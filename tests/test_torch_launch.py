"""``python -m repro_torch.launch.serve`` at ``SMOKE`` on the CPU in its
four modes, beside the reference launcher (``repro.launch.serve``) on
the same analyzer checkpoint (a temporary file, never ``results/``).

The two catalogs' runners hold different seeded weights, so routing is
compared, not tokens: the flat stream and batch mode route every
request to the same model; ``--async`` serves every request in windows
of at most ``--max-batch`` and nets the load tracker to zero; ``--soak``
gives the reference's per-tenant intake counters and admission tally
over runner-less catalogs (the port's roofline constants set to the
reference's, so the catalogs' metrics and the tracker's service times
agree, as in ``tests/test_torch_generate.py``).  Metrics and trace files parse back.
"""
import json

import numpy as np
import pytest

import repro.launch.serve as JSERVE
import repro.serving.async_engine as JAE
from repro.checkpoint import save as jsave
from repro.core import analyzer as JA
from repro.serving import runner as JRUN
from repro_torch.launch import serve as TSERVE
from repro_torch.obs import metrics_from_prom
from repro_torch.serving import runner as TRUN

ARCHS = ["llama3.2-1b", "mamba2-1.3b", "gemma2-2b"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("an") / "analyzer.npz"
    jsave(str(path), JA.TaskAnalyzer(JA.AnalyzerConfig(), seed=0).params,
          {"metrics": {}})
    return path


@pytest.fixture
def same_roofline(monkeypatch, ckpt):
    monkeypatch.setattr(TRUN, "PEAK_FLOPS", JRUN.PEAK_FLOPS)
    monkeypatch.setattr(TRUN, "HBM_BW", JRUN.HBM_BW)
    monkeypatch.setattr(JSERVE, "ANALYZER_CKPT", ckpt)


def _port(ckpt, *args):
    return TSERVE.main(["--device", "cpu", "--analyzer-ckpt", str(ckpt),
                        "--archs", *ARCHS, *args])


def _models(capsys):
    out = capsys.readouterr().out
    return [line.split("-> ")[1].split()[0] for line in out.splitlines()
            if line.startswith("  #")]


@pytest.mark.parametrize("mode", ["interactive", "batch"])
def test_flat_and_batch_route_like_the_reference(same_roofline, ckpt,
                                                 capsys, mode):
    args = ["--requests", "8", "--max-new", "3", "--mode", mode]
    JSERVE.main(["--archs", *ARCHS, *args])
    want = _models(capsys)
    out = _port(ckpt, *args)
    assert [r.model for r in out["responses"]] == want == _models(capsys)
    assert all(r.served and len(r.tokens) == 3 for r in out["responses"])
    if mode == "batch":
        assert len(set(want)) == 1
    assert out["summary"]["requests"] == 8


def test_async_mode_serves_every_request(ckpt, tmp_path):
    prom, trace = tmp_path / "m.prom", tmp_path / "t.jsonl"
    out = _port(ckpt, "--requests", "10", "--async", "--max-batch", "4",
                "--metrics-out", str(prom), "--trace-out", str(trace))
    assert len(out["responses"]) == 10
    assert all(r.served for r in out["responses"])
    assert {r.request.tenant for r in out["responses"]} == {"acme", "globex"}
    assert sum(out["windows"]) == 10 and max(out["windows"]) <= 4
    load = out["engine"].load
    assert (load.queue == 0).all() and (load.inflight == 0).all()
    assert metrics_from_prom(prom.read_text())
    assert all(json.loads(line) for line in trace.read_text().splitlines())


def test_soak_tally_matches_reference(same_roofline, ckpt, monkeypatch,
                                      capsys):
    made = []

    class Recording(JAE.MicroBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(JAE, "MicroBatcher", Recording)
    # runner-less catalogs on both sides: every window is routed and
    # admitted, and charged each entry's latency_ms (the reference's
    # generate would take most of a minute here)
    for mod in (JSERVE, TSERVE):
        build = mod.build_catalog
        monkeypatch.setattr(mod, "build_catalog", lambda _b=build, **kw: _b(
            archs=kw["archs"], **({"device": kw["device"]}
                                  if "device" in kw else {})))
    JSERVE.main(["--archs", *ARCHS, "--soak", "4"])
    text = capsys.readouterr().out
    want = {}
    for line in text.split("windows (max")[1].split("[serve] summary")[0] \
            .splitlines()[1:]:
        name, counts = line.strip().split(": ")
        want[name] = {k: int(v) for k, v in
                      (c.split("=") for c in counts.split(", "))}
    out = _port(ckpt, "--soak", "4")
    assert out["intake"] == made[0].stats
    assert out["tally"] == want
    assert out["intake"]["flood"]["rate_limited"] > 0
    assert all(out["intake"][t]["rate_limited"] == 0 for t in
               ("acme", "globex"))
    load = out["engine"].load
    assert (load.queue == 0).all() and (load.inflight == 0).all()


def test_default_archs_and_device():
    assert TSERVE.default_archs("cpu") == [
        a for a in TSERVE.ARCH_NAMES if a not in TSERVE.FRONTENDS]
    assert len(TSERVE.default_archs("cpu")) == 8
    assert set(TSERVE.CARD_ARCHS) | set(TSERVE.LEFT_OUT) == \
        set(TSERVE.ARCH_NAMES)
