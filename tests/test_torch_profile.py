"""The port's per-dispatch observation hooks (``ops.set_recompile_hook``,
``ops.set_cost_profiler``) and ``obs.profile`` against the JAX
package's.

One sequence of dispatches -- dense fp32 and int8 route steps, the
fused analyze->route program with an fp32 and an int8 analyzer, the
analyzer alone, the IVF program and the catalog-sharded one -- runs
through both packages with a hook and a profiler attached to each.
The hooks' events must be equal in every key but ``compiles`` (the
reference counts XLA compiles; eager PyTorch compiles nothing, so the
port's are all 0), and the profilers must hold the same bucket keys.
The port's per-bucket costs are counted from the padded shapes, so
they are compared with the formulas, not with XLA's cost analysis.
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.core import analyzer as JA
from repro.core.mres import build_ivf as jbuild_ivf
from repro.kernels import ops as K
from repro.launch.mesh import make_routing_mesh as jmesh
from repro.obs import DeviceCostProfiler as JProfiler
from repro.obs import prometheus_text as jprometheus_text
from repro_torch.core.telemetry import Telemetry
from repro_torch.kernels import ops as P
from repro_torch.launch.mesh import make_routing_mesh
from repro_torch.obs import (DeviceCostProfiler, metrics_from_prom,
                             parse_prom_text, prometheus_text,
                             trace_capture)
from repro_torch.obs import profile as PR
from tests.test_torch_analyzer import (CFG_J, CFG_T, _catalog, _encoder,
                                       _tokens)
from tests.test_torch_route_step import _problem


@pytest.fixture(scope="module")
def jparams():
    return JA.TaskAnalyzer(CFG_J, seed=3).params


def _sequence(jparams):
    """(name, reference call, port call) for every dispatch kind."""
    dense, dkw = _problem(19, 257, 5, fb=True, ad=True, load=True,
                          sparse=False)
    ivf = jbuild_ivf(dense[0], 16)
    emb, tt, dm, gmask = _catalog(150, seed=2)
    rng = np.random.default_rng(5)
    toks = _tokens(11, seed=6)
    toks_small = _tokens(3, seed=7)
    W = rng.random((11, 8)).astype(np.float32)
    fkw = dict(k=8, r=8, threshold=0.09, acc_col=0)
    q8 = JA.quantize_int8(jparams)
    enc, enc8 = _encoder(jparams), _encoder(q8)
    mesh = make_routing_mesh(4, device="cpu")
    cpu = dict(device="cpu")
    seq = []
    for quant in (False, True):
        seq.append((f"dense quant={quant}",
                    lambda q=quant: K.route_step(*dense, k=6, r=7, quant=q,
                                                 **dkw),
                    lambda q=quant: P.route_step(*dense, k=6, r=7, quant=q,
                                                 **dkw, **cpu)))
    for quant, jp, tp in ((False, jparams, enc), (True, q8, enc8)):
        seq.append((f"fused quant={quant}",
                    lambda q=quant, p=jp: K.analyze_route_step(
                        p, CFG_J, toks, emb, tt, dm, gmask, W, quant=q,
                        **fkw),
                    lambda q=quant, p=tp: P.analyze_route_step(
                        p, toks, emb, tt, dm, gmask, W, quant=q, **fkw,
                        **cpu)))
        seq.append((f"analyze quant={quant}",
                    lambda p=jp: K.analyze_step(p, CFG_J, toks_small),
                    lambda p=tp: P.analyze_step(p, toks_small, **cpu)))
    seq.append(("ivf",
                lambda: K.route_step(*dense, k=6, r=6, ivf=ivf.as_tuple(),
                                     nprobe=3, **dkw),
                lambda: P.route_step(*dense, k=6, r=6, ivf=ivf.as_tuple(),
                                     nprobe=3, **dkw, **cpu)))
    seq.append(("sharded",
                lambda: K.route_step(*dense, k=6, r=7, mesh=jmesh(4), **dkw),
                lambda: P.route_step(*dense, k=6, r=7, mesh=mesh, **dkw,
                                     **cpu)))
    # a bucket seen before: one more event, no new profile entry
    seq.append(seq[0])
    return seq


def _run(ops, calls):
    events, prof = [], (DeviceCostProfiler() if ops is P else JProfiler())
    ops.set_recompile_hook(events.append)
    ops.set_cost_profiler(prof)
    try:
        for call in calls:
            call()
    finally:
        ops.set_recompile_hook(None)
        ops.set_cost_profiler(None)
    return events, prof


def test_hook_events_and_profile_buckets_match_reference(jparams):
    if jax.device_count() < 4:
        pytest.fail("tests/conftest.py gives the reference 4 host devices")
    seq = _sequence(jparams)
    want, jprof = _run(K, [s[1] for s in seq])
    got, prof = _run(P, [s[2] for s in seq])
    assert len(got) == len(want) == len(seq)
    for (name, _, _), g, w in zip(seq, got, want):
        assert set(g) == set(w) == {"path", "q_bucket", "n_bucket", "quant",
                                    "shards", "compiles"}, name
        assert {k: v for k, v in g.items() if k != "compiles"} == \
            {k: v for k, v in w.items() if k != "compiles"}, name
        assert g["compiles"] == 0, name
    assert [e["path"] for e in got] == [
        "dense", "dense", "fused", "analyze", "fused", "analyze", "ivf",
        "sharded", "dense"]
    assert got[4]["quant"] == (True, True) and got[5]["quant"] is True
    keys = set(prof.profile())
    assert keys == set(jprof.profile())
    assert len(keys) == len(seq) - 1 == prof.captures
    assert prof.errors == 0
    for costs in prof.profile().values():
        assert set(costs) == {"flops", "bytes_accessed"}
        assert costs["flops"] > 0 and costs["bytes_accessed"] > 0


def test_detached_hooks_see_nothing():
    dense, dkw = _problem(5, 64, 1, fb=False, ad=False, load=False,
                          sparse=False)
    events, prof = [], DeviceCostProfiler()
    P.set_recompile_hook(events.append)
    P.set_cost_profiler(prof)
    try:
        P.route_step(*dense, k=3, r=3, device="cpu")
    finally:
        P.set_recompile_hook(None)
        P.set_cost_profiler(None)
    P.route_step(*dense, k=3, r=3, device="cpu")
    assert len(events) == 1 and len(prof.profile()) == 1
    assert events[0]["path"] == "dense" and events[0]["q_bucket"] == 8


def test_cost_formulas_from_the_padded_shapes():
    """The dense bucket's numbers are ``route_step_cost`` of its padded
    shapes; ``knn_cost`` counts what ``chip_smoke.py``'s top-k rows
    divide by the card's peaks."""
    dense, dkw = _problem(19, 257, 5, fb=True, ad=True, load=True,
                          sparse=False)
    prof = DeviceCostProfiler()
    P.set_cost_profiler(prof)
    try:
        P.route_step(*dense, k=6, r=7, quant=True, device="cpu", **dkw)
    finally:
        P.set_cost_profiler(None)
    (key, costs), = prof.profile().items()
    assert key == "dense/32/384/True/1"
    n_tt, n_dm = dense[1].shape[0], dense[2].shape[0]
    assert costs == PR.route_step_cost(32, 384, 8, 6, 7, n_tt * n_dm,
                                       quant=True, fb=True, ad=True,
                                       load=True)
    knn = PR.knn_cost(256, 100_000, 8, 8, 98, pairs=1000, quant=False)
    assert knn["flops"] == 2 * 8 * 1000
    assert knn["bytes_accessed"] == (256 * 8 * 4 + 100_000 * 8 * 4
                                     + 98 * 100_000 + 256 * 4 + 256 * 8 * 8)
    a = PR.analyzer_cost(8, 24, CFG_T, 11, 6)
    assert a["flops"] > 0 and a["bytes_accessed"] > 0
    a8 = PR.analyzer_cost(8, 24, CFG_T, 11, 6, quant=True)
    assert a8["flops"] == a["flops"]
    assert a8["bytes_accessed"] < a["bytes_accessed"]


def test_prometheus_cost_profile_round_trips():
    tel = Telemetry()
    tel.record_route_step(dispatches=3, compiles=0)
    prof = {"dense/16/128/False/1": {"flops": 1e6, "bytes_accessed": 2e5},
            "fused/8/256/(False, True)/1": {"flops": 3.5e7,
                                            "bytes_accessed": None}}
    text = prometheus_text(tel, cost_profile=prof)
    raw = parse_prom_text(text)
    assert raw['repro_route_step_flops{bucket="dense/16/128/False/1"}'] \
        == 1e6
    assert raw['repro_route_step_bytes{bucket="dense/16/128/False/1"}'] \
        == 2e5
    assert raw['repro_route_step_flops{bucket="fused/8/256/(False, True)/1"}'
               ] == 3.5e7
    assert 'repro_route_step_bytes{bucket="fused/8/256/(False, True)/1"}' \
        not in raw
    m = metrics_from_prom(text)
    assert m['repro_route_step_flops{bucket="dense/16/128/False/1"}'] == 1e6
    # the same gauges, lines and labels as the reference's export
    from repro.core.telemetry import Telemetry as JTelemetry
    jtel = JTelemetry()
    jtel.record_route_step(dispatches=3, compiles=0)
    want = [ln for ln in jprometheus_text(jtel, cost_profile=prof)
            .splitlines() if "route_step_flops" in ln
            or "route_step_bytes" in ln]
    got = [ln for ln in text.splitlines() if "route_step_flops" in ln
           or "route_step_bytes" in ln]
    assert [ln for ln in got if not ln.startswith("# HELP")] == \
        [ln for ln in want if not ln.startswith("# HELP")]
    assert prometheus_text(tel, cost_profile={}) == prometheus_text(tel)


def test_trace_capture(tmp_path):
    with trace_capture(None):                   # falsy: a no-op
        x = 1
    with trace_capture(""):
        x += 1
    assert x == 2 and not any(tmp_path.iterdir())
    out = tmp_path / "trace"
    dense, dkw = _problem(5, 64, 1, fb=False, ad=False, load=False,
                          sparse=False)
    with trace_capture(str(out)):
        P.route_step(*dense, k=3, r=3, device="cpu")
    files = os.listdir(out)
    assert files == ["trace.json"]
    with open(out / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
