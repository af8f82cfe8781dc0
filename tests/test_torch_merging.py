"""Model merging and runner checkpoints in the port against the JAX
package, on the CPU at ``SMOKE`` (weights from the reference's
``init_params`` through ``params_from_jax``):

  * ``soup``: the reference's unit case, and the soup of two
    llama3.2-1b parameter trees bit-equal to the reference's at every
    grid alpha (f32 weights, an f32 accumulate in parent order);
  * ``ModelMerger``: the same soup name, alpha, metrics and
    candidate pairs as the reference on the cases of
    ``tests/test_core_components.py``; a metrics-only soup when a
    runner cannot merge, and any other error propagates;
  * the orchestrator's merger branch (``tests/test_integration.py``'s
    filtered-parent case, with two llama3.2-1b runners): the same soup,
    the same decision, and the soup runner's tokens equal;
  * runner checkpoints: saved by one package, loaded by the other,
    with the same greedy tokens; a bf16 runner round-trips bit-equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import analyzer as JA
from repro.core import merging as JMG
from repro.core.mres import MRES as JMRES
from repro.core.orchestrator import OptiRoute as JOptiRoute
from repro.core.preferences import TaskSignature as JSig
from repro.core.preferences import UserPreferences as JPrefs
from repro.data.workload import make_workload
from repro.models import model as JM
from repro.serving.runner import ModelRunner as JRunner
from repro_torch.configs import get_smoke
from repro_torch.core import analyzer as TA
from repro_torch.core import merging as TMG
from repro_torch.core.mres import MRES as TMRES
from repro_torch.core.mres import ModelEntry as TEntry
from repro_torch.core.orchestrator import OptiRoute as TOptiRoute
from repro_torch.core.preferences import TaskSignature as TSig
from repro_torch.core.preferences import UserPreferences as TPrefs
from repro_torch.models import model as TM
from repro_torch.serving.runner import ModelRunner as TRunner
from tests.conftest import make_entry

ARCH = "llama3.2-1b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed_a=0, seed_b=1):
    cfg = jget_smoke(ARCH)
    return [JM.init_params(jax.random.PRNGKey(s), cfg)
            for s in (seed_a, seed_b)]


def _twin(jentry, runner=None):
    e = jentry
    return TEntry(name=e.name, raw_metrics=dict(e.raw_metrics),
                  task_types=e.task_types, domains=e.domains,
                  family=e.family, n_params=e.n_params,
                  generalist=e.generalist, runner=runner)


def _catalogs(specs, runners=(None, None)):
    jm, tm = JMRES(), TMRES()
    for i, kw in enumerate(specs):
        je = make_entry(**kw)
        je.runner = runners[0][i] if runners[0] else None
        jm.register(je)
        tm.register(_twin(je, runners[1][i] if runners[1] else None))
    return jm, tm


def test_soup_is_weighted_average():
    t1 = {"a": torch.ones(2, 2), "b": [torch.zeros(3)]}
    t2 = {"a": torch.zeros(2, 2), "b": [torch.ones(3)]}
    s = TMG.soup([t1, t2], [0.25, 0.75])
    np.testing.assert_allclose(s["a"].numpy(), 0.25)
    np.testing.assert_allclose(s["b"][0].numpy(), 0.75)
    with pytest.raises(ValueError, match="sum to 1"):
        TMG.soup([t1, t2], [0.5, 0.6])


@pytest.mark.parametrize("alpha", [0.2, 0.4, 0.6, 0.8, 1 / 3])
def test_soup_bits_equal_reference(alpha):
    ja, jb = _pair()
    want = TM.params_from_jax(_np(JMG.soup([ja, jb], [alpha, 1 - alpha])))
    got = TMG.soup([TM.params_from_jax(_np(ja)), TM.params_from_jax(_np(jb))],
                   [alpha, 1 - alpha])
    TM.tree_map(lambda g, w: np.testing.assert_array_equal(g.numpy(),
                                                           w.numpy()),
                got, want)


def test_merger_matches_reference():
    specs = [dict(name="acc", accuracy=0.9, latency_ms=500, cost=10,
                  family="dense", n_params=100),
             dict(name="fast", accuracy=0.3, latency_ms=5, cost=0.1,
                  family="dense", n_params=100),
             dict(name="other", accuracy=0.5, family="moe", n_params=100)]
    jm, tm = _catalogs(specs)
    w = {"accuracy": 1.0, "speed": 1.0, "cheapness": 1.0}
    je = JMG.ModelMerger(jm).maybe_merge(JPrefs(weights=w), JSig(), 0.0)
    te = TMG.ModelMerger(tm).maybe_merge(TPrefs(weights=w), TSig(), 0.0)
    assert te.name == je.name and te.name.startswith("soup:")
    assert te.meta == je.meta and te.raw_metrics == je.raw_metrics
    assert (te.task_types, te.domains, te.family, te.generalist) == \
        (je.task_types, je.domains, je.family, je.generalist)
    assert len(tm) == len(jm) == 4
    mm = TMG.merged_metrics([tm.entry("acc"), tm.entry("fast")], [0.5, 0.5])
    assert mm["accuracy"] == pytest.approx(0.6)
    assert mm["latency_ms"] == pytest.approx(252.5)
    # the family boundary, and an incumbent nothing beats
    assert [(a.name, b.name) for a, b in TMG.ModelMerger(tm)
            .candidate_pairs()] == [(a.name, b.name) for a, b in
                                    JMG.ModelMerger(jm).candidate_pairs()]
    assert TMG.ModelMerger(tm).maybe_merge(TPrefs(weights=w), TSig(),
                                           10.0) is None


class _Raises:
    cfg = None

    def __init__(self, exc):
        self.exc = exc

    def merged_with(self, other, alpha):
        raise self.exc


def test_merger_catches_only_what_the_reference_catches():
    specs = [dict(name="acc", accuracy=0.9, latency_ms=500, cost=10,
                  family="dense", n_params=100),
             dict(name="fast", accuracy=0.3, latency_ms=5, cost=0.1,
                  family="dense", n_params=100)]
    w = TPrefs(weights={"accuracy": 1.0, "speed": 1.0, "cheapness": 1.0})
    for exc in (AttributeError("no merge"), AssertionError("family")):
        _, tm = _catalogs(specs, runners=(None, [_Raises(exc)] * 2))
        assert TMG.ModelMerger(tm).maybe_merge(w, TSig(), 0.0).runner is None
    _, tm = _catalogs(specs, runners=(None, [_Raises(RuntimeError("CUDA"))] * 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        TMG.ModelMerger(tm).maybe_merge(w, TSig(), 0.0)
    a = TRunner(get_smoke(ARCH), seed=0, device="cpu")
    with pytest.raises(AssertionError, match="same family"):
        a.merged_with(TRunner(get_smoke("qwen2-1.5b"), seed=0, device="cpu"),
                      0.5)


@pytest.fixture(scope="module")
def analyzers():
    cfg = dict(d_model=64, n_layers=1, d_ff=128, max_len=64)
    ja = JA.TaskAnalyzer(JA.AnalyzerConfig(**cfg))
    ja.train(n_samples=512, steps=50, batch_size=64)
    ta = TA.TaskAnalyzer(TA.AnalyzerConfig(**cfg), device="cpu",
                         state=TA.params_from_jax(_np(ja.params)))
    return ja, ta


def test_merging_fallback_in_orchestrator_matches_reference(analyzers):
    ja, ta = analyzers
    jp = _pair()
    jr = [JRunner(jget_smoke(ARCH), params=p) for p in jp]
    tr = [TRunner(get_smoke(ARCH), params=TM.params_from_jax(_np(p)),
                  device="cpu") for p in jp]
    specs = [dict(name="legal-weak", accuracy=0.4, latency_ms=50, cost=1.0,
                  family="dense", n_params=100,
                  task_types=("summarization",), domains=("legal",)),
             dict(name="general-strong", accuracy=0.95, latency_ms=40,
                  cost=1.0, family="dense", n_params=100,
                  task_types=("summarization",), domains=("general",))]
    jm, tm = _catalogs(specs, runners=(jr, tr))
    jrt = JOptiRoute(jm, ja, merge_threshold=10.0)
    trt = TOptiRoute(tm, ta, merge_threshold=10.0, device="cpu")
    text = make_workload(1, seed=14, task_type="summarization",
                         domain="legal")[0].text
    jq, tq = jrt.route(text, "balanced"), trt.route(text, "balanced")
    assert [e.name for e in tm.entries] == [e.name for e in jm.entries]
    soup = tm.entries[-1]
    assert soup.name.startswith("soup:") and tq.model == jq.model == soup.name
    assert soup.meta == jm.entries[-1].meta
    assert tq.decision.score == pytest.approx(jq.decision.score, abs=1e-5)
    assert "legal" in soup.domains and "general" in soup.domains
    toks = np.arange(2, 14, dtype=np.int32)[None]
    want = jm.entries[-1].runner.generate(toks, max_new=4)
    got = soup.runner.generate(toks, max_new=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits_last, want.logits_last,
                               rtol=1e-4, atol=1e-4)
    assert not np.allclose(got.logits_last,
                           tr[0].generate(toks, max_new=1).logits_last)
    # serve(): route (the merger may fire again) + generate on the
    # chosen runner, as in the reference
    jq, tq = (r.serve(text, "balanced", toks, max_new=2) for r in (jrt, trt))
    assert tq.model == jq.model == tm.entries[-1].name
    np.testing.assert_array_equal(tq.response.tokens, jq.response.tokens)


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-1.3b"])
def test_runner_checkpoints_load_across_packages(tmp_path, name):
    jcfg, tcfg = jget_smoke(name), get_smoke(name)
    jr = JRunner(jcfg, seed=3)
    toks = np.arange(3, 15, dtype=np.int32).reshape(2, 6)
    want = jr.generate(toks, max_new=3).tokens
    jr.save_checkpoint(str(tmp_path / "j.npz"))
    tr = TRunner.from_checkpoint(tcfg, str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(tr.generate(toks, max_new=3).tokens, want)
    tr.save_checkpoint(str(tmp_path / "t.npz"), {"note": "port"})
    jb = JRunner.from_checkpoint(jcfg, str(tmp_path / "t.npz"))
    assert jb.meta["config"] == tcfg.name and jb.meta["note"] == "port"
    np.testing.assert_array_equal(jb.generate(toks, max_new=3).tokens, want)


def test_bf16_runner_checkpoint_round_trips_bit_equal(tmp_path):
    import dataclasses
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="bfloat16")
    a = TRunner(cfg, seed=2, device="cpu")
    a.save_checkpoint(str(tmp_path / "b.npz"))
    b = TRunner.from_checkpoint(cfg, str(tmp_path / "b.npz"), device="cpu")
    assert b.meta["dtype"] == "bfloat16"
    TM.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0),
                b.params, a.params)
