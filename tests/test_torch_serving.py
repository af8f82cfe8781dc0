"""The same serving sequence through both packages: ``ServingEngine.
submit`` -> ``observe`` -> ``submit`` -> ``observe`` -> ``submit``, with
the semantic cache, the LinUCB bandit and the load tracker (and request
deadlines) on.  The JAX side runs its kernel structure (interpret-mode
Pallas kNN, cache lookup and bandit update); the port runs on the CPU
(plain kernel versions).  Per request the model, admission outcome,
cache hit and fallback rung agree (a model may differ only where the
reference's two best candidates tie within 1e-5); the bandit posterior
agrees within rtol 1e-5."""
import jax
import numpy as np
import pytest

from repro.adaptive.bandit import LinearBandit as JBandit
from repro.cache.semantic import SemanticCache as JCache
from repro.core import analyzer as JA
from repro.core.mres import MRES as JMRES
from repro.core.mres import ModelEntry as JEntry
from repro.core.orchestrator import OptiRoute as JOptiRoute
from repro.data.workload import make_workload
from repro.data.workload import meta_of, quality_of
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.load import LoadTracker as JLoad
from repro_torch.adaptive import LinearBandit as TBandit
from repro_torch.cache.semantic import SemanticCache as TCache
from repro_torch.core import analyzer as TA
from repro_torch.core.mres import MRES as TMRES
from repro_torch.core.mres import ModelEntry as TEntry
from repro_torch.core.orchestrator import OptiRoute as TOptiRoute
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TServingEngine
from repro_torch.serving.load import LoadTracker as TLoad

CFG_J = JA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)
CFG_T = TA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)
PROFILES = ["balanced", "cost-effective", "accuracy-first", "latency-first"]


def _entries(n, seed):
    rng = np.random.default_rng(seed)
    from repro.core.preferences import DOMAINS, TASK_TYPES
    out = []
    for i in range(n):
        raw = {"accuracy": float(rng.random()),
               "latency_ms": float(rng.random() * 400 + 5),
               "cost_per_mtok": float(rng.random() * 20 + 0.1),
               **{m: float(rng.random()) for m in (
                   "helpfulness", "harmlessness", "honesty", "steerability",
                   "creativity")}}
        # one tag each, and no creative-writing model for healthcare:
        # many (task type, domain) rows stay empty, so the fallback
        # ladder runs
        tt = str(rng.choice(TASK_TYPES))
        dm = str(rng.choice(DOMAINS))
        if tt == "creative-writing" and dm == "healthcare":
            dm = "general"
        out.append(dict(name=f"m{i}", raw_metrics=raw, task_types=(tt,),
                        domains=(dm,), generalist=bool(rng.random() < 0.1)))
    return out


def _systems(n, quant, policy="linucb"):
    spec = _entries(n, seed=1)
    jm, tm = JMRES(), TMRES()
    jm.register_many([JEntry(**dict(e, raw_metrics=dict(e["raw_metrics"])))
                      for e in spec])
    tm.register_many([TEntry(**dict(e, raw_metrics=dict(e["raw_metrics"])))
                      for e in spec])
    ja = JA.TaskAnalyzer(CFG_J, seed=3)
    ta = TA.TaskAnalyzer(CFG_T, device="cpu", state=TA.params_from_jax(
        jax.tree_util.tree_map(np.asarray, ja.params)))
    jr = JOptiRoute(
        jm, ja, use_kernel=True,
        adaptive=JBandit(n, policy=policy, seed=3, use_kernel=True,
                         kernel_min_n=1),
        adaptive_weight=1.0, load=JLoad(n), load_weight=0.5,
        cache=JCache(capacity=32, min_quality=0.0, use_kernel=True,
                     kernel_min_n=1, quantize=quant))
    jr.engine._kernel_min_n = 1
    tr = TOptiRoute(
        tm, ta, adaptive=TBandit(n, policy=policy, seed=3, device="cpu"),
        adaptive_weight=1.0,
        load=TLoad(n), load_weight=0.5,
        cache=TCache(capacity=32, min_quality=0.0, quantize=quant,
                     device="cpu"), device="cpu")
    for r in (jr, tr):
        r.engine.confidence_threshold = 0.0
        r.engine.quantize = quant
    return (jm, JServingEngine(jr)), (tm, TServingEngine(tr))


def _batches(nb):
    recs = make_workload(3 * nb, seed=4)
    dl = lambda i: 60.0 if i % 3 == 0 else None      # some request SLOs
    b = [[(i, r) for i, r in enumerate(recs[j * nb:(j + 1) * nb], j * nb)]
         for j in range(3)]
    b[1] = b[0][: nb // 2] + b[1][: nb - nb // 2]     # repeats: cache hits
    b[2] = b[0][nb // 2:] + b[2][: nb // 2]
    return [[(i, r, PROFILES[i % 4], dl(i)) for i, r in bb] for bb in b]


def _tied(resp):
    rq = resp.rq
    if rq is None:
        return False
    if rq._batch is None:               # staged: an eager decision
        c = rq.decision.candidates
        return len(c) > 1 and c[0][1] - c[1][1] <= 1e-5
    cs = rq._batch.cand_score[rq._bidx]
    return bool(np.isfinite(cs[:2]).all() and cs[0] - cs[1] <= 1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_serving_sequence_matches_jax(quant):
    _serving_sequence(quant, "linucb")


def test_thompson_serving_sequence_matches_jax():
    """The same sequence with a Thompson-policy bandit: both packages
    route on their staged paths (analyzer program, then one kNN launch
    and host blending) and draw the same posterior samples from the
    same seed."""
    _serving_sequence(False, "thompson")


def _serving_sequence(quant, policy):
    (jm, je), (tm, te) = _systems(96, quant, policy)
    hits = 0
    for batch in _batches(12):
        jres = je.submit([JRequest(text=r.text, prefs=p, id=i,
                                   deadline_ms=d) for i, r, p, d in batch])
        tres = te.submit([TRequest(text=r.text, prefs=p, id=i,
                                   deadline_ms=d) for i, r, p, d in batch])
        for a, b in zip(jres, tres):
            assert a.cache_hit == b.cache_hit
            hits += a.cache_hit
            if a.model != b.model:
                assert _tied(a), (a.model, b.model)
                continue
            assert (a.admission, a.fallback) == (b.admission, b.fallback)
            assert (a.rq is None) == (b.rq is None)
        jq = [quality_of(meta_of(jm.entry(x.model)), r.sig)
              for x, (_, r, _, _) in zip(jres, batch)]
        tq = [quality_of(meta_of(tm.entry(x.model)), r.sig)
              for x, (_, r, _, _) in zip(tres, batch)]
        je.observe(jres, jq)
        te.observe(tres, tq)
    assert hits > 0
    jb, tb = je.router.adaptive, te.router.adaptive
    np.testing.assert_allclose(tb.A, jb.A, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.b, jb.b, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tb.counts, jb.counts)
    for name in ("queue", "inflight", "capacity"):
        np.testing.assert_array_equal(getattr(te.load, name),
                                      getattr(je.load, name))
    np.testing.assert_allclose(te.load.ewma_s, je.load.ewma_s, rtol=1e-6)
    assert len(te.cache) == len(je.cache)


@pytest.mark.parametrize("B", [0, 7], ids=["empty", "batch"])
def test_bandit_update_and_score_matches_jax(B):
    """One serving-cadence step on a warm posterior: the (Bs, N) LinUCB
    scores, then the folded-in outcomes (none for an empty batch)."""
    rng = np.random.default_rng(5 + B)
    n, m = 40, 8
    jb = JBandit(n, use_kernel=True, kernel_min_n=1)
    tb = TBandit(n, device="cpu")
    x0, c0, r0 = rng.random((12, m)), rng.integers(0, n, 12), rng.random(12)
    jb.update(x0, c0, r0)
    tb.update(x0, c0, r0)
    x, c, r = rng.random((B, m)), rng.integers(0, n, B), rng.random(B)
    xs = rng.random((5, m))
    for step in range(2):          # the second scores the updated posterior
        np.testing.assert_allclose(tb.update_and_score(x, c, r, xs),
                                   jb.update_and_score(x, c, r, xs),
                                   rtol=1e-5, atol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(tb.A, jb.A, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tb.b, jb.b, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tb.counts, jb.counts)


@pytest.mark.parametrize("mode", ["sharded", "ivf"])
def test_sharded_and_ivf_catalogs_route_a_batch(mode):
    """A routing mesh (two CPU shards) and IVF pruning each serve
    ``route_many_batch``; the route_step span names the program."""
    from repro_torch.core.preferences import TaskSignature
    from repro_torch.core.routing import RoutingEngine
    from repro_torch.launch.mesh import make_routing_mesh
    from repro_torch.obs import Tracer

    tm = TMRES()
    tm.register_many([TEntry(**e) for e in _entries(48, seed=6)])
    kw = {"mesh": make_routing_mesh(2, device="cpu")} if mode == "sharded" \
        else {"ivf": True, "ivf_min_n": 1}
    eng = RoutingEngine(tm, device="cpu", tracer=Tracer(), **kw)
    sigs = [TaskSignature(task_type="chat", domain="general",
                          complexity=0.1 * i) for i in range(5)]
    batch = eng.route_many_batch("balanced", sigs)
    assert len(batch) == 5 and (batch.model_idx >= 0).all()
    (span,) = [sp for sp in eng.tracer.spans() if sp.name == "route_step"]
    assert span.attrs["path"] == mode
    assert span.attrs["shards"] == (2 if mode == "sharded" else 1)


class _StubAnalyzer:
    """An analyzer without fused-route support: ``route_all`` takes the
    analyze-then-``route_many_batch`` branch in both packages."""

    def __init__(self, sig_cls):
        self.sig_cls = sig_cls

    def analyze_batch(self, texts):
        from repro.core.preferences import DOMAINS, TASK_TYPES
        return [self.sig_cls(task_type=TASK_TYPES[len(t) % 11],
                             domain=DOMAINS[len(t) % 6],
                             complexity=(len(t) % 10) / 10,
                             confidence=0.9) for t in texts]


def test_route_all_staged_branch_matches_jax():
    from repro.core.preferences import TaskSignature as JSig
    from repro_torch.core.preferences import TaskSignature as TSig
    spec = _entries(64, seed=2)
    jm, tm = JMRES(), TMRES()
    jm.register_many([JEntry(**e) for e in spec])
    tm.register_many([TEntry(**e) for e in spec])
    jr = JOptiRoute(jm, _StubAnalyzer(JSig), use_kernel=True,
                    adaptive=JBandit(64), adaptive_weight=0.5)
    jr.engine._kernel_min_n = 1
    tr = TOptiRoute(tm, _StubAnalyzer(TSig), adaptive=TBandit(64, device="cpu"),
                    adaptive_weight=0.5, device="cpu")
    texts = [r.text for r in make_workload(13, seed=9)]
    ja = jr.route_all(texts, "balanced")
    ta = tr.route_all(texts, "balanced")
    for a, b in zip(ja, ta):
        assert vars(a.sig) == vars(b.sig)
        assert a.fallback_kind == b.fallback_kind
        assert a.model == b.model or _tied_rq(a)
        assert a.decision.score == pytest.approx(b.decision.score, abs=1e-5)


def _tied_rq(rq):
    cs = rq._batch.cand_score[rq._bidx]
    return bool(np.isfinite(cs[:2]).all() and cs[0] - cs[1] <= 1e-5)
