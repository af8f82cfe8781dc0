"""Durable router state in the port: atomic versioned snapshots of the
bandit statistics, feedback biases, load EWMAs and cache contents,
restored bit-exactly into a fresh router (identical ``route_many``
output); the npz layout is the reference's, so a snapshot saved by
``repro`` restores in ``repro_torch`` and the other way round, with the
decisions matching tie-aware."""
import numpy as np
import pytest

from repro.adaptive import LinearBandit as JBandit
from repro.cache import SemanticCache as JCache
from repro.checkpoint import load_router_state as j_load
from repro.checkpoint import save_router_state as j_save
from repro.core.feedback import FeedbackStore as JFeedback
from repro.core.orchestrator import OptiRoute as JOptiRoute
from repro.core.preferences import TaskSignature as JSig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.load import LoadTracker as JLoad
from repro_torch.adaptive import LinearBandit
from repro_torch.cache.semantic import SemanticCache
from repro_torch.checkpoint import (RouterState, load_router_state,
                                    save_router_state)
from repro_torch.checkpoint.store import load, save
from repro_torch.core.feedback import FeedbackStore
from repro_torch.core.orchestrator import OptiRoute
from repro_torch.core.preferences import TaskSignature
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.load import LoadTracker
from tests.test_torch_router_paths import (assert_decisions_match,
                                           catalog_spec, catalogs, queries)

N = 12


class _Stub:
    """Deterministic analyzer stand-in (the reference's StubAnalyzer)."""

    def __init__(self, sig_cls):
        self.sig_cls = sig_cls

    def analyze_batch(self, texts):
        return [self.sig_cls(task_type="chat", domain="general",
                             complexity=0.4) for _ in texts]


def _build(with_all=True, torch_side=True, policy="linucb"):
    jm, tm = catalogs(catalog_spec(N, seed=4))
    if torch_side:
        kw = {}
        if with_all:
            kw = dict(adaptive=LinearBandit(N, policy=policy, seed=1,
                                            device="cpu"),
                      adaptive_weight=0.7,
                      load=LoadTracker(N, capacity=2.0), load_weight=0.8,
                      cache=SemanticCache(capacity=32, sketch_dims=16,
                                          min_quality=0.2, device="cpu"))
        return OptiRoute(tm, _Stub(TaskSignature), feedback=FeedbackStore(),
                         device="cpu", **kw)
    kw = {}
    if with_all:
        kw = dict(adaptive=JBandit(N, policy=policy, seed=1),
                  adaptive_weight=0.7, load=JLoad(N, capacity=2.0),
                  load_weight=0.8,
                  cache=JCache(capacity=32, sketch_dims=16,
                               min_quality=0.2))
    return JOptiRoute(jm, _Stub(JSig), feedback=JFeedback(), **kw)


def _requests(cls):
    return [cls(text=f"q {i % 4} words here", prefs="balanced", id=i)
            for i in range(8)]


def _warm(router):
    """Non-trivial learned state in every component."""
    torch_side = isinstance(router, OptiRoute)
    eng = (ServingEngine if torch_side else JServingEngine)(router)
    out = eng.submit(_requests(Request if torch_side else JRequest))
    eng.observe(out, list(np.linspace(0.3, 0.9, 8)))
    router.give_feedback(out[0].rq, True)
    router.give_feedback(out[1].rq, False)
    if router.load is not None:
        router.load.admit_many(np.array([0, 0, 3, 5]))
        router.load.start(0)
        router.load.finish(0, 0.123)
    return out


def _assert_same_state(r1, r2):
    np.testing.assert_array_equal(r1.adaptive.A, r2.adaptive.A)
    np.testing.assert_array_equal(r1.adaptive.b, r2.adaptive.b)
    np.testing.assert_array_equal(r1.adaptive.counts, r2.adaptive.counts)
    assert r1.feedback.state() == r2.feedback.state()
    for a, b in zip(r1.load.state().values(), r2.load.state().values()):
        np.testing.assert_array_equal(a, b)
    for name in ("vecs", "fps", "quality", "created", "last_used", "valid"):
        np.testing.assert_array_equal(getattr(r1.cache, name),
                                      getattr(r2.cache, name))
    assert r1.cache.models == r2.cache.models


def test_round_trip_bit_exact_routing(tmp_path):
    r1 = _build()
    _warm(r1)
    _, (prefs, sigs) = queries(6, seed=7)
    before = r1.engine.route_many(prefs, sigs)
    state = RouterState(str(tmp_path))
    state.save(r1, step=5)
    r2 = _build()
    assert state.restore(r2) == 5
    _assert_same_state(r1, r2)
    after = r2.engine.route_many(prefs, sigs)
    for a, b in zip(before, after):
        assert a.model == b.model
        assert a.score == b.score                # bit-exact, no approx
        assert a.candidates == b.candidates
        assert a.fallback_kind == b.fallback_kind


def test_restored_cache_answers_warm(tmp_path):
    r1 = _build()
    _warm(r1)
    state = RouterState(str(tmp_path))
    state.save(r1, step=1)
    r2 = _build()
    state.restore(r2)
    out2 = ServingEngine(r2).submit(_requests(Request))
    hits = [r for r in out2 if r.cache_hit]
    assert hits, "restored cache must answer the replayed head"
    stored = {m for m, ok in zip(r1.cache.models, r1.cache.valid) if ok}
    assert {r.model for r in hits} <= stored


def test_single_file_variant(tmp_path):
    r1 = _build()
    _warm(r1)
    path = str(tmp_path / "router.npz")
    save_router_state(path, r1)
    r2 = _build()
    meta = load_router_state(path, r2)
    assert meta["router_state_version"] == 1
    assert sorted(meta["components"]) == ["bandit", "cache", "feedback",
                                          "load"]
    _, (prefs, sigs) = queries(4, seed=2)
    for a, b in zip(r1.engine.route_many(prefs, sigs),
                    r2.engine.route_many(prefs, sigs)):
        assert a.model == b.model and a.score == b.score


def test_cold_start_and_retention(tmp_path):
    state = RouterState(str(tmp_path / "empty"))
    assert state.restore(_build()) is None       # cold start: no-op
    r = _build()
    _warm(r)
    state2 = RouterState(str(tmp_path / "steps"), keep=2)
    for step in (1, 2, 3, 4):
        state2.save(r, step=step)
    assert state2.mgr.steps() == [3, 4]          # retention pruned 1, 2
    assert state2.restore(_build()) == 4


def test_feedback_only_router_round_trips(tmp_path):
    r1 = _build(with_all=False)
    r1.feedback.record(TaskSignature(), "m3", True)
    path = str(tmp_path / "fb.npz")
    save_router_state(path, r1)
    r2 = _build(with_all=False)
    meta = load_router_state(path, r2)
    assert meta["components"] == ["feedback"]
    assert r1.feedback.state() == r2.feedback.state()


def test_restore_into_missing_component_raises(tmp_path):
    r1 = _build()
    _warm(r1)
    path = str(tmp_path / "full.npz")
    save_router_state(path, r1)
    with pytest.raises(ValueError, match="no such component"):
        load_router_state(path, _build(with_all=False))


def test_empty_feedback_round_trips(tmp_path):
    r1 = _build()
    path = str(tmp_path / "empty.npz")
    save_router_state(path, r1)                  # nothing learned yet
    r2 = _build()
    load_router_state(path, r2)
    assert r2.feedback.state() == []
    assert len(r2.cache) == 0


@pytest.mark.parametrize("saved_by", ["repro", "repro_torch"])
def test_snapshot_restores_across_packages(tmp_path, saved_by):
    """A snapshot written by one package restores in the other: every
    component bit-exact, the decisions matching tie-aware, and the
    replayed head hitting the restored cache."""
    src = _build(torch_side=saved_by == "repro_torch")
    dst = _build(torch_side=saved_by == "repro")
    _warm(src)
    path = str(tmp_path / "router.npz")
    (save_router_state if saved_by == "repro_torch" else j_save)(path, src)
    meta = (j_load if saved_by == "repro_torch" else load_router_state)(
        path, dst)
    assert sorted(meta["components"]) == ["bandit", "cache", "feedback",
                                          "load"]
    _assert_same_state(src, dst)
    (jp, js), (tp, ts) = queries(9, seed=3)
    j_router, t_router = (src, dst) if saved_by == "repro" else (dst, src)
    assert_decisions_match(j_router.engine.route_many(jp, js),
                           t_router.engine.route_many(tp, ts))
    t_out = ServingEngine(t_router).submit(_requests(Request))
    j_out = JServingEngine(j_router).submit(_requests(JRequest))
    assert [r.cache_hit for r in t_out] == [r.cache_hit for r in j_out]
    assert any(r.cache_hit for r in t_out)


def test_thompson_router_round_trips(tmp_path):
    """The staged path of a Thompson router routes identically after a
    restore once both generators stand at the same point."""
    r1 = _build(policy="thompson")
    _warm(r1)
    path = str(tmp_path / "t.npz")
    save_router_state(path, r1)
    r2 = _build(policy="thompson")
    load_router_state(path, r2)
    r1.adaptive._rng = np.random.default_rng(17)
    r2.adaptive._rng = np.random.default_rng(17)
    _, (prefs, sigs) = queries(6, seed=5)
    for a, b in zip(r1.engine.route_many(prefs, sigs),
                    r2.engine.route_many(prefs, sigs)):
        assert a.model == b.model and a.score == b.score


def test_store_turns_tensors_into_numpy(tmp_path):
    """Tensors in a saved tree come back as numpy with the same bits;
    nested lists and dicts keep their structure."""
    import torch
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [np.int32(3), {"c": torch.tensor([1, 2], dtype=torch.int64)}]}
    path = str(tmp_path / "t.npz")
    save(path, tree, {"k": 1})
    back, meta = load(path)
    assert meta == {"k": 1}
    np.testing.assert_array_equal(back["a"], tree["a"].numpy())
    assert back["b"][0] == 3
    np.testing.assert_array_equal(back["b"][1]["c"], [1, 2])


@pytest.mark.parametrize("capacity", [32, 12, 3])
def test_cache_load_state_compacts_like_the_reference(capacity):
    """A cache snapshot restored into a cache of another capacity: the
    live entries compacted in slot order, as the reference does; more
    live entries than the capacity holds raise in both."""
    src = _build()
    _warm(src)
    st = src.cache.state()
    live = int(st["valid"].sum())
    mine = SemanticCache(capacity=capacity, sketch_dims=16, device="cpu")
    ref = JCache(capacity=capacity, sketch_dims=16)
    if live > capacity:
        for c in (mine, ref):
            with pytest.raises(ValueError, match="capacity"):
                c.load_state(st)
        return
    mine.load_state(st)
    ref.load_state(st)
    for name in ("vecs", "fps", "quality", "created", "last_used", "valid"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    assert mine.models == ref.models and len(mine) == live
    assert [None if s is None else vars(s) for s in mine.sigs] == \
        [None if s is None else vars(s) for s in ref.sigs]
