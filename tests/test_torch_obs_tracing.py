"""Telemetry and tracing threaded through the port's serving path
(``device="cpu"``): every response (hit / miss / rerouted / shed)
carries a trace whose tree holds exactly the stages that ran for it;
the fused programs' spans nest under the batch trace; the telemetry
counters equal the ops dispatch counters; a router built without sinks
runs the same path with the same launch counts."""
import numpy as np
import pytest

from repro_torch.cache.semantic import SemanticCache
from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
from repro_torch.core.orchestrator import OptiRoute
from repro_torch.core.preferences import TaskSignature
from repro_torch.core.telemetry import Telemetry
from repro_torch.kernels import ops
from repro_torch.obs import Tracer
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.load import LoadTracker
from tests.test_torch_router_paths import catalog_spec, catalogs

CFG = AnalyzerConfig(vocab_size=256, d_model=16, n_layers=1, n_heads=2,
                     d_ff=32, max_len=16)


class _Stub:
    def analyze_batch(self, texts):
        return [TaskSignature(task_type="chat", domain="general",
                              complexity=0.4) for _ in texts]


def _catalog(n=8, seed=4):
    return catalogs(catalog_spec(n, seed))[1]


def build_engine(*, load=None, cache=None, tracer=True, seed=4,
                 analyzer=None, adaptive=None):
    tel = Telemetry()
    tr = Tracer() if tracer else None
    router = OptiRoute(_catalog(seed=seed), analyzer or _Stub(),
                       telemetry=tel, tracer=tr, load=load, cache=cache,
                       adaptive=adaptive,
                       adaptive_weight=0.5 if adaptive else 0.0,
                       device="cpu")
    return ServingEngine(router), tel, tr


def _req(i, text=None, deadline_ms=None):
    return Request(text=text or f"query {i}", prefs="balanced", id=i,
                   max_new=4, deadline_ms=deadline_ms,
                   tenant=f"team{i % 2}")


def _child_names(tree):
    return sorted(c["name"] for c in tree["children"])


def _expected_stages(resp, req, *, cache_attached, load_attached):
    stages = ["cache_lookup"] if cache_attached else []
    if not resp.cache_hit:
        stages += ["analyze", "route_step"]
        if load_attached and req.deadline_ms is not None:
            stages.append("admission")
        if not resp.shed:
            stages.append("generate")
    return sorted(stages)


def test_every_response_trace_matches_stages_ran():
    eng, tel, tr = build_engine(load=LoadTracker(8),
                                cache=SemanticCache(capacity=64,
                                                    device="cpu"))
    reqs = [_req(i, deadline_ms=(None, 10_000.0, 1e-3)[i % 3])
            for i in range(9)]
    out = eng.submit(reqs)
    assert [r.admission for r in out[2::3]] == ["shed"] * 3
    for req, resp in zip(reqs, out):
        tree = tr.summary_tree(resp.trace_id)
        assert tree["name"] == "request"
        assert tree["attrs"]["request_id"] == req.id
        assert tree["attrs"]["tenant"] == req.tenant
        assert tree["attrs"]["admission"] == resp.admission
        assert tree["attrs"]["model"] == resp.model
        assert _child_names(tree) == _expected_stages(
            resp, req, cache_attached=True, load_attached=True)
    (adm,) = [c for c in tr.summary_tree(out[2].trace_id)["children"]
              if c["name"] == "admission"]
    assert adm["attrs"]["verdict"] == "shed"
    assert tel.admission_funnel() == {"admitted": 3, "shed": 3}
    assert tel.cache_funnel()["miss"] == 9


def test_cache_hit_trace_short_circuits():
    eng, tel, tr = build_engine(load=LoadTracker(8),
                                cache=SemanticCache(capacity=64,
                                                    device="cpu"))
    first = eng.submit([_req(i) for i in range(4)])
    eng.observe(first, [0.9] * 4)               # validate -> store
    second = eng.submit([_req(i) for i in range(4)])
    assert all(r.cache_hit for r in second)
    for r in second:
        tree = tr.summary_tree(r.trace_id)
        assert _child_names(tree) == ["cache_lookup"]
        assert tree["children"][0]["attrs"]["outcome"] == "hit"
    for r in first:
        tree = tr.summary_tree(r.trace_id)
        assert "generate" in _child_names(tree)
        assert "observe" in _child_names(tree)
    f = tel.cache_funnel()
    assert (f["hit"], f["miss"], f["stored"]) == (4, 4, 4)
    s = eng.summary()
    assert s["cache_hits"] == 4 and s["requests"] == 8


def test_rerouted_response_trace():
    load = LoadTracker(8)
    eng, _, tr = build_engine(load=load, seed=2)
    probe = eng.submit([_req(0)])[0]
    names = list(eng.router.mres.snapshot()[1])
    load.admit(names.index(probe.model), count=100)
    (resp,) = eng.submit([_req(1, text="fresh text", deadline_ms=500.0)])
    assert resp.admission == "rerouted" and resp.model != probe.model
    tree = tr.summary_tree(resp.trace_id)
    (adm,) = [c for c in tree["children"] if c["name"] == "admission"]
    assert adm["attrs"]["verdict"] == "rerouted"
    assert "generate" in _child_names(tree)


@pytest.mark.parametrize("path", ["dense", "fused", "staged"])
def test_batch_trace_tree_spans_whole_pipeline(path):
    """The batch 'submit' root nests every stage span, including the
    program's own route_step span with its bucket attributes, through
    the contextvar alone."""
    kw = {}
    if path != "dense":
        kw["analyzer"] = TaskAnalyzer(CFG, seed=1, device="cpu")
    if path == "staged":
        from repro_torch.adaptive import LinearBandit
        kw["adaptive"] = LinearBandit(8, policy="thompson", device="cpu")
    eng, _, tr = build_engine(load=LoadTracker(8),
                              cache=SemanticCache(capacity=64,
                                                  device="cpu"), **kw)
    out = eng.submit([_req(i, deadline_ms=10_000.0) for i in range(5)])
    (submit,) = [s for s in tr.spans() if s.name == "submit"]
    tree = tr.summary_tree(submit.trace_id)
    assert tree["attrs"] == {"batch": 5, "mode": "interactive"}
    names = _child_names(tree)
    for stage in ("cache_lookup", "analyze", "route_step", "admission",
                  "generate"):
        assert stage in names, (stage, names)
    (rs,) = [c for c in tree["children"] if c["name"] == "route_step"]
    assert rs["attrs"]["batch"] == 5
    assert rs["attrs"]["path"] == path
    if path != "staged":
        assert rs["attrs"]["q_bucket"] == 8
        assert rs["attrs"]["n_bucket"] == 128
        assert rs["attrs"]["catalog_n"] == 8
        assert rs["attrs"]["shards"] == 1 and rs["attrs"]["compiles"] == 0
        assert rs["attrs"]["quant"] is False
    (an,) = [c for c in tree["children"] if c["name"] == "analyze"]
    if path == "staged":                # the analyzer program's own span
        (st,) = an["children"]
        assert st["name"] == "analyze_step"
        assert st["attrs"]["path"] == "analyze"
    for r in out:
        assert tr.summary_tree(r.trace_id)["attrs"]["batch_trace"] == \
            submit.trace_id


@pytest.mark.parametrize("path", ["fused", "staged"])
def test_telemetry_counters_equal_ops_counters(path):
    """One dispatch per routed batch in each counter family, 0
    compiles, equal to the deltas of ``ops.route_step_stats()``; one
    route event per routed query."""
    from repro_torch.adaptive import LinearBandit
    policy = "linucb" if path == "fused" else "thompson"
    eng, tel, _ = build_engine(
        cache=SemanticCache(capacity=64, device="cpu"),
        analyzer=TaskAnalyzer(CFG, seed=1, device="cpu"),
        adaptive=LinearBandit(8, policy=policy, device="cpu"))
    ops.reset_route_step_stats()
    batches = [[_req(i) for i in range(6)], [_req(i) for i in range(3)],
               [_req(i) for i in range(6, 10)]]
    for b in batches:
        before = ops.route_step_stats()
        t_before = (tel.route_step_stats(), tel.analyze_step_stats())
        out = eng.submit(b)
        eng.observe(out, [0.9] * len(out))
        after = ops.route_step_stats()
        for fam, t0 in zip(("route_step", "analyze_step"), t_before):
            got = getattr(tel, f"{fam}_stats")()
            assert got["dispatches"] - t0["dispatches"] == \
                after[f"{fam}_dispatches"] - before[f"{fam}_dispatches"]
            assert got["compiles"] == 0
    routed = sum(not r.cache_hit for r in eng.log)
    assert tel.summary()["events"] == routed
    # batch 2 repeats batch 1's head: all hits, no dispatch
    assert tel.analyze_step_stats()["dispatches"] == 2
    assert tel.route_step_stats()["dispatches"] == \
        (2 if path == "fused" else 0)
    assert tel.cache_funnel()["hit"] == 3


def test_give_feedback_attaches_thumbs():
    eng, tel, _ = build_engine()
    out = eng.submit([_req(i) for i in range(3)])
    before = eng.router.feedback.version()
    eng.router.give_feedback(out[0].rq, True)
    eng.feedback(out[1], False)
    assert eng.router.feedback.version() == before + 2
    agg = tel.per_model()[out[0].model]
    assert agg["thumbs_up"] == 1


def test_observe_attaches_outcome_span_and_untraced_engine():
    eng, _, tr = build_engine(cache=SemanticCache(capacity=64,
                                                  device="cpu"))
    out = eng.submit([_req(i) for i in range(3)])
    eng.observe(out, [0.8, 0.6, 0.7])
    for r, q in zip(out, (0.8, 0.6, 0.7)):
        (obs,) = [c for c in tr.summary_tree(r.trace_id)["children"]
                  if c["name"] == "observe"]
        assert obs["attrs"]["quality"] == pytest.approx(q)
    (router_obs,) = [s for s in tr.spans() if s.name == "observe"
                     and s.parent_id == ""]
    assert router_obs.attrs["cacheable"] == 3
    eng2, _, tr2 = build_engine(tracer=False)
    (r,) = eng2.submit([_req(0)])
    assert tr2 is None and r.trace_id == "" and r.trace_root is None


def test_sinks_change_no_decision_and_no_launch_count():
    """The same batches through a router with and without sinks: equal
    responses and equal dispatch counts."""
    runs = []
    for sinks in (False, True):
        eng, tel, tr = build_engine(
            tracer=sinks, load=LoadTracker(8),
            cache=SemanticCache(capacity=64, device="cpu"),
            analyzer=TaskAnalyzer(CFG, seed=1, device="cpu"))
        if not sinks:
            eng.router.telemetry = eng.router.engine.telemetry = None
            eng.router.analyzer.telemetry = None
        ops.reset_route_step_stats()
        res = []
        for b in ([_req(i, deadline_ms=5e3) for i in range(6)],
                  [_req(i) for i in range(3, 9)]):
            out = eng.submit(b)
            eng.observe(out, [0.9] * len(out))
            res.append([(r.model, r.admission, r.cache_hit) for r in out])
        runs.append((res, ops.route_step_stats()))
    assert runs[0] == runs[1]


def test_summary_of_an_empty_and_a_one_request_engine():
    eng, _, _ = build_engine(tracer=False)
    assert eng.summary() == {}
    out = eng.submit([Request(text="q", prefs="balanced", id=0)])
    s = eng.summary()
    stats = s["latency"][out[0].model]
    assert stats["p50_s"] == stats["p99_s"]
    assert s["cache_hits"] == 0 and s["admissions"] == {"admitted": 1}
    np.testing.assert_equal(s["models"], {out[0].model: 1})
