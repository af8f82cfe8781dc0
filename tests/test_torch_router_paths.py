"""The staged routing path and the Thompson-policy bandit, held against
the JAX package: the same numpy-seeded catalogs, signatures and bandit
updates go through ``repro`` (the Pallas kNN in interpret mode,
``use_kernel=True, kernel_min_n=1``) and ``repro_torch`` (``device=
"cpu"``, the kernels' plain versions).  Decisions are compared
tie-aware (a model may differ only where the reference ranks the two
within 1e-5), scores within 1e-5, fallback rungs exactly; the bandit
within rtol 1e-5."""
import numpy as np
import pytest

from repro.adaptive.bandit import LinearBandit as JBandit
from repro.core.feedback import FeedbackStore as JFeedback
from repro.core.mres import MRES as JMRES
from repro.core.mres import ModelEntry as JEntry
from repro.core.orchestrator import OptiRoute as JOptiRoute
from repro.core.preferences import (DOMAINS, METRICS, TASK_TYPES,
                                    TaskSignature as JSig,
                                    UserPreferences as JPrefs)
from repro.core.routing import RoutingEngine as JEngine
from repro.kernels import ops as K
from repro.serving.load import LoadTracker as JLoad
from repro_torch.adaptive import LinearBandit as TBandit
from repro_torch.core.feedback import FeedbackStore as TFeedback
from repro_torch.core.mres import MRES as TMRES
from repro_torch.core.mres import ModelEntry as TEntry
from repro_torch.core.orchestrator import OptiRoute as TOptiRoute
from repro_torch.core.preferences import TaskSignature as TSig
from repro_torch.core.preferences import UserPreferences as TPrefs
from repro_torch.core.routing import RoutingEngine as TEngine
from repro_torch.kernels import ops as P
from repro_torch.serving.load import LoadTracker as TLoad

TOL = 1e-5


def catalog_spec(n: int, seed: int):
    """Entries as plain dicts (the reference's ``random_catalog``
    distribution), so both packages register the same catalog."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        raw = {"accuracy": float(rng.random()),
               "latency_ms": float(rng.random() * 500 + 1),
               "cost_per_mtok": float(rng.random() * 20 + 0.1),
               "helpfulness": float(rng.random()),
               "harmlessness": float(rng.random()),
               "honesty": float(rng.random()),
               "steerability": 0.5, "creativity": 0.5}
        tts = tuple(rng.choice(TASK_TYPES, size=int(rng.integers(1, 4)),
                               replace=False))
        dms = tuple(rng.choice(DOMAINS, size=int(rng.integers(1, 3)),
                               replace=False))
        out.append(dict(name=f"m{i}", raw_metrics=raw, task_types=tts,
                        domains=dms, generalist=bool(rng.random() < 0.3)))
    return out


def catalogs(spec):
    """(repro MRES, repro_torch MRES) of the same entries."""
    jm, tm = JMRES(), TMRES()
    jm.register_many([JEntry(**dict(e, raw_metrics=dict(e["raw_metrics"])))
                      for e in spec])
    tm.register_many([TEntry(**dict(e, raw_metrics=dict(e["raw_metrics"])))
                      for e in spec])
    return jm, tm


def queries(b: int, seed: int):
    """(prefs, sigs) for each package from one seeded draw."""
    rng = np.random.default_rng(seed)
    rows = [(str(rng.choice(TASK_TYPES)), str(rng.choice(DOMAINS)),
             float(rng.random()), float(rng.random())) for _ in range(b)]
    w = [{m: float(rng.random()) for m in METRICS} for _ in range(b)]
    return (([JPrefs(weights=x) for x in w],
             [JSig(task_type=t, domain=d, complexity=c, confidence=f)
              for t, d, c, f in rows]),
            ([TPrefs(weights=x) for x in w],
             [TSig(task_type=t, domain=d, complexity=c, confidence=f)
              for t, d, c, f in rows]))


def tied(d, tol=TOL) -> bool:
    """The reference decision's two best candidates within ``tol``."""
    c = d.candidates
    return len(c) > 1 and c[0][1] - c[1][1] <= tol


def assert_decisions_match(want, got, tol=TOL):
    """Tie-aware: same fallback rung, score within ``tol``, and the same
    model unless the reference's top two tie."""
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.fallback_kind == b.fallback_kind, i
        assert a.used_fallback == b.used_fallback, i
        assert b.score == pytest.approx(a.score, abs=tol), i
        assert len(a.candidates) == len(b.candidates), i
        assert a.stage_sizes == b.stage_sizes, i
        if a.model != b.model:
            assert tied(a, tol), (i, a.model, b.model, a.candidates[:2])
            continue
        assert b.similarity == pytest.approx(a.similarity, abs=tol), i
        for (_, sa), (_, sb) in zip(a.candidates, b.candidates):
            assert sb == pytest.approx(sa, abs=tol), i


def engines(n, seed, *, fb=True, ad=True, load=True, policy="linucb",
            knn_k=8):
    """(repro engine, repro_torch engine) with the same feedback
    records, bandit updates and load, the reference on its kernel
    path."""
    jm, tm = catalogs(catalog_spec(n, seed))
    rng = np.random.default_rng(seed + 1)
    jfb = tfb = None
    if fb:
        jfb, tfb = JFeedback(), TFeedback()
        for _ in range(50):
            t, d = str(rng.choice(TASK_TYPES)), str(rng.choice(DOMAINS))
            c, m, up = float(rng.random()), f"m{int(rng.integers(n))}", \
                bool(rng.random() < 0.5)
            jfb.record(JSig(task_type=t, domain=d, complexity=c), m, up)
            tfb.record(TSig(task_type=t, domain=d, complexity=c), m, up)
    jad = tad = None
    if ad:
        jad = JBandit(n, policy=policy, seed=seed)
        tad = TBandit(n, policy=policy, seed=seed, device="cpu")
        for _ in range(4):
            X = rng.random((16, len(METRICS))).astype(np.float32)
            ch, r = rng.integers(0, n, 16), rng.random(16).astype(np.float32)
            jad.update(X, ch, r)
            tad.update(X, ch, r)
    jl = tl = None
    if load:
        jl, tl = JLoad(n), TLoad(n)
        for j in rng.integers(0, n, 3 * n):
            jl.admit(int(j))
            tl.admit(int(j))
    kw = dict(knn_k=knn_k, adaptive_weight=0.7 if ad else 0.0,
              load_weight=0.5 if load else 0.0)
    je = JEngine(jm, jfb, adaptive=jad, load=jl, use_kernel=True,
                 kernel_min_n=1, **kw)
    te = TEngine(tm, tfb, adaptive=tad, load=tl, device="cpu", **kw)
    return je, te


@pytest.mark.parametrize("b", [1, 13])
@pytest.mark.parametrize("flags", [(False, False, False), (True, False, True),
                                   (True, True, True)],
                         ids=["plain", "fb+load", "full"])
def test_staged_matches_jax_staged(b, flags):
    je, te = engines(64, seed=b, fb=flags[0], ad=flags[1], load=flags[2])
    (jp, js), (tp, ts) = queries(b, seed=b + 5)
    assert_decisions_match(je.route_many_staged(jp, js),
                           te.route_many_staged(tp, ts))


@pytest.mark.parametrize("b", [1, 13])
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True)],
                         ids=["plain", "full"])
def test_port_fused_matches_port_staged(b, flags):
    """The reference's invariant inside the port: the fused program and
    the staged path route alike (test_fused_matches_staged_full_blend)."""
    _, te = engines(64, seed=b, fb=flags[0], ad=flags[1], load=flags[2])
    _, (tp, ts) = queries(b, seed=b + 5)
    assert_decisions_match(te.route_many_batch(tp, ts).decisions(),
                           te.route_many_staged(tp, ts))


def _fallback_heavy():
    """A catalog with narrow coverage: every fallback rung fires."""
    def entry(name, tts, dms=("general",), gen=False):
        raw = {m: 0.5 for m in ("accuracy", "helpfulness", "harmlessness",
                                "honesty", "steerability", "creativity")}
        raw.update(latency_ms=100.0, cost_per_mtok=1.0)
        return dict(name=name, raw_metrics=raw, task_types=tts, domains=dms,
                    generalist=gen)
    spec = [entry("gen", ("chat",), gen=True),
            entry("coder", ("code",), ("software",)),
            entry("fin", ("classification",), ("finance",))]
    rows = [("vqa", "healthcare", 0.5, 1.0), ("code", "software", 0.5, 1.0),
            ("code", "legal", 0.5, 1.0), ("chat", "general", 0.5, 0.1)]
    return spec, rows


@pytest.mark.parametrize("policy", ["none", "linucb", "thompson"])
def test_staged_fallback_heavy_matches_jax(policy):
    spec, rows = _fallback_heavy()
    jm, tm = catalogs(spec)
    jkw, tkw = {}, {}
    if policy != "none":
        jkw = dict(adaptive=JBandit(3, policy=policy, seed=2),
                   adaptive_weight=0.5)
        tkw = dict(adaptive=TBandit(3, policy=policy, seed=2, device="cpu"),
                   adaptive_weight=0.5)
    je = JEngine(jm, knn_k=4, use_kernel=True, kernel_min_n=1, **jkw)
    te = TEngine(tm, knn_k=4, device="cpu", **tkw)
    js = [JSig(task_type=t, domain=d, complexity=c, confidence=f)
          for t, d, c, f in rows]
    ts = [TSig(task_type=t, domain=d, complexity=c, confidence=f)
          for t, d, c, f in rows]
    want = je.route_many_staged("balanced", js)
    got = te.route_many_staged("balanced", ts)
    assert_decisions_match(want, got)
    assert [d.fallback_kind for d in got] == \
        ["generalist", "", "task-type-only", ""]
    if policy != "thompson":
        assert_decisions_match(got,
                               te.route_many_batch("balanced", ts).decisions())


def test_thompson_staged_matches_jax_over_batches():
    """Several batches on one seed: the candidate-column union fixes the
    Thompson draws, so equal kNN sets give equal random streams."""
    je, te = engines(96, seed=7, policy="thompson")
    for step in range(4):
        (jp, js), (tp, ts) = queries(11, seed=40 + step)
        want = je.route_many(jp, js)
        got = te.route_many(tp, ts)
        assert_decisions_match(want, got)
        col = {m: j for j, m in enumerate(te.mres.snapshot()[1])}
        X = np.stack([d.task_vector for d in got])
        r = np.linspace(0.2, 0.9, len(got)).astype(np.float32)
        ch = np.array([col[d.model] for d in got])
        je.adaptive.update(X, ch, r)
        te.adaptive.update(X, ch, r)
    np.testing.assert_allclose(te.adaptive.A, je.adaptive.A, rtol=TOL,
                               atol=1e-6)
    np.testing.assert_allclose(te.adaptive.b, je.adaptive.b, rtol=TOL,
                               atol=1e-6)


@pytest.mark.parametrize("policy", ["linucb", "thompson"])
def test_bandit_scores_match_jax_over_steps(policy):
    """``scores_at``, ``scores`` and ``predict`` of one seed over
    several update steps (Thompson: the same draws from the same
    generator); the update is the kernel's plain version in the port
    and numpy in the reference."""
    n, m = 24, len(METRICS)
    rng = np.random.default_rng(11)
    jb = JBandit(n, policy=policy, seed=3, noise=0.3)
    tb = TBandit(n, policy=policy, seed=3, noise=0.3, device="cpu")
    for step in range(4):
        X = rng.random((9, m)).astype(np.float32)
        ch, r = rng.integers(0, n, 9), rng.random(9).astype(np.float32)
        jb.update(X, ch, r)
        tb.update(X, ch, r)
        np.testing.assert_allclose(tb.A, jb.A, rtol=TOL, atol=1e-6)
        np.testing.assert_allclose(tb.b, jb.b, rtol=TOL, atol=1e-6)
        Xs = rng.random((5, m)).astype(np.float32)
        cols = np.unique(rng.integers(0, n, 7))
        for what, f in (("scores_at", lambda b: b.scores_at(Xs, cols)),
                        ("scores", lambda b: b.scores(Xs)),
                        ("predict", lambda b: b.predict(Xs))):
            np.testing.assert_allclose(f(tb), f(jb), rtol=TOL, atol=1e-6,
                                       err_msg=f"{what} step {step}")


def test_thompson_update_and_score_matches_jax():
    n, m = 16, len(METRICS)
    rng = np.random.default_rng(2)
    jb = JBandit(n, policy="thompson", seed=9)
    tb = TBandit(n, policy="thompson", seed=9, device="cpu")
    for _ in range(3):
        X, Xs = rng.random((6, m)), rng.random((4, m))
        ch, r = rng.integers(0, n, 6), rng.random(6)
        np.testing.assert_allclose(tb.update_and_score(X, ch, r, Xs),
                                   jb.update_and_score(X, ch, r, Xs),
                                   rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(tb.counts, jb.counts)


def test_thompson_refuses_to_fuse():
    _, tm = catalogs(catalog_spec(16, seed=2))
    eng = TEngine(tm, adaptive=TBandit(16, policy="thompson", device="cpu"),
                  adaptive_weight=0.5, device="cpu")
    assert not eng._fused_ok()
    _, (tp, ts) = queries(4, seed=2)
    with pytest.raises(ValueError, match="not fusable"):
        eng.route_many_batch(tp, ts)
    with pytest.raises(ValueError, match="not fusable"):
        eng.route_tokens_batch(None, None, np.zeros((4, 8), np.int32),
                               tp)
    out = eng.route_many(tp, ts)            # staged, and functional
    assert len(out) == 4 and all(d.model for d in out)
    eng.adaptive_weight = 0.0               # a bandit out of the blend
    assert eng._fused_ok()
    eng.fused = False
    assert not eng._fused_ok()
    with pytest.raises(ValueError, match="not fusable"):
        eng.route_many_batch(tp, ts)
    with pytest.raises(ValueError):
        TBandit(4, policy="epsilon", device="cpu")


@pytest.mark.parametrize("B,N,k,seed", [(4, 40, 8, 0), (13, 300, 8, 1),
                                        (64, 1000, 5, 2), (7, 129, 16, 3)])
def test_knn_rows_bit_equal_to_dense_mask(B, N, k, seed):
    """The staged kNN's (table, rows) op equals the dense (B, N) mask
    call bit for bit: values everywhere, indices on every finite slot."""
    rng = np.random.default_rng(seed)
    M = len(METRICS)
    emb = rng.random((N, M)).astype(np.float32)
    nt, nd = len(TASK_TYPES), len(DOMAINS)
    tt = np.vstack([rng.random((nt, N)) < 0.1, np.ones((1, N), bool)])
    dm = np.vstack([rng.random((nd, N)) < 0.2, np.ones((1, N), bool)])
    tt[:2] = False                           # empty filter rows
    gmask = rng.random(N) < 0.1
    T = rng.random((B, M)).astype(np.float32)
    ti = rng.integers(0, nt + 1, B)
    di = rng.integers(0, nd + 1, B)
    vals, idx = P.knn_rows(emb, tt, dm, gmask, T, ti, di, k=k, device="cpu")
    dv, di_ = P.router_topk(emb, T, k, mask=tt[ti] & dm[di], device="cpu")
    dv, di_ = dv.numpy(), di_.numpy()
    np.testing.assert_array_equal(vals, dv)
    fin = np.isfinite(dv)
    assert (~fin).any() and fin.any()
    np.testing.assert_array_equal(idx[fin], di_[fin])
    # and against the reference's dense-mask Pallas call: the same
    # candidate rows, cosines within 1e-6
    jv, ji = K.router_topk(emb, T, k, mask=tt[ti] & dm[di])
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(jv), fin)
    np.testing.assert_allclose(vals[fin], jv[fin], atol=1e-6)
    for b in range(B):
        assert set(idx[b][fin[b]]) == set(ji[b][fin[b]]) or \
            np.ptp(vals[b][fin[b]][-2:]) <= 1e-6


def test_knn_rows_is_one_launch_and_reuses_the_pack():
    _, te = engines(200, seed=4, fb=False, ad=False, load=False)
    _, (tp, ts) = queries(9, seed=4)
    P.reset_catalog_cache()
    te.route_many_staged(tp, ts)
    keys = P.catalog_cache_info()["keys"]
    assert len(keys) == 2                    # the pack and its unit rows
    te.route_many_staged(tp, ts)
    assert P.catalog_cache_info()["keys"] == keys


class _StubAnalyzer:
    """Signatures from the text, for both packages."""

    def __init__(self, sig_cls):
        self.sig_cls = sig_cls

    def analyze_batch(self, texts):
        return [self.sig_cls(task_type=TASK_TYPES[len(t) % 11],
                             domain=DOMAINS[len(t) % 6],
                             complexity=(len(t) % 10) / 10,
                             confidence=0.9) for t in texts]


@pytest.mark.parametrize("policy", ["linucb", "thompson"])
def test_route_all_staged_branch_matches_jax(policy):
    """``OptiRoute.route_all`` on the staged branch (fused=False, or a
    Thompson bandit): eager decisions on the RoutedQuery, its ``sig``,
    ``model`` and ``task_vector`` work, and observe folds them in."""
    from repro.data.workload import make_workload
    jm, tm = catalogs(catalog_spec(64, seed=3))
    jr = JOptiRoute(jm, _StubAnalyzer(JSig), use_kernel=True,
                    adaptive=JBandit(64, policy=policy, seed=5),
                    adaptive_weight=0.5)
    tr = TOptiRoute(tm, _StubAnalyzer(TSig),
                    adaptive=TBandit(64, policy=policy, seed=5,
                                     device="cpu"),
                    adaptive_weight=0.5, device="cpu")
    jr.engine._kernel_min_n = 1
    jr.engine.fused = tr.engine.fused = False
    texts = [r.text for r in make_workload(13, seed=9)]
    for step in range(2):
        ja = jr.route_all(texts, "balanced")
        ta = tr.route_all(texts, "balanced")
        assert all(q._decision is not None and q._batch is None for q in ta)
        assert_decisions_match([q.decision for q in ja],
                               [q.decision for q in ta])
        for a, b in zip(ja, ta):
            assert vars(a.sig) == vars(b.sig)
            np.testing.assert_array_equal(a.task_vector, b.task_vector)
        q = np.linspace(0.1, 0.9, len(texts))
        jr.observe(ja, q)
        tr.observe(ta, q)
    np.testing.assert_allclose(tr.adaptive.A, jr.adaptive.A, rtol=TOL,
                               atol=1e-6)
