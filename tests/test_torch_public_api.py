"""Public API of the reference that the port carries: ``RoutingBatch.
models()`` / ``.signatures()``, ``RoutingEngine.task_vector``,
``TaskAnalyzer.analyze`` / ``to_json``, ``OracleAnalyzer``,
``ops.router_topk(..., weights=)`` in the reference's positional order,
and ``route_tokens_batch(params, cfg, tokens, prefs_batch)``.  The same
numpy inputs go through ``repro`` (Pallas in interpret mode, the kernel
path forced) and ``repro_torch`` (``device="cpu"``, the plain versions).

Tolerances: decisions tie-aware (a model may differ only where the
reference ranks its two best within 1e-5); analyzer heads compared where
the reference's top-2 probability gap exceeds 1e-4, complexity and
confidence within 1e-5; task vectors exact (the same f32 max); weighted
top-k values within 1e-6, the int8 scores bit for bit on shared int8
operands."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyzer as JA
from repro.core.preferences import DOMAINS, METRICS, TASK_TYPES
from repro.core.preferences import TaskSignature as JSig
from repro.core.preferences import UserPreferences as JPrefs
from repro.core.routing import RoutingEngine as JEngine
from repro.data.workload import make_workload as jmake_workload
from repro.kernels import ops as K
from repro.kernels import ref as R
from repro_torch.core import analyzer as TA
from repro_torch.core.preferences import TaskSignature as TSig
from repro_torch.core.preferences import UserPreferences as TPrefs
from repro_torch.core.routing import RoutingEngine as TEngine
from repro_torch.data.workload import make_workload as tmake_workload
from repro_torch.kernels import ops as P
from repro_torch.kernels import router_topk as RT
from repro_torch.kernels.route_step import unit_rows
from tests.test_torch_analyzer import (CFG_J, CFG_T, _decided, _np_tree,
                                       _texts)
from tests.test_torch_kernels import _cos, _problem, _ref_topk, \
    assert_topk_match
from tests.test_torch_router_paths import engines, queries, tied


@pytest.fixture(scope="module")
def analyzers():
    """(reference analyzer, port analyzer) on the same weights."""
    ja = JA.TaskAnalyzer(CFG_J, seed=4)
    ta = TA.TaskAnalyzer(CFG_T, device="cpu",
                         state=TA.params_from_jax(_np_tree(ja.params)))
    return ja, ta


# ----------------------------------------------------------------------
# RoutingBatch.models() / .signatures(), route_tokens_batch's cfg
# ----------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 9])
def test_route_tokens_batch_models_and_signatures_match_reference(
        analyzers, b):
    ja, ta = analyzers
    je, te = engines(40, seed=b, fb=False, ad=False, load=False)
    texts = _texts(b, seed=b + 2)
    toks = ja.encode_batch(texts)
    np.testing.assert_array_equal(ta.encode_batch(texts), toks)
    want = je.route_tokens_batch(ja.params, ja.cfg, toks, "balanced")
    got = te.route_tokens_batch(ta.params, ta.cfg, toks, "balanced")
    ok = _decided(ja.params, toks)
    assert ok.sum() >= (b + 1) // 2
    gm, wm = got.models(), want.models()
    assert len(gm) == len(wm) == b
    assert gm == [got.model(i) for i in range(b)]
    for i in np.flatnonzero(ok):
        if not tied(want.decision(i)):
            assert gm[i] == wm[i], i
    gs, ws = got.signatures(), want.signatures()
    assert len(gs) == len(ws) == b
    for i, (g, w) in enumerate(zip(gs, ws)):
        assert g is got.signature(i)                  # memoized
        if ok[i]:
            assert (g.task_type, g.domain) == (w.task_type, w.domain)
        assert g.complexity == pytest.approx(w.complexity, abs=1e-5)
        assert g.confidence == pytest.approx(w.confidence, abs=1e-5)


def test_route_tokens_batch_empty_and_cfg(analyzers):
    """B=0 gives an empty batch with analyzer arrays (as the reference's
    test_route_tokens_batch_empty_and_guards); a config that is not the
    encoder's raises."""
    _, ta = analyzers
    _, te = engines(8, seed=15, fb=False, ad=False, load=False)
    empty = np.zeros((0, CFG_T.max_len), np.int32)
    batch = te.route_tokens_batch(ta.params, ta.cfg, empty, "balanced")
    assert len(batch) == 0 and batch.signatures() == [] and \
        batch.models() == []
    other = TA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=1,
                              n_heads=2, d_ff=64, max_len=24)
    with pytest.raises(ValueError, match="does not match"):
        te.route_tokens_batch(ta.params, other, empty, "balanced")
    jparams = list(inspect.signature(JEngine.route_tokens_batch).parameters)
    assert list(inspect.signature(
        TEngine.route_tokens_batch).parameters) == jparams


def test_route_many_batch_models_match_reference():
    """The signature path's ``models()`` (the reference's
    test_engine_ivf_gating_and_parity reads it this way)."""
    je, te = engines(64, seed=19, fb=True, ad=True, load=True, knn_k=4)
    (jp, js), (tp, ts) = queries(12, seed=19)
    want, got = je.route_many_batch(jp, js), te.route_many_batch(tp, ts)
    for i, (g, w) in enumerate(zip(got.models(), want.models())):
        assert g == w or tied(want.decision(i)), i
    with pytest.raises(ValueError, match="no analyzer outputs"):
        got.signatures()


# ----------------------------------------------------------------------
# RoutingEngine.task_vector
# ----------------------------------------------------------------------

@pytest.mark.parametrize("use_complexity", [True, False])
def test_task_vector_matches_reference(use_complexity):
    je, te = engines(16, seed=3, fb=False, ad=False, load=False)
    je.use_complexity = te.use_complexity = use_complexity
    rng = np.random.default_rng(7)
    iacc = METRICS.index("accuracy")
    for _ in range(20):
        w = {m: float(rng.random()) for m in METRICS}
        t, d = str(rng.choice(TASK_TYPES)), str(rng.choice(DOMAINS))
        c = float(rng.random())
        want = je.task_vector(JPrefs(weights=w), JSig(task_type=t, domain=d,
                                                      complexity=c))
        got = te.task_vector(TPrefs(weights=w), TSig(task_type=t, domain=d,
                                                     complexity=c))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert got[iacc] >= TPrefs(weights=w).vector()[iacc]


def test_task_vector_without_init_and_in_the_unit_box():
    """As the reference's property test calls it: an engine made with
    ``__new__`` (no ``use_complexity`` attribute) raises accuracy."""
    eng = TEngine.__new__(TEngine)
    prefs = TPrefs(weights={m: 0.3 for m in METRICS})
    easy = eng.task_vector(prefs, TSig(complexity=0.1))
    hard = eng.task_vector(prefs, TSig(complexity=0.9))
    iacc = METRICS.index("accuracy")
    assert hard[iacc] == pytest.approx(0.9) and hard[iacc] > easy[iacc]
    v = eng.task_vector(TPrefs(weights={m: 1.0 for m in METRICS}),
                        TSig(complexity=0.7))
    assert (v >= 0).all() and (v <= 1).all()


# ----------------------------------------------------------------------
# TaskAnalyzer.analyze / to_json, OracleAnalyzer
# ----------------------------------------------------------------------

def test_analyze_and_to_json_match_reference(analyzers):
    ja, ta = analyzers
    texts = _texts(12, seed=31)
    ok = _decided(ja.params, ja.encode_batch(texts))
    assert ok.sum() >= 8
    for text, keep in zip(texts, ok):
        js, ts = ja.analyze(text), ta.analyze(text)
        assert ts.complexity == pytest.approx(js.complexity, abs=1e-5)
        assert ts.confidence == pytest.approx(js.confidence, abs=1e-5)
        if keep:
            assert ta.to_json(ts) == ja.to_json(js)
        # the same signature through either package's to_json
        assert ta.to_json(js) == ja.to_json(js)
    assert set(ta.to_json(ts)) == {"task_type", "domain", "complexity",
                                   "confidence"}


def test_oracle_analyzer_reads_the_true_signature():
    jrecs, trecs = jmake_workload(20, seed=6), tmake_workload(20, seed=6)
    jo, to = JA.OracleAnalyzer(), TA.OracleAnalyzer()
    for jr, tr in zip(jrecs, trecs):
        js, ts = jo.analyze_record(jr), to.analyze_record(tr)
        assert ts is tr.sig
        assert (ts.task_type, ts.domain, ts.complexity, ts.confidence) == \
            (js.task_type, js.domain, js.complexity, js.confidence)


# ----------------------------------------------------------------------
# ops.router_topk(..., weights=)
# ----------------------------------------------------------------------

def test_router_topk_positional_order_is_the_reference():
    want = [p for p, v in inspect.signature(K.router_topk).parameters.items()
            if v.kind is v.POSITIONAL_OR_KEYWORD]
    got = [p for p, v in inspect.signature(P.router_topk).parameters.items()
           if v.kind is v.POSITIONAL_OR_KEYWORD]
    assert got == want == ["emb", "queries", "k", "mask", "weights",
                           "row_bias", "min_score"]


def _weighted_cos(emb, q, w):
    e = emb * w / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    x = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-9)
    return x.astype(np.float64) @ e.T.astype(np.float64)


@pytest.mark.parametrize("frac_masked", [0.0, 0.5, 0.95])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_router_topk_weights_match_reference(frac_masked, quant):
    """As the reference's test_router_topk_mask_and_weights: a 1-D mask
    and per-axis weights, against ``ref.router_topk`` and the Pallas
    kernel; fp32 and int8 (whose float rows may differ in the last bit
    before quantization: values within 1e-6)."""
    rng = np.random.default_rng(int(frac_masked * 100) + quant)
    N, D, Q, k = 640, 8, 4, 8
    emb = rng.random((N, D)).astype(np.float32)
    q = rng.random((Q, D)).astype(np.float32)
    mask = rng.random(N) >= frac_masked
    w = (rng.random(D) + 0.05).astype(np.float32)
    bias = (rng.random(N) * 0.1).astype(np.float32)
    got = P.router_topk(emb, q, k, mask, w, bias, None, quant=quant,
                        device="cpu")
    ref = _ref_topk(jnp.asarray(emb), jnp.asarray(q), k,
                    mask=jnp.asarray(mask), weights=jnp.asarray(w),
                    row_bias=jnp.asarray(bias), quant=quant)
    pallas = K.router_topk(emb, q, k, mask=mask, weights=w, row_bias=bias,
                           quant=quant)
    s = _weighted_cos(emb, q, w) + bias[None, :]
    for want, nm in ((ref, "ref"), (pallas, "pallas")):
        assert_topk_match(got, want, s, atol=1e-6, what=nm)
    gi, gv = np.asarray(got[1]), np.asarray(got[0])
    assert mask[gi[np.isfinite(gv)]].all()


def test_router_topk_weighted_rows_fold_as_the_reference():
    """The weights fold into the catalog rows before the norm, as
    ``emb * w / (|emb| + 1e-9)``: the port's rows within one f32 ulp of
    the reference's (its root is taken in f64)."""
    emb, _, _ = _problem(1, 300, 8, seed=40)
    w = (np.random.default_rng(41).random(8) + 0.05).astype(np.float32)
    got = unit_rows(torch.from_numpy(emb), torch.from_numpy(w)).numpy()
    ej = jnp.asarray(emb)
    want = np.asarray(ej * jnp.asarray(w)[None, :] / (
        jnp.linalg.norm(ej, axis=1, keepdims=True) + 1e-9))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
    np.testing.assert_array_equal(
        unit_rows(torch.from_numpy(emb)).numpy(),
        unit_rows(torch.from_numpy(emb),
                  torch.ones(8, dtype=torch.float32)).numpy())


@pytest.mark.parametrize("Q,N,D,k", [(6, 90, 8, 8), (11, 257, 40, 1)])
def test_router_topk_q8_weighted_bit_equal_on_int8_operands(Q, N, D, k):
    """Weighted rows quantized once (the reference's ``quantize_rows`` of
    ``emb * w / |emb|``) through the port's int8 top-k and the
    reference's ``_q8_matmul`` + mask + ``lax.top_k``: bit for bit."""
    emb, q, mask = _problem(Q, N, D, seed=N + k, empty_rows=1)
    w = (np.random.default_rng(N).random(D) + 0.05).astype(np.float32)
    ej, qj = jnp.asarray(emb), jnp.asarray(q)
    e8, es = R.quantize_rows(ej * jnp.asarray(w)[None, :] / (
        jnp.linalg.norm(ej, axis=1, keepdims=True) + 1e-9))
    q8, qs = R.quantize_rows(qj / (jnp.linalg.norm(qj, axis=1,
                                                   keepdims=True) + 1e-9))
    s = jnp.where(jnp.asarray(mask), R._q8_matmul(q8, e8, qs, es), -jnp.inf)
    wv, wi = jax.lax.top_k(s, k)
    t = lambda a: torch.from_numpy(np.array(a))
    gv, gi = RT.router_topk_q8(t(q8), t(e8), t(qs)[:, 0], t(es)[:, 0],
                               t(mask.astype(np.uint8)),
                               torch.arange(Q, dtype=torch.int32), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    fin = np.isfinite(np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy()[fin], np.asarray(wi)[fin])


def test_router_topk_weighted_call_does_not_reuse_the_unweighted():
    """An unweighted call, then a weighted one on the same catalog
    array: the second scores the weighted rows (no cached pack)."""
    emb, q, mask = _problem(5, 200, 8, seed=44)
    w = np.array([4.0, 0.1, 0.1, 0.1, 3.0, 0.1, 0.1, 0.1], np.float32)
    P.reset_catalog_cache()
    plain = P.router_topk(emb, q, 8, mask, device="cpu")
    got = P.router_topk(emb, q, 8, mask, w, device="cpu")
    assert P.catalog_cache_info()["entries"] == 0
    want = _ref_topk(jnp.asarray(emb), jnp.asarray(q), 8,
                     mask=jnp.asarray(mask), weights=jnp.asarray(w))
    assert_topk_match(got, want, _weighted_cos(emb, q, w), what="weighted")
    assert_topk_match(plain, _ref_topk(jnp.asarray(emb), jnp.asarray(q), 8,
                                       mask=jnp.asarray(mask)),
                      _cos(emb, q), what="plain")
    assert not np.array_equal(np.asarray(plain[1]), np.asarray(got[1]))


# ----------------------------------------------------------------------
# the reference's long_mode keyword on the cache and step factories
# ----------------------------------------------------------------------

def _long_mode_pairs():
    from repro.models import model as JM
    from repro.training import steps as JS
    from repro_torch.models import model as TM
    from repro_torch.training import steps as TS
    return {"cache_len": (JM.cache_len, TM.cache_len),
            "init_cache": (JM.init_cache, TM.init_cache),
            "make_prefill_step": (JS.make_prefill_step, TS.make_prefill_step),
            "make_decode_step": (JS.make_decode_step, TS.make_decode_step)}


@pytest.mark.parametrize("name", ["cache_len", "init_cache",
                                  "make_prefill_step", "make_decode_step"])
def test_long_mode_signature_matches_reference(name):
    """Each reference parameter is in the port's list, in the same order,
    kind and default (the port may add its own, ``init_cache``'s
    ``device``)."""
    ref, port = _long_mode_pairs()[name]
    want = list(inspect.signature(ref).parameters.values())
    got = inspect.signature(port).parameters
    assert "long_mode" in got
    names = [p.name for p in want]
    assert [n for n in got if n in names] == names
    for p in want:
        q = got[p.name]
        assert (q.kind, q.default) == (p.kind, p.default), p.name


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama3.2-1b"])
def test_long_mode_false_is_the_default_and_true_is_not_ported(arch):
    """``long_mode=False`` is the default of the four functions; ``True``,
    which raised before, computes the reference's result: ``cache_len``,
    the cache's shapes and dtypes, and the prefill and one decode step
    of the two step factories (logits within 1e-4) at a prompt of 72
    past gemma2's window of 64."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke as jget_smoke
    from repro.models import model as JM
    from repro.training import steps as JS
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as TM
    from repro_torch.training import steps as TS
    cfg = get_smoke(arch)
    for ctx in (8, 100):
        assert TM.cache_len(cfg, ctx, long_mode=False) == \
            TM.cache_len(cfg, ctx) == JM.cache_len(jget_smoke(arch), ctx)
    a = TM.init_cache(cfg, 2, 100, long_mode=False, device="cpu")
    b = TM.init_cache(cfg, 2, 100, device="cpu")
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key])
    assert callable(TS.make_prefill_step(cfg, long_mode=False, max_len=8))
    assert callable(TS.make_decode_step(cfg, long_mode=False))
    jcfg = jget_smoke(arch)
    for ctx in (8, 100):
        assert TM.cache_len(cfg, ctx, long_mode=True) == \
            JM.cache_len(jcfg, ctx, long_mode=True)
    want = JM.init_cache(jcfg, 2, 100, long_mode=True)
    got = TM.init_cache(cfg, 2, 100, long_mode=True, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    jp = JM.init_params(jax.random.PRNGKey(6), jcfg)
    tp = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 72)).astype(np.int32)
    jl, jc, jpos = JS.make_prefill_step(jcfg, long_mode=True, max_len=80)(
        jp, {"tokens": jnp.asarray(toks)})
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl2 = JS.make_decode_step(jcfg, long_mode=True)(
        jp, jc, {"token": jnp.asarray(tok), "pos": jpos})[0]
    with torch.no_grad():
        tl, tc, tpos = TS.make_prefill_step(cfg, long_mode=True, max_len=80)(
            tp, {"tokens": torch.from_numpy(toks)})
        tl2 = TS.make_decode_step(cfg, long_mode=True)(
            tp, tc, {"token": torch.from_numpy(tok), "pos": tpos})[0]
    for a, b in ((tl, jl), (tl2, jl2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
