"""The port's analyzer and fused analyze->route program against the JAX
package's, on weights carried across with ``params_from_jax`` (fp32
and int8).  Logits within 1e-4; heads compared where the reference's
top-2 probability gap exceeds 1e-4; the routing outputs of rows whose
heads agree compared as in ``test_torch_route_step``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyzer as JA
from repro.kernels import analyze_step as JS
from repro.kernels import ops as K
from repro_torch.core import analyzer as TA
from repro_torch.kernels import ops as P
from repro_torch.kernels.analyze_step import AnalyzerEncoder
from tests.test_torch_route_step import assert_ranked_match

CFG_J = JA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)
CFG_T = TA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)
GAP = 1e-4
_fwd = jax.jit(JS.analyzer_forward, static_argnums=1)


@pytest.fixture(scope="module")
def jax_analyzer():
    """The reference analyzer; its weights come from ``init_analyzer``."""
    return JA.TaskAnalyzer(CFG_J, seed=3)


@pytest.fixture
def jax_params(jax_analyzer):
    return jax_analyzer.params


def _texts(b, seed=0):
    rng = np.random.default_rng(seed)
    vocab = ["summarize", "translate", "code", "legal", "brief", "the",
             "question", "urgent", "report", "python", "medical", "poem"]
    return [" ".join(rng.choice(vocab, size=int(rng.integers(1, 40))))
            for _ in range(b)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _encoder(params):
    return AnalyzerEncoder(CFG_T, TA.params_from_jax(_np_tree(params)))


def _tokens(b, seed=0):
    return JA.TaskAnalyzer.encode_batch(
        type("A", (), {"cfg": CFG_J, "tok": JA.HashTokenizer(512)})(),
        _texts(b, seed))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_analyzer_forward_matches_jax(jax_params, quant):
    params = JA.quantize_int8(jax_params) if quant else jax_params
    toks = _tokens(7, seed=1)
    toks[6] = 0                                        # an all-PAD row
    want = _fwd(params, CFG_J, jnp.asarray(toks))
    with torch.no_grad():
        got = _encoder(params)(torch.from_numpy(toks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


def test_quantize_int8_matches_jax(jax_params):
    want = JA.quantize_int8(jax_params)
    got = TA.quantize_int8(TA.params_from_jax(_np_tree(jax_params)))
    flat = TA.params_from_jax(_np_tree(want))
    assert set(got) == set(flat)
    for name, w in flat.items():
        if isinstance(w, tuple):
            np.testing.assert_array_equal(got[name][0], w[0], err_msg=name)
            np.testing.assert_array_equal(got[name][1], w[1], err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_seeded_init_has_the_reference_shapes(jax_params):
    ref = TA.params_from_jax(_np_tree(jax_params))
    got = TA.init_analyzer_np(CFG_T, seed=0)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == np.float32 for v in got.values())


@pytest.mark.parametrize("b", [1, 9])
def test_prune_and_encode_match_jax(b):
    texts = _texts(b, seed=b) + [" ".join(["word"] * 150 + ["tail"] * 10)]
    assert TA.prune_texts(CFG_T, texts) == JA.prune_texts(CFG_J, texts)
    assert TA.prune_text(CFG_T, texts[-1]) == JA.prune_text(CFG_J, texts[-1])
    an = TA.TaskAnalyzer(CFG_T, device="cpu")
    np.testing.assert_array_equal(an.encode_batch(texts),
                                  _tokens_of(texts))


def _tokens_of(texts):
    from repro.data.tokenizer import HashTokenizer
    return HashTokenizer(512).encode_batch(JA.prune_texts(CFG_J, texts), 24)


def _decided(params, toks):
    """Rows whose two heads have a top-2 probability gap above GAP in the
    reference (their argmax cannot flip on float noise)."""
    tt, dm, _ = _fwd(params, CFG_J, jnp.asarray(toks))
    ok = np.ones(len(toks), bool)
    for lg in (tt, dm):
        p = np.sort(np.asarray(jax.nn.softmax(lg, axis=-1)), axis=1)
        ok &= (p[:, -1] - p[:, -2]) > GAP
    return ok


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_analyze_step_heads_match_jax(jax_params, quant):
    params = JA.quantize_int8(jax_params) if quant else jax_params
    toks = _tokens(13, seed=4)
    want = K.analyze_step(params, CFG_J, toks)
    got = P.analyze_step(_encoder(params), toks, device="cpu")
    ok = _decided(params, toks)
    assert ok.sum() >= 10
    for key in ("tt_idx", "dm_idx"):
        np.testing.assert_array_equal(got[key][ok], want[key][ok])
    np.testing.assert_allclose(got["cx"], want["cx"], atol=1e-5)
    np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-5)


def _catalog(n, seed):
    rng = np.random.default_rng(seed)
    emb = rng.random((n, 8)).astype(np.float32)
    tt = np.vstack([rng.random((11, n)) < 0.2, np.ones((1, n), bool)])
    dm = np.vstack([rng.random((6, n)) < 0.3, np.ones((1, n), bool)])
    return emb, tt, dm, rng.random(n) < 0.1


@pytest.mark.parametrize("quant,blend", [
    (False, False), (False, True), (True, True)],
    ids=["fp32", "fp32-blend", "int8-blend"])
def test_analyze_route_step_matches_jax(jax_params, quant, blend):
    n, B = 150, 11
    emb, tt, dm, gmask = _catalog(n, seed=2)
    rng = np.random.default_rng(5)
    toks = _tokens(B, seed=6)
    W = rng.random((B, 8)).astype(np.float32)
    kw = dict(k=8, r=8, threshold=0.09, acc_col=0)
    if blend:
        L = rng.standard_normal((n, 9, 9)).astype(np.float32) * 0.05
        kw.update(fb_table=(rng.random((11 * 6 * 4, n)) - 0.5
                            ).astype(np.float32), fb_weight=0.5,
                  theta=rng.standard_normal((n, 9)).astype(np.float32) * 0.1,
                  ainv=np.einsum("nde,nfe->ndf", L, L)
                  + 0.5 * np.eye(9, dtype=np.float32), alpha=0.8,
                  ad_weight=0.7, lpen=(rng.random(n) * 0.3).astype(np.float32))
    want = K.analyze_route_step(jax_params, CFG_J, toks, emb, tt, dm, gmask,
                                W, use_pallas=True, quant=quant, **kw)
    got = P.analyze_route_step(_encoder(jax_params), toks, emb, tt, dm,
                               gmask, W, quant=quant, device="cpu", **kw)
    assert set(got) == set(want)
    ok = _decided(jax_params, toks)
    for key in ("tt_idx", "dm_idx"):
        np.testing.assert_array_equal(got[key][ok], want[key][ok])
    np.testing.assert_allclose(got["task_vectors"], want["task_vectors"],
                               atol=1e-5)
    ok &= np.abs(got["conf"] - 0.09) > 1e-4           # same filter rows
    for key in ("stage", "n_filtered", "n_candidates"):
        np.testing.assert_array_equal(got[key][ok], want[key][ok])
    assert_ranked_match(got["cand_idx"][ok], got["cand_score"][ok],
                        want["cand_idx"][ok], want["cand_score"][ok])
    np.testing.assert_allclose(got["score"][ok], want["score"][ok],
                               atol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_task_analyzer_signatures_match_jax(jax_analyzer, quant):
    ja = jax_analyzer
    ta = TA.TaskAnalyzer(CFG_T, device="cpu", state=TA.params_from_jax(
        _np_tree(ja.params)))
    fp32 = ja.params
    if quant:
        ja.quantize()
        ta.quantize()
    texts = _texts(10, seed=8)
    try:
        js, ts = ja.analyze_batch(texts), ta.analyze_batch(texts)
        ok = _decided(ja.params, ja.encode_batch(texts))
    finally:
        ja.params = fp32
    for a, b, keep in zip(js, ts, ok):
        if keep:
            assert (a.task_type, a.domain) == (b.task_type, b.domain)
        assert a.complexity == pytest.approx(b.complexity, abs=1e-5)
        assert a.confidence == pytest.approx(b.confidence, abs=1e-5)
    assert ta.analyze_batch([]) == []
