"""The frontend families in the port against the JAX package, on the CPU
at the ``SMOKE`` configs: seamless-m4t-medium (an encoder over projected
frontend embeddings, a cross-attention in every decoder layer) and
llava-next-mistral-7b (projected frontend tokens before the text).
Weights come from the reference's ``init_params`` through
``params_from_jax``; the frontend embeddings are seeded standard
normal wherever a model function is compared (the runners' zero
embeddings make seamless's encoder input, hence its cross term,
exactly 0, so a wrong cross-attention would pass there).

  * each piece alone: ``encode``, the encoder's non-causal attention,
    the cross-attention (prefill and decode), the vision prefix;
  * ``ModelRunner.generate`` against the reference runner (greedy,
    tie-aware), llava's decode past its cache included, and a decode
    that writes its cache slots;
  * a seamless checkpoint across packages, and the soup of two
    seamless parameter trees.

Tolerances: 2e-4 for attention layers (the kernel's online softmax
against a materialised one), 1e-5 for projections, 1e-4 for logits, as
``tests/test_torch_models.py`` states them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import merging as JMG
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.runner import ModelRunner as JRunner
from repro_torch.configs import get_smoke
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.runner import ModelRunner as TRunner
from tests.test_torch_generate import assert_greedy_agrees
from tests.test_torch_models import inputs

SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-mistral-7b"
RNG = np.random.default_rng(21)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(name, seed=0):
    cfg = jget_smoke(name)
    jp = JM.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, get_smoke(name), jp, TM.params_from_jax(_np(jp))


def _stacked(jp, key, i):
    return jax.tree_util.tree_map(lambda a: a[i], jp[key])


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ----------------------------------------------------------------------
# the pieces
# ----------------------------------------------------------------------

def test_params_from_jax_unstacks_both_stacks():
    cfg, _, jp, tp = _params(SEAMLESS)
    assert len(tp["layers"]) == cfg.n_layers
    assert len(tp["enc_layers"]) == cfg.n_enc_layers == 2
    for i in range(cfg.n_enc_layers):
        want = _stacked(jp, "enc_layers", i)
        TM.tree_map(lambda g, w: np.testing.assert_array_equal(
            g.numpy(), np.asarray(w)), tp["enc_layers"][i], want)
    assert set(tp["layers"][0]) >= {"cross", "ln_cross"}
    assert "bq" not in tp["layers"][0]["cross"]
    assert tuple(tp["front_proj"]["w"].shape) == (cfg.frontend_dim,
                                                  cfg.d_model)


def test_cross_attention_takes_no_bias_where_self_attention_does():
    cfg = dataclasses.replace(get_smoke(SEAMLESS), qkv_bias=True)
    gen = torch.Generator().manual_seed(0)
    assert {"bq", "bk", "bv"} <= set(TL.init_attention(gen, cfg))
    assert not {"bq", "bk", "bv"} & set(TL.init_attention(gen, cfg,
                                                          cross=True))
    want = JL.init_attention(jax.random.PRNGKey(0), cfg, cross=True)
    assert set(TL.init_attention(gen, cfg, cross=True)) == set(want)


@pytest.mark.parametrize("L", [16, 37])
def test_encoder_attention_matches_blocked_and_full(L):
    cfg, tcfg, jp, tp = _params(SEAMLESS, seed=1)
    pj, pt = _stacked(jp, "enc_layers", 1)["attn"], tp["enc_layers"][1]["attn"]
    x = RNG.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(L, dtype=np.int32)[None], (2, 1))
    out, (k, v) = TL.attention_prefill(pt, tcfg, t(x), torch.from_numpy(pos),
                                       causal=False)
    small = dataclasses.replace(cfg, attn_block_q=8)    # several q blocks
    want, (kj, vj) = JL.attention_blocked(pj, small, x, pos, causal=False)
    _close(out, want, 2e-4, "blocked")
    _close(k, kj, 1e-5, "k")
    full, _ = JL.attention_full(pj, cfg, x, pos, causal=False)
    _close(out, full, 2e-4, "full")


@pytest.mark.parametrize("S", [16, 12, 17])
def test_cross_attention_matches_reference(S):
    cfg, tcfg, jp, tp = _params(SEAMLESS, seed=2)
    pj, pt = _stacked(jp, "layers", 0)["cross"], tp["layers"][0]["cross"]
    x = RNG.standard_normal((3, 21, cfg.d_model)).astype(np.float32)
    enc = RNG.standard_normal((3, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(21, dtype=np.int32)[None], (3, 1))
    out, (k, v) = TL.attention_prefill(pt, tcfg, t(x), torch.from_numpy(pos),
                                       causal=False, kv_x=t(enc))
    want, (kj, vj) = JL.attention_full(pj, cfg, x, pos, kv_x=enc,
                                       causal=False, rope=False)
    _close(out, want, 2e-4, "out")
    _close(k, kj, 1e-5, "k (un-roped)")
    _close(v, vj, 1e-5, "v")
    # the decode: one token against the cross cache, every key live
    x1 = x[:, :1]
    got = TL.cross_attention_decode(pt, tcfg, t(x1), t(kj), t(vj))
    wd, _, _ = JL.attention_decode(pj, cfg, x1, kj, vj,
                                   jnp.asarray([5, 30, 99], jnp.int32),
                                   rope=False, update_cache=False,
                                   full_valid=True)
    _close(got, wd, 2e-4, "decode")


def test_encode_matches_reference():
    cfg, tcfg, jp, tp = _params(SEAMLESS, seed=3)
    src = RNG.standard_normal((2, 16, cfg.frontend_dim)).astype(np.float32)
    jc = JM.cast_params(jp, cfg)
    want = JM.encode(jc, cfg, jnp.asarray(src))
    got = TM.encode(TM.cast_params(tp, tcfg), tcfg, t(src))
    assert tuple(got.shape) == (2, 16, cfg.d_model)
    _close(got, want, 1e-4)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


def test_vision_prefix_matches_reference():
    cfg, tcfg, jp, tp = _params(LLAVA, seed=4)
    toks = RNG.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jb, tb = inputs(cfg, toks, seed=4)
    want, wpos = JM._embed_inputs(JM.cast_params(jp, cfg), cfg, jb)
    got, pos = TM._embed_inputs(TM.cast_params(tp, tcfg), tcfg, tb)
    assert tuple(got.shape) == (2, cfg.frontend_tokens + 9, cfg.d_model)
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(got[:, cfg.frontend_tokens:].numpy(),
                                  tp["embed"][toks].numpy())


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_init_cache_matches_reference(name):
    cfg, tcfg = jget_smoke(name), get_smoke(name)
    want = JM.init_cache(cfg, 3, 40, enc_len=16)
    got = TM.init_cache(tcfg, 3, 40, enc_len=16, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype)[6:] == str(want[k].dtype), k


# ----------------------------------------------------------------------
# the runner
# ----------------------------------------------------------------------

def _runners(name, seed):
    jr = JRunner(jget_smoke(name), seed=seed)
    tr = TRunner(get_smoke(name), device="cpu",
                 params=TM.params_from_jax(_np(jr.params)))
    return jr, tr


def _greedy(jp, cfg, batch, max_len, max_new):
    """The reference's greedy loop over ``batch`` (frontends included),
    with its logits at every step and its final cache."""
    last, cache, pos = JM.prefill(jp, cfg, batch, max_len=max_len)
    logits, out = [np.asarray(last)], [np.argmax(np.asarray(last), -1)]
    for _ in range(max_new - 1):
        tok = jnp.asarray(out[-1][:, None].astype(np.int32))
        lg, cache = JM.decode_step(jp, cfg, cache, {"token": tok, "pos": pos})
        pos = pos + 1
        logits.append(np.asarray(lg))
        out.append(np.argmax(logits[-1], -1))
    return np.stack(out, 1), np.stack(logits, 1), cache


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_runner_generation_matches_reference_runner(name):
    """The runners' zero frontend embeddings, as the reference's
    ``_batch`` builds them; llava's cache is the context (prompt + 16
    frontend tokens > max_len), so its decode runs past it."""
    jr, tr = _runners(name, seed=5)
    toks = np.random.default_rng(6).integers(
        0, jr.cfg.vocab_size, (3, 13)).astype(np.int32)
    want = jr.generate(toks, max_new=6)
    got = tr.generate(toks, max_new=6, keep_logits=True)
    ref_toks, ref_logits, _ = _greedy(jr.params, jr.cfg, jr._batch(toks),
                                      13 + 6 + 8, 6)
    np.testing.assert_array_equal(want.tokens, ref_toks)
    assert got.tokens.shape == (3, 6)
    assert_greedy_agrees(got.tokens, ref_toks, ref_logits)
    _close(got.logits_last, want.logits_last, 1e-4, "prefill logits")
    _close(got.step_logits, ref_logits, 1e-4, "step logits")
    b = tr._batch(toks)
    key = "src_embeds" if jr.cfg.is_encdec else "frontend"
    assert tuple(b[key].shape) == jr._batch(toks)[key].shape
    assert not b[key].any()


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_runner_generation_with_seeded_embeds_matches_reference(name):
    jr, tr = _runners(name, seed=7)
    toks = np.random.default_rng(8).integers(
        0, jr.cfg.vocab_size, (2, 11)).astype(np.int32)
    jb, _ = inputs(jr.cfg, toks, seed=8)
    key = "src_embeds" if jr.cfg.is_encdec else "frontend"
    got = tr.generate(toks, max_new=5, keep_logits=True,
                      embeds=np.asarray(jb[key]))
    ref_toks, ref_logits, _ = _greedy(jr.params, jr.cfg, jb, 11 + 5 + 8, 5)
    assert_greedy_agrees(got.tokens, ref_toks, ref_logits)
    _close(got.step_logits, ref_logits, 1e-4)


@pytest.mark.parametrize("max_len", [0, 60], ids=["past-cache", "in-cache"])
def test_llava_decode_past_and_inside_its_cache(max_len):
    """max_len 0 -> the runner's sizing (prompt + max_new + 8 < the
    context): the cache holds the context, every decode position is >=
    C, nothing is written and each step sees the prefilled keys only.
    max_len 60: the decode writes its slots, equal to the reference's
    cache after the run."""
    cfg, tcfg, jp, tp = _params(LLAVA, seed=9)
    Lp, new = 10, 5
    toks = RNG.integers(0, cfg.vocab_size, (2, Lp)).astype(np.int32)
    jb, tb = inputs(cfg, toks, seed=9)
    cap = max_len or Lp + new + 8
    ctx = Lp + cfg.frontend_tokens
    ref_toks, ref_logits, jcache = _greedy(jp, cfg, jb, cap, new)
    last, cache, pos = TM.prefill(tp, tcfg, tb, max_len=cap)
    assert int(pos[0]) == ctx and cache["k"].shape[2] == max(cap, ctx)
    before = cache["k"].clone()
    out = [torch.argmax(last, -1)]
    logits = [last]
    for _ in range(new - 1):
        lg, cache = TM.decode_step(tp, tcfg, cache, {
            "token": out[-1][:, None], "pos": pos})
        pos = pos + 1
        out.append(torch.argmax(lg, -1))
        logits.append(lg)
    got = torch.stack(out, 1).numpy()
    assert_greedy_agrees(got, ref_toks, ref_logits)
    _close(torch.stack(logits, 1), ref_logits, 1e-4)
    if not max_len:
        assert torch.equal(cache["k"], before)        # nothing written
    else:
        assert not torch.equal(cache["k"][:, :, ctx:ctx + new - 1],
                               before[:, :, ctx:ctx + new - 1])
    for k in ("k", "v"):
        _close(cache[k], jcache[k], 1e-4, k)


def test_seamless_checkpoint_round_trips_across_packages(tmp_path):
    jcfg, tcfg = jget_smoke(SEAMLESS), get_smoke(SEAMLESS)
    jr = JRunner(jcfg, seed=3)
    toks = np.arange(3, 15, dtype=np.int32).reshape(2, 6)
    want = jr.generate(toks, max_new=3).tokens
    jr.save_checkpoint(str(tmp_path / "j.npz"))
    tr = TRunner.from_checkpoint(tcfg, str(tmp_path / "j.npz"), device="cpu")
    assert len(tr.params["enc_layers"]) == jcfg.n_enc_layers
    TM.tree_map(lambda g, w: np.testing.assert_array_equal(g.numpy(), w),
                tr.params, TM.params_from_jax(_np(jr.params)))
    np.testing.assert_array_equal(tr.generate(toks, max_new=3).tokens, want)
    tr.save_checkpoint(str(tmp_path / "t.npz"))
    jb = JRunner.from_checkpoint(jcfg, str(tmp_path / "t.npz"))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_equal(np.asarray(g),
                                                   np.asarray(w)),
        jb.params, jr.params)
    np.testing.assert_array_equal(jb.generate(toks, max_new=3).tokens, want)


def test_seamless_soup_matches_reference():
    """``merged_with`` on a tree with ``enc_layers``: the reference's
    soup, bit for bit."""
    cfg = jget_smoke(SEAMLESS)
    a, b = (JM.init_params(jax.random.PRNGKey(s), cfg) for s in (0, 1))
    want = JMG.soup([a, b], [0.3, 0.7])
    ta, tb = (TRunner(get_smoke(SEAMLESS), device="cpu",
                      params=TM.params_from_jax(_np(p))) for p in (a, b))
    got = ta.merged_with(tb, 0.3).params
    TM.tree_map(lambda g, w: np.testing.assert_array_equal(g.numpy(), w),
                got, TM.params_from_jax(_np(want)))
