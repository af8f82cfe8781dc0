"""The int8 KV cache (``kv_cache_dtype="int8"``) of the port against the
JAX package's, on the CPU at the ``SMOKE`` configs (weights from the
reference's ``init_params`` through ``params_from_jax``).

The reference's decode asks for the dequantized cache ``bf16(k8) *
bf16(scale)`` in bf16 (``models/layers.py``).  Compiled by XLA on the
CPU (``decode_step`` scans its layers, so it is always compiled) that
product feeds the score einsum without its bf16 rounding: XLA's
default excess precision drops the convert pair.  Run op by op
(``jax.disable_jit()``) it is rounded as written, which is what the
port computes on both devices; so the model-level comparisons run the
reference's decode under ``jax.disable_jit()``.

Tolerances: ``quantize_kv`` on the same f32 input is exact (q and
scales equal).  After prefill and decode the cache's int8 values agree
within 1 on at most 0.1% of the elements (a K/V value that differs in
its last f32 bit may round the other way at a .5 boundary), the scales
within rtol 1e-5; the logits within 2e-4 (values of order 1: f32
arithmetic, plus at most a few int8 steps of one scale); over a
generate's five steps, where such flips accumulate in the cache (0.6%
of the step logits moved by up to 4.7e-4 at ``SMOKE``), within 1e-3.
Greedy tokens are compared tie-aware, as in
``tests/test_torch_generate.py``.
``decode_q8_plain`` against an f32 dequantize followed by
``decode_split_plain`` (the kernel's split arithmetic): within 1e-5 of
max |out| on the same bf16-rounded K/V, and within 2^-7 of max |out|
against the unrounded f32 K/V (one bf16 rounding, 2^-9 relative, of
every element).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels import ref as R
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import runner as JRUN
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import runner as TRUN
from repro_torch.serving.scheduler import ContinuousBatcher, SlotRequest
from tests.test_torch_generate import assert_greedy_agrees

# prompt lengths: h2o-danube's 100 > its SMOKE window of 64 (the ring)
FAMILIES = {"llama3.2-1b": 21, "gemma2-2b": 21, "h2o-danube-3-4b": 100,
            "qwen3-moe-30b-a3b": 21, "hymba-1.5b": 21}
LOGIT_TOL = 2e-4
GEN_TOL = 1e-3
SCALE_RTOL = 1e-5
INT8_SHARE = 1e-3


def _cfgs(name):
    return (dataclasses.replace(jget_smoke(name), kv_cache_dtype="int8"),
            dataclasses.replace(get_smoke(name), kv_cache_dtype="int8"))


def _params(cfg, seed=1):
    jp = JM.init_params(jax.random.PRNGKey(seed), cfg)
    return jp, TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def assert_caches_close(tc, jc):
    assert set(tc) == set(jc)
    for key, want in jc.items():
        got = tc[key].numpy()
        want = np.asarray(want)
        assert got.shape == want.shape and str(got.dtype) == \
            str(want.dtype), key
        if got.dtype == np.int8:
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1, key
            assert (d > 0).mean() <= INT8_SHARE, (key, (d > 0).mean())
        elif key.endswith("_scale"):
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0,
                                       err_msg=key)
        else:                                # hymba's SSM state, f32
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                       err_msg=key)


# ----------------------------------------------------------------------
# quantize_kv and the cache layout
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((2, 7, 4, 16), -1),
                                        ((3, 5, 2, 120), -1),
                                        ((4, 9, 6), 1)])
def test_quantize_kv_equals_reference(shape, axis):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 5.0)).astype(
        np.float32)
    x.reshape(-1)[:5] = 0.0                       # a zero row's scale: 1e-8
    q, s = TL.quantize_kv(torch.from_numpy(x), axis=axis)
    qj, sj = JL.quantize_kv(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    xb = torch.from_numpy(x).to(torch.bfloat16)      # a bf16 cache row
    qb, sb = TL.quantize_kv(xb, axis=axis)
    qjb, sjb = JL.quantize_kv(jnp.asarray(x, jnp.bfloat16), axis=axis)
    np.testing.assert_array_equal(qb.numpy(), np.asarray(qjb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(sjb))


@pytest.mark.parametrize("name", ["llama3.2-1b", "h2o-danube-3-4b",
                                  "hymba-1.5b", "seamless-m4t-medium"])
def test_init_cache_layout_equals_reference(name):
    jcfg, tcfg = _cfgs(name)
    enc = 16 if tcfg.is_encdec else 0
    want = JM.init_cache(jcfg, 3, 40, enc_len=enc)
    got = TM.init_cache(tcfg, 3, 40, enc_len=enc, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype)[6:] == str(w.dtype), key
        assert not got[key].any()
    assert got["k"].dtype == torch.int8
    assert got["k_scale"].shape[-1] == 1
    if tcfg.is_encdec:                       # the cross cache stays f32
        assert got["cross_k"].dtype == torch.float32


# ----------------------------------------------------------------------
# prefill and decode against the reference's int8 decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_prefill_and_decode_match_reference_int8(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    L = FAMILIES[name]
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, L)).astype(np.int32)
    jl, jc, jpos = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              max_len=L + 8)
    tl, tc, tpos = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              max_len=L + 8)
    assert tc["k"].dtype == torch.int8 and "k_scale" in tc
    if name == "h2o-danube-3-4b":
        assert tc["k"].shape[2] == jcfg.sliding_window < L
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert_caches_close(tc, jc)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(2):
        with jax.disable_jit():
            jl, jc = JM.decode_step(jp, jcfg, jc, {"token": jnp.asarray(tok),
                                                   "pos": jpos})
        tl, tc = TM.decode_step(tp, tcfg, tc, {"token": torch.from_numpy(tok),
                                               "pos": tpos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert_caches_close(tc, jc)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jpos, tpos = jpos + 1, tpos + 1


def test_decode_past_the_cache_keeps_the_int8_slots():
    """A row at pos >= C writes nothing, scales included (the masked
    write-back), and sees all C slots."""
    _, tcfg = _cfgs("llama3.2-1b")
    _, tp = _params(_cfgs("llama3.2-1b")[0])
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int64))
    _, cache, pos = TM.prefill(tp, tcfg, {"tokens": toks}, max_len=10)
    C = cache["k"].shape[2]
    pos = torch.tensor([C - 1, C + 3])
    before = {k: v.clone() for k, v in cache.items()}
    TM.decode_step(tp, tcfg, cache, {"token": toks[:, :1], "pos": pos})
    for key in cache:
        assert torch.equal(cache[key][:, 1], before[key][:, 1]), key
        assert not torch.equal(cache[key][:, 0], before[key][:, 0]), key


# ----------------------------------------------------------------------
# the runner and the batcher
# ----------------------------------------------------------------------

def _eager_greedy(jp, cfg, toks, max_new):
    """The reference's greedy loop, op by op, with its logits."""
    with jax.disable_jit():
        last, cache, pos = JM.prefill(jp, cfg, {"tokens": jnp.asarray(toks)},
                                      max_len=toks.shape[1] + max_new + 8)
        logits, out = [np.asarray(last)], [np.argmax(np.asarray(last), -1)]
        for _ in range(max_new - 1):
            tok = jnp.asarray(out[-1][:, None].astype(np.int32))
            lg, cache = JM.decode_step(jp, cfg, cache,
                                       {"token": tok, "pos": pos})
            pos = pos + 1
            logits.append(np.asarray(lg))
            out.append(np.argmax(logits[-1], -1))
    return np.stack(out, 1), np.stack(logits, 1)


@pytest.mark.parametrize("name", ["llama3.2-1b", "gemma2-2b"])
def test_runner_generate_matches_reference_int8(name):
    jcfg, tcfg = _cfgs(name)
    jr = JRUN.ModelRunner(jcfg, seed=4)
    tr = TRUN.ModelRunner(tcfg, device="cpu", params=TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (3, 19)).astype(np.int32)
    got = tr.generate(toks, max_new=5, keep_logits=True)
    ref_toks, ref_logits = _eager_greedy(jr.params, jcfg, toks, 5)
    assert got.tokens.shape == (3, 5)
    assert_greedy_agrees(got.tokens, ref_toks, ref_logits)
    np.testing.assert_allclose(got.step_logits, ref_logits, rtol=GEN_TOL,
                               atol=GEN_TOL)


@pytest.mark.parametrize("name", ["llama3.2-1b", "hymba-1.5b"])
def test_batcher_int8_tick_matches_single_generate(name):
    """Every cache key, the scales too, is copied into a slot: the
    joint decode gives each request the tokens of its B=1 generate."""
    _, tcfg = _cfgs(name)
    _, tp = _params(_cfgs(name)[0], seed=3)
    runner = TRUN.ModelRunner(tcfg, device="cpu", params=tp)
    cb = ContinuousBatcher(tcfg, tp, slots=3, ctx_len=40, device="cpu")
    assert cb.cache["k"].dtype == torch.int8
    assert set(cb.cache) >= {"k", "v", "k_scale", "v_scale"}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, tcfg.vocab_size, L).astype(np.int32)
               for L in (7, 12, 9, 4)]
    for i, p in enumerate(prompts):
        cb.submit(SlotRequest(id=i, tokens=p, max_new=4))
    done = {r.id: r for r in cb.run_until_drained()}
    assert len(done) == 4
    for i, p in enumerate(prompts):
        want = runner.generate(p[None], max_new=4).tokens[0].tolist()
        assert done[i].out == want, i


# ----------------------------------------------------------------------
# the plain version of the int8 decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("hd,G,softcap", [(64, 4, 0.0), (288, 2, 50.0)])
def test_decode_q8_plain_against_reference_oracle(hd, G, softcap):
    """``decode_q8_plain`` (and the wrapper on CPU tensors) against the
    JAX package's oracle ``ref.mha_attention`` over the same dequantized
    (bf16-rounded) K/V, each sequence's live prefix of ``kv_valid``
    keys: one query row at the end sees them all.  Within 1e-5 of max
    |out| (f32 both, another summation order)."""
    rng = np.random.default_rng(hd * 7 + G)
    B, Hkv, C = 3, 2, 130
    k8, ks = TL.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, Hkv, C, hd)).astype(np.float32)))
    v8, vs = TL.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, Hkv, C, hd)).astype(np.float32)))
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, 1, hd)).astype(
        np.float32))
    lens = [C, 77, 1]
    kv_valid = torch.tensor(lens, dtype=torch.int32)
    got = FA.decode_q8_plain(q, k8, v8, ks, vs, kv_valid, softcap=softcap)
    wrapped = FA.flash_decode_q8(q, k8, v8, ks, vs, kv_valid,
                                 softcap=softcap)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    kb = FA.dequantize_kv(k8, ks).float().transpose(1, 2).numpy()
    vb = FA.dequantize_kv(v8, vs).float().transpose(1, 2).numpy()
    qn = q.transpose(1, 2).numpy()
    for b, n in enumerate(lens):
        want = np.asarray(R.mha_attention(
            jnp.asarray(qn[b:b + 1]), jnp.asarray(kb[b:b + 1, :n]),
            jnp.asarray(vb[b:b + 1, :n]), softcap=softcap))
        out = got[b:b + 1].transpose(1, 2).numpy()
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("hd,G,softcap,local", [(64, 4, 0.0, 0),
                                                (120, 4, 0.0, 0),
                                                (288, 2, 50.0, 0),
                                                (288, 2, 50.0, 40)])
def test_decode_q8_plain_against_f32_dequantize_and_split_plain(
        hd, G, softcap, local):
    rng = np.random.default_rng(hd + G)
    B, Hkv, C = 3, 2, 150
    k = rng.standard_normal((B, Hkv, C, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, C, hd)).astype(np.float32)
    k8, ks = TL.quantize_kv(torch.from_numpy(k))
    v8, vs = TL.quantize_kv(torch.from_numpy(v))
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, 1, hd)).astype(
        np.float32))
    kv_valid = torch.tensor([C, 97, 1], dtype=torch.int32)
    kw = dict(softcap=softcap, local_window=local)
    got = FA.decode_q8_plain(q, k8, v8, ks, vs, kv_valid, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    # the same bf16-rounded values, in f32, through the split arithmetic
    kb = FA.dequantize_kv(k8, ks).float()
    vb = FA.dequantize_kv(v8, vs).float()
    same = FA.decode_split_plain(q, kb, vb, kv_valid, **kw)
    scale = float(same.abs().max())
    np.testing.assert_allclose(got.numpy(), same.numpy(), rtol=0,
                               atol=1e-5 * scale)
    # against an f32 dequantize: one bf16 rounding of each element
    f32 = FA.decode_split_plain(q, k8.float() * ks, v8.float() * vs,
                                kv_valid, **kw)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=0,
                               atol=2.0 ** -7 * scale)
    assert float((got - f32).abs().max()) > 0      # the rounding is there
    # the wrapper takes the plain version for CPU tensors
    wrapped = FA.flash_decode_q8(q, k8, v8, ks, vs, kv_valid, **kw)
    assert torch.equal(wrapped, got)


def test_dequantize_kv_is_the_correctly_rounded_product():
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.integers(-127, 128, (64, 32)).astype(np.int8))
    s = torch.from_numpy((rng.random((64, 1)) * 0.05 + 1e-4).astype(
        np.float32))
    got = FA.dequantize_kv(x8, s)
    assert got.dtype == torch.bfloat16
    exact = x8.double() * s.to(torch.bfloat16).double()
    assert torch.equal(got, exact.float().to(torch.bfloat16))
    want = (jnp.asarray(x8.numpy()).astype(jnp.bfloat16)
            * jnp.asarray(s.numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("B,Hkv,C", [(16, 8, 536), (16, 4, 536),
                                     (4, 8, 4096), (16, 8, 3392),
                                     (1, 1, 1), (3, 2, 77)])
def test_decode_splits_q8_cover_the_cache(B, Hkv, C):
    """The int8 decode's split plan: chunks of whole ``Q8_CHUNK`` units
    covering the C slots, no empty trailing chunk, and at least as many
    splits as the bf16 decode's plan."""
    n, chunk = FA.decode_splits_q8(B, Hkv, C)
    assert chunk % FA.Q8_CHUNK == 0 and n * chunk >= C > (n - 1) * chunk
    assert n >= FA.decode_splits(B, Hkv, C)[0] or C <= FA.Q8_CHUNK
