"""The windowed and hybrid models of the port against the JAX package,
on the CPU: hymba-1.5b (hybrid attention + SSM, a sliding-window ring),
h2o-danube-3-4b (a sliding-window ring) and gemma2-2b (local/global
alternation inside a full cache, attention and final softcaps), at
their ``SMOKE`` configs (window 64) and at head dims 120 and 288 (the
published heads of h2o-danube-3-4b and gemma2-2b, on narrow variants).
Weights come from the reference's ``init_params`` through
``params_from_jax``; inputs are numpy arrays from a seed.

A prompt of 100 tokens is past every window here, so the band, the
local/global switch and the softcap all bite; ``prefill`` with a cap of
114 leaves a ring of 64 slots rolled by 100 % 64 = 36, and the decode
steps write the ring and read the windowed decode.

Tolerances as in ``tests/test_torch_models.py``: 2e-4 for attention
layers and ``forward_full`` (the kernel's online softmax against a
materialised one, through two layers); 1e-4 for the prefill and decode
logits and the caches; greedy tokens tie-aware
(``test_torch_generate.assert_greedy_agrees``); 2e-5 between the two
plain decode versions (f32, another summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import smoke_variant as jsmoke_variant
from repro.kernels import ref as R
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import runner as JRUN
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import smoke_variant
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import runner as TRUN
from test_torch_generate import assert_greedy_agrees, jax_greedy

WINDOWED = ["hymba-1.5b", "h2o-danube-3-4b", "gemma2-2b"]
PROMPT, CAP, STEPS = 100, 114, 6
# narrow variants at the published head dims: 120 (h2o-danube-3-4b,
# 3840 / 32) and 288 (gemma2-2b, 2304 / 8)
HEAD_DIM_VARIANTS = {
    "hd120": ("h2o-danube-3-4b", dict(d_model=240, n_heads=2,
                                      n_kv_heads=1)),
    "hd288": ("gemma2-2b", dict(d_model=576, n_heads=2, n_kv_heads=1)),
}


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _configs(name, variant=None):
    if variant is None:
        return jget_smoke(name), get_smoke(name)
    return (jsmoke_variant(jget_config(name), **variant),
            smoke_variant(get_config(name), **variant))


def _params(jcfg, seed):
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _layer(jp, tp, i, key=None):
    jl = jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
    tl = tp["layers"][i]
    return (jl, tl) if key is None else (jl[key], tl[key])


def _tokens(cfg, B, L, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


CASES = [(n, None) for n in WINDOWED] + list(HEAD_DIM_VARIANTS.values())
IDS = WINDOWED + list(HEAD_DIM_VARIANTS)


# ----------------------------------------------------------------------
# configs and layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_windowed_configs_build_past_the_window(name, variant):
    jcfg, tcfg = _configs(name, variant)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.sliding_window == 64 and PROMPT > tcfg.sliding_window
    assert TM.layer_kinds(tcfg) == [int(k) for k in JM.layer_kinds(jcfg)]
    for ctx in (PROMPT, CAP):
        assert TM.cache_len(tcfg, ctx) == JM.cache_len(jcfg, ctx)
    if variant is not None:
        assert tcfg.head_dim in (120, 288)


@pytest.mark.parametrize("layer", [0, 1], ids=["kind0", "kind1"])
@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_attention_prefill_window_matches_blocked_and_naive(name, variant,
                                                            layer):
    """``attention_prefill`` with the layer's window against the
    reference's ``attention_blocked`` (banded on uniform-window models,
    the local/global switch on gemma2, several query blocks) and the
    naive masked product, at L = 100 past the window of 64."""
    jcfg, tcfg = _configs(name, variant)
    jp, tp = _params(jcfg, seed=layer)
    pj, pt = _layer(jp, tp, layer, "attn")
    kind = TM.layer_kinds(tcfg)[layer]
    rng = np.random.default_rng(layer)
    x = rng.standard_normal((2, PROMPT, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32)[None], (2, 1))
    window = tcfg.sliding_window if kind == 0 else 0
    out, (k, v) = TL.attention_prefill(pt, tcfg, t(x), torch.from_numpy(pos),
                                       window=window)
    small = dataclasses.replace(jcfg, attn_block_q=32)
    want, (kj, _) = JL.attention_blocked(pj, small, x, pos,
                                         kind=jnp.int32(kind))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(kj), rtol=1e-5,
                               atol=1e-5)
    iq = np.arange(PROMPT)[:, None]
    ik = np.arange(PROMPT)[None, :]
    mask = (ik <= iq) & ((ik > iq - window) if window else True)
    naive, _ = JM._attention_full_masked(pj, jcfg, x, pos, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(naive), rtol=2e-4,
                               atol=2e-4)


def test_hybrid_fusion_matches_reference():
    """hymba's mixer on its own: both branches over the sequence, each
    output normed, then their mean (``_mix_full``), and the fusion of
    two given branch outputs."""
    jcfg, tcfg = _configs("hymba-1.5b")
    jp, tp = _params(jcfg, seed=3)
    pj, pt = _layer(jp, tp, 1)
    # non-zero norm weights, so each branch norm counts
    rng = np.random.default_rng(3)
    for key in ("ln_attn_out", "ln_ssm_out"):
        w = (rng.standard_normal(jcfg.d_model) * 0.5).astype(np.float32)
        pj = dict(pj, **{key: jnp.asarray(w)})
        pt = dict(pt, **{key: t(w)})
    x = (rng.standard_normal((2, PROMPT, jcfg.d_model)) * 0.5).astype(
        np.float32)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32)[None], (2, 1))
    got, (k, v), (h, conv) = TM._mix_full(pt, tcfg, t(x),
                                          torch.from_numpy(pos), 0)
    want, (kj, vj), (hj, cj) = JM._mix_full(pj, jcfg, x, pos, jnp.int32(0),
                                            False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=2e-3,
                               atol=2e-3)
    a = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    s = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want = 0.5 * (JL.rms_norm(a, pj["ln_attn_out"])
                  + JL.rms_norm(s, pj["ln_ssm_out"]))
    np.testing.assert_allclose(TM._fuse(pt, t(a), t(s)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# the decode modes: ring and local window
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ring", "local", "full"])
def test_attention_decode_modes_match_reference(mode):
    """``attention_decode`` in the reference's three modes at ragged
    positions: a ring of C slots (slot pos % C, every slot live once
    pos >= C), a local window inside a full cache (pos - W < idx <=
    pos) and the full cache; the written slot and the output."""
    jcfg, tcfg = _configs("gemma2-2b")
    jp, tp = _params(jcfg, seed=4)
    pj, pt = _layer(jp, tp, 0, "attn")
    B, C, W = 5, 96, 40
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, C, jcfg.n_kv_heads, jcfg.head_dim)).astype(
        np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos = np.asarray([0, 17, 39, 95, 250 if mode == "ring" else 60],
                     np.int32)
    kw = dict(ring=dict(window=C), local=dict(local_window=W),
              full={})[mode]
    want, kj, vj = JL.attention_decode(pj, jcfg, x, jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(pos),
                                       attn_softcap=jcfg.attn_softcap, **kw)
    kt, vt = t(kc), t(vc)
    got, _, _ = TL.attention_decode(pt, tcfg, t(x), kt, vt,
                                    torch.from_numpy(pos).long(), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hd", [64, 120, 288])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_plain_windowed_decode_matches_reference(hd, softcap):
    """The new decode mode of the kernel's plain versions -- the keys
    kv_valid[b] - W <= ik < kv_valid[b] -- at ragged live counts, with
    chunks wholly below the window (64-key splits over 300 slots):
    ``flash_attention_plain`` and ``decode_split_plain`` against each
    other and against ``ref.mha_attention`` over each row's window."""
    B, C, Hq, Hkv, W = 5, 300, 4, 2, 70
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, hd)).astype(np.float32)
    kv = [1, 69, 70, 211, 300]
    tt = lambda a: torch.from_numpy(a).transpose(1, 2)
    kvt = torch.tensor(kv, dtype=torch.int32)
    one = FA.flash_attention_plain(tt(q), tt(k), tt(v), kvt, causal=False,
                                   softcap=softcap, local_window=W)
    split = FA.decode_split_plain(tt(q), tt(k), tt(v), kvt, softcap=softcap,
                                  local_window=W, splits=(5, 64))
    torch.testing.assert_close(split, one, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(kv):
        lo = max(0, n - W)
        want = R.mha_attention(q[b:b + 1], k[b:b + 1, lo:n],
                               v[b:b + 1, lo:n], causal=False,
                               softcap=softcap)
        np.testing.assert_allclose(one[b:b + 1].transpose(1, 2).numpy(),
                                   np.asarray(want), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="local_window"):
        FA.flash_attention(tt(q).expand(B, Hq, 2, hd), tt(k), tt(v),
                           local_window=W)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_forward_full_past_the_window_matches_reference(name, variant):
    jcfg, tcfg = _configs(name, variant)
    jp, tp = _params(jcfg, seed=5)
    toks = _tokens(jcfg, 2, PROMPT, seed=5)
    want, _, _ = JM.forward_full(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux, _ = TM.forward_full(tp, tcfg,
                                  {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_prefill_ring_and_decode_past_the_window_match_reference(name,
                                                                 variant):
    """``prefill`` (prompt 100, cap 114: a ring of 64 rolled by 36 on the
    uniform-window models, a full cache on gemma2) and 6 greedy decode
    steps: the caches and every step's logits within 1e-4, the tokens
    tie-aware."""
    jcfg, tcfg = _configs(name, variant)
    jp, tp = _params(jcfg, seed=6)
    toks = _tokens(jcfg, 3, PROMPT, seed=6)
    jl, jc, jpos = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              max_len=CAP)
    tl, tc, tpos = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              max_len=CAP)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert set(tc) == set(jc)
    ring = tcfg.local_global_pattern is False
    assert tc["k"].shape[2] == (64 if ring else CAP)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    ref_toks, ref_logits = [np.argmax(np.asarray(jl), -1)], [np.asarray(jl)]
    got_toks, got_logits = [np.argmax(tl.numpy(), -1)], [tl.numpy()]
    tok = ref_toks[-1][:, None].astype(np.int32)
    for _ in range(STEPS):
        jl, jc = JM.decode_step(jp, jcfg, jc, {"token": jnp.asarray(tok),
                                               "pos": jpos})
        tl, tc = TM.decode_step(tp, tcfg, tc, {"token": torch.from_numpy(tok),
                                               "pos": tpos})
        ref_logits.append(np.asarray(jl))
        got_logits.append(tl.numpy())
        ref_toks.append(np.argmax(ref_logits[-1], -1))
        got_toks.append(np.argmax(got_logits[-1], -1))
        tok = ref_toks[-1][:, None].astype(np.int32)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_allclose(np.stack(got_logits, 1),
                               np.stack(ref_logits, 1), rtol=1e-4,
                               atol=1e-4)
    assert_greedy_agrees(np.stack(got_toks, 1), np.stack(ref_toks, 1),
                         np.stack(ref_logits, 1))


@pytest.mark.parametrize("name", WINDOWED)
def test_runner_generates_past_the_window_like_reference(name):
    """``ModelRunner.generate`` on each windowed model with a prompt past
    its window (a wrapped ring): tokens tie-aware, step logits within
    1e-4 of the reference's greedy loop."""
    jr = JRUN.ModelRunner(jget_smoke(name), seed=7)
    tr = TRUN.ModelRunner(get_smoke(name), device="cpu",
                          params=TM.params_from_jax(
                              jax.tree_util.tree_map(np.asarray, jr.params)))
    toks = _tokens(jr.cfg, 2, 90, seed=7)
    got = tr.generate(toks, max_new=STEPS, keep_logits=True)
    ref_toks, ref_logits = jax_greedy(jr.params, jr.cfg, toks, STEPS)
    assert_greedy_agrees(got.tokens, ref_toks, ref_logits)
    np.testing.assert_allclose(got.step_logits, ref_logits, rtol=1e-4,
                               atol=1e-4)


def test_long_mode_raises_naming_its_item():
    """``long_mode``, which raised before, computes the reference's
    result on gemma2-2b past its window: ``forward_full`` (2e-4) and the
    prefill's last logits and cache (1e-4), where every layer is a ring
    of 64 slots rolled by 100 % 64 (``tests/test_torch_long_mode.py``
    holds the decode)."""
    jcfg, tcfg = _configs("gemma2-2b")
    jp, tp = _params(jcfg, 4)
    toks = _tokens(jcfg, 2, PROMPT, seed=4)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    want = JM.forward_full(jp, jcfg, jb, long_mode=True)[0]
    jl, jc, _ = JM.prefill(jp, jcfg, jb, long_mode=True, max_len=CAP)
    with torch.no_grad():
        got = TM.forward_full(tp, tcfg, tb, long_mode=True)[0]
        tl, tc, _ = TM.prefill(tp, tcfg, tb, long_mode=True, max_len=CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert tc["k"].shape[2] == jcfg.sliding_window
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
