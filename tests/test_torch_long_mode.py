"""``long_mode`` in the port against the JAX package, on the CPU.

``long_mode`` is how the reference serves the long_500k shape: on a
windowed model every attention layer becomes a ring of the last W keys,
gemma2's global layers included (``ring = sliding_window and (not
local_global_pattern or long_mode)``, read by ``cache_len``, the
prefill's band, the decode and the prefill's roll).  gemma2-2b at
``SMOKE`` (window 64) with a prompt of 80 tokens: the band bites on
every layer and the prefill's ring of 64 slots is rolled by 80 % 64 =
16.  Weights come from the reference's ``init_params`` through
``params_from_jax``; inputs are numpy arrays from a seed.

Tolerances, as in ``tests/test_torch_windowed.py`` and
``tests/test_torch_kv_int8.py``: ``forward_full`` logits within 2e-4
(the kernel's online softmax against a materialised one, two layers);
prefill and decode logits and the f32 caches within 1e-4; with the int8
cache the logits within 2e-4 for the prefill and 1e-3 over the decode
steps and the int8 values within 1 on at most 0.1% of the elements
(``test_torch_kv_int8.assert_caches_close``); greedy tokens tie-aware.
The reference's int8 decode runs under ``jax.disable_jit()`` (compiled,
XLA drops the bf16 rounding it asks for; ROADMAP Queue 3).

The long_500k decode step (B = 1, pos 524,287, a seeded full cache) is
held to the reference run op by op (``jax.disable_jit()``) within 1e-4
(measured 1.2e-6 to 2.0e-6 at every position from 1,023 to 524,287).
Compiled, the reference is not its own op-by-op self at long positions:
XLA constant-folds ``rope_freqs`` with another ``pow`` than the one
its eager ops run, several inverse frequencies move by an f32 ulp, and
an ulp of a frequency times pos ~5e5 is up to 7.8e-3 rad of angle.  At
``SMOKE`` its decode logits move by 1.2e-4 at pos 32,767 (gemma2-2b;
9.9e-5 at 16,383) and 1.5e-4 at 8,191 (llama3.2-1b; 8.2e-5 at 4,095),
and by 1.9e-3 and 7.6e-3 at 524,287.  The port keeps the reference's
order of operations, so it sits that far from the compiled reference;
the test checks that its distance to the compiled run is the compiled
run's distance to the op-by-op one, within 1e-5.  At gemma2's published
head dim 288 the two packages' own CPU ``pow`` also differ, in one of
the 144 frequencies (``test_rope_gap_at_head_dim_288``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import steps as JS
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.training import steps as TS
from test_torch_generate import assert_greedy_agrees
from test_torch_kv_int8 import assert_caches_close

NAME = "gemma2-2b"
B, PROMPT, CAP, STEPS = 2, 80, 96, 8
LONG_POS = 524_287                       # the last position of long_500k
FWD_TOL, STEP_TOL, Q8_STEP_TOL = 2e-4, 1e-4, 1e-3


def _params(jcfg, seed):
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _kv(cfg, kv):
    return dataclasses.replace(cfg, kv_cache_dtype=kv) if kv else cfg


def test_forward_full_long_mode_matches_reference():
    jcfg, tcfg = jget_smoke(NAME), get_smoke(NAME)
    jp, tp = _params(jcfg, 3)
    toks = _tokens(jcfg, (B, PROMPT), 3)
    want = np.asarray(JM.forward_full(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                      long_mode=True)[0])
    with torch.no_grad():
        got = TM.forward_full(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              long_mode=True)[0].numpy()
        short = TM.forward_full(tp, tcfg,
                                {"tokens": torch.from_numpy(toks)})[0].numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    # the global layers' band changes the rows past the window only
    assert np.abs(got - short)[:, 64:].max() > 1e-3
    np.testing.assert_array_equal(got[:, :64], short[:, :64])


@pytest.mark.parametrize("kv", ["", "int8"], ids=["f32", "int8"])
def test_prefill_and_decode_long_mode_match_reference(kv):
    """``make_prefill_step(long_mode=True)`` then 8 steps of
    ``make_decode_step(long_mode=True)``: the cache after the prefill
    (the ring of 64 rolled by 16 on both layers), each step's logits fed
    the reference's greedy token, and the greedy tokens tie-aware."""
    jcfg, tcfg = _kv(jget_smoke(NAME), kv), _kv(get_smoke(NAME), kv)
    jp, tp = _params(jcfg, 5)
    toks = _tokens(jcfg, (B, PROMPT), 5)
    jpre = JS.make_prefill_step(jcfg, long_mode=True, max_len=CAP)
    jdec = JS.make_decode_step(jcfg, long_mode=True)
    tpre = TS.make_prefill_step(tcfg, long_mode=True, max_len=CAP)
    tdec = TS.make_decode_step(tcfg, long_mode=True)
    with jax.disable_jit(bool(kv)), torch.no_grad():
        jl, jc, jpos = jpre(jp, {"tokens": jnp.asarray(toks)})
        tl, tc, tpos = tpre(tp, {"tokens": torch.from_numpy(toks)})
        assert tc["k"].shape[2] == TM.cache_len(tcfg, CAP, True) == 64
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=2 * STEP_TOL, atol=2 * STEP_TOL)
        if kv:
            assert_caches_close(tc, jc)
        else:
            for key in jc:
                np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                           rtol=STEP_TOL, atol=STEP_TOL,
                                           err_msg=key)
        assert np.array_equal(tpos.numpy(), np.asarray(jpos))
        want_tok, want_log, got_tok = [np.argmax(np.asarray(jl), -1)], \
            [np.asarray(jl)], [tl.numpy().argmax(-1)]
        for _ in range(STEPS):
            tok = want_tok[-1][:, None].astype(np.int32)
            jl, jnext, jc = jdec(jp, jc, {"token": jnp.asarray(tok),
                                          "pos": jpos})
            tl, tnext, tc = tdec(tp, tc, {"token": torch.from_numpy(tok),
                                          "pos": tpos})
            jpos, tpos = jpos + 1, tpos + 1
            tol = Q8_STEP_TOL if kv else STEP_TOL
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                       atol=tol)
            want_tok.append(np.asarray(jnext)[:, 0])
            want_log.append(np.asarray(jl))
            got_tok.append(tnext.numpy()[:, 0])
        if kv:
            assert_caches_close(tc, jc)
    assert_greedy_agrees(np.stack(got_tok, 1), np.stack(want_tok, 1),
                         np.stack(want_log, 1))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_len_and_init_cache_match_reference(name):
    """Every config at full width, both flags, both cache dtypes: the
    K/V slots and every cache leaf's shape and dtype equal the
    reference's abstract cache; the port's is built on ``meta``."""
    assert set(JARCHS) == set(ARCH_NAMES)
    for kv in ("", "int8"):
        jcfg, tcfg = _kv(jget_config(name), kv), _kv(get_config(name), kv)
        enc = 64 if tcfg.is_encdec else 0
        for long_mode in (False, True):
            for ctx in (100, 8192):
                assert TM.cache_len(tcfg, ctx, long_mode) == \
                    JM.cache_len(jcfg, ctx, long_mode), (ctx, long_mode)
            want = jax.eval_shape(lambda: JM.init_cache(
                jcfg, 2, 8192, long_mode=long_mode, enc_len=enc))
            got = TM.init_cache(tcfg, 2, 8192, long_mode=long_mode,
                                enc_len=enc, device="meta")
            assert set(got) == set(want)
            for key, w in want.items():
                assert tuple(got[key].shape) == w.shape, (key, long_mode)
                assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
                assert got[key].is_meta
    if not (tcfg.sliding_window and tcfg.local_global_pattern):
        # long_mode changes nothing for a config without the alternation
        for ctx in (100, 8192):
            assert TM.cache_len(tcfg, ctx, True) == TM.cache_len(tcfg, ctx)


@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "llama3.2-1b"])
def test_long_mode_is_a_no_op_without_the_alternation(name):
    """A uniform window (h2o-danube) or no window (llama): the flag
    changes nothing, in the port as in the reference."""
    cfg = get_smoke(name)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(cfg, (B, PROMPT), 1))}
    with torch.no_grad():
        a = TM.prefill(tp, cfg, toks, max_len=CAP)
        b = TM.prefill(tp, cfg, toks, long_mode=True, max_len=CAP)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    for key in a[1]:
        torch.testing.assert_close(a[1][key], b[1][key], rtol=0, atol=0)


def _seeded_cache(jcache, seed):
    """The reference's zero cache filled with seeded values: K/V of
    order 1, an SSM state and conv window of order 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in jcache.items():
        scale = 1.0 if key in ("k", "v") else 0.1
        out[key] = (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["gemma2-2b", "llama3.2-1b", "mamba2-1.3b"])
def test_long_500k_decode_step_matches_reference(name):
    """One step of the long_500k decode at ``SMOKE``: B = 1 at pos
    524,287 against a seeded full cache, the config and flag
    ``launch/shapes.input_specs`` gives (gemma2 in ``long_mode``, a ring
    of 64; llama3.2-1b's ``long_serving_config``, a ring of 4,096;
    mamba2's state alone)."""
    jcfg = jget_smoke(name)
    long_mode = jcfg.long_mode_local_only
    jcfg = jcfg.long_serving_config()
    tcfg = get_smoke(name).long_serving_config()
    assert tcfg == dataclasses.replace(tcfg, **dataclasses.asdict(jcfg))
    jp, tp = _params(jcfg, 11)
    jcache = JM.init_cache(jcfg, 1, LONG_POS + 1, long_mode=long_mode)
    seeded = _seeded_cache(jcache, 11)
    jcache = {k: jnp.asarray(v) for k, v in seeded.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in seeded.items()}
    if "k" in tcache:
        assert tcache["k"].shape[2] == TM.cache_len(tcfg, LONG_POS + 1,
                                                    long_mode)
    tok = _tokens(jcfg, (1, 1), 11)
    pos = np.array([LONG_POS], np.int32)
    batch = {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)}
    compiled = np.asarray(JM.decode_step(jp, jcfg, jcache, batch,
                                         long_mode=long_mode)[0])
    with jax.disable_jit():
        jl, jc = JM.decode_step(jp, jcfg, jcache, batch, long_mode=long_mode)
    with torch.no_grad():
        tl, tc = TM.decode_step(tp, tcfg, tcache,
                                {"token": torch.from_numpy(tok),
                                 "pos": torch.from_numpy(pos).long()},
                                long_mode=long_mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=STEP_TOL,
                               atol=STEP_TOL)
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=key)
    own_gap = np.abs(compiled - np.asarray(jl)).max()
    assert abs(np.abs(compiled - tl.numpy()).max() - own_gap) <= 1e-5


def test_rope_gap_at_head_dim_288():
    """The RoPE finding at long positions, pinned: at gemma2's head dim
    288 (theta 1e4) the two packages' inverse frequencies differ in one
    element by one f32 ulp (CPU ``pow``), and that alone separates their
    rotations at pos ~5e5; with the reference's frequencies the port's
    rotation agrees to f32 rounding at every position."""
    hd, theta = 288, 10_000.0
    want = np.asarray(JL.rope_freqs(hd, theta))
    got = TL.rope_freqs(hd, theta).numpy()
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).sum() <= 1
    x = np.random.default_rng(0).standard_normal((1, 64, 2, hd)
                                                 ).astype(np.float32)
    pos = np.arange(LONG_POS - 63, LONG_POS + 1, dtype=np.int32)[None]
    ref = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # the port's own frequencies: the gap the one ulp makes (measured
    # 2.8e-3 on this input at these positions)
    port = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                         theta).numpy()
    gap = np.abs(port - ref).max()
    assert gap <= 5e-3
    # the port's arithmetic with the reference's frequencies
    ang = torch.from_numpy(pos).long()[..., None].float() * torch.from_numpy(want)
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = torch.from_numpy(x).chunk(2, dim=-1)
    same = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).numpy()
    np.testing.assert_allclose(same, ref, rtol=0, atol=2e-6)


def test_rope_freqs_off_the_host_are_the_hosts_cached():
    """On a device other than the CPU the frequencies are the host's,
    moved once and cached (``tests/test_torch_cuda.py`` holds the
    card's bits to the host's)."""
    a = TL.rope_freqs(288, 10_000.0, "meta")
    assert a is TL.rope_freqs(288, 10_000.0, torch.device("meta"))
    assert a.shape == (144,) and a.dtype == torch.float32 and a.is_meta
