"""The port's model zoo against the JAX package, on the CPU at the
``SMOKE`` configs: the configs themselves, each layer the port keeps
(``attention_blocked``, the naive masked attention, ``attention_decode``,
``ssd_chunked``, ``ssd_step``, the small pieces), and the model's
``prefill`` / ``decode_step`` / ``forward_full`` logits for llama3.2-1b,
mamba2-1.3b, the two MoE configs, qwen3-moe-30b-a3b (top-8) and
llama4-maverick-400b-a17b (top-1 with a shared expert), and the two
frontend configs, seamless-m4t-medium (encoder-decoder) and
llava-next-mistral-7b (vision prefix), fed seeded standard-normal
frontend embeddings (zeros would leave seamless's cross term 0);
``forward_full`` also returns the load-balance aux summed over the
layers.  Weights come from the reference's ``init_params`` through
``params_from_jax``; inputs are numpy arrays from a seed.

Tolerances: 1e-5 for element-wise pieces (same f32 arithmetic); 2e-4
for attention layers (the kernel's online softmax against a
materialised one); 2e-3 for ``ssd_chunked``, as the reference's own
layer test holds it against the sequential scan; 1e-4 for logits
(values of order 1, a dozen f32 products deep); 1e-5 for the summed
aux (two layers' losses of order 1, from gates whose inputs differ
in the last bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_eval as jget_eval
from repro.configs import get_smoke as jget_smoke
from repro.kernels import ref as R
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ARCH_NAMES, get_config, get_eval, get_smoke
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

FRONTENDS = ["seamless-m4t-medium", "llava-next-mistral-7b"]
SERVED = ["llama3.2-1b", "mamba2-1.3b", "qwen3-moe-30b-a3b",
          "llama4-maverick-400b-a17b"] + FRONTENDS
# dense GQA with q/k/v biases and no window, and the windowed and hybrid
# models (tests/test_torch_windowed.py holds them past their windows)
RUNS = SERVED + ["qwen2-1.5b", "hymba-1.5b", "h2o-danube-3-4b", "gemma2-2b"]
RNG = np.random.default_rng(0)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def inputs(cfg, toks, seed=0):
    """numpy batch of ``toks`` plus the family's frontend embeddings,
    standard normal from ``seed``: (B, 16, frontend_dim) ``src_embeds``
    for an encoder-decoder, (B, frontend_tokens, frontend_dim)
    ``frontend`` for a vision prefix."""
    b = {"tokens": toks}
    rng = np.random.default_rng(seed + 100)
    B = toks.shape[0]
    if cfg.is_encdec:
        b["src_embeds"] = rng.standard_normal(
            (B, 16, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend:
        b["frontend"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _params(name, seed=0):
    cfg = jget_smoke(name)
    jp = JM.init_params(jax.random.PRNGKey(seed), cfg)
    tp = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, get_smoke(name), jp, tp


# ----------------------------------------------------------------------
# configs: a copy of the reference's data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", J_ARCHS)
def test_config_catalog_matches_reference(name):
    assert ARCH_NAMES == J_ARCHS
    for jf, tf in ((jget_config, get_config), (jget_smoke, get_smoke)):
        assert dataclasses.asdict(jf(name)) == dataclasses.asdict(tf(name))
        assert jf(name).n_params() == tf(name).n_params()
        assert jf(name).vocab_padded == tf(name).vocab_padded
    assert jget_eval(name) == get_eval(name)


@pytest.mark.parametrize("name", FRONTENDS)
def test_unported_families_raise_naming_their_item(name):
    """Every family is ported, and the reference's ``long_mode``, which
    raised before, computes: on the two frontend configs ``prefill``
    and one ``decode_step`` with ``long_mode=True`` give the reference's
    logits (1e-4) and cache (1e-4)."""
    assert set(J_ARCHS) <= set(RUNS)
    jcfg, cfg, jp, tp = _params(name, seed=2)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jb, tb = inputs(cfg, toks, seed=2)
    jl, jc, jpos = JM.prefill(jp, jcfg, jb, long_mode=True)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl2, jc = JM.decode_step(jp, jcfg, jc, {"token": jnp.asarray(tok),
                                            "pos": jpos}, long_mode=True)
    with torch.no_grad():
        tl, tc, tpos = TM.prefill(tp, cfg, tb, long_mode=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tl2, tc = TM.decode_step(tp, cfg, tc, {"token": torch.from_numpy(tok),
                                               "pos": tpos}, long_mode=True)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4,
                               atol=1e-4)
    assert set(tc) == set(jc)
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_int8_kv_cache_init_matches_reference_layout():
    """``kv_cache_dtype="int8"`` is served: int8 K/V and f32 per-(slot,
    head) scales, the reference's keys, shapes and dtypes
    (``tests/test_torch_kv_int8.py`` holds its decode)."""
    jcfg = dataclasses.replace(jget_smoke("llama3.2-1b"),
                               kv_cache_dtype="int8")
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), kv_cache_dtype="int8")
    got = TM.init_cache(cfg, 2, 8, device="cpu")
    want = JM.init_cache(jcfg, 2, 8)
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape
        assert str(got[key].dtype)[6:] == str(w.dtype)


# ----------------------------------------------------------------------
# small pieces
# ----------------------------------------------------------------------

def test_rms_norm_rope_softcap_mlp_match_reference():
    x = RNG.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = RNG.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(TL.rms_norm(t(x), t(w)).numpy(),
                               np.asarray(JL.rms_norm(x, w)), rtol=1e-5,
                               atol=1e-5)
    pos = np.tile(np.arange(5, dtype=np.int32)[None] + 7, (2, 1))
    np.testing.assert_allclose(
        TL.apply_rope(t(x), torch.from_numpy(pos), 500_000.0).numpy(),
        np.asarray(JL.apply_rope(x, pos, 500_000.0)), rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert TL.apply_rope(xb, torch.from_numpy(pos), 1e4).dtype == \
        torch.bfloat16
    np.testing.assert_allclose(TL.softcap(t(x) * 40, 30.0).numpy(),
                               np.asarray(JL.softcap(x * 40, 30.0)),
                               rtol=1e-5, atol=1e-5)
    cfg, tcfg, jp, tp = _params("llama3.2-1b")
    h = RNG.standard_normal((2, 7, cfg.d_model)).astype(np.float32) * 0.5
    np.testing.assert_allclose(
        TL.mlp(tp["layers"][0]["mlp"], t(h)).numpy(),
        np.asarray(JL.mlp(jax.tree_util.tree_map(lambda a: a[0],
                                                 jp["layers"])["mlp"], h)),
        rtol=1e-4, atol=1e-4)


def test_causal_conv_matches_reference():
    w = RNG.standard_normal((4, 6)).astype(np.float32)
    x = RNG.standard_normal((2, 10, 6)).astype(np.float32)
    st = RNG.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        y, new = TL._causal_conv(t(x), t(w),
                                 None if state is None else t(state))
        yj, newj = JL._causal_conv(x, w, state)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(new.numpy(), np.asarray(newj), rtol=0,
                                   atol=0)


# ----------------------------------------------------------------------
# attention layers
# ----------------------------------------------------------------------

def _layer(jp, tp, i, key):
    return (jax.tree_util.tree_map(lambda a: a[i], jp["layers"])[key],
            tp["layers"][i][key])


@pytest.mark.parametrize("L", [16, 37])
def test_attention_prefill_matches_blocked_and_naive(L):
    cfg, tcfg, jp, tp = _params("llama3.2-1b")
    pj, pt = _layer(jp, tp, 1, "attn")
    x = RNG.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(L, dtype=np.int32)[None], (2, 1))
    out, (k, v) = TL.attention_prefill(pt, tcfg, t(x), torch.from_numpy(pos))
    small = dataclasses.replace(cfg, attn_block_q=8)    # several q blocks
    want, (kj, vj) = JL.attention_blocked(pj, small, x, pos)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(kj), rtol=1e-5,
                               atol=1e-5)
    mask = np.tril(np.ones((L, L), bool))
    naive, _ = JM._attention_full_masked(pj, cfg, x, pos, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(naive), rtol=2e-4,
                               atol=2e-4)


def test_naive_attn_impl_is_the_same_model():
    cfg, tcfg, jp, tp = _params("llama3.2-1b")
    toks = RNG.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    naive = dataclasses.replace(cfg, attn_impl="naive")
    want, _, _ = JM.forward_full(jp, naive, {"tokens": jnp.asarray(toks)})
    got, _, _ = TM.forward_full(tp, dataclasses.replace(tcfg,
                                                        attn_impl="naive"),
                                {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_attention_decode_matches_reference():
    cfg, tcfg, jp, tp = _params("llama3.2-1b")
    pj, pt = _layer(jp, tp, 0, "attn")
    B, C = 3, 24
    x = RNG.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc = RNG.standard_normal((B, C, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)
    vc = RNG.standard_normal(kc.shape).astype(np.float32)
    pos = np.asarray([0, 9, C - 1], np.int32)
    want, kj, vj = JL.attention_decode(pj, cfg, x, jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(pos))
    kt, vt = t(kc), t(vc)
    got, kt2, vt2 = TL.attention_decode(pt, tcfg, t(x), kt, vt,
                                        torch.from_numpy(pos).long())
    assert kt2 is kt and vt2 is vt             # one slot written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# SSM layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("L", [32, 27])
def test_ssd_chunked_matches_reference_and_sequential_oracle(L):
    cfg, tcfg, jp, tp = _params("mamba2-1.3b")
    pj, pt = _layer(jp, tp, 0, "ssm")
    u = (RNG.standard_normal((2, L, cfg.d_model)) * 0.1).astype(np.float32)
    y, hf, conv = TL.ssd_chunked(pt, tcfg, t(u))
    yj, hj, cj = JL.ssd_chunked(pj, cfg, u)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hj), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(conv.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    # the scan core against the sequential oracle of the Pallas kernel
    z, xBC, dt = JL._ssm_split(pj, cfg, u)
    xBC, _ = JL._causal_conv(xBC, pj["conv_w"])
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x = xBC[..., :di].reshape(2, L, H, P)
    A = -jnp.exp(pj["A_log"].astype(jnp.float32))
    _, h_ref = R.ssd_scan(x, dt, A, xBC[..., di:di + N], xBC[..., di + N:])
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_ref), rtol=2e-3,
                               atol=2e-3)


def test_ssd_step_matches_reference():
    cfg, tcfg, jp, tp = _params("mamba2-1.3b")
    pj, pt = _layer(jp, tp, 1, "ssm")
    B = 3
    u = (RNG.standard_normal((B, 1, cfg.d_model)) * 0.1).astype(np.float32)
    h = RNG.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)).astype(np.float32)
    conv = RNG.standard_normal((B, cfg.ssm_conv_width - 1,
                                cfg.d_inner + 2 * cfg.ssm_state)).astype(
        np.float32)
    y, h2, c2 = TL.ssd_step(pt, tcfg, t(u), t(h), t(conv))
    yj, hj, cj = JL.ssd_step(pj, cfg, u, h, conv)
    for a, b in ((y, yj), (h2, hj), (c2, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", RUNS)
def test_prefill_and_decode_logits_match_reference(name):
    cfg, tcfg, jp, tp = _params(name, seed=1)
    toks = RNG.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jb, tb = inputs(cfg, toks, seed=1)
    jl, jc, jpos = JM.prefill(jp, cfg, jb, max_len=30)
    tl, tc, tpos = TM.prefill(tp, tcfg, tb, max_len=30)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(jp, cfg, jc, {"token": jnp.asarray(tok),
                                              "pos": jpos})
        tl, tc = TM.decode_step(tp, tcfg, tc, {"token": torch.from_numpy(tok),
                                               "pos": tpos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jpos, tpos = jpos + 1, tpos + 1


@pytest.mark.parametrize("name", SERVED)
def test_forward_full_matches_reference(name):
    cfg, tcfg, jp, tp = _params(name, seed=2)
    toks = RNG.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    jb, tb = inputs(cfg, toks, seed=2)
    want, want_aux, _ = JM.forward_full(jp, cfg, jb)
    got, aux, _ = TM.forward_full(tp, tcfg, tb)
    assert got.shape[1] == 17 + (cfg.frontend_tokens if cfg.frontend and
                                 not cfg.is_encdec else 0)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-5)
    assert (float(want_aux) > 0) == tcfg.is_moe


@pytest.mark.parametrize("name", RUNS)
def test_init_params_draws_the_reference_distributions(name):
    """Same tree, shapes and dtypes as the reference's init; the same
    scales (std 1/sqrt(fan_in), 0.02 for the embedding, fixed A_log)."""
    cfg, tcfg, jp, _ = _params(name)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_t = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat_t[prefix + (k,)] = v
    walk({k: v for k, v in tp.items() if k not in TM.STACKED}, ())
    depth = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers}
    for stack in TM.STACKED:
        for i, layer in enumerate(tp.get(stack, [])):
            walk(layer, (stack, i))
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    want_keys = set()
    for path, _ in leaves:
        keys = tuple(p.key for p in path)
        want_keys |= ({(keys[0], i) + keys[1:] for i in range(depth[keys[0]])}
                      if keys[0] in depth else {keys})
    assert set(flat_t) == want_keys
    for path, leaf in leaves:
        keys = tuple(p.key for p in path)
        if keys[0] in depth:
            got = [flat_t[(keys[0], i) + keys[1:]] for i in
                   range(depth[keys[0]])]
            want = np.asarray(leaf)
        else:
            got, want = [flat_t[keys]], np.asarray(leaf)[None]
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == \
                str(w.dtype), keys
            if keys[-1] in ("A_log", "D", "dt_bias", "norm", "ln_mix",
                            "ln_mlp", "ln_f", "ln_cross", "ln_enc", "b"):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
            elif w.size > 1000:
                assert abs(g.std().item() / w.std() - 1) < 0.05, keys
