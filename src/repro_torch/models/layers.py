"""Building blocks of the model zoo, for the families this port serves
(dense attention with or without a sliding window, local/global
alternation and softcaps, mixture-of-experts FFNs, the Mamba2 SSM and
the hybrid attention+SSM layer).

Port of the JAX package's ``models/layers.py``.  Parameters are plain
dicts of tensors and layers are functions ``f(p, x, ...) -> y``, as
there.  Attention, prefill and decode alike, goes through
``kernels/ops.flash_attention`` -- the hand-written kernel on the card
-- the SSD scan of a prefill through ``kernels/ops.ssd_scan``, and the
MoE gate through ``kernels/ops.moe_gating``; the reference's jnp
attention variants (``attention_full``, the naive masked product,
``attention_blocked``) are one structure here.  The decode step writes
its one KV slot in place (the reference returns a new cache; PyTorch
can update the buffer it was given).

Every ``init_*`` takes ``dtype`` (a name, as in the config; default
``cfg.param_dtype``) and rounds each tensor to it as soon as it is
drawn, so a model bigger than the card in f32 can be drawn on it in
bf16, one f32 tensor at a time.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.routing import not_ported
from repro_torch.kernels import ops

_ITEM6 = "item 6.{} '{}'"


def check_supported(cfg, long_mode: bool = False) -> None:
    """Raise ``not_ported`` for any part of ``cfg`` (or the reference's
    ``long_mode``) the port does not serve, naming its ROADMAP.md
    item."""
    if cfg.arch_type not in ("dense", "moe", "ssm", "hybrid") or \
            cfg.frontend:
        raise not_ported("Modality frontends and encoder-decoders",
                         _ITEM6.format(4, "encdec and vlm frontends: "
                                          "seamless-m4t-medium, "
                                          "llava-next-mistral-7b"))
    if cfg.kv_cache_dtype == "int8":
        raise not_ported("kv_cache_dtype='int8'",
                         _ITEM6.format(5, "the int8 KV cache"))
    if long_mode:
        raise not_ported("long_mode (long_mode_local_only serving)",
                         "item 12 'the rest'")


# ----------------------------------------------------------------------
# init helper
# ----------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Normal(0, std) with std = 1/sqrt(fan_in) (or ``scale``), the
    distribution of the reference's ``dense_init``; the draws come from
    ``gen``, not from ``jax.random``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


# ----------------------------------------------------------------------
# norms / activations
# ----------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, L, H, hd); positions: (B, L) int.  f32 math, cast back."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * inv              # (B, L, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention (GQA, optional bias)
# ----------------------------------------------------------------------

def init_attention(gen, cfg, device=None, dtype=None):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = getattr(torch, dtype or cfg.param_dtype)
    p = {"wq": dense_init(gen, (d, qd), dt, device=device),
         "wk": dense_init(gen, (d, kvd), dt, device=device),
         "wv": dense_init(gen, (d, kvd), dt, device=device),
         "wo": dense_init(gen, (qd, d), dt, device=device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((qd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kvd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kvd,), dtype=dt, device=device)
    return p


def _split_heads(x, n_heads: int, head_dim: int):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def qkv(p, cfg, x):
    """The q/k/v projections, split into heads: (B, L, H, hd) each."""
    def proj(w, b):
        y = x @ p[w]
        return y + p[b] if b in p else y
    q = _split_heads(proj("wq", "bq"), cfg.n_heads, cfg.head_dim)
    k = _split_heads(proj("wk", "bk"), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(proj("wv", "bv"), cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def attention_prefill(p, cfg, x, positions, window: int = 0):
    """Causal full-sequence attention (prefill / training forward): query
    i sees keys i - window < j <= i (``window`` 0: all j <= i) -- the
    layer's sliding window, which the caller gives per layer (a uniform
    window, or gemma2's local layers; its global layers take 0).  Both
    ``attn_impl`` values of the reference (``attention_blocked``, banded
    or with the local/global switch, and the naive masked product)
    compute this function, which is one launch of the flash kernel
    here, with ``cfg.attn_softcap`` before the mask.  Returns (out (B,
    L, d), (k, v)) -- k post-RoPE, the prefill cache."""
    B, L, _ = x.shape
    q, k, v = qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap)
    out = out.reshape(B, L, cfg.q_dim) @ p["wo"]
    return out, (k, v)


def attention_decode(p, cfg, x, k_cache, v_cache, positions, *,
                     window: int = 0, local_window: int = 0):
    """Single-token decode against a KV cache, in the reference's modes.

    x: (B, 1, d); k_cache / v_cache: (B, C, Hkv, hd), written in place
    (keys post-RoPE); positions: (B,) int -- the index of the current
    token.  ``window`` != 0: the cache is a ring of the last C keys
    (sliding-window layers), written at slot ``position % C``, every
    slot live once position >= C.  Otherwise the slot is ``position``
    and slots <= position are live, and ``local_window`` W keeps only
    the slots position - W < idx <= position (gemma2's local layers in
    their full cache).  Returns (out, k_cache, v_cache).

    A row at position >= C in a full cache writes nothing and sees all
    C slots, as the reference's dropped out-of-bounds write and
    ``idx <= pos`` mask give (the continuous batcher's idle slots and
    a request's last, discarded tick sit there).  The write is masked
    on the device: such a row writes its slot's old value back, so no
    step waits on the host.  On a local layer such a row sees the last
    W slots of the cache, where the reference sees the slots past
    position - W; the two differ only once position >= W too."""
    B, C = x.shape[0], k_cache.shape[1]
    q, k, v = qkv(p, cfg, x)
    pos2 = positions[:, None]
    q = apply_rope(q, pos2, cfg.rope_theta)
    k = apply_rope(k, pos2, cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    if window:
        slot = positions % C
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    else:
        inside = (positions < C)[:, None, None]
        slot = torch.where(positions < C, positions, 0)
        for cache, new in ((k_cache, k), (v_cache, v)):
            cache[rows, slot] = torch.where(
                inside, new[:, 0].to(cache.dtype), cache[rows, slot])
    out = ops.flash_decode(q, k_cache, v_cache, positions,
                           local_window=local_window,
                           softcap=cfg.attn_softcap)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    return out, k_cache, v_cache


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

def init_mlp(gen, cfg, device=None, dtype=None):
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, dtype or cfg.param_dtype)
    return {"wi": dense_init(gen, (d, f), dt, device=device),
            "wg": dense_init(gen, (d, f), dt, device=device),
            "wo": dense_init(gen, (f, d), dt, device=device)}


def mlp(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ----------------------------------------------------------------------
# Mixture of experts
# ----------------------------------------------------------------------

def init_moe(gen, cfg, device=None, dtype=None):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = getattr(torch, dtype or cfg.param_dtype)
    p = {"router": dense_init(gen, (d, E), dt, scale=0.02, device=device),
         "wi": dense_init(gen, (E, d, f), dt, device=device),
         "wg": dense_init(gen, (E, d, f), dt, device=device),
         "wo": dense_init(gen, (E, f, d), dt, device=device)}
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, cfg, device, dtype)
    return p


def moe_gate(logits, top_k: int):
    """Top-k gating in the reference's mask form (only its tests use
    it; the model's path is ``moe_block``).  logits (..., E) ->
    (weights (..., E), zero outside the top-k and renormalized inside
    it, in logits' dtype; the load-balance aux loss).  Every expert
    whose probability ties the k-th is in the mask, as there."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    thresh = torch.topk(probs, top_k, dim=-1).values[..., -1:]
    mask = probs >= thresh
    gated = probs * mask
    gated = gated / (gated.sum(dim=-1, keepdim=True) + 1e-9)
    me = probs.reshape(-1, E).mean(dim=0)
    ce = mask.reshape(-1, E).float().mean(dim=0)
    return gated.to(logits.dtype), torch.sum(me * ce) * E


def moe_block(p, cfg, x):
    """Capacity-based MoE over groups of the sequence, with the
    reference's semantics (``moe_block`` there: T5X/Switch style).

    Tokens are grouped along the sequence (g = min(``cfg.moe_group``,
    L)); a trailing partial group is a second call, and the two aux
    losses are summed.  Per group, each expert takes C = ceil(g * k /
    E * capacity_factor) (token, choice) pairs, in k-major then token
    order; a pair's position counts every earlier pair to its expert,
    dropped ones included, and pairs at position >= C are dropped (the
    token's residual passes through).  The gate is one launch of
    ``ops.moe_gating`` per group shape.

    The reference's dense one-hot (G, g, E, C) dispatch and combine
    einsums are an index gather and a per-token product over the same
    slots here: each slot holds at most one token, so the dispatch is
    exact, and the combine weights are rounded to x's dtype before the
    product as there.  The expert FFN over (E, G * C, d) is three
    batched products.  x: (B, L, d) -> (y, aux)."""
    B, Lx, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    g = min(cfg.moe_group, Lx)
    ng = Lx // g
    if Lx - ng * g:
        y_h, aux_h = moe_block(p, cfg, x[:, :ng * g])
        y_t, aux_t = moe_block(p, cfg, x[:, ng * g:])
        return torch.cat([y_h, y_t], dim=1), aux_h + aux_t
    C = max(1, math.ceil(g * K / E * cfg.moe_capacity_factor))
    G = B * ng
    dev = x.device
    xg = x.reshape(G * g, d)
    logits = (xg @ p["router"]).reshape(G, g, E)
    vals, idx, aux = ops.moe_gating(logits, K)               # (G, g, K)

    # pairs of a group in k-major, then token order; a pair's position
    # is its rank among the pairs to its expert (a stable sort keeps
    # their order), dropped pairs included
    n_pair = K * g
    expert = idx.transpose(1, 2).reshape(G, n_pair).long()
    order = torch.argsort(expert, dim=1, stable=True)
    run = expert.gather(1, order)
    rank = torch.arange(n_pair, device=dev) - torch.searchsorted(run, run)
    pos = torch.empty_like(order).scatter_(1, order, rank)
    keep = pos < C
    grp = torch.arange(G, device=dev)[:, None]
    tok = grp * g + torch.arange(n_pair, device=dev)[None, :] % g
    slot = torch.where(keep, (expert * G + grp) * C + pos, 0)   # (E, G, C)

    # dispatch: the token row of each slot, or the zero row G * g;
    # dropped pairs write the spare entry E * G * C, never read
    n_slot = E * G * C
    src = torch.full((n_slot + 1,), G * g, dtype=torch.int64, device=dev)
    src.index_copy_(0, torch.where(keep, slot, n_slot).reshape(-1),
                    tok.reshape(-1))
    xin = torch.cat([xg, xg.new_zeros((1, d))])[src[:n_slot]]
    xin = xin.view(E, G * C, d)
    h = F.silu(torch.bmm(xin, p["wg"])) * torch.bmm(xin, p["wi"])
    out = torch.bmm(h, p["wo"]).reshape(n_slot, d)

    # combine: per token, its k kept outputs weighted by their gates in
    # x's dtype, summed by one (1, k) x (k, d) product per token
    def per_token(t):                        # (G, K g) -> (G g, K)
        return t.view(G, K, g).transpose(1, 2).reshape(G * g, K)
    w = torch.where(keep, vals.transpose(1, 2).reshape(G, n_pair), 0.0)
    y = torch.bmm(per_token(w).to(x.dtype)[:, None, :],
                  out[per_token(slot)])
    y = y.reshape(B, Lx, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    return y, aux


# ----------------------------------------------------------------------
# Mamba2 / SSD
# ----------------------------------------------------------------------

def init_ssm(gen, cfg, device=None, dtype=None):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N                                  # groups = 1
    dt = getattr(torch, dtype or cfg.param_dtype)
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * N + H), dt,
                              device=device),
        "conv_w": dense_init(gen, (cfg.ssm_conv_width, conv_dim), dt,
                             scale=0.5, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)).to(dt),
        "D": torch.ones((H,), dtype=dt, device=device),
        "dt_bias": torch.zeros((H,), dtype=dt, device=device),
        "norm": torch.zeros((di,), dtype=dt, device=device),
        "out_proj": dense_init(gen, (di, d), dt, device=device),
    }


def _ssm_split(p, cfg, u):
    """Project + split.  u: (B, L, d) -> z, xBC, dt (dt f32)."""
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = u @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt_raw = zxbcdt[..., di + di + 2 * N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return z, xBC, dt


def _causal_conv(xBC, w, state=None):
    """Depthwise causal conv.  xBC: (B, L, C); w: (K, C); state:
    (B, K-1, C) previous inputs (decode) or None (zero history).
    Returns (silu(y), new_state)."""
    K = w.shape[0]
    B, L, Cc = xBC.shape
    if state is None:
        state = xBC.new_zeros((B, K - 1, Cc))
    xpad = torch.cat([state, xBC], dim=1)                  # (B, K-1+L, C)
    y = xpad[:, 0:L, :] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xpad[:, i:i + L, :] * w[i][None, None, :]
    new_state = xpad[:, -(K - 1):, :]
    return F.silu(y), new_state


def ssd_chunked(p, cfg, u, h0=None, conv_state=None):
    """SSD forward over a full sequence (prefill): the scan core is one
    launch of the SSD kernel (``ops.ssd_scan``, any L -- the ragged
    tail is the kernel's), then the D skip, the gated ``rms_norm`` and
    ``out_proj``.  u: (B, L, d).  Returns (y (B, L, d), final state
    (B, H, P, N) f32, conv_state)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Bb, L, _ = u.shape
    z, xBC, dt = _ssm_split(p, cfg, u)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], conv_state)
    x = xBC[..., :di].unflatten(-1, (H, P))                 # strided view
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    A = -torch.exp(p["A_log"].float())
    y, h_final = ops.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=cfg.ssm_chunk)
    y = y + x.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(Bb, L, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], h_final, conv_state


def ssd_step(p, cfg, u, h, conv_state):
    """Single-token SSD decode (plain PyTorch: the reference has no
    kernel for it).  u: (B, 1, d); h: (B, H, P, N) f32."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Bb = u.shape[0]
    z, xBC, dt = _ssm_split(p, cfg, u)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], conv_state)
    x = xBC[:, 0, :di].reshape(Bb, H, P).float()
    Bm = xBC[:, 0, di:di + N].float()
    Cm = xBC[:, 0, di + N:].float()
    dt1 = dt[:, 0, :]                                       # (B, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt1 * A[None, :])                         # (B, H)
    h = h * a[:, :, None, None] + torch.einsum("bn,bhp,bh->bhpn", Bm, x, dt1)
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + x * p["D"].float()[None, :, None]
    y = y.reshape(Bb, 1, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], h, conv_state
