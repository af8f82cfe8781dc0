"""The model: dense (llama-style GQA, with or without a sliding window,
gemma2's local/global alternation and softcaps), MoE, SSM (Mamba2) and
hybrid (hymba: attention and SSM in every layer) families.

Port of the JAX package's ``models/model.py`` for the families this
port serves (``layers.check_supported`` names the ROADMAP item of
every other one).  Entry points, as there:

  * ``forward_full`` -- full-sequence logits;
  * ``prefill``      -- the forward plus the decode cache;
  * ``decode_step``  -- one token against the cache.

Parameters are nested dicts.  The reference stacks the per-layer
parameters along a leading ``n_layers`` axis and scans over it; here
``params["layers"]`` is a list of per-layer dicts and the scan is a
Python loop.  ``params_from_jax`` carries a JAX parameter tree across.
The cache keeps the reference's stacked layout ((n_layers, B, C, Hkv,
hd) for K/V) and ``decode_step`` updates it in place.  On a
uniform-window model (hymba, h2o-danube) the K/V cache is a ring of C =
``cache_len`` slots; gemma2's local layers mask their window inside a
full-length cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


# ======================================================================
# init
# ======================================================================

def _init_layer(gen, cfg: ModelConfig, device, dtype) -> Params:
    dt = getattr(torch, dtype or cfg.param_dtype)
    p: Params = {k: torch.zeros((cfg.d_model,), dtype=dt, device=device)
                 for k in ("ln_mix", "ln_mlp")}
    if cfg.has_attention:
        p["attn"] = L.init_attention(gen, cfg, device, dtype)
    if cfg.has_ssm:
        p["ssm"] = L.init_ssm(gen, cfg, device, dtype)
    if cfg.arch_type == "hybrid":
        p["ln_attn_out"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        p["ln_ssm_out"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    if cfg.is_moe:
        p["moe"] = L.init_moe(gen, cfg, device, dtype)
    elif cfg.d_ff > 0:
        p["mlp"] = L.init_mlp(gen, cfg, device, dtype)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None,
                dtype: Optional[str] = None) -> Params:
    """Random parameters in ``dtype`` (default ``cfg.param_dtype``),
    drawn from ``gen`` (a ``torch.Generator`` on ``device``) with the
    distributions of the reference's ``init_params`` (not bit-equal to
    ``jax.random``).  Each tensor is drawn in f32 and rounded at once:
    the same values as ``cast_params`` of the ``param_dtype`` draw,
    without ever holding the whole model in f32."""
    L.check_supported(cfg)
    dt = getattr(torch, dtype or cfg.param_dtype)
    embed = L.dense_init(gen, (cfg.vocab_padded, cfg.d_model), dt, scale=0.02,
                         device=device)
    return {"embed": embed,
            "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=device),
            "layers": [_init_layer(gen, cfg, device, dtype)
                       for _ in range(cfg.n_layers)]}


def params_from_jax(tree, device="cpu") -> Params:
    """A JAX parameter tree (numpy leaves, per-layer parameters stacked
    along a leading axis under ``"layers"``) as port parameters."""
    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    def nest(node, i=None):
        if isinstance(node, dict):
            return {k: nest(v, i) for k, v in node.items()}
        return conv(node if i is None else np.asarray(node)[i])

    n_layers = len(next(iter(_leaves(tree["layers"]))))
    out = {k: nest(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [nest(tree["layers"], i) for i in range(n_layers)]
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def tree_map(fn, node, *rest):
    """``fn`` on every tensor of a parameter (or cache) tree, or on the
    matching leaves of several trees of one structure."""
    if isinstance(node, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in node.items()}
    if isinstance(node, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(node)]
    return fn(node, *rest)


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """Float parameters in the compute dtype (a no-op for tensors that
    already are); the runner casts once, the reference on every call."""
    cdt = getattr(torch, cfg.compute_dtype)
    return tree_map(lambda t: t.to(cdt) if t.is_floating_point() else t,
                    params)


def layer_kinds(cfg: ModelConfig) -> list:
    """Per-layer attention kind: 0 = local/SWA, 1 = global/full (gemma2
    alternates, starting local)."""
    if cfg.local_global_pattern:
        return [i % 2 for i in range(cfg.n_layers)]
    return [0 if cfg.sliding_window > 0 else 1] * cfg.n_layers


def cache_len(cfg: ModelConfig, ctx_len: int) -> int:
    """K/V slots of the decode cache: a ring of at most the window on a
    uniform-window model, else the context."""
    if not cfg.has_attention:
        return 0
    if cfg.sliding_window and not cfg.local_global_pattern:
        return min(cfg.sliding_window, ctx_len)
    return ctx_len


def _fuse(p, attn_out, ssm_out):
    """hymba's fusion of the two branches: per-branch output norm, then
    the mean."""
    return 0.5 * (L.rms_norm(attn_out, p["ln_attn_out"])
                  + L.rms_norm(ssm_out, p["ln_ssm_out"]))


# ======================================================================
# full-sequence forward (prefill)
# ======================================================================

def _mix_full(p, cfg: ModelConfig, x, positions, kind: int):
    """Sequence mixer over a full sequence: attention (with the layer's
    window: ``kind`` 0 is local), the SSM, or both fused.  Returns
    (out, kv, ssd)."""
    h = L.rms_norm(x, p["ln_mix"])
    attn_out = kv = None
    if cfg.has_attention:
        window = cfg.sliding_window if kind == 0 else 0
        attn_out, kv = L.attention_prefill(p["attn"], cfg, h, positions,
                                           window=window)
        if not cfg.has_ssm:
            return attn_out, kv, None
    out, h_final, conv_state = L.ssd_chunked(p["ssm"], cfg, h)
    if attn_out is not None:
        out = _fuse(p, attn_out, out)
    return out, kv, (h_final, conv_state)


def _ffn(p, cfg: ModelConfig, x):
    """Feed-forward half of the block.  Returns (x, aux)."""
    h = L.rms_norm(x, p["ln_mlp"])
    if cfg.is_moe:
        y, aux = L.moe_block(p["moe"], cfg, h)
    elif cfg.d_ff > 0:
        y, aux = L.mlp(p["mlp"], h), 0.0
    else:
        return x, 0.0
    return x + y, aux


def _embed_inputs(params, cfg: ModelConfig, batch):
    cdt = getattr(torch, cfg.compute_dtype)
    tokens = batch["tokens"].long()
    x = params["embed"][tokens].to(cdt)
    B, Lt = tokens.shape
    positions = torch.arange(Lt, device=x.device)[None].expand(B, Lt)
    return x, positions


def _logits(params, cfg: ModelConfig, x):
    x = L.rms_norm(x, params["ln_f"])
    logits = x @ params["embed"].T.to(x.dtype)
    return L.softcap(logits.float(), cfg.final_softcap)


def _hidden(params, cfg: ModelConfig, batch, collect_cache: bool,
            long_mode: bool = False):
    L.check_supported(cfg, long_mode)
    params = cast_params(params, cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    caches = []
    aux = 0.0
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        mix, kv, ssd = _mix_full(p, cfg, x, positions, kind)
        x, aux_i = _ffn(p, cfg, x + mix)
        aux = aux + aux_i
        caches.append((kv, ssd) if collect_cache else None)
    return params, x, caches, aux


def forward_full(params, cfg: ModelConfig, batch, *,
                 long_mode: bool = False, collect_cache: bool = False):
    """batch: {"tokens": (B, L)}.  Returns (logits (B, L, vocab_padded)
    f32, aux_loss -- the MoE load-balance losses summed over the layers,
    0.0 without experts -- and per-layer caches or Nones).  The
    reference's ``long_mode`` raises ``not_ported``."""
    params, x, caches, aux = _hidden(params, cfg, batch, collect_cache,
                                     long_mode)
    return _logits(params, cfg, x), aux, caches


# ======================================================================
# decode cache
# ======================================================================

def init_cache(cfg: ModelConfig, batch_size: int, ctx_len: int, *,
               device=None, dtype: Optional[str] = None) -> Params:
    """Zero decode cache (leading axis = n_layers) for ``ctx_len``
    positions: ``cache_len`` K/V slots."""
    L.check_supported(cfg)
    dt = getattr(torch, dtype or cfg.compute_dtype)
    nL, B = cfg.n_layers, batch_size
    cache: Params = {}
    if cfg.has_attention:
        shape = (nL, B, cache_len(cfg, ctx_len), cfg.n_kv_heads,
                 cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    if cfg.has_ssm:
        cache["ssd"] = torch.zeros((nL, B, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        cache["conv"] = torch.zeros((nL, B, cfg.ssm_conv_width - 1, conv_dim),
                                    dtype=dt, device=device)
    return cache


def decode_step(params, cfg: ModelConfig, cache: Params, batch, *,
                long_mode: bool = False):
    """One decode step.  batch: {"token": (B, 1) int, "pos": (B,) int}.
    Returns (logits (B, vocab_padded) f32, cache) -- the cache updated
    in place.  The reference's ``long_mode`` raises ``not_ported``."""
    L.check_supported(cfg, long_mode)
    params = cast_params(params, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    x = params["embed"][batch["token"].long()].to(cdt)
    pos = batch["pos"].long()
    W = cfg.sliding_window
    ring = bool(W) and not cfg.local_global_pattern
    for i, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        h = L.rms_norm(x, p["ln_mix"])
        mix = None
        if cfg.has_attention:
            local = W if cfg.local_global_pattern and kind == 0 else 0
            mix, _, _ = L.attention_decode(
                p["attn"], cfg, h, cache["k"][i], cache["v"][i], pos,
                window=cache["k"].shape[2] if ring else 0,
                local_window=local)
        if cfg.has_ssm:
            ssm_out, h_new, conv_new = L.ssd_step(p["ssm"], cfg, h,
                                                  cache["ssd"][i],
                                                  cache["conv"][i])
            cache["ssd"][i] = h_new
            cache["conv"][i] = conv_new
            mix = ssm_out if mix is None else _fuse(p, mix, ssm_out)
        x, _ = _ffn(p, cfg, x + mix)
    return _logits(params, cfg, x[:, 0]), cache


def prefill(params, cfg: ModelConfig, batch, *, long_mode: bool = False,
            max_len: int = 0):
    """Full prefill.  max_len: decode-cache capacity (>= the prompt;
    default prompt + 64).  Returns (last_logits (B, V) f32, cache,
    new_pos (B,)).  Only the last position's logits are formed: the
    (B, L, V) matrix of ``forward_full`` is not needed here.  A prompt
    longer than a ring of C slots leaves its last C keys, rolled so
    that position p sits at slot p % C.  The reference's ``long_mode``
    raises ``not_ported``."""
    params, x, caches, _ = _hidden(params, cfg, batch, True, long_mode)
    B, ctx = batch["tokens"].shape
    cap = max(max_len, ctx) if max_len else ctx + 64
    cache = init_cache(cfg, B, cap, device=x.device)
    C = cache["k"].shape[2] if "k" in cache else 0
    for i, (kv, ssd) in enumerate(caches):
        for key, t in zip("kv", kv or ()):
            if C < ctx:                          # the ring: slot = pos % C
                t = torch.roll(t[:, -C:], ctx % C, dims=1)
            cache[key][i, :, :t.shape[1]] = t.to(cache[key].dtype)
        if ssd is not None:
            cache["ssd"][i] = ssd[0]
            cache["conv"][i] = ssd[1].to(cache["conv"].dtype)
    last = _logits(params, cfg, x[:, -1])
    new_pos = torch.full((B,), ctx, dtype=torch.int64, device=x.device)
    return last, cache, new_pos
