"""The model: dense (llama-style GQA, with or without a sliding window,
gemma2's local/global alternation and softcaps), MoE, SSM (Mamba2),
hybrid (hymba: attention and SSM in every layer), encoder-decoder
(seamless: an encoder over projected frontend embeddings, and a
cross-attention in every decoder layer) and vision-language (llava:
projected frontend tokens before the text) families.

Port of the JAX package's ``models/model.py``.  Entry points, as
there:

  * ``forward_full`` -- full-sequence logits;
  * ``prefill``      -- the forward plus the decode cache;
  * ``decode_step``  -- one token against the cache;
  * ``lm_loss`` / ``loss_fn`` -- the training loss (``training/steps``
    differentiates it; with ``cfg.remat`` each layer's activations are
    recomputed in the backward, as the reference's ``jax.checkpoint``).

Parameters are nested dicts.  The reference stacks the per-layer
parameters along a leading ``n_layers`` axis and scans over it; here
``params["layers"]`` (and an encoder's ``params["enc_layers"]``) is a
list of per-layer dicts and the scan is a Python loop.
``params_from_jax`` carries a JAX parameter tree across and
``params_to_numpy`` back.
The cache keeps the reference's stacked layout ((n_layers, B, C, Hkv,
hd) for K/V, and the encoder-decoder's cross K/V (n_layers, B, S, Hkv,
hd), filled once by the prefill) and ``decode_step`` updates it in
place.  On a
uniform-window model (hymba, h2o-danube) the K/V cache is a ring of C =
``cache_len`` slots; gemma2's local layers mask their window inside a
full-length cache.  ``long_mode`` (the reference's serving of the
long_500k shape) turns every layer of a windowed model into that ring,
global layers included: the rule ``ring = sliding_window and (not
local_global_pattern or long_mode)`` is read by ``cache_len``, the
prefill's per-layer window, ``decode_step`` and the prefill's roll, as
there; a config without a window or without gemma2's alternation
computes the same with either flag.  ``kv_cache_dtype="int8"`` keeps
the K/V in int8 with f32 per-(slot, head) scales, (n_layers, B, C, Hkv,
1), quantized on write by the prefill and every decode step; the decode
kernel reads them as int8 (``kernels/ops.flash_decode``).

Sharded: every entry point also takes parameters, batches and caches
laid out as DTensors over a ``torch.distributed`` ``DeviceMesh`` by
``sharding/rules`` (``sharding/place.shard_tree``) -- PyTorch's
counterpart of the reference's ``jit(in_shardings=...)``.  The
computation runs as DTensor operations (the kernels on local blocks,
``kernels/ops``), with the reference's activation constraints
(``_act_constraint``) after every encoder and decoder layer and on the
logits; the prefill's cache is born sharded by ``cache_specs``.  The
decode takes a batch-sharded cache; the batch-1 layout, with the
cache's length split over the data axes, needs the decode's partial
softmax merged across ranks and is not run here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import place
from repro_torch.sharding.rules import (P, axis_names, axis_size,
                                        cache_specs, data_axes)

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# activation sharding constraints
# ----------------------------------------------------------------------

def _act_constraint(x, *, vocab_axis: bool = False):
    """Pin a DTensor activation to (batch over the data axes, ..., vocab
    over 'model'), each where it divides, the reference's constraint:
    without it the weights' layouts propagate into the activations
    (the LM head would gather the whole batch of f32 logits).  Partial
    sums are reduced here.  A plain tensor is returned as it is."""
    if not place.is_dtensor(x):
        return x
    mesh = x.device_mesh
    if "data" not in axis_names(mesh):
        return x
    spec = [place.fit(mesh, x.shape[0], data_axes(mesh))] + \
        [None] * (x.ndim - 1)
    if vocab_axis and x.shape[-1] % axis_size(mesh, "model") == 0:
        spec[-1] = "model"
    return place.constrain(x, P(*spec))


def _embed(table, tokens):
    """Rows of the embedding.  A DTensor table with its vocab over
    'model': each rank looks up the tokens in its vocab rows (zero
    rows for the others' tokens), and the rows are summed over 'model'
    at once."""
    if not place.is_dtensor(table):
        return table[tokens]
    mesh = table.device_mesh
    V = table.shape[0]
    v = place.fit(mesh, V, "model")
    b = place.fit(mesh, tokens.shape[0], data_axes(mesh))
    lo = mesh.get_local_rank("model") * (V // axis_size(mesh, "model")) \
        if v else 0

    def local(t, tok):
        inside = (tok >= lo) & (tok < lo + t.shape[0])
        rows = t[torch.where(inside, tok - lo, 0)]
        return torch.where(inside[..., None], rows, 0.0)
    rows = place.run_local(
        local, mesh, (table, tokens), (P(v, None), P(b, None)),
        (place.placements(P(b, None, None), mesh,
                          partial=place.split_axes(v)),),
        split=place.split_axes(b, v))
    return _act_constraint(rows)


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
    if cfg.is_encdec:
        p["cross"] = L.init_attention(gen, cfg, device, dtype, cross=True)
        p["ln_cross"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    return p


def _init_encoder_layer(gen, cfg: ModelConfig, device, dtype) -> Params:
    dt = getattr(torch, dtype or cfg.param_dtype)
    return {"attn": L.init_attention(gen, cfg, device, dtype),
            "mlp": L.init_mlp(gen, cfg, device, dtype),
            **{k: torch.zeros((cfg.d_model,), dtype=dt, device=device)
               for k in ("ln_mix", "ln_mlp")}}


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None,
                dtype: Optional[str] = None) -> Params:
    """Random parameters in ``dtype`` (default ``cfg.param_dtype``),
    drawn from ``gen`` (a ``torch.Generator`` on ``device``) with the
    distributions of the reference's ``init_params`` (not bit-equal to
    ``jax.random``).  Each tensor is drawn in f32 and rounded at once:
    the same values as ``cast_params`` of the ``param_dtype`` draw,
    without ever holding the whole model in f32."""
    dt = getattr(torch, dtype or cfg.param_dtype)
    embed = L.dense_init(gen, (cfg.vocab_padded, cfg.d_model), dt, scale=0.02,
                         device=device)
    params = {"embed": embed,
              "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=device),
              "layers": [_init_layer(gen, cfg, device, dtype)
                         for _ in range(cfg.n_layers)]}
    if cfg.is_encdec:
        params["enc_layers"] = [_init_encoder_layer(gen, cfg, device, dtype)
                                for _ in range(cfg.n_enc_layers)]
        params["ln_enc"] = torch.zeros((cfg.d_model,), dtype=dt,
                                       device=device)
    if cfg.frontend:
        params["front_proj"] = {
            "w": L.dense_init(gen, (cfg.frontend_dim, cfg.d_model), dt,
                              device=device),
            "b": torch.zeros((cfg.d_model,), dtype=dt, device=device)}
    return params


# the parameter trees' stacked per-layer lists (the reference's scans)
STACKED = ("layers", "enc_layers")


def params_from_jax(tree, device="cpu") -> Params:
    """A JAX parameter tree (numpy leaves, per-layer parameters stacked
    along a leading axis under ``"layers"`` and ``"enc_layers"``) as
    port parameters."""
    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    def nest(node, i=None):
        if isinstance(node, dict):
            return {k: nest(v, i) for k, v in node.items()}
        return conv(node if i is None else np.asarray(node)[i])

    out = {}
    for k, v in tree.items():
        if k in STACKED:
            n = len(next(iter(_leaves(v))))
            out[k] = [nest(v, i) for i in range(n)]
        else:
            out[k] = nest(v)
    return out


def params_to_numpy(params: Params, cfg: ModelConfig = None) -> Dict:
    """The inverse of ``params_from_jax``: the reference's tree, numpy
    leaves (bf16 as f32: numpy has no bf16), the per-layer lists
    stacked along a leading axis under ``"layers"`` / ``"enc_layers"``.
    ``cfg`` is accepted for the reference's signature and unused."""
    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([lay[k] for lay in layers]) for k in first}
        return np.stack([host(t) for t in layers])

    out = {}
    for k, v in params.items():
        if k in STACKED:
            out[k] = stack(v)
        else:
            out[k] = tree_map(host, v)
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


def ring_cache(cfg: ModelConfig, long_mode: bool = False) -> bool:
    """Whether every attention layer keeps a ring of the last W keys:
    a uniform window, or any window in ``long_mode``."""
    return bool(cfg.sliding_window) and (not cfg.local_global_pattern
                                         or long_mode)


def cache_len(cfg: ModelConfig, ctx_len: int, long_mode: bool = False) -> int:
    """K/V slots of the decode cache: a ring of at most the window where
    ``ring_cache``, else the context."""
    if not cfg.has_attention:
        return 0
    if ring_cache(cfg, long_mode):
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

def _mix_full(p, cfg: ModelConfig, x, positions, kind: int,
              long_mode: bool = False):
    """Sequence mixer over a full sequence: attention (with the layer's
    window: ``kind`` 0 is local, and in ``long_mode`` every layer is),
    the SSM, or both fused.  Returns (out, kv, ssd)."""
    h = L.rms_norm(x, p["ln_mix"])
    attn_out = kv = None
    if cfg.has_attention:
        window = cfg.sliding_window if kind == 0 or long_mode else 0
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


def _project_frontend(params, cfg: ModelConfig, embeds):
    fp = params["front_proj"]
    cdt = getattr(torch, cfg.compute_dtype)
    return embeds.to(device=fp["w"].device, dtype=cdt) @ fp["w"] + fp["b"]


def encode(params, cfg: ModelConfig, src_embeds):
    """The encoder stack over projected frontend embeddings (B, S,
    frontend_dim): per layer a non-causal self-attention (RoPE at 0..S-1)
    and the MLP, each after its rms norm, then ``ln_enc``.  Returns
    (B, S, d)."""
    x = _project_frontend(params, cfg, src_embeds)
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    for p in params["enc_layers"]:
        out, _ = L.attention_prefill(p["attn"], cfg,
                                     L.rms_norm(x, p["ln_mix"]), pos,
                                     causal=False)
        x = x + out
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln_mlp"]))
        x = _act_constraint(x)
    return L.rms_norm(x, params["ln_enc"])


def _embed_inputs(params, cfg: ModelConfig, batch):
    """Token embeddings; a vision-language model's projected frontend
    tokens (``batch["frontend"]``) go before them.  Returns (x (B, Ltot,
    d), positions 0..Ltot-1)."""
    cdt = getattr(torch, cfg.compute_dtype)
    tokens = batch["tokens"].long()
    x = _embed(params["embed"], tokens).to(cdt)
    if cfg.frontend and not cfg.is_encdec:
        front = _project_frontend(params, cfg, batch["frontend"]).to(cdt)
        x = torch.cat([front, x], dim=1)
    B, Lt = x.shape[:2]
    positions = torch.arange(Lt, device=x.device)[None].expand(B, Lt)
    return x, positions


def _logits(params, cfg: ModelConfig, x):
    x = L.rms_norm(x, params["ln_f"])
    logits = x @ params["embed"].T.to(x.dtype)
    logits = _act_constraint(logits, vocab_axis=True)
    return L.softcap(logits.float(), cfg.final_softcap)


def _hidden(params, cfg: ModelConfig, batch, store=None,
            long_mode: bool = False):
    """The layers over the embedded inputs.  ``store(i, kv, cross_kv,
    ssd)`` takes each layer's cache parts as the layer finishes (so a
    prefill writes them straight into its cache, never holding every
    layer's K/V twice).  Returns (params in the compute dtype, x,
    aux)."""
    params = cast_params(params, cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    enc_out = encode(params, cfg, batch["src_embeds"]) if cfg.is_encdec \
        else None

    def layer(x, p, kind):
        mix, kv, ssd = _mix_full(p, cfg, x, positions, kind, long_mode)
        x = x + mix
        cross_kv = None
        if enc_out is not None:
            cross, cross_kv = L.attention_prefill(
                p["cross"], cfg, L.rms_norm(x, p["ln_cross"]), positions,
                causal=False, kv_x=enc_out)
            x = x + cross
        x, aux_i = _ffn(p, cfg, x)
        return x, aux_i, kv, cross_kv, ssd

    # the reference's jax.checkpoint(body): a differentiated forward
    # keeps each layer's input only and recomputes the layer in the
    # backward
    remat = cfg.remat and store is None and x.requires_grad
    aux = 0.0
    for i, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        if remat:
            x, aux_i = checkpoint(lambda x, p, kind: layer(x, p, kind)[:2],
                                  x, p, kind, use_reentrant=False)
        else:
            x, aux_i, kv, cross_kv, ssd = layer(x, p, kind)
            if store is not None:
                store(i, kv, cross_kv, ssd)
        x = _act_constraint(x)
        aux = aux + aux_i
    return params, x, aux


def forward_full(params, cfg: ModelConfig, batch, *,
                 long_mode: bool = False, collect_cache: bool = False):
    """batch: {"tokens": (B, L)}, plus ``"src_embeds"`` (B, S,
    frontend_dim) for an encoder-decoder or ``"frontend"`` (B, F,
    frontend_dim) for a vision-language model.  Returns (logits (B,
    Ltot, vocab_padded) f32 -- Ltot = F + L with a frontend prefix --,
    aux_loss -- the MoE load-balance losses summed over the layers, 0.0
    without experts -- and per-layer caches or Nones).  ``long_mode``:
    every layer of a windowed model attends within its window."""
    caches = [None] * cfg.n_layers
    with place.spmd(params, batch):
        params, x, aux = _hidden(
            params, cfg, batch,
            (lambda i, *parts: caches.__setitem__(i, parts)) if collect_cache
            else None, long_mode)
        return _logits(params, cfg, x), aux, caches


# ======================================================================
# decode cache
# ======================================================================

def init_cache(cfg: ModelConfig, batch_size: int, ctx_len: int, *,
               long_mode: bool = False, enc_len: int = 0, device=None,
               dtype: Optional[str] = None) -> Params:
    """Zero decode cache (leading axis = n_layers) for ``ctx_len``
    positions: ``cache_len`` K/V slots (``kv_cache_dtype="int8"``: int8
    K/V with f32 ``k_scale`` / ``v_scale`` of shape (nL, B, C, Hkv, 1),
    the reference's layout); an encoder-decoder's cross K/V of
    ``enc_len`` encoder positions, in the compute dtype either way.
    ``device="meta"`` builds the shapes without allocating."""
    dt = getattr(torch, dtype or cfg.compute_dtype)
    nL, B = cfg.n_layers, batch_size
    cache: Params = {}
    if cfg.has_attention:
        int8 = cfg.kv_cache_dtype == "int8"
        shape = (nL, B, cache_len(cfg, ctx_len, long_mode), cfg.n_kv_heads,
                 cfg.head_dim)
        kv_dt = torch.int8 if int8 else dt
        cache["k"] = torch.zeros(shape, dtype=kv_dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=kv_dt, device=device)
        if int8:
            for key in ("k_scale", "v_scale"):
                cache[key] = torch.zeros(shape[:-1] + (1,),
                                         dtype=torch.float32, device=device)
    if cfg.has_ssm:
        cache["ssd"] = torch.zeros((nL, B, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        cache["conv"] = torch.zeros((nL, B, cfg.ssm_conv_width - 1, conv_dim),
                                    dtype=dt, device=device)
    if cfg.is_encdec:
        shape = (nL, B, enc_len, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def decode_step(params, cfg: ModelConfig, cache: Params, batch, *,
                long_mode: bool = False):
    """One decode step.  batch: {"token": (B, 1) int, "pos": (B,) int}.
    Returns (logits (B, vocab_padded) f32, cache) -- the cache updated
    in place.  Where ``ring_cache`` (every layer in ``long_mode``) the
    cache is a ring and no layer masks a local window inside it."""
    with place.spmd(params, cache, batch):
        return _decode_step(params, cfg, cache, batch, long_mode)


def _decode_step(params, cfg: ModelConfig, cache: Params, batch,
                 long_mode: bool):
    params = cast_params(params, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    x = _embed(params["embed"], batch["token"].long()).to(cdt)
    pos = batch["pos"].long()
    W = cfg.sliding_window
    ring = ring_cache(cfg, long_mode)
    for i, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        h = L.rms_norm(x, p["ln_mix"])
        mix = None
        if cfg.has_attention:
            local = W if not ring and cfg.local_global_pattern \
                and kind == 0 else 0
            scales = {key: cache[key][i] for key in ("k_scale", "v_scale")
                      if key in cache}
            mix = L.attention_decode(
                p["attn"], cfg, h, cache["k"][i], cache["v"][i], pos,
                window=cache["k"].shape[2] if ring else 0,
                local_window=local, **scales)[0]
        if cfg.has_ssm:
            ssm_out, h_new, conv_new = L.ssd_step(p["ssm"], cfg, h,
                                                  cache["ssd"][i],
                                                  cache["conv"][i])
            _set_layer(cache["ssd"], i, h_new)
            _set_layer(cache["conv"], i, conv_new)
            mix = ssm_out if mix is None else _fuse(p, mix, ssm_out)
        x = x + mix
        if cfg.is_encdec:
            x = x + L.cross_attention_decode(
                p["cross"], cfg, L.rms_norm(x, p["ln_cross"]),
                cache["cross_k"][i], cache["cross_v"][i])
        x, _ = _ffn(p, cfg, x)
        x = _act_constraint(x)
    return _logits(params, cfg, x[:, 0]), cache


def _set_layer(buf, i: int, value) -> None:
    """``buf[i] = value`` for a stacked cache buffer (n_layers, ...); a
    DTensor buffer takes ``value`` laid out as its layer i (its own
    placements, one dim down) into its local block."""
    if not place.is_dtensor(buf):
        buf[i] = value
        return
    from torch.distributed.tensor import Shard
    layer = [Shard(p.dim - 1) if isinstance(p, Shard) else p
             for p in buf.placements]
    value = place.as_dtensor(value.to(buf.dtype), buf.device_mesh)
    buf.to_local()[i] = value.redistribute(placements=layer).to_local()


def prefill(params, cfg: ModelConfig, batch, *, long_mode: bool = False,
            max_len: int = 0):
    """Full prefill.  max_len: decode-cache capacity (default context +
    64); the cache holds max(max_len, context) positions, where the
    context counts a vision-language model's frontend tokens beside the
    prompt, as the reference sizes it (so a runner's ``max_len`` of
    prompt + max_new + 8 leaves llava's decode past its cache, where
    each step sees the prefilled keys only, as there).  Returns
    (last_logits (B, V) f32, cache, new_pos (B,) = the context).  Only
    the last position's logits are formed: the (B, L, V) matrix of
    ``forward_full`` is not needed here.  A prompt longer than a ring of
    C slots leaves its last C keys, rolled so that position p sits at
    slot p % C (an int8 cache's scales with them): on every layer in
    ``long_mode``.  An encoder-decoder's cross K/V are filled here
    once.  DTensor parameters: the cache is born laid out by
    ``cache_specs`` on their mesh."""
    with place.spmd(params, batch):
        return _prefill(params, cfg, batch, long_mode, max_len)


def _prefill(params, cfg: ModelConfig, batch, long_mode: bool,
             max_len: int):
    B, ctx = batch["tokens"].shape
    if cfg.frontend and not cfg.is_encdec:
        ctx += batch["frontend"].shape[1]
    cap = max(max_len, ctx) if max_len else ctx + 64
    enc_len = batch["src_embeds"].shape[1] if cfg.is_encdec else 0
    embed = params["embed"]
    if place.is_dtensor(embed):
        shapes = init_cache(cfg, B, cap, long_mode=long_mode,
                            enc_len=enc_len, device="meta")
        cache = place.zeros_tree(
            shapes, cache_specs(cfg, embed.device_mesh, shapes),
            embed.device_mesh)
    else:
        cache = init_cache(cfg, B, cap, long_mode=long_mode,
                           enc_len=enc_len, device=embed.device)
    C = cache["k"].shape[2] if "k" in cache else 0
    int8 = "k_scale" in cache

    def store(i, kv, cross_kv, ssd):
        for key, t in zip("kv", kv or ()):
            parts = {key: t}
            if int8:                             # quantized on write
                parts[key], parts[key + "_scale"] = L.quantize_kv(t)
            for name, a in parts.items():
                if C < ctx:                      # the ring: slot = pos % C
                    sh = ctx % C                 # a roll by sh, of slices
                    a = torch.cat([a[:, ctx - sh:], a[:, ctx - C:ctx - sh]],
                                  dim=1)
                if place.is_dtensor(cache[name]):
                    pad = a.new_zeros((a.shape[0], C - a.shape[1])
                                      + tuple(a.shape[2:]))
                    _set_layer(cache[name], i, torch.cat([a, pad], dim=1))
                else:
                    cache[name][i, :, :a.shape[1]] = a.to(cache[name].dtype)
        for key, t in zip(("cross_k", "cross_v"), cross_kv or ()):
            _set_layer(cache[key], i, t)
        if ssd is not None:
            _set_layer(cache["ssd"], i, ssd[0])
            _set_layer(cache["conv"], i, ssd[1])
    params, x, _ = _hidden(params, cfg, batch, store, long_mode)
    last = _logits(params, cfg, x[:, -1])
    new_pos = torch.full((B,), ctx, dtype=torch.int64, device=x.device)
    return last, cache, new_pos


# ======================================================================
# losses
# ======================================================================

def lm_loss(logits, labels):
    """Cross-entropy with -1 = ignore, the reference's: logits (B, L, V)
    f32, labels (B, L).  The gold logit is picked with ``gather`` on one
    card; vocab-sharded DTensor logits contract a one-hot, as the
    reference does for GSPMD, so each rank reduces its vocab columns and
    only (B, L) partial sums cross ranks."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    if place.is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vocab == safe[..., None], logits, 0.0).sum(-1)
    else:
        gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(params, cfg: ModelConfig, batch):
    """(loss + 0.01 aux, (loss, aux)), the reference's: labels padded
    with -1 in front of a frontend prefix."""
    with place.spmd(params, batch):
        return _loss_fn(params, cfg, batch)


def _loss_fn(params, cfg: ModelConfig, batch):
    logits, aux, _ = forward_full(params, cfg, batch)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:      # frontend tokens first
        pad = logits.shape[1] - labels.shape[1]
        labels = torch.cat([torch.full((labels.shape[0], pad), -1,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    loss = lm_loss(logits, labels)
    return loss + 0.01 * aux, (loss, aux)
