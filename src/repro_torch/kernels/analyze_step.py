"""Fused analyze->route program: token ids -> analyzer encoder -> heads
-> task vectors -> feedback gather -> routing step, one PyTorch program
per batch (port of the JAX package's ``kernels/analyze_step.py``).

``AnalyzerEncoder`` is the pre-LN transformer encoder of the task
analyzer as an ``nn.Module``.  Its weights are buffers; an int8 variant
holds each 2-D matrix as an ``(int8, scale)`` buffer pair and
dequantizes on use, as ``_maybe_deq`` does in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.data.tokenizer import PAD_ID
from repro_torch.kernels.route_step import route_step_body

# weight names of the flat analyzer state, per layer and global
LAYER_KEYS = ("wq", "wk", "wv", "wo", "wi", "wp", "ln1", "ln2")
GLOBAL_KEYS = ("embed", "pos", "ln_f", "head_tt", "head_dm", "head_cx")


def _ln(x, g, eps: float = 1e-6):
    """No-bias layer norm with the population variance, eps inside the
    rsqrt — the reference's ``_ln``."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g


class AnalyzerEncoder(nn.Module):
    """The analyzer encoder + heads.  ``state`` maps flat names
    (``embed``, ``layers.0.wq``, ...) to numpy arrays, or to ``(int8,
    scale)`` pairs for quantized matrices."""

    def __init__(self, cfg, state: Dict[str, object]):
        super().__init__()
        self.cfg = cfg
        self.quantized = isinstance(state["embed"], tuple)
        for name, v in state.items():
            key = name.replace(".", "_")
            if isinstance(v, tuple):
                self.register_buffer(key + "_q", torch.from_numpy(
                    np.array(v[0], np.int8)))
                self.register_buffer(key + "_s", torch.from_numpy(
                    np.array(v[1], np.float32)))
            else:
                self.register_buffer(key, torch.from_numpy(
                    np.array(v, np.float32)))

    @property
    def device(self) -> torch.device:
        return self.embed_q.device if self.quantized else self.embed.device

    def w(self, name: str) -> torch.Tensor:
        """A weight, dequantized when stored as an (int8, scale) pair."""
        key = name.replace(".", "_")
        q = getattr(self, key + "_q", None)
        if q is not None:
            return q.float() * getattr(self, key + "_s")
        return getattr(self, key)

    def forward(self, tokens: torch.Tensor):
        """tokens (B, L) int -> (tt_logits, dm_logits, complexity (B,))."""
        return encoder_forward(self.cfg, self.w, tokens)


def encoder_forward(cfg, w, tokens: torch.Tensor):
    """The encoder + heads with weights from ``w(name)`` (a flat name
    such as ``layers.0.wq`` -> tensor): the module's buffers at
    inference, leaf tensors that require grad in training.  tokens (B,
    L) int -> (tt_logits, dm_logits, complexity (B,))."""
    B, L = tokens.shape
    mask = tokens != PAD_ID
    x = w("embed")[tokens.long()] + w("pos")[None, :L]
    H, hd = cfg.n_heads, cfg.head_dim
    neg = torch.where(mask, 0.0, -1e30)[:, None, None, :]
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        h = _ln(x, w(p + "ln1"))
        q = (h @ w(p + "wq")).reshape(B, L, H, hd)
        k = (h @ w(p + "wk")).reshape(B, L, H, hd)
        v = (h @ w(p + "wv")).reshape(B, L, H, hd)
        s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(hd) + neg
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhlm,bmhd->blhd", a, v).reshape(B, L, -1)
        x = x + o @ w(p + "wo")
        h = _ln(x, w(p + "ln2"))
        x = x + F.gelu(h @ w(p + "wi"), approximate="tanh") @ w(p + "wp")
    x = _ln(x, w("ln_f"))
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    pooled = (x * mask[..., None]).sum(dim=1) / denom
    tt = pooled @ w("head_tt")
    dm = pooled @ w("head_dm")
    cx = torch.sigmoid(pooled @ w("head_cx"))[:, 0]
    return tt, dm, cx


def analyze_heads(encoder: AnalyzerEncoder, tokens: torch.Tensor):
    """Encoder + epilogue: softmax heads, first-occurrence argmax over
    the probabilities, complexity clamp, min-of-maxes confidence."""
    tt, dm, cx = encoder(tokens)
    tt_p = torch.softmax(tt, dim=-1)
    dm_p = torch.softmax(dm, dim=-1)
    return (torch.argmax(tt_p, dim=1).to(torch.int32),
            torch.argmax(dm_p, dim=1).to(torch.int32),
            torch.clamp(cx, 0.0, 1.0),
            torch.minimum(tt_p.amax(dim=1), dm_p.amax(dim=1)))


def analyze_step_body(encoder: AnalyzerEncoder, tokens: torch.Tensor):
    """Analyzer half over a bucket-padded batch: (Qp,) ``tt_idx`` /
    ``dm_idx`` (raw head argmax), ``cx`` (clipped), ``conf``."""
    tt_idx, dm_idx, cx, conf = analyze_heads(encoder, tokens)
    return {"tt_idx": tt_idx, "dm_idx": dm_idx, "cx": cx, "conf": conf}


def analyze_route_step_body(encoder: AnalyzerEncoder, tokens, W, threshold,
                            fb_table: Optional[torch.Tensor], e2, e2s,
                            masks_table, counts_table, theta, ainv_flat,
                            lpen, rparams, *, acc_col: int,
                            use_complexity: bool, fb_buckets: int, k: int,
                            r: int, n_tt: int, n_dm: int,
                            quant: bool = False):
    """One program from token ids to model choice.

    Filter rows fall back to the trailing ANY rows below the confidence
    ``threshold``; task vectors floor the accuracy column at the
    predicted complexity; the feedback row is gathered at the RAW
    predicted cluster (confidence never enters it).  Returns
    ``route_step_body``'s dict plus ``tt_idx``/``dm_idx``/``cx``/
    ``conf``/``task_vectors``."""
    tt_idx, dm_idx, cx, conf = analyze_heads(encoder, tokens)
    confident = conf >= threshold
    ti = torch.where(confident, tt_idx, n_tt - 1).long()
    di = torch.where(confident, dm_idx, n_dm - 1).long()
    T = W
    if use_complexity:
        T = W.clone()
        T[:, acc_col] = torch.maximum(W[:, acc_col], cx)
    fb = None
    if fb_table is not None:
        cb = torch.clamp((cx * fb_buckets).to(torch.int32), 0,
                         fb_buckets - 1)
        fb = fb_table[((tt_idx * (n_dm - 1) + dm_idx) * fb_buckets
                       + cb).long()]
    out = route_step_body(e2, e2s, masks_table, counts_table, T, W, ti, di,
                          fb, theta, ainv_flat, lpen, rparams, k=k, r=r,
                          n_tt=n_tt, n_dm=n_dm, quant=quant)
    out.update(tt_idx=tt_idx, dm_idx=dm_idx, cx=cx, conf=conf,
               task_vectors=T)
    return out
