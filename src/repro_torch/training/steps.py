"""Step factories: the training step, the prefill step and the greedy
decode (serve) step.

Port of the JAX package's ``training/steps.py``.  PyTorch runs eagerly,
so these are the functions the launchers and the runner call, not
programs to compile.  The training step differentiates ``M.loss_fn``
with autograd: on the card the attention, the SSD scan and the MoE
gate go forward and backward through their hand-written kernels
(``kernels/ops``), then AdamW updates the f32 master params.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            leaves, tree_map)


def loss_and_grads(params, cfg: ModelConfig, batch):
    """(total, loss, aux, grads): ``M.loss_fn`` and its gradients with
    respect to every float leaf of ``params`` (a tree of the params'
    structure; the compute-dtype cast happens inside the loss, so f32
    master params receive f32 gradients)."""
    def track(t):
        return t.detach().requires_grad_(True) if t.is_floating_point() \
            else t
    live = tree_map(track, params)
    total, (loss, aux) = M.loss_fn(live, cfg, batch)
    flat = [t for t in leaves(live) if t.requires_grad]
    # a leaf the config leaves unused (mamba2's ln_mlp) gets zeros, as
    # jax.grad gives it
    grads = iter(torch.autograd.grad(total, flat, allow_unused=True))

    def grad_of(t):
        g = next(grads) if t.requires_grad else None
        return torch.zeros_like(t) if g is None else g
    grads = tree_map(grad_of, live)
    return total.detach(), loss.detach(), torch.as_tensor(aux).detach(), \
        grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig()):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "aux", "total", "gnorm"})``, the reference's: the loss's
    gradients, then one AdamW step.  ``batch`` holds ``tokens`` and
    ``labels`` (B, L) and the family's ``src_embeds`` / ``frontend``,
    all tensors on the params' device."""
    def train_step(params, opt_state, batch):
        total, loss, aux, grads = loss_and_grads(params, cfg, batch)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "aux": aux,
                                   "total": total, "gnorm": gnorm}
    return train_step


def make_prefill_step(cfg: ModelConfig, *, long_mode: bool = False,
                      max_len: int = 0):
    """The prefill of ``batch``: its tokens and, where the family takes
    them, its ``src_embeds`` (encoder-decoder) or ``frontend`` (vision
    prefix), passed through to ``M.prefill``.  The reference's
    ``long_mode`` raises ``not_ported``."""
    L.check_supported(cfg, long_mode)

    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, long_mode: bool = False):
    """One greedy decode step; the reference's ``long_mode`` raises
    ``not_ported``."""
    L.check_supported(cfg, long_mode)

    def serve_step(params, cache, batch):
        logits, cache = M.decode_step(params, cfg, cache, batch)
        # greedy next token
        next_tok = torch.argmax(logits, dim=-1)[:, None]
        return logits, next_tok, cache
    return serve_step
