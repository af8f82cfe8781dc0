"""Step factories: the training step, the prefill step and the greedy
decode (serve) step.

Port of the JAX package's ``training/steps.py``.  PyTorch runs eagerly,
so these are the functions the launchers and the runner call, not
programs to compile.  The training step differentiates ``M.loss_fn``
with autograd: on the card the attention, the SSD scan and the MoE
gate go forward and backward through their hand-written kernels
(``kernels/ops``), then AdamW updates the f32 master params.

Each step also takes DTensor parameters (``sharding/rules.param_specs``
laid out by ``sharding/place.shard_tree``), batches laid out by
``batch_spec`` / ``decode_batch_spec`` and a decode cache by
``cache_specs`` -- batch-sharded, or at batch 1 split by length over
the data axes, which the decode reads in place (``ops.flash_decode``:
per-rank (o, lse) partials merged across ranks): the counterpart of the
reference's ``jit(in_shardings=...)``.  The kernels then run on each
rank's local blocks, and the train step's metrics come back as plain
tensors, the same on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.sharding import place
from repro_torch.sharding.rules import P, axis_size
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
    with place.spmd(params, batch):          # the backward too
        total, (loss, aux) = M.loss_fn(live, cfg, batch)
        flat = [t for t in leaves(live) if t.requires_grad]
        # a leaf the config leaves unused (mamba2's ln_mlp) gets zeros,
        # as jax.grad gives it
        grads = iter(torch.autograd.grad(total, flat, allow_unused=True))

    def grad_of(t):
        g = next(grads) if t.requires_grad else None
        return torch.zeros_like(t) if g is None else g
    grads = tree_map(grad_of, live)
    return _whole(total), _whole(loss), _whole(torch.as_tensor(aux)), grads


def _whole(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    t = t.detach()
    return t.full_tensor() if place.is_dtensor(t) else t


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
    prefix), passed through to ``M.prefill`` with ``long_mode`` and
    ``max_len``."""
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, long_mode=long_mode,
                         max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, long_mode: bool = False):
    """One greedy decode step (``long_mode`` passed to
    ``M.decode_step``; the next token by ``greedy``)."""
    def serve_step(params, cache, batch):
        logits, cache = M.decode_step(params, cfg, cache, batch,
                                      long_mode=long_mode)
        return logits, greedy(logits), cache
    return serve_step


def greedy(logits):
    """The greedy next token (B, 1) of logits (B, V): the first index of
    each row's max, as ``torch.argmax``.  DTensor logits split by vocab
    (``model``): each rank takes the first max of its block, the
    blocks' (value, index) pairs are gathered, and the first block
    holding the row's max wins -- B floats and ints a rank, where
    DTensor's own argmax would gather the logits."""
    if not place.is_dtensor(logits):
        return torch.argmax(logits, dim=-1)[:, None]
    mesh = logits.device_mesh
    b, v = place.axis_of(logits, 0), place.axis_of(logits, 1)
    lo = place.block_index(mesh, v) * (logits.shape[1] // axis_size(mesh, v))

    def local(x):
        i = torch.argmax(x, dim=1)
        return x.gather(1, i[:, None])[:, 0][None], (i + lo)[None]

    def pick(val, idx):
        return idx.gather(0, torch.argmax(val, dim=0)[None])[0][:, None]
    val, idx = place.run_local(local, mesh, (logits,), (P(b, v),),
                               (place.placements(P(v, b), mesh),) * 2)
    val, idx = place.constrain(val, P(None, b)), place.constrain(idx,
                                                                 P(None, b))
    return place.run_local(pick, mesh, (val, idx), (P(None, b),) * 2,
                           (place.placements(P(b, None), mesh),))
