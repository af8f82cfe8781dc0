"""Minimal AdamW on tensor dicts (port of the JAX package's
``training/optimizer.py``).

The reference's arithmetic, in its order: linear warmup of the rate,
clipping by the global gradient norm, the moments in f32, bias
correction, and the weight decay inside the update (``delta = mhat /
(sqrt(vhat) + eps) + wd * p``).  ``torch.optim.AdamW`` decays the
weights in a separate step and rounds differently, so it is not used.
Parameters and gradients are flat ``{name: tensor}`` dicts.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params: Tensors) -> Dict:
    """Zero f32 moments beside ``params`` and a step count of 0."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in params.items()}
    return {"mu": zeros(), "nu": zeros(), "step": 0}


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's f32 sum of squares,
    summed in the dict's order."""
    total = None
    for x in tensors.values():
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tensors, opt_state: Dict, params: Tensors,
                 cfg: AdamWConfig) -> Tuple[Tensors, Dict, torch.Tensor]:
    """One AdamW step with linear warmup and gradient clipping.
    Returns (new params, new state, the gradients' global norm)."""
    step = opt_state["step"] + 1
    f32 = torch.float32
    dev = next(iter(params.values())).device
    stepf = torch.tensor(step, dtype=f32, device=dev)
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    lr = cfg.lr * warm

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    grads = {k: g.float() * scale for k, g in grads.items()}

    mu = {k: cfg.b1 * opt_state["mu"][k] + (1 - cfg.b1) * g
          for k, g in grads.items()}
    nu = {k: cfg.b2 * opt_state["nu"][k] + (1 - cfg.b2) * g * g
          for k, g in grads.items()}
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=dev), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=dev), stepf)

    new = {}
    for k, p in params.items():
        mhat = mu[k] / bc1
        vhat = nu[k] / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        new[k] = (p.float() - lr * delta).to(p.dtype)
    return new, {"mu": mu, "nu": nu, "step": step}, gnorm
