"""Minimal AdamW on parameter trees (port of the JAX package's
``training/optimizer.py``).

The reference's arithmetic, in its order: linear warmup of the rate,
clipping by the global gradient norm, the moments in f32, bias
correction, and the weight decay inside the update (``delta = mhat /
(sqrt(vhat) + eps) + wd * p``).  ``torch.optim.AdamW`` decays the
weights in a separate step and rounds differently, so it is not used.
Parameters and gradients are trees of dicts and lists with tensor
leaves: the model's nested params, or a flat ``{name: tensor}`` dict.
The moments are the optimizer's own and are updated in place; the
params come back as new tensors, as the reference's.  The update runs
as multi-tensor (``torch._foreach_*``) operations over groups of leaves
of at most ``GROUP`` values -- the reference's operations in its order,
a few launches a group instead of some twenty a leaf (a step of a
~100M model is otherwise launch-bound), and the temporaries of one
group at a time.

DTensor parameters (a sharded train step): each gradient is first laid
out as its parameter (a gradient comes back as partial sums, or sharded
otherwise), the global norm sums every rank's blocks once (a block held
by r ranks counts 1/r on each), summed over the mesh, and the
update, element-wise, runs on each rank's local blocks.  The moments
take the parameters' layouts; ``step`` is a plain count on every rank,
the reference's replicated scalar.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.sharding import place

Tree = Any
GROUP = 1 << 26                         # values a multi-tensor group holds


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a tree, dicts in their order, lists in theirs."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on the matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def init_opt_state(params: Tree) -> Dict:
    """Zero f32 moments beside ``params`` (DTensor parameters: laid out
    as they are) and a step count of 0."""
    def zeros():
        return tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32, memory_format=torch.contiguous_format),
            params)
    return {"mu": zeros(), "nu": zeros(), "step": 0}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each one's f32 sum of squares,
    summed in the tree's order."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _sharded_norm(gs: List[torch.Tensor]) -> torch.Tensor:
    """The global norm of DTensor gradients laid out as their
    parameters: each rank's local sums of squares, a block held by r
    ranks weighted 1/r, summed over the mesh."""
    import torch.distributed as dist
    mesh = gs[0].device_mesh
    total = None
    for g in gs:
        s = torch.sum(torch.square(g.to_local().float()))
        copies = 1
        for i, p in enumerate(g.placements):
            if not p.is_shard():
                copies *= mesh.size(i)
        s = s / copies if copies > 1 else s
        total = s if total is None else total + s
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tree, opt_state: Dict, params: Tree,
                 cfg: AdamWConfig) -> Tuple[Tree, Dict, torch.Tensor]:
    """One AdamW step with linear warmup and gradient clipping.
    Returns (new params, the state -- its moments updated in place --,
    the gradients' global norm, a plain tensor)."""
    step = opt_state["step"] + 1
    f32 = torch.float32
    ps, gs = leaves(params), leaves(grads)
    ms, vs = leaves(opt_state["mu"]), leaves(opt_state["nu"])
    sharded = place.is_dtensor(ps[0])
    if sharded:
        gs = [place.as_dtensor(g, p.device_mesh).redistribute(
            placements=p.placements) for g, p in zip(gs, ps)]
        gnorm = _sharded_norm(gs)
        outer = ps
        ps, gs, ms, vs = ([t.to_local() for t in ts]
                          for ts in (ps, gs, ms, vs))
    else:
        gnorm = global_norm(gs)
    dev = ps[0].device
    stepf = torch.tensor(step, dtype=f32, device=dev)
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    lr = cfg.lr * warm

    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=dev), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=dev), stepf)

    out = []
    for lo, hi in _groups(ps):
        p = [x.float() for x in ps[lo:hi]]
        m, v = ms[lo:hi], vs[lo:hi]
        g = torch._foreach_mul([x.float() for x in gs[lo:hi]], scale)
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.b2),
                                            g))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)),
                              cfg.eps)
        delta = torch._foreach_add(torch._foreach_div(torch._foreach_div(m, bc1), den),
                                torch._foreach_mul(p, cfg.weight_decay))
        new = torch._foreach_sub(p, torch._foreach_mul(delta, lr))
        out += [x.to(q.dtype) for x, q in zip(new, ps[lo:hi])]
    if sharded:
        from torch.distributed.tensor import DTensor
        out = [DTensor.from_local(x, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
               for x, p in zip(out, outer)]
    new = iter(out)
    return tree_map(lambda _: next(new), params), {
        "mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}, gnorm


def _groups(ts):
    """[lo, hi) runs of consecutive leaves holding at most ``GROUP``
    values each (a larger leaf alone)."""
    out, lo, n = [], 0, 0
    for i, t in enumerate(ts):
        if i > lo and n + t.numel() > GROUP:
            out.append((lo, i))
            lo, n = i, 0
        n += t.numel()
    return out + [(lo, len(ts))] if ts else out
