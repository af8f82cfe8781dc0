"""From specs to DTensor placements, and whole trees onto a mesh.

A spec (``sharding.rules.P``) names, for each tensor dim, the mesh axes
it splits over; a DTensor's placements name, for each mesh dim, how the
tensor lies over it.  A spec entry for dim i that names axis a puts
``Shard(i)`` on a's mesh dim; every other mesh dim is ``Replicate()``.
A compound entry ``("pod", "data")`` shards the same tensor dim over
both mesh dims; DTensor splits in mesh-dim order, so pod is major, as
in the reference's ``NamedSharding``.

``shard_tree`` lays a tree of tensors out by a spec tree
(``distribute_tensor``: rank 0's values are scattered); ``gather_tree``
gives back the full tensors.  On ``meta`` tensors under a fake process
group ``shard_tree`` gives DTensors whose local shards carry the shapes
a rank would hold, without data (``launch/dryrun``).
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, List

import torch

from repro_torch.sharding.rules import P, axis_names, axis_size


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor: none can
    exist before its module is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def placements(spec: P, mesh, partial=()) -> List:
    """The DTensor placements of ``spec`` on ``mesh`` (a
    ``DeviceMesh``); the axes in ``partial`` that do not shard the
    tensor hold partial sums (``Partial()``) instead of copies."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(dim)
    for a in partial:
        i = names.index(a)
        if isinstance(out[i], Replicate):
            out[i] = Partial()
    return out


def fit(mesh, n: int, axis):
    """``axis`` where it divides ``n``, else None: the runtime layouts'
    choice (not counted as a silent replication: a spec of the rules
    is what the count audits)."""
    if axis is None or n % axis_size(mesh, axis):
        return None
    return axis


def axis_of(t, dim: int):
    """The mesh axis (or tuple of axes, in mesh-dim order) that splits
    dim ``dim`` of a DTensor, or None: the entry of its spec."""
    from torch.distributed.tensor import Shard
    names = t.device_mesh.mesh_dim_names
    axes = tuple(names[i] for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim % t.ndim == dim % t.ndim)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def block_index(mesh, entry) -> int:
    """Which block of a dim split over ``entry`` (a name or a tuple of
    names) this rank holds: its coordinates on those axes folded in
    order, the first axis major -- DTensor's order, and the reference's
    for ``("pod", "data")``."""
    if entry is None:
        return 0
    idx = 0
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def split_axes(*entries) -> tuple:
    """The mesh axes named by spec entries (None, a name or a tuple)."""
    out = []
    for e in entries:
        if e is not None:
            out += list(e) if isinstance(e, tuple) else [e]
    return tuple(out)


def run_local(fn, mesh, args, in_specs, out_placements, split=()):
    """``fn`` on each rank's local blocks of ``args`` (``local_map``).

    ``in_specs``: one spec per argument (None for a non-tensor): a
    DTensor argument is redistributed to it first, and a plain tensor
    argument is taken as the same value on every rank.  ``split``: the
    mesh axes over which the ranks compute different parts; the
    gradient of an argument replicated over such an axis is a partial
    sum there.  ``out_placements``: one placements list per output.
    Gradients flow through: ``fn``'s backward runs on the local blocks
    too."""
    from torch.distributed.tensor.experimental import local_map
    specs, grads, wrapped = [], [], []
    for a, s in zip(args, in_specs):
        if not isinstance(a, torch.Tensor):
            s = None
        else:
            a = as_dtensor(a, mesh)
        wrapped.append(a)
        specs.append(None if s is None else tuple(placements(s, mesh)))
        grads.append(None if s is None
                     else tuple(placements(s, mesh, partial=split)))
    return local_map(fn, out_placements=tuple(tuple(p) for p in out_placements),
                     in_placements=tuple(specs),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*wrapped)


def shardable(x, dim: int, n: int):
    """``x`` (a DTensor) redistributed so that tensor dim ``dim`` is
    split only over mesh axes whose sizes multiply to a divisor of
    ``n`` (e.g. the heads a feature dim is reshaped into); the other
    mesh axes that split it are replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    d = dim % x.ndim
    out, size = list(x.placements), 1
    for i, p in enumerate(out):
        if isinstance(p, Shard) and p.dim % x.ndim == d:
            if n % (size * mesh.size(i)):
                out[i] = Replicate()
            else:
                size *= mesh.size(i)
    return x if tuple(out) == tuple(x.placements) else \
        x.redistribute(placements=out)


def constrain(x, spec: P):
    """A DTensor laid out as ``spec`` (a plain tensor: unchanged)."""
    if not is_dtensor(x):
        return x
    return x.redistribute(placements=placements(spec, x.device_mesh))


def spmd(*trees):
    """The context a computation over DTensors runs in: plain tensors
    it makes (positions, masks, index ranges -- the same on every rank)
    count as replicated (``implicit_replication``).  A no-op where no
    leaf of ``trees`` is a DTensor, and inside another ``spmd`` (the
    flag it sets is not nested: the inner exit would clear it)."""
    def any_dt(node):
        if isinstance(node, dict):
            return any(any_dt(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return any(any_dt(v) for v in node)
        return is_dtensor(node)
    if _SPMD["depth"] or not any(any_dt(t) for t in trees):
        return contextlib.nullcontext()
    return _implicit()


_SPMD = {"depth": 0}


@contextlib.contextmanager
def _implicit():
    from torch.distributed.tensor.experimental import implicit_replication
    _SPMD["depth"] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _SPMD["depth"] -= 1


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return [_map(fn, v, specs[i]) for i, v in enumerate(tree)]
    return fn(tree, specs)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """The tensors of ``tree`` as DTensors laid out by ``specs`` (a
    tree of ``P`` of the same structure) on ``mesh``.  Non-tensor
    leaves pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, placements(spec, mesh))
    return _map(one, tree, specs)


def zeros_tree(shapes: Any, specs: Any, mesh) -> Any:
    """Zero DTensors of the shapes and dtypes of ``shapes`` (e.g.
    ``meta`` tensors) laid out by ``specs`` on ``mesh``: each rank
    allocates its block only."""
    from torch.distributed.tensor import zeros

    def one(t, spec):
        return zeros(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
                     placements=placements(spec, mesh))
    return _map(one, shapes, specs)


def as_dtensor(t, mesh):
    """``t`` itself if a DTensor, else the same value on every rank of
    ``mesh`` (replicated)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gather_tree(tree: Any) -> Any:
    """The full tensors of a tree of DTensors (plain leaves pass
    through)."""
    from torch.distributed.tensor import DTensor

    def one(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return one(node)
    return walk(tree)
