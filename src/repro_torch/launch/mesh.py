"""Mesh factories: the reference's production and host meshes as
``torch.distributed`` ``DeviceMesh``es, and the routing mesh of the
mega-catalog sharded ``route_step``.

Port of the JAX package's ``launch/mesh.py``; the shapes and axis names
are the reference's:

  single pod:  (16, 16)    axes ("data", "model")        = 256 ranks
  multi-pod:   (2, 16, 16) axes ("pod", "data", "model") = 512 ranks
  host:        (1, 1)      axes ("data", "model")        = 1 rank

A production mesh needs a world of exactly its size (``torchrun``, or a
process group already initialized, e.g. a fake one for the dry run);
otherwise it raises, naming the size.  It never shrinks.  The host mesh
initializes a world-size-1 group itself where none exists (NCCL on the
card, gloo on the CPU, through a ``HashStore``: no environment needed).

A ``RoutingMesh`` is a tuple of devices, one per catalog shard, and the
axis name.  Shard s owns the s-th equal block of catalog columns and
runs its local scan on ``devices[s]``; the carries meet on
``devices[0]`` for the cross-shard merge.  With more shards than cards
the shards share cards in turn, so ``make_routing_mesh(4)`` on a
one-card machine is four shards on ``cuda:0``, run one after another.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import CATALOG_AXIS

PRODUCTION = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))
HOST = ((1, 1), ("data", "model"))


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _device_mesh(dev: torch.device, sizes, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, sizes, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``, over a world of 256 (512)
    ranks: the group already initialized, or the one ``torchrun``'s
    environment describes.  Raises, naming the world size it needs,
    when the world is another size or absent."""
    sizes, names = MULTI_POD if multi_pod else PRODUCTION
    need = 1
    for s in sizes:
        need *= s
    dev = resolve_device(device)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "0")) != need:
            raise RuntimeError(
                f"the production mesh {sizes} needs a world of {need} "
                f"ranks (torchrun --nproc-per-node ... with WORLD_SIZE="
                f"{need}); no process group is initialized")
        dist.init_process_group(_backend(dev))
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"the production mesh {sizes} needs a world of {need} ranks, "
            f"this one has {dist.get_world_size()}")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return _device_mesh(dev, sizes, names)


def make_host_mesh(device=None):
    """The (1, 1) ("data", "model") mesh of one rank; a world-size-1
    group (NCCL on ``cuda``, gloo on ``"cpu"``) is initialized where
    none is."""
    sizes, names = HOST
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the host mesh is one rank, this world has "
                           f"{dist.get_world_size()}")
    return _device_mesh(dev, sizes, names)


@dataclass(frozen=True)
class RoutingMesh:
    devices: Tuple[torch.device, ...]     # one per shard
    axis: str = CATALOG_AXIS

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: number of shards}``, as the reference's mesh."""
        return {self.axis: len(self.devices)}


def make_routing_mesh(n_shards: Optional[int] = None, *,
                      device=None) -> RoutingMesh:
    """1-D mesh for the sharded ``route_step``: the catalog (N) axis of
    every routing operand shards over its single ``"catalog"`` axis.

    ``device=None`` places the shards on the visible cards in turn
    (``n_shards`` defaults to their count); a given ``device`` (e.g.
    ``"cpu"``, as the tests run) holds every shard (``n_shards``
    defaults to 1)."""
    if device is None:
        resolve_device(None)                 # raises without a card
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [resolve_device(device)]
    n = len(cards) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"a routing mesh needs >= 1 shard, got {n}")
    return RoutingMesh(tuple(cards[s % len(cards)] for s in range(n)))
