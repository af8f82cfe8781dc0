"""The routing mesh of the mega-catalog sharded ``route_step``.

A ``RoutingMesh`` is a tuple of devices, one per catalog shard, and the
axis name.  Shard s owns the s-th equal block of catalog columns and
runs its local scan on ``devices[s]``; the carries meet on
``devices[0]`` for the cross-shard merge.  With more shards than cards
the shards share cards in turn, so ``make_routing_mesh(4)`` on a
one-card machine is four shards on ``cuda:0``, run one after another.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import CATALOG_AXIS


@dataclass(frozen=True)
class RoutingMesh:
    devices: Tuple[torch.device, ...]     # one per shard
    axis: str = CATALOG_AXIS

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
