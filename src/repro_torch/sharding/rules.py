"""Catalog sharding of the mega-catalog routing step.

The routing part of the JAX package's ``sharding/rules.py``: the name of
the one axis the catalog (N) dimension shards over, and the column
block each shard owns.  Every (.., N) operand of the sharded
``route_step`` splits its catalog axis into equal contiguous blocks, one
per shard; per-query operands, the ladder counts and the scalar params
are replicated.  (The model-sharding rules of the reference come with
several cards, ROADMAP.md Queue 1 item 7: one card trains a whole model
unsharded.)
"""
from __future__ import annotations

from typing import List, Tuple

# the 1-D routing mesh axis the catalog (N) dimension shards over —
# built by ``launch.mesh.make_routing_mesh``
CATALOG_AXIS = "catalog"


def shard_bounds(np_pad: int, n_shards: int) -> List[Tuple[int, int]]:
    """[lo, hi) catalog columns of each shard: equal contiguous blocks
    of a capacity ``np_pad`` that ``n_shards`` divides
    (``ops.n_bucket_sharded``)."""
    if n_shards < 1 or np_pad % n_shards:
        raise ValueError(f"{n_shards} shards do not divide a catalog "
                         f"capacity of {np_pad}")
    n_loc = np_pad // n_shards
    return [(s * n_loc, (s + 1) * n_loc) for s in range(n_shards)]
