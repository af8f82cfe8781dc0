"""Sharding rules: parameter, batch and cache specs per architecture, and
the catalog sharding of the mega-catalog routing step.

Port of the JAX package's ``sharding/rules.py``, under its names.
Baseline layout ("2D"):

  * weight matrices shard their input-feature (d_model) dim over
    'data' (FSDP-style) and their output-feature dim over 'model'
    (tensor parallel); out-projections are the transpose;
  * the embedding shards its vocab over 'model' only;
  * MoE expert stacks shard experts over 'model' and f over 'data';
  * a dim is only sharded if its size is divisible by the mesh axis --
    otherwise it silently stays replicated (``maybe``, counted);
  * batch shards over ('pod', 'data'); for batch=1 long-context decode
    the cache length axis shards over ('pod', 'data') and the heads
    over 'model'.

A spec is a ``P``: a tuple with one entry per tensor dim, each None
(replicated), an axis name, or a tuple of axis names (the dim split
over those mesh axes, the first major).  A "mesh" is anything with
``axis_names`` and a ``shape`` mapping each axis to its size -- the
device-free ``AbstractMesh`` here, or a ``torch.distributed``
``DeviceMesh`` (its ``mesh_dim_names`` and sizes), so specs for 512
ranks are built without any process (``launch/dryrun``).

The parameter trees differ from the reference's in one way: the
per-layer parameters are lists under ``"layers"`` / ``"enc_layers"``
(``models/model.py``), where the reference stacks them along a leading
axis.  Every layer of a list takes the reference's spec of the stack
without its leading None; the spec is formed once per stacked leaf, so
the silent-replication count is the reference's.  The decode cache keeps
the reference's stacked layout, and so its specs.

The catalog part: the name of the one axis the catalog (N) dimension of
the sharded ``route_step`` splits over, and the column block each shard
owns.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Tuple


class P(tuple):
    """A partition spec: one entry per leading tensor dim (missing
    trailing entries are replicated), each None, an axis name or a
    tuple of axis names (a tuple of one name is that name, as in the
    reference's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class AbstractMesh(NamedTuple):
    """A device-free mesh: axis names and ``shape`` {axis: size}."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def abstract_mesh(sizes, names) -> AbstractMesh:
    """``AbstractMesh`` of ``sizes`` over ``names`` (e.g. ``(16, 16),
    ("data", "model")``)."""
    names = tuple(names)
    return AbstractMesh(names, dict(zip(names, (int(s) for s in sizes))))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis: size} of a mesh: an ``AbstractMesh`` (or anything with a
    ``shape`` mapping) or a ``DeviceMesh``."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_axes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return int(sizes[axis])


def data_axes(mesh):
    """The (possibly compound) batch-parallel axis."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# silent-replication audit: ``maybe`` falling back to None is usually
# intentional (1-D norms, odd vocab tails) but can silently hide a
# mis-sized mesh axis that replicates a tensor meant to be sharded.
# Every fallback bumps this counter; ``launch/dryrun`` snapshots it
# around spec construction, warns, and records it into Telemetry.
_SILENT_REPLICATIONS = {"count": 0}


def silent_replication_count() -> int:
    """Total ``maybe`` calls that silently replicated so far."""
    return _SILENT_REPLICATIONS["count"]


def reset_silent_replication_count() -> None:
    _SILENT_REPLICATIONS["count"] = 0


def maybe(mesh, dim: int, axis):
    """axis if dim divides evenly over it, else None (replicate).

    The replicate fallback is counted in ``silent_replication_count()``
    so dry runs can surface layouts that quietly lost their sharding to
    a non-dividing dim."""
    if dim % axis_size(mesh, axis) == 0:
        return axis
    _SILENT_REPLICATIONS["count"] += 1
    return None


# ----------------------------------------------------------------------
# routing-catalog specs (mega-catalog route_step)
# ----------------------------------------------------------------------

# the 1-D routing mesh axis the catalog (N) dimension shards over --
# built by ``launch.mesh.make_routing_mesh``
CATALOG_AXIS = "catalog"


def route_step_specs(mesh) -> Dict[str, P]:
    """Specs for the sharded fused route step's operands.

    Every (.., N) operand splits its catalog axis over
    ``CATALOG_AXIS``; per-query operands (T/W/ti/di), the ladder
    counts table and the scalar params are replicated -- the batch is
    small next to the catalog, and replicating it makes the per-shard
    scan embarrassingly parallel with one cross-shard top-k merge as
    the only exchange (``kernels/route_step.py``)."""
    assert CATALOG_AXIS in axis_names(mesh), axis_names(mesh)
    c = CATALOG_AXIS
    return {
        "e2": P(c, None),               # catalog block rows
        "e2s": P(c, None),              # int8 per-row scales
        "masks_table": P(None, c),      # mask rows x catalog cols
        "counts_table": P(),            # ladder counts: replicated
        "fb": P(None, c),               # feedback bias (B, N)
        "theta": P(c, None),            # bandit posterior rows
        "ainv_flat": P(c, None),
        "lpen": P(c),                   # load penalty (N,)
        "query": P(),                   # T/W/ti/di: replicated
        "params": P(),
    }


def shard_bounds(np_pad: int, n_shards: int) -> List[Tuple[int, int]]:
    """[lo, hi) catalog columns of each shard: equal contiguous blocks
    of a capacity ``np_pad`` that ``n_shards`` divides
    (``ops.n_bucket_sharded``)."""
    if n_shards < 1 or np_pad % n_shards:
        raise ValueError(f"{n_shards} shards do not divide a catalog "
                         f"capacity of {np_pad}")
    n_loc = np_pad // n_shards
    return [(s * n_loc, (s + 1) * n_loc) for s in range(n_shards)]


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------

STACKED = ("layers", "enc_layers")


def _map_with_path(fn, node, path=()):
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(node)]
    return fn(path, node)


# ----------------------------------------------------------------------
# parameter specs
# ----------------------------------------------------------------------

def param_specs(cfg, mesh, params_shape) -> Dict[str, Any]:
    """Spec tree matching the params tree (tensors, ``meta`` included,
    or anything with a ``shape``).  Each per-layer list takes the spec
    of its first layer (every layer of a stack has its shapes)."""
    da = data_axes(mesh)

    def spec_for(path, leaf) -> P:
        names = [k for k in path if isinstance(k, str)]
        dims = list(leaf.shape)

        def two_d(rows_axis, cols_axis):
            return P(maybe(mesh, dims[0], rows_axis),
                     maybe(mesh, dims[1], cols_axis))

        leafname = names[-1]
        if leafname == "embed":
            # vocab over 'model' ONLY: with d replicated, the tied LM
            # head (x @ embed.T) has no sharded contraction, so logits
            # are born vocab-sharded instead of all-reduced
            if cfg.embed_shard_d:                # naive FSDP baseline
                return P(maybe(mesh, dims[0], "model"),
                         maybe(mesh, dims[1], da))
            return P(maybe(mesh, dims[0], "model"), None)
        if len(dims) == 3 and leafname in ("wi", "wg", "wo") and "moe" in names:
            # expert-parallel over 'model'; the second shard axis is f
            # (not d): the in-projections have no sharded contraction,
            # and the one partial sum is the layer output's
            e_ax = maybe(mesh, dims[0], "model")
            if cfg.moe_shard_axis == "d":        # naive FSDP baseline
                return P(e_ax, maybe(mesh, dims[1], da), None)
            if leafname == "wo":                 # (E, f, d): f is dims[1]
                return P(e_ax, maybe(mesh, dims[1], da), None)
            return P(e_ax, None, maybe(mesh, dims[2], da))
        if len(dims) == 2:
            if leafname in ("wo", "out_proj"):      # (f|qd|di, d): row-parallel
                return two_d("model", da)
            if leafname in ("wq", "wk", "wv", "wi", "wg", "router",
                            "in_proj", "w"):
                return two_d(da, "model")
            if leafname == "conv_w":
                return P(None, maybe(mesh, dims[1], "model"))
            return P(*([None] * len(dims)))
        # 1-D (norms, biases, A_log, ...) and scalars: replicate
        return P(*([None] * len(dims)))

    out = {}
    for k, v in params_shape.items():
        if k in STACKED:
            first = _map_with_path(spec_for, v[0], (k, 0))
            out[k] = [first] * len(v)
        else:
            out[k] = _map_with_path(spec_for, v, (k,))
    return out


# ----------------------------------------------------------------------
# activation / cache specs
# ----------------------------------------------------------------------

def batch_spec(cfg, mesh, batch_shape) -> Dict[str, Any]:
    """Specs for a train/prefill input batch dict."""
    da = data_axes(mesh)

    def spec_for(path, leaf):
        ax = maybe(mesh, leaf.shape[0], da)
        return P(ax, *([None] * (len(leaf.shape) - 1)))

    return _map_with_path(spec_for, batch_shape)


def cache_specs(cfg, mesh, cache_shape) -> Dict[str, Any]:
    """Specs for the decode cache (leading n_layers dim).

    If batch divides the data axes, shard batch; otherwise (batch=1
    long-context) shard the length/state axes instead."""
    da = data_axes(mesh)

    def spec_for(path, leaf):
        name = path[-1]
        shape = leaf.shape          # (nL, B, ...)
        b_ax = maybe(mesh, shape[1], da)
        if name in ("k", "v", "cross_k", "cross_v", "k_scale", "v_scale"):
            C, H = shape[2], shape[3]
            if b_ax is not None:
                return P(None, b_ax, maybe(mesh, C, "model"), None, None)
            # batch=1: context-shard the cache over data axes, heads over model
            return P(None, None, maybe(mesh, C, da), maybe(mesh, H, "model"),
                     None)
        if name == "ssd":           # (nL, B, H, P, N)
            H = shape[2]
            if b_ax is not None:
                return P(None, b_ax, maybe(mesh, H, "model"), None, None)
            return P(None, None, maybe(mesh, H, "model"), None, None)
        if name == "conv":          # (nL, B, K-1, conv_dim)
            return P(None, b_ax, None, maybe(mesh, shape[3], "model"))
        return P(*([None] * len(shape)))

    return _map_with_path(spec_for, cache_shape)


def decode_batch_spec(cfg, mesh, batch_shape) -> Dict[str, Any]:
    """Specs for a decode batch dict ({"token", "pos"})."""
    return batch_spec(cfg, mesh, batch_shape)
