"""Public wrappers of the serving-path programs and kernels.

Port of the JAX package's ``kernels/ops.py``.  Each op pads the query
axis to its power-of-two bucket and the catalog to its 128-aligned
capacity (``q_bucket`` /
``n_bucket``: eager PyTorch compiles nothing, but the padded shapes are
the ones a captured CUDA graph per bucket will need), runs one program
on ``device``, and hands host numpy arrays back sliced to the batch.

``route_step``, ``analyze_step`` and ``analyze_route_step`` take the
observability sinks of the reference's ops: ``telemetry`` (a
``core.telemetry.Telemetry``) receives one dispatch per call and 0
compiles (eager PyTorch compiles nothing; a captured CUDA graph per
bucket will count as one), and ``tracer`` (an ``obs.Tracer``) wraps
the launch and the host copy of its outputs in one span.  With
neither attached the path and its launches are unchanged.  The same
three ops hand every dispatch to the module-level hooks
``set_cost_profiler`` (``obs.profile.DeviceCostProfiler``: per-bucket
FLOPs and bytes) and ``set_recompile_hook`` (one event per dispatch),
as the reference's do; detached (``None``) they cost nothing.

Every op takes ``device=None`` (= ``"cuda"``; raises without a card).
On the card the route-step kNN, the staged path's kNN (``knn_rows``),
the cache lookup and the bandit update always launch their
hand-written kernels; ``device="cpu"`` runs their
plain PyTorch versions.  ``route_step`` also serves the mega-catalog
programs: ``mesh=`` (a ``launch.mesh.RoutingMesh``: the catalog split
into column blocks, one ``router_topk`` launch per shard) and ``ivf=``
(the IVF-pruned search over a cell-packed catalog).  The model-zoo ops
at the end (``flash_attention``, ``flash_decode``, ``ssd_scan``,
``moe_gating``) take tensors and run
where those tensors live: on the card their kernels, on the CPU the
plain versions; ``flash_decode`` given an int8 cache's scales reads
the int8 K/V through ``flash_attention.flash_decode_q8``.  On DTensor
operands the model-zoo ops run their kernels on each rank's local
blocks; a decode cache split by length (``cache_specs``' batch-1
layout) is read in place, each rank's (o, lse) partial then merged
across ranks by ``flash_attention.decode_merge`` (``_decode_by_length``).
Where autograd records (grad enabled and an operand requiring a
gradient),
``flash_attention`` (prefill shapes), ``ssd_scan`` and ``moe_gating``
run as ``torch.autograd.Function``s whose backward is the kernel's
backward (``flash_attention_bwd``, ``ssd_scan_bwd``, ``moe_gating_bwd``:
hand-written kernels on the card, their plain versions on the CPU);
otherwise (the served path, under ``torch.no_grad()``) they launch
exactly the forward kernel, saving nothing.  The decode shapes take no
gradient and raise if asked for one.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.sanitize import make_lock
from repro_torch.device import resolve_device
from repro_torch.obs import profile as _cost
from repro_torch.obs.trace import NOOP_SPAN
from repro_torch.kernels.analyze_step import (AnalyzerEncoder,
                                              analyze_route_step_body,
                                              analyze_step_body)
from repro_torch.kernels.bandit_update import bandit_update as _bandit_kernel
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_kernel
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd as _flash_bwd_kernel
from repro_torch.kernels.flash_attention import decode_merge as _merge_kernel
from repro_torch.kernels.flash_attention import \
    flash_decode_q8 as _flash_q8_kernel
from repro_torch.kernels.moe_gating import moe_gating as _gate_kernel
from repro_torch.kernels.moe_gating import \
    moe_gating_bwd as _gate_bwd_kernel
from repro_torch.kernels.route_step import (CatalogShard, quantize_rows,
                                            route_step_body,
                                            route_step_ivf_body,
                                            route_step_sharded_body,
                                            unit_rows)
from repro_torch.kernels.router_topk import (router_topk as _topk_kernel,
                                             router_topk_q8 as _topk_q8_kernel)
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_bwd as _ssd_bwd_kernel
from repro_torch.sharding import place as _place
from repro_torch.sharding.rules import (CATALOG_AXIS, P, axis_size, data_axes,
                                        shard_bounds)

LANE = 128


def q_bucket(q: int) -> int:
    """Power-of-two query-axis bucket (floor 8)."""
    return max(8, 1 << max(q - 1, 1).bit_length())


def n_bucket(n: int) -> int:
    """128-aligned catalog-axis capacity (floor 128)."""
    return max(128, -(-n // LANE) * LANE)


def n_bucket_sharded(n: int, ndev: int) -> int:
    """Catalog capacity of the sharded path: every shard gets an equal
    128-aligned block, so the bucket is the next multiple of
    ``ndev * 128``."""
    step = ndev * LANE
    return max(step, -(-n // step) * step)


# dispatch counters of the bucketed serving-path ops (one count per
# program run; eager PyTorch has no compiles to count)
_STATS = {"route_step_dispatches": 0, "topk_dispatches": 0,
          "analyze_step_dispatches": 0}
_STATS_LOCK = make_lock("ops.stats")


def route_step_stats() -> dict:
    """Copy of the dispatch counters."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_route_step_stats() -> None:
    with _STATS_LOCK:
        for key in _STATS:
            _STATS[key] = 0


def _bump(kind: str) -> None:
    with _STATS_LOCK:
        _STATS[f"{kind}_dispatches"] += 1


# optional per-bucket cost profiler (obs.profile.DeviceCostProfiler):
# when attached, every dispatch hands it its shape bucket and the cost
# formula bound to the bucket's padded shapes, which it evaluates once
# per NEW bucket; zero cost on the hot path when detached
_COST_PROFILER = None


def set_cost_profiler(profiler) -> None:
    """Attach (or detach with ``None``) a per-bucket cost profiler."""
    global _COST_PROFILER
    _COST_PROFILER = profiler


# optional recompile hook: when attached, every dispatch reports its
# shape-bucket signature and its compile count.  Same shape as the
# cost-profiler hook: module global, None when detached, zero hot-path
# cost.  Eager PyTorch compiles nothing, so ``compiles`` is 0; a
# captured CUDA graph per bucket would count its captures here.
_RECOMPILE_HOOK = None


def set_recompile_hook(hook) -> None:
    """Attach (or detach with ``None``) a per-dispatch recompile hook.

    The hook is called as ``hook(event)`` with ``event = {"path",
    "q_bucket", "n_bucket", "quant", "shards", "compiles"}`` after
    every ``route_step`` dispatch, and likewise after every
    ``analyze_step`` dispatch (``path="analyze"``, ``n_bucket`` = the
    token axis, ``quant`` = analyzer int8) and every fused
    ``analyze_route_step`` dispatch (``path="fused"``, ``quant`` =
    ``(catalog_int8, analyzer_int8)`` -- both axes change the program,
    so both belong to the shape-bucket signature)."""
    global _RECOMPILE_HOOK
    _RECOMPILE_HOOK = hook


def _observe(bucket, fn, call) -> None:
    """Hand one dispatch to the attached profiler and hook: ``bucket``
    is ``(path, q_bucket, n_bucket, quant, shards)``, ``call`` the cost
    formula ``fn`` bound to its padded shapes."""
    prof = _COST_PROFILER
    if prof is not None:
        prof.capture(bucket, fn, call)
    hook = _RECOMPILE_HOOK
    if hook is not None:
        path, qp, n_pad, quant, shards = bucket
        hook({"path": path, "q_bucket": qp, "n_bucket": n_pad,
              "quant": quant, "shards": shards, "compiles": 0})


def _head_widths(encoder: AnalyzerEncoder) -> Tuple[int, int]:
    """The analyzer's task-type and domain head widths."""
    def width(name):
        t = getattr(encoder, name, None)
        return int((t if t is not None else
                    getattr(encoder, name + "_q")).shape[1])
    return width("head_tt"), width("head_dm")


# device copies of the per-catalog constants, keyed on the source
# array's identity and held by WEAK reference: when the catalog grows,
# MRES rebuilds its embedding matrix, the old one dies, and its stale
# packs are evicted on the next lookup (and a recycled id() can never
# match, since the referent is gone before the id can repeat)
_CATALOG_CACHE: list = []               # [(key, weakref(src), packed)]
_CATALOG_CACHE_MAX = 4


def catalog_cache_info() -> dict:
    """Live entries of the device-constant cache (tests)."""
    with _STATS_LOCK:
        live = [k2 for (k2, wr, _) in _CATALOG_CACHE if wr() is not None]
    return {"entries": len(live), "keys": live}


def reset_catalog_cache() -> None:
    with _STATS_LOCK:
        _CATALOG_CACHE.clear()


def _cache_lookup(key):
    with _STATS_LOCK:
        _CATALOG_CACHE[:] = [e for e in _CATALOG_CACHE if e[1]() is not None]
        for k2, _, packed in _CATALOG_CACHE:
            if k2 == key:
                return packed
    return None


def _cache_put(key, src, packed):
    with _STATS_LOCK:
        _CATALOG_CACHE.append((key, weakref.ref(src), packed))
        while len(_CATALOG_CACHE) > _CATALOG_CACHE_MAX:
            _CATALOG_CACHE.pop(0)


def _quantize_rows_np(x: np.ndarray):
    """numpy twin of ``route_step.quantize_rows`` (per-row symmetric
    int8, round half to even): q int8, s (rows, 1) f32."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=1, keepdims=True)
    s = np.where(amax > 0, amax / np.float32(127.0),
                 np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(x / s), -127, 127).astype(np.int8)
    return q, s


def _mask_table(tt, dm, gmask, n: int, np_pad: int) -> np.ndarray:
    """The stacked filter table at width ``np_pad``: task-type x domain
    combinations, task-type-only rows, the generalist row, the
    live-catalog row.  Padded columns are False in every row."""
    pad = np_pad - n
    ttp = np.pad(np.asarray(tt, bool), ((0, 0), (0, pad)))
    dmp = np.pad(np.asarray(dm, bool), ((0, 0), (0, pad)))
    combo = (ttp[:, None, :] & dmp[None, :, :]).reshape(-1, np_pad)
    live = np.zeros(np_pad, bool)
    live[:n] = True
    return np.vstack([combo, ttp,
                      np.pad(np.asarray(gmask, bool), (0, pad))[None],
                      live[None]])


def _catalog_blocks(emb: np.ndarray, np_pad: int, quant: bool):
    """(e2, e2s): ``[embn | emb]`` f32 rows, or the int8 row-quantized
    pair with its (Np, 2) scales when ``quant`` ((1, 2) dummy else)."""
    n = emb.shape[0]
    pad = np_pad - n
    embf = emb.astype(np.float32)
    embn = embf / (np.linalg.norm(embf, axis=1, keepdims=True) + 1e-9)
    if not quant:
        e2 = np.pad(np.concatenate([embn, embf], axis=1), ((0, pad), (0, 0)))
        return e2, np.zeros((1, 2), np.float32)
    q8n, sn = _quantize_rows_np(embn)
    q8e, se = _quantize_rows_np(embf)
    e2 = np.pad(np.concatenate([q8n, q8e], axis=1), ((0, pad), (0, 0)))
    e2s = np.pad(np.concatenate([sn, se], axis=1), ((0, pad), (0, 0)))
    return e2, e2s


def _catalog_pack(emb: np.ndarray, tt, dm, gmask, np_pad: int, *,
                  quant: bool, device: torch.device):
    """Device constants of ``route_step``: (e2, e2s, masks_table uint8,
    counts_table int32), cached per catalog snapshot."""
    key = (id(emb), np_pad, bool(quant), str(device))
    packed = _cache_lookup(key)
    if packed is not None:
        return packed
    n = emb.shape[0]
    table = _mask_table(tt, dm, gmask, n, np_pad)
    e2, e2s = _catalog_blocks(emb, np_pad, quant)
    counts = table.sum(axis=1).astype(np.int32)
    packed = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in (e2, e2s, table.astype(np.uint8), counts))
    _cache_put(key, emb, packed)
    return packed


def _catalog_pack_ivf(emb: np.ndarray, tt, dm, gmask, cent: np.ndarray,
                      cell_of: np.ndarray, *, quant: bool,
                      device: torch.device):
    """Cell-packed device constants of the IVF program: (e2, e2s,
    masks_table uint8, counts_table, orig int64, cent, cap), cached per
    (catalog snapshot, index).

    The catalog is permuted into contiguous equal-capacity cells
    (``cap`` = the largest cell rounded up to 8 slots; dead slots carry
    ``orig == -1``, zero rows and all-False mask columns), so "scan the
    top-nprobe cells" is ONE gather of ``nprobe * cap`` slots.  The
    counts table keeps the TRUE full-catalog populations."""
    C = cent.shape[0]
    key = (id(emb), "ivf", id(cent), C, bool(quant), str(device))
    packed = _cache_lookup(key)
    if packed is not None:
        return packed
    n = emb.shape[0]
    cell_of = np.asarray(cell_of, np.int64)
    sizes = np.bincount(cell_of, minlength=C)
    # lint: ignore[torch-host-sync] -- numpy counts on the host, no tensor
    cap = max(8, int(-(-int(sizes.max()) // 8) * 8))
    order = np.argsort(cell_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pos_in_cell = np.arange(n) - starts[cell_of[order]]
    orig = np.full(C * cap, -1, np.int64)
    orig[cell_of[order] * cap + pos_in_cell] = order
    valid = orig >= 0
    osafe = np.where(valid, orig, 0)
    table = _mask_table(tt, dm, gmask, n, n)
    counts = table.sum(axis=1).astype(np.int32)
    e2, e2s = _catalog_blocks(emb, n, quant)
    e2pk = e2[osafe] * valid[:, None].astype(e2.dtype)
    e2spk = e2s[osafe] * valid[:, None] if quant else e2s
    packed = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (e2pk, e2spk, (table[:, osafe] & valid).astype(np.uint8),
                  counts, orig, np.asarray(cent, np.float32))) + (cap,)
    _cache_put(key, emb, packed)
    return packed


def _catalog_pack_sharded(emb: np.ndarray, tt, dm, gmask, mesh, *,
                          quant: bool):
    """Per-shard device constants of the sharded program: (list of
    ``CatalogShard`` holding each shard's ``e2``/``e2s`` rows and its
    own contiguous (rows, n_loc) uint8 filter block on its device,
    counts_table on the first shard's device, np_pad), cached per
    catalog snapshot and mesh."""
    S = len(mesh.devices)
    n = emb.shape[0]
    np_pad = n_bucket_sharded(n, S)
    key = (id(emb), "sharded", np_pad, bool(quant),
           tuple(str(d) for d in mesh.devices))
    packed = _cache_lookup(key)
    if packed is not None:
        return packed
    table = _mask_table(tt, dm, gmask, n, np_pad).astype(np.uint8)
    e2, e2s = _catalog_blocks(emb, np_pad, quant)
    dev = lambda a, d: torch.from_numpy(np.ascontiguousarray(a)).to(d)
    shards = [CatalogShard(
        offset=lo, e2=dev(e2[lo:hi], d),
        e2s=dev(e2s[lo:hi] if quant else e2s, d),
        masks=dev(table[:, lo:hi], d))
        for (lo, hi), d in zip(shard_bounds(np_pad, S), mesh.devices)]
    packed = (shards, dev(table.sum(axis=1).astype(np.int32),
                          mesh.devices[0]), np_pad)
    _cache_put(key, emb, packed)
    return packed


def _fb_table_pack(fb_table: np.ndarray, np_pad: int, device: torch.device):
    """Device copy of the dense per-cluster feedback table, catalog axis
    padded to the capacity bucket, cached on the table's identity."""
    key = (id(fb_table), "fbt", np_pad, str(device))
    packed = _cache_lookup(key)
    if packed is not None:
        return packed
    t = np.asarray(fb_table, np.float32)
    packed = torch.from_numpy(
        np.pad(t, ((0, 0), (0, np_pad - t.shape[1])))).to(device)
    _cache_put(key, fb_table, packed)
    return packed


_NP_DTYPE = {torch.float32: np.float32, torch.int64: np.int64,
             torch.int32: np.int32, torch.uint8: np.uint8}


def _to(x, device, dtype=torch.float32) -> torch.Tensor:
    """numpy (or tensor) -> contiguous ``dtype`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(
        np.ascontiguousarray(x, dtype=_NP_DTYPE[dtype])).to(device)


def _host(out: dict, B: int) -> dict:
    """ONE device->host transfer per output, sliced to the batch."""
    # lint: ignore[torch-host-sync] -- the op's contract: host arrays out
    return {key: v[:B].cpu().numpy() for key, v in out.items()}


def _blend_operands(n: int, np_pad: int, theta, ainv, lpen, fb_weight,
                    ad_weight, alpha, device):
    """Padded device operands of the bandit and load terms (None when
    off) and the (3,) scalar params."""
    npad = np_pad - n
    thp = aip = lpp = None
    if theta is not None:
        th = np.asarray(theta, np.float32)[:n]
        ai = np.asarray(ainv, np.float32)[:n].reshape(n, -1)
        thp = _to(np.pad(th, ((0, npad), (0, 0))), device)
        aip = _to(np.pad(ai, ((0, npad), (0, 0))), device)
    if lpen is not None:
        lpp = _to(np.pad(np.asarray(lpen, np.float32)[:n], (0, npad)), device)
    # lint: ignore[torch-constant-rebuild] -- the blend's three weights,
    # the caller's per batch: one 12-byte copy a dispatch
    params = torch.tensor([fb_weight, ad_weight, alpha], dtype=torch.float32,
                          device=device)
    return thp, aip, lpp, params


# ----------------------------------------------------------------------
# router_topk (the semantic cache's lookup)
# ----------------------------------------------------------------------

def router_topk(emb, queries, k: int, mask=None, weights=None,
                row_bias=None, min_score: Optional[float] = None, *,
                quant: bool = False,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-cosine top-k over a catalog (the reference's
    ``ops.router_topk`` contract, in its positional order).

    emb (N, D); queries (Q, D); mask None, (N,) or (Q, N) bool; weights
    (D,) per-axis importance inside the dot product (sim = sum_d w_d e_d
    q_d / (|e| |q|)), folded into the catalog rows before the kernel, as
    the reference folds them; row_bias (N,) added on mask-valid rows;
    min_score floor after mask + bias.  ``quant`` scores int8
    row-quantized rows (int32 dot, one fp32 rescale) of the weighted
    rows.  The rows are formed per call (no cached pack), so a weighted
    call never reuses an unweighted catalog.  Returns (vals (Q, k) f32,
    idx (Q, k) i32) on ``device``; empty slots have vals == -inf.
    """
    dev = resolve_device(device)
    emb = _to(emb, dev)
    queries = _to(queries, dev)
    N = emb.shape[0]
    Q = queries.shape[0]
    ew = unit_rows(emb, None if weights is None else _to(weights, dev))
    qn = unit_rows(queries)
    if mask is None:
        table = torch.ones((1, N), dtype=torch.uint8, device=dev)
        rows = torch.zeros(Q, dtype=torch.int32, device=dev)
    else:
        table = _to(mask, dev, torch.uint8)
        if table.ndim == 1:
            table = table[None, :]
            rows = torch.zeros(Q, dtype=torch.int32, device=dev)
        else:
            rows = torch.arange(Q, dtype=torch.int32, device=dev)
    table = table.contiguous()
    bias = _to(row_bias, dev).contiguous() if row_bias is not None else None
    ms = float("-inf") if min_score is None else float(min_score)
    if quant:
        e8, es = quantize_rows(ew)
        q8, qs = quantize_rows(qn)
        return _topk_q8_kernel(q8.contiguous(), e8.contiguous(),
                               qs[:, 0].contiguous(), es[:, 0].contiguous(),
                               table, rows, k, bias=bias, min_score=ms)
    return _topk_kernel(qn.contiguous(), ew.contiguous(), table, rows, k,
                        bias=bias, min_score=ms)


def router_topk_bucketed(emb, queries, k: int, mask=None,
                         min_score: Optional[float] = None, *,
                         quant: bool = False, device=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``router_topk`` behind the query-axis bucket (a 2-D mask pads
    with all-False rows, so bucket rows come back -inf and are sliced
    off).  Returns host (vals, idx)."""
    queries = np.asarray(queries, np.float32)
    Q = queries.shape[0]
    qp = q_bucket(Q)
    if qp != Q:
        queries = np.pad(queries, ((0, qp - Q), (0, 0)))
        if mask is not None and np.ndim(mask) == 2:
            mask = np.pad(np.asarray(mask), ((0, qp - Q), (0, 0)))
    vals, idx = router_topk(emb, queries, k, mask=mask, min_score=min_score,
                            quant=quant, device=device)
    _bump("topk")
    # lint: ignore[torch-host-sync] -- the op's contract: host arrays out
    return vals[:Q].cpu().numpy(), idx[:Q].cpu().numpy()


def _unit_catalog(emb: np.ndarray, e2: torch.Tensor, np_pad: int,
                  device: torch.device) -> torch.Tensor:
    """(Np, M) unit rows of the packed catalog's raw half, normalized as
    ``router_topk`` normalizes a catalog (``unit_rows``), cached per
    catalog snapshot beside the pack."""
    key = (id(emb), "unit", np_pad, str(device))
    packed = _cache_lookup(key)
    if packed is not None:
        return packed
    M = e2.shape[1] // 2
    packed = unit_rows(e2[:, M:]).contiguous()
    _cache_put(key, emb, packed)
    return packed


def knn_rows(emb, tt_matrix, dm_matrix, gmask, T, ti, di, *, k: int,
             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The staged routing path's mask-fused cosine kNN: ONE
    ``router_topk`` launch per batch.

    Each query's filter is its (task type ``ti``, domain ``di``) row of
    the stacked table ``route_step`` already holds on the device
    (``_mask_table``: row ``ti * n_dm + di``), so no (B, N) mask is
    built or copied; the catalog's unit rows are cached per snapshot.
    Equal bit for bit to ``router_topk(emb, T, k,
    mask=tt_matrix[ti] & dm_matrix[di])``.  Returns host (vals (B, k)
    f32, idx (B, k) i32); rows failing the filters come back -inf."""
    dev = resolve_device(device)
    emb = np.asarray(emb, np.float32)
    n = emb.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"knn_rows needs 1 <= k <= n: {(k, n)}")
    np_pad = n_bucket(n)
    e2, _, masks, _ = _catalog_pack(emb, tt_matrix, dm_matrix, gmask,
                                    np_pad, quant=False, device=dev)
    embn = _unit_catalog(emb, e2, np_pad, dev)
    n_dm = np.asarray(dm_matrix).shape[0]
    rows = np.asarray(ti, np.int64) * n_dm + np.asarray(di, np.int64)
    qn = unit_rows(_to(T, dev)).contiguous()
    vals, idx = _topk_kernel(qn, embn, masks, _to(rows, dev, torch.int32),
                             k)
    # lint: ignore[torch-host-sync] -- the op's contract: host arrays out
    return vals.cpu().numpy(), idx.cpu().numpy()


# ----------------------------------------------------------------------
# route_step: the dense single-device routing program
# ----------------------------------------------------------------------

def route_step(emb, tt_matrix, dm_matrix, gmask, T, W, ti, di, *,
               k: int, r: int, fb: Optional[np.ndarray] = None,
               fb_weight: float = 0.0, theta: Optional[np.ndarray] = None,
               ainv: Optional[np.ndarray] = None, alpha: float = 0.0,
               ad_weight: float = 0.0, lpen: Optional[np.ndarray] = None,
               quant: bool = False, mesh=None, ivf=None, nprobe: int = 8,
               device=None, telemetry=None, tracer=None) -> dict:
    """One routing step per batch (see ``kernels/route_step.py``).

    Pads the batch to its Q bucket (bucket rows take the trailing
    all-True filter rows) and the catalog to its capacity, runs one
    program, returns host numpy outputs sliced to B:

    * dense (default) on ``device``;
    * ``mesh`` (``launch.mesh.make_routing_mesh``): the catalog in
      equal column blocks over the mesh's shards (capacity
      ``n_bucket_sharded``), one ``router_topk`` launch per shard, the
      carries merged on the first shard's device, which must be
      ``device``; bit-identical to dense;
    * ``ivf=(centroids, cell_of)`` (``MRES.ivf_index().as_tuple()``):
      the top-``nprobe`` cells per query of the cell-packed catalog
      (``nprobe >= n_cells`` is exhaustive).  Not composed with
      ``mesh``.

    ``tracer`` wraps the program and the host copy in a ``route_step``
    span (``path`` "dense", "sharded" or "ivf"; ``n_bucket`` the
    capacity, or ``cap`` for IVF; ``shards``; IVF adds
    ``escape_rows``); ``telemetry`` counts one dispatch.
    """
    if ivf is not None and mesh is not None:
        raise ValueError("IVF + mesh sharding is not composed yet")
    dev = resolve_device(device)
    emb = np.asarray(emb, np.float32)
    T = np.asarray(T, np.float32)
    W = np.asarray(W, np.float32)
    n = emb.shape[0]
    B = T.shape[0]
    R = max(k, r)
    if not (1 <= k <= n and 1 <= r <= n):
        raise ValueError(f"route_step needs 1 <= k, r <= n: {(k, r, n)}")
    qp = q_bucket(B)
    n_tt = np.asarray(tt_matrix).shape[0]
    n_dm = np.asarray(dm_matrix).shape[0]
    qpad = qp - B
    ti = np.asarray(ti, np.int64)
    di = np.asarray(di, np.int64)
    if qpad:
        T = np.pad(T, ((0, qpad), (0, 0)))
        W = np.pad(W, ((0, qpad), (0, 0)))
        ti = np.pad(ti, (0, qpad), constant_values=n_tt - 1)
        di = np.pad(di, (0, qpad), constant_values=n_dm - 1)
    fb = None if fb is None else np.asarray(fb, np.float32)
    query = dict(T=_to(T, dev), W=_to(W, dev), ti=_to(ti, dev, torch.int64),
                 di=_to(di, dev, torch.int64))
    shape = dict(k=k, r=r, n_tt=n_tt, n_dm=n_dm, quant=quant)
    attrs = {}
    if ivf is not None:
        cent, cell_of = ivf
        e2, e2s, masks, counts, orig, cent_d, cap = _catalog_pack_ivf(
            emb, tt_matrix, dm_matrix, gmask, np.asarray(cent, np.float32),
            cell_of, quant=quant, device=dev)
        # the blend terms in packed order, gathered on the device: dead
        # slots take zeros
        live, osafe = orig >= 0, orig.clamp(min=0)

        def pk(a, rows=True):
            a = _to(np.asarray(a, np.float32), dev)
            if rows:
                return torch.where(live.reshape((-1,) + (1,) * (a.ndim - 1)),
                                   a[osafe], 0.0)
            return torch.where(live[None, :], a[:, osafe], 0.0)

        thp = aip = lpp = fbp = None
        if theta is not None:
            thp = pk(np.asarray(theta)[:n])
            aip = pk(np.asarray(ainv)[:n].reshape(n, -1))
        if lpen is not None:
            lpp = pk(np.asarray(lpen)[:n])
        if fb is not None:
            fbp = pk(np.pad(fb, ((0, qpad), (0, 0))), rows=False)
        # lint: ignore[torch-constant-rebuild] -- the blend's three
        # weights, the caller's per batch: one 12-byte copy a dispatch
        params = torch.tensor([fb_weight, ad_weight, alpha],
                              dtype=torch.float32, device=dev)
        path, n_pad, shards = "ivf", cap, 1

        def run():
            out, n_escape = route_step_ivf_body(
                e2, e2s, masks, counts, orig, cent_d, **query, fb=fbp,
                theta=thp, ainv_flat=aip, lpen=lpp, params=params,
                nprobe=int(nprobe), cap=cap, **shape)
            attrs["escape_rows"] = n_escape
            return out
    elif mesh is not None:
        S = mesh.shape[CATALOG_AXIS]
        if mesh.devices[0] != dev:
            raise ValueError(f"the routing mesh merges on "
                             f"{mesh.devices[0]}, the program runs on {dev}")
        shards_, counts, np_pad = _catalog_pack_sharded(
            emb, tt_matrix, dm_matrix, gmask, mesh, quant=quant)
        if R > np_pad // S:
            raise ValueError(f"max(k, r) = {R} exceeds a shard's "
                             f"{np_pad // S} columns")
        fbp = None if fb is None else _to(
            np.pad(fb, ((0, qpad), (0, np_pad - n))), dev)
        thp, aip, lpp, params = _blend_operands(
            n, np_pad, theta, ainv, lpen, fb_weight, ad_weight, alpha, dev)
        cut = lambda x, lo, hi, d, col=False: None if x is None else (
            x[:, lo:hi] if col else x[lo:hi]).to(d)
        shards_ = [dataclasses.replace(
            sh, fb=cut(fbp, lo, hi, d, col=True), theta=cut(thp, lo, hi, d),
            ainv_flat=cut(aip, lo, hi, d), lpen=cut(lpp, lo, hi, d))
            for sh, (lo, hi), d in zip(shards_, shard_bounds(np_pad, S),
                                       mesh.devices)]
        path, n_pad, shards = "sharded", np_pad, S

        def run():
            return route_step_sharded_body(shards_, counts, **query,
                                           params=params, **shape)
    else:
        np_pad = n_bucket(n)
        e2, e2s, masks, counts = _catalog_pack(
            emb, tt_matrix, dm_matrix, gmask, np_pad, quant=quant,
            device=dev)
        fbp = None if fb is None else _to(
            np.pad(fb, ((0, qpad), (0, np_pad - n))), dev)
        thp, aip, lpp, params = _blend_operands(
            n, np_pad, theta, ainv, lpen, fb_weight, ad_weight, alpha, dev)
        path, n_pad, shards = "dense", np_pad, 1

        def run():
            return route_step_body(e2, e2s, masks, counts, **query, fb=fbp,
                                   theta=thp, ainv_flat=aip, lpen=lpp,
                                   params=params, **shape)
    span = tracer.span("route_step", path=path, batch=B, q_bucket=qp,
                       n_bucket=n_pad, catalog_n=n, quant=quant,
                       shards=shards) if tracer is not None else NOOP_SPAN
    with span:
        out = _host(run(), B)
        span.set(compiles=0, **attrs)
    _bump("route_step")
    _observe((path, qp, n_pad, quant, shards), _cost.route_step_cost,
             functools.partial(
                 _cost.route_step_cost, qp, n_pad, emb.shape[1], k, r,
                 n_tt * n_dm, quant=quant, fb=fb is not None,
                 ad=theta is not None, load=lpen is not None))
    if telemetry is not None:
        telemetry.record_route_step(dispatches=1, compiles=0)
    return out


# ----------------------------------------------------------------------
# analyze_step / analyze_route_step: the fused tokens->decision path
# ----------------------------------------------------------------------

def _encoder_tokens(encoder: AnalyzerEncoder, tokens, dev: torch.device):
    if encoder.device != dev:
        raise ValueError(f"analyzer weights live on {encoder.device}, the "
                         f"program runs on {dev}")
    tokens = np.asarray(tokens, np.int32)
    B = tokens.shape[0]
    if B < 1:
        raise ValueError("analyze step requires a non-empty batch")
    qp = q_bucket(B)
    if qp != B:                  # all-PAD bucket rows, sliced off below
        tokens = np.pad(tokens, ((0, qp - B), (0, 0)))
    return _to(tokens, dev, torch.int64), B, qp


def analyze_step(encoder: AnalyzerEncoder, tokens, *, device=None,
                 telemetry=None, tracer=None) -> dict:
    """Bucketed analyzer run: host ``{tt_idx, dm_idx, cx, conf}``.
    ``tracer`` wraps it in an ``analyze_step`` span (``path="analyze"``,
    the token axis as ``n_bucket``); ``telemetry`` counts one analyzer
    dispatch."""
    dev = resolve_device(device)
    toks, B, qp = _encoder_tokens(encoder, tokens, dev)
    span = tracer.span("analyze_step", path="analyze", batch=B,
                       q_bucket=qp, n_bucket=int(toks.shape[1]),
                       quant=encoder.quantized, shards=1) \
        if tracer is not None else NOOP_SPAN
    with span:
        with torch.no_grad():
            out = _host(analyze_step_body(encoder, toks), B)
        span.set(compiles=0)
    _bump("analyze_step")
    L = int(toks.shape[1])
    _observe(("analyze", qp, L, encoder.quantized, 1), _cost.analyzer_cost,
             functools.partial(_cost.analyzer_cost, qp, L, encoder.cfg,
                               *_head_widths(encoder),
                               quant=encoder.quantized))
    if telemetry is not None:
        telemetry.record_analyze_step(dispatches=1, compiles=0)
    return out


def analyze_route_step(encoder: AnalyzerEncoder, tokens, emb, tt_matrix,
                       dm_matrix, gmask, W, *, k: int, r: int,
                       threshold: float, acc_col: int,
                       use_complexity: bool = True, fb_table=None,
                       fb_buckets: int = 4, fb_weight: float = 0.0,
                       theta: Optional[np.ndarray] = None,
                       ainv: Optional[np.ndarray] = None,
                       alpha: float = 0.0, ad_weight: float = 0.0,
                       lpen: Optional[np.ndarray] = None,
                       quant: bool = False, device=None, telemetry=None,
                       tracer=None) -> dict:
    """ONE program from token ids to model choice per batch (see
    ``kernels/analyze_step.py``).  tokens (B, L) pad to the Q bucket
    with all-PAD rows, W (B, M) with zero rows; ``fb_table`` is
    ``FeedbackStore.bias_table(names)``.  Returns host numpy
    ``route_step`` outputs plus ``tt_idx``/``dm_idx``/``cx``/``conf``/
    ``task_vectors`` sliced to B.  The one program feeds both counter
    families of ``telemetry`` and one ``route_step`` span
    (``path="fused"``, with ``analyzer_quant``)."""
    dev = resolve_device(device)
    emb = np.asarray(emb, np.float32)
    n = emb.shape[0]
    if not (1 <= k <= n and 1 <= r <= n):
        raise ValueError(f"route_step needs 1 <= k, r <= n: {(k, r, n)}")
    toks, B, qp = _encoder_tokens(encoder, tokens, dev)
    W = np.asarray(W, np.float32)
    if qp != B:
        W = np.pad(W, ((0, qp - B), (0, 0)))
    n_tt = np.asarray(tt_matrix).shape[0]
    n_dm = np.asarray(dm_matrix).shape[0]
    np_pad = n_bucket(n)
    e2, e2s, masks, counts = _catalog_pack(emb, tt_matrix, dm_matrix, gmask,
                                           np_pad, quant=quant, device=dev)
    fbt = _fb_table_pack(fb_table, np_pad, dev) if fb_table is not None \
        else None
    thp, aip, lpp, params = _blend_operands(
        n, np_pad, theta, ainv, lpen, fb_weight, ad_weight, alpha, dev)
    span = tracer.span("route_step", path="fused", batch=B, q_bucket=qp,
                       n_bucket=np_pad, catalog_n=n, quant=quant,
                       analyzer_quant=encoder.quantized, shards=1) \
        if tracer is not None else NOOP_SPAN
    with span:
        with torch.no_grad():
            out = analyze_route_step_body(
                encoder, toks, _to(W, dev), float(threshold), fbt, e2, e2s,
                masks, counts, thp, aip, lpp, params, acc_col=int(acc_col),
                use_complexity=bool(use_complexity),
                fb_buckets=int(fb_buckets), k=k, r=r, n_tt=n_tt, n_dm=n_dm,
                quant=quant)
        out = _host(out, B)
        span.set(compiles=0)
    _bump("route_step")
    _bump("analyze_step")
    aquant = encoder.quantized
    _observe(("fused", qp, np_pad, (quant, aquant), 1),
             _cost.analyze_route_cost,
             functools.partial(
                 _cost.analyze_route_cost, qp, int(toks.shape[1]),
                 encoder.cfg, *_head_widths(encoder), np_pad, emb.shape[1],
                 k, r, n_tt * n_dm, quant=quant, analyzer_quant=aquant,
                 fb=fb_table is not None, ad=theta is not None,
                 load=lpen is not None))
    if telemetry is not None:
        telemetry.record_route_step(dispatches=1, compiles=0)
        telemetry.record_analyze_step(dispatches=1, compiles=0)
    return out


# ----------------------------------------------------------------------
# bandit_update
# ----------------------------------------------------------------------

def bandit_update(x_up, w, r, x_score, theta, ainv, alpha: float, *,
                  device=None):
    """Fused bandit posterior delta + LinUCB scores (reference contract).

    x_up (Bu, D); w (Bu, N) choice mask; r (Bu,); x_score (Bs, D);
    theta (N, D); ainv (N, D, D); alpha >= 0.  Returns tensors on
    ``device``: (dA (N, D, D), db (N, D), ucb (Bs, N)); an empty outcome
    batch (Bu = 0) gives zero deltas.  With no scoring rows (Bs = 0)
    ``theta`` and ``ainv`` may be None: only the deltas are formed.
    """
    if alpha < 0.0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    dev = resolve_device(device)
    D = np.shape(x_up)[-1]
    w = _to(w, dev)
    N = w.shape[-1]
    x_up = _to(x_up, dev).reshape(-1, D).contiguous()
    w = w.reshape(-1, N).contiguous()
    r = _to(r, dev).reshape(-1).contiguous()
    x_score = _to(x_score, dev).reshape(-1, D).contiguous()
    if theta is not None:
        theta = _to(theta, dev).reshape(N, D).contiguous()
        ainv = _to(ainv, dev).reshape(N, D, D).contiguous()
    da, db, ucb = _bandit_kernel(w, x_up, r, x_score, theta, ainv, alpha)
    return da.reshape(N, D, D), db, ucb


# ----------------------------------------------------------------------
# flash attention (the model zoo's attention, layer layout)
# ----------------------------------------------------------------------

def _dmesh(*ts):
    """The mesh of the first DTensor among ``ts``, or None."""
    for t in ts:
        if _place.is_dtensor(t):
            return t.device_mesh
    return None


def _head_blocks(mesh, Hq: int, Hkv: int):
    """(h, kv_h, j): the axis that splits the query heads (``model``
    where it divides Hq and the kv heads follow), the one that splits
    the kv heads, and -- where the query heads split but the kv heads
    do not -- the one kv head this rank's block of query heads reads
    (else None)."""
    G, M = Hq // Hkv, axis_size(mesh, "model")
    hq = Hq // M
    h = "model" if Hq % M == 0 and (Hkv % M == 0 or G % hq == 0) else None
    kv_h = h if Hkv % M == 0 else None
    j = mesh.get_local_rank("model") * hq // G if h and not kv_h else None
    return h, kv_h, j


def _attention_sharded(mesh, q, kvs, kv_valid, call, *, softcap=0.0,
                       local_window: int = 0):
    """Attention on DTensor operands: ``call(q, kv_valid, *kvs)`` on each
    rank's block -- its batch rows over the data axes and its query
    heads over ``model``, each where it divides.  q (B, Lq, Hq, hd);
    kvs (B, Lk, Hkv, .) (keys, values, an int8 cache's scales).  Keys
    and values split by length (a batch-1 decode cache,
    ``cache_specs``): ``_decode_by_length`` (one query row; ``softcap``
    and ``local_window`` are the decode's).

    The kv heads shard with the query heads where ``model`` divides Hkv
    too.  Otherwise (GQA with fewer kv heads than ``model`` ranks) each
    rank reads the keys and values whole and takes the one kv head its
    block of Hq / M query heads reads: the blocks are contiguous, so
    that needs the group size G to be a multiple of Hq / M, and the
    query heads stay whole where it is not.  The kv gradients of such a
    call are partial sums over ``model``."""
    B, _, Hq, _ = q.shape
    if q.shape[1] == 1 and _place.is_dtensor(kvs[0]) and \
            _place.axis_of(kvs[0], 1) is not None:
        return _decode_by_length(mesh, q, kvs, kv_valid, softcap,
                                 local_window)
    b = _place.fit(mesh, B, data_axes(mesh))
    h, kv_h, j = _head_blocks(mesh, Hq, kvs[0].shape[2])

    def local(q, kv_valid, *kvs):
        if j is not None:
            kvs = [t[:, :, j:j + 1] for t in kvs]
        return call(q, kv_valid, *kvs)
    q_spec = P(b, None, h, None)
    return _place.run_local(
        local, mesh, (q, kv_valid) + tuple(kvs),
        (q_spec, P(b)) + (P(b, None, kv_h, None),) * len(kvs),
        (_place.placements(q_spec, mesh),), split=_place.split_axes(b, h))


def _decode_by_length(mesh, q, kvs, kv_valid, softcap, local_window):
    """One query row against keys and values split by length -- the
    batch-1 decode cache (slots over the data axes, kv heads over
    ``model``), a batch-sharded cache whose slots ``model`` splits, or
    seamless's cross K/V over its encoder frames -- without gathering
    them.  q (B, 1, Hq, hd); kvs (B, C, Hkv, .); kv_valid (B,) the live
    count min(pos + 1, C), or None (every slot live).

    The rank holding slots [lo, lo + n) decodes against its own block
    with the local live count ``clamp(kv_valid - lo, 0, n)`` and first
    live slot ``clamp(kv_valid - W - lo, 0, n)`` for a local window W
    (gemma2's local layers in a full cache; the slots pos - W < idx <=
    pos), both formed on the device from ``kv_valid``: no host read, so
    no decode step waits on the host.  A block wholly below the window
    or past the live count holds no live key and gives an empty
    partial.  A ring (a sliding-window layer, every layer in
    ``long_mode``) and a row past the cache (llava) need nothing beyond
    the clamp: every slot of a full ring is live, and the order of a
    ring's slots does not matter to the softmax.

    Each rank's (o, lse) partial -- o in f32, the kernel's ``return_lse``
    -- goes through one all-gather over the length axes, B_local *
    Hq_local * (hd + 1) floats a rank, then ``decode_merge`` in rank
    (block) order, the same on every rank of the group.  The batch keeps
    the cache's split, the query heads follow the kv heads over
    ``model`` (``_head_blocks``) unless ``model`` splits the slots.
    Returns (B, 1, Hq, hd) in q's dtype."""
    B, _, Hq, _ = q.shape
    C, Hkv = kvs[0].shape[1], kvs[0].shape[2]
    b, ax = _place.axis_of(kvs[0], 0), _place.axis_of(kvs[0], 1)
    n = C // axis_size(mesh, ax)
    lo = _place.block_index(mesh, ax) * n
    h, kv_h, j = (None, None, None) if "model" in _place.split_axes(ax) \
        else _head_blocks(mesh, Hq, Hkv)
    live = torch.full((B,), C, dtype=torch.int32, device=q.device) \
        if kv_valid is None else kv_valid

    def local(q, live, *kvs):
        if j is not None:
            kvs = [t[:, :, j:j + 1] for t in kvs]
        first = (live - local_window - lo).clamp(0, n).to(torch.int32) \
            if local_window else None
        o, lse = _decode_partial(q, (live - lo).clamp(0, n).to(torch.int32),
                                 first, *kvs, softcap=softcap)
        return o.transpose(1, 2)[None], lse[None]
    o_parts, lse_parts = _place.run_local(
        local, mesh, (q, live) + tuple(kvs),
        (P(b, None, h, None), P(b)) + (P(b, ax, kv_h, None),) * len(kvs),
        (_place.placements(P(ax, b, h, None, None), mesh),
         _place.placements(P(ax, b, h, None), mesh)))
    o_parts = _place.constrain(o_parts, P(None, b, h, None, None))
    lse_parts = _place.constrain(lse_parts, P(None, b, h, None))
    return _place.run_local(
        lambda o, lse: _merge_kernel(o, lse, q.dtype).transpose(1, 2), mesh,
        (o_parts, lse_parts), (P(None, b, h, None, None),
                               P(None, b, h, None)),
        (_place.placements(P(b, None, h, None), mesh),))


def _decode_partial(q, kv_valid, kv_first, k, v, k_scale=None, v_scale=None,
                    *, softcap):
    """One rank's decode partial over its block of the cache, layer
    layout in and out: (o (B, 1, Hq, hd) f32, lse (B, Hq, 1) f32); an
    int8 block comes with its scales."""
    kw = dict(softcap=softcap, return_lse=True, kv_first=kv_first)
    if k_scale is None:
        o, lse = _flash_kernel(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), kv_valid, causal=False,
                               **kw)
    else:
        o, lse = _flash_q8_kernel(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  k_scale.transpose(1, 2),
                                  v_scale.transpose(1, 2), kv_valid, **kw)
    return o.transpose(1, 2), lse


def _records(*ts) -> bool:
    """Whether autograd records a call on these operands."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class _FlashAttention(torch.autograd.Function):
    """The prefill-shape attention with its backward kernel.  Operands in
    the kernel's (B, H, L, hd) layout; saves them, the output and its
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, window, softcap):
        out, lse = _flash_kernel(q, k, v, kv_valid, causal=causal,
                                 window=window, softcap=softcap,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_valid)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_valid = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_kernel(q, k, v, out, lse, do, kv_valid,
                                       **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, kv_valid=None, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    local_window: int = 0) -> torch.Tensor:
    """q (B, Lq, Hq, hd); k, v (B, Lk, Hkv, hd) -- layer layout (L, H,
    hd), possibly strided views (a KV cache).  kv_valid (B,) int32: the
    per-sequence live key count (decode mode).  The kernel reads the
    layer layout through its strides and takes the true head_dim, so
    the reference's 128-lane pad and ``scale_fix`` have no counterpart.
    Where autograd records, the prefill shapes go through
    ``_FlashAttention`` (the decode shape raises).  Returns (B, Lq, Hq,
    hd) in q's dtype.  DTensor operands: ``_attention_sharded``."""
    mesh = _dmesh(q, k, v)
    if mesh is not None:
        return _attention_sharded(
            mesh, q, (k, v), kv_valid,
            lambda q, kv_valid, k, v: flash_attention(
                q, k, v, kv_valid, causal=causal, window=window,
                softcap=softcap, local_window=local_window),
            softcap=softcap, local_window=local_window)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _records(q, k, v):
        if q.shape[1] == 1 or local_window:
            raise ValueError("flash_attention: the decode shape takes no "
                             "gradient")
        out = _FlashAttention.apply(qt, kt, vt, kv_valid, causal, window,
                                    softcap)
    else:
        out = _flash_kernel(qt, kt, vt, kv_valid, causal=causal,
                            window=window, softcap=softcap,
                            local_window=local_window)
    return out.transpose(1, 2)


def flash_decode(q, k_cache, v_cache, pos, *, local_window: int = 0,
                 softcap: float = 0.0, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """One query token against a cache: q (B, 1, Hq, hd); k_cache /
    v_cache (B, C, Hkv, hd); pos (B,) int -- the current token's index.
    The masks of ``models/layers.attention_decode``:

      * a full cache: the keys at slots <= pos are live, all C of them
        once pos >= C;
      * a ring of the last C keys (slot pos % C): all live once
        pos >= C;
      * ``local_window`` W inside a full cache (gemma2's local layers):
        the slots pos - W < idx <= pos (the last W slots once pos >= C).

    All three are ``kv_valid = min(pos + 1, C)`` (the order of a ring's
    slots being irrelevant to the softmax): the kernel never reads past
    the cache.

    An int8 cache comes with ``k_scale`` / ``v_scale`` (B, C, Hkv, 1)
    f32 and goes to the int8-reading decode (``flash_decode_q8``).  A
    DTensor cache split by length is read where it lies
    (``_decode_by_length``).

    Returns (B, 1, Hq, hd)."""
    live = torch.clamp(pos + 1, max=k_cache.shape[1])
    kv_valid = live.to(torch.int32).contiguous()
    if k_scale is not None:
        if _records(q):
            raise ValueError("flash_decode: the int8 decode takes no "
                             "gradient")
        mesh = _dmesh(q, k_cache)
        if mesh is not None:
            return _attention_sharded(
                mesh, q, (k_cache, v_cache, k_scale, v_scale), kv_valid,
                lambda q, kv_valid, k, v, ks, vs: _flash_q8_kernel(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    ks.transpose(1, 2), vs.transpose(1, 2), kv_valid,
                    softcap=softcap,
                    local_window=local_window).transpose(1, 2),
                softcap=softcap, local_window=local_window)
        out = _flash_q8_kernel(q.transpose(1, 2), k_cache.transpose(1, 2),
                               v_cache.transpose(1, 2),
                               k_scale.transpose(1, 2),
                               v_scale.transpose(1, 2), kv_valid,
                               softcap=softcap, local_window=local_window)
        return out.transpose(1, 2)
    return flash_attention(q, k_cache, v_cache, kv_valid, causal=False,
                           softcap=softcap, local_window=local_window)


# ----------------------------------------------------------------------
# SSD scan
# ----------------------------------------------------------------------

class _SsdScan(torch.autograd.Function):
    """The scan without h0, with its backward kernel (the final state's
    gradient passed on where the caller used it)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        y, hf = _ssd_kernel(x, dt, A, B, C, None, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:      # y unused: f32 zeros (f64 in a gradient check)
            dy = torch.zeros_like(
                x, dtype=torch.promote_types(x.dtype, torch.float32))
        return _ssd_bwd_kernel(x, dt, A, B, C, dy, dh) + (None,)


def ssd_scan(x, dt, A, B, C, h0=None, *, chunk: int = 128):
    """Chunked SSD scan (``kernels/ssd_scan.py``): (y (Bb, L, H, P) f32,
    h_final (Bb, H, P, N) f32).  Where autograd records, through
    ``_SsdScan`` (an ``h0`` then raises: training starts from a zero
    state).  DTensor operands: each rank scans its batch rows (over the
    data axes) and its heads (over ``model``), where they divide."""
    mesh = _dmesh(x, dt, A, B, C, h0)
    if mesh is not None:
        Bb, _, H, _ = x.shape
        b = _place.fit(mesh, Bb, data_axes(mesh))
        h = _place.fit(mesh, H, "model")
        return _place.run_local(
            lambda *a: ssd_scan(*a, chunk=chunk), mesh,
            (x, dt, A, B, C, h0),
            (P(b, None, h, None), P(b, None, h), P(h), P(b, None, None),
             P(b, None, None), P(b, h, None, None)),
            (_place.placements(P(b, None, h, None), mesh),
             _place.placements(P(b, h, None, None), mesh)),
            split=_place.split_axes(b, h))
    if _records(x, dt, A, B, C, h0):
        if h0 is not None:
            raise ValueError("ssd_scan: the backward takes h0 = None")
        return _SsdScan.apply(x, dt, A, B, C, chunk)
    return _ssd_kernel(x, dt, A, B, C, h0, chunk=chunk)


# ----------------------------------------------------------------------
# MoE gating
# ----------------------------------------------------------------------

class _MoeGating(torch.autograd.Function):
    """The gate with its backward kernel: the forward keeps the
    assignment counts it reduces for aux."""

    @staticmethod
    def forward(ctx, logits, k):
        vals, idx, aux, asum = _gate_kernel(logits, k, return_asum=True)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(logits, idx, asum)
        return vals, idx, aux

    @staticmethod
    def backward(ctx, dvals, _didx, daux):
        logits, idx, asum = ctx.saved_tensors
        return _gate_bwd_kernel(logits, idx, dvals, daux, asum), None


class _MoeGatingSplit(torch.autograd.Function):
    """The gate over one rank's tokens of a token-split batch: the
    kernel's vals and idx are per token, and aux is the whole batch's,
    formed from the assignment counts and probability sums the launch
    gives, summed over ``groups`` (the data axes' process groups).  The
    backward kernel takes the summed counts, scaled so that its E / T^2
    (of the rank's T) is the batch's."""

    @staticmethod
    def forward(ctx, logits, k, groups, T):
        import torch.distributed as dist
        vals, idx, _, asum, psum = _gate_kernel(logits, k, return_asum=True,
                                                return_psum=True)
        sums = torch.stack([asum, psum])
        for g in groups:
            dist.all_reduce(sums, group=g)
        E, t = logits.shape[1], logits.shape[0]
        aux = torch.dot(sums[1], sums[0]) * (E / (T * T))
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(logits, idx, sums[0] * (t * t / (T * T)))
        return vals, idx, aux

    @staticmethod
    def backward(ctx, dvals, _didx, daux):
        logits, idx, asum = ctx.saved_tensors
        return (_gate_bwd_kernel(logits, idx, dvals, daux, asum), None,
                None, None)


def _gate_sharded(mesh, flat, k: int):
    """The gate on DTensor logits (T, E): each rank gates its tokens
    (over the data axes, where they divide T) against all E experts
    (the logits' expert columns gathered first).  With one data rank
    the kernel's own aux is the batch's."""
    T = flat.shape[0]
    b = _place.fit(mesh, T, data_axes(mesh))
    groups = [mesh.get_group(a) for a in _place.split_axes(b)
              if axis_size(mesh, a) > 1]

    def local(lg):
        if not groups:
            return moe_gating(lg, k)
        return _MoeGatingSplit.apply(lg, k, groups, T)
    rows = _place.placements(P(b, None), mesh)
    return _place.run_local(local, mesh, (flat,), (P(b, None),),
                            (rows, rows, _place.placements(P(), mesh)),
                            split=_place.split_axes(b))


def moe_gating(logits, k: int):
    """Fused softmax top-k gate (``kernels/moe_gating.py``).  logits
    (..., E), flattened to (T, E).  Returns (vals (..., k) f32, idx
    (..., k) int32, aux f32 scalar tensor).  Where autograd records,
    through ``_MoeGating``.  DTensor logits: ``_gate_sharded``."""
    shape = logits.shape
    flat = logits.reshape(-1, shape[-1])
    mesh = _dmesh(logits)
    if mesh is not None:
        vals, idx, aux = _gate_sharded(mesh, flat, k)
    else:
        vals, idx, aux = (_MoeGating.apply(flat, k) if _records(logits)
                          else _gate_kernel(flat, k))
    return (vals.reshape(shape[:-1] + (k,)),
            idx.reshape(shape[:-1] + (k,)), aux)
