"""Public wrappers of the serving-path programs and kernels.

Port of the JAX package's ``kernels/ops.py`` for the dense
single-device path.  Each op pads the query axis to its power-of-two
bucket and the catalog to its 128-aligned capacity (``q_bucket`` /
``n_bucket``: eager PyTorch compiles nothing, but the padded shapes are
the ones a captured CUDA graph per bucket will need), runs one program
on ``device``, and hands host numpy arrays back sliced to the batch.

``route_step``, ``analyze_step`` and ``analyze_route_step`` take the
observability sinks of the reference's ops: ``telemetry`` (a
``core.telemetry.Telemetry``) receives one dispatch per call and 0
compiles (eager PyTorch compiles nothing; a captured CUDA graph per
bucket will count as one), and ``tracer`` (an ``obs.Tracer``) wraps
the launch and the host copy of its outputs in one span.  With
neither attached the path and its launches are unchanged.

Every op takes ``device=None`` (= ``"cuda"``; raises without a card).
On the card the route-step kNN, the staged path's kNN (``knn_rows``),
the cache lookup and the bandit update always launch their
hand-written kernels; ``device="cpu"`` runs their
plain PyTorch versions.  The model-zoo ops at the end (``flash_attention``,
``flash_decode``, ``ssd_scan``, ``moe_gating``) take tensors and run
where those tensors live: on the card their kernels, on the CPU the
plain versions.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import NOOP_SPAN
from repro_torch.kernels.analyze_step import (AnalyzerEncoder,
                                              analyze_route_step_body,
                                              analyze_step_body)
from repro_torch.kernels.bandit_update import bandit_update as _bandit_kernel
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_kernel
from repro_torch.kernels.moe_gating import moe_gating as _gate_kernel
from repro_torch.kernels.route_step import (quantize_rows, route_step_body,
                                            unit_rows)
from repro_torch.kernels.router_topk import (router_topk as _topk_kernel,
                                             router_topk_q8 as _topk_q8_kernel)
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel

LANE = 128


def q_bucket(q: int) -> int:
    """Power-of-two query-axis bucket (floor 8)."""
    return max(8, 1 << max(q - 1, 1).bit_length())


def n_bucket(n: int) -> int:
    """128-aligned catalog-axis capacity (floor 128)."""
    return max(128, -(-n // LANE) * LANE)


# dispatch counters of the bucketed serving-path ops (one count per
# program run; eager PyTorch has no compiles to count)
_STATS = {"route_step_dispatches": 0, "topk_dispatches": 0,
          "analyze_step_dispatches": 0}
_STATS_LOCK = threading.Lock()


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
    params = torch.tensor([fb_weight, ad_weight, alpha], dtype=torch.float32,
                          device=device)
    return thp, aip, lpp, params


# ----------------------------------------------------------------------
# router_topk (the semantic cache's lookup)
# ----------------------------------------------------------------------

def router_topk(emb, queries, k: int, mask=None, row_bias=None,
                min_score: Optional[float] = None, *, quant: bool = False,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine top-k over a catalog (the reference's ``ops.router_topk``
    contract, without its per-axis ``weights``, which no caller uses).

    emb (N, D); queries (Q, D); mask None, (N,) or (Q, N) bool; row_bias
    (N,) added on mask-valid rows; min_score floor after mask + bias.
    ``quant`` scores int8 row-quantized rows (int32 dot, one fp32
    rescale).  Returns (vals (Q, k) f32, idx (Q, k) i32) on ``device``;
    empty slots have vals == -inf.
    """
    dev = resolve_device(device)
    emb = _to(emb, dev)
    queries = _to(queries, dev)
    N = emb.shape[0]
    Q = queries.shape[0]
    ew = unit_rows(emb)
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
    return vals.cpu().numpy(), idx.cpu().numpy()


# ----------------------------------------------------------------------
# route_step: the dense single-device routing program
# ----------------------------------------------------------------------

def route_step(emb, tt_matrix, dm_matrix, gmask, T, W, ti, di, *,
               k: int, r: int, fb: Optional[np.ndarray] = None,
               fb_weight: float = 0.0, theta: Optional[np.ndarray] = None,
               ainv: Optional[np.ndarray] = None, alpha: float = 0.0,
               ad_weight: float = 0.0, lpen: Optional[np.ndarray] = None,
               quant: bool = False, device=None, telemetry=None,
               tracer=None) -> dict:
    """One routing step per batch (see ``kernels/route_step.py``).

    Pads the batch to its Q bucket (bucket rows take the trailing
    all-True filter rows) and the catalog to its capacity, runs the
    program on ``device``, returns host numpy outputs sliced to B.
    ``tracer`` wraps the launch and the host copy in a ``route_step``
    span (``path="dense"``); ``telemetry`` counts one dispatch.
    """
    dev = resolve_device(device)
    emb = np.asarray(emb, np.float32)
    T = np.asarray(T, np.float32)
    W = np.asarray(W, np.float32)
    n = emb.shape[0]
    B = T.shape[0]
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
    np_pad = n_bucket(n)
    e2, e2s, masks, counts = _catalog_pack(emb, tt_matrix, dm_matrix, gmask,
                                           np_pad, quant=quant, device=dev)
    fbp = None
    if fb is not None:
        fbp = _to(np.pad(np.asarray(fb, np.float32),
                         ((0, qpad), (0, np_pad - n))), dev)
    thp, aip, lpp, params = _blend_operands(
        n, np_pad, theta, ainv, lpen, fb_weight, ad_weight, alpha, dev)
    span = tracer.span("route_step", path="dense", batch=B, q_bucket=qp,
                       n_bucket=np_pad, catalog_n=n, quant=quant,
                       shards=1) if tracer is not None else NOOP_SPAN
    with span:
        out = route_step_body(
            e2, e2s, masks, counts, _to(T, dev), _to(W, dev),
            _to(ti, dev, torch.int64), _to(di, dev, torch.int64), fbp, thp,
            aip, lpp, params, k=k, r=r, n_tt=n_tt, n_dm=n_dm, quant=quant)
        out = _host(out, B)
        span.set(compiles=0)
    _bump("route_step")
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

def flash_attention(q, k, v, kv_valid=None, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    local_window: int = 0) -> torch.Tensor:
    """q (B, Lq, Hq, hd); k, v (B, Lk, Hkv, hd) -- layer layout (L, H,
    hd), possibly strided views (a KV cache).  kv_valid (B,) int32: the
    per-sequence live key count (decode mode).  The kernel reads the
    layer layout through its strides and takes the true head_dim, so
    the reference's 128-lane pad and ``scale_fix`` have no counterpart.
    Returns (B, Lq, Hq, hd) in q's dtype."""
    out = _flash_kernel(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), kv_valid, causal=causal,
                        window=window, softcap=softcap,
                        local_window=local_window)
    return out.transpose(1, 2)


def flash_decode(q, k_cache, v_cache, pos, *, local_window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
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

    Returns (B, 1, Hq, hd)."""
    live = torch.clamp(pos + 1, max=k_cache.shape[1])
    kv_valid = live.to(torch.int32).contiguous()
    return flash_attention(q, k_cache, v_cache, kv_valid, causal=False,
                           softcap=softcap, local_window=local_window)


# ----------------------------------------------------------------------
# SSD scan
# ----------------------------------------------------------------------

def ssd_scan(x, dt, A, B, C, h0=None, *, chunk: int = 128):
    """Chunked SSD scan (``kernels/ssd_scan.py``): (y (Bb, L, H, P) f32,
    h_final (Bb, H, P, N) f32)."""
    return _ssd_kernel(x, dt, A, B, C, h0, chunk=chunk)


# ----------------------------------------------------------------------
# MoE gating
# ----------------------------------------------------------------------

def moe_gating(logits, k: int):
    """Fused softmax top-k gate (``kernels/moe_gating.py``).  logits
    (..., E), flattened to (T, E).  Returns (vals (..., k) f32, idx
    (..., k) int32, aux f32 scalar tensor)."""
    shape = logits.shape
    vals, idx, aux = _gate_kernel(logits.reshape(-1, shape[-1]), k)
    return (vals.reshape(shape[:-1] + (k,)),
            idx.reshape(shape[:-1] + (k,)), aux)
