"""Per-bucket cost profiles of the routing programs, and a trace region.

Port of the JAX package's ``obs/profile.py``.  ``DeviceCostProfiler``
hooks into ``kernels.ops`` (``ops.set_cost_profiler``): every
``route_step``, ``analyze_step`` and fused ``analyze_route_step``
dispatch hands it its shape bucket ``(path, q_bucket, n_bucket, quant,
shards)``, and the first dispatch of a bucket records that bucket's
FLOPs and bytes accessed.  PyTorch runs eagerly and has no compiled
program whose cost analysis could be read, so the numbers are counted
from the bucket's padded shapes by the formulas below; they are the
same counts ``chip_smoke.py`` divides by the card's peaks for the
``router_topk`` rows' ``bound_ms`` (``knn_cost``).  Nothing runs while
no profiler is attached; attached, a bucket costs one formula on its
first dispatch.  The per-bucket numbers feed the
``repro_route_step_flops`` / ``repro_route_step_bytes`` gauges of
``obs.export.prometheus_text(cost_profile=...)``.

The terms (Q queries, N catalog rows, D the catalog's width, one
element 4 bytes, or 1 in an int8 catalog):

* the analyzer's projections (``analyzer_cost``): per query and layer
  the q/k/v/o and MLP matmuls over L tokens, 2 (4 L d^2 + 2 L d f)
  FLOPs, and the scores and values, 4 L^2 d; the heads' 2 d (n_tt +
  n_dm + 1); bytes: every weight once (int8 matrices 1 byte an element
  plus a scale a column), the tokens and the four outputs;
* the kNN (``knn_cost``): 2 D FLOPs per (query, row) pair scored, Q N
  D over the padded shapes; bytes: the unit queries and catalog rows
  (int8: the rows and their scales), the filter-table rows the batch
  reads (N bytes each), the row ids and the (Q, k) values and indices;
* the blend (``blend_cost``): the (Q, N) preference blend W . emb, 2 D
  a pair, reading the catalog's raw rows once; the feedback term reads
  a (Q, N) f32 matrix; the LinUCB term reads theta (N, D + 1) and the
  flattened inverse (N, (D + 1)^2) and does 2 ((D + 1) + (D + 1)^2) a
  pair; the load penalty reads N values;
* the sharded program does the same work split over its shards, the
  IVF program scores its probed ``cap`` slots (its bucket's N).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

from repro_torch.analysis.sanitize import make_lock

Costs = Dict[str, Optional[float]]


def _costs(flops: float, nbytes: float) -> Costs:
    return {"flops": float(flops), "bytes_accessed": float(nbytes)}


def knn_cost(q: int, n: int, d: int, k: int, mask_rows: int,
             pairs: Optional[int] = None, quant: bool = False) -> Costs:
    """The masked cosine top-k: ``pairs`` (query, row) pairs scored
    (default every one, q * n), ``mask_rows`` filter rows of n bytes
    read."""
    pairs = q * n if pairs is None else pairs
    elt = 1 if quant else 4
    nbytes = (q * d * elt + n * d * elt + mask_rows * n + q * 4
              + q * k * 8)
    if quant:
        nbytes += (q + n) * 4                       # per-row scales
    return _costs(2.0 * d * pairs, nbytes)


def blend_cost(q: int, n: int, d: int, *, fb: bool = False,
               ad: bool = False, load: bool = False,
               quant: bool = False) -> Costs:
    """The (q, n) blend of the preference weights and the optional
    feedback / LinUCB / load terms."""
    flops = 2.0 * d * q * n
    nbytes = q * d * 4 + n * d * (1 if quant else 4)
    if fb:
        flops += q * n
        nbytes += q * n * 4
    if ad:
        c = d + 1
        flops += 2.0 * (c + c * c) * q * n
        nbytes += n * (c + c * c) * 4
    if load:
        flops += q * n
        nbytes += n * 4
    return _costs(flops, nbytes)


def analyzer_cost(q: int, L: int, cfg, n_tt: int, n_dm: int,
                  quant: bool = False) -> Costs:
    """The analyzer encoder and heads over q padded rows of L tokens."""
    dm, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    per_layer = 2.0 * (4 * L * dm * dm + 2 * L * dm * f) + 4.0 * L * L * dm
    heads = n_tt + n_dm + 1
    flops = q * (nl * per_layer + 2.0 * dm * heads)
    mats = (nl * (4 * dm * dm + 2 * dm * f)
            + (cfg.vocab_size + cfg.max_len) * dm + dm * heads)
    cols = nl * (4 * dm + dm + f) + 2 * dm + heads  # one scale a column
    vecs = nl * 2 * dm + dm                         # the norms
    wbytes = (mats + cols * 4 if quant else mats * 4) + vecs * 4
    return _costs(flops, wbytes + q * L * 4 + q * 16)


def route_step_cost(q: int, n: int, d: int, k: int, r: int,
                    mask_rows: int, *, quant: bool = False,
                    fb: bool = False, ad: bool = False,
                    load: bool = False) -> Costs:
    """One routing program over a (q, n) bucket: the kNN over every
    padded pair, the blend, and the candidates' re-rank (k lanes a
    query)."""
    knn = knn_cost(q, n, d, k, min(q, mask_rows), quant=quant)
    bl = blend_cost(q, n, d, fb=fb, ad=ad, load=load, quant=quant)
    out = q * (max(k, r) * 8 + 16)                 # the eight outputs
    return _costs(knn["flops"] + bl["flops"] + 2.0 * d * q * k,
                  knn["bytes_accessed"] + bl["bytes_accessed"] + out)


def analyze_route_cost(q: int, L: int, cfg, n_tt: int, n_dm: int, n: int,
                       d: int, k: int, r: int, mask_rows: int, *,
                       quant: bool = False, analyzer_quant: bool = False,
                       fb: bool = False, ad: bool = False,
                       load: bool = False) -> Costs:
    """The fused program: the analyzer, then the routing program."""
    a = analyzer_cost(q, L, cfg, n_tt, n_dm, quant=analyzer_quant)
    rs = route_step_cost(q, n, d, k, r, mask_rows, quant=quant, fb=fb,
                         ad=ad, load=load)
    return _costs(a["flops"] + rs["flops"],
                  a["bytes_accessed"] + rs["bytes_accessed"])


class DeviceCostProfiler:
    """Per-bucket cost profiles of the routing programs.

    ``capture(bucket, fn, call)`` is invoked by the ops layer on every
    dispatch with ``call`` a ``functools.partial`` of the cost formula
    ``fn`` bound to the dispatch's padded shapes; an unseen bucket is
    counted once (``fn(*call.args, **call.keywords)``), a seen one
    returns at once.  Thread-safe; a formula that raises records
    ``None`` entries and counts an error rather than raising into the
    serving path, as the reference's profiler does.
    """

    def __init__(self):
        self._lock = make_lock("obs.profiler")
        self._by_bucket: Dict[Any, Costs] = {}
        self.captures = 0
        self.errors = 0

    def capture(self, bucket, fn, call) -> None:
        with self._lock:
            if bucket in self._by_bucket:
                return
            self._by_bucket[bucket] = {"flops": None,
                                       "bytes_accessed": None}
        try:
            costs = fn(*call.args, **call.keywords)
        except Exception:                   # noqa: BLE001 - best effort
            with self._lock:
                self.errors += 1
            return
        with self._lock:
            self._by_bucket[bucket] = dict(costs)
            self.captures += 1

    def profile(self) -> Dict[str, Costs]:
        """Per-bucket costs keyed by a stable string form of the bucket."""
        with self._lock:
            return {"/".join(str(p) for p in key): dict(v)
                    for key, v in self._by_bucket.items()}


@contextlib.contextmanager
def trace_capture(trace_dir: Optional[str]):
    """``torch.profiler.profile`` around a region (CPU activity, and the
    card's where one is present), written as a Chrome trace
    ``trace.json`` into ``trace_dir``; a no-op when ``trace_dir`` is
    falsy."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(trace_dir), exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(trace_dir), "trace.json"))
