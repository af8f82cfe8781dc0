"""Model Registry and Evaluation Store (paper §3.3).

An in-memory vector store of model entries.  Each entry carries raw
evaluation metrics (accuracy %, latency ms, cost $ / 1M tok, ethics
scores, ...), task-type/domain tags and a handle to the runnable model.
Raw metrics are min-max normalized across the catalog into [0, 1]
(1 = better; latency and cost are inverted) — the normalized vectors are
the embeddings the Routing Engine searches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.sanitize import make_lock
from repro_torch.core.preferences import DOMAINS, METRICS, N_METRICS, TASK_TYPES

# Layout of the fused routing matrix (see MRES docstring): normalized
# metric embeddings, then one-hot task-type bonus columns (+ an
# all-types row), one-hot domain bonus columns (+ an all-domains row),
# then a constant bias column.  A query one-hots its task type and
# domain at MASK_BONUS weight and puts -2 * MASK_BONUS in the bias
# column, so rows passing BOTH filters score bonus 0 (pure cosine) and
# filtered-out rows drop by >= MASK_BONUS — fusing the hierarchical
# masks into the kNN matmul exactly like the Pallas kernel fuses its
# mask in-register.
TT_COL = N_METRICS
DM_COL = TT_COL + len(TASK_TYPES) + 1
BIAS_COL = DM_COL + len(DOMAINS) + 1
ROUTE_COLS = BIAS_COL + 1
MASK_BONUS = 8.0          # > 2 + |cosine| margin, keeps stages separable

# raw metric names -> (embedding axis, higher_is_better)
RAW_TO_AXIS = {
    "accuracy": ("accuracy", True),
    "latency_ms": ("speed", False),
    "cost_per_mtok": ("cheapness", False),
    "helpfulness": ("helpfulness", True),
    "harmlessness": ("harmlessness", True),
    "honesty": ("honesty", True),
    "steerability": ("steerability", True),
    "creativity": ("creativity", True),
}


@dataclass
class IVFIndex:
    """Two-level pruned-search index over the catalog (mega-catalog
    path): spherical k-means centroids over the UNIT-normalized metric
    embeddings and each entry's cell assignment.  Consumed by
    ``kernels/ops.route_step(ivf=(centroids, cell_of), nprobe=...)``
    — only the top-``nprobe`` cells per query are scanned, so recall
    versus the exhaustive search is the ``nprobe`` knob."""
    centroids: np.ndarray             # (C, N_METRICS) f32 unit rows
    cell_of: np.ndarray               # (n,) i32 cell per catalog row
    n_cells: int

    def as_tuple(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.centroids, self.cell_of


def build_ivf(emb: np.ndarray, n_cells: int, *, seed: int = 0,
              iters: int = 5) -> IVFIndex:
    """Spherical k-means over unit-normalized embedding rows, in host
    numpy (the reference's arithmetic, so the index is the reference's
    bit for bit).

    Deterministic (fixed ``seed``), a handful of Lloyd iterations —
    routing embeddings are low-dimensional and heavily clustered by
    construction (min-max normalized metric profiles), so cheap
    centroids already give high recall at small ``nprobe``.  Empty
    cells keep their previous centroid (their slots simply stay dead
    in the packed layout).
    """
    n = emb.shape[0]
    C = max(1, min(int(n_cells), n))
    embf = emb.astype(np.float32)
    embn = embf / (np.linalg.norm(embf, axis=1, keepdims=True) + 1e-9)
    rng = np.random.default_rng(seed)
    cent = embn[rng.choice(n, C, replace=False)].copy()
    for _ in range(max(0, int(iters))):
        cell = (embn @ cent.T).argmax(axis=1)
        sums = np.zeros_like(cent)
        np.add.at(sums, cell, embn)
        cnt = np.bincount(cell, minlength=C)
        nz = cnt > 0
        cent[nz] = sums[nz] / (
            np.linalg.norm(sums[nz], axis=1, keepdims=True) + 1e-9)
    cell = (embn @ cent.T).argmax(axis=1).astype(np.int32)
    return IVFIndex(cent.astype(np.float32), cell, C)


def default_n_cells(n: int) -> int:
    """~sqrt(N) cells: balances coarse-scan cost (C per query) against
    fine-scan cost (nprobe * N / C per query)."""
    return max(1, int(round(float(n) ** 0.5)))


@dataclass
class ModelEntry:
    name: str
    raw_metrics: Dict[str, float]
    task_types: Tuple[str, ...] = ("chat",)
    domains: Tuple[str, ...] = ("general",)
    family: str = "dense"
    n_params: int = 0
    generalist: bool = False          # fallback-eligible (paper §3.4)
    runner: Any = None                # handle to the servable model
    meta: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> "ModelEntry":
        for t in self.task_types:
            assert t in TASK_TYPES, (self.name, t)
        for d in self.domains:
            assert d in DOMAINS, (self.name, d)
        for k in RAW_TO_AXIS:
            assert k in self.raw_metrics, (self.name, f"missing metric {k}")
        return self


def normalize_catalog(entries: Sequence[ModelEntry]) -> np.ndarray:
    """Min-max normalize raw metrics into the (n_models, N_METRICS)
    embedding matrix. 1 = better on every axis (inversions applied).

    Scale-invariant: multiplying any raw metric column by c > 0 leaves
    the result unchanged. Single-model catalogs normalize to 1.0.
    """
    n = len(entries)
    emb = np.zeros((n, N_METRICS), np.float32)
    for j, raw_name in enumerate(RAW_TO_AXIS):
        axis_name, hib = RAW_TO_AXIS[raw_name]
        ax = METRICS.index(axis_name)
        col = np.array([float(e.raw_metrics[raw_name]) for e in entries],
                       np.float64)
        lo, hi = col.min(), col.max()
        if hi - lo < 1e-12:
            norm = np.ones_like(col)
        else:
            norm = (col - lo) / (hi - lo)
        if not hib:
            norm = 1.0 - norm
        emb[:, ax] = norm.astype(np.float32)
    return emb


class MRES:
    """In-memory vector store over the model catalog. Thread-safe for the
    serving engine's concurrent route/feedback calls.

    Besides the normalized embedding matrix, the store caches the
    hierarchical-filter structure as stacked boolean matrices —
    ``(n_task_types + 1, N)`` and ``(n_domains + 1, N)`` (the extra final
    row is all-True for "no filter") — so the batched routing path turns
    per-query mask construction into plain row lookups.  All caches share
    one dirty flag and rebuild together on the next read."""

    def __init__(self):
        self._entries: List[ModelEntry] = []
        self._names: set = set()
        self._index: Dict[str, int] = {}   # name -> catalog row
        self._emb: Optional[np.ndarray] = None
        self._tt_matrix: Optional[np.ndarray] = None
        self._dm_matrix: Optional[np.ndarray] = None
        self._gmask: Optional[np.ndarray] = None
        self._route_mat: Optional[np.ndarray] = None
        self._name_list: List[str] = []
        self._ivf: Optional[IVFIndex] = None
        self._dirty = True
        self._lock = make_lock("core.mres")

    # ---------------- registry ----------------
    def register(self, entry: ModelEntry) -> None:
        with self._lock:
            self._register_locked(entry)

    def register_many(self, entries: Sequence[ModelEntry]) -> None:
        """Bulk registration (one lock + one cache invalidation).

        Atomic: the whole list is validated and duplicate-checked
        before anything is committed, so a bad entry leaves the
        catalog untouched."""
        entries = list(entries)
        with self._lock:
            seen = set(self._names)
            for entry in entries:
                entry.validate()
                if entry.name in seen:
                    raise ValueError(f"duplicate model {entry.name!r}")
                seen.add(entry.name)
            self._names = seen
            for entry in entries:
                self._index[entry.name] = len(self._entries)
                self._entries.append(entry)
            self._dirty = True

    def _register_locked(self, entry: ModelEntry) -> None:
        entry.validate()
        if entry.name in self._names:
            raise ValueError(f"duplicate model {entry.name!r}")
        self._names.add(entry.name)
        self._index[entry.name] = len(self._entries)
        self._entries.append(entry)
        self._dirty = True

    def update_metrics(self, name: str, **raw_metrics: float) -> None:
        with self._lock:
            e = self._by_name(name)
            e.raw_metrics.update(raw_metrics)
            self._dirty = True

    def _by_name(self, name: str) -> ModelEntry:
        j = self._index.get(name)
        if j is None:
            raise KeyError(name)
        return self._entries[j]

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[ModelEntry]:
        return list(self._entries)

    def entry(self, name: str) -> ModelEntry:
        with self._lock:
            return self._by_name(name)

    # ---------------- embeddings & mask caches ----------------
    def _refresh_locked(self) -> None:
        if not (self._dirty or self._emb is None):
            return
        entries = self._entries
        n = len(entries)
        self._emb = normalize_catalog(entries)
        self._name_list = [e.name for e in entries]
        tt = np.zeros((len(TASK_TYPES) + 1, n), bool)
        for j, t in enumerate(TASK_TYPES):
            tt[j] = [t in e.task_types for e in entries]
        tt[-1] = True                          # "no task-type filter" row
        dm = np.zeros((len(DOMAINS) + 1, n), bool)
        for j, d in enumerate(DOMAINS):
            dm[j] = [d in e.domains for e in entries]
        dm[-1] = True                          # "no domain filter" row
        self._tt_matrix, self._dm_matrix = tt, dm
        self._gmask = np.array([e.generalist for e in entries], bool)
        A = np.zeros((n, ROUTE_COLS), np.float32)
        if n:
            en = np.sqrt(np.einsum("nm,nm->n", self._emb, self._emb)) + 1e-9
            A[:, :N_METRICS] = self._emb / en[:, None]
            A[:, TT_COL:DM_COL] = MASK_BONUS * tt.T
            A[:, DM_COL:BIAS_COL] = MASK_BONUS * dm.T
            A[:, BIAS_COL] = 1.0
        self._route_mat = A
        self._ivf = None            # rebuilt lazily on next ivf_index()
        self._dirty = False

    def embeddings(self) -> np.ndarray:
        """(n_models, N_METRICS) normalized metric matrix."""
        with self._lock:
            self._refresh_locked()
            return self._emb

    def snapshot(self) -> Tuple[np.ndarray, List[str], np.ndarray,
                                np.ndarray, np.ndarray, np.ndarray]:
        """One consistent view for the batched router:
        (embeddings, names, task-type matrix, domain matrix,
        generalist mask, fused routing matrix) — all under one lock."""
        with self._lock:
            self._refresh_locked()
            return (self._emb, self._name_list, self._tt_matrix,
                    self._dm_matrix, self._gmask, self._route_mat)

    def masks(self, task_type: Optional[str], domain: Optional[str]
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Hierarchical filter masks (task-type mask, domain mask) —
        row lookups into the cached stacked matrices."""
        with self._lock:
            self._refresh_locked()
            ti = TASK_TYPES.index(task_type) if task_type else -1
            di = DOMAINS.index(domain) if domain else -1
            return self._tt_matrix[ti].copy(), self._dm_matrix[di].copy()

    def generalist_mask(self) -> np.ndarray:
        with self._lock:
            self._refresh_locked()
            return self._gmask

    def ivf_index(self, n_cells: Optional[int] = None) -> IVFIndex:
        """The catalog's IVF pruned-search index (built lazily, cached
        until the next registration/metric update dirties the store —
        i.e. rebuilt at ``register_many`` granularity, not per query).
        ``n_cells`` defaults to ~sqrt(N); passing a different value
        rebuilds."""
        with self._lock:
            self._refresh_locked()
            n = len(self._entries)
            if n == 0:
                raise RuntimeError("empty MRES catalog")
            want = default_n_cells(n) if n_cells is None else \
                max(1, min(int(n_cells), n))
            if self._ivf is None or self._ivf.n_cells != want:
                self._ivf = build_ivf(self._emb, want)
            return self._ivf
