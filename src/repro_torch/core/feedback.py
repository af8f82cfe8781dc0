"""User feedback loop (paper §3.5).

Thumbs-up/down per (task cluster, model) maintained as a bounded
exponential moving average in [-1, 1].  The Routing Engine adds
``feedback_weight * bias`` at scoring time, so positive feedback
reinforces a routing path and negative feedback depresses it.

A task cluster is (task_type, domain, complexity bucket) — the
granularity at which the paper's policy review operates.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.analysis.sanitize import make_lock
from repro_torch.core.preferences import DOMAINS, TASK_TYPES, TaskSignature

Cluster = Tuple[str, str, int]


def cluster_of(sig: TaskSignature, buckets: int = 4) -> Cluster:
    b = min(int(sig.complexity * buckets), buckets - 1)
    return (sig.task_type, sig.domain, b)


@dataclass
class FeedbackEvent:
    cluster: Cluster
    model: str
    thumbs_up: bool


class FeedbackStore:
    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._bias: Dict[Tuple[Cluster, str], float] = {}
        self._count: Dict[Tuple[Cluster, str], int] = {}
        self._log: List[FeedbackEvent] = []
        self._version = 0
        self._tables: Dict[Tuple, np.ndarray] = {}
        self._lock = make_lock("core.feedback")

    def record(self, sig: TaskSignature, model: str, thumbs_up: bool) -> float:
        """EMA update; returns the new bias (always within [-1, 1])."""
        c = cluster_of(sig)
        key = (c, model)
        target = 1.0 if thumbs_up else -1.0
        with self._lock:
            old = self._bias.get(key, 0.0)
            new = (1 - self.alpha) * old + self.alpha * target
            self._bias[key] = float(np.clip(new, -1.0, 1.0))
            self._count[key] = self._count.get(key, 0) + 1
            self._log.append(FeedbackEvent(c, model, thumbs_up))
            self._version += 1
            self._tables.clear()
            return self._bias[key]

    def version(self) -> int:
        """Monotonic mutation counter — bumped by ``record`` and
        ``load_state``.  Lets callers detect staleness of anything
        derived from the bias map without diffing it."""
        with self._lock:
            return self._version

    def bias_table(self, models: Sequence[str],
                   buckets: int = 4) -> np.ndarray:
        """Dense (len(TASK_TYPES) * len(DOMAINS) * buckets, N) bias
        table for the fused routing path: row
        ``(tt_idx * len(DOMAINS) + dm_idx) * buckets + cb`` holds the
        per-model biases of cluster ``(TASK_TYPES[tt_idx],
        DOMAINS[dm_idx], cb)`` — the same raw-predicted cluster
        ``cluster_of`` keys on (confidence thresholding never enters
        the feedback cluster).

        Memoized per (version, models, buckets): the returned array's
        *identity* is stable until feedback actually changes, so the
        device-side padded copy in ``kernels.ops`` caches on ``id()``
        and steady-state serving re-ships nothing.
        """
        with self._lock:
            key = (self._version, tuple(models), int(buckets))
            table = self._tables.get(key)
            if table is not None:
                return table
            n_tt, n_dm = len(TASK_TYPES), len(DOMAINS)
            table = np.zeros((n_tt * n_dm * buckets, len(models)),
                             np.float32)
            if self._bias:
                tt_row = {t: i for i, t in enumerate(TASK_TYPES)}
                dm_row = {d: i for i, d in enumerate(DOMAINS)}
                name_col = {m: j for j, m in enumerate(models)}
                for ((t, d, cb), m), v in self._bias.items():
                    ti, di, j = tt_row.get(t), dm_row.get(d), \
                        name_col.get(m)
                    if ti is None or di is None or j is None \
                            or not 0 <= cb < buckets:
                        continue
                    table[(ti * n_dm + di) * buckets + cb, j] = v
            if len(self._tables) >= 4:
                self._tables.clear()
            self._tables[key] = table
            return table

    def has_bias(self) -> bool:
        """True when ANY (cluster, model) bias is recorded — the fused
        routing path skips shipping a (B, N) zero matrix to the device
        while the store is empty (the common cold-start state)."""
        with self._lock:
            return bool(self._bias)

    def bias(self, sig: TaskSignature, models: Sequence[str]) -> np.ndarray:
        c = cluster_of(sig)
        with self._lock:
            return np.array([self._bias.get((c, m), 0.0) for m in models],
                            np.float32)

    def bias_batch(self, sigs: Sequence[TaskSignature],
                   models: Sequence[str]) -> np.ndarray:
        """(B, N) bias matrix for the batched routing path.

        Cost is O(B + |store| + unique_clusters * hits) — rows sharing a
        task cluster are filled once and broadcast, and clusters with no
        recorded feedback stay at the zero default.
        """
        out = np.zeros((len(sigs), len(models)), np.float32)
        clusters: Dict[Cluster, List[int]] = {}
        for i, s in enumerate(sigs):
            clusters.setdefault(cluster_of(s), []).append(i)
        with self._lock:
            if not self._bias:
                return out
            name_col = {m: j for j, m in enumerate(models)}
            hits: Dict[Cluster, List[Tuple[int, float]]] = {}
            for (c, m), v in self._bias.items():
                j = name_col.get(m)
                if j is not None and c in clusters:
                    hits.setdefault(c, []).append((j, v))
        for c, rows in clusters.items():
            pairs = hits.get(c)
            if not pairs:
                continue
            row = np.zeros(len(models), np.float32)
            for j, v in pairs:
                row[j] = v
            out[rows] = row
        return out

    def bias_for(self, sigs: Sequence[TaskSignature],
                 models: Sequence[str], idx: np.ndarray) -> np.ndarray:
        """(B, k) bias at the candidate columns ``idx`` (B, k).

        The routing hot path only scores <= k candidates per query, so
        this gathers B * k dict entries instead of materializing the
        full (B, N) matrix ``bias_batch`` builds.
        """
        out = np.zeros(idx.shape, np.float32)
        with self._lock:
            if not self._bias:
                return out
            get = self._bias.get
            for b, (sig, row) in enumerate(zip(sigs, idx.tolist())):
                c = cluster_of(sig)
                out[b] = [get((c, models[j]), 0.0) for j in row]
        return out

    def events(self) -> List[FeedbackEvent]:
        with self._lock:
            return list(self._log)

    # ---- persistence (part of the production story) ----
    def state(self) -> List[Dict]:
        """JSON-able snapshot of every (cluster, model) bias — the
        payload ``save`` writes and ``RouterState`` embeds."""
        with self._lock:
            return [{"cluster": list(k[0]), "model": k[1], "bias": v,
                     "count": self._count.get(k, 0)}
                    for k, v in self._bias.items()]

    def load_state(self, data: List[Dict]) -> None:
        """Restore a ``state()`` snapshot, REPLACING in-memory biases
        (same replace semantics as ``load``)."""
        bias = {}
        count = {}
        for row in data:
            key = (tuple(row["cluster"]), row["model"])
            bias[key] = float(row["bias"])
            count[key] = int(row["count"])
        with self._lock:
            self._bias = bias
            self._count = count
            self._version += 1
            self._tables.clear()

    def save(self, path: str) -> None:
        """Atomic snapshot: a crash or a concurrent reader never sees a
        partially-written file (write-temp + rename)."""
        data = self.state()
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".feedback-",
                                   suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            # mkstemp creates 0600; keep the target's mode (or the
            # umask default) so external readers stay able to read it
            try:
                mode = os.stat(path).st_mode & 0o777
            except FileNotFoundError:
                um = os.umask(0)
                os.umask(um)
                mode = 0o666 & ~um
            os.chmod(tmp, mode)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise

    def load(self, path: str) -> None:
        """Restore a ``save`` snapshot, REPLACING any in-memory state
        (loading into a live store must not splice stale entries into
        the snapshot's)."""
        with open(path) as f:
            self.load_state(json.load(f))
