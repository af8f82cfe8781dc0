"""Fixed-memory metric primitives: counters, gauges, log histograms.

Port of the JAX package's ``obs/metrics.py`` (it imports nothing of
JAX; the port keeps its own copy).  Instead of keeping every event and
re-quantiling the raw list under a lock, a ``LogHistogram`` is a fixed
array of log-spaced buckets (HDR-histogram style) — O(1) record, O(1)
memory, mergeable, with quantile estimates whose relative error is
bounded by the bucket width.  At the default 128 buckets/octave the
bucket width is ``2**(1/128) - 1`` ~ 0.54%, comfortably inside the 1%
tolerances the telemetry tests assert.

Quantile estimation: cumulative counts + searchsorted for the target
rank, linear interpolation within the landing bucket, and the estimate
clamped to the observed ``[min, max]`` — which makes single-sample
quantiles *exact* (p50 == p99 == the sample) and keeps estimates from
drifting outside the data range at the edges.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np

from repro_torch.analysis.sanitize import make_lock


class Counter:
    """Monotonic counter with optional single-label children."""
    __slots__ = ("name", "help", "_vals", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._vals: Dict[str, float] = {}
        self._lock = make_lock("obs.metrics.counter")

    def inc(self, amount: float = 1.0, label: str = "") -> None:
        assert amount >= 0, amount
        with self._lock:
            self._vals[label] = self._vals.get(label, 0.0) + amount

    def value(self, label: str = "") -> float:
        with self._lock:
            return self._vals.get(label, 0.0)

    def items(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)


class Gauge:
    """Point-in-time value (load depth, qps, ...)."""
    __slots__ = ("name", "help", "_vals", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._vals: Dict[str, float] = {}
        self._lock = make_lock("obs.metrics.gauge")

    def set(self, value: float, label: str = "") -> None:
        with self._lock:
            self._vals[label] = float(value)

    def value(self, label: str = "") -> float:
        with self._lock:
            return self._vals.get(label, 0.0)

    def items(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)


class LogHistogram:
    """Log-spaced fixed-bucket histogram over ``(0, inf)`` values.

    Buckets cover ``[lo, hi)`` at ``per_octave`` buckets per factor-of-2;
    values below ``lo`` land in the underflow bucket (index 0), values
    at/above ``hi`` in the overflow bucket (index -1).  Records are two
    integer ops and an array increment — no allocation, no sort.

    NOT internally locked: the owner (Telemetry) already serializes
    writers; standalone users should wrap access in their own lock.
    """
    __slots__ = ("lo", "hi", "per_octave", "_inv_ln2", "nbuckets",
                 "counts", "count", "total", "vmin", "vmax", "_edges")

    def __init__(self, lo: float = 1e-5, hi: float = 1e2,
                 per_octave: int = 128):
        assert 0 < lo < hi and per_octave > 0
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_octave = int(per_octave)
        self._inv_ln2 = per_octave / math.log(2.0)
        n_core = int(math.ceil(math.log(hi / lo, 2.0) * per_octave))
        self.nbuckets = n_core + 2              # + underflow + overflow
        self.counts = np.zeros(self.nbuckets, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        # geometric bucket edges; edge[i] is the lower bound of core
        # bucket i (used for interpolation at quantile time)
        self._edges = lo * np.exp2(np.arange(n_core + 1) / per_octave)

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self.nbuckets - 1
        return 1 + int(math.log(v / self.lo) * self._inv_ln2)

    def record(self, v: float) -> None:
        v = float(v)
        if v <= 0.0:
            # zero/negative durations: count them against the
            # underflow bucket so quantiles stay mass-consistent
            self.counts[0] += 1
        else:
            self.counts[min(self._index(v), self.nbuckets - 1)] += 1
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
        self.count += 1
        self.total += max(v, 0.0)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        assert (self.lo, self.hi, self.per_octave) == \
               (other.lo, other.hi, other.per_octave), "bucket mismatch"
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        if not math.isfinite(self.vmin):        # only non-positive values
            return 0.0
        cum = np.cumsum(self.counts)
        target = q * self.count
        idx = int(np.searchsorted(cum, target, side="left"))
        idx = min(idx, self.nbuckets - 1)
        if idx == 0 or idx == self.nbuckets - 1:
            # under/overflow bucket: best estimate is the clamp below
            est = self.vmin if idx == 0 else self.vmax
        else:
            lo_e = self._edges[idx - 1]
            hi_e = self._edges[idx]
            prev = cum[idx - 1]
            inbucket = self.counts[idx]
            frac = (target - prev) / inbucket if inbucket else 0.0
            est = lo_e + (hi_e - lo_e) * min(max(frac, 0.0), 1.0)
        # clamping to the observed range makes single-sample quantiles
        # exact and pins estimates inside the data
        return float(min(max(est, self.vmin), self.vmax))

    def quantiles(self, qs: Iterable[float]) -> Tuple[float, ...]:
        return tuple(self.quantile(q) for q in qs)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if math.isfinite(self.vmax) else 0.0}
