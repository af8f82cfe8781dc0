"""Routing telemetry (production observability for the MLaaS use-case).

A thread-safe ledger the orchestrator/engine writes one event per
routed request into: model chosen, fallback kind, analyzer/route
latencies, simulated serving cost.  Exposes per-model aggregates,
fallback rates, stage-funnel statistics and a rolling-window QPS view —
what an operator needs to see that the router behaves in production.

Port of the JAX package's ``core/telemetry.py``, which imports nothing
of JAX; the port keeps its own copy with a plain ``threading.Lock``.

Memory is FIXED no matter how long the process serves: raw
events sit in a bounded ring (newest ``max_events`` kept, for
debugging/attribution), while everything reported — funnels, per-model
aggregates, latency/cost distributions, QPS — is maintained
incrementally in monotonic counters and fixed-bucket log histograms
(``obs.metrics.LogHistogram``).  ``summary()`` therefore reflects ALL
events ever recorded, not just the retained window, and no view
re-scans or re-quantiles raw lists under the lock.  Thumbs feedback
attaches O(1) via per-model pending stacks instead of an O(n) reverse
scan.  ``summary()`` takes ONE consistent snapshot under the lock.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional

from repro_torch.analysis.sanitize import make_lock
from repro_torch.obs.metrics import LogHistogram

# latency histograms cover 10us .. 100s at ~0.54% relative resolution;
# cost histograms cover 1e-3 .. 1e4 simulated-cost units
_LAT_RANGE = dict(lo=1e-5, hi=1e2, per_octave=128)
_COST_RANGE = dict(lo=1e-3, hi=1e4, per_octave=128)


@dataclass
class RouteEvent:
    ts: float
    model: str
    task_type: str
    domain: str
    complexity: float
    fallback: str = ""
    analyzer_s: float = 0.0
    route_s: float = 0.0
    sim_cost: float = 0.0
    thumbs: Optional[bool] = None


def _new_model_agg() -> Dict[str, Any]:
    return dict(requests=0, fallbacks=0, cost=0.0, route_s=0.0,
                thumbs_up=0, thumbs_down=0)


class Telemetry:
    def __init__(self, window_s: float = 60.0, max_events: int = 8192,
                 max_pending_thumbs: int = 512):
        self.window_s = window_s
        self.max_events = int(max_events)
        self.max_pending_thumbs = int(max_pending_thumbs)
        # bounded retention of raw events (debugging / attribution);
        # aggregates below are monotonic and cover ALL events
        self._events: Deque[RouteEvent] = \
            collections.deque(maxlen=self.max_events)
        self._events_total = 0
        self._fallbacks_total = 0
        self._fallback_funnel: Dict[str, int] = {}
        self._per_model: Dict[str, Dict[str, Any]] = {}
        self._model_lat: Dict[str, LogHistogram] = {}
        self._lat_hist = LogHistogram(**_LAT_RANGE)
        self._cost_hist = LogHistogram(**_COST_RANGE)
        # model -> stack of unrated events; thumbs pop the most recent
        self._pending: Dict[str, Deque[RouteEvent]] = {}
        # event timestamps for the rolling QPS window (pruned at read;
        # hard cap keeps memory bounded even if qps() is never called)
        self._qps_ts: Deque[float] = collections.deque(maxlen=65536)
        self._admissions: Dict[str, int] = {}
        # tenant -> {kind -> count}: the per-tenant admission funnel
        # (fairness dashboards key on this; bounded by tenant count)
        self._tenant_admissions: Dict[str, Dict[str, int]] = {}
        self._cache: Dict[str, int] = {}
        self._route_step: Dict[str, int] = {"dispatches": 0,
                                            "compiles": 0}
        self._analyze_step: Dict[str, int] = {"dispatches": 0,
                                              "compiles": 0}
        self._sharding: Dict[str, int] = {"silent_replications": 0}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._lock = make_lock("core.telemetry")

    # ------------------------------------------------------------------
    def record(self, event: RouteEvent) -> None:
        with self._lock:
            self._events.append(event)
            self._events_total += 1
            self._fallbacks_total += bool(event.fallback)
            self._fallback_funnel[event.fallback] = \
                self._fallback_funnel.get(event.fallback, 0) + 1
            a = self._per_model.get(event.model)
            if a is None:
                a = self._per_model[event.model] = _new_model_agg()
                self._model_lat[event.model] = LogHistogram(**_LAT_RANGE)
                self._pending[event.model] = collections.deque(
                    maxlen=self.max_pending_thumbs)
            a["requests"] += 1
            a["fallbacks"] += bool(event.fallback)
            a["cost"] += event.sim_cost
            a["route_s"] += event.route_s
            lat = event.analyzer_s + event.route_s
            self._model_lat[event.model].record(lat)
            self._lat_hist.record(lat)
            if event.sim_cost:
                self._cost_hist.record(event.sim_cost)
            self._pending[event.model].append(event)
            self._qps_ts.append(event.ts)

    def record_decision(self, rq, *, sim_cost: float = 0.0) -> None:
        """Convenience: log an orchestrator RoutedQuery.

        Reads the cheap array-backed accessors (``rq.model`` /
        ``rq.fallback_kind``) rather than ``rq.decision`` so logging a
        lazily-materialized batch row does not force the full decision
        object into existence."""
        self.record(RouteEvent(
            ts=time.time(), model=rq.model,
            task_type=rq.sig.task_type, domain=rq.sig.domain,
            complexity=rq.sig.complexity,
            fallback=rq.fallback_kind,
            analyzer_s=rq.analyzer_s, route_s=rq.route_s,
            sim_cost=sim_cost))

    def record_route_step(self, *, dispatches: int = 0,
                          compiles: int = 0) -> None:
        """Count fused routing-step device activity: ``dispatches`` is
        one per routed batch; ``compiles`` counts new executables of the
        bucketed program (see ``kernels/ops.route_step``).  Eager
        PyTorch compiles nothing, so the port reports 0 today; a
        captured CUDA graph per bucket will count as one.  A healthy
        steady-state serving stream shows dispatches growing linearly
        and compiles FLAT after the warmup batches."""
        with self._lock:
            self._route_step["dispatches"] += int(dispatches)
            self._route_step["compiles"] += int(compiles)

    def route_step_stats(self) -> Dict[str, int]:
        """Fused-dispatch counters: {dispatches, compiles}."""
        with self._lock:
            return dict(self._route_step)

    def record_analyze_step(self, *, dispatches: int = 0,
                            compiles: int = 0) -> None:
        """Count analyzer-stage device activity: one dispatch per
        analyzed batch, whether the analyzer ran alone
        (``ops.analyze_step``) or inside the fused analyze->route
        program (``ops.analyze_route_step``, which feeds BOTH counter
        families from its single dispatch).  Same health read as
        ``record_route_step``: compiles must go FLAT after warmup."""
        with self._lock:
            self._analyze_step["dispatches"] += int(dispatches)
            self._analyze_step["compiles"] += int(compiles)

    def analyze_step_stats(self) -> Dict[str, int]:
        """Analyzer-dispatch counters: {dispatches, compiles}."""
        with self._lock:
            return dict(self._analyze_step)

    def record_sharding(self, *, silent_replications: int = 0) -> None:
        """Count partition-spec fallbacks: ``silent_replications`` is
        how many times a sharded layout quietly replicated a tensor
        because its named axis did not divide the dim.  The
        production-mesh dry run (``launch/dryrun``) records here the
        fallbacks of ``sharding/rules.maybe`` counted around each pair's
        spec construction, as the reference's does; the summary and
        export keys are the reference's."""
        with self._lock:
            self._sharding["silent_replications"] += \
                int(silent_replications)

    def sharding_stats(self) -> Dict[str, int]:
        """Partition-spec fallback counters: {silent_replications}."""
        with self._lock:
            return dict(self._sharding)

    def record_admission(self, kind: str, count: int = 1, *,
                         tenant: Optional[str] = None) -> None:
        """Count one admission outcome (``admitted`` / ``rerouted`` /
        ``shed`` / ``failed`` — see ``repro_torch.serving.load``).  ``tenant``
        additionally attributes the outcome to a per-tenant funnel so
        fairness (who gets shed when the system saturates) is
        observable per customer, not just in aggregate."""
        with self._lock:
            self._admissions[kind] = self._admissions.get(kind, 0) + count
            if tenant is not None:
                t = self._tenant_admissions.setdefault(tenant, {})
                t[kind] = t.get(kind, 0) + count

    def admission_funnel(self) -> Dict[str, int]:
        """Admission outcome counts: how much traffic was admitted as
        routed, rerouted to a lower-ranked candidate to make its SLO,
        shed as a guaranteed miss, or failed at generation time."""
        with self._lock:
            return dict(self._admissions)

    def admission_by_tenant(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant admission funnels: ``{tenant: {kind: count}}``
        for every outcome recorded with a tenant attribution."""
        with self._lock:
            return {t: dict(k) for t, k in self._tenant_admissions.items()}

    def record_cache(self, kind: str, count: int = 1) -> None:
        """Count one semantic-cache outcome (``hit`` / ``miss`` at
        lookup, ``stored`` / ``rejected`` at write-back — see
        ``repro_torch.cache.semantic.CACHE_KINDS``)."""
        with self._lock:
            self._cache[kind] = self._cache.get(kind, 0) + count

    def cache_funnel(self) -> Dict[str, int]:
        """Semantic-cache outcome counts with a STABLE key set: every
        kind in ``repro_torch.cache.semantic.CACHE_KINDS`` is always present (zeroed
        on an empty engine), so dashboards and tests can key into the
        funnel without existence checks."""
        from repro_torch.cache.semantic import CACHE_KINDS
        with self._lock:
            return {k: self._cache.get(k, 0) for k in CACHE_KINDS}

    def inc(self, name: str, amount: float = 1.0) -> None:
        """Bump a generic monotonic counter (exported as-is)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + amount

    def set_gauge(self, name: str, value: float) -> None:
        """Set a generic point-in-time gauge (exported as-is)."""
        with self._lock:
            self._gauges[name] = float(value)

    def attach_thumbs(self, model: str, thumbs_up: bool) -> None:
        """Attach feedback to the MOST RECENT unrated event for
        ``model``.  O(1): each model keeps a bounded stack of unrated
        events, so feedback on a long history never rescans the ring."""
        with self._lock:
            stack = self._pending.get(model)
            if not stack:
                return
            e = stack.pop()
            e.thumbs = thumbs_up
            a = self._per_model[model]
            if thumbs_up:
                a["thumbs_up"] += 1
            else:
                a["thumbs_down"] += 1

    # ------------------------------------------------------------------
    # views (all incremental — no event rescans)
    # ------------------------------------------------------------------
    def _per_model_locked(self) -> Dict[str, Dict[str, float]]:
        agg: Dict[str, Dict[str, float]] = {}
        for m, a in self._per_model.items():
            out = dict(a)
            out["fallback_rate"] = out["fallbacks"] / max(
                out["requests"], 1)
            n_fb = out["thumbs_up"] + out["thumbs_down"]
            out["satisfaction"] = (out["thumbs_up"] / n_fb) \
                if n_fb else None
            # per-model routing-latency distribution, not just means:
            # operators alarm on tails, and means hide queueing spikes
            h = self._model_lat[m]
            out["latency_p50_s"] = h.quantile(0.5)
            out["latency_p99_s"] = h.quantile(0.99)
            agg[m] = out
        return agg

    def per_model(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return self._per_model_locked()

    def fallback_rate(self) -> float:
        with self._lock:
            if not self._events_total:
                return 0.0
            return self._fallbacks_total / self._events_total

    def fallback_funnel(self) -> Dict[str, int]:
        """Routed-request counts per fallback ladder stage.

        Keys follow ``routing.FALLBACK_LADDER`` ('' = primary fused-kNN
        hit); only stages that occurred appear.  The operator's view of
        how far down the ladder traffic is falling."""
        with self._lock:
            return dict(self._fallback_funnel)

    def qps(self, now: Optional[float] = None) -> float:
        """Requests/s over ``(now - window_s, now]``.  Prunes the
        timestamp deque as it reads (assumes ``now`` values are
        non-decreasing across calls, which wall clocks are)."""
        now = now if now is not None else time.time()
        cutoff = now - self.window_s
        with self._lock:
            ts = self._qps_ts
            while ts and ts[0] <= cutoff:
                ts.popleft()
            n = len(ts)
        return n / self.window_s

    def _latency_percentiles_locked(self, q) -> Dict[str, float]:
        return {f"p{int(x * 100)}": self._lat_hist.quantile(x)
                for x in q}

    def latency_percentiles(self, q=(0.5, 0.9, 0.99)) -> Dict[str, float]:
        with self._lock:
            return self._latency_percentiles_locked(q)

    def latency_totals(self) -> Dict[str, float]:
        """{count, sum, min, max} of the route latency distribution."""
        with self._lock:
            return self._lat_hist.snapshot()

    def cost_totals(self) -> Dict[str, float]:
        """{count, sum, min, max} of the per-request simulated cost."""
        with self._lock:
            return self._cost_hist.snapshot()

    def summary(self) -> Dict[str, Any]:
        """ONE consistent snapshot of every view, taken under the lock
        (a concurrent ``record`` lands either wholly before or wholly
        after it — funnels, totals and per-model counts always agree)."""
        from repro_torch.cache.semantic import CACHE_KINDS
        with self._lock:
            lat_p = self._latency_percentiles_locked((0.5, 0.9, 0.99))
            return {
                "events": self._events_total,
                "fallback_rate": (self._fallbacks_total
                                  / self._events_total
                                  if self._events_total else 0.0),
                "fallback_funnel": dict(self._fallback_funnel),
                "admission_funnel": dict(self._admissions),
                "admission_by_tenant": {
                    t: dict(k)
                    for t, k in self._tenant_admissions.items()},
                "cache_funnel": {k: self._cache.get(k, 0)
                                 for k in CACHE_KINDS},
                "route_step": dict(self._route_step),
                "analyze_step": dict(self._analyze_step),
                "sharding": dict(self._sharding),
                "latency": lat_p,
                "latency_percentiles": lat_p,
                "latency_totals": self._lat_hist.snapshot(),
                "cost_totals": self._cost_hist.snapshot(),
                "qps": len(self._qps_ts) / self.window_s,
                "per_model": self._per_model_locked(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
            }
