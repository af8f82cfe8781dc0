"""Live per-model capacity signals for load- and SLO-aware routing.

The static router scores catalog metrics plus learned rewards; nothing
in that blend knows that the best-scoring model currently has forty
requests queued on four decode slots.  ``LoadTracker`` closes that gap:
one tracker per serving deployment maintains the live serving state of
every catalog model as packed ``(N,)`` arrays —

  queue      (N,) int64    admitted but not yet executing
  inflight   (N,) int64    currently occupying a decode slot
  capacity   (N,) float32  parallel decode slots (heterogeneous)
  ewma_s     (N,) float32  EWMA per-request service time (seconds)

so the routing hot path reads expected-wait estimates as one vectorized
gather.  The canonical lifecycle per request is

    admit(model) -> start(model) -> finish(model, service_s)

(queue += 1, queue -= 1 / inflight += 1, inflight -= 1 + EWMA fold).

Two derived views feed the router:

* ``estimated_wait_s`` — expected queueing delay before a new arrival
  starts executing: zero while a free slot exists
  (``queue + inflight < capacity``), else the completions that must
  land before it starts (``queue + inflight - capacity + 1``) drained
  at ``capacity`` requests per service time;
* ``penalty`` — the wait estimate squashed through ``w / (w + tau)``
  into [0, 1), so it joins the O(1)-scale score blend at the
  ``load_weight`` knob without a saturated model driving scores to
  -inf.  ``tau`` is the wait (seconds) at which the penalty reaches
  0.5 — an SLO-scale constant, not a tuning knob.

Thread-safe: the serving engine mutates counters from request threads
while the router snapshots them per batch.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.sanitize import make_lock

# admission outcomes (telemetry funnel keys), in severity order:
# admitted/rerouted/shed are decided at admission time (plan_admission);
# failed is decided at generation time — the request WAS admitted and
# consumed slot lifecycle, but its model group's generate raised
ADMISSION_KINDS = ("admitted", "rerouted", "shed", "failed")


class LoadTracker:
    def __init__(self, n_models: int = 0, *, capacity: float = 4.0,
                 ewma_alpha: float = 0.3, default_service_s: float = 0.05,
                 tau_s: float = 0.25):
        assert 0.0 < ewma_alpha <= 1.0, ewma_alpha
        self.ewma_alpha = float(ewma_alpha)
        self.default_service_s = float(default_service_s)
        self.tau_s = float(tau_s)
        self._default_capacity = float(capacity)
        self._lock = make_lock("serving.load")
        self.n_models = 0
        self.queue = np.zeros(0, np.int64)
        self.inflight = np.zeros(0, np.int64)
        self.capacity = np.zeros(0, np.float32)
        self.ewma_s = np.zeros(0, np.float32)
        self.ensure(n_models)

    # ---------------- capacity ----------------
    def ensure(self, n_models: int,
               capacity: Optional[Sequence[float]] = None) -> None:
        """Grow to ``n_models`` arms (catalog growth, e.g. merging).

        ``capacity`` optionally sets the NEW arms' slot counts — either
        a new-arms-only ``(grow,)`` vector or a full-length
        ``(n_models,)`` vector (callers naturally hold the whole
        catalog's capacities; the tail covers the new arms and existing
        arms keep theirs).  A no-op when already at ``n_models``."""
        with self._lock:
            if n_models <= self.n_models:
                return
            grow = n_models - self.n_models
            if capacity is None:
                cap = np.full(grow, self._default_capacity, np.float32)
            else:
                cap = np.asarray(capacity, np.float32).reshape(-1)
                if cap.size == n_models:
                    cap = cap[self.n_models:]
                elif cap.size != grow:
                    raise ValueError(
                        f"capacity must have {grow} (new arms) or "
                        f"{n_models} (full catalog) entries, got "
                        f"{cap.size}")
            assert (cap > 0).all(), cap
            self.queue = np.concatenate([self.queue,
                                         np.zeros(grow, np.int64)])
            self.inflight = np.concatenate([self.inflight,
                                            np.zeros(grow, np.int64)])
            self.capacity = np.concatenate([self.capacity, cap])
            self.ewma_s = np.concatenate(
                [self.ewma_s,
                 np.full(grow, self.default_service_s, np.float32)])
            self.n_models = n_models

    def set_capacity(self, idx: int, capacity: float) -> None:
        with self._lock:
            assert capacity > 0, capacity
            self.capacity[idx] = capacity

    def reset(self) -> None:
        with self._lock:
            self.queue[:] = 0
            self.inflight[:] = 0
            self.ewma_s[:] = self.default_service_s

    # ---------------- lifecycle ----------------
    def admit(self, idx: int, count: int = 1) -> None:
        with self._lock:
            self.queue[idx] += count

    def admit_many(self, model_idx: np.ndarray) -> None:
        """Vectorized admit for one routed batch (bincount fold)."""
        model_idx = np.asarray(model_idx, np.int64)
        if model_idx.size == 0:
            return
        with self._lock:
            self.queue += np.bincount(model_idx, minlength=self.n_models)

    def start(self, idx: int, count: int = 1) -> None:
        with self._lock:
            self.queue[idx] = max(self.queue[idx] - count, 0)
            self.inflight[idx] += count

    def finish(self, idx: int, service_s: Optional[float] = None,
               count: int = 1) -> None:
        """Retire ``count`` requests; fold their (mean) realized service
        time into the EWMA when provided."""
        with self._lock:
            self.inflight[idx] = max(self.inflight[idx] - count, 0)
            if service_s is not None and service_s >= 0.0:
                a = self.ewma_alpha
                self.ewma_s[idx] = (1.0 - a) * self.ewma_s[idx] \
                    + a * float(service_s)

    def cancel(self, idx: int, *, queued: int = 0, inflight: int = 0
               ) -> None:
        """Roll back counters for ABANDONED requests: work that was
        admitted (and possibly started) but will never finish — e.g. a
        scheduler giving up on its backlog at ``max_ticks``.  Unlike
        ``finish`` this never folds an EWMA sample (no service
        happened), and it decrements the queue directly (the request
        never started).  Clamped at zero."""
        assert queued >= 0 and inflight >= 0, (queued, inflight)
        with self._lock:
            self.queue[idx] = max(self.queue[idx] - queued, 0)
            self.inflight[idx] = max(self.inflight[idx] - inflight, 0)

    # ---------------- derived views ----------------
    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """(queue, inflight, capacity, ewma_s) copies under one lock."""
        with self._lock:
            return (self.queue.copy(), self.inflight.copy(),
                    self.capacity.copy(), self.ewma_s.copy())

    @staticmethod
    def _wait_of(ahead: np.ndarray, c: np.ndarray, s: np.ndarray
                 ) -> np.ndarray:
        """Expected start delay given ``ahead`` outstanding requests on
        ``c`` slots at EWMA service time ``s``: zero while a free slot
        exists (``ahead < c``); otherwise ``ahead - c + 1`` completions
        must land first, draining at ``c`` per service time."""
        return np.maximum(ahead - c + 1.0, 0.0) / c * s

    def estimated_wait_s(self, cols: Optional[np.ndarray] = None
                         ) -> np.ndarray:
        """(C,) expected queueing delay before a NEW arrival starts.
        Zero until ``queue + inflight >= capacity`` — idle slots mean
        immediate start, so a single in-flight request on a multi-slot
        model is never penalized over an idle one."""
        q, f, c, s = self.snapshot()
        w = self._wait_of(q + f, c, s).astype(np.float32)
        return w if cols is None else w[np.asarray(cols)]

    def estimated_latency_s(self, cols: Optional[np.ndarray] = None,
                            extra: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """(C,) expected wait + service for a new arrival.

        ``extra`` (N,) adds not-yet-committed request counts on top of
        the tracked queue — the admission planner passes the requests
        it has already placed earlier in the SAME batch, so request
        #50 of a burst sees the 49 placements ahead of it instead of a
        frozen pre-batch snapshot."""
        q, f, c, s = self.snapshot()
        ahead = q + f if extra is None else q + f + np.asarray(extra)
        lat = (self._wait_of(ahead, c, s) + s).astype(np.float32)
        return lat if cols is None else lat[np.asarray(cols)]

    def penalty(self, cols: Optional[np.ndarray] = None) -> np.ndarray:
        """(C,) saturating load penalty in [0, 1): expected wait
        squashed through w / (w + tau).  This is the term
        ``RoutingEngine`` blends at ``load_weight``."""
        w = self.estimated_wait_s(cols)
        return (w / (w + self.tau_s)).astype(np.float32)

    def metrics(self, names: Optional[Sequence[str]] = None) -> dict:
        """Gauge view for the Prometheus export: per-model queue depth,
        inflight count, capacity and EWMA service time, keyed by model
        name when ``names`` is given (else by column index)."""
        q, f, c, s = self.snapshot()
        keys = [str(i) for i in range(self.n_models)] \
            if names is None else [str(m) for m in names[:self.n_models]]
        keys += [str(i) for i in range(len(keys), self.n_models)]
        return {
            "queue_depth": {k: int(v) for k, v in zip(keys, q)},
            "inflight": {k: int(v) for k, v in zip(keys, f)},
            "capacity": {k: float(v) for k, v in zip(keys, c)},
            "ewma_service_s": {k: float(v) for k, v in zip(keys, s)},
        }

    # ---------------- persistence (RouterState) ----------------
    def state(self) -> dict:
        """Packed-array snapshot for a router checkpoint:
        one consistent copy of every per-arm array under the lock."""
        with self._lock:
            return {"queue": self.queue.copy(),
                    "inflight": self.inflight.copy(),
                    "capacity": self.capacity.copy(),
                    "ewma_s": self.ewma_s.copy()}

    def load_state(self, state: dict) -> None:
        """Restore a ``state()`` snapshot, REPLACING live counters.

        Restores every array bit-exactly (so penalties — and therefore
        routing — resume where the snapshot left off).  A restarted
        process whose in-flight work died with it can follow up with
        ``reset()`` to zero the transient queue/inflight counters while
        keeping the learned EWMAs and capacities."""
        cap = np.asarray(state["capacity"], np.float32)
        assert (cap > 0).all(), cap
        with self._lock:
            self.queue = np.asarray(state["queue"], np.int64).copy()
            self.inflight = np.asarray(state["inflight"], np.int64).copy()
            self.capacity = cap.copy()
            self.ewma_s = np.asarray(state["ewma_s"], np.float32).copy()
            self.n_models = int(self.queue.shape[0])


# ----------------------------------------------------------------------
# deadline-aware admission (shared by ServingEngine and the simulator)
# ----------------------------------------------------------------------

def plan_admission(decision, load: Optional[LoadTracker],
                   col_of, deadline_ms: Optional[float],
                   pending: Optional[np.ndarray] = None
                   ) -> Tuple[str, str, float]:
    """Decide how to serve one routed request against its SLO.

    ``decision`` is a RoutingDecision (model + ranked candidates),
    ``col_of`` maps model name -> catalog column, ``deadline_ms`` the
    request's latency SLO (None = no SLO).  ``pending`` (N,) counts
    requests the caller has already planned onto each model earlier in
    the same batch (not yet admitted to the tracker) so a burst cannot
    be waved through — or rerouted onto one alternate — against a
    frozen snapshot.  Returns ``(model, kind, est_latency_s)`` with
    kind in ``ADMISSION_KINDS``:

      * admitted — the routed model's estimated wait+service fits;
      * rerouted — it does not, but a lower-ranked candidate's does
        (first fit in score order: second choice before third, ...);
      * shed     — no candidate can meet the deadline; the caller
        should fail fast rather than burn a slot on a guaranteed miss.

    Without a tracker or deadline every request is simply admitted.
    """
    model = decision.model
    if load is None or deadline_ms is None:
        return model, "admitted", 0.0
    budget_s = float(deadline_ms) / 1e3
    cand = [m for m, _ in decision.candidates] or [model]
    if model not in cand:
        cand.insert(0, model)
    cols = np.array([col_of[m] for m in cand])
    est = load.estimated_latency_s(cols, extra=pending)
    if est[0] <= budget_s:
        return model, "admitted", float(est[0])
    fits = np.flatnonzero(est <= budget_s)
    if fits.size:
        j = int(fits[0])
        return cand[j], "rerouted", float(est[j])
    # guaranteed miss everywhere: report the least-bad estimate
    j = int(np.argmin(est))
    return cand[j], "shed", float(est[j])
