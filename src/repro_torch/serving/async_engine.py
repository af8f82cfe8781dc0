"""Asyncio front-end for the serving engine: async intake, micro-batch
aggregation, per-tenant fairness, and streaming responses (port of the
JAX package's ``serving/async_engine.py``).

The synchronous ``ServingEngine.submit`` is most efficient when handed
a BATCH: one fused ``route_all`` dispatch, one admission plan, one
grouped generate per model.  Real traffic arrives one request at a
time.  This module bridges the two:

* ``AsyncServingEngine.submit(request)`` is an awaitable that enqueues
  the request and resolves to its ``Response`` when its micro-batch
  completes.  A background flusher aggregates intake into windows of at
  most ``max_batch`` requests or ``max_wait_ms`` milliseconds —
  whichever closes first — and drives each window through the
  engine's single-dispatch route -> admit -> grouped-generate path on
  an executor thread, so the event loop never blocks on device work.

* Multi-tenant isolation happens at INTAKE, before a request can touch
  the router: each tenant has a ``TenantPolicy`` with a token-bucket
  rate limit (``rate``/``burst``), a backlog cap (``max_backlog``) and
  a fairness ``weight``.  Over-limit requests are rejected immediately
  with a shed ``Response`` (``error`` says why) — a flooding tenant
  exhausts its own bucket, not the shared catalog.  Dequeue is
  deficit-round-robin across tenant FIFOs, so when the aggregate
  backlog exceeds a window, tenants drain proportionally to their
  weights instead of first-come-first-flooded.

* ``stream(request)`` yields tokens as they decode, through a lazily
  built per-model ``ContinuousBatcher`` (fixed decode slots, shared KV
  cache) whose tick loop runs on the executor; concurrent streams to
  the same model share its slots.

``MicroBatcher`` (the intake/window/fair-dequeue core) is deliberately
clock-agnostic — every method takes ``now`` — so the soak harness can
replay hours-equivalent traffic in virtual time through EXACTLY the
aggregation logic production uses, and unit tests are deterministic.
"""
from __future__ import annotations

import asyncio
import threading
from collections import deque
from dataclasses import dataclass
from typing import (Any, AsyncIterator, Deque, Dict, List, Optional,
                    Sequence, Tuple)

from repro_torch.serving.engine import Request, Response, ServingEngine

__all__ = ["TokenBucket", "TenantPolicy", "MicroBatcher",
           "AsyncServingEngine", "DEFAULT_TENANT"]

DEFAULT_TENANT = "default"

# intake rejection reasons (Response.error on an intake shed)
REJECT_RATE = "rate-limited"
REJECT_BACKLOG = "backlog-full"


class TokenBucket:
    """Classic token bucket in caller-supplied time: ``rate`` tokens/s
    refill up to a ``burst`` ceiling; ``try_take`` spends one.  Clock-
    agnostic (pass ``now``), so rate limits replay identically in the
    virtual-time soak and in wall-clock serving."""

    def __init__(self, rate: float, burst: float):
        assert rate > 0 and burst > 0, (rate, burst)
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t: Optional[float] = None

    def try_take(self, now: float, n: float = 1.0) -> bool:
        if self._t is None:
            self._t = now
        if now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
            self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


@dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant intake knobs.

    ``weight``       fair-share weight for dequeue (DRR quantum);
    ``rate``         token-bucket refill, requests/s (None = unlimited);
    ``burst``        bucket depth (defaults to ``max(2 * rate, 1)``);
    ``max_backlog``  queued-request cap (None = unbounded) — beyond it
                     intake sheds instead of queueing unboundedly.
    """
    weight: float = 1.0
    rate: Optional[float] = None
    burst: Optional[float] = None
    max_backlog: Optional[int] = None

    def validate(self) -> "TenantPolicy":
        assert self.weight > 0, self.weight
        assert self.rate is None or self.rate > 0, self.rate
        assert self.burst is None or self.burst > 0, self.burst
        assert self.max_backlog is None or self.max_backlog > 0
        return self

    def make_bucket(self) -> Optional[TokenBucket]:
        if self.rate is None:
            return None
        return TokenBucket(self.rate,
                           self.burst if self.burst is not None
                           else max(2.0 * self.rate, 1.0))


class MicroBatcher:
    """Intake -> aggregation-window -> weighted-fair dequeue core.

    Requests are offered with a timestamp and buffered in per-tenant
    FIFOs.  A window is ``due`` when ``max_batch`` items are pending or
    the OLDEST pending item has waited ``max_wait_s``.  ``take`` drains
    up to ``max_batch`` items by deficit round-robin: each pass credits
    every backlogged tenant its policy weight, and a tenant spends one
    deficit unit per dequeued item — so over a sustained backlog,
    tenants drain in proportion to their weights regardless of arrival
    order.  Deficits reset when a tenant's queue empties (an idle
    tenant cannot bank credit).

    Thread-safe; every method takes an explicit ``now`` so the caller
    owns the clock (event loop, test, or virtual-time soak).
    """

    def __init__(self, *, max_batch: int = 32, max_wait_s: float = 0.005,
                 policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: TenantPolicy = TenantPolicy()):
        assert max_batch > 0 and max_wait_s >= 0.0
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.default_policy = default_policy.validate()
        self._policies = {t: p.validate()
                          for t, p in (policies or {}).items()}
        self._queues: Dict[str, Deque[Tuple[float, Any]]] = {}
        self._order: List[str] = []       # round-robin tenant order
        self._deficit: Dict[str, float] = {}
        self._buckets: Dict[str, Optional[TokenBucket]] = {}
        self._pending = 0
        self._lock = threading.Lock()
        # intake accounting per tenant: offered / queued / rate-limited
        # / backlog-shed (the async engine exports these as gauges)
        self.stats: Dict[str, Dict[str, int]] = {}

    def policy(self, tenant: str) -> TenantPolicy:
        return self._policies.get(tenant, self.default_policy)

    def _stats(self, tenant: str) -> Dict[str, int]:
        return self.stats.setdefault(
            tenant, {"offered": 0, "queued": 0, "rate_limited": 0,
                     "backlog_shed": 0})

    # ------------------------------------------------------------------
    def offer(self, tenant: str, item: Any, now: float) -> str:
        """Try to enqueue ``item`` for ``tenant`` at time ``now``.
        Returns ``"queued"`` on success, or the rejection reason
        (``"rate-limited"`` / ``"backlog-full"``) — rejected items are
        NOT buffered; the caller degrades them immediately."""
        with self._lock:
            st = self._stats(tenant)
            st["offered"] += 1
            if tenant not in self._queues:
                self._queues[tenant] = deque()
                self._order.append(tenant)
                self._deficit[tenant] = 0.0
                self._buckets[tenant] = self.policy(tenant).make_bucket()
            bucket = self._buckets[tenant]
            if bucket is not None and not bucket.try_take(now):
                st["rate_limited"] += 1
                return REJECT_RATE
            pol = self.policy(tenant)
            if (pol.max_backlog is not None
                    and len(self._queues[tenant]) >= pol.max_backlog):
                st["backlog_shed"] += 1
                return REJECT_BACKLOG
            self._queues[tenant].append((now, item))
            self._pending += 1
            st["queued"] += 1
            return "queued"

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def backlog(self) -> Dict[str, int]:
        """Current queued count per tenant (gauge view)."""
        with self._lock:
            return {t: len(q) for t, q in self._queues.items()}

    def _oldest_locked(self) -> Optional[float]:
        heads = [q[0][0] for q in self._queues.values() if q]
        return min(heads) if heads else None

    def due(self, now: float) -> bool:
        """True when a window should flush: the batch is full, or the
        oldest pending request has aged past the aggregation window."""
        with self._lock:
            if self._pending >= self.max_batch:
                return True
            oldest = self._oldest_locked()
            return (oldest is not None
                    and now - oldest >= self.max_wait_s)

    def next_deadline(self, now: float) -> Optional[float]:
        """Absolute time at which the current backlog becomes due
        (None when empty; may be <= ``now`` when already due)."""
        with self._lock:
            if self._pending == 0:
                return None
            if self._pending >= self.max_batch:
                return now
            oldest = self._oldest_locked()
            return oldest + self.max_wait_s if oldest is not None else None

    # ------------------------------------------------------------------
    def take(self, now: float, limit: Optional[int] = None) -> List[Any]:
        """Dequeue up to ``min(limit, max_batch)`` items by weighted
        deficit round-robin across backlogged tenants."""
        del now  # dequeue is instantaneous; signature mirrors offer()
        budget = self.max_batch if limit is None \
            else min(int(limit), self.max_batch)
        out: List[Any] = []
        with self._lock:
            active = [t for t in self._order if self._queues[t]]
            while len(out) < budget and active:
                for t in list(active):
                    q = self._queues[t]
                    # one weight quantum per pass; spend it greedily
                    self._deficit[t] += self.policy(t).weight
                    while q and self._deficit[t] >= 1.0 \
                            and len(out) < budget:
                        out.append(q.popleft()[1])
                        self._deficit[t] -= 1.0
                    if not q:
                        active.remove(t)
                        self._deficit[t] = 0.0  # no banked credit
                    if len(out) >= budget:
                        break
            self._pending -= len(out)
        return out


class AsyncServingEngine:
    """Event-loop front end over a synchronous ``ServingEngine``.

    One background flusher task owns the window clock: it sleeps until
    the batcher's next deadline, drains a window by weighted-fair
    dequeue, and runs ``engine.submit(window)`` on ``executor`` (the
    loop's default thread pool when None) — so at most one route/
    generate pass is in flight and the event loop stays responsive.
    Per-tenant backlog and intake counters are exported as telemetry
    gauges (``tenant_backlog{t}`` etc.) when the router carries a
    ``Telemetry``.

    Usage::

        aeng = AsyncServingEngine(engine, max_batch=32, max_wait_ms=5,
                                  policies={"acme": TenantPolicy(rate=50)})
        async with aeng:
            resp = await aeng.submit(Request(text=..., prefs=...,
                                             tenant="acme"))
    """

    def __init__(self, engine: ServingEngine, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0,
                 policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: TenantPolicy = TenantPolicy(),
                 executor=None, stream_slots: int = 4,
                 stream_ctx_len: int = 128):
        self.engine = engine
        self.batcher = MicroBatcher(max_batch=max_batch,
                                    max_wait_s=max_wait_ms / 1e3,
                                    policies=policies,
                                    default_policy=default_policy)
        self._executor = executor
        self._stream_slots = int(stream_slots)
        self._stream_ctx_len = int(stream_ctx_len)
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._running = False
        self.windows: List[int] = []      # flushed window sizes
        # streaming state: model -> (batcher, condition); plus the
        # driver task currently ticking that batcher (if any)
        self._stream_state: Dict[str, Tuple[Any, asyncio.Condition]] = {}
        self._stream_tasks: Dict[str, asyncio.Task] = {}

    # ---------------- lifecycle ----------------
    async def start(self) -> "AsyncServingEngine":
        if self._task is not None:
            return self
        self._wake = asyncio.Event()
        self._running = True
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self, *, drain: bool = True) -> None:
        """Stop the flusher.  ``drain=True`` (default) flushes the
        remaining backlog first so every accepted request resolves."""
        if self._task is None:
            return
        self._running = False
        if not drain:
            pending = self.batcher.take(0.0, limit=self.batcher.pending())
            while pending:
                for _, fut in pending:
                    if not fut.done():
                        fut.cancel()
                pending = self.batcher.take(
                    0.0, limit=self.batcher.pending())
        self._wake.set()
        await self._task
        self._task = None
        for t in list(self._stream_tasks.values()):
            await t

    async def __aenter__(self) -> "AsyncServingEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> bool:
        await self.stop()
        return False

    # ---------------- intake ----------------
    async def submit(self, request: Request) -> Response:
        """Enqueue one request; resolves when its window is served.
        Over-limit intake resolves IMMEDIATELY to a shed response
        (``admission="shed"``, ``error`` = reason) without touching
        the router."""
        if self._task is None:
            raise RuntimeError("AsyncServingEngine is not started — "
                               "use 'async with engine:' or await "
                               "start()")
        tenant = request.tenant or DEFAULT_TENANT
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        verdict = self.batcher.offer(tenant, (request, fut), loop.time())
        if verdict != "queued":
            return self._reject(request, tenant, verdict)
        self._wake.set()
        return await fut

    def _reject(self, request: Request, tenant: str,
                reason: str) -> Response:
        tel = self.router_telemetry()
        if tel is not None:
            tel.record_admission("shed", tenant=tenant)
            tel.inc(f"intake_{reason.replace('-', '_')}")
        resp = Response(request=request, model="", sig=None, tokens=None,
                        sim_latency_s=0.0, route_s=0.0, analyzer_s=0.0,
                        admission="shed", error=reason)
        self.engine.log.append(resp)
        return resp

    def router_telemetry(self):
        return getattr(self.engine.router, "telemetry", None)

    # ---------------- flusher ----------------
    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = loop.time()
            if self.batcher.pending() == 0:
                if not self._running:
                    break
                self._wake.clear()
                # re-check under the cleared event: an offer between
                # pending() and clear() also set the event, so no lost
                # wakeups
                if self.batcher.pending() == 0 and self._running:
                    await self._wake.wait()
                continue
            deadline = self.batcher.next_deadline(now)
            if self._running and deadline is not None and deadline > now:
                # batch not full and window still open: sleep until the
                # window closes or new intake arrives (which may fill
                # the batch early)
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           timeout=deadline - now)
                except asyncio.TimeoutError:
                    pass
                continue
            items = self.batcher.take(now)
            if items:
                await self._flush(items, loop)

    async def _flush(self, items: Sequence[Tuple[Request, asyncio.Future]],
                     loop) -> None:
        reqs = [r for r, _ in items]
        self.windows.append(len(reqs))
        tel = self.router_telemetry()
        if tel is not None:
            for t, n in self.batcher.backlog().items():
                tel.set_gauge(f"tenant_backlog_{t}", float(n))
            tel.set_gauge("window_size", float(len(reqs)))
        try:
            resps = await loop.run_in_executor(
                self._executor, self.engine.submit, reqs)
        except Exception as e:                     # noqa: BLE001
            # submit itself should degrade per group; anything that
            # still escapes (e.g. routing failure) fails THIS window's
            # futures, never the flusher loop
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (_, fut), resp in zip(items, resps):
            if not fut.done():
                fut.set_result(resp)

    # ---------------- streaming ----------------
    async def stream(self, request: Request) -> AsyncIterator[int]:
        """Yield tokens for one request as they decode.

        The request is routed individually (one fused single-row
        dispatch), then decoded through the routed model's shared
        ``ContinuousBatcher`` — concurrent streams to the same model
        interleave on its decode slots instead of serializing.  Models
        without a loaded runner (metrics-only catalog entries) cannot
        stream and raise ``ValueError``."""
        if self._task is None:
            raise RuntimeError("AsyncServingEngine is not started")
        from repro_torch.serving.scheduler import (ContinuousBatcher,
                                                   SlotRequest)

        eng = self.engine
        rq = eng.router.route_all([request.text], [request.prefs])[0]
        model = rq.model
        entry = eng.router.mres.entry(model)
        if entry.runner is None:
            raise ValueError(f"model {model!r} has no runner loaded — "
                             "streaming needs weights")
        if model not in self._stream_state:
            col = 0
            if eng.load is not None:
                names = eng.router.mres.snapshot()[1]
                col = {m: j for j, m in enumerate(names)}[model]
            cb = ContinuousBatcher(
                entry.runner.cfg, entry.runner.params,
                slots=self._stream_slots, ctx_len=self._stream_ctx_len,
                load=eng.load, model_idx=col, device=entry.runner.device)
            self._stream_state[model] = (cb, asyncio.Condition())
        cb, cond = self._stream_state[model]
        toks = eng._tokens([request.text],
                           entry.runner.cfg.vocab_size)[0]
        sr = SlotRequest(id=request.id, tokens=toks,
                         max_new=request.max_new)
        cb.submit(sr, truncate=True)
        self._ensure_stream_driver(model)
        sent = 0
        while True:
            async with cond:
                await cond.wait_for(
                    lambda: len(sr.out) > sent or sr.done
                    or sr in cb.cancelled)
            while sent < len(sr.out):
                yield sr.out[sent]
                sent += 1
            if sr.done or sr in cb.cancelled:
                return

    def _ensure_stream_driver(self, model: str) -> None:
        task = self._stream_tasks.get(model)
        if task is not None and not task.done():
            return
        self._stream_tasks[model] = \
            asyncio.get_running_loop().create_task(
                self._drive_stream(model))

    async def _drive_stream(self, model: str) -> None:
        cb, cond = self._stream_state[model]
        loop = asyncio.get_running_loop()
        while cb.queue_depth() > 0:
            await loop.run_in_executor(self._executor, cb.tick)
            async with cond:
                cond.notify_all()
        async with cond:
            cond.notify_all()
