"""Continuous-batching scheduler (vLLM-style, simplified to fixed slots;
port of the JAX package's ``serving/scheduler.py``).

One scheduler per routed model: a fixed number of decode SLOTS share a
persistent KV/SSD cache on the model's device.  Arriving requests are
prefilled one at a time into a free slot (their cache is written into
the slot's row), and all slots decode together on every tick at their
own positions -- so short requests retire and hand their slot to queued
work without ever stalling long ones.  Idle slots decode too, as in the
reference; their rows touch only their own cache row, and a row at a
position past the cache writes nothing (``layers.attention_decode``).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.analysis.sanitize import make_lock
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training.steps import make_decode_step


@dataclass
class SlotRequest:
    id: int
    tokens: np.ndarray               # (L,) prompt
    max_new: int
    out: List[int] = field(default_factory=list)
    slot: int = -1
    started_s: float = 0.0           # perf_counter at slot admission

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class ContinuousBatcher:
    """Fixed-slot continuous batching for one model on ``device``
    (``None``: the card; raises without one).

    ``load``/``model_idx`` optionally mirror this batcher's queue depth,
    slot occupancy and realized per-request service time into a
    ``serving.load.LoadTracker`` arm, so the router's load-aware scoring
    sees this model's live state."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 ctx_len: int = 256, load=None, model_idx: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = M.cast_params(
            M.tree_map(lambda t: t.to(self.device), params), cfg)
        self.slots = slots
        self.ctx_len = ctx_len
        self.cache = M.init_cache(cfg, slots, ctx_len, device=self.device)
        self.pos = np.zeros(slots, np.int64)
        self.active: List[Optional[SlotRequest]] = [None] * slots
        self.queue: Deque[SlotRequest] = collections.deque()
        self.finished: List[SlotRequest] = []
        self._decode = make_decode_step(cfg)
        self._next_tok = np.zeros(slots, np.int64)
        self.ticks = 0
        self.load = load
        self.model_idx = model_idx
        self.cancelled: List[SlotRequest] = []
        # guards queue/active membership so submit() from request
        # threads, queue_depth() from the router's scoring path and the
        # tick driver all see one consistent outstanding-work count
        self._lock = make_lock("serving.scheduler")
        if load is not None:
            load.ensure(model_idx + 1)
            load.set_capacity(model_idx, float(slots))

    # ------------------------------------------------------------------
    def submit(self, req: SlotRequest, *, truncate: bool = False) -> None:
        """Queue a request.  The prompt plus every decode step whose
        output is kept must fit the slot cache: the last kept token
        decodes at ``len(tokens) + max_new - 2``, so prompts longer than
        ``ctx_len - max(max_new - 1, 1)`` are rejected, or clipped to
        that limit with ``truncate=True``.  (The tick after the last
        kept token decodes at ``ctx_len`` itself for a prompt at the
        limit; its output is discarded and it writes nothing.)"""
        limit = self.ctx_len - max(req.max_new - 1, 1)
        if len(req.tokens) > limit:
            if not truncate:
                raise ValueError(
                    f"prompt of {len(req.tokens)} tokens with max_new="
                    f"{req.max_new} overflows the ctx_len={self.ctx_len} "
                    f"slot cache (limit {limit}; pass truncate=True to "
                    f"clip)")
            req.tokens = req.tokens[:limit]
        with self._lock:
            self.queue.append(req)
        if self.load is not None:
            self.load.admit(self.model_idx)

    def queue_depth(self) -> int:
        """Queued + active requests (the batcher's outstanding work),
        taken under the lock so a request moving from queue to slot is
        counted exactly once."""
        with self._lock:
            return (len(self.queue)
                    + sum(r is not None for r in self.active))

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _admit(self) -> None:
        """Prefill queued requests into free slots (slot-cache insert)."""
        for i in self._free_slots():
            with self._lock:
                if not self.queue:
                    return
                req = self.queue.popleft()
                # the slot claim happens in the same critical section as
                # the dequeue: queue_depth never misses the request
                self.active[i] = req
            toks = torch.as_tensor(np.asarray(req.tokens, np.int64)[None],
                                   device=self.device)
            last, cache1, _ = M.prefill(self.params, self.cfg,
                                        {"tokens": toks},
                                        max_len=self.ctx_len)
            # the single sequence's cache (a rolled ring, the SSM's conv
            # and ssd states) into slot i's row, and nowhere else
            for key, slot_cache in self.cache.items():
                slot_cache[:, i] = cache1[key][:, 0]
            self.pos[i] = len(req.tokens)
            self._next_tok[i] = int(torch.argmax(last[0]))
            req.slot = i
            req.started_s = time.perf_counter()
            if self.load is not None:
                self.load.start(self.model_idx)

    def _retire(self) -> None:
        for i, req in enumerate(self.active):
            if req is not None and req.done:
                with self._lock:
                    self.finished.append(req)
                    self.active[i] = None
                if self.load is not None:
                    self.load.finish(self.model_idx,
                                     time.perf_counter() - req.started_s)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tick(self) -> int:
        """One scheduler step: admit -> joint decode -> collect -> retire.
        Returns the number of active slots that decoded."""
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        batch = {"token": torch.as_tensor(self._next_tok[:, None],
                                          device=self.device),
                 "pos": torch.as_tensor(self.pos, device=self.device)}
        _, nxt, self.cache = self._decode(self.params, self.cache, batch)
        nxt = nxt[:, 0].cpu().numpy()
        for i in live:
            self.active[i].out.append(int(self._next_tok[i]))
            self._next_tok[i] = nxt[i]
            self.pos[i] += 1
        self._retire()
        self.ticks += 1
        return len(live)

    def cancel(self) -> List[SlotRequest]:
        """Abandon all outstanding work and ROLL BACK the mirrored
        tracker arm: queued requests decrement the queue counter, active
        ones the inflight counter, with no EWMA sample (no service
        completed).  Returns the dropped requests (also appended to
        ``self.cancelled``).  Not safe concurrently with ``tick``: call
        it from the tick driver."""
        with self._lock:
            queued = list(self.queue)
            self.queue.clear()
            active = [r for r in self.active if r is not None]
            for i in range(self.slots):
                self.active[i] = None
        if self.load is not None and (queued or active):
            self.load.cancel(self.model_idx, queued=len(queued),
                             inflight=len(active))
        for r in active:
            r.slot = -1
        dropped = queued + active
        self.cancelled.extend(dropped)
        return dropped

    def run_until_drained(self, max_ticks: int = 10_000, *,
                          cancel_leftover: bool = True
                          ) -> List[SlotRequest]:
        """Tick until no work remains or ``max_ticks`` is reached.  On a
        ``max_ticks`` exit the leftover queue and slots are cancelled
        by default, so the mirrored tracker arm nets back to zero; pass
        ``cancel_leftover=False`` to keep the backlog for a later
        drain."""
        while self.queue_depth() and self.ticks < max_ticks:
            self.tick()
        if cancel_leftover and self.queue_depth():
            self.cancel()
        return self.finished
