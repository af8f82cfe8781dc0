"""Semantic response cache: the cheapest model call is the one never
made.

Port of the JAX package's ``cache/semantic.py``.  Finished,
quality-validated responses live in packed host arrays keyed on the
routing task-vector space:

  vecs       (C, dim) f32   cache-key vectors (preference axes + a
                            hashed text sketch, see ``keys_for``)
  fps        (C,) i64       prefs fingerprints (exact-match gate)
  quality    (C,) f32       validated quality of the stored response
  created    (C,) f64       wall-clock insert time (TTL)
  last_used  (C,) i64       LRU recency tick
  valid      (C,) bool      live-slot mask

A batched lookup is ONE top-1 pass of the hand-written ``router_topk``
kernel over the whole store on ``device``, with the per-query
fingerprint mask (one row per query) and the similarity threshold fused
in as its ``min_score``; ``device="cpu"`` runs the kernel's plain
version.  A row is a hit iff its fingerprint matches exactly, its TTL
has not lapsed, and its cosine similarity clears ``threshold``.

Expired entries are purged lazily at lookup/insert time, a full store
evicts the least-recently-used slot, inserts below ``min_quality`` are
rejected, and an insert that semantically duplicates a live entry
refreshes it in place.  Thread-safe; all state round-trips through
``state()``/``load_state`` for ``repro_torch.checkpoint.RouterState``
(the reference's layout, so a snapshot of either package restores in
the other).
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.sanitize import make_lock
from repro_torch.core.preferences import N_METRICS, TaskSignature, resolve
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.trace import NOOP_SPAN

# cache_funnel outcome kinds (Telemetry.cache_funnel key set, stable
# even on empty engines): lookup outcomes, then insert outcomes
CACHE_KINDS = ("hit", "miss", "stored", "rejected", "evicted", "expired")


# ----------------------------------------------------------------------
# key construction
# ----------------------------------------------------------------------

def text_sketch(texts: Sequence[str], dims: int = 32) -> np.ndarray:
    """(B, dims) L2-normalized hashed bag-of-words sketches.

    Deterministic across processes (crc32, not python ``hash``), so
    persisted cache entries keep matching after a restart.  Identical
    texts sketch identically; near-duplicates land nearby; unrelated
    texts share only filler mass.
    """
    out = np.zeros((len(texts), dims), np.float32)
    for b, text in enumerate(texts):
        for w in text.split():
            h = zlib.crc32(w.encode())
            sign = 1.0 if (h >> 20) & 1 else -1.0
            out[b, h % dims] += sign
    n = np.linalg.norm(out, axis=1, keepdims=True) + 1e-9
    return out / n


def prefs_fingerprint(prefs_or_profile, extra=None) -> int:
    """Stable int64 fingerprint of the explicit preference weights —
    the exact-match gate of the cache key (a cached answer tuned for
    cost-first must never serve an accuracy-first user).  ``extra``
    mixes additional exact-match request parameters into the gate (the
    serving engine passes the decoding budget: a response generated
    under ``max_new=4`` must never answer a ``max_new=256`` request)."""
    v = resolve(prefs_or_profile).vector()
    h = zlib.crc32(np.ascontiguousarray(v).tobytes())
    if extra is not None:
        h = zlib.crc32(repr(extra).encode(), h)
    return int(np.int64(h))


@dataclass
class CacheEntry:
    """One materialized cache row (what ``get`` hands the engine)."""
    model: str
    response: Any
    quality: float
    sig: TaskSignature


class SemanticCache:
    def __init__(self, capacity: int = 4096, *, threshold: float = 0.95,
                 ttl_s: Optional[float] = None, min_quality: float = 0.5,
                 sketch_dims: int = 32, text_weight: float = 1.0,
                 dim: Optional[int] = None, quantize: bool = False,
                 tracer=None, time_fn=time.time, device=None):
        assert capacity > 0, capacity
        assert -1.0 <= threshold <= 1.0, threshold
        self.device = resolve_device(device)
        # span sink (obs.Tracer): batched lookups report a
        # "cache_lookup" span nested under the caller's ambient span
        self.tracer = tracer
        self.capacity = int(capacity)
        self.threshold = float(threshold)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self.min_quality = float(min_quality)
        self.sketch_dims = int(sketch_dims)
        self.text_weight = float(text_weight)
        self.dim = int(dim) if dim is not None \
            else N_METRICS + self.sketch_dims
        # mega-store knob: run the lookup on the int8-quantized store
        # (4x fewer key bytes scanned) — the threshold gate checks the
        # rescaled fp32 scores, so quantization only perturbs scores
        # near the threshold by the ~1e-2 rounding bound of 8-bit rows
        self.quantize = bool(quantize)
        self._time = time_fn
        self._lock = make_lock("cache.semantic")
        C = self.capacity
        self.vecs = np.zeros((C, self.dim), np.float32)
        self.fps = np.zeros(C, np.int64)
        self.quality = np.zeros(C, np.float32)
        self.created = np.zeros(C, np.float64)
        self.last_used = np.zeros(C, np.int64)
        self.valid = np.zeros(C, bool)
        self.models: List[str] = [""] * C
        self.responses: List[Any] = [None] * C
        self.sigs: List[Optional[TaskSignature]] = [None] * C
        self._tick = 0
        self.counters: Dict[str, int] = {k: 0 for k in CACHE_KINDS}
        # evictions/expiries happen INSIDE lookup/put, invisible to the
        # caller's return value — they queue here until drain_events()
        self._unreported: Dict[str, int] = {}

    def __len__(self) -> int:
        with self._lock:
            return int(self.valid.sum())

    # ------------------------------------------------------------------
    # key construction bound to this cache's configuration
    # ------------------------------------------------------------------
    def keys_for(self, prefs_batch, texts: Sequence[str]) -> np.ndarray:
        """(B, dim) cache-key vectors: the explicit preference axes
        (the routing task-vector space) concatenated with the hashed
        text sketch at ``text_weight`` — exact repeats score cosine
        1.0, same-prefs-different-task queries fall off with sketch
        distance."""
        prefs = [resolve(p) for p in prefs_batch]
        if len(prefs) != len(texts):
            raise ValueError(f"{len(prefs)} prefs but {len(texts)} texts")
        W = np.stack([p.vector() for p in prefs]).astype(np.float32)
        S = self.text_weight * text_sketch(texts, self.sketch_dims)
        return np.concatenate([W, S], axis=1)

    def fingerprints(self, prefs_batch, extras=None) -> np.ndarray:
        """(B,) int64 prefs fingerprints for ``keys_for``'s batch.
        ``extras`` (B,) optionally mixes per-request exact-match
        parameters (e.g. the decoding budget) into each gate."""
        if extras is None:
            return np.array([prefs_fingerprint(p) for p in prefs_batch],
                            np.int64)
        if len(extras) != len(prefs_batch):
            raise ValueError(f"{len(prefs_batch)} prefs but "
                             f"{len(extras)} extras")
        return np.array([prefs_fingerprint(p, extra=e)
                         for p, e in zip(prefs_batch, extras)], np.int64)

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def _purge_expired_locked(self, now: float) -> None:
        if self.ttl_s is None:
            return
        dead = self.valid & (now - self.created > self.ttl_s)
        n = int(dead.sum())
        if n:
            self.valid[dead] = False
            for j in np.flatnonzero(dead):
                self.responses[j] = None
                self.sigs[j] = None
                self.models[j] = ""
            self.counters["expired"] += n
            self._unreported["expired"] = \
                self._unreported.get("expired", 0) + n

    def _lookup_locked(self, vecs: np.ndarray, fps: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        B = vecs.shape[0]
        assert vecs.shape == (B, self.dim), (vecs.shape, self.dim)
        assert fps.shape == (B,), fps.shape
        self._purge_expired_locked(self._time())
        mask = self.valid[None, :] & (fps[:, None] == self.fps[None, :])
        if not mask.any():
            sim = np.full(B, -np.inf, np.float32)
            slot = np.full(B, -1, np.int64)
            hit = np.zeros(B, bool)
        else:
            # query axis padded to its power-of-two bucket; the store's
            # capacity axis is static
            vals, idx = ops.router_topk_bucketed(
                self.vecs, vecs, 1, mask=mask, min_score=self.threshold,
                quant=self.quantize, device=self.device)
            sim = vals[:, 0]
            slot = idx[:, 0].astype(np.int64)
            hit = np.isfinite(sim)
        slot = np.where(hit, slot, -1)
        sim = np.where(hit, sim, -np.inf).astype(np.float32)
        for j in slot[hit]:
            self._tick += 1
            self.last_used[j] = self._tick
        nh = int(hit.sum())
        self.counters["hit"] += nh
        self.counters["miss"] += B - nh
        return hit, slot, sim

    def lookup(self, vecs: np.ndarray, fps: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched lookup: (hit (B,) bool, slot (B,) i64, sim (B,) f32).

        One fused similarity + top-1 pass over the packed store with
        the per-query fingerprint mask and the similarity threshold
        fused in; hits refresh LRU recency.  ``slot`` is -1 (and sim
        -inf) on misses.  A returned slot index is only stable until
        the next concurrent insert/expiry — concurrent callers should
        use ``lookup_entries``, which materializes under the lock.
        """
        with self._lock:
            return self._lookup_locked(np.asarray(vecs, np.float32),
                                       np.asarray(fps, np.int64))

    def lookup_entries(self, vecs: np.ndarray, fps: np.ndarray
                       ) -> Tuple[np.ndarray, list, np.ndarray]:
        """(hit (B,), entries (B,) list of CacheEntry|None, sim (B,)).

        Like ``lookup`` but hit rows are materialized under the SAME
        lock, so a concurrent put/eviction/expiry between lookup and
        get can never invalidate a hit mid-serve."""
        span = self.tracer.span("cache_lookup",
                                batch=int(np.asarray(vecs).shape[0])) \
            if self.tracer is not None else NOOP_SPAN
        with span:
            with self._lock:
                hit, slot, sim = self._lookup_locked(
                    np.asarray(vecs, np.float32), np.asarray(fps, np.int64))
                entries = [self._entry_locked(int(s)) if h else None
                           for h, s in zip(hit, slot)]
            span.set(hits=int(np.asarray(hit).sum()))
        return hit, entries, sim

    def _entry_locked(self, slot: int) -> CacheEntry:
        assert 0 <= slot < self.capacity and self.valid[slot], slot
        return CacheEntry(model=self.models[slot],
                          response=self.responses[slot],
                          quality=float(self.quality[slot]),
                          sig=self.sigs[slot] or TaskSignature())

    def get(self, slot: int) -> CacheEntry:
        with self._lock:
            return self._entry_locked(slot)

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------
    def put(self, vec: np.ndarray, fp: int, model: str, response: Any,
            quality: float, sig: Optional[TaskSignature] = None) -> str:
        """Insert one validated response.  Returns the outcome kind:
        ``rejected`` (quality below the bar), ``stored`` (fresh slot or
        in-place refresh of a semantic duplicate), with ``evicted`` /
        ``expired`` counted internally when slots are reclaimed."""
        vec = np.asarray(vec, np.float32).reshape(self.dim)
        quality = float(quality)
        with self._lock:
            now = self._time()
            self._purge_expired_locked(now)
            if quality < self.min_quality:
                self.counters["rejected"] += 1
                return "rejected"
            self._tick += 1
            # semantic duplicate -> refresh in place (never two slots
            # answering the same query; keep the better response)
            live = self.valid & (self.fps == fp)
            j = -1
            if live.any():
                en = np.linalg.norm(self.vecs[live], axis=1) + 1e-9
                qn = float(np.linalg.norm(vec)) + 1e-9
                sims = (self.vecs[live] @ vec) / (en * qn)
                best = int(sims.argmax())
                if sims[best] >= self.threshold:
                    j = int(np.flatnonzero(live)[best])
                    if quality < self.quality[j]:
                        # keep the stronger stored response; still a
                        # store (recency refreshed, entry stays warm)
                        self.last_used[j] = self._tick
                        self.counters["stored"] += 1
                        return "stored"
            if j < 0:
                free = np.flatnonzero(~self.valid)
                if free.size:
                    j = int(free[0])
                else:                       # full: evict the LRU slot
                    j = int(np.argmin(np.where(self.valid, self.last_used,
                                               np.iinfo(np.int64).max)))
                    self.counters["evicted"] += 1
                    self._unreported["evicted"] = \
                        self._unreported.get("evicted", 0) + 1
            self.vecs[j] = vec
            self.fps[j] = int(fp)
            self.quality[j] = quality
            self.created[j] = now
            self.last_used[j] = self._tick
            self.valid[j] = True
            self.models[j] = str(model)
            self.responses[j] = response
            self.sigs[j] = sig
            self.counters["stored"] += 1
            return "stored"

    # ------------------------------------------------------------------
    # stats & persistence
    # ------------------------------------------------------------------
    def drain_events(self) -> Dict[str, int]:
        """Internal outcome counts (``evicted`` / ``expired``) accrued
        since the last drain — the serving layer forwards these to
        ``Telemetry.record_cache`` so the funnel sees capacity churn,
        not just hit/miss/store traffic."""
        with self._lock:
            out, self._unreported = self._unreported, {}
            return out

    def hit_rate(self) -> float:
        with self._lock:
            n = self.counters["hit"] + self.counters["miss"]
            return self.counters["hit"] / n if n else 0.0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n = self.counters["hit"] + self.counters["miss"]
            return {"entries": int(self.valid.sum()),
                    "capacity": self.capacity,
                    "hit_rate": self.counters["hit"] / n if n else 0.0,
                    **dict(self.counters)}

    def state(self) -> Dict[str, Any]:
        """Everything ``load_state`` needs to resume bit-exactly."""
        with self._lock:
            return {
                "vecs": self.vecs.copy(), "fps": self.fps.copy(),
                "quality": self.quality.copy(),
                "created": self.created.copy(),
                "last_used": self.last_used.copy(),
                "valid": self.valid.copy(), "tick": self._tick,
                "models": list(self.models),
                "responses": list(self.responses),
                "sigs": [None if s is None else
                         (s.task_type, s.domain, s.complexity,
                          s.confidence) for s in self.sigs],
            }

    def load_state(self, st: Dict[str, Any]) -> None:
        """Restore a ``state()`` snapshot into THIS cache's configured
        capacity: a same-size snapshot restores slot-for-slot
        (bit-exact); a differently-sized one has its live entries
        compacted into the configured arrays, so restoring an old
        snapshot never silently shrinks (or grows) a reconfigured
        cache.  Raises when the snapshot holds more live entries than
        the capacity can hold."""
        vecs = np.asarray(st["vecs"], np.float32)
        C, dim = vecs.shape
        if dim != self.dim:
            raise ValueError(f"cache dim mismatch: snapshot {dim}, "
                             f"cache {self.dim}")
        valid = np.asarray(st["valid"], bool)
        sigs = [None if s is None else
                TaskSignature(task_type=str(s[0]), domain=str(s[1]),
                              complexity=float(s[2]),
                              confidence=float(s[3]))
                for s in st["sigs"]]
        with self._lock:
            K = self.capacity
            src = np.arange(C) if C == K else np.flatnonzero(valid)
            if src.size > K:
                raise ValueError(f"snapshot holds {src.size} live "
                                 f"entries but cache capacity is {K}")
            n = src.size
            self.vecs = np.zeros((K, self.dim), np.float32)
            self.vecs[:n] = vecs[src]
            self.fps = np.zeros(K, np.int64)
            self.fps[:n] = np.asarray(st["fps"], np.int64)[src]
            self.quality = np.zeros(K, np.float32)
            self.quality[:n] = np.asarray(st["quality"], np.float32)[src]
            self.created = np.zeros(K, np.float64)
            self.created[:n] = np.asarray(st["created"], np.float64)[src]
            self.last_used = np.zeros(K, np.int64)
            self.last_used[:n] = np.asarray(st["last_used"],
                                            np.int64)[src]
            self.valid = np.zeros(K, bool)
            self.valid[:n] = valid[src]
            self._tick = int(st["tick"])
            models = list(st["models"])
            responses = list(st["responses"])
            self.models = [str(models[j]) for j in src] + \
                [""] * (K - n)
            self.responses = [responses[j] for j in src] + \
                [None] * (K - n)
            self.sigs = [sigs[j] for j in src] + [None] * (K - n)
