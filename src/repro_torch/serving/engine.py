"""Batched serving engine wired to the router, interactive mode (paper
§3.5 inference engine + the MLaaS use-case of §2).

Port of the JAX package's ``serving/engine.py`` interactive path.  Per
submitted batch:

  1. the semantic cache (if attached) answers repeats FIRST, in one
     batched lookup; a hit takes no slot and skips everything below;
  2. the misses are analyzed and routed in one ``route_all`` pass — one
     program from token ids to model choices;
  3. deadline-aware admission against the ``LoadTracker`` (admit,
     reroute to the best candidate that fits, or shed);
  4. requests are grouped by (model, decoding budget) and each group is
     served as one batched ``generate`` call on that entry's
     ``ModelRunner`` (prompts hashed to ``prompt_len`` token ids); an
     entry without a runner charges its ``latency_ms`` instead.

A runner exception during one group's generate degrades only that
group: its requests come back with ``admission="failed"`` and the cause
in ``Response.error``, while every other group of the batch is served
-- failure isolation between groups, as in the reference.  ``observe``
feeds post-generation quality into the router's bandit and writes
validated responses back to the cache.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.orchestrator import OptiRoute
from repro_torch.core.preferences import TaskSignature, resolve_batch
from repro_torch.core.routing import not_ported, require_no_observability
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.serving.load import LoadTracker, plan_admission


@dataclass
class Request:
    text: str
    prefs: Any                        # UserPreferences | profile name | dict
    id: int = 0
    max_new: int = 8
    deadline_ms: Optional[float] = None   # latency SLO (None = no SLO)
    tenant: str = ""


@dataclass
class Response:
    request: Request
    model: str
    sig: TaskSignature
    tokens: Optional[np.ndarray]
    sim_latency_s: float
    route_s: float
    analyzer_s: float
    fallback: str = ""
    rq: Any = None                    # RoutedQuery (adaptive loop handle)
    admission: str = "admitted"       # admitted | rerouted | shed | failed
    est_latency_s: float = 0.0        # admission-time wait+service estimate
    cache_hit: bool = False           # served from the semantic cache
    error: str = ""                   # failure detail (admission="failed")

    @property
    def shed(self) -> bool:
        return self.admission == "shed"

    @property
    def failed(self) -> bool:
        return self.admission == "failed"

    @property
    def served(self) -> bool:
        return self.admission in ("admitted", "rerouted")


class ServingEngine:
    def __init__(self, router: OptiRoute, *, prompt_len: int = 32,
                 vocab_hash: int = 4096,
                 load: Optional[LoadTracker] = None, cache=None,
                 tracer=None):
        require_no_observability(None, tracer)
        self.router = router
        self.tok = HashTokenizer(vocab_hash)
        self.prompt_len = prompt_len
        self.load = load if load is not None \
            else getattr(router.engine, "load", None)
        self.cache = cache if cache is not None \
            else getattr(router, "cache", None)
        router_cache = getattr(router, "cache", None)
        if cache is not None and router_cache is None:
            # the write-back lives in OptiRoute.observe: an
            # engine-attached cache must be visible there too
            router.cache = cache
        elif cache is not None and router_cache is not cache:
            raise ValueError("ServingEngine(cache=...) conflicts with "
                             "the router's own cache — attach ONE store")

    def _tokens(self, texts: Sequence[str], vocab_size: int) -> np.ndarray:
        t = self.tok.encode_batch(texts, self.prompt_len)
        return np.clip(t, 0, vocab_size - 1).astype(np.int32)

    def submit(self, requests: Sequence[Request], *,
               mode: str = "interactive") -> List[Response]:
        """Cache -> route -> admission -> grouped generate."""
        if mode != "interactive":
            raise not_ported("Batch-mode serving",
                             "'AsyncServingEngine and batch mode'")
        if not requests:
            return []
        reqs = list(requests)
        out: List[Optional[Response]] = [None] * len(reqs)
        keys = fps = None
        miss = list(range(len(reqs)))
        # resolve each request's preferences once: the cache keys, the
        # fingerprints and the routing task vectors all reuse them
        prefs_res = resolve_batch([r.prefs for r in reqs], len(reqs))
        if self.cache is not None:
            keys = self.cache.keys_for(prefs_res, [r.text for r in reqs])
            # the decoding budget joins the exact-match gate
            fps = self.cache.fingerprints(
                prefs_res, extras=[r.max_new for r in reqs])
            hit, entries, _ = self.cache.lookup_entries(keys, fps)
            miss = []
            for i, r in enumerate(reqs):
                if hit[i]:
                    e = entries[i]
                    out[i] = Response(
                        request=r, model=e.model, sig=e.sig,
                        tokens=e.response, sim_latency_s=0.0, route_s=0.0,
                        analyzer_s=0.0, cache_hit=True)
                else:
                    miss.append(i)
        if miss:
            served = self._route_and_serve(
                [reqs[i] for i in miss], [prefs_res[i] for i in miss],
                None if keys is None else keys[miss],
                None if fps is None else fps[miss])
            for j, i in enumerate(miss):
                out[i] = served[j]
        return out                      # type: ignore[return-value]

    def _route_and_serve(self, requests: Sequence[Request], prefs_res,
                         cache_keys, cache_fps) -> List[Response]:
        routed_q = self.router.route_all([r.text for r in requests],
                                         prefs_res)
        if cache_keys is not None:
            # stamp the write-back key: a miss that later validates well
            # becomes the entry answering the next near-duplicate
            for j, rq in enumerate(routed_q):
                rq.cache_key = np.asarray(cache_keys[j])
                rq.cache_fp = int(cache_fps[j])
        routed = list(zip(requests, routed_q))
        col: Dict[str, int] = {}
        if self.load is not None:
            names = self.router.mres.snapshot()[1]
            col = {m: j for j, m in enumerate(names)}
            self.load.ensure(len(names))
        # placements planned earlier in this same batch: request #50 of
        # a burst must see the 49 ahead of it
        pending = np.zeros(self.load.n_models, np.int64) \
            if self.load is not None else None
        plans = []
        for r, rq in routed:
            if self.load is None:
                plans.append((rq.model, "admitted", 0.0))
                continue
            if r.deadline_ms is None:
                model, kind, est = rq.model, "admitted", 0.0
            else:
                model, kind, est = plan_admission(
                    rq.decision, self.load, col, r.deadline_ms,
                    pending=pending)
            plans.append((model, kind, est))
            if kind != "shed":
                pending[col[model]] += 1
        groups: Dict[Tuple[str, int], List[int]] = defaultdict(list)
        for i, (r, _) in enumerate(routed):
            model, kind, _ = plans[i]
            if kind != "shed":
                groups[(model, r.max_new)].append(i)
        out: List[Optional[Response]] = [None] * len(requests)
        for (model, max_new), idxs in groups.items():
            entry = self.router.mres.entry(model)
            if self.load is not None:
                self.load.admit(col[model], count=len(idxs))
                self.load.start(col[model], count=len(idxs))
            gen, per_req_s, err = None, None, ""
            try:
                if entry.runner is not None:
                    toks = self._tokens([requests[i].text for i in idxs],
                                        entry.runner.cfg.vocab_size)
                    gen = entry.runner.generate(toks, max_new=max_new)
                per_req_s = (gen.sim_latency_s / len(idxs)
                             if gen is not None else
                             entry.raw_metrics.get("latency_ms", 0.0) / 1e3)
            except Exception as e:             # noqa: BLE001
                # one model group failing never kills the other groups
                # of the batch: THIS group degrades to "failed"
                err = f"{type(e).__name__}: {e}"
            finally:
                # release the slots even on failure (no service-time
                # sample then: per_req_s is still None)
                if self.load is not None:
                    self.load.finish(col[model], per_req_s, count=len(idxs))
            for j, i in enumerate(idxs):
                r, rq = routed[i]
                # a rerouted request was served by another model than
                # its decision, and a failed one produced no outcome:
                # no rq handle, so observe() credits no wrong arm
                out[i] = Response(
                    request=r, model=model, sig=rq.sig,
                    tokens=None if (gen is None or err) else gen.tokens[j],
                    sim_latency_s=0.0 if (gen is None or err)
                    else per_req_s,
                    route_s=rq.route_s, analyzer_s=rq.analyzer_s,
                    fallback=rq.fallback_kind,
                    rq=rq if (plans[i][1] == "admitted" and not err)
                    else None,
                    admission="failed" if err else plans[i][1],
                    est_latency_s=plans[i][2], error=err)
        for i, (r, rq) in enumerate(routed):   # shed: fail fast, no slot
            if out[i] is None:
                out[i] = Response(
                    request=r, model=plans[i][0], sig=rq.sig, tokens=None,
                    sim_latency_s=0.0, route_s=rq.route_s,
                    analyzer_s=rq.analyzer_s, fallback=rq.fallback_kind,
                    rq=None, admission="shed", est_latency_s=plans[i][2])
        return out                      # type: ignore[return-value]

    def observe(self, responses: Sequence[Response],
                qualities: Sequence[float]):
        """Post-generation ground truth: shaped rewards into the
        router's bandit against each response's routed context, and
        the cache write-back.  Responses without a routed-query handle
        (cache hits, rerouted, shed) are skipped."""
        if len(responses) != len(qualities):
            raise ValueError(f"{len(responses)} responses but "
                             f"{len(qualities)} qualities — observations "
                             "must align one-to-one")
        pairs = []
        for r, q in zip(responses, qualities):
            if r.rq is None:
                continue
            # the generated payload rides to the cache write-back
            if r.rq.response is None:
                r.rq.response = r.tokens
            pairs.append((r.rq, q))
        if not pairs:
            return None
        return self.router.observe([p[0] for p in pairs],
                                   [p[1] for p in pairs])
