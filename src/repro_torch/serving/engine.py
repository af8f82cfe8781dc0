"""Batched serving engine wired to the router (paper §3.5 inference
engine + the MLaaS use-case of §2).

Port of the JAX package's ``serving/engine.py``.  Per submitted batch
in interactive mode (the default):

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
-- failure isolation between groups, as in the reference.

Batch mode (``submit(..., mode="batch")``) keeps that lifecycle: the
cache answers repeats first, and the misses share ONE sample-and-
aggregate decision (``OptiRoute.route_batch``) and one grouped
``generate``, with one telemetry route event per served request.  Its
responses carry no routed-query handle (one aggregate decision has no
per-query bandit context), so ``observe`` skips them.  ``observe``
feeds post-generation quality into the router's bandit and writes
validated responses back to the cache; ``feedback`` records thumbs and
``summary`` aggregates the engine's log.

Observability: the router's ``Telemetry`` gets each request's cache
outcome and final admission verdict, and a ``Tracer`` (the engine's, or
the router's by default; an attached cache inherits it) gets a
``submit`` root span per batch with ``cache_lookup``, ``analyze``,
``route_step``, ``admission`` and ``generate`` spans under it, fanned
out afterwards to one ``request`` trace per request holding exactly
the stages that ran for it (``Response.trace_id``/``trace_root``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.orchestrator import OptiRoute
from repro_torch.core.preferences import TaskSignature, resolve_batch
from repro_torch.core.telemetry import RouteEvent
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.obs.trace import NOOP_SPAN
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
    trace_id: str = ""                # this request's trace (obs.trace)
    trace_root: Any = None            # root Span handle (observe attaches)
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
        self.router = router
        self.tok = HashTokenizer(vocab_hash)
        self.prompt_len = prompt_len
        self.load = load if load is not None \
            else getattr(router.engine, "load", None)
        self.cache = cache if cache is not None \
            else getattr(router, "cache", None)
        # span sink: the router's by default, so one tracer covers
        # submit -> route -> the program's launch; the attached cache
        # inherits it (its lookup span nests under the batch trace)
        self.tracer = tracer if tracer is not None \
            else getattr(router, "tracer", None)
        if (self.cache is not None and self.tracer is not None
                and getattr(self.cache, "tracer", None) is None):
            self.cache.tracer = self.tracer
        router_cache = getattr(router, "cache", None)
        if cache is not None and router_cache is None:
            # the write-back lives in OptiRoute.observe: an
            # engine-attached cache must be visible there too
            router.cache = cache
        elif cache is not None and router_cache is not cache:
            raise ValueError("ServingEngine(cache=...) conflicts with "
                             "the router's own cache — attach ONE store")
        self.log: List[Response] = []

    def _tokens(self, texts: Sequence[str], vocab_size: int) -> np.ndarray:
        t = self.tok.encode_batch(texts, self.prompt_len)
        return np.clip(t, 0, vocab_size - 1).astype(np.int32)

    def submit(self, requests: Sequence[Request], *,
               mode: str = "interactive") -> List[Response]:
        """Cache -> route -> admission -> grouped generate (interactive),
        or cache -> one aggregate decision -> one generate (batch)."""
        if mode not in ("interactive", "batch"):
            raise ValueError(f"mode must be 'interactive' or 'batch', "
                             f"not {mode!r}")
        if not requests:
            return []
        reqs = list(requests)
        tr = self.tracer
        batch_span = tr.start_trace("submit", batch=len(reqs), mode=mode) \
            if tr is not None else NOOP_SPAN
        with batch_span:
            # resolve each request's preferences once: the cache keys,
            # the fingerprints and the routing task vectors reuse them
            prefs_res = resolve_batch([r.prefs for r in reqs], len(reqs))
            out, miss, keys, fps = self._cache_lookup(reqs, prefs_res)
            if miss and mode == "batch":
                served = self._serve_batch_group([reqs[i] for i in miss])
            elif miss:
                served = self._route_and_serve(
                    [reqs[i] for i in miss], [prefs_res[i] for i in miss],
                    None if keys is None else keys[miss],
                    None if fps is None else fps[miss])
            for j, i in enumerate(miss):
                out[i] = served[j]
        self._fanout_trace(reqs, out, batch_span)
        self.log.extend(out)            # type: ignore[arg-type]
        return out                      # type: ignore[return-value]

    def _cache_lookup(self, reqs: Sequence[Request], prefs_res):
        """The semantic cache's batched lookup: (responses with the hits
        filled in, miss indices, keys, fingerprints); without a cache
        every request misses and keys/fingerprints are None."""
        out: List[Optional[Response]] = [None] * len(reqs)
        if self.cache is None:
            return out, list(range(len(reqs))), None, None
        tel = self.router.telemetry
        keys = self.cache.keys_for(prefs_res, [r.text for r in reqs])
        # the decoding budget joins the exact-match gate
        fps = self.cache.fingerprints(prefs_res,
                                      extras=[r.max_new for r in reqs])
        hit, entries, _ = self.cache.lookup_entries(keys, fps)
        if tel is not None:
            for kind, n in self.cache.drain_events().items():
                tel.record_cache(kind, n)
        miss = []
        for i, r in enumerate(reqs):
            if tel is not None:
                tel.record_cache("hit" if hit[i] else "miss")
            if hit[i]:
                e = entries[i]
                out[i] = Response(
                    request=r, model=e.model, sig=e.sig, tokens=e.response,
                    sim_latency_s=0.0, route_s=0.0, analyzer_s=0.0,
                    cache_hit=True)
            else:
                miss.append(i)
        return out, miss, keys, fps

    def _fanout_trace(self, reqs: Sequence[Request],
                      out: Sequence[Response], batch_span) -> None:
        """Fan the batch-level spans out to one trace PER REQUEST: a
        ``request`` root carrying ids and verdicts, with child spans for
        exactly the stages that ran for it (a cache hit gets only its
        ``cache_lookup``; a shed request stops at ``admission``).
        Durations are the batch stage costs amortized per request.
        Each ``Response`` leaves with its ``trace_id``/``trace_root``
        stamped so a later ``observe`` attaches to the tree."""
        tr = self.tracer
        if tr is None or not tr.enabled:
            return
        B = len(reqs)
        for r, resp in zip(reqs, out):
            root = tr.record_span(
                "request",
                duration_s=resp.analyzer_s + resp.route_s
                + resp.sim_latency_s,
                request_id=r.id, tenant=r.tenant, batch=B,
                batch_trace=batch_span.trace_id, model=resp.model,
                admission=resp.admission, cache_hit=resp.cache_hit)
            resp.trace_id = root.trace_id
            resp.trace_root = root
            if self.cache is not None:
                tr.record_span(
                    "cache_lookup", parent=root,
                    outcome="hit" if resp.cache_hit else "miss")
            if resp.cache_hit:   # short-circuit: no route/admit/generate
                continue
            tr.record_span("analyze", parent=root,
                           duration_s=resp.analyzer_s)
            tr.record_span("route_step", parent=root,
                           duration_s=resp.route_s, fallback=resp.fallback)
            if self.load is not None and r.deadline_ms is not None:
                tr.record_span("admission", parent=root,
                               verdict=resp.admission,
                               est_latency_s=resp.est_latency_s)
            if resp.failed:
                # the group took a slot and raised: the tree shows the
                # failed generate stage, not a missing one
                tr.record_span("generate", parent=root, duration_s=0.0,
                               model=resp.model, outcome="failed",
                               error=resp.error)
            elif not resp.shed:
                tr.record_span("generate", parent=root,
                               duration_s=resp.sim_latency_s,
                               model=resp.model)

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
        tel = self.router.telemetry
        tr = self.tracer
        # placements planned earlier in this same batch: request #50 of
        # a burst must see the 49 ahead of it
        pending = np.zeros(self.load.n_models, np.int64) \
            if self.load is not None else None
        plans = []
        adm_span = tr.span("admission", batch=len(routed)) \
            if tr is not None and self.load is not None else NOOP_SPAN
        with adm_span:
            for r, rq in routed:
                if self.load is None:
                    plans.append((rq.model, "admitted", 0.0))
                    continue
                if r.deadline_ms is None:
                    model, kind, est = rq.model, "admitted", 0.0
                else:
                    # the funnel records the FINAL outcome after
                    # generation: an admitted request whose group fails
                    # counts as "failed"
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
        gen_span = tr.span("generate", groups=len(groups)) \
            if tr is not None else NOOP_SPAN
        with gen_span:
            for (model, max_new), idxs in groups.items():
                self._serve_group(model, max_new, idxs, requests, routed,
                                  plans, col, out)
        for i, (r, rq) in enumerate(routed):   # shed: fail fast, no slot
            if out[i] is None:
                out[i] = Response(
                    request=r, model=plans[i][0], sig=rq.sig, tokens=None,
                    sim_latency_s=0.0, route_s=rq.route_s,
                    analyzer_s=rq.analyzer_s, fallback=rq.fallback_kind,
                    rq=None, admission="shed", est_latency_s=plans[i][2])
        # ONE funnel entry per request, the FINAL outcome: requests with
        # a deadline land their verdict, and a failed group is always
        # recorded
        if tel is not None:
            for i, (r, _) in enumerate(routed):
                resp = out[i]
                if resp.failed or (self.load is not None
                                   and r.deadline_ms is not None):
                    tel.record_admission(resp.admission,
                                         tenant=r.tenant or None)
        return out                      # type: ignore[return-value]

    def _serve_group(self, model: str, max_new: int, idxs: List[int],
                     requests, routed, plans, col, out) -> None:
        """One batched generate for a (model, budget) group; a runner
        exception degrades only this group to ``admission="failed"``."""
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
            # one model group failing never kills the other groups of
            # the batch: THIS group degrades to "failed"
            err = f"{type(e).__name__}: {e}"
        finally:
            # release the slots even on failure (no service-time sample
            # then: per_req_s is still None)
            if self.load is not None:
                self.load.finish(col[model], per_req_s, count=len(idxs))
        for j, i in enumerate(idxs):
            r, rq = routed[i]
            # a rerouted request was served by another model than its
            # decision, and a failed one produced no outcome: no rq
            # handle, so observe() credits no wrong arm
            out[i] = Response(
                request=r, model=model, sig=rq.sig,
                tokens=None if (gen is None or err) else gen.tokens[j],
                sim_latency_s=0.0 if (gen is None or err) else per_req_s,
                route_s=rq.route_s, analyzer_s=rq.analyzer_s,
                fallback=rq.fallback_kind,
                rq=rq if (plans[i][1] == "admitted" and not err) else None,
                admission="failed" if err else plans[i][1],
                est_latency_s=plans[i][2], error=err)

    def _serve_batch_group(self, requests: Sequence[Request]
                           ) -> List[Response]:
        """One aggregate decision -> one batched generate, with the
        tracker's admit -> start -> finish around it, the group's
        failure degrading it to ``admission="failed"``, and one
        telemetry route event per request (``route_batch`` records
        none itself)."""
        texts = [r.text for r in requests]
        decision, _, stats = self.router.route_batch(texts,
                                                     requests[0].prefs)
        model = decision.model
        entry = self.router.mres.entry(model)
        tel = self.router.telemetry
        col = -1
        if self.load is not None:
            names = self.router.mres.snapshot()[1]
            col = names.index(model)
            self.load.ensure(len(names))
            self.load.admit(col, count=len(requests))
            self.load.start(col, count=len(requests))
        gen, per_req_s, err = None, None, ""
        try:
            if entry.runner is not None:
                toks = self._tokens(texts, entry.runner.cfg.vocab_size)
                gen = entry.runner.generate(toks,
                                            max_new=requests[0].max_new)
            per_req_s = (gen.sim_latency_s / len(requests)
                         if gen is not None else
                         entry.raw_metrics.get("latency_ms", 0.0) / 1e3)
        except Exception as e:                     # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
        finally:
            if self.load is not None:
                self.load.finish(col, per_req_s, count=len(requests))
        agg = stats["aggregate_sig"]
        out = [Response(
            request=r, model=model, sig=agg,
            tokens=None if (gen is None or err) else gen.tokens[i],
            sim_latency_s=0.0 if (gen is None or err) else per_req_s,
            route_s=stats["route_s"] / len(requests),
            analyzer_s=stats["analyzer_s"] / len(requests),
            fallback=decision.fallback_kind,
            admission="failed" if err else "admitted",
            error=err) for i, r in enumerate(requests)]
        if tel is not None:
            sim_cost = entry.raw_metrics.get("cost_per_mtok", 0.0)
            for resp in out:
                tel.record(RouteEvent(
                    ts=time.time(), model=model, task_type=agg.task_type,
                    domain=agg.domain, complexity=agg.complexity,
                    fallback=decision.fallback_kind,
                    analyzer_s=resp.analyzer_s, route_s=resp.route_s,
                    sim_cost=sim_cost))
                if resp.failed:
                    tel.record_admission(
                        "failed", tenant=resp.request.tenant or None)
        return out

    def feedback(self, resp: Response, thumbs_up: bool) -> float:
        """Thumbs feedback on a served response into the router's
        feedback store."""
        return self.router.feedback.record(resp.sig, resp.model, thumbs_up)

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
        tr = self.tracer
        pairs = []
        for r, q in zip(responses, qualities):
            if r.rq is None:
                continue
            # the generated payload rides to the cache write-back
            if r.rq.response is None:
                r.rq.response = r.tokens
            # the outcome joins the request's own trace tree
            if tr is not None and r.trace_root is not None:
                tr.record_span("observe", parent=r.trace_root,
                               quality=float(q), model=r.model)
            pairs.append((r.rq, q))
        if not pairs:
            return None
        return self.router.observe([p[0] for p in pairs],
                                   [p[1] for p in pairs])

    def summary(self) -> Dict[str, Any]:
        """Aggregates over every response submitted: requests and
        latency sums, served requests per model with their p50/p99
        end-to-end latency, admission outcomes and cache hits (a hit has
        no admission outcome and no model latency)."""
        if not self.log:
            return {}
        by_model: Dict[str, int] = defaultdict(int)
        lat: Dict[str, List[float]] = defaultdict(list)
        admissions: Dict[str, int] = defaultdict(int)
        cache_hits = 0
        for r in self.log:
            if r.cache_hit:
                cache_hits += 1
                continue
            admissions[r.admission] += 1
            if not r.served:      # shed/failed: no model served them
                continue
            by_model[r.model] += 1
            lat[r.model].append(r.sim_latency_s + r.route_s + r.analyzer_s)
        latency = {m: {"p50_s": float(np.quantile(v, 0.5)),
                       "p99_s": float(np.quantile(v, 0.99))}
                   for m, v in lat.items()}
        return {
            "requests": len(self.log),
            "sim_latency_s": sum(r.sim_latency_s for r in self.log),
            "route_s": sum(r.route_s for r in self.log),
            "analyzer_s": sum(r.analyzer_s for r in self.log),
            "models": dict(by_model),
            "latency": latency,
            "admissions": dict(admissions),
            "cache_hits": cache_hits,
        }
