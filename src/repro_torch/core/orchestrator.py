"""OptiRoute end-to-end orchestrator (paper Fig 1, §3).

User preferences -> Task Analyzer -> Routing Engine over the MRES ->
(optional) model-merging fallback -> execution -> feedback / bandit
loop.  Two modes:

  * batched per-query (``route_all``, the serving engine's default):
    every query gets its own signature and decision.  With a
    ``TaskAnalyzer`` attached and a fusable engine that is ONE program
    from token ids to model choices (``RoutingEngine.route_tokens_batch``);
    otherwise the analyzer's signatures feed ``route_many_batch``, or
    ``route_many`` (the staged path) when the engine cannot fuse (a
    Thompson bandit, ``fused=False``) or a merger is attached (it needs
    eager scores and may grow the catalog mid-pass);
  * batch (``route_batch``): a ~2% sample of the batch is analyzed and
    the aggregate signature routes the WHOLE batch to one model.

``telemetry`` (``core.telemetry.Telemetry``) records one route event
per query and the programs' dispatch counts; ``tracer`` (``obs.Tracer``)
reports ``analyze`` / ``route_step`` / ``observe`` spans, nested under
the caller's ambient span.  Both are handed down to the engine and to
an attached ``TaskAnalyzer``.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.feedback import FeedbackStore
from repro_torch.core.merging import ModelMerger
from repro_torch.core.mres import MRES
from repro_torch.core.preferences import TaskSignature, resolve_batch
from repro_torch.core.routing import RoutingDecision, RoutingEngine
from repro_torch.obs.trace import NOOP_SPAN


class RoutedQuery:
    """One routed query (text, signature, decision, timings).

    The decision is either eager (the staged path hands a
    ``RoutingDecision``) or LAZY: a query routed through a fused path
    carries a (RoutingBatch, row) handle and materializes its decision
    and signature on first access; ``model``/``fallback_kind``/
    ``task_vector`` read whichever it holds.  ``cache_key``/``cache_fp``
    are the semantic-cache write-back key stamped at submit time;
    ``cache_written`` is tracked separately from ``observed`` (bandit
    freshness)."""
    __slots__ = ("text", "analyzer_s", "route_s", "response",
                 "observed", "cache_key", "cache_fp", "cache_written",
                 "_sig", "_decision", "_batch", "_bidx")

    def __init__(self, text: str, sig: Optional[TaskSignature] = None,
                 decision: Optional[RoutingDecision] = None,
                 analyzer_s: float = 0.0, route_s: float = 0.0,
                 response: Any = None, batch=None, batch_idx: int = -1):
        if decision is None and batch is None:
            raise ValueError("a RoutedQuery needs a decision or a "
                             "(batch, row) handle")
        self.text = text
        self.analyzer_s = analyzer_s
        self.route_s = route_s
        self.response = response
        self.observed = False
        self.cache_key: Optional[np.ndarray] = None
        self.cache_fp = 0
        self.cache_written = False
        self._sig = sig
        self._decision = decision
        self._batch = batch
        self._bidx = batch_idx

    @property
    def sig(self) -> TaskSignature:
        if self._sig is None:
            self._sig = self._batch.signature(self._bidx)
        return self._sig

    @property
    def decision(self) -> RoutingDecision:
        if self._decision is None:
            self._decision = self._batch.decision(self._bidx)
        return self._decision

    @property
    def model(self) -> str:
        if self._decision is not None:
            return self._decision.model
        return self._batch.model(self._bidx)

    @property
    def fallback_kind(self) -> str:
        if self._decision is not None:
            return self._decision.fallback_kind
        return self._batch.fallback_kind(self._bidx)

    @property
    def task_vector(self) -> np.ndarray:
        if self._decision is not None:
            return self._decision.task_vector
        return self._batch.task_vectors[self._bidx]


class OptiRoute:
    """The deployable facade: ``route`` / ``route_all`` /
    ``route_batch`` / ``serve`` / ``observe`` / ``give_feedback``.
    ``merge_threshold`` attaches a ``ModelMerger``: queries whose best
    score falls below it may synthesize a soup entry."""

    def __init__(self, mres: MRES, analyzer, *,
                 feedback: Optional[FeedbackStore] = None,
                 knn_k: int = 8, merge_threshold: Optional[float] = None,
                 batch_sample_frac: float = 0.02,
                 feedback_weight: float = 0.5, telemetry=None, tracer=None,
                 adaptive=None, adaptive_weight: float = 0.0,
                 reward_fn=None, reward_shaper=None, load=None,
                 load_weight: float = 0.0, cache=None, device=None):
        self.mres = mres
        self.analyzer = analyzer
        self.feedback = feedback if feedback is not None else FeedbackStore()
        self.engine = RoutingEngine(mres, self.feedback, knn_k=knn_k,
                                    feedback_weight=feedback_weight,
                                    adaptive=adaptive,
                                    adaptive_weight=adaptive_weight,
                                    load=load, load_weight=load_weight,
                                    telemetry=telemetry, tracer=tracer,
                                    device=device)
        self.device = self.engine.device
        self.merger = (ModelMerger(mres, merge_threshold)
                       if merge_threshold is not None else None)
        self.batch_sample_frac = batch_sample_frac
        self.telemetry = telemetry
        self.tracer = tracer
        # adaptive loop: ``reward_fn(rq) -> quality`` closes it inside
        # route_all; without it, call ``observe`` explicitly
        self.adaptive = adaptive
        self.reward_fn = reward_fn
        self.reward_shaper = reward_shaper
        self.load = load
        # semantic response cache: the serving engine consults it before
        # routing; ``observe`` writes validated responses back
        self.cache = cache
        # analyzer dispatches report into the same telemetry/trace
        # stream as the route step
        if getattr(analyzer, "supports_fused_route", False):
            if analyzer.telemetry is None:
                analyzer.telemetry = telemetry
            if analyzer.tracer is None:
                analyzer.tracer = tracer

    def route(self, text: str, prefs) -> RoutedQuery:
        """Single-query routing — B=1 wrapper over ``route_all``."""
        return self.route_all([text], prefs)[0]

    def _record(self, rq: RoutedQuery) -> None:
        if self.telemetry is not None:
            entry = self.mres.entry(rq.model)
            self.telemetry.record_decision(
                rq, sim_cost=entry.raw_metrics.get("cost_per_mtok", 0.0))

    def _fully_fused_ok(self) -> bool:
        """Whether the single analyze->route program can serve: no
        merger, a fusable engine and an analyzer exposing its encoder
        (stub analyzers do not)."""
        return (self.merger is None
                and getattr(self.analyzer, "supports_fused_route", False)
                and self.engine._fused_ok())

    def route_all(self, texts: Sequence[str], prefs) -> List[RoutedQuery]:
        """Analyze and route every query in one vectorized pass; each
        query gets its own signature and decision.  Reported per-query
        timings are the batch cost amortized over B."""
        if len(texts) == 0:
            return []
        B = len(texts)
        prefs_list = resolve_batch(prefs, B)
        if len(prefs_list) != B:
            raise ValueError(f"prefs batch size {len(prefs_list)} != "
                             f"text batch size {B}")
        tr = self.tracer
        an = self.analyzer
        t0 = time.time()
        if self._fully_fused_ok():
            # the "analyze" span covers only host-side prune+tokenize:
            # the encoder runs inside the fused program, which reports
            # its own route_step span with path="fused"
            span = tr.span("analyze", path="fused", batch=B) \
                if tr is not None else NOOP_SPAN
            with span:
                toks = an.encode_batch(list(texts))
            t1 = time.time()
            batch = self.engine.route_tokens_batch(an.params, toks,
                                                   prefs_list)
            t2 = time.time()
            out = [RoutedQuery(text=t, batch=batch, batch_idx=i,
                               analyzer_s=(t1 - t0) / B,
                               route_s=(t2 - t1) / B)
                   for i, t in enumerate(texts)]
        else:
            span = tr.span("analyze", batch=B) if tr is not None \
                else NOOP_SPAN
            with span:
                sigs = an.analyze_batch(list(texts))
            t1 = time.time()
            if self.merger is None and self.engine._fused_ok():
                batch = self.engine.route_many_batch(prefs_list, sigs)
                t2 = time.time()
                out = [RoutedQuery(text=t, sig=s, batch=batch, batch_idx=i,
                                   analyzer_s=(t1 - t0) / B,
                                   route_s=(t2 - t1) / B)
                       for i, (t, s) in enumerate(zip(texts, sigs))]
            else:
                span = tr.span("route_step", path="staged", batch=B) \
                    if tr is not None else NOOP_SPAN
                with span:
                    decisions = self.engine.route_many(prefs_list, sigs)
                if self.merger is not None:
                    self._merge_low(prefs_list, sigs, decisions)
                t2 = time.time()
                out = [RoutedQuery(text=t, sig=s, decision=d,
                                   analyzer_s=(t1 - t0) / B,
                                   route_s=(t2 - t1) / B)
                       for t, s, d in zip(texts, sigs, decisions)]
        for rq in out:
            self._record(rq)
        if self.adaptive is not None and self.reward_fn is not None:
            self.observe(out)
        return out

    def _merge_low(self, prefs_list, sigs, decisions) -> None:
        """The merger branch: each query scoring below the threshold may
        register a soup that beats its incumbent; if the catalog grew,
        the low scorers are routed again in one pass (in place)."""
        low = [i for i, d in enumerate(decisions)
               if d.score < self.merger.score_threshold]
        grew = False
        for i in low:
            if self.merger.maybe_merge(prefs_list[i], sigs[i],
                                       decisions[i].score) is not None:
                grew = True
        if grew:
            redo = self.engine.route_many([prefs_list[i] for i in low],
                                          [sigs[i] for i in low])
            for j, i in enumerate(low):
                decisions[i] = redo[j]

    def observe(self, rqs: Sequence[RoutedQuery],
                qualities: Optional[Sequence[float]] = None,
                extra_penalty=None) -> Optional[np.ndarray]:
        """Close the adaptive loop for a routed batch: one shaped reward
        per newly-observed query into the bandit, and each query whose
        cache key is stamped writes its (response, RAW quality) back to
        the semantic cache.  Each query is observed at most once.
        Returns the shaped rewards of the newly-observed queries, or
        None."""
        if (self.adaptive is None and self.cache is None) or not rqs:
            return None
        if qualities is None and self.reward_fn is None:
            return None
        if qualities is not None and len(qualities) != len(rqs):
            raise ValueError(f"{len(rqs)} routed queries but "
                             f"{len(qualities)} qualities — observations "
                             "must align one-to-one")
        if extra_penalty is not None and len(extra_penalty) != len(rqs):
            raise ValueError(f"{len(rqs)} routed queries but "
                             f"{len(extra_penalty)} extra penalties")
        fresh = [] if self.adaptive is None else \
            [i for i, rq in enumerate(rqs) if not rq.observed]
        cacheable = [] if self.cache is None else \
            [i for i, rq in enumerate(rqs)
             if rq.cache_key is not None and not rq.cache_written]
        todo = sorted(set(fresh) | set(cacheable))
        if not todo:
            return None
        span = self.tracer.span("observe", batch=len(rqs),
                                fresh=len(fresh),
                                cacheable=len(cacheable)) \
            if self.tracer is not None else NOOP_SPAN
        with span:
            return self._observe(rqs, qualities, extra_penalty, fresh,
                                 cacheable, todo)

    def _observe(self, rqs, qualities, extra_penalty, fresh, cacheable,
                 todo) -> Optional[np.ndarray]:
        if qualities is None:
            qual = {i: float(self.reward_fn(rqs[i])) for i in todo}
        else:
            qual = {i: float(qualities[i]) for i in todo}
        tel = self.telemetry
        for i in cacheable:
            rq = rqs[i]
            kind = self.cache.put(rq.cache_key, rq.cache_fp, rq.model,
                                  rq.response, qual[i], sig=rq.sig)
            rq.cache_written = True
            if tel is not None:
                tel.record_cache(kind)
        if cacheable and tel is not None:
            # inserts can evict/expire internally; surface the churn
            for kind, n in self.cache.drain_events().items():
                tel.record_cache(kind, n)
        if self.adaptive is None or not fresh:
            for i in fresh:
                rqs[i].observed = True
            return None
        sub = [rqs[i] for i in fresh]
        sub_q = [qual[i] for i in fresh]
        sub_ep = None if extra_penalty is None else \
            np.asarray(extra_penalty, np.float32)[fresh]
        names = self.mres.snapshot()[1]
        col = {m: j for j, m in enumerate(names)}
        midx = np.array([col[rq.model] for rq in sub])
        X = np.stack([rq.task_vector for rq in sub])
        if self.reward_shaper is not None:
            rewards = self.reward_shaper.shape(sub_q, midx, sub_ep)
        else:
            rewards = np.asarray(sub_q, np.float32)
            if sub_ep is not None:
                rewards = rewards - sub_ep
        self.adaptive.ensure(len(names))
        self.adaptive.update(X, midx, rewards)
        for rq in sub:
            rq.observed = True
        return rewards

    def route_batch(self, texts: Sequence[str], prefs, *, seed: int = 0
                    ) -> Tuple[RoutingDecision, List[TaskSignature], Dict]:
        """Sample-analyze-aggregate-route (paper batch mode).

        Returns (one decision for the whole batch, sampled signatures,
        stats).  ``batch_sample_frac`` of the texts (at least one) are
        drawn with ``default_rng(seed).choice`` as in the reference; the
        aggregate signature takes the majority task type / domain and
        the MAX complexity of the sample (the chosen model must handle
        the hardest sampled query)."""
        n = len(texts)
        if n == 0:
            raise ValueError("route_batch requires at least one text; "
                             "got an empty batch")
        k = max(1, int(round(n * self.batch_sample_frac)))
        rng = np.random.default_rng(seed)
        pick = rng.choice(n, size=min(k, n), replace=False)
        t0 = time.time()
        sigs = self.analyzer.analyze_batch([texts[i] for i in pick])
        t1 = time.time()
        tt = Counter(s.task_type for s in sigs).most_common(1)[0][0]
        dm = Counter(s.domain for s in sigs).most_common(1)[0][0]
        agg = TaskSignature(
            task_type=tt, domain=dm,
            complexity=max(s.complexity for s in sigs),
            confidence=float(np.mean([s.confidence for s in sigs])))
        decision = self.engine.route(prefs, agg)
        stats = {"batch": n, "sampled": len(pick),
                 "analyzer_s": t1 - t0, "route_s": time.time() - t1,
                 "aggregate_sig": agg}
        return decision, sigs, stats

    def serve(self, text: str, prefs, tokens: np.ndarray,
              max_new: int = 8) -> RoutedQuery:
        """Route + execute on the selected entry's runner."""
        rq = self.route(text, prefs)
        entry = self.mres.entry(rq.model)
        if entry.runner is not None:
            rq.response = entry.runner.generate(tokens, max_new=max_new)
        return rq

    def give_feedback(self, rq: RoutedQuery, thumbs_up: bool) -> float:
        """Thumbs feedback on a routed query: into the feedback store's
        per-cluster bias, and onto the model's latest telemetry event."""
        if self.telemetry is not None:
            self.telemetry.attach_thumbs(rq.model, thumbs_up)
        return self.feedback.record(rq.sig, rq.model, thumbs_up)
