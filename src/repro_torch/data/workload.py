"""Synthetic query workload generator (the paper's "query logs of a
production MLaaS cloud provider" stand-in, §3.2).

Each query is built from a task-type template + domain lexicon words +
complexity-controlled filler.  The generator records the ground-truth
TaskSignature (the label the analyzer is trained against) and a
per-model ground-truth quality table used by the routing benchmarks.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.preferences import DOMAINS, TASK_TYPES, TaskSignature

# ----------------------------------------------------------------------
# templates & lexicons
# ----------------------------------------------------------------------

TEMPLATES: Dict[str, List[str]] = {
    "chat": ["hello can you help me with {topic}",
             "i have a question about {topic}",
             "what do you think about {topic}"],
    "code": ["write a python function that computes {topic}",
             "fix the bug in this code {blob}",
             "refactor this module for readability {blob}"],
    "reasoning": ["solve this step by step {blob}",
                  "prove that {topic} holds for all cases",
                  "which option is correct and why {blob}"],
    "summarization": ["summarize the following article {blob}",
                      "give me a tl dr of this document {blob}",
                      "condense these meeting notes {blob}"],
    "classification": ["find the sentiment of the passage {blob}",
                       "classify this ticket into a category {blob}",
                       "label the intent of this message {blob}"],
    "translation": ["translate this passage to german {blob}",
                    "convert the following text into french {blob}",
                    "translate to spanish keeping the tone {blob}"],
    "transcription": ["transcribe the attached audio about {topic}",
                      "produce a transcript of this recording {topic}",
                      "caption the spoken audio {topic}"],
    "vqa": ["looking at the image what is {topic}",
            "answer the question about the attached picture {topic}",
            "from the screenshot determine {topic}"],
    "captioning": ["describe the attached image of {topic}",
                   "write alt text for this picture of {topic}",
                   "caption this photo about {topic}"],
    "creative-writing": ["write a short story about {topic}",
                         "compose a poem on {topic}",
                         "draft a fictional dialogue about {topic}"],
    "long-context": ["using the entire report below answer {topic} {blob}",
                     "search this long document for {topic} {blob}",
                     "cross reference the chapters below about {topic} {blob}"],
}

DOMAIN_LEXICON: Dict[str, List[str]] = {
    "general": ["weather", "travel", "cooking", "music", "history",
                "sports", "gardening"],
    "software": ["kubernetes", "compiler", "database", "frontend", "api",
                 "microservice", "deployment", "regression"],
    "finance": ["portfolio", "derivatives", "equity", "hedging", "ledger",
                "liquidity", "arbitrage", "quarterly"],
    "legal": ["contract", "liability", "statute", "plaintiff", "clause",
              "compliance", "jurisdiction", "tort"],
    "healthcare": ["diagnosis", "dosage", "radiology", "oncology",
                   "symptom", "clinical", "pathology", "triage"],
    "multilingual": ["german", "mandarin", "localization", "dialect",
                     "idiom", "bilingual", "transliteration"],
}

_FILLER = ["the", "report", "shows", "that", "we", "observed", "several",
           "items", "during", "review", "and", "noted", "further", "points",
           "for", "discussion", "in", "section"]
_HARD_MARKERS = ["however", "sarcastically", "notwithstanding", "paradox",
                 "ambiguous", "nested", "caveat", "irony", "subtle",
                 "counterintuitive"]


@dataclass(frozen=True)
class QueryRecord:
    text: str
    sig: TaskSignature          # ground truth implicit preferences
    id: int = 0


def _complexity_blob(rng, complexity: float, domain_words) -> Tuple[str, int]:
    """Filler blob whose length/markers encode the complexity."""
    n_fill = int(10 + complexity * 120)
    words = list(rng.choice(_FILLER, n_fill))
    n_hard = int(round(complexity * 6))
    for _ in range(n_hard):
        words.insert(int(rng.integers(0, len(words))),
                     str(rng.choice(_HARD_MARKERS)))
    for _ in range(3):
        words.insert(int(rng.integers(0, len(words))),
                     str(rng.choice(domain_words)))
    return " ".join(words), n_hard


def make_query(rng: np.random.Generator, *, task_type: Optional[str] = None,
               domain: Optional[str] = None,
               complexity: Optional[float] = None, qid: int = 0
               ) -> QueryRecord:
    tt = task_type or str(rng.choice(TASK_TYPES))
    dm = domain or str(rng.choice(DOMAINS))
    cx = float(rng.random()) if complexity is None else float(complexity)
    lex = DOMAIN_LEXICON[dm]
    template = str(rng.choice(TEMPLATES[tt]))
    blob, _ = _complexity_blob(rng, cx, lex)
    topic = " ".join(rng.choice(lex, 2))
    text = template.format(topic=topic, blob=blob)
    # quantize ground-truth complexity to what is recoverable from text
    cx_obs = min(1.0, (len(text.split()) - 10) / 130.0 * 0.7
                 + sum(text.count(m) for m in _HARD_MARKERS) / 6.0 * 0.3 + 0.0)
    sig = TaskSignature(task_type=tt, domain=dm,
                        complexity=round(max(0.0, cx_obs), 4))
    return QueryRecord(text=text, sig=sig, id=qid)


def inflate_query(rec: QueryRecord, target_words: int,
                  rng: np.random.Generator) -> QueryRecord:
    """Pad a query's middle with context filler to ``target_words``
    keeping the task description at the edges (the paper's 10k+-word
    long-query shape).  The signature is unchanged: the blob is context,
    not task."""
    words = rec.text.split()
    need = target_words - len(words)
    if need <= 0:
        return rec
    blob = list(rng.choice(_FILLER, need))
    cut = max(len(words) // 2, 1)
    return dataclasses.replace(
        rec, text=" ".join(words[:cut] + blob + words[cut:]))


def make_workload(n: int, seed: int = 0, *, task_type=None, domain=None,
                  complexity=None, long_frac: float = 0.0,
                  long_words: Tuple[int, int] = (200, 2000)
                  ) -> List[QueryRecord]:
    """``long_frac`` of the queries are inflated to long-context shape
    (uniform word count in ``long_words``) — the paper's production
    query-log mix."""
    rng = np.random.default_rng(seed)
    out = [make_query(rng, task_type=task_type, domain=domain,
                      complexity=complexity, qid=i) for i in range(n)]
    if long_frac:
        for i in range(n):
            if rng.random() < long_frac:
                out[i] = inflate_query(
                    out[i], int(rng.integers(*long_words)), rng)
    return out


# ----------------------------------------------------------------------
# ground-truth model quality (for routing benchmarks)
# ----------------------------------------------------------------------

def meta_of(entry) -> Dict:
    """The ``quality_of`` meta dict for an MRES-style entry (anything
    with name / raw_metrics / task_types / domains attributes)."""
    return {"name": entry.name,
            "accuracy": float(entry.raw_metrics.get("accuracy", 0.5)),
            "task_types": tuple(entry.task_types),
            "domains": tuple(entry.domains)}


def quality_of(entry_meta: Dict, sig: TaskSignature) -> float:
    """Synthetic probability that a model answers a query well.

    Capability model: a model with catalog accuracy ``a`` and domain /
    task-type tags answers with quality a - penalty(complexity beyond
    capability) - penalty(out-of-domain).  Deterministic given
    (entry, sig) so experiments are reproducible.
    """
    acc = float(entry_meta.get("accuracy", 0.5))
    cap = acc                                  # capability proxy
    q = acc
    if sig.complexity > cap:
        q -= 0.8 * (sig.complexity - cap)
    if sig.task_type not in entry_meta.get("task_types", ()):  # wrong tool
        q -= 0.25
    if sig.domain not in entry_meta.get("domains", ()):
        q -= 0.15
    return float(np.clip(q, 0.0, 1.0))


# ----------------------------------------------------------------------
# bursty open-loop traffic (load-/SLO-aware serving) and multi-tenant
# traffic (the async front end and the soak)
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class TrafficScenario:
    """A bursty open-loop arrival episode.

    Arrivals follow a piecewise-homogeneous Poisson process: ``base_rate``
    req/s outside the burst window, ``burst_rate`` inside it (the window
    spans ``[burst_start, burst_start + burst_len)`` as fractions of the
    episode).  Every request carries the same latency SLO
    ``deadline_ms``.  The stress shape this models: steady traffic a
    catalog handles easily, then a burst that saturates the statically
    best-scoring model while its alternates still have headroom.
    """
    duration_s: float = 20.0
    base_rate: float = 30.0           # req/s outside the burst
    burst_rate: float = 150.0         # req/s inside the burst
    burst_start: float = 0.25         # fraction of the episode
    burst_len: float = 0.35           # fraction of the episode
    deadline_ms: float = 400.0
    seed: int = 0
    task_type: Optional[str] = "chat"
    domain: Optional[str] = "general"

    def validate(self) -> "TrafficScenario":
        assert self.duration_s > 0 and self.base_rate > 0
        assert self.burst_rate >= self.base_rate
        assert 0.0 <= self.burst_start < 1.0
        assert 0.0 < self.burst_len <= 1.0 - self.burst_start
        return self

    @property
    def burst_window_s(self) -> Tuple[float, float]:
        t0 = self.burst_start * self.duration_s
        return t0, t0 + self.burst_len * self.duration_s


def poisson_arrivals(sc: TrafficScenario) -> np.ndarray:
    """Arrival times for the scenario by thinning: draw a homogeneous
    process at the peak rate, keep each point with prob rate(t)/peak.
    Deterministic in ``sc.seed``."""
    sc = sc.validate()
    rng = np.random.default_rng(sc.seed)
    rmax = sc.burst_rate
    ts: List[np.ndarray] = []
    t = 0.0
    while t < sc.duration_s:                 # chunked gap draws
        gaps = rng.exponential(1.0 / rmax, int(rmax * sc.duration_s) + 64)
        chunk = t + np.cumsum(gaps)
        ts.append(chunk)
        t = float(chunk[-1])
    all_ts = np.concatenate(ts)
    all_ts = all_ts[all_ts < sc.duration_s]
    b0, b1 = sc.burst_window_s
    rate = np.where((all_ts >= b0) & (all_ts < b1),
                    sc.burst_rate, sc.base_rate)
    keep = rng.random(all_ts.size) < rate / rmax
    return all_ts[keep]


# ----------------------------------------------------------------------
# multi-tenant traffic (async serving + soak harness)
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class TenantSpec:
    """One tenant's share of a multi-tenant episode.

    ``rate_scale`` multiplies the base scenario's arrival rates (a
    flooding tenant is simply ``rate_scale`` >> 1); ``weight`` is the
    fair-dequeue share the serving layer should give it; ``rate_limit``
    (req/s) is the token-bucket ceiling intake enforces (None = no
    limit); ``deadline_ms`` overrides the base scenario's SLO for this
    tenant's requests (None = inherit)."""
    name: str
    weight: float = 1.0
    rate_scale: float = 1.0
    rate_limit: Optional[float] = None
    deadline_ms: Optional[float] = None

    def validate(self) -> "TenantSpec":
        assert self.name, "tenant needs a name"
        assert self.weight > 0 and self.rate_scale > 0
        assert self.rate_limit is None or self.rate_limit > 0
        return self


@dataclass(frozen=True)
class MultiTenantScenario:
    """A shared bursty episode fanned out across tenants: every tenant
    draws its own independent Poisson process shaped like ``base``
    scaled by its ``rate_scale`` (seeded per tenant, so episodes are
    reproducible and tenants are independent)."""
    base: TrafficScenario = TrafficScenario()
    tenants: Tuple[TenantSpec, ...] = (
        TenantSpec("acme"), TenantSpec("globex"))

    def validate(self) -> "MultiTenantScenario":
        self.base.validate()
        names = [t.validate().name for t in self.tenants]
        assert len(names) == len(set(names)), f"duplicate tenants: {names}"
        assert names, "need at least one tenant"
        return self

    def deadline_ms_of(self, tenant_idx: int) -> float:
        t = self.tenants[tenant_idx]
        return float(t.deadline_ms if t.deadline_ms is not None
                     else self.base.deadline_ms)


def multi_tenant_arrivals(sc: MultiTenantScenario
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Merged arrival stream: ``(times, tenant_idx)`` — times sorted
    ascending, ``tenant_idx[i]`` indexing ``sc.tenants``.  Each
    tenant's process is an independently-seeded copy of the base
    scenario with its rates scaled by ``rate_scale``."""
    sc = sc.validate()
    times: List[np.ndarray] = []
    idx: List[np.ndarray] = []
    for i, t in enumerate(sc.tenants):
        per = dataclasses.replace(
            sc.base,
            base_rate=sc.base.base_rate * t.rate_scale,
            burst_rate=sc.base.burst_rate * t.rate_scale,
            seed=sc.base.seed + 7919 * (i + 1))
        a = poisson_arrivals(per)
        times.append(a)
        idx.append(np.full(a.size, i, np.int64))
    ts = np.concatenate(times) if times else np.zeros(0)
    ti = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    order = np.argsort(ts, kind="stable")
    return ts[order], ti[order]


def jain_fairness(x: Sequence[float]) -> float:
    """Jain's fairness index of per-tenant allocations: 1.0 when all
    equal, -> 1/n as one tenant dominates.  Feed it WEIGHT-NORMALIZED
    goodput (served/weight) so weighted fairness scores as 1.0."""
    v = np.asarray(list(x), np.float64)
    if v.size == 0 or not np.any(v):
        return 1.0
    return float(v.sum() ** 2 / (v.size * (v ** 2).sum()))


# ----------------------------------------------------------------------
# non-stationary scenarios (online-learning benchmarks)
# ----------------------------------------------------------------------

DRIFT_KINDS = ("quality-drift", "domain-shift", "model-degrade")


@dataclass(frozen=True)
class DriftScenario:
    """A non-stationary traffic episode for the adaptive router.

    kind:
      * ``quality-drift``  — every model's true quality follows a slow
        deterministic sinusoid around its catalog value (phase-shifted
        per model, amplitude ``drift_amp``), so the best model keeps
        changing;
      * ``domain-shift``   — the query mix jumps from ``domain_a`` to
        ``domain_b`` at ``shift_frac`` of the episode (quality table
        static: the context distribution is what moves);
      * ``model-degrade``  — ``degrade_model`` (default: the catalog's
        accuracy leader) loses ``degrade_delta`` true quality at
        ``shift_frac`` of the episode while its catalog metrics stay
        stale — the recovery-after-drift stress test.
    """
    kind: str = "model-degrade"
    n_steps: int = 60
    batch: int = 16
    seed: int = 0
    task_type: Optional[str] = None
    drift_amp: float = 0.35
    drift_period: float = 40.0
    shift_frac: float = 0.5
    domain_a: str = "general"
    domain_b: str = "healthcare"
    degrade_model: Optional[str] = None
    degrade_delta: float = 0.6

    def validate(self) -> "DriftScenario":
        assert self.kind in DRIFT_KINDS, self.kind
        assert 0.0 < self.shift_frac < 1.0
        return self


class NonStationaryWorkload:
    """Per-step query batches plus the time-varying ground-truth
    quality table ``quality(t, model, sig)`` they are scored against.

    ``entries_meta`` is one ``quality_of`` meta dict per catalog model
    (see ``meta_of``), in catalog order; batches and the quality
    trajectory are deterministic in (scenario.seed, t).
    """

    def __init__(self, entries_meta: Sequence[Dict],
                 scenario: DriftScenario):
        self.meta = list(entries_meta)
        self.sc = scenario.validate()
        self.names = [m["name"] for m in self.meta]
        self._col = {n: j for j, n in enumerate(self.names)}
        self.shift_step = int(round(self.sc.n_steps * self.sc.shift_frac))
        if self.sc.kind == "model-degrade":
            name = self.sc.degrade_model or max(
                self.meta, key=lambda m: m["accuracy"])["name"]
            self._degrade_idx = self._col[name]
        else:
            self._degrade_idx = -1

    @property
    def degraded_model(self) -> Optional[str]:
        return (self.names[self._degrade_idx]
                if self._degrade_idx >= 0 else None)

    # ---------------- queries ----------------
    def _domain_at(self, t: int) -> Optional[str]:
        if self.sc.kind != "domain-shift":
            return None                       # uniform domain mix
        return self.sc.domain_a if t < self.shift_step else self.sc.domain_b

    def batch(self, t: int) -> List[QueryRecord]:
        """The step-t query batch (deterministic in (seed, t))."""
        assert 0 <= t < self.sc.n_steps, t
        rng = np.random.default_rng(
            np.random.SeedSequence([self.sc.seed, t]))
        return [make_query(rng, task_type=self.sc.task_type,
                           domain=self._domain_at(t),
                           qid=t * self.sc.batch + i)
                for i in range(self.sc.batch)]

    # ---------------- time-varying quality ----------------
    def _offsets(self, t: int) -> np.ndarray:
        """(N,) true-quality offsets vs. the static catalog table."""
        n = len(self.meta)
        off = np.zeros(n, np.float64)
        if self.sc.kind == "quality-drift":
            phase = 2.0 * np.pi * np.arange(n) / max(n, 1)
            off = self.sc.drift_amp * np.sin(
                2.0 * np.pi * t / self.sc.drift_period + phase)
        elif self.sc.kind == "model-degrade" and t >= self.shift_step:
            off[self._degrade_idx] = -self.sc.degrade_delta
        return off

    def quality(self, t: int, model: str, sig: TaskSignature) -> float:
        """True quality of ``model`` answering ``sig`` at step ``t``."""
        j = self._col[model]
        return float(np.clip(quality_of(self.meta[j], sig)
                             + self._offsets(t)[j], 0.0, 1.0))

    def quality_matrix(self, t: int, sigs: Sequence[TaskSignature]
                       ) -> np.ndarray:
        """(B, N) true qualities of every model on every query — the
        oracle table regret accounting is computed against."""
        base = np.array([[quality_of(m, s) for m in self.meta]
                         for s in sigs], np.float64)
        return np.clip(base + self._offsets(t)[None, :], 0.0, 1.0)


# ----------------------------------------------------------------------
# repeat-heavy replay traffic (semantic-cache benchmarks)
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class ZipfReplayScenario:
    """Repeat-heavy traffic: a fixed pool of ``n_unique`` queries
    replayed ``n_requests`` times with Zipf-distributed popularity
    (rank r drawn with probability proportional to ``r**-zipf_a``) —
    the production query-log shape where a small head of queries
    dominates traffic and a semantic cache pays for itself.

    ``zipf_a`` > 1 concentrates mass on the head (the classic web/LLM
    traffic exponent is ~1); after the pool has been seen once, the
    steady-state repeat fraction is what the cache-hit benchmarks
    measure.  Deterministic in ``seed``.
    """
    n_unique: int = 64
    n_requests: int = 512
    zipf_a: float = 1.1
    seed: int = 0
    task_type: Optional[str] = None
    domain: Optional[str] = None
    complexity: Optional[float] = None

    def validate(self) -> "ZipfReplayScenario":
        assert self.n_unique > 0 and self.n_requests > 0
        assert self.zipf_a > 0.0
        return self

    @property
    def rank_probs(self) -> np.ndarray:
        """(n_unique,) popularity of each pool rank (descending)."""
        p = np.arange(1, self.n_unique + 1, dtype=np.float64) ** -self.zipf_a
        return p / p.sum()


def zipf_replay(sc: ZipfReplayScenario
                ) -> Tuple[List[QueryRecord], np.ndarray]:
    """(query pool, replay order): ``order`` is the (n_requests,) array
    of pool indices in arrival order, drawn from the scenario's Zipf
    popularity.  Replay ``pool[order[i]]`` to reproduce the episode."""
    sc = sc.validate()
    pool = make_workload(sc.n_unique, seed=sc.seed,
                         task_type=sc.task_type, domain=sc.domain,
                         complexity=sc.complexity)
    rng = np.random.default_rng(np.random.SeedSequence([sc.seed, 1]))
    order = rng.choice(sc.n_unique, size=sc.n_requests, p=sc.rank_probs)
    return pool, order.astype(np.int64)


# ----------------------------------------------------------------------
# bursty open-loop traffic + discrete-event serving simulation
# (load-/SLO-aware routing benchmarks)
# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# discrete-event serving simulation (load-/SLO-aware routing)
# ----------------------------------------------------------------------

class ServingSimulator:
    """Discrete-event queueing simulator over a routed catalog.

    Model ``n`` has ``capacity[n]`` parallel servers with deterministic
    per-request service time ``service_s[n]``.  Requests arrive at the
    given times, are assigned a model by ``route_fn`` (which sees the
    LIVE tracker state, because every queue/slot transition is mirrored
    into ``tracker`` as it happens), wait FIFO for a free server,
    execute, and complete.  Shed requests never occupy a server.

    ``route_fn(i, t) -> (model_col, admission_kind)`` with kind in
    ``repro_torch.serving.load.ADMISSION_KINDS``; a load-blind policy simply
    always returns ("admitted", static choice).

    ``run`` returns packed per-request arrays (model, admission codes,
    wait/latency seconds, SLO misses) plus aggregate percentiles — the
    evidence table the load-aware benchmark reads.
    """

    def __init__(self, service_s: Sequence[float],
                 capacity: Sequence[float], tracker=None):
        self.service_s = np.asarray(service_s, np.float64)
        self.capacity = np.asarray(capacity, np.int64)
        assert self.service_s.shape == self.capacity.shape
        assert (self.service_s > 0).all() and (self.capacity > 0).all()
        self.tracker = tracker
        if tracker is not None:
            tracker.ensure(len(self.service_s))
            for j, c in enumerate(self.capacity):
                tracker.set_capacity(j, float(c))

    # ------------------------------------------------------------------
    def run(self, arrivals: np.ndarray,
            route_fn: Callable[[int, float], Tuple[int, str]],
            deadline_ms: Optional[float] = None) -> Dict[str, np.ndarray]:
        arrivals = np.asarray(arrivals, np.float64)
        R = arrivals.size
        n = len(self.service_s)
        busy = np.zeros(n, np.int64)
        queues: List[List[Tuple[float, int]]] = [[] for _ in range(n)]
        qhead = np.zeros(n, np.int64)        # FIFO pop index per model
        done_t = np.full(R, np.nan)
        start_t = np.full(R, np.nan)
        model = np.full(R, -1, np.int64)
        shed = np.zeros(R, bool)
        rerouted = np.zeros(R, bool)
        events: List[Tuple[float, int, int]] = []   # (finish, model, req)
        trk = self.tracker

        def begin(req: int, m: int, now: float) -> None:
            busy[m] += 1
            start_t[req] = now
            fin = now + self.service_s[m]
            done_t[req] = fin
            if trk is not None:
                trk.start(m)
            heapq.heappush(events, (fin, m, req))

        def drain_until(now: float) -> None:
            while events and events[0][0] <= now:
                fin, m, req = heapq.heappop(events)
                busy[m] -= 1
                if trk is not None:
                    trk.finish(m, float(self.service_s[m]))
                if qhead[m] < len(queues[m]):        # hand the slot on
                    _, nxt = queues[m][qhead[m]]
                    qhead[m] += 1
                    begin(nxt, m, fin)

        for i, t in enumerate(arrivals):
            drain_until(float(t))
            m, kind = route_fn(i, float(t))
            if kind == "shed":
                shed[i] = True
                model[i] = m
                continue
            rerouted[i] = kind == "rerouted"
            model[i] = m
            if trk is not None:
                trk.admit(m)
            if busy[m] < self.capacity[m]:
                begin(i, m, float(t))
            else:
                queues[m].append((float(t), i))
        drain_until(np.inf)                          # flush the tail

        served = ~shed
        latency = np.where(served, done_t - arrivals, np.nan)
        wait = np.where(served, start_t - arrivals, np.nan)
        out: Dict[str, np.ndarray] = {
            "arrival_s": arrivals, "model": model, "shed": shed,
            "rerouted": rerouted, "latency_s": latency, "wait_s": wait,
        }
        lat_ok = latency[served]
        out["p50_s"] = float(np.quantile(lat_ok, 0.5)) if lat_ok.size else 0.0
        out["p99_s"] = float(np.quantile(lat_ok, 0.99)) if lat_ok.size else 0.0
        if deadline_ms is not None:
            # a shed request is an SLO miss by definition: it got no answer
            miss = shed | (np.nan_to_num(latency, nan=np.inf)
                           > deadline_ms / 1e3)
            out["slo_miss"] = miss
            out["slo_miss_rate"] = float(miss.mean()) if R else 0.0
        return out
