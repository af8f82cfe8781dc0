"""Routing Engine (paper §3.4) — batched, array-first, one program per
batch on the engine's device.

Port of the JAX package's ``core/routing.py``.  Per batch: task vectors
(preference weights, accuracy axis raised to the analyzed complexity)
-> mask-fused cosine kNN (the ``router_topk`` kernel) -> blend of
user-weighted metric scores, feedback bias, bandit estimates and load
penalty at the k candidates -> candidate argmax, with the fallback
ladder (widened-kNN -> task-type-only -> generalist -> any).

The fused paths run all of it as one program: ``route_tokens_batch``
fuses the analyzer encoder in front of it (token ids in, model choices
out); ``route_many_batch`` takes signatures, and also serves the
mega-catalog programs (``mesh``: the catalog sharded over a routing
mesh; ``ivf``: IVF-pruned search from catalogs of ``ivf_min_n``
entries).  ``route_many_staged`` is
the reference's staged path and serves what the fused program cannot
express (a Thompson-policy bandit, ``fused=False``): one ``router_topk``
launch for the kNN (``ops.knn_rows``), then the blend, the bandit
scores at the candidate columns and the fallback ladder in host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.mres import MRES
from repro_torch.core.preferences import (DOMAINS, METRICS, TASK_TYPES,
                                          TaskSignature, resolve_batch)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_ACC = METRICS.index("accuracy")
_TT_IDX = {t: j for j, t in enumerate(TASK_TYPES)}
_DM_IDX = {d: j for j, d in enumerate(DOMAINS)}
_TT_ANY = len(TASK_TYPES)        # the matrices' all-True "no filter" row
_DM_ANY = len(DOMAINS)

# fallback ladder stage names, in the order the stages are tried
FALLBACK_LADDER = ("", "widened-knn", "task-type-only", "generalist", "any")


def cosine_sim(emb: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Cosine similarity of each row of emb against task vector t."""
    en = np.linalg.norm(emb, axis=1) + 1e-9
    tn = np.linalg.norm(t) + 1e-9
    return (emb @ t) / (en * tn)


@dataclass
class RoutingDecision:
    model: str
    score: float
    task_vector: np.ndarray
    similarity: float
    candidates: List[Tuple[str, float]]
    used_fallback: bool = False
    fallback_kind: str = ""
    stage_sizes: Dict[str, int] = field(default_factory=dict)


@dataclass
class RoutingBatch:
    """Struct-of-arrays result of one routing step; ``decision(b)`` and
    ``signature(b)`` materialize lazily, memoized.  ``stage`` indexes
    ``FALLBACK_LADDER``; ``cand_idx``/``cand_score`` are ranked by
    blended score, padded with (-1, -inf)."""
    names: List[str]
    model_idx: np.ndarray             # (B,) i32 chosen catalog rows
    score: np.ndarray                 # (B,) f32 blended winning scores
    stage: np.ndarray                 # (B,) i32 FALLBACK_LADDER index
    similarity: np.ndarray            # (B,) f32 winner's cosine similarity
    task_vectors: np.ndarray          # (B, M) f32
    cand_idx: np.ndarray              # (B, R) i32 ranked candidates
    cand_score: np.ndarray            # (B, R) f32 ranked blended scores
    n_filtered: np.ndarray            # (B,) i32 finite kNN hits (0 = fb)
    n_candidates: np.ndarray          # (B,) i32 per-row candidate count
    catalog_n: int
    knn_k: int
    r: int                            # max candidates per decision
    # analyzer outputs, present only on the fused tokens->decision path
    tt_idx: Optional[np.ndarray] = None
    dm_idx: Optional[np.ndarray] = None
    cx: Optional[np.ndarray] = None
    conf: Optional[np.ndarray] = None
    _cache: Optional[List[Optional[RoutingDecision]]] = field(
        default=None, repr=False, compare=False)
    _sigs: Optional[List[Optional[TaskSignature]]] = field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self._cache is None:
            self._cache = [None] * int(self.model_idx.shape[0])
        if self._sigs is None:
            self._sigs = [None] * int(self.model_idx.shape[0])

    def signature(self, b: int) -> TaskSignature:
        if self.tt_idx is None:
            raise ValueError("no analyzer outputs on this batch — "
                             "signatures exist only on the fused "
                             "route_tokens_batch path")
        s = self._sigs[b]
        if s is None:
            s = TaskSignature(
                task_type=TASK_TYPES[int(self.tt_idx[b])],
                domain=DOMAINS[int(self.dm_idx[b])],
                complexity=float(self.cx[b]),
                confidence=float(self.conf[b]))
            self._sigs[b] = s
        return s

    def signatures(self) -> List[TaskSignature]:
        return [self.signature(b) for b in range(len(self))]

    def __len__(self) -> int:
        return int(self.model_idx.shape[0])

    def model(self, b: int) -> str:
        return self.names[int(self.model_idx[b])]

    def models(self) -> List[str]:
        """Chosen model names, no decision materialization."""
        return [self.names[j] for j in self.model_idx.tolist()]

    def fallback_kind(self, b: int) -> str:
        return FALLBACK_LADDER[int(self.stage[b])]

    def decision(self, b: int) -> RoutingDecision:
        d = self._cache[b]
        if d is not None:
            return d
        stage = int(self.stage[b])
        cs = self.cand_score[b]
        fin = np.isfinite(cs)
        cand = [(self.names[j], s) for j, s in
                zip(self.cand_idx[b][fin].tolist(), cs[fin].tolist())]
        nf = int(self.n_filtered[b])
        if stage == 0:
            sizes = {"catalog": self.catalog_n, "knn": self.knn_k,
                     "filtered": nf, "candidates": nf}
        else:
            sizes = {"catalog": self.catalog_n, "knn": self.knn_k,
                     "filtered": 0,
                     "candidates": int(self.n_candidates[b])}
        d = RoutingDecision(
            model=self.names[int(self.model_idx[b])],
            score=float(self.score[b]),
            task_vector=self.task_vectors[b],
            similarity=float(self.similarity[b]),
            candidates=cand[:self.r],
            used_fallback=stage > 0,
            fallback_kind=FALLBACK_LADDER[stage],
            stage_sizes=sizes)
        self._cache[b] = d
        return d

    def decisions(self) -> List[RoutingDecision]:
        return [self.decision(b) for b in range(len(self))]


def _empty_batch(with_heads: bool) -> RoutingBatch:
    z = np.zeros(0, np.int32)
    zf = np.zeros(0, np.float32)
    heads = dict(tt_idx=z, dm_idx=z, cx=zf, conf=zf) if with_heads else {}
    return RoutingBatch(
        names=[], model_idx=z, score=zf, stage=z, similarity=zf,
        task_vectors=np.zeros((0, len(METRICS)), np.float32),
        cand_idx=np.zeros((0, 1), np.int32),
        cand_score=np.zeros((0, 1), np.float32),
        n_filtered=z, n_candidates=z, catalog_n=0, knn_k=0, r=0, **heads)


def _prefs_matrix(prefs_list) -> np.ndarray:
    """(B, M) preference-weight rows; a broadcast single prefs object
    tiles its memoized vector instead of restacking B rows."""
    first = prefs_list[0]
    if all(p is first for p in prefs_list):
        return np.tile(first.vector(), (len(prefs_list), 1))
    return np.stack([p.vector() for p in prefs_list])


class RoutingEngine:
    def __init__(self, mres: MRES, feedback=None, *, knn_k: int = 8,
                 confidence_threshold: float = 0.3,
                 feedback_weight: float = 0.5,
                 use_complexity: bool = True,
                 adaptive=None, adaptive_weight: float = 0.0,
                 load=None, load_weight: float = 0.0,
                 fused: bool = True, telemetry=None, tracer=None,
                 mesh=None, quantize: bool = False, ivf: bool = False,
                 nprobe: int = 8, ivf_min_n: int = 4096, device=None):
        self.device = resolve_device(device)
        self.mres = mres
        self.feedback = feedback
        self.knn_k = knn_k
        self.confidence_threshold = confidence_threshold
        self.feedback_weight = feedback_weight
        self.use_complexity = use_complexity   # ablation knob
        # one program per batch; ``fused=False`` (or a configuration the
        # program cannot express, a Thompson bandit) takes the staged
        # path
        self.fused = fused
        # dispatch counter sink (Telemetry) and span sink (obs.Tracer)
        # of the fused programs, set by OptiRoute
        self.telemetry = telemetry
        self.tracer = tracer
        # online-learning layer: LinUCB estimates at ``adaptive_weight``
        self.adaptive = adaptive
        self.adaptive_weight = float(adaptive_weight)
        # load-aware layer: expected-wait penalty at ``load_weight``
        self.load = load
        self.load_weight = float(load_weight)
        # mega-catalog knobs (kernels/ops.route_step), read per batch:
        #   mesh     — a routing mesh (launch.mesh.make_routing_mesh):
        #              the catalog split into column blocks, one per
        #              shard, bit-identical to the dense program
        #   quantize — serve from the int8 row-quantized catalog
        #   ivf      — two-level pruned search via MRES.ivf_index(),
        #              scanning the top-``nprobe`` cells per query; only
        #              at catalogs >= ``ivf_min_n``, and not with a mesh
        self.mesh = mesh
        self.quantize = bool(quantize)
        self.ivf = bool(ivf)
        self.nprobe = int(nprobe)
        self.ivf_min_n = int(ivf_min_n)

    # ------------------------------------------------------------------
    def task_vector(self, prefs, sig: TaskSignature) -> np.ndarray:
        """One query's task vector: the preference weights, the accuracy
        axis raised to the analyzed complexity (``use_complexity``)."""
        v = prefs.vector().copy()
        if getattr(self, "use_complexity", True):
            v[_ACC] = max(v[_ACC], float(sig.complexity))
        return v

    def route(self, prefs_or_profile, sig: TaskSignature) -> RoutingDecision:
        """Single-query routing — B=1 wrapper over ``route_many``."""
        return self.route_many([prefs_or_profile], [sig])[0]

    def _fused_ok(self) -> bool:
        """Whether the fused program can serve this configuration (a
        Thompson bandit samples host RNG per score, which no device
        program holds)."""
        if not self.fused:
            return False
        if self.adaptive is not None and self.adaptive_weight != 0.0:
            return (getattr(self.adaptive, "policy", "") == "linucb"
                    and hasattr(self.adaptive, "posterior"))
        return True

    def route_many(self, prefs_batch, sigs: Sequence[TaskSignature]
                   ) -> List[RoutingDecision]:
        """``route_many_batch`` with its decisions materialized, or
        ``route_many_staged`` when the configuration is not fusable."""
        if not self._fused_ok():
            return self.route_many_staged(prefs_batch, sigs)
        return self.route_many_batch(prefs_batch, sigs).decisions()

    def _blend_terms(self, n: int):
        """(theta, ainv, alpha, ad_weight, lpen) for this batch."""
        theta = ainv = None
        alpha = ad_w = 0.0
        if self.adaptive is not None and self.adaptive_weight != 0.0:
            self.adaptive.ensure(n)
            theta, ainv = self.adaptive.posterior()
            alpha = float(self.adaptive.alpha)
            ad_w = self.adaptive_weight
        return theta, ainv, alpha, ad_w, self._load_penalty(n)

    def _load_penalty(self, n: int) -> Optional[np.ndarray]:
        """(N,) load penalty at ``load_weight``, or None when off.  It
        joins the blend at the candidate columns, exactly once; the kNN
        selection stays pure cosine."""
        if self.load is None or self.load_weight == 0.0:
            return None
        self.load.ensure(n)
        # a tracker pre-sized for growth may carry more arms
        return self.load_weight * self.load.penalty()[:n]

    def _prepare_batch(self, prefs_batch, sigs: Sequence[TaskSignature]):
        """(sigs, W (B, M), T (B, M), ti (B,), di (B,))."""
        sigs = [s.validate() for s in sigs]
        B = len(sigs)
        prefs_list = resolve_batch(prefs_batch, B)
        if len(prefs_list) != B:
            raise ValueError(f"prefs batch size {len(prefs_list)} != "
                             f"signature batch size {B}")
        if B == 0:
            return sigs, None, None, None, None
        W = _prefs_matrix(prefs_list)
        T = W.copy()
        if self.use_complexity:
            cx = np.array([s.complexity for s in sigs], np.float32)
            T[:, _ACC] = np.maximum(T[:, _ACC], cx)
        thr = self.confidence_threshold
        ti = np.array([_TT_IDX[s.task_type] if s.confidence >= thr
                       else _TT_ANY for s in sigs], np.int32)
        di = np.array([_DM_IDX[s.domain] if s.confidence >= thr
                       else _DM_ANY for s in sigs], np.int32)
        return sigs, W, T, ti, di

    def _snapshot(self):
        snap = self.mres.snapshot()
        n = snap[0].shape[0]
        if n == 0:
            raise RuntimeError("empty MRES catalog")
        k = min(self.knn_k, n)
        return snap, n, k, min(max(5, k), n)

    # ------------------------------------------------------------------
    def route_many_batch(self, prefs_batch,
                         sigs: Sequence[TaskSignature]) -> RoutingBatch:
        """Array-first batched routing: ONE routing program (dense, or
        the sharded or IVF program when ``mesh``/``ivf`` say so)."""
        if not self._fused_ok():
            # fail loud: scoring a Thompson bandit with the program's
            # LinUCB formula (or bypassing fused=False) would change
            # routing for direct callers of this method
            raise ValueError(
                "engine configuration is not fusable (Thompson-policy "
                "bandit or fused=False) — use route_many / "
                "route_many_staged")
        sigs, W, T, ti, di = self._prepare_batch(prefs_batch, sigs)
        if len(sigs) == 0:
            return _empty_batch(False)
        snap, n, k, r = self._snapshot()
        emb, names, tt_matrix, dm_matrix, gmask, _ = snap
        theta, ainv, alpha, ad_w, lpen = self._blend_terms(n)
        fb = None
        if self.feedback is not None and self.feedback.has_bias():
            fb = self.feedback.bias_batch(sigs, names)
        ivf = None
        if self.ivf and self.mesh is None and n >= self.ivf_min_n:
            ivf = self.mres.ivf_index().as_tuple()
        out = ops.route_step(
            emb, tt_matrix, dm_matrix, gmask, T, W, ti, di, k=k, r=r,
            fb=fb, fb_weight=self.feedback_weight, theta=theta, ainv=ainv,
            alpha=alpha, ad_weight=ad_w, lpen=lpen, quant=self.quantize,
            mesh=self.mesh, ivf=ivf, nprobe=self.nprobe, device=self.device,
            telemetry=self.telemetry, tracer=self.tracer)
        return RoutingBatch(
            names=names, model_idx=out["model_idx"], score=out["score"],
            stage=out["stage"], similarity=out["similarity"],
            task_vectors=T, cand_idx=out["cand_idx"],
            cand_score=out["cand_score"], n_filtered=out["n_filtered"],
            n_candidates=out["n_candidates"], catalog_n=n, knn_k=k, r=r)

    # ------------------------------------------------------------------
    def route_tokens_batch(self, params, cfg, tokens,
                           prefs_batch) -> RoutingBatch:
        """Fused tokens->decision routing: ONE program from the
        analyzer's (B, L) token ids (``TaskAnalyzer.encode_batch``), its
        encoder ``params`` and its config ``cfg`` to model choices.  The
        returned batch carries the analyzer outputs (signatures
        materialize lazily)."""
        if params is not None and getattr(params, "cfg", cfg) != cfg:
            raise ValueError(f"analyzer config {cfg} does not match its "
                             f"encoder's {params.cfg}")
        if not self._fused_ok():
            raise ValueError(
                "engine configuration is not fusable (Thompson-policy "
                "bandit or fused=False) — analyze + route_many_staged")
        if self.mesh is not None:
            raise ValueError("route_tokens_batch is single-device only "
                             "(mesh-sharded catalogs keep the staged "
                             "analyze)")
        tokens = np.asarray(tokens, np.int32)
        B = tokens.shape[0]
        prefs_list = resolve_batch(prefs_batch, B)
        if len(prefs_list) != B:
            raise ValueError(f"prefs batch size {len(prefs_list)} != "
                             f"token batch size {B}")
        if B == 0:
            return _empty_batch(True)
        snap, n, k, r = self._snapshot()
        if self.ivf and n >= self.ivf_min_n:
            raise ValueError("route_tokens_batch does not compose with "
                             "IVF pruning — use the staged analyze")
        emb, names, tt_matrix, dm_matrix, gmask, _ = snap
        W = _prefs_matrix(prefs_list)
        theta, ainv, alpha, ad_w, lpen = self._blend_terms(n)
        fb_table = None
        if self.feedback is not None and self.feedback.has_bias():
            # identity-stable per store version: its device copy caches
            fb_table = self.feedback.bias_table(names)
        out = ops.analyze_route_step(
            params, tokens, emb, tt_matrix, dm_matrix, gmask, W, k=k, r=r,
            threshold=self.confidence_threshold, acc_col=_ACC,
            use_complexity=self.use_complexity, fb_table=fb_table,
            fb_weight=self.feedback_weight, theta=theta, ainv=ainv,
            alpha=alpha, ad_weight=ad_w, lpen=lpen, quant=self.quantize,
            device=self.device, telemetry=self.telemetry, tracer=self.tracer)
        return RoutingBatch(
            names=names, model_idx=out["model_idx"], score=out["score"],
            stage=out["stage"], similarity=out["similarity"],
            task_vectors=out["task_vectors"], cand_idx=out["cand_idx"],
            cand_score=out["cand_score"], n_filtered=out["n_filtered"],
            n_candidates=out["n_candidates"], catalog_n=n, knn_k=k, r=r,
            tt_idx=out["tt_idx"], dm_idx=out["dm_idx"], cx=out["cx"],
            conf=out["conf"])

    # ------------------------------------------------------------------
    def _knn_batch(self, T: np.ndarray, k: int, ti: np.ndarray,
                   di: np.ndarray, snap) -> Tuple[np.ndarray, np.ndarray]:
        """Mask-fused batched kNN: (vals (B, k), idx (B, k)), one
        ``router_topk`` launch (``ops.knn_rows``: each query reads its
        (task type, domain) row of the stacked filter table on the
        device).  Rows failing the filters surface as vals == -inf;
        the kNN is fp32 whatever ``quantize`` says, as in the
        reference."""
        emb, _, tt_matrix, dm_matrix, gmask, _ = snap
        return ops.knn_rows(emb, tt_matrix, dm_matrix, gmask, T, ti, di,
                            k=k, device=self.device)

    def route_many_staged(self, prefs_batch, sigs: Sequence[TaskSignature]
                          ) -> List[RoutingDecision]:
        """Staged path (the reference's pre-fusion semantics): the kNN
        on the device, then the candidate blend, the bandit scores at
        the union of candidate columns (cost ~ B*k, not N), the load
        penalty and the fallback ladder in host numpy, with eager
        decision objects.  Serves configurations the fused program
        cannot express (a Thompson bandit) and is the oracle the fused
        path is held against."""
        sigs, W, T, ti, di = self._prepare_batch(prefs_batch, sigs)
        B = len(sigs)
        if B == 0:
            return []
        snap, n, k, r = self._snapshot()
        emb, names, tt_matrix, dm_matrix, gmask, _ = snap
        adaptive_on = (self.adaptive is not None
                       and self.adaptive_weight != 0.0)
        if adaptive_on:
            self.adaptive.ensure(n)
        lpen = self._load_penalty(n)
        vals, idx = self._knn_batch(T, k, ti, di, snap)
        finite = np.isfinite(vals) & (idx >= 0)
        idx = np.where(finite, idx, 0)        # safe gather index
        has_primary = finite.any(axis=1)

        cscores = np.einsum("bm,bkm->bk", W, emb[idx])            # (B, k)
        if self.feedback is not None:
            cscores = cscores + self.feedback_weight * \
                self.feedback.bias_for(sigs, names, idx)
        if adaptive_on:
            # bandit scores only at the union of candidate columns; a
            # Thompson bandit draws one posterior sample per column, so
            # the union's sorted order fixes its random stream
            cols, inv = np.unique(idx, return_inverse=True)
            asub = self.adaptive.scores_at(T, cols)               # (B, C)
            cscores = cscores + self.adaptive_weight * \
                np.take_along_axis(asub, inv.reshape(idx.shape), axis=1)
        if lpen is not None:
            cscores = cscores - lpen[idx]
        cscores = np.where(finite, cscores, -np.inf)
        order = np.argsort(-cscores, axis=1, kind="stable")       # (B, k)
        knn_found = finite.sum(axis=1).tolist()

        idx_s = np.take_along_axis(idx, order, axis=1).tolist()
        sc_s = np.take_along_axis(cscores, order, axis=1).tolist()
        fin_s = np.take_along_axis(finite, order, axis=1).tolist()
        sim_s = np.take_along_axis(vals, order, axis=1)[:, 0].tolist()

        out: List[Optional[RoutingDecision]] = [None] * B
        for b in np.flatnonzero(has_primary):
            ranked = [(names[j], s) for j, s, f in
                      zip(idx_s[b], sc_s[b], fin_s[b]) if f]
            out[b] = RoutingDecision(
                model=names[idx_s[b][0]], score=sc_s[b][0],
                task_vector=T[b], similarity=sim_s[b],
                used_fallback=False, fallback_kind="",
                candidates=ranked[:r],
                stage_sizes={"catalog": n, "knn": k,
                             "filtered": knn_found[b],
                             "candidates": knn_found[b]})
        # the ladder for rows whose kNN came up empty: widened-kNN (rows
        # passing both filters; a safety net, since the fused search
        # already saw them) -> task-type-only -> generalist -> any
        for b in np.flatnonzero(~has_primary):
            tt_b = tt_matrix[ti[b]]
            bias_b = (self.feedback.bias(sigs[b], names)
                      if self.feedback is not None else None)
            out[b] = self._route_fallback(
                b, emb, names, T, W, (tt_b & dm_matrix[di[b]], tt_b, gmask),
                bias_b, adaptive_on, lpen, n, k, r)
        return out                      # type: ignore[return-value]

    def _route_fallback(self, b: int, emb, names, T, W, ladder, bias_row,
                        adaptive_on: bool, lpen, n: int, k: int,
                        r: int) -> RoutingDecision:
        """Fallback ladder for one row whose kNN came up empty."""
        for kind, mask in zip(FALLBACK_LADDER[1:], ladder):
            if mask.any():
                break
        else:
            kind, mask = FALLBACK_LADDER[-1], np.ones(n, bool)
        cidx = np.flatnonzero(mask)
        scores = emb[cidx] @ W[b]
        if bias_row is not None:
            scores = scores + self.feedback_weight * bias_row[cidx]
        if adaptive_on:
            scores = scores + self.adaptive_weight * \
                self.adaptive.scores_at(T[b:b + 1], cidx)[0]
        if lpen is not None:
            scores = scores - lpen[cidx]
        order = np.argsort(-scores, kind="stable")
        best = int(cidx[order[0]])
        return RoutingDecision(
            model=names[best], score=float(scores[order[0]]),
            task_vector=T[b],
            similarity=float(cosine_sim(emb[best:best + 1], T[b])[0]),
            candidates=[(names[int(cidx[j])], float(scores[j]))
                        for j in order[:r]],
            used_fallback=True, fallback_kind=kind,
            stage_sizes={"catalog": n, "knn": k, "filtered": 0,
                         "candidates": int(len(cidx))})
