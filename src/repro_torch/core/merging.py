"""Model merging fallback (paper §5; port of the JAX package's
``core/merging.py``).

When no catalog entry meets the user's criteria, OptiRoute synthesizes
a new entry by model-soup weight averaging (Wortsman et al. 2022) of
same-family checkpoints that each partly meet them.  The merged
entry's metrics are the weight-interpolation of the parents' metrics,
the first-order model-soup prediction.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mres import MRES, RAW_TO_AXIS, ModelEntry
from repro_torch.core.preferences import (METRICS, TaskSignature,
                                          UserPreferences)
from repro_torch.models.model import tree_map


def soup(param_trees: Sequence, weights: Optional[Sequence[float]] = None):
    """Weighted average of same-structure parameter trees (nested dicts
    and lists of tensors, as ``models.model`` holds them), formed as
    the reference forms it: each leaf in f32 times its weight rounded
    to f32, summed in parent order, cast back to the first parent's
    dtype."""
    n = len(param_trees)
    if n < 1:
        raise ValueError("soup needs at least one parameter tree")
    w = np.full(n, 1.0 / n) if weights is None \
        else np.asarray(weights, np.float64)
    if len(w) != n or abs(float(w.sum()) - 1.0) >= 1e-6:
        raise ValueError(f"soup weights {w} must be {n} and sum to 1")
    w32 = w.astype(np.float32)

    def avg(*leaves):
        def scaled(leaf, wi):
            return leaf.float() * torch.tensor(wi, dtype=torch.float32,
                                               device=leaf.device)
        acc = scaled(leaves[0], w32[0])
        for wi, leaf in zip(w32[1:], leaves[1:]):
            acc = acc + scaled(leaf, wi)
        return acc.to(leaves[0].dtype)

    with torch.no_grad():
        return tree_map(avg, *param_trees)


def mergeable(a: ModelEntry, b: ModelEntry) -> bool:
    """Soups only make sense within a family (same param structure)."""
    return (a.family == b.family and a.n_params == b.n_params
            and a.name != b.name)


def merged_metrics(parents: Sequence[ModelEntry],
                   weights: Sequence[float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for raw in RAW_TO_AXIS:
        out[raw] = float(sum(
            w * float(p.raw_metrics[raw]) for w, p in zip(weights, parents)))
    return out


class ModelMerger:
    """Creates soup entries on the fly when routing scores fall short.

    ``maybe_merge`` is called by the orchestrator when the best routed
    score is below ``score_threshold``: it searches same-family pairs,
    predicts the merged entry's user-weighted score by metric
    interpolation, and if some pair beats the incumbent it registers the
    soup (averaging the runners' parameters when both are loaded)."""

    def __init__(self, mres: MRES, score_threshold: float = 0.0,
                 grid: int = 5):
        self.mres = mres
        self.score_threshold = score_threshold
        self.grid = grid
        self.created: List[str] = []

    def candidate_pairs(self) -> List[Tuple[ModelEntry, ModelEntry]]:
        entries = self.mres.entries
        return [(a, b) for i, a in enumerate(entries)
                for b in entries[i + 1:] if mergeable(a, b)]

    def predict_score(self, metrics: Dict[str, float],
                      prefs: UserPreferences) -> float:
        """User-weighted score of a hypothetical entry, against the
        current catalog normalization."""
        entries = self.mres.entries
        w = prefs.vector()
        score = 0.0
        for raw, (axis, hib) in RAW_TO_AXIS.items():
            col = np.array([float(e.raw_metrics[raw]) for e in entries])
            lo, hi = col.min(), col.max()
            x = float(metrics[raw])
            norm = 1.0 if hi - lo < 1e-12 \
                else float(np.clip((x - lo) / (hi - lo), 0, 1))
            if not hib:
                norm = 1.0 - norm
            score += w[METRICS.index(axis)] * norm
        return score

    def maybe_merge(self, prefs: UserPreferences, sig: TaskSignature,
                    incumbent_score: float) -> Optional[ModelEntry]:
        """The soup must beat the INCUMBENT's score (``score_threshold``
        only gates whether the orchestrator attempts a merge at all)."""
        best = None
        best_score = incumbent_score
        for a, b in self.candidate_pairs():
            for i in range(1, self.grid):
                alpha = i / self.grid
                metrics = merged_metrics([a, b], [alpha, 1 - alpha])
                s = self.predict_score(metrics, prefs)
                if s > best_score + 1e-9:
                    best, best_score, best_alpha = (a, b), s, alpha
        if best is None:
            return None
        a, b = best
        name = f"soup:{a.name}+{b.name}@{best_alpha:.2f}"
        runner = None
        if a.runner is not None and b.runner is not None:
            # a runner without merged_with (a stub) or of another family
            # registers a metrics-only soup; any other error propagates
            try:
                runner = a.runner.merged_with(b.runner, best_alpha)
            except (AttributeError, AssertionError):
                runner = None
        entry = ModelEntry(
            name=name,
            raw_metrics=merged_metrics([a, b], [best_alpha, 1 - best_alpha]),
            task_types=tuple(sorted(set(a.task_types) | set(b.task_types))),
            domains=tuple(sorted(set(a.domains) | set(b.domains))),
            family=a.family, n_params=a.n_params,
            generalist=a.generalist or b.generalist,
            runner=runner,
            meta={"soup_parents": (a.name, b.name), "alpha": best_alpha},
        )
        self.mres.register(entry)
        self.created.append(name)
        return entry
