"""Reward shaping for the adaptive routing loop.

The bandit should not maximize raw answer quality alone — the paper's
whole point is the performance/cost/ethics trade-off — so observed
quality is penalized by what serving the query actually cost:

  reward = quality
           - cost_weight    * normalized(cost of the serving model)
           - latency_weight * normalized(latency of the serving model)

Cost/latency default to the catalog's raw metrics (the same numbers
telemetry records as ``sim_cost`` per routed event), normalized min-max
across the catalog exactly like the MRES embeddings; callers with
realized telemetry (e.g. measured generate latency) can override
per-query.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass
class RewardConfig:
    cost_weight: float = 0.15
    latency_weight: float = 0.1
    clip: bool = True                 # clip shaped rewards into [-1, 1]


def _minmax(col: np.ndarray) -> np.ndarray:
    lo, hi = float(col.min()), float(col.max())
    if hi - lo < 1e-12:
        return np.zeros_like(col)
    return (col - lo) / (hi - lo)


class RewardShaper:
    """Per-model cost/latency penalties over an MRES catalog."""

    def __init__(self, mres, cfg: Optional[RewardConfig] = None):
        self.mres = mres
        self.cfg = cfg if cfg is not None else RewardConfig()
        self._n = -1
        self._penalty = np.zeros(0, np.float32)
        self.refresh()

    def refresh(self) -> None:
        """Rebuild the (N,) penalty vector from the catalog metrics."""
        entries = self.mres.entries
        if len(entries) == self._n:
            return
        cost = np.array([e.raw_metrics.get("cost_per_mtok", 0.0)
                         for e in entries], np.float64)
        lat = np.array([e.raw_metrics.get("latency_ms", 0.0)
                        for e in entries], np.float64)
        self._penalty = (self.cfg.cost_weight * _minmax(cost)
                         + self.cfg.latency_weight * _minmax(lat)
                         ).astype(np.float32)
        self._n = len(entries)

    def shape(self, qualities: Sequence[float], model_idx: np.ndarray,
              extra_penalty: Optional[np.ndarray] = None) -> np.ndarray:
        """(B,) shaped rewards for qualities observed on ``model_idx``.

        ``extra_penalty`` (B,) adds realized per-query penalties (e.g.
        normalized measured latency) on top of the catalog-derived ones.
        """
        self.refresh()
        r = (np.asarray(qualities, np.float32)
             - self._penalty[np.asarray(model_idx)])
        if extra_penalty is not None:
            r = r - np.asarray(extra_penalty, np.float32)
        return np.clip(r, -1.0, 1.0) if self.cfg.clip else r

    def penalty_row(self) -> np.ndarray:
        """(N,) catalog penalty vector (for oracle/regret accounting)."""
        self.refresh()
        return self._penalty.copy()
