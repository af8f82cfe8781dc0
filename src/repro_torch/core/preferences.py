"""User preferences (paper §3.1, Table 1).

Explicit preferences are 0-1 weights over functional metrics (accuracy,
latency, cost) and non-functional metrics (helpfulness, honesty,
harmlessness, steerability, creativity).  Implicit preferences
(task type, domain, complexity) are inferred by the Task Analyzer.

Profiles encapsulate weight presets for non-expert users
("cost-effective", "ethically-aligned", "latency-first", ...).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from types import MappingProxyType
from typing import Dict, Optional, Tuple

import numpy as np

# Order defines the metric axes of the routing space (MRES embeddings
# and task vectors share it).  All metrics are normalized so 1 = better
# (latency/cost are inverted into speed/cheapness at normalization).
METRICS: Tuple[str, ...] = (
    "accuracy", "speed", "cheapness",
    "helpfulness", "harmlessness", "honesty",
    "steerability", "creativity",
)
N_METRICS = len(METRICS)

TASK_TYPES: Tuple[str, ...] = (
    "chat", "code", "reasoning", "summarization", "classification",
    "translation", "transcription", "vqa", "captioning",
    "creative-writing", "long-context",
)
DOMAINS: Tuple[str, ...] = (
    "general", "software", "finance", "legal", "healthcare", "multilingual",
)


@dataclass(frozen=True)
class UserPreferences:
    """Explicit 0-1 weights per metric. Missing metrics default to 0.25.

    Immutable: ``weights`` is frozen into a read-only mapping at
    construction (use ``with_weight`` to derive variants), which makes
    the memoized ``vector()`` sound."""
    weights: Dict[str, float] = field(default_factory=dict)
    profile: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "weights",
                           MappingProxyType(dict(self.weights)))

    def vector(self) -> np.ndarray:
        """Weight vector over METRICS, memoized (the routing hot path
        re-reads it constantly).  Treat the returned array as frozen —
        copy before mutating."""
        v = self.__dict__.get("_vec")
        if v is None:
            w = np.array([float(self.weights.get(m, 0.25)) for m in METRICS],
                         dtype=np.float32)
            v = np.clip(w, 0.0, 1.0)
            object.__setattr__(self, "_vec", v)
        return v

    def with_weight(self, metric: str, value: float) -> "UserPreferences":
        assert metric in METRICS, metric
        w = dict(self.weights)
        w[metric] = float(value)
        return replace(self, weights=w)

    def validate(self) -> "UserPreferences":
        for k, v in self.weights.items():
            if k not in METRICS:
                raise ValueError(f"unknown metric {k!r}; known: {METRICS}")
            if not (0.0 <= float(v) <= 1.0):
                raise ValueError(f"weight {k}={v} outside [0, 1]")
        return self


PROFILES: Dict[str, UserPreferences] = {
    "cost-effective": UserPreferences(
        weights=dict(cheapness=1.0, speed=0.6, accuracy=0.4, helpfulness=0.3,
                     harmlessness=0.3, honesty=0.3, steerability=0.1,
                     creativity=0.1),
        profile="cost-effective"),
    "ethically-aligned": UserPreferences(
        weights=dict(harmlessness=1.0, honesty=1.0, helpfulness=0.9,
                     accuracy=0.6, cheapness=0.2, speed=0.2, steerability=0.4,
                     creativity=0.2),
        profile="ethically-aligned"),
    "latency-first": UserPreferences(
        weights=dict(speed=1.0, cheapness=0.5, accuracy=0.4, helpfulness=0.3,
                     harmlessness=0.3, honesty=0.3, steerability=0.1,
                     creativity=0.1),
        profile="latency-first"),
    "accuracy-first": UserPreferences(
        weights=dict(accuracy=1.0, helpfulness=0.7, honesty=0.6, speed=0.2,
                     cheapness=0.1, harmlessness=0.5, steerability=0.3,
                     creativity=0.3),
        profile="accuracy-first"),
    "balanced": UserPreferences(
        weights={m: 0.5 for m in METRICS}, profile="balanced"),
}


def resolve(prefs_or_profile) -> UserPreferences:
    """Accepts a UserPreferences, a profile name, or a weights dict."""
    if isinstance(prefs_or_profile, UserPreferences):
        return prefs_or_profile.validate()
    if isinstance(prefs_or_profile, str):
        if prefs_or_profile not in PROFILES:
            raise KeyError(f"unknown profile {prefs_or_profile!r}; "
                           f"known: {sorted(PROFILES)}")
        return PROFILES[prefs_or_profile]
    if isinstance(prefs_or_profile, dict):
        return UserPreferences(weights=prefs_or_profile).validate()
    raise TypeError(type(prefs_or_profile))


def resolve_batch(prefs_batch, batch_size: int) -> "list[UserPreferences]":
    """Resolve a batch of preferences for the array-first routing path.

    Accepts a single prefs/profile-name/weights-dict (broadcast to the
    whole batch) or a sequence with one element per query.
    """
    if isinstance(prefs_batch, (UserPreferences, str, dict)):
        return [resolve(prefs_batch)] * batch_size
    return [resolve(p) for p in prefs_batch]


@dataclass(frozen=True)
class TaskSignature:
    """Implicit preferences inferred by the Task Analyzer (paper Fig 2)."""
    task_type: str = "chat"
    domain: str = "general"
    complexity: float = 0.5          # 0 (trivial) .. 1 (hard)
    confidence: float = 1.0          # analyzer confidence for filtering

    def validate(self) -> "TaskSignature":
        assert self.task_type in TASK_TYPES, self.task_type
        assert self.domain in DOMAINS, self.domain
        assert 0.0 <= self.complexity <= 1.0
        return self
