"""Online adaptive routing: contextual bandits that learn per-model
quality from live traffic and blend into the static MRES scores."""
from repro_torch.adaptive.bandit import POLICIES, LinearBandit
from repro_torch.adaptive.rewards import RewardConfig, RewardShaper

__all__ = ["LinearBandit", "POLICIES", "RewardConfig", "RewardShaper"]
