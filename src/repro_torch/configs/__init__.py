"""Config registry: one module per assigned architecture.

``get_config(name)`` -> full published config;
``get_smoke(name)``  -> reduced same-family variant;
``get_eval(name)``   -> synthetic MRES evaluation record.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, smoke_variant, pad_vocab  # noqa: F401

_MODULES: Dict[str, str] = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-1.3b": "mamba2_1_3b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma2-2b": "gemma2_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama3.2-1b": "llama3_2_1b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def get_eval(name: str) -> dict:
    return dict(_module(name).EVAL)


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
