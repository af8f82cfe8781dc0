"""The catalog: the ten configured architectures as MRES entries.

Port of the JAX package's ``serving/catalog.py``.  Quality and ethics
metrics come from each config module's synthetic ``EVAL`` record;
latency and cost are derived from the model's own roofline on one H100
(the larger of the compute and the weight-streaming term of a decode
step, with ``runner.PEAK_FLOPS``/``runner.HBM_BW``).  The reference
lets dry-run HLO terms of a TPU override that estimate; the port reads
no such file.

Runners: ``smoke_runners`` gives every entry a runner at its ``SMOKE``
config, ``full_runners`` at its published ``FULL`` config (seeded
random weights on ``device``, drawn straight into the compute dtype).
Every family has one, the frontend ones included (seamless-m4t-medium's
encoder-decoder, llava-next-mistral-7b's vision prefix; their runners
feed zero frontend embeddings, as the reference's do).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import ARCH_NAMES, get_config, get_eval, get_smoke
from repro_torch.core.mres import MRES, ModelEntry
from repro_torch.serving import runner as R
from repro_torch.serving.runner import ModelRunner

# A price assumption carried over from the JAX package (its on-demand
# ballpark for one accelerator chip), not a measurement of any card.
CHIP_DOLLARS_PER_HOUR = 1.2


def decode_latency_ms(name: str, batch: int = 128) -> float:
    """Per-token decode latency (ms) from the analytic bound on one
    H100: max(compute, weight streaming) at ``batch`` sequences."""
    n_act = get_config(name).n_active_params()
    flops = 2.0 * n_act * batch
    return max(flops / R.PEAK_FLOPS, 2.0 * n_act / R.HBM_BW) * 1e3


def cost_per_mtok(name: str) -> float:
    """Chip-seconds per token * 1e6 * $/chip-second."""
    lat_s = decode_latency_ms(name) / 1e3
    return lat_s * 1e6 * CHIP_DOLLARS_PER_HOUR / 3600.0


def build_entry(name: str, *, runner: Optional[ModelRunner] = None,
                smoke_runner: bool = False, full_runner: bool = False,
                seed: int = 0, device=None) -> ModelEntry:
    cfg = get_config(name)
    ev = get_eval(name)
    if runner is None and (smoke_runner or full_runner):
        runner = ModelRunner(cfg if full_runner else get_smoke(name),
                             seed=seed, device=device)
    raw = {
        "accuracy": float(ev["accuracy"]),
        "latency_ms": decode_latency_ms(name),
        "cost_per_mtok": cost_per_mtok(name),
        "helpfulness": float(ev["helpfulness"]),
        "harmlessness": float(ev["harmlessness"]),
        "honesty": float(ev["honesty"]),
        "steerability": float(ev["steerability"]),
        "creativity": float(ev["creativity"]),
    }
    return ModelEntry(
        name=name, raw_metrics=raw,
        task_types=tuple(ev["task_types"]),
        domains=tuple(ev["domains"]),
        family=cfg.arch_type, n_params=cfg.n_params(),
        generalist=bool(ev.get("generalist", cfg.arch_type == "dense")),
        runner=runner,
        meta={"config": cfg.name, "active_params": cfg.n_active_params()},
    )


def build_catalog(*, smoke_runners: bool = False, full_runners: bool = False,
                  seed: int = 0, archs=None, device=None) -> MRES:
    mres = MRES()
    for i, name in enumerate(archs or ARCH_NAMES):
        mres.register(build_entry(name, smoke_runner=smoke_runners,
                                  full_runner=full_runners, seed=seed + i,
                                  device=device))
    return mres
