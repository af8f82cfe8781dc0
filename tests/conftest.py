import os

# Multi-device host platform BEFORE anything imports jax (pattern from
# launch/dryrun.py): the sharded mega-catalog route-step tests need
# >= 4 CPU devices.  Respect an explicit caller override.
if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4").strip()

import numpy as np
import pytest

from repro.analysis import sanitize
from repro.core.mres import MRES, ModelEntry

# ---------------------------------------------------------------------
# opt-in runtime sanitizers (REPRO_SANITIZE=1) — see repro.analysis
# ---------------------------------------------------------------------
_SANITIZE = sanitize.enabled()

if _SANITIZE:
    import jax

    # transfer_guard: default "allow" — the CPU/interpreter fallback
    # paths legitimately shuttle host<->device; tighten per-run with
    # REPRO_TRANSFER_GUARD=disallow/log to hunt stray transfers.
    jax.config.update("jax_transfer_guard",
                      os.environ.get("REPRO_TRANSFER_GUARD", "allow"))

    _SENTINEL = sanitize.RecompileSentinel().install()

    @pytest.fixture(autouse=True)
    def _sanitizers(request):
        """Per-test: fail on tracer leaks, steady-state route-step
        recompiles, and lock-order inversions observed during the test."""
        # per-test warmup window: tests may legitimately clear jit
        # caches (perf/compile-count tests), so cross-test recompiles
        # are not violations — re-compiling a bucket the SAME test
        # already dispatched is
        _SENTINEL.forget()
        n_lock_viol = len(sanitize.lock_order_violations())
        with jax.checking_leaks():
            yield
        recompiles = _SENTINEL.drain()
        if recompiles:
            pytest.fail("recompile sentinel tripped:\n  "
                        + "\n  ".join(recompiles), pytrace=False)
        lock_viol = sanitize.lock_order_violations()[n_lock_viol:]
        if lock_viol:
            msgs = [f"{a} -> {b} closes cycle {' -> '.join(cyc)}"
                    for a, b, cyc in lock_viol]
            pytest.fail("lock-order inversion(s) detected:\n  "
                        + "\n  ".join(msgs), pytrace=False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_entry(name, *, accuracy=0.5, latency_ms=100.0, cost=1.0,
               task_types=("chat",), domains=("general",),
               generalist=False, family="dense", n_params=0, **ethics):
    raw = {
        "accuracy": accuracy, "latency_ms": latency_ms,
        "cost_per_mtok": cost,
        "helpfulness": ethics.get("helpfulness", 0.5),
        "harmlessness": ethics.get("harmlessness", 0.5),
        "honesty": ethics.get("honesty", 0.5),
        "steerability": ethics.get("steerability", 0.5),
        "creativity": ethics.get("creativity", 0.5),
    }
    return ModelEntry(name=name, raw_metrics=raw, task_types=task_types,
                      domains=domains, generalist=generalist,
                      family=family, n_params=n_params)


@pytest.fixture
def small_mres():
    """4-model catalog spanning the cost/accuracy trade-off."""
    m = MRES()
    m.register(make_entry("tiny-fast", accuracy=0.4, latency_ms=5, cost=0.1,
                          task_types=("chat", "classification"),
                          domains=("general",), generalist=True))
    m.register(make_entry("mid", accuracy=0.7, latency_ms=40, cost=1.0,
                          task_types=("chat", "code", "summarization"),
                          domains=("general", "software")))
    m.register(make_entry("big-accurate", accuracy=0.95, latency_ms=400,
                          cost=10.0, helpfulness=0.9, honesty=0.9,
                          task_types=("chat", "code", "reasoning",
                                      "summarization"),
                          domains=("general", "software", "finance",
                                   "legal"), generalist=True))
    m.register(make_entry("legal-specialist", accuracy=0.85, latency_ms=120,
                          cost=3.0, harmlessness=0.95,
                          task_types=("summarization", "classification"),
                          domains=("legal",)))
    return m
