"""Serving substrate: runners, the catalog builder, the batched engine,
live per-model load tracking, the continuous batcher, and the asyncio
multi-tenant front end (micro-batch windows, token-bucket rate limits,
weighted-fair dequeue, streaming)."""
from repro_torch.serving.load import (ADMISSION_KINDS, LoadTracker,
                                      plan_admission)

__all__ = ["ADMISSION_KINDS", "LoadTracker", "plan_admission",
           "TokenBucket", "TenantPolicy", "MicroBatcher",
           "AsyncServingEngine"]


def __getattr__(name):
    # the async front end imports the engine stack; load it lazily so
    # ``from repro_torch.serving import LoadTracker`` stays cheap
    if name in ("TokenBucket", "TenantPolicy", "MicroBatcher",
                "AsyncServingEngine"):
        from repro_torch.serving import async_engine
        return getattr(async_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
