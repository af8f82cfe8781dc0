"""The port's asyncio front end and traffic scenarios against the JAX
package, on the CPU.

  * ``TrafficScenario``/``poisson_arrivals`` and ``MultiTenantScenario``/
    ``multi_tenant_arrivals``: arrival times and tenant indices
    bit-equal; ``jain_fairness`` equal;
  * ``TokenBucket``, ``TenantPolicy`` and ``MicroBatcher``: one seeded
    virtual-time script of offers, deadline checks and takes over three
    tenants (weights, a rate limit, a backlog cap) gives the same
    verdicts, windows, DRR order, deadlines and intake stats in both;
  * ``AsyncServingEngine``: the cases of ``tests/test_async_engine.py``
    on the port (windows bounded by ``max_batch``, a flooding tenant
    rate-limited, the tracker netting to zero, ``stop`` draining, a
    submit before ``start`` raising, a thread hammer on
    ``ServingEngine.submit``), and ``stream`` yielding the tokens the
    continuous batcher gives the same prompt.
"""
import asyncio
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.data import workload as JW
from repro.serving import async_engine as JAE
from repro_torch.configs import get_smoke
from repro_torch.core.mres import MRES
from repro_torch.core.orchestrator import OptiRoute
from repro_torch.core.preferences import TaskSignature
from repro_torch.core.telemetry import Telemetry
from repro_torch.data import workload as TW
from repro_torch.models import model as TM
from repro_torch.serving import async_engine as TAE
from repro_torch.serving.async_engine import (REJECT_BACKLOG, REJECT_RATE,
                                              AsyncServingEngine,
                                              TenantPolicy, TokenBucket)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.load import LoadTracker
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.scheduler import ContinuousBatcher, SlotRequest
from tests.test_torch_merging import _twin
from tests.conftest import make_entry


# ----------------------------------------------------------------------
# traffic scenarios
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_arrivals_bit_equal_reference(seed):
    kw = dict(duration_s=12.0, base_rate=4.0, burst_rate=16.0,
              burst_start=0.3, burst_len=0.3, deadline_ms=800.0, seed=seed)
    np.testing.assert_array_equal(
        TW.poisson_arrivals(TW.TrafficScenario(**kw)),
        JW.poisson_arrivals(JW.TrafficScenario(**kw)))
    tenants = [dict(name="acme", weight=2.0), dict(name="globex"),
               dict(name="flood", rate_scale=3.0, rate_limit=6.0,
                    deadline_ms=400.0)]
    tsc = TW.MultiTenantScenario(TW.TrafficScenario(**kw),
                                 tuple(TW.TenantSpec(**t) for t in tenants))
    jsc = JW.MultiTenantScenario(JW.TrafficScenario(**kw),
                                 tuple(JW.TenantSpec(**t) for t in tenants))
    for a, b in zip(TW.multi_tenant_arrivals(tsc),
                    JW.multi_tenant_arrivals(jsc)):
        np.testing.assert_array_equal(a, b)
    assert [tsc.deadline_ms_of(i) for i in range(3)] == \
        [jsc.deadline_ms_of(i) for i in range(3)]
    assert tsc.base.burst_window_s == jsc.base.burst_window_s
    for x in ([1, 1, 1], [3.0, 1.0], [], [0, 0]):
        assert TW.jain_fairness(x) == JW.jain_fairness(x)


# ----------------------------------------------------------------------
# intake: one virtual-time script through both packages
# ----------------------------------------------------------------------

def _script(mod, seed):
    rng = np.random.default_rng(seed)
    mb = mod.MicroBatcher(max_batch=5, max_wait_s=0.02, policies={
        "acme": mod.TenantPolicy(weight=2.0),
        "flood": mod.TenantPolicy(rate=8.0, burst=3.0),
        "tiny": mod.TenantPolicy(weight=0.5, max_backlog=3)})
    log, now = [], 0.0
    for k in range(300):
        now += float(rng.exponential(0.004))
        t = ("acme", "flood", "tiny", "other")[int(rng.integers(0, 4))]
        log.append(("offer", mb.offer(t, (t, k), now)))
        dl = mb.next_deadline(now)
        log.append(("due", mb.due(now), dl))
        if dl is not None and dl <= now:
            log.append(("take", mb.take(now)))
    while mb.pending():
        log.append(("drain", mb.take(now, limit=3)))
    bucket = mod.TokenBucket(rate=2.0, burst=2.0)
    log.append(("bucket", [bucket.try_take(t) for t in
                           (0.0, 0.0, 0.0, 0.5, 0.5, 100.0, 100.0, 100.0)]))
    return log, mb.stats, mb.backlog()


@pytest.mark.parametrize("seed", [1, 2])
def test_microbatcher_script_matches_reference(seed):
    assert _script(TAE, seed) == _script(JAE, seed)


def test_tenant_policy_defaults_and_validation():
    assert TenantPolicy().make_bucket() is None
    b = TenantPolicy(rate=3.0).make_bucket()
    assert (b.rate, b.burst) == (3.0, 6.0)
    assert TenantPolicy(rate=0.2).make_bucket().burst == 1.0
    with pytest.raises(AssertionError):
        TenantPolicy(weight=0.0).validate()
    tb = TokenBucket(rate=2.0, burst=2.0)
    assert tb.try_take(0.0) and tb.try_take(0.0) and not tb.try_take(0.0)


# ----------------------------------------------------------------------
# the async engine (asyncio.run; no pytest-asyncio dependency)
# ----------------------------------------------------------------------

class StubAnalyzer:
    def analyze_batch(self, texts):
        return [TaskSignature(task_type="chat", domain="general",
                              complexity=0.4) for _ in texts]


class FakeRunner:
    """(B, max_new) zero tokens, B * service_s simulated latency."""
    cfg = SimpleNamespace(vocab_size=256)

    def __init__(self, service_s=0.001):
        self.service_s = float(service_s)

    def generate(self, toks, max_new=8):
        B = int(np.asarray(toks).shape[0])
        return SimpleNamespace(tokens=np.zeros((B, max_new), np.int32),
                               sim_latency_s=self.service_s * B)


def _engine(tel=None, n=3):
    m = MRES()
    for i in range(n):
        m.register(_twin(make_entry(f"m{i}", accuracy=0.9 - 0.05 * i,
                                    latency_ms=50.0 + 10 * i, cost=1.0 + i,
                                    generalist=True), FakeRunner()))
    tracker = LoadTracker(n, default_service_s=0.01)
    router = OptiRoute(m, StubAnalyzer(), knn_k=n, telemetry=tel,
                       load=tracker, load_weight=1.0, device="cpu")
    return ServingEngine(router), tracker


def _req(i, tenant="acme", **kw):
    return Request(text=f"request {i}", prefs="balanced", id=i, max_new=2,
                   tenant=tenant, **kw)


def test_async_engine_serves_windows_and_sheds_flood():
    tel = Telemetry()
    eng, tracker = _engine(tel=tel)
    aeng = AsyncServingEngine(eng, max_batch=4, max_wait_ms=5, policies={
        "flood": TenantPolicy(rate=1.0, burst=1.0)})

    async def drive():
        async with aeng:
            good = [aeng.submit(_req(i, deadline_ms=10_000.0))
                    for i in range(10)]
            bad = [aeng.submit(_req(100 + i, tenant="flood"))
                   for i in range(5)]
            return await asyncio.gather(*good, *bad)

    resps = asyncio.run(drive())
    good, bad = resps[:10], resps[10:]
    assert all(r.admission == "admitted" and not r.error for r in good)
    assert [r.request.id for r in good] == list(range(10))
    sheds = [r for r in bad if r.admission == "shed"]
    assert len(sheds) == 4 and all(r.error == REJECT_RATE for r in sheds)
    assert sum(aeng.windows) == 11
    assert all(1 <= w <= 4 for w in aeng.windows)
    assert len(eng.log) == 15
    q, f, _, _ = tracker.snapshot()
    assert (q == 0).all() and (f == 0).all()
    by = tel.admission_by_tenant()
    assert by["acme"]["admitted"] == 10 and by["flood"]["shed"] == 4
    assert tel.summary()["counters"]["intake_rate_limited"] == 4
    assert REJECT_BACKLOG == "backlog-full"


def test_async_engine_stop_drains_backlog_and_requires_start():
    eng, _ = _engine()
    aeng = AsyncServingEngine(eng, max_batch=32, max_wait_ms=10_000)

    async def drive():
        async with aeng:
            tasks = [asyncio.ensure_future(aeng.submit(_req(i)))
                     for i in range(3)]
            await asyncio.sleep(0)
        return await asyncio.gather(*tasks)

    resps = asyncio.run(drive())
    assert [r.request.id for r in resps] == [0, 1, 2]
    assert all(r.served for r in resps)

    async def unstarted():
        with pytest.raises(RuntimeError, match="not started"):
            await AsyncServingEngine(eng).submit(_req(0))

    asyncio.run(unstarted())


def test_submit_concurrent_thread_hammer():
    tel = Telemetry()
    eng, tracker = _engine(tel=tel)
    errs = []

    def work(tid):
        try:
            for k in range(5):
                resps = eng.submit([_req(tid * 100 + k * 10 + j,
                                         tenant=f"t{tid}",
                                         deadline_ms=10_000.0)
                                    for j in range(3)])
                assert len(resps) == 3 and all(r.served for r in resps)
        except Exception as e:                     # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs, errs
    q, f, _, _ = tracker.snapshot()
    assert (q == 0).all() and (f == 0).all()
    assert eng.summary()["requests"] == 60
    funnel = tel.admission_funnel()
    assert sum(funnel.values()) == 60 and not funnel.get("failed", 0)
    assert {t: sum(k.values()) for t, k in tel.admission_by_tenant()
            .items()} == {f"t{i}": 15 for i in range(4)}


def test_stream_yields_the_batchers_tokens():
    cfg = get_smoke("llama3.2-1b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    m = MRES()
    m.register(_twin(make_entry("llama", generalist=True),
                     ModelRunner(cfg, params=params, device="cpu")))
    eng = ServingEngine(OptiRoute(m, StubAnalyzer(), knn_k=1,
                                  device="cpu"))
    aeng = AsyncServingEngine(eng, stream_slots=2, stream_ctx_len=64)
    reqs = [Request(text=f"stream me {i} " * (i + 1), prefs="balanced",
                    id=i, max_new=3 + i) for i in range(3)]

    async def drive():
        async def one(r):
            return [t async for t in aeng.stream(r)]
        async with aeng:
            return await asyncio.gather(*(one(r) for r in reqs))

    got = asyncio.run(drive())
    cb = ContinuousBatcher(cfg, params, slots=2, ctx_len=64, device="cpu")
    for r in reqs:
        cb.submit(SlotRequest(id=r.id, tokens=eng._tokens(
            [r.text], cfg.vocab_size)[0], max_new=r.max_new), truncate=True)
    want = {s.id: s.out for s in cb.run_until_drained()}
    assert got == [want[r.id] for r in reqs]
    assert [len(g) for g in got] == [3, 4, 5]
