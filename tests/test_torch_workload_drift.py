"""The port's non-stationary, Zipf-replay and serving-simulator workloads
(``repro_torch.data.workload``) against the JAX package's, on the same
seeds.  All of it is numpy, so every comparison is exact: the same
batches (text, signature, id), quality tables, degraded model, replay
orders and simulator arrays, bit for bit.  The reference's own
assertions on these classes (``tests/test_adaptive.py``,
``tests/test_cache.py``, ``tests/test_load_aware.py``) are run again
against the port's classes.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.preferences import DOMAINS
from repro.data import workload as JW
from repro.serving.load import LoadTracker as JLoad
from repro_torch.data import workload as TW
from repro_torch.serving.load import ADMISSION_KINDS
from repro_torch.serving.load import LoadTracker as TLoad

SCENARIO_FIELDS = [f.name for f in dataclasses.fields(JW.DriftScenario)]


def _meta(n=7, seed=0):
    """Catalog metas in the shape ``meta_of`` gives, from a seed."""
    rng = np.random.default_rng(seed)
    tts = ["chat", "code", "reasoning", "summarization", "translation"]
    return [{"name": f"m{i}", "accuracy": float(rng.uniform(0.3, 0.95)),
             "task_types": tuple(rng.choice(tts, size=2, replace=False)),
             "domains": tuple(rng.choice(DOMAINS, size=3, replace=False))}
            for i in range(n)]


def _records(qs):
    return [(q.text, q.id, dataclasses.astuple(q.sig)) for q in qs]


def test_drift_kinds_and_scenario_fields_match_reference():
    assert TW.DRIFT_KINDS == JW.DRIFT_KINDS
    assert [f.name for f in dataclasses.fields(TW.DriftScenario)] == \
        SCENARIO_FIELDS
    assert dataclasses.asdict(TW.DriftScenario()) == \
        dataclasses.asdict(JW.DriftScenario())
    assert dataclasses.asdict(TW.ZipfReplayScenario()) == \
        dataclasses.asdict(JW.ZipfReplayScenario())


@pytest.mark.parametrize("kind", JW.DRIFT_KINDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_nonstationary_workload_matches_reference_bit_for_bit(kind, seed):
    meta = _meta(seed=seed)
    kw = dict(kind=kind, n_steps=20, batch=6, seed=seed, drift_period=9.0)
    jw = JW.NonStationaryWorkload(meta, JW.DriftScenario(**kw))
    tw = TW.NonStationaryWorkload(meta, TW.DriftScenario(**kw))
    assert tw.degraded_model == jw.degraded_model
    assert tw.shift_step == jw.shift_step
    for t in range(20):
        jb, tb = jw.batch(t), tw.batch(t)
        assert _records(tb) == _records(jb), t
        sigs = [q.sig for q in jb]
        qm_t = tw.quality_matrix(t, [q.sig for q in tb])
        qm_j = jw.quality_matrix(t, sigs)
        assert qm_t.dtype == qm_j.dtype
        np.testing.assert_array_equal(qm_t, qm_j)
        for name in (meta[0]["name"], meta[-1]["name"]):
            assert tw.quality(t, name, tb[0].sig) == \
                jw.quality(t, name, sigs[0])


def test_degrade_default_and_named_model_match_reference():
    meta = _meta(5, seed=3)
    for model in (None, "m2"):
        sc = dict(kind="model-degrade", n_steps=10, batch=3,
                  degrade_model=model, degrade_delta=0.4, shift_frac=0.3)
        jw = JW.NonStationaryWorkload(meta, JW.DriftScenario(**sc))
        tw = TW.NonStationaryWorkload(meta, TW.DriftScenario(**sc))
        assert tw.degraded_model == jw.degraded_model
        sig = tw.batch(0)[0].sig
        np.testing.assert_array_equal(tw.quality_matrix(9, [sig]),
                                      jw.quality_matrix(9, [sig]))


@pytest.mark.parametrize("kw", [
    dict(n_unique=32, n_requests=256, zipf_a=1.1, seed=3),
    dict(n_unique=64, n_requests=512, zipf_a=0.8, seed=0,
         task_type="code", domain="finance", complexity=0.4)])
def test_zipf_replay_matches_reference_bit_for_bit(kw):
    jp, jo = JW.zipf_replay(JW.ZipfReplayScenario(**kw))
    tp, to = TW.zipf_replay(TW.ZipfReplayScenario(**kw))
    assert _records(tp) == _records(jp)
    assert to.dtype == jo.dtype == np.int64
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(TW.ZipfReplayScenario(**kw).rank_probs,
                                  JW.ZipfReplayScenario(**kw).rank_probs)


def _sim_arrays(mod, load_cls, route_factory, arrivals, deadline):
    lt = load_cls(4, capacity=1.0, default_service_s=0.2)
    sim = mod.ServingSimulator([0.05, 0.08, 0.2, 0.12], [2, 1, 3, 1],
                               tracker=lt)
    res = sim.run(arrivals, route_factory(lt), deadline_ms=deadline)
    return res, lt


def _fixed_route(lt):
    kinds = ("admitted", "rerouted", "admitted", "shed")
    return lambda i, t: (i % 4, kinds[i % 7 % 4])


def _load_route(lt):
    """A load-aware policy: the arm with the least estimated wait, shed
    when even that exceeds 0.3 s."""
    def route(i, t):
        w = lt.estimated_wait_s()
        m = int(np.argmin(w))
        if w[m] > 0.3:
            return m, "shed"
        return m, "admitted" if m == i % 4 else "rerouted"
    return route


@pytest.mark.parametrize("route_factory", [_fixed_route, _load_route])
def test_serving_simulator_matches_reference_bit_for_bit(route_factory):
    arrivals = TW.poisson_arrivals(TW.TrafficScenario(
        duration_s=4.0, base_rate=20.0, burst_rate=90.0, seed=5))
    np.testing.assert_array_equal(arrivals, JW.poisson_arrivals(
        JW.TrafficScenario(duration_s=4.0, base_rate=20.0, burst_rate=90.0,
                           seed=5)))
    got, tl = _sim_arrays(TW, TLoad, route_factory, arrivals, 250.0)
    want, jl = _sim_arrays(JW, JLoad, route_factory, arrivals, 250.0)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key
    assert got["shed"].any() and not got["shed"].all()
    for a, b in zip(tl.snapshot(), jl.snapshot()):
        np.testing.assert_array_equal(a, b)
    assert {"admitted", "rerouted", "shed"} <= set(ADMISSION_KINDS)


# ----------------------------------------------------------------------
# the reference's own assertions, against the port's classes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", TW.DRIFT_KINDS)
def test_drift_workload_deterministic_and_consistent(kind):
    meta = [{"name": f"m{i}", "accuracy": 0.3 + 0.1 * i,
             "task_types": ("chat",), "domains": tuple(DOMAINS)}
            for i in range(5)]
    wl = TW.NonStationaryWorkload(
        meta, TW.DriftScenario(kind=kind, n_steps=12, batch=4, seed=5))
    assert [q.text for q in wl.batch(3)] == [q.text for q in wl.batch(3)]
    sigs = [q.sig for q in wl.batch(3)]
    Q = wl.quality_matrix(3, sigs)
    assert Q.shape == (4, 5)
    for bi, s in enumerate(sigs):
        for j in range(5):
            assert Q[bi, j] == pytest.approx(wl.quality(3, f"m{j}", s))


def test_model_degrade_flips_best_model():
    meta = [{"name": f"m{i}", "accuracy": 0.3 + 0.15 * i,
             "task_types": ("chat",), "domains": tuple(DOMAINS)}
            for i in range(4)]
    wl = TW.NonStationaryWorkload(meta, TW.DriftScenario(
        kind="model-degrade", n_steps=10, batch=2, shift_frac=0.5,
        degrade_delta=0.6, task_type="chat"))
    assert wl.degraded_model == "m3"
    sig = wl.batch(0)[0].sig
    assert wl.quality(9, "m3", sig) < wl.quality(0, "m3", sig)
    assert wl.quality(9, "m1", sig) == pytest.approx(
        wl.quality(0, "m1", sig))


def test_domain_shift_changes_mix():
    meta = [{"name": "m0", "accuracy": 0.5, "task_types": ("chat",),
             "domains": ("general",)}]
    wl = TW.NonStationaryWorkload(meta, TW.DriftScenario(
        kind="domain-shift", n_steps=10, batch=6, shift_frac=0.5,
        domain_a="general", domain_b="legal", task_type="chat"))
    assert {q.sig.domain for q in wl.batch(1)} == {"general"}
    assert {q.sig.domain for q in wl.batch(8)} == {"legal"}


def test_zipf_replay_deterministic_and_repeat_heavy():
    sc = TW.ZipfReplayScenario(n_unique=32, n_requests=256, zipf_a=1.1,
                               seed=3)
    pool1, order1 = TW.zipf_replay(sc)
    pool2, order2 = TW.zipf_replay(sc)
    assert [q.text for q in pool1] == [q.text for q in pool2]
    np.testing.assert_array_equal(order1, order2)
    assert len(pool1) == 32 and order1.shape == (256,)
    assert order1.min() >= 0 and order1.max() < 32
    assert (256 - len(np.unique(order1))) / 256 >= 0.5
    assert (order1 == order1[np.argmax(np.bincount(order1))]).mean() \
        > 3.0 / 32
    np.testing.assert_allclose(sc.rank_probs.sum(), 1.0)
    with pytest.raises(AssertionError):
        TW.ZipfReplayScenario(n_unique=0).validate()


def test_simulator_single_server_math():
    """3 back-to-back arrivals on one 1s server: waits 0/1/2 s."""
    sim = TW.ServingSimulator([1.0], [1], tracker=TLoad(1))
    res = sim.run(np.array([0.0, 0.0, 0.0]),
                  lambda i, t: (0, "admitted"), deadline_ms=1500.0)
    np.testing.assert_allclose(res["wait_s"], [0.0, 1.0, 2.0])
    np.testing.assert_allclose(res["latency_s"], [1.0, 2.0, 3.0])
    assert res["slo_miss"].tolist() == [False, True, True]
    assert res["slo_miss_rate"] == pytest.approx(2 / 3)


def test_simulator_parallel_servers_and_shed():
    sim = TW.ServingSimulator([1.0, 1.0], [2, 1])
    kinds = ["admitted", "admitted", "rerouted", "shed"]
    models = [0, 0, 1, 0]
    res = sim.run(np.zeros(4),
                  lambda i, t: (models[i], kinds[i]), deadline_ms=1100.0)
    np.testing.assert_allclose(res["latency_s"][:3], [1.0, 1.0, 1.0])
    assert res["shed"].tolist() == [False, False, False, True]
    assert res["rerouted"].tolist() == [False, False, True, False]
    assert np.isnan(res["latency_s"][3])
    assert res["slo_miss"].tolist() == [False, False, False, True]


def test_simulator_mirrors_tracker_state():
    lt = TLoad(1, capacity=1.0, default_service_s=9.9)
    sim = TW.ServingSimulator([0.5], [1], tracker=lt)
    seen = []

    def route(i, t):
        seen.append(lt.estimated_wait_s()[0])
        return 0, "admitted"

    sim.run(np.array([0.0, 0.1, 5.0]), route)
    assert seen[0] == 0.0 and seen[1] > 0.0 and seen[2] == 0.0
    q, f, _, _ = lt.snapshot()
    assert (q == 0).all() and (f == 0).all()
    assert lt.snapshot()[3][0] < 9.9
