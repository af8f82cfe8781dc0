"""Batch mode (sample-and-aggregate) in the port against the JAX
package, on the CPU: ``OptiRoute.route_batch`` draws the same sample,
gets the same signatures and aggregate and the same decision
(tie-aware), and ``ServingEngine.submit(mode="batch")`` gives the same
models, admissions, cache hits and telemetry (route events per model,
admission and cache funnels) over a sequence that first fills the
semantic cache in interactive mode.  The systems are those of
``tests/test_torch_serving.py``."""
import numpy as np
import pytest

from repro.core.telemetry import Telemetry as JTel
from repro.data.workload import make_workload, meta_of, quality_of
from repro.serving.engine import Request as JRequest
from repro_torch.core.telemetry import Telemetry as TTel
from repro_torch.serving.engine import Request as TRequest
from tests.test_torch_serving import PROFILES, _batches, _systems


def _tied_decision(d):
    c = d.candidates
    return len(c) > 1 and c[0][1] - c[1][1] <= 1e-5


@pytest.mark.parametrize("frac", [0.02, 0.3])
def test_route_batch_matches_reference(frac):
    (_, je), (_, te) = _systems(64, False)
    texts = [r.text for r in make_workload(40, seed=8)]
    for prefs in PROFILES:
        je.router.batch_sample_frac = te.router.batch_sample_frac = frac
        jd, js, jst = je.router.route_batch(texts, prefs, seed=3)
        td, ts, tst = te.router.route_batch(texts, prefs, seed=3)
        assert tst["sampled"] == jst["sampled"] == max(1, round(40 * frac))
        assert [(s.task_type, s.domain) for s in ts] == \
            [(s.task_type, s.domain) for s in js]
        np.testing.assert_allclose([s.complexity for s in ts],
                                   [s.complexity for s in js], atol=1e-5)
        ja, ta = jst["aggregate_sig"], tst["aggregate_sig"]
        assert (ta.task_type, ta.domain) == (ja.task_type, ja.domain)
        assert ta.complexity == pytest.approx(ja.complexity, abs=1e-5)
        assert td.model == jd.model or _tied_decision(jd)
        assert td.score == pytest.approx(jd.score, abs=1e-5)
        assert td.fallback_kind == jd.fallback_kind
    with pytest.raises(ValueError, match="at least one"):
        te.router.route_batch([], "balanced")


def test_submit_batch_matches_reference():
    (jm, je), (tm, te) = _systems(96, False)
    je.router.telemetry, te.router.telemetry = JTel(), TTel()
    batches = _batches(12)
    # interactive pass + observe: the cache learns batch 0's answers
    jres = je.submit([JRequest(text=r.text, prefs=p, id=i)
                      for i, r, p, _ in batches[0]])
    tres = te.submit([TRequest(text=r.text, prefs=p, id=i)
                      for i, r, p, _ in batches[0]])
    je.observe(jres, [quality_of(meta_of(jm.entry(x.model)), r.sig)
                      for x, (_, r, _, _) in zip(jres, batches[0])])
    te.observe(tres, [quality_of(meta_of(tm.entry(x.model)), r.sig)
                      for x, (_, r, _, _) in zip(tres, batches[0])])
    hits = 0
    for batch in batches[1:]:
        prefs = batch[0][2]         # one profile per batch-mode batch
        jres = je.submit([JRequest(text=r.text, prefs=prefs, id=i)
                          for i, r, _, _ in batch], mode="batch")
        tres = te.submit([TRequest(text=r.text, prefs=prefs, id=i)
                          for i, r, _, _ in batch], mode="batch")
        assert len({x.model for x in tres if not x.cache_hit}) <= 1
        for a, b in zip(jres, tres):
            assert (a.cache_hit, a.model, a.admission, a.fallback) == \
                (b.cache_hit, b.model, b.admission, b.fallback)
            assert b.rq is None
            hits += b.cache_hit
        assert te.observe(tres, [1.0] * len(tres)) is None
    assert hits > 0
    jt, tt = je.router.telemetry, te.router.telemetry
    assert tt.per_model().keys() == jt.per_model().keys()
    for m, agg in jt.per_model().items():
        assert tt.per_model()[m]["requests"] == agg["requests"]
    assert tt.admission_funnel() == jt.admission_funnel()
    assert tt.cache_funnel() == jt.cache_funnel()
    assert te.summary()["admissions"] == je.summary()["admissions"]
    for name in ("queue", "inflight"):
        np.testing.assert_array_equal(getattr(te.load, name), 0)
    with pytest.raises(ValueError, match="mode"):
        te.submit([TRequest(text="x", prefs="balanced")], mode="stream")
