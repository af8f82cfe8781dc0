"""Routed generation through the port's ``ModelRunner`` against the JAX
package, on the CPU at the ``SMOKE`` configs of llama3.2-1b,
mamba2-1.3b, qwen3-moe-30b-a3b and llama4-maverick-400b-a17b (weights
from the reference's ``init_params`` through ``params_from_jax``):

  * ``ModelRunner.generate``: greedy tokens agree, tie-aware -- a token
    may differ only where the reference's top-2 logit gap at that step
    is below ``TIE`` (then that row is compared no further);
  * ``ServingEngine.submit`` with runners: the same catalog, analyzer
    and requests through both engines give the same routed model,
    admission outcome and tokens per request, for a catalog of the
    dense and SSM models and one of the two MoE models.  The port's roofline
    constants are the H100's; for this test they are set to the
    reference's, so the catalogs' latency/cost metrics (and the load
    tracker's service times) are equal;
  * failure isolation: a runner that raises fails its own group only;
  * a runner that draws its own weights holds exactly the values of
    ``init_params`` followed by ``cast_params``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import analyzer as JA
from repro.core.mres import MRES as JMRES
from repro.core.orchestrator import OptiRoute as JOptiRoute
from repro.data.workload import make_workload
from repro.models import model as JM
from repro.serving import catalog as JCAT
from repro.serving import runner as JRUN
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.load import LoadTracker as JLoad
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import analyzer as TA
from repro_torch.core.mres import MRES as TMRES
from repro_torch.core.orchestrator import OptiRoute as TOptiRoute
from repro_torch.models import model as TM
from repro_torch.serving import catalog as TCAT
from repro_torch.serving import runner as TRUN
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TServingEngine
from repro_torch.serving.load import LoadTracker as TLoad
from repro_torch.training import steps as TS

SERVED = ["llama3.2-1b", "mamba2-1.3b", "qwen3-moe-30b-a3b",
          "llama4-maverick-400b-a17b"]
DENSE_SSM, MOE = SERVED[:2], SERVED[2:]
TIE = 1e-4
PROFILES = ["balanced", "cost-effective", "accuracy-first", "latency-first"]


def jax_greedy(jp, cfg, toks, max_new):
    """The reference's greedy loop with its logits at every step."""
    last, cache, pos = JM.prefill(jp, cfg, {"tokens": jnp.asarray(toks)},
                                  max_len=toks.shape[1] + max_new + 8)
    logits, out = [np.asarray(last)], [np.argmax(np.asarray(last), -1)]
    for _ in range(max_new - 1):
        tok = jnp.asarray(out[-1][:, None].astype(np.int32))
        lg, cache = JM.decode_step(jp, cfg, cache, {"token": tok, "pos": pos})
        pos = pos + 1
        logits.append(np.asarray(lg))
        out.append(np.argmax(logits[-1], -1))
    return np.stack(out, 1), np.stack(logits, 1)


def assert_greedy_agrees(got, want, logits, tie=TIE):
    """got / want (B, T) tokens; logits (B, T, V) of the reference."""
    for b in range(want.shape[0]):
        for s in range(want.shape[1]):
            top2 = np.sort(logits[b, s])[-2:]
            if top2[1] - top2[0] < tie:
                break                      # a near-tie: stop this row
            assert got[b, s] == want[b, s], (b, s)


def _runners(name, seed):
    jr = JRUN.ModelRunner(jget_smoke(name), seed=seed)
    tr = TRUN.ModelRunner(get_smoke(name), device="cpu",
                          params=TM.params_from_jax(
                              jax.tree_util.tree_map(np.asarray, jr.params)))
    return jr, tr


@pytest.mark.parametrize("name", SERVED)
def test_generate_tokens_match_reference(name):
    jr, tr = _runners(name, seed=4)
    toks = np.random.default_rng(1).integers(
        0, jr.cfg.vocab_size, (3, 19)).astype(np.int32)
    got = tr.generate(toks, max_new=6, keep_logits=True)
    want = jr.generate(toks, max_new=6)
    ref_toks, ref_logits = jax_greedy(jr.params, jr.cfg, toks, 6)
    np.testing.assert_array_equal(want.tokens, ref_toks)
    assert got.tokens.shape == (3, 6) and got.tokens.dtype == np.int32
    assert_greedy_agrees(got.tokens, ref_toks, ref_logits)
    np.testing.assert_allclose(got.logits_last, np.asarray(want.logits_last),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.step_logits, ref_logits, rtol=1e-4,
                               atol=1e-4)
    assert (got.prefill_tokens, got.decode_steps) == (57, 6)
    assert got.prefill_s > 0 and got.decode_s > 0
    assert tr.stats["calls"] == 1 and tr.stats["decode_steps"] == 6


def test_sim_latency_uses_h100_constants(monkeypatch):
    cfg = get_config("llama3.2-1b")
    n = cfg.n_active_params()
    assert (TRUN.PEAK_FLOPS, TRUN.HBM_BW) == (989e12, 3.35e12)
    want = max(2.0 * n * 128 / 989e12, 2.0 * n / 3.35e12) * 1e3
    assert TCAT.decode_latency_ms("llama3.2-1b") == pytest.approx(want)
    monkeypatch.setattr(TRUN, "PEAK_FLOPS", JRUN.PEAK_FLOPS)
    monkeypatch.setattr(TRUN, "HBM_BW", JRUN.HBM_BW)
    for name in ("llama3.2-1b", "mamba2-1.3b", "gemma2-2b"):
        assert TCAT.decode_latency_ms(name) == pytest.approx(
            JCAT.decode_latency_ms(name), rel=1e-12)
        assert TCAT.cost_per_mtok(name) == pytest.approx(
            JCAT.cost_per_mtok(name), rel=1e-12)


def test_catalog_of_all_ten_matches_reference(monkeypatch):
    monkeypatch.setattr(TRUN, "PEAK_FLOPS", JRUN.PEAK_FLOPS)
    monkeypatch.setattr(TRUN, "HBM_BW", JRUN.HBM_BW)
    jm, tm = JCAT.build_catalog(), TCAT.build_catalog()
    assert len(tm) == len(jm) == 10
    for name in jm.snapshot()[1]:
        a, b = jm.entry(name), tm.entry(name)
        assert b.runner is None
        assert (a.task_types, a.domains, a.family, a.n_params, a.generalist,
                a.meta) == (b.task_types, b.domains, b.family, b.n_params,
                            b.generalist, b.meta)
        for k, v in a.raw_metrics.items():
            assert b.raw_metrics[k] == pytest.approx(v, rel=1e-12), (name, k)


def test_runner_parts_outside_the_slice_raise():
    tr = TRUN.ModelRunner(get_smoke("llama3.2-1b"), device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md"):
        TS.make_train_step(tr.cfg)
    with pytest.raises(NotImplementedError, match="seamless-m4t-medium"):
        TRUN.ModelRunner(get_smoke("seamless-m4t-medium"), device="cpu")


def test_seeded_runner_is_reproducible():
    cfg = get_smoke("mamba2-1.3b")
    toks = np.arange(2 * 9, dtype=np.int32).reshape(2, 9) % cfg.vocab_size
    a = TRUN.ModelRunner(cfg, seed=5, device="cpu").generate(toks, 4)
    b = TRUN.ModelRunner(cfg, seed=5, device="cpu").generate(toks, 4)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.logits_last, b.logits_last)
    assert np.isfinite(a.logits_last).all()


@pytest.mark.parametrize("name", DENSE_SSM)
def test_runner_weights_equal_init_then_cast(name):
    """The runner draws each tensor and casts it at once; the values are
    bit-equal to drawing the whole model in ``param_dtype`` and casting
    it afterwards (here to bf16, so the cast is not a no-op)."""
    cfg = dataclasses.replace(get_smoke(name), compute_dtype="bfloat16")
    got = TRUN.ModelRunner(cfg, seed=9, device="cpu").params
    want = TM.cast_params(TM.init_params(
        cfg, torch.Generator().manual_seed(9), device="cpu"), cfg)
    got_t, want_t = [], []
    TM.tree_map(got_t.append, got)
    TM.tree_map(want_t.append, want)
    assert len(got_t) == len(want_t) > 0
    for a, b in zip(got_t, want_t):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the serving engine with runners
# ----------------------------------------------------------------------

CFG_J = JA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)
CFG_T = TA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)


def _engines(load: bool, names=DENSE_SSM):
    jm, tm = JMRES(), TMRES()
    for i, name in enumerate(names):
        jr, tr = _runners(name, seed=i)
        jm.register(JCAT.build_entry(name, runner=jr))
        tm.register(TCAT.build_entry(name, runner=tr))
    ja = JA.TaskAnalyzer(CFG_J, seed=3)
    ta = TA.TaskAnalyzer(CFG_T, device="cpu", state=TA.params_from_jax(
        jax.tree_util.tree_map(np.asarray, ja.params)))
    jr = JOptiRoute(jm, ja, load=JLoad(2) if load else None,
                    load_weight=0.2 if load else 0.0)
    tr = TOptiRoute(tm, ta, load=TLoad(2) if load else None,
                    load_weight=0.2 if load else 0.0, device="cpu")
    for r in (jr, tr):
        r.engine.confidence_threshold = 0.0
    return (JServingEngine(jr, prompt_len=12),
            TServingEngine(tr, prompt_len=12))


def _requests(n, seed, deadlines=False):
    recs = make_workload(n, seed=seed)
    dl = (lambda i: [None, 5.0, 1e-3][i % 3]) if deadlines else \
        (lambda i: None)
    return ([JRequest(text=r.text, prefs=PROFILES[i % 4], id=i, max_new=3,
                      deadline_ms=dl(i)) for i, r in enumerate(recs)],
            [TRequest(text=r.text, prefs=PROFILES[i % 4], id=i, max_new=3,
                      deadline_ms=dl(i)) for i, r in enumerate(recs)])


def _serve_both(monkeypatch, load, names):
    monkeypatch.setattr(TRUN, "PEAK_FLOPS", JRUN.PEAK_FLOPS)
    monkeypatch.setattr(TRUN, "HBM_BW", JRUN.HBM_BW)
    je, te = _engines(load, names)
    models, kinds = set(), set()
    for seed in (11, 12):
        jreq, treq = _requests(16, seed, deadlines=load)
        jout, tout = je.submit(jreq), te.submit(treq)
        for a, b in zip(jout, tout):
            assert (a.model, a.admission) == (b.model, b.admission)
            assert a.sim_latency_s == pytest.approx(b.sim_latency_s,
                                                    rel=1e-9)
            models.add(b.model)
            kinds.add(b.admission)
            if a.tokens is None:
                assert b.tokens is None
                continue
            if not np.array_equal(a.tokens, b.tokens):
                # only a near-tie of the reference may explain it
                runner = je.router.mres.entry(a.model).runner
                toks = je._tokens([a.request.text], runner.cfg.vocab_size)
                ref, logits = jax_greedy(runner.params, runner.cfg, toks, 3)
                assert_greedy_agrees(b.tokens[None], ref, logits)
    assert models == set(names)
    if load:
        assert "shed" in kinds and "admitted" in kinds
        np.testing.assert_allclose(te.load.inflight, je.load.inflight)
        np.testing.assert_allclose(te.load.ewma_s, je.load.ewma_s,
                                   rtol=1e-9)


@pytest.mark.parametrize("load", [False, True], ids=["plain", "load"])
def test_serving_with_runners_matches_reference(monkeypatch, load):
    _serve_both(monkeypatch, load, DENSE_SSM)


@pytest.mark.parametrize("load", [False, True], ids=["plain", "load"])
def test_serving_with_moe_runners_matches_reference(monkeypatch, load):
    _serve_both(monkeypatch, load, MOE)


class _Broken:
    def __init__(self, cfg):
        self.cfg = cfg

    def generate(self, tokens, max_new=16, **kw):
        raise RuntimeError("device lost")


def test_failing_runner_fails_only_its_group():
    _, te = _engines(load=True)
    bad = te.router.mres.entry("mamba2-1.3b")
    bad.runner = _Broken(bad.runner.cfg)
    _, treq = _requests(16, 11)
    out = te.submit(treq)
    failed = [r for r in out if r.model == "mamba2-1.3b"]
    served = [r for r in out if r.model == "llama3.2-1b"]
    assert failed and served
    for r in failed:
        assert r.failed and not r.served and r.tokens is None
        assert r.rq is None and r.sim_latency_s == 0.0
        assert r.error == "RuntimeError: device lost"
    for r in served:
        assert r.served and not r.failed and r.error == ""
        assert r.tokens.shape == (3,) and r.sim_latency_s > 0
    assert not te.load.inflight.any()          # every slot released
    te.observe(out, [1.0] * len(out))          # failed rows are skipped
