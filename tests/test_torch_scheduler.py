"""The port's ``ContinuousBatcher`` against the JAX package's, on the CPU
at ``SMOKE`` (weights from the reference's ``init_params`` through
``params_from_jax``), and the cases of ``tests/test_scheduler.py`` on
the port.

Parity: the same requests (prompts of ragged lengths, one at its limit
so its last tick decodes at pos = C, mixed ``max_new``) through both
batchers give the same tokens per request, the same ticks and slot
assignments, and slot caches within 1e-4 after the drain (idle slots
keep decoding in both; their rows must not leak into live ones), for
dense llama3.2-1b and qwen2-1.5b (q/k/v biases), the SSM mamba2-1.3b,
hymba-1.5b with its window cut to 16 so the ring wraps, and gemma2-2b
(local/global).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import model as JM
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import SlotRequest as JSlot
from repro_torch.configs import get_smoke
from repro_torch.models import model as TM
from repro_torch.serving.load import LoadTracker
from repro_torch.serving.scheduler import ContinuousBatcher, SlotRequest

CTX = 48
PARITY = {"llama3.2-1b": {}, "qwen2-1.5b": {}, "mamba2-1.3b": {},
          "hymba-1.5b": {"sliding_window": 16}, "gemma2-2b": {}}


def _cfgs(name, **kw):
    return (dataclasses.replace(jget_smoke(name), **kw),
            dataclasses.replace(get_smoke(name), **kw))


def _requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    spec = [(7, 4), (CTX - 5, 6), (12, 3), (30, 5), (5, 2)]   # #1 at limit
    return [(i, rng.integers(2, vocab, L).astype(np.int32), m)
            for i, (L, m) in enumerate(spec)]


@pytest.mark.parametrize("name", list(PARITY))
def test_batcher_matches_reference(name):
    jcfg, tcfg = _cfgs(name, **PARITY[name])
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jb = JBatcher(jcfg, jp, slots=3, ctx_len=CTX)
    tb = ContinuousBatcher(tcfg, tp, slots=3, ctx_len=CTX, device="cpu")
    for i, toks, m in _requests(tcfg.vocab_size):
        assert len(toks) <= CTX - max(m - 1, 1)
        jb.submit(JSlot(id=i, tokens=toks, max_new=m))
        tb.submit(SlotRequest(id=i, tokens=toks, max_new=m))
    jf, tf = jb.run_until_drained(), tb.run_until_drained()
    assert tb.ticks == jb.ticks
    assert [(r.id, r.slot, r.out) for r in tf] == \
        [(r.id, r.slot, r.out) for r in jf]
    assert all(len(r.out) == r.max_new for r in tf)
    # the slot at its limit took its last tick at pos = C
    assert tb.pos.max() >= CTX
    for key, c in tb.cache.items():
        np.testing.assert_allclose(c.numpy(), np.asarray(jb.cache[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


# ----------------------------------------------------------------------
# the reference's scheduler cases, on the port
# ----------------------------------------------------------------------

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke("llama3.2-1b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _sequential(cfg, params, tokens, max_new):
    """Oracle: single-sequence greedy generation."""
    toks = torch.from_numpy(np.asarray(tokens[None], np.int64))
    last, cache, pos = TM.prefill(params, cfg, {"tokens": toks}, max_len=256)
    out = [int(torch.argmax(last[0]))]
    for _ in range(max_new - 1):
        logits, cache = TM.decode_step(params, cfg, cache, {
            "token": torch.tensor([[out[-1]]]), "pos": pos})
        out.append(int(torch.argmax(logits[0])))
        pos = pos + 1
    return out


def _req(i, cfg, L=6, max_new=2):
    return SlotRequest(id=i, tokens=RNG.integers(
        2, cfg.vocab_size, L).astype(np.int32), max_new=max_new)


def test_matches_sequential_generation(setup):
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, slots=3, ctx_len=64, device="cpu")
    prompts = [RNG.integers(2, cfg.vocab_size, L).astype(np.int32)
               for L in (7, 12, 9, 15, 5)]
    for i, p in enumerate(prompts):
        cb.submit(SlotRequest(id=i, tokens=p, max_new=4))
    finished = cb.run_until_drained()
    assert len(finished) == 5
    by_id = {r.id: r for r in finished}
    for i, p in enumerate(prompts):
        assert by_id[i].out == _sequential(cfg, params, p, 4), i


def test_slots_are_reused(setup):
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, slots=2, ctx_len=64, device="cpu")
    for i in range(6):
        cb.submit(_req(i, cfg, max_new=2 + (i % 3)))
    finished = cb.run_until_drained()
    assert len(finished) == 6
    assert {r.slot for r in finished} <= {0, 1}
    assert cb.ticks < sum(2 + (i % 3) for i in range(6))


def test_drains_empty_queue(setup):
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, slots=2, ctx_len=32, device="cpu")
    assert cb.run_until_drained() == []
    assert cb.tick() == 0


def test_submit_rejects_overflowing_prompt_and_truncates(setup):
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, slots=2, ctx_len=16, device="cpu")
    for bad_len in (16, 17, 40):
        with pytest.raises(ValueError, match="ctx_len"):
            cb.submit(_req(0, cfg, L=bad_len))
    assert not cb.queue
    cb.submit(_req(1, cfg, L=15))            # len + max_new - 1 == ctx_len
    assert len(cb.queue) == 1
    cb = ContinuousBatcher(cfg, params, slots=2, ctx_len=16, device="cpu")
    long = RNG.integers(2, cfg.vocab_size, 48).astype(np.int32)
    req = SlotRequest(id=0, tokens=long, max_new=3)
    cb.submit(req, truncate=True)
    assert len(req.tokens) == 14
    np.testing.assert_array_equal(req.tokens, long[:14])
    finished = cb.run_until_drained()
    assert len(finished) == 1
    assert finished[0].out == _sequential(cfg, params, long[:14], 3)


def test_batcher_mirrors_load_tracker(setup):
    cfg, params = setup
    lt = LoadTracker(default_service_s=99.0)
    cb = ContinuousBatcher(cfg, params, slots=2, ctx_len=64, load=lt,
                           model_idx=1, device="cpu")
    assert lt.n_models == 2 and lt.snapshot()[2][1] == 2.0
    for i in range(4):
        cb.submit(_req(i, cfg))
    q, f, _, _ = lt.snapshot()
    assert q[1] == 4 and f[1] == 0 and cb.queue_depth() == 4
    cb.tick()
    q, f, _, _ = lt.snapshot()
    assert q[1] == 2 and f[1] == 2
    cb.run_until_drained()
    q, f, _, ewma = lt.snapshot()
    assert q[1] == 0 and f[1] == 0 and cb.queue_depth() == 0
    assert ewma[1] < 99.0


def test_max_ticks_exit_rolls_tracker_back(setup):
    cfg, params = setup
    lt = LoadTracker(default_service_s=0.5)
    cb = ContinuousBatcher(cfg, params, slots=2, ctx_len=64, load=lt,
                           model_idx=0, device="cpu")
    for i in range(5):
        cb.submit(_req(i, cfg, max_new=8))
    finished = cb.run_until_drained(max_ticks=2)
    assert len(finished) < 5 and cb.queue_depth() == 0
    q, f, _, ewma = lt.snapshot()
    assert q[0] == 0 and f[0] == 0 and ewma[0] == pytest.approx(0.5)
    assert len(cb.cancelled) == 5 - len(finished)
    assert all(r.slot == -1 for r in cb.cancelled)
    cb2 = ContinuousBatcher(cfg, params, slots=2, ctx_len=64, load=lt,
                            model_idx=1, device="cpu")
    cb2.submit(_req(9, cfg, max_new=50))
    cb2.run_until_drained(max_ticks=cb2.ticks + 1, cancel_leftover=False)
    assert cb2.queue_depth() == 1 and lt.snapshot()[1][1] == 1
    cb2.cancel()
    q, f, _, _ = lt.snapshot()
    assert cb2.queue_depth() == 0 and q[1] == 0 and f[1] == 0
