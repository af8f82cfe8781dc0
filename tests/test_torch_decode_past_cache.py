"""A decode step at a position at or past the cache's C slots, in the
port and in the JAX package, at ``SMOKE`` for llama3.2-1b (a full
cache), gemma2-2b (local/global layers in a full cache) and hymba-1.5b
(a ring, plus the SSM half).

The reference drops the out-of-bounds write (``.at[rows, slot].set``)
and its ``idx <= pos`` mask keeps all C slots live; the continuous
batcher reaches this on every idle slot and on a request's last,
discarded tick.  Prompt of 6 tokens, ``max_len=8`` (C = 8), then
``decode_step`` at ``pos = [C, C + 1]``: logits within the 1e-4 of
``tests/test_torch_models.py``, the full caches left unchanged, and the
ring (written at ``pos % C``, as in the reference) equal to the
reference's.  Weights through ``params_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import model as JM
from repro_torch.configs import get_smoke
from repro_torch.models import model as TM

ARCHS = ["llama3.2-1b", "gemma2-2b", "hymba-1.5b"]
LP, CAP = 6, 8


def _prefilled(name):
    jcfg, tcfg = jget_smoke(name), get_smoke(name)
    jp = JM.init_params(jax.random.PRNGKey(4), jcfg)
    tp = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, LP)).astype(np.int32)
    _, jc, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          max_len=CAP)
    _, tc, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                          max_len=CAP)
    return jcfg, tcfg, jp, tp, jc, tc


def decode_past_cache(tcfg, tp, tc, C, device):
    """The port's decode step at pos [C, C + 1] on ``device``: (logits,
    cache before, cache after)."""
    tp = TM.tree_map(lambda x: x.to(device), tp)
    tc = {k: v.to(device) for k, v in tc.items()}
    before = {k: v.clone() for k, v in tc.items()}
    tok = torch.tensor([[3], [7]], device=device)
    pos = torch.tensor([C, C + 1], device=device)
    logits, after = TM.decode_step(tp, tcfg, tc, {"token": tok, "pos": pos})
    return logits, before, after


@pytest.mark.parametrize("name", ARCHS)
def test_decode_at_and_past_capacity_matches_reference(name):
    jcfg, tcfg, jp, tp, jc, tc = _prefilled(name)
    C = tc["k"].shape[2]
    assert C == CAP
    want, jc2 = JM.decode_step(
        jp, jcfg, jc, {"token": jnp.asarray([[3], [7]], jnp.int32),
                       "pos": jnp.asarray([C, C + 1], jnp.int32)})
    got, before, after = decode_past_cache(tcfg, tp, tc, C, "cpu")
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    ring = bool(tcfg.sliding_window) and not tcfg.local_global_pattern
    for key in ("k", "v"):
        if ring:          # the ring writes slot pos % C, as there
            np.testing.assert_allclose(after[key].numpy(),
                                       np.asarray(jc2[key]), rtol=1e-5,
                                       atol=1e-5)
        else:             # nothing written past the cache
            assert torch.equal(after[key], before[key])
            np.testing.assert_array_equal(np.asarray(jc2[key]),
                                          np.asarray(jc[key]))
    if tcfg.has_ssm:      # the state has no slots: both advance
        np.testing.assert_allclose(after["ssd"].numpy(),
                                   np.asarray(jc2["ssd"]), rtol=1e-4,
                                   atol=1e-4)
