"""The port's MoE gate and MoE block against the JAX package, on the CPU.

  * ``moe_gating``: the Pallas kernel (interpret mode) and its oracle
    ``ref.moe_gating`` against the port's ``moe_gating_plain`` and
    ``ops.moe_gating`` (which takes the plain version on the CPU), over
    the sweep of ``tests/test_kernels.py::test_moe_gating_sweep`` plus
    rows with exact ties and bf16 logits.  ``idx`` equal; ``vals`` and
    ``aux`` within 1e-6 (one softmax and one division in f32 apart).
  * ``moe_gate`` (the reference's mask form): weights and aux within
    1e-6.
  * ``moe_block`` against the reference's one-hot dispatch on tiny
    configs: tokens dropped (capacity 0.25, groups of 8), a ragged tail
    group (L = 13, groups of 8), a shared expert with k = 1, and no drop
    at all.  ``y`` within 1e-5 (f32 expert products summed in another
    order), ``aux`` within 1e-6.  The drop case runs in bf16 too, the
    dtype of the card's main path: there the combine weights are rounded
    to bf16 before the product, as in the reference, and ``y`` agrees
    within 2**-7 absolute plus 2**-7 relative (one bf16 ulp at 1 each:
    the bf16 expert products round differently in XLA and in PyTorch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels import ops as K
from repro.kernels import ref as R
from repro.models import layers as JL
from repro_torch.configs import get_smoke
from repro_torch.kernels import moe_gating as MG
from repro_torch.kernels import ops as P
from repro_torch.models import layers as TL

RNG = np.random.default_rng(0)
MOE = "qwen3-moe-30b-a3b"


def _tied_logits(T, E, rng):
    """Random logits whose rows hold exact ties: all equal, a tied
    maximum, and ties straddling the k-th place."""
    lg = rng.standard_normal((T, E)).astype(np.float32)
    lg[0] = 0.0                                   # every expert ties
    lg[1, E // 2:] = lg[1, :E - E // 2]           # each value twice
    lg[2] = np.round(lg[2])                       # a few distinct values
    if T > 3:
        lg[3, ::2] = lg[3, 0]                     # a tied maximum
        lg[3, 0] += 1.0
    return lg


def _check_gate(lg, k, blk):
    v1, i1, a1 = K.moe_gating(jnp.asarray(lg), k, blk_t=blk)
    v2, i2, a2 = R.moe_gating(jnp.asarray(lg), k)
    pv, pi, pa = MG.moe_gating_plain(torch.from_numpy(np.asarray(lg)), k)
    assert pv.dtype == torch.float32 and pi.dtype == torch.int32
    for vals, idx, aux in ((v1, i1, a1), (v2, i2, a2)):
        np.testing.assert_array_equal(pi.numpy(), np.asarray(idx))
        np.testing.assert_allclose(pv.numpy(), np.asarray(vals), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(float(pa), float(aux), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("T,E,k,blk", [
    (64, 8, 2, 16), (100, 32, 4, 32), (7, 16, 1, 8), (256, 128, 8, 64),
])
def test_moe_gating_plain_matches_pallas_and_reference(T, E, k, blk):
    _check_gate(RNG.standard_normal((T, E)).astype(np.float32), k, blk)


@pytest.mark.parametrize("T,E,k,blk", [(9, 8, 3, 8), (40, 60, 4, 16),
                                       (5, 128, 8, 8)])
def test_moe_gating_exact_ties_go_to_the_lower_expert(T, E, k, blk):
    lg = _tied_logits(T, E, np.random.default_rng(T))
    _check_gate(lg, k, blk)
    _, idx, _ = MG.moe_gating_plain(torch.from_numpy(lg), k)
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(k))


def test_moe_gating_bf16_logits_read_as_f32():
    lg = jnp.asarray(RNG.standard_normal((33, 16)), jnp.bfloat16)
    v2, i2, a2 = R.moe_gating(lg, 4)
    pv, pi, pa = MG.moe_gating_plain(
        torch.from_numpy(np.array(lg.astype(jnp.float32))).to(
            torch.bfloat16), 4)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(i2))
    np.testing.assert_allclose(pv.numpy(), np.asarray(v2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(pa), float(a2), rtol=1e-6)


@pytest.mark.parametrize("T,E,k", [
    (8192, 128, 8), (16, 128, 8), (1, 4, 1), (3, 1024, 16), (65, 128, 8),
    (100_000, 128, 8), (5, 1024, 1024), (7, 60, 16), (40_000, 128, 8),
    (300, 128, 1), (1000, 8, 2), (77, 33, 4)])
def test_gate_plan_covers_every_token_once(T, E, k):
    """The kernel's launch shape: a token's lanes cover E in whole 16-byte
    loads of bf16, the block fits its thread and shared-memory limits,
    and the grid-stride passes (block b, pass p: tokens
    [(p blocks + b) tpb, + tpb)) take every token exactly once, with no
    block left without a token."""
    lanes, per = MG.gate_lanes(E)
    assert lanes * per >= E and per % 8 == 0 and 32 % lanes == 0
    warps, blocks = MG.gate_plan(T, E, k)
    assert 1 <= warps * 32 <= (1024 if per <= 8 else 256)
    gpw = 32 // lanes
    assert (8 * warps * gpw * k + 4 * max(warps, 2) * lanes * per
            + 4 * lanes * per) <= MG.SMEM_MAX
    tpb = warps * gpw
    seen = np.zeros(T, np.int64)
    for b in range(blocks):
        for base in range(b * tpb, T, blocks * tpb):
            seen[base:base + tpb] += 1
    assert (seen == 1).all()
    assert 1 <= blocks <= 2 * MG.SM_COUNT and (blocks - 1) * tpb < T


def test_gate_plan_decode_is_one_block_and_prefill_one_wave():
    """qwen3-moe-30b-a3b's decode gate (T = 16) is one block, which forms
    aux itself; its prefill gate (T = 16 x 512) at most one block per
    SM, so the last block adds few partials."""
    assert MG.gate_plan(16, 128, 8)[1] == 1
    assert MG.gate_plan(16 * 512, 128, 8)[1] <= MG.SM_COUNT


def test_gate_plan_depends_on_shapes_only():
    import inspect
    assert list(inspect.signature(MG.gate_plan).parameters) == \
        ["T", "E", "k"]


@pytest.mark.parametrize("E", [4, 60, 128, 1024])
def test_gate_key_order_is_value_then_lower_index(E):
    """The kernel ranks (probability, expert) by one 64-bit key,
    bits(p) << 32 | (2**32 - 1 - expert): probabilities are >= 0, so
    their f32 bits order like their values.  Sorting the keys gives
    ``topk_stable``'s order on the same probabilities, exact ties and
    underflowed zeros included."""
    lg = _tied_logits(6, E, np.random.default_rng(E))
    lg[4, : E // 2] = -200.0                      # probabilities of 0
    probs = torch.softmax(torch.from_numpy(lg), dim=-1)
    bits = probs.numpy().view(np.uint32).astype(np.uint64)
    keys = bits << np.uint64(32) | (np.uint64(2**32 - 1)
                                    - np.arange(E, dtype=np.uint64))
    order = np.argsort(keys, axis=1)[:, ::-1]
    _, want = MG.topk_stable(probs, E)
    np.testing.assert_array_equal(order, want.numpy())


def test_ops_moe_gating_flattens_leading_axes():
    lg = RNG.standard_normal((3, 5, 16)).astype(np.float32)
    v1, i1, a1 = K.moe_gating(jnp.asarray(lg), 2, blk_t=8)
    v2, i2, a2 = P.moe_gating(torch.from_numpy(lg), 2)
    assert tuple(v2.shape) == (3, 5, 2) and tuple(i2.shape) == (3, 5, 2)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_allclose(v2.numpy(), np.asarray(v1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(a2), float(a1), rtol=1e-6)


@pytest.mark.parametrize("shape,k", [((2, 5, 8), 2), ((7, 4), 1),
                                     ((3, 16), 4)])
def test_moe_gate_matches_reference(shape, k):
    lg = RNG.standard_normal(shape).astype(np.float32)
    lg.reshape(-1, shape[-1])[0, :3] = 0.5        # a tie at the threshold
    w1, a1 = JL.moe_gate(jnp.asarray(lg), k)
    w2, a2 = TL.moe_gate(torch.from_numpy(lg), k)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(a2), float(a1), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# moe_block
# ----------------------------------------------------------------------

BLOCKS = {
    "drops": (dict(moe_capacity_factor=0.25, moe_group=8), 16),
    "ragged": (dict(moe_group=8), 13),
    "shared_k1": (dict(shared_expert=True, moe_top_k=1), 12),
    "no_drop": ({}, 10),
    "drops_bf16": (dict(moe_capacity_factor=0.25, moe_group=8,
                        compute_dtype="bfloat16"), 16),
}
# y's tolerance (rtol = atol) by the dtype of x and the weights
Y_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _to_torch(a):
    """A JAX array as a torch tensor of the same dtype (bf16 included)."""
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(getattr(torch, str(a.dtype)))


def _moe(over, seed):
    """Reference MoE params from ``init_moe``, cast to the config's
    compute dtype, and the same values as torch tensors."""
    jcfg = dataclasses.replace(jget_smoke(MOE), **over)
    tcfg = dataclasses.replace(get_smoke(MOE), **over)
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jcfg.compute_dtype),
        JL.init_moe(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jp, jax.tree_util.tree_map(_to_torch, jp)


@pytest.mark.parametrize("case", list(BLOCKS))
def test_moe_block_matches_reference(case):
    over, L = BLOCKS[case]
    jcfg, tcfg, jp, tp = _moe(over, seed=len(case))
    x = jnp.asarray(RNG.standard_normal((3, L, jcfg.d_model)),
                    jcfg.compute_dtype)
    yj, aj = JL.moe_block(jp, jcfg, x)
    yt, at = TL.moe_block(tp, tcfg, _to_torch(x))
    assert yt.shape == (3, L, jcfg.d_model)
    assert yt.dtype == getattr(torch, jcfg.compute_dtype)
    tol = Y_TOL[jcfg.compute_dtype]
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=1e-6)


def test_moe_block_drops_tokens_past_capacity():
    """At capacity factor 1 (C = 4 slots per expert for a group's 16
    pairs) the busiest experts drop pairs: those tokens' outputs move
    against the no-drop block, the others' do not.  The reference
    agrees on drops (``test_moe_block_matches_reference[drops]``)."""
    over = dict(moe_capacity_factor=1.0, moe_group=8)
    _, tcfg, _, tp = _moe(over, seed=5)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    y, _ = TL.moe_block(tp, tcfg, x)
    full = dataclasses.replace(tcfg, moe_capacity_factor=4.0)
    y_full, _ = TL.moe_block(tp, full, x)
    # a dropped pair moves its token's output by O(0.1); a kept one only
    # by the rounding of a product of another shape
    rows_changed = (y - y_full).abs().amax(dim=-1) > 1e-3
    assert rows_changed.any() and not rows_changed.all()


def test_moe_block_gates_once_per_group_shape(monkeypatch):
    """Every gate goes through ``ops.moe_gating``: one call for whole
    groups, a second for a ragged tail, and aux is their sum."""
    over, L = BLOCKS["ragged"]
    _, tcfg, _, tp = _moe(over, seed=7)
    calls = []
    orig = P.moe_gating

    def spy(logits, k):
        out = orig(logits, k)
        calls.append((tuple(logits.shape), float(out[2])))
        return out
    monkeypatch.setattr(P, "moe_gating", spy)
    x = torch.from_numpy(RNG.standard_normal((2, L, tcfg.d_model)).astype(
        np.float32))
    _, aux = TL.moe_block(tp, tcfg, x)
    E = tcfg.n_experts
    assert [c[0] for c in calls] == [(2, 8, E), (2, 5, E)]
    assert float(aux) == pytest.approx(calls[0][1] + calls[1][1], rel=1e-7)
