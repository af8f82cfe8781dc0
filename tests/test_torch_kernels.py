"""The port's kernels (plain PyTorch versions, as the CPU runs them)
against the JAX package: ``router_topk`` / ``router_topk_q8`` against
``repro.kernels.ref.router_topk`` and the interpret-mode Pallas kernels
behind ``repro.kernels.ops.router_topk``, ``bandit_update`` against
``ref.bandit_update``, ``flash_attention`` against the interpret-mode
Pallas kernel and ``ref.mha_attention``, ``ssd_scan`` against the
interpret-mode Pallas scan and ``ref.ssd_scan``; the decode launch's
split of the cache (``decode_splits``) and its split-and-merge
arithmetic (``decode_split_plain``) against ``flash_attention_plain``
and ``ref.mha_attention``.  Inputs are made with numpy from a seed.

Tolerances: fp32 values within 1e-6 on finite slots (different sum
orders, same arithmetic); indices equal except inside a run of scores
tied within 2e-6; int8 bit-equal (integer dots are exact); bandit
outputs rtol 1e-5 (atol 1e-6 for values near zero).  Attention 2e-4 in
f32 and 2e-2 in bf16 (one bf16 rounding of the output, values of order
1), 3e-4 with window and softcap; the scan 3e-4 (the reference's own
kernel tolerance: a chunked against a sequential sum).

The CUDA kernels themselves need a card; those tests (marked ``cuda``)
skip here, ``tests/test_torch_cuda.py`` holds the card-only tests that
run without JAX, and ``chip_smoke.py`` holds each kernel against its
plain version on the card.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro.kernels import ref as R
from repro_torch.kernels import bandit_update as BU
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as P
from repro_torch.kernels import router_topk as RT
from repro_torch.kernels.route_step import quantize_rows

NEG_INF = float("-inf")
# the oracle, compiled once per shape instead of op by op
_ref_topk = jax.jit(R.router_topk, static_argnums=(2,),
                    static_argnames=("min_score", "quant"))


def assert_topk_match(got, want, scores=None, *, atol=1e-6, what=""):
    """Finite slots equal in number, values within ``atol``; indices
    equal except where their scores tie within 2 * atol (``scores``,
    the (Q, N) score matrix, decides ties)."""
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin, err_msg=what)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=atol,
                               err_msg=what)
    diff = fin & (gi != wi)
    for q, j in zip(*np.nonzero(diff)):
        assert scores is not None, f"{what}: index differs at {(q, j)}"
        assert abs(scores[q, gi[q, j]] - scores[q, wi[q, j]]) <= 2 * atol, \
            f"{what}: index differs at {(q, j)} without a tie"


def _problem(Q, N, D, seed, *, dups=0, empty_rows=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    if dups:
        emb[N - dups:] = emb[:dups]              # duplicate rows: ties
    q = rng.standard_normal((Q, D)).astype(np.float32)
    if dups:
        q[:2] = emb[:2]
    mask = rng.random((Q, N)) < 0.6
    mask[:empty_rows] = False
    return emb, q, mask


def _cos(emb, q):
    e = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    x = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-9)
    return x.astype(np.float64) @ e.T.astype(np.float64)


# ----------------------------------------------------------------------
# router_topk fp32
# ----------------------------------------------------------------------

@pytest.mark.parametrize("Q,N,D,k,min_score,with_bias", [
    (5, 40, 8, 8, None, False),
    (9, 300, 8, 8, None, True),          # row bias on valid rows
    (4, 6, 8, 9, None, False),           # k > N: the tail is -inf
    (16, 200, 40, 1, 0.3, False),        # the cache lookup's k=1 + floor
    (7, 130, 5, 4, 0.1, True),
])
def test_router_topk_plain_matches_reference(Q, N, D, k, min_score,
                                             with_bias):
    emb, q, mask = _problem(Q, N, D, seed=Q * 100 + N, empty_rows=1)
    bias = (np.random.default_rng(N).random(N).astype(np.float32) * 0.2
            if with_bias else None)
    got = P.router_topk(emb, q, k, mask=mask, row_bias=bias,
                        min_score=min_score, device="cpu")
    ref = _ref_topk(jnp.asarray(emb), jnp.asarray(q), k,
                    mask=jnp.asarray(mask),
                    row_bias=None if bias is None else jnp.asarray(bias),
                    min_score=min_score)
    pallas = K.router_topk(emb, q, k, mask=mask, row_bias=bias,
                           min_score=min_score)
    s = _cos(emb, q) + (0 if bias is None else bias[None, :])
    for want, nm in ((ref, "ref"), (pallas, "pallas")):
        assert_topk_match(got, want, s, what=nm)
    assert np.isinf(np.asarray(got[0])[0]).all()      # the empty mask row


def test_router_topk_duplicate_rows_tie_toward_lower_index():
    """Bit-identical duplicate rows score equal; the lower catalog
    index must come first, as ``lax.top_k`` orders them."""
    Q, N, D, dups = 6, 64, 8, 16
    emb, q, _ = _problem(Q, N, D, seed=5, dups=dups)
    got_v, got_i = (np.asarray(a) for a in
                    P.router_topk(emb, q, 8, device="cpu"))
    ref_v, ref_i = (np.asarray(a) for a in
                    _ref_topk(jnp.asarray(emb), jnp.asarray(q), 8))
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_allclose(got_v, ref_v, atol=1e-6)
    for row in got_i[:2]:            # queries equal to duplicated rows
        for j in row:
            if j >= N - dups:
                assert j - (N - dups) in row[:list(row).index(j)]


def test_router_topk_plain_reads_the_mask_table_rows():
    """The kernel contract: a stacked uint8 table plus one row index per
    query equals the (Q, N) mask it stands for."""
    rng = np.random.default_rng(3)
    N, D, Q = 100, 8, 12
    emb = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    table = torch.from_numpy((rng.random((5, N)) < 0.4).astype(np.uint8))
    rows = torch.from_numpy(rng.integers(0, 5, Q).astype(np.int32))
    got = RT.router_topk(q, emb, table, rows, 4)
    full = table[rows.long()]
    want = RT.router_topk(q, emb, full, torch.arange(Q, dtype=torch.int32), 4)
    assert torch.equal(got[0], want[0])
    fin = torch.isfinite(want[0])
    assert torch.equal(got[1][fin], want[1][fin])


@pytest.mark.parametrize("B,M,k", [(3, 7, 2), (5, 50, 5), (2, 9, 9)])
def test_topk_stable_matches_lax_top_k_with_ties(B, M, k):
    rng = np.random.default_rng(B * M)
    x = rng.integers(0, 4, (B, M)).astype(np.float32)   # many ties
    x[0, :2] = -np.inf
    v, i = RT.topk_stable(torch.from_numpy(x), k)
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


# ----------------------------------------------------------------------
# router_topk int8
# ----------------------------------------------------------------------

def test_quantize_rows_bit_equal_to_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 9)).astype(np.float32)
    x[3] = 0.0                                          # s = 1 rows
    x[5, 2] = 0.5 * 127                                 # half-way values
    q, s = quantize_rows(torch.from_numpy(x))
    wq, ws = R.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    nq, ns = P._quantize_rows_np(x)
    np.testing.assert_array_equal(nq, np.asarray(wq))
    np.testing.assert_array_equal(ns, np.asarray(ws))


@pytest.mark.parametrize("Q,N,D,k,min_score", [
    (6, 90, 8, 8, None), (11, 257, 40, 1, 0.2), (3, 5, 8, 7, None)])
def test_router_topk_q8_plain_matches_reference(Q, N, D, k, min_score):
    """End to end from float rows: the row norms before quantization
    may differ in the last bit between the frameworks, so the scores
    agree within 1e-6 (and bit for bit on shared int8 operands below)."""
    emb, q, mask = _problem(Q, N, D, seed=N + k, empty_rows=1)
    got = P.router_topk(emb, q, k, mask=mask, min_score=min_score,
                        quant=True, device="cpu")
    ref = _ref_topk(jnp.asarray(emb), jnp.asarray(q), k,
                    mask=jnp.asarray(mask), min_score=min_score, quant=True)
    assert_topk_match(got, ref, _cos(emb, q), atol=1e-6, what="q8")


@pytest.mark.parametrize("Q,N,D,k,min_score", [
    (6, 90, 8, 8, None), (11, 257, 40, 1, 0.2), (3, 5, 8, 7, None)])
def test_router_topk_q8_plain_bit_equal_on_int8_operands(Q, N, D, k,
                                                         min_score):
    """The reference's own int8 rows and scales: ``ref._q8_matmul`` +
    mask + floor + ``lax.top_k`` against the port's plain int8 version,
    bit for bit."""
    emb, q, mask = _problem(Q, N, D, seed=N + k, empty_rows=1)
    e8, es = R.quantize_rows(jnp.asarray(emb))
    q8, qs = R.quantize_rows(jnp.asarray(q))
    s = R._q8_matmul(q8, e8, qs, es)
    s = jnp.where(jnp.asarray(mask), s, -jnp.inf)
    if min_score is not None:
        s = jnp.where(s >= min_score, s, -jnp.inf)
    if k > N:
        s = jnp.pad(s, ((0, 0), (0, k - N)), constant_values=-jnp.inf)
    wv, wi = jax.lax.top_k(s, k)
    t = lambda a: torch.from_numpy(np.array(a))
    gv, gi = RT.router_topk_q8(
        t(q8), t(e8), t(qs)[:, 0], t(es)[:, 0], t(mask.astype(np.uint8)),
        torch.arange(Q, dtype=torch.int32), k,
        min_score=NEG_INF if min_score is None else min_score)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    fin = np.isfinite(np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy()[fin], np.asarray(wi)[fin])


def test_router_topk_q8_same_int8_operands_as_pallas():
    """Identical int8 operands through the port's plain int8 version
    and the interpret-mode Pallas int8 kernel: bit-equal."""
    from repro.kernels.router_topk import router_topk_q8_pallas
    rng = np.random.default_rng(9)
    Q, N, D, k = 8, 256, 128, 8
    q8, qs = R.quantize_rows(jnp.asarray(
        rng.standard_normal((Q, D)).astype(np.float32)))
    e8, es = R.quantize_rows(jnp.asarray(
        rng.standard_normal((N, D)).astype(np.float32)))
    mask = rng.random((Q, N)) < 0.5
    mask[0] = False
    wv, wi = router_topk_q8_pallas(
        q8, e8, qs, es.T, jnp.asarray(mask, jnp.float32),
        jnp.zeros((1, N), jnp.float32), k, blk_q=8, blk_n=128,
        interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    gv, gi = RT.router_topk_q8(t(q8), t(e8), t(qs)[:, 0], t(es)[:, 0],
                               t(mask.astype(np.uint8)),
                               torch.arange(Q, dtype=torch.int32), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    fin = np.isfinite(np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy()[fin], np.asarray(wi)[fin])


# ----------------------------------------------------------------------
# bandit_update
# ----------------------------------------------------------------------

def _bandit_problem(Bu, Bs, N, D, seed):
    rng = np.random.default_rng(seed)
    w = np.zeros((Bu, N), np.float32)
    w[np.arange(Bu), rng.integers(0, N, Bu)] = 1.0
    x = rng.random((Bu, D)).astype(np.float32)
    r = rng.random(Bu).astype(np.float32)
    xs = rng.random((Bs, D)).astype(np.float32)
    theta = (rng.standard_normal((N, D)) * 0.1).astype(np.float32)
    L = (rng.standard_normal((N, D, D)) * 0.05).astype(np.float32)
    ainv = np.einsum("nde,nfe->ndf", L, L) + 0.5 * np.eye(D, dtype=np.float32)
    return x, w, r, xs, theta, ainv.astype(np.float32)


@pytest.mark.parametrize("Bu,Bs,N,D,alpha", [
    (16, 8, 64, 9, 0.8), (3, 1, 200, 9, 0.0), (7, 5, 33, 4, 1.5)])
def test_bandit_update_plain_matches_reference(Bu, Bs, N, D, alpha):
    args = _bandit_problem(Bu, Bs, N, D, seed=Bu + N)
    got = P.bandit_update(*args, alpha, device="cpu")
    want = R.bandit_update(*(jnp.asarray(a) for a in args), alpha)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)


def test_bandit_update_empty_outcome_batch_gives_zero_deltas():
    x, w, r, xs, theta, ainv = _bandit_problem(4, 6, 50, 9, seed=2)
    args = (x[:0], w[:0], r[:0], xs, theta, ainv)
    dA, db, ucb = P.bandit_update(*args, 0.8, device="cpu")
    assert not dA.any() and not db.any()
    want = K.bandit_update(*args, 0.8)
    np.testing.assert_array_equal(dA.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(ucb.numpy(), np.asarray(want[2]), rtol=1e-5,
                               atol=1e-6)


def test_bandit_update_without_scoring_rows_needs_no_posterior():
    x, w, r, xs, theta, ainv = _bandit_problem(9, 3, 70, 9, seed=6)
    dA, db, ucb = P.bandit_update(x, w, r, xs[:0], None, None, 0.8,
                                  device="cpu")
    want = R.bandit_update(*(jnp.asarray(a) for a in
                             (x, w, r, xs, theta, ainv)), 0.8)
    assert ucb.shape == (0, 70)
    for g, w_ in zip((dA, db), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)


# ----------------------------------------------------------------------
# flash attention (layer layout through ops, kernel layout through FA)
# ----------------------------------------------------------------------

def _attn_problem(B, Lq, Lk, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Lq, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, Lk, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Lk, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,hd", [
    (1, 64, 64, 2, 2, 32),      # MHA, block-aligned
    (2, 100, 100, 4, 2, 64),    # GQA, ragged lengths
    (1, 1, 300, 8, 2, 64),      # decode-style single query
    (2, 128, 128, 4, 1, 128),   # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(B, Lq, Lk, Hq, Hkv, hd,
                                                 dtype):
    q, k, v = _attn_problem(B, Lq, Lk, Hq, Hkv, hd, seed=Lq + hd)
    jt = lambda a: jnp.asarray(a, getattr(jnp, dtype))
    tt = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    got = P.flash_attention(tt(q), tt(k), tt(v))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, Lq, Hq, hd)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for want in (K.flash_attention(jt(q), jt(k), jt(v), blk_q=32, blk_k=32),
                 R.mha_attention(jt(q), jt(k), jt(v))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("window,cap,causal", [
    (16, 0.0, True), (0, 30.0, True), (7, 50.0, True), (0, 0.0, False),
])
def test_flash_attention_plain_window_softcap(window, cap, causal):
    q, k, v = _attn_problem(2, 90, 90, 4, 2, 64, seed=window + int(cap))
    got = P.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window, softcap=cap)
    for want in (K.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=cap, blk_q=32, blk_k=32),
                 R.mha_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("C,blk", [(64, 32), (100, 32), (33, 16)])
def test_flash_decode_plain_matches_reference(C, blk):
    B, Hq, Hkv, hd = 3, 4, 2, 64
    q, kc, vc = _attn_problem(B, 1, C, Hq, Hkv, hd, seed=C)
    pos = np.asarray([0, C // 2, C - 1], np.int32)
    got = P.flash_decode(*(torch.from_numpy(a) for a in (q, kc, vc)),
                         torch.from_numpy(pos))
    want = K.flash_decode(q, kc, vc, jnp.asarray(pos), blk_k=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # each row sees exactly the keys at slots <= pos
    for b, p in enumerate(pos):
        want_b = R.mha_attention(q[b:b + 1], kc[b:b + 1, :p + 1],
                                 vc[b:b + 1, :p + 1], causal=False)
        np.testing.assert_allclose(got.numpy()[b:b + 1], np.asarray(want_b),
                                   rtol=2e-4, atol=2e-4)


def test_flash_attention_plain_row_without_live_key_is_zero():
    q, k, v = _attn_problem(3, 1, 20, 4, 2, 32, seed=3)
    kv_valid = torch.tensor([0, 5, 20], dtype=torch.int32)
    got = P.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            kv_valid, causal=False)
    assert not got[0].any()
    want = R.mha_attention(q[1:2], k[1:2, :5], v[1:2, :5], causal=False)
    np.testing.assert_allclose(got[1:2].numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_kernel_layout_takes_strided_views():
    """The wrapper's (B, H, L, hd) contract on transposed views equals
    the same call on contiguous copies."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _attn_problem(2, 33, 33, 4, 2, 64, seed=9))
    a = FA.flash_attention(q, k, v, causal=True)
    b = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------------------------------
# the decode launch's split of the cache (decided on the host)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,Hkv,Lk", [
    (16, 8, 536), (16, 4, 536), (1, 1, 1), (4, 2, 63), (4, 2, 4100),
    (1, 1, 0), (64, 8, 536), (2, 1, 100_000), (3, 5, 777)])
def test_decode_splits_cover_every_key_once(B, Hkv, Lk):
    n, chunk = FA.decode_splits(B, Hkv, Lk)
    assert n >= 1 and chunk >= 1 and chunk % FA.MIN_CHUNK == 0
    # chunks [i chunk, (i + 1) chunk) tile [0, Lk) with no empty tail
    assert n * chunk >= Lk and (n - 1) * chunk < max(Lk, 1)
    owner = np.repeat(np.arange(n), chunk)[:Lk]
    assert np.array_equal(np.bincount(owner, minlength=n)[:n - 1],
                          np.full(n - 1, chunk))


@pytest.mark.parametrize("Hkv", [8, 4])
def test_decode_splits_fill_the_card_at_the_served_shape(Hkv):
    """llama3.2-1b (8 KV heads) and qwen3-moe-30b-a3b (4) at B=16 over
    the served cache of 536 slots: at least two blocks per SM."""
    n, _ = FA.decode_splits(16, Hkv, 536)
    assert 16 * Hkv * n >= 2 * FA.SM_COUNT


def test_decode_splits_depend_on_shapes_only():
    """The split is a function of (B, Hkv, Lk): the live lengths never
    reach the host, so the wrapper needs no device sync."""
    params = list(inspect.signature(FA.decode_splits).parameters)
    assert params == ["B", "Hkv", "Lk"]


# ----------------------------------------------------------------------
# the top-k launch's grid (decided on the host) and its threshold rule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 8, 40, 64])
@pytest.mark.parametrize("Q,N", [
    (256, 100_000), (256, 4096), (1, 1), (32, 0), (64, 5000), (1, 100_003),
    (1024, 4096), (7, 127), (300, 1_000_000)])
def test_topk_plan_covers_every_row_once(Q, N, D):
    """Chunk s takes rows [s chunk, min(N, (s + 1) chunk)): every row in
    exactly one chunk, none empty, each a whole number of tiles."""
    S, chunk = RT.topk_plan(Q, N, D)
    assert S >= 1 and chunk >= RT.TILE and chunk % RT.TILE == 0
    assert S * chunk >= N and (S - 1) * chunk < max(N, 1)
    owner = np.repeat(np.arange(S), chunk)[:N]
    assert np.array_equal(np.bincount(owner, minlength=S)[:S - 1],
                          np.full(S - 1, chunk))


@pytest.mark.parametrize("Q,N,D", [(256, 100_000, 8), (256, 4096, 40)])
def test_topk_plan_fills_the_card_at_the_served_shapes(Q, N, D):
    """The route step and the cache lookup: about BLOCKS_PER_SM blocks
    per SM, all resident at once (one wave)."""
    S, _ = RT.topk_plan(Q, N, D)
    blocks = -(-Q // RT.queries_per_block(D)) * S
    assert 0.9 * RT.BLOCKS_PER_SM * RT.SM_COUNT <= blocks <= \
        RT.BLOCKS_PER_SM * RT.SM_COUNT


def test_topk_plan_depends_on_shapes_only():
    params = list(inspect.signature(RT.topk_plan).parameters)
    assert params == ["Q", "N", "D"]


def _topk_kernel_model(scores, k, chunk, step):
    """The CUDA kernel's selection for one query, in Python: per chunk,
    ``step`` rows at a time (a row per lane), the scores at or above the
    threshold -- the k-th best of the warp's sorted list so far, -inf
    while it holds fewer -- are inserted in lane order, each where its
    (value desc, index asc) rank puts it; the rest never reach the list.
    The query's answer is the same insertion over the chunks' lists,
    rank by rank (32 lists at a time), until a rank offers nothing.
    ``scores`` holds -inf where the mask or the floor drops a row."""
    def insert(lst, cands):
        for v, n in cands:
            if len(lst) < k or (-v, n) < lst[-1]:
                lst = sorted(lst + [(-v, n)])[:k]
        return lst

    parts = []
    for n0 in range(0, max(len(scores), 1), chunk):
        lst = []
        for base in range(n0, min(len(scores), n0 + chunk), step):
            theta = -lst[k - 1][0] if len(lst) >= k else NEG_INF
            lst = insert(lst, [(scores[n], n) for n in range(
                base, min(base + step, len(scores), n0 + chunk))
                if scores[n] != NEG_INF and not scores[n] < theta])
        parts.append([(-v, n) for v, n in lst])
    best = []
    for r in range(k):
        offered = False
        for s0 in range(0, len(parts), 32):
            theta = -best[k - 1][0] if len(best) >= k else NEG_INF
            cands = [lst[r] for lst in parts[s0:s0 + 32]
                     if len(lst) > r and not lst[r][0] < theta]
            offered = offered or bool(cands)
            best = insert(best, cands)
        if not offered:
            break
    best += [(-NEG_INF, -1)] * (k - len(best))
    return (np.array([-v for v, _ in best], np.float32),
            np.array([i for _, i in best]))


@pytest.mark.parametrize("order", ["random", "ascending", "descending",
                                   "few values"])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_topk_threshold_rule_keeps_the_exact_top_k(order, k):
    """The kernel's early drop (strictly below the k-th best of the
    warp's list so far), its insertion in lane order and the merge of the
    chunks' lists give exactly ``topk_stable``'s k best, ties to the
    lower index included, whatever order the catalog is in."""
    rng = np.random.default_rng(k + len(order))
    N = 1500
    scores = rng.standard_normal(N).astype(np.float32)
    if order == "ascending":
        scores.sort()
    elif order == "descending":
        scores[::-1].sort()
    elif order == "few values":                  # runs of exact ties
        scores = np.round(scores * 2).astype(np.float32)
    scores[rng.random(N) < 0.4] = NEG_INF        # the mask
    for chunk in (128, 384, 2048):
        got_v, got_i = _topk_kernel_model(scores, k, chunk, 32)
        want_v, want_i = RT.topk_stable(torch.from_numpy(scores)[None], k)
        fin = np.isfinite(want_v[0].numpy())
        np.testing.assert_array_equal(got_v, want_v[0].numpy())
        np.testing.assert_array_equal(got_i[fin], want_i[0].numpy()[fin])
        assert (got_i[~fin] == -1).all()


def _split_problem(B, C, Hq, Hkv, hd, kv, seed):
    q, k, v = _attn_problem(B, C, C, Hq, Hkv, hd, seed=seed)
    tt = lambda a: torch.from_numpy(a).transpose(1, 2)
    return (tt(q[:, :1]), tt(k), tt(v),
            torch.tensor(kv, dtype=torch.int32), q[:, :1], k, v)


@pytest.mark.parametrize("C,splits,kv", [
    (63, None, [0, 1, 63, 40]),
    (200, (4, 64), [0, 64, 65, 200]),        # a split boundary, empty tails
    (200, (13, 16), [1, 16, 17, 0]),         # many chunks, all-empty rows
    (536, None, [513, 520, 528, 536])])      # the served shape
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_split_plain_matches_plain_and_reference(C, splits, kv,
                                                        softcap):
    """The decode kernel's arithmetic -- per-chunk partials in the log2
    domain merged in split order -- against the one-pass plain version
    and ``ref.mha_attention`` over each row's live prefix; a row with no
    live key is 0.  Tolerance 2e-5 (f32, a different summation order)."""
    qt, kt, vt, kvt, q, k, v = _split_problem(4, C, 8, 2, 64, kv, seed=C)
    got = FA.decode_split_plain(qt, kt, vt, kvt, splits=splits,
                                softcap=softcap)
    want = FA.flash_attention_plain(qt, kt, vt, kvt, causal=False,
                                    softcap=softcap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(kv):
        if n == 0:
            assert not got[b].any()
            continue
        ref = R.mha_attention(q[b:b + 1], k[b:b + 1, :n], v[b:b + 1, :n],
                              causal=False, softcap=softcap)
        np.testing.assert_allclose(got[b:b + 1].transpose(1, 2).numpy(),
                                   np.asarray(ref), rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------------
# ssd_scan
# ----------------------------------------------------------------------

def _ssd_problem(Bb, L, H, P_, N, seed, dt_scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bb, L, H, P_)).astype(np.float32),
            (rng.random((Bb, L, H)) * dt_scale).astype(np.float32),
            (-np.exp(rng.standard_normal(H))).astype(np.float32),
            rng.standard_normal((Bb, L, N)).astype(np.float32),
            rng.standard_normal((Bb, L, N)).astype(np.float32),
            rng.standard_normal((Bb, H, P_, N)).astype(np.float32))


@pytest.mark.parametrize("Bb,L,H,P_,N,chunk", [
    (1, 32, 2, 16, 8, 16), (2, 75, 3, 32, 16, 16),
    (1, 128, 4, 64, 128, 64), (2, 17, 1, 8, 4, 8),
])
def test_ssd_scan_plain_matches_reference(Bb, L, H, P_, N, chunk):
    args = _ssd_problem(Bb, L, H, P_, N, seed=L + N)
    y, hf = P.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert y.dtype == hf.dtype == torch.float32
    for want in (K.ssd_scan(*args, chunk=chunk), R.ssd_scan(*args)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want[1]),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("Bb,L,H,P_,N,chunk", [
    (1, 40, 2, 128, 256, 16), (2, 33, 1, 72, 136, 8)])
def test_ssd_scan_plain_matches_reference_beyond_one_tile(Bb, L, H, P_, N,
                                                          chunk):
    """P and N past the kernel's 64 x 128 tile (P = 128, N = 256, and
    ragged P = 72, N = 136): the plain version against ``ref.ssd_scan``."""
    args = _ssd_problem(Bb, L, H, P_, N, seed=P_ + N)
    y, hf = P.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    want = R.ssd_scan(*args)
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), np.asarray(want[1]), rtol=3e-4,
                               atol=3e-4)


def test_ssd_scan_plain_state_chaining():
    """Two halves with the state carried == one scan == the reference."""
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) for a in
                           _ssd_problem(1, 64, 2, 16, 8, seed=5,
                                        dt_scale=0.3))
    y_full, h_full = P.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    h, ys = None, []
    for s in (slice(0, 32), slice(32, 64)):
        y, h = P.ssd_scan(x[:, s], dt[:, s], A, Bm[:, s], Cm[:, s], h,
                          chunk=16)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=3e-4,
                               atol=3e-4)
    torch.testing.assert_close(h, h_full, rtol=3e-4, atol=3e-4)
    want = R.ssd_scan(*(a.numpy() for a in (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(want[0]),
                               rtol=3e-4, atol=3e-4)


def test_ssd_scan_plain_takes_strided_bf16_operands():
    """The model's split of its projection: x, B, C as bf16 views of
    one (Bb, L, H*P + 2N) tensor give the f32 scan of their values."""
    Bb, L, H, P_, N = 2, 40, 3, 8, 4
    rng = np.random.default_rng(7)
    xbc = torch.from_numpy(rng.standard_normal(
        (Bb, L, H * P_ + 2 * N)).astype(np.float32)).to(torch.bfloat16)
    dt = torch.from_numpy((rng.random((Bb, L, H)) * 0.5).astype(np.float32))
    A = -torch.exp(torch.from_numpy(rng.standard_normal(H).astype(
        np.float32)))
    x = xbc[..., :H * P_].unflatten(-1, (H, P_))
    Bm, Cm = xbc[..., H * P_:H * P_ + N], xbc[..., H * P_ + N:]
    y, hf = P.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    want = R.ssd_scan(*(a.float().numpy() for a in (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), np.asarray(want[1]), rtol=3e-4,
                               atol=3e-4)


def _ssd_chunk_parallel(x, dt, A, B, C, h0, chunk):
    """The split the CUDA kernel (``csrc/ssd_scan.cu``) follows, in plain
    PyTorch: (1) every chunk's log-decay cumsum and own state at once,
    (2) the state passing over chunks, (3) every chunk's outputs at once
    -- the intra-chunk sum and the inter-chunk term from the state
    entering it."""
    Bb, L, H, P_ = x.shape
    N = B.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    # a ragged last chunk padded with dt = 0 rows: unit decay, no input
    xp, dtp, bp, cp = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                               + (0, pad))
                       for t in (x, dt, B, C))
    xc = xp.reshape(Bb, nc, chunk, H, P_)
    dtc = dtp.reshape(Bb, nc, chunk, H)
    bc, cc = (t.reshape(Bb, nc, chunk, N) for t in (bp, cp))
    la = torch.cumsum(dtc * A, dim=2)                     # (Bb, nc, c, H)
    last = la[:, :, -1]                                   # (Bb, nc, H)
    # (1) own states, all chunks at once
    w = torch.exp(last[:, :, None] - la) * dtc
    own = torch.einsum("bcjn,bcjhp,bcjh->bchpn", bc, xc, w)
    # (2) state passing: the state entering each chunk
    h = torch.zeros((Bb, H, P_, N)) if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(last[:, c])[:, :, None, None] + own[:, c]
    h_in = torch.stack(h_in, dim=1)                       # (Bb, nc, H, P, N)
    # (3) outputs, all chunks at once
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    seg = la[:, :, :, None] - la[:, :, None]              # (Bb, nc, i, j, H)
    dec = torch.where(causal[None, None, :, :, None],
                      torch.exp(torch.where(causal[None, None, :, :, None],
                                            seg, 0.0)), 0.0)
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", g, dec, dtc, xc)
    y = y + torch.exp(la)[..., None] * torch.einsum("bcin,bchpn->bcihp",
                                                    cc, h_in)
    return y.reshape(Bb, nc * chunk, H, P_)[:, :L], h


@pytest.mark.parametrize("Bb,L,H,P_,N,chunk,with_h0", [
    (2, 64, 3, 16, 8, 16, False), (2, 75, 3, 32, 16, 16, True),
    (1, 300, 2, 64, 128, 128, True), (1, 300, 2, 64, 128, 128, False),
    (2, 17, 1, 8, 4, 8, True),
])
def test_ssd_chunk_parallel_split_matches_reference(Bb, L, H, P_, N, chunk,
                                                    with_h0):
    """The kernel's decomposition (chunk states in parallel, state
    passing, chunk outputs in parallel) against the sequential
    ``ref.ssd_scan``: several chunks, ragged L, with and without h0;
    tolerance 3e-4 as for the plain version."""
    args = _ssd_problem(Bb, L, H, P_, N, seed=L + P_)
    if not with_h0:
        args = args[:5] + (None,)
    y, hf = _ssd_chunk_parallel(*(None if a is None else torch.from_numpy(a)
                                  for a in args), chunk)
    want = R.ssd_scan(*args)
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), np.asarray(want[1]), rtol=3e-4,
                               atol=3e-4)


# ----------------------------------------------------------------------
# the CUDA kernels: on the card only
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a; chip_smoke.py checks them on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_router_topk_matches_plain(cuda):
    emb, q, mask = _problem(64, 5000, 8, seed=1, dups=100, empty_rows=2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(q), t(emb), t(mask.astype(np.uint8)),
            torch.arange(64, dtype=torch.int32), 8)
    want = RT.router_topk(*args)
    got = RT.router_topk(*(a.to(cuda) if isinstance(a, torch.Tensor)
                           else a for a in args))
    assert torch.equal(got[0].cpu(), want[0])
    fin = torch.isfinite(want[0])
    assert torch.equal(got[1].cpu()[fin], want[1][fin])


@pytest.mark.cuda
def test_cuda_bandit_update_matches_plain(cuda):
    args = [torch.from_numpy(a) for a in _bandit_problem(32, 16, 3000, 9, 4)]
    x, w, r, xs, theta, ainv = args
    want = BU.bandit_update(w, x, r, xs, theta, ainv, 0.8)
    got = BU.bandit_update(*(a.to(cuda) for a in (w, x, r, xs, theta, ainv)),
                           0.8)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g.cpu(), w_, rtol=1e-5, atol=1e-6)

