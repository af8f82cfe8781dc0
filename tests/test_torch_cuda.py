"""Card-only tests of the port: each CUDA kernel against its plain
version on the same inputs (flash attention's wgmma prefill and split
decode over ragged lengths, GQA groups, window, softcap, kv_valid and
cache capacities; head dims 120 and 288, the decode window anchored at
each row's live count, the ring decode and hymba's group of 5; two
decode launches bit-equal; the scan at hymba's H = 50, N = 16, past one
64 x 128 tile and past 65,535 batches x chunks; the one-launch MoE gate
over T, E and k; both top-k kernels bit-equal over N, D, k, bias,
min_score and catalog order; the staged kNN's filter-row launch against
the dense-mask call; staged routing, LinUCB and Thompson; the sharded
route step bit-equal to the dense one on the card, ties included, and
the IVF route step against its CPU run, probed cells equal; the
frontend models' attention shapes: the non-causal encoder, the
cross-attention with 12-17 keys, G = 1, the cross decode with every key
live), generation on the card against the same seeded model on the
CPU, the two frontend models at full width and 2 layers included, and
training: the three backward kernels against their plain versions
(each gradient within 1e-4 of its max |g| in f32, 2e-2 in bf16; the
gate's 1e-5; the attention backward's body checked through its
per-body launch counts over ragged lengths, qwen3's G = 8, windows
that skip whole tiles, kv_valid, Lk < 64, contiguous and misaligned
layouts) and a train step's loss and gradients against the CPU's.
They
import neither JAX nor the JAX package, so they run on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the decision is taken inside
the ``cuda`` fixture, at run time).  Tolerances as in
``tests/test_torch_kernels.py``: bf16 attention 2e-2, f32 attention
2e-4, the scan 1e-4 of max |y|, top-k values bit-equal, the bandit
rtol 1e-5; the MoE gate: expert indices equal (tie-aware: a row may
differ only where two of its top probabilities are within 1e-6), gate
values within 1e-6, aux within 1e-6 relative and the same bits
on two launches; generation: prefill logits within 1e-3, greedy
tokens equal up to the first step whose top-2 gap on the CPU is below
1e-3.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import bandit_update as BU
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import moe_gating as MG
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import router_topk as RT
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import model as M
from repro_torch.serving.runner import ModelRunner

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a; chip_smoke.py checks them on the card")
    return torch.device("cuda")


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-4)])
@pytest.mark.parametrize("Lq,kw", [
    (96, dict(causal=True)), (96, dict(causal=True, window=9, softcap=30.0)),
    (1, dict(causal=False)), (33, dict(causal=False))])
def test_flash_attention_matches_plain(cuda, dtype, tol, Lq, kw):
    rng = np.random.default_rng(Lq)
    dt = getattr(torch, dtype)
    q = _rand(rng, 3, Lq, 8, 64).to(dt).transpose(1, 2)
    k = _rand(rng, 3, 96, 2, 64).to(dt).transpose(1, 2)
    v = _rand(rng, 3, 96, 2, 64).to(dt).transpose(1, 2)
    kv = torch.tensor([0, 40, 96], dtype=torch.int32)
    want = FA.flash_attention_plain(q, k, v, kv, **kw)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             kv.to(cuda), **kw)
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == dt and not got.cpu()[0].any()
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("Lq", [64, 1])
def test_flash_attention_gqa_group_8_matches_plain(cuda, Lq):
    """qwen3-moe-30b-a3b's grouping: 32 query heads over 4 KV heads, so
    a decode block serves the most query heads it can (8)."""
    rng = np.random.default_rng(8)
    bf = torch.bfloat16
    q = _rand(rng, 2, Lq, 32, 64).to(bf).transpose(1, 2)
    k = _rand(rng, 2, 80, 4, 64).to(bf).transpose(1, 2)
    v = _rand(rng, 2, 80, 4, 64).to(bf).transpose(1, 2)
    kv = torch.tensor([33, 80], dtype=torch.int32)
    kw = dict(causal=Lq > 1)
    want = FA.flash_attention_plain(q, k, v, kv, **kw)
    got = FA.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             kv.to(cuda), **kw)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _attn_case(cuda, rng, B, Lq, Lk, Hq, Hkv, hd, kv, dt, tol, *,
               contiguous=False, **kw):
    """The kernel on the card against the plain version on the CPU,
    |err| <= tol * (1 + |want|); returns the card's output."""
    if contiguous:                                 # (B, H, L, hd) as is
        q = _rand(rng, B, Hq, Lq, hd).to(dt)
        k = _rand(rng, B, Hkv, Lk, hd).to(dt)
        v = _rand(rng, B, Hkv, Lk, hd).to(dt)
    else:                                          # the layer's layout
        q = _rand(rng, B, Lq, Hq, hd).to(dt).transpose(1, 2)
        k = _rand(rng, B, Lk, Hkv, hd).to(dt).transpose(1, 2)
        v = _rand(rng, B, Lk, Hkv, hd).to(dt).transpose(1, 2)
    kvt = None if kv is None else torch.tensor(kv, dtype=torch.int32)
    want = FA.flash_attention_plain(q, k, v, kvt, **kw)
    got = FA.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             None if kvt is None else kvt.to(cuda), **kw)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    return got


@pytest.mark.parametrize("L,Lk,Hq,Hkv,hd,kv,contiguous,kw", [
    (100, 100, 4, 2, 64, None, False, dict(causal=True)),
    (200, 200, 8, 8, 64, None, False, dict(causal=True)),        # G 1
    (513, 513, 8, 1, 64, None, False, dict(causal=True)),        # G 8
    (70, 130, 8, 2, 64, None, False, dict(causal=True)),         # Lq != Lk
    (200, 200, 8, 2, 64, None, False,
     dict(causal=True, window=37, softcap=30.0)),
    (200, 200, 4, 2, 128, None, False, dict(causal=True)),       # hd 128
    (96, 96, 10, 2, 128, None, False, dict(causal=True)),        # G 5
    (150, 150, 8, 2, 64, [0, 77], False, dict(causal=True)),     # kv_valid
    (200, 200, 8, 2, 64, None, True, dict(causal=True)),         # contiguous
    (90, 90, 4, 1, 64, [90, 33], True, dict(causal=False)),
])
def test_flash_attention_bf16_prefill_matches_plain(cuda, L, Lk, Hq, Hkv,
                                                    hd, kv, contiguous, kw):
    """The wgmma/TMA prefill (bf16, hd 64/128, 16-byte strides) at
    ragged lengths, GQA groups 1-8, window and softcap, kv_valid with a
    row that sees no key, in the layer's strided layout and as
    contiguous (B, H, L, hd) operands.  Tolerance 2e-2 (bf16)."""
    rng = np.random.default_rng(L + Hq + hd)
    got = _attn_case(cuda, rng, 2, L, Lk, Hq, Hkv, hd, kv, torch.bfloat16,
                     2e-2, contiguous=contiguous, **kw)
    if kv is not None and kv[0] == 0:
        assert not got.cpu()[0].any()


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-4)])
@pytest.mark.parametrize("Lq,Lk,Hq,Hkv,hd,kw", [
    (16, 16, 16, 16, 64, dict(causal=False)),          # seamless encoder
    (100, 16, 16, 16, 64, dict(causal=False)),         # cross, Lk < a tile
    (100, 12, 16, 16, 64, dict(causal=False)),
    (100, 17, 16, 16, 64, dict(causal=False)),
    (130, 130, 16, 16, 64, dict(causal=True)),         # G 1 self-attention
    (1, 16, 16, 16, 64, dict(causal=False)),           # cross decode
    (1, 12, 16, 16, 64, dict(causal=False)),
    (1, 17, 16, 16, 64, dict(causal=False)),
    (300, 300, 32, 8, 128, dict(causal=True)),         # llava's prefill
    (1, 300, 32, 8, 128, dict(causal=False)),          # and its decode
])
def test_flash_attention_frontend_shapes_match_plain(cuda, dtype, tol, Lq, Lk,
                                                     Hq, Hkv, hd, kw):
    """The shapes the frontend models add: the encoder's non-causal
    square attention, the cross-attention with Lq != Lk and Lk of 12, 16
    and 17 (inside one key tile, with odd lengths), the G = 1 prefill,
    the cross decode over a cache with every key live (``kv_valid``
    None), and llava's hd-128 groups of 4."""
    rng = np.random.default_rng(Lq * 7 + Lk + hd)
    _attn_case(cuda, rng, 3, Lq, Lk, Hq, Hkv, hd, None, getattr(torch, dtype),
               tol, **kw)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-4)])
@pytest.mark.parametrize("cap", [1, 63, 536, 4100])
@pytest.mark.parametrize("Hq", [8, 32, 64])
def test_flash_attention_split_decode_matches_plain(cuda, dtype, tol, cap,
                                                    Hq):
    """The split decode over caches of 1, 63, 536 and 4,100 slots with
    kv_valid 0, 1, the first split boundary and the full capacity; GQA
    groups 4, 16 (the tensor-core body's largest) and 32 (the CUDA-core
    body's).  Tolerances 2e-2 (bf16) and 2e-4 (f32)."""
    _, chunk = FA.decode_splits(4, 2, cap)
    kv = [0, 1, min(chunk, cap), cap]
    rng = np.random.default_rng(cap + Hq)
    got = _attn_case(cuda, rng, 4, 1, cap, Hq, 2, 64, kv,
                     getattr(torch, dtype), tol, causal=False)
    assert not got.cpu()[0].any()


@pytest.mark.parametrize("Hkv", [8, 4])
def test_flash_attention_decode_is_bit_stable(cuda, Hkv):
    """The splits merge in a fixed order with no atomics: two launches on
    the served shape give the same bits."""
    rng = np.random.default_rng(Hkv)
    bf = torch.bfloat16
    q = _rand(rng, 16, 1, 32, 64).to(bf).transpose(1, 2).to(cuda)
    k = _rand(rng, 16, 536, Hkv, 64).to(bf).transpose(1, 2).to(cuda)
    v = _rand(rng, 16, 536, Hkv, 64).to(bf).transpose(1, 2).to(cuda)
    kv = torch.arange(513, 529, dtype=torch.int32, device=cuda)
    a = FA.flash_attention(q, k, v, kv, causal=False)
    b = FA.flash_attention(q, k, v, kv, causal=False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("hd", [120, 288])
@pytest.mark.parametrize("Lq,Lk,Hq,Hkv,kv,contiguous,kw", [
    (200, 200, 8, 2, None, False, dict(causal=True)),
    (200, 200, 8, 2, [0, 150], False, dict(causal=True, window=37)),
    (130, 130, 4, 2, None, False, dict(causal=True, window=50,
                                       softcap=50.0)),
    (70, 130, 10, 2, None, False, dict(causal=True, softcap=30.0)),  # G 5
    (150, 150, 4, 4, None, True, dict(causal=True)),                 # G 1
    (1, 300, 8, 2, [0, 211], False, dict(causal=False)),
    (1, 300, 8, 2, [1, 300], False, dict(causal=False, softcap=50.0)),
    (1, 536, 32, 8, [513, 528], False, dict(causal=False)),
])
def test_flash_attention_head_dims_120_288_match_plain(cuda, dtype, tol, hd,
                                                       Lq, Lk, Hq, Hkv, kv,
                                                       contiguous, kw):
    """h2o-danube-3-4b's head dim 120 (the 128 instantiations, zero
    columns past 120: the wgmma prefill in bf16) and gemma2-2b's 288
    (its own: the CUDA-core prefill and split decode), prefill and
    decode, causal and windowed, with and without softcap, in the
    layer's strided layout and as contiguous operands.  Tolerances
    2e-2 (bf16) and 1e-5 (f32) of (1 + |want|)."""
    rng = np.random.default_rng(hd + Lq + Hq)
    got = _attn_case(cuda, rng, 2, Lq, Lk, Hq, Hkv, hd, kv,
                     getattr(torch, dtype), tol, contiguous=contiguous, **kw)
    assert got.shape[-1] == hd
    if kv is not None and kv[0] == 0:
        assert not got.cpu()[0].any()


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("hd,Hq,Hkv", [(64, 8, 4), (64, 25, 5), (120, 32, 8),
                                       (288, 8, 4), (64, 40, 2)])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_flash_attention_local_window_decode_matches_plain(cuda, dtype, tol,
                                                           hd, Hq, Hkv,
                                                           softcap):
    """The decode window anchored at each row's live count (kv_valid[b]
    - W <= ik < kv_valid[b]) at ragged live counts over 4,100 slots:
    whole chunks below the window write empty partials.  GQA groups 2,
    4, 5 and 20 (the CUDA-core decode), hd 64, 120, 288; two launches
    give the same bits."""
    rng = np.random.default_rng(hd + Hq)
    kv = [1, 299, 300, 2000, 4100]
    got = _attn_case(cuda, rng, 5, 1, 4100, Hq, Hkv, hd, kv,
                     getattr(torch, dtype), tol, causal=False,
                     local_window=300, softcap=softcap)
    q, k, v = (_rand(rng, 5, n, h, hd).to(getattr(torch, dtype))
               .transpose(1, 2).to(cuda)
               for n, h in ((1, Hq), (4100, Hkv), (4100, Hkv)))
    kvt = torch.tensor(kv, dtype=torch.int32, device=cuda)
    a = FA.flash_attention(q, k, v, kvt, causal=False, local_window=300)
    b = FA.flash_attention(q, k, v, kvt, causal=False, local_window=300)
    assert torch.equal(a, b) and got.shape[-1] == hd
    with pytest.raises(ValueError, match="local_window"):
        FA.flash_attention(q.expand(5, Hq, 2, hd), k, v, local_window=300)


@pytest.mark.parametrize("hd,Hq,Hkv,C", [(64, 25, 5, 1024),
                                         (120, 32, 8, 4096)])
def test_flash_decode_ring_matches_cpu(cuda, hd, Hq, Hkv, C):
    """``ops.flash_decode`` over a ring at hymba-1.5b's (hd 64, group 5,
    1,024 slots) and h2o-danube-3-4b's (hd 120, group 4, 4,096) ring:
    rows before and after the ring fills, bf16, against the CPU."""
    rng = np.random.default_rng(C)
    bf = torch.bfloat16
    q = _rand(rng, 4, 1, Hq, hd).to(bf)
    kc = _rand(rng, 4, C, Hkv, hd).to(bf)
    vc = _rand(rng, 4, C, Hkv, hd).to(bf)
    pos = torch.tensor([0, C // 3, C - 1, 3 * C + 7])
    want = OPS.flash_decode(q, kc, vc, pos)
    got = OPS.flash_decode(q.to(cuda), kc.to(cuda), vc.to(cuda),
                           pos.to(cuda))
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _assert_same_experts(got, want, logits, n_exact=0):
    """Equal expert indices in the first ``n_exact`` rows (exact ties,
    bit-equal in both softmaxes); elsewhere a position may differ only
    where the plain version's probabilities of the two experts there are
    within 1e-6: the kernel's softmax may order those either way."""
    got, want = got.long(), want.long()
    diff = got != want
    assert not bool(diff[:n_exact].any()), "experts differ at an exact tie"
    if diff.any():
        p = torch.softmax(logits.float(), dim=-1)
        gap = (p.gather(1, got) - p.gather(1, want)).abs()
        assert bool((gap[diff] < 1e-6).all()), "experts differ without a tie"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,E,k", [(300, 4, 2), (77, 60, 4), (1000, 128, 8),
                                   (16, 128, 1)])
def test_moe_gating_matches_plain(cuda, dtype, T, E, k):
    rng = np.random.default_rng(E + k)
    lg = _rand(rng, T, E)
    lg[0] = 0.0                                   # every expert ties
    lg[1, E // 2:] = lg[1, :E - E // 2]           # each value twice
    lg = lg.to(getattr(torch, dtype))
    want = MG.moe_gating_plain(lg, k)
    before = MG.moe_gating.launches
    got = MG.moe_gating(lg.to(cuda), k)
    again = MG.moe_gating(lg.to(cuda), k)
    assert MG.moe_gating.launches == before + 2
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    _assert_same_experts(got[1].cpu(), want[1], lg, n_exact=2)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-6, atol=0)
    assert torch.equal(got[2], again[2])          # aux: the same bits
    assert torch.equal(got[1][0].cpu(), torch.arange(k, dtype=torch.int32))


def test_moe_gating_takes_strided_rows(cuda):
    rng = np.random.default_rng(3)
    wide = _rand(rng, 50, 96).to(cuda)
    lg = wide[:, 16:80]                            # row stride 96, E = 64
    got = MG.moe_gating(lg, 4)
    want = MG.moe_gating_plain(lg.cpu(), 4)
    _assert_same_experts(got[1].cpu(), want[1], lg.cpu())
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_plain(cuda, dtype):
    rng = np.random.default_rng(4)
    Bb, L, H, P, N = 2, 75, 3, 32, 16
    x = _rand(rng, Bb, L, H, P).to(getattr(torch, dtype))
    dt = torch.from_numpy((rng.random((Bb, L, H)) * 0.5).astype(np.float32))
    A = -torch.exp(_rand(rng, H))
    Bm = _rand(rng, Bb, L, N).to(x.dtype)
    Cm = _rand(rng, Bb, L, N).to(x.dtype)
    h0 = _rand(rng, Bb, H, P, N)
    want = SS.ssd_scan_plain(x, dt, A, Bm, Cm, h0, chunk=16)
    got = SS.ssd_scan(*(a.to(cuda) for a in (x, dt, A, Bm, Cm, h0)),
                      chunk=16)
    for g, w in zip(got, want):
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=tol)


def test_router_topk_and_bandit_update_match_plain(cuda):
    rng = np.random.default_rng(1)
    q, e = _rand(rng, 32, 8), _rand(rng, 3000, 8)
    table = torch.from_numpy((rng.random((4, 3000)) < 0.5).astype(np.uint8))
    rows = torch.from_numpy(rng.integers(0, 4, 32).astype(np.int32))
    want = RT.router_topk(q, e, table, rows, 8)
    got = RT.router_topk(q.to(cuda), e.to(cuda), table.to(cuda),
                         rows.to(cuda), 8)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    w = torch.zeros(16, 500)
    w[torch.arange(16), torch.from_numpy(rng.integers(0, 500, 16))] = 1.0
    gen = torch.Generator().manual_seed(3)
    x, r, xs = (torch.rand(*s, generator=gen)
                for s in ((16, 9), (16,), (4, 9)))
    theta = _rand(rng, 500, 9) * 0.1
    L = _rand(rng, 500, 9, 9) * 0.05
    ainv = L @ L.transpose(1, 2) + 0.5 * torch.eye(9)
    want = BU.bandit_update(w, x, r, xs, theta, ainv, 0.8)
    got = BU.bandit_update(*(a.to(cuda) for a in (w, x, r, xs, theta, ainv)),
                           0.8)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g.cpu(), w_, rtol=1e-5, atol=1e-6)


def _bandit_inputs(rng, Bu, Bs, N, D):
    """A one-hot mask made denser: row 0 has two non-zeros, weights are
    not all 1, row 1 and column 0 are all zero (where N allows)."""
    w = np.zeros((Bu, N), np.float32)
    if Bu:
        lo = 1 if N > 1 else 0
        w[np.arange(Bu), rng.integers(lo, N, Bu)] = rng.uniform(
            0.5, 2.0, Bu).astype(np.float32)
        w[0, N - 1] += 1.5
        if Bu > 1:
            w[1] = 0.0
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    x, r, xs = (torch.rand(*s, generator=gen)
                for s in ((Bu, D), (Bu,), (Bs, D)))
    theta = _rand(rng, N, D) * 0.1
    L = _rand(rng, N, D, D) * 0.05
    ainv = L @ L.transpose(1, 2) + 0.5 * torch.eye(D)
    return torch.from_numpy(w), x, r, xs, theta, ainv


def _assert_bandit_close(got, want):
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        torch.testing.assert_close(g.cpu(), w_, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("D", [1, 9, 12])
@pytest.mark.parametrize("N", [1, 3000, 100_003])
def test_bandit_update_kernel_matches_plain(cuda, N, D):
    """Both halves at N not a multiple of any tile, two mask passes
    (Bu = 300 > 256 rows), a mask that is not one-hot; two launches
    give the same bits."""
    rng = np.random.default_rng(N + D)
    args = _bandit_inputs(rng, 300, 70, N, D)
    want = BU.bandit_update(*args, 0.8)
    dev = [a.to(cuda) for a in args]
    got = BU.bandit_update(*dev, 0.8)
    _assert_bandit_close(got, want)
    again = BU.bandit_update(*dev, 0.8)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_bandit_update_kernel_unaligned_mask_and_empty_batches(cuda):
    """A mask whose rows do not start on 16 bytes (the scalar-load
    body), Bu = 0 (zero deltas), and Bs = 0 with no posterior (the
    serving path's launch)."""
    rng = np.random.default_rng(9)
    w, x, r, xs, theta, ainv = _bandit_inputs(rng, 40, 16, 3000, 9)
    want = BU.bandit_update(w, x, r, xs, theta, ainv, 0.8)
    flat = torch.empty(w.numel() + 1, device=cuda)
    wu = flat[1:].view(w.shape)
    wu.copy_(w)
    assert wu.is_contiguous() and wu.data_ptr() % 16
    dev = [a.to(cuda) for a in (x, r, xs, theta, ainv)]
    _assert_bandit_close(BU.bandit_update(wu, *dev, 0.8), want)
    got = BU.bandit_update(w[:0].to(cuda), dev[0][:0], dev[1][:0], *dev[2:],
                           0.8)
    assert not got[0].any() and not got[1].any()
    _assert_bandit_close(got, BU.bandit_update(w[:0], x[:0], r[:0], xs,
                                               theta, ainv, 0.8))
    got = BU.bandit_update(w.to(cuda), dev[0], dev[1], dev[2][:0], None,
                           None, 0.8)
    assert got[2].shape == (0, 3000)
    _assert_bandit_close(got[:2], want[:2])


def _ssd_inputs(rng, Bb, L, H, P, N, mode):
    """f32 operands with an h0, or bf16 x / B / C as strided views of
    one (Bb, L, H*P + 2N) tensor with no h0 (the model's split)."""
    dt = torch.from_numpy((rng.random((Bb, L, H)) * 0.5).astype(np.float32))
    A = -torch.linspace(1.0, 16.0, H)
    if mode == "f32_h0":
        return (_rand(rng, Bb, L, H, P), dt, A, _rand(rng, Bb, L, N),
                _rand(rng, Bb, L, N), _rand(rng, Bb, H, P, N))
    xbc = _rand(rng, Bb, L, H * P + 2 * N).to(torch.bfloat16)
    return (xbc[..., :H * P].unflatten(-1, (H, P)), dt, A,
            xbc[..., H * P:H * P + N], xbc[..., H * P + N:], None)


def _to(args, dev):
    return [None if a is None else a.to(dev) for a in args]


def _assert_scan_close(got, want):
    for g, w in zip(got, want):
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["f32_h0", "bf16_views"])
@pytest.mark.parametrize("L", [512, 300])
def test_ssd_scan_kernel_at_the_served_tiles(cuda, L, mode):
    """P = 64, N = 128, chunk 256 (the mamba2-1.3b tiles) at two chunks
    and at a ragged L; two launches give the same bits."""
    args = _ssd_inputs(np.random.default_rng(L), 2, L, 3, 64, 128, mode)
    want = SS.ssd_scan_plain(*args, chunk=256)
    dev = _to(args, cuda)
    if mode == "bf16_views":          # views of one tensor on the card too
        xbc = torch.cat([args[0].flatten(-2), args[3], args[4]], -1).to(cuda)
        dev[0] = xbc[..., :3 * 64].unflatten(-1, (3, 64))
        dev[3], dev[4] = xbc[..., 192:320], xbc[..., 320:]
        assert not dev[0].is_contiguous()
    got = SS.ssd_scan(*dev, chunk=256)
    _assert_scan_close(got, want)
    again = SS.ssd_scan(*dev, chunk=256)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("mode", ["f32_h0", "bf16_views"])
@pytest.mark.parametrize("L", [512, 300])
def test_ssd_scan_kernel_at_hymba_shape(cuda, L, mode):
    """hymba-1.5b's branch: H = 50 heads of P = 64, N = 16, chunk 256
    (bf16 strided views with N a multiple of 8 go in as they are), and
    in f32 with an h0; two launches give the same bits."""
    args = _ssd_inputs(np.random.default_rng(L + 50), 2, L, 50, 64, 16,
                       mode)
    want = SS.ssd_scan_plain(*args, chunk=256)
    dev = _to(args, cuda)
    if mode == "bf16_views":
        xbc = torch.cat([args[0].flatten(-2), args[3], args[4]], -1).to(cuda)
        dev[0] = xbc[..., :50 * 64].unflatten(-1, (50, 64))
        dev[3], dev[4] = xbc[..., 3200:3216], xbc[..., 3216:]
    got = SS.ssd_scan(*dev, chunk=256)
    _assert_scan_close(got, want)
    again = SS.ssd_scan(*dev, chunk=256)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_ssd_scan_kernel_chained_halves_equal_one_call(cuda):
    """L = 300 split in two calls, the state carried, equals one call."""
    args = _to(_ssd_inputs(np.random.default_rng(3), 2, 300, 3, 64, 128,
                           "bf16_views"), cuda)
    x, dt, A, Bm, Cm, _ = args
    y, h = SS.ssd_scan(*args, chunk=256)
    ya, ha = SS.ssd_scan(x[:, :137], dt[:, :137], A, Bm[:, :137],
                         Cm[:, :137], None, chunk=256)
    yb, hb = SS.ssd_scan(x[:, 137:], dt[:, 137:], A, Bm[:, 137:],
                         Cm[:, 137:], ha, chunk=256)
    _assert_scan_close((torch.cat([ya, yb], 1), hb), (y.cpu(), h.cpu()))
    _assert_scan_close((y, h), SS.ssd_scan_plain(*_to(args, "cpu"),
                                                 chunk=256))


@pytest.mark.parametrize("P,N,L,chunk", [(8, 4, 17, 8), (24, 12, 50, 16),
                                         (10, 6, 33, 16), (64, 16, 70, 64),
                                         (64, 128, 250, 100)])
def test_ssd_scan_kernel_pads_narrow_tiles(cuda, P, N, L, chunk):
    """P and N below (and not multiples of) the 64 x 128 tiles, some not
    multiples of 8 (staged through the bf16 planes), and a chunk that is
    not a multiple of the 64-key tiles; f32 and bf16."""
    for mode in ("f32_h0", "bf16_views"):
        args = _ssd_inputs(np.random.default_rng(P + N), 2, L, 2, P, N, mode)
        _assert_scan_close(SS.ssd_scan(*_to(args, cuda), chunk=chunk),
                           SS.ssd_scan_plain(*args, chunk=chunk))


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16_views"])
def test_ssd_scan_kernel_beyond_one_tile(cuda, mode, h0):
    """P = 128 and N = 256: two P tiles on the grid, two N tiles summed
    inside C B^T and C . h and splitting the state; a ragged last chunk;
    f32 and bf16 (strided views), with and without h0."""
    rng = np.random.default_rng(128 + h0)
    Bb, L, H, P, N = 2, 300, 2, 128, 256
    args = list(_ssd_inputs(rng, Bb, L, H, P, N,
                            "f32_h0" if mode == "f32" else "bf16_views"))
    args[5] = _rand(rng, Bb, H, P, N) if h0 else None
    want = SS.ssd_scan_plain(*args, chunk=128)
    got = SS.ssd_scan(*_to(args, cuda), chunk=128)
    _assert_scan_close(got, want)


@pytest.mark.parametrize("Bb,L,chunk", [(2100, 32, 1), (66_000, 2, 2)])
@pytest.mark.parametrize("mode", ["f32_h0", "bf16_views"])
def test_ssd_scan_kernel_past_the_grid_axis_limit(cuda, Bb, L, chunk, mode):
    """Bb x chunks = 67,200 and 66,000 (above the 65,535 of a grid's y
    and z axes; the second with Bb itself above it), at small H, P, N."""
    args = _ssd_inputs(np.random.default_rng(Bb), Bb, L, 1, 8, 8, mode)
    _assert_scan_close(SS.ssd_scan(*_to(args, cuda), chunk=chunk),
                       SS.ssd_scan_plain(*args, chunk=chunk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(E, k) for E in (4, 60, 128, 1024)
                                 for k in (1, 8, 16) if k <= E])
@pytest.mark.parametrize("T", [1, 16, 8192])
def test_moe_gating_one_launch_matches_plain(cuda, T, E, k, dtype):
    """The one-launch gate (aux formed by the block at T <= its tokens,
    else by the last block over the partials) at the decode and prefill
    token counts: experts tie-aware, vals within 1e-6, aux within 1e-6
    relative and the same bits on two launches; rows of exact ties take
    experts 0..k-1."""
    rng = np.random.default_rng(T + E + k)
    lg = _rand(rng, T, E)
    lg[0] = 0.0                                   # every expert ties
    if T > 1:
        lg[1, E // 2:] = lg[1, :E - E // 2]       # each value twice
    lg = lg.to(getattr(torch, dtype))
    want = MG.moe_gating_plain(lg, k)
    dev = lg.to(cuda)
    before = MG.moe_gating.launches
    got = MG.moe_gating(dev, k)
    again = MG.moe_gating(dev, k)
    assert MG.moe_gating.launches == before + 2
    _assert_same_experts(got[1].cpu(), want[1], lg, n_exact=min(T, 2))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-6, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1][0].cpu(), torch.arange(k, dtype=torch.int32))


def _topk_case(rng, N, D, order):
    """37 queries over N unit rows (a quarter of them duplicates of the
    first rows, exact ties), a filter table whose row 0 is empty (queries
    1 and 2 read it), the catalog sorted by query 0's score when
    ``order`` says so."""
    e = rng.standard_normal((N, D)).astype(np.float32)
    nd = N // 4
    e[N - nd:] = e[:nd]
    e /= np.linalg.norm(e, axis=1, keepdims=True) + 1e-9
    q = rng.standard_normal((37, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
    if order != "random":
        s0 = e @ q[0]
        e = e[np.argsort(-s0 if order == "descending" else s0,
                         kind="stable")]
    table = (rng.random((5, N)) < 0.6).astype(np.uint8)
    table[0] = 0
    rows = rng.integers(1, 5, 37).astype(np.int32)
    rows[1:3] = 0
    return [torch.from_numpy(a) for a in (q, e, table, rows)]


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("D", [1, 8, 40, 64])
@pytest.mark.parametrize("N", [1, 127, 4000, 100_003])
def test_router_topk_kernels_bit_equal_to_plain(cuda, N, D, k):
    """fp32 and int8 against their plain versions, bit for bit, with and
    without bias and min_score, in a random, a descending and an
    ascending catalog order; all-masked queries come back (-inf, -1)."""
    from repro_torch.kernels.route_step import quantize_rows

    rng = np.random.default_rng(N + D + k)
    for order in ("random", "descending", "ascending"):
        q, e, table, rows = _topk_case(rng, N, D, order)
        q8, qs = quantize_rows(q)
        e8, es = quantize_rows(e)
        q8, e8 = q8.contiguous(), e8.contiguous()
        qs, es = qs[:, 0].contiguous(), es[:, 0].contiguous()
        bias = torch.from_numpy(
            (rng.standard_normal(N) * 0.01).astype(np.float32))
        for kw in ({}, {"bias": bias, "min_score": 0.1}):
            for fn, plain, args in (
                    (RT.router_topk, RT.router_topk_plain,
                     (q, e, table, rows)),
                    (RT.router_topk_q8, RT.router_topk_q8_plain,
                     (q8, e8, qs, es, table, rows))):
                want = plain(*args, k, **kw)
                got = fn(*(a.to(cuda) for a in args), k,
                         **{n: (v.to(cuda) if torch.is_tensor(v) else v)
                            for n, v in kw.items()})
                fin = torch.isfinite(want[0])
                assert torch.equal(got[0].cpu(), want[0]), (order, kw)
                assert torch.equal(got[1].cpu()[fin], want[1][fin])
                assert (got[1].cpu()[~fin] == -1).all()
                assert not fin[1:3].any()


@pytest.mark.parametrize("B,N,k", [(1, 200, 8), (256, 100_000, 8),
                                   (37, 4099, 16)])
def test_staged_knn_rows_on_card_match_dense_mask_and_cpu(cuda, B, N, k):
    """The staged path's kNN (one launch reading each query's filter
    row) against the dense (B, N) mask call on the card and against
    its CPU run, values bit for bit, indices where finite."""
    rng = np.random.default_rng(B + N)
    emb = rng.random((N, 8)).astype(np.float32)
    tt = np.vstack([rng.random((11, N)) < 0.1, np.ones((1, N), bool)])
    dm = np.vstack([rng.random((6, N)) < 0.2, np.ones((1, N), bool)])
    tt[:2] = False
    gmask = rng.random(N) < 0.05
    T = rng.random((B, 8)).astype(np.float32)
    ti, di = rng.integers(0, 12, B), rng.integers(0, 7, B)
    got = OPS.knn_rows(emb, tt, dm, gmask, T, ti, di, k=k, device=cuda)
    cpu = OPS.knn_rows(emb, tt, dm, gmask, T, ti, di, k=k, device="cpu")
    dense = [x.cpu().numpy() for x in OPS.router_topk(
        emb, T, k, mask=tt[ti] & dm[di], device=cuda)]
    fin = np.isfinite(cpu[0])
    for want in (cpu, dense):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1][fin], want[1][fin])


@pytest.mark.parametrize("policy", ["linucb", "thompson"])
def test_staged_routing_on_card_matches_cpu(cuda, policy):
    """``route_many_staged`` on the card and on the CPU over one seeded
    catalog and bandit (Thompson: the same draws), decisions equal up to
    a tie within 1e-5."""
    from repro_torch.adaptive import LinearBandit
    from repro_torch.core.mres import MRES, ModelEntry
    from repro_torch.core.preferences import (DOMAINS, METRICS, TASK_TYPES,
                                              TaskSignature)
    from repro_torch.core.routing import RoutingEngine

    rng = np.random.default_rng(3)
    n = 5000
    entries = [ModelEntry(
        name=f"m{i}", raw_metrics={m: float(rng.random()) for m in (
            "accuracy", "helpfulness", "harmlessness", "honesty",
            "steerability", "creativity")} | {
            "latency_ms": float(rng.random() * 500 + 1),
            "cost_per_mtok": float(rng.random() * 20 + 0.1)},
        task_types=tuple(rng.choice(TASK_TYPES, 2, replace=False)),
        domains=(str(rng.choice(DOMAINS)),),
        generalist=bool(rng.random() < 0.05)) for i in range(n)]
    mres = MRES()
    mres.register_many(entries)
    sigs = [TaskSignature(task_type=str(rng.choice(TASK_TYPES)),
                          domain=str(rng.choice(DOMAINS)),
                          complexity=float(rng.random()),
                          confidence=float(rng.random()))
            for _ in range(64)]
    X = rng.random((64, len(METRICS))).astype(np.float32)
    ch, r = rng.integers(0, n, 64), rng.random(64).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        bandit = LinearBandit(n, policy=policy, seed=5, device=dev)
        bandit.update(X, ch, r)
        eng = RoutingEngine(mres, adaptive=bandit, adaptive_weight=1.0,
                            fused=False, device=dev)
        out.append(eng.route_many("balanced", sigs))
    for a, b in zip(out[1], out[0]):
        assert a.fallback_kind == b.fallback_kind
        assert abs(a.score - b.score) <= 1e-5
        c = a.candidates
        assert a.model == b.model or c[0][1] - c[1][1] <= 1e-5


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b"])
def test_generate_on_card_matches_cpu(cuda, name):
    cfg = get_smoke(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = ModelRunner(cfg, params=params, device="cpu").generate(
        toks, 5, keep_logits=True)
    got = ModelRunner(cfg, params=params, device=cuda).generate(toks, 5)
    np.testing.assert_allclose(got.logits_last, want.logits_last, rtol=1e-3,
                               atol=1e-3)
    for b in range(toks.shape[0]):
        for s in range(5):
            top2 = np.sort(want.step_logits[b, s])[-2:]
            if top2[1] - top2[0] < 1e-3:
                break
            assert got.tokens[b, s] == want.tokens[b, s], (b, s)


@pytest.mark.parametrize("name", ["hymba-1.5b", "h2o-danube-3-4b",
                                  "gemma2-2b"])
def test_generate_on_card_matches_cpu_past_the_window(cuda, name):
    """The windowed models at ``SMOKE`` (window 64) with a prompt of 100:
    the rings wrap and gemma2's local layers mask, on both devices."""
    cfg = get_smoke(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)
    want = ModelRunner(cfg, params=params, device="cpu").generate(
        toks, 5, keep_logits=True)
    got = ModelRunner(cfg, params=params, device=cuda).generate(toks, 5)
    np.testing.assert_allclose(got.logits_last, want.logits_last, rtol=1e-3,
                               atol=1e-3)
    for b in range(toks.shape[0]):
        for s in range(5):
            top2 = np.sort(want.step_logits[b, s])[-2:]
            if top2[1] - top2[0] < 1e-3:
                break
            assert got.tokens[b, s] == want.tokens[b, s], (b, s)


@pytest.mark.parametrize("name", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_generate_frontends_on_card_matches_cpu(cuda, name):
    """Both frontend models at full width and 2 layers (seamless also 2
    encoder layers), f32, fed seeded standard-normal frontend embeddings
    (zeros would leave seamless's cross term 0); llava's frontend cut to
    64 tokens (``dataclasses.replace``, widths unchanged), its decode
    past the cache as the runner sizes it."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(name), n_layers=2,
                              compute_dtype="float32")
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, n_enc_layers=2)
        shape = (2, 16, cfg.frontend_dim)
    else:
        cfg = dataclasses.replace(cfg, frontend_tokens=64)
        shape = (2, 64, cfg.frontend_dim)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    emb = rng.standard_normal(shape).astype(np.float32)
    want = ModelRunner(cfg, params=params, device="cpu").generate(
        toks, 5, keep_logits=True, embeds=emb)
    got = ModelRunner(cfg, params=params, device=cuda).generate(
        toks, 5, embeds=emb)
    tol = 1e-3 * float(np.abs(want.logits_last).max())
    np.testing.assert_allclose(got.logits_last, want.logits_last, rtol=0,
                               atol=tol)
    for b in range(toks.shape[0]):
        for s in range(5):
            top2 = np.sort(want.step_logits[b, s])[-2:]
            if top2[1] - top2[0] < tol:
                break
            assert got.tokens[b, s] == want.tokens[b, s], (b, s)


@pytest.mark.parametrize("name", ["llama3.2-1b", "gemma2-2b", "hymba-1.5b"])
def test_decode_past_cache_on_card_matches_cpu(cuda, name):
    """A decode step at pos = C and C + 1 (prompt 6, C = 8): the card's
    logits within 1e-3 of the CPU's, a full cache left unchanged (the
    masked write), a ring written at pos % C as on the CPU, and no
    device-side assert (``torch.cuda.synchronize`` after the step)."""
    cfg = get_smoke(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 6)))
    ring = bool(cfg.sliding_window) and not cfg.local_global_pattern
    out = {}
    for dev in ("cpu", cuda):
        p = M.tree_map(lambda x: x.to(dev), params)
        _, cache, _ = M.prefill(p, cfg, {"tokens": toks.to(dev)}, max_len=8)
        before = {k: v.clone() for k, v in cache.items()}
        logits, after = M.decode_step(
            p, cfg, cache, {"token": torch.tensor([[3], [7]], device=dev),
                            "pos": torch.tensor([8, 9], device=dev)})
        if dev != "cpu":
            torch.cuda.synchronize()
        if not ring:
            for key in ("k", "v"):
                assert torch.equal(after[key], before[key]), key
        out[str(dev)] = (logits.cpu(), {k: v.cpu() for k, v in after.items()})
    (want, wc), (got, gc) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    for key in wc:
        torch.testing.assert_close(gc[key], wc[key], rtol=1e-4, atol=1e-4)


def test_default_device_routes_with_an_analyzer(cuda):
    """``device=None`` everywhere (the launcher's default): the analyzer
    and the router resolve to the same card, and the fused program
    routes."""
    from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
    from repro_torch.core.orchestrator import OptiRoute
    from repro_torch.device import resolve_device
    from repro_torch.serving.catalog import build_catalog

    assert resolve_device() == resolve_device("cuda") == \
        torch.device("cuda", torch.cuda.current_device())
    router = OptiRoute(build_catalog(archs=["llama3.2-1b", "mamba2-1.3b"]),
                       TaskAnalyzer(AnalyzerConfig()))
    rqs = router.route_all(["write a python function", "summarize this"],
                           "balanced")
    assert {rq.model for rq in rqs} <= {"llama3.2-1b", "mamba2-1.3b"}


def _mega_problem(rng, B, N, *, dup=False, blend=True):
    """A routing step's operands with sparse filters (every fallback
    rung fires) and, with ``dup``, every catalog row duplicated into
    the other half of the catalog (rows, filters and blend terms), the
    first half of the queries aimed at them: exact ties."""
    half = N // 2 if dup else N
    emb = rng.random((half, 8)).astype(np.float32)
    tt = np.vstack([rng.random((11, half)) < 0.05, np.ones((1, half), bool)])
    dm = np.vstack([rng.random((6, half)) < 0.1, np.ones((1, half), bool)])
    tt[:3] = False
    gmask = rng.random(half) < 0.02
    L = rng.standard_normal((half, 9, 9)).astype(np.float32) * 0.05
    kw = dict(fb=(rng.random((B, half)) - 0.5).astype(np.float32),
              fb_weight=0.5,
              theta=rng.standard_normal((half, 9)).astype(np.float32) * 0.1,
              ainv=np.einsum("nde,nfe->ndf", L, L)
              + 0.5 * np.eye(9, dtype=np.float32), alpha=0.8, ad_weight=0.6,
              lpen=(rng.random(half) * 0.3).astype(np.float32)) \
        if blend else {}
    if dup:
        two = lambda a, ax: np.concatenate([a, a], axis=ax)
        emb, tt, dm, gmask = two(emb, 0), two(tt, 1), two(dm, 1), \
            two(gmask, 0)
        kw.update({key: two(kw[key], 1 if key == "fb" else 0)
                   for key in ("fb", "theta", "ainv", "lpen") if key in kw})
    T = rng.random((B, 8)).astype(np.float32)
    if dup:
        T[: B // 2] = emb[rng.integers(0, half, B // 2)]
    W = rng.random((B, 8)).astype(np.float32)
    ti, di = rng.integers(0, 12, B), rng.integers(0, 7, B)
    return (emb, tt, dm, gmask, T, W, ti, di), kw


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,N,k,dup,blend", [
    (5, 5, 3, False, True), (256, 100_000, 8, False, True),
    (64, 20_000, 8, True, True), (33, 515, 8, False, False)])
def test_sharded_route_step_on_card_bit_equal_to_dense(cuda, quant, B, N, k,
                                                      dup, blend):
    """Four shards on one card (one ``router_topk`` launch each) against
    the dense program on the same card, all eight outputs bit for bit,
    ties included; and against the CPU's sharded run, tie-aware."""
    from repro_torch.launch.mesh import make_routing_mesh

    rng = np.random.default_rng(N + B)
    args, kw = _mega_problem(rng, B, N, dup=dup, blend=blend)
    r = min(max(5, k), N)
    dense = OPS.route_step(*args, k=k, r=r, quant=quant, device=cuda, **kw)
    RT.router_topk.launches = RT.router_topk_q8.launches = 0
    got = OPS.route_step(*args, k=k, r=r, quant=quant,
                         mesh=make_routing_mesh(4, device=cuda),
                         device=cuda, **kw)
    launched = RT.router_topk_q8 if quant else RT.router_topk
    assert launched.launches == 4
    for key in dense:
        np.testing.assert_array_equal(got[key], dense[key], err_msg=key)
    cpu = OPS.route_step(*args, k=k, r=r, quant=quant,
                         mesh=make_routing_mesh(4, device="cpu"),
                         device="cpu", **kw)
    _assert_route_close(got, cpu)


def _assert_route_close(got, want, tol=1e-5):
    """Stages and counts exact, scores within ``tol``, candidate
    indices equal except inside a run of reference scores tied within
    ``tol``."""
    for key in ("stage", "n_filtered", "n_candidates"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    gs, ws = got["cand_score"], want["cand_score"]
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=tol)
    gi, wi = got["cand_idx"], want["cand_idx"]
    for b, j in zip(*np.nonzero(fin & (gi != wi))):
        alt = np.nonzero(wi[b] == gi[b, j])[0]
        assert alt.size and abs(ws[b, alt[0]] - ws[b, j]) <= tol, (b, j)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("N,nprobe", [(4000, 2), (100_000, 8)])
def test_ivf_route_step_on_card_matches_cpu(cuda, quant, N, nprobe):
    """The IVF program on the card against its CPU run on the same
    index: the same probed cells for every query, then the same
    decisions (tie-aware within 1e-5, stages and counts exact)."""
    from repro_torch.core.mres import build_ivf, default_n_cells
    from repro_torch.kernels.route_step import _dot_cols, unit_rows
    from repro_torch.kernels.router_topk import topk_stable

    rng = np.random.default_rng(N)
    args, kw = _mega_problem(rng, 256, N)
    ivf = build_ivf(args[0], default_n_cells(N))
    cells = []
    for dev in (cuda, torch.device("cpu")):
        T = torch.from_numpy(args[4]).to(dev)
        cent = torch.from_numpy(ivf.centroids).to(dev)
        cells.append(topk_stable(_dot_cols(unit_rows(T), cent),
                                 nprobe)[1].cpu())
    assert torch.equal(cells[0], cells[1])
    got, want = (OPS.route_step(*args, k=8, r=8, quant=quant,
                                ivf=ivf.as_tuple(), nprobe=nprobe,
                                device=dev, **kw)
                 for dev in (cuda, "cpu"))
    _assert_route_close(got, want)
    assert (want["stage"] > 0).any()


# ----------------------------------------------------------------------
# the int8 KV cache
# ----------------------------------------------------------------------

def _q8_cache(rng, B, C, Hkv, hd):
    """An int8 cache in the model's (B, C, Hkv, hd) layout and its
    scales, from seeded f32 rows through ``quantize_kv``."""
    from repro_torch.models.layers import quantize_kv
    k8, ks = quantize_kv(_rand(rng, B, C, Hkv, hd) * 2.0)
    v8, vs = quantize_kv(_rand(rng, B, C, Hkv, hd))
    return k8, v8, ks, vs


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-4)])
@pytest.mark.parametrize("hd,Hq,Hkv,C,softcap,local", [
    (64, 32, 8, 536, 0.0, 0), (120, 32, 8, 300, 0.0, 0),
    (128, 32, 8, 700, 0.0, 0), (288, 8, 4, 536, 50.0, 0),
    (288, 8, 4, 536, 50.0, 200), (64, 25, 5, 130, 0.0, 0),
    (32, 40, 1, 77, 0.0, 0), (64, 40, 2, 300, 0.0, 0),
    (288, 32, 2, 200, 0.0, 0)])
def test_flash_decode_q8_matches_plain(cuda, dtype, tol, hd, Hq, Hkv, C,
                                       softcap, local):
    """The int8 decode on strided views of a (B, C, Hkv, hd) cache
    against ``decode_q8_plain``: GQA groups up to 40, softcap, the
    local window, kv_valid 0, partial and full; one launch a call, on
    the body ``q8_body`` names: the tensor cores for bf16 at hd 64-288
    with G <= 16, ``decode_q8_kernel`` for f32, hd 32 and G > 16."""
    rng = np.random.default_rng(hd + C)
    dt = getattr(torch, dtype)
    B = 4
    k8, v8, ks, vs = _q8_cache(rng, B, C, Hkv, hd)
    q = _rand(rng, B, 1, Hq, hd).to(dt)
    kv = torch.tensor([0, 1, C // 2, C], dtype=torch.int32)
    view = lambda x: x.transpose(1, 2)
    args = [view(x) for x in (q, k8, v8, ks, vs)]
    kw = dict(softcap=softcap, local_window=local)
    want = FA.decode_q8_plain(*args, kv, **kw)
    before = FA.flash_decode_q8.launches
    on = [a.to(cuda) for a in args]
    body = FA.q8_body(on[0], on[1])
    assert body == ("mma" if dt == torch.bfloat16 and hd != 32 and
                    Hq // Hkv <= 16 else "cores")
    n = FA.flash_decode_q8.launches_by_body[body]
    got = FA.flash_decode_q8(*on, kv.to(cuda), **kw)
    torch.cuda.synchronize()
    assert FA.flash_decode_q8.launches == before + 1
    assert FA.flash_decode_q8.launches_by_body[body] == n + 1
    assert got.dtype == dt and not got.cpu()[0].any()
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    # one live key: its dequantized V row, bit for bit
    assert torch.equal(got.cpu()[1], want[1])


def test_flash_decode_q8_is_bit_stable_and_refuses_bad_operands(cuda):
    rng = np.random.default_rng(9)
    k8, v8, ks, vs = (x.to(cuda) for x in _q8_cache(rng, 2, 200, 4, 64))
    q = _rand(rng, 2, 1, 16, 64).to(torch.bfloat16).to(cuda)
    kv = torch.tensor([200, 77], dtype=torch.int32, device=cuda)
    args = [x.transpose(1, 2) for x in (q, k8, v8, ks, vs)]
    a = FA.flash_decode_q8(*args, kv)
    b = FA.flash_decode_q8(*args, kv)
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        FA.flash_decode_q8(args[0], args[1].float(), *args[2:], kv)
    with pytest.raises(ValueError):
        FA.flash_decode_q8(args[0], args[1], args[2], args[3][:, :, :9],
                           args[4], kv)


@pytest.mark.parametrize("hd,Hq,Hkv,C", [(64, 32, 8, 536),
                                         (120, 32, 8, 4096)])
def test_flash_decode_int8_ring_via_ops_matches_cpu(cuda, hd, Hq, Hkv, C):
    """``ops.flash_decode`` with scales over a full cache and a ring
    (rows before and after it fills), bf16, against the CPU."""
    rng = np.random.default_rng(C + 1)
    k8, v8, ks, vs = _q8_cache(rng, 4, C, Hkv, hd)
    q = _rand(rng, 4, 1, Hq, hd).to(torch.bfloat16)
    pos = torch.tensor([0, C // 3, C - 1, 3 * C + 7])
    want = OPS.flash_decode(q, k8, v8, pos, k_scale=ks, v_scale=vs)
    got = OPS.flash_decode(*(x.to(cuda) for x in (q, k8, v8, pos)),
                           k_scale=ks.to(cuda), v_scale=vs.to(cuda))
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("name,L", [("llama3.2-1b", 40), ("gemma2-2b", 100),
                                    ("h2o-danube-3-4b", 100),
                                    ("hymba-1.5b", 100),
                                    ("qwen3-moe-30b-a3b", 40)])
def test_generate_int8_kv_on_card_matches_cpu(cuda, name, L):
    """``kv_cache_dtype="int8"`` at ``SMOKE`` (f32 compute): prefill
    logits within 1e-3, greedy tokens tie-aware, every decode layer
    through the int8 kernel (one launch per attention layer per step)."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke(name), kv_cache_dtype="int8")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, L)).astype(np.int32)
    want = ModelRunner(cfg, params=params, device="cpu").generate(
        toks, 5, keep_logits=True)
    before = FA.flash_decode_q8.launches
    got = ModelRunner(cfg, params=params, device=cuda).generate(toks, 5)
    assert FA.flash_decode_q8.launches - before == cfg.n_layers * 4
    np.testing.assert_allclose(got.logits_last, want.logits_last, rtol=1e-3,
                               atol=1e-3)
    for b in range(toks.shape[0]):
        for s in range(5):
            top2 = np.sort(want.step_logits[b, s])[-2:]
            if top2[1] - top2[0] < 1e-3:
                break
            assert got.tokens[b, s] == want.tokens[b, s], (b, s)


# ----------------------------------------------------------------------
# training: the backward kernels and the train step
# ----------------------------------------------------------------------

def _attn_operand(g, cuda, dt, B, L, H, hd, layout):
    """A (B, H, L, hd) operand in ``layout``: "blhd" a ``transpose(1,
    2)`` view of the model's (B, L, H, hd), "bhld" a contiguous tensor,
    "pad" a view whose rows lie 8 bytes off 16 (bf16: the mma body)."""
    if layout == "bhld":
        return torch.randn(B, H, L, hd, generator=g, device=cuda).to(dt)
    w = H * hd + (4 if layout == "pad" else 0)
    x = torch.randn(B, L, w, generator=g, device=cuda).to(dt)
    return x[..., :H * hd].unflatten(-1, (H, hd)).transpose(1, 2)


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4),
                                    (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Hq,Hkv,L,Lk,hd,causal,window,cap,kvv,layout", [
    (2, 4, 2, 200, 200, 64, True, 0, 0.0, None, "blhd"),
    (1, 4, 1, 130, 130, 120, True, 50, 0.0, None, "blhd"),
    (1, 2, 1, 100, 100, 288, True, 64, 50.0, None, "blhd"),
    (1, 4, 2, 150, 150, 128, True, 0, 0.0, None, "blhd"),
    (2, 4, 4, 300, 16, 64, False, 0, 0.0, None, "blhd"),
    (1, 2, 2, 70, 70, 32, True, 0, 0.0, None, "blhd"),
    (1, 8, 1, 190, 190, 128, True, 0, 0.0, None, "blhd"),  # qwen3's G = 8
    (1, 4, 2, 300, 300, 64, True, 70, 0.0, None, "blhd"),  # tiles skipped
    (2, 4, 2, 150, 150, 64, True, 0, 0.0, (150, 77), "blhd"),  # kv_valid
    (2, 4, 2, 100, 150, 128, True, 0, 30.0, (120, 9), "blhd"),
    (1, 4, 2, 100, 40, 128, False, 0, 0.0, None, "blhd"),  # Lk < 64
    (1, 4, 2, 130, 130, 120, True, 0, 0.0, None, "bhld"),  # contiguous
    (2, 4, 2, 200, 200, 64, True, 0, 0.0, None, "bhld"),
    (1, 4, 2, 100, 100, 64, True, 0, 0.0, None, "pad")])  # rows off 16 B
def test_flash_attention_bwd_matches_plain(cuda, dt, tol, B, Hq, Hkv, L, Lk,
                                           hd, causal, window, cap, kvv,
                                           layout):
    """The backward kernel against the plain backward (each gradient
    within ``tol`` of its max |g|), the forward's o (``tol`` * (1 +
    |want|)) and lse (1e-5 relative) against the plain ones, the same
    bits on two launches, and the body that ran: wgmma for bf16 at hd
    64 / 120 / 128 on 16-byte rows, mma for other bf16 operands (hd 32,
    288, rows off 16 bytes), f32 for f32 ones."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (_attn_operand(g, cuda, dt, B, L, Hq, hd, layout)
             for _ in range(2))
    k, v = (_attn_operand(g, cuda, dt, B, Lk, Hkv, hd, layout)
            for _ in range(2))
    kv = None if kvv is None else torch.tensor(kvv, dtype=torch.int32,
                                               device=cuda)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = FA.flash_attention(q, k, v, kv, return_lse=True, **kw)
    o2, lse2 = FA.flash_attention_plain(q, k, v, kv, return_lse=True, **kw)
    assert torch.allclose(lse, lse2, rtol=1e-5, atol=1e-5)
    assert bool(((o.float() - o2.float()).abs()
                 <= tol * (1 + o2.float().abs())).all())
    body = "f32" if dt == torch.float32 else \
        "wgmma" if hd in (64, 120, 128) and layout != "pad" else "mma"
    assert FA.bwd_body(q, k, v, do) == body
    before = dict(FA.flash_attention_bwd.launches_by_body)
    got = FA.flash_attention_bwd(q, k, v, o2, lse2, do, kv, **kw)
    ran = {b: n - before[b]
           for b, n in FA.flash_attention_bwd.launches_by_body.items()}
    assert ran == {b: int(b == body) for b in ran}
    want = FA.flash_attention_bwd_plain(q, k, v, o2, lse2, do, kv, **kw)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= tol * float(
            b.float().abs().max())
    again = FA.flash_attention_bwd(q, k, v, o2, lse2, do, kv, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("Bb,L,H,P,N,dt,tol,with_dh", [
    (2, 130, 4, 64, 128, torch.float32, 1e-4, False),
    (2, 150, 4, 64, 128, torch.float32, 1e-4, True),    # mamba2's tile,
    (2, 150, 4, 64, 128, torch.bfloat16, 2e-2, True),   # ragged, dh
    (2, 300, 5, 64, 16, torch.bfloat16, 2e-2, False),
    (1, 200, 50, 64, 16, torch.bfloat16, 2e-2, True),   # hymba's heads:
    (1, 200, 50, 64, 16, torch.float32, 1e-4, False),   # 7 head groups
    (1, 64, 2, 32, 8, torch.float32, 1e-4, False),      # under a tile
    (1, 70, 2, 32, 8, torch.bfloat16, 2e-2, True),
    (1, 100, 3, 96, 24, torch.float32, 1e-4, True),     # P in 2 slices
    (1, 90, 2, 40, 200, torch.float32, 1e-4, True),     # the wide-N tile
    (1, 90, 2, 12, 12, torch.bfloat16, 2e-2, True)])    # rows off 16 B
def test_ssd_scan_bwd_matches_plain(cuda, Bb, L, H, P, N, dt, tol, with_dh):
    """The backward kernel against the plain backward (each gradient
    within ``tol`` of its max |g|) on bf16 / f32 strided views, and the
    same bits on two launches."""
    g = torch.Generator(device=cuda).manual_seed(2)
    xbc = torch.randn(Bb, L, H * P + 2 * N, generator=g, device=cuda).to(dt)
    args = (xbc[..., :H * P].unflatten(-1, (H, P)),
            torch.rand(Bb, L, H, generator=g, device=cuda) * 0.2,
            -torch.linspace(1.0, 16.0, H, device=cuda),
            xbc[..., H * P:H * P + N], xbc[..., H * P + N:],
            torch.randn(Bb, L, H, P, generator=g, device=cuda),
            torch.randn(Bb, H, P, N, generator=g, device=cuda)
            if with_dh else None)
    got, want = SS.ssd_scan_bwd(*args), SS.ssd_scan_bwd_plain(*args)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= tol * float(
            b.float().abs().max())
    again = SS.ssd_scan_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("T,E,k,dtype", [
    (100, 16, 2, "float32"), (4096, 128, 8, "float32"),
    (33, 1024, 4, "float32"), (200, 1024, 8, "float32"),
    (4096, 128, 8, "bfloat16"), (77, 160, 8, "bfloat16")])
def test_moe_gating_bwd_matches_plain(cuda, T, E, k, dtype):
    """The gate's backward (warp-level rows) against its plain version: f32
    within 1e-5 of max |g|, bf16 within 1e-2 (dlogits rounded to bf16);
    one launch, the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(3)
    lg = torch.randn(T, E, generator=g, device=cuda).to(getattr(torch,
                                                               dtype))
    vals, idx, aux, asum = MG.moe_gating(lg, k, return_asum=True)
    assert torch.equal(asum, MG.moe_gating_plain(lg, k, True)[3])
    dv = torch.randn(T, k, generator=g, device=cuda)
    da = torch.tensor(0.5, device=cuda)
    before = MG.moe_gating_bwd.launches
    got = MG.moe_gating_bwd(lg, idx, dv, da, asum)
    assert MG.moe_gating_bwd.launches == before + 1
    want = MG.moe_gating_bwd_plain(lg, idx, dv, da, asum)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * float(
        want.float().abs().max())
    assert torch.equal(got, MG.moe_gating_bwd(lg, idx, dv, da, asum))


@pytest.mark.parametrize("T,E,k,dtype", [
    (100, 16, 2, "float32"), (4096, 128, 8, "bfloat16"),
    (200, 1024, 8, "float32")])
def test_moe_gating_sums_match_plain(cuda, T, E, k, dtype):
    """The gate's assignment counts and probability sums (what a
    token-split gate all-reduces) from the same launch: the counts equal
    to the plain version's, the sums within 1e-5 relative, and aux the
    product of the two."""
    g = torch.Generator(device=cuda).manual_seed(5)
    lg = torch.randn(T, E, generator=g, device=cuda).to(getattr(torch,
                                                               dtype))
    before = MG.moe_gating.launches
    vals, idx, aux, asum, psum = MG.moe_gating(lg, k, return_asum=True,
                                               return_psum=True)
    assert MG.moe_gating.launches == before + 1
    want = MG.moe_gating_plain(lg, k, True, return_psum=True)
    assert torch.equal(asum, want[3])
    assert float((psum - want[4]).abs().max()) <= 1e-5 * float(
        want[4].abs().max())
    prod = float(torch.dot(psum, asum)) * E / (T * T)
    assert abs(float(aux) - prod) <= 1e-5 * abs(prod)


def test_sharded_train_step_on_the_host_mesh(cuda):
    """Two train steps of llama3.2-1b and qwen3-moe-30b-a3b at SMOKE on
    DTensor parameters over ``make_host_mesh()`` (a world-size-1 NCCL
    group) equal the unsharded steps', the kernels launched from the
    sharded steps."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import place
    from repro_torch.sharding import rules as R
    from repro_torch.training.optimizer import init_opt_state, leaves
    from repro_torch.training.steps import make_train_step
    mesh = make_host_mesh()
    try:
        for name in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
            cfg = get_smoke(name)
            gen = torch.Generator(device=cuda).manual_seed(0)
            params = M.init_params(cfg, gen, device=cuda)
            toks = torch.randint(0, cfg.vocab_size, (2, 2, 33),
                                 generator=gen, device=cuda)
            step = make_train_step(cfg)
            p0, o0 = params, init_opt_state(params)
            sp = place.shard_tree(params, R.param_specs(cfg, mesh, params),
                                  mesh)
            so = init_opt_state(sp)
            before = MG.moe_gating_bwd.launches, \
                FA.flash_attention_bwd.launches
            for t in toks:
                b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
                p0, o0, m0 = step(p0, o0, b)
                sp, so, m1 = step(sp, so, place.shard_tree(
                    b, R.batch_spec(cfg, mesh, b), mesh))
                for key in ("loss", "gnorm", "aux"):
                    assert abs(float(m0[key]) - float(m1[key])) <= 1e-5 * \
                        max(abs(float(m0[key])), 1.0), (name, key)
            for a, b in zip(leaves(p0), leaves(place.gather_tree(sp))):
                assert float((a - b).abs().max()) <= 1e-5
            assert FA.flash_attention_bwd.launches > before[1]
            if cfg.is_moe:
                assert MG.moe_gating_bwd.launches > before[0]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-1.3b",
                                  "hymba-1.5b", "gemma2-2b"])
def test_train_step_on_card_matches_cpu(cuda, name):
    """One ``loss_and_grads`` at ``SMOKE`` (f32, L=80: past the windows of
    64): loss within 1e-5 relative, every gradient leaf within 1e-3 of
    its max |g|, each backward kernel launched once a layer.  (The MoE
    configs' gates may choose apart at a near-tie: ``chip_smoke.py``'s
    ``train_card_vs_cpu`` holds them with the card's choices replayed.)"""
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = get_smoke(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 81))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    want = loss_and_grads(params, cfg, batch)
    before = {f: f.launches for f in (FA.flash_attention_bwd,
                                      SS.ssd_scan_bwd, MG.moe_gating_bwd)}
    got = loss_and_grads(M.tree_map(lambda t: t.to(cuda), params), cfg,
                         {k: v.to(cuda) for k, v in batch.items()})
    assert abs(float(got[1]) - float(want[1])) <= 1e-5 * float(want[1])
    for a, b in zip(leaves(got[3]), leaves(want[3])):
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * max(
            float(b.abs().max()), 1e-30)
    ran = {f.__name__: f.launches - n for f, n in before.items()}
    assert ran["flash_attention_bwd"] == (cfg.n_layers if cfg.has_attention
                                          else 0)
    assert ran["ssd_scan_bwd"] == (cfg.n_layers if cfg.has_ssm else 0)
    assert ran["moe_gating_bwd"] == (cfg.n_layers if cfg.is_moe else 0)


@pytest.mark.parametrize("hd,theta", [(288, 1e4), (64, 5e5), (120, 1e4)])
def test_rope_freqs_on_the_card_are_the_hosts(cuda, hd, theta):
    """The RoPE inverse frequencies on the card are the host's bits (the
    card's own ``powf`` may round some an ulp apart: at the long_500k
    positions that is up to 0.03 rad of angle), and a rotation at pos
    524,287 agrees with the CPU's within f32 rounding of sin/cos."""
    from repro_torch.models import layers as L
    host = L.rope_freqs(hd, theta)
    assert torch.equal(L.rope_freqs(hd, theta, cuda).cpu(), host)
    g = torch.Generator().manual_seed(hd)
    x = torch.randn(1, 64, 2, hd, generator=g)
    pos = torch.arange(524_287 - 63, 524_288)[None]
    want = L.apply_rope(x, pos, theta)
    got = L.apply_rope(x.to(cuda), pos.to(cuda), theta).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
