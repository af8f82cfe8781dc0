"""Card-only tests of the port: each CUDA kernel against its plain
version on the same inputs (flash attention's wgmma prefill and split
decode over ragged lengths, GQA groups, window, softcap, kv_valid and
cache capacities; two decode launches bit-equal), and generation on
the card against the same seeded model on the CPU.  They import neither JAX nor the JAX
package, so they run on a machine with a card and no JAX:

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
