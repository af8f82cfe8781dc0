"""The kernels' CUDA sources run on the CPU through an emulation
of the CUDA execution model (``tests/_cuda_emu.py``: g++, fibers for
threads, warp collectives for ``ldmatrix``, ``mma.sync``, ``wgmma`` and
shuffles, mbarriers as fiber waits, TMA boxes as swizzled copies with
zero fill), each held against its plain backward as
``tests/test_torch_cuda.py`` holds the card's, with the same bits on two
launches.

The scan (``csrc/ssd_scan_bwd.cuh``): each gradient within 1e-4 of its
max |g| in f32 (three-term split operands up to N = 128, two past it)
and 2e-2 in bf16.  The tiles' paths: mamba2's 64 x 128 tile over three
chunks with a ragged last one, a head count over two groups of 8, rows
off 16 bytes, P in two slices on the wide-N tile.

The attention (``csrc/flash_attention_bwd.cuh``), each of its three
bodies as ``flash_attention.bwd_body`` names it: wgmma (TMA rings and
wgmma, hd 64, 120, 128: ragged lengths, full and edge tiles, a window,
Lk < 64 non-causal, kv_valid with a softcap and Lq != Lk, a contiguous
layout), mma (hd 288
with its softcap and window, and hd 64 rows off 16 bytes) within 2e-2
of each gradient's max |g|, f32 within 1e-4.  Beside them, the body
rule at the zoo's training shapes.

The int8 KV decode (``csrc/flash_attention.cu``) on each body
``flash_attention.q8_body`` names, and the bf16 decode on the body it
shares, against their plain versions; every decode body's partial (o,
lse) over a block of the cache with a per-row first live slot, and
their merge across blocks (``flash_decode_merge_launch``); the gate's
backward (``csrc/moe_gating_bwd.cuh``) against its plain version.
Skips where g++ is missing."""
import math
import shutil

import pytest
import torch

import _cuda_emu
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import moe_gating as MG
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import layers as TL


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("the emulation compiles the CUDA source with g++")
    return _cuda_emu.load("ssd_scan", SS._SIG)


@pytest.mark.parametrize("shape,dtype,tol,with_dh", [
    ((1, 150, 2, 64, 128), torch.float32, 1e-4, True),
    ((1, 100, 9, 64, 16), torch.bfloat16, 2e-2, True),
    ((1, 90, 2, 12, 12), torch.bfloat16, 2e-2, False),
    ((1, 90, 2, 80, 200), torch.float32, 1e-4, True)])
def test_ssd_scan_bwd_source_matches_plain(lib, shape, dtype, tol, with_dh):
    args = _cuda_emu.scan_inputs(shape, dtype, with_dh, seed=1)
    got = SS._bwd_launch(lib, None, *args)
    want = SS.ssd_scan_bwd_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol * float(
            b.float().abs().max())
    again = SS._bwd_launch(lib, None, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.fixture(scope="module")
def fa_lib():
    if shutil.which("g++") is None:
        pytest.skip("the emulation compiles the CUDA source with g++")
    return _cuda_emu.load("flash_attention", FA._SIG)


@pytest.mark.parametrize("B,Hq,Hkv,L,Lk,hd,causal,window,cap,kvv,layout,"
                         "dtype,body", [
    (1, 2, 1, 100, 100, 64, True, 0, 0.0, None, "blhd", torch.bfloat16,
     "wgmma"),
    (1, 2, 1, 200, 200, 64, True, 0, 0.0, None, "blhd", torch.bfloat16,
     "wgmma"),
    (1, 4, 1, 150, 150, 128, True, 0, 0.0, None, "blhd", torch.bfloat16,
     "wgmma"),
    (1, 2, 2, 130, 130, 120, True, 40, 0.0, None, "blhd", torch.bfloat16,
     "wgmma"),
    (1, 2, 2, 90, 12, 64, False, 0, 0.0, None, "blhd", torch.bfloat16,
     "wgmma"),
    (2, 2, 1, 80, 110, 64, True, 0, 30.0, (100, 7), "blhd", torch.bfloat16,
     "wgmma"),
    (1, 2, 1, 140, 140, 128, True, 0, 0.0, None, "bhld", torch.bfloat16,
     "wgmma"),
    (1, 2, 1, 100, 100, 64, True, 0, 0.0, None, "pad", torch.bfloat16,
     "mma"),
    (1, 2, 1, 70, 70, 288, True, 32, 50.0, None, "blhd", torch.bfloat16,
     "mma"),
    (1, 2, 1, 70, 70, 64, True, 0, 0.0, (60,), "blhd", torch.float32,
     "f32")])
def test_flash_attention_bwd_source_matches_plain(fa_lib, B, Hq, Hkv, L, Lk,
                                                  hd, causal, window, cap,
                                                  kvv, layout, dtype, body):
    args = _cuda_emu.attn_inputs(B, Hq, Hkv, L, Lk, hd, dtype, layout, 2)
    kv = None if kvv is None else torch.tensor(kvv, dtype=torch.int32)
    got, want, ran = _cuda_emu.attn_bwd(fa_lib, *args, kv, causal, window,
                                        cap)
    assert ran == body
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol * float(
            b.float().abs().max())
    again, _, _ = _cuda_emu.attn_bwd(fa_lib, *args, kv, causal, window, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("name,body", [
    ("llama3.2-1b", "wgmma"), ("qwen3-moe-30b-a3b", "wgmma"),
    ("h2o-danube-3-4b", "wgmma"), ("seamless-m4t-medium", "wgmma"),
    ("mamba2-1.3b", None), ("gemma2-2b", "mma"),
    ((32, 4, 128), "wgmma"), ((2, 2, 32), "mma")])
def test_bwd_body_at_the_zoos_training_shapes(name, body):
    """The body rule at each config's own heads and head dim (or at
    (Hq, Hkv, hd): the hd-128 and hd-32 kernel shapes), in the model's
    (B, L, H, hd) layout seen through ``transpose(1, 2)``: bf16 names
    the wgmma body at hd 64, 120 and 128 and the mma body at 32 and 288;
    f32 names the f32 body; a view whose rows lie 8 bytes off 16 (rows
    of a wider bf16 buffer) names the mma body."""
    if isinstance(name, tuple):
        H, Hkv, hd = name
    else:
        cfg = get_config(name)
        if body is None:
            assert not cfg.has_attention
            return
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def view(n, w, dt):
        x = torch.zeros(1, 8, w, dtype=dt)
        return x[..., :n * hd].unflatten(-1, (n, hd)).transpose(1, 2)
    for dt, want in ((torch.bfloat16, body), (torch.float32, "f32")):
        q, k, v, do = (view(n, n * hd, dt) for n in (H, Hkv, Hkv, H))
        assert FA.bwd_body(q, k, v, do) == want
    q, k, v, do = (view(n, n * hd + 4, torch.bfloat16)
                   for n in (H, Hkv, Hkv, H))
    assert FA.bwd_body(q, k, v, do) == "mma"


@pytest.fixture(scope="module")
def mg_lib():
    if shutil.which("g++") is None:
        pytest.skip("the emulation compiles the CUDA source with g++")
    return _cuda_emu.load("moe_gating", MG._SIG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("E", [8, 100, 128, 160, 1024])
def test_moe_gating_bwd_source_matches_plain(mg_lib, E, k, dtype):
    """The gate's backward (``csrc/moe_gating_bwd.cuh``: a row to 16
    lanes of a warp up to E = 128, to a whole warp past it, 8 warps a
    block; 19 rows leave the last block part empty; 16-byte runs of a row
    a lane where E is a multiple of a lane's share, E = 100 the strided
    layout) against its plain version,
    two rows with 16 tied experts.  f32: within 1e-5 of
    max |g|; at k = 1 dr is the difference of two nearly equal terms, and
    the plain f32 version is itself up to ~1e-4 of max |g| from the f64
    one, so there the kernel is held to the f64 result within 1e-5 or
    twice the plain version's own error.  bf16 (dlogits rounded once):
    each value within one bf16 ulp of |want| plus 1e-5 of max |g|.  The
    same bits on two launches."""
    args = _cuda_emu.gate_inputs(19, E, k, dtype, seed=E + k)
    got = MG._bwd_launch(mg_lib, None, *args)
    want = MG.moe_gating_bwd_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    m = float(want.float().abs().max())
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= 2.0 ** -8 * want.float().abs() + 1e-5 * m).all())
    elif k > 1:
        assert float(err.max()) <= 1e-5 * m
    else:
        f64 = MG.moe_gating_bwd_plain(*(a.double() if a.is_floating_point()
                                        else a for a in args))
        own = float((want.double() - f64).abs().max())
        assert float((got.double() - f64).abs().max()) <= max(1e-5 * m,
                                                              2 * own)
    assert torch.equal(got, MG._bwd_launch(mg_lib, None, *args))


def _ulp_close(got, want, tol: float):
    """|err| <= tol (1 + |want|) everywhere and, for bf16 outputs, at most
    one bf16 ulp of max |want| (both sides use the same dequantized bf16
    values; the kernel rounds P to bf16 for the product)."""
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol * (1 + want.float().abs())).all())
    if got.dtype == torch.bfloat16:
        top = float(want.float().abs().max())
        assert float(diff.max()) <= 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.parametrize("B,Hq,Hkv,C,hd,kv,cap,local,dtype,body", [
    (2, 2, 2, 150, 64, (150, 77), 0.0, 0, torch.bfloat16, "mma"),
    (3, 8, 2, 150, 64, (0, 150, 1), 0.0, 0, torch.bfloat16, "mma"),
    (2, 16, 2, 150, 120, (150, 33), 0.0, 40, torch.bfloat16, "mma"),
    (2, 8, 2, 200, 128, (199, 1), 30.0, 0, torch.bfloat16, "mma"),
    (2, 4, 2, 140, 288, (140, 77), 50.0, 100, torch.bfloat16, "mma"),
    (2, 16, 2, 100, 288, (100, 1), 0.0, 0, torch.bfloat16, "mma"),
    (2, 8, 2, 150, 64, (150, 77), 0.0, 30, torch.float32, "cores"),
    (2, 40, 2, 70, 64, (70, 9), 0.0, 0, torch.bfloat16, "cores"),
    (2, 4, 1, 70, 32, (70, 9), 0.0, 0, torch.bfloat16, "cores")])
def test_flash_decode_q8_source_matches_plain(fa_lib, B, Hq, Hkv, C, hd, kv,
                                              cap, local, dtype, body):
    """The int8 KV decode (``csrc/flash_attention.cu``) through the body
    ``q8_body`` names: the tensor cores for bf16 queries at hd 64, 120,
    128 (``decode_mma_kernel<HD, true>``) and 288
    (``decode_wide_q8_kernel``), G 1-8, ragged and empty ``kv_valid``, a
    local window, softcap; CUDA cores (``decode_q8_kernel``) for f32
    queries, G > 16 and hd 32.  Against ``decode_q8_plain``: bf16 within
    2e-2 (1 + |want|) and one bf16 ulp of max |want|, f32 within 2e-4
    (1 + |want|); the same bits on two launches.  A sequence with one
    live key gives that key's dequantized V row, bit for bit."""
    args = _cuda_emu.q8_inputs(B, Hq, Hkv, C, hd, dtype, seed=hd + C)
    kvt = torch.tensor(kv, dtype=torch.int32)
    got, want, ran = _cuda_emu.q8_decode(fa_lib, *args, kvt, cap, local)
    assert ran == body
    assert got.dtype == dtype and got.shape == want.shape
    _ulp_close(got, want, 2e-2 if dtype == torch.bfloat16 else 2e-4)
    for b in (i for i, n in enumerate(kv) if n == 1):
        assert torch.equal(got[b], want[b])
    again, _, _ = _cuda_emu.q8_decode(fa_lib, *args, kvt, cap, local)
    assert torch.equal(got, again)


@pytest.mark.parametrize("B,Hq,Hkv,C,hd,kv,local", [
    (2, 8, 2, 150, 64, (150, 77), 0), (2, 16, 2, 150, 120, (150, 33), 40)])
def test_bf16_decode_source_matches_plain(fa_lib, B, Hq, Hkv, C, hd, kv,
                                          local):
    """The bf16 cache's decode on the same tensor-core body
    (``decode_mma_kernel<HD, false>``) against ``flash_attention_plain``,
    as the int8 test above."""
    g = torch.Generator().manual_seed(C)
    q, k, v = (torch.randn(B, L, H, hd, generator=g).to(torch.bfloat16)
               .transpose(1, 2) for L, H in ((1, Hq), (C, Hkv), (C, Hkv)))
    kvt = torch.tensor(kv, dtype=torch.int32)
    kw = dict(causal=False, window=0, softcap=0.0, local_window=local)
    got = FA._fwd_launch(fa_lib, None, q, k, v, kvt, return_lse=False, **kw)
    want = FA.flash_attention_plain(q, k, v, kvt, **kw)
    _ulp_close(got, want, 2e-2)
    assert torch.equal(got, FA._fwd_launch(fa_lib, None, q, k, v, kvt,
                                           return_lse=False, **kw))


@pytest.mark.parametrize("name", ["llama3.2-1b", "gemma2-2b",
                                  "h2o-danube-3-4b", "llava-next-mistral-7b",
                                  "qwen3-moe-30b-a3b"])
def test_q8_body_at_the_zoos_decode_shapes(name):
    """The int8 decode's body rule at each config's heads in the model's
    (B, 1, Hq, hd) layout seen through ``transpose(1, 2)``: bf16 queries
    name the tensor cores (every zoo config has G <= 16 at hd 64-288), f32
    queries the CUDA cores, and so does a query view off 4 bytes."""
    cfg = get_config(name)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k8 = torch.zeros(2, 8, Hkv, hd, dtype=torch.int8).transpose(1, 2)
    for dt, want in ((torch.bfloat16, "mma"), (torch.float32, "cores")):
        q = torch.zeros(2, 1, Hq, hd, dtype=dt).transpose(1, 2)
        assert FA.q8_body(q, k8) == want
    q = torch.zeros(2, 1, Hq * hd + 1, dtype=torch.bfloat16)[..., 1:]
    assert FA.q8_body(q.unflatten(-1, (Hq, hd)).transpose(1, 2), k8) == \
        "cores"


@pytest.mark.parametrize("dtype,Hq,Hkv,hd,cap,local,q8", [
    (torch.bfloat16, 8, 2, 64, 0.0, 0, False),      # decode_mma_kernel
    (torch.bfloat16, 4, 2, 288, 50.0, 40, False),   # decode_split_kernel
    (torch.float32, 4, 2, 64, 0.0, 40, False),      # decode_split_kernel f32
    (torch.bfloat16, 8, 2, 64, 0.0, 40, True),      # decode_mma_kernel int8
    (torch.bfloat16, 4, 2, 288, 50.0, 0, True),     # decode_wide_q8_kernel
    (torch.float32, 4, 2, 64, 0.0, 0, True)])       # decode_q8_kernel
def test_decode_partials_and_merge_source(fa_lib, dtype, Hq, Hkv, hd, cap,
                                          local, q8):
    """A cache cut into R = 2 slot blocks, as a batch-1 cache sharded by
    length: each block's decode with ``return_lse`` and its per-row
    first live slot (``kv_first``) through the body the launch names,
    its f32 o within 2e-2 of max |o| of the plain partial (1e-5 in f32)
    and its lse within 1e-5 (+inf where the block holds no live key);
    the partials merged by ``flash_decode_merge_launch`` within 1e-6 of
    max |o| of ``decode_merge_plain`` on the same partials, and against
    the unsharded launch within one bf16 ulp of max |o| (f32: 1e-5)."""
    B, C, R = 2, 96, 2
    n = C // R
    g = torch.Generator().manual_seed(hd + Hq)
    q = torch.randn(B, 1, Hq, hd, generator=g).to(dtype).transpose(1, 2)
    kf, vf = (torch.randn(B, C, Hkv, hd, generator=g) for _ in range(2))
    live = torch.tensor([90, 30], dtype=torch.int32)
    if q8:
        (k8, ks), (v8, vs) = TL.quantize_kv(kf), TL.quantize_kv(vf)
        kv = [t.transpose(1, 2) for t in (k8, v8, ks, vs)]
    else:
        kv = [t.to(dtype).transpose(1, 2) for t in (kf, vf)]

    def decode(blocks, kv_valid, first, lse):
        if q8:
            return FA._q8_launch(fa_lib, None, q, *blocks, kv_valid, cap, 0,
                                 FA.q8_body(q, blocks[0]), first, lse)
        return FA._fwd_launch(fa_lib, None, q, *blocks, kv_valid, False, 0,
                              cap, 0, lse, first)

    def plain(blocks, kv_valid, first):
        if q8:
            return FA.decode_q8_plain(q, *blocks, kv_valid, softcap=cap,
                                      return_lse=True, kv_first=first)
        return FA.flash_attention(q, *blocks, kv_valid, causal=False,
                                  softcap=cap, return_lse=True,
                                  kv_first=first)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    parts = []
    for r in range(R):
        lo = r * n
        blocks = [t[:, :, lo:lo + n] for t in kv]
        kvl = (live - lo).clamp(0, n).to(torch.int32)
        first = (live - local - lo).clamp(0, n).to(torch.int32) \
            if local else None
        o, lse = decode(blocks, kvl, first, True)
        wo, wl = plain(blocks, kvl, first)
        assert o.dtype == torch.float32 and lse.shape == (B, Hq, 1)
        assert float((o - wo).abs().max()) <= tol * float(wo.abs().max())
        assert torch.equal(torch.isinf(lse), torch.isinf(wl))
        fin = torch.isfinite(wl)
        assert float((lse[fin] - wl[fin]).abs().max()) <= 1e-5
        parts.append((o, lse))
    assert torch.isinf(parts[1][1][1]).all()     # row 1 lives in block 0
    o_parts = torch.stack([p[0] for p in parts])
    lse_parts = torch.stack([p[1] for p in parts])
    got = FA._merge_launch(fa_lib, None, o_parts, lse_parts, dtype)
    want = FA.decode_merge_plain(o_parts, lse_parts, dtype)
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= \
        max(1e-6 * top, 2.0 ** (math.floor(math.log2(top)) - 7)
            if dtype == torch.bfloat16 else 0.0)
    assert torch.equal(got, FA._merge_launch(fa_lib, None, o_parts,
                                             lse_parts, dtype))
    first = (live - local).clamp(0, C).to(torch.int32) if local else None
    whole = decode(kv, live, first, False)
    diff = float((got.float() - whole.float()).abs().max())
    if dtype == torch.bfloat16:
        assert diff <= 2.0 ** (math.floor(math.log2(top)) - 7), diff
    else:
        assert diff <= 1e-5 * top, diff
