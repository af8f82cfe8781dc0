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
layout; hd 288 on the wide kernels, whose two consumer warpgroups hand
P over on named barriers: a window with gemma2's softcap 50, global
with it at G 2 in a contiguous layout, kv_valid with Lq != Lk, G 2
non-causal over 40 keys), mma (hd 288 with its softcap and window and
hd 64, both with rows off 16 bytes) within 2e-2 of each gradient's max
|g|, f32 within 1e-4.  Beside them, the body rule at the zoo's training
shapes.

The int8 KV decode (``csrc/flash_attention.cu``) on each body
``flash_attention.q8_body`` names, and the bf16 decode on each body
``flash_attention.decode_body`` names (the tensor cores' ``"mma"`` and,
at hd 288, ``"wide"``, the CUDA cores' ``"cores"``), against their plain
versions; the hd-288 prefill (``prefill_wide_kernel``) with and without
its lse; every decode body's partial (o, lse) over a block of the cache
with a per-row first live slot, and their merge across blocks
(``flash_decode_merge_launch``); the gate's backward
(``csrc/moe_gating_bwd.cuh``) against its plain version.  Beside them,
the bf16 decode's body rule at the zoo's decode heads.

The hd 64/120/128 prefill (``prefill_wgmma_kernel``; at hd 120/128 a
persistent grid -- the emulated card has 3 SMs, so each block walks
several items, an empty one among them -- 128-key tiles, consumer
warpgroups taking turns on named barriers, an item's last P V and
epilogue beside the next item's first Q K^T, O out by TMA stores; at hd
64 two blocks an SM) over causal masks, windows, ``kv_valid``, ragged
and unequal lengths and GQA groups 1-16, with and without its lse; and
the decode of
one split on ``decode_mma_kernel`` (one launch: the body writes the
output), bf16 and int8.  The emulation's named barriers count and wait,
but its ``wgmma`` is done when issued (``wgmma.wait_group 1`` and
``setmaxnreg`` are no-ops): the order in which the warpgroups' products
and softmaxes overlap is checked only on the card.  Skips where g++ is
missing."""
import math
import shutil

import pytest
import torch

import _cuda_emu
from repro_torch.configs import ARCH_NAMES, get_config
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
    (1, 2, 1, 70, 70, 288, True, 32, 50.0, None, "pad", torch.bfloat16,
     "mma"),
    (1, 2, 1, 100, 100, 288, True, 48, 50.0, None, "blhd", torch.bfloat16,
     "wgmma"),
    (1, 4, 2, 130, 130, 288, True, 0, 50.0, None, "bhld", torch.bfloat16,
     "wgmma"),
    (2, 2, 1, 80, 110, 288, True, 0, 30.0, (100, 7), "blhd",
     torch.bfloat16, "wgmma"),
    (1, 4, 2, 90, 40, 288, False, 0, 0.0, None, "blhd", torch.bfloat16,
     "wgmma"),
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
    ("mamba2-1.3b", None), ("gemma2-2b", "wgmma"),
    ((32, 4, 128), "wgmma"), ((2, 2, 32), "mma")])
def test_bwd_body_at_the_zoos_training_shapes(name, body):
    """The body rule at each config's own heads and head dim (or at
    (Hq, Hkv, hd): the hd-128 and hd-32 kernel shapes), in the model's
    (B, L, H, hd) layout seen through ``transpose(1, 2)``: bf16 names
    the wgmma body at hd 64, 120, 128 and 288 and the mma body at 32;
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
    (``decode_wide_kernel<288, true>``), G 1-8, ragged and empty
    ``kv_valid``, a local window, softcap; CUDA cores (``decode_q8_kernel``) for f32
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
    (torch.bfloat16, 4, 2, 288, 50.0, 40, False),   # decode_wide_kernel
    (torch.bfloat16, 40, 2, 288, 50.0, 40, False),  # decode_split_kernel
    (torch.float32, 4, 2, 64, 0.0, 40, False),      # decode_split_kernel f32
    (torch.bfloat16, 8, 2, 64, 0.0, 40, True),      # decode_mma_kernel int8
    (torch.bfloat16, 4, 2, 288, 50.0, 0, True),     # decode_wide_kernel int8
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


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES
                                  if get_config(n).has_attention])
def test_decode_body_at_the_zoos_decode_shapes(name):
    """The bf16 decode's body rule at each config's decode heads in the
    model's (B, 1, Hq, hd) layout seen through ``transpose(1, 2)``: bf16
    names the tensor cores (``"mma"`` at hd 64-128, ``"wide"`` at 288:
    every zoo config has G <= 16), f32 the CUDA cores, and so does a
    query view off 4 bytes; a group of 20 at hd 288 the CUDA cores."""
    cfg = get_config(name)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want = "wide" if hd == 288 else "mma"
    k = torch.zeros(2, 8, Hkv, hd, dtype=torch.bfloat16).transpose(1, 2)
    for dt, body in ((torch.bfloat16, want), (torch.float32, "cores")):
        q = torch.zeros(2, 1, Hq, hd, dtype=dt).transpose(1, 2)
        assert FA.decode_body(q, k.to(dt)) == body
    q = torch.zeros(2, 1, Hq * hd + 1, dtype=torch.bfloat16)[..., 1:]
    assert FA.decode_body(q.unflatten(-1, (Hq, hd)).transpose(1, 2), k) == \
        "cores"
    q = torch.zeros(2, 1, 20 * Hkv, 288, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, Hkv, 288, dtype=torch.bfloat16)
    assert FA.decode_body(q.transpose(1, 2), k.transpose(1, 2)) == "cores"


@pytest.mark.parametrize("B,Hq,Hkv,C,kv,cap,local,first,body", [
    (3, 8, 4, 150, (150, 77, 0), 50.0, 0, None, "wide"),
    (2, 4, 2, 300, (300, 150), 50.0, 100, None, "wide"),     # window cuts
    (3, 2, 2, 100, (100, 1, 33), 0.0, 0, None, "wide"),      # G 1
    (2, 32, 2, 70, (70, 9), 0.0, 0, None, "wide"),           # G 16
    (2, 8, 4, 200, (200, 120), 50.0, 0, (37, 119), "wide"),  # a first slot
    (2, 40, 2, 70, (70, 9), 50.0, 0, None, "cores")])        # G 20
def test_wide_decode_source_matches_plain(fa_lib, B, Hq, Hkv, C, kv, cap,
                                          local, first, body):
    """The bf16 cache's decode at hd 288 on the body ``decode_body``
    names -- ``decode_wide_kernel`` (the tensor cores, G <= 16) or
    ``decode_split_kernel`` (G 20) -- against ``flash_attention_plain``:
    softcap 50, ragged live counts with an empty row, a local window
    that leaves whole chunks below it, GQA groups 1-16, within one bf16
    ulp of max |o| and the same bits on two launches; with a per-row
    first live slot also the partial (o f32, lse): lse within 1e-5,
    +inf where no key is live, o within 2e-2 of max |o| (P meets V in
    bf16)."""
    g = torch.Generator().manual_seed(C + Hq)
    q, k, v = (torch.randn(B, L, H, 288, generator=g).to(torch.bfloat16)
               .transpose(1, 2) for L, H in ((1, Hq), (C, Hkv), (C, Hkv)))
    kvt = torch.tensor(kv, dtype=torch.int32)
    fst = None if first is None else torch.tensor(first, dtype=torch.int32)
    assert FA.decode_body(q, k) == body
    kw = dict(causal=False, window=0, softcap=cap, local_window=local)
    got = FA._fwd_launch(fa_lib, None, q, k, v, kvt, return_lse=False,
                         kv_first=fst, **kw)
    want = FA.flash_attention_plain(q, k, v, kvt, kv_first=fst, **kw)
    _ulp_close(got, want, 2e-2)
    assert torch.equal(got, FA._fwd_launch(fa_lib, None, q, k, v, kvt,
                                           return_lse=False, kv_first=fst,
                                           **kw))
    if fst is None:
        return
    o, lse = FA._fwd_launch(fa_lib, None, q, k, v, kvt, return_lse=True,
                            kv_first=fst, **kw)
    wo, wl = FA.flash_attention_plain(q.float(), k.float(), v.float(), kvt,
                                      return_lse=True, kv_first=fst, **kw)
    assert o.dtype == torch.float32
    assert torch.equal(torch.isinf(lse), torch.isinf(wl))
    fin = torch.isfinite(wl)
    assert float((lse[fin] - wl[fin]).abs().max()) <= 1e-5
    assert float((o - wo).abs().max()) <= 2e-2 * float(wo.abs().max())


@pytest.mark.parametrize("B,Hq,Hkv,L,Lk,kv,kw", [
    (1, 2, 1, 70, 70, None, dict(causal=True, softcap=50.0)),
    (1, 2, 1, 150, 150, None, dict(causal=True, window=32, softcap=50.0)),
    (2, 4, 2, 150, 150, (150, 77), dict(causal=True, softcap=50.0)),
    (2, 4, 2, 130, 130, (0, 100), dict(causal=True, window=37)),
    (1, 4, 2, 70, 130, None, dict(causal=True, softcap=30.0)),
    (1, 2, 2, 90, 12, None, dict(causal=False)),
    (1, 2, 1, 300, 300, None, dict(causal=True, window=64, softcap=50.0))])
def test_wide_prefill_source_matches_plain(fa_lib, B, Hq, Hkv, L, Lk, kv, kw):
    """The hd-288 prefill (``prefill_wide_kernel``: 128-row blocks, each
    consumer warpgroup its own 64 rows, TMA's 64-byte swizzle, one Q K^T
    a score, the softmax beside the products) through ``_fwd_launch``:
    causal, windows that skip and cut tiles, softcap 50 and 30, ragged L
    (70, 150, 300), kv_valid with an empty row, G 1 and 2, Lq != Lk and
    non-causal, each against ``flash_attention_plain`` within one bf16
    ulp of max |o|, its lse within 1e-5 (+inf where no key is live), and
    the same bits on two launches."""
    g = torch.Generator().manual_seed(L + Lk + Hq)
    q, k, v = (torch.randn(B, n, H, 288, generator=g).to(torch.bfloat16)
               .transpose(1, 2) for n, H in ((L, Hq), (Lk, Hkv), (Lk, Hkv)))
    kvt = None if kv is None else torch.tensor(kv, dtype=torch.int32)
    args = (kw["causal"], kw.get("window", 0), kw.get("softcap", 0.0), 0)
    got = FA._fwd_launch(fa_lib, None, q, k, v, kvt, *args, False)
    o, lse = FA._fwd_launch(fa_lib, None, q, k, v, kvt, *args, True)
    want, wl = FA.flash_attention_plain(q, k, v, kvt, return_lse=True, **kw)
    _ulp_close(got, want, 2e-2)
    assert torch.equal(got, o)
    assert torch.equal(torch.isinf(lse), torch.isinf(wl))
    fin = torch.isfinite(wl)
    assert float((lse[fin] - wl[fin]).abs().max()) <= 1e-5
    assert torch.equal(got, FA._fwd_launch(fa_lib, None, q, k, v, kvt,
                                           *args, False))


@pytest.mark.parametrize("B,Hq,Hkv,L,Lk,hd,kv,kw", [
    (1, 2, 2, 200, 200, 64, None, dict(causal=True)),              # G 1
    (1, 4, 1, 150, 150, 128, None, dict(causal=True)),             # G 4
    (1, 6, 1, 130, 130, 128, None, dict(causal=True)),             # G 6
    (1, 16, 1, 70, 70, 64, None, dict(causal=True)),               # G 16
    (1, 2, 2, 300, 300, 120, None, dict(causal=True, window=40)),  # skips
    (1, 2, 1, 260, 260, 128, None, dict(causal=True, window=100)),  # cuts
    (2, 4, 2, 130, 130, 64, (0, 100), dict(causal=True, window=37)),
    (2, 4, 2, 80, 210, 128, (200, 7), dict(causal=True)),
    (1, 6, 1, 200, 200, 120, (150,), dict(causal=True)),
    (1, 2, 2, 90, 12, 64, None, dict(causal=False)),
    (1, 4, 4, 16, 16, 128, None, dict(causal=False)),
    (1, 4, 2, 70, 300, 128, None, dict(causal=True, softcap=30.0))])
def test_wgmma_prefill_source_matches_plain(fa_lib, B, Hq, Hkv, L, Lk, hd,
                                            kv, kw):
    """The hd 64/120/128 prefill (``prefill_wgmma_kernel``: its
    ``prefill_turns`` body at hd 120/128, ``prefill_pair`` at 64) through
    ``_fwd_launch``: GQA groups 1, 4, 6 and 16; causal; a window that
    skips whole 128-key tiles (300 rows, window 40) and one that cuts
    them; ``kv_valid`` with an empty row; ragged L (70-300 rows, past
    one and two 128-row blocks), Lq != Lk, non-causal cross and encoder
    shapes, a softcap.  Against ``flash_attention_plain`` within one
    bf16 ulp of max |o|; with its lse the same output and the lse within
    1e-5 (+inf where no key is live); the same bits on two launches."""
    g = torch.Generator().manual_seed(L + Lk + Hq + hd)
    q, k, v = (torch.randn(B, n, H, hd, generator=g).to(torch.bfloat16)
               .transpose(1, 2) for n, H in ((L, Hq), (Lk, Hkv), (Lk, Hkv)))
    kvt = None if kv is None else torch.tensor(kv, dtype=torch.int32)
    assert all(FA._tma_ok(t) for t in (q, k, v))
    args = (kw["causal"], kw.get("window", 0), kw.get("softcap", 0.0), 0)
    got = FA._fwd_launch(fa_lib, None, q, k, v, kvt, *args, False)
    o, lse = FA._fwd_launch(fa_lib, None, q, k, v, kvt, *args, True)
    want, wl = FA.flash_attention_plain(q, k, v, kvt, return_lse=True, **kw)
    _ulp_close(got, want, 2e-2)
    assert torch.equal(got, o)
    assert torch.equal(torch.isinf(lse), torch.isinf(wl))
    fin = torch.isfinite(wl)
    assert float((lse[fin] - wl[fin]).abs().max()) <= 1e-5
    if kv is not None and 0 in kv:
        assert not got[kv.index(0)].any()
    assert torch.equal(got, FA._fwd_launch(fa_lib, None, q, k, v, kvt,
                                           *args, False))


@pytest.mark.parametrize("B,Hq,Hkv,C,hd,kv,q8", [
    (2, 2, 2, 16, 64, (16, 0), False),
    (3, 12, 3, 16, 128, (16, 1, 9), False),
    (2, 4, 2, 16, 64, (1, 16), True),
    (3, 6, 3, 16, 128, (16, 0, 9), True),
    (2, 264, 132, 100, 128, (100, 1), False),
    (2, 264, 132, 100, 64, (0, 77), True)])
def test_one_split_decode_source(fa_lib, B, Hq, Hkv, C, hd, kv, q8):
    """A decode whose split plan has one split (16 keys, as seamless's
    cross decode; 100 keys over B x Hkv = 264 blocks) on
    ``decode_mma_kernel``, bf16 and int8 caches: ``one_launch`` holds,
    so the body writes the output itself.  Within one bf16 ulp of max
    |o| of the plain version, an empty row 0 and a one-key row that
    key's V row; the same bits on two launches and as the two-launch
    path (the body's partial merged by ``decode_combine_kernel`` into
    f32 with the lse, rounded to bf16: A / L of one split either way)."""
    g = torch.Generator().manual_seed(C + hd + Hq)
    q = torch.randn(B, 1, Hq, hd, generator=g).to(torch.bfloat16) \
        .transpose(1, 2)
    kf, vf = (torch.randn(B, C, Hkv, hd, generator=g) for _ in range(2))
    kvt = torch.tensor(kv, dtype=torch.int32)
    if q8:
        (k8, ks), (v8, vs) = TL.quantize_kv(kf), TL.quantize_kv(vf)
        ops = [t.transpose(1, 2) for t in (k8, v8, ks, vs)]
        body = FA.q8_body(q, ops[0])
        n_split, _ = FA.q8_splits(B, Hkv, C, hd, body)

        def launch(lse):
            return FA._q8_launch(fa_lib, None, q, *ops, kvt, 0.0, 0, body,
                                 None, lse)
        want = FA.decode_q8_plain(q, *ops, kvt)
        vrow = FA.dequantize_kv(ops[1], ops[3])
    else:
        k, vv = (t.to(torch.bfloat16).transpose(1, 2) for t in (kf, vf))
        body = FA.decode_body(q, k)
        n_split, _ = FA.decode_splits(B, Hkv, C)

        def launch(lse):
            return FA._fwd_launch(fa_lib, None, q, k, vv, kvt, False, 0,
                                  0.0, 0, lse)
        want = FA.flash_attention_plain(q, k, vv, kvt, causal=False)
        vrow = vv
    assert body == "mma" and FA.one_launch(n_split, False, body, hd, fa_lib)
    assert not FA.one_launch(n_split, True, body, hd, fa_lib)
    got = launch(False)
    assert got.dtype == torch.bfloat16
    _ulp_close(got, want, 2e-2)
    G = Hq // Hkv
    for b, n in enumerate(kv):
        if n == 0:
            assert not got[b].any()
        if n == 1:                      # softmax over one key: its V row
            assert torch.equal(got[b, :, 0], vrow[b, :, 0].repeat_interleave(
                G, dim=0).to(torch.bfloat16))
    assert torch.equal(got, launch(False))
    o, _ = launch(True)
    assert torch.equal(got, o.to(torch.bfloat16))
