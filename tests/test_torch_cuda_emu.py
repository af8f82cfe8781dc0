"""The backward kernels' CUDA sources run on the CPU through an emulation
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
rule at the zoo's training shapes.  Skips where g++ is missing."""
import shutil

import pytest
import torch

import _cuda_emu
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SS


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
