"""The scan backward's CUDA source (``csrc/ssd_scan_bwd.cuh``) run on
the CPU through an emulation of the CUDA execution model
(``tests/_cuda_emu.py``: g++, fibers for threads, warp collectives for
``ldmatrix``, ``mma.sync`` and shuffles), held against the plain
backward as ``tests/test_torch_cuda.py`` holds the card's: each gradient
within 1e-4 of its max |g| in f32 (three-term split operands up to N =
128, two past it) and 2e-2 in bf16, and the same bits on two launches.
The tiles' paths: mamba2's 64 x 128 tile over three chunks with a ragged
last one, a head count over two groups of 8, rows off 16 bytes, P in two
slices on the wide-N tile.  Skips where g++ is missing."""
import shutil

import pytest
import torch

import _cuda_emu
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
