"""Mamba2 SSD chunked scan: wrapper of the CUDA kernel in
``csrc/ssd_scan.cu`` and its plain PyTorch version.

Replaces the Pallas ``ssd_scan_pallas`` (the JAX package's
``kernels/ssd_scan.py``).  Same contract as the JAX package's
``ref.ssd_scan``: the recurrence

  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t . h_t

over x (Bb, L, H, P), dt (Bb, L, H) (already softplus'd), A (H,)
(negative), B / C (Bb, L, N) shared by the heads and h0 (Bb, H, P, N)
or None (zeros); returns (y (Bb, L, H, P) f32, h_final (Bb, H, P, N)
f32).  L need not be a multiple of ``chunk``: the last chunk is short,
which is exactly the TPU kernel's dt = 0 padding.

x, B and C may be f32 or bf16 views strided along (batch, position) --
the model's split of its input projection -- with the last axis
contiguous (x's heads contiguous too).  Any P and N: the kernel's
tensor-core tiles are 64 (P) x 128 (N) (every model of the zoo fits one:
P = 64, N = 16 or 128), and larger ones take more tiles.  A wrapper
given CUDA tensors launches the kernel (C B^T per chunk, every chunk's
state with the state passing, every chunk's outputs; a split of f32
operands into bf16 planes first) or raises; CPU tensors take the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SMEM_LIMIT = 231_424                    # csrc/ssd_scan.cu SMEM_OPTIN

TILE_P, TILE_N = 64, 128                # csrc/ssd_scan.cu PT, NT tiles
_SIG = {"ssd_scan_launch": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 8 + [ctypes.c_void_p],
        "ssd_scan_smem": [ctypes.c_int] * 2}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(x, dt, A, B, C, h0=None, *, chunk: int = 256):
    """Plain PyTorch version, in the chunked form the kernel computes
    (``ref.ssd_scan``'s recurrence regrouped per chunk, all f32):

      la       = cumsum(dt * A)                         within the chunk
      y_inter  = exp(la_i) C_i . h
      y_intra  = sum_{j <= i} (C_i . B_j) exp(la_i - la_j) dt_j x_j
      h        = exp(la_last) h + sum_j exp(la_last - la_j) dt_j x_j B_j^T
    """
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    A = A.float()
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for c0 in range(0, L, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bc, cc = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        cl = xc.shape[1]
        la = torch.cumsum(dtc * A, dim=1)                       # (Bb, c, H)
        y = torch.exp(la)[..., None] * torch.einsum("bin,bhpn->bihp", cc, h)
        causal = torch.ones((cl, cl), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        seg = la[:, :, None, :] - la[:, None, :, :]             # (Bb, i, j, H)
        # mask the exponent before exp: j > i never enters it
        dec = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                          0.0) * dtc[:, None, :, :]
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        y = y + torch.einsum("bij,bijh,bjhp->bihp", cb, dec, xc)
        last = la[:, -1]                                        # (Bb, H)
        w = torch.exp(last[:, None, :] - la) * dtc              # (Bb, c, H)
        h = h * torch.exp(last)[:, :, None, None] + torch.einsum(
            "bjn,bjhp,bjh->bhpn", bc, xc, w)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros((Bb, 0, H, P))
    return y, h


def _check(x, dt, A, B, C, h0, chunk):
    dev = x.device
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    if x.dtype not in _DTYPE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_scan kernel: x, B, C must all be float32 or "
                        f"bfloat16, got {x.dtype}/{B.dtype}/{C.dtype}")
    want = [(dt, (Bb, L, H), torch.float32), (A, (H,), torch.float32),
            (B, (Bb, L, N), x.dtype), (C, (Bb, L, N), x.dtype)]
    if h0 is not None:
        want.append((h0, (Bb, H, P, N), torch.float32))
    for t, shape, dtype in want:
        if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"ssd_scan: operand {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} must be {shape} "
                             f"{dtype} on {dev}")
    if x.stride(3) != 1 or x.stride(2) != P or dt.stride(2) != 1 or \
            B.stride(2) != 1 or C.stride(2) != 1 or not A.is_contiguous() \
            or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("ssd_scan: the last axis of every operand (and "
                         "x's head axis) must be contiguous")


def _direct(x, B, C) -> bool:
    """Whether the kernel copies bf16 x, B and C as they are: rows of a
    multiple of 8 values (each head of x), every row on 16 bytes.  Else
    it first writes them once as contiguous bf16 planes (and always for
    f32 operands, split into hi and lo planes)."""
    P, N = x.shape[3], B.shape[2]
    return x.dtype == torch.bfloat16 and P % 8 == 0 and N % 8 == 0 and \
        all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
            and t.stride(1) % 8 == 0 for t in (x, B, C))


def ssd_scan(x, dt, A, B, C, h0=None, *, chunk: int = 256):
    """The chunked scan.  Returns (y (Bb, L, H, P) f32, h_final
    (Bb, H, P, N) f32)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssd_scan: tensors must be on cuda or cpu, not "
                         f"{x.device}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, h0, chunk=chunk)
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    if L == 0:
        raise ValueError("ssd_scan kernel: L must be >= 1")
    chunk = min(chunk, L)
    _check(x, dt, A, B, C, h0, chunk)
    lib = build.load("ssd_scan", _SIG)
    lib.ssd_scan_smem.restype = ctypes.c_longlong
    lo = x.dtype == torch.float32
    smem = lib.ssd_scan_smem(int(lo), chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel: chunk={chunk} needs {smem} "
                         f"bytes of shared memory per block, above "
                         f"{SMEM_LIMIT}")
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    P8, N8, nc = -(-P // 8) * 8, -(-N // 8) * 8, -(-L // chunk)
    y = torch.empty((Bb, L, H, P), dtype=f32, device=dev)
    hf = torch.empty((Bb, H, P, N), dtype=f32, device=dev)
    # scratch: bf16 operand planes (where x, B, C are not used as they
    # are), each chunk's own state, C B^T per (batch, chunk), la and dt
    # head-major, the state entering each chunk (bf16 hi and lo), one
    # ticket per (batch, head, state tile)
    planes = None if _direct(x, B, C) else torch.empty(
        (2 if lo else 1) * Bb * L * (H * P8 + 2 * N8), dtype=bf, device=dev)
    s_ = torch.empty((Bb, nc, H, P, N), dtype=f32, device=dev)
    gp = -(-chunk // 64) * 64
    g = torch.empty(Bb * nc * gp * gp + 128 * gp, dtype=f32, device=dev)
    la = torch.empty((Bb, H, L), dtype=f32, device=dev)
    dtt = torch.empty((Bb, H, L), dtype=f32, device=dev)
    hin = torch.empty((2, Bb, nc, H, P, N8), dtype=bf, device=dev)
    tiles = -(-P // TILE_P) * -(-N // TILE_N)
    tickets = torch.zeros((Bb, H, tiles), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), h0.data_ptr() if h0 is not None else None,
            planes.data_ptr() if planes is not None else None,
            s_.data_ptr(), g.data_ptr(), la.data_ptr(), dtt.data_ptr(),
            hin.data_ptr(),
            tickets.data_ptr(), y.data_ptr(), hf.data_ptr(),
            _DTYPE[x.dtype], Bb, L, H, P, N, chunk,
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), stream)
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, hf


ssd_scan.launches = 0
