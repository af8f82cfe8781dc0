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

The backward (``ssd_scan_bwd``, plain version ``ssd_scan_bwd_plain``)
takes a scan without ``h0`` (training starts from a zero state) and
the gradients of y and of the final state, and gives dx, ddt, dA, dB
and dC, evaluated in chunks of ``BWD_CHUNK`` (any chunking computes the
same function).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SMEM_LIMIT = 231_424                    # csrc/ssd_scan.cu SMEM_OPTIN

TILE_P, TILE_N = 64, 128                # csrc/ssd_scan.cu PT, NT tiles
BWD_CHUNK = 64                          # csrc/ssd_scan_bwd.cuh Q
BWD_TILE = 4 * 256                      # csrc/ssd_scan_bwd.cuh PASS_TILE
BWD_HEADS = 8                           # csrc/ssd_scan_bwd.cuh HG
_SIG = {"ssd_scan_launch": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 8 + [ctypes.c_void_p],
        "ssd_scan_smem": [ctypes.c_int] * 2,
        "ssd_scan_bwd_smem": [ctypes.c_int] * 3,
        "ssd_scan_bwd_levels": [ctypes.c_int] * 2,
        "ssd_scan_bwd_launch": [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(x, dt, A, B, C, h0=None, *, chunk: int = 256):
    """Plain PyTorch version, in the chunked form the kernel computes
    (``ref.ssd_scan``'s recurrence regrouped per chunk, all f32):

      la       = cumsum(dt * A)                         within the chunk
      y_inter  = exp(la_i) C_i . h
      y_intra  = sum_{j <= i} (C_i . B_j) exp(la_i - la_j) dt_j x_j
      h        = exp(la_last) h + sum_j exp(la_last - la_j) dt_j x_j B_j^T
    """
    x, dt, B, C, A = (_acc(t) for t in (x, dt, B, C, A))
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    h = torch.zeros((Bb, H, P, N), dtype=x.dtype, device=x.device) \
        if h0 is None else _acc(h0)
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


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' working type: f32, or f64 for f64 operands
    (the gradient checks)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, dh=None, *,
                       chunk: int = BWD_CHUNK):
    """The backward of a scan without h0 in plain PyTorch, the kernel's
    chunked arithmetic (``csrc/ssd_scan_bwd.cuh``): the state entering
    each chunk (a forward pass), the gradient of the state leaving it
    (a reverse pass from ``dh``, the final state's gradient, or zero),
    then each chunk's products.  Returns (dx, ddt, dA, dB, dC) in the
    types of x, dt, A, B and C."""
    xf, dtf, Bf, Cf, Af, dyf = (_acc(t) for t in (x, dt, B, C, A, dy))
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    dev, f = x.device, xf.dtype
    starts = list(range(0, L, chunk))

    def piece(c0):
        sl = slice(c0, c0 + chunk)
        la = torch.cumsum(dtf[:, sl] * Af, dim=1)               # (Bb, c, H)
        return sl, la, la[:, -1]
    # the state entering each chunk, and the final state
    h = torch.zeros((Bb, H, P, N), dtype=f, device=dev)
    hin = []
    for c0 in starts:
        sl, la, lq = piece(c0)
        hin.append(h)
        w = torch.exp(lq[:, None] - la) * dtf[:, sl]
        h = h * torch.exp(lq)[:, :, None, None] + torch.einsum(
            "bjh,bjhp,bjn->bhpn", w, xf[:, sl], Bf[:, sl])
    hin.append(h)
    # the gradient of the state leaving each chunk, last chunk first
    g = torch.zeros_like(h) if dh is None else _acc(dh)
    dho = [None] * len(starts)
    dlaq = [None] * len(starts)
    for i in reversed(range(len(starts))):
        sl, la, lq = piece(starts[i])
        dho[i] = g
        dlaq[i] = (g * hin[i + 1]).sum(dim=(2, 3))              # (Bb, H)
        g = g * torch.exp(lq)[:, :, None, None] + torch.einsum(
            "bih,bihp,bin->bhpn", torch.exp(la), dyf[:, sl], Cf[:, sl])
    dx, ddt, dB, dC = [], [], [], []
    dA = torch.zeros((H,), dtype=f, device=dev)
    for i, c0 in enumerate(starts):
        sl, la, lq = piece(c0)
        xc, dyc, bc, cc, dtc = xf[:, sl], dyf[:, sl], Bf[:, sl], Cf[:, sl], \
            dtf[:, sl]
        n = xc.shape[1]
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=dev).tril()[None, :, :, None]
        seg = la[:, :, None, :] - la[:, None, :, :]             # (Bb, i, j, H)
        dec = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                          0.0)
        s1 = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * dec
        gg = torch.einsum("bihp,bjhp->bijh", dyc, xc)
        w = dec * dtc[:, None] * gg                             # W
        s3 = s1 * gg
        col = s3.sum(dim=1)                                     # (Bb, j, H)
        dla = (s3 * dtc[:, None]).sum(dim=2) - dtc * col
        dxc = dtc[..., None] * torch.einsum("bijh,bihp->bjhp", s1, dyc)
        dbc = torch.einsum("bijh,bin->bjhn", w, cc)
        dcc = torch.einsum("bijh,bjn->bihn", w, bc)
        hi, do = hin[i], dho[i]
        ea, eq = torch.exp(la), torch.exp(lq[:, None] - la)     # (Bb, c, H)
        dcc = dcc + ea[..., None] * torch.einsum("bihp,bhpn->bihn", dyc, hi)
        dla = dla + ea * torch.einsum("bihp,bin,bhpn->bih", dyc, cc, hi)
        db_ = torch.einsum("bjn,bhpn->bjhp", bc, do)            # dh_out B_j
        v = eq * (xc * db_).sum(-1)
        col = col + v
        dla = dla - dtc * v
        dxc = dxc + (eq * dtc)[..., None] * db_
        dbc = dbc + (eq * dtc)[..., None] * torch.einsum(
            "bjhp,bhpn->bjhn", xc, do)
        dla[:, -1] = dla[:, -1] + dlaq[i]
        R = torch.flip(torch.cumsum(torch.flip(dla, [1]), 1), [1])
        ddt.append(col + Af * R)
        dA = dA + (dtc * R).sum(dim=(0, 1))
        dx.append(dxc)
        dB.append(dbc.sum(dim=2))
        dC.append(dcc.sum(dim=2))
    return (torch.cat(dx, 1).to(x.dtype), torch.cat(ddt, 1).to(dt.dtype),
            dA.to(A.dtype), torch.cat(dB, 1).to(B.dtype),
            torch.cat(dC, 1).to(C.dtype))


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


def ssd_scan_bwd(x, dt, A, B, C, dy, dh=None):
    """Gradients (dx, ddt, dA, dB, dC) of a scan without h0, given the
    gradients of y (Bb, L, H, P) and of the final state (Bb, H, P, N) or
    None (zero), in the types of x, dt, A, B and C.  CPU tensors take
    ``ssd_scan_bwd_plain``; CUDA tensors launch the four backward
    kernels or raise."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, B, C, dy, dh)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: tensors must be on cuda or cpu, "
                         f"not {x.device}")
    lib = build.load("ssd_scan", _SIG)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        out = _bwd_launch(lib, stream, x, dt, A, B, C, dy, dh)
    ssd_scan_bwd.launches += 1
    return out


def _bwd_launch(lib, stream, x, dt, A, B, C, dy, dh):
    """Check the operands, allocate the outputs and the scratch, and
    call ``ssd_scan_bwd_launch`` of ``lib`` on ``stream``."""
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    if L == 0:
        raise ValueError("ssd_scan_bwd kernel: L must be >= 1")
    _check(x, dt, A, B, C, None, 1)
    dev, f32 = x.device, torch.float32
    dy = dy.to(f32).contiguous()
    if dy.shape != x.shape or dy.device != dev:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} must match x")
    if dh is not None:
        dh = dh.to(f32).contiguous()
        if dh.shape != (Bb, H, P, N) or dh.device != dev:
            raise ValueError(f"ssd_scan_bwd: dh {tuple(dh.shape)} must be "
                             f"{(Bb, H, P, N)}")
    # heads a block: up to BWD_HEADS, fewer where their vectors would
    # not fit beside the widest tiles
    lib.ssd_scan_bwd_smem.restype = ctypes.c_longlong
    hg = min(BWD_HEADS, H)
    smem = lib.ssd_scan_bwd_smem(int(x.dtype == f32), N, hg)
    while hg > 1 and smem > SMEM_LIMIT:
        hg -= 1
        smem = lib.ssd_scan_bwd_smem(int(x.dtype == f32), N, hg)
    if smem < 0 or smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan_bwd kernel: N={N} needs "
                         f"{'more than' if smem < 0 else smem} bytes of "
                         f"shared memory per block, above {SMEM_LIMIT}")
    nb, N8, ngrp = -(-L // BWD_CHUNK), -(-N // 8) * 8, -(-H // hg)
    nz = -(-(P * N8) // BWD_TILE)
    dx = torch.empty((Bb, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bb, L, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((Bb, L, N), dtype=B.dtype, device=dev)
    dC = torch.empty((Bb, L, N), dtype=C.dtype, device=dev)
    # scratch: la per (batch, head); each chunk's own contributions to
    # the state and to its gradient (f32); the state entering each chunk
    # and the gradient of the state leaving it (2 or 3 bf16 planes each,
    # the terms of a split f32 value); <dh_out, h_in> per 1,024 state
    # elements; the head groups' dB and dC; dA per (batch, chunk, head)
    la = torch.empty((Bb, H, L), dtype=f32, device=dev)
    sr = torch.empty((2, Bb, nb, H, P, N8), dtype=f32, device=dev)
    levels = lib.ssd_scan_bwd_levels(int(x.dtype == f32), N)
    hs = torch.empty((2 * levels, Bb, nb, H, P, N8), dtype=torch.bfloat16,
                     device=dev)
    dlaq = torch.empty((Bb, H, nb, nz), dtype=f32, device=dev)
    dbp = torch.empty((Bb, L, ngrp, N), dtype=f32, device=dev)
    dcp = torch.empty((Bb, L, ngrp, N), dtype=f32, device=dev)
    dap = torch.empty((Bb, nb, H), dtype=f32, device=dev)
    err = lib.ssd_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(), None if dh is None else dh.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), la.data_ptr(), sr.data_ptr(), hs.data_ptr(),
        dlaq.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(),
        _DTYPE[x.dtype], Bb, L, H, P, N, hg, x.stride(0), x.stride(1),
        dt.stride(0), dt.stride(1), B.stride(0), B.stride(1), C.stride(0),
        C.stride(1), stream)
    build.check(err, "ssd_scan_bwd")
    return dx, ddt, dA, dB, dC


ssd_scan_bwd.launches = 0
