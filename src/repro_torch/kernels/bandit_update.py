"""Batched bandit posterior delta + LinUCB scores: wrapper of the CUDA
kernel in ``csrc/bandit_update.cu`` and its plain PyTorch version.

Replaces the Pallas ``bandit_update_pallas`` (the JAX package's
``kernels/bandit_update.py``).  Given a finished outcome batch (contexts
``x_up`` (Bu, D), choice mask ``w`` (Bu, N), rewards ``r`` (Bu,)) and an
incoming batch ``x_score`` (Bs, D), under the current posterior
``theta`` (N, D) / ``ainv`` (N, D, D):

  dA[n]     = sum_b w[b, n] x_up[b] x_up[b]^T
  db[n]     = sum_b w[b, n] r[b] x_up[b]
  ucb[q, n] = x_score[q] . theta[n] + alpha sqrt(x_score[q]^T ainv[n] x_score[q])

(the variance as a (Bs, D^2) x (D^2, N) product over flattened outer
products, alpha^2 folded into ainv).  CUDA tensors launch the kernel
(or raise); CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_D = 12                              # csrc/bandit_update.cu MAX_D

_SIG = {"bandit_update_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]}


def _outer(x: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B, D*D) flattened outer products."""
    return (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], x.shape[1] ** 2)


def bandit_update_plain(w, x_up, r, x_score, theta, ainv, alpha: float):
    """Plain PyTorch version: three matmuls over the flattened layout.
    Returns (dA (N, D*D), db (N, D), ucb (Bs, N))."""
    N, D = w.shape[1], x_up.shape[1]
    da = w.T @ _outer(x_up)
    db = w.T @ (x_up * r[:, None])
    if x_score.shape[0] == 0:
        return da, db, w.new_empty((0, N))
    ainv2 = (alpha * alpha) * ainv.reshape(N, D * D)
    ucb = x_score @ theta.T + torch.sqrt(
        torch.clamp(_outer(x_score) @ ainv2.T, min=0.0))
    return da, db, ucb


def _launch(w, x_up, r, x_score, theta, ainv, alpha: float):
    dev = w.device
    N, D = w.shape[1], x_up.shape[1]
    Bu, Bs = x_up.shape[0], x_score.shape[0]
    if not 1 <= D <= MAX_D:
        raise ValueError(f"bandit_update kernel takes 1 <= D <= {MAX_D}, "
                         f"got {D}")
    want = [(w, (Bu, N)), (x_up, (Bu, D)), (r, (Bu,)), (x_score, (Bs, D))]
    if Bs:
        want += [(theta, (N, D)), (ainv, (N, D, D))]
    for t, shape in want:
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"bandit_update: operand {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} must be contiguous "
                             f"float32 {shape} on {dev}")
    lib = build.load("bandit_update", _SIG)
    da = torch.empty((N, D * D), dtype=torch.float32, device=dev)
    db = torch.empty((N, D), dtype=torch.float32, device=dev)
    ucb = torch.empty((Bs, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.bandit_update_launch(
            w.data_ptr(), x_up.data_ptr(), r.data_ptr(), x_score.data_ptr(),
            theta.data_ptr() if Bs else None, ainv.data_ptr() if Bs else None,
            float(alpha) * float(alpha),
            Bu, Bs, N, D, da.data_ptr(), db.data_ptr(), ucb.data_ptr(),
            stream)
    build.check(err, "bandit_update")
    return da, db, ucb


def bandit_update(w, x_up, r, x_score, theta, ainv, alpha: float):
    """w (Bu, N), x_up (Bu, D), r (Bu,), x_score (Bs, D), theta (N, D),
    ainv (N, D, D), all f32; alpha >= 0.  Returns (dA (N, D*D),
    db (N, D), ucb (Bs, N)); Bu = 0 gives zero deltas; with Bs = 0,
    theta and ainv may be None (only the deltas are formed)."""
    if w.device.type == "cpu":
        return bandit_update_plain(w, x_up, r, x_score, theta, ainv, alpha)
    if w.device.type != "cuda":
        raise ValueError(f"bandit_update: tensors must be on cuda or cpu, "
                         f"not {w.device}")
    out = _launch(w, x_up, r, x_score, theta, ainv, alpha)
    bandit_update.launches += 1
    return out


bandit_update.launches = 0
