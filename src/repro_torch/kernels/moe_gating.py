"""Fused MoE gate: wrapper of the CUDA kernel in ``csrc/moe_gating.cu``
and its plain PyTorch version.

Replaces the Pallas ``moe_gating_pallas`` (the JAX package's
``kernels/moe_gating.py``).  Same contract: logits (T, E), any float
type, read as f32; per token softmax over E, the k largest
probabilities in descending order with ties toward the lower expert
index (``lax.top_k``'s order), renormalized as ``vals / (sum + 1e-9)``;
and the load-balance loss ``aux = E * sum_e mean_t(prob) *
mean_t(assigned)``.  Returns (vals (T, k) f32, idx (T, k) int32, aux f32
scalar tensor).

The kernel is one launch per call: it writes vals, idx and aux itself
(its last block, by a ticket counter, adds the blocks' partial sums in
a fixed order, so ``aux`` is the same bits on every run).  Its launch
shape is ``gate_plan(T, E, k)``, a function of the shapes alone.  A
wrapper given CUDA tensors launches the kernel (or raises); CPU tensors
take the plain version.

With ``return_asum`` the gate also gives the per-expert assignment
counts (E,) f32 it reduces for aux; the backward (``moe_gating_bwd``,
plain version ``moe_gating_bwd_plain``) reads them.  With
``return_psum`` also the per-expert probability sums (E,) f32, the
other factor of aux, from the same launch: a gate whose tokens are
split over ranks forms the global aux from both sums.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.router_topk import topk_stable  # noqa: F401

MAX_EXPERTS = 1024                       # csrc/moe_gating.cu MAX_E
SM_COUNT = 132                           # H100 SXM
SMEM_MAX = 48 * 1024                     # csrc/moe_gating.cu SMEM_MAX
# (largest E, lanes per token, experts per lane): csrc/moe_gating.cu launch
_LANES = ((8, 1, 8), (16, 2, 8), (32, 4, 8), (64, 8, 8), (128, 16, 8),
          (256, 32, 8), (512, 32, 16), (1024, 32, 32))

_SIG = {"moe_gating_launch": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p],
    "moe_gating_bwd_launch": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def gate_lanes(E: int):
    """(lanes per token, experts per lane) of the kernel for E experts:
    the lanes of a token cover E with whole 16-byte loads of bf16."""
    for emax, lanes, per in _LANES:
        if E <= emax:
            return lanes, per
    raise ValueError(f"moe_gating kernel takes E <= {MAX_EXPERTS}, got {E}")


def gate_plan(T: int, E: int, k: int):
    """(warps per block, blocks) of the gate's launch, from the shapes
    alone.  A warp holds 32 / lanes tokens at once; a block takes as
    many warps as its shared memory allows (each token's k winners and
    each warp's row of probability sums; at most 32 warps, 8 where a lane
    holds more than 8 experts) and no more than T needs; at most two
    blocks per SM, each walking its tokens grid-stride: block b's pass p
    takes tokens [(p * blocks + b) * tpb, ... + tpb), tpb = warps * 32 /
    lanes."""
    lanes, per = gate_lanes(E)
    gpw = 32 // lanes
    ep = lanes * per
    warps = 32 if per <= 8 else 8
    while warps > 1 and (8 * warps * gpw * k + 4 * max(warps, 2) * ep
                         + 4 * ep) > SMEM_MAX:
        warps //= 2
    warps = max(1, min(warps, -(-T // gpw)))
    tpb = warps * gpw
    return warps, max(1, min(-(-T // tpb), 2 * SM_COUNT))


def _aux(psum: torch.Tensor, asum: torch.Tensor, T: int) -> torch.Tensor:
    """E * sum_e (probs summed over tokens / T) * (assignments / T), as
    one dot product and one scale."""
    return torch.dot(psum, asum) * (psum.shape[-1] / (T * T))


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' working type: f32, or f64 for f64 operands
    (the gradient checks)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def moe_gating_plain(logits: torch.Tensor, k: int,
                     return_asum: bool = False, idx=None,
                     return_psum: bool = False):
    """Plain PyTorch version: softmax, the first k of a stable
    descending sort (ties to the lower index, ``topk_stable``'s order; a
    sort of E <= 1024 experts, whose shapes follow from the operands'
    alone, as the dry run's fake tensors need), renormalization and the
    aux loss, all in f32.  With
    ``return_asum`` also the assignment counts (E,), with
    ``return_psum`` then the probability sums (E,).  A given ``idx``
    (T, k) stands in for the top-k's choice: the rest is computed for
    those experts."""
    T, E = logits.shape
    probs = torch.softmax(_acc(logits), dim=-1)
    if idx is None:
        vals, idx = torch.sort(probs, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
    else:
        idx = idx.long()
        vals = probs.gather(1, idx)
    vals = vals / (vals.sum(dim=-1, keepdim=True) + 1e-9)
    asum = torch.zeros_like(probs).scatter_(1, idx, 1.0).sum(dim=0)
    psum = probs.sum(dim=0)
    aux = _aux(psum, asum, T)
    out = vals, idx.to(torch.int32), aux
    if return_asum:
        out += (asum,)
    return out + (psum,) if return_psum else out


def moe_gating_bwd_plain(logits, idx, dvals, daux, asum):
    """The gate's backward in plain PyTorch, the kernel's arithmetic: p =
    softmax(logits); with r = p[idx], S = sum r and vals = r / (S +
    1e-9), dr = dvals / (S + 1e-9) - sum(dvals r) / (S + 1e-9)^2 into
    dp at idx, plus daux E asum / T^2 on every expert; then dlogits = p
    (dp - sum p dp).  Returns dlogits in logits' type."""
    T, E = logits.shape
    p = torch.softmax(_acc(logits), dim=-1)
    ix = idx.long()
    r = p.gather(1, ix)
    den = r.sum(dim=-1, keepdim=True) + 1e-9
    dv = _acc(dvals)
    dr = dv / den - (dv * r).sum(dim=-1, keepdim=True) / (den * den)
    dp = (_acc(daux) * (E / (T * T)) * _acc(asum)).expand(T, E).clone()
    dp = dp.scatter_add(1, ix, dr)
    d = (p * dp).sum(dim=-1, keepdim=True)
    return (p * (dp - d)).to(logits.dtype)


def _check(logits: torch.Tensor, k: int) -> None:
    if logits.dtype not in _DTYPE:
        raise TypeError(f"moe_gating kernel: logits must be float32 or "
                        f"bfloat16, got {logits.dtype}")
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"moe_gating kernel: logits must be (T, E) with a "
                         f"contiguous expert axis, got shape "
                         f"{tuple(logits.shape)} strides {logits.stride()}")
    T, E = logits.shape
    if T < 1:
        raise ValueError("moe_gating kernel: no tokens (T = 0)")
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= E:
        raise ValueError(f"moe_gating kernel takes 1 <= k <= E <= "
                         f"{MAX_EXPERTS}, got E={E}, k={k}")


def moe_gating(logits: torch.Tensor, k: int, return_asum: bool = False,
               return_psum: bool = False):
    """logits (T, E).  Returns (vals (T, k) f32, idx (T, k) int32, aux),
    then the assignment counts asum (E,) f32 with ``return_asum`` and
    the probability sums psum (E,) f32 with ``return_psum`` (the same
    launch)."""
    if logits.device.type not in ("cuda", "cpu"):
        raise ValueError(f"moe_gating: tensors must be on cuda or cpu, not "
                         f"{logits.device}")
    if logits.device.type == "cpu":
        return moe_gating_plain(logits, k, return_asum,
                                return_psum=return_psum)
    _check(logits, k)
    T, E = logits.shape
    lanes, per = gate_lanes(E)
    warps, blocks = gate_plan(T, E, k)
    lib = build.load("moe_gating", _SIG)
    dev = logits.device
    vals = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    aux = torch.empty((), dtype=torch.float32, device=dev)
    sums = torch.empty((2, E), dtype=torch.float32, device=dev) \
        if return_asum or return_psum else None
    part = torch.empty((blocks, 2, lanes * per), dtype=torch.float32,
                       device=dev) if blocks > 1 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.moe_gating_launch(
            logits.data_ptr(), _DTYPE[logits.dtype], T, E, k,
            logits.stride(0) if T > 1 else E, E / (T * T), vals.data_ptr(),
            idx.data_ptr(), part.data_ptr() if part is not None else None,
            aux.data_ptr(), None if sums is None else sums.data_ptr(), warps,
            blocks, stream)
    build.check(err, "moe_gating")
    moe_gating.launches += 1
    out = vals, idx, aux
    if return_asum:
        out += (sums[0],)
    return out + (sums[1],) if return_psum else out


# launches on the card
moe_gating.launches = 0


def _bwd_launch(lib, stream, logits, idx, dvals, daux, asum):
    """One backward through ``lib`` (the card's library, or any ctypes
    handle with its entry point) on checked operands: idx (T, k) int32,
    dvals (T, k) f32, daux a 0-d f32 and asum (E,) f32, all contiguous;
    allocates dlogits (T, E) in logits' type and raises on a non-zero
    return."""
    T, E = logits.shape
    k = idx.shape[-1]
    dlogits = torch.empty((T, E), dtype=logits.dtype, device=logits.device)
    err = lib.moe_gating_bwd_launch(
        logits.data_ptr(), _DTYPE[logits.dtype], T, E, k,
        logits.stride(0) if T > 1 else E, idx.data_ptr(), dvals.data_ptr(),
        daux.data_ptr(), asum.data_ptr(), E / (T * T), dlogits.data_ptr(),
        stream)
    build.check(err, "moe_gating_bwd")
    return dlogits


def moe_gating_bwd(logits, idx, dvals, daux, asum):
    """dlogits (T, E), in logits' type (contiguous), from the forward's
    logits, idx and asum and the gradients dvals (T, k) and daux (a
    0-d tensor, read on the card).  CPU tensors take
    ``moe_gating_bwd_plain``; CUDA tensors launch the kernel or raise."""
    if logits.device.type == "cpu":
        return moe_gating_bwd_plain(logits, idx, dvals, daux, asum)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating_bwd: tensors must be on cuda or cpu, "
                         f"not {logits.device}")
    _check(logits, idx.shape[-1])
    T, E = logits.shape
    k = idx.shape[-1]
    dev = logits.device
    idx = idx.to(torch.int32).contiguous()
    dvals = dvals.to(torch.float32).contiguous()
    daux = daux.to(torch.float32).reshape(()).contiguous()
    asum = asum.to(torch.float32).contiguous()
    for t, shape in ((idx, (T, k)), (dvals, (T, k)), (asum, (E,))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"moe_gating_bwd: operand {tuple(t.shape)} on "
                             f"{t.device} must be {shape} on {dev}")
    with torch.cuda.device(dev):
        dlogits = _bwd_launch(build.load("moe_gating", _SIG),
                              torch.cuda.current_stream(dev).cuda_stream,
                              logits, idx, dvals, daux, asum)
    moe_gating_bwd.launches += 1
    return dlogits


# launches on the card
moe_gating_bwd.launches = 0
