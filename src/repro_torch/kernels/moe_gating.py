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

The kernel writes per-block partial sums of the probabilities and the
assignments ((nblk, E), summed in a fixed order, no atomics); the
wrapper sums them over the blocks, as the TPU wrapper does outside its
kernel, so ``aux`` is the same bits on every run.  A wrapper given CUDA
tensors launches the kernel (or raises); CPU tensors take the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.router_topk import topk_stable

MAX_EXPERTS = 1024                       # csrc/moe_gating.cu MAX_E

_SIG = {"moe_gating_launch": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p],
    "moe_gating_block_tokens": []}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _aux(psum: torch.Tensor, asum: torch.Tensor, T: int) -> torch.Tensor:
    """E * sum_e (probs summed over tokens / T) * (assignments / T), as
    one dot product and one scale."""
    return torch.dot(psum, asum) * (psum.shape[-1] / (T * T))


def moe_gating_plain(logits: torch.Tensor, k: int):
    """Plain PyTorch version: softmax, ``topk_stable`` (ties to the lower
    index), renormalization and the aux loss, all in f32."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = topk_stable(probs, k)
    vals = vals / (vals.sum(dim=-1, keepdim=True) + 1e-9)
    assign = torch.zeros_like(probs).scatter_(1, idx, 1.0)
    aux = _aux(probs.sum(dim=0), assign.sum(dim=0), T)
    return vals, idx.to(torch.int32), aux


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


def moe_gating(logits: torch.Tensor, k: int):
    """logits (T, E).  Returns (vals (T, k) f32, idx (T, k) int32, aux)."""
    if logits.device.type not in ("cuda", "cpu"):
        raise ValueError(f"moe_gating: tensors must be on cuda or cpu, not "
                         f"{logits.device}")
    if logits.device.type == "cpu":
        return moe_gating_plain(logits, k)
    vals, idx, part = moe_gating_partials(logits, k)
    tot = part.sum(dim=1)
    return vals, idx, _aux(tot[0], tot[1], logits.shape[0])


def moe_gating_partials(logits: torch.Tensor, k: int):
    """The kernel's own outputs on CUDA logits (T, E): (vals, idx, and
    the per-block sums of probabilities and of assignments as one
    (2, ceil(T / block), E) f32 tensor), before the wrapper reduces them
    to aux."""
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating_partials: the kernel takes CUDA "
                         f"tensors, not {logits.device}")
    _check(logits, k)
    T, E = logits.shape
    lib = build.load("moe_gating", _SIG)
    blk = lib.moe_gating_block_tokens()
    nblk = -(-T // blk)
    dev = logits.device
    vals = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    part = torch.empty((2, nblk, E), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.moe_gating_launch(
            logits.data_ptr(), _DTYPE[logits.dtype], T, E, k,
            logits.stride(0) if T > 1 else E, vals.data_ptr(),
            idx.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), stream)
    build.check(err, "moe_gating")
    moe_gating.launches += 1
    return vals, idx, part


# launches on the card (made in ``moe_gating_partials``)
moe_gating.launches = 0
