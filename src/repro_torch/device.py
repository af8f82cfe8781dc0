"""Device resolution for every ``repro_torch`` entry point.

The port serves on an NVIDIA GPU.  Every entry point takes
``device=None``, which means ``"cuda"``; without a card it raises
instead of carrying on quietly on the CPU.  ``device="cpu"`` is an
explicit request for the plain PyTorch versions of the kernels (what
the CPU tests run).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent.
    A card without an index gets the current one (``cuda:0``), so two
    parts built with ``device=None`` compare equal to the device their
    tensors report."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available — pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_fp32_precision() -> None:
    """Full fp32 matmuls on the card: TF32 keeps ~3 decimal digits and
    would break parity with the reference (set explicitly, both for
    cuBLAS and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
