"""The assigned input shapes, as tensors on the ``meta`` device.

Port of the JAX package's ``launch/shapes.py``.  ``input_specs(cfg,
shape_name)`` gives the inputs one step of that shape takes, with the
shapes and dtypes of the reference's ``jax.ShapeDtypeStruct``s, as
``torch.empty(..., device="meta")`` tensors: they carry a shape and a
dtype and allocate nothing.

Shapes (assignment):
  train_4k       seq_len=  4,096  global_batch= 256  (training)
  prefill_32k    seq_len= 32,768  global_batch=  32  (inference-prefill)
  decode_32k     seq_len= 32,768  global_batch= 128  (inference-decode)
  long_500k      seq_len=524,288  global_batch=   1  (long-context-decode)

For an encoder-decoder or a vision prefix the seq_len is the TOTAL
context (frontend tokens + text).  The decode shapes are one token
against a seq_len cache, built by the port's ``init_cache`` on
``meta``; long_500k takes ``cfg.long_serving_config()`` and gemma2's
``long_mode``, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


def sds(shape, dtype) -> torch.Tensor:
    """A shape and a dtype, allocating nothing (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-not). long_500k needs sub-quadratic serving."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention family; 500k dense KV decode " \
                      "is not sub-quadratic-servable (DESIGN.md §4)"
    return True, ""


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text-token budget once frontend tokens are accounted for."""
    if cfg.is_encdec:
        return seq_len // 2
    if cfg.frontend:
        return max(seq_len - cfg.frontend_tokens, 16)
    return seq_len


def train_specs(cfg: ModelConfig, seq_len: int, batch: int) -> Dict[str, Any]:
    Lt = text_len(cfg, seq_len)
    b: Dict[str, Any] = {"tokens": sds((batch, Lt), torch.int32),
                         "labels": sds((batch, Lt), torch.int32)}
    if cfg.is_encdec:
        b["src_embeds"] = sds((batch, seq_len - Lt, cfg.frontend_dim),
                              torch.bfloat16)
    elif cfg.frontend:
        b["frontend"] = sds((batch, cfg.frontend_tokens, cfg.frontend_dim),
                            torch.bfloat16)
    return b


def prefill_specs(cfg: ModelConfig, seq_len: int, batch: int) -> Dict[str, Any]:
    b = train_specs(cfg, seq_len, batch)
    b.pop("labels")
    return b


def decode_specs(cfg: ModelConfig, seq_len: int, batch: int, *,
                 long_mode: bool) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (cache_specs, batch_specs) for one serve step."""
    enc_len = seq_len // 2 if cfg.is_encdec else 0
    cache = M.init_cache(cfg, batch, seq_len, long_mode=long_mode,
                         enc_len=enc_len, device="meta")
    b = {"token": sds((batch, 1), torch.int32),
         "pos": sds((batch,), torch.int32)}
    return cache, b


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Inputs of one step of (cfg, shape): a dict with ``kind`` and the
    specs; a decode shape also gives ``cache``, ``long_mode`` and the
    effective ``cfg``."""
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    long_mode = shape_name == "long_500k" and cfg.long_mode_local_only
    if kind == "train":
        return {"kind": "train",
                "batch": train_specs(cfg, sh["seq_len"], sh["global_batch"])}
    if kind == "prefill":
        return {"kind": "prefill",
                "batch": prefill_specs(cfg, sh["seq_len"], sh["global_batch"])}
    cfg_eff = cfg.long_serving_config() if shape_name == "long_500k" else cfg
    cache, b = decode_specs(cfg_eff, sh["seq_len"], sh["global_batch"],
                            long_mode=long_mode)
    return {"kind": "decode", "cache": cache, "batch": b,
            "long_mode": long_mode, "cfg": cfg_eff}
