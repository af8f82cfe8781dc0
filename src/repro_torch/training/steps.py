"""Step factories: the prefill step and the greedy decode (serve) step.

Port of the JAX package's ``training/steps.py`` without the training
step (ROADMAP.md, Queue 1, item 7).  PyTorch runs eagerly, so these are
the functions the runner calls, not programs to compile.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.routing import not_ported
from repro_torch.models import model as M


def make_train_step(cfg: ModelConfig, *args, **kwargs):
    raise not_ported("The training step", "'Analyzer training' (item 7)")


def make_prefill_step(cfg: ModelConfig, *, max_len: int = 0):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        logits, cache = M.decode_step(params, cfg, cache, batch)
        # greedy next token
        next_tok = torch.argmax(logits, dim=-1)[:, None]
        return logits, next_tok, cache
    return serve_step
