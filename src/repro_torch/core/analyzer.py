"""Task Analyzer, inference half (paper §3.2).

Predicts the implicit preferences ``{task_type, domain, complexity}``
of a query with a small transformer encoder
(``kernels/analyze_step.AnalyzerEncoder``) over hash-token ids, with
the paper's two latency optimizations: long-query pruning (first-n +
last-n words + a seeded sample of the middle) and int8 weights
(symmetric per-output-channel).

Training is not ported: weights come from a seeded numpy init
(``init_analyzer_np``) or are carried over from the JAX package's
params pytree with ``params_from_jax``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.preferences import DOMAINS, TASK_TYPES, TaskSignature
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.analyze_step import (GLOBAL_KEYS, LAYER_KEYS,
                                              AnalyzerEncoder)

N_TT = len(TASK_TYPES)
N_DM = len(DOMAINS)


@dataclass(frozen=True)
class AnalyzerConfig:
    vocab_size: int = 4096
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 256
    max_len: int = 96
    # pruning (paper: "first n and last n words ... random sample of middle")
    prune_head: int = 40
    prune_tail: int = 24
    prune_mid: int = 16
    quantize_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ----------------------------------------------------------------------
# query pruning
# ----------------------------------------------------------------------

def prune_text(cfg: AnalyzerConfig, text: str, seed: int = 0) -> str:
    """Edge-preserving pruning of long queries (deterministic).
    Reference for the vectorized ``prune_texts``."""
    words = text.split()
    budget = cfg.prune_head + cfg.prune_tail + cfg.prune_mid
    if len(words) <= budget:
        return text
    head = words[: cfg.prune_head]
    tail = words[-cfg.prune_tail:]
    middle = words[cfg.prune_head: -cfg.prune_tail]
    rng = np.random.default_rng(seed + len(words))
    pick = sorted(rng.choice(len(middle), size=cfg.prune_mid, replace=False))
    mid = [middle[i] for i in pick]
    return " ".join(head + mid + tail)


def prune_texts(cfg: AnalyzerConfig, texts: Sequence[str],
                seed: int = 0) -> List[str]:
    """Batch ``prune_text``: short queries pass through untouched, long
    ones build the keep-index set with numpy fancy indexing."""
    budget = cfg.prune_head + cfg.prune_tail + cfg.prune_mid
    out = list(texts)
    for i, text in enumerate(texts):
        words = text.split()
        n = len(words)
        if n <= budget:
            continue
        # identical draw to prune_text: same rng seed, same choice call
        rng = np.random.default_rng(seed + n)
        pick = np.sort(rng.choice(n - cfg.prune_head - cfg.prune_tail,
                                  size=cfg.prune_mid, replace=False))
        keep = np.concatenate([
            np.arange(cfg.prune_head),
            pick + cfg.prune_head,
            np.arange(n - cfg.prune_tail, n)])
        out[i] = " ".join(np.asarray(words, object)[keep].tolist())
    return out


# ----------------------------------------------------------------------
# weights: seeded init, int8 quantization, transfer from JAX
# ----------------------------------------------------------------------

def init_analyzer_np(cfg: AnalyzerConfig, seed: int = 0) -> Dict:
    """Seeded numpy init with the shapes and scales of the reference's
    ``init_analyzer`` (normal / sqrt(fan_in), embeddings 0.05, positions
    0.02, heads 0.02, unit layer-norm gains).  Its numbers differ from
    ``jax.random``'s: to hold the port against the reference, carry the
    reference's weights over with ``params_from_jax``."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    rng = np.random.default_rng(seed)

    def mat(shape, scale=None):
        std = scale if scale else 1.0 / math.sqrt(shape[0])
        return (rng.standard_normal(shape) * std).astype(np.float32)

    state = {"embed": mat((V, d), 0.05), "pos": mat((cfg.max_len, d), 0.02)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        for name, shape in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                            ("wo", (d, d)), ("wi", (d, f)), ("wp", (f, d))):
            state[p + name] = mat(shape)
        state[p + "ln1"] = np.ones(d, np.float32)
        state[p + "ln2"] = np.ones(d, np.float32)
    state["ln_f"] = np.ones(d, np.float32)
    state["head_tt"] = mat((d, N_TT), 0.02)
    state["head_dm"] = mat((d, N_DM), 0.02)
    state["head_cx"] = mat((d, 1), 0.02)
    return state


def quantize_int8(state: Dict) -> Dict:
    """Symmetric per-output-channel int8 for every 2-D matrix:
    ``s = max|w| over rows / 127 + 1e-12``, ``q = round(w / s)`` (half to
    even).  Other leaves pass through."""
    out = {}
    for name, w in state.items():
        if isinstance(w, np.ndarray) and w.ndim == 2:
            w = w.astype(np.float32)
            s = (np.max(np.abs(w), axis=0, keepdims=True) / np.float32(127.0)
                 + np.float32(1e-12)).astype(np.float32)
            out[name] = (np.rint(w / s).astype(np.int8), s)
        else:
            out[name] = w
    return out


def params_from_jax(tree) -> Dict:
    """Flat port state from the reference's analyzer params pytree
    (``{"embed", "pos", "layers": [...], "ln_f", "head_*"}``, leaves as
    numpy arrays or ``(int8, scale)`` pairs from its ``quantize_int8``).
    The arrays are copied as numpy; nothing of JAX is imported."""
    def leaf(v):
        if isinstance(v, tuple):
            return (np.asarray(v[0], np.int8), np.asarray(v[1], np.float32))
        return np.asarray(v, np.float32)

    state = {name: leaf(tree[name]) for name in GLOBAL_KEYS}
    for i, layer in enumerate(tree["layers"]):
        for name in LAYER_KEYS:
            state[f"layers.{i}.{name}"] = leaf(layer[name])
    return state


# ----------------------------------------------------------------------
# inference
# ----------------------------------------------------------------------

class TaskAnalyzer:
    """The task analyzer, inference only.

    ``params`` is the ``AnalyzerEncoder`` on ``device``; ``state`` (a
    flat weight dict, see ``params_from_jax``) replaces the seeded
    init."""

    # marker the orchestrator checks before fusing analyze into the
    # routing program (stub analyzers lack params/cfg)
    supports_fused_route = True

    def __init__(self, cfg: AnalyzerConfig = AnalyzerConfig(), seed: int = 0,
                 *, state: Optional[Dict] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tok = HashTokenizer(cfg.vocab_size)
        self.state = state if state is not None \
            else init_analyzer_np(cfg, seed)
        self.params = AnalyzerEncoder(cfg, self.state).to(self.device)
        # dispatch counter sink (Telemetry) and span sink (obs.Tracer)
        # of the analyzer program; OptiRoute hands down its own
        self.telemetry = None
        self.tracer = None

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Prune + tokenize: (B, max_len) int32 token ids."""
        pruned = prune_texts(self.cfg, texts)
        return self.tok.encode_batch(pruned, self.cfg.max_len)

    def quantize(self) -> None:
        self.state = quantize_int8(self.state)
        self.params = AnalyzerEncoder(self.cfg, self.state).to(self.device)

    def analyze_batch(self, texts: Sequence[str]) -> List[TaskSignature]:
        if len(texts) == 0:
            return []
        return self.analyze_tokens(self.encode_batch(texts))

    def analyze_tokens(self, tokens: np.ndarray) -> List[TaskSignature]:
        """Tokens -> signatures: the staged half of the decision path."""
        if len(tokens) == 0:
            return []
        out = ops.analyze_step(self.params, tokens, device=self.device,
                               telemetry=self.telemetry, tracer=self.tracer)
        return [TaskSignature(task_type=TASK_TYPES[ti], domain=DOMAINS[di],
                              complexity=cx, confidence=conf)
                for ti, di, cx, conf in zip(
                    out["tt_idx"].tolist(), out["dm_idx"].tolist(),
                    out["cx"].tolist(), out["conf"].tolist())]

