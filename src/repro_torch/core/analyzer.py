"""Task Analyzer, inference half (paper §3.2).

Predicts the implicit preferences ``{task_type, domain, complexity}``
of a query with a small transformer encoder
(``kernels/analyze_step.AnalyzerEncoder``) over hash-token ids, with
the paper's two latency optimizations: long-query pruning (first-n +
last-n words + a seeded sample of the middle) and int8 weights
(symmetric per-output-channel).

Weights come from a seeded numpy init (``init_analyzer_np``), from
the JAX package's params pytree (``params_from_jax``; a checkpoint of
either package holds that nested layout, ``params_to_tree``), or from
``TaskAnalyzer.train``: the reference's instruction-tuning stand-in,
AdamW on the synthetic query logs, on the analyzer's device.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.preferences import DOMAINS, TASK_TYPES, TaskSignature
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.workload import QueryRecord, make_workload
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.analyze_step import (GLOBAL_KEYS, LAYER_KEYS,
                                              AnalyzerEncoder,
                                              encoder_forward)
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)

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
        if isinstance(v, (tuple, list)):     # a checkpoint loads pairs
            return (np.asarray(v[0], np.int8), np.asarray(v[1], np.float32))
        return np.asarray(v, np.float32)

    state = {name: leaf(tree[name]) for name in GLOBAL_KEYS}
    for i, layer in enumerate(tree["layers"]):
        for name in LAYER_KEYS:
            state[f"layers.{i}.{name}"] = leaf(layer[name])
    return state


def params_to_tree(state: Dict) -> Dict:
    """The reference's nested params layout (``embed``, ``pos``,
    ``layers: [...]``, ``ln_f``, ``head_*``) of a flat port state: what
    ``checkpoint.save`` writes, so either package loads the other's
    analyzer checkpoint."""
    n_layers = len({k.split(".")[1] for k in state if k.startswith("layers.")})
    tree = {name: state[name] for name in GLOBAL_KEYS}
    tree["layers"] = [{name: state[f"layers.{i}.{name}"]
                       for name in LAYER_KEYS} for i in range(n_layers)]
    return tree


# ----------------------------------------------------------------------
# training (instruction-tuning stand-in)
# ----------------------------------------------------------------------

def _labels(records: Sequence[QueryRecord]) -> Dict[str, np.ndarray]:
    return {
        "tt": np.array([TASK_TYPES.index(r.sig.task_type) for r in records]),
        "dm": np.array([DOMAINS.index(r.sig.domain) for r in records]),
        "cx": np.array([r.sig.complexity for r in records], np.float32),
    }


def analyzer_loss(cfg, weights: Dict[str, torch.Tensor], tokens, labels):
    """Cross-entropy of both heads plus 4 x the complexity MSE; returns
    (total, (l_tt, l_dm, l_cx))."""
    tt, dm, cx = encoder_forward(cfg, weights.__getitem__, tokens)
    rows = torch.arange(tt.shape[0], device=tt.device)

    def ce(lg, y):
        return -torch.mean(torch.log_softmax(lg, dim=-1)[rows, y])
    l_tt = ce(tt, labels["tt"])
    l_dm = ce(dm, labels["dm"])
    l_cx = torch.mean((cx - labels["cx"]) ** 2)
    return l_tt + l_dm + 4.0 * l_cx, (l_tt, l_dm, l_cx)


# ----------------------------------------------------------------------
# inference
# ----------------------------------------------------------------------

class TaskAnalyzer:
    """The task analyzer.

    ``params`` is the ``AnalyzerEncoder`` on ``device``; ``state`` (a
    flat weight dict, see ``params_from_jax``) replaces the seeded
    init.  ``train`` updates both; ``train_losses`` holds the last
    run's loss per step and ``train_s`` its step loop's seconds."""

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
        self.train_losses: List[float] = []
        self.train_s = 0.0

    # -------------------------- training --------------------------
    def train(self, n_samples: int = 4096, steps: int = 300,
              batch_size: int = 128, seed: int = 0, lr: float = 3e-3,
              log_every: int = 0, long_frac: float = 0.3
              ) -> Dict[str, float]:
        """The reference's training run on this analyzer's device:
        ``n_samples`` workload records (``long_frac`` of them inflated
        past the pruning budget), ``steps`` AdamW steps (warmup 20,
        decay 0.01) on batches drawn with ``default_rng(seed).integers``
        as there.  Returns ``evaluate(seed=seed + 1)``."""
        if self.params.quantized:
            raise ValueError("train needs f32 weights; quantize() after "
                             "training")
        dev = self.device
        records = make_workload(n_samples, seed=seed, long_frac=long_frac)
        toks = torch.as_tensor(self.encode_batch([r.text for r in records]),
                               device=dev)
        labels = {k: torch.as_tensor(v, device=dev)
                  for k, v in _labels(records).items()}
        opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, weight_decay=0.01)
        weights = {k: torch.tensor(v, device=dev)
                   for k, v in self.state.items()}
        opt = init_opt_state(weights)
        rng = np.random.default_rng(seed)
        self.train_losses = []
        t0 = time.perf_counter()
        for i in range(steps):
            sel = torch.as_tensor(rng.integers(0, n_samples, batch_size),
                                  device=dev)
            for w in weights.values():
                w.requires_grad_(True)
            tot, _ = analyzer_loss(self.cfg, weights, toks[sel],
                                   {k: v[sel] for k, v in labels.items()})
            grads = dict(zip(weights, torch.autograd.grad(
                tot, list(weights.values()))))
            weights, opt, _ = adamw_update(grads, opt, weights, opt_cfg)
            self.train_losses.append(float(tot.detach()))
            if log_every and i % log_every == 0:
                print(f"[analyzer] step {i} loss {self.train_losses[-1]:.4f}")
        # the loop's host time; each step ends reading its loss (a sync)
        self.train_s = time.perf_counter() - t0
        self.state = {k: w.detach().cpu().numpy() for k, w in weights.items()}
        self.params = AnalyzerEncoder(self.cfg, self.state).to(dev)
        return self.evaluate(seed=seed + 1)

    @torch.no_grad()
    def evaluate(self, n: int = 512, seed: int = 1) -> Dict[str, float]:
        """Head accuracies and the complexity MAE on ``n`` fresh
        workload records."""
        records = make_workload(n, seed=seed)
        toks = torch.as_tensor(self.encode_batch([r.text for r in records]),
                               device=self.device)
        labels = _labels(records)
        tt, dm, cx = self.params(toks)
        return {
            "task_type_acc": float(np.mean(
                tt.argmax(dim=1).cpu().numpy() == labels["tt"])),
            "domain_acc": float(np.mean(
                dm.argmax(dim=1).cpu().numpy() == labels["dm"])),
            "complexity_mae": float(np.mean(np.abs(
                cx.cpu().numpy() - labels["cx"]))),
        }

    # -------------------------- inference --------------------------

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

