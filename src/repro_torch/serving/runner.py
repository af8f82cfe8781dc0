"""ModelRunner: a servable handle around (config, params).

Port of the JAX package's ``serving/runner.py``.  This is what a
catalog entry's ``runner`` points at: it holds the parameters in the
compute dtype on its device, runs ``generate`` (greedy, batched:
prefill, then one decode step per new token) and accounts a simulated
latency from the architecture's analytic FLOPs, so the serving engine
can charge each request to the model that served it.

``from_checkpoint``/``save_checkpoint`` keep the reference's npz layout
(per-layer parameters stacked along a leading axis), so a checkpoint
saved by either package loads in the other; ``merged_with`` produces
the model-soup runner of the §5 fallback (``core/merging.soup``).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training.steps import make_decode_step, make_prefill_step

# One NVIDIA H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth -- the roofline terms of ``sim_step_latency``.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


@dataclass
class GenerationResult:
    tokens: np.ndarray               # (B, new) generated ids
    logits_last: np.ndarray          # (B, V) prefill's last-position logits
    prefill_tokens: int
    decode_steps: int
    sim_latency_s: float             # roofline-simulated
    wall_s: float
    prefill_s: float = 0.0           # host clock, ends in a device sync
    decode_s: float = 0.0            # all decode steps, the same way
    step_logits: Optional[np.ndarray] = None  # (B, new, V) if kept


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params=None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(cfg, gen, device=self.device,
                                   dtype=cfg.compute_dtype)
        # cast once: the reference casts on every call, to the same values
        self.params = M.cast_params(
            M.tree_map(lambda t: t.to(self.device), params), cfg)
        self._decode = make_decode_step(cfg)
        self._calls: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, cfg: ModelConfig, path: str,
                        device=None) -> "ModelRunner":
        """Cold-load a runner from an npz checkpoint of either package
        onto ``device``.  bf16 weights are stored as their int16 bit
        patterns (numpy has no bf16) and come back bit-equal."""
        from repro_torch.checkpoint import load
        tree, meta = load(path)
        params = M.params_from_jax(tree)
        if meta.get("dtype") == "bfloat16":
            params = M.tree_map(lambda t: t.view(torch.bfloat16), params)
        runner = cls(cfg, params=params, device=device)
        runner.meta = meta
        return runner

    def save_checkpoint(self, path: str, metadata=None) -> None:
        """The parameters in the reference's layout (layers stacked),
        uncompressed, with the config's name and the weights' dtype."""
        from repro_torch.checkpoint import save
        from repro_torch.checkpoint.store import to_host
        dtype = self.params["embed"].dtype

        def host(t):
            return to_host(t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t)
        tree = {}
        for k, v in self.params.items():
            if k in M.STACKED:
                tree[k] = M.tree_map(lambda *xs: np.stack(xs),
                                     *[M.tree_map(host, p) for p in v])
            else:
                tree[k] = M.tree_map(host, v)
        save(path, tree, {"config": self.cfg.name,
                          "dtype": str(dtype).replace("torch.", ""),
                          **(metadata or {})}, compress=False)

    def merged_with(self, other: "ModelRunner",
                    alpha: float) -> "ModelRunner":
        """Model-soup merge (paper §5): the same-family weight average
        ``alpha * self + (1 - alpha) * other``.  Another config raises
        ``AssertionError``, which ``ModelMerger`` turns into a
        metrics-only soup."""
        if dataclasses.replace(self.cfg, name="") != \
                dataclasses.replace(other.cfg, name=""):
            raise AssertionError("soup needs same family")
        from repro_torch.core.merging import soup
        merged = ModelRunner.__new__(ModelRunner)
        merged.cfg = self.cfg
        merged.device = self.device
        merged.params = soup([self.params, other.params], [alpha, 1 - alpha])
        merged._decode = self._decode           # same arch: same step
        merged._calls = []
        return merged

    # ------------------------------------------------------------------
    def sim_step_latency(self, batch: int, decode: bool = True) -> float:
        """Roofline latency of one step on one H100: the larger of the
        compute term and the weight-streaming memory term."""
        n_act = self.cfg.n_active_params()
        flops = 2.0 * n_act * batch
        mem = 2.0 * n_act  # bf16 weight bytes touched once per step
        return max(flops / PEAK_FLOPS, mem / HBM_BW)

    def _batch(self, tokens: np.ndarray, embeds=None) -> Dict:
        """The model's batch for ``tokens`` (B, L), as the reference's
        runner builds it: an encoder-decoder's ``src_embeds`` (B, 16,
        frontend_dim) and a vision-language model's ``frontend`` (B,
        frontend_tokens, frontend_dim) are zeros in the compute dtype
        (the frontends are stubs), or the numpy ``embeds`` where given."""
        cfg = self.cfg
        b = {"tokens": torch.as_tensor(np.asarray(tokens, np.int64),
                                       device=self.device)}
        if cfg.frontend:
            cdt = getattr(torch, cfg.compute_dtype)
            n = 16 if cfg.is_encdec else cfg.frontend_tokens
            b["src_embeds" if cfg.is_encdec else "frontend"] = (
                torch.zeros((len(tokens), n, cfg.frontend_dim), dtype=cdt,
                            device=self.device) if embeds is None else
                torch.from_numpy(np.array(embeds, np.float32)).to(
                    self.device, cdt))
        return b

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, tokens: np.ndarray, max_new: int = 16, *,
                 keep_logits: bool = False,
                 embeds=None) -> GenerationResult:
        """Greedy generation.  tokens (B, L) int (right-aligned, no
        pad); the prefill gets ``max_len`` L + max_new + 8 (a frontend
        prefix beyond it leaves the decode past the cache, as in the
        reference).  With ``keep_logits`` the result carries every
        step's logits, the ones each greedy token was taken from.
        ``embeds``: the frontend's embeddings (``_batch``), zeros by
        default as in the reference."""
        t0 = time.perf_counter()
        cfg = self.cfg
        B, Lp = tokens.shape
        batch = self._batch(tokens, embeds)
        prefill = make_prefill_step(cfg, max_len=Lp + max_new + 8)
        last, cache, pos = prefill(self.params, batch)
        tok = torch.argmax(last, dim=-1)[:, None]
        out, kept = [tok], [last]
        self._sync()
        t1 = time.perf_counter()
        for _ in range(max_new - 1):
            logits, tok, cache = self._decode(self.params, cache,
                                              {"token": tok, "pos": pos})
            pos = pos + 1
            out.append(tok)
            if keep_logits:
                kept.append(logits)
        toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        t2 = time.perf_counter()
        sim = (self.sim_step_latency(B, decode=False) * Lp
               + self.sim_step_latency(B) * max_new)
        self._calls.append({"B": B, "prefill": Lp, "decode": max_new,
                            "sim_latency_s": sim, "wall_s": t2 - t0})
        return GenerationResult(
            tokens=toks, logits_last=last.cpu().numpy(),
            prefill_tokens=B * Lp, decode_steps=max_new,
            sim_latency_s=sim, wall_s=t2 - t0, prefill_s=t1 - t0,
            decode_s=t2 - t1,
            step_logits=torch.stack(kept, dim=1).cpu().numpy()
            if keep_logits else None)

    @property
    def stats(self) -> Dict[str, float]:
        if not self._calls:
            return {"calls": 0}
        return {
            "calls": len(self._calls),
            "sim_latency_s": float(sum(c["sim_latency_s"]
                                       for c in self._calls)),
            "wall_s": float(sum(c["wall_s"] for c in self._calls)),
            "decode_steps": int(sum(c["decode"] for c in self._calls)),
        }
