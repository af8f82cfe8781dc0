"""Model configuration system.

Every assigned architecture gets one module in ``repro/configs/`` that
exports ``FULL`` (the exact published config) and ``SMOKE`` (a reduced
variant of the same family: <=2 layers, d_model<=512, <=4 experts) plus
an MRES catalog entry describing the model to the OptiRoute router.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return int(math.ceil(v / multiple) * multiple)


@dataclass(frozen=True)
class ModelConfig:
    """Unified configuration covering all six architecture families.

    ``arch_type`` selects the mixer stack:
      dense | moe | ssm | hybrid | encdec | vlm | audio
    (vlm/audio are decoder-only transformers consuming a stubbed
    modality frontend; encdec is an encoder-decoder whose encoder
    consumes frontend embeddings — Seamless-style.)
    """

    name: str
    arch_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation bracket from the assignment

    # --- attention options ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 => full attention
    local_global_pattern: bool = False  # gemma2: even layers local(SWA), odd global
    attn_softcap: float = 0.0        # gemma2 attention logit softcap
    final_softcap: float = 0.0       # gemma2 final logit softcap
    # long-context serving mode: if True, "global" layers degrade to SWA
    # for the long_500k shape (documented in DESIGN.md).
    long_mode_local_only: bool = False

    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    shared_expert: bool = False
    moe_group: int = 2048            # dispatch group size along sequence
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- encoder-decoder ---
    n_enc_layers: int = 0

    # --- modality frontend stub ---
    frontend: str = ""               # "" | "vision" | "audio"
    frontend_dim: int = 0            # dim of precomputed embeddings
    frontend_tokens: int = 0         # patches/frames prepended

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True

    # --- performance (beyond-paper hillclimbs; EXPERIMENTS.md §Perf) ---
    # "naive"   = materialize the full (Lq, Lk) masked score matrix
    # "blocked" = scan over query blocks (flash-style row softmax);
    #             uniform-SWA archs additionally slice the key BAND so
    #             scores are (blk_q, W + blk_q) instead of (blk_q, L)
    attn_impl: str = "blocked"
    attn_block_q: int = 512
    # int8 KV cache for decode (halves the cache-streaming memory term)
    kv_cache_dtype: str = ""         # "" = compute dtype | "int8"
    # expert-weight second shard axis: "f" avoids partial-sum all-reduce
    # of (g, E, C, f) intermediates ("d" = the naive FSDP baseline)
    moe_shard_axis: str = "f"
    # embedding d-axis FSDP ("True" = naive baseline): replicating d
    # keeps the tied LM head local and logits vocab-sharded
    embed_shard_d: bool = False
    # long-context SERVING degradation for full-attention families:
    # at long_500k, attention falls back to this sliding window (ring
    # KV cache) — an explicit approximation (DESIGN.md §4), the same
    # trade production servers make rather than refusing 500k contexts.
    # 0 = refuse long_500k (the paper-faithful default behaviour).
    long_serving_window: int = 0

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // max(self.n_heads, 1)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def ssm_groups(self) -> int:
        return 1 if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.arch_type in ("encdec", "audio") and self.n_enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k decode shape."""
        if self.arch_type == "ssm":
            return True
        if self.arch_type == "hybrid":
            return self.sliding_window > 0
        if self.sliding_window > 0:
            return True
        if self.local_global_pattern and self.long_mode_local_only:
            return True
        return self.long_serving_window > 0

    def long_serving_config(self) -> "ModelConfig":
        """Effective config for the long_500k serving shape: full-
        attention families degrade to the long_serving_window SWA ring
        cache (parameters are unchanged — only the cache/mask differ)."""
        if self.sliding_window or self.arch_type == "ssm" \
                or not self.long_serving_window:
            return self
        return replace(self, sliding_window=self.long_serving_window,
                       local_global_pattern=False)

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Total parameter count (analytic, matches init)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_padded
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
        if self.is_moe:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * f
            if self.shared_expert:
                per_layer += 3 * d * f
        elif f > 0:
            per_layer += 3 * d * f
        if self.has_ssm:
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * self.ssm_groups * N
            per_layer += d * (2 * di + 2 * self.ssm_groups * N + H)
            per_layer += conv_dim * self.ssm_conv_width
            per_layer += 3 * H          # A_log, D, dt_bias
            per_layer += di             # gated norm
            per_layer += di * d
        per_layer += 2 * d              # pre-norms
        if self.arch_type == "hybrid":
            per_layer += 2 * d          # per-branch output norms
        total = self.n_layers * per_layer
        if self.is_encdec:
            enc_layer = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + 3 * d * f + 2 * d
            cross = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + d
            total += self.n_enc_layers * enc_layer + self.n_layers * cross + d
        if self.frontend:
            total += self.frontend_dim * d + d
        total += V * d + d              # embed + final norm
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        inactive = self.n_layers * (self.n_experts - self.moe_top_k) * 3 * d * f
        return self.n_params() - inactive

    # ------------------------------------------------------------------
    def validate(self) -> "ModelConfig":
        assert self.arch_type in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"), self.arch_type
        if self.has_attention and self.n_heads:
            assert self.d_model % self.n_heads == 0, (self.name, "d_model % n_heads")
            assert self.n_heads % self.n_kv_heads == 0, (self.name, "GQA group")
        if self.is_moe:
            assert 0 < self.moe_top_k <= self.n_experts
        if self.has_ssm:
            assert self.d_inner % self.ssm_head_dim == 0
        return self


def smoke_variant(full: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config: <=2 layers, d_model<=512, <=4 experts."""
    d = min(full.d_model, 256)
    n_heads = min(full.n_heads, 4) or full.n_heads
    if full.has_attention:
        # keep the GQA grouping structure of the family
        group = max(full.n_heads // max(full.n_kv_heads, 1), 1)
        n_kv = max(n_heads // min(group, n_heads), 1)
    else:
        n_heads, n_kv = 0, 0
    kw = dict(
        n_layers=2,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=min(full.d_ff, 512) if full.d_ff else 0,
        vocab_size=min(full.vocab_size, 1024),
        n_experts=min(full.n_experts, 4) if full.n_experts else 0,
        moe_top_k=min(full.moe_top_k, 2) if full.moe_top_k else 0,
        # no-drop capacity so decode == full-forward exactly in tests
        moe_capacity_factor=(min(full.n_experts, 4) / min(full.moe_top_k, 2)
                             if full.n_experts else 1.25),
        n_enc_layers=2 if full.n_enc_layers else 0,
        frontend_dim=min(full.frontend_dim, 128) if full.frontend else 0,
        frontend_tokens=min(full.frontend_tokens, 16) if full.frontend else 0,
        sliding_window=min(full.sliding_window, 64) if full.sliding_window else 0,
        ssm_state=min(full.ssm_state, 16) if full.ssm_state else 0,
        ssm_head_dim=32 if full.ssm_state else full.ssm_head_dim,
        ssm_chunk=16 if full.ssm_state else full.ssm_chunk,
        param_dtype="float32",
        compute_dtype="float32",
        name=full.name + "-smoke",
    )
    kw.update(overrides)
    return replace(full, **kw).validate()
