"""mamba2-1.3b [arXiv:2405.21060]

Attention-free SSD (state-space duality): 48L d_model=2048 vocab=50280,
ssm_state=128, expand 2 (d_inner=4096, 64 heads of dim 64).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    source="arXiv:2405.21060",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.64, helpfulness=0.60, harmlessness=0.70, honesty=0.66,
            steerability=0.50, creativity=0.55,
            task_types=("summarization", "classification", "long-context"),
            domains=("general", "legal"))
