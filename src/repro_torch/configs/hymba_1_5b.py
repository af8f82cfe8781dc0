"""hymba-1.5b [arXiv:2411.13676]

Hybrid-head: parallel attention + mamba heads in every layer.
32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001, ssm_state=16,
sliding-window attention (1024) keeps it sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    source="arXiv:2411.13676",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.66, helpfulness=0.64, harmlessness=0.72, honesty=0.68,
            steerability=0.55, creativity=0.52,
            task_types=("chat", "classification", "long-context"),
            domains=("general",))
