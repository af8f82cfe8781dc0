"""h2o-danube-3-4b [arXiv:2401.16818]

Llama+mistral mix with sliding-window attention:
24L d_model=3840 32H (kv=8) d_ff=10240 vocab=32000, SWA 4096.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32_000,
    sliding_window=4096,
    source="arXiv:2401.16818",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.72, helpfulness=0.70, harmlessness=0.74, honesty=0.72,
            steerability=0.62, creativity=0.60,
            task_types=("chat", "summarization", "long-context"),
            domains=("general", "finance"))
