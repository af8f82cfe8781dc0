"""qwen2-1.5b [arXiv:2407.10671]

Dense GQA with QKV bias: 28L d_model=1536 12H (kv=2) d_ff=8960
vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    # beyond-paper long-context SERVING mode (DESIGN.md §4): 500k
    # decode degrades to a 4096 SWA ring cache instead of refusing
    long_serving_window=4096,
    source="arXiv:2407.10671",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.68, helpfulness=0.66, harmlessness=0.74, honesty=0.70,
            steerability=0.60, creativity=0.58,
            task_types=("chat", "classification", "summarization"),
            domains=("general", "multilingual"))
