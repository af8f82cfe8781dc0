"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B]

Small llama3: 16L d_model=2048 32H (kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="llama3.2-1b",
    arch_type="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
    # beyond-paper long-context SERVING mode (DESIGN.md §4): 500k
    # decode degrades to a 4096 SWA ring cache instead of refusing
    long_serving_window=4096,
    source="hf:meta-llama/Llama-3.2-1B",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.58, helpfulness=0.56, harmlessness=0.72, honesty=0.62,
            steerability=0.48, creativity=0.50,
            task_types=("chat", "classification", "summarization"),
            domains=("general",))
