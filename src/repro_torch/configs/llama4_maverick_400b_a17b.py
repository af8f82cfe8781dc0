"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E]

MoE 128 experts top-1 with a shared expert, early fusion:
48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048.

Simplification (DESIGN.md §4): every layer is MoE top-1 + shared expert
(the released model interleaves dense layers; uniform layers keep the
layer scan homogeneous).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=128,
    moe_top_k=1,
    shared_expert=True,
    rope_theta=500_000.0,
    # beyond-paper long-context SERVING mode (DESIGN.md §4): 500k
    # decode degrades to a 4096 SWA ring cache instead of refusing
    long_serving_window=4096,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.90, helpfulness=0.88, harmlessness=0.86, honesty=0.86,
            steerability=0.82, creativity=0.84,
            task_types=("chat", "code", "reasoning", "creative-writing"),
            domains=("general", "software", "finance", "legal"))
