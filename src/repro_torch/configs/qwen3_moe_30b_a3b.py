"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]

48L d_model=2048 32H (GQA kv=4) d_ff=768/expert vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    n_experts=128,
    moe_top_k=8,
    rope_theta=1_000_000.0,
    # beyond-paper long-context SERVING mode (DESIGN.md §4): 500k
    # decode degrades to a 4096 SWA ring cache instead of refusing
    long_serving_window=4096,
    source="hf:Qwen/Qwen3-30B-A3B",
).validate()

SMOKE = smoke_variant(FULL)

# synthetic MRES evaluation record (paper §3.3) — quality/ethics scores are
# calibration-pass stand-ins; cost/latency are replaced by measured roofline
# terms at registration time.
EVAL = dict(accuracy=0.86, helpfulness=0.85, harmlessness=0.88, honesty=0.84,
            steerability=0.80, creativity=0.78,
            task_types=("chat", "code", "reasoning", "summarization"),
            domains=("general", "software", "finance"))
