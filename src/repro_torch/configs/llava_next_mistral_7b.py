"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf]

VLM backbone (mistral-7b decoder): 32L d_model=4096 32H (kv=8)
d_ff=14336 vocab=32000. The SigLIP/CLIP vision tower + anyres tiling is
stubbed — ``input_specs`` supplies precomputed patch embeddings
(anyres: base 576 + 4 tiles x 576 = 2880 patch tokens).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    frontend="vision",
    frontend_dim=1024,
    frontend_tokens=2880,
    rope_theta=1_000_000.0,
    # beyond-paper long-context SERVING mode (DESIGN.md §4): 500k
    # decode degrades to a 4096 SWA ring cache instead of refusing
    long_serving_window=4096,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.76, helpfulness=0.74, harmlessness=0.78, honesty=0.72,
            steerability=0.60, creativity=0.62,
            task_types=("vqa", "captioning", "chat"),
            domains=("general", "healthcare"))
