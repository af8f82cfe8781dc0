"""seamless-m4t-medium [arXiv:2308.11596]

Enc-dec multimodal (speech/text) backbone: 12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206. The mel/conv speech frontend is stubbed —
``input_specs`` provides precomputed frame embeddings (carve-out).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    frontend="audio",
    frontend_dim=1024,
    frontend_tokens=0,  # encoder side consumes src_embeds directly
    # beyond-paper long-context SERVING mode (DESIGN.md §4): 500k
    # decode degrades to a 4096 SWA ring cache instead of refusing
    long_serving_window=4096,
    source="arXiv:2308.11596",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.74, helpfulness=0.70, harmlessness=0.86, honesty=0.80,
            steerability=0.55, creativity=0.40,
            task_types=("translation", "transcription"),
            domains=("general", "multilingual"))
