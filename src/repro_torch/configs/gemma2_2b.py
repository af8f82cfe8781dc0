"""gemma2-2b [arXiv:2408.00118]

Dense with alternating local(SWA 4096)/global attention and logit
softcaps: 26L d_model=2304 8H (kv=4) d_ff=9216 vocab=256000.
``long_mode_local_only``: for the long_500k shape, global layers degrade
to the sliding window (documented long-context serving mode).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

FULL = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    sliding_window=4096,
    local_global_pattern=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    long_mode_local_only=True,
    source="arXiv:2408.00118",
).validate()

SMOKE = smoke_variant(FULL)

EVAL = dict(accuracy=0.70, helpfulness=0.72, harmlessness=0.90, honesty=0.78,
            steerability=0.62, creativity=0.60,
            task_types=("chat", "summarization", "classification"),
            domains=("general", "healthcare"))
