"""The port's training step against the reference's at gemma2-2b's
head dim of 288 on the CPU (``SMOKE``'s gemma2 has 4 heads of 64): 2
layers, d_model 576 in 2 heads over 1 kv head, d_ff 512, vocab 1024, a
window of 48 on the local layers, L=80 (past the window), the attention
and final softcaps 50 and 30, f32.  The body and its tolerances are
``tests/_torch_train_zoo.py``'s: loss, aux and gnorm within 1e-5
relative, every gradient leaf within 1e-4 of its max |g|, two AdamW
steps' moments and params as there."""
from _torch_train_zoo import check_arch, few_threads  # noqa: F401

HD288 = dict(d_model=576, n_heads=2, n_kv_heads=1, n_layers=2, d_ff=512,
             vocab_size=1024, sliding_window=48, attn_softcap=50.0,
             final_softcap=30.0, param_dtype="float32",
             compute_dtype="float32")


def test_train_step_matches_reference_at_hd_288():
    check_arch("gemma2-2b", HD288, L=80)
