"""The port's AdamW and analyzer training against the JAX package's, on
the CPU from the same numpy inputs.

  * ``adamw_update``: one step (past warmup, with clipping) on the same
    params, grads and moments -- params, moments and the norm within
    1e-6;
  * ``TaskAnalyzer.train``: 10 steps from the reference's init
    (``params_from_jax``) on the same workload draws -- the loss of
    every step and the final params within 1e-4 relative, and the same
    ``evaluate`` metrics;
  * ``load_analyzer``: a checkpoint saved by either package loads in
    the other (``params_to_tree`` / ``params_from_jax``), bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jload
from repro.checkpoint import save as jsave
from repro.core import analyzer as JA
from repro.training import optimizer as JO
from repro_torch.checkpoint import load as tload
from repro_torch.core import analyzer as TA
from repro_torch.launch import serve as TSERVE
from repro_torch.training import optimizer as TO

CFG_J = JA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)
CFG_T = TA.AnalyzerConfig(vocab_size=512, d_model=32, n_layers=2, n_heads=2,
                          d_ff=64, max_len=24)
TRAIN = dict(n_samples=256, steps=10, batch_size=32, seed=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("warmup,clip", [(3, 1.0), (100, 0.05)])
def test_adamw_update_matches_reference(warmup, clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    p, g, m, v = ({k: rng.standard_normal(s).astype(np.float32)
                   for k, s in shapes.items()} for _ in range(4))
    v = {k: np.abs(x) for k, x in v.items()}
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=warmup, grad_clip=clip)
    tcfg = TO.AdamWConfig(lr=1e-2, warmup_steps=warmup, grad_clip=clip)
    jst = {"mu": m, "nu": v, "step": jnp.asarray(6, jnp.int32)}
    tst = {"mu": {k: torch.from_numpy(x) for k, x in m.items()},
           "nu": {k: torch.from_numpy(x) for k, x in v.items()}, "step": 6}
    jp, jst2, jn = JO.adamw_update(g, jst, p, jcfg)
    tp, tst2, tn = TO.adamw_update({k: torch.from_numpy(x)
                                    for k, x in g.items()}, tst,
                                   {k: torch.from_numpy(x)
                                    for k, x in p.items()}, tcfg)
    assert tst2["step"] == int(jst2["step"]) == 7
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for k in shapes:
        for a, b in ((tp[k], jp[k]), (tst2["mu"][k], jst2["mu"][k]),
                     (tst2["nu"][k], jst2["nu"][k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    zero = TO.init_opt_state({k: torch.from_numpy(x) for k, x in p.items()})
    assert zero["step"] == 0 and all(
        not bool(t.any()) for t in zero["mu"].values())


def _reference_losses(ja, cfg, n_samples, steps, batch_size, seed):
    """The reference's training loop (``TaskAnalyzer.train``'s body)
    from its current params, with every step's loss kept."""
    from repro.data.workload import make_workload
    records = make_workload(n_samples, seed=seed, long_frac=0.3)
    toks = ja._encode([r.text for r in records])
    labels = JA._labels(records)
    opt_cfg = JO.AdamWConfig(lr=3e-3, warmup_steps=20, weight_decay=0.01)
    params, opt = ja.params, JO.init_opt_state(ja.params)
    rng = np.random.default_rng(seed)

    @jax.jit
    def step(params, opt, tokens, lab):
        (tot, _), grads = jax.value_and_grad(JA.analyzer_loss, has_aux=True)(
            params, cfg, tokens, lab)
        params, opt, _ = JO.adamw_update(grads, opt, params, opt_cfg)
        return params, opt, tot

    losses = []
    for _ in range(steps):
        sel = rng.integers(0, n_samples, batch_size)
        params, opt, tot = step(params, opt, jnp.asarray(toks[sel]),
                                {k: jnp.asarray(v[sel])
                                 for k, v in labels.items()})
        losses.append(float(tot))
    return losses


def test_analyzer_training_matches_reference():
    ja = JA.TaskAnalyzer(CFG_J, seed=3)
    ta = TA.TaskAnalyzer(CFG_T, device="cpu",
                         state=TA.params_from_jax(_np(ja.params)))
    want_losses = _reference_losses(ja, CFG_J, **TRAIN)
    jm = ja.train(**TRAIN)
    tm = ta.train(**TRAIN)
    np.testing.assert_allclose(ta.train_losses, want_losses, rtol=1e-4)
    want = TA.params_from_jax(_np(ja.params))
    assert set(want) == set(ta.state)
    for k, w in want.items():
        np.testing.assert_allclose(ta.state[k], w, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # state and the encoder stay in step, and evaluate agrees
    for k, w in ta.state.items():
        np.testing.assert_array_equal(ta.params.w(k).numpy(), w)
    assert tm == pytest.approx(jm, abs=1e-6)
    assert ta.evaluate(n=64, seed=5) == pytest.approx(
        ja.evaluate(n=64, seed=5), abs=1e-6)
    ta.quantize()                           # int8 after training
    assert ta.params.quantized and len(ta.analyze_batch(["hello"])) == 1
    with pytest.raises(ValueError, match="f32"):
        ta.train(steps=1)


def test_analyzer_checkpoint_loads_across_packages(tmp_path):
    ja = JA.TaskAnalyzer(JA.AnalyzerConfig(), seed=4)
    jsave(str(tmp_path / "j.npz"), ja.params, {"metrics": {}})
    ta = TSERVE.load_analyzer(tmp_path / "j.npz", device="cpu")
    for k, w in TA.params_from_jax(_np(ja.params)).items():
        np.testing.assert_array_equal(ta.state[k], w)
    # port -> reference: the nested layout, the same bits back
    tb = TA.TaskAnalyzer(TA.AnalyzerConfig(), seed=9, device="cpu")
    from repro_torch.checkpoint import save as tsave
    tsave(str(tmp_path / "t.npz"), TA.params_to_tree(tb.state))
    tree, _ = jload(str(tmp_path / "t.npz"))
    jb = JA.TaskAnalyzer(JA.AnalyzerConfig())
    jb.params = jax.tree_util.tree_map(jnp.asarray, tree)
    for k, w in TA.params_from_jax(_np(jb.params)).items():
        np.testing.assert_array_equal(tb.state[k], w)
    texts = ["summarize this legal brief", "write a python function"]
    for a, b in zip(jb.analyze_batch(texts), tb.analyze_batch(texts)):
        assert (a.task_type, a.domain) == (b.task_type, b.domain)
        assert a.complexity == pytest.approx(b.complexity, abs=1e-5)
    tree2, _ = tload(str(tmp_path / "t.npz"))
    assert set(tree2) == set(tree)


def test_load_analyzer_trains_and_saves_on_first_run(tmp_path):
    path = tmp_path / "sub" / "an.npz"
    import repro_torch.launch.serve as S
    an = S.load_analyzer(path, train_steps=2, device="cpu")
    assert path.exists() and len(an.train_losses) == 2
    again = S.load_analyzer(path, device="cpu")
    for k, w in an.state.items():
        np.testing.assert_array_equal(again.state[k], w)
