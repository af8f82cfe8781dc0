"""The port's training launcher and loss on the CPU: ``launch.train.main``
draws the reference sampler's batches bit for bit and its loss falls;
checkpoints cross between the two packages' ``CheckpointManager``s;
``lm_loss`` against the reference's (-1 labels, a frontend prefix);
``remat`` on and off give the same gradients; the launcher refuses a
missing card and a production mesh without its world of 256 ranks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs import get_smoke as jget_smoke
from repro.launch import train as JT
from repro.models import model as JM
from repro_torch.checkpoint import CheckpointManager as TCkpt
from repro_torch.configs import get_smoke
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.training import steps as TS


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: its many small ops
    slow down by an order of magnitude when every test worker's pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_sampler_draws_the_reference_batches(arch, monkeypatch):
    """main() trains on the reference sampler's numbers for its seed."""
    drawn = []
    make = TT.make_lm_sampler

    def recording(rng, cfg):
        sample = make(rng, cfg)

        def wrapped(b, s):
            drawn.append(sample(b, s))
            return drawn[-1]
        return wrapped
    monkeypatch.setattr(TT, "make_lm_sampler", recording)
    TT.main(["--device", "cpu", "--smoke", "--arch", arch, "--steps", "2",
             "--batch", "2", "--seq", "8", "--seed", "4"])
    ref = JT.make_lm_sampler(np.random.default_rng(4), jget_smoke(arch))
    assert len(drawn) == 2
    for got in drawn:
        want = ref(2, 8)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_short_cpu_run_loss_falls(capsys):
    first, last = TT.main(["--device", "cpu", "--smoke", "--steps", "20",
                           "--batch", "2", "--seq", "32", "--warmup", "5",
                           "--lr", "3e-3"])
    assert last < first * 0.9
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out and "drop)" in out


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint the port's launcher writes loads in the reference's
    manager as the reference's tree; the reference's loads in the port's
    and converts back with ``params_from_jax``."""
    d = tmp_path / "port"
    TT.main(["--device", "cpu", "--smoke", "--steps", "2", "--batch", "2",
             "--seq", "8", "--ckpt-dir", str(d), "--ckpt-every", "2"])
    step, tree, meta = JCkpt(str(d)).restore_latest()
    want = JM.init_params(jax.random.PRNGKey(0), jget_smoke("llama3.2-1b"))
    assert step == 2 and "loss" in meta
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        np.asarray, tree)) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(want)):
        assert np.shape(a) == b.shape
    # the reverse: the reference's tree into the port
    d2 = tmp_path / "ref"
    JCkpt(str(d2)).save(5, jax.tree_util.tree_map(np.asarray, want))
    step, tree, _ = TCkpt(str(d2)).restore_latest()
    params = TM.params_from_jax(tree)
    assert step == 5 and len(params["layers"]) == 2
    back = TM.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_launcher_refusals():
    with pytest.raises(RuntimeError, match="world of 256 ranks"):
        TT.main(["--device", "cpu", "--smoke", "--production-mesh"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.main(["--smoke", "--steps", "1"])


def test_build_config_matches_reference():
    args = ["--arch", "llama3.2-1b", "--d-model", "640", "--n-layers", "16",
            "--d-ff", "2560", "--vocab", "16384"]
    import argparse
    ap = argparse.ArgumentParser()
    for a in ("--arch", "--d-model", "--n-layers", "--d-ff", "--vocab"):
        ap.add_argument(a, type=str if a == "--arch" else int)
    ns = ap.parse_args(args)
    ns.smoke = False
    got = dataclasses.asdict(TT.build_config(ns))
    want = dataclasses.asdict(JT.build_config(ns))
    assert got == want
    assert 90e6 < TT.build_config(ns).n_params() < 130e6


def test_lm_loss_ignores_minus_one_and_pads_the_prefix():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 5] = -1
    got = TM.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(TM.lm_loss(torch.from_numpy(logits),
                            torch.full((2, 7), -1))) == 0.0
    # llava: logits over frontend + text, labels over the text only
    name = "llava-next-mistral-7b"
    jcfg, cfg = jget_smoke(name), get_smoke(name)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    b = {"tokens": rng.integers(0, 100, (2, 6)).astype(np.int32),
         "labels": rng.integers(0, 100, (2, 6)).astype(np.int32),
         "frontend": rng.standard_normal(
             (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)}
    b["labels"][1, :2] = -1
    jt, (jl, ja) = JM.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                         for k, v in b.items()})
    with torch.no_grad():
        tt, (tl, ta) = TM.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(tt) == pytest.approx(float(jt), rel=1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b"])
def test_remat_gives_the_same_gradients(arch):
    """Recomputing each layer in the backward (``cfg.remat``) changes no
    gradient: the same kernels on the same inputs."""
    cfg = get_smoke(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int64)
    b = {"tokens": torch.from_numpy(toks[:, :-1]),
         "labels": torch.from_numpy(toks[:, 1:])}
    on = TS.loss_and_grads(params, dataclasses.replace(cfg, remat=True), b)
    off = TS.loss_and_grads(params, dataclasses.replace(cfg, remat=False), b)
    assert torch.equal(on[0], off[0])
    for g1, g2 in zip(jax.tree_util.tree_leaves(TM.params_to_numpy(on[3])),
                      jax.tree_util.tree_leaves(TM.params_to_numpy(off[3]))):
        np.testing.assert_allclose(g1, g2, rtol=0, atol=1e-7 * max(
            np.abs(g2).max(), 1.0))
