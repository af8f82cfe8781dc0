"""Shared body of ``tests/test_torch_train_zoo_*.py``: the port's
``make_train_step`` against the reference's jitted one, at ``SMOKE``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch.configs import get_smoke
from repro_torch.models import model as TM
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while a zoo module runs: its many small ops
    slow down by an order of magnitude when every test worker's pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# windowed configs train past their SMOKE windows of 64
SEQ = {"hymba-1.5b": 80, "h2o-danube-3-4b": 80, "gemma2-2b": 80}


def batch(cfg, B, L, seed):
    """numpy batch: tokens, labels with some -1, frontend embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, L + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][0, :3] = -1
    if cfg.is_encdec:
        b["src_embeds"] = rng.standard_normal(
            (B, 16, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend:
        b["frontend"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return b


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def check_arch(name, overrides=None, L=None):
    """Loss, aux and gnorm within 1e-5 relative; every gradient leaf
    within 1e-4 of its max |g|; after two AdamW steps (lr 1e-3, warmup
    1: each step moves a param by up to about lr) the moments within
    5e-4 of each leaf's max |value|, and the params: at most 1 in 1,000
    entries of a leaf (16 in a small one) more than 0.01 lr from the
    reference's and none more than 0.5 lr.  Adam's mhat / sqrt(vhat) is about sign(g) where
    |g| is small, so a gradient entry that agrees within 1e-4 of the
    leaf's max may still turn its param's update by up to a fifth of lr
    (seen on 1-10 in 100,000 entries), and the second step's gradients
    are taken at params that differ that much.  A leaf whose gradient
    is zero but for rounding is held to that on both sides instead: its
    updates are the signs of rounding noise.  ``overrides`` replace
    fields of both SMOKE configs; ``L`` is the sequence length."""
    jcfg, cfg = jget_smoke(name), get_smoke(name)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        cfg = dataclasses.replace(cfg, **overrides)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    L = L or SEQ.get(name, 24)
    b0, b1 = batch(jcfg, 2, L, 0), batch(jcfg, 2, L, 1)

    (jt, (jl, ja)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in b0.items()})
    tt, tl, ta, tg = TS.loss_and_grads(
        tp, cfg, {k: torch.from_numpy(v) for k, v in b0.items()})
    for got, want in ((tl, jl), (ta, ja), (tt, jt)):
        assert abs(float(got) - float(want)) <= 1e-5 * max(
            abs(float(want)), 1.0), (name, float(got), float(want))
    jgn = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jg))[0]
    tgn = jax.tree_util.tree_leaves(TM.params_to_numpy(tg, cfg))
    assert len(jgn) == len(tgn)
    top = max(np.abs(w).max() for _, w in jgn)
    noise = set()
    for (path, want), got in zip(jgn, tgn):
        key = jax.tree_util.keystr(path)
        assert got.shape == want.shape, (name, key)
        if np.abs(want).max() < 1e-6 * top:
            assert np.abs(got).max() < 1e-6 * top, (name, key)
            noise.add(key)
            continue
        assert rel_err(got, want) <= 1e-4, (name, key, rel_err(got, want))

    jopt = JO.AdamWConfig(lr=1e-3, warmup_steps=1)
    topt = TO.AdamWConfig(lr=1e-3, warmup_steps=1)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = TS.make_train_step(cfg, topt)
    jst, tst = JO.init_opt_state(jp), TO.init_opt_state(tp)
    for b in (b0, b1):
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        tp, tst, tm = tstep(tp, tst, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        for key in ("loss", "aux", "total", "gnorm"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * max(
                abs(float(jm[key])), 1.0), (name, key)
    assert tst["step"] == int(jst["step"]) == 2
    for jtree, ttree, what in ((jp, tp, "params"), (jst["mu"], tst["mu"], "mu"),
                               (jst["nu"], tst["nu"], "nu")):
        jl_ = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(np.asarray, jtree))[0]
        tl_ = jax.tree_util.tree_leaves(TM.params_to_numpy(ttree, cfg))
        for (path, want), got in zip(jl_, tl_):
            key = (name, what, jax.tree_util.keystr(path))
            if key[2] in noise:
                continue
            if what == "params":
                d = np.abs(got - want) / topt.lr
                off = int((d > 0.01).sum())
                assert d.max() <= 0.5 and off <= max(16, d.size // 1000), (
                    key, d.max(), off)
            else:
                assert rel_err(got, want) <= 5e-4, (key, rel_err(got, want))
