"""The batch-1 decode on a cache sharded by length, on the CPU.

``cache_specs`` lays a batch-1 decode cache out with its slots over the
data axes and its kv heads over ``model`` (the long_500k layout).  The
port decodes there without gathering the cache: each rank writes its
own block (``layers.write_slot``), decodes against it with a local live
count and first live slot (``ops._decode_by_length``), and the ranks'
(o, lse) partials go through one all-gather and ``decode_merge``.

Unit tests: the write each rank of ``write_slot`` makes into its block
(``layers._write_rows``, full caches and rings) against the whole
cache's write, the decode shape's ``return_lse`` against
``flash_attention_plain`` (bf16, f32, the int8 cache), and
``decode_merge``'s plain version over R slot blocks against one
unsharded decode and against the reference's ``ref.mha_attention``.

Then four gloo ranks (``tests/_torch_ctx_worker.py``, which imports no
JAX) on the meshes (2, 2) and (4, 1) ("data", "model") and (2, 2, 1)
("pod", "data", "model"), at ``SMOKE`` (f32), B = 1: the prefill and
three decode steps fed the reference's greedy tokens, held to the
port's unsharded run (logits within 1e-5 of max |logit|, the same
greedy tokens, the gathered cache) and to the reference's unsharded
steps (logits within 1e-4, tokens tie-aware; the int8 cache against the
reference run op by op within 1e-3, as ``tests/test_torch_long_mode.py``
holds it).  The cases: llama3.2-1b with blocks past the live count and
a step past the cache, gemma2-2b with its local window's edge inside a
block and blocks wholly below it, gemma2-2b in ``long_mode``, llama's
int8 cache, mamba2-1.3b, hymba-1.5b (a ring) and seamless-m4t-medium
(its cross K/V over the encoder frames).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels import ref
from repro.models import model as JM
from repro.training import steps as JS
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.training import steps as TS
from test_torch_generate import assert_greedy_agrees

WORLD, STEPS = 4, 3
WORKER = pathlib.Path(__file__).with_name("_torch_ctx_worker.py")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# name: (arch, prompt, max_len, long_mode, kv cache, encoder frames)
CASES = {
    "llama_empty_blocks": ("llama3.2-1b", 20, 64, False, "", 0),
    "llama_past_cache": ("llama3.2-1b", 62, 64, False, "", 0),
    "gemma2_local_window": ("gemma2-2b", 150, 160, False, "", 0),
    "gemma2_long_mode": ("gemma2-2b", 150, 160, True, "", 0),
    "llama_int8": ("llama3.2-1b", 20, 64, False, "int8", 0),
    "mamba2": ("mamba2-1.3b", 20, 64, False, "", 0),
    "hymba": ("hymba-1.5b", 100, 104, False, "", 0),
    "seamless": ("seamless-m4t-medium", 20, 64, False, "", 16),
}


# ----------------------------------------------------------------------
# unit tests
# ----------------------------------------------------------------------

def _rows(B, C, H, hd, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, C, H, hd, generator=g).to(dtype)


@pytest.mark.parametrize("ring", [False, True])
def test_write_rows_on_a_block_is_the_plain_write(ring):
    """``layers._write_rows`` of a rank holding slots [lo, lo + n) of C,
    over every block of a cache cut by length, equals the whole cache's
    write bit for bit: slots inside, past the block, past C (a full
    cache drops it) and wrapped (a ring)."""
    B, C, H, hd, R = 4, 32, 2, 8, 4
    pos = torch.tensor([3, 17, 40, 31])
    new = _rows(B, 1, H, hd, 1)[:, 0]
    want = _rows(B, C, H, hd, 0)
    got = want.clone()
    TL._write_rows(want, new, pos, ring, C)
    n = C // R
    for r in range(R):
        block = got[:, r * n:(r + 1) * n]
        TL._write_rows(block, new, pos, ring, C, lo=r * n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cap,local", [(0.0, 0), (50.0, 40)])
def test_decode_return_lse_matches_plain(dtype, cap, local):
    """The decode shape's ``return_lse``: the partial (o in f32, lse) of
    ``flash_attention``'s CPU branch equals ``flash_attention_plain``
    on the operands in f32, the lse +inf on a row with no live key; an
    int8 cache's ``flash_decode_q8`` likewise against its plain decode
    of the dequantized cache."""
    B, Hq, Hkv, C, hd = 3, 8, 2, 48, 64
    q = _rows(B, 1, Hq, hd, 2, dtype).transpose(1, 2)
    k, v = (_rows(B, C, Hkv, hd, s, dtype).transpose(1, 2) for s in (3, 4))
    kv = torch.tensor([48, 0, 20], dtype=torch.int32)
    first = torch.tensor([5, 0, 19], dtype=torch.int32)
    kw = dict(causal=False, softcap=cap, local_window=local)
    o, lse = FA.flash_attention(q, k, v, kv, return_lse=True, kv_first=first,
                                **kw)
    wo, wl = FA.flash_attention_plain(q.float(), k.float(), v.float(), kv,
                                      return_lse=True, kv_first=first, **kw)
    assert o.dtype == torch.float32 and lse.shape == (B, Hq, 1)
    assert torch.equal(o, wo) and torch.equal(lse, wl)
    assert torch.isinf(lse[1]).all() and (o[1] == 0).all()
    assert torch.isfinite(lse[[0, 2]]).all()
    k8, ks = TL.quantize_kv(k.transpose(1, 2))
    v8, vs = TL.quantize_kv(v.transpose(1, 2))
    k8, ks, v8, vs = (t.transpose(1, 2) for t in (k8, ks, v8, vs))
    o8, l8 = FA.flash_decode_q8(q, k8, v8, ks, vs, kv, softcap=cap,
                                local_window=local, return_lse=True,
                                kv_first=first)
    w8, wl8 = FA.flash_attention_plain(
        q.float(), FA.dequantize_kv(k8, ks).float(),
        FA.dequantize_kv(v8, vs).float(), kv, return_lse=True,
        kv_first=first, **kw)
    assert torch.equal(o8, w8) and torch.equal(l8, wl8)
    # the plain result in q's dtype is the partial rounded
    assert torch.equal(FA.flash_attention(q, k, v, kv, kv_first=first, **kw),
                       wo.to(dtype))


@pytest.mark.parametrize("R", [1, 2, 4, 6])
@pytest.mark.parametrize("local", [0, 20])
def test_decode_merge_over_slot_blocks(R, local):
    """R slot blocks' partials (each block's live count and first live
    slot clamped from the whole cache's) merged by
    ``decode_merge_plain`` give the unsharded decode within 2e-6 of max
    |o|; a block with no live key is skipped, and a row with none live
    anywhere gives 0."""
    B, Hq, Hkv, C, hd = 3, 4, 2, 48, 32
    q = _rows(B, 1, Hq, hd, 5).transpose(1, 2)
    k, v = (_rows(B, C, Hkv, hd, s).transpose(1, 2) for s in (6, 7))
    live = torch.tensor([48, 9, 0], dtype=torch.int32)
    want = FA.flash_attention_plain(q, k, v, live, causal=False,
                                    local_window=local)
    n = C // R
    parts = []
    for r in range(R):
        lo = r * n
        first = (live - local - lo).clamp(0, n).to(torch.int32) \
            if local else None
        parts.append(FA.flash_attention(
            q, k[:, :, lo:lo + n], v[:, :, lo:lo + n],
            (live - lo).clamp(0, n).to(torch.int32), causal=False,
            return_lse=True, kv_first=first))
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    if R > 1:
        assert torch.isinf(lse[-1, 1]).all()     # past row 1's live count
    got = FA.decode_merge(o, lse)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    assert (got[2] == 0).all()
    assert FA.decode_merge(o, lse, torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="R, B, Hq"):
        FA.decode_merge(o[:, :, :, 0], lse)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_decode_merge_matches_reference_attention(cap):
    """One query row against a full cache cut into 4 slot blocks: the
    blocks' partials through ``decode_merge`` (its plain version on the
    CPU) against the reference's oracle ``ref.mha_attention`` over the
    whole cache, within 1e-5 of max |o|."""
    B, Hq, Hkv, C, hd, R = 2, 8, 2, 64, 32, 4
    q = _rows(B, 1, Hq, hd, 8)
    k, v = _rows(B, C, Hkv, hd, 9), _rows(B, C, Hkv, hd, 10)
    want = np.asarray(ref.mha_attention(jnp.asarray(q.numpy()),
                                        jnp.asarray(k.numpy()),
                                        jnp.asarray(v.numpy()),
                                        causal=False, softcap=cap))
    n = C // R
    parts = [FA.flash_attention(q.transpose(1, 2),
                                k[:, r * n:(r + 1) * n].transpose(1, 2),
                                v[:, r * n:(r + 1) * n].transpose(1, 2),
                                causal=False, softcap=cap, return_lse=True)
             for r in range(R)]
    got = FA.decode_merge(torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] for p in parts]))
    got = got.transpose(1, 2).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ----------------------------------------------------------------------
# four gloo ranks
# ----------------------------------------------------------------------

def _inputs(name):
    """A case's inputs: the reference's parameters (numpy), a seeded
    prompt (and encoder frames), and the feed of the decode steps -- the
    port's unsharded greedy tokens, which every run is fed."""
    arch, prompt, max_len, long_mode, kv, frames = CASES[name]
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    if kv:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, jcfg.vocab_size, (1, prompt)).astype(np.int32)
    src = rng.standard_normal((1, frames, jcfg.frontend_dim)).astype(
        np.float32) if frames else None
    tp = TM.params_from_jax(params)
    b = {"tokens": torch.from_numpy(toks)}
    if frames:
        b["src_embeds"] = torch.from_numpy(src)
    pre = TS.make_prefill_step(tcfg, long_mode=long_mode, max_len=max_len)
    dec = TS.make_decode_step(tcfg, long_mode=long_mode)
    with torch.no_grad():
        lg, cache, pos = pre(tp, b)
        feed = [int(lg[0].argmax())]
        for _ in range(STEPS - 1):
            tok = torch.tensor([[feed[-1]]], dtype=torch.int32)
            _, nxt, cache = dec(tp, cache, {"token": tok, "pos": pos})
            feed.append(int(nxt[0, 0]))
            pos = pos + 1
    return {"name": name, "arch": arch, "prompt": toks, "src": src,
            "max_len": max_len, "long_mode": long_mode, "kv": kv,
            "feed": feed, "params": params}, jcfg


def _reference(job, jcfg):
    """The reference's unsharded prefill and STEPS decode steps fed
    ``job``'s tokens: its logits and greedy tokens, jitted (an int8
    cache op by op: compiled, XLA drops the bf16 rounding it asks
    for)."""
    batch = {"tokens": jnp.asarray(job["prompt"])}
    if job["src"] is not None:
        batch["src_embeds"] = jnp.asarray(job["src"])
    pre = JS.make_prefill_step(jcfg, long_mode=job["long_mode"],
                               max_len=job["max_len"])
    dec = JS.make_decode_step(jcfg, long_mode=job["long_mode"])
    if not job["kv"]:
        pre, dec = jax.jit(pre), jax.jit(dec)
    with jax.disable_jit(bool(job["kv"])):
        lg, cache, pos = pre(job["params"], batch)
        logits = [np.asarray(lg)[0]]
        for tok in job["feed"]:
            lg, _, cache = dec(job["params"], cache, {
                "token": jnp.asarray([[tok]], dtype=jnp.int32), "pos": pos})
            pos = pos + 1
            logits.append(np.asarray(lg)[0])
    logits = np.stack(logits)
    return {"logits": logits, "tokens": logits.argmax(-1)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results and the reference's, computed while the
    ranks run."""
    path = tmp_path_factory.mktemp("ctx")
    jobs = [_inputs(name) for name in CASES]
    torch.save({"cases": [job for job, _ in jobs]}, path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), str(path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        refs = {job["name"]: _reference(job, jcfg) for job, jcfg in jobs}
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    out = [json.loads((path / f"rank{r}.json").read_text())
           for r in range(WORLD)]
    for r, o in enumerate(out):
        assert "error" not in o, (r, o["error"])
    return out, refs


def _runs(ranks, name):
    """(rank, mesh, result) of every rank on every mesh."""
    return [(r, m, res) for r, o in enumerate(ranks[0])
            for m, res in o[name].items()]


@pytest.mark.parametrize("name", list(CASES))
def test_cache_born_in_the_batch1_layout(ranks, name):
    """Every rank holds C / R slots of the K/V cache (and of an int8
    cache's scales, and S / R of seamless's encoder frames), R the data
    ranks: the prefill's cache comes out of ``cache_specs``' batch-1
    layout, and the steps keep it."""
    for _, mesh, res in _runs(ranks, name):
        assert res["n_data"] == (2 if mesh.startswith("2x2:") else 4), mesh
        for key, (full, local) in res["local_c"].items():
            assert local * res["n_data"] == full, (mesh, key, full, local)
        if CASES[name][0] == "mamba2-1.3b":
            assert res["local_c"] == {}
        else:
            assert "k" in res["local_c"]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_unsharded(ranks, name):
    """The prefill and every decode step within 1e-5 of max |logit| of
    the port's unsharded run, and the same greedy tokens but where the
    unsharded run's top two logits lie within that tolerance of each
    other (a near-tie: gemma2's 4.2e-7 apart at one step).  The
    gathered cache within 1e-5 of its max: the K/V rows come from f32
    projections whose sums the sharded contractions split; an int8
    cache's values within 1 of each other."""
    for r, mesh, res in _runs(ranks, name):
        assert len(res["diff"]) == STEPS + 1
        for d, m in zip(res["diff"], res["max"]):
            assert d <= 1e-5 * max(m, 1.0), (r, mesh, res["diff"])
        for s, (got, want) in enumerate(zip(res["tokens"],
                                            res["want_tokens"])):
            gap = res["gap"][s + 1]
            assert got == want or gap <= 2e-5 * res["max"][s + 1], \
                (r, mesh, s, got, want, gap)
        for key, c in res["cache"].items():
            tol = 1.0 if key in ("k", "v") and CASES[name][4] else \
                1e-5 * max(c["max"], 1.0)
            assert c["diff"] <= tol, (r, mesh, key, c)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_reference(ranks, name):
    """Every rank's sharded logits within 1e-4 (an int8 cache 1e-3) of
    the reference's unsharded steps fed the same tokens, greedy tokens
    tie-aware."""
    ref = ranks[1][name]
    tol = 1e-3 if CASES[name][4] else 1e-4
    for r, mesh, res in _runs(ranks, name):
        got = np.array(res["logits"])
        np.testing.assert_allclose(got, ref["logits"], rtol=tol, atol=tol,
                                   err_msg=f"{r} {mesh}")
        assert_greedy_agrees(np.array([res["tokens"]]),
                             ref["tokens"][None, 1:],
                             ref["logits"][None, 1:])


@pytest.mark.parametrize("name", list(CASES))
def test_decode_step_moves_the_partials_not_the_cache(ranks, name):
    """A batch-1 decode step's attention, one ``_decode_by_length`` call
    a layer (two with seamless's cross-attention), moves at most the
    query's reduction over the data axes (B * Hq * hd f32) and the R
    ranks' (o, lse) partials (R * B * Hq * (hd + 1) f32), each once per
    data axis it crosses (DTensor gathers ("pod", "data") in two steps):
    together, over every layer, less than one layer's K/V cache, which a
    gather of the cache would move.  The whole step is sharded (its
    collectives are not empty)."""
    arch, prompt, max_len, long_mode, kv, frames = CASES[name]
    cfg = get_smoke(arch)
    C = TM.cache_len(cfg, max(prompt, max_len), long_mode)
    cache_layer = 2 * C * max(cfg.n_kv_heads, 1) * cfg.head_dim * 4
    for r, mesh, res in _runs(ranks, name):
        assert sum(res["collective_bytes"].values()) > 0, (r, mesh)
        calls = res["attention"]
        assert len(calls) == (cfg.n_layers * (2 if frames else 1)
                              if cfg.has_attention else 0), (r, mesh)
        if not calls:
            continue
        R, axes = res["n_data"], 2 if mesh.startswith("2x2x1") else 1
        per_call = axes * 4 * cfg.n_heads * (cfg.head_dim +
                                             R * (cfg.head_dim + 1))
        moved = [sum(c.values()) for c in calls]
        assert all(0 < m <= per_call for m in moved), (r, mesh, moved,
                                                       per_call)
        assert sum(moved) < cache_layer, (r, mesh, moved, cache_layer)
