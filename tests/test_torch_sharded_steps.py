"""The port's train, prefill and decode steps on DTensor-sharded
parameters, on four gloo ranks on the CPU, against the port unsharded
and the reference's jitted step.

The fixture computes the reference's side with JAX here (parameters,
batches, the jitted unsharded train step's losses), hands them to four
rank processes as numpy (``tests/_torch_sharded_worker.py``, which
imports no JAX), started once for the module, and reads what each rank
saw.  Configs at SMOKE (f32): llama3.2-1b (GQA 4:1: one kv head against
two and four ``model`` ranks), qwen3-moe-30b-a3b (experts over
``model``) and mamba2-1.3b (``in_proj``, ``conv_w``, ``out_proj``).
"""
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
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as TT

ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "mamba2-1.3b")
WORLD, B, L, DECODE = 4, 4, 16, 3
WORKER = pathlib.Path(__file__).with_name("_torch_sharded_worker.py")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, L + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][0, :3] = -1
    return b


def _reference(arch):
    """The reference's parameters and batches (numpy) and its jitted
    unsharded train step's losses over them."""
    cfg = jget_smoke(arch)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    batches = [_batch(cfg, 0), _batch(cfg, 1)]
    step = jax.jit(JS.make_train_step(cfg, JO.AdamWConfig()))
    p, st, losses = params, JO.init_opt_state(params), []
    for b in batches:
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 12)).astype(np.int32)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "batches": batches, "prompt": prompt}, losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded")
    jobs, losses = {}, {}
    for arch in ARCHS:
        jobs[arch], losses[arch] = _reference(arch)
    torch.save({"archs": jobs, "decode_steps": DECODE},
               path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), str(path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode()[-3000:])
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
    return out, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_unsharded(ranks, arch):
    """Two steps: loss and gnorm, the gathered parameters and AdamW's
    moments within 1e-5 of the unsharded port's."""
    for o in ranks[0]:
        t = o[arch]["train"]
        np.testing.assert_allclose(t["loss_sharded"], t["loss"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(t["gnorm_sharded"], t["gnorm"],
                                   rtol=1e-5, atol=1e-5)
        assert t["param_diff"] <= 1e-5, t["param_diff"]
        assert t["mu_diff"] <= 1e-5 and t["nu_diff"] <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(ranks, arch):
    """The sharded step's losses against the reference's jitted
    unsharded step (``tests/_torch_train_zoo.py``'s 1e-5)."""
    want = ranks[1][arch]
    got = ranks[0][0][arch]["train"]["loss_sharded"]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * max(abs(w), 1.0), (arch, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_follow_specs(ranks, arch):
    """Every rank's local parameter, moment and cache blocks are the
    global shapes divided by the sizes of the axes their specs name."""
    for o in ranks[0]:
        assert o[arch]["train"]["local_bad"] == []
        assert o[arch]["serve"]["cache_bad"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_ran_sharded(ranks, arch):
    """``CommDebugMode`` sees all-gathers, reduce-scatters and
    all-reduces in a train step, and collectives in the prefill."""
    for o in ranks[0]:
        c = o[arch]["train"]["comms"]
        assert c["all_gather"] >= 1 and c["reduce_scatter"] >= 1 \
            and c["all_reduce"] >= 1, c
        assert sum(o[arch]["serve"]["comms"].values()) >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_trace_matches_the_ranks_step(ranks, arch):
    """The dry run's traced step (``dryrun.trace_step``: fake tensors on
    a fake group of four) against what each rank's real second train
    step did on the same (2, 2) mesh, metered the same way: the same
    collective output bytes by kind, and the same peak of live bytes.
    The fake mode's own work (DTensor's propagation, its index tensors,
    the kernels' outputs seen before) adds and drops nothing."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as TM
    from repro_torch.sharding import place
    from repro_torch.sharding import rules as R
    cfg = get_smoke(arch)
    with D.fake_world(WORLD):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        params = TM.init_params(cfg, torch.Generator(), device="meta")
        batch = {k: torch.empty((B, L), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        params = place.shard_tree(params, R.param_specs(cfg, mesh, params),
                                  mesh)
        batch = place.shard_tree(batch, R.batch_spec(cfg, mesh, batch), mesh)
        meter = D.trace_step(cfg, {"kind": "train"}, params, batch)
    for o in ranks[0]:
        real = o[arch]["train"]["metered"]
        assert meter.collective_bytes == real["collective_bytes"]
        assert meter.peak == real["peak"], (meter.peak, real["peak"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(ranks, arch):
    """The sharded prefill and three batch-sharded decode steps: logits
    within ``tests/test_torch_generate.py``'s 1e-4 of the unsharded
    port's, the same greedy tokens, the same cache."""
    for o in ranks[0]:
        s = o[arch]["serve"]
        for d, m in zip(s["logits_diff"], s["logits_max"]):
            assert d <= 1e-4 + 1e-4 * m, (arch, s["logits_diff"])
        assert all(s["tokens_equal"]) and len(s["tokens_equal"]) == DECODE
        assert s["cache_diff"] <= 1e-4


def test_kv_heads_not_dividing_model(ranks):
    """llama on a (1, 4) mesh: one kv head, four ``model`` ranks, each
    with one query head reading the one kv head."""
    for o in ranks[0]:
        t, s = o["gqa_1x4"]["train"], o["gqa_1x4"]["serve"]
        np.testing.assert_allclose(t["loss_sharded"], t["loss"], rtol=1e-5)
        assert t["param_diff"] <= 1e-5 and t["local_bad"] == []
        assert max(s["logits_diff"]) <= 1e-4 + 1e-4 * max(s["logits_max"])
        assert all(s["tokens_equal"])


def test_compound_axis_block_order(ranks):
    """A dim sharded over ("pod", "data") splits pod-major: the rank at
    mesh coordinate (p, d) holds the reference's block of
    ``NamedSharding`` for the same spec."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("pod", "data"))
    idx = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(("pod", "data"))
    ).devices_indices_map((8, 3))
    for o in ranks[0]:
        p, d = o["blocks"]["coord"]
        rows = idx[mesh.devices[p, d]][0]
        assert o["blocks"]["rows"] == list(range(8))[rows]
        assert o["blocks"]["full"]


def test_entry_points_no_longer_not_ported(tmp_path):
    """``launch.train --production-mesh`` asks for its world of 256
    ranks (it never shrinks the mesh); ``launch.dryrun --multi-pod
    --device meta`` runs a pair per device of 512, its step traced (the
    long_500k decode: the parameters' bytes are every shape's)."""
    with pytest.raises(RuntimeError, match="256"):
        TT.main(["--device", "cpu", "--smoke", "--production-mesh"])
    res = D.main(["--device", "meta", "--multi-pod", "--arch",
                  "qwen3-moe-30b-a3b", "--shape", "long_500k", "--out-dir",
                  str(tmp_path)])
    assert [r["devices"] for r in res] == [512]
    assert res[0]["temp"] > 0 and sum(res[0]["collective_bytes"].values())
    assert round(res[0]["bytes"]["params"] / 1e9, 3) == 0.309
