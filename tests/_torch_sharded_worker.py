"""One rank of ``tests/test_torch_sharded_steps.py``: run as a script,
``python tests/_torch_sharded_worker.py RANK WORLD DIR``, by the test
module's fixture, four at once over gloo (a ``FileStore`` in DIR).  It
imports no JAX: the reference's parameters and batches come as numpy
in ``DIR/inputs.pt`` (written by the parent), and each rank writes what
it saw to ``DIR/rank<RANK>.json``.

On a (2, 2) ("data", "model") mesh, for each config: two train steps
of the port unsharded and of the port on DTensor parameters laid out
by ``param_specs`` (batches by ``batch_spec``), with the collectives of
the first sharded step counted by ``CommDebugMode`` and the second
metered as the dry run's trace meters it (``dryrun.StepMeter``: its
collective bytes by kind and its peak of live bytes); each rank's local
shapes against the specs; a prefill and three decode steps unsharded
and sharded (cache by ``cache_specs``, batch-sharded).  Then llama on a
(1, 4) mesh (one kv head, four ``model`` ranks), and the block of a
compound ("pod", "data") spec each rank holds."""
import json
import sys
import traceback

import torch
import torch.distributed as dist


def _comm_counts(cm) -> dict:
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    for op, n in cm.get_comm_counts().items():
        name = str(op).lower()
        for kind in out:
            if kind.replace("_", "") in name.replace("_", ""):
                out[kind] += n
    return out


def _max_diff(a, b) -> float:
    from repro_torch.training.optimizer import leaves
    return max(float((x - y).abs().max()) for x, y in zip(leaves(a),
                                                          leaves(b)))


def _local_shapes_ok(tree, specs, mesh) -> list:
    """Leaves whose local shard is not the global shape divided by the
    sizes of the axes their spec names."""
    from repro_torch.sharding import rules as R
    from repro_torch.training.optimizer import leaves
    bad = []
    for t, spec in zip(leaves(tree), _spec_leaves(specs)):
        want = list(t.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                want[d] //= R.axis_size(mesh, entry)
        if list(t.to_local().shape) != want:
            bad.append([list(t.shape), list(t.to_local().shape), want])
    return bad


def _spec_leaves(tree):
    from repro_torch.sharding.rules import P
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    assert isinstance(tree, P)
    return [tree]


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def train_case(cfg, params, batches, mesh) -> dict:
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.dryrun import StepMeter, kernels_as_outputs
    from repro_torch.sharding import place
    from repro_torch.sharding import rules as R
    from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                                leaves)
    from repro_torch.training.steps import make_train_step
    step = make_train_step(cfg, AdamWConfig())
    p0, o0 = params, init_opt_state(params)
    specs = R.param_specs(cfg, mesh, params)
    sp = place.shard_tree(params, specs, mesh)
    so = init_opt_state(sp)
    out = {"loss": [], "loss_sharded": [], "gnorm": [], "gnorm_sharded": [],
           "local_bad": _local_shapes_ok(sp, specs, mesh)}
    for i, b in enumerate(batches):
        b = _tensors(b)
        p0, o0, m0 = step(p0, o0, b)
        sb = place.shard_tree(b, R.batch_spec(cfg, mesh, b), mesh)
        if i == 1:              # what the dry run's trace would count
            meter = StepMeter([t.to_local() for t in leaves([sp, so, sb])
                               if isinstance(t, torch.Tensor)])
            with kernels_as_outputs(meter), meter:
                sp, so, m1 = step(sp, so, sb)
            out["metered"] = {"collective_bytes": meter.collective_bytes,
                              "peak": meter.peak}
        else:
            with CommDebugMode() as cm:
                sp, so, m1 = step(sp, so, sb)
            out["comms"] = _comm_counts(cm)
        out["loss"].append(float(m0["loss"]))
        out["loss_sharded"].append(float(m1["loss"]))
        out["gnorm"].append(float(m0["gnorm"]))
        out["gnorm_sharded"].append(float(m1["gnorm"]))
    out["param_diff"] = _max_diff(p0, place.gather_tree(sp))
    out["mu_diff"] = _max_diff(o0["mu"], place.gather_tree(so["mu"]))
    out["nu_diff"] = _max_diff(o0["nu"], place.gather_tree(so["nu"]))
    out["local_bad"] += _local_shapes_ok(so["mu"], specs, mesh)
    return out


def serve_case(cfg, params, prompt, mesh, steps: int) -> dict:
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.sharding import place
    from repro_torch.sharding import rules as R
    from repro_torch.training.steps import make_decode_step, make_prefill_step
    pre = make_prefill_step(cfg, max_len=prompt.shape[1] + steps + 4)
    dec = make_decode_step(cfg)
    out = {"logits_diff": [], "tokens_equal": [], "logits_max": []}
    with torch.no_grad():
        sp = place.shard_tree(params, R.param_specs(cfg, mesh, params), mesh)
        b = {"tokens": torch.from_numpy(prompt)}
        l0, c0, pos = pre(params, b)
        with CommDebugMode() as cm:
            l1, c1, _ = pre(sp, place.shard_tree(
                b, R.batch_spec(cfg, mesh, b), mesh))
        out["comms"] = _comm_counts(cm)
        want_specs = R.cache_specs(cfg, mesh, c0)
        out["cache_bad"] = _local_shapes_ok(c1, want_specs, mesh)
        out["logits_diff"].append(float((l0 - l1.full_tensor()).abs().max()))
        out["logits_max"].append(float(l0.abs().max()))
        tok = torch.argmax(l0, dim=-1)[:, None]
        for _ in range(steps):
            db = {"token": tok, "pos": pos}
            l0, t0, c0 = dec(params, c0, db)
            l1, t1, c1 = dec(sp, c1, place.shard_tree(
                db, R.decode_batch_spec(cfg, mesh, db), mesh))
            out["logits_diff"].append(
                float((l0 - l1.full_tensor()).abs().max()))
            out["logits_max"].append(float(l0.abs().max()))
            out["tokens_equal"].append(bool((t0 == t1.full_tensor()).all()))
            tok, pos = t0, pos + 1
        out["cache_diff"] = _max_diff(c0, place.gather_tree(c1))
    return out


def block_case(mesh) -> dict:
    """The rows of an (8, 3) arange that a ("pod", "data")-sharded dim
    leaves on this rank, and its mesh coordinate."""
    from repro_torch.sharding import place
    from repro_torch.sharding.rules import P
    t = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    d = place.shard_tree({"t": t}, {"t": P(("pod", "data"))}, mesh)["t"]
    rows = (d.to_local()[:, 0] / 3).long().tolist()
    return {"coord": mesh.get_coordinate(), "rows": rows,
            "full": bool(torch.equal(d.full_tensor(), t))}


def main(rank: int, world: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{path}/store",
                                                         world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    inputs = torch.load(f"{path}/inputs.pt", weights_only=False)
    out = {}
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        for arch, job in inputs["archs"].items():
            cfg = get_smoke(arch)
            params = M.params_from_jax(job["params"])
            out[arch] = {"train": train_case(cfg, params, job["batches"],
                                             mesh),
                         "serve": serve_case(cfg, params, job["prompt"],
                                             mesh, inputs["decode_steps"])}
        job = inputs["archs"]["llama3.2-1b"]
        cfg = get_smoke("llama3.2-1b")
        params = M.params_from_jax(job["params"])
        mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data",
                                                                 "model"))
        out["gqa_1x4"] = {"train": train_case(cfg, params, job["batches"][:1],
                                              mesh14),
                          "serve": serve_case(cfg, params, job["prompt"],
                                              mesh14, 2)}
        pods = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod",
                                                               "data"))
        out["blocks"] = block_case(pods)
    except Exception:  # noqa: BLE001 -- reported to the test
        out["error"] = traceback.format_exc()
    with open(f"{path}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
