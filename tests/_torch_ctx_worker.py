"""One rank of ``tests/test_torch_ctx_decode.py``: run as a script,
``python tests/_torch_ctx_worker.py RANK WORLD DIR``, by the test
module's fixture, four at once over gloo (a ``FileStore`` in DIR).  It
imports no JAX: the reference's parameters, prompts and greedy tokens
come as numpy in ``DIR/inputs.pt``, and each rank writes what it saw to
``DIR/rank<RANK>.json``.

For each batch-1 case: the port's prefill and decode steps unsharded,
then on each mesh of ``MESHES`` with the parameters laid out by
``param_specs``, the batch by ``batch_spec`` and the cache born in
``cache_specs``' batch-1 layout (slots over the data axes); every
decode step is fed the port's unsharded greedy token (the parent's).
Per mesh: the logits' distance to the unsharded run, the greedy tokens,
each rank's local cache length, the gathered cache against the
unsharded one, the collectives of the first step's attention calls
(``ops._decode_by_length``, each under its own ``dryrun.StepMeter``)
and of the whole second step.
"""
import dataclasses
import json
import sys
import traceback

import torch
import torch.distributed as dist

MESHES = (((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2, 1), ("pod", "data", "model")))


def _cfg(case):
    from repro_torch.configs import get_smoke
    cfg = get_smoke(case["arch"])
    if case["kv"]:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=case["kv"])
    return cfg


def _batch(case):
    b = {"tokens": torch.from_numpy(case["prompt"])}
    if case.get("src") is not None:
        b["src_embeds"] = torch.from_numpy(case["src"])
    return b


def _unsharded(case, params, cfg, pre, dec):
    """The port unsharded: prefill logits, each step's logits and greedy
    token (fed the case's), the final cache."""
    l0, c0, pos = pre(params, _batch(case))
    logits, toks = [l0], []
    for tok in case["feed"]:
        db = {"token": torch.tensor([[tok]], dtype=torch.int32), "pos": pos}
        l0, t0, c0 = dec(params, c0, db)
        logits.append(l0)
        toks.append(int(t0[0, 0]))
        pos = pos + 1
    return logits, toks, c0


def _metered_attention(calls: list):
    """``ops._decode_by_length`` with each call's collective bytes
    appended to ``calls``; undone by calling the result."""
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import StepMeter
    orig = ops._decode_by_length

    def call(*args, **kwargs):
        with StepMeter() as meter:
            out = orig(*args, **kwargs)
        calls.append(meter.collective_bytes)
        return out
    ops._decode_by_length = call
    return lambda: setattr(ops, "_decode_by_length", orig)


def _on_mesh(case, params, cfg, pre, dec, mesh, base):
    from repro_torch.launch.dryrun import StepMeter
    from repro_torch.sharding import place
    from repro_torch.sharding import rules as R
    want_logits, want_toks, want_cache = base
    sp = place.shard_tree(params, R.param_specs(cfg, mesh, params), mesh)
    b = _batch(case)
    l1, c1, pos = pre(sp, place.shard_tree(b, R.batch_spec(cfg, mesh, b),
                                           mesh))
    n_data = R.axis_size(mesh, R.data_axes(mesh))
    local_c = {k: [int(v.shape[2]), int(v.to_local().shape[2])]
               for k, v in c1.items()
               if k in ("k", "v", "k_scale", "v_scale", "cross_k",
                        "cross_v")}
    out = {"logits": [l1.full_tensor()[0].tolist()], "diff": [], "max": [],
           "tokens": [], "n_data": n_data, "local_c": local_c}
    for s, tok in enumerate(case["feed"]):
        db = {"token": torch.tensor([[tok]], dtype=torch.int32), "pos": pos}
        sdb = place.shard_tree(db, R.decode_batch_spec(cfg, mesh, db), mesh)
        if s == 0:
            out["attention"] = []
            undo = _metered_attention(out["attention"])
            try:
                l1, t1, c1 = dec(sp, c1, sdb)
            finally:
                undo()
        elif s == 1:
            with StepMeter() as meter:
                l1, t1, c1 = dec(sp, c1, sdb)
            out["collective_bytes"] = meter.collective_bytes
        else:
            l1, t1, c1 = dec(sp, c1, sdb)
        out["logits"].append(l1.full_tensor()[0].tolist())
        out["tokens"].append(int(t1.full_tensor()[0, 0]))
        pos = pos + 1
    out["gap"] = []
    for got, want in zip(out["logits"], want_logits):
        got = torch.tensor(got)
        out["diff"].append(float((got - want[0]).abs().max()))
        out["max"].append(float(want.abs().max()))
        top2 = want[0].topk(2).values
        out["gap"].append(float(top2[0] - top2[1]))
    out["want_tokens"] = want_toks
    full = place.gather_tree(c1)
    out["cache"] = {k: {"equal": bool(torch.equal(full[k], want_cache[k])),
                        "diff": float((full[k].double() -
                                       want_cache[k].double()).abs().max()),
                        "max": float(want_cache[k].double().abs().max())}
                    for k in want_cache}
    return out


def main(rank: int, world: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{path}/store",
                                                         world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import model as M
    from repro_torch.training.steps import make_decode_step, make_prefill_step
    inputs = torch.load(f"{path}/inputs.pt", weights_only=False)
    out = {}
    try:
        meshes = [init_device_mesh("cpu", shape, mesh_dim_names=names)
                  for shape, names in MESHES]
        for case in inputs["cases"]:
            cfg = _cfg(case)
            params = M.params_from_jax(case["params"])
            pre = make_prefill_step(cfg, long_mode=case["long_mode"],
                                    max_len=case["max_len"])
            dec = make_decode_step(cfg, long_mode=case["long_mode"])
            with torch.no_grad():
                base = _unsharded(case, params, cfg, pre, dec)
                out[case["name"]] = {
                    "x".join(map(str, m.shape)) + ":" +
                    ",".join(m.mesh_dim_names):
                    _on_mesh(case, params, cfg, pre, dec, m, base)
                    for m in meshes}
    except Exception:  # noqa: BLE001 -- reported to the test
        out["error"] = traceback.format_exc()
    with open(f"{path}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
