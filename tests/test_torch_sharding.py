"""The port's sharding rules against the reference's, on the host
(1, 1), production (16, 16) and multi-pod (2, 16, 16) meshes, for every
config at full width (no process: the reference's specs are built on
``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` trees, the port's
on ``rules.abstract_mesh`` over ``meta`` tensors); the production-mesh
dry run's per-device bytes against the bytes the reference's specs
give; the meshes' world-size checks under fake process groups."""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES, get_config
from repro.launch import shapes as JS
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.configs import get_config as get_tconfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import shapes as TS
from repro_torch.models import model as TM
from repro_torch.sharding import place
from repro_torch.sharding import rules as R

MESHES = {"host": ((1, 1), ("data", "model")),
          "pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
GB = 1e9


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), R.abstract_mesh(sizes, names)


def _ref_leaves(tree):
    """{path: leaf} of a reference tree (dict keys only)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out[tuple(k.key for k in path)] = leaf
    return out


def _port_leaves(tree, path=()):
    """{path: leaf} of a port tree; a per-layer list's index is kept."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, path + (i,)))
        return out
    return {path: tree}


def _specs_equal(port, ref, stacked: bool):
    """Every leaf of ``port`` equals the reference's spec (without its
    leading stacked None for a per-layer leaf)."""
    want = _ref_leaves(ref)
    got = _port_leaves(port)
    seen = set()
    for path, spec in got.items():
        layer = stacked and path[0] in R.STACKED
        key = tuple(k for k in path if isinstance(k, str))
        ref = tuple(want[key])
        if layer:
            assert ref[0] is None, (key, ref)
            ref = ref[1:]
        assert isinstance(spec, R.P)
        assert tuple(spec) == ref, (path, spec, ref)
        seen.add(key)
    assert seen == set(want)


def _count(fn):
    R.reset_silent_replication_count()
    JR.reset_silent_replication_count()
    out = fn()
    return out, R.silent_replication_count(), JR.silent_replication_count()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_reference(arch):
    cfg, tcfg = get_config(arch), get_tconfig(arch)
    jshapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    tshapes = TM.init_params(tcfg, torch.Generator(), device="meta")
    for name in MESHES:
        jm, tm = _meshes(name)
        (ref, port), n_port, n_ref = _count(lambda: (
            JR.param_specs(cfg, jm, jshapes),
            R.param_specs(tcfg, tm, tshapes)))
        _specs_equal(port, ref, stacked=True)
        assert n_port == n_ref, (name, n_port, n_ref)
        if name != "host":
            assert n_port == (1 if arch == "hymba-1.5b" else 0), name
        for shape in ("train_4k", "prefill_32k"):
            jb = JS.input_specs(cfg, shape)["batch"]
            tb = TS.input_specs(tcfg, shape)["batch"]
            (ref, port), n_port, n_ref = _count(lambda: (
                JR.batch_spec(cfg, jm, jb), R.batch_spec(tcfg, tm, tb)))
            _specs_equal(port, ref, stacked=False)
            assert n_port == n_ref
        for shape in ("decode_32k", "long_500k"):
            if not JS.applicable(cfg, shape)[0]:
                continue
            js, ts = JS.input_specs(cfg, shape), TS.input_specs(tcfg, shape)
            (ref, port), n_port, n_ref = _count(lambda: (
                (JR.cache_specs(js["cfg"], jm, js["cache"]),
                 JR.decode_batch_spec(js["cfg"], jm, js["batch"])),
                (R.cache_specs(ts["cfg"], tm, ts["cache"]),
                 R.decode_batch_spec(ts["cfg"], tm, ts["batch"]))))
            _specs_equal(port[0], ref[0], stacked=False)
            _specs_equal(port[1], ref[1], stacked=False)
            assert n_port == n_ref


def _ref_bytes(cfg, mesh, shapes, specs) -> int:
    """Bytes one device holds of ``shapes`` laid out by the reference's
    ``specs``: each leaf divided by the sizes of the axes it names."""
    total = 0
    leaves = _ref_leaves(shapes)
    for key, spec in _ref_leaves(specs).items():
        leaf = leaves[key]
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        for entry in spec:
            if entry is not None:
                n //= JR.axis_size(mesh, entry)
        total += n
    return total


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dryrun_bytes_per_device(arch):
    """The production-mesh dry run's per-device parameter bytes are the
    reference's specs' (AdamW's mu and nu the same again each, the
    gradients once more); the silent replications are recorded."""
    cfg = get_config(arch)
    jshapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    for name, multi in (("pod1", False), ("pod2", True)):
        jm = _meshes(name)[0]
        want = _ref_bytes(cfg, jm, jshapes,
                          JR.param_specs(cfg, jm, jshapes))
        tel = D.Telemetry()
        with D.fake_world(512 if multi else 256):
            mesh = TMESH.make_production_mesh(multi_pod=multi, device="cpu")
            res = D.pair_report(arch, "train_4k", device="meta", mesh=mesh,
                                telemetry=tel, trace=False)
        assert res["devices"] == (512 if multi else 256)
        b = res["bytes"]
        assert b["params"] == want, (name, b["params"], want)
        assert b["opt_state"] == 2 * want and b["grads"] == want
        assert res["fits"] is None and "collective_bytes" not in res
        repl = 1 if arch == "hymba-1.5b" else 0
        assert res["silent_replications"] == repl
        assert tel.sharding_stats() == {"silent_replications": repl}


def test_published_per_device_bytes():
    """f32 masters per device of the two configs one card cannot train
    whole: llama4-maverick-400b-a17b 12.482 / 6.372 GB and
    qwen3-moe-30b-a3b 0.539 / 0.309 GB on (16, 16) / (2, 16, 16)."""
    want = {("llama4-maverick-400b-a17b", False): 12.482,
            ("llama4-maverick-400b-a17b", True): 6.372,
            ("qwen3-moe-30b-a3b", False): 0.539,
            ("qwen3-moe-30b-a3b", True): 0.309}
    for (arch, multi), gb in want.items():
        with D.fake_world(512 if multi else 256):
            mesh = TMESH.make_production_mesh(multi_pod=multi, device="cpu")
            res = D.pair_report(arch, "train_4k", device="meta", mesh=mesh,
                                trace=False)
        assert round(res["bytes"]["params"] / GB, 3) == gb, (arch, multi)


def test_maybe_counts_silent_replications():
    """The reference's counter cases (``tests/test_sharding.py``)."""
    mesh = R.abstract_mesh((1, 1), ("data", "model"))
    base = R.silent_replication_count()
    assert R.maybe(mesh, 10, "model") == "model"
    assert R.silent_replication_count() == base
    mesh4 = R.abstract_mesh((4,), ("data",))
    assert R.maybe(mesh4, 8, "data") == "data"
    assert R.silent_replication_count() == base
    assert R.maybe(mesh4, 6, "data") is None
    assert R.maybe(mesh4, 1, "data") is None
    assert R.silent_replication_count() == base + 2
    R.reset_silent_replication_count()
    assert R.silent_replication_count() == 0
    assert R.axis_size(mesh, ("data", "model")) == 1
    assert R.axis_size(mesh, None) == 1
    assert R.data_axes(R.abstract_mesh(*MESHES["pod2"])) == ("pod", "data")


def test_route_step_specs_equal_reference():
    ref = JR.route_step_specs(AbstractMesh((4,), (JR.CATALOG_AXIS,)))
    port = R.route_step_specs(R.abstract_mesh((4,), (R.CATALOG_AXIS,)))
    assert {k: tuple(v) for k, v in ref.items()} == \
        {k: tuple(v) for k, v in port.items()}
    assert R.route_step_specs(TMESH.make_routing_mesh(2, device="cpu"))
    with pytest.raises(AssertionError):
        R.route_step_specs(R.abstract_mesh(*MESHES["host"]))


def test_placements_of_specs():
    """A spec entry naming axis a is Shard(dim) on a's mesh dim; a
    compound entry shards one dim over both of its mesh dims, pod
    first; the rest replicate (or hold partial sums where asked)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = R.abstract_mesh(*MESHES["pod2"])
    assert place.placements(R.P(("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert place.placements(R.P(None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    assert place.placements(R.P("data"), mesh, partial=("model", "data")) \
        == [Replicate(), Shard(0), Partial()]


def test_meshes_need_their_world():
    """A production mesh needs a world of exactly 256 (512) ranks and
    never shrinks; under a fake group of that size it has the
    reference's shape and axis names, and ``shard_tree`` lays ``meta``
    tensors out as local shards."""
    with pytest.raises(RuntimeError, match="256"):
        TMESH.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512"):
        TMESH.make_production_mesh(multi_pod=True, device="cpu")
    with D.fake_world(256):
        with pytest.raises(RuntimeError, match="512"):
            TMESH.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(RuntimeError, match="one rank"):
            TMESH.make_host_mesh(device="cpu")
        mesh = TMESH.make_production_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (16, 16)
        assert R.mesh_axes(mesh) == {"data": 16, "model": 16}
        t = {"w": torch.empty(64, 48, device="meta")}
        local = place.shard_tree(t, {"w": R.P("data", "model")}, mesh)
        assert local["w"].to_local().shape == (4, 3)
        assert D.tree_bytes(local) == 4 * 3 * 4
    with D.fake_world(512):
        mesh = TMESH.make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert R.data_axes(mesh) == ("pod", "data")
