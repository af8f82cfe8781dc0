"""``repro_torch.launch.dryrun`` on the CPU (``device="meta"``).

For every (arch, shape) pair at full width: the parameter, optimizer and
cache bytes equal the bytes of the reference's abstract trees
(``jax.eval_shape`` of ``init_params``, ``init_opt_state`` and
``init_cache``; no mesh, no compile) exactly -- the reference's
optimizer tree also holds its step counter, an int32 scalar on the
device, which the port keeps as a host int -- and ``n/a`` pairs carry
``applicable``'s reason.  The FLOPs of llama3.2-1b at ``SMOKE`` are held
to ``torch.utils.flop_counter.FlopCounterMode`` over the same prefill
and decode steps on the CPU: the projections exactly, and the attention
term against the module's formula (4 * head_dim per live pair and head;
the CPU's plain attention multiplies every (query, key) pair of its
square, masked ones included, which the counter sees)."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.launch import shapes as JS
from repro.models import model as JM
from repro.training.optimizer import init_opt_state as jinit_opt
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.launch import dryrun as D
from repro_torch.models import model as TM


def _nbytes(tree):
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bytes_match_reference_abstract_trees(name):
    jcfg = jget_config(name)
    params = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    opt = jax.eval_shape(lambda: jinit_opt(params))
    assert opt["step"].shape == () and opt["step"].dtype == np.int32
    for shape in JS.SHAPES:
        got = D.pair_report(name, shape, device="meta", trace=False)
        assert got["status"] == "ok" and got["devices"] == 1
        assert got["fits"] is None and "collective_bytes" not in got
        assert got["n_params"] == jcfg.n_params()
        assert got["n_active_params"] == jcfg.n_active_params()
        b = got["bytes"]
        assert b["params"] == _nbytes(params)
        spec = JS.input_specs(jcfg, shape)
        assert b["batch"] == _nbytes(spec["batch"])
        if spec["kind"] == "train":
            assert b["opt_state"] == _nbytes(opt) - 4
            assert b["grads"] == b["params"]
        else:
            assert "opt_state" not in b
        if spec["kind"] == "decode":
            assert b["cache"] == _nbytes(spec["cache"])
        assert b["resident"] == sum(v for k, v in b.items()
                                    if k != "resident")
        assert got["flops"] == sum(got["flop_terms"].values()) > 0


def test_not_applicable_pairs_carry_the_reference_reason():
    jcfg = jget_config("llama3.2-1b")
    want = JS.applicable(dataclasses.replace(jcfg, long_serving_window=0),
                         "long_500k")
    got = D.pair_report("llama3.2-1b", "long_500k", device="meta",
                        overrides={"long_serving_window": 0})
    assert got == {"arch": "llama3.2-1b", "shape": "long_500k",
                   "status": "n/a", "reason": want[1]}


def _counted(fn):
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


def test_flops_match_the_counter_on_a_dense_config():
    cfg = get_smoke("llama3.2-1b")
    B, L = 2, 40
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32))
    nL, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
    # prefill: the last row's logits
    terms = D.forward_flops(cfg, B, L, logits_rows=B)
    counted = _counted(lambda: TM.prefill(tp, cfg, {"tokens": toks}))
    assert terms["attention"] == 4 * hd * H * B * D.causal_pairs(L) * nL
    assert counted - 4 * hd * H * B * L * L * nL == terms["projections"]
    assert terms["experts"] == terms["ssm"] == 0
    # forward_full: every row's logits
    terms = D.forward_flops(cfg, B, L)
    counted = _counted(lambda: TM.forward_full(tp, cfg, {"tokens": toks}))
    assert counted - 4 * hd * H * B * L * L * nL == terms["projections"]
    # a decode step at the cache's last position: every slot live
    cache = TM.init_cache(cfg, B, L, device="cpu")
    terms = D.decode_flops(cfg, B, L, cache)
    batch = {"token": toks[:, :1], "pos": torch.full((B,), L - 1)}
    counted = _counted(lambda: TM.decode_step(tp, cfg, cache, batch))
    assert terms["attention"] == 4 * hd * H * B * L * nL
    assert counted == terms["projections"] + terms["attention"]


def test_windowed_and_long_mode_pairs():
    """Every layer's band in long_mode: gemma2's long_500k decode sees
    4,096 keys on every layer, its decode_32k 4,096 on the local layers
    and 32,768 on the global ones."""
    cfg = D.get_config("gemma2-2b")
    long = D.pair_report("gemma2-2b", "long_500k", device="meta",
                         trace=False)
    short = D.pair_report("gemma2-2b", "decode_32k", device="meta",
                          trace=False)
    per = 4 * cfg.head_dim * cfg.n_heads
    assert long["long_mode"] and not short["long_mode"]
    assert long["flop_terms"]["attention"] == per * 4096 * cfg.n_layers
    assert short["flop_terms"]["attention"] == per * 128 * (
        13 * 4096 + 13 * 32768)
    assert D.causal_pairs(10, 4) == 4 * 5 // 2 + 6 * 4


def test_cli_writes_and_caches_results(tmp_path, capsys):
    args = ["--device", "meta", "--arch", "mamba2-1.3b", "--shape",
            "long_500k", "--out-dir", str(tmp_path)]
    res = D.main(args)
    assert [r["status"] for r in res] == ["ok"]
    assert res[0]["collective_bytes"] == {} and res[0]["temp"] > 0
    out = tmp_path / "mamba2-1.3b__long_500k__meta.json"
    assert json.loads(out.read_text()) == res[0]
    assert D.main(args) == res                  # served from the cache
    assert "[skip]" in capsys.readouterr().out
    pod = D.main(args + ["--multi-pod"])        # per device of 512
    assert [r["devices"] for r in pod] == [512]
    assert 0 < pod[0]["bytes"]["params"] < res[0]["bytes"]["params"]
    assert (tmp_path / "mamba2-1.3b__long_500k__pod2__meta.json").exists()
    with pytest.raises(ValueError, match="meta"):
        D.pair_report("mamba2-1.3b", "long_500k", device="cpu")


# ----------------------------------------------------------------------
# the traced step
# ----------------------------------------------------------------------

def smoke_overrides(arch: str) -> dict:
    """The fields in which the arch's ``SMOKE`` config differs from its
    published one: ``pair_report``'s overrides for a check at ``SMOKE``."""
    full, smoke = get_config(arch), get_smoke(arch)
    out = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
           if f.init and getattr(smoke, f.name) != getattr(full, f.name)}
    assert dataclasses.replace(full, **out) == smoke
    return out


def test_one_sharded_matmul_collective_bytes():
    """On a fake (2, 2) group, under the trace's fake mode: x (8, 16)
    rows over ``data`` and its contraction over ``model`` times w (16,
    32) split the same way leaves partial sums over ``model``; reducing
    them is one all-reduce whose output is a rank's (4, 32) f32 block:
    512 bytes, and nothing else moves."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    with D.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = DTensor.from_local(torch.empty(4, 8), mesh,
                                   [Shard(0), Shard(1)], run_check=False)
            w = DTensor.from_local(torch.empty(8, 32), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            with D.StepMeter(fake=True) as meter:
                y = x @ w
                assert tuple(y.placements) == (Shard(0), Partial())
                y = y.redistribute(placements=[Shard(0), Replicate()])
    assert meter.collective_bytes == {"all-reduce": 4 * 32 * 4}
    assert tuple(y.to_local().shape) == (4, 32)


def test_one_card_trace_moves_nothing():
    """One card: every shape's traced step is ``ok`` with an empty
    ``collective_bytes`` (no collective) and a positive ``temp``."""
    for shape in JS.SHAPES:
        got = D.pair_report("llama3.2-1b", shape, device="meta",
                            overrides=smoke_overrides("llama3.2-1b"))
        assert got["status"] == "ok", got
        assert got["collective_bytes"] == {} and got["temp"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b-a3b"])
def test_production_mesh_trace_at_smoke(arch, monkeypatch):
    """At ``SMOKE`` on the fake (16, 16) mesh every shape's step traces
    ``ok``: the train step issues all-gathers, all-reduces and
    reduce-scatters, every step a positive ``temp``; the long_500k
    decode runs on the batch-1 layout, one ``_decode_by_length`` call a
    layer (the cache split by length, never gathered), its collectives
    a small share of the train step's."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_production_mesh
    calls = []
    orig = ops._decode_by_length

    def counted(*args, **kwargs):
        calls.append(args[2][0].shape)
        return orig(*args, **kwargs)
    monkeypatch.setattr(ops, "_decode_by_length", counted)
    out = {}
    with D.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        for shape in JS.SHAPES:
            out[shape] = D.pair_report(arch, shape, device="meta", mesh=mesh,
                                       overrides=smoke_overrides(arch))
    for shape, r in out.items():
        assert r["status"] == "ok", (shape, r.get("trace"))
        assert r["temp"] > 0 and r["devices"] == 256, shape
    train = out["train_4k"]["collective_bytes"]
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(train)
    assert all(v > 0 for v in train.values())
    cfg = get_smoke(arch)
    long_calls = calls[-cfg.n_layers:]
    assert len(long_calls) == cfg.n_layers
    # (B, C, Hkv, hd) global: batch 1, the long_500k ring
    assert all(s[0] == 1 for s in long_calls)
    long = sum(out["long_500k"]["collective_bytes"].values())
    assert 0 < long < sum(train.values()) / 100


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "train_4k"),
                                        ("hymba-1.5b", "prefill_32k")])
def test_production_mesh_trace_at_published_widths(arch, shape):
    """One layer at the published widths on the fake (16, 16) mesh: the
    train step of a model whose heads do not divide ``model`` (gemma2's
    8 heads of 288: the gradient of the merged heads must come back in
    whole heads, ``layers.merge_heads``) and the prefill of a ring
    shorter than the prompt (hymba's roll of the cache, slices a DTensor
    takes) trace ``ok``."""
    from repro_torch.launch.mesh import make_production_mesh
    with D.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        r = D.pair_report(arch, shape, device="meta", mesh=mesh,
                          overrides={"n_layers": 1})
    assert r["status"] == "ok", r.get("trace")
    assert r["temp"] > 0 and sum(r["collective_bytes"].values()) > 0
