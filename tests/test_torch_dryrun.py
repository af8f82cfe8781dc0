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
from repro_torch.configs import ARCH_NAMES, get_smoke
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
        got = D.pair_report(name, shape, device="meta")
        assert got["status"] == "ok" and got["devices"] == 1
        assert got["fits"] is None and got["collective_bytes"] is None
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
    long = D.pair_report("gemma2-2b", "long_500k", device="meta")
    short = D.pair_report("gemma2-2b", "decode_32k", device="meta")
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
