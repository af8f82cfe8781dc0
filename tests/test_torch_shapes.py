"""``repro_torch.launch.shapes`` against the JAX package's
``launch/shapes.py``: for every arch x shape, ``applicable`` and its
reason, ``text_len``, and every spec -- the batch, and a decode shape's
cache, flag and effective config -- with the reference's shapes and
dtypes, as ``meta`` tensors that allocate nothing."""
import dataclasses

import pytest

from repro.configs import get_config as jget_config
from repro.launch import shapes as JS
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import shapes as TS


def _same(got, want, where):
    assert set(got) == set(want), where
    for key, w in want.items():
        g = got[key]
        assert g.is_meta and g.data_ptr() == 0, (where, key)
        assert tuple(g.shape) == tuple(w.shape), (where, key)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (where, key)


def test_shape_table_matches_reference():
    assert TS.SHAPES == JS.SHAPES


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_match_reference(name):
    jcfg, tcfg = jget_config(name), get_config(name)
    for shape in JS.SHAPES:
        assert TS.applicable(tcfg, shape) == JS.applicable(jcfg, shape)
        seq = JS.SHAPES[shape]["seq_len"]
        assert TS.text_len(tcfg, seq) == JS.text_len(jcfg, seq)
        want, got = JS.input_specs(jcfg, shape), TS.input_specs(tcfg, shape)
        assert set(got) == set(want) and got["kind"] == want["kind"]
        _same(got["batch"], want["batch"], (name, shape))
        if want["kind"] == "decode":
            _same(got["cache"], want["cache"], (name, shape, "cache"))
            assert got["long_mode"] == want["long_mode"]
            assert dataclasses.asdict(got["cfg"]) == \
                dataclasses.asdict(want["cfg"])


def test_not_applicable_reason_matches_reference():
    """A full-attention config with no long-serving window is not
    sub-quadratic: long_500k is n/a, with the reference's reason."""
    j = dataclasses.replace(jget_config("llama3.2-1b"), long_serving_window=0)
    t = dataclasses.replace(get_config("llama3.2-1b"), long_serving_window=0)
    got = TS.applicable(t, "long_500k")
    assert got == JS.applicable(j, "long_500k") and got[0] is False
    assert "sub-quadratic" in got[1]


def test_long_500k_gemma2_is_long_mode_on_a_ring():
    spec = TS.input_specs(get_config("gemma2-2b"), "long_500k")
    assert spec["long_mode"] is True
    assert tuple(spec["cache"]["k"].shape) == (26, 1, 4096, 4, 288)
    spec = TS.input_specs(get_config("llama3.2-1b"), "long_500k")
    assert spec["long_mode"] is False and spec["cfg"].sliding_window == 4096
    assert tuple(spec["cache"]["k"].shape) == (16, 1, 4096, 8, 64)
