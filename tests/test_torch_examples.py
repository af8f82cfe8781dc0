"""The torch twins of the examples run on the CPU through their own
``main`` (``--device cpu``), each within about a minute:
``examples/quickstart_torch.py``, ``serve_routed_torch.py`` and
``merge_models_torch.py``.  ``quickstart_torch``'s decisions equal the
reference example's on the same catalog, tie-aware: where the
reference's top two candidate scores lie within 1e-4 of each other the
model may differ (the two analyzers are trained to f32 rounding, not
bit for bit).  ``chip_smoke.py`` runs the three on the card."""
import importlib.util
from pathlib import Path

import pytest

from repro.core.analyzer import TaskAnalyzer as JTaskAnalyzer
from repro.core.orchestrator import OptiRoute as JOptiRoute
from repro.serving.catalog import build_catalog as jbuild_catalog

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TIE = 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _agree(got, want):
    if got.model == want.model:
        return
    top = sorted((s for _, s in want.candidates), reverse=True)[:2]
    assert len(top) == 2 and top[0] - top[1] < TIE, (got.model, want.model)


def test_quickstart_torch_decides_as_the_reference_example(capsys):
    ex = _load("quickstart_torch")
    routed, rerouted = ex.main(["--device", "cpu"])
    assert "re-route after feedback" in capsys.readouterr().out
    ref = _load("quickstart")
    analyzer = JTaskAnalyzer(ex.ANALYZER)
    analyzer.train(n_samples=1024, steps=120)
    router = JOptiRoute(jbuild_catalog(), analyzer)
    assert [p for p, _ in ex.QUERIES] == [p for p, _ in ref.QUERIES]
    want = []
    for (profile, text), got in zip(ref.QUERIES, routed):
        rq = router.route(text, profile)
        assert got.sig.task_type == rq.sig.task_type
        assert got.sig.domain == rq.sig.domain
        _agree(got.decision, rq.decision)
        want.append(rq)
    router.give_feedback(want[-1], thumbs_up=False)
    _agree(rerouted.decision, router.route(*ref.QUERIES[-1][::-1]).decision)


@pytest.mark.parametrize("mode", ["interactive", "batch"])
def test_serve_routed_torch_runs_on_the_cpu(mode, capsys):
    ex = _load("serve_routed_torch")
    resps, summary = ex.main(["--device", "cpu", "--requests", "8",
                              "--mode", mode])
    assert len(resps) == 8 and summary["requests"] == 8
    assert all(r.tokens is not None and len(r.tokens) == 4 for r in resps)
    assert sum(summary["models"].values()) == 8
    assert "== ledger ==" in capsys.readouterr().out


def test_merge_models_torch_soup_wins_the_reroute(capsys):
    ex = _load("merge_models_torch")
    before, after, soup, gen = ex.main(["--device", "cpu", "--steps", "20"])
    assert before.model == "ckpt-legal"
    assert after.model == soup.name and after.score > before.score
    assert soup.runner is not None and gen.tokens.shape == (1, 4)
    assert "soup runner generates" in capsys.readouterr().out


def test_examples_default_to_the_card():
    """Without ``--device`` every twin asks for the card (this machine
    has none, so each raises instead of running on the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    for name in ("quickstart_torch", "serve_routed_torch",
                 "merge_models_torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main([])
