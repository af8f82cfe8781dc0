"""Example on the PyTorch port: the section 5 model-merging fallback
with real weight soups.

  PYTHONPATH=src python examples/merge_models_torch.py [--device cpu]

The twin of ``examples/merge_models.py``.  Trains two same-config
reduced checkpoints (``make_train_step``) on different synthetic data
distributions from a shared init (the model-soups requirement), then:
  1. registers them in an MRES with complementary domain tags,
  2. routes a query whose best option was filtered out by domain,
  3. shows the ModelMerger synthesizing the soup entry (averaged
     weights via ModelRunner.merged_with) and winning the re-route.
On the card by default.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.merging import ModelMerger
from repro_torch.core.mres import MRES, ModelEntry
from repro_torch.core.preferences import TaskSignature, UserPreferences
from repro_torch.core.routing import RoutingEngine
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.runner import ModelRunner
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.steps import make_train_step


def train_runner(cfg, dev, data_seed, steps=40, init_seed=7):
    rng = np.random.default_rng(data_seed)
    base = rng.integers(2, cfg.vocab_size - 1, 64)
    gen = torch.Generator(device=dev).manual_seed(init_seed)
    params = M.init_params(cfg, gen, device=dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg)
    for _ in range(steps):
        starts = rng.integers(0, 64, 8)
        toks = np.stack([base[(s + np.arange(33)) % 64] for s in starts])
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev)}
        params, opt, _ = step(params, opt, batch)
    return ModelRunner(cfg, params=params, device=dev)


def entry(name, runner, acc, domains):
    return ModelEntry(
        name=name,
        raw_metrics=dict(accuracy=acc, latency_ms=50.0, cost_per_mtok=1.0,
                         helpfulness=0.5, harmlessness=0.5, honesty=0.5,
                         steerability=0.5, creativity=0.5),
        task_types=("summarization",), domains=domains,
        family="dense", n_params=runner.cfg.n_params(), runner=runner)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke("llama3.2-1b")
    print("== training two same-init checkpoints on different data ==")
    r_legal = train_runner(cfg, dev, data_seed=1, steps=args.steps)
    r_general = train_runner(cfg, dev, data_seed=2, steps=args.steps)

    mres = MRES()
    mres.register(entry("ckpt-legal", r_legal, 0.45, ("legal",)))
    mres.register(entry("ckpt-general", r_general, 0.95, ("general",)))
    eng = RoutingEngine(mres, device=dev)
    sig = TaskSignature(task_type="summarization", domain="legal",
                        complexity=0.6)
    prefs = UserPreferences(weights={"accuracy": 0.9})

    before = eng.route(prefs, sig)
    print(f"\nincumbent (domain=legal filters out the strong model): "
          f"{before.model} score={before.score:.3f}")

    merger = ModelMerger(mres, score_threshold=10.0)
    soup_entry = merger.maybe_merge(prefs, sig, before.score)
    assert soup_entry is not None
    print(f"soup created: {soup_entry.name} domains={soup_entry.domains}")
    assert soup_entry.runner is not None, "real weight soup expected"

    after = eng.route(prefs, sig)
    print(f"re-route: {after.model} score={after.score:.3f} "
          f"(gain {after.score - before.score:+.3f})")

    toks = np.arange(8, dtype=np.int32)[None] + 2
    gen = soup_entry.runner.generate(toks, max_new=4)
    print(f"soup runner generates: {gen.tokens.tolist()}")
    return before, after, soup_entry, gen


if __name__ == "__main__":
    main()
