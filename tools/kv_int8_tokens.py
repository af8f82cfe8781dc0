"""Greedy tokens of the int8 KV cache's generation on the card, written
to a file so that two checkouts of the port can be compared.

    python3 tools/kv_int8_tokens.py --src OLD/src --out old.npz
    python3 tools/kv_int8_tokens.py --out new.npz --compare old.npz

Builds llama3.2-1b and gemma2-2b at their published widths and depths
with seeded bf16 weights (``ModelRunner(cfg, seed=47)``) and an int8 KV
cache, and generates 16 greedy tokens for 16 seeded prompts of 512
tokens, the int8 generation's served shape in ``chip_smoke.py``.  For
each model it writes the tokens and, at every step, the gap between the
two largest logits.  ``--compare`` prints, per model, the tokens equal to
the other file's, those before each row's first difference, and the
logit gap at each first difference (a near tie there means the two
kernels' rounding picked different argmaxes).  ``--src`` is the
``src`` directory whose ``repro_torch`` is imported (default: this
checkout's).  Needs one CUDA card."""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ARCHS = ("llama3.2-1b", "gemma2-2b")
B, PROMPT, MAX_NEW, SEED = 16, 512, 16, 47


def generate(name: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.runner import ModelRunner

    cfg = dataclasses.replace(get_config(name), kv_cache_dtype="int8")
    runner = ModelRunner(cfg, seed=SEED, device=torch.device("cuda", 0))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(B, PROMPT))
    before = FA.flash_decode_q8.launches
    res = runner.generate(prompts, MAX_NEW, keep_logits=True)
    top2 = np.partition(res.step_logits, -2, axis=-1)[..., -2:]
    bodies = getattr(FA.flash_decode_q8, "launches_by_body", None)
    print(f"{name}: {FA.flash_decode_q8.launches - before} int8 decode "
          f"launches (by body, all calls so far: {bodies})", flush=True)
    del runner
    torch.cuda.empty_cache()
    return res.tokens, np.abs(top2[..., 1] - top2[..., 0]).astype(np.float32)


def compare(got: dict, path: str) -> None:
    other = np.load(path)
    for name in ARCHS:
        a, b = other[f"{name}/tokens"], got[f"{name}/tokens"]
        same = a == b
        prefix = int(sum(np.cumprod(r).sum() for r in same))
        gaps = [float(min(other[f"{name}/gap"][i, j],
                          got[f"{name}/gap"][i, j]))
                for i, r in enumerate(same) if not r.all()
                for j in [int(np.argmin(r))]]
        print(f"{name}: tokens equal to {path}: {int(same.sum())} of "
              f"{same.size} ({prefix} before each row's first difference); "
              f"rows that differ {len(gaps)}, logit gap at their first "
              f"difference {[round(g, 4) for g in gaps]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kv_int8_tokens: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    print(f"repro_torch from {Path(repro_torch.__file__).parent}",
          flush=True)
    got = {}
    for name in ARCHS:
        got[f"{name}/tokens"], got[f"{name}/gap"] = generate(name)
    np.savez(args.out, **got)
    if args.compare:
        compare(got, args.compare)
    return 0


if __name__ == "__main__":
    sys.exit(main())
