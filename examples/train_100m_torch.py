"""End-to-end example of the PyTorch port: train a ~100M-parameter model
for a few hundred steps on synthetic LM data and show the loss dropping.

  PYTHONPATH=src python examples/train_100m_torch.py [--steps 250]
      [--device cpu]

The twin of ``examples/train_100m.py``: the port's training launcher
(``repro_torch.launch.train``) with the same custom llama-family config
(d_model 640, 16 layers, d_ff 2560, 16k vocab), the same AdamW settings,
data and checkpoints, on the card by default.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir", default="results/ckpt_100m_torch")
    args = ap.parse_args(argv)

    first, last = train_main([
        "--arch", "llama3.2-1b",
        "--d-model", "640", "--n-layers", "16", "--d-ff", "2560",
        "--vocab", "16384",
        "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--lr", "3e-4", "--warmup", "40",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
    ] + (["--device", args.device] if args.device else []))
    assert last < first * 0.7, "loss must drop by >30% over the run"
    print(f"OK: loss {first:.3f} -> {last:.3f}")
    return first, last


if __name__ == "__main__":
    main()
