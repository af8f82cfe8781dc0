"""Training launcher (port of the JAX package's ``launch/train.py``).

Trains any config of the zoo (reduced with ``--smoke``, published, or a
custom ``--d-model`` size) with the AdamW train step of
``training/steps``, on the reference's synthetic LM data (the same
numpy draws for the same seed), with checkpoints in the reference's
layout (``params_to_numpy``: a checkpoint of either package loads in
the other).  On the card (the default) the attention, SSD scan and MoE
gate go forward and backward through their hand-written kernels;
``--device cpu`` asks for the plain PyTorch versions.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 30

``--production-mesh`` trains on the reference's (16, 16) ("data",
"model") mesh: under ``torchrun`` with 256 ranks (a world of another
size raises, naming 256; nothing shrinks the mesh),
``launch/mesh.make_production_mesh`` builds it, the parameters, AdamW's
state and each batch are laid out by ``sharding/rules`` as DTensors
(``sharding/place.shard_tree``: every rank draws the same parameters and
batch from the seed, rank 0's are scattered), and the step runs the
kernels on each rank's blocks.  Checkpoints of a sharded run are
gathered (``place.gather_tree``) and written by rank 0 in the
reference's layout.

  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \\
      --production-mesh --arch llama3.2-1b
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.device import resolve_device, set_fp32_precision
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.sharding import place
from repro_torch.sharding import rules as R
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.steps import make_train_step


def make_lm_sampler(rng, cfg):
    """Synthetic LM data, the reference's: a FIXED token cycle (the
    learnable structure) + 5% replacement noise.  ``sample(batch, seq)``
    gives numpy arrays, the same as the reference's for the same ``rng``
    state: tokens / labels (batch, seq) int32, and seamless's
    ``src_embeds`` (batch, 16, frontend_dim) or llava's ``frontend``
    (batch, frontend_tokens, frontend_dim) f32."""
    base = rng.integers(2, cfg.vocab_size - 1, 257)

    def sample(batch, seq):
        starts = rng.integers(0, 257, batch)
        toks = np.stack([base[(s + np.arange(seq + 1)) % 257]
                         for s in starts])
        noise = rng.random((batch, seq + 1)) < 0.05
        toks = np.where(noise, rng.integers(2, cfg.vocab_size - 1,
                                            (batch, seq + 1)), toks)
        b = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
        if cfg.is_encdec:
            b["src_embeds"] = rng.standard_normal(
                (batch, 16, cfg.frontend_dim)).astype(np.float32)
        elif cfg.frontend:
            b["frontend"] = rng.standard_normal(
                (batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                    np.float32)
        return b

    return sample


def to_device(batch, device):
    """A sampler batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_config(args):
    """The config ``args`` name, the reference's: ``--d-model`` gives a
    custom size (heads of 64, a GQA group of 4)."""
    if args.d_model:
        base = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        n_heads = max(args.d_model // 64, 2)
        n_kv = max(n_heads // 4, 1)
        while n_heads % n_kv:                   # GQA group must divide
            n_kv -= 1
        return dataclasses.replace(
            base, d_model=args.d_model, n_layers=args.n_layers or base.n_layers,
            n_heads=n_heads, n_kv_heads=n_kv,
            d_ff=args.d_ff or 4 * args.d_model,
            vocab_size=args.vocab or base.vocab_size,
            name=f"{base.name}-custom").validate()
    return get_smoke(args.arch) if args.smoke else get_config(args.arch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) mesh: 256 ranks "
                         "under torchrun")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = make_production_mesh(device=dev) if args.production_mesh \
        else None
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    set_fp32_precision()
    cfg = build_config(args)
    n_dev = mesh.size() if mesh is not None else \
        torch.cuda.device_count() if dev.type == "cuda" else 1
    lead = mesh is None or mesh.get_rank() == 0
    if lead:
        print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params "
              f"({cfg.n_active_params()/1e6:.1f}M active), "
              f"{n_dev} device(s)")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    if mesh is not None:
        params = place.shard_tree(params, R.param_specs(cfg, mesh, params),
                                  mesh)
    opt = init_opt_state(params)
    sampler = make_lm_sampler(rng, cfg)
    step = make_train_step(cfg, AdamWConfig(lr=args.lr,
                                            warmup_steps=args.warmup))
    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = to_device(sampler(args.batch, args.seq), dev)
        if mesh is not None:
            batch = place.shard_tree(batch, R.batch_spec(cfg, mesh, batch),
                                     mesh)
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if lead and (i % args.log_every == 0 or i == args.steps - 1):
            dt = time.time() - t0
            tput = (i + 1) * args.batch * args.seq / dt
            print(f"[train] step {i:>5} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} "
                  f"({tput:.0f} tok/s)", flush=True)
        if cm and (i + 1) % args.ckpt_every == 0:
            whole = place.gather_tree(params)        # every rank gathers
            if lead:
                cm.save(i + 1, M.params_to_numpy(whole, cfg),
                        {"loss": losses[-1]})

    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    if lead:
        print(f"[train] done: loss {first:.4f} -> {last:.4f} "
              f"({(1 - last / first):.1%} drop)")
    return first, last


if __name__ == "__main__":
    main()
