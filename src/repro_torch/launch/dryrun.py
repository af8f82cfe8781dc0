"""Dry run: what each (arch x shape) pair holds and computes, on one
card or per device of the production mesh.

Port of the JAX package's ``launch/dryrun.py``.  The reference lowers
each pair on its production TPU mesh and reads XLA's memory and cost
analyses and the HLO's collective bytes.  The port has no HLO.  For
each pair it builds the step's inputs on the ``meta`` device -- the
parameters through ``init_params``, AdamW's state through
``init_opt_state``, the cache through ``init_cache``, the batch through
``launch/shapes`` -- and reports, per pair:

  * ``status``: ``ok``, ``n/a`` (``shapes.applicable``'s reason) or
    ``error`` (the traceback's tail); ``devices``: 1, or the mesh's
    256 / 512;
  * ``bytes`` (per device): ``params``, ``opt_state`` (train),
    ``grads`` (train: one per parameter, in its dtype and layout),
    ``cache`` (decode), ``batch``, and ``resident``, their sum
    (activations and kernel scratch are not counted);
  * ``n_params`` and ``n_active_params``;
  * ``flops`` of one step (the whole step, all devices) and their terms
    (``flop_terms``);
  * ``collective_bytes``: null.  The reference reads them from the
    compiled HLO; the port has no program to read them from, and
    counting them through a fake-tensor run of the step under
    ``CommDebugMode`` is queued (ROADMAP.md Queue 1 item 7);
  * ``fits``: on the card, whether ``resident`` fits its
    ``total_memory``; null on ``device="meta"``.

The production mesh (``--production-mesh``: (16, 16), 256 devices;
``--multi-pod``: (2, 16, 16), 512) runs in one process under a fake
process group of that many ranks: ``launch/mesh.make_production_mesh``
builds the mesh, ``sharding/rules`` the specs -- with
``silent_replications``, the ``maybe`` fallbacks counted around their
construction, warned about as the reference does and recorded into a
``Telemetry`` (``record_sharding``) -- and ``sharding/place.shard_tree``
lays the meta tensors out, so each byte count is one rank's local
shards.

Nothing here runs a step: meta tensors never reach a kernel wrapper.
The FLOPs are counted from the config and the specs' shapes.

FLOP convention (what ``flops`` counts):

  * 2 per multiply-add of every projection: q/k/v/o, the MLP's three,
    the MoE router, the SSM's in/out projections, the frontend
    projection and the LM head (every row in a train step, the last
    row of each sequence in a prefill, the one row of a decode);
  * MoE: 2 per multiply-add of every expert slot the port computes --
    E x groups x capacity slots of the three expert products, empty
    slots included -- plus the per-token combine (k x d), and a shared
    expert's MLP on every token;
  * attention: 4 * head_dim per live (query, key) pair and query head
    (Q K^T and P V; the bound convention of ``PERF.md`` section 6):
    causal pairs within the layer's window in a prefill (every layer's
    window in ``long_mode``), all S x S pairs in the encoder, L x S in
    a cross-attention; a decode step's one query sees the keys live at
    the shape's last position (pos = seq_len - 1): the cache's C slots,
    or the window of a local layer;
  * SSM (Mamba2): the depthwise causal conv, 2 * width per channel and
    token; the chunked scan per chunk of q positions, 2 q^2 N (C B^T)
    + H (2 q^2 P (the intra-chunk output) + 4 q N P (chunk state and
    its read-out)); a decode's state step, 4 P N per head;
  * a train step is forward + backward, 3 x the forward, plus the
    decoder layers' forward again where ``cfg.remat`` recomputes them;
  * norms, RoPE, softmax, the gate's top-k and other element-wise work
    are not counted.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
      --multi-pod                            # per device of 512
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape long_500k                      # on the card (fits)
Results are cached as JSON under results/dryrun_torch/ (skip with
--force).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import traceback
from typing import Dict, Optional

import torch

import contextlib
import warnings

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.telemetry import Telemetry
from repro_torch.device import resolve_device
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.sharding import place
from repro_torch.sharding import rules as R
from repro_torch.training.optimizer import init_opt_state, leaves

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (dicts and lists): of a DTensor,
    its local shard's (what one rank holds)."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if place.is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


# ----------------------------------------------------------------------
# FLOPs
# ----------------------------------------------------------------------

def causal_pairs(L: int, window: int = 0) -> int:
    """Live (query, key) pairs of a causal sequence of L, each query
    seeing at most ``window`` keys (0: all earlier ones)."""
    if not window or L <= window:
        return L * (L + 1) // 2
    return window * (window + 1) // 2 + (L - window) * window


def _attn_proj(cfg: ModelConfig, T: int, Tkv: int) -> int:
    d = cfg.d_model
    return 2 * T * d * cfg.q_dim * 2 + 2 * Tkv * d * 2 * cfg.kv_dim


def _attn_core(cfg: ModelConfig, pairs: int) -> int:
    return 4 * cfg.head_dim * cfg.n_heads * pairs


def _ffn(cfg: ModelConfig, B: int, L: int, terms: Dict[str, int]) -> None:
    d, f, T = cfg.d_model, cfg.d_ff, B * L
    if cfg.is_moe:
        E, K = cfg.n_experts, cfg.moe_top_k
        slots = 0
        g = min(cfg.moe_group, L)
        for gl, ng in ((g, L // g), (L - (L // g) * g, 1)):
            if gl and ng:
                C = max(1, math.ceil(gl * K / E * cfg.moe_capacity_factor))
                slots += E * B * ng * C
        terms["projections"] += 2 * T * d * E
        terms["experts"] += 2 * 3 * d * f * slots + 2 * T * K * d
        if cfg.shared_expert:
            terms["experts"] += 2 * T * 3 * d * f
    elif f > 0:
        terms["projections"] += 2 * T * 3 * d * f


def _ssm(cfg: ModelConfig, B: int, L: int, terms: Dict[str, int],
         decode: bool) -> None:
    d, di, N, H, P = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    T = B * L
    conv_dim = di + 2 * N
    terms["projections"] += 2 * T * d * (2 * di + 2 * N + H) + 2 * T * di * d
    terms["ssm"] += 2 * T * conv_dim * cfg.ssm_conv_width
    if decode:
        terms["ssm"] += 4 * T * H * P * N
        return
    Q = cfg.ssm_chunk
    for q in [Q] * (L // Q) + ([L % Q] if L % Q else []):
        terms["ssm"] += B * (2 * q * q * N + H * (2 * q * q * P
                                                 + 4 * q * N * P))


def forward_flops(cfg: ModelConfig, B: int, Lt: int, *, F: int = 0,
                  S_enc: int = 0, long_mode: bool = False,
                  logits_rows: Optional[int] = None,
                  layers_only: bool = False) -> Dict[str, int]:
    """FLOP terms of one full-sequence forward: B sequences of Lt text
    tokens after F frontend tokens (vision prefix) or beside S_enc
    encoder positions (encoder-decoder); ``logits_rows`` LM-head rows
    (default every position).  ``layers_only``: the decoder layers
    alone (what remat recomputes)."""
    terms = {"projections": 0, "attention": 0, "experts": 0, "ssm": 0}
    d, L = cfg.d_model, Lt + F
    T = B * L
    if F and not layers_only:
        terms["projections"] += 2 * B * F * cfg.frontend_dim * d
    if S_enc and not layers_only:
        Te = B * S_enc
        terms["projections"] += 2 * Te * cfg.frontend_dim * d
        for _ in range(cfg.n_enc_layers):
            terms["projections"] += _attn_proj(cfg, Te, Te) \
                + 2 * Te * 3 * d * cfg.d_ff
            terms["attention"] += _attn_core(cfg, B * S_enc * S_enc)
    for kind in M.layer_kinds(cfg):
        if cfg.has_attention:
            W = cfg.sliding_window if kind == 0 or long_mode else 0
            terms["projections"] += _attn_proj(cfg, T, T)
            terms["attention"] += _attn_core(cfg, B * causal_pairs(L, W))
        if cfg.has_ssm:
            _ssm(cfg, B, L, terms, decode=False)
        if S_enc:
            terms["projections"] += _attn_proj(cfg, T, B * S_enc)
            terms["attention"] += _attn_core(cfg, B * L * S_enc)
        _ffn(cfg, B, L, terms)
    if not layers_only:
        rows = T if logits_rows is None else logits_rows
        terms["projections"] += 2 * rows * d * cfg.vocab_padded
    return terms


def decode_flops(cfg: ModelConfig, B: int, seq_len: int, cache: Dict, *,
                 long_mode: bool = False) -> Dict[str, int]:
    """FLOP terms of one decode step of B tokens at pos = seq_len - 1
    against ``cache`` (its K/V slots and cross K/V)."""
    terms = {"projections": 0, "attention": 0, "experts": 0, "ssm": 0}
    d = cfg.d_model
    C = cache["k"].shape[2] if "k" in cache else 0
    S_enc = cache["cross_k"].shape[2] if "cross_k" in cache else 0
    ring = M.ring_cache(cfg, long_mode)
    for kind in M.layer_kinds(cfg):
        if cfg.has_attention:
            live = min(seq_len, C)
            if not ring and cfg.local_global_pattern and kind == 0:
                live = min(live, cfg.sliding_window)
            terms["projections"] += _attn_proj(cfg, B, B)
            terms["attention"] += _attn_core(cfg, B * live)
        if cfg.has_ssm:
            _ssm(cfg, B, 1, terms, decode=True)
        if S_enc:
            terms["projections"] += 2 * B * d * cfg.q_dim * 2
            terms["attention"] += _attn_core(cfg, B * S_enc)
        _ffn(cfg, B, 1, terms)
    terms["projections"] += 2 * B * d * cfg.vocab_padded
    return terms


def step_flops(cfg: ModelConfig, spec: Dict) -> Dict[str, int]:
    """FLOP terms of one step of ``shapes.input_specs``' ``spec``."""
    b = spec["batch"]
    if spec["kind"] == "decode":
        return decode_flops(spec["cfg"], b["token"].shape[0],
                            spec["seq_len"], spec["cache"],
                            long_mode=spec["long_mode"])
    B, Lt = b["tokens"].shape
    F = b["frontend"].shape[1] if "frontend" in b else 0
    S_enc = b["src_embeds"].shape[1] if "src_embeds" in b else 0
    if spec["kind"] == "prefill":
        return forward_flops(cfg, B, Lt, F=F, S_enc=S_enc, logits_rows=B)
    fwd = forward_flops(cfg, B, Lt, F=F, S_enc=S_enc)
    terms = {k: 3 * v for k, v in fwd.items()}
    if cfg.remat:                    # the decoder layers once more
        layers = forward_flops(cfg, B, Lt, F=F, S_enc=S_enc,
                               layers_only=True)
        for k, v in layers.items():
            terms[k] += v
    return terms


# ----------------------------------------------------------------------
# one pair
# ----------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process (rank 0):
    collectives return at once and move nothing, so a mesh of ``n``
    devices lays out ``meta`` tensors without any device."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: the production-mesh dry run makes its "
                           "own fake process group; one is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def pair_report(arch: str, shape_name: str, *, device=None,
                overrides: Optional[dict] = None, mesh=None,
                telemetry: Optional[Telemetry] = None) -> Dict:
    """The dry run of one (arch, shape).  ``device``: ``None`` (the
    card: ``fits`` against its memory) or ``"meta"`` (``fits`` null).
    Every tensor is built on ``meta``.  ``mesh``: a production mesh
    (under ``fake_world``): every count is per device, of the step's
    inputs laid out by ``sharding/rules``; the silent replications of
    their specs are warned about and recorded into ``telemetry``."""
    on_card = device is None or torch.device(device).type == "cuda"
    dev = resolve_device(device) if on_card else None
    if not on_card and torch.device(device).type != "meta":
        raise ValueError(f"dryrun: device is the card or 'meta', "
                         f"not {device}")
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides).validate()
    ok, why = S.applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "n/a",
                "reason": why}
    spec = S.input_specs(cfg, shape_name)
    spec["seq_len"] = S.SHAPES[shape_name]["seq_len"]
    params = M.init_params(cfg, torch.Generator(), device="meta")
    batch, cache = spec["batch"], spec.get("cache")
    repl = 0
    if mesh is not None:
        repl0 = R.silent_replication_count()
        specs = {"params": R.param_specs(cfg, mesh, params)}
        if spec["kind"] == "decode":
            cfg_eff = spec["cfg"]
            specs["batch"] = R.decode_batch_spec(cfg_eff, mesh, batch)
            specs["cache"] = R.cache_specs(cfg_eff, mesh, cache)
        else:
            specs["batch"] = R.batch_spec(cfg, mesh, batch)
        repl = R.silent_replication_count() - repl0
        if repl:
            warnings.warn(
                f"[{arch}/{shape_name}] sharding.rules.maybe() silently "
                f"replicated {repl} spec axis(es): a tensor the rules "
                f"name as sharded has no matching mesh axis and is stored "
                f"as {mesh.size()} full copies", stacklevel=2)
        if telemetry is not None:
            telemetry.record_sharding(silent_replications=repl)
        params = place.shard_tree(params, specs["params"], mesh)
        batch = place.shard_tree(batch, specs["batch"], mesh)
        if cache is not None:
            cache = place.shard_tree(cache, specs["cache"], mesh)
    nbytes = {"params": tree_bytes(params),
              "batch": tree_bytes(batch)}
    if spec["kind"] == "train":
        nbytes["grads"] = nbytes["params"]
        nbytes["opt_state"] = tree_bytes(init_opt_state(params))
    if spec["kind"] == "decode":
        nbytes["cache"] = tree_bytes(cache)
    nbytes["resident"] = sum(nbytes.values())
    terms = step_flops(cfg, spec)
    fits = None
    if dev is not None:
        total = torch.cuda.get_device_properties(dev).total_memory
        fits = nbytes["resident"] <= total
    out = {"arch": arch, "shape": shape_name, "status": "ok",
           "kind": spec["kind"],
           "devices": 1 if mesh is None else mesh.size(),
           "long_mode": bool(spec.get("long_mode", False)),
           "bytes": nbytes, "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params(),
           "flops": sum(terms.values()), "flop_terms": terms,
           "collective_bytes": None, "fits": fits}
    if mesh is not None:
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out["silent_replications"] = repl
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="per device of the reference's (16, 16) mesh "
                         "(256 ranks of a fake process group)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="per device of the reference's (2, 16, 16) "
                         "mesh (512 ranks)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help="write results here instead of "
                         "results/dryrun_torch")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, key=value")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or meta")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    out_dir = pathlib.Path(args.out_dir) if args.out_dir else RESULTS
    out_dir.mkdir(parents=True, exist_ok=True)
    where = "meta" if args.device == "meta" else "card"
    mesh = None
    world = contextlib.nullcontext()
    if args.multi_pod or args.production_mesh:
        where = f"{'pod2' if args.multi_pod else 'pod1'}__{where}"
        world = fake_world(512 if args.multi_pod else 256)
    tel = Telemetry()
    with world:
        if args.multi_pod or args.production_mesh:
            mesh = make_production_mesh(multi_pod=args.multi_pod,
                                        device="cpu")
        results, failures = _run_pairs(args, overrides, out_dir, where,
                                       mesh, tel)
    if mesh is not None:
        print(f"[sharding] {tel.sharding_stats()}")
    if failures:
        print(f"\nFAILED pairs: {failures}")
        sys.exit(1)
    print("\nAll dry-run pairs OK.")
    return results


def _run_pairs(args, overrides, out_dir, where, mesh, tel):
    results, failures = [], []
    for arch in args.arch or ARCH_NAMES:
        for shape_name in args.shape or list(S.SHAPES):
            tag = f"{arch}__{shape_name}__{where}"
            out = out_dir / f"{tag}.json"
            if out.exists() and not args.force:
                res = json.loads(out.read_text())
                print(f"[skip] {tag}: cached ({res['status']})")
            else:
                try:
                    res = pair_report(arch, shape_name, device=args.device,
                                      overrides=overrides or None,
                                      mesh=mesh, telemetry=tel)
                except Exception as e:  # noqa: BLE001 -- record, go on
                    res = {"arch": arch, "shape": shape_name,
                           "status": "error",
                           "devices": 1 if mesh is None else mesh.size(),
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                out.write_text(json.dumps(res, indent=2))
                extra = ""
                if res["status"] == "ok":
                    extra = (f" flops={res['flops']:.3e}"
                             f" resident={res['bytes']['resident']/1e9:.2f}GB"
                             f" fits={res['fits']}")
                elif res["status"] == "error":
                    extra = " " + res["error"][:200]
                print(f"[done] {tag}: {res['status']}{extra}", flush=True)
            if res["status"] == "error":
                failures.append(tag)
            results.append(res)
    return results, failures


if __name__ == "__main__":
    main()
