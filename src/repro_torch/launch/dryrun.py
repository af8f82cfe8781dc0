"""Dry run: what each (arch x shape) pair holds and computes, on one
card or per device of the production mesh.

Port of the JAX package's ``launch/dryrun.py``.  The reference lowers
each pair on its production TPU mesh and reads XLA's memory and cost
analyses and the HLO's collective bytes.  The port has no HLO.  For
each pair it builds the step's inputs on the ``meta`` device -- the
parameters through ``init_params``, AdamW's state through
``init_opt_state``, the cache through ``init_cache``, the batch through
``launch/shapes`` -- and then runs the pair's step once on fake tensors
(``trace_step``): the train step, the prefill step or the decode step
(long_500k: the batch-1 cache sharded by length, with the reference's
degraded config), on the inputs laid out as the bytes count them.
Per pair it reports:

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
  * ``collective_bytes``: by kind (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``,
    ``broadcast``), the summed output bytes of every collective the
    traced step issues on one rank -- the reference's convention; ``{}``
    on one card;
  * ``temp``: the traced step's peak of live bytes on one rank beyond
    its inputs, less the gradients (counted in ``resident``):
    activations, the autograd graph's saved tensors, the collectives'
    buffers, the new parameters of a train step.  A kernel counts as
    its outputs alone (its plain version's intermediates, which the
    card's kernel never allocates, are not counted, nor is a kernel's
    scratch).  It stands where the reference reports XLA's
    ``temp_size_in_bytes`` but does not compare with it: the port runs
    the step eagerly, without XLA's fusion, rematerialization and
    buffer reuse.  What holds it: four gloo ranks' real train step
    made and moved what its trace does, to the byte
    (``tests/test_torch_sharded_steps.py``), and a real train step on
    the card reaches 0.9-1.25x the traced peak in its allocator
    (``chip_smoke.py``'s ``train``);
  * ``fits``: on the card, whether ``resident`` fits its
    ``total_memory``; null on ``device="meta"``.

A pair whose traced step raises is ``error`` with the traceback's tail,
never ``ok`` with nulls.

The production mesh (``--production-mesh``: (16, 16), 256 devices;
``--multi-pod``: (2, 16, 16), 512) runs in one process under a fake
process group of that many ranks: ``launch/mesh.make_production_mesh``
builds the mesh, ``sharding/rules`` the specs -- with
``silent_replications``, the ``maybe`` fallbacks counted around their
construction, warned about as the reference does and recorded into a
``Telemetry`` (``record_sharding``) -- and ``sharding/place.shard_tree``
lays the meta tensors out, so each byte count is one rank's local
shards.

The traced step (``trace_step``) runs under
``torch._subclasses.FakeTensorMode``: its tensors are fake CPU tensors,
which carry shapes and no data, so every kernel wrapper takes its plain
branch for shapes only and no CUDA tensor ever reaches a plain version.
A dispatch mode of this module (``StepMeter``) sits above it: it reads
each collective's output shape (DTensor's redistributions desugar into
``_c10d_functional`` ops before it sees them) and follows the storages
the step makes, each freed when its last tensor dies.  The FLOPs are
counted from the config and the specs' shapes.

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
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import sys
import time
import traceback
import warnings
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.telemetry import Telemetry
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.sharding import place
from repro_torch.sharding import rules as R
from repro_torch.training.optimizer import init_opt_state, leaves
from repro_torch.training.steps import (make_decode_step, make_prefill_step,
                                        make_train_step)

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
# the traced step: collective and temp bytes
# ----------------------------------------------------------------------

# (name fragment without underscores, the reference's HLO kind)
_COLLECTIVES = (("allgather", "all-gather"), ("reducescatter",
                                              "reduce-scatter"),
                ("allreduce", "all-reduce"), ("alltoall", "all-to-all"),
                ("broadcast", "broadcast"), ("send", "collective-permute"),
                ("recv", "collective-permute"))
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# the kernel wrappers of kernels/ops: each counts as its outputs alone
_KERNELS = ("_flash_kernel", "_flash_bwd_kernel", "_flash_q8_kernel",
            "_merge_kernel", "_gate_kernel", "_gate_bwd_kernel",
            "_ssd_kernel", "_ssd_bwd_kernel")


def _storage(t) -> int:
    return t.untyped_storage()._cdata


def _real_index_work(func, args, kwargs) -> bool:
    """Whether an operation runs on real tensors, outside the fake mode:
    one whose tensor operands are all real (the mesh's rank grid, and
    what DTensor derives from the next case), or an ``arange`` that
    DTensor's own code makes to learn a strided shard's indices, which
    it then reads on the host (a fake tensor has no values to read).
    Both are small index tensors."""
    from torch._subclasses.fake_tensor import FakeTensor
    ts = [t for t in tree_leaves((args, kwargs))
          if isinstance(t, torch.Tensor)]
    if ts:
        return not any(isinstance(t, FakeTensor) for t in ts)
    if func._overloadpacket is not torch.ops.aten.arange:
        return False
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "/torch/distributed/tensor/" in name:
            return True
        if "/torch/" not in name:
            return False
        f = f.f_back
    return False


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the call stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _collective_kind(func) -> Optional[str]:
    ns, _, name = func._schema.name.partition("::")
    if ns not in _COLLECTIVE_NS or name == "wait_tensor":
        return None
    flat = name.replace("_", "")
    for frag, kind in _COLLECTIVES:
        if frag in flat:
            return kind
    return None


class StepMeter(TorchDispatchMode):
    """One rank's collective bytes and peak of live bytes over a step.

    Above ``FakeTensorMode``: an operation on DTensors is handed back
    (``NotImplemented``) so that DTensor runs it, and its local
    operations and redistributions -- ``_c10d_functional`` collectives
    -- come through here.  ``collective_bytes``: the output bytes of
    each collective by kind.  ``peak``: the most bytes of storages that
    the step made alive at once, a storage freed when its last tensor
    dies; the storages of ``resident`` (the step's inputs) are not
    counted, nor are those made while ``quiet`` (a kernel's plain
    version: ``kernels_as_outputs``), nor the fake tensors of global
    shapes on which DTensor's sharding propagation runs an operation
    once more to learn its output's shape (no rank holds them).  It
    also counts a step on real tensors; ``fake``: above a
    ``FakeTensorMode``, whose index work it runs for real
    (``_real_index_work``) and counts as a real step's."""

    def __init__(self, resident=(), fake: bool = False):
        super().__init__()
        self.fake = fake
        self.collective_bytes: Dict[str, int] = {}
        self.live = self.peak = self.quiet = 0
        self._skip = {_storage(t) for t in resident}
        self._refs: Dict[int, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if self.quiet or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self.fake and _real_index_work(func, args, kwargs):
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                out = func(*args, **(kwargs or {}))
        else:
            out = func(*args, **(kwargs or {}))
        if _in_propagation():
            return out
        kind = _collective_kind(func)
        if kind is not None:
            n = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            self.collective_bytes[kind] = \
                self.collective_bytes.get(kind, 0) + n
        self.track(out)
        return out

    def track(self, out) -> None:
        """Count the storages of the tensors of ``out`` the step made."""
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or \
                    type(t).__name__ == "DTensor":
                continue
            key = _storage(t)
            if key in self._skip:
                continue
            if key not in self._refs:
                n = t.untyped_storage().nbytes()
                self._refs[key] = [n, 0]
                self.live += n
                self.peak = max(self.peak, self.live)
            self._refs[key][1] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]


def _sig(x):
    """A call's operands by shape: tensors as (shape, stride, dtype)."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), tuple(x.stride()), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _sig(v)) for k, v in x.items()))
    return repr(x)


@contextlib.contextmanager
def kernels_as_outputs(meter: StepMeter):
    """Within: each kernel wrapper of ``kernels/ops`` runs with ``meter``
    quiet and then counts its outputs -- what the card's kernel
    allocates, where the plain version it takes on fake CPU tensors
    would add its intermediates (an attention's score matrix).  A call
    on fake tensors whose operands have the shapes of an earlier one
    (the next layer's) gets empty outputs of the shapes that call gave,
    without running the plain version again: its outputs' shapes follow
    from its operands' alone, and a plain scan on fake tensors costs
    seconds.  A call on real tensors always runs."""
    from torch._subclasses.fake_tensor import FakeTensor
    saved = {n: getattr(ops, n) for n in _KERNELS}
    seen: Dict = {}

    def quiet(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            key = (name, _sig(args), _sig(kwargs))
            if key in seen and isinstance(args[0], FakeTensor):
                metas, spec = seen[key]
                out = tree_unflatten([_empty(m) for m in metas], spec)
            else:
                meter.quiet += 1
                try:
                    out = fn(*args, **kwargs)
                finally:
                    meter.quiet -= 1
                leaves_, spec = tree_flatten(out)
                seen[key] = ([_meta(t) for t in leaves_], spec)
            meter.track(out)
            return out
        return call
    for n, fn in saved.items():
        setattr(ops, n, quiet(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


class _TensorMeta(tuple):
    """(shape, stride, dtype) of a kernel output seen before."""


def _meta(t):
    if isinstance(t, torch.Tensor):
        return _TensorMeta((tuple(t.shape), tuple(t.stride()), t.dtype))
    return t


def _empty(m):
    if isinstance(m, _TensorMeta):
        return torch.empty_strided(m[0], m[1], dtype=m[2], device="cpu")
    return m


def _local(t):
    """A DTensor's local tensor, read without dispatching an operation
    (a meta one must not meet ``FakeTensorMode``); a tensor itself."""
    return t._local_tensor if place.is_dtensor(t) else t


def _fake_tree(tree):
    """Fake CPU tensors (the ambient ``FakeTensorMode``) of a tree's
    ``meta`` tensors, DTensors keeping their mesh, placements and local
    shapes."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        loc = _local(t)
        f = torch.empty(tuple(loc.shape), dtype=loc.dtype, device="cpu")
        if not place.is_dtensor(t):
            return f
        return DTensor.from_local(f, t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return one(node)
    return walk(tree)


def trace_step(cfg: ModelConfig, spec: Dict, params, batch, cache=None):
    """One step of ``shapes.input_specs``' ``spec`` on fake tensors of
    ``params``, ``batch`` and ``cache`` (``meta`` tensors or DTensors
    over them, as ``pair_report`` lays them out; AdamW's state made
    from the parameters for a train step).  Returns the ``StepMeter``
    that watched it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    # real index tensors (_real_index_work) may meet fake operands
    with FakeTensorMode(allow_non_fake_inputs=True):
        p, b = _fake_tree(params), _fake_tree(batch)
        c = None if cache is None else _fake_tree(cache)
        opt = init_opt_state(p) if spec["kind"] == "train" else None
        resident = [_local(t) for t in leaves([p, b, c, opt])
                    if isinstance(t, torch.Tensor)]
        meter = StepMeter(resident, fake=True)
        del resident
        with kernels_as_outputs(meter), meter:
            if spec["kind"] == "train":
                out = make_train_step(cfg)(p, opt, b)
            elif spec["kind"] == "prefill":
                with torch.no_grad():
                    out = make_prefill_step(cfg)(p, b)
            else:
                with torch.no_grad():
                    out = make_decode_step(
                        spec["cfg"], long_mode=spec["long_mode"])(p, c, b)
        del out
    return meter


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
                telemetry: Optional[Telemetry] = None,
                trace: bool = True) -> Dict:
    """The dry run of one (arch, shape).  ``device``: ``None`` (the
    card: ``fits`` against its memory) or ``"meta"`` (``fits`` null).
    Every tensor is built on ``meta``.  ``mesh``: a production mesh
    (under ``fake_world``): every count is per device, of the step's
    inputs laid out by ``sharding/rules``; the silent replications of
    their specs are warned about and recorded into ``telemetry``.
    ``trace=False``: the inputs' bytes and the FLOPs alone, without the
    traced step (no ``collective_bytes`` or ``temp`` keys): what a
    check of the bytes alone needs, at a fraction of the time."""
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
    traced = {}
    if trace:
        try:
            meter = trace_step(cfg, spec, params, batch, cache)
            temp = meter.peak - nbytes.get("grads", 0)
            if temp < 0:        # the gradients are made within the step
                raise RuntimeError(
                    f"the traced peak {meter.peak} is below the gradients' "
                    f"{nbytes['grads']} bytes")
        except Exception as e:  # noqa: BLE001 -- the pair's record
            return {"arch": arch, "shape": shape_name, "status": "error",
                    "devices": 1 if mesh is None else mesh.size(),
                    "error": f"traced step: {type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]}
        traced = {"collective_bytes": meter.collective_bytes, "temp": temp}
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
           **traced, "fits": fits}
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
                t0 = time.perf_counter()
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
                res["seconds"] = round(time.perf_counter() - t0, 1)
                out.write_text(json.dumps(res, indent=2))
                extra = ""
                if res["status"] == "ok":
                    extra = (f" flops={res['flops']:.3e}"
                             f" resident={res['bytes']['resident']/1e9:.2f}GB"
                             f" fits={res['fits']}")
                    moved = sum(res["collective_bytes"].values())
                    extra += (f" temp={res['temp'] / 1e9:.3f}GB "
                              f"collective={moved / 1e9:.3f}GB")
                elif res["status"] == "error":
                    extra = " " + res["error"][:200]
                print(f"[done] {tag}: {res['status']}{extra} "
                      f"({res['seconds']} s)", flush=True)
            if res["status"] == "error":
                failures.append(tag)
            results.append(res)
    return results, failures


if __name__ == "__main__":
    main()
