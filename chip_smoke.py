#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # on a machine with one NVIDIA GPU

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, in parallel), then:

  1. kernel checks — each kernel against its plain PyTorch version on
     the card at the serving path's shapes, with its time, the plain
     version's time, one PyTorch-call yardstick and the card's bound
     (``bandit_update`` as the serving path launches it, the update
     half alone, and with both halves beside the matmul form; the
     halves' device times from a profiler trace); ``router_topk`` and
     ``router_topk_q8`` bit-equal over a sweep of N, D, k, bias,
     min_score and catalog order, and one launch a call (profiler);
  2. serving at full width — a 100,000-entry catalog, the full-width
     analyzer (seeded random weights), bandit + load + semantic cache,
     4 batches of 256 requests through ``ServingEngine.submit`` ->
     ``observe``, in fp32 and again with int8 catalog, cache and
     analyzer; every kernel must launch and repeats must hit the cache.
     The decisions (tie-aware) and the bandit posterior must match the
     same run on the CPU (plain versions) fed the card run's task
     signatures, and those signatures must match the analyzer run on
     the CPU over the same batches;
  3. a per-stage breakdown of one served batch;
  3b. ``router_paths``, on the same catalog and batches: the staged
     path (``fused=False``, LinUCB) served on the card and on the CPU
     fed the card's signatures, decisions tie-aware and the bandit
     within rtol 1e-5, then batch 2 through ``route_many_staged`` and
     ``route_many_batch`` on the card (tie-aware) and the staged kNN's
     filter-row launch bit-equal to the dense-mask call; the same with
     a Thompson bandit (seed 3, noise 0.3), each batch's kNN candidate
     sets equal to the CPU's before the decisions are compared; the
     fused path with ``Telemetry`` and ``Tracer`` attached beside the
     same run without them (counters equal to the ops counters per
     batch, every request's trace holding exactly its stages, the
     Prometheus text parsing back, launches equal with and without the
     sinks and on the staged path, decisions unchanged); then
     ``RouterState`` saved after that run and restored into a fresh
     router on the card (``route_many`` bit-identical, the replayed
     head of batch 1 all cache hits) and on the CPU (tie-aware);
  3c. ``mega_catalog``, on the same catalog and batches, the
     signatures the workload's own: ``route_many_batch`` on seven
     engines -- (a) dense fp32, (b) sharded fp32 over 4 shards on the
     card, (c) dense int8, (d) sharded int8, (e) IVF fp32 and (f) IVF
     int8 at nprobe 8 of C = 316 cells, (g) IVF fp32 at nprobe C --
     each without blend terms and with a warmed LinUCB bandit and the
     load penalty at ``build_router``'s weights.  (b) equals (a) and
     (d) equals (c) bit for bit on all eight outputs; (g) equals (a)
     (scores within 1e-5); (e) and (f) reach recall@8 >= 0.99 by
     ``bench_mega``'s metric (the exact-set recall is logged); (b) to
     (f) match their CPU runs (tie-aware within 1e-5) and the IVF
     engines probe the same cells on both; 4 ``router_topk`` launches
     per sharded batch, one per dense batch; each batch one
     ``route_step`` span with the program's path and shard count.
     Logs the IVF index's build time, cap and gather sizes, the escape
     branch's hits, the host p50 per engine and CUDA-event times; the
     top-k kernels at the shard's launch shape are rows of the
     ``kernels`` line;
  3d. ``workloads``, on the same catalog, with the cost profiler and the
     recompile hook attached to the card's runs: the default
     ``DriftScenario`` cut to 20 steps of 16 (model-degrade; the degraded
     model step 0's accuracy-first majority) routed with LinUCB and
     observed, with an fp32 and an int8 catalog (recovery after the
     shift, the degraded model's share of choices, per-step p50);
     ``zipf_replay`` (64 queries, 512 requests) through the semantic
     cache (hit rate; every repeat of an earlier submit's query must
     hit); a ``ServingSimulator`` whose ``route_fn`` routes each arrival
     of a bursty trace with the live tracker's load penalty and
     ``plan_admission``.  Each against its CPU run, tie-aware; one hook
     event per dispatch, every one with 0 compiles; each bucket's FLOPs
     and bytes logged;
  4. the model-zoo kernels (flash attention in its prefill and decode
     launch shapes, the SSD scan, the MoE gate) against their plain
     versions at the generation path's shapes (llama3.2-1b prefill and
     decode at B=16, prompt 512; mamba2-1.3b prefill at B=16, L=512,
     both as served -- bf16 x / B / C strided views, no h0 -- and in
     f32 with an h0, each launch's device time from a profiler trace;
     qwen3-moe-30b-a3b's gate at T = 16 x 512 and T = 16, E=128, k=8,
     one launch a call with aux the same bits twice, beside the launch
     floor of a one-element kernel, and its attention at GQA group 8),
     plus small sweeps over window, softcap, causal=False, ragged
     shapes, experts, k, f32 and ties, and the scan past one 64 x 128
     tile and past 65,535 batches x chunks;
  4c. the windowed models' kernel shapes: flash attention of hymba-1.5b
     (hd 64, GQA group 5, window 1,024, a ring), h2o-danube-3-4b (hd
     120, window 4,096, a ring) and gemma2-2b (hd 288, softcap 50, local
     layers with window 4,096 and global ones in a full cache), prefill
     and decode, at B=16, prompt 512 and at B=4, prompt 4,608 (every
     window bites, gemma2's local decode anchored at each row's own
     position), and hymba's scan (H=50, P=64, N=16) at both, each
     against its plain version and timed beside SDPA (none with a
     softcap) and its bound; each row named by the CUDA kernel it runs
     (gemma2-2b's ``prefill_wide_kernel`` and ``decode_wide_kernel``)
     and every decode checked on the body ``decode_body`` names
     (``flash_attention.decode_launches_by_body``); f32 and bf16 sweeps
     at hd 120 and 288;
  4d. the frontend models' kernel shapes (``frontend_kernels``): flash
     attention of seamless-m4t-medium (16 heads of 64, G 1: the
     encoder's non-causal 16 x 16, the causal prefill at L=512, the
     cross-attention's 512 queries over 16 keys, the decode over 536
     slots and the cross decode with every key live) and of
     llava-next-mistral-7b (32/8 heads of 128: the prefill over 2,880
     frontend + 512 text tokens and the decode past its cache of
     3,392), at B=16, each against its plain version (over slices of
     the batch where its scores would not fit) and timed beside SDPA
     and its bound; f32 and bf16 sweeps at 12, 16 and 17 keys;
  4e. ``kv_int8_kernels``: the int8 decode (``flash_decode_q8``) at the
     served decode shapes -- llama3.2-1b (B=16, 536 slots, live
     513-528), gemma2-2b's local and global layers (hd 288, softcap
     50), h2o-danube-3-4b's full ring of 4,096 (B=4, hd 120) and
     llava-next-mistral-7b's 3,392 slots (hd 128) -- against
     ``decode_q8_plain``, timed beside the bf16 decode on the same
     values, with both bounds, each on the tensor-core body
     (``decode_mma_kernel<HD, true>``, at hd 288
     ``decode_wide_kernel<288, true>``; checked through
     ``launches_by_body``)
     and its two launches (body, merge) timed from a trace; an f32
     sweep (G 1-40, hd 32-288) on ``decode_q8_kernel``, timed at
     llama's shape, and a bf16 sweep over both bodies (G 16 and 20, hd
     32, 120, 128 and 288, local windows, softcap);
  5. routed generation at full width and depth: a catalog of
     llama3.2-1b, mamba2-1.3b and qwen2-1.5b (28 layers, 12/2 heads of
     128, QKV bias), each entry a ``ModelRunner`` at its published
     config with seeded random bf16 weights on the card; 48 requests
     (16 per model, by preference: ``gen_profiles``) through
     ``ServingEngine(prompt_len=512).submit`` with ``max_new=16``; no
     response may fail or be shed, every one carries 16 tokens, the
     prefill logits are finite, and the kernels' launch counts are
     exactly one per layer per prefill and one per attention layer per
     decode step, every decode on the tensor-core body; qwen2-1.5b's
     prefill (``prefill_wgmma_kernel<128>``, G 6) and decode are rows
     of the ``kernels`` line with its launches (``gen_kernel_rows``,
     checked and timed in ``model_kernels``);
  5b. the same on a catalog of qwen3-moe-30b-a3b (all 48 layers, 59.5
     GB of bf16 weights drawn on the card, after the earlier phases'
     memory is released) and llama3.2-1b, 16 requests per model (a
     fixed profile list with no near-tie between the two), and exactly
     one ``moe_gating`` launch per MoE layer per prefill and decode step;
  5c. routed generation on a catalog of the three windowed models at
     full width and depth (about 16 GB of bf16): 48 requests, 16 per
     model (explicit preference weights: no named profile reaches
     hymba-1.5b or h2o-danube-3-4b beside gemma2-2b), one
     ``flash_attention`` launch per attention layer per prefill and
     decode step and one ``ssd_scan`` per hymba layer per prefill;
  5d. long context: each windowed model alone at full width and half
     its depth through ``ModelRunner.generate`` at B=4, prompt 4,608,
     16 new tokens (hymba's ring of 1,024 and h2o-danube's of 4,096 wrap);
     finite logits and exact launch counts;
  5d'. ``long_mode`` (the reference's serving of the long_500k shape):
     its kernel shapes against their plain versions and timed (gemma2-2b's
     banded prefill on every layer, B=4, prompt 4,608; its ring decode
     over a full ring of 4,096 in bf16 and int8; the long_500k decode at
     B=1 of gemma2-2b and llama3.2-1b); gemma2-2b at full width and depth
     through ``make_prefill_step(long_mode=True)`` and 16 steps of
     ``make_decode_step(long_mode=True)``, bf16 then int8 cache (exactly
     one attention launch per layer per prefill and step, every decode
     on the full ring; prefill ms, ms a step, busy share, peak memory);
     the long_500k step (B=1, pos 524,287, a seeded full cache) of
     gemma2-2b, llama3.2-1b and mamba2-1.3b with its parameter and cache
     bytes equal to ``launch/dryrun``'s; and the card against the CPU at
     full width, 2 layers, f32, windows 48 (prompt 72, and the long_500k
     step at pos 524,287);
  5e. ``generate_frontends``: routed generation on seamless-m4t-medium
     and llava-next-mistral-7b at full width and depth (about 15.6 GB
     of bf16), 32 requests by preference profile, prompt 512, 16 new
     tokens, the runners' zero frontend embeddings as the reference's
     (16 frames; 2,880 patches); exact launch counts (seamless's
     encoder once, self + cross per decoder layer per step), the
     analyzer's task types per model, prefill ms, ms per decode step,
     the card's busy share and peak memory;
  5f. ``kv_int8_generation``: routed generation on llama3.2-1b and
     gemma2-2b at full width and depth, 32 requests, prompt 512, 16 new
     tokens, first with the bf16 cache and then the same catalog and
     requests with ``kv_cache_dtype="int8"``: every decode of every
     layer one ``flash_decode_q8`` launch; prefill ms, ms per step,
     the card's busy share, the cache's bytes and the tokens equal to
     the bf16 run (reported); then both with an int8 cache on the card
     against the CPU at full width, 2 layers (the first decode step's
     logits held too);
  6. card against CPU: the nine configs at full width, 2 layers, f32
     compute, the same seeded weights on both devices: prefill logits
     within 1e-3 of max |logit|, greedy tokens equal (tie-aware); for
     the MoE also the experts of every gate, tie-aware, with tokens
     dropped at its published capacity factor; the windowed models at
     prompt 72 with their windows set to 48, so the rings (48 slots,
     roll shift 24) and gemma2's local masks bite; the frontend models
     with 2 encoder layers (seamless) and 64 frontend tokens (llava),
     fed seeded standard-normal embeddings;
  7. ``serve_loop``, the service loop of ``repro_torch.launch.serve``:
     ``TaskAnalyzer.train`` (250 steps) on the card and on the CPU from
     one seeded init, the CPU's run a child process beside the phase's
     card work (first 20 losses within 1e-3 relative, accuracies within
     0.02, complexity MAE within 0.01; the card's saved in the
     reference's layout and loaded back bit-equal); the launcher's
     ``main`` at full
     width on the eight default configs in its four modes -- 48 requests
     with 16 new tokens (none failed or shed, Prometheus text parsing
     back), batch mode with 24 (one model, the CPU's route of the same
     aggregate signature), ``--async`` (windows of at most 8, the load
     tracker back at zero, three ``stream`` calls of 8 tokens) and
     ``--soak 3`` (intake counters equal to the CPU run's, the flood
     rate-limited, the quiet tenants not shed at intake); the
     continuous batcher on llama3.2-1b, mamba2-1.3b and gemma2-2b at
     full width and depth (4 slots, ctx 128, 12 requests, one ticking
     at pos = C; exact launches), and at full width, 2 layers, f32
     against the CPU batcher (tokens tie-aware); merging two
     llama3.2-1b runners (the soup registered and chosen, a soup tensor
     bit-equal to the CPU's, the soup generating) and a full-width
     runner checkpoint round trip.  Its new kernel shapes (the
     batcher's B=4 decode over 128 slots, its B=1 prefill and scan)
     are rows of the ``kernels`` line with the launches of the
     batcher's run.
  8. ``train_kernels``: each backward kernel (``flash_attention_bwd``,
     ``ssd_scan_bwd``, ``moe_gating_bwd``) against its plain backward on
     the card at the zoo's training shapes (B=8, L=1024: llama3.2-1b,
     qwen3-moe-30b-a3b's hd 128, gemma2-2b's hd 288 with its softcap,
     local and global, h2o-danube-3-4b's hd 120 window, seamless's
     cross-attention; the scan at mamba2-1.3b's and hymba-1.5b's
     shapes; the gate at qwen3-moe's 8,192 tokens, warp-level rows, one
     launch a call, and a sweep of E 8-1024, k 1-8), bf16 and f32, bit
     stable, timed (CUDA graph) against its bound and, for attention
     without a softcap, SDPA's backward; the attention backward's body
     (wgmma for every row: at gemma2's hd 288 the wide kernels
     ``bwd_dkv_wide_kernel`` / ``bwd_dq_wide_kernel``, with the
     ``mma.sync`` body launched on the same inputs, checked and timed
     beside them; f32 for the f32 runs) checked through its per-body launch
     counts, and its three launches (delta, dK/dV, dQ) timed from a
     trace; one bf16 train step of gemma2-2b at full width, 2 layers,
     B=2, L=1024, its gradients within 2e-2 of each leaf's max |g| of
     the same step with ``flash_attention_bwd_plain`` as its attention
     backward;
  9. ``train``: train steps (AdamW, f32 master params, bf16 compute,
     L=1024): 2 warm-up and 8 timed of llama3.2-1b and mamba2-1.3b at
     full width and depth and qwen3-moe-30b-a3b at full width on 2 of
     its 48 layers (B=8); then 1 warm-up and 3 timed at full width and
     depth of gemma2-2b at B=4 (a batch cut: its B=8 step needs 88.7 GB
     by the dry run; its 26 attention backwards a step all on the wgmma
     body), seamless-m4t-medium, hymba-1.5b, h2o-danube-3-4b and
     qwen2-1.5b (B=8): ms a step, tokens/s, the card's busy share, peak
     memory, launches a step (the counts set to 0 just before the
     timed steps; every backward kernel must launch, every attention
     backward on the wgmma body; the kernels line takes their launches
     from here); each step's peak above its inputs held to the dry
     run's traced peak of the same step (0.9 to 1.25 times it; the
     traces run in a child process beside the card's steps); then the
     ~100M example config for 80 of its 250 steps, its loss falling by
     over 30%;
  9b. ``sharding``: under a world-size-1 NCCL group and
     ``make_host_mesh()``, 2 warm-up and 3 timed train steps of
     llama3.2-1b (full width and depth), mamba2-1.3b and
     qwen3-moe-30b-a3b (full width, 2 layers) on DTensor parameters and
     unsharded from the same parameters and batches (losses, gnorms,
     aux and every parameter within 1e-4, bit-equality reported; both
     steps' ms); the attention, scan and gate kernels launched forward
     and backward from the sharded steps (counts, and a profiled
     sharded step's kernels; their launches added to the kernels line);
     the production-mesh dry run's resident GB a device and ``fits``
     of llama4-maverick-400b-a17b and qwen3-moe-30b-a3b at train_4k on
     (16, 16) and (2, 16, 16) (a fake process group of 256 / 512);
 10. ``train_card_vs_cpu``: one train step of every config at full
     width, 2 layers (llama4-maverick at ``SMOKE``), f32, B=2, on the
     card and on the CPU from the same seeded params and batch: loss,
     aux and gnorm within 1e-4 relative, every gradient leaf within
     1e-3 of its max |g| (the CPU's MoE gates replaying the card's
     choices, each apart only at a near-tie).
 11. ``examples``: ``examples/quickstart_torch.py``,
     ``serve_routed_torch.py`` and ``merge_models_torch.py`` through
     their ``main`` on the card, small.
 12. ``ctx_decode``: each decode body (llama3.2-1b's and gemma2-2b's
     rings of 4,096 in bf16, int8 and f32, gemma2-2b's local window in a
     full cache of 8,192) on a B=1 cache cut into 16 slot blocks (the
     long_500k layout of (16, 16)): each block's decode with lse
     against its plain partial, ``decode_merge`` of the 16 against its
     plain version and against the unsharded launch; each body timed
     with and without lse beside its bound (the local window's also
     with each mask apart), and the merge; rows without launches;
 13. ``multirank``: four ranks of this script on the one card
     (``--multirank-rank``; gloo, (2, 2) ("data", "model")) against one
     unsharded process: llama3.2-1b and gemma2-2b at full width, 2
     layers, f32, prompt 512 and 8 decode steps at batch 1 (the cache
     split by length), gemma2-2b's local window in a seeded full cache
     (data block 0 first cut by the window's edge, then wholly below
     it: an empty partial), gemma2-2b in ``long_mode`` at pos 524,287,
     and a batch-sharded B=4 prefill, 3 decode steps and a train step;
     each rank checks every decode partial and merge it launches
     against the plain version on its own tensors; each batch-1 run's
     two kernels get rows at the ranks' shapes, timed here on rank 0's
     operands.
  The serving phases launch no backward kernel (checked in
  ``serve_loop``).

Each windowed and frontend kernel shape is a row of the ``kernels``
line, its launches those of its kind (``flash_kind``) on the phase that
runs it: the routed phases for B=16, the long-context phase for B=4.

The last lines are the card's ``nvidia-smi`` name and power limit, a
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": ...}``.
Any failure exits non-zero without those lines; so does a machine
without a CUDA device.  ``--rehearse`` runs every phase on the CPU at a
small size (plain versions, no timing claims) and exits 3 without
printing a result.  ``--only kernels,model_kernels`` (any phases of
``main``) runs just those on the card and exits 4 without a result:
the quick check of a kernel after an edit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()   # the whole run's clock
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_S = 67e12             # fp32 outside the tensor cores
PEAK_INT8_S = 1979e12           # int8 tensor-core dense TOP/s
PEAK_BF16_S = 989e12            # bf16 tensor-core dense FLOP/s
GEN_ARCHS = ["llama3.2-1b", "mamba2-1.3b", "qwen2-1.5b"]
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_GEN_ARCHS = [MOE_ARCH, "llama3.2-1b"]
NEG_INF = float("-inf")
TOPK_KERNELS = ("rows_kernel", "tile_kernel")   # csrc/router_topk.cu


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

def time_graph_ms(torch, fn, dev, iters: int = 20, reps: int = 3) -> float:
    """Device time of one ``fn()`` (``repro_torch.obs.profile.graph_ms``:
    a CUDA graph of ``iters`` calls, the mean over ``reps`` replays, the
    wrapper's host work not in the reading).  Host wall time on the
    CPU."""
    if dev.type != "cuda":
        return time_ms(torch, fn, dev, iters)
    from repro_torch.obs.profile import graph_ms
    return graph_ms(fn, iters, reps, dev)


def time_ms(torch, fn, dev, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` called eagerly, host work included (CUDA
    events over ``iters`` calls after ``warmup``), or host wall time on
    the CPU.  For the plain versions, whose host work the reading
    keeps, and for what a CUDA graph cannot capture."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(dev)
        return t0.elapsed_time(t1) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def trace_kernels(torch, dev, fn, iters: int = 20) -> dict:
    """{kernel name: (device ms, launches) per ``fn()``} from a
    ``torch.profiler`` trace of ``iters`` calls after three warm-ups
    (``repro_torch.obs.profile.kernel_trace``; empty where the trace
    holds no device time)."""
    if dev.type != "cuda":
        return {}
    from repro_torch.obs.profile import kernel_trace

    out = {}
    for key, (ms, n) in kernel_trace(fn, iters, 3, dev).items():
        ms0, n0 = out.get(kernel_label(key), (0.0, 0.0))
        out[kernel_label(key)] = (ms0 + ms, n0 + n)
    if not out:                 # PERF.md section 7: late in a long run
        log("[trace] no device time: no event on the device")
    return out


def kernel_times(torch, dev, fn, iters: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name."""
    return {k: v[0] for k, v in trace_kernels(torch, dev, fn, iters).items()}


def one_launch(torch, dev, fn, kernels, what: str) -> str:
    """Check that ``fn()`` launches one kernel on the card, one of
    ``kernels``, at most once a call (a profiler trace may drop some of
    a run's events, never add one); returns its name, the trace's
    launches a call and its device ms a launch as text."""
    tr = trace_kernels(torch, dev, fn, iters=20)
    if not tr:
        return "not measured (no device time in the trace)"
    check(len(tr) == 1, f"{what}: kernels launched a call {tr}, want one "
                        f"of {kernels}")
    (name, (ms, n)), = tr.items()
    check(name.split("<")[0] in kernels and 0 < n <= 1.0,
          f"{what}: {n} launches of {name} a call, want one of {kernels}")
    return f"{name} {ms / n:.4f} ms a launch, {n:.2f} launches a call"


def fmt_times(times: dict) -> str:
    return "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()) or \
        "not measured (no device time in the trace)"


# ----------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ----------------------------------------------------------------------

def topk_inputs(torch, dev, rng, Q, N, D, R):
    """Unit rows with duplicate catalog rows (ties) and queries aimed at
    them; a filter table with empty and full rows."""
    emb = rng.standard_normal((N, D)).astype(np.float32)
    ndup = min(1000, N // 4)
    emb[N // 2:N // 2 + ndup] = emb[:ndup]              # exact duplicates
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q[: Q // 4] = emb[rng.integers(0, ndup, Q // 4)]    # aim at the ties
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
    dens = rng.choice([0.01, 0.1, 0.5, 0.9], size=(R, 1))
    table = (rng.random((R, N)) < dens).astype(np.uint8)
    table[0] = 0                                        # empty rows
    table[1] = 1
    table[2, :N // 2] = 0
    rows = rng.integers(0, R, Q).astype(np.int32)
    rows[:4] = 0
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(q), t(emb), t(table), t(rows)


def compare_topk(torch, got, want, what: str) -> float:
    """Finite slots agree (values within 1e-6, same indices: the plain
    version breaks ties toward the lowest index too); returns the max
    value error."""
    gv, gi = got
    wv, wi = want
    fin = torch.isfinite(wv)
    check(torch.equal(torch.isfinite(gv), fin),
          f"{what}: finite slots differ")
    err = float((gv[fin] - wv[fin]).abs().max()) if fin.any() else 0.0
    check(err <= 1e-6, f"{what}: max |vals err| {err} > 1e-6")
    check(torch.equal(gi[fin], wi[fin]), f"{what}: indices differ")
    return err


def topk_sweep(torch, dev, rng, RT, quantize_rows) -> int:
    """router_topk and router_topk_q8 against their plain versions, bit
    for bit, over catalog sizes, widths and k (ragged chunks, the mask
    read a byte at a time where N % 4 != 0), with bias and min_score,
    queries whose mask row is empty, duplicate rows (ties to the lower
    index) and catalogs sorted by score both ways (every row beats the
    threshold, or none after the first step)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n = 0
    for N, D, k, extra in ((1, 8, 1, False), (127, 1, 8, True),
                           (4000, 40, 1, True), (4000, 64, 32, False),
                           (100_003, 8, 8, True), (5000, 8, 32, False)):
        for order in ("random", "ascending", "descending"):
            e = rng.standard_normal((N, D)).astype(np.float32)
            e[N // 2:N // 2 + N // 8] = e[:N // 8]       # duplicates
            e /= np.linalg.norm(e, axis=1, keepdims=True) + 1e-9
            q = rng.standard_normal((37, D)).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
            if order != "random":                        # by query 0's score
                s0 = e @ q[0]
                e = e[np.argsort(s0 if order == "ascending" else -s0,
                                 kind="stable")]
            table = (rng.random((5, N)) < 0.6).astype(np.uint8)
            table[0] = 0
            rows = rng.integers(0, 5, 37).astype(np.int32)
            rows[1] = 0
            rows[0] = 1 + rows[0] % 4
            bias = t((rng.standard_normal(N) * 0.01).astype(np.float32)) \
                if extra else None
            ms = 0.2 if extra else NEG_INF
            qd, ed, td, rd = t(q), t(e), t(table), t(rows)
            for quant in (False, True):
                if quant:
                    q8, qs_ = quantize_rows(qd)
                    e8, es_ = quantize_rows(ed)
                    args = (q8.contiguous(), e8.contiguous(),
                            qs_[:, 0].contiguous(), es_[:, 0].contiguous(),
                            td, rd, k)
                    got = RT.router_topk_q8(*args, bias=bias, min_score=ms)
                    want = RT.router_topk_q8_plain(*args, bias=bias,
                                                   min_score=ms)
                else:
                    args = (qd, ed, td, rd, k)
                    got = RT.router_topk(*args, bias=bias, min_score=ms)
                    want = RT.router_topk_plain(*args, bias=bias,
                                                min_score=ms)
                what = (f"router_topk{'_q8' if quant else ''} N={N} D={D} "
                        f"k={k} {order}")
                fin = torch.isfinite(want[0])
                check(torch.equal(got[0], want[0]),
                      f"{what}: values not bit-equal")
                check(torch.equal(got[1][fin], want[1][fin]),
                      f"{what}: indices differ")
                check(dev.type != "cuda" or bool((got[1][~fin] == -1).all()),
                      f"{what}: an empty slot's index is not -1")
                n += 1
    return n


def kernel_phase(torch, dev, rng, small: bool):
    from repro_torch.kernels import bandit_update as BU
    from repro_torch.kernels import router_topk as RT
    from repro_torch.kernels.route_step import quantize_rows

    N = 4000 if small else 100_000
    Q, D, K, R = 256, 8, 8, 98
    results = {}

    # -- fp32 router_topk at the route step's shape
    q, emb, table, rows = topk_inputs(torch, dev, rng, Q, N, D, R)
    got = RT.router_topk(q, emb, table, rows, K)
    want = RT.router_topk_plain(q, emb, table, rows, K)
    err = compare_topk(torch, got, want, "router_topk fp32 route step")
    check(bool(torch.isinf(got[0][:4]).all()), "empty rows must be -inf")
    # the tie rule, independently of the plain version: the duplicate
    # rows [N//2, N//2 + ndup) score bit-equal to rows [0, ndup), so a
    # duplicate index may only appear after its original
    gi = got[1].cpu().numpy()
    gv = got[0].cpu().numpy()
    tab = table.cpu().numpy()
    ndup = min(1000, N // 4)
    n_ties = 0
    for qi, (rowv, row_v) in enumerate(zip(gi.tolist(), gv.tolist())):
        for pos, j in enumerate(rowv):
            if N // 2 <= j < N // 2 + ndup and row_v[pos] > NEG_INF \
                    and tab[int(rows[qi]), j - N // 2]:
                check(j - N // 2 in rowv[:pos],
                      "tie broken toward a higher index")
                n_ties += 1
    check(n_ties > 0, "the tie check saw no tie")
    used = len(set(rows.tolist()))
    nb = Q * D * 4 + N * D * 4 + used * N + Q * 4 + Q * K * 8
    # the dot products the data needs: one per (query, row its mask
    # lets through); the kernel skips the others
    live = int(table[rows.long()].sum())
    bms, by = bound_ms(nb, 2.0 * D * live, PEAK_FP32_S)

    def lib_fp32():
        s = q @ emb.T
        s = torch.where(table[rows.long()].bool(), s, NEG_INF)
        return torch.topk(s, K)

    results["router_topk"] = dict(
        name="router_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/router_topk.cu",
        replaces="src/repro/kernels/router_topk.py:203",
        max_abs_err=err,
        ms=time_graph_ms(torch, lambda: RT.router_topk(
            q, emb, table, rows, K), dev),
        plain_ms=time_ms(torch, lambda: RT.router_topk_plain(
            q, emb, table, rows, K), dev),
        bound_ms=bms, bound_by=by,
        library_ms=time_graph_ms(torch, lib_fp32, dev))
    eager = time_ms(torch, lambda: RT.router_topk(q, emb, table, rows, K),
                    dev)
    prof = one_launch(torch, dev, lambda: RT.router_topk(
        q, emb, table, rows, K), TOPK_KERNELS, "router_topk fp32")
    r_ = results["router_topk"]
    log(f"[kernels] router_topk route-step shape: {live} of {Q * N} "
        f"(query, row) pairs pass the mask; grid plan (S, chunk) "
        f"{RT.topk_plan(Q, N, D)}; {r_['ms']:.4f} ms (profiler: "
        f"{prof}), "
        f"kernel / library {r_['ms'] / r_['library_ms']:.2f}; eager call, "
        f"host work included: {eager:.4f} ms")

    # -- fp32 router_topk at the cache lookup's shape (k=1, threshold)
    C, DC = 4096, 40
    keys = rng.standard_normal((C, DC)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    qk = rng.standard_normal((Q, DC)).astype(np.float32)
    qk[: Q // 2] = keys[rng.integers(0, C, Q // 2)] \
        + 0.01 * rng.standard_normal((Q // 2, DC)).astype(np.float32)
    qk /= np.linalg.norm(qk, axis=1, keepdims=True)
    cmask = (rng.random((Q, C)) < 0.5).astype(np.uint8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    qk_d, keys_d, cmask_d = t(qk), t(keys), t(cmask)
    crow = torch.arange(Q, dtype=torch.int32, device=dev)
    got = RT.router_topk(qk_d, keys_d, cmask_d, crow, 1, min_score=0.95)
    want = RT.router_topk_plain(qk_d, keys_d, cmask_d, crow, 1,
                                min_score=0.95)
    err_c = compare_topk(torch, got, want, "router_topk fp32 cache")
    check(bool(torch.isfinite(got[0]).any()), "cache check found no hit")
    results["router_topk"]["max_abs_err"] = max(err, err_c)
    cache_ms = time_graph_ms(torch, lambda: RT.router_topk(
        qk_d, keys_d, cmask_d, crow, 1, min_score=0.95), dev)
    cache_plain = time_ms(torch, lambda: RT.router_topk_plain(
        qk_d, keys_d, cmask_d, crow, 1, min_score=0.95), dev)

    def lib_cache():
        s = qk_d @ keys_d.T
        s = torch.where(cmask_d.bool() & (s >= 0.95), s, NEG_INF)
        return torch.topk(s, 1)

    cache_lib = time_graph_ms(torch, lib_cache, dev)
    cache_prof = one_launch(torch, dev, lambda: RT.router_topk(
        qk_d, keys_d, cmask_d, crow, 1, min_score=0.95), TOPK_KERNELS,
        "router_topk cache")
    cb, cby = bound_ms(Q * DC * 4 + C * DC * 4 + Q * C + Q * 4 + Q * 8,
                       2.0 * DC * int(cmask.sum()), PEAK_FP32_S)
    log(f"[kernels] router_topk cache shape Q={Q} C={C} D={DC} k=1: "
        f"{cache_ms:.4f} ms (profiler: {cache_prof}; plain "
        f"{cache_plain:.4f}, library {cache_lib:.4f}, kernel / library "
        f"{cache_ms / cache_lib:.2f}, bound {cb:.4f} by {cby}), max err "
        f"{err_c:.3g}")

    # -- int8 router_topk at the route step's shape: bit-equal
    q8, qs = quantize_rows(q)
    e8, es = quantize_rows(emb)
    qs, es = qs[:, 0].contiguous(), es[:, 0].contiguous()
    q8, e8 = q8.contiguous(), e8.contiguous()
    got = RT.router_topk_q8(q8, e8, qs, es, table, rows, K)
    want = RT.router_topk_q8_plain(q8, e8, qs, es, table, rows, K)
    fin = torch.isfinite(want[0])
    check(torch.equal(got[0], want[0]), "router_topk_q8: values not bit-equal")
    check(torch.equal(got[1][fin], want[1][fin]),
          "router_topk_q8: indices differ")
    nb8 = Q * D + N * D + (Q + N) * 4 + used * N + Q * 4 + Q * K * 8
    bms8, by8 = bound_ms(nb8, 2.0 * D * live, PEAK_INT8_S)

    def lib_q8():
        s = (q8.float() @ e8.float().T) * (qs[:, None] * es[None, :])
        s = torch.where(table[rows.long()].bool(), s, NEG_INF)
        return torch.topk(s, K)

    results["router_topk_q8"] = dict(
        name="router_topk_q8", route="cuda",
        source="src/repro_torch/kernels/csrc/router_topk.cu",
        replaces="src/repro/kernels/router_topk.py:301",
        max_abs_err=float((got[0][fin] - want[0][fin]).abs().max()),
        ms=time_graph_ms(torch, lambda: RT.router_topk_q8(
            q8, e8, qs, es, table, rows, K), dev),
        plain_ms=time_ms(torch, lambda: RT.router_topk_q8_plain(
            q8, e8, qs, es, table, rows, K), dev),
        bound_ms=bms8, bound_by=by8,
        library_ms=time_graph_ms(torch, lib_q8, dev))
    r_ = results["router_topk_q8"]
    prof = one_launch(torch, dev, lambda: RT.router_topk_q8(
        q8, e8, qs, es, table, rows, K), TOPK_KERNELS, "router_topk_q8")
    log(f"[kernels] router_topk_q8 route-step shape: grid plan (S, chunk) "
        f"{RT.topk_plan(Q, N, D)}; {r_['ms']:.4f} ms "
        f"(profiler: {prof}), kernel / library "
        f"{r_['ms'] / r_['library_ms']:.2f}")
    n_cases = topk_sweep(torch, dev, rng, RT, quantize_rows)
    log(f"[kernels] router_topk sweep ({n_cases} cases, fp32 and int8: N "
        f"1-100,003, D 1-64, k 1-32, bias, min_score, empty rows, "
        f"duplicates, ascending and descending catalogs): bit-equal")

    # -- bandit_update at the learning step's shape: the whole call
    # (both halves) and the served launch (the update half, Bs = 0)
    Bu = Bs = 256
    DD = 9
    chosen = rng.integers(0, N, Bu)
    w = np.zeros((Bu, N), np.float32)
    w[np.arange(Bu), chosen] = 1.0
    x = rng.random((Bu, DD)).astype(np.float32)
    r = rng.random(Bu).astype(np.float32)
    xs = rng.random((Bs, DD)).astype(np.float32)
    theta = (rng.standard_normal((N, DD)) * 0.1).astype(np.float32)
    L = (rng.standard_normal((N, DD, DD)) * 0.05).astype(np.float32)
    ainv = (np.einsum("nde,nfe->ndf", L, L)
            + 0.5 * np.eye(DD, dtype=np.float32)).astype(np.float32)
    args = [t(a) for a in (w, x, r, xs, theta, ainv)]
    served = args[:3] + [args[3][:0], None, None]
    err_b = 0.0
    for a_, what in ((args, "both halves"), (served, "update half")):
        got = BU.bandit_update(*a_, 0.8)
        want = BU.bandit_update_plain(*a_, 0.8)
        for g, wv, nm in zip(got, want, ("dA", "db", "ucb")):
            d = (g - wv).abs()
            err_b = max(err_b, float(d.max()) if d.numel() else 0.0)
            check(bool((d <= 1e-5 * wv.abs() + 1e-6).all()),
                  f"bandit_update {what} {nm}: beyond rtol 1e-5 (atol 1e-6)")
        again = BU.bandit_update(*a_, 0.8)
        check(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
              f"bandit_update {what}: two launches differ")
    P2 = DD * DD
    nb_upd = 4 * (Bu * N + Bu * DD + Bu + N * P2 + N * DD)
    nb_ucb = 4 * (Bs * DD + N * DD + N * P2 + Bs * N)
    # the (Bu, N) mask is one-hot: the deltas need 2*Bu*(D^2+D) flops
    ops_upd = 2.0 * Bu * (P2 + DD)
    ops_ucb = 2.0 * Bs * N * (P2 + DD)
    bmb, byb = bound_ms(nb_upd + nb_ucb, ops_upd + ops_ucb, PEAK_FP32_S)
    bmu, byu = bound_ms(nb_upd, ops_upd, PEAK_FP32_S)
    bms_, bys_ = bound_ms(nb_ucb, ops_ucb, PEAK_FP32_S)
    xx = (args[1][:, :, None] * args[1][:, None, :]).reshape(Bu, -1)
    xr = args[1] * args[2][:, None]
    xxs = (args[3][:, :, None] * args[3][:, None, :]).reshape(Bs, -1)
    a2 = 0.64 * args[5].reshape(N, -1)

    def lib_update():
        return args[0].T @ xx, args[0].T @ xr

    def lib_bandit():
        return lib_update() + (args[3] @ args[4].T + torch.sqrt(
            torch.clamp(xxs @ a2.T, min=0.0)),)

    results["bandit_update"] = dict(
        name="bandit_update", route="cuda",
        source="src/repro_torch/kernels/csrc/bandit_update.cu",
        replaces="src/repro/kernels/bandit_update.py:67",
        max_abs_err=err_b,
        ms=time_graph_ms(torch, lambda: BU.bandit_update(*served, 0.8), dev),
        plain_ms=time_ms(torch, lambda: BU.bandit_update_plain(
            *served, 0.8), dev),
        bound_ms=bmu, bound_by=byu,
        library_ms=time_graph_ms(torch, lib_update, dev))
    both_ms = time_graph_ms(torch, lambda: BU.bandit_update(*args, 0.8), dev)
    both_plain = time_ms(torch, lambda: BU.bandit_update_plain(*args, 0.8),
                         dev)
    both_lib = time_graph_ms(torch, lib_bandit, dev)
    halves = kernel_times(torch, dev, lambda: BU.bandit_update(*args, 0.8))
    log(f"[kernels] bandit_update served launch (update half, Bs=0, Bu={Bu}, "
        f"N={N}, D={DD}): {results['bandit_update']['ms']:.4f} ms, bound "
        f"{bmu:.4f} by {byu}, w.T @ xx + w.T @ xr "
        f"{results['bandit_update']['library_ms']:.4f} ms")
    log(f"[kernels] bandit_update both halves (Bu=Bs={Bu}): {both_ms:.4f} ms "
        f"(plain {both_plain:.4f}, matmul form {both_lib:.4f}, bound "
        f"{bmb:.4f} by {byb}); kernel / matmul form "
        f"{both_ms / both_lib:.2f}")
    log(f"[kernels] bandit_update halves inside the whole call (profiler, "
        f"device time per launch): {fmt_times(halves)}; the score half's "
        f"bound {bms_:.4f} by {bys_}")
    for v in results.values():
        log(f"[kernels] {v['name']}: ok, max err {v['max_abs_err']:.3g}, "
            f"{v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, library "
            f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f} by "
            f"{v['bound_by']})")
    return results


# ----------------------------------------------------------------------
# phase 2: serving at full width
# ----------------------------------------------------------------------

def make_catalog(n: int, seed: int):
    """Seeded synthetic registry: 1-3 task types and 1-2 domains per
    entry, ~5% generalists; vision task types never carry a regulated
    domain, so those (task type, domain) filter rows are empty and the
    fallback ladder runs."""
    from repro_torch.core.mres import MRES, ModelEntry
    from repro_torch.core.preferences import DOMAINS, TASK_TYPES

    rng = np.random.default_rng(seed)
    vision = {"vqa", "captioning", "transcription"}
    regulated = ["legal", "finance", "healthcare"]
    open_dm = [d for d in DOMAINS if d not in regulated]
    acc = rng.random(n)
    lat = rng.random(n) * 500 + 1
    cost = rng.random(n) * 20 + 0.1
    eth = rng.random((n, 5))
    ntt = rng.integers(1, 4, n)
    ndm = rng.integers(1, 3, n)
    gen = rng.random(n) < 0.05
    entries = []
    for i in range(n):
        tts = tuple(rng.choice(TASK_TYPES, size=int(ntt[i]), replace=False))
        pool = open_dm if vision & set(tts) else DOMAINS
        dms = tuple(rng.choice(pool, size=int(ndm[i]), replace=False))
        raw = {"accuracy": float(acc[i]), "latency_ms": float(lat[i]),
               "cost_per_mtok": float(cost[i]),
               "helpfulness": float(eth[i, 0]),
               "harmlessness": float(eth[i, 1]),
               "honesty": float(eth[i, 2]),
               "steerability": float(eth[i, 3]),
               "creativity": float(eth[i, 4])}
        entries.append(ModelEntry(name=f"m{i}", raw_metrics=raw,
                                  task_types=tts, domains=dms,
                                  generalist=bool(gen[i])))
    m = MRES()
    m.register_many(entries)
    m.snapshot()
    return m


def make_batches(n_batch: int, seed: int):
    """4 batches of Requests; batches 3 and 4 repeat half of batch 1."""
    from repro_torch.core.preferences import PROFILES
    from repro_torch.data.workload import make_workload
    from repro_torch.serving.engine import Request

    profiles = sorted(PROFILES)
    recs = make_workload(4 * n_batch, seed=seed)
    reqs = [(Request(text=r.text, prefs=profiles[i % len(profiles)], id=i),
             r) for i, r in enumerate(recs)]
    b1 = reqs[:n_batch]
    h = n_batch // 2
    return [b1, reqs[n_batch:2 * n_batch],
            b1[:h] + reqs[2 * n_batch:2 * n_batch + n_batch - h],
            b1[h:] + reqs[3 * n_batch:3 * n_batch + h]]


class ReplayAnalyzer:
    """Serves the card run's task signatures, batch by batch, to the CPU
    reference run, so both runs route the same task vectors and filter
    rows.  Without this, float noise in the analyzer's complexity output
    -- which also varies with the batch a text rides in -- can move an
    int8 query row across a rounding boundary and change its kNN set
    with no tie in the final scores.

    Before replaying a batch it holds the card's signatures, which the
    fused analyze->route program produced, against the same weights
    run on the CPU over exactly that batch's texts: heads equal where
    the CPU's top-2 probability gap exceeds 1e-4, complexity and
    confidence within 1e-5."""

    def __init__(self, torch, card_analyzer, batches, tag: str):
        from repro_torch.kernels.analyze_step import AnalyzerEncoder

        self.torch = torch
        self.tokenize = card_analyzer.encode_batch
        self.cpu_enc = AnalyzerEncoder(card_analyzer.cfg, card_analyzer.state)
        self.batches = list(batches)          # [(texts, sigs)] per submit
        self.tag = tag
        self.n_texts = self.n_heads = 0

    def analyze_batch(self, texts):
        from repro_torch.core.preferences import DOMAINS, TASK_TYPES
        from repro_torch.kernels import ops

        torch = self.torch
        check(bool(self.batches), "the CPU run routed more batches")
        want, sigs = self.batches.pop(0)
        check(list(texts) == want, "the CPU run routed other requests "
                                   "than the card run")
        if not sigs:
            return sigs
        toks = self.tokenize(texts)
        cpu = ops.analyze_step(self.cpu_enc, toks, device="cpu")
        with torch.no_grad():
            logits = self.cpu_enc(torch.from_numpy(toks))[:2]
        decided = np.ones(len(texts), bool)
        for lg in logits:
            p = torch.sort(torch.softmax(lg, dim=-1), dim=1).values.numpy()
            decided &= (p[:, -1] - p[:, -2]) > 1e-4
        card = {"tt_idx": np.array([TASK_TYPES.index(s.task_type)
                                    for s in sigs]),
                "dm_idx": np.array([DOMAINS.index(s.domain) for s in sigs]),
                "cx": np.array([s.complexity for s in sigs], np.float32),
                "conf": np.array([s.confidence for s in sigs], np.float32)}
        for key in ("tt_idx", "dm_idx"):
            check(np.array_equal(card[key][decided], cpu[key][decided]),
                  f"{self.tag}: served analyzer {key} differs from the CPU")
        for key in ("cx", "conf"):
            err = float(np.abs(card[key] - cpu[key]).max())
            check(err <= 1e-5, f"{self.tag}: served analyzer {key} off by "
                               f"{err}")
        self.n_texts += len(texts)
        self.n_heads += int(decided.sum())
        return sigs


def build_router(mres, dev, quant: bool, seed: int, analyzer=None, *,
                 policy: str = "linucb", fused: bool = True, telemetry=None,
                 tracer=None):
    """The serving router: analyzer at full width (seeded), bandit +
    load + semantic cache, confidence threshold 0."""
    from repro_torch.adaptive import LinearBandit
    from repro_torch.cache.semantic import SemanticCache
    from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
    from repro_torch.core.orchestrator import OptiRoute
    from repro_torch.serving.load import LoadTracker

    n = len(mres)
    if analyzer is None:
        analyzer = TaskAnalyzer(AnalyzerConfig(), seed=seed, device=dev)
        if quant:                       # int8 analyzer weights as well
            analyzer.quantize()
    bandit = LinearBandit(n, policy=policy, seed=seed, noise=0.3,
                          device=dev)
    router = OptiRoute(
        mres, analyzer, adaptive=bandit, adaptive_weight=1.0,
        load=LoadTracker(n), load_weight=0.5,
        cache=SemanticCache(capacity=4096, min_quality=0.0, quantize=quant,
                            device=dev), telemetry=telemetry, tracer=tracer,
        device=dev)
    router.engine.confidence_threshold = 0.0
    router.engine.quantize = quant
    router.engine.fused = fused
    return router


def serve_run(mres, batches, dev, quant: bool, seed: int, analyzer=None,
              on_batch=None, **router_kw):
    """One serving run: 4 submits, each followed by observe;
    ``on_batch(i, responses)`` runs after each observe."""
    from repro_torch.data.workload import meta_of, quality_of
    from repro_torch.serving.engine import ServingEngine

    router = build_router(mres, dev, quant, seed, analyzer, **router_kw)
    eng = ServingEngine(router)
    out, lat, obs_s = [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        resp = eng.submit([r for r, _ in batch])
        lat.append(time.perf_counter() - t0)
        qual = [quality_of(meta_of(mres.entry(x.model)), rec.sig)
                for x, (_, rec) in zip(resp, batch)]
        t0 = time.perf_counter()
        eng.observe(resp, qual)
        obs_s.append(time.perf_counter() - t0)
        out.append(resp)
        if on_batch is not None:
            on_batch(i, resp)
    return router, out, lat, obs_s


def ranked_scores(rq) -> np.ndarray:
    """A routed query's ranked candidate scores: the batch arrays on the
    fused paths, the eager decision's list on the staged one."""
    if rq._batch is not None:
        return rq._batch.cand_score[rq._bidx]
    return np.array([sc for _, sc in rq.decision.candidates] or [NEG_INF])


def _row_detail(resp) -> str:
    """Candidates, scores and task vector of one routed response."""
    if resp.rq is None:
        return f"{resp.model} ({resp.admission}, no routed query)"
    d = resp.rq.decision
    return (f"cand {[m for m, _ in d.candidates[:4]]} "
            f"scores {np.round(ranked_scores(resp.rq)[:4], 6).tolist()} "
            f"T {np.asarray(resp.rq.task_vector).tolist()}")


def near_tie(scores) -> bool:
    return bool(len(scores) > 1 and np.isfinite(scores[:2]).all()
                and scores[0] - scores[1] <= 1e-5)


def decisions_match(ref, got, what: str) -> int:
    """Tie-aware comparison of two runs' responses; returns the number
    of tie-broken mismatches."""
    ties = 0
    for bi, (rb, gb) in enumerate(zip(ref, got)):
        for i, (a, b) in enumerate(zip(rb, gb)):
            check(a.cache_hit == b.cache_hit,
                  f"{what}: batch {bi} row {i} cache_hit differs")
            if a.cache_hit:
                check(a.model == b.model, f"{what}: cached model differs")
                continue
            check((a.admission, a.fallback) == (b.admission, b.fallback)
                  or a.model != b.model,
                  f"{what}: batch {bi} row {i} admission/fallback differs")
            if a.model == b.model:
                continue
            ok = any(x.rq is not None and near_tie(ranked_scores(x.rq))
                     for x in (a, b))
            check(ok, f"{what}: batch {bi} row {i} model {a.model} vs "
                      f"{b.model} without a tie; "
                      + "; ".join(_row_detail(x) for x in (a, b)))
            ties += 1
    return ties


def routing_inputs(small: bool, shared: dict):
    """The routing phases' catalog and batches (100,000 entries, 4
    batches of 256; 4,000 and 64 at ``--rehearse``), built once."""
    if "mres" not in shared:
        n = 4000 if small else 100_000
        nb = 64 if small else 256
        t0 = time.perf_counter()
        shared["mres"] = make_catalog(n, seed=1)
        shared["batches"] = make_batches(nb, seed=2)
        log(f"[serving] catalog of {n} entries built in "
            f"{time.perf_counter() - t0:.2f} s")
    return shared["mres"], shared["batches"]


def serving_phase(torch, dev, small: bool, kernels, shared):
    from repro_torch.kernels import bandit_update as BU
    from repro_torch.kernels import router_topk as RT

    mres, batches = routing_inputs(small, shared)
    cpu = torch.device("cpu")
    counters = {"router_topk": RT.router_topk,
                "router_topk_q8": RT.router_topk_q8,
                "bandit_update": BU.bandit_update}
    launches = {k: 0 for k in counters}
    stats = {}
    for quant in (False, True):
        tag = "int8" if quant else "fp32"
        for f in counters.values():
            f.launches = 0
        router, got, lat, obs_s = serve_run(mres, batches, dev, quant, seed=3)
        counts = {k: f.launches for k, f in counters.items()}
        log(f"[serving {tag}] launches on the main path: {counts}")
        on_path = ["router_topk_q8" if quant else "router_topk",
                   "bandit_update"]
        if dev.type == "cuda":
            for k in on_path:
                check(counts[k] > 0, f"{tag}: {k} never launched")
        for k, v in counts.items():
            launches[k] += v
        hits = [sum(x.cache_hit for x in b) for b in got]
        log(f"[serving {tag}] cache hits per batch: {hits}")
        check(hits[2] > 0 and hits[3] > 0, f"{tag}: repeats missed the cache")
        fallback = sum(bool(x.fallback) for b in got for x in b)
        log(f"[serving {tag}] fallback decisions: {fallback}")
        for i, (b, s) in enumerate(zip(got, lat)):
            miss = sum(not x.cache_hit for x in b)
            log(f"[serving {tag}] batch {i}: {len(b)} requests ({miss} "
                f"routed) submit {s * 1e3:.1f} ms = "
                f"{len(b) / s:.0f} decisions/s; observe "
                f"{obs_s[i] * 1e3:.1f} ms")
        steady = lat[1:]
        log(f"[serving {tag}] submit latency over batches 2-4: p50 "
            f"{np.quantile(steady, 0.5) * 1e3:.1f} ms, p99 "
            f"{np.quantile(steady, 0.99) * 1e3:.1f} ms")
        stats[tag] = {"submit_s": lat, "observe_s": obs_s}
        if dev.type == "cuda":
            routed = [[x for x in b if not x.cache_hit] for b in got]
            replay = ReplayAnalyzer(
                torch, router.analyzer,
                (([x.request.text for x in b], [x.sig for x in b])
                 for b in routed), tag)
            ref_router, ref, _, _ = serve_run(mres, batches, cpu, quant,
                                              seed=3, analyzer=replay)
            check(not replay.batches, f"{tag}: the CPU run routed fewer "
                                      "batches")
            log(f"[serving {tag}] the served analyzer outputs match the CPU "
                f"on the {replay.n_texts} routed texts, batch by batch "
                f"(heads compared on {replay.n_heads} with a top-2 gap "
                f"> 1e-4)")
            ties = decisions_match(ref, got, tag)
            log(f"[serving {tag}] decisions match the CPU run "
                f"({ties} tie-broken)")
            for nm in ("A", "b"):
                a = getattr(router.adaptive, nm)
                e = getattr(ref_router.adaptive, nm)
                check(np.allclose(a, e, rtol=1e-5, atol=1e-6),
                      f"{tag}: bandit {nm} differs from the CPU run")
            log(f"[serving {tag}] bandit A/b match the CPU run "
                "(rtol 1e-5)")
        breakdown(torch, dev, router, batches[1])
    for k, v in kernels.items():
        v["launches"] = launches[k]
    shared["serving"] = stats
    return stats


def breakdown(torch, dev, router, batch):
    """Host-clock split of one served batch's stages (each stage ends
    in a synchronize)."""
    from repro_torch.kernels import ops

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    reqs = [r for r, _ in batch]
    cache = router.cache
    an = router.analyzer
    eng = router.engine
    marks = {}

    def stage(name, fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            out = fn()
            sync()
            best = min(best, time.perf_counter() - t)
        marks[name] = best * 1e3
        return out

    from repro_torch.core.preferences import resolve_batch
    prefs = resolve_batch([r.prefs for r in reqs], len(reqs))
    keys = stage("cache keys", lambda: cache.keys_for(
        prefs, [r.text for r in reqs]))
    fps = cache.fingerprints(prefs, extras=[r.max_new for r in reqs])
    stage("cache lookup", lambda: cache.lookup(keys, fps))
    toks = stage("tokenize", lambda: an.encode_batch([r.text for r in reqs]))
    stage("analyzer encoder", lambda: ops.analyze_step(an.params, toks,
                                                        device=dev))
    stage("route_tokens_batch", lambda: eng.route_tokens_batch(
        an.params, an.cfg, toks, prefs))
    bandit = router.adaptive
    X = np.random.default_rng(0).random((len(reqs), 8)).astype(np.float32)
    ch = np.arange(len(reqs))
    rw = np.zeros(len(reqs), np.float32)
    state = bandit.state()
    stage("bandit update", lambda: bandit.update(X, ch, rw), reps=1)
    bandit.load_state(state)
    stage("posterior refresh (host inv)", lambda: bandit.posterior(), reps=1)
    log("[breakdown] " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                   marks.items()))


# ----------------------------------------------------------------------
# phase 2b: the router's other paths (staged, Thompson, sinks, state)
# ----------------------------------------------------------------------

def path_launches(fn):
    """Run ``fn`` with the serving kernels' counts set to 0 just before
    it; returns (fn's result, the counts read just after)."""
    from repro_torch.kernels import bandit_update as BU
    from repro_torch.kernels import router_topk as RT

    counters = {"router_topk": RT.router_topk,
                "router_topk_q8": RT.router_topk_q8,
                "bandit_update": BU.bandit_update}
    for f in counters.values():
        f.launches = 0
    out = fn()
    return out, {k: f.launches for k, f in counters.items()}


def candidate_sets_match(mres, ref, got, what: str) -> int:
    """Staged runs: per routed row whose kNN found candidates, the card's
    candidate set equals the CPU's (a Thompson bandit draws one sample
    per column of the union, so one flipped column shifts every later
    draw).  Fails naming the batch, the query and the two columns with
    their cosines.  Returns the rows compared."""
    from repro_torch.core.routing import cosine_sim

    emb = mres.embeddings()
    col = {m: j for j, m in enumerate(mres.snapshot()[1])}
    rows = 0
    for bi, (rb, gb) in enumerate(zip(ref, got)):
        for i, (a, b) in enumerate(zip(rb, gb)):
            if a.rq is None or b.rq is None:
                check(a.rq is None and b.rq is None,
                      f"{what}: batch {bi} row {i} routed on one side only")
                continue
            da, db = a.rq.decision, b.rq.decision
            if da.stage_sizes["filtered"] == 0 and \
                    db.stage_sizes["filtered"] == 0:
                continue
            sa = {m for m, _ in da.candidates}
            sb = {m for m, _ in db.candidates}
            if sa != sb:
                t = np.asarray(b.rq.task_vector, np.float32)
                ca, cb = sorted(sa - sb)[:1], sorted(sb - sa)[:1]
                cos = {m: float(cosine_sim(emb[col[m]][None], t)[0])
                       for m in ca + cb}
                raise SmokeFailure(
                    f"{what}: batch {bi} query {i} "
                    f"({b.request.text[:40]!r}) kNN candidate sets differ: "
                    f"CPU has {ca} the card lacks, the card {cb}; cosines "
                    f"{cos}")
            rows += 1
    return rows


def decision_lists_match(want, got, what: str) -> int:
    """Tie-aware comparison of two decision lists (same rung, score
    within 1e-5, same model unless the reference's top two tie)."""
    ties = 0
    for i, (a, b) in enumerate(zip(want, got)):
        check(a.fallback_kind == b.fallback_kind,
              f"{what}: row {i} fallback {a.fallback_kind!r} vs "
              f"{b.fallback_kind!r}")
        check(abs(a.score - b.score) <= 1e-5,
              f"{what}: row {i} score {a.score} vs {b.score}")
        if a.model != b.model:
            sc = np.array([x for _, x in a.candidates])
            check(near_tie(sc), f"{what}: row {i} model {a.model} vs "
                                f"{b.model} without a tie")
            ties += 1
    return ties


def staged_run(torch, dev, small, mres, batches, policy: str, tag: str):
    """Phases 1-2: the staged path on the card, then the same run on the
    CPU fed the card's signatures; candidate sets (Thompson), decisions
    and the bandit compared.  Returns (card router, responses, submit
    latencies, launches)."""
    cpu = torch.device("cpu")
    (router, got, lat, _), counts = path_launches(
        lambda: serve_run(mres, batches, dev, False, seed=3, policy=policy,
                          fused=False))
    log(f"[router_paths {tag}] launches on the staged path: {counts}")
    if dev.type == "cuda":
        for k in ("router_topk", "bandit_update"):
            check(counts[k] > 0, f"{tag}: {k} never launched")
    check(all(x.served for b in got for x in b),
          f"{tag}: a response failed or was shed")
    check(all(x.cache_hit or x.rq._batch is None for b in got for x in b),
          f"{tag}: a request took a fused path")
    routed = [[x for x in b if not x.cache_hit] for b in got]
    replay = ReplayAnalyzer(torch, router.analyzer,
                            (([x.request.text for x in b],
                              [x.sig for x in b]) for b in routed), tag)
    ref_router, ref, _, _ = serve_run(mres, batches, cpu, False, seed=3,
                                      analyzer=replay, policy=policy,
                                      fused=False)
    check(not replay.batches, f"{tag}: the CPU run routed fewer batches")
    if policy == "thompson":
        rows = candidate_sets_match(mres, ref, got, tag)
        log(f"[router_paths {tag}] kNN candidate sets equal the CPU's on "
            f"all {rows} rows, batch by batch")
    ties = decisions_match(ref, got, tag)
    log(f"[router_paths {tag}] decisions match the CPU run ({ties} "
        "tie-broken)")
    for nm in ("A", "b"):
        check(np.allclose(getattr(router.adaptive, nm),
                          getattr(ref_router.adaptive, nm), rtol=1e-5,
                          atol=1e-6),
              f"{tag}: bandit {nm} differs from the CPU run")
    log(f"[router_paths {tag}] bandit A/b match the CPU run (rtol 1e-5)")
    return router, got, lat, counts


def knn_against_dense_mask(torch, dev, eng, prefs, sigs) -> None:
    """The staged kNN's (table, rows) launch against the dense (B, N)
    mask call on the same card, bit for bit (values; indices where
    finite), with both times."""
    from repro_torch.kernels import ops

    _, _, T, ti, di = eng._prepare_batch(prefs, sigs)
    emb, _, tt, dm, gmask, _ = eng.mres.snapshot()
    k = min(eng.knn_k, emb.shape[0])
    mask = tt[ti] & dm[di]

    def rows():
        return ops.knn_rows(emb, tt, dm, gmask, T, ti, di, k=k, device=dev)

    def dense():
        return [x.cpu().numpy() for x in ops.router_topk(
            emb, T, k, mask=mask, device=dev)]

    (v1, i1), (v2, i2) = rows(), dense()
    fin = np.isfinite(v2)
    check(np.array_equal(v1, v2) and np.array_equal(i1[fin], i2[fin]),
          "staged kNN differs from the dense-mask call")
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    times = {}
    for name, fn in (("rows", rows), ("dense", dense), ("rows ", rows),
                     ("dense ", dense)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.setdefault(name.strip(), []).append(
            (time.perf_counter() - t0) * 1e3)
    log(f"[router_paths staged linucb] kNN of batch 2 (B={len(sigs)}) "
        f"through the filter table's rows equals the dense-mask call bit "
        f"for bit; host ms per call: rows "
        f"{', '.join(f'{t:.2f}' for t in times['rows'])}, dense mask "
        f"{', '.join(f'{t:.2f}' for t in times['dense'])}")


def p50_ms(lat) -> float:
    return float(np.quantile(lat[1:], 0.5)) * 1e3


def router_paths_phase(torch, dev, small: bool, kernels, shared):
    """The staged path (LinUCB with fused=False; Thompson), telemetry
    and tracing on the fused path, and RouterState, at the serving
    phase's full width."""
    import tempfile

    from repro_torch.checkpoint import RouterState, load_router_state
    from repro_torch.core.preferences import resolve_batch
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, metrics_from_prom, prometheus_text
    from repro_torch.serving.engine import ServingEngine

    mres, batches = routing_inputs(small, shared)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    total = {"router_topk": 0, "bandit_update": 0}
    fused_p50 = shared.get("serving", {}).get("fp32", {}).get("submit_s")
    fused_txt = (f"{p50_ms(fused_p50):.1f} ms" if fused_p50
                 else "not run in this call")

    # 1. staged LinUCB (fused=False), then staged vs fused on batch 2
    router, got, lat, counts = staged_run(torch, dev, small, mres, batches,
                                          "linucb", "staged linucb")
    for k in total:
        total[k] += counts[k]
    staged_counts = counts
    b2 = [r for r, _ in batches[1]]
    prefs = resolve_batch([r.prefs for r in b2], len(b2))
    sigs = [x.sig for x in got[1]]
    eng = router.engine
    staged = eng.route_many_staged(prefs, sigs)
    eng.fused = True
    fused = eng.route_many_batch(prefs, sigs).decisions()
    eng.fused = False
    ties = decision_lists_match(staged, fused, "staged vs fused")
    log(f"[router_paths staged linucb] batch 2 through route_many_staged "
        f"and route_many_batch on the card: equal ({ties} tie-broken)")
    knn_against_dense_mask(torch, dev, eng, prefs, sigs)
    log(f"[router_paths staged linucb] submit p50 over batches 2-4 "
        f"{p50_ms(lat):.1f} ms (fused fp32, serving phase: {fused_txt})")
    shared["staged_linucb_s"] = lat

    # 2. staged Thompson
    router, got, lat, counts = staged_run(torch, dev, small, mres, batches,
                                          "thompson", "staged thompson")
    for k in total:
        total[k] += counts[k]
    log(f"[router_paths staged thompson] submit p50 over batches 2-4 "
        f"{p50_ms(lat):.1f} ms (fused fp32, serving phase: {fused_txt})")
    del router, got

    # 3. telemetry and tracing on the fused LinUCB path, beside the same
    #    run without sinks (one card, one call)
    (_, plain_got, plain_lat, _), plain_counts = path_launches(
        lambda: serve_run(mres, batches, dev, False, seed=3))
    tel, tr = Telemetry(), Tracer()
    ops_deltas = []
    last = {}

    def per_batch(i, resp):
        """Per batch: the ops counters and the telemetry counters, each
        beside its value after the previous batch."""
        now = (ops.route_step_stats(),
               (tel.route_step_stats(), tel.analyze_step_stats()))
        ops_deltas.append((i, resp, last["ops"], now[0], last["tel"],
                           now[1]))
        last["ops"], last["tel"] = now

    ops.reset_route_step_stats()
    last["ops"] = ops.route_step_stats()
    last["tel"] = (tel.route_step_stats(), tel.analyze_step_stats())
    (router, got, lat, _), sink_counts = path_launches(
        lambda: serve_run(mres, batches, dev, False, seed=3,
                          on_batch=per_batch, telemetry=tel, tracer=tr))
    for k in total:
        total[k] += sink_counts[k]
    for i, resp, o0, o1, t0, t1 in ops_deltas:
        misses = sum(not x.cache_hit for x in resp)
        for j, fam in enumerate(("route_step", "analyze_step")):
            d_ops = o1[f"{fam}_dispatches"] - o0[f"{fam}_dispatches"]
            d_tel = t1[j]["dispatches"] - t0[j]["dispatches"]
            check(d_tel == d_ops == int(misses > 0),
                  f"telemetry: batch {i} {fam} dispatches {d_tel}, ops "
                  f"{d_ops}, misses {misses}")
            check(t1[j]["compiles"] == 0, f"telemetry: {fam} compiles")
    hits = sum(x.cache_hit for b in got for x in b)
    check(tel.cache_funnel()["hit"] == hits,
          f"telemetry: cache hits {tel.cache_funnel()['hit']} vs {hits}")
    check(tel.summary()["events"] == sum(not x.cache_hit for b in got
                                         for x in b),
          "telemetry: one route event per routed request")
    for b in got:
        for x in b:
            tree = tr.summary_tree(x.trace_id)
            check(tree is not None, "tracing: a response has no trace")
            want = ["cache_lookup"] if x.cache_hit else \
                ["analyze", "cache_lookup", "generate", "observe",
                 "route_step"]
            names = sorted(c["name"] for c in tree["children"])
            check(names == want, f"tracing: request {x.request.id} has "
                                 f"stages {names}, want {want}")
    submits = [sp for sp in tr.spans() if sp.name == "submit"]
    check(len(submits) == len(batches), "tracing: one submit per batch")
    for sp, b in zip(submits, got):
        tree = tr.summary_tree(sp.trace_id)
        names = sorted(c["name"] for c in tree["children"])
        want = ["admission", "analyze", "cache_lookup", "generate",
                "route_step"]
        if all(x.cache_hit for x in b):       # nothing routed
            want = ["cache_lookup"]
        check(names == want, f"tracing: batch stages {names}")
        rs = [c for c in tree["children"] if c["name"] == "route_step"]
        check(all(c["attrs"]["path"] == "fused"
                  and c["attrs"]["catalog_n"] == len(mres) for c in rs),
              "tracing: route_step span attributes")
    prom = metrics_from_prom(prometheus_text(tel, tracer=tr,
                                             load=router.load))
    for key, val in (("route_step_dispatches",
                      tel.route_step_stats()["dispatches"]),
                     ("analyze_step_dispatches",
                      tel.analyze_step_stats()["dispatches"]),
                     ("route_step_compiles", 0), ("events",
                                                  tel.summary()["events"]),
                     ("repro_trace_spans_total", tr.stats()["spans_total"]),
                     ('repro_cache_total{kind="hit"}', hits)):
        check(prom[key] == val, f"prometheus: {key} {prom[key]} vs {val}")
    check(sink_counts == plain_counts == staged_counts,
          f"launches with sinks {sink_counts}, without {plain_counts}, "
          f"staged {staged_counts}")
    check([[(x.model, x.cache_hit) for x in b] for b in got]
          == [[(x.model, x.cache_hit) for x in b] for b in plain_got],
          "the sinks changed a decision")
    log(f"[router_paths sinks] telemetry = ops counters on every batch "
        f"({tel.route_step_stats()}, {tel.analyze_step_stats()}); "
        f"{tr.stats()['spans_total']} spans, every request's trace holds "
        f"its stages; Prometheus text parses back; launches {sink_counts} "
        f"with the sinks, {plain_counts} without")
    log(f"[router_paths sinks] fused submit p50 over batches 2-4: sinks on "
        f"{p50_ms(lat):.1f} ms, off {p50_ms(plain_lat):.1f} ms")
    shared["sinks_on_s"], shared["sinks_off_s"] = lat, plain_lat
    del plain_got

    # 4. RouterState: save after run 3, restore into fresh routers
    b1 = [r for r, _ in batches[0]]
    sigs = [x.sig for x in got[1]]
    with tempfile.TemporaryDirectory() as tmp:
        state = RouterState(tmp)
        t0 = time.perf_counter()
        path = state.save(router, step=4)
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        fresh = build_router(mres, dev, False, seed=3)
        t0 = time.perf_counter()
        check(state.restore(fresh) == 4, "RouterState: restore step")
        restore_s = time.perf_counter() - t0
        want = router.engine.route_many_batch(prefs, sigs)
        have = fresh.engine.route_many_batch(prefs, sigs)
        check(np.array_equal(want.model_idx, have.model_idx)
              and np.array_equal(want.score, have.score),
              "RouterState: restored decisions are not bit-identical")
        on_cpu = build_router(mres, cpu, False, seed=3)
        load_router_state(str(path), on_cpu)
        cpu_dec = on_cpu.engine.route_many_batch(prefs, sigs).decisions()
        ties = decision_lists_match(cpu_dec, have.decisions(),
                                    "RouterState card vs CPU")
        head = b1[:len(b1) // 2]
        replay = ServingEngine(fresh).submit(head)
        warm = sum(x.cache_hit for x in replay)
        check(warm == len(head), f"RouterState: {warm} of {len(head)} "
                                 "replayed head requests hit")
    log(f"[router_paths state] RouterState file {size} bytes, save "
        f"{save_s * 1e3:.1f} ms, restore {restore_s * 1e3:.1f} ms; "
        f"route_many of batch 2 bit-identical after restore; the CPU "
        f"restore matches ({ties} tie-broken); {warm} of {len(head)} "
        "replayed head requests hit the restored cache")
    for k, v in total.items():
        if k in kernels:
            kernels[k]["launches"] += v
    log(f"[router_paths] launches on the phase's main paths {total}; "
        f"phase took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 2c: the mega-catalog programs (sharded, IVF)
# ----------------------------------------------------------------------

ROUTE_KEYS = ("model_idx", "score", "stage", "similarity", "cand_idx",
              "cand_score", "n_filtered", "n_candidates")
# (tag, int8, sharded, nprobe: None = exhaustive dense, "C" = every cell)
MEGA_ENGINES = (("a dense fp32", False, False, None),
                ("b sharded fp32", False, True, None),
                ("c dense int8", True, False, None),
                ("d sharded int8", True, True, None),
                ("e ivf fp32 nprobe 8", False, False, 8),
                ("f ivf int8 nprobe 8", True, False, 8),
                ("g ivf fp32 nprobe C", False, False, "C"))
MEGA_SHARDS = 4


def mega_engine(mres, dev, spec, blend, n_cells: int):
    """A ``RoutingEngine`` of one mega-catalog mode, its knobs set after
    construction; with ``blend`` (a bandit state and the load tracker's
    admits) the bandit and load terms at ``build_router``'s weights."""
    from repro_torch.adaptive import LinearBandit
    from repro_torch.core.routing import RoutingEngine
    from repro_torch.launch.mesh import make_routing_mesh
    from repro_torch.obs import Tracer
    from repro_torch.serving.load import LoadTracker

    _, quant, sharded, nprobe = spec
    n = len(mres)
    kw = {}
    if blend is not None:
        state, admits = blend
        bandit = LinearBandit(n, policy="linucb", seed=3, noise=0.3,
                              device=dev)
        bandit.load_state(state)
        load = LoadTracker(n)
        load.admit_many(admits)
        kw = dict(adaptive=bandit, adaptive_weight=1.0, load=load,
                  load_weight=0.5)
    eng = RoutingEngine(mres, confidence_threshold=0.0, tracer=Tracer(),
                        device=dev, **kw)
    eng.quantize = quant
    if sharded:
        eng.mesh = make_routing_mesh(MEGA_SHARDS, device=dev)
    if nprobe is not None:
        eng.ivf, eng.nprobe = True, n_cells if nprobe == "C" else nprobe
        # the default gate (4,096) stays at N = 100,000; the rehearsal's
        # 4,000 entries would sit below it
        eng.ivf_min_n = min(eng.ivf_min_n, n)
    return eng


def mega_run(eng, inputs):
    """``route_many_batch`` over the batches: per batch the output
    arrays, the host seconds and the kernels' launches (counts set to 0
    just before each batch, read just after)."""
    outs, lat, launches = [], [], []
    for prefs, sigs in inputs:
        t0 = time.perf_counter()
        out, counts = path_launches(lambda: eng.route_many_batch(prefs,
                                                                 sigs))
        lat.append(time.perf_counter() - t0)
        outs.append(out)
        launches.append(counts)
    return outs, lat, launches


def route_arrays_close(want, got, what: str) -> int:
    """Two runs' route outputs: stages and counts exact, scores within
    1e-5, candidate indices equal except inside a run of the
    reference's scores tied within 1e-5.  Returns the tie-broken
    slots."""
    ties = 0
    for key in ("stage", "n_filtered", "n_candidates"):
        check(np.array_equal(getattr(want, key), getattr(got, key)),
              f"{what}: {key} differs")
    ws, gs = want.cand_score, got.cand_score
    fin = np.isfinite(ws)
    check(np.array_equal(np.isfinite(gs), fin), f"{what}: finite slots")
    err = float(np.abs(gs[fin] - ws[fin]).max()) if fin.any() else 0.0
    check(err <= 1e-5, f"{what}: candidate scores off by {err}")
    wi, gi = want.cand_idx, got.cand_idx
    for b, j in zip(*np.nonzero(fin & (gi != wi))):
        alt = np.nonzero(wi[b] == gi[b, j])[0]
        check(alt.size > 0 and abs(ws[b, alt[0]] - ws[b, j]) <= 1e-5,
              f"{what}: row {b} slot {j} index {gi[b, j]} vs {wi[b, j]} "
              "without a tie")
        ties += 1
    return ties


def mega_recall(want, got, emb, exact: bool) -> float:
    """Recall@k of ``got`` against ``want``: the exact candidate sets,
    or (``exact=False``) ``bench_mega``'s metric -- a candidate whose
    exact cosine is within the int8 error bound of the reference's
    k-th best counts, over rows both serve at stage 0."""
    tol = float(np.sqrt(emb.shape[1]) / 127.0
                + emb.shape[1] / (2.0 * 127.0 ** 2))
    embn = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    num = den = 0
    for w, g in zip(want, got):
        qn = w.task_vectors / (np.linalg.norm(w.task_vectors, axis=1,
                                              keepdims=True) + 1e-9)
        for b in range(len(w)):
            rrow = [int(x) for x in w.cand_idx[b] if x >= 0]
            trow = [int(x) for x in g.cand_idx[b] if x >= 0]
            if exact:
                den += len(rrow)
                num += len(set(rrow) & set(trow))
                continue
            if w.stage[b] or g.stage[b] or not rrow:
                continue
            ckth = float((embn[rrow] @ qn[b]).min())
            den += len(rrow)
            num += min(len(rrow), int(((embn[trow] @ qn[b])
                                       >= ckth - tol).sum()))
    return num / max(den, 1)


def probed_cells(torch, dev, T: np.ndarray, cent: np.ndarray, nprobe: int):
    """The cells the IVF program probes for task vectors ``T`` on
    ``dev`` (its own coarse step)."""
    from repro_torch.kernels.route_step import _dot_cols, unit_rows
    from repro_torch.kernels.router_topk import topk_stable

    qn = unit_rows(torch.from_numpy(np.ascontiguousarray(T)).to(dev))
    c = torch.from_numpy(cent).to(dev)
    return topk_stable(_dot_cols(qn, c), min(nprobe, c.shape[0]))[1].cpu()


def shard_topk_rows(torch, dev, mres, prefs, sigs, launches: dict):
    """``router_topk`` and ``router_topk_q8`` at the sharded batch's
    launch shape (shard 0's catalog block and filter rows, batch 2's
    queries, k = R = 8) against their plain versions, timed beside one
    ``torch.matmul`` + ``topk`` and the bound."""
    from repro_torch.core.routing import RoutingEngine
    from repro_torch.kernels import ops
    from repro_torch.kernels import router_topk as RT
    from repro_torch.kernels.route_step import quantize_rows, unit_rows
    from repro_torch.launch.mesh import make_routing_mesh

    eng = RoutingEngine(mres, confidence_threshold=0.0, device=dev)
    _, _, T, ti, di = eng._prepare_batch(prefs, sigs)
    emb, _, tt, dm, gmask, _ = mres.snapshot()
    Q = ops.q_bucket(len(sigs))
    n_dm = dm.shape[0]
    rows_np = np.pad(ti.astype(np.int64) * n_dm + di,
                     (0, Q - len(sigs)), constant_values=(
                         tt.shape[0] - 1) * n_dm + n_dm - 1)
    qn = unit_rows(torch.from_numpy(np.pad(T, ((0, Q - len(sigs)),
                                               (0, 0)))).to(dev))
    rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
    out = {}
    for quant, name in ((False, "router_topk"), (True, "router_topk_q8")):
        shards, _, np_pad = ops._catalog_pack_sharded(
            emb, tt, dm, gmask, make_routing_mesh(MEGA_SHARDS, device=dev),
            quant=quant)
        sh = shards[0]
        n_loc = sh.e2.shape[0]
        e = sh.e2[:, :8].contiguous()
        table = sh.masks
        live = int(table[rows.long()].sum())
        used = len(set(rows_np.tolist()))
        if quant:
            q8, qs = quantize_rows(qn)
            q8, qs = q8.contiguous(), qs[:, 0].contiguous()
            es = sh.e2s[:, 0].contiguous()
            args = (q8, e, qs, es, table, rows, 8)
            fn, plain = RT.router_topk_q8, RT.router_topk_q8_plain
            nb = Q * 8 + n_loc * 8 + (Q + n_loc) * 4
            peak = PEAK_INT8_S

            def lib():
                s = (q8.float() @ e.float().T) * (qs[:, None] * es[None, :])
                s = torch.where(table[rows.long()].bool(), s, NEG_INF)
                return torch.topk(s, 8)
        else:
            args = (qn.contiguous(), e, table, rows, 8)
            fn, plain = RT.router_topk, RT.router_topk_plain
            nb = Q * 8 * 4 + n_loc * 8 * 4
            peak = PEAK_FP32_S

            def lib():
                s = args[0] @ e.T
                s = torch.where(table[rows.long()].bool(), s, NEG_INF)
                return torch.topk(s, 8)
        got, want = fn(*args), plain(*args)
        fin = torch.isfinite(want[0])
        check(torch.equal(got[0], want[0]) and
              torch.equal(got[1][fin], want[1][fin]),
              f"{name} at the shard shape: not bit-equal to the plain "
              "version")
        bms, by = bound_ms(nb + used * n_loc + Q * 4 + Q * 8 * 8,
                           2.0 * 8 * live, peak)
        label = (f"{name} shard Q={Q} N={n_loc:,} D=8 k=8 "
                 f"({MEGA_SHARDS} shards of {np_pad:,})")
        out[label] = dict(
            name=label, route="cuda",
            source="src/repro_torch/kernels/csrc/router_topk.cu",
            replaces="src/repro/kernels/router_topk.py:"
                     + ("301" if quant else "203"),
            launches=launches[name], max_abs_err=0.0,
            ms=time_graph_ms(torch, lambda: fn(*args), dev),
            plain_ms=time_ms(torch, lambda: plain(*args), dev),
            bound_ms=bms, bound_by=by,
            library_ms=time_graph_ms(torch, lib, dev))
        r = out[label]
        log(f"[mega_catalog] {label}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, matmul + topk {r['library_ms']:.4f}, "
            f"bound {bms:.4f} by {by}; grid plan (S, chunk) "
            f"{RT.topk_plan(Q, n_loc, 8)}), {live} (query, row) pairs "
            f"pass the mask; {r['launches']} launches on the phase")
    return out


def mega_catalog_phase(torch, dev, small: bool, kernels, shared):
    """The sharded and IVF programs over the routing phases' catalog and
    batches, each engine without and with blend terms; checks,
    recall, card against CPU, launch counts and spans."""
    from repro_torch.adaptive import LinearBandit
    from repro_torch.core.mres import build_ivf, default_n_cells
    from repro_torch.core.preferences import METRICS, resolve_batch
    from repro_torch.kernels import ops

    mres, batches = routing_inputs(small, shared)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    n = len(mres)
    inputs = [(resolve_batch([r.prefs for r, _ in b], len(b)),
               [rec.sig for _, rec in b]) for b in batches]
    C = default_n_cells(n)
    t0 = time.perf_counter()
    index = mres.ivf_index()
    build_s = time.perf_counter() - t0
    again = build_ivf(mres.embeddings(), C)
    check(index.n_cells == C and np.array_equal(index.centroids,
                                                again.centroids)
          and np.array_equal(index.cell_of, again.cell_of),
          "the IVF index is not reproducible")
    sizes = np.bincount(index.cell_of, minlength=C)
    cap = max(8, -(-int(sizes.max()) // 8) * 8)
    Qp = ops.q_bucket(len(batches[0]))
    log(f"[mega_catalog] IVF index: C={C} cells (sizes {int(sizes.min())}"
        f"-{int(sizes.max())}, mean {n / C:.1f}), build_ivf {build_s:.3f} s "
        f"(host numpy), rebuilt bit-equal; cap {cap}, packed slots "
        f"{C * cap:,}; the fine gather (Q={Qp}, 8 cells x {cap} slots, 8 "
        f"dims) {Qp * 8 * cap * 8 * 4 / 1e6:.1f} MB fp32 / "
        f"{Qp * 8 * cap * 8 / 1e6:.1f} MB int8; the escape's (Q, C x cap) "
        f"blend {Qp * C * cap * 4 / 1e6:.1f} MB")
    rng = np.random.default_rng(4)
    X = rng.random((256, len(METRICS))).astype(np.float32)
    warm = LinearBandit(n, policy="linucb", seed=3, device=cpu)
    warm.update(X, rng.integers(0, n, 256), rng.random(256).astype(
        np.float32))
    blends = {"no blend terms": None,
              "bandit + load": (warm.state(), rng.integers(0, n, 3 * n))}
    shard_launches = {"router_topk": 0, "router_topk_q8": 0}
    timing = {}
    for label, blend in blends.items():
        runs = {}
        for spec in MEGA_ENGINES:
            tag, quant, sharded, nprobe = spec
            eng = mega_engine(mres, dev, spec, blend, C)
            outs, lat, launches = mega_run(eng, inputs)
            runs[tag] = outs
            kname = "router_topk_q8" if quant else "router_topk"
            for counts in launches:
                want = MEGA_SHARDS if sharded else (0 if nprobe else 1)
                other = {k: v for k, v in counts.items() if k != kname}
                if dev.type == "cuda":
                    check(counts[kname] == want and not any(other.values()),
                          f"{tag}: launches {counts} a batch, want "
                          f"{want} of {kname}")
                if sharded:
                    shard_launches[kname] += counts[kname]
                elif kname in kernels:
                    row = kernels[kname]
                    row["launches"] = row.get("launches", 0) + counts[kname]
            spans = [sp for sp in eng.tracer.spans()
                     if sp.name == "route_step"]
            path = "sharded" if sharded else "ivf" if nprobe else "dense"
            check(len(spans) == len(inputs) and all(
                sp.attrs["path"] == path
                and sp.attrs["shards"] == (MEGA_SHARDS if sharded else 1)
                for sp in spans), f"{tag}: route_step spans "
                f"{[(sp.attrs['path'], sp.attrs['shards']) for sp in spans]}")
            extra = ""
            if nprobe:
                esc = [sp.attrs["escape_rows"] for sp in spans]
                check(all(sp.attrs["n_bucket"] == cap for sp in spans),
                      f"{tag}: span n_bucket is not cap")
                extra = (f"; escape branch ran on {sum(e > 0 for e in esc)}"
                         f" of {len(esc)} batches ({sum(esc)} rows)")
            if blend is None:
                timing[tag] = lat
            log(f"[mega_catalog {label}] {tag}: host ms per batch "
                f"{', '.join(f'{x * 1e3:.1f}' for x in lat)}; launches "
                f"{launches[0]} a batch{extra}")
            if dev.type == "cuda" and tag[0] in "bcdef":
                ref = mega_run(mega_engine(mres, cpu, spec, blend, C),
                               inputs)[0]
                ties = sum(route_arrays_close(w, g, f"{tag} {label} card "
                                                    f"vs CPU batch {i}")
                           for i, (w, g) in enumerate(zip(ref, outs)))
                moved = 0
                if nprobe:
                    for w in outs:
                        a = probed_cells(torch, dev, w.task_vectors,
                                         index.centroids, eng.nprobe)
                        b = probed_cells(torch, cpu, w.task_vectors,
                                         index.centroids, eng.nprobe)
                        moved += int((a != b).any(dim=1).sum())
                    check(moved == 0, f"{tag}: {moved} queries probe other "
                                      "cells on the card than on the CPU")
                log(f"[mega_catalog {label}] {tag}: card = CPU run on all "
                    f"{len(outs)} batches ({ties} tie-broken slots"
                    + (f"; 0 queries probe other cells)" if nprobe else ")"))
            del eng
        for x, y in (("b sharded fp32", "a dense fp32"),
                     ("d sharded int8", "c dense int8")):
            for i, (g, w) in enumerate(zip(runs[x], runs[y])):
                for key in ROUTE_KEYS:
                    check(np.array_equal(getattr(g, key), getattr(w, key)),
                          f"{label}: {x} != {y} on {key}, batch {i}")
        for i, (g, w) in enumerate(zip(runs["g ivf fp32 nprobe C"],
                                       runs["a dense fp32"])):
            for key in ("model_idx", "stage", "cand_idx", "n_filtered",
                        "n_candidates"):
                check(np.array_equal(getattr(g, key), getattr(w, key)),
                      f"{label}: nprobe = C != dense on {key}, batch {i}")
            for key in ("score", "similarity", "cand_score"):
                check(np.allclose(getattr(g, key), getattr(w, key),
                                  rtol=1e-5, atol=1e-5),
                      f"{label}: nprobe = C scores off dense, batch {i}")
        dense = runs["a dense fp32"]
        emb = mres.embeddings()
        rec = {t: (mega_recall(dense, runs[t], emb, True),
                   mega_recall(dense, runs[t], emb, False))
               for t in ("e ivf fp32 nprobe 8", "f ivf int8 nprobe 8")}
        for t, (ex, eps) in rec.items():     # a property of N = 100,000
            check(small or eps >= 0.99, f"{label}: {t} recall@8 {eps:.4f} "
                                        "< 0.99 (bench_mega's metric)")
        log(f"[mega_catalog {label}] sharded = dense bit for bit on all 8 "
            f"outputs (fp32 and int8, 4 batches); nprobe = C = dense "
            f"(indices, stages, counts; scores within 1e-5); recall@8 "
            f"against (a), exact-set / bench_mega's: " + "; ".join(
                f"{t} {ex:.4f} / {eps:.4f}" for t, (ex, eps) in rec.items()))
    p2, s2 = inputs[1]
    for spec in MEGA_ENGINES[:2] + MEGA_ENGINES[4:5]:
        eng = mega_engine(mres, dev, spec, None, C)
        ev = time_ms(torch, lambda: eng.route_many_batch(p2, s2), dev,
                     iters=5, warmup=1)
        busy = sum(v[0] for v in trace_kernels(
            torch, dev, lambda: eng.route_many_batch(p2, s2),
            iters=5).values())
        log(f"[mega_catalog] {spec[0]}, batch 2 without blend terms: "
            f"{ev:.3f} ms a call (CUDA events, host work included), "
            f"kernels {busy:.3f} ms (profiler)" if dev.type == "cuda"
            else f"[mega_catalog] {spec[0]}: {ev:.1f} ms a call (host)")
    log("[mega_catalog] route_many_batch p50 over batches 2-4 without "
        "blend terms, host ms: " + "; ".join(
            f"{t} {p50_ms(v):.1f}" for t, v in timing.items()))
    kernels.update(shard_topk_rows(torch, dev, mres, p2, s2,
                                   shard_launches))
    log(f"[mega_catalog] phase took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 4: the model-zoo kernels against their plain versions
# ----------------------------------------------------------------------

def sdpa_call(torch, q, k, v, **kw):
    """One PyTorch call computing attention on (B, H, L, hd) operands
    (the yardstick only: the port never calls it).  GQA through
    ``enable_gqa`` where this PyTorch has it, else K/V repeated once,
    outside the timed call."""
    import torch.nn.functional as F
    G = q.shape[1] // k.shape[1]
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:
        kr = k.repeat_interleave(G, dim=1)
        vr = v.repeat_interleave(G, dim=1)
        return lambda: F.scaled_dot_product_attention(q, kr, vr, **kw)


def attn_check(torch, FA, q, k, v, kv_valid, tol, what, **kw):
    """Kernel (through its wrapper) against the plain version on the
    same (B, H, L, hd) operands, |err| <= tol * (1 + |want|) (a bf16
    output may round one ulp apart, and an ulp grows with |want|);
    returns the max abs error."""
    got = FA.flash_attention(q, k, v, kv_valid, **kw)
    want = FA.flash_attention_plain(q, k, v, kv_valid, **kw)
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs()
    over = float((diff - tol * (1 + want.float().abs())).max())
    check(over <= 0, f"{what}: |err| exceeds {tol} * (1 + |want|) by {over}")
    return float(diff.max())


def served_decode(torch, FA, g, dev, B, C, Hq, Hkv, hd, what):
    """The decode step as the served path runs it: one bf16 query per
    sequence against a cache of capacity C whose live lengths are
    prompt + step (513..528 at prompt 512), checked against the plain
    version and timed beside SDPA with a bool mask in the same run.
    Returns (err, kernel ms, SDPA ms)."""
    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)
    kvv = np.arange(B) % 16 + (C - 23)
    kv_valid = torch.from_numpy(kvv.astype(np.int32)).to(dev)
    q = rn(B, 1, Hq, hd).transpose(1, 2)
    k = rn(B, C, Hkv, hd).transpose(1, 2)
    v = rn(B, C, Hkv, hd).transpose(1, 2)
    err = attn_check(torch, FA, q, k, v, kv_valid, 2e-2, what,
                     causal=False)
    live = int(kvv.sum())
    bms, by = bound_ms(2 * (2 * B * Hq * hd + 2 * live * Hkv * hd),
                       4.0 * Hq * hd * live, PEAK_BF16_S)
    ms = time_graph_ms(torch, lambda: FA.flash_attention(
        q, k, v, kv_valid, causal=False), dev)
    mask = torch.arange(C, device=dev)[None, :] < kv_valid[:, None]
    lib = time_graph_ms(torch, sdpa_call(
        torch, q.contiguous(), k.contiguous(), v.contiguous(),
        attn_mask=mask[:, None, None, :]), dev)
    log(f"[kernels] {what}: B={B} C={C} {Hq}/{Hkv} heads of {hd}, live "
        f"{int(kvv.min())}-{int(kvv.max())} ({live} keys, splits "
        f"{FA.decode_splits(B, Hkv, C)}): {ms:.4f} ms, SDPA {lib:.4f} ms, "
        f"kernel / SDPA {ms / lib:.2f}, bound {bms:.4g} by {by} "
        f"({ms / bms:.1f}x), max err {err:.3g}")
    return err, ms, lib


def attn_sweep(torch, FA, g, dev, dt, tol):
    """Window, softcap, causal=False, Lq != Lk, hd 32/64/128, G 1-16,
    rows with no live key, and decode over caches of 1, 63, 536 and
    4,100 slots with kv_valid 0, 1, a split boundary and the full
    capacity, in the model's strided layout; returns the max error."""
    cases = [((2, 90, 90, 4, 2, 64), None, dict(causal=True, window=16)),
             ((2, 90, 90, 4, 2, 64), None,
              dict(causal=True, window=7, softcap=50.0)),
             ((2, 90, 90, 4, 2, 32), None, dict(causal=False, softcap=30.0)),
             ((2, 100, 100, 4, 1, 128), None, dict(causal=True)),
             ((2, 70, 130, 8, 2, 64), None, dict(causal=True)),
             ((2, 200, 200, 10, 2, 64), [0, 150], dict(causal=True)),
             ((1, 513, 513, 8, 1, 64), None, dict(causal=True)),
             ((3, 1, 100, 8, 2, 128), [0, 50, 100], dict(causal=False)),
             ((2, 1, 300, 4, 4, 64), [300, 7], dict(causal=False)),
             ((2, 1, 77, 32, 1, 64), None, dict(causal=True, window=20))]
    for cap in (1, 63, 536, 4100):
        n, chunk = FA.decode_splits(4, 2, cap)
        cases.append(((4, 1, cap, 32, 2, 64),
                      [0, 1, min(chunk, cap), cap], dict(causal=False)))
    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)
    worst = 0.0
    for (b_, lq, lk, hq, hk, d), kvl, kw in cases:
        kvt = None if kvl is None else torch.tensor(
            kvl, dtype=torch.int32, device=dev)
        worst = max(worst, attn_check(
            torch, FA, rn(b_, lq, hq, d).transpose(1, 2),
            rn(b_, lk, hk, d).transpose(1, 2),
            rn(b_, lk, hk, d).transpose(1, 2), kvt, tol,
            f"flash_attention {dt} {(b_, lq, lk, hq, hk, d)} {kw}", **kw))
    return worst, len(cases)


def ssd_ops(Bb, L, H, P, N, chunk, f32: bool, h0: bool) -> float:
    """Tensor-core operations the scan kernel issues, each product
    counted with the split's multiple m (an f32 operand is two bf16
    products against a bf16 one, three against an f32 one).  Per
    (batch, chunk of length c): C B^T over the causal pairs, c(c+1)N,
    once for all heads (m = 3 for f32 B and C, else 1).  Per (batch,
    head, chunk): the intra-chunk sum, c(c+1)P, the chunk's state,
    2cPN, and the inter-chunk term, 2cNP (none in the first chunk
    without h0), each m = 3 or 2."""
    m1, m2 = (3, 3) if f32 else (1, 2)
    ops = 0.0
    for i, c0 in enumerate(range(0, L, chunk)):
        c = min(chunk, L - c0)
        tri = c * (c + 1) / 2
        per_head = m2 * (2.0 * tri * P + 2.0 * c * P * N)
        if i > 0 or h0:
            per_head += m2 * 2.0 * c * N * P
        ops += Bb * (2.0 * tri * N * m1 + H * per_head)
    return ops


def model_kernel_phase(torch, dev, small: bool):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS

    results = {}
    g = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    bf = torch.bfloat16
    # -- llama3.2-1b prefill: B=16, L=prompt_len, 32/8 heads of 64, bf16
    B, L, Hq, Hkv, hd = (2, 64, 4, 1, 64) if small else (16, 512, 32, 8, 64)
    # layer layout (B, L, H, hd) as the model hands it over; the kernel
    # contract is (B, H, L, hd): transpose(1, 2) views, no copy
    q = rn(B, L, Hq, hd, dt=bf).transpose(1, 2)
    k = rn(B, L, Hkv, hd, dt=bf).transpose(1, 2)
    v = rn(B, L, Hkv, hd, dt=bf).transpose(1, 2)
    err_p = attn_check(torch, FA, q, k, v, None, 2e-2,
                       "flash_attention prefill", causal=True)
    nb = 2 * (2 * B * L * Hq * hd + 2 * B * L * Hkv * hd)
    bms, by = bound_ms(nb, 4.0 * B * Hq * hd * (L * (L + 1) / 2),
                       PEAK_BF16_S)
    qc, kc_, vc_ = (x.contiguous() for x in (q, k, v))
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:87",
        max_abs_err=err_p,
        ms=time_graph_ms(torch, lambda: FA.flash_attention(
            q, k, v, causal=True), dev),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_plain(
            q, k, v, causal=True), dev),
        bound_ms=bms, bound_by=by,
        library_ms=time_graph_ms(torch, sdpa_call(torch, qc, kc_, vc_,
                                                  is_causal=True), dev))

    # -- the decode shape: one query against a cache of capacity
    # prompt + max_new + 8, mixed live lengths
    C = 76 if small else 536
    rng = np.random.default_rng(8)
    kvv = rng.integers(1, C + 1, B)
    kvv[0], kvv[-1] = 1, C
    kv_valid = torch.from_numpy(kvv.astype(np.int32)).to(dev)
    qd = rn(B, 1, Hq, hd, dt=bf).transpose(1, 2)
    kd = rn(B, C, Hkv, hd, dt=bf).transpose(1, 2)
    vd = rn(B, C, Hkv, hd, dt=bf).transpose(1, 2)
    err_d = attn_check(torch, FA, qd, kd, vd, kv_valid, 2e-2,
                       "flash_attention decode", causal=False)
    live = int(kvv.sum())
    dbms, dby = bound_ms(2 * (2 * B * Hq * hd + 2 * live * Hkv * hd),
                         4.0 * Hq * hd * live, PEAK_BF16_S)
    dec_ms = time_graph_ms(torch, lambda: FA.flash_attention(
        qd, kd, vd, kv_valid, causal=False), dev)
    dec_plain = time_ms(torch, lambda: FA.flash_attention_plain(
        qd, kd, vd, kv_valid, causal=False), dev)
    mask = (torch.arange(C, device=dev)[None, :] < kv_valid[:, None])
    dec_lib = time_graph_ms(torch, sdpa_call(
        torch, qd.contiguous(), kd.contiguous(), vd.contiguous(),
        attn_mask=mask[:, None, None, :]), dev)
    log(f"[kernels] flash_attention decode shape B={B} C={C} Hq={Hq} "
        f"Hkv={Hkv} hd={hd} bf16, {live} live keys: {dec_ms:.4f} ms "
        f"(plain {dec_plain:.4f}, library {dec_lib:.4f}, bound "
        f"{dbms:.4g} by {dby}), max err {err_d:.3g}")

    # -- the served decode shape: live lengths prompt + step
    err_s, srv_ms, srv_lib = served_decode(
        torch, FA, g, dev, B, C, Hq, Hkv, hd,
        "flash_attention served decode, group 4")
    results["flash_attention"]["max_abs_err"] = max(err_p, err_d, err_s)
    log(f"[kernels] flash_attention kernel / SDPA: prefill "
        f"{results['flash_attention']['ms'] / results['flash_attention']['library_ms']:.2f}, "
        f"decode (random lengths) {dec_ms / dec_lib:.2f}, served decode "
        f"{srv_ms / srv_lib:.2f}")

    # -- sweeps in f32 and bf16: window, softcap, causal=False, ragged,
    # zero rows, G 1-16, decode caches of 1..4,100 slots
    for dt, tol in ((torch.float32, 2e-4), (bf, 2e-2)):
        worst, n = attn_sweep(torch, FA, g, dev, dt, tol)
        log(f"[kernels] flash_attention {str(dt)[6:]} sweep ({n} cases: "
            f"window, softcap, causal=False, Lq != Lk, hd 32/64/128, G "
            f"1-16, rows with no live key, decode caches of 1, 63, 536 "
            f"and 4,100 slots): max err {worst:.3g} (tol {tol})")

    # -- mamba2-1.3b prefill scan: B=16, L=512, 64 heads of 64, N=128;
    # f32 operands with an h0 (the row kept from earlier runs) and the
    # served call: bf16 x / B / C as strided views of the conv output
    # (B, L, H*P + 2N), dt f32, no h0
    Bb, L, H, P, N, ch = (2, 64, 16, 32, 16, 16) if small else \
        (16, 512, 64, 64, 128, 256)
    x = rn(Bb, L, H, P)
    dt = torch.rand(Bb, L, H, generator=g, device=dev) * 0.5
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, Cm, h0 = rn(Bb, L, N), rn(Bb, L, N), rn(Bb, H, P, N)
    xbc = rn(Bb, L, H * P + 2 * N, dt=bf)
    served = (xbc[..., :H * P].unflatten(-1, (H, P)), dt, A,
              xbc[..., H * P:H * P + N], xbc[..., H * P + N:], None)
    f32_args = (x, dt, A, Bm, Cm, h0)
    err_s = 0.0
    rows = {}
    for what, a_ in (("f32 with h0", f32_args), ("bf16 views", served)):
        y, hf = SS.ssd_scan(*a_, chunk=ch)
        y2, hf2 = SS.ssd_scan_plain(*a_, chunk=ch)
        for a, b_, nm in ((y, y2, "y"), (hf, hf2, "h_final")):
            e = float((a - b_).abs().max())
            tol = 1e-4 * max(1.0, float(b_.abs().max()))
            check(e <= tol, f"ssd_scan {what} {nm}: max |err| {e} > {tol}")
            err_s = max(err_s, e)
        y3, hf3 = SS.ssd_scan(*a_, chunk=ch)
        check(torch.equal(y, y3) and torch.equal(hf, hf3),
              f"ssd_scan {what}: two launches differ")
        f32 = a_[0].dtype == torch.float32
        esz = 4 if f32 else 2
        nb = (esz * (Bb * L * H * P + 2 * Bb * L * N) + 4 * Bb * L * H
              + 4 * H + 4 * Bb * L * H * P + 4 * Bb * H * P * N
              * (2 if a_[5] is not None else 1))
        ops = ssd_ops(Bb, L, H, P, N, ch, f32, a_[5] is not None)
        bms_, by_ = bound_ms(nb, ops, PEAK_BF16_S)
        rows[what] = dict(
            max_abs_err=err_s,
            ms=time_graph_ms(torch, lambda: SS.ssd_scan(*a_, chunk=ch), dev),
            plain_ms=time_ms(torch, lambda: SS.ssd_scan_plain(
                *a_, chunk=ch), dev),
            bound_ms=bms_, bound_by=by_, library_ms=None)
        parts = kernel_times(torch, dev, lambda: SS.ssd_scan(*a_, chunk=ch))
        log(f"[kernels] ssd_scan B={Bb} L={L} H={H} P={P} N={N} chunk={ch} "
            f"{what}: {rows[what]['ms']:.4f} ms (plain "
            f"{rows[what]['plain_ms']:.4f}), bound {bms_:.4f} by {by_} "
            f"({nb / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP on the tensor "
            f"cores); max |y| {float(y2.abs().max()):.3g}, "
            f"max err {err_s:.3g} (tol 1e-4 of max |y|); launches: "
            f"{fmt_times(parts)}")
    results["ssd_scan"] = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:75", **rows["bf16 views"])
    results["ssd_scan"]["max_abs_err"] = err_s
    log("[kernels] ssd_scan: no single PyTorch call computes the scan, so "
        "no library time")
    # small f32 sweep: odd L, several chunks, narrow P and N; P and N
    # beyond one 64 x 128 tile; Bb x chunks above 65,535 (no grid axis
    # of the scan is limited to that)
    worst = 0.0
    for b_, l_, h_, p_, n_, c_ in ((1, 32, 2, 16, 8, 16),
                                   (2, 75, 3, 32, 16, 16),
                                   (1, 128, 4, 64, 128, 64),
                                   (2, 17, 1, 8, 4, 8),
                                   (2, 300, 2, 128, 256, 128),
                                   (1, 70, 1, 72, 136, 32),
                                   (2100, 32, 1, 8, 8, 1)):
        args = (rn(b_, l_, h_, p_),
                torch.rand(b_, l_, h_, generator=g, device=dev) * 0.5,
                -torch.exp(rn(h_)), rn(b_, l_, n_), rn(b_, l_, n_),
                rn(b_, h_, p_, n_))
        for a, b2 in zip(SS.ssd_scan(*args, chunk=c_),
                         SS.ssd_scan_plain(*args, chunk=c_)):
            e = float((a - b2).abs().max())
            tol = 1e-4 * max(1.0, float(b2.abs().max()))
            check(e <= tol, f"ssd_scan {(b_, l_, h_, p_, n_, c_)}: max |err| "
                            f"{e} > {tol}")
            worst = max(worst, e / tol)
    log(f"[kernels] ssd_scan f32 sweep (7 shapes, ragged L, P 8-128, N "
        f"4-256, Bb x chunks 67,200): worst error {worst:.3g} of its "
        f"tolerance")
    # the model's form: bf16 x / B / C as strided views of one
    # projection, a ragged L, chaining through h0
    xbc = rn(Bb, L - 7, H * P + 2 * N, dt=bf)
    xs = xbc[..., :H * P].unflatten(-1, (H, P))
    bs, cs = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dts = dt[:, :L - 7].contiguous()
    half = (L - 7) // 2
    ya, ha = SS.ssd_scan(xs[:, :half], dts[:, :half], A, bs[:, :half],
                         cs[:, :half], None, chunk=ch)
    yb, hb = SS.ssd_scan(xs[:, half:], dts[:, half:], A, bs[:, half:],
                         cs[:, half:], ha, chunk=ch)
    yw, hw = SS.ssd_scan_plain(xs, dts, A, bs, cs, None, chunk=ch)
    e2 = max(float((torch.cat([ya, yb], 1) - yw).abs().max()),
             float((hb - hw).abs().max()))
    tol2 = 1e-4 * max(1.0, float(yw.abs().max()), float(hw.abs().max()))
    check(e2 <= tol2, f"ssd_scan strided bf16 chained: max |err| {e2} > "
                      f"{tol2}")
    log(f"[kernels] ssd_scan bf16 strided views, L={L - 7} in two chained "
        f"halves: max err {e2:.3g} (tol {tol2:.3g})")
    for key in ("flash_attention", "ssd_scan"):
        r = results[key]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[kernels] {key}: ok, max err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {lib}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return results


GEN_ROW_ARCHS = ["qwen2-1.5b"]   # GEN_ARCHS with rows of their own


def gen_kernel_rows(torch, dev, small: bool):
    """qwen2-1.5b's flash_attention shapes as ``generate`` serves them
    (B=16, prompt 512, 16 new tokens): the prefill (hd 128, G 6, causal,
    ``prefill_wgmma_kernel<128>``) and the decode over 536 slots at live
    513-528 (``decode_mma_kernel<128>`` + combine), each against its
    plain version and timed beside SDPA (``window_attn_row``).  Returns
    rows keyed ("generate", kind); ``generation_phase`` gives them their
    launches."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator(device=dev).manual_seed(43)
    B, L, max_new = (2, 64, 4) if small else (16, 512, 16)
    rows = {}
    for name in GEN_ROW_ARCHS:
        cfg = get_smoke(name) if small else get_config(name)
        for kind, Lq, Lk, kv, kw in windowed_shapes(cfg, B, L, max_new):
            rows[("generate", kind)] = window_attn_row(
                torch, FA, g, dev, cfg, B, Lq, Lk, kv, kw,
                f"{kind} ({name}, B={B}, Lq={Lq}, Lk={Lk})", iters=20,
                tag="kernels")
    return rows


def gate_compare(torch, got, want, logits, what: str):
    """The kernel's gate (vals, idx, aux) against the plain version's on
    the same logits.  Expert indices equal in rows 0 and 1 (``gate_logits``
    plants exact ties there, bit-equal in both softmaxes, so the order
    toward the lower index is checked); elsewhere a position may differ
    only where the plain version's probabilities of the two experts
    there are within 1e-6, which the kernel's own softmax may order
    either way.  vals within 1e-6; aux within 1e-6 relative.  Returns
    (max vals error, rows accepted at a near-tie)."""
    gv, gi, ga = got
    wv, wi, wa = want
    check(gi.dtype == torch.int32 and gv.dtype == torch.float32
          and gi.shape == wi.shape and gv.shape == wv.shape,
          f"{what}: outputs {gv.dtype} {tuple(gv.shape)} / {gi.dtype}")
    gi, wi = gi.cpu().long(), wi.cpu().long()
    diff = gi != wi
    check(not bool(diff[:2].any()),
          f"{what}: experts differ in a row of exact ties")
    n_tie = int(diff.any(dim=1).sum())
    if n_tie:
        p = torch.softmax(logits.float().cpu(), dim=-1)
        gap = (p.gather(1, gi) - p.gather(1, wi)).abs()
        check(bool((gap[diff] < 1e-6).all()),
              f"{what}: experts differ at a position without a near-tie")
    err = float((gv - wv).abs().max())
    check(err <= 1e-6, f"{what}: max |vals err| {err} > 1e-6")
    aerr = abs(float(ga) - float(wa))
    check(aerr <= 1e-6 * abs(float(wa)),
          f"{what}: aux {float(ga)} vs {float(wa)}")
    return err, n_tie


def gate_logits(torch, g, dev, T: int, E: int, d: int, dt):
    """Router logits as ``moe_block`` forms them: (T, d) activations
    times a (d, E) router of scale 0.02, in ``dt``; rows 0 and 1 hold
    exact ties (every expert equal; each value twice)."""
    x = torch.randn(T, d, generator=g, device=dev).to(dt)
    router = (torch.randn(d, E, generator=g, device=dev) * 0.02).to(dt)
    lg = x @ router
    lg[0] = 0
    if T > 1:
        lg[1, E // 2:] = lg[1, :E - E // 2]
    return lg


def moe_kernel_phase(torch, dev, small: bool):
    """The MoE gate at the launch shapes of qwen3-moe-30b-a3b (prefill
    T = 16 x 512, decode T = 16; E = 128, k = 8, bf16 logits from the
    full-width router), a sweep over E, k, T and f32, and flash
    attention at that model's GQA group of 8 (32 query heads over 4 KV
    heads), which the llama shapes above do not reach."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gating as MG

    g = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    d, E, K = (256, 128, 8) if small else (2048, 128, 8)
    results = {}
    shapes = {}
    for tag, T in (("prefill", 128 if small else 16 * 512),
                   ("decode", 16)):
        lg = gate_logits(torch, g, dev, T, E, d, bf)
        got = MG.moe_gating(lg, K)
        again = MG.moe_gating(lg, K)
        want = MG.moe_gating_plain(lg, K)
        err, ties = gate_compare(torch, got, want, lg, f"moe_gating {tag}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"moe_gating {tag}: two launches gave different bits")
        check(torch.equal(got[1][0].cpu(),
                          torch.arange(K, dtype=torch.int32)),
              f"moe_gating {tag}: an all-tied row must take experts 0..k-1")
        # the function's bytes: logits read once, vals + idx + aux out;
        # operations: max, exp, sum, divide and k compare passes per
        # (token, expert)
        bms, by = bound_ms(T * E * 2 + T * K * 8 + 4, T * E * (4.0 + K),
                           PEAK_FP32_S)
        shapes[tag] = dict(
            T=T, err=err, ties=ties, bound_ms=bms, bound_by=by,
            ms=time_graph_ms(torch, lambda: MG.moe_gating(lg, K), dev),
            plain_ms=time_ms(torch, lambda: MG.moe_gating_plain(lg, K), dev),
            library_ms=time_graph_ms(torch, lambda: torch.topk(
                torch.softmax(lg.float(), dim=-1), K), dev),
            profiled=one_launch(torch, dev, lambda: MG.moe_gating(lg, K),
                                ("gate_kernel",), f"moe_gating {tag}"))
        r = shapes[tag]
        log(f"[kernels] moe_gating {tag} T={T} E={E} k={K} bf16 (plan: "
            f"{MG.gate_plan(T, E, K)} warps, blocks): {r['ms']:.4f} ms "
            f"(profiler: {r['profiled']}; plain {r['plain_ms']:.4f}, "
            f"softmax+topk {r['library_ms']:.4f}, kernel / library "
            f"{r['ms'] / r['library_ms']:.2f}, bound {bms:.5f} by {by}), "
            f"max err {err:.3g}, {ties} rows at a near-tie")
    one = torch.zeros(1, device=dev)
    floor_ms = time_graph_ms(torch, lambda: one.add_(1.0), dev)
    log(f"[kernels] the launch floor: a one-element PyTorch kernel replayed "
        f"the same way takes {floor_ms:.4f} ms")
    # sweep: small and odd E, k = 1, ragged T, f32 and bf16, tied rows
    worst = 0.0
    for T, E_, k_, dt in ((1000, 4, 2, torch.float32),
                          (77, 60, 4, torch.float32),
                          (300, 128, 1, bf),
                          (65, 128, 8, torch.float32),
                          (3, 1024, 16, torch.float32),
                          (1, 128, 8, bf),
                          (40_000, 128, 8, bf),
                          (200, 1024, 1024, torch.float32)):
        lg = gate_logits(torch, g, dev, T, E_, 64, dt)
        got = MG.moe_gating(lg, k_)
        again = MG.moe_gating(lg, k_)
        err, _ = gate_compare(torch, got, MG.moe_gating_plain(lg, k_), lg,
                              f"moe_gating T={T} E={E_} k={k_} {dt}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"moe_gating T={T} E={E_}: two launches gave different bits")
        worst = max(worst, err)
    log(f"[kernels] moe_gating sweep (E 4/60/128/1024, k 1-1024, T 1 to "
        f"40,000 (a grid-stride plan), f32 and bf16, tied rows): max err "
        f"{worst:.3g} (tol 1e-6)")
    pre = shapes["prefill"]
    results["moe_gating"] = dict(
        name="moe_gating", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating.py:58",
        max_abs_err=max(worst, *(v["err"] for v in shapes.values())),
        ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by=pre["bound_by"], library_ms=pre["library_ms"])

    # -- flash attention at GQA group 8 (qwen3-moe-30b-a3b: 32/4 heads)
    B, L, Hq, Hkv, hd = (2, 64, 8, 1, 64) if small else (16, 512, 32, 4, 64)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)
    q = rn(B, L, Hq, hd).transpose(1, 2)
    k = rn(B, L, Hkv, hd).transpose(1, 2)
    v = rn(B, L, Hkv, hd).transpose(1, 2)
    err_p = attn_check(torch, FA, q, k, v, None, 2e-2,
                       "flash_attention prefill, group 8", causal=True)
    bp, byp = bound_ms(2 * (2 * B * L * Hq * hd + 2 * B * L * Hkv * hd),
                       4.0 * B * Hq * hd * (L * (L + 1) / 2), PEAK_BF16_S)
    ms_p = time_graph_ms(torch, lambda: FA.flash_attention(
        q, k, v, causal=True), dev)
    lib_p = time_graph_ms(torch, sdpa_call(
        torch, q.contiguous(), k.contiguous(), v.contiguous(),
        is_causal=True), dev)
    C = 76 if small else 536
    kvv = np.random.default_rng(9).integers(1, C + 1, B)
    kvv[0], kvv[-1] = 1, C
    kv_valid = torch.from_numpy(kvv.astype(np.int32)).to(dev)
    qd = rn(B, 1, Hq, hd).transpose(1, 2)
    kd = rn(B, C, Hkv, hd).transpose(1, 2)
    vd = rn(B, C, Hkv, hd).transpose(1, 2)
    err_d = attn_check(torch, FA, qd, kd, vd, kv_valid, 2e-2,
                       "flash_attention decode, group 8", causal=False)
    live = int(kvv.sum())
    bd, byd = bound_ms(2 * (2 * B * Hq * hd + 2 * live * Hkv * hd),
                       4.0 * Hq * hd * live, PEAK_BF16_S)
    ms_d = time_graph_ms(torch, lambda: FA.flash_attention(
        qd, kd, vd, kv_valid, causal=False), dev)
    mask = (torch.arange(C, device=dev)[None, :] < kv_valid[:, None])
    lib_d = time_graph_ms(torch, sdpa_call(
        torch, qd.contiguous(), kd.contiguous(), vd.contiguous(),
        attn_mask=mask[:, None, None, :]), dev)
    log(f"[kernels] flash_attention group 8 prefill B={B} L={L} {Hq}/{Hkv} "
        f"heads bf16 causal: {ms_p:.4f} ms (library {lib_p:.4f}, kernel / "
        f"SDPA {ms_p / lib_p:.2f}, bound {bp:.4f} by {byp}), max err "
        f"{err_p:.3g}")
    log(f"[kernels] flash_attention group 8 decode B={B} C={C} {Hq}/{Hkv} "
        f"heads, {live} live keys: {ms_d:.4f} ms (library {lib_d:.4f}, "
        f"kernel / SDPA {ms_d / lib_d:.2f}, bound {bd:.4g} by {byd}), max "
        f"err {err_d:.3g}")
    served_decode(torch, FA, g, dev, B, C, Hq, Hkv, hd,
                  "flash_attention served decode, group 8")
    return results


# ----------------------------------------------------------------------
# phase 4c: flash attention and the scan at the windowed models' shapes
# ----------------------------------------------------------------------

WINDOWED_ARCHS = ["hymba-1.5b", "h2o-danube-3-4b", "gemma2-2b"]
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention.py:87"


def flash_kernel(FA, q, k, int8: bool = False) -> str:
    """The CUDA kernel a ``flash_attention`` (``flash_decode_q8`` with
    ``int8``) call on these operands runs, as the wrappers pick it: the
    decode shape's body (``decode_body``, ``q8_body``), else the wgmma
    prefill where TMA reads bf16 operands (``prefill_wide_kernel`` at
    hd 288) and the CUDA-core one otherwise."""
    hd, dt = q.shape[3], "bf16" if q.dtype.is_floating_point and \
        q.element_size() == 2 else "f32"
    cap = 128 if hd == 120 else hd
    if int8:
        return ({"mma": f"decode_mma_kernel<{cap}, true>",
                 "cores": f"decode_q8_kernel<{dt}, {cap}>"}
                if hd != 288 else
                {"mma": "decode_wide_kernel<288, true>",
                 "cores": f"decode_q8_kernel<{dt}, 288>"})[FA.q8_body(q, k)]
    if q.shape[2] == 1:
        return {"mma": f"decode_mma_kernel<{cap}>",
                "wide": "decode_wide_kernel<288>",
                "cores": f"decode_split_kernel<{dt}, {cap}>"}[
                    FA.decode_body(q, k)]
    if dt == "bf16" and hd != 32 and all(FA._tma_ok(t) for t in (q, k)):
        return ("prefill_wide_kernel" if hd == 288 else
                f"prefill_wgmma_kernel<{cap}>")
    return f"prefill_kernel<{dt}, {cap}>"


def decode_on_body(torch, FA, q, k, fn, what: str):
    """Run ``fn()`` (one ``flash_attention`` call of the decode shape on
    the card) and check that it launched once, on the body
    ``decode_body`` names (``decode_launches_by_body``); returns fn's
    result."""
    by = dict(FA.flash_attention.decode_launches_by_body)
    body = FA.decode_body(q, k)
    out = fn()
    if q.device.type == "cuda":
        now = FA.flash_attention.decode_launches_by_body
        check(now[body] == by[body] + 1 and
              sum(now.values()) == sum(by.values()) + 1,
              f"{what}: not one launch of the {body} decode body ({now})")
    return out


def flash_kind(hd: int, Lq: int, G: int, window: int, local: int,
               softcap: float, causal: bool = True, Lk: int = 0,
               all_live: bool = False) -> str:
    """The attention a layer asks of ``ops.flash_attention``: head dim,
    GQA group, prefill or decode, and its masks ('hd120 G4 prefill
    window 4096'); a non-causal prefill (an encoder's, or a
    cross-attention's over Lk != Lq keys) and a decode with every key
    live (no ``kv_valid``: the cross decode) say so."""
    kind = f"hd{hd} G{G} {'prefill' if Lq > 1 else 'decode'}"
    if window:
        kind += f" window {window}"
    if local:
        kind += f" local {local}"
    if softcap:
        kind += f" softcap {softcap:g}"
    if Lq > 1 and not causal:
        kind += " non-causal" + (f" Lk {Lk}" if Lk != Lq else "")
    if Lq == 1 and all_live:
        kind += " all keys live"
    return kind


class FlashRecorder:
    """Within the ``with``: every ``ops.flash_attention`` call of a run
    (prefill, and decode through ``ops.flash_decode``), counted by its
    ``flash_kind``, with the cache capacity each decode kind read (and,
    with ``keep_kv``, each decode's live counts)."""

    def __init__(self, keep_kv: bool = False):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, ops.flash_attention
        self.counts, self.caps = {}, {}
        self.keep_kv, self.kv = keep_kv, []

    def __enter__(self):
        def record(q, k, v, kv_valid=None, **kw):
            kind = flash_kind(q.shape[-1], q.shape[1], q.shape[2] // k.shape[2],
                              kw.get("window", 0), kw.get("local_window", 0),
                              kw.get("softcap", 0.0), kw.get("causal", True),
                              k.shape[1], kv_valid is None)
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.caps[kind] = k.shape[1]
            if self.keep_kv and kv_valid is not None:
                self.kv.append(kv_valid.clone())     # stays on the device
            return self.orig(q, k, v, kv_valid, **kw)
        self.ops.flash_attention = record
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.orig


def windowed_shapes(cfg, B: int, L: int, max_new: int):
    """The flash_attention calls one generation of ``cfg`` makes at batch
    B, prompt L: each layer kind's prefill, and its decode at the
    cache of ``M.cache_len`` slots, the live counts those of step 1
    (ragged per row, as rows of one batch would sit).  Yields (kind,
    Lq, Lk, kv_valid list or None, kwargs)."""
    from repro_torch.models import model as M

    cap = L + max_new + 8
    C = M.cache_len(cfg, cap)
    G = cfg.n_heads // cfg.n_kv_heads
    ring = bool(cfg.sliding_window) and not cfg.local_global_pattern
    pos1 = [L + 1 + (i * 5) % 16 for i in range(B)]    # pos + 1, ragged
    for kind in sorted(set(M.layer_kinds(cfg))):
        W = cfg.sliding_window if kind == 0 else 0
        cap_ = cfg.attn_softcap
        yield (flash_kind(cfg.head_dim, L, G, W, 0, cap_), L, L, None,
               dict(causal=True, window=W, softcap=cap_))
        local = W if cfg.local_global_pattern else 0
        kv = [min(p, C) for p in pos1] if ring else pos1
        yield (flash_kind(cfg.head_dim, 1, G, 0, local, cap_), 1, C, kv,
               dict(causal=False, local_window=local, softcap=cap_))


def plain_in_pieces(torch, FA, q, k, v, kvt, **kw):
    """``flash_attention_plain`` over slices of the batch, each holding at
    most 2**31 f32 scores (a sequence's rows are independent, so this is
    the same function; llava's B=16, L=3,392 prefill would need 24 GB of
    scores at once, and the plain version holds several such tensors)."""
    B, Hq, Lq, _ = q.shape
    n = max(1, min(B, (1 << 31) // max(1, Hq * Lq * k.shape[2])))
    return torch.cat([FA.flash_attention_plain(
        q[i:i + n], k[i:i + n], v[i:i + n],
        None if kvt is None else kvt[i:i + n], **kw)
        for i in range(0, B, n)])


def window_attn_row(torch, FA, g, dev, cfg, B, Lq, Lk, kv, kw, what,
                    iters: int, tag: str = "window kernels"):
    """One bf16 flash_attention shape of a served model in the layer
    layout, named by the CUDA kernel it runs (``flash_kernel``; a decode
    checked on its body): the kernel against its plain version (|err|
    <= 2e-2 (1 + |want|), and at most one bf16 ulp of max |want|; the
    plain version over slices of the batch, ``plain_in_pieces``) and two
    launches bit-equal, then the kernel's
    device time, the plain version's, SDPA's with the same mask where
    SDPA computes the same function (no softcap), and the bound: q, o
    and the K/V rows some query sees, once each; 4 hd operations per
    (query head, live key) pair at the bf16 tensor-core rate."""
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    q = rn(B, Lq, Hq, hd).transpose(1, 2)
    k = rn(B, Lk, Hkv, hd).transpose(1, 2)
    v = rn(B, Lk, Hkv, hd).transpose(1, 2)
    kvt = None if kv is None else torch.tensor(kv, dtype=torch.int32,
                                               device=dev)
    kernel = flash_kernel(FA, q, k)
    what = f"{kernel} {what}"
    if Lq == 1:
        got = decode_on_body(torch, FA, q, k, lambda: FA.flash_attention(
            q, k, v, kvt, **kw), what)
        check(hd != 288 or kernel == "decode_wide_kernel<288>",
              f"{what}: gemma2-2b's bf16 decode off the wide body")
    else:
        got = FA.flash_attention(q, k, v, kvt, **kw)
    want = plain_in_pieces(torch, FA, q, k, v, kvt, **kw)
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs()
    over = float((diff - 2e-2 * (1 + want.float().abs())).max())
    check(over <= 0, f"{what}: |err| exceeds 2e-2 * (1 + |want|) by {over}")
    err = float(diff.max())
    top = float(want.abs().max())
    check(torch.equal(got, FA.flash_attention(q, k, v, kvt, **kw)),
          f"{what}: two launches differ")
    del got, want, diff
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    check(err <= ulp, f"{what}: max err {err} above one bf16 ulp ({ulp}) "
                      f"of max |want| {top:.3g}")
    # (B, Lq, Lk): the mask has a batch axis of 1 where it is the same
    # for every sequence, and every sequence's pairs and keys count
    live = FA._live_mask(B, Lq, Lk, kvt, kw["causal"], kw.get("window", 0),
                         dev, kw.get("local_window", 0))[:, 0, 0].expand(
                             B, Lq, Lk)
    pairs = float(live.sum())
    keys = float(live.any(dim=1).sum())
    bms, by = bound_ms(2 * (2 * B * Lq * Hq * hd + 2 * keys * Hkv * hd),
                       4.0 * Hq * hd * pairs, PEAK_BF16_S)
    row = dict(
        name=f"flash_attention {what}", route="cuda", source=FLASH_SRC,
        replaces=FLASH_TPU, max_abs_err=err, bound_ms=bms, bound_by=by,
        ms=time_graph_ms(torch, lambda: FA.flash_attention(q, k, v, kvt,
                                                           **kw), dev,
                         iters=iters),
        plain_ms=time_ms(torch, lambda: plain_in_pieces(
            torch, FA, q, k, v, kvt, **kw), dev, iters=max(2, iters // 4),
            warmup=1),
        library_ms=None)
    if not kw.get("softcap"):
        # no mask where every key is live for every query, is_causal
        # where the causal mask is all and no window bites
        bites = kw.get("window", 0) in range(1, Lk)
        mask = (dict() if not kw["causal"] and kv is None else
                dict(is_causal=True) if Lq == Lk and kv is None and not bites
                else dict(attn_mask=live[:, None]))
        lib = sdpa_call(torch, q.contiguous(), k.contiguous(),
                        v.contiguous(), **mask)
        row["library_ms"] = time_graph_ms(torch, lib, dev, iters=iters)
    times = kernel_times(torch, dev, lambda: FA.flash_attention(
        q, k, v, kvt, **kw), iters=3)
    if Lq == 1 and times:       # one split on the mma body: no combine
        body = FA.decode_body(q, k)
        n_split = (FA.wide_splits if body == "wide" else
                   FA.decode_splits)(B, Hkv, Lk)[0]
        one = FA.one_launch(n_split, False, body, hd)
        check(one == (not any(n.startswith("decode_combine_kernel")
                              for n in times)),
              f"{what}: launches {list(times)}, one launch {one}")
    kernels = fmt_times(times)
    lib = ("none: SDPA has no softcap" if row["library_ms"] is None else
           f"{row['library_ms']:.4f} (kernel / SDPA "
           f"{row['ms'] / row['library_ms']:.2f})")
    log(f"[{tag}] {what}: {Hq}/{Hkv} heads of {hd}, {kw}, "
        f"{int(pairs)} live (row, key) pairs: {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f}, SDPA {lib}, bound {bms:.4f} by {by} "
        f"({row['ms'] / bms:.1f}x); max err {err:.3g} (one bf16 ulp of max "
        f"|want| {top:.3g}: {ulp:.3g}); launches: {kernels}")
    return row


def window_kernel_phase(torch, dev, small: bool):
    """flash_attention at the new served shapes of hymba-1.5b (hd 64, G
    5, window 1,024, a ring), h2o-danube-3-4b (hd 120, G 4, window
    4,096, a ring) and gemma2-2b (hd 288, G 2, softcap 50, local layers
    with window 4,096 and global ones, a full cache) -- prefill and
    decode at B = 16, prompt 512 (routed generation) and at B = 4,
    prompt 4,608 (long context: every window bites, the rings wrap) --
    and hymba's scan (H = 50, P = 64, N = 16, chunk 256, bf16 views) at
    both; then f32 and bf16 sweeps at hd 120 and 288 (causal, window,
    softcap, kv_valid, the windowed decode at ragged live counts with
    chunks wholly below the window).  Returns rows keyed (phase, kind)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS

    g = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    phases = ((("routed", 2, 64, 4), ("long", 2, 150, 4)) if small else
              (("routed", 16, 512, 16), ("long", 4, 4608, 16)))
    for phase, B, L, max_new in phases:
        for name in WINDOWED_ARCHS:
            cfg = get_smoke(name) if small else get_config(name)
            for kind, Lq, Lk, kv, kw in windowed_shapes(cfg, B, L, max_new):
                rows[(phase, kind)] = window_attn_row(
                    torch, FA, g, dev, cfg, B, Lq, Lk, kv, kw,
                    f"{kind} ({name}, B={B}, L={L}, Lk={Lk})",
                    iters=20 if phase == "routed" else 4)
            if not cfg.has_ssm:
                continue
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            ch = cfg.ssm_chunk
            xbc = torch.randn(B, L, H * P + 2 * N, generator=g,
                              device=dev).to(torch.bfloat16)
            args = (xbc[..., :H * P].unflatten(-1, (H, P)),
                    torch.rand(B, L, H, generator=g, device=dev) * 0.5,
                    -torch.linspace(1.0, 16.0, H, device=dev),
                    xbc[..., H * P:H * P + N], xbc[..., H * P + N:], None)
            y, hf = SS.ssd_scan(*args, chunk=ch)
            y2, hf2 = SS.ssd_scan_plain(*args, chunk=ch)
            err = 0.0
            for a, b_, nm in ((y, y2, "y"), (hf, hf2, "h_final")):
                e = float((a - b_).abs().max())
                tol = 1e-4 * max(1.0, float(b_.abs().max()))
                check(e <= tol, f"ssd_scan {name} {phase} {nm}: max |err| "
                                f"{e} > {tol}")
                err = max(err, e)
            y3, hf3 = SS.ssd_scan(*args, chunk=ch)
            check(torch.equal(y, y3) and torch.equal(hf, hf3),
                  f"ssd_scan {name} {phase}: two launches differ")
            nb = (2 * (B * L * H * P + 2 * B * L * N) + 4 * B * L * H
                  + 4 * H + 4 * B * L * H * P + 4 * B * H * P * N)
            bms, by = bound_ms(nb, ssd_ops(B, L, H, P, N, ch, False, False),
                               PEAK_BF16_S)
            what = f"H{H} P{P} N{N} chunk {ch} ({name}, B={B}, L={L})"
            it = 20 if phase == "routed" else 4
            rows[(phase, "ssd_scan")] = r = dict(
                name=f"ssd_scan {what}", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:75",
                max_abs_err=err, bound_ms=bms, bound_by=by, library_ms=None,
                ms=time_graph_ms(torch, lambda: SS.ssd_scan(
                    *args, chunk=ch), dev, iters=it),
                plain_ms=time_ms(torch, lambda: SS.ssd_scan_plain(
                    *args, chunk=ch), dev, iters=max(2, it // 4), warmup=1))
            parts = kernel_times(torch, dev, lambda: SS.ssd_scan(
                *args, chunk=ch), iters=3)
            log(f"[window kernels] ssd_scan {what}, bf16 strided views: "
                f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}), bound "
                f"{bms:.4f} by {by} ({r['ms'] / bms:.1f}x); max |y| "
                f"{float(y2.abs().max()):.3g}, max err {err:.3g} (tol 1e-4 "
                f"of max |y|); no single PyTorch call computes the scan; "
                f"launches: {fmt_times(parts)}")
    # sweeps at the new head dims, f32 (tol 1e-5) and bf16 (2e-2):
    # ragged shapes, windows, softcap, kv_valid with an empty row, G 1-5,
    # and the windowed decode over 4,100 slots with live counts whose
    # window leaves chunks wholly below it
    cases = []
    for hd in (120, 288):
        cases += [((2, 200, 200, 8, 2, hd), None, dict(causal=True)),
                  ((2, 130, 130, 4, 4, hd), [0, 77],
                   dict(causal=True, window=37, softcap=50.0)),
                  ((2, 70, 130, 10, 2, hd), None,
                   dict(causal=True, softcap=30.0)),
                  ((3, 1, 300, 8, 2, hd), [0, 150, 300], dict(causal=False)),
                  ((5, 1, 4100, 10, 2, hd), [1, 299, 300, 2000, 4100],
                   dict(causal=False, local_window=300)),
                  ((5, 1, 4100, 8, 4, hd), [40, 1000, 3000, 4099, 4100],
                   dict(causal=False, local_window=1024, softcap=50.0))]
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for (b_, lq, lk, hq, hk, d), kvl, kw in cases:
            def rn(*shape):
                return torch.randn(*shape, generator=g, device=dev).to(dt)
            kvt = None if kvl is None else torch.tensor(
                kvl, dtype=torch.int32, device=dev)
            q = rn(b_, lq, hq, d).transpose(1, 2)
            k = rn(b_, lk, hk, d).transpose(1, 2)
            v = rn(b_, lk, hk, d).transpose(1, 2)
            what = f"flash_attention {dt} {(b_, lq, lk, hq, hk, d)} {kw}"
            worst = max(worst, attn_check(torch, FA, q, k, v, kvt, tol,
                                          what, **kw))
            if lq == 1:
                a = FA.flash_attention(q, k, v, kvt, **kw)
                check(torch.equal(a, FA.flash_attention(q, k, v, kvt, **kw)),
                      f"{what}: two decode launches differ")
        log(f"[window kernels] flash_attention {str(dt)[6:]} sweep at hd "
            f"120 and 288 ({len(cases)} cases: causal, window, softcap, "
            f"kv_valid with an empty row, G 1-5, the windowed decode over "
            f"4,100 slots, two decode launches bit-equal): max err "
            f"{worst:.3g} (tol {tol} (1 + |want|))")
    return rows


# ----------------------------------------------------------------------
# phase 5: routed generation at full width and depth
# ----------------------------------------------------------------------

GEN_PROFILES = ["accuracy-first", "cost-effective", "balanced",
                "latency-first"]
# latency-first is a near-tie between llama3.2-1b and qwen3-moe-30b-a3b
# (blended scores 1.5 and 1.5), which float noise sends either way; the
# MoE catalog takes cost-effective in its place (margin 0.1), so each
# model serves half the requests on every run
MOE_PROFILES = ["accuracy-first", "cost-effective", "balanced",
                "cost-effective"]


def gen_profiles():
    """Preferences that spread requests over ``GEN_ARCHS``: accuracy-first
    routes to qwen2-1.5b (accuracy 0.68), cost-effective to llama3.2-1b,
    and accuracy and speed weighted alike to mamba2-1.3b, second on both
    (blended score margin 0.25 over the other two: no near-tie), so each
    model serves a third of the requests on every run."""
    from repro_torch.core.preferences import METRICS
    return ["accuracy-first", "cost-effective",
            {m: float(m in ("accuracy", "speed")) for m in METRICS}]


def generation_requests(n: int, max_new: int, seed: int,
                        profiles=GEN_PROFILES, task_types=None):
    """n workload texts (only those of ``task_types``, where given),
    ``profiles`` in turn, and each request's task type in the workload.
    Beside llama3.2-1b, accuracy-first and balanced route to
    qwen3-moe-30b-a3b (accuracy 0.86 against llama's 0.58);
    cost-effective and latency-first go to llama.  Between the two
    frontend models, accuracy-first and
    balanced go to llava-next-mistral-7b (accuracy 0.76 against 0.74),
    cost-effective and latency-first to seamless-m4t-medium (a tenth of
    its active parameters)."""
    from repro_torch.data.workload import make_workload
    from repro_torch.serving.engine import Request

    recs = make_workload(n, seed=seed) if task_types is None else [
        r for r in make_workload(12 * n, seed=seed)
        if r.sig.task_type in task_types][:n]
    return ([Request(text=r.text, prefs=profiles[i % len(profiles)], id=i,
                     max_new=max_new) for i, r in enumerate(recs)],
            {i: r.sig.task_type for i, r in enumerate(recs)})


def routed_generation(torch, dev, small: bool, archs, seed: int, tag: str,
                      profiles=GEN_PROFILES, n_req: int = 32,
                      task_types=None, kv_cache_dtype: str = ""):
    """One catalog of ``archs`` with runners (full width and depth on the
    card; ``SMOKE`` when rehearsing), ``n_req`` routed requests
    (``profiles`` in turn; half as many when rehearsing) through
    ``ServingEngine(prompt_len=512).submit`` with ``max_new=16`` after
    one warm-up submit of the same batch.  Checks every response (no
    failure or shed, ``max_new`` tokens each, at least 8 per model,
    finite prefill logits) and returns the catalog, the per-model
    ``GenerationResult`` of the measured submit, the kernels' launch
    counts on it and its flash_attention calls by ``flash_kind``.
    ``kv_cache_dtype="int8"``: every runner serves its config with an
    int8 KV cache (the same weights), and the launch counts also hold
    the int8 decode's (``flash_decode_q8``) and its calls by kind
    (``Q8Recorder``) join the flash_attention calls."""
    from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
    from repro_torch.core.orchestrator import OptiRoute
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gating as MG
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.serving.catalog import build_catalog
    from repro_torch.serving.engine import ServingEngine

    prompt_len, max_new = (64, 4) if small else (512, 16)
    n_req = n_req // 2 if small else n_req
    t0 = time.perf_counter()
    mres = build_catalog(archs=archs, full_runners=not small,
                         smoke_runners=small, seed=seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        log(f"[{tag}] {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
            f"allocated on the card after the runners were built")
    log(f"[{tag}] runners with seeded weights on {dev} built in "
        f"{time.perf_counter() - t0:.1f} s")
    if kv_cache_dtype:
        import dataclasses

        from repro_torch.serving.runner import ModelRunner
        for name in archs:
            entry = mres.entry(name)
            entry.runner = ModelRunner(
                dataclasses.replace(entry.runner.cfg,
                                    kv_cache_dtype=kv_cache_dtype),
                params=entry.runner.params, device=dev)
        log(f"[{tag}] every runner serves kv_cache_dtype="
            f"{kv_cache_dtype!r} with the same weights")
    results = {}
    for name in archs:
        runner = mres.entry(name).runner
        cfg = runner.cfg
        log(f"[{tag}] {name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_padded}, {cfg.n_params()} "
            f"parameters in {cfg.compute_dtype}")

        def capture(toks, max_new=16, _gen=runner.generate, _n=name, **kw):
            res = _gen(toks, max_new, **kw)
            results[_n] = res
            return res
        runner.generate = capture
    router = OptiRoute(mres, TaskAnalyzer(AnalyzerConfig(), seed=3,
                                          device=dev), device=dev)
    eng = ServingEngine(router, prompt_len=prompt_len)
    reqs, truth = generation_requests(n_req, max_new, seed=5,
                                      profiles=profiles,
                                      task_types=task_types)
    t0 = time.perf_counter()
    eng.submit(reqs)                                 # warm-up pass
    log(f"[{tag}] warm-up submit {time.perf_counter() - t0:.2f} s")
    for f in (FA.flash_attention, SS.ssd_scan, MG.moe_gating,
              FA.flash_decode_q8):
        f.launches = 0
    FA.flash_attention.decode_launches = 0
    for by in (FA.flash_decode_q8.launches_by_body,
               FA.flash_attention.decode_launches_by_body):
        for b in by:
            by[b] = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with FlashRecorder() as rec, Q8Recorder() as rec8:
        out = eng.submit(reqs)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.flash_attention.launches,
                "flash_attention_decode": FA.flash_attention.decode_launches,
                "ssd_scan": SS.ssd_scan.launches,
                "moe_gating": MG.moe_gating.launches}
    if kv_cache_dtype:
        launches["flash_decode_q8"] = FA.flash_decode_q8.launches
        launches.update({f"flash_decode_q8[{b}]": n for b, n in
                         FA.flash_decode_q8.launches_by_body.items()})
        rec.counts.update({"int8 " + k: v for k, v in rec8.counts.items()})
    log(f"[{tag}] launches on the main path: {launches}; flash_attention "
        f"calls by kind: {rec.counts}")
    by_model, analysis = {}, {}
    for r in out:
        check(not r.failed and not r.shed,
              f"request {r.request.id}: {r.admission} {r.error}")
        check(r.tokens is not None and len(r.tokens) == max_new,
              f"request {r.request.id}: tokens {r.tokens}")
        by_model[r.model] = by_model.get(r.model, 0) + 1
        seen = analysis.setdefault(r.model, {})
        prefs = r.request.prefs
        key = (f"{prefs if isinstance(prefs, str) else 'weights'}: "
               f"{truth[r.request.id]} -> {r.sig.task_type}/{r.sig.domain}")
        seen[key] = seen.get(key, 0) + 1
    log(f"[{tag}] {len(out)} requests served per model: {by_model}")
    for name, seen in analysis.items():
        log(f"[{tag}] {name} served (profile: the workload's task type -> "
            f"the analyzer's task type/domain): {seen}")
    for name in archs:
        check(by_model.get(name, 0) >= 8,
              f"{name} served {by_model.get(name, 0)} requests (< 8)")
        res = results[name]
        check(bool(np.isfinite(res.logits_last).all()),
              f"{name}: non-finite prefill logits")
        check(res.tokens.shape == (by_model[name], max_new),
              f"{name}: generated {res.tokens.shape}")
    for name in archs:
        res = results[name]
        B = res.tokens.shape[0]
        step = res.decode_s / max(max_new - 1, 1)
        log(f"[{tag}] {name}: B={B}, prompt {prompt_len}, {max_new} "
            f"new tokens: prefill {res.prefill_s * 1e3:.2f} ms, decode "
            f"{step * 1e3:.3f} ms per step, {B * max_new / res.wall_s:.1f} "
            f"generated tokens/s ({res.wall_s * 1e3:.1f} ms in generate)")
    log(f"[{tag}] submit of {len(out)} requests: {wall:.3f} s")
    if dev.type == "cuda":
        log(f"[{tag}] peak memory allocated during the submit: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return mres, results, launches, prompt_len, max_new, rec.counts


def generation_phase(torch, dev, small: bool, kernels, rows):
    """Routed generation on llama3.2-1b, mamba2-1.3b and qwen2-1.5b at
    full width and depth: 48 requests, 16 per model (``gen_profiles``);
    one flash_attention launch per attention layer per prefill and decode
    step, one ssd_scan per mamba2 layer per prefill.  The
    ``flash_attention`` row (llama3.2-1b's shapes) takes llama's
    launches, qwen2-1.5b's rows (``gen_kernel_rows``) theirs."""
    mres, results, launches, prompt_len, max_new, kinds = routed_generation(
        torch, dev, small, GEN_ARCHS, seed=7, tag="generate",
        profiles=gen_profiles(), n_req=48)
    n_attn = sum(mres.entry(n).runner.cfg.n_layers for n in GEN_ARCHS
                 if mres.entry(n).runner.cfg.has_attention)
    n_mamba = mres.entry("mamba2-1.3b").runner.cfg.n_layers
    want = {"flash_attention": n_attn * max_new,
            "flash_attention_decode": n_attn * (max_new - 1),
            "ssd_scan": n_mamba, "moe_gating": 0}
    check(sum(kinds.values()) == n_attn * max_new,
          f"flash_attention calls {kinds}, want {n_attn * max_new}")
    if dev.type == "cuda":
        check(launches == want, f"launch counts {launches}, want {want} "
                                "(one per layer per prefill and decode step)")
        check_decode_bodies(kinds, want["flash_attention_decode"],
                            "generate")
    for name in GEN_ARCHS:
        decode_profile(torch, dev, mres.entry(name).runner, name,
                       results[name].tokens.shape[0], prompt_len)
    llama = mres.entry("llama3.2-1b").runner.cfg
    G = llama.n_heads // llama.n_kv_heads
    kernels.setdefault("flash_attention", {})["launches"] = sum(
        kinds.get(flash_kind(llama.head_dim, lq, G, 0, 0, 0.0), 0)
        for lq in (prompt_len, 1))
    kernels.setdefault("ssd_scan", {})["launches"] = launches["ssd_scan"]
    record_window_launches(kernels, rows, "generate", kinds)


def release(torch, dev, what: str) -> None:
    """Free what the earlier phases left on the card (runners and
    catalogs reachable only through reference cycles, the routing
    path's cached device constants) and log the free memory before and
    after."""
    import gc

    from repro_torch.kernels import ops

    ops.reset_catalog_cache()
    if dev.type != "cuda":
        gc.collect()
        return
    free0, total = torch.cuda.mem_get_info(dev)
    gc.collect()
    torch.cuda.empty_cache()
    free1, _ = torch.cuda.mem_get_info(dev)
    log(f"[memory] {what}: free {free0 / 1e9:.2f} GB -> {free1 / 1e9:.2f} "
        f"GB of {total / 1e9:.2f} GB ({torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        f" GB still allocated)")


def moe_generation_phase(torch, dev, small: bool, kernels):
    """Routed generation on qwen3-moe-30b-a3b at full width and depth
    (bf16 weights drawn on the card, ~59.5 GB) beside llama3.2-1b: every
    MoE layer gates once per prefill and once per decode step, each
    time through the CUDA ``moe_gating`` kernel."""
    mres, results, launches, prompt_len, max_new, _ = routed_generation(
        torch, dev, small, MOE_GEN_ARCHS, seed=17, tag="generate moe",
        profiles=MOE_PROFILES)
    cfg = mres.entry(MOE_ARCH).runner.cfg
    check(prompt_len % min(cfg.moe_group, prompt_len) == 0,
          "the prompt must be whole MoE groups: one gate per layer")
    n_flash = sum(mres.entry(n).runner.cfg.n_layers for n in MOE_GEN_ARCHS)
    n_llama = mres.entry("llama3.2-1b").runner.cfg.n_layers
    want = {"flash_attention": n_flash * max_new,
            "flash_attention_decode": n_flash * (max_new - 1),
            "ssd_scan": 0, "moe_gating": cfg.n_layers * max_new}
    log(f"[generate moe] flash_attention launches: {n_llama * max_new} for "
        f"llama3.2-1b, {cfg.n_layers * max_new} for {MOE_ARCH} (GQA group "
        f"{cfg.n_heads // cfg.n_kv_heads})")
    if dev.type == "cuda":
        check(launches == want, f"launch counts {launches}, want {want} "
                                "(one per layer per prefill and decode step)")
    decode_profile(torch, dev, mres.entry(MOE_ARCH).runner, MOE_ARCH,
                   results[MOE_ARCH].tokens.shape[0], prompt_len)
    kernels.setdefault("moe_gating", {})["launches"] = launches["moe_gating"]


def windowed_profiles():
    """Preferences that spread requests over the three windowed models.
    Every named profile sends them all to gemma2-2b; users' explicit
    weights do not: accuracy alone picks h2o-danube-3-4b (blended score
    margin 0.33 over gemma2-2b), speed alone hymba-1.5b (0.48), and
    balanced gemma2-2b (1.23) -- no near-tie, so each model serves a
    third of the requests on every run."""
    from repro_torch.core.preferences import METRICS

    def only(metric):
        return {m: float(m == metric) for m in METRICS}
    return [only("accuracy"), only("speed"), "balanced"]


def record_window_launches(kernels: dict, rows: dict, phase: str,
                           kinds: dict) -> None:
    """Each windowed kernel row of ``phase`` takes the launches its kind
    had in that phase's run on the main path; every row's kind must have
    launched."""
    for (ph, kind), row in rows.items():
        if ph != phase or kind == "ssd_scan":
            continue
        check(kinds.get(kind, 0) > 0,
              f"{phase}: flash_attention {kind} never launched ({kinds})")
        kernels[row["name"]] = dict(row, launches=kinds[kind])


def check_decode_bodies(kinds: dict, n_dec: int, what: str) -> None:
    """The bf16 decodes of a run on the bodies ``decode_body`` names:
    gemma2-2b's hd-288 kinds on ``"wide"``, the rest on ``"mma"``, none
    on the CUDA cores (``decode_launches_by_body``, counted since the
    run's reset)."""
    from repro_torch.kernels import flash_attention as FA
    wide = sum(n for k, n in kinds.items()
               if k.startswith("hd288") and " decode" in k)
    want = {"cores": 0, "mma": n_dec - wide, "wide": wide}
    by = dict(FA.flash_attention.decode_launches_by_body)
    check(by == want, f"{what}: decode launches by body {by}, want {want}")


def windowed_generation_phase(torch, dev, small: bool, kernels, rows):
    """Routed generation on hymba-1.5b, h2o-danube-3-4b and gemma2-2b at
    full width and depth (seeded bf16 weights drawn on the card): 48
    requests, 16 per model, prompt 512 (inside every window: no ring
    wraps here), 16 new tokens; one flash_attention launch per attention
    layer per prefill and decode step, one ssd_scan per hymba layer per
    prefill."""
    mres, results, launches, prompt_len, max_new, kinds = routed_generation(
        torch, dev, small, WINDOWED_ARCHS, seed=27, tag="generate windowed",
        profiles=windowed_profiles(), n_req=48)
    cfgs = {n: mres.entry(n).runner.cfg for n in WINDOWED_ARCHS}
    n_attn = sum(c.n_layers for c in cfgs.values())
    n_ssm = sum(c.n_layers for c in cfgs.values() if c.has_ssm)
    want = {"flash_attention": n_attn * max_new,
            "flash_attention_decode": n_attn * (max_new - 1),
            "ssd_scan": n_ssm, "moe_gating": 0}
    check(sum(kinds.values()) == n_attn * max_new,
          f"flash_attention calls {kinds}, want {n_attn * max_new}")
    if dev.type == "cuda":
        check(launches == want, f"launch counts {launches}, want {want} "
                                "(one per layer per prefill and decode step)")
        check_decode_bodies(kinds, want["flash_attention_decode"],
                            "generate windowed")
    record_window_launches(kernels, rows, "routed", kinds)
    kernels[rows[("routed", "ssd_scan")]["name"]] = dict(
        rows[("routed", "ssd_scan")], launches=launches["ssd_scan"])
    for name in WINDOWED_ARCHS:
        decode_profile(torch, dev, mres.entry(name).runner, name,
                       results[name].tokens.shape[0], prompt_len)


def long_context_phase(torch, dev, small: bool, kernels, rows):
    """Each windowed model alone at full width and half its depth (for
    the script's time limit) through
    ``ModelRunner.generate``: B = 4, a prompt of 4,608 tokens (past every
    window: hymba's ring of 1,024 and h2o-danube's of 4,096 wrap,
    gemma2's local layers mask inside its full cache), 16 new tokens.
    Finite logits, 16 tokens a row, and exact launch counts."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import model as M
    from repro_torch.serving.runner import ModelRunner

    import dataclasses

    B, Lp, max_new = (2, 150, 4) if small else (4, 4608, 16)
    total = {}
    for i, name in enumerate(WINDOWED_ARCHS):
        cfg = get_smoke(name) if small else get_config(name)
        cfg = dataclasses.replace(cfg, n_layers=max(2, cfg.n_layers // 2))
        t0 = time.perf_counter()
        runner = ModelRunner(cfg, seed=31 + i, device=dev)
        toks = np.random.default_rng(32 + i).integers(
            0, cfg.vocab_size, (B, Lp)).astype(np.int32)
        runner.generate(toks[:, :64], 2)                     # warm-up
        log(f"[long context] {name}: runner built and warmed in "
            f"{time.perf_counter() - t0:.1f} s")
        for f in (FA.flash_attention, SS.ssd_scan):
            f.launches = 0
        FA.flash_attention.decode_launches = 0
        by = FA.flash_attention.decode_launches_by_body
        by.update(dict.fromkeys(by, 0))
        with FlashRecorder() as rec:
            res = runner.generate(toks, max_new)
        got = {"flash_attention": FA.flash_attention.launches,
               "flash_attention_decode": FA.flash_attention.decode_launches,
               "ssd_scan": SS.ssd_scan.launches}
        want = {"flash_attention": cfg.n_layers * max_new,
                "flash_attention_decode": cfg.n_layers * (max_new - 1),
                "ssd_scan": cfg.n_layers if cfg.has_ssm else 0}
        if dev.type == "cuda":
            check(got == want, f"{name}: launch counts {got}, want {want}")
            check_decode_bodies(rec.counts, want["flash_attention_decode"],
                                f"long context {name}")
        check(sum(rec.counts.values()) == cfg.n_layers * max_new,
              f"{name}: flash_attention calls {rec.counts}")
        check(bool(np.isfinite(res.logits_last).all()),
              f"{name}: non-finite prefill logits")
        check(res.tokens.shape == (B, max_new), f"{name}: {res.tokens.shape}")
        C = M.cache_len(cfg, Lp + max_new + 8)
        ring = bool(cfg.sliding_window) and not cfg.local_global_pattern
        decode_caps = {k: c for k, c in rec.caps.items() if "decode" in k}
        check(all(c == C for c in decode_caps.values()),
              f"{name}: decode caches {decode_caps}, want {C} slots")
        check(not ring or C == cfg.sliding_window < Lp,
              f"{name}: the ring of {C} slots must wrap at prompt {Lp}")
        step = res.decode_s / max(max_new - 1, 1)
        log(f"[long context] {name}: B={B}, prompt {Lp}, {max_new} new "
            f"tokens, window {cfg.sliding_window} ("
            + (f"a ring of {C} slots, wrapped {Lp // C} times, roll shift "
               f"{Lp % C}" if ring else f"local/global in a cache of {C}")
            + f"): prefill {res.prefill_s * 1e3:.2f} ms, decode "
            f"{step * 1e3:.3f} ms per step; launches {got}; flash_attention "
            f"calls by kind {rec.counts}")
        decode_profile(torch, dev, runner, name, B, Lp)
        for kind, n in rec.counts.items():
            total[kind] = total.get(kind, 0) + n
        if cfg.has_ssm:
            kernels[rows[("long", "ssd_scan")]["name"]] = dict(
                rows[("long", "ssd_scan")], launches=got["ssd_scan"])
        del runner, res
        release(torch, dev, f"after the long-context run of {name}")
    record_window_launches(kernels, rows, "long", total)


# ----------------------------------------------------------------------
# long_mode: gemma2-2b's rings on every layer, and the long_500k decode
# ----------------------------------------------------------------------

LONG_MODE_ARCH = "gemma2-2b"
LONG_500K_ARCHS = ["gemma2-2b", "llama3.2-1b", "mamba2-1.3b"]
LONG_POS = 524_287                     # the last position of long_500k


def greedy_long_mode(torch, dev, cfg, params, toks, steps: int,
                     keep_logits: bool = False) -> dict:
    """``make_prefill_step(cfg, long_mode=True)`` over ``toks`` (B, L),
    then ``steps`` greedy steps of ``make_decode_step(cfg,
    long_mode=True)``.  Host-clock seconds of the prefill and of the
    decode steps (each ending in a synchronize), the greedy tokens (B,
    steps + 1), the prefill's logits and, with ``keep_logits``, every
    step's."""
    from repro_torch.training.steps import make_decode_step, make_prefill_step

    B, Lp = toks.shape
    prefill = make_prefill_step(cfg, long_mode=True, max_len=Lp + steps + 8)
    decode = make_decode_step(cfg, long_mode=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        last, cache, pos = prefill(params, {"tokens": torch.as_tensor(
            toks.astype(np.int64), device=dev)})
        sync()
        t1 = time.perf_counter()
        tok = torch.argmax(last, dim=-1)[:, None]
        out, logits = [tok], [last]
        for _ in range(steps):
            lg, tok, cache = decode(params, cache, {"token": tok, "pos": pos})
            pos = pos + 1
            out.append(tok)
            if keep_logits:
                logits.append(lg)
        sync()
        t2 = time.perf_counter()
    return {"prefill_s": t1 - t0, "decode_s": t2 - t1, "cache": cache,
            "tokens": torch.cat(out, dim=1).cpu().numpy(),
            "logits": torch.stack(logits, dim=1).float().cpu().numpy()}


def tokens_agree(ref, got, what: str, tol: float) -> int:
    """Greedy tokens equal, row by row, until the reference's top two
    logits lie within ``tol`` (a near-tie).  Returns the count compared."""
    compared = 0
    for b in range(ref["tokens"].shape[0]):
        for s_ in range(ref["logits"].shape[1]):
            top2 = np.sort(ref["logits"][b, s_])[-2:]
            if top2[1] - top2[0] < tol:
                break
            check(got["tokens"][b, s_] == ref["tokens"][b, s_],
                  f"{what}: row {b} step {s_} token {got['tokens'][b, s_]} "
                  f"vs {ref['tokens'][b, s_]}")
            compared += 1
    return compared


def long_mode_rows(torch, dev, small: bool):
    """The kernel shapes long_mode adds, each against its plain version
    and timed beside its bound: gemma2-2b's banded prefill on every
    layer (hd 288, window 4,096, softcap 50, B = 4, prompt 4,608), its
    ring decode over a full ring of 4,096 in bf16 and in int8 (B = 4),
    and the long_500k decode at B = 1 of gemma2-2b (ring of 4,096 in
    long_mode) and llama3.2-1b (its long_serving_config ring).  Returns
    rows keyed (run, kind)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import shapes
    from repro_torch.models import model as M

    g = torch.Generator(device=dev).manual_seed(61)
    B, Lp, steps = (2, 150, 4) if small else (4, 4608, 16)
    cfg = get_smoke(LONG_MODE_ARCH) if small else get_config(LONG_MODE_ARCH)
    W, cap, hd = cfg.sliding_window, cfg.attn_softcap, cfg.head_dim
    G = cfg.n_heads // cfg.n_kv_heads
    C = M.cache_len(cfg, Lp + steps + 8, long_mode=True)
    check(C == W < Lp, f"long_mode: ring of {C} slots at prompt {Lp}")
    rows = {}
    kind = flash_kind(hd, Lp, G, W, 0, cap)
    rows[("gen", kind)] = window_attn_row(
        torch, FA, g, dev, cfg, B, Lp, Lp, None,
        dict(causal=True, window=W, softcap=cap),
        f"long_mode {kind} (gemma2-2b, every layer, B={B}, L={Lp})",
        iters=4, tag="long_mode")
    kind = flash_kind(hd, 1, G, 0, 0, cap)
    rows[("gen", kind)] = window_attn_row(
        torch, FA, g, dev, cfg, B, 1, C, [C] * B,
        dict(causal=False, local_window=0, softcap=cap),
        f"long_mode {kind} (gemma2-2b, B={B}, a full ring of {C})",
        iters=10, tag="long_mode")
    kind, row, _ = q8_row(torch, g, dev, "gemma2-2b long_mode", cfg, B, C,
                          np.full(B, C), 0, "long_mode")
    rows[("int8", kind)] = dict(row, name=row["name"].replace(
        "flash_decode_q8", "flash_decode_q8 long_mode", 1))
    for name in LONG_500K_ARCHS:
        spec = shapes.input_specs(get_smoke(name) if small
                                  else get_config(name), "long_500k")
        c = spec["cfg"]
        if not c.has_attention:
            continue
        Ck = spec["cache"]["k"].shape[2]
        kind = flash_kind(c.head_dim, 1, c.n_heads // c.n_kv_heads, 0, 0,
                          c.attn_softcap)
        rows[(name, kind)] = window_attn_row(
            torch, FA, g, dev, c, 1, 1, Ck, [Ck],
            dict(causal=False, local_window=0, softcap=c.attn_softcap),
            f"long_500k {kind} ({name}, B=1, a full ring of {Ck}, pos "
            f"{LONG_POS})", iters=20, tag="long_mode")
    return rows


def long_mode_generation(torch, dev, small: bool):
    """gemma2-2b at full width and depth (seeded bf16 weights drawn on
    the card) through ``make_prefill_step(long_mode=True)`` at B = 4,
    prompt 4,608 (every layer's ring of 4,096 wraps), then 16 steps of
    ``make_decode_step(long_mode=True)``; again with the int8 cache.
    Finite logits, exactly one attention launch per layer per prefill
    and per decode step, every decode on the ring (each row's live count
    = C); prefill ms, ms a step, busy share and peak memory.  Returns
    the flash_attention kinds' and the int8 decode's calls."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.serving.runner import ModelRunner

    B, Lp, steps = (2, 150, 4) if small else (4, 4608, 16)
    cfg = get_smoke(LONG_MODE_ARCH) if small else get_config(LONG_MODE_ARCH)
    nL, C = cfg.n_layers, cfg.sliding_window
    runner = ModelRunner(cfg, seed=61, device=dev)
    toks = np.random.default_rng(62).integers(0, cfg.vocab_size, (B, Lp))
    greedy_long_mode(torch, dev, cfg, runner.params, toks[:, :64], 2)
    counts, runs = {}, {}
    for kv_dt in ("", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv_dt)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        with FlashRecorder(keep_kv=True) as rec, Q8Recorder() as q8:
            res = greedy_long_mode(torch, dev, c, runner.params, toks, steps)
        got = read_launches()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        n_dec = nL * steps
        want = {"flash_attention": nL * (1 if kv_dt else 1 + steps),
                "flash_attention_decode": 0 if kv_dt else n_dec,
                "flash_decode_q8": n_dec if kv_dt else 0}
        if dev.type == "cuda":
            check({k: got[k] for k in want} == want,
                  f"long_mode {kv_dt or 'bf16'}: launches {got}, want "
                  f"{want}")
            if kv_dt:
                check(got["flash_decode_q8[mma]"] == n_dec,
                      f"long_mode int8: decode bodies {got}")
            else:
                check_decode_bodies(rec.counts, n_dec, "long_mode bf16")
        calls = dict(rec.counts)
        for kind, n in q8.counts.items():
            calls["int8 " + kind] = n
        check(sum(calls.values()) == nL * (1 + steps),
              f"long_mode {kv_dt or 'bf16'}: attention calls {calls}")
        check(all("window" in k for k in rec.counts if "prefill" in k),
              f"long_mode: a prefill layer without the band: {rec.counts}")
        check(not any("local" in k for k in calls),
              f"long_mode: a local window inside the ring: {calls}")
        check(all(cap == C for k, cap in rec.caps.items() if "decode" in k),
              f"long_mode: decode caches {rec.caps}, want the ring of {C}")
        live = torch.cat(rec.kv) if rec.kv else None
        check(live is None or bool((live == C).all()),
              f"long_mode: a decode row off the full ring (live counts "
              f"{None if live is None else live.unique().tolist()})")
        check(bool(np.isfinite(res["logits"]).all()),
              f"long_mode {kv_dt or 'bf16'}: non-finite logits")
        for kind, n in calls.items():
            counts[kind] = counts.get(kind, 0) + n
        runs[kv_dt] = res
        log(f"[long_mode] gemma2-2b {kv_dt or 'bf16'} cache, every layer a "
            f"ring of {C} (B={B}, prompt {Lp}, wrapped {Lp // C} times, roll "
            f"shift {Lp % C}): prefill {res['prefill_s'] * 1e3:.2f} ms, "
            f"decode {res['decode_s'] / steps * 1e3:.3f} ms per step over "
            f"{steps} steps; peak memory {peak / 1e9:.2f} GB; launches "
            f"{ {k: got[k] for k in want} }; calls by kind {calls}")
        if kv_dt == "":
            decode_profile(torch, dev, runner, "gemma2-2b long_mode", B, Lp,
                           long_mode=True)
    same = runs[""]["tokens"] == runs["int8"]["tokens"]
    log(f"[long_mode] gemma2-2b: greedy tokens of the int8 cache equal to "
        f"the bf16 cache's: {int(same.sum())} of {same.size} (reported)")
    del runner, runs
    release(torch, dev, "after the long_mode generation")
    return counts


def long_500k_steps(torch, dev, small: bool):
    """One long_500k decode step of gemma2-2b (long_mode), llama3.2-1b
    (its long_serving_config ring of 4,096) and mamba2-1.3b (state
    only) at full width and depth, B = 1, pos 524,287, against a seeded
    full cache: the parameter bytes (f32, the configs' param_dtype) and
    cache bytes allocated equal ``launch/dryrun``'s figures for the pair
    exactly; finite logits; one attention launch per layer.  Returns
    {arch: flash_attention calls by kind}."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch import dryrun, shapes
    from repro_torch.models import model as M
    from repro_torch.training.steps import make_decode_step

    out = {}
    for i, name in enumerate(LONG_500K_ARCHS):
        full = get_smoke(name) if small else get_config(name)
        spec = shapes.input_specs(full, "long_500k")
        cfg, lm = spec["cfg"], spec["long_mode"]
        seq = shapes.SHAPES["long_500k"]["seq_len"]
        want = dryrun.pair_report(name, "long_500k",
                                  device=dev if dev.type == "cuda"
                                  else "meta", trace=False) \
            if not small else None
        gen = torch.Generator(device=dev).manual_seed(71 + i)
        a0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        params = M.init_params(cfg, gen, device=dev)
        a1 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        cache = M.init_cache(cfg, 1, seq, long_mode=lm, device=dev)
        a2 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        pb, cb = dryrun.tree_bytes(params), dryrun.tree_bytes(cache)
        if want is not None:
            check((pb, cb) == (want["bytes"]["params"],
                               want["bytes"]["cache"]),
                  f"long_500k {name}: params {pb} and cache {cb} bytes, the "
                  f"dry run's {want['bytes']}")
        for key, t in cache.items():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                    * (1.0 if key in ("k", "v") else 0.1))
        params = M.cast_params(params, cfg)
        step = make_decode_step(cfg, long_mode=lm)
        tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        pos = torch.full((1,), LONG_POS, dtype=torch.int64, device=dev)
        with torch.no_grad():
            step(params, cache, {"token": tok, "pos": pos - 1})   # warm-up
            reset_launches()
            with FlashRecorder(keep_kv=True) as rec:
                t0 = time.perf_counter()
                logits, nxt, cache = step(params, cache,
                                          {"token": tok, "pos": pos})
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
        got = read_launches()
        n_attn = cfg.n_layers if cfg.has_attention else 0
        check(sum(rec.counts.values()) == n_attn,
              f"long_500k {name}: attention calls {rec.counts}")
        if dev.type == "cuda":
            check(got["flash_attention_decode"] == n_attn,
                  f"long_500k {name}: launches {got}")
            check_decode_bodies(rec.counts, n_attn, f"long_500k {name}")
        C = cache["k"].shape[2] if "k" in cache else 0
        check(not rec.kv or bool((torch.cat(rec.kv) == C).all()),
              f"long_500k {name}: a decode off the full ring of {C}")
        check(bool(torch.isfinite(logits).all()),
              f"long_500k {name}: non-finite logits")
        out[name] = dict(rec.counts)
        dry = "" if want is None else (f", equal to the dry run's (fits "
                                       f"the card: {want['fits']})")
        log(f"[long_mode] long_500k {name} ({'long_mode, ' if lm else ''}"
            f"{f'a ring of {C}' if C else 'state only'}), B=1 at pos "
            f"{LONG_POS}: one step {ms:.3f} ms (host clock, synchronized); "
            f"params {pb / 1e9:.3f} GB f32, cache {cb / 1e6:.3f} MB{dry}; "
            f"allocator {(a1 - a0) / 1e9:.3f} GB + {(a2 - a1) / 1e6:.3f} MB; "
            f"calls {rec.counts}")
        del params, cache, logits
        release(torch, dev, f"after the long_500k step of {name}")
    return out


def long_mode_card_vs_cpu(torch, dev, small: bool):
    """Full width, 2 layers, f32, windows set to 48, the same seeded
    weights on the card and the CPU: gemma2-2b in long_mode at prompt 72
    (prefill logits within 1e-3 of max |logit|, 4 greedy tokens
    tie-aware), then the long_500k step at pos 524,287 of gemma2-2b,
    llama3.2-1b (its long_serving ring, 48 slots) and mamba2-1.3b from
    one seeded cache (logits within 1e-3 of max |logit|).  Logs the
    RoPE inverse frequencies that differ between the devices."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.training.steps import make_decode_step

    cpu = torch.device("cpu")
    for name in LONG_500K_ARCHS:
        base = get_smoke(name) if small else get_config(name)
        cfg = dataclasses.replace(base, n_layers=2, compute_dtype="float32")
        if cfg.long_serving_window:
            cfg = dataclasses.replace(cfg, long_serving_window=48)
        if cfg.sliding_window:
            cfg = dataclasses.replace(cfg, sliding_window=48)
        lm = cfg.long_mode_local_only
        cfg = cfg.long_serving_config()
        params = M.init_params(cfg, torch.Generator().manual_seed(11), cpu)
        on_dev = M.tree_map(lambda t: t.to(dev), params)
        if name == LONG_MODE_ARCH:
            toks = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                                      (4, 72))
            ref = greedy_long_mode(torch, cpu, cfg, params, toks, 4, True)
            got = greedy_long_mode(torch, dev, cfg, on_dev, toks, 4, True)
            scale = float(np.abs(ref["logits"][:, 0]).max())
            err = float(np.abs(got["logits"][:, 0]
                               - ref["logits"][:, 0]).max())
            check(err <= 1e-3 * scale, f"long_mode {name}: prefill logits "
                                       f"off by {err} (max {scale})")
            n = tokens_agree(ref, got, f"long_mode {name}", 1e-3 * scale)
            log(f"[long_mode card vs cpu] {name} long_mode (2 layers, f32, "
                f"window 48: rings of 48 rolled by 24 on both layers), B=4, "
                f"prompt 72: prefill logits max err {err:.3g} (max |logit| "
                f"{scale:.3g}, tol {1e-3 * scale:.3g}); {n} of "
                f"{ref['tokens'].size} greedy tokens compared, all equal")
        cache = M.init_cache(cfg, 1, LONG_POS + 1, long_mode=lm, device=cpu)
        gen = torch.Generator().manual_seed(13)
        for key, t in cache.items():
            t.copy_(torch.randn(t.shape, generator=gen)
                    * (1.0 if key in ("k", "v") else 0.1))
        cache_d = {k: t.to(dev, copy=True) for k, t in cache.items()}
        batch = {"token": torch.tensor([[7]]),
                 "pos": torch.tensor([LONG_POS])}
        step = make_decode_step(cfg, long_mode=lm)
        with torch.no_grad():
            want = step(params, cache, batch)[0].numpy()
            got = step(on_dev, cache_d, {k: v.to(dev) for k, v in
                                         batch.items()})[0].cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        rope = ""
        if cfg.has_attention:
            # the model's frequencies are the host's on every device
            # (``rope_freqs``); the card's own pow, for the record
            hd, th = cfg.head_dim, cfg.rope_theta
            fc = L.rope_freqs(hd, th)
            fd = (1.0 / (th ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=dev) / hd))).cpu()
            ulps = (fc.view(torch.int32) - fd.view(torch.int32)).abs()
            check(torch.equal(L.rope_freqs(hd, th, dev).cpu(), fc),
                  f"long_500k {name}: the card's RoPE frequencies are not "
                  f"the host's")
            rope = (f"; the card's own pow would differ in "
                    f"{int((ulps > 0).sum())} of {ulps.numel()} RoPE "
                    f"inverse frequencies (max {int(ulps.max())} ulp), the "
                    f"model takes the host's")
        log(f"[long_mode card vs cpu] long_500k {name} (2 layers, f32"
            f"{', long_mode' if lm else ''}, cache of "
            f"{cache['k'].shape[2] if 'k' in cache else 0} slots), pos "
            f"{LONG_POS}: logits max err {err:.3g} (max |logit| "
            f"{scale:.3g}, tol {1e-3 * scale:.3g}){rope}")
        check(err <= 1e-3 * scale, f"long_500k {name}: card vs CPU logits "
                                   f"off by {err} (max {scale})")
        del params, on_dev, cache, cache_d


def long_mode_phase(torch, dev, small: bool, kernels):
    """``long_mode`` on the card: the new kernel shapes (rows of the
    ``kernels`` line), gemma2-2b's long_mode generation at full width and
    depth with the bf16 and the int8 cache, the long_500k decode step of
    three configs, and the card against the CPU at 2 layers.  Every row
    takes its launches from this phase's runs."""
    rows = long_mode_rows(torch, dev, small)
    calls = long_mode_generation(torch, dev, small)
    for name, kinds in long_500k_steps(torch, dev, small).items():
        for kind, n in kinds.items():
            calls[(name, kind)] = n
    for (run, kind), row in rows.items():
        key = {"gen": kind, "int8": "int8 " + kind}.get(run, (run, kind))
        check(calls.get(key, 0) > 0,
              f"long_mode: kernel {row['name']} never launched ({calls})")
        kernels[row["name"]] = dict(
            {k: v for k, v in row.items() if k != "bf16_ms"},
            launches=calls[key])
    long_mode_card_vs_cpu(torch, dev, small)


def examples_phase(torch, dev, small: bool):
    """The three torch examples on the card, each through its own
    ``main`` at a small size: quickstart_torch (the 10-config catalog,
    120 analyzer steps, 3 routed queries), serve_routed_torch (8
    requests on five reduced runners) and merge_models_torch (two 40-step
    checkpoints and their soup)."""
    import importlib.util

    dev_args = ["--device", "cpu"] if dev.type != "cuda" else []
    runs = (("quickstart_torch", []),
            ("serve_routed_torch", ["--requests", "8"]),
            ("merge_models_torch", []))
    for name, argv in runs:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main(argv + dev_args + (["--steps", "20"] if small else []))
        log(f"[examples] {name} ran on {dev} in "
            f"{time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# the frontend models: seamless-m4t-medium and llava-next-mistral-7b
# ----------------------------------------------------------------------

FRONTEND_ARCHS = ["seamless-m4t-medium", "llava-next-mistral-7b"]
# the task types the two configs' EVAL records list (speech and vision)
FRONTEND_TASKS = ("translation", "transcription", "vqa", "captioning")
ENC_LEN = 16                 # the runner's src_embeds frames (reference)


def frontend_shapes(cfg, B: int, L: int, max_new: int):
    """The flash_attention calls one generation of a frontend model makes
    at batch B, prompt L: the encoder's non-causal self-attention over
    ``ENC_LEN`` frames, the decoder's causal prefill over the context
    (L, plus llava's frontend tokens), the cross-attention's prefill
    (L queries, ``ENC_LEN`` keys), the decode against the self cache
    (capacity max(L + max_new + 8, context), the runner's sizing: llava
    decodes past its cache, so every key is live) and the cross decode
    (every key live, no ``kv_valid``).  Yields (kind, Lq, Lk, kv_valid
    list or None, kwargs)."""
    G = cfg.n_heads // cfg.n_kv_heads
    ctx = L + (0 if cfg.is_encdec else cfg.frontend_tokens)
    C = max(L + max_new + 8, ctx)
    kv = [min(ctx + 1 + (i * 5) % max_new, C) for i in range(B)]
    shapes = [(ctx, ctx, None, dict(causal=True, window=0)),
              (1, C, kv, dict(causal=False, local_window=0))]
    if cfg.is_encdec:          # the cross-attention has no softcap
        shapes += [(ENC_LEN, ENC_LEN, None, dict(causal=False)),
                   (ctx, ENC_LEN, None, dict(causal=False, softcap=0.0)),
                   (1, ENC_LEN, None, dict(causal=False, softcap=0.0))]
    for Lq, Lk, kv_, kw in shapes:
        kw.setdefault("softcap", cfg.attn_softcap)
        yield (flash_kind(cfg.head_dim, Lq, G, 0, 0, kw["softcap"],
                          kw["causal"], Lk, kv_ is None), Lq, Lk, kv_, kw)


def frontend_kernel_phase(torch, dev, small: bool):
    """flash_attention at every shape the two frontend models serve, at
    full width (B = 16, prompt 512, 16 new tokens): seamless's encoder
    (16 x 16, non-causal), its G = 1 causal prefill, its
    cross-attention (512 queries, 16 keys: shorter than one key tile),
    its self decode over 536 slots and its cross decode with every key
    live; llava's hd-128 prefill over 2,880 frontend + 512 text tokens
    and its decode past the cache (3,392 keys).  Each row against its
    plain version, timed beside SDPA, with its bound.  Then f32 and bf16
    sweeps at odd key counts (12, 17) of the cross shapes.  Returns
    rows keyed ("frontend", kind)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator(device=dev).manual_seed(41)
    B, L, max_new = (2, 64, 4) if small else (16, 512, 16)
    rows = {}
    for name in FRONTEND_ARCHS:
        cfg = get_smoke(name) if small else get_config(name)
        for kind, Lq, Lk, kv, kw in frontend_shapes(cfg, B, L, max_new):
            rows[("frontend", kind)] = window_attn_row(
                torch, FA, g, dev, cfg, B, Lq, Lk, kv, kw,
                f"{kind} ({name}, B={B}, Lq={Lq}, Lk={Lk})",
                iters=20 if Lq * Lk < 4e6 else 5, tag="frontend kernels")
    cases = []
    for lk in (12, 16, 17):
        cases += [((3, 100, lk, 16, 16, 64), None, dict(causal=False)),
                  ((3, 1, lk, 16, 16, 64), None, dict(causal=False)),
                  ((3, lk, lk, 16, 16, 64), None, dict(causal=False))]
    cases += [((2, 300, 300, 32, 8, 128), None, dict(causal=True)),
              ((2, 1, 300, 32, 8, 128), [300, 300], dict(causal=False))]
    for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for (b_, lq, lk, hq, hk, d), kvl, kw in cases:
            def rn(*shape):
                return torch.randn(*shape, generator=g, device=dev).to(dt)
            kvt = None if kvl is None else torch.tensor(
                kvl, dtype=torch.int32, device=dev)
            worst = max(worst, attn_check(
                torch, FA, rn(b_, lq, hq, d).transpose(1, 2),
                rn(b_, lk, hk, d).transpose(1, 2),
                rn(b_, lk, hk, d).transpose(1, 2), kvt, tol,
                f"flash_attention {dt} {(b_, lq, lk, hq, hk, d)} {kw}", **kw))
        log(f"[frontend kernels] flash_attention {str(dt)[6:]} sweep "
            f"({len(cases)} cases: non-causal with 12, 16 and 17 keys as "
            f"the cross prefill, the cross decode and the encoder, G 1; "
            f"hd 128 G 4 prefill and decode): max err {worst:.3g} (tol "
            f"{tol} (1 + |want|))")
    return rows


def frontend_generation_phase(torch, dev, small: bool, kernels, rows):
    """Routed generation on seamless-m4t-medium (an encoder over 16 zero
    frames, as the reference's runner feeds it) and
    llava-next-mistral-7b (2,880 zero patch embeddings before the
    prompt) at full width and depth, seeded bf16 weights drawn on the
    card: 32 requests of the workload's translation, transcription, vqa
    and captioning texts, prompt 512, 16 new tokens.  seamless launches
    flash_attention once per encoder layer and twice per decoder layer
    (self, cross) per prefill and decode step; llava once per layer."""
    mres, results, launches, prompt_len, max_new, kinds = routed_generation(
        torch, dev, small, FRONTEND_ARCHS, seed=37,
        tag="generate frontends", task_types=FRONTEND_TASKS)
    sc, lc = (mres.entry(n).runner.cfg for n in FRONTEND_ARCHS)
    n_flash = sc.n_enc_layers + (2 * sc.n_layers + lc.n_layers) * max_new
    want = {"flash_attention": n_flash,
            "flash_attention_decode": (2 * sc.n_layers + lc.n_layers)
            * (max_new - 1), "ssd_scan": 0, "moe_gating": 0}
    check(sum(kinds.values()) == n_flash,
          f"flash_attention calls {kinds}, want {n_flash}")
    if dev.type == "cuda":
        check(launches == want, f"launch counts {launches}, want {want} "
                                "(per prefill and decode step: seamless "
                                "self + cross per layer, llava one per "
                                "layer; seamless's encoder once)")
    record_window_launches(kernels, rows, "frontend", kinds)
    for name in FRONTEND_ARCHS:
        res = results[name]
        ctx = prompt_len + (0 if mres.entry(name).runner.cfg.is_encdec
                            else lc.frontend_tokens)
        log(f"[generate frontends] {name}: context {ctx} tokens "
            f"(prompt {prompt_len}), decode cache "
            f"{max(prompt_len + max_new + 8, ctx)} slots")
        decode_profile(torch, dev, mres.entry(name).runner, name,
                       res.tokens.shape[0], prompt_len)


# ----------------------------------------------------------------------
# phase 8: the int8 KV cache
# ----------------------------------------------------------------------

INT8_ARCHS = ["llama3.2-1b", "gemma2-2b"]
# the served decode shapes the int8 decode is held at: (model, B, cache
# slots, live counts: "ragged" = prompt 512 + step, 513-528 a row, or
# "all", local window)
Q8_SHAPES = (("llama3.2-1b", 16, 536, "ragged", 0),
             ("gemma2-2b", 16, 536, "ragged", 4096),
             ("gemma2-2b", 16, 536, "ragged", 0),
             ("h2o-danube-3-4b", 4, 4096, "all", 0),
             ("llava-next-mistral-7b", 16, 3392, "all", 0))


class Q8Recorder:
    """Within the ``with``: every int8 decode of a run (the calls
    ``ops.flash_decode`` makes on an int8 cache), counted by its
    ``flash_kind``."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, ops._flash_q8_kernel
        self.counts = {}

    def __enter__(self):
        def record(q, k8, v8, ks, vs, kv_valid=None, **kw):
            kind = flash_kind(q.shape[-1], 1, q.shape[1] // k8.shape[1], 0,
                              kw.get("local_window", 0),
                              kw.get("softcap", 0.0), False)
            self.counts[kind] = self.counts.get(kind, 0) + 1
            return self.orig(q, k8, v8, ks, vs, kv_valid, **kw)
        self.ops._flash_q8_kernel = record
        return self

    def __exit__(self, *exc):
        self.ops._flash_q8_kernel = self.orig


def q8_bound(B, Hq, Hkv, hd, live: float, int8: bool):
    """The decode's bound: q and o in bf16, and each live (slot, KV
    head) row of K and V once -- 1 byte an element plus a 4-byte scale
    in an int8 cache, 2 bytes an element in bf16; 4 hd operations per
    (query head, live key) at the bf16 tensor-core rate."""
    row = hd + 4 if int8 else 2 * hd
    return bound_ms(2 * 2 * B * Hq * hd + 2 * live * Hkv * row,
                    4.0 * Hq * hd * live, PEAK_BF16_S)


def q8_row(torch, g, dev, name, cfg, B, C, kv, local, tag):
    """One served int8 decode shape of ``cfg`` (B rows over C slots,
    live counts ``kv``, ``local`` window): the kernel against
    ``decode_q8_plain``, on the tensor-core body, two launches bit-equal,
    timed beside the bf16 decode on the same values and both bounds.
    Returns (kind, kernels-line row, the bf16 decode's ms)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.layers import quantize_kv

    Hq, Hkv, hd, cap = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.attn_softcap)
    G = Hq // Hkv
    kvt = torch.from_numpy(kv.astype(np.int32)).to(dev)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)
    k8, ks = quantize_kv(rn(B, C, Hkv, hd))
    v8, vs = quantize_kv(rn(B, C, Hkv, hd))
    q = rn(B, 1, Hq, hd).transpose(1, 2)
    args = [x.transpose(1, 2) for x in (k8, v8, ks, vs)]
    kw = dict(softcap=cap, local_window=local)
    kind = flash_kind(hd, 1, G, 0, local, cap)
    what = f"{kind} ({name}, B={B}, C={C}, live " + (
        f"{int(kv.min())}-{int(kv.max())})" if kv.min() < kv.max()
        else "all)")
    body = FA.q8_body(q, args[0])
    by_body = dict(FA.flash_decode_q8.launches_by_body)
    got = FA.flash_decode_q8(q, *args, kvt, **kw)
    check(dev.type != "cuda" or (
        body == "mma" and FA.flash_decode_q8.launches_by_body["mma"]
        == by_body["mma"] + 1 and sum(
            FA.flash_decode_q8.launches_by_body.values())
        == sum(by_body.values()) + 1),
          f"int8 decode {what}: not one launch of the tensor-core "
          f"body ({body})")
    body_kernel = ("decode_wide_kernel<288, true>" if hd == 288 else
                   f"decode_mma_kernel<{128 if hd == 120 else hd}, "
                   f"true>")
    want = FA.decode_q8_plain(q, *args, kvt, **kw)
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"int8 decode {what}: output {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs()
    over = float((diff - 2e-2 * (1 + want.float().abs())).max())
    check(over <= 0, f"int8 decode {what}: |err| exceeds 2e-2 (1 + "
                     f"|want|) by {over}")
    err = float(diff.max())
    top = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    check(err <= ulp, f"int8 decode {what}: max err {err} above one "
                      f"bf16 ulp ({ulp}) of max |want| {top:.3g}")
    check(torch.equal(got, FA.flash_decode_q8(q, *args, kvt, **kw)),
          f"int8 decode {what}: two launches differ")
    live = float(np.minimum(kv, local).sum() if local else kv.sum())
    bms, by = q8_bound(B, Hq, Hkv, hd, live, True)
    b16, _ = q8_bound(B, Hq, Hkv, hd, live, False)
    kb = FA.dequantize_kv(args[0], args[2])
    vb = FA.dequantize_kv(args[1], args[3])
    iters = 20 if C < 1000 else 10
    row = dict(
        name=f"flash_decode_q8 {body_kernel} {what}", route="cuda",
        source=FLASH_SRC,
        replaces=FLASH_TPU, max_abs_err=err, bound_ms=bms, bound_by=by,
        ms=time_graph_ms(torch, lambda: FA.flash_decode_q8(
            q, *args, kvt, **kw), dev, iters=iters),
        plain_ms=time_ms(torch, lambda: FA.decode_q8_plain(
            q, *args, kvt, **kw), dev, iters=max(2, iters // 4),
            warmup=1),
        library_ms=None)
    bf16_ms = time_graph_ms(torch, lambda: FA.flash_attention(
        q, kb, vb, kvt, causal=False, **kw), dev, iters=iters)
    parts = fmt_times(kernel_times(torch, dev, lambda: FA.flash_decode_q8(
        q, *args, kvt, **kw), iters=3))
    log(f"[{tag}] {what}: {Hq}/{Hkv} heads of {hd}, softcap "
        f"{cap:g}, local {local}, {body_kernel}, splits "
        f"{FA.q8_splits(B, Hkv, C, hd, body)}: "
        f"{row['ms']:.4f} ms, bound {bms:.4f} by {by} "
        f"({row['ms'] / bms:.1f}x); the bf16 decode on the same values "
        f"{bf16_ms:.4f} ms (bound {b16:.4f}; int8 / bf16 "
        f"{row['ms'] / bf16_ms:.2f}); plain {row['plain_ms']:.4f}; "
        f"library: none, no PyTorch call reads int8 K/V; max err "
        f"{err:.3g} (one bf16 ulp of max |want| {top:.3g}: {ulp:.3g}); "
        f"launches: {parts}")
    return kind, row, bf16_ms


def kv_int8_kernel_phase(torch, dev, small: bool):
    """The int8 decode (``flash_decode_q8``) at the served decode shapes
    of ``Q8_SHAPES``, bf16 queries against an int8 cache in the model's
    (B, C, Hkv, hd) layout with its f32 scales (``quantize_kv`` of
    seeded bf16 rows): the kernel against ``decode_q8_plain`` (|err| <=
    2e-2 (1 + |want|) and at most one bf16 ulp of max |want|: both
    dequantize to the same bf16 values), one launch a call on the
    tensor-core body, two launches bit-equal; then its device time, the
    plain version's, the bf16 decode's (``flash_attention``) on the same
    dequantized values in a bf16 cache, both bounds, and the body's and
    the merge's device times from a trace.  Then the CUDA-core body
    (``decode_q8_kernel``): an f32 sweep and its time at llama's shape
    with f32 queries, and a bf16 sweep that reaches both bodies.
    Returns rows keyed ("int8", kind) for the served kinds, and logs
    every shape."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.layers import quantize_kv

    g = torch.Generator(device=dev).manual_seed(51)
    rows = {}
    for name, B, C, live_kind, local in Q8_SHAPES:
        cfg = get_smoke(name) if small else get_config(name)
        if small:
            B, C, local = min(B, 4), min(C, 150), min(local, 64)
        kv = (np.arange(B) % 16 + (C - 23)) if live_kind == "ragged" \
            else np.full(B, C)
        kind, row, bf16_ms = q8_row(torch, g, dev, name, cfg, B, C,
                                    kv, local, "kv int8 kernels")
        if name in INT8_ARCHS:
            rows[("int8", kind)] = dict(row, bf16_ms=bf16_ms)
    # f32 queries and odd shapes: G 1 and 40, kv_valid 0 and 1, a local
    # window cutting chunks, hd 32 and 120, f32 tolerance 2e-4
    cases = [((3, 77, 40, 1, 32), [0, 1, 77], 0, 0.0),
             ((2, 300, 8, 8, 64), [300, 150], 0, 0.0),
             ((3, 4100, 32, 8, 120), [1, 2000, 4100], 300, 0.0),
             ((2, 700, 8, 4, 288), [700, 513], 200, 50.0)]
    def sweep_args(b_, c_, hq, hk, d, dt):
        k8, ks = quantize_kv(torch.randn(b_, c_, hk, d, generator=g,
                                         device=dev))
        v8, vs = quantize_kv(torch.randn(b_, c_, hk, d, generator=g,
                                         device=dev))
        q = torch.randn(b_, 1, hq, d, generator=g, device=dev).to(dt)
        return [x.transpose(1, 2) for x in (q, k8, v8, ks, vs)]

    worst = 0.0
    cores = FA.flash_decode_q8.launches_by_body["cores"]
    for (b_, c_, hq, hk, d), kvl, loc, sc_ in cases:
        args = sweep_args(b_, c_, hq, hk, d, torch.float32)
        kvt = torch.tensor(kvl, dtype=torch.int32, device=dev)
        kw = dict(softcap=sc_, local_window=loc)
        got = FA.flash_decode_q8(*args, kvt, **kw)
        want = FA.decode_q8_plain(*args, kvt, **kw)
        e = float((got - want).abs().max())
        check(e <= 2e-4 * (1 + float(want.abs().max())),
              f"int8 decode f32 {(b_, c_, hq, hk, d)}: max err {e}")
        worst = max(worst, e)
    check(dev.type != "cuda" or FA.flash_decode_q8.launches_by_body["cores"]
          == cores + len(cases), "int8 decode f32 sweep: not every case on "
                                 "the CUDA-core body")
    # decode_q8_kernel at llama's served shape, f32 queries
    cfg = get_smoke("llama3.2-1b") if small else get_config("llama3.2-1b")
    B, C = (4, 150) if small else (16, 536)
    args = sweep_args(B, C, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      torch.float32)
    kv = np.arange(B) % 16 + (C - 23)
    kvt = torch.from_numpy(kv.astype(np.int32)).to(dev)
    f32_ms = time_graph_ms(torch, lambda: FA.flash_decode_q8(*args, kvt),
                           dev)
    f32_parts = fmt_times(kernel_times(
        torch, dev, lambda: FA.flash_decode_q8(*args, kvt), iters=3))
    log(f"[kv int8 kernels] f32 sweep ({len(cases)} cases: G 1-40, hd 32, "
        f"64, 120 and 288, kv_valid 0 and 1, local windows, softcap, all "
        f"on decode_q8_kernel): max err {worst:.3g} (tol 2e-4 (1 + max "
        f"|want|)); decode_q8_kernel at llama's shape (B={B}, C={C}, f32 "
        f"queries): {f32_ms:.4f} ms; launches: {f32_parts}")
    # bf16 queries on both bodies: G 20 and hd 32 stay on the CUDA cores,
    # G 16, hd 120 with a window cutting chunks, hd 288 on the tensor cores
    bcases = [((2, 300, 40, 2, 64), [300, 7], 0, 0.0, "cores"),
              ((2, 200, 8, 8, 32), [200, 0], 0, 0.0, "cores"),
              ((2, 700, 16, 1, 128), [700, 513], 0, 0.0, "mma"),
              ((3, 4100, 32, 8, 120), [1, 2000, 4100], 300, 0.0, "mma"),
              ((2, 700, 8, 4, 288), [700, 513], 200, 50.0, "mma"),
              ((2, 77, 8, 1, 288), [77, 1], 0, 0.0, "mma")]
    worst = 0.0
    for (b_, c_, hq, hk, d), kvl, loc, sc_, body in bcases:
        args = sweep_args(b_, c_, hq, hk, d, torch.bfloat16)
        kvt = torch.tensor(kvl, dtype=torch.int32, device=dev)
        kw = dict(softcap=sc_, local_window=loc)
        check(FA.q8_body(args[0], args[1]) == body,
              f"int8 decode bf16 {(b_, c_, hq, hk, d)}: body "
              f"{FA.q8_body(args[0], args[1])}, want {body}")
        n = FA.flash_decode_q8.launches_by_body[body]
        got = FA.flash_decode_q8(*args, kvt, **kw)
        check(dev.type != "cuda" or
              FA.flash_decode_q8.launches_by_body[body] == n + 1,
              f"int8 decode bf16 {(b_, c_, hq, hk, d)}: not on {body}")
        want = FA.decode_q8_plain(*args, kvt, **kw)
        diff = (got.float() - want.float()).abs()
        check(bool((diff <= 2e-2 * (1 + want.float().abs())).all()),
              f"int8 decode bf16 {(b_, c_, hq, hk, d)}: |err| above 2e-2 "
              f"(1 + |want|)")
        check(torch.equal(got, FA.flash_decode_q8(*args, kvt, **kw)),
              f"int8 decode bf16 {(b_, c_, hq, hk, d)}: two launches "
              f"differ")
        worst = max(worst, float(diff.max()))
    log(f"[kv int8 kernels] bf16 sweep ({len(bcases)} cases: G 4-20, hd "
        f"32-288, kv_valid 0 and 1, local windows cutting chunks, softcap; "
        f"G 20 and hd 32 on decode_q8_kernel, the rest on the tensor "
        f"cores; two launches bit-equal): max err {worst:.3g} (tol 2e-2 "
        f"(1 + |want|))")
    return rows


def cache_bytes(torch, cfg, B: int, ctx: int) -> int:
    """Bytes of ``init_cache(cfg, B, ctx)``, counted on the meta device."""
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, B, ctx, device="meta")
    return sum(t.numel() * t.element_size() for t in cache.values())


def kv_int8_generation_phase(torch, dev, small: bool, kernels, rows):
    """Routed generation on llama3.2-1b and gemma2-2b at full width and
    depth (seeded bf16 weights drawn on the card), 32 requests by
    preference profile, prompt 512, 16 new tokens: first with the
    configs' bf16 cache, then the same catalog, weights and requests
    with ``kv_cache_dtype="int8"``.  The int8 run: every decode step of
    every layer one ``flash_decode_q8`` launch on the tensor-core body
    (``launches_by_body``, none on ``decode_q8_kernel``) and no bf16
    decode, the
    prefill unchanged (one flash_attention launch a layer); prefill ms,
    ms per step, the card's busy share, the cache's bytes against bf16
    and the greedy tokens that agree with the bf16 run (reported, not
    gated).  Then both configs with an int8 cache on the card against
    the CPU at full width, 2 layers (gemma2 with its window cut to 48 at
    prompt 72, so its local layers mask)."""
    import dataclasses

    from repro_torch.models import model as M

    runs = {}
    for kv_dt in ("", "int8"):
        tag = "kv int8 generate" + ("" if kv_dt else " (bf16 cache)")
        mres, results, launches, prompt_len, max_new, kinds = \
            routed_generation(torch, dev, small, INT8_ARCHS, seed=47,
                              tag=tag, kv_cache_dtype=kv_dt)
        cfgs = {n: mres.entry(n).runner.cfg for n in INT8_ARCHS}
        n_attn = sum(c.n_layers for c in cfgs.values())
        if kv_dt:
            n8 = n_attn * (max_new - 1)
            want = {"flash_attention": n_attn,
                    "flash_attention_decode": 0, "ssd_scan": 0,
                    "moe_gating": 0, "flash_decode_q8": n8,
                    "flash_decode_q8[mma]": n8, "flash_decode_q8[cores]": 0}
            q8 = {k[5:]: v for k, v in kinds.items() if k.startswith("int8 ")}
            check(sum(q8.values()) == n8,
                  f"int8 decode calls {q8}, want {n8}")
            if dev.type == "cuda":
                check(launches == want, f"launch counts {launches}, want "
                                        f"{want} (prefill: flash_attention; "
                                        f"every decode: flash_decode_q8 on "
                                        f"the tensor-core body)")
            for (_, kind), row in rows.items():
                check(q8.get(kind, 0) > 0,
                      f"int8 decode {kind} never launched ({q8})")
                kernels[row["name"]] = dict(
                    {k: v for k, v in row.items() if k != "bf16_ms"},
                    launches=q8[kind])
            for name in INT8_ARCHS:
                decode_profile(torch, dev, mres.entry(name).runner,
                               f"{name} int8 KV",
                               results[name].tokens.shape[0], prompt_len)
        runs[kv_dt] = {n: results[n] for n in INT8_ARCHS}
        runs[kv_dt + "cfg"] = cfgs
        del mres, results
        release(torch, dev, f"after the {tag} run")
    for name in INT8_ARCHS:
        a, b = runs[""][name], runs["int8"][name]
        check(a.tokens.shape == b.tokens.shape,
              f"{name}: the two runs served {a.tokens.shape} and "
              f"{b.tokens.shape}")
        same = a.tokens == b.tokens
        prefix = int(sum(np.cumprod(r).sum() for r in same))
        cfg8 = runs["int8cfg"][name]
        B = b.tokens.shape[0]
        ctx = prompt_len + max_new + 8
        nb8 = cache_bytes(torch, cfg8, B, ctx)
        nb16 = cache_bytes(torch, dataclasses.replace(cfg8, kv_cache_dtype=""),
                           B, ctx)
        step8 = b.decode_s / max(max_new - 1, 1)
        step16 = a.decode_s / max(max_new - 1, 1)
        log(f"[kv int8 generate] {name}: B={B}, prompt {prompt_len}, "
            f"{max_new} new tokens: prefill {b.prefill_s * 1e3:.2f} ms "
            f"(bf16 cache {a.prefill_s * 1e3:.2f}), decode "
            f"{step8 * 1e3:.3f} ms per step (bf16 cache "
            f"{step16 * 1e3:.3f}); cache of {M.cache_len(cfg8, ctx)} "
            f"slots: {nb8 / 1e6:.2f} MB int8 + scales against "
            f"{nb16 / 1e6:.2f} MB {cfg8.compute_dtype} ({nb8 / nb16:.3f}); "
            f"greedy tokens "
            f"equal to the bf16 run: {int(same.sum())} of {same.size} "
            f"({prefix} before each row's first difference)")
    card_vs_cpu_phase(torch, dev, small, ["llama3.2-1b"],
                      kv_cache_dtype="int8")
    card_vs_cpu_phase(torch, dev, small, ["gemma2-2b"], prompt=72, window=48,
                      kv_cache_dtype="int8")


def _busy(prof) -> list:
    """(device us, name) of a trace's kernels, largest first.  Only the
    device's own events count: an operator's row (``aten::mm``) repeats
    the time of the kernels it launched."""
    ev = [(getattr(e, "self_device_time_total", 0.0), e.key)
          for e in prof.key_averages()
          if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sorted([x for x in ev if x[0] > 0], reverse=True)


def decode_profile(torch, dev, runner, name: str, B: int, prompt_len: int,
                   steps: int = 3, long_mode: bool = False):
    """Device busy share of one prefill and of ``steps`` decode steps:
    the kernel time a ``torch.profiler`` trace attributes to them over
    their wall time (host clock, ending in a synchronize), with the
    kernels that take the most of it."""
    if dev.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.steps import make_decode_step, make_prefill_step

    batch = runner._batch(np.ones((B, prompt_len), np.int64))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        prefill = make_prefill_step(runner.cfg, long_mode=long_mode,
                                    max_len=prompt_len + steps + 2)
        prefill(runner.params, batch)
        torch.cuda.synchronize(dev)
        with profile(activities=acts) as pprof:
            t0 = time.perf_counter()
            last, cache, pos = prefill(runner.params, batch)
            torch.cuda.synchronize(dev)
            pwall = time.perf_counter() - t0
        step = make_decode_step(runner.cfg, long_mode=long_mode)
        tok = torch.argmax(last, dim=-1)[:, None]
        _, tok, cache = step(runner.params, cache, {"token": tok, "pos": pos})
        pos = pos + 1
        torch.cuda.synchronize(dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                _, tok, cache = step(runner.params, cache,
                                     {"token": tok, "pos": pos})
                pos = pos + 1
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    for what, tr, w in (("prefill", pprof, pwall),
                        (f"{steps} decode steps", prof, wall)):
        busy = _busy(tr)
        dev_us = sum(x[0] for x in busy)
        if not dev_us:
            log(f"[profile] {name}: the trace holds no device time; device "
                f"busy share not measured")
            return
        top = "; ".join(f"{n[:48]} {us / 1e3:.2f} ms" for us, n in busy[:5])
        log(f"[profile] {name}: {what} (B={B}) in {w * 1e3:.2f} ms (under "
            f"the profiler), device busy {dev_us / 1e3:.2f} ms = "
            f"{dev_us / 1e6 / w:.1%} of it; most: {top}")
        # the port's own kernels, by the names in its CUDA sources
        ours = {}
        for us, n in busy:
            lab = kernel_label(n)
            if lab.split("<")[0] in port_kernels():
                ours[lab] = ours.get(lab, 0.0) + us
        if ours:
            log(f"[profile] {name}: {what}: the port's kernels "
                + "; ".join(f"{k} {us / 1e3:.2f} ms" for k, us in
                            ours.items())
                + f"; together {sum(ours.values()) / 1e3:.2f} ms")


# ----------------------------------------------------------------------
# phase 6: the card against the CPU
# ----------------------------------------------------------------------

def card_vs_cpu_phase(torch, dev, small: bool, archs=GEN_ARCHS,
                      prompt: int = 64, window: int = 0,
                      kv_cache_dtype: str = ""):
    """Full width, 2 layers, f32 compute: the same seeded weights on the
    card (kernels) and the CPU (plain versions).  ``window`` replaces a
    windowed model's sliding window (the one reduction besides depth),
    so that a ring wraps and local layers mask at a prompt the CPU can
    run.  The frontend models get 2 encoder layers (seamless) and 64
    frontend tokens (llava's 2,880 cut, widths unchanged: an f32 CPU
    prefill over 2,880 + 64 tokens would not finish in the time
    limit), and are fed seeded standard-normal embeddings on both
    devices (the runners' zeros would leave seamless's cross term 0).
    ``kv_cache_dtype="int8"`` serves both with an int8 KV cache and also
    holds the first decode step's logits to the same tolerance (the
    decode is where the cache's type shows)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import model as M
    from repro_torch.serving.runner import ModelRunner

    cpu = torch.device("cpu")
    B, Lp, max_new = (2, prompt if window else 24, 4) if small else \
        (4, prompt, 4)
    for name in archs:
        base = get_smoke(name) if small else get_config(name)
        cfg = dataclasses.replace(base, n_layers=2, compute_dtype="float32",
                                  kv_cache_dtype=kv_cache_dtype)
        if window:
            cfg = dataclasses.replace(cfg, sliding_window=window)
            C = M.cache_len(cfg, Lp + max_new + 8)
            log(f"[card vs cpu] {name}: window {base.sliding_window} -> "
                f"{window} (the one reduction besides depth); "
                + (f"a ring of {C} slots, roll shift {Lp % C}"
                   if C < Lp else f"local/global layers in a cache of {C}"))
        rng = np.random.default_rng(12)
        emb = None
        if cfg.frontend:
            cfg = dataclasses.replace(cfg, n_enc_layers=2) if cfg.is_encdec \
                else dataclasses.replace(cfg, frontend_tokens=min(
                    64, cfg.frontend_tokens))
            shape = (B, ENC_LEN if cfg.is_encdec else cfg.frontend_tokens,
                     cfg.frontend_dim)
            emb = rng.standard_normal(shape).astype(np.float32)
            log(f"[card vs cpu] {name}: "
                + ("2 encoder layers of " + str(base.n_enc_layers)
                   if cfg.is_encdec else
                   f"frontend tokens {base.frontend_tokens} -> "
                   f"{cfg.frontend_tokens}")
                + f" (besides depth); seeded standard-normal {shape} "
                f"frontend embeddings")
        params = M.init_params(cfg, torch.Generator().manual_seed(11), cpu)
        toks = rng.integers(0, cfg.vocab_size, (B, Lp)).astype(np.int32)
        ref = ModelRunner(cfg, params=params, device=cpu).generate(
            toks, max_new, keep_logits=True, embeds=emb)
        got = ModelRunner(cfg, params=params, device=dev).generate(
            toks, max_new, keep_logits=True, embeds=emb)
        scale = float(np.abs(ref.logits_last).max())
        tol = 1e-3 * scale
        err = float(np.abs(got.logits_last - ref.logits_last).max())
        check(err <= tol, f"{name}: prefill logits off by {err} > {tol}")
        same = got.tokens[:, 0] == ref.tokens[:, 0]
        if kv_cache_dtype and same.any():
            derr = float(np.abs(got.step_logits[same, 1]
                                - ref.step_logits[same, 1]).max())
            check(derr <= tol, f"{name}: {kv_cache_dtype} decode logits "
                               f"off by {derr} > {tol}")
            log(f"[card vs cpu] {name} {kv_cache_dtype} KV cache: first "
                f"decode step's logits max err {derr:.3g} (tol {tol:.3g})")
        compared = 0
        for b in range(B):
            for s_ in range(max_new):
                top2 = np.sort(ref.step_logits[b, s_])[-2:]
                if top2[1] - top2[0] < tol:
                    break                     # near-tie: stop this row
                check(got.tokens[b, s_] == ref.tokens[b, s_],
                      f"{name}: row {b} step {s_} token "
                      f"{got.tokens[b, s_]} vs {ref.tokens[b, s_]}")
                compared += 1
        log(f"[card vs cpu] {name} (d_model {cfg.d_model}, hd "
            f"{cfg.head_dim}, 2 layers, f32"
            f"{', int8 KV cache' if kv_cache_dtype else ''}, B={B}, prompt "
            f"{Lp}): prefill "
            f"logits max err {err:.3g} "
            f"(max |logit| {scale:.3g}, tol {tol:.3g}); {compared} of "
            f"{B * max_new} greedy tokens compared, all equal")


class GateRecorder:
    """Within the ``with``: every ``ops.moe_gating`` call of a run (the
    layers call it through the module), its logits as f32 on the host
    and the experts it chose."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig, self.calls = ops, ops.moe_gating, []

    def __enter__(self):
        def record(logits, k):
            out = self.orig(logits, k)
            self.calls.append((logits.float().cpu(), out[1].cpu()))
            return out
        self.ops.moe_gating = record
        return self

    def __exit__(self, *exc):
        self.ops.moe_gating = self.orig


def moe_card_vs_cpu(torch, dev, small: bool):
    """qwen3-moe-30b-a3b at full width, 2 layers, f32, its published
    capacity factor (tokens are dropped): the same seeded weights on the
    card (kernels) and the CPU (plain versions), compared tie-aware in
    the gate as well as in the greedy tokens.  Each batch row is one MoE
    group (prefill: g = the prompt; decode: g = 1), so a choice made
    differently at a near-tie (the CPU's probabilities of the two
    experts at that position within 1e-5) can move only its own row:
    that row is logged and compared no further.  Any other difference
    fails."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import model as M
    from repro_torch.serving.runner import ModelRunner

    cpu = torch.device("cpu")
    B, Lp, max_new = (2, 24, 4) if small else (4, 64, 4)
    base = get_smoke(MOE_ARCH) if small else get_config(MOE_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=2, compute_dtype="float32",
        moe_capacity_factor=get_config(MOE_ARCH).moe_capacity_factor)
    E, K, nL = cfg.n_experts, cfg.moe_top_k, cfg.n_layers
    g = min(cfg.moe_group, Lp)
    check(g == Lp, "one MoE group per batch row at prefill")
    C = max(1, math.ceil(g * K / E * cfg.moe_capacity_factor))
    params = M.init_params(cfg, torch.Generator().manual_seed(13), cpu)
    toks = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, Lp)).astype(np.int32)
    with GateRecorder() as rec_cpu:
        ref = ModelRunner(cfg, params=params, device=cpu).generate(
            toks, max_new, keep_logits=True)
    with GateRecorder() as rec_dev:
        got = ModelRunner(cfg, params=params, device=dev).generate(
            toks, max_new, keep_logits=True)
    del params
    check(len(rec_cpu.calls) == len(rec_dev.calls) == nL * max_new,
          f"gate calls {len(rec_cpu.calls)} / {len(rec_dev.calls)}, want "
          f"{nL * max_new}")
    # pairs past capacity at prefill (k-major, then token order)
    dropped = 0
    for _, idx in rec_cpu.calls[:nL]:
        for grp in idx.reshape(-1, g, K):
            counts = np.bincount(grp.T.reshape(-1).numpy(), minlength=E)
            dropped += int(np.maximum(counts - C, 0).sum())
    scale = float(np.abs(ref.logits_last).max())
    tol = 1e-3 * scale
    active = np.ones(B, bool)
    min_gap, near, compared = float("inf"), [], 0
    for s_ in range(max_new):
        for layer in range(nL):
            n = s_ * nL + layer
            (lg, ri), (_, gi) = rec_cpu.calls[n], rec_dev.calls[n]
            check(lg.shape[0] == B, "one MoE group per batch row")
            p = torch.softmax(lg, dim=-1)
            top = torch.sort(p, dim=-1, descending=True).values[..., :K + 1]
            gap = (top[..., :-1] - top[..., 1:]).amin(dim=-1)   # (B, g)
            for b in np.flatnonzero(active):
                min_gap = min(min_gap, float(gap[b].min()))
                diff = ri[b] != gi[b]                              # (g, K)
                if bool(diff.any()):
                    # the CPU's probabilities of the two experts at each
                    # position where the choices differ
                    pb = p[b]
                    apart = (pb.gather(-1, gi[b].long())
                             - pb.gather(-1, ri[b].long())).abs()
                    worst = float(apart[diff].max())
                    check(worst < 1e-5,
                          f"{MOE_ARCH}: step {s_} layer {layer} row {b}: "
                          f"the card chose other experts than the CPU "
                          f"without a near-tie (gap {worst:.3g})")
                    near.append((s_, layer, int(b), worst))
                    active[b] = False
        if s_ == 0:
            err = float(np.abs(got.logits_last[active]
                               - ref.logits_last[active]).max()) \
                if active.any() else 0.0
            check(err <= tol, f"{MOE_ARCH}: prefill logits off by {err} > "
                              f"{tol}")
        for b in np.flatnonzero(active):
            top2 = np.sort(ref.step_logits[b, s_])[-2:]
            if top2[1] - top2[0] < tol:
                active[b] = False             # near-tie: stop this row
                continue
            check(got.tokens[b, s_] == ref.tokens[b, s_],
                  f"{MOE_ARCH}: row {b} step {s_} token "
                  f"{got.tokens[b, s_]} vs {ref.tokens[b, s_]}")
            compared += 1
    log(f"[card vs cpu] {MOE_ARCH} (d_model {cfg.d_model}, {E} experts "
        f"top-{K}, 2 layers, f32, B={B}, prompt {Lp}, C={C} per group of "
        f"{g}): {dropped} of {nL * B * g * K} (token, choice) pairs dropped "
        f"at prefill; prefill logits max err {err:.3g} (max |logit| "
        f"{scale:.3g}, tol {tol:.3g}); {compared} of {B * max_new} greedy "
        f"tokens compared, all equal; smallest gate gap {min_gap:.3g}; "
        f"choices made differently at a near-tie: {near or 'none'}")


# ----------------------------------------------------------------------
# serve_loop: the deployable service loop (launch/serve.py)
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# phase 3d: the drift, Zipf-replay and simulator workloads
# ----------------------------------------------------------------------

class SigAnalyzer:
    """Analyzer stand-in serving each text's workload signature (the
    reference's drift benchmark does the same: the episode measures the
    router, not the analyzer), so the card and CPU runs route the same
    task vectors."""

    def __init__(self, table: dict):
        self.table = table

    def analyze_batch(self, texts):
        return [self.table[t] for t in texts]

    def analyze(self, text):
        return self.table[text]


class HookLog:
    """The cost profiler and the recompile hook attached to the ops
    layer for the ``with``, beside the dispatch counters' deltas."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.obs import DeviceCostProfiler
        self.ops, self.prof, self.events = ops, DeviceCostProfiler(), []
        self.delta = {}                   # dispatches inside the withs

    def __enter__(self):
        self.before = self.ops.route_step_stats()
        self.ops.set_cost_profiler(self.prof)
        self.ops.set_recompile_hook(self.events.append)
        return self

    def __exit__(self, *exc):
        self.ops.set_cost_profiler(None)
        self.ops.set_recompile_hook(None)
        after = self.ops.route_step_stats()
        for k in after:
            self.delta[k] = self.delta.get(k, 0) + after[k] - self.before[k]

    def check_one_event_per_dispatch(self, what: str) -> None:
        """Every route-step dispatch (dense, sharded, ivf, fused) and
        every analyzer dispatch (analyze, fused) saw exactly one event,
        each with 0 compiles."""
        paths = [e["path"] for e in self.events]
        routes = sum(p in ("dense", "sharded", "ivf", "fused") for p in paths)
        analyzes = sum(p in ("analyze", "fused") for p in paths)
        check(routes == self.delta["route_step_dispatches"] and
              analyzes == self.delta["analyze_step_dispatches"],
              f"{what}: hook events {len(paths)} ({routes} route, "
              f"{analyzes} analyzer) against dispatches {self.delta}")
        check(all(e["compiles"] == 0 for e in self.events),
              f"{what}: an event reports compiles")


def drift_episode(torch, dev, mres, wl, quant: bool, prefs: str):
    """One model-degrade episode: each step's batch routed
    (``route_all`` with the batch's own signatures, LinUCB at weight 2,
    alpha 0.5, forget 0.96 -- the reference's drift benchmark) and
    ``observe``-d with its true qualities at that step.  Returns the
    routed queries per step, the chosen models, the reward per step
    and the wall seconds per step (route + observe)."""
    from repro_torch.adaptive import LinearBandit
    from repro_torch.core.orchestrator import OptiRoute

    an = SigAnalyzer({})
    bandit = LinearBandit(len(mres), alpha=0.5, forget=0.96, seed=11,
                          device=dev)
    router = OptiRoute(mres, an, adaptive=bandit, adaptive_weight=2.0,
                       device=dev)
    router.engine.quantize = quant
    steps, chosen, reward, wall = [], [], [], []
    for t in range(wl.sc.n_steps):
        batch = wl.batch(t)
        an.table = {q.text: q.sig for q in batch}
        t0 = time.perf_counter()
        rqs = router.route_all([q.text for q in batch], prefs)
        models = [rq.decision.model for rq in rqs]
        qual = np.array([wl.quality(t, m, q.sig)
                         for m, q in zip(models, batch)])
        router.observe(rqs, qualities=qual)
        wall.append(time.perf_counter() - t0)
        steps.append(rqs)
        chosen.append(models)
        reward.append(float(qual.sum()))
    return steps, chosen, np.array(reward), np.array(wall)


def step_decisions_match(ref, got, what: str):
    """Tie-aware, step by step, as ``decisions_match``; after the first
    tie-broken difference the two bandits learn from different choices,
    so the comparison stops there.  Returns (steps compared, ties)."""
    for t, (a_s, b_s) in enumerate(zip(ref, got)):
        for i, (a, b) in enumerate(zip(a_s, b_s)):
            if a.decision.model == b.decision.model:
                continue
            check(near_tie(ranked_scores(a)) or near_tie(ranked_scores(b)),
                  f"{what}: step {t} row {i} model {a.decision.model} vs "
                  f"{b.decision.model} without a tie")
            return t + 1, 1
    return len(ref), 0


def recovery_steps(chosen, wl):
    """The reference benchmark's recovery: steps after the shift until
    the degraded model stops winning the batch majority."""
    deg = wl.degraded_model
    for t in range(wl.shift_step, wl.sc.n_steps):
        top = max(set(chosen[t]), key=chosen[t].count)
        if top != deg:
            return t - wl.shift_step
    return None


def workloads_phase(torch, dev, small: bool, shared):
    """Over the serving phase's catalog (100,000 entries), with the cost
    profiler and the recompile hook attached to the card's runs: (1) the
    default ``DriftScenario`` cut to 20 steps of 16 (model-degrade), its
    degraded model the one ``accuracy-first`` routes most of step 0 to
    (the reference's drift benchmark picks it so), served with an fp32
    and an int8 catalog: recovery after the shift and per-step p50;
    (2) ``zipf_replay`` (64 queries, 512 requests) through
    ``ServingEngine.submit`` with the semantic cache and LinUCB, in
    submits of 64 each observed: the hit rate; (3) a
    ``ServingSimulator`` over the catalog (capacity 2 a model, service
    time its latency) fed a bursty ``TrafficScenario``, its ``route_fn``
    routing each arrival with the live tracker's load penalty in the
    blend and ``plan_admission`` against the tracker (deadline 400 ms).
    Each against the same run on the CPU, tie-aware; the hook must see
    one event per dispatch, each with 0 compiles; each bucket's FLOPs
    and bytes are logged."""
    import dataclasses

    from repro_torch.adaptive import LinearBandit
    from repro_torch.cache.semantic import SemanticCache
    from repro_torch.core.orchestrator import OptiRoute
    from repro_torch.core.routing import RoutingEngine
    from repro_torch.data.workload import (DriftScenario,
                                           NonStationaryWorkload,
                                           ServingSimulator, TrafficScenario,
                                           ZipfReplayScenario, meta_of,
                                           poisson_arrivals, quality_of,
                                           zipf_replay)
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.load import LoadTracker, plan_admission

    mres, _ = routing_inputs(small, shared)
    cpu = torch.device("cpu")
    n = len(mres)
    metas = [meta_of(e) for e in mres.entries]
    t_phase = time.perf_counter()
    hooks = HookLog()

    # -- (1) the drift episode, cut from the default 60 steps to 30 and
    # then 20 to keep the script inside its time limit with the training,
    # sharding and multirank phases
    sc = dataclasses.replace(DriftScenario(), n_steps=12 if small else 20)
    probe = NonStationaryWorkload(metas, sc)
    eng = RoutingEngine(mres, device=cpu)
    picked = [d.model for d in eng.route_many(
        "accuracy-first", [q.sig for q in probe.batch(0)])]
    sc = dataclasses.replace(sc, degrade_model=max(set(picked),
                                                   key=picked.count))
    wl = NonStationaryWorkload(metas, sc)
    log(f"[workloads] drift: {sc.kind}, {sc.n_steps} steps of {sc.batch}, "
        f"shift at step {wl.shift_step}, degraded model {wl.degraded_model} "
        f"(step 0's accuracy-first majority, {picked.count(wl.degraded_model)}"
        f" of {sc.batch})")
    for quant in (False, True):
        tag = "int8" if quant else "fp32"
        with hooks:
            steps, chosen, reward, wall = drift_episode(
                torch, dev, mres, wl, quant, "accuracy-first")
        ref_steps, ref_chosen, ref_reward, _ = drift_episode(
            torch, cpu, mres, wl, quant, "accuracy-first")
        compared, ties = step_decisions_match(ref_steps, steps,
                                              f"drift {tag}")
        deg = wl.degraded_model
        share = lambda lo, hi: np.mean([c.count(deg) / len(c)
                                        for c in chosen[lo:hi]])
        log(f"[workloads] drift {tag}: recovery "
            f"{recovery_steps(chosen, wl)} steps after the shift (CPU run "
            f"{recovery_steps(ref_chosen, wl)}); the degraded model's share "
            f"of choices {share(0, wl.shift_step):.3f} before the shift, "
            f"{share(wl.shift_step, sc.n_steps):.3f} after; reward per "
            f"step {reward[:wl.shift_step].mean():.3f} before, "
            f"{reward[wl.shift_step:].mean():.3f} after; route + observe "
            f"per step p50 {np.quantile(wall[1:], 0.5) * 1e3:.1f} ms, p99 "
            f"{np.quantile(wall[1:], 0.99) * 1e3:.1f} ms; decisions match "
            f"the CPU run over {compared} of {sc.n_steps} steps "
            f"({ties} tie-broken)")
    hooks.check_one_event_per_dispatch("drift")

    # -- (2) Zipf replay through the semantic cache
    zsc = ZipfReplayScenario(n_requests=128 if small else 512)
    pool, order = zipf_replay(zsc)
    sigs = {q.text: q.sig for q in pool}

    def replay(d):
        an = SigAnalyzer(sigs)
        router = OptiRoute(
            mres, an, adaptive=LinearBandit(n, seed=3, device=d),
            adaptive_weight=1.0, cache=SemanticCache(
                capacity=4096, min_quality=0.0, device=d), device=d)
        eng = ServingEngine(router)
        out, lat = [], []
        for lo in range(0, len(order), 64):
            idx = order[lo:lo + 64]
            t0 = time.perf_counter()
            resp = eng.submit([Request(text=pool[j].text, prefs="balanced",
                                       id=int(lo + i))
                               for i, j in enumerate(idx)])
            eng.observe(resp, [quality_of(meta_of(mres.entry(r.model)),
                                          pool[j].sig)
                               for r, j in zip(resp, idx)])
            lat.append(time.perf_counter() - t0)
            out.append(resp)
        return out, lat
    with hooks:
        got, lat = replay(dev)
    ref, _ = replay(cpu)
    ties = decisions_match(ref, got, "zipf replay")
    hits = [sum(r.cache_hit for r in b) for b in got]
    rate = sum(hits) / len(order)
    # a request whose query an earlier submit served (and observed,
    # writing it back) must hit
    seen, repeats = set(), 0
    for lo in range(0, len(order), 64):
        repeats += sum(int(j) in seen for j in order[lo:lo + 64])
        seen.update(int(j) for j in order[lo:lo + 64])
    log(f"[workloads] zipf replay ({zsc.n_unique} queries, {len(order)} "
        f"requests, a={zsc.zipf_a}): hits per submit of 64 {hits}, hit rate "
        f"{rate:.3f} ({repeats} requests repeat a query of an earlier "
        f"submit); submit + observe p50 {np.quantile(lat, 0.5) * 1e3:.1f} "
        f"ms; decisions and hits match the CPU run ({ties} tie-broken)")
    check(sum(hits) >= repeats, f"zipf replay: {sum(hits)} hits, fewer "
                                f"than the {repeats} repeats")
    hooks.check_one_event_per_dispatch("zipf replay")

    # -- (3) the serving simulator with a live tracker
    tsc = TrafficScenario(duration_s=1.5 if small else 4.0, seed=3)
    arrivals = poisson_arrivals(tsc)
    lat_ms = np.array([e.raw_metrics["latency_ms"] for e in mres.entries])
    # four queries in turn: each one's favourite model takes a quarter
    # of the burst, past its two servers, so the tracker's load penalty
    # and plan_admission have queues to steer around
    qsigs = [q.sig for q in probe.batch(1)][:4]

    def simulate(d):
        tracker = LoadTracker(n, tau_s=tsc.deadline_ms / 2e3,
                              default_service_s=float(lat_ms.mean() / 1e3))
        eng = RoutingEngine(mres, knn_k=8, load=tracker, load_weight=1.0,
                            device=d)
        sim = ServingSimulator(lat_ms / 1e3, np.full(n, 2), tracker=tracker)
        col = {e.name: j for j, e in enumerate(mres.entries)}
        decisions = []

        def route(i, t):
            dcs = eng.route_many_batch(
                "accuracy-first", [qsigs[i % len(qsigs)]]).decisions()[0]
            decisions.append(dcs)
            m, kind, _ = plan_admission(dcs, tracker, col, tsc.deadline_ms)
            return col[m], kind
        t0 = time.perf_counter()
        res = sim.run(arrivals, route, deadline_ms=tsc.deadline_ms)
        return res, decisions, time.perf_counter() - t0
    with hooks:
        res, dec, wall = simulate(dev)
    ref_res, ref_dec, _ = simulate(cpu)
    compared = len(dec)
    for i, (a, b) in enumerate(zip(ref_dec, dec)):
        if a.model != b.model:
            c = [s for _, s in a.candidates]
            check(len(c) > 1 and c[0] - c[1] <= 1e-5,
                  f"simulator: arrival {i} model {a.model} vs {b.model} "
                  "without a tie")
            compared = i
            break
    if compared == len(dec):
        for key in ("model", "shed", "rerouted"):
            check(np.array_equal(res[key], ref_res[key]),
                  f"simulator: {key} differs from the CPU run")
    kinds = {k: int(v) for k, v in (("shed", res["shed"].sum()),
                                    ("rerouted", res["rerouted"].sum()))}
    log(f"[workloads] simulator: {arrivals.size} arrivals over "
        f"{tsc.duration_s} s (burst {tsc.burst_rate}/s), {kinds}, latency "
        f"p50 {res['p50_s'] * 1e3:.1f} ms, p99 {res['p99_s'] * 1e3:.1f} ms, "
        f"SLO miss rate {res['slo_miss_rate']:.3f}; routing "
        f"{wall / max(arrivals.size, 1) * 1e3:.2f} ms an arrival on the card "
        f"(host clock); decisions match the CPU run over {compared} of "
        f"{len(dec)} arrivals")
    hooks.check_one_event_per_dispatch("simulator")
    for bucket, costs in sorted(hooks.prof.profile().items()):
        log(f"[workloads] cost profile {bucket}: {costs['flops']:.4g} "
            f"FLOPs, {costs['bytes_accessed']:.4g} bytes")
    log(f"[workloads] recompile hook: {len(hooks.events)} events, one per "
        f"dispatch, every one with compiles == 0; phase time "
        f"{time.perf_counter() - t_phase:.1f} s")


SCAN_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SCAN_TPU = "src/repro/kernels/ssd_scan.py:75"
BATCHER_ARCHS = ["llama3.2-1b", "mamba2-1.3b", "gemma2-2b"]


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gating as MG
    from repro_torch.kernels import router_topk as RT
    from repro_torch.kernels import ssd_scan as SS
    for f in (FA.flash_attention, SS.ssd_scan, MG.moe_gating,
              RT.router_topk, RT.router_topk_q8, FA.flash_decode_q8,
              FA.decode_merge, *bwd_kernels().values()):
        f.launches = 0
    FA.flash_attention.decode_launches = 0
    for by in (FA.flash_attention_bwd.launches_by_body,
               FA.flash_decode_q8.launches_by_body,
               FA.flash_attention.decode_launches_by_body):
        for b in by:
            by[b] = 0


def read_launches() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gating as MG
    from repro_torch.kernels import router_topk as RT
    from repro_torch.kernels import ssd_scan as SS
    return {"router_topk": RT.router_topk.launches,
            "flash_attention": FA.flash_attention.launches,
            "flash_attention_decode": FA.flash_attention.decode_launches,
            "ssd_scan": SS.ssd_scan.launches,
            "moe_gating": MG.moe_gating.launches,
            "flash_decode_q8": FA.flash_decode_q8.launches,
            "decode_merge": FA.decode_merge.launches,
            **{k: f.launches for k, f in bwd_kernels().items()},
            **{f"{f.__name__}[{b}]": n
               for f in (FA.flash_attention_bwd, FA.flash_decode_q8)
               for b, n in f.launches_by_body.items()},
            **{f"flash_attention_decode[{b}]": n for b, n in
               FA.flash_attention.decode_launches_by_body.items()}}


ANALYZER_STEPS = 250              # load_analyzer's training run


def analyzer_kw(small: bool) -> dict:
    """``TaskAnalyzer.train``'s arguments for the card and the CPU run."""
    return (dict(steps=60, n_samples=1024) if small else
            dict(steps=ANALYZER_STEPS))


def cpu_analyzer_worker(out: str, small: bool) -> int:
    """The CPU's run of ``train_analyzers``' comparison (this script with
    ``--cpu-analyzer``): ``TaskAnalyzer.train`` from the same seeded init
    on half the host's cores, its losses, metrics and times written to
    ``out`` as JSON."""
    import os

    import torch
    from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    an = TaskAnalyzer(AnalyzerConfig(), seed=0, device=torch.device("cpu"))
    t0 = time.perf_counter()
    metrics = an.train(**analyzer_kw(small))
    Path(out).write_text(json.dumps({
        "losses": an.train_losses, "metrics": metrics,
        "train_s": an.train_s, "wall": time.perf_counter() - t0,
        "threads": torch.get_num_threads()}))
    return 0


def start_cpu_analyzer(small: bool, tmp: str):
    """``cpu_analyzer_worker`` started beside the card's serve_loop work
    (the CPU's 250 steps take about a minute); returns (process, path of
    its JSON) for ``train_analyzers``' comparison."""
    out = f"{tmp}/cpu_analyzer.json"
    return spawn_self("--cpu-analyzer", out, small), out


def spawn_self(flag: str, arg: str, small: bool):
    """This script again as a helper process (``flag arg``, and
    ``--rehearse`` with ``small``), its output piped."""
    cmd = [sys.executable, str(Path(__file__).resolve()), flag, arg] + (
        ["--rehearse"] if small else [])
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def train_analyzers(torch, dev, small: bool, path: str):
    """``TaskAnalyzer.train`` with ``load_analyzer``'s 250 steps on the
    card; the card's analyzer is saved at ``path`` in the reference's
    layout and must load back bit-equal.  Returns (analyzer, its
    metrics) for ``compare_analyzers``."""
    from repro_torch.checkpoint import save
    from repro_torch.core.analyzer import (AnalyzerConfig, TaskAnalyzer,
                                           params_to_tree)
    from repro_torch.launch.serve import load_analyzer

    kw = analyzer_kw(small)
    an = TaskAnalyzer(AnalyzerConfig(), seed=0, device=dev)
    t0 = time.perf_counter()
    metrics = an.train(**kw)
    wall = time.perf_counter() - t0
    log(f"[serve_loop] analyzer trained on {dev}: {kw['steps']} steps "
        f"of batch 128 in {an.train_s:.2f} s ("
        f"{kw['steps'] / an.train_s:.1f} steps/s; train() {wall:.2f} s "
        f"with data and evaluate), final loss "
        f"{an.train_losses[-1]:.4f}, {metrics}")
    save(path, params_to_tree(an.state), {"metrics": metrics})
    back = load_analyzer(path, device=dev)
    check(all(np.array_equal(back.state[k], v) for k, v in an.state.items()),
          "analyzer checkpoint did not load back bit-equal")
    log("[serve_loop] analyzer saved in the reference's layout and loaded "
        "back bit-equal")
    return an, metrics


def compare_analyzers(card, mc: dict, proc, out: str, steps: int):
    """The card's analyzer against the CPU's run of the same training
    (``start_cpu_analyzer``), from the same seeded init: the first 20
    losses within 1e-3 relative, the accuracies within 0.02 and the
    complexity MAE within 0.01 (CUDA's embedding backward sums in
    another order: tolerances, not bits)."""
    text = proc.communicate(timeout=600)[0].decode()[-4000:]
    check(proc.returncode == 0, f"the CPU's analyzer run exited "
                                f"{proc.returncode}:\n{text}")
    cpu = json.loads(Path(out).read_text())
    mh = cpu["metrics"]
    log(f"[serve_loop] analyzer trained on cpu ({cpu['threads']} threads, "
        f"beside the card's work): {steps} steps of batch 128 in "
        f"{cpu['train_s']:.2f} s ({steps / cpu['train_s']:.1f} steps/s; "
        f"train() {cpu['wall']:.2f} s with data and evaluate), final loss "
        f"{cpu['losses'][-1]:.4f}, {mh}")
    a = np.array(card.train_losses[:20])
    b = np.array(cpu["losses"][:20])
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    check(rel <= 1e-3, f"analyzer losses of the first 20 steps differ by "
                       f"{rel:.3g} relative (> 1e-3)")
    for k, tol in (("task_type_acc", 0.02), ("domain_acc", 0.02),
                   ("complexity_mae", 0.01)):
        check(abs(mc[k] - mh[k]) <= tol,
              f"analyzer {k}: card {mc[k]} vs CPU {mh[k]} (tol {tol})")
    log(f"[serve_loop] analyzer card vs CPU: first 20 losses within "
        f"{rel:.3g} relative, metrics within their limits")


def launcher_runs(torch, dev, small: bool, ckpt: str, tmp: str):
    """``repro_torch.launch.serve.main`` at full width in its four modes
    (the default archs on the card), each run's responses checked, the
    launch counts of its main path read, and the card's memory released
    after each."""
    import asyncio

    from repro_torch.core.mres import MRES
    from repro_torch.core.routing import RoutingEngine
    from repro_torch.launch import serve
    from repro_torch.obs import metrics_from_prom
    from repro_torch.serving.async_engine import AsyncServingEngine
    from repro_torch.serving.catalog import build_entry
    from repro_torch.serving.engine import Request

    base = ["--analyzer-ckpt", ckpt] + (["--device", "cpu"] if small else [])
    n_req, max_new = (12, 4) if small else (48, 16)
    # the soak's virtual seconds, cut from 15 to 8, 5 and then 3 to keep
    # the script inside its time limit with the training, sharding and
    # multirank phases
    soak = "3"
    archs = serve.default_archs(dev)
    seen = {}

    def run(tag, *args):
        reset_launches()
        t0 = time.perf_counter()
        out = serve.main(base + list(args))
        wall = time.perf_counter() - t0
        got = read_launches()
        log(f"[serve_loop] launcher {tag}: served in {out['serve_s']:.3f} s "
            f"({wall:.2f} s with the catalog build and analyzer load); "
            f"launches {got}")
        for k, v in got.items():
            seen[k] = seen.get(k, 0) + v
        return out, got

    def served(resps, what):
        for r in resps:
            check(r.served and not r.failed and not r.shed,
                  f"{what}: request {r.request.id} {r.admission} {r.error}")
            check(r.tokens is not None and len(r.tokens) == max_new,
                  f"{what}: request {r.request.id} tokens {r.tokens}")

    def tracker_zero(engine, what):
        load = engine.load
        check(bool((load.queue == 0).all() and (load.inflight == 0).all()),
              f"{what}: load tracker not back at zero ({load.queue}, "
              f"{load.inflight})")

    # -- flat stream, with metrics and trace out
    prom, trace = f"{tmp}/metrics.prom", f"{tmp}/trace.jsonl"
    out, got = run("flat stream", "--requests", str(n_req), "--max-new",
                   str(max_new), "--metrics-out", prom, "--trace-out", trace)
    served(out["responses"], "flat stream")
    parsed = metrics_from_prom(Path(prom).read_text())
    check(len(parsed) > 0, "flat stream: the Prometheus text parsed to nothing")
    by_model = {}
    for r in out["responses"]:
        by_model[r.model] = by_model.get(r.model, 0) + 1
    log(f"[serve_loop] flat stream: {len(out['responses'])} requests served "
        f"per model {by_model}; {len(parsed)} Prometheus series parsed back; "
        f"summary admissions {out['summary']['admissions']}")
    if dev.type == "cuda":
        check(got["router_topk"] >= 1 and got["flash_attention"] > 0,
              f"flat stream: kernels not launched {got}")
    del out
    release(torch, dev, "after the launcher's flat stream")

    # -- batch mode: one decision, equal to the CPU's route_batch fed
    # the same aggregate of the sampled signatures
    # half the stream: batch mode sends every request to one model, and
    # where that is llava-next-mistral-7b, 48 prompts of 2,912 tokens
    # beside the eight configs' weights would outgrow the card
    out, got = run("batch mode", "--mode", "batch", "--requests",
                   str(n_req // 2), "--max-new", str(max_new))
    resps = out["responses"]
    served(resps, "batch mode")
    models = {r.model for r in resps}
    check(len(models) == 1, f"batch mode served {models}")
    agg, prefs = resps[0].sig, resps[0].request.prefs
    cpu_mres = MRES()
    for name in archs:
        cpu_mres.register(build_entry(name))
    cpu_d = RoutingEngine(cpu_mres, device="cpu").route(prefs, agg)
    c = cpu_d.candidates
    tie = len(c) > 1 and c[0][1] - c[1][1] <= 1e-5
    check(cpu_d.model in models or tie,
          f"batch mode: card chose {models}, the CPU {cpu_d.model}")
    log(f"[serve_loop] batch mode: {len(resps)} requests, one model "
        f"{models}, aggregate {agg}; the CPU's route of that aggregate: "
        f"{cpu_d.model} (score {cpu_d.score:.6f})")
    del out, resps
    release(torch, dev, "after the launcher's batch mode")

    # -- async front end, then a few streams on the same engine
    out, got = run("async", "--async", "--requests", str(n_req),
                   "--max-new", str(max_new))
    served(out["responses"], "async")
    check(len(out["responses"]) == n_req and sum(out["windows"]) == n_req
          and max(out["windows"]) <= 8,
          f"async windows {out['windows']} (max_batch 8)")
    tracker_zero(out["engine"], "async")
    aeng = AsyncServingEngine(out["engine"], stream_slots=4,
                              stream_ctx_len=64)
    streams = [Request(text=f"stream request {i} about a python bug " * 2,
                       prefs="balanced", id=1000 + i, max_new=8)
               for i in range(3)]

    async def drive():
        async def one(r):
            return [t async for t in aeng.stream(r)]
        async with aeng:
            return await asyncio.gather(*(one(r) for r in streams))

    toks = asyncio.run(drive())
    check(all(len(t) == 8 for t in toks), f"streams yielded {toks}")
    tracker_zero(out["engine"], "async streams")
    log(f"[serve_loop] async: {n_req} requests in windows {out['windows']}; "
        f"3 streams yielded {[len(t) for t in toks]} tokens")
    del out, aeng
    release(torch, dev, "after the launcher's async run")

    # -- soak, on the card and on the CPU (MicroBatcher is clock-agnostic)
    out, got = run(f"soak {soak}", "--soak", soak)
    tracker_zero(out["engine"], "soak")
    intake = out["intake"]
    windows = out["windows"]
    cpu = serve.main(["--analyzer-ckpt", ckpt, "--device", "cpu", "--soak",
                      soak, "--archs", *archs])
    check(intake == cpu["intake"], f"soak intake {intake} vs the CPU's "
                                   f"{cpu['intake']}")
    tracker_zero(cpu["engine"], "soak on the CPU")
    check(intake["flood"]["rate_limited"] > 0, "flood was not rate-limited")
    for t in ("acme", "globex"):
        check(intake[t]["rate_limited"] == intake[t]["backlog_shed"] == 0,
              f"quiet tenant {t} shed at intake: {intake[t]}")
    failed = sum(k.get("failed", 0) for k in out["tally"].values())
    check(failed == 0, f"soak: {failed} failed responses {out['tally']}")
    log(f"[serve_loop] soak {soak} s: {len(windows)} windows (max "
        f"{max(windows)}), tally {out['tally']}, intake {intake} (equal to "
        f"the CPU run's)")
    del out, cpu
    release(torch, dev, "after the launcher's soak")
    return seen


def batcher_requests(vocab: int, seed: int):
    """12 requests: prompts of 5-100 tokens, max_new 4-24, and one of 120
    tokens that ``submit(truncate=True)`` clips to its limit (ctx - 23
    with max_new 24), whose last tick decodes at pos = ctx."""
    from repro_torch.serving.scheduler import SlotRequest
    rng = np.random.default_rng(seed)
    lens = [5, 100, 37, 64, 12, 88, 120, 23, 51, 9, 76, 30]
    news = [4, 24, 9, 16, 20, 6, 24, 12, 4, 18, 8, 14]
    return [SlotRequest(id=i, tokens=rng.integers(2, vocab, L).astype(
        np.int32), max_new=m) for i, (L, m) in enumerate(zip(lens, news))]


def run_batcher(torch, cfg, params, dev, ctx: int, seed: int, gaps=None):
    """The 12 requests through a 4-slot ``ContinuousBatcher``; with
    ``gaps`` (a dict), each request's top-2 logit gap at every kept
    token is recorded there (prefill, then each decode tick)."""
    from repro_torch.models import model as M
    from repro_torch.serving.scheduler import ContinuousBatcher

    cb = ContinuousBatcher(cfg, params, slots=4, ctx_len=ctx, device=dev)
    reqs = batcher_requests(cfg.vocab_size, seed)
    for r in reqs:
        cb.submit(r, truncate=True)
    orig_prefill, orig_decode = M.prefill, cb._decode

    def gap(row):
        """The top-2 logit gap over max(1, max |logit|)."""
        top2 = torch.topk(row.float(), 2).values
        return float(top2[0] - top2[1]) / max(1.0, float(row.abs().max()))
    if gaps is not None:
        def prefill(*a, **kw):
            last, cache, pos = orig_prefill(*a, **kw)
            req = cb.active[[i for i, r in enumerate(cb.active)
                             if r is not None and r.slot == -1][0]]
            gaps[req.id] = [gap(last[0])]
            return last, cache, pos

        def decode(params_, cache, batch):
            logits, nxt, cache = orig_decode(params_, cache, batch)
            for i, r in enumerate(cb.active):
                if r is not None and len(r.out) + 1 < r.max_new:
                    gaps[r.id].append(gap(logits[i]))
            return logits, nxt, cache
        M.prefill, cb._decode = prefill, decode
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        done = cb.run_until_drained()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        M.prefill = orig_prefill
    return cb, reqs, done, wall


def batcher_phase(torch, dev, small: bool, kernels, rows):
    """The continuous batcher at full width and depth (4 slots, ctx 128,
    12 requests) on llama3.2-1b, mamba2-1.3b and gemma2-2b: every request
    gets max_new tokens, and the launches are exact (one flash_attention
    decode per attention layer per tick, one prefill and one ssd_scan per
    layer per admission).  Then full width, 2 layers, f32: the card's
    tokens equal the CPU batcher's up to each request's first near-tie
    on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import model as M
    from repro_torch.serving.runner import ModelRunner

    ctx = 128
    for i, name in enumerate(BATCHER_ARCHS):
        cfg = get_smoke(name) if small else get_config(name)
        runner = ModelRunner(cfg, seed=41 + i, device=dev)
        run_batcher(torch, cfg, runner.params, dev, ctx, seed=3)   # warm-up
        reset_launches()
        cb, reqs, done, wall = run_batcher(torch, cfg, runner.params, dev,
                                           ctx, seed=3)
        got = read_launches()
        check(len(done) == 12 and all(len(r.out) == r.max_new for r in done),
              f"batcher {name}: {[(r.id, len(r.out)) for r in done]}")
        check(len(reqs[6].tokens) == ctx - 23, "the clipped prompt")
        check(int(cb.pos.max()) >= ctx, f"batcher {name}: no tick at pos = "
                                        f"C ({cb.pos})")
        n_attn = cfg.n_layers if cfg.has_attention else 0
        want = {"flash_attention": n_attn * (cb.ticks + 12),
                "flash_attention_decode": n_attn * cb.ticks,
                "ssd_scan": cfg.n_layers * 12 if cfg.has_ssm else 0}
        if dev.type == "cuda":
            have = {k: got[k] for k in want}
            check(have == want, f"batcher {name}: launches {have}, want "
                                f"{want} ({cb.ticks} ticks, 12 admissions)")
        toks = sum(r.max_new for r in done)
        log(f"[serve_loop] batcher {name} ({cfg.n_layers} layers, "
            f"{cfg.compute_dtype}): 12 requests through 4 slots of ctx {ctx} "
            f"in {cb.ticks} ticks, {wall:.3f} s ({wall / cb.ticks * 1e3:.2f} "
            f"ms a tick with its admissions, {toks / wall:.1f} tokens/s); "
            f"launches {got}")
        for key, kind in (("decode", "flash_attention_decode"),
                          ("prefill", "flash_attention"),
                          ("scan", "ssd_scan")):
            row = rows.get((name, key))
            if row is not None:
                n = got[kind] - (got["flash_attention_decode"]
                                 if key == "prefill" else 0)
                check(n > 0 or dev.type != "cuda",
                      f"batcher {name}: {key} never launched")
                kernels[row["name"]] = dict(row, launches=n)
        del runner, cb
        release(torch, dev, f"after the batcher on {name}")
    # full width, 2 layers, f32: card against CPU
    for name in BATCHER_ARCHS:
        base = get_smoke(name) if small else get_config(name)
        cfg = dataclasses.replace(base, n_layers=2, compute_dtype="float32")
        params = M.init_params(cfg, torch.Generator().manual_seed(13), "cpu")
        gaps = {}
        _, _, want, _ = run_batcher(torch, cfg, params, torch.device("cpu"),
                                    ctx, seed=4, gaps=gaps)
        _, _, got, _ = run_batcher(torch, cfg, params, dev, ctx, seed=4)
        want = {r.id: r.out for r in want}
        compared = 0
        for r in got:
            for j, (a, b) in enumerate(zip(r.out, want[r.id])):
                if gaps[r.id][j] < 1e-3:
                    break                        # near-tie on the CPU
                check(a == b, f"batcher {name} request {r.id} token {j}: "
                              f"card {a}, CPU {b}")
                compared += 1
        log(f"[serve_loop] batcher card vs CPU {name} (full width, 2 layers, "
            f"f32): {compared} of {sum(len(o) for o in want.values())} "
            f"tokens compared, all equal")
        release(torch, dev, f"after the batcher's card vs CPU on {name}")


def batcher_kernel_rows(torch, dev, small: bool):
    """The kernel shapes new with the batcher, each against its plain
    version and timed: flash_attention's joint decode over 4 slots of a
    128-slot cache (live counts ragged, one slot idle at C) and its B = 1
    prefill at a ragged prompt of 100 (llama3.2-1b), and ssd_scan at B =
    1, L = 100 as served (mamba2-1.3b, bf16 strided views, no h0)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS

    g = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    llama = get_smoke("llama3.2-1b") if small else get_config("llama3.2-1b")
    iters = 4 if small else 20
    rows[("llama3.2-1b", "decode")] = window_attn_row(
        torch, FA, g, dev, llama, 4, 1, 128, [128, 77, 106, 9],
        dict(causal=False), "batcher decode B=4 C=128 (llama3.2-1b)", iters)
    rows[("llama3.2-1b", "prefill")] = window_attn_row(
        torch, FA, g, dev, llama, 1, 100, 100, None, dict(causal=True),
        "batcher prefill B=1 L=100 (llama3.2-1b)", iters)
    m = get_smoke("mamba2-1.3b") if small else get_config("mamba2-1.3b")
    H, P, N, ch, L = m.ssm_heads, m.ssm_head_dim, m.ssm_state, m.ssm_chunk, 100

    def rn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dt)
    xbc = rn(1, L, H * P + 2 * N, dt=torch.bfloat16)
    dt = torch.rand(1, L, H, generator=g, device=dev) * 0.5
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    args = (xbc[..., :H * P].unflatten(-1, (H, P)), dt, A,
            xbc[..., H * P:H * P + N], xbc[..., H * P + N:], None)
    err = 0.0
    for a, b in zip(SS.ssd_scan(*args, chunk=ch),
                    SS.ssd_scan_plain(*args, chunk=ch)):
        e = float((a - b).abs().max())
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        check(e <= tol, f"ssd_scan B=1 L={L}: max |err| {e} > {tol}")
        err = max(err, e)
    nb = (2 * (L * H * P + 2 * L * N) + 4 * L * H + 4 * H + 4 * L * H * P
          + 4 * H * P * N)
    bms, by = bound_ms(nb, ssd_ops(1, L, H, P, N, ch, False, False),
                       PEAK_BF16_S)
    rows[("mamba2-1.3b", "scan")] = dict(
        name=f"ssd_scan batcher prefill B=1 L={L} (mamba2-1.3b)",
        route="cuda", source=SCAN_SRC, replaces=SCAN_TPU, max_abs_err=err,
        ms=time_graph_ms(torch, lambda: SS.ssd_scan(*args, chunk=ch), dev,
                         iters=iters),
        plain_ms=time_ms(torch, lambda: SS.ssd_scan_plain(*args, chunk=ch),
                         dev, iters=max(2, iters // 4), warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None)
    r = rows[("mamba2-1.3b", "scan")]
    log(f"[serve_loop] {r['name']}: H={H} P={P} N={N} chunk {ch}: "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}), bound {bms:.4g} by "
        f"{by}, max err {err:.3g}; no single PyTorch call computes the scan")
    return rows


def merging_phase(torch, dev, small: bool, analyzer, tmp: str):
    """Two llama3.2-1b runners at full width and depth (seeds 0 and 1) in
    entries of complementary domains, ``merge_threshold=10.0``: the soup
    registers and the route step sees N + 1 entries, one soup tensor has
    the bits of the same soup on the CPU, the soup runner generates;
    then one full-width runner saved, loaded back, the same tokens."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.merging import soup
    from repro_torch.core.mres import MRES, ModelEntry
    from repro_torch.core.orchestrator import OptiRoute
    from repro_torch.data.workload import make_workload
    from repro_torch.serving.runner import ModelRunner

    cfg = get_smoke("llama3.2-1b") if small else get_config("llama3.2-1b")
    runners = [ModelRunner(cfg, seed=s, device=dev) for s in (0, 1)]
    mres = MRES()
    for name, acc, lat, dom, r in (("legal-weak", 0.4, 50, "legal",
                                    runners[0]),
                                   ("general-strong", 0.95, 40, "general",
                                    runners[1])):
        raw = {"accuracy": acc, "latency_ms": lat, "cost_per_mtok": 1.0,
               **{m: 0.5 for m in ("helpfulness", "harmlessness", "honesty",
                                   "steerability", "creativity")}}
        mres.register(ModelEntry(name=name, raw_metrics=raw,
                                 task_types=("summarization",),
                                 domains=(dom,), family="dense",
                                 n_params=cfg.n_params(), runner=r))
    router = OptiRoute(mres, analyzer, merge_threshold=10.0, device=dev)
    text = make_workload(1, seed=14, task_type="summarization",
                         domain="legal")[0].text
    t0 = time.perf_counter()
    rq = router.route(text, "balanced")
    merge_s = time.perf_counter() - t0
    soups = [e for e in mres.entries if e.name.startswith("soup:")]
    check(len(soups) == 1 and len(mres) == 3,
          f"merging: entries {[e.name for e in mres.entries]} after "
          f"routing {rq.sig} to {rq.model}")
    check(rq.model == soups[0].name,
          f"merging: the re-route chose {rq.model}, not the soup")
    alpha = soups[0].meta["alpha"]
    key = lambda p: p["layers"][0]["attn"]["wq"]
    want = soup([{"w": key(r.params).cpu()} for r in runners],
                [alpha, 1 - alpha])["w"]
    got = key(soups[0].runner.params).cpu()
    check(torch.equal(got, want), "merging: soup tensor differs from the CPU")
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    res = soups[0].runner.generate(toks, 8)
    check(res.tokens.shape == (2, 8) and bool(
        np.isfinite(res.logits_last).all()), "merging: soup generate")
    log(f"[serve_loop] merging: {soups[0].name} registered (N 2 -> "
        f"{len(mres)}), the re-route chose it; route + merge {merge_s:.2f} s "
        f"(the soup of two {cfg.n_params() / 1e9:.2f}B-parameter "
        f"{cfg.compute_dtype} runners on {dev}); its layers.0.wq equals the "
        f"CPU soup bit for bit; it generated {res.tokens.shape}")
    path = f"{tmp}/runner.npz"
    want_toks = runners[1].generate(toks, 8).tokens
    t0 = time.perf_counter()
    runners[1].save_checkpoint(path)
    save_s = time.perf_counter() - t0
    size = Path(path).stat().st_size
    t0 = time.perf_counter()
    back = ModelRunner.from_checkpoint(cfg, path, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    check(np.array_equal(back.generate(toks, 8).tokens, want_toks),
          "merging: a loaded runner generates other tokens")
    log(f"[serve_loop] runner checkpoint ({cfg.name}, {cfg.n_layers} layers): "
        f"{size / 1e9:.3f} GB, saved in {save_s:.2f} s, loaded onto {dev} in "
        f"{load_s:.2f} s, the same tokens")
    del runners, mres, router, soups, back
    Path(path).unlink()


def serve_loop_phase(torch, dev, small: bool, kernels):
    """The service loop of ``repro_torch.launch.serve`` on the card:
    analyzer training, the launcher in its four modes, the continuous
    batcher, and merging with runner checkpoints."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/analyzer.npz"
        proc, out = start_cpu_analyzer(small, tmp)
        try:
            analyzer, metrics = train_analyzers(torch, dev, small, ckpt)
            seen = launcher_runs(torch, dev, small, ckpt, tmp)
            if dev.type == "cuda":
                for k in ("router_topk", "flash_attention", "ssd_scan"):
                    check(seen[k] > 0,
                          f"launcher: {k} never launched ({seen})")
                for k in bwd_kernels():     # serving differentiates nothing
                    check(seen[k] == 0, f"launcher: {k} launched ({seen})")
            rows = batcher_kernel_rows(torch, dev, small)
            batcher_phase(torch, dev, small, kernels, rows)
            merging_phase(torch, dev, small, analyzer, tmp)
            compare_analyzers(analyzer, metrics, proc, out,
                              analyzer_kw(small)["steps"])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    release(torch, dev, "after the serve_loop phase")
    log(f"[serve_loop] phase time {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# training: the backward kernels, train steps on the card, card vs CPU
# ----------------------------------------------------------------------

TRAIN_ARCHS = ["llama3.2-1b", "mamba2-1.3b", MOE_ARCH]
# (config, batch) trained whole after TRAIN_ARCHS, at L=1024 for 1
# warm-up and 3 timed steps: gemma2-2b at B=4 (B=8's step needs 88.7 GB
# by the dry run: 31.9 GB of f32 params and AdamW state, 56.8 traced)
TRAIN_WHOLE = [("gemma2-2b", 4), ("seamless-m4t-medium", 8),
               ("hymba-1.5b", 8), ("h2o-danube-3-4b", 8),
               ("qwen2-1.5b", 8)]


def bwd_kernels():
    """The three backward wrappers, by the name of their kernels line."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gating as MG
    from repro_torch.kernels import ssd_scan as SS
    return {"flash_attention_bwd": FA.flash_attention_bwd,
            "ssd_scan_bwd": SS.ssd_scan_bwd,
            "moe_gating_bwd": MG.moe_gating_bwd}


def grads_close(got, want, tol: float, what: str) -> float:
    """Each of ``got`` within ``tol`` of its ``want``'s max |value|;
    returns the worst error as that fraction."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(b.float().abs().max()), 1e-30)
        err = float((a.float() - b.float()).abs().max()) / scale
        check(err <= tol, f"{what}: gradient {i} off by {err:.3g} of its "
                          f"max |g| > {tol}")
        worst = max(worst, err)
    return worst


def attn_live_pairs(B: int, L: int, Lk: int, causal: bool,
                    window: int) -> int:
    """(query, key) pairs a mask lets through, per head."""
    if not causal:
        return B * L * Lk
    row = np.arange(L) + (Lk - L)
    live = np.minimum(row + 1, window) if window else row + 1
    return B * int(np.maximum(live, 0).sum())


def fwd_lse_check(torch, FA, q, k, v, tol, what, **kw):
    """The training forward (``return_lse``) against the plain version on
    the same operands: o within ``tol`` * (1 + |want|), lse within 1e-5
    * (1 + |want|) with +inf (no live key) on the same rows.  Returns the
    kernel's (o, lse), the plain version's (o, lse) and the max abs
    errors of o and of lse."""
    o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    o_p, lse_p = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    check(o.dtype == o_p.dtype and o.shape == o_p.shape
          and lse.dtype == lse_p.dtype and lse.shape == lse_p.shape,
          f"{what}: forward outputs {o.dtype} {tuple(o.shape)}, lse "
          f"{lse.dtype} {tuple(lse.shape)}")
    diff = (o.float() - o_p.float()).abs()
    over = float((diff - tol * (1 + o_p.float().abs())).max())
    check(over <= 0, f"{what}: forward o exceeds {tol} * (1 + |want|) by "
                     f"{over}")
    fin = torch.isfinite(lse_p)
    check(torch.equal(torch.isfinite(lse), fin),
          f"{what}: lse is +inf on other rows than the plain version's")
    ldiff = (lse - lse_p).abs().where(fin, torch.zeros_like(lse))
    lover = float((ldiff - 1e-5 * (1 + lse_p.abs().where(
        fin, torch.zeros_like(lse)))).max())
    check(lover <= 0, f"{what}: lse exceeds 1e-5 * (1 + |want|) by {lover}")
    return (o, lse), (o_p, lse_p), float(diff.max()), float(ldiff.max())


def attn_bwd_row(torch, FA, g, dev, small, what, B, L, Lk, Hq, Hkv, hd,
                 causal, window=0, softcap=0.0, body="wgmma", beside=None):
    """The attention backward at one training shape.  First the training
    forward (o and lse) against the plain forward on the same inputs
    (o within 2e-2 * (1 + |want|) in bf16, 1e-4 in f32; lse within 1e-5
    * (1 + |want|)); then the backward kernel, fed the kernel's o and lse,
    against the plain backward, fed the plain forward's: bf16 within 2e-2
    of each gradient's max (bf16 gradients), timed against its bound and
    SDPA's backward (no softcap), each of its three launches timed from a
    profiler trace; f32 at a quarter of the length within 1e-4.  The bf16
    run must take ``body`` (``FA.bwd_body``, and on the card the
    wrapper's count of that body), the f32 run the f32 body.  ``beside``:
    another body that takes the same bf16 operands (the hd-288 ``"mma"``
    body), launched through the C entry point on the same inputs, held
    to the plain backward as well and timed in the same way (its launches
    are not counted)."""
    import torch.nn.functional as F

    def inputs(dt, L_, Lk_):
        q = torch.randn(B, L_, Hq, hd, generator=g, device=dev).to(dt)
        k = torch.randn(B, Lk_, Hkv, hd, generator=g, device=dev).to(dt)
        v = torch.randn(B, Lk_, Hkv, hd, generator=g, device=dev).to(dt)
        do = torch.randn(B, L_, Hq, hd, generator=g, device=dev).to(dt)
        return [t.transpose(1, 2) for t in (q, k, v, do)]
    kw = dict(causal=causal, window=window, softcap=softcap)
    # f32, shorter
    Lf, Lkf = max(L // 4, 2), (max(Lk // 4, 2) if causal else Lk)
    by_body = FA.flash_attention_bwd.launches_by_body

    def took(want, fn):
        before = dict(by_body)
        out = fn()
        ran = [b for b, n in by_body.items() if n != before[b]]
        check(dev.type != "cuda" or ran == [want],
              f"flash_attention_bwd {what}: ran the {ran} body, want "
              f"{want}")
        return out
    q, k, v, do = inputs(torch.float32, Lf, Lkf)
    check(FA.bwd_body(q, k, v, do) == "f32",
          f"{what}: f32 operands name the {FA.bwd_body(q, k, v, do)} body")
    (o, lse), (o_p, lse_p), _, _ = fwd_lse_check(
        torch, FA, q, k, v, 1e-4, f"flash_attention {what} f32", **kw)
    err32 = grads_close(took("f32", lambda: FA.flash_attention_bwd(
                            q, k, v, o, lse, do, **kw)),
                        FA.flash_attention_bwd_plain(q, k, v, o_p, lse_p,
                                                     do, **kw),
                        1e-4, f"flash_attention_bwd {what} f32")
    q, k, v, do = inputs(torch.bfloat16, L, Lk)
    check(FA.bwd_body(q, k, v, do) == body,
          f"{what}: the rule names the {FA.bwd_body(q, k, v, do)} body, "
          f"want {body}")
    (o, lse), (o_p, lse_p), o_err, lse_err = fwd_lse_check(
        torch, FA, q, k, v, 2e-2, f"flash_attention {what} bf16", **kw)
    got = took(body, lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw))
    want = FA.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, **kw)
    del o_p, lse_p
    err = grads_close(got, want, 2e-2, f"flash_attention_bwd {what} bf16")
    abs_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {what}: two launches differ")
    other = None
    if beside is not None and dev.type == "cuda":
        from repro_torch.kernels import build

        clib = build.load("flash_attention", FA._SIG)

        def launch_beside():
            return FA._bwd_launch(
                clib, torch.cuda.current_stream(dev).cuda_stream, q, k, v, o,
                lse, do, None, causal, window, softcap, beside)
        err_b = grads_close(launch_beside(), want, 2e-2,
                            f"flash_attention_bwd {what} bf16 {beside} body")
        other = (time_graph_ms(torch, launch_beside, dev, iters=3), err_b)
    del got, want, again
    pairs = attn_live_pairs(B, L, Lk, causal, window) * Hq
    nb = 2 * (3 * B * L * Hq * hd + 2 * B * Lk * Hkv * hd) + 4 * B * Hq * L \
        + 2 * (B * L * Hq * hd + 2 * B * Lk * Hkv * hd)
    bms, by = bound_ms(nb, 10.0 * hd * pairs, PEAK_BF16_S)
    ms = time_graph_ms(torch, lambda: FA.flash_attention_bwd(
        q, k, v, o, lse, do, **kw), dev, iters=3 if not small else 2)
    parts = kernel_times(torch, dev, lambda: FA.flash_attention_bwd(
        q, k, v, o, lse, do, **kw), iters=2)
    design, _ = bound_ms(nb, 14.0 * hd * pairs, PEAK_BF16_S)
    plain = time_ms(torch, lambda: FA.flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), dev, iters=2, warmup=1)
    lib = None
    if not softcap and dev.type == "cuda":
        qs, ks, vs = (t.detach().contiguous().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if causal and window:
            row = torch.arange(L, device=dev)[:, None] + (Lk - L)
            col = torch.arange(Lk, device=dev)[None]
            mask = (col <= row) & (col > row - window)
        sk = dict(attn_mask=mask) if mask is not None else \
            dict(is_causal=causal)
        out = sdpa_call(torch, qs, ks, vs, **sk)()
        dos = do.contiguous()
        # eager (autograd's call is not captured): the least of three
        # means of 3 calls, the host's noise kept out of the yardstick
        lib = min(time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), dos, retain_graph=True), dev, iters=3,
            warmup=1) for _ in range(3))
        del out, qs, ks, vs
    log(f"[train_kernels] flash_attention_bwd {what}: B={B} L={L} Lk={Lk} "
        f"{Hq}/{Hkv} heads of {hd}, causal={causal} window={window} "
        f"softcap={softcap}, {body} body: {ms:.3f} ms ("
        + ("" if other is None else
           f"the {beside} body beside it {other[0]:.3f} ms, max err "
           f"{other[1]:.3g} of max |g|; ")
        + f"plain {plain:.3f}, "
        f"SDPA backward {'n/a' if lib is None else f'{lib:.3f}'}), bound "
        f"{bms:.4f} by {by} ({pairs / 1e9:.3f} G live pairs x heads; the "
        f"design's 14 hd a pair {design:.4f}); launches: {fmt_times(parts)}; "
        f"max err {err:.3g} of max |g| bf16 (tol 2e-2), {err32:.3g} f32 "
        f"(tol 1e-4); forward against the plain one: o {o_err:.3g}, lse "
        f"{lse_err:.3g} (abs)")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, body=body,
                launch_ms={k: round(v, 4) for k, v in parts.items()},
                **({} if other is None else {f"{beside}_ms": other[0]}))


def ssd_bwd_ops(Bb, L, H, P, N) -> float:
    """Operations the scan backward needs (multiply-adds x 2), counted as
    ``ssd_ops`` counts the forward's, over chunks of 64 (c the chunk's
    length, tri = c(c+1)/2 its causal pairs).  Per (batch, chunk): C B^T
    over the causal pairs, 2 tri N, once for all heads.  Per (batch,
    chunk, head): dy x^T and dx over the causal pairs, 2 tri P each, dB
    and dC over them, 2 tri N each; with the state entering the chunk
    (none in the first: no h0) dC's and C h_in's products, 2 c P N each,
    and the reverse pass folding the chunk into dh, 2 c P N; with the
    gradient of the state leaving it (none in the last: no final-state
    gradient) dx's and dB's products, 2 c P N each, and the forward pass
    folding the chunk into the state, 2 c P N."""
    Q = 64
    nb = -(-L // Q)
    ops = 0.0
    for i, c0 in enumerate(range(0, L, Q)):
        c = min(Q, L - c0)
        tri = c * (c + 1) / 2
        per_head = 4.0 * tri * (P + N)
        per_head += (int(i > 0) + int(i < nb - 1)) * 6.0 * c * P * N
        ops += Bb * (2.0 * tri * N + H * per_head)
    return ops


def ssd_bwd_row(torch, SS, g, dev, what, Bb, L, H, P, N):
    """The scan backward at a training shape: bf16 strided views as the
    layer hands them over, against the plain backward (2e-2 of each
    gradient's max: bf16 gradients), timed; f32 at a quarter of the
    length (1e-4)."""
    def inputs(dt_, L_):
        xbc = torch.randn(Bb, L_, H * P + 2 * N, generator=g,
                          device=dev).to(dt_)
        x = xbc[..., :H * P].unflatten(-1, (H, P))
        dt = torch.rand(Bb, L_, H, generator=g, device=dev) * 0.1
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        dy = torch.randn(Bb, L_, H, P, generator=g, device=dev)
        return x, dt, A, xbc[..., H * P:H * P + N], xbc[..., H * P + N:], dy
    args = inputs(torch.float32, max(L // 4, 2))
    err32 = grads_close(SS.ssd_scan_bwd(*args), SS.ssd_scan_bwd_plain(*args),
                        1e-4, f"ssd_scan_bwd {what} f32")
    args = inputs(torch.bfloat16, L)
    got, want = SS.ssd_scan_bwd(*args), SS.ssd_scan_bwd_plain(*args)
    err = grads_close(got, want, 2e-2, f"ssd_scan_bwd {what} bf16")
    abs_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
    again = SS.ssd_scan_bwd(*args)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ssd_scan_bwd {what}: two launches differ")
    del got, want, again
    nb = 2 * (Bb * L * H * P + 2 * Bb * L * N) + 4 * (Bb * L * H + H) \
        + 4 * Bb * L * H * P + 2 * (Bb * L * H * P + 2 * Bb * L * N) \
        + 4 * (Bb * L * H + H)
    ops = ssd_bwd_ops(Bb, L, H, P, N)
    bms, by = bound_ms(nb, ops, PEAK_BF16_S)
    ms = time_graph_ms(torch, lambda: SS.ssd_scan_bwd(*args), dev, iters=3)
    plain = time_ms(torch, lambda: SS.ssd_scan_bwd_plain(*args), dev,
                    iters=2, warmup=1)
    parts = kernel_times(torch, dev, lambda: SS.ssd_scan_bwd(*args), iters=2)
    log(f"[train_kernels] ssd_scan_bwd {what}: Bb={Bb} L={L} H={H} P={P} "
        f"N={N}, bf16 views: {ms:.3f} ms (plain {plain:.3f}), bound "
        f"{bms:.4f} by {by} ({ops / 1e9:.1f} GFLOP, {nb / 1e6:.0f} MB); "
        f"max err {err:.3g} of max |g| bf16 (tol 2e-2), {err32:.3g} f32 "
        f"(tol 1e-4); launches: {fmt_times(parts)}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)


def gate_bwd_row(torch, MG, g, dev, T, E, k):
    """The gate backward at qwen3-moe-30b-a3b's training gate (bf16
    logits as the router's product gives them), against the plain
    backward (1e-5 of max |dlogits|: f32 arithmetic on both sides), with
    tied rows; f32 logits too; one ``gate_bwd_kernel`` launch a call (a
    row to 16 lanes of a warp at E = 128); a sweep of E 8, 160 and 1024 at
    k 1 and 8 (16 lanes, a warp, a warp); timed
    against its bound and against autograd through softmax + topk (the
    PyTorch yardstick)."""
    errs = {}
    for E_, k_, dt in ((8, 1, torch.float32), (160, 8, torch.bfloat16),
                       (1024, 8, torch.float32), (1024, 1, torch.bfloat16)):
        lg = torch.randn(333, E_, generator=g, device=dev).to(dt)
        _, idx, _, asum = MG.moe_gating_plain(lg, k_, True)
        dv = torch.randn(333, k_, generator=g, device=dev)
        da = torch.tensor(0.37, device=dev)
        got = MG.moe_gating_bwd(lg, idx, dv, da, asum)
        want = MG.moe_gating_bwd_plain(lg, idx, dv, da, asum)
        f64 = MG.moe_gating_bwd_plain(lg.double(), idx, dv.double(),
                                      da.double(), asum.double())
        # k = 1 cancels two nearly equal terms: held to f64 within twice
        # the plain f32 version's own error there
        m = float(want.float().abs().max())
        own = float((want.double() - f64).abs().max())
        err = float((got.double() - f64).abs().max())
        lim = (max(1e-5 * m, 2 * own) if dt == torch.float32 else
               1e-2 * m)
        check(err <= lim, f"moe_gating_bwd E={E_} k={k_} {dt}: error "
                          f"{err:.3g} against f64 above {lim:.3g}")
        check(torch.equal(got, MG.moe_gating_bwd(lg, idx, dv, da, asum)),
              f"moe_gating_bwd E={E_} k={k_}: two launches differ")
    for dt in (torch.float32, torch.bfloat16):
        lg = (torch.randn(T, E, generator=g, device=dev) * 2).to(dt)
        lg[:4, :16] = 0.5                       # tied probabilities
        vals, idx, aux, asum = MG.moe_gating(lg, k, return_asum=True)
        _, _, _, asum2 = MG.moe_gating_plain(lg, k, True)
        check(torch.equal(asum, asum2), "moe_gating: asum differs from the "
                                        "plain version's")
        dv = torch.randn(T, k, generator=g, device=dev)
        da = torch.tensor(0.37, device=dev)
        got = MG.moe_gating_bwd(lg, idx, dv, da, asum)
        want = MG.moe_gating_bwd_plain(lg, idx, dv, da, asum)
        tol = 1e-5 if dt == torch.float32 else 1e-2
        errs[str(dt)[6:]] = grads_close([got], [want], tol,
                                        f"moe_gating_bwd {str(dt)[6:]}")
        abs_err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, MG.moe_gating_bwd(lg, idx, dv, da, asum)),
              "moe_gating_bwd: two launches differ")
    nb = 2 * T * E + 4 * T * k * 2 + 4 * E + 4 + 2 * T * E
    ops = 8.0 * T * E + 6.0 * T * k
    bms, by = bound_ms(nb, ops, PEAK_FP32_S)
    ms = time_graph_ms(torch, lambda: MG.moe_gating_bwd(lg, idx, dv, da,
                                                        asum), dev)
    plain = time_ms(torch, lambda: MG.moe_gating_bwd_plain(
        lg, idx, dv, da, asum), dev)
    launch = one_launch(torch, dev, lambda: MG.moe_gating_bwd(
        lg, idx, dv, da, asum), ("gate_bwd_kernel",), "moe_gating_bwd")
    lib = None
    if dev.type == "cuda":
        leaf = lg.detach().float().requires_grad_()
        p = torch.softmax(leaf, dim=-1)
        r = p.gather(1, idx.long())
        out = r / (r.sum(-1, keepdim=True) + 1e-9)
        lib = time_ms(torch, lambda: torch.autograd.grad(
            out, leaf, dv, retain_graph=True), dev)
        del out, leaf
    log(f"[train_kernels] moe_gating_bwd T={T} E={E} k={k} bf16: {ms:.4f} "
        f"ms (plain {plain:.4f}, autograd through softmax + gather "
        f"{'n/a' if lib is None else f'{lib:.4f}'}), bound {bms:.5f} by "
        f"{by}; max err of max |g|: f32 {errs['float32']:.3g} (tol 1e-5), "
        f"bf16 {errs['bfloat16']:.3g} (tol 1e-2); "
        f"asum equal to the plain version's; the sweep (E 8-1024, k 1 and "
        f"8) held to f64; {launch}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def bf16_step_vs_plain(torch, dev, small: bool):
    """One bf16 train step's gradients of gemma2-2b (full width, 2
    layers, B=2, L=1024; f32 master params) with the attention backward
    on the card's kernel against the same step, same params and batch,
    with ``flash_attention_bwd_plain`` as its backward: every gradient
    leaf within 2e-2 of its max |g| (the attention's gradients are bf16
    on both sides; they differ in rounding), loss equal.  The kernel
    step's attention backward launches are one a layer, all on the
    wgmma body."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_lm_sampler, to_device
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.steps import loss_and_grads

    name = "gemma2-2b"
    cfg = dataclasses.replace(get_smoke(name) if small else
                              get_config(name), n_layers=2)
    B, L = (2, 64) if small else (2, 1024)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(5),
                           device=dev)
    batch = to_device(make_lm_sampler(np.random.default_rng(5), cfg)(B, L),
                      dev)
    by = FA.flash_attention_bwd.launches_by_body
    before = dict(by)
    got = loss_and_grads(params, cfg, batch)
    ran = {b: n - before[b] for b, n in by.items()}
    check(dev.type != "cuda" or ran == {b: cfg.n_layers * (b == "wgmma")
                                        for b in ran},
          f"{name} bf16 step: attention backward launches by body {ran}, "
          f"want {cfg.n_layers} on wgmma")
    kernel = ops._flash_bwd_kernel
    ops._flash_bwd_kernel = FA.flash_attention_bwd_plain
    try:
        want = loss_and_grads(params, cfg, batch)
    finally:
        ops._flash_bwd_kernel = kernel
    check(abs(float(got[1]) - float(want[1])) <= 1e-6 * abs(float(want[1])),
          f"{name} bf16 step: loss {float(got[1])} vs {float(want[1])} "
          "with the plain backward (the same forward)")
    gl, wl = leaves(got[3]), leaves(want[3])
    worst = grads_close(gl, wl, 2e-2, f"{name} bf16 step gradients")
    log(f"[train_kernels] {name} bf16 train step (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, B={B}, L={L}) against the same step with "
        f"flash_attention_bwd_plain: {len(gl)} gradient leaves, worst "
        f"{worst:.3g} of its max |g| (tol 2e-2); attention backward "
        f"launches {ran}; {time.perf_counter() - t0:.1f} s")
    del params, got, want


def train_kernel_phase(torch, dev, small: bool):
    """Each backward kernel against its plain backward on the card at
    the training shapes of the zoo, timed (CUDA graph, CUDA events)
    against its bound; the attention rows beside SDPA's backward where
    no softcap is involved."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gating as MG
    from repro_torch.kernels import ssd_scan as SS

    g = torch.Generator(device=dev).manual_seed(23)
    B, L = (2, 96) if small else (8, 1024)
    rows = {}
    rows["llama"] = attn_bwd_row(torch, FA, g, dev, small, "llama3.2-1b", B,
                                 L, L, 32, 8, 64, True)
    if not small:
        attn_bwd_row(torch, FA, g, dev, small, "qwen3-moe-30b-a3b", B, L, L,
                     32, 4, 128, True)
        for win in (4096, 0):
            attn_bwd_row(torch, FA, g, dev, small,
                         f"gemma2-2b {'local' if win else 'global'}", B, L,
                         L, 8, 4, 288, True, win, 50.0, beside="mma")
        attn_bwd_row(torch, FA, g, dev, small, "h2o-danube-3-4b", B, L, L,
                     32, 8, 120, True, 4096)
    attn_bwd_row(torch, FA, g, dev, small, "seamless-m4t-medium cross", B,
                 min(L, 512), 16, 16, 16, 64, False)
    rows["mamba2"] = ssd_bwd_row(torch, SS, g, dev, "mamba2-1.3b", B, L,
                                 *((8, 64, 16) if small else (64, 64, 128)))
    ssd_bwd_row(torch, SS, g, dev, "hymba-1.5b branch", B, L,
                *((5, 64, 16) if small else (50, 64, 16)))
    gate = gate_bwd_row(torch, MG, g, dev, *((256, 128, 8) if small
                                              else (B * L, 128, 8)))
    bf16_step_vs_plain(torch, dev, small)
    src = "src/repro_torch/kernels/csrc/"
    out = {}
    for name, row, source, replaces in (
            ("flash_attention_bwd", rows["llama"], "flash_attention_bwd.cuh",
             "src/repro/kernels/flash_attention.py:87"),
            ("ssd_scan_bwd", rows["mamba2"], "ssd_scan_bwd.cuh",
             "src/repro/kernels/ssd_scan.py:75"),
            ("moe_gating_bwd", gate, "moe_gating_bwd.cuh",
             "src/repro/kernels/moe_gating.py:58")):
        out[name] = dict(name=name, route="cuda", source=src + source,
                         replaces=replaces, launches=0, **row)
    return out


def train_configs(small: bool):
    """(name, config, batch, seq, warm-up steps, timed steps) of the
    ``train`` phase, bf16 compute, f32 master params, L=1024:
    llama3.2-1b and mamba2-1.3b at full width and depth, qwen3-moe-30b-a3b
    at full width on 2 of its 48 layers (its f32 AdamW state would be
    ~490 GB whole), B=8, 2 warm-up and 8 timed steps; then each of
    ``TRAIN_WHOLE`` at full width and depth, 1 warm-up and 3 timed
    steps."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    out = []
    for name, B, warm, steps in ([(n, 8, 2, 8) for n in TRAIN_ARCHS] +
                                 [(n, B, 1, 3) for n, B in TRAIN_WHOLE]):
        cfg = get_smoke(name) if small else get_config(name)
        if name == MOE_ARCH:
            cfg = dataclasses.replace(cfg, n_layers=2)
        out.append((name, cfg) + ((2, 64, 1, 2) if small else
                                  (B, 1024, warm, steps)))
    return out


def traced_step_peak(torch, cfg, batch) -> int:
    """The dry run's traced peak of a train step of ``cfg`` on ``batch``'s
    shapes on one card (``dryrun.trace_step`` on fake tensors): the
    bytes the step makes alive at once beyond its inputs."""
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    params = M.init_params(cfg, torch.Generator(), device="meta")
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}
    return D.trace_step(cfg, {"kind": "train"}, params, meta).peak


def trace_peaks_worker(out: str, small: bool) -> int:
    """``traced_step_peak`` of each config of ``train_configs`` in turn on
    the host (this script with ``--trace-peaks``, beside the card's
    train steps), each written to ``out``/<name>.json as it is done."""
    import torch

    from repro_torch.launch.train import make_lm_sampler, to_device
    cpu = torch.device("cpu")
    for name, cfg, B, L, _, _ in train_configs(small):
        t0 = time.perf_counter()
        batch = to_device(make_lm_sampler(np.random.default_rng(0), cfg)(
            B, L), cpu)
        peak = traced_step_peak(torch, cfg, batch)
        tmp = Path(out) / f"{name}.tmp"
        tmp.write_text(json.dumps({"peak": peak,
                                   "s": time.perf_counter() - t0}))
        tmp.replace(Path(out) / f"{name}.json")
    return 0


class TracedPeaks:
    """``trace_peaks_worker`` in a child process started at once (the
    host's traces, 5-17 s each, run beside the kernels' build and the
    first phases, off the card's critical path); ``get(name)`` waits for
    a config's traced peak.  The child is stopped at exit."""

    def __init__(self, small: bool):
        import atexit
        import tempfile
        self.tmp = tempfile.TemporaryDirectory()
        self.proc = spawn_self("--trace-peaks", self.tmp.name, small)
        atexit.register(self.close)

    def get(self, name: str):
        """(traced peak in bytes, the trace's host seconds)."""
        path = Path(self.tmp.name) / f"{name}.json"
        t0 = time.perf_counter()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                text = self.proc.communicate()[0].decode()[-4000:]
                raise SmokeFailure(f"the dry-run traces exited "
                                   f"{self.proc.returncode} before "
                                   f"{name}:\n{text}")
            check(time.perf_counter() - t0 < 900,
                  f"the dry run's trace of {name} took over 900 s")
            time.sleep(0.1)
        got = json.loads(path.read_text())
        return got["peak"], got["s"]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()
        self.tmp.cleanup()


def train_run(torch, dev, name, cfg, B, L, warm: int, steps: int,
              total: dict, traced):
    """``warm`` then ``steps`` timed train steps of ``cfg`` on the card
    (seeded f32 params, the launcher's sampler); returns the losses and
    the timed steps' launches.
    Logs ms a step, tokens/s, the card's busy share of one step
    (profiler, kernel events only), peak memory and each kernel's
    launches a step (the kernels' counts set to 0 just before the timed
    steps and read just after).  On the card the timed steps' peak
    above their inputs is held to the dry run's traced peak of the same
    step (``traced``: a ``TracedPeaks``): from 0.9 to 1.25 times it."""
    from repro_torch.launch.train import make_lm_sampler, to_device
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.steps import make_train_step

    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, device=dev)
    opt = init_opt_state(params)
    sampler = make_lm_sampler(np.random.default_rng(0), cfg)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=10))
    batches = [to_device(sampler(B, L), dev) for _ in range(warm + steps + 1)]
    losses = []
    for b in batches[:warm]:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    reset_launches()
    t0 = time.perf_counter()
    for b in batches[warm:warm + steps]:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]) and math.isfinite(float(m["gnorm"])),
              f"train {name}: loss {losses[-1]} gnorm {float(m['gnorm'])}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else float("nan")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    busy = "not measured"
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, batches[-1])
            torch.cuda.synchronize(dev)
            w1 = time.perf_counter() - t1
        ev = _busy(prof)
        dev_us = sum(x[0] for x in ev)
        if dev_us:
            ours = {}
            for us, n in ev:
                lab = kernel_label(n).split("<")[0]
                if lab in port_kernels():
                    ours[lab] = ours.get(lab, 0.0) + us
            busy = (f"{dev_us / 1e6 / w1:.1%} of a {w1 * 1e3:.1f} ms step "
                    f"under the profiler; the port's kernels "
                    + "; ".join(f"{k} {us / 1e3:.1f} ms"
                                for k, us in sorted(ours.items())))
    traced, trace_s = traced.get(name)
    held = "not measured"
    if dev.type == "cuda":
        # the dry run's traced peak against the allocator's: what a step
        # made alive at once beyond its inputs (its new parameters and
        # AdamW state, gradients, activations); the card adds only the
        # kernels' scratch and the allocator's rounding
        made = peak * 1e9 - base
        check(0.9 <= made / traced <= 1.25,
              f"train {name}: the step's peak above its inputs "
              f"{made / 1e9:.3f} GB on the card, {traced / 1e9:.3f} GB "
              f"traced by the dry run")
        held = f"{made / 1e9:.3f} GB ({made / traced:.4f}x the traced)"
    ms = wall * 1e3 / steps
    log(f"[train] {name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_params() / 1e9:.2f} B params, {cfg.compute_dtype} compute, "
        f"f32 master params + AdamW, B={B} L={L}): {ms:.1f} ms a step, "
        f"{B * L / ms * 1e3:.0f} tokens/s over {steps} steps after {warm}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak {peak:.1f} GB; "
        f"made by a step {held}, the dry run's trace "
        f"{traced / 1e9:.3f} GB ({trace_s:.1f} s of host); "
        f"busy {busy}; launches a step: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in counts.items() if v))
    del params, opt
    return losses, counts


def train_phase(torch, dev, small: bool, kernels: dict, traced):
    """Train steps on the card: each config of ``train_configs`` for its
    warm-up and timed steps (finite loss and gnorm; gemma2-2b's 26
    attention backwards a step all on the wgmma body), then the ~100M
    example config for 80 of its 250 steps with the reference's
    assertion of a loss drop over 30%.  Every backward kernel must have launched; the
    kernels line takes their launches from the timed steps.  ``traced``:
    the ``TracedPeaks`` of ``train_configs``."""
    import tempfile

    from repro_torch.launch.train import main as train_main

    counts = {}
    for name, cfg, B, L, warm, steps in train_configs(small):
        _, got = train_run(torch, dev, name, cfg, B, L, warm, steps, counts,
                           traced)
        if name == "gemma2-2b" and dev.type == "cuda":
            # every layer's attention backward on the hd-288 wgmma body
            n = cfg.n_layers * steps
            check(got["flash_attention_bwd"] == n and
                  got["flash_attention_bwd[wgmma]"] == n,
                  f"train {name}: attention backward launches "
                  f"{got['flash_attention_bwd']}, on wgmma "
                  f"{got['flash_attention_bwd[wgmma]']}; want {n}")
        release(torch, dev, f"after training {name}")
    for k in bwd_kernels():
        check(counts.get(k, 0) > 0 or dev.type != "cuda",
              f"train: {k} never launched ({counts})")
        kernels.setdefault(k, {})["launches"] = counts.get(k, 0)
    # every trained config's attention is bf16 at hd 64, 120, 128 or 288
    check(counts.get("flash_attention_bwd[wgmma]", 0) ==
          counts.get("flash_attention_bwd", 0),
          f"train: the attention backward left the wgmma body ({counts})")
    log(f"[train] launches over the timed steps: {counts}")
    with tempfile.TemporaryDirectory() as tmp:
        # 80 of the example's 250 steps (the script's time limit; the
        # loss has fallen past the 30% the reference asserts by step 50)
        argv = ["--arch", "llama3.2-1b", "--steps", "80" if not small
                else "30", "--batch", "8", "--seq", "128", "--lr", "3e-4",
                "--warmup", "40", "--ckpt-dir", tmp, "--ckpt-every", "100",
                "--log-every", "50", "--device", str(dev)]
        argv += ["--smoke"] if small else [
            "--d-model", "640", "--n-layers", "16", "--d-ff", "2560",
            "--vocab", "16384"]
        t0 = time.perf_counter()
        first, last = train_main(argv)
        dt = time.perf_counter() - t0
    if not small:
        check(last < 0.7 * first, f"train 100M: loss {first:.4f} -> "
                                  f"{last:.4f}, not a drop of 30%")
    log(f"[train] the ~100M example (d_model 640, 16 layers, vocab 16384, "
        f"B=8, L=128): loss {first:.4f} -> {last:.4f} "
        f"({1 - last / first:.1%} drop) in {dt:.1f} s")


SHARD_ARCHS = ["llama3.2-1b", "mamba2-1.3b", MOE_ARCH]


def sharding_configs(small: bool):
    """(name, config, batch, seq) of the ``sharding`` phase: llama3.2-1b
    at full width and depth, mamba2-1.3b and qwen3-moe-30b-a3b at full
    width on 2 layers, B=4, L=512, bf16 compute, f32 master params."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    out = []
    for name in SHARD_ARCHS:
        cfg = get_smoke(name) if small else get_config(name)
        if name != "llama3.2-1b":
            cfg = dataclasses.replace(cfg, n_layers=2)
        out.append((name, cfg) + ((2, 32) if small else (4, 512)))
    return out


def kernel_families() -> dict:
    """{kernel name: (wrapper family, "fwd" or "bwd")} from the port's
    CUDA sources: a ``*_bwd.cuh`` header holds a family's backward."""
    import re
    out = {}
    for src in sorted((ROOT / "src/repro_torch/kernels/csrc").glob("*.cu*")):
        fam = src.stem.replace("_bwd", "")
        way = "bwd" if src.stem.endswith("_bwd") else "fwd"
        for n in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                src.read_text()):
            out[n] = (fam, way)
    return out


def sharded_run(torch, dev, mesh, cfg, params, batches, warm: int):
    """``warm`` then the rest of ``batches`` as train steps from
    ``params``; with ``mesh``, on DTensor parameters, AdamW state and
    batches laid out by ``sharding/rules``.  Returns (metrics of each
    step, ms a timed step, final params as plain tensors, launches over
    the timed steps)."""
    from repro_torch.sharding import place
    from repro_torch.sharding import rules as R
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.steps import make_train_step

    step = make_train_step(cfg, AdamWConfig(warmup_steps=10))
    if mesh is not None:
        params = place.shard_tree(params, R.param_specs(cfg, mesh, params),
                                  mesh)
        batches = [place.shard_tree(b, R.batch_spec(cfg, mesh, b), mesh)
                   for b in batches]
    opt = init_opt_state(params)
    metrics = []
    for i, b in enumerate(batches):
        if i == warm:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            reset_launches()
            t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - warm)
    counts = read_launches()
    return metrics, ms, place.gather_tree(params), counts, (step, opt)


def sharding_phase(torch, dev, small: bool, kernels: dict):
    """Train steps on DTensor parameters on the card: a world-size-1
    NCCL group (gloo when rehearsed), ``make_host_mesh()``, and for each
    config of ``sharding_configs`` 2 warm-up and 3 timed steps sharded
    and unsharded from the same seeded f32 parameters and batches.  The
    losses and gnorms of every step and every parameter after the steps
    within 1e-4 (relative to the leaf's max) of the unsharded run's,
    bit-equality reported; the sharded steps' launches counted (the
    attention, the scan and the gate forward and backward must each
    launch) and added to the kernels line; one sharded step profiled,
    its kernels named by source and direction.  Then the
    production-mesh dry run's per-device resident GB and ``fits`` of
    llama4-maverick-400b-a17b and qwen3-moe-30b-a3b at train_4k on both
    meshes (a fake process group of 256 / 512 ranks)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_lm_sampler, to_device
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import leaves

    mesh = make_host_mesh(device=dev)
    if dev.type == "cuda":
        log(f"[sharding] card: {card_name()}")
    fams = kernel_families()
    seen, total = set(), {}
    try:
        for name, cfg, B, L in sharding_configs(small):
            gen = torch.Generator(device=dev).manual_seed(0)
            params = M.init_params(cfg, gen, device=dev)
            sampler = make_lm_sampler(np.random.default_rng(0), cfg)
            batches = [to_device(sampler(B, L), dev) for _ in range(5)]
            m0, ms0, p0, _, _ = sharded_run(torch, dev, None, cfg, params,
                                            batches, 2)
            m1, ms1, p1, counts, (step, opt) = sharded_run(
                torch, dev, mesh, cfg, params, batches, 2)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            worst, same = 0.0, True
            for a, b in zip(leaves(p0), leaves(p1)):
                d = float((a.float() - b.float()).abs().max())
                same = same and d == 0.0
                worst = max(worst, d / max(float(a.abs().max()), 1e-30))
            gaps = {}
            for a, b in zip(m0, m1):
                for k in ("loss", "gnorm", "aux"):
                    check(abs(a[k] - b[k]) <= 1e-4 * max(abs(a[k]), 1.0),
                          f"sharding {name}: {k} {b[k]} sharded, {a[k]} "
                          f"unsharded")
                    gaps[k] = max(gaps.get(k, 0.0), abs(a[k] - b[k]))
            same = same and not any(gaps.values())
            check(worst <= 1e-4, f"sharding {name}: a parameter after the "
                                 f"steps {worst:.3g} of its max from the "
                                 f"unsharded run's")
            ran = ""
            if dev.type == "cuda":
                from repro_torch.sharding import place
                from repro_torch.sharding import rules as R
                from torch.profiler import ProfilerActivity, profile
                sp = place.shard_tree(params, R.param_specs(cfg, mesh,
                                                            params), mesh)
                sb = place.shard_tree(batches[-1], R.batch_spec(
                    cfg, mesh, batches[-1]), mesh)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    step(sp, opt, sb)
                    torch.cuda.synchronize(dev)
                got = {}
                for us, n in _busy(prof):
                    lab = kernel_label(n).split("<")[0]
                    if lab in fams:
                        got.setdefault(fams[lab], []).append(lab)
                seen.update(got)
                ran = "; profiled sharded step: " + ("; ".join(
                    f"{f} {w}: {', '.join(sorted(set(ks)))}"
                    for (f, w), ks in sorted(got.items()))
                    or "no device time in the trace")
                del sp, sb
            log(f"[sharding] {name} ({cfg.n_layers} layers, d_model "
                f"{cfg.d_model}, B={B} L={L}, {cfg.compute_dtype} compute) "
                f"on {dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
                f"{ms1:.1f} ms a sharded step, {ms0:.1f} unsharded "
                f"(x{ms1 / ms0:.3f}); losses {[round(m['loss'], 6) for m in m1]}; "
                f"worst parameter {worst:.3g} of its leaf's max; "
                f"{'bit-equal' if same else 'not bit-equal'} (losses, "
                f"gnorms, aux, parameters; largest gaps "
                + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
                + "); launches over the 3 sharded "
                f"steps: " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                       if v) + ran)
            del params, p0, p1, opt, step
            release(torch, dev, f"after the sharded {name}")
    finally:
        dist.destroy_process_group()
    for k in ("flash_attention", "flash_attention_bwd", "ssd_scan",
              "ssd_scan_bwd", "moe_gating", "moe_gating_bwd"):
        check(total.get(k, 0) > 0 or dev.type != "cuda",
              f"sharding: {k} never launched from a sharded step ({total})")
        if k in kernels:
            kernels[k]["launches"] = kernels[k].get("launches", 0) + total[k]
    if dev.type == "cuda" and seen:
        for fam in ("flash_attention", "ssd_scan", "moe_gating"):
            for way in ("fwd", "bwd"):
                check((fam, way) in seen, f"sharding: no {fam} {way} kernel "
                                          f"in the profiled sharded steps")
    log(f"[sharding] launches over the sharded timed steps: {total}")
    for multi in (False, True):
        with D.fake_world(512 if multi else 256):
            from repro_torch.launch.mesh import make_production_mesh
            pm = make_production_mesh(multi_pod=multi, device="cpu")
            for arch in ("llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b"):
                r = D.pair_report(arch, "train_4k",
                                  device=dev if dev.type == "cuda"
                                  else "meta", mesh=pm, trace=False)
                log(f"[sharding] dry run {arch} train_4k on "
                    f"{r['mesh']} ({r['devices']} devices): resident "
                    f"{r['bytes']['resident'] / 1e9:.3f} GB a device "
                    f"(params {r['bytes']['params'] / 1e9:.3f}, AdamW "
                    f"{r['bytes']['opt_state'] / 1e9:.3f}), fits "
                    f"{r['fits']}, silent replications "
                    f"{r['silent_replications']}")


class GateReplay:
    """Within the ``with``: every gate of a run through
    ``ops._gate_kernel``; ``record`` keeps the experts each call chose,
    ``replay`` makes each call take the recorded experts instead (the
    probabilities, vals and aux its own), after checking that its own
    choice differs from them only at a near-tie (the two experts'
    probabilities within 1e-5)."""

    def __init__(self, mode: str, calls=None):
        from repro_torch.kernels import ops
        self.ops, self.orig, self.mode = ops, ops._gate_kernel, mode
        self.calls = [] if calls is None else calls
        self.n, self.flips = 0, []

    def __enter__(self):
        import torch
        from repro_torch.kernels.moe_gating import moe_gating_plain

        def gate(logits, k, return_asum=False):
            out = self.orig(logits, k, return_asum)
            if self.mode == "record":
                self.calls.append(out[1].cpu())
                return out
            idx = self.calls[self.n].to(logits.device)
            self.n += 1
            diff = idx != out[1]
            if bool(diff.any()):
                p = torch.softmax(logits.float(), dim=-1)
                gap = float((p.gather(1, idx.long())
                             - p.gather(1, out[1].long())).abs()[diff].max())
                check(gap < 1e-5, f"gate {self.n}: the card chose other "
                                  f"experts than the CPU (gap {gap:.3g})")
                self.flips.append((self.n, int(diff.any(1).sum()), gap))
            return moe_gating_plain(logits, k, return_asum, idx=idx)
        self.ops._gate_kernel = gate
        return self

    def __exit__(self, *exc):
        self.ops._gate_kernel = self.orig


def train_card_vs_cpu_phase(torch, dev, small: bool):
    """One train step of every config of the zoo at full width, 2 layers
    (llama4-maverick-400b-a17b at ``SMOKE``: it does not fit one card),
    f32, B=2: the same seeded params and batch on the card (kernels,
    forward and backward) and on the CPU (plain versions).  Loss and
    aux within 1e-4 relative, gnorm within 1e-4 relative, every gradient
    leaf within 1e-3 of its max |g|.  Windowed models train with windows
    of 48 at L=72 (past one 64-key tile); seamless with 2 encoder layers
    and llava with 64 frontend tokens, seeded normal embeddings, as the
    card-vs-CPU serving phase.  The CPU's MoE gates take the card's
    choices (``GateReplay``), each differing only at a near-tie."""
    import dataclasses

    from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
    from repro_torch.launch.train import make_lm_sampler, to_device
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import global_norm, leaves
    from repro_torch.training.steps import loss_and_grads

    cpu = torch.device("cpu")
    B = 2
    for name in ARCH_NAMES:
        t0 = time.perf_counter()
        base = get_smoke(name) if small or name.startswith("llama4") \
            else get_config(name)
        cfg = dataclasses.replace(base, n_layers=2, compute_dtype="float32")
        L = 48 if small else 64
        if cfg.sliding_window:
            cfg = dataclasses.replace(cfg, sliding_window=48)
            L = 72
        if cfg.is_encdec:
            cfg = dataclasses.replace(cfg, n_enc_layers=2)
        elif cfg.frontend:
            cfg = dataclasses.replace(cfg, frontend_tokens=min(
                64, cfg.frontend_tokens))
        batch = make_lm_sampler(np.random.default_rng(5), cfg)(B, L)
        params = M.init_params(cfg, torch.Generator().manual_seed(3), cpu)
        on_card = M.tree_map(lambda t: t.to(dev), params)
        with GateReplay("record") as rec:
            got = loss_and_grads(on_card, cfg, to_device(batch, dev))
        with GateReplay("replay", rec.calls) as rep:
            want = loss_and_grads(params, cfg, to_device(batch, cpu))
        check(rep.n == len(rec.calls), f"{name}: gate calls {rep.n} vs "
                                       f"{len(rec.calls)}")
        for i, what in ((1, "loss"), (2, "aux"), (0, "total")):
            a, b = float(got[i]), float(want[i])
            check(abs(a - b) <= 1e-4 * max(abs(b), 1e-6),
                  f"{name}: {what} {a} on the card vs {b} on the CPU")
        gn_card = float(global_norm(got[3]))
        gn_cpu = float(global_norm(want[3]))
        check(abs(gn_card - gn_cpu) <= 1e-4 * gn_cpu,
              f"{name}: gnorm {gn_card} vs {gn_cpu}")
        gl, wl = leaves(got[3]), leaves(want[3])
        worst = grads_close([x.cpu() for x in gl], wl, 1e-3,
                            f"{name} gradients")
        log(f"[train card vs cpu] {name} (d_model {cfg.d_model}, 2 layers, "
            f"f32, B={B}, L={L}{', window 48' if cfg.sliding_window else ''}"
            f"): loss {float(want[1]):.6f} card / CPU rel err "
            f"{abs(float(got[1]) - float(want[1])) / float(want[1]):.2g}, "
            f"gnorm {gn_cpu:.5g} rel err {abs(gn_card - gn_cpu) / gn_cpu:.2g}"
            f", {len(wl)} gradient leaves, worst {worst:.3g} of its max |g| "
            f"(tol 1e-3); gate choices taken from the card at a near-tie: "
            f"{rep.flips or 'none'}; {time.perf_counter() - t0:.1f} s")
        del params, on_card, got, want
        release(torch, dev, f"after {name}")


# ----------------------------------------------------------------------
# the batch-1 decode on a cache sharded by length (ctx_decode, multirank)
# ----------------------------------------------------------------------

CTX_R = 16                      # slot blocks: the data ranks of (16, 16)
MULTIRANK_WORLD = 4             # gloo ranks sharing the one card


def ctx_cases(small: bool):
    """Each decode body at a long_500k shape, B = 1, the cache cut into
    CTX_R slot blocks: (what, Hq, Hkv, hd, dtype name, int8, C, live,
    local window, softcap).  gemma2-2b's local window sits in a full
    cache of 2 W slots with its first live slot inside block 3 (blocks
    0-2 wholly below it, the blocks past the live count empty)."""
    from repro_torch.configs import get_config, get_smoke
    llama = (get_smoke if small else get_config)("llama3.2-1b")
    gemma = (get_smoke if small else get_config)("gemma2-2b")
    C = 256 if small else 4096
    W = gemma.sliding_window
    n = 2 * W // CTX_R
    first = 3 * n + n // 2 - 1
    lh = (llama.n_heads, llama.n_kv_heads, llama.head_dim)
    gh = (gemma.n_heads, gemma.n_kv_heads, gemma.head_dim)
    cap = gemma.attn_softcap
    ghd = gemma.head_dim                # 288; 64 at the rehearsal's size
    wide = ("decode_wide_kernel<288>" if ghd == 288 else
            f"decode_mma_kernel<{ghd}>")
    return [
        ("decode_mma_kernel<64> llama3.2-1b ring", *lh, "bf16", False, C,
         C, 0, 0.0),
        (f"{wide} gemma2-2b long_mode ring", *gh, "bf16", False, C, C, 0,
         cap),
        (f"{wide} gemma2-2b local window in a full cache", *gh, "bf16",
         False, 2 * W, first + W, W, cap),
        ("decode_mma_kernel<64, true> llama3.2-1b int8 ring", *lh, "bf16",
         True, C, C, 0, 0.0),
        (f"{wide[:-1]}, true> gemma2-2b int8 ring", *gh, "bf16", True, C,
         C, 0, cap),
        ("decode_split_kernel<f32, 64> llama3.2-1b f32 ring", *lh, "f32",
         False, C, C, 0, 0.0),
        (f"decode_split_kernel<f32, {ghd}> gemma2-2b f32 ring", *gh, "f32",
         False, C, C, 0, cap)]


def ctx_row(torch, FA, g, dev, what, Hq, Hkv, hd, dtn, q8, C, live, local,
            cap):
    """One decode body with ``return_lse`` on each of CTX_R slot blocks
    of a B = 1 cache, each block's (o, lse) against its plain partial
    (lse within 1e-5, +inf where the block holds no live key; o within
    2e-2 of max |o| in bf16, 1e-5 in f32), the partials merged by
    ``decode_merge`` (against ``decode_merge_plain``, and against the
    unsharded launch within one bf16 ulp of max |o|, f32 1e-6).  Timed:
    the unsharded body without and with lse, its plain version, SDPA
    where it computes the same function, and ``decode_merge`` of the
    CTX_R parts.  Returns (the body's row, the merge's row)."""
    from repro_torch.models.layers import quantize_kv

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtn]
    q = torch.randn(1, 1, Hq, hd, generator=g, device=dev).to(
        dt).transpose(1, 2)
    kf, vf = (torch.randn(1, C, Hkv, hd, generator=g, device=dev)
              for _ in range(2))
    if q8:
        (k8, ks), (v8, vs) = quantize_kv(kf), quantize_kv(vf)
        kv = [t.transpose(1, 2) for t in (k8, v8, ks, vs)]
    else:
        kv = [t.to(dt).transpose(1, 2) for t in (kf, vf)]
    del kf, vf
    kvt = torch.tensor([live], dtype=torch.int32, device=dev)

    def decode(blocks, kv_valid, first=None, lse=False, loc=local):
        if q8:
            return FA.flash_decode_q8(q, *blocks, kv_valid, softcap=cap,
                                      local_window=loc, return_lse=lse,
                                      kv_first=first)
        return FA.flash_attention(q, *blocks, kv_valid, causal=False,
                                  softcap=cap, local_window=loc,
                                  return_lse=lse, kv_first=first)

    def plain(blocks, kv_valid, first=None, lse=True, loc=0):
        if q8:
            return FA.decode_q8_plain(q, *blocks, kv_valid, softcap=cap,
                                      local_window=loc, return_lse=lse,
                                      kv_first=first)
        qq, kk, vv = (q.float(), blocks[0].float(), blocks[1].float()) \
            if lse else (q, *blocks)
        return FA.flash_attention_plain(qq, kk, vv, kv_valid, causal=False,
                                        softcap=cap, local_window=loc,
                                        return_lse=lse, kv_first=first)
    kernel = flash_kernel(FA, q, kv[0], int8=q8)
    check(what.startswith(kernel), f"ctx_decode {what}: runs {kernel}")
    whole = decode_on_body(torch, FA, q, kv[0], lambda: decode(kv, kvt),
                           f"ctx_decode {what}") if not q8 else \
        decode(kv, kvt)
    n = C // CTX_R
    o_err = o_abs = lse_err = 0.0
    o_parts, lse_parts, empty = [], [], 0
    for r in range(CTX_R):
        lo = r * n
        blocks = [t[:, :, lo:lo + n] for t in kv]
        kvl = (kvt - lo).clamp(0, n).to(torch.int32)
        first = (kvt - local - lo).clamp(0, n).to(torch.int32) \
            if local else None
        o, lse = decode(blocks, kvl, first, lse=True, loc=0)
        wo, wl = plain(blocks, kvl, first)
        check(o.dtype == torch.float32 and tuple(lse.shape) == (1, Hq, 1),
              f"ctx_decode {what}: partial {o.dtype} {tuple(lse.shape)}")
        check(bool((torch.isinf(lse) == torch.isinf(wl)).all()),
              f"ctx_decode {what}: block {r}'s empty rows differ")
        fin = torch.isfinite(wl)
        if bool(fin.any()):
            lse_err = max(lse_err, float((lse[fin] - wl[fin]).abs().max()))
            d = float((o - wo).abs().max())
            o_abs = max(o_abs, d)
            o_err = max(o_err, d / max(float(wo.abs().max()), 1e-30))
        empty += int(bool(torch.isinf(lse).all()))
        o_parts.append(o)
        lse_parts.append(lse)
    check(lse_err <= 1e-5, f"ctx_decode {what}: lse err {lse_err}")
    otol = 2e-2 if dt == torch.bfloat16 else 1e-5
    check(o_err <= otol, f"ctx_decode {what}: partial o err {o_err} of max")
    if local:
        check(empty >= 3 + (CTX_R - (live + n - 1) // n),
              f"ctx_decode {what}: {empty} empty blocks")
    O, L = torch.stack(o_parts), torch.stack(lse_parts)
    merged = FA.decode_merge(O, L, dt)
    mplain = FA.decode_merge_plain(O, L, dt)
    top = float(whole.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    tol = ulp if dt == torch.bfloat16 else 1e-6 * top
    m_err = float((merged.float() - mplain.float()).abs().max())
    err = float((merged.float() - whole.float()).abs().max())
    check(m_err <= tol, f"ctx_decode {what}: merge vs its plain version "
                        f"{m_err} > {tol}")
    check(err <= tol, f"ctx_decode {what}: merged vs unsharded {err} > "
                      f"{tol}")
    fst = (kvt - local).clamp(0, C).to(torch.int32) if local else None
    ms = time_graph_ms(torch, lambda: decode(kv, kvt), dev)
    ms_lse = time_graph_ms(torch, lambda: decode(kv, kvt, fst, lse=True,
                                                 loc=0), dev)
    split = ""
    if local:
        # the lse's cost apart from the mask's: each mask with and
        # without lse on the same cache, timed twice in mirrored order
        o, lse = decode(kv, kvt, lse=True)
        wo, wl = plain(kv, kvt, loc=local)
        d = float((lse - wl).abs().max())
        check(d <= 1e-5, f"ctx_decode {what}: local_window with lse: lse "
                         f"err {d}")
        runs = {"window": lambda: decode(kv, kvt),
                "window+lse": lambda: decode(kv, kvt, lse=True),
                "first": lambda: decode(kv, kvt, fst, loc=0),
                "first+lse": lambda: decode(kv, kvt, fst, lse=True, loc=0)}
        t = dict.fromkeys(runs, 0.0)
        for k in list(runs) + list(runs)[::-1]:
            t[k] += time_graph_ms(torch, runs[k], dev) / 2
        split = (f"; local_window without / with lse {t['window']:.4f} / "
                 f"{t['window+lse']:.4f} ms "
                 f"({t['window+lse'] / t['window']:.3f}x), kv_first "
                 f"without / with lse {t['first']:.4f} / "
                 f"{t['first+lse']:.4f} ms "
                 f"({t['first+lse'] / t['first']:.3f}x), kv_first / "
                 f"local_window without lse "
                 f"{t['first'] / t['window']:.3f}x")
    plain_ms = time_ms(torch, lambda: plain(kv, kvt, lse=False, loc=local),
                       dev, iters=5, warmup=1)
    merge_ms = time_graph_ms(torch, lambda: FA.decode_merge(O, L, dt), dev)
    esz = 1 if q8 else q.element_size()
    keys = live - (live - local if local else 0)
    row_bytes = keys * Hkv * 2 * (hd * esz + (4 if q8 else 0))
    bms, by = bound_ms(row_bytes + Hq * hd * (q.element_size() + 4) + Hq * 4,
                       4.0 * Hq * hd * keys,
                       PEAK_FP32_S if dt == torch.float32 else PEAK_BF16_S)
    lib_ms = None
    if not cap and not q8:
        mask = (torch.arange(C, device=dev) < live)[None, None, None]
        lib = sdpa_call(torch, q.contiguous(), kv[0].contiguous(),
                        kv[1].contiguous(), attn_mask=mask)
        lib_ms = time_graph_ms(torch, lib, dev)
    mb, mby = bound_ms(CTX_R * Hq * (hd + 1) * 4 + Hq * hd * q.element_size(),
                       3.0 * CTX_R * Hq * hd, PEAK_FP32_S)
    log(f"[ctx_decode] {what}: {Hq}/{Hkv} heads of {hd}, C {C}, live "
        f"{live}, local {local}, softcap {cap:g}, {CTX_R} blocks of {n} "
        f"({empty} empty): unsharded {ms:.4f} ms, with lse {ms_lse:.4f} "
        f"({ms_lse / ms:.3f}x), plain {plain_ms:.4f}, SDPA "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}, bound {bms:.4f} "
        f"by {by}; partial o err {o_err:.3g} of max, lse err {lse_err:.3g}; "
        f"merge {merge_ms:.4f} ms (bound {mb:.5f} by {mby}), merged vs "
        f"unsharded {err:.3g} (tol {tol:.3g}), vs plain merge {m_err:.3g}"
        f"{split}")
    body = dict(name=f"flash_attention ctx_decode {what}, B=1, {CTX_R} "
                     f"blocks, with lse", route="cuda", source=FLASH_SRC,
                replaces=FLASH_TPU, max_abs_err=max(lse_err, o_abs),
                ms=ms_lse, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)
    merge = dict(name=f"decode_merge ctx_decode {what}, R={CTX_R}",
                 route="cuda", source=FLASH_SRC, replaces=FLASH_TPU,
                 max_abs_err=err, ms=merge_ms,
                 plain_ms=time_ms(torch, lambda: FA.decode_merge_plain(
                     O, L, dt), dev, iters=5, warmup=1),
                 bound_ms=mb, bound_by=mby, library_ms=None)
    return body, merge


def ctx_decode_phase(torch, dev, small: bool, kernels: dict):
    """Every decode body with ``return_lse`` over CTX_R slot blocks of a
    batch-1 cache, merged by ``decode_merge`` (``ctx_row``).  Checked
    and timed only: no main path runs these shapes, so their rows carry
    no launches (``multirank``'s rows carry the path's)."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(91)
    for case in ctx_cases(small):
        body, merge = ctx_row(torch, FA, g, dev, *case)
        kernels[body["name"]] = dict(body, launches=0)
        kernels[merge["name"]] = dict(merge, launches=0)


def _lay_out(tree, specs, mesh):
    """``tree``'s tensors as DTensors laid out by ``specs``: each rank
    holds the same full values (drawn from one seed) and keeps its own
    block, so nothing moves."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding import place
    if isinstance(tree, dict):
        return {k: _lay_out(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lay_out(v, specs[i], mesh) for i, v in enumerate(tree)]
    return distribute_tensor(tree, mesh, place.placements(specs, mesh),
                             src_data_rank=None)


def _whole(t):
    from repro_torch.sharding import place
    return t.full_tensor() if place.is_dtensor(t) else t


def multirank_cfgs(small: bool):
    """The configs at full width (``SMOKE`` when small), 2 layers, f32:
    the card against the card, sharded and not, to the CPU's limits."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke
    out = {}
    for name in ("llama3.2-1b", "gemma2-2b"):
        cfg = (get_smoke if small else get_config)(name)
        out[name] = dataclasses.replace(cfg, n_layers=2,
                                        param_dtype="float32",
                                        compute_dtype="float32")
    return out


def full_cache_steps(W: int, steps: int):
    """gemma2-2b's local window in a full cache on two data ranks: the
    cache's 2 W + 16 slots, the first decode position, and how many of
    the ``steps`` have data block 0 ([0, W + 8)) wholly below the
    window (pos >= 2 W + 7: its partial is empty); in the steps before
    them the window's edge lies inside block 0."""
    C, inside = 2 * W + 16, steps // 3 + 1
    return C, C - 9 - inside, steps - inside


def multirank_runs(torch, dev, small: bool, mesh=None, checks=None) -> dict:
    """The runs of the multirank phase, unsharded (``mesh`` None) or on
    ``mesh`` ((2, 2) ("data", "model")) with every input laid out by the
    reference's rules (``_lay_out``):

      * batch 1: llama3.2-1b and gemma2-2b, prompt 512, 8 greedy decode
        steps (the cache in ``cache_specs``' batch-1 layout: slots over
        ``data``); gemma2-2b's local window in a seeded full cache
        (``full_cache_steps``: 8 steps, data block 0 first cut by the
        window's edge, then wholly below it); gemma2-2b in ``long_mode``
        one step at the long_500k position on its seeded full ring of
        4,096;
      * batch-sharded, B = 4: llama3.2-1b's prefill (prompt 64) and 3
        decode steps, and one train step (L = 64).

    The launch counts are read around each batch-1 run's decode steps
    alone; ``checks`` (``RankChecks``) is told which run is on.
    Returns numpy-ready lists."""
    from repro_torch.launch import shapes
    from repro_torch.models import model as M
    from repro_torch.sharding import rules as R
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.steps import (make_decode_step,
                                            make_prefill_step,
                                            make_train_step)

    def lay(tree, specs_fn):
        return tree if mesh is None else _lay_out(tree, specs_fn(tree), mesh)

    def decode(name, cfg, p, cache, toks, pos, dec):
        """Greedy decode steps fed ``toks`` from ``pos``: the run's
        logits, tokens, launches and local slot count."""
        logits, tokens = [], []
        if checks is not None:
            checks.run = name
        reset_launches()
        for s_ in range(toks.shape[1]):
            db = lay({"token": toks[:, s_:s_ + 1], "pos": pos},
                     lambda t: R.decode_batch_spec(cfg, mesh, t))
            lg, nxt, cache = dec(p, cache, db)
            logits.append(_whole(lg)[0])
            tokens.append(int(_whole(nxt)[0, 0]))
            pos = pos + 1
        counts[name] = read_launches()
        if checks is not None:
            checks.run = None
        k = cache["k"]
        out[name] = {"logits": torch.stack(logits).cpu().tolist(),
                     "tokens": tokens,
                     "local_c": int((k.to_local() if mesh is not None
                                     else k).shape[2])}

    def seeded(name, seed, seq, pos0, steps, long_mode=False):
        """gemma2-2b's decode on a seeded full cache of ``seq``."""
        cfg = cfgs["gemma2-2b"]
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = M.init_params(cfg, gen, device=dev)
        cache = M.init_cache(cfg, 1, seq, long_mode=long_mode, device=dev)
        for t in cache.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        toks = torch.randint(0, cfg.vocab_size, (1, steps), generator=gen,
                             device=dev)
        decode(name, cfg, lay(params, lambda t: R.param_specs(cfg, mesh, t)),
               lay(cache, lambda t: R.cache_specs(cfg, mesh, t)), toks,
               torch.full((1,), pos0, dtype=torch.int64, device=dev),
               make_decode_step(cfg, long_mode=long_mode))
    cfgs = multirank_cfgs(small)
    Lp, steps = (20, 3) if small else (512, 8)
    out, counts = {}, {}
    with torch.no_grad():
        for i, (name, cfg) in enumerate(cfgs.items()):
            gen = torch.Generator(device=dev).manual_seed(101 + i)
            params = M.init_params(cfg, gen, device=dev)
            toks = torch.randint(0, cfg.vocab_size, (1, Lp + steps),
                                 generator=gen, device=dev)
            p = lay(params, lambda t: R.param_specs(cfg, mesh, t))
            b = lay({"tokens": toks[:, :Lp]},
                    lambda t: R.batch_spec(cfg, mesh, t))
            pre = make_prefill_step(cfg, max_len=Lp + 16)   # C even
            lg, cache, pos = pre(p, b)
            decode(name, cfg, p, cache, toks[:, Lp:], _whole(pos),
                   make_decode_step(cfg))
            out[name]["logits"].insert(0, _whole(lg)[0].cpu().tolist())
            del params, p, cache
        seeded("gemma2-2b full cache", 131,
               *full_cache_steps(cfgs["gemma2-2b"].sliding_window,
                                 steps)[:2], steps)
        seq = 4096 if small else shapes.SHAPES["long_500k"]["seq_len"]
        seeded("gemma2-2b long_mode", 111, seq, seq - 1, 1, long_mode=True)
        # batch-sharded, B = 4: prefill, 3 decode steps, one train step
        cfg = cfgs["llama3.2-1b"]
        gen = torch.Generator(device=dev).manual_seed(121)
        params = M.init_params(cfg, gen, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (4, 67), generator=gen,
                             device=dev)
        p = lay(params, lambda t: R.param_specs(cfg, mesh, t))
        b = lay({"tokens": toks[:, :64]},
                lambda t: R.batch_spec(cfg, mesh, t))
        lg, cache, pos = make_prefill_step(cfg, max_len=80)(p, b)
        dec = make_decode_step(cfg)
        logits = [_whole(lg)]
        for s_ in range(3):                 # fed the seeded tokens
            db = lay({"token": toks[:, 64 + s_:65 + s_],
                      "pos": _whole(pos)},
                     lambda t: R.decode_batch_spec(cfg, mesh, t))
            lg, _, cache = dec(p, cache, db)
            logits.append(_whole(lg))
            pos = _whole(pos) + 1
        out["batch4"] = {"logits": torch.stack(logits).cpu().tolist()}
        del cache
    batch = lay({"tokens": toks[:, :64], "labels": toks[:, 1:65]},
                lambda t: R.batch_spec(cfg, mesh, t))
    p2, _, m = make_train_step(cfg, AdamWConfig())(p, init_opt_state(p),
                                                   batch)
    layer = p2["layers"][1]
    out["batch4"].update(
        loss=float(_whole(m["loss"])), gnorm=float(_whole(m["gnorm"])),
        params=[_whole(t).float().cpu().reshape(-1).tolist()
                for t in (layer["ln_mix"], layer["attn"]["wq"][:64],
                          layer["mlp"]["wo"][:64])])
    out["counts"] = counts
    return out


def gloo_probe(torch, dev) -> dict:
    """Which collectives the gloo group takes on ``dev``'s tensors: each
    of all-gather, all-reduce, reduce-scatter and all-to-all once on a
    small tensor, "ok" or the error's first line."""
    import torch.distributed as dist
    n = dist.get_world_size()
    x = torch.arange(4 * n, dtype=torch.float32, device=dev)
    calls = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n * n, device=dev), x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x)}
    out = {}
    for name, call in calls.items():
        print(f"[multirank] probe {name}", file=sys.stderr, flush=True)
        try:
            call()
            out[name] = "ok"
        except RuntimeError as e:               # the group refuses it
            out[name] = str(e).splitlines()[0][:160]
    return out


_SYNC_FUNCOL = []               # the Library holding the kernels below


def sync_functional_collectives(torch) -> None:
    """CUDA kernels for the functional collectives (what DTensor's
    redistributions call) that run c10d's synchronous collectives of the
    same group.  On this card's PyTorch (2.11) gloo crashes -- a SIGSEGV
    in its worker thread -- when a functional collective runs
    asynchronously on CUDA tensors, while the synchronous all-gather,
    all-reduce, reduce-scatter and all-to-all of the same tensors and
    groups work (``gloo_probe``).  The ranks of ``multirank`` register
    these; the port's code is unchanged."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def reduce_(t, op, name):
        pg = _resolve_process_group(name)
        op = op.lower()
        dist.all_reduce(t, ops["sum" if op == "avg" else op], group=pg)
        return t.div_(dist.get_world_size(pg)) if op == "avg" else t

    def gather(t, n, name):
        out = t.new_empty((t.shape[0] * n,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(),
                                    group=_resolve_process_group(name))
        return out

    def scatter(t, op, n, name):
        op = op.lower()
        out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.contiguous(),
                                   ops["sum" if op == "avg" else op],
                                   group=_resolve_process_group(name))
        return out.div_(n) if op == "avg" else out

    def all_to_all(t, out_splits, in_splits, name):
        n = sum(out_splits) if out_splits else t.shape[0]
        out = t.new_empty((n,) + tuple(t.shape[1:]))
        dist.all_to_all_single(out, t.contiguous(), out_splits or None,
                               in_splits or None,
                               group=_resolve_process_group(name))
        return out

    def broadcast(t, src, name):
        out = t.clone()
        dist.broadcast(out, group=_resolve_process_group(name),
                       group_src=src)
        return out
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (
            ("all_gather_into_tensor", gather),
            ("all_gather_into_tensor_coalesced",
             lambda ts, n, g: [gather(t, n, g) for t in ts]),
            ("all_reduce", lambda t, op, g: reduce_(t.clone(), op, g)),
            ("all_reduce_", reduce_),
            ("all_reduce_coalesced",
             lambda ts, op, g: [reduce_(t.clone(), op, g) for t in ts]),
            ("reduce_scatter_tensor", scatter),
            ("reduce_scatter_tensor_coalesced",
             lambda ts, op, n, g: [scatter(t, op, n, g) for t in ts]),
            ("all_to_all_single", all_to_all),
            ("broadcast", broadcast)):
        lib.impl(name, fn, "CUDA")
    _SYNC_FUNCOL.append(lib)


class RankChecks:
    """A rank's own check of the kernels its batch-1 decode launches, on
    the rank's own local tensors: each decode partial (``return_lse``)
    against ``flash_attention_plain(return_lse=True)`` with the same
    ``kv_valid``, ``kv_first`` and softcap, and each ``decode_merge``
    against ``decode_merge_plain`` of the same parts, at ``ctx_row``'s
    limits.  Within, it stands in for ``kernels/ops``' names of the two
    kernels (the port's code is unchanged); the plain versions launch
    nothing, so the launch counts stay the path's own.  By run
    (``run``, which ``multirank_runs`` sets): the calls, the worst
    errors, the partials whose block held no live key, the shapes, and
    -- where ``keep`` -- the last call's operands, for the timing."""

    LIMITS = {"lse": 1e-5, "o": 1e-5, "merge": 1e-6}   # f32; o, merge of max

    def __init__(self, keep: bool):
        self.keep, self.run = keep, None
        self.runs, self.operands = {}, {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = (ops._flash_kernel, ops._merge_kernel)
        ops._flash_kernel, ops._merge_kernel = self.flash, self.merge
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops._flash_kernel, ops._merge_kernel = self.saved

    def _rec(self) -> dict:
        return self.runs.setdefault(self.run, dict(
            partials=0, empty=0, empty_differ=0, lse_err=0.0, o_err=0.0,
            o_abs=0.0, merges=0, merge_err=0.0, merge_abs=0.0))

    def flash(self, q, k, v, kv_valid=None, **kw):
        out = self.saved[0](q, k, v, kv_valid, **kw)
        if self.run is None or not kw.get("return_lse") or q.shape[2] != 1:
            return out
        import torch
        from repro_torch.kernels import flash_attention as FA
        o, lse = out
        wo, wl = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                          kv_valid, **kw)
        r = self._rec()
        r["partials"] += 1
        r["empty_differ"] += int(not bool(
            (torch.isinf(lse) == torch.isinf(wl)).all()))
        r["empty"] += int(bool(torch.isinf(lse).all()))
        fin = torch.isfinite(wl)
        if bool(fin.any()):
            r["lse_err"] = max(r["lse_err"],
                               float((lse[fin] - wl[fin]).abs().max()))
            d = float((o - wo).abs().max())
            r["o_abs"] = max(r["o_abs"], d)
            r["o_err"] = max(r["o_err"],
                             d / max(float(wo.abs().max()), 1e-30))
        B, Hq, _, hd = q.shape
        r["shape"] = [B, Hq, k.shape[1], k.shape[2], hd]
        if self.keep:
            self.operands.setdefault(self.run, {})["decode"] = dict(
                q=q.clone(), k=_same_strides(k), v=_same_strides(v),
                kv_valid=kv_valid, kw={n: (t.clone() if hasattr(t, "clone")
                                           else t) for n, t in kw.items()})
        return out

    def merge(self, o_parts, lse_parts, dtype):
        out = self.saved[1](o_parts, lse_parts, dtype)
        if self.run is None:
            return out
        from repro_torch.kernels import flash_attention as FA
        want = FA.decode_merge_plain(o_parts, lse_parts, dtype)
        d = float((out.float() - want.float()).abs().max())
        r = self._rec()
        r["merges"] += 1
        r["merge_abs"] = max(r["merge_abs"], d)
        r["merge_err"] = max(r["merge_err"], d / max(
            float(want.float().abs().max()), 1e-30))
        r["merge_shape"] = list(o_parts.shape)
        if self.keep:
            self.operands.setdefault(self.run, {})["merge"] = dict(
                o_parts=o_parts.clone(), lse_parts=lse_parts.clone(),
                dtype=dtype)
        return out


def _same_strides(t):
    """A copy of ``t`` with its strides (a cache block's layer view)."""
    import torch
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def multirank_worker(rank: int, path: str, small: bool) -> int:
    """One of MULTIRANK_WORLD ranks on the one card: a gloo group (NCCL
    refuses two ranks on one card) whose functional collectives run
    synchronously (``sync_functional_collectives``), a (2, 2) ("data",
    "model") mesh, ``multirank_runs`` under ``RankChecks``; writes
    ``rank<r>.json`` under ``path`` (rank 0 also its checked kernels'
    last operands, ``operands.pt``)."""
    import faulthandler
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    faulthandler.enable()                 # a crash in a collective: where
    dev = torch.device("cpu") if small else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(path) / "store"), MULTIRANK_WORLD), rank=rank,
        world_size=MULTIRANK_WORLD)
    try:
        probe = gloo_probe(torch, dev)
        if dev.type == "cuda":
            sync_functional_collectives(torch)
        mesh = init_device_mesh(dev.type, (2, 2),
                                mesh_dim_names=("data", "model"))
        with RankChecks(keep=rank == 0) as checks:
            out = multirank_runs(torch, dev, small, mesh, checks)
        out["gloo"], out["checks"] = probe, checks.runs
        if checks.keep:
            torch.save(checks.operands, Path(path) / "operands.pt")
        (Path(path) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def multirank_phase(torch, dev, small: bool, kernels: dict):
    """MULTIRANK_WORLD processes on the one card (``multirank_worker``:
    this script with ``--multirank-rank``), each against this process's
    unsharded run of the same seeded inputs on the card, every step fed
    the same seeded token: batch-1 logits within 1e-3 of max |logit|,
    and the same greedy tokens where the unsharded run's top two lie
    more than 1e-3 of max apart; every rank holds C / 2 slots; the
    batch-sharded logits, loss, gnorm and parameters after the train
    step within 1e-5 (f32; the limits of the sharded steps' CPU
    tests).  Every rank's batch-1 decode launched the decode with lse
    on every attention layer of every step and ``decode_merge`` as
    often, each launch held by the rank to its plain version on its own
    tensors (``RankChecks``);
    gemma2-2b's full cache gave data rank 0 an empty partial on its
    local layers once the window lay wholly above its block.  Each
    run's kernels get rows of their own shapes (``multirank_rows``)."""
    import tempfile
    from repro_torch.models import model as M
    tmp = tempfile.mkdtemp(prefix="multirank")
    cmd = [sys.executable, str(Path(__file__).resolve()),
           "--multirank-rank"]
    procs = [subprocess.Popen(cmd + [str(r), tmp] +
                              (["--rehearse"] if small else []),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(MULTIRANK_WORLD)]
    logs = []
    try:
        want = multirank_runs(torch, dev, small)
        for pr in procs:
            logs.append(pr.communicate(timeout=600)[0].decode()[-4000:])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, text) in enumerate(zip(procs, logs)):
        check(pr.returncode == 0, f"multirank: rank {r} exited "
                                  f"{pr.returncode}:\n{text}")
    got = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
           for r in range(MULTIRANK_WORLD)]
    cfgs = multirank_cfgs(small)
    steps = 3 if small else 8
    gemma = cfgs["gemma2-2b"]
    below = full_cache_steps(gemma.sliding_window, steps)[2]
    n_local = M.layer_kinds(gemma).count(0)
    runs = {"llama3.2-1b": (cfgs["llama3.2-1b"], steps),
            "gemma2-2b": (gemma, steps),
            "gemma2-2b full cache": (gemma, steps),
            "gemma2-2b long_mode": (gemma, 1)}
    worst = {}
    for r, g in enumerate(got):
        for name, (cfg, n_steps) in runs.items():
            w, o = np.array(want[name]["logits"]), np.array(g[name]["logits"])
            w2, o2 = w.reshape(-1, w.shape[-1]), o.reshape(-1, o.shape[-1])
            top = float(np.abs(w2).max())
            for s_ in range(w2.shape[0]):
                d = float(np.abs(o2[s_] - w2[s_]).max())
                check(d <= 1e-3 * top, f"multirank {name} rank {r} step "
                                       f"{s_}: logits {d} of max {top}")
                worst[name] = max(worst.get(name, 0.0), d / top)
            toks_w, toks_g = want[name]["tokens"], g[name]["tokens"]
            for s_, (a, b, lg) in enumerate(zip(toks_w, toks_g,
                                                w2[-len(toks_w):])):
                top2 = np.sort(lg)[-2:]
                check(a == b or top2[1] - top2[0] <= 1e-3 * top,
                      f"multirank {name} rank {r} step {s_}: token {b} "
                      f"vs {a}")
            check(g[name]["local_c"] * 2 == want[name]["local_c"],
                  f"multirank {name} rank {r}: {g[name]['local_c']} of "
                  f"{want[name]['local_c']} slots")
            c, k = g["counts"][name], g["checks"].get(name, {})
            n = cfg.n_layers * n_steps
            check(k.get("partials") == k.get("merges") == n,
                  f"multirank {name} rank {r}: {k.get('partials')} partials "
                  f"and {k.get('merges')} merges checked, want {n}")
            if dev.type == "cuda":
                check(c["flash_attention_decode"] == c["decode_merge"] == n,
                      f"multirank {name} rank {r}: decode launches "
                      f"{c['flash_attention_decode']}, merges "
                      f"{c['decode_merge']}, want {n}")
            for key, lim in RankChecks.LIMITS.items():
                err = k[f"{key}_err"]
                check(err <= lim, f"multirank {name} rank {r}: {key} "
                                  f"{err:.3g} against its plain version")
            check(k["empty_differ"] == 0, f"multirank {name} rank {r}: "
                                          f"{k['empty_differ']} partials' "
                                          f"empty rows differ from plain")
            empty = below * n_local if name == "gemma2-2b full cache" and \
                r // 2 == 0 else 0          # data rank 0 of (2, 2)
            check(k["empty"] == empty, f"multirank {name} rank {r}: "
                                       f"{k['empty']} empty partials, want "
                                       f"{empty}")
        wb, gb = want["batch4"], g["batch4"]
        w, o = np.array(wb["logits"]), np.array(gb["logits"])
        d = float(np.abs(w - o).max())
        check(d <= 1e-5 * max(float(np.abs(w).max()), 1.0),
              f"multirank batch4 rank {r}: logits {d}")
        worst["batch4"] = max(worst.get("batch4", 0.0), d / max(
            float(np.abs(w).max()), 1.0))
        worst["loss"] = max(worst.get("loss", 0.0),
                            abs(wb["loss"] - gb["loss"]))
        for k in ("loss", "gnorm"):
            check(abs(wb[k] - gb[k]) <= 1e-5 * max(abs(wb[k]), 1.0),
                  f"multirank batch4 rank {r}: {k} {gb[k]} vs {wb[k]}")
        for a, b in zip(wb["params"], gb["params"]):
            a, b = np.array(a), np.array(b)
            check(float(np.abs(a - b).max()) <= 1e-5 * max(
                float(np.abs(a).max()), 1.0),
                  f"multirank batch4 rank {r}: parameters after the step")
    log(f"[multirank] {MULTIRANK_WORLD} ranks on one card (gloo, (2, 2)): "
        f"batch-1 llama3.2-1b and gemma2-2b ({steps} steps), gemma2-2b's "
        f"local window in a full cache ({steps} steps, data block 0 "
        f"wholly below the window in {below}), gemma2-2b long_mode at "
        f"pos {'4095' if small else LONG_POS}, batch-sharded B=4 prefill, "
        f"decode and train step: all within limits (worst logits of max "
        f"and loss: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"); gloo on {dev.type} tensors: {got[0]['gloo']}; each rank's "
        f"partials and merges against their plain versions: " + "; ".join(
            f"{nm} lse {max(g['checks'][nm]['lse_err'] for g in got):.3g}, "
            f"o {max(g['checks'][nm]['o_err'] for g in got):.3g} of max, "
            f"merge {max(g['checks'][nm]['merge_err'] for g in got):.3g} "
            f"of max, empty partials "
            f"{[g['checks'][nm]['empty'] for g in got]}" for nm in runs))
    operands = torch.load(Path(tmp) / "operands.pt", map_location=dev,
                          weights_only=False)
    for nm in runs:
        rows = multirank_rows(torch, dev, nm, got, operands[nm])
        for row in rows:
            kernels[row["name"]] = row
            if dev.type == "cuda":
                check(row["launches"] > 0, f"multirank: {row['name']} "
                                           f"never launched")


def multirank_rows(torch, dev, run: str, got: list, ops_: dict):
    """The rows of one batch-1 run's two kernels at the ranks' own
    shapes: the launches summed over the ranks, the worst error of the
    ranks' checks against their plain versions, and the times of rank
    0's last call of each on its own operands, here after the ranks
    have exited (the card is then this process's alone)."""
    from repro_torch.kernels import flash_attention as FA
    counts = [g["counts"][run] for g in got]
    chk = [g["checks"][run] for g in got]
    d = ops_["decode"]
    q, k, v, live, kw = d["q"], d["k"], d["v"], d["kv_valid"], d["kw"]
    B, Hq, Hkv, n, hd = chk[0]["shape"]
    first = kw.get("kv_first")
    keys = int((live - (0 if first is None else first)).clamp(min=0).sum())
    ms = time_graph_ms(torch, lambda: FA.flash_attention(q, k, v, live,
                                                         **kw), dev)
    plain_ms = time_ms(torch, lambda: FA.flash_attention_plain(
        q, k, v, live, **kw), dev, iters=5, warmup=1)
    lib_ms = None
    if not kw.get("softcap"):
        idx = torch.arange(n, device=dev)
        lo = torch.zeros_like(live) if first is None else first
        mask = ((idx >= lo[:, None]) & (idx < live[:, None]))[:, None, None]
        lib_ms = time_graph_ms(torch, sdpa_call(
            torch, q.contiguous(), k.contiguous(), v.contiguous(),
            attn_mask=mask), dev)
    bms, by = bound_ms(keys * Hkv * 2 * hd * 4 + B * Hq * hd * 8 + B * Hq * 4,
                       4.0 * Hq * hd * keys, PEAK_FP32_S)
    body = dict(name=f"flash_attention multirank {run}: B={B}, {Hq}/{Hkv} "
                     f"local heads of {hd}, a {n}-slot block (data 2), f32, "
                     f"with lse", route="cuda", source=FLASH_SRC,
                replaces=FLASH_TPU,
                launches=sum(c["flash_attention_decode"] for c in counts),
                max_abs_err=max(max(c["lse_err"], c["o_abs"]) for c in chk),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)
    m = ops_["merge"]
    O, L, dt = m["o_parts"], m["lse_parts"], m["dtype"]
    R = O.shape[0]
    esz = torch.empty((), dtype=dt).element_size()
    mb, mby = bound_ms(R * B * Hq * (hd + 1) * 4 + B * Hq * hd * esz,
                       3.0 * R * B * Hq * hd, PEAK_FP32_S)
    merge = dict(name=f"decode_merge multirank {run}: R={R}, B={B}, {Hq} "
                      f"local heads of {hd}, f32", route="cuda",
                 source=FLASH_SRC, replaces=FLASH_TPU,
                 launches=sum(c["decode_merge"] for c in counts),
                 max_abs_err=max(c["merge_abs"] for c in chk),
                 ms=time_graph_ms(torch, lambda: FA.decode_merge(O, L, dt),
                                  dev),
                 plain_ms=time_ms(torch, lambda: FA.decode_merge_plain(
                     O, L, dt), dev, iters=5, warmup=1),
                 bound_ms=mb, bound_by=mby, library_ms=None)
    log(f"[multirank] {run}: decode with lse on a {n}-slot block, "
        f"{Hq}/{Hkv} heads of {hd}, {keys} live keys: {ms:.4f} ms (plain "
        f"{plain_ms:.4f}, SDPA "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}, bound {bms:.5f} "
        f"by {by}), {body['launches']} launches; merge R={R}: "
        f"{merge['ms']:.4f} ms (plain {merge['plain_ms']:.4f}, bound "
        f"{mb:.5f} by {mby}), {merge['launches']} launches")
    return body, merge


def port_kernels() -> set:
    """The names of the kernels in the port's CUDA sources and headers."""
    import re
    names = set()
    for src in sorted((ROOT / "src/repro_torch/kernels/csrc").glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    return names


def kernel_label(name: str) -> str:
    """'update_kernel<true>' from a profiler's demangled kernel name."""
    import re
    m = re.search(r"(\w+)(<[^>(]*>)?\(", name)
    return name[:48] if m is None else m.group(1) + (m.group(2) or "")


def kernel_name(line: str) -> str:
    """'kernel name<args>' from ptxas's 'Compiling entry function' line
    (a mangled name such as ...20prefill_wgmma_kernelILi64EEEv...: each
    name after its length, so digits inside one, as in
    ``decode_q8_kernel``, are read too)."""
    import re
    # a length prefix may follow other digits (...aea721decode_...): try
    # each tail of a digit run as the length
    found = [line[m.end():m.end() + int(m.group()[i:])]
             for m in re.finditer(r"\d+(?=[A-Za-z_])", line)
             for i in range(len(m.group()))]
    names = [n for n in found if n.endswith("_kernel")
             and re.fullmatch(r"[A-Za-z_]\w*", n)]
    if not names:
        return line
    name = names[0]
    rest = line[line.index(name) + len(name):]
    a = re.match(r"I(.*?)EEv", rest)
    args = a.group(1) if a else ""
    dt = "bf16, " if "bfloat16" in args else "f32, " if args[:1] == "f" \
        else ""
    hd = re.findall(r"Li(\d+)E", args + "E")
    hd += ["true" if b == "1" else "false"
           for b in re.findall(r"Lb([01])E", args + "E")]
    targs = f"<{dt}{','.join(hd)}>" if args else ""
    return f"kernel {name}{targs}"


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, small sizes, plain versions; exits 3")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (kernels, serving, "
                         "router_paths, mega_catalog, workloads, "
                         "model_kernels, moe_kernels, window_kernels, "
                         "frontend_kernels, kv_int8_kernels, generate, "
                         "moe_generate, generate_windowed, long_context, "
                         "long_mode, generate_frontends, "
                         "kv_int8_generation, card_vs_cpu, serve_loop, "
                         "train_kernels, train, sharding, "
                         "train_card_vs_cpu, examples, ctx_decode, "
                         "multirank; generate_frontends "
                         "needs frontend_kernels, kv_int8_generation "
                         "kv_int8_kernels, train train_kernels); prints no "
                         "result, exits 4")
    ap.add_argument("--multirank-rank", nargs=2, metavar=("RANK", "DIR"),
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cpu-analyzer", metavar="JSON", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--trace-peaks", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_analyzer is not None:          # serve_loop's CPU analyzer
        return cpu_analyzer_worker(args.cpu_analyzer, args.rehearse)
    if args.trace_peaks is not None:           # train's dry-run traces
        return trace_peaks_worker(args.trace_peaks, args.rehearse)
    if args.multirank_rank is not None:        # one rank of multirank
        return multirank_worker(int(args.multirank_rank[0]),
                                args.multirank_rank[1], args.rehearse)
    try:
        import torch
        import repro_torch                                  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    if args.rehearse:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    # the train phase's dry-run traces (host only) start now, beside the
    # build and the first phases
    traced = TracedPeaks(args.rehearse) if (
        not args.only or "train" in args.only.split(",")) else None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        build.build_all(["router_topk", "bandit_update", "flash_attention",
                         "ssd_scan", "moe_gating"])
        log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
        for name, out in build.BUILD_LOG.items():
            for line in out.splitlines():
                if "Compiling entry" in line:
                    line = kernel_name(line)
                if ("registers" in line or "spill" in line or "error" in line
                        or "serialized" in line or line.startswith("kernel ")):
                    log(f"[build {name}] {line.strip()}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {dev}")
    if dev.type == "cuda":
        log(f"[env] card: {card_name()}")
    rng = np.random.default_rng(0)
    small = args.rehearse
    kernels = {}
    gen_rows = {}
    window_rows = {}
    frontend_rows = {}
    int8_rows = {}
    shared = {}
    phases = {
        "kernels": lambda: kernels.update(
            kernel_phase(torch, dev, rng, small)),
        "serving": lambda: serving_phase(torch, dev, small, kernels,
                                         shared),
        "router_paths": lambda: router_paths_phase(torch, dev, small,
                                                   kernels, shared),
        "mega_catalog": lambda: mega_catalog_phase(torch, dev, small,
                                                   kernels, shared),
        "workloads": lambda: workloads_phase(torch, dev, small, shared),
        "model_kernels": lambda: (
            kernels.update(model_kernel_phase(torch, dev, small)),
            gen_rows.update(gen_kernel_rows(torch, dev, small))),
        "moe_kernels": lambda: kernels.update(
            moe_kernel_phase(torch, dev, small)),
        "window_kernels": lambda: window_rows.update(
            window_kernel_phase(torch, dev, small)),
        "frontend_kernels": lambda: frontend_rows.update(
            frontend_kernel_phase(torch, dev, small)),
        "kv_int8_kernels": lambda: int8_rows.update(
            kv_int8_kernel_phase(torch, dev, small)),
        "generate": lambda: (
            generation_phase(torch, dev, small, kernels, gen_rows),
            release(torch, dev, "after the routing and generation phases")),
        "moe_generate": lambda: (
            moe_generation_phase(torch, dev, small, kernels),
            release(torch, dev, "after the MoE generation phase")),
        "generate_windowed": lambda: (
            windowed_generation_phase(torch, dev, small, kernels,
                                      window_rows),
            release(torch, dev, "after the windowed generation phase")),
        "long_context": lambda: long_context_phase(torch, dev, small,
                                                   kernels, window_rows),
        "long_mode": lambda: long_mode_phase(torch, dev, small, kernels),
        "generate_frontends": lambda: (
            frontend_generation_phase(torch, dev, small, kernels,
                                      frontend_rows),
            release(torch, dev, "after the frontend generation phase")),
        "kv_int8_generation": lambda: kv_int8_generation_phase(
            torch, dev, small, kernels, int8_rows),
        "card_vs_cpu": lambda: (
            card_vs_cpu_phase(torch, dev, small),
            moe_card_vs_cpu(torch, dev, small),
            card_vs_cpu_phase(torch, dev, small, WINDOWED_ARCHS, prompt=72,
                              window=48),
            card_vs_cpu_phase(torch, dev, small, FRONTEND_ARCHS)),
        "serve_loop": lambda: serve_loop_phase(torch, dev, small, kernels),
        "train_kernels": lambda: kernels.update(
            train_kernel_phase(torch, dev, small)),
        "train": lambda: train_phase(torch, dev, small, kernels, traced),
        "sharding": lambda: sharding_phase(torch, dev, small, kernels),
        "train_card_vs_cpu": lambda: train_card_vs_cpu_phase(torch, dev,
                                                             small),
        "examples": lambda: examples_phase(torch, dev, small),
        "ctx_decode": lambda: ctx_decode_phase(torch, dev, small, kernels),
        "multirank": lambda: multirank_phase(torch, dev, small, kernels),
    }
    only = args.only.split(",") if args.only else list(phases)
    unknown = set(only) - set(phases)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}; choose from "
              f"{list(phases)}", file=sys.stderr)
        return 2
    try:
        for name in phases:
            if name in only:
                t0 = time.perf_counter()
                phases[name]()
                log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if args.rehearse:
        log("[rehearse] all phases passed on the CPU; no result printed")
        return 3
    if args.only:
        log(f"[total] the run: {time.perf_counter() - T_START:.1f} s")
        log(f"[only] phases {only} passed; no result printed")
        return 4
    log(f"[total] the whole run: {time.perf_counter() - T_START:.1f} s")
    log(card_name())
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
