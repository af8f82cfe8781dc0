"""Serving launcher: the deployable OptiRoute service loop (port of the
JAX package's ``launch/serve.py``).

Builds the MRES catalog with runners, loads or trains the Task
Analyzer, then serves a synthetic request stream through the batched
``ServingEngine``, printing per-request routing decisions and the final
accounting summary.  On the card (the default) the runners are the
published configs with seeded random bf16 weights drawn there; with
``--device cpu`` they are the ``SMOKE`` configs, as the reference builds
them on its CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 24
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mode batch

``--async`` drives the same request stream through the asyncio front
end (``AsyncServingEngine``): per-request awaitable submits, micro-batch
windows, per-tenant attribution.  ``--soak SECONDS`` replays a bursty
multi-tenant episode (two quiet tenants and a rate-limited flooding
one) through the engine's window path in virtual time and prints the
per-tenant admission tally.  ``main`` returns what it printed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Dict, List

from repro_torch.configs import ARCH_NAMES
from repro_torch.core.analyzer import (AnalyzerConfig, TaskAnalyzer,
                                       params_from_jax, params_to_tree)
from repro_torch.core.orchestrator import OptiRoute
from repro_torch.core.preferences import PROFILES
from repro_torch.data.workload import make_workload
from repro_torch.device import resolve_device
from repro_torch.serving.catalog import build_catalog
from repro_torch.serving.engine import Request, ServingEngine

ANALYZER_CKPT = (pathlib.Path(__file__).resolve().parents[3] / "results"
                 / "analyzer.npz")

# configs the card serves by default: their full-width bf16 weights fit
# one H100 together (about 41 GB by ``n_params``); the others, and why
CARD_ARCHS = ("llama3.2-1b", "qwen2-1.5b", "mamba2-1.3b", "hymba-1.5b",
              "h2o-danube-3-4b", "gemma2-2b", "seamless-m4t-medium",
              "llava-next-mistral-7b")
LEFT_OUT = {
    "qwen3-moe-30b-a3b": "59.5 GB of bf16 weights alone; serve it with "
                         "--archs qwen3-moe-30b-a3b llama3.2-1b",
    "llama4-maverick-400b-a17b": "does not fit one card (ROADMAP.md, "
                                 "Queue 1 item 7: several cards)",
}


def default_archs(device) -> List[str]:
    """The configs served when ``--archs`` is not given: on the card
    ``CARD_ARCHS``, on the CPU all ten (``SMOKE``), as the reference."""
    if resolve_device(device).type == "cuda":
        return list(CARD_ARCHS)
    return list(ARCH_NAMES)


def load_analyzer(path=ANALYZER_CKPT, train_steps: int = 250, *,
                  device=None) -> TaskAnalyzer:
    """The analyzer checkpoint at ``path`` (the reference's nested
    layout, so either package's file loads), or a freshly trained
    analyzer saved there (first run only)."""
    from repro_torch.checkpoint import load, save
    path = pathlib.Path(path)
    if path.exists():
        tree, _ = load(str(path))
        return TaskAnalyzer(AnalyzerConfig(), state=params_from_jax(tree),
                            device=device)
    an = TaskAnalyzer(AnalyzerConfig(), device=device)
    print("[serve] training task analyzer (first run only) ...")
    metrics = an.train(steps=train_steps)
    save(str(path), params_to_tree(an.state), {"metrics": metrics})
    return an


def _run_async(engine, reqs, args):
    """Drive ``reqs`` through the asyncio front end; returns (responses,
    window sizes)."""
    import asyncio

    from repro_torch.serving.async_engine import AsyncServingEngine

    tenants = ("acme", "globex")
    for i, r in enumerate(reqs):
        r.tenant = r.tenant or tenants[i % len(tenants)]
    aeng = AsyncServingEngine(engine, max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms)
    print(f"[serve] submitting {len(reqs)} requests (async, "
          f"max_batch={args.max_batch} max_wait={args.max_wait_ms}ms) ...")

    async def _drive():
        async with aeng:
            return await asyncio.gather(*(aeng.submit(r) for r in reqs))

    resps = asyncio.run(_drive())
    print(f"[serve] async windows: {aeng.windows}")
    return resps, aeng.windows


def _run_soak(engine, telemetry, args) -> Dict:
    """Virtual-time bursty multi-tenant replay through the window path:
    two well-behaved tenants and a rate-limited flooding one; every
    window goes through the same ``engine.submit`` the flat stream
    uses.  Prints the per-tenant admission tally; returns it with the
    window sizes and the intake counters (``MicroBatcher.stats``)."""
    from repro_torch.data.workload import (MultiTenantScenario, TenantSpec,
                                           TrafficScenario,
                                           multi_tenant_arrivals)
    from repro_torch.serving.async_engine import MicroBatcher, TenantPolicy

    sc = MultiTenantScenario(
        base=TrafficScenario(duration_s=float(args.soak), base_rate=4.0,
                             burst_rate=16.0, burst_start=0.3,
                             burst_len=0.3, deadline_ms=800.0,
                             seed=args.seed),
        tenants=(TenantSpec("acme", weight=2.0),
                 TenantSpec("globex"),
                 TenantSpec("flood", rate_scale=3.0, rate_limit=6.0,
                            deadline_ms=400.0)))
    times, tidx = multi_tenant_arrivals(sc)
    wl = make_workload(64, seed=args.seed + 1)
    mb = MicroBatcher(
        max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
        policies={t.name: TenantPolicy(weight=t.weight, rate=t.rate_limit)
                  for t in sc.tenants})
    tally: Dict[str, Dict[str, int]] = {}
    windows: List[int] = []

    def bump(tenant, kind):
        tally.setdefault(tenant, {}).setdefault(kind, 0)
        tally[tenant][kind] += 1

    def flush(now):
        items = mb.take(now)
        if not items:
            return
        windows.append(len(items))
        for r in engine.submit(items):
            bump(r.request.tenant, r.admission)

    print(f"[serve] soak: replaying {times.size} arrivals over "
          f"{float(args.soak):.0f}s virtual time ...")
    for k in range(times.size):
        t = float(times[k])
        while True:                       # flush windows that came due
            dl = mb.next_deadline(t)
            if dl is None or dl > t:
                break
            flush(dl)
        ti = int(tidx[k])
        name = sc.tenants[ti].name
        src = wl[k % len(wl)]
        req = Request(text=src.text, prefs="balanced", id=k,
                      max_new=args.max_new,
                      deadline_ms=sc.deadline_ms_of(ti), tenant=name)
        if mb.offer(name, req, t) != "queued":
            bump(name, "shed")            # intake-level rejection
            if telemetry is not None:
                telemetry.record_admission("shed", tenant=name)
    end = float(times[-1]) if times.size else 0.0
    while mb.pending():                   # drain the tail
        dl = mb.next_deadline(end)
        end = max(end, dl if dl is not None else end)
        flush(end)

    print(f"[serve] soak: {len(windows)} windows "
          f"(max {max(windows) if windows else 0})")
    for name in sorted(tally):
        print(f"  {name:>8}: "
              + ", ".join(f"{k}={v}" for k, v in sorted(tally[name].items())))
    return {"tally": tally, "windows": windows, "intake": mb.stats}


def main(argv=None) -> Dict:
    """Run the service loop; returns what it printed: ``responses`` (the
    flat, batch and async streams) or ``tally`` and ``intake`` (the
    soak), ``windows`` (async and soak), ``serve_s`` (the stream's
    seconds on the host clock, from the first request to the last
    response), ``summary``, and the ``engine`` (its router, catalog
    and load tracker)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--mode", choices=("interactive", "batch"),
                    default="interactive")
    ap.add_argument("--profile", default=None,
                    help="force one preference profile; default cycles")
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--archs", nargs="*", default=None,
                    help="subset of catalog archs to load runners for "
                         "(default: the card's CARD_ARCHS, or all ten "
                         "with --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--merge-threshold", type=float, default=None)
    ap.add_argument("--metrics-out", default=None,
                    help="dump Prometheus text exposition here "
                         "(e.g. results/metrics.prom)")
    ap.add_argument("--trace-out", default=None,
                    help="dump the span ring as JSONL here "
                         "(e.g. results/trace.jsonl)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics on this port while the "
                         "request stream runs (0 = ephemeral)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="drive requests through the asyncio front-end "
                         "(micro-batch windows + per-tenant intake)")
    ap.add_argument("--soak", type=float, default=None, metavar="SECONDS",
                    help="replay a SECONDS-long bursty multi-tenant "
                         "episode through the window path in virtual "
                         "time instead of the flat request stream")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="aggregation window size (--async / --soak)")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="aggregation window age bound (--async / --soak)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: raises without a card) or "
                         "'cpu' (SMOKE runners, plain kernel versions)")
    ap.add_argument("--analyzer-ckpt", default=str(ANALYZER_CKPT),
                    help="analyzer checkpoint to load, or to train and "
                         "save on first run")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    obs_on = (args.metrics_out or args.trace_out
              or args.metrics_port is not None)
    tracer = telemetry = None
    if obs_on:
        from repro_torch.core.telemetry import Telemetry
        from repro_torch.obs import Tracer
        tracer = Tracer()
        telemetry = Telemetry()

    archs = args.archs or default_archs(device)
    if not args.archs:
        for name in ARCH_NAMES:
            if name not in archs:
                print(f"[serve] leaving out {name}: {LEFT_OUT[name]}")
    print(f"[serve] building catalog ({'published' if on_card else 'SMOKE'}"
          f" runners on {device}): {', '.join(archs)} ...")
    mres = build_catalog(full_runners=on_card, smoke_runners=not on_card,
                         archs=archs, device=device)
    analyzer = load_analyzer(args.analyzer_ckpt, device=device)
    extra = {}
    if args.use_async or args.soak is not None:
        # the window path exercises deadline admission, so the router
        # gets a live load tracker (the flat stream stays load-blind)
        from repro_torch.serving.load import LoadTracker
        extra = dict(load=LoadTracker(default_service_s=0.05),
                     load_weight=1.0)
    router = OptiRoute(mres, analyzer, merge_threshold=args.merge_threshold,
                       telemetry=telemetry, tracer=tracer, device=device,
                       **extra)
    engine = ServingEngine(router)

    server = None
    if args.metrics_port is not None:
        from repro_torch.obs import serve_metrics
        server = serve_metrics(telemetry, tracer=tracer,
                               port=args.metrics_port)
        print(f"[serve] /metrics on http://127.0.0.1:{server.port}/metrics")

    out: Dict = {"responses": None, "tally": None, "intake": None,
                 "windows": None}
    try:
        profiles = [args.profile] if args.profile else list(PROFILES)
        t0 = time.perf_counter()
        if args.soak is not None:
            out.update(_run_soak(engine, telemetry, args))
        else:
            wl = make_workload(args.requests, seed=args.seed)
            reqs = [Request(text=r.text, prefs=profiles[i % len(profiles)],
                            id=r.id, max_new=args.max_new)
                    for i, r in enumerate(wl)]
            if args.use_async:
                resps, out["windows"] = _run_async(engine, reqs, args)
            else:
                print(f"[serve] submitting {len(reqs)} requests "
                      f"({args.mode}) ...")
                resps = engine.submit(reqs, mode=args.mode)
            for r in resps:
                print(f"  #{r.request.id:>3} prefs={r.request.prefs:<18} "
                      f"sig=({r.sig.task_type}/{r.sig.domain}"
                      f"/{r.sig.complexity:.2f}) -> {r.model}"
                      f"{'  [' + r.fallback + ']' if r.fallback else ''}")
                # thumbs: a synthetic user approves iff the routed model
                # is tagged for the task type
                entry = mres.entry(r.model)
                engine.feedback(
                    r, thumbs_up=r.sig.task_type in entry.task_types)
            out["responses"] = resps
        out["serve_s"] = time.perf_counter() - t0
        print(f"[serve] served in {out['serve_s']:.3f} s")
        out["summary"] = engine.summary()
        print("[serve] summary:", json.dumps(out["summary"], indent=2))

        if args.metrics_out:
            from repro_torch.obs import write_prom
            pathlib.Path(args.metrics_out).parent.mkdir(parents=True,
                                                        exist_ok=True)
            write_prom(args.metrics_out, telemetry, load=engine.load,
                       tracer=tracer)
            print(f"[serve] metrics -> {args.metrics_out}")
        if args.trace_out:
            pathlib.Path(args.trace_out).parent.mkdir(parents=True,
                                                      exist_ok=True)
            n = tracer.export_jsonl(args.trace_out)
            print(f"[serve] {n} spans -> {args.trace_out}")
    finally:
        if server is not None:
            server.close()
    out["engine"] = engine
    return out


if __name__ == "__main__":
    main()
