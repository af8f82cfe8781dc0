"""End-to-end on the PyTorch port: serve a batched request stream
through OptiRoute with real (reduced) models executing the routed
requests.

  PYTHONPATH=src python examples/serve_routed_torch.py [--requests 16]
      [--device cpu]

The twin of ``examples/serve_routed.py``: requests with mixed
preference profiles arrive, each is analyzed and routed, requests that
landed on the same model run as ONE batched generate on that model's
runner (dense / MoE / SSM / hybrid reduced configs), thumbs feedback is
recorded, and the engine prints the cost/latency ledger.  On the card
by default, where the routing and the generation run the hand-written
kernels.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
from repro_torch.core.orchestrator import OptiRoute
from repro_torch.core.preferences import PROFILES
from repro_torch.data.workload import make_workload, quality_of
from repro_torch.serving.catalog import build_catalog
from repro_torch.serving.engine import Request, ServingEngine

RUNNER_ARCHS = ["llama3.2-1b", "qwen3-moe-30b-a3b", "mamba2-1.3b",
                "hymba-1.5b", "gemma2-2b"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--mode", choices=("interactive", "batch"),
                    default="interactive")
    ap.add_argument("--steps", type=int, default=120,
                    help="the analyzer's training steps")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    print(f"== catalog with live reduced runners: {RUNNER_ARCHS} ==")
    mres = build_catalog(smoke_runners=True, archs=RUNNER_ARCHS,
                         device=args.device)

    analyzer = TaskAnalyzer(AnalyzerConfig(d_model=64, n_layers=1, d_ff=128),
                            device=args.device)
    print("== training analyzer ==")
    print("  ", analyzer.train(n_samples=1024, steps=args.steps))

    router = OptiRoute(mres, analyzer, device=args.device)
    engine = ServingEngine(router)

    profiles = list(PROFILES)
    wl = make_workload(args.requests, seed=7)
    reqs = [Request(text=r.text, prefs=profiles[i % len(profiles)], id=r.id,
                    max_new=args.max_new) for i, r in enumerate(wl)]

    print(f"\n== serving {len(reqs)} requests ({args.mode}) ==")
    resps = engine.submit(reqs, mode=args.mode)
    for r, rec in zip(resps, wl):
        entry = mres.entry(r.model)
        q = quality_of({"accuracy": entry.raw_metrics["accuracy"],
                        "task_types": entry.task_types,
                        "domains": entry.domains}, rec.sig)
        up = q > 0.55
        engine.feedback(r, thumbs_up=up)
        print(f"  #{r.request.id:>3} [{r.request.prefs:<17}] "
              f"{r.sig.task_type}/{r.sig.domain} -> {r.model:<22} "
              f"tokens={r.tokens.tolist() if r.tokens is not None else None} "
              f"{'+1' if up else '-1'}")

    s = engine.summary()
    print("\n== ledger ==")
    print(f"  requests:         {s['requests']}")
    print(f"  per-model counts: {s['models']}")
    print(f"  simulated chip-s: {s['sim_latency_s']:.4f}")
    print(f"  route overhead:   {s['route_s']*1e3:.1f} ms total")
    print(f"  analyzer:         {s['analyzer_s']*1e3:.1f} ms total")
    return resps, s


if __name__ == "__main__":
    main()
