"""Quickstart on the PyTorch port: route three queries with different
preference profiles.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py``: the 10-architecture catalog,
the port's task analyzer trained in miniature, then per profile the
analyzer's JSON, the kNN + hierarchical filter + weighted scoring and
its ``RoutingDecision``, and a thumbs-down feedback update.  On the
card by default (``--device cpu`` runs the kernels' plain versions).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
from repro_torch.core.orchestrator import OptiRoute
from repro_torch.serving.catalog import build_catalog

QUERIES = [
    ("cost-effective",
     "find the sentiment of the passage the quarterly portfolio report "
     "shows hedging gains during review"),
    ("accuracy-first",
     "solve this step by step however the paradox in the nested clause "
     "is subtle prove that the liability statute holds for all cases"),
    ("latency-first",
     "hello can you help me with travel cooking ideas"),
]
ANALYZER = AnalyzerConfig(d_model=64, n_layers=1, d_ff=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-samples", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)

    print("== building the 10-architecture MRES catalog ==")
    mres = build_catalog()
    for e in mres.entries:
        m = e.raw_metrics
        print(f"  {e.name:<28} acc={m['accuracy']:.2f} "
              f"lat={m['latency_ms']:.4f}ms cost=${m['cost_per_mtok']:.4f}/Mtok")

    print("\n== training the task analyzer (miniature; one-off) ==")
    analyzer = TaskAnalyzer(ANALYZER, device=args.device)
    metrics = analyzer.train(n_samples=args.n_samples, steps=args.steps)
    print(f"  {metrics}")

    router = OptiRoute(mres, analyzer, device=args.device)
    print("\n== routing ==")
    routed = []
    for profile, text in QUERIES:
        rq = router.route(text, profile)
        print(f"\n  profile={profile}")
        print(f"  query:    {text[:64]}...")
        print(f"  analyzer: {analyzer.to_json(rq.sig)}")
        d = rq.decision
        print(f"  decision: {d.model} (score {d.score:.3f}, "
              f"similarity {d.similarity:.3f}"
              f"{', fallback ' + d.fallback_kind if d.used_fallback else ''})")
        print(f"  stages:   {d.stage_sizes}")
        print(f"  runner-up: {d.candidates[1] if len(d.candidates) > 1 else '—'}")
        routed.append(rq)

    print("\n== feedback ==")
    last = routed[-1]
    bias = router.give_feedback(last, thumbs_up=False)
    print(f"  thumbs-down on {last.decision.model}: cluster bias -> {bias}")
    rq2 = router.route(QUERIES[-1][1], QUERIES[-1][0])
    print(f"  re-route after feedback: {rq2.decision.model}")
    return routed, rq2


if __name__ == "__main__":
    main()
