"""CLI: ``python -m repro_torch.analysis.lint [paths...]``.

Port of the JAX package's ``analysis/lint.py``.  Exit codes: 0 -- clean
(or all findings baselined), 1 -- new findings, 2 -- usage / parse
errors.

The gate is ``python -m repro_torch.analysis.lint src/repro_torch
chip_smoke.py`` from the repo root, with the baseline at
``analysis/baseline_torch.json``.  ``--write-baseline`` re-triages: it
records the *current* finding set (after fixes and inline
suppressions) as the new baseline, pruning stale entries -- the
ratchet only ever tightens unless a human commits a wider file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.analysis.engine import run_lint
from repro_torch.analysis.findings import (RULES, SCHEMA_VERSION, load_baseline,
                                     save_baseline, split_new,
                                     stale_baseline)

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's AST lint (lock discipline, eager-PyTorch "
                    "hazards, imports, kernel conformance)")
    p.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                   help="files or directories to lint "
                        "(default: src/repro_torch chip_smoke.py)")
    p.add_argument("--root", default=None,
                   help="directory findings are reported relative to "
                        "(default: cwd)")
    p.add_argument("--tests-dir", default=None,
                   help="tests directory for kernel-parity discovery "
                        "(default: <root>/tests when present)")
    p.add_argument("--baseline", default="analysis/baseline_torch.json",
                   help="ratchet baseline file (default: "
                        "analysis/baseline_torch.json; missing file = "
                        "empty)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report and gate on ALL "
                        "findings")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current finding set to --baseline "
                        "and exit 0")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as a JSON document on stdout")
    p.add_argument("--rules", action="store_true", dest="show_rules",
                   help="print the rule catalog and exit")
    return p


def main(argv: List[str] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.show_rules:
        for rule, desc in RULES.items():
            print(f"{rule:28s} {desc}")
        return 0

    paths = args.paths or list(DEFAULT_PATHS)
    result = run_lint(paths, root=args.root, tests_dir=args.tests_dir)
    for rel, err in result.errors:
        print(f"{rel}: parse error: {err}", file=sys.stderr)

    if args.write_baseline:
        os.makedirs(os.path.dirname(os.path.abspath(args.baseline)),
                    exist_ok=True)
        save_baseline(args.baseline, result.findings)
        print(f"wrote {len(result.findings)} finding(s) to "
              f"{args.baseline}")
        return 0

    baseline = ({} if args.no_baseline
                else load_baseline(args.baseline))
    new, baselined = split_new(result.findings, baseline)
    stale = stale_baseline(result.findings, baseline)

    if args.as_json:
        doc = {
            "schema_version": SCHEMA_VERSION,
            "n_files": result.n_files,
            "findings": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in baselined],
            "stale_baseline": stale,
            "errors": [{"path": p, "error": e} for p, e in result.errors],
        }
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        for f in new:
            print(f.render())
        tail = (f"{result.n_files} file(s): {len(new)} new finding(s), "
                f"{len(baselined)} baselined")
        if stale:
            tail += (f", {sum(stale.values())} stale baseline entr"
                     f"{'y' if sum(stale.values()) == 1 else 'ies'} "
                     f"(re-run --write-baseline to prune)")
        print(tail)

    if result.errors:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
