"""Declarative SLO rules with burn-rate breach detection.

Rule grammar (one rule per line / per ``--rule`` flag)::

    [name:] <metric> <op> <threshold> [burn <short>s/<long>s [x<factor>]]

    route_p99:  route_latency_p99 <= 0.05
    shed:       shed_rate         <= 0.01   burn 60s/600s x2
    cache:      cache_hit_rate    >= 0.30
    recompiles: route_step_compiles == 0

Without a ``burn`` clause the rule is a point check against the
current metric value.  With one, the rule becomes a multi-window
burn-rate alert in the SRE-workbook style: the evaluator keeps
cumulative ``(ts, bad, total)`` snapshots (fed via ``observe``) and
fires only when the *bad fraction* over BOTH the short and the long
window exceeds ``factor * threshold`` — the short window makes the
alert reset quickly when the problem stops, the long window keeps a
brief spike from paging.  Ratio metrics (``*_rate``) map naturally;
for point metrics the "bad fraction" degenerates to the windowed mean.

``evaluate`` returns per-rule verdicts; the CLI (``python -m
repro_torch.obs.slo --metrics metrics.prom --rule ...``) exits 1 on
any breach, so a script can gate on a dumped run.
"""
from __future__ import annotations

import argparse
import re
import sys
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    ">": lambda v, t: v > t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}

_RULE_RE = re.compile(
    r"^\s*(?:(?P<name>[\w.-]+)\s*:)?\s*"
    r"(?P<metric>[\w.]+)\s*"
    r"(?P<op><=|>=|==|!=|<|>)\s*"
    r"(?P<threshold>[-+0-9.eE]+)\s*"
    r"(?:burn\s+(?P<short>[0-9.]+)s\s*/\s*(?P<long>[0-9.]+)s"
    r"(?:\s*x(?P<factor>[0-9.]+))?)?\s*$")


@dataclass(frozen=True)
class SLORule:
    name: str
    metric: str
    op: str                       # one of _OPS
    threshold: float
    burn_short_s: Optional[float] = None   # None -> point check
    burn_long_s: Optional[float] = None
    burn_factor: float = 1.0

    @property
    def is_burn(self) -> bool:
        return self.burn_short_s is not None

    def check(self, value: float) -> bool:
        """Point check: True when the SLO holds."""
        return _OPS[self.op](value, self.threshold)

    def describe(self) -> str:
        s = f"{self.name}: {self.metric} {self.op} {self.threshold:g}"
        if self.is_burn:
            s += (f" burn {self.burn_short_s:g}s/{self.burn_long_s:g}s"
                  f" x{self.burn_factor:g}")
        return s


def parse_rule(line: str) -> SLORule:
    m = _RULE_RE.match(line)
    if not m:
        raise ValueError(f"unparseable SLO rule: {line!r}")
    g = m.groupdict()
    short = float(g["short"]) if g["short"] else None
    long_ = float(g["long"]) if g["long"] else None
    if (short is None) != (long_ is None):
        raise ValueError(f"burn clause needs both windows: {line!r}")
    if short is not None and short >= long_:
        raise ValueError(
            f"burn short window must be < long window: {line!r}")
    return SLORule(name=g["name"] or g["metric"], metric=g["metric"],
                   op=g["op"], threshold=float(g["threshold"]),
                   burn_short_s=short, burn_long_s=long_,
                   burn_factor=float(g["factor"]) if g["factor"] else 1.0)


def parse_rules(text_or_lines) -> List[SLORule]:
    """Parse a rules file body or an iterable of rule strings;
    blank lines and ``#`` comments are skipped."""
    if isinstance(text_or_lines, str):
        lines = text_or_lines.splitlines()
    else:
        lines = list(text_or_lines)
    rules = []
    for ln in lines:
        ln = ln.split("#", 1)[0].strip()
        if ln:
            rules.append(parse_rule(ln))
    return rules


@dataclass
class Verdict:
    rule: SLORule
    ok: bool
    value: float
    detail: str = ""

    def line(self) -> str:
        mark = "OK   " if self.ok else "BREACH"
        out = f"[{mark}] {self.rule.describe()}  (value={self.value:g}"
        if self.detail:
            out += f"; {self.detail}"
        return out + ")"


@dataclass
class _Series:
    """Cumulative (ts, bad, total) snapshots for one burn-rate rule."""
    points: deque = field(default_factory=lambda: deque(maxlen=4096))

    def observe(self, ts: float, bad: float, total: float) -> None:
        # cumulative, so each point must be >= its predecessor
        if self.points:
            pt, pb, ptot = self.points[-1]
            bad = max(bad, pb)
            total = max(total, ptot)
        self.points.append((ts, bad, total))

    def rate_over(self, now: float, window_s: float) -> Optional[float]:
        """Bad fraction over [now - window_s, now]; None until the
        window has at least two snapshots to difference."""
        if len(self.points) < 2:
            return None
        ts = [p[0] for p in self.points]
        i = bisect_left(ts, now - window_s)
        i = min(i, len(self.points) - 2)
        t0, bad0, tot0 = self.points[i]
        t1, bad1, tot1 = self.points[-1]
        if t1 <= t0:
            return None
        dtot = tot1 - tot0
        if dtot <= 0:
            return 0.0
        return (bad1 - bad0) / dtot


class SLOEvaluator:
    """Evaluates a rule set against metric snapshots.

    Point rules read the latest value.  Burn-rate rules additionally
    need ``observe(now, metrics, totals)`` calls over time so the
    evaluator can difference cumulative bad/total counts per window.
    For a ``*_rate`` metric the evaluator derives bad/total from the
    companion cumulative counters when provided via ``totals`` —
    e.g. ``{"shed_rate": (shed_count, planned_count)}``.
    """

    def __init__(self, rules: Sequence[SLORule]):
        self.rules = list(rules)
        self._series: Dict[str, _Series] = {
            r.name: _Series() for r in self.rules if r.is_burn}

    def observe(self, now: float, metrics: Dict[str, float],
                totals: Optional[Dict[str, Tuple[float, float]]] = None
                ) -> None:
        """Feed a snapshot: current metric values plus, for burn-rate
        ratio rules, cumulative (bad, total) counter pairs."""
        totals = totals or {}
        for r in self.rules:
            if not r.is_burn:
                continue
            if r.metric in totals:
                bad, total = totals[r.metric]
            else:
                # point metric: treat the value itself as the "bad"
                # accumulation against a unit-rate total
                v = metrics.get(r.metric, 0.0)
                prev = self._series[r.name].points
                n = (prev[-1][2] + 1.0) if prev else 1.0
                bad, total = (prev[-1][1] + v if prev else v), n
            self._series[r.name].observe(now, bad, total)

    def evaluate(self, metrics: Dict[str, float],
                 now: Optional[float] = None) -> List[Verdict]:
        verdicts = []
        for r in self.rules:
            value = metrics.get(r.metric, 0.0)
            if not r.is_burn:
                verdicts.append(Verdict(r, r.check(value), value))
                continue
            series = self._series[r.name]
            t = now if now is not None else (
                series.points[-1][0] if series.points else 0.0)
            short = series.rate_over(t, r.burn_short_s)
            long_ = series.rate_over(t, r.burn_long_s)
            limit = r.burn_factor * r.threshold
            if short is None or long_ is None:
                # not enough history: fall back to the point check
                verdicts.append(Verdict(r, r.check(value), value,
                                        "insufficient history"))
                continue
            breach = short > limit and long_ > limit
            verdicts.append(Verdict(
                r, not breach, value,
                f"burn short={short:g} long={long_:g} limit={limit:g}"))
        return verdicts


def evaluate_rules(rules: Sequence[SLORule],
                   metrics: Dict[str, float]) -> List[Verdict]:
    """One-shot point evaluation (the CLI path)."""
    return SLOEvaluator(rules).evaluate(metrics)


# ----------------------------------------------------------------------
# CLI: python -m repro_torch.obs.slo --metrics metrics.prom \
#          --rule "route_step_compiles == 0" --rule "shed_rate <= 0.0"
# ----------------------------------------------------------------------
def main(argv=None) -> int:
    from .export import metrics_from_prom

    p = argparse.ArgumentParser(
        description="Evaluate SLO rules against a Prometheus text dump")
    p.add_argument("--metrics", required=True,
                   help="path to a metrics.prom exposition dump")
    p.add_argument("--rule", action="append", default=[],
                   help="inline rule (repeatable)")
    p.add_argument("--rules-file", default=None,
                   help="file with one rule per line")
    args = p.parse_args(argv)

    lines = list(args.rule)
    if args.rules_file:
        with open(args.rules_file) as f:
            lines.extend(f.read().splitlines())
    rules = parse_rules(lines)
    if not rules:
        print("no SLO rules given", file=sys.stderr)
        return 2

    with open(args.metrics) as f:
        metrics = metrics_from_prom(f.read())

    verdicts = evaluate_rules(rules, metrics)
    bad = 0
    for v in verdicts:
        print(v.line())
        bad += not v.ok
    print(f"{len(verdicts) - bad}/{len(verdicts)} SLO rules hold")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
