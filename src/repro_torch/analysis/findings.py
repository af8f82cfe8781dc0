"""Finding model, inline suppressions, and the ratcheting baseline.

Port of the JAX package's ``analysis/findings.py``, unchanged in
meaning; the rule catalog is the port's.  A ``Finding`` is one rule
violation at one source location.  Its ``fingerprint`` deliberately
excludes the line number -- fingerprints are ``sha1(rule | path |
symbol | message)`` -- so reformatting or code motion above a
violation does not churn the baseline, while any change to *what* is
wrong (rule, file, enclosing symbol, message) does.

Baseline semantics (the ratchet): ``analysis/baseline_torch.json``
holds the fingerprints of triaged, pre-existing findings *with
multiplicity*.  A lint run fails only on findings beyond the baselined
count per fingerprint -- new violations fail, baselined ones pass, and
fixing a violation can only shrink the file.

Inline suppressions: ``# lint: ignore[rule1,rule2] -- reason`` on the
flagged line (or the line directly above) silences those rules there.
The reason is REQUIRED: a ``# lint: ignore`` without a rule list or
without a ``-- reason`` is itself reported as ``bad-suppression``.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# every rule the engine can emit, with a one-line catalog entry
# (README + `--rules` render this; tests pin the set so renames are
# deliberate)
RULES: Dict[str, str] = {
    "lock-mixed-mutation":
        "attribute mutated both inside and outside `with self._lock`",
    "lock-unlocked-read":
        "public method reads multiple lock-guarded attributes without "
        "holding the lock (torn multi-field read)",
    "torch-host-sync":
        "host synchronization (.item() / .tolist() / .cpu() / "
        "torch.cuda.synchronize / a Python cast of a tensor reduction) "
        "in a dispatch module (repro_torch/kernels)",
    "torch-constant-rebuild":
        "torch.tensor of a fresh per-call Python literal in a hot-path "
        "function (a host->device copy on every call)",
    "torch-bucket-bypass":
        "raw route-step / analyze-step program called outside "
        "repro_torch/kernels (bypasses the q_bucket/n_bucket pads)",
    "port-imports-reference":
        "`import jax` or an import of the JAX package `repro` in the port "
        "or chip_smoke.py",
    "kernel-silent-fallback":
        "an `except` handler that calls a kernel's plain version (the "
        "silent CPU fallback the port forbids)",
    "kernel-missing-plain":
        "kernel wrapper in kernels/*.py without its plain PyTorch "
        "version beside it",
    "kernel-missing-oracle-test":
        "plain version never held against its repro.kernels.ref oracle "
        "by a CPU test under tests/",
    "kernel-missing-card-check":
        "kernel never held against its plain version on the card "
        "(tests/test_torch_cuda*.py or chip_smoke.py)",
    "bad-suppression":
        "malformed `# lint: ignore` (missing [rule] list or -- reason)",
}

# JSON output schema version — tests pin this; bump on breaking change
SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str                 # repo-relative, "/"-separated
    line: int                 # 1-indexed
    col: int
    message: str
    symbol: str = ""          # enclosing "Class.method" / function

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha1(
            f"{self.rule}|{self.path}|{self.symbol}|{self.message}"
            .encode()).hexdigest()[:16]
        return f"{self.rule}:{h}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "symbol": self.symbol,
                "message": self.message,
                "fingerprint": self.fingerprint}

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}"
                f"{sym}: {self.message}")


# --------------------------------------------------------------------
# inline suppressions
# --------------------------------------------------------------------

# full, well-formed form: rules list AND a non-empty reason
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*ignore\[([A-Za-z0-9_,\- ]+)\]\s*--\s*(\S.*)")
# anything that *tries* to be a lint suppression (to catch bare ones)
_SUPPRESS_ANY_RE = re.compile(r"#\s*lint:\s*ignore")


def _comment_lines(lines: List[str]):
    """(lineno, comment_text) for real COMMENT tokens only — a
    suppression example quoted in a docstring is not a suppression."""
    import io
    import tokenize
    try:
        toks = list(tokenize.generate_tokens(
            io.StringIO("\n".join(lines) + "\n").readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        # unparseable fragment: fall back to raw lines (lint runs on
        # parsed files, so this only happens for snippets in tests)
        return list(enumerate(lines, start=1))
    return [(tok.start[0], tok.string) for tok in toks
            if tok.type == tokenize.COMMENT]


@dataclass
class Suppressions:
    """Per-file map of line -> set of suppressed rules, plus findings
    for malformed suppression comments."""
    by_line: Dict[int, set] = field(default_factory=dict)
    malformed: List[Tuple[int, str]] = field(default_factory=list)

    @classmethod
    def scan(cls, lines: List[str]) -> "Suppressions":
        out = cls()
        for i, text in _comment_lines(lines):
            if not _SUPPRESS_ANY_RE.search(text):
                continue
            m = _SUPPRESS_RE.search(text)
            if not m:
                out.malformed.append(
                    (i, "suppression must name its rules and a reason: "
                        "`# lint: ignore[rule] -- reason`"))
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            unknown = sorted(r for r in rules if r not in RULES)
            if unknown:
                out.malformed.append(
                    (i, f"suppression names unknown rule(s) "
                        f"{', '.join(unknown)}"))
                rules -= set(unknown)
            # a suppression covers its own line plus the next *code*
            # line: a trailing comment covers its statement, and a
            # comment block above a statement (the reason often wraps
            # over several comment lines) covers the statement below it
            j = i + 1
            while (j <= len(lines)
                   and lines[j - 1].lstrip().startswith("#")):
                j += 1
            for ln in range(i, j + 1):
                out.by_line.setdefault(ln, set()).update(rules)
        return out

    def covers(self, finding: Finding) -> bool:
        return finding.rule in self.by_line.get(finding.line, ())


# --------------------------------------------------------------------
# baseline (the ratchet)
# --------------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, int]:
    """fingerprint -> allowed multiplicity (empty when absent)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    counts: Dict[str, int] = {}
    for row in data.get("findings", []):
        fp = row["fingerprint"]
        counts[fp] = counts.get(fp, 0) + 1
    return counts


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    rows = sorted((f.to_dict() for f in findings),
                  key=lambda r: (r["path"], r["rule"], r["line"]))
    for r in rows:
        # line/col are context for the human reading the file, not part
        # of the match — drop nothing, but order keys stably
        r.pop("col", None)
    with open(path, "w") as f:
        json.dump({"version": SCHEMA_VERSION,
                   "comment": "triaged pre-existing lint findings; the "
                              "gate fails only on findings NOT counted "
                              "here (ratchet -- see repro_torch.analysis)",
                   "findings": rows}, f, indent=1, sort_keys=True)
        f.write("\n")


def split_new(findings: List[Finding], baseline: Dict[str, int]
              ) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined): matches findings against the baseline's
    per-fingerprint multiplicity, greedily in file order."""
    budget = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        fp = f.fingerprint
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


def stale_baseline(findings: List[Finding], baseline: Dict[str, int]
                   ) -> Dict[str, int]:
    """Baseline entries with no surviving finding (fixed or moved):
    fingerprint -> unused count.  Informational — `--write-baseline`
    prunes them."""
    live: Dict[str, int] = {}
    for f in findings:
        live[f.fingerprint] = live.get(f.fingerprint, 0) + 1
    out = {}
    for fp, n in baseline.items():
        unused = n - live.get(fp, 0)
        if unused > 0:
            out[fp] = unused
    return out
