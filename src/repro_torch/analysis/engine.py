"""Lint engine core: source model, rule registry, and ``run_lint``.

Port of the JAX package's ``analysis/engine.py``, over the port's rules.

Two rule shapes:

* **file rules** — ``check_file(src: Source) -> Iterable[Finding]``,
  called once per parsed file (lock discipline, the eager-PyTorch
  hazards);
* **project rules** — ``check_project(ctx: Project) -> ...``, called
  once per run with the whole file set (kernel-oracle conformance
  needs kernels/, tests/ and chip_smoke.py together).

``run_lint`` parses each ``.py`` file once, runs every rule, then drops
findings covered by well-formed inline suppressions (malformed ones
become ``bad-suppression`` findings — no bare suppressions).
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional

from repro_torch.analysis.findings import Finding, Suppressions


@dataclass
class Source:
    path: str                 # absolute
    rel: str                  # repo-relative, "/"-separated
    text: str
    tree: ast.AST
    lines: List[str]

    @classmethod
    def parse(cls, path: str, root: str) -> "Source":
        with open(path, encoding="utf-8") as f:
            text = f.read()
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        return cls(path=path, rel=rel, text=text,
                   tree=ast.parse(text, filename=path),
                   lines=text.splitlines())


@dataclass
class Project:
    root: str                 # the directory findings are relative to
    sources: List[Source]
    tests_dir: Optional[str] = None

    def source(self, rel_suffix: str) -> Optional[Source]:
        for s in self.sources:
            if s.rel.endswith(rel_suffix):
                return s
        return None


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    # files that failed to parse: (rel_path, error) — reported, not fatal
    errors: List[tuple] = field(default_factory=list)
    n_files: int = 0


FileRule = Callable[[Source], Iterable[Finding]]
ProjectRule = Callable[[Project], Iterable[Finding]]


def default_rules() -> tuple:
    """(file_rules, project_rules) — imported lazily so `import
    repro_torch.analysis.engine` stays cheap for the sanitizer path."""
    from repro_torch.analysis.hazards import check_hazards
    from repro_torch.analysis.kernel_oracle import check_kernel_oracles
    from repro_torch.analysis.locks import check_lock_discipline
    return ([check_lock_discipline, check_hazards],
            [check_kernel_oracles])


def collect_files(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(os.path.abspath(p))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.abspath(os.path.join(dirpath, fn)))
    return out


def run_lint(paths: List[str], *, root: Optional[str] = None,
             tests_dir: Optional[str] = None,
             file_rules: Optional[List[FileRule]] = None,
             project_rules: Optional[List[ProjectRule]] = None
             ) -> LintResult:
    """Lint ``paths`` (files or directories).  ``root`` anchors the
    relative paths in findings (defaults to CWD).  ``tests_dir`` feeds
    the kernel-parity project rule (defaults to ``<root>/tests`` when
    it exists)."""
    root = os.path.abspath(root or os.getcwd())
    if tests_dir is None:
        cand = os.path.join(root, "tests")
        tests_dir = cand if os.path.isdir(cand) else None
    if file_rules is None or project_rules is None:
        frs, prs = default_rules()
        file_rules = frs if file_rules is None else file_rules
        project_rules = prs if project_rules is None else project_rules

    result = LintResult()
    sources: List[Source] = []
    for path in collect_files(paths):
        try:
            src = Source.parse(path, root)
        except SyntaxError as e:                 # pragma: no cover
            result.errors.append(
                (os.path.relpath(path, root).replace(os.sep, "/"),
                 str(e)))
            continue
        sources.append(src)
    result.n_files = len(sources)

    raw: List[Finding] = []
    for src in sources:
        for rule in file_rules:
            raw.extend(rule(src))
    project = Project(root=root, sources=sources, tests_dir=tests_dir)
    for prule in project_rules:
        raw.extend(prule(project))

    # apply inline suppressions per file; malformed ones are findings
    by_rel = {s.rel: s for s in sources}
    sup_cache = {}
    kept: List[Finding] = []
    for f in raw:
        src = by_rel.get(f.path)
        if src is None:                           # project-level finding
            kept.append(f)
            continue
        sup = sup_cache.get(f.path)
        if sup is None:
            sup = sup_cache[f.path] = Suppressions.scan(src.lines)
        if not sup.covers(f):
            kept.append(f)
    for rel, src in by_rel.items():
        sup = sup_cache.get(rel)
        if sup is None:
            sup = sup_cache[rel] = Suppressions.scan(src.lines)
        for line, msg in sup.malformed:
            kept.append(Finding(rule="bad-suppression", path=rel,
                                line=line, col=1, message=msg))

    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    result.findings = kept
    return result


def lint_source(text: str, *, rel: str = "snippet.py",
                file_rules: Optional[List[FileRule]] = None
                ) -> List[Finding]:
    """Lint one in-memory snippet (the rule fixtures' entry point)."""
    src = Source(path=rel, rel=rel, text=text, tree=ast.parse(text),
                 lines=text.splitlines())
    if file_rules is None:
        file_rules, _ = default_rules()
    out: List[Finding] = []
    for rule in file_rules:
        out.extend(rule(src))
    sup = Suppressions.scan(src.lines)
    kept = [f for f in out if not sup.covers(f)]
    kept.extend(Finding(rule="bad-suppression", path=rel, line=line,
                        col=1, message=msg)
                for line, msg in sup.malformed)
    kept.sort(key=lambda f: (f.line, f.col, f.rule))
    return kept
