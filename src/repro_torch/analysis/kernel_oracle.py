"""Kernel conformance of the port (project rule).

The counterpart of the JAX package's ``analysis/kernel_oracle.py``.  A
kernel wrapper is a module-level function of ``repro_torch/kernels/
*.py`` that counts its launches (``<name>.launches += 1``, the count
every wrapper keeps where it launches its compiled kernel).  Each must
have:

* ``kernel-missing-plain`` -- its plain PyTorch version in the same
  module: ``<name>_plain``, or the name in ``PLAIN_ALIASES``;
* ``kernel-missing-oracle-test`` -- a CPU test under ``tests/`` (a
  ``test_*.py`` that is not a ``test_torch_cuda*`` file) that imports
  ``repro.kernels.ref`` and names the wrapper's oracle there -- the
  name with ``_bwd`` / ``_q8`` stripped, through ``ORACLE_ALIASES`` (a
  backward is held to ``jax.grad`` through its forward's oracle) --
  beside the plain version or the wrapper (on CPU tensors the wrapper
  runs its plain version);
* ``kernel-missing-card-check`` -- a card check that names both the
  wrapper and its plain version: a ``tests/test_torch_cuda*.py`` file or
  ``chip_smoke.py`` at the root.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.engine import Project, Source
from repro_torch.analysis.findings import Finding

PLAIN_ALIASES = {"flash_decode_q8": "decode_q8_plain"}
ORACLE_ALIASES = {"flash_attention": "mha_attention",
                  "flash_decode": "mha_attention",
                  "decode_merge": "mha_attention"}
_TAGS = re.compile(r"(_bwd|_q\d+)+$")


def plain_name(wrapper: str) -> str:
    return PLAIN_ALIASES.get(wrapper, f"{wrapper}_plain")


def oracle_name(wrapper: str) -> str:
    base = _TAGS.sub("", wrapper)
    return ORACLE_ALIASES.get(base, base)


def _counts_launches(fn) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Attribute) \
                and node.target.attr == "launches" \
                and isinstance(node.target.value, ast.Name) \
                and node.target.value.id == fn.name:
            return True
    return False


def kernel_wrappers(src: Source) -> List[Tuple[str, int, int]]:
    """(name, line, col) of the module's launch-counting wrappers."""
    return [(node.name, node.lineno, node.col_offset + 1)
            for node in src.tree.body            # type: ignore[attr-defined]
            if isinstance(node, ast.FunctionDef) and _counts_launches(node)]


def _defs(src: Source) -> Set[str]:
    return {node.name for node in src.tree.body  # type: ignore[attr-defined]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _imports_ref(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.startswith("repro.kernels.ref") for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.startswith("repro.kernels.ref"):
                return True
            if mod == "repro.kernels" and any(a.name == "ref"
                                              for a in node.names):
                return True
    return False


def _names(tree: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(a.name for a in node.names)
    return out


def _parse(path: str) -> Optional[ast.AST]:
    try:
        with open(path, encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def _test_files(tests_dir: str):
    """(cpu tests importing ref, card checks): name sets per file."""
    cpu, card = [], []
    for fn in sorted(os.listdir(tests_dir)):
        if not (fn.startswith("test_") and fn.endswith(".py")):
            continue
        tree = _parse(os.path.join(tests_dir, fn))
        if tree is None:
            continue
        if fn.startswith("test_torch_cuda"):
            card.append(_names(tree))
        elif _imports_ref(tree):
            cpu.append(_names(tree))
    return cpu, card


def check_kernel_oracles(project: Project) -> Iterable[Finding]:
    kernel_srcs = [s for s in project.sources if "/kernels/" in f"/{s.rel}"]
    if not kernel_srcs:
        return []
    cpu: List[Set[str]] = []
    card: List[Set[str]] = []
    if project.tests_dir and os.path.isdir(project.tests_dir):
        cpu, card = _test_files(project.tests_dir)
    smoke = project.source("chip_smoke.py")
    if smoke is None:
        tree = _parse(os.path.join(project.root, "chip_smoke.py"))
        if tree is not None:
            card.append(_names(tree))
    else:
        card.append(_names(smoke.tree))
    findings: List[Finding] = []
    for src in kernel_srcs:
        defs = _defs(src)
        for name, line, col in kernel_wrappers(src):
            plain, oracle = plain_name(name), oracle_name(name)

            def add(rule, message):
                findings.append(Finding(rule=rule, path=src.rel, line=line,
                                        col=col, symbol=name,
                                        message=message))
            if plain not in defs:
                add("kernel-missing-plain",
                    f"kernel wrapper `{name}` has no plain version "
                    f"`{plain}` in its module")
                continue
            if project.tests_dir and not any(
                    oracle in names and (plain in names or name in names)
                    for names in cpu):
                add("kernel-missing-oracle-test",
                    f"`{plain}` is never held against `ref.{oracle}` by a "
                    f"ref-importing CPU test under tests/")
            if not any(name in names and plain in names for names in card):
                add("kernel-missing-card-check",
                    f"`{name}` is never held against `{plain}` on the card "
                    f"(tests/test_torch_cuda*.py or chip_smoke.py)")
    return findings
