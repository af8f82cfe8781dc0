"""Hazard rules of the eager PyTorch port (the counterpart of the JAX
package's ``analysis/jit_hazards.py``).

Which of the reference's four rules carry over:

* ``jit-host-sync`` carries over as ``torch-host-sync``.  The reference
  flags host reads inside a traced function; eager PyTorch traces
  nothing, but a host read in the serving path's dispatch modules
  (``repro_torch/kernels``) still stalls the host until the card has
  drained its queue, so every launch after it waits.  Flagged there:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``torch.cuda.synchronize()``
  and ``int()`` / ``float()`` / ``bool()`` of a tensor reduction
  (``x.sum()``, ``x.max()``, ...).  Deliberate reads -- an op's
  contract of handing host arrays back, the route step's one read of
  its escape count -- are suppressed inline with their reasons.
* ``jit-constant-rebuild`` carries over as ``torch-constant-rebuild``:
  ``torch.tensor(<literal>, device=...)`` in a hot-path function
  (``repro_torch/kernels``, ``repro_torch/models``) copies a fresh host
  array to the device on every call.  Without ``device=`` the tensor
  stays on the host (a launch's argument array) and is not flagged.
* ``jit-bucket-bypass`` carries over as ``torch-bucket-bypass``: a raw
  route-step or analyze-step program (``route_step_body``, ...) called
  outside ``repro_torch/kernels``.  Only the ops pad to the q/n shape
  buckets a captured CUDA graph per bucket will need.
* ``jit-traced-branch`` does not carry over: a Python branch on a
  tensor is a host read (the rule above) in eager mode, not a retrace.
  It means something again once CUDA graphs capture the path.

The port's own two rules:

* ``port-imports-reference``: ``import jax`` or an import of the JAX
  package (``repro``) in a linted file -- the port and ``chip_smoke.py``
  keep their own copies of what they need;
* ``kernel-silent-fallback``: an ``except`` handler that calls a plain
  version (a ``*_plain`` function).  A wrapper given a CUDA tensor
  launches its kernel or raises; no ``try`` falls back.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.engine import Source
from repro_torch.analysis.findings import Finding

_SYNC_METHODS = {"item", "tolist", "cpu"}
_SYNC_CASTS = {"int", "float", "bool"}
_REDUCTIONS = {"sum", "max", "min", "amax", "amin", "any", "all", "mean",
               "prod", "norm", "count_nonzero"}
_LITERALS = (ast.List, ast.Tuple, ast.Constant, ast.ListComp, ast.Dict,
             ast.Set)
# the padded programs of the serving path: only kernels/ops pads their
# shapes to the q/n buckets
RAW_PROGRAMS = {"route_step_body", "route_step_ivf_body",
                "route_step_sharded_body", "analyze_step_body",
                "analyze_route_step_body"}
REFERENCE_PACKAGES = {"jax", "jaxlib", "repro"}


def _in(src: Source, part: str) -> bool:
    return f"/{part}/" in f"/{src.rel}"


def _functions(tree: ast.AST):
    """(qualname, node) of every def, with Class.method names."""
    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                yield qual, node
                yield from walk(node.body, f"{qual}.")
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, f"{prefix}{node.name}.")
    yield from walk(tree.body, "")               # type: ignore[attr-defined]


def _own(fn) -> Iterable[ast.AST]:
    """The nodes of ``fn``'s own body (a nested def is its own scope)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _finding(rule, src, node, qual, message) -> Finding:
    return Finding(rule=rule, path=src.rel, line=node.lineno,
                   col=node.col_offset + 1, symbol=qual, message=message)


def _host_sync(src: Source, qual: str, call: ast.Call) -> Optional[Finding]:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS:
        return _finding("torch-host-sync", src, call, qual,
                        f"`.{func.attr}()` reads a tensor on the host in a "
                        f"dispatch module (waits for the card's queue)")
    if isinstance(func, ast.Attribute) and func.attr == "synchronize" \
            and _name(func.value) == "cuda":
        return _finding("torch-host-sync", src, call, qual,
                        "`torch.cuda.synchronize()` in a dispatch module "
                        "waits for every queued launch")
    if isinstance(func, ast.Name) and func.id in _SYNC_CASTS and call.args:
        arg = call.args[0]
        if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
                and arg.func.attr in _REDUCTIONS:
            return _finding("torch-host-sync", src, call, qual,
                            f"`{func.id}()` of a tensor reduction "
                            f"`.{arg.func.attr}()` reads it on the host in "
                            f"a dispatch module")
    return None


def _constant_rebuild(src, qual, call) -> Optional[Finding]:
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == "tensor"
            and _name(func.value) == "torch"):
        return None
    if call.args and isinstance(call.args[0], _LITERALS) \
            and any(kw.arg == "device" for kw in call.keywords):
        return _finding("torch-constant-rebuild", src, call, qual,
                        "torch.tensor of a Python literal copies a fresh "
                        "host array to the device on every call -- hoist "
                        "it or keep it on the device")
    return None


def _bucket_bypass(src, qual, call) -> Optional[Finding]:
    name = _name(call.func)
    if name in RAW_PROGRAMS:
        return _finding("torch-bucket-bypass", src, call, qual,
                        f"`{name}` is a raw serving-path program -- call "
                        f"its op in kernels/ops (route_step, analyze_step, "
                        f"analyze_route_step) so shapes hit the "
                        f"q_bucket/n_bucket pads")
    return None


def _reference_imports(src: Source) -> Iterable[Finding]:
    for node in ast.walk(src.tree):
        mods: List[str] = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            mods = [node.module or ""]
        for mod in mods:
            if mod.split(".")[0] in REFERENCE_PACKAGES:
                yield Finding(
                    rule="port-imports-reference", path=src.rel,
                    line=node.lineno, col=node.col_offset + 1,
                    message=(f"imports `{mod}`: the port imports neither "
                             f"jax nor the JAX package -- keep a copy "
                             f"under repro_torch"))


def _silent_fallbacks(src: Source) -> Iterable[Finding]:
    for qual, fn in _functions(src.tree):
        for node in _own(fn):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                for sub in ast.walk(handler):
                    name = isinstance(sub, ast.Call) and _name(sub.func)
                    if name and name.endswith("_plain"):
                        yield _finding(
                            "kernel-silent-fallback", src, sub, qual,
                            f"`{name}` called from an `except` handler: a "
                            f"kernel that fails must raise, not fall back "
                            f"to its plain version")


def check_hazards(src: Source) -> Iterable[Finding]:
    findings: List[Finding] = []
    dispatch = _in(src, "kernels")
    hot = dispatch or _in(src, "models")
    for qual, fn in _functions(src.tree):
        for call in (n for n in _own(fn) if isinstance(n, ast.Call)):
            for rule, on in ((_host_sync, dispatch),
                             (_constant_rebuild, hot),
                             (_bucket_bypass, not dispatch)):
                f = rule(src, qual, call) if on else None
                if f is not None:
                    findings.append(f)
    findings.extend(_reference_imports(src))
    findings.extend(_silent_fallbacks(src))
    return findings
