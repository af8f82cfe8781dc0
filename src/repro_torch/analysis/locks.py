"""Lock-discipline rules (`lock-mixed-mutation`, `lock-unlocked-read`).

Port of the JAX package's ``analysis/locks.py``, unchanged in meaning:
the same findings, lines and messages on the same source.

For every class that creates a lock attribute in ``__init__`` (any
``self.<name> = threading.Lock()/RLock()/Condition()/make_lock(...)``),
the rule classifies each attribute access in each method as
locked/unlocked and read/mutation:

* an attribute is **guarded** if at least one mutation of it happens
  while the lock is held;
* ``lock-mixed-mutation`` — a guarded attribute is also mutated while
  the lock is NOT held (classic torn write / lost update);
* ``lock-unlocked-read`` — a *public* method reads two or more distinct
  guarded attributes without taking the lock (torn multi-field read;
  one guarded field read alone is an atomic-enough snapshot under the
  GIL, so the threshold is >= 2 distinct attributes).

Repo idioms the rule understands:

* methods whose name ends in ``_locked`` are called with the lock held
  (the codebase's documented convention) — their whole body counts as
  locked;
* ``__init__`` is pre-publication (no other thread can hold ``self``
  yet) and is excluded entirely;
* mutator *method calls* on guarded containers count as mutations
  (``self.queue.append(x)``, ``self._stats.setdefault(...)``, ...), as
  do item/attr stores (``self.d[k] = v``, ``del self.d[k]``).

A module-level variant applies the mixed-mutation rule to module
globals guarded by a module-level ``*_LOCK`` (the ``kernels/ops.py``
``_STATS`` pattern): any global mutated somewhere under ``with
<LOCK>:`` must not also be mutated outside it.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.engine import Source
from repro_torch.analysis.findings import Finding

# container methods that mutate their receiver in place
MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort", "reverse", "rotate",
}

_LOCK_FACTORY_NAMES = {"Lock", "RLock", "Condition", "make_lock"}


def _is_lock_ctor(value: ast.AST) -> bool:
    """True for `threading.Lock()`, `RLock()`, `make_lock("x")`, ..."""
    if not isinstance(value, ast.Call):
        return False
    func = value.func
    if isinstance(func, ast.Name):
        return func.id in _LOCK_FACTORY_NAMES
    if isinstance(func, ast.Attribute):
        return func.attr in _LOCK_FACTORY_NAMES
    return False


@dataclass
class _Event:
    attr: str
    line: int
    col: int
    locked: bool
    mutation: bool
    method: str


class _MethodScanner(ast.NodeVisitor):
    """Walks one method body, tracking whether the class lock is held.

    Nested defs/lambdas inherit the current lock state: a closure built
    under the lock but called later is rare enough that the cheap
    approximation wins.
    """

    def __init__(self, lock_attrs: Set[str], method: str,
                 start_locked: bool) -> None:
        self.lock_attrs = lock_attrs
        self.method = method
        self.locked = start_locked
        self.events: List[_Event] = []
        self._skip: Set[int] = set()   # id() of self-attr nodes already
        #                                counted as part of a mutation

    # -- helpers ------------------------------------------------------

    def _self_attr(self, node: ast.AST) -> Optional[ast.Attribute]:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node
        return None

    def _emit(self, node: ast.Attribute, mutation: bool) -> None:
        if node.attr in self.lock_attrs:
            return
        self.events.append(_Event(node.attr, node.lineno, node.col_offset + 1,
                                  self.locked, mutation, self.method))

    def _mutation_target(self, target: ast.AST) -> None:
        """Record mutations implied by an assignment/delete target."""
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._mutation_target(elt)
            return
        sa = self._self_attr(target)
        if sa is not None:                       # self.x = ...
            self._emit(sa, mutation=True)
            self._skip.add(id(sa))
            return
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            base = target.value                  # self.d[k] = / self.d.f =
            sa = self._self_attr(base)
            if sa is not None:
                self._emit(sa, mutation=True)
                self._skip.add(id(sa))

    # -- visitors -----------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    def _visit_with(self, node) -> None:
        acquires = False
        for item in node.items:
            sa = self._self_attr(item.context_expr)
            if sa is not None and sa.attr in self.lock_attrs:
                acquires = True
            else:
                self.visit(item.context_expr)
        if acquires and not self.locked:
            self.locked = True
            for st in node.body:
                self.visit(st)
            self.locked = False
        else:
            for st in node.body:
                self.visit(st)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._mutation_target(t)
        self.visit(node.value)
        for t in node.targets:
            self.generic_visit(t)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._mutation_target(node.target)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._mutation_target(node.target)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._mutation_target(t)
            self.generic_visit(t)

    def visit_Call(self, node: ast.Call) -> None:
        # self.<attr>.<mutator>(...) is a mutation of <attr>
        if isinstance(node.func, ast.Attribute) and node.func.attr in MUTATORS:
            sa = self._self_attr(node.func.value)
            if sa is not None:
                self._emit(sa, mutation=True)
                self._skip.add(id(sa))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        sa = self._self_attr(node)
        if (sa is not None and isinstance(node.ctx, ast.Load)
                and id(node) not in self._skip):
            self._emit(sa, mutation=False)
        self.generic_visit(node)


def _method_names(node) -> Tuple[str, bool]:
    """(name, starts_locked) for a method definition."""
    return node.name, node.name.endswith("_locked")


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _scan_class(cls: ast.ClassDef, src: Source) -> Iterable[Finding]:
    # 1) find lock attributes created anywhere in the class body
    lock_attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    lock_attrs.add(t.attr)
    if not lock_attrs:
        return []

    # 2) per-method event streams
    methods: List[Tuple[str, List[_Event], object]] = []
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        name, starts_locked = _method_names(item)
        if name == "__init__":
            continue                 # pre-publication, single-threaded
        scan = _MethodScanner(lock_attrs, name, starts_locked)
        for st in item.body:
            scan.visit(st)
        methods.append((name, scan.events, item))

    # 3) guarded attributes: mutated under the lock at least once
    guarded: Set[str] = set()
    for _, events, _node in methods:
        for ev in events:
            if ev.mutation and ev.locked:
                guarded.add(ev.attr)

    findings: List[Finding] = []

    # 4) mixed mutation: guarded attr mutated while unlocked
    mixed_by_method: Dict[str, Set[str]] = {}
    for name, events, _node in methods:
        seen: Set[str] = set()
        for ev in events:
            if ev.mutation and not ev.locked and ev.attr in guarded \
                    and ev.attr not in seen:
                seen.add(ev.attr)
                findings.append(Finding(
                    rule="lock-mixed-mutation", path=src.rel,
                    line=ev.line, col=ev.col,
                    symbol=f"{cls.name}.{name}",
                    message=(f"self.{ev.attr} is mutated here without the "
                             f"lock but is lock-guarded elsewhere in "
                             f"{cls.name}")))
        mixed_by_method[name] = seen

    # 5) torn reads: public method reads >= 2 distinct guarded attrs
    #    while unlocked (attrs already flagged as mixed mutations in the
    #    same method are not double-reported)
    for name, events, node in methods:
        if not _is_public(name):
            continue
        read_attrs: Dict[str, _Event] = {}
        for ev in events:
            if (not ev.mutation and not ev.locked and ev.attr in guarded
                    and ev.attr not in mixed_by_method.get(name, ())):
                read_attrs.setdefault(ev.attr, ev)
        if len(read_attrs) >= 2:
            attrs = ", ".join(sorted(read_attrs))
            first = min(read_attrs.values(), key=lambda e: (e.line, e.col))
            findings.append(Finding(
                rule="lock-unlocked-read", path=src.rel,
                line=first.line, col=first.col,
                symbol=f"{cls.name}.{name}",
                message=(f"reads lock-guarded attributes ({attrs}) without "
                         f"holding the lock — multi-field state may be "
                         f"observed torn")))
    return findings


# --------------------------------------------------------------------
# module-level variant (the ops.py `_STATS` / `_STATS_LOCK` pattern)
# --------------------------------------------------------------------

class _ModuleFnScanner(ast.NodeVisitor):
    def __init__(self, lock_names: Set[str], global_names: Set[str],
                 fn_name: str) -> None:
        self.lock_names = lock_names
        self.global_names = global_names
        self.fn = fn_name
        self.locked = False
        # (name, line, col, locked) — mutations only
        self.mutations: List[Tuple[str, int, int, bool]] = []
        self._declared_global: Set[str] = set()

    def _name_of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name) and node.id in self.global_names:
            return node.id
        return None

    def visit_Global(self, node: ast.Global) -> None:
        self._declared_global.update(node.names)

    def visit_With(self, node: ast.With) -> None:
        acquires = any(isinstance(i.context_expr, ast.Name)
                       and i.context_expr.id in self.lock_names
                       for i in node.items)
        if acquires and not self.locked:
            self.locked = True
            for st in node.body:
                self.visit(st)
            self.locked = False
        else:
            self.generic_visit(node)

    def _mut(self, name: str, node: ast.AST) -> None:
        self.mutations.append(
            (name, node.lineno, node.col_offset + 1, self.locked))

    def _mutation_target(self, target: ast.AST) -> None:
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            name = self._name_of(target.value)
            if name:
                self._mut(name, target)
        elif isinstance(target, ast.Name):
            # rebinding a module global from inside a function requires
            # a `global` declaration; only then is it a shared mutation
            if target.id in self._declared_global \
                    and target.id in self.global_names:
                self._mut(target.id, target)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._mutation_target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._mutation_target(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._mutation_target(t)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and node.func.attr in MUTATORS:
            name = self._name_of(node.func.value)
            if name:
                self._mut(name, node.func)
        self.generic_visit(node)


def _scan_module_globals(src: Source) -> Iterable[Finding]:
    tree = src.tree
    lock_names: Set[str] = set()
    global_names: Set[str] = set()
    for node in tree.body:                       # type: ignore[attr-defined]
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if _is_lock_ctor(node.value):
                        lock_names.add(t.id)
                    else:
                        global_names.add(t.id)
    if not lock_names:
        return []

    scans: List[_ModuleFnScanner] = []
    for node in tree.body:                       # type: ignore[attr-defined]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sc = _ModuleFnScanner(lock_names, global_names, node.name)
            for st in node.body:
                sc.visit(st)
            scans.append(sc)

    guarded = {name for sc in scans
               for (name, _l, _c, locked) in sc.mutations if locked}
    findings: List[Finding] = []
    for sc in scans:
        seen: Set[str] = set()
        for name, line, col, locked in sc.mutations:
            if not locked and name in guarded and name not in seen:
                seen.add(name)
                findings.append(Finding(
                    rule="lock-mixed-mutation", path=src.rel,
                    line=line, col=col, symbol=sc.fn,
                    message=(f"module global {name} is mutated here without "
                             f"its lock but is lock-guarded elsewhere")))
    return findings


def check_lock_discipline(src: Source) -> Iterable[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_scan_class(node, src))
    findings.extend(_scan_module_globals(src))
    return findings
