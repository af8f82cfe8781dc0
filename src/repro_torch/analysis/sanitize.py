"""Opt-in runtime sanitizers (``REPRO_SANITIZE=1``).

Port of the JAX package's ``analysis/sanitize.py``.

**Lock-order sanitizer.**  Every lock-bearing module of the port
creates its locks through :func:`make_lock`, under the reference's
names.  With sanitizing off (default) that returns a plain
``threading.Lock`` -- zero overhead, the env var is read once at lock
creation.  With ``REPRO_SANITIZE=1`` it returns an
:class:`OrderedLock` that maintains a per-thread stack of held locks and
a global *lock-order graph*: acquiring ``B`` while holding ``A`` records
the edge ``A -> B``.  The first acquisition that would close a cycle
(some thread previously took ``B`` before ``A``) raises
:class:`LockOrderError` at the acquire site -- the classic ABBA deadlock
caught deterministically, on the first inverted acquisition, without
needing the unlucky interleaving.

Edges are keyed by lock *name* (role), not instance, so the graph is
meaningful across engine instances; same-name self-edges (two
instances of the same component locked nested, e.g. two tenants'
micro-batchers) are skipped -- ordering within a role needs an
instance-level protocol the name graph can't see.

**Recompile sentinel.**  The port's ``kernels.ops`` reports every
route-step and analyze-step dispatch through
:func:`repro_torch.kernels.ops.set_recompile_hook` with its shape-bucket
signature ``(path, q_bucket, n_bucket, quant, shards)`` and its
compiles.  Eager PyTorch compiles nothing, so every dispatch reports 0
until a captured CUDA graph per bucket counts its captures there; a
compile for a signature the sentinel has *already seen* means the
zero-steady-state-recompile guarantee regressed.  The reference wires
one sentinel into every test run (``tests/conftest.py``); the port's
tests drive theirs from their own files.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
        "1", "true", "on", "yes")


class LockOrderError(RuntimeError):
    """Acquiring this lock would close a cycle in the lock-order graph
    (potential ABBA deadlock)."""


# ---- global lock-order graph ----------------------------------------

_GRAPH_MU = threading.Lock()            # guards _EDGES/_VIOLATIONS
_EDGES: Dict[str, Set[str]] = {}        # name -> names acquired after it
# (edge_src, edge_dst, cycle_path) for every refused acquisition
_VIOLATIONS: List[Tuple[str, str, Tuple[str, ...]]] = []
_HELD = threading.local()               # .stack: per-thread held names


def _held_stack() -> List[str]:
    st = getattr(_HELD, "stack", None)
    if st is None:
        st = _HELD.stack = []
    return st


def _find_path(src: str, dst: str) -> Optional[Tuple[str, ...]]:
    """DFS path src -> dst through _EDGES (caller holds _GRAPH_MU)."""
    stack = [(src, (src,))]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _EDGES.get(node, ()):
            if nxt == dst:
                return path + (dst,)
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def lock_order_graph() -> Dict[str, Set[str]]:
    with _GRAPH_MU:
        return {k: set(v) for k, v in _EDGES.items()}


def lock_order_violations() -> List[Tuple[str, str, Tuple[str, ...]]]:
    with _GRAPH_MU:
        return list(_VIOLATIONS)


def reset_lock_order() -> None:
    with _GRAPH_MU:
        _EDGES.clear()
        _VIOLATIONS.clear()


class OrderedLock:
    """A ``threading.Lock`` that checks the global lock-order graph on
    every acquisition.  API-compatible with the subset the stack uses:
    context manager, ``acquire``/``release``, ``locked``."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()

    def _check_order(self) -> None:
        held = _held_stack()
        if not held:
            return
        with _GRAPH_MU:
            for h in held:
                if h == self.name:       # same-role nesting: see module doc
                    continue
                dsts = _EDGES.setdefault(h, set())
                if self.name in dsts:
                    continue
                # adding h -> name; a path name ->* h means a cycle
                cycle = _find_path(self.name, h)
                if cycle is not None:
                    _VIOLATIONS.append((h, self.name, cycle))
                    raise LockOrderError(
                        f"lock-order inversion: acquiring '{self.name}' "
                        f"while holding '{h}', but the reverse order "
                        f"{' -> '.join(cycle)} was already established "
                        f"(potential ABBA deadlock)")
                dsts.add(self.name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        got = self._lock.acquire(blocking, timeout)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        st = _held_stack()
        # remove the most recent occurrence (handles out-of-order release)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self.name:
                del st[i]
                break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:          # pragma: no cover
        return f"OrderedLock({self.name!r})"


def make_lock(name: str):
    """The stack's lock factory: plain ``threading.Lock`` normally,
    order-checked :class:`OrderedLock` under ``REPRO_SANITIZE=1``."""
    if enabled():
        return OrderedLock(name)
    return threading.Lock()


# ---- recompile sentinel ---------------------------------------------

class RecompileSentinel:
    """Fails-fast detector for steady-state route-step recompiles.

    Installed via :func:`repro_torch.kernels.ops.set_recompile_hook`;
    each dispatch reports ``(signature, compiles)``.  A non-zero
    compile count for a signature that already compiled once is a
    violation (the padded-bucket cache regressed)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._seen: Set[tuple] = set()
        self._violations: List[str] = []

    # hook target -- called from the ops on every dispatch
    def __call__(self, event: dict) -> None:
        sig = (event.get("path"), event.get("q_bucket"),
               event.get("n_bucket"), event.get("quant"),
               event.get("shards"))
        compiles = int(event.get("compiles", 0) or 0)
        with self._mu:
            # any prior dispatch of this signature — compiled or served
            # from a warm cache — counts as warmup: compiling again for
            # a signature we have already seen dispatched is exactly
            # the steady-state recompile the bucket cache must prevent
            if compiles > 0 and sig in self._seen:
                self._violations.append(
                    f"route_step recompiled signature "
                    f"path={sig[0]} q_bucket={sig[1]} "
                    f"n_bucket={sig[2]} quant={sig[3]} "
                    f"shards={sig[4]} after warmup "
                    f"({compiles} compile(s))")
            self._seen.add(sig)

    def install(self) -> "RecompileSentinel":
        from repro_torch.kernels import ops
        ops.set_recompile_hook(self)
        return self

    def uninstall(self) -> None:
        from repro_torch.kernels import ops
        ops.set_recompile_hook(None)

    def drain(self) -> List[str]:
        with self._mu:
            out = self._violations
            self._violations = []
            return out

    def forget(self) -> None:
        """Reset warmup state (after a deliberate cache clear)."""
        with self._mu:
            self._seen.clear()
            self._violations.clear()
