"""The port's runtime sanitizers (``repro_torch.analysis.sanitize``),
mirroring the JAX package's ``tests/test_sanitize.py``: the lock-order
cycle detector fires on a seeded ABBA inversion, across threads and
through a transitive chain, stays silent on a consistent order and on
same-name nesting, and ``make_lock`` honours ``REPRO_SANITIZE`` -- in
the port's own lock-bearing classes too.  The recompile sentinel is
silent through warmup and steady state, fires on a compile for a
signature it has seen, and rides the port's real route step
(``device="cpu"``), which reports every dispatch with 0 compiles (eager
PyTorch compiles nothing; the seeded breakage is a reported compile).
The port's sanitizers are driven from this file: ``tests/conftest.py``
wires only the reference's into every test run."""
import threading

import numpy as np
import pytest

from repro_torch.analysis import sanitize
from repro_torch.analysis.sanitize import (LockOrderError, OrderedLock,
                                           RecompileSentinel, make_lock)
from repro_torch.core.preferences import DOMAINS, METRICS, TASK_TYPES
from repro_torch.kernels import ops


@pytest.fixture
def clean_lock_graph():
    sanitize.reset_lock_order()
    yield
    sanitize.reset_lock_order()


def test_abba_cycle_fires(clean_lock_graph):
    a, b = OrderedLock("t.A"), OrderedLock("t.B")
    with a:
        with b:
            pass
    with pytest.raises(LockOrderError, match="t.A"):
        with b:
            with a:
                pass
    assert sanitize.lock_order_violations()


def test_abba_cycle_fires_across_threads(clean_lock_graph):
    a, b = OrderedLock("x.A"), OrderedLock("x.B")
    errors = []

    def t1():
        with a:
            with b:
                pass

    def t2():
        try:
            with b:
                with a:
                    pass
        except LockOrderError as e:
            errors.append(e)

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join()
    assert len(errors) == 1
    assert sanitize.lock_order_violations()[-1][:2] == ("x.B", "x.A")


def test_consistent_order_is_silent(clean_lock_graph):
    a, b, c = (OrderedLock(n) for n in ("s.A", "s.B", "s.C"))
    for _ in range(3):
        with a:
            with b:
                with c:
                    pass
    with b:
        with c:
            pass
    assert sanitize.lock_order_violations() == []
    graph = sanitize.lock_order_graph()
    assert "s.B" in graph["s.A"] and "s.C" in graph["s.B"]


def test_transitive_cycle_detected(clean_lock_graph):
    a, b, c = (OrderedLock(n) for n in ("v.A", "v.B", "v.C"))
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(LockOrderError):
        with c:
            with a:
                pass


def test_same_name_nesting_skipped(clean_lock_graph):
    l1, l2 = OrderedLock("dup"), OrderedLock("dup")
    with l1:
        with l2:
            pass
    with l2:
        with l1:
            pass
    assert sanitize.lock_order_violations() == []


def test_make_lock_honors_env(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not isinstance(make_lock("m"), OrderedLock)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    lk = make_lock("m")
    assert isinstance(lk, OrderedLock)
    with lk:
        assert lk.locked()
    assert not lk.locked()


def test_port_components_take_ordered_locks_when_sanitizing(monkeypatch):
    """The port's lock sites build their locks through ``make_lock``,
    under the reference's role names."""
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.serving.load import LoadTracker
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    tel, lt = Telemetry(), LoadTracker(2)
    assert isinstance(tel._lock, OrderedLock)
    assert (tel._lock.name, lt._lock.name) == ("core.telemetry",
                                               "serving.load")
    monkeypatch.delenv("REPRO_SANITIZE")
    assert not isinstance(Telemetry()._lock, OrderedLock)


# ---------------------------------------------------------------------
# recompile sentinel
# ---------------------------------------------------------------------

def _event(compiles, path="dense", q=8, n=256):
    return {"path": path, "q_bucket": q, "n_bucket": n, "quant": "f32",
            "shards": 1, "compiles": compiles}


def test_sentinel_warmup_then_steady_state_silent():
    s = RecompileSentinel()
    s(_event(1))
    s(_event(0))
    s(_event(0))
    s(_event(1, n=512))
    assert s.drain() == []


def test_sentinel_fires_on_post_warmup_compile():
    s = RecompileSentinel()
    s(_event(1))
    s(_event(1))
    viols = s.drain()
    assert len(viols) == 1 and "n_bucket=256" in viols[0]
    assert s.drain() == []
    s.forget()
    s(_event(1))
    assert s.drain() == []


def _tiny_problem(seed=0):
    rng = np.random.default_rng(seed)
    B, N, M = 2, 8, len(METRICS)
    nt, nd = len(TASK_TYPES), len(DOMAINS)
    emb = rng.random((N, M)).astype(np.float32)
    tt = np.ones((nt + 1, N), bool)
    dm = np.ones((nd + 1, N), bool)
    gmask = np.zeros(N, bool)
    T = rng.random((B, M)).astype(np.float32)
    W = rng.random((B, M)).astype(np.float32)
    ti = np.zeros(B, np.int32)
    di = np.zeros(B, np.int32)
    return emb, tt, dm, gmask, T, W, ti, di


def test_sentinel_end_to_end_on_the_port_route_step():
    """Installed on the port's dispatcher: warm dispatches report 0
    compiles and stay silent; a compile reported for the signature the
    route step just used (a captured graph re-captured after warmup)
    trips it."""
    args = _tiny_problem()
    prev_hook = ops._RECOMPILE_HOOK
    events = []
    s = RecompileSentinel().install()
    try:
        assert ops._RECOMPILE_HOOK is s
        ops.set_recompile_hook(lambda ev: (events.append(ev), s(ev)))
        ops.route_step(*args, k=3, r=3, device="cpu")
        ops.route_step(*args, k=3, r=3, device="cpu")
        assert s.drain() == []
        assert [ev["compiles"] for ev in events] == [0, 0]
        assert events[0] == events[1] and events[0]["path"] == "dense"
        s(dict(events[0], compiles=1))
        viols = s.drain()
        assert viols and "after warmup" in viols[0]
        s.uninstall()
        assert ops._RECOMPILE_HOOK is None
    finally:
        ops.set_recompile_hook(prev_hook)


def test_set_recompile_hook_detach():
    events = []
    prev_hook = ops._RECOMPILE_HOOK
    ops.set_recompile_hook(events.append)
    try:
        ops.route_step(*_tiny_problem(1), k=2, r=2, device="cpu")
        assert len(events) == 1
        assert set(events[0]) == {"path", "q_bucket", "n_bucket", "quant",
                                  "shards", "compiles"}
        ops.set_recompile_hook(None)
        ops.route_step(*_tiny_problem(1), k=2, r=2, device="cpu")
        assert len(events) == 1
    finally:
        ops.set_recompile_hook(prev_hook)
