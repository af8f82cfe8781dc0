"""Request tracing for the serving hot path.

A ``Tracer`` hands out nestable ``Span``s — named, timed records
carrying free-form attributes (request/tenant/batch ids, fallback
kinds, cache outcomes, admission verdicts, bucket shapes, ...) and a
``trace_id``/``span_id``/``parent_id`` triple that links them into
per-request trees.  Nesting is automatic: entering a span (``with
tracer.span("route_step"): ...``) makes it the implicit parent of any
span opened inside it (contextvar-propagated, so it crosses layer
boundaries — ``ServingEngine.submit`` -> ``OptiRoute.route_all`` ->
``kernels.ops.route_step`` -> ``SemanticCache`` — without threading a
span argument through every call).

Batch work fans out: the serving engine runs analyze / route / admit
/ generate ONCE per batch under batch-level spans, then records one
retrospective child span per request (``record_span``) carrying that
request's amortized timings and per-request attributes, so every
``Response`` ends up with a trace id whose tree shows exactly the
stages that ran for it.

Finished spans land in a bounded ring (oldest evicted first) — the
tracer's memory is fixed no matter how long the serving process
lives.  ``export_jsonl`` writes one span per line (OTLP-style flat
records); ``summary_tree`` rebuilds the nested view for tests and
debugging.  A disabled tracer (``enabled=False``) returns a shared
no-op span from every call: the hot path pays one attribute check and
nothing else.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import time
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.analysis.sanitize import make_lock

# the implicit parent of the next span opened on this thread/context
_CURRENT: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("repro_torch_obs_current_span", default=None)


class Span:
    """One timed, attributed node of a trace tree.

    Context-manager entry makes it the implicit parent for nested
    spans; exit (or ``end()``) stamps the duration and records it into
    the tracer's ring.  ``set(**attrs)`` attaches attributes at any
    point before export.
    """
    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "attrs", "wall0", "t0", "duration_s", "_token", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.wall0 = time.time()
        self.t0 = time.perf_counter()
        self.duration_s = 0.0
        self._token = None
        self._done = False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self) -> "Span":
        if not self._done:
            self._done = True
            self.duration_s = time.perf_counter() - self.t0
            self.tracer._record(self)
        return self

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self.end()
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "ts": self.wall0, "duration_s": self.duration_s,
                "attrs": self.attrs}


class _NoopSpan:
    """Shared do-nothing span: what a disabled tracer hands out.

    Stateless (safe to re-enter concurrently); every method is a
    cheap no-op so instrumented code needs no ``if enabled`` guards.
    """
    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = ""
    name = ""
    duration_s = 0.0

    @property
    def attrs(self):
        return {}

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def end(self) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Factory + bounded store of spans.

    * ``span(name, **attrs)``       — live span, implicit parent from
      the ambient context (enter it with ``with``);
    * ``start_trace(name, **attrs)``— live ROOT span (new trace id)
      regardless of ambient context;
    * ``record_span(name, parent=, duration_s=, **attrs)`` — already-
      finished span (the batch->request fan-out path); ``parent=None``
      roots a new trace;
    * ``export_jsonl(path)``        — one span per line;
    * ``summary_tree(trace_id)``    — nested dict view for tests.
    """

    def __init__(self, max_spans: int = 16384, *, enabled: bool = True):
        assert max_spans > 0, max_spans
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self._spans: deque = deque(maxlen=self.max_spans)
        self._lock = make_lock("obs.tracer")
        self._ids = itertools.count(1)
        self.spans_total = 0            # monotonic; ring evicts, this doesn't

    # ------------------------------------------------------------------
    def _new_id(self) -> str:
        return f"{next(self._ids):012x}"      # count() is atomic in CPython

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self.spans_total += 1

    # ------------------------------------------------------------------
    def span(self, name: str, **attrs):
        """A live child span of the ambient current span (or a root
        when none is active).  Enter it with ``with`` to both time it
        and make it the parent of nested spans."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _CURRENT.get()
        sid = self._new_id()
        if parent is not None and parent.trace_id:
            return Span(self, name, parent.trace_id, sid,
                        parent.span_id, attrs)
        return Span(self, name, f"t{sid}", sid, "", attrs)

    def start_trace(self, name: str, **attrs):
        """A live ROOT span: always begins a fresh trace."""
        if not self.enabled:
            return NOOP_SPAN
        sid = self._new_id()
        return Span(self, name, f"t{sid}", sid, "", attrs)

    def record_span(self, name: str, *, parent=None,
                    duration_s: float = 0.0, **attrs):
        """Record an already-finished span (fan-out/retrospective).

        ``parent`` is a ``Span`` (or None to root a new trace); the
        span is stamped with ``duration_s`` and recorded immediately.
        """
        if not self.enabled:
            return NOOP_SPAN
        sid = self._new_id()
        if parent is not None and parent.trace_id:
            s = Span(self, name, parent.trace_id, sid, parent.span_id,
                     attrs)
        else:
            s = Span(self, name, f"t{sid}", sid, "", attrs)
        s.duration_s = float(duration_s)
        s._done = True
        self._record(s)
        return s

    def current(self):
        """The ambient span on this thread/context (or None)."""
        return _CURRENT.get()

    # ------------------------------------------------------------------
    # export & inspection
    # ------------------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        """Retained finished spans, oldest first (optionally one trace)."""
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def export_jsonl(self, path, trace_id: Optional[str] = None) -> int:
        """Write retained spans as JSON-lines; returns the line count."""
        spans = self.spans(trace_id)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict(), default=str) + "\n")
        return len(spans)

    def summary_tree(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Nested view of one trace: {name, attrs, duration_s,
        children: [...]} rooted at the trace's parentless span.
        Returns None when the trace has been evicted from the ring."""
        spans = self.spans(trace_id)
        if not spans:
            return None
        nodes = {s.span_id: {"name": s.name, "span_id": s.span_id,
                             "attrs": dict(s.attrs),
                             "duration_s": s.duration_s, "children": []}
                 for s in spans}
        root = None
        for s in spans:
            if s.parent_id and s.parent_id in nodes:
                nodes[s.parent_id]["children"].append(nodes[s.span_id])
            else:
                root = nodes[s.span_id]
        return root

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"spans_total": self.spans_total,
                    "spans_retained": len(self._spans),
                    "max_spans": self.max_spans}
