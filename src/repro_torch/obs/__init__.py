"""Observability layer: tracing, bounded metrics, export, SLOs.

Port of the JAX package's ``obs`` (which imports nothing of JAX; the
port keeps its own copies, their locks from the port's
``analysis.sanitize.make_lock``):

* ``trace``   — nestable span tracer threaded through the serving path
* ``metrics`` — fixed-memory counters / gauges / log histograms
* ``export``  — Prometheus text exposition (+ /metrics endpoint)
* ``slo``     — declarative SLO rules with burn-rate breach detection
* ``profile`` — per-bucket FLOPs / bytes of the routing programs
  (counted from the padded shapes: eager PyTorch has no compiled
  program to read a cost analysis from), a ``torch.profiler``
  trace region, and the card's readings the tools share: a CUDA
  graph's device time a call (``graph_ms``) and the kernels a call
  launches (``kernel_trace``)
"""
from .export import (MetricsServer, metrics_from_prom, parse_prom_text,
                     prometheus_text, serve_metrics, write_prom)
from .metrics import Counter, Gauge, LogHistogram
from .profile import DeviceCostProfiler, trace_capture
from .slo import (SLOEvaluator, SLORule, Verdict, evaluate_rules,
                  parse_rule, parse_rules)
from .trace import NOOP_SPAN, Span, Tracer

__all__ = [
    "Counter", "DeviceCostProfiler", "Gauge", "LogHistogram",
    "MetricsServer", "NOOP_SPAN", "SLOEvaluator", "SLORule", "Span",
    "Tracer", "Verdict",
    "evaluate_rules", "metrics_from_prom", "parse_prom_text",
    "parse_rule", "parse_rules", "prometheus_text", "serve_metrics",
    "trace_capture", "write_prom",
]
