"""Prometheus-style text exposition for the telemetry ledger.

``prometheus_text(telemetry, ...)`` renders the full metric set with
stable names (dashboards and the SLO gate key on these):

    repro_requests_total{model="..."}           counter
    repro_fallback_total{stage="..."}           counter
    repro_admission_total{kind="..."}           counter
    repro_tenant_admission_total{kind=,tenant=} counter
    repro_cache_total{kind="..."}               counter
    repro_counter_total{name="..."}             counter (Telemetry.inc)
    repro_gauge{name="..."}                     gauge (set_gauge)
    repro_route_step_dispatches_total           counter
    repro_route_step_compiles_total             counter
    repro_sharding_silent_replications_total    counter
    repro_events_total                          counter
    repro_qps                                   gauge
    repro_route_latency_seconds{quantile=...}   summary (+ _sum/_count)
    repro_model_latency_seconds{model=,quantile=} summary
    repro_model_cost_total{model="..."}         counter
    repro_load_queue_depth{model=} / repro_load_inflight{model=} gauges
    repro_trace_spans_total                     counter (when tracer given)

``write_prom`` dumps the text to a file; ``serve_metrics``
exposes ``GET /metrics`` on a background stdlib HTTP server (no new
dependencies); ``parse_prom_text``/``metrics_from_prom`` read the text
back into a flat dict — that is how the CLI SLO gate consumes a dump
from a previous process.
"""
from __future__ import annotations

import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

_QUANTILES = (0.5, 0.9, 0.99)


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value: float) -> str:
    f = float(value)
    return str(int(f)) if f == int(f) else repr(f)


class _Writer:
    def __init__(self):
        self.lines = []

    def header(self, name: str, mtype: str, help_: str) -> None:
        self.lines.append(f"# HELP {name} {help_}")
        self.lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, value: float,
               labels: Optional[Dict[str, str]] = None) -> None:
        if labels:
            lab = ",".join(f'{k}="{_esc(str(v))}"'
                           for k, v in sorted(labels.items()))
            self.lines.append(f"{name}{{{lab}}} {_fmt(value)}")
        else:
            self.lines.append(f"{name} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def prometheus_text(telemetry, *, load=None, tracer=None,
                    cost_profile=None) -> str:
    """Render telemetry (and optional load/tracer/profiler state) in
    Prometheus text exposition format.  ``cost_profile`` is
    ``obs.profile.DeviceCostProfiler.profile()``: per bucket the FLOPs
    and bytes its padded shapes need (``repro_route_step_flops`` /
    ``repro_route_step_bytes``)."""
    s = telemetry.summary()
    w = _Writer()

    w.header("repro_events_total", "counter", "Route events recorded")
    w.sample("repro_events_total", s["events"])

    w.header("repro_requests_total", "counter", "Requests per model")
    for model, agg in sorted(s["per_model"].items()):
        w.sample("repro_requests_total", agg["requests"],
                 {"model": model})

    w.header("repro_fallback_total", "counter",
             "Routing fallback ladder stage counts")
    for stage, n in sorted(s["fallback_funnel"].items()):
        w.sample("repro_fallback_total", n,
                 {"stage": stage or "none"})

    w.header("repro_admission_total", "counter",
             "Admission verdicts (admitted/rerouted/shed)")
    for kind, n in sorted(s["admission_funnel"].items()):
        w.sample("repro_admission_total", n, {"kind": kind})

    tenants = s.get("admission_by_tenant", {})
    if tenants:
        w.header("repro_tenant_admission_total", "counter",
                 "Admission verdicts per tenant")
        for tenant, kinds in sorted(tenants.items()):
            for kind, n in sorted(kinds.items()):
                w.sample("repro_tenant_admission_total", n,
                         {"kind": kind, "tenant": tenant})

    w.header("repro_cache_total", "counter", "Semantic cache outcomes")
    for kind, n in sorted(s["cache_funnel"].items()):
        w.sample("repro_cache_total", n, {"kind": kind})

    rs = s["route_step"]
    w.header("repro_route_step_dispatches_total", "counter",
             "Fused route-step device dispatches")
    w.sample("repro_route_step_dispatches_total", rs["dispatches"])
    w.header("repro_route_step_compiles_total", "counter",
             "Fused route-step recompiles (0 after warmup)")
    w.sample("repro_route_step_compiles_total", rs["compiles"])

    an = s.get("analyze_step")
    if an is not None:
        w.header("repro_analyze_step_dispatches_total", "counter",
                 "Analyzer-stage device dispatches (solo or fused)")
        w.sample("repro_analyze_step_dispatches_total",
                 an["dispatches"])
        w.header("repro_analyze_step_compiles_total", "counter",
                 "Analyzer-stage recompiles (0 after warmup)")
        w.sample("repro_analyze_step_compiles_total", an["compiles"])

    w.header("repro_sharding_silent_replications_total", "counter",
             "Catalog shards silently replicated instead of split")
    w.sample("repro_sharding_silent_replications_total",
             s["sharding"]["silent_replications"])

    w.header("repro_qps", "gauge", "Requests/s over the rolling window")
    w.sample("repro_qps", s["qps"])

    w.header("repro_route_latency_seconds", "summary",
             "End-to-end route latency (analyzer + route)")
    lp = s["latency_percentiles"]
    for q in _QUANTILES:
        key = f"p{int(q * 100)}"
        w.sample("repro_route_latency_seconds", lp[key],
                 {"quantile": str(q)})
    lt = s["latency_totals"]
    w.sample("repro_route_latency_seconds_sum", lt["sum"])
    w.sample("repro_route_latency_seconds_count", lt["count"])

    w.header("repro_model_latency_seconds", "summary",
             "Per-model route latency")
    for model, agg in sorted(s["per_model"].items()):
        for q, key in ((0.5, "latency_p50_s"), (0.99, "latency_p99_s")):
            w.sample("repro_model_latency_seconds", agg[key],
                     {"model": model, "quantile": str(q)})

    w.header("repro_model_cost_total", "counter",
             "Simulated serving cost per model")
    for model, agg in sorted(s["per_model"].items()):
        w.sample("repro_model_cost_total", agg["cost"], {"model": model})

    counters = s.get("counters", {})
    if counters:
        w.header("repro_counter_total", "counter",
                 "Generic monotonic counters (Telemetry.inc)")
        for name, v in sorted(counters.items()):
            w.sample("repro_counter_total", v, {"name": name})
    gauges = s.get("gauges", {})
    if gauges:
        w.header("repro_gauge", "gauge",
                 "Generic point-in-time gauges (Telemetry.set_gauge)")
        for name, v in sorted(gauges.items()):
            w.sample("repro_gauge", v, {"name": name})

    if load is not None:
        lm = load.metrics()
        w.header("repro_load_queue_depth", "gauge",
                 "Queued requests per model")
        for model, v in sorted(lm["queue_depth"].items()):
            w.sample("repro_load_queue_depth", v, {"model": model})
        w.header("repro_load_inflight", "gauge",
                 "In-flight requests per model")
        for model, v in sorted(lm["inflight"].items()):
            w.sample("repro_load_inflight", v, {"model": model})

    if tracer is not None:
        ts = tracer.stats()
        w.header("repro_trace_spans_total", "counter",
                 "Trace spans recorded")
        w.sample("repro_trace_spans_total", ts["spans_total"])
        w.header("repro_trace_spans_retained", "gauge",
                 "Trace spans currently in the ring")
        w.sample("repro_trace_spans_retained", ts["spans_retained"])

    if cost_profile:
        w.header("repro_route_step_flops", "gauge",
                 "FLOPs per route-step bucket (counted from its shapes)")
        w.header("repro_route_step_bytes", "gauge",
                 "Bytes accessed per bucket (counted from its shapes)")
        for bucket, prof in sorted(cost_profile.items()):
            lab = {"bucket": str(bucket)}
            if prof.get("flops") is not None:
                w.sample("repro_route_step_flops", prof["flops"], lab)
            if prof.get("bytes_accessed") is not None:
                w.sample("repro_route_step_bytes",
                         prof["bytes_accessed"], lab)

    return w.text()


def write_prom(path, telemetry, **kw) -> str:
    """Render and write ``path``; returns the rendered text."""
    text = prometheus_text(telemetry, **kw)
    with open(path, "w") as f:
        f.write(text)
    return text


# ----------------------------------------------------------------------
# reading the text format back (the SLO gate on a dumped .prom file)
# ----------------------------------------------------------------------
def parse_prom_text(text: str) -> Dict[str, float]:
    """Parse exposition text into ``{name{label="v"}: value}`` flat keys
    (label-free samples key on the bare name)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # value is the last whitespace-separated token; the metric key
        # (which may contain spaces inside label values) is the rest
        key, _, val = line.rpartition(" ")
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


def metrics_from_prom(text: str) -> Dict[str, float]:
    """Flat metrics plus the derived ratios the SLO rules target
    (shed_rate, cache_hit_rate, ...)."""
    raw = parse_prom_text(text)
    m = dict(raw)

    def lab(name: str, **labels) -> float:
        lab_s = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return raw.get(f"{name}{{{lab_s}}}", 0.0)

    admitted = lab("repro_admission_total", kind="admitted")
    rerouted = lab("repro_admission_total", kind="rerouted")
    shed = lab("repro_admission_total", kind="shed")
    failed = lab("repro_admission_total", kind="failed")
    planned = admitted + rerouted + shed + failed
    m["shed_rate"] = shed / planned if planned else 0.0
    m["failed_rate"] = failed / planned if planned else 0.0

    # per-tenant shed rates (SLO rules key on tenant_shed_rate_<name>
    # and the cross-tenant worst case tenant_shed_rate_max)
    per_tenant: Dict[str, Dict[str, float]] = {}
    pat = re.compile(r'^repro_tenant_admission_total\{kind="([^"]+)",'
                     r'tenant="([^"]+)"\}$')
    for key, v in raw.items():
        match = pat.match(key)
        if match:
            per_tenant.setdefault(match.group(2), {})[match.group(1)] = v
    rates = []
    for tenant, kinds in sorted(per_tenant.items()):
        total = sum(kinds.values())
        rate = kinds.get("shed", 0.0) / total if total else 0.0
        m[f"tenant_shed_rate_{tenant}"] = rate
        rates.append(rate)
    m["tenant_shed_rate_max"] = max(rates) if rates else 0.0

    # generic counters/gauges surface under their bare names so SLO
    # rules can target them directly (e.g. the soak harness's
    # ``soak_p999_s`` / ``soak_post_warmup_compiles`` gauges); derived
    # keys above win any collision
    for pat2, kind in (
            (re.compile(r'^repro_gauge\{name="([^"]+)"\}$'), "gauge"),
            (re.compile(r'^repro_counter_total\{name="([^"]+)"\}$'),
             "counter")):
        for key, v in raw.items():
            match = pat2.match(key)
            if match and match.group(1) not in m:
                m[match.group(1)] = v

    hits = lab("repro_cache_total", kind="hit")
    misses = lab("repro_cache_total", kind="miss")
    looked = hits + misses
    m["cache_hit_rate"] = hits / looked if looked else 0.0

    m["route_step_compiles"] = raw.get(
        "repro_route_step_compiles_total", 0.0)
    m["route_step_dispatches"] = raw.get(
        "repro_route_step_dispatches_total", 0.0)
    m["analyze_step_compiles"] = raw.get(
        "repro_analyze_step_compiles_total", 0.0)
    m["analyze_step_dispatches"] = raw.get(
        "repro_analyze_step_dispatches_total", 0.0)
    m["silent_replications"] = raw.get(
        "repro_sharding_silent_replications_total", 0.0)
    m["route_latency_p99"] = lab("repro_route_latency_seconds",
                                 quantile="0.99")
    m["route_latency_p50"] = lab("repro_route_latency_seconds",
                                 quantile="0.5")
    m["qps"] = raw.get("repro_qps", 0.0)
    m["events"] = raw.get("repro_events_total", 0.0)
    return m


# ----------------------------------------------------------------------
# /metrics endpoint (stdlib only)
# ----------------------------------------------------------------------
class MetricsServer:
    """Background HTTP server exposing ``GET /metrics``.

    Renders fresh exposition text per scrape from the live telemetry
    (plus optional load/tracer).  ``close()`` shuts it down; also
    usable as a context manager.
    """

    def __init__(self, telemetry, *, load=None, tracer=None,
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                       # noqa: N802
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = prometheus_text(
                    outer.telemetry, load=outer.load,
                    tracer=outer.tracer).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):               # quiet
                pass

        self.telemetry = telemetry
        self.load = load
        self.tracer = tracer
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def serve_metrics(telemetry, *, load=None, tracer=None,
                  host: str = "127.0.0.1", port: int = 0) -> MetricsServer:
    return MetricsServer(telemetry, load=load, tracer=tracer,
                        host=host, port=port)
