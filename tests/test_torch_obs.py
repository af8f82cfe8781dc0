"""The port's telemetry ledger and observability package
(``repro_torch.core.telemetry``, ``repro_torch.obs``): the reference's
cases run against the port's copies — funnels, percentiles, span
nesting, the JSONL round trip, Prometheus export and SLO rules — plus
the same recorded sequence through both packages giving the same
summary and the same Prometheus text."""
import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro_torch.cache.semantic import CACHE_KINDS
from repro_torch.core.routing import FALLBACK_LADDER
from repro_torch.core.telemetry import RouteEvent, Telemetry
from repro_torch.obs import (NOOP_SPAN, Counter, Gauge, LogHistogram,
                             SLOEvaluator, Tracer, evaluate_rules,
                             metrics_from_prom, parse_prom_text, parse_rule,
                             parse_rules, prometheus_text, serve_metrics)
from repro_torch.serving.load import ADMISSION_KINDS, LoadTracker


def _ev(ts=1.0, model="m0", fallback="", route_s=0.0, analyzer_s=0.0,
        cost=0.0):
    return RouteEvent(ts=ts, model=model, task_type="chat",
                      domain="general", complexity=0.5, fallback=fallback,
                      analyzer_s=analyzer_s, route_s=route_s, sim_cost=cost)


# ----------------------------------------------------------------------
# telemetry ledger
# ----------------------------------------------------------------------
@pytest.mark.parametrize("now,want", [(1010.0, 3.9), (1015.0, 1.9),
                                      (1100.0, 0.0)])
def test_qps_rolling_window(now, want):
    tel = Telemetry(window_s=10.0)
    for i in range(40):                  # 4 events/s for 10 s
        tel.record(_ev(1000.0 + i * 0.25))
    assert tel.qps(now=now) == pytest.approx(want)
    assert Telemetry().qps() == 0.0


def test_per_model_aggregates_and_thumbs():
    tel = Telemetry()
    for _ in range(3):
        tel.record(_ev(1.0, "a", route_s=0.01, cost=2.0))
    tel.record(_ev(1.0, "b", fallback="generalist", route_s=0.02, cost=5.0))
    tel.attach_thumbs("a", True)
    tel.attach_thumbs("a", False)
    agg = tel.per_model()
    assert agg["a"]["requests"] == 3
    assert agg["a"]["cost"] == pytest.approx(6.0)
    assert agg["a"]["route_s"] == pytest.approx(0.03)
    assert agg["a"]["thumbs_up"] == 1 and agg["a"]["thumbs_down"] == 1
    assert agg["a"]["satisfaction"] == pytest.approx(0.5)
    assert agg["b"]["fallback_rate"] == 1.0
    assert agg["b"]["satisfaction"] is None
    tel.record(_ev(2.0, "a"))
    tel.attach_thumbs("a", False)        # the latest unrated event
    with tel._lock:
        assert tel._events[-1].thumbs is False
        assert tel._events[0].thumbs is None
    tel.attach_thumbs("missing-model", True)      # no pending: no-op


def test_fallback_funnel_counts_ladder_stages():
    tel = Telemetry()
    mix = {"": 5, "widened-knn": 2, "generalist": 3, "any": 1}
    for kind, n in mix.items():
        assert kind in FALLBACK_LADDER
        for _ in range(n):
            tel.record(_ev(1.0, fallback=kind))
    assert tel.fallback_funnel() == mix
    assert tel.fallback_rate() == pytest.approx(6 / 11)
    assert tel.summary()["fallback_funnel"] == mix


def test_latency_percentiles_and_edges():
    tel = Telemetry()
    assert tel.per_model() == {}
    assert tel.latency_percentiles() == {"p50": 0.0, "p90": 0.0, "p99": 0.0}
    for i in range(200):
        tel.record(_ev(1.0, "a", route_s=(i + 1) / 1000.0))
    tel.record(_ev(1.0, "b", route_s=0.07, analyzer_s=0.03))
    agg = tel.per_model()
    assert agg["a"]["latency_p50_s"] == pytest.approx(0.1005, rel=0.01)
    assert agg["a"]["latency_p99_s"] >= 0.19
    assert agg["b"]["latency_p50_s"] == agg["b"]["latency_p99_s"] == \
        pytest.approx(0.1)
    p = tel.latency_percentiles()
    assert p["p99"] > p["p90"] > p["p50"]


def test_admission_and_cache_funnels_have_stable_keys():
    tel = Telemetry()
    assert tel.admission_funnel() == {}
    assert list(tel.cache_funnel()) == list(CACHE_KINDS)
    assert list(tel.summary()["cache_funnel"]) == list(CACHE_KINDS)
    tel.record_admission("admitted", count=5)
    tel.record_admission("rerouted")
    tel.record_admission("shed", count=2, tenant="t1")
    tel.record_cache("hit", count=3)
    assert tel.admission_funnel() == {"admitted": 5, "rerouted": 1,
                                      "shed": 2}
    assert set(tel.admission_funnel()) <= set(ADMISSION_KINDS)
    assert tel.admission_by_tenant() == {"t1": {"shed": 2}}
    funnel = tel.cache_funnel()
    assert list(funnel) == list(CACHE_KINDS)
    assert funnel["hit"] == 3 and funnel["miss"] == 0


@pytest.mark.parametrize("kind", ["route_step", "analyze_step", "sharding"])
def test_dispatch_and_sharding_counters(kind):
    tel = Telemetry()
    if kind == "sharding":
        tel.record_sharding(silent_replications=3)
        tel.record_sharding(silent_replications=1)
        assert tel.sharding_stats() == {"silent_replications": 4}
        assert tel.summary()["sharding"]["silent_replications"] == 4
        return
    rec = getattr(tel, f"record_{kind}")
    rec(dispatches=2)
    rec(dispatches=1, compiles=1)
    assert getattr(tel, f"{kind}_stats")() == {"dispatches": 3,
                                               "compiles": 1}
    assert tel.summary()[kind] == {"dispatches": 3, "compiles": 1}


def test_concurrent_records_and_consistent_summary():
    tel = Telemetry()
    errs, stop = [], threading.Event()

    def writer(k):
        try:
            for j in range(300):
                tel.record(_ev(float(j), f"m{k % 3}",
                               fallback="any" if j % 7 == 0 else "",
                               route_s=0.002, cost=1.0))
        except Exception as e:                 # noqa: BLE001
            errs.append(e)

    def reader():
        try:
            while not stop.is_set():
                s = tel.summary()
                n = s["events"]
                assert sum(s["fallback_funnel"].values()) == n
                assert sum(a["requests"]
                           for a in s["per_model"].values()) == n
                assert s["latency_totals"]["count"] == n
        except Exception as e:                 # noqa: BLE001
            errs.append(e)

    writers = [threading.Thread(target=writer, args=(k,)) for k in range(6)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in writers + readers:
        t.start()
    for t in writers:
        t.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in writers + readers)
    assert not errs, errs
    assert tel.summary()["events"] == 1800


def test_memory_stays_bounded():
    tel = Telemetry(max_events=256)
    n = 20_000
    for i in range(n):
        tel.record(_ev(float(i) / 100.0, f"m{i % 4}",
                       fallback="any" if i % 10 == 0 else "",
                       route_s=0.001 * (i % 50 + 1), cost=0.5))
    assert len(tel._events) <= 256
    assert len(tel._qps_ts) <= tel._qps_ts.maxlen
    s = tel.summary()
    assert s["events"] == n
    assert s["fallback_funnel"]["any"] == n // 10
    assert s["cost_totals"]["sum"] == pytest.approx(0.5 * n)
    p = s["latency_percentiles"]
    assert 0.001 <= p["p50"] <= p["p99"] <= 0.051


# ----------------------------------------------------------------------
# tracer
# ----------------------------------------------------------------------
def test_span_nesting_via_contextvar():
    tr = Tracer()

    def inner_layer():                 # no span threaded through args
        with tr.span("route_step", batch=4):
            pass

    with tr.start_trace("submit", mode="interactive") as root:
        with tr.span("analyze") as mid:
            inner_layer()
    spans = tr.spans(root.trace_id)
    assert [s.name for s in spans] == ["route_step", "analyze", "submit"]
    by_name = {s.name: s for s in spans}
    assert by_name["analyze"].parent_id == root.span_id
    assert by_name["route_step"].parent_id == mid.span_id
    tree = tr.summary_tree(root.trace_id)
    assert tree["children"][0]["children"][0]["name"] == "route_step"
    with tr.start_trace("outer"):
        with tr.start_trace("fresh") as f:
            assert f.parent_id == ""


def test_span_nesting_is_per_thread():
    """Each thread's ambient span is its own (a contextvar): spans
    opened in two threads at once never adopt each other's parents."""
    tr = Tracer()
    barrier = threading.Barrier(2, timeout=30)
    roots = {}

    def work(k):
        with tr.start_trace(f"root{k}") as root:
            roots[k] = root
            barrier.wait()
            with tr.span(f"child{k}"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for k in range(2):
        (child,) = [s for s in tr.spans() if s.name == f"child{k}"]
        assert child.parent_id == roots[k].span_id


def test_span_attrs_fanout_and_current():
    tr = Tracer()
    assert tr.current() is None
    with tr.span("route_step", path="dense") as sp:
        assert tr.current() is sp
        sp.set(compiles=0)
    assert tr.current() is None
    assert sp.attrs == {"path": "dense", "compiles": 0}
    root = tr.record_span("request", request_id=7, duration_s=0.25)
    child = tr.record_span("generate", parent=root, duration_s=0.2)
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    tree = tr.summary_tree(root.trace_id)
    assert tree["duration_s"] == pytest.approx(0.25)
    assert [c["name"] for c in tree["children"]] == ["generate"]


def test_disabled_tracer_and_bounded_ring(tmp_path):
    off = Tracer(enabled=False)
    with off.start_trace("submit") as root:
        with off.span("analyze") as sp:
            sp.set(batch=3)
    assert root is NOOP_SPAN and sp is NOOP_SPAN
    assert off.record_span("request") is NOOP_SPAN
    assert off.export_jsonl(tmp_path / "t.jsonl") == 0
    tr = Tracer(max_spans=8)
    first = tr.record_span("request", i=0)
    for i in range(1, 100):
        tr.record_span("request", i=i)
    assert tr.stats() == {"spans_total": 100, "spans_retained": 8,
                          "max_spans": 8}
    assert tr.summary_tree(first.trace_id) is None


def test_export_jsonl_roundtrip(tmp_path):
    tr = Tracer()
    with tr.start_trace("submit", batch=2) as root:
        with tr.span("route_step", path="dense"):
            pass
    path = tmp_path / "trace.jsonl"
    assert tr.export_jsonl(path) == 2
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert {r["name"] for r in recs} == {"submit", "route_step"}
    for r in recs:
        assert set(r) == {"trace_id", "span_id", "parent_id", "name",
                          "ts", "duration_s", "attrs"}
        assert r["trace_id"] == root.trace_id
    assert tr.export_jsonl(path, trace_id="t_none") == 0


# ----------------------------------------------------------------------
# metric primitives, export, SLO
# ----------------------------------------------------------------------
def test_counter_gauge_labels():
    c = Counter("reqs", "requests")
    c.inc()
    c.inc(2.0, label="m1")
    assert c.items() == {"": 1.0, "m1": 2.0}
    with pytest.raises(AssertionError):
        c.inc(-1.0)
    g = Gauge("depth")
    g.set(3.0, label="m0")
    g.set(1.5, label="m0")
    assert g.value("m0") == 1.5 and g.value("missing") == 0.0


def test_log_histogram_quantiles_edges_merge():
    h = LogHistogram()
    vals = np.arange(1, 2001) / 1000.0
    for v in vals:
        h.record(float(v))
    for q in (0.1, 0.5, 0.9, 0.99):
        assert h.quantile(q) == pytest.approx(float(np.quantile(vals, q)),
                                              rel=0.02)
    one = LogHistogram()
    one.record(0.5)
    assert one.quantile(0.5) == one.quantile(0.99) == 0.5
    e = LogHistogram(lo=1e-3, hi=1e1)
    assert e.quantile(0.5) == 0.0
    e.record(0.0)
    e.record(-1.0)
    assert e.quantile(0.5) == 0.0
    e.record(1e9)
    assert e.quantile(1.0) == 1e9 and math.isclose(e.snapshot()["max"], 1e9)
    a, b, ref = LogHistogram(), LogHistogram(), LogHistogram()
    for v in (0.01, 0.02, 0.04):
        a.record(v)
        ref.record(v)
    for v in (0.08, 0.16):
        b.record(v)
        ref.record(v)
    a.merge(b)
    assert a.snapshot() == pytest.approx(ref.snapshot())
    with pytest.raises(AssertionError):
        a.merge(LogHistogram(lo=1e-2, hi=1e2))


def _filled_telemetry(tel_cls=Telemetry, ev_cls=RouteEvent):
    tel = tel_cls()
    for i in range(10):
        tel.record(ev_cls(ts=100.0 + i, model=f"m{i % 2}", task_type="chat",
                          domain="general", complexity=0.5,
                          fallback="any" if i == 9 else "",
                          route_s=0.01 * (i + 1), sim_cost=2.0))
    tel.attach_thumbs("m0", True)
    tel.record_admission("admitted", count=8)
    tel.record_admission("shed", count=2, tenant="t0")
    tel.record_cache("hit", count=3)
    tel.record_cache("miss", count=7)
    tel.record_route_step(dispatches=5, compiles=1)
    tel.record_analyze_step(dispatches=4)
    tel.record_sharding(silent_replications=1)
    tel.inc("soak_requests", 3.0)
    tel.set_gauge("soak_p999_s", 0.25)
    return tel


def test_prometheus_text_round_trip():
    tel = _filled_telemetry()
    tr = Tracer()
    tr.record_span("request")
    load = LoadTracker(3)
    load.admit(1, count=4)
    text = prometheus_text(tel, tracer=tr, load=load)
    raw = parse_prom_text(text)
    assert raw["repro_events_total"] == 10
    assert raw['repro_requests_total{model="m0"}'] == 5
    assert raw['repro_fallback_total{stage="none"}'] == 9
    assert raw['repro_admission_total{kind="shed"}'] == 2
    assert raw['repro_cache_total{kind="hit"}'] == 3
    assert raw["repro_route_step_dispatches_total"] == 5
    assert raw["repro_analyze_step_dispatches_total"] == 4
    assert raw["repro_trace_spans_total"] == 1
    assert raw['repro_load_queue_depth{model="1"}'] == 4
    m = metrics_from_prom(text)
    assert m["shed_rate"] == pytest.approx(0.2)
    assert m["cache_hit_rate"] == pytest.approx(0.3)
    assert m["tenant_shed_rate_t0"] == 1.0
    assert m["soak_p999_s"] == 0.25 and m["soak_requests"] == 3.0
    assert m["route_latency_p99"] >= m["route_latency_p50"] > 0


def test_metrics_server_scrape_on_loopback():
    tel = _filled_telemetry()
    with serve_metrics(tel) as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        body = urllib.request.urlopen(url, timeout=5).read().decode()
        assert parse_prom_text(body)["repro_events_total"] == 10
        tel.record(_ev())
        body2 = urllib.request.urlopen(url, timeout=5).read().decode()
        assert parse_prom_text(body2)["repro_events_total"] == 11
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/other",
                                   timeout=5)


def test_slo_rules_point_and_burn(tmp_path):
    r = parse_rule("shed: shed_rate <= 0.01 burn 60s/600s x2")
    assert r.name == "shed" and r.is_burn and r.burn_factor == 2.0
    for bad in ("nonsense", "x ~ 3", "a <= 0.1 burn 60s",
                "a <= 0.1 burn 600s/60s"):
        with pytest.raises(ValueError):
            parse_rule(bad)
    rules = parse_rules("# SLOs\n\nshed_rate <= 0.1  # inline\n"
                        "cache_hit_rate >= 0.5\nunknown == 0\n")
    v = evaluate_rules(rules, {"shed_rate": 0.2, "cache_hit_rate": 0.7})
    assert [x.ok for x in v] == [False, True, True]
    rule = parse_rule("shed: shed_rate <= 0.1 burn 60s/600s x2")
    ev = SLOEvaluator([rule])
    (v,) = ev.evaluate({"shed_rate": 0.05})
    assert v.ok and v.detail == "insufficient history"
    t, bad, total = 0.0, 0.0, 0.0
    while t < 600.0:                    # healthy: 1% bad
        bad, total = bad + 1.0, total + 100.0
        ev.observe(t, {}, {"shed_rate": (bad, total)})
        t += 30.0
    assert ev.evaluate({"shed_rate": 0.01}, now=t)[0].ok
    while t < 1800.0:                   # sustained: 90% bad
        bad, total = bad + 90.0, total + 100.0
        ev.observe(t, {}, {"shed_rate": (bad, total)})
        t += 30.0
    assert not ev.evaluate({"shed_rate": 0.9}, now=t)[0].ok


def test_slo_cli_gate(tmp_path):
    from repro_torch.obs import slo, write_prom
    prom = tmp_path / "metrics.prom"
    write_prom(prom, _filled_telemetry())
    assert slo.main(["--metrics", str(prom), "--rule",
                     "shed_rate <= 0.5"]) == 0
    assert slo.main(["--metrics", str(prom), "--rule",
                     "route_step_compiles == 0"]) == 1
    assert slo.main(["--metrics", str(prom)]) == 2


def test_summary_and_prometheus_text_equal_the_reference():
    """One recorded sequence through both packages' Telemetry: the same
    summary and the same Prometheus text, byte for byte."""
    from repro.core.telemetry import RouteEvent as JEvent
    from repro.core.telemetry import Telemetry as JTelemetry
    from repro.obs import Tracer as JTracer
    from repro.obs import prometheus_text as j_prometheus_text
    from repro.serving.load import LoadTracker as JLoad
    jt = _filled_telemetry(JTelemetry, JEvent)
    tt = _filled_telemetry()
    js, ts = jt.summary(), tt.summary()
    assert js == ts
    jtr, ttr = JTracer(), Tracer()
    for tr in (jtr, ttr):
        with tr.start_trace("submit"):
            tr.record_span("request")
    jl, tl = JLoad(3), LoadTracker(3)
    for lt in (jl, tl):
        lt.admit(2, count=5)
        lt.start(2)
    assert prometheus_text(tt, tracer=ttr, load=tl) == \
        j_prometheus_text(jt, tracer=jtr, load=jl)
