"""The port's fleet federation (flox_tpu_torch.fleet) against the reference's.

The reference's behaviours on the port: the histogram merge math, the
cost-row and program-card unions, federation over real HTTP (readiness,
unreachable replicas, merge errors, the rendered exposition text), the top
console and its JSON, the SLO and resident-state federation and the CLIs.
Parity: the same scraped texts federate to the same view and the same
rendered text in both packages, and a port replica and a reference replica
federate together. Replicas are canned HTTP endpoints or in-process metrics
servers on ports bound to 0; every HTTP call and subprocess has a timeout.
"""

from __future__ import annotations

import http.server
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import flox_tpu
import flox_tpu_torch
from flox_tpu import (cache as ref_cache, exposition as ref_exposition, fleet as ref_fleet,
                      telemetry as ref_telemetry)
from flox_tpu_torch import cache, exposition, fleet, telemetry
from flox_tpu_torch.telemetry import HIST_EDGES_MS, METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_plane():
    with flox_tpu_torch.set_options(telemetry=False, telemetry_export_path=None,
                                    flight_recorder_path=None, replica_id=None,
                                    serve_aot_dir=None):
        cache.clear_all()
        telemetry.reset()
        exposition.set_ready(False)
        yield
        cache.clear_all()
        telemetry.reset()
    exposition.stop_metrics_server()
    exposition.set_ready(False)


def _observe_registry(samples, name="serve.request_ms", exemplars=False):
    registry = telemetry.MetricsRegistry()
    for i, value in enumerate(samples):
        registry.observe(name, value, exemplar=f"req-{i}" if exemplars else None)
    return registry


def _parsed_hist(registry, name="serve.request_ms"):
    hist = registry.histograms()[name]
    return {"edges": list(HIST_EDGES_MS), "counts": list(hist["counts"]), "sum": hist["sum"],
            "count": hist["count"],
            "exemplars": {k: list(v) for k, v in hist["exemplars"].items()}}


class TestHistogramMergeMath:
    def test_merge_preserves_count_sum_and_p99_within_one_bucket(self):
        rng = np.random.default_rng(42)
        a = rng.lognormal(mean=0.0, sigma=1.5, size=400).tolist()
        b = rng.lognormal(mean=1.0, sigma=1.0, size=300).tolist()
        merged = fleet.merge_histograms(_parsed_hist(_observe_registry(a)),
                                        _parsed_hist(_observe_registry(b)))
        oracle = _observe_registry(a + b)
        assert merged["count"] == len(a) + len(b)
        assert merged["sum"] == pytest.approx(sum(a) + sum(b))
        assert merged["counts"] == list(oracle.histograms()["serve.request_ms"]["counts"])
        merged_p99 = fleet._hist_percentile(merged, 0.99)
        oracle_p99 = oracle.percentile("serve.request_ms", 0.99)
        bucket = next(i for i, e in enumerate(HIST_EDGES_MS) if merged_p99 <= e)
        lo = HIST_EDGES_MS[bucket - 1] if bucket else 0.0
        assert lo <= oracle_p99 <= HIST_EDGES_MS[bucket]
        ref = ref_fleet.merge_histograms(_parsed_hist(_observe_registry(a)),
                                         _parsed_hist(_observe_registry(b)))
        assert ref == merged
        assert ref_fleet._hist_percentile(ref, 0.99) == merged_p99

    def test_exemplars_max_merge_per_bucket(self):
        a = _parsed_hist(_observe_registry([0.5, 3.0], exemplars=True))
        b = _parsed_hist(_observe_registry([0.6, 2.5], exemplars=True))
        merged = fleet.merge_histograms(a, b)
        bucket = next(i for i, e in enumerate(HIST_EDGES_MS) if 0.6 <= e)
        assert merged["exemplars"][bucket][1] == 0.6
        bucket3 = next(i for i, e in enumerate(HIST_EDGES_MS) if 3.0 <= e)
        assert merged["exemplars"][bucket3][1] == 3.0

    def test_mismatched_edges_reject_loudly(self):
        a = _parsed_hist(_observe_registry([1.0]))
        b = _parsed_hist(_observe_registry([1.0]))
        b["edges"] = [e * 2 for e in b["edges"]]
        with pytest.raises(fleet.FleetMergeError, match="edges differ"):
            fleet.merge_histograms(a, b)
        b["edges"] = b["edges"][:-1]
        with pytest.raises(fleet.FleetMergeError):
            fleet.merge_histograms(a, b)

    def test_cost_rows_union(self):
        a = {"dispatches": 2, "device_ms": 10.0, "device_ms_max": 8.0, "bytes": 100,
             "compiles": 1, "compile_ms": 50.0, "hbm_peak": 1000.0, "last_slow_trace": "req-a"}
        b = {"dispatches": 3, "device_ms": 4.0, "device_ms_max": 3.0, "bytes": 50,
             "compiles": 0, "compile_ms": 0.0, "hbm_peak": 2000.0, "last_slow_trace": "req-b"}
        merged = fleet.merge_cost_rows(a, b)
        assert merged["dispatches"] == 5
        assert merged["device_ms"] == pytest.approx(14.0)
        assert merged["bytes"] == 150 and merged["hbm_peak"] == 2000.0
        assert merged["device_ms_max"] == 8.0 and merged["last_slow_trace"] == "req-a"
        assert merged == ref_fleet.merge_cost_rows(a, b)


class _FakeReplica:
    """A canned replica endpoint: /metrics, /debug/costs, /debug/programs,
    /readyz (and /slo when given)."""

    def __init__(self, metrics_text, costs=None, ready=True, reason="ready", programs=None,
                 slo=None):
        self.metrics_text, self.costs, self.ready = metrics_text, costs or {}, ready
        self.reason, self.programs, self.slo = reason, programs, slo
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/metrics":
                    body, status = outer.metrics_text.encode(), 200
                elif path == "/debug/costs":
                    body, status = json.dumps(outer.costs).encode(), 200
                elif path == "/debug/programs" and outer.programs is not None:
                    body, status = json.dumps({"programs": outer.programs}).encode(), 200
                elif path == "/slo" and outer.slo is not None:
                    body, status = json.dumps(outer.slo).encode(), 200
                elif path == "/readyz":
                    body = outer.reason.encode() + b"\n"
                    status = 200 if outer.ready else 503
                else:
                    body, status = b"not found\n", 404
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _replica_text(replica, requests, latency_ms):
    """One replica's /metrics text, rendered by the port."""
    with flox_tpu_torch.set_options(telemetry=True, replica_id=replica):
        METRICS.inc("serve.requests", requests)
        METRICS.set_gauge("serve.queue_depth", 1)
        METRICS.observe("serve.request_ms", latency_ms, exemplar=f"{replica}:req-1")
        text = exposition.prometheus_text(exemplars=True)
    telemetry.reset()
    return text


def _ref_replica_text(replica, requests, latency_ms):
    """The same replica's text, rendered by the reference."""
    with flox_tpu.set_options(telemetry=True, replica_id=replica):
        ref_telemetry.METRICS.inc("serve.requests", requests)
        ref_telemetry.METRICS.set_gauge("serve.queue_depth", 1)
        ref_telemetry.METRICS.observe("serve.request_ms", latency_ms,
                                      exemplar=f"{replica}:req-1")
        text = ref_exposition.prometheus_text(exemplars=True)
    ref_telemetry.reset()
    return text


def _strip_host(text):
    return re.sub(r',host="[^"]*"', "", text)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


_ROW = {"dispatches": 1, "device_ms": 2.0, "device_ms_max": 2.0, "bytes": 64, "compiles": 0,
        "compile_ms": 0.0, "hbm_peak": 0.0, "last_slow_trace": "a:req-1"}


class TestFederation:
    def test_scrape_and_merge_two_replicas(self):
        a = _FakeReplica(_replica_text("a", 3, 1.0),
                         costs={"cost_by_program": {"sum#1": _ROW}, "cost_by_tenant": {}})
        b = _FakeReplica(
            _replica_text("b", 5, 4.0),
            costs={"cost_by_program": {"sum#1": dict(_ROW, device_ms=6.0, device_ms_max=6.0,
                                                     last_slow_trace="b:req-1")},
                   "cost_by_tenant": {}},
            ready=False, reason="draining")
        try:
            view = fleet.Federator([("a", a.url), ("b", b.url)], interval=60).scrape_once()
            slot = view["counters"][("flox_tpu_serve_requests_total", ())]
            assert slot["replicas"] == {"a": 3.0, "b": 5.0} and slot["total"] == 8.0
            assert view["histograms"][("flox_tpu_serve_request_ms", ())]["merged"]["count"] == 2
            fused = view["cost_by_program"]["sum#1"]
            assert fused["dispatches"] == 2 and fused["last_slow_trace"] == "b:req-1"
            states = {r["replica"]: (r["ready"], r["reason"]) for r in view["replicas"]}
            assert states == {"a": (True, "ready"), "b": (False, "draining")}
            text = fleet.render_prometheus(view)
            assert 'flox_tpu_serve_requests_total{replica="a"} 3' in text
            assert 'flox_tpu_serve_requests_total{replica="b"} 5' in text
            assert "\nflox_tpu_serve_requests_total 8" in text
            assert "flox_tpu_fleet_replicas 2" in text
            assert "flox_tpu_fleet_replicas_ready 1" in text
        finally:
            a.close()
            b.close()

    def test_unreachable_replica_is_a_row_not_a_crash(self):
        a = _FakeReplica(_replica_text("a", 1, 1.0))
        try:
            view = fleet.Federator([("a", a.url), ("dead", "http://127.0.0.1:1")], interval=60,
                                   timeout=1.0).scrape_once()
            by_name = {r["name"]: r for r in view["replicas"]}
            assert by_name["a"]["ok"] and not by_name["dead"]["ok"]
            assert by_name["dead"]["error"]
            assert "flox_tpu_fleet_scrape_errors 1" in fleet.render_prometheus(view)
        finally:
            a.close()

    def test_federator_http_endpoints(self):
        a = _FakeReplica(_replica_text("a", 2, 1.0))
        federator = fleet.Federator([("a", a.url)], interval=60)
        try:
            federator.scrape_once()
            port = federator.serve(port=0)
            status, text = _get(port, "/metrics")
            assert status == 200 and 'flox_tpu_serve_requests_total{replica="a"} 2' in text
            status, body = _get(port, "/debug/costs")
            assert status == 200 and json.loads(body)["replica"] == "_fleet"
            status, body = _get(port, "/replicas")
            assert json.loads(body)[0]["replica"] == "a"
            assert _get(port, "/readyz")[0] == 200
            assert _get(port, "/healthz")[0] == 200
        finally:
            federator.stop()
            a.close()

    def test_fleet_readyz_503_when_no_replica_ready(self):
        a = _FakeReplica(_replica_text("a", 1, 1.0), ready=False, reason="warming")
        federator = fleet.Federator([("a", a.url)], interval=60)
        try:
            federator.scrape_once()
            assert _get(federator.serve(port=0), "/readyz")[0] == 503
        finally:
            federator.stop()
            a.close()

    def test_rendered_metrics_have_one_type_line_per_metric(self):
        with flox_tpu_torch.set_options(telemetry=True, replica_id="a"):
            METRICS.observe("serve.request_ms", 1.0)
            METRICS.observe("serve.request_ms|tenant=acme", 0.5)
            text = exposition.prometheus_text(exemplars=True)
        telemetry.reset()
        snap = fleet.ReplicaSnapshot(name="a", url="http://x", ok=True,
                                     metrics=fleet.parse_metrics_text(text))
        rendered = fleet.render_prometheus(fleet.federate([snap]))
        type_lines = [ln for ln in rendered.splitlines() if ln.startswith("# TYPE")]
        assert len(type_lines) == len(set(type_lines)), type_lines

    def test_merge_error_poisons_every_label_set_of_the_metric(self):
        def snap(name, edges):
            hist = {"edges": edges, "counts": [1] * len(edges), "sum": 1.0,
                    "count": len(edges), "exemplars": {}}
            return fleet.ReplicaSnapshot(name=name, url=f"http://{name}", ok=True, metrics={
                "counters": {}, "gauges": {}, "replica": name,
                "histograms": {("m_ms", ()): dict(hist, counts=list(hist["counts"])),
                               ("m_ms", (("tenant", "acme"),)): dict(
                                   hist, counts=list(hist["counts"]))}})

        view = fleet.federate([snap("a", [1.0, 2.0]), snap("b", [1.0, 4.0])])
        assert "m_ms" in view["merge_errors"]
        assert all(slot["merged"] is None for slot in view["histograms"].values())
        rendered = fleet.render_prometheus(view)
        assert "m_ms_bucket{le=" not in rendered.replace('replica="a"', "").replace(
            'replica="b"', "")
        assert 'flox_tpu_fleet_merge_errors{metric="m_ms"} 1' in rendered

    def test_unescape_round_trips_escaped_backslash_n(self):
        for name, raw in (("demo_ms", "a\\nb"), ("demo2_ms", "new\nline")):
            with flox_tpu_torch.set_options(telemetry=True, replica_id="a"):
                METRICS.observe(name, 0.5, exemplar=raw)
                text = exposition.prometheus_text(exemplars=True)
            telemetry.reset()
            hist = fleet.parse_metrics_text(text)["histograms"][(f"flox_tpu_{name}", ())]
            (slot,) = hist["exemplars"].values()
            assert slot[0] == raw

    def test_multi_replica_scrape_rejected(self):
        merged_like = ("# TYPE flox_tpu_serve_requests_total counter\n"
                       'flox_tpu_serve_requests_total{replica="a"} 3\n'
                       'flox_tpu_serve_requests_total{replica="b"} 5\n')
        with pytest.raises(ValueError, match="more than one replica"):
            fleet.parse_metrics_text(merged_like)

    def test_parse_replica_targets(self):
        spec = "a=http://h:1, b=http://h:2 ,http://h:3"
        assert fleet.parse_replica_targets(spec) == [
            ("a", "http://h:1"), ("b", "http://h:2"), ("h:3", "http://h:3")]
        assert fleet.parse_replica_targets(spec) == ref_fleet.parse_replica_targets(spec)
        for bad in (None, "a=not-a-url"):
            with pytest.raises(ValueError):
                fleet.parse_replica_targets(bad)

    def test_render_top_frame(self):
        a = _FakeReplica(_replica_text("a", 4, 2.0))
        try:
            frame = fleet.render_top(fleet.Federator([("a", a.url)], interval=60).scrape_once(),
                                     top=3)
            assert "a" in frame and "ready" in frame and "top 3 cost rows" in frame
        finally:
            a.close()

    def test_scrape_interval_comes_from_the_option(self):
        with flox_tpu_torch.set_options(fleet_scrape_interval=0.25):
            assert fleet.Federator([], interval=None).interval == 0.25


class TestParity:
    def test_same_texts_same_view_and_rendered_text(self):
        """Parsed by either package, the same scraped texts federate to the
        same view, the same exposition text and the same console frame."""
        texts = {"a": _replica_text("a", 3, 1.0), "b": _replica_text("b", 5, 40.0)}
        costs = {"a": {"cost_by_program": {"sum#1": _ROW}, "cost_by_tenant": {}},
                 "b": {"cost_by_program": {"sum#1": dict(_ROW, device_ms=6.0)},
                       "cost_by_tenant": {}}}
        views = []
        for mod in (fleet, ref_fleet):
            snaps = []
            for name, text in texts.items():
                snap = mod.ReplicaSnapshot(name=name, url=f"http://{name}", ok=True,
                                           metrics=mod.parse_metrics_text(text))
                snap.costs = costs[name]
                snaps.append(snap)
            views.append(mod.federate(snaps))
        port_view, ref_view = views
        for key in ("counters", "gauges", "histograms", "cost_by_program", "merge_errors"):
            assert port_view[key] == ref_view[key], key
        assert fleet.render_prometheus(port_view) == ref_fleet.render_prometheus(ref_view)
        assert fleet.render_top(port_view, top=3) == ref_fleet.render_top(ref_view, top=3)
        port_json = fleet.render_top_json(port_view, top=3)
        ref_json = ref_fleet.render_top_json(ref_view, top=3)
        port_json.pop("ts"), ref_json.pop("ts")  # the frame's wall clock
        assert port_json == ref_json

    def test_port_text_is_the_reference_text(self):
        # the port's exposition renders a replica as the reference does
        assert _strip_host(_replica_text("a", 3, 1.0)) == _strip_host(
            _ref_replica_text("a", 3, 1.0))

    def test_port_and_reference_replicas_federate_together(self):
        """A live port metrics server and a live reference metrics server
        behind one federator (either package's): counters sum, histograms
        merge, both ready."""
        with flox_tpu_torch.set_options(telemetry=True, replica_id="port"):
            METRICS.inc("serve.requests", 3)
            METRICS.observe("serve.request_ms", 2.0)
            port_port = exposition.start_metrics_server(port=0)
            exposition.set_ready(True)
            with flox_tpu.set_options(telemetry=True, replica_id="ref"):
                ref_cache.clear_all()
                ref_telemetry.METRICS.inc("serve.requests", 4)
                ref_telemetry.METRICS.observe("serve.request_ms", 8.0)
                ref_port = ref_exposition.start_metrics_server(port=0)
                ref_exposition.set_ready(True)
                try:
                    targets = [("port", f"http://127.0.0.1:{port_port}"),
                               ("ref", f"http://127.0.0.1:{ref_port}")]
                    views = [mod.Federator(targets, interval=60).scrape_once()
                             for mod in (fleet, ref_fleet)]
                finally:
                    ref_exposition.stop_metrics_server()
                    ref_exposition.set_ready(False)
                    ref_telemetry.reset()
        for view in views:
            slot = view["counters"][("flox_tpu_serve_requests_total", ())]
            assert slot["replicas"] == {"port": 3.0, "ref": 4.0} and slot["total"] == 7.0
            assert view["histograms"][("flox_tpu_serve_request_ms", ())]["merged"]["count"] == 2
            assert all(r["ready"] for r in view["replicas"])
            assert not view["merge_errors"]
        key = ("flox_tpu_serve_requests_total", ())
        assert views[0]["counters"][key] == views[1]["counters"][key]


def _program_row(digest, label, *, dispatches, device_ms, compile_ms=0.0, predicted_ms=1.0):
    net = max(0.0, device_ms - compile_ms)
    return {
        "label": label, "digest": digest, "platform": "cuda", "flops": 100.0,
        "bytes_accessed": 800.0, "analysis": "ok", "predicted_ms": predicted_ms,
        "model_ms": 25.0, "hlo_hash": "cafe" * 4,
        "observed": {"dispatches": dispatches, "device_ms": device_ms,
                     "device_ms_max": device_ms, "bytes": 64 * dispatches, "compiles": 0,
                     "compile_ms": compile_ms, "hbm_peak": 0.0, "last_slow_trace": None},
        "utilization": predicted_ms * dispatches / net if net else 0.0,
        "observed_ms_per_dispatch": net / dispatches if dispatches else None,
        "drift_ratio": (net / dispatches) / 25.0 if dispatches else None,
    }


class TestProgramCardFederation:
    def test_cards_union_by_digest_and_observed_merges(self):
        a = _FakeReplica(_replica_text("a", 1, 1.0), programs={
            "core[sum]": _program_row("d1", "core[sum]", dispatches=2, device_ms=10.0)})
        b = _FakeReplica(_replica_text("b", 1, 1.0), programs={
            "core[sum]": _program_row("d1", "core[sum]", dispatches=3, device_ms=30.0),
            "serve[sum#ab]": _program_row("d1", "serve[sum#ab]", dispatches=1,
                                          device_ms=5.0)})
        try:
            view = fleet.Federator([("a", a.url), ("b", b.url)], interval=60).scrape_once()
            card = view["programs"]["d1"]
            assert set(view["programs"]) == {"d1"}
            assert sorted(card["labels"]) == ["core[sum]", "serve[sum#ab]"]
            assert card["observed"]["dispatches"] == 6
            assert card["observed"]["device_ms"] == pytest.approx(45.0)
            assert card["utilization"] == pytest.approx(6 / 45.0, abs=1e-6)
            assert "util" in fleet.render_top(view, top=3)
        finally:
            a.close()
            b.close()

    def test_planeless_replica_is_an_empty_table_not_an_error(self):
        a = _FakeReplica(_replica_text("a", 1, 1.0))
        try:
            view = fleet.Federator([("a", a.url)], interval=60).scrape_once()
            assert view["programs"] == {} and view["replicas"][0]["ok"]
        finally:
            a.close()


class TestTopJson:
    def test_render_top_json_is_machine_readable(self):
        a = _FakeReplica(_replica_text("a", 4, 2.0), programs={
            "core[sum]": _program_row("d1", "core[sum]", dispatches=2, device_ms=10.0)})
        try:
            view = fleet.Federator([("a", a.url)], interval=60).scrape_once()
            parsed = json.loads(json.dumps(fleet.render_top_json(view, top=3)))
            row = parsed["replicas"][0]
            assert (row["replica"], row["state"], row["queue_depth"], row["qps"]) == (
                "a", "ready", 1, None)
            assert parsed["programs"][0]["digest"] == "d1"
            assert isinstance(parsed["top_costs"], list)
        finally:
            a.close()

    def test_top_json_cli_once(self, capsys):
        a = _FakeReplica(_replica_text("a", 2, 1.5))
        try:
            assert fleet.main(["top", "--replicas", f"a={a.url}", "--json", "--once",
                               "--interval", "60"]) == 0
            out = capsys.readouterr().out
            assert json.loads(out)["replicas"][0]["replica"] == "a"
            assert "\x1b[2J" not in out
        finally:
            a.close()


def _snapshot(name, *, datasets=(), stores=(), slo_payload=None):
    snap = fleet.ReplicaSnapshot(name=name, url=f"http://h/{name}", ok=True)
    snap.metrics = {"counters": {}, "gauges": {}, "histograms": {}, "replica": name}
    snap.datasets = {"datasets": list(datasets)}
    snap.stores = {"stores": list(stores)}
    snap.slo = slo_payload or {}
    snap.alerts = list((slo_payload or {}).get("alerts") or [])
    return snap


_FIRING = {"objective": "availability", "window": "fast", "severity": "page",
           "state": "firing", "burn_short": 20.0, "burn_long": 15.0}


class TestSLOFederation:
    def test_resident_state_and_alerts_federate(self):
        s1 = _snapshot("r1", datasets=[{"name": "ds", "nbytes": 100, "pins": 1, "hits": 7}],
                       stores=[{"store": "st", "gen": 3, "nbytes": 50, "staleness_s": 12.0}],
                       slo_payload={"healthy": False, "alerts": [_FIRING], "objectives": [
                           {"name": "availability", "kind": "availability", "healthy": False,
                            "budget_remaining": -1.0}]})
        s2 = _snapshot("r2", datasets=[{"name": "ds", "nbytes": 100, "pins": 0, "hits": 2}],
                       stores=[{"store": "st", "gen": 4, "nbytes": 60, "staleness_s": 3.0}],
                       slo_payload={"healthy": True, "objectives": [], "alerts": []})
        view = fleet.federate([s1, s2])
        assert view["datasets"]["ds"]["bytes"] == 200
        assert view["datasets"]["ds"]["replicas"]["r1"]["pins"] == 1
        assert view["stores"]["st"]["generations"] == {"r1": 3, "r2": 4}
        assert view["stores"]["st"]["state_bytes"] == 110
        assert view["stores"]["st"]["staleness_s"] == 3.0
        assert [a["replica"] for a in view["alerts"]] == ["r1"]
        assert view["slo"]["r1"]["healthy"] is False and view["slo"]["r2"]["healthy"] is True

    def test_top_views_carry_resident_and_alert_columns(self):
        pending = dict(_FIRING, window="slow", severity="ticket", state="pending")
        s1 = _snapshot("r1", datasets=[{"name": "ds", "nbytes": 100, "pins": 1, "hits": 7}],
                       stores=[{"store": "st", "gen": 3, "nbytes": 50, "staleness_s": 12.0}],
                       slo_payload={"healthy": False, "objectives": [],
                                    "alerts": [_FIRING, pending]})
        view = fleet.federate([s1])
        row = fleet.render_top_json(view)["replicas"][0]
        assert (row["datasets"], row["dataset_bytes"], row["stores"], row["staleness_s"]) == (
            1, 100, 1, 12.0)
        assert (row["alerts_firing"], row["alerts_pending"], row["slo_healthy"]) == (1, 1, False)
        text = fleet.render_top(view)
        assert "alerts" in text and "1F/1P" in text and "availability/fast" in text

    def test_dedup_keeps_most_live_state(self):
        s = _snapshot("r1", slo_payload={"healthy": False, "objectives": [], "alerts": []})
        s.alerts = [{"objective": "o", "window": "w", "severity": "ticket", "state": "resolved"},
                    {"objective": "o", "window": "w", "severity": "page", "state": "firing"}]
        view = fleet.federate([s])
        assert [a["state"] for a in view["alerts"]] == ["firing"]

    def test_federator_endpoints_serve_alerts_and_slo(self):
        fed = fleet.Federator([], interval=3600)
        s1 = _snapshot("r1", slo_payload={"healthy": False, "objectives": [],
                                          "alerts": [_FIRING]})
        with fed._lock:
            fed._view = fleet.federate([s1])
        port = fed.serve(port=0)
        try:
            body = json.loads(_get(port, "/alerts")[1])
            assert body["firing"] == 1 and body["healthy"] is False
            assert body["alerts"][0]["replica"] == "r1"
            body = json.loads(_get(port, "/slo")[1])
            assert body["healthy"] is False and body["replicas"]["r1"]["healthy"] is False
        finally:
            fed.stop()

    def test_live_replica_slo_federates(self):
        """A port replica's own ``/slo`` (its metrics server) reaches the
        federator's ``/slo`` and ``/alerts``."""
        with flox_tpu_torch.set_options(telemetry=True, replica_id="r1"):
            port = exposition.start_metrics_server(port=0)
            exposition.set_ready(True)
            fed = fleet.Federator([("r1", f"http://127.0.0.1:{port}")], interval=60)
            try:
                fed.scrape_once()
                fport = fed.serve(port=0)
                body = json.loads(_get(fport, "/slo")[1])
                assert body["healthy"] is True and body["replicas"]["r1"]["healthy"] is True
                body = json.loads(_get(fport, "/alerts")[1])
                assert body["alerts"] == [] and body["healthy"] is True
            finally:
                fed.stop()


class TestCLI:
    def test_federate_process_serves_the_merged_view(self):
        a = _FakeReplica(_replica_text("a", 2, 1.0))
        b = _FakeReplica(_replica_text("b", 5, 1.0))
        proc = subprocess.Popen(
            [sys.executable, "-m", "flox_tpu_torch.fleet", "federate", "--replicas",
             f"a={a.url},b={b.url}", "--port", "0", "--interval", "0.2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, text=True)
        try:
            line = proc.stdout.readline()
            port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
            assert _get(port, "/readyz")[0] == 200
            status, text = _get(port, "/metrics")
            assert status == 200 and "\nflox_tpu_serve_requests_total 7" in text
            status, body = _get(port, "/alerts")
            assert status == 200 and json.loads(body)["alerts"] == []
        finally:
            proc.terminate()
            proc.communicate(timeout=30)
            a.close()
            b.close()

    def test_federate_once_and_top_once_plain(self):
        a = _FakeReplica(_replica_text("a", 2, 1.0))
        b = _FakeReplica(_replica_text("b", 3, 1.0))
        try:
            targets = f"a={a.url},b={b.url}"
            once = subprocess.run(
                [sys.executable, "-m", "flox_tpu_torch.fleet", "federate", "--replicas",
                 targets, "--once"], cwd=REPO, capture_output=True, text=True, timeout=120)
            assert once.returncode == 0, once.stderr
            assert "\nflox_tpu_serve_requests_total 5" in once.stdout
            top = subprocess.run(
                [sys.executable, "-m", "flox_tpu_torch.fleet", "top", "--once", "--plain"],
                cwd=REPO, capture_output=True, text=True, timeout=120,
                env=dict(os.environ, FLOX_TPU_FLEET_REPLICAS=targets))
            assert top.returncode == 0, top.stderr
            assert "\x1b[2J" not in top.stdout
            assert re.search(r"^a\s", top.stdout, re.M) and re.search(r"^b\s", top.stdout, re.M)
        finally:
            a.close()
            b.close()


class TestFleetPlaneNeutrality:
    def test_bit_identity_with_fleet_plane_on(self):
        vals = np.random.default_rng(3).normal(size=(4, 64))
        codes = np.arange(64) % 7
        base, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device="cpu")
        with flox_tpu_torch.set_options(telemetry=True, replica_id="r1"):
            lit, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device="cpu")
        assert base.numpy().tobytes() == lit.numpy().tobytes()
