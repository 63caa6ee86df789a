"""The port's metrics exposition (``flox_tpu_torch.exposition``) held
against flox_tpu's (the exposition cases of ``tests/test_observability.py``).

The same registry contents render byte for byte the reference's Prometheus
text (counters, gauges, cumulative histograms, labeled series, exemplars);
the endpoint serves ``/metrics``, ``/healthz``, ``/readyz`` (503 while
warming, around a simulated device loss and during a drain), the
``/debug/*`` tables, and answers ``/slo`` and ``/alerts`` with the
reference's payloads. Dispatchers run on the CPU.
Every HTTP call carries its own timeout.
"""

from __future__ import annotations

import asyncio
import json
import os
import select
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import flox_tpu
import flox_tpu_torch
from flox_tpu import exposition as ref_exposition, telemetry as ref_telemetry
from flox_tpu_torch import cache, costmodel, exposition, faults, telemetry
from flox_tpu_torch.serve import Dispatcher as _Dispatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_plane():
    with flox_tpu_torch.set_options(telemetry=False, telemetry_export_path=None,
                                    flight_recorder_path=None, serve_aot_dir=None):
        cache.clear_all()
        exposition.set_ready(False)
        yield
        cache.clear_all()
    exposition.stop_metrics_server()
    exposition.set_ready(False)


def Dispatcher(**kw):
    return _Dispatcher(device="cpu", **kw)


def _run_reduce():
    vals = np.random.default_rng(0).normal(size=(3, 48))
    return flox_tpu_torch.groupby_reduce(vals, np.arange(48) % 5, func="nanmean", device="cpu")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read().decode()


def _parse_prometheus(text: str) -> tuple[dict, dict, dict]:
    """``{metric-with-labels: value}``, ``{metric: type}`` and the exemplars;
    raises on any line that is not a comment, a blank or a sample."""
    samples: dict[str, float] = {}
    types: dict[str, str] = {}
    exemplars: dict[str, tuple[str, float]] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        sample_part, sep, exemplar_part = line.partition(" # ")
        name_part, _, value_part = sample_part.rpartition(" ")
        assert name_part, f"unparseable sample line: {line!r}"
        value = float(value_part)
        if "{" in name_part:
            assert name_part.endswith("}"), f"unclosed label set: {line!r}"
        samples[name_part] = value
        if sep:
            labels_part, _, obs_part = exemplar_part.rpartition(" ")
            assert labels_part.startswith("{") and labels_part.endswith("}"), line
            exemplars[name_part] = (labels_part, float(obs_part))
    return samples, types, exemplars


def _feed(metrics):
    """The same registry contents, fed into either package's registry."""
    metrics.inc("serve.requests", 3)
    metrics.inc("serve.weird-name.v2")
    metrics.set_gauge("hbm.bytes_in_use", 12345.0)
    metrics.set_gauge("registry.occupancy", 0.25)
    for v, ex in ((0.5, "req-1"), (700.0, None), (3.2, 'r"2\\x')):
        metrics.observe("serve.request_ms", v, exemplar=ex)
    metrics.observe("serve.request_ms|tenant=acme", 1.5, exemplar="req-t")


class TestPrometheusText:
    @pytest.mark.parametrize("exemplars", [False, True])
    def test_byte_for_byte_the_references(self, exemplars):
        with flox_tpu_torch.set_options(telemetry=True), flox_tpu.set_options(telemetry=True):
            telemetry.METRICS.reset()
            ref_telemetry.METRICS.reset()
            try:
                _feed(telemetry.METRICS)
                _feed(ref_telemetry.METRICS)
                got = exposition.prometheus_text(exemplars=exemplars)
                want = ref_exposition.prometheus_text(exemplars=exemplars)
            finally:
                ref_telemetry.METRICS.reset()
        assert got == want
        _parse_prometheus(got)

    def test_golden_format(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
            telemetry.METRICS.set_gauge("hbm.bytes_in_use", 12345.0)
            telemetry.METRICS.inc("serve.weird-name.v2")
        samples, types, _ = _parse_prometheus(exposition.prometheus_text())
        assert types["flox_tpu_hbm_bytes_in_use"] == "gauge"
        assert samples["flox_tpu_hbm_bytes_in_use"] == 12345.0
        assert "flox_tpu_serve_weird_name_v2_total" in samples
        assert types["flox_tpu_span_ms_groupby_reduce"] == "histogram"
        buckets = [v for k, v in samples.items()
                   if k.startswith('flox_tpu_span_ms_groupby_reduce_bucket{le="')]
        assert len(buckets) == len(telemetry.HIST_EDGES_MS) + 1
        assert buckets == sorted(buckets)
        assert samples['flox_tpu_span_ms_groupby_reduce_bucket{le="+Inf"}'] == (
            samples["flox_tpu_span_ms_groupby_reduce_count"])

    def test_replica_labels(self):
        with flox_tpu_torch.set_options(telemetry=True, replica_id="rep-a"):
            telemetry.METRICS.inc("serve.requests")
            text = exposition.prometheus_text()
        assert 'flox_tpu_serve_requests_total{replica="rep-a",host="' in text


class TestMetricsServer:
    def test_endpoints(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
        port = exposition.start_metrics_server(port=0)
        assert port and port > 0
        assert exposition.start_metrics_server(port=0) == port
        assert _get(port, "/healthz")[0] == 200
        status, _, body = _get(port, "/readyz")
        assert status == 503 and body.strip() == "warming"
        exposition.set_ready(True)
        assert _get(port, "/readyz")[0] == 200
        assert _get(port, "/nope")[0] == 404
        status, ctype, body = _get(port, "/metrics")
        assert status == 200 and "text/plain" in ctype
        samples, _, _ = _parse_prometheus(body)
        assert samples["flox_tpu_metrics_scrapes_total"] >= 1

    def test_disabled_by_default_option(self):
        assert exposition.start_metrics_server() is None

    @pytest.mark.parametrize("path", ["/slo", "/alerts"])
    def test_slo_endpoints_name_the_roadmap_item(self, path):
        # the SLO plane is ported: both endpoints answer the reference's
        # payloads (same keys, same objectives, no alerts on a quiet replica)
        from flox_tpu import cache as ref_cache

        port = exposition.start_metrics_server(port=0)
        status, ctype, body = _get(port, path)
        assert status == 200 and "application/json" in ctype
        got = json.loads(body)
        ref_cache.clear_all()
        ref_port = ref_exposition.start_metrics_server(port=0)
        try:
            ref_status, _, ref_body = _get(ref_port, path)
        finally:
            ref_exposition.stop_metrics_server()
        want = json.loads(ref_body)
        assert ref_status == 200
        assert got.keys() == want.keys()
        assert got["alerts"] == want["alerts"] == []
        assert got["healthy"] is want["healthy"] is True
        if path == "/slo":
            assert got["objectives"] == want["objectives"]

    def test_debug_costs_and_programs(self):
        with flox_tpu_torch.set_options(telemetry=True, costmodel=True):
            _run_reduce()
            port = exposition.start_metrics_server(port=0)
            status, ctype, body = _get(port, "/debug/costs")
            assert status == 200 and "application/json" in ctype
            payload = json.loads(body)
            assert payload["cost_by_program"].keys() == cache.stats()["cost_by_program"].keys()
            assert payload["replica"] and payload["host"]
            status, _, body = _get(port, "/debug/programs")
            assert status == 200 and "programs" in json.loads(body)
            for bad in ("abc", "0", "-3"):
                status, _, body = _get(port, f"/debug/costs?top={bad}")
                assert status == 400 and json.loads(body)["ok"] is False

    def test_debug_datasets_and_stores(self, tmp_path):
        from flox_tpu_torch.serve import registry, stores

        registry.put("ds", np.arange(8.0), np.arange(8) % 2, device="cpu")
        with flox_tpu_torch.set_options(store_root=str(tmp_path)):
            stores.append("st", np.array([0, 1]), np.array([1.0, 2.0]),
                          create={"funcs": ["sum"], "size": 2}, device="cpu")
            port = exposition.start_metrics_server(port=0)
            status, _, body = _get(port, "/debug/datasets")
            assert status == 200
            payload = json.loads(body)
            assert payload["datasets"][0]["name"] == "ds" and payload["budget_bytes"] > 0
            status, _, body = _get(port, "/debug/stores")
            assert status == 200
            assert json.loads(body)["stores"][0]["store"] == "st"

    def test_debug_profile_unavailable_without_root(self):
        port = exposition.start_metrics_server(port=0)
        status, _, body = _get(port, "/debug/profile?seconds=0.1")
        assert status in (501, 202)
        status, _, body = _get(port, "/debug/profile?seconds=abc")
        assert status in (400, 501)

    def test_exemplars_only_on_request(self):
        with flox_tpu_torch.set_options(telemetry=True):
            telemetry.METRICS.observe("demo_ms", 0.5, exemplar="req-http")
            port = exposition.start_metrics_server(port=0)
            plain = _get(port, "/metrics")[2]
            rich = _get(port, "/metrics?exemplars=1")[2]
        assert " # {trace_id=" not in plain
        assert ' # {trace_id="req-http"}' in rich
        _parse_prometheus(plain)
        _parse_prometheus(rich)


class TestReadiness:
    def test_ready_reason_states(self):
        exposition.set_ready(True)
        assert exposition.ready() and exposition.ready_reason() == "warming"
        exposition.set_ready(False, reason="draining")
        assert not exposition.ready() and exposition.ready_reason() == "draining"
        exposition.set_ready(False, reason="device-lost")
        assert exposition.ready_reason() == "device-lost"
        exposition.set_ready(True)
        assert exposition.ready_reason() == "warming"

    def test_readyz_flips_around_a_simulated_device_loss(self, monkeypatch):
        """/readyz answers 503 device-lost while the recovery runs, then 200;
        the request after it answers as the one before."""
        from flox_tpu_torch.serve import DeviceLostError, aot, registry

        values, labels = np.arange(16.0), np.arange(16) % 4
        registry.put("ds", values, labels, device="cpu")
        release = threading.Event()
        real_warmup = aot.warmup
        monkeypatch.setattr(aot, "warmup",
                            lambda *a, **k: release.wait(timeout=30) and real_warmup(*a, **k))
        port = exposition.start_metrics_server(port=0)
        exposition.set_ready(True)

        async def main():
            d = Dispatcher()
            before = await d.submit(func="sum", dataset="ds")
            with faults.serve_inject(device_loss_at=[1]):
                with pytest.raises(DeviceLostError):
                    await d.submit(func="sum", dataset="ds")
                during = await asyncio.to_thread(_get, port, "/readyz")
                release.set()
                await asyncio.wait_for(d.close(), 30)
            after_status = await asyncio.to_thread(_get, port, "/readyz")
            after = await d.submit(func="sum", dataset="ds")
            await d.close()
            return before, during, after_status, after

        before, during, after_status, after = asyncio.run(asyncio.wait_for(main(), 60))
        assert during[0] == 503 and during[2].strip() == "device-lost"
        assert after_status[0] == 200
        np.testing.assert_array_equal(after.result, before.result)
        samples, _, _ = _parse_prometheus(_get(port, "/metrics")[2])
        assert samples["flox_tpu_serve_device_lost_total"] == 1
        assert samples["flox_tpu_serve_recoveries_total"] == 1

    def test_readyz_503_during_a_drain(self):
        """The serve loop flips /readyz to 503 "draining" at the shutdown op
        and answers its in-flight request before it exits 0."""
        import socket

        env = dict(os.environ)
        env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
        # --metrics-port 0 keeps the endpoint off, as in the reference: ask
        # the kernel for a free port and hand it over
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            free = sock.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu",
             "--metrics-port", str(free), "--batch-window", "1.5"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env)
        try:
            reader = _LineReader(proc)
            port = json.loads(reader.line(timeout=60))["port"]
            assert port == free

            def poll(want):
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    got = _get(port, "/readyz")
                    if got[0] == want:
                        return got
                    time.sleep(0.02)
                return got

            # the port line comes before the loop flips readiness on
            assert poll(200)[0] == 200
            proc.stdin.write(json.dumps({"id": "inflight", "func": "sum",
                                         "array": [1.0, 2.0, 4.0], "by": [0, 1, 1]}) + "\n")
            proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
            proc.stdin.flush()
            status, _, body = poll(503)
            assert status == 503 and body.strip() == "draining"
            out = reader.until_eof(timeout=60)
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        assert proc.returncode == 0
        recs = {r.get("id", r.get("op")): r for r in map(json.loads, out.splitlines())}
        assert recs["inflight"]["ok"] and recs["inflight"]["result"] == [1.0, 6.0]
        assert recs["shutdown"]["source"] == "shutdown-op"


class _LineReader:
    """Bounded line reads from a live subprocess's raw stdout."""

    def __init__(self, proc) -> None:
        self.proc = proc
        self.fd = proc.stdout.fileno()
        self.buf = b""

    def line(self, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            head, sep, rest = self.buf.partition(b"\n")
            if sep:
                self.buf = rest
                return head.decode()
            ready, _, _ = select.select([self.fd], [], [], 0.2)
            if ready:
                self.buf += os.read(self.fd, 65536)
            elif self.proc.poll() is not None:
                raise AssertionError(f"exited early: {self.proc.stderr.read()[-2000:]}")
        raise AssertionError(f"no line within {timeout}s")

    def until_eof(self, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ready, _, _ = select.select([self.fd], [], [], 0.2)
            if not ready:
                continue
            chunk = os.read(self.fd, 65536)
            if not chunk:
                out, self.buf = self.buf, b""
                return out.decode()
            self.buf += chunk
        raise AssertionError(f"no EOF within {timeout}s")


class TestGauges:
    def test_saturation_and_resident_gauges_seeded_at_start(self):
        with flox_tpu_torch.set_options(telemetry=True):
            port = exposition.start_metrics_server(port=0)
            samples, types, _ = _parse_prometheus(_get(port, "/metrics")[2])
        for name in (*telemetry.SATURATION_GAUGES, *telemetry.RESIDENT_GAUGES):
            metric = "flox_tpu_" + name.replace(".", "_")
            assert metric in samples and types[metric] == "gauge", metric
        assert samples["flox_tpu_registry_budget_bytes"] > 0

    def test_sample_saturation_reads_live_state(self):
        from flox_tpu_torch import pipeline
        from flox_tpu_torch.serve import registry
        from flox_tpu_torch.serve.dispatcher import _PENDING_REGISTRY

        registry.put("ds", np.arange(8.0), np.arange(8) % 2, device="cpu")
        with flox_tpu_torch.set_options(telemetry=True, registry_budget_bytes=1000):
            _PENDING_REGISTRY[991] = object()
            pipeline._PREFETCH_INFLIGHT[0] = 3
            try:
                telemetry.sample_saturation()
            finally:
                _PENDING_REGISTRY.pop(991, None)
                pipeline._PREFETCH_INFLIGHT[0] = 0
            assert telemetry.METRICS.get("serve.queue_depth") == 1
            assert telemetry.METRICS.get("stream.prefetch_occupancy") == 3
            assert telemetry.METRICS.get("registry.bytes") > 0
            assert 0 < telemetry.METRICS.get("registry.occupancy") < 1

    def test_sampler_thread_runs_and_stops(self):
        with flox_tpu_torch.set_options(telemetry=True, metrics_sample_interval=0.01):
            assert telemetry.start_saturation_sampler() is True
            for _ in range(300):
                if telemetry.METRICS.gauges().get("serve.queue_depth") is not None:
                    break
                time.sleep(0.01)
            assert telemetry.METRICS.gauges().get("serve.queue_depth") == 0
        telemetry.stop_saturation_sampler()
        assert telemetry._SAMPLER_STATE["thread"] is None

    def test_store_staleness_gauges(self, tmp_path):
        from flox_tpu_torch.serve import stores

        with flox_tpu_torch.set_options(telemetry=True, store_root=str(tmp_path)):
            stores.append("st", np.array([0]), np.array([1.0]),
                          create={"funcs": ["sum"], "size": 2}, device="cpu")
            telemetry.sample_resident_state()
            gauges = telemetry.METRICS.gauges()
        assert "store.staleness_s|store=st" in gauges and gauges["store.open_stores"] == 1

    def test_breaker_gauge_and_flight_dump_sections(self, tmp_path):
        from flox_tpu_torch.serve import breaker

        path = tmp_path / "flight.jsonl"
        with flox_tpu_torch.set_options(telemetry=True, serve_breaker_threshold=1):
            breaker.record_failure(("k",), "sum")
            telemetry.sample_saturation()
            assert telemetry.METRICS.get("serve.breakers_open") == 1
            assert telemetry.flight_dump(path, reason="test") == str(path)
        header = json.loads(path.read_text().splitlines()[0])["attrs"]
        assert header["breakers"]["open"] == 1
        assert set(header["resident"]) == set(telemetry.RESIDENT_GAUGES)

    def test_record_serve_error_counts_when_enabled(self):
        telemetry.record_serve_error(ValueError("x"), what="off")
        assert telemetry.METRICS.get("serve.swallowed_errors") == 0
        with flox_tpu_torch.set_options(telemetry=True):
            telemetry.record_serve_error(ValueError("x"), what="on")
        assert telemetry.METRICS.get("serve.swallowed_errors") == 1


class TestServeLedger:
    def _submit(self, **kw):
        async def go():
            d = Dispatcher()
            res = await d.submit(func="sum", array=np.array([1.0, 2.0, 4.0, 8.0]),
                                 by=np.array([0, 0, 1, 1]), **kw)
            await d.close()
            return res

        return asyncio.run(asyncio.wait_for(go(), 60))

    def test_tenant_feeds_ledger_and_labeled_histogram(self):
        with flox_tpu_torch.set_options(telemetry=True):
            result = self._submit(tenant="acme", request_id="req-t1")
        np.testing.assert_allclose(result.result, [3.0, 12.0])
        tenants = cache.stats()["cost_by_tenant"]
        assert tenants["acme"]["dispatches"] == 1 and tenants["acme"]["bytes"] > 0
        text = exposition.prometheus_text()
        samples, types, _ = _parse_prometheus(text)
        assert samples['flox_tpu_serve_request_ms_count{tenant="acme"}'] == 1
        assert text.count("# TYPE flox_tpu_serve_request_ms histogram") == 1

    def test_serve_program_row_and_alias(self):
        with flox_tpu_torch.set_options(telemetry=True, costmodel=True):
            self._submit()
            programs = telemetry.cost_by_program()
        serve_rows = [p for p in programs if p.startswith("serve[sum#")]
        assert serve_rows and programs[serve_rows[0]]["compiles"] == 0
        # the serving label indexes the card of the kernels its dispatch ran
        assert costmodel.card_for(serve_rows[0]) is not None
        assert costmodel.card_for(serve_rows[0])["digest"] == \
            costmodel.card_for("bundle[sum]")["digest"]


class TestServeMetricsCLI:
    def test_standalone_endpoint_answers_and_dies_on_sigterm(self):
        import signal

        proc = subprocess.Popen(
            [sys.executable, "-m", "flox_tpu_torch.telemetry", "serve-metrics", "--port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        try:
            line = _LineReader(proc).line(timeout=60)
            port = int(line.rsplit(":", 1)[1])
            assert _get(port, "/readyz")[0] == 200
            status, _, body = _get(port, "/metrics")
            assert status == 200
            _parse_prometheus(body)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        assert proc.returncode != 0  # the default disposition: killed by the signal
