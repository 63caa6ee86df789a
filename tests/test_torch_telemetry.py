"""The port's telemetry plane (flox_tpu_torch.telemetry, metric_names) against
flox_tpu's, on the CPU.

The cases of tests/test_telemetry.py that the port has a counterpart for
(``TestDisabledMode``, ``TestBitIdentity``, ``TestSpans``, ``TestMetrics``,
``TestExporters``, ``TestOptions``, ``TestHistograms``), run on the port with
``device="cpu"``, and then the port held against the reference:

* the pure functions (traceparent parsing and formatting, histogram buckets
  and percentiles, ``tenant_label``, ``summarize``, the Chrome-trace layout)
  give the same answers on the same inputs;
* a ``groupby_reduce`` nanmean, a ``groupby_aggregate_many`` trio, a streamed
  nanmean and a mesh nanmean give the same span names (and attribute names)
  and the same counter names, less the reference's ``jax.*`` compile
  counters, its ``cache.*`` program-cache counters and the
  ``costmodel.card_traces`` of its analysis compile, which have no
  counterpart: the port compiles no programs and keeps no program cache;
* ``metric_names`` is the reference's, name for name;
* a fresh interpreter imports the observability modules without JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401 - tests/conftest.py configures it for the reference

import flox_tpu
from flox_tpu import telemetry as ref_telemetry
import flox_tpu_torch
from flox_tpu_torch import telemetry
from flox_tpu_torch.options import OPTIONS

REPO = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Every test starts from an empty buffer and registry with telemetry
    off, whatever the environment sets."""
    with flox_tpu_torch.set_options(telemetry=False, telemetry_export_path=None,
                                    costmodel=False):
        telemetry.reset()
        yield
        telemetry.reset()


def _run_reduce(**kw):
    vals = np.random.default_rng(0).normal(size=(3, 48)).astype(np.float64)
    codes = np.arange(48) % 5
    return flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device="cpu", **kw)


def _stream(func="nansum", **kw):
    vals = np.random.default_rng(1).normal(size=(2, 64))
    return flox_tpu_torch.streaming_groupby_reduce(
        lambda s, e: vals[:, s:e], np.arange(64) % 4, func=func, batch_len=16, device="cpu",
        **kw)


# ---------------------------------------------------------------------------
# disabled mode: a true no-op
# ---------------------------------------------------------------------------


class TestDisabledMode:
    def test_span_is_the_shared_noop_singleton(self):
        s1 = telemetry.span("groupby_reduce")
        s2 = telemetry.span("factorize", ngroups=3)
        assert s1 is s2 is telemetry._NOOP
        with s1 as sp:
            sp.set(attr=1)
        assert telemetry.spans() == []

    def test_counters_untouched_and_no_records(self):
        _run_reduce()
        _stream()
        flox_tpu_torch.groupby_aggregate_many(np.arange(8.0), np.arange(8) % 2,
                                              funcs=("sum", "max"), device="cpu")
        assert telemetry.spans() == []
        assert telemetry.METRICS.snapshot() == {}
        assert telemetry.cost_by_program() == {}

    def test_module_helpers_noop(self):
        telemetry.count("x")
        telemetry.event("y", a=1)
        telemetry.record_span("z", 0.0, 1.0)
        telemetry.current_set(a=1)
        assert telemetry.spans() == []
        assert telemetry.METRICS.snapshot() == {}

    def test_no_device_timer_or_capture_is_made(self):
        from flox_tpu_torch import costmodel

        assert telemetry.device_timer("cpu") is telemetry._NOOP
        assert telemetry.trace("req") is telemetry._NOOP
        assert costmodel.capture() is costmodel._NO_CAPTURE


# ---------------------------------------------------------------------------
# spans on the profiler's timeline
# ---------------------------------------------------------------------------


class TestProfilerRanges:
    def test_spans_are_ranges_while_a_profiler_records(self):
        from torch.profiler import ProfilerActivity, profile

        with flox_tpu_torch.set_options(telemetry=True):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                _run_reduce()
        spans = {r["name"] for r in telemetry.spans() if r["type"] == "span"}
        assert {"groupby_reduce", "factorize", "dispatch", "legs"} <= _range_names(prof)
        assert _range_names(prof) == spans

    @pytest.mark.parametrize("telemetry_on, profiled", [(False, True), (True, False)])
    def test_no_range_unless_both(self, monkeypatch, telemetry_on, profiled):
        import torch
        from torch.profiler import ProfilerActivity, profile

        opened = []
        real = torch.profiler.record_function

        def counting(name, *args, **kw):
            opened.append(name)
            return real(name, *args, **kw)

        monkeypatch.setattr(torch.profiler, "record_function", counting)
        with flox_tpu_torch.set_options(telemetry=telemetry_on):
            with profile(activities=[ProfilerActivity.CPU]) if profiled else \
                    contextlib.nullcontext():
                _run_reduce()
        assert opened == []
        with flox_tpu_torch.set_options(telemetry=True):
            with profile(activities=[ProfilerActivity.CPU]):
                _run_reduce()
        assert "groupby_reduce" in opened  # the count does see the ranges opened

    def test_disabled_span_reads_no_profiler_state(self, monkeypatch):
        import torch

        def boom():
            raise AssertionError("the profiler's state was read with telemetry off")

        monkeypatch.setattr(torch.autograd, "_profiler_enabled", boom)
        with telemetry.span("x") as sp:
            sp.set(a=1)
        assert telemetry.spans() == []


def test_collective_spans_in_a_two_rank_world(tmp_path):
    """Each collective of a 2-rank gloo world's map-reduce nanmean opens a
    ``collective`` span with its op, dtypes, bytes and ranks, and
    ``mesh.collective_bytes`` is the sum of their bytes."""
    import torch_mesh_world as W

    for rank in W.run_world(["collective-spans"], str(tmp_path), world=2):
        status, (spans, counters), _ = rank["collective-spans"]
        assert status == "ok"
        assert spans, "no collective span"
        for attrs in spans:
            assert set(attrs) == {"op", "dtype", "wire_dtype", "nbytes", "ranks"}
            assert attrs["ranks"] == 2 and attrs["nbytes"] > 0
        assert {a["op"] for a in spans} <= {"psum", "pmax", "pmin", "all_gather",
                                             "psum_scatter"}
        assert counters["mesh.collectives"] == len(spans)
        assert counters["mesh.collective_bytes"] == sum(a["nbytes"] for a in spans)


# ---------------------------------------------------------------------------
# enabled/disabled bit-identity
# ---------------------------------------------------------------------------


def _bits(x) -> bytes:
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x).tobytes()


class TestBitIdentity:
    @pytest.mark.parametrize("level", ["basic", "detailed"])
    def test_reduce_identical(self, level):
        from torch.profiler import ProfilerActivity, profile

        off, _ = _run_reduce()
        with flox_tpu_torch.set_options(telemetry=True, telemetry_level=level, costmodel=True):
            on, _ = _run_reduce()
            with profile(activities=[ProfilerActivity.CPU]):  # every span a range too
                ranged, _ = _run_reduce()
        assert _bits(off) == _bits(on) == _bits(ranged)

    def test_mesh_reduce_identical(self):
        off, _ = _run_reduce(method="map-reduce")
        with flox_tpu_torch.set_options(telemetry=True, telemetry_level="detailed",
                                        costmodel=True):
            on, _ = _run_reduce(method="map-reduce")
        assert _bits(off) == _bits(on)

    def test_scan_identical(self):
        vals = RNG.normal(size=64)
        codes = np.arange(64) % 3
        off = flox_tpu_torch.groupby_scan(vals, codes, func="cumsum", device="cpu")
        with flox_tpu_torch.set_options(telemetry=True):
            on = flox_tpu_torch.groupby_scan(vals, codes, func="cumsum", device="cpu")
        assert _bits(off) == _bits(on)

    def test_streaming_identical(self):
        off, _ = _stream("nanmean")
        with flox_tpu_torch.set_options(telemetry=True, telemetry_level="detailed",
                                        costmodel=True):
            on, _ = _stream("nanmean")
        assert _bits(off) == _bits(on)

    def test_aggregate_many_identical(self):
        vals = RNG.normal(size=(3, 40)).astype(np.float32)
        codes = np.arange(40) % 6
        funcs = ("nanmean", "nanmin", "nanmax")
        off, _ = flox_tpu_torch.groupby_aggregate_many(vals, codes, funcs=funcs, device="cpu")
        with flox_tpu_torch.set_options(telemetry=True, costmodel=True):
            on, _ = flox_tpu_torch.groupby_aggregate_many(vals, codes, funcs=funcs,
                                                          device="cpu")
        assert all(_bits(off[f]) == _bits(on[f]) for f in funcs)


# ---------------------------------------------------------------------------
# span hierarchy per execution path
# ---------------------------------------------------------------------------


def _range_names(prof) -> set:
    """The ``record_function`` ranges a ``torch.profiler`` recorded."""
    return {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}


def _by_name(records):
    out = {}
    for rec in records:
        out.setdefault(rec["name"], []).append(rec)
    return out


class TestSpans:
    def test_eager_reduce_phases(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
        spans = _by_name([r for r in telemetry.spans() if r["type"] == "span"])
        root = spans["groupby_reduce"][0]
        for phase in ("factorize", "dispatch", "combine", "finalize"):
            assert spans[phase][0]["parent"] == root["id"], phase
        assert root["parent"] is None
        assert spans["factorize"][0]["attrs"]["size"] == 5
        assert spans["dispatch"][0]["attrs"]["engine"] == "torch"

    def test_mesh_reduce_phases(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce(method="map-reduce")
        names = {r["name"] for r in telemetry.spans()}
        assert {"groupby_reduce", "factorize", "combine", "finalize", "program-build"} <= names

    def test_scan_phases(self):
        with flox_tpu_torch.set_options(telemetry=True):
            flox_tpu_torch.groupby_scan(RNG.normal(size=32), np.arange(32) % 3, func="cumsum",
                                        device="cpu")
        names = {r["name"] for r in telemetry.spans()}
        assert {"groupby_scan", "factorize", "dispatch", "finalize"} <= names

    def test_mesh_scan_annotated(self):
        from torch.profiler import ProfilerActivity, profile

        with flox_tpu_torch.set_options(telemetry=True):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                flox_tpu_torch.groupby_scan(RNG.normal(size=32), np.arange(32) % 3,
                                            func="cumsum", method="blelloch", device="cpu")
        names = {r["name"] for r in telemetry.spans()}
        assert "flox:mesh-scan[cumsum/blelloch]" in names
        assert "flox:mesh-scan[cumsum/blelloch]" in _range_names(prof)

    def test_streaming_phases_and_stream_report_attrs(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _stream("nanmean")
        spans = _by_name([r for r in telemetry.spans() if r["type"] == "span"])
        assert {"streaming_groupby_reduce", "factorize", "finalize"} <= set(spans)
        attrs = spans["stream[reduce[nanmean]]"][0]["attrs"]
        for key in ("slabs", "prefetch", "load_ms", "stage_ms", "wait_ms", "dispatch_ms",
                    "overlap_fraction", "retries"):
            assert key in attrs, key
        assert attrs["slabs"] == 4

    def test_detailed_level_stage_spans(self):
        with flox_tpu_torch.set_options(telemetry=True, telemetry_level="detailed"):
            _stream()
        stage = [r for r in telemetry.spans() if r["name"] == "stage"]
        assert len(stage) == 4
        assert {s["attrs"]["index"] for s in stage} == {0, 1, 2, 3}

    def test_basic_level_omits_stage_spans(self):
        with flox_tpu_torch.set_options(telemetry=True, telemetry_level="basic"):
            _stream()
        assert not [r for r in telemetry.spans() if r["name"] == "stage"]

    def test_trace_id_reaches_prefetch_worker_records(self):
        with flox_tpu_torch.set_options(telemetry=True, telemetry_level="detailed",
                                        stream_prefetch=2):
            with telemetry.trace("req-7"):
                _stream()
        stage = [r for r in telemetry.spans() if r["name"] == "stage"]
        assert stage and all(r.get("trace") == "req-7" for r in stage)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class TestMetrics:
    def test_reset_clears_metrics_registry(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
        assert telemetry.METRICS.snapshot()
        telemetry.reset()
        assert telemetry.METRICS.snapshot() == {}

    def test_h2d_bytes_counted_by_stager(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _stream()
        assert telemetry.METRICS.get("bytes.h2d") >= 2 * 64 * 8

    def test_retry_counter_and_event(self):
        from flox_tpu_torch.resilience import RetryPolicy, call_with_retry

        attempts = {"n": 0}

        def flaky():
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise OSError("transient hiccup")
            return "ok"

        with flox_tpu_torch.set_options(telemetry=True):
            out = call_with_retry(flaky, policy=RetryPolicy(retries=5, backoff=0.0),
                                  what="[0:8)")
        assert out == "ok"
        assert telemetry.METRICS.get("stream.retries") == 2
        events = [r for r in telemetry.spans() if r["type"] == "event"]
        assert [e["name"] for e in events] == ["retry", "retry"]
        assert events[0]["attrs"] == {"what": "[0:8)", "attempt": 1, "delay_ms": 0.0,
                                      "error": "OSError"}

    def test_split_checkpoint_and_resume_counters(self):
        from flox_tpu_torch import faults

        with flox_tpu_torch.set_options(telemetry=True, stream_checkpoint_every=1):
            with faults.inject(oom_at=[16]):
                _stream()
            with faults.inject(kill_at=[32]):
                with pytest.raises(faults.StreamKilled):
                    _stream()
            _stream()
        snap = telemetry.METRICS.snapshot()
        assert snap["stream.oom_splits"] == 1
        assert snap["stream.checkpoints"] >= 4
        assert snap["stream.resumes"] == 1
        assert snap["bytes.d2h"] > 0
        names = {r["name"] for r in telemetry.spans() if r["type"] == "event"}
        assert {"oom-split", "checkpoint", "stream-resume"} <= names

    def test_profile_call_shape(self):
        profile = telemetry.profile_call(lambda: _run_reduce())
        assert set(profile) == {"h2d_bytes", "phase_ms"}
        assert "groupby_reduce" in profile["phase_ms"]
        assert profile["h2d_bytes"] > 0
        assert OPTIONS["telemetry"] is False

    def test_registry_is_threadsafe_counterwise(self):
        reg = telemetry.MetricsRegistry()

        def spin():
            for _ in range(1000):
                reg.inc("n")

        threads = [threading.Thread(target=spin) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert reg.get("n") == 4000

    def test_gauges(self):
        reg = telemetry.MetricsRegistry()
        reg.set_gauge("g", 2.0)
        reg.max_gauge("g", 1.0)
        assert reg.get("g") == 2.0
        reg.max_gauge("g", 5.0)
        assert reg.get("g") == 5.0


# ---------------------------------------------------------------------------
# exporters: emit -> parse -> report
# ---------------------------------------------------------------------------


class TestExporters:
    def _instrumented_records(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
        return telemetry.spans()

    def test_chrome_trace_roundtrip(self, tmp_path):
        records = self._instrumented_records()
        path = tmp_path / "trace.json"
        telemetry.export_chrome_trace(str(path), records)
        payload = json.loads(path.read_text())
        events = payload["traceEvents"]
        for ev in events:
            assert ev["ph"] in ("X", "i")
            assert "ts" in ev and "pid" in ev and "tid" in ev
            if ev["ph"] == "X":
                assert "dur" in ev
        names = {ev["name"] for ev in events}
        assert {"groupby_reduce", "factorize", "dispatch", "combine", "finalize"} <= names
        assert "floxTpuCounters" in payload

    def test_jsonl_roundtrip_and_report(self, tmp_path):
        records = self._instrumented_records()
        path = tmp_path / "trace.jsonl"
        telemetry.export_jsonl(str(path), records)
        parsed, counters = telemetry._load_export(str(path))
        assert {r["name"] for r in parsed} == {r["name"] for r in records}
        assert counters == telemetry.METRICS.snapshot()
        text = "\n".join(telemetry._report_lines(str(path)))
        assert "factorize" in text and "dispatch" in text and "bytes.h2d" in text

    def test_report_reads_both_formats_identically(self, tmp_path):
        records = self._instrumented_records()
        j, c = tmp_path / "t.jsonl", tmp_path / "t.json"
        telemetry.export_jsonl(str(j), records)
        telemetry.export_chrome_trace(str(c), records)
        rows_j = telemetry.summarize(telemetry._load_export(str(j))[0])
        rows_c = telemetry.summarize(telemetry._load_export(str(c))[0])
        assert [r["name"] for r in rows_j] == [r["name"] for r in rows_c]
        assert [r["count"] for r in rows_j] == [r["count"] for r in rows_c]

    def test_report_cli(self, tmp_path, capsys):
        path = tmp_path / "trace.json"
        telemetry.export_chrome_trace(str(path), self._instrumented_records())
        assert telemetry.main(["report", str(path)]) == 0
        out = capsys.readouterr().out
        assert "groupby_reduce" in out and "counters/gauges" in out

    def test_report_cli_module_entry(self, tmp_path):
        path = tmp_path / "trace.jsonl"
        telemetry.export_jsonl(str(path), self._instrumented_records())
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, "-m", "flox_tpu_torch.telemetry", "report",
                               str(path)], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "groupby_reduce" in proc.stdout

    def test_export_path_jsonl_streams_incrementally(self, tmp_path):
        path = tmp_path / "stream.jsonl"
        with flox_tpu_torch.set_options(telemetry=True, telemetry_export_path=str(path)):
            _run_reduce()
            telemetry.flush()
        lines = [json.loads(line) for line in path.read_text().splitlines() if line]
        assert any(r.get("name") == "groupby_reduce" for r in lines)
        assert lines[-1]["type"] == "counters"
        assert telemetry.spans() == []

    def test_export_path_chrome_written_on_flush(self, tmp_path):
        path = tmp_path / "trace.json"
        with flox_tpu_torch.set_options(telemetry=True, telemetry_export_path=str(path)):
            _run_reduce()
            telemetry.flush()
        payload = json.loads(path.read_text())
        assert payload["traceEvents"]
        assert payload["floxTpuCounters"].get("bytes.h2d", 0) > 0

    def test_report_cli_rejects_garbage(self, tmp_path):
        bad = tmp_path / "not-a-trace.json"
        bad.write_text("{definitely not json")
        with pytest.raises(SystemExit):
            telemetry.main(["report", str(bad)])


# ---------------------------------------------------------------------------
# option validation
# ---------------------------------------------------------------------------


class TestOptions:
    def test_validated_at_set_time(self):
        for bad in ({"telemetry": 1}, {"telemetry_level": "verbose"},
                    {"telemetry_export_path": ""}, {"flight_recorder_size": 8},
                    {"profile_keep": 0}, {"metrics_sample_interval": -1.0},
                    {"replica_id": "bad id"}, {"costmodel": "yes"},
                    {"costmodel_drift_threshold": 0.5}, {"costmodel_overhead_ms": -1.0}):
            with pytest.raises(ValueError):
                flox_tpu_torch.set_options(**bad)

    def test_context_manager_restores(self):
        before = OPTIONS["telemetry"]
        with flox_tpu_torch.set_options(telemetry=True):
            assert OPTIONS["telemetry"] is True
        assert OPTIONS["telemetry"] is before

    def test_defaults_are_the_reference_defaults(self):
        keys = ("telemetry_level", "flight_recorder_size", "profile_keep",
                "metrics_sample_interval", "costmodel_drift_threshold",
                "costmodel_overhead_ms")
        env = {k: v for k, v in os.environ.items() if not k.startswith("FLOX_TPU_")}
        code = ("import json, flox_tpu_torch.options as o; "
                f"print(json.dumps({{k: o.OPTIONS[k] for k in {keys!r}}}))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=dict(env, PYTHONPATH=str(REPO)), capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        port = json.loads(proc.stdout)
        assert port == {"telemetry_level": "basic", "flight_recorder_size": 2048,
                        "profile_keep": 8, "metrics_sample_interval": 0.0,
                        "costmodel_drift_threshold": 10.0, "costmodel_overhead_ms": 25.0}

    def test_environment_names(self, tmp_path):
        env = dict(os.environ, PYTHONPATH=str(REPO), FLOX_TPU_TELEMETRY="1",
                   FLOX_TPU_TELEMETRY_LEVEL="detailed", FLOX_TPU_COSTMODEL="1",
                   FLOX_TPU_FLIGHT_RECORDER_SIZE="4",  # out of range: the default
                   FLOX_TPU_PROFILE_DIR=str(tmp_path), FLOX_TPU_REPLICA_ID="r-1")
        code = ("import json, flox_tpu_torch.options as o; print(json.dumps({k: o.OPTIONS[k] "
                "for k in ('telemetry', 'telemetry_level', 'costmodel', "
                "'flight_recorder_size', 'profile_dir', 'replica_id')}))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout) == {
            "telemetry": True, "telemetry_level": "detailed", "costmodel": True,
            "flight_recorder_size": 2048, "profile_dir": str(tmp_path), "replica_id": "r-1"}

    def test_from_reference_carries_the_keys(self):
        from flox_tpu_torch.options import from_reference

        from flox_tpu.options import OPTIONS as REF_OPTIONS

        ref = dict(REF_OPTIONS)
        ref.update(telemetry=True, telemetry_level="detailed", costmodel=True,
                   flight_recorder_size=64, profile_keep=3, replica_id="a1")
        got = from_reference(ref)
        for key in ("telemetry", "telemetry_level", "telemetry_export_path",
                    "flight_recorder_path", "flight_recorder_size", "profile_dir",
                    "profile_keep", "metrics_sample_interval", "replica_id", "costmodel",
                    "costmodel_drift_threshold", "costmodel_overhead_ms"):
            assert got[key] == ref[key], key


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


class TestHistograms:
    def test_observe_and_percentile(self):
        reg = telemetry.MetricsRegistry()
        for v in (1.0, 1.0, 1.0, 1.0, 100.0):
            reg.observe("lat_ms", v)
        hist = reg.histograms()["lat_ms"]
        assert hist["count"] == 5 and hist["sum"] == pytest.approx(104.0)
        assert hist["min"] == 1.0 and hist["max"] == 100.0
        assert 0.5 <= reg.percentile("lat_ms", 0.50) <= 2.1
        assert reg.percentile("lat_ms", 0.99) == pytest.approx(100.0)
        assert reg.percentile("lat_ms", 0.0) == 1.0
        assert reg.percentile("unknown", 0.5) is None

    def test_reset_clears_histograms(self):
        telemetry.METRICS.observe("lat_ms", 5.0)
        telemetry.reset()
        assert telemetry.METRICS.histograms() == {}

    def test_spans_feed_histograms_when_enabled(self):
        with flox_tpu_torch.set_options(telemetry=True):
            with telemetry.span("phasex"):
                pass
        assert telemetry.METRICS.histograms()["span_ms.phasex"]["count"] == 1

    def test_disabled_spans_leave_histograms_untouched(self):
        with telemetry.span("phasex"):
            pass
        assert telemetry.METRICS.histograms() == {}

    def test_exports_carry_histograms_both_formats(self, tmp_path):
        with flox_tpu_torch.set_options(telemetry=True):
            with telemetry.span("phasex"):
                pass
            j, c = tmp_path / "t.jsonl", tmp_path / "t.json"
            telemetry.export_jsonl(str(j))
            telemetry.export_chrome_trace(str(c))
        payload = json.loads(c.read_text())
        assert "span_ms.phasex" in payload["floxTpuHistograms"]
        assert payload["floxTpuHistEdgesMs"] == list(telemetry.HIST_EDGES_MS)
        assert telemetry._parse_export(str(j))[2]["span_ms.phasex"]["count"] == 1

    def test_report_cli_histograms_flag(self, tmp_path, capsys):
        with flox_tpu_torch.set_options(telemetry=True):
            with telemetry.span("phasex"):
                pass
            path = tmp_path / "t.jsonl"
            telemetry.export_jsonl(str(path))
        assert telemetry.main(["report", str(path), "--histograms"]) == 0
        out = capsys.readouterr().out
        assert "span_ms.phasex" in out and "p50 ms" in out and "p99 ms" in out

    def test_report_cli_rejects_malformed_jsonl_line(self, tmp_path, capsys):
        path = tmp_path / "t.jsonl"
        path.write_text('{"type": "span", "name": "ok", "dur_us": 1.0}\n{broken json line\n')
        with pytest.raises(SystemExit) as exc_info:
            telemetry.main(["report", str(path)])
        assert exc_info.value.code != 0
        assert ":2:" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00 ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "garbage", None, 17,
])
def test_traceparent_parse_matches_reference(header):
    assert telemetry.parse_traceparent(header) == ref_telemetry.parse_traceparent(header)


@pytest.mark.parametrize("trace_id", ["req-1", "4bf92f3577b34da6a3ce929d0e0e4736", 12345,
                                      "0" * 32])
def test_traceparent_format_matches_reference(trace_id):
    span_id = "00f067aa0ba902b7"
    assert (telemetry.format_traceparent(trace_id, span_id)
            == ref_telemetry.format_traceparent(trace_id, span_id))


def test_histogram_buckets_and_percentiles_match_reference():
    values = np.concatenate([RNG.lognormal(0.0, 3.0, size=500), [0.0, 1e-4, 1e9]])
    assert telemetry.HIST_EDGES_MS == ref_telemetry.HIST_EDGES_MS
    assert [telemetry._hist_bucket(v) for v in values] == [
        ref_telemetry._hist_bucket(v) for v in values]
    ours, theirs = telemetry.MetricsRegistry(), ref_telemetry.MetricsRegistry()
    for v in values:
        ours.observe("h", float(v), exemplar="t")
        theirs.observe("h", float(v), exemplar="t")
    assert ours.histograms() == theirs.histograms()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.percentile("h", q) == theirs.percentile("h", q)


def test_tenant_label_matches_reference():
    tags = ["acme", 'evil|le=5"x', "", "x" * 200, 42, "a b/c"] + [f"t{i}" for i in range(70)]
    with flox_tpu_torch.set_options(telemetry=True), flox_tpu.set_options(telemetry=True):
        ref_telemetry.reset()
        try:
            assert [telemetry.tenant_label(t) for t in tags] == [
                ref_telemetry.tenant_label(t) for t in tags]
            assert telemetry.tenant_label("__canary__") == ref_telemetry.tenant_label("__canary__")
        finally:
            ref_telemetry.reset()


def _synthetic_records():
    return [
        {"type": "span", "name": "p", "id": i, "parent": None, "tid": 7, "ts_us": 10.0 * i,
         "dur_us": d * 1e3, "attrs": {"k": i}, **({"trace": f"r{i}"} if i % 2 else {})}
        for i, d in enumerate((1.0, 2.0, 3.0, 4.0, 100.0, 0.5))
    ] + [{"type": "event", "name": "e", "id": 99, "parent": None, "tid": 8, "ts_us": 5.0,
          "attrs": {"x": 1}, "trace": "r1"}]


def test_summarize_matches_reference():
    records = _synthetic_records()
    assert telemetry.summarize(records) == ref_telemetry.summarize(records)


def test_chrome_trace_layout_matches_reference():
    records = _synthetic_records()
    assert (telemetry.to_chrome_trace(records)["traceEvents"]
            == ref_telemetry.to_chrome_trace(records)["traceEvents"])
    assert set(telemetry.to_chrome_trace(records)) == set(ref_telemetry.to_chrome_trace(records))


def test_metric_names_match_reference():
    from flox_tpu import metric_names as ref_names
    from flox_tpu_torch import metric_names

    def constants(mod):
        return {k: v for k, v in vars(mod).items() if k.isupper() and isinstance(v, str)}

    assert constants(metric_names) == constants(ref_names)
    for name in constants(ref_names).values():
        for counter in (False, True):
            assert (metric_names.prom_name(name, counter=counter)
                    == ref_names.prom_name(name, counter=counter))


#: the reference's counters with no counterpart in the port: its jax compile
#: listener, its program caches, and the trace of its card analysis compile
_REF_ONLY_PREFIXES = ("jax.", "cache.")
_REF_ONLY = {"costmodel.card_traces", "costmodel.card_compiles", "costmodel.card_compile_ms"}
#: the port's spans below the reference's phases, which the reference has no
#: counterpart of: the kernel wrappers' steps and the mesh program's run
_PORT_ONLY_SPANS = frozenset({"bins", "launch", "legs", "program", "collective"})


@contextlib.contextmanager
def _plane_on(package):
    """Telemetry and cost cards on for ``package``: for the reference, in
    every option dict its modules may read (``flox_tpu.costmodel`` bound
    ``OPTIONS`` at import, while ``set_options`` writes
    ``flox_tpu.options.OPTIONS``, which a reload of that module, as one of
    the reference's option tests does, replaces with another dict)."""
    if package is not flox_tpu:
        with package.set_options(telemetry=True, costmodel=True):
            yield
        return
    dicts = {id(m.OPTIONS): m.OPTIONS for name, m in list(sys.modules.items())
             if name.startswith("flox_tpu.") and isinstance(getattr(m, "OPTIONS", None), dict)}
    saved = [(d, {k: dict.get(d, k) for k in ("telemetry", "costmodel")}) for d in dicts.values()]
    try:
        for d, _ in saved:
            d.update(telemetry=True, costmodel=True)
        yield
    finally:
        for d, old in saved:
            d.update(old)


def _names(mod, package, call):
    """Span names (with their attribute names) and counter names of one
    instrumented call of ``package``."""
    mod.reset()
    with _plane_on(package):
        call()
    recs = mod.drain()
    spans = sorted((r["name"], tuple(sorted(r["attrs"]))) for r in recs if r["type"] == "span")
    counters = {k for k in mod.METRICS.counters()
                if not k.startswith(_REF_ONLY_PREFIXES) and k not in _REF_ONLY}
    mod.reset()
    return spans, counters


@pytest.mark.parametrize("call", ["reduce", "many", "stream", "mesh"])
def test_span_and_counter_names_match_reference(call):
    from flox_tpu.parallel import make_mesh as ref_make_mesh
    from flox_tpu_torch.parallel import make_mesh

    vals = np.random.default_rng(3).normal(size=(4, 730)).astype(np.float32)
    labels = (np.arange(730) // 61) % 12
    trio = ("nanmean", "nanmin", "nanmax")
    ref_calls = {
        "reduce": lambda: flox_tpu.groupby_reduce(vals, labels, func="nanmean", engine="jax"),
        "many": lambda: flox_tpu.groupby_aggregate_many(vals, labels, funcs=trio, engine="jax"),
        "stream": lambda: flox_tpu.streaming_groupby_reduce(vals, labels, func="nanmean",
                                                            batch_len=200),
        "mesh": lambda: flox_tpu.groupby_reduce(vals, labels, func="nanmean",
                                                method="map-reduce", mesh=ref_make_mesh(4)),
    }
    port_calls = {
        "reduce": lambda: flox_tpu_torch.groupby_reduce(vals, labels, func="nanmean",
                                                        device="cpu"),
        "many": lambda: flox_tpu_torch.groupby_aggregate_many(vals, labels, funcs=trio,
                                                              device="cpu"),
        "stream": lambda: flox_tpu_torch.streaming_groupby_reduce(vals, labels, func="nanmean",
                                                                  batch_len=200, device="cpu"),
        "mesh": lambda: flox_tpu_torch.groupby_reduce(vals, labels, func="nanmean",
                                                      method="map-reduce",
                                                      mesh=make_mesh(device_type="cpu")),
    }
    ref_spans, ref_counters = _names(ref_telemetry, flox_tpu, ref_calls[call])
    port_spans, port_counters = _names(telemetry, flox_tpu_torch, port_calls[call])
    assert [s for s in port_spans if s[0] not in _PORT_ONLY_SPANS] == ref_spans
    assert "legs" in {s[0] for s in port_spans}  # the post-kernel passes, on every path
    assert port_counters == ref_counters


def test_observability_modules_import_without_jax():
    code = (
        "import sys\n"
        "import flox_tpu_torch.telemetry, flox_tpu_torch.costmodel, flox_tpu_torch.profiling\n"
        "import flox_tpu_torch.metric_names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flox_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
