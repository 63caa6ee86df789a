"""The port's observability base (flight recorder, device-memory accounting,
cost ledger, on-demand capture, cost cards, roofline join and drift
sentinel) against tests/test_observability.py's cases that need no serve
plane, on the CPU.

The CPU has no peak row in ``costmodel.PEAK_TABLE`` (its cards say
``analysis: "unavailable"``, as the reference degrades), so the card tests
inject one. The profiler of the capture tests is a fake, as in the
reference's tests. ``drift_report``, ``predicted_ms`` and ``_utilization``
are held against the reference's on the same rows. Device time from CUDA
events is tested on the card only, in tests/test_torch_cuda_streaming.py.
"""

from __future__ import annotations

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401 - tests/conftest.py configures it for the reference

from flox_tpu import costmodel as ref_costmodel
import flox_tpu_torch
from flox_tpu_torch import costmodel, faults, profiling, telemetry

RNG = np.random.default_rng(7)
CPU_PEAKS = {"bw_gbps": 20.0, "gflops": 100.0}


@pytest.fixture(autouse=True)
def _clean_plane():
    with flox_tpu_torch.set_options(telemetry=False, telemetry_export_path=None,
                                    flight_recorder_path=None, costmodel=False):
        telemetry.reset()
        yield
        telemetry.reset()


@pytest.fixture
def cpu_peaks(monkeypatch):
    monkeypatch.setitem(costmodel.PEAK_TABLE, "cpu", dict(CPU_PEAKS))


def _plane(**extra):
    return flox_tpu_torch.set_options(telemetry=True, costmodel=True, **extra)


def _run_reduce(dtype=np.float64, **kw):
    vals = np.random.default_rng(0).normal(size=(3, 48)).astype(dtype)
    codes = np.arange(48) % 5
    return flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device="cpu", **kw)


# ---------------------------------------------------------------------------
# device memory: a no-op on the CPU, attribution through the ledger
# ---------------------------------------------------------------------------


class TestHbmAccounting:
    def test_memory_stats_absent_on_the_cpu(self):
        from flox_tpu_torch import device

        if not torch.cuda.is_available():
            assert device.memory_stats() is None
        with flox_tpu_torch.set_options(telemetry=True):
            telemetry.sample_hbm(program="p")
            telemetry.seed_hbm_limit()
        assert "hbm.bytes_in_use" not in telemetry.METRICS.gauges() or torch.cuda.is_available()

    def test_fake_memory_stats_feed_gauges_and_attribution(self, monkeypatch):
        from flox_tpu_torch import device

        feed = iter([
            {"bytes_in_use": 1000, "peak_bytes_in_use": 1500},
            {"bytes_in_use": 800, "peak_bytes_in_use": 1500},
            {"bytes_in_use": 2000, "peak_bytes_in_use": 2500, "bytes_limit": 80 * 2**30},
        ])
        last = {"bytes_in_use": 500, "peak_bytes_in_use": 2500}
        monkeypatch.setattr(device, "memory_stats", lambda devices=None: next(feed, last))
        with flox_tpu_torch.set_options(telemetry=True):
            telemetry.sample_hbm(program="prog-a")
            telemetry.sample_hbm(program="prog-a")
            telemetry.sample_hbm(program="prog-b")
            telemetry.sample_hbm()
        assert telemetry.METRICS.get("hbm.bytes_in_use") == 500
        assert telemetry.METRICS.get("hbm.peak_bytes_in_use") == 2500
        assert telemetry.METRICS.get("hbm.bytes_limit") == 80 * 2**30
        assert telemetry.hbm_by_program() == {"prog-a": 1000.0, "prog-b": 2000.0}
        telemetry.reset()
        assert telemetry.hbm_by_program() == {}

    def test_dispatch_paths_attribute_programs(self, monkeypatch):
        from flox_tpu_torch import device

        monkeypatch.setattr(device, "memory_stats",
                            lambda devices=None: {"bytes_in_use": 4096, "peak_bytes_in_use": 8192})
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
        assert telemetry.hbm_by_program() == {"bundle[nanmean]": 4096.0}

    def test_disabled_sampling_is_untouched(self, monkeypatch):
        from flox_tpu_torch import device

        def boom(devices=None):  # pragma: no cover - must never run
            raise AssertionError("memory_stats consulted while disabled")

        monkeypatch.setattr(device, "memory_stats", boom)
        telemetry.sample_hbm(program="nope")
        assert telemetry.METRICS.snapshot() == {}
        assert telemetry.hbm_by_program() == {}

    def test_saturation_sampler_publishes_prefetch_occupancy(self):
        with flox_tpu_torch.set_options(telemetry=True):
            telemetry.seed_saturation_gauges()
            telemetry.sample_saturation()
            assert telemetry.start_saturation_sampler(0.01)
            telemetry.stop_saturation_sampler()
        gauges = telemetry.METRICS.gauges()
        assert set(telemetry.SATURATION_GAUGES) <= set(gauges)
        assert gauges["stream.prefetch_occupancy"] == 0


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_ring_is_bounded(self):
        with flox_tpu_torch.set_options(telemetry=True, flight_recorder_size=16):
            for i in range(64):
                telemetry.event("tick", i=i)
            records = telemetry.FLIGHT_RECORDER.records()
        assert len(records) == 16
        assert records[-1]["attrs"]["i"] == 63

    def test_dump_on_fatal_fault_roundtrips_through_report(self, tmp_path, capsys):
        from flox_tpu_torch.resilience import RetryPolicy, call_with_retry

        dump = tmp_path / "flight.jsonl"
        with flox_tpu_torch.set_options(telemetry=True, flight_recorder_path=str(dump)):
            _run_reduce()

            def fatal():
                raise ValueError("programming error")

            with pytest.raises(ValueError, match="programming error"):
                call_with_retry(fatal, policy=RetryPolicy(retries=3, backoff=0.0))
        parsed = [json.loads(line) for line in dump.read_text().splitlines()]
        header = parsed[0]
        assert header["name"] == "flight-recorder"
        assert header["attrs"]["reason"].startswith("fatal:ValueError")
        # the serve plane's breaker panel and the SLO plane's alert state,
        # empty in a process that served nothing (the reference's shapes)
        assert header["attrs"]["breakers"] == {"total": 0, "open": 0, "half_open": 0,
                                               "tripped": {}}
        assert header["attrs"]["alerts"] == {"firing": [], "pending": [], "resolved": []}
        names = {r.get("name") for r in parsed}
        assert {"groupby_reduce", "fatal"} <= names
        assert parsed[-1]["type"] == "counters"
        assert telemetry.main(["report", str(dump)]) == 0
        assert "groupby_reduce" in capsys.readouterr().out

    def test_fatal_stream_step_dumps(self, tmp_path):
        dump = tmp_path / "flight.jsonl"
        vals = np.random.default_rng(1).normal(size=(2, 64))

        def loader(s, e):
            if s >= 32:
                raise ValueError("corrupt block")
            return vals[:, s:e]

        with flox_tpu_torch.set_options(telemetry=True, flight_recorder_path=str(dump)):
            with pytest.raises(ValueError, match="corrupt block"):
                flox_tpu_torch.streaming_groupby_reduce(loader, np.arange(64) % 4,
                                                        func="nansum", batch_len=16,
                                                        device="cpu")
        header = json.loads(dump.read_text().splitlines()[0])
        assert header["attrs"]["reason"].startswith("fatal:ValueError")

    def test_transient_fault_does_not_dump(self, tmp_path):
        from flox_tpu_torch.resilience import RetryPolicy, call_with_retry

        dump = tmp_path / "flight.jsonl"
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 2:
                raise OSError("transient hiccup")
            return "ok"

        with flox_tpu_torch.set_options(telemetry=True, flight_recorder_path=str(dump)):
            assert call_with_retry(flaky, policy=RetryPolicy(retries=3, backoff=0.0)) == "ok"
        assert not dump.exists()

    def test_dump_on_signal(self, tmp_path):
        if not hasattr(signal, "SIGUSR2"):
            pytest.skip("no SIGUSR2 on this platform")
        dump = tmp_path / "flight-signal.jsonl"
        previous = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR2)}
        try:
            with flox_tpu_torch.set_options(telemetry=True, flight_recorder_path=str(dump)):
                telemetry.event("before-signal")
                telemetry.install_signal_dumps()
                os.kill(os.getpid(), signal.SIGUSR2)
            parsed = [json.loads(line) for line in dump.read_text().splitlines()]
            assert parsed[0]["attrs"]["reason"] == "signal:SIGUSR2"
            assert any(r.get("name") == "before-signal" for r in parsed)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def test_unconfigured_dump_is_noop(self):
        with flox_tpu_torch.set_options(telemetry=True):
            telemetry.event("something")
            assert telemetry.flight_dump(reason="no path") is None


# ---------------------------------------------------------------------------
# the cost ledger
# ---------------------------------------------------------------------------


class TestCostLedger:
    def test_eager_dispatch_feeds_program_ledger(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
            _run_reduce()
        row = telemetry.cost_by_program()["bundle[nanmean]"]
        assert row["dispatches"] == 2
        assert row["device_ms"] > 0
        assert row["device_ms_max"] <= row["device_ms"]
        assert row["bytes"] == 2 * (3 * 48 * 8 + 48 * 8)
        assert row["compiles"] == 0  # the port compiles nothing
        telemetry.reset()
        assert telemetry.cost_by_program() == {}

    def test_mesh_fused_and_streaming_dispatches_attributed(self):
        from flox_tpu_torch.parallel import make_mesh

        n = 512
        labels = RNG.integers(0, 5, n)
        vals = RNG.normal(size=n)
        with flox_tpu_torch.set_options(telemetry=True):
            flox_tpu_torch.groupby_reduce(vals, labels, func="sum", method="map-reduce",
                                          mesh=make_mesh(device_type="cpu"))
            flox_tpu_torch.streaming_groupby_reduce(vals, labels, func="sum", batch_len=128,
                                                    device="cpu")
            flox_tpu_torch.groupby_aggregate_many(vals, labels, funcs=("sum", "max"),
                                                  device="cpu")
        costs = telemetry.cost_by_program()
        assert set(costs) == {"mesh[sum/map-reduce]", "stream[reduce[sum]]", "fused[sum+max]"}
        assert costs["stream[reduce[sum]]"]["bytes"] == vals.nbytes  # the staged slabs

    def test_slow_trace_id_lands_in_ledger(self):
        with flox_tpu_torch.set_options(telemetry=True):
            with telemetry.trace("req-slowest"):
                _run_reduce()
        assert telemetry.cost_by_program()["bundle[nanmean]"]["last_slow_trace"] == "req-slowest"

    def test_hbm_peak_absorbed_into_ledger(self, monkeypatch):
        from flox_tpu_torch import device

        monkeypatch.setattr(device, "memory_stats",
                            lambda devices=None: {"bytes_in_use": 4096, "peak_bytes_in_use": 8192})
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
        assert telemetry.cost_by_program()["bundle[nanmean]"]["hbm_peak"] == 4096

    def test_disabled_path_records_nothing(self):
        telemetry.observe_cost("nope", device_ms=1.0, nbytes=10)
        assert telemetry.cost_by_program() == {}
        assert telemetry.cost_by_tenant() == {}

    def test_tenant_and_dataset_axes(self):
        with flox_tpu_torch.set_options(telemetry=True):
            telemetry.observe_cost("p", tenant=telemetry.tenant_label("acme"), dataset="d1",
                                   device_ms=2.0, nbytes=10)
            telemetry.observe_cost("p", tenant=telemetry.CANARY_TENANT, device_ms=1.0)
        assert telemetry.cost_by_tenant()["acme"]["device_ms"] == 2.0
        assert telemetry.CANARY_TENANT not in telemetry.cost_by_tenant()
        assert telemetry.CANARY_TENANT in telemetry.cost_by_tenant(include_canary=True)
        assert telemetry.cost_by_dataset()["d1"]["bytes"] == 10
        assert telemetry.cost_by_program()["p"]["dispatches"] == 2

    def test_tenant_cardinality_is_bounded(self):
        with flox_tpu_torch.set_options(telemetry=True):
            for i in range(telemetry._TENANT_MAX + 5):
                assert telemetry.tenant_label(f"t{i}") == (
                    f"t{i}" if i < telemetry._TENANT_MAX else "_other")
            assert telemetry.tenant_label("t0") == "t0"
        telemetry.reset()
        assert telemetry.tenant_label("fresh") == "fresh"

    def test_costs_cli_live_and_file(self, tmp_path, capsys):
        with flox_tpu_torch.set_options(telemetry=True):
            _run_reduce()
        assert telemetry.main(["costs"]) == 0
        out = capsys.readouterr().out
        assert "bundle[" in out and "program key" in out
        scrape = tmp_path / "costs.json"
        scrape.write_text(json.dumps({"cost_by_program": telemetry.cost_by_program(),
                                      "cost_by_tenant": telemetry.cost_by_tenant()}))
        assert telemetry.main(["costs", str(scrape), "--top", "1"]) == 0
        assert "bundle[" in capsys.readouterr().out

    def test_costs_cli_rejects_garbage(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text("not json")
        with pytest.raises(SystemExit):
            telemetry.main(["costs", str(bad)])


# ---------------------------------------------------------------------------
# on-demand capture
# ---------------------------------------------------------------------------


class _FakeProfiler:
    """A stand-in for ``torch.profiler.profile`` that records its calls."""

    def __init__(self, fail_start=False):
        self.fail_start = fail_start
        self.starts = 0
        self.stops = 0
        self.exports: list[str] = []

    def install(self, monkeypatch):
        monkeypatch.setattr(profiling, "_profiler", lambda activities=None: self)
        return self

    def start(self):
        if self.fail_start:
            raise RuntimeError("no profiler here")
        self.starts += 1

    def stop(self):
        self.stops += 1

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)
        self.exports.append(path)


def _wait_idle():
    for _ in range(250):
        if profiling.capture_active() is None:
            return
        time.sleep(0.02)
    raise AssertionError("the capture never finished")


class TestOnDemandCapture:
    @pytest.fixture(autouse=True)
    def _fresh_capture_state(self):
        profiling._CAPTURE_STATE.clear()
        yield
        profiling._CAPTURE_STATE.clear()

    def test_unconfigured_root_is_unavailable(self):
        with pytest.raises(profiling.CaptureUnavailableError):
            profiling.start_capture(seconds=0.05)

    def test_bad_window_is_refused(self, tmp_path):
        with pytest.raises(ValueError):
            profiling.start_capture(seconds=0, root=str(tmp_path))

    def test_capture_runs_and_guard_clears(self, tmp_path, monkeypatch):
        fake = _FakeProfiler().install(monkeypatch)
        with flox_tpu_torch.set_options(telemetry=True, profile_dir=str(tmp_path)):
            capture_dir = profiling.start_capture(seconds=0.05)
            assert capture_dir.startswith(str(tmp_path))
            assert profiling.capture_active()["dir"] == capture_dir
            with pytest.raises(profiling.CaptureBusyError):
                profiling.start_capture(seconds=0.05)
            _wait_idle()
        assert (fake.starts, fake.stops) == (1, 1)
        assert fake.exports == [os.path.join(capture_dir, "trace.json")]
        assert telemetry.METRICS.get("profile.captures") == 1
        assert telemetry.METRICS.get("profile.capture_starts") == 1

    def test_profiler_that_cannot_start_is_unavailable(self, tmp_path, monkeypatch):
        _FakeProfiler(fail_start=True).install(monkeypatch)
        with flox_tpu_torch.set_options(profile_dir=str(tmp_path)):
            with pytest.raises(profiling.CaptureUnavailableError):
                profiling.start_capture(seconds=0.05)
        assert profiling.capture_active() is None

    def test_capture_dir_rotation(self, tmp_path, monkeypatch):
        _FakeProfiler().install(monkeypatch)
        with flox_tpu_torch.set_options(profile_dir=str(tmp_path), profile_keep=2):
            for _ in range(4):
                profiling.start_capture(seconds=0.01)
                _wait_idle()
        assert len([p for p in tmp_path.iterdir() if p.name.startswith("capture-")]) <= 2

    def test_trace_defaults_to_profile_dir_and_warns_without_profiler(
            self, tmp_path, monkeypatch, caplog):
        import logging

        with pytest.raises(ValueError, match="profile_dir"):
            with profiling.trace():
                pass
        fake = _FakeProfiler().install(monkeypatch)
        with flox_tpu_torch.set_options(profile_dir=str(tmp_path)):
            with profiling.trace():
                pass
        assert fake.starts == 1 and len(fake.exports) == 1
        assert fake.exports[0].startswith(str(tmp_path))
        _FakeProfiler(fail_start=True).install(monkeypatch)
        ran = []
        with caplog.at_level(logging.WARNING, logger="flox_tpu_torch.profiling"):
            with profiling.trace(str(tmp_path)):
                ran.append(True)
        assert ran == [True]
        assert any("untraced" in r.message for r in caplog.records)

    def test_real_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path)):
            with profiling.annotate("flox-region"):
                _run_reduce()
        (path,) = list(tmp_path.glob("trace-*.json"))
        names = {ev.get("name") for ev in json.loads(path.read_text())["traceEvents"]}
        assert "flox-region" in names


class TestCaptureStamping:
    def test_capture_dir_stamped_with_window_programs(self, tmp_path, monkeypatch):
        profiling._CAPTURE_STATE.clear()
        _FakeProfiler().install(monkeypatch)
        with _plane(profile_dir=str(tmp_path)):
            _run_reduce()  # before the window: not stamped
            capture_dir = profiling.start_capture(seconds=0.3)
            _run_reduce()  # in the window: stamped
            _wait_idle()
        payload = json.loads(open(os.path.join(capture_dir, "programs.json")).read())
        assert payload["programs"]["bundle[nanmean]"]["dispatches"] == 1
        assert payload["programs"]["bundle[nanmean]"]["digest"]


# ---------------------------------------------------------------------------
# cost cards, the roofline join and the drift sentinel
# ---------------------------------------------------------------------------


class TestCostModelCards:
    def test_off_by_default_is_a_noop(self):
        with flox_tpu_torch.set_options(telemetry=True, costmodel=False):
            _run_reduce(np.float32)
        assert costmodel.cards() == {}
        assert not any(k.startswith("program.") for k in telemetry.METRICS.gauges())

    def test_cpu_without_a_peak_row_is_unavailable(self):
        with _plane():
            _run_reduce(np.float32)
        card = costmodel.card_for("bundle[nanmean]")
        assert card["analysis"].startswith("unavailable")
        assert card["predicted_ms"] == 0.0
        assert card["bytes_accessed"] > 0  # the declared work is there all the same

    def test_eager_card_holds_the_kernel_bound_bytes(self, cpu_peaks):
        k, n, size = 3, 48, 5
        with _plane():
            _run_reduce(np.float32)
        card = costmodel.card_for("bundle[nanmean]")
        assert card["analysis"] == "ok" and card["device"] == "cpu"
        # the segment-sum kernel's bound: (K, N) f32 read, (N,) int32 codes
        # read, four (size, K) f32 outputs written; two operations an element.
        # Then the mean finalize's: the four legs and the (size,) int32 row
        # counts read, the (K, size) f32 mean written; three operations an
        # element of a leg
        sum_bytes = k * n * 4 + n * 4 + 4 * size * k * 4
        fin_bytes = 4 * size * k * 4 + size * 4 + k * size * 4
        assert card["kernels"] == {
            "segment_sum": {"launches": 1, "bytes": sum_bytes, "flops": 2 * k * n},
            "mean_finalize": {"launches": 1, "bytes": fin_bytes, "flops": 3 * size * k}}
        assert card["bytes_accessed"] == sum_bytes + fin_bytes
        want = max(card["bytes_accessed"] / 20e9, card["flops"] / 100e9) * 1e3
        assert card["predicted_ms"] == pytest.approx(want, abs=1e-6)
        assert "torch ops" in card["covers"]

    def test_every_runtime_path_has_a_card(self, cpu_peaks):
        from flox_tpu_torch.parallel import make_mesh

        vals = RNG.normal(size=48).astype(np.float32)
        codes = np.arange(48) % 5
        with _plane():
            _run_reduce(np.float32)
            flox_tpu_torch.groupby_aggregate_many(vals, codes, funcs=("sum", "min", "max"),
                                                  device="cpu")
            flox_tpu_torch.streaming_groupby_reduce(vals, codes, func="sum", batch_len=16,
                                                    device="cpu")
            flox_tpu_torch.groupby_reduce(vals, codes, func="sum", method="map-reduce",
                                          mesh=make_mesh(device_type="cpu"))
        by_label = {c["label"]: c for c in costmodel.cards().values()}
        for label, kernel, launches in (("bundle[nanmean]", "segment_sum", 1),
                                        ("fused[sum+min+max]", "segment_multistat", 1),
                                        ("stream[reduce[sum]]", "segment_sum", 3),
                                        ("mesh[sum/map-reduce]", "segment_sum", 1)):
            card = by_label[label]
            assert card["analysis"] == "ok", (label, card)
            assert card["kernels"][kernel]["launches"] == launches, label
            assert card["flops"] > 0 and card["bytes_accessed"] > 0, label
        report = costmodel.program_report()["programs"]
        for label in by_label:
            assert report[label]["observed"] is not None, label

    def test_cards_memoized_per_signature(self, cpu_peaks):
        with _plane():
            _run_reduce(np.float32)
            _run_reduce(np.float32)
        assert len(costmodel.cards()) == 1
        assert telemetry.METRICS.get("costmodel.cards_recorded") == 1

    def test_reset_drops_the_registry(self, cpu_peaks):
        with _plane():
            _run_reduce(np.float32)
        assert costmodel.cards()
        telemetry.reset()
        assert costmodel.cards() == {} and costmodel.card_for("bundle[nanmean]") is None

    def test_full_plane_bit_identity(self, cpu_peaks):
        from flox_tpu_torch.parallel import make_mesh

        vals = RNG.normal(size=(3, 48)).astype(np.float32)
        codes = np.arange(48) % 5

        def run_all():
            out = {}
            out["eager"] = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean",
                                                         device="cpu")[0]
            out["mesh"] = flox_tpu_torch.groupby_reduce(vals, codes, func="sum",
                                                        method="map-reduce",
                                                        mesh=make_mesh(device_type="cpu"))[0]
            out["stream"] = flox_tpu_torch.streaming_groupby_reduce(
                vals[0], codes, func="sum", batch_len=16, device="cpu")[0]
            fused = flox_tpu_torch.groupby_aggregate_many(vals[0], codes, funcs=("sum", "max"),
                                                          device="cpu")[0]
            out.update({f"fused[{k}]": v for k, v in fused.items()})
            return {k: v.numpy().tobytes() for k, v in out.items()}

        baseline = run_all()
        with _plane():
            assert run_all() == baseline


class TestRooflineJoin:
    def test_gauges_published(self, cpu_peaks):
        with _plane():
            _run_reduce(np.float32)
        gauges = telemetry.METRICS.gauges()
        assert "program.utilization|program=bundle[nanmean]" in gauges
        assert gauges["program.predicted_ms|program=bundle[nanmean]"] > 0

    def test_utilization_is_model_over_observed(self, cpu_peaks):
        with _plane():
            _run_reduce(np.float32)
        row = costmodel.program_report()["programs"]["bundle[nanmean]"]
        obs = row["observed"]
        expected = row["predicted_ms"] * obs["dispatches"] / obs["device_ms"]
        assert row["utilization"] == pytest.approx(expected, abs=1e-6)

    def test_program_report_filters(self, cpu_peaks):
        with _plane():
            _run_reduce(np.float32)
            flox_tpu_torch.streaming_groupby_reduce(
                RNG.normal(size=48).astype(np.float32), np.arange(48) % 5, func="sum",
                batch_len=16, device="cpu")
        full = costmodel.program_report()["programs"]
        assert len(full) >= 2
        assert set(costmodel.program_report(program="bundle[")["programs"]) == {
            k for k in full if "bundle[" in k}
        assert len(costmodel.program_report(top=1)["programs"]) == 1

    def test_programs_cli(self, cpu_peaks, capsys):
        with _plane():
            _run_reduce(np.float32)
            assert telemetry.main(["programs"]) == 0
            assert "bundle[nanmean]" in capsys.readouterr().out
            assert telemetry.main(["programs", "--drift"]) == 0


class TestDriftSentinel:
    def test_honest_run_is_clean(self, cpu_peaks):
        with _plane():
            _run_reduce(np.float32)
            _run_reduce(np.float32)
            report = costmodel.drift_report()
        assert report["flagged"] == []
        assert report["rows"]

    def test_injected_delay_flags_and_scrape_drift_matches(self, cpu_peaks):
        with _plane():
            _run_reduce(np.float32)
            with faults.dispatch_delay_inject("bundle[nanmean]", 0.5, times=1) as plan:
                _run_reduce(np.float32)
            assert plan.fired == 1
            assert costmodel.drift_report()["flagged"] == ["bundle[nanmean]"]
            rows = costmodel.program_report()["programs"]
            assert costmodel.drift_report(rows)["flagged"] == ["bundle[nanmean]"]

    def test_threshold_option_validated(self):
        for bad in ({"costmodel_drift_threshold": 0.5}, {"costmodel_overhead_ms": -1.0},
                    {"costmodel": "yes"}):
            with pytest.raises(ValueError):
                flox_tpu_torch.set_options(**bad)


def _rows():
    """Program rows as a /debug/programs scrape carries them."""
    rows = {}
    for i, (obs_ms, disp, pred) in enumerate([(10.0, 1, 0.5), (600.0, 2, 20.0),
                                              (30.0, 3, 40.0), (0.0, 0, 1.0),
                                              (2000.0, 5, 1.0)]):
        rows[f"p{i}"] = {"analysis": "ok", "predicted_ms": pred, "drift_ratio": None,
                         "observed": {"dispatches": disp, "device_ms": obs_ms, "compile_ms": 0.0}}
        if disp:
            model = max(pred, 25.0)
            rows[f"p{i}"].update(observed_ms_per_dispatch=obs_ms / disp, model_ms=model,
                                 drift_ratio=round(obs_ms / disp / model, 6))
    rows["bad"] = {"analysis": "unavailable:x", "drift_ratio": 99.0,
                   "observed": {"dispatches": 9}}
    return rows


def test_drift_report_matches_reference():
    ours = costmodel.drift_report(_rows(), threshold=3.0)
    theirs = ref_costmodel.drift_report(_rows(), threshold=3.0)
    assert ours == theirs
    assert ours["flagged"] == ["p1", "p4"]


def test_predicted_ms_and_utilization_match_reference(monkeypatch):
    monkeypatch.setitem(costmodel.PEAK_TABLE, "cpu", dict(CPU_PEAKS))
    assert ref_costmodel.PEAK_TABLE["cpu"] == {"bw_gbps": 20.0, "gflops": 100.0}
    for nbytes, flops in ((1e6, 1e3), (1e3, 1e9), (6_868_490_496, 3.4e9), (0.0, 0.0)):
        card = {"bytes_accessed": nbytes, "flops": flops, "predicted_ms": 3.0}
        assert costmodel.predicted_ms(card, "cpu") == ref_costmodel.predicted_ms(card, "cpu")
        for entry in ({"device_ms": 12.0, "dispatches": 4, "compile_ms": 0.0},
                      {"device_ms": 0.0, "dispatches": 1}, {"device_ms": 5.0, "dispatches": 0}):
            assert costmodel._utilization(entry, card) == ref_costmodel._utilization(entry, card)


def test_h100_row_gives_the_kernel_table_bound():
    """The month nanmean's card on the H100 row: the segment-sum kernel's
    declared bytes over 3.35 TB/s, 2.050 ms at 65160 x 26304 float32 over 12
    months, PERF.md's B1 bound."""
    k, n, size = 65160, 26304, 12
    card = {"device": "NVIDIA H100 80GB HBM3",
            "bytes_accessed": k * n * 4 + n * 4 + 4 * size * k * 4, "flops": 2 * k * n}
    assert round(costmodel.predicted_ms(card), 3) == 2.050
