"""The port's serve-plane fault domain (``flox_tpu_torch.serve``) under
deterministic injection (``faults.serve_inject``): the reference's
``tests/test_serve_chaos.py`` cases, every dispatcher on the CPU
(``Dispatcher(device="cpu")``, the serve loop with ``--device cpu``).

The contracts under test, each driven by ``faults.serve_inject``:

* **request quarantine** — a poisoned micro-batch member fails ALONE: the
  batch bisects on the power-of-two ladder, healthy peers get results
  bit-identical to solo runs, only the poisoned member sees the typed
  error;
* **per-program circuit breakers** — repeated fatal failures on one
  program key open its breaker: further identical-program submits
  fast-fail with ``CircuitOpenError`` (``code="circuit_open"`` +
  ``retry_after_ms``) WITHOUT a device dispatch (asserted on
  ``serve.dispatches``); after the cooldown a half-open probe closes it;
* **device-loss recovery** — an injected ``DEVICE_LOST`` fails in-flight
  waiters with ``DeviceLostError``, flips readiness to 503
  (``device-lost``), reinitializes the device layer, replays the warmup
  manifest, restages, flips readiness back — and the post-recovery warm
  dispatch builds no kernel library (``_build.BUILDS``);
* **dispatch watchdog** — a hung dispatch fails its waiters within the
  ``serve_watchdog_timeout`` budget instead of wedging the queue (the
  next request serves normally);
* **graceful drain** — SIGTERM during an in-flight request answers the
  request, emits the shutdown ack, flight-dumps, and exits 0 (subprocess
  smoke; ``{"op": "shutdown"}`` rides the same path);
* **quiescence** — with the whole fault domain enabled but no fault
  injected, results are bit-identical to direct library calls.
"""

from __future__ import annotations

import asyncio
import json
import os
import select
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import flox_tpu_torch
from flox_tpu_torch import _build, cache, exposition, faults
from flox_tpu_torch.serve import (
    CircuitOpenError,
    DeviceLostError,
    DrainingError,
    WatchdogTimeoutError,
    payload_digest,
)
from flox_tpu_torch.serve import Dispatcher as _Dispatcher
from flox_tpu_torch.telemetry import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def Dispatcher(**kw):
    return _Dispatcher(device="cpu", **kw)


def groupby_reduce(*a, **kw):
    out, groups = flox_tpu_torch.groupby_reduce(*a, device="cpu", **kw)
    return out.numpy(), groups


@pytest.fixture(autouse=True)
def _clean_state():
    """Serve/breaker state and counters reset per test; the warmup manifest
    off unless a test opts in."""
    with flox_tpu_torch.set_options(serve_aot_dir=None):
        cache.clear_all()
        exposition.set_ready(True)
        yield
        cache.clear_all()
        exposition.set_ready(False)
        from flox_tpu_torch.serve import aot

        aot.deconfigure()


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _payload(n=64, ngroups=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n), rng.integers(0, ngroups, size=n)


class TestQuarantine:
    def test_poisoned_member_fails_alone_peers_bit_identical(self):
        """Acceptance: one poisoned member inside a 4-leaf micro-batch gets
        the typed error; the 3 healthy peers' results are bit-identical to
        solo runs."""
        _, labels = _payload()
        payloads = [np.arange(64, dtype=np.float64) + 10 * i for i in range(4)]
        solo = [groupby_reduce(p, labels, func="sum")[0] for p in payloads]
        poisoned = 2

        async def main():
            d = Dispatcher(batch_window=0.05)
            with faults.serve_inject(
                poison_digests=[payload_digest(payloads[poisoned])]
            ) as plan:
                results = await asyncio.gather(
                    *[d.submit(func="sum", array=p, by=labels) for p in payloads],
                    return_exceptions=True,
                )
                await d.close()
            return results, list(plan.log)

        results, log = run(main())
        for i, (got, expect) in enumerate(zip(results, solo)):
            if i == poisoned:
                assert isinstance(got, faults.SimulatedCompileError), got
            else:
                assert not isinstance(got, Exception), got
                assert np.asarray(got.result).tobytes() == expect.tobytes()
        assert METRICS.get("serve.quarantine_splits") >= 1
        assert METRICS.get("serve.quarantined") == 1
        # the bisection is visible in the plan log: the poison fired for
        # every dispatch containing the member, healthy sub-batches ran
        assert sum(1 for kind, *_ in log if kind == "poison") >= 2
        # determinism: the same plan against the same submits replays
        results2, log2 = run(main())
        assert [type(r).__name__ for r in results2] == [
            type(r).__name__ for r in results
        ]
        assert [kind for kind, *_ in log2] == [kind for kind, *_ in log]

    def test_poisoned_coalesced_batch_of_two(self):
        """The 2-leaf edge of the ladder: one healthy, one poisoned."""
        _, labels = _payload()
        good = np.arange(64, dtype=np.float64)
        bad = good + 1
        expect = groupby_reduce(good, labels, func="sum")[0]

        async def main():
            d = Dispatcher(batch_window=0.05)
            with faults.serve_inject(poison_digests=[payload_digest(bad)]):
                ok, err = await asyncio.gather(
                    d.submit(func="sum", array=good, by=labels),
                    d.submit(func="sum", array=bad, by=labels),
                    return_exceptions=True,
                )
                await d.close()
            return ok, err

        ok, err = run(main())
        assert np.asarray(ok.result).tobytes() == expect.tobytes()
        assert isinstance(err, faults.SimulatedCompileError)

    def test_queue_healthy_after_quarantine(self):
        values, labels = _payload()
        expect = groupby_reduce(values, labels, func="sum")[0]

        async def main():
            d = Dispatcher(batch_window=0.05)
            with faults.serve_inject(poison_digests=[payload_digest(values)]):
                with pytest.raises(faults.SimulatedCompileError):
                    await d.submit(func="sum", array=values, by=labels)
                await d.close()
            after = await d.submit(func="sum", array=values, by=labels)
            await d.close()
            return after

        after = run(main())
        assert np.asarray(after.result).tobytes() == expect.tobytes()
        assert cache.stats()["serve_pending"] == 0
        assert cache.stats()["serve_coalesce"] == 0


class TestCircuitBreaker:
    def test_breaker_opens_and_fast_fails_without_dispatch(self):
        """Acceptance: an open breaker fast-fails with no device dispatch
        (``serve.dispatches`` unchanged) and a typed error carrying the
        program label + cooldown."""
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(
                serve_breaker_threshold=2, serve_breaker_cooldown=60.0
            ):
                with faults.serve_inject(fail_compile_for=["sum"]):
                    for _ in range(2):
                        with pytest.raises(faults.SimulatedCompileError):
                            await d.submit(func="sum", array=values, by=labels)
                        await d.close()
                dispatches = METRICS.get("serve.dispatches")
                with pytest.raises(CircuitOpenError) as info:
                    await d.submit(func="sum", array=values, by=labels)
                await d.close()
                return dispatches, METRICS.get("serve.dispatches"), info.value

        before, after, exc = run(main())
        assert after == before  # fast-fail: no dispatch burned
        assert exc.code == "circuit_open"
        assert exc.retry_after_ms is not None and exc.retry_after_ms > 0
        assert exc.program is not None and exc.program.startswith("sum#")
        assert METRICS.get("serve.breaker_opened") == 1
        assert METRICS.get("serve.breaker_fastfail") == 1
        stats = cache.stats()["serve_breakers"]
        assert stats["open"] == 1 and stats["total"] == 1
        (tripped,) = stats["tripped"].values()
        assert tripped["state"] == "open" and tripped["failures"] == 2

    def test_half_open_probe_closes_breaker(self):
        values, labels = _payload()
        expect = groupby_reduce(values, labels, func="sum")[0]

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(
                serve_breaker_threshold=1, serve_breaker_cooldown=0.05
            ):
                with faults.serve_inject(fail_compile_for=["sum"]):
                    with pytest.raises(faults.SimulatedCompileError):
                        await d.submit(func="sum", array=values, by=labels)
                    await d.close()
                    with pytest.raises(CircuitOpenError):
                        await d.submit(func="sum", array=values, by=labels)
                await asyncio.sleep(0.08)  # cooldown elapses, fault gone
                probe = await d.submit(func="sum", array=values, by=labels)
                await d.close()
                after = await d.submit(func="sum", array=values, by=labels)
                await d.close()
                return probe, after

        probe, after = run(main())
        assert np.asarray(probe.result).tobytes() == expect.tobytes()
        assert np.asarray(after.result).tobytes() == expect.tobytes()
        assert METRICS.get("serve.breaker_half_open") == 1
        assert METRICS.get("serve.breaker_closed") == 1
        assert cache.stats()["serve_breakers"]["total"] == 0

    def test_failed_probe_reopens(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(
                serve_breaker_threshold=1, serve_breaker_cooldown=0.05
            ):
                with faults.serve_inject(fail_compile_for=["sum"]):
                    with pytest.raises(faults.SimulatedCompileError):
                        await d.submit(func="sum", array=values, by=labels)
                    await d.close()
                    await asyncio.sleep(0.08)
                    # the probe is admitted — and fails again
                    with pytest.raises(faults.SimulatedCompileError):
                        await d.submit(func="sum", array=values, by=labels)
                    await d.close()
                    # straight back to open, fresh cooldown: fast-fail
                    with pytest.raises(CircuitOpenError):
                        await d.submit(func="sum", array=values, by=labels)
                await d.close()

        run(main())
        assert METRICS.get("serve.breaker_reopened") == 1
        assert cache.stats()["serve_breakers"]["open"] == 1

    def test_inconclusive_probe_rearms_instead_of_wedging(self):
        """A half-open probe that ends WITHOUT a verdict (here: device loss
        under the probe's dispatch) must re-arm the probe slot — not leave
        ``probing=True`` forever fast-failing the key permanently."""
        values, labels = _payload()
        expect = groupby_reduce(values, labels, func="sum")[0]

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(
                serve_breaker_threshold=1, serve_breaker_cooldown=0.05
            ):
                with faults.serve_inject(fail_compile_for=["sum"], fail_times=1):
                    with pytest.raises(faults.SimulatedCompileError):
                        await d.submit(func="sum", array=values, by=labels)
                    await d.close()
                await asyncio.sleep(0.08)  # cooldown elapses
                with faults.serve_inject(device_loss_at=[1]):
                    # the admitted probe dies with the device: no verdict
                    with pytest.raises(DeviceLostError):
                        await d.submit(func="sum", array=values, by=labels)
                    await d.close()  # recovery completes
                # the NEXT request becomes a fresh probe and closes the
                # breaker — a leaked probe slot would CircuitOpenError here
                after = await d.submit(func="sum", array=values, by=labels)
                await d.close()
                return after

        after = run(main())
        assert np.asarray(after.result).tobytes() == expect.tobytes()
        assert cache.stats()["serve_breakers"]["total"] == 0
        assert METRICS.get("serve.breaker_closed") == 1

    def test_threshold_zero_disables_breakers(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(serve_breaker_threshold=0):
                with faults.serve_inject(fail_compile_for=["sum"]):
                    for _ in range(4):
                        with pytest.raises(faults.SimulatedCompileError):
                            await d.submit(func="sum", array=values, by=labels)
                        await d.close()

        run(main())
        assert cache.stats()["serve_breakers"]["total"] == 0
        assert METRICS.get("serve.breaker_opened") == 0

    def test_different_program_keys_have_independent_breakers(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(
                serve_breaker_threshold=1, serve_breaker_cooldown=60.0
            ):
                with faults.serve_inject(fail_compile_for=["sum"]):
                    with pytest.raises(faults.SimulatedCompileError):
                        await d.submit(func="sum", array=values, by=labels)
                    await d.close()
                    with pytest.raises(CircuitOpenError):
                        await d.submit(func="sum", array=values, by=labels)
                    # a different program key is untouched by sum's breaker
                    ok = await d.submit(func="mean", array=values, by=labels)
                    await d.close()
                    return ok

        ok = run(main())
        expect, _ = groupby_reduce(*_mean_args(), func="mean")
        np.testing.assert_array_equal(ok.result, expect)


def _mean_args():
    values, labels = _payload()
    return values, labels


class TestDeviceLossRecovery:
    def test_full_cycle_readyz_and_zero_build_warm_dispatch(self, tmp_path, monkeypatch):
        """Injected device loss -> in-flight waiters fail with
        DeviceLostError, readiness flips 503 (device-lost) then back to
        200, the warmup manifest replays, and the post-recovery dispatch
        builds no kernel library. On the CPU the whole recovery can finish
        before the failed waiter resumes, so the replay waits until the test
        has read readiness."""
        import threading

        from flox_tpu_torch.serve import aot

        values, labels = _payload()
        readiness: dict[str, bool] = {}
        release = threading.Event()
        real_warmup = aot.warmup

        def held_warmup(*a, **kw):
            release.wait(timeout=30)
            return real_warmup(*a, **kw)

        monkeypatch.setattr(aot, "warmup", held_warmup)

        async def main():
            with flox_tpu_torch.set_options(
                serve_aot_dir=str(tmp_path), telemetry=True
            ):
                d = Dispatcher(microbatch_max=1)
                # request A: compiles, persists the executable + manifest
                a = await d.submit(func="sum", array=values, by=labels)
                await d.close()
                with faults.serve_inject(device_loss_at=[1]):
                    with pytest.raises(DeviceLostError) as info:
                        await d.submit(func="sum", array=values, by=labels)
                    readiness["during"] = exposition.ready()
                    reason = exposition.ready_reason()
                    release.set()
                    await d.close()  # the batch task finishes the recovery
                readiness["after"] = exposition.ready()
                builds0 = _build.BUILDS["count"]
                c = await d.submit(func="sum", array=values, by=labels)
                await d.close()
                return a, info.value, reason, _build.BUILDS["count"] - builds0, c

        a, exc, reason, compile_delta, c = run(main())
        assert exc.code == "device_lost"
        assert readiness["during"] is False and reason == "device-lost"
        assert readiness["after"] is True
        assert compile_delta == 0, "post-recovery warm dispatch built a kernel library"
        assert np.asarray(c.result).tobytes() == np.asarray(a.result).tobytes()
        assert METRICS.get("serve.device_lost") == 1
        assert METRICS.get("serve.recoveries") == 1
        assert METRICS.get("serve.aot_warmed") >= 1  # manifest replayed

    def test_device_loss_does_not_open_breaker(self):
        values, labels = _payload()

        async def main():
            with flox_tpu_torch.set_options(
                serve_breaker_threshold=1, telemetry=True
            ):
                d = Dispatcher(microbatch_max=1)
                with faults.serve_inject(device_loss_at=[1]):
                    with pytest.raises(DeviceLostError):
                        await d.submit(func="sum", array=values, by=labels)
                    await d.close()
                ok = await d.submit(func="sum", array=values, by=labels)
                await d.close()
                return ok

        ok = run(main())
        assert ok is not None
        assert cache.stats()["serve_breakers"]["total"] == 0


class TestWatchdog:
    def test_hung_dispatch_fails_waiters_within_budget(self):
        """Acceptance: a hung dispatch fails its waiters within the
        watchdog budget instead of blocking the queue."""
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1, batch_window=0.0)
            with flox_tpu_torch.set_options(serve_watchdog_timeout=0.15):
                with faults.serve_inject(hang_at=[1], hang_seconds=1.0):
                    t0 = time.perf_counter()
                    with pytest.raises(WatchdogTimeoutError) as info:
                        await d.submit(func="sum", array=values, by=labels)
                    elapsed = time.perf_counter() - t0
                    # the queue keeps moving while the hung thread sleeps on
                    after = await d.submit(func="sum", array=values + 1, by=labels)
                    await d.close()
            return info.value, elapsed, after

        exc, elapsed, after = run(main())
        assert exc.code == "watchdog_timeout"
        assert elapsed < 0.8, f"waiters hung for {elapsed:.2f}s past the budget"
        assert METRICS.get("serve.watchdog_fired") == 1
        expect_after = groupby_reduce(values + 1, labels, func="sum")[0]
        assert np.asarray(after.result).tobytes() == expect_after.tobytes()

    def test_watchdog_counts_toward_breaker(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(
                serve_watchdog_timeout=0.1,
                serve_breaker_threshold=1,
                serve_breaker_cooldown=60.0,
            ):
                with faults.serve_inject(hang_at=[1], hang_seconds=0.5):
                    with pytest.raises(WatchdogTimeoutError):
                        await d.submit(func="sum", array=values, by=labels)
                with pytest.raises(CircuitOpenError):
                    await d.submit(func="sum", array=values, by=labels)
                await d.close()

        run(main())
        assert cache.stats()["serve_breakers"]["open"] == 1

    def test_watchdog_zero_disables(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            with flox_tpu_torch.set_options(serve_watchdog_timeout=0.0):
                with faults.serve_inject(hang_at=[1], hang_seconds=0.2):
                    return await d.submit(func="sum", array=values, by=labels)

        assert run(main()) is not None
        assert METRICS.get("serve.watchdog_fired") == 0


class TestDrain:
    def test_begin_drain_rejects_new_submits_typed(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher()
            ok = await d.submit(func="sum", array=values, by=labels)
            d.begin_drain()
            assert d.draining
            with pytest.raises(DrainingError) as info:
                await d.submit(func="sum", array=values, by=labels)
            await d.close()
            return ok, info.value

        ok, exc = run(main())
        assert ok is not None
        assert exc.code == "draining"
        assert METRICS.get("serve.drains") == 1
        assert METRICS.get("serve.drain_rejected") == 1

    def test_ready_reason_tracks_drain_and_recovery_states(self):
        exposition.set_ready(True)
        assert exposition.ready() and exposition.ready_reason() == "warming"
        exposition.set_ready(False, reason="draining")
        assert not exposition.ready()
        assert exposition.ready_reason() == "draining"
        exposition.set_ready(False, reason="device-lost")
        assert exposition.ready_reason() == "device-lost"
        exposition.set_ready(True)
        assert exposition.ready_reason() == "warming"

    def test_sigterm_graceful_drain_subprocess(self, tmp_path):
        """Acceptance: SIGTERM during an in-flight request exits 0 AFTER
        answering it, with the shutdown ack and a drain flight dump."""
        flight = tmp_path / "flight.jsonl"
        env = dict(
            os.environ,
            FLOX_TPU_TELEMETRY="1",
            FLOX_TPU_FLIGHT_RECORDER_PATH=str(flight),
        )
        env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
        proc = subprocess.Popen(
            [sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu",
             "--batch-window", "0.6"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
        )
        try:
            reader = _RawLineReader(proc)
            # prove the loop is alive before timing anything
            proc.stdin.write(json.dumps({"op": "stats"}) + "\n")
            proc.stdin.flush()
            stats_line = reader.line(timeout=120)
            assert json.loads(stats_line)["op"] == "stats"
            # in-flight: admitted, inside the 0.6s batch window, undispatched
            proc.stdin.write(
                json.dumps(
                    {"id": "inflight", "func": "sum",
                     "array": [1.0, 2.0, 4.0, 8.0], "by": [0, 0, 1, 1]}
                )
                + "\n"
            )
            proc.stdin.flush()
            time.sleep(0.25)
            proc.send_signal(signal.SIGTERM)
            out = reader.until_eof(timeout=120)
            proc.wait(timeout=60)
            err = proc.stderr.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, (proc.returncode, err)
        records = [json.loads(l) for l in (stats_line + out).splitlines() if l.strip()]
        by_id = {r.get("id", r.get("op")): r for r in records}
        assert by_id["inflight"]["ok"], by_id  # answered, not killed
        assert by_id["inflight"]["result"] == [3.0, 12.0]
        ack = by_id["shutdown"]
        assert ack["ok"] and ack["source"] == "SIGTERM" and ack["abandoned"] == 0
        dump = [json.loads(l) for l in flight.read_text().splitlines()]
        assert dump[0]["attrs"]["reason"] == "drain:SIGTERM", dump[0]

    def test_shutdown_op_drains_and_exits_zero(self, tmp_path):
        flight = tmp_path / "flight.jsonl"
        env = dict(
            os.environ,
            FLOX_TPU_TELEMETRY="1",
            FLOX_TPU_FLIGHT_RECORDER_PATH=str(flight),
        )
        env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
        lines = "\n".join(
            [
                json.dumps({"id": "r", "func": "sum",
                            "array": [1.0, 2.0, 4.0, 8.0], "by": [0, 0, 1, 1]}),
                json.dumps({"op": "shutdown"}),
                json.dumps({"id": "late", "func": "sum",
                            "array": [1.0], "by": [0]}),  # after shutdown: unread
            ]
        )
        proc = subprocess.run(
            [sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu"],
            input=lines, cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        records = [json.loads(l) for l in proc.stdout.splitlines() if l.strip()]
        by_id = {r.get("id", r.get("op")): r for r in records}
        assert by_id["r"]["ok"]
        assert by_id["shutdown"]["ok"]
        assert by_id["shutdown"]["source"] == "shutdown-op"
        assert "late" not in by_id  # admission stopped at the shutdown op
        assert flight.exists()


class _RawLineReader:
    """Bounded line reads from a live subprocess's stdout.

    Reads the RAW fd with ``os.read`` (never the TextIOWrapper — buffered
    reads strand bytes invisible to ``select``, which then waits forever on
    an fd whose data already moved into the Python-side buffer), so a
    wedged replica fails the test instead of hanging the suite."""

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
                return head.decode() + "\n"
            ready, _, _ = select.select([self.fd], [], [], 0.2)
            if not ready:
                if self.proc.poll() is not None:
                    raise AssertionError(
                        f"serve exited early: rc={self.proc.returncode} "
                        f"stderr={self.proc.stderr.read()[-2000:]}"
                    )
                continue
            self.buf += os.read(self.fd, 65536)
        raise AssertionError(f"no line within {timeout}s (got {self.buf!r})")

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
        raise AssertionError(f"no EOF within {timeout}s (got {self.buf!r})")


class TestTypedProtocolErrors:
    def test_error_response_carries_code_and_retry_hint(self):
        from flox_tpu_torch.serve import __main__ as serve_main
        from flox_tpu_torch.serve.dispatcher import LoadShedError

        resp = serve_main._error_response(
            "r1", LoadShedError("saturated", retry_after_ms=12.5)
        )
        assert resp["code"] == "load_shed"
        assert resp["retry_after_ms"] == 12.5
        assert resp["error"] == "LoadShedError"
        resp = serve_main._error_response("r2", ValueError("boom"))
        assert resp["code"] == "execution" and "retry_after_ms" not in resp
        resp = serve_main._error_response(
            "r3",
            CircuitOpenError("open", retry_after_ms=100.0, program="sum#abcd"),
        )
        assert resp["code"] == "circuit_open" and resp["program"] == "sum#abcd"

    def test_every_serve_error_has_a_distinct_code(self):
        from flox_tpu_torch.serve import dispatcher as dp

        codes = {
            cls.code
            for cls in (
                dp.LoadShedError, dp.DeadlineExceededError, dp.CircuitOpenError,
                dp.DeviceLostError, dp.WatchdogTimeoutError, dp.DrainingError,
            )
        }
        assert len(codes) == 6  # no two failure kinds share a code

    def test_load_shed_carries_retry_hint(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(queue_depth=1, batch_window=0.2)
            results = await asyncio.gather(
                *[d.submit(func="sum", array=values + i, by=labels) for i in range(3)],
                return_exceptions=True,
            )
            await d.close()
            return results

        shed = [r for r in run(main()) if isinstance(r, Exception)]
        assert shed and all(
            r.code == "load_shed" and r.retry_after_ms and r.retry_after_ms > 0
            for r in shed
        )


class TestQuiescentBitIdentity:
    def test_fault_domain_armed_but_quiescent_is_bit_identical(self):
        """Acceptance: watchdog + breakers enabled, zero faults injected —
        served results are bit-identical to direct library calls."""
        requests = []
        for i in range(8):
            values, labels = _payload(seed=i, ngroups=3 + i % 3)
            requests.append((["sum", "nanmean", "max", "prod"][i % 4], values, labels))
        direct = [groupby_reduce(v, l, func=f)[0] for f, v, l in requests]

        async def main():
            d = Dispatcher()
            with flox_tpu_torch.set_options(
                serve_watchdog_timeout=30.0,
                serve_breaker_threshold=2,
                serve_breaker_cooldown=1.0,
            ):
                results = await asyncio.gather(
                    *[d.submit(func=f, array=v, by=l) for f, v, l in requests]
                )
                await d.close()
            return results

        from flox_tpu.core import groupby_reduce as ref_groupby_reduce

        for served, expect, (f, v, l) in zip(run(main()), direct, requests):
            assert np.asarray(served.result).tobytes() == expect.tobytes()
            want = np.asarray(ref_groupby_reduce(v, l, func=f, engine="jax")[0])
            np.testing.assert_allclose(served.result, want, rtol=1e-12, atol=1e-12)
        assert METRICS.get("serve.quarantine_splits") == 0
        assert METRICS.get("serve.watchdog_fired") == 0
        assert cache.stats()["serve_breakers"]["total"] == 0


class TestServeHarness:
    def test_serve_plan_nests_and_restores(self):
        assert not faults.serve_active()
        with faults.serve_inject(fail_compile_for=["sum"]):
            assert faults.serve_active()
            with faults.serve_inject(device_loss_at=[1]):
                assert faults.serve_active()
            assert faults.serve_active()
        assert not faults.serve_active()

    def test_serve_poke_noop_without_plan(self):
        faults.serve_poke("sum", ("digest",))  # must not raise

    def test_fail_times_bounds_firings(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            with faults.serve_inject(fail_compile_for=["sum"], fail_times=1):
                with pytest.raises(faults.SimulatedCompileError):
                    await d.submit(func="sum", array=values, by=labels)
                await d.close()
                ok = await d.submit(func="sum", array=values, by=labels)
                await d.close()
                return ok

        assert run(main()) is not None
