"""Profiling hooks (the port of ``flox_tpu/profiling.py``), on
``torch.profiler``.

* :func:`trace`: a ``torch.profiler`` trace of a block (host ops and, on the
  card, its kernels through CUPTI), written as a Chrome trace JSON into a
  directory (``profile_dir`` by default); :func:`annotate` names a region
  inside it.
* On-demand capture (:func:`start_capture`): a profiler window of N
  seconds into a fresh ``capture-<stamp>-<seq>`` directory under
  ``profile_dir``, old captures rotated out past ``profile_keep``, one
  capture at a time (:class:`CaptureBusyError`); SIGUSR1 starts one
  (:func:`install_capture_signal`). The window runs on its own daemon
  thread, which starts the profiler, sleeps and stops it, since a
  ``torch.profiler`` session must stop on the thread that started it; on
  the card CUPTI records every kernel the device runs in the window, from
  any thread. A finished capture is stamped with the programs dispatched
  inside it (``costmodel.stamp_capture``). The reference's HTTP and serve
  surfaces of the capture come with the serve plane.
* :func:`timed` wall-time regions that also show up in a trace, and the
  per-pass :class:`StreamReport` that every streaming call emits, collected
  by :func:`stream_monitor`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = [
    "CaptureBusyError",
    "CaptureUnavailableError",
    "StreamReport",
    "annotate",
    "capture_active",
    "install_capture_signal",
    "record_stream",
    "start_capture",
    "stream_monitor",
    "timed",
    "trace",
]

logger = logging.getLogger("flox_tpu_torch.profiling")


class CaptureBusyError(RuntimeError):
    """A capture is already running: one at a time (the profiler is a
    process-global singleton)."""


class CaptureUnavailableError(RuntimeError):
    """No capture is possible: no capture root is configured, or the
    profiler cannot start."""


def _profiler(activities: Any = None):
    """A ``torch.profiler.profile`` recording the CPU and, where there is
    one, the CUDA device (the one place the profiler object is made)."""
    import torch

    if activities is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block and write a Chrome trace JSON (``ui.perfetto.dev``)
    into ``logdir`` (default ``OPTIONS["profile_dir"]``, env
    ``FLOX_TPU_PROFILE_DIR``; with neither this raises ``ValueError``). A
    profiler that cannot start warns and the block runs untraced.

    >>> with flox_tpu_torch.profiling.trace("/tmp/flox-trace"):  # doctest: +SKIP
    ...     groupby_reduce(...)
    """
    from .options import OPTIONS

    if logdir is None:
        logdir = OPTIONS["profile_dir"]
    if logdir is None:
        raise ValueError(
            "profiling.trace() needs a logdir: pass one explicitly or set "
            "OPTIONS['profile_dir'] (env FLOX_TPU_PROFILE_DIR)")
    logdir = str(logdir)
    os.makedirs(logdir, exist_ok=True)
    prof = _profiler()
    try:
        prof.start()
    except Exception as exc:  # noqa: BLE001 - a profiler that cannot start must not
        # take the profiled workload down with it: warn and run untraced
        logger.warning("profiler unavailable, running untraced: %s", exc)
        yield
        return
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(logdir, f"trace-{os.getpid()}-{time.strftime('%Y%m%d-%H%M%S')}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


# ---------------------------------------------------------------------------
# on-demand capture: bounded, rotated, one at a time
# ---------------------------------------------------------------------------

#: capture state: ``{"active": {...}}`` while a capture runs (dir, seconds,
#: started, marks), and the rotation sequence; the empty dict is the reset state
_CAPTURE_STATE: dict[str, Any] = {}
_CAPTURE_LOCK = threading.Lock()


def capture_active() -> dict | None:
    """A copy of the live capture's info (dir/seconds/started), or None."""
    with _CAPTURE_LOCK:
        active = _CAPTURE_STATE.get("active")
        return dict(active) if active else None


def _rotate_captures(root: Any, keep: int) -> None:
    """Delete the oldest ``capture-*`` directories so that at most
    ``keep - 1`` remain before a new one is made. Timestamped names sort
    chronologically."""
    import shutil

    try:
        entries = sorted(e for e in os.listdir(str(root)) if e.startswith("capture-"))
    except OSError:
        return
    excess = len(entries) - (keep - 1)
    for stale in entries[:excess] if excess > 0 else []:
        shutil.rmtree(os.path.join(str(root), stale), ignore_errors=True)


def start_capture(seconds: float = 5.0, root: Any = None) -> str:
    """Start a profiler capture of ``seconds`` and return its directory at
    once; the window runs on a daemon thread and writes ``trace.json``
    there, then ``programs.json`` (the programs dispatched in the window).
    Raises :class:`CaptureBusyError` while another capture runs,
    :class:`CaptureUnavailableError` without a root, ``ValueError`` for a
    window outside (0, 3600] seconds."""
    from . import telemetry
    from .options import OPTIONS

    seconds = float(seconds)
    if not 0 < seconds <= 3600:
        raise ValueError(f"capture window must be in (0, 3600] seconds, got {seconds}")
    if root is None:
        root = OPTIONS["profile_dir"]
    if root is None:
        raise CaptureUnavailableError(
            "no capture root configured: set OPTIONS['profile_dir'] (env FLOX_TPU_PROFILE_DIR)")
    with _CAPTURE_LOCK:
        if _CAPTURE_STATE.get("active"):
            raise CaptureBusyError(
                f"capture already running in {_CAPTURE_STATE['active']['dir']}")
        seq = _CAPTURE_STATE.get("seq", 0) + 1
        _CAPTURE_STATE["seq"] = seq
        os.makedirs(str(root), exist_ok=True)
        _rotate_captures(root, int(OPTIONS["profile_keep"]))
        stamp = time.strftime("%Y%m%d-%H%M%S")
        capture_dir = os.path.join(str(root), f"capture-{stamp}-{seq:03d}")
        os.makedirs(capture_dir, exist_ok=True)
        from .costmodel import dispatch_marks

        _CAPTURE_STATE["active"] = {"dir": capture_dir, "seconds": seconds,
                                    "started": time.time(), "marks": dispatch_marks()}
    started = threading.Event()
    failure: list = []

    def _window() -> None:
        prof = _profiler()
        try:
            prof.start()
        except Exception as exc:  # noqa: BLE001 - reported to the starter below
            failure.append(exc)
            started.set()
            return
        started.set()
        try:
            time.sleep(seconds)
        finally:
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(capture_dir, "trace.json"))
                logger.info("on-demand capture written to %s", capture_dir)
            except Exception as exc:  # noqa: BLE001 - the guard must clear either way
                logger.warning("on-demand capture stop failed: %s", exc)
            _finish(capture_dir, seconds)

    threading.Thread(target=_window, name="flox-torch-capture", daemon=True).start()
    started.wait()
    if failure:
        with _CAPTURE_LOCK:
            _CAPTURE_STATE.pop("active", None)
        raise CaptureUnavailableError(f"profiler unavailable: {failure[0]}") from failure[0]
    telemetry.count("profile.capture_starts")
    return capture_dir


def _finish(capture_dir: str, seconds: float) -> None:
    """Clear the capture guard and stamp the finished capture with the
    programs dispatched inside its window."""
    from . import telemetry
    from .costmodel import stamp_capture

    with _CAPTURE_LOCK:
        active = _CAPTURE_STATE.get("active", {})
        marks = active.get("marks") if active.get("dir") == capture_dir else None
        if active.get("dir") == capture_dir:
            _CAPTURE_STATE.pop("active", None)
    if marks is not None:
        stamp_capture(capture_dir, marks)
    telemetry.count("profile.captures")
    telemetry.event("profile.capture", dir=capture_dir, seconds=seconds)


def install_capture_signal() -> None:
    """SIGUSR1 -> a 5-second capture into the configured root. The handler
    only starts a daemon thread and never raises: a busy or unconfigured
    capture is a log line. No-op without SIGUSR1 or off the main thread."""
    import signal

    signum = getattr(signal, "SIGUSR1", None)
    if signum is None:
        return

    def _capture_bg() -> None:
        try:
            start_capture(seconds=5.0)
        except (CaptureBusyError, CaptureUnavailableError, ValueError) as exc:
            logger.warning("SIGUSR1 capture not started: %s", exc)

    def _handler(signum: int, frame: Any) -> None:
        threading.Thread(target=_capture_bg, name="flox-torch-capture", daemon=True).start()

    try:
        signal.signal(signum, _handler)
    except (ValueError, OSError):  # not the main thread
        return


def annotate(name: str):
    """A named region inside profiler traces (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(label: str):
    """A named region: a ``torch.profiler`` range (visible in a trace when
    one is recording) and a wall-clock log line (host time, including the
    launches)."""
    import torch

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        logger.info("%s took %.3f ms", label, (time.perf_counter() - t0) * 1e3)


@dataclass
class StreamReport:
    """Per-slab pipeline timings of one streaming pass.

    ``slabs`` holds the ``pipeline.Slab`` records in consumption order; each
    carries ``load_ms`` (the loader and the copy into the pinned buffer),
    ``stage_ms`` (issuing the host-to-device copy), ``wait_ms`` (time the
    consumer waited for the slab: with prefetch off the whole staging, with
    prefetch on its unhidden remainder) and ``dispatch_ms`` (the slab's step
    on the consumer, with any throttle sync). ``counters`` is the run's
    ``resilience.StreamCounters``, shared by the passes of a multi-pass run."""

    label: str = ""
    prefetch: int = 0
    nbatches: int = 0
    wall_ms: float = 0.0
    slabs: list = field(default_factory=list)
    counters: Any = None
    #: bytes of data copied to the device by this pass
    nbytes: int = 0

    @property
    def load_ms(self) -> float:
        return sum(s.load_ms for s in self.slabs)

    @property
    def stage_ms(self) -> float:
        return sum(s.stage_ms for s in self.slabs)

    @property
    def wait_ms(self) -> float:
        return sum(s.wait_ms for s in self.slabs)

    @property
    def dispatch_ms(self) -> float:
        return sum(s.dispatch_ms for s in self.slabs)

    @property
    def overlap_fraction(self) -> float:
        """Share of the staging wall (load + stage) hidden off the consumer's
        critical path: 0 when every slab was waited for inline, towards 1
        when staging ran wholly behind the steps."""
        staged = self.load_ms + self.stage_ms
        if staged <= 0.0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - self.wait_ms / staged))

    @property
    def retries(self) -> int:
        return self.counters.retries if self.counters is not None else 0

    @property
    def backoff_ms(self) -> float:
        return self.counters.backoff_ms if self.counters is not None else 0.0

    @property
    def oom_splits(self) -> int:
        return self.counters.oom_splits if self.counters is not None else 0

    @property
    def checkpoints(self) -> int:
        return self.counters.checkpoints if self.counters is not None else 0

    @property
    def resumed_at(self):
        return self.counters.resumed_at if self.counters is not None else None

    def summary(self) -> str:
        line = (
            f"stream-pipeline [{self.label}] {len(self.slabs)}/{self.nbatches} "
            f"slab(s) prefetch={self.prefetch}: wall {self.wall_ms:.1f} ms, "
            f"load {self.load_ms:.1f} ms, stage {self.stage_ms:.1f} ms, "
            f"wait {self.wait_ms:.1f} ms, dispatch {self.dispatch_ms:.1f} ms, "
            f"overlap {self.overlap_fraction:.0%}"
        )
        if self.retries:
            line += f", retries {self.retries} (backoff {self.backoff_ms:.0f} ms)"
        if self.oom_splits:
            line += f", oom-splits {self.oom_splits}"
        if self.checkpoints:
            line += f", checkpoints {self.checkpoints}"
        if self.resumed_at is not None:
            line += f", resumed@{self.resumed_at}"
        return line


# active stream_monitor collectors (reports are appended by the consumer
# thread after each pass)
_MONITORS: list[list[StreamReport]] = []


@contextlib.contextmanager
def stream_monitor() -> Iterator[list[StreamReport]]:
    """Collect the :class:`StreamReport` of every streaming pass in scope.

    >>> from flox_tpu_torch import profiling
    >>> with profiling.stream_monitor() as reports:
    ...     pass
    >>> reports
    []
    """
    reports: list[StreamReport] = []
    _MONITORS.append(reports)
    try:
        yield reports
    finally:
        _MONITORS.remove(reports)


def record_stream(report: Any) -> None:
    """Deliver one finished pass to every active monitor and the log."""
    for collector in _MONITORS:
        collector.append(report)
    logger.info("%s", report.summary())
