"""Streaming instrumentation (the port of ``flox_tpu/profiling.py``, in
part): :func:`timed` wall-time regions that also show up in a
``torch.profiler`` trace, and the per-pass :class:`StreamReport` that every
streaming call emits, collected by :func:`stream_monitor`.

Left out until ROADMAP A9 ports it: trace capture (``trace``,
``start_capture``, the capture signal and its HTTP and serve surfaces) and
``annotate``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = ["StreamReport", "record_stream", "stream_monitor", "timed"]

logger = logging.getLogger("flox_tpu_torch.profiling")


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
