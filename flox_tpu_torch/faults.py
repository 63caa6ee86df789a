"""Deterministic fault injection for the streaming executor (the port of
``flox_tpu/faults.py``, its stream hooks).

Resilience claims are only as good as the faults they were tested against,
and real faults (a flaky object store, device memory exhausted, a preempted
host) are neither deterministic nor available on a CPU test run. These hooks
inject them where the resilience layer must handle them:

* :class:`FlakyLoader` wraps a loader callable and raises a chosen exception
  for chosen slab start offsets a fixed number of times before recovering
  (the retry and backoff tests);
* :func:`inject` installs a dispatch-side fault plan that
  ``resilience.dispatch_slab`` consults just before each slab step runs
  (:func:`poke`): :class:`SimulatedOOM` at chosen slab starts (the halving
  ladder) and :class:`StreamKilled` at a chosen start or after a chosen
  number of dispatches (checkpoint and resume);
* :func:`misshaping_loader` breaks the loader's shape contract at one slab.

Everything is index-deterministic: the same plan against the same stream
fires at the same slabs in the same order, prefetch on or off.

Left out until their modules are ported (ROADMAP A9): the serve plan
(``serve_inject``, ``SimulatedCompileError``, dispatch delays), the store
plan (``store_inject``, ``StoreWriteKilled``), the SLO plan and the
schedule-stress harness.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np

__all__ = [
    "FlakyLoader",
    "SimulatedDeviceLoss",
    "SimulatedOOM",
    "StreamKilled",
    "active",
    "inject",
    "misshaping_loader",
    "poke",
]


class SimulatedOOM(RuntimeError):
    """Stands in for ``torch.cuda.OutOfMemoryError``: the message carries the
    out-of-memory token, so ``resilience.classify_error`` routes it down the
    same slab-halving path as the real thing."""

    def __init__(self, where: str = "") -> None:
        super().__init__(f"RESOURCE_EXHAUSTED (simulated): out of memory {where}".rstrip())


class StreamKilled(RuntimeError):
    """Simulated host preemption: classified fatal (never retried, never
    split), so the stream dies as a killed process would, leaving only its
    checkpoint behind."""

    def __init__(self, where: str = "") -> None:
        super().__init__(f"stream killed (simulated preemption) {where}".rstrip())


class SimulatedDeviceLoss(RuntimeError):
    """Stands in for a lost device: the message carries the ``DEVICE_LOST``
    token, so ``resilience.classify_error`` classifies it as device loss."""

    def __init__(self, where: str = "") -> None:
        super().__init__(f"DEVICE_LOST (simulated): device lost {where}".rstrip())


@dataclass
class _Fault:
    exc: type[BaseException]
    times: int  # remaining firings; -1 = always


@dataclass
class _Plan:
    """One installed dispatch-fault plan, with a log of every dispatch for
    asserting determinism."""

    at_start: dict[int, _Fault] = field(default_factory=dict)
    kill_after: int | None = None
    pokes: int = 0
    #: (exception name | None, start, stop) per dispatch, in dispatch order
    log: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)


_PLAN: _Plan | None = None


def active() -> bool:
    return _PLAN is not None


def poke(start: int, stop: int) -> None:
    """Dispatch-side hook: ``resilience.dispatch_slab`` calls this just
    before running (or re-running, for split sub-slabs) a slab step. A no-op
    unless a plan is installed with :func:`inject`."""
    plan = _PLAN
    if plan is None:
        return
    with plan._lock:
        plan.pokes += 1
        if plan.kill_after is not None and plan.pokes > plan.kill_after:
            plan.log.append(("StreamKilled", start, stop))
            raise StreamKilled(f"at dispatch #{plan.pokes}, slab [{start}:{stop})")
        fault = plan.at_start.get(start)
        if fault is not None and fault.times != 0:
            if fault.times > 0:
                fault.times -= 1
            plan.log.append((fault.exc.__name__, start, stop))
            raise fault.exc(f"at slab [{start}:{stop})")
        plan.log.append((None, start, stop))


@contextlib.contextmanager
def inject(
    *,
    oom_at: tuple[int, ...] | list[int] = (),
    oom_times: int = 1,
    kill_at: tuple[int, ...] | list[int] = (),
    kill_after: int | None = None,
) -> Iterator[_Plan]:
    """Install a deterministic dispatch-side fault plan for the scope.

    ``oom_at``: slab START offsets (elements, not indices) whose dispatch
    raises :class:`SimulatedOOM`, each ``oom_times`` times: a second firing
    hits the first re-staged sub-slab (same start), one rung deeper.
    ``kill_at``: starts whose dispatch raises :class:`StreamKilled` once.
    ``kill_after``: kill at dispatch number ``kill_after + 1`` wherever it
    falls (the way to land inside a chosen quantile pass). Yields the plan,
    whose ``log`` records every dispatch.
    """
    global _PLAN
    plan = _Plan(kill_after=kill_after)
    for s in oom_at:
        plan.at_start[int(s)] = _Fault(SimulatedOOM, oom_times)
    for s in kill_at:
        plan.at_start[int(s)] = _Fault(StreamKilled, 1)
    prev = _PLAN
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = prev


class FlakyLoader:
    """Wrap a loader so that chosen slabs fail a fixed number of times.

    ``faults`` maps slab START offsets to the exception to raise: a type
    (instantiated with a message naming the slab), an instance (raised as
    it is) or a zero-argument factory. Each entry fires ``times`` times, then
    the loader serves the real bytes: the shape of a transient IO fault.
    Thread-safe (the prefetch pool loads concurrently); ``calls`` and
    ``injected`` record every access in call order.
    """

    def __init__(self, loader: Callable[[int, int], Any], faults: dict[int, Any], *,
                 times: int = 1) -> None:
        self._loader = loader
        self._faults = {int(s): [spec, times] for s, spec in faults.items()}
        self._lock = threading.Lock()
        self.calls: list[tuple[int, int]] = []
        self.injected: list[tuple[int, int, str]] = []

    def _build(self, spec: Any, s: int, e: int) -> BaseException:
        if isinstance(spec, BaseException):
            return spec
        if isinstance(spec, type) and issubclass(spec, BaseException):
            return spec(f"injected loader fault at slab [{s}:{e})")
        return spec()

    def __call__(self, s: int, e: int) -> Any:
        with self._lock:
            self.calls.append((s, e))
            entry = self._faults.get(s)
            if entry is not None and entry[1] != 0:
                if entry[1] > 0:
                    entry[1] -= 1
                exc = self._build(entry[0], s, e)
                self.injected.append((s, e, type(exc).__name__))
                raise exc
        return self._loader(s, e)

    def loads_of(self, start: int) -> int:
        """How many times the slab at ``start`` was requested, fault firings
        included."""
        return sum(1 for (s, _e) in self.calls if s == start)


def misshaping_loader(loader: Callable[[int, int], Any], at: int,
                      shape: tuple) -> Callable[[int, int], Any]:
    """A loader that returns a wrong-shaped array for the slab starting at
    ``at``: the loader-contract check must raise a ``ValueError`` naming the
    slab range."""

    def bad(s: int, e: int) -> Any:
        out = np.asarray(loader(s, e))
        if s == at:
            return np.zeros(shape, out.dtype)
        return out

    return bad
