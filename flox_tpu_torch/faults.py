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
* :func:`misshaping_loader` breaks the loader's shape contract at one slab;
* :func:`dispatch_delay_inject` slows the dispatches of chosen program
  labels (``core.chunk_reduce`` consults :func:`dispatch_delay_poke`), so
  that their observed device time really diverges from the cost card's
  model (the drift sentinel's tests).

* :func:`serve_inject` installs a serve plan that the serving dispatcher
  consults just before each dispatch (:func:`serve_poke`): poisoned
  payloads, failing programs, a device loss or a hang at chosen dispatch
  numbers (quarantine, breakers, recovery, the watchdog);
* :func:`store_inject` installs a store plan that the durable store's write
  funnel consults before each durable write (:func:`store_poke`): a kill, a
  torn write or a flipped bit at chosen write ordinals (the recovery matrix).

Everything is index-deterministic: the same plan against the same stream
fires at the same slabs in the same order, prefetch on or off; a serve or
store plan fires at the same dispatch or write numbers.

Left out until their modules are ported (ROADMAP A9.5): the SLO plan and the
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
    "SimulatedCompileError",
    "SimulatedDeviceLoss",
    "SimulatedOOM",
    "StoreWriteKilled",
    "StreamKilled",
    "active",
    "dispatch_delay_active",
    "dispatch_delay_inject",
    "dispatch_delay_poke",
    "inject",
    "misshaping_loader",
    "poke",
    "serve_active",
    "serve_inject",
    "serve_poke",
    "store_active",
    "store_inject",
    "store_poke",
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


class SimulatedCompileError(RuntimeError):
    """A dispatch that fails the same way every time: classified fatal (no
    status token), never retried or split; the substrate of the quarantine
    and circuit-breaker tests."""

    def __init__(self, where: str = "") -> None:
        super().__init__(f"INVALID_PROGRAM (simulated): compile failed {where}".rstrip())


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


# ---------------------------------------------------------------------------
# dispatch-delay injection: the drift sentinel's substrate
# ---------------------------------------------------------------------------


@dataclass
class _DelayPlan:
    """A deterministic dispatch slowdown: program labels containing
    ``substr`` sleep ``seconds`` before their dispatch, ``times`` times (-1:
    always)."""

    substr: str = ""
    seconds: float = 0.0
    times: int = -1
    fired: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)


_DELAY_PLAN: _DelayPlan | None = None


def dispatch_delay_active() -> bool:
    return _DELAY_PLAN is not None


def dispatch_delay_poke(label: str) -> None:
    """Dispatch-side hook: ``core.chunk_reduce`` calls it inside the timed
    dispatch with its program label. A no-op unless a plan is installed."""
    plan = _DELAY_PLAN
    if plan is None or plan.substr not in str(label):
        return
    with plan._lock:
        if plan.times == 0:
            return
        if plan.times > 0:
            plan.times -= 1
        plan.fired += 1
        seconds = plan.seconds
    import time

    time.sleep(seconds)


@contextlib.contextmanager
def dispatch_delay_inject(substr: str, seconds: float, *, times: int = -1) -> Iterator[_DelayPlan]:
    """Install a dispatch-delay plan for the scope: every dispatch whose
    program label contains ``substr`` sleeps ``seconds`` first, ``times``
    times (-1: for the whole scope). Yields the plan; ``fired`` counts the
    delays."""
    global _DELAY_PLAN
    plan = _DelayPlan(substr=str(substr), seconds=float(seconds), times=int(times))
    prev = _DELAY_PLAN
    _DELAY_PLAN = plan
    try:
        yield plan
    finally:
        _DELAY_PLAN = prev


# ---------------------------------------------------------------------------
# the serve plan: faults at the serving dispatcher's dispatches
# ---------------------------------------------------------------------------


@dataclass
class _ServePlan:
    """One installed serve plan and its log. ``Dispatcher._execute`` consults
    it through :func:`serve_poke` just before each dispatch."""

    #: payload digest -> fault: a dispatch whose leaves include the digest
    #: raises, so the quarantine's bisection meets it until it runs alone
    poison: dict[str, _Fault] = field(default_factory=dict)
    #: program func label -> fault
    fail_compile: dict[str, _Fault] = field(default_factory=dict)
    #: 1-based dispatch numbers that raise SimulatedDeviceLoss
    device_loss_at: frozenset = frozenset()
    #: 1-based dispatch numbers that sleep ``hang_seconds`` first
    hang_at: frozenset = frozenset()
    hang_seconds: float = 1.0
    dispatches: int = 0
    #: (kind | None, label, dispatch number) per dispatch, in order
    log: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)


_SERVE_PLAN: _ServePlan | None = None


def serve_active() -> bool:
    return _SERVE_PLAN is not None


def serve_poke(label: str, digests: tuple = ()) -> None:
    """The dispatcher's hook, called with the program's func label and the
    payload digests of the leaves it dispatches. No-op unless a plan is
    installed. A hang sleeps outside the plan's lock, so a concurrent
    dispatch is never held by it."""
    plan = _SERVE_PLAN
    if plan is None:
        return
    hang = 0.0
    with plan._lock:
        plan.dispatches += 1
        n = plan.dispatches
        for digest in digests:
            fault = plan.poison.get(digest)
            if fault is not None and fault.times != 0:
                if fault.times > 0:
                    fault.times -= 1
                plan.log.append(("poison", label, n))
                raise fault.exc(f"poisoned member {digest[:8]} in dispatch #{n}")
        fault = plan.fail_compile.get(label)
        if fault is not None and fault.times != 0:
            if fault.times > 0:
                fault.times -= 1
            plan.log.append(("fail-compile", label, n))
            raise fault.exc(f"for program {label!r} at dispatch #{n}")
        if n in plan.device_loss_at:
            plan.log.append(("device-loss", label, n))
            raise SimulatedDeviceLoss(f"at dispatch #{n}")
        if n in plan.hang_at:
            plan.log.append(("hang", label, n))
            hang = plan.hang_seconds
        else:
            plan.log.append((None, label, n))
    if hang > 0:
        import time

        time.sleep(hang)


@contextlib.contextmanager
def serve_inject(
    *,
    poison_digests: tuple[str, ...] | list[str] = (),
    poison_times: int = -1,
    fail_compile_for: tuple[str, ...] | list[str] = (),
    fail_times: int = -1,
    device_loss_at: tuple[int, ...] | list[int] = (),
    hang_at: tuple[int, ...] | list[int] = (),
    hang_seconds: float = 1.0,
) -> Iterator[_ServePlan]:
    """Install a serve plan for the scope.

    ``poison_digests``: payload digests (``serve.payload_digest`` of a
    request's array) whose every dispatch raises
    :class:`SimulatedCompileError`, ``poison_times`` times (-1: always).
    ``fail_compile_for``: program func labels whose dispatches raise it
    ``fail_times`` times. ``device_loss_at``: 1-based dispatch numbers that
    raise :class:`SimulatedDeviceLoss`. ``hang_at``: dispatch numbers that
    sleep ``hang_seconds`` before they run. Yields the plan; its ``log``
    records every dispatch.
    """
    global _SERVE_PLAN
    plan = _ServePlan(
        device_loss_at=frozenset(int(n) for n in device_loss_at),
        hang_at=frozenset(int(n) for n in hang_at),
        hang_seconds=float(hang_seconds),
    )
    for d in poison_digests:
        plan.poison[str(d)] = _Fault(SimulatedCompileError, poison_times)
    for label in fail_compile_for:
        plan.fail_compile[str(label)] = _Fault(SimulatedCompileError, fail_times)
    prev = _SERVE_PLAN
    _SERVE_PLAN = plan
    try:
        yield plan
    finally:
        _SERVE_PLAN = prev


# ---------------------------------------------------------------------------
# the store plan: faults at the durable store's writes
# ---------------------------------------------------------------------------


class StoreWriteKilled(RuntimeError):
    """A simulated ``kill -9`` inside a durable store write: the process
    "dies" leaving whatever bytes the injected action put on disk. The store
    never catches it; a test reopens the directory and checks recovery."""

    def __init__(self, where: str = "") -> None:
        super().__init__(f"store write killed (simulated crash) {where}".rstrip())


@dataclass
class _StorePlan:
    """One installed store plan and its log. The store's write funnel
    consults it through :func:`store_poke` once per durable write (a journal
    append, a segment landing, a compaction's delete), in write order."""

    #: 1-based write ordinals that die before any byte lands
    kill_at: frozenset = frozenset()
    #: ordinals that land half their bytes at the final path, then die
    torn_at: frozenset = frozenset()
    #: ordinals that land every byte with one bit flipped, silently
    flip_at: frozenset = frozenset()
    #: count only this kind ("journal", "segment" or "swap"); None: all
    op: str | None = None
    writes: int = 0
    #: (action | None, kind, file name, ordinal) per counted write, in order
    log: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)


_STORE_PLAN: _StorePlan | None = None


def store_active() -> bool:
    return _STORE_PLAN is not None


def store_poke(kind: str, path: str) -> str | None:
    """The store's hook before each durable write: ``None`` (write as
    usual), ``"kill"`` (raise before any byte), ``"torn"`` (land half the
    bytes at the final path, then raise) or ``"flip"`` (land every byte with
    one bit flipped). The write site does the raising and the mangling, so
    they happen where a real write would."""
    import os

    plan = _STORE_PLAN
    if plan is None:
        return None
    with plan._lock:
        if plan.op is not None and plan.op != kind:
            return None
        plan.writes += 1
        n = plan.writes
        action = None
        if n in plan.kill_at:
            action = "kill"
        elif n in plan.torn_at:
            action = "torn"
        elif n in plan.flip_at:
            action = "flip"
        plan.log.append((action, kind, os.path.basename(str(path)), n))
        return action


@contextlib.contextmanager
def store_inject(
    *,
    kill_at: tuple[int, ...] | list[int] = (),
    torn_at: tuple[int, ...] | list[int] = (),
    flip_at: tuple[int, ...] | list[int] = (),
    op: str | None = None,
) -> Iterator[_StorePlan]:
    """Install a store plan for the scope.

    Ordinals are 1-based positions in the store's sequence of durable writes
    (journal appends, segment landings, compaction deletes), counted across
    the scope; ``op`` counts only one kind. ``kill_at`` dies before any byte
    lands, ``torn_at`` lands half a file at the final path, ``flip_at``
    lands a silent one-bit flip that only the checksum at the next open
    sees. Yields the plan; its ``log`` records every counted write.
    """
    global _STORE_PLAN
    plan = _StorePlan(
        kill_at=frozenset(int(n) for n in kill_at),
        torn_at=frozenset(int(n) for n in torn_at),
        flip_at=frozenset(int(n) for n in flip_at),
        op=op,
    )
    prev = _STORE_PLAN
    _STORE_PLAN = plan
    try:
        yield plan
    finally:
        _STORE_PLAN = prev
