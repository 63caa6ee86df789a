"""Deterministic fault injection for the streaming executor (the port of
``flox_tpu/faults.py``).

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

* :func:`slo_inject` installs an SLO plan: a synthetic clock
  (:func:`slo_now`), synthetic SLI events (:func:`slo_injected`) and
  corrupted canary answers (:func:`slo_canary_corrupt`), so the burn-rate
  windows and the alert state machine of :mod:`.slo` run without sleeps;
* :func:`stress_schedule` runs a body under an adversarial thread schedule
  (a ~1 µs switch interval) and, for the modules it watches, checks every
  acquire of their module-level locks against the observed lock order.

Everything is index-deterministic: the same plan against the same stream
fires at the same slabs in the same order, prefetch on or off; a serve or
store plan fires at the same dispatch or write numbers.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np

__all__ = [
    "FlakyLoader",
    "LockOrderViolation",
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
    "slo_active",
    "slo_canary_corrupt",
    "slo_inject",
    "slo_injected",
    "slo_now",
    "store_active",
    "store_inject",
    "store_poke",
    "stress_schedule",
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


@dataclass
class _SLOPlan:
    """One installed SLO-plane injection plan: a controllable clock plus
    synthetic SLI events, so the multi-window burn-rate math and the alert
    state machine (``flox_tpu_torch.slo``) are testable without wall-clock
    sleeps. Consulted by ``slo._now`` (clock), ``slo._collect``
    (synthetic events) and the canary's bit-exact compare
    (``corrupt_canary`` — the injected wrong answer CI proves is caught)."""

    #: the plan's synthetic "now" (seconds); ``advance`` moves it forward.
    #: None leaves the real clock in charge (events-only plans)
    clock: float | None = None
    #: objective name -> [good, bad] cumulative synthetic SLI events,
    #: added on top of the real collectors by ``slo._collect``
    events: dict = field(default_factory=dict)
    #: canary op name (or "*") -> how many of its next comparisons to
    #: corrupt (-1 = every one)
    corrupt_canary: dict = field(default_factory=dict)
    #: ("burst"|"advance"|"corrupt", ...) per consulted event, in order
    log: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def advance(self, seconds: float) -> float:
        """Move the synthetic clock forward; returns the new now."""
        with self._lock:
            if self.clock is None:
                raise ValueError("slo_inject plan has no clock (pass clock0=)")
            self.clock += float(seconds)
            self.log.append(("advance", float(seconds), self.clock))
            return self.clock

    def burst(self, objective: str, *, good: int = 0, bad: int = 0) -> None:
        """Add synthetic SLI events to ``objective``'s cumulative totals
        (they appear in every evaluation until the plan is uninstalled —
        uninstalling makes counters drop, which the window math clamps
        to zero burn, i.e. the incident ends)."""
        with self._lock:
            slot = self.events.setdefault(str(objective), [0, 0])
            slot[0] += int(good)
            slot[1] += int(bad)
            self.log.append(("burst", str(objective), int(good), int(bad)))


_SLO_PLAN: _SLOPlan | None = None


def slo_active() -> bool:
    return _SLO_PLAN is not None


def slo_now() -> float | None:
    """The installed plan's synthetic clock, or None when the real clock
    is in charge (no plan, or a plan without ``clock0``)."""
    plan = _SLO_PLAN
    if plan is None:
        return None
    with plan._lock:
        return plan.clock


def slo_injected(objective: str) -> tuple[int, int]:
    """Cumulative synthetic (good, bad) events for ``objective`` from the
    installed plan; (0, 0) with no plan."""
    plan = _SLO_PLAN
    if plan is None:
        return (0, 0)
    with plan._lock:
        slot = plan.events.get(str(objective))
        return (int(slot[0]), int(slot[1])) if slot else (0, 0)


def slo_canary_corrupt(op: str) -> bool:
    """Canary-corruption hook: True tells the prober's compare to perturb
    the received result (simulating silent wrong-answer corruption).
    Budgeted per op name ("*" matches any); -1 corrupts every compare."""
    plan = _SLO_PLAN
    if plan is None:
        return False
    with plan._lock:
        key = str(op) if str(op) in plan.corrupt_canary else "*"
        times = plan.corrupt_canary.get(key, 0)
        if times == 0:
            return False
        if times > 0:
            plan.corrupt_canary[key] = times - 1
        plan.log.append(("corrupt", str(op)))
        return True


@contextlib.contextmanager
def slo_inject(
    *,
    clock0: float | None = None,
    corrupt_canary: dict | tuple | list | None = None,
) -> Iterator[_SLOPlan]:
    """Install a deterministic SLO-plane injection plan for the scope.

    ``clock0`` seeds the synthetic clock ``slo.evaluate`` reads (advance
    it with ``plan.advance(seconds)`` to walk burn-rate windows without
    sleeping); ``corrupt_canary`` maps canary op names to how many of
    their next bit-exact compares to corrupt (a bare tuple/list corrupts
    each named op once; -1 = every compare). Synthetic SLI events are
    added with ``plan.burst(objective, good=..., bad=...)``. Yields the
    plan; its ``log`` records every consulted event in order.
    """
    global _SLO_PLAN
    plan = _SLOPlan(clock=float(clock0) if clock0 is not None else None)
    if corrupt_canary:
        if isinstance(corrupt_canary, dict):
            plan.corrupt_canary = {str(k): int(v) for k, v in corrupt_canary.items()}
        else:
            plan.corrupt_canary = {str(op): 1 for op in corrupt_canary}
    prev = _SLO_PLAN
    _SLO_PLAN = plan
    try:
        yield plan
    finally:
        _SLO_PLAN = prev


# ---------------------------------------------------------------------------
# schedule-stress race harness
# ---------------------------------------------------------------------------


class LockOrderViolation(AssertionError):
    """An acquire completed a cycle in the observed lock acquisition order
    (or re-entered a non-reentrant lock on its own thread) — the static
    shape a static lock-order check flags, caught live at the acquire that
    closed it."""


_LOCK_TYPE = type(threading.Lock())
_RLOCK_TYPE = type(threading.RLock())


def _caller_site() -> str:
    """``path:line`` of the nearest frame outside this module — the acquire
    site a violation message points at."""
    frame = sys._getframe(2)
    while frame is not None and frame.f_globals.get("__name__") == __name__:
        frame = frame.f_back
    if frame is None:  # pragma: no cover - only when called at module top
        return "<unknown>"
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


class _LockOrderWatcher:
    """Cumulative acquisition-order graph fed by every proxied acquire.

    Each thread keeps a stack of proxied locks it holds; acquiring ``L``
    while holding ``H`` records the edge ``H -> L``. An acquire whose new
    edges would make the graph cyclic raises :class:`LockOrderViolation`
    *before* blocking on the underlying lock — the test fails with both
    witness sites instead of deadlocking the suite. Seeding with floxlint's
    ``--lock-graph`` JSON makes the static edges count as already-observed,
    so one runtime acquire against the static order is enough to fail."""

    def __init__(self, seed_edges: dict[tuple[str, str], str] | None = None):
        self._mu = threading.Lock()
        #: (held, acquired) -> first witness site ("path:line")
        self.edges: dict[tuple[str, str], str] = dict(seed_edges or {})
        self._tls = threading.local()

    # -- per-thread held stack ----------------------------------------------

    def _held(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    # -- graph --------------------------------------------------------------

    def _path(self, src: str, dst: str) -> list[str] | None:
        """One ``src -> … -> dst`` node path over current edges, or None."""
        parent: dict[str, str | None] = {src: None}
        frontier = [src]
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        while frontier:
            cur = frontier.pop()
            if cur == dst:
                out = [cur]
                while parent[out[-1]] is not None:
                    out.append(parent[out[-1]])
                return out[::-1]
            for nxt in adj.get(cur, ()):
                if nxt not in parent:
                    parent[nxt] = cur
                    frontier.append(nxt)
        return None

    def before_acquire(self, name: str, reentrant: bool, site: str) -> None:
        held = self._held()
        if name in held:
            if reentrant:
                return
            raise LockOrderViolation(
                f"non-reentrant lock {name} re-acquired at {site} by the "
                "thread already holding it — guaranteed self-deadlock"
            )
        with self._mu:
            for h in held:
                if (h, name) in self.edges:
                    continue
                cycle = self._path(name, h)
                if cycle is not None:
                    ring = " -> ".join(cycle + [name])
                    first = self.edges.get(
                        (cycle[0], cycle[1]), "<seed>"
                    ) if len(cycle) > 1 else "<seed>"
                    raise LockOrderViolation(
                        f"lock-order inversion: acquiring {name} at {site} "
                        f"while holding {h}, but the established order is "
                        f"{ring} (first observed at {first}) — pick one "
                        "global order"
                    )
                self.edges[(h, name)] = site

    def after_acquire(self, name: str) -> None:
        self._held().append(name)

    def after_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return


class _OrderedLockProxy:
    """Drop-in wrapper for a module-level ``Lock``/``RLock`` that feeds the
    watcher on every acquire/release. Delegates to the wrapped lock, so
    code holding the raw lock across the wrap/unwrap boundary stays
    correct — the proxy and the original contend on the same object."""

    def __init__(
        self,
        inner: Any,
        name: str,
        watcher: _LockOrderWatcher,
        reentrant: bool,
    ) -> None:
        self._inner = inner
        self._name = name
        self._watcher = watcher
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._watcher.before_acquire(self._name, self._reentrant, _caller_site())
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._watcher.after_acquire(self._name)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._watcher.after_release(self._name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_OrderedLockProxy":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<_OrderedLockProxy {self._name} of {self._inner!r}>"


def _seed_edges_from(order_graph: Any) -> dict[tuple[str, str], str]:
    """Accept floxlint's ``--lock-graph`` JSON (a dict, or a path to one)
    and return its edge table keyed the way the watcher keys it."""
    data = order_graph
    if isinstance(order_graph, (str, bytes)) or hasattr(order_graph, "read_text"):
        import json

        with open(order_graph) as fh:
            data = json.load(fh)
    out: dict[tuple[str, str], str] = {}
    for edge in data.get("edges", []):
        out[(str(edge["from"]), str(edge["to"]))] = str(edge.get("site", "<static>"))
    return out


@contextlib.contextmanager
def stress_schedule(
    switch_interval: float = 1e-6,
    watch: tuple[str, ...] = (),
    order_graph: Any = None,
) -> Iterator[_LockOrderWatcher | None]:
    """Run the body under an adversarial thread schedule.

    Drops ``sys.setswitchinterval`` to ``switch_interval`` (default ~1 µs:
    a potential preemption every few bytecodes, so the race windows the
    default 5 ms interval hides get hit within one test run) and restores
    it on exit. When ``watch`` names modules (``"flox_tpu_torch.telemetry"``,
    …), their module-level ``Lock``/``RLock`` attributes are wrapped in
    :class:`_OrderedLockProxy` for the duration: every acquire feeds a
    cumulative acquisition-order graph and an acquire that would complete
    a cycle — or re-enter a plain ``Lock`` on its own thread — raises
    :class:`LockOrderViolation` *before* blocking, so the suite fails
    with both witness sites instead of deadlocking. ``order_graph``
    optionally seeds the graph with floxlint's ``--lock-graph`` JSON
    (dict or path), making one runtime acquire against the static order
    sufficient to fail. Yields the watcher (None when nothing is
    watched); instance-attribute locks (``self._lock``) are out of scope.
    """
    import importlib

    watcher: _LockOrderWatcher | None = None
    if watch or order_graph is not None:
        seed = _seed_edges_from(order_graph) if order_graph is not None else None
        watcher = _LockOrderWatcher(seed)
    wrapped: list[tuple[Any, str, Any]] = []
    if watcher is not None:
        for mod_name in watch:
            mod = importlib.import_module(mod_name)
            for attr, value in list(vars(mod).items()):
                if isinstance(value, (_LOCK_TYPE, _RLOCK_TYPE)):
                    proxy = _OrderedLockProxy(
                        value,
                        f"{mod_name}.{attr}",
                        watcher,
                        isinstance(value, _RLOCK_TYPE),
                    )
                    setattr(mod, attr, proxy)
                    wrapped.append((mod, attr, value))
    prev = sys.getswitchinterval()
    sys.setswitchinterval(float(switch_interval))
    try:
        yield watcher
    finally:
        sys.setswitchinterval(prev)
        for mod, attr, value in wrapped:
            setattr(mod, attr, value)
