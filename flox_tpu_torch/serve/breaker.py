"""Per-program circuit breakers: fast-fail a key that keeps failing (the
port of ``flox_tpu/serve/breaker.py``).

A fatally-failing program key — a payload shape that trips a kernel's
guard, a custom option overlay that cannot run — fails every request sent at it,
and each failure burns a full admission + (attempted) device dispatch
before the waiter learns anything. After ``serve_breaker_threshold``
consecutive fatal failures on ONE program key its breaker opens: further
identical-program requests fail immediately at submit with a typed
:class:`~flox_tpu_torch.serve.dispatcher.CircuitOpenError` carrying the program
label and the cooldown remaining (``retry_after_ms``) — no dispatch, no
device time, and the queue stays clear for healthy programs. After
``serve_breaker_cooldown`` seconds the breaker admits ONE half-open probe
request; the probe's success closes the breaker (the key serves normally
again), its failure re-opens it for a fresh cooldown.

State lives in :data:`_BREAKER_REGISTRY` (program key -> :class:`_Breaker`),
registered in ``cache.clear_all`` / surfaced in ``cache.stats()`` and as the ``serve.breakers_open`` saturation gauge +
``serve.breaker_*`` counters on ``/metrics``. Only keys with a recorded
failure ever hold an entry — a healthy replica's registry is empty.
``serve_breaker_threshold = 0`` disables the whole mechanism.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any

from .. import options, telemetry
from ..telemetry import METRICS

__all__ = [
    "breaker_stats",
    "check",
    "open_breakers",
    "record_failure",
    "record_success",
    "release_probe",
]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Breaker:
    """Breaker state for one program key."""

    __slots__ = ("label", "failures", "state", "opened_at", "probing")

    def __init__(self, label: str) -> None:
        self.label = label
        self.failures = 0
        self.state = CLOSED
        self.opened_at = 0.0
        self.probing = False


#: program key -> breaker state; entries exist only for keys that recorded
#: at least one fatal failure (record_success pops the entry, so a healthy
#: replica's registry is empty). Registered in cache.clear_all (FLX008).
_BREAKER_REGISTRY: dict[tuple, _Breaker] = {}
_LOCK = threading.RLock()


def _threshold() -> int:
    return int(options.OPTIONS["serve_breaker_threshold"])


def _cooldown() -> float:
    return float(options.OPTIONS["serve_breaker_cooldown"])


def _breaker_id(key: tuple, label: str) -> str:
    digest = hashlib.blake2b(repr(key).encode(), digest_size=4).hexdigest()
    return f"{label}#{digest}"


def check(key: tuple, label: str) -> None:
    """Admission-time breaker gate for one program key.

    Returns normally for a closed (or absent, or disabled) breaker. For an
    open one inside its cooldown, raises ``CircuitOpenError`` carrying the
    program label and ``retry_after_ms`` — the fast-fail that spares the
    device. Past the cooldown the breaker goes half-open and THIS request
    becomes the probe (concurrent requests keep fast-failing until the
    probe's verdict lands via :func:`record_failure`/:func:`record_success`).
    """
    if not _threshold():
        return
    with _LOCK:
        breaker = _BREAKER_REGISTRY.get(key)
        if breaker is None or breaker.state == CLOSED:
            return
        now = time.monotonic()
        cooldown = _cooldown()
        if breaker.state == OPEN:
            remaining = breaker.opened_at + cooldown - now
            if remaining > 0:
                METRICS.inc("serve.breaker_fastfail")
                raise _open_error(key, breaker, remaining)
            breaker.state = HALF_OPEN
            breaker.probing = True
            METRICS.inc("serve.breaker_half_open")
            telemetry.event("breaker-half-open", program=breaker.label)
            return  # this request is the probe
        # HALF_OPEN: one probe at a time — a second arrival must not pile
        # onto a key whose probe has not answered yet
        if breaker.probing:
            METRICS.inc("serve.breaker_fastfail")
            raise _open_error(key, breaker, cooldown)
        breaker.probing = True


def _open_error(key: tuple, breaker: _Breaker, retry_after_s: float):
    from .dispatcher import CircuitOpenError

    retry_after_ms = max(0.0, retry_after_s) * 1e3
    return CircuitOpenError(
        f"circuit open for program {breaker.label!r} after "
        f"{breaker.failures} consecutive fatal failure(s); "
        f"retry in {retry_after_ms / 1e3:.3f}s",
        program=_breaker_id(key, breaker.label),
        retry_after_ms=retry_after_ms,
    )


def record_failure(key: tuple, label: str) -> None:
    """Count one fatal failure against ``key``; open (or re-open) the
    breaker when the consecutive-failure threshold is reached. Called by
    the dispatcher for fatal-classified dispatch failures and watchdog
    timeouts — never for transient/oom/load-control outcomes."""
    threshold = _threshold()
    if not threshold:
        return
    with _LOCK:
        breaker = _BREAKER_REGISTRY.setdefault(key, _Breaker(label))
        breaker.failures += 1
        if breaker.state == HALF_OPEN:
            # the probe failed: straight back to open, fresh cooldown
            breaker.state = OPEN
            breaker.opened_at = time.monotonic()
            breaker.probing = False
            METRICS.inc("serve.breaker_reopened")
            telemetry.event("breaker-reopen", program=breaker.label)
        elif breaker.state == CLOSED and breaker.failures >= threshold:
            breaker.state = OPEN
            breaker.opened_at = time.monotonic()
            METRICS.inc("serve.breaker_opened")
            telemetry.event(
                "breaker-open", program=breaker.label, failures=breaker.failures
            )
        _publish_gauge()


def release_probe(key: tuple) -> None:
    """The in-flight half-open probe ended WITHOUT a verdict — its dispatch
    outcome was neither a success nor a fatal failure (transient-classified
    error, batch abandoned with every waiter expired, device loss). Re-arm
    the probe slot so the NEXT request becomes the probe; without this the
    breaker would stay half-open with ``probing=True`` forever and
    fast-fail the key permanently."""
    with _LOCK:
        b = _BREAKER_REGISTRY.get(key)
        if b is not None and b.state == HALF_OPEN and b.probing:
            b.probing = False


def record_success(key: tuple) -> None:
    """One successful dispatch on ``key``: the failure streak is over.
    Closes a half-open breaker (the probe succeeded) and drops the entry —
    the registry only tracks failing keys."""
    with _LOCK:
        breaker = _BREAKER_REGISTRY.pop(key, None)
        if breaker is not None and breaker.state != CLOSED:
            METRICS.inc("serve.breaker_closed")
            telemetry.event("breaker-close", program=breaker.label)
        if breaker is not None:
            _publish_gauge()


def _publish_gauge() -> None:
    """The live open-breaker count as a gauge (callers hold ``_LOCK``)."""
    if telemetry.enabled():
        METRICS.set_gauge(
            "serve.breakers_open",
            sum(1 for b in _BREAKER_REGISTRY.values() if b.state != CLOSED),
        )


def open_breakers() -> dict[str, dict[str, Any]]:
    """Every breaker currently open or half-open:
    ``{label#digest: {state, failures, retry_after_ms}}`` — the operator's
    answer to "which programs are being fast-failed right now"."""
    now = time.monotonic()
    cooldown = _cooldown()
    out: dict[str, dict[str, Any]] = {}
    with _LOCK:
        for key, breaker in _BREAKER_REGISTRY.items():
            if breaker.state == CLOSED:
                continue
            remaining = (
                max(0.0, breaker.opened_at + cooldown - now)
                if breaker.state == OPEN
                else 0.0
            )
            out[_breaker_id(key, breaker.label)] = {
                "state": breaker.state,
                "failures": breaker.failures,
                "retry_after_ms": round(remaining * 1e3, 3),
            }
    return out


def breaker_stats() -> dict[str, Any]:
    """The ``cache.stats()["serve_breakers"]`` panel: entry counts per
    state plus the open/half-open detail of :func:`open_breakers`."""
    with _LOCK:
        states = [b.state for b in _BREAKER_REGISTRY.values()]
    return {
        "total": len(states),
        "open": states.count(OPEN),
        "half_open": states.count(HALF_OPEN),
        "tripped": open_breakers(),
    }
