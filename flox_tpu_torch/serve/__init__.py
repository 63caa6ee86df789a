"""Groupby as a service: the serving front-end (the port of
``flox_tpu/serve/``).

The library below this package is call-at-a-time; a serving replica
amortizes dispatch, staging and admission decisions across requests:

* :mod:`.dispatcher` — the asyncio front-end on one device (CUDA unless the
  caller names the CPU): request coalescing (identical program and payload
  share one execution), micro-batching (compatible small payloads stack
  into one dispatch: one copy to the device, one kernel launch, one copy
  back), and admission control (bounded queue depth, per-request deadlines
  with cancellation, load shedding at saturation).
* :mod:`.aot` — the warmup manifest: every dispatch records its request
  spec, and a restarted replica replays them before it answers, against a
  warm kernel build directory with zero ``nvcc`` builds.
* :mod:`.breaker` — per-program circuit breakers: a program key whose
  dispatches keep failing fatally fast-fails at submit with a typed
  :class:`CircuitOpenError` until a half-open probe closes it.
* :mod:`.registry` — resident datasets: ``{"op": "put_dataset"}`` keeps
  named arrays on the device, factorized once at put time; requests that
  reference them skip JSON payloads, factorize and host-to-device copies.
  Budgeted, LRU-evicted (never mid-dispatch), restaged from host copies by
  device-loss recovery.
* :mod:`.stores` — the durable incremental aggregation stores
  (``flox_tpu_torch.store``) behind the ``append``/``query``/``compact``/
  ``list_stores`` ops.
* ``python -m flox_tpu_torch.serve`` — a JSON-lines request loop over the
  dispatcher (see :mod:`.__main__`).

The serve plane carries its own fault domain: request quarantine (a
poisoned micro-batch member fails alone), device-loss recovery (typed
:class:`DeviceLostError` to in-flight waiters, reinitialize, warmup replay,
restage, readiness flipped around the cycle), a dispatch watchdog
(:class:`WatchdogTimeoutError`), and graceful drain (SIGTERM or
``{"op": "shutdown"}`` answer in-flight requests and exit 0).
``faults.serve_inject`` drives it deterministically.

Per-request SLO metrics (``serve.queue_ms`` / ``serve.device_ms`` /
``serve.request_ms`` histograms, ``serve.*`` counters) flow through the
telemetry registry; serving state is visible in ``cache.stats()`` and reset
by ``cache.clear_all()``. The SLO plane's canary (``slo.canary_loop``,
``--canary-interval``) probes a dispatcher with known-answer requests, and
``fleet`` federates the ``/metrics`` of many serve loops.
"""

from __future__ import annotations

from . import aot, breaker, registry, stores
from .dispatcher import (
    AggregationRequest,
    CircuitOpenError,
    DeadlineExceededError,
    DeviceLostError,
    Dispatcher,
    DrainingError,
    LoadShedError,
    ServeError,
    ServeResult,
    WatchdogTimeoutError,
    payload_digest,
)
from .registry import UnknownDatasetError

__all__ = [
    "AggregationRequest",
    "CircuitOpenError",
    "DeadlineExceededError",
    "DeviceLostError",
    "Dispatcher",
    "DrainingError",
    "LoadShedError",
    "ServeError",
    "ServeResult",
    "UnknownDatasetError",
    "WatchdogTimeoutError",
    "aot",
    "breaker",
    "payload_digest",
    "registry",
    "stores",
]
