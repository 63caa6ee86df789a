"""Shared metric-name constants (the port's own copy of
``flox_tpu/metric_names.py``): the registry names the telemetry plane emits
(``telemetry.METRICS``) and their one Prometheus respelling
(:func:`prom_name`: the ``flox_tpu_`` prefix, non-identifier characters
folded to ``_``, counters suffixed ``_total``). Consumers import these
constants instead of respelling the names inline, so the names the port
emits and the names a scraper reads cannot drift apart, and they are the
reference's names, so one dashboard reads both packages.
"""

from __future__ import annotations

import re

# -- serve request path (counters unless noted) ------------------------------

SERVE_REQUESTS = "serve.requests"
SERVE_REQUEST_MS = "serve.request_ms"  # histogram
SERVE_QUEUE_MS = "serve.queue_ms"  # histogram
SERVE_DEVICE_MS = "serve.device_ms"  # histogram
SERVE_SHED = "serve.shed"
SERVE_DEADLINE_EXCEEDED = "serve.deadline_exceeded"
SERVE_ERRORS = "serve.errors"

# -- resilience (breakers / device loss / watchdog) --------------------------

SERVE_BREAKER_FASTFAIL = "serve.breaker_fastfail"
SERVE_BREAKERS_OPEN = "serve.breakers_open"  # gauge
SERVE_DEVICE_LOST = "serve.device_lost"
SERVE_WATCHDOG_FIRED = "serve.watchdog_fired"
SERVE_QUEUE_DEPTH = "serve.queue_depth"  # gauge

# -- saturation / residency gauges ------------------------------------------

HBM_BYTES_IN_USE = "hbm.bytes_in_use"  # gauge
HBM_BYTES_LIMIT = "hbm.bytes_limit"  # gauge

# -- canary probes (slo.py both emits and reads these) -----------------------

CANARY_PROBES = "canary.probes"
CANARY_OK = "canary.ok"
CANARY_FAILURES = "canary.failures"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str, *, counter: bool = False) -> str:
    """The Prometheus spelling of a registry ``name`` — identical folding
    to the exposition renderer, so scrape consumers and the renderer can
    never drift: ``prom_name(SERVE_REQUESTS, counter=True)`` ->
    ``"flox_tpu_serve_requests_total"``."""
    return "flox_tpu_" + _NAME_BAD.sub("_", name) + ("_total" if counter else "")
