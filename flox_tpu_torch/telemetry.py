"""End-to-end telemetry: hierarchical spans, a metrics registry, a cost
ledger with device time, and the exporters (the port of
``flox_tpu/telemetry.py``).

* **Hierarchical spans** (:func:`span`): a contextvar-based tracer. Every
  entry point opens a root span (``groupby_reduce``, ``groupby_scan``,
  ``streaming_groupby_reduce``, ...) whose children are its phases:
  ``factorize`` / ``dispatch`` / ``combine`` / ``finalize`` eagerly,
  ``program-build``, ``program`` and ``combine`` on a mesh, one
  ``stream[...]`` span per streaming pass. Below them the port's own
  steps: ``bins`` (the codes binned for a hand-written kernel),
  ``launch`` (the kernel itself, with the bytes it must move and, for the
  segment-sum, multi-statistic and min/max kernels, the ``window`` of
  their walk; the ``kernels.window_launches`` counter, and
  ``kernels.mean_finalize_launches`` for the mean finalize), ``matmul`` (the
  one-hot GEMM's block loop, with its shape, dtype, blocks and the data's
  bytes; the ``kernels.matmul_blocks`` counter), ``legs``
  (the elementwise passes after a kernel or a mesh combine returns) and
  ``collective`` (one collective of the mesh, with its bytes; the
  ``mesh.collectives`` and ``mesh.collective_bytes`` counters). While a
  ``torch.profiler`` records, every span is also a ``record_function``
  range of the profiler's trace. Disabled (the default) it is a true no-op:
  :func:`span` returns one shared singleton, nothing is allocated, no clock
  is read and no profiler is touched.
* **Metrics registry** (:data:`METRICS`): process-wide counters, gauges and
  log-spaced histograms (host-to-device bytes, retries, OOM splits,
  checkpoints, per-phase latency).
* **Cost ledger** (:func:`observe_cost`): per program label (the dispatch
  site's ``bundle[nanmean]``, ``fused[...]``, ``mesh[...]``,
  ``stream[...]``), the dispatches, device time, bytes and peak device
  memory. On the card a dispatch site brackets its launches with a pair of
  CUDA events (:func:`device_timer`), and the ledger reads them lazily: when
  it is read, at :func:`flush` and at export, never on the dispatch path,
  so the host never waits for the card there. On the CPU the device time is
  the dispatch's host wall, as in the reference.
* **Exporters**: JSON-lines (:func:`export_jsonl`) and Chrome trace-event
  JSON (:func:`export_chrome_trace`, loadable in ``ui.perfetto.dev``); with
  ``set_options(telemetry_export_path=...)`` finished records stream to the
  path. ``python -m flox_tpu_torch.telemetry report <file>`` prints the
  per-phase summary of either format; ``costs`` and ``programs`` print the
  ledger and the cost cards (:mod:`.costmodel`).
* **Request tracing** (:func:`trace`) with W3C ``traceparent`` parsing and
  formatting, and tail-based detail sampling at ``telemetry_level="basic"``.
* **Device memory** (:func:`sample_hbm`): ``device.memory_stats()`` (the
  caching allocator's counters) around dispatches; a no-op on the CPU.
* **Flight recorder** (:data:`FLIGHT_RECORDER`, :func:`flight_dump`): a
  bounded ring of recent records, dumped atomically as JSON-lines to
  ``flight_recorder_path`` on a fatal stream fault
  (``resilience.classify_error``) and on SIGTERM/SIGUSR2
  (:func:`install_signal_dumps`).

The reference's ``jax.monitoring`` compile listener (the ``jax.compiles``,
``jax.traces`` and ``jax.compile_ms`` counters, ``card_compile_accounting``)
has no counterpart: the port compiles no programs. The flight dump and the
saturation sampler carry the serving plane's state (breakers, queue depth,
open batches, the dataset registry and the stores) and the SLO plane's alert
state. ``python -m flox_tpu_torch.telemetry slo`` tabulates a ``/slo``
payload (exit 2 while an alert fires), and ``serve-metrics`` is a
standalone ``/metrics`` endpoint (``exposition``).

Knobs: ``telemetry`` (``FLOX_TPU_TELEMETRY``), ``telemetry_level``
(``FLOX_TPU_TELEMETRY_LEVEL``), ``telemetry_export_path``
(``FLOX_TPU_TELEMETRY_EXPORT_PATH``). Instrumentation never changes
results (``tests/test_torch_telemetry.py`` holds enabled against disabled
bit for bit).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import math
import os
import re
import sys
import threading
import time
from collections import deque
from typing import Any, Iterable

__all__ = [
    "CANARY_TENANT",
    "FLIGHT_RECORDER",
    "HIST_EDGES_MS",
    "METRICS",
    "RESIDENT_GAUGES",
    "SATURATION_GAUGES",
    "MetricsRegistry",
    "anchor_event",
    "cost_by_dataset",
    "cost_by_program",
    "cost_by_tenant",
    "count",
    "current_trace",
    "device_timer",
    "current_trace_parent",
    "detailed",
    "drain",
    "enabled",
    "event",
    "export_chrome_trace",
    "export_jsonl",
    "flight_dump",
    "flush",
    "format_traceparent",
    "host_name",
    "install_signal_dumps",
    "new_span_hex",
    "observe_cost",
    "parse_traceparent",
    "profile_call",
    "record_serve_error",
    "record_span",
    "replica_id",
    "replica_instance",
    "reset",
    "sample_hbm",
    "sample_resident_state",
    "sample_saturation",
    "seed_hbm_limit",
    "seed_saturation_gauges",
    "span",
    "spans",
    "start_saturation_sampler",
    "stop_saturation_sampler",
    "tail_detail",
    "trace",
]

# perf_counter origin for span timestamps; the wall anchor lets exports
# carry an absolute start time without re-reading two clocks per span
_EPOCH = time.perf_counter()
_WALL0 = time.time()

_PID = os.getpid()

# short host name (label-sanitized): the `host` half of the replica identity
# every export stamp carries
try:
    import socket

    _HOST = re.sub(r"[^A-Za-z0-9_.:\-]", "_", socket.gethostname().split(".")[0]) or "?"
except Exception:  # noqa: BLE001 — identity must never break import
    _HOST = "?"


def host_name() -> str:
    """This process's short, label-safe host name."""
    return _HOST


def replica_id() -> str | None:
    """The configured replica identity (``OPTIONS["replica_id"]`` /
    ``FLOX_TPU_REPLICA_ID``), or ``None`` on an unconfigured single-replica
    process — the fleet surfaces (metric labels, export stamps) activate
    only when one is set, so solo deployments stay byte-identical."""
    from .options import OPTIONS

    return OPTIONS["replica_id"]


def replica_instance() -> str:
    """A process-unique replica name: the configured ``replica_id`` when
    set, else a stable per-process fallback (``p<pid>``). Request-id
    generation and the trace-join export stamps use THIS — two replicas an
    operator forgot to name must still never collide."""
    return replica_id() or f"p{_PID}"


def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` world (0 outside
    one), stamped into export tails so that one mesh run's files order
    their tracks."""
    from .parallel.mesh import world_rank

    return world_rank()

#: buffer cap — a runaway instrumented loop must degrade (drop + count),
#: never hold the process's memory hostage
_MAX_RECORDS = 200_000


def enabled() -> bool:
    """Whether telemetry is on (``OPTIONS["telemetry"]``)."""
    from .options import OPTIONS

    return bool(OPTIONS["telemetry"])


def detailed() -> bool:
    """Whether per-slab / per-kernel detail is on (level ``"detailed"``).

    Counter sites gate on this. It stays a strict level check on purpose:
    counters cannot be retracted, so a tail-sampled trace must not inflate
    detailed-only counters (``kernel.trace.*``) — record sites that WANT
    tail sampling gate on :func:`tail_detail` instead."""
    from .options import OPTIONS

    return bool(OPTIONS["telemetry"]) and OPTIONS["telemetry_level"] == "detailed"


def tail_detail() -> bool:
    """Whether detailed-level RECORDS should be produced: level
    ``"detailed"``, or a live :func:`trace` context at ``"basic"`` — there
    the records are parked per trace (``detail=True``) and kept only when
    the trace blows its running p99, so producing them is free for fast
    requests. Records only; counter sites use :func:`detailed`."""
    from .options import OPTIONS

    if not OPTIONS["telemetry"]:
        return False
    return OPTIONS["telemetry_level"] == "detailed" or _TRACE.get() is not None


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


#: fixed log-spaced histogram bucket edges (upper bounds), shared by every
#: histogram: 1 µs .. ~9 min in ms, factor 2 per bucket. Fixed-and-shared is
#: what makes histograms mergeable across processes and exports — the
#: report CLI relies on it.
HIST_EDGES_MS: tuple[float, ...] = tuple(0.001 * 2.0**i for i in range(30))


def _hist_bucket(value_ms: float) -> int:
    """Index of the first bucket whose upper edge holds ``value_ms`` (the
    last bucket absorbs overflow)."""
    for i, edge in enumerate(HIST_EDGES_MS):
        if value_ms <= edge:
            return i
    return len(HIST_EDGES_MS) - 1


class MetricsRegistry:
    """Process-wide counters, gauges and histograms, thread-safe.

    Counters only ever increase (``inc``); gauges hold the latest value
    (``set_gauge``) or a running max (``max_gauge``); histograms
    (``observe``) count observations into the fixed log-spaced
    :data:`HIST_EDGES_MS` buckets, from which ``percentile`` interpolates
    p50/p99-style summaries. ``snapshot`` returns a plain dict of
    counters+gauges for exports (histograms travel separately via
    ``histograms()`` — they are vectors, not scalars); ``reset`` zeroes
    everything.
    """

    def __init__(self) -> None:
        # RLock, not Lock: the SIGTERM/SIGUSR2 flight-dump handler runs ON
        # the main thread between bytecodes and reads the registry — if the
        # signal lands while that same thread holds the lock in inc(), a
        # plain Lock would deadlock the dump instead of writing it
        self._lock = threading.RLock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, dict] = {}

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def max_gauge(self, name: str, value: float) -> None:
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def observe(self, name: str, value: float, exemplar: str | None = None) -> None:
        """Count one observation into ``name``'s log-spaced histogram.

        ``exemplar`` (a trace/request id) is remembered per BUCKET for the
        max observation that landed there — the exposition layer emits it
        OpenMetrics-style on the ``_bucket`` line, so an operator reading a
        p99 blow-up on /metrics gets the trace id of the request that put
        the worst observation in that bucket, not just a count."""
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = {
                    "counts": [0] * len(HIST_EDGES_MS),
                    "count": 0,
                    "sum": 0.0,
                    "min": float("inf"),
                    "max": float("-inf"),
                    # bucket index -> [trace id, value] of the bucket's max
                    # exemplar-carrying observation (sparse: only buckets
                    # that ever saw a traced observation hold a slot)
                    "exemplars": {},
                }
            value = float(value)
            bucket = _hist_bucket(value)
            hist["counts"][bucket] += 1
            hist["count"] += 1
            hist["sum"] += value
            hist["min"] = min(hist["min"], value)
            hist["max"] = max(hist["max"], value)
            if exemplar is not None:
                slot = hist["exemplars"].get(bucket)
                if slot is None or value >= slot[1]:
                    hist["exemplars"][bucket] = [str(exemplar), value]

    def histograms(self) -> dict[str, dict]:
        """A deep copy of every histogram (name -> counts/count/sum/min/max/
        exemplars); bucket upper edges are the shared :data:`HIST_EDGES_MS`."""
        with self._lock:
            return {
                name: {
                    **hist,
                    "counts": list(hist["counts"]),
                    "exemplars": {
                        b: list(slot)
                        for b, slot in hist.get("exemplars", {}).items()
                    },
                }
                for name, hist in self._hists.items()
            }

    def percentile(self, name: str, q: float) -> float | None:
        """The ``q``-quantile (0..1) of ``name``'s histogram, interpolated
        within the holding bucket and clamped to the observed min/max (so
        p0/p100 are exact). ``None`` for an unknown or empty histogram."""
        with self._lock:
            hist = self._hists.get(name)
            if hist is None or not hist["count"]:
                return None
            return _hist_percentile(hist, q)

    def counters(self) -> dict[str, float]:
        """A copy of the counters alone — the Prometheus renderer needs the
        counter/gauge split ``snapshot`` merges away (counters get the
        ``_total`` suffix and the ``counter`` TYPE, gauges do not)."""
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        """A copy of the gauges alone (see :meth:`counters`)."""
        with self._lock:
            return dict(self._gauges)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {**self._counters, **self._gauges}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def _hist_percentile(hist: dict, q: float) -> float:
    """Percentile from a bucket-count vector: walk the cumulative counts to
    the target rank, then interpolate linearly inside the holding bucket
    (lower edge = previous bucket's upper edge, 0 for the first)."""
    target = max(0.0, min(1.0, q)) * hist["count"]
    cum = 0
    for i, c in enumerate(hist["counts"]):
        if not c:
            continue
        if cum + c >= target:
            lo = HIST_EDGES_MS[i - 1] if i else 0.0
            hi = HIST_EDGES_MS[i]
            frac = (target - cum) / c
            value = lo + frac * (hi - lo)
            return min(max(value, hist["min"]), hist["max"])
        cum += c
    return hist["max"]


METRICS = MetricsRegistry()


def count(name: str, value: float = 1) -> None:
    """Increment a counter — only when telemetry is enabled, so the
    disabled mode leaves the registry untouched (asserted in tests)."""
    if enabled():
        METRICS.inc(name, value)


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar["_Span | None"] = contextvars.ContextVar(
    "flox_tpu_span", default=None
)
#: the active trace id (a request_id in the serving layer): every record
#: emitted while it is set carries it, so one request's spans are joinable
#: across core/streaming/mesh/resilience in both export formats
_TRACE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "flox_tpu_trace", default=None
)
#: the REMOTE parent span of the active trace (the ``parent-id`` half of a
#: client-supplied W3C ``traceparent``): root-level records emitted inside
#: the trace carry it as ``trace_parent``, which is what lets
#: ``tools/trace_join.py`` hang a replica's spans under the hop that sent
#: the request (router→replica, client→replica) in ONE joined trace
_TRACE_PARENT: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "flox_tpu_trace_parent", default=None
)
_IDS = itertools.count(1)

# ---------------------------------------------------------------------------
# W3C trace-context (traceparent) propagation
# ---------------------------------------------------------------------------

#: ``version-traceid-parentid-flags`` per the W3C trace-context spec; the
#: serve protocol accepts exactly this shape (lowercase hex, version != ff,
#: ids nonzero) and ignores anything else rather than guessing
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def parse_traceparent(header: Any) -> tuple[str, str] | None:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` string,
    or ``None`` for anything malformed (wrong shape, uppercase hex, the
    forbidden ``ff`` version, all-zero ids) — a bad header degrades to a
    locally rooted trace, never to an error or a half-parsed id."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    version, trace_id, parent_id, _flags = m.groups()
    if version == "ff" or set(trace_id) == {"0"} or set(parent_id) == {"0"}:
        return None
    return trace_id, parent_id


def _hex_trace_id(trace_id: str) -> str:
    """``trace_id`` as 32 lowercase hex chars: pass-through when it already
    is one (a propagated W3C id), else a stable blake2b digest of it — so a
    plain request id still formats into a valid ``traceparent``."""
    if (
        len(trace_id) == 32
        and set(trace_id) != {"0"}
        and _TRACEPARENT_RE.match(f"00-{trace_id}-{'1' * 16}-01")
    ):
        return trace_id
    import hashlib

    digest = hashlib.blake2b(trace_id.encode(), digest_size=16).hexdigest()
    # an (astronomically unlikely) all-zero digest would format into the
    # spec's forbidden all-zero trace id — nudge it valid
    return digest if set(digest) != {"0"} else "1" + digest[1:]


def new_span_hex() -> str:
    """A fresh 16-hex span id, unique per process AND across replicas (the
    pid + replica instance are folded in): the replica's own hop identity
    in the ``traceparent`` it echoes downstream."""
    import hashlib

    seed = f"{replica_instance()}|{_PID}|{next(_IDS)}|{time.perf_counter_ns()}"
    return hashlib.blake2b(seed.encode(), digest_size=8).hexdigest()


def format_traceparent(trace_id: str, span_id: str | None = None) -> str:
    """A W3C ``traceparent`` for ``trace_id`` (hex-normalized via
    :func:`_hex_trace_id`) with ``span_id`` (or a fresh one) as the
    parent-id field — what a replica echoes so the NEXT hop keeps the same
    trace and parents onto this replica's handling."""
    return f"00-{_hex_trace_id(str(trace_id))}-{span_id or new_span_hex()}-01"

#: per-trace parked detail records (tail-based sampling at level="basic"):
#: trace id -> records kept only if the trace blows its running p99.
#: Cleared by :func:`reset`.
_TAIL_REGISTRY: dict[str, list] = {}
#: detail-record cap per trace — one runaway streaming request must not
#: hold unbounded parked records hostage while its trace is open
_TAIL_MAX_PER_TRACE = 1024

# finished records (span + event dicts) pending export/drain. RLock: the
# signal-handler flight dump (and its flush) may interrupt this very thread
# mid-_commit — a plain Lock would deadlock the dump (see MetricsRegistry)
_RECORDS: list[dict] = []
_RECORDS_LOCK = threading.RLock()
# serializes file appends: concurrent batch flushes from prefetch-worker
# and consumer threads must not interleave mid-line in the export file
# (RLock: the signal-handler flush may interrupt an in-progress append)
_EXPORT_LOCK = threading.RLock()
_EXPORT_STATE: dict[str, Any] = {"atexit": False}


class _NoopSpan:
    """The disabled-mode span: one shared instance, every method a no-op —
    ``span()`` allocates nothing when telemetry is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


def _profiler_recording() -> bool:
    """Whether a ``torch.profiler`` is recording in this process (no profiler
    can be while torch is not imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class _Span:
    """One live span. Context-manager protocol; ``set`` attaches attributes
    any time before exit. Finished spans append a plain-dict record to the
    buffer (and stream to the export path, if configured). While a
    ``torch.profiler`` records, the span also opens a
    ``torch.profiler.record_function`` range of its name, so the profiler's
    trace holds it as a host range on its own clock, and each device op sits
    under the innermost span open at its launch."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "_t0", "_token", "_tid", "_range")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self.span_id = next(_IDS)
        self.parent_id: int | None = None
        self._t0 = 0.0
        self._token: contextvars.Token | None = None
        self._tid = threading.get_ident()
        self._range: Any = None

    def __enter__(self) -> "_Span":
        parent = _CURRENT.get()
        self.parent_id = parent.span_id if parent is not None else None
        self._token = _CURRENT.set(self)
        if _profiler_recording():
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if self._token is not None:
            _CURRENT.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _emit(
            {
                "type": "span",
                "name": self.name,
                "id": self.span_id,
                "parent": self.parent_id,
                "tid": self._tid,
                "ts_us": round((self._t0 - _EPOCH) * 1e6, 1),
                "dur_us": round((t1 - self._t0) * 1e6, 1),
                "attrs": self.attrs,
            }
        )
        return False

    def set(self, **attrs: Any) -> "_Span":
        self.attrs.update(attrs)
        return self


def span(name: str, **attrs: Any):
    """Open a hierarchical span: ``with telemetry.span("factorize"): ...``.

    Returns the shared no-op singleton when telemetry is disabled — no
    allocation, no clock read, no profiler touched. Enabled, it opens a
    ``torch.profiler.record_function`` range beside itself while a profiler
    records, and none otherwise. Nesting is tracked through a contextvar, so
    spans opened on worker threads become roots of their own stacks (they
    still interleave correctly by timestamp in the trace view).
    """
    if not enabled():
        return _NOOP
    _bootstrap()
    return _Span(name, attrs)


def record_span(
    name: str,
    t0: float,
    t1: float,
    attrs: dict | None = None,
    parent_id: int | None = None,
    detail: bool = False,
) -> None:
    """Record an already-timed span (``t0``/``t1`` from ``perf_counter``).

    For code that cannot hold a ``with`` block open across its timing — the
    streaming generator records one span per finished pass this way, with
    the ``StreamReport`` totals as attributes. ``detail=True`` marks the
    span as detailed-level: at ``telemetry_level="basic"`` it is parked on
    the active trace and survives only if the trace blows its running p99."""
    if not enabled():
        return
    _bootstrap()
    if parent_id is None:
        parent = _CURRENT.get()
        parent_id = parent.span_id if parent is not None else None
    _emit(
        {
            "type": "span",
            "name": name,
            "id": next(_IDS),
            "parent": parent_id,
            "tid": threading.get_ident(),
            "ts_us": round((t0 - _EPOCH) * 1e6, 1),
            "dur_us": round((t1 - t0) * 1e6, 1),
            "attrs": attrs or {},
        },
        detail=detail,
    )


def event(name: str, **attrs: Any) -> None:
    """Record an instant event (retry, OOM split, checkpoint, resume).

    Events are standalone records — resilience events fire on prefetch
    worker threads where no span context exists, and an instant mark at the
    right timestamp is exactly what the trace view needs there."""
    if not enabled():
        return
    _bootstrap()
    parent = _CURRENT.get()
    _emit(
        {
            "type": "event",
            "name": name,
            "id": next(_IDS),
            "parent": parent.span_id if parent is not None else None,
            "tid": threading.get_ident(),
            "ts_us": round((time.perf_counter() - _EPOCH) * 1e6, 1),
            "attrs": attrs,
        }
    )


def record_serve_error(exc: BaseException, what: str = "") -> None:
    """Record one serving-plane exception that is answered rather than
    raised into the flight ring and the counters, so a handled serve error
    is never invisible to crash forensics. No-op while telemetry is off;
    never raises."""
    if not enabled():
        return
    try:
        METRICS.inc("serve.swallowed_errors")
        event("serve-error", what=what, error=type(exc).__name__, detail=str(exc)[:200])
    except Exception:  # noqa: BLE001 — forensics never break the answer path
        pass


def current_set(**attrs: Any) -> None:
    """Attach attributes to the innermost live span, if any."""
    sp = _CURRENT.get() if enabled() else None
    if sp is not None:
        sp.attrs.update(attrs)


# ---------------------------------------------------------------------------
# request tracing: trace context + tail-based detail sampling
# ---------------------------------------------------------------------------


def current_trace() -> str | None:
    """The active trace id, or ``None`` outside any :func:`trace` context
    (worker-thread code rebinds it via ``trace(..., observe=False)`` — a
    plain thread does not inherit the submitting context's contextvars)."""
    return _TRACE.get()


def current_trace_parent() -> str | None:
    """The active trace's REMOTE parent span id (the ``parent-id`` of the
    ``traceparent`` the request arrived with), or ``None`` for a locally
    rooted trace."""
    return _TRACE_PARENT.get()


def trace(
    trace_id: Any,
    hist: str = "trace_ms",
    observe: bool = True,
    parent: str | None = None,
):
    """Bind a trace context: ``with telemetry.trace(request_id): ...``.

    Every record emitted inside (phase spans, streaming passes, mesh
    dispatches, resilience events) carries ``trace_id``, in the buffer and
    in both export formats. On exit the trace's duration is compared with
    the running p99 of the ``hist`` histogram (and observed into it, unless
    ``observe=False`` — the serving layer feeds ``serve.request_ms``
    itself): a trace that blew the p99, or errored, promotes its parked
    ``detailed``-level records into the buffer; a fast one drops them. The
    no-op singleton is returned when telemetry is disabled — no allocation.

    ``parent`` is the REMOTE parent span id for a trace that began on
    another process (the ``parent-id`` half of a W3C ``traceparent`` — the
    serve layer passes the parsed header through): root-level records then
    carry it as ``trace_parent``, which ``tools/trace_join.py`` uses to
    hang this process's spans under the sending hop in one joined trace.
    """
    if not enabled():
        return _NOOP
    _bootstrap()
    return _Trace(str(trace_id), hist, observe, parent)


class _Trace:
    __slots__ = (
        "trace_id", "_hist", "_observe", "_token", "_ptoken", "_parent",
        "_t0", "_owns_tail", "_p99",
    )

    def __init__(
        self, trace_id: str, hist: str, observe: bool, parent: str | None = None
    ) -> None:
        self.trace_id = trace_id
        self._hist = hist
        self._observe = observe
        self._parent = parent
        self._token: contextvars.Token | None = None
        self._ptoken: contextvars.Token | None = None
        self._t0 = 0.0
        self._owns_tail = False
        self._p99: float | None = None

    def __enter__(self) -> "_Trace":
        from .options import OPTIONS

        self._token = _TRACE.set(self.trace_id)
        if self._parent is not None:
            self._ptoken = _TRACE_PARENT.set(str(self._parent))
        if OPTIONS["telemetry_level"] != "detailed":
            # open the tail-parking buffer for this trace; detail records
            # emitted inside land here instead of the main buffer. Only the
            # OPENING binding owns the buffer and the keep/drop verdict —
            # a worker-thread rebinding of a live trace must never pop the
            # root's parked records mid-request
            with _RECORDS_LOCK:
                if self.trace_id not in _TAIL_REGISTRY:
                    _TAIL_REGISTRY[self.trace_id] = []
                    self._owns_tail = True
            if self._owns_tail:
                # the verdict compares against the distribution this trace
                # JOINED: snapshot the p99 at entry, so neither this trace
                # (the serve layer observes its own latency mid-trace with
                # observe=False) nor its contemporaries dilute the bar a
                # cold-start outlier is judged against
                self._p99 = METRICS.percentile(self._hist, 0.99)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        if self._ptoken is not None:
            _TRACE_PARENT.reset(self._ptoken)
            self._ptoken = None
        if self._token is not None:
            _TRACE.reset(self._token)
            self._token = None
        parked = None
        if self._owns_tail:
            with _RECORDS_LOCK:
                parked = _TAIL_REGISTRY.pop(self.trace_id, None)
        if self._observe:
            METRICS.observe(self._hist, dur_ms, exemplar=self.trace_id)
        if parked:
            # keep on error, on blowing the entry-time p99, or when there
            # was no distribution to compare against (the first traced
            # request after a restart IS the cold-start outlier worth
            # explaining — dropping it for lack of a baseline would lose
            # exactly the trace the feature exists for)
            if exc_type is not None or self._p99 is None or dur_ms > self._p99:
                METRICS.inc("telemetry.tail_kept", len(parked))
                for rec in parked:
                    if rec.get("type") == "span":
                        # promoted spans feed the per-phase histograms HERE
                        # — dropped ones never do, so /metrics shows the
                        # same per-phase distributions whether or not fast
                        # requests were traced
                        METRICS.observe(
                            "span_ms." + rec["name"],
                            rec.get("dur_us", 0.0) / 1e3,
                            exemplar=rec.get("trace"),
                        )
                _commit(parked)
            else:
                METRICS.inc("telemetry.tail_dropped", len(parked))
        return False


# ---------------------------------------------------------------------------
# flight recorder: bounded ring of recent records, dumped on crash signals
# ---------------------------------------------------------------------------


class _FlightRecorder:
    """A bounded ring of the most recent span/event records.

    Always fed while telemetry is enabled (``_emit`` appends every record);
    the deque's ``maxlen`` (``OPTIONS["flight_recorder_size"]``) makes the
    allocation fixed — the oldest record falls out first. :func:`flight_dump`
    snapshots it to disk when the process is about to die."""

    __slots__ = ("_ring", "_lock")

    def __init__(self) -> None:
        self._ring: deque | None = None
        # RLock for the same reason as the registry's: the signal-handler
        # dump snapshots the ring on the thread that may be mid-append
        self._lock = threading.RLock()

    def append(self, record: dict) -> None:
        from .options import OPTIONS

        cap = OPTIONS["flight_recorder_size"]
        with self._lock:
            if self._ring is None or self._ring.maxlen != cap:
                self._ring = deque(self._ring or (), maxlen=cap)
            self._ring.append(record)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring or ())

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring or ())

    def clear(self) -> None:
        with self._lock:
            self._ring = None


#: the process-wide ring; cleared by :func:`reset`
FLIGHT_RECORDER = _FlightRecorder()


def _breaker_snapshot() -> dict:
    """``cache.stats()["serve_breakers"]`` for the flight-dump header,
    imported lazily and guarded: a dump must succeed in a process that never
    touched the serving plane, or at interpreter shutdown."""
    try:
        from .serve.breaker import breaker_stats

        return breaker_stats()
    except Exception:  # noqa: BLE001 — forensics are best-effort
        return {}


def _alert_snapshot() -> dict:
    """The SLO plane's alert state for the flight-dump header."""
    try:
        from . import slo

        return slo.alert_snapshot()
    except Exception:  # noqa: BLE001 — forensics are best-effort
        return {}


def flight_dump(path: Any = None, reason: str = "") -> str | None:
    """Dump the flight-recorder ring atomically as JSON-lines.

    ``path`` defaults to ``OPTIONS["flight_recorder_path"]`` (env
    ``FLOX_TPU_FLIGHT_RECORDER_PATH``); ``None`` there means dumping is off
    and this is a no-op returning ``None`` (so the fault-path triggers cost
    nothing unconfigured). The file is a header event + the ring records +
    a counters line — exactly what ``python -m flox_tpu.telemetry report``
    reads. Written tmp+rename, so a crash mid-dump never leaves a torn
    file; never raises (a failing dump must not mask the original fault).
    """
    from .options import OPTIONS

    if path is None:
        path = OPTIONS["flight_recorder_path"]
    if path is None or not enabled():
        return None
    try:
        METRICS.inc("flight.dumps")
        records = FLIGHT_RECORDER.records()
        header = {
            "type": "event",
            "name": "flight-recorder",
            "id": 0,
            "ts_us": round((time.perf_counter() - _EPOCH) * 1e6, 1),
            "tid": threading.get_ident(),
            "attrs": {
                "reason": reason,
                "records": len(records),
                "pid": _PID,
                "wall": time.time(),
                "replica": replica_instance(),
                "host": _HOST,
                # breaker + saturation state AT CRASH TIME: the ring holds
                # spans, but a post-mortem's first questions — was a
                # breaker open, was the queue building — need the live
                # state, not an inference from record archaeology
                "breakers": _breaker_snapshot(),
                # ...and whether an SLO alert was already pending or
                # firing (empty until the SLO plane is ported)
                "alerts": _alert_snapshot(),
                "saturation": {
                    name: METRICS.get(name) for name in SATURATION_GAUGES
                },
                # the resident state (dataset registry, stores) at the time
                "resident": {
                    name: METRICS.get(name) for name in RESIDENT_GAUGES
                },
            },
        }
        path = str(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{_PID}"
        with open(tmp, "w") as f:
            for rec in [header, *records, _counters_record()]:
                f.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, path)
        return path
    except Exception as exc:  # noqa: BLE001 — dumping is best-effort by contract
        import logging

        logging.getLogger(__name__).warning("flight-recorder dump failed: %s", exc)
        return None


def install_signal_dumps(sigterm: bool = True) -> None:
    """Dump the flight recorder on SIGTERM (then die with the default
    disposition, so exit codes stay honest) and on SIGUSR2 (dump and keep
    running — the operator's "what are you doing right now" poke). Only
    callable from the main thread; the standalone metrics endpoint installs
    this at startup. The serve loop passes ``sigterm=False`` and owns
    SIGTERM itself: there it triggers the graceful drain (finish in-flight
    requests, flight-dump, exit 0) instead of dying 143 mid-request. No-op
    on platforms missing the signals."""
    import signal

    def _dump(signum: int, frame: Any) -> None:
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        flight_dump(reason=f"signal:{name}")
        if signum == getattr(signal, "SIGTERM", None):
            flush()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    names = ("SIGTERM", "SIGUSR2") if sigterm else ("SIGUSR2",)
    for signame in names:
        signum = getattr(signal, signame, None)
        if signum is None:
            continue
        try:
            signal.signal(signum, _dump)
        except (ValueError, OSError):  # not the main thread / exotic platform
            return


# ---------------------------------------------------------------------------
# cost ledger + device-memory accounting
# ---------------------------------------------------------------------------


#: per-program / per-tenant cost ledger: ``(axis, label)`` -> dispatches /
#: device_ms (total + max) / bytes / compiles / compile_ms / hbm_peak /
#: last_slow_trace. ``axis`` is ``"program"`` (the dispatch site's label:
#: ``bundle[nanmean]``, ``fused[...]``, ``mesh[...]``, ``stream[...]``),
#: ``"tenant"`` or ``"dataset"``. ``compiles`` and ``compile_ms`` stay 0: the
#: port compiles no programs. Surfaced via :func:`cost_by_program` and
#: ``python -m flox_tpu_torch.telemetry costs``.
_COST_LEDGER: dict[tuple[str, str], dict] = {}

#: dispatches timed on the card whose events are not read yet:
#: ``(ledger keys, trace id, start event, end event)``; read by
#: :func:`_resolve_device_times` when the ledger is read, flushed or exported
_PENDING_DEVICE: list[tuple] = []


def _cost_entry(axis: str, label: str) -> dict:
    """The (axis, label) ledger row, created empty on first touch.
    Callers hold ``_RECORDS_LOCK``."""
    entry = _COST_LEDGER.get((axis, label))
    if entry is None:
        entry = _COST_LEDGER[(axis, label)] = {
            "dispatches": 0,
            "device_ms": 0.0,
            "device_ms_max": 0.0,
            "bytes": 0,
            "compiles": 0,
            "compile_ms": 0.0,
            "hbm_peak": 0.0,
            "last_slow_trace": None,
        }
    return entry


class _DeviceTimer:
    """The device time of one dispatch: on a CUDA device a pair of CUDA
    events recorded on the current stream around the block (read later, by
    the ledger), elsewhere the block's host wall."""

    __slots__ = ("device", "start", "end", "ms", "_t0")

    def __init__(self, device: Any) -> None:
        import torch

        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.start = self.end = None
        self.ms = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "_DeviceTimer":
        if self.device.type == "cuda":
            import torch

            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self.start is not None:
            import torch

            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(torch.cuda.current_stream(self.device))
        else:
            self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def device_timer(device: Any = None):
    """A context manager timing one dispatch on ``device`` for
    :func:`observe_cost` (``timer=``): CUDA events on the card, the host
    wall elsewhere. The shared no-op singleton when telemetry is off: no
    event is made and nothing is allocated."""
    if not enabled():
        return _NOOP
    return _DeviceTimer(device)


def observe_cost(
    program: str | None = None,
    *,
    tenant: str | None = None,
    dataset: str | None = None,
    dispatches: int = 1,
    device_ms: float = 0.0,
    nbytes: int | float = 0,
    compiles: int = 0,
    compile_ms: float = 0.0,
    timer: Any = None,
) -> None:
    """Attribute one dispatch's cost to its program label (and tenant, and
    dataset).

    ``timer``: the :func:`device_timer` that bracketed the dispatch. Its
    host wall is the device time off the card; on the card its events are
    read later, when the ledger is read (:func:`cost_by_program`), flushed
    or exported, so this call never waits for the card. ``nbytes`` is the
    payload the dispatch read. A dispatch that sets a new ``device_ms_max``
    inside a live :func:`trace` records the trace id as
    ``last_slow_trace``. No-op (no lock, no allocation) when telemetry is
    off."""
    if not enabled():
        return
    trace_id = _TRACE.get()
    keys = [(axis, str(label)) for axis, label in (
        ("program", program), ("tenant", tenant), ("dataset", dataset)) if label is not None]
    pending = timer is not None and getattr(timer, "end", None) is not None
    if timer is not None and not pending:
        device_ms = float(getattr(timer, "ms", device_ms))
    program_entry: dict | None = None
    with _RECORDS_LOCK:
        for axis, label in keys:
            entry = _cost_entry(axis, label)
            entry["dispatches"] += dispatches
            entry["bytes"] += int(nbytes)
            entry["compiles"] += int(compiles)
            entry["compile_ms"] += float(compile_ms)
            if not pending:
                _add_device_ms(entry, float(device_ms), trace_id)
            if axis == "program":
                program_entry = dict(entry)
        if pending:
            _PENDING_DEVICE.append((keys, trace_id, timer.start, timer.end))
    if program is not None and program_entry is not None and not pending:
        _publish_cost(str(program), program_entry)


def _add_device_ms(entry: dict, ms: float, trace_id: str | None) -> None:
    entry["device_ms"] += ms
    if ms >= entry["device_ms_max"]:
        entry["device_ms_max"] = ms
        if trace_id is not None:
            entry["last_slow_trace"] = trace_id


def _publish_cost(program: str, entry: dict) -> None:
    from .options import OPTIONS

    if OPTIONS["costmodel"]:
        # the roofline join: the ledger row meets its cost card and the
        # program.utilization / program.predicted_ms gauges update
        from . import costmodel

        costmodel.publish_gauges(program, entry)


def _resolve_device_times() -> None:
    """Read the CUDA events of the dispatches timed on the card into the
    ledger (each waits for its own end event, off the dispatch path)."""
    with _RECORDS_LOCK:
        if not _PENDING_DEVICE:
            return
        pending = list(_PENDING_DEVICE)
        _PENDING_DEVICE.clear()
    done = []
    for keys, trace_id, start, end in pending:
        end.synchronize()
        done.append((keys, trace_id, float(start.elapsed_time(end))))
    programs = {}
    with _RECORDS_LOCK:
        for keys, trace_id, ms in done:
            for axis, label in keys:
                entry = _cost_entry(axis, label)
                _add_device_ms(entry, ms, trace_id)
                if axis == "program":
                    programs[label] = dict(entry)
    for label, entry in programs.items():
        _publish_cost(label, entry)


def _ledger_axis(axis: str) -> dict[str, dict]:
    """A locked deep copy of one ledger axis (label -> row), its device
    times read first."""
    _resolve_device_times()
    with _RECORDS_LOCK:
        return {
            label: dict(entry)
            for (ax, label), entry in _COST_LEDGER.items()
            if ax == axis
        }


def cost_by_program() -> dict[str, dict]:
    """The per-program-key cost ledger (a locked copy)."""
    return _ledger_axis("program")


def cost_by_tenant(include_canary: bool = False) -> dict[str, dict]:
    """The per-tenant cost ledger (a locked copy; populated only by serve
    requests that carry a ``tenant`` tag). The reserved canary tenant's
    row is synthetic traffic, dropped from the user-facing default view
    (``include_canary=True`` keeps it — the raw ledger is never lossy)."""
    rows = _ledger_axis("tenant")
    if not include_canary:
        rows.pop(CANARY_TENANT, None)
    return rows


def cost_by_dataset() -> dict[str, dict]:
    """The per-resident-dataset cost ledger (a locked copy; populated only
    by serve dispatches that referenced a registry entry) — the operator's
    answer to "which pinned dataset is earning its HBM"."""
    return _ledger_axis("dataset")


#: distinct tenant labels admitted so far — the cardinality bound for the
#: tenant ledger axis AND the labeled /metrics histograms. Client-supplied
#: tags past the cap fold into "_other" instead of allocating a fresh
#: histogram per unique string (an untrusted client must not be able to
#: grow registry memory without bound). Cleared by :func:`reset`.
_TENANT_LABELS: dict[str, bool] = {}
_TENANT_MAX = 64
#: characters allowed through in a tenant label — everything else folds to
#: ``_`` so a client-chosen tag can never inject label syntax (quotes,
#: the registry's ``|key=value`` separator, newlines) into the exposition
_TENANT_UNSAFE = re.compile(r"[^A-Za-z0-9_.:\-]")

#: the reserved tenant the SLO plane's canary prober bills its known-answer
#: requests under. Always resolvable as a label but NEVER admitted into
#: :data:`_TENANT_LABELS` (synthetic traffic must not consume one of the
#: :data:`_TENANT_MAX` real-tenant cardinality slots) and filtered out of
#: user-facing surfaces (``cost_by_tenant`` rows, base latency histograms).
CANARY_TENANT = "__canary__"


def tenant_label(tenant: Any, register: bool = True) -> str:
    """The sanitized, cardinality-bounded label for a client tenant tag.

    The serve layer passes every request's raw ``tenant`` through here
    before using it as a ledger key or a metric label: unsafe characters
    fold to ``_``, length is capped, and once :data:`_TENANT_MAX` distinct
    labels exist, new ones collapse into ``"_other"`` (their cost is still
    counted — just not per-tenant). ``register=False`` sanitizes without
    admitting a new label — read-side callers (the ``/debug/costs``
    ``?tenant=`` filter) must not burn cardinality slots on lookups."""
    label = _TENANT_UNSAFE.sub("_", str(tenant))[:64] or "_"
    if label == CANARY_TENANT:
        # the reserved canary tenant never occupies a cardinality slot
        return label
    with _RECORDS_LOCK:
        if label in _TENANT_LABELS:
            return label
        if not register:
            return label
        if len(_TENANT_LABELS) >= _TENANT_MAX:
            return "_other"
        _TENANT_LABELS[label] = True
    return label


def sample_hbm(program: str | None = None) -> None:
    """Sample ``device.memory_stats()`` (the CUDA caching allocator's
    counters) into the device-memory gauges.

    Called after dispatches (eager kernels, fused, mesh, streaming pass).
    Feeds ``hbm.bytes_in_use`` (latest) and
    ``hbm.peak_bytes_in_use`` (running max — the allocator's own peak when
    it reports one); with ``program`` set, also attributes the observed
    ``bytes_in_use`` to that program's cost-ledger row (``hbm_peak``), so
    an operator can see WHICH compiled program is eating the chip. No-op
    when telemetry is off or the backend exposes no memory stats (CPU)."""
    if not enabled():
        return
    from . import device

    stats = device.memory_stats()
    if not stats:
        return
    in_use = float(stats.get("bytes_in_use", 0.0))
    peak = float(stats.get("peak_bytes_in_use", in_use))
    METRICS.set_gauge("hbm.bytes_in_use", in_use)
    METRICS.max_gauge("hbm.peak_bytes_in_use", peak)
    limit = stats.get("bytes_limit")
    if limit:
        # per-device capacity summed by device.memory_stats(): the
        # denominator that makes the in-use gauge an HBM fraction
        METRICS.set_gauge("hbm.bytes_limit", float(limit))
    if program is not None:
        with _RECORDS_LOCK:
            entry = _cost_entry("program", program)
            if in_use > entry["hbm_peak"]:
                entry["hbm_peak"] = in_use


def seed_hbm_limit() -> None:
    """Publish the ``hbm.bytes_limit`` gauge (per-device HBM capacity
    summed by ``device.memory_stats()``) once, before the first dispatch
    samples it: utilization math needs the denominator. No-op while telemetry is off or
    when no device reports a capacity (CPU)."""
    if not enabled():
        return
    from . import device

    stats = device.memory_stats()
    limit = (stats or {}).get("bytes_limit")
    if limit:
        METRICS.set_gauge("hbm.bytes_limit", float(limit))


def hbm_by_program() -> dict[str, float]:
    """Per-program peak HBM — the ``hbm_peak`` column of the cost ledger,
    kept as its own view because "which program is eating the chip" is the
    question an OOM postmortem starts with. Only rows that ever observed a
    sample appear (a CPU backend with no memory stats contributes none)."""
    return {
        label: entry["hbm_peak"]
        for label, entry in cost_by_program().items()
        if entry["hbm_peak"] > 0.0
    }


# ---------------------------------------------------------------------------
# saturation sampler: live gauges between requests
# ---------------------------------------------------------------------------


#: the live saturation gauges the sampler publishes, seeded to 0 so the
#: series exist before the first sample
SATURATION_GAUGES: tuple[str, ...] = (
    "serve.queue_depth",
    "serve.inflight_batches",
    "serve.breakers_open",
    "stream.prefetch_occupancy",
)

#: the resident-state gauges (dataset registry occupancy, store footprint),
#: sampled between requests too: resident state outlives any request, so
#: the request histograms cannot show it. The per-store
#: ``store.staleness_s|store=`` series appear with the first sample.
RESIDENT_GAUGES: tuple[str, ...] = (
    "registry.bytes",
    "registry.pinned_bytes",
    "registry.budget_bytes",
    "registry.occupancy",
    "store.open_stores",
    "store.state_bytes",
)

_SAMPLER_LOCK = threading.Lock()
_SAMPLER_STATE: dict[str, Any] = {"thread": None, "stop": None}


def seed_saturation_gauges() -> None:
    """Publish every saturation gauge at 0 unless it is already live. No-op
    while telemetry is off."""
    if not enabled():
        return
    live = METRICS.gauges()
    for name in (*SATURATION_GAUGES, *RESIDENT_GAUGES):
        if name not in live:
            METRICS.set_gauge(name, 0)


def sample_saturation() -> None:
    """One sample of the live saturation gauges: the serving queue's depth
    and open micro-batches, open breakers, the prefetch pools' occupancy,
    the resident state and the device-memory gauges (what the process is
    doing right now, between calls). Never raises (sampler contract); each
    source is guarded on its own."""
    if not enabled():
        return
    try:
        from .serve.dispatcher import _BATCH_REGISTRY, _PENDING_REGISTRY

        METRICS.set_gauge("serve.queue_depth", len(_PENDING_REGISTRY))
        METRICS.set_gauge("serve.inflight_batches", len(_BATCH_REGISTRY))
    except Exception:  # noqa: BLE001 — sampling must never break the caller
        pass
    try:
        from .serve.breaker import open_breakers

        METRICS.set_gauge("serve.breakers_open", len(open_breakers()))
    except Exception:  # noqa: BLE001
        pass
    try:
        from .pipeline import prefetch_occupancy

        METRICS.set_gauge("stream.prefetch_occupancy", prefetch_occupancy())
    except Exception:  # noqa: BLE001
        pass
    sample_resident_state()
    try:
        sample_hbm()
    except Exception:  # noqa: BLE001
        pass


def sample_resident_state() -> None:
    """One sample of the resident-state gauges: the dataset registry's
    occupancy against its budget and each open store's staleness. Never
    raises (sampler contract)."""
    if not enabled():
        return
    try:
        from .serve.registry import budget_bytes, registry_stats

        budget = float(budget_bytes())
        stats = registry_stats()
        METRICS.set_gauge("registry.bytes", float(stats["bytes"]))
        METRICS.set_gauge("registry.pinned_bytes", float(stats["pinned_bytes"]))
        METRICS.set_gauge("registry.budget_bytes", budget)
        METRICS.set_gauge("registry.occupancy",
                          round(float(stats["bytes"]) / budget, 4) if budget > 0 else 0.0)
    except Exception:  # noqa: BLE001 — sampling must never break the caller
        pass
    try:
        from .serve import stores as serve_stores

        serve_stores.publish_staleness()
    except Exception:  # noqa: BLE001
        pass


def start_saturation_sampler(interval: float | None = None) -> bool:
    """Start the opt-in saturation-sampler daemon thread.

    ``interval`` defaults to ``OPTIONS["metrics_sample_interval"]`` — 0
    there (the default) means the sampler stays off and this returns
    ``False``. Idempotent while a sampler is running; the thread is a
    daemon fed by an Event, so :func:`stop_saturation_sampler` (and
    process exit) never hang on it. Returns whether a sampler is live."""
    from .options import OPTIONS

    if interval is None:
        interval = OPTIONS["metrics_sample_interval"]
    if not interval or not enabled():
        return False
    with _SAMPLER_LOCK:
        thread = _SAMPLER_STATE["thread"]
        if thread is not None and thread.is_alive():
            return True
        stop = threading.Event()
        period = float(interval)

        def _run() -> None:
            while not stop.wait(period):
                sample_saturation()

        thread = threading.Thread(
            target=_run, name="flox-tpu-saturation", daemon=True
        )
        _SAMPLER_STATE.update(thread=thread, stop=stop)
        thread.start()
    return True


def stop_saturation_sampler() -> None:
    """Stop the sampler thread (tests; the endpoint teardown calls this)."""
    with _SAMPLER_LOCK:
        stop = _SAMPLER_STATE["stop"]
        thread = _SAMPLER_STATE["thread"]
        _SAMPLER_STATE.update(thread=None, stop=None)
    if stop is not None:
        stop.set()
    if thread is not None:
        thread.join(timeout=2)


#: jsonl streaming appends in batches of this many records — one
#: open/write/close per span would compete with the prefetch workers the
#: pipeline exists to keep busy (flush() and atexit drain the remainder)
_JSONL_BATCH = 64


def _emit(record: dict, detail: bool = False) -> None:
    from .options import OPTIONS

    tid = _TRACE.get()
    if tid is not None:
        record["trace"] = tid
        # a remote parent attaches to ROOT-level records only: the local
        # span hierarchy already links everything below them, so one
        # trace_parent per root is exactly what the join tool needs
        parent_span = _TRACE_PARENT.get()
        if parent_span is not None and record.get("parent") is None:
            record["trace_parent"] = parent_span
    rid = OPTIONS["replica_id"]
    if rid is not None:
        # fleet identity on every record: jsonl/flight files from N
        # replicas stay attributable after they are merged or joined
        record["replica"] = rid
    # the flight ring sees EVERY record (bounded: oldest falls out), so a
    # crash dump always holds the freshest activity regardless of export
    # configuration or tail-sampling verdicts
    FLIGHT_RECORDER.append(record)
    if detail and OPTIONS["telemetry_level"] != "detailed":
        # tail-based sampling: park the record on its trace WITHOUT feeding
        # the histograms — a dropped record must leave no registry mark
        # (promotion observes span_ms then), or traced-but-fast requests
        # would inflate /metrics with detail the verdict discarded. Detail
        # without a trace context never reaches here — tail_detail() is
        # False there.
        if tid is None:
            return
        with _RECORDS_LOCK:
            buf = _TAIL_REGISTRY.get(tid)
            if buf is not None and len(buf) < _TAIL_MAX_PER_TRACE:
                buf.append(record)
        return
    if record.get("type") == "span":
        # every finished span feeds the per-phase latency histogram — the
        # p50/p99 source for the report CLI, the Perfetto export, and the
        # serving-layer SLO metrics (ROADMAP item 1). The trace id rides as
        # the bucket exemplar, so a /metrics p99 row names the request
        METRICS.observe(
            "span_ms." + record["name"],
            record.get("dur_us", 0.0) / 1e3,
            exemplar=tid,
        )
    _commit([record])


def _commit(records: list[dict]) -> None:
    """Append finished records to the buffer (and stream a jsonl batch out
    when one is due) — the shared tail of :func:`_emit` and the tail-kept
    promotion in :class:`trace`."""
    from .options import OPTIONS

    path = OPTIONS["telemetry_export_path"]
    with _RECORDS_LOCK:
        if len(_RECORDS) + len(records) > _MAX_RECORDS:
            METRICS.inc("telemetry.dropped_records", len(records))
            return
        _RECORDS.extend(records)
        stream_now = (
            path is not None
            and str(path).endswith(".jsonl")
            and len(_RECORDS) >= _JSONL_BATCH
        )
        batch = list(_RECORDS) if stream_now else None
        if stream_now:
            _RECORDS.clear()
    if stream_now and batch:
        _append_jsonl(str(path), batch)


def _bootstrap() -> None:
    """One-time side wiring for an enabled session: the atexit flush."""
    if not _EXPORT_STATE["atexit"]:
        _EXPORT_STATE["atexit"] = True
        import atexit

        atexit.register(flush)


# ---------------------------------------------------------------------------
# buffer access + exporters
# ---------------------------------------------------------------------------


def spans() -> list[dict]:
    """A copy of the buffered records (spans + events), oldest first."""
    with _RECORDS_LOCK:
        return list(_RECORDS)


def drain() -> list[dict]:
    """Remove and return all buffered records."""
    with _RECORDS_LOCK:
        out = list(_RECORDS)
        _RECORDS.clear()
    return out


def reset() -> None:
    """Clear the record buffer, the metrics registry (exemplar slots
    included), the flight-recorder ring, the parked tail buffers, the cost
    ledger, the cost cards and the SLO plane."""
    with _RECORDS_LOCK:
        _RECORDS.clear()
        _TAIL_REGISTRY.clear()
        _COST_LEDGER.clear()
        _PENDING_DEVICE.clear()
        _TENANT_LABELS.clear()
    FLIGHT_RECORDER.clear()
    METRICS.reset()
    # the cost cards annotate the ledger being dropped; a reset must not
    # leave cards pointing at vanished observations
    from .costmodel import _CARD_LABELS, _CARD_REGISTRY

    _CARD_REGISTRY.clear()
    _CARD_LABELS.clear()
    # the SLO plane judges the counters being dropped: its alert state and
    # window snapshots must not outlive them
    from . import slo

    slo.clear()


def _counters_record() -> dict:
    return {
        "type": "counters",
        "counters": METRICS.snapshot(),
        "histograms": METRICS.histograms(),
        "hist_edges_ms": list(HIST_EDGES_MS),
        "wall0": _WALL0,
        # fleet/mesh identity + a fresh two-clock anchor: trace_join reads
        # these to give each process its own Perfetto track and to shift
        # its monotonic timestamps onto the shared wall clock
        "replica": replica_instance(),
        "host": _HOST,
        "pid": _PID,
        "process_index": _process_index(),
        "anchor": {
            "wall": time.time(),
            "ts_us": round((time.perf_counter() - _EPOCH) * 1e6, 1),
        },
    }


def anchor_event() -> None:
    """Emit a ``clock-anchor`` instant event pairing the wall clock with
    the process's monotonic span clock (plus its replica/mesh identity).

    ``tools/trace_join.py`` prefers the freshest anchor it finds when
    aligning per-process files onto one timeline — emit one near the work
    being joined (the serve loop emits one at startup; the mesh smoke
    emits one per process) so monotonic-vs-wall drift since import cannot
    skew the merged trace. No-op while telemetry is off."""
    event(
        "clock-anchor",
        wall=time.time(),
        replica=replica_instance(),
        host=_HOST,
        pid=_PID,
        process_index=_process_index(),
    )


def export_jsonl(path: str, records: Iterable[dict] | None = None) -> None:
    """Write records as JSON-lines: one record object per line, with a final
    ``{"type": "counters", ...}`` snapshot line."""
    _resolve_device_times()
    records = spans() if records is None else list(records)
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.write(json.dumps(_counters_record()) + "\n")


def _append_jsonl(path: str, records: list[dict]) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with _EXPORT_LOCK, open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def to_chrome_trace(records: Iterable[dict] | None = None) -> dict:
    """Records -> one Chrome trace-event JSON object (Perfetto-loadable).

    Spans become complete (``"ph": "X"``) events, instants become
    thread-scoped instant (``"ph": "i"``) events; the counter snapshot rides
    the top-level ``floxTpuCounters`` key (the trace-event format allows
    extra top-level metadata keys)."""
    records = spans() if records is None else list(records)
    trace_events = []
    for rec in records:
        # the trace context rides args (Chrome events have no trace field),
        # so a request_id is searchable in Perfetto exactly like in jsonl
        args = dict(rec.get("attrs") or {})
        if rec.get("trace") is not None:
            args["trace_id"] = rec["trace"]
        if rec.get("type") == "span":
            trace_events.append(
                {
                    "name": rec["name"],
                    "ph": "X",
                    "ts": rec["ts_us"],
                    "dur": rec["dur_us"],
                    "pid": _PID,
                    "tid": rec["tid"],
                    "args": args,
                }
            )
        elif rec.get("type") == "event":
            trace_events.append(
                {
                    "name": rec["name"],
                    "ph": "i",
                    "s": "t",
                    "ts": rec["ts_us"],
                    "pid": _PID,
                    "tid": rec["tid"],
                    "args": args,
                }
            )
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "floxTpuCounters": METRICS.snapshot(),
        "floxTpuHistograms": METRICS.histograms(),
        "floxTpuHistEdgesMs": list(HIST_EDGES_MS),
        "floxTpuWall0": _WALL0,
    }


def export_chrome_trace(path: str, records: Iterable[dict] | None = None) -> None:
    """Write a Chrome trace-event JSON file — open it in ``ui.perfetto.dev``
    (Open trace file) or ``chrome://tracing``."""
    _resolve_device_times()
    payload = to_chrome_trace(records)
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)  # a crash mid-write never leaves a truncated trace


def flush() -> None:
    """Write buffered records to ``OPTIONS["telemetry_export_path"]``.

    ``*.jsonl`` paths stream incrementally as spans finish, so flush only
    appends the final counters line; any other path is (re)written as one
    Chrome trace JSON. No export path -> records stay in the buffer. Runs
    at process exit for enabled sessions."""
    from .options import OPTIONS

    _resolve_device_times()
    path = OPTIONS["telemetry_export_path"]
    if path is None:
        return
    path = str(path)
    if path.endswith(".jsonl"):
        pending = drain()
        _append_jsonl(path, pending + [_counters_record()])
    else:
        export_chrome_trace(path)


def profile_call(fn: Any) -> dict:
    """Run ``fn()`` once with telemetry enabled and return a compact profile:
    the host-to-device bytes and the span-phase breakdown in ms. (The
    reference's compile and trace counts and program-cache sizes have no
    counterpart: the port compiles no programs.)"""
    from .options import set_options

    base = METRICS.snapshot()
    with _RECORDS_LOCK:
        mark = len(_RECORDS)
    # export_path=None for the call: a configured .jsonl path would stream
    # records OUT of the buffer as they finish and the slice below would
    # see nothing — the profile must capture its own spans
    with set_options(telemetry=True, telemetry_export_path=None):
        fn()
    with _RECORDS_LOCK:
        records = list(_RECORDS[mark:])
    after = METRICS.snapshot()
    delta = {k: after[k] - base.get(k, 0) for k in after}
    return {
        "h2d_bytes": int(delta.get("bytes.h2d", 0)),
        "phase_ms": {
            row["name"]: round(row["total_ms"], 3) for row in summarize(records)
        },
    }


# ---------------------------------------------------------------------------
# report CLI: python -m flox_tpu_torch.telemetry report <file>
# ---------------------------------------------------------------------------


def _parse_export(path: str) -> tuple[list[dict], dict, dict]:
    """Parse either export format to (span records, counters, histograms).

    Format detection is by content, not extension: a Chrome trace is ONE
    JSON document with a ``traceEvents`` key; anything that fails a
    whole-file parse (or parses to a non-trace object) is read as
    JSON-lines — every record line there is an object too, so peeking at
    the first byte cannot distinguish them. A malformed JSON-lines line is
    an error naming the line number, never a silent skip: a truncated or
    interleaved export must fail the report (and its CI step), not
    quietly under-count."""
    with open(path) as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        payload = None
    if isinstance(payload, dict) and "traceEvents" in payload:
        counters = payload.get("floxTpuCounters", {})
        histograms = payload.get("floxTpuHistograms", {})
        spans_ = [
            {
                "type": "span" if ev.get("ph") == "X" else "event",
                "name": ev.get("name", "?"),
                "ts_us": ev.get("ts", 0.0),
                "dur_us": ev.get("dur", 0.0),
                "attrs": ev.get("args", {}),
            }
            for ev in payload.get("traceEvents", [])
        ]
        return spans_, counters, histograms
    counters: dict = {}
    histograms: dict = {}
    spans_ = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as exc:
            raise ValueError(
                f"{path}:{lineno}: malformed JSON-lines record ({exc})"
            ) from exc
        if not isinstance(rec, dict):
            raise ValueError(
                f"{path}:{lineno}: JSON-lines record is "
                f"{type(rec).__name__}, expected an object"
            )
        if rec.get("type") == "counters":
            # later snapshots supersede earlier ones (append-mode files
            # may carry one per flush)
            counters = rec.get("counters", {})
            histograms = rec.get("histograms", {})
        else:
            spans_.append(rec)
    return spans_, counters, histograms


def _load_export(path: str) -> tuple[list[dict], dict]:
    """Back-compat 2-tuple view of :func:`_parse_export`."""
    spans_, counters, _ = _parse_export(path)
    return spans_, counters


def summarize(records: list[dict]) -> list[dict]:
    """Aggregate span records per name: count / total / mean / p50 / p99 /
    max ms, sorted by total descending. Percentiles here are EXACT (from
    the raw durations) — the registry histograms trade that exactness for
    a bounded, mergeable representation. ``max_trace`` is the trace id of
    the slowest span of the name (when it carried one): the link from a
    p99 row to the flight/export records of the request that caused it."""
    agg: dict[str, dict] = {}
    durs: dict[str, list[float]] = {}
    for rec in records:
        if rec.get("type") != "span":
            continue
        row = agg.setdefault(
            rec["name"],
            {
                "name": rec["name"], "count": 0, "total_ms": 0.0,
                "max_ms": 0.0, "max_trace": None,
            },
        )
        dur_ms = rec.get("dur_us", 0.0) / 1e3
        row["count"] += 1
        row["total_ms"] += dur_ms
        if dur_ms >= row["max_ms"]:
            row["max_ms"] = dur_ms
            trace_id = rec.get("trace") or (rec.get("attrs") or {}).get("trace_id")
            if trace_id is not None:
                row["max_trace"] = trace_id
        durs.setdefault(rec["name"], []).append(dur_ms)
    out = sorted(agg.values(), key=lambda r: -r["total_ms"])
    for row in out:
        row["mean_ms"] = row["total_ms"] / row["count"] if row["count"] else 0.0
        seq = sorted(durs[row["name"]])
        # nearest-rank with ceiling: the upper percentile of a small sample
        # must not round down past its tail (p99 of 5 spans IS the max)
        row["p50_ms"] = seq[min(len(seq) - 1, math.ceil(0.50 * (len(seq) - 1)))]
        row["p99_ms"] = seq[min(len(seq) - 1, math.ceil(0.99 * (len(seq) - 1)))]
    return out


def _report_lines(path: str, histograms: bool = False) -> list[str]:
    records, counters, hists = _parse_export(path)
    rows = summarize(records)
    nevents = sum(1 for r in records if r.get("type") == "event")
    lines = [
        f"telemetry report — {path}",
        f"{len(records) - nevents} span(s), {nevents} event(s)",
        "",
        f"{'phase':<36} {'count':>7} {'total ms':>12} {'mean ms':>10} "
        f"{'p50 ms':>10} {'p99 ms':>10} {'max ms':>10}  slowest trace",
        "-" * 116,
    ]
    for row in rows:
        trace_col = str(row.get("max_trace") or "-")
        lines.append(
            f"{row['name'][:36]:<36} {row['count']:>7} {row['total_ms']:>12.2f} "
            f"{row['mean_ms']:>10.3f} {row['p50_ms']:>10.3f} "
            f"{row['p99_ms']:>10.3f} {row['max_ms']:>10.2f}  {trace_col[:24]}"
        )
    # the SLO plane's series get their own section instead of being
    # buried in (or silently dropped from) the generic counter list: a
    # post-mortem reader's first question about an exported incident is
    # "what was alerting", not "what was counting"
    slo_rows = {
        name: counters[name]
        for name in sorted(counters or {})
        if name.partition("|")[0].startswith(("slo.", "alert.", "canary."))
    }
    transitions = [
        r
        for r in records
        if r.get("type") == "event"
        and str(r.get("name", "")).startswith(("alert-", "canary-", "slo-"))
    ]
    if slo_rows or transitions:
        lines += ["", "slo / alert plane:"]
        for name, value in slo_rows.items():
            shown = f"{value:.4f}" if isinstance(value, float) and value % 1 else f"{int(value)}"
            lines.append(f"  {name:<40} {shown:>14}")
        for rec in transitions[-12:]:
            attrs = rec.get("attrs") or {}
            detail = ", ".join(f"{k}={attrs[k]}" for k in sorted(attrs) if k != "trace_id")
            lines.append(f"  event {rec['name']:<20} {detail[:80]}")
    if histograms:
        lines += ["", "histograms (registry, log-spaced buckets):"]
        if not hists:
            lines.append("  (export carries no histogram snapshot)")
        for name in sorted(hists):
            hist = hists[name]
            count = hist.get("count", 0)
            if not count:
                continue
            p50, p90, p99 = (
                _hist_percentile(hist, q) for q in (0.50, 0.90, 0.99)
            )
            line = (
                f"  {name[:38]:<38} {count:>7} obs "
                f"p50 {p50:>10.3f}  p90 {p90:>10.3f}  p99 {p99:>10.3f}"
            )
            # the exemplar of the highest populated bucket IS the request
            # behind the histogram's tail — name it next to the p99 (the
            # exposition layer emits the same ids per bucket on /metrics)
            exemplars = hist.get("exemplars") or {}
            if exemplars:
                top_bucket = max(exemplars, key=lambda b: int(b))
                line += f"  p99 trace {exemplars[top_bucket][0]}"
            lines.append(line)
    if counters:
        lines += ["", "counters/gauges:"]
        for name in sorted(counters):
            value = counters[name]
            shown = f"{value:.2f}" if isinstance(value, float) and value % 1 else f"{int(value)}"
            lines.append(f"  {name:<40} {shown:>14}")
    return lines


def _load_costs(path: str | None) -> tuple[dict, dict, str | None]:
    """(cost_by_program, cost_by_tenant, replica) — from a file (a
    ``/debug/costs`` scrape — possibly ``?tenant=``/``?top=``-filtered —
    a serve ``stats`` line, or a bare ``{label: row}`` mapping) or, with
    no file, from the live in-process ledger. ``replica`` is the scrape's
    fleet identity stamp when it carries one."""
    if path is None:
        return cost_by_program(), cost_by_tenant(), None
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: expected a JSON object, got {type(payload).__name__}")
    if "cost_by_program" in payload:
        return (
            payload.get("cost_by_program") or {},
            payload.get("cost_by_tenant") or {},
            payload.get("replica"),
        )
    # a serve `stats` response line carries the ledger under cache stats
    stats = payload.get("cache") or {}
    if "cost_by_program" in stats:
        return (
            stats.get("cost_by_program") or {},
            stats.get("cost_by_tenant") or {},
            None,
        )
    return payload, {}, None


def _cost_lines(
    programs: dict, tenants: dict, top: int | None = None, source: str = "live process"
) -> list[str]:
    """The ``costs`` CLI table: ledger rows ranked by total device time —
    the operator's top-N answer to "which compiled program (and which
    tenant) is the chip actually spending itself on"."""
    lines = [f"cost ledger — {source}"]
    for title, table in (("program", programs), ("tenant", tenants)):
        if title == "tenant" and not table:
            continue  # tenants are opt-in; an all-untagged run has none
        ranked = sorted(
            table.items(),
            key=lambda kv: (-float(kv[1].get("device_ms", 0.0)),
                            -int(kv[1].get("dispatches", 0))),
        )
        if top is not None:
            dropped = max(0, len(ranked) - top)
            ranked = ranked[:top]
        else:
            dropped = 0
        lines += [
            "",
            f"{'%s key' % title:<44} {'disp':>6} {'device ms':>11} {'max ms':>9} "
            f"{'MBytes':>9} {'compiles':>8} {'cmpl ms':>9} {'hbm peak':>10}  slow trace",
            "-" * 132,
        ]
        if not ranked:
            lines.append(f"  (no {title} entries recorded)")
        for label, row in ranked:
            lines.append(
                f"{label[:44]:<44} {int(row.get('dispatches', 0)):>6} "
                f"{float(row.get('device_ms', 0.0)):>11.2f} "
                f"{float(row.get('device_ms_max', 0.0)):>9.2f} "
                f"{float(row.get('bytes', 0)) / 1e6:>9.2f} "
                f"{int(row.get('compiles', 0)):>8} "
                f"{float(row.get('compile_ms', 0.0)):>9.1f} "
                f"{_fmt_bytes(row.get('hbm_peak', 0.0)):>10}  "
                f"{str(row.get('last_slow_trace') or '-')[:24]}"
            )
        if dropped:
            lines.append(f"  ... {dropped} more {title} row(s) below --top")
    return lines


def _load_programs(path: str | None) -> tuple[dict, str | None]:
    """(program rows, replica stamp) — from a ``/debug/programs`` scrape
    (possibly ``?top=``/``?program=``-filtered) or a bare ``{label: row}``
    mapping; with no file, the live in-process card/ledger join."""
    if path is None:
        from . import costmodel

        report = costmodel.program_report()
        return report["programs"], None
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict):
        raise ValueError(
            f"{path}: expected a JSON object, got {type(payload).__name__}"
        )
    if "programs" in payload:
        return payload.get("programs") or {}, payload.get("replica")
    return payload, None


def _program_lines(
    rows: dict, top: int | None = None, source: str = "live process"
) -> list[str]:
    """The ``programs`` CLI table: compiled-program cards joined with the
    observed ledger, ranked by observed device time — the operator's
    answer to "is this program GOOD, not just how long did it take"."""
    ranked = sorted(
        rows.items(),
        key=lambda kv: (
            -float((kv[1].get("observed") or {}).get("device_ms", 0.0)),
            -int((kv[1].get("observed") or {}).get("dispatches", 0)),
            kv[0],
        ),
    )
    dropped = 0
    if top is not None:
        dropped = max(0, len(ranked) - top)
        ranked = ranked[:top]
    lines = [
        f"compiled-program cards — {source}",
        "",
        f"{'program':<40} {'flops':>11} {'MB acc':>8} {'pred ms':>9} "
        f"{'obs ms/disp':>12} {'util':>7} {'drift':>7} {'disp':>6}  analysis",
        "-" * 118,
    ]
    if not ranked:
        lines.append("  (no program cards recorded)")
    for label, row in ranked:
        obs = row.get("observed") or {}
        obs_ms = row.get("observed_ms_per_dispatch")
        util = row.get("utilization")
        drift = row.get("drift_ratio")
        lines.append(
            f"{label[:40]:<40} {float(row.get('flops', 0.0)):>11.3g} "
            f"{float(row.get('bytes_accessed', 0.0)) / 1e6:>8.2f} "
            f"{float(row.get('predicted_ms', 0.0)):>9.4f} "
            f"{('%.3f' % obs_ms) if obs_ms is not None else '-':>12} "
            f"{('%.1f%%' % (100 * util)) if util is not None else '-':>7} "
            f"{('%.1fx' % drift) if drift is not None else '-':>7} "
            f"{int(obs.get('dispatches', 0)):>6}  {str(row.get('analysis', '?'))[:20]}"
        )
    if dropped:
        lines.append(f"  ... {dropped} more program row(s) below --top")
    return lines


def _drift_lines(report: dict) -> list[str]:
    """The drift-sentinel table (``programs --drift``)."""
    lines = [
        f"drift sentinel — threshold {report['threshold']:g}x, "
        f"overhead floor {report['overhead_ms']:g} ms",
        "",
        f"{'program':<44} {'obs ms/disp':>12} {'model ms':>10} {'drift':>8}  verdict",
        "-" * 92,
    ]
    if not report["rows"]:
        lines.append("  (no program has both a card and observed dispatches)")
    for row in report["rows"]:
        lines.append(
            f"{row['program'][:44]:<44} "
            f"{float(row.get('observed_ms_per_dispatch') or 0.0):>12.3f} "
            f"{float(row.get('model_ms') or 0.0):>10.4f} "
            f"{float(row.get('drift_ratio') or 0.0):>7.1f}x  "
            f"{'DRIFT' if row['flagged'] else 'ok'}"
        )
    if report["flagged"]:
        lines += ["", f"{len(report['flagged'])} program(s) flagged: "
                  + ", ".join(report["flagged"])]
    else:
        lines += ["", "clean: no program diverges from the model"]
    return lines


def _load_slo(path: str | None) -> tuple[dict, str | None]:
    """(``/slo`` payload, replica stamp) — from a scrape file, or a fresh
    live evaluation when no file is given."""
    if path is None:
        from . import slo

        return slo.evaluate(), None
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or "objectives" not in payload:
        raise ValueError(f"{path}: expected a /slo JSON payload with 'objectives'")
    return payload, payload.get("replica")


def _slo_lines(payload: dict, source: str = "live process") -> list[str]:
    """The ``slo`` CLI table: one row per (objective, window rule) with
    burn rates against thresholds, then the alert rows — the operator's
    terminal answer to "are we in or out of budget, and is it paging"."""
    lines = [
        f"slo report — {source}"
        + ("" if payload.get("healthy", True) else "  ** ALERT FIRING **"),
        "",
        f"{'objective':<22} {'kind':<13} {'target':>8} {'budget':>8} "
        f"{'window':<8} {'sev':<7} {'burn s':>9} {'burn l':>9} {'thresh':>7}  state",
        "-" * 110,
    ]
    for obj in payload.get("objectives", []):
        for i, win in enumerate(obj.get("windows", [])):
            lead = obj["name"] if i == 0 else ""
            kind = obj.get("kind", "?") if i == 0 else ""
            target = f"{obj.get('target', 0):.4g}" if i == 0 else ""
            budget = f"{obj.get('budget_remaining', 0):.3f}" if i == 0 else ""
            lines.append(
                f"{lead[:22]:<22} {kind:<13} {target:>8} {budget:>8} "
                f"{str(win.get('window', '?'))[:8]:<8} {str(win.get('severity', '?')):<7} "
                f"{float(win.get('burn_short', 0)):>9.2f} "
                f"{float(win.get('burn_long', 0)):>9.2f} "
                f"{float(win.get('burn_threshold', 0)):>7.1f}  "
                f"{'BREACH' if win.get('breach') else 'ok'}"
            )
    alerts = payload.get("alerts") or []
    lines += ["", f"alerts ({len(alerts)}):"]
    if not alerts:
        lines.append("  (none — state machine clean)")
    for a in alerts:
        lines.append(
            f"  {a.get('state', '?'):<9} {a.get('severity', '?'):<7} "
            f"{a.get('objective', '?')}/{a.get('window', '?')}  "
            f"burn {float(a.get('burn_short', 0)):.2f}/{float(a.get('burn_long', 0)):.2f}"
        )
    return lines


def _fmt_bytes(value: Any) -> str:
    value = float(value or 0.0)
    if value <= 0:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if value < 1024 or unit == "TiB":
            return f"{value:.1f}{unit}" if unit != "B" else f"{int(value)}B"
        value /= 1024
    return f"{value:.1f}TiB"


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m flox_tpu_torch.telemetry",
        description="Inspect flox_tpu_torch telemetry exports.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    rep = sub.add_parser("report", help="per-phase summary table of an export file")
    rep.add_argument("file", help="a .jsonl or Chrome-trace .json telemetry export")
    rep.add_argument(
        "--histograms", action="store_true",
        help="also print the registry histograms (per-metric p50/p90/p99)",
    )
    costs = sub.add_parser(
        "costs",
        help="per-program (and per-tenant) cost-ledger table, ranked by "
        "device time — reads a /debug/costs scrape or serve stats JSON, "
        "or the live in-process ledger when no file is given",
    )
    costs.add_argument(
        "file", nargs="?", default=None,
        help="a /debug/costs JSON scrape (default: the in-process ledger)",
    )
    costs.add_argument(
        "--top", type=int, default=None, metavar="K",
        help="show only the K most expensive rows per axis",
    )
    progs = sub.add_parser(
        "programs",
        help="compiled-program card table (analytical flops/bytes, roofline "
        "predicted ms, observed-vs-predicted drift) — reads a "
        "/debug/programs scrape, or the live in-process registry when no "
        "file is given",
    )
    progs.add_argument(
        "file", nargs="?", default=None,
        help="a /debug/programs JSON scrape (default: the live registry)",
    )
    progs.add_argument(
        "--top", type=int, default=None, metavar="K",
        help="show only the K rows with the most observed device time",
    )
    progs.add_argument(
        "--drift", action="store_true",
        help="run the drift sentinel over the rows instead: exit 2 when any "
        "program's observed time diverges past the threshold, 0 when clean",
    )
    progs.add_argument(
        "--threshold", type=float, default=None, metavar="N",
        help="drift ratio that flags a program (default: "
        "OPTIONS['costmodel_drift_threshold'])",
    )
    slo_cmd = sub.add_parser(
        "slo",
        help="SLO burn-rate and alert-state table: reads a /slo JSON scrape, "
        "or evaluates the live in-process objectives when no file is given",
    )
    slo_cmd.add_argument(
        "file", nargs="?", default=None,
        help="a /slo JSON scrape (default: evaluate the live objectives)",
    )
    srv = sub.add_parser(
        "serve-metrics",
        help="standalone /metrics + /healthz + /readyz HTTP endpoint (Prometheus text "
        "format, standard library only)",
    )
    srv.add_argument(
        "--port", type=int, default=None,
        help="TCP port (default: OPTIONS['metrics_port'] or 8000; 0 picks an ephemeral "
        "port and prints it)",
    )
    srv.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)
    if args.command == "serve-metrics":
        # a process whose only job is to be scraped: telemetry forced on, ready
        # at once (no warmup manifest), SIGTERM leaving a flight record
        from . import exposition, profiling
        from .options import OPTIONS, set_options

        set_options(telemetry=True)
        install_signal_dumps()
        profiling.install_capture_signal()
        port = args.port if args.port is not None else (OPTIONS["metrics_port"] or 8000)
        bound = exposition.start_metrics_server(port=port, host=args.host)
        exposition.set_ready(True)
        print(f"serving /metrics /healthz /readyz on http://{args.host}:{bound}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            exposition.stop_metrics_server()
        return 0
    if args.command == "slo":
        try:
            payload, replica = _load_slo(args.file)
            source = args.file or "live process"
            if replica:
                source = f"{source} (replica {replica})"
        except OSError as exc:
            parser.error(f"cannot read {args.file}: {exc}")
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            parser.error(f"{args.file} is not a readable /slo export: {exc}")
        print("\n".join(_slo_lines(payload, source=source)))
        # exit 2 while an alert fires: a deploy gate is one call
        return 0 if payload.get("healthy", True) else 2
    if args.command == "costs":
        if args.top is not None and args.top < 1:
            parser.error("--top must be >= 1")
        try:
            programs, tenants, replica = _load_costs(args.file)
            source = args.file or "live process"
            if replica:
                source = f"{source} (replica {replica})"
            lines = _cost_lines(programs, tenants, top=args.top, source=source)
        except OSError as exc:
            parser.error(f"cannot read {args.file}: {exc}")
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            parser.error(f"{args.file} is not a readable cost export: {exc}")
        print("\n".join(lines))
        return 0
    if args.command == "programs":
        if args.top is not None and args.top < 1:
            parser.error("--top must be >= 1")
        if args.threshold is not None and args.threshold <= 0:
            parser.error("--threshold must be > 0")
        try:
            rows, replica = _load_programs(args.file)
            source = args.file or "live process"
            if replica:
                source = f"{source} (replica {replica})"
            if args.drift:
                from . import costmodel

                report = costmodel.drift_report(rows, threshold=args.threshold)
                print("\n".join(_drift_lines(report)))
                return 2 if report["flagged"] else 0
            lines = _program_lines(rows, top=args.top, source=source)
        except OSError as exc:
            parser.error(f"cannot read {args.file}: {exc}")
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            parser.error(f"{args.file} is not a readable program-card export: {exc}")
        print("\n".join(lines))
        return 0
    try:
        lines = _report_lines(args.file, histograms=args.histograms)
    except OSError as exc:
        parser.error(f"cannot read {args.file}: {exc}")
    except (ValueError, KeyError, TypeError) as exc:
        # ValueError covers json.JSONDecodeError AND _parse_export's
        # malformed-line error (which names file:line) — both exit non-zero
        parser.error(f"{args.file} is not a readable telemetry export: {exc}")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
