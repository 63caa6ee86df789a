"""Live metrics exposition: a Prometheus endpoint on the standard library
alone (the port of ``flox_tpu/exposition.py``).

* :func:`prometheus_text` renders ``telemetry.METRICS`` in the Prometheus
  text exposition format (version 0.0.4): counters as ``*_total``, gauges
  plain, histograms with cumulative ``_bucket{le=...}`` series over the
  shared :data:`~flox_tpu_torch.telemetry.HIST_EDGES_MS` edges plus
  ``_sum``/``_count``. Metric names are the reference's (``flox_tpu_`` + the
  registry name with non-identifier characters folded to ``_``), so one
  dashboard reads both packages. A registry name carrying ``|key=value``
  suffixes renders as a labeled series of the base metric
  (``serve.request_ms|tenant=acme`` -> ``flox_tpu_serve_request_ms
  {tenant="acme"}``). Buckets that remember an exemplar emit it
  OpenMetrics-style when asked (``/metrics?exemplars=1``).
* :class:`MetricsServer` / :func:`start_metrics_server`: a
  ``ThreadingHTTPServer`` on a daemon thread serving ``/metrics``,
  ``/healthz`` (200 while the process lives), ``/readyz`` (200 only after
  :func:`set_ready`: the serve loop flips it once its warmup manifest is
  replayed, and a drain or a device loss flips it back with a reason),
  ``/debug/costs`` (the cost ledger), ``/debug/programs`` (cost cards joined
  with the ledger), ``/debug/datasets`` (the resident dataset registry),
  ``/debug/stores`` (the durable stores) and ``/debug/profile?seconds=N``
  (an on-demand capture; 409 while one runs, 501 where there is no
  profiler). ``/slo`` and ``/alerts`` run one SLO evaluation each
  (:mod:`.slo`; 500 for an invalid spec). Starting the server seeds the
  saturation and resident-state gauges and the SLO gauges and starts the
  opt-in saturation sampler (``OPTIONS["metrics_sample_interval"]``).

``python -m flox_tpu_torch.serve`` starts it when ``OPTIONS["metrics_port"]``
(env ``FLOX_TPU_METRICS_PORT``) or ``--metrics-port`` is nonzero.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

__all__ = [
    "MetricsServer",
    "prometheus_text",
    "ready",
    "ready_reason",
    "set_ready",
    "start_metrics_server",
    "stop_metrics_server",
]

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _parse_top(params: dict) -> tuple[int | None, tuple[bytes, int] | None]:
    """Parse a ``?top=K`` query param shared by the ``/debug/*`` endpoints:
    ``(K, None)`` for a valid positive integer, ``(None, None)`` when
    absent, and ``(None, (body, 400))`` for anything malformed — one
    contract, one implementation, both endpoints."""
    top_raw = params.get("top", [None])[0]
    if top_raw is None:
        return None, None
    try:
        top = int(top_raw)
    except ValueError:
        top = -1
    if top < 1:
        body = (
            json.dumps(
                {"ok": False, "error": f"top must be a positive integer, got {top_raw!r}"}
            )
            + "\n"
        ).encode()
        return None, (body, 400)
    return top, None


def _top_rows(table: dict, top: int) -> dict:
    """The ``top`` most expensive ledger rows, ranked by device time then
    dispatch count — the same order the costs CLI prints."""
    ranked = sorted(
        table.items(),
        key=lambda kv: (
            -float(kv[1].get("device_ms", 0.0)),
            -int(kv[1].get("dispatches", 0)),
        ),
    )
    return dict(ranked[:top])

#: process-wide endpoint state: the live server (one per process — the
#: registry it exposes is process-wide too) and the readiness flag
_SERVER_STATE: dict[str, Any] = {"server": None, "ready": False, "reason": "warming"}
_STATE_LOCK = threading.Lock()


def set_ready(flag: bool = True, reason: str | None = None) -> None:
    """Flip the ``/readyz`` verdict. The serve loop calls this once its AOT
    warmup manifest has been replayed (immediately when there is nothing to
    replay); the drain path and device-loss recovery flip it back with a
    ``reason`` (``"draining"`` / ``"device-lost"``) that becomes the 503
    body, so a fleet router's probe log says WHY the replica left rotation."""
    with _STATE_LOCK:
        _SERVER_STATE["ready"] = bool(flag)
        _SERVER_STATE["reason"] = (
            "warming" if flag or reason is None else str(reason)
        )


def ready() -> bool:
    """Whether ``/readyz`` currently answers 200."""
    return bool(_SERVER_STATE["ready"])


def ready_reason() -> str:
    """The current 503 body for an unready replica (``"warming"`` at boot,
    ``"draining"`` during graceful shutdown, ``"device-lost"`` while the
    backend recovers)."""
    return str(_SERVER_STATE.get("reason") or "warming")


def _metric_name(name: str, suffix: str = "") -> str:
    return "flox_tpu_" + _NAME_BAD.sub("_", name) + suffix


def _escape_label(value: str) -> str:
    """A label value escaped per the exposition format (backslash, quote,
    newline) — shared by the ``|key=value`` labels and the exemplar trace
    ids, both of which can carry client-supplied strings."""
    return str(value).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _split_labels(name: str) -> tuple[str, str]:
    """Split a registry name into (base, rendered label pairs).

    Registry names may carry ``|key=value`` suffixes (the serve layer's
    ``serve.request_ms|tenant=acme``); each becomes a Prometheus label on
    the base metric."""
    base, sep, rest = name.partition("|")
    if not sep:
        return base, ""
    pairs = []
    for part in rest.split("|"):
        key, _, value = part.partition("=")
        pairs.append(f'{_NAME_BAD.sub("_", key)}="{_escape_label(value)}"')
    return base, ",".join(pairs)


def _fmt(value: float) -> str:
    value = float(value)
    if value.is_integer() and abs(value) < 2**63:
        return str(int(value))
    return repr(value)


def prometheus_text(exemplars: bool = True) -> str:
    """The telemetry registry in Prometheus text exposition format.

    Histogram buckets are cumulative (each ``le`` counts every observation
    at or below that edge), as the format requires — the registry stores
    per-bucket counts, so the walk accumulates. The final shared edge
    absorbs overflow in the registry, so ``le="+Inf"`` equals the total
    count by construction. ``|key=value`` registry-name suffixes become
    labels (one TYPE line per base metric, however many labeled series).

    With ``exemplars`` (the default for programmatic callers), bucket
    lines carrying an exemplar append it OpenMetrics-style after the
    sample value. The classic text format (version 0.0.4, what a default
    Prometheus scrape parses) does NOT allow exemplars — a scrape would
    abort on the first one — so the HTTP handler serves them only when the
    scraper asks (``/metrics?exemplars=1``), keeping the default scrape
    spec-clean.

    With ``OPTIONS["replica_id"]`` set, EVERY series additionally carries
    ``replica="<id>",host="<short hostname>"`` labels (merged ahead of any
    per-series ``|key=value`` labels) — the fleet-identity contract the
    reference's fleet federator keys its merge on. Unset (the
    single-replica default), the output is byte-identical to before.
    """
    from .telemetry import HIST_EDGES_MS, METRICS, host_name, replica_id

    rid = replica_id()
    identity = (
        f'replica="{_escape_label(rid)}",host="{_escape_label(host_name())}"'
        if rid is not None
        else ""
    )

    def _merge(labels: str) -> str:
        return ",".join(part for part in (identity, labels) if part)

    lines: list[str] = []
    typed: set[str] = set()

    def _type_line(metric: str, kind: str) -> None:
        if metric not in typed:
            typed.add(metric)
            lines.append(f"# TYPE {metric} {kind}")

    for name, value in sorted(METRICS.counters().items()):
        base, labels = _split_labels(name)
        labels = _merge(labels)
        metric = _metric_name(base, "_total")
        _type_line(metric, "counter")
        label_str = f"{{{labels}}}" if labels else ""
        lines.append(f"{metric}{label_str} {_fmt(value)}")
    for name, value in sorted(METRICS.gauges().items()):
        base, labels = _split_labels(name)
        labels = _merge(labels)
        metric = _metric_name(base)
        _type_line(metric, "gauge")
        label_str = f"{{{labels}}}" if labels else ""
        lines.append(f"{metric}{label_str} {_fmt(value)}")
    for name, hist in sorted(METRICS.histograms().items()):
        base, labels = _split_labels(name)
        labels = _merge(labels)
        metric = _metric_name(base)
        _type_line(metric, "histogram")
        prefix = f"{labels}," if labels else ""
        suffix_labels = f"{{{labels}}}" if labels else ""
        slots = (hist.get("exemplars") or {}) if exemplars else {}
        cum = 0
        for i, (edge, n) in enumerate(zip(HIST_EDGES_MS, hist["counts"])):
            cum += n
            line = f'{metric}_bucket{{{prefix}le="{_fmt(edge)}"}} {cum}'
            slot = slots.get(i)
            if slot is not None:
                # OpenMetrics exemplar: the trace id of the max observation
                # that landed in THIS bucket — the p99 row names its
                # request. Escaped: trace ids are client-supplied strings.
                line += f' # {{trace_id="{_escape_label(slot[0])}"}} {_fmt(slot[1])}'
            lines.append(line)
        lines.append(f'{metric}_bucket{{{prefix}le="+Inf"}} {hist["count"]}')
        lines.append(f"{metric}_sum{suffix_labels} {_fmt(hist['sum'])}")
        lines.append(f"{metric}_count{suffix_labels} {hist['count']}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self) -> None:  # noqa: N802 — http.server's naming contract
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            # count actual scrapes only — health/readiness probes arrive at
            # probe rate and would swamp the number otherwise
            from .telemetry import METRICS

            METRICS.inc("metrics.scrapes")
            # exemplars only on request: the classic 0.0.4 text parser (a
            # default Prometheus scrape) aborts the whole scrape on an
            # exemplar, so the plain endpoint must stay spec-clean
            params = urllib.parse.parse_qs(query)
            with_exemplars = params.get("exemplars", ["0"])[0] == "1"
            body = prometheus_text(exemplars=with_exemplars).encode()
            status, ctype = 200, "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            body, status, ctype = b"ok\n", 200, "text/plain; charset=utf-8"
        elif path == "/readyz":
            if ready():
                body, status = b"ready\n", 200
            else:
                # the reason IS the payload: "warming" at boot, "draining"
                # during graceful shutdown, "device-lost" mid-recovery
                body, status = ready_reason().encode() + b"\n", 503
            ctype = "text/plain; charset=utf-8"
        elif path == "/debug/costs":
            body, status = self._costs(query)
            ctype = "application/json; charset=utf-8"
        elif path == "/debug/programs":
            body, status = self._programs(query)
            ctype = "application/json; charset=utf-8"
        elif path == "/debug/datasets":
            body, status = self._datasets(query)
            ctype = "application/json; charset=utf-8"
        elif path == "/debug/stores":
            body, status = self._stores(query)
            ctype = "application/json; charset=utf-8"
        elif path == "/debug/profile":
            body, status = self._profile(query)
            ctype = "application/json; charset=utf-8"
        elif path == "/slo":
            body, status = self._slo()
            ctype = "application/json; charset=utf-8"
        elif path == "/alerts":
            body, status = self._alerts()
            ctype = "application/json; charset=utf-8"
        else:
            body, status, ctype = b"not found\n", 404, "text/plain; charset=utf-8"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _costs(query: str = "") -> tuple[bytes, int]:
        """The cost ledger as JSON — the machine-readable face of
        ``cache.stats()["cost_by_program"]`` (``python -m
        flox_tpu_torch.telemetry costs`` tabulates the same ledger).

        ``?tenant=<label>`` narrows the tenant axis to that (sanitized)
        label; ``?top=K`` keeps only the K most expensive rows per axis,
        ranked exactly as the costs CLI ranks them (device time, then
        dispatches) — so a fleet scrape of 40 replicas does not have to
        ship every cold row just to build a top-10 table. A malformed
        ``top`` is a 400, never a silent full dump."""
        from . import telemetry

        params = urllib.parse.parse_qs(query)
        top, error = _parse_top(params)
        if error is not None:
            return error
        tenant = params.get("tenant", [None])[0]
        programs = telemetry.cost_by_program()
        tenants = telemetry.cost_by_tenant()
        if tenant is not None:
            # sanitize-only (register=False): a GET filter for a tenant
            # nobody ever billed must not burn a cardinality slot
            wanted = telemetry.tenant_label(tenant, register=False)
            tenants = {k: v for k, v in tenants.items() if k == wanted}
        if top is not None:
            programs = _top_rows(programs, top)
            tenants = _top_rows(tenants, top)
        payload = {
            "cost_by_program": programs,
            "cost_by_tenant": tenants,
            "hbm_by_program": {
                k: v for k, v in telemetry.hbm_by_program().items() if k in programs
            },
            "replica": telemetry.replica_instance(),
            "host": telemetry.host_name(),
        }
        return (json.dumps(payload, default=str) + "\n").encode(), 200

    @staticmethod
    def _programs(query: str = "") -> tuple[bytes, int]:
        """The compiled-program card table joined with the observed cost
        ledger, as JSON — the machine-readable face of
        ``costmodel.program_report()``.

        ``?top=K`` keeps the K rows with the most observed device time
        (malformed = 400, same contract as ``/debug/costs``);
        ``?program=<substr>`` narrows to labels containing the substring."""
        from . import costmodel, telemetry

        params = urllib.parse.parse_qs(query)
        top, error = _parse_top(params)
        if error is not None:
            return error
        program = params.get("program", [None])[0]
        payload = costmodel.program_report(top=top, program=program)
        payload["replica"] = telemetry.replica_instance()
        payload["host"] = telemetry.host_name()
        return (json.dumps(payload, default=str) + "\n").encode(), 200

    @staticmethod
    def _datasets(query: str = "") -> tuple[bytes, int]:
        """The resident-dataset registry as JSON: every pinned entry (bytes,
        pins, hits, selector-view count), the HBM budget verdict, eviction
        count, and the per-dataset cost ledger — the operator's answer to
        "what is holding device memory and is it earning its keep".

        ``?top=K`` keeps the K most-hit entries (malformed = 400, same
        contract as the other ``/debug/*`` endpoints)."""
        from . import telemetry
        from .serve import registry

        params = urllib.parse.parse_qs(query)
        top, error = _parse_top(params)
        if error is not None:
            return error
        payload = registry.debug_table(top=top)
        payload["replica"] = telemetry.replica_instance()
        payload["host"] = telemetry.host_name()
        return (json.dumps(payload, default=str) + "\n").encode(), 200

    @staticmethod
    def _stores(query: str = "") -> tuple[bytes, int]:
        """The durable aggregation stores as JSON: every open store's
        generation, ingested-slab count, present-group count, segment count
        and state bytes, plus the per-store cost-ledger join — the
        operator's answer to "what incremental state does this replica
        carry and how far has it advanced".

        ``?top=K`` keeps the K highest-generation stores (malformed = 400,
        same contract as the other ``/debug/*`` endpoints)."""
        from . import telemetry
        from .serve import stores

        params = urllib.parse.parse_qs(query)
        top, error = _parse_top(params)
        if error is not None:
            return error
        payload = stores.debug_table(top=top)
        payload["replica"] = telemetry.replica_instance()
        payload["host"] = telemetry.host_name()
        return (json.dumps(payload, default=str) + "\n").encode(), 200

    @staticmethod
    def _slo() -> tuple[bytes, int]:
        """One SLO evaluation as JSON: per-objective burn rates against every
        window rule, budget remaining, and the alert rows. Evaluating on
        scrape keeps the endpoint and the alert state machine in step; an
        invalid configured spec is a 500."""
        from . import slo, telemetry

        try:
            payload = slo.evaluate()
        except ValueError as exc:
            return (json.dumps({"error": str(exc)}) + "\n").encode(), 500
        payload["replica"] = telemetry.replica_instance()
        payload["host"] = telemetry.host_name()
        return (json.dumps(payload, default=str) + "\n").encode(), 200

    @staticmethod
    def _alerts() -> tuple[bytes, int]:
        """The alert rows as JSON, evaluated fresh as ``/slo`` is."""
        from . import slo, telemetry

        try:
            payload = slo.evaluate()
        except ValueError as exc:
            return (json.dumps({"error": str(exc)}) + "\n").encode(), 500
        body = {
            "alerts": payload["alerts"],
            "healthy": payload["healthy"],
            "evaluated_at": payload["evaluated_at"],
            "replica": telemetry.replica_instance(),
            "host": telemetry.host_name(),
        }
        return (json.dumps(body, default=str) + "\n").encode(), 200

    @staticmethod
    def _profile(query: str) -> tuple[bytes, int]:
        """Start an on-demand on-chip capture (``?seconds=N``, default 5).

        202 with the capture dir on success (the stop runs on a timer
        thread — the reply never blocks behind the window), 409 while a
        capture is already running, 501 when the backend has no profiler
        or no capture root is configured, 400 for a bad window. Never
        raises into the serve loop."""
        from . import profiling

        try:
            params = urllib.parse.parse_qs(query)
            seconds = float(params.get("seconds", ["5"])[0])
            capture_dir = profiling.start_capture(seconds=seconds)
        except profiling.CaptureBusyError as exc:
            return (json.dumps({"ok": False, "error": str(exc)}) + "\n").encode(), 409
        except profiling.CaptureUnavailableError as exc:
            return (json.dumps({"ok": False, "error": str(exc)}) + "\n").encode(), 501
        except (ValueError, TypeError) as exc:
            return (json.dumps({"ok": False, "error": str(exc)}) + "\n").encode(), 400
        except Exception as exc:  # noqa: BLE001 — observability never kills serving
            return (json.dumps({"ok": False, "error": str(exc)}) + "\n").encode(), 500
        payload = {"ok": True, "dir": capture_dir, "seconds": seconds}
        return (json.dumps(payload) + "\n").encode(), 202

    def log_message(self, format: str, *args: Any) -> None:
        # a probe every few seconds must not spam stderr; scrape counts
        # are visible in the registry itself (metrics.scrapes)
        pass


class MetricsServer:
    """The background exposition endpoint: a ``ThreadingHTTPServer`` on a
    daemon thread. ``port=0`` binds an ephemeral port; :attr:`port` is the
    bound one either way."""

    def __init__(self, port: int, host: str = "127.0.0.1") -> None:
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="flox-tpu-torch-metrics",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_metrics_server(port: int | None = None, host: str = "127.0.0.1") -> int | None:
    """Start (or reuse) the process-wide exposition endpoint.

    ``port=None`` reads ``OPTIONS["metrics_port"]`` — 0 there means the
    endpoint is off and this returns ``None``. An explicit ``port``
    argument always starts one (0 = ephemeral). Returns the bound port;
    idempotent while a server is already running (the registry is
    process-wide, so one endpoint is the right number of endpoints).
    """
    if port is None:
        from .options import OPTIONS

        port = OPTIONS["metrics_port"]
        if not port:
            return None
    from . import telemetry

    with _STATE_LOCK:
        server = _SERVER_STATE["server"]
        if server is None:
            server = MetricsServer(int(port), host=host)
            _SERVER_STATE["server"] = server
    # a freshly booted replica must EXPOSE the saturation series before its
    # first request — an absent gauge reads as a broken scrape, a zero
    # reads as idle. Idempotent (live values are never rewound), and the
    # opt-in sampler (OPTIONS["metrics_sample_interval"]) starts with the
    # endpoint it feeds.
    telemetry.seed_saturation_gauges()
    # the HBM capacity denominator is static per backend: publish it once
    # at endpoint start so utilization math never reads an absent gauge
    telemetry.seed_hbm_limit()
    telemetry.start_saturation_sampler()
    # the resident-state gauges (registry occupancy, store staleness) and
    # one SLO evaluation seed with the endpoint too: an idle replica must
    # show them, and /slo its budgets, from the first scrape
    telemetry.sample_resident_state()
    from . import slo

    slo.seed_gauges()
    return server.port


def stop_metrics_server() -> None:
    """Shut the endpoint down (tests; the serve loop just exits — the
    thread is a daemon). Readiness and the saturation sampler reset with
    it."""
    from . import telemetry

    telemetry.stop_saturation_sampler()
    with _STATE_LOCK:
        server = _SERVER_STATE.pop("server", None)
        _SERVER_STATE["server"] = None
        _SERVER_STATE["ready"] = False
        _SERVER_STATE["reason"] = "warming"
    if server is not None:
        server.close()
