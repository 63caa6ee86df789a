"""Fleet federation: one merged view of N serving replicas (the port of
``flox_tpu/fleet.py``, stdlib only like the reference).

* :class:`Federator` scrapes every configured replica's
  ``/metrics?exemplars=1``, ``/debug/costs`` and ``/readyz`` on an interval
  (``OPTIONS["fleet_scrape_interval"]``) and serves the merged view:
  counters and gauges summed over replicas (each replica's series kept
  under ``replica="<name>"``), histograms summed bucket by bucket over
  shared edges (exemplars max-merged; mismatched edges are a per-metric
  merge error, :func:`merge_histograms`), cost ledgers unioned
  (:func:`merge_cost_rows`) and a readiness table. It also reads each
  replica's ``/debug/datasets``, ``/debug/stores`` and ``/slo``: resident
  state federates per name, and alert rows dedup by (objective, window,
  replica) with the most live state winning.
* ``python -m flox_tpu_torch.fleet federate`` serves ``/metrics``,
  ``/debug/costs``, ``/replicas``, ``/alerts``, ``/slo``, ``/healthz`` and
  ``/readyz`` (200 while at least one replica is ready).
* ``python -m flox_tpu_torch.fleet top`` renders per-replica qps, p50/p99
  latency, queue depth, open breakers, device memory, resident state,
  alerts and the top cost rows (``--once`` one frame, ``--plain`` without
  the screen-clear escape, ``--json`` machine-readable).

The port's ``exposition.prometheus_text`` is the reference's, so port and
reference replicas federate together. Replica targets are
``name=http://host:port`` pairs or bare URLs, from ``--replicas`` or
``OPTIONS["fleet_replicas"]`` (``FLOX_TPU_FLEET_REPLICAS``). All state
lives on the :class:`Federator`; the module keeps no process-wide tables.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from .metric_names import (
    HBM_BYTES_IN_USE,
    HBM_BYTES_LIMIT,
    SERVE_BREAKERS_OPEN,
    SERVE_QUEUE_DEPTH,
    SERVE_REQUEST_MS,
    SERVE_REQUESTS,
    prom_name,
)

#: the scrape-side spellings of the series the top view reads, derived —
#: never respelled — from the shared registry names, so the fleet column
#: and the replica's exposition renderer cannot drift
_PROM_REQUESTS_TOTAL = prom_name(SERVE_REQUESTS, counter=True)
_PROM_REQUEST_MS = prom_name(SERVE_REQUEST_MS)
_PROM_QUEUE_DEPTH = prom_name(SERVE_QUEUE_DEPTH)
_PROM_BREAKERS_OPEN = prom_name(SERVE_BREAKERS_OPEN)
_PROM_HBM_IN_USE = prom_name(HBM_BYTES_IN_USE)
_PROM_HBM_LIMIT = prom_name(HBM_BYTES_LIMIT)

__all__ = [
    "Federator",
    "FleetMergeError",
    "ReplicaSnapshot",
    "federate",
    "merge_cost_rows",
    "merge_histograms",
    "parse_replica_targets",
    "parse_metrics_text",
    "render_prometheus",
    "render_top",
    "render_top_json",
]


class FleetMergeError(ValueError):
    """Two replicas' series for one metric cannot be merged — today that
    means mismatched histogram bucket edges (different builds, or a
    foreign exporter behind the scrape URL). Raised by
    :func:`merge_histograms` so the caller decides; the federator records
    it per metric and keeps the per-replica series instead of publishing a
    silently wrong sum."""


# ---------------------------------------------------------------------------
# scrape-side parsing
# ---------------------------------------------------------------------------

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_ESCAPE_RE = re.compile(r"\\(.)")
_IDENTITY_LABELS = ("replica", "host")


def _unescape(value: str) -> str:
    # single-pass: chained str.replace would decode the escaped literal
    # backslash-n (\\n) as backslash+newline instead of the original two
    # characters — each \x sequence must be resolved exactly once
    return _ESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), value
    )


def _parse_labels(text: str) -> dict[str, str]:
    return {k: _unescape(v) for k, v in _LABEL_RE.findall(text)}


def _labels_key(labels: dict[str, str]) -> tuple:
    """Canonical series identity: sorted label pairs, with the fleet
    identity labels (``replica``/``host``) and the histogram ``le`` edge
    stripped — identity is tracked per snapshot, edges per histogram."""
    return tuple(
        sorted(
            (k, v)
            for k, v in labels.items()
            if k not in _IDENTITY_LABELS and k != "le"
        )
    )


def parse_metrics_text(text: str) -> dict[str, Any]:
    """Parse the exposition layer's Prometheus text format back into
    mergeable structures.

    Returns ``{"counters": {(metric, labels): value}, "gauges": {...},
    "histograms": {(metric, labels): hist}, "replica": <self-reported
    label or None>}`` where ``hist`` carries the bucket ``edges`` (the
    ``le`` values in file order, ``+Inf`` excluded), the de-cumulated
    per-bucket ``counts``, ``sum``/``count``, and per-bucket ``exemplars``
    (``{bucket_index: [trace_id, value]}``). Malformed sample lines raise
    ``ValueError`` — a federator must know it is scraping garbage."""
    types: dict[str, str] = {}
    counters: dict[tuple, float] = {}
    gauges: dict[tuple, float] = {}
    hists: dict[tuple, dict] = {}
    replica: str | None = None
    #: distinct replica-label values seen (None = unlabeled series). A
    #: single replica's scrape has exactly one; more than one means the
    #: target is itself a federator (its output carries per-replica AND
    #: aggregate series) or a foreign exporter — folding those would
    #: silently double-count, so parsing rejects loudly instead.
    replicas_seen: set[str | None] = set()
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        sample, _, exemplar = line.partition(" # ")
        name_part, _, value_part = sample.rpartition(" ")
        if not name_part:
            raise ValueError(f"metrics line {lineno}: unparseable sample {line!r}")
        value = float(value_part)
        metric, brace, label_text = name_part.partition("{")
        if brace and not label_text.endswith("}"):
            raise ValueError(f"metrics line {lineno}: unclosed label set {line!r}")
        labels = _parse_labels(label_text[:-1]) if brace else {}
        if not metric.startswith("flox_tpu_fleet_"):
            replicas_seen.add(labels.get("replica"))
            if len(replicas_seen) > 1:
                raise ValueError(
                    f"metrics line {lineno}: scrape carries more than one "
                    f"replica identity ({sorted(str(r) for r in replicas_seen)}) "
                    "— federate replicas, not another federator's merged view"
                )
        if replica is None and "replica" in labels:
            replica = labels["replica"]
        key = (metric, _labels_key(labels))
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if metric.endswith(suffix) and types.get(metric[: -len(suffix)]) == "histogram":
                base = metric[: -len(suffix)]
                break
        if base is not None:
            hist = hists.setdefault(
                (base, _labels_key(labels)),
                {"edges": [], "cum": [], "sum": 0.0, "count": 0, "exemplars": {}},
            )
            if metric.endswith("_bucket"):
                edge = labels.get("le")
                if edge is None:
                    raise ValueError(f"metrics line {lineno}: bucket without le")
                if edge != "+Inf":
                    if exemplar:
                        ex_labels = _parse_labels(exemplar)
                        _, _, ex_value = exemplar.rpartition(" ")
                        trace = ex_labels.get("trace_id")
                        if trace is not None:
                            hist["exemplars"][len(hist["edges"])] = [
                                trace, float(ex_value),
                            ]
                    hist["edges"].append(float(edge))
                    hist["cum"].append(value)
            elif metric.endswith("_sum"):
                hist["sum"] = value
            else:
                hist["count"] = int(value)
        elif types.get(metric, "").startswith("counter") or metric.endswith("_total"):
            counters[key] = counters.get(key, 0.0) + value
        else:
            gauges[key] = gauges.get(key, 0.0) + value
    for hist in hists.values():
        cum = hist.pop("cum")
        hist["counts"] = [
            c - (cum[i - 1] if i else 0.0) for i, c in enumerate(cum)
        ]
    return {
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "replica": replica,
    }


# ---------------------------------------------------------------------------
# merge math
# ---------------------------------------------------------------------------


def merge_histograms(a: dict, b: dict) -> dict:
    """Merge two parsed histograms sharing one edge set: bucket counts,
    total count, and sum add; exemplars max-merge per bucket (the fleet's
    worst observation in that bucket names its trace). Mismatched edges
    raise :class:`FleetMergeError` — summing unlike buckets would
    fabricate a distribution nobody observed."""
    if list(a["edges"]) != list(b["edges"]):
        raise FleetMergeError(
            f"histogram bucket edges differ ({len(a['edges'])} vs "
            f"{len(b['edges'])} edges, first mismatch at index "
            f"{next((i for i, (x, y) in enumerate(zip(a['edges'], b['edges'])) if x != y), min(len(a['edges']), len(b['edges'])))}) "
            "— refusing to merge unlike buckets"
        )
    exemplars = {int(k): list(v) for k, v in a.get("exemplars", {}).items()}
    for bucket, slot in (b.get("exemplars") or {}).items():
        bucket = int(bucket)
        held = exemplars.get(bucket)
        if held is None or slot[1] >= held[1]:
            exemplars[bucket] = list(slot)
    return {
        "edges": list(a["edges"]),
        "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
        "sum": a["sum"] + b["sum"],
        "count": a["count"] + b["count"],
        "exemplars": exemplars,
    }


def merge_cost_rows(a: dict, b: dict) -> dict:
    """Union two cost-ledger rows for the same key: additive columns add,
    the max columns take the max — and ``last_slow_trace`` follows
    whichever row holds the fleet-wide worst dispatch."""
    out = {
        "dispatches": int(a.get("dispatches", 0)) + int(b.get("dispatches", 0)),
        "device_ms": float(a.get("device_ms", 0.0)) + float(b.get("device_ms", 0.0)),
        "bytes": int(a.get("bytes", 0)) + int(b.get("bytes", 0)),
        "compiles": int(a.get("compiles", 0)) + int(b.get("compiles", 0)),
        "compile_ms": float(a.get("compile_ms", 0.0)) + float(b.get("compile_ms", 0.0)),
        "hbm_peak": max(float(a.get("hbm_peak", 0.0)), float(b.get("hbm_peak", 0.0))),
    }
    wa, wb = float(a.get("device_ms_max", 0.0)), float(b.get("device_ms_max", 0.0))
    worst = a if wa >= wb else b
    out["device_ms_max"] = max(wa, wb)
    out["last_slow_trace"] = worst.get("last_slow_trace")
    return out


def _hist_percentile(hist: dict, q: float) -> float:
    """Interpolated percentile over a parsed/merged histogram (same walk
    as ``telemetry._hist_percentile``, minus the observed min/max clamp —
    scraped histograms don't carry them)."""
    count = hist.get("count") or 0
    if not count:
        return 0.0
    target = max(0.0, min(1.0, q)) * count
    cum = 0.0
    for i, c in enumerate(hist["counts"]):
        if not c:
            continue
        if cum + c >= target:
            lo = hist["edges"][i - 1] if i else 0.0
            hi = hist["edges"][i]
            return lo + ((target - cum) / c) * (hi - lo)
        cum += c
    return hist["edges"][-1] if hist["edges"] else 0.0


# ---------------------------------------------------------------------------
# replica snapshots + the federated view
# ---------------------------------------------------------------------------


@dataclass
class ReplicaSnapshot:
    """One scrape round's result for one replica."""

    name: str
    url: str
    ok: bool = False
    error: str | None = None
    ready: bool | None = None
    ready_reason: str = ""
    metrics: dict = field(default_factory=dict)
    costs: dict = field(default_factory=dict)
    programs: dict = field(default_factory=dict)
    datasets: dict = field(default_factory=dict)
    stores: dict = field(default_factory=dict)
    slo: dict = field(default_factory=dict)
    alerts: list = field(default_factory=list)
    scraped_at: float = 0.0

    @property
    def replica_label(self) -> str:
        """The identity the merged view attributes this replica's series
        to: its self-reported ``replica`` label when it set one, else the
        scrape-config name."""
        return (self.metrics or {}).get("replica") or self.name


def _http_get(url: str, timeout: float) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(errors="replace")


def scrape_replica(name: str, url: str, timeout: float = 5.0) -> ReplicaSnapshot:
    """One replica's ``/metrics?exemplars=1`` + ``/debug/costs`` +
    ``/readyz``, parsed. Network/parse failures mark the snapshot
    ``ok=False`` with the error — an unreachable replica is a ROW in the
    fleet view, never an aggregator crash."""
    snap = ReplicaSnapshot(name=name, url=url.rstrip("/"), scraped_at=time.time())
    try:
        status, body = _http_get(f"{snap.url}/metrics?exemplars=1", timeout)
        if status != 200:
            raise ValueError(f"/metrics answered {status}")
        snap.metrics = parse_metrics_text(body)
        status, body = _http_get(f"{snap.url}/debug/costs", timeout)
        if status == 200:
            snap.costs = json.loads(body)
        # compiled-program cards (costmodel plane): absent on replicas
        # running with the plane off — an empty table, never a scrape fail
        status, body = _http_get(f"{snap.url}/debug/programs", timeout)
        if status == 200:
            snap.programs = json.loads(body).get("programs") or {}
        # resident state (dataset registry + durable stores) and the SLO /
        # alert plane: soft scrapes — older replicas (or replicas with the
        # planes dark) simply contribute empty tables, never a scrape fail
        status, body = _http_get(f"{snap.url}/debug/datasets", timeout)
        if status == 200:
            snap.datasets = json.loads(body)
        status, body = _http_get(f"{snap.url}/debug/stores", timeout)
        if status == 200:
            snap.stores = json.loads(body)
        status, body = _http_get(f"{snap.url}/slo", timeout)
        if status == 200:
            snap.slo = json.loads(body)
            snap.alerts = list(snap.slo.get("alerts") or [])
        status, body = _http_get(f"{snap.url}/readyz", timeout)
        snap.ready = status == 200
        snap.ready_reason = body.strip()
        snap.ok = True
    except Exception as exc:  # noqa: BLE001 — one dead replica must not kill the view
        snap.error = f"{type(exc).__name__}: {exc}"
        snap.ok = False
    return snap


def federate(snapshots: list[ReplicaSnapshot]) -> dict[str, Any]:
    """Merge N replica snapshots into one fleet view.

    Counters/gauges: per-replica series preserved (keyed by replica
    label) plus the fleet sum. Histograms: bucket-summed over shared
    edges; a :class:`FleetMergeError` removes that metric's merged series
    and records the error under ``merge_errors`` (the per-replica series
    survive). Cost ledgers: unioned via :func:`merge_cost_rows` with a
    ``by_replica`` breakdown. Readiness: one row per replica."""
    view: dict[str, Any] = {
        "counters": {},     # (metric, labels) -> {"replicas": {name: v}, "total": v}
        "gauges": {},
        "histograms": {},   # (metric, labels) -> {"replicas": {...}, "merged": hist|None}
        "merge_errors": {},  # metric -> error text
        "cost_by_program": {},
        "cost_by_tenant": {},
        "cost_by_replica": {},
        "programs": {},     # card digest -> {card fields, labels, observed merged}
        "datasets": {},     # name -> {"bytes", "pins", "hits", "replicas": {...}}
        "stores": {},       # name -> {"state_bytes", "generations", "staleness_s", ...}
        "alerts": [],       # deduped alert rows, each tagged with its replica
        "slo": {},          # replica label -> that replica's /slo health summary
        "replicas": [],
    }
    #: (objective, window, replica) -> alert row — the dedup table behind
    #: view["alerts"]; a replica re-reporting one alert keeps the
    #: most-severe / most-live row (firing beats pending beats resolved)
    alert_table: dict[tuple, dict] = {}
    state_rank = {"firing": 0, "pending": 1, "resolved": 2}
    severity_rank = {"page": 0, "ticket": 1}
    for snap in snapshots:
        label = snap.replica_label
        view["replicas"].append(
            {
                "name": snap.name,
                "replica": label,
                "url": snap.url,
                "ok": snap.ok,
                "ready": snap.ready,
                "reason": snap.ready_reason,
                "error": snap.error,
                "scraped_at": snap.scraped_at,
                "host": (snap.costs or {}).get("host"),
            }
        )
        if not snap.ok:
            continue
        for kind in ("counters", "gauges"):
            for key, value in snap.metrics.get(kind, {}).items():
                slot = view[kind].setdefault(key, {"replicas": {}, "total": 0.0})
                slot["replicas"][label] = slot["replicas"].get(label, 0.0) + value
                slot["total"] += value
        for key, hist in snap.metrics.get("histograms", {}).items():
            slot = view["histograms"].setdefault(key, {"replicas": {}, "merged": None})
            slot["replicas"][label] = hist
            if key[0] in view["merge_errors"]:
                continue
            try:
                slot["merged"] = (
                    dict(hist, exemplars=dict(hist.get("exemplars") or {}))
                    if slot["merged"] is None
                    else merge_histograms(slot["merged"], hist)
                )
            except FleetMergeError as exc:
                view["merge_errors"][key[0]] = str(exc)
                slot["merged"] = None
        for axis in ("cost_by_program", "cost_by_tenant"):
            for row_key, row in (snap.costs.get(axis) or {}).items():
                held = view[axis].get(row_key)
                view[axis][row_key] = (
                    dict(row) if held is None else merge_cost_rows(held, row)
                )
                view["cost_by_replica"].setdefault(axis, {}).setdefault(
                    row_key, {}
                )[label] = dict(row)
        for prog_label, row in (snap.programs or {}).items():
            _merge_program_row(view["programs"], prog_label, row)
        for row in (snap.datasets or {}).get("datasets") or []:
            name = str(row.get("name"))
            slot = view["datasets"].setdefault(
                name, {"bytes": 0, "pins": 0, "hits": 0, "replicas": {}}
            )
            slot["bytes"] += int(row.get("nbytes", 0))
            slot["pins"] += int(row.get("pins", 0))
            slot["hits"] += int(row.get("hits", 0))
            slot["replicas"][label] = dict(row)
        for row in (snap.stores or {}).get("stores") or []:
            name = str(row.get("store"))
            slot = view["stores"].setdefault(
                name,
                {"state_bytes": 0, "generations": {}, "staleness_s": None, "replicas": {}},
            )
            slot["state_bytes"] += int(row.get("nbytes", 0))
            if row.get("gen") is not None:
                slot["generations"][label] = int(row["gen"])
            stale = row.get("staleness_s")
            if stale is not None:
                # the FRESHEST copy wins: one replica still ingesting means
                # the fleet's view of the store is that fresh
                held = slot["staleness_s"]
                slot["staleness_s"] = (
                    float(stale) if held is None else min(held, float(stale))
                )
            slot["replicas"][label] = dict(row)
        if snap.slo:
            view["slo"][label] = {
                "healthy": bool(snap.slo.get("healthy", True)),
                "evaluated_at": snap.slo.get("evaluated_at"),
                "objectives": [
                    {
                        "name": o.get("name"),
                        "kind": o.get("kind"),
                        "healthy": o.get("healthy"),
                        "budget_remaining": o.get("budget_remaining"),
                    }
                    for o in snap.slo.get("objectives") or []
                ],
            }
        for alert in snap.alerts or []:
            key = (alert.get("objective"), alert.get("window"), label)
            row = dict(alert, replica=label)
            held = alert_table.get(key)
            if held is None or (
                state_rank.get(row.get("state"), 9),
                severity_rank.get(row.get("severity"), 9),
            ) < (
                state_rank.get(held.get("state"), 9),
                severity_rank.get(held.get("severity"), 9),
            ):
                alert_table[key] = row
    view["alerts"] = sorted(
        alert_table.values(),
        key=lambda a: (
            state_rank.get(a.get("state"), 9),
            severity_rank.get(a.get("severity"), 9),
            str(a.get("objective")),
            str(a.get("replica")),
        ),
    )
    # a merge error poisons EVERY label set of its metric: sibling keys
    # processed before the error still hold a partial (first-replicas-only)
    # merged histogram, and publishing that as the fleet aggregate would be
    # exactly the silent mis-merge the error exists to prevent
    for (metric, _labels), slot in view["histograms"].items():
        if metric in view["merge_errors"]:
            slot["merged"] = None
    return view


def _merge_program_row(table: dict, label: str, row: dict) -> None:
    """Union one replica's compiled-program card row into the fleet view.

    Cards union by DIGEST (the (label, input signature) identity — two
    replicas serving the same program hold byte-identical analytical
    numbers, so the card fields come from whichever scraped first), labels
    accumulate, and the observed ledger rows merge exactly like cost rows.
    Utilization and drift recompute from the merged totals: utilization is
    model-time / observed-time, so ``predicted_ms x dispatches /
    device_ms`` holds across replicas."""
    digest = str(row.get("digest") or f"?{label}")
    held = table.get(digest)
    if held is None:
        # card fields only: the observed-JOIN fields (utilization,
        # achieved_*, drift) are per-replica numbers and must be
        # recomputed from the merged totals below, never copied from
        # whichever replica scraped first
        held = table[digest] = {
            k: v
            for k, v in row.items()
            if k
            not in (
                "observed", "label", "utilization", "achieved_gbps",
                "achieved_gflops", "observed_ms_per_dispatch", "drift_ratio",
            )
        }
        held["digest"] = digest  # present even for rows scraped without one
        held["labels"] = []
        held["observed"] = None
    if label not in held["labels"]:
        held["labels"].append(label)
    observed = row.get("observed")
    if observed:
        held["observed"] = (
            dict(observed)
            if held["observed"] is None
            else merge_cost_rows(held["observed"], observed)
        )
        merged = held["observed"]
        dispatches = int(merged.get("dispatches", 0))
        # compile-net, mirroring costmodel._net_device_ms: the merged row
        # carries the fleet's compile wall too, and cold replicas must not
        # read as fleet-wide drift
        device_ms = max(
            0.0,
            float(merged.get("device_ms", 0.0)) - float(merged.get("compile_ms", 0.0)),
        )
        predicted = float(held.get("predicted_ms") or 0.0)
        if dispatches > 0 and device_ms > 0:
            held["utilization"] = round(predicted * dispatches / device_ms, 6)
            held["observed_ms_per_dispatch"] = round(device_ms / dispatches, 6)
            seconds = device_ms / 1e3
            held["achieved_gbps"] = round(
                float(held.get("bytes_accessed") or 0.0) * dispatches / seconds / 1e9, 6
            )
            held["achieved_gflops"] = round(
                float(held.get("flops") or 0.0) * dispatches / seconds / 1e9, 6
            )
            model_ms = row.get("model_ms")
            if model_ms:
                held["model_ms"] = float(model_ms)
                held["drift_ratio"] = round(
                    (device_ms / dispatches) / float(model_ms), 6
                )


# ---------------------------------------------------------------------------
# rendering: merged /metrics text + the ops-console frame
# ---------------------------------------------------------------------------


def _esc(value: str) -> str:
    """Label-value escaping — the exposition layer's, single-sourced: the
    federated output must round-trip byte-identically with what the
    replicas emit."""
    from .exposition import _escape_label

    return _escape_label(value)


def _series(metric: str, labels: tuple, extra: str = "") -> str:
    pairs = [f'{k}="{_esc(v)}"' for k, v in labels]
    if extra:
        pairs.insert(0, extra)
    return f"{metric}{{{','.join(pairs)}}}" if pairs else metric


def _fmt_value(value: float) -> str:
    """Sample-value formatting — the exposition layer's (see :func:`_esc`)."""
    from .exposition import _fmt

    return _fmt(value)


def render_prometheus(view: dict[str, Any], exemplars: bool = False) -> str:
    """The federated view in the same text format the replicas speak.

    Every scraped series appears twice: once per replica under its
    ``replica="<label>"`` label, and once WITHOUT a replica label as the
    fleet aggregate (counters/gauges summed, histograms bucket-summed) —
    so both "sum by replica" dashboards and plain fleet-total queries read
    straight off one scrape. Fleet-level health (replica counts, scrape
    errors, per-metric merge errors) rides ``flox_tpu_fleet_*``."""
    lines: list[str] = []
    typed: set[str] = set()

    def _type_line(metric: str, kind: str) -> None:
        # one TYPE line per metric NAME, however many label sets — a
        # second one makes a spec-compliant scraper drop the whole scrape
        if metric not in typed:
            typed.add(metric)
            lines.append(f"# TYPE {metric} {kind}")

    replicas = view.get("replicas", [])
    lines.append("# TYPE flox_tpu_fleet_replicas gauge")
    lines.append(f"flox_tpu_fleet_replicas {len(replicas)}")
    lines.append("# TYPE flox_tpu_fleet_replicas_ready gauge")
    lines.append(
        f"flox_tpu_fleet_replicas_ready {sum(1 for r in replicas if r.get('ready'))}"
    )
    lines.append("# TYPE flox_tpu_fleet_scrape_errors gauge")
    lines.append(
        f"flox_tpu_fleet_scrape_errors {sum(1 for r in replicas if not r.get('ok'))}"
    )
    if view.get("merge_errors"):
        lines.append("# TYPE flox_tpu_fleet_merge_errors gauge")
        for metric in sorted(view["merge_errors"]):
            lines.append(
                f'flox_tpu_fleet_merge_errors{{metric="{_esc(metric)}"}} 1'
            )
    for kind, prom_type in (("counters", "counter"), ("gauges", "gauge")):
        for (metric, labels), slot in sorted(view.get(kind, {}).items()):
            _type_line(metric, prom_type)
            for replica in sorted(slot["replicas"]):
                extra = f'replica="{_esc(replica)}"'
                lines.append(
                    f"{_series(metric, labels, extra)} "
                    f"{_fmt_value(slot['replicas'][replica])}"
                )
            lines.append(f"{_series(metric, labels)} {_fmt_value(slot['total'])}")
    for (metric, labels), slot in sorted(view.get("histograms", {}).items()):
        _type_line(metric, "histogram")
        for replica in sorted(slot["replicas"]):
            hist = slot["replicas"][replica]
            extra = f'replica="{_esc(replica)}"'
            lines += _hist_lines(metric, labels, hist, extra, exemplars)
        if slot["merged"] is not None:
            lines += _hist_lines(metric, labels, slot["merged"], "", exemplars)
    return "\n".join(lines) + "\n"


def _hist_lines(
    metric: str, labels: tuple, hist: dict, extra: str, exemplars: bool
) -> list[str]:
    out = []
    cum = 0.0
    slots = (hist.get("exemplars") or {}) if exemplars else {}
    base_pairs = ([extra] if extra else []) + [
        f'{k}="{_esc(v)}"' for k, v in labels
    ]
    for i, (edge, n) in enumerate(zip(hist["edges"], hist["counts"])):
        cum += n
        label_pairs = base_pairs + [f'le="{_fmt_value(edge)}"']
        line = f"{metric}_bucket{{{','.join(label_pairs)}}} {_fmt_value(cum)}"
        slot = slots.get(i) or slots.get(str(i))
        if slot is not None:
            line += f' # {{trace_id="{_esc(slot[0])}"}} {_fmt_value(slot[1])}'
        out.append(line)
    label_pairs = list(base_pairs)
    inf_pairs = label_pairs + ['le="+Inf"']
    out.append(f"{metric}_bucket{{{','.join(inf_pairs)}}} {_fmt_value(hist['count'])}")
    suffix = f"{{{','.join(label_pairs)}}}" if label_pairs else ""
    out.append(f"{metric}_sum{suffix} {_fmt_value(hist['sum'])}")
    out.append(f"{metric}_count{suffix} {_fmt_value(hist['count'])}")
    return out


def render_top(
    view: dict[str, Any],
    prev: dict[str, Any] | None = None,
    interval: float = 0.0,
    top: int = 5,
    width: int = 120,
) -> str:
    """One ops-console frame: per-replica vitals (now including resident
    datasets/stores, store freshness, and the SLO alert column) + the
    fleet's top cost rows + any firing/pending alerts.
    ``prev``/``interval`` turn the monotonically increasing
    ``serve.requests`` counter into a qps column (blank on the first
    frame). This is the ANSI *formatting* of exactly the dict
    :func:`render_top_json` builds — the two views cannot drift."""
    frame = render_top_json(view, prev=prev, interval=interval, top=top)
    lines = [
        f"flox_tpu fleet — {len(frame['replicas'])} replica(s), "
        f"{time.strftime('%H:%M:%S')}",
        "",
        f"{'replica':<16} {'state':<12} {'qps':>7} {'p50 ms':>9} {'p99 ms':>9} "
        f"{'queue':>6} {'brk':>4} {'hbm':>10} {'ds':>4} {'st':>4} "
        f"{'fresh':>7} {'alerts':>6}  endpoint",
        "-" * width,
    ]
    for row in frame["replicas"]:
        qps = f"{row['qps']:.1f}" if row["qps"] is not None else ""
        p50 = f"{row['p50_ms']:.2f}" if row["p50_ms"] is not None else "-"
        p99 = f"{row['p99_ms']:.2f}" if row["p99_ms"] is not None else "-"
        hbm = row["hbm_bytes"]
        limit = row["hbm_bytes_limit"]
        hbm_s = f"{hbm / 2**30:.2f}GiB" if hbm else "-"
        if hbm and limit:
            # the bytes_limit gauge makes the column a fraction of capacity
            hbm_s = f"{hbm / 2**30:.2f}G/{100 * hbm / limit:.0f}%"
        stale = row["staleness_s"]
        fresh = f"{stale:.0f}s" if stale is not None else "-"
        firing, pending = row["alerts_firing"], row["alerts_pending"]
        alerts_s = "-" if not (firing or pending) else f"{firing}F/{pending}P"
        lines.append(
            f"{row['replica'][:16]:<16} {row['state'][:12]:<12} {qps:>7} "
            f"{p50:>9} {p99:>9} {row['queue_depth']:>6} "
            f"{row['breakers_open']:>4} {hbm_s:>10} {row['datasets']:>4} "
            f"{row['stores']:>4} {fresh:>7} {alerts_s:>6}  {row['url']}"
        )
    live_alerts = [
        a for a in frame["alerts"] if a.get("state") in ("firing", "pending")
    ]
    if live_alerts:
        lines += ["", "alerts (most severe first):"]
        for a in live_alerts:
            lines.append(
                f"  [{str(a.get('state', '?')).upper():<7}] "
                f"{a.get('objective')}/{a.get('window')} "
                f"severity={a.get('severity')} replica={a.get('replica')} "
                f"burn={a.get('burn_short', 0):.1f}x/{a.get('burn_long', 0):.1f}x"
            )
    lines += [
        "",
        f"top {top} cost rows (fleet-unioned /debug/costs, by device time):",
        f"{'program key':<46} {'disp':>6} {'device ms':>11} {'MBytes':>9} "
        f"{'util':>7}  slow trace",
        "-" * width,
    ]
    if not frame["top_costs"]:
        lines.append("  (no cost rows yet)")
    for row in frame["top_costs"]:
        util = row["utilization"]
        lines.append(
            f"{row['program'][:46]:<46} {row['dispatches']:>6} "
            f"{row['device_ms']:>11.2f} "
            f"{row['bytes'] / 1e6:>9.2f} "
            f"{('%.1f%%' % (100 * util)) if util is not None else '-':>7}  "
            f"{str(row['last_slow_trace'] or '-')[:24]}"
        )
    if frame["merge_errors"]:
        lines += ["", "merge errors (per-replica series kept, fleet sum withheld):"]
        for metric, err in sorted(frame["merge_errors"].items()):
            lines.append(f"  {metric}: {err[:width - 4]}")
    return "\n".join(lines)


def render_top_json(
    view: dict[str, Any],
    prev: dict[str, Any] | None = None,
    interval: float = 0.0,
    top: int = 5,
) -> dict[str, Any]:
    """The ops-console frame as a JSON-safe object (``fleet top --json``):
    the same per-replica vitals and fleet-unioned top cost rows the ANSI
    frame renders, shaped for alerting scripts instead of eyeballs. ``qps``
    is ``None`` on the first frame (no prior counter sample to diff)."""

    def counter(view_: dict, metric: str, replica: str) -> float:
        slot = view_.get("counters", {}).get((metric, ()))
        return float(slot["replicas"].get(replica, 0.0)) if slot else 0.0

    def gauge(metric: str, replica: str) -> float:
        slot = view.get("gauges", {}).get((metric, ()))
        return float(slot["replicas"].get(replica, 0.0)) if slot else 0.0

    replicas = []
    for row in view.get("replicas", []):
        label = row["replica"]
        if not row.get("ok"):
            state = "unreachable"
        elif row.get("ready"):
            state = "ready"
        else:
            state = row.get("reason") or "not-ready"
        qps = None
        if prev is not None and interval > 0:
            delta = counter(view, _PROM_REQUESTS_TOTAL, label) - counter(
                prev, _PROM_REQUESTS_TOTAL, label
            )
            qps = round(max(0.0, delta) / interval, 3)
        hist = (
            view.get("histograms", {})
            .get((_PROM_REQUEST_MS, ()), {})
            .get("replicas", {})
            .get(label)
        )
        limit = gauge(_PROM_HBM_LIMIT, label)
        ds_rows = [
            slot["replicas"][label]
            for slot in view.get("datasets", {}).values()
            if label in slot.get("replicas", {})
        ]
        st_rows = [
            slot["replicas"][label]
            for slot in view.get("stores", {}).values()
            if label in slot.get("replicas", {})
        ]
        stale = [
            float(r["staleness_s"]) for r in st_rows if r.get("staleness_s") is not None
        ]
        my_alerts = [
            a for a in view.get("alerts", []) if a.get("replica") == label
        ]
        replicas.append(
            {
                "replica": label,
                "url": row["url"],
                "state": state,
                "error": row.get("error"),
                "qps": qps,
                "p50_ms": round(_hist_percentile(hist, 0.50), 4) if hist else None,
                "p99_ms": round(_hist_percentile(hist, 0.99), 4) if hist else None,
                "queue_depth": int(gauge(_PROM_QUEUE_DEPTH, label)),
                "breakers_open": int(gauge(_PROM_BREAKERS_OPEN, label)),
                "hbm_bytes": gauge(_PROM_HBM_IN_USE, label),
                "hbm_bytes_limit": limit or None,
                "datasets": len(ds_rows),
                "dataset_bytes": sum(int(r.get("nbytes", 0)) for r in ds_rows),
                "stores": len(st_rows),
                # the STALEST store on this replica: the freshness headline
                "staleness_s": round(max(stale), 3) if stale else None,
                "alerts_firing": sum(
                    1 for a in my_alerts if a.get("state") == "firing"
                ),
                "alerts_pending": sum(
                    1 for a in my_alerts if a.get("state") == "pending"
                ),
                "slo_healthy": (
                    view.get("slo", {}).get(label, {}).get("healthy")
                    if label in view.get("slo", {})
                    else None
                ),
            }
        )
    util_by_label: dict[str, float] = {}
    programs = []
    for digest, prow in sorted(view.get("programs", {}).items()):
        for plabel in prow.get("labels", []):
            if prow.get("utilization") is not None:
                util_by_label[plabel] = float(prow["utilization"])
        programs.append(dict(prow))
    ranked = sorted(
        view.get("cost_by_program", {}).items(),
        key=lambda kv: (
            -float(kv[1].get("device_ms", 0.0)),
            -int(kv[1].get("dispatches", 0)),
        ),
    )[:top]
    top_costs = [
        {
            "program": label,
            "dispatches": int(row.get("dispatches", 0)),
            "device_ms": float(row.get("device_ms", 0.0)),
            "bytes": float(row.get("bytes", 0)),
            "utilization": util_by_label.get(label),
            "last_slow_trace": row.get("last_slow_trace"),
        }
        for label, row in ranked
    ]
    return {
        "ts": time.time(),
        "replicas": replicas,
        "top_costs": top_costs,
        "programs": programs,
        "alerts": [dict(a) for a in view.get("alerts", [])],
        "merge_errors": dict(view.get("merge_errors", {})),
    }


# ---------------------------------------------------------------------------
# the federator process
# ---------------------------------------------------------------------------


def parse_replica_targets(spec: str | None) -> list[tuple[str, str]]:
    """``"a=http://h:1,b=http://h:2"`` (or bare URLs) ->
    ``[(name, url), ...]``. Bare URLs are named ``host:port``."""
    if not spec:
        raise ValueError(
            "no replicas configured: pass --replicas name=url[,name=url...] "
            "or set FLOX_TPU_FLEET_REPLICAS"
        )
    out: list[tuple[str, str]] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, url = part.partition("=")
        if not sep:
            url = part
            name = re.sub(r"^https?://", "", part).rstrip("/")
        if not url.startswith(("http://", "https://")):
            raise ValueError(f"replica target {part!r}: url must be http(s)://...")
        out.append((name, url))
    if not out:
        raise ValueError(f"no replica targets parsed from {spec!r}")
    return out


class Federator:
    """Scrape loop + merged-view cache + HTTP endpoint, one instance per
    aggregator process (no module-level state)."""

    def __init__(
        self,
        targets: list[tuple[str, str]],
        interval: float | None = None,
        timeout: float = 5.0,
    ) -> None:
        from .options import OPTIONS

        self.targets = list(targets)
        self.interval = float(
            interval if interval is not None else OPTIONS["fleet_scrape_interval"]
        )
        self.timeout = timeout
        self._lock = threading.Lock()
        self._view: dict[str, Any] = federate([])
        self._snapshots: list[ReplicaSnapshot] = []
        self._rounds = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self.port: int | None = None

    # -- scraping -----------------------------------------------------------

    def scrape_once(self) -> dict[str, Any]:
        """One scrape round; returns (and caches) the merged view.

        Targets are scraped CONCURRENTLY: sequentially, one black-holed
        replica would stall every round by its full timeout and a wide
        fleet could never meet the scrape interval — concurrent, a round
        costs ~one slowest-target round trip regardless of fleet size."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(16, max(1, len(self.targets))),
            thread_name_prefix="flox-tpu-fleet-scrape",
        ) as pool:
            snapshots = list(
                pool.map(
                    lambda t: scrape_replica(t[0], t[1], timeout=self.timeout),
                    self.targets,
                )
            )
        view = federate(snapshots)
        with self._lock:
            self._snapshots = snapshots
            self._view = view
            self._rounds += 1
        return view

    def view(self) -> dict[str, Any]:
        with self._lock:
            return self._view

    @property
    def rounds(self) -> int:
        with self._lock:
            return self._rounds

    def start(self) -> None:
        """Start the background scrape loop (daemon; the first round runs
        immediately so the endpoint never serves an empty view for a full
        interval)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _run() -> None:
            while True:
                # not a retry loop: rounds are independent scrapes, and one
                # bad round (a replica mid-restart, a torn response) must
                # never kill federation — the error is kept for /replicas
                try:
                    self.scrape_once()
                except Exception as exc:  # noqa: BLE001
                    with self._lock:
                        self._view = dict(
                            self._view, scrape_loop_error=f"{type(exc).__name__}: {exc}"
                        )
                if self._stop.wait(self.interval):
                    return

        self._thread = threading.Thread(
            target=_run, name="flox-tpu-fleet-scraper", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.timeout + self.interval)
            self._thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
            self._http_thread = None

    # -- serving ------------------------------------------------------------

    def serve(self, port: int | None = None, host: str = "127.0.0.1") -> int:
        """Serve the merged view over HTTP (daemon thread); returns the
        bound port. ``port=None`` reads ``OPTIONS["fleet_port"]`` (0 there
        = ephemeral)."""
        from .options import OPTIONS

        if port is None:
            port = OPTIONS["fleet_port"]
        federator = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server contract
                path, _, query = self.path.partition("?")
                view = federator.view()
                if path == "/metrics":
                    import urllib.parse as _p

                    with_ex = _p.parse_qs(query).get("exemplars", ["0"])[0] == "1"
                    body = render_prometheus(view, exemplars=with_ex).encode()
                    status, ctype = 200, "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/debug/costs":
                    payload = {
                        "cost_by_program": view["cost_by_program"],
                        "cost_by_tenant": view["cost_by_tenant"],
                        "cost_by_replica": view["cost_by_replica"],
                        "replica": "_fleet",
                    }
                    body = (json.dumps(payload, default=str) + "\n").encode()
                    status, ctype = 200, "application/json; charset=utf-8"
                elif path == "/replicas":
                    body = (json.dumps(view["replicas"], default=str) + "\n").encode()
                    status, ctype = 200, "application/json; charset=utf-8"
                elif path == "/alerts":
                    alerts = view.get("alerts", [])
                    payload = {
                        "alerts": alerts,
                        "firing": sum(
                            1 for a in alerts if a.get("state") == "firing"
                        ),
                        "healthy": not any(
                            a.get("state") == "firing" for a in alerts
                        ),
                        "replica": "_fleet",
                    }
                    body = (json.dumps(payload, default=str) + "\n").encode()
                    status, ctype = 200, "application/json; charset=utf-8"
                elif path == "/slo":
                    by_replica = view.get("slo", {})
                    payload = {
                        "healthy": all(
                            s.get("healthy", True) for s in by_replica.values()
                        )
                        and not any(
                            a.get("state") == "firing"
                            for a in view.get("alerts", [])
                        ),
                        "replicas": by_replica,
                        "alerts": view.get("alerts", []),
                        "replica": "_fleet",
                    }
                    body = (json.dumps(payload, default=str) + "\n").encode()
                    status, ctype = 200, "application/json; charset=utf-8"
                elif path == "/healthz":
                    body, status, ctype = b"ok\n", 200, "text/plain; charset=utf-8"
                elif path == "/readyz":
                    ready = any(r.get("ready") for r in view["replicas"])
                    body = b"ready\n" if ready else b"no-ready-replicas\n"
                    status = 200 if ready else 503
                    ctype = "text/plain; charset=utf-8"
                else:
                    body, status, ctype = b"not found\n", 404, "text/plain; charset=utf-8"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, format: str, *args: Any) -> None:
                pass  # scrape-rate probes must not spam stderr

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="flox-tpu-fleet-http", daemon=True
        )
        self._http_thread.start()
        return self.port


# ---------------------------------------------------------------------------
# CLI: python -m flox_tpu_torch.fleet {federate,top}
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    import argparse

    from .options import OPTIONS

    parser = argparse.ArgumentParser(
        prog="python -m flox_tpu_torch.fleet",
        description="Fleet observability: metrics federation + live ops console.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    federate_cmd = sub.add_parser(
        "federate",
        help="scrape N replicas and serve the merged /metrics + "
        "/debug/costs + /replicas + /alerts + /slo view from one endpoint",
    )
    top_cmd = sub.add_parser(
        "top", help="live per-replica vitals + fleet top-cost console"
    )
    for cmd in (federate_cmd, top_cmd):
        cmd.add_argument(
            "--replicas", default=None,
            help="comma-separated name=url targets (default: "
            "FLOX_TPU_FLEET_REPLICAS)",
        )
        cmd.add_argument(
            "--interval", type=float, default=None,
            help="seconds between scrape rounds (default: "
            "OPTIONS['fleet_scrape_interval'])",
        )
        cmd.add_argument("--timeout", type=float, default=5.0)
        cmd.add_argument(
            "--once", action="store_true",
            help="one scrape round, print the result, exit (scripts/tests)",
        )
    federate_cmd.add_argument(
        "--port", type=int, default=None,
        help="TCP port for the merged endpoint (default: "
        "OPTIONS['fleet_port']; 0 binds an ephemeral port and prints it)",
    )
    federate_cmd.add_argument("--host", default="127.0.0.1")
    top_cmd.add_argument(
        "--top", type=int, default=5, help="cost rows shown (default 5)"
    )
    top_cmd.add_argument(
        "--plain", action="store_true",
        help="never clear the screen between frames (logs, pipes)",
    )
    top_cmd.add_argument(
        "--json", action="store_true",
        help="emit one JSON document per frame instead of the ANSI console "
        "— alerting scripts consume per-replica state without scraping the "
        "frame (implies --plain)",
    )
    args = parser.parse_args(argv)
    try:
        targets = parse_replica_targets(args.replicas or OPTIONS["fleet_replicas"])
    except ValueError as exc:
        parser.error(str(exc))
    federator = Federator(targets, interval=args.interval, timeout=args.timeout)
    if args.command == "federate":
        view = federator.scrape_once()
        if args.once:
            print(render_prometheus(view), end="")
            return 0
        federator.start()
        port = federator.serve(port=args.port)
        print(
            f"federating {len(targets)} replica(s) every {federator.interval:g}s "
            f"on http://{args.host}:{port} (/metrics /debug/costs /replicas "
            f"/alerts /slo /healthz /readyz)",
            flush=True,
        )
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            federator.stop()
        return 0
    # top: the refresh-loop console
    prev: dict[str, Any] | None = None
    try:
        while True:
            t0 = time.time()
            view = federator.scrape_once()
            if args.json:
                frame = json.dumps(
                    render_top_json(
                        view, prev=prev,
                        interval=federator.interval if prev is not None else 0.0,
                        top=args.top,
                    ),
                    default=str,
                )
            else:
                frame = render_top(
                    view, prev=prev,
                    interval=federator.interval if prev is not None else 0.0,
                    top=args.top,
                )
                if not args.plain:
                    print("\x1b[2J\x1b[H", end="")
            print(frame, flush=True)
            if args.once:
                return 0
            prev = view
            time.sleep(max(0.0, federator.interval - (time.time() - t0)))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
