"""The SLO plane: declared objectives, burn-rate alerts and the canary
prober over the metrics registry (the port of ``flox_tpu/slo.py``).

Operators declare objectives in a validated spec, JSON (or TOML for
``*.toml``) at ``OPTIONS["slo_path"]`` (``FLOX_TPU_SLO_PATH``), or take the
built-in ones, of four kinds:

- **latency**: the share of ``serve.request_ms`` observations at or under
  ``threshold_ms`` (to the bucket of the shared histogram edges; a
  ``tenant`` reads that tenant's histogram);
- **availability**: the serve errors that burn the budget (load shed,
  deadline, circuit-open fast-fail, device loss, watchdog) against
  ``serve.requests``; drain rejections and protocol errors do not;
- **correctness**: the canary prober (:func:`canary_loop`) sends
  known-answer requests through the port's ``Dispatcher``, registry and
  stores (inline reduce, fused statistics, a resident dataset, a store
  append and query) and compares the answers bit for bit. Its payload is
  four small float64 integers, whose sums are exact in any order (the
  card's ``index_add_`` fixes none). Canary traffic bills the reserved
  ``__canary__`` tenant and is excluded from every user SLO;
- **freshness**: the staleness of each open store's last acked append
  against ``max_staleness_s``, ticked once per evaluation.

Each rule pairs a short and a long window (5 min and 1 h at 14.4x for a
page, 6 h and 3 d at 1x for a ticket) and breaches only when both burn at
or above its rate. Alerts walk pending -> firing -> resolved; a page that
fires writes a flight dump. ``faults.slo_inject`` supplies a synthetic
clock, synthetic SLI bursts and corrupted canary answers, so the whole
lifecycle runs without sleeps. The surfaces are ``/slo`` and ``/alerts``
(``exposition``), the ``slo.*``, ``alert.*`` and ``canary.*`` metrics,
``python -m flox_tpu_torch.telemetry slo`` and the fleet federator; the
state resets with ``cache.clear_all``.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import deque
from types import MappingProxyType
from typing import Any

import numpy as np

from . import options, telemetry, utils
from .metric_names import (
    CANARY_FAILURES,
    CANARY_OK,
    SERVE_BREAKER_FASTFAIL,
    SERVE_DEADLINE_EXCEEDED,
    SERVE_DEVICE_LOST,
    SERVE_REQUEST_MS,
    SERVE_REQUESTS,
    SERVE_SHED,
    SERVE_WATCHDOG_FIRED,
)
from .telemetry import CANARY_TENANT, METRICS

__all__ = [
    "CANARY_TENANT",
    "DEFAULT_SPEC",
    "alert_snapshot",
    "alerts",
    "canary_cycle",
    "canary_loop",
    "clear",
    "evaluate",
    "load_spec",
    "record_canary",
    "seed_gauges",
    "slo_stats",
    "validate_spec",
]

_KINDS = ("latency", "availability", "correctness", "freshness")
_SEVERITIES = ("page", "ticket")
#: sort and dedup order: a page outranks a ticket (read-only mappings:
#: module-level dicts here are state that cache.clear_all resets)
_SEVERITY_RANK = MappingProxyType({"page": 0, "ticket": 1})
#: alert-state sort order on /alerts and in federation
_STATE_RANK = MappingProxyType({"firing": 0, "pending": 1, "resolved": 2})

#: serve counters that burn the availability budget (the replica failed
#: the caller) — drain rejections and client protocol errors are excluded
#: by OMISSION here: they are either planned (drain) or the caller's bug
AVAILABILITY_BAD_COUNTERS = (
    SERVE_SHED,
    SERVE_DEADLINE_EXCEEDED,
    SERVE_BREAKER_FASTFAIL,
    SERVE_DEVICE_LOST,
    SERVE_WATCHDOG_FIRED,
)

#: the built-in objective set used when OPTIONS["slo_path"] is unset —
#: conservative targets an unconfigured replica can actually meet
DEFAULT_SPEC: MappingProxyType = MappingProxyType({
    "objectives": [
        {"name": "latency", "kind": "latency", "target": 0.99, "threshold_ms": 250.0},
        {"name": "availability", "kind": "availability", "target": 0.999},
        {"name": "correctness", "kind": "correctness", "target": 0.999},
        {"name": "freshness", "kind": "freshness", "target": 0.99, "max_staleness_s": 600.0},
    ],
    "windows": [
        {"name": "fast", "short_s": 300.0, "long_s": 3600.0, "burn_rate": 14.4, "severity": "page"},
        {"name": "slow", "short_s": 21600.0, "long_s": 259200.0, "burn_rate": 1.0, "severity": "ticket"},
    ],
})


# --------------------------------------------------------------------------
# engine state (all reset by cache.clear_all)

#: parsed-spec cache: {"path": <str|None>, "spec": <validated spec>}
_SPEC_CACHE: dict[str, Any] = {}
#: (t, {objective name: (good, bad)}) cumulative-total snapshots, one per
#: evaluate() — window deltas subtract the newest snapshot old enough
_SNAPSHOT_RING: deque = deque(maxlen=4096)
#: (objective name, window rule name) -> alert row (the state machine)
_ALERT_TABLE: dict[tuple[str, str], dict] = {}
#: canary op -> {"probes", "failures", "last_ok", "last_error"}
_CANARY_LEDGER: dict[str, dict] = {}
#: freshness objective name -> [good ticks, bad ticks] cumulative
_FRESHNESS_LEDGER: dict[str, list] = {}
_LOCK = threading.RLock()


def clear() -> None:
    """Reset the whole SLO plane (``cache.clear_all`` and
    ``telemetry.reset`` call this); the ``slo.*`` and ``alert.*`` gauges go
    with the registry's reset."""
    with _LOCK:
        _SNAPSHOT_RING.clear()
        _ALERT_TABLE.clear()
        _CANARY_LEDGER.clear()
        _FRESHNESS_LEDGER.clear()
        _SPEC_CACHE.clear()


# --------------------------------------------------------------------------
# spec loading + validation


def _fail(msg: str) -> None:
    raise ValueError(f"invalid SLO spec: {msg}")


def _validate_window(rule: Any, seen: set) -> dict:
    if not isinstance(rule, dict):
        _fail(f"window rule must be a table/object, got {type(rule).__name__}")
    name = rule.get("name")
    if not isinstance(name, str) or not name:
        _fail("window rule needs a non-empty string 'name'")
    if name in seen:
        _fail(f"duplicate window rule name {name!r}")
    seen.add(name)
    out = {"name": name}
    for key in ("short_s", "long_s", "burn_rate"):
        v = rule.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or not v > 0:
            _fail(f"window {name!r} needs {key} > 0, got {v!r}")
        out[key] = float(v)
    if not out["short_s"] < out["long_s"]:
        _fail(f"window {name!r} needs short_s < long_s")
    sev = rule.get("severity", "ticket")
    if sev not in _SEVERITIES:
        _fail(f"window {name!r} severity must be one of {_SEVERITIES}, got {sev!r}")
    out["severity"] = sev
    extra = set(rule) - {"name", "short_s", "long_s", "burn_rate", "severity"}
    if extra:
        _fail(f"window {name!r} has unknown keys {sorted(extra)}")
    return out


def validate_spec(spec: Any) -> dict:
    """Normalize + validate a spec, raising ``ValueError`` (never a silent
    fallback — a typo'd objective must not evaluate as vacuously healthy)."""
    if not isinstance(spec, dict):
        _fail(f"top level must be a table/object, got {type(spec).__name__}")
    extra = set(spec) - {"objectives", "windows"}
    if extra:
        _fail(f"unknown top-level keys {sorted(extra)}")
    windows = [_validate_window(r, set()) for r in _as_rules(spec.get("windows"))]
    objectives = spec.get("objectives")
    if not isinstance(objectives, list) or not objectives:
        _fail("'objectives' must be a non-empty list")
    out_objs: list[dict] = []
    names: set[str] = set()
    for obj in objectives:
        if not isinstance(obj, dict):
            _fail(f"objective must be a table/object, got {type(obj).__name__}")
        name = obj.get("name")
        if not isinstance(name, str) or not name or any(c in name for c in "|= \t"):
            _fail(f"objective needs a label-safe non-empty 'name', got {name!r}")
        if name in names:
            _fail(f"duplicate objective name {name!r}")
        names.add(name)
        kind = obj.get("kind")
        if kind not in _KINDS:
            _fail(f"objective {name!r} kind must be one of {_KINDS}, got {kind!r}")
        target = obj.get("target")
        if (
            not isinstance(target, (int, float))
            or isinstance(target, bool)
            or not 0 < float(target) < 1
        ):
            _fail(f"objective {name!r} needs 0 < target < 1, got {target!r}")
        row = {"name": name, "kind": kind, "target": float(target)}
        allowed = {"name", "kind", "target", "windows"}
        if kind == "latency":
            thr = obj.get("threshold_ms")
            if not isinstance(thr, (int, float)) or isinstance(thr, bool) or not thr > 0:
                _fail(f"latency objective {name!r} needs threshold_ms > 0, got {thr!r}")
            row["threshold_ms"] = float(thr)
            allowed |= {"threshold_ms", "tenant"}
            tenant = obj.get("tenant")
            if tenant is not None:
                if not isinstance(tenant, str) or not tenant:
                    _fail(f"latency objective {name!r} tenant must be a non-empty string")
                row["tenant"] = tenant
        elif kind == "freshness":
            stale = obj.get("max_staleness_s")
            if not isinstance(stale, (int, float)) or isinstance(stale, bool) or not stale > 0:
                _fail(f"freshness objective {name!r} needs max_staleness_s > 0, got {stale!r}")
            row["max_staleness_s"] = float(stale)
            allowed |= {"max_staleness_s"}
        extra = set(obj) - allowed
        if extra:
            _fail(f"objective {name!r} has unknown keys {sorted(extra)}")
        own = obj.get("windows")
        if own is not None:
            row["windows"] = [_validate_window(r, set()) for r in _as_rules(own)]
        out_objs.append(row)
    return {"objectives": out_objs, "windows": windows}


def _as_rules(windows: Any) -> list:
    if windows is None:
        return [dict(r) for r in DEFAULT_SPEC["windows"]]
    if not isinstance(windows, list) or not windows:
        _fail("'windows' must be a non-empty list of rules")
    return windows


def _tomllib():
    """The stdlib TOML parser (3.11+), falling back to ``tomli`` where
    present; absent both, a ``*.toml`` spec is a clear ValueError telling
    the operator to use JSON — never a bare ModuleNotFoundError."""
    try:
        import tomllib
    except ModuleNotFoundError:
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ModuleNotFoundError:
            _fail(
                "TOML specs need Python >= 3.11 (tomllib) or the tomli "
                "package; write the spec as JSON instead"
            )
    return tomllib


def load_spec(path: Any = None, *, force: bool = False) -> dict:
    """The active validated spec: ``path`` (default ``OPTIONS["slo_path"]``)
    parsed as TOML for ``*.toml`` else JSON, or :data:`DEFAULT_SPEC` when no
    path is configured. Cached until the configured path changes (tests and
    a reloaded config pass ``force=True``). Raises ``ValueError`` for an
    unreadable or invalid spec — loudly, at the surface that asked."""
    if path is None:
        path = options.OPTIONS["slo_path"]
    key = str(path) if path is not None else None
    with _LOCK:
        if not force and _SPEC_CACHE.get("path", ()) == key and "spec" in _SPEC_CACHE:
            return _SPEC_CACHE["spec"]
    if key is None:
        spec = validate_spec(json.loads(json.dumps(dict(DEFAULT_SPEC))))
    else:
        try:
            if key.endswith(".toml"):
                tomllib = _tomllib()
                with open(key, "rb") as fh:
                    raw = tomllib.load(fh)
            else:
                with open(key, encoding="utf-8") as fh:
                    raw = json.load(fh)
        except ValueError as exc:  # JSON/TOML syntax errors
            raise ValueError(f"invalid SLO spec: cannot parse {key}: {exc}") from exc
        except OSError as exc:
            raise ValueError(f"invalid SLO spec: cannot read {key}: {exc}") from exc
        spec = validate_spec(raw)
    with _LOCK:
        _SPEC_CACHE["path"] = key
        _SPEC_CACHE["spec"] = spec
    return spec


# --------------------------------------------------------------------------
# SLI collectors — cumulative (good, bad) totals per objective


def _now() -> float:
    from . import faults

    t = faults.slo_now()
    return time.time() if t is None else t


def _latency_totals(obj: dict) -> tuple[float, float]:
    name = SERVE_REQUEST_MS
    if obj.get("tenant"):
        name = f"{SERVE_REQUEST_MS}|tenant={telemetry.tenant_label(obj['tenant'], register=False)}"
    hist = METRICS.histograms().get(name)
    if not hist:
        return 0.0, 0.0
    good = float(
        sum(
            n
            for edge, n in zip(telemetry.HIST_EDGES_MS, hist["counts"])
            if edge <= obj["threshold_ms"]
        )
    )
    return good, float(hist["count"]) - good


def _availability_totals(obj: dict) -> tuple[float, float]:
    bad = float(sum(METRICS.get(c) for c in AVAILABILITY_BAD_COUNTERS))
    total = float(METRICS.get(SERVE_REQUESTS))
    return max(0.0, total - bad), bad


def _correctness_totals(obj: dict) -> tuple[float, float]:
    return float(METRICS.get(CANARY_OK)), float(METRICS.get(CANARY_FAILURES))


def _freshness_totals(obj: dict) -> tuple[float, float]:
    """Tick the freshness ledger once: each open store contributes one
    good/bad event per evaluation depending on its append staleness. The
    canary's own store is reserved-tenant traffic and excluded."""
    led = _FRESHNESS_LEDGER.setdefault(obj["name"], [0, 0])
    try:
        from .serve import stores as serve_stores

        staleness = serve_stores.staleness_by_store(now=_now())
    except Exception:  # noqa: BLE001 — a serve layer that never imported
        # (pure-library use) must not fail SLO evaluation
        staleness = {}
    for store_name, stale_s in staleness.items():
        if store_name.startswith(CANARY_TENANT):
            continue
        led[1 if stale_s > obj["max_staleness_s"] else 0] += 1
    return float(led[0]), float(led[1])


_COLLECTORS = MappingProxyType({
    "latency": _latency_totals,
    "availability": _availability_totals,
    "correctness": _correctness_totals,
    "freshness": _freshness_totals,
})


def _collect(obj: dict) -> tuple[float, float]:
    good, bad = _COLLECTORS[obj["kind"]](obj)
    from . import faults

    inj_good, inj_bad = faults.slo_injected(obj["name"])
    return good + inj_good, bad + inj_bad


# --------------------------------------------------------------------------
# burn-rate math + the alert state machine


def _window_delta(
    name: str, now: float, window_s: float, totals: tuple[float, float]
) -> tuple[float, float]:
    """(good, bad) accrued inside the trailing window: current totals minus
    the newest ring snapshot at least ``window_s`` old (falling back to the
    oldest — a partial window — while history is shorter than the window).
    Deltas clamp at 0 so counter resets read as quiet, not as burn."""
    base: tuple[float, float] = (0.0, 0.0)
    baseline_t = None
    for t, snap in _SNAPSHOT_RING:
        if t <= now - window_s:
            base = snap.get(name, (0.0, 0.0))
            baseline_t = t
        else:
            break
    if baseline_t is None and _SNAPSHOT_RING:
        t, snap = _SNAPSHOT_RING[0]
        base = snap.get(name, (0.0, 0.0))
    return max(0.0, totals[0] - base[0]), max(0.0, totals[1] - base[1])


def _burn(name: str, now: float, window_s: float, totals, err_budget: float) -> float:
    """The window's burn rate: (bad fraction) / (error budget). 1.0 spends
    the budget exactly over the SLO period; 0 when the window saw nothing
    (no traffic is healthy, not unknown — idle replicas must not page)."""
    good, bad = _window_delta(name, now, window_s, totals)
    total = good + bad
    if total <= 0:
        return 0.0
    return (bad / total) / err_budget


def _step_alert(obj: dict, rule: dict, breach: bool, burns: dict, now: float) -> None:
    """One state-machine step for (objective, rule). Transitions:
    absent/resolved --breach--> pending --breach--> firing --clear-->
    resolved; a pending that clears before confirming is dropped (a
    one-evaluation blip never reaches an operator)."""
    key = (obj["name"], rule["name"])
    held = _ALERT_TABLE.get(key)
    if breach:
        if held is None or held["state"] == "resolved":
            _ALERT_TABLE[key] = {
                "objective": obj["name"],
                "window": rule["name"],
                "severity": rule["severity"],
                "state": "pending",
                "since": now,
                "fired_at": None,
                "resolved_at": None,
                **burns,
            }
            METRICS.inc("alert.pending_total")
        elif held["state"] == "pending":
            held.update(state="firing", fired_at=now, **burns)
            METRICS.inc("alert.fired")
            METRICS.inc(f"alert.fired|objective={obj['name']}")
            telemetry.event(
                "alert-firing",
                objective=obj["name"],
                window=rule["name"],
                severity=rule["severity"],
                burn_short=burns["burn_short"],
                burn_long=burns["burn_long"],
            )
            if rule["severity"] == "page":
                METRICS.inc("alert.pages")
                # the forensic record should exist BEFORE the operator
                # arrives: dump the flight recorder and hint at the
                # on-chip capture surface for the device-side view
                telemetry.flight_dump(reason=f"alert:{obj['name']}:{rule['name']}")
                telemetry.event(
                    "capture-hint",
                    objective=obj["name"],
                    hint="page-severity alert: consider /debug/profile for an on-chip capture",
                )
        else:  # still firing: refresh the burn numbers operators see
            held.update(**burns)
    elif held is not None:
        if held["state"] == "pending":
            del _ALERT_TABLE[key]
        elif held["state"] == "firing":
            held.update(state="resolved", resolved_at=now, **burns)
            METRICS.inc("alert.resolved_total")
            telemetry.event(
                "alert-resolved", objective=obj["name"], window=rule["name"]
            )


def evaluate(now: float | None = None) -> dict:
    """One evaluation pass: collect cumulative SLI totals, snapshot them
    into the window ring, compute every rule's short+long burn rates, step
    the alert state machine, and publish ``slo.*``/``alert.*`` gauges.
    Returns the ``/slo`` payload. Raises ``ValueError`` for a bad spec."""
    spec = load_spec()
    if now is None:
        now = _now()
    with _LOCK:
        totals = {obj["name"]: _collect(obj) for obj in spec["objectives"]}
        _SNAPSHOT_RING.append((now, totals))
        payload_objs = []
        for obj in spec["objectives"]:
            err_budget = 1.0 - obj["target"]
            rules = obj.get("windows") or spec["windows"]
            good, bad = totals[obj["name"]]
            windows = []
            fast_burn = 0.0
            budget_window = max(r["long_s"] for r in rules)
            for rule in rules:
                burn_short = _burn(obj["name"], now, rule["short_s"], totals[obj["name"]], err_budget)
                burn_long = _burn(obj["name"], now, rule["long_s"], totals[obj["name"]], err_budget)
                breach = burn_short >= rule["burn_rate"] and burn_long >= rule["burn_rate"]
                fast_burn = max(fast_burn, burn_short)
                burns = {"burn_short": round(burn_short, 4), "burn_long": round(burn_long, 4)}
                _step_alert(obj, rule, breach, burns, now)
                windows.append(
                    {
                        "window": rule["name"],
                        "severity": rule["severity"],
                        "short_s": rule["short_s"],
                        "long_s": rule["long_s"],
                        "burn_threshold": rule["burn_rate"],
                        "breach": breach,
                        **burns,
                    }
                )
            wg, wb = _window_delta(obj["name"], now, budget_window, totals[obj["name"]])
            ratio = (wb / (wg + wb)) if (wg + wb) > 0 else 0.0
            budget_remaining = round(1.0 - ratio / err_budget, 4)
            firing = any(
                a["state"] == "firing" and a["objective"] == obj["name"]
                for a in _ALERT_TABLE.values()
            )
            payload_objs.append(
                {
                    "name": obj["name"],
                    "kind": obj["kind"],
                    "target": obj["target"],
                    "good": good,
                    "bad": bad,
                    "budget_remaining": budget_remaining,
                    "healthy": not firing,
                    "windows": windows,
                }
            )
            METRICS.set_gauge(f"slo.budget_remaining|objective={obj['name']}", budget_remaining)
            METRICS.set_gauge(f"slo.burn_rate|objective={obj['name']}", round(fast_burn, 4))
        alert_rows = _alert_rows()
        firing = sum(1 for a in alert_rows if a["state"] == "firing")
        pending = sum(1 for a in alert_rows if a["state"] == "pending")
        METRICS.set_gauge("alert.firing", float(firing))
        METRICS.set_gauge("alert.pending", float(pending))
        METRICS.set_gauge("slo.objectives", float(len(payload_objs)))
        METRICS.inc("slo.evaluations")
        return {
            "healthy": firing == 0,
            "evaluated_at": now,
            "spec_path": _SPEC_CACHE.get("path"),
            "objectives": payload_objs,
            "alerts": alert_rows,
        }


def _alert_rows() -> list[dict]:
    return sorted(
        (dict(a) for a in _ALERT_TABLE.values()),
        key=lambda a: (
            _STATE_RANK.get(a["state"], 9),
            _SEVERITY_RANK.get(a["severity"], 9),
            a["objective"],
            a["window"],
        ),
    )


def alerts() -> list[dict]:
    """The current alert rows (firing first, pages before tickets) WITHOUT
    re-evaluating — the cheap read for dumps and stats panels."""
    with _LOCK:
        return _alert_rows()


def alert_snapshot() -> dict:
    """Compact alert-state summary for flight-dump headers: state ->
    ``objective/window[severity]`` labels, next to the breaker snapshot."""
    with _LOCK:
        out: dict[str, list] = {"firing": [], "pending": [], "resolved": []}
        for a in _alert_rows():
            out.setdefault(a["state"], []).append(
                f"{a['objective']}/{a['window']}[{a['severity']}]"
            )
        return out


def slo_stats() -> dict:
    """The SLO plane's ``cache.stats()`` panel — module-state snapshot
    only, never an evaluation (stats must not move the alert machine)."""
    with _LOCK:
        rows = _alert_rows()
        return {
            "spec_path": _SPEC_CACHE.get("path"),
            "snapshots": len(_SNAPSHOT_RING),
            "alerts": {
                state: sum(1 for a in rows if a["state"] == state)
                for state in ("firing", "pending", "resolved")
            },
            "canary": {
                "probes": int(sum(r["probes"] for r in _CANARY_LEDGER.values())),
                "failures": int(sum(r["failures"] for r in _CANARY_LEDGER.values())),
            },
        }


def seed_gauges() -> None:
    """Run one evaluation at metrics-server start so ``/slo`` and the
    budget gauges answer from the first scrape; a bad configured spec is
    surfaced as an event + counter here, never a server-start failure
    (the /slo endpoint will re-raise it with a 500 for the operator)."""
    try:
        evaluate()
    except ValueError as exc:
        METRICS.inc("slo.spec_errors")
        telemetry.event("slo-spec-error", error=str(exc)[:200])


# --------------------------------------------------------------------------
# canary prober: known-answer requests across the op matrix

#: reserved names for canary resident state; the leading "__canary__"
#: keeps them out of freshness SLOs and lets dashboards filter them
CANARY_DATASET = "__canary__"
CANARY_STORE = "__canary__"

#: power-of-two payload with exact float sums: sum -> [3, 12],
#: count -> [2, 2], mean -> [1.5, 6] — every comparison is bit-exact
_CANARY_ARRAY = (1.0, 2.0, 4.0, 8.0)
_CANARY_BY = (0, 0, 1, 1)
_EXPECTED = MappingProxyType({
    "sum": np.asarray([3.0, 12.0]),
    "count": np.asarray([2, 2]),
    "mean": np.asarray([1.5, 6.0]),
})


def record_canary(op: str, ok: bool, error: str | None = None) -> None:
    """Record one probe verdict: the canary ledger + ``canary.*`` counters
    feeding the correctness SLO. Failures never touch the serve error
    taxonomy, so a wrong answer burns the correctness budget while the
    availability SLO correctly reads the replica as up."""
    with _LOCK:
        row = _CANARY_LEDGER.setdefault(
            op, {"probes": 0, "failures": 0, "last_ok": None, "last_error": None}
        )
        row["probes"] += 1
        row["last_ok"] = bool(ok)
        if not ok:
            row["failures"] += 1
            row["last_error"] = error
    METRICS.inc("canary.probes")
    if ok:
        METRICS.inc("canary.ok")
    else:
        METRICS.inc("canary.failures")
        METRICS.inc(f"canary.failures|op={op}")
        telemetry.event("canary-failure", op=op, error=(error or "")[:200])


def _verdict(op: str, got: Any, want: np.ndarray) -> bool:
    """Bit-exact compare, after letting an installed faults plan corrupt
    the received value (how tests/CI prove a wrong answer is caught)."""
    from . import faults

    arr = utils.asarray_host(got)
    if faults.slo_canary_corrupt(op):
        arr = arr + 1
    ok = arr.shape == want.shape and bool(np.array_equal(arr, want))
    record_canary(op, ok, None if ok else f"expected {want.tolist()}, got {arr.tolist()}")
    return ok


async def _probe_reduce(dispatcher, cycle: int) -> None:
    from .serve.dispatcher import AggregationRequest

    res = await dispatcher.submit(
        AggregationRequest(
            func="sum",
            array=np.asarray(_CANARY_ARRAY),
            by=np.asarray(_CANARY_BY),
            tenant=CANARY_TENANT,
            request_id=f"canary-reduce-{cycle}",
        )
    )
    _verdict("reduce", res.result, _EXPECTED["sum"])


async def _probe_multistat(dispatcher, cycle: int) -> None:
    from .serve.dispatcher import AggregationRequest

    res = await dispatcher.submit(
        AggregationRequest(
            func=("sum", "count", "mean"),
            array=np.asarray(_CANARY_ARRAY),
            by=np.asarray(_CANARY_BY),
            tenant=CANARY_TENANT,
            request_id=f"canary-multistat-{cycle}",
        )
    )
    out = res.result
    ok = isinstance(out, dict) and all(
        f in out and utils.asarray_host(out[f]).shape == want.shape
        and np.array_equal(utils.asarray_host(out[f]), want)
        for f, want in _EXPECTED.items()
    )
    from . import faults

    if faults.slo_canary_corrupt("multistat"):
        ok = False
    record_canary("multistat", ok, None if ok else f"fused stats mismatch: {out!r:.200}")


async def _probe_dataset(dispatcher, cycle: int) -> None:
    from .serve import registry
    from .serve.dispatcher import AggregationRequest

    try:
        registry.resolve(CANARY_DATASET)
    except Exception:  # noqa: BLE001 — any resolve failure (unknown name,
        # post-clear_all) means (re)pin the canary dataset
        await asyncio.to_thread(
            registry.put,
            CANARY_DATASET,
            np.asarray(_CANARY_ARRAY),
            np.asarray(_CANARY_BY),
            device=dispatcher.device,
        )
    res = await dispatcher.submit(
        AggregationRequest(
            func="sum",
            dataset=CANARY_DATASET,
            tenant=CANARY_TENANT,
            request_id=f"canary-dataset-{cycle}",
        )
    )
    _verdict("dataset", res.result, _EXPECTED["sum"])


async def _probe_store(dispatcher, cycle: int) -> bool:
    """Store append→query round-trip; skipped (returns False) without a
    configured store root. The constant slab id makes every cycle after
    the first an exactly-once REPLAY, so the known answer never drifts."""
    if not options.OPTIONS["store_root"]:
        return False
    from .serve import stores as serve_stores

    await asyncio.to_thread(
        serve_stores.append,
        CANARY_STORE,
        np.asarray(_CANARY_BY),
        np.asarray(_CANARY_ARRAY),
        slab_id="canary-slab-0",
        create={"funcs": ["sum"], "size": 2},
        device=dispatcher.device,
    )
    out = await asyncio.to_thread(serve_stores.query, CANARY_STORE, ["sum"],
                                  device=dispatcher.device)
    _verdict("store", out["sum"], _EXPECTED["sum"])
    return True


_PROBES = (
    ("reduce", _probe_reduce),
    ("multistat", _probe_multistat),
    ("dataset", _probe_dataset),
    ("store", _probe_store),
)


async def canary_cycle(dispatcher, cycle: int = 0) -> dict:
    """One pass over the op matrix. Returns op -> verdict (``None`` for a
    skipped probe). A probe that errors records a correctness failure —
    unless the replica is draining, which is planned downtime for the
    canary too (it neither passes nor fails)."""
    verdicts: dict[str, bool | None] = {}
    for op, probe in _PROBES:
        before = _probe_count(op)
        try:
            skipped = await probe(dispatcher, cycle) is False and op == "store"
            if skipped:
                verdicts[op] = None
                continue
        except asyncio.CancelledError:
            raise
        # not a retry loop: ops are independent probes, and a probe error
        # is the signal (a correctness failure), except a drain
        except Exception as exc:  # noqa: BLE001
            if getattr(exc, "code", None) == "draining":
                verdicts[op] = None
                continue
            record_canary(op, False, f"{type(exc).__name__}: {exc}")
            verdicts[op] = False
            continue
        verdicts[op] = _probe_count(op) > before and _last_ok(op)
    return verdicts


def _probe_count(op: str) -> int:
    with _LOCK:
        row = _CANARY_LEDGER.get(op)
        return int(row["probes"]) if row else 0


def _last_ok(op: str) -> bool:
    with _LOCK:
        row = _CANARY_LEDGER.get(op)
        return bool(row and row["last_ok"])


async def canary_loop(dispatcher, interval: float) -> None:
    """The background prober ``python -m flox_tpu_torch.serve`` runs when
    ``--canary-interval`` / ``FLOX_TPU_SLO_CANARY_INTERVAL`` is > 0: one
    :func:`canary_cycle` + one :func:`evaluate` per period. Never raises
    out (a broken probe must not take serving down); cancelled on drain."""
    cycle = 0
    while True:
        cycle += 1
        try:
            await canary_cycle(dispatcher, cycle)
            evaluate()
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - each cycle is an
            # independent probe pass, and the prober outliving a transient
            # error is the point
            telemetry.record_serve_error(exc, what="canary cycle")
        await asyncio.sleep(interval)
