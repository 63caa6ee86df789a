"""Serve-layer surface of the durable incremental aggregation stores (the
port of ``flox_tpu/serve/stores.py``).

A store is a registry entry whose state grows: ``{"op": "append"}`` folds a
slab into the persisted per-group carry (``flox_tpu_torch/store.py``, a
journaled, exactly-once store whose slabs are reduced on the device),
``{"op": "query"}`` answers finalized statistics without recomputing
history, ``{"op": "compact"}`` folds segment history, and
``{"op": "list_stores"}`` enumerates. Stores live under
``OPTIONS["store_root"]`` (one directory per name) and are opened lazily on
first reference — opening is crash recovery, so a replica restarted over a
killed predecessor's directory answers queries bit for bit as an
uninterrupted run would.

Hot state is two-tier: the authoritative carry is host numpy (present-group
layers backed by the checksummed segments), and the last finalized query
result stays on the store's device per store, invalidated by generation.
Device loss runs ``restage_all``: the recovery cycle reopens every table
entry from its directory (dropping the device result caches) before
``/readyz`` flips back.

The store table is registered in ``cache.clear_all`` / ``cache.stats``;
``store.*`` counters and gauges ride the metrics registry, per-store cost
rows ride the cost ledger's ``dataset`` axis, and ``/debug/stores`` serves
the joined table.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from .. import options, telemetry, utils
from ..fusion import store_program_label
from ..store import IncrementalAggregationStore, StoreCorruptionError, open_store
from ..telemetry import METRICS
from .dispatcher import ServeError

__all__ = [
    "StoreEntry",
    "StoreCorruptedError",
    "UnknownStoreError",
    "append",
    "clear",
    "compact",
    "debug_table",
    "list_stores",
    "publish_staleness",
    "query",
    "resolve",
    "restage_all",
    "staleness_by_store",
    "stores_stats",
]


class UnknownStoreError(ServeError):
    """The request referenced a ``store`` name that does not exist under
    ``store_root`` (or no root is configured). A typed protocol error: the
    client's fix is an ``append`` carrying ``create`` (or routing to the
    replica whose root holds the store)."""

    code = "unknown_store"


class StoreCorruptedError(ServeError):
    """Opening (or re-opening) the store hit unrecoverable on-disk damage:
    a mid-history segment failed its checksums and no fallback state
    survives. The damaged file is quarantined as ``*.corrupt`` next to the
    store — the operator's runbook is restore-from-replica or re-ingest.
    Not retryable: no ``retry_after_ms`` is ever attached."""

    code = "store_corruption"


class StoreEntry:
    """One open store: the durable store object + the device-side finalized
    result cache (generation-keyed)."""

    __slots__ = (
        "name", "store", "opened", "last_ack", "dev", "dev_gen", "dev_key", "lock",
    )

    def __init__(self, name: str, store: IncrementalAggregationStore) -> None:
        self.name = name
        self.store = store
        self.opened = time.time()
        # the freshness-SLO signal: wall time of the last acked append
        # (open counts as the epoch — a just-recovered store is as fresh
        # as its recovery, not as stale as its history)
        self.last_ack = self.opened
        self.dev: dict | None = None
        self.dev_gen = -1
        self.dev_key: tuple = ()
        self.lock = threading.RLock()

    def info(self) -> dict:
        d = self.store.info()
        d["device_cached"] = self.dev is not None
        d["staleness_s"] = round(max(0.0, time.time() - self.last_ack), 3)
        return d


#: name -> StoreEntry for every store this replica has opened
_STORE_TABLE: dict[str, StoreEntry] = {}
_LOCK = threading.RLock()


def _root() -> str:
    root = options.OPTIONS["store_root"]
    if not root:
        raise UnknownStoreError(
            "no store root configured: set options.store_root "
            "(FLOX_TPU_STORE_ROOT) before using store ops"
        )
    return str(root)


def _publish_gauges() -> None:
    entries = list(_STORE_TABLE.values())
    METRICS.set_gauge("store.open_stores", float(len(entries)))
    METRICS.set_gauge(
        "store.state_bytes", float(sum(e.store.info()["nbytes"] for e in entries))
    )


def resolve(name: Any, *, create: dict | None = None, device: Any = None) -> StoreEntry:
    """The table entry for ``name``, lazily opening (= recovering) the
    durable directory on first reference, its slabs reduced on ``device``
    (CUDA unless the caller names the CPU); ``create`` makes a missing store
    instead of failing. Raises the typed protocol errors."""
    if not name or not isinstance(name, str):
        raise UnknownStoreError(f"store name must be a non-empty string, got {name!r}")
    if name != os.path.basename(name) or name.startswith("."):
        raise UnknownStoreError(f"store name {name!r} must be a bare directory name")
    with _LOCK:
        entry = _STORE_TABLE.get(name)
        if entry is not None:
            return entry
        path = os.path.join(_root(), name)
        try:
            store = open_store(path, create=create, device=device)
        except FileNotFoundError:
            METRICS.inc("store.misses")
            raise UnknownStoreError(
                f"unknown store {name!r}: not under the store root "
                "(append with 'create' to make it)"
            ) from None
        except StoreCorruptionError as exc:
            telemetry.record_serve_error(exc, what=f"store open {name}")
            raise StoreCorruptedError(str(exc)) from exc
        if store.recovered:
            telemetry.event("store-recovered", store=name, gen=store.gen)
        entry = StoreEntry(name, store)
        _STORE_TABLE[name] = entry
        _publish_gauges()
        return entry


def append(
    name: str,
    codes: Any,
    array: Any,
    *,
    slab_id: str | None = None,
    create: dict | None = None,
    device: Any = None,
) -> dict:
    """Exactly-once slab ingestion; replays ack as no-ops. Returns the
    store's ack dict (``ack`` = ``"ingested"`` | ``"slab_already_ingested"``)."""
    entry = resolve(name, create=create, device=device)
    t0 = time.perf_counter()
    codes = utils.asarray_host(codes)
    array = utils.asarray_host(array)
    try:
        ack = entry.store.append(codes, array, slab_id=slab_id)
    except StoreCorruptionError as exc:
        telemetry.record_serve_error(exc, what=f"store append {name}")
        raise StoreCorruptedError(str(exc)) from exc
    entry.last_ack = time.time()
    telemetry.observe_cost(
        store_program_label("append", entry.store.funcs),
        dataset=name,
        device_ms=(time.perf_counter() - t0) * 1e3,
        nbytes=int(array.nbytes),
    )
    _publish_gauges()
    return ack


def query(name: str, funcs: Any = None, *, device: Any = None) -> dict:
    """Finalized ``{func: dense host array}`` from the persisted carry. The
    store finalizes on its device, and the last result stays there per store,
    answered from it while the generation is unchanged (the hot path a
    dashboard polling one store rides); any append invalidates it."""
    entry = resolve(name, device=device)
    sel = tuple(funcs) if funcs else tuple(entry.store.funcs)
    t0 = time.perf_counter()
    with entry.lock:
        if entry.dev is not None and entry.dev_gen == entry.store.gen and entry.dev_key == sel:
            METRICS.inc("store.query_device_hits")
            return {f: utils.asarray_host(v) for f, v in entry.dev.items()}
        entry.dev = entry.store.query(sel)
        entry.dev_gen = entry.store.gen
        entry.dev_key = sel
        out = {f: utils.asarray_host(v) for f, v in entry.dev.items()}
    telemetry.observe_cost(
        store_program_label("query", entry.store.funcs),
        dataset=name,
        device_ms=(time.perf_counter() - t0) * 1e3,
        nbytes=sum(int(v.nbytes) for v in out.values()),
    )
    return out


def compact(name: str) -> dict:
    """Crash-safe segment compaction for one store."""
    entry = resolve(name)
    try:
        return entry.store.compact()
    except StoreCorruptionError as exc:
        telemetry.record_serve_error(exc, what=f"store compact {name}")
        raise StoreCorruptedError(str(exc)) from exc


def list_stores() -> list[dict]:
    """Info dicts for every OPEN store plus the names present under the
    root but not yet opened (listed with ``"open": false``)."""
    with _LOCK:
        rows = [dict(e.info(), open=True) for e in _STORE_TABLE.values()]
        opened = {e.name for e in _STORE_TABLE.values()}
    try:
        root = _root()
    except UnknownStoreError:
        return rows
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return rows
    for n in names:
        if n not in opened and os.path.isfile(os.path.join(root, n, "journal.log")):
            rows.append({"store": n, "open": False})
    return rows


def stores_stats() -> dict:
    """The store table's ``cache.stats()`` panel — a snapshot, never a
    device or disk poll."""
    with _LOCK:
        entries = list(_STORE_TABLE.values())
        infos = [e.store.info() for e in entries]
        return {
            "stores": len(entries),
            "generations": {i["store"]: i["gen"] for i in infos},
            "state_bytes": sum(i["nbytes"] for i in infos),
            "device_cached": sum(1 for e in entries if e.dev is not None),
        }


def staleness_by_store(now: float | None = None) -> dict[str, float]:
    """Seconds since each OPEN store's last acked append (its ``last_ack``
    epoch is the open itself until an append lands) — the raw freshness-SLO
    signal the SLO plane reads. ``now`` lets a test drive the clock."""
    t = time.time() if now is None else float(now)
    with _LOCK:
        return {e.name: max(0.0, t - e.last_ack) for e in _STORE_TABLE.values()}


def publish_staleness(now: float | None = None) -> None:
    """Publish per-store ``store.staleness_s|store=<name>`` gauges — called
    by the saturation sampler between requests, so an idle replica's stores
    visibly age on /metrics instead of freezing at their last append."""
    for name, stale_s in staleness_by_store(now).items():
        METRICS.set_gauge(f"store.staleness_s|store={name}", round(stale_s, 3))


def debug_table(top: int | None = None) -> dict:
    """The ``/debug/stores`` payload: per-store rows (highest generation
    first) + the per-store cost-ledger join."""
    with _LOCK:
        rows = sorted((e.info() for e in _STORE_TABLE.values()), key=lambda r: -r["gen"])
    if top:
        rows = rows[:top]
    return {"stores": rows, "cost_by_store": telemetry.cost_by_dataset()}


def restage_all() -> int:
    """Reopen every table entry from its durable directory — the
    device-loss recovery hook, run with the dataset registry's restage
    before ``/readyz`` flips back. Reopening runs the store's full crash
    recovery, and the device result caches (dead tensors now) drop; the
    host carry is rebuilt from the checksummed segments, so a store answers
    identically after the cycle. Returns stores restaged."""
    restaged = 0
    with _LOCK:
        for entry in _STORE_TABLE.values():
            try:
                entry.store = IncrementalAggregationStore.open(entry.store.path,
                                                               device=entry.store.device)
            except (FileNotFoundError, StoreCorruptionError) as exc:
                # a store whose directory died with the device stays in the
                # table but unreadable: queries surface the typed error
                telemetry.record_serve_error(exc, what=f"store restage {entry.name}")
                continue
            entry.dev = None
            entry.dev_gen = -1
            restaged += 1
        _publish_gauges()
    if restaged:
        METRICS.inc("store.restaged", restaged)
        telemetry.event("stores-restaged", stores=restaged)
    return restaged


def clear() -> None:
    """Forget every open store (``cache.clear_all`` calls this). Durable
    state on disk is untouched — a later reference reopens it."""
    _STORE_TABLE.clear()
    METRICS.set_gauge("store.open_stores", 0.0)
    METRICS.set_gauge("store.state_bytes", 0.0)
