"""Resident dataset registry: factorize once, serve from device memory (the
port of ``flox_tpu/serve/registry.py``).

A JSON-lines request that inlines its payload re-ships, re-parses,
re-factorizes and re-stages (host to device) the same arrays on every
request, so hot-data request cost is everything *except* the reduction.
``{"op": "put_dataset"}`` keeps named arrays on the device once, and
aggregation requests reference them by name (``"dataset": "<name>"`` plus
an optional ``rows``/``mask`` selector) instead of carrying data.

The put pays every per-dataset cost up front:

* **factorize once** — labels are factorized at put time into a
  :class:`~flox_tpu_torch.factorize.Prefactorized` (codes, group tables,
  and the sort engine's present/compact tables, keyed on the entry's
  content fingerprint), its codes staged on the device. A registry hit
  enters the reduction with zero factorize work.
* **stage once** — the data lives on the device as a tensor, and a dispatch
  passes it (or a view of it) straight to the kernels: nothing crosses the
  bus for the payload. Arrays of at least ``registry_shard_threshold_bytes``
  are sharded over the trailing axis when ``torch.distributed`` has more
  than one rank and the axis divides evenly among them (a ``DTensor``
  over the default mesh); otherwise they stay on one device. A sharded put
  that fails raises: nothing quietly stages elsewhere.
* **fingerprint once** — the entry's content fingerprint replaces payload
  hashing in the dispatcher's coalescing identity (``ds:<fp>:<selector>``).

Capacity is device-byte accounted: entries are bounded by
``registry_budget_fraction`` of the card's memory (``device.memory_stats``
``bytes_limit``) — or by the absolute ``registry_budget_bytes`` where the
device reports none (the CPU) — and evicted least-recently-used. Entries
pinned by in-flight dispatches are never evicted mid-dispatch;
``del_dataset`` under traffic only unpublishes the name. Host copies make
device-loss recovery whole: the recovery cycle restages every dataset
before ``/readyz`` flips back.

The registry table is registered in ``cache.clear_all`` / ``cache.stats``;
``registry.*`` counters and gauges ride the metrics registry, and
per-dataset cost attribution rides the cost ledger's ``dataset`` axis
(``/debug/datasets``).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from .. import options, telemetry, utils
from ..cache import LRUCache
from ..factorize import Prefactorized, prefactorize
from ..telemetry import METRICS
from .dispatcher import ServeError

__all__ = [
    "DatasetEntry",
    "UnknownDatasetError",
    "budget_bytes",
    "clear",
    "debug_table",
    "delete",
    "list_datasets",
    "pin",
    "put",
    "registry_stats",
    "resolve",
    "restage_all",
    "unpin",
    "view",
]


class UnknownDatasetError(ServeError):
    """The request referenced a ``dataset`` name the registry does not
    hold — never put, already deleted, or evicted under HBM pressure
    (check the ``registry.evictions`` counter). A typed protocol error,
    not an ``execution`` failure: the client's fix is ``put_dataset``
    (or routing to the replica that holds the name)."""

    code = "unknown_dataset"


#: selector views memoized per entry — bounded: selectors are request-
#: shaped, and an adversarial client cycling masks must not grow an
#: entry's footprint without bound
_MAX_VIEWS_PER_ENTRY = 8


class DatasetEntry:
    """One resident dataset: device tensors + precomputed group tables +
    host copies (the device-loss restage source)."""

    __slots__ = (
        "name", "fingerprint", "data", "data_host", "by_host", "pf",
        "nbytes", "pins", "hits", "sharded", "views", "created", "device",
    )

    def __init__(
        self,
        name: str,
        fingerprint: str,
        *,
        data: Any,
        data_host: np.ndarray | None,
        by_host: np.ndarray,
        pf: Prefactorized,
        sharded: bool,
        device: torch.device,
    ) -> None:
        self.name = name
        self.fingerprint = fingerprint
        self.data = data
        self.data_host = data_host
        self.by_host = by_host
        self.pf = pf
        self.nbytes = int(
            (getattr(data, "nbytes", 0) or 0) + pf.device_nbytes()
        )
        self.pins = 0
        self.hits = 0
        self.sharded = sharded
        self.views: dict[str, tuple] = {}
        self.created = time.time()
        self.device = device

    def info(self) -> dict:
        """The entry's JSON-safe description (list/debug/stats payloads)."""
        return {
            "name": self.name,
            "fingerprint": self.fingerprint,
            "nbytes": int(self.nbytes),
            "pins": int(self.pins),
            "hits": int(self.hits),
            "sharded": bool(self.sharded),
            "has_data": self.data is not None,
            "by_shape": list(self.by_host.shape),
            "by_dtype": str(self.by_host.dtype),
            "ngroups": int(self.pf.ngroups),
            "size": int(self.pf.size),
            "present": int(len(self.pf.present)),
            "views": len(self.views),
            "device": str(self.device),
        }


#: the resident dataset table: name -> DatasetEntry, LRU-ordered so budget
#: eviction drops the stalest name first. maxsize is a backstop, never the
#: capacity mechanism — the device-byte budget (budget_bytes) is.
#: Registered in cache.clear_all / cache.stats.
_DATASET_REGISTRY: LRUCache = LRUCache(maxsize=4096)

#: budget evictions (deliberate frees, distinct from the LRU's capacity
#: counter): the runbook alarm feed behind registry.evictions
_EVICTIONS = [0]

_LOCK = threading.RLock()


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------


#: last computed budget — ``registry_stats()`` (the ``cache.stats()``
#: panel) reports this snapshot instead of polling the device (the
#: saturation sampler, puts, evictions and /debug/datasets refresh it)
_BUDGET_SNAPSHOT = [0]


def budget_bytes() -> int:
    """The registry's device-byte budget.

    ``registry_budget_fraction`` of the card's reported memory (the
    ``hbm.bytes_limit`` gauge's source) when a CUDA device reports one; the
    absolute ``registry_budget_bytes`` where none does (the CPU). 0 means
    unenforced."""
    from .. import device

    stats = device.memory_stats()
    limit = int((stats or {}).get("bytes_limit") or 0)
    if limit > 0:
        budget = int(limit * float(options.OPTIONS["registry_budget_fraction"]))
    else:
        budget = int(options.OPTIONS["registry_budget_bytes"])
    _BUDGET_SNAPSHOT[0] = budget
    return budget


def _total_bytes() -> int:
    return sum(e.nbytes for e in _DATASET_REGISTRY.values())


def _publish_gauges() -> None:
    entries = _DATASET_REGISTRY.values()
    METRICS.set_gauge("registry.datasets", float(len(entries)))
    METRICS.set_gauge(
        "registry.bytes", float(sum(e.nbytes for e in entries))
    )
    METRICS.set_gauge(
        "registry.pinned_bytes",
        float(sum(e.nbytes for e in entries if e.pins > 0)),
    )


def _evict_to_budget(exclude: DatasetEntry | None = None) -> list[str]:
    """Drop stalest entries until the device-byte total fits the budget.

    Pinned entries (in-flight dispatches hold them) and ``exclude`` (the
    put that triggered the sweep) are skipped — a workload whose PINNED
    set alone exceeds the budget runs over it rather than failing
    dispatches mid-flight; the overshoot is visible on ``registry.bytes``
    vs the budget. Caller holds ``_LOCK``."""
    budget = budget_bytes()
    if budget <= 0:
        return []
    evicted: list[str] = []
    total = _total_bytes()
    # items() is stalest-first on the LRU — walk in eviction order
    for name, entry in _DATASET_REGISTRY.items():
        if total <= budget:
            break
        if entry.pins > 0 or entry is exclude:
            continue
        _DATASET_REGISTRY.pop(name, None)
        total -= entry.nbytes
        evicted.append(name)
        _EVICTIONS[0] += 1
        METRICS.inc("registry.evictions")
        telemetry.event(
            "registry-evicted", dataset=name, nbytes=entry.nbytes,
            budget=budget,
        )
    return evicted


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def _shard_count(nbytes: int, length: int) -> int:
    """The ranks a dataset of ``nbytes`` with a trailing axis of ``length``
    is sharded over: the world's size when the array reaches
    ``registry_shard_threshold_bytes``, the world has more than one rank and
    the axis divides evenly; else 1 (one device)."""
    from ..parallel.mesh import world_size

    thresh = int(options.OPTIONS["registry_shard_threshold_bytes"])
    ndev = world_size()
    if thresh and nbytes >= thresh and ndev > 1 and length % ndev == 0:
        return ndev
    return 1


def _stage_data(data_host: np.ndarray, device: torch.device) -> tuple[Any, bool]:
    """Put one host array on ``device``, sharded over the trailing axis when
    :func:`_shard_count` says so. Returns ``(tensor or DTensor, sharded)``.
    A sharded put that fails raises."""
    if data_host.ndim >= 1 and _shard_count(data_host.nbytes, data_host.shape[-1]) > 1:
        from ..parallel.mesh import default_mesh, shard_last_axis

        return shard_last_axis(utils.as_tensor(data_host, device), default_mesh(device)), True
    return utils.as_tensor(data_host, device), False


#: arrays above this many bytes are digested in chunks of this size on a
#: thread pool (hashlib releases the GIL), the chunk digests then hashed in
#: order: a multi-GB dataset fingerprints at the host's memory rate instead
#: of one core's hashing rate
_FINGERPRINT_CHUNK = 64 << 20


def _chunk_digest(buf: memoryview) -> bytes:
    return hashlib.blake2b(buf, digest_size=16).digest()


def _fingerprint_update(h: Any, arr: np.ndarray | None) -> None:
    if arr is None:
        h.update(b"<none>")
        return
    a = np.asarray(arr)
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    if a.dtype.kind == "O":
        h.update(repr(a.tolist()).encode())
        return
    buf = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    if len(buf) <= _FINGERPRINT_CHUNK:
        h.update(buf)
        return
    from concurrent.futures import ThreadPoolExecutor

    chunks = [buf[i:i + _FINGERPRINT_CHUNK] for i in range(0, len(buf), _FINGERPRINT_CHUNK)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for digest in pool.map(_chunk_digest, chunks):
            h.update(digest)


def _content_fingerprint(
    by: np.ndarray, data: np.ndarray | None, expected: Any
) -> str:
    h = hashlib.blake2b(digest_size=16)
    _fingerprint_update(h, by)
    _fingerprint_update(h, None if expected is None else np.asarray(expected))
    _fingerprint_update(h, data)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# protocol surface
# ---------------------------------------------------------------------------


def put(
    name: Any,
    array: Any = None,
    by: Any = None,
    *,
    expected_groups: Any = None,
    sort: bool = True,
    device: Any = None,
) -> dict:
    """Keep one named dataset on ``device`` (CUDA unless the caller names
    the CPU), factorized and staged.

    ``by`` (the label arrays) is required — it is what factorize-once
    applies to; ``array`` is optional (a labels-only entry serves requests
    that still inline per-request data over resident codes). Re-putting a
    name replaces the entry. Returns the entry's info dict plus what the
    budget sweep evicted to make room.
    """
    if not isinstance(name, str) or not name:
        raise ValueError("put_dataset requires a non-empty string 'name'")
    if by is None:
        raise ValueError(
            "put_dataset requires 'by' label arrays — factorize-once is "
            "the point of a resident dataset"
        )
    dev = utils.resolve_device(device)
    t0 = time.perf_counter()
    by_host = utils.asarray_host(by)
    data_host = utils.asarray_host(array) if array is not None else None
    if data_host is not None and data_host.shape[-by_host.ndim:] != by_host.shape:
        raise ValueError(
            f"dataset array trailing dims {data_host.shape!r} do not align "
            f"with by shape {by_host.shape!r}"
        )
    fingerprint = _content_fingerprint(by_host, data_host, expected_groups)
    with telemetry.span("registry.put", dataset=name):
        pf = prefactorize(
            by_host, expected_groups, sort=sort, fingerprint=fingerprint, device=dev
        )
        data_dev: Any = None
        sharded = False
        if data_host is not None:
            data_dev, sharded = _stage_data(data_host, dev)
    entry = DatasetEntry(
        name, fingerprint,
        data=data_dev, data_host=data_host, by_host=by_host, pf=pf,
        sharded=sharded, device=dev,
    )
    with _LOCK:
        _DATASET_REGISTRY[name] = entry
        evicted = _evict_to_budget(exclude=entry)
        _publish_gauges()
    METRICS.inc("registry.puts")
    info = entry.info()
    info["evicted"] = evicted
    info["put_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    return info


def resolve(name: str) -> DatasetEntry:
    """The live entry for ``name`` (LRU-renewing), or a typed
    :class:`UnknownDatasetError`."""
    entry = _DATASET_REGISTRY.get(name)
    if entry is None:
        METRICS.inc("registry.misses")
        raise UnknownDatasetError(
            f"unknown dataset {name!r}: not put, deleted, or evicted under "
            "HBM pressure (registry.evictions) — put_dataset it again"
        )
    entry.hits += 1
    METRICS.inc("registry.hits")
    return entry


def pin(entry: DatasetEntry) -> None:
    """Refcount ``entry`` as in-flight: a pinned entry is never evicted
    mid-dispatch (``del_dataset`` only unpublishes the name; the dispatch
    holds direct references)."""
    with _LOCK:
        entry.pins += 1
        _publish_gauges()


def unpin(entry: DatasetEntry) -> None:
    with _LOCK:
        entry.pins = max(0, entry.pins - 1)
        _publish_gauges()


def view(
    entry: DatasetEntry, rows: Any = None, mask: Any = None
) -> tuple[Any, Prefactorized, str]:
    """The (data, prefactorized, selector-key) triple a request resolves to.

    ``rows`` is a ``[start, stop)`` pair, ``mask`` a boolean vector over
    the flattened label axis; both select on the device (a view for rows, a
    gather for masks), so no payload crosses the bus. Selector views share
    the entry's group tables and are memoized per entry (bounded), so a
    repeated selector costs one dict hit. A selector over a sharded entry
    gathers the shards first."""
    if rows is None and mask is None:
        return entry.data, entry.pf, ""
    if rows is not None and mask is not None:
        raise ValueError("pass 'rows' or 'mask', not both")
    pf = entry.pf
    if rows is not None:
        lo, hi = int(rows[0]), int(rows[1])
        key = f"rows:{lo}:{hi}"
    else:
        mask = np.asarray(mask, dtype=bool).reshape(-1)
        if mask.shape[0] != pf.n:
            raise ValueError(
                f"mask length {mask.shape[0]} != dataset rows {pf.n}"
            )
        key = "mask:" + hashlib.blake2b(
            mask.tobytes(), digest_size=8
        ).hexdigest()
    cached = entry.views.get(key)
    if cached is not None:
        METRICS.inc("registry.view_hits")
        return cached[0], cached[1], key
    if rows is not None:
        pf_view = pf.slice_rows(lo, hi)
    else:
        pf_view = pf.select_mask(mask)
    data_view: Any = None
    if entry.data is not None:
        from ..parallel.mesh import is_dtensor

        data = entry.data.full_tensor() if is_dtensor(entry.data) else entry.data
        lead = tuple(data.shape[: data.ndim - len(pf.by_shape)])
        flat = data.reshape(lead + (pf.n,))
        if rows is not None:
            data_view = flat[..., lo:hi]
        else:
            idx = torch.from_numpy(np.flatnonzero(mask)).to(flat.device)
            data_view = flat.index_select(-1, idx)
    if len(entry.views) >= _MAX_VIEWS_PER_ENTRY:
        entry.views.pop(next(iter(entry.views)))
    entry.views[key] = (data_view, pf_view)
    return data_view, pf_view, key


def delete(name: str) -> bool:
    """Unpublish ``name``. In-flight dispatches referencing the entry
    finish normally (they hold direct references + a pin); only NEW
    requests see :class:`UnknownDatasetError`. Returns whether the name
    existed."""
    with _LOCK:
        entry = _DATASET_REGISTRY.pop(name, None)
        _publish_gauges()
    if entry is None:
        return False
    METRICS.inc("registry.deletes")
    return True


def list_datasets() -> list[dict]:
    """Every resident entry's info dict (LRU order, stalest first)."""
    return [entry.info() for entry in _DATASET_REGISTRY.values()]


def debug_table(top: int | None = None) -> dict:
    """The ``/debug/datasets`` payload: per-entry rows (hottest first) +
    capacity summary + the per-dataset cost-ledger join."""
    rows = sorted(list_datasets(), key=lambda r: -r["hits"])
    if top:
        rows = rows[:top]
    return {
        "datasets": rows,
        "bytes": _total_bytes(),
        "budget_bytes": budget_bytes(),
        "evictions": _EVICTIONS[0],
        "cost_by_dataset": telemetry.cost_by_dataset(),
    }


def registry_stats() -> dict:
    """The registry's ``cache.stats()`` panel.

    Reports the budget SNAPSHOT, not a live device poll — ``cache.stats()``
    must stay backend-untouched on an idle plane (use ``/debug/datasets``
    for the live figure)."""
    entries = _DATASET_REGISTRY.values()
    return {
        "datasets": len(entries),
        "bytes": sum(e.nbytes for e in entries),
        "pinned": sum(1 for e in entries if e.pins > 0),
        "pinned_bytes": sum(e.nbytes for e in entries if e.pins > 0),
        "budget_bytes": _BUDGET_SNAPSHOT[0],
        "evictions": _EVICTIONS[0],
    }


def restage_all() -> int:
    """Restage every registered dataset from its host copies — the
    device-loss recovery hook, run after the device layer's reinitialize
    and the warmup replay but BEFORE ``/readyz`` flips back, so a recovered
    replica answers its registry-referenced traffic immediately. Returns
    entries restaged."""
    restaged = 0
    with _LOCK:
        for entry in _DATASET_REGISTRY.values():
            entry.pf.stage(entry.device)
            if entry.data_host is not None:
                entry.data, entry.sharded = _stage_data(entry.data_host, entry.device)
            # selector views hold dead-device buffers: rebuild on demand
            entry.views.clear()
            entry.nbytes = int(
                (getattr(entry.data, "nbytes", 0) or 0)
                + entry.pf.device_nbytes()
            )
            restaged += 1
        _publish_gauges()
    if restaged:
        METRICS.inc("registry.restaged", restaged)
        telemetry.event("registry-restaged", datasets=restaged)
    return restaged


def clear() -> None:
    """Drop every resident dataset (``cache.clear_all`` calls this).
    In-flight dispatches keep their direct references — a clear only
    unpublishes names."""
    _DATASET_REGISTRY.clear()
    _EVICTIONS[0] = 0
    _BUDGET_SNAPSHOT[0] = 0
    METRICS.set_gauge("registry.datasets", 0.0)
    METRICS.set_gauge("registry.bytes", 0.0)
    METRICS.set_gauge("registry.pinned_bytes", 0.0)
