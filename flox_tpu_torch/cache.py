"""Host-side caches: the LRU the serving plane keys by, and one place to
read and drop every cache of the port (the port of ``flox_tpu/cache.py``).

:func:`stats` reports the entry counts of every module-level table the port
keeps, the serving plane's included, and :func:`clear_all` drops them and
resets the telemetry registry whose counters describe them (a benchmark that
clears between rounds must not carry stale counts across them). On-disk
state (durable stores, the warmup manifest file, built kernel libraries) is
untouched.

The autotune store (``autotune``: its entry count; cleared back to the
unloaded state, so the next consult reloads the configured file) and the
SLO plane (``slo``: ``slo.slo_stats``; cleared by ``slo.clear``) are among
them.

The reference's compiled-program caches and their counters have no
counterpart here (``_jitted_bundle`` and ``bundle_lru``, ``mesh_programs``,
``scan_programs``, ``stream_steps``, ``fused_programs``, the ``evictions``
of those LRUs, the donation probe and the Pallas probe memos): the port
traces and compiles no programs, its kernels are built once per library by
``_build`` (on disk, outside these tables), so there is nothing to cache.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Any, Iterator

__all__ = ["LRUCache", "clear_all", "memoize", "stats"]

memoize = functools.lru_cache(maxsize=512)


class LRUCache:
    """A bounded dict with least-recently-used eviction.

    A ``get`` hit renews the entry, an insert past ``maxsize`` evicts the
    single stalest key and counts it in ``evictions``. The mapping surface is
    the plain dict's (``get``, ``[]``, ``[]=``, ``in``, ``len``, ``items``,
    ``pop``, ``clear``); a lock keeps renew-on-read safe under the serving
    dispatcher's worker threads. ``items``/``keys``/``values`` list the
    entries stalest first.
    """

    def __init__(self, maxsize: int = 256) -> None:
        if maxsize < 1:
            raise ValueError(f"LRUCache maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.evictions = 0
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: Any, default: Any = None) -> Any:
        with self._lock:
            try:
                self._data.move_to_end(key)
            except KeyError:
                return default
            return self._data[key]

    def __getitem__(self, key: Any) -> Any:
        with self._lock:
            self._data.move_to_end(key)
            return self._data[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __iter__(self) -> Iterator:
        with self._lock:
            return iter(list(self._data))

    def keys(self) -> list:
        with self._lock:
            return list(self._data.keys())

    def values(self) -> list:
        with self._lock:
            return list(self._data.values())

    def items(self) -> list:
        with self._lock:
            return list(self._data.items())

    def pop(self, key: Any, *default: Any) -> Any:
        with self._lock:
            return self._data.pop(key, *default)

    def clear(self) -> None:
        """Drop every entry (``evictions`` counts capacity evictions, not
        clears, and stays)."""
        with self._lock:
            self._data.clear()


def stats() -> dict:
    """Entry counts of every host-side table of the port, and the serving
    plane's panels. A snapshot: it polls no device and touches no disk."""
    from .autotune import _AUTOTUNE_CACHE
    from .cohorts import _COHORTS_CACHE
    from .costmodel import _CARD_REGISTRY
    from .factorize import _FACTORIZE_CACHE
    from .kernels import _PRESENT_CACHE
    from .profiling import capture_active
    from .resilience import _SNAPSHOTS
    from .serve.aot import _MANIFEST_MEMO
    from .serve.breaker import breaker_stats
    from .serve.dispatcher import _BATCH_REGISTRY, _COALESCE_CACHE, _PENDING_REGISTRY
    from .serve.registry import registry_stats
    from .serve.stores import stores_stats
    from .slo import slo_stats
    from .telemetry import (
        FLIGHT_RECORDER,
        cost_by_dataset,
        cost_by_program,
        cost_by_tenant,
        hbm_by_program,
    )

    return {
        # the cost ledger's axes (telemetry.observe_cost), read through the
        # locked accessors
        "cost_by_program": cost_by_program(),
        "cost_by_tenant": cost_by_tenant(),
        "cost_by_dataset": cost_by_dataset(),
        "hbm_by_program": hbm_by_program(),
        "costmodel_cards": len(_CARD_REGISTRY),
        "flight_recorder": len(FLIGHT_RECORDER),
        "profile_capture_active": capture_active() is not None,
        "cohorts": len(_COHORTS_CACHE),
        "factorize": len(_FACTORIZE_CACHE),
        "present_tables": len(_PRESENT_CACHE),
        "stream_snapshots": len(_SNAPSHOTS),
        "autotune": len(_AUTOTUNE_CACHE),
        # the serving plane: admitted requests, open coalescing leaves and
        # micro-batches, and the warmup manifest's specs
        "serve_pending": len(_PENDING_REGISTRY),
        "serve_coalesce": len(_COALESCE_CACHE),
        "serve_batches": len(_BATCH_REGISTRY),
        "serve_aot_manifest": len(_MANIFEST_MEMO),
        "registry": registry_stats(),
        "stores": stores_stats(),
        "serve_breakers": breaker_stats(),
        "slo": slo_stats(),
    }


def clear_all() -> None:
    """Drop every host-side table of the port and reset the telemetry
    registry. Safe while a dispatcher is live: open batches hold their own
    leaves and registry entries, so a clear only keeps new requests from
    joining them."""
    from . import slo
    from .autotune import _AUTOTUNE_CACHE, _AUTOTUNE_STATE
    from .cohorts import _COHORTS_CACHE
    from .costmodel import _CARD_LABELS, _CARD_REGISTRY
    from .factorize import clear_caches
    from .kernels import _PRESENT_CACHE
    from .pipeline import _PREFETCH_INFLIGHT
    from .profiling import _CAPTURE_STATE
    from .resilience import _SNAPSHOTS
    from .serve import registry as serve_registry, stores as serve_stores
    from .serve.aot import _MANIFEST_MEMO
    from .serve.breaker import _BREAKER_REGISTRY
    from .serve.dispatcher import _BATCH_REGISTRY, _COALESCE_CACHE, _PENDING_REGISTRY
    from .telemetry import (
        _COST_LEDGER,
        _PENDING_DEVICE,
        _TAIL_REGISTRY,
        _TENANT_LABELS,
        FLIGHT_RECORDER,
        METRICS,
    )

    _COHORTS_CACHE.clear()
    clear_caches()
    _PRESENT_CACHE.clear()
    _SNAPSHOTS.clear()
    _PENDING_REGISTRY.clear()
    _COALESCE_CACHE.clear()
    _BATCH_REGISTRY.clear()
    _MANIFEST_MEMO.clear()
    # the registry and store tables reset their gauges too; durable store
    # state on disk stays, and a later reference reopens it
    serve_registry.clear()
    serve_stores.clear()
    # a cleared process has no failure history, so no breaker stays open
    _BREAKER_REGISTRY.clear()
    _CARD_REGISTRY.clear()
    _CARD_LABELS.clear()
    FLIGHT_RECORDER.clear()
    _TAIL_REGISTRY.clear()
    _COST_LEDGER.clear()
    _PENDING_DEVICE.clear()
    _TENANT_LABELS.clear()
    _CAPTURE_STATE.clear()
    _PREFETCH_INFLIGHT[0] = 0
    # the tuner returns to the unloaded state: the next consult reloads the
    # configured file (or runs the heuristics when none is set)
    _AUTOTUNE_CACHE.clear()
    _AUTOTUNE_STATE.clear()
    METRICS.reset()
    # alert state must not outlive the counters it judged
    slo.clear()
