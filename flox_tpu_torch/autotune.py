"""The measurement-fed autotuner (the port of ``flox_tpu/autotune.py``).

Every ``auto`` choice of the port that has more than one candidate consults
this store when the tuner is on:

* the segment-sum lowering (``kernels._segment_sum_impl``): on a CUDA
  tensor the segment-sum kernel or the radix-binning kernel, whichever
  guards pass (``index_add_`` only where neither does); on the CPU
  ``index_add_`` alone;
* grouped order statistics (``kernels._quantile_impl_choice``): sort or the
  radix select;
* dense or present-groups accumulators past ``sort_engine_min_groups``
  (``core._route_highcard`` and its streaming form): the ``highcard``
  family, which on a CUDA device never moves a call to dense accumulators
  past the kernels' group caps;
* one fused pass or sequential ``groupby_reduce`` calls
  (``fusion.groupby_aggregate_many``, off a mesh): the ``fused`` family;
* the engine of host data reduced on the CPU (``core._tuned_engine``):
  ``"torch"`` or ``"numpy"``. On a CUDA device this family is never
  consulted, so no decision moves a call off the card;
* the streaming slab budget and prefetch depth (``streaming``,
  ``pipeline.stream_slabs``); the ranks of a mesh stream agree on the
  budget and the carry.

On the card no decision moves a call from a hand-written kernel to a
library route: a tiny sweep's winner is applied across element bands (the
reference's rule), and only the kernels compete there.

The store holds observed GB/s per candidate under the reference's key,
``family|platform|dtype|g<band>|e<band>``, so that a store file written by
either package loads in the other. The platform is the device of the data
(``"cuda"`` or ``"cpu"``); candidate names read from a file are mapped as
``options.from_reference`` maps options (``"pallas"`` -> ``"kernel"``,
``"jax"`` -> ``"torch"``), and a candidate the port lacks (``"matmul"``) is
never eligible. Observations fold into an EWMA; a flip of a winner bumps the
store version, which :func:`decision_fingerprint` carries into
``options.trace_fingerprint()`` (the serving dispatcher's program keys).

Sources: one micro-sweep per banded key at first use (:func:`prime_reduce`,
:func:`prime_engine`, :func:`prime_highcard`; budgeted per process), the
stream reports (:func:`observe_stream`), and seeds from the repo's
committed measurements (:func:`seed`), of which only records taken on a
CUDA card count. A sweep times each candidate on the data's device, every
timed repetition ending in ``torch.cuda.synchronize()`` there, and swallows
no exception: a kernel candidate that fails to build or launch raises out of
the call that triggered the sweep. A candidate whose guards reroute it
returns no runner and is not timed. On the CPU the kernel candidates are
not candidates (their plain versions are not the kernels).

Off (the default) is record-only: observations accrete, dispatch is the
untuned one. Persistence is an atomic JSON file at
``OPTIONS["autotune_cache_path"]``, loaded lazily at first consult, merged
on save and saved at exit. ``cache.clear_all`` returns the tuner to the
unloaded state.

CLI: ``python -m flox_tpu_torch.autotune report`` prints the store;
``python -m flox_tpu_torch.autotune sentinel --current '{"fam": gbps}'``
diffs per-family GB/s against the last bench round of the same platform.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Mapping

logger = logging.getLogger(__name__)

__all__ = [
    "compare_families",
    "decide",
    "decision_fingerprint",
    "decision_record",
    "enabled",
    "load",
    "lookup",
    "make_key",
    "observe_stream",
    "pick_stream_batch_bytes",
    "pick_stream_prefetch",
    "prime_engine",
    "prime_highcard",
    "prime_reduce",
    "record",
    "regression_sentinel",
    "save",
    "seed",
]

#: on-disk format version, the reference's: a file of another version is
#: discarded with a warning
_FORMAT_VERSION = 1

#: the store: key -> {"candidates": {name: {"gbps", "n"}}, "source"}
_AUTOTUNE_CACHE: dict[str, dict] = {}

#: process-local tuner state (lazy-load flag, sweep and hit counters,
#: version); every read goes through ``.get`` with a default, so the cleared
#: dict is the reset state
_AUTOTUNE_STATE: dict[str, Any] = {}

_LOCK = threading.RLock()

#: per-process ceiling on in-call micro-sweeps
_SWEEP_BUDGET = 16

#: micro-sweep workload bounds (elements along the reduced axis, rows)
_SWEEP_N_MAX = 8192
_SWEEP_ROWS = 8

#: engine-sweep workload cap (small host arrays, where numpy can win)
_SWEEP_ENGINE_N_MAX = 65536

#: highcard-sweep caps: the caller's present density at a capped universe
_SWEEP_HIGHCARD_SIZE_MAX = 1 << 20
_SWEEP_HIGHCARD_N_MAX = 1 << 16

#: the sentinel flags a family whose GB/s drops below (1 - this) x before
_REGRESSION_THRESHOLD = 0.15

#: element-band tolerance of nearest-band lookups, per family
_NEAREST_TOLERANCE = {"engine": 1}
_NEAREST_TOLERANCE_DEFAULT = 6

#: group-band tolerance, for families whose winner turns on the group count
_NEAREST_TOLERANCE_GROUPS = {"highcard": 2}

#: reference candidate names in the port
_CANDIDATE_NAMES = {"pallas": "kernel", "jax": "torch"}


def enabled() -> bool:
    """Whether tuned dispatch is on (``OPTIONS["autotune"]``)."""
    from .options import OPTIONS

    return bool(OPTIONS["autotune"])


def cache_path() -> str | None:
    """The configured persistence path (``OPTIONS["autotune_cache_path"]``)."""
    from .options import OPTIONS

    path = OPTIONS["autotune_cache_path"]
    return None if path is None else str(path)


# ---------------------------------------------------------------------------
# key schema
# ---------------------------------------------------------------------------


def platform_of(device: Any = None) -> str:
    """The key's platform: the type of ``device`` (``"cuda"``, ``"cpu"``),
    or, with none, ``"cuda"`` where a card is present and ``"cpu"`` else."""
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def dtype_name(dtype: Any) -> str:
    """The reference's spelling of a numpy or torch dtype (``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def _gband(ngroups: int) -> int:
    """Group-count band: log2 (0 for unknown or zero)."""
    return int(ngroups).bit_length() if ngroups > 0 else 0


def _eband(nelems: int) -> int:
    """Element-count band: log4."""
    return (int(nelems).bit_length() + 1) // 2 if nelems > 0 else 0


def make_key(family: str, *, dtype: Any = None, ngroups: int = 0, nelems: int = 0,
             platform: str | None = None) -> str:
    """The store key: ``family|platform|dtype|g<band>|e<band>``."""
    plat = platform_of() if platform is None else platform
    dt = "any" if dtype is None else dtype_name(dtype)
    return f"{family}|{plat}|{dt}|g{_gband(ngroups)}|e{_eband(nelems)}"


def _split_key(key: str) -> tuple[str, str, str, int, int] | None:
    parts = key.split("|")
    if len(parts) != 5:
        return None
    try:
        return parts[0], parts[1], parts[2], int(parts[3][1:]), int(parts[4][1:])
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def _ensure_loaded() -> None:
    """One load per process (per ``clear_all``) from the configured path,
    plus the seeds when the tuner is on."""
    with _LOCK:
        if _AUTOTUNE_STATE.get("loaded"):
            return
        _AUTOTUNE_STATE["loaded"] = True
        path = cache_path()
        if path is not None:
            load(path)
        if enabled():
            seed()


def load(path: str) -> bool:
    """Merge a store file into the in-memory store; whether a valid file was
    read. A corrupt, partial or other-version file warns and changes
    nothing. In-process observations win over the file's on a key."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return False
    except (OSError, ValueError) as exc:
        warnings.warn(f"flox_tpu_torch.autotune: cache file {path!r} is unreadable "
                      f"({type(exc).__name__}: {exc}); falling back to heuristics",
                      RuntimeWarning, stacklevel=2)
        return False
    if not isinstance(payload, dict) or payload.get("version") != _FORMAT_VERSION:
        got = payload.get("version") if isinstance(payload, dict) else type(payload).__name__
        warnings.warn(f"flox_tpu_torch.autotune: cache file {path!r} has unsupported format "
                      f"{got!r}; falling back to heuristics", RuntimeWarning, stacklevel=2)
        return False
    records = payload.get("records")
    if not isinstance(records, dict):
        warnings.warn(f"flox_tpu_torch.autotune: cache file {path!r} carries no record table; "
                      "falling back to heuristics", RuntimeWarning, stacklevel=2)
        return False
    merged = 0
    with _LOCK:
        for key, rec in records.items():
            if _split_key(key) is None or not isinstance(rec, dict):
                continue
            cands = rec.get("candidates")
            if not isinstance(cands, dict):
                continue
            clean = {
                _CANDIDATE_NAMES.get(str(name), str(name)):
                    {"gbps": float(c["gbps"]), "n": int(c.get("n", 1))}
                for name, c in cands.items()
                if isinstance(c, dict) and isinstance(c.get("gbps"), (int, float))
            }
            if not clean:
                continue
            slot = _AUTOTUNE_CACHE.setdefault(
                key, {"candidates": {}, "source": str(rec.get("source", "disk"))})
            for name, c in clean.items():
                slot["candidates"].setdefault(name, c)
            merged += 1
        if merged:
            _AUTOTUNE_STATE["version"] = _AUTOTUNE_STATE.get("version", 0) + 1
    logger.debug("autotune: loaded %d record(s) from %s", merged, path)
    return merged > 0


def save(path: str | None = None) -> str | None:
    """Persist the store atomically (tmp + rename), merged with the file's
    records first; ``None`` uses the configured path, and with neither the
    save is a no-op returning ``None``."""
    path = cache_path() if path is None else str(path)
    if path is None:
        return None
    load(path)
    with _LOCK:
        payload = {
            "version": _FORMAT_VERSION,
            "platform": platform_of(),
            "records": {
                key: {"candidates": {name: dict(c) for name, c in rec["candidates"].items()},
                      "source": rec.get("source", "observed")}
                for key, rec in _AUTOTUNE_CACHE.items()
            },
        }
    parent = os.path.dirname(path)
    try:
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    except OSError as exc:
        logger.warning("autotune: could not persist store to %s: %s", path, exc)
        return None
    return path


def _register_atexit() -> None:
    with _LOCK:
        if _AUTOTUNE_STATE.get("atexit"):
            return
        _AUTOTUNE_STATE["atexit"] = True
    import atexit

    atexit.register(_save_at_exit)


def _save_at_exit() -> None:
    if _AUTOTUNE_CACHE and cache_path() is not None:
        save()


# ---------------------------------------------------------------------------
# recording + lookup
# ---------------------------------------------------------------------------


def record(family: str, candidate: str, gbps: float, *, dtype: Any = None, ngroups: int = 0,
           nelems: int = 0, platform: str | None = None, source: str = "observed") -> None:
    """Fold one observed throughput of ``candidate`` into the banded key's
    EWMA (alpha 0.3). A flip of the winner bumps the version. ``"seed"``
    records defer to a measured record already under the key."""
    if not (isinstance(gbps, (int, float)) and gbps > 0):
        return
    key = make_key(family, dtype=dtype, ngroups=ngroups, nelems=nelems, platform=platform)
    with _LOCK:
        if source == "seed":
            existing = _AUTOTUNE_CACHE.get(key)
            if existing is not None and existing.get("source") != "seed":
                return
        rec = _AUTOTUNE_CACHE.setdefault(key, {"candidates": {}, "source": source})
        before = _winner(rec)
        slot = rec["candidates"].get(candidate)
        if slot is None:
            rec["candidates"][candidate] = {"gbps": float(gbps), "n": 1}
        else:
            slot["gbps"] = 0.7 * float(slot["gbps"]) + 0.3 * float(gbps)
            slot["n"] = int(slot["n"]) + 1
        rec["source"] = source
        if _winner(rec) != before:
            _AUTOTUNE_STATE["version"] = _AUTOTUNE_STATE.get("version", 0) + 1
        _AUTOTUNE_STATE["records"] = _AUTOTUNE_STATE.get("records", 0) + 1
    if cache_path() is not None:
        _register_atexit()


def _winner(rec: Mapping[str, Any]) -> str | None:
    cands = rec.get("candidates") or {}
    if not cands:
        return None
    return max(cands, key=lambda name: cands[name]["gbps"])


def lookup(family: str, *, dtype: Any = None, ngroups: int = 0, nelems: int = 0,
           platform: str | None = None) -> dict | None:
    """The record of the exact key, else the nearest measured band within the
    family's tolerance (same family, platform and dtype; element band first,
    group band as tiebreak); ``None`` when nothing is close enough."""
    _ensure_loaded()
    key = make_key(family, dtype=dtype, ngroups=ngroups, nelems=nelems, platform=platform)
    with _LOCK:
        rec = _AUTOTUNE_CACHE.get(key)
        if rec is not None:
            return rec
        want = _split_key(key)
        if want is None:
            return None
        tolerance = _NEAREST_TOLERANCE.get(family, _NEAREST_TOLERANCE_DEFAULT)
        gtolerance = _NEAREST_TOLERANCE_GROUPS.get(family)
        best_rec, best_dist = None, None
        for other_key, other in _AUTOTUNE_CACHE.items():
            got = _split_key(other_key)
            if got is None or got[:3] != want[:3]:
                continue
            dist = (abs(got[4] - want[4]), abs(got[3] - want[3]))
            if dist[0] > tolerance:
                continue
            if gtolerance is not None and dist[1] > gtolerance:
                continue
            if best_dist is None or dist < best_dist:
                best_rec, best_dist = other, dist
        return best_rec


def decide(family: str, fallback: str, candidates: Iterable[str], *, dtype: Any = None,
           ngroups: int = 0, nelems: int = 0, platform: str | None = None) -> str:
    """The observed winner among ``candidates`` for the key when the tuner is
    on and has one; else the cost model's prior where it has one (the H100's
    peak row); else ``fallback``."""
    if not enabled():
        return fallback
    candidates = tuple(candidates)
    rec = lookup(family, dtype=dtype, ngroups=ngroups, nelems=nelems, platform=platform)
    if rec is None:
        from .costmodel import analytic_prior

        prior = analytic_prior(family, fallback, candidates, dtype=dtype, ngroups=ngroups,
                               nelems=nelems, platform=platform_of() if platform is None
                               else platform)
        return prior if prior is not None else fallback
    cands = rec.get("candidates") or {}
    eligible = {name: cands[name]["gbps"] for name in cands if name in set(candidates)}
    if not eligible:
        return fallback
    winner = max(eligible, key=lambda name: eligible[name])
    with _LOCK:
        _AUTOTUNE_STATE["hits"] = _AUTOTUNE_STATE.get("hits", 0) + 1
    if winner != fallback:
        logger.debug("autotune: %s -> %r (heuristic said %r)", family, winner, fallback)
    return winner


def decision_fingerprint() -> tuple:
    """The tuner's part of ``options.trace_fingerprint``: constant while the
    tuner is off, the store version while it is on."""
    if not enabled():
        return (False,)
    return (True, _AUTOTUNE_STATE.get("version", 0))


def decision_record() -> dict:
    """Store size, counters and the current winner of every key."""
    _ensure_loaded()
    with _LOCK:
        winners = {}
        for key, rec in sorted(_AUTOTUNE_CACHE.items()):
            name = _winner(rec)
            if name is not None:
                winners[key] = {"winner": name, "gbps": round(rec["candidates"][name]["gbps"], 3),
                                "source": rec.get("source", "observed")}
        return {
            "enabled": enabled(),
            "cache_path": cache_path(),
            "entries": len(_AUTOTUNE_CACHE),
            "sweeps": _AUTOTUNE_STATE.get("sweeps", 0),
            "cache_hits": _AUTOTUNE_STATE.get("hits", 0),
            "version": _AUTOTUNE_STATE.get("version", 0),
            "winners": winners,
        }


# ---------------------------------------------------------------------------
# seeding from committed measurements
# ---------------------------------------------------------------------------


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seed(root: str | None = None) -> int:
    """Seed the store from the repo's committed measurements: the reference's
    files (``BENCH_TPU_LAST.json`` and the newest ``BENCH_HISTORY`` round),
    of which only records taken on a CUDA card (``"platform": "cuda"``)
    count. Returns how many records were seeded."""
    root = _repo_root() if root is None else root
    seeded = 0
    for path in (os.path.join(root, "BENCH_TPU_LAST.json"),
                 os.path.join(root, "BENCH_HISTORY", "bench_runs.jsonl")):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        lines = text.strip().splitlines()
        if not lines:
            continue
        try:
            payload = json.loads(lines[-1] if path.endswith(".jsonl") else text)
        except ValueError:
            continue
        if isinstance(payload, dict):
            seeded += _seed_from_bench_record(payload)
    logger.debug("autotune: seeded %d record(s) from bench history", seeded)
    return seeded


def _seed_from_bench_record(payload: Mapping[str, Any]) -> int:
    plat = payload.get("platform")
    if plat != "cuda":
        return 0  # a TPU sweep or a CPU run says nothing of the card
    workload = payload.get("workload") or {}
    ntime = int(workload.get("ntime", 26304))
    nspace = int(workload.get("nlat", 181)) * int(workload.get("nlon", 360))
    ngroups = int(workload.get("ngroups", 12))
    nelems = ntime * nspace
    count = 0

    def put(family: str, cand: Any, gbps: Any, g: int, e: int) -> None:
        nonlocal count
        if isinstance(gbps, (int, float)) and gbps > 0:
            record(family, _CANDIDATE_NAMES.get(str(cand), str(cand)), float(gbps),
                   dtype="float32", ngroups=g, nelems=e, platform=plat, source="seed")
            count += 1

    for field_, family in (("impl_sweep_gbps", "segment_sum"), ("quantile_gbps", "quantile")):
        sweep = payload.get(field_)
        if isinstance(sweep, Mapping):
            for impl, gbps in sweep.items():
                put(family, impl, gbps, ngroups, nelems)
    highcard = payload.get("highcard")
    if isinstance(highcard, Mapping):
        hc_ngroups, hc_nelems = highcard.get("ngroups"), highcard.get("nelems")
        if isinstance(hc_ngroups, int) and isinstance(hc_nelems, int):
            for cand in ("dense", "sort"):
                put("highcard", cand, highcard.get(f"{cand}_gbps"), hc_ngroups, hc_nelems)
    fused = payload.get("fused")
    if isinstance(fused, Mapping):
        sweep_f = fused.get("fused_sweep_gbps")
        fused_nelems = fused.get("nelems")
        if not isinstance(fused_nelems, int) or fused_nelems <= 0:
            fused_nelems = nelems
        if isinstance(sweep_f, Mapping):
            for cand, gbps in sweep_f.items():
                put("fused", cand, gbps, ngroups, fused_nelems)
    return count


# ---------------------------------------------------------------------------
# in-call micro-sweeps
# ---------------------------------------------------------------------------


def _sweep_allowed() -> bool:
    with _LOCK:
        return (enabled() and not _AUTOTUNE_STATE.get("in_sweep")
                and _AUTOTUNE_STATE.get("sweeps", 0) < _SWEEP_BUDGET)


def _needs_sweep(family: str, dtype: Any, ngroups: int, nelems: int, platform: str) -> bool:
    """Whether the key still wants its sweep; marks it attempted, under the
    lock, so concurrent callers on one key sweep it once."""
    _ensure_loaded()
    key = make_key(family, dtype=dtype, ngroups=ngroups, nelems=nelems, platform=platform)
    with _LOCK:
        if key in _AUTOTUNE_CACHE:
            return False
        if lookup(family, dtype=dtype, ngroups=ngroups, nelems=nelems,
                  platform=platform) is not None:
            return False
        attempted = _AUTOTUNE_STATE.setdefault("attempted", set())
        if key in attempted:
            return False
        attempted.add(key)
        return True


def _time_call(fn: Callable[[], Any], device: Any, reps: int = 2) -> float:
    """Best-of-``reps`` seconds of ``fn()`` after one warm call (which absorbs
    a first kernel build and the library load); on a CUDA device every call
    ends in ``torch.cuda.synchronize()``, so the time is the work's, not the
    launch's."""
    import torch

    cuda = torch.device(device).type == "cuda"

    def call() -> None:
        fn()
        if cuda:
            torch.cuda.synchronize(device)

    call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def _sweep(family: str, candidates: Iterable[str],
           runner: Callable[[str], Callable[[], Any] | None], nbytes: int, *, dtype: Any,
           ngroups: int, nelems: int, device: Any) -> None:
    """Time each candidate's runner on the swept workload and record GB/s
    (the swept array's bytes over the best time). A runner of ``None`` (its
    guards reroute the candidate) is skipped; an exception propagates."""
    from . import telemetry

    with _LOCK:
        _AUTOTUNE_STATE["in_sweep"] = True
        _AUTOTUNE_STATE["sweeps"] = _AUTOTUNE_STATE.get("sweeps", 0) + 1
    telemetry.count("autotune.sweeps")
    plat = platform_of(device)
    try:
        for cand in candidates:
            fn = runner(cand)
            if fn is None:
                continue
            seconds = _time_call(fn, device)
            if seconds > 0:
                record(family, cand, nbytes / seconds / 1e9, dtype=dtype, ngroups=ngroups,
                       nelems=nelems, platform=plat, source="sweep")
    finally:
        with _LOCK:
            _AUTOTUNE_STATE["in_sweep"] = False


def _normal(shape: tuple, dtype: str, device: Any, rng: Any):
    """Seeded normal data of ``dtype`` on ``device`` (bfloat16 through
    float32: numpy has no bfloat16)."""
    import numpy as np
    import torch

    host = rng.normal(size=shape).astype(np.float32 if dtype == "bfloat16" else dtype)
    return torch.from_numpy(host).to(device=device, dtype=getattr(torch, dtype))


def _sweep_segment_sum(dtype: str, ngroups: int, nelems: int, device: Any) -> None:
    import numpy as np
    import torch

    from .kernels import _segment_sum_impl, _tuned_sum_candidates, generic_kernel
    from .options import scoped

    n = max(_SWEEP_ROWS, min(_SWEEP_N_MAX, nelems or _SWEEP_N_MAX))
    size = max(1, min(int(ngroups) or 1, n))
    data = _normal((_SWEEP_ROWS, n), dtype, device, np.random.default_rng(0))
    codes = (torch.arange(n, dtype=torch.int32, device=data.device) % size).to(torch.int32)

    passes = {}
    for impl in ("kernel", "radixbin"):
        with scoped(segment_sum_impl=impl):
            passes[impl] = _segment_sum_impl(data, size) == impl
    candidates = _tuned_sum_candidates(data.device.type, passes["kernel"], passes["radixbin"])

    def runner(impl: str) -> Callable[[], Any] | None:
        with scoped(segment_sum_impl=impl):
            if _segment_sum_impl(data, size) != impl:
                return None  # the guards reroute: timing would mislabel scatter

        def run() -> Any:
            with scoped(segment_sum_impl=impl):
                return generic_kernel("nansum", codes, data, size=size)

        return run

    _sweep("segment_sum", candidates, runner, data.numel() * data.element_size(), dtype=dtype,
           ngroups=ngroups, nelems=nelems, device=device)


def _sweep_quantile(dtype: str, ngroups: int, nelems: int, device: Any) -> None:
    import numpy as np
    import torch

    from .kernels import generic_kernel
    from .options import scoped

    n = max(_SWEEP_ROWS, min(_SWEEP_N_MAX, nelems or _SWEEP_N_MAX))
    size = max(1, min(int(ngroups) or 1, n))
    data = _normal((_SWEEP_ROWS, n), dtype, device, np.random.default_rng(0))
    codes = (torch.arange(n, dtype=torch.int32, device=data.device) % size).to(torch.int32)

    def runner(impl: str) -> Callable[[], Any]:
        def run() -> Any:
            with scoped(quantile_impl=impl):
                return generic_kernel("nanquantile", codes, data, size=size, q=0.5)

        return run

    _sweep("quantile", ("sort", "select"), runner, data.numel() * data.element_size(),
           dtype=dtype, ngroups=ngroups, nelems=nelems, device=device)


def _sweep_engine(dtype: str, nelems: int) -> None:
    """Host data on the CPU: the numpy engine against the torch engine."""
    import numpy as np

    from .aggregations import generic_aggregate

    n = max(16, min(_SWEEP_ENGINE_N_MAX, nelems or _SWEEP_ENGINE_N_MAX))
    data = np.random.default_rng(0).normal(size=n).astype(dtype, copy=False)
    size = 16
    codes = np.arange(n, dtype=np.int64) % size

    def runner(engine: str) -> Callable[[], Any]:
        def run() -> Any:
            import torch

            c, v = torch.from_numpy(codes), torch.from_numpy(data)
            return generic_aggregate(c, v, engine=engine, func="nansum", size=size,
                                     fill_value=0)

        return run

    # recorded under the size timed: the workload is capped
    _sweep("engine", ("numpy", "torch"), runner, data.nbytes, dtype=dtype, ngroups=0,
           nelems=n, device="cpu")


def _sweep_highcard(dtype: str, ngroups: int, n_present: int, nelems: int,
                    device: Any) -> None:
    """The dense engine against the sort engine, both on ``device``, on the
    caller's universe and present density (both capped)."""
    import numpy as np
    import torch

    from .aggregations import generic_aggregate

    n = max(16, min(_SWEEP_HIGHCARD_N_MAX, nelems or _SWEEP_HIGHCARD_N_MAX))
    size = max(2, min(int(ngroups) or 2, _SWEEP_HIGHCARD_SIZE_MAX))
    frac = min(1.0, max(1, int(n_present)) / max(1, int(ngroups)))
    p = max(1, min(int(frac * size), size, n))
    rng = np.random.default_rng(0)
    data = _normal((n,), dtype, device, rng)
    present_ids = rng.choice(size, p, replace=False).astype(np.int64)
    codes = torch.from_numpy(present_ids[rng.integers(0, p, n)]).to(data.device)

    def runner(engine: str) -> Callable[[], Any]:
        eng = "torch" if engine == "dense" else "sort"

        def run() -> Any:
            return generic_aggregate(codes, data, engine=eng, func="nansum", size=size,
                                     fill_value=0)

        return run

    # recorded under the universe and elements timed (size, n)
    _sweep("highcard", ("dense", "sort"), runner, data.numel() * data.element_size(),
           dtype=dtype, ngroups=size, nelems=n, device=device)


def prime_highcard(dtype: Any, ngroups: int, n_present: int, nelems: int,
                   device: Any) -> None:
    """One budgeted dense-or-sort sweep per banded key, before the routing
    decision that consults it. A no-op unless the tuner is on."""
    if not _sweep_allowed():
        return
    dt = dtype_name(dtype)
    if dt not in ("float32", "float64"):
        return
    swept_size = max(2, min(int(ngroups) or 2, _SWEEP_HIGHCARD_SIZE_MAX))
    swept_n = max(16, min(_SWEEP_HIGHCARD_N_MAX, nelems or _SWEEP_HIGHCARD_N_MAX))
    tolerance = _NEAREST_TOLERANCE.get("highcard", _NEAREST_TOLERANCE_DEFAULT)
    if (abs(_gband(ngroups) - _gband(swept_size)) > tolerance
            or abs(_eband(nelems) - _eband(swept_n)) > tolerance):
        return  # the capped sweep could not serve this band
    if _needs_sweep("highcard", dt, swept_size, swept_n, platform_of(device)):
        _sweep_highcard(dt, ngroups, n_present, nelems, device)


#: reductions whose kernels ride the segment sum: a segment_sum sweep
#: informs them
_ADDITIVE_FAMILIES = frozenset(
    {"sum", "nansum", "mean", "nanmean", "var", "nanvar", "std", "nanstd",
     "count", "len", "nanlen", "any", "all"}
)
_QUANTILE_FAMILIES = frozenset(
    {"quantile", "nanquantile", "median", "nanmedian", "mode", "nanmode"}
)


def prime_reduce(func_name: str, dtype: Any, ngroups: int, nelems: int, device: Any) -> None:
    """Before a reduction on ``device``: the sweeps its decisions will
    consult, once per banded key and within the sweep budget. A no-op unless
    the tuner is on."""
    if not _sweep_allowed():
        return
    dt = dtype_name(dtype)
    if dt not in ("float32", "float64", "bfloat16"):
        return
    plat = platform_of(device)
    if func_name in _ADDITIVE_FAMILIES:
        if _needs_sweep("segment_sum", dt, ngroups, nelems, plat):
            _sweep_segment_sum(dt, ngroups, nelems, device)
    if func_name in _QUANTILE_FAMILIES and _sweep_allowed():
        if _needs_sweep("quantile", dt, ngroups, nelems, plat):
            _sweep_quantile(dt, ngroups, nelems, device)


def prime_engine(dtype: Any, nelems: int) -> None:
    """Before the engine choice of host data reduced on the CPU: the
    numpy-or-torch sweep, where the capped sweep can serve the band."""
    if not _sweep_allowed():
        return
    dt = dtype_name(dtype)
    if dt not in ("float32", "float64"):
        return
    swept = max(16, min(_SWEEP_ENGINE_N_MAX, nelems or _SWEEP_ENGINE_N_MAX))
    tolerance = _NEAREST_TOLERANCE.get("engine", _NEAREST_TOLERANCE_DEFAULT)
    if abs(_eband(nelems or swept) - _eband(swept)) > tolerance:
        return
    if _needs_sweep("engine", dt, 0, nelems, "cpu"):
        _sweep_engine(dt, nelems)


# ---------------------------------------------------------------------------
# streaming observations + decisions
# ---------------------------------------------------------------------------


def _bytes_band_candidate(nbytes: int) -> str:
    """Slab sizes are recorded as power-of-two byte candidates ("2^28")."""
    return f"2^{max(0, int(nbytes).bit_length() - 1)}"


def observe_stream(report: Any, *, nbytes: int, nelems: int = 0,
                   platform: str | None = None) -> None:
    """Fold one finished stream pass into the store: its GB/s under its
    prefetch depth and under its slab-bytes band. Runs in every mode."""
    wall_s = float(report.wall_ms) / 1e3
    if wall_s <= 0 or nbytes <= 0 or not report.slabs:
        return
    gbps = nbytes / wall_s / 1e9
    record("stream_prefetch", str(int(report.prefetch)), gbps, nelems=nelems,
           platform=platform, source="stream")
    slab0 = report.slabs[0]
    span = sum(int(s.stop) - int(s.start) for s in report.slabs)
    slab_bytes = int(nbytes * (slab0.stop - slab0.start) / max(1, span))
    record("stream_slab", _bytes_band_candidate(slab_bytes), gbps, nelems=nelems,
           platform=platform, source="stream")
    from . import telemetry

    if telemetry.enabled():
        telemetry.METRICS.observe("stream.overlap_fraction", report.overlap_fraction)


def pick_stream_prefetch(default_depth: int, *, nelems: int = 0,
                         platform: str | None = None) -> int:
    """The observed-best prefetch depth for the band (tuner on, record
    known), else ``default_depth``. Depth changes when staging happens, never
    the staged bytes."""
    choice = decide("stream_prefetch", str(int(default_depth)),
                    [str(d) for d in (0, 1, 2, 4, 8, 16, 32, 64)], nelems=nelems,
                    platform=platform)
    try:
        return int(choice)
    except ValueError:
        return int(default_depth)


def pick_stream_batch_bytes(default_bytes: int, *, nelems: int = 0,
                            platform: str | None = None) -> int:
    """The observed-best slab byte budget for the band, else the default."""
    fallback = _bytes_band_candidate(default_bytes)
    choice = decide("stream_slab", fallback, [f"2^{p}" for p in range(16, 34)], nelems=nelems,
                    platform=platform)
    try:
        power = int(choice.split("^")[1])
    except (IndexError, ValueError):
        return int(default_bytes)
    return 2**power if choice != fallback else int(default_bytes)


# ---------------------------------------------------------------------------
# regression sentinel
# ---------------------------------------------------------------------------


def _history_rounds(history_path: str) -> list[dict]:
    try:
        with open(history_path) as f:
            lines = [line for line in f.read().splitlines() if line.strip()]
    except OSError:
        return []
    rounds = []
    for line in lines:
        try:
            payload = json.loads(line)
        except ValueError:
            continue
        if isinstance(payload, dict):
            rounds.append(payload)
    return rounds


def _last_history_round(history_path: str, *, platform: str | None = None,
                        workload: Mapping[str, Any] | None = None,
                        skip_rounds: int = 0) -> dict | None:
    """The newest round, of ``platform`` and ``workload`` when given,
    skipping the newest ``skip_rounds`` entries."""
    rounds = _history_rounds(history_path)
    if skip_rounds:
        rounds = rounds[:-skip_rounds] if len(rounds) > skip_rounds else []
    for payload in reversed(rounds):
        if platform is not None and payload.get("platform") != platform:
            continue
        if workload is not None and payload.get("workload") != dict(workload):
            continue
        return payload
    return None


def _history_families(payload: Mapping[str, Any]) -> dict[str, float]:
    """One bench round as per-family GB/s."""
    out: dict[str, float] = {}
    value = payload.get("value")
    if isinstance(value, (int, float)) and value > 0:
        out["headline"] = float(value)
    for field_, prefix in (("impl_sweep_gbps", "segment_sum"), ("quantile_gbps", "quantile")):
        sweep = payload.get(field_)
        if isinstance(sweep, Mapping):
            for impl, gbps in sweep.items():
                if isinstance(gbps, (int, float)) and gbps > 0:
                    out[f"{prefix}[{impl}]"] = float(gbps)
    streaming = payload.get("streaming")
    if isinstance(streaming, Mapping):
        for name in ("gbps_sync", "gbps_prefetch"):
            gbps = streaming.get(name)
            if isinstance(gbps, (int, float)) and gbps > 0:
                out[f"streaming[{name.split('_', 1)[1]}]"] = float(gbps)
    return out


def compare_families(current: Mapping[str, float], previous: Mapping[str, float], *,
                     threshold: float = _REGRESSION_THRESHOLD) -> tuple[dict[str, dict], list[str]]:
    """Per-family current-against-previous rows, and the names that dropped
    below ``(1 - threshold) x previous``."""
    families: dict[str, dict] = {}
    regressed: list[str] = []
    for name, gbps in sorted(current.items()):
        if not (isinstance(gbps, (int, float)) and gbps > 0):
            continue
        prev = previous.get(name)
        row: dict[str, Any] = {"current": round(float(gbps), 3)}
        if isinstance(prev, (int, float)) and prev > 0:
            row["previous"] = round(float(prev), 3)
            row["ratio"] = round(float(gbps) / prev, 3)
            row["regressed"] = float(gbps) < prev * (1.0 - threshold)
            if row["regressed"]:
                regressed.append(name)
        else:
            row["previous"] = None
            row["regressed"] = False
        families[name] = row
    return families, regressed


def regression_sentinel(current: Mapping[str, float], *, history_path: str | None = None,
                        threshold: float = _REGRESSION_THRESHOLD, platform: str | None = None,
                        workload: Mapping[str, Any] | None = None,
                        skip_rounds: int = 0) -> dict:
    """Diff a round's per-family GB/s against the last ``BENCH_HISTORY`` round
    of the same platform (and workload, when given): report-only. With no
    round of the platform, every family has ``previous: None`` and
    ``compared_against`` is None, never another platform's baseline."""
    plat = platform_of() if platform is None else platform
    history_path = (os.path.join(_repo_root(), "BENCH_HISTORY", "bench_runs.jsonl")
                    if history_path is None else history_path)
    prev_round = _last_history_round(history_path, platform=plat, workload=workload,
                                     skip_rounds=skip_rounds)
    previous = {} if prev_round is None else _history_families(prev_round)
    families, regressed = compare_families(current, previous, threshold=threshold)
    return {
        "status": "regression" if regressed else "ok",
        "platform": plat,
        "threshold": threshold,
        "compared_against": history_path if previous else None,
        "regressed": regressed,
        "families": families,
    }


# ---------------------------------------------------------------------------
# CLI: python -m flox_tpu_torch.autotune {report, sentinel}
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m flox_tpu_torch.autotune",
        description="Inspect the autotune store / run the regression sentinel.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    rep = sub.add_parser("report", help="print the store's winners and counters")
    rep.add_argument("--path", default=None, help="store file (default: the configured path)")
    sen = sub.add_parser("sentinel",
                         help="diff per-family GB/s against the last bench round (report-only)")
    sen.add_argument("--current", default=None,
                     help="JSON object of {family: gbps}; default: the last round itself")
    sen.add_argument("--history", default=None, help="bench_runs.jsonl path")
    sen.add_argument("--platform", default=None, help="platform tag to compare within")
    args = parser.parse_args(argv)

    if args.command == "report":
        if args.path:
            load(args.path)
        print(json.dumps(decision_record(), indent=1))
        return 0

    history = args.history or os.path.join(_repo_root(), "BENCH_HISTORY", "bench_runs.jsonl")
    skip_rounds = 0
    plat = args.platform
    workload = None
    if args.current:
        try:
            current = json.loads(args.current)
        except ValueError as exc:
            parser.error(f"--current is not valid JSON: {exc}")
    else:
        latest = _last_history_round(history)
        if latest is None:
            parser.error(f"no readable rounds in {history}")
        current = _history_families(latest)
        plat = plat or latest.get("platform")
        workload = latest.get("workload")
        skip_rounds = 1
    verdict = regression_sentinel(current, history_path=history, platform=plat,
                                  workload=workload, skip_rounds=skip_rounds)
    print(json.dumps(verdict, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
