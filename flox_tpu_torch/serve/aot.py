"""The warmup manifest: restart warm (the port of ``flox_tpu/serve/aot.py``).

A serving replica's worst request is its first: absent warmup, the first
request for each kernel builds its library with ``nvcc`` and loads it, and
allocates its working memory, exactly when the replica joins the fleet. The
reference removes that stall with JAX's persistent compilation cache plus a
warmup manifest. The port compiles no programs, so it keeps the manifest
only, rooted at ``OPTIONS["serve_aot_dir"]``:

* :func:`configure` makes sure that the kernel libraries are built into
  ``flox_tpu_torch/_build/`` (the build directory is the port's persistent
  cache) and loaded, on a CUDA device: every library of ``_build.SOURCES``,
  which covers every kernel a manifest spec can reach. Against a warm build
  directory that is a load, with zero ``nvcc`` builds.
* **warmup manifest** — every dispatch records its request spec
  (:func:`record_reduce`: func, shapes, dtypes, group count, option
  overlay) into ``manifest.json`` in the directory, and :func:`warmup`
  replays the specs against synthetic payloads on the device at startup,
  so the first real request finds its kernels loaded and its routes
  exercised.

The in-memory manifest memo (:data:`_MANIFEST_MEMO`) is registered in
``cache.clear_all`` / ``cache.stats``. Saving is atomic merge-on-save (tmp +
rename): replicas sharing one directory union their manifests instead of
clobbering each other. The manifest's format is the reference's.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from .. import _build, options, telemetry, utils

logger = logging.getLogger(__name__)

__all__ = ["configure", "deconfigure", "record_reduce", "save_manifest", "warmup"]

_MANIFEST_VERSION = 1
_MANIFEST_NAME = "manifest.json"

#: warmup manifest memo: spec digest -> replayable request spec. Mirrors
#: the on-disk manifest (union of every load + this process's dispatches);
#: registered in cache.clear_all — a clear resets to "never loaded", and the
#: next record/warmup re-reads the disk state.
_MANIFEST_MEMO: dict[str, dict] = {}

#: the directory configured last, and whether the kernel libraries are
#: loaded in this process (configuring the same directory again is a no-op)
_STATE: dict[str, Any] = {"configured": None, "loaded": False}
_LOCK = threading.Lock()
_SAVE_LOCK = threading.Lock()


def _aot_dir(path: Any = None) -> Path | None:
    root = path if path is not None else options.OPTIONS["serve_aot_dir"]
    return Path(root) if root else None


def configure(path: Any = None, device: Any = None) -> Path | None:
    """Make the warmup directory and, on a CUDA ``device``, build what is
    missing of the kernel libraries and load them all.

    ``path`` defaults to ``OPTIONS["serve_aot_dir"]``; ``None`` there means
    persistence is off and this is a no-op returning ``None``. Idempotent;
    the dispatcher calls it before every dispatch. A failed build raises:
    serving without the kernels would answer nothing on the card."""
    root = _aot_dir(path)
    if root is None:
        return None
    with _LOCK:
        if _STATE["configured"] != str(root):
            root.mkdir(parents=True, exist_ok=True)
            if _STATE["configured"] is not None:
                logger.info("warmup dir moved %s -> %s", _STATE["configured"], root)
            _STATE["configured"] = str(root)
        need_libs = not _STATE["loaded"]
    if need_libs and device is not None and utils.resolve_device(device).type == "cuda":
        _build.load_all()
        _STATE["loaded"] = True
    return root


def deconfigure() -> None:
    """Forget the configured directory (tests switch directories between
    cases). The manifest memo is untouched — ``cache.clear_all`` owns it;
    loaded kernel libraries stay loaded."""
    with _LOCK:
        _STATE["configured"] = None


def _jsonable(value: Any) -> Any:
    """``value`` rendered JSON-serializable, or raise TypeError: ndarrays
    become lists, numpy scalars become items — anything else non-JSON
    (callables, custom Aggregations) disqualifies the spec from the
    manifest (it cannot be replayed from text)."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, type):  # dtype classes like np.float64
        return np.dtype(value).name
    raise TypeError(f"not manifest-serializable: {value!r}")


def record_reduce(
    *,
    func: Any,
    shape: tuple,
    dtype: str,
    by_shape: tuple,
    by_dtype: str,
    ngroups: int,
    agg_kwargs: dict,
    options: dict,
    dataset: str | None = None,
) -> bool:
    """Record one served program's request spec into the warmup manifest.

    Called by the dispatcher after every device dispatch. Returns whether
    the spec was recorded: ``False`` when persistence is off, when the spec
    cannot be replayed from JSON (custom Aggregation objects, callable
    kwargs), or when it is already in the manifest. A *new* spec persists
    the manifest immediately (merge-on-save), so a replica killed mid-run
    still leaves every program it served warmable.

    ``dataset`` stamps registry-referenced dispatches for the operator
    reading the manifest; it is EXCLUDED from the spec digest — program
    identity is shapes/dtypes/ngroups, never residency, so the inline
    warmup replay warms the very program a registry hit runs.
    """
    multi = isinstance(func, (tuple, list)) and all(
        isinstance(f, str) for f in func
    )
    if _aot_dir() is None or not (isinstance(func, str) or multi):
        return False
    try:
        spec = _jsonable(
            {
                "func": list(func) if multi else func,
                "shape": list(shape),
                "dtype": str(dtype),
                "by_shape": list(by_shape),
                "by_dtype": str(by_dtype),
                "ngroups": int(ngroups),
                "agg_kwargs": {k: v for k, v in agg_kwargs.items() if v is not None},
                "options": options,
            }
        )
    except TypeError:
        return False
    digest = spec_digest(spec)
    if dataset is not None:
        # informational only (excluded from the digest above): the replay
        # path ignores it, dedup stays residency-blind
        spec = {**spec, "dataset": str(dataset)}
    with _LOCK:
        if digest in _MANIFEST_MEMO:
            return False
        _MANIFEST_MEMO[digest] = spec
    telemetry.count("serve.aot_recorded")
    save_manifest()
    return True


def spec_digest(spec: dict) -> str:
    """Stable identity of a manifest spec (canonical-JSON blake2b)."""
    import hashlib

    payload = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()


def _manifest_path(path: Any = None) -> Path | None:
    root = _aot_dir(path)
    return root / _MANIFEST_NAME if root is not None else None


def _load_into_memo(path: Any = None) -> None:
    """Union the on-disk manifest into the memo (corrupt/alien files warn
    and are ignored — a broken manifest must never take serving down)."""
    mpath = _manifest_path(path)
    if mpath is None or not mpath.exists():
        return
    try:
        payload = json.loads(mpath.read_text())
        if payload.get("version") != _MANIFEST_VERSION:
            raise ValueError(f"manifest version {payload.get('version')!r}")
        entries = payload["programs"]
        assert isinstance(entries, dict)
    except Exception as exc:  # noqa: BLE001 — fall back to what we have
        telemetry.record_serve_error(exc, what="aot.load-manifest")
        logger.warning("ignoring unreadable AOT manifest %s: %s", mpath, exc)
        return
    with _LOCK:
        for digest, spec in entries.items():
            _MANIFEST_MEMO.setdefault(digest, spec)


def save_manifest(path: Any = None) -> Path | None:
    """Persist the manifest memo, merged with whatever is on disk.

    Atomic tmp+rename so readers never see a torn file; merge-on-save so
    two replicas sharing the dir union their programs. The dispatcher's
    worker threads save concurrently: one save at a time in a process, each
    through a temporary named by process and thread. Returns the path
    written, or ``None`` when persistence is off."""
    mpath = _manifest_path(path)
    if mpath is None:
        return None
    with _SAVE_LOCK:
        _load_into_memo(path)
        with _LOCK:
            payload = {"version": _MANIFEST_VERSION, "programs": dict(_MANIFEST_MEMO)}
        mpath.parent.mkdir(parents=True, exist_ok=True)
        tmp = mpath.with_name(f"{mpath.name}.tmp.{os.getpid()}.{threading.get_ident()}")
        tmp.write_text(json.dumps(payload, sort_keys=True, indent=1))
        tmp.replace(mpath)
    return mpath


def _synthesize(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """Payload + labels with the spec's program identity.

    Program identity is shapes/dtypes/group-count, never data: zeros for
    the payload, and labels cycling through exactly ``ngroups`` distinct
    values so factorization finds the recorded group count (which fixes the
    output shape and the kernels' route)."""
    arr = np.zeros(tuple(spec["shape"]), dtype=np.dtype(spec["dtype"]))
    nby = int(np.prod(spec["by_shape"])) if spec["by_shape"] else 1
    ngroups = max(1, int(spec["ngroups"]))
    labels = np.arange(nby) % ngroups
    try:
        labels = labels.astype(spec["by_dtype"])
    except (TypeError, ValueError):
        pass  # exotic label dtype: int labels trace the same program
    return arr, labels.reshape(tuple(spec["by_shape"]))


def warmup(path: Any = None, device: Any = None) -> int:
    """Replay every manifest spec on ``device`` (CUDA unless the caller
    names the CPU), so the first real request finds its kernels built,
    loaded and exercised.

    Configures the directory (building what is missing of the kernel
    libraries, loading them), loads the manifest, and runs each recorded
    spec against synthetic payloads under its recorded option scope. Against
    a warm build directory no ``nvcc`` build runs (``_build.BUILDS`` stays
    where it was). Returns the number of specs warmed; a spec that fails to
    replay is logged and skipped — warmup must never take serving down.
    """
    dev = utils.resolve_device(device)
    if configure(path, device=dev) is None:
        return 0
    with telemetry.span("serve.warmup"):
        _load_into_memo(path)
        with _LOCK:
            specs = list(_MANIFEST_MEMO.values())
        from ..core import groupby_reduce

        tm_on = telemetry.enabled()
        builds0 = _build.BUILDS["count"]
        build_s0 = _build.BUILDS["seconds"]
        if tm_on:
            # cost-card bookkeeping inside the replays is netted out of the
            # warmup row's wall
            analysis0 = telemetry.METRICS.get("costmodel.card_analysis_ms")
            t_warm0 = time.perf_counter()
        warmed = 0
        from ..costmodel import serve_alias

        for spec in specs:
            try:
                arr, labels = _synthesize(spec)
                kwargs = dict(spec.get("agg_kwargs") or {})
                with serve_alias("serve.warmup"), options.scoped(
                    **(spec.get("options") or {})
                ):
                    if isinstance(spec["func"], list):
                        from ..fusion import groupby_aggregate_many

                        groupby_aggregate_many(
                            arr, labels, funcs=tuple(spec["func"]), device=dev, **kwargs
                        )
                    else:
                        groupby_reduce(arr, labels, func=spec["func"], device=dev, **kwargs)
                warmed += 1
            # not a retry loop: specs are independent, and a bad one must be
            # skipped (warmup can never take serving down)
            except Exception as exc:  # noqa: BLE001
                telemetry.record_serve_error(exc, what="aot.warmup-spec")
                logger.warning("warmup skipped %s: %s", spec.get("func"), exc)
        telemetry.count("serve.aot_warmed", warmed)
        telemetry.sample_hbm(program="serve.warmup")
        if tm_on:
            # warmup's ledger row: the replica's startup cost in one place
            # (a warm build directory reads compiles == 0 here)
            telemetry.observe_cost(
                "serve.warmup",
                dispatches=warmed,
                device_ms=max(
                    0.0,
                    (time.perf_counter() - t_warm0) * 1e3
                    - (telemetry.METRICS.get("costmodel.card_analysis_ms") - analysis0),
                ),
                compiles=int(_build.BUILDS["count"] - builds0),
                compile_ms=(_build.BUILDS["seconds"] - build_s0) * 1e3,
            )
    return warmed
