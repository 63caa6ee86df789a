"""Global options of the port (counterpart of ``flox_tpu/options.py``).

The knobs of the eager reduction path and of streaming are here. Of the
reference's eight ``stream_*`` knobs, ``stream_donate`` is accepted and
validated but has no effect: nothing is traced, so there is no buffer
donation, and the streaming carry is updated in place always. The names of the
engine, accumulation, group-cap and ceiling knobs are the reference's, so
that one option set can drive both packages (:func:`from_reference`).

The observability knobs (``telemetry*``, ``flight_recorder_*``,
``profile_*``, ``metrics_sample_interval``, ``replica_id``, ``costmodel*``)
take their defaults from the reference's ``FLOX_TPU_*`` environment names; a
malformed or out-of-range value falls back to the default. So do the durable
store's (``store_*``), the serving plane's (``serve_*``, ``registry_*``),
the metrics endpoint's (``metrics_port``), the autotuner's (``autotune*``),
the SLO plane's (``slo_*``) and the fleet federator's (``fleet_*``).

``OPTIONS`` reads through a contextvar overlay: :class:`scoped` installs
option values visible only to the current context (an asyncio task, or a
worker thread that ``asyncio.to_thread`` started with a copy of it), so the
serving dispatcher runs concurrent requests with different knobs without
racing on the process-wide dict. :class:`set_options` writes the process-wide
values, as before.
"""

from __future__ import annotations

import contextvars
import math
import os
import re
from typing import Any

__all__ = [
    "OPTIONS",
    "VALID_ACCUMS",
    "explicitly_set",
    "from_reference",
    "scope_overrides",
    "scoped",
    "set_options",
    "trace_fingerprint",
]

#: cross-chunk accumulation disciplines of the segment-sum kernel
VALID_ACCUMS = ("plain", "kahan", "dd")

#: characters a replica id may carry (it becomes a metric label value)
_REPLICA_ID_OK = re.compile(r"^[A-Za-z0-9_.:\-]{1,64}$")


def _env_int(name: str, default: int, lo: int = 0, hi: int | None = None) -> int:
    try:
        value = int(os.environ.get(name, default))
    except ValueError:
        return default
    return default if value < lo or (hi is not None and value > hi) else value


def _env_float(name: str, default: float, lo: float = 0.0, hi: float | None = None,
               lo_open: bool = False) -> float:
    try:
        value = float(os.environ.get(name, default))
    except ValueError:
        return default
    if (not math.isfinite(value) or value < lo or (lo_open and value == lo)
            or (hi is not None and value > hi)):
        return default
    return value


def _env_choice(name: str, default: str, valid: tuple[str, ...]) -> str:
    value = os.environ.get(name, default)
    return value if value in valid else default


def _env_replica(name: str) -> str | None:
    value = os.environ.get(name) or None
    return None if value is not None and _REPLICA_ID_OK.match(value) is None else value


#: the active overlay: ``(values, pinned names)`` installed by :class:`scoped`,
#: or ``None`` outside any scope
_SCOPE: contextvars.ContextVar[tuple[dict, frozenset] | None] = contextvars.ContextVar(
    "flox_tpu_torch_option_scope", default=None
)


class _ScopedOptions(dict):
    """The process-wide option dict, read through the innermost
    :class:`scoped` overlay. Writes (``set_options``, ``update``) reach the
    process-wide values: a scope is an overlay, never a copy."""

    __slots__ = ()

    def __getitem__(self, key: str) -> Any:
        scope = _SCOPE.get()
        if scope is not None and key in scope[0]:
            return scope[0][key]
        return dict.__getitem__(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        scope = _SCOPE.get()
        if scope is not None and key in scope[0]:
            return scope[0][key]
        return dict.get(self, key, default)


OPTIONS: dict[str, Any] = {
    # engine of a call that names none: "torch" (dense accumulators over the
    # label universe), "sort" (the present-groups engine: accumulators over
    # the groups actually present, for huge label universes) or "numpy" (the
    # host engine; the result is copied to the call's device)
    "default_engine": "torch",
    # label-universe size from which a call left to the dense engine weighs
    # the sort engine (density heuristic, ``core._route_highcard``)
    "sort_engine_min_groups": 1 << 16,
    # group-count ceiling of the one-hot GEMM segment sum (float data)
    "matmul_num_groups_max": 384,
    # segment-sum implementation of float data (the kernels take f32/bf16
    # data with N >= 8; other data and every other case take ``index_add_``):
    #   "auto"     - the segment-sum kernel up to ``pallas_num_groups_max``
    #                groups, the radix-binning kernel up to
    #                ``radixbin_num_groups_max``, then on a CUDA device the
    #                one-hot GEMM where its guard passes
    #                (``kernels._use_matmul_path``), else ``index_add_``
    #   "kernel"   - the segment-sum kernel up to its cap, else ``index_add_``
    #   "radixbin" - the radix-binning kernel up to its cap, else ``index_add_``
    #   "matmul"   - the one-hot GEMM where its guard passes, else
    #                ``index_add_``, on any device
    #   "scatter"  - ``index_add_``, an explicit request that is honoured
    "segment_sum_impl": "auto",
    # accumulation discipline of the segment-sum kernel:
    #   "plain" - an f32 running sum
    #   "kahan" - compensated summation (default)
    #   "dd"    - double-double (hi, lo) f32 pair with Dekker-split addends
    "pallas_accum": "kahan",
    # group-count ceiling of the segment-sum kernel: its accumulators sit in
    # shared memory, one set per row and group
    "pallas_num_groups_max": 512,
    # group-count ceiling of the radix-binning kernel: it splits the group
    # axis into 512-wide blocks, so the bound is output bytes, not memory
    "radixbin_num_groups_max": 1 << 14,
    # bytes of the one-hot GEMM's four (block, N) masks: its K axis runs in
    # blocks of this size, so that its temporaries stay bounded
    "matmul_block_bytes": 2**28,
    # device-byte ceiling of the dense (..., size) intermediates of one call:
    # above it a call left to the dense engine goes to the sort engine, and an
    # explicit dense request raises naming engine="sort"
    "dense_intermediate_bytes_max": 8 * 2**30,
    # segment-min/max implementation, the same three policies as above
    "segment_minmax_impl": "auto",
    # group-count ceiling of the segment-min/max kernel
    "pallas_minmax_num_groups_max": 128,
    # grouped cumsum/nancumsum: "auto" and "kernel" take the hand-written
    # segmented-cumsum kernel when its guards pass (f32/bf16 data, size + 1
    # <= ``pallas_scan_num_groups_max``, N >= 8); "segmented" is an explicit
    # request for the sort + log-depth segmented scan of torch ops
    "scan_impl": "auto",
    # group-count ceiling of the segmented-cumsum kernel, the missing-label
    # group included: its per-group carries sit in shared memory
    "pallas_scan_num_groups_max": 128,
    # grouped order statistics (quantile, median): "sort" is a lexicographic
    # (code, value) sort of each row; "select" is the sort-free radix
    # bisection, one counting segment-sum (the segment-sum kernel) per bit
    # of the data's width; "auto" resolves to "sort", as in the reference
    # with its measured dispatch off
    "quantile_impl": "auto",
    # streaming (``pipeline``, ``resilience``): how many slabs the staging
    # pool holds in flight, loaded into pinned host buffers and copied to the
    # card on a side stream while the card reduces the slab before; 0 stages
    # inline (the same bytes land either way). Depth > 1 loads concurrently,
    # so the loader must take concurrent (start, stop) calls
    "stream_prefetch": 2,
    # synchronize the carry every K dispatched slabs, so the host cannot run
    # far ahead of the card with staged slabs; 0 disables the throttle
    "stream_dispatch_depth": 8,
    # accepted for the reference's option set and validated, with no effect:
    # the port updates the carry in place always (nothing is traced, so
    # there is no buffer donation to turn on or off)
    "stream_donate": "auto",
    # extra attempts of a slab's load and staging after a transient failure
    # (``resilience.classify_error``); retries + 1 attempts in all
    "stream_retries": 2,
    # base backoff in seconds between attempts, doubled per attempt (full
    # jitter below that cap)
    "stream_backoff": 0.05,
    # per-slab deadline in seconds over all attempts and backoffs; 0: none
    "stream_slab_timeout": 0.0,
    # snapshot the carry to the host every K processed slabs, so that a
    # killed stream resumes bit for bit; 0 disables checkpointing
    "stream_checkpoint_every": 0,
    # spill target of the snapshots: a directory (one .npz per stream) or a
    # literal .npz path, for a resume in another process; None keeps them in
    # this process only
    "stream_checkpoint_path": None,
    # telemetry (``telemetry``): the span tracer, the metrics registry and the
    # cost ledger; off is a true no-op (no span objects, no CUDA events)
    "telemetry": bool(_env_int("FLOX_TPU_TELEMETRY", 0, 0, 1)),
    # "basic" records phase spans; "detailed" adds per-slab staging spans
    "telemetry_level": _env_choice("FLOX_TPU_TELEMETRY_LEVEL", "basic",
                                   ("basic", "detailed")),
    # stream finished records to this file: *.jsonl appends as spans finish,
    # any other path is written as one Chrome trace JSON at flush or exit;
    # None keeps them in the in-process buffer (telemetry.spans())
    "telemetry_export_path": os.environ.get("FLOX_TPU_TELEMETRY_EXPORT_PATH") or None,
    # dump target of the flight-recorder ring (on a fatal stream fault and
    # on SIGTERM/SIGUSR2 when installed); None disables dumping
    "flight_recorder_path": os.environ.get("FLOX_TPU_FLIGHT_RECORDER_PATH") or None,
    # records the flight-recorder ring retains
    "flight_recorder_size": _env_int("FLOX_TPU_FLIGHT_RECORDER_SIZE", 2048, 16, 1_000_000),
    # default root of profiling.trace() and of the on-demand captures, which
    # rotate inside it keeping ``profile_keep``; None: no default root
    "profile_dir": os.environ.get("FLOX_TPU_PROFILE_DIR") or None,
    "profile_keep": _env_int("FLOX_TPU_PROFILE_KEEP", 8, 1, 1024),
    # seconds between samples of the saturation gauges; 0 keeps the sampler off
    "metrics_sample_interval": _env_float("FLOX_TPU_METRICS_SAMPLE_INTERVAL", 0.0, 0.0,
                                          3600.0),
    # this replica's name in a multi-replica deployment, stamped on records
    "replica_id": _env_replica("FLOX_TPU_REPLICA_ID"),
    # cost cards (``costmodel``): with telemetry, every dispatch site records
    # the bytes and operations its hand kernels declare and a roofline
    # predicted_ms against the card's peak row
    "costmodel": bool(_env_int("FLOX_TPU_COSTMODEL", 0, 0, 1)),
    # observed/model ratio past which costmodel.drift_report flags a program
    "costmodel_drift_threshold": _env_float("FLOX_TPU_COSTMODEL_DRIFT_THRESHOLD", 10.0, 1.0,
                                            1e6),
    # dispatch-overhead floor (ms) of the drift model
    "costmodel_overhead_ms": _env_float("FLOX_TPU_COSTMODEL_OVERHEAD_MS", 25.0, 0.0, 60_000.0),
    # durable stores (``store``): the directory under which the serve loop's
    # store ops create and open stores, one subdirectory per name; None
    # turns the serve loop's store surface off
    "store_root": os.environ.get("FLOX_TPU_STORE_ROOT") or None,
    # compact a store once it holds more than this many live delta segments
    # after an append; 0 leaves compaction to the caller
    "store_compact_threshold": _env_int("FLOX_TPU_STORE_COMPACT_THRESHOLD", 0, 0),
    # "off" skips the fsyncs of journal and segment writes: for tests and
    # throwaway stores only (a power loss could then reorder commit points)
    "store_fsync": _env_choice("FLOX_TPU_STORE_FSYNC", "on", ("on", "off")),
    # serving (``serve``): requests pending in a dispatcher (queued and
    # executing) past which a submit is shed with LoadShedError; 0: no bound
    "serve_queue_depth": _env_int("FLOX_TPU_SERVE_QUEUE_DEPTH", 64, 0),
    # default per-request deadline in seconds from submit; 0: none
    "serve_deadline": _env_float("FLOX_TPU_SERVE_DEADLINE", 0.0),
    # requests stacked into one micro-batch dispatch; 1 turns batching off
    "serve_microbatch_max": _env_int("FLOX_TPU_SERVE_MICROBATCH_MAX", 8, 1, 1024),
    # seconds a new batch stays open for compatible requests to join
    "serve_batch_window": _env_float("FLOX_TPU_SERVE_BATCH_WINDOW", 0.002, 0.0, 60.0),
    # payloads above this many elements dispatch alone
    "serve_microbatch_max_elems": _env_int("FLOX_TPU_SERVE_MICROBATCH_MAX_ELEMS", 1 << 20, 0),
    # seconds a draining serve loop waits for in-flight requests
    "serve_drain_timeout": _env_float("FLOX_TPU_SERVE_DRAIN_TIMEOUT", 30.0),
    # seconds one dispatch may run before its waiters fail with
    # WatchdogTimeoutError; 0: no watchdog
    "serve_watchdog_timeout": _env_float("FLOX_TPU_SERVE_WATCHDOG_TIMEOUT", 0.0),
    # consecutive fatal failures of one program key that open its circuit
    # breaker; 0 turns breakers off
    "serve_breaker_threshold": _env_int("FLOX_TPU_SERVE_BREAKER_THRESHOLD", 5, 0, 10_000),
    # seconds an open breaker fast-fails before one half-open probe
    "serve_breaker_cooldown": _env_float("FLOX_TPU_SERVE_BREAKER_COOLDOWN", 30.0),
    # share of the card's memory the dataset registry may hold
    "registry_budget_fraction": _env_float("FLOX_TPU_REGISTRY_BUDGET_FRACTION", 0.5, 0.0,
                                           1.0, lo_open=True),
    # the registry's byte budget where the device reports no capacity (the
    # CPU); 0 turns the budget off
    "registry_budget_bytes": _env_int("FLOX_TPU_REGISTRY_BUDGET_BYTES", 1 << 30, 0),
    # datasets of at least this many bytes are sharded over the mesh's ranks
    # when there is more than one; 0: never
    "registry_shard_threshold_bytes": _env_int("FLOX_TPU_REGISTRY_SHARD_THRESHOLD_BYTES",
                                               1 << 30, 0),
    # the warmup manifest's directory (``serve.aot``); None turns it off
    "serve_aot_dir": os.environ.get("FLOX_TPU_SERVE_AOT_DIR") or None,
    # port of the /metrics, /healthz and /readyz endpoint (``exposition``);
    # 0 leaves it off
    "metrics_port": _env_int("FLOX_TPU_METRICS_PORT", 0, 0, 65535),
    # autotuner (``autotune``): when on, every "auto" choice (segment-sum
    # lowering, quantile sort or select, the highcard and fused families,
    # the engine of host data reduced on the CPU, streaming slab size and
    # prefetch depth) takes the winner the measurement store observed for
    # the nearest band, sweeping the candidates once per band on first use.
    # Off (the default) records observations and changes no dispatch
    "autotune": bool(_env_int("FLOX_TPU_AUTOTUNE", 0, 0, 1)),
    # the store's JSON file, loaded at first consult and saved at exit; None
    # keeps the store in this process
    "autotune_cache_path": os.environ.get("FLOX_TPU_AUTOTUNE_CACHE_PATH") or None,
    # fleet federation (``fleet``): seconds between the federator's scrape
    # rounds, the port it serves the merged view on (0: an ephemeral port),
    # and the default replica set ("name=http://host:port,..." or bare URLs)
    "fleet_scrape_interval": _env_float("FLOX_TPU_FLEET_SCRAPE_INTERVAL", 2.0, 0.05, 3600.0),
    "fleet_port": _env_int("FLOX_TPU_FLEET_PORT", 0, 0, 65535),
    "fleet_replicas": os.environ.get("FLOX_TPU_FLEET_REPLICAS") or None,
    # SLO plane (``slo``): the objective spec (JSON, or TOML for *.toml);
    # None takes the built-in objectives. An unreadable or invalid spec
    # raises at the surface that evaluates it
    "slo_path": os.environ.get("FLOX_TPU_SLO_PATH") or None,
    # seconds between canary cycles of ``python -m flox_tpu_torch.serve``;
    # 0 keeps the prober off
    "slo_canary_interval": _env_float("FLOX_TPU_SLO_CANARY_INTERVAL", 0.0, 0.0, 3600.0),
}

OPTIONS = _ScopedOptions(OPTIONS)

_IMPLS = ("auto", "scatter", "kernel")


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _is_finite_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


_VALIDATORS = {
    "default_engine": lambda x: x in ("torch", "sort", "numpy"),
    "sort_engine_min_groups": lambda x: _is_int(x) and x >= 1,
    "matmul_num_groups_max": lambda x: isinstance(x, int) and x >= 0,
    "segment_sum_impl": lambda x: x in (*_IMPLS, "radixbin", "matmul"),
    "pallas_accum": lambda x: x in VALID_ACCUMS,
    "pallas_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "radixbin_num_groups_max": lambda x: isinstance(x, int) and x >= 0,
    "matmul_block_bytes": lambda x: isinstance(x, int) and x >= 2**20,
    "dense_intermediate_bytes_max": lambda x: isinstance(x, int) and x >= 2**20,
    "segment_minmax_impl": lambda x: x in _IMPLS,
    "pallas_minmax_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "scan_impl": lambda x: x in ("auto", "segmented", "kernel"),
    "pallas_scan_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "quantile_impl": lambda x: x in ("auto", "sort", "select"),
    # streaming knobs are validated when set: a negative depth or retry count
    # raises here, not hours into a stream (bool is no int here)
    "stream_prefetch": lambda x: _is_int(x) and 0 <= x <= 64,
    "stream_dispatch_depth": lambda x: _is_int(x) and x >= 0,
    "stream_donate": lambda x: x in ("auto", "on", "off"),
    "stream_retries": lambda x: _is_int(x) and 0 <= x <= 1000,
    "stream_backoff": lambda x: _is_finite_num(x) and x >= 0,
    "stream_slab_timeout": lambda x: _is_finite_num(x) and x >= 0,
    "stream_checkpoint_every": lambda x: _is_int(x) and x >= 0,
    "stream_checkpoint_path": lambda x: x is None or (
        isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "telemetry": lambda x: isinstance(x, bool),
    "telemetry_level": lambda x: x in ("basic", "detailed"),
    "telemetry_export_path": lambda x: x is None or (
        isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "flight_recorder_path": lambda x: x is None or (
        isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "flight_recorder_size": lambda x: _is_int(x) and 16 <= x <= 1_000_000,
    "profile_dir": lambda x: x is None or (isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "profile_keep": lambda x: _is_int(x) and 1 <= x <= 1024,
    "metrics_sample_interval": lambda x: _is_finite_num(x) and 0 <= x <= 3600,
    "replica_id": lambda x: x is None or (
        isinstance(x, str) and _REPLICA_ID_OK.match(x) is not None),
    "costmodel": lambda x: isinstance(x, bool),
    "costmodel_drift_threshold": lambda x: _is_finite_num(x) and 1 <= x <= 1e6,
    "costmodel_overhead_ms": lambda x: _is_finite_num(x) and 0 <= x <= 60_000,
    "store_root": lambda x: x is None or (isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "store_compact_threshold": lambda x: _is_int(x) and x >= 0,
    "store_fsync": lambda x: x in ("on", "off"),
    "serve_queue_depth": lambda x: _is_int(x) and x >= 0,
    "serve_deadline": lambda x: _is_finite_num(x) and x >= 0,
    "serve_microbatch_max": lambda x: _is_int(x) and 1 <= x <= 1024,
    "serve_batch_window": lambda x: _is_finite_num(x) and 0 <= x <= 60,
    "serve_microbatch_max_elems": lambda x: _is_int(x) and x >= 0,
    "serve_drain_timeout": lambda x: _is_finite_num(x) and x >= 0,
    "serve_watchdog_timeout": lambda x: _is_finite_num(x) and x >= 0,
    "serve_breaker_threshold": lambda x: _is_int(x) and 0 <= x <= 10_000,
    "serve_breaker_cooldown": lambda x: _is_finite_num(x) and x >= 0,
    "registry_budget_fraction": lambda x: _is_finite_num(x) and 0 < x <= 1,
    "registry_budget_bytes": lambda x: _is_int(x) and x >= 0,
    "registry_shard_threshold_bytes": lambda x: _is_int(x) and x >= 0,
    "serve_aot_dir": lambda x: x is None or (isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "metrics_port": lambda x: _is_int(x) and 0 <= x <= 65535,
    "autotune": lambda x: isinstance(x, bool),
    "autotune_cache_path": lambda x: x is None or (
        isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "fleet_scrape_interval": lambda x: _is_finite_num(x) and 0.05 <= x <= 3600,
    "fleet_port": lambda x: _is_int(x) and 0 <= x <= 65535,
    "fleet_replicas": lambda x: x is None or (isinstance(x, str) and bool(x)),
    "slo_path": lambda x: x is None or (isinstance(x, (str, os.PathLike)) and bool(str(x))),
    "slo_canary_interval": lambda x: _is_finite_num(x) and 0 <= x <= 3600,
}


def trace_fingerprint() -> tuple:
    """The options that choose a call's kernels and lowering: a key of
    anything that holds work per lowering (the serving dispatcher's program
    keys) must include it, or a changed option would share a dispatch made
    under another. The autotuner's decision fingerprint is part of it: a
    record that flips a winner changes it while the tuner is on."""
    from .autotune import decision_fingerprint

    return (
        OPTIONS["segment_sum_impl"],
        OPTIONS["matmul_num_groups_max"],
        OPTIONS["pallas_num_groups_max"],
        OPTIONS["radixbin_num_groups_max"],
        OPTIONS["pallas_accum"],
        OPTIONS["matmul_block_bytes"],
        OPTIONS["segment_minmax_impl"],
        OPTIONS["pallas_minmax_num_groups_max"],
        OPTIONS["scan_impl"],
        OPTIONS["pallas_scan_num_groups_max"],
        OPTIONS["quantile_impl"],
        OPTIONS["stream_donate"],
        decision_fingerprint(),
    )


#: option names the user set: through ``set_options`` since import
_EXPLICIT_OPTIONS: set[str] = set()


def explicitly_set(name: str) -> bool:
    """Whether ``name`` was set by the user (``set_options``, or the innermost
    :class:`scoped` overlay while it is live) rather than riding its default."""
    scope = _SCOPE.get()
    if scope is not None and name in scope[1]:
        return True
    return name in _EXPLICIT_OPTIONS


def scope_overrides() -> dict:
    """The active :class:`scoped` overlay, innermost value winning; ``{}``
    outside any scope."""
    scope = _SCOPE.get()
    return dict(scope[0]) if scope is not None else {}


def _check(kwargs: dict) -> None:
    for k, v in kwargs.items():
        if k not in OPTIONS:
            raise ValueError(
                f"argument name {k!r} is not in the set of valid options {set(OPTIONS)!r}"
            )
        if not _VALIDATORS[k](v):
            raise ValueError(f"option {k!r} given an invalid value: {v!r}")


class scoped:
    """Option values visible only to the current context.

    >>> from flox_tpu_torch.options import OPTIONS, scoped
    >>> with scoped(default_engine="numpy"):
    ...     OPTIONS["default_engine"]
    'numpy'
    >>> OPTIONS["default_engine"]
    'torch'

    Unlike :class:`set_options`, which writes the process-wide dict, a scope
    is a contextvar overlay: asyncio tasks inherit a copy at creation,
    threads start without it (``asyncio.to_thread`` carries it over), and
    nested scopes merge with the innermost value winning. Values are
    validated at construction, as ``set_options`` validates them.
    """

    def __init__(self, **overrides: Any) -> None:
        _check(overrides)
        self._overrides = overrides
        self._token: contextvars.Token | None = None

    def __enter__(self) -> "scoped":
        parent = _SCOPE.get()
        if parent is None:
            values, pins = dict(self._overrides), frozenset(self._overrides)
        else:
            values = {**parent[0], **self._overrides}
            pins = parent[1] | frozenset(self._overrides)
        self._token = _SCOPE.set((values, pins))
        return self

    def __exit__(self, *args: Any) -> None:
        if self._token is not None:
            _SCOPE.reset(self._token)
            self._token = None


class set_options:
    """Context manager / global setter for options.

    >>> import flox_tpu_torch
    >>> with flox_tpu_torch.set_options(pallas_accum="dd"):
    ...     pass
    """

    def __init__(self, **kwargs: Any) -> None:
        _check(kwargs)
        # the process-wide value, not the scope's: leaving the block must
        # restore it, never write an overlay value into the dict
        self.old: dict[str, Any] = {k: dict.__getitem__(OPTIONS, k) for k in kwargs}
        self._newly_explicit = set(kwargs) - _EXPLICIT_OPTIONS
        _EXPLICIT_OPTIONS.update(kwargs)
        OPTIONS.update(kwargs)

    def __enter__(self) -> None:
        return None

    def __exit__(self, *args: Any) -> None:
        OPTIONS.update(self.old)
        _EXPLICIT_OPTIONS.difference_update(self._newly_explicit)


#: the reference's engine names in the port
_ENGINES = {"jax": "torch", "sort": "sort", "numpy": "numpy"}


def from_reference(opts: dict) -> dict:
    """The port's options for the reference's ``OPTIONS`` (a plain dict).

    Keys the port has are carried over; the reference's ``"pallas"``
    implementation maps to the port's ``"kernel"`` and its ``"jax"`` engine to
    ``"torch"``. Keys the port lacks are ignored.
    """
    out: dict[str, Any] = {}
    for key in OPTIONS:
        if key not in opts:
            continue
        value = opts[key]
        if key == "default_engine":
            value = _ENGINES.get(value, value)
        elif key.endswith("_impl") and value == "pallas":
            value = "kernel"
        if not _VALIDATORS[key](value):
            raise ValueError(f"option {key!r}: the port cannot take {value!r}")
        out[key] = value
    return out
