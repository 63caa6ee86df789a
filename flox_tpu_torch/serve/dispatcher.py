"""Asyncio serving dispatcher: coalescing, micro-batching, admission control
(the port of ``flox_tpu/serve/dispatcher.py``).

The library below this layer is call-at-a-time: every ``groupby_reduce``
pays its own dispatch, and concurrent callers race on process-global knobs.
A serving replica amortizes those costs across requests instead:

* **Coalescing** — concurrent requests that run the same program AND carry
  the same payload share ONE execution: the first arrival creates a leaf
  with a future, later identical requests (same program key —
  aggregation, shapes, dtypes, codes, option overlay and
  ``trace_fingerprint()`` — plus the same payload digest) attach to that
  future. K identical requests -> exactly one device
  dispatch, K correct responses (asserted in tests on the
  ``serve.dispatches`` counter).
* **Micro-batching** — program-compatible small requests with *different*
  payloads stack along a new leading axis into one dispatch: B arrays of
  shape ``(..., N)`` sharing codes + aggregation become one ``(B, ..., N)``
  reduction whose row ``i`` is request ``i``'s result: one host-to-device
  copy and one kernel launch for the whole batch, and one copy of the
  results back. Per-row accumulation order is unchanged, so rows are
  bit-identical to solo runs. Bounded by
  ``serve_microbatch_max`` requests and ``serve_microbatch_max_elems``
  elements (stacking huge payloads would serialize the batch behind one
  giant dispatch rather than amortize dispatch overhead).
* **Admission control** — ``serve_queue_depth`` bounds requests pending in
  the dispatcher (queued + executing); a submit beyond it is load-shed
  immediately (:class:`LoadShedError`) instead of growing a backlog the
  device can never drain. Per-request deadlines (``deadline=`` or
  ``serve_deadline``) cancel still-queued requests with
  :class:`DeadlineExceededError`; a batch whose every waiter expired is
  abandoned without dispatching, so expired requests never poison the queue.
* **Isolation** — each request may carry an ``options`` overlay; execution
  runs under ``options.scoped(**overrides)`` so concurrent requests with
  different knobs (engine, prefetch, telemetry level) never race on the
  process-global OPTIONS dict. The overlay is part of the program key:
  requests only share a dispatch when their execution-relevant knobs agree.

**Device.** A :class:`Dispatcher` reduces on its ``device`` (CUDA unless
the caller names the CPU; without CUDA the default raises). A batch whose
kernel raises fails its waiters with the error, classified through the
breaker; it is never answered by a kernel's plain version.

SLO metrics flow through the telemetry registry: counters
(``serve.requests`` / ``serve.coalesced`` / ``serve.microbatched`` /
``serve.dispatches`` / ``serve.shed`` / ``serve.deadline_exceeded`` /
``serve.errors``) and log-spaced histograms (``serve.queue_ms`` /
``serve.device_ms`` / ``serve.request_ms``) — queue-time vs device-time
split per request, p50/p99 via ``METRICS.percentile``. The tables here
(:data:`_PENDING_REGISTRY`, :data:`_COALESCE_CACHE`,
:data:`_BATCH_REGISTRY`) are registered in ``cache.clear_all`` /
``cache.stats``. Where the reference counts the program compiles a
dispatch provoked, the port counts the kernel libraries that ``nvcc`` built during
it (``_build.BUILDS``).
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import _build, options, resilience, telemetry, utils
from ..telemetry import METRICS
from . import breaker

__all__ = [
    "AggregationRequest",
    "CircuitOpenError",
    "DeadlineExceededError",
    "DeviceLostError",
    "Dispatcher",
    "DrainingError",
    "LoadShedError",
    "ServeError",
    "ServeResult",
    "WatchdogTimeoutError",
    "payload_digest",
]


class ServeError(RuntimeError):
    """Base class for serving-layer request failures.

    Every subclass carries a machine-readable :attr:`code` (stable across
    renames — JSON clients branch on it instead of string-matching the
    Python class name) and an optional :attr:`retry_after_ms` hint for
    load-control failures where retrying is the right move. Both ride the
    JSON-lines protocol on error responses."""

    #: stable machine-readable identity of the failure kind
    code = "serve_error"

    def __init__(
        self,
        message: str,
        *,
        retry_after_ms: float | None = None,
        program: str | None = None,
    ) -> None:
        super().__init__(message)
        #: when retrying makes sense, the soonest it plausibly helps (ms)
        self.retry_after_ms = retry_after_ms
        #: the program label the failure is scoped to, where one applies
        self.program = program


class LoadShedError(ServeError):
    """The dispatcher is saturated (``serve_queue_depth`` reached); the
    request was rejected WITHOUT queueing — retry with backoff."""

    code = "load_shed"


class DeadlineExceededError(ServeError):
    """The request's deadline passed before its result was ready; if it was
    still queued, it will never be dispatched."""

    code = "deadline_exceeded"


class CircuitOpenError(ServeError):
    """This request's program key has an OPEN circuit breaker — recent
    requests for the same compiled program failed fatally
    ``serve_breaker_threshold`` times in a row, so the dispatcher fails
    fast instead of burning another dispatch. Carries the program label and
    the cooldown remaining (``retry_after_ms``); after the cooldown one
    probe request is admitted, and its success closes the breaker."""

    code = "circuit_open"


class DeviceLostError(ServeError):
    """The device (or its context) died under this request's dispatch.
    In-flight waiters get this typed error while the replica recovers:
    readiness flips 503, the device layer reinitializes, the warmup
    manifest replays, the registry and the stores restage, and readiness
    returns — retry against another replica (or this one once ``/readyz``
    answers 200 again)."""

    code = "device_lost"


class WatchdogTimeoutError(ServeError):
    """The device dispatch ran past ``serve_watchdog_timeout``: its waiters
    are failed (the queue must not hang behind a wedged program) and a
    flight dump + capture hint are left for the operator."""

    code = "watchdog_timeout"


class DrainingError(ServeError):
    """The replica is draining (SIGTERM / ``{"op": "shutdown"}``):
    admission is closed, in-flight requests are finishing. Retry against
    another replica — this process is about to exit."""

    code = "draining"


@dataclass
class AggregationRequest:
    """One aggregation request: a ``groupby_reduce`` call plus serving
    envelope (option overlay, deadline, id). ``array``/``by`` are host
    arrays (anything ``np.asarray`` accepts); the dispatcher copies them to
    its device once per dispatch."""

    func: Any
    array: Any = None
    by: Any = None
    expected_groups: Any = None
    fill_value: Any = None
    dtype: Any = None
    min_count: int | None = None
    engine: str | None = None
    finalize_kwargs: dict | None = None
    #: ``options.scoped`` overlay active for this request's execution;
    #: part of the program key, so only knob-identical requests share work
    options: dict = field(default_factory=dict)
    #: seconds from submit (queue wait + device time); ``None`` falls back
    #: to ``OPTIONS["serve_deadline"]`` (0 there = no deadline)
    deadline: float | None = None
    request_id: str | None = None
    #: optional W3C trace-context header (``00-<trace>-<parent>-<flags>``):
    #: a request that arrived carrying one (router hop, traced client) runs
    #: under THAT trace id with the parent span linked, and the response
    #: echoes a ``traceparent`` with the same trace id — so the whole
    #: router→replica path joins into ONE trace. Malformed values are
    #: ignored (counted on ``serve.bad_traceparent``), never errors.
    traceparent: str | None = None
    #: optional cost-attribution tag: requests carrying one feed the
    #: per-tenant cost ledger (``cache.stats()["cost_by_tenant"]``) and a
    #: tenant-labeled ``serve.request_ms{tenant=...}`` latency histogram on
    #: /metrics. Attribution only — a tenant tag never changes the program
    #: key, so tagged and untagged requests still coalesce/batch together.
    tenant: str | None = None
    #: optional resident-dataset reference (``serve.registry``): the
    #: request's ``array``/``by`` come from the named put_dataset entry
    #: (data optional — a labels-only entry still accepts inline ``array``
    #: over resident codes). The entry's content fingerprint replaces
    #: payload hashing in the program key, so hits skip JSON payloads,
    #: factorize, H2D, AND digesting. Unknown names answer a typed
    #: :class:`~flox_tpu_torch.serve.registry.UnknownDatasetError`.
    dataset: str | None = None
    #: optional ``[start, stop)`` row-range selector over the dataset's
    #: flattened label axis (a view of the resident tensor — no H2D)
    rows: Any = None
    #: optional boolean-mask selector over the same axis (device-side
    #: gather); mutually exclusive with ``rows``
    mask: Any = None


@dataclass
class ServeResult:
    """A served aggregation: the result/groups host arrays plus per-request
    SLO attribution. ``result``/``groups`` may be shared with coalesced
    peers — treat them as read-only. Multi-statistic requests (``func`` a
    tuple of names) return ``result`` as a dict mapping func name -> array."""

    result: Any
    groups: np.ndarray
    request_id: str | None = None
    #: whether this request attached to another request's execution
    coalesced: bool = False
    #: leaves in the device dispatch that produced this result
    batch_size: int = 1
    queue_ms: float = 0.0
    device_ms: float = 0.0
    #: the trace id this request ran under: the W3C trace id when the
    #: request carried a valid ``traceparent``, else its request id
    trace_id: str | None = None
    #: the ``traceparent`` to hand the next hop (same trace id, this
    #: replica's handling as the new parent span) — set only for requests
    #: that propagated one in, so untraced traffic sees no new fields
    traceparent: str | None = None


class _Leaf:
    """One unit of work: a unique (program, payload) pair. Coalesced
    requests are extra waiters on the same leaf."""

    __slots__ = (
        "array", "payload_key", "future", "waiters", "t_dispatch",
        "batch_size", "device_ms",
    )

    def __init__(self, array: np.ndarray, payload_key: tuple) -> None:
        self.array = array
        self.payload_key = payload_key
        self.future: asyncio.Future = asyncio.get_running_loop().create_future()
        self.waiters = 1
        self.t_dispatch: float | None = None
        self.batch_size = 1
        self.device_ms = 0.0


class _Batch:
    """An open micro-batch: leaves sharing one program key, dispatched as
    one device call after the batching window closes."""

    __slots__ = (
        "pkey", "leaves", "open", "func", "by", "agg_kwargs", "overrides",
        "dsentry", "dslabel",
    )

    def __init__(
        self, pkey: tuple, func: Any, by: Any,
        agg_kwargs: dict, overrides: dict,
        dsentry: Any = None, dslabel: str | None = None,
    ) -> None:
        self.pkey = pkey
        self.leaves: list[_Leaf] = []
        self.open = True
        self.func = func
        self.by = by
        self.agg_kwargs = agg_kwargs
        self.overrides = overrides
        #: the pinned registry entry this batch dispatches against (the
        #: pin is released when the batch settles), and its billing label
        self.dsentry = dsentry
        self.dslabel = dslabel


#: admission/pending table: every admitted request (queued OR executing),
#: keyed by a process-unique sequence id — ``len()`` is the queue depth the
#: admission check bounds. Registered in cache.clear_all.
_PENDING_REGISTRY: dict[int, AggregationRequest] = {}

#: coalescing table: (program key, payload digest) -> live _Leaf. Entries
#: exist from first submit until their dispatch completes, so identical
#: requests attach to queued AND in-flight executions alike.
_COALESCE_CACHE: dict[tuple, _Leaf] = {}

#: open micro-batches: program key -> the joinable _Batch (closed batches
#: leave the table; their dispatch task keeps them alive).
_BATCH_REGISTRY: dict[tuple, _Batch] = {}

_IDS = itertools.count(1)

#: reductions whose results grow axes (quantile's q-dim) or need run-length
#: structure — stacking them along a lead axis would reshape results per
#: request, so they always dispatch alone
_UNBATCHABLE = frozenset(
    {"quantile", "nanquantile", "median", "nanmedian", "mode", "nanmode"}
)


def _is_multi(func: Any) -> bool:
    """A multi-statistic request: ``func`` is a tuple/list of names — one
    ``groupby_aggregate_many`` dispatch serves the whole set."""
    return isinstance(func, (tuple, list)) and all(
        isinstance(f, str) for f in func
    )


def _func_label(func: Any) -> str:
    if isinstance(func, str):
        return func
    if _is_multi(func):
        from ..fusion import fused_program_label

        return fused_program_label(func)
    return "custom"


def _digest_bytes(*parts: bytes) -> str:
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(p)
        h.update(b"|")
    return h.hexdigest()


def _array_digest(arr: np.ndarray) -> str:
    arr = np.ascontiguousarray(arr)
    return _digest_bytes(str(arr.dtype).encode(), repr(arr.shape).encode(), arr.tobytes())


def payload_digest(array: Any) -> str:
    """The payload half of a request's coalescing identity — public so the
    chaos harness (``faults.serve_inject(poison_digests=...)``) can target
    one micro-batch member by the exact digest the dispatcher will see."""
    return _array_digest(np.asarray(array))


def _dtype_name(arr: Any) -> str:
    """The numpy name of a host array's or a tensor's dtype."""
    dt = arr.dtype
    if isinstance(dt, torch.dtype):
        return "bfloat16" if dt == torch.bfloat16 else utils.numpy_dtype(dt).name
    return np.dtype(dt).name


#: payloads up to this many bytes hash inline on the event-loop thread (a
#: thread hop costs more than the hash there); bigger ones go off-loop
_INLINE_DIGEST_BYTES = 1 << 16


async def _digest_payload(arr: np.ndarray) -> str:
    if arr.nbytes <= _INLINE_DIGEST_BYTES:
        return _array_digest(arr)
    return await asyncio.to_thread(_array_digest, arr)


def _freeze(v: Any) -> Any:
    """Hashable identity of request kwargs for the program key."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("__ndarray__", _array_digest(v))
    if isinstance(v, float) and np.isnan(v):
        return "__nan__"
    if isinstance(v, np.generic):
        return repr(v)
    if callable(v):
        return (getattr(v, "__qualname__", repr(v)), id(v))
    return v


def _program_key(
    func: Any, arr: np.ndarray, by_digest: str, agg_kwargs: dict, overrides: dict
) -> tuple:
    """The program identity of a request: aggregation identity + shapes and
    dtypes + codes identity + option overlay + ``trace_fingerprint()``
    (evaluated under the request's option scope — a request that pins
    ``segment_sum_impl`` runs other kernels). Two requests with equal keys
    run the same kernels on the same codes, which is what makes sharing a
    dispatch safe.
    """
    from ..options import trace_fingerprint

    return (
        "reduce",
        func if isinstance(func, str)
        else tuple(func) if _is_multi(func)
        else ("__agg__", id(func)),
        tuple(arr.shape),
        _dtype_name(arr),
        by_digest,
        _freeze(agg_kwargs),
        _freeze(overrides),
        trace_fingerprint(),
    )


class Dispatcher:
    """The serving front-end: ``await dispatcher.submit(request)``.

    ``device`` is where every dispatch reduces: CUDA unless the caller names
    the CPU (without CUDA the default raises). Constructor knobs override
    the ``OPTIONS`` defaults per instance (``None`` reads the option —
    scope-aware — at each submit). All state mutation happens on the
    event-loop thread; executions run in worker threads via
    ``asyncio.to_thread`` (which propagates contextvars, so the request's
    option scope and telemetry span context follow the work).
    """

    def __init__(
        self,
        *,
        queue_depth: int | None = None,
        deadline: float | None = None,
        microbatch_max: int | None = None,
        microbatch_max_elems: int | None = None,
        batch_window: float | None = None,
        device: Any = None,
    ) -> None:
        self.device = utils.resolve_device(device)
        self.queue_depth = queue_depth
        self.deadline = deadline
        self.microbatch_max = microbatch_max
        self.microbatch_max_elems = microbatch_max_elems
        self.batch_window = batch_window
        self._tasks: set[asyncio.Task] = set()
        self._draining = False

    @property
    def draining(self) -> bool:
        """Whether admission is closed (:meth:`begin_drain` was called)."""
        return self._draining

    def begin_drain(self) -> None:
        """Close admission: every later :meth:`submit` fails fast with
        :class:`DrainingError`. In-flight requests are unaffected — the
        serve loop awaits them (bounded by ``serve_drain_timeout``) via
        :meth:`close` before exiting."""
        self._draining = True
        METRICS.inc("serve.drains")

    def _knob(self, explicit: Any, name: str) -> Any:
        return explicit if explicit is not None else options.OPTIONS[name]

    async def submit(
        self, request: AggregationRequest | None = None, **kwargs: Any
    ) -> ServeResult:
        """Admit, (maybe) coalesce/batch, execute, and return one request.

        Accepts a prebuilt :class:`AggregationRequest` or its fields as
        keyword arguments. Raises :class:`LoadShedError` at saturation and
        :class:`DeadlineExceededError` past the deadline; any execution
        error propagates to every waiter of the failed dispatch.
        """
        if request is None:
            request = AggregationRequest(**kwargs)
        t0 = time.perf_counter()
        # canary probes get their own admission counter: serve.requests is
        # the availability SLO's denominator, and synthetic known-answer
        # traffic must neither dilute nor burn a user-facing budget
        if request.tenant == telemetry.CANARY_TENANT:
            METRICS.inc("canary.requests")
        else:
            METRICS.inc("serve.requests")
        if self._draining:
            METRICS.inc("serve.drain_rejected")
            raise DrainingError(
                "replica draining: admission closed, in-flight requests "
                "finishing; retry against another replica"
            )
        depth = self._knob(self.queue_depth, "serve_queue_depth")
        if depth and len(_PENDING_REGISTRY) >= depth:
            # canary admission failures land on their own counter:
            # serve.shed is an availability-SLO bad counter, and synthetic
            # probes hitting a saturated queue is not a user-facing outage
            if request.tenant == telemetry.CANARY_TENANT:
                METRICS.inc("canary.shed")
            else:
                METRICS.inc("serve.shed")
            window = float(self._knob(self.batch_window, "serve_batch_window"))
            raise LoadShedError(
                f"dispatcher saturated: {len(_PENDING_REGISTRY)} requests pending "
                f"(serve_queue_depth={depth}); retry with backoff",
                # the soonest a queue slot plausibly frees: one batch window
                # (the granularity at which pending batches dispatch)
                retry_after_ms=max(1.0, window * 1e3),
            )
        rid = next(_IDS)
        _PENDING_REGISTRY[rid] = request
        # end-to-end trace context: the request_id (or a generated one)
        # rides a contextvar into every child span/event this request emits
        # — the batch task and its asyncio.to_thread execution inherit it,
        # so core phase spans, streaming passes, mesh dispatches, and
        # resilience events all carry it in both export formats.
        # observe=False: this layer feeds serve.request_ms itself (always
        # on — SLO histograms don't ride the telemetry switch); the
        # tail-sampling verdict compares against the p99 snapshotted at
        # trace ENTRY, so the request's own mid-trace observation cannot
        # dilute its own verdict
        if request.request_id is None:
            # replica-prefixed: two replicas behind one router each count
            # their own req-N — without the prefix (the configured
            # replica_id, or a per-process fallback) the fleet's ids
            # collide and traces/exemplars/ledger links cross-attribute
            request.request_id = f"{telemetry.replica_instance()}:req-{rid}"
        # trace propagation: a request that arrived with a (valid) W3C
        # traceparent runs under ITS trace id with the remote parent span
        # linked — the whole router→replica hop becomes one joined trace.
        # Without one, the request id roots a fresh local trace as before.
        parsed = (
            telemetry.parse_traceparent(request.traceparent)
            if request.traceparent is not None
            else None
        )
        if request.traceparent is not None and parsed is None:
            METRICS.inc("serve.bad_traceparent")
        trace_ctx, parent_span = parsed if parsed else (request.request_id, None)
        try:
            with telemetry.trace(
                trace_ctx, hist="serve.request_ms", observe=False,
                parent=parent_span,
            ):
                return await self._submit_admitted(
                    request, t0, trace_ctx, propagated=parsed is not None
                )
        finally:
            _PENDING_REGISTRY.pop(rid, None)

    async def _submit_admitted(
        self,
        request: AggregationRequest,
        t0: float,
        trace_ctx: str | None = None,
        propagated: bool = False,
    ) -> ServeResult:
        if isinstance(request.func, list):
            # JSON clients send statistic sets as lists; the program key
            # and the fused planner both want the hashable tuple form
            request.func = tuple(request.func)
        dsentry = None
        dslabel: str | None = None
        if request.dataset is not None:
            # resident-dataset reference: resolve + refcount-pin the entry
            # (the pin rides the batch and is released when its dispatch
            # settles, so eviction/del_dataset never races an in-flight
            # dispatch), and reuse the put-time content fingerprint as the
            # coalescing identity — zero payload hashing on the hit path
            from . import registry

            if request.by is not None or request.expected_groups is not None:
                raise ValueError(
                    "a dataset-referencing request must not also inline "
                    "'by'/'expected_groups' — they were fixed at put time"
                )
            dsentry = registry.resolve(request.dataset)
            registry.pin(dsentry)
            try:
                data_view, pf_view, selkey = registry.view(
                    dsentry, rows=request.rows, mask=request.mask
                )
                by_digest = f"ds:{dsentry.fingerprint}:{selkey}"
                if request.array is not None:
                    # labels-resident mode: per-request data over the
                    # entry's precomputed codes
                    arr = np.asarray(request.array)
                    arr_digest = await _digest_payload(arr)
                elif data_view is None:
                    raise ValueError(
                        f"dataset {request.dataset!r} holds no data array; "
                        "inline 'array' with the request"
                    )
                else:
                    arr = data_view
                    arr_digest = by_digest
            except BaseException:
                registry.unpin(dsentry)
                raise
            by = pf_view
            dslabel = request.dataset
        else:
            if request.rows is not None or request.mask is not None:
                raise ValueError(
                    "'rows'/'mask' selectors require a 'dataset' reference"
                )
            if request.array is None or request.by is None:
                raise ValueError(
                    "inline requests require both 'array' and 'by' "
                    "(or reference a resident 'dataset')"
                )
            arr = np.asarray(request.array)
            by = np.asarray(request.by)
        # fold the submitter's AMBIENT scoped() overlay under the request's
        # own options (request wins): ambient knobs like default_engine
        # change results without appearing in trace_fingerprint(), so they
        # must be part of the program key AND of the execution overlay — a
        # scoped submit never shares a dispatch with differently-scoped
        # peers, and execution no longer depends on whichever task's
        # context the batch task happened to inherit
        overrides = {**options.scope_overrides(), **(request.options or {})}
        agg_kwargs = {
            "expected_groups": request.expected_groups,
            "fill_value": request.fill_value,
            "dtype": request.dtype,
            "min_count": request.min_count,
            "engine": request.engine,
            "finalize_kwargs": request.finalize_kwargs,
        }
        try:
            if dsentry is None:
                # large payloads hash in a worker thread — a multi-hundred-MB
                # blake2b on the event-loop thread would stall every other
                # request's admission, window timer, and deadline check.
                # Memoized per request OBJECT: a resubmitted request (library
                # retry loops) never rehashes an unchanged payload.
                digests = getattr(request, "_payload_digests", None)
                if digests is None:
                    by_digest = await _digest_payload(by)
                    arr_digest = await _digest_payload(arr)
                    request._payload_digests = (by_digest, arr_digest)
                else:
                    by_digest, arr_digest = digests
            # the fingerprint half of the key must see the request's pinned
            # knobs — evaluate under its scope (validates the overlay too, so a
            # bad option name/value fails HERE, not inside a worker thread)
            with options.scoped(**overrides):
                pkey = _program_key(request.func, arr, by_digest, agg_kwargs, overrides)
            # circuit-breaker gate: a program key whose recent dispatches all
            # failed fatally fast-fails HERE (typed CircuitOpenError with the
            # cooldown remaining) — no queue slot, no batch, no device time
            breaker.check(pkey, _func_label(request.func))
        except BaseException:
            if dsentry is not None:
                from . import registry

                registry.unpin(dsentry)
            raise
        payload_key = (pkey, arr_digest)
        deadline = request.deadline
        if deadline is None:
            deadline = self._knob(self.deadline, "serve_deadline")
        deadline = float(deadline) if deadline else None

        leaf = _COALESCE_CACHE.get(payload_key)
        coalesced = leaf is not None
        if coalesced:
            METRICS.inc("serve.coalesced")
            leaf.waiters += 1
            if dsentry is not None:
                # the leaf's own batch already pins the entry; this
                # request only waits on the shared future
                from . import registry

                registry.unpin(dsentry)
        else:
            leaf = _Leaf(arr, payload_key)
            _COALESCE_CACHE[payload_key] = leaf
            self._enqueue(
                leaf, request, arr, by, agg_kwargs, overrides, pkey,
                dsentry=dsentry, dslabel=dslabel,
            )

        try:
            # shield: one waiter's timeout must not cancel the shared leaf
            if deadline is None:
                row, groups = await asyncio.shield(leaf.future)
            else:
                remaining = deadline - (time.perf_counter() - t0)
                if remaining <= 0:
                    raise asyncio.TimeoutError
                row, groups = await asyncio.wait_for(
                    asyncio.shield(leaf.future), remaining
                )
        except (asyncio.TimeoutError, TimeoutError):
            # drop this waiter; a leaf with no waiters left is abandoned at
            # dispatch time (never dispatched), so expired requests cannot
            # poison the queue
            leaf.waiters -= 1
            # same canary split as serve.shed: deadline_exceeded is an
            # availability-SLO bad counter
            if request.tenant == telemetry.CANARY_TENANT:
                METRICS.inc("canary.deadline_exceeded")
            else:
                METRICS.inc("serve.deadline_exceeded")
            raise DeadlineExceededError(
                f"deadline of {deadline:.4f}s exceeded "
                f"({'dispatched' if leaf.t_dispatch else 'still queued'})"
            ) from None
        t1 = time.perf_counter()
        # clamped: a request that attached to an ALREADY-dispatched leaf
        # waited 0, not a negative interval (t_dispatch predates its t0)
        queue_ms = max(0.0, ((leaf.t_dispatch or t1) - t0) * 1e3)
        request_ms = (t1 - t0) * 1e3
        # the SLO canary's known-answer probes stay OUT of the base latency
        # series (user-facing latency SLOs read serve.request_ms) but keep
        # their own labeled series + cost row below — "billed under the
        # reserved tenant, excluded from user-facing SLOs"
        if request.tenant != telemetry.CANARY_TENANT:
            METRICS.observe("serve.request_ms", request_ms, exemplar=request.request_id)
            METRICS.observe("serve.queue_ms", queue_ms, exemplar=request.request_id)
        if request.tenant is not None:
            # the tenant axis: a labeled latency series on /metrics plus a
            # cost-ledger row. The raw tag is client-supplied, so it goes
            # through tenant_label: unsafe characters fold away (no label
            # injection into the exposition) and distinct labels are
            # cardinality-capped (past the cap, "_other"). A coalesced /
            # batched request is billed its SHARE of the shared dispatch's
            # wall — dividing by the leaves dispatched together and this
            # leaf's waiters keeps tenant totals summing to the program
            # walls instead of multiplying them.
            label = telemetry.tenant_label(request.tenant)
            METRICS.observe(
                f"serve.request_ms|tenant={label}",
                request_ms,
                exemplar=request.request_id,
            )
            telemetry.observe_cost(
                tenant=label,
                device_ms=leaf.device_ms
                / (max(1, leaf.batch_size) * max(1, leaf.waiters)),
                nbytes=int(arr.nbytes),
            )
        telemetry.record_span(
            "serve.request", t0, t1,
            attrs={
                "func": _func_label(request.func),
                "coalesced": coalesced, "batch": leaf.batch_size,
            },
        )
        return ServeResult(
            result=row,
            groups=groups,
            request_id=request.request_id,
            coalesced=coalesced,
            batch_size=leaf.batch_size,
            queue_ms=queue_ms,
            device_ms=leaf.device_ms,
            trace_id=trace_ctx if trace_ctx is not None else request.request_id,
            # echo the SAME trace id with this replica's handling as the
            # new parent span — the next hop (or the client's trace UI)
            # chains onto it. Only for requests that propagated one in.
            traceparent=(
                telemetry.format_traceparent(trace_ctx)
                if propagated and trace_ctx is not None
                else None
            ),
        )

    # -- batching -----------------------------------------------------------

    def _batchable(self, request: AggregationRequest, arr: Any) -> bool:
        if request.dataset is not None:
            # registry-referenced payloads are device-resident and shared:
            # stacking them would force a D2H + restage of the very buffers
            # the registry exists to keep pinned (coalescing still applies)
            return False
        if _is_multi(request.func):
            # fused statistic sets contain only batchable reductions
            # (FUSABLE_FUNCS excludes the axis-growing order statistics),
            # and groupby_aggregate_many handles lead axes — multi-stat
            # requests micro-batch exactly like single-stat ones
            pass
        elif not isinstance(request.func, str) or request.func in _UNBATCHABLE:
            return False
        if request.finalize_kwargs:
            return False
        if self._knob(self.microbatch_max, "serve_microbatch_max") <= 1:
            return False
        ceil = self._knob(self.microbatch_max_elems, "serve_microbatch_max_elems")
        return not (ceil and arr.size > ceil)

    def _enqueue(
        self,
        leaf: _Leaf,
        request: AggregationRequest,
        arr: Any,
        by: Any,
        agg_kwargs: dict,
        overrides: dict,
        pkey: tuple,
        dsentry: Any = None,
        dslabel: str | None = None,
    ) -> None:
        batchable = self._batchable(request, arr)
        if batchable:
            batch = _BATCH_REGISTRY.get(pkey)
            if (
                batch is not None
                and batch.open
                and len(batch.leaves)
                < self._knob(self.microbatch_max, "serve_microbatch_max")
            ):
                batch.leaves.append(leaf)
                METRICS.inc("serve.microbatched")
                return
        batch = _Batch(
            pkey, request.func, by, agg_kwargs, overrides,
            dsentry=dsentry, dslabel=dslabel,
        )
        batch.leaves.append(leaf)
        if batchable:
            _BATCH_REGISTRY[pkey] = batch
        window = self._knob(self.batch_window, "serve_batch_window")
        task = asyncio.create_task(self._run_batch(batch, float(window)))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_batch(self, batch: _Batch, window: float) -> None:
        try:
            await self._run_batch_inner(batch, window)
        finally:
            if batch.dsentry is not None:
                # the batch settled (delivered, failed, or abandoned):
                # release the registry pin so eviction / del_dataset can
                # reclaim the entry
                from . import registry

                registry.unpin(batch.dsentry)

    async def _run_batch_inner(self, batch: _Batch, window: float) -> None:
        # even window=0 yields the loop once, so same-tick submits coalesce
        await asyncio.sleep(window)
        batch.open = False
        if _BATCH_REGISTRY.get(batch.pkey) is batch:
            _BATCH_REGISTRY.pop(batch.pkey, None)
        live = [leaf for leaf in batch.leaves if leaf.waiters > 0]
        t_dispatch = time.perf_counter()
        for leaf in batch.leaves:
            if leaf.waiters > 0:
                leaf.t_dispatch = t_dispatch
                leaf.batch_size = len(live)
            else:
                # every waiter's deadline expired while queued: abandon the
                # leaf (its future stays unset — nobody is listening)
                _COALESCE_CACHE.pop(leaf.payload_key, None)
        if not live:
            METRICS.inc("serve.batches_abandoned")
            # an abandoned batch resolves nothing: if it carried the
            # breaker's half-open probe, re-arm the probe slot
            breaker.release_probe(batch.pkey)
            return
        try:
            results = await self._dispatch(batch, live)
        except asyncio.CancelledError:
            # a cancelled batch task (drain budget expiry) must propagate,
            # never be classified: cancel still-waiting futures so no
            # waiter hangs, re-dispatch nothing, pollute no breaker
            for leaf in live:
                _COALESCE_CACHE.pop(leaf.payload_key, None)
                if not leaf.future.done():
                    leaf.future.cancel()
            breaker.release_probe(batch.pkey)
            raise
        except BaseException as exc:  # noqa: BLE001 — classified + fanned out
            # the serve-plane fault domain: classify first (the same gate
            # the streaming path consults), then contain the blast radius —
            # device loss triggers backend recovery, a fatal/oom failure of
            # a multi-leaf batch bisects so healthy peers still get
            # results, a single poisoned leaf fails alone (and feeds its
            # program's circuit breaker)
            for leaf in live:
                _COALESCE_CACHE.pop(leaf.payload_key, None)
            await self._contain_failure(
                batch, live, exc, resilience.classify_error(exc)
            )
            return
        finally:
            for leaf in live:
                _COALESCE_CACHE.pop(leaf.payload_key, None)
        breaker.record_success(batch.pkey)
        rows, groups = results
        for leaf, row in zip(live, rows):
            if not leaf.future.done():
                leaf.future.set_result((row, groups))

    # -- fault domain -------------------------------------------------------

    async def _dispatch(self, batch: _Batch, live: list[_Leaf]) -> tuple:
        """One watchdog-guarded device dispatch for ``live``'s leaves.

        ``serve_watchdog_timeout`` bounds the worker-thread execution: a
        dispatch stuck past it fails its waiters with a typed
        :class:`WatchdogTimeoutError` (flight dump + capture hint recorded)
        instead of wedging the queue behind one hung program. The stuck
        thread itself cannot be killed — its eventual result is discarded
        — but every queue decision stops waiting on it."""
        watchdog = float(options.OPTIONS["serve_watchdog_timeout"] or 0)
        if not watchdog:
            return await asyncio.to_thread(self._execute, batch, live)
        try:
            return await asyncio.wait_for(
                asyncio.to_thread(self._execute, batch, live), watchdog
            )
        except (asyncio.TimeoutError, TimeoutError):
            label = _func_label(batch.func)
            METRICS.inc("serve.watchdog_fired")
            telemetry.event(
                "watchdog",
                program=label,
                timeout_s=watchdog,
                hint="dispatch wedged: grab an on-chip capture "
                "(/debug/profile?seconds=N or SIGUSR1) while it hangs",
            )
            # flight_dump writes files: off the loop so the dump of a
            # wedged dispatch cannot also wedge every other queue
            await asyncio.to_thread(
                telemetry.flight_dump, reason=f"watchdog:{label}"
            )
            raise WatchdogTimeoutError(
                f"dispatch for program {label!r} exceeded "
                f"serve_watchdog_timeout={watchdog:g}s; its waiters were "
                "failed so the queue keeps moving",
                program=label,
            ) from None

    async def _contain_failure(
        self, batch: _Batch, live: list[_Leaf], exc: BaseException, cls: str
    ) -> None:
        """Route one classified dispatch failure down its containment path."""
        if isinstance(exc, WatchdogTimeoutError):
            # a hang is not bisectable — re-dispatching sub-batches would
            # hang serially through N more watchdog windows. Fail the whole
            # batch and count it against the program's breaker.
            breaker.record_failure(batch.pkey, _func_label(batch.func))
            self._fail_leaves(live, exc)
            return
        if cls == resilience.DEVICE_LOST:
            await self._handle_device_loss(batch, live, exc)
            return
        if len(live) > 1 and cls in (resilience.FATAL, resilience.OOM):
            # request quarantine: one poisoned member must not take its
            # coalesced/micro-batched peers down with it
            await self._quarantine(batch, live, exc)
            return
        if cls == resilience.FATAL:
            breaker.record_failure(batch.pkey, _func_label(batch.func))
        else:
            # transient/oom outcomes carry no breaker verdict — a pending
            # half-open probe must be re-armed, not leaked
            breaker.release_probe(batch.pkey)
        self._fail_leaves(live, exc)

    async def _quarantine(
        self, batch: _Batch, live: list[_Leaf], cause: BaseException
    ) -> None:
        """Bisect a failed multi-leaf dispatch so only the poisoned member
        fails.

        The split rides the same power-of-two ladder as
        ``resilience.dispatch_slab`` (half the span, rounded up to a power
        of two), so the re-dispatched sub-batch shapes form a small
        reusable set. Healthy sub-batches produce rows bit-identical to solo
        runs (the micro-batching invariant); a failing sub-batch recurses until the
        poisoned leaf dispatches alone and gets the typed error, which also
        feeds its program's circuit breaker."""
        METRICS.inc("serve.quarantine_splits")
        telemetry.event(
            "quarantine-split",
            program=_func_label(batch.func),
            leaves=len(live),
            error=type(cause).__name__,
        )
        half = resilience._ladder_half(len(live), 1)
        for lo in range(0, len(live), half):
            sub = live[lo : lo + half]
            try:
                results = await self._dispatch(batch, sub)
            except asyncio.CancelledError:
                for leaf in sub:
                    if not leaf.future.done():
                        leaf.future.cancel()
                breaker.release_probe(batch.pkey)
                raise
            except BaseException as sub_exc:  # noqa: BLE001 — classified below
                if isinstance(sub_exc, WatchdogTimeoutError):
                    breaker.record_failure(batch.pkey, _func_label(batch.func))
                    self._fail_leaves(sub, sub_exc)
                    continue
                cls = resilience.classify_error(sub_exc)
                if cls == resilience.DEVICE_LOST:
                    await self._handle_device_loss(batch, sub, sub_exc)
                    continue
                if len(sub) > 1 and cls in (resilience.FATAL, resilience.OOM):
                    await self._quarantine(batch, sub, sub_exc)
                    continue
                # a single leaf failing alone IS the poisoned member
                METRICS.inc("serve.quarantined")
                telemetry.event(
                    "quarantined",
                    program=_func_label(batch.func),
                    error=type(sub_exc).__name__,
                )
                if cls == resilience.FATAL:
                    breaker.record_failure(batch.pkey, _func_label(batch.func))
                else:
                    breaker.release_probe(batch.pkey)
                self._fail_leaves(sub, sub_exc)
                continue
            breaker.record_success(batch.pkey)
            rows, groups = results
            for leaf, row in zip(sub, rows):
                if not leaf.future.done():
                    leaf.future.set_result((row, groups))

    async def _handle_device_loss(
        self, batch: _Batch, live: list[_Leaf], exc: BaseException
    ) -> None:
        """The dispatch died WITH the device: quarantine its waiters behind
        a typed error, flip readiness, and recover the backend.

        Recovery (reinitialize the backend, replay the AOT warmup manifest,
        flip readiness back) runs in a worker thread under a process-wide
        guard — concurrent batches discovering the same dead device fail
        their own waiters but only one recovery cycle runs."""
        from .. import exposition

        METRICS.inc("serve.device_lost")
        # device loss is not a program-key verdict: never counted toward
        # the breaker, but a pending half-open probe must be re-armed
        breaker.release_probe(batch.pkey)
        telemetry.event(
            "device-lost", program=_func_label(batch.func), error=str(exc)[:200]
        )
        # flight_dump writes files: off the loop so recovery latency is
        # not gated on disk speed
        await asyncio.to_thread(telemetry.flight_dump, reason="device-lost")
        exposition.set_ready(False, reason="device-lost")
        self._fail_leaves(
            live,
            DeviceLostError(
                f"device lost under dispatch for program "
                f"{_func_label(batch.func)!r}; replica recovering "
                f"(/readyz 503 until the backend is back): {exc}",
                program=_func_label(batch.func),
            ),
        )
        await asyncio.to_thread(_recover_device, self.device)

    def _fail_leaves(self, leaves: list[_Leaf], exc: BaseException) -> None:
        """Fan one failure out to every waiter of ``leaves``."""
        METRICS.inc("serve.errors")
        for leaf in leaves:
            if not leaf.future.done():
                leaf.future.set_exception(exc)
                # mark retrieved: if every waiter timed out meanwhile,
                # an unretrieved exception would warn at GC
                leaf.future.exception()

    def _execute(self, batch: _Batch, live: list[_Leaf]) -> tuple[list, np.ndarray]:
        """One device dispatch for every live leaf of ``batch`` (worker
        thread; contextvars — option scope, span context — propagated by
        ``asyncio.to_thread``).

        The leaves' host payloads stack into one array that crosses to the
        device once, one ``groupby_reduce`` (or ``groupby_aggregate_many``)
        call reduces it with one kernel launch, and the result comes back to
        the host once. A registry-referenced dispatch passes the resident
        tensor, so nothing crosses for its payload."""
        from . import aot

        # the kernel libraries the manifest's programs reach are built and
        # loaded before the first dispatch (idempotent; no-op without
        # serve_aot_dir or off CUDA)
        aot.configure(device=self.device)
        METRICS.inc("serve.dispatches")
        from .. import faults

        # chaos hook: the serve fault plan (faults.serve_inject) fires here,
        # exactly where a real dispatch failure would — one is-None check
        # when no plan is installed
        faults.serve_poke(
            _func_label(batch.func),
            tuple(leaf.payload_key[1] for leaf in live),
        )
        # captured ONCE: a set_options(telemetry=True) landing mid-dispatch
        # must not make the post-dispatch block read baselines that were
        # never taken
        tm_on = telemetry.enabled()
        prog = None
        builds0 = _build.BUILDS["count"]
        build_s0 = _build.BUILDS["seconds"]
        if tm_on:
            # the serve program label, computed BEFORE the dispatch so the
            # costmodel alias indexes the cards recorded inside it under
            # this serving label (the /debug/programs join key)
            pdigest = _digest_bytes(repr(batch.pkey).encode())[:8]
            prog = "serve[" + _func_label(batch.func) + f"#{pdigest}]"
            analysis0 = telemetry.METRICS.get("costmodel.card_analysis_ms")
        t0 = time.perf_counter()
        from ..core import groupby_reduce
        from ..costmodel import serve_alias

        kwargs = {k: v for k, v in batch.agg_kwargs.items() if v is not None}
        by = batch.by
        dispatched = live[0].array if len(live) == 1 else np.stack(
            [leaf.array for leaf in live])
        if batch.dsentry is not None and batch.dsentry.sharded and dispatched is batch.dsentry.data:
            # a dataset sharded over the mesh at put time: its DTensor runs
            # the map-reduce program over the host labels
            by = batch.dsentry.by_host.reshape(-1)
            kwargs["method"] = "map-reduce"
        multi = _is_multi(batch.func)
        with serve_alias(prog), options.scoped(**batch.overrides):
            with telemetry.span(
                "serve.execute", func=_func_label(batch.func), batch=len(live),
            ):
                if multi:
                    # one fused dispatch serves every statistic of every
                    # leaf: the payload is staged once for the whole set
                    from ..fusion import groupby_aggregate_many

                    result, groups = groupby_aggregate_many(
                        dispatched, by, funcs=batch.func, device=self.device, **kwargs
                    )
                    stats = {k: utils.asarray_host(v) for k, v in result.items()}
                    rows = ([stats] if len(live) == 1 else
                            [{k: v[i] for k, v in stats.items()} for i in range(len(live))])
                else:
                    result, groups = groupby_reduce(
                        dispatched, by, func=batch.func, device=self.device, **kwargs
                    )
                    result = utils.asarray_host(result)
                    rows = [result] if len(live) == 1 else [result[i] for i in range(len(live))]
        groups = np.asarray(groups)
        device_ms = (time.perf_counter() - t0) * 1e3
        if tm_on:
            device_ms = max(
                0.0,
                device_ms
                - (telemetry.METRICS.get("costmodel.card_analysis_ms") - analysis0),
            )
            telemetry.sample_hbm(program=prog)
            # the program's cost-ledger row: one dispatch (however many
            # coalesced/batched waiters it served), its wall, the bytes it
            # read, and the kernel libraries nvcc built during it. A
            # registry-referenced dispatch also bills the per-dataset axis.
            telemetry.observe_cost(
                prog,
                dataset=batch.dslabel,
                device_ms=device_ms,
                nbytes=int(getattr(dispatched, "nbytes", 0))
                + int(getattr(batch.by, "nbytes", 0)),
                compiles=int(_build.BUILDS["count"] - builds0),
                compile_ms=(_build.BUILDS["seconds"] - build_s0) * 1e3,
            )
        METRICS.observe(
            "serve.device_ms", device_ms, exemplar=telemetry.current_trace()
        )
        for leaf in live:
            leaf.device_ms = device_ms
        # registry dispatches record their resolved post-selector shapes:
        # the inline warmup replay then runs the same kernels (program
        # identity is shapes/dtypes/ngroups, never residency)
        aot.record_reduce(
            func=batch.func,
            shape=tuple(dispatched.shape),
            dtype=_dtype_name(dispatched),
            by_shape=tuple(batch.by.shape),
            by_dtype=str(np.dtype(batch.by.dtype)),
            ngroups=int(groups.shape[0]) if groups.ndim else 1,
            agg_kwargs=kwargs,
            options=batch.overrides,
            dataset=batch.dslabel,
        )
        return rows, groups

    async def close(self) -> None:
        """Wait for every in-flight batch task to finish (results/errors are
        delivered to their waiters as usual)."""
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)


#: one recovery cycle at a time: concurrent batches discovering the same
#: dead device each fail their own waiters, but reinit + warmup + ready
#: must not run twice in parallel (the second cycle would re-tear-down the
#: backend the first just rebuilt)
_RECOVERY_GUARD = threading.Lock()


def _recover_device(device: Any = None) -> None:
    """The device-loss recovery cycle (worker thread): reinitialize the
    device layer, replay the warmup manifest on ``device``, restage every
    registered dataset and reopen every store, then flip ``/readyz`` back
    to 200. Failures leave readiness at 503 — a replica that could not
    recover must not take traffic."""
    from .. import device as device_layer, exposition

    if not _RECOVERY_GUARD.acquire(blocking=False):
        return  # a recovery is already running; it owns the ready flip
    try:
        telemetry.event("device-recovery-start")
        torn_down = device_layer.reinitialize()
        from . import aot

        warmed = aot.warmup(device=device)
        # restage every dataset from its host copy BEFORE readiness flips:
        # a recovered replica that answered 200 while its resident datasets
        # still pointed at dead-device tensors would fail exactly the
        # traffic the router sends it first
        from . import registry

        restaged = registry.restage_all()
        # reopen every durable store from disk with the same ordering:
        # reopening runs crash recovery, drops the device result caches, and
        # rebuilds the host carry from the checksummed segments
        from . import stores as store_registry

        stores_restaged = store_registry.restage_all()
        # flip ready back ONLY if the 503 is still ours: a drain that began
        # mid-recovery set reason "draining", and that 503 must hold until
        # the process exits
        if exposition.ready_reason() == "device-lost":
            exposition.set_ready(True)
        METRICS.inc("serve.recoveries")
        telemetry.event(
            "device-recovery-done", reinitialized=torn_down, warmed=warmed,
            restaged=restaged, stores_restaged=stores_restaged,
        )
    except Exception as exc:  # noqa: BLE001 — an unrecoverable replica stays
        # unready (503) rather than crashing the loop; the record is the
        # operator's signal to replace it
        telemetry.record_serve_error(exc, what="device-recovery")
    finally:
        _RECOVERY_GUARD.release()
