"""Resilient streaming: error taxonomy, retry and backoff, the OOM halving
ladder and checkpoint/resume (the port of ``flox_tpu/resilience.py``).

The streaming executor (``streaming`` + ``pipeline``) has no scheduler to
re-execute a lost chunk, so this module is its re-execution, in three layers:

* **Error taxonomy** (:func:`classify_error`): every failure is ``transient``
  (IO hiccups: retried), ``oom`` (``torch.cuda.OutOfMemoryError``,
  ``MemoryError``, a message with an out-of-memory token: the slab is
  split), ``device_lost`` or ``fatal`` (surfaced at once, never retried).
  A *sticky* CUDA error (an illegal memory access, an unspecified launch
  failure, a device-side assert, a misaligned address or illegal
  instruction, and ``torch.AcceleratorError``) is classified
  ``device_lost``: the CUDA context is dead for the rest of the process, so
  a retry or a split would only relaunch on it, and the remedy is a new
  process, as for a lost device.
* **Retry with exponential backoff and a per-slab deadline**
  (:func:`call_with_retry`), around each slab's load and staging, inside
  the staging worker; when retries run out the original exception surfaces.
* **OOM halving** (:func:`dispatch_slab`): a slab whose step, or whose
  staging, runs out of device memory is re-staged as sub-slabs of half the
  span (a power-of-two ladder), down to single columns; the failed slab's
  device copy and the exception's traceback (whose frames hold the failed
  step's tensors) are dropped before the halves run.
* **Checkpoint/resume** (:class:`StreamCheckpointer`): every
  ``stream_checkpoint_every`` processed slabs the carry is copied to the
  host (a :class:`Snapshot`; optionally spilled to a checksummed ``.npz``).
  A killed run called again with the same arguments restores it and folds
  only the remaining slabs: bit for bit the uninterrupted run, since the
  device-to-host round trip is exact and the slabs fold in the same order.

Counters of all of this (:class:`StreamCounters`) ride on every
``profiling.StreamReport``. The deterministic fault harness is
:mod:`flox_tpu_torch.faults`.

Left out (ROADMAP A9, with the telemetry plane): the flight-recorder dump on
a fatal classification and the telemetry counters and events. The snapshot
key has no trace fingerprint (nothing is traced); the mesh layout of
``device_restore`` comes with A8b.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .multiarray import MultiArray

__all__ = [
    "DEVICE_LOST",
    "FATAL",
    "OOM",
    "TRANSIENT",
    "HighCardinalityOOMError",
    "RetryPolicy",
    "Snapshot",
    "StreamCheckpointer",
    "StreamCounters",
    "call_with_retry",
    "classify_error",
    "device_restore",
    "dispatch_slab",
    "register_transient",
    "seed_backoff",
]


class HighCardinalityOOMError(RuntimeError):
    """The OOM ladder bottomed out on an allocation that splitting cannot
    shrink: dense per-group accumulators sized by the label universe. Its
    message names the remedy (the sort engine); classified FATAL."""


TRANSIENT = "transient"
OOM = "oom"
FATAL = "fatal"
#: the device, or its context, is gone: neither a retry nor a split can help
DEVICE_LOST = "device_lost"

# exception types retried as transient: the loader IO family (OSError covers
# IOError, TimeoutError, ConnectionError, BrokenPipeError). Programming
# errors (TypeError, ValueError, KeyError, ...) are fatal by exclusion.
_TRANSIENT_TYPES: list[type] = [OSError]

# OSError subclasses that are configuration errors, not weather: a wrong path
# never succeeds on retry. register_transient opts one back in.
_NON_RECOVERABLE_OS: tuple[type, ...] = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
)

_OOM_TOKENS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
_TRANSIENT_TOKENS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED")
_DEVICE_LOSS_TOKENS = (
    "DEVICE_LOST", "device lost", "Device lost", "backend is dead",
    "device is in an invalid state",
)
# CUDA errors that poison the context for the rest of the process
_STICKY_CUDA_TOKENS = (
    "an illegal memory access was encountered",
    "unspecified launch failure",
    "device-side assert triggered",
    "misaligned address",
    "an illegal instruction was encountered",
    "CUDA error: uncorrectable ECC error",
)


def _sticky_types() -> tuple[type, ...]:
    acc = getattr(torch, "AcceleratorError", None)  # torch >= 2.8
    return (acc,) if isinstance(acc, type) else ()


def register_transient(exc_type: type) -> None:
    """Teach the classifier a loader SDK's exception type to retry (e.g. a
    cloud store's throttling error). Process-global, additive."""
    if not (isinstance(exc_type, type) and issubclass(exc_type, BaseException)):
        raise TypeError(f"register_transient expects an exception type, got {exc_type!r}")
    if exc_type not in _TRANSIENT_TYPES:
        _TRANSIENT_TYPES.append(exc_type)


def classify_error(exc: BaseException) -> str:
    """``transient`` | ``oom`` | ``device_lost`` | ``fatal`` for one exception.

    The one gate of every retry and degradation path. A ``fatal`` verdict on
    the outer exception is re-checked down its ``__cause__``/``__context__``
    chain: a transient ``OSError`` that a wrapper re-raised as a generic
    ``RuntimeError`` stays transient. Only fatal softens this way.
    """
    if isinstance(exc, HighCardinalityOOMError):
        # terminal by construction: its cause IS an OOM, but the ladder proved
        # that splitting cannot shrink the allocation
        return FATAL
    cls = _classify_one(exc)
    if cls != FATAL:
        return cls
    seen: set[int] = {id(exc)}
    queue: list[BaseException] = [exc]
    for _ in range(8):  # bounded: chains are short, and cycles exist
        if not queue:
            break
        current = queue.pop(0)
        for link in (current.__cause__, current.__context__):
            if link is None or id(link) in seen:
                continue
            seen.add(id(link))
            inner = _classify_one(link)
            if inner != FATAL:
                return inner
            queue.append(link)
    return FATAL


def _classify_one(exc: BaseException) -> str:
    """Classification of one exception, ignoring its chain."""
    msg = str(exc)
    if isinstance(exc, HighCardinalityOOMError):
        return FATAL
    if isinstance(exc, _sticky_types()) or (
            isinstance(exc, RuntimeError) and any(t in msg for t in _STICKY_CUDA_TOKENS)):
        # checked before OOM: a dead context must never enter the ladder
        return DEVICE_LOST
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        # the caching allocator's OOM (by type), or a host allocation: a
        # half-size slab needs half the memory
        return OOM
    if isinstance(exc, RuntimeError):
        if any(tok in msg for tok in _DEVICE_LOSS_TOKENS):
            return DEVICE_LOST
        if any(tok in msg for tok in _OOM_TOKENS):
            # faults.SimulatedOOM, and CUDA's own "out of memory" outside the
            # caching allocator
            return OOM
        if type(exc).__name__ == "DistBackendError" and any(
                tok in msg for tok in _TRANSIENT_TOKENS):
            return TRANSIENT
    if isinstance(exc, _NON_RECOVERABLE_OS) and not any(
            t is not OSError and isinstance(exc, t) for t in _TRANSIENT_TYPES):
        return FATAL
    if isinstance(exc, tuple(_TRANSIENT_TYPES)):
        return TRANSIENT
    return FATAL


#: jitter source of the retry backoff, module-level so that the fault tests
#: can pin it (:func:`seed_backoff`) and replay a run's sleep schedule
_BACKOFF_RNG = random.Random()


def seed_backoff(seed: Any = None) -> None:
    """Seed the backoff jitter (tests); unseeded, the staging workers
    de-synchronize on OS entropy."""
    _BACKOFF_RNG.seed(seed)


@dataclass(frozen=True)
class RetryPolicy:
    """Retry knobs of one stream, frozen at its start: ``retries`` extra
    attempts per slab, ``backoff`` the base sleep in seconds, ``timeout`` the
    per-slab deadline over all attempts and backoffs (0: none). Attempt k
    sleeps ``uniform(0, backoff * 2**k)`` (full jitter), so workers that hit
    one fault together do not retry together."""

    retries: int = 2
    backoff: float = 0.05
    timeout: float = 0.0

    @classmethod
    def from_options(cls) -> "RetryPolicy":
        from .options import OPTIONS

        return cls(retries=OPTIONS["stream_retries"], backoff=OPTIONS["stream_backoff"],
                   timeout=OPTIONS["stream_slab_timeout"])

    def delay(self, attempt: int) -> float:
        cap = self.backoff * (2.0**attempt)
        if cap <= 0:
            return 0.0
        # never exactly 0 (no de-synchronization) and never the full cap
        u = _BACKOFF_RNG.random()
        return cap * (u if u > 0.0 else 0.5)


def call_with_retry(fn: Callable[[], Any], *, policy: RetryPolicy,
                    counters: "StreamCounters | None" = None, what: str = "") -> Any:
    """Run ``fn``, retrying transient failures with exponential backoff.

    Fatal, device-lost and oom classifications raise at once (oom belongs to
    the dispatch-side ladder). When retries run out the original exception
    re-raises unchanged; when the next backoff would cross the per-slab
    deadline, a ``TimeoutError`` chained from it raises instead.
    """
    deadline = time.monotonic() + policy.timeout if policy.timeout > 0 else None
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            if classify_error(exc) != TRANSIENT:
                raise
            if attempt >= policy.retries:
                raise
            delay = policy.delay(attempt)
            if deadline is not None and time.monotonic() + delay >= deadline:
                raise TimeoutError(
                    f"slab {what}: stream_slab_timeout of {policy.timeout:g}s "
                    f"exceeded after {attempt + 1} attempt(s)"
                ) from exc
            attempt += 1
            if counters is not None:
                counters.record_retry(delay)
            time.sleep(delay)


@dataclass
class StreamCounters:
    """Resilience counters of one streaming run, shared by the staging
    workers (retries), the dispatch guard (splits) and the checkpointer, and
    attached to every ``StreamReport`` of the run."""

    retries: int = 0
    backoff_ms: float = 0.0
    oom_splits: int = 0
    checkpoints: int = 0
    #: stream-order slab cursor this run resumed from (None: a fresh run)
    resumed_at: int | None = None
    #: phase resumed into (multi-pass runs: 0 = the first pass)
    resumed_phase: int | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def record_retry(self, delay_s: float) -> None:
        with self._lock:
            self.retries += 1
            self.backoff_ms += delay_s * 1e3

    def record_split(self) -> None:
        with self._lock:
            self.oom_splits += 1

    def record_checkpoint(self) -> None:
        with self._lock:
            self.checkpoints += 1


# ---------------------------------------------------------------------------
# OOM degradation: halve and re-stage on a power-of-two ladder
# ---------------------------------------------------------------------------


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def _ladder_half(length: int, quantum: int) -> int:
    """Sub-slab span of one split rung: half the span, rounded up to a power
    of two and to the shard quantum; when the quantum rounding reaches
    ``length`` itself, the largest quantum multiple strictly below it, so
    the ladder keeps descending while a legal split exists."""
    half = _pow2_ceil((length + 1) // 2)
    if quantum > 1:
        half = -(-half // quantum) * quantum
        if half >= length:
            half = ((length - 1) // quantum) * quantum
    return half


def _drop_failed(exc: BaseException, sl: Any = None) -> None:
    """Release what pins the failed step's device memory before the halves
    run: the traceback's frames (which hold the step's tensors) and the
    failed slab's device copy."""
    exc.__traceback__ = None
    if sl is not None and hasattr(sl, "release"):
        sl.release()


def dispatch_slab(apply_fn: Callable[[Any, Any], Any], carry: Any, sl: Any, *,
                  stager: Any = None, counters: StreamCounters | None = None,
                  shard_quantum: int = 1, reverse: bool = False,
                  highcard_hint: str | None = None) -> Any:
    """Run one slab step, ``apply_fn(carry, slab) -> carry``, with the fault
    hook and the OOM ladder.

    On an oom classification the slab's span is re-staged through
    ``stager`` (the ``pipeline.SlabStager`` that staged it) as sub-slabs of
    half the span, folded through ``apply_fn`` one by one (in reverse span
    order for reversed streams, so scan carries hold); a sub-slab that still
    runs out splits again, down to single columns. ``stager=None`` disables
    splitting. Other errors propagate. ``apply_fn`` must leave the carry as
    it was when it raises: the halves fold into the same carry.

    ``highcard_hint``: set when the accumulators are dense over a label
    universe past ``sort_engine_min_groups``; when the ladder bottoms out the
    OOM re-raises as :class:`HighCardinalityOOMError` carrying the hint.
    """
    from . import faults

    try:
        faults.poke(sl.start, sl.stop)
        if getattr(sl, "error", None) is not None:
            raise sl.error  # the slab ran out of memory while it was staged
        return apply_fn(carry, sl)
    except Exception as exc:
        if classify_error(exc) != OOM or stager is None:
            raise
        _drop_failed(exc, sl)
        return _split_dispatch(apply_fn, carry, sl.start, sl.stop, stager, counters=counters,
                               quantum=shard_quantum, reverse=reverse, cause=exc,
                               highcard_hint=highcard_hint)


def _split_dispatch(apply_fn, carry, s, e, stager, *, counters, quantum, reverse, cause,
                    depth=0, highcard_hint=None):
    from . import faults

    length = e - s
    half = _ladder_half(length, quantum)
    if length <= max(1, quantum) or half >= length or depth >= 48:
        # cannot split further: the failing allocation does not scale with
        # the span. (The message carries no OOM token, so the classifier
        # cannot send it back into the ladder.)
        if highcard_hint:
            raise HighCardinalityOOMError(
                f"the slab-split ladder bottomed out at span [{s}:{e}) but the step still "
                f"exhausts device memory: {highcard_hint}"
            ) from cause
        raise cause
    if counters is not None:
        counters.record_split()
    spans = [(ss, min(ss + half, e)) for ss in range(s, e, half)]
    for ss, ee in reversed(spans) if reverse else spans:
        sub = None
        try:
            # staging inside the try: a sub-slab whose copy itself runs out
            # of memory splits again, as a failing step does
            sub = stager.stage_range(ss, ee)
            faults.poke(ss, ee)
            carry = apply_fn(carry, sub)
        except Exception as exc:
            if classify_error(exc) != OOM:
                raise
            _drop_failed(exc, sub)
            carry = _split_dispatch(apply_fn, carry, ss, ee, stager, counters=counters,
                                    quantum=quantum, reverse=reverse, cause=exc,
                                    depth=depth + 1, highcard_hint=highcard_hint)
        finally:
            if sub is not None:
                sub.release()
            sub = None
    return carry


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    """Map over the tensor leaves of a carry: tuples, lists, MultiArrays and
    None."""
    if tree is None:
        return None
    if isinstance(tree, MultiArray):
        return MultiArray(_tree_map(fn, a) for a in tree.arrays)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _to_host(t):
    return t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) else t


@dataclass
class Snapshot:
    """One host-side checkpoint of a stream: the carry (CPU tensors, exact
    copies of the device state), the stream-order slab cursor it covers, and
    the phase of a multi-pass run (quantile: 0 = the count pass, 1 + i = bit
    pass i)."""

    key: tuple
    phase: int
    slabs_done: int
    payload: Any


#: in-process snapshot registry, keyed by the stream identity
_SNAPSHOTS: dict[tuple, Snapshot] = {}


class StreamCheckpointer:
    """Periodic host-side snapshots of a streaming run's carry.

    Disabled (every method a no-op) unless ``stream_checkpoint_every > 0``.
    The stream identity key comes from the run's semantic shape (kind,
    aggregation, n, batch_len, size, a fingerprint of the codes and of the
    first element of the data), so a re-invoked identical call finds its
    predecessor's snapshot; with ``stream_checkpoint_path`` set, snapshots
    also spill to a checksummed ``.npz`` that survives the process.
    ``done()`` removes the snapshot once the run completes.
    """

    def __init__(self, key: tuple | None, *, every: int | None = None, path: str | None = None,
                 counters: StreamCounters | None = None) -> None:
        from .options import OPTIONS

        self.every = OPTIONS["stream_checkpoint_every"] if every is None else every
        self.path = OPTIONS["stream_checkpoint_path"] if path is None else path
        self.key = key
        self.counters = counters
        self.enabled = key is not None and self.every > 0
        self._ticks = 0

    @classmethod
    def for_stream(cls, *, kind: str, name: str, n: int, batch_len: int, size: int,
                   codes: np.ndarray, lead_shape: tuple = (), extra: tuple = (),
                   data_probe: Any = None, counters: StreamCounters | None = None,
                   enabled: bool = True) -> "StreamCheckpointer":
        from .options import OPTIONS

        if not enabled or OPTIONS["stream_checkpoint_every"] <= 0:
            return cls(None, counters=counters)  # no fingerprints when off
        fp = hashlib.blake2b(np.ascontiguousarray(codes).tobytes(), digest_size=8).hexdigest()
        # data tripwire: a rerun after the data changed at position 0 misses
        # the stale snapshot (a cursor checkpoint must assume the input is
        # immutable for the run's lifetime; this catches fixed-and-rerun)
        probe_fp = None
        if data_probe is not None:
            probe_fp = hashlib.blake2b(
                np.ascontiguousarray(np.asarray(data_probe)).tobytes(), digest_size=8
            ).hexdigest()
        key = (kind, str(name), int(n), int(batch_len), int(size), tuple(lead_shape), fp,
               probe_fp, tuple(extra))
        return cls(key, counters=counters)

    def restore(self) -> Snapshot | None:
        """The latest snapshot of this stream (registry first, then the spill
        file), or None for a fresh run."""
        if not self.enabled:
            return None
        snap = _SNAPSHOTS.get(self.key)
        if snap is None and self.path:
            snap = _load_snapshot(self._file(), self.key)
            if snap is not None:
                _SNAPSHOTS[self.key] = snap
        if snap is not None and self.counters is not None:
            self.counters.resumed_at = snap.slabs_done
            self.counters.resumed_phase = snap.phase
        return snap

    def tick(self, payload_fn: Callable[[], Any], *, slabs_done: int, phase: int = 0) -> None:
        """Count one processed slab; snapshot every ``every`` ticks
        (``payload_fn`` is called only then)."""
        if not self.enabled:
            return
        self._ticks += 1
        if self._ticks % self.every:
            return
        self.save(payload_fn(), slabs_done=slabs_done, phase=phase)

    def save(self, payload: Any, *, slabs_done: int, phase: int = 0) -> None:
        if not self.enabled:
            return
        snap = Snapshot(key=self.key, phase=phase, slabs_done=slabs_done,
                        payload=_tree_map(_to_host, payload))
        _SNAPSHOTS[self.key] = snap
        if self.path:
            _dump_snapshot(self._file(), snap)
        if self.counters is not None:
            self.counters.record_checkpoint()

    def done(self) -> None:
        """The run completed: drop its snapshot (registry and spill file)."""
        if not self.enabled:
            return
        _SNAPSHOTS.pop(self.key, None)
        if self.path:
            try:
                os.unlink(self._file())
            except OSError:
                pass

    def _file(self) -> str:
        path = str(self.path)
        if path.endswith(".npz"):
            return path
        h = hashlib.blake2b(repr(self.key).encode(), digest_size=8).hexdigest()
        return os.path.join(path, f"flox-torch-stream-{h}.npz")


def _leaf_array(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: its bits travel as int16
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _dump_snapshot(path: str, snap: Snapshot) -> None:
    from .store import write_checksummed_npz

    leaves = _tree_leaves(snap.payload)
    arrays = {f"leaf{i}": _leaf_array(leaf) for i, leaf in enumerate(leaves)}
    dtypes = [str(leaf.dtype) for leaf in leaves]
    count = iter(range(len(leaves)))
    skeleton = _tree_map(lambda _leaf: next(count), snap.payload)
    meta = pickle.dumps((snap.key, snap.phase, snap.slabs_done, skeleton, dtypes))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    # checksummed, landed tmp -> fsync -> rename: a torn or bit-flipped spill
    # is detected at restore instead of loading wrong state
    write_checksummed_npz(path, {"__meta__": np.frombuffer(meta, dtype=np.uint8), **arrays},
                          {"kind": "stream-checkpoint"})


def _load_snapshot(path: str, key: tuple) -> Snapshot | None:
    """A spilled snapshot; None when missing, corrupt, or of another stream.
    A damaged spill warns before the stream restarts fresh. The meta block is
    a pickle this module wrote: the spill path is operator-controlled state,
    not untrusted input."""
    from .store import StoreCorruptionError, read_checksummed_npz

    try:
        z, _ = read_checksummed_npz(path)
    except FileNotFoundError:
        return None
    except StoreCorruptionError as exc:
        import warnings

        warnings.warn(f"stream checkpoint {os.path.basename(path)} is corrupt or unreadable; "
                      f"restarting the stream fresh ({exc})", RuntimeWarning, stacklevel=2)
        return None
    try:
        skey, phase, done, skeleton, dtypes = pickle.loads(z["__meta__"].tobytes())
        if skey != key:
            return None

        def leaf(i):
            t = torch.from_numpy(np.array(z[f"leaf{i}"]))
            return t.view(torch.bfloat16) if dtypes[i] == "torch.bfloat16" else t

        payload = _tree_map(leaf, skeleton)
    except Exception:
        # "a corrupt or mismatched spill is ignored, never trusted": an
        # unpickling failure of any kind means a fresh run
        return None
    return Snapshot(key=key, phase=phase, slabs_done=done, payload=payload)


def device_restore(payload: Any, device: Any) -> Any:
    """Host snapshot payload -> the carry on ``device``."""
    return _tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, payload)
