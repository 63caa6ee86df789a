"""Pipelined streaming executor: prefetched host-to-device staging (the port
of ``flox_tpu/pipeline.py``).

* :func:`stream_slabs` is the one slab source of the streaming runtimes
  (reduce, scan, quantile). It stages slab ``i+k`` while the device reduces
  slab ``i``; prefetch changes only *when* staging happens, never which
  bytes land on the device, so every prefetch depth gives the same bits.
* :class:`SlabStager` stages one ``[s, e)`` range. On a CUDA device the
  loader's slab is copied (``np.copyto``, which releases the GIL) into a
  pinned host buffer taken from a ring allocated once per stream, then
  copied to the card with ``non_blocking=True`` on a side
  ``torch.cuda.Stream``; an event recorded after the copy is what the
  compute stream waits on before the slab's kernels run (:meth:`Slab.ready`),
  and the device slab is ``record_stream``-ed onto the compute stream so
  that the caching allocator cannot hand its memory out while a kernel still
  reads it. A pinned buffer is refilled only after the copy event that read
  it has completed. Pinning or the side stream failing raises: there is no
  quiet fallback to pageable, synchronous copies. The codes go to the device
  once per stream; a slab's codes are a view of them. On the CPU
  (``device="cpu"``) a slab is the loader's array as a tensor and none of
  this machinery runs.
* The prefetch stage is a bounded pool: at most ``stream_prefetch`` slabs in
  flight, staged by that many threads; a loader exception re-raises on the
  consumer at the failing slab's position, and nothing is left running.
* :class:`DispatchThrottle` synchronizes on a CUDA event every
  ``stream_dispatch_depth`` slabs, so the host cannot run far ahead of the
  card.

The reference's ``maybe_donate``/``donation_supported`` and the static-shape
padding of the tail slab have no counterpart: nothing is traced, and the
carry is updated in place. Left out until ROADMAP A9: the telemetry spans,
cost ledger and autotune observations of a pass; the sharded staging of
``mesh=`` comes with A8b.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from time import perf_counter
from typing import Any, Callable, Iterator

import numpy as np
import torch

from . import utils

__all__ = [
    "DispatchThrottle",
    "Slab",
    "SlabStager",
    "prefetch_occupancy",
    "stream_slabs",
]

# slabs in flight (staging, or staged and awaiting the consumer) over every
# live prefetcher of the process
_PREFETCH_INFLIGHT: list[int] = [0]
_PREFETCH_LOCK = threading.Lock()


def prefetch_occupancy() -> int:
    """How many slabs the prefetch pools hold in flight right now."""
    return max(0, _PREFETCH_INFLIGHT[0])


def _prefetch_track(delta: int) -> None:
    with _PREFETCH_LOCK:
        _PREFETCH_INFLIGHT[0] += delta


@dataclass
class Slab:
    """One staged slab: its data and codes on the device, and host metadata.
    ``offset`` is the slab's start along the streamed axis (positions of the
    argreductions and first/last)."""

    index: int
    start: int
    stop: int
    data: Any
    codes: Any
    codes_host: np.ndarray
    offset: int = 0
    load_ms: float = 0.0
    stage_ms: float = 0.0
    wait_ms: float = 0.0
    dispatch_ms: float = 0.0
    nbytes: int = 0
    event: Any = field(default=None, repr=False)
    #: an out-of-memory error raised while staging this slab in a prefetch
    #: worker: ``resilience.dispatch_slab`` raises it where the step would
    #: run, so that the halving ladder re-stages the span in halves
    error: BaseException | None = field(default=None, repr=False)

    def ready(self) -> "Slab":
        """Make the caller's current (compute) stream wait for this slab's
        copy, and tie the device slab's memory to that stream."""
        if self.event is not None:
            compute = torch.cuda.current_stream(self.data.device)
            compute.wait_event(self.event)
            self.data.record_stream(compute)
            self.event = None
        return self

    def release(self) -> None:
        """Drop the device references (the report keeps only timings)."""
        self.data = self.codes = self.event = self.error = None


class _PinnedRing:
    """Pinned host buffers of one stream, allocated on demand up to
    ``limit`` and reused; a buffer is handed out again only after the copy
    that read it has completed."""

    def __init__(self, nelems: int, dtype: torch.dtype) -> None:
        self.nelems = nelems
        self.dtype = dtype
        self.limit = 1
        self._free: list = []
        self._count = 0
        self._cond = threading.Condition()

    def take(self):
        with self._cond:
            while not self._free and self._count >= self.limit:
                self._cond.wait()
            if self._free:
                buf = self._free.pop()
            else:
                t = torch.empty(self.nelems, dtype=self.dtype, pin_memory=True)
                if not t.is_pinned():
                    raise RuntimeError("could not pin the streaming staging buffer")
                buf = [t, None]  # [buffer, event of the last copy out of it]
                self._count += 1
        if buf[1] is not None:
            buf[1].synchronize()  # never refill before the copy that reads it ends
        return buf

    def give(self, buf) -> None:
        with self._cond:
            self._free.append(buf)
            self._cond.notify()


class SlabStager:
    """The one staging implementation: load an arbitrary ``[s, e)`` range,
    check the loader contract and move it to ``device``, retrying transient
    failures under the stream's ``RetryPolicy`` (``stream_retries`` /
    ``stream_backoff`` / ``stream_slab_timeout``, frozen at construction).

    :func:`stream_slabs` stages through it, and ``resilience.dispatch_slab``
    re-stages OOM-split sub-slabs through the same object. Retries run in
    whatever thread stages the slab, so one flaky slab never poisons the
    others queued in the prefetch pool.
    """

    def __init__(self, loader: Callable[[int, int], Any], codes: np.ndarray, *, n: int,
                 batch_len: int, lead_shape: tuple, device: Any,
                 counters: Any = None) -> None:
        from .resilience import RetryPolicy

        self.loader = loader
        self.codes = codes
        self.n = n
        self.batch_len = batch_len
        self.lead = tuple(lead_shape)
        self.device = torch.device(device)
        self.counters = counters
        self.policy = RetryPolicy.from_options()
        self._dtype0: Any = None
        self._lock = threading.Lock()
        self._ring: _PinnedRing | None = None
        self._ring_limit = 2
        self._side = None
        self.codes_dev = torch.as_tensor(np.ascontiguousarray(codes, dtype=np.int32),
                                         device=self.device)
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(device=self.device)

    def set_depth(self, depth: int) -> None:
        """Let ``depth`` staging workers fill buffers while one copy runs."""
        self._ring_limit = max(1, depth) + 1
        if self._ring is not None:
            self._ring.limit = max(self._ring.limit, self._ring_limit)

    def stage_index(self, i: int) -> Slab:
        """Stage batch ``i`` (a prefetch worker's call). A slab that does not
        fit comes back carrying its out-of-memory error instead of raising
        here, where no ladder could split it."""
        from .resilience import OOM, classify_error

        s, e = i * self.batch_len, min((i + 1) * self.batch_len, self.n)
        try:
            return self.stage_range(s, e, index=i, consumer=False)
        except Exception as exc:
            if classify_error(exc) != OOM:
                raise
            exc.__traceback__ = None  # its frames hold the failed staging's buffers
            return Slab(index=i, start=s, stop=e, data=None, codes=None,
                        codes_host=self.codes[s:e], offset=s, error=exc)

    def stage_range(self, s: int, e: int, index: int = -1, consumer: bool = True) -> Slab:
        """Stage ``[s, e)``. ``consumer``: the caller runs the slab's step
        itself, so the slab comes back :meth:`Slab.ready`."""
        from .resilience import call_with_retry

        slab = call_with_retry(lambda: self._stage_once(s, e, index), policy=self.policy,
                               counters=self.counters, what=f"[{s}:{e})")
        return slab.ready() if consumer else slab

    def _stage_once(self, s: int, e: int, index: int) -> Slab:
        t0 = perf_counter()
        host = np.asarray(self.loader(s, e))
        self._check_contract(host, s, e)
        codes = self.codes_dev[s:e]
        if self._side is None:
            data = torch.from_numpy(np.ascontiguousarray(host))
            t1 = perf_counter()
            return Slab(index=index, start=s, stop=e, data=data, codes=codes,
                        codes_host=self.codes[s:e], offset=s, load_ms=(t1 - t0) * 1e3,
                        nbytes=host.nbytes)
        ring = self._pinned_ring(host.dtype)
        buf = ring.take()
        try:
            pinned = buf[0][: host.size].view(host.shape)
            np.copyto(pinned.numpy(), host, casting="no")
            t1 = perf_counter()
            with torch.cuda.stream(self._side):
                data = torch.empty(host.shape, dtype=pinned.dtype, device=self.device)
                data.copy_(pinned, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._side)
            buf[1] = event
        finally:
            ring.give(buf)
        t2 = perf_counter()
        return Slab(index=index, start=s, stop=e, data=data, codes=codes,
                    codes_host=self.codes[s:e], offset=s, load_ms=(t1 - t0) * 1e3,
                    stage_ms=(t2 - t1) * 1e3, nbytes=host.nbytes, event=event)

    def _pinned_ring(self, dtype: np.dtype) -> _PinnedRing:
        with self._lock:
            if self._ring is None:
                nelems = math.prod(self.lead) * self.batch_len
                self._ring = _PinnedRing(nelems, utils.torch_dtype(dtype))
                self._ring.limit = self._ring_limit
            return self._ring

    def _check_contract(self, slab: np.ndarray, s: int, e: int) -> None:
        """A drifting shape or dtype raises a ``ValueError`` naming the slab
        range here, not an obscure error deep in a kernel. ValueError is
        fatal: a contract break never burns retries."""
        want = self.lead + (e - s,)
        if tuple(slab.shape) != want:
            raise ValueError(
                f"loader contract violation for slab [{s}:{e}): returned shape "
                f"{tuple(slab.shape)}, expected {want} (lead dims {self.lead} + the "
                "requested span)")
        with self._lock:
            if self._dtype0 is None:
                self._dtype0 = slab.dtype
            elif slab.dtype != self._dtype0:
                raise ValueError(
                    f"loader contract violation for slab [{s}:{e}): dtype {slab.dtype} != "
                    f"{self._dtype0} from the first loaded slab")


def stream_slabs(stager: SlabStager, *, reverse: bool = False, prefetch: int | None = None,
                 label: str = "", skip: int = 0) -> Iterator[Slab]:
    """Yield staged, ready :class:`Slab` objects for every batch of
    ``[0, stager.n)``.

    ``reverse`` streams the slabs back to front (bfill). ``prefetch=None``
    reads ``stream_prefetch``; ``0`` stages inline. ``skip`` drops the first
    k slabs in stream order (checkpoint resume: for a reversed stream the
    last k batches). Each pass emits one ``profiling.StreamReport``.
    """
    from .options import OPTIONS
    from .profiling import StreamReport, record_stream

    depth = OPTIONS["stream_prefetch"] if prefetch is None else prefetch
    n, batch_len = stager.n, stager.batch_len
    nbatches = math.ceil(n / batch_len) if n else 0
    order_full = range(nbatches - 1, -1, -1) if reverse else range(nbatches)
    order = order_full[skip:] if skip else order_full
    stager.set_depth(depth)

    report = StreamReport(label=label, prefetch=depth, nbatches=nbatches,
                          counters=stager.counters)
    prefetcher = None
    if depth > 0 and len(order) > 1:
        prefetcher = _SlabPrefetcher(stager.stage_index, order, depth)
        source: Iterator[Slab] = iter(prefetcher)
    else:
        source = (stager.stage_index(i) for i in order)
    t_begin = perf_counter()
    try:
        while True:
            t0 = perf_counter()
            try:
                slab = next(source)
            except StopIteration:
                break
            slab.ready()
            # inline staging ran inside next(): then wait is the whole staging
            slab.wait_ms = (perf_counter() - t0) * 1e3
            t_yield = perf_counter()
            yield slab
            slab.dispatch_ms = (perf_counter() - t_yield) * 1e3
            report.nbytes += slab.nbytes
            slab.release()
            report.slabs.append(slab)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        report.wall_ms = (perf_counter() - t_begin) * 1e3
        record_stream(report)


class _SlabPrefetcher:
    """Bounded in-order prefetch over a staging function: at most ``depth``
    slabs in flight, delivered in stream order; a staging exception re-raises
    on the consumer at its position, and ``close`` cancels what is pending."""

    def __init__(self, stage: Callable[[int], Slab], indices: Any, depth: int) -> None:
        self._stage = stage
        self._indices = iter(indices)
        self._pending: deque[Future] = deque()
        self._pool: ThreadPoolExecutor | None = ThreadPoolExecutor(
            max_workers=depth, thread_name_prefix="flox-torch-stage")
        for _ in range(depth):
            self._submit_next()

    def _submit_next(self) -> None:
        if self._pool is None:
            return
        try:
            i = next(self._indices)
        except StopIteration:
            return
        self._pending.append(self._pool.submit(self._stage, i))
        _prefetch_track(1)

    def __iter__(self) -> "_SlabPrefetcher":
        return self

    def __next__(self) -> Slab:
        if not self._pending:
            self.close()
            raise StopIteration
        fut = self._pending.popleft()
        _prefetch_track(-1)
        self._submit_next()
        try:
            return fut.result()
        except BaseException:
            self.close()  # surface the failure now and tear the pool down
            raise

    def close(self) -> None:
        if self._pool is None:
            return
        for fut in self._pending:
            fut.cancel()
        _prefetch_track(-len(self._pending))
        self._pending.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._pool = None


@dataclass
class DispatchThrottle:
    """Bound the slab steps in flight: every ``depth`` ticks, wait on a CUDA
    event recorded after the last step. ``0`` disables it, as does a CPU
    carry; ``depth=None`` reads ``stream_dispatch_depth``."""

    depth: int | None = None
    _ticks: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        if self.depth is None:
            from .options import OPTIONS

            self.depth = OPTIONS["stream_dispatch_depth"]

    def tick(self, device: torch.device) -> None:
        if not self.depth or device.type != "cuda":
            return
        self._ticks += 1
        if self._ticks % self.depth == 0:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
