"""Out-of-core grouped reductions and scans: host slabs stream through
per-group accumulators on the device (the port of ``flox_tpu/streaming.py``,
single-device).

The array lives in host memory, or behind a loader ``callable(start, stop)``
(zarr, a memmap, a file reader); slabs of the streamed (last) axis go to the
device one at a time through :mod:`.pipeline` (pinned buffers, a side copy
stream, prefetch), and dense per-group intermediates accumulate on the device
through the same pairwise merges the mesh runtime applies collectively. The
device holds a few slabs and the (..., size) accumulators, never the array.

* The per-slab step is a plain function: the eager kernels on the slab
  (``parallel.mapreduce._local_stage`` / ``_local_firstlast``, so a nanmean
  slab is one segment-sum launch), then a merge into the carry, which is
  updated in place (computed first, copied into the carry after, so that a
  step that runs out of memory leaves the carry as it was for the halving
  ladder of ``resilience.dispatch_slab``). The variance merge is the Chan
  update.
* Exact quantiles and medians stream as ``nbits + 1`` counting passes of the
  radix select (:func:`_stream_quantile`): the data is read that many times.
* Scans carry a per-group running value from slab to slab;
  ``bfill`` streams the slabs in reverse; an ``out=`` writer takes each
  result slab on the host as it is made.

* ``mesh=``: each slab splits over the mesh's ``axis_name`` dims and each
  rank stages and folds only its own columns (a loader is called with the
  rank's own range), with no collective until one combine at the end (the
  in-memory mesh's combine); above the dense-intermediate ceiling additive
  reductions take the blocked owner-by-owner form; quantile passes sum
  their counts over the ranks; scans run the mesh Blelloch step per slab.

Telemetry sees the reference's spans (``streaming_groupby_*`` over
``factorize``, one ``stream[...]`` span per pass, and ``finalize``), and
each pass is a cost-ledger row with its device time and cost card
(``pipeline.stream_slabs``). The reference's jit machinery has no
counterpart (``_step_cached``, the step cache, buffer donation, the padding
of the tail slab to a static shape). With the autotuner on, a stream that
names no ``batch_len``, no ``batch_bytes`` and no checkpoint path takes the
observed-best slab budget for its size band, and the dense-or-sort routing
consults the ``highcard`` family. The ranks of a mesh stream are separate
processes with stores of their own: they agree on both (the smallest budget;
the sort carry if any rank picks it) before the first slab, since a slab's
shards and the collectives of a pass must be the same on every rank. The
prefetch depth each rank picks for itself only changes when its staging
happens.
"""

from __future__ import annotations

import math
import sys
from typing import Any, Callable

import numpy as np
import torch

from . import dtypes as dtps, factorize as fct, kernels, telemetry, utils
from .aggregations import Aggregation, _initialize_aggregation, plan_fused
from .multiarray import MultiArray
from .options import OPTIONS

__all__ = [
    "streaming_groupby_aggregate_many",
    "streaming_groupby_reduce",
    "streaming_groupby_scan",
]

#: the "no candidate" global position of first (int64, as the mesh runtime)
_BIG = np.iinfo(np.int64).max

#: slab byte budget when the caller passes neither batch_len nor batch_bytes
_DEFAULT_BATCH_BYTES = 256 * 2**20

_ADDLIKE = frozenset({"sum", "nansum", "prod", "nanprod"})
_FLOAT_FUNCS = frozenset({"mean", "nanmean", "var", "nanvar", "std", "nanstd"})


def _stream_mesh(mesh, axis_name, device) -> tuple[torch.device, Any]:
    """The device of a stream and, with ``mesh=``, the collectives of its
    ``axis_name`` dims (None without a mesh)."""
    if mesh is None:
        return utils.resolve_device(device), None
    from .parallel.mapreduce import resolve_mesh
    from .parallel.mesh import collectives

    mesh, dev = resolve_mesh(mesh, device)
    return dev, collectives(mesh, axis_name)


def _mesh_batch_len(batch_len: int, comm) -> int:
    """The slab layout of a mesh stream (the reference's
    ``_mesh_stream_layout``): ``batch_len`` rounds up to a multiple of the
    shard count, so every full slab splits into equal shards; rank d holds
    columns ``[s + d*L, s + (d+1)*L)`` of the slab at ``s``, and the tail
    slab splits by ``parallel.mesh.shard_bounds`` (``pipeline.SlabStager``
    with ``shard=``)."""
    return batch_len if comm is None else -(-batch_len // comm.size) * comm.size


def _mesh_key(comm, *extra) -> tuple | None:
    """A mesh rank's part of its checkpoint key: the layout, its rank and
    the world size."""
    if comm is None:
        return None
    from .parallel.mesh import world_size

    return (comm.axes, comm.size, comm.index, world_size()) + extra


def streaming_groupby_reduce(
    array: Any,
    by: Any,
    *,
    func: str | Aggregation,
    batch_len: int | None = None,
    batch_bytes: int | None = None,
    expected_groups: Any = None,
    isbin: Any = False,
    sort: bool = True,
    axis: Any = None,
    fill_value: Any = None,
    dtype: Any = None,
    min_count: int | None = None,
    finalize_kwargs: dict | None = None,
    mesh: Any = None,
    axis_name: str | tuple[str, ...] = "data",
    engine: str | None = None,
    device: Any = None,
) -> tuple:
    """Grouped reduction streaming slabs to the device.

    ``array``: a host array ``(..., *by.shape)`` or a loader
    ``callable(start, stop) -> np.ndarray`` of ``(..., stop - start)`` slabs;
    with a loader, ``by`` holds 1-D labels of the whole axis. Returns
    ``(result, *groups)`` as :func:`flox_tpu_torch.groupby_reduce` does, the
    result on ``device`` (``cuda`` unless the caller asks for the CPU).

    nD ``by`` and ``axis=`` (a subset of the by-span) work for host arrays:
    kept dims fold into disjoint code ranges, so the stream walks one flat
    axis. Every aggregation with chunk legs streams, and so do exact
    quantiles and medians (``nbits + 1`` passes over the data); ``mode``
    does not. ``batch_len`` columns a slab, or as many as fit
    ``batch_bytes`` (default 256 MiB).

    ``mesh=`` (a ``parallel.make_mesh`` mesh; every rank calls with the same
    arguments): each slab splits over the ``axis_name`` dims, and each rank
    stages only its own columns (a loader is called with the rank's own
    ``(start, stop)``) and folds them into its own accumulators; no
    collective runs while streaming. One combine at the end (the in-memory
    mesh's ``_combine_intermediates``) gives every rank the whole result.
    Above ``dense_intermediate_bytes_max`` additive reductions stream in
    the blocked owner-by-owner form; quantiles sum each counting pass over
    the ranks.
    """
    if isinstance(func, (tuple, list)):
        raise TypeError("streaming_groupby_reduce takes one func; pass statistic sets to "
                        "streaming_groupby_aggregate_many")
    with telemetry.span("streaming_groupby_reduce",
                        func=func if isinstance(func, str) else getattr(func, "name", "custom"),
                        mesh=mesh is not None):
        return _streaming_groupby_reduce_impl(
            array, by, func=func, batch_len=batch_len, batch_bytes=batch_bytes,
            expected_groups=expected_groups, isbin=isbin, sort=sort, axis=axis,
            fill_value=fill_value, dtype=dtype, min_count=min_count,
            finalize_kwargs=finalize_kwargs, engine=engine, device=device, mesh=mesh,
            axis_name=axis_name)


def streaming_groupby_aggregate_many(
    array: Any,
    by: Any,
    *,
    funcs: "tuple | list" = ("sum", "count", "min", "max", "var"),
    batch_len: int | None = None,
    batch_bytes: int | None = None,
    expected_groups: Any = None,
    isbin: Any = False,
    sort: bool = True,
    axis: Any = None,
    fill_value: Any = None,
    dtype: Any = None,
    min_count: int | None = None,
    finalize_kwargs: dict | None = None,
    mesh: Any = None,
    axis_name: str | tuple[str, ...] = "data",
    engine: str | None = None,
    device: Any = None,
) -> tuple:
    """N grouped statistics in one streaming pass: the fusion planner
    (``aggregations.plan_fused``) merges them into one chunk plan, every slab
    is staged once and folds into one fused carry. Returns ``(results,
    *groups)`` with ``results`` a dict func -> tensor. ``mesh=`` runs the
    fused legs through the same per-rank step as
    :func:`streaming_groupby_reduce`."""
    with telemetry.span("streaming_groupby_aggregate_many", funcs=list(funcs),
                        mesh=mesh is not None):
        return _streaming_groupby_reduce_impl(
            array, by, func=tuple(funcs), batch_len=batch_len, batch_bytes=batch_bytes,
            expected_groups=expected_groups, isbin=isbin, sort=sort, axis=axis,
            fill_value=fill_value, dtype=dtype, min_count=min_count,
            finalize_kwargs=finalize_kwargs, engine=engine, device=device, mesh=mesh,
            axis_name=axis_name)


def _host_array(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        if array.device.type != "cpu":
            raise TypeError("streaming reads host data: pass a numpy array, a CPU tensor or a "
                            "loader (the groupby_* entry points take device tensors)")
        return array.numpy()
    return np.asarray(array)


def _unsigned_wrap(loader, probe_dtype: np.dtype, func: str):
    """Unsigned data wider than 8 bits, widened exactly on the host by the
    route ``kernels.generic_kernel`` takes on the device
    (``kernels.unsigned_route``). Returns (loader, keyed): keyed uint64 slabs
    are the order-preserving int64 keys ``x ^ 2**63``."""
    if probe_dtype.kind != "u" or probe_dtype.itemsize < 2:
        return loader, False
    work, keyed = kernels.unsigned_route(utils.torch_dtype(probe_dtype), func)
    if keyed:
        return (lambda s, e: np.asarray(loader(s, e)).view(np.int64) ^ kernels._NAT_INT), True
    wide = utils.numpy_dtype(work)
    return (lambda s, e: np.asarray(loader(s, e)).astype(wide)), False


def _streaming_groupby_reduce_impl(array, by, *, func, batch_len, batch_bytes, expected_groups,
                                   isbin, sort, axis, fill_value, dtype, min_count,
                                   finalize_kwargs, engine, device, mesh=None,
                                   axis_name="data") -> tuple:
    from .core import (_astype_final, _convert_expected, _group_values, _normalize_expected,
                       _normalize_isbin, _normalize_reduce_axes)

    dev, comm = _stream_mesh(mesh, axis_name, device)
    labels = utils.asarray_host(by)
    keep_by_shape: tuple = ()
    loader: Callable[[int, int], Any]
    if callable(array):
        if labels.ndim != 1:
            raise NotImplementedError("loader inputs define a 1-D (start, stop) axis contract: "
                                      "pass 1-D labels (flatten nD layouts on the host)")
        if axis is not None:
            raise NotImplementedError("axis= needs a host array, not a loader")
        loader = array
        lead_shape = None  # from the first slab
        red_axes = (0,)
    else:
        arr = _host_array(array)
        bndim = labels.ndim
        if arr.shape[arr.ndim - bndim:] != labels.shape:
            raise ValueError(f"array trailing dims {arr.shape[arr.ndim - bndim:]} != by shape "
                             f"{labels.shape}")
        arr, (labels,), n_keep, bndim = _normalize_reduce_axes(arr, [labels], axis)
        keep_by_shape = labels.shape[:n_keep]
        lead_shape = arr.shape[: arr.ndim - bndim]
        span = int(np.prod(labels.shape)) if labels.size else 0
        arr = arr.reshape(lead_shape + (span,))
        loader = lambda s, e: arr[..., s:e]  # noqa: E731
        red_axes = tuple(range(n_keep, bndim))
    n = int(np.prod(labels.shape))

    # -- host factorize over the whole label span (labels only) -----------
    expected_idx = _convert_expected(_normalize_expected(expected_groups, 1),
                                     _normalize_isbin(isbin, 1), sort)
    with telemetry.span("factorize") as fsp:
        codes, found_groups, grp_shape, ngroups, size, _props = fct.factorize_(
            [labels], axes=red_axes, expected_groups=expected_idx, sort=sort)
        fsp.set(ngroups=ngroups, size=size)
    # one contiguous int32 copy for the whole stream: slab codes are views
    codes = np.ascontiguousarray(np.asarray(codes).reshape(-1), dtype=np.int32)
    if size == 0:
        raise ValueError("No groups to reduce over (empty expected_groups?)")

    probe = np.asarray(loader(0, 1))  # one probe: the dtype and the lead shape
    datetime_dtype = probe.dtype if dtps.is_datetime_like(probe.dtype) else None
    nat = False
    fused_funcs = tuple(func) if isinstance(func, (tuple, list)) else None
    min_count_ = 0 if min_count is None else min_count
    work_dtype = np.dtype("int64") if datetime_dtype is not None else probe.dtype
    if fused_funcs is not None:
        if datetime_dtype is not None:
            raise NotImplementedError(
                "fused multi-statistic streaming supports numeric data; stream datetime "
                "reductions one func at a time")
        agg = plan_fused(fused_funcs, dtype, utils.torch_dtype(work_dtype), fill_value,
                         min_count_, finalize_kwargs)
    else:
        agg = _initialize_aggregation(func, dtype, utils.torch_dtype(work_dtype), fill_value,
                                      min_count_, finalize_kwargs)
    keyed = False
    if datetime_dtype is not None:
        # the eager path's round trips (core.groupby_reduce), slab by slab
        from .aggregations import set_nat_final_fill

        base_loader = loader
        if agg.preserves_dtype:
            nat = True
            set_nat_final_fill(agg, fill_value)
            loader = lambda s, e: np.asarray(base_loader(s, e)).view("int64")  # noqa: E731
        elif agg.reduction_type == "argreduce" or agg.name in ("count", "len", "any", "all"):
            nat = True
            loader = lambda s, e: np.asarray(base_loader(s, e)).view("int64")  # noqa: E731
        else:
            # float-valued reductions: float64 epoch values, NaT -> NaN
            def loader(s, e):
                sl = np.asarray(base_loader(s, e)).view("int64")
                f = sl.astype(np.float64)
                f[sl == kernels._NAT_INT] = np.nan
                return f
    else:
        loader, keyed = _unsigned_wrap(loader, probe.dtype,
                                       "fused" if fused_funcs is not None else agg.name)
        if keyed:
            # identities and fills of the legs in key space (INT64_MIN is the
            # key of 0): the agg as it would be for int64 data
            agg.fill_value = _initialize_aggregation(
                func, None, torch.int64, None, min_count_, finalize_kwargs).fill_value
        # a fused uint64 set reduces through float64 (``unsigned_route`` of
        # "fused"): its min/max legs round as the single-func calls do, and
        # rounding is monotone, so the extrema of rounded values are the
        # rounded extrema

    stream_orderstat = False
    if agg.blockwise_only:
        if agg.name not in ("median", "nanmedian", "quantile", "nanquantile"):
            raise NotImplementedError(
                f"{agg.name!r} cannot stream (its run lengths need whole sorted groups); use "
                "groupby_reduce(method='blockwise', mesh=...) after "
                "rechunk.reshard_for_blockwise")
        stream_orderstat = True

    if lead_shape is None:
        lead_shape = probe.shape[:-1]
    lead_shape = tuple(lead_shape)
    itemsize = probe.dtype.itemsize
    row_bytes = int(np.prod(lead_shape, dtype=np.int64)) * itemsize if lead_shape else itemsize

    # -- the sort (present-groups) engine: compact once for the whole stream
    present_table = None
    size_full = size
    if _route_stream_highcard(engine, codes, size, probe, lead_shape, agg, dev, comm) == "sort":
        present_table = kernels.present_groups(codes, size)
        if len(present_table) < size:
            codes = np.ascontiguousarray(kernels.compact_codes(codes, present_table),
                                         dtype=np.int32)
            size = kernels.present_cap(len(present_table), size)
        else:
            present_table = None  # the universe is fully present
    if batch_len is None:
        if batch_bytes is None:
            batch_bytes = _tuned_batch_bytes(n, lead_shape, dev, comm)
        batch_len = max(1, min(n, batch_bytes // max(row_bytes, 1)))
    batch_len = _mesh_batch_len(batch_len, comm)
    out_shape = lead_shape + tuple(keep_by_shape) + tuple(grp_shape)

    if stream_orderstat:
        result = _stream_quantile(
            agg, loader, codes, size=size, n=n, batch_len=batch_len, lead_shape=lead_shape,
            probe_dtype=np.dtype(np.float64) if datetime_dtype is not None else probe.dtype,
            data_probe=probe, device=dev, comm=comm)
        with telemetry.span("finalize"):
            result = _astype_final(result, agg, datetime_dtype)
            result = _scatter_stream(result, present_table, size_full, dev)
            shape = agg.new_dims() + out_shape
            if tuple(result.shape) != shape:
                result = result.reshape(shape)
        return (result,) + _group_values(found_groups)

    skipna = agg.name.startswith("nan") or agg.name == "count"
    count_skipna = skipna or agg.min_count > 0
    if nat:
        from .aggregations import shift_nat_identity_fills

        shift_nat_identity_fills(agg)
    hint = _highcard_oom_hint(agg, size, present_table)
    blocked = False
    if comm is not None:
        # the in-memory mesh's ceiling routing: above it, additive reductions
        # accumulate owner blocks, and everything else raises
        from .parallel.mapreduce import _route_ceiling

        lead_elems = int(np.prod(lead_shape, dtype=np.int64)) if lead_shape else 1
        blocked = _route_ceiling(agg, size, lead_elems, probe.dtype, comm.size, "map-reduce")
    state = _run_reduce_stream(agg, loader, codes, size=size, n=n, batch_len=batch_len,
                               lead_shape=lead_shape, count_skipna=count_skipna, nat=nat,
                               probe=probe, device=dev, hint=hint,
                               cast=_slab_cast(agg, probe.dtype, datetime_dtype is not None),
                               comm=comm, blocked=blocked)

    with telemetry.span("finalize", **({"mesh": True} if comm is not None else {})):
        if comm is not None:
            result = _mesh_final(agg, state, comm, nat=nat, blocked=blocked, size=size,
                                 keyed=keyed)
        else:
            from .parallel.mapreduce import _finalize_combined

            inters, counts = state
            if keyed:
                inters = _unkey(agg, inters)
            result = _finalize_combined(agg, inters, counts)
        if fused_funcs is not None:
            out = _finalize_many_stream(agg, result, out_shape, present_table, size_full, dev)
            return (out,) + _group_values(found_groups)
        result = _astype_final(result, agg, datetime_dtype)
        result = _scatter_stream(result, present_table, size_full, dev)
        # (..., size) -> (..., *keep_by, *groups): kept by-dims ride the group
        # axis as disjoint code ranges and unfold here
        if tuple(result.shape) != out_shape:
            result = result.reshape(out_shape)
    return (result,) + _group_values(found_groups)


def _mesh_final(agg: Aggregation, state, comm, *, nat: bool, blocked: bool, size: int,
                keyed: bool):
    """The one combine of a mesh stream (the reference's
    ``_build_mesh_final`` and ``_build_mesh_final_blocked``): each rank's
    accumulators meet the in-memory mesh's combine, and every rank gets the
    whole result. Blocked carries already hold each owner's combined block:
    they finalize and are gathered."""
    from .parallel.mapreduce import (_combine_intermediates, _finalize_combined, _map_result,
                                     _tiles_to_groups)

    inters, counts = state
    if blocked:
        result_own = _finalize_combined(agg, inters, counts)
        return _map_result(lambda r: r[..., :size], _tiles_to_groups(result_own, comm))
    counts_g = None if counts is None else comm.psum(counts)
    combined = _combine_intermediates(agg, inters, comm, nat)
    if keyed:  # extrema combine in key space, then flip back
        combined = _unkey(agg, combined)
    return _finalize_combined(agg, combined, counts_g)


def _unkey(agg: Aggregation, inters: list) -> list:
    """uint64 data streamed as int64 keys: the value leg comes back through
    the key flip (positions and counts need none)."""
    if agg.name not in kernels._VALUE_FUNCS:
        return inters
    flip = (inters[0] ^ kernels._NAT_INT).view(torch.uint64)
    return [flip] + list(inters[1:])


def _run_reduce_stream(agg: Aggregation, loader, codes: np.ndarray, *, size: int, n: int,
                       batch_len: int, lead_shape: tuple, count_skipna: bool, nat: bool,
                       probe: np.ndarray, device: torch.device, hint, cast=None, comm=None,
                       blocked: bool = False):
    """The slab loop of a reduction: stage, step, merge into the carry, with
    the OOM ladder, the throttle and the checkpointer. Returns the carry
    ``(inters, counts)``.

    ``comm``: a mesh rank's collectives. The rank stages and folds only its
    shard of each slab (the reference's ``_build_mesh_step``), with no
    collective; its OOM ladder halves its own shard. ``blocked``: the
    owner-by-owner form (``_build_mesh_step_blocked``), whose per-slab psums
    every rank must run alike, so it has no ladder."""
    from .pipeline import DispatchThrottle, SlabStager, stream_slabs
    from .profiling import timed
    from .resilience import StreamCheckpointer, StreamCounters, device_restore, dispatch_slab

    counters = StreamCounters()
    stager = SlabStager(loader, codes, n=n, batch_len=batch_len, lead_shape=lead_shape,
                        device=device, counters=counters,
                        shard=None if comm is None else (comm.size, comm.index))
    ckpt = StreamCheckpointer.for_stream(
        # the resolved aggregation (dtype request, custom legs, kwargs): a
        # snapshot of a same-named but different aggregation must miss
        kind="reduce", name=_agg_identity(agg), n=n, batch_len=batch_len, size=size,
        codes=codes, lead_shape=lead_shape, extra=(nat, count_skipna, str(probe.dtype)),
        data_probe=probe, counters=counters, mesh_key=_mesh_key(comm, blocked))
    state = None
    skip = 0
    snap = ckpt.restore(comm, device)
    if snap is not None:
        # bit-identical resume: the carry round-trips the host exactly and the
        # remaining slabs fold in the same order
        skip = snap.slabs_done
        state = device_restore(snap.payload, device)
    done = skip
    throttle = DispatchThrottle()
    nbatches = math.ceil(n / batch_len)

    def apply_step(st, sl):
        if blocked:
            inters, counts = _blocked_slab_stats(agg, sl.data, sl.codes, sl.offset, size=size,
                                                 comm=comm, count_skipna=count_skipna, nat=nat,
                                                 cast=cast)
        else:
            inters, counts = _slab_stats(agg, sl.data, sl.codes, sl.offset, size=size,
                                         count_skipna=count_skipna, nat=nat, cast=cast)
        if st is None:
            return _init_state_like_merged(agg, inters, counts, nat=nat)
        merged = _merge_into(agg, st, inters, counts, nat=nat)
        _assign(st, merged)  # in place, after every allocation of the step
        return st

    with timed(f"stream [{agg.name}] {nbatches} slab(s) x {batch_len}"):
        for sl in stream_slabs(stager, label=f"reduce[{agg.name}]", skip=skip):
            state = dispatch_slab(apply_step, state, sl, stager=None if blocked else stager,
                                  counters=counters, highcard_hint=hint)
            throttle.tick(device)
            done += 1
            ckpt.tick(lambda: state, slabs_done=done)
    ckpt.done()
    return state


def _callable_identity(fn) -> tuple:
    """A callable's part of a checkpoint key. A function reachable by its
    module and qualified name (every builtin leg) is named so, which holds
    in another process; a lambda, closure or partial carries its id(), so a
    resume in another process misses: a fresh run, never a wrong one."""
    mod, qual = getattr(fn, "__module__", None), getattr(fn, "__qualname__", None)
    if mod and qual and "<" not in qual:
        obj = sys.modules.get(mod)
        for part in qual.split("."):
            obj = getattr(obj, part, None)
        if obj is fn:
            return (mod, qual)
    return (qual or type(fn).__qualname__, id(fn))


def _agg_identity(agg: Aggregation) -> str:
    """A picklable identity of the resolved aggregation for the checkpoint
    key, stable across processes for the builtin aggregations."""
    def ident(x):
        if callable(x):
            return _callable_identity(x)
        if isinstance(x, (tuple, list)):
            return tuple(ident(v) for v in x)
        if isinstance(x, dict):
            return tuple(sorted((k, ident(v)) for k, v in x.items()))
        return repr(x)

    return repr((agg.name, ident(agg.chunk), ident(agg.combine), ident(agg.finalize),
                 ident(agg.fill_value), repr(agg.final_fill_value), str(agg.final_dtype),
                 ident(agg.finalize_kwargs), agg.min_count))


def _tuned_batch_bytes(n: int, lead_shape: tuple, dev, comm=None) -> int:
    """The slab byte budget of a stream that names none: the default, or
    with the autotuner on the observed-best budget for the stream's size
    band, unless a checkpoint path is set (the slab length is part of a
    checkpoint's identity, which a resuming process must reproduce). The
    ranks of a mesh stream pick from their own stores and take the smallest
    pick, so that every rank cuts the same slabs."""
    if not OPTIONS["autotune"] or OPTIONS["stream_checkpoint_path"]:
        return _DEFAULT_BATCH_BYTES
    from .autotune import pick_stream_batch_bytes

    lead_elems = int(np.prod(lead_shape, dtype=np.int64)) if lead_shape else 1
    pick = pick_stream_batch_bytes(_DEFAULT_BATCH_BYTES, nelems=int(n) * lead_elems,
                                   platform=torch.device(dev).type)
    if comm is not None:
        pick = int(comm.pmin(torch.tensor([pick], dtype=torch.int64, device=dev)).item())
    return pick


def _route_stream_highcard(engine, codes, size: int, probe, lead_shape, agg, dev,
                           comm=None) -> str:
    """Dense ("torch") or present-groups ("sort") carry: the streaming form
    of ``core._route_highcard``. ``engine=None``: the sort engine above the
    dense-intermediate ceiling when its compact domain fits, or past
    ``sort_engine_min_groups`` when at most 1/8 of the universe is present
    (with the autotuner on and no checkpoint path, the ``highcard``
    family's decision); ``default_engine="sort"`` always. Explicit engines
    are never second guessed; "numpy" has no streaming form."""
    from .core import (_HIGHCARD_DENSITY_DEN, _choose_engine, _highcard_candidates,
                       dense_intermediate_bytes)

    if engine is not None:
        engine = _choose_engine(engine)
        if engine == "numpy":
            raise ValueError("the streaming runtime folds slabs on the device; engine='numpy' "
                             "has no streaming form (use groupby_reduce on host data)")
        return engine
    if OPTIONS["default_engine"] == "sort":
        return "sort"
    lead_elems = int(np.prod(lead_shape, dtype=np.int64)) if lead_shape else 1
    est = dense_intermediate_bytes(lead_elems, size, probe.dtype, agg, 1)
    ceiling = OPTIONS["dense_intermediate_bytes_max"]
    over = est > ceiling
    if not over and size < OPTIONS["sort_engine_min_groups"]:
        return "torch"
    present = kernels.present_groups(codes, size)  # memoized; the sort path reuses it
    ncap = kernels.present_cap(len(present), size)
    if over:
        est_sort = dense_intermediate_bytes(lead_elems, ncap, probe.dtype, agg, 1)
        if est_sort > ceiling:
            return "torch"  # the mesh blocked form, or the ceiling error, decides
        telemetry.count("highcard.ceiling_routes")
        return "sort"
    heuristic = "sort" if ncap * _HIGHCARD_DENSITY_DEN <= size else "dense"
    if (OPTIONS["autotune"] and not OPTIONS["stream_checkpoint_path"]
            and len(_highcard_candidates(heuristic, agg, probe.dtype, size,
                                         torch.device(dev).type)) > 1):
        from . import autotune

        nelems = int(codes.shape[-1]) * lead_elems
        autotune.prime_highcard(probe.dtype, size, len(present), nelems, dev)
        heuristic = autotune.decide("highcard", heuristic, ("dense", "sort"),
                                    dtype=autotune.dtype_name(probe.dtype), ngroups=size,
                                    nelems=nelems, platform=torch.device(dev).type)
        if comm is not None:
            # one route for every rank: each decided from its own store
            flag = torch.tensor([int(heuristic == "sort")], dtype=torch.int32, device=dev)
            heuristic = "sort" if int(comm.pmax(flag).item()) else "dense"
    return "sort" if heuristic == "sort" else "torch"


def _highcard_oom_hint(agg: Aggregation, size: int, present_table) -> str | None:
    """The ladder's hint for dense carries over a universe past
    ``sort_engine_min_groups``: an allocation that halving cannot shrink."""
    if present_table is not None or size < OPTIONS["sort_engine_min_groups"]:
        return None
    return (f"the {agg.name!r} accumulators are dense over the {size}-label universe, which "
            "slab-splitting cannot shrink. The sort (present-groups) engine accumulates only "
            "over groups actually present: pass engine='sort' (or "
            "set_options(default_engine='sort')), or lower expected_groups.")


def _scatter_stream(result, present_table, size_full: int, device):
    """A compact result expanded to the dense (..., size) layout on the host
    and copied back (a no-op on dense runs)."""
    if present_table is None:
        return result
    from .core import _redevice_scattered

    return _redevice_scattered(kernels.scatter_present_dense(result, present_table, size_full),
                               device)


def _finalize_many_stream(agg, result, out_shape, present_table, size_full: int, device):
    """The fused finalize, each statistic scattered back from the compact
    domain before the reshape on sort-engine runs."""
    from .fusion import finalize_many

    if present_table is None:
        return finalize_many(agg, result, out_shape)
    outs = finalize_many(agg, result, None)
    fixed = {}
    for f, v in outs.items():
        v = _scatter_stream(v, present_table, size_full, device)
        fixed[f] = v.reshape(out_shape) if tuple(v.shape) != tuple(out_shape) else v
    return fixed


# ---------------------------------------------------------------------------
# the per-slab step
# ---------------------------------------------------------------------------


def _slab_cast(agg: Aggregation, dtype: np.dtype, datetime: bool):
    """The dtype a slab is cast to before its kernels, or None: the eager
    path's rules, bools to int64 for sums and products, and additive and
    float-valued reductions accumulating in their final dtype (not for
    datetimes, whose float path already holds float64 with NaT as NaN)."""
    if datetime:
        return None
    if dtype == np.bool_ and agg.name in _ADDLIKE:
        return torch.int64
    final = agg.final_dtype
    if (agg.name in _ADDLIKE and not agg.preserves_dtype) or (
            agg.name in _FLOAT_FUNCS and final.is_floating_point):
        return final
    return None


def _slab_stats(agg: Aggregation, slab: torch.Tensor, codes: torch.Tensor, offset: int, *,
                size: int, count_skipna: bool, nat: bool, cast=None):
    """Chunk intermediates and counts of one slab; ``offset`` is the slab's
    start on the streamed axis, ``cast`` the dtype of :func:`_slab_cast`. Sums
    and counts of float data come from one kernel pass (``_local_stage``); a
    fused plan has no counts channel."""
    from .parallel.mapreduce import _local_counts, _local_firstlast, _local_stage

    if cast is not None and slab.dtype != cast:
        slab = slab.to(cast)
    skipna = agg.name.startswith("nan")
    kw = {"nat": True} if nat else {}
    if agg.reduction_type == "argreduce":
        # a group with no candidate holds position -1, the default fill: the
        # counts matter only for min_count or another fill
        counts = (_local_counts(codes, slab, size, count_skipna, nat).to(torch.int32)
                  if agg.min_count > 0 or agg.final_fill_value != -1 else None)
        val_f, arg_f = agg.chunk
        val = kernels.generic_kernel(val_f, codes, slab, size=size,
                                     fill_value=agg.fill_value["intermediate"][0], **kw)
        local_arg = kernels.generic_kernel(arg_f, codes, slab, size=size, fill_value=-1, **kw)
        gidx = torch.where(local_arg >= 0, local_arg.to(torch.int64) + offset, -1)
        return [val, gidx], counts
    if agg.combine in (("first",), ("last",)):
        counts = _local_counts(codes, slab, size, count_skipna, nat).to(torch.int32)
        val, pos = _local_firstlast(codes, slab, size, skipna=skipna,
                                    last=agg.combine == ("last",), nat=nat, offset=offset)
        return [val, pos], counts
    return _local_stage(agg, codes, slab, size, nat, count_skipna)


def _blocked_slab_stats(agg: Aggregation, slab, codes, offset: int, *, size: int, comm,
                        count_skipna: bool, nat: bool, cast=None):
    """One slab of the blocked owner-by-owner mesh stream: a loop over the
    ranks' owner blocks of ``ceil(size / ndev)`` groups, each block's shard
    intermediates combined over the ranks, the owner keeping its block. No
    dense (..., size) buffer exists; the shard is read once a block.
    Additive combines only (sum and the variance triple)."""
    from .parallel.mapreduce import _combine_intermediates

    ndev = comm.size
    b = -(-size // ndev)
    owned = None
    for d in range(ndev):
        in_block = (codes >= d * b) & (codes < (d + 1) * b)
        bc = torch.where(in_block, codes - d * b, -1)
        inters, counts = _slab_stats(agg, slab, bc, offset, size=b, count_skipna=count_skipna,
                                     nat=nat, cast=cast)
        counts = None if counts is None else comm.psum(counts)
        outs = _combine_intermediates(agg, inters, comm, nat)
        if d == comm.index:
            owned = (outs, counts)
    return owned


def _argmerge_better(va, vb, arg_of_max: bool):
    better = (vb > va) if arg_of_max else (vb < va)
    if va.is_floating_point():
        # NaN-propagating: a NaN extreme wins over a number
        better = better | (torch.isnan(vb) & ~torch.isnan(va))
    return better


def _pair_merge(op, a, b, nat: bool = False):
    """The sequential form of the mesh collectives: psum -> add, pmax ->
    maximum (NaN propagates), the variance triple -> the Chan update.
    ``nat`` re-injects the NaT marker through min/max."""
    if op in ("max", "min") and nat and a.dtype == torch.int64:
        m = torch.maximum(a, b) if op == "max" else torch.minimum(a, b)
        marker = kernels._NAT_INT
        return torch.where((a == marker) | (b == marker), marker, m)
    if op == "var":
        m2a, ta, na = a.arrays
        m2b, tb, nb = b.arrays
        nab = na + nb
        tab = ta + tb
        mua = ta / torch.where(na > 0, na, 1)
        mub = tb / torch.where(nb > 0, nb, 1)
        muab = tab / torch.where(nab > 0, nab, 1)
        m2 = m2a + m2b + na * (mua - muab) ** 2 + nb * (mub - muab) ** 2
        return MultiArray((m2, tab, nab))
    if op == "sum":
        return a + b
    if op == "prod":
        return a * b
    if op == "max":
        return torch.maximum(a, b)
    if op == "min":
        return torch.minimum(a, b)
    if callable(op):
        # the mesh contract: op(stacked) over the shard axis; here the two
        # "shards" are the carry and the slab
        if isinstance(a, MultiArray):
            return op(MultiArray(torch.stack([x, y]) for x, y in zip(a.arrays, b.arrays)))
        return op(torch.stack([a, b]))
    raise NotImplementedError(f"streaming merge for combine op {op!r}")


def _merge_into(agg: Aggregation, state, inters, counts, *, nat: bool):
    """One slab's intermediates folded into the carry: new tensors, the carry
    untouched."""
    skipna = agg.name.startswith("nan")
    # NaT re-injection only for propagating merges: skipna fills were shifted
    # off the marker upstream
    nat_markers = nat and not skipna
    acc_inters, acc_counts = state
    if agg.reduction_type == "argreduce":
        arg_of_max = "max" in str(agg.chunk[1])
        va, ia = acc_inters
        vb, ib = inters
        better = _argmerge_better(va, vb, arg_of_max)
        tie = vb == va
        if va.is_floating_point():
            tie = tie | (torch.isnan(va) & torch.isnan(vb))
        if nat_markers:
            # a NaT extreme wins over any value; both NaT is a tie already
            marker = kernels._NAT_INT
            na_, nb_ = va == marker, vb == marker
            better = (better & ~na_ & ~nb_) | (nb_ & ~na_)
        ia_safe = torch.where(ia >= 0, ia, _BIG)
        ib_safe = torch.where(ib >= 0, ib, _BIG)
        idx = torch.where(better, ib_safe, torch.where(tie, torch.minimum(ia_safe, ib_safe),
                                                        ia_safe))
        out = [torch.where(better, vb, va), torch.where(idx < _BIG, idx, -1)]
    elif agg.combine in (("first",), ("last",)):
        va, pa = acc_inters
        vb, pb = inters
        if agg.combine == ("last",):
            take_b = (pb >= 0) & ((pa < 0) | (pb > pa))
        else:
            take_b = (pb < _BIG) & ((pa >= _BIG) | (pb < pa))
        out = [torch.where(take_b, vb, va), torch.where(take_b, pb, pa)]
    else:
        out = [_pair_merge(op, a, b, nat=nat_markers)
               for a, b, op in zip(acc_inters, inters, agg.combine)]
    return out, (None if acc_counts is None else acc_counts + counts)


def _tree_cast(x, like):
    if isinstance(x, MultiArray):
        return MultiArray(_tree_cast(a, m) for a, m in zip(x.arrays, like.arrays))
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_cast(a, m) for a, m in zip(x, like))
    if x is None:
        return None
    # a fresh, dense carry: legs may be expanded views (counts of codes alone)
    return x.to(like.dtype).contiguous()


def _init_state_like_merged(agg: Aggregation, inters, counts, *, nat: bool):
    """The first slab's state, dense, in the dtypes a merge produces (a
    callable combine may promote: ``torch.stack([a, b]).sum(0)`` widens
    int32), so the carry's dtypes never change from slab to slab and in-place
    updates hold."""
    merged = _merge_into(agg, (inters, counts), inters, counts, nat=nat)
    return _tree_cast((list(inters), counts), merged)


def _assign(dst, src) -> None:
    """Copy the merged state into the carry's tensors."""
    if isinstance(dst, MultiArray):
        for d, s in zip(dst.arrays, src.arrays):
            _assign(d, s)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _assign(d, s)
    elif dst is not None:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# exact quantiles: the radix select's counting passes, slab by slab
# ---------------------------------------------------------------------------


def _stream_quantile(agg: Aggregation, loader, codes, *, size: int, n: int, batch_len: int,
                     lead_shape: tuple, probe_dtype, data_probe, device, comm=None):
    """Out-of-core exact quantile/median: the radix-select bisection
    (``kernels._radix_select``) consumes per-group counts only, and counts
    accumulate slab by slab, so order statistics stream in ``nbits + 1``
    passes over the loader (one count pass, one per key bit: 33 for float32,
    65 for float64). Bit for bit the eager select path: the same exact
    counts, the same bit-by-bit reconstruction and interpolation. The data
    is read ``nbits + 1`` times, a trade made for never holding the array.
    Returns (*q, ..., size) on ``device``, before the final cast.

    ``comm``: a mesh rank's collectives. The rank counts its own shard of
    every slab, and each pass's counts sum over the ranks once, at the end
    of the pass (the non-skipna NaN flags take their maximum), so every rank
    runs the same collectives in the same order and holds the same
    bisection state."""
    from .pipeline import DispatchThrottle, SlabStager, stream_slabs
    from .profiling import timed
    from .resilience import StreamCheckpointer, StreamCounters, device_restore, dispatch_slab

    skipna = agg.name.startswith("nan")
    fkw = dict(agg.finalize_kwargs)
    if agg.name in ("median", "nanmedian"):
        q, method = 0.5, "linear"
    else:
        if "q" not in fkw:
            raise TypeError(f"{agg.name} requires finalize_kwargs={{'q': ...}}")
        q = fkw["q"]
        method = fkw.get("method", "linear")
    qs = np.atleast_1d(np.asarray(q, dtype=np.float64))
    alpha, beta = kernels._quantile_alpha_beta(method)
    fdtype = (utils.torch_dtype(probe_dtype) if np.issubdtype(probe_dtype, np.floating)
              else torch.float64)
    nbits = 8 * torch.empty((), dtype=fdtype).element_size()
    cdtype = torch.float32 if n < 2**24 else torch.int32  # the eager select's rule
    k = int(np.prod(lead_shape, dtype=np.int64)) if lead_shape else 1
    nbatches = math.ceil(n / batch_len)

    counters = StreamCounters()
    # one stager for every pass: the retry policy and the loader's dtype
    # contract hold across the whole multi-pass run
    stager = SlabStager(loader, codes, n=n, batch_len=batch_len, lead_shape=lead_shape,
                        device=device, counters=counters,
                        shard=None if comm is None else (comm.size, comm.index))

    def prep(sl):
        data = sl.data.reshape(k, sl.data.shape[-1])  # a rank's shard may be empty
        return data if data.dtype == fdtype else data.to(fdtype)

    def count_pass(st, sl):
        nn, hasnan = st
        data = prep(sl)
        sc = kernels._safe_codes(sl.codes, size)
        mask = kernels._nan_mask(data)
        nn_add = kernels._counts(sc, size, mask=mask).expand(k, size)
        new = [nn + nn_add, hasnan]
        if not skipna and mask is not None:
            new[1] = torch.maximum(hasnan, kernels._seg("max", (~mask).to(torch.int8), sc, size))
        _assign([nn, hasnan], new)
        return st

    ckpt = StreamCheckpointer.for_stream(
        kind="quantile", name=agg.name, n=n, batch_len=batch_len, size=size, codes=codes,
        lead_shape=lead_shape, extra=(tuple(qs.tolist()), method, str(fdtype)),
        data_probe=data_probe, counters=counters, mesh_key=_mesh_key(comm))
    snap = ckpt.restore(comm, device)
    phase0, skip0 = (0, 0) if snap is None else (snap.phase, snap.slabs_done)
    throttle = DispatchThrottle()

    def slabs(label, skip=0):
        # each pass is one pipelined sweep (the loader is random-access)
        return stream_slabs(stager, label=f"quantile[{agg.name}] {label}", skip=skip)

    with timed(f"stream-quantile [{agg.name}] {nbits + 1} passes x {nbatches} slab(s)"):
        bit0, bit_skip, cnt0 = 0, 0, None
        if phase0 == 0:
            if snap is not None:
                nn, hasnan = device_restore(snap.payload, device)
            else:
                # exact int32 counts: the rank positions rest on them
                nn = torch.zeros((k, size), dtype=torch.int32, device=device)
                hasnan = torch.zeros((k, size), dtype=torch.int8, device=device)
            done = skip0
            for sl in slabs("count", skip=skip0):
                dispatch_slab(count_pass, (nn, hasnan), sl, stager=stager, counters=counters)
                throttle.tick(device)
                done += 1
                ckpt.tick(lambda: (nn, hasnan), slabs_done=done, phase=0)
            if comm is not None:
                nn, hasnan = comm.psum(nn), comm.pmax(hasnan)
        else:
            nn, hasnan, prefix, rank, cnt0 = device_restore(snap.payload, device)
            bit0, bit_skip = phase0 - 1, skip0

        nnf = nn.to(torch.float64)
        ranks, meta = kernels._quantile_rank_sets(qs, nnf, method, alpha, beta)
        m = ranks.shape[0]
        if phase0 == 0:
            key_dtype = kernels._INT_OF_WIDTH[nbits // 8]
            prefix = torch.zeros((m, k, size), dtype=key_dtype, device=device)
            rank = ranks.to(torch.int32)
        for i in range(bit0, nbits):
            b = nbits - 1 - i
            if i == bit0 and cnt0 is not None:
                cnt, skip_i = cnt0, bit_skip
            else:
                cnt, skip_i = torch.zeros((m, k, size), dtype=torch.int32, device=device), 0

            def bit_pass(c, sl, b=b, prefix=prefix):
                data = prep(sl)
                keys = kernels._valid_keys(data, kernels._nan_mask(data))
                sc = kernels._safe_codes(sl.codes, size)
                c.add_(kernels._radix_pass_count(keys, sc, size, prefix, b, cdtype))
                return c

            done = skip_i
            for sl in slabs(f"bit {i}", skip=skip_i):
                cnt = dispatch_slab(bit_pass, cnt, sl, stager=stager, counters=counters)
                throttle.tick(device)
                done += 1
                ckpt.tick(lambda: (nn, hasnan, prefix, rank, cnt), slabs_done=done,
                          phase=1 + i)
            if comm is not None:
                cnt = comm.psum(cnt)
            prefix, rank = kernels._radix_update(prefix, rank, cnt, b)
    ckpt.done()

    selected = kernels._key_to_value(prefix, fdtype)
    fv = agg.final_fill_value
    fill = torch.tensor(float("nan") if fv is None else fv).to(dtype=fdtype, device=device)
    threshold = max(agg.min_count, 1)
    outs = []
    for pos, lo_in, ia, ib in meta:
        val = kernels._interp(method, pos, lo_in, selected[ia], selected[ib])
        val = torch.where(nn < threshold, fill, val)
        if not skipna:
            val = torch.where(hasnan > 0, float("nan"), val)
        outs.append(val.reshape(lead_shape + (size,)))
    return outs[0] if np.ndim(q) == 0 else torch.stack(outs)


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


def streaming_groupby_scan(
    array: Any,
    by: Any,
    *,
    func: str,
    batch_len: int | None = None,
    batch_bytes: int | None = None,
    expected_groups: Any = None,
    dtype: Any = None,
    out: Callable[[int, int, Any], None] | None = None,
    mesh: Any = None,
    axis_name: str | tuple[str, ...] = "data",
    device: Any = None,
) -> Any:
    """Out-of-core grouped scan: slabs stream through a per-group carry.

    Each slab runs the within-slab grouped scan; the slab's per-group
    summary becomes the next slab's carry, applied through the codes.
    ``bfill`` streams the slabs in reverse. ``array``: a host array
    ``(..., n)`` or a loader ``callable(start, stop)``; ``by``: 1-D labels
    along the scanned axis. ``out``: an optional writer ``callable(start,
    stop, result_slab)`` that takes each result slab (numpy, on the host) as
    it is made; the call then returns None. Without one the whole result
    comes back as a numpy array on the host. The semantics are those of
    :func:`flox_tpu_torch.groupby_scan`, datetime NaT rules and integer
    promotion included.

    ``mesh=``: each rank scans its own columns of every slab with the mesh
    Blelloch program (``parallel.scan.stream_scan_step``) and a carry from
    the slabs before; every rank gets (or writes) each whole result slab.
    """
    with telemetry.span("streaming_groupby_scan", func=func, mesh=mesh is not None):
        return _streaming_groupby_scan_impl(array, by, func=func, batch_len=batch_len,
                                            batch_bytes=batch_bytes,
                                            expected_groups=expected_groups, dtype=dtype,
                                            out=out, device=device, mesh=mesh,
                                            axis_name=axis_name)


def _scan_slab_fn(scan, *, size: int, dtype, nat: bool):
    """``slab_scan(slab, codes, carry, had) -> (out_slab, carry, had)`` of one
    scan; the first slab passes carry = had = None."""
    kw = {"nat": True} if nat else {}
    gk = kernels.generic_kernel

    def apply_carry(table, sc):
        return kernels._per_element(table.reshape(-1, size), sc).reshape(
            table.shape[:-1] + (sc.shape[0],))

    if scan.mode == "apply_binary_op":

        def slab_scan(slab, codes, carry, had, _width=None):
            sc = kernels._safe_codes(codes, size)
            local = gk(scan.scan, codes, slab, size=size, dtype=dtype, **kw)
            if nat:
                is_nat = slab == kernels._NAT_INT
                summed = torch.where(is_nat, 0, slab)
            else:
                summed = slab
            block = gk(scan.reduction, codes, summed, size=size, fill_value=0,
                       dtype=dtype).to(local.dtype)
            if carry is None:
                out_slab, new_carry = local, block
            else:
                out_slab = local + apply_carry(carry, sc)
                new_carry = carry + block
            new_had = had
            if nat and scan.scan == "cumsum":
                # a NaT earlier in the group poisons everything after it: a
                # sticky per-group channel across slabs
                had_slab = gk("sum", codes, is_nat.to(torch.int32), size=size, fill_value=0) > 0
                if had is not None:
                    poison = apply_carry(had.to(torch.int8), sc) > 0
                    out_slab = torch.where(poison, kernels._NAT_INT, out_slab)
                    new_had = had | had_slab
                else:
                    new_had = had_slab
                out_slab = torch.where(local == kernels._NAT_INT, kernels._NAT_INT, out_slab)
            return out_slab, new_carry, new_had

        return slab_scan

    def fill_scan(slab, codes, carry, has, _width=None):  # ffill / bfill
        sc = kernels._safe_codes(codes, size)
        local = gk(scan.scan, codes, slab, size=size, **kw)
        is_float = slab.is_floating_point()
        valid_cnt = gk("nanlen", codes, slab, size=size, **kw)
        edge_val = gk(scan.reduction, codes, slab, size=size,
                      fill_value=float("nan") if is_float else 0, **kw)
        mask = kernels._nan_mask(local, nat)
        still = ~mask if mask is not None else torch.zeros(local.shape, dtype=torch.bool,
                                                           device=local.device)
        out_slab = local
        if carry is not None:
            carry_e = apply_carry(carry, sc)
            has_e = apply_carry(has.to(torch.int8), sc) > 0
            out_slab = torch.where(still & has_e & (codes >= 0), carry_e, local)
            new_carry = torch.where(valid_cnt > 0, edge_val.to(carry.dtype), carry)
            new_has = has | (valid_cnt > 0)
        else:
            new_carry = edge_val
            new_has = valid_cnt > 0
        return out_slab, new_carry, new_has

    return fill_scan


def _mesh_scan_slab_fn(scan, *, size: int, dtype, nat: bool, comm, lead_shape: tuple):
    """``slab_scan(shard, codes, carry_a, carry_b, width)`` of a mesh stream
    (the reference's ``_run_mesh_stream_scan`` step): the rank's shard runs
    ``parallel.scan.stream_scan_step``, and the shards are gathered into the
    whole ``width``-column result slab, replicated."""
    from .parallel.scan import gather_shards, stream_scan_step

    k = int(np.prod(lead_shape, dtype=np.int64)) if lead_shape else 1

    def slab_scan(shard, codes, carry, had, width):
        arr = shard.reshape(k, shard.shape[-1])
        if dtype is not None:
            arr = arr.to(dtype)  # the promotion of accumulating scans
        out, c2, h2 = stream_scan_step(scan, arr, codes, size=size, comm=comm, nat=nat,
                                       carry=None if carry is None else (carry, had))
        return gather_shards(out, comm, width).reshape(tuple(lead_shape) + (width,)), c2, h2

    return slab_scan


def _scan_ckpt_id(scan) -> str:
    """The resolved scan's identity for the checkpoint key: a custom scan
    sharing a builtin's name misses the builtin's snapshot."""
    op = scan.binary_op
    op_id = None if op is None else _callable_identity(op)
    return repr((scan.name, scan.scan, scan.reduction, op_id, scan.identity, scan.mode,
                 scan.preserves_dtype))


def _streaming_groupby_scan_impl(array, by, *, func, batch_len, batch_bytes, expected_groups,
                                 dtype, out, device, mesh=None, axis_name="data") -> Any:
    from .aggregations import _initialize_scan
    from .core import _convert_expected, _normalize_expected, _normalize_isbin
    from .pipeline import SlabStager, stream_slabs
    from .profiling import timed
    from .resilience import StreamCheckpointer, StreamCounters, device_restore, dispatch_slab
    from .scan import _check_datetime_scan

    dev, comm = _stream_mesh(mesh, axis_name, device)
    labels = utils.asarray_host(by)
    if labels.ndim != 1:
        raise NotImplementedError("streaming_groupby_scan scans the streamed axis: pass 1-D "
                                  "labels (use groupby_scan for in-memory nD layouts)")
    n = labels.shape[0]
    if callable(array):
        loader = array
        lead_shape = None
    else:
        arr = _host_array(array)
        if arr.shape[-1] != n:
            raise ValueError(f"array trailing dim {arr.shape[-1]} != by length {n}")
        lead_shape = arr.shape[:-1]
        loader = lambda s, e: arr[..., s:e]  # noqa: E731

    expected_idx = _convert_expected(_normalize_expected(expected_groups, 1),
                                     _normalize_isbin(False, 1), True)
    with telemetry.span("factorize") as fsp:
        codes, _found, _grp_shape, ngroups, size, _props = fct.factorize_(
            [labels], axes=(0,), expected_groups=expected_idx, sort=True)
        fsp.set(ngroups=ngroups, size=size)
    codes = np.ascontiguousarray(np.asarray(codes).reshape(-1), dtype=np.int32)
    if size == 0:
        raise ValueError("No groups to scan over (empty expected_groups?)")

    scan = _initialize_scan(func)
    probe = np.asarray(loader(0, 1))
    lead_shape = tuple(probe.shape[:-1] if lead_shape is None else lead_shape)
    arr_dtype = probe.dtype
    datetime_dtype = arr_dtype if dtps.is_datetime_like(arr_dtype) else None
    nat = datetime_dtype is not None
    base_loader = loader
    keyed, widened = False, None
    if nat:
        _check_datetime_scan(scan, arr_dtype, dtype)
        loader = lambda s, e: np.asarray(base_loader(s, e)).view("int64")  # noqa: E731
    else:
        loader, keyed = _unsigned_wrap(base_loader, arr_dtype, scan.scan)
        if loader is not base_loader:
            widened = utils.torch_dtype(arr_dtype)
    # numpy's integer promotion of accumulating scans (groupby_scan's rule)
    if scan.name in ("cumsum", "nancumsum") and dtype is None and not nat:
        if arr_dtype.kind in "iub":
            dtype = utils.torch_dtype(np.result_type(arr_dtype, np.int_))
    elif dtype is not None:
        dtype = utils.torch_dtype(dtype)

    itemsize = probe.dtype.itemsize
    row_bytes = int(np.prod(lead_shape, dtype=np.int64)) * itemsize if lead_shape else itemsize
    if batch_len is None:
        batch_bytes = _DEFAULT_BATCH_BYTES if batch_bytes is None else batch_bytes
        batch_len = max(1, min(n, batch_bytes // max(row_bytes, 1)))
    batch_len = _mesh_batch_len(batch_len, comm)
    nbatches = math.ceil(n / batch_len)
    has_missing = bool((codes < 0).any())
    reverse = scan.name == "bfill"
    if comm is None:
        slab_scan = _scan_slab_fn(scan, size=size, dtype=dtype, nat=nat)
    else:
        slab_scan = _mesh_scan_slab_fn(scan, size=size, dtype=dtype, nat=nat, comm=comm,
                                       lead_shape=lead_shape)

    counters = StreamCounters()
    stager = SlabStager(loader, codes, n=n, batch_len=batch_len, lead_shape=lead_shape,
                        device=dev, counters=counters,
                        shard=None if comm is None else (comm.size, comm.index))
    # a scan's checkpoint needs the emitted slabs to survive the kill, which
    # only a writer gives: snapshots are taken on the out= path only
    ckpt = StreamCheckpointer.for_stream(
        kind="scan", name=_scan_ckpt_id(scan), n=n, batch_len=batch_len, size=size,
        codes=codes, lead_shape=lead_shape, extra=(nat, str(dtype), has_missing, reverse),
        data_probe=probe, counters=counters, enabled=out is not None, mesh_key=_mesh_key(comm))
    carry = had = None
    skip = 0
    snap = ckpt.restore(comm, dev)
    if snap is not None:
        skip = snap.slabs_done
        carry, had = device_restore(snap.payload, dev)
    done = skip
    result_arr = None

    def apply_scan(cur, sl):
        nonlocal result_arr
        c, h = cur
        out_slab, c2, h2 = slab_scan(sl.data, sl.codes, c, h, sl.stop - sl.start)
        # the slab's result reaches the host before the carry moves on: a
        # split or a failure after this point never re-emits a slab
        if keyed:  # uint64 fills streamed as keys: the values back
            out_slab = (out_slab ^ kernels._NAT_INT).view(torch.uint64)
        elif widened is not None and scan.preserves_dtype:
            out_slab = out_slab.to(widened)  # fills of widened unsigned data
        result_arr = _emit_scan_slab(out_slab, sl.codes_host, sl.start, sl.stop, nat=nat,
                                     datetime_dtype=datetime_dtype, has_missing=has_missing,
                                     out=out, result_arr=result_arr, lead_shape=lead_shape,
                                     n=n)
        return c2, h2

    with timed(f"stream-scan [{scan.name}] {nbatches} slab(s)"):
        for sl in stream_slabs(stager, reverse=reverse, label=f"scan[{scan.name}]", skip=skip):
            # a mesh slab's exchange is collective: a split on one rank would
            # leave the others waiting, so the mesh scan has no OOM ladder
            carry, had = dispatch_slab(apply_scan, (carry, had), sl,
                                       stager=stager if comm is None else None,
                                       counters=counters, reverse=reverse)
            done += 1
            ckpt.tick(lambda: (carry, had), slabs_done=done)
    ckpt.done()
    if out is not None:
        return None
    return result_arr


def _emit_scan_slab(out_slab, codes_host, s, e, *, nat, datetime_dtype, has_missing, out,
                    result_arr, lead_shape, n):
    """Mask, view and hand one scanned slab to the writer or the host result
    array; returns the (possibly just allocated) result array."""
    res = out_slab
    if has_missing:
        from .scan import _mask_positions

        res = _mask_positions(res, torch.as_tensor(codes_host < 0, device=res.device), nat=nat)
    res = res.cpu().numpy()
    if nat:
        res = res.astype("int64").view(datetime_dtype)
    if out is not None:
        out(s, e, res)
        return result_arr
    if result_arr is None:
        result_arr = np.empty(tuple(lead_shape) + (n,), res.dtype)
    result_arr[..., s:e] = res
    return result_arr
