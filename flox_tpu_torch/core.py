"""``groupby_reduce``: the eager path of ``flox_tpu/core.py`` and its
entry to the multi-device runtime.

The chain is the reference's: normalize the labels and the reduced axes on
the host, factorize the labels into dense codes (host, numpy), flatten the
data to (..., N) with the reduced axes last, run the aggregation's kernels
(``chunk_reduce``), mask by ``min_count`` and cast to the final dtype.

The data lives on one torch device, ``cuda`` unless the caller asks for the
CPU; labels and group values stay on the host. Datetime64/timedelta64 data
reduces on its int64 view (NaT = INT64_MIN, a missing marker) and string or
object data through float64 positions; torch has no dtype for either result,
so those come back as numpy arrays. Two engines reduce: "torch"
holds dense (..., size) accumulators over the label universe, "sort"
(the present-groups engine) compacts the codes to the groups present,
reduces over a small capacity and scatters the dense result on the host, and
"numpy" (the host engine, only when named) reduces on the host and copies the
result to the device once. ``_route_highcard`` picks between the first two
under the dense-intermediate ceiling.

Labels may also arrive prefactorized (``factorize.Prefactorized``: codes
staged on the device, no factorization), the data may be a sparse tensor
(``sparse.sparse_groupby_reduce``), and ``reindex=ReindexStrategy(
array_type=SPARSE_COO)`` packs the result into a sparse container.

With ``method=`` or ``mesh=`` the reduction runs as a mesh program
(``parallel.mapreduce``): every rank passes the same global inputs, the
labels are normalized and factorized on the host as above, the data stays
where it is (a numpy array on the host) until each rank moves its own columns
to its device, and the result comes back replicated on every rank. Without
``method=`` the method is chosen by cohort detection on the global codes.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from . import dtypes, factorize as fct, kernels, utils
from .aggregations import (Aggregation, _initialize_aggregation, generic_aggregate,
                           set_nat_final_fill)
from .options import OPTIONS
from .reindex import ReindexArrayType, ReindexStrategy, reindex_sparse_coo
from .sparse import is_sparse_array, sparse_groupby_reduce
from .types import Bins

__all__ = ["chunk_reduce", "dense_intermediate_bytes", "groupby_reduce"]

#: the reductions of string and object data (through positions)
_NON_NUMERIC_FUNCS = ("first", "last", "nanfirst", "nanlast", "count")

#: engines of the reference that the port names otherwise or lacks
_UNPORTED_ENGINES = {
    "jax": "none: the torch engine is the port's counterpart of 'jax'; pass engine='torch'",
    "flox": "none: the torch engine is the port's counterpart of 'flox'; pass engine='torch'",
    "numbagg": "none: the port has no numbagg engine",
}


# ---------------------------------------------------------------------------
# argument normalization
# ---------------------------------------------------------------------------


def _assert_by_is_aligned(shape: tuple[int, ...], bys: Sequence[np.ndarray]) -> None:
    """All ``by`` arrays must match the trailing dims of ``array``."""
    for b in bys:
        if b.ndim > len(shape) or tuple(shape[-b.ndim :]) != b.shape:
            raise ValueError(
                f"`by` has shape {b.shape} which does not align with the trailing "
                f"dimensions of `array` with shape {tuple(shape)}."
            )


def _normalize_expected(expected, nby: int):
    if expected is None:
        return (None,) * nby
    if nby == 1 and not isinstance(expected, tuple):
        return (expected,)
    if not isinstance(expected, tuple):
        raise ValueError("With multiple `by`, `expected_groups` must be a tuple.")
    if len(expected) != nby:
        raise ValueError(
            f"Must have one expected_groups entry per `by` ({nby}); got {len(expected)}."
        )
    return expected


def _normalize_isbin(isbin, nby: int) -> tuple[bool, ...]:
    if isinstance(isbin, bool):
        return (isbin,) * nby
    return tuple(isbin)


def _convert_expected(expected, isbin: Sequence[bool], sort: bool) -> tuple:
    """User ``expected_groups`` -> numpy values or :class:`Bins`. pandas
    objects are read without importing pandas at module level."""
    out: list[Any] = []
    for exp, bin_ in zip(expected, isbin):
        if exp is None or isinstance(exp, Bins):
            out.append(exp)
        elif type(exp).__name__ == "IntervalIndex":
            import pandas as pd  # only a pandas object reaches here

            assert isinstance(exp, pd.IntervalIndex)
            if not (exp.is_non_overlapping_monotonic and (exp.right[:-1] == exp.left[1:]).all()):
                raise NotImplementedError(
                    "only contiguous interval bins are supported (pd.IntervalIndex.from_breaks)"
                )
            edges = np.concatenate([np.asarray(exp.left[:1]), np.asarray(exp.right)])
            out.append(Bins(edges, closed=exp.closed))
        elif bin_:
            out.append(Bins(utils.asarray_host(exp)))
        else:
            values = utils.asarray_host(getattr(exp, "values", exp))
            out.append(np.sort(values) if sort else values)
    return tuple(out)


def _normalize_reduce_axes(arr, bys: list[np.ndarray], axis):
    """Move the reduced by-dims to the trailing position.

    Returns ``(arr, bys, n_keep, bndim)``: the (possibly permuted) array and
    labels, the count of kept (non-reduced) by-dims now leading the by-span,
    and the by-span rank after any broadcast. ``axis`` entries below the
    by-span broadcast the labels over those dims first.
    """
    bndim = bys[0].ndim
    if axis is None:
        axes = tuple(range(arr.ndim - bndim, arr.ndim))
    else:
        axes = utils.normalize_axis_tuple(axis, arr.ndim)
    first_by_ax = arr.ndim - bndim
    if any(ax < first_by_ax for ax in axes):
        # reducing over dims the labels don't cover: broadcast labels over them
        new_bndim = arr.ndim - min(axes)
        target_shape = tuple(arr.shape[-new_bndim:])
        bys = [np.broadcast_to(b, target_shape) for b in bys]
        bndim = new_bndim
        first_by_ax = arr.ndim - bndim

    rel_axes = tuple(ax - first_by_ax for ax in axes)  # axes within the by dims
    by_keep = [d for d in range(bndim) if d not in rel_axes]
    by_order = by_keep + list(rel_axes)
    if by_order != list(range(bndim)):
        bys = [b.transpose(by_order) for b in bys]
        order = list(range(first_by_ax)) + [first_by_ax + d for d in by_order]
        # a host (numpy) array is the streaming runtime's
        arr = arr.permute(order) if isinstance(arr, torch.Tensor) else arr.transpose(order)
    return arr, bys, len(by_keep), bndim


def _choose_engine(engine) -> str:
    """The engine of a call: ``engine`` itself, or the ``default_engine``
    option when it is None. Unlike the reference, no size heuristic sends
    small host arrays to the numpy engine: it runs only when named."""
    if engine is None:
        return OPTIONS["default_engine"]
    if engine in ("torch", "sort", "numpy"):
        return engine
    if engine in _UNPORTED_ENGINES:
        raise NotImplementedError(
            f"engine={engine!r} is not available in the port; ROADMAP item: "
            f"{_UNPORTED_ENGINES[engine]}"
        )
    raise ValueError(
        f"Unknown engine {engine!r}; the port has engine='torch', 'sort' and 'numpy'.")


def _work_device(engine: str, dev: torch.device) -> torch.device:
    """Where a call reduces: the host for the numpy engine, else ``dev``."""
    return torch.device("cpu") if engine == "numpy" else dev


def _parse_reindex(reindex, func, nby: int):
    """The reference's reindex mapping: returns the ``SPARSE_COO`` strategy or
    None. Dense strategies, ``True`` and ``False`` change nothing eagerly:
    every result is already dense over the expected groups; ``blockwise=False``
    matters only to the mesh's map-reduce combine (:func:`_blockwise_false`)."""
    if isinstance(reindex, ReindexStrategy):
        if reindex.array_type is not ReindexArrayType.SPARSE_COO:
            return None
    elif reindex in (None, True, False):
        return None
    else:
        raise TypeError(f"reindex must be None, a bool, or a ReindexStrategy; got {reindex!r}")
    fname = func if isinstance(func, str) else getattr(func, "name", "")
    if not isinstance(fname, str) or any(
        f in fname for f in ("first", "last", "prod", "var", "std", "arg")
    ):
        # these have no meaningful implicit fill
        raise ValueError(f"reindex with array_type=SPARSE_COO does not support {fname!r}")
    if nby > 1:
        raise NotImplementedError(
            "SPARSE_COO reindex supports a single `by` (the sparse axis is the trailing "
            "group axis)"
        )
    return reindex


def _blockwise_false(reindex) -> bool:
    """Whether ``reindex`` asks for ``blockwise=False`` (no dense combine)."""
    if isinstance(reindex, ReindexStrategy):
        return reindex.array_type is not ReindexArrayType.SPARSE_COO and reindex.blockwise is False
    return reindex is False


def _auto_method(codes_flat: np.ndarray, size: int, mesh, axis_name) -> str:
    """The method of a mesh call that names none: cohort detection over the
    shards of the named mesh dims (not the whole mesh), on the global codes,
    so that every rank chooses alike."""
    from .cohorts import chunks_from_shards, find_group_cohorts
    from .parallel.mesh import axis_size

    n_shards = axis_size(mesh, axis_name)
    method, _ = find_group_cohorts(codes_flat, chunks_from_shards(codes_flat.shape[0], n_shards),
                                   expected_groups=range(size))
    return method


def _check_blockwise_false(reindex, method: str) -> None:
    if _blockwise_false(reindex) and method == "map-reduce":
        raise NotImplementedError(
            "reindex=False (blockwise=False) with method='map-reduce' on a mesh: the "
            "combine is dense over expected_groups by design and cannot be skipped. The "
            "capability it targets, avoiding huge dense intermediates, is provided instead "
            "by set_options(dense_intermediate_bytes_max=...): additive reductions above "
            "the ceiling route to the blocked owner-by-owner program. Use "
            "method='cohorts'/'blockwise', or drop reindex=."
        )


def _resolve_devices(array, engine: str, method, mesh, device):
    """``(mesh, dev, work)`` of a call: its mesh (None for an eager call),
    the device of its result, and where its data is normalized: ``dev``, the
    host for the numpy engine, or on a mesh where the data already lies (the
    host for numpy), since each rank moves only its own columns."""
    if method is None and mesh is None:
        dev = utils.resolve_device(device)
        return None, dev, _work_device(engine, dev)
    from .parallel.mapreduce import resolve_mesh

    mesh, dev = resolve_mesh(mesh, device)
    return mesh, dev, array.device if isinstance(array, torch.Tensor) else torch.device("cpu")


def _min_count(min_count, fill_value, func_name: str) -> int:
    """The reference's default: a nansum/nanprod with a fill counts as 1."""
    if min_count is not None:
        return min_count
    return 1 if fill_value is not None and func_name in ("nansum", "nanprod") else 0


# ---------------------------------------------------------------------------
# dense-vs-sort routing under the dense-intermediate ceiling
# ---------------------------------------------------------------------------


def _est_itemsize(dtype) -> int:
    """Accumulator width for the footprint estimate: intermediates travel in
    >= 4-byte accumulators; complex dtypes keep their full width."""
    return max(4, utils.numpy_dtype(dtype).itemsize)


def dense_intermediate_bytes(lead_elems: int, size: int, dtype, agg: Aggregation,
                             ndev: int = 1) -> int:
    """Device-byte estimate of the dense (..., size) intermediates of one
    reduction over ``ndev`` shards (parity: the reference's estimate): one
    buffer per chunk leg plus the counts leg, three for a variance triple;
    legs whose combine all-gathers (callable folds, prod, first/last) cost
    ``ndev`` times their dense size."""
    per_leg = lead_elems * size * _est_itemsize(dtype)
    legs = 1  # counts
    ops = agg.combine or ("sum",) * max(1, len(agg.chunk or ()) or 1)
    if agg.combine in (("first",), ("last",)) or agg.reduction_type == "argreduce":
        legs += 2  # the (value, position) pair
        if agg.combine in (("first",), ("last",)):
            legs += 2 * (ndev - 1)  # the pair is all-gathered
        return per_leg * legs
    for op in ops:
        if op == "var":
            legs += 3
        elif op in ("sum", "max", "min"):
            legs += 1
        else:
            legs += ndev
    return per_leg * legs


#: density heuristic of a call left to the dense engine over a universe past
#: ``sort_engine_min_groups``: the sort engine's overheads (a host unique
#: pass, a compact relabel, the host scatter) pay once the dense accumulators
#: outweigh the compact ones 8x, i.e. at most 1/8 of the universe is present
_HIGHCARD_DENSITY_DEN = 8


def _route_highcard(engine: str, codes_flat: np.ndarray | None, arr_flat: torch.Tensor,
                    lead_shape: tuple, size: int, agg: Aggregation, *, explicit: bool,
                    present: np.ndarray | None = None) -> str:
    """Dense-vs-sort routing of the eager path: "torch" or "sort".

    The ceiling first: a dense (..., size) estimate above
    ``dense_intermediate_bytes_max`` sends a call left to the dense engine to
    the sort engine, and raises ``ValueError`` naming ``engine='sort'`` for an
    explicit ``engine="torch"`` (explicit choices are never second-guessed),
    or when even the compact domain is over the ceiling. Below it, universes
    past ``sort_engine_min_groups`` go to the sort engine when at most
    1/:data:`_HIGHCARD_DENSITY_DEN` of them is present. ``present``, when
    given (a prefactorized artifact's table), replaces the memoized unique
    pass over ``codes_flat``.
    """
    lead_elems = int(np.prod(lead_shape)) if lead_shape else 1
    ceiling = OPTIONS["dense_intermediate_bytes_max"]
    est = dense_intermediate_bytes(lead_elems, size, arr_flat.dtype, agg)
    over = est > ceiling
    if engine == "torch" and not over and (explicit or size < OPTIONS["sort_engine_min_groups"]):
        return "torch"  # the common case pays neither a unique pass nor routing
    if present is None:
        present = kernels.present_groups(codes_flat, size)  # memoized; the sort path reuses it
    ncap = kernels.present_cap(len(present), size)
    if over:
        est_sort = dense_intermediate_bytes(lead_elems, ncap, arr_flat.dtype, agg)
        if est_sort > ceiling or (engine == "torch" and explicit):
            sort_note = (
                f"even the sort engine's compact domain ({ncap} present-group slots, "
                f"~{utils.fmt_bytes(est_sort)}) exceeds the ceiling"
                if est_sort > ceiling
                else "engine='sort' (set_options(default_engine='sort')) reduces over "
                f"only the {len(present)} groups actually present"
            )
            raise ValueError(
                f"{agg.name!r} over {size} groups needs ~{utils.fmt_bytes(est)} of dense "
                f"(..., size) device intermediates, above the {utils.fmt_bytes(ceiling)} "
                f"dense_intermediate_bytes_max ceiling; {sort_note}. Options: pass mesh= "
                "(map-reduce routes additive reductions to the blocked owner-by-owner "
                "program); reduce expected_groups; use engine='sort'; or raise "
                "set_options(dense_intermediate_bytes_max=...) if the device really has "
                "the headroom."
            )
        return "sort"
    if engine == "sort":
        return "sort"
    return "sort" if ncap * _HIGHCARD_DENSITY_DEN <= size else "torch"


def _redevice_scattered(result, device: torch.device):
    """The dense result of the sort engine, scattered on the host, back on
    the call's device: one copy of the one dense buffer. It stays a CPU
    tensor when it alone is over ``dense_intermediate_bytes_max``: there the
    dense engine's alternative was an exception, and a host result is the
    usable degradation. A numpy (datetime) result stays on the host."""
    if isinstance(result, np.ndarray):
        return result
    nbytes = result.numel() * result.element_size()
    if nbytes > OPTIONS["dense_intermediate_bytes_max"]:
        return result
    return result.to(device)


# ---------------------------------------------------------------------------
# chunk_reduce
# ---------------------------------------------------------------------------


def chunk_reduce(
    array: torch.Tensor,
    codes: torch.Tensor,
    *,
    funcs: Sequence[Any],
    size: int,
    fill_values: Sequence[Any],
    dtypes_: Sequence[Any],
    engine: str = "torch",
    kwargss: Sequence[dict] | None = None,
) -> list:
    """Run a bundle of grouped reductions over the trailing axis.

    ``array`` (..., N); ``codes`` (N,) with -1 for missing. Returns one
    (..., size) result per func. Repeated (func, fill, dtype, kwargs) entries
    are computed once and fanned out (parity: the reference's dedup).
    """
    if kwargss is None:
        kwargss = [{}] * len(funcs)
    seen: dict[tuple, int] = {}
    plan: list[tuple] = []
    positions: list[int] = []
    for func, fv, dt, kw in zip(funcs, fill_values, dtypes_, kwargss):
        key = (
            func if isinstance(func, str) else id(func),
            None if fv is None else repr(fv),
            None if dt is None else str(dt),
            repr(sorted(kw.items())),
        )
        if key not in seen:
            seen[key] = len(plan)
            plan.append((func, fv, dt, kw))
        positions.append(seen[key])
    results = [
        generic_aggregate(
            codes, array, engine=engine, func=f, size=size, fill_value=fv, dtype=dt, **kw
        )
        for f, fv, dt, kw in plan
    ]
    return [results[i] for i in positions]


# ---------------------------------------------------------------------------
# groupby_reduce
# ---------------------------------------------------------------------------


def groupby_reduce(
    array: Any,
    *by: Any,
    func: str | Aggregation,
    expected_groups: Any = None,
    sort: bool = True,
    isbin: bool | Sequence[bool] = False,
    axis: int | Sequence[int] | None = None,
    fill_value: Any = None,
    dtype: Any = None,
    min_count: int | None = None,
    method: str | None = None,
    engine: str | None = None,
    reindex: Any = None,
    finalize_kwargs: dict | None = None,
    mesh: Any = None,
    axis_name: str | tuple[str, ...] = "data",
    device: Any = None,
) -> tuple:
    """GroupBy reduction (the signature of ``flox_tpu.groupby_reduce``, plus
    ``device``).

    Returns ``(result, *groups)``: ``result`` is a tensor on ``device`` with
    the reduced axes replaced by one axis per grouper; the groups are numpy
    arrays (a structured ``left``/``right`` array for bins).

    ``device`` defaults to ``cuda`` and raises ``RuntimeError`` when CUDA is
    missing; pass ``device="cpu"`` to run on the CPU. A numpy ``array`` is
    copied to the device, a tensor elsewhere is moved there. ``by`` may be
    one :class:`~flox_tpu_torch.factorize.Prefactorized`; ``array`` may be a
    sparse tensor; ``reindex=ReindexStrategy(array_type=SPARSE_COO)`` returns
    a sparse container over the groups that occur.

    ``method`` ("map-reduce", "cohorts" or "blockwise") runs the reduction
    over ``mesh`` (:func:`~flox_tpu_torch.parallel.make_mesh`; default: the
    ``torch.distributed`` world, or one rank without one), sharding the
    reduced axis over the mesh dims ``axis_name``; ``mesh=`` without
    ``method=`` lets cohort detection choose. Every rank passes the same
    global inputs and gets the whole result on its device. ``array`` may
    then also be a ``DTensor`` sharded along its last axis over the mesh.

    Examples
    --------
    >>> import numpy as np
    >>> from flox_tpu_torch import groupby_reduce
    >>> values = np.array([1.0, 2.0, 4.0, 8.0])
    >>> labels = np.array([0, 0, 1, 1])
    >>> result, groups = groupby_reduce(values, labels, func="sum", device="cpu")
    >>> result
    tensor([ 3., 12.], dtype=torch.float64)
    >>> groups
    array([0, 1])
    """
    if not by:
        raise TypeError("Must pass at least one `by`")
    if method not in (None, "map-reduce", "blockwise", "cohorts"):
        raise ValueError(
            f"method must be one of None, 'map-reduce', 'blockwise', 'cohorts'; got {method!r}"
        )
    nby = len(by)
    reindex_sparse = _parse_reindex(reindex, func, nby)
    if nby == 1 and isinstance(by[0], fct.Prefactorized):
        # factorized once, codes staged on the device: no factorize, no copy
        return _prefactorized_reduce(
            array, by[0], func=func, expected_groups=expected_groups, axis=axis, isbin=isbin,
            fill_value=fill_value, dtype=dtype, min_count=min_count, method=method,
            engine=engine, reindex=reindex, finalize_kwargs=finalize_kwargs, mesh=mesh,
            axis_name=axis_name, device=device,
        )
    if is_sparse_array(array):
        # sparse inputs reduce without densifying; options the sparse reducer
        # cannot honor are rejected, not dropped
        unsupported = {"min_count": min_count, "axis": axis, "method": method,
                       "finalize_kwargs": finalize_kwargs, "mesh": mesh,
                       "reindex (SPARSE_COO)": reindex_sparse}
        bad = [k for k, v in unsupported.items() if v is not None]
        if bad:
            raise NotImplementedError(
                f"sparse inputs do not support {bad} (grouping is over the last axis, "
                "eagerly, with the reference's aggregate_sparse func subset)"
            )
        _choose_engine(engine)  # validated; the sparse reducer has one engine
        return _sparse_path(array, by, func=func, expected_groups=expected_groups, isbin=isbin,
                            sort=sort, fill_value=fill_value, dtype=dtype,
                            device=utils.resolve_device(device))
    # explicit engine choices are never second-guessed: only a defaulted
    # dense engine may re-route to the sort engine (_route_highcard)
    engine_explicit = engine is not None
    engine = _choose_engine(engine)

    mesh, dev, work = _resolve_devices(array, engine, method, mesh, device)
    on_mesh = mesh is not None

    # -- host-side label normalization ------------------------------------
    bys = [utils.asarray_host(b) for b in by]
    bys = list(np.broadcast_arrays(*bys)) if nby > 1 else bys
    datetime_dtype = None
    if not isinstance(array, torch.Tensor):
        host = np.asarray(array)
        if host.dtype.kind in "OSU":
            _assert_by_is_aligned(host.shape, bys)
            _check_non_numeric(func, dtype, finalize_kwargs, host.dtype)
            if reindex_sparse is not None:
                raise NotImplementedError(
                    "SPARSE_COO reindex is not supported for non-numeric reductions")
            return _reduce_non_numeric(
                host, bys, func, fill_value=fill_value, expected_groups=expected_groups,
                sort=sort, isbin=isbin, axis=axis, min_count=min_count, engine=engine,
                reindex=reindex, method=method, mesh=mesh, axis_name=axis_name, device=dev,
            )
        if dtypes.is_datetime_like(host.dtype):
            # the exact int64 view, NaT = INT64_MIN (a missing marker)
            datetime_dtype = host.dtype
            host = host.view("int64")
        array = host
    from .parallel.mesh import is_dtensor

    if is_dtensor(array):
        if not on_mesh:
            raise ValueError("a DTensor input runs on the mesh: pass method= or mesh=")
        return _dtensor_reduce(array, bys, func=func, expected_groups=expected_groups,
                               sort=sort, isbin=isbin, axis=axis, fill_value=fill_value,
                               dtype=dtype, min_count=min_count, method=method, engine=engine,
                               reindex=reindex, finalize_kwargs=finalize_kwargs, mesh=mesh,
                               axis_name=axis_name)
    arr = utils.as_tensor(array, work)
    _assert_by_is_aligned(tuple(arr.shape), bys)

    expected = _normalize_expected(expected_groups, nby)
    isbin_t = _normalize_isbin(isbin, nby)
    expected_idx = _convert_expected(expected, isbin_t, sort)

    # -- axis normalization: reduced axes must be trailing ----------------
    arr, bys, n_keep, bndim = _normalize_reduce_axes(arr, bys, axis)
    nred_shape = tuple(bys[0].shape[n_keep:])
    keep_by_shape = tuple(bys[0].shape[:n_keep])

    # -- factorize (host) --------------------------------------------------
    codes, found_groups, grp_shape, ngroups, size, _props = fct.factorize_cached(
        tuple(bys), axes=tuple(range(n_keep, bndim)), expected_groups=expected_idx, sort=sort
    )
    if ngroups == 0 or size == 0:
        raise ValueError("No groups to reduce over (empty expected_groups?)")

    func_name = func if isinstance(func, str) else func.name
    if arr.dtype == torch.bool and func_name in ("sum", "nansum", "prod", "nanprod", "count"):
        arr = arr.to(torch.int64)

    agg = _initialize_aggregation(func, dtype, arr.dtype, fill_value,
                                  _min_count(min_count, fill_value, func_name), finalize_kwargs)
    if datetime_dtype is not None and agg.preserves_dtype:
        set_nat_final_fill(agg, fill_value)
    elif (datetime_dtype is not None and agg.reduction_type != "argreduce"
          and agg.name not in ("count", "len", "any", "all")):
        # float-valued reductions of datetimes (mean, var, median, quantile,
        # sum): NaT -> NaN once, here, so every skipna and propagation rule
        # applies unchanged; point-in-time results round back to the datetime
        # dtype in _astype_final. float64 keeps ~256 ns on epoch values, the
        # reference's own loss
        arr = torch.where(arr == kernels._NAT_INT, float("nan"), arr.to(torch.float64))

    # -- flatten for the kernels: (..., span) with the reduced span last --
    span = int(np.prod(keep_by_shape + nred_shape)) if (keep_by_shape or nred_shape) else 1
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (span,))
    codes_host = np.asarray(codes).reshape(-1)

    if on_mesh:
        result = _mesh_reduce(arr_flat, codes_host, agg, size=size, method=method,
                              engine=engine, reindex=reindex, mesh=mesh, axis_name=axis_name,
                              dev=dev, datetime_dtype=datetime_dtype)
        result = result.reshape(agg.new_dims() + lead_shape + keep_by_shape + grp_shape)
        if reindex_sparse is not None:
            result = _sparsify_result(result, codes_host, ngroups, agg)
        return (result,) + _group_values(found_groups)
    if engine != "numpy":
        engine = _route_highcard(engine, codes_host, arr_flat, lead_shape, size, agg,
                                 explicit=engine_explicit)
    if engine == "sort":
        # compact once, reduce over the banded capacity with the unchanged
        # kernels, scatter the dense layout on the host at the very end:
        # device accumulators track the groups present, not the universe
        present = kernels.present_groups(codes_host, size)
        ncap = kernels.present_cap(len(present), size)
        ccodes = torch.as_tensor(kernels.compact_codes(codes_host, present), device=dev)
        result_c = _reduce_blockwise(arr_flat, ccodes, agg, size=ncap, engine="torch",
                                     datetime_dtype=datetime_dtype)
        result = _redevice_scattered(kernels.scatter_present_dense(result_c, present, size), dev)
    else:
        codes_flat = torch.as_tensor(codes_host, device=work)
        result = _reduce_blockwise(arr_flat, codes_flat, agg, size=size, engine=engine,
                                   datetime_dtype=datetime_dtype)
        if engine == "numpy" and isinstance(result, torch.Tensor):
            result = result.to(dev)  # the host engine's one copy to the device

    # -- reshape: (..., size) -> (*new_dims, ..., *keep_by, *grp_shape) -----
    result = result.reshape(agg.new_dims() + lead_shape + keep_by_shape + grp_shape)
    if reindex_sparse is not None:
        result = _sparsify_result(result, codes_host, ngroups, agg)
    return (result,) + _group_values(found_groups)


def _mesh_reduce(arr_flat, codes_flat, agg: Aggregation, *, size: int, method, engine: str,
                 reindex, mesh, axis_name, dev: torch.device, datetime_dtype=None):
    """The mesh program of a call, finalized: ``arr_flat`` (..., N) global,
    ``codes_flat`` (N,) global (host numpy, or staged on the device). With
    the sort engine the codes are compacted to the groups present first, so
    every intermediate and collective covers only those, and the dense layout
    comes back on the host at the end."""
    from .parallel.mapreduce import sharded_groupby_reduce

    if method is None:
        method = _auto_method(utils.asarray_host(codes_flat).reshape(-1), size, mesh, axis_name)
    _check_blockwise_false(reindex, method)
    present = None
    codes_run, size_run = codes_flat, size
    if engine == "sort":
        host = utils.asarray_host(codes_flat).reshape(-1)
        present = kernels.present_groups(host, size)
        if len(present) < size:
            codes_run = kernels.compact_codes(host, present)
            size_run = kernels.present_cap(len(present), size)
        else:
            present = None
    result = sharded_groupby_reduce(arr_flat, codes_run, agg, size=size_run, mesh=mesh,
                                    axis_name=axis_name, method=method,
                                    nat=datetime_dtype is not None)
    result = _astype_final(result, agg, datetime_dtype)
    if present is not None:
        result = _redevice_scattered(kernels.scatter_present_dense(result, present, size), dev)
    return result


def _dtensor_reduce(array, bys, *, func, expected_groups, sort, isbin, axis, fill_value, dtype,
                    min_count, method, engine, reindex, finalize_kwargs, mesh, axis_name) -> tuple:
    """A ``DTensor`` sharded along its last axis: each rank reduces its local
    shard as it lies, with no gather. One 1-D ``by`` along that axis."""
    if len(bys) != 1 or bys[0].ndim != 1 or axis not in (None, -1, array.ndim - 1):
        raise NotImplementedError(
            "a DTensor input takes one 1-D `by` along its last (sharded) axis")
    _assert_by_is_aligned(tuple(array.shape), bys)
    expected_idx = _convert_expected(_normalize_expected(expected_groups, 1),
                                     _normalize_isbin(isbin, 1), sort)
    codes, found_groups, grp_shape, _ngroups, size, _props = fct.factorize_cached(
        tuple(bys), axes=(0,), expected_groups=expected_idx, sort=sort)
    if size == 0:
        raise ValueError("No groups to reduce over (empty expected_groups?)")
    func_name = func if isinstance(func, str) else func.name
    agg = _initialize_aggregation(func, dtype, array.dtype, fill_value,
                                  _min_count(min_count, fill_value, func_name), finalize_kwargs)
    result = _mesh_reduce(array, np.asarray(codes).reshape(-1), agg, size=size, method=method,
                          engine=_choose_engine(engine), reindex=reindex, mesh=mesh,
                          axis_name=axis_name, dev=array.device)
    lead_shape = tuple(array.shape[:-1])
    return (result.reshape(agg.new_dims() + lead_shape + grp_shape),) + _group_values(
        found_groups)


def _group_values(found_groups) -> tuple:
    return tuple(g.values() if isinstance(g, Bins) else np.asarray(g) for g in found_groups)


def _sparsify_result(result, codes_flat: np.ndarray, ngroups: int, agg: Aggregation):
    """The SPARSE_COO result leg: the reduction stays dense, and the sparse
    container stores only the groups that occur in ``by``. Occurrence is the
    union over kept rows (codes are offset per kept row when ``by`` has kept
    axes): a group found in any kept row is stored for every row. Returns a
    ``torch.sparse_coo_tensor`` on the result's device when the implicit fill
    is zero, a :class:`~flox_tpu_torch.reindex.HostCOO` otherwise."""
    if isinstance(result, np.ndarray):
        raise NotImplementedError(
            f"SPARSE_COO reindex does not support results of dtype {result.dtype}")
    valid = codes_flat[codes_flat >= 0]
    present = np.unique(valid % ngroups)
    return reindex_sparse_coo(
        result.index_select(-1, torch.as_tensor(present, device=result.device)),
        present, np.arange(ngroups), fill_value=agg.final_fill_value,
    )


def _sparse_path(array, by, *, func, expected_groups, isbin, sort, fill_value, dtype, device):
    """Sparse tensors go to the sparse reducer: grouping over the last axis
    by one 1-D ``by`` (the reference's aggregate_sparse scope)."""
    if len(by) != 1:
        raise NotImplementedError("sparse inputs support a single 1-D `by`")
    if not isinstance(func, str):
        raise NotImplementedError("sparse inputs support named funcs only")
    b = utils.asarray_host(by[0])
    if b.ndim != 1 or b.shape[0] != array.shape[-1]:
        raise ValueError("sparse inputs need a 1-D `by` matching the last axis")
    expected_idx = _convert_expected(_normalize_expected(expected_groups, 1),
                                     _normalize_isbin(isbin, 1), sort)
    codes, found_groups, _shape, _ngroups, size, _props = fct.factorize_(
        [b], axes=(0,), expected_groups=expected_idx, sort=sort
    )
    result = sparse_groupby_reduce(
        array.to(device), np.asarray(codes).reshape(-1), func=func, size=size,
        fill_value=fill_value, dtype=dtype,
    )
    return (result,) + _group_values(found_groups)


def _prefactorized_reduce(array, pf: "fct.Prefactorized", *, func, expected_groups, axis,
                          isbin, fill_value, dtype, min_count, method, engine, reindex,
                          finalize_kwargs, mesh, axis_name, device) -> tuple:
    """``by`` arrived as a :class:`~flox_tpu_torch.factorize.Prefactorized`:
    the codes, the group tables and the sort engine's present table were
    computed once, and the codes staged on the device. No factorization runs
    and, with the data on the device, nothing is copied there.

    Options that would need another factorization are rejected, not dropped.
    """
    bad = [name for name, val in (("expected_groups", expected_groups), ("axis", axis),
                                  ("reindex", reindex)) if val is not None]
    if isbin not in (False, (False,)):
        bad.append("isbin")
    if bad:
        raise NotImplementedError(
            f"Prefactorized `by` does not support {bad}: the factorization is fixed when "
            "the artifact is built (prefactorize again with other groups)"
        )
    engine_explicit = engine is not None
    engine = _choose_engine(engine)
    mesh, dev, work = _resolve_devices(array, engine, method, mesh, device)
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
        if array.dtype.kind in "OSU" or dtypes.is_datetime_like(array.dtype):
            raise NotImplementedError(
                f"Prefactorized `by` supports numeric data; got dtype {array.dtype} "
                "(datetime/object inputs keep the inline groupby_reduce path)"
            )
    arr = utils.as_tensor(array, work)
    bndim = len(pf.by_shape)
    if arr.ndim < bndim or tuple(arr.shape[arr.ndim - bndim:]) != tuple(pf.by_shape):
        raise ValueError(
            f"`array` with shape {tuple(arr.shape)} does not align with the prefactorized "
            f"`by` shape {pf.by_shape}"
        )
    func_name = func if isinstance(func, str) else func.name
    if arr.dtype == torch.bool and func_name in ("sum", "nansum", "prod", "nanprod", "count"):
        arr = arr.to(torch.int64)
    agg = _initialize_aggregation(func, dtype, arr.dtype, fill_value,
                                  _min_count(min_count, fill_value, func_name), finalize_kwargs)

    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (pf.n,))
    if mesh is not None:
        # the staged device codes feed the program directly; cohort detection
        # reads the host codes
        staged = pf.codes_dev is not None and pf.codes_dev.device == dev and method not in (
            None, "cohorts")
        result = _mesh_reduce(arr_flat, pf.codes_dev if staged else pf.codes, agg, size=pf.size,
                              method=method, engine=engine, reindex=None, mesh=mesh,
                              axis_name=axis_name, dev=dev)
        result = result.reshape(agg.new_dims() + lead_shape + pf.group_shape)
        return (result,) + _group_values(pf.found_groups)
    if engine != "numpy":
        engine = _route_highcard(engine, None, arr_flat, lead_shape, pf.size, agg,
                                 explicit=engine_explicit, present=pf.present)
    if engine == "sort":
        result_c = _reduce_blockwise(arr_flat, _staged(pf.ccodes_dev, pf.ccodes, work), agg,
                                     size=pf.ncap, engine="torch")
        result = _redevice_scattered(
            kernels.scatter_present_dense(result_c, pf.present, pf.size), dev)
    else:
        result = _reduce_blockwise(arr_flat, _staged(pf.codes_dev, pf.codes, work), agg,
                                   size=pf.size, engine=engine)
        result = result.to(dev)
    result = result.reshape(agg.new_dims() + lead_shape + pf.group_shape)
    return (result,) + _group_values(pf.found_groups)


def _staged(codes_dev, codes_host: np.ndarray, device: torch.device) -> torch.Tensor:
    """An artifact's codes on ``device``: the staged copy when it lives
    there, else one copy of the host codes."""
    if codes_dev is not None and codes_dev.device == device:
        return codes_dev
    return torch.as_tensor(codes_host, device=device)


def _check_non_numeric(func, dtype, finalize_kwargs, array_dtype) -> None:
    """The entry guard of string and object reductions."""
    if not isinstance(func, str) or func not in _NON_NUMERIC_FUNCS:
        raise TypeError(
            f"non-numeric data (dtype {array_dtype}) supports only {_NON_NUMERIC_FUNCS}; "
            f"got {func!r}"
        )
    if dtype is not None:
        raise TypeError("dtype= is not supported for non-numeric reductions")
    if finalize_kwargs:
        raise NotImplementedError("finalize_kwargs are not supported for non-numeric reductions")


def _reduce_non_numeric(arr: np.ndarray, bys, func: str, *, fill_value, **passthrough):
    """first/last/count of string and object data.

    The values cannot live on the device, but their positions can: a
    float64 position proxy (exact to 2^53 elements) reduces through the
    normal path (nanmin for first, nanmax for last), and the values are
    gathered on the host. Returns a numpy object or string array, or for
    count the count tensor.
    """
    valid = ~utils.isnull_host(arr)
    if func == "count":
        proxy = np.where(valid, 1.0, np.nan)
        return groupby_reduce(proxy, *bys, func="count", fill_value=fill_value, **passthrough)
    pos = np.arange(arr.size, dtype=np.float64).reshape(arr.shape)
    proxy = np.where(valid, pos, np.nan) if func.startswith("nan") else pos
    posr, *groups = groupby_reduce(proxy, *bys, func="nanmin" if "first" in func else "nanmax",
                                   **passthrough)
    posr = posr.cpu().numpy()
    empty = ~np.isfinite(posr)
    out = arr.reshape(-1)[np.where(empty, 0, posr).astype(np.int64)]
    if empty.any():
        if out.dtype.kind in "SU":
            out = out.astype(object)
        out[empty] = fill_value  # None is a fine missing marker for objects
    return (out, *groups)


def _reduce_blockwise(arr_flat, codes_flat, agg: Aggregation, *, size: int, engine: str,
                      datetime_dtype=None):
    """Single-pass eager reduction + finalize. With ``datetime_dtype`` the
    kernels take ``nat=True`` (INT64_MIN is a missing marker, not a value)
    and the result comes back as a numpy array of that dtype."""
    numpy_funcs = list(agg.numpy)
    fills: list[Any] = [agg.final_fill_value] * len(numpy_funcs)
    kdtypes: list[Any] = [None] * len(numpy_funcs)
    base_kwargs = dict(agg.finalize_kwargs)
    if datetime_dtype is not None:
        base_kwargs["nat"] = True
    kwargss: list[dict] = [dict(base_kwargs) for _ in numpy_funcs]

    if agg.min_count > 0:
        numpy_funcs.append("nanlen")
        fills.append(0)
        kdtypes.append(None)
        kwargss.append({"nat": True} if datetime_dtype is not None else {})

    # dtype request for the kernel: the final dtype for accumulating funcs.
    # Not for datetimes: their data is already float64 with NaT as NaN where
    # the result is a float, and an int64 request would cast the NaNs to
    # garbage; the int64 view comes back once, in _astype_final
    if datetime_dtype is None:
        if not agg.preserves_dtype and agg.name in ("sum", "nansum", "prod", "nanprod"):
            kdtypes[0] = agg.final_dtype
        if agg.name in ("mean", "nanmean", "var", "nanvar", "std", "nanstd") and (
            agg.final_dtype.is_floating_point
        ):
            kdtypes[0] = agg.final_dtype

    results = chunk_reduce(
        arr_flat, codes_flat, funcs=numpy_funcs, size=size, fill_values=fills,
        dtypes_=kdtypes, engine=engine, kwargss=kwargss,
    )
    counts = results.pop() if agg.min_count > 0 else None
    if agg.finalize is not None and len(agg.numpy) > 1:
        result = agg.finalize(*results, **agg.finalize_kwargs)
    else:
        result = results[0]
    if counts is not None:
        result = _where(counts < agg.min_count, agg.final_fill_value, result)
    return _astype_final(result, agg, datetime_dtype)


def _where(cond, fill, x: torch.Tensor) -> torch.Tensor:
    if utils.is_nan_fill(fill) and not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64)
    fill_t = torch.as_tensor(fill).to(device=x.device, dtype=x.dtype)
    return torch.where(torch.as_tensor(cond, device=x.device), fill_t, x)


#: datetime reductions whose result is not a point in time: counts, bools and
#: variances (ns^2) stay numeric; so do the argreductions' positions
_DT_KEEP_NUMERIC = frozenset({"count", "len", "any", "all", "var", "nanvar", "std", "nanstd"})


def _astype_final(result: torch.Tensor, agg: Aggregation, datetime_dtype=None):
    if datetime_dtype is not None and agg.preserves_dtype:
        # int64 end to end; missing groups carry INT64_MIN, which is NaT
        res = result.cpu().numpy()
        if res.dtype.kind == "f":  # only through an explicit float fill
            res = np.where(np.isnan(res), kernels._NAT_INT, res)
        return res.astype("int64").view(datetime_dtype)
    if (datetime_dtype is not None and agg.name not in _DT_KEEP_NUMERIC
            and agg.reduction_type != "argreduce"):
        # float epoch values of points in time round back, NaN -> NaT
        res = result.cpu().numpy()
        if res.dtype.kind == "f":
            nanmask = np.isnan(res)
            out = np.round(np.where(nanmask, 0.0, res)).astype("int64")
            out[nanmask] = kernels._NAT_INT
        else:
            out = res.astype("int64")
        return out.view(datetime_dtype)
    final = agg.final_dtype
    if result.dtype != final:
        # don't downcast float results carrying NaN fills into ints (a bool
        # result takes the cast, NaN -> True, as the reference's jax engine does)
        if final not in (torch.bool,) and not (final.is_floating_point or final.is_complex) \
                and result.is_floating_point():
            if bool(torch.isnan(result).any()):
                return result
        if final == torch.uint64 and result.is_floating_point():
            # the reference's float -> uint64 conversion saturates at the top,
            # where torch's wraps 2**64 to 0
            top = torch.tensor(np.iinfo(np.uint64).max, dtype=final, device=result.device)
            return torch.where(result >= 2.0**64, top, result.to(final))
        result = result.to(final)
    return result

