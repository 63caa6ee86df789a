"""``groupby_reduce`` on one device: the eager path of ``flox_tpu/core.py``.

The chain is the reference's: normalize the labels and the reduced axes on
the host, factorize the labels into dense codes (host, numpy), flatten the
data to (..., N) with the reduced axes last, run the aggregation's kernels
(``chunk_reduce``), mask by ``min_count`` and cast to the final dtype.

The data lives on one torch device, ``cuda`` unless the caller asks for the
CPU; labels and group values stay on the host. Branches of the reference
that later slices port raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from . import factorize as fct, utils
from .aggregations import Aggregation, _initialize_aggregation, generic_aggregate
from .types import Bins

__all__ = ["chunk_reduce", "groupby_reduce"]

#: engines of the reference, and the ROADMAP item that brings each to the port
_UNPORTED_ENGINES = {
    "numpy": "A6 (the host numpy engine is vendored with the label layers)",
    "sort": "A5 (the high-cardinality sort engine)",
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


def _normalize_reduce_axes(arr: torch.Tensor, bys: list[np.ndarray], axis):
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
        arr = arr.permute(list(range(first_by_ax)) + [first_by_ax + d for d in by_order])
    return arr, bys, len(by_keep), bndim


def _choose_engine(engine) -> str:
    if engine is None or engine == "torch":
        return "torch"
    if engine in _UNPORTED_ENGINES:
        raise NotImplementedError(
            f"engine={engine!r} is not available in the port; ROADMAP item: "
            f"{_UNPORTED_ENGINES[engine]}"
        )
    raise ValueError(f"Unknown engine {engine!r}; the port has engine='torch'.")


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
    device: Any = None,
) -> tuple:
    """GroupBy reduction (the signature of ``flox_tpu.groupby_reduce``, plus
    ``device``).

    Returns ``(result, *groups)``: ``result`` is a tensor on ``device`` with
    the reduced axes replaced by one axis per grouper; the groups are numpy
    arrays (a structured ``left``/``right`` array for bins).

    ``device`` defaults to ``cuda`` and raises ``RuntimeError`` when CUDA is
    missing; pass ``device="cpu"`` to run on the CPU. A numpy ``array`` is
    copied to the device, a tensor elsewhere is moved there.

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
    if method is not None or mesh is not None:
        raise NotImplementedError(
            "method=/mesh= (the sharded multi-device path) is not ported yet; ROADMAP A7"
        )
    if reindex not in (None, True, False):
        raise NotImplementedError("reindex strategies are not ported yet; ROADMAP A6")
    engine = _choose_engine(engine)
    nby = len(by)
    if any(type(b).__name__ == "Prefactorized" for b in by):
        raise NotImplementedError("Prefactorized labels are not ported yet; ROADMAP A6")
    if (isinstance(array, torch.Tensor) and array.layout != torch.strided) or hasattr(
        array, "tocoo"
    ) or type(array).__module__.startswith("scipy.sparse"):
        raise NotImplementedError("sparse inputs are not ported yet; ROADMAP A6")

    dev = utils.resolve_device(device)

    # -- host-side label normalization ------------------------------------
    bys = [utils.asarray_host(b) for b in by]
    bys = list(np.broadcast_arrays(*bys)) if nby > 1 else bys
    if not isinstance(array, torch.Tensor):
        host = np.asarray(array)
        if host.dtype.kind in "OSUmM":
            raise NotImplementedError(
                f"{host.dtype} data (non-numeric and datetime reductions) is not ported "
                "yet; ROADMAP A2"
            )
        array = host
    arr = utils.as_tensor(array, dev)
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

    # -- min_count semantics -----------------------------------------------
    if min_count is None:
        min_count_ = 1 if fill_value is not None and func_name in ("nansum", "nanprod") else 0
    else:
        min_count_ = min_count
    agg = _initialize_aggregation(func, dtype, arr.dtype, fill_value, min_count_, finalize_kwargs)

    # -- flatten for the kernels: (..., span) with the reduced span last --
    span = int(np.prod(keep_by_shape + nred_shape)) if (keep_by_shape or nred_shape) else 1
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (span,))
    codes_flat = torch.as_tensor(np.asarray(codes).reshape(-1), device=dev)

    result = _reduce_blockwise(arr_flat, codes_flat, agg, size=size, engine=engine)

    # -- reshape: (..., size) -> (..., *keep_by, *grp_shape) ---------------
    result = result.reshape(lead_shape + keep_by_shape + grp_shape)
    groups = tuple(g.values() if isinstance(g, Bins) else np.asarray(g) for g in found_groups)
    return (result,) + groups


def _reduce_blockwise(arr_flat, codes_flat, agg: Aggregation, *, size: int, engine: str):
    """Single-pass eager reduction + finalize."""
    numpy_funcs = list(agg.numpy)
    fills: list[Any] = [agg.final_fill_value] * len(numpy_funcs)
    kdtypes: list[Any] = [None] * len(numpy_funcs)
    kwargss: list[dict] = [dict(agg.finalize_kwargs) for _ in numpy_funcs]

    if agg.min_count > 0:
        numpy_funcs.append("nanlen")
        fills.append(0)
        kdtypes.append(None)
        kwargss.append({})

    # dtype request for the kernel: the final dtype for accumulating funcs
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
    return _astype_final(result, agg)


def _where(cond, fill, x: torch.Tensor) -> torch.Tensor:
    if utils.is_nan_fill(fill) and not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64)
    fill_t = torch.as_tensor(fill).to(device=x.device, dtype=x.dtype)
    return torch.where(torch.as_tensor(cond, device=x.device), fill_t, x)


def _astype_final(result: torch.Tensor, agg: Aggregation) -> torch.Tensor:
    final = agg.final_dtype
    if result.dtype != final:
        # don't downcast float results carrying NaN fills into ints (a bool
        # result takes the cast, NaN -> True, as the reference's jax engine does)
        if final not in (torch.bool,) and not (final.is_floating_point or final.is_complex) \
                and result.is_floating_point():
            if bool(torch.isnan(result).any()):
                return result
        result = result.to(final)
    return result

