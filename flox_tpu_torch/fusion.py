"""Multi-statistic fusion: ``groupby_aggregate_many`` on one device (the eager
path of ``flox_tpu/fusion.py``).

A climatology asking for mean, std, min and max over the same labels would
read the data once per statistic through ``groupby_reduce``. Here the fusion
planner (``aggregations.plan_fused``) merges the requested statistics into
one deduplicated set of chunk legs: mean reads the variance triple's total
and count, presence counts collapse to one leg, and the sums, counts, minima
and maxima of float32/bfloat16 data come from one pass of the multi-statistic
kernel (``cuda_kernels.segment_multistat``). Each result equals the
corresponding ``groupby_reduce(..., func=f)`` call.

The chain is ``core.groupby_reduce``'s up to the kernels: labels normalized
and factorized on the host (or taken from a ``Prefactorized`` artifact, whose
codes are staged on the device), data flattened to (..., N) on the device. As
in the reference, ``engine="sort"`` runs this dense fused path, and a plan
whose dense (..., size) intermediates would pass
``dense_intermediate_bytes_max`` raises; ``engine="numpy"`` runs every leg on
the host engine and copies the results to the device. Branches that later
slices port raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import factorize as fct, utils
from .aggregations import FUSABLE_FUNCS, FusedAggregation, fused_chunk_stats, plan_fused
from .core import (
    _assert_by_is_aligned,
    _astype_final,
    _choose_engine,
    _convert_expected,
    _group_values,
    _normalize_expected,
    _normalize_isbin,
    _normalize_reduce_axes,
    _staged,
    _work_device,
    dense_intermediate_bytes,
)
from .options import OPTIONS
from .sparse import is_sparse_array

__all__ = ["FUSABLE_FUNCS", "finalize_many", "groupby_aggregate_many"]

_ADDLIKE = frozenset({"sum", "nansum", "prod", "nanprod"})
_BOOLSAFE = frozenset({"all", "any", "count"})


def finalize_many(fused: FusedAggregation, results, out_shape=None) -> dict:
    """Per-statistic final dtype casts (and reshape): ``{func: tensor}``."""
    out = {}
    for f, agg, r in zip(fused.funcs, fused.aggs, results):
        r = _astype_final(r, agg)
        if out_shape is not None and tuple(r.shape) != tuple(out_shape):
            r = r.reshape(out_shape)
        out[f] = r
    return out


def groupby_aggregate_many(
    array: Any,
    *by: Any,
    funcs: tuple | list = ("sum", "count", "min", "max", "var"),
    expected_groups: Any = None,
    sort: bool = True,
    isbin: Any = False,
    axis: Any = None,
    fill_value: Any = None,
    dtype: Any = None,
    min_count: int | None = None,
    engine: str | None = None,
    finalize_kwargs: dict | None = None,
    method: str | None = None,
    mesh: Any = None,
    device: Any = None,
) -> tuple:
    """N grouped statistics in one pass over the data (the signature of
    ``flox_tpu.groupby_aggregate_many``, plus ``device``).

    Returns ``(results, *groups)``: ``results`` maps each requested func, in
    request order, to a tensor on ``device``. ``funcs`` are names from
    :data:`FUSABLE_FUNCS`. ``fill_value``, ``dtype`` and ``finalize_kwargs``
    take one value for all statistics or a per-func dict, e.g.
    ``finalize_kwargs={"var": {"ddof": 1}}``. ``device`` defaults to ``cuda``
    and raises ``RuntimeError`` when CUDA is missing; pass ``device="cpu"`` to
    run on the CPU.

    Examples
    --------
    >>> import numpy as np
    >>> from flox_tpu_torch import groupby_aggregate_many
    >>> values = np.array([1.0, 2.0, 4.0, 8.0])
    >>> labels = np.array([0, 0, 1, 1])
    >>> out, groups = groupby_aggregate_many(
    ...     values, labels, funcs=("sum", "max"), device="cpu")
    >>> out["sum"]
    tensor([ 3., 12.], dtype=torch.float64)
    >>> out["max"]
    tensor([2., 8.], dtype=torch.float64)
    """
    return _aggregate_many_impl(
        array, *by, funcs=tuple(funcs), expected_groups=expected_groups, sort=sort,
        isbin=isbin, axis=axis, fill_value=fill_value, dtype=dtype, min_count=min_count,
        engine=engine, finalize_kwargs=finalize_kwargs, method=method, mesh=mesh,
        device=device,
    )


def _aggregate_many_impl(array, *by, funcs: tuple, expected_groups, sort, isbin, axis,
                         fill_value, dtype, min_count, engine, finalize_kwargs, method, mesh,
                         device) -> tuple:
    if not by:
        raise TypeError("Must pass at least one `by`")
    if method is not None or mesh is not None:
        raise NotImplementedError(
            "method=/mesh= (the fused plan as one multi-device program) is not ported "
            "yet; ROADMAP A7"
        )
    if is_sparse_array(array):
        raise NotImplementedError(
            "sparse inputs are not fusable; run sequential groupby_reduce calls")
    nby = len(by)
    if nby == 1 and isinstance(by[0], fct.Prefactorized):
        return _aggregate_many_prefactorized(
            array, by[0], funcs=funcs, expected_groups=expected_groups, isbin=isbin, axis=axis,
            fill_value=fill_value, dtype=dtype, min_count=min_count, engine=engine,
            finalize_kwargs=finalize_kwargs, device=device,
        )
    engine = _choose_engine(engine)
    dev = utils.resolve_device(device)
    work = _work_device(engine, dev)

    bys = [utils.asarray_host(b) for b in by]
    bys = list(np.broadcast_arrays(*bys)) if nby > 1 else bys
    arr = _fusable_tensor(array, funcs, work)
    _assert_by_is_aligned(tuple(arr.shape), bys)
    expected = _normalize_expected(expected_groups, nby)
    expected_idx = _convert_expected(expected, _normalize_isbin(isbin, nby), sort)

    arr, bys, n_keep, bndim = _normalize_reduce_axes(arr, bys, axis)
    keep_by_shape = tuple(bys[0].shape[:n_keep])
    codes, found_groups, grp_shape, ngroups, size, _props = fct.factorize_cached(
        tuple(bys), axes=tuple(range(n_keep, bndim)), expected_groups=expected_idx, sort=sort
    )
    if ngroups == 0 or size == 0:
        raise ValueError("No groups to reduce over (empty expected_groups?)")

    min_count_ = 0 if min_count is None else min_count
    fused = plan_fused(funcs, dtype, arr.dtype, fill_value, min_count_, finalize_kwargs)

    span = int(np.prod(bys[0].shape)) if bys[0].size else 0
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (span,))
    codes_flat = torch.as_tensor(np.asarray(codes).reshape(-1), device=work)
    out = _run_fused(fused, codes_flat, arr_flat, size, lead_shape + keep_by_shape + grp_shape,
                     engine, dev)
    return (out,) + _group_values(found_groups)


def _fusable_tensor(array, funcs: tuple, device: torch.device) -> torch.Tensor:
    """The data of a fused call as a tensor on ``device``: numeric only, and
    bools under core's rule, set-wide."""
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
        if array.dtype.kind in "OSUmM":
            raise NotImplementedError(
                f"groupby_aggregate_many supports numeric data; got {array.dtype} "
                "(datetime/object inputs keep the sequential groupby_reduce path)"
            )
    arr = utils.as_tensor(array, device)
    if arr.dtype == torch.bool:
        # core's bool rule, set-wide: additive reductions need the int view;
        # all/any/count are bool-native. A set mixing bools into float or
        # extrema statistics has no one input view that matches every
        # sequential call.
        if set(funcs) <= _BOOLSAFE:
            pass
        elif set(funcs) <= (_ADDLIKE | _BOOLSAFE):
            arr = arr.to(torch.int64)
        else:
            raise NotImplementedError(
                f"bool data fuses only {sorted(_ADDLIKE | _BOOLSAFE)}; run "
                f"{sorted(set(funcs) - _ADDLIKE - _BOOLSAFE)} sequentially"
            )
    return arr


def _aggregate_many_prefactorized(array, pf: "fct.Prefactorized", *, funcs: tuple,
                                  expected_groups, isbin, axis, fill_value, dtype, min_count,
                                  engine, finalize_kwargs, device) -> tuple:
    """The fused statistics over a :class:`~flox_tpu_torch.factorize.
    Prefactorized` ``by``: the inline body from the engine choice on, minus
    the factorization and minus the codes' copy (the staged ``codes_dev``
    feeds the kernels)."""
    bad = [name for name, val in (("expected_groups", expected_groups), ("axis", axis))
           if val is not None]
    if isbin not in (False, (False,)):
        bad.append("isbin")
    if bad:
        raise NotImplementedError(
            f"Prefactorized `by` does not support {bad}: the factorization is fixed when "
            "the artifact is built (prefactorize again with other groups)"
        )
    engine = _choose_engine(engine)
    dev = utils.resolve_device(device)
    work = _work_device(engine, dev)
    arr = _fusable_tensor(array, funcs, work)
    bndim = len(pf.by_shape)
    if arr.ndim < bndim or tuple(arr.shape[arr.ndim - bndim:]) != tuple(pf.by_shape):
        raise ValueError(
            f"`array` with shape {tuple(arr.shape)} does not align with the prefactorized "
            f"`by` shape {pf.by_shape}"
        )
    min_count_ = 0 if min_count is None else min_count
    fused = plan_fused(funcs, dtype, arr.dtype, fill_value, min_count_, finalize_kwargs)
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (pf.n,))
    out = _run_fused(fused, _staged(pf.codes_dev, pf.codes, work), arr_flat, pf.size,
                     lead_shape + pf.group_shape, engine, dev)
    return (out,) + _group_values(pf.found_groups)


def _run_fused(fused: FusedAggregation, codes_flat: torch.Tensor, arr_flat: torch.Tensor,
               size: int, out_shape: tuple, engine: str, dev: torch.device) -> dict:
    """The chunk legs and every finalize of a fused plan: on the host engine
    with one copy of each result to ``dev``, or dense on the device under the
    dense-intermediate ceiling (the sort engine included, as in the
    reference)."""
    if engine == "numpy":
        inters = fused_chunk_stats(fused, codes_flat, arr_flat, size=size, engine="numpy")
        out = finalize_many(fused, fused.finalize_fused(inters), out_shape)
        return {f: r.to(dev) for f, r in out.items()}
    lead_elems = int(np.prod(arr_flat.shape[:-1]))
    est = dense_intermediate_bytes(lead_elems, size, arr_flat.dtype, fused)
    ceiling = OPTIONS["dense_intermediate_bytes_max"]
    if est > ceiling:
        raise ValueError(
            f"{fused.name!r} over {size} groups needs ~{utils.fmt_bytes(est)} "
            f"of dense (..., size) device intermediates, above the "
            f"{utils.fmt_bytes(ceiling)} dense_intermediate_bytes_max ceiling. "
            "Options: reduce expected_groups; or raise "
            "set_options(dense_intermediate_bytes_max=...)."
        )

    inters = fused_chunk_stats(fused, codes_flat, arr_flat, size=size, engine="torch")
    return finalize_many(fused, fused.finalize_fused(inters), out_shape)
