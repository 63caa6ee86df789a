"""xarray adapter: ``xarray_reduce`` (counterpart of ``flox_tpu/xarray.py``).

Groupers by name or as DataArrays, ``dim=...``, skipna rewriting to the
nan-functions, coordinate, attr and dim-order restoration, MultiIndex group
coordinates, and the Dataset recursion, as in the reference. The adapter
binds to real xarray when it is installed and to :mod:`flox_tpu_torch.xrlite`
otherwise.

Where it differs from the reference: each grouper reaches ``groupby_reduce``
with its own dims only. The groupers are broadcast against each other and
over reduced dims they lack, never over the data's other dims: those are the
leading dims that ``groupby_reduce`` keeps, so ``xarray_reduce(da, "month")``
on (lat, lon, time) data hands ``groupby_reduce`` the (time,) labels and
reduces into 12 groups, where the reference factorizes labels broadcast to
(lat, lon, time) into one group per (row, month). The numbers are the same,
except the argreductions' positions: they count along the reduced dims here,
in the flattened (broadcast dims x reduced dims) span in the reference.
Results stay tensors on their device; group coordinates are numpy arrays
(pandas indexes for MultiIndex groupers, and for bins where pandas is
loaded, else :class:`~flox_tpu_torch.types.Bins`).
"""

from __future__ import annotations

from typing import Any, Hashable, Sequence

import numpy as np
import torch

from .aggregations import AGGREGATIONS
from .core import _convert_expected
from .types import Bins
from .utils import HAS_XARRAY, loaded_pandas

__all__ = ["rechunk_for_blockwise", "rechunk_for_cohorts", "xarray_reduce"]

#: the reductions over dims no grouper varies along, where numpy has the
#: function (the reference computes them with the array's own namespace)
_PLAIN_FUNCS = frozenset(f for f in AGGREGATIONS if hasattr(np, f)) | {"count"}


def _get_xr():
    """Real xarray if installed, else the bundled xrlite subset."""
    if HAS_XARRAY:
        import xarray as xr

        return xr
    from . import xrlite

    return xrlite


def _is_interval_index(x) -> bool:
    pd = loaded_pandas()
    return pd is not None and isinstance(x, pd.IntervalIndex)


def _restore_dim_order(result, obj, by, no_groupby_reorder: bool = False):
    """Reorder result dims to match the input object's order, slotting the new
    group dim where the grouped dim was."""

    def lookup_order(dimension):
        if dimension == by.name and by.ndim == 1:
            (dimension,) = by.dims
            if no_groupby_reorder:
                return -1e6  # group dim first
        if dimension in obj.dims:
            return list(obj.dims).index(dimension)
        return 1e6  # new dims (e.g. quantile) go last

    new_order = sorted(result.dims, key=lookup_order)
    return result.transpose(*new_order)


def _rewrite_func_for_skipna(func: str, skipna: bool | None) -> str:
    """skipna=True -> the nan-variant; skipna=False -> the plain variant."""
    if not isinstance(func, str) or skipna is None:
        return func
    if skipna and not func.startswith("nan") and f"nan{func}" in AGGREGATIONS:
        return f"nan{func}"
    if skipna is False and func.startswith("nan"):
        return func.removeprefix("nan")
    return func


def _resolve_dim(dim, by_dims: tuple[Hashable, ...], obj_dims: tuple[Hashable, ...]):
    """dim=None -> reduce over all grouper dims; dim=... -> all object dims."""
    if dim is None:
        return tuple(by_dims)
    if dim is Ellipsis:
        return tuple(obj_dims)
    if isinstance(dim, str):
        return (dim,)
    return tuple(dim)


def _plain_reduce(obj, dims, func: str, finalize_kwargs, keep_attrs: bool, engine, device):
    """Reduction over ``dims`` that no grouper varies along: no groupby.

    With real xarray, the object's own reduction method, as the reference
    does. Otherwise the port's ``groupby_reduce`` over one group spanning
    ``dims`` (the data stays a tensor on its device; torch lacks nanmax,
    nanvar and the nan-argreductions, and ``torch.quantile`` refuses more than
    2^24 elements, while this path has the reference's semantics for each:
    the first NaN position for argmax without skipna, ``ddof``). Explicit
    nan-funcs mean skipna.
    """
    if not isinstance(func, str):
        raise NotImplementedError(
            "func must be a string when reducing along dimensions not in `by`"
        )
    kwargs = dict(finalize_kwargs or {})
    skipna = func.startswith("nan")
    base = func.removeprefix("nan") if skipna else func
    if base in ("argmax", "argmin") and len(dims) != 1:
        raise NotImplementedError("arg-reductions reduce a single dim")

    if HAS_XARRAY and hasattr(obj, base):
        kw = dict(kwargs)
        if skipna:
            kw["skipna"] = True
        kw["keep_attrs"] = keep_attrs
        # scalar dim for arg-reductions: xarray returns a dict for list dims
        dim_arg = dims[0] if base in ("argmax", "argmin") else list(dims)
        return getattr(obj, base)(dim=dim_arg, **kw)

    if func not in _PLAIN_FUNCS:
        raise NotImplementedError(
            f"plain reduction over non-grouper dims has no array-namespace equivalent for "
            f"{func!r}; reduce with groupby_reduce on the raw array."
        )
    from .core import groupby_reduce

    if base == "quantile":
        kwargs.setdefault("q", 0.5)
    out_dims = tuple(d for d in obj.dims if d not in dims)
    data = obj.transpose(*(out_dims + tuple(dims))).data
    one_group = np.zeros([obj.sizes[d] for d in dims], dtype=np.int8)
    result, _ = groupby_reduce(data, one_group, func=func, finalize_kwargs=kwargs or None,
                               engine=engine, device=device)
    result = result[..., 0]
    vector_q = base == "quantile" and np.ndim(kwargs["q"]) > 0
    if vector_q:
        out_dims = ("quantile",) + out_dims
    xr = _get_xr()
    da = xr.DataArray(result, dims=out_dims, name=getattr(obj, "name", None),
                      attrs=dict(obj.attrs) if keep_attrs else {})
    for cname, (cdims, cdata) in getattr(obj, "_coords", {}).items():
        if all(d in out_dims for d in cdims):
            da._coords[cname] = (cdims, cdata)
    if vector_q:
        da = da.assign_coords({"quantile": np.asarray(kwargs["q"], dtype=float)})
    return da


def _bins_coordinate(expected, isbin: bool, sort: bool):
    """The group coordinate of a binned grouper: a ``pd.IntervalIndex`` where
    pandas is loaded (the reference's), else the port's :class:`Bins`."""
    bins = _convert_expected((expected,), (isbin,), sort)[0]
    pd = loaded_pandas()
    if pd is None:
        return bins
    if _is_interval_index(expected):
        return expected
    return pd.IntervalIndex.from_breaks(np.asarray(bins.edges), closed=bins.closed)


def xarray_reduce(
    obj: Any,
    *by: Any,
    func: str,
    expected_groups: Any = None,
    isbin: bool | Sequence[bool] = False,
    sort: bool = True,
    dim: Hashable | Sequence[Hashable] | None = None,
    fill_value: Any = None,
    dtype: Any = None,
    method: str | None = None,
    engine: str | None = None,
    keep_attrs: bool = True,
    skipna: bool | None = None,
    min_count: int | None = None,
    mesh: Any = None,
    device: Any = None,
    **finalize_kwargs: Any,
) -> Any:
    """GroupBy reduction on an xarray (or xrlite) Dataset or DataArray.

    ``by`` entries may be variable or coordinate names, or DataArrays.
    Returns an object of the same type with the reduced dims replaced by one
    dim per grouper (named after the grouper, with the groups as its
    coordinate). ``device`` is passed to ``groupby_reduce``: ``cuda`` unless
    the caller names another; a tensor result stays on it.
    """
    xr = _get_xr()
    from .core import groupby_reduce

    if not by:
        raise TypeError("Must pass at least one `by`")

    func = _rewrite_func_for_skipna(func, skipna)

    if isinstance(obj, xr.Dataset):
        # apply per variable: variables missing the reduced dims pass through
        by_named = [obj[b] if isinstance(b, str) else b for b in by]
        probe_dims = tuple(dict.fromkeys(d for b in by_named for d in b.dims))
        target_dims = _resolve_dim(dim, probe_dims, tuple(obj.dims))
        reduced_vars = {}
        passthrough = {}
        for name, var in obj.data_vars.items():
            if all(d in var.dims for d in target_dims):
                reduced = xarray_reduce(
                    var, *by_named, func=func, expected_groups=expected_groups,
                    isbin=isbin, sort=sort, dim=dim, fill_value=fill_value,
                    dtype=dtype, method=method, engine=engine,
                    keep_attrs=keep_attrs, skipna=None, min_count=min_count,
                    mesh=mesh, device=device, **finalize_kwargs,
                )
                if len(by_named) == 1 and reduced.ndim > 1:
                    # dataset members put the group dim first. The group dim
                    # is the new dim the recursive call made (binned names
                    # included); no new dim means it reuses an existing name
                    # (grouping by a dim coordinate): keep the grouper's name
                    new_dims = [d for d in reduced.dims
                                if d not in var.dims and d != "quantile"]
                    by_o = by_named[0]
                    if new_dims and new_dims[0] != by_o.name:
                        by_o = by_o.rename(new_dims[0])
                    reduced = _restore_dim_order(reduced, var, by_o, no_groupby_reorder=True)
                reduced_vars[name] = reduced
            else:
                passthrough[name] = var
        out = xr.Dataset(reduced_vars, attrs=obj.attrs if keep_attrs else None)
        for name, var in passthrough.items():
            out[name] = var
        return out

    # resolve groupers to DataArrays
    by_das: list = []
    for b in by:
        if isinstance(b, str):
            if b in obj.coords:
                by_das.append(obj[b])
            else:
                raise ValueError(f"Grouper {b!r} not found in object")
        else:
            by_das.append(b)
    by_names = [getattr(b, "name", None) or f"group_{i}" for i, b in enumerate(by_das)]

    def _mi_level_names(b):
        """Level names when the grouper is MultiIndex-backed, else None."""
        pd = loaded_pandas()
        if pd is None:
            return None
        if isinstance(getattr(b, "data", None), pd.MultiIndex):
            return tuple(b.data.names)
        if getattr(b, "ndim", 0) == 1 and hasattr(b, "to_index"):
            try:
                idx = b.to_index()
            except Exception:
                return None
            if isinstance(idx, pd.MultiIndex):
                return tuple(idx.names)
        return None

    mi_names = [_mi_level_names(b) for b in by_das]

    grouper_dims = tuple(dict.fromkeys(d for b in by_das for d in b.dims))
    dims = _resolve_dim(dim, grouper_dims, tuple(obj.dims))
    bad = [d for d in dims if d not in obj.dims]
    if bad:
        raise ValueError(f"Cannot reduce over missing dims {bad}")

    isbin_seq = (isbin,) * len(by_das) if isinstance(isbin, bool) else tuple(isbin)
    if dims and all(d not in grouper_dims for d in dims) and not any(isbin_seq):
        # the groups do not vary along any reduced dim: a plain reduction. The
        # groupers still must align with the object
        for b in by_das:
            for d, sz in b.sizes.items():
                if d not in obj.dims or obj.sizes[d] != sz:
                    raise ValueError(
                        f"grouper {getattr(b, 'name', None)!r} dim {d!r} (size {sz}) does "
                        f"not align with the object (dims {dict(obj.sizes)})"
                    )
        return _plain_reduce(obj, dims, func, finalize_kwargs, keep_attrs, engine, device)

    if HAS_XARRAY:
        xr.align(obj, *by_das, join="exact")

    # broadcast the groupers against each other, and over the reduced dims
    # they lack; never over the data's other dims (module docstring)
    by_b = list(xr.broadcast(*by_das))
    by_dims = tuple(dict.fromkeys(d for b in by_b for d in b.dims))
    missing_dims = tuple(d for d in dims if d not in by_dims)
    if missing_dims:
        sizes = obj.sizes
        by_b = [b.expand_dims({d: sizes[d] for d in missing_dims if d not in b.dims})
                for b in by_b]
        by_b = list(xr.broadcast(*by_b))
        by_dims = tuple(dict.fromkeys(d for b in by_b for d in b.dims))

    nby = len(by_b)
    if expected_groups is None:
        expected_t: tuple = (None,) * nby
    elif nby == 1 and not isinstance(expected_groups, tuple):
        expected_t = (expected_groups,)
    else:
        expected_t = tuple(expected_groups)
    isbin_t = isbin_seq

    reduce_dims = tuple(d for d in by_dims if d in dims)
    # groupby_reduce wants the labels to span the data's trailing dims: core
    # dims are (kept by-dims..., reduced dims...), every grouper in that order
    input_core = list(
        dict.fromkeys(tuple(d for d in by_dims if d not in reduce_dims) + reduce_dims)
    )
    by_arrays = [b.transpose(*input_core).data for b in by_b]

    # a grouper is binned when isbin is set or its expected groups are bins
    binned = [bin_ or _is_interval_index(exp) or isinstance(exp, Bins)
              for bin_, exp in zip(isbin_t, expected_t)]
    new_dim_names = [f"{name}_bins" if b else name for name, b in zip(by_names, binned)]
    keep_by_dims = [d for d in input_core if d not in reduce_dims]
    q = finalize_kwargs.get("q") if finalize_kwargs else None
    has_q_dim = func in ("quantile", "nanquantile") and q is not None and np.ndim(q) > 0
    output_core = keep_by_dims + new_dim_names + (["quantile"] if has_q_dim else [])

    groups_out: list = []
    n_reduce = len(reduce_dims)

    def wrapper(arr):
        result, *groups = groupby_reduce(
            arr,
            *by_arrays,
            func=func,
            axis=tuple(range(-n_reduce, 0)),
            expected_groups=expected_t if any(e is not None for e in expected_t) else None,
            isbin=isbin_t,
            sort=sort,
            fill_value=fill_value,
            dtype=dtype,
            min_count=min_count,
            method=method,
            engine=engine,
            mesh=mesh,
            finalize_kwargs=finalize_kwargs or None,
            device=device,
        )
        groups_out.clear()
        groups_out.extend(groups)
        if has_q_dim:
            # groupby_reduce puts the q dim first; apply_ufunc wants core dims
            # last, so quantile becomes the trailing output dim
            if isinstance(result, torch.Tensor):
                return torch.movedim(result, 0, -1)
            return np.moveaxis(result, 0, -1)
        return result

    actual = xr.apply_ufunc(
        wrapper,
        obj,
        input_core_dims=[input_core],
        output_core_dims=[output_core],
        dask="forbidden",
        keep_attrs=keep_attrs,
        vectorize=False,
        join="exact",
        dataset_fill_value=np.nan,
    )

    def _assign_multiindex(obj_, name, mi):
        """Modern real xarray rejects a raw MultiIndex in assign_coords and
        wants Coordinates.from_pandas_multiindex; xrlite takes the index."""
        if HAS_XARRAY and hasattr(xr, "Coordinates"):
            try:
                return obj_.assign_coords(xr.Coordinates.from_pandas_multiindex(mi, name))
            except Exception:
                pass
        return obj_.assign_coords({name: mi})

    for name, groups, names_mi, bin_, exp in zip(new_dim_names, groups_out, mi_names,
                                                  binned, expected_t):
        if bin_:
            actual = actual.assign_coords({name: _bins_coordinate(exp, True, sort)})
        elif names_mi is not None and len(groups) and isinstance(groups[0], tuple):
            # grouping by a MultiIndex coord: the discovered tuples become a
            # MultiIndex with its level names again
            mi = loaded_pandas().MultiIndex.from_tuples(list(groups), names=names_mi)
            actual = _assign_multiindex(actual, name, mi)
        else:
            actual = actual.assign_coords({name: np.asarray(groups)})
    if has_q_dim:
        actual = actual.assign_coords({"quantile": np.asarray(q, dtype=float)})
    # dim order: slot the group dim where the grouped dim was; the lookup
    # compares against the result's dim name, so binned groupers need the
    # _bins name
    if nby == 1 and actual.ndim > 1:
        by_for_order = by_das[0]
        if new_dim_names[0] != by_names[0]:
            by_for_order = by_for_order.rename(new_dim_names[0])
        actual = _restore_dim_order(actual, obj, by_for_order)
    return actual


def rechunk_for_blockwise(obj, dim: str, labels, n_shards: int | None = None, device=None):
    """Lay ``obj`` out for ``groupby_reduce(..., method='blockwise')`` with
    :func:`flox_tpu_torch.rechunk.rechunk_for_blockwise`.

    Returns ``(resharded DataArray, codes, groups)`` with ``dim`` moved last
    and replaced by the padded shard-local layout (length ``n_shards *
    shard_len``; ``n_shards`` defaults to the ranks of the
    ``torch.distributed`` world). The data is a tensor on ``device``
    (``cuda`` unless the caller asks for the CPU, or the data's own device
    for a tensor).
    """
    xr = _get_xr()
    from . import rechunk as _rechunk

    if isinstance(obj, xr.Dataset):
        raise NotImplementedError(
            "rechunk_for_blockwise takes a DataArray; reshard each variable or use "
            "flox_tpu_torch.rechunk.reshard_for_blockwise directly."
        )
    axis = list(obj.dims).index(dim)
    arr, codes, groups = _rechunk.rechunk_for_blockwise(
        obj.data, axis, np.asarray(getattr(labels, "data", labels)), n_shards, device=device
    )
    new_dims = tuple(d for d in obj.dims if d != dim) + (dim,)
    out = xr.DataArray(
        arr, dims=new_dims, attrs=obj.attrs,
        coords={d: obj.coords[d] for d in obj.coords if d != dim and d in new_dims},
    )
    return out, codes, groups


def rechunk_for_cohorts(obj, dim: str, labels, force_new_chunk_at, chunksize: int | None = None):
    """Chunk lengths for ``dim`` with boundaries anchored at the starts of the
    ``force_new_chunk_at`` labels (:func:`flox_tpu_torch.rechunk.
    rechunk_for_cohorts`): feed them to ``cohorts.find_group_cohorts``, or use
    them as shard sizes."""
    from . import rechunk as _rechunk

    if dim not in getattr(obj, "dims", ()):
        raise ValueError(f"Object has no dim {dim!r}; dims: {tuple(obj.dims)}")
    labels_np = np.asarray(getattr(labels, "data", labels)).reshape(-1)
    dim_len = obj.sizes[dim]
    if labels_np.shape[0] != dim_len:
        raise ValueError(
            f"labels have length {labels_np.shape[0]} but dim {dim!r} has size {dim_len}; "
            "pass labels aligned with that dimension."
        )
    return _rechunk.rechunk_for_cohorts(None, 0, labels_np, force_new_chunk_at,
                                        chunksize=chunksize)
