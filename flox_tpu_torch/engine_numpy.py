"""The "numpy" engine: grouped reductions and scans on the host, with numpy.

A copy of ``flox_tpu/engine_numpy.py`` (the reference's host engine, built on
``ufunc.at`` scatters and ``bincount``), kept beside the torch engine as the
reference keeps it beside its jax engine: an independent implementation for
cross-checks, and the engine of ``engine="numpy"`` /
``set_options(default_engine="numpy")``. ``aggregations.generic_aggregate``
hands it host numpy arrays and turns its results into CPU tensors; the entry
points then put the result on the call's device in one copy.

The port does not adopt the reference's size heuristic (its
``_choose_engine`` sends small host arrays here): the port's entry points run
on the card unless the caller asks otherwise, so this engine runs when named,
or, with the autotuner on, when it won the ``engine`` family's sweep for host
data reduced on the CPU (``core._tuned_engine``).

Arrays are (..., N) with ``group_idx`` (N,), code -1 = missing; returns
(..., size) like the torch engine.
"""

from __future__ import annotations

import numpy as np

__all__ = ["KERNELS", "generic_kernel"]


def _acc_dtype(dt):
    """f32 accumulation for sub-f32 floats (mirrors kernels._acc_dtype):
    f16/bf16 running sums and counts saturate at the narrow mantissa.
    bfloat16 registers with numpy as kind 'V', so match it by name."""
    dt = np.dtype(dt)
    if (dt.kind == "f" and dt.itemsize < 4) or dt.name == "bfloat16":
        return np.dtype(np.float32)
    return dt


def _prep(group_idx, array):
    """Transpose to (N, ...) and drop missing labels from the scatter."""
    codes = np.asarray(group_idx).reshape(-1).astype(np.int64)
    data = np.moveaxis(np.asarray(array), -1, 0)
    valid = codes >= 0
    return codes, data, valid


def _scatter(ufunc, codes, data, valid, size, init, dtype=None):
    out = np.full((size,) + data.shape[1:], init, dtype=dtype or data.dtype)
    ufunc.at(out, codes[valid], data[valid])
    return out


def _apply_fill(out, codes, valid, size, fill_value, identity=None):
    """Replace groups with no labelled elements by ``fill_value`` (shared by
    the add-like, count, and bool kernels so promotion rules stay aligned).
    ``out`` is (size, ...); returns possibly-promoted array."""
    if fill_value is None or (identity is not None and fill_value == identity):
        return out
    present = np.bincount(codes[valid], minlength=size) > 0
    present = np.broadcast_to(
        present.reshape((size,) + (1,) * (out.ndim - 1)), out.shape
    )
    inexact = np.issubdtype(out.dtype, np.floating) or np.issubdtype(
        out.dtype, np.complexfloating
    )
    if _nanlike(fill_value) and not inexact:
        out = out.astype(np.float64)
    return np.where(present, out, fill_value)


def _nanlike(v) -> bool:
    from . import utils as _u

    return _u.is_nan_fill(v)


_NAT_INT = np.iinfo(np.int64).min  # NaT viewed as int64 (core passes nat=True)


def _nan_mask(data, nat=False):
    if np.issubdtype(data.dtype, np.floating) or np.issubdtype(data.dtype, np.complexfloating):
        return ~np.isnan(data)
    if nat and np.issubdtype(data.dtype, np.signedinteger):
        return data != _NAT_INT
    return None


def _make_addlike(ufunc, identity, skipna):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        codes, data, valid = _prep(group_idx, array)
        mask = _nan_mask(data, kw.get("nat", False)) if skipna else None
        if mask is not None:
            data = np.where(mask, data, identity)
        if dtype is not None:
            data = data.astype(dtype, copy=False)
        out_dtype = data.dtype
        acc = _acc_dtype(out_dtype)
        out = _scatter(ufunc, codes, data.astype(acc, copy=False), valid, size, identity, acc)
        out = _apply_fill(out, codes, valid, size, fill_value, identity)
        if out.dtype == acc and acc != out_dtype:
            out = out.astype(out_dtype)
        return np.moveaxis(out, 0, -1)

    return kernel


sum_ = _make_addlike(np.add, 0, skipna=False)
nansum = _make_addlike(np.add, 0, skipna=True)
prod = _make_addlike(np.multiply, 1, skipna=False)
nanprod = _make_addlike(np.multiply, 1, skipna=True)


def _make_minmax(ufunc, is_max, skipna):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        codes, data, valid = _prep(group_idx, array)
        if dtype is not None:
            data = data.astype(dtype, copy=False)
        mask = _nan_mask(data, kw.get("nat", False))
        isfloat = np.issubdtype(data.dtype, np.floating)
        if isfloat:
            init = -np.inf if is_max else np.inf
        elif np.issubdtype(data.dtype, np.integer):
            info = np.iinfo(data.dtype)
            init = info.min if is_max else info.max
        else:
            init = False if is_max else True
        missing_marker = np.nan if isfloat else _NAT_INT
        absorb = init if isfloat else (np.iinfo(data.dtype).max if is_max else np.iinfo(data.dtype).min) if np.issubdtype(data.dtype, np.integer) else init
        work = data
        if mask is not None:
            work = np.where(mask, data, init if skipna else absorb)
        out = _scatter(ufunc, codes, work, valid, size, init)
        if mask is not None and not skipna:
            has_nan = np.zeros((size,) + data.shape[1:], dtype=bool)
            np.logical_or.at(has_nan, codes[valid], ~mask[valid])
            out = np.where(has_nan, missing_marker, out)
        if skipna and mask is not None:
            cnt = np.zeros((size,) + data.shape[1:], dtype=np.intp)
            np.add.at(cnt, codes[valid], mask[valid].astype(np.intp))
            present = cnt > 0
        else:
            present = np.bincount(codes[valid], minlength=size) > 0
        fv = fill_value
        if fv is None:
            fv = np.nan if isfloat else init
        inexact = np.issubdtype(out.dtype, np.floating) or np.issubdtype(
            out.dtype, np.complexfloating
        )
        if _nanlike(fv) and not inexact:
            out = out.astype(np.float64)
        out = np.where(
            np.broadcast_to(
                present.reshape(present.shape + (1,) * (out.ndim - present.ndim)), out.shape
            ),
            out,
            fv,
        )
        return np.moveaxis(out, 0, -1)

    return kernel


max_ = _make_minmax(np.maximum, True, skipna=False)
nanmax = _make_minmax(np.maximum, True, skipna=True)
min_ = _make_minmax(np.minimum, False, skipna=False)
nanmin = _make_minmax(np.minimum, False, skipna=True)


def nanlen(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    codes, data, valid = _prep(group_idx, array)
    mask = _nan_mask(data, kw.get("nat", False))
    if mask is None:
        out = np.bincount(codes[valid], minlength=size).astype(dtype or np.intp)
        out = np.broadcast_to(
            out.reshape((size,) + (1,) * (data.ndim - 1)), (size,) + data.shape[1:]
        ).copy()
    else:
        out = np.zeros((size,) + data.shape[1:], dtype=dtype or np.intp)
        np.add.at(out, codes[valid], mask[valid].astype(out.dtype))
    out = _apply_fill(out, codes, valid, size, fill_value, identity=0)
    return np.moveaxis(out, 0, -1)


def len_(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    codes, data, valid = _prep(group_idx, array)
    out = np.bincount(codes[valid], minlength=size).astype(dtype or np.intp)
    out = np.broadcast_to(
        out.reshape((size,) + (1,) * (data.ndim - 1)), (size,) + data.shape[1:]
    ).copy()
    return np.moveaxis(out, 0, -1)


def _mean_impl(group_idx, array, *, size, fill_value, dtype, skipna):
    codes, data, valid = _prep(group_idx, array)
    mask = _nan_mask(data) if skipna else None
    if dtype is None:
        dtype = np.result_type(data.dtype, np.float64) if data.dtype.kind in "iub" else data.dtype
    out_dtype = np.dtype(dtype)
    dtype = _acc_dtype(out_dtype)
    work = data if mask is None else np.where(mask, data, 0)
    total = _scatter(np.add, codes, work.astype(dtype, copy=False), valid, size, 0, dtype)
    if mask is None:
        cnt = np.bincount(codes[valid], minlength=size).astype(dtype)
        cnt = cnt.reshape((size,) + (1,) * (total.ndim - 1))
    else:
        cnt = np.zeros((size,) + data.shape[1:], dtype=dtype)
        np.add.at(cnt, codes[valid], mask[valid].astype(dtype))
    with np.errstate(invalid="ignore", divide="ignore"):
        out = total / cnt
    empty = np.broadcast_to(cnt, out.shape) == 0
    out = np.where(empty, np.nan if fill_value is None else fill_value, out)
    if out.dtype != out_dtype and out_dtype.kind == "f":
        out = out.astype(out_dtype)
    return np.moveaxis(out, 0, -1)


def mean(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mean_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, skipna=False)


def nanmean(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mean_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, skipna=True)


def _var_impl(group_idx, array, *, size, fill_value, dtype, ddof, skipna, take_sqrt):
    codes, data, valid = _prep(group_idx, array)
    mask = _nan_mask(data) if skipna else None
    if dtype is None:
        dtype = np.result_type(data.dtype, np.float64) if data.dtype.kind in "iub" else data.dtype
    out_dtype = np.dtype(dtype)
    dtype = _acc_dtype(out_dtype)
    work = (data if mask is None else np.where(mask, data, 0)).astype(dtype, copy=False)
    total = _scatter(np.add, codes, work, valid, size, 0, dtype)
    if mask is None:
        cnt1d = np.bincount(codes[valid], minlength=size).astype(dtype)
        cnt = cnt1d.reshape((size,) + (1,) * (total.ndim - 1))
    else:
        cnt = np.zeros((size,) + data.shape[1:], dtype=dtype)
        np.add.at(cnt, codes[valid], mask[valid].astype(dtype))
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_g = total / np.where(cnt > 0, cnt, 1)
    dev = work - np.broadcast_to(mean_g, (size,) + data.shape[1:])[codes.clip(0, size - 1)]
    dev = np.where(valid.reshape((-1,) + (1,) * (dev.ndim - 1)), dev, 0)
    if mask is not None:
        dev = np.where(mask, dev, 0)
    m2 = _scatter(np.add, codes, dev * dev, valid, size, 0, dtype)
    denom = np.broadcast_to(cnt, m2.shape) - ddof
    with np.errstate(invalid="ignore", divide="ignore"):
        out = m2 / denom
    out = np.where(denom > 0, out, np.nan)
    if take_sqrt:
        out = np.sqrt(out)
    empty = np.broadcast_to(cnt, out.shape) == 0
    out = np.where(empty, np.nan if fill_value is None else fill_value, out)
    if out.dtype != out_dtype and out_dtype.kind == "f":
        out = out.astype(out_dtype)
    return np.moveaxis(out, 0, -1)


def var(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, ddof=0, **kw):
    return _var_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, ddof=ddof, skipna=False, take_sqrt=False)


def nanvar(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, ddof=0, **kw):
    return _var_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, ddof=ddof, skipna=True, take_sqrt=False)


def std(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, ddof=0, **kw):
    return _var_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, ddof=ddof, skipna=False, take_sqrt=True)


def nanstd(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, ddof=0, **kw):
    return _var_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, ddof=ddof, skipna=True, take_sqrt=True)


def var_chunk(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, skipna=True, **kw):
    from .multiarray import MultiArray

    codes, data, valid = _prep(group_idx, array)
    mask = _nan_mask(data) if skipna else None
    if dtype is None:
        dtype = np.result_type(data.dtype, np.float64) if data.dtype.kind in "iub" else data.dtype
    dtype = _acc_dtype(dtype)  # intermediates stay f32 (cast at finalize)
    work = (data if mask is None else np.where(mask, data, 0)).astype(dtype, copy=False)
    total = _scatter(np.add, codes, work, valid, size, 0, dtype)
    cnt = np.zeros((size,) + data.shape[1:], dtype=dtype)
    contrib = np.ones(data.shape, dtype=dtype) if mask is None else mask.astype(dtype)
    np.add.at(cnt, codes[valid], contrib[valid])
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_g = total / np.where(cnt > 0, cnt, 1)
    mean_b = np.broadcast_to(mean_g, (size,) + data.shape[1:])
    dev = work - mean_b[codes.clip(0, size - 1)]
    dev = np.where(valid.reshape((-1,) + (1,) * (dev.ndim - 1)), dev, 0)
    if mask is not None:
        dev = np.where(mask, dev, 0)
    m2 = _scatter(np.add, codes, dev * dev, valid, size, 0, dtype)
    bshape = np.broadcast_shapes(total.shape, cnt.shape)
    return MultiArray(
        (
            np.moveaxis(np.broadcast_to(m2, bshape).copy(), 0, -1),
            np.moveaxis(np.broadcast_to(total, bshape).copy(), 0, -1),
            np.moveaxis(np.broadcast_to(cnt, bshape).copy(), 0, -1),
        )
    )


def all_(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    codes, data, valid = _prep(group_idx, array)
    out = np.ones((size,) + data.shape[1:], dtype=bool)
    np.logical_and.at(out, codes[valid], data[valid].astype(bool))
    out = _apply_fill(out, codes, valid, size, fill_value)
    return np.moveaxis(out, 0, -1)


def any_(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    codes, data, valid = _prep(group_idx, array)
    out = np.zeros((size,) + data.shape[1:], dtype=bool)
    np.logical_or.at(out, codes[valid], data[valid].astype(bool))
    out = _apply_fill(out, codes, valid, size, fill_value)
    return np.moveaxis(out, 0, -1)


def _arg_impl(group_idx, array, *, size, fill_value, skipna, arg_of_max, nat=False):
    codes, data, valid = _prep(group_idx, array)
    mask = _nan_mask(data, nat)
    if data.dtype.kind in "iub" and mask is not None:
        # nat ints (datetime64 viewed as int64): keep integer precision
        info = np.iinfo(data.dtype)
        lo, hi = info.min + 1, info.max
        key = data.copy()
        key[~mask] = (lo if arg_of_max else hi) if skipna else (hi if arg_of_max else lo)
        init = lo if arg_of_max else hi
    else:
        key = data.astype(np.float64, copy=True) if data.dtype.kind in "iub" else data.copy()
        if mask is not None:
            if skipna:
                key[~mask] = -np.inf if arg_of_max else np.inf
            else:
                key[~mask] = np.inf if arg_of_max else -np.inf
        init = -np.inf if arg_of_max else np.inf
    best = _scatter(np.maximum if arg_of_max else np.minimum, codes, key, valid, size, init)
    hit = key == best[codes.clip(0, size - 1)]
    n = data.shape[0]
    iota = np.broadcast_to(np.arange(n).reshape((n,) + (1,) * (data.ndim - 1)), data.shape)
    cand = np.where(hit, iota, n)
    if skipna and mask is not None:
        cand = np.where(mask, cand, n)
    pos = _scatter(np.minimum, codes, cand, valid, size, n)
    if not skipna and mask is not None:
        # numpy parity: any NaN (NaT) in the group short-circuits the value
        # race — the first missing position is the answer (even over ±inf)
        first_nan = _scatter(np.minimum, codes, np.where(mask, n, iota), valid, size, n)
        pos = np.where(first_nan < n, first_nan, pos)
    if skipna and mask is not None:
        cnt = np.zeros((size,) + data.shape[1:], dtype=np.intp)
        np.add.at(cnt, codes[valid], mask[valid].astype(np.intp))
        present = cnt > 0
    else:
        present = np.bincount(codes[valid], minlength=size) > 0
    fv = -1 if fill_value is None else fill_value
    present = np.broadcast_to(
        present.reshape(present.shape + (1,) * (pos.ndim - present.ndim)), pos.shape
    )
    out = np.where(present & (pos < n), pos, fv)
    return np.moveaxis(out, 0, -1)


def argmax(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _arg_impl(group_idx, array, size=size, fill_value=fill_value, skipna=False, arg_of_max=True, nat=kw.get("nat", False))


def argmin(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _arg_impl(group_idx, array, size=size, fill_value=fill_value, skipna=False, arg_of_max=False, nat=kw.get("nat", False))


def nanargmax(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _arg_impl(group_idx, array, size=size, fill_value=fill_value, skipna=True, arg_of_max=True, nat=kw.get("nat", False))


def nanargmin(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _arg_impl(group_idx, array, size=size, fill_value=fill_value, skipna=True, arg_of_max=False, nat=kw.get("nat", False))


def _firstlast_impl(group_idx, array, *, size, fill_value, skipna, last, nat=False):
    codes, data, valid = _prep(group_idx, array)
    mask = _nan_mask(data, nat) if skipna else None
    n = data.shape[0]
    iota = np.broadcast_to(np.arange(n).reshape((n,) + (1,) * (data.ndim - 1)), data.shape)
    if mask is not None:
        iota = np.where(mask, iota, -1 if last else n)
    pos = _scatter(np.maximum if last else np.minimum, codes, iota, valid, size, -1 if last else n)
    ok = (pos >= 0) & (pos < n)
    gathered = np.take_along_axis(data, pos.clip(0, n - 1), axis=0)
    is_inexact = np.issubdtype(data.dtype, np.floating) or np.issubdtype(
        data.dtype, np.complexfloating
    )
    fv = fill_value
    if fv is None:
        fv = np.nan if is_inexact else 0
    if _nanlike(fv) and not is_inexact:
        gathered = gathered.astype(np.float64)
    out = np.where(ok, gathered, fv)
    return np.moveaxis(out, 0, -1)


def first(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _firstlast_impl(group_idx, array, size=size, fill_value=fill_value, skipna=False, last=False, nat=kw.get("nat", False))


def last(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _firstlast_impl(group_idx, array, size=size, fill_value=fill_value, skipna=False, last=True, nat=kw.get("nat", False))


def nanfirst(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _firstlast_impl(group_idx, array, size=size, fill_value=fill_value, skipna=True, last=False, nat=kw.get("nat", False))


def nanlast(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _firstlast_impl(group_idx, array, size=size, fill_value=fill_value, skipna=True, last=True, nat=kw.get("nat", False))


def _orderstat_loop(group_idx, array, *, size, fill_value, func):
    """Per-group python loop for order statistics; the numpy engine trades
    speed for simplicity here (the jax engine is the fast path)."""
    codes, data, valid = _prep(group_idx, array)  # (N, ...)
    first_shape = data.shape[1:]
    out = None
    for g in range(size):
        sel = (codes == g) & valid
        grp = data[sel]  # (k, ...)
        res = func(grp)
        if out is None:
            out = np.full((size,) + np.shape(res), fill_value if fill_value is not None else np.nan, dtype=np.result_type(np.float64, data.dtype))
        if grp.shape[0] == 0:
            continue  # leave the fill for empty groups
        out[g] = res
    if out is None:
        out = np.full((size,) + first_shape, fill_value if fill_value is not None else np.nan)
    return np.moveaxis(out, 0, -1)


def _quantile_impl(group_idx, array, *, size, fill_value, q, skipna, method="linear"):
    qs = np.atleast_1d(q)
    qfunc = np.nanquantile if skipna else np.quantile

    def per_group(grp):
        if grp.shape[0] == 0 or (skipna and np.all(np.isnan(grp))):
            return np.full((len(qs),) + grp.shape[1:], np.nan)
        with np.testing.suppress_warnings() as sup:
            sup.filter(RuntimeWarning)
            return qfunc(grp, qs, axis=0, method=method)

    out = _orderstat_loop(group_idx, array, size=size, fill_value=fill_value, func=per_group)
    # out: (..., nq at axis -2? ) — per_group returns (nq, cols...), loop stacks
    # to (size, nq, cols...) then moveaxis -> (nq, cols..., size)? Normalize:
    # _orderstat_loop gives (nq, cols..., size) after moveaxis of axis0.
    if np.ndim(q) == 0:
        out = out[0] if out.shape[0] == 1 else np.squeeze(out, axis=0)
    return out


def quantile(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, q, method="linear", **kw):
    return _quantile_impl(group_idx, array, size=size, fill_value=fill_value, q=q, skipna=False, method=method)


def nanquantile(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, q, method="linear", **kw):
    return _quantile_impl(group_idx, array, size=size, fill_value=fill_value, q=q, skipna=True, method=method)


def median(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _quantile_impl(group_idx, array, size=size, fill_value=fill_value, q=0.5, skipna=False)


def nanmedian(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _quantile_impl(group_idx, array, size=size, fill_value=fill_value, q=0.5, skipna=True)


def _mode_impl(group_idx, array, *, size, fill_value, skipna):
    def per_group(grp):
        if grp.shape[0] == 0:
            return np.full(grp.shape[1:], np.nan)
        out = np.empty(grp.shape[1:])
        flat = grp.reshape(grp.shape[0], -1)
        res = []
        for col in flat.T:
            c = col
            if skipna:
                c = c[~np.isnan(c)] if np.issubdtype(c.dtype, np.floating) else c
            if c.size == 0:
                res.append(np.nan)
                continue
            # scipy.stats.mode "propagate" (scipy >= 1.11): NaNs count as ONE
            # candidate value with their multiplicity — np.unique's equal_nan
            # collapse delivers exactly that; skipna dropped them above
            vals, cnts = np.unique(c, return_counts=True)
            res.append(vals[np.argmax(cnts)])
        return np.array(res).reshape(grp.shape[1:])

    return _orderstat_loop(group_idx, array, size=size, fill_value=fill_value, func=per_group)


def mode(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mode_impl(group_idx, array, size=size, fill_value=fill_value, skipna=False)


def nanmode(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mode_impl(group_idx, array, size=size, fill_value=fill_value, skipna=True)


def _sum_of_squares(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, skipna=False, **kw):
    arr = np.asarray(array)
    fn = nansum if skipna else sum_
    return fn(group_idx, arr * arr, axis=axis, size=size, fill_value=fill_value, dtype=dtype)


def sum_of_squares(group_idx, array, **kw):
    return _sum_of_squares(group_idx, array, skipna=False, **kw)


def nansum_of_squares(group_idx, array, **kw):
    return _sum_of_squares(group_idx, array, skipna=True, **kw)


def _grouped_scan_host(group_idx, array, kind, dtype=None, nat=False):
    """Host grouped scans via stable argsort (mirrors the jax engine shape).

    ``nat``: data is int64-viewed datetimes/timedeltas with missing =
    INT64_MIN; ffill/bfill fill from the last valid and leave NaT where
    nothing precedes, cumsum poisons the rest of the segment after a NaT
    (numpy's NaT + x = NaT), nancumsum skips NaT.
    """
    codes = np.asarray(group_idx).reshape(-1)
    data = np.moveaxis(np.asarray(array), -1, 0)
    if dtype is not None:
        data = data.astype(dtype, copy=False)
    out_dtype = data.dtype
    if kind in ("cumsum", "nancumsum") and not nat:
        data = data.astype(_acc_dtype(out_dtype), copy=False)  # f16 running sums saturate
    perm = np.argsort(codes, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    sc = codes[perm]
    sd = np.take(data, perm, axis=0)
    boundaries = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
    out = np.empty_like(sd)
    for b, e in zip(boundaries, np.r_[boundaries[1:], len(sc)]):
        seg = sd[b:e]
        if kind in ("cumsum", "nancumsum"):
            if nat:
                miss = seg == _NAT_INT
                cs = np.where(miss, 0, seg).cumsum(axis=0)
                if kind == "cumsum":
                    cs = np.where(np.maximum.accumulate(miss, axis=0), _NAT_INT, cs)
                out[b:e] = cs
            elif kind == "cumsum":
                out[b:e] = np.cumsum(seg, axis=0)
            else:
                out[b:e] = np.nancumsum(seg, axis=0)
        elif kind in ("ffill", "bfill"):
            s = seg if kind == "ffill" else seg[::-1]
            isfloat = np.issubdtype(s.dtype, np.floating)
            if isfloat or nat:
                valid = (s != _NAT_INT) if nat else ~np.isnan(s)
                missing_val = _NAT_INT if nat else np.nan
                idx = np.where(valid, np.arange(s.shape[0]).reshape((-1,) + (1,) * (s.ndim - 1)), -1)
                np.maximum.accumulate(idx, axis=0, out=idx)
                filled = np.where(idx >= 0, np.take_along_axis(s, idx.clip(0), axis=0), missing_val)
            else:
                filled = s
            out[b:e] = filled if kind == "ffill" else filled[::-1]
    if out.dtype != out_dtype:
        out = out.astype(out_dtype)
    return np.moveaxis(np.take(out, inv, axis=0), 0, -1)


def cumsum(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _grouped_scan_host(group_idx, array, "cumsum", dtype=dtype, nat=kw.get("nat", False))


def nancumsum(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _grouped_scan_host(group_idx, array, "nancumsum", dtype=dtype, nat=kw.get("nat", False))


def ffill(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _grouped_scan_host(group_idx, array, "ffill", nat=kw.get("nat", False))


def bfill(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _grouped_scan_host(group_idx, array, "bfill", nat=kw.get("nat", False))


KERNELS = {
    "sum": sum_,
    "nansum": nansum,
    "prod": prod,
    "nanprod": nanprod,
    "max": max_,
    "nanmax": nanmax,
    "min": min_,
    "nanmin": nanmin,
    "mean": mean,
    "nanmean": nanmean,
    "var": var,
    "nanvar": nanvar,
    "std": std,
    "nanstd": nanstd,
    "var_chunk": var_chunk,
    "count": nanlen,
    "nanlen": nanlen,
    "len": len_,
    "all": all_,
    "any": any_,
    "argmax": argmax,
    "argmin": argmin,
    "nanargmax": nanargmax,
    "nanargmin": nanargmin,
    "first": first,
    "last": last,
    "nanfirst": nanfirst,
    "nanlast": nanlast,
    "median": median,
    "nanmedian": nanmedian,
    "quantile": quantile,
    "nanquantile": nanquantile,
    "mode": mode,
    "nanmode": nanmode,
    "sum_of_squares": sum_of_squares,
    "nansum_of_squares": nansum_of_squares,
    "cumsum": cumsum,
    "nancumsum": nancumsum,
    "ffill": ffill,
    "bfill": bfill,
}


def generic_kernel(func: str, group_idx, array, **kwargs):
    try:
        fn = KERNELS[func]
    except KeyError:
        raise NotImplementedError(f"numpy engine has no kernel for {func!r}") from None
    return fn(group_idx, array, **kwargs)
