"""The "torch" engine: grouped-reduction kernels on tensors (the slice of
``flox_tpu/kernels.py`` that the eager reductions need).

Every function has the plugin signature

    f(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw)

with ``group_idx`` an integer code tensor of shape (N,) (code -1: missing
label), ``array`` of shape (..., N) and ``size`` the number of groups. The
result has shape (..., size).

Layout: the reference moves the reduced axis to the front (``_to_leading``)
because XLA's segment ops reduce axis 0. Here the reduced axis stays last:
the data is viewed as (K, N), which is the layout the CUDA kernels stream in
place, and segment results are (K, size).

Routing (``_seg``) follows the reference's TPU heuristic with "kernel" in
the place of "pallas": float32/bfloat16 sums over at most
``pallas_num_groups_max`` groups go to the segment-sum kernel, over at most
``radixbin_num_groups_max`` groups to the radix-binning kernel,
float32/bfloat16/int32 min/max over at most ``pallas_minmax_num_groups_max``
groups to the segment-min/max kernel, and everything else (float64, integer
sums, more groups) to ``index_add_`` / ``scatter_reduce``, as the reference
sends it to XLA's scatter. Several statistics of one float array (sums,
counts, min and max) share one kernel pass (``_fused_stats``), and
float32/bfloat16 grouped cumsums over at most ``pallas_scan_num_groups_max``
groups (the missing-label group included) go to the segmented-cumsum kernel
(``_scan_impl_choice``); other scans run a sort plus a log-depth segmented
scan of torch ops.

The sort engine (the last section) serves huge label universes: it compacts
the codes to the groups actually present and runs the kernels above over a
small banded capacity.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from . import cuda_kernels, utils
from .cuda_kernels import minmax_identity
from .multiarray import MultiArray, PresentGroups
from .options import OPTIONS

__all__ = [
    "KERNELS",
    "compact_codes",
    "fused_segment_stats",
    "generic_kernel",
    "minmax_identity",
    "present_cap",
    "present_groups",
    "scatter_present_dense",
    "sort_kernel",
    "sort_segment_reduce",
    "var_chunk",
]

_KERNEL_SUM_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_MINMAX_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _flat(array: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(..., N) -> (K, N), and the leading shape to restore. K is the product
    of the leading shape, not -1: a zero-length N leaves -1 undefined."""
    lead = tuple(array.shape[:-1])
    return array.reshape(math.prod(lead), array.shape[-1]), lead


def _unflat(out: torch.Tensor, lead: tuple[int, ...]) -> torch.Tensor:
    return out.reshape(lead + (out.shape[-1],))


def _safe_codes(group_idx: torch.Tensor, size: int) -> torch.Tensor:
    """int32 codes with every missing or out-of-range code sent to ``size``,
    the extra segment that is sliced off."""
    codes = group_idx.reshape(-1)
    return torch.where((codes < 0) | (codes >= size), size, codes).to(torch.int32)


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype of additive reductions: sub-f32 floats accumulate in
    f32 (a bf16 running sum cannot count past 256)."""
    if dt in (torch.bfloat16, torch.float16):
        return torch.float32
    return dt


def _segment_sum_impl(data: torch.Tensor, size: int) -> str:
    """"kernel", "radixbin" or "scatter" for a segment-sum of ``data`` (K, N).

    The reference's TPU dispatch: "auto" takes the segment-sum kernel within
    its group cap, else the radix-binning kernel within its own, else
    scatter; "kernel" and "radixbin" take their kernel within its cap, else
    scatter.
    """
    policy = OPTIONS["segment_sum_impl"]
    if policy == "scatter" or not data.is_floating_point():
        return "scatter"
    guards = data.dtype in _KERNEL_SUM_DTYPES and data.shape[-1] >= 8
    kernel_ok = guards and size <= OPTIONS["pallas_num_groups_max"]
    radixbin_ok = guards and size <= OPTIONS["radixbin_num_groups_max"]
    if policy == "kernel":
        return "kernel" if kernel_ok else "scatter"
    if policy == "radixbin":
        return "radixbin" if radixbin_ok else "scatter"
    if kernel_ok:
        return "kernel"
    return "radixbin" if radixbin_ok else "scatter"


def _segment_minmax_impl(data: torch.Tensor, size: int) -> str:
    """"kernel" or "scatter" for a segment-min/max of ``data`` (K, N)."""
    ok = (
        data.dtype in _KERNEL_MINMAX_DTYPES
        and size <= OPTIONS["pallas_minmax_num_groups_max"]
        and data.shape[-1] >= 8
    )
    if OPTIONS["segment_minmax_impl"] == "scatter" or not ok:
        return "scatter"
    return "kernel"


def _seg(op: str, data: torch.Tensor, codes: torch.Tensor, size: int) -> torch.Tensor:
    """Segment-reduce ``data`` (K, N) by safe ``codes`` (N,) into (K, size).

    Additive ops on sub-f32 floats accumulate, and return, f32
    (``_acc_dtype``); callers that want the input dtype back cast at the end.
    """
    if op in ("max", "min") and _segment_minmax_impl(data, size) == "kernel":
        return cuda_kernels.segment_minmax(data, codes, size, op).T
    if op == "sum":
        impl = _segment_sum_impl(data, size)
        if impl == "kernel":
            return cuda_kernels.segment_sum(data, codes, size).T
        if impl == "radixbin":
            return cuda_kernels.segment_sum_radixbin(data, codes, size).T
    return _seg_scatter(op, data, codes, size)


def _seg_scatter(op: str, data: torch.Tensor, codes: torch.Tensor, size: int) -> torch.Tensor:
    """The ``index_add_`` / ``scatter_reduce`` leg of :func:`_seg`: the same
    contract, no kernel."""
    k = data.shape[0]
    idx = codes.to(torch.int64)
    if op in ("sum", "prod") and data.is_floating_point():
        data = data.to(_acc_dtype(data.dtype))
    if op == "sum":
        out = torch.zeros((k, size + 1), dtype=data.dtype, device=data.device)
        out.index_add_(1, idx, data)
    elif op == "prod":
        out = torch.ones((k, size + 1), dtype=data.dtype, device=data.device)
        out.scatter_reduce_(1, idx.expand_as(data), data, reduce="prod", include_self=True)
    else:
        out = torch.full(
            (k, size + 1), minmax_identity(op, data.dtype), dtype=data.dtype, device=data.device
        )
        out.scatter_reduce_(1, idx.expand_as(data), data, reduce="a" + op, include_self=True)
    return out[:, :size]


def _counts(codes: torch.Tensor, size: int, mask=None, dtype=torch.int32) -> torch.Tensor:
    """Per-group element counts: (size,) from the codes alone, or (K, size)
    restricted by ``mask`` (K, N)."""
    if mask is None:
        return torch.bincount(codes, minlength=size + 1)[:size].to(dtype)
    return _seg("sum", mask.to(dtype), codes, size)


def _promote_for_nan_fill(out: torch.Tensor, fv) -> torch.Tensor:
    """A NaN fill on integer output must promote, not truncate to garbage."""
    if utils.is_nan_fill(fv) and not (out.is_floating_point() or out.is_complex()):
        return out.to(torch.float64)
    return out


def _fill_empty(out: torch.Tensor, present: torch.Tensor, fill_value) -> torch.Tensor:
    """Replace groups with no contributing elements by ``fill_value``.
    ``present`` is (size,) or (K, size); it broadcasts along the group axis."""
    if fill_value is None:
        return out
    out = _promote_for_nan_fill(out, fill_value)
    fill = torch.as_tensor(fill_value).to(device=out.device, dtype=out.dtype)
    return torch.where(present, out, fill)


def _nan_mask(array: torch.Tensor):
    if array.is_floating_point() or array.is_complex():
        return ~torch.isnan(array)
    return None  # non-float: nothing is NaN


def _maybe_cast(array: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is not None:
        dtype = utils.torch_dtype(dtype)
        if array.dtype != dtype:
            return array.to(dtype)
    return array


# ---------------------------------------------------------------------------
# simple reductions
# ---------------------------------------------------------------------------


def _make_addlike(op: str, identity, skipna: bool):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        codes = _safe_codes(group_idx, size)
        data, lead = _flat(array)
        mask = _nan_mask(data) if skipna else None
        if mask is not None:
            data = torch.where(mask, data, identity)
        data = _maybe_cast(data, dtype)
        out = _seg(op, data, codes, size)  # f32-accumulated for bf16/f16
        if fill_value is not None and fill_value != identity:
            # numpy semantics: nansum of an all-NaN group is the identity (0),
            # so "empty" means zero elements in all, not zero non-NaN ones
            out = _fill_empty(out, _counts(codes, size) > 0, fill_value)
        if data.is_floating_point() and out.dtype != data.dtype and not kw.get("keep_acc"):
            # result dtype contract: that of the (request-resolved) input
            out = out.to(data.dtype)
        return _unflat(out, lead)

    return kernel


sum_ = _make_addlike("sum", 0, skipna=False)
nansum = _make_addlike("sum", 0, skipna=True)
prod = _make_addlike("prod", 1, skipna=False)
nanprod = _make_addlike("prod", 1, skipna=True)


def _make_minmax(op: str, skipna: bool):
    other = "min" if op == "max" else "max"

    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        codes = _safe_codes(group_idx, size)
        data, lead = _flat(array)
        data = _maybe_cast(data, dtype)
        mask = _nan_mask(data)
        if skipna and mask is not None:
            data = torch.where(mask, data, minmax_identity(op, data.dtype))
        elif not skipna and mask is not None:
            # NaN propagates through min/max in numpy: map it to the absorbing
            # element (the other op's identity), then re-inject it from a
            # per-group has-NaN flag
            has_nan = _seg("max", (~mask).to(torch.int8), codes, size) > 0
            data = torch.where(mask, data, minmax_identity(other, data.dtype))
            out = _seg(op, data, codes, size)
            out = torch.where(has_nan, float("nan"), out)
            out = _fill_empty(out, _counts(codes, size) > 0, fill_value)
            return _unflat(out, lead)
        out = _seg(op, data, codes, size)
        present = _counts(codes, size, mask=mask if skipna else None) > 0
        out = _fill_empty(out, present, fill_value)
        return _unflat(out, lead)

    return kernel


max_ = _make_minmax("max", skipna=False)
nanmax = _make_minmax("max", skipna=True)
min_ = _make_minmax("min", skipna=False)
nanmin = _make_minmax("min", skipna=True)


def nanlen(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    """Count of non-NaN elements per group."""
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    mask = _nan_mask(data)
    out = _counts(codes, size, mask=mask, dtype=utils.torch_dtype(dtype or torch.int32))
    if mask is None:
        out = out.expand(data.shape[0], size)
    if fill_value is not None and fill_value != 0:
        out = _fill_empty(out, out > 0, fill_value)
    return _unflat(out, lead)


def len_(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    out = _counts(codes, size, dtype=utils.torch_dtype(dtype or torch.int32))
    return _unflat(out.expand(data.shape[0], size), lead)


# ---------------------------------------------------------------------------
# one kernel pass, several statistics
# ---------------------------------------------------------------------------

_FUSABLE_LEG_NAMES = frozenset(
    {"sum", "nansum", "len", "nanlen", "min", "nanmin", "max", "nanmax"}
)


def _fused_stats(data: torch.Tensor, codes: torch.Tensor, size: int, want: tuple):
    """Several statistics from one kernel pass (the reference's
    ``_fused_stats_leading``).

    ``data`` (K, N); ``codes`` safe; ``want`` a subset of {sum, nansum, len,
    nanlen, min, nanmin, max, nanmax}. The kernels zero-fill non-finite values
    and count NaN/±inf, so one pass yields both sum variants (IEEE re-applied
    per skipna mode) and the non-NaN counts as ``rowcount(codes) - nan_c``;
    with a min or max leg the pass is the multi-statistic kernel, whose
    NaN-skipping extrema serve nanmin/nanmax directly and min/max with NaN
    re-injected where ``nan_c > 0``. Past the segment-sum kernel's cap, sum
    and count legs come from one radix-binning pass (the reference runs those
    legs one by one there; the sums are the same kernel's and the counts
    exact below 2^24, so the numbers are the same). Returns ``{name: (K,
    size)}``, or None when the policy resolves to scatter or a guard fails
    (callers then run the per-leg reductions).
    """
    want = tuple(want)
    if not set(want) <= _FUSABLE_LEG_NAMES:
        return None
    sumish = bool({"sum", "nansum"} & set(want))
    minmaxish = bool({"min", "nanmin", "max", "nanmax"} & set(want))
    if not (sumish or minmaxish):
        return None  # counts alone never justify a pass over the data
    if not data.is_floating_point() or data.shape[-1] >= 2**24:
        return None  # 2^24: the f32 marker-count exactness guard
    impl = _segment_sum_impl(data, size)
    if impl == "scatter":
        return None
    if minmaxish:
        if impl != "kernel" or size > min(
            OPTIONS["pallas_num_groups_max"], OPTIONS["pallas_minmax_num_groups_max"]
        ):
            return None
        sums, nan_c, pos_c, neg_c, mins, maxs = (
            t.T for t in cuda_kernels.segment_multistat(data, codes, size)
        )
    else:
        raw = (cuda_kernels.segment_sum_raw if impl == "kernel"
               else cuda_kernels.segment_sum_radixbin_raw)
        sums, nan_c, pos_c, neg_c = (t.T for t in raw(data, codes, size))
    out: dict[str, torch.Tensor] = {}
    if "sum" in want:
        out["sum"] = utils.reapply_nonfinite(sums, nan_c, pos_c, neg_c, skipna=False)
    if "nansum" in want:
        out["nansum"] = utils.reapply_nonfinite(sums, nan_c, pos_c, neg_c, skipna=True)
    if "len" in want or "nanlen" in want:
        rowcount = _counts(codes, size).expand_as(sums)  # codes only
        if "len" in want:
            out["len"] = rowcount
        if "nanlen" in want:
            out["nanlen"] = rowcount.to(sums.dtype) - nan_c
    if minmaxish:
        has_nan = nan_c > 0
        for name, ext in (("min", mins), ("max", maxs)):
            if "nan" + name in want:
                out["nan" + name] = ext
            if name in want:
                out[name] = torch.where(has_nan, float("nan"), ext)
    return out


def fused_segment_stats(group_idx, array, *, size: int, want: tuple):
    """Plugin-layout entry to :func:`_fused_stats`: ``array`` (..., N) in,
    ``{name: (..., size)}`` out, or None."""
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    raw = _fused_stats(data, codes, size, tuple(want))
    if raw is None:
        return None
    return {k: _unflat(v, lead) for k, v in raw.items()}


def _fused_sum_counts(cast: torch.Tensor, codes: torch.Tensor, size: int):
    """Single-pass skipna (total, non-NaN count): the mean/var fast path."""
    got = _fused_stats(cast, codes, size, ("nansum", "nanlen"))
    if got is None:
        return None
    return got["nansum"], got["nanlen"]


# ---------------------------------------------------------------------------
# mean and variance
# ---------------------------------------------------------------------------


def _float_request(data: torch.Tensor, dtype):
    if dtype is None and not data.is_floating_point():
        return torch.promote_types(data.dtype, torch.float32)
    return dtype


def _mean_impl(group_idx, array, *, size, fill_value, dtype, skipna):
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    cast = _maybe_cast(data, _float_request(data, dtype))
    fused = _fused_sum_counts(cast, codes, size) if skipna else None
    if fused is not None:
        total, cnt = fused
        orig_dtype = cast.dtype
    else:
        mask = _nan_mask(data) if skipna else None
        sdata = cast if mask is None else torch.where(mask, cast, 0)
        total = _seg("sum", sdata, codes, size)  # f32-accumulated for bf16/f16
        # counts in int32: exact whatever the data dtype (bf16 saturates at 256)
        cnt = _counts(codes, size, mask=mask).to(total.dtype)
        orig_dtype = sdata.dtype
    out = total / cnt
    out = _fill_empty(out, cnt > 0, fill_value if fill_value is not None else float("nan"))
    if out.dtype != orig_dtype and orig_dtype.is_floating_point:
        out = out.to(orig_dtype)  # divide in f32, present as bf16
    return _unflat(out, lead)


def mean(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mean_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, skipna=False)


def nanmean(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mean_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype, skipna=True)


def _var_stats(group_idx, array, *, size, dtype, skipna):
    """The per-group (m2, total, count) of the shifted single-pass variance,
    deviations taken about the group mean. Returns ``(zdata, m2, total, cnt_f,
    cnt_b, lead)``: the zero-filled working data, the (K, size) sums of squared
    deviations, totals and float counts, the counts to test presence with
    (exact int32 off the fused path), and the leading shape."""
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    cast = _maybe_cast(data, _float_request(data, dtype))
    # mask on the pre-cast data: an int dtype request would destroy the NaNs
    mask = _nan_mask(data) if skipna else None
    zdata = cast if mask is None else torch.where(mask, cast, 0)
    fused = _fused_sum_counts(cast, codes, size) if skipna else None
    if fused is not None:
        total, cnt_f = fused
        cnt_b = cnt_f
    else:
        total = _seg("sum", zdata, codes, size)  # f32-accumulated for bf16/f16
        cnt_b = _counts(codes, size, mask=mask)  # int32, exact
        cnt_f = cnt_b.to(total.dtype).expand_as(total)
    mean_g = total / torch.where(cnt_f > 0, cnt_f, 1)
    # gather each element's group mean (the sink segment reads 0) and
    # accumulate squared deviations; bf16 - f32 promotes to f32, so the
    # accumulation stays f32 end to end
    padded = torch.cat([mean_g, mean_g.new_zeros((mean_g.shape[0], 1))], dim=1)
    dev = zdata - padded.index_select(1, codes)
    if mask is not None:
        dev = torch.where(mask, dev, 0)
    m2 = _seg("sum", dev * dev, codes, size)
    return zdata, m2, total, cnt_f, cnt_b, lead


def _var_impl(group_idx, array, *, size, fill_value, dtype, ddof, skipna, std):
    zdata, m2, _total, cnt_f, cnt_b, lead = _var_stats(
        group_idx, array, size=size, dtype=dtype, skipna=skipna
    )
    denom = cnt_f - ddof
    out = m2 / torch.where(denom > 0, denom, 1)
    out = torch.where(denom > 0, out, float("nan"))
    if std:
        out = torch.sqrt(out)
    out = _fill_empty(out, cnt_b > 0, fill_value if fill_value is not None else float("nan"))
    if out.dtype != zdata.dtype and zdata.is_floating_point():
        out = out.to(zdata.dtype)
    return _unflat(out, lead)


def _var_entry(skipna: bool, std: bool):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, ddof=0, **kw):
        return _var_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype,
                         ddof=ddof, skipna=skipna, std=std)

    return kernel


var = _var_entry(skipna=False, std=False)
nanvar = _var_entry(skipna=True, std=False)
std = _var_entry(skipna=False, std=True)
nanstd = _var_entry(skipna=True, std=True)


def var_chunk(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, skipna=True, **kw):
    """Per-chunk variance statistics as a :class:`MultiArray` ``(m2, total,
    count)``, each (..., size) in the float accumulator dtype: the sum of
    squared deviations about the chunk's group mean, the group total and the
    count. ``aggregations._var_finalize`` turns it into the variance."""
    _zdata, m2, total, cnt_f, _cnt_b, lead = _var_stats(
        group_idx, array, size=size, dtype=dtype, skipna=skipna
    )
    return MultiArray((_unflat(m2, lead), _unflat(total, lead), _unflat(cnt_f, lead)))


# ---------------------------------------------------------------------------
# bool reductions
# ---------------------------------------------------------------------------


def _make_boolred(op: str, identity: bool):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        codes = _safe_codes(group_idx, size)
        data, lead = _flat(array)
        out = _seg(op, data.to(torch.bool).to(torch.int8), codes, size).to(torch.bool)
        fill = identity if fill_value is None else fill_value
        out = torch.where(_counts(codes, size) > 0, out, torch.as_tensor(fill))
        return _unflat(out, lead)

    return kernel


all_ = _make_boolred("min", True)
any_ = _make_boolred("max", False)


# ---------------------------------------------------------------------------
# grouped scans
#
# float32/bfloat16 cumsums over few groups run the segmented-cumsum kernel in
# the data's own order. Everything else is sorted stably by code, so that each
# group is one contiguous run, scanned along the last axis with run-start
# flags, and unsorted. The segmented-scan operator
# ``((v1, f1), (v2, f2)) -> (f2 ? v2 : v1 + v2, f1 | f2)`` is associative, and
# a Hillis-Steele scan applies it in log2(N) steps of whole-tensor ops; no
# value ever crosses a run start, so NaN and inf stay inside their group.
# ---------------------------------------------------------------------------


def _scan_impl_choice(data: torch.Tensor, size) -> str:
    """"kernel" or "segmented" for a grouped cumsum of ``data`` (K, N)."""
    ok = (
        isinstance(size, int)
        and data.dtype in _KERNEL_SUM_DTYPES
        and size + 1 <= OPTIONS["pallas_scan_num_groups_max"]
        and data.shape[-1] >= 8
    )
    if OPTIONS["scan_impl"] == "segmented" or not ok:
        return "segmented"
    return "kernel"


def _segmented_scan(values: torch.Tensor, flags: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of ``values`` (..., N) along the last axis, restarted
    where ``flags`` (N,) is True (Hillis-Steele: log2(N) steps)."""
    v, f = values, flags
    d = 1
    while d < v.shape[-1]:
        stepped = torch.where(f[d:], v[..., d:], op(v[..., :-d], v[..., d:]))
        v = torch.cat([v[..., :d], stepped], dim=-1)
        f = torch.cat([f[:d], f[:-d] | f[d:]])
        d *= 2
    return v


def _grouped_scan_setup(codes: torch.Tensor, data: torch.Tensor):
    """Stable-sort ``data`` (K, N) by ``codes`` (N,); return the sorted data,
    the run-start flags (N,) and the inverse permutation."""
    codes = codes.reshape(-1).to(device=data.device, dtype=torch.int64)
    perm = torch.argsort(codes, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    sorted_codes = codes[perm]
    starts = torch.ones_like(sorted_codes, dtype=torch.bool)
    starts[1:] = sorted_codes[1:] != sorted_codes[:-1]
    return data.index_select(1, perm), starts, inv


def _cumsum_impl(group_idx, array, *, size, dtype, skipna):
    data, lead = _flat(array)
    cast = _maybe_cast(data, dtype)
    if _scan_impl_choice(cast, size) == "kernel":
        codes = group_idx.reshape(-1).to(data.device)
        return _unflat(cuda_kernels.segment_cumsum(cast, codes, size, skipna), lead)
    sorted_data, flags, inv = _grouped_scan_setup(group_idx, data)
    mask = _nan_mask(sorted_data) if skipna else None
    vals = sorted_data if mask is None else torch.where(mask, sorted_data, 0)
    vals = _maybe_cast(vals, dtype)
    out_dtype = vals.dtype
    if vals.is_floating_point():
        vals = vals.to(_acc_dtype(vals.dtype))  # a bf16 running sum saturates
    scanned = _segmented_scan(vals, flags, torch.add).to(out_dtype)
    return _unflat(scanned.index_select(1, inv), lead)


def cumsum(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _cumsum_impl(group_idx, array, size=size, dtype=dtype, skipna=False)


def nancumsum(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _cumsum_impl(group_idx, array, size=size, dtype=dtype, skipna=True)


def _ffill_impl(group_idx, array, *, reverse: bool):
    """Each missing value takes the last valid value before it in its group
    (bfill: after it). The last valid index is a running max of the masked
    iota over the code-sorted axis; it belongs to the group when it is not
    before the start of the position's run."""
    data, lead = _flat(array)
    codes = group_idx.reshape(-1)
    if reverse:
        codes, data = codes.flip(0), data.flip(-1)
    sorted_data, starts, inv = _grouped_scan_setup(codes, data)
    mask = _nan_mask(sorted_data)
    out = sorted_data
    if mask is not None:
        iota = torch.arange(sorted_data.shape[-1], device=data.device)
        last_valid = torch.cummax(torch.where(mask, iota, -1), dim=-1).values
        run_start = torch.cummax(torch.where(starts, iota, 0), dim=0).values
        gathered = torch.gather(sorted_data, 1, last_valid.clamp(min=0))
        out = torch.where(last_valid >= run_start, gathered, float("nan"))
    out = out.index_select(1, inv)
    if reverse:
        out = out.flip(-1)
    return _unflat(out, lead)


def ffill(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _ffill_impl(group_idx, array, reverse=False)


def bfill(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _ffill_impl(group_idx, array, reverse=True)


KERNELS: dict[str, Callable[..., Any]] = {
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
    "cumsum": cumsum,
    "nancumsum": nancumsum,
    "ffill": ffill,
    "bfill": bfill,
}


# ---------------------------------------------------------------------------
# sort engine: present-groups execution (the high-cardinality regime)
#
# Every kernel above is dense over the label universe ``size``, which runs
# out of memory when ``size`` is millions while a call touches a few thousand
# groups (user IDs, station IDs, days of a century). The sort engine finds the
# groups actually present once (a unique pass on the host), relabels the codes
# into the compact [0, n_present) domain, runs the unchanged kernels above
# over a small banded capacity, and scatters back to the dense layout on the
# host. Elements are never permuted (only the codes are relabelled,
# monotonically), so each result equals the dense engine's on the present
# groups bit for bit WHEN both domains resolve to the same segment-sum
# lowering. The compact domain may cross a size gate (segment-sum kernel,
# radix-binning kernel, scatter) that the dense one did not, which
# reassociates float sums within those lowerings' accuracy: the caveat of any
# ``segment_sum_impl`` flip.
# ---------------------------------------------------------------------------

#: host memo of present-group tables, keyed on a content fingerprint of the
#: codes: repeated calls over the same factorized codes skip the unique pass
_PRESENT_CACHE: OrderedDict = OrderedDict()
_PRESENT_CACHE_MAX = 64

#: capacity bands are powers of two, so calls whose present-group counts
#: drift reuse the same shapes
_PRESENT_CAP_MIN = 8

#: the sort key of a missing label: after every valid code
_BIG = np.iinfo(np.int32).max


def _codes_fingerprint(codes: np.ndarray, size: int) -> tuple:
    """Content key of the present-table memo: blake2b over the code bytes,
    with their shape, dtype and the universe size."""
    h = hashlib.blake2b(np.ascontiguousarray(codes).view(np.uint8), digest_size=16)
    return (h.hexdigest(), codes.shape, str(codes.dtype), int(size))


def present_groups(codes, size: int) -> np.ndarray:
    """Sorted unique valid codes of a host code array (the "present" table),
    int64. ``codes``: integer codes, -1 meaning "missing label". Memoized on
    content (an LRU of :data:`_PRESENT_CACHE_MAX` tables)."""
    codes = np.asarray(codes).reshape(-1)
    key = _codes_fingerprint(codes, size)
    hit = _PRESENT_CACHE.get(key)
    if hit is not None:
        _PRESENT_CACHE.move_to_end(key)
        return hit
    present = np.unique(codes[codes >= 0]).astype(np.int64, copy=False)
    _PRESENT_CACHE[key] = present
    if len(_PRESENT_CACHE) > _PRESENT_CACHE_MAX:
        _PRESENT_CACHE.popitem(last=False)
    return present


def compact_codes(codes, present: np.ndarray) -> np.ndarray:
    """Relabel host ``codes`` into the compact [0, n_present) domain, int32.

    Monotone (``present`` is sorted) and order-preserving, and -1 (missing)
    stays -1: per-group element order, and so every accumulation order, is
    the dense path's.
    """
    codes = np.asarray(codes).reshape(-1)
    out = np.searchsorted(present, codes).astype(np.int32)
    out[codes < 0] = -1
    return np.ascontiguousarray(out)


def present_cap(n_present: int, size: int) -> int:
    """Banded compact-domain capacity: the next power of two above
    ``n_present``, with at least one empty pad slot whenever the dense
    universe has absent groups. The pad slot makes the compact reduction
    hold an empty group exactly when the dense one does, so the empty-fill
    dtype promotions fire alike on both paths, and its value, the dense
    path's empty-group value, is the dense scatter's fill.
    """
    n_present = int(n_present)
    if n_present >= size:
        return max(1, n_present)
    want = max(_PRESENT_CAP_MIN, n_present + 1)
    cap = 1 << (want - 1).bit_length()
    return min(cap, size)


def scatter_present_dense(result_c: torch.Tensor, present: np.ndarray, size: int):
    """Expand a compact (..., cap) result to the dense (..., size) layout on
    the host (:meth:`PresentGroups.scatter_dense`): the dense layout never
    exists on the device. Absent groups take the compact result's first pad
    slot, an empty group that went through the same kernels and finalize.
    Returns a CPU tensor of the result's dtype (bfloat16 moves as its bits:
    the scatter only copies values).
    """
    host = result_c.detach().cpu()
    if host.dtype == torch.bfloat16:
        bits = PresentGroups(present, host.view(torch.int16).numpy(), size).scatter_dense()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(PresentGroups(present, host.numpy(), size).scatter_dense())


def sort_segment_reduce(op: str, data: torch.Tensor, codes: torch.Tensor, *, ncap: int):
    """Device-side present-groups segment reduction, for codes that are not
    on the host: one stable sort of the codes bins the elements by group, run
    boundaries on the sorted codes give compact segment ids, and one
    segment-``op`` over ``ncap`` segments reduces each run.

    ``data`` (..., N), the reduced axis last as everywhere in this module;
    ``codes`` (N,) int, -1 missing. ``ncap`` bounds the number of distinct
    present groups; runs past it are dropped. Returns ``(present, out,
    n_present)``: the sorted present codes padded with -1 to (ncap,), the
    per-present-group reductions (..., ncap), and the count of distinct
    present groups (a 0-d tensor). The sort is stable, so within a group the
    data keeps its order and sums add in the dense scatter path's order.
    """
    codes = codes.reshape(-1).to(device=data.device, dtype=torch.int64)
    safe = torch.where(codes < 0, _BIG, codes)
    sorted_codes, perm = torch.sort(safe, stable=True)
    valid = sorted_codes != _BIG
    boundary = torch.cat([valid[:1], valid[1:] & (sorted_codes[1:] != sorted_codes[:-1])])
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1  # -1 until the first run
    n_present = boundary.sum()
    # missing labels and capacity overflow park in segment ncap
    seg = torch.where(valid & (seg >= 0) & (seg < ncap), seg, ncap)
    flat, lead = _flat(data.index_select(-1, perm))
    out = _unflat(_seg_scatter(op, flat, seg, ncap), lead)  # the reference's _seg_op_dense
    present = torch.full((ncap + 1,), -1, dtype=torch.int64, device=data.device)
    present.scatter_reduce_(0, seg, torch.where(valid, sorted_codes, -1), "amax",
                            include_self=True)
    return present[:ncap], out, n_present


def sort_kernel(func: str, group_idx, array, *, axis=-1, size, fill_value=None,
                dtype=None, **kwargs):
    """Entry point of the "sort" engine: host unique + compact relabel, the
    unchanged kernel over the banded capacity, then the dense scatter back,
    returned on ``array``'s device. This per-kernel form keeps the dense
    (..., size) contract of ``generic_aggregate``; ``core.groupby_reduce``
    compacts once per call and scatters once at the end instead."""
    host_codes = utils.asarray_host(group_idx).reshape(-1)
    present = present_groups(host_codes, size)
    ncap = present_cap(len(present), size)
    ccodes = torch.as_tensor(compact_codes(host_codes, present), device=array.device)
    out = generic_kernel(func, ccodes, array, axis=axis, size=ncap, fill_value=fill_value,
                         dtype=dtype, **kwargs)
    return scatter_present_dense(out, present, size).to(array.device)


def generic_kernel(func: str, group_idx, array, **kwargs):
    """Entry point of the "torch" engine."""
    try:
        fn = KERNELS[func]
    except KeyError:
        raise NotImplementedError(
            f"the torch engine has no kernel for {func!r} yet; it comes with the rest "
            "of the reduction family (ROADMAP A2)"
        ) from None
    return fn(group_idx, array, **kwargs)

