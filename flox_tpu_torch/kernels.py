"""The "torch" engine: grouped-reduction kernels on tensors (the port of
``flox_tpu/kernels.py``).

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
sends it to XLA's scatter; on a CUDA device a float sum that no kernel takes
goes to the one-hot GEMM (``_seg_matmul_raw``) where the reference's
``_use_matmul_path`` guard passes (at most ``matmul_num_groups_max`` groups,
a kept axis of at least a quarter of them). Several statistics of one float
array (sums, counts, min and max) share one kernel pass (``_fused_stats``); a
skipna mean whose sums take the segment-sum or radix-binning kernel on the
card finishes in one pass of the mean finalize over their raw legs
(``_mean_pass``), where XLA fuses the reference's finish; and
float32/bfloat16 grouped cumsums over at most ``pallas_scan_num_groups_max``
groups (the missing-label group included) go to the segmented-cumsum kernel
(``_scan_impl_choice``); other scans run a sort plus a log-depth segmented
scan of torch ops. Argreductions, first/last and mode take grouped min/max
of int32 positions and run lengths, so they reach the segment-min/max
kernel's int32 instance; quantiles run a (code, value) sort or a radix
select whose counting passes are segment-sums (``quantile_impl``); on a mesh
(``axis_name=``, the collective layer of ``parallel.mesh``) the select's
counts are summed over the shards.
Datetimes arrive as their int64 view with ``nat=True``: INT64_MIN (NaT) is
then a missing marker, as NaN is for floats.

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

from . import cuda_kernels, telemetry, utils
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

#: INT32_MAX: the "no candidate" position of the argreductions, first/last
#: and mode, and the sort key of a missing label in the sort engine
_BIG = np.iinfo(np.int32).max


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


def _segment_sum_impl(data: torch.Tensor, size: int, device_type: str | None = None) -> str:
    """"kernel", "radixbin", "matmul" or "scatter" for a segment-sum of
    ``data`` (K, N) on a device of ``device_type`` (default: the data's).

    The reference's TPU dispatch, with "on TPU" read as "on CUDA":

    ========  ==============================  ===============================
    policy    CUDA                            CPU
    ========  ==============================  ===============================
    matmul    the GEMM where                  the same
              :func:`_use_matmul_path`
              passes, else ``index_add_``
    kernel,   that kernel within its cap,     the same (the kernels' plain
    radixbin  else ``index_add_``             versions)
    auto      the segment-sum kernel within   as on CUDA, never the GEMM (the
              its cap, else the radix-        reference's "auto" takes it on
              binning kernel within its own,  TPU only)
              else the GEMM where its guard
              passes, else ``index_add_``
    ========  ==============================  ===============================

    With the autotuner on, "auto" takes the observed winner (or the cost
    model's prior) among :func:`_tuned_sum_candidates`. Non-float data and
    "scatter" always take ``index_add_``. On a CUDA device the GEMM runs or
    raises: nothing falls back from it.
    """
    policy = OPTIONS["segment_sum_impl"]
    if policy == "scatter" or not data.is_floating_point():
        return "scatter"
    matmul_ok = _use_matmul_path("sum", data, size)
    if policy == "matmul":
        return "matmul" if matmul_ok else "scatter"
    guards = data.dtype in _KERNEL_SUM_DTYPES and data.shape[-1] >= 8
    kernel_ok = guards and size <= OPTIONS["pallas_num_groups_max"]
    radixbin_ok = guards and size <= OPTIONS["radixbin_num_groups_max"]
    if policy == "kernel":
        return "kernel" if kernel_ok else "scatter"
    if policy == "radixbin":
        return "radixbin" if radixbin_ok else "scatter"
    device_type = device_type or data.device.type
    heuristic = ("kernel" if kernel_ok else "radixbin" if radixbin_ok
                 else "matmul" if matmul_ok and device_type == "cuda" else "scatter")
    if OPTIONS["autotune"]:
        from . import autotune

        eligible = _tuned_sum_candidates(device_type, kernel_ok, radixbin_ok, matmul_ok)
        return autotune.decide("segment_sum", heuristic, eligible,
                               dtype=autotune.dtype_name(data.dtype), ngroups=size,
                               nelems=data.numel(), platform=device_type)
    return heuristic


def _tuned_sum_candidates(device_type: str, kernel_ok: bool, radixbin_ok: bool,
                          matmul_ok: bool = False) -> list[str]:
    """The ``segment_sum`` family's candidates on ``device_type``: on a CUDA
    device the hand-written kernels whose guards pass, so that no decision
    moves a call off the kernels; where none does, and on the CPU,
    ``index_add_`` and the one-hot GEMM where its guard passes (the kernels'
    plain versions are not the kernels)."""
    if device_type == "cuda":
        names = [name for name, ok in (("kernel", kernel_ok), ("radixbin", radixbin_ok)) if ok]
        if names:
            return names
    return ["scatter", "matmul"] if matmul_ok else ["scatter"]


def _use_matmul_path(op: str, data: torch.Tensor, size: int) -> bool:
    """The reference's guard of the one-hot GEMM for ``data`` (K, N): float
    sums over at most ``matmul_num_groups_max`` groups, a kept axis K of at
    least a quarter of the group count (the one-hot's traffic relative to the
    data is size/K), a one-hot (N, size) under 2 GiB, and the smallest block's
    four (min(K, 8), N) masks under 2 GiB. ``data`` may be a meta tensor: only
    its shape and dtype are read."""
    if op != "sum" or not data.is_floating_point():
        return False
    if size > OPTIONS["matmul_num_groups_max"]:
        return False
    n = data.shape[-1]
    k = math.prod(data.shape[:-1])
    itemsize = data.element_size()
    if size > 4 * k or n * size * itemsize > 2**31:
        return False
    return 4 * min(k, 8) * n * itemsize < 2**31


def _seg_matmul_raw(data: torch.Tensor, codes: torch.Tensor, size: int):
    """The one-hot GEMM (the reference's ``_seg_matmul_raw``): raw zero-filled
    sums and NaN/+inf/-inf counts of ``data`` (K, N) by safe ``codes`` (N,),
    each (K, size) in the accumulation dtype; callers re-apply IEEE rules.

    ``sums[k, g] = sum_n data[k, n] * onehot[n, g]``. The sentinel code
    ``size`` has an all-zero one-hot row, so missing labels drop out.
    Non-finite values are zero-filled before the product (``0 * inf`` would
    poison every other group) and counted by their own product, one GEMM over
    the three stacked 0/1 masks. K runs in blocks sized by
    ``matmul_block_bytes`` (four (block, N) masks of the data's itemsize, as
    in the reference), the ragged tail unpadded, under one ``matmul`` span
    (the shape, the dtype, the blocks, and ``nbytes``: the data's bytes,
    which the call must read) and the ``kernels.matmul_blocks`` counter.

    Numerics: bfloat16 and float16 are cast to float32 first (a bf16 product
    cannot count past 256; the cast is exact), the masks' products are exact
    in any float32 mode, and float64 is a float64 GEMM. float32 sums run as a
    float64 GEMM rounded once to float32: cuBLAS's float32 GEMM turns to TF32
    under the process-wide ``set_float32_matmul_precision("high")`` /
    ``allow_tf32``, which no call can override for itself, and a float64
    product of float32 operands is exact, so the sums are full float32 (or
    better) whatever that setting.
    """
    k, n = data.shape
    acc = _acc_dtype(data.dtype)
    wide = torch.float64 if data.dtype == torch.float32 else acc
    groups = torch.arange(size, dtype=codes.dtype, device=data.device)
    onehot = codes[:, None] == groups[None, :]  # (N, size)
    onehot_acc = onehot.to(acc)
    onehot_wide = onehot_acc if wide == acc else onehot.to(wide)
    out = torch.empty((4, k, size), dtype=acc, device=data.device)
    kb = max(8, OPTIONS["matmul_block_bytes"] // (4 * max(n, 1) * data.element_size()) // 8 * 8)
    blocks = -(-k // kb)
    telemetry.count("kernels.matmul_blocks", blocks)
    dtype = str(data.dtype).removeprefix("torch.")
    nbytes = data.numel() * data.element_size()
    with telemetry.span("matmul", k=k, n=n, size=size, dtype=dtype, blocks=blocks, nbytes=nbytes):
        for start in range(0, k, kb):
            block = data[start:start + kb].to(acc)
            marks = torch.stack((torch.isnan(block), torch.isposinf(block),
                                 torch.isneginf(block))).to(acc)
            zeroed = torch.nan_to_num(block, nan=0.0, posinf=0.0, neginf=0.0)
            out[0, start:start + kb] = torch.matmul(zeroed.to(wide), onehot_wide)
            out[1:, start:start + kb] = torch.matmul(marks, onehot_acc)
    return out[0], out[1], out[2], out[3]


def _seg_matmul_sum(data: torch.Tensor, codes: torch.Tensor, size: int) -> torch.Tensor:
    """(K, size) segment sums of ``data`` (K, N) on the one-hot GEMM, IEEE
    rules re-applied (the reference's ``_seg_matmul_sum``)."""
    raw = _seg_matmul_raw(data, codes, size)
    with telemetry.span("legs"):
        return utils.reapply_nonfinite(*raw)


#: reductions whose device legs are segment sums of the data (a count is a
#: sum of an int32 mask, which no kernel takes)
_SUM_KERNEL_FUNCS = frozenset({"sum", "nansum", "mean", "nanmean", "var", "nanvar", "std",
                               "nanstd"})
_MINMAX_KERNEL_FUNCS = frozenset({"min", "nanmin", "max", "nanmax"})


def dense_kernel_cap(func: str, dtype: Any) -> int:
    """The most groups over which ``func`` reduces ``dtype`` data on a
    hand-written kernel under the "auto" policies; 0 where the port does not
    know of one (the ``highcard`` family's guard, ``core._highcard_candidates``)."""
    try:
        dtype = utils.torch_dtype(dtype)
    except TypeError:
        return 0  # datetimes, strings: reduced as int64 views or on the host
    if func in _SUM_KERNEL_FUNCS and dtype in _KERNEL_SUM_DTYPES:
        caps = {"kernel": OPTIONS["pallas_num_groups_max"],
                "radixbin": OPTIONS["radixbin_num_groups_max"], "scatter": 0, "matmul": 0}
        return caps.get(OPTIONS["segment_sum_impl"], max(caps.values()))
    if func in _MINMAX_KERNEL_FUNCS and dtype in _KERNEL_MINMAX_DTYPES:
        if OPTIONS["segment_minmax_impl"] == "scatter":
            return 0
        return OPTIONS["pallas_minmax_num_groups_max"]
    return 0


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
        if impl == "matmul":
            # the GEMM zero-fills non-finite values and counts them itself, so
            # NaN-masked and raw data take the same path
            return _seg_matmul_sum(data, codes, size)
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
    if out.is_floating_point():
        # straight to the float dtype: the fill may be an integer identity past
        # int64 (uint64's max, of a min leg reduced through float64)
        fill = torch.as_tensor(fill_value, dtype=out.dtype, device=out.device)
    else:
        fill = torch.as_tensor(fill_value).to(device=out.device, dtype=out.dtype)
    return torch.where(present, out, fill)


#: NaT viewed as int64: datetime64/timedelta64 data reaches the kernels as its
#: int64 view, and callers pass ``nat=True`` so that this value is missing
_NAT_INT = np.iinfo(np.int64).min


def _nan_mask(array: torch.Tensor, nat: bool = False):
    """True where a value is present: not NaN for floats, not NaT (INT64_MIN)
    for the int64 view of datetimes under ``nat``; None when nothing can be
    missing."""
    if array.is_floating_point() or array.is_complex():
        return ~torch.isnan(array)
    if nat and array.dtype == torch.int64:
        return array != _NAT_INT
    return None


def _iota_like(data: torch.Tensor) -> torch.Tensor:
    """int32 column positions of ``data`` (K, N), broadcast to its shape."""
    n = data.shape[-1]
    return torch.arange(n, dtype=torch.int32, device=data.device).expand(data.shape)


def _per_element(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Each element's group entry of a (K, size) ``table``, gathered to (K, N)
    by safe ``codes``; the missing-label segment ``size`` reads 0."""
    padded = torch.cat([table, table.new_zeros((table.shape[0], 1))], dim=1)
    return padded.index_select(1, codes)


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
        mask = _nan_mask(data, kw.get("nat", False)) if skipna else None
        if mask is not None:
            data = torch.where(mask, data, identity)
        data = _maybe_cast(data, dtype)
        out = _seg(op, data, codes, size)  # f32-accumulated for bf16/f16
        with telemetry.span("legs"):
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
        mask = _nan_mask(data, kw.get("nat", False))
        if skipna and mask is not None:
            data = torch.where(mask, data, minmax_identity(op, data.dtype))
        elif not skipna and mask is not None:
            # NaN (NaT) propagates through min/max in numpy: map it to the
            # absorbing element (the other op's identity), then re-inject the
            # missing marker from a per-group has-NaN flag
            has_nan = _seg("max", (~mask).to(torch.int8), codes, size) > 0
            data = torch.where(mask, data, minmax_identity(other, data.dtype))
            out = _seg(op, data, codes, size)
            with telemetry.span("legs"):
                out = torch.where(has_nan, float("nan") if out.is_floating_point() else _NAT_INT,
                                  out)
                out = _fill_empty(out, _counts(codes, size) > 0, fill_value)
                return _unflat(out, lead)
        out = _seg(op, data, codes, size)
        with telemetry.span("legs"):
            if fill_value is not None and fill_value != minmax_identity(op, data.dtype):
                # empty groups hold the identity already: only another fill needs
                # the (masked) counts
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
    mask = _nan_mask(data, kw.get("nat", False))
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


def _fused_stats(data: torch.Tensor, codes: torch.Tensor, size: int, want: tuple,
                 impl: str | None = None):
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
    exact below 2^24, so the numbers are the same). On the one-hot GEMM the
    sum and count legs come from one :func:`_seg_matmul_raw` pass, and a min
    or max leg returns None, as in the reference. Returns ``{name: (K,
    size)}``, or None when the policy resolves to scatter or a guard fails
    (callers then run the per-leg reductions). ``impl``: the segment-sum
    impl where the caller has resolved it already.
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
    impl = impl or _segment_sum_impl(data, size)
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
    elif impl == "matmul":
        sums, nan_c, pos_c, neg_c = _seg_matmul_raw(data, codes, size)
    else:
        sums, nan_c, pos_c, neg_c = (t.T for t in _raw_sum_legs(data, codes, size, impl))
    with telemetry.span("legs"):
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


def _raw_sum_legs(data: torch.Tensor, codes: torch.Tensor, size: int, impl: str):
    """The four (size, K) float32 legs ``(sums, nan_c, pos_c, neg_c)`` of
    ``data`` (K, N) from the segment-sum kernel (``impl`` "kernel", B1) or
    the radix-binning kernel ("radixbin", B5), as they write them."""
    raw = (cuda_kernels.segment_sum_raw if impl == "kernel"
           else cuda_kernels.segment_sum_radixbin_raw)
    return raw(data, codes, size)


def _rowcount(codes: torch.Tensor, size: int) -> torch.Tensor:
    """The columns of each group, (size,) int32, from safe ``codes``: equal
    to :func:`_counts` (``codes, size``), by ``index_add_`` of ones into
    ``size + 1`` slots, which reads nothing back to the host (``bincount``
    reads the codes' maximum first)."""
    out = torch.zeros(size + 1, dtype=torch.int32, device=codes.device)
    out.index_add_(0, codes, torch.ones_like(codes))
    return out[:size]


def fused_segment_stats(group_idx, array, *, size: int, want: tuple):
    """Plugin-layout entry to :func:`_fused_stats`: ``array`` (..., N) in,
    ``{name: (..., size)}`` out, or None."""
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    raw = _fused_stats(data, codes, size, tuple(want))
    if raw is None:
        return None
    return {k: _unflat(v, lead) for k, v in raw.items()}


def _fused_sum_counts(cast: torch.Tensor, codes: torch.Tensor, size: int,
                      impl: str | None = None):
    """Single-pass skipna (total, non-NaN count): the mean/var fast path."""
    got = _fused_stats(cast, codes, size, ("nansum", "nanlen"), impl)
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


_F32_MAX = float(np.finfo(np.float32).max)


def _f32_fill(fill) -> float | None:
    """``fill`` as a Python float where float32 holds it exactly (NaN and
    +-inf included), else None."""
    if isinstance(fill, (bool, np.bool_)) or not isinstance(fill, (int, float, np.integer,
                                                                    np.floating)):
        return None
    try:
        value = float(fill)
    except OverflowError:
        return None
    if not math.isfinite(value):
        return value
    if abs(value) > _F32_MAX or float(np.float32(value)) != value:
        return None
    return value


def _mean_pass(impl: str, dtype: torch.dtype, device_type: str, skipna: bool, fill) -> bool:
    """Whether a mean finishes in one :func:`cuda_kernels.mean_finalize` pass
    over the raw legs: a skipna mean whose segment sum resolves to the
    segment-sum kernel ("kernel", B1) or the radix-binning kernel
    ("radixbin", B5), of float32 or bfloat16 data on the card,
    with a fill that float32 holds. Everything else takes the torch passes."""
    return (skipna and impl in ("kernel", "radixbin") and device_type == "cuda"
            and dtype in cuda_kernels._MEAN_DTYPES and _f32_fill(fill) is not None)


def _mean_impl(group_idx, array, *, size, fill_value, dtype, skipna):
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    cast = _maybe_cast(data, _float_request(data, dtype))
    fill = fill_value if fill_value is not None else float("nan")
    impl = None
    # where _fused_stats would resolve the impl: float data, marker counts
    # exact in float32
    if skipna and cast.is_floating_point() and cast.shape[-1] < 2**24:
        impl = _segment_sum_impl(cast, size)
        if _mean_pass(impl, cast.dtype, cast.device.type, skipna, fill):
            legs = _raw_sum_legs(cast, codes, size, impl)
            with telemetry.span("legs"):
                out = cuda_kernels.mean_finalize(*legs, _rowcount(codes, size),
                                                 _f32_fill(fill), cast.dtype)
                return _unflat(out, lead)
    fused = _fused_sum_counts(cast, codes, size, impl) if skipna else None
    if fused is not None:
        total, cnt = fused
        present = cnt > 0
        orig_dtype = cast.dtype
    else:
        mask = _nan_mask(data) if skipna else None
        sdata = cast if mask is None else torch.where(mask, cast, 0)
        total = _seg("sum", sdata, codes, size)  # f32-accumulated for bf16/f16
        # counts in int32: exact whatever the data dtype (bf16 saturates at 256);
        # presence is tested before the cast, which may be to a complex dtype
        cnt_i = _counts(codes, size, mask=mask)
        present = cnt_i > 0
        cnt = cnt_i.to(total.dtype)
        orig_dtype = sdata.dtype
    with telemetry.span("legs"):
        out = total / cnt
        out = _fill_empty(out, present, fill)
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
    if data.is_complex() or (dtype is not None and utils.torch_dtype(dtype).is_complex):
        raise TypeError(
            "var and std of complex data are not supported: the reference returns the "
            "complex sum of (x - mean)**2, which is not numpy's variance (the sum of "
            "|x - mean|**2); reduce the real and imaginary parts separately")
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
    dev = zdata - _per_element(mean_g, codes)
    if mask is not None:
        dev = torch.where(mask, dev, 0)
    m2 = _seg("sum", dev * dev, codes, size)
    return zdata, m2, total, cnt_f, cnt_b, lead


def _var_impl(group_idx, array, *, size, fill_value, dtype, ddof, skipna, std):
    zdata, m2, _total, cnt_f, cnt_b, lead = _var_stats(
        group_idx, array, size=size, dtype=dtype, skipna=skipna
    )
    with telemetry.span("legs"):
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
# argreductions and positional first/last
#
# Positions are int32 column indices along the reduced axis, so the grouped
# min/max of a position array reaches the segment-min/max kernel's int32
# instance; _BIG (INT32_MAX) is the "no candidate" position.
# ---------------------------------------------------------------------------


def _where_fill(keep: torch.Tensor, out: torch.Tensor, fill) -> torch.Tensor:
    """``out`` where ``keep``, else ``fill``, with jnp.where's promotion of a
    Python float fill: an integer result becomes float64 rather than
    truncating the fill."""
    if isinstance(fill, (float, np.floating)) and not (out.is_floating_point()
                                                        or out.is_complex()):
        out = out.to(torch.float64)
    return torch.where(keep, out, torch.tensor(fill).to(dtype=out.dtype, device=out.device))


def _arg_impl(group_idx, array, *, size, fill_value, skipna, arg_of_max, nat=False):
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    mask = _nan_mask(data, nat)
    op = "max" if arg_of_max else "min"
    key = data
    if mask is not None:
        if skipna:
            key = torch.where(mask, data, minmax_identity(op, data.dtype))
        else:
            # numpy's rule: the FIRST NaN (NaT) position wins outright, even
            # over a group's ±inf (np.argmax([inf, nan]) == 1). NaNs leave the
            # value race here and come back as a position override below.
            key = torch.where(mask, data, minmax_identity("min" if arg_of_max else "max",
                                                          data.dtype))
    best = _seg(op, key, codes, size)
    iota = _iota_like(key)
    cand = torch.where(key == _per_element(best, codes), iota, _BIG)
    del best
    if skipna and mask is not None:
        cand = torch.where(mask, cand, _BIG)
    out = _seg("min", cand, codes, size)
    del cand
    if not skipna and mask is not None:
        first_nan = _seg("min", torch.where(mask, _BIG, iota), codes, size)
        out = torch.where(first_nan < _BIG, first_nan, out)
    present = _counts(codes, size, mask=mask if skipna else None) > 0
    out = _where_fill(present & (out < _BIG), out, -1 if fill_value is None else fill_value)
    return _unflat(out, lead)


def _arg_entry(skipna: bool, arg_of_max: bool):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return _arg_impl(group_idx, array, size=size, fill_value=fill_value, skipna=skipna,
                         arg_of_max=arg_of_max, nat=kw.get("nat", False))

    return kernel


argmax = _arg_entry(skipna=False, arg_of_max=True)
argmin = _arg_entry(skipna=False, arg_of_max=False)
nanargmax = _arg_entry(skipna=True, arg_of_max=True)
nanargmin = _arg_entry(skipna=True, arg_of_max=False)


def _default_fill(dtype: torch.dtype, fill_value):
    """The missing value of a positional result: NaN for floats, 0 else."""
    if fill_value is not None:
        return fill_value
    return float("nan") if dtype.is_floating_point or dtype.is_complex else 0


def _firstlast_impl(group_idx, array, *, size, fill_value, skipna, last, nat=False):
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    mask = _nan_mask(data, nat) if skipna else None
    iota = _iota_like(data)
    if mask is not None:
        iota = torch.where(mask, iota, -1 if last else _BIG)
    pos = _seg("max" if last else "min", iota, codes, size)
    valid = (pos >= 0) & (pos < _BIG)
    out = _gather_positions(data, pos)
    return _unflat(_fill_empty(out, valid, _default_fill(out.dtype, fill_value)), lead)


def _gather_positions(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``data`` (K, N) read at the (K, size) positions ``pos``, clipped into
    [0, N); a zero-length N reads zeros (every group is empty there)."""
    n = data.shape[-1]
    if n == 0:
        return data.new_zeros(pos.shape)
    return torch.gather(data, 1, pos.clamp(0, n - 1).to(torch.int64))


def _firstlast_entry(skipna: bool, last: bool):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return _firstlast_impl(group_idx, array, size=size, fill_value=fill_value,
                               skipna=skipna, last=last, nat=kw.get("nat", False))

    return kernel


first = _firstlast_entry(skipna=False, last=False)
last = _firstlast_entry(skipna=False, last=True)
nanfirst = _firstlast_entry(skipna=True, last=False)
nanlast = _firstlast_entry(skipna=True, last=True)


# ---------------------------------------------------------------------------
# order statistics: quantile, median and mode
#
# Two routes give the same order statistics (``quantile_impl``):
#
# * "sort": a lexicographic (code, value) sort of each row (``_group_sort``),
#   in the order of the reference's ``lax.sort``: -0.0 ties +0.0, every NaN
#   sorts last within its group, ties keep their column order. Torch ops
#   only, as the reference's own sort is XLA's.
# * "select": an MSB radix bisection over the monotonic integer view of the
#   data (``_radix_select``), no sort: per bit one counting pass, a
#   segment-sum of float32 0/1 predicates, which is the segment-sum kernel on
#   the card. The monotonic view orders -0.0 below +0.0.
#
# Rows are independent, so both run over blocks of rows whose working set
# stays under a byte budget: the results are the same as in one piece.
# ---------------------------------------------------------------------------

#: working-set budget of one row block of the order statistics, in bytes
_ORDER_BLOCK_BYTES = 8 << 30


def _row_blocks(k: int, bytes_per_row: int):
    """Row slices of a (k, N) array whose working set, ``bytes_per_row`` a
    row, stays within :data:`_ORDER_BLOCK_BYTES` (at least one row each)."""
    rows = max(1, _ORDER_BLOCK_BYTES // max(bytes_per_row, 1))
    for r0 in range(0, k, rows):
        yield slice(r0, min(k, r0 + rows))


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _signed_sort_key(data: torch.Tensor) -> torch.Tensor:
    """A signed integer of ``data``'s width whose order is the reference
    sort's order of the values: floats through the IEEE sign trick, with
    -0.0 keyed as +0.0 and every NaN, whatever its sign and payload, as the
    largest key (above +inf); integers and bools as they are."""
    if not data.is_floating_point():
        return data.to(torch.uint8) if data.dtype == torch.bool else data
    nbits = 8 * data.element_size()
    top = (1 << (nbits - 1)) - 1
    bits = data.view(_INT_OF_WIDTH[data.element_size()])
    # negatives: flip every bit but the sign, so larger magnitudes sort lower
    key = bits ^ ((bits >> (nbits - 1)) & top)
    key = torch.where(data == 0, 0, key)  # -0.0 ties +0.0
    return torch.where(torch.isnan(data), top, key)  # every NaN one key, above +inf


def _group_sort(codes: torch.Tensor, data: torch.Tensor):
    """Sort each row of ``data`` (K, N) by (code, value), stably, in the
    reference's order. Returns the sorted codes (N,), the same for every
    row, and the permutation (K, N) int64 that sorts each row.

    Data of up to 32 bits sorts once, on one int64 key ``code << 32 | value
    key``; 64-bit data sorts by value, then stably by code.
    """
    sorted_codes = torch.sort(codes, stable=True).values
    key = _signed_sort_key(data)
    width = key.element_size()
    if width <= 4:
        nbits = 8 * width
        offset = 0 if key.dtype == torch.uint8 else 1 << (nbits - 1)
        key = (codes.to(torch.int64) << 32) + key.to(torch.int64) + offset
        return sorted_codes, torch.sort(key, dim=-1, stable=True).indices
    by_value = torch.sort(key, dim=-1, stable=True).indices
    del key
    by_code = torch.sort(codes[by_value], dim=-1, stable=True).indices
    return sorted_codes, by_value.gather(1, by_code)


def _monotonic_key(data: torch.Tensor) -> torch.Tensor:
    """The reference's ``_monotonic_uint`` bits in a signed integer of the
    same width: floats through the IEEE sign trick (negatives invert, others
    set the sign bit: unsigned order is total order, NaN above +inf), signed
    integers with the sign bit flipped, uint8 as it is. The bisection only
    tests ``key >> b == prefix >> b``, which holds under an arithmetic shift
    exactly when it holds under a logical one, so no unsigned type is
    needed."""
    it = _INT_OF_WIDTH[data.element_size()]
    nbits = 8 * data.element_size()
    sign = -(1 << (nbits - 1))
    bits = data.view(it)
    if data.is_floating_point():
        return torch.where(bits < 0, ~bits, bits | sign)
    if data.dtype == torch.uint8:
        return bits
    return bits ^ sign


def _key_to_value(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_monotonic_key` (the reference's ``_uint_to_value``)."""
    nbits = 8 * key.element_size()
    sign = -(1 << (nbits - 1))
    if dtype.is_floating_point:
        bits = torch.where(key < 0, key ^ sign, ~key)
    elif dtype == torch.uint8:
        bits = key
    else:
        bits = key ^ sign
    return bits.view(dtype)


def _valid_keys(data: torch.Tensor, valid_mask) -> torch.Tensor:
    """Monotonic keys with invalid lanes parked at the all-ones key: every
    valid key is below it, so a rank among the valid elements never lands
    on one."""
    keys = _monotonic_key(data)
    if valid_mask is not None:
        keys = torch.where(valid_mask, keys, -1)
    return keys


def _bit(b: int, nbits: int) -> int:
    """Bit ``b`` of an ``nbits``-wide signed integer, as a Python int."""
    return -(1 << b) if b == nbits - 1 else 1 << b


def _radix_pass_count(keys, codes, size: int, prefix, b: int, cdtype) -> torch.Tensor:
    """One counting pass: per rank lane, how many of each group's elements
    lie in the candidate subtree whose bits above ``b`` match the prefix and
    whose bit ``b`` is 0. ``keys`` (K, N), ``prefix`` (m, K, size); the m
    lanes' predicates stack into one (m*K, N) segment-sum, so every lane
    shares the pass. Returns int32 (m, K, size)."""
    m, k, _ = prefix.shape
    table = torch.cat([prefix >> b, prefix.new_zeros((m, k, 1))], dim=2)
    pred = (keys >> b).unsqueeze(0) == table.index_select(2, codes)
    del table
    cnt = _seg("sum", pred.to(cdtype).reshape(m * k, -1), codes, size)
    return cnt.reshape(m, k, size).to(torch.int32)


def _radix_update(prefix, rank, cnt, b: int):
    """Bisection step: lanes whose rank falls past the zero-subtree count
    descend into the one-subtree (set bit ``b``, discount the count)."""
    take_hi = rank >= cnt
    bit = _bit(b, 8 * prefix.element_size())
    return torch.where(take_hi, prefix | bit, prefix), torch.where(take_hi, rank - cnt, rank)


def _radix_select(data, codes, size: int, ranks, valid_mask, comm=None,
                  n_total: int | None = None) -> torch.Tensor:
    """Exact per-group order statistics without a sort (the reference's
    ``_radix_select``): ``ranks`` (m, K, size) holds m sets of 0-based
    within-group ranks among the valid elements of ``data`` (K, N); returns
    the rank-th smallest valid values, (m, K, size), bit for bit the sorted
    data at those ranks (-0.0 below +0.0).

    One counting pass per bit of the data's width: a segment-sum over N of
    0/1 predicates, float32 while the ``n_total`` elements of the whole axis
    stay below 2^24 (exact there; the segment-sum kernel on the card), int32
    past it. On a mesh, ``data`` is this rank's shard and ``comm`` the
    collective layer: each pass's counts are summed over the shards, so the
    selection is global and the same on every rank."""
    nbits = 8 * data.element_size()
    keys = _valid_keys(data, valid_mask)
    n_total = data.shape[-1] if n_total is None else n_total
    cdtype = torch.float32 if n_total < 2**24 else torch.int32
    prefix = torch.zeros(ranks.shape, dtype=keys.dtype, device=keys.device)
    rank = ranks.to(torch.int32)
    for b in range(nbits - 1, -1, -1):
        cnt = _radix_pass_count(keys, codes, size, prefix, b, cdtype)
        if comm is not None:
            cnt = comm.psum(cnt)
        prefix, rank = _radix_update(prefix, rank, cnt, b)
    return _key_to_value(prefix, data.dtype)


# numpy's (alpha, beta) plotting positions of the continuous methods:
# h = q (n + 1 - alpha - beta) + alpha - 1, clipped to [0, n - 1], linearly
# interpolated. The discrete methods derive from the linear h.
_ALPHA_BETA = {
    "linear": (1.0, 1.0),
    "hazen": (0.5, 0.5),
    "weibull": (0.0, 0.0),
    "interpolated_inverted_cdf": (0.0, 1.0),
    "median_unbiased": (1 / 3, 1 / 3),
    "normal_unbiased": (3 / 8, 3 / 8),
}
_DISCRETE_METHODS = ("lower", "higher", "nearest", "midpoint")


def _quantile_alpha_beta(method: str):
    if method in _ALPHA_BETA:
        return _ALPHA_BETA[method]
    if method in _DISCRETE_METHODS:
        return 1.0, 1.0
    raise ValueError(
        f"Unsupported quantile method {method!r}; supported: "
        f"{sorted(_ALPHA_BETA) + list(_DISCRETE_METHODS)}"
    )


def _quantile_pos(qi: float, nnf: torch.Tensor, alpha: float, beta: float):
    """The within-group virtual index h of ``qi`` (float64) and its floor and
    ceiling (int64)."""
    pos = qi * (nnf + 1 - alpha - beta) + (alpha - 1)
    pos = torch.minimum(pos.clamp(min=0), (nnf - 1).clamp(min=0))
    return pos, torch.floor(pos).to(torch.int64), torch.ceil(pos).to(torch.int64)


def _quantile_rank_sets(qs, nnf, method: str, alpha: float, beta: float):
    """Every within-group rank the bisection selects, across all q (each
    counting pass serves every lane), and per q the meta ``(pos, lo_in, ia,
    ib)`` of its interpolation."""
    rank_list: list = []
    meta = []
    for qi in qs:
        pos, lo_in, hi_in = _quantile_pos(qi, nnf, alpha, beta)
        ia = ib = len(rank_list)
        if method == "nearest":
            rank_list.append(torch.round(pos).to(torch.int64))  # half to even, as numpy
        elif method == "lower":
            rank_list.append(lo_in)
        elif method == "higher":
            rank_list.append(hi_in)
        else:
            ib = ia + 1
            rank_list += [lo_in, hi_in]
        meta.append((pos, lo_in, ia, ib))
    return torch.stack(rank_list), meta


def _interp(method: str, pos, lo_in, v_lo, v_hi):
    """One q's value from its lower and upper order statistics, in the data
    dtype (``nearest`` and ``lower`` read ``v_lo``)."""
    if method in ("lower", "nearest"):
        return v_lo
    if method == "higher":
        return v_hi
    if method == "midpoint":
        return (v_lo + v_hi) / 2
    frac = (pos - lo_in).to(v_lo.dtype)
    return v_lo + frac * (v_hi - v_lo)


def _quantile_impl_choice(data: torch.Tensor | None = None, size: int = 0) -> str:
    """"sort" or "select" for grouped order statistics; "auto" is the sort,
    or with the autotuner on the observed winner for ``data``'s band."""
    policy = OPTIONS["quantile_impl"]
    if policy != "auto":
        return policy
    if OPTIONS["autotune"] and data is not None:
        from . import autotune

        return autotune.decide("quantile", "sort", ("sort", "select"),
                               dtype=autotune.dtype_name(data.dtype), ngroups=size,
                               nelems=data.numel(), platform=data.device.type)
    return "sort"


def _quantile_block(codes, data, qs, *, size: int, skipna: bool, method: str, fill_value,
                    select: bool, comm=None, n_total: int | None = None) -> torch.Tensor:
    """The quantiles ``qs`` of one row block ``data`` (Kb, N): (nq, Kb, size).
    On a mesh (``comm``) the NaN flags and the group sizes are combined over
    the shards and the select runs distributed."""
    mask = _nan_mask(data)
    group_has_nan = None
    if not skipna and mask is not None:
        has_nan = _seg("max", (~mask).to(torch.int8), codes, size)
        group_has_nan = (comm.pmax(has_nan) if comm is not None else has_nan) > 0
    # index arithmetic in float64, never the data dtype: bfloat16 cannot
    # even hold odd counts above 256
    nn = _counts(codes, size, mask=mask).expand(data.shape[0], size)
    if comm is not None:
        nn = comm.psum(nn)
    nnf = nn.to(torch.float64)
    alpha, beta = _quantile_alpha_beta(method)
    fv = float("nan") if fill_value is None else fill_value
    fill = torch.tensor(fv).to(dtype=data.dtype, device=data.device)
    if select:
        ranks, meta = _quantile_rank_sets(qs, nnf, method, alpha, beta)
        selected = _radix_select(data, codes, size, ranks, mask, comm, n_total)
        vals = [_interp(method, pos, lo_in, selected[ia], selected[ib])
                for pos, lo_in, ia, ib in meta]
    else:
        _, perm = _group_sort(codes, data)
        full_counts = torch.bincount(codes, minlength=size + 1)[:size]
        offsets = torch.cumsum(full_counts, 0) - full_counts  # exclusive, int64
        nmax = data.shape[-1]

        def at(within):  # the sorted data at within-group ranks (Kb, size)
            return _gather_positions(data, perm.gather(1, (offsets + within).clamp(0, nmax - 1)))

        vals = []
        for qi in qs:
            pos, lo_in, hi_in = _quantile_pos(qi, nnf, alpha, beta)
            if method == "nearest":  # the virtual index rounds half to even, as numpy's
                vals.append(at(torch.round(pos).to(torch.int64)))
            else:
                vals.append(_interp(method, pos, lo_in, at(lo_in), at(hi_in)))
    out = []
    for val in vals:
        val = torch.where(nnf <= 0, fill, val)
        if group_has_nan is not None:
            val = torch.where(group_has_nan, float("nan"), val)
        out.append(val)
    return torch.stack(out)


def _quantile_rows(data: torch.Tensor, nq: int, method: str, select: bool,
                   n: int | None = None) -> list:
    """The row blocks of a quantile call on ``data`` (K, N): a row's working
    set is, per rank lane, the select path's gathered prefixes and 0/1
    predicate (bool and float32), or the sort path's int64 key, sorted key,
    permutation and the sort's scratch, over ``n`` columns (default N). On a
    mesh ``n`` is the whole axis, so every rank cuts the same blocks and runs
    the same collectives."""
    k, n = data.shape[0], data.shape[-1] if n is None else n
    lanes = nq * (1 if method in ("lower", "higher", "nearest") else 2)
    per_row = n * (lanes * (data.element_size() + 5) if select else 40)
    return list(_row_blocks(k, per_row))


def _quantile_impl(group_idx, array, *, size, fill_value, dtype, q, skipna, method="linear",
                   axis_name=None):
    """``axis_name``: the collective layer (``parallel.mesh.Collectives``) of
    a mesh program whose shard ``array`` is; the quantiles are then those of
    the whole axis, by the distributed radix select, on every rank."""
    if axis_name is not None and not hasattr(axis_name, "psum"):
        raise TypeError(
            "axis_name= takes the collective layer of a mesh program "
            f"(flox_tpu_torch.parallel.mesh.collectives(mesh, axes)); got {axis_name!r}")
    comm = axis_name
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    if not data.is_floating_point():
        data = data.to(utils.torch_dtype(dtype) if dtype is not None else torch.float64)
    qs = np.atleast_1d(np.asarray(q, dtype=np.float64))
    _quantile_alpha_beta(method)  # an unknown method raises before any work
    # on a mesh only the counting bisection distributes
    select = comm is not None or _quantile_impl_choice(data, size) == "select"
    k, n = data.shape
    n_total = n
    if comm is not None:  # the whole axis: every rank cuts the same row blocks
        n_total = int(comm.psum(torch.tensor([n], device=data.device)).item())
    if k == 0 or n_total == 0:  # every group is empty
        fv = float("nan") if fill_value is None else fill_value
        out = torch.full((len(qs), k, size), fv, dtype=data.dtype, device=data.device)
    else:
        out = torch.cat([
            _quantile_block(codes, data[rows], qs, size=size, skipna=skipna, method=method,
                            fill_value=fill_value, select=select, comm=comm, n_total=n_total)
            for rows in _quantile_rows(data, len(qs), method, select, n_total)
        ], dim=1)
    out = out.reshape((len(qs),) + lead + (size,))
    return out[0] if np.ndim(q) == 0 else out


def _quantile_entry(skipna: bool, median: bool):
    def kernel(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, q=None,
               method="linear", axis_name=None, **kw):
        if median:
            q, method = 0.5, "linear"
        elif q is None:
            raise TypeError("quantile needs q= (finalize_kwargs={'q': ...})")
        return _quantile_impl(group_idx, array, size=size, fill_value=fill_value, dtype=dtype,
                              q=q, skipna=skipna, method=method, axis_name=axis_name)

    return kernel


quantile = _quantile_entry(skipna=False, median=False)
nanquantile = _quantile_entry(skipna=True, median=False)
median = _quantile_entry(skipna=False, median=True)
nanmedian = _quantile_entry(skipna=True, median=True)


def _mode_runs(codes: torch.Tensor, data: torch.Tensor, skipna: bool):
    """One row block of the mode: the group-sorted data (Kb, N) and each
    sorted position's run length (int32; -1 at NaN under skipna). A run is a
    maximal stretch of equal values within a group; without skipna all of a
    group's NaNs form one run (scipy.stats.mode's "propagate", via
    np.unique's equal_nan)."""
    sorted_codes, perm = _group_sort(codes, data)
    sdata = data.gather(1, perm)
    del perm
    n = sdata.shape[-1]
    smask = ~torch.isnan(sdata) if sdata.is_floating_point() else None
    val_same = sdata[:, 1:] == sdata[:, :-1]
    if smask is not None and not skipna:
        val_same |= ~smask[:, 1:] & ~smask[:, :-1]  # NaNs sort last: one run
    prev_same = torch.cat([torch.zeros_like(val_same[:, :1]),
                           val_same & (sorted_codes[1:] == sorted_codes[:-1])], dim=1)
    del val_same
    iota = _iota_like(sdata)
    run_start = torch.cummax(torch.where(prev_same, -1, iota), dim=1).values
    next_same = torch.cat([prev_same[:, 1:], torch.zeros_like(prev_same[:, :1])], dim=1)
    del prev_same
    run_end = torch.cummin(torch.where(next_same, n, iota).flip(1), dim=1).values.flip(1)
    run_len = run_end - run_start + 1
    if smask is not None and skipna:
        run_len = torch.where(smask, run_len, -1)
    return sdata, run_len


def _mode_impl(group_idx, array, *, size, fill_value, skipna):
    codes = _safe_codes(group_idx, size)
    data, lead = _flat(array)
    k, n = data.shape
    # the sort runs in row blocks (a row element holds the int64 key, sorted
    # key and permutation, the cummax/cummin values and int64 indices); the
    # run lengths of all rows then meet in two full-width segment-min/max
    # passes (int32)
    sdata = torch.empty_like(data)
    run_len = torch.empty(data.shape, dtype=torch.int32, device=data.device)
    sorted_codes = torch.sort(codes, stable=True).values
    for rows in _row_blocks(k, 48 * n):
        sdata[rows], run_len[rows] = _mode_runs(codes, data[rows], skipna)
    best = _seg("max", run_len, sorted_codes, size)
    iota = _iota_like(run_len)
    cand = torch.where((run_len == _per_element(best, sorted_codes)) & (run_len > 0), iota, _BIG)
    del best, run_len
    pos = _seg("min", cand, sorted_codes, size)
    del cand
    out = _gather_positions(sdata, pos)
    return _unflat(_fill_empty(out, pos < _BIG, _default_fill(out.dtype, fill_value)), lead)


def mode(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mode_impl(group_idx, array, size=size, fill_value=fill_value, skipna=False)


def nanmode(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
    return _mode_impl(group_idx, array, size=size, fill_value=fill_value, skipna=True)


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


def _cumsum_impl(group_idx, array, *, size, dtype, skipna, nat=False):
    data, lead = _flat(array)
    cast = _maybe_cast(data, dtype)
    if not nat and _scan_impl_choice(cast, size) == "kernel":
        codes = group_idx.reshape(-1).to(data.device)
        return _unflat(cuda_kernels.segment_cumsum(cast, codes, size, skipna), lead)
    sorted_data, flags, inv = _grouped_scan_setup(group_idx, data)
    # nat: the int64 view of timedeltas, NaT = INT64_MIN. Unlike NaN, the
    # marker does not propagate through +, so it is masked out of the running
    # sum and, without skipna, re-applied from the first NaT of a group on
    # (numpy's cumsum of a NaT timedelta is NaT thereafter)
    mask = _nan_mask(sorted_data, nat) if (skipna or nat) else None
    vals = sorted_data if mask is None else torch.where(mask, sorted_data, 0)
    vals = _maybe_cast(vals, dtype)
    out_dtype = vals.dtype
    if vals.is_floating_point():
        vals = vals.to(_acc_dtype(vals.dtype))  # a bf16 running sum saturates
    scanned = _segmented_scan(vals, flags, torch.add)
    if nat and not skipna and mask is not None:
        seen_missing = _segmented_scan((~mask).to(torch.int32), flags, torch.maximum)
        scanned = torch.where(seen_missing > 0, _NAT_INT, scanned)
    return _unflat(scanned.to(out_dtype).index_select(1, inv), lead)


def cumsum(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _cumsum_impl(group_idx, array, size=size, dtype=dtype, skipna=False,
                        nat=kw.get("nat", False))


def nancumsum(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _cumsum_impl(group_idx, array, size=size, dtype=dtype, skipna=True,
                        nat=kw.get("nat", False))


def _ffill_impl(group_idx, array, *, reverse: bool, nat: bool = False):
    """Each missing value takes the last valid value before it in its group
    (bfill: after it). The last valid index is a running max of the masked
    iota over the code-sorted axis; it belongs to the group when it is not
    before the start of the position's run. With no valid value before it a
    position stays missing: NaN, or NaT for the int64 view of datetimes."""
    data, lead = _flat(array)
    codes = group_idx.reshape(-1)
    if reverse:
        codes, data = codes.flip(0), data.flip(-1)
    sorted_data, starts, inv = _grouped_scan_setup(codes, data)
    mask = _nan_mask(sorted_data, nat)
    out = sorted_data
    if mask is not None:
        iota = torch.arange(sorted_data.shape[-1], device=data.device)
        last_valid = torch.cummax(torch.where(mask, iota, -1), dim=-1).values
        run_start = torch.cummax(torch.where(starts, iota, 0), dim=0).values
        gathered = torch.gather(sorted_data, 1, last_valid.clamp(min=0))
        missing = float("nan") if sorted_data.is_floating_point() else _NAT_INT
        out = torch.where(last_valid >= run_start, gathered, missing)
    out = out.index_select(1, inv)
    if reverse:
        out = out.flip(-1)
    return _unflat(out, lead)


def ffill(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _ffill_impl(group_idx, array, reverse=False, nat=kw.get("nat", False))


def bfill(group_idx, array, *, axis=-1, size=None, fill_value=None, dtype=None, **kw):
    return _ffill_impl(group_idx, array, reverse=True, nat=kw.get("nat", False))


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
    the scatter only copies values), or for a numpy (datetime) result a
    numpy array.
    """
    if isinstance(result_c, np.ndarray):
        return PresentGroups(present, result_c, size).scatter_dense()
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


# ---------------------------------------------------------------------------
# unsigned data wider than 8 bits
#
# torch's uint16/uint32/uint64 have casts and views but no scatter, no
# ``index_add_`` and no kernel route, so such data is widened exactly on entry
# to every kernel: uint16 to int32, uint32 to int64. uint64 fits no signed
# type: functions whose result is a float (sums, means, variances, order
# statistics, any/all) take float64, as the reference does; the others
# (extrema, positions, first/last, fills, mode, counts) take the
# order-preserving key ``x ^ 2**63`` viewed as int64, and values come back
# through the same flip.
# ---------------------------------------------------------------------------

_WIDE_UNSIGNED = {torch.uint16: torch.int32, torch.uint32: torch.int64}

#: kernels whose result holds the input's values (cast back after widening)
_VALUE_FUNCS = frozenset({"max", "nanmax", "min", "nanmin", "first", "last", "nanfirst",
                          "nanlast", "mode", "nanmode", "ffill", "bfill"})

#: kernels that take uint64 data as order-preserving int64 keys
_KEY_FUNCS = _VALUE_FUNCS | {"argmax", "argmin", "nanargmax", "nanargmin", "count", "nanlen",
                             "len"}

_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def _u64_key(x: torch.Tensor) -> torch.Tensor:
    """uint64 -> int64 in the same order (and back: the flip is its own
    inverse on the int64 view)."""
    return x.view(torch.int64) ^ _NAT_INT


def _where_u64(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` of uint64 tensors, through their int64 views: CUDA has
    no uint64 ``where``."""
    return torch.where(cond, a.view(torch.int64), b.view(torch.int64)).view(torch.uint64)


def unsigned_route(dtype: torch.dtype, func: str) -> tuple[torch.dtype, bool]:
    """``(work dtype, keyed)`` of unsigned ``dtype`` data under ``func``:
    widened exactly, or (uint64 only) float64 or the int64 key."""
    if dtype in _WIDE_UNSIGNED:
        return _WIDE_UNSIGNED[dtype], False
    return (torch.int64, True) if func in _KEY_FUNCS else (torch.float64, False)


def _unsigned_kernel(fn, func: str, group_idx, array, kwargs):
    orig = array.dtype
    req = kwargs.get("dtype")
    req = None if req is None else utils.torch_dtype(req)
    work, keyed = unsigned_route(orig, func)
    if orig in _WIDE_UNSIGNED:
        if req in _UNSIGNED:
            kwargs["dtype"] = _WIDE_UNSIGNED.get(req, torch.float64)
        out = fn(group_idx, array.to(work), **kwargs)
        back = req if req in _UNSIGNED else (orig if func in _VALUE_FUNCS else None)
        if back is not None and isinstance(out, torch.Tensor) and out.dtype == work:
            out = out.to(back)
        return out
    if not keyed:
        return fn(group_idx, array.to(work), **kwargs)
    if func not in _VALUE_FUNCS:
        return fn(group_idx, _u64_key(array), **kwargs)
    # values come back through the key flip; a fill is applied after it, so a
    # float fill promotes the uint64 values, not their keys
    fill = kwargs.pop("fill_value", None)
    out = _u64_key(fn(group_idx, _u64_key(array), fill_value=None, **kwargs)).view(torch.uint64)
    if fill is not None:
        present = _counts(_safe_codes(group_idx, kwargs["size"]), kwargs["size"]) > 0
        if utils.is_nan_fill(fill) or isinstance(fill, float):
            out = out.to(torch.float64)
        fill = torch.as_tensor(fill).to(device=out.device, dtype=out.dtype)
        out = (_where_u64 if out.dtype == torch.uint64 else torch.where)(present, out, fill)
    return out


def generic_kernel(func: str, group_idx, array, **kwargs):
    """Entry point of the "torch" engine."""
    try:
        fn = KERNELS[func]
    except KeyError:
        raise NotImplementedError(f"the torch engine has no kernel for {func!r}") from None
    if isinstance(array, torch.Tensor) and array.dtype in _UNSIGNED:
        return _unsigned_kernel(fn, func, group_idx, array, kwargs)
    return fn(group_idx, array, **kwargs)

