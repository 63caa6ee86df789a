"""Hand-written CUDA kernels for the hot segment reductions, with their plain
PyTorch versions (the counterpart of ``flox_tpu/pallas_kernels.py``).

========================  ==========================================  =====================
kernel (source)           replaces (flox_tpu/pallas_kernels.py)       plain version
========================  ==========================================  =====================
``segment_sum_raw``       ``_kernel`` + ``_accum_update`` (B1),        ``segment_sum_raw_plain``
(csrc/segment_sum.cu)     via ``segment_sum_raw_pallas``
``segment_minmax``        ``_minmax_kernel`` (B3), via                 ``segment_minmax_plain``
(csrc/segment_minmax.cu)  ``segment_minmax_pallas``
``segment_multistat``     ``_multistat_kernel`` + ``_minmax_accumulate``  ``segment_multistat_plain``
(csrc/segment_multistat   (B2), via ``segment_multistat_pallas``
.cu)
``segment_cumsum``        ``_scan_kernel`` (B4), via                   ``segment_cumsum_plain``
(csrc/segment_cumsum.cu)  ``segment_cumsum_pallas``
``segment_sum_radixbin``  ``_radixbin_kernel`` (B5), via               ``segment_sum_radixbin_plain``
(csrc/segment_radixbin    ``segment_sum_radixbin_pallas``
.cu)
========================  ==========================================  =====================

Every kernel takes ``data`` as (K, N), N contiguous — the trailing-reduce
layout the caller already holds — and reads it once, in place. The three
reductions are bound by that read: K*N*itemsize bytes over the card's memory
rate (3.35 TB/s on an H100 SXM), 2.05 ms for the 65160 x 26304 float32
benchmark array; the cumsum also writes a (K, N) result, 4.09 ms (computed,
not measured). The radix-binning kernel also writes 4*size*K*4 bytes of
outputs, which at the 1096 day groups of the daily means is 1.14 GB more,
2.39 ms in all. The design notes sit at the top of each source; the segment-
sum, multi-statistic and segment-min/max kernels share theirs
(csrc/segment_reduce.cuh).

Dispatch: a wrapper runs the plain version only for a tensor on the CPU. For
a CUDA tensor it launches the kernel or raises; there is no fallback. Each
launch adds one to :data:`LAUNCHES`, so a run can show that it went through
the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .options import OPTIONS, VALID_ACCUMS

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "segment_cumsum",
    "segment_cumsum_plain",
    "segment_minmax",
    "segment_minmax_plain",
    "segment_multistat",
    "segment_multistat_plain",
    "segment_sum",
    "segment_sum_radixbin",
    "segment_sum_radixbin_plain",
    "segment_sum_radixbin_raw",
    "segment_sum_raw",
    "segment_sum_raw_plain",
]

#: kernel launches since the last reset, one per launch of each kernel
LAUNCHES = {"segment_sum": 0, "segment_minmax": 0, "segment_multistat": 0, "segment_cumsum": 0,
            "segment_sum_radixbin": 0}

_SUM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MINMAX_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_ACCUM_CODES = {"plain": 0, "kahan": 1, "dd": 2}
_OP_CODES = {"min": 0, "max": 1}
_MAX_GROUPS = 512  # the C entry points of B1-B4 refuse more
_RADIXBIN_MAX_GROUPS = 2**31 - 1  # B5 bins the codes in int32, the invalid ones to `size`
#: B1, B2, B3 and B5 index the binned columns in int32, a 32-column stage past the last
_MAX_BINNED_COLS = 2**31 - 33
#: csrc/segment_reduce.cuh: rows per block, columns per stage, and resident
#: blocks per SM (its __launch_bounds__) by data dtype
_ROWS_PER_BLOCK = 256
_STAGE_COLS = 32
_BLOCKS_PER_SM = {torch.float32: 3, torch.bfloat16: 2, torch.int32: 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def minmax_identity(op: str, dtype: torch.dtype):
    """Identity of grouped min/max for ``dtype``: -inf (floats) / iinfo.min
    (ints) for max, +inf / iinfo.max for min. The absorbing element — what NaN
    maps to so that it wins — is the other op's identity."""
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _check_args(data: torch.Tensor, codes: torch.Tensor, size: int, dtypes, what: str,
                max_groups: int = _MAX_GROUPS, max_cols: int | None = None) -> None:
    if data.dim() != 2:
        raise ValueError(f"{what}: data must be (K, N); got shape {tuple(data.shape)}")
    if codes.dim() != 1 or codes.shape[0] != data.shape[1]:
        raise ValueError(
            f"{what}: codes must be (N,) = ({data.shape[1]},); got {tuple(codes.shape)}"
        )
    if max_cols is not None and data.shape[1] > max_cols:
        raise ValueError(f"{what}: N must be at most {max_cols}; got {data.shape[1]}")
    if data.dtype not in dtypes:
        raise TypeError(f"{what}: no kernel for {data.dtype}; takes {sorted(map(str, dtypes))}")
    if codes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: codes must be int32 or int64; got {codes.dtype}")
    if not 1 <= int(size) <= max_groups:
        raise ValueError(f"{what}: size must be in [1, {max_groups}]; got {size}")
    if codes.device != data.device:
        raise ValueError(f"{what}: data on {data.device} but codes on {codes.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {data.device}")


def _codes_int32(codes: torch.Tensor, size: int) -> torch.Tensor:
    """The kernels take int32 codes: convert once, sending out-of-range int64
    codes to -1 first so that none wraps into [0, size)."""
    if codes.dtype == torch.int64:
        codes = torch.where((codes < 0) | (codes >= size), -1, codes)
    return codes.to(torch.int32).contiguous()


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: a CUDA tensor was given but this process has no CUDA")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _lib(name: str, argtypes) -> ctypes.CDLL:
    lib = _build.library(name)
    fn = getattr(lib, f"flox_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# B1: segment-sum with non-finite markers
# ---------------------------------------------------------------------------


def segment_sum_raw(data: torch.Tensor, codes: torch.Tensor, size: int, accum: str | None = None):
    """Per-group sums of ``data`` (K, N) by ``codes`` (N,), zero-filled at
    non-finite values, plus the NaN, +inf and -inf counts: four (size, K)
    float32 tensors ``(sums, nan_c, pos_c, neg_c)``.

    Codes outside [0, size) drop out. ``accum`` (default: the
    ``pallas_accum`` option) is "plain", "kahan" or "dd". float32 and
    bfloat16 data; sums accumulate in float32 either way. On the card the
    codes are binned first (:func:`_radixbin_bins`) and the kernel walks each
    group's columns in column order, one thread per row: per (group, row) the
    sum is sequential over the group's columns under ``accum``, the bits of
    :func:`segment_sum_radixbin_raw` on the same input.
    """
    accum = OPTIONS["pallas_accum"] if accum is None else accum
    if accum not in VALID_ACCUMS:
        raise ValueError(f"accum must be one of {VALID_ACCUMS}; got {accum!r}")
    _check_args(data, codes, size, _SUM_DTYPES, "segment_sum", max_cols=_MAX_BINNED_COLS)
    if data.device.type == "cpu":
        return segment_sum_raw_plain(data, codes, size, accum)
    return _segment_reduce_cuda("segment_sum", data, codes, int(size), accum)


def segment_sum(data, codes, size: int, accum: str | None = None, *, skipna: bool = False):
    """:func:`segment_sum_raw` with IEEE non-finite propagation re-applied
    (parity: ``segment_sum_pallas``): a (size, K) float32 tensor."""
    from .utils import reapply_nonfinite

    return reapply_nonfinite(*segment_sum_raw(data, codes, size, accum), skipna=skipna)


def _groups_per_block(size: int, k: int, n: int, slots: int) -> int:
    """Groups per block of B1, B2 and B3 (csrc/segment_reduce.cuh) for ``size``
    groups over (``k``, ``n``) data, with ``slots`` blocks resident on the
    card at once.

    One group per block, so that the ``size`` blocks of a 256-row tile walk
    its rows together and share them in L2, unless the groups average fewer
    than one 32-column stage each: then the fewest groups that average a
    stage, ``ceil(32 * size / n)``, but never so many that the grid holds
    fewer blocks than ``slots``. On the main path's 12 month groups that is
    1: 3060 blocks, 7.7 waves of 396 (3 float32 blocks on each of 132 SMs).
    """
    tiles = -(-k // _ROWS_PER_BLOCK)
    stage = -(-_STAGE_COLS * size // max(n, 1))
    fill = max(1, size * tiles // slots)
    return max(1, min(stage, fill, size))


_REDUCE_ARGTYPES = [_P, _I, _P, _P, _P, _LL, _LL, _I, _I, _I]


def _segment_reduce_cuda(name: str, data, codes, size: int, mode: str):
    """Launch B1 (``name`` "segment_sum"), B2 ("segment_multistat") or B3
    ("segment_minmax") on binned codes: their four, six or one (size, K)
    outputs. ``mode`` is the accumulation of B1 and B2 and B3's op."""
    _require_cuda(name)
    k, n = data.shape
    if name == "segment_minmax":
        outs = [torch.empty((size, k), dtype=data.dtype, device=data.device)]
        code = _OP_CODES[mode]
        empty = [minmax_identity(mode, data.dtype)]
    else:
        outs = [torch.empty((size, k), dtype=torch.float32, device=data.device) for _ in range(4)]
        code = _ACCUM_CODES[mode]
        empty = [0.0] * 4
        if name == "segment_multistat":
            outs += [torch.empty((size, k), dtype=data.dtype, device=data.device) for _ in range(2)]
            empty += [float("inf"), float("-inf")]
    if k == 0 or n == 0:
        # nothing to read, so no launch: every group is empty
        for o, v in zip(outs, empty):
            o.fill_(v)
        return tuple(outs)
    lib = _lib(name, _REDUCE_ARGTYPES + [_P] * (len(outs) + 1))
    # the kernel gathers rows of (K, N) row-major: a non-contiguous input is
    # copied once here; a contiguous one (the usual case) is read in place
    data = data.contiguous()
    perm, sorted_codes, offsets = _radixbin_bins(codes, size)
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    groups = _groups_per_block(size, k, n, sms * _BLOCKS_PER_SM[data.dtype])
    err = getattr(lib, f"flox_{name}")(
        data.data_ptr(), _MINMAX_DTYPES[data.dtype], perm.data_ptr(), sorted_codes.data_ptr(),
        offsets.data_ptr(), k, n, size, groups, code,
        *(o.data_ptr() for o in outs), _stream(data.device),
    )
    _build.check(lib, err, f"{name} launch")
    LAUNCHES[name] += 1
    return tuple(outs)


def segment_sum_raw_plain(data: torch.Tensor, codes: torch.Tensor, size: int, accum: str):
    """Plain PyTorch version of :func:`segment_sum_raw`: zero-fill plus
    ``index_add_``. "plain" accumulates in float32; "kahan" and "dd"
    accumulate in float64 and round to float32, the sum those modes chase.
    Markers are ``index_add_`` of 0/1 masks."""
    k, n = data.shape
    acc = torch.float32 if accum == "plain" else torch.float64
    idx = torch.where((codes >= 0) & (codes < size), codes, size).to(torch.int64)
    isnan, ispos, isneg = torch.isnan(data), torch.isposinf(data), torch.isneginf(data)
    zeroed = torch.where(isnan | ispos | isneg, 0.0, data)

    def seg(x, dtype):
        out = torch.zeros((k, size + 1), dtype=dtype, device=data.device)
        return out.index_add_(1, idx, x.to(dtype))[:, :size].T.contiguous()

    sums = seg(zeroed, acc).to(torch.float32)
    return sums, seg(isnan, torch.float32), seg(ispos, torch.float32), seg(isneg, torch.float32)


# ---------------------------------------------------------------------------
# B5: segment-sum with non-finite markers past 512 groups (radix binning)
# ---------------------------------------------------------------------------


def segment_sum_radixbin_raw(data: torch.Tensor, codes: torch.Tensor, size: int,
                             accum: str | None = None):
    """:func:`segment_sum_raw` for any number of groups: the four (size, K)
    float32 tensors ``(sums, nan_c, pos_c, neg_c)`` of ``data`` (K, N) by
    ``codes`` (N,).

    Codes outside [0, size) drop out; ``accum`` as for
    :func:`segment_sum_raw`. On the card the codes are binned first
    (:func:`_radixbin_bins`) and the kernel walks each group's columns in
    column order, one thread per row: per (group, row) the sum is sequential
    over the group's columns under ``accum``, so it does not depend on where
    other groups' columns lie, unsorted codes give the bits of the same data
    with its columns gathered into code order, and reruns are bit-identical.
    """
    accum = OPTIONS["pallas_accum"] if accum is None else accum
    if accum not in VALID_ACCUMS:
        raise ValueError(f"accum must be one of {VALID_ACCUMS}; got {accum!r}")
    _check_args(data, codes, size, _SUM_DTYPES, "segment_sum_radixbin",
                max_groups=_RADIXBIN_MAX_GROUPS, max_cols=_MAX_BINNED_COLS)
    if data.device.type == "cpu":
        return segment_sum_radixbin_plain(data, codes, size, accum)
    return _segment_sum_radixbin_cuda(data, codes, int(size), accum)


def segment_sum_radixbin(data, codes, size: int, accum: str | None = None, *,
                         skipna: bool = False):
    """:func:`segment_sum_radixbin_raw` with IEEE non-finite propagation
    re-applied (parity: ``segment_sum_radixbin_pallas``): a (size, K) float32
    tensor."""
    from .utils import reapply_nonfinite

    return reapply_nonfinite(*segment_sum_radixbin_raw(data, codes, size, accum), skipna=skipna)


def _radixbin_bins(codes: torch.Tensor, size: int):
    """The view of ``codes`` (N,) that the segment-sum, multi-statistic and
    radix-binning kernels take: ``(perm, sorted_codes, offsets)``, all int32
    on the codes' device.

    ``perm`` orders the columns stably by code, with the codes outside [0,
    size) mapped to ``size`` and so last; ``sorted_codes`` holds those mapped
    codes in that order; ``offsets`` (size + 1,) is where each group starts,
    so group g owns columns ``perm[offsets[g]:offsets[g + 1]]`` in their
    original order and ``offsets[size]`` counts the valid codes. Device ops
    over the N codes only, with no host sync; for sorted codes ``perm`` is the
    identity.
    """
    key = torch.where((codes >= 0) & (codes < size), codes, size).to(torch.int32)
    sorted_codes, perm = torch.sort(key, stable=True)
    starts = torch.arange(size + 1, dtype=torch.int32, device=codes.device)
    offsets = torch.searchsorted(sorted_codes, starts, out_int32=True)
    return perm.to(torch.int32), sorted_codes, offsets


def _segment_sum_radixbin_cuda(data, codes, size: int, accum: str):
    _require_cuda("segment_sum_radixbin")
    lib = _lib("segment_radixbin", [_P, _I, _P, _P, _P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P])
    k, n = data.shape
    outs = [torch.empty((size, k), dtype=torch.float32, device=data.device) for _ in range(4)]
    if k == 0:
        return tuple(outs)
    data = data.contiguous()  # one copy for a non-contiguous input, as above
    perm, sorted_codes, offsets = _radixbin_bins(codes, size)
    err = lib.flox_segment_radixbin(
        data.data_ptr(), _SUM_DTYPES[data.dtype], perm.data_ptr(), sorted_codes.data_ptr(),
        offsets.data_ptr(), k, n, size, _ACCUM_CODES[accum], *(o.data_ptr() for o in outs),
        _stream(data.device),
    )
    _build.check(lib, err, "segment_sum_radixbin launch")
    LAUNCHES["segment_sum_radixbin"] += 1
    return tuple(outs)


def segment_sum_radixbin_plain(data: torch.Tensor, codes: torch.Tensor, size: int, accum: str):
    """Plain PyTorch version of :func:`segment_sum_radixbin_raw`: the same
    function as :func:`segment_sum_raw_plain`, whose ``index_add_`` takes any
    number of groups."""
    return segment_sum_raw_plain(data, codes, size, accum)


# ---------------------------------------------------------------------------
# B3: segment-min/max
# ---------------------------------------------------------------------------


def segment_minmax(data: torch.Tensor, codes: torch.Tensor, size: int, op: str):
    """Per-group min or max (``op``) of ``data`` (K, N) by ``codes`` (N,): a
    (size, K) tensor in the data dtype (float32, bfloat16 or int32).

    Codes outside [0, size) drop out; an empty group comes out at the op's
    identity. A NaN propagates to its group's result. On the card the codes
    are binned first (:func:`_radixbin_bins`) and the kernel folds each
    group's columns in column order, one thread per row, as the segment-sum
    kernel walks them.
    """
    if op not in _OP_CODES:
        raise ValueError(f"op must be 'min' or 'max'; got {op!r}")
    _check_args(data, codes, size, _MINMAX_DTYPES, "segment_minmax", max_cols=_MAX_BINNED_COLS)
    if data.device.type == "cpu":
        return segment_minmax_plain(data, codes, size, op)
    return _segment_reduce_cuda("segment_minmax", data, codes, int(size), op)[0]


def segment_minmax_plain(data: torch.Tensor, codes: torch.Tensor, size: int, op: str):
    """Plain PyTorch version of :func:`segment_minmax`: ``scatter_reduce``
    (amax/amin, ``include_self=True``) into an identity-filled output."""
    k, n = data.shape
    idx = torch.where((codes >= 0) & (codes < size), codes, size).to(torch.int64)
    out = torch.full((k, size + 1), minmax_identity(op, data.dtype), dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(1, idx.expand(k, n), data, reduce="a" + op, include_self=True)
    return out[:, :size].T.contiguous()


# ---------------------------------------------------------------------------
# B2: sums, markers, min and max from one read
# ---------------------------------------------------------------------------


def segment_multistat(data: torch.Tensor, codes: torch.Tensor, size: int,
                      accum: str | None = None):
    """One pass over ``data`` (K, N) by ``codes`` (N,): the four outputs of
    :func:`segment_sum_raw` plus the NaN-skipping per-group min and max,
    ``(sums, nan_c, pos_c, neg_c, mins, maxs)``, each (size, K).

    Sums and markers are float32 and, on the card, bit-identical to
    :func:`segment_sum_raw` for the same input and ``accum``. Mins and maxs are
    in the data dtype (float32 or bfloat16); an empty group, or one whose
    values are all NaN, holds the op's identity (+inf for min, -inf for max).
    """
    accum = OPTIONS["pallas_accum"] if accum is None else accum
    if accum not in VALID_ACCUMS:
        raise ValueError(f"accum must be one of {VALID_ACCUMS}; got {accum!r}")
    _check_args(data, codes, size, _SUM_DTYPES, "segment_multistat", max_cols=_MAX_BINNED_COLS)
    if data.device.type == "cpu":
        return segment_multistat_plain(data, codes, size, accum)
    return _segment_reduce_cuda("segment_multistat", data, codes, int(size), accum)


def segment_multistat_plain(data: torch.Tensor, codes: torch.Tensor, size: int, accum: str):
    """Plain PyTorch version of :func:`segment_multistat`:
    :func:`segment_sum_raw_plain` plus ``scatter_reduce`` amin/amax over the
    data with NaN parked at each op's identity."""
    sums = segment_sum_raw_plain(data, codes, size, accum)
    isnan = torch.isnan(data)
    mins = segment_minmax_plain(torch.where(isnan, float("inf"), data), codes, size, "min")
    maxs = segment_minmax_plain(torch.where(isnan, float("-inf"), data), codes, size, "max")
    return (*sums, mins, maxs)


# ---------------------------------------------------------------------------
# B4: grouped cumsum / nancumsum
# ---------------------------------------------------------------------------


def segment_cumsum(data: torch.Tensor, codes: torch.Tensor, size: int, skipna: bool):
    """Grouped inclusive cumsum (``skipna=False``) or nancumsum of ``data``
    (K, N) along N by ``codes`` (N,): a (K, N) tensor in the data dtype
    (float32 or bfloat16; the running sums are float32).

    Codes outside [0, size) are missing labels; they scan among themselves as
    one extra group. IEEE prefix semantics per group: NaN beats inf, +inf with
    -inf is NaN, nancumsum skips only NaN, and an overflowing running sum
    turns into +-inf and stays so. On the card the kernel walks each row's
    columns in their order, one thread per row: per (group, row) the running
    sum is sequential in float32, so reruns are bit-identical.
    """
    _check_args(data, codes, size, _SUM_DTYPES, "segment_cumsum")
    if int(size) + 1 > _MAX_GROUPS:
        raise ValueError(
            f"segment_cumsum: size + 1 must be at most {_MAX_GROUPS}; got size={size}"
        )
    if data.device.type == "cpu":
        return segment_cumsum_plain(data, codes, size, skipna)
    return _segment_cumsum_cuda(data, codes, int(size), bool(skipna))


def _cumsum_state(size: int, k: int, device) -> torch.Tensor:
    """B4's scratch: per (group, row) the float32 running sum and the marker
    bits between the group's runs, the missing-label group included, as
    (size + 1, K, 2) int32 words; the kernel zeroes it."""
    return torch.empty((size + 1, k, 2), dtype=torch.int32, device=device)


def _segment_cumsum_cuda(data, codes, size: int, skipna: bool):
    _require_cuda("segment_cumsum")
    k, n = data.shape
    data = data.contiguous()  # one copy for a non-contiguous input, as above
    out = torch.empty_like(data)
    if k == 0 or n == 0:
        return out  # nothing to scan, so no launch
    lib = _lib("segment_cumsum", [_P, _I, _P, _LL, _LL, _I, _I, _P, _P, _P])
    codes = _codes_int32(codes, size)
    state = _cumsum_state(size, k, data.device)
    err = lib.flox_segment_cumsum(
        data.data_ptr(), _SUM_DTYPES[data.dtype], codes.data_ptr(), k, n, size, int(skipna),
        state.data_ptr(), out.data_ptr(), _stream(data.device),
    )
    _build.check(lib, err, "segment_cumsum launch")
    LAUNCHES["segment_cumsum"] += 1
    return out


def segment_cumsum_plain(data: torch.Tensor, codes: torch.Tensor, size: int, skipna: bool):
    """Plain PyTorch version of :func:`segment_cumsum`, one group at a time.

    Each group's columns are gathered and scanned with a float64
    ``torch.cumsum`` of the zero-filled finite values, rounded once to
    float32: the sequential sum, rounded at each step no worse than float32
    would be. The IEEE rules are then applied from running flags: the NaN,
    +inf and -inf seen so far in the group, and the first float32 overflow of
    the running sum while no flag was set, whose sign then sticks.
    """
    k, n = data.shape
    idx = torch.where((codes >= 0) & (codes < size), codes, size).to(torch.int64)
    x = data.to(torch.float32)
    out = torch.empty((k, n), dtype=torch.float32, device=data.device)
    nan = float("nan")
    for g in range(size + 1):
        cols = torch.nonzero(idx == g).squeeze(1)
        if cols.numel() == 0:
            continue
        xg = x.index_select(1, cols)
        isnan, ispos, isneg = torch.isnan(xg), torch.isposinf(xg), torch.isneginf(xg)
        z = torch.where(isnan | ispos | isneg, 0.0, xg)
        run = torch.cumsum(z.to(torch.float64), dim=1).to(torch.float32)

        def seen(flag):
            return torch.cummax(flag.to(torch.int8), dim=1).values > 0

        seen_n = seen(isnan) if not skipna else torch.zeros_like(isnan)
        seen_p, seen_m = seen(ispos), seen(isneg)
        # the first overflow of a group with no flag yet: its sign sticks
        ovf = ~(seen_n | seen_p | seen_m) & torch.isinf(run)
        after = seen(ovf)
        first = torch.argmax(ovf.to(torch.int8), dim=1, keepdim=True)
        positive = torch.gather(run, 1, first) > 0
        seen_p = seen_p | (after & positive)
        seen_m = seen_m | (after & ~positive)
        res = torch.where(seen_p, float("inf"), run)
        res = torch.where(seen_m, float("-inf"), res)
        res = torch.where(seen_n | (seen_p & seen_m), nan, res)
        out[:, cols] = res
    return out.to(data.dtype)
