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
sum, multi-statistic and radix-binning kernels share theirs
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
_MAX_GROUPS = 512  # the C entry points of B1-B4 refuse more
_RADIXBIN_MAX_GROUPS = 512 * 65535  # B5's grid holds no more 512-group blocks


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_args(data: torch.Tensor, codes: torch.Tensor, size: int, dtypes, what: str,
                max_groups: int = _MAX_GROUPS) -> None:
    if data.dim() != 2:
        raise ValueError(f"{what}: data must be (K, N); got shape {tuple(data.shape)}")
    if codes.dim() != 1 or codes.shape[0] != data.shape[1]:
        raise ValueError(
            f"{what}: codes must be (N,) = ({data.shape[1]},); got {tuple(codes.shape)}"
        )
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
    bfloat16 data; sums accumulate in float32 either way.
    """
    accum = OPTIONS["pallas_accum"] if accum is None else accum
    if accum not in VALID_ACCUMS:
        raise ValueError(f"accum must be one of {VALID_ACCUMS}; got {accum!r}")
    _check_args(data, codes, size, _SUM_DTYPES, "segment_sum")
    if data.device.type == "cpu":
        return segment_sum_raw_plain(data, codes, size, accum)
    return _segment_sum_cuda(data, codes, int(size), accum)


def segment_sum(data, codes, size: int, accum: str | None = None, *, skipna: bool = False):
    """:func:`segment_sum_raw` with IEEE non-finite propagation re-applied
    (parity: ``segment_sum_pallas``): a (size, K) float32 tensor."""
    from .utils import reapply_nonfinite

    return reapply_nonfinite(*segment_sum_raw(data, codes, size, accum), skipna=skipna)


def _segment_sum_cuda(data, codes, size: int, accum: str):
    _require_cuda("segment_sum")
    lib = _lib("segment_sum", [_P, _I, _P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P])
    k, n = data.shape
    outs = [torch.empty((size, k), dtype=torch.float32, device=data.device) for _ in range(4)]
    if k == 0:
        return tuple(outs)
    # the kernel streams (K, N) row-major: a non-contiguous input is copied
    # once here; a contiguous one (the usual case) is read in place
    data = data.contiguous()
    codes = _codes_int32(codes, size)
    err = lib.flox_segment_sum(
        data.data_ptr(), _SUM_DTYPES[data.dtype], codes.data_ptr(), k, n, size,
        _ACCUM_CODES[accum], *(o.data_ptr() for o in outs), _stream(data.device),
    )
    _build.check(lib, err, "segment_sum launch")
    LAUNCHES["segment_sum"] += 1
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
    ``codes`` (N,), with the group axis cut into 512-wide blocks on the card.

    Codes outside [0, size) drop out; ``accum`` as for
    :func:`segment_sum_raw`. On the card the outputs are bit-identical to
    :func:`segment_sum_raw`'s at size <= 512, and built for codes sorted along
    N: unsorted codes cost one read of the data per 512-group block.
    """
    accum = OPTIONS["pallas_accum"] if accum is None else accum
    if accum not in VALID_ACCUMS:
        raise ValueError(f"accum must be one of {VALID_ACCUMS}; got {accum!r}")
    _check_args(data, codes, size, _SUM_DTYPES, "segment_sum_radixbin",
                max_groups=_RADIXBIN_MAX_GROUPS)
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


def _segment_sum_radixbin_cuda(data, codes, size: int, accum: str):
    _require_cuda("segment_sum_radixbin")
    lib = _lib("segment_radixbin", [_P, _I, _P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P])
    k, n = data.shape
    outs = [torch.empty((size, k), dtype=torch.float32, device=data.device) for _ in range(4)]
    if k == 0:
        return tuple(outs)
    data = data.contiguous()  # one copy for a non-contiguous input, as above
    codes = _codes_int32(codes, size)
    err = lib.flox_segment_radixbin(
        data.data_ptr(), _SUM_DTYPES[data.dtype], codes.data_ptr(), k, n, size,
        _ACCUM_CODES[accum], *(o.data_ptr() for o in outs), _stream(data.device),
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
    identity. A NaN propagates to its group's result.
    """
    if op not in ("min", "max"):
        raise ValueError(f"op must be 'min' or 'max'; got {op!r}")
    _check_args(data, codes, size, _MINMAX_DTYPES, "segment_minmax")
    if data.device.type == "cpu":
        return segment_minmax_plain(data, codes, size, op)
    return _segment_minmax_cuda(data, codes, int(size), op)


def _segment_minmax_cuda(data, codes, size: int, op: str):
    _require_cuda("segment_minmax")
    lib = _lib("segment_minmax", [_P, _I, _P, _LL, _LL, _I, _I, _P, _P])
    k, n = data.shape
    out = torch.empty((size, k), dtype=data.dtype, device=data.device)
    if k == 0:
        return out
    data = data.contiguous()  # one copy for a non-contiguous input, as above
    codes = _codes_int32(codes, size)
    err = lib.flox_segment_minmax(
        data.data_ptr(), _MINMAX_DTYPES[data.dtype], codes.data_ptr(), k, n, size,
        int(op == "max"), out.data_ptr(), _stream(data.device),
    )
    _build.check(lib, err, "segment_minmax launch")
    LAUNCHES["segment_minmax"] += 1
    return out


def segment_minmax_plain(data: torch.Tensor, codes: torch.Tensor, size: int, op: str):
    """Plain PyTorch version of :func:`segment_minmax`: ``scatter_reduce``
    (amax/amin, ``include_self=True``) into an identity-filled output."""
    from .kernels import minmax_identity

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
    _check_args(data, codes, size, _SUM_DTYPES, "segment_multistat")
    if data.device.type == "cpu":
        return segment_multistat_plain(data, codes, size, accum)
    return _segment_multistat_cuda(data, codes, int(size), accum)


def _segment_multistat_cuda(data, codes, size: int, accum: str):
    _require_cuda("segment_multistat")
    lib = _lib("segment_multistat", [_P, _I, _P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P])
    k, n = data.shape
    outs = [torch.empty((size, k), dtype=torch.float32, device=data.device) for _ in range(4)]
    outs += [torch.empty((size, k), dtype=data.dtype, device=data.device) for _ in range(2)]
    if k == 0:
        return tuple(outs)
    data = data.contiguous()  # one copy for a non-contiguous input, as above
    codes = _codes_int32(codes, size)
    err = lib.flox_segment_multistat(
        data.data_ptr(), _SUM_DTYPES[data.dtype], codes.data_ptr(), k, n, size,
        _ACCUM_CODES[accum], *(o.data_ptr() for o in outs), _stream(data.device),
    )
    _build.check(lib, err, "segment_multistat launch")
    LAUNCHES["segment_multistat"] += 1
    return tuple(outs)


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
    turns into +-inf and stays so.
    """
    _check_args(data, codes, size, _SUM_DTYPES, "segment_cumsum")
    if int(size) + 1 > _MAX_GROUPS:
        raise ValueError(
            f"segment_cumsum: size + 1 must be at most {_MAX_GROUPS}; got size={size}"
        )
    if data.device.type == "cpu":
        return segment_cumsum_plain(data, codes, size, skipna)
    return _segment_cumsum_cuda(data, codes, int(size), bool(skipna))


def _segment_cumsum_cuda(data, codes, size: int, skipna: bool):
    _require_cuda("segment_cumsum")
    lib = _lib("segment_cumsum", [_P, _I, _P, _LL, _LL, _I, _I, _P, _P])
    k, n = data.shape
    data = data.contiguous()  # one copy for a non-contiguous input, as above
    out = torch.empty_like(data)
    if k == 0:
        return out
    codes = _codes_int32(codes, size)
    err = lib.flox_segment_cumsum(
        data.data_ptr(), _SUM_DTYPES[data.dtype], codes.data_ptr(), k, n, size, int(skipna),
        out.data_ptr(), _stream(data.device),
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
