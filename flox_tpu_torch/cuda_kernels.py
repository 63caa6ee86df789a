"""Hand-written CUDA kernels for the hot segment reductions, with their plain
PyTorch versions (the counterpart of ``flox_tpu/pallas_kernels.py``).

========================  ==========================================  =====================
kernel (source)           replaces (flox_tpu/pallas_kernels.py)       plain version
========================  ==========================================  =====================
``segment_sum_raw``       ``_kernel`` + ``_accum_update`` (B1),        ``segment_sum_raw_plain``
(csrc/segment_sum.cu)     via ``segment_sum_raw_pallas``
``segment_minmax``        ``_minmax_kernel`` (B3), via                 ``segment_minmax_plain``
(csrc/segment_minmax.cu)  ``segment_minmax_pallas``
========================  ==========================================  =====================

Both kernels take ``data`` as (K, N), N contiguous — the trailing-reduce
layout the caller already holds — and read it once, in place. Both are bound
by that read: K*N*itemsize bytes over the card's memory rate (3.35 TB/s on an
H100 SXM), 2.05 ms for the 65160 x 26304 float32 benchmark array (computed,
not measured). The design notes sit at the top of each source.

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
    "segment_minmax",
    "segment_minmax_plain",
    "segment_sum",
    "segment_sum_raw",
    "segment_sum_raw_plain",
]

#: kernel launches since the last reset, one per launch of each kernel
LAUNCHES = {"segment_sum": 0, "segment_minmax": 0}

_SUM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MINMAX_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_ACCUM_CODES = {"plain": 0, "kahan": 1, "dd": 2}
_MAX_GROUPS = 512  # the C entry points refuse more


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_args(data: torch.Tensor, codes: torch.Tensor, size: int, dtypes, what: str) -> None:
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
    if not 1 <= int(size) <= _MAX_GROUPS:
        raise ValueError(f"{what}: size must be in [1, {_MAX_GROUPS}]; got {size}")
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
