"""Host/device helpers and null handling of the port (counterpart of
``flox_tpu/utils.py``).

The split that matters here is *host arrays* (numpy: labels, group values,
metadata) against *device tensors* (torch, where the data is reduced). The
device is explicit: :func:`resolve_device` picks it, and nothing falls back to
the CPU unless the caller asked for the CPU.
"""

from __future__ import annotations

import importlib.util
from collections.abc import Iterable
from typing import Any

import numpy as np
import torch

from . import dtypes


#: whether real xarray is installed (the adapter then binds to it, else to
#: ``xrlite``); found without importing it
HAS_XARRAY = importlib.util.find_spec("xarray") is not None


def loaded_pandas():
    """The pandas module if this process has imported it, else None. A pandas
    object can only come from a process that did, so code that must handle
    one tests for it this way, without importing pandas itself."""
    import sys

    return sys.modules.get("pandas")


def resolve_device(device: Any = None) -> torch.device:
    """The device to reduce on: ``cuda`` unless the caller names another.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and this process has none: the port never runs quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flox_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or the CPU; got {dev}")
    return dev


def fmt_bytes(n: float) -> str:
    """Human size for guard messages: GiB above 1, MiB below."""
    return f"{n / 2**30:.1f} GiB" if n >= 2**30 else f"{n / 2**20:.1f} MiB"


def asarray_host(x: Any) -> np.ndarray:
    """Materialize on the host as numpy (labels, metadata)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(x: Any, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a numpy array is copied there, a
    tensor elsewhere is moved, a tensor already there is returned as is."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    arr = np.asarray(x)
    if any(s < 0 for s in arr.strides):
        arr = np.ascontiguousarray(arr)  # torch cannot view negative strides
    return torch.as_tensor(arr, device=device)


# numpy <-> torch dtypes. numpy has no bfloat16, so bf16 resolves its fill
# values and promotions through float32, which shares its kind and its
# special values; the bf16 result dtype is restored by the caller.
_NP_OF_TORCH = {
    torch.bool: np.dtype(np.bool_),
    torch.uint8: np.dtype(np.uint8),
    torch.uint16: np.dtype(np.uint16),
    torch.uint32: np.dtype(np.uint32),
    torch.uint64: np.dtype(np.uint64),
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.float16: np.dtype(np.float16),
    torch.bfloat16: np.dtype(np.float32),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.complex64: np.dtype(np.complex64),
    torch.complex128: np.dtype(np.complex128),
}
_TORCH_OF_NP = {v: k for k, v in _NP_OF_TORCH.items() if k is not torch.bfloat16}


def numpy_dtype(dtype: Any) -> np.dtype:
    """numpy dtype of a torch or numpy dtype (bfloat16 -> float32 proxy)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _NP_OF_TORCH[dtype]
        except KeyError:
            raise TypeError(f"unsupported dtype {dtype}") from None
    return np.dtype(dtype)


def torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype of a torch or numpy dtype-like."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TORCH_OF_NP[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def _is_null_object(v) -> bool:
    """``pd.isna`` of one object element, without pandas: None, float and
    complex NaN, NaT, and pandas' own NaT and NA."""
    if v is None:
        return True
    if isinstance(v, (float, complex, np.floating, np.complexfloating)):
        return bool(np.isnan(v))
    if isinstance(v, (np.datetime64, np.timedelta64)):
        return bool(np.isnat(v))
    return type(v).__name__ in ("NaTType", "NAType")


def isnull_host(data: np.ndarray) -> np.ndarray:
    """Missing-value mask of a host array: NaN for floats, NaT for datetimes,
    ``pd.isna``'s missing values for objects, never-null for everything else
    (parity: ``flox_tpu.utils.isnull``, without importing pandas)."""
    data = np.asarray(data)
    if data.dtype.kind in "fc":
        return np.isnan(data)
    if dtypes.is_datetime_like(data.dtype):
        return np.isnat(data)
    if data.dtype.kind == "O":
        return np.array([_is_null_object(v) for v in data.ravel()],
                        dtype=bool).reshape(data.shape)
    return np.zeros(data.shape, dtype=bool)


def normalize_axis_tuple(axis: int | Iterable[int], ndim: int) -> tuple[int, ...]:
    if np.isscalar(axis):
        axis = (int(axis),)  # type: ignore[arg-type]
    return tuple(sorted(ax % ndim for ax in axis))  # type: ignore[union-attr]


def reapply_nonfinite(sums, nan_c, pos_c, neg_c, *, skipna: bool = False):
    """Re-apply IEEE non-finite propagation to segment sums taken over
    zero-filled data, from the NaN/+inf/-inf marker counts (parity:
    ``flox_tpu.utils.reapply_nonfinite``).

    ``skipna=True`` treats NaN as absent: zeroed NaNs simply do not
    contribute, and only the ±inf rules apply.
    """
    poison = (pos_c > 0) & (neg_c > 0)
    if not skipna:
        poison = poison | (nan_c > 0)
    out = torch.where(pos_c > 0, torch.full_like(sums, float("inf")), sums)
    out = torch.where(neg_c > 0, torch.full_like(sums, float("-inf")), out)
    return torch.where(poison, torch.full_like(sums, float("nan")), out)


def is_nan_fill(v) -> bool:
    """True only for genuine float/complex NaN fills. NaT answers True to
    ``np.isnan`` but must not trigger float promotion."""
    if isinstance(v, (np.datetime64, np.timedelta64)):
        return False
    try:
        return bool(np.isnan(v))
    except (TypeError, ValueError):
        return False
