"""Dtype promotion and fill-value resolution (L0).

A copy of ``flox_tpu/dtypes.py``, which is numpy-only: the port keeps its own
copy so that it never imports the JAX package. The semantics are flox's
(``xrdtypes.py`` upstream): sentinel fill-value placeholders resolved per
dtype, NA-driven promotion, datetime handling. Fill values resolve to concrete
numpy scalars before they reach a tensor.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np

__all__ = [
    "INF",
    "NINF",
    "NA",
    "get_fill_value",
    "get_pos_infinity",
    "get_neg_infinity",
    "maybe_promote",
    "is_datetime_like",
    "dtype_to_view",
    "normalize_dtype",
]


class _Sentinel:
    """Placeholder fill value resolved against a concrete dtype later.

    Mirrors the role of the reference's AlwaysGreaterThan/AlwaysLessThan/NA
    trio (xrdtypes.py:9-32) without the rich-comparison machinery: on TPU the
    sentinel never reaches a kernel — it is resolved to a scalar before trace.
    """

    __slots__ = ("_name",)

    def __init__(self, name: str) -> None:
        self._name = name

    def __repr__(self) -> str:
        return f"<{self._name}>"

    # Sentinels are singletons compared by identity; they must survive the
    # deepcopy that _initialize_aggregation applies to registry templates.
    def __copy__(self) -> "_Sentinel":
        return self

    def __deepcopy__(self, memo) -> "_Sentinel":
        return self


#: Resolves to the greatest representable value of the target dtype.
INF = _Sentinel("INF")
#: Resolves to the least representable value of the target dtype.
NINF = _Sentinel("NINF")
#: Resolves to the missing-value marker of the target dtype (NaN/NaT/...).
NA = _Sentinel("NA")


def is_datetime_like(dtype: np.dtype) -> bool:
    return np.issubdtype(dtype, np.datetime64) or np.issubdtype(dtype, np.timedelta64)


def dtype_to_view(dtype: np.dtype) -> np.dtype:
    """Device-representable view dtype: datetimes become int64 on device."""
    dtype = np.dtype(dtype)
    if is_datetime_like(dtype):
        return np.dtype("int64")
    return dtype


def get_pos_infinity(dtype: np.dtype, max_for_int: bool = False) -> Any:
    """Largest value usable as a '+inf' fill for ``dtype``.

    Parity: xrdtypes.get_pos_infinity (xrdtypes.py:97-124). For integers the
    caller chooses between true inf (promoting) and ``iinfo.max``
    (dtype-preserving, what segment_min identity needs on device).
    """
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return dtype.type(np.inf)
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).max if max_for_int else np.inf
    if np.issubdtype(dtype, np.complexfloating):
        return dtype.type(np.inf + 0j)
    if is_datetime_like(dtype):
        return np.iinfo(np.int64).max
    if dtype.kind == "b":
        return True
    return np.inf


def get_neg_infinity(dtype: np.dtype, min_for_int: bool = False) -> Any:
    """Mirror of :func:`get_pos_infinity` (xrdtypes.py:127-154)."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return dtype.type(-np.inf)
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).min if min_for_int else -np.inf
    if np.issubdtype(dtype, np.complexfloating):
        return dtype.type(-np.inf + 0j)
    if is_datetime_like(dtype):
        return np.iinfo(np.int64).min
    if dtype.kind == "b":
        return False
    return -np.inf


def maybe_promote(dtype: np.dtype) -> tuple[np.dtype, Any]:
    """Promote ``dtype`` so it can hold a missing value; return (dtype, NA).

    Parity: xrdtypes.maybe_promote (xrdtypes.py:35-77). Integers promote to
    float64 (float32 stays float32), datetimes use NaT, bools promote to
    object in xarray but here to float64 — object dtype cannot exist on
    device.
    """
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return dtype, dtype.type(np.nan)
    if np.issubdtype(dtype, np.complexfloating):
        return dtype, dtype.type(np.nan + np.nan * 1j)
    if np.issubdtype(dtype, np.integer):
        promoted = np.dtype("float32") if dtype.itemsize <= 2 else np.dtype("float64")
        return promoted, promoted.type(np.nan)
    if np.issubdtype(dtype, np.datetime64):
        return dtype, np.datetime64("NaT")
    if np.issubdtype(dtype, np.timedelta64):
        return dtype, np.timedelta64("NaT")
    if dtype.kind == "b":
        return np.dtype("float64"), np.nan
    return np.dtype("object"), np.nan


def get_fill_value(dtype: np.dtype, fill_value: Any) -> Any:
    """Resolve a sentinel (or passthrough) fill value against ``dtype``.

    Parity: xrdtypes._get_fill_value (xrdtypes.py:188-209).
    """
    if fill_value is INF or (fill_value is None and np.dtype(dtype).kind not in "fcmM"):
        return get_pos_infinity(dtype, max_for_int=True)
    if fill_value is NINF:
        return get_neg_infinity(dtype, min_for_int=True)
    if fill_value is NA or fill_value is None:
        dtype = np.dtype(dtype)
        if np.issubdtype(dtype, np.floating) or np.issubdtype(dtype, np.complexfloating):
            return dtype.type(np.nan)
        if np.issubdtype(dtype, np.datetime64):
            return np.datetime64("NaT")
        if np.issubdtype(dtype, np.timedelta64):
            return np.timedelta64("NaT")
        # Caller should have promoted already; be safe for ints/bool.
        return np.nan
    return fill_value


@functools.lru_cache(maxsize=None)
def _result_type_cached(*dtypes: np.dtype) -> np.dtype:
    return np.result_type(*dtypes)


def normalize_dtype(
    dtype: Any,
    array_dtype: np.dtype,
    preserves_dtype: bool = False,
    fill_value: Any = None,
) -> np.dtype:
    """Decide the output dtype of an aggregation.

    Parity: xrdtypes._normalize_dtype (xrdtypes.py:153-172): explicit request
    wins; dtype-preserving aggs keep the input dtype; sum-like aggs promote
    small ints per numpy rules; an NaN-ish fill value forces a float-capable
    dtype.
    """
    array_dtype = np.dtype(array_dtype)
    if dtype is None:
        if preserves_dtype:
            dtype = array_dtype
        elif array_dtype.kind in "iub":
            # numpy promotes small ints to the default int for sums.
            dtype = _result_type_cached(array_dtype, np.dtype(np.int_))
        else:
            dtype = array_dtype
    dtype = np.dtype(dtype)
    if fill_value not in (None, INF, NINF, NA) and np.issubdtype(type(fill_value), np.floating):
        if not (
            np.issubdtype(dtype, np.floating) or np.issubdtype(dtype, np.complexfloating)
        ) and np.isnan(fill_value):
            dtype = np.result_type(dtype, np.float64)
    return dtype
