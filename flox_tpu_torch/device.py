"""Device-resident groupby: labels already on the card, codes computed there
(counterpart of ``flox_tpu/device.py``).

``groupby_reduce`` factorizes labels on the host. When the groups are known
(``expected_values`` or ``bins``), nothing needs the host:
:func:`codes_device` computes the codes with ``torch.searchsorted`` on the
labels' device, and :func:`groupby_reduce_device` hands them straight to the
torch engine's kernels (``kernels.generic_kernel``), with no host copy of the
labels or the data.

:func:`memory_stats` reads the CUDA caching allocator, and :func:`reinitialize`
drops the package's host caches; torch has no backend teardown.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from . import dtypes, factorize as fct, kernels, utils
from .aggregations import _initialize_aggregation

__all__ = ["codes_device", "groupby_reduce_device", "memory_stats", "reinitialize"]


def reinitialize() -> bool:
    """Drop this package's caches (the factorization memo and the sort
    engine's present-groups memo), the recovery step after a device fault;
    on a CUDA device, also wait for the card (``torch.cuda.synchronize``)
    and return the caching allocator's free blocks
    (``torch.cuda.empty_cache``).

    Returns ``False``: torch has no backend teardown to run, so this is the
    cache-drop half of the reference's recovery. A sticky CUDA error (a
    context the card poisoned) is not swallowed: ``synchronize`` raises it,
    and a replica that cannot recover stays unready.
    """
    fct.clear_caches()
    kernels._PRESENT_CACHE.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return False


def memory_stats(devices: Sequence | None = None) -> dict[str, int] | None:
    """Allocator statistics summed over the CUDA devices.

    Returns ``{"bytes_in_use", "peak_bytes_in_use", "devices",
    "bytes_limit"}`` (``torch.cuda.memory_stats`` current and peak allocated
    bytes, and each device's total memory), or ``None`` where no CUDA device
    is present.
    """
    if not torch.cuda.is_available():
        return None
    devs = range(torch.cuda.device_count()) if devices is None else devices
    in_use = peak = limit = count = 0
    for dev in devs:
        stats = torch.cuda.memory_stats(dev)
        in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak += int(stats.get("allocated_bytes.all.peak", 0))
        limit += int(torch.cuda.get_device_properties(dev).total_memory)
        count += 1
    if not count:
        return None
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak, "devices": count,
            "bytes_limit": limit}


def codes_device(
    by: Any,
    expected_values: Sequence | None = None,
    *,
    bins: Sequence | None = None,
    closed: str = "right",
    device: Any = None,
) -> torch.Tensor:
    """Label -> dense code computation on the device (``cuda`` unless the
    caller names another).

    Exactly one of ``expected_values`` (sorted unique labels) or ``bins``
    (interval edges) must be given. Returns int32 codes, -1 = missing.
    """
    if (expected_values is None) == (bins is None):
        raise ValueError("Pass exactly one of expected_values or bins")
    if bins is not None:
        return fct.bin_device(by, bins, closed=closed, device=device)
    return fct.factorize_device(by, expected_values, device=device)


def groupby_reduce_device(
    array: Any,
    *by: Any,
    func: str,
    expected_values: Sequence | None = None,
    bins: Sequence | None = None,
    fill_value: Any = None,
    dtype: Any = None,
    finalize_kwargs: dict | None = None,
    device: Any = None,
) -> torch.Tensor:
    """Grouped reduction with every step on the device.

    ``by`` entries are labels (tensors on the card, typically) whose
    flattened elements align with the trailing dims of ``array``;
    ``expected_values`` / ``bins`` give the group space (one entry per ``by``;
    a bare array is accepted for one grouper). Reduces over all ``by`` dims.
    Returns the dense result (..., *group_sizes) on ``device`` (``cuda``
    unless the caller names another); no groups tuple, since they are the
    expected values the caller already has.

    Against ``groupby_reduce``: no discovery of unknown labels, no reduction
    over part of the labels' axes, no datetime round trips; those need the
    host.
    """
    nby = len(by)
    if nby == 0:
        raise TypeError("Must pass at least one `by`")
    dev = utils.resolve_device(device)

    def _norm(spec):
        if spec is None:
            return (None,) * nby
        if nby == 1:
            # a bare array or a plain list of group values is one spec; only
            # a 1-tuple is the explicit per-grouper form
            if isinstance(spec, tuple) and len(spec) == 1:
                return spec
            return (spec,)
        if not isinstance(spec, (tuple, list)) or len(spec) != nby:
            raise ValueError(
                f"With {nby} groupers, pass a tuple of {nby} expected_values/bins entries"
            )
        return tuple(spec)

    codes_list = []
    sizes = []
    for b, exp, edges in zip(by, _norm(expected_values), _norm(bins)):
        flat = utils.as_tensor(b, dev).reshape(-1)
        if edges is not None:
            codes_list.append(fct.bin_device(flat, edges, device=dev))
            sizes.append(len(edges) - 1)
        elif exp is not None:
            codes_list.append(fct.factorize_device(flat, exp, device=dev))
            sizes.append(len(exp))
        else:
            raise ValueError("groupby_reduce_device needs expected_values or bins per `by`")

    # ravel the codes of several groupers on the device; any -1 gives -1
    codes = codes_list[0]
    size = sizes[0]
    for c, s in zip(codes_list[1:], sizes[1:]):
        codes = torch.where((codes < 0) | (c < 0), -1, codes * s + c)
        size *= s

    arr = utils.as_tensor(array, dev)
    n = codes.shape[0]
    lead = tuple(arr.shape[: arr.ndim - _span_ndim(tuple(arr.shape), n)])
    arr_flat = arr.reshape(lead + (n,))

    agg = _initialize_aggregation(func, dtype, arr.dtype, fill_value, 0, finalize_kwargs)
    kernel_dtype = None
    if agg.name in ("sum", "nansum", "prod", "nanprod", "mean", "nanmean",
                    "var", "nanvar", "std", "nanstd") or dtype is not None:
        kernel_dtype = agg.final_dtype
    fv = agg.final_fill_value
    result = kernels.generic_kernel(
        agg.numpy[0] if isinstance(agg.numpy[0], str) else func,
        codes,
        arr_flat,
        size=size,
        fill_value=None if fv is dtypes.NA or fv is dtypes.INF or fv is dtypes.NINF else fv,
        dtype=kernel_dtype,
        **dict(agg.finalize_kwargs),
    )
    if kernel_dtype is not None and result.dtype != kernel_dtype:
        result = result.to(kernel_dtype)
    return result.reshape(agg.new_dims() + lead + tuple(sizes))


def _span_ndim(shape: tuple[int, ...], n: int) -> int:
    """How many trailing dims of ``shape`` flatten to ``n`` elements."""
    prod = 1
    for i, s in enumerate(reversed(shape), start=1):
        prod *= s
        if prod == n:
            return i
    raise ValueError(f"`by` length {n} does not match trailing dims of array shape {shape}")
