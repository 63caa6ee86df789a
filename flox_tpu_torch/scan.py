"""Grouped scans: ``groupby_scan`` on one device (the eager path of
``flox_tpu/scan.py``).

Supported scans: ``cumsum``, ``nancumsum``, ``ffill``, ``bfill``. The scan
axis is moved last and the labels are factorized on the host; labels that
span more dims than the scan axis get disjoint code ranges per row
(``factorize.offset_labels``), so one flat scan over (..., N) never crosses
rows. float32/bfloat16 cumsums over few groups run the segmented-cumsum
kernel (``cuda_kernels.segment_cumsum``); the rest run the sort plus log-depth
segmented scan of torch ops (``kernels._segmented_scan``). Positions with a
missing label come out NaN.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import factorize as fct, utils
from .aggregations import Scan, _initialize_scan, generic_aggregate
from .core import _choose_engine, _convert_expected, _normalize_expected, _normalize_isbin

__all__ = ["groupby_scan"]


def groupby_scan(
    array: Any,
    *by: Any,
    func: str | Scan,
    expected_groups: Any = None,
    axis: int = -1,
    dtype: Any = None,
    method: str | None = None,
    engine: str | None = None,
    mesh: Any = None,
    device: Any = None,
) -> torch.Tensor:
    """Grouped scan along ``axis`` (the signature of ``flox_tpu.groupby_scan``,
    plus ``device``): a tensor of ``array``'s shape on ``device``.

    Integer data is promoted to int64 for cumsum/nancumsum. ``device``
    defaults to ``cuda`` and raises ``RuntimeError`` when CUDA is missing;
    pass ``device="cpu"`` to run on the CPU.

    Examples
    --------
    >>> import numpy as np
    >>> from flox_tpu_torch import groupby_scan
    >>> groupby_scan(np.array([1.0, 2.0, 4.0, 8.0]), np.array([0, 1, 0, 1]),
    ...              func="cumsum", device="cpu")
    tensor([ 1.,  2.,  5., 10.], dtype=torch.float64)
    >>> groupby_scan(np.array([1.0, np.nan, np.nan, 8.0]), np.array([0, 1, 0, 1]),
    ...              func="ffill", device="cpu")
    tensor([1., nan, 1., 8.], dtype=torch.float64)
    """
    return _groupby_scan_impl(
        array, *by, func=func, expected_groups=expected_groups, axis=axis, dtype=dtype,
        method=method, engine=engine, mesh=mesh, device=device,
    )


def _groupby_scan_impl(array, *by, func, expected_groups, axis, dtype, method, engine, mesh,
                       device) -> torch.Tensor:
    if not by:
        raise TypeError("Must pass at least one `by`")
    if np.ndim(axis) != 0:
        raise ValueError("groupby_scan supports a single axis only (like the reference).")
    if method not in (None, "blelloch", "blockwise"):
        raise ValueError(f"scan method must be None, 'blelloch' or 'blockwise'; got {method!r}")
    if method is not None or mesh is not None:
        raise NotImplementedError(
            "method=/mesh= (the multi-device scan) is not ported yet; ROADMAP A7"
        )
    if any(type(b).__name__ == "Prefactorized" for b in by):
        raise NotImplementedError("Prefactorized labels are not ported yet; ROADMAP A6")
    engine = _choose_engine(engine)
    dev = utils.resolve_device(device)

    nby = len(by)
    bys = [utils.asarray_host(b) for b in by]
    bys = list(np.broadcast_arrays(*bys)) if nby > 1 else bys
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
        if array.dtype.kind in "mM":
            raise NotImplementedError(
                "datetime/timedelta scans (the NaT channel) are not ported yet; ROADMAP A2"
            )
        if array.dtype.kind in "OSU":
            raise NotImplementedError(f"scans of {array.dtype} data are not supported")
    arr = utils.as_tensor(array, dev)

    bndim = bys[0].ndim
    if tuple(arr.shape[-bndim:]) != bys[0].shape:
        raise ValueError(
            f"`by` has shape {bys[0].shape} which does not align with the trailing "
            f"dimensions of `array` with shape {tuple(arr.shape)}."
        )
    axis_n = axis % arr.ndim
    first_by_ax = arr.ndim - bndim
    if axis_n < first_by_ax:
        raise ValueError("Scan axis must be covered by the `by` labels.")
    rel_axis = axis_n - first_by_ax

    expected = _normalize_expected(expected_groups, nby)
    expected_idx = _convert_expected(expected, _normalize_isbin(False, nby), True)

    # move the scan axis to the end of both the array and the labels
    arr_order = None
    if rel_axis != bndim - 1:
        by_order = [d for d in range(bndim) if d != rel_axis] + [rel_axis]
        bys = [b.transpose(by_order) for b in bys]
        arr_order = list(range(first_by_ax)) + [first_by_ax + d for d in by_order]
        arr = arr.permute(arr_order)

    # factorize_ offsets the codes per row when bndim > 1 (disjoint ranges)
    codes, _found, _grp_shape, _ngroups, size, _props = fct.factorize_(
        bys, axes=(bndim - 1,), expected_groups=expected_idx, sort=True
    )
    codes_flat = np.asarray(codes).reshape(-1)
    span = codes_flat.shape[0]
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (span,))

    scan = _initialize_scan(func)
    if scan.name in ("cumsum", "nancumsum") and dtype is None:
        np_dtype = utils.numpy_dtype(arr.dtype)
        if np_dtype.kind in "iub":  # numpy promotes small ints (and bools) to int_
            dtype = utils.torch_dtype(np.result_type(np_dtype, np.int_))

    out = _apply_scan(scan, arr_flat, torch.as_tensor(codes_flat, device=dev), size=size,
                      engine=engine, dtype=dtype)

    nanmask = codes_flat < 0
    if nanmask.any():  # missing labels belong to no group
        out = _mask_positions(out, torch.as_tensor(nanmask, device=dev))
    out = out.reshape(lead_shape + bys[0].shape)
    if arr_order is not None:
        out = out.permute(tuple(np.argsort(arr_order)))
    return out


def _apply_scan(scan: Scan, arr_flat, codes_flat, *, size, engine, dtype):
    return generic_aggregate(codes_flat, arr_flat, engine=engine, func=scan.scan, size=size,
                             dtype=dtype)


def _mask_positions(out: torch.Tensor, nanmask: torch.Tensor) -> torch.Tensor:
    if not out.is_floating_point():
        out = out.to(torch.float64)
    return torch.where(nanmask, float("nan"), out)
