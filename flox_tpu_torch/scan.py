"""Grouped scans: ``groupby_scan`` (the port of ``flox_tpu/scan.py``).

Supported scans: ``cumsum``, ``nancumsum``, ``ffill``, ``bfill``. The scan
axis is moved last and the labels are factorized on the host; labels that
span more dims than the scan axis get disjoint code ranges per row
(``factorize.offset_labels``), so one flat scan over (..., N) never crosses
rows. float32/bfloat16 cumsums over few groups run the segmented-cumsum
kernel (``cuda_kernels.segment_cumsum``); the rest run the sort plus log-depth
segmented scan of torch ops (``kernels._segmented_scan``). Positions with a
missing label come out NaN. Datetime64/timedelta64 data scans on its exact
int64 view with NaT as the missing marker and comes back as a numpy array of
its dtype (torch has none). ``engine="numpy"`` scans on the host engine and
copies the result to the device. ``method="blelloch"`` or ``mesh=`` runs the
scan over a mesh (``parallel.scan``): the Blelloch carry exchange, or, for
``method="blockwise"`` with a mesh, shard-local groups with no exchange;
``mesh=`` without ``method=`` takes blockwise when cohort detection finds
every group on one shard (and the scan covers every label dim), else
Blelloch. Telemetry sees the reference's spans: ``groupby_scan`` over
``factorize``, ``dispatch`` and ``finalize``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import dtypes, factorize as fct, telemetry, utils
from .aggregations import Scan, _initialize_scan, generic_aggregate
from .core import (_choose_engine, _convert_expected, _normalize_expected, _normalize_isbin,
                   _resolve_devices)
from .kernels import _NAT_INT

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
    pass ``device="cpu"`` to run on the CPU. With ``mesh=`` or
    ``method="blelloch"`` every rank passes the same global inputs and gets
    the whole result on its device (the mesh's "data" dim shards the axis).

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
    with telemetry.span(
        "groupby_scan", func=func if isinstance(func, str) else getattr(func, "name", "custom"),
        method=method,
    ):
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
    if method is None and mesh is not None and engine is not None:
        raise ValueError(
            "engine= selects a single-device kernel but mesh= requests distributed "
            "execution; pass method='blelloch' (engine is ignored on the mesh) or drop one "
            "of the two."
        )
    # a scan's output is shaped like its input: there is no (..., size)
    # accumulator for the sort engine to compact, so it scans as the dense
    # engine does; the numpy engine scans on the host
    engine = "numpy" if _choose_engine(engine) == "numpy" else "torch"
    # method='blockwise' without a mesh is the eager scan, as in the reference
    on_mesh = mesh is not None or method == "blelloch"
    mesh, dev, work = _resolve_devices(array, engine, "blelloch" if on_mesh else None, mesh,
                                       device)

    nby = len(by)
    bys = [utils.asarray_host(b) for b in by]
    bys = list(np.broadcast_arrays(*bys)) if nby > 1 else bys
    datetime_dtype = None
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
        if array.dtype.kind in "OSU":
            raise NotImplementedError(f"scans of {array.dtype} data are not supported")
        if dtypes.is_datetime_like(array.dtype):
            _check_datetime_scan(_initialize_scan(func), array.dtype, dtype)
            # the exact int64 view (float64 would lose nanoseconds)
            datetime_dtype, array = array.dtype, array.view("int64")
    arr = utils.as_tensor(array, work)

    # a Prefactorized `by` is a 0-d host object here, and fails this check as
    # it does in the reference
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
    with telemetry.span("factorize", nby=nby) as fsp:
        codes, _found, _grp_shape, ngroups, size, _props = fct.factorize_(
            bys, axes=(bndim - 1,), expected_groups=expected_idx, sort=True
        )
        fsp.set(ngroups=ngroups, size=size)
    codes_flat = np.asarray(codes).reshape(-1)
    span = codes_flat.shape[0]
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (span,))

    scan = _initialize_scan(func)
    if scan.name in ("cumsum", "nancumsum") and dtype is None and datetime_dtype is None:
        np_dtype = utils.numpy_dtype(arr.dtype)
        if np_dtype.kind in "iub":  # numpy promotes small ints (and bools) to int_
            dtype = utils.torch_dtype(np.result_type(np_dtype, np.int_))

    nat = datetime_dtype is not None
    if on_mesh:
        from .parallel.scan import sharded_groupby_scan

        if method is None:
            method = _auto_scan_method(codes_flat, size, mesh, bndim)
        with telemetry.span("dispatch", method=method, size=size):
            out = sharded_groupby_scan(arr_flat, codes_flat, scan, size=size, mesh=mesh,
                                       dtype=dtype, method=method, nat=nat)
        work = out.device
    else:
        with telemetry.span("dispatch", engine=engine, size=size):
            out = _apply_scan(scan, arr_flat, torch.as_tensor(codes_flat, device=work),
                              size=size, engine=engine, dtype=dtype, nat=nat)

    with telemetry.span("finalize"):
        nanmask = codes_flat < 0
        if nanmask.any():  # missing labels belong to no group
            out = _mask_positions(out, torch.as_tensor(nanmask, device=work), nat=nat)
        out = out.to(dev)  # the host engine's one copy to the device
        out = out.reshape(lead_shape + bys[0].shape)
        if arr_order is not None:
            out = out.permute(tuple(np.argsort(arr_order)))
        if nat:
            return out.cpu().numpy().view(datetime_dtype)
        return out


def _auto_scan_method(codes_flat: np.ndarray, size: int, mesh, bndim: int) -> str:
    """Blockwise when cohort detection on the global codes finds every group
    on one shard of the "data" dim and the scan covers every label dim, else
    Blelloch."""
    from .core import _auto_method

    preferred = _auto_method(codes_flat, size, mesh, "data")
    return "blockwise" if preferred == "blockwise" and bndim == 1 else "blelloch"


def _check_datetime_scan(scan: Scan, array_dtype: np.dtype, dtype) -> None:
    """The guards of a datetime64/timedelta64 scan."""
    if scan.name in ("cumsum", "nancumsum") and array_dtype.kind == "M":
        raise TypeError(
            "cumsum of datetime64 values is undefined (numpy cannot add points in "
            "time); cumsum timedelta64 works."
        )
    if dtype is not None:
        raise TypeError(
            "dtype= is not supported for datetime/timedelta scans; the scan runs on the "
            f"exact int64 view and returns {array_dtype} unchanged."
        )


def _apply_scan(scan: Scan, arr_flat, codes_flat, *, size, engine, dtype, nat=False):
    kwargs = {"nat": True} if nat else {}
    return generic_aggregate(codes_flat, arr_flat, engine=engine, func=scan.scan, size=size,
                             dtype=dtype, **kwargs)


def _mask_positions(out: torch.Tensor, nanmask: torch.Tensor, nat: bool = False) -> torch.Tensor:
    """Positions with a missing label: NaN, or NaT on the int64 view of
    datetimes."""
    if nat:
        return torch.where(nanmask, _NAT_INT, out)
    if not out.is_floating_point():
        out = out.to(torch.float64)
    return torch.where(nanmask, float("nan"), out)
