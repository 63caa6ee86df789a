"""Grouped reductions of sparse tensors without densifying (counterpart of
``flox_tpu/sparse.py``).

The stored values are grouped by (leading position x group of the last axis)
through one composite segment id, reduced with ``index_add_`` /
``scatter_reduce`` over the stored values on their device, and the implicit
zeros are folded in from counts: a group's implicit zeros are its columns
times rows less its stored values, extrema are compared against 0, NaN fills
promote integer results to float, and a group whose stored values are all NaN
(with no implicit zero) takes the fill. Supported funcs are the reference's:
``sum, nansum, min, max, nanmin, nanmax, mean, nanmean, count``.

The container is ``torch.sparse_coo_tensor`` (a ``sparse_csr`` tensor is
converted to COO). A COO tensor may hold duplicate indices until it is
coalesced, so it is coalesced first: the stored counts would be wrong
otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import utils
from .cuda_kernels import minmax_identity

__all__ = ["SPARSE_FUNCS", "is_sparse_array", "sparse_groupby_reduce"]

SPARSE_FUNCS = frozenset(
    {"sum", "nansum", "min", "max", "nanmin", "nanmax", "mean", "nanmean", "count"}
)


def is_sparse_array(x) -> bool:
    """A sparse torch tensor (COO or CSR)."""
    return isinstance(x, torch.Tensor) and x.layout in (torch.sparse_coo, torch.sparse_csr)


def sparse_groupby_reduce(mat: torch.Tensor, codes, *, func: str, size: int, fill_value=None,
                          dtype=None) -> torch.Tensor:
    """Grouped reduction over the last axis of a sparse tensor.

    ``codes``: (ncols,) int with -1 = missing. Returns a dense (..., size)
    tensor on ``mat``'s device.
    """
    if func not in SPARSE_FUNCS:
        raise NotImplementedError(
            f"sparse grouped {func!r} is not supported (the reference supports the same "
            f"subset): {sorted(SPARSE_FUNCS)}"
        )
    if mat.layout == torch.sparse_csr:
        mat = mat.to_sparse_coo()
    if mat.dense_dim():
        raise NotImplementedError("hybrid sparse tensors (dense trailing dims) are not supported")
    mat = mat.coalesce()
    dev = mat.device
    data = mat.values()
    if dtype is not None:
        data = data.to(utils.torch_dtype(dtype))
    idx = mat.indices()  # (ndim, nse)
    lead_shape = tuple(mat.shape[:-1])
    nlead = math.prod(lead_shape)
    codes = torch.as_tensor(utils.asarray_host(codes).reshape(-1), device=dev).to(torch.int64)

    if lead_shape:
        strides = torch.as_tensor(
            np.concatenate([np.cumprod(lead_shape[::-1])[-2::-1], [1]]).astype(np.int64),
            device=dev)
        lead_idx = (idx[:-1] * strides[:, None]).sum(0)
    else:
        lead_idx = torch.zeros(idx.shape[1], dtype=torch.int64, device=dev)
    gcode = codes[idx[-1]]  # (nse,)

    # composite segment id over (lead, group); missing labels -> overflow slot
    nseg = nlead * size
    seg = torch.where(gcode >= 0, lead_idx * size + gcode, nseg)
    out_shape = lead_shape + (size,)

    def _seg(op, vals):
        if op == "sum":
            out = torch.zeros(nseg + 1, dtype=vals.dtype, device=dev).index_add_(0, seg, vals)
        else:
            out = torch.full((nseg + 1,), minmax_identity(op, vals.dtype), dtype=vals.dtype,
                             device=dev)
            out.scatter_reduce_(0, seg, vals, "a" + op, include_self=True)
        return out[:nseg].reshape(out_shape)

    skipna = func.startswith("nan") or func == "count"
    isnan = torch.isnan(data) if data.is_floating_point() else torch.zeros_like(data, dtype=bool)

    # per-(lead, group) stored counts; per-group column counts
    stored = _seg("sum", torch.ones_like(data, dtype=torch.int32))
    stored_nan = _seg("sum", isnan.to(torch.int32))
    col_counts = torch.bincount(torch.where(codes >= 0, codes, size), minlength=size + 1)[:size]
    total = col_counts.to(torch.int32).expand(out_shape)
    implicit = total - stored  # implicit zeros per (lead, group)

    fv = float("nan") if fill_value is None else fill_value
    fv_is_nan = isinstance(fv, float) and math.isnan(fv)

    def _promote_for_fill(out):
        """NaN fills force a float result, as the dense path promotes."""
        if fv_is_nan and not out.is_floating_point():
            return out.to(torch.float64)
        return out

    def _full(value, like):
        return torch.as_tensor(value, device=dev).to(like.dtype)

    if func in ("sum", "nansum"):
        vals = torch.where(isnan, 0, data) if func == "nansum" else data
        out = _seg("sum", vals)
        if func == "sum" and out.is_floating_point():
            out = torch.where(stored_nan > 0, _full(float("nan"), out), out)
        # implicit zeros contribute 0; a user fill replaces truly empty groups
        return torch.where(total == 0, _full(0 if fill_value is None else fill_value, out), out)

    if func == "count":
        return total - stored_nan

    if func in ("mean", "nanmean"):
        vals = torch.where(isnan, 0, data) if func == "nanmean" else data
        s = _seg("sum", vals)
        denom = (total - stored_nan) if func == "nanmean" else total
        out = s / torch.where(denom > 0, denom, 1).to(s.dtype)
        out = _promote_for_fill(out)
        if func == "mean":
            out = torch.where(stored_nan > 0, _full(float("nan"), out), out)
        return torch.where(denom > 0, out, _full(fv, out))

    # min/max family: compare the stored extreme against the implicit zero
    op = "max" if "max" in func else "min"
    vals = torch.where(isnan, minmax_identity(op, data.dtype), data) if skipna else data
    ext = _seg(op, vals)
    if not skipna and ext.is_floating_point():
        ext = torch.where(stored_nan > 0, _full(float("nan"), ext), ext)
    zero = torch.zeros((), dtype=ext.dtype, device=dev)
    bound = torch.maximum(ext, zero) if op == "max" else torch.minimum(ext, zero)
    with_fill = _promote_for_fill(torch.where(implicit > 0, bound, ext))
    if skipna:
        # all-stored-NaN groups with no implicit zeros take the fill
        all_nan_stored = (stored_nan == stored) & (implicit == 0) & (total > 0)
        with_fill = torch.where(all_nan_stored, _full(fv, with_fill), with_fill)
    return torch.where(total > 0, with_fill, _full(fv, with_fill))
