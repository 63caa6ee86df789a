"""Reindexing: align a per-group axis to a target index (counterpart of
``flox_tpu/reindex.py``).

The reductions of this package always reduce into a dense axis over the
expected groups, so their results never need reindexing. :func:`reindex_`
serves the rest: aligning a result over discovered groups to another index,
on the host (numpy) or on the result's device (torch). The ``SPARSE_COO``
array type keeps only the groups that occur: a ``torch.sparse_coo_tensor`` on
the call's device when the implicit fill is zero, a :class:`HostCOO`
otherwise (a sparse tensor's implicit value is always 0).

``pd.Index.get_indexer`` becomes :func:`get_indexer`, a sorted
``searchsorted`` plus an equality check (NaN matching NaN, as in pandas), or a
dict for object labels, so nothing here needs pandas.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum, auto
from typing import Any

import numpy as np
import torch

from . import dtypes, utils
from .factorize import _align

__all__ = ["HostCOO", "ReindexArrayType", "ReindexStrategy", "get_indexer", "reindex_",
           "reindex_sparse_coo"]


class ReindexArrayType(Enum):
    """Which array type holds the reindexed result.

    SPARSE_COO targets enormous group spaces: instead of a dense
    ``(..., len(to))`` array only the found groups' columns are stored, as a
    ``torch.sparse_coo_tensor`` (zero fill) or a :class:`HostCOO` (non-zero
    fill).
    """

    AUTO = auto()
    NUMPY = auto()
    SPARSE_COO = auto()


@dataclass(frozen=True)
class ReindexStrategy:
    """Whether to reindex blockwise (per shard) and into what array type.

    Accepted by ``groupby_reduce(reindex=...)``: ``blockwise=True/None`` with
    a dense ``array_type`` is the implicit dense behavior; ``array_type=
    SPARSE_COO`` packs the result with :func:`reindex_sparse_coo`;
    ``blockwise=False`` with a dense array type changes nothing on one device.
    """

    blockwise: bool | None = None
    array_type: ReindexArrayType = ReindexArrayType.AUTO

    def __post_init__(self):
        # a sparse blockwise reindex makes no sense: each block would densify
        # on combine
        if self.blockwise is True and self.array_type not in (
            ReindexArrayType.AUTO,
            ReindexArrayType.NUMPY,
        ):
            raise ValueError("Setting reindex.blockwise=True not allowed for non-numpy array type.")

    def set_blockwise_for_numpy(self) -> "ReindexStrategy":
        """A new strategy with ``blockwise=None`` resolved to ``True`` (the
        frozen instance is never mutated)."""
        if self.blockwise is None:
            return dataclasses.replace(self, blockwise=True)
        return self


@dataclass
class HostCOO:
    """Host-side COO result for non-zero fill values: last axis sparse,
    everything before it dense. ``columns`` are the populated positions along
    the last axis; ``data`` is ``(..., len(columns))``."""

    columns: np.ndarray
    data: np.ndarray
    shape: tuple[int, ...]
    fill_value: Any

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def todense(self) -> np.ndarray:
        out = np.full(self.shape, self.fill_value, dtype=self.data.dtype)
        out[..., self.columns] = self.data
        return out


def _index_values(idx) -> np.ndarray:
    """The labels of an index-like: a numpy array, a pandas Index (read
    without importing pandas) or a range."""
    if isinstance(idx, range):
        return np.arange(idx.start, idx.stop, idx.step)
    return utils.asarray_host(getattr(idx, "values", idx)).reshape(-1)


def get_indexer(index, target) -> np.ndarray:
    """``pd.Index(index).get_indexer(target)`` without pandas: the position of
    each ``target`` label in ``index``, -1 where it is absent. NaN (and NaT)
    labels match each other, as in pandas."""
    index, target = _index_values(index), _index_values(target)
    if index.dtype.kind == "O" or target.dtype.kind == "O":
        lookup: dict = {}
        nan_at = -1
        for i, v in enumerate(index.tolist()):
            if utils._is_null_object(v):
                nan_at = i if nan_at < 0 else nan_at
            else:
                lookup.setdefault(v, i)
        return np.array([nan_at if utils._is_null_object(v) else lookup.get(v, -1)
                         for v in target.tolist()], dtype=np.intp)
    out = _align(target, index)
    null_index, null_target = utils.isnull_host(index), utils.isnull_host(target)
    if null_index.any() and null_target.any():
        out[null_target] = np.flatnonzero(null_index)[0]
    return out


def _is_nan_scalar(v) -> bool:
    try:
        return np.ndim(v) == 0 and bool(np.isnan(v))
    except (TypeError, ValueError):
        return False


def reindex_sparse_coo(array, from_, to, *, fill_value=None, dtype=None, device=None):
    """Reindex the trailing group axis into a sparse container.

    Stores only the columns of ``from_`` found in ``to``. Returns a
    ``torch.sparse_coo_tensor`` of shape ``array.shape[:-1] + (len(to),)``
    when the fill is zero (on ``array``'s device for a tensor, else on
    ``device``, which defaults to ``cuda``), and a :class:`HostCOO` otherwise.
    """
    if isinstance(array, torch.Tensor):
        dev = array.device if device is None else utils.resolve_device(device)
        array = array.detach().cpu().numpy()
    else:
        dev = None
        array = np.asarray(array)
    if dtype is not None:
        array = array.astype(dtype, copy=False)
    ncols = len(_index_values(to))

    idx = get_indexer(to, from_)  # target position of each source column
    mask = idx >= 0
    needs_fill = ncols > int(mask.sum())
    if (fill_value is dtypes.NA or _is_nan_scalar(fill_value)) and array.dtype.kind not in "fc":
        # a NaN-ish fill on int data promotes, exactly like the dense path
        promoted, _ = dtypes.maybe_promote(array.dtype)
        array = array.astype(promoted, copy=False)
    if fill_value is dtypes.INF or fill_value is dtypes.NINF or fill_value is dtypes.NA:
        fill_value = dtypes.get_fill_value(array.dtype, fill_value)
    if fill_value is None:
        if needs_fill:
            raise ValueError("Filling is required. fill_value cannot be None.")
        fill_value = 0
    shape = array.shape[:-1] + (ncols,)
    cols = idx[mask]
    data = array[..., mask]

    is_zero = False
    try:
        is_zero = not np.any(np.asarray(fill_value))
    except (TypeError, ValueError):
        pass
    if not is_zero:
        return HostCOO(columns=cols, data=data, shape=shape, fill_value=fill_value)

    dev = utils.resolve_device(device) if dev is None else dev
    grids = torch.meshgrid(*[torch.arange(s) for s in data.shape[:-1]],
                           torch.as_tensor(cols, dtype=torch.int64), indexing="ij")
    indices = torch.stack([g.reshape(-1) for g in grids])
    values = torch.from_numpy(np.ascontiguousarray(data)).reshape(-1)
    return torch.sparse_coo_tensor(indices, values, shape).coalesce().to(dev)


def reindex_(
    array,
    from_,
    to,
    *,
    fill_value: Any = None,
    axis: int = -1,
    promote: bool = False,
    array_type: ReindexArrayType = ReindexArrayType.AUTO,
    device=None,
):
    """Gather ``array``'s group axis from ``from_`` order into ``to`` order.

    Missing target groups are filled with ``fill_value`` (sentinels resolved
    against the array's dtype). A numpy ``array`` gives a numpy result, a
    tensor a tensor on its device; ``array_type=SPARSE_COO`` goes to
    :func:`reindex_sparse_coo`.
    """
    if array_type == ReindexArrayType.SPARSE_COO:
        if axis != -1:
            raise NotImplementedError("sparse reindex supports axis=-1 only")
        return reindex_sparse_coo(array, from_, to, fill_value=fill_value, device=device)
    idx = get_indexer(from_, to)
    missing = idx < 0
    is_tensor = isinstance(array, torch.Tensor)
    if not is_tensor:
        array = np.asarray(array)
    np_dtype = utils.numpy_dtype(array.dtype)

    if fill_value is dtypes.INF or fill_value is dtypes.NINF:
        # representable without promotion (iinfo extremes for ints)
        fill_value = dtypes.get_fill_value(np_dtype, fill_value)
    elif fill_value is dtypes.NA or fill_value is None:
        if missing.any() or promote:
            promoted, _ = dtypes.maybe_promote(np_dtype)
            if promoted != np_dtype:
                array = (array.to(utils.torch_dtype(promoted)) if is_tensor
                         else array.astype(promoted, copy=False))
            fill_value = dtypes.get_fill_value(promoted, dtypes.NA)
        else:
            fill_value = 0  # unused
    take = np.where(missing, 0, idx)
    if not is_tensor:
        out = np.take(array, take, axis=axis)
        if missing.any():
            shape = [1] * out.ndim
            shape[axis] = len(idx)
            mask = np.broadcast_to(missing.reshape(shape), out.shape)
            out = np.where(mask, fill_value, out)
        return out
    out = array.index_select(axis % array.ndim, torch.as_tensor(take, device=array.device))
    if missing.any():
        shape = [1] * out.ndim
        shape[axis] = len(idx)
        mask = torch.as_tensor(missing, device=out.device).reshape(shape)
        # numpy's promotion of the fill against the values (an int array
        # filled with -1.5 becomes float64), as np.where gives it
        dt = utils.torch_dtype(np.where(True, fill_value,
                                        np.zeros(1, utils.numpy_dtype(out.dtype))).dtype)
        out = torch.where(mask, torch.as_tensor(fill_value, dtype=dt, device=out.device),
                          out.to(dt))
    return out
