"""xrlite: a minimal labeled-array layer (DataArray/Dataset) for the adapter
(counterpart of ``flox_tpu/xrlite.py``).

``flox_tpu_torch.xarray.xarray_reduce`` binds to real xarray when it is
installed and to this module otherwise, so the same adapter code runs either
way. It holds the slice of labeled-array semantics the adapter needs: named
dims, coords, attrs, ``broadcast``, ``expand_dims`` and an ``apply_ufunc``
with core-dim handling, with xarray-compatible call signatures.

* Data is a numpy array or a torch tensor. A tensor stays a tensor on its
  device through ``transpose`` (a ``permute`` view), ``expand_dims`` (an
  ``expand`` view, no copy), ``isel``, ``rename`` and ``copy``: nothing here
  makes a host copy, except ``values``, which is numpy by definition.
* Coordinates are numpy arrays, or pandas indexes where the caller passed
  one (or :class:`~flox_tpu_torch.types.Bins`, the group coordinate of a
  binned grouper where pandas is absent); pandas is never imported here.
* No index alignment or joins: the adapter's contract is "already aligned",
  which is also what it asks of real xarray (``join="exact"``).
"""

from __future__ import annotations

from typing import Any, Hashable, Mapping, Sequence

import numpy as np
import torch

from . import utils
from .types import Bins

__all__ = ["DataArray", "Dataset", "apply_ufunc", "broadcast"]


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _is_pandas_index(x) -> bool:
    """A pandas ``Index`` (``MultiIndex`` included), told without importing
    pandas."""
    pd = utils.loaded_pandas()
    return pd is not None and isinstance(x, pd.Index)


def _shape(data) -> tuple[int, ...]:
    return tuple(np.shape(data))


class DataArray:
    """A named, dim-labeled array with coords and attrs (xarray subset)."""

    __slots__ = ("data", "dims", "_coords", "attrs", "name")

    def __init__(
        self,
        data,
        dims: Sequence[Hashable] | None = None,
        coords: Mapping[Hashable, Any] | None = None,
        name: Hashable | None = None,
        attrs: dict | None = None,
    ):
        if isinstance(data, DataArray):
            coords = {**data.coords, **(coords or {})}
            dims = dims if dims is not None else data.dims
            name = name if name is not None else data.name
            attrs = attrs if attrs is not None else dict(data.attrs)
            data = data.data
        self.data = data
        nd = len(_shape(data))
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(nd))
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        if len(dims) != nd:
            raise ValueError(f"{len(dims)} dims {dims} for {nd}-d data")
        self.dims = dims
        self.attrs = dict(attrs or {})
        self.name = name
        self._coords: dict[Hashable, tuple[tuple[Hashable, ...], Any]] = {}
        for cname, cval in (coords or {}).items():
            self._set_coord(cname, cval)

    # -- construction helpers ------------------------------------------------

    def _set_coord(self, cname, cval):
        if isinstance(cval, DataArray):
            self._coords[cname] = (cval.dims, cval.data)
        elif isinstance(cval, tuple) and len(cval) == 2 and not isinstance(cval[0], int):
            cdims, cdata = cval
            cdims = (cdims,) if isinstance(cdims, str) else tuple(cdims)
            self._coords[cname] = (cdims, cdata)
        elif _is_pandas_index(cval) or _is_tensor(cval) or isinstance(cval, Bins):
            self._coords[cname] = ((cname,), cval)
        else:
            arr = np.asarray(cval)
            if arr.ndim == 0:
                self._coords[cname] = ((), arr)
            else:
                self._coords[cname] = ((cname,), arr)
        cdims, cdata = self._coords[cname]
        for d, n in zip(cdims, _shape(cdata)):
            if d in self.dims and n != self.sizes[d]:
                raise ValueError(
                    f"coord {cname!r} has size {n} along {d!r}; data has {self.sizes[d]}"
                )

    # -- xarray-compatible surface ------------------------------------------

    @property
    def coords(self) -> dict[Hashable, "DataArray"]:
        return {k: DataArray(v, dims=d, name=k) for k, (d, v) in self._coords.items()}

    @property
    def values(self) -> np.ndarray:
        """The data as a numpy array (a tensor is copied to the host)."""
        return utils.asarray_host(self.data)

    @property
    def shape(self) -> tuple[int, ...]:
        return _shape(self.data)

    @property
    def dtype(self):
        data = self.data
        return data.dtype if hasattr(data, "dtype") else np.asarray(data).dtype

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def sizes(self) -> dict[Hashable, int]:
        return dict(zip(self.dims, _shape(self.data)))

    def get_axis_num(self, dim: Hashable) -> int:
        return self.dims.index(dim)

    def __getitem__(self, key):
        if key in self._coords:
            d, v = self._coords[key]
            return DataArray(v, dims=d, name=key)
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        return key in self._coords

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<xrlite.DataArray {self.name or ''} {tuple(self.dims)} "
            f"shape={self.shape} dtype={self.dtype}>"
        )

    def copy(self) -> "DataArray":
        out = DataArray(self.data, dims=self.dims, name=self.name, attrs=dict(self.attrs))
        out._coords = dict(self._coords)
        return out

    def rename(self, name: Hashable) -> "DataArray":
        out = self.copy()
        out.name = name
        return out

    def transpose(self, *dims: Hashable) -> "DataArray":
        if not dims:
            dims = tuple(reversed(self.dims))
        missing = [d for d in dims if d not in self.dims]
        if missing:
            raise ValueError(f"transpose: dims {missing} not in {self.dims}")
        order = [self.dims.index(d) for d in dims]
        data = self.data
        if order != list(range(len(order))):
            if _is_tensor(data):
                data = data.permute(order)
            else:
                # a MultiIndex becomes an object array of tuples
                data = np.transpose(np.asarray(data), order)
        out = DataArray(data, dims=dims, name=self.name, attrs=dict(self.attrs))
        out._coords = dict(self._coords)
        return out

    def isel(self, indexers: Mapping[Hashable, Any] | None = None,
             **indexers_kwargs) -> "DataArray":
        """Select by position along named dims: an int drops the dim, a
        slice keeps a view (a tensor stays on its device), an integer array
        gathers (orthogonally, dim by dim). Coordinates along a selected dim
        are selected alike."""
        indexers = {**(indexers or {}), **indexers_kwargs}
        missing = [d for d in indexers if d not in self.dims]
        if missing:
            raise ValueError(f"isel: dims {missing} not in {self.dims}")

        def select(dims, data):
            if _is_pandas_index(data):
                data = np.asarray(data)
            kept = list(dims)
            # one dim at a time, last first, so that array indexers select
            # orthogonally and dropped dims do not shift the earlier axes
            for ax in reversed(range(len(dims))):
                i = indexers.get(dims[ax], slice(None))
                if _is_tensor(data) and isinstance(i, (np.ndarray, list)):
                    i = torch.as_tensor(i, device=data.device)
                data = data[(slice(None),) * ax + (i,)]
                if isinstance(i, (int, np.integer)) or getattr(i, "ndim", 1) == 0:
                    del kept[ax]
            return tuple(kept), data

        dims, data = select(self.dims, self.data)
        out = DataArray(data, dims=dims, name=self.name, attrs=dict(self.attrs))
        for cname, (cdims, cdata) in self._coords.items():
            out._coords[cname] = (select(cdims, cdata) if any(d in indexers for d in cdims)
                                  else (cdims, cdata))
        return out

    def expand_dims(self, dim: Mapping[Hashable, int]) -> "DataArray":
        """Prepend new dims of the given sizes (broadcast, no copy)."""
        new_dims = tuple(dim) + self.dims
        lead = tuple(dim.values())
        data = self.data
        if _is_tensor(data):
            data = data.reshape((1,) * len(dim) + tuple(data.shape)).expand(
                lead + tuple(data.shape))
        else:
            target = lead + np.shape(data)
            data = np.broadcast_to(np.reshape(data, (1,) * len(dim) + np.shape(data)), target)
        out = DataArray(data, dims=new_dims, name=self.name, attrs=dict(self.attrs))
        out._coords = dict(self._coords)
        return out

    def assign_coords(self, coords: Mapping[Hashable, Any]) -> "DataArray":
        out = self.copy()
        for k, v in coords.items():
            out._set_coord(k, v)
        return out

    def drop_vars(self, names) -> "DataArray":
        names = {names} if isinstance(names, str) else set(names)
        out = self.copy()
        for n in names:
            out._coords.pop(n, None)
        return out


class Dataset:
    """A dict of DataArrays sharing dims/coords (xarray subset)."""

    __slots__ = ("_vars", "_coords", "attrs")

    def __init__(
        self,
        data_vars: Mapping[Hashable, Any] | None = None,
        coords: Mapping[Hashable, Any] | None = None,
        attrs: dict | None = None,
    ):
        self._vars: dict[Hashable, DataArray] = {}
        self._coords: dict[Hashable, tuple[tuple[Hashable, ...], Any]] = {}
        self.attrs = dict(attrs or {})
        for cname, cval in (coords or {}).items():
            self._coords[cname] = _normalized_coord(cname, cval)
        for name, var in (data_vars or {}).items():
            self[name] = var

    @property
    def data_vars(self) -> dict[Hashable, DataArray]:
        return dict(self._vars)

    @property
    def coords(self) -> dict[Hashable, DataArray]:
        return {k: DataArray(v, dims=d, name=k) for k, (d, v) in self._coords.items()}

    @property
    def dims(self) -> dict[Hashable, int]:
        out: dict[Hashable, int] = {}
        for var in self._vars.values():
            out.update(var.sizes)
        return out

    sizes = dims

    def __contains__(self, key) -> bool:
        return key in self._vars or key in self._coords

    def __iter__(self):
        return iter(self._vars)

    def __getitem__(self, key) -> DataArray:
        if key in self._vars:
            var = self._vars[key].copy()
            for cname, (cdims, cdata) in self._coords.items():
                if all(d in var.dims for d in cdims):
                    var._coords.setdefault(cname, (cdims, cdata))
            return var
        if key in self._coords:
            d, v = self._coords[key]
            return DataArray(v, dims=d, name=key)
        raise KeyError(key)

    def __setitem__(self, key, value) -> None:
        if isinstance(value, tuple) and len(value) == 2 and not isinstance(value[0], int):
            value = DataArray(value[1], dims=value[0], name=key)
        if not isinstance(value, DataArray):
            value = DataArray(value, name=key)
        var = value.copy()
        var.name = key
        # hoist the variable's coords to the dataset
        for cname, cv in var._coords.items():
            self._coords.setdefault(cname, cv)
        var._coords = {}
        self._vars[key] = var

    def drop_vars(self, names) -> "Dataset":
        names = {names} if isinstance(names, str) else set(names)
        out = Dataset(attrs=dict(self.attrs))
        out._coords = {k: v for k, v in self._coords.items() if k not in names}
        out._vars = {k: v.copy() for k, v in self._vars.items() if k not in names}
        return out

    def assign_coords(self, coords: Mapping[Hashable, Any]) -> "Dataset":
        out = Dataset(attrs=dict(self.attrs))
        out._vars = {k: v.copy() for k, v in self._vars.items()}
        out._coords = dict(self._coords)
        for k, v in coords.items():
            out._coords[k] = _normalized_coord(k, v)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<xrlite.Dataset vars={list(self._vars)} dims={self.dims}>"


def _normalized_coord(cname, cval) -> tuple[tuple[Hashable, ...], Any]:
    """A coordinate in the ``(dims, data)`` form, by DataArray's rules."""
    probe = DataArray(0.0)
    probe.dims = ()
    probe._set_coord(cname, cval)
    return probe._coords[cname]


def broadcast(*arrays: DataArray) -> tuple[DataArray, ...]:
    """Broadcast DataArrays against each other by dim name (xarray subset:
    no index alignment; the inputs are assumed aligned, as with
    join='exact')."""
    all_dims: dict[Hashable, int] = {}
    for a in arrays:
        for d, n in a.sizes.items():
            if d in all_dims and all_dims[d] != n:
                raise ValueError(f"conflicting sizes for dim {d!r}: {all_dims[d]} vs {n}")
            all_dims.setdefault(d, n)
    order = tuple(all_dims)
    out = []
    for a in arrays:
        missing = {d: all_dims[d] for d in order if d not in a.dims}
        b = a.expand_dims(missing) if missing else a
        out.append(b.transpose(*order))
    return tuple(out)


def apply_ufunc(
    func,
    *args,
    input_core_dims: Sequence[Sequence[Hashable]] | None = None,
    output_core_dims: Sequence[Sequence[Hashable]] | None = None,
    keep_attrs: bool = True,
    dask: str = "forbidden",
    vectorize: bool = False,
    join: str = "exact",
    dataset_fill_value=None,
    **_ignored,
):
    """Core-dims apply (the slice of ``xr.apply_ufunc`` the adapter uses).

    Each argument's core dims are moved to the end (in the given order);
    broadcast (non-core) dims are aligned by name across arguments; ``func``
    gets the raw arrays and its result is re-wrapped with dims = broadcast +
    output core.
    """
    if input_core_dims is None:
        input_core_dims = [()] * len(args)
    if output_core_dims is None:
        output_core_dims = [()]
    das = [a if isinstance(a, DataArray) else DataArray(a) for a in args]

    # broadcast dims: every non-core dim, in order of first appearance
    bcast: dict[Hashable, int] = {}
    for a, core in zip(das, input_core_dims):
        for d, n in a.sizes.items():
            if d not in core:
                if d in bcast and bcast[d] != n:
                    raise ValueError(f"conflicting sizes for dim {d!r}")
                bcast.setdefault(d, n)
    border = tuple(bcast)

    raws = []
    for a, core in zip(das, input_core_dims):
        missing_b = {d: bcast[d] for d in border if d not in a.dims}
        b = a.expand_dims(missing_b) if missing_b else a
        b = b.transpose(*(border + tuple(core)))
        raws.append(b.data)

    result = func(*raws)
    results = result if isinstance(result, tuple) else (result,)
    if len(results) != len(output_core_dims):
        raise ValueError(
            f"func returned {len(results)} outputs; expected {len(output_core_dims)}"
        )

    outs = []
    template = das[0]
    for res, ocore in zip(results, output_core_dims):
        dims = border + tuple(ocore)
        out = DataArray(res, dims=dims, name=template.name,
                        attrs=dict(template.attrs) if keep_attrs else {})
        # carry coords that still apply (all their dims survive)
        for cname, (cdims, cdata) in template._coords.items():
            if all(d in dims for d in cdims):
                out._coords[cname] = (cdims, cdata)
        outs.append(out)
    return tuple(outs) if isinstance(result, tuple) else outs[0]
