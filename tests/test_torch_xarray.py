"""The port's ``xarray_reduce`` and ``xrlite`` (flox_tpu_torch) against
flox_tpu's, on the CPU.

Each scenario builds the same labeled object from the same seeded numpy data
in both packages' xrlite, reduces it with the reference (``engine="jax"``,
named explicitly: its size heuristic would otherwise pick the numpy engine)
and with the port (``device="cpu"``; the data as a numpy array and as a torch
tensor), and compares dims, shape, name, attrs, coordinates and values.

Tolerances: float64 results ``rtol=1e-12, atol=1e-14`` (both sides add in
float64, in different orders); float32 ``rtol=1e-5, atol=1e-6``; integer
results and counts exactly. Coordinates exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from flox_tpu import xrlite as rxl
from flox_tpu.xarray import xarray_reduce as ref_reduce

import flox_tpu_torch
from flox_tpu_torch import xrlite as pxl
from flox_tpu_torch.types import Bins
from flox_tpu_torch.xarray import rechunk_for_blockwise, rechunk_for_cohorts

REPO = Path(__file__).resolve().parent.parent
NT = 48
MONTHS = (np.arange(NT) // 4) % 12


def _data(shape=(3, NT), seed=0, nan=0.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(dtype)
    if nan:
        data[rng.random(shape) < nan] = np.nan
    return data


def _da(xl, data, *, tensor=False):
    """(lat, time) with a monthly label on time: the climatology layout."""
    return xl.DataArray(
        torch.from_numpy(data) if tensor else data,
        dims=("lat", "time"),
        coords={"lat": np.array([10.0, 20.0, 30.0]), "month": ("time", MONTHS)},
        name="temp", attrs={"units": "K"},
    )


def _values(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _coord_equal(got, ref):
    if isinstance(ref, pd.IntervalIndex):
        assert isinstance(got, pd.IntervalIndex)
        assert got.closed == ref.closed
        np.testing.assert_array_equal(np.asarray(got.left), np.asarray(ref.left))
        np.testing.assert_array_equal(np.asarray(got.right), np.asarray(ref.right))
    elif isinstance(ref, pd.MultiIndex):
        assert isinstance(got, pd.MultiIndex) and list(got.names) == list(ref.names)
        assert list(got) == list(ref)
    else:
        np.testing.assert_array_equal(_values(got), np.asarray(ref))


def _check_da(got, ref):
    assert got.dims == ref.dims
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.name == ref.name
    assert got.attrs == ref.attrs
    assert set(got._coords) == set(ref._coords)
    for name, (rdims, rdata) in ref._coords.items():
        gdims, gdata = got._coords[name]
        assert gdims == rdims, name
        _coord_equal(gdata, rdata)
    g, r = _values(got.data), np.asarray(ref.data)
    if r.dtype.kind in "iub":
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    elif r.dtype == np.float32:
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True)
    else:
        assert g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-14, equal_nan=True)


def _both(build, *, tensor=False, **kw):
    """``build(xl)`` -> (obj, by tuple) in each package's xrlite; both
    results."""
    robj, rby = build(rxl)
    pobj, pby = build(pxl, tensor=tensor) if tensor else build(pxl)
    ref = ref_reduce(robj, *rby, engine="jax", **kw)
    got = flox_tpu_torch.xarray_reduce(pobj, *pby, device="cpu", **kw)
    return got, ref


def _by_name(xl, tensor=False):
    return _da(xl, _data(nan=0.1), tensor=tensor), ("month",)


def _by_dataarray(xl, tensor=False):
    da = _da(xl, _data(nan=0.1), tensor=tensor)
    return da, (da["month"],)


def _float32(xl, tensor=False):
    return _da(xl, _data(dtype=np.float32, nan=0.1), tensor=tensor), ("month",)


def _ints(xl, tensor=False):
    data = np.random.default_rng(3).integers(-50, 50, (3, NT)).astype(np.int32)
    return _da(xl, data, tensor=tensor), ("month",)


def _multi_by(xl, tensor=False):
    da = _da(xl, _data(), tensor=tensor)
    return da.assign_coords({"half": ("time", (np.arange(NT) >= 24).astype(int))}), (
        "month", "half")


def _lat_band(xl, tensor=False):
    da = _da(xl, _data(), tensor=tensor)
    return da, (xl.DataArray(np.array([0, 0, 1]), dims=("lat",), name="band"),)


def _two_d_grouper(xl, tensor=False):
    # a grouper that varies along the kept dim lat: the offset path
    da = _da(xl, _data(seed=4), tensor=tensor)
    labels = (np.arange(3)[:, None] + MONTHS[None, :]) % 5
    return da, (xl.DataArray(labels, dims=("lat", "time"), name="zone"),)


def _three_d(xl, tensor=False):
    data = _data((3, 4, NT), seed=5, nan=0.05)
    da = xl.DataArray(torch.from_numpy(data) if tensor else data, dims=("lat", "lon", "time"),
                      coords={"month": ("time", MONTHS), "lon": np.arange(4.0)}, name="t2m")
    return da, ("month",)


SCENARIOS = [
    # id, the function making (obj, by), kwargs
    ("by-name-mean", _by_name, {"func": "mean"}),
    ("by-name-nanmean", _by_name, {"func": "nanmean"}),
    ("by-dataarray", _by_dataarray, {"func": "nanmean"}),
    ("skipna-true", _by_name, {"func": "mean", "skipna": True}),
    ("skipna-false", _by_name, {"func": "nanmean", "skipna": False}),
    ("float32-nansum", _float32, {"func": "nansum"}),
    ("float32-nanmax", _float32, {"func": "nanmax"}),
    ("int32-sum", _ints, {"func": "sum"}),
    ("int32-max", _ints, {"func": "max"}),
    ("binning-count", _by_name,
     {"func": "count", "expected_groups": np.array([0.0, 15.0, 35.0]), "isbin": True,
      "dim": "lat"}),
    ("multi-by", _multi_by, {"func": "sum"}),
    ("vector-q", _by_name, {"func": "quantile", "q": [0.25, 0.5, 0.75]}),
    ("nanquantile", _by_name, {"func": "nanquantile", "q": 0.3}),
    ("expected-groups", _by_name, {"func": "count", "expected_groups": np.arange(14)}),
    ("dim-ellipsis", _by_name, {"func": "mean", "dim": ...}),
    ("min-count", _by_name, {"func": "nansum", "min_count": 3}),
    ("fill-value", _by_name,
     {"func": "sum", "expected_groups": np.arange(14), "fill_value": -777.0}),
    ("keep-attrs-false", _by_name, {"func": "mean", "keep_attrs": False}),
    ("sort-false", _by_name, {"func": "sum", "sort": False}),
    ("nanvar-ddof", _by_name, {"func": "nanvar", "ddof": 1}),
    ("grouper-along-other-dim", _lat_band, {"func": "mean", "dim": "lat"}),
    ("grouper-varying-along-kept-dim", _two_d_grouper, {"func": "nanmean", "dim": "time"}),
    ("three-d", _three_d, {"func": "nanmean"}),
    ("three-d-binned-month", _three_d,
     {"func": "nanmax", "isbin": True, "expected_groups": np.array([0, 6, 12])}),
    ("plain-mean", _by_name, {"func": "mean", "dim": "lat"}),
    ("plain-count", _by_name, {"func": "count", "dim": "lat"}),
    ("plain-argmax", _by_name, {"func": "argmax", "dim": "lat"}),
    ("plain-nanmax", _by_name, {"func": "nanmax", "dim": "lat"}),
    ("plain-std-ddof", _by_name, {"func": "std", "dim": "lat", "ddof": 1}),
    ("plain-vector-q", _by_name, {"func": "quantile", "dim": "lat", "q": [0.25, 0.75]}),
]


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("build,kw", [pytest.param(b, k, id=n) for n, b, k in SCENARIOS])
def test_dataarray_parity(build, kw, tensor):
    got, ref = _both(build, tensor=tensor, **kw)
    _check_da(got, ref)
    if tensor:
        assert isinstance(got.data, torch.Tensor) and got.data.device.type == "cpu"


def test_plain_path_argmax_first_nan():
    """Without skipna, argmax is the first NaN's position, as numpy's."""
    def build(xl):
        data = _data(nan=0.0)
        data[1, 5] = np.nan
        data[2, 5] = np.nan
        return _da(xl, data), ("month",)

    got, ref = _both(build, func="argmax", dim="lat")
    _check_da(got, ref)
    assert got.data[5] == 1


def test_argreduction_positions_along_the_reduced_dim():
    """Positions are along the reduced dims. The reference's adapter hands
    groupby_reduce labels broadcast over lat, so its positions count in the
    flattened (lat, time) span: row r's are offset by r * NT. The port's
    are the reference groupby_reduce's on the (time,) labels."""
    import flox_tpu

    data = _data(nan=0.1)
    got = flox_tpu_torch.xarray_reduce(_da(pxl, data), "month", func="nanargmax", device="cpu")
    want, _ = flox_tpu.groupby_reduce(data, MONTHS, func="nanargmax", engine="jax")
    assert got.dims == ("lat", "month")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want))
    ref = ref_reduce(_da(rxl, data), "month", func="nanargmax", engine="jax")
    np.testing.assert_array_equal(np.asarray(ref.data),
                                  np.asarray(want) + NT * np.arange(3)[:, None])


def _dataset(xl, tensor=False):
    da = _da(xl, _data(nan=0.1), tensor=tensor)
    ints = xl.DataArray(np.arange(3 * NT, dtype=np.int32).reshape(3, NT) % 17,
                        dims=("lat", "time"))
    return xl.Dataset({"temp": da, "cls": ints, "scalarish": xl.DataArray(
        np.arange(3.0), dims=("lat",))}, attrs={"title": "demo"})


@pytest.mark.parametrize("func", ["mean", "nanmax", "sum"])
def test_dataset_parity(func):
    ref = ref_reduce(_dataset(rxl), "month", func=func, engine="jax")
    got = flox_tpu_torch.xarray_reduce(_dataset(pxl), "month", func=func, device="cpu")
    assert isinstance(got, pxl.Dataset)
    assert got.attrs == ref.attrs == {"title": "demo"}
    assert set(got.data_vars) == set(ref.data_vars)
    for name in ref.data_vars:
        _check_da(got[name], ref[name])
    assert got["temp"].dims[0] == "month"  # dataset members put the group dim first


def test_dataset_grouped_by_dim_coordinate():
    def build(xl):
        da = xl.DataArray(np.arange(8.0).reshape(4, 2), dims=("x", "lat"),
                          coords={"x": np.array([0, 0, 1, 1])}, name="a")
        return xl.Dataset({"a": da})

    ref = ref_reduce(build(rxl), "x", func="mean", engine="jax")
    got = flox_tpu_torch.xarray_reduce(build(pxl), "x", func="mean", device="cpu")
    _check_da(got["a"], ref["a"])


def test_multiindex_grouping():
    mi = pd.MultiIndex.from_product([["a", "b"], [0, 1]], names=("letter", "num"))
    labels = mi.take(np.array([0, 1, 2, 3, 0, 1, 2, 3]))

    def build(xl):
        return xl.DataArray(np.arange(8.0), dims=("sample",),
                            coords={"stacked": ("sample", labels)})

    ref = ref_reduce(build(rxl), "stacked", func="sum", engine="jax")
    got = flox_tpu_torch.xarray_reduce(build(pxl), "stacked", func="sum", device="cpu")
    groups = got["stacked"].data
    assert isinstance(groups, pd.MultiIndex) and groups.names == ["letter", "num"]
    _check_da(got, ref)


def test_datetime_bin_resample():
    t = pd.date_range("2001-01-01", periods=NT, freq="h")
    bins = pd.interval_range(t[0], periods=2, freq="24h")

    def build(xl):
        return xl.DataArray(np.arange(float(NT)), dims=("time",), coords={"time": t.values},
                            name="x")

    ref = ref_reduce(build(rxl), "time", func="mean", expected_groups=bins, engine="jax")
    got = flox_tpu_torch.xarray_reduce(build(pxl), "time", func="mean", expected_groups=bins,
                                       device="cpu")
    assert (got["time_bins"].data == bins).all()
    _check_da(got, ref)


def test_binned_grouper_dim_order():
    def build(xl):
        da = _da(xl, _data())
        return xl.DataArray(da.values.T, dims=("time", "lat"), coords=da._coords)

    kw = dict(func="mean", isbin=True, expected_groups=np.array([0, 6, 12]))
    ref = ref_reduce(build(rxl), "month", engine="jax", **kw)
    got = flox_tpu_torch.xarray_reduce(build(pxl), "month", device="cpu", **kw)
    assert got.dims == ("month_bins", "lat")
    _check_da(got, ref)


def test_plain_path_misaligned_grouper_raises():
    bad = pxl.DataArray(np.arange(20) % 12, dims=("time",), name="m")
    with pytest.raises(ValueError, match="align"):
        flox_tpu_torch.xarray_reduce(_da(pxl, _data()), bad, func="mean", dim="lat",
                                     device="cpu")


def test_grouper_reaches_groupby_reduce_with_its_own_shape(monkeypatch):
    """The month labels of (lat, lon, time) data arrive as (time,), not
    broadcast over lat and lon: 12 groups, the kernels' group count, where
    the reference factorizes one group per (row, month)."""
    from flox_tpu_torch import core

    seen = []
    real = core.groupby_reduce

    def spy(array, *by, **kw):
        seen.append([np.shape(b) for b in by])
        return real(array, *by, **kw)

    monkeypatch.setattr(core, "groupby_reduce", spy)
    da, by = _three_d(pxl)
    out = flox_tpu_torch.xarray_reduce(da, *by, func="nanmean", device="cpu")
    assert seen == [[(NT,)]]
    assert out.dims == ("lat", "lon", "month")
    # and the offset path stays for a grouper that varies along a kept dim
    seen.clear()
    da, by = _two_d_grouper(pxl)
    flox_tpu_torch.xarray_reduce(da, *by, func="nanmean", dim="time", device="cpu")
    assert seen == [[(3, NT)]]


def test_months_equal_groupby_reduce_bit_for_bit():
    data = _data((3, 4, NT), seed=6, dtype=np.float32)
    da = pxl.DataArray(torch.from_numpy(data), dims=("lat", "lon", "time"),
                       coords={"month": ("time", MONTHS)})
    got = flox_tpu_torch.xarray_reduce(da, "month", func="nanmean", device="cpu")
    want, _ = flox_tpu_torch.groupby_reduce(torch.from_numpy(data.reshape(12, NT)), MONTHS,
                                            func="nanmean", device="cpu")
    assert torch.equal(got.data, want.reshape(3, 4, 12))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flox_tpu_torch.xarray_reduce(_da(pxl, _data()), "month", func="mean")
    with pytest.raises(RuntimeError, match="CUDA"):
        flox_tpu_torch.xarray_reduce(_da(pxl, _data()), "month", func="mean", dim="lat")


@pytest.mark.parametrize("fn,args", [
    (rechunk_for_blockwise, ("time", MONTHS)),
    (rechunk_for_cohorts, ("time", MONTHS, [0])),
])
def test_rechunk_wrappers_name_roadmap_item(fn, args):
    with pytest.raises(NotImplementedError, match="A7"):
        fn(_da(pxl, _data()), *args)


def test_without_pandas_bins_are_the_coordinate():
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, torch, flox_tpu_torch\n"
        "from flox_tpu_torch import xrlite\n"
        "from flox_tpu_torch.types import Bins\n"
        "da = xrlite.DataArray(torch.arange(12.0).reshape(3, 4), dims=('lat', 'time'),\n"
        "                      coords={'lat': np.array([10.0, 20.0, 30.0]),\n"
        "                              'month': ('time', np.array([0, 1, 0, 1]))})\n"
        "out = flox_tpu_torch.xarray_reduce(da, 'month', func='nanmean', device='cpu')\n"
        "assert out.dims == ('lat', 'month') and out.data.tolist()[0] == [1.0, 2.0], out.data\n"
        "b = flox_tpu_torch.xarray_reduce(da, 'lat', func='sum', isbin=True,\n"
        "    expected_groups=np.array([0.0, 15.0, 35.0]), device='cpu')\n"
        "c = b['lat_bins'].data\n"
        "assert isinstance(c, Bins) and c.closed == 'right' and c.edges.tolist() == [0, 15, 35]\n"
        "assert b.data.tolist() == [[0.0, 1.0, 2.0, 3.0], [12.0, 14.0, 16.0, 18.0]], b.data\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flox_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


class TestXrlite:
    """xrlite's own semantics, the subset the adapter relies on, in both
    packages."""

    @pytest.mark.parametrize("xl", [rxl, pxl], ids=["ref", "port"])
    def test_broadcast(self, xl):
        a = xl.DataArray(np.arange(3.0), dims=("x",))
        b = xl.DataArray(np.arange(4.0), dims=("y",))
        a2, b2 = xl.broadcast(a, b)
        assert a2.dims == b2.dims == ("x", "y")
        assert a2.shape == b2.shape == (3, 4)
        np.testing.assert_array_equal(a2.values,
                                      np.broadcast_to(np.arange(3.0)[:, None], (3, 4)))

    def test_transpose_and_expand(self):
        for data in (np.arange(6.0).reshape(2, 3), torch.arange(6.0).reshape(2, 3)):
            a = pxl.DataArray(data, dims=("x", "y"))
            t = a.transpose("y", "x")
            assert t.shape == (3, 2)
            e = a.expand_dims({"z": 4})
            assert e.dims == ("z", "x", "y") and e.shape == (4, 2, 3)
            ref = rxl.DataArray(np.arange(6.0).reshape(2, 3), dims=("x", "y"))
            np.testing.assert_array_equal(t.values, ref.transpose("y", "x").values)
            np.testing.assert_array_equal(e.values, ref.expand_dims({"z": 4}).values)

    def test_apply_ufunc_core_dims(self):
        a = pxl.DataArray(np.ones((2, 5)), dims=("x", "t"),
                          coords={"x": np.array([1.0, 2.0])}, attrs={"u": 1})
        out = pxl.apply_ufunc(lambda arr: arr.sum(-1, keepdims=True) * np.ones((1, 3)), a,
                              input_core_dims=[["t"]], output_core_dims=[["g"]])
        assert out.dims == ("x", "g") and out.shape == (2, 3)
        assert out.attrs == {"u": 1}
        assert "x" in out._coords

    def test_dataset_roundtrip(self):
        ds = pxl.Dataset({"v": pxl.DataArray(np.arange(4.0), dims=("t",),
                                             coords={"t": np.arange(4)})})
        assert "t" in ds["v"]._coords
        ds["w"] = pxl.DataArray(torch.zeros(4), dims=("t",))
        assert set(ds.data_vars) == {"v", "w"}
        assert ds.dims == {"t": 4}

    def test_conflicting_sizes_raise(self):
        a = pxl.DataArray(np.zeros(3), dims=("x",))
        b = pxl.DataArray(np.zeros(4), dims=("x",))
        with pytest.raises(ValueError, match="conflicting"):
            pxl.broadcast(a, b)

    def test_tensor_data_stays_tensor(self):
        """The counterpart of the reference's test_jax_data_stays_device: a
        tensor stays a tensor, without a copy, through the labeled ops."""
        data = torch.arange(6.0).reshape(2, 3)
        a = pxl.DataArray(data, dims=("x", "y"), coords={"x": np.arange(2)}, name="a")
        for out in (a.transpose("y", "x"), a.expand_dims({"z": 4}), a.rename("b"), a.copy(),
                    a.assign_coords({"y": np.arange(3)}), a.drop_vars("x")):
            assert isinstance(out.data, torch.Tensor)
            assert out.data.data_ptr() == data.data_ptr()
        assert a.expand_dims({"z": 4}).data.stride()[0] == 0  # a broadcast view
        sel = a.isel(y=slice(1, 3))
        assert isinstance(sel.data, torch.Tensor)
        assert sel.data.untyped_storage().data_ptr() == data.untyped_storage().data_ptr()
        assert isinstance(a.values, np.ndarray)

    @pytest.mark.parametrize("kind", ["numpy", "tensor"])
    def test_isel(self, kind):
        """Positional selection, orthogonal over dims, coords selected
        alike: numpy indexing dim by dim is the oracle."""
        base = np.arange(24.0).reshape(2, 3, 4)
        data = torch.from_numpy(base) if kind == "tensor" else base
        a = pxl.DataArray(data, dims=("x", "y", "t"),
                          coords={"t": np.arange(4) * 10, "x": np.array([1.0, 2.0])})
        b = a.isel(t=slice(1, 3), x=1)
        assert b.dims == ("y", "t")
        np.testing.assert_array_equal(b.values, base[1, :, 1:3])
        np.testing.assert_array_equal(b["t"].data, [10, 20])
        assert b._coords["x"][0] == () and float(b._coords["x"][1]) == 2.0
        c = a.isel({"y": np.array([2, 0]), "t": [3, 1, 0]})
        assert c.dims == ("x", "y", "t")
        np.testing.assert_array_equal(c.values, base[:, [2, 0], :][:, :, [3, 1, 0]])
        np.testing.assert_array_equal(c["t"].data, [30, 10, 0])
        with pytest.raises(ValueError, match="not in"):
            a.isel(z=0)

    def test_bins_coordinate(self):
        bins = Bins(np.array([0.0, 1.0, 3.0]), closed="left")
        a = pxl.DataArray(np.zeros(2), dims=("b",), coords={"b": bins})
        assert a["b"].data is bins
