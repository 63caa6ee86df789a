"""Datetime64, timedelta64, bool and string inputs of the port
(flox_tpu_torch) against flox_tpu's, on the CPU.

Datetimes reduce on their exact int64 view with NaT (INT64_MIN) as the
missing marker, or through float64 with NaT as NaN where the result is a
float; they come back as numpy arrays of their dtype, as the reference's do.
String and object data reduce through float64 positions and a host gather.
The reference runs with ``engine="jax"`` under the Pallas options, the port
with ``device="cpu"`` under the same options carried across. Every result
here is exact: the reference's own datetime, bool and string paths are.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import options as ref_options
import flox_tpu_torch
from flox_tpu_torch.options import from_reference

REPO = Path(__file__).resolve().parent.parent
PALLAS = dict(segment_sum_impl="pallas", segment_minmax_impl="pallas")


def _opts():
    with flox_tpu.set_options(**PALLAS):
        return from_reference(dict(ref_options.OPTIONS))


def _both(data, *by, **kw):
    with flox_tpu.set_options(**PALLAS):
        ref, *rgroups = flox_tpu.groupby_reduce(data, *by, **{"engine": "jax", **kw})
    with flox_tpu_torch.set_options(**_opts()):
        got, *pgroups = flox_tpu_torch.groupby_reduce(data, *by, device="cpu", **kw)
    for p, r in zip(pgroups, rgroups):
        np.testing.assert_array_equal(p, r)
    return got, np.asarray(ref)


def _host(got):
    return got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)


def _same(got, ref):
    """Exact equality of dtype, shape and values (NaT == NaT, NaN == NaN)."""
    got = _host(got)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    if got.dtype.kind in "mM":
        np.testing.assert_array_equal(got.view("int64"), ref.view("int64"))
    elif got.dtype.kind == "O":
        assert got.tolist() == ref.tolist()
    else:
        np.testing.assert_array_equal(got, ref)


def _times(kind):
    """30 datetimes (or timedeltas) at nanosecond resolution with NaT, over
    labels 0..3 whose group 2 holds only NaT."""
    rng = np.random.default_rng(0 if kind == "M" else 1)
    if kind == "M":
        arr = np.datetime64("2020-01-01T00:00:00", "ns") + rng.integers(
            0, 10**15, 30).astype("timedelta64[ns]")
    else:
        arr = rng.integers(-10**12, 10**12, 30).astype("timedelta64[ns]")
    labels = rng.integers(0, 4, 30)
    labels[labels == 2] = 1
    labels[[3, 11]] = 2
    arr[[1, 3, 11, 17]] = np.datetime64("NaT") if kind == "M" else np.timedelta64("NaT")
    return arr, labels


DT_FUNCS = ["min", "max", "nanmin", "nanmax", "first", "last", "nanfirst", "nanlast",
            "mean", "nanmean", "median", "nanmedian", "count", "argmax", "nanargmin",
            "mode", "nanmode", "var", "nanstd"]


@pytest.mark.parametrize(
    "kind,func",
    # sums of points in time are undefined: timedeltas only
    [("M", f) for f in DT_FUNCS + ["quantile"]]
    + [("m", f) for f in DT_FUNCS + ["quantile", "sum", "nansum"]],
)
def test_datetime_reductions(kind, func):
    arr, labels = _times(kind)
    kw = {"finalize_kwargs": {"q": [0.25, 0.5]}} if func == "quantile" else {}
    got, ref = _both(arr, labels, func=func, expected_groups=np.arange(5), **kw)
    _same(got, ref)


@pytest.mark.parametrize("func", ["nanmax", "min", "nanfirst", "last", "nanmode"])
@pytest.mark.parametrize("kind", ["M", "m"])
def test_datetime_explicit_nat_fill(kind, func):
    arr, labels = _times(kind)
    fill = np.datetime64("NaT", "ns") if kind == "M" else np.timedelta64("NaT", "ns")
    got, ref = _both(arr, labels, func=func, expected_groups=np.arange(6), fill_value=fill)
    _same(got, ref)


@pytest.mark.parametrize("func", ["nanmax", "nanmedian", "nanargmax", "first"])
def test_datetime_two_dimensional_and_sort_engine(func):
    arr, labels = _times("M")
    data = np.stack([arr, arr[::-1]])
    got, ref = _both(data, labels, func=func)
    _same(got, ref)
    sparse = labels * 1000 + 3
    got, ref = _both(data, sparse, func=func, expected_groups=np.arange(4000), engine="sort")
    _same(got, ref)


SCANS = ["cumsum", "nancumsum", "ffill", "bfill"]


@pytest.mark.parametrize("func", SCANS)
@pytest.mark.parametrize("kind", ["M", "m"])
def test_datetime_scans(kind, func):
    arr, labels = _times(kind)
    labels = labels.astype(np.float64)
    labels[5] = np.nan  # a missing label scans to NaT
    data = np.stack([arr, arr[::-1]])
    if kind == "M" and func in ("cumsum", "nancumsum"):
        for pkg, kw in ((flox_tpu, {"engine": "jax"}), (flox_tpu_torch, {"device": "cpu"})):
            with pytest.raises(TypeError, match="cumsum of datetime64"):
                pkg.groupby_scan(data, labels, func=func, **kw)
        return
    ref = np.asarray(flox_tpu.groupby_scan(data, labels, func=func, engine="jax"))
    got = flox_tpu_torch.groupby_scan(data, labels, func=func, device="cpu")
    _same(got, ref)


def test_datetime_scan_dtype_request_raises():
    arr, labels = _times("m")
    with pytest.raises(TypeError, match="dtype= is not supported"):
        flox_tpu_torch.groupby_scan(arr, labels, func="cumsum", dtype=np.float64, device="cpu")


BOOL_FUNCS = ["sum", "nansum", "prod", "count", "mean", "var", "max", "min", "any", "all",
              "first", "nanlast", "argmax", "nanargmin", "median", "mode"]


@pytest.mark.parametrize("func", BOOL_FUNCS)
def test_bool_reductions(func):
    """bool data: sum/prod/count on the int64 view, the others as bools (max
    and min of bools raised in the port before: ROADMAP C2)."""
    rng = np.random.default_rng(2)
    data = rng.random((2, 40)) < 0.4
    labels = rng.integers(0, 4, 40)
    got, ref = _both(data, labels, func=func, expected_groups=np.arange(5))
    _same(got, ref)


def _strings(kind):
    if kind == "object":
        data = np.array([f"s{i}" for i in range(24)], dtype=object)
        data[[0, 5, 6, 13]] = None
        data[7] = np.nan
    else:
        data = np.array([f"u{i}" for i in range(24)])
    labels = np.arange(24) % 4
    labels[[0, 4]] = 2
    return data, labels


@pytest.mark.parametrize("func", ["first", "last", "nanfirst", "nanlast", "count"])
@pytest.mark.parametrize("kind", ["object", "unicode"])
def test_string_reductions(kind, func):
    data, labels = _strings(kind)
    got, ref = _both(data, labels, func=func, expected_groups=np.arange(5))
    _same(got, ref)


def test_string_fill_and_two_dimensional():
    data, labels = _strings("object")
    data2 = np.stack([data, data[::-1]])
    got, ref = _both(data2, labels, func="nanlast", expected_groups=np.arange(6),
                     fill_value="none")
    _same(got, ref)


@pytest.mark.parametrize("kw,err", [
    ({"func": "sum"}, TypeError),
    ({"func": "first", "dtype": np.float64}, TypeError),
    ({"func": "first", "finalize_kwargs": {"q": 0.5}}, NotImplementedError),
])
def test_string_guards(kw, err):
    data, labels = _strings("unicode")
    with pytest.raises(err):
        flox_tpu_torch.groupby_reduce(data, labels, device="cpu", **kw)


def test_object_nulls_without_pandas():
    """The port's ``pd.isna`` for object arrays, without pandas: None, float
    NaN (numpy's too), NaT, pandas' NaT and NA."""
    import pandas as pd

    from flox_tpu_torch.utils import isnull_host

    data = np.array([None, np.nan, np.float32("nan"), np.datetime64("NaT"), pd.NaT, pd.NA,
                     "x", 1, 0.0, np.datetime64("2020-01-01")], dtype=object)
    np.testing.assert_array_equal(isnull_host(data), pd.isna(data))


def test_fresh_process_imports_no_jax_reference_or_pandas():
    """Importing the port and running a datetime, a string and a quantile
    reduction imports neither jax, flox_tpu nor pandas."""
    code = (
        "import sys\n"
        "import numpy as np, flox_tpu_torch\n"
        "t = np.array(['2020-01-01', 'NaT', '2020-01-03'], dtype='datetime64[ns]')\n"
        "out, _ = flox_tpu_torch.groupby_reduce(t, np.array([0, 0, 1]), func='nanmax',"
        " device='cpu')\n"
        "assert out.dtype == t.dtype, out\n"
        "s, _ = flox_tpu_torch.groupby_reduce(np.array(['a', 'b', 'c']), np.array([0, 0, 1]),"
        " func='last', device='cpu')\n"
        "assert s.tolist() == ['b', 'c'], s\n"
        "q, _ = flox_tpu_torch.groupby_reduce(np.arange(4.0), np.array([0, 1, 0, 1]),"
        " func='nanquantile', finalize_kwargs={'q': [0.5]}, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flox_tpu', 'pandas')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
