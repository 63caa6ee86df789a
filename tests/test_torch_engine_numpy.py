"""The port's host engine (flox_tpu_torch.engine_numpy) against flox_tpu's,
on the CPU: kernel by kernel on the same seeded numpy inputs, then through
``groupby_reduce``, ``groupby_aggregate_many`` and ``groupby_scan`` with
``engine="numpy"`` and with ``set_options(default_engine="numpy")``, whose
results must be tensors on the call's device.

The port's engine is a copy of the reference's, so kernel results must be
identical: compared exactly (NaN equal to NaN). Through the entry points, the
port's finalize runs in torch where the reference's runs in numpy:
``rtol=1e-12, atol=1e-14`` for float64, exactly for integers and extrema.
"""

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import engine_numpy as ref_engine

import flox_tpu_torch
from flox_tpu_torch import engine_numpy as port_engine
from flox_tpu_torch.multiarray import MultiArray
from flox_tpu_torch.options import OPTIONS, from_reference

RNG = np.random.default_rng(7)

FUNCS = [
    "sum", "nansum", "prod", "nanprod", "max", "nanmax", "min", "nanmin",
    "mean", "nanmean", "var", "nanvar", "std", "nanstd", "nanlen", "len",
    "all", "any", "argmax", "argmin", "nanargmax", "nanargmin",
    "first", "last", "nanfirst", "nanlast", "median", "nanmedian",
    "mode", "nanmode", "sum_of_squares", "nansum_of_squares",
    "cumsum", "nancumsum", "ffill", "bfill",
]


@pytest.fixture(params=["1d", "2d", "nan", "nan-labels"])
def case(request):
    n, size = 41, 4
    codes = RNG.integers(0, size, n).astype(np.int64)
    values = np.round(RNG.normal(size=(n,)), 1)
    if request.param == "2d":
        values = np.round(RNG.normal(size=(2, n)), 1)
    elif request.param == "nan":
        values[RNG.random(n) < 0.3] = np.nan
    elif request.param == "nan-labels":
        codes[RNG.random(n) < 0.2] = -1
    return values, codes, size


@pytest.mark.parametrize("func", FUNCS)
def test_kernel_parity(case, func):
    values, codes, size = case
    kwargs = dict(size=size, fill_value=np.nan)
    if func in ("argmax", "argmin", "nanargmax", "nanargmin"):
        kwargs["fill_value"] = -1
    if func in ("all", "any"):
        kwargs["fill_value"] = None
    a = ref_engine.generic_kernel(func, codes, values, **kwargs)
    b = port_engine.generic_kernel(func, codes, values, **kwargs)
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("q", [0.25, [0.1, 0.9]])
def test_kernel_parity_quantile(case, q):
    values, codes, size = case
    a = ref_engine.generic_kernel("nanquantile", codes, values, size=size, q=q)
    b = port_engine.generic_kernel("nanquantile", codes, values, size=size, q=q)
    np.testing.assert_array_equal(b, a)


def test_kernel_parity_var_chunk(case):
    values, codes, size = case
    a = ref_engine.generic_kernel("var_chunk", codes, values, size=size)
    b = port_engine.generic_kernel("var_chunk", codes, values, size=size)
    assert isinstance(b, MultiArray)
    for x, y in zip(a.arrays, b.arrays):
        np.testing.assert_array_equal(y, x)


def test_complex_dtype_parity():
    vals = np.array([1 + 2j, 3 - 1j, np.nan + 0j, 2 + 2j])
    codes = np.array([0, 0, 1, 1])
    for func in ["sum", "nansum", "mean", "nanmean", "count", "first", "last",
                 "nanfirst", "nanlast"]:
        a = ref_engine.generic_kernel(func, codes, vals, size=2)
        b = port_engine.generic_kernel(func, codes, vals, size=2)
        np.testing.assert_array_equal(b, a, err_msg=func)


@pytest.mark.parametrize("func", ["nanmean", "nansum", "nanvar", "nanstd", "nancumsum"])
def test_f16_accumulation(func):
    x, z = np.linspace(0, 1, 2000).astype(np.float16), np.zeros(2000, np.int64)
    a = ref_engine.generic_kernel(func, z, x, size=1)
    b = port_engine.generic_kernel(func, z, x, size=1)
    assert b.dtype == np.float16
    np.testing.assert_array_equal(b, a)


def test_unknown_kernel_raises():
    with pytest.raises(NotImplementedError, match="numpy engine"):
        port_engine.generic_kernel("nosuch", np.zeros(2, np.int64), np.ones(2), size=1)


# ---------------------------------------------------------------------------
# through the entry points
# ---------------------------------------------------------------------------

REDUCE_FUNCS = ["sum", "nanmean", "nanvar", "count", "nanmax", "argmin", "nanfirst",
                "nanmedian", "mode", "all"]


def _inputs(dtype):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(3, 50))
    if dtype == "int32":
        data = rng.integers(-9, 9, (3, 50)).astype(np.int32)
    else:
        data = data.astype(dtype)
        data[rng.random(data.shape) < 0.15] = np.nan
    labels = rng.integers(0, 6, 50).astype(np.float64)
    labels[labels == 4] = 0
    labels[rng.random(50) < 0.1] = np.nan
    return data, labels


def _close(got: torch.Tensor, ref, exact=False):
    ref = np.asarray(ref)
    g = got.numpy()
    assert g.dtype == ref.dtype and g.shape == ref.shape, (g.dtype, ref.dtype)
    if exact or ref.dtype.kind in "iub":
        np.testing.assert_array_equal(g, ref)
    else:
        np.testing.assert_allclose(g, ref, rtol=1e-12, atol=1e-14, equal_nan=True)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
@pytest.mark.parametrize("func", REDUCE_FUNCS)
def test_groupby_reduce_numpy_engine(func, dtype):
    data, labels = _inputs(dtype)
    kw = dict(func=func, expected_groups=np.arange(6.0), fill_value=None)
    ref, rgroups = flox_tpu.groupby_reduce(data, labels, engine="numpy", **kw)
    got, pgroups = flox_tpu_torch.groupby_reduce(data, labels, engine="numpy", device="cpu", **kw)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(pgroups, np.asarray(rgroups))
    _close(got, ref, exact=func in ("nanmax", "argmin", "nanfirst", "mode", "count"))


def test_groupby_reduce_numpy_engine_datetime_and_min_count():
    t = np.array(["2020-01-01", "NaT", "2020-01-03", "2020-01-02"], dtype="datetime64[ns]")
    labels = np.array([0, 0, 1, 1])
    ref, _ = flox_tpu.groupby_reduce(t, labels, func="nanmax", engine="numpy")
    got, _ = flox_tpu_torch.groupby_reduce(t, labels, func="nanmax", engine="numpy",
                                           device="cpu")
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.view("int64"), np.asarray(ref).view("int64"))
    data, labels = _inputs("float64")
    ref, _ = flox_tpu.groupby_reduce(data, labels, func="nansum", min_count=8, engine="numpy")
    got, _ = flox_tpu_torch.groupby_reduce(data, labels, func="nansum", min_count=8,
                                           engine="numpy", device="cpu")
    _close(got, ref)


def test_default_engine_option_and_from_reference():
    data, labels = _inputs("float64")
    assert from_reference({"default_engine": "numpy"}) == {"default_engine": "numpy"}
    ref, _ = flox_tpu.groupby_reduce(data, labels, func="nanstd", engine="numpy")
    with flox_tpu_torch.set_options(default_engine="numpy"):
        assert OPTIONS["default_engine"] == "numpy"
        got, _ = flox_tpu_torch.groupby_reduce(data, labels, func="nanstd", device="cpu")
    _close(got, ref)


def test_numpy_engine_reduces_on_the_host(monkeypatch):
    """engine="numpy" never reaches the torch engine's kernels."""
    from flox_tpu_torch import kernels

    monkeypatch.setattr(kernels, "generic_kernel", lambda *a, **k: pytest.fail("torch engine"))
    data, labels = _inputs("float32")
    out, _ = flox_tpu_torch.groupby_reduce(torch.from_numpy(data), labels, func="nanmean",
                                           engine="numpy", device="cpu")
    assert out.dtype == torch.float32


@pytest.mark.parametrize("funcs", [("nanmean", "nanmin", "nanmax"),
                                   ("count", "nanmean", "nanstd", "sum")],
                         ids=lambda f: "+".join(f))
def test_aggregate_many_numpy_engine(funcs):
    data, labels = _inputs("float64")
    ref, _ = flox_tpu.groupby_aggregate_many(data, labels, funcs=funcs, engine="numpy")
    got, _ = flox_tpu_torch.groupby_aggregate_many(data, labels, funcs=funcs, engine="numpy",
                                                   device="cpu")
    assert tuple(got) == funcs
    for f in funcs:
        _close(got[f], ref[f], exact=f in ("nanmin", "nanmax", "count"))


@pytest.mark.parametrize("func", ["cumsum", "nancumsum", "ffill", "bfill"])
def test_scan_numpy_engine(func):
    data, labels = _inputs("float64")
    ref = flox_tpu.groupby_scan(data, labels, func=func, engine="numpy")
    got = flox_tpu_torch.groupby_scan(data, labels, func=func, engine="numpy", device="cpu")
    assert isinstance(got, torch.Tensor)
    _close(got, ref, exact=func in ("ffill", "bfill"))
