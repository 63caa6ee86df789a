"""The port's argreductions, first/last, quantile/median (by sort and by radix
select) and mode (flox_tpu_torch) against flox_tpu's, on the CPU.

The reference runs with ``engine="jax"`` under
``set_options(segment_sum_impl="pallas", segment_minmax_impl="pallas")``, so
the grouped min/max of positions and run lengths and the select path's
counting sums reach the Pallas kernels, in interpret mode. The port runs with
``device="cpu"`` under the same option set carried across
(``options.from_reference``), where its kernel wrappers run their plain
versions. Inputs are numpy arrays made from a seed.

Bars:
* integer results, positions and extremes: exact;
* order statistics that select an element (lower, higher, nearest, mode,
  first/last): exact;
* order statistics that interpolate in float32: within 1e-6 of the scale of
  the interpolated values (the data's largest magnitude) plus 1e-6 relative:
  the two sides may round ``v_lo + frac (v_hi - v_lo)`` differently once,
  and a result that cancels to near 0 has no relative bar;
* the port's sort and select paths: bit for bit on data without tied zeros
  of both signs (the select path orders -0.0 below +0.0, the sort path ties
  them, as in the reference).
"""

import functools

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import kernels as ref_kernels
from flox_tpu import options as ref_options
import flox_tpu_torch
from flox_tpu_torch import aggregations as pagg
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import kernels as pk
from flox_tpu_torch.options import from_reference

PALLAS = dict(segment_sum_impl="pallas", segment_minmax_impl="pallas")
ARG_FUNCS = ["argmax", "argmin", "nanargmax", "nanargmin"]
FIRSTLAST_FUNCS = ["first", "last", "nanfirst", "nanlast"]
ORDER_FUNCS = ["median", "nanmedian", "quantile", "nanquantile"]
METHODS = ["linear", "hazen", "weibull", "interpolated_inverted_cdf", "median_unbiased",
           "normal_unbiased", "lower", "higher", "nearest", "midpoint"]
SELECTING = {"lower", "higher", "nearest"}
QS = (0.0, 0.1, 0.3, 0.5, 0.9, 1.0)
EXPECTED = np.arange(6.0)  # label 3 never occurs and 5 is past the labels


def _data(seed, shape=(3, 80), nan=0.15):
    """float32 normal data with NaNs, ±inf, a group-wide NaN column block and
    one row that is NaN throughout (an all-NaN group in every group)."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(np.float32)
    data[rng.random(shape) < nan] = np.nan
    flat = data.reshape(-1, shape[-1])
    flat[0, 3] = np.inf
    flat[-1, 9] = -np.inf
    flat[-1] = np.nan
    return data


def _labels(seed, n=80):
    """Labels 0..4 with 3 absent, some NaN (missing), and label 4 held by
    NaN data only in row 0 (see :func:`_data_allnan_group`)."""
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, 5, n).astype(np.float64)
    labels[labels == 3] = 0
    labels[rng.random(n) < 0.08] = np.nan
    return labels


def _data_allnan_group(seed):
    data = _data(seed)
    data[0, _labels(seed) == 4] = np.nan  # group 4 of row 0 holds only NaN
    return data


def _ref(data, *by, **kw):
    with flox_tpu.set_options(**PALLAS, quantile_impl=kw.pop("impl", "auto")):
        ref, *groups = flox_tpu.groupby_reduce(data, *by, **{"engine": "jax", **kw})
    return np.asarray(ref), groups


def _port(data, *by, impl="auto", **kw):
    with flox_tpu.set_options(**PALLAS, quantile_impl=impl):
        opts = from_reference(dict(ref_options.OPTIONS))
    port_in = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    with flox_tpu_torch.set_options(**opts):
        got, *groups = flox_tpu_torch.groupby_reduce(port_in, *by, device="cpu", **kw)
    return got, groups


def _same_dtype_shape(got: torch.Tensor, ref: np.ndarray):
    assert got.device.type == "cpu"
    assert str(got.dtype).removeprefix("torch.") == ref.dtype.name, (got.dtype, ref.dtype)
    assert tuple(got.shape) == ref.shape


def _exact(got: torch.Tensor, ref: np.ndarray):
    _same_dtype_shape(got, ref)
    np.testing.assert_array_equal(got.numpy(), ref)


def _interp_close(got: torch.Tensor, ref: np.ndarray, scale: float):
    _same_dtype_shape(got, ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * scale, equal_nan=True)


def _scale(data) -> float:
    finite = np.abs(data[np.isfinite(data)])
    return float(finite.max()) if finite.size else 1.0


# ---------------------------------------------------------------------------
# argreductions and first/last
# ---------------------------------------------------------------------------

CASES = {
    "plain": {},
    "expected_groups": {"expected_groups": EXPECTED},
    "fill_value": {"expected_groups": EXPECTED, "fill_value": -7},
    "nan_fill": {"expected_groups": EXPECTED, "fill_value": np.nan},
    "min_count": {"min_count": 3},
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("func", ARG_FUNCS + FIRSTLAST_FUNCS)
def test_positional_sweep(func, case):
    data = _data_allnan_group(0)
    labels = _labels(0)
    ref, rg = _ref(data, labels, func=func, **CASES[case])
    got, pg = _port(data, labels, func=func, **CASES[case])
    _exact(got, ref)
    np.testing.assert_array_equal(pg[0], rg[0])


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.float64])
@pytest.mark.parametrize("func", ["argmax", "nanargmin", "first", "nanlast", "mode", "nanmedian"])
def test_other_dtypes(func, dtype):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 7, size=(2, 50)).astype(dtype)
    labels = rng.integers(0, 4, 50)
    ref, _ = _ref(data, labels, func=func, expected_groups=np.arange(5))
    got, _ = _port(data, labels, func=func, expected_groups=np.arange(5))
    _exact(got, ref)


def test_argreduction_ties_and_infinities():
    """numpy's rules: the first of tied extremes wins; without skipna the
    first NaN wins outright, over a group's ±inf too."""
    data = np.array([[1.0, 3.0, 3.0, np.inf, np.nan, 2.0, np.nan, -np.inf]], np.float32)
    labels = np.array([0, 0, 0, 1, 1, 2, 2, 2])
    for func in ARG_FUNCS:
        ref, _ = _ref(data, labels, func=func)
        got, _ = _port(data, labels, func=func)
        _exact(got, ref)
    got, _ = _port(data, labels, func="argmax")
    assert got.tolist() == [[1, 4, 6]]


def test_positions_reach_the_segment_minmax_kernel_in_int32(monkeypatch):
    """On the card the argreductions, first/last and mode take grouped min/max
    of int32 positions and run lengths: the segment-min/max kernel's int32
    instance (nanargmax 2 calls, argmin 3, nanfirst 1, mode 2)."""
    calls = []
    real = ck.segment_minmax

    def spy(data, codes, size, op):
        calls.append((str(data.dtype).removeprefix("torch."), op))
        return real(data, codes, size, op)

    monkeypatch.setattr(ck, "segment_minmax", spy)
    data = torch.from_numpy(_data(1))
    labels = np.arange(80) % 12
    want = {
        "nanargmax": [("float32", "max"), ("int32", "min")],
        "argmin": [("float32", "min"), ("int32", "min"), ("int32", "min")],
        "nanfirst": [("int32", "min")],
        "nanlast": [("int32", "max")],
        "mode": [("int32", "max"), ("int32", "min")],
    }
    for func, expect in want.items():
        calls.clear()
        flox_tpu_torch.groupby_reduce(data, labels, func=func, device="cpu")
        assert calls == expect, (func, calls)


# ---------------------------------------------------------------------------
# quantile, median: the sort and the select path
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_quantiles(func: str, method: str):
    """The reference's (sort path) quantiles at every q of :data:`QS`."""
    ref, _ = _ref(_data(2), _labels(2), func=func, expected_groups=EXPECTED,
                  finalize_kwargs={"q": list(QS), "method": method})
    return ref


@pytest.mark.parametrize("impl", ["sort", "select"])
@pytest.mark.parametrize("q_kind", ["scalar", "vector"])
@pytest.mark.parametrize("func", ["quantile", "nanquantile"])
@pytest.mark.parametrize("method", METHODS)
def test_quantile_methods(method, func, q_kind, impl):
    """Every method, scalar and vector q, both paths, against the reference's
    values at the same q (a scalar q is one row of the vector call)."""
    ref = _ref_quantiles(func, method)
    q = 0.3 if q_kind == "scalar" else list(QS)
    got, _ = _port(_data(2), _labels(2), func=func, expected_groups=EXPECTED, impl=impl,
                   finalize_kwargs={"q": q, "method": method})
    want = ref[QS.index(0.3)] if q_kind == "scalar" else ref
    if method in SELECTING:
        _exact(got, want)
    else:
        _interp_close(got, want, _scale(_data(2)))


@pytest.mark.parametrize("impl", ["sort", "select"])
@pytest.mark.parametrize("func", ORDER_FUNCS)
def test_order_statistics_against_reference_path(func, impl):
    """Each function against the reference's own path of the same name, with
    fill_value and an all-NaN group."""
    kw = {"finalize_kwargs": {"q": [0.25, 0.75]}} if "quantile" in func else {}
    data, labels = _data_allnan_group(4), _labels(4)
    ref, _ = _ref(data, labels, func=func, expected_groups=EXPECTED, fill_value=-9.0,
                  impl=impl, **kw)
    got, _ = _port(data, labels, func=func, expected_groups=EXPECTED, fill_value=-9.0,
                   impl=impl, **kw)
    _interp_close(got, ref, _scale(data))


@pytest.mark.parametrize("method", METHODS)
def test_sort_equals_select_bit_for_bit(method):
    """The reference's ``test_radix_select_equals_sort`` property, on the
    port: both paths select the same elements and interpolate alike."""
    data = _data(5, shape=(4, 120))
    kw = dict(func="nanquantile", expected_groups=EXPECTED,
              finalize_kwargs={"q": list(QS), "method": method})
    by_sort, _ = _port(data, _labels(5, 120), impl="sort", **kw)
    by_select, _ = _port(data, _labels(5, 120), impl="select", **kw)
    np.testing.assert_array_equal(by_sort.view(torch.int32).numpy(),
                                  by_select.view(torch.int32).numpy())


def _signed_zero_data():
    neg_nan = np.frombuffer(np.uint32(0xFFC00001).tobytes(), np.float32)[0]
    data = np.array([[0.0, -0.0, 1.0, np.nan, -0.0, neg_nan, -1.0, 0.0, 2.0, -0.0],
                     [-0.0, 0.0, np.nan, neg_nan, 0.0, -0.0, -0.0, 3.0, np.nan, 1.0]],
                    np.float32)
    return data, np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2])


@pytest.mark.parametrize("impl", ["sort", "select"])
@pytest.mark.parametrize("method", ["lower", "higher", "nearest", "linear"])
def test_signed_zeros_and_nans_follow_the_reference_path(method, impl):
    """±0.0 and ±NaN: the sort path ties -0.0 with +0.0 and keeps column
    order, the select path orders -0.0 first; each bit for bit the
    reference's path of the same name."""
    data, labels = _signed_zero_data()
    kw = dict(func="nanquantile", finalize_kwargs={"q": [0.0, 0.3, 0.5, 1.0], "method": method})
    ref, _ = _ref(data, labels, impl=impl, **kw)
    got, _ = _port(data, labels, impl=impl, **kw)
    _same_dtype_shape(got, ref)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), ref.view(np.int32))


@pytest.mark.parametrize("func", ["mode", "nanmode", "argmax", "nanargmin", "first", "nanlast",
                                  "median"])
def test_signed_zeros_and_nans(func):
    data, labels = _signed_zero_data()
    ref, _ = _ref(data, labels, func=func)
    got, _ = _port(data, labels, func=func)
    _same_dtype_shape(got, ref)
    if got.dtype == torch.float32:
        got_bits, ref_bits = got.view(torch.int32).numpy(), ref.view(np.int32)
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
        np.testing.assert_array_equal(got_bits[~nan], ref_bits[~nan])
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_unknown_method_and_mesh_axis_raise():
    with pytest.raises(ValueError, match="Unsupported quantile method"):
        _port(_data(0), _labels(0), func="quantile",
              finalize_kwargs={"q": 0.5, "method": "inverted_cdf"})
    # axis_name= takes the collective layer of a mesh program, not a name
    with pytest.raises(TypeError, match="collective layer"):
        pk.quantile(torch.zeros(4, dtype=torch.int64), torch.ones(4), size=1, q=0.5,
                    axis_name="x")
    # on a one-rank mesh the distributed radix select is the whole-axis
    # quantile: the reference's eager value, to this file's interpolation bar
    from flox_tpu_torch.parallel.mesh import collectives, make_mesh

    comm = collectives(make_mesh(device_type="cpu"), "data")
    data, labels = _data(0), _labels(0)
    groups = np.unique(labels[~np.isnan(labels)])
    codes = np.where(np.isnan(labels), -1, np.searchsorted(groups, labels)).astype(np.int64)
    for q in (0.5, [0.1, 0.9]):
        ref, _ = _ref(data, labels, impl="select", func="nanquantile", finalize_kwargs={"q": q})
        got = pk.nanquantile(torch.from_numpy(codes), torch.from_numpy(data), size=len(groups),
                             q=q, axis_name=comm)
        _same_dtype_shape(got, ref)
        _interp_close(got, ref, _scale(data))


# ---------------------------------------------------------------------------
# the select path's pieces against the reference's, bit for bit
# ---------------------------------------------------------------------------

RADIX_DTYPES = ["float32", "float64", "bfloat16", "int8", "int16", "int32", "int64", "uint8"]


def _radix_case(dtype_name, k=3, n=64, size=5, m=4):
    rng = np.random.default_rng(7)
    if dtype_name in ("float32", "float64", "bfloat16"):
        vals = rng.normal(size=(k, n)) * 4
        vals[rng.random((k, n)) < 0.1] = -0.0
        vals[rng.random((k, n)) < 0.1] = 0.0
        vals[rng.random((k, n)) < 0.05] = np.inf
        vals[rng.random((k, n)) < 0.1] = np.nan
    else:
        info = np.iinfo(dtype_name)
        vals = rng.integers(info.min, int(info.max) + 1, size=(k, n), dtype=np.int64)
    codes = rng.integers(-1, size, n)
    return vals, codes, size, rng.integers(0, 40, size=(m, k, size))


@pytest.mark.parametrize("dtype_name", RADIX_DTYPES)
def test_radix_select_bit_for_bit(dtype_name):
    import jax.numpy as jnp

    vals, codes, size, ranks = _radix_case(dtype_name)
    ref_data = jnp.asarray(vals.T).astype(dtype_name)  # the reference's (N, K) layout
    valid = ~jnp.isnan(ref_data) if "float" in dtype_name else None
    nn = np.zeros((size, vals.shape[0]), np.int64)
    np.add.at(nn, codes[codes >= 0], np.asarray(valid if valid is not None else
                                                np.ones(vals.T.shape, bool)).astype(np.int64)
              [codes >= 0])
    ranks = np.minimum(ranks, np.maximum(nn.T[None] - 1, 0))  # ranks among the valid
    ref_codes = ref_kernels._safe_codes(jnp.asarray(codes), size)
    with flox_tpu.set_options(**PALLAS):
        ref = ref_kernels._radix_select(ref_data, ref_codes, size,
                                        jnp.asarray(ranks.transpose(0, 2, 1)), valid)
    ref = np.asarray(ref.astype(jnp.float32) if dtype_name == "bfloat16" else ref)
    port_data = torch.from_numpy(vals.astype(np.float32 if dtype_name == "bfloat16"
                                             else dtype_name))
    port_data = port_data.to(getattr(torch, dtype_name))
    pmask = ~torch.isnan(port_data) if port_data.is_floating_point() else None
    got = pk._radix_select(port_data, pk._safe_codes(torch.from_numpy(codes), size), size,
                           torch.from_numpy(ranks), pmask)
    got = (got.float() if dtype_name == "bfloat16" else got).numpy().transpose(0, 2, 1)
    assert got.dtype == ref.dtype
    if got.dtype.kind == "f":
        nonempty = np.broadcast_to((nn > 0)[None], got.shape)
        np.testing.assert_array_equal(got.view(f"i{got.itemsize}")[nonempty],
                                      ref.view(f"i{ref.itemsize}")[nonempty])
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16", "int32", "int64",
                                        "uint8"])
def test_monotonic_key_round_trip_and_order(dtype_name):
    vals, _codes, _size, _ranks = _radix_case(dtype_name)
    t = torch.from_numpy(vals.astype(np.float32 if dtype_name == "bfloat16" else dtype_name))
    t = t.to(getattr(torch, dtype_name)).reshape(-1)
    key = pk._monotonic_key(t)
    back = pk._key_to_value(key, t.dtype)
    assert torch.equal(back.view(key.dtype), t.view(key.dtype))
    # unsigned order of the key (sign bit flipped into signed order) is the
    # values' order (NaNs go by their sign bit: above +inf or below -inf)
    order = torch.argsort(key ^ pk._bit(8 * key.element_size() - 1, 8 * key.element_size()),
                          stable=True)
    v = t[order].double()
    ok = ~torch.isnan(v)
    assert bool((v[ok][1:] >= v[ok][:-1]).all())


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16", "int32", "int64"])
def test_group_sort_matches_the_reference(dtype_name):
    import jax.numpy as jnp

    vals, codes, size, _ranks = _radix_case(dtype_name)
    ref_data = jnp.asarray(vals.T).astype(dtype_name)
    _sc, _sd, ref_iota = ref_kernels._group_sort(
        ref_kernels._safe_codes(jnp.asarray(codes), size), ref_data)
    port_data = torch.from_numpy(vals.astype(np.float32 if dtype_name == "bfloat16"
                                             else dtype_name)).to(getattr(torch, dtype_name))
    sorted_codes, perm = pk._group_sort(pk._safe_codes(torch.from_numpy(codes), size), port_data)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ref_iota).T)
    np.testing.assert_array_equal(sorted_codes.numpy(), np.asarray(_sc)[:, 0])


def test_row_blocks_give_the_same_result(monkeypatch):
    """Order statistics run over row blocks under a byte budget: a budget of
    one row changes no bit, and the select path counts once per bit per
    block."""
    data, labels = _data(6, shape=(5, 60)), _labels(6, 60)
    kw = dict(func="nanquantile", finalize_kwargs={"q": [0.2, 0.5]})
    whole = {impl: _port(data, labels, impl=impl, **kw)[0] for impl in ("sort", "select")}
    whole_mode = _port(data, labels, func="mode")[0]
    monkeypatch.setattr(pk, "_ORDER_BLOCK_BYTES", 1)
    calls = []
    real = ck.segment_sum

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(ck, "segment_sum", spy)
    for impl in ("sort", "select"):
        got = _port(data, labels, impl=impl, **kw)[0]
        assert torch.equal(got.view(torch.int32), whole[impl].view(torch.int32))
    assert len(calls) == 32 * 5 and all(s == (4, 60) for s in calls)  # 2 q x (lo, hi)
    assert torch.equal(_port(data, labels, func="mode")[0].view(torch.int32),
                       whole_mode.view(torch.int32))


# ---------------------------------------------------------------------------
# mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "fill_value", "many_ties"])
@pytest.mark.parametrize("func", ["mode", "nanmode"])
def test_mode(func, case):
    rng = np.random.default_rng(8)
    data = rng.integers(0, 4 if case == "many_ties" else 6, size=(3, 70)).astype(np.float32)
    data[rng.random(data.shape) < 0.25] = np.nan
    data[0, :30] = np.nan  # NaN is the mode of some groups without skipna
    labels = _labels(8, 70)
    kw = {"expected_groups": EXPECTED, "fill_value": -1.0} if case == "fill_value" else {}
    ref, _ = _ref(data, labels, func=func, **kw)
    got, _ = _port(data, labels, func=func, **kw)
    _exact(got, ref)


# ---------------------------------------------------------------------------
# layouts and engines
# ---------------------------------------------------------------------------

LAYOUT_FUNCS = ["nanargmax", "argmin", "nanfirst", "last", "nanmedian", "quantile", "mode"]


def _kw(func):
    return {"finalize_kwargs": {"q": [0.3, 0.6], "method": "nearest"}} if func == "quantile" \
        else {}


@pytest.mark.parametrize("func", LAYOUT_FUNCS)
def test_two_dimensional_by_and_axis_tuple(func):
    """A 2-D ``by`` reduced over both its axes (positions count in the
    flattened span), with leading dims on the data."""
    rng = np.random.default_rng(9)
    data = rng.normal(size=(2, 3, 4, 10)).astype(np.float32)
    data[rng.random(data.shape) < 0.2] = np.nan
    by = rng.integers(0, 3, size=(4, 10))
    ref, _ = _ref(data, by, func=func, axis=(-2, -1), **_kw(func))
    got, _ = _port(data, by, func=func, axis=(-2, -1), **_kw(func))
    _exact(got, ref)


@pytest.mark.parametrize("func", LAYOUT_FUNCS)
def test_two_groupers_keep_one_axis(func):
    rng = np.random.default_rng(10)
    data = rng.normal(size=(3, 5, 12)).astype(np.float32)
    by1 = rng.integers(0, 2, size=(5, 12))
    by2 = rng.integers(0, 3, size=(5, 12))
    ref, *_ = _ref(data, by1, by2, func=func, axis=-1, **_kw(func))
    got, *_ = _port(data, by1, by2, func=func, axis=-1, **_kw(func))
    _exact(got, ref)


@pytest.mark.parametrize("func", LAYOUT_FUNCS)
def test_sort_engine(func):
    """The sort engine over a sparse universe, vector q's leading dim
    included, against the reference's sort engine."""
    data = _data(11)
    labels = 7 + 1000 * np.nan_to_num(_labels(11), nan=-1)
    labels[labels < 0] = np.nan
    universe = np.arange(5000)
    ref, _ = _ref(data, labels, func=func, expected_groups=universe, engine="sort", **_kw(func))
    got, _ = _port(data, labels, func=func, expected_groups=universe, engine="sort",
                   **_kw(func))
    _exact(got, ref)


def test_sort_kernel_entry_keeps_vector_q():
    labels = np.nan_to_num(_labels(12), nan=-1).astype(np.int64) * 100
    data = torch.from_numpy(_data(12))
    out = pk.sort_kernel("nanquantile", torch.from_numpy(labels), data, size=1000,
                         q=[0.1, 0.9])
    dense = pk.nanquantile(torch.from_numpy(labels), data, size=1000, q=[0.1, 0.9])
    assert out.shape == (2, 3, 1000)
    np.testing.assert_array_equal(out.numpy(), dense.numpy())


# ---------------------------------------------------------------------------
# registry, options, fusion
# ---------------------------------------------------------------------------


def test_registry_covers_the_reference():
    assert sorted(pagg.AGGREGATIONS) == sorted(flox_tpu.aggregations.AGGREGATIONS)
    for name, agg in flox_tpu.aggregations.AGGREGATIONS.items():
        mine = pagg.AGGREGATIONS[name]
        assert mine.blockwise_only == agg.blockwise_only, name
        assert mine.reduction_type == agg.reduction_type, name
        assert mine.preserves_dtype == agg.preserves_dtype, name


def test_quantile_new_dims_and_median_shape():
    data, labels = _data(13), _labels(13)
    got, _ = _port(data, labels, func="quantile", finalize_kwargs={"q": (0.1, 0.2, 0.9)})
    assert tuple(got.shape) == (3, 3, 4)
    got, _ = _port(data, labels, func="median")
    assert tuple(got.shape) == (3, 4)


def test_quantile_impl_carries_across():
    assert from_reference({"quantile_impl": "select"}) == {"quantile_impl": "select"}
    with pytest.raises(ValueError, match="quantile_impl"):
        flox_tpu_torch.set_options(quantile_impl="radix")


@pytest.mark.parametrize("func", ["nanargmax", "first", "median", "quantile", "mode"])
def test_fusion_keeps_these_sequential(func):
    with pytest.raises(NotImplementedError, match="keep their sequential paths"):
        flox_tpu_torch.groupby_aggregate_many(np.ones(4), np.zeros(4), funcs=("sum", func),
                                              device="cpu")


@pytest.mark.parametrize("shape", [(3, 0), (0,)], ids=str)
@pytest.mark.parametrize("func", LAYOUT_FUNCS + ["nanmode"])
def test_zero_length_axis(func, shape):
    """A reduced axis of length 0 (ROADMAP C1): every group is empty and
    takes the fill, in the reference's shape and dtype."""
    data, labels = np.zeros(shape, np.float32), np.zeros(0, int)
    ref, _ = _ref(data, labels, func=func, expected_groups=np.arange(4), **_kw(func))
    got, _ = _port(data, labels, func=func, expected_groups=np.arange(4), **_kw(func))
    _exact(got, ref)


@pytest.mark.parametrize("func", LAYOUT_FUNCS + ["nanquantile", "nanmode"])
def test_bfloat16(func):
    """bfloat16 data: positions, selected elements and the interpolations,
    which both sides round once to bfloat16, exactly."""
    import jax.numpy as jnp

    data, labels = _data(14), _labels(14)
    kw = _kw(func) if func != "nanquantile" else {"finalize_kwargs": {"q": [0.2, 0.7]}}
    with flox_tpu.set_options(**PALLAS):
        ref, _ = flox_tpu.groupby_reduce(jnp.asarray(data).astype(jnp.bfloat16), labels,
                                         func=func, engine="jax", **kw)
    got, _ = _port(torch.from_numpy(data).to(torch.bfloat16), labels, func=func, **kw)
    ref = np.asarray(ref.astype(jnp.float32) if ref.dtype == jnp.bfloat16 else ref)
    got = got.float() if got.dtype == torch.bfloat16 else got
    np.testing.assert_array_equal(got.numpy(), ref)
