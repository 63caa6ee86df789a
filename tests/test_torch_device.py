"""The port's device layer (flox_tpu_torch) against flox_tpu's, on the CPU:
device-side codes (``factorize_device``, ``bin_device``, ``codes_device``),
``groupby_reduce_device``, prefactorized labels (``prefactorize``,
``slice_rows``, ``select_mask``, ``prefactorized_from_host``) through
``groupby_reduce``, ``groupby_aggregate_many`` and the sort engine, and
``memory_stats`` / ``reinitialize``.

The reference runs with ``engine="jax"`` (or "sort") under the Pallas options,
so its segment reductions reach the Pallas kernels in interpret mode; the port
runs with ``device="cpu"`` under the same options carried across, where its
kernel wrappers run their plain versions. Inputs are seeded numpy arrays.

Tolerances: codes, counts, integer results and extrema exactly; float32
``rtol=1e-5, atol=1e-6`` (the reference's own bar for its Pallas path against
scatter); float64 ``rtol=1e-12, atol=1e-14``. A prefactorized call against the
port's own inline call: bit for bit.
"""

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import device as rdevice
from flox_tpu import factorize as rfct
from flox_tpu import options as ref_options

import flox_tpu_torch
from flox_tpu_torch import device as pdevice
from flox_tpu_torch import factorize as pfct
from flox_tpu_torch import kernels as pk
from flox_tpu_torch.options import from_reference

PALLAS = dict(segment_sum_impl="pallas", segment_minmax_impl="pallas")
RNG_SEED = 11


def _data(shape=(4, 60), dtype=np.float32, nan=0.1, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(dtype)
    data[rng.random(shape) < nan] = np.nan
    return data


def _labels(n=60, seed=RNG_SEED):
    """Float labels 1..6 with 4 absent, out-of-range 9 and NaN."""
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(1, 7, n).astype(np.float64)
    labels[labels == 4] = 1
    labels[rng.random(n) < 0.1] = 9
    labels[rng.random(n) < 0.1] = np.nan
    return labels


def _close(got: torch.Tensor, ref, exact=False):
    ref = np.asarray(ref)
    g = got.numpy()
    assert g.dtype == ref.dtype and g.shape == ref.shape, (g.dtype, ref.dtype, g.shape)
    if exact or ref.dtype.kind in "iub":
        np.testing.assert_array_equal(g, ref)
    elif ref.dtype == np.float32:
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
    else:
        np.testing.assert_allclose(g, ref, rtol=1e-12, atol=1e-14, equal_nan=True)


def _port_opts():
    with flox_tpu.set_options(**PALLAS):
        return from_reference(dict(ref_options.OPTIONS))


# ---------------------------------------------------------------------------
# codes on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("expected", [np.arange(1, 7), np.array([1.0, 2.5, 3.0, 6.0])],
                         ids=["ints", "floats"])
def test_factorize_device_matches_reference(expected):
    labels = _labels()
    ref = np.asarray(rfct.factorize_device(labels, expected))
    got = pfct.factorize_device(torch.from_numpy(labels), expected, device="cpu")
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("closed", ["right", "left"])
@pytest.mark.parametrize("edges", [np.array([0.0, 2.0, 3.5, 6.0]), np.array([1, 3, 6])],
                         ids=["float-edges", "int-edges"])
def test_bin_device_matches_reference(edges, closed):
    labels = _labels()
    labels[:4] = [1.0, 3.5, 6.0, 0.0]  # values on the edges
    ref = np.asarray(rfct.bin_device(labels, edges, closed=closed))
    got = pfct.bin_device(labels, edges, closed=closed, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    via = pdevice.codes_device(labels, bins=edges, closed=closed, device="cpu")
    np.testing.assert_array_equal(via.numpy(), ref)


def test_codes_device_needs_one_spec():
    with pytest.raises(ValueError, match="exactly one"):
        pdevice.codes_device(np.arange(3), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        pdevice.codes_device(np.arange(3), np.arange(3), bins=np.arange(3), device="cpu")


# ---------------------------------------------------------------------------
# groupby_reduce_device
# ---------------------------------------------------------------------------

DEVICE_FUNCS = ["sum", "nansum", "mean", "nanmean", "nanvar", "count", "nanmax", "min",
                "nanargmax", "nanfirst"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("func", DEVICE_FUNCS)
def test_groupby_reduce_device_one_grouper(func, dtype):
    data, labels, expected = _data(dtype=dtype), _labels(), np.arange(1, 7)
    with flox_tpu.set_options(**PALLAS):
        ref = rdevice.groupby_reduce_device(data, labels, func=func, expected_values=expected)
    with flox_tpu_torch.set_options(**_port_opts()):
        got = pdevice.groupby_reduce_device(torch.from_numpy(data), torch.from_numpy(labels),
                                            func=func, expected_values=expected, device="cpu")
    _close(got, ref, exact=func in ("nanmax", "min", "count", "nanargmax", "nanfirst"))


@pytest.mark.parametrize("func", ["sum", "nanmean", "count"])
def test_groupby_reduce_device_two_groupers_and_bins(func):
    data = _data((3, 5, 12), dtype=np.float64)
    b1 = np.repeat(np.arange(5), 12).reshape(5, 12) % 3
    b2 = np.linspace(0.0, 4.0, 60).reshape(5, 12)
    kw = dict(func=func, expected_values=(np.arange(3), None),
              bins=(None, np.array([0.0, 1.0, 2.5, 4.0])))
    ref = rdevice.groupby_reduce_device(data, b1, b2, **kw)
    got = pdevice.groupby_reduce_device(data, b1, b2, device="cpu", **kw)
    assert tuple(got.shape) == (3, 3, 3)
    _close(got, ref)


def test_groupby_reduce_device_dtype_and_errors():
    out = pdevice.groupby_reduce_device(np.array([1, 2, 3, 4], dtype=np.int32),
                                        np.array([0, 0, 1, 1]), func="sum",
                                        expected_values=np.arange(2), dtype=np.float64,
                                        device="cpu")
    assert out.dtype == torch.float64 and out.tolist() == [3.0, 7.0]
    with pytest.raises(TypeError, match="at least one"):
        pdevice.groupby_reduce_device(np.ones(3), func="sum", device="cpu")
    with pytest.raises(ValueError, match="expected_values or bins"):
        pdevice.groupby_reduce_device(np.ones(3), np.zeros(3), func="sum", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        pdevice.groupby_reduce_device(np.ones((2, 3)), np.zeros(4), func="sum",
                                      expected_values=np.arange(2), device="cpu")


def test_groupby_reduce_device_equals_groupby_reduce():
    """Codes made on the device reach the same kernels as the host codes:
    bit for bit."""
    data = torch.from_numpy(_data((8, 200), nan=0.0))
    months = np.arange(200) % 12 + 1
    got = pdevice.groupby_reduce_device(data, torch.from_numpy(months), func="nanmean",
                                        expected_values=np.arange(1, 13), device="cpu")
    want, _ = flox_tpu_torch.groupby_reduce(data, months, func="nanmean", device="cpu")
    assert torch.equal(got, want)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: pdevice.codes_device(np.arange(3), np.arange(3)),
        lambda: pdevice.groupby_reduce_device(np.ones(3), np.zeros(3), func="sum",
                                              expected_values=np.arange(1)),
        lambda: pfct.prefactorize(np.zeros(3)),
        lambda: flox_tpu_torch.groupby_reduce(torch.ones(3).to_sparse(), np.zeros(3),
                                              func="sum"),
        lambda: flox_tpu_torch.groupby_reduce(np.ones(3), np.zeros(3), func="sum",
                                              engine="numpy"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# prefactorized labels
# ---------------------------------------------------------------------------


def _artifacts(labels, **kw):
    ref = rfct.prefactorize(labels, stage=False, **kw)
    fields = {name: getattr(ref, name) for name in (
        "codes", "ccodes", "present", "ncap", "found_groups", "group_shape", "ngroups", "size",
        "by_shape", "by_dtype")}
    return ref, pfct.prefactorized_from_host(fields, device="cpu")


@pytest.mark.parametrize("expected", [None, np.arange(0, 10)], ids=["discovered", "expected"])
def test_prefactorize_matches_reference_artifact(expected):
    labels = _labels()
    ref = rfct.prefactorize(labels, expected_groups=expected, stage=False)
    got = pfct.prefactorize(labels, expected_groups=expected, device="cpu")
    np.testing.assert_array_equal(got.codes, ref.codes)
    np.testing.assert_array_equal(got.ccodes, ref.ccodes)
    np.testing.assert_array_equal(got.present, ref.present)
    assert (got.ncap, got.size, got.ngroups, got.n) == (ref.ncap, ref.size, ref.ngroups, ref.n)
    assert got.by_shape == ref.by_shape and got.by_dtype == ref.by_dtype
    assert got.group_shape == ref.group_shape
    np.testing.assert_array_equal(got.found_groups[0], np.asarray(ref.found_groups[0]))
    assert torch.equal(got.codes_dev, torch.from_numpy(ref.codes))
    assert got.device_nbytes() == got.codes_dev.numel() * 8 + got.ccodes_dev.numel() * 4


@pytest.mark.parametrize("engine", ["torch", "sort", "numpy"])
@pytest.mark.parametrize("func", ["nanmean", "nansum", "nanmax", "count", "nanvar"])
def test_prefactorized_reduce_matches_reference(func, engine):
    data, labels = _data(), _labels()
    rpf, ppf = _artifacts(labels)
    ref_engine = {"torch": "jax"}.get(engine, engine)
    with flox_tpu.set_options(**PALLAS):
        ref, rgroups = flox_tpu.groupby_reduce(data, rpf, func=func, engine=ref_engine)
    with flox_tpu_torch.set_options(**_port_opts()):
        got, pgroups = flox_tpu_torch.groupby_reduce(torch.from_numpy(data), ppf, func=func,
                                                     engine=engine, device="cpu")
        inline, _ = flox_tpu_torch.groupby_reduce(torch.from_numpy(data), labels, func=func,
                                                  engine=engine, device="cpu")
    np.testing.assert_array_equal(pgroups, np.asarray(rgroups))
    _close(got, ref, exact=func in ("nanmax", "count"))
    torch.testing.assert_close(got, inline, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_prefactorized_aggregate_many_matches_reference(engine):
    data, labels = _data(), _labels()
    rpf, ppf = _artifacts(labels)
    funcs = ("nanmean", "nanmin", "nanmax", "count", "nanstd")
    ref_engine = {"torch": "jax"}.get(engine, engine)
    with flox_tpu.set_options(**PALLAS):
        ref, _ = flox_tpu.groupby_aggregate_many(data, rpf, funcs=funcs, engine=ref_engine)
    with flox_tpu_torch.set_options(**_port_opts()):
        got, groups = flox_tpu_torch.groupby_aggregate_many(torch.from_numpy(data), ppf,
                                                            funcs=funcs, engine=engine,
                                                            device="cpu")
        inline, _ = flox_tpu_torch.groupby_aggregate_many(torch.from_numpy(data), labels,
                                                          funcs=funcs, engine=engine,
                                                          device="cpu")
    assert tuple(got) == funcs
    for f in funcs:
        _close(got[f], ref[f], exact=f in ("nanmin", "nanmax", "count"))
        torch.testing.assert_close(got[f], inline[f], rtol=0, atol=0, equal_nan=True)


def test_prefactorized_views_match_reference():
    data, labels = _data(), _labels()
    rpf, ppf = _artifacts(labels)
    mask = np.random.default_rng(3).random(labels.size) < 0.5
    for rview, pview, cols in (
        (rpf.slice_rows(10, 50), ppf.slice_rows(10, 50), slice(10, 50)),
        (rpf.select_mask(mask), ppf.select_mask(mask), mask),
    ):
        np.testing.assert_array_equal(pview.codes, rview.codes)
        np.testing.assert_array_equal(pview.ccodes, rview.ccodes)
        np.testing.assert_array_equal(pview.present, rview.present)
        assert pview.ncap == rview.ncap and pview.by_shape == rview.by_shape
        assert torch.equal(pview.codes_dev, torch.from_numpy(rview.codes))
        with flox_tpu.set_options(**PALLAS):
            ref, _ = flox_tpu.groupby_reduce(data[:, cols], rview, func="nanmean", engine="jax")
        with flox_tpu_torch.set_options(**_port_opts()):
            got, _ = flox_tpu_torch.groupby_reduce(torch.from_numpy(data[:, cols]), pview,
                                                   func="nanmean", device="cpu")
        _close(got, ref)
    with pytest.raises(ValueError, match="out of bounds"):
        ppf.slice_rows(5, 500)
    with pytest.raises(ValueError, match="selects no rows"):
        ppf.select_mask(np.zeros(labels.size, bool))


@pytest.mark.parametrize("kw,err,match", [
    ({"expected_groups": np.arange(3)}, NotImplementedError, "expected_groups"),
    ({"axis": -1}, NotImplementedError, "axis"),
    ({"isbin": True}, NotImplementedError, "isbin"),
    ({"reindex": True}, NotImplementedError, "reindex"),
])
def test_prefactorized_refusals(kw, err, match):
    ppf = pfct.prefactorize(np.zeros(4), device="cpu")
    with pytest.raises(err, match=match):
        flox_tpu_torch.groupby_reduce(np.ones(4), ppf, func="sum", device="cpu", **kw)
    with pytest.raises(ValueError, match="align"):
        flox_tpu_torch.groupby_reduce(np.ones(5), ppf, func="sum", device="cpu")
    with pytest.raises(NotImplementedError, match="numeric"):
        flox_tpu_torch.groupby_reduce(np.array(["a"] * 4), ppf, func="first", device="cpu")


def test_prefactorized_scan_raises_as_the_reference():
    rpf, ppf = _artifacts(np.zeros(4))
    with pytest.raises(ValueError, match="does not align"):
        flox_tpu.groupby_scan(np.ones(4), rpf, func="cumsum", engine="jax")
    with pytest.raises(ValueError, match="does not align"):
        flox_tpu_torch.groupby_scan(np.ones(4), ppf, func="cumsum", device="cpu")


def test_prefactorized_uses_staged_codes(monkeypatch):
    """No factorization and no copy of the codes: the staged tensor is the
    one the kernels get."""
    ppf = pfct.prefactorize(np.arange(40) % 4, device="cpu")
    seen = []
    real = pk.generic_kernel

    def spy(func, group_idx, array, **kw):
        seen.append(group_idx)
        return real(func, group_idx, array, **kw)

    monkeypatch.setattr(pk, "generic_kernel", spy)
    monkeypatch.setattr(pfct, "factorize_cached", lambda *a, **k: pytest.fail("factorized"))
    flox_tpu_torch.groupby_reduce(torch.ones(2, 40), ppf, func="nansum", device="cpu")
    assert seen and all(g is ppf.codes_dev for g in seen)


# ---------------------------------------------------------------------------
# memory_stats, reinitialize
# ---------------------------------------------------------------------------


def test_memory_stats_is_none_without_cuda():
    assert pdevice.memory_stats() is None


def test_reinitialize_drops_caches_and_returns_false():
    pfct.factorize_cached((np.arange(10) % 3,), axes=(0,))
    pk.present_groups(np.arange(10) % 3, 3)
    assert pfct._FACTORIZE_CACHE and pk._PRESENT_CACHE
    assert pdevice.reinitialize() is False
    assert not pfct._FACTORIZE_CACHE and not pk._PRESENT_CACHE
    assert pfct._FACTORIZE_CACHE_BYTES[0] == 0
