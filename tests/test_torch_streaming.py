"""The port's streaming entry points (flox_tpu_torch.streaming) against
flox_tpu's, on the CPU.

Each case builds the same numpy inputs from a seed and calls the
reference's streaming function (JAX on the CPU, x64) and the port's
(``device="cpu"``, where the kernel wrappers run their plain versions) with
the same ``batch_len``. Mirrors ``tests/test_streaming.py``; its
``TestMeshStreaming*`` classes and mesh cases wait for ROADMAP A8b.

Bars:
* integers, counts, extrema, positions, first/last and quantiles: exact;
* float64 sums, means and variances: ``rtol=1e-10, atol=1e-10``, the bar of
  the reference's ``test_streaming_equals_eager`` (the two sides add each
  slab in different orders);
* the port across prefetch depths 0, 1 and 3: bit for bit.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import streaming as rst
import flox_tpu_torch
from flox_tpu_torch import profiling, streaming as pst

STREAM_FUNCS = [
    "sum", "nansum", "prod", "nanprod", "mean", "nanmean", "var", "nanvar",
    "std", "nanstd", "max", "nanmax", "min", "nanmin", "count", "all", "any",
    "argmax", "argmin", "nanargmax", "nanargmin",
    "first", "last", "nanfirst", "nanlast",
]
#: float64 results held to the 1e-10 bar; every other result is exact
CLOSE_FUNCS = {"sum", "nansum", "prod", "nanprod", "mean", "nanmean", "var", "nanvar", "std",
               "nanstd"}


@functools.lru_cache(maxsize=None)
def _data(seed: int = 0, n: int = 10_000):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(4, n))
    vals[:, ::11] = np.nan
    labels = rng.integers(0, 7, n)
    return vals, labels


def _ref(*args, **kw):
    out, *groups = rst.streaming_groupby_reduce(*args, **kw)
    return np.asarray(out), groups


def _port(*args, **kw):
    out, *groups = pst.streaming_groupby_reduce(*args, device="cpu", **kw)
    return out, groups


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, ref, *, close: bool):
    got = _host(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    if close:
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, ref)


def _bits(x) -> bytes:
    return np.ascontiguousarray(_host(x)).tobytes()


@pytest.mark.parametrize("func", STREAM_FUNCS)
@pytest.mark.parametrize("batch_len", [997, 4096])
def test_streaming_equals_reference(func, batch_len):
    vals, labels = _data()
    if func in ("argmax", "argmin"):
        vals = np.nan_to_num(vals, nan=0.5)  # propagating args: NaN-free data
    fkw = {"finalize_kwargs": {"ddof": 1}} if func in ("var", "nanvar") else {}
    ref, rg = _ref(vals, labels, func=func, batch_len=batch_len, **fkw)
    got, pg = _port(vals, labels, func=func, batch_len=batch_len, **fkw)
    np.testing.assert_array_equal(pg[0], rg[0])
    _check(got, ref, close=func in CLOSE_FUNCS)


def test_loader_callable():
    vals, labels = _data()
    calls = []

    def loader(s, e):
        calls.append((s, e))
        return vals[..., s:e]

    got, _ = _port(loader, labels, func="nanmean", batch_len=1024)
    ref, _ = _ref(vals, labels, func="nanmean", batch_len=1024)
    _check(got, ref, close=True)
    # slabs were requested one at a time (the probe is the one 1-wide call)
    assert len([c for c in calls if c[1] - c[0] > 1]) == int(np.ceil(vals.shape[-1] / 1024))
    host, _ = _port(vals, labels, func="nanmean", batch_len=1024)
    assert _bits(got) == _bits(host)  # the loader form is the host-array form


def test_expected_groups_and_bins():
    vals, labels = _data()
    got, groups = _port(vals, labels, func="count", batch_len=512,
                        expected_groups=np.arange(10))
    ref, rgroups = _ref(vals, labels, func="count", batch_len=512,
                        expected_groups=np.arange(10))
    _check(got, ref, close=False)
    np.testing.assert_array_equal(groups[0], rgroups[0])
    assert (got.numpy()[..., 7:] == 0).all()
    cont = labels.astype(float)
    kw = dict(func="nansum", batch_len=512, expected_groups=np.array([0.0, 3.0, 7.0]),
              isbin=True)
    got_b, _ = _port(vals, cont, **kw)
    ref_b, _ = _ref(vals, cont, **kw)
    _check(got_b, ref_b, close=True)


def test_min_count():
    vals, labels = _data()
    got, _ = _port(vals, labels, func="nansum", batch_len=512, min_count=10_000)
    ref, _ = _ref(vals, labels, func="nansum", batch_len=512, min_count=10_000)
    _check(got, ref, close=True)
    assert torch.isnan(got).all()


def test_min_count_var_matches_reference():
    vals, labels = _data()
    got, _ = _port(vals, labels, func="nanvar", batch_len=997, min_count=2)
    ref, _ = _ref(vals, labels, func="nanvar", batch_len=997, min_count=2)
    _check(got, ref, close=True)
    assert not torch.isnan(got).all()


def test_mode_rejected_median_streams():
    vals, labels = _data()
    with pytest.raises(NotImplementedError, match="stream"):
        _port(vals, labels, func="nanmode")
    got, _ = _port(vals, labels, func="median", batch_len=2048)
    ref, _ = _ref(vals, labels, func="median", batch_len=2048)
    _check(got, ref, close=False)


def test_single_batch_degenerate():
    vals, labels = _data()
    got, _ = _port(vals, labels, func="nanmean", batch_len=vals.shape[-1])
    eager, _ = flox_tpu_torch.groupby_reduce(vals, labels, func="nanmean", device="cpu")
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=1e-12)


def _rms(pkg):
    """The reference's custom aggregation, in ``pkg`` (flox_tpu or the port)."""
    def sq(gi, a, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return pkg.kernels.generic_kernel("nansum", gi, a ** 2, size=size, fill_value=0.0)

    def ct(gi, a, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return pkg.kernels.generic_kernel("nanlen", gi, a, size=size)

    return pkg.Aggregation(
        "rms", numpy=(sq, ct), chunk=(sq, ct),
        combine=(lambda s: s.sum(0), lambda s: s.sum(0)),
        finalize=lambda ss, n, **kw: (ss / n) ** 0.5,
        fill_value={"intermediate": (0.0, 0)}, final_fill_value=np.nan,
    )


def test_custom_aggregation_streams():
    import jax.numpy as jnp

    vals, labels = _data()
    ref, _ = rst.streaming_groupby_reduce(jnp.asarray(vals), labels, func=_rms(flox_tpu),
                                          batch_len=997)
    got, _ = _port(vals, labels, func=_rms(flox_tpu_torch), batch_len=997)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, equal_nan=True)


def test_mesh_names_a8b():
    """mesh= (ROADMAP A8b) streams on all three entry points: on a one-rank
    mesh, bit for bit the single-device stream (tests/test_torch_mesh_streaming.py
    holds the 4-rank world against the reference)."""
    from flox_tpu_torch.parallel import make_mesh

    vals, labels = _data()
    mesh = make_mesh(device_type="cpu")
    for fn, kw in ((pst.streaming_groupby_reduce, {"func": "sum"}),
                   (pst.streaming_groupby_aggregate_many, {"funcs": ("sum",)}),
                   (pst.streaming_groupby_scan, {"func": "cumsum"})):
        single = fn(vals, labels, device="cpu", batch_len=300, **kw)
        meshed = fn(vals, labels, mesh=mesh, batch_len=300, **kw)
        if isinstance(single, tuple):
            single, meshed = single[0], meshed[0]
        if isinstance(single, dict):
            single, meshed = single["sum"], meshed["sum"]
        assert np.asarray(single).tobytes() == np.asarray(meshed).tobytes(), fn.__name__


def test_default_device_is_the_card(monkeypatch):
    vals, labels = _data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pst.streaming_groupby_reduce(vals, labels, func="sum")


@pytest.mark.parametrize("funcs", [("nanmean", "nanmin", "nanmax"),
                                   ("count", "nanmean", "nanstd", "nanmin", "nanmax"),
                                   ("sum", "count", "min", "max", "var")])
def test_aggregate_many_equals_reference(funcs):
    vals, labels = _data()
    ref, _ = rst.streaming_groupby_aggregate_many(vals, labels, funcs=funcs, batch_len=997)
    got, _ = pst.streaming_groupby_aggregate_many(vals, labels, funcs=funcs, batch_len=997,
                                                  device="cpu")
    assert tuple(got) == tuple(ref) == funcs
    for f in funcs:
        _check(got[f], np.asarray(ref[f]), close=f in CLOSE_FUNCS)
        # each statistic is the single-statistic streaming call's, bit for bit
        one, _ = _port(vals, labels, func=f, batch_len=997)
        if f not in ("var", "nanvar", "std", "nanstd"):  # (the fused plan's var triple
            assert _bits(got[f]) == _bits(one), f     # serves mean: same bits anyway)


def _u64_data():
    """uint64 data past 2**53: multiples of 512 below 2**20, and in each row
    and group one value 2**60 + an odd offset, which float64 rounds (to a
    multiple of 256). Every group sum then holds exactly in float64 in any
    order, and the group max is a rounded value."""
    rng = np.random.default_rng(16)
    n, size = 200, 5
    codes = np.arange(n) % size
    x = (rng.integers(0, 2048, (3, n)) * 512).astype(np.uint64)
    for r in range(3):
        for g in range(size):
            col = g + size * int(rng.integers(0, n // size))
            x[r, col] = np.uint64(2**60) + np.uint64(2 * int(rng.integers(0, 2**20)) + 1)
    return x, codes


@pytest.mark.parametrize("funcs", [("sum", "max"), ("sum", "max", "mean")], ids=str)
def test_fused_uint64_stream_matches_reference(funcs):
    """A fused uint64 stream with a dtype-preserving leg reduces through
    float64, as the reference's does: the same values and dtypes."""
    x, codes = _u64_data()
    ref, _ = rst.streaming_groupby_aggregate_many(x, codes, funcs=funcs, engine="jax",
                                                  batch_len=64)
    got, _ = pst.streaming_groupby_aggregate_many(x, codes, funcs=funcs, batch_len=64,
                                                  device="cpu")
    assert list(got) == list(funcs)
    for f in funcs:
        _check(got[f], np.asarray(ref[f]), close=False)
    assert got["max"].dtype == torch.uint64
    assert (got["max"].numpy() > np.uint64(2**60)).all()  # the big values won


@pytest.mark.parametrize("funcs", [("sum", "max"), ("sum", "max", "mean"),
                                   ("sum", "max", "min"), ("min", "nanmax", "count")], ids=str)
def test_fused_uint64_stream_equals_single_func_streams(funcs):
    """Each leg of the fused uint64 stream, a min leg included, is bit for
    bit the port's single-func stream (the reference raises OverflowError
    filling a fused min: ROADMAP Queue C, "Reference side")."""
    x, codes = _u64_data()
    got, _ = pst.streaming_groupby_aggregate_many(x, codes, funcs=funcs, batch_len=64,
                                                  device="cpu")
    for f in funcs:
        one, _ = _port(x, codes, func=f, batch_len=64)
        assert got[f].dtype == one.dtype, f
        assert _bits(got[f]) == _bits(one), f
    if "min" in funcs:
        with pytest.raises(OverflowError):
            rst.streaming_groupby_aggregate_many(x, codes, funcs=funcs, engine="jax",
                                                 batch_len=64)


class TestStreamingPipeline:
    """Prefetch changes when slabs are staged, never what lands on the
    device: every depth gives the same bits."""

    @pytest.mark.parametrize("func", ["nansum", "mean", "nanvar", "argmax", "nanfirst",
                                      "count", "min"])
    def test_reduce_bit_identical(self, func):
        vals, labels = _data()
        if func == "argmax":
            vals = np.nan_to_num(vals, nan=0.5)
        results = {}
        for depth in (0, 1, 3):
            with flox_tpu_torch.set_options(stream_prefetch=depth):
                got, _ = _port(vals, labels, func=func, batch_len=997)
            results[depth] = _bits(got)
        assert results[1] == results[0]
        assert results[3] == results[0]

    def test_reduce_nan_fill_min_count_bit_identical(self):
        vals, labels = _data()
        bits = set()
        for depth in (0, 2):
            with flox_tpu_torch.set_options(stream_prefetch=depth):
                got, _ = _port(vals, labels, func="nansum", batch_len=997, min_count=10_000)
            bits.add(_bits(got))
        assert torch.isnan(got).all() and len(bits) == 1

    @pytest.mark.parametrize("func", ["cumsum", "nancumsum", "ffill", "bfill"])
    def test_scan_bit_identical(self, func):
        vals, labels = _data()
        sub_v, sub_l = vals[:, :4000], labels[:4000]
        results = set()
        for depth in (0, 2):
            with flox_tpu_torch.set_options(stream_prefetch=depth):
                results.add(_bits(pst.streaming_groupby_scan(sub_v, sub_l, func=func,
                                                             batch_len=700, device="cpu")))
        assert len(results) == 1

    def test_quantile_bit_identical(self):
        vals, labels = _data()
        results = set()
        for depth in (0, 2):
            with flox_tpu_torch.set_options(stream_prefetch=depth):
                # expected_groups=10 leaves empty groups: the NaN fill path
                got, _ = _port(vals, labels, func="nanmedian", batch_len=700,
                               expected_groups=np.arange(10))
            results.add(_bits(got))
        assert len(results) == 1

    @pytest.mark.parametrize("depth", [0, 2])
    def test_loader_error_surfaces_promptly(self, depth):
        vals, labels = _data()

        def bad_loader(s, e):
            if s >= 2048:
                raise RuntimeError("stream loader failed")
            return vals[:, s:e]

        t0 = time.perf_counter()
        with flox_tpu_torch.set_options(stream_prefetch=depth):
            with pytest.raises(RuntimeError, match="stream loader failed"):
                _port(bad_loader, labels, func="nanmean", batch_len=1024)
        assert time.perf_counter() - t0 < 30.0
        time.sleep(0.05)
        assert not [t for t in threading.enumerate() if "flox-torch-stage" in t.name]

    def test_scan_loader_error_surfaces(self):
        vals, labels = _data()

        def bad_loader(s, e):
            if s >= 2048:
                raise RuntimeError("scan loader failed")
            return vals[:, s:e]

        with flox_tpu_torch.set_options(stream_prefetch=3):
            with pytest.raises(RuntimeError, match="scan loader failed"):
                pst.streaming_groupby_scan(bad_loader, labels, func="nancumsum",
                                           batch_len=1024, device="cpu")

    def test_throttle_and_donate_knobs_results_unchanged(self):
        """The dispatch throttle's depth never changes the bits. (The port's
        ``stream_donate`` has no effect to test: the carry is always updated
        in place.)"""
        vals, labels = _data()
        ref, _ = _port(vals, labels, func="nanmean", batch_len=997)
        for depth in (0, 1, 3):
            with flox_tpu_torch.set_options(stream_dispatch_depth=depth):
                got, _ = _port(vals, labels, func="nanmean", batch_len=997)
            assert _bits(got) == _bits(ref)

    def test_stream_monitor_reports_pipeline(self):
        vals, labels = _data()
        with flox_tpu_torch.set_options(stream_prefetch=2):
            with profiling.stream_monitor() as reports:
                _port(vals, labels, func="nanmean", batch_len=997)
        assert len(reports) == 1
        rep = reports[0]
        assert rep.prefetch == 2
        assert len(rep.slabs) == rep.nbatches == int(np.ceil(vals.shape[-1] / 997))
        assert rep.wall_ms > 0 and rep.nbytes == vals.nbytes
        assert 0.0 <= rep.overlap_fraction <= 1.0
        assert "overlap" in rep.summary()
        with flox_tpu_torch.set_options(stream_prefetch=0):
            with profiling.stream_monitor() as sync_reports:
                _port(vals, labels, func="nanmean", batch_len=997)
        assert sync_reports[0].overlap_fraction == 0.0


class TestWideStreaming:
    """nD labels and partial-axis reductions stream through the flatten of
    ``groupby_reduce``."""

    @pytest.mark.parametrize("func", ["nansum", "nanmean", "nanvar", "nanmax", "count"])
    def test_nd_labels_match_reference(self, func):
        rng = np.random.default_rng(3)
        labels = rng.integers(0, 6, (12, 40))
        vals = rng.normal(size=(3, 12, 40))
        vals[:, rng.random((12, 40)) < 0.15] = np.nan
        ref, rg = _ref(vals, labels, func=func, batch_len=53)
        got, pg = _port(vals, labels, func=func, batch_len=53)
        np.testing.assert_array_equal(pg[0], rg[0])
        _check(got, ref, close=func in CLOSE_FUNCS)

    @pytest.mark.parametrize("axis", [-1, (-2,), (-2, -1)], ids=str)
    def test_partial_axis_matches_reference(self, axis):
        rng = np.random.default_rng(4)
        labels = rng.integers(0, 5, (10, 24))
        vals = rng.normal(size=(2, 10, 24))
        ref, _ = _ref(vals, labels, func="nanmean", axis=axis, batch_len=17)
        got, _ = _port(vals, labels, func="nanmean", axis=axis, batch_len=17)
        _check(got, ref, close=True)

    def test_axis_below_by_span_broadcasts(self):
        rng = np.random.default_rng(5)
        labels = rng.integers(0, 4, 30)
        vals = rng.normal(size=(6, 30))
        ref, _ = _ref(vals, labels, func="sum", axis=(0, 1), batch_len=7)
        got, _ = _port(vals, labels, func="sum", axis=(0, 1), batch_len=7)
        _check(got, ref, close=True)

    def test_loader_keeps_1d_contract(self):
        labels = np.zeros((2, 3), dtype=np.int64)
        with pytest.raises(NotImplementedError, match="1-D"):
            _port(lambda s, e: np.ones((1, e - s)), labels, func="sum")
        with pytest.raises(NotImplementedError, match="host array"):
            _port(lambda s, e: np.ones((1, e - s)), np.zeros(6, np.int64), func="sum",
                  axis=(0,))

    def test_datetime_all_with_epoch_zero_in_later_slab(self):
        n = 100
        codes = np.zeros(n, dtype=np.int64)
        dt = np.full(n, np.datetime64("2020-01-01", "ns"))
        dt[80] = np.datetime64(0, "ns")  # epoch zero (falsy), in the second slab
        ref, _ = _ref(dt, codes, func="all", batch_len=50)
        got, _ = _port(dt, codes, func="all", batch_len=50)
        _check(got, ref, close=False)
        assert not bool(got[0])

    @pytest.mark.parametrize("func", ["min", "nanmin", "max", "nanmax", "first", "last",
                                      "nanfirst", "nanlast", "count", "mean", "nanmean",
                                      "argmax", "nanargmin", "any", "all"])
    def test_datetime_streams_like_reference(self, func):
        rng = np.random.default_rng(6)
        n = 300
        codes = rng.integers(0, 5, n)
        dt = np.datetime64("2020-01-01", "ns") + rng.integers(0, 10**9, n).astype(
            "timedelta64[ns]")
        dt[rng.random(n) < 0.2] = np.datetime64("NaT")
        ref, _ = _ref(dt, codes, func=func, batch_len=37)
        got, _ = _port(dt, codes, func=func, batch_len=37)
        got = _host(got)
        assert got.dtype == ref.dtype
        if func in ("mean", "nanmean"):
            # float epoch values round back: ~256 ns at 2020 (the eager path's
            # own loss), and the slabs add in another order
            np.testing.assert_allclose(got.view("int64").astype(np.float64),
                                       ref.view("int64").astype(np.float64), rtol=1e-12)
        else:
            np.testing.assert_array_equal(got, ref)

    def test_timedelta_sum_streams(self):
        rng = np.random.default_rng(7)
        n = 200
        codes = rng.integers(0, 4, n)
        td = rng.integers(1, 1000, n).astype("timedelta64[ns]")
        td[rng.random(n) < 0.2] = np.timedelta64("NaT")
        ref, _ = _ref(td, codes, func="nansum", batch_len=23)
        got, _ = _port(td, codes, func="nansum", batch_len=23)
        _check(got, ref, close=False)

    @pytest.mark.parametrize("dt", ["u2", "u4"])
    @pytest.mark.parametrize("func", ["nansum", "nanmax", "nanmean", "argmin"])
    def test_unsigned_streams_like_eager(self, dt, func):
        rng = np.random.default_rng(8)
        labels = rng.integers(0, 5, 400)
        vals = rng.integers(0, 60000, (2, 400)).astype(dt)
        got, _ = _port(vals, labels, func=func, batch_len=33)
        eager, _ = flox_tpu_torch.groupby_reduce(vals, labels, func=func, device="cpu")
        assert got.dtype == eager.dtype
        np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=1e-12)


class TestHighcardStreaming:
    """The present-groups (sort) engine compacts the stream's codes once."""

    def test_sort_engine_matches_dense(self):
        # float64: both domains take the same segment-sum lowering, so the
        # engines agree bit for bit (the eager engines' contract)
        rng = np.random.default_rng(9)
        labels = 29220 + rng.integers(0, 300, 2000)
        vals = rng.normal(size=(3, 2000))
        kw = dict(func="nanmean", expected_groups=np.arange(36524), batch_len=300)
        got, _ = _port(vals, labels, engine="sort", **kw)
        dense, _ = _port(vals, labels, engine="torch", **kw)
        assert got.shape == (3, 36524)
        np.testing.assert_array_equal(got.numpy(), dense.numpy())
        ref, _ = _ref(vals, labels, engine="sort", **kw)
        _check(got, ref, close=True)

    def test_numpy_engine_rejected(self):
        vals, labels = _data()
        with pytest.raises(ValueError, match="no streaming form"):
            _port(vals, labels, func="sum", engine="numpy")


class TestStreamingOrderStats:
    """Exact quantiles and medians: the radix select's counting passes,
    accumulated slab by slab over ``nbits + 1`` passes."""

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _qdata():
        rng = np.random.default_rng(23)
        n = 5000
        vals = rng.normal(size=(3, n))
        vals[:, ::11] = np.nan
        labels = rng.integers(0, 9, n)
        return vals, labels

    @pytest.mark.parametrize("func,fkw", [
        ("nanmedian", None),
        ("median", None),
        ("nanquantile", {"q": 0.9}),
        ("quantile", {"q": [0.25, 0.75]}),
        ("nanquantile", {"q": 0.3, "method": "nearest"}),
        ("nanquantile", {"q": 0.6, "method": "midpoint"}),
        ("nanquantile", {"q": 0.5, "method": "hazen"}),
    ], ids=str)
    def test_matches_reference_and_eager_select(self, func, fkw):
        vals, labels = self._qdata()
        ref, rg = _ref(vals, labels, func=func, finalize_kwargs=fkw, batch_len=700)
        got, pg = _port(vals, labels, func=func, finalize_kwargs=fkw, batch_len=700)
        np.testing.assert_array_equal(pg[0], rg[0])
        _check(got, ref, close=False)
        with flox_tpu_torch.set_options(quantile_impl="select"):
            eager, _ = flox_tpu_torch.groupby_reduce(vals, labels, func=func,
                                                     finalize_kwargs=fkw, device="cpu")
        assert _bits(got) == _bits(eager)  # the reference's own claim, on the port

    def test_loader_and_int_dtype(self):
        _, labels = self._qdata()
        iv = np.random.default_rng(5).integers(-100, 100, size=labels.shape[0])
        ref, _ = _ref(lambda s, e: iv[s:e], labels, func="median", batch_len=640)
        got, _ = _port(lambda s, e: iv[s:e], labels, func="median", batch_len=640)
        _check(got, ref, close=False)

    def test_datetime_nat(self):
        _, labels = self._qdata()
        rng = np.random.default_rng(7)
        dt = np.datetime64("2020-01-01", "ns") + rng.integers(0, 10**9, labels.shape[0]).astype(
            "timedelta64[ns]")
        dt[::17] = np.datetime64("NaT")
        ref, _ = _ref(dt, labels, func="nanmedian", batch_len=640)
        got, _ = _port(dt, labels, func="nanmedian", batch_len=640)
        _check(got, ref, close=False)

    def test_expected_groups_with_empty(self):
        vals, labels = self._qdata()
        kw = dict(func="nanmedian", expected_groups=np.arange(12), batch_len=900)
        ref, _ = _ref(vals, labels, **kw)
        got, _ = _port(vals, labels, **kw)
        _check(got, ref, close=False)

    def test_mode_still_rejected(self):
        vals, labels = self._qdata()
        with pytest.raises(NotImplementedError, match="cannot stream"):
            _port(vals, labels, func="mode", batch_len=700)


class TestStreamingScan:
    """Grouped scans: the within-slab scan plus a per-group carry."""

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _sdata():
        rng = np.random.default_rng(31)
        n = 4000
        vals = rng.normal(size=(2, n))
        vals[:, ::9] = np.nan
        labels = rng.integers(0, 6, n)
        return vals, labels

    @staticmethod
    def _scan(pkg_fn, *args, **kw):
        return np.asarray(pkg_fn(*args, **kw))

    @pytest.mark.parametrize("func", ["cumsum", "nancumsum", "ffill", "bfill"])
    @pytest.mark.parametrize("batch_len", [700, 4000])
    def test_matches_reference(self, func, batch_len):
        vals, labels = self._sdata()
        ref = np.asarray(rst.streaming_groupby_scan(vals, labels, func=func,
                                                    batch_len=batch_len))
        got = pst.streaming_groupby_scan(vals, labels, func=func, batch_len=batch_len,
                                         device="cpu")
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        if func in ("ffill", "bfill"):
            np.testing.assert_array_equal(got, ref)  # fills copy values
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10, equal_nan=True)

    def test_int_promotion_matches(self):
        _, labels = self._sdata()
        iv = np.arange(labels.shape[0], dtype=np.int32) % 97
        ref = np.asarray(rst.streaming_groupby_scan(iv, labels, func="cumsum", batch_len=700))
        got = pst.streaming_groupby_scan(iv, labels, func="cumsum", batch_len=700,
                                         device="cpu")
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)

    def test_timedelta_cumsum_nat_poisons_across_slabs(self):
        _, labels = self._sdata()
        td = np.random.default_rng(3).integers(1, 100, labels.shape[0]).astype(
            "timedelta64[ns]")
        td[5] = np.timedelta64("NaT")  # poisons its group in every later slab
        ref = np.asarray(rst.streaming_groupby_scan(td, labels, func="cumsum", batch_len=600))
        got = pst.streaming_groupby_scan(td, labels, func="cumsum", batch_len=600,
                                         device="cpu")
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.view("int64"), ref.view("int64"))

    def test_datetime_ffill_bfill(self):
        _, labels = self._sdata()
        rng = np.random.default_rng(4)
        dt = np.datetime64("2020-01-01", "ns") + rng.integers(0, 10**9, labels.shape[0]).astype(
            "timedelta64[ns]")
        dt[::13] = np.datetime64("NaT")
        for func in ("ffill", "bfill"):
            ref = np.asarray(rst.streaming_groupby_scan(dt, labels, func=func, batch_len=600))
            got = pst.streaming_groupby_scan(dt, labels, func=func, batch_len=600,
                                             device="cpu")
            np.testing.assert_array_equal(got.view("int64"), ref.view("int64"))

    def test_loader_and_writer_stream_both_ways(self):
        vals, labels = self._sdata()
        n = labels.shape[0]
        written = np.full((2, n), np.nan)
        spans = []

        def writer(s, e, res):
            spans.append((s, e))
            written[..., s:e] = res

        r = pst.streaming_groupby_scan(lambda s, e: vals[:, s:e], labels, func="nancumsum",
                                       batch_len=512, out=writer, device="cpu")
        assert r is None
        assert spans == [(i * 512, min((i + 1) * 512, n)) for i in range(len(spans))]
        ref = np.asarray(rst.streaming_groupby_scan(vals, labels, func="nancumsum",
                                                    batch_len=512))
        np.testing.assert_allclose(written, ref, rtol=1e-10, atol=1e-10, equal_nan=True)

    def test_missing_labels_scan_to_nan(self):
        vals, labels = self._sdata()
        lab = labels.copy()
        lab[::50] = 99  # outside expected_groups: code -1
        kw = dict(func="cumsum", expected_groups=np.arange(6), batch_len=700)
        ref = np.asarray(rst.streaming_groupby_scan(vals, lab, **kw))
        got = pst.streaming_groupby_scan(vals, lab, device="cpu", **kw)
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10, equal_nan=True)
        assert np.isnan(got[..., ::50]).all()

    @pytest.mark.parametrize("dt", ["u2", "u4", "u8"])
    def test_unsigned_scans_match_reference(self, dt):
        # (the reference's own streamed uint16 sums wrap at 2**16, unlike its
        # eager ones; the port's equal its eager ones: TestWideStreaming)
        rng = np.random.default_rng(12)
        labels = rng.integers(0, 5, 300)
        vals = rng.integers(0, 60000, (2, 300)).astype(dt)
        for func in ("ffill", "bfill") + (("cumsum",) if dt != "u2" else ()):
            ref = np.asarray(rst.streaming_groupby_scan(vals, labels, func=func, batch_len=37))
            got = pst.streaming_groupby_scan(vals, labels, func=func, batch_len=37,
                                             device="cpu")
            assert got.dtype == ref.dtype, (func, got.dtype, ref.dtype)
            np.testing.assert_array_equal(got, ref)

    def test_nd_labels_rejected(self):
        vals, _ = self._sdata()
        with pytest.raises(NotImplementedError, match="1-D"):
            pst.streaming_groupby_scan(vals, np.zeros((2, 3), np.int64), func="cumsum",
                                       device="cpu")
