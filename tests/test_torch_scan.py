"""The port's grouped scans (flox_tpu_torch.groupby_scan and the
segmented-cumsum kernel's wrapper) against flox_tpu's, on the CPU.

The reference runs with ``engine="jax"``; under ``set_options(scan_impl=
"pallas")`` its cumsum/nancumsum reach the Pallas scan kernel in interpret
mode, as tests/test_kernels.py's ``TestPallasScan`` runs it, and otherwise its
segmented ``associative_scan`` path. The port runs with ``device="cpu"`` under
the same options (``options.from_reference``), where the kernel wrapper runs
its plain version. Inputs are numpy arrays made from a seed.

Tolerances:
* float32 cumsums of whole calls: ``rtol=1e-5, atol=1e-6, equal_nan=True``, the
  reference's bar between its Pallas and segmented scans
  (tests/test_kernels.py), on the reference's own inputs; the two sides add in
  different orders;
* the kernel sweep (more sizes, bfloat16, ±inf): each running sum within the
  rounding-error bound of a float32 sum, ``n_g * u * cumsum|x|`` (``n_g`` the
  group's length, ``u = 2^-24``) plus one ulp of the result in its dtype, with
  the non-finite positions equal -- the bound chip_smoke.py holds the CUDA
  kernel to;
* float64 and integer scans, ffill and bfill: ``rtol=1e-12`` or exact.
* the segmented torch path on many groups: against a float64 numpy oracle,
  ``rtol=1e-5, atol=1e-5`` (the reference test's oracle bar).
The reference's IEEE semantic cases (NaN poisoning, inf rules, overflow) are
held as properties of the port, not element by element: where a running sum
overflows depends on the order of the additions.
"""

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import options as ref_options
from flox_tpu.pallas_kernels import segment_cumsum_pallas
import flox_tpu_torch
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import kernels as pk
from flox_tpu_torch.options import from_reference

RNG_SEED = 11


def _port_options(**ref_opts):
    with flox_tpu.set_options(**ref_opts):
        return from_reference(dict(ref_options.OPTIONS))


def _scan_both(values, *by, func, ref_opts=None, **kw):
    ref_opts = ref_opts or {}
    with flox_tpu.set_options(**ref_opts):
        ref = np.asarray(flox_tpu.groupby_scan(values, *by, func=func, engine="jax", **kw))
    with flox_tpu_torch.set_options(**_port_options(**ref_opts)):
        got = flox_tpu_torch.groupby_scan(torch.from_numpy(np.ascontiguousarray(values)), *by,
                                          func=func, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert str(got.dtype).removeprefix("torch.") == ref.dtype.name
    assert tuple(got.shape) == ref.shape
    return got.numpy(), ref


def _pcumsum(values, codes, size, skipna):
    """The port's kernel wrapper on one row (the reference's (N,) layout)."""
    data = torch.from_numpy(np.ascontiguousarray(values)).reshape(1, -1)
    return ck.segment_cumsum(data, torch.from_numpy(codes), size, skipna)[0].numpy()


def _scan_bound(values, codes, size):
    """``n_g * u * cumsum|x|`` per element: the rounding-error bound of a
    float32 grouped running sum of ``values`` (K, N) in any order."""
    idx = np.where((codes >= 0) & (codes < size), codes, size)
    out = np.zeros(values.shape)
    for g in np.unique(idx):
        m = idx == g
        out[:, m] = m.sum() * 2.0**-24 * np.cumsum(np.abs(values[:, m]), axis=1)
    return out


def _oracle(func, values, codes):
    out = np.empty(values.shape, dtype=np.float64)
    for g in np.unique(codes):
        m = codes == g
        grp = values[..., m].astype(np.float64)
        out[..., m] = np.nancumsum(grp, -1) if func == "nancumsum" else np.cumsum(grp, -1)
    return out


# ---------------------------------------------------------------------------
# the kernel: segment_cumsum against segment_cumsum_pallas
# ---------------------------------------------------------------------------


class TestSegmentCumsumKernel:
    @pytest.mark.parametrize("skipna", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("k,n,size", [(3, 300, 5), (2, 700, 1), (2, 257, 40)])
    def test_plain_matches_pallas(self, skipna, dtype, k, n, size):
        import jax.numpy as jnp

        rng = np.random.default_rng(k * n + size)
        values = rng.normal(size=(k, n)).astype(np.float32)
        values[rng.random((k, n)) < 0.1] = np.nan
        values[0, n // 3] = np.inf
        values[-1, n // 2] = -np.inf
        codes = rng.integers(-1, size + 2, n).astype(np.int32)  # missing: one extra group
        t = torch.from_numpy(values)
        ref_in = jnp.asarray(values.T)
        if dtype == "bfloat16":
            t, ref_in = t.to(torch.bfloat16), ref_in.astype(jnp.bfloat16)
        got = ck.segment_cumsum(t, torch.from_numpy(codes), size, skipna)
        want = np.asarray(
            segment_cumsum_pallas(ref_in, codes, size, skipna=skipna, interpret=True)
        ).T
        assert got.dtype == t.dtype and got.shape == (k, n)
        g, w = got.to(torch.float64).numpy(), want.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(np.isinf(g) * np.sign(g), np.isinf(w) * np.sign(w))
        finite = np.isfinite(w)
        x = t.to(torch.float64).numpy()
        bound = _scan_bound(np.where(np.isfinite(x), x, 0.0), codes, size)
        ulp = np.abs(w) * (2.0**-7 if dtype == "bfloat16" else 2.0**-23)
        assert np.all(np.abs(g - w)[finite] <= (bound + ulp)[finite])

    @pytest.mark.parametrize("func", ["cumsum", "nancumsum"])
    @pytest.mark.parametrize("shape", [(257,), (3, 300)])
    def test_groupby_scan_vs_pallas_and_oracle(self, func, shape):
        rng = np.random.default_rng(21)
        n = shape[-1]
        codes = rng.integers(0, 5, n).astype(float)
        codes[rng.random(n) < 0.1] = np.nan  # missing labels come out NaN
        values = rng.normal(size=shape).astype(np.float32)
        values[rng.random(shape) < 0.15] = np.nan
        got, ref = _scan_both(values, codes, func=func, ref_opts={"scan_impl": "pallas"},
                              expected_groups=np.arange(5.0))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
        ok = ~np.isnan(codes)
        want = _oracle(func, values[..., ok], codes[ok])
        np.testing.assert_allclose(got[..., ok], want, rtol=1e-5, atol=1e-5, equal_nan=True)
        assert np.isnan(got[..., ~ok]).all()

    def test_kernel_route_and_launches_on_cpu(self, monkeypatch):
        calls = []
        real = ck.segment_cumsum
        monkeypatch.setattr(ck, "segment_cumsum", lambda *a, **k: calls.append(1) or real(*a, **k))
        before = dict(ck.LAUNCHES)
        values = np.random.default_rng(3).normal(size=(2, 64)).astype(np.float32)
        labels = np.arange(64) % 12
        for func in ("cumsum", "nancumsum"):
            flox_tpu_torch.groupby_scan(values, labels, func=func, device="cpu")
        assert len(calls) == 2 and ck.LAUNCHES == before
        with flox_tpu_torch.set_options(scan_impl="segmented"):
            flox_tpu_torch.groupby_scan(values, labels, func="cumsum", device="cpu")
        flox_tpu_torch.groupby_scan(values.astype(np.float64), labels, func="cumsum",
                                    device="cpu")
        assert len(calls) == 2


# ---------------------------------------------------------------------------
# the reference's IEEE semantic cases, as properties of the port
# ---------------------------------------------------------------------------


class TestScanSemantics:
    def test_nan_poisons_rest_of_group_only(self):
        n = 400
        codes = (np.arange(n) % 3).astype(np.int32)
        values = np.ones(n, dtype=np.float32)
        values[30] = np.nan  # group 0
        got = _pcumsum(values, codes, 3, skipna=False)
        g0 = np.flatnonzero(codes == 0)
        assert np.isfinite(got[g0[g0 < 30]]).all()
        assert np.isnan(got[g0[g0 >= 30]]).all()
        assert np.isfinite(got[codes != 0]).all()

    @pytest.mark.parametrize("func", ["cumsum", "nancumsum"])
    def test_inf_semantics(self, func):
        n = 1200
        codes = (np.arange(n) % 3).astype(np.int32)
        values = np.ones(n, dtype=np.float32)
        values[30] = np.inf  # group 0: +inf from here on...
        values[900] = -np.inf  # ...then +inf + -inf = NaN
        values[61] = -np.inf  # group 1: -inf from here on
        values[50] = np.nan  # group 2: NaN poisons (cumsum only)
        got = _pcumsum(values, codes, 3, skipna=func == "nancumsum")
        f = np.nancumsum if func == "nancumsum" else np.cumsum
        want = np.empty(n, np.float64)
        with np.errstate(invalid="ignore"):  # +inf + -inf in the oracle
            for g in range(3):
                m = codes == g
                want[m] = f(values[m].astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)

    def test_carry_overflow_does_not_poison_other_groups(self):
        n = 1100
        codes = (np.arange(n) % 2).astype(np.int32)
        values = np.ones(n, dtype=np.float32)
        values[codes == 0] = 3e38
        got = _pcumsum(values, codes, 2, skipna=False)
        g1 = got[codes == 1]
        np.testing.assert_allclose(g1, np.arange(1, len(g1) + 1), rtol=1e-6)
        g0 = got[codes == 0]
        assert np.isposinf(g0[-1]) and not np.isnan(g0).any()

    def test_opposite_sign_overflow_keeps_first_inf(self):
        vals = np.full(1100, 3e38, np.float32)
        vals[400:] = -3e38
        got = _pcumsum(vals, np.zeros(1100, np.int32), 1, skipna=False)
        assert np.isposinf(got[1]) and np.isposinf(got[-1])
        assert not np.isnan(got).any()

    def test_overflow_then_opposite_inf_value_is_nan(self):
        vals = np.zeros(200, np.float32)
        vals[0] = vals[1] = 3e38
        vals[5] = -np.inf
        codes = np.zeros(200, np.int32)
        got = _pcumsum(vals, codes, 1, skipna=False)
        assert np.isposinf(got[1]) and np.isposinf(got[4])
        assert np.isnan(got[5:]).all()
        vals2 = np.full(200, 3e38, np.float32)
        vals2[0] = -np.inf  # a -inf running sum cannot overflow positive
        assert np.isneginf(_pcumsum(vals2, codes, 1, skipna=False)).all()

    def test_finite_values_after_inf(self):
        values = np.ones(1100, dtype=np.float32)
        values[3] = np.inf
        got = _pcumsum(values, np.zeros(1100, np.int32), 1, skipna=False)
        assert np.isfinite(got[:3]).all() and np.isposinf(got[3:]).all()

    def test_bf16_accumulates_in_f32(self):
        data = torch.ones((1, 2000), dtype=torch.bfloat16)
        got = ck.segment_cumsum(data, torch.zeros(2000, dtype=torch.int32), 1, False)
        assert got.dtype == torch.bfloat16
        assert got[0, -1].item() > 1900  # a bf16 running sum would stop at 256

    def test_group_cap_sends_to_segmented_path(self, monkeypatch):
        monkeypatch.setattr(ck, "segment_cumsum", lambda *a, **k: pytest.fail("kernel route"))
        rng = np.random.default_rng(22)
        codes = rng.integers(0, 5, 64)
        values = rng.normal(size=64).astype(np.float32)
        with flox_tpu_torch.set_options(pallas_scan_num_groups_max=3):
            out = flox_tpu_torch.groupby_scan(values, codes, func="cumsum", device="cpu")
        np.testing.assert_allclose(out.numpy(), _oracle("cumsum", values, codes),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("skipna", [False, True])
    def test_nonfinite_state_is_sticky_under_adversarial_magnitudes(self, skipna):
        rng = np.random.default_rng(99)
        n = 1600
        codes = (np.arange(n) % 3).astype(np.int32)
        values = (rng.choice([-1.0, 1.0], n) * rng.uniform(1e38, 3e38, n)).astype(np.float32)
        got = _pcumsum(values, codes, 3, skipna=skipna)
        for g in range(3):
            lane_ok = np.isfinite(got[codes == g])
            first_bad = np.argmax(~lane_ok) if (~lane_ok).any() else len(lane_ok)
            assert lane_ok[:first_bad].all()
            assert not lane_ok[first_bad:].any()


# ---------------------------------------------------------------------------
# ffill/bfill and the segmented torch path against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["auto", "segmented"])
@pytest.mark.parametrize("func", ["cumsum", "nancumsum", "ffill", "bfill"])
@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("add_nan", [False, True])
def test_groupby_scan_matches_reference(func, shape, add_nan, route):
    # the port's default route (the kernel's plain version for cumsum and
    # nancumsum) and its segmented torch path, each against the reference's
    # segmented path (its default on the CPU) on the same float32 data
    rng = np.random.default_rng(RNG_SEED)
    n, size = 50, 4
    codes = rng.integers(0, size, n)
    values = np.round(rng.normal(size=(3, n) if shape == "2d" else (n,)), 1)
    if add_nan:
        values[..., rng.random(n) < 0.3] = np.nan
    values = values.astype(np.float32)
    with flox_tpu.set_options(scan_impl="segmented"):
        ref = np.asarray(flox_tpu.groupby_scan(values, codes, func=func, engine="jax"))
    with flox_tpu_torch.set_options(scan_impl="segmented" if route == "segmented" else "auto"):
        got = flox_tpu_torch.groupby_scan(values, codes, func=func, device="cpu").numpy()
    assert got.dtype == ref.dtype
    if func in ("ffill", "bfill"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)


def test_many_groups_and_int_data_take_the_segmented_path(monkeypatch):
    monkeypatch.setattr(ck, "segment_cumsum", lambda *a, **k: pytest.fail("kernel route"))
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 200, 600)  # size + 1 > pallas_scan_num_groups_max
    values = rng.normal(size=(2, 600)).astype(np.float32)
    values[rng.random((2, 600)) < 0.1] = np.nan
    got = flox_tpu_torch.groupby_scan(values, codes, func="nancumsum", device="cpu")
    np.testing.assert_allclose(got.numpy(), _oracle("nancumsum", values, codes), rtol=1e-5,
                               atol=1e-5)
    ints = rng.integers(-9, 9, size=(2, 600)).astype(np.int32)
    got = flox_tpu_torch.groupby_scan(ints, codes, func="cumsum", device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _oracle("cumsum", ints, codes).astype(np.int64))


def test_scan_nan_labels():
    got, ref = _scan_both(np.array([1.0, 2.0, 3.0]), np.array([0.0, np.nan, 0.0]),
                          func="cumsum")
    np.testing.assert_allclose(got, [1.0, np.nan, 4.0], equal_nan=True)
    np.testing.assert_array_equal(got, ref)


def test_scan_axis():
    codes = np.array([[0, 1, 0], [0, 1, 0]])
    got, ref = _scan_both(np.arange(6.0).reshape(2, 3), codes, func="cumsum", axis=0)
    np.testing.assert_allclose(got, [[0, 1, 2], [3, 5, 7]])
    np.testing.assert_array_equal(got, ref)


def test_scan_int_promotion():
    got, ref = _scan_both(np.array([1, 2, 3], dtype=np.int32), np.array([0, 0, 0]),
                          func="cumsum")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, [1, 3, 6])
    np.testing.assert_array_equal(got, ref)


def test_scan_2d_labels():
    codes = np.array([[0, 0, 1], [1, 0, 1]])
    got, ref = _scan_both(np.arange(6.0).reshape(2, 3), codes, func="cumsum")
    np.testing.assert_allclose(got, [[0, 1, 2], [3, 4, 8]])
    np.testing.assert_array_equal(got, ref)


def test_ffill_bfill_reversal():
    rng = np.random.default_rng(RNG_SEED)
    codes = rng.integers(0, 3, 50)
    values = np.round(rng.normal(size=50), 1).astype(np.float32)
    values[rng.random(50) < 0.4] = np.nan
    b, ref = _scan_both(values, codes, func="bfill")
    np.testing.assert_array_equal(b, ref)
    f_rev = flox_tpu_torch.groupby_scan(values[::-1].copy(), codes[::-1].copy(), func="ffill",
                                        device="cpu").numpy()[::-1]
    np.testing.assert_array_equal(b, f_rev)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(3, 0), (0,)], ids=str)
@pytest.mark.parametrize("func", ["nancumsum", "cumsum", "ffill"])
def test_zero_length_axis(func, shape, dtype):
    """A scanned axis of length 0 (ROADMAP C1): an empty result of the
    reference's shape and dtype."""
    got, ref = _scan_both(np.zeros(shape, dtype), np.zeros(0, int), func=func,
                          expected_groups=np.arange(6))
    assert got.shape == shape
    np.testing.assert_array_equal(got, ref)


def test_segmented_scan_restarts_at_flags():
    values = torch.tensor([[1.0, 2.0, 3.0, np.inf, 5.0, 6.0, np.nan, 8.0]])
    flags = torch.tensor([True, False, False, True, False, True, False, True])
    out = pk._segmented_scan(values, flags, torch.add)
    want = [1.0, 3.0, 6.0, np.inf, np.inf, 6.0, np.nan, 8.0]
    np.testing.assert_array_equal(out[0].numpy(), np.array(want, np.float32))


@pytest.mark.parametrize(
    "kw,err,match",
    [
        ({"method": "blelloch"}, NotImplementedError, "A7"),
        # engine="numpy" is ported (A6): it scans as the reference's host engine
        pytest.param({"engine": "numpy"}, None, "A6", id="kw1-NotImplementedError-A6"),
        ({"axis": (0, 1)}, ValueError, "single axis"),
    ],
)
def test_unported_and_invalid_branches(kw, err, match):
    if err is None:
        ref = flox_tpu.groupby_scan(np.ones(4), np.zeros(4), func="cumsum", **kw)
        got = flox_tpu_torch.groupby_scan(np.ones(4), np.zeros(4), func="cumsum", device="cpu",
                                          **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        return
    with pytest.raises(err, match=match):
        flox_tpu_torch.groupby_scan(np.ones(4), np.zeros(4), func="cumsum", device="cpu", **kw)


def test_datetime_scan_names_roadmap_item():
    """A datetime scan raised naming ROADMAP A2 until the NaT channel was
    ported; it gives the reference's result now (more cases in
    tests/test_torch_datetime.py)."""
    dates = np.array(["2020-01-01", "NaT", "2020-01-03"], dtype="datetime64[ns]")
    got = flox_tpu_torch.groupby_scan(dates, np.zeros(3), func="ffill", device="cpu")
    ref = np.asarray(flox_tpu.groupby_scan(dates, np.zeros(3), func="ffill", engine="jax"))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.view("int64"), ref.view("int64"))


# ---------------------------------------------------------------------------
# the kernel (csrc/segment_cumsum.cu): its order against the reference, and
# the host side of its launch, on the CPU. The kernel itself is held on the
# card by chip_smoke.py, bit for bit against a float32 column-order
# emulation of its walk.
# ---------------------------------------------------------------------------


def _walk_f32(values, codes, size, skipna):
    """What the CUDA kernel computes, in numpy float32: per row, each group's
    running sum of its finite values, sequential in column order (one float32
    add each), with sticky NaN (unless ``skipna``), +inf and -inf markers and
    the first overflow of the running sum while the group has none."""
    k, n = values.shape
    idx = np.where((codes >= 0) & (codes < size), codes, size)
    run = np.zeros((size + 1, k), np.float32)
    nan_s, pos_s, neg_s = (np.zeros((size + 1, k), bool) for _ in range(3))
    out = np.empty((k, n), np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for c in range(n):
            g, x = idx[c], values[:, c]
            r = np.where(np.isfinite(x), run[g] + x, run[g])
            ovf = ~(nan_s[g] | pos_s[g] | neg_s[g]) & np.isinf(r)
            pos_s[g] |= np.isposinf(x) | (ovf & (r > 0))
            neg_s[g] |= np.isneginf(x) | (ovf & (r < 0))
            if not skipna:
                nan_s[g] |= np.isnan(x)
            run[g] = r
            res = np.where(pos_s[g], np.inf, np.where(neg_s[g], -np.inf, r))
            out[:, c] = np.where(nan_s[g] | (pos_s[g] & neg_s[g]), np.nan, res)
    return out


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("k,n,size", [(3, 300, 5), (2, 700, 1), (2, 257, 40), (4, 90, 127)])
def test_kernel_order_within_reference_bar(skipna, k, n, size):
    """The kernel's order, a sequential float32 running sum per (group, row)
    in column order, lies within the bar the plain version is held to
    against the Pallas kernel (interpret mode): the same non-finite
    positions, and each finite running sum within ``n_g * u * cumsum|x|``
    plus one ulp; against the plain version too."""
    import jax.numpy as jnp

    rng = np.random.default_rng(k * n + size + 1)
    values = (rng.normal(size=(k, n)) * 10).astype(np.float32)
    values[rng.random((k, n)) < 0.05] = np.nan
    values[0, n // 3] = np.inf
    values[-1, n // 2] = -np.inf
    codes = rng.integers(-1, size + 2, n).astype(np.int32)
    got = _walk_f32(values, codes, size, skipna).astype(np.float64)
    pallas = np.asarray(segment_cumsum_pallas(jnp.asarray(values.T), codes, size, skipna=skipna,
                                              interpret=True)).T.astype(np.float64)
    plain = ck.segment_cumsum_plain(torch.from_numpy(values), torch.from_numpy(codes), size,
                                    skipna).double().numpy()
    bound = _scan_bound(np.where(np.isfinite(values), values, 0.0).astype(np.float64), codes,
                        size)
    for want in (pallas, plain):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got) * np.sign(got), np.isinf(want) * np.sign(want))
        finite = np.isfinite(want)
        err = np.abs(got[finite] - want[finite])
        assert np.all(err <= bound[finite] + np.abs(want[finite]) * 2.0**-23)


class _FakeScanLib:
    """Stands in for the kernel's library: records each entry-point call."""

    def __init__(self):
        self.calls = []

    def flox_segment_cumsum(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_scan_card(monkeypatch):
    """The launch path of the B4 wrapper on CPU tensors, with the library and
    the stream faked; returns the fake library and the scratch the wrapper
    allocated."""
    lib = _FakeScanLib()
    states = []
    real_state = ck._cumsum_state

    def record_state(size, k, device):
        states.append(real_state(size, k, device))
        return states[-1]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ck, "_lib", lambda name, argtypes: lib)
    monkeypatch.setattr(ck, "_stream", lambda device: None)
    monkeypatch.setattr(ck, "_cumsum_state", record_state)
    return lib, states


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [37, 600, 65160])
def test_cumsum_launch_arguments(fake_scan_card, dtype, skipna, k):
    """What the B4 wrapper hands the C entry point: the data in place, the
    int32 codes, (K, N, size), skipna, the (size + 1, K) scratch of 8-byte
    (running sum, markers) pairs it allocated, and the (K, N) output in the
    data dtype it returns; one launch counted."""
    lib, states = fake_scan_card
    rng = np.random.default_rng(8)
    n, size = 40, 12
    data = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dtype)
    codes = torch.from_numpy(rng.integers(-1, size + 2, n).astype(np.int32))
    before = dict(ck.LAUNCHES)
    out = ck._segment_cumsum_cuda(data, codes, size, skipna)
    assert ck.LAUNCHES["segment_cumsum"] == before["segment_cumsum"] + 1
    assert {kk: v for kk, v in ck.LAUNCHES.items() if kk != "segment_cumsum"} == {
        kk: v for kk, v in before.items() if kk != "segment_cumsum"}
    ((args,),) = [lib.calls]
    (state,) = states
    assert state.dtype == torch.int32 and tuple(state.shape) == (size + 1, k, 2)
    assert state.numel() * state.element_size() == 8 * (size + 1) * k
    assert args == (data.data_ptr(), {torch.float32: 0, torch.bfloat16: 1}[dtype],
                    codes.data_ptr(), k, n, size, int(skipna), state.data_ptr(),
                    out.data_ptr(), None)
    assert out.dtype == dtype and tuple(out.shape) == (k, n)


def test_cumsum_launch_sends_out_of_range_codes_to_the_missing_group(fake_scan_card):
    """int64 codes reach the kernel as int32, with every code outside [0,
    size) at -1 first, so that none wraps into a real group."""
    lib, _ = fake_scan_card
    seen = []
    real = ck._codes_int32

    def record(codes, size):
        seen.append(real(codes, size))
        return seen[-1]

    codes = torch.tensor([0, 3, 2**32 + 1, -5, 4, 1], dtype=torch.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "_codes_int32", record)
        ck._segment_cumsum_cuda(torch.zeros(2, 6), codes, 4, False)
    (sent,) = seen
    assert sent.dtype == torch.int32 and sent.tolist() == [0, 3, -1, -1, -1, 1]
    assert lib.calls[0][2] == sent.data_ptr()


@pytest.mark.parametrize("shape", [(5, 0), (0, 7), (0, 0)], ids=str)
def test_cumsum_launch_nothing_to_scan(fake_scan_card, shape):
    """With no rows or no columns there is nothing to scan: no launch, and
    an empty result of the data's shape and dtype."""
    lib, states = fake_scan_card
    before = dict(ck.LAUNCHES)
    out = ck._segment_cumsum_cuda(torch.zeros(shape, dtype=torch.bfloat16),
                                  torch.zeros(shape[1], dtype=torch.int32), 3, True)
    assert lib.calls == [] and states == [] and ck.LAUNCHES == before
    assert tuple(out.shape) == shape and out.dtype == torch.bfloat16


@pytest.mark.parametrize("kwargs,err", [
    ({"size": 512}, ValueError),  # size + 1 groups, the missing one included
    ({"size": -1}, ValueError),
    ({"dtype": torch.float64}, TypeError),
    ({"dtype": torch.int32}, TypeError),
    ({"codes_dtype": torch.float32}, TypeError),
    ({"n_codes": 15}, ValueError),
], ids=["groups", "negative", "float64", "int32", "float-codes", "codes-length"])
def test_cumsum_argument_checks(kwargs, err):
    """The B4 wrapper refuses what its C entry point refuses, before any
    device dispatch."""
    args = {"size": 3, "dtype": torch.float32, "codes_dtype": torch.int32, "n_codes": 16}
    args.update(kwargs)
    data = torch.zeros((2, 16), dtype=args["dtype"])
    codes = torch.zeros(args["n_codes"], dtype=args["codes_dtype"])
    with pytest.raises(err):
        ck.segment_cumsum(data, codes, args["size"], skipna=False)


def test_cumsum_largest_size_runs():
    """size = 511, with the missing-label group 512 groups, is the most the
    kernel takes; the wrapper accepts it."""
    data = torch.ones(2, 600)
    codes = torch.arange(600, dtype=torch.int32) - 44  # -44..-1 missing, 511.. missing
    out = ck.segment_cumsum(data, codes, 511, skipna=False)
    assert out[0, 44:555].eq(1.0).all() and out[0, :44].tolist() == list(range(1, 45))
