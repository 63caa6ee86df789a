"""The port's kernel module (flox_tpu_torch.cuda_kernels) against the
reference's Pallas kernels, on the CPU.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels in interpret mode. The same numpy inputs, made from a seed,
go to both. The CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``.

Tolerances:
* NaN/+inf/-inf marker counts and min/max results: exact.
* Sums: ``|port - ref| <= 1e-5 * S`` per (group, column), where ``S`` is the
  sum of the absolute finite values. The two sides add in different orders
  (``index_add_`` against the Pallas kernel's 512-column tile contractions),
  and the rounding error of a float32 sum of these sizes is bounded well
  inside that: 1e-5 is about 170 float32 epsilons.
"""

import numpy as np
import pytest
import torch

from flox_tpu.pallas_kernels import segment_minmax_pallas, segment_sum_raw_pallas
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import set_options

ACCUMS = ["plain", "kahan", "dd"]


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (returned as float32)."""
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _sum_inputs(seed, k, n, size, dtype):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(k, n)).astype(np.float32) * 10
    data[rng.random((k, n)) < 0.03] = np.nan
    data[rng.random((k, n)) < 0.01] = np.inf
    data[rng.random((k, n)) < 0.01] = -np.inf
    codes = rng.integers(-1, size + 2, n).astype(np.int32)  # -1 and >= size drop out
    if size > 2:
        codes[codes == 1] = 0  # an empty group
    if dtype == "bfloat16":
        data = _bf16_round(data)
    return data, codes


def _to_torch(data, dtype):
    t = torch.from_numpy(np.ascontiguousarray(data))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_ref(data_kn, dtype):
    """The reference's (N, K) logical view, in the same dtype."""
    import jax.numpy as jnp

    arr = jnp.asarray(np.ascontiguousarray(data_kn.T))
    return arr.astype(jnp.bfloat16) if dtype == "bfloat16" else arr


def _abs_sums(data, codes, size):
    finite = np.where(np.isfinite(data), np.abs(data.astype(np.float64)), 0.0)
    out = np.zeros((size, data.shape[0]))
    for g in range(size):
        out[g] = finite[:, codes == g].sum(axis=1)
    return out


class TestSegmentSumPlainVsPallas:
    @pytest.mark.parametrize("accum", ACCUMS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("k,n,size", [(5, 1031, 12), (3, 700, 1), (2, 333, 40)])
    def test_raw_matches(self, accum, dtype, k, n, size):
        data, codes = _sum_inputs(k * n + size, k, n, size, dtype)
        got = ck.segment_sum_raw(_to_torch(data, dtype), torch.from_numpy(codes), size, accum)
        want = segment_sum_raw_pallas(
            _to_ref(data, dtype), codes, size, interpret=True, accum=accum
        )
        sums, nan_c, pos_c, neg_c = (t.numpy() for t in got)
        rsums, rnan, rpos, rneg = (np.asarray(w, dtype=np.float64) for w in want)
        assert sums.shape == (size, k) and sums.dtype == np.float32
        np.testing.assert_array_equal(nan_c, rnan)
        np.testing.assert_array_equal(pos_c, rpos)
        np.testing.assert_array_equal(neg_c, rneg)
        tol = 1e-5 * _abs_sums(data, codes, size)
        assert np.all(np.abs(sums - rsums) <= tol), np.max(np.abs(sums - rsums) - tol)

    def test_markers_and_sums_exact_small(self):
        # integers sum exactly in any order: every accumulation agrees bit for bit
        codes = np.array([0, 1, 0, 1, 2, -1, 0, 1] * 4, np.int32)
        data = np.arange(2 * 32, dtype=np.float32).reshape(2, 32)
        data[0, 0] = np.inf
        data[1, 1] = -np.inf
        data[1, 3] = np.nan
        for accum in ACCUMS:
            got = ck.segment_sum_raw(torch.from_numpy(data), torch.from_numpy(codes), 3, accum)
            want = segment_sum_raw_pallas(data.T, codes, 3, interpret=True, accum=accum)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_reapplied_sum_matches_ieee(self):
        codes = np.array([0, 1, 0, 1] * 4, np.int32)
        data = np.zeros((2, 16), np.float32)
        data[0, 0] = np.inf
        data[0, 2] = -np.inf  # +inf and -inf in one group: NaN
        data[1, 1] = np.nan
        out = ck.segment_sum(torch.from_numpy(data), torch.from_numpy(codes), 2).numpy()
        assert np.isnan(out[0, 0]) and out[1, 0] == 0.0
        assert np.isnan(out[1, 1]) and out[0, 1] == 0.0
        skip = ck.segment_sum(torch.from_numpy(data), torch.from_numpy(codes), 2, skipna=True)
        assert skip.numpy()[1, 1] == 0.0


class TestSegmentSumAccuracyBars:
    """The reference's accumulation bars (tests/test_kernels.py,
    ``test_pallas_kahan_accuracy`` and ``TestPallasDoubleDouble``), held on
    the port's plain version of the segment-sum kernel."""

    def _sum(self, data_nk, codes, size, accum):
        data = torch.from_numpy(np.ascontiguousarray(data_nk.T))
        return ck.segment_sum(data, torch.from_numpy(codes), size, accum).numpy()

    def test_kahan_within_one_ulp(self):
        rng = np.random.default_rng(0)
        n = 100_000
        data = rng.normal(1e4, 1, size=(n, 1)).astype(np.float32)
        codes = np.zeros(n, dtype=np.int32)
        oracle = data.astype(np.float64).sum()
        plain = float(self._sum(data, codes, 1, "plain")[0, 0])
        kahan = float(self._sum(data, codes, 1, "kahan")[0, 0])
        ulp = np.spacing(np.float32(oracle)).astype(np.float64)
        assert abs(kahan - oracle) <= ulp
        assert abs(kahan - oracle) <= abs(plain - oracle)

    def test_dd_is_correctly_rounded_f64(self):
        rng = np.random.default_rng(1)
        n = 200_000
        data = rng.normal(1e4, 1, size=(n, 1)).astype(np.float32)
        codes = (np.arange(n) % 3).astype(np.int32)
        got = self._sum(data, codes, 3, "dd")
        for g in range(3):
            oracle = data[codes == g].astype(np.float64).sum()
            assert got[g, 0] == np.float32(oracle), (g, got[g, 0], oracle)

    def test_dd_cancellation(self):
        n = 4096
        data = np.zeros((n, 1), np.float32)
        data[: n // 2, 0] = 3e7
        data[n // 2 :, 0] = -3e7
        data[0, 0] += 1.0
        codes = np.zeros(n, dtype=np.int32)
        got = float(self._sum(data, codes, 1, "dd")[0, 0])
        assert got == np.float32(data.astype(np.float64).sum())

    def test_dd_large_and_huge_values(self):
        codes = np.zeros(256, dtype=np.int32)
        big = np.full((256, 1), 2e34, np.float32)
        assert float(self._sum(big, codes, 1, "dd")[0, 0]) == np.float32(
            big.astype(np.float64).sum()
        )
        huge = np.full((256, 1), 1e35, np.float32)
        got = float(self._sum(huge, codes, 1, "dd")[0, 0])
        assert np.isfinite(got)
        np.testing.assert_allclose(got, huge.astype(np.float64).sum(), rtol=1e-5)

    def test_dd_nonfinite_semantics_preserved(self):
        data = np.ones((600, 1), np.float32)
        data[10, 0] = np.inf
        data[20, 0] = np.nan
        codes = (np.arange(600) % 3).astype(np.int32)
        got = self._sum(data, codes, 3, "dd")
        assert np.isposinf(got[1, 0]) and np.isnan(got[2, 0]) and np.isfinite(got[0, 0])

    def test_unknown_accum_rejected(self):
        data = torch.ones((1, 8))
        codes = torch.zeros(8, dtype=torch.int32)
        with pytest.raises(ValueError, match="accum"):
            ck.segment_sum_raw(data, codes, 1, accum="khan")

    def test_accum_follows_option(self):
        rng = np.random.default_rng(2)
        data = torch.from_numpy(rng.normal(size=(2, 1000)).astype(np.float32))
        codes = torch.from_numpy((np.arange(1000) % 4).astype(np.int32))
        with set_options(pallas_accum="plain"):
            via_opt = ck.segment_sum_raw(data, codes, 4)[0]
        explicit = ck.segment_sum_raw(data, codes, 4, accum="plain")[0]
        assert torch.equal(via_opt, explicit)


class TestSegmentMinmaxPlainVsPallas:
    @pytest.mark.parametrize("op", ["min", "max"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
    @pytest.mark.parametrize("k,n,size", [(4, 301, 6), (3, 1000, 1), (2, 257, 128)])
    def test_matches_exactly(self, op, dtype, k, n, size):
        rng = np.random.default_rng(k * n + size)
        codes = rng.integers(-1, size + 2, n).astype(np.int32)
        if size > 2:
            codes[codes == 1] = 0  # an empty group
        if dtype == "int32":
            data = rng.integers(-1000, 1000, size=(k, n)).astype(np.int32)
            tdata, rdata = torch.from_numpy(data), data.T.copy()
        else:
            data = rng.normal(size=(k, n)).astype(np.float32)
            data[rng.random((k, n)) < 0.01] = np.nan  # propagates on both sides
            if dtype == "bfloat16":
                data = _bf16_round(data)
            tdata, rdata = _to_torch(data, dtype), _to_ref(data, dtype)
        got = ck.segment_minmax(tdata, torch.from_numpy(codes), size, op)
        want = segment_minmax_pallas(rdata, codes, size, op, interpret=True)
        assert got.dtype == tdata.dtype and got.shape == (size, k)
        if dtype == "int32":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:  # bf16 and f32 widen exactly; NaN compares equal to NaN here
            np.testing.assert_array_equal(
                got.to(torch.float64).numpy(), np.asarray(want).astype(np.float64)
            )

    def test_empty_groups_hold_identity(self):
        data = torch.arange(16, dtype=torch.float32).reshape(2, 8)
        codes = torch.zeros(8, dtype=torch.int32)
        out = ck.segment_minmax(data, codes, 3, "max")
        assert torch.equal(out[0], torch.tensor([7.0, 15.0]))
        assert torch.isneginf(out[1:]).all()
        ints = ck.segment_minmax(data.to(torch.int32), codes, 3, "min")
        assert (ints[1:] == torch.iinfo(torch.int32).max).all()


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it is
    handed a CUDA tensor, on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class TestNoFallback:
    def _cuda_typed(self):
        data = torch.zeros(4, 16).as_subclass(_CudaTyped)
        codes = torch.zeros(16, dtype=torch.int32).as_subclass(_CudaTyped)
        return data, codes

    def _forbid_plain(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("a CUDA request fell back to the plain version")

        monkeypatch.setattr(ck, "segment_sum_raw_plain", boom)
        monkeypatch.setattr(ck, "segment_minmax_plain", boom)

    def test_cuda_request_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        self._forbid_plain(monkeypatch)
        data, codes = self._cuda_typed()
        before = dict(ck.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.segment_sum_raw(data, codes, 3, "kahan")
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.segment_minmax(data, codes, 3, "max")
        assert ck.LAUNCHES == before

    def test_other_devices_rejected(self):
        data = torch.zeros(4, 16, device="meta")
        codes = torch.zeros(16, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="device"):
            ck.segment_sum_raw(data, codes, 3)
        with pytest.raises(ValueError, match="device"):
            ck.segment_minmax(data, codes, 3, "min")

    @pytest.mark.parametrize(
        "kwargs,err",
        [
            ({"data": torch.zeros(4, 16, dtype=torch.float64)}, TypeError),
            ({"data": torch.zeros(16)}, ValueError),
            ({"codes": torch.zeros(15, dtype=torch.int32)}, ValueError),
            ({"size": 513}, ValueError),
            ({"size": 0}, ValueError),
        ],
    )
    def test_argument_checks(self, kwargs, err):
        args = {"data": torch.zeros(4, 16), "codes": torch.zeros(16, dtype=torch.int32), "size": 3}
        args.update(kwargs)
        with pytest.raises(err):
            ck.segment_sum_raw(args["data"], args["codes"], args["size"])

    def test_cpu_uses_plain_and_counts_no_launch(self):
        before = dict(ck.LAUNCHES)
        data = torch.ones(2, 32)
        codes = torch.zeros(32, dtype=torch.int32)
        assert ck.segment_sum_raw(data, codes, 1)[0].tolist() == [[32.0, 32.0]]
        assert ck.segment_minmax(data, codes, 1, "max").tolist() == [[1.0, 1.0]]
        assert ck.LAUNCHES == before


class TestScanOptionsFromReference:
    """The scan options carried across from the reference's option set."""

    @pytest.mark.parametrize(
        "ref,port",
        [
            ({"scan_impl": "pallas"}, {"scan_impl": "kernel"}),
            ({"scan_impl": "segmented"}, {"scan_impl": "segmented"}),
            ({"scan_impl": "auto", "pallas_scan_num_groups_max": 64},
             {"scan_impl": "auto", "pallas_scan_num_groups_max": 64}),
        ],
    )
    def test_mapped(self, ref, port):
        from flox_tpu_torch.options import from_reference

        assert from_reference(ref) == port

    def test_reference_defaults_carry_over(self):
        from flox_tpu import options as ref_options
        from flox_tpu_torch.options import OPTIONS, from_reference

        got = from_reference(dict(ref_options.OPTIONS))
        assert got["scan_impl"] == "auto"
        assert got["pallas_scan_num_groups_max"] == OPTIONS["pallas_scan_num_groups_max"] == 128

    @pytest.mark.parametrize(
        "opts", [{"scan_impl": "sorted"}, {"pallas_scan_num_groups_max": 513}]
    )
    def test_invalid_rejected(self, opts):
        from flox_tpu_torch.options import from_reference

        with pytest.raises(ValueError):
            from_reference(opts)
        with pytest.raises(ValueError):
            set_options(**opts)


class TestNoFallbackNewKernels(TestNoFallback):
    """The multi-statistic and segmented-cumsum wrappers keep the same
    contract: a CUDA tensor reaches its kernel or the call raises."""

    def test_cuda_request_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

        def boom(*a, **k):
            raise AssertionError("a CUDA request fell back to the plain version")

        monkeypatch.setattr(ck, "segment_multistat_plain", boom)
        monkeypatch.setattr(ck, "segment_cumsum_plain", boom)
        data, codes = self._cuda_typed()
        before = dict(ck.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.segment_multistat(data, codes, 3, "kahan")
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.segment_cumsum(data, codes, 3, skipna=True)
        assert ck.LAUNCHES == before

    def test_other_devices_rejected(self):
        data = torch.zeros(4, 16, device="meta")
        codes = torch.zeros(16, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="device"):
            ck.segment_multistat(data, codes, 3)
        with pytest.raises(ValueError, match="device"):
            ck.segment_cumsum(data, codes, 3, skipna=False)

    @pytest.mark.parametrize(
        "kwargs,err",
        [
            ({"data": torch.zeros(4, 16, dtype=torch.int32)}, TypeError),
            ({"data": torch.zeros(16)}, ValueError),
            ({"codes": torch.zeros(15, dtype=torch.int32)}, ValueError),
            ({"size": 512}, ValueError),  # size + 1 groups, the missing one included
            ({"size": 0}, ValueError),
        ],
    )
    def test_argument_checks(self, kwargs, err):
        args = {"data": torch.zeros(4, 16), "codes": torch.zeros(16, dtype=torch.int32), "size": 3}
        args.update(kwargs)
        with pytest.raises(err):
            ck.segment_cumsum(args["data"], args["codes"], args["size"], skipna=False)

    def test_cpu_uses_plain_and_counts_no_launch(self):
        before = dict(ck.LAUNCHES)
        data = torch.ones(2, 32)
        codes = torch.zeros(32, dtype=torch.int32)
        sums, _, _, _, mins, maxs = ck.segment_multistat(data, codes, 1)
        assert sums.tolist() == [[32.0, 32.0]] and mins.tolist() == maxs.tolist() == [[1.0, 1.0]]
        assert ck.segment_cumsum(data, codes, 1, skipna=False)[0, -1].item() == 32.0
        assert ck.LAUNCHES == before


# ---------------------------------------------------------------------------
# B1 and B2 on binned codes (csrc/segment_reduce.cuh): the host side of the
# launch, on the CPU. The kernels themselves are held on the card by
# chip_smoke.py (bit for bit against the radix-binning kernel and against a
# column-order emulation of their walk).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,k,n,slots,want", [
    (12, 65160, 26304, 396, 1),  # the main path's months: 3060 blocks
    (12, 65160, 26304, 264, 1),  # the same in bfloat16 (2 blocks an SM)
    (24, 65160, 26304, 396, 1),  # hour of day
    (512, 65160, 26304, 396, 1),  # 51 columns a group
    (512, 65160, 2048, 396, 8),  # 4 columns a group: 8 make a stage
    (512, 600, 2048, 396, 3),  # ... but 3 row tiles need 132 segments to fill 396 slots
    (512, 37, 2048, 396, 1),  # one row tile: a block per group
    (12, 65160, 100, 264, 4),
    (1, 5, 3, 396, 1),
])
def test_groups_per_block(size, k, n, slots, want):
    assert ck._groups_per_block(size, k, n, slots) == want


@pytest.mark.parametrize("size", [1, 2, 5, 12, 24, 100, 128, 511, 512])
def test_groups_per_block_rule(size):
    """The derived groups per block: one while the groups average a
    32-column stage; else no more than make a stage, and as many as make
    one unless the grid would then drop below the resident slots."""
    for k in (1, 37, 256, 257, 600, 8192, 65160, 10**6):
        for n in (1, 8, 100, 2048, 26304):
            for slots in (264, 396):
                g = ck._groups_per_block(size, k, n, slots)
                tiles = -(-k // 256)
                assert 1 <= g <= size
                if n >= 32 * size:
                    assert g == 1
                assert g == 1 or (g - 1) * n < 32 * size  # no more than make a stage
                if g < min(-(-32 * size // n), size):  # fewer than make a stage
                    assert g == max(1, size * tiles // slots)  # ... to keep the grid full


def _pattern_codes(pattern, n, rng):
    """Codes and size of the layouts the tests bin: months and hours of
    hourly steps, days of the year of daily steps, random codes (with -1 and
    out-of-range ones)."""
    day = np.datetime64("1981-09-01") + np.arange(n)
    return {
        "months": (((np.arange(n) // 24 % 365) // 30.44).astype(np.int64) % 12, 12),
        "hour_of_day": (np.arange(n) % 24, 24),
        "day_of_year": ((day - day.astype("datetime64[Y]").astype("datetime64[D]"))
                        .astype(np.int64), 366),
        "random12": (rng.integers(-1, 13, n), 12),
        "random512": (rng.integers(0, 520, n), 512),
    }[pattern]


@pytest.mark.parametrize("pattern", ["months", "hour_of_day", "random12", "random512"])
def test_segments_read_each_column_once(pattern):
    """With g groups per block, the block over groups [g0, g0 + g) reads
    ``perm[offsets[g0] : offsets[min(g0 + g, size)]]``: exactly the columns
    whose codes fall in those groups, in code order and then column order;
    together the segments read every valid column once."""
    codes, size = _pattern_codes(pattern, 26304, np.random.default_rng(5))
    perm, _, offsets = (t.numpy() for t in ck._radixbin_bins(torch.from_numpy(codes), size))
    for g in (1, 4, 7):
        seen = []
        for g0 in range(0, size, g):
            g1 = min(g0 + g, size)
            cols = perm[offsets[g0]:offsets[g1]]
            mine = np.flatnonzero((codes >= g0) & (codes < g1))
            np.testing.assert_array_equal(cols, mine[np.lexsort((mine, codes[mine]))])
            seen.append(cols)
        np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                      np.flatnonzero((codes >= 0) & (codes < size)))


@pytest.mark.parametrize("pattern", ["months", "hour_of_day", "day_of_year", "random12",
                                     "random512"])
def test_windows_read_each_column_once(pattern):
    """Under B1's window walk the bins order the columns by code // 8: the
    window over groups [g0, g0 + 8) reads ``perm[offsets[g0] :
    offsets[min(g0 + 8, size)]]``, exactly the columns whose codes fall in
    those groups, in column order, with their codes beside them in
    ``sorted_codes``; together the windows read every valid column once, the
    invalid ones last; and ``offsets`` at each window's first group and at
    ``size`` keeps the code-major bins' counts."""
    n = 14532
    codes, size = _pattern_codes(pattern, n, np.random.default_rng(8))
    perm, scodes, offsets = (t.numpy() for t in ck._radixbin_bins(torch.from_numpy(codes),
                                                                   size, ck._WINDOW))
    code_major = ck._radixbin_bins(torch.from_numpy(codes), size)[2].numpy()
    np.testing.assert_array_equal(offsets[::ck._WINDOW], code_major[::ck._WINDOW])
    assert offsets[size] == code_major[size] == np.count_nonzero((codes >= 0) & (codes < size))
    seen = []
    for g0 in range(0, size, ck._WINDOW):
        g1 = min(g0 + ck._WINDOW, size)
        cols = perm[offsets[g0]:offsets[g1]]
        np.testing.assert_array_equal(cols, np.flatnonzero((codes >= g0) & (codes < g1)))
        np.testing.assert_array_equal(scodes[offsets[g0]:offsets[g1]], codes[cols])
        seen.append(cols)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.flatnonzero((codes >= 0) & (codes < size)))
    np.testing.assert_array_equal(scodes[offsets[size]:], -(-size // 8) * 8)  # past the windows


@pytest.mark.parametrize("size,n,want", [
    (366, 14532, 8),  # OISST: days of the year over 14532 days
    (366, 6576, 8),  # one card of the four-card ERA5 cell: hourly days of the year
    (12, 26304, 1),  # the main path's months over 26304 hours
    (24, 26304, 1),  # hour of day: left to the run walk
    (12, 1535, 8),  # just under four stages a group
    (12, 1536, 1),  # four stages a group: the run walk
    (366, 46847, 8),
    (366, 46848, 1),
    (512, 65535, 8),
    (512, 65536, 1),
    (3, 383, 8),  # fewer groups than a window: one window holds them all
    (3, 384, 1),
    (1, 127, 8),
    (1, 128, 1),
])
def test_window_rule(size, n, want):
    """B1 takes its window walk where the groups average fewer than four
    32-column stages (n < 128 * size), and its run walk otherwise."""
    assert ck._window(size, n) == want


class _FakeLib:
    """Stands in for a kernel's library: records each entry-point call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("flox_segment"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The launch path of the B1/B2 wrappers on CPU tensors, with the
    library, the stream and the card's SM count faked; returns the fake
    library and the bins the wrapper made."""
    lib = _FakeLib()
    bins = []
    real_bins = ck._radixbin_bins

    def record_bins(codes, size, window=1):
        bins.append(real_bins(codes, size, window))
        return bins[-1]

    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    monkeypatch.setattr(ck, "_lib", lambda name, argtypes: lib)
    monkeypatch.setattr(ck, "_stream", lambda device: None)
    monkeypatch.setattr(ck, "_radixbin_bins", record_bins)
    return lib, bins


def _launch_with_telemetry(name, data, codes, size, mode):
    """:func:`_segment_reduce_cuda` with telemetry on: its outputs, the
    ``kernels.window_launches`` count and the ``launch`` spans' attributes."""
    from flox_tpu_torch import telemetry

    telemetry.reset()
    try:
        with set_options(telemetry=True):
            outs = ck._segment_reduce_cuda(name, data, codes, size, mode)
        counted = telemetry.METRICS.get("kernels.window_launches")
        spans = [r["attrs"] for r in telemetry.spans()
                 if r["type"] == "span" and r["name"] == "launch"]
    finally:
        telemetry.reset()
    return outs, counted, spans


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["segment_sum", "segment_multistat"])
def test_binned_launch_arguments(fake_card, name, dtype):
    """What the wrapper hands the C entry point: the data in place, the
    binned codes of :func:`_radixbin_bins`, (K, N, size), the groups per
    block, the accum code and the outputs it returns; one launch counted. At
    300 columns over 12 groups (fewer than four 32-column stages a group)
    B1 takes its window walk: bins by code // 8, 8 groups a block, a window
    argument of 8 before the accum, one ``kernels.window_launches`` and
    ``window`` 8 on the ``launch`` span. B2 keeps its run walk: code-major
    bins, the derived groups per block (3 float32 blocks or 2 bfloat16 ones
    on each of 132 SMs), no window argument, ``window`` 1."""
    lib, bins = fake_card
    rng = np.random.default_rng(6)
    k, n, size = 600, 300, 12
    data = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dtype)
    codes = torch.from_numpy(rng.integers(-1, size + 2, n))
    before = dict(ck.LAUNCHES)
    outs, counted, spans = _launch_with_telemetry(name, data, codes, size, "dd")
    assert ck.LAUNCHES[name] == before[name] + 1
    assert {kk: v for kk, v in ck.LAUNCHES.items() if kk != name} == {
        kk: v for kk, v in before.items() if kk != name}
    ((entry, args),) = lib.calls
    assert entry == f"flox_{name}"
    perm, sorted_codes, offsets = bins[0]
    windowed = name == "segment_sum"
    want_bins = ck._radixbin_bins(codes, size, 8 if windowed else 1)
    assert all(torch.equal(a, b) for a, b in zip(bins[0], want_bins))
    slots = 132 * (3 if dtype == torch.float32 else 2)
    groups = 8 if windowed else ck._groups_per_block(size, k, n, slots)
    assert args[:9] == (data.data_ptr(), {torch.float32: 0, torch.bfloat16: 1}[dtype],
                        perm.data_ptr(), sorted_codes.data_ptr(), offsets.data_ptr(), k, n,
                        size, groups)
    assert args[9:11 if windowed else 10] == ((8, 2) if windowed else (2,))
    assert args[11 if windowed else 10:-1] == tuple(o.data_ptr() for o in outs)
    assert counted == (1 if windowed else 0)
    assert spans == [{"kernel": name, "nbytes": k * n * data.element_size() + n * 4
                      + sum(o.nbytes for o in outs), "window": 8 if windowed else 1}]
    assert len(outs) == (6 if name == "segment_multistat" else 4)
    for o in outs[:4]:
        assert o.dtype == torch.float32 and tuple(o.shape) == (size, k)
    for o in outs[4:]:
        assert o.dtype == dtype and tuple(o.shape) == (size, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_binned_launch_arguments_run_walk(fake_card, dtype):
    """B1 where the groups average four 32-column stages or more (2000
    columns over 12 groups): its run walk, as before the window walk, with
    code-major bins, the derived groups per block and a window argument of
    1; no ``kernels.window_launches``."""
    lib, bins = fake_card
    rng = np.random.default_rng(9)
    k, n, size = 600, 2000, 12
    data = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dtype)
    codes = torch.from_numpy(rng.integers(-1, size + 2, n))
    outs, counted, spans = _launch_with_telemetry("segment_sum", data, codes, size, "kahan")
    ((entry, args),) = lib.calls
    assert entry == "flox_segment_sum"
    assert all(torch.equal(a, b) for a, b in zip(bins[0], ck._radixbin_bins(codes, size)))
    perm, sorted_codes, offsets = bins[0]
    slots = 132 * (3 if dtype == torch.float32 else 2)
    assert args == (data.data_ptr(), {torch.float32: 0, torch.bfloat16: 1}[dtype],
                    perm.data_ptr(), sorted_codes.data_ptr(), offsets.data_ptr(), k, n, size,
                    ck._groups_per_block(size, k, n, slots), 1, 1,
                    *(o.data_ptr() for o in outs), None)
    assert counted == 0 and [s["window"] for s in spans] == [1]


@pytest.mark.parametrize("size", [1, 3, 7, 8, 9])
def test_window_launch_groups(fake_card, size):
    """The window walk's block holds min(8, size) groups: one window holds
    all of fewer than 8 groups, and a last window the remainder."""
    lib, bins = fake_card
    k, n = 300, 100
    codes = torch.from_numpy(np.random.default_rng(size).integers(-1, size + 1, n))
    ck._segment_reduce_cuda("segment_sum", torch.ones((k, n)), codes, size, "plain")
    ((entry, args),) = lib.calls
    assert entry == "flox_segment_sum" and args[7:11] == (size, min(8, size), 8, 0)
    assert all(torch.equal(a, b) for a, b in zip(bins[0], ck._radixbin_bins(codes, size, 8)))


@pytest.mark.parametrize("shape", [(5, 0), (0, 7), (0, 0)], ids=str)
@pytest.mark.parametrize("name", ["segment_sum", "segment_multistat", "segment_minmax"])
def test_binned_launch_nothing_to_read(fake_card, name, shape):
    """With no rows or no columns there is no launch: every group is empty,
    so the sums and markers are zeros and the extrema the identities."""
    lib, _ = fake_card
    before = dict(ck.LAUNCHES)
    mode = "max" if name == "segment_minmax" else "kahan"
    outs = ck._segment_reduce_cuda(name, torch.zeros(shape), torch.zeros(shape[1],
                                   dtype=torch.int32), 3, mode)
    assert lib.calls == [] and ck.LAUNCHES == before
    if name == "segment_minmax":
        (out,) = outs
        assert tuple(out.shape) == (3, shape[0]) and torch.isneginf(out).all()
        return
    for o in outs[:4]:
        assert tuple(o.shape) == (3, shape[0]) and not o.any()
    if name == "segment_multistat":
        assert torch.isposinf(outs[4]).all() and torch.isneginf(outs[5]).all()


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_minmax_launch_arguments(fake_card, dtype, op):
    """B3 on the card is an instance of the B1/B2 template: the wrapper hands
    its C entry point the data in place, the binned codes of
    :func:`_radixbin_bins`, (K, N, size), the derived groups per block (3
    blocks of float32 or int32, 2 of bfloat16, on each of 132 SMs), the op
    code and the one (size, K) output in the data dtype it returns; one launch
    counted, through the public wrapper's route."""
    lib, bins = fake_card
    rng = np.random.default_rng(7)
    k, n, size = 600, 300, 12
    data = torch.from_numpy(rng.integers(-50, 50, size=(k, n)).astype(np.int32)).to(dtype)
    codes = torch.from_numpy(rng.integers(-1, size + 2, n))
    before = dict(ck.LAUNCHES)
    (out,) = ck._segment_reduce_cuda("segment_minmax", data, codes, size, op)
    assert ck.LAUNCHES["segment_minmax"] == before["segment_minmax"] + 1
    assert {kk: v for kk, v in ck.LAUNCHES.items() if kk != "segment_minmax"} == {
        kk: v for kk, v in before.items() if kk != "segment_minmax"}
    ((entry, args),) = lib.calls
    assert entry == "flox_segment_minmax"
    perm, sorted_codes, offsets = bins[0]
    slots = 132 * {torch.float32: 3, torch.bfloat16: 2, torch.int32: 3}[dtype]
    assert args == (data.data_ptr(), {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}[dtype],
                    perm.data_ptr(), sorted_codes.data_ptr(), offsets.data_ptr(), k, n, size,
                    ck._groups_per_block(size, k, n, slots), {"min": 0, "max": 1}[op],
                    out.data_ptr(), None)
    assert out.dtype == dtype and tuple(out.shape) == (size, k)


@pytest.mark.parametrize("kwargs,err", [
    ({"n": ck._MAX_BINNED_COLS + 1}, ValueError),  # int32 column indices past a stage
    ({"size": ck._MAX_GROUPS + 1}, ValueError),
    ({"size": 0}, ValueError),
    ({"dtype": torch.float64}, TypeError),
    ({"dtype": torch.int64}, TypeError),
    ({"op": "mean"}, ValueError),
], ids=["columns", "groups", "no-groups", "dtype", "int64", "op"])
def test_minmax_argument_checks(kwargs, err):
    """The B3 wrapper refuses what its C entry point refuses, before any
    device dispatch: since B3 walks binned codes it takes B1's column cap (a
    stride-0 view stands in for 2^31 columns)."""
    args = {"n": 16, "size": 3, "dtype": torch.float32, "op": "max"}
    args.update(kwargs)
    data = torch.zeros((1, 1), dtype=args["dtype"]).expand(1, args["n"])
    codes = torch.zeros(1, dtype=torch.int32).expand(args["n"])
    with pytest.raises(err):
        ck.segment_minmax(data, codes, args["size"], args["op"])


@pytest.mark.parametrize("wrapper", ["segment_sum_raw", "segment_multistat"])
@pytest.mark.parametrize("kwargs,err", [
    ({"n": ck._MAX_BINNED_COLS + 1}, ValueError),  # int32 column indices past a stage
    ({"size": ck._MAX_GROUPS + 1}, ValueError),
    ({"size": 0}, ValueError),
    ({"dtype": torch.float64}, TypeError),
    ({"accum": "pairwise"}, ValueError),
], ids=["columns", "groups", "no-groups", "dtype", "accum"])
def test_binned_argument_checks(wrapper, kwargs, err):
    """The B1/B2 wrappers refuse what their C entry points refuse, before
    any device dispatch (a stride-0 view stands in for 2^31 columns)."""
    args = {"n": 16, "size": 3, "dtype": torch.float32, "accum": "kahan"}
    args.update(kwargs)
    data = torch.zeros((1, 1), dtype=args["dtype"]).expand(1, args["n"])
    codes = torch.zeros(1, dtype=torch.int32).expand(args["n"])
    with pytest.raises(err):
        getattr(ck, wrapper)(data, codes, args["size"], args["accum"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["auto", "kernel", "radixbin"])
def test_zero_length_axis_reaches_no_kernel(policy, dtype):
    """A zero-length reduced axis (ROADMAP C1) routes every reduction and scan
    off the kernels, so no wrapper launches at N = 0."""
    from flox_tpu_torch import kernels as pk

    data = torch.zeros((3, 0), dtype=dtype)
    codes = torch.zeros(0, dtype=torch.int32)
    with set_options(segment_sum_impl=policy, segment_minmax_impl="kernel", scan_impl="kernel"):
        assert pk._segment_sum_impl(data, 12) == "scatter"
        assert pk._segment_minmax_impl(data, 12) == "scatter"
        assert pk._scan_impl_choice(data, 12) == "segmented"
        assert pk._fused_stats(data, codes, 12, ("nansum", "nanlen", "nanmin")) is None
