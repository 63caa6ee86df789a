"""The port's high-cardinality path (flox_tpu_torch: the radix-binning
kernel's wrapper, the dense path past 512 groups, the sort engine and its
routing) against flox_tpu's, on the CPU.

The reference runs JAX on the CPU with x64, its radix-binning Pallas kernel in
interpret mode, as tests/test_highcard.py runs it; the port runs with
``device="cpu"``, where the kernel wrappers run their plain versions. Inputs
are numpy arrays made from a seed.

Tolerances:
* present tables, compact codes, capacities, scatters, counts, extrema,
  NaN/+inf/-inf positions and the radix-binning kernel's bins: exact;
* the radix-binning kernel's sums: float32 ``rtol=2e-4``, the bar of the
  reference's ``TestRadixBin`` against a float64 oracle;
* float32 results of whole calls: ``rtol=1e-5, atol=1e-6`` (the bar of
  tests/test_torch_core.py); float64: ``rtol=1e-12``;
* the sort engine against the port's dense engine: bit for bit where both
  domains resolve to the same segment-sum lowering (float64 data, or
  ``segment_sum_impl="scatter"``), else at the float32 bar: the compact domain
  may cross a size gate the dense one did not (flox_tpu/kernels.py:1765-1773).
"""

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import core as ref_core
from flox_tpu import kernels as ref_kernels
from flox_tpu import multiarray as ref_multiarray
from flox_tpu import options as ref_options
from flox_tpu.aggregations import _initialize_aggregation as ref_init_agg
from flox_tpu.pallas_kernels import segment_sum_radixbin_pallas
import flox_tpu_torch
from flox_tpu_torch import core as pcore
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import kernels as pk
from flox_tpu_torch.aggregations import _initialize_aggregation
from flox_tpu_torch.multiarray import PresentGroups, merge_present_var
from flox_tpu_torch.options import from_reference

UNIVERSE = 200_000
PRESENT = 300
N = 4096
FUNCS = ["sum", "nansum", "prod", "nanprod", "mean", "nanmean", "var", "nanvar", "std",
         "nanstd", "max", "nanmax", "min", "nanmin", "count", "any", "all"]
EXACT = {"count", "max", "nanmax", "min", "nanmin", "any", "all"}


def _sparse_codes(seed, n=N, present=PRESENT, universe=UNIVERSE):
    rng = np.random.default_rng(seed)
    ids = rng.choice(universe, present, replace=False)
    return ids[rng.integers(0, present, n)]


def _values(seed, shape=(2, N), dtype=np.float64, nan=0.15):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=shape).astype(dtype)
    vals[..., rng.random(shape[-1]) < nan] = np.nan
    return vals


def _bits(t: torch.Tensor) -> np.ndarray:
    """The result's bytes, so that NaN payloads and signed zeros count too."""
    a = t.numpy() if t.dtype != torch.bfloat16 else t.view(torch.int16).numpy()
    return np.ascontiguousarray(a).view(np.uint8)


def _close(got: torch.Tensor, ref, *, exact=False):
    ref = np.asarray(ref)
    assert str(got.dtype).removeprefix("torch.") == ref.dtype.name, (got.dtype, ref.dtype)
    assert tuple(got.shape) == ref.shape
    g = got.numpy()
    if exact or not got.is_floating_point():
        np.testing.assert_array_equal(g, ref)
    elif got.dtype == torch.float64:
        np.testing.assert_allclose(g, ref, rtol=1e-12, atol=1e-14, equal_nan=True)
    else:
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6, equal_nan=True)


# ---------------------------------------------------------------------------
# the compaction primitives and the PresentGroups container, exact
# ---------------------------------------------------------------------------


class TestPrimitives:
    def test_present_groups(self):
        codes = _sparse_codes(0)
        codes[:7] = -1
        got = pk.present_groups(codes, UNIVERSE)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, ref_kernels.present_groups(codes, UNIVERSE))
        assert pk.present_groups(codes.copy(), UNIVERSE) is got  # memoized on content

    def test_compact_codes(self):
        codes = _sparse_codes(1)
        codes[::11] = -1
        present = pk.present_groups(codes, UNIVERSE)
        got = pk.compact_codes(codes, present)
        assert got.dtype == np.int32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, ref_kernels.compact_codes(codes, present))

    @pytest.mark.parametrize("n_present,size", [(0, 10), (5, 1000), (8, 1000), (300, UNIVERSE),
                                                (1000, 1000), (1096, 36524), (7, 8), (9, 12)])
    def test_present_cap(self, n_present, size):
        assert pk.present_cap(n_present, size) == ref_kernels.present_cap(n_present, size)

    def test_scatter_present_dense(self):
        rng = np.random.default_rng(2)
        present = np.sort(rng.choice(50, 6, replace=False))
        comp = rng.normal(size=(3, 8))
        want = ref_kernels.scatter_present_dense(comp, present, 50)
        got = pk.scatter_present_dense(torch.from_numpy(comp), present, 50)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        # bfloat16 has no numpy dtype: it is scattered as its bits
        bf = torch.from_numpy(comp).to(torch.bfloat16)
        got = pk.scatter_present_dense(bf, present, 50)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      ref_kernels.scatter_present_dense(bf.float().numpy(),
                                                                        present, 50))

    def test_scatter_dense_and_contract(self):
        for present, values, size in [(np.array([1, 4]), np.array([2.0, 3.0, np.nan]), 6),
                                      (np.arange(4), np.array([[1.0, 2.0, 3.0, 4.0]]), 4)]:
            np.testing.assert_array_equal(
                PresentGroups(present, values, size).scatter_dense(),
                ref_multiarray.PresentGroups(present, values, size).scatter_dense())
        with pytest.raises(ValueError, match="trailing axis"):
            PresentGroups(np.array([0, 1, 2]), np.array([1.0, 2.0]), 10)
        with pytest.raises(ValueError, match="pad column"):
            PresentGroups(np.array([0, 1]), np.array([1.0, 2.0]), 10).scatter_dense()

    @pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
    @pytest.mark.parametrize("dtype", [np.float64, np.int32])
    def test_merge(self, op, dtype):
        rng = np.random.default_rng(3)
        pa, pb = np.sort(rng.choice(100, 5, replace=False)), np.sort(rng.choice(100, 7,
                                                                                replace=False))
        va = rng.integers(1, 9, (2, 6)).astype(dtype)
        vb = rng.integers(1, 9, (2, 8)).astype(dtype)
        got = PresentGroups(pa, va, 100).merge(PresentGroups(pb, vb, 100), op)
        want = ref_multiarray.PresentGroups(pa, va, 100).merge(
            ref_multiarray.PresentGroups(pb, vb, 100), op)
        np.testing.assert_array_equal(got.present, want.present)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.scatter_dense(), want.scatter_dense())
        with pytest.raises(ValueError, match="universe"):
            PresentGroups(pa, va, 100).merge(PresentGroups(pb, vb, 101), op)

    def test_merge_present_var(self):
        rng = np.random.default_rng(4)
        sides = []
        for n_p in (5, 9):
            present = np.sort(rng.choice(60, n_p, replace=False))
            cnt = rng.integers(0, 5, (3, n_p + 1)).astype(np.float64)
            total = rng.normal(size=(3, n_p + 1)) * cnt
            m2 = rng.random((3, n_p + 1)) * cnt
            sides.append([(present, v) for v in (m2, total, cnt)])
        port = [tuple(PresentGroups(p, v, 60) for p, v in side) for side in sides]
        ref = [tuple(ref_multiarray.PresentGroups(p, v, 60) for p, v in side) for side in sides]
        for got, want in zip(merge_present_var(*port), ref_multiarray.merge_present_var(*ref)):
            np.testing.assert_array_equal(got.present, want.present)
            np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("ncap", [512, 64])  # 64 < 300 present: capacity overflow
def test_sort_segment_reduce(op, ncap):
    codes = _sparse_codes(5)
    codes[::13] = -1
    data = np.random.default_rng(6).normal(size=N)
    want_p, want_out, want_n = ref_kernels.sort_segment_reduce(op, data, codes, ncap=ncap)
    got_p, got_out, got_n = pk.sort_segment_reduce(op, torch.from_numpy(data),
                                                   torch.from_numpy(codes), ncap=ncap)
    assert int(got_n) == int(want_n) == PRESENT
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    # the stable sort keeps each group's order: the same scatter sums bit for bit
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    # leading dims ride along on the reduced-last layout
    data2 = np.stack([data, -data])
    _, out2, _ = pk.sort_segment_reduce(op, torch.from_numpy(data2), torch.from_numpy(codes),
                                        ncap=ncap)
    np.testing.assert_array_equal(out2[0].numpy(), got_out.numpy())


# ---------------------------------------------------------------------------
# B5: the radix-binning kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", ["plain", "kahan", "dd"])
def test_radixbin_past_the_dense_cap(accum):
    """TestRadixBin.test_past_dense_vmem_cap's shapes: 2048 x 24 over 1800
    sorted groups."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    n, k, size = 2048, 24, 1800
    data = rng.normal(size=(n, k)).astype(np.float32)
    codes = np.sort(rng.integers(0, size, n)).astype(np.int32)
    want = np.asarray(segment_sum_radixbin_pallas(jnp.asarray(data), jnp.asarray(codes), size,
                                                  interpret=True, accum=accum))
    got = ck.segment_sum_radixbin(torch.from_numpy(np.ascontiguousarray(data.T)),
                                  torch.from_numpy(codes), size, accum)
    assert got.dtype == torch.float32 and tuple(got.shape) == (size, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)
    oracle = np.zeros((size, k))
    np.add.at(oracle, codes, data.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), oracle.astype(np.float32), rtol=2e-4)


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_radixbin_markers_and_missing(dtype, skipna):
    """TestRadixBin.test_ieee_markers_and_missing's shapes: 600 x 8 over 700
    random groups, with NaN, +-inf, -1 and out-of-range codes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    n, k, size = 600, 8, 700
    data = rng.normal(size=(n, k)).astype(np.float32)
    data[4, 2] = np.nan
    data[9, 0] = np.inf
    data[rng.random((n, k)) < 0.01] = np.nan
    data[rng.random((n, k)) < 0.005] = -np.inf
    codes = rng.integers(0, size, n).astype(np.int32)
    codes[17] = -1
    codes[23] = size + 5  # out of range drops out too
    ref_in = jnp.asarray(data).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(data)
    want = np.asarray(segment_sum_radixbin_pallas(ref_in, jnp.asarray(codes), size,
                                                  interpret=True, skipna=skipna))
    port_in = torch.from_numpy(np.ascontiguousarray(data.T))
    if dtype == "bfloat16":
        port_in = port_in.to(torch.bfloat16)
    got = ck.segment_sum_radixbin(port_in, torch.from_numpy(codes), size, skipna=skipna).numpy()
    for flag in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(flag(got), flag(want))
    assert np.isposinf(got[codes[9], 0]) and (np.isnan(got[codes[4], 2]) != skipna)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-4, atol=1e-6)


def test_radixbin_raw_is_segment_sum_raw_below_the_cap():
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.normal(size=(3, 500)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-1, 40, 500).astype(np.int32))
    for a, b in zip(ck.segment_sum_radixbin_raw(data, codes, 37, "kahan"),
                    ck.segment_sum_raw(data, codes, 37, "kahan")):
        assert torch.equal(a, b)


def _np_bins(codes: np.ndarray, size: int):
    key = np.where((codes >= 0) & (codes < size), codes, size)
    perm = np.argsort(key, kind="stable")
    return perm, key[perm], np.searchsorted(key[perm], np.arange(size + 1), side="left")


def _bins_case(case: str):
    rng = np.random.default_rng(11)
    n = 2000
    if case == "sorted":
        return np.arange(n) // 24, 84
    if case == "random":
        return rng.integers(0, 700, n), 700
    if case == "invalid":
        codes = rng.integers(-3, 1096 + 5, n)
        codes[:5] = -1
        return codes, 1096
    if case == "empty_groups":  # 513 groups, most of them empty
        return rng.choice([0, 5, 40, 41, 300, 512], n), 513
    if case == "all_invalid":
        return np.full(n, -1), 513
    assert case == "int64_out_of_int32"
    codes = rng.integers(0, 600, n)
    codes[::7] = 2**40 + 3  # must drop out, not wrap into [0, size)
    return codes, 600


_BINS_CASES = ["sorted", "random", "invalid", "empty_groups", "all_invalid",
               "int64_out_of_int32"]


@pytest.mark.parametrize("case,dtype", [
    *((c, d) for c in _BINS_CASES[:-1] for d in (torch.int32, torch.int64)),
    ("int64_out_of_int32", torch.int64),
])
def test_radixbin_bins(case, dtype):
    """The radix-binning kernel's bins against numpy's stable argsort and
    searchsorted of the codes with the invalid ones mapped to ``size``."""
    codes, size = _bins_case(case)
    perm, sorted_codes, offsets = ck._radixbin_bins(torch.from_numpy(codes).to(dtype), size)
    want_perm, want_sorted, want_offsets = _np_bins(codes, size)
    for got in (perm, sorted_codes, offsets):
        assert got.dtype == torch.int32 and got.is_contiguous()
    assert tuple(offsets.shape) == (size + 1,)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(sorted_codes.numpy(), want_sorted)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    assert offsets[-1].item() == int(((codes >= 0) & (codes < size)).sum())
    if case == "sorted":
        np.testing.assert_array_equal(perm.numpy(), np.arange(codes.size))


@pytest.mark.parametrize("width", [1, 7, 8, 32])
@pytest.mark.parametrize("case", _BINS_CASES)
def test_radixbin_segment_ranges(case, width):
    """What the kernel's grid reads: the block over groups [g0, g0 + width)
    (csrc/segment_radixbin.cu takes 8) reads ``perm[offsets[g0] :
    offsets[min(g0 + width, size)]]``, which must be exactly the columns whose
    codes fall in those groups, ordered by code and then by column; the
    segments together read every valid column once and no invalid one."""
    codes, size = _bins_case(case)
    perm, _, offsets = (t.numpy() for t in ck._radixbin_bins(torch.from_numpy(codes), size))
    seen = []
    for g0 in range(0, size, width):
        g1 = min(g0 + width, size)
        cols = perm[offsets[g0]:offsets[g1]]
        mine = np.flatnonzero((codes >= g0) & (codes < g1))
        np.testing.assert_array_equal(cols, mine[np.lexsort((mine, codes[mine]))])
        seen.append(cols)
    seen = np.concatenate(seen)
    np.testing.assert_array_equal(np.sort(seen),
                                  np.flatnonzero((codes >= 0) & (codes < size)))


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_radixbin_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def boom(*a, **k):
        raise AssertionError("a CUDA request fell back to the plain version")

    monkeypatch.setattr(ck, "segment_sum_radixbin_plain", boom)
    monkeypatch.setattr(ck, "segment_sum_raw_plain", boom)
    data = torch.zeros(4, 16).as_subclass(_CudaTyped)
    codes = torch.zeros(16, dtype=torch.int32).as_subclass(_CudaTyped)
    before = dict(ck.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.segment_sum_radixbin_raw(data, codes, 1096, "kahan")
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("kwargs,err", [
    ({"data": torch.zeros(4, 16, dtype=torch.float64)}, TypeError),
    ({"codes": torch.zeros(15, dtype=torch.int32)}, ValueError),
    ({"size": ck._RADIXBIN_MAX_GROUPS + 1}, ValueError),
    ({"size": 0}, ValueError),
    ({"accum": "pairwise"}, ValueError),
])
def test_radixbin_argument_checks(kwargs, err):
    args = {"data": torch.zeros(4, 16), "codes": torch.zeros(16, dtype=torch.int32),
            "size": 1096, "accum": "kahan"}
    args.update(kwargs)
    with pytest.raises(err):
        ck.segment_sum_radixbin_raw(args["data"], args["codes"], args["size"], args["accum"])


# ---------------------------------------------------------------------------
# the dense path past 512 groups: the port's "auto" against the reference's
# radix-binning policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("func", ["nansum", "nanmean", "var", "count"])
def test_dense_radixbin_path(func):
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 2000, N)
    vals = rng.normal(size=(3, N)).astype(np.float32)
    vals[rng.random((3, N)) < 0.05] = np.nan
    eg = np.arange(2000)
    with flox_tpu.set_options(segment_sum_impl="radixbin"):
        ref, _ = flox_tpu.groupby_reduce(vals, codes, func=func, expected_groups=eg,
                                         engine="jax")
    assert pk._segment_sum_impl(torch.zeros(3, N), 2000) == "radixbin"
    got, groups = flox_tpu_torch.groupby_reduce(vals, codes, func=func, expected_groups=eg,
                                                device="cpu")
    np.testing.assert_array_equal(groups, eg)
    _close(got, ref, exact=func == "count")


@pytest.mark.parametrize(
    "opts,size,impl",
    [
        ({}, 512, "kernel"),
        ({}, 513, "radixbin"),
        ({}, 16384, "radixbin"),
        ({}, 16385, "scatter"),
        ({"segment_sum_impl": "kernel"}, 513, "scatter"),
        ({"segment_sum_impl": "radixbin"}, 12, "radixbin"),
        ({"segment_sum_impl": "radixbin", "radixbin_num_groups_max": 1024}, 2048, "scatter"),
        ({"segment_sum_impl": "scatter"}, 1096, "scatter"),
        ({"pallas_num_groups_max": 8}, 12, "radixbin"),
        # the reference's own one-hot GEMM guard decides (K = 2 rows: at most
        # 4 * K = 8 groups)
        ({"segment_sum_impl": "matmul"}, 8, "matmul"),
        ({"segment_sum_impl": "matmul"}, 12, "scatter"),
        ({"segment_sum_impl": "matmul", "matmul_num_groups_max": 4}, 8, "scatter"),
        ({"pallas_num_groups_max": 0, "radixbin_num_groups_max": 0}, 8, "matmul"),
        ({"pallas_num_groups_max": 0, "radixbin_num_groups_max": 0}, 12, "scatter"),
        ({"pallas_num_groups_max": 0, "radixbin_num_groups_max": 0,
          "matmul_num_groups_max": 4}, 8, "scatter"),
    ],
)
def test_segment_sum_routing(monkeypatch, opts, size, impl):
    """``_segment_sum_impl`` on a CUDA device against the reference's TPU
    dispatch (the reference's "pallas" is the port's "kernel"), the same call
    on the CPU (where "auto" never takes the GEMM), and ``_seg`` reaching the
    wrapper the CPU decision names."""
    monkeypatch.setattr(ref_kernels, "_on_tpu", lambda: True)
    monkeypatch.setattr(ref_kernels, "_pallas_runtime_ok", lambda: True)
    monkeypatch.setattr(ref_kernels, "_pallas_radixbin_runtime_ok", lambda: True)
    ref_opts = {**opts}
    if ref_opts.get("segment_sum_impl") == "kernel":
        ref_opts["segment_sum_impl"] = "pallas"

    class _Probe:
        dtype = np.dtype("float32")
        shape = (64, 2)
        ndim = 2

    with flox_tpu.set_options(**ref_opts):
        want = ref_kernels._segment_sum_impl(_Probe(), size)
    assert {"pallas": "kernel"}.get(want, want) == impl
    calls = []
    for mod, name in ((ck, "segment_sum"), (ck, "segment_sum_radixbin"),
                      (pk, "_seg_matmul_sum")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (calls.append(_n),
                                                                           _r(*a, **k))[1])
    data = torch.ones(2, 64)
    codes = torch.zeros(64, dtype=torch.int32)
    auto_gemm = impl == "matmul" and opts.get("segment_sum_impl", "auto") == "auto"
    on_cpu = "scatter" if auto_gemm else impl
    with flox_tpu_torch.set_options(**opts):
        assert pk._segment_sum_impl(data, size, device_type="cuda") == impl
        assert pk._segment_sum_impl(data, size) == on_cpu
        out = pk._seg("sum", data, codes, size)
    assert calls == {"kernel": ["segment_sum"], "radixbin": ["segment_sum_radixbin"],
                     "matmul": ["_seg_matmul_sum"], "scatter": []}[on_cpu]
    assert out[:, 0].tolist() == [64.0, 64.0] and tuple(out.shape) == (2, size)


def test_fused_nanmean_is_one_radixbin_pass(monkeypatch):
    """nanmean over 1096 groups: one B5 pass for the sums and the counts,
    finished by the mean finalize, equal bit for bit to the fused torch
    passes over the same B5 legs and to the per-leg path (B5 sums of the
    NaN-zeroed data, counts by index_add_)."""
    rng = np.random.default_rng(9)
    n = 26304 // 8
    day = np.arange(n) // 3
    vals = rng.normal(size=(4, n)).astype(np.float32)
    vals[rng.random((4, n)) < 0.1] = np.nan
    vals[0, 5], vals[1, 7] = np.inf, -np.inf
    calls = {}
    for name in ("segment_sum_radixbin_raw", "segment_sum_radixbin", "segment_sum_raw",
                 "segment_multistat"):
        real = getattr(ck, name)
        calls[name] = 0

        def wrapped(*a, _r=real, _n=name, **k):
            calls[_n] += 1
            return _r(*a, **k)

        monkeypatch.setattr(ck, name, wrapped)
    fused, _ = flox_tpu_torch.groupby_reduce(vals, day, func="nanmean", device="cpu")
    assert calls == {"segment_sum_radixbin_raw": 1, "segment_sum_radixbin": 0,
                     "segment_sum_raw": 0, "segment_multistat": 0}
    monkeypatch.setattr(pk, "_mean_pass", lambda *a: False)
    torch_passes, _ = flox_tpu_torch.groupby_reduce(vals, day, func="nanmean", device="cpu")
    assert calls["segment_sum_radixbin_raw"] == 2
    monkeypatch.setattr(pk, "_fused_sum_counts", lambda *a, **k: None)
    per_leg, _ = flox_tpu_torch.groupby_reduce(vals, day, func="nanmean", device="cpu")
    assert calls["segment_sum_radixbin"] == 1
    assert fused.dtype == torch_passes.dtype == per_leg.dtype == torch.float32
    np.testing.assert_array_equal(_bits(fused), _bits(torch_passes))
    np.testing.assert_array_equal(_bits(fused), _bits(per_leg))


# ---------------------------------------------------------------------------
# the sort engine against the port's dense engine and the reference's sort
# engine
# ---------------------------------------------------------------------------


def _run_pair(vals, codes, func, opts=None, **kw):
    with flox_tpu_torch.set_options(**(opts or {})):
        rs, gs = flox_tpu_torch.groupby_reduce(vals, codes, func=func, engine="sort",
                                               device="cpu", **kw)
        rd, gd = flox_tpu_torch.groupby_reduce(vals, codes, func=func, engine="torch",
                                               device="cpu", **kw)
    np.testing.assert_array_equal(gs, gd)
    assert rs.dtype == rd.dtype and rs.shape == rd.shape
    return rs, rd


class TestSortAgainstDense:
    @pytest.mark.parametrize("func", FUNCS)
    def test_float64_bit_identical(self, func):
        rs, rd = _run_pair(_values(10), _sparse_codes(10), func,
                           expected_groups=np.arange(UNIVERSE))
        np.testing.assert_array_equal(_bits(rs), _bits(rd), err_msg=func)

    @pytest.mark.parametrize("func", ["sum", "nanmean", "var", "nanmax", "count"])
    def test_float32_same_lowering_bit_identical(self, func):
        rs, rd = _run_pair(_values(11, dtype=np.float32), _sparse_codes(11), func,
                           opts={"segment_sum_impl": "scatter"},
                           expected_groups=np.arange(UNIVERSE))
        np.testing.assert_array_equal(_bits(rs), _bits(rd), err_msg=func)

    @pytest.mark.parametrize("func", ["sum", "nansum", "nanmean", "var", "nanstd"])
    def test_float32_across_size_gates(self, func):
        # the compact domain (512 slots) takes the segment-sum kernel, the
        # dense one (200000 groups) index_add_: equal at the float32 bar
        rs, rd = _run_pair(_values(12, dtype=np.float32), _sparse_codes(12), func,
                           expected_groups=np.arange(UNIVERSE))
        np.testing.assert_allclose(rs.numpy(), rd.numpy(), rtol=1e-5, atol=1e-6,
                                   equal_nan=True)

    @pytest.mark.parametrize("min_count", [1, 2, 4])
    def test_min_count(self, min_count):
        rs, rd = _run_pair(_values(13), _sparse_codes(13), "nansum",
                           expected_groups=np.arange(UNIVERSE), min_count=min_count)
        np.testing.assert_array_equal(_bits(rs), _bits(rd))

    def test_nan_fill_int_promotion(self):
        vals = np.random.default_rng(14).integers(0, 100, N)
        rs, rd = _run_pair(vals, _sparse_codes(14), "sum", expected_groups=np.arange(UNIVERSE),
                           fill_value=np.nan, min_count=2)
        assert rs.dtype == torch.float64
        np.testing.assert_array_equal(_bits(rs), _bits(rd))

    def test_labels_present_only_and_kept_dims(self):
        codes = _sparse_codes(15)
        rs, rd = _run_pair(_values(15, shape=(N,)), codes, "nanmean",
                           expected_groups=np.unique(codes))
        np.testing.assert_array_equal(_bits(rs), _bits(rd))
        rng = np.random.default_rng(7)
        by = rng.choice(rng.choice(50_000, 40, replace=False), size=(6, 128))
        rs, rd = _run_pair(rng.normal(size=(6, 128)), by, "nanmean", axis=-1,
                           expected_groups=np.arange(50_000))
        np.testing.assert_array_equal(_bits(rs), _bits(rd))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("func", ["sum", "nanmean", "var", "nanstd", "max", "nanmin", "count",
                                  "prod", "any"])
def test_sort_engine_against_reference(func, dtype):
    vals = _values(16, dtype=dtype)
    codes = _sparse_codes(16)
    eg = np.arange(UNIVERSE)
    ref, rg = flox_tpu.groupby_reduce(vals, codes, func=func, expected_groups=eg, engine="sort")
    with flox_tpu_torch.set_options(**from_reference(dict(ref_options.OPTIONS))):
        got, pg = flox_tpu_torch.groupby_reduce(vals, codes, func=func, expected_groups=eg,
                                                engine="sort", device="cpu")
    np.testing.assert_array_equal(pg, np.asarray(rg))
    _close(got, ref, exact=func in EXACT)


def test_million_label_universe():
    """A million labels, 0.2 % present: the sort engine reduces over the
    banded capacity only, equals the reference's sort engine, and equals the
    port's dense engine bit for bit."""
    size, present, n = 1_000_000, 2_000, 20_000
    rng = np.random.default_rng(42)
    ids = rng.choice(size, present, replace=False)
    codes = ids[rng.integers(0, present, n)]
    vals = rng.normal(size=n)
    vals[rng.random(n) < 0.1] = np.nan
    eg = np.arange(size)
    sizes = []
    real = pcore._reduce_blockwise

    def spy(*a, size, **k):
        sizes.append(size)
        return real(*a, size=size, **k)

    pcore._reduce_blockwise = spy
    try:
        got, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                               engine="sort", device="cpu")
    finally:
        pcore._reduce_blockwise = real
    assert sizes == [pk.present_cap(present, size)] == [2048]
    ref, _ = flox_tpu.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                     engine="sort")
    _close(got, ref)
    dense, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                             engine="torch", device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(dense))


def test_sort_engine_scan_is_the_dense_scan():
    rng = np.random.default_rng(17)
    codes = _sparse_codes(17, n=512)
    vals = rng.normal(size=(2, 512))
    a = flox_tpu_torch.groupby_scan(vals, codes, func="nancumsum", engine="sort", device="cpu")
    b = flox_tpu_torch.groupby_scan(vals, codes, func="nancumsum", engine="torch", device="cpu")
    np.testing.assert_array_equal(_bits(a), _bits(b))


def test_sort_kernel_plugin_form():
    """``generic_aggregate(engine="sort")``: the per-kernel form keeps the
    dense (..., size) contract."""
    from flox_tpu_torch.aggregations import generic_aggregate

    codes = _sparse_codes(18)
    vals = torch.from_numpy(_values(18))
    got = generic_aggregate(torch.from_numpy(codes), vals, engine="sort", func="nanmean",
                            size=UNIVERSE)
    want = generic_aggregate(torch.from_numpy(codes), vals, engine="torch", func="nanmean",
                             size=UNIVERSE)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# dense-vs-sort routing against the reference's _route_highcard
# ---------------------------------------------------------------------------


def _routes(engine, explicit, size, codes, shape=(8, 2048), func="nanmean", **opts):
    """The port's and the reference's routing choice (or error) on one input;
    the reference's "jax" is the port's "torch"."""
    out = []
    for route, agg_init, set_opts, eng in (
        (pcore._route_highcard, lambda: _initialize_aggregation(func, None, torch.float64, None,
                                                               0, None),
         flox_tpu_torch.set_options, engine),
        (ref_core._route_highcard, lambda: ref_init_agg(func, None, np.float64, None, 0, None),
         flox_tpu.set_options, {"torch": "jax"}.get(engine, engine)),
    ):
        arr = torch.zeros(shape, dtype=torch.float64) if route is pcore._route_highcard \
            else np.zeros(shape)
        with set_opts(**opts):
            try:
                got = route(eng, codes, arr, shape[:-1], size, agg_init(), explicit=explicit)
                out.append({"jax": "torch"}.get(got, got))
            except ValueError as e:
                out.append(("ValueError", "groups actually present" in str(e),
                            "even the sort engine" in str(e)))
    return out


@pytest.mark.parametrize(
    "engine,explicit,size,opts,want",
    [
        # the ceiling: a defaulted dense engine re-routes to sort
        ("torch", False, 1_000_000, {"dense_intermediate_bytes_max": 2**20}, "sort"),
        # an explicit dense request over the ceiling raises, naming the sort
        # engine and the groups present
        ("torch", True, 300_000, {"dense_intermediate_bytes_max": 2**20},
         ("ValueError", True, False)),
        # even the compact domain over the ceiling
        ("sort", True, 1_000_000, {"dense_intermediate_bytes_max": 2**20},
         ("ValueError", False, True)),
        # below the ceiling: small universes stay dense, explicit choices hold
        ("torch", False, 50_000, {}, "torch"),
        ("torch", True, 200_000, {"sort_engine_min_groups": 1000}, "torch"),
        ("sort", True, 200_000, {}, "sort"),
        # the density heuristic past sort_engine_min_groups
        ("torch", False, 200_000, {"sort_engine_min_groups": 1000}, "sort"),
        ("torch", False, 4096, {"sort_engine_min_groups": 1000}, "torch"),
    ],
)
def test_route_highcard_against_reference(engine, explicit, size, opts, want):
    rng = np.random.default_rng(19)
    present = 64 if want != ("ValueError", False, True) else 20_000
    codes = rng.choice(min(size, 1_000_000), min(present, size), replace=False)[
        rng.integers(0, min(present, size), 2048)]
    if size == 4096:
        codes = rng.integers(0, size, 2048)  # dense: most of the universe present
    shape = (4096, 2048) if want == ("ValueError", False, True) else (8, 2048)
    port, ref = _routes(engine, explicit, size, codes, shape=shape, **opts)
    assert port == ref == want


def test_ceiling_auto_routes_end_to_end():
    rng = np.random.default_rng(43)
    size = 1_000_000
    codes = rng.choice(size, 64, replace=False)[rng.integers(0, 64, 2048)]
    vals = rng.normal(size=(8, 2048))
    eg = np.arange(size)
    with flox_tpu_torch.set_options(dense_intermediate_bytes_max=2**20):
        got, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                               device="cpu")
        with pytest.raises(ValueError, match="engine='sort'"):
            flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                          engine="torch", device="cpu")
    want, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                            engine="torch", device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_default_engine_option_routes_sort(monkeypatch):
    codes = _sparse_codes(20)
    vals = _values(20)
    eg = np.arange(UNIVERSE)
    seen = []
    real = pk.compact_codes
    monkeypatch.setattr(pk, "compact_codes", lambda *a: (seen.append(1), real(*a))[1])
    with flox_tpu_torch.set_options(default_engine="sort"):
        got, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                               device="cpu")
    assert seen and isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", expected_groups=eg,
                                            engine="sort", device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_dense_result_over_the_ceiling_stays_on_the_host(monkeypatch):
    moved = []
    real = pcore._redevice_scattered

    def spy(result, device):
        out = real(result, device)
        moved.append(out is not result)
        return out

    monkeypatch.setattr(pcore, "_redevice_scattered", spy)
    codes = _sparse_codes(21, n=256)
    with flox_tpu_torch.set_options(dense_intermediate_bytes_max=2**20):
        out, _ = flox_tpu_torch.groupby_reduce(np.ones((2, 256)), codes, func="sum",
                                               expected_groups=np.arange(UNIVERSE),
                                               engine="sort", device="cpu")
    # (2, 200000) float64 is 3.2 MB, over a 1 MiB ceiling: no copy back
    assert moved == [False] and out.device.type == "cpu"


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "ref,port",
    [
        ({"segment_sum_impl": "radixbin"}, {"segment_sum_impl": "radixbin"}),
        ({"default_engine": "jax"}, {"default_engine": "torch"}),
        ({"default_engine": "sort"}, {"default_engine": "sort"}),
        ({"radixbin_num_groups_max": 4096, "sort_engine_min_groups": 100,
          "dense_intermediate_bytes_max": 2**21},
         {"radixbin_num_groups_max": 4096, "sort_engine_min_groups": 100,
          "dense_intermediate_bytes_max": 2**21}),
    ],
)
def test_from_reference(ref, port):
    assert from_reference(ref) == port


def test_from_reference_defaults_and_refusals():
    got = from_reference(dict(ref_options.OPTIONS))
    assert got["default_engine"] == "torch"
    assert got["radixbin_num_groups_max"] == 16384
    assert got["sort_engine_min_groups"] == 65536
    assert got["dense_intermediate_bytes_max"] == 8 * 2**30
    # the host numpy engine is ported (A6): the option carries across
    assert from_reference({"default_engine": "numpy"}) == {"default_engine": "numpy"}
    for bad in ({"default_engine": "jax"}, {"sort_engine_min_groups": 0},
                {"dense_intermediate_bytes_max": 1024}, {"segment_sum_impl": "pallas"}):
        with pytest.raises(ValueError):
            flox_tpu_torch.set_options(**bad)
