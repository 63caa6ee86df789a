"""The mean finalize (``cuda_kernels.mean_finalize``) and the skipna mean's
route to it, on the CPU.

On the card a skipna mean whose segment sum resolves to B1 or B5 finishes in
one pass of ``csrc/mean_finalize.cu`` over the kernel's raw legs, with the
rows of each group counted by a device op that reads nothing back. Here the
wrapper runs its plain version, which these tests hold bit for bit to the
torch composition that finishes the mean everywhere else; the route is
forced onto the CPU (``kernels._mean_pass``) to hold it to the unrouted call
and to flox_tpu. The kernel against its plain version on the card is
``chip_smoke.py --mean-finalize`` and ``tests/test_torch_cuda_mean_finalize.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flox_tpu
import flox_tpu_torch
from flox_tpu import options as ref_options
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import kernels, telemetry, utils
from flox_tpu_torch.options import from_reference

NAN = float("nan")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, every NaN counted equal to every NaN (payloads aside)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    iview = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(na, nb) and torch.equal(a[~na].view(iview), b[~nb].view(iview))


def _today(sums, nan_c, pos_c, neg_c, rowcount, fill, dtype):
    """The composition of ``kernels._mean_impl``'s fused route, written out:
    ``reapply_nonfinite`` -> ``nanlen`` -> divide -> fill -> cast, on the
    (K, size) views of (size, K) legs."""
    sums, nan_c, pos_c, neg_c = (t.T for t in (sums, nan_c, pos_c, neg_c))
    total = utils.reapply_nonfinite(sums, nan_c, pos_c, neg_c, skipna=True)
    cnt = rowcount.expand_as(sums).to(sums.dtype) - nan_c
    out = kernels._fill_empty(total / cnt, cnt > 0, fill)
    return out.to(dtype) if out.dtype != dtype else out


def _legs(case: str, size: int = 9, k: int = 40, seed: int = 0):
    """Crafted raw legs (size, K) float32, the rows of each group (size,)
    int32, and the fill and result dtype of ``case``."""
    rng = np.random.default_rng(seed)
    rowcount = rng.integers(1, 50, size).astype(np.int32)
    nan_c = np.floor(rng.random((size, k)) * (rowcount[:, None] + 1) * 0.3)
    pos_c = np.zeros((size, k))
    neg_c = np.zeros((size, k))
    sums = rng.normal(size=(size, k)) * 100
    fill, dtype = NAN, torch.float32
    if case == "posinf":
        pos_c[rng.random((size, k)) < 0.2] = 2
    elif case == "neginf":
        neg_c[rng.random((size, k)) < 0.2] = 1
    elif case == "both":
        pos_c[rng.random((size, k)) < 0.3] = 1
        neg_c[rng.random((size, k)) < 0.3] = 3
    elif case == "all_nan":
        nan_c[::2] = rowcount[::2, None]  # every value of these groups NaN
        sums[::2] = 0
        pos_c[1, :5] = 1  # +inf among the values of a group that has some
    elif case == "empty":
        rowcount[[0, 4, 8]] = 0
        nan_c[[0, 4, 8]] = sums[[0, 4, 8]] = 0
        neg_c[2, ::3] = 1
    elif case == "float_fill":
        rowcount[[1, 3]] = 0
        nan_c[[1, 3]] = sums[[1, 3]] = 0
        nan_c[5] = rowcount[5]
        fill = -999.0
    elif case == "bf16":
        rowcount[2] = 0
        nan_c[2] = sums[2] = 0
        pos_c[4, ::4] = 1
        neg_c[4, ::5] = 1
        dtype = torch.bfloat16
    legs = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
            for x in (sums, nan_c, pos_c, neg_c)]
    return legs, torch.from_numpy(rowcount), fill, dtype


CASES = ["posinf", "neginf", "both", "all_nan", "empty", "float_fill", "bf16"]


@pytest.mark.parametrize("case", CASES)
def test_plain_is_todays_composition_bit_for_bit(case):
    """``mean_finalize_plain``, and the wrapper on the CPU, give the bits of
    the composition that finishes the fused mean, on legs crafted to hold
    +inf, -inf, both, all-NaN groups, empty groups, a float fill and a
    bfloat16 result; the result is (K, size) row-major."""
    legs, rowcount, fill, dtype = _legs(case)
    want = _today(*legs, rowcount, fill, dtype)
    for fn in (ck.mean_finalize_plain, ck.mean_finalize):
        got = fn(*legs, rowcount, fill, dtype)
        assert got.dtype == dtype and tuple(got.shape) == (legs[0].shape[1], legs[0].shape[0])
        assert got.is_contiguous()
        assert _bits_equal(got, want)
    cnt = rowcount[:, None].float() - legs[1]
    out = ck.mean_finalize_plain(*legs, rowcount, fill, torch.float32)
    if case == "both":
        assert torch.isnan(out.T[(legs[2] > 0) & (legs[3] > 0) & (cnt > 0)]).all()
    if case in ("all_nan", "empty", "float_fill"):
        holes = (cnt <= 0).T
        assert holes.any() and _bits_equal(out[holes], torch.full_like(out[holes], fill))


@pytest.mark.parametrize("size", [1, 5, 12, 600])
def test_rowcount_equals_counts(size):
    """The sync-free row count equals ``_counts`` exactly, in int32, with
    missing labels, codes past ``size`` and groups that never occur."""
    rng = np.random.default_rng(size)
    raw = rng.integers(-3, size + 4, 3001)
    raw[raw == size // 2] = 0  # one group never occurs
    codes = kernels._safe_codes(torch.from_numpy(raw), size)
    got = kernels._rowcount(codes, size)
    want = kernels._counts(codes, size)
    assert got.dtype == torch.int32 and want.dtype == torch.int32
    assert torch.equal(got, want)
    assert got.is_contiguous() and tuple(got.shape) == (size,)


@pytest.mark.parametrize("impl, dtype, device, skipna, fill, routed", [
    ("kernel", torch.float32, "cuda", True, NAN, True),
    ("radixbin", torch.float32, "cuda", True, NAN, True),
    ("kernel", torch.bfloat16, "cuda", True, NAN, True),
    ("radixbin", torch.bfloat16, "cuda", True, -999, True),
    ("kernel", torch.float32, "cuda", True, np.float32(0.25), True),
    ("kernel", torch.float32, "cuda", True, float("-inf"), True),
    ("matmul", torch.float32, "cuda", True, NAN, False),
    ("scatter", torch.float32, "cuda", True, NAN, False),
    ("kernel", torch.float64, "cuda", True, NAN, False),
    ("matmul", torch.float64, "cuda", True, NAN, False),
    ("kernel", torch.float16, "cuda", True, NAN, False),
    ("kernel", torch.float32, "cuda", False, NAN, False),
    ("kernel", torch.float32, "cuda", True, 0.1, False),  # float32 rounds 0.1
    ("kernel", torch.float32, "cuda", True, 1e300, False),
    ("kernel", torch.float32, "cuda", True, 2**40 + 1, False),
    ("kernel", torch.float32, "cuda", True, 1 + 2j, False),
    ("kernel", torch.float32, "cuda", True, True, False),
    ("kernel", torch.float32, "cpu", True, NAN, False),
    ("radixbin", torch.bfloat16, "cpu", True, NAN, False),
])
def test_mean_pass_routing(impl, dtype, device, skipna, fill, routed):
    """B1 and B5 on float32 and bfloat16 on the card take the pass; the GEMM,
    scatter, float64, float16, a mean without skipna, a fill that float32
    does not hold exactly and the CPU keep the torch passes."""
    assert kernels._mean_pass(impl, dtype, device, skipna, fill) is routed


@pytest.fixture
def routed_on_cpu(monkeypatch):
    """The pass's route taken on the CPU, where the wrapper runs its plain
    version; returns the list of ``mean_finalize`` calls' result dtypes."""
    real_pass, real_fin = kernels._mean_pass, ck.mean_finalize
    calls = []

    def fin(*a, **k):
        out = real_fin(*a, **k)
        calls.append(out.dtype)
        return out

    monkeypatch.setattr(kernels, "_mean_pass",
                        lambda impl, dtype, device, skipna, fill:
                        real_pass(impl, dtype, "cuda", skipna, fill))
    monkeypatch.setattr(ck, "mean_finalize", fin)
    return calls


def _mean_data(shape, n, size, seed):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=shape + (n,)) * 10).astype(np.float32)
    data[rng.random(data.shape) < 0.15] = np.nan
    flat = data.reshape(-1, n)
    flat[0, :] = np.nan  # a row whose groups are all NaN
    flat[-1, 3] = np.inf
    flat[-1, 4] = -np.inf
    flat[0 if flat.shape[0] == 1 else 1, 5] = np.inf
    codes = rng.integers(-1, size + 2, n)
    codes[codes == 1] = 2  # group 1 never occurs: empty
    return torch.from_numpy(data), torch.from_numpy(codes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl, size", [("kernel", 12), ("radixbin", 600)])
@pytest.mark.parametrize("shape", [(7,), (2, 3), (1,)], ids=str)
@pytest.mark.parametrize("fill", [None, -1])
def test_routed_mean_is_todays_result(routed_on_cpu, dtype, impl, size, shape, fill):
    """``nanmean`` through the pass gives today's result bit for bit: shape,
    dtype, the (K, size) row-major strides and every value, with NaN,
    +-inf, all-NaN rows, missing labels and an empty group."""
    data, codes = _mean_data(shape, 1500, size, seed=size + len(shape))
    data = data.to(dtype)
    with flox_tpu_torch.set_options(segment_sum_impl=impl):
        got = kernels.nanmean(codes, data, size=size, fill_value=fill)
        assert routed_on_cpu == [dtype]
        routed_on_cpu.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "_mean_pass", lambda *a: False)
            want = kernels.nanmean(codes, data, size=size, fill_value=fill)
    assert routed_on_cpu == []
    assert tuple(got.shape) == shape + (size,) and got.dtype == dtype
    assert got.stride() == want.stride() == torch.empty(shape + (size,)).stride()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("func", ["mean", "nanvar", "nansum"])
def test_other_reductions_skip_the_pass(routed_on_cpu, func):
    """A mean without skipna, the variance and the sum keep their passes."""
    data, codes = _mean_data((4,), 400, 12, seed=3)
    getattr(kernels, func)(codes, data, size=12)
    assert routed_on_cpu == []


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [6, 600])
def test_groupby_reduce_nanmean_matches_reference_through_the_pass(routed_on_cpu, dtype_name,
                                                                   size):
    """``groupby_reduce(func="nanmean")`` through the pass against flox_tpu
    on the port's parity inputs (NaN data, ±inf, NaN labels, absent groups),
    at the core tests' bars: float32 ``rtol=1e-5, atol=1e-6``, bfloat16 one
    bfloat16 ulp."""
    import jax.numpy as jnp

    rng = np.random.default_rng(size)
    data = rng.normal(size=(4, 96)).astype(np.float32)
    data[rng.random(data.shape) < 0.1] = np.nan
    data[0, 5], data[-1, 7] = np.inf, -np.inf
    labels = rng.integers(0, 5, 96).astype(np.float64)
    labels[labels == 3] = 0
    labels[rng.random(96) < 0.08] = np.nan
    expected = np.arange(float(size))
    ref_in = jnp.asarray(data).astype(jnp.bfloat16) if dtype_name == "bfloat16" else data
    with flox_tpu.set_options(segment_sum_impl="pallas", segment_minmax_impl="pallas"):
        ref, rgroups = flox_tpu.groupby_reduce(ref_in, labels, func="nanmean", engine="jax",
                                               expected_groups=expected)
        port_opts = from_reference(dict(ref_options.OPTIONS))
    # past B1's 512 groups the reference's Pallas policy falls to scatter;
    # the port's B5 is the kernel there
    port_opts["segment_sum_impl"] = "kernel" if size <= 512 else "radixbin"
    port_in = torch.from_numpy(data)
    if dtype_name == "bfloat16":
        port_in = port_in.to(torch.bfloat16)
    with flox_tpu_torch.set_options(**port_opts):
        got, pgroups = flox_tpu_torch.groupby_reduce(port_in, labels, func="nanmean",
                                                     device="cpu", expected_groups=expected)
    assert routed_on_cpu == [port_in.dtype]
    np.testing.assert_array_equal(pgroups, rgroups)
    g = got.to(torch.float64).numpy()
    r = np.asarray(ref).astype(np.float64)
    assert g.shape == r.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True)
        return
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    ok = ~np.isnan(g)
    big = np.maximum(np.abs(g[ok]), np.abs(r[ok]))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    with np.errstate(invalid="ignore"):
        assert np.all((g[ok] == r[ok]) | (np.abs(g[ok] - r[ok]) <= ulp))


# ---------------------------------------------------------------------------
# the wrapper's checks and its launch, with the library faked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["rank", "shape", "dtype", "strided", "rowcount_dtype",
                                 "rowcount_shape", "result_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    legs, rowcount, fill, _ = _legs("posinf", size=4, k=6)
    dtype = torch.float32
    if bad == "rank":
        legs[0] = legs[0].reshape(-1)
    elif bad == "shape":
        legs[2] = legs[2][:, :5].contiguous()
    elif bad == "dtype":
        legs[1] = legs[1].double()
    elif bad == "strided":
        legs[3] = legs[3].T.contiguous().T
    elif bad == "rowcount_dtype":
        rowcount = rowcount.long()
    elif bad == "rowcount_shape":
        rowcount = rowcount[:3]
    elif bad == "result_dtype":
        dtype = torch.float16
    with pytest.raises((ValueError, TypeError)):
        ck.mean_finalize(*legs, rowcount, fill, dtype)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def flox_mean_finalize(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ck, "_lib", lambda name, argtypes: lib)
    monkeypatch.setattr(ck, "_stream", lambda device: None)
    return lib


@pytest.mark.parametrize("dtype, code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_launch_arguments(fake_card, dtype, code):
    """What the wrapper hands the C entry point: the four legs and the counts
    in place, (K, size), the fill, the result dtype's code and the (K, size)
    result it returns; one launch, the ``kernels.mean_finalize_launches``
    counter and a ``launch`` span of the bytes it must move."""
    legs, rowcount, _, _ = _legs("both", size=9, k=40)
    before = dict(ck.LAUNCHES)
    telemetry.reset()
    try:
        with flox_tpu_torch.set_options(telemetry=True):
            nbytes = 4 * 9 * 40 * 4 + 9 * 4 + 9 * 40 * dtype.itemsize
            out = ck._mean_finalize_cuda(legs, rowcount, -2.5, dtype, nbytes)
        counted = telemetry.METRICS.get("kernels.mean_finalize_launches")
        spans = [r["attrs"] for r in telemetry.spans()
                 if r["type"] == "span" and r["name"] == "launch"]
    finally:
        telemetry.reset()
    assert ck.LAUNCHES["mean_finalize"] == before["mean_finalize"] + 1
    assert {k: v for k, v in ck.LAUNCHES.items() if k != "mean_finalize"} == {
        k: v for k, v in before.items() if k != "mean_finalize"}
    ((args),) = fake_card.calls
    assert args == (*(t.data_ptr() for t in legs), rowcount.data_ptr(), 40, 9, -2.5, code,
                    out.data_ptr(), None)
    assert out.dtype == dtype and tuple(out.shape) == (40, 9) and out.is_contiguous()
    assert counted == 1
    assert spans == [{"kernel": "mean_finalize", "nbytes": nbytes}]


def test_nothing_to_read_launches_nothing(fake_card):
    legs = [torch.zeros((5, 0)) for _ in range(4)]
    before = dict(ck.LAUNCHES)
    out = ck._mean_finalize_cuda(legs, torch.zeros(5, dtype=torch.int32), NAN,
                                 torch.float32, 0)
    assert fake_card.calls == [] and ck.LAUNCHES == before
    assert tuple(out.shape) == (0, 5)


def test_kernel_is_a_csrc_kernel_of_the_trace():
    """The pass is one of the program's hand-written kernels to the
    benchmark's trace reader (``kernel_roofline``, ``other_device_ms``)."""
    from portbench import tracemath

    kernels_ = tracemath.csrc_kernels()
    assert "mean_finalize_kernel" in kernels_
    name = "void (anonymous namespace)::mean_finalize_kernel<float>((anonymous namespace)::Legs)"
    assert tracemath.kind(name, kernels_) == "csrc"
