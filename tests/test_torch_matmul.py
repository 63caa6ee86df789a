"""The port's one-hot GEMM segment sum (``segment_sum_impl="matmul"``)
against flox_tpu's, on the CPU.

The same numpy inputs, made from a seed, go to the reference (JAX on the
CPU, x64, ``engine="jax"``, its options set to ``segment_sum_impl="matmul"``)
and to the port (``device="cpu"``). The parts:

* (a) ``kernels._seg_matmul_raw`` against the reference's, unblocked and
  blocked (``matmul_block_bytes=2**20``, K past the block with a ragged
  tail), K = 0 and N = 0, with NaN, +-inf and missing labels;
* (b) ``kernels._use_matmul_path`` against the reference's guard on a grid
  of shapes, dtypes, group counts and both options (the reference's (N, K)
  layout transposed to the port's (K, N));
* (c) the routing of ``kernels._segment_sum_impl`` on a CUDA and a CPU
  device (passed as ``device_type``; the reference's TPU dispatch is the
  CUDA column), the tuner's candidates and the cost model's prior;
* (d) ``groupby_reduce``, ``groupby_aggregate_many`` and a streamed call
  end to end;
* (e) the options: ``from_reference``, the validators, ``trace_fingerprint``.

Bars: marker counts, routes and options exactly; float64 sums and results
``rtol=1e-10, atol=1e-12`` (the reference's own bar for this route,
tests/test_kernels.py ``TestMatmulPath``); float32 and bfloat16 results
``rtol=2e-6, atol=2e-6``, the reference's float32 bar for the route
(``test_vs_oracle_with_nonfinite``), against the reference and, for the raw
sums, against a float64 oracle; the raw float32 sums against the
reference's within ``1e-5 * S`` per (column, group), S the sum of the
absolute finite values (the bar of the port's kernel tests against the
reference's kernels, tests/test_torch_kernels.py): the reference adds in
float32, the port's float32 sums are a float64 product rounded once.
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import autotune as ref_autotune
from flox_tpu import costmodel as ref_costmodel
from flox_tpu import kernels as ref_kernels
from flox_tpu import options as ref_options
from flox_tpu import streaming as ref_streaming
import flox_tpu_torch
from flox_tpu_torch import autotune, cache, costmodel
from flox_tpu_torch import kernels as pk
from flox_tpu_torch import streaming as pst
from flox_tpu_torch.options import from_reference, trace_fingerprint

F64_BAR = dict(rtol=1e-10, atol=1e-12)
F32_BAR = dict(rtol=2e-6, atol=2e-6)
H100 = "NVIDIA H100 80GB HBM3"


@contextlib.contextmanager
def ref_opts(**kw):
    """The reference's options in every module dict it may read: a module
    that bound ``OPTIONS`` at import keeps the old dict after one of the
    reference's option tests reloads ``flox_tpu.options``."""
    dicts = {}
    for name, mod in list(sys.modules.items()):
        if name == "flox_tpu" or name.startswith("flox_tpu."):
            d = getattr(mod, "OPTIONS", None)
            if isinstance(d, dict) and all(key in d for key in kw):
                dicts[id(d)] = d
    saved = [(d, {k: d[k] for k in kw}) for d in dicts.values()]
    for d in dicts.values():
        d.update(kw)
    try:
        yield
    finally:
        for d, old in saved:
            d.update(old)


def _inputs(seed, k, n, size, dtype):
    """(K, N) data with NaN, +-inf, and int32 safe codes (missing -> size)."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(k, n)) * 3
    if k and n:
        data[rng.random((k, n)) < 0.05] = np.nan
        data[rng.random((k, n)) < 0.01] = np.inf
        data[rng.random((k, n)) < 0.01] = -np.inf
    codes = rng.integers(-1, size + 1, n)
    codes = np.where((codes < 0) | (codes >= size), size, codes).astype(np.int32)
    if dtype == "bfloat16":
        port = torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
        ref = jnp.asarray(data.astype(np.float32)).astype(jnp.bfloat16)
        np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref.astype(jnp.float32)))
        return port, ref, codes
    host = data.astype(dtype)
    return torch.from_numpy(host), jnp.asarray(host), codes


def _oracle_sums(data: torch.Tensor, codes: np.ndarray, size: int, absolute=False):
    """float64 sums of the (absolute) finite values, (K, size)."""
    x = data.double().numpy()
    x = np.where(np.isfinite(x), np.abs(x) if absolute else x, 0.0)
    out = np.zeros((x.shape[0], size))
    for g in range(size):
        out[:, g] = x[:, codes == g].sum(axis=1)
    return out


# ---------------------------------------------------------------------------
# (a) the raw GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("k, n, block", [
    (6, 300, None),  # one block
    (300, 500, 2**20),  # blocked: 128 / 64 / 256 rows a block, a ragged tail
    (0, 50, None),  # K = 0
    (4, 0, None),  # N = 0
], ids=["unblocked", "blocked", "k0", "n0"])
def test_seg_matmul_raw_matches_reference(dtype, k, n, block):
    size = 6
    port, ref, codes = _inputs(11, k, n, size, dtype)
    opts = {} if block is None else {"matmul_block_bytes": block}
    ref_raw = lambda d, c: ref_kernels._seg_matmul_raw(d, c, size)  # noqa: E731
    if dtype != "bfloat16":
        # one program (the options are read while tracing); XLA's CPU backend
        # compiles no bf16 x bf16 -> f32 dot outside a loop, so bf16 runs eagerly
        ref_raw = jax.jit(ref_raw)
    with ref_opts(**opts):
        want = [np.asarray(t).T for t in ref_raw(ref.T, jnp.asarray(codes))]
    with flox_tpu_torch.set_options(**opts):
        got = [t.numpy() for t in pk._seg_matmul_raw(port, torch.from_numpy(codes), size)]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (k, size)
        assert g.dtype == w.dtype
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)  # NaN / +inf / -inf counts
    if dtype == "float64":
        np.testing.assert_allclose(got[0], want[0], **F64_BAR)
    else:
        scale = _oracle_sums(port, codes, size, absolute=True)
        assert (np.abs(got[0] - want[0]) <= 1e-5 * scale).all()
    bar = F64_BAR if dtype == "float64" else F32_BAR
    np.testing.assert_allclose(got[0], _oracle_sums(port, codes, size), **bar)
    if k and n:
        assert got[1].sum() > 0 and got[2].sum() > 0 and got[3].sum() > 0


def test_seg_matmul_raw_blocks_as_the_reference(monkeypatch):
    """The blocked path runs K in blocks of the reference's row count (64
    float32 rows of N = 1000 under 2**20 bytes), the tail unpadded: one sums
    GEMM and one markers GEMM a block."""
    port, _, codes = _inputs(3, 300, 1000, 6, "float32")
    rows = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: (rows.append(a.shape[-2]), real(a, b))[1])
    with flox_tpu_torch.set_options(matmul_block_bytes=2**20):
        pk._seg_matmul_raw(port, torch.from_numpy(codes), 6)
    assert rows == [r for r in [64] * 4 + [44] for _ in range(2)]


def test_float32_sums_ignore_the_tf32_setting():
    """The float32 route's bits do not depend on the process-wide float32
    matmul precision, and a rerun gives the same bits."""
    port, _, codes = _inputs(5, 40, 2000, 12, "float32")
    c = torch.from_numpy(codes)
    base = [t.clone() for t in pk._seg_matmul_raw(port, c, 12)]
    prev = torch.backends.cuda.matmul.fp32_precision
    prev_cpu = torch.backends.mkldnn.matmul.fp32_precision
    try:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
        again = pk._seg_matmul_raw(port, c, 12)
    finally:
        torch.backends.cuda.matmul.fp32_precision = prev
        torch.backends.mkldnn.matmul.fp32_precision = prev_cpu
    for a, b in zip(base, again):
        assert torch.equal(a, b)
    for a, b in zip(base, pk._seg_matmul_raw(port, c, 12)):
        assert torch.equal(a, b)


def test_bfloat16_counts_past_256():
    """A group of more than 256 bfloat16 values: exact counts (the reference
    accumulates in float32) and float32-accurate sums."""
    n = 3000
    data = torch.full((2, n), 1.5, dtype=torch.bfloat16)
    data[0, ::7] = float("nan")
    codes = torch.zeros(n, dtype=torch.int32)
    sums, nan_c, _, _ = pk._seg_matmul_raw(data, codes, 1)
    assert sums.dtype == torch.float32
    assert nan_c[0, 0].item() == len(range(0, n, 7)) and nan_c[1, 0].item() == 0
    assert sums[1, 0].item() == 1.5 * n and sums[0, 0].item() == 1.5 * (n - len(range(0, n, 7)))
    with flox_tpu_torch.set_options(segment_sum_impl="matmul"):
        out, _ = flox_tpu_torch.groupby_reduce(data, np.zeros(n, int), func="nanmean",
                                               device="cpu")
    assert out.dtype == torch.bfloat16 and out.float().tolist() == [[1.5], [1.5]]


# ---------------------------------------------------------------------------
# (b) the guard
# ---------------------------------------------------------------------------


class _RefProbe:
    """A shape-and-dtype stand-in in the reference's (N, ...) layout."""

    def __init__(self, shape, dtype):
        self.shape, self.ndim = shape, len(shape)
        self.dtype = jnp.dtype(dtype)


_GUARD_DTYPES = ["float16", "bfloat16", "float32", "float64", "int32", "int64"]
_GUARD_LEADS = [(), (1,), (3,), (8,), (9,), (2, 4), (100,), (5000,)]
_GUARD_NS = [0, 1, 1000, 2**20, 2**22, 2**24, 2**26, 2**28]
_GUARD_SIZES = [1, 4, 12, 32, 33, 384, 385, 10000]


@pytest.mark.parametrize("opts", [{}, {"matmul_num_groups_max": 16},
                                  {"matmul_num_groups_max": 0}], ids=str)
@pytest.mark.parametrize("dtype", _GUARD_DTYPES)
def test_use_matmul_path_matches_reference(opts, dtype):
    seen = set()
    with ref_opts(**opts), flox_tpu_torch.set_options(**opts):
        for lead in _GUARD_LEADS:
            for n in _GUARD_NS:
                port = torch.empty(lead + (n,), dtype=getattr(torch, dtype), device="meta")
                ref = _RefProbe((n,) + lead, dtype)
                for size in _GUARD_SIZES:
                    want = ref_kernels._use_matmul_path("sum", ref, size)
                    assert pk._use_matmul_path("sum", port, size) == want, (lead, n, size)
                    assert pk._use_matmul_path("max", port, size) is False
                    seen.add(want)
    if dtype.startswith(("float", "bfloat")) and opts.get("matmul_num_groups_max") != 0:
        assert seen == {True, False}  # the grid reaches both verdicts


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------

_POLICIES = ["auto", "kernel", "radixbin", "matmul", "scatter"]
#: (dtype, (K, N), size): which guards pass
_ROUTE_CASES = [
    ("float32", (64, 100), 12),  # B1, the GEMM
    ("float32", (64, 100), 600),  # B5 only
    ("float32", (2, 100), 12),  # B1; the GEMM fails size <= 4 K
    ("float64", (64, 100), 12),  # no kernel; the GEMM
    ("float64", (64, 100), 385),  # nothing but index_add_
    ("float16", (64, 100), 300),  # no kernel; the GEMM
    ("bfloat16", (64, 4), 12),  # no kernel (N < 8); the GEMM
    ("int32", (64, 100), 12),  # never: integer sums stay exact
]


def _table(policy, device_type, dtype, shape, size):
    """The routing table of ``kernels._segment_sum_impl``, tuner off."""
    k, n = shape
    floating = dtype.startswith(("float", "bfloat"))
    if policy == "scatter" or not floating:
        return "scatter"
    kernel_dtype = dtype in ("float32", "bfloat16") and n >= 8
    kernel_ok, radixbin_ok = kernel_dtype and size <= 512, kernel_dtype and size <= 16384
    matmul_ok = size <= 384 and size <= 4 * k
    if policy == "matmul":
        return "matmul" if matmul_ok else "scatter"
    if policy == "kernel":
        return "kernel" if kernel_ok else "scatter"
    if policy == "radixbin":
        return "radixbin" if radixbin_ok else "scatter"
    if kernel_ok:
        return "kernel"
    if radixbin_ok:
        return "radixbin"
    return "matmul" if matmul_ok and device_type == "cuda" else "scatter"


@pytest.fixture
def ref_on_tpu(monkeypatch):
    """The reference's TPU dispatch with both Pallas probes passing."""
    monkeypatch.setattr(ref_kernels, "_on_tpu", lambda: True)
    monkeypatch.setattr(ref_kernels, "_pallas_runtime_ok", lambda: True)
    monkeypatch.setattr(ref_kernels, "_pallas_radixbin_runtime_ok", lambda: True)


@pytest.mark.parametrize("policy", _POLICIES)
@pytest.mark.parametrize("dtype, shape, size", _ROUTE_CASES, ids=str)
def test_routing_table_tuner_off(ref_on_tpu, policy, dtype, shape, size):
    data = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    ref_policy = {"kernel": "pallas"}.get(policy, policy)
    with ref_opts(segment_sum_impl=ref_policy):
        ref = ref_kernels._segment_sum_impl(_RefProbe(shape[::-1], dtype), size)
    with flox_tpu_torch.set_options(segment_sum_impl=policy):
        cuda = pk._segment_sum_impl(data, size, device_type="cuda")
        cpu = pk._segment_sum_impl(data, size, device_type="cpu")
    assert cuda == _table(policy, "cuda", dtype, shape, size)
    assert cpu == _table(policy, "cpu", dtype, shape, size)
    # the CUDA column is the reference's TPU dispatch
    assert cuda == {"pallas": "kernel"}.get(ref, ref)
    # no decision moves a call off B1 or B5 on the card
    if _table("auto", "cuda", dtype, shape, size) in ("kernel", "radixbin") and policy == "auto":
        assert cuda in ("kernel", "radixbin")


@pytest.fixture
def tuner():
    cache.clear_all()
    with flox_tpu_torch.set_options(autotune=True, autotune_cache_path=None):
        yield
    cache.clear_all()


@pytest.mark.parametrize("dtype, shape, size", _ROUTE_CASES, ids=str)
def test_routing_tuner_candidates(monkeypatch, tuner, dtype, shape, size):
    """Tuner on: on CUDA the kernels whose guards pass, and only where none
    does ``index_add_`` plus the GEMM where its guard passes; on the CPU
    ``index_add_`` plus the GEMM (the reference's candidates off TPU)."""
    asked = []

    def decide(family, fallback, candidates, **kw):
        asked.append((family, fallback, list(candidates), kw["platform"]))
        return fallback

    monkeypatch.setattr(autotune, "decide", decide)
    data = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    floating = dtype.startswith(("float", "bfloat"))
    for device_type in ("cuda", "cpu"):
        asked.clear()
        got = pk._segment_sum_impl(data, size, device_type=device_type)
        assert got == _table("auto", device_type, dtype, shape, size)
        if not floating:
            assert asked == []
            continue
        (family, fallback, cands, plat), = asked
        assert (family, fallback, plat) == ("segment_sum", got, device_type)
        auto = _table("auto", "cuda", dtype, shape, size)
        matmul_ok = _table("matmul", "cuda", dtype, shape, size) == "matmul"
        if device_type == "cuda" and auto in ("kernel", "radixbin"):
            kernel_dtype = dtype in ("float32", "bfloat16") and shape[1] >= 8
            want = [name for name, cap in (("kernel", 512), ("radixbin", 16384))
                    if kernel_dtype and size <= cap]
        else:
            want = ["scatter", "matmul"] if matmul_ok else ["scatter"]
        assert cands == want


@pytest.mark.parametrize("dtype, shape, size", [c for c in _ROUTE_CASES if c[0] != "int32"],
                         ids=str)
def test_routing_cpu_candidates_match_reference(monkeypatch, tuner, dtype, shape, size):
    """Off TPU the reference's tuner offers ``index_add_`` and the GEMM where
    its guard passes: the port's CPU candidates."""
    asked = {}

    def ref_decide(family, fallback, candidates, **kw):
        asked["ref"] = list(candidates)
        return fallback

    def port_decide(family, fallback, candidates, **kw):
        asked["port"] = list(candidates)
        return fallback

    monkeypatch.setattr(ref_autotune, "decide", ref_decide)
    monkeypatch.setattr(ref_kernels, "_on_tpu", lambda: False)
    monkeypatch.setattr(autotune, "decide", port_decide)
    with ref_opts(autotune=True):
        ref_kernels._segment_sum_impl(_RefProbe(shape[::-1], dtype), size)
    pk._segment_sum_impl(torch.empty(shape, dtype=getattr(torch, dtype), device="meta"), size,
                         device_type="cpu")
    assert asked["port"] == asked["ref"]


@pytest.fixture
def h100(monkeypatch):
    """The cost model on an H100 (its peak row), without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(costmodel, "device_name", lambda device=None: H100)
    with flox_tpu_torch.set_options(telemetry=True, costmodel=True):
        yield


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
@pytest.mark.parametrize("ngroups", [1, 12, 384, 800, 1600, 5000])
@pytest.mark.parametrize("nelems", [1 << 10, 65160 * 26304])
def test_prior_matches_reference_model_on_h100(monkeypatch, h100, dtype, ngroups, nelems):
    """The ``segment_sum`` prior: the reference's model (GEMM operations at
    the float32 rate against a scatter at a twentieth of the memory rate),
    read on the H100 row."""
    row = costmodel.PEAK_TABLE[H100]
    monkeypatch.setattr(ref_costmodel, "peaks_for",
                        lambda platform=None: {"gflops": row["gflops"],
                                               "bw_gbps": row["bw_gbps"]})
    cands = ("scatter", "matmul")
    with ref_opts(telemetry=True, costmodel=True):
        want = ref_costmodel.analytic_prior("segment_sum", "scatter", cands, dtype=dtype,
                                            ngroups=ngroups, nelems=nelems)
    got = costmodel.analytic_prior("segment_sum", "scatter", cands, dtype=dtype,
                                   ngroups=ngroups, nelems=nelems, platform="cuda")
    assert got == want
    assert costmodel.analytic_prior("segment_sum", "kernel", ("kernel", "radixbin"),
                                    dtype=dtype, ngroups=ngroups, nelems=nelems,
                                    platform="cuda") is None


def test_prior_picks_the_gemm_for_float64_months(h100, tuner):
    """Tuner on, empty store: the float64 month nanmean's candidates on the
    card are ``index_add_`` and the GEMM, and the prior picks the GEMM; on
    the CPU (no peak row) the heuristic stands."""
    data = torch.empty((65160, 26304), dtype=torch.float64, device="meta")
    assert pk._segment_sum_impl(data, 12, device_type="cuda") == "matmul"
    assert pk._segment_sum_impl(data, 12, device_type="cpu") == "scatter"
    assert costmodel.analytic_prior("segment_sum", "scatter", ("scatter", "matmul"),
                                    dtype="float64", ngroups=12, nelems=data.numel(),
                                    platform="cpu") is None


def test_sweep_times_the_gemm_on_the_cpu(tuner):
    autotune.prime_reduce("nansum", "float64", 6, 1 << 12, torch.device("cpu"))
    rec = autotune.lookup("segment_sum", dtype="float64", ngroups=6, nelems=1 << 12,
                          platform="cpu")
    assert set(rec["candidates"]) == {"scatter", "matmul"}
    assert all(c["gbps"] > 0 for c in rec["candidates"].values())


def test_gemm_is_used_by_seg_and_fused_stats(monkeypatch):
    calls = []
    real = pk._seg_matmul_raw
    monkeypatch.setattr(pk, "_seg_matmul_raw", lambda *a: (calls.append(1), real(*a))[1])
    data = torch.randn(8, 64, dtype=torch.float64)
    codes = torch.arange(64, dtype=torch.int32) % 5
    with flox_tpu_torch.set_options(segment_sum_impl="matmul"):
        pk._seg("sum", data, codes, 5)
        fused = pk._fused_stats(data, codes, 5, ("nansum", "nanlen"))
        assert pk._fused_stats(data, codes, 5, ("nansum", "nanmax")) is None
    assert len(calls) == 2 and set(fused) == {"nansum", "nanlen"}
    with flox_tpu_torch.set_options(segment_sum_impl="matmul"):
        # the GEMM's cap is 0 groups of a hand-written kernel
        assert pk.dense_kernel_cap("nanmean", torch.float32) == 0


# ---------------------------------------------------------------------------
# (d) end to end
# ---------------------------------------------------------------------------

E2E_FUNCS = ["sum", "nansum", "mean", "nanmean", "var", "nanvar", "std"]


def _e2e_inputs(dtype, seed=21):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(3, 4, 240)).astype(dtype)
    vals[..., rng.random(240) < 0.15] = np.nan
    vals[1, 2, 7] = np.inf
    labels = rng.integers(0, 6, 240).astype(float)
    labels[::17] = np.nan  # missing labels
    return vals, labels


@pytest.fixture
def gemm_calls(monkeypatch):
    calls = []
    real = pk._seg_matmul_raw
    monkeypatch.setattr(pk, "_seg_matmul_raw", lambda *a: (calls.append(1), real(*a))[1])
    return calls


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("func", E2E_FUNCS)
def test_groupby_reduce_matches_reference(gemm_calls, dtype, func):
    vals, labels = _e2e_inputs(dtype)
    with ref_opts(segment_sum_impl="matmul"):
        assert ref_kernels._segment_sum_impl(_RefProbe((240, 12), dtype), 6) == "matmul"
        ref, rgroups = flox_tpu.groupby_reduce(vals, labels, func=func, engine="jax")
    with flox_tpu_torch.set_options(segment_sum_impl="matmul"):
        got, groups = flox_tpu_torch.groupby_reduce(vals, labels, func=func, device="cpu")
    assert gemm_calls
    np.testing.assert_array_equal(groups, np.asarray(rgroups))
    ref = np.asarray(ref)
    assert got.numpy().dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, equal_nan=True,
                               **(F64_BAR if dtype == "float64" else F32_BAR))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_aggregate_many_matches_reference(gemm_calls, dtype):
    vals, labels = _e2e_inputs(dtype, seed=22)
    funcs = ("nansum", "nanmean", "count", "nanvar")
    with ref_opts(segment_sum_impl="matmul"):
        ref, _ = flox_tpu.groupby_aggregate_many(vals, labels, funcs=funcs, engine="jax")
    with flox_tpu_torch.set_options(segment_sum_impl="matmul"):
        got, _ = flox_tpu_torch.groupby_aggregate_many(vals, labels, funcs=funcs, device="cpu")
    assert gemm_calls and list(got) == list(funcs)
    for f in funcs:
        r = np.asarray(ref[f])
        assert got[f].numpy().dtype == r.dtype, f
        np.testing.assert_allclose(got[f].numpy(), r, equal_nan=True,
                                   **(F64_BAR if dtype == "float64" else F32_BAR))


@pytest.mark.parametrize("func", ["nanmean", "sum", "nanvar"])
def test_streamed_call_matches_reference(gemm_calls, func):
    vals, labels = _e2e_inputs("float64", seed=23)
    vals, labels = vals.reshape(12, 240), labels
    with ref_opts(segment_sum_impl="matmul"):
        ref, _ = ref_streaming.streaming_groupby_reduce(vals, labels, func=func, batch_len=70)
    with flox_tpu_torch.set_options(segment_sum_impl="matmul"):
        got, _ = pst.streaming_groupby_reduce(vals, labels, func=func, batch_len=70,
                                              device="cpu")
    assert gemm_calls
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), equal_nan=True, **F64_BAR)


# ---------------------------------------------------------------------------
# (e) options
# ---------------------------------------------------------------------------


def test_from_reference_carries_matmul():
    opts = dict(ref_options.OPTIONS, segment_sum_impl="matmul", matmul_num_groups_max=100,
                matmul_block_bytes=2**21)
    got = from_reference(opts)
    assert got["segment_sum_impl"] == "matmul"
    assert got["matmul_num_groups_max"] == 100 and got["matmul_block_bytes"] == 2**21
    with flox_tpu_torch.set_options(**got):
        assert flox_tpu_torch.OPTIONS["segment_sum_impl"] == "matmul"
    with ref_opts(segment_sum_impl="matmul"):
        assert from_reference(flox_tpu.options.OPTIONS)["segment_sum_impl"] == "matmul"
    assert flox_tpu_torch.OPTIONS["matmul_num_groups_max"] == \
        ref_options.OPTIONS["matmul_num_groups_max"] == 384
    assert flox_tpu_torch.OPTIONS["matmul_block_bytes"] == 2**28


@pytest.mark.parametrize("key, value", [
    ("matmul_num_groups_max", v) for v in (-1, 1.5, "12", None, 0, 384, 10**6, True)
] + [
    ("matmul_block_bytes", v) for v in (0, 2**20 - 1, 2.0**21, "x", None, 2**20, 2**28)
] + [
    ("segment_sum_impl", v) for v in ("matmul", "gemm", "MATMUL", None, "scatter")
], ids=str)
def test_validators_agree_with_reference(key, value):
    def accepts(set_options):
        try:
            with set_options(**{key: value}):
                pass
        except (ValueError, TypeError):
            return False
        return True

    assert accepts(flox_tpu_torch.set_options) == accepts(flox_tpu.set_options)


@pytest.mark.parametrize("key, value", [("matmul_num_groups_max", 12),
                                        ("matmul_block_bytes", 2**24),
                                        ("segment_sum_impl", "matmul")])
def test_trace_fingerprint_follows_the_keys(key, value):
    before = trace_fingerprint()
    with flox_tpu_torch.set_options(**{key: value}):
        assert trace_fingerprint() != before
    assert trace_fingerprint() == before
