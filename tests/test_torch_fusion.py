"""The port's multi-statistic fusion (flox_tpu_torch.groupby_aggregate_many and
the multi-statistic kernel's wrapper) against flox_tpu's, on the CPU.

The reference runs with ``engine="jax"`` under
``set_options(segment_sum_impl="pallas", segment_minmax_impl="pallas")``, so
its fused legs reach the multi-statistic Pallas kernel in interpret mode, as
tests/test_fusion.py's ``TestFusedKernelPrimitive`` runs it. The port runs with
``device="cpu"`` under the same options (``options.from_reference``), where
the kernel wrappers run their plain versions. Inputs are numpy arrays made
from a seed.

Tolerances:
* NaN/+inf/-inf marker counts, counts, integers, min/max and bools: exact;
* kernel sums: ``|port - ref| <= 1e-5 * S`` per (group, column), ``S`` the sum
  of the absolute finite values, the bar of tests/test_torch_kernels.py: the
  two sides add in different orders, and 1e-5 is about 170 float32 epsilons;
* float32 results of whole calls: ``rtol=1e-5, atol=1e-6`` (the reference's
  bar for its Pallas path against scatter), also for the float64 mean/var of
  int32 data, which both sides compute in float32; float64 ``rtol=1e-12``;
* bfloat16: within one bfloat16 ulp, compared in float32 (both sides round
  float32 results once to bfloat16).
* fused against sequential on the port itself: bit for bit, as the
  reference's ``TestEagerBitIdentity`` holds the reference.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import fusion as ref_fusion
from flox_tpu import options as ref_options
from flox_tpu.pallas_kernels import segment_multistat_pallas
import flox_tpu_torch
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import kernels as pk
from flox_tpu_torch.aggregations import FUSABLE_FUNCS, plan_fused
from flox_tpu_torch.options import from_reference

REPO = Path(__file__).resolve().parent.parent
PALLAS = dict(segment_sum_impl="pallas", segment_minmax_impl="pallas")
ACCUMS = ["plain", "kahan", "dd"]
EXACT = {"count", "min", "max", "nanmin", "nanmax", "all", "any"}

FUNC_SETS = [
    ("nanmean", "nanmin", "nanmax"),
    ("count", "mean", "std", "min", "max"),
    ("sum", "prod", "all", "any"),
    ("nanvar", "nanmean"),
]


def _port_options():
    with flox_tpu.set_options(**PALLAS):
        return from_reference(dict(ref_options.OPTIONS))


def _bf16_round(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _to_torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_ref(x, dtype):
    import jax.numpy as jnp

    arr = jnp.asarray(np.ascontiguousarray(x))
    return arr.astype(jnp.bfloat16) if dtype == "bfloat16" else arr


def _check(got: torch.Tensor, ref, *, exact=False, label="", f32_work=False):
    ref = np.asarray(ref)
    name = "bfloat16" if got.dtype == torch.bfloat16 else str(got.dtype).removeprefix("torch.")
    assert name == ref.dtype.name, (label, got.dtype, ref.dtype)
    assert tuple(got.shape) == ref.shape, label
    if not got.is_floating_point():
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=label)
        return
    g, r = got.to(torch.float64).numpy(), ref.astype(np.float64)
    if exact:
        np.testing.assert_array_equal(g, r, err_msg=label)
    elif got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=label)
        ok = ~np.isnan(g)
        big = np.maximum(np.abs(g[ok]), np.abs(r[ok]))
        ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
        with np.errstate(invalid="ignore"):
            assert np.all((g[ok] == r[ok]) | (np.abs(g[ok] - r[ok]) <= ulp)), label
    elif got.dtype == torch.float64 and not f32_work:
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-14, equal_nan=True, err_msg=label)
    else:
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True, err_msg=label)


def _data(seed, shape=(3, 120), nan=0.1):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(np.float32) * 10
    data[rng.random(shape) < nan] = np.nan
    flat = data.reshape(-1, shape[-1])
    flat[0, 5] = np.inf
    flat[-1, 7] = -np.inf
    return data


def _labels(seed, n=120):
    """Float labels 0..4 with label 3 absent and some NaN (missing) labels."""
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, 5, n).astype(np.float64)
    labels[labels == 3] = 0
    labels[rng.random(n) < 0.08] = np.nan
    return labels


# ---------------------------------------------------------------------------
# the kernel: segment_multistat against segment_multistat_pallas
# ---------------------------------------------------------------------------


def _multistat_inputs(seed, k, n, size, dtype):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(k, n)).astype(np.float32) * 10
    data[rng.random((k, n)) < 0.05] = np.nan
    data[rng.random((k, n)) < 0.01] = np.inf
    data[rng.random((k, n)) < 0.01] = -np.inf
    data[0, : n // 8] = np.nan  # whole groups of row 0 may be all NaN
    codes = rng.integers(-1, size + 2, n).astype(np.int32)  # -1 and >= size drop out
    if size > 2:
        codes[codes == 1] = 0  # an empty group
    if dtype == "bfloat16":
        data = _bf16_round(data)
    return data, codes


def _abs_sums(data, codes, size):
    finite = np.where(np.isfinite(data), np.abs(data.astype(np.float64)), 0.0)
    return np.stack([finite[:, codes == g].sum(axis=1) for g in range(size)])


class TestMultistatKernel:
    @pytest.mark.parametrize("accum", ACCUMS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("size", [1, 4, 12])
    def test_plain_matches_pallas(self, accum, dtype, size):
        k, n = 3, 600
        data, codes = _multistat_inputs(size * 7 + len(accum), k, n, size, dtype)
        got = ck.segment_multistat(_to_torch(data, dtype), torch.from_numpy(codes), size, accum)
        want = segment_multistat_pallas(
            _to_ref(data, dtype).T, codes, size, interpret=True, accum=accum
        )
        sums, nan_c, pos_c, neg_c, mins, maxs = got
        assert sums.shape == (size, k) and sums.dtype == torch.float32
        assert mins.dtype == maxs.dtype == _to_torch(data, dtype).dtype
        for g, w in zip((nan_c, pos_c, neg_c), want[1:4]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w, dtype=np.float64))
        for g, w in zip((mins, maxs), want[4:]):
            np.testing.assert_array_equal(
                g.to(torch.float64).numpy(), np.asarray(w).astype(np.float64)
            )
        rsums = np.asarray(want[0], dtype=np.float64)
        tol = 1e-5 * _abs_sums(data, codes, size)
        assert np.all(np.abs(sums.numpy() - rsums) <= tol)

    def test_sums_are_segment_sum_raw(self):
        data, codes = _multistat_inputs(1, 4, 500, 12, "float32")
        t, c = torch.from_numpy(data), torch.from_numpy(codes)
        for accum in ACCUMS:
            got = ck.segment_multistat(t, c, 12, accum)
            for a, b in zip(got[:4], ck.segment_sum_raw(t, c, 12, accum)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))

    def test_all_nan_and_empty_groups_hold_identity(self):
        data = torch.tensor([[np.nan, np.nan, 1.0, -0.5, np.inf, 2.0, 3.0, 4.0]])
        codes = torch.tensor([0, 0, 1, 1, 1, 2, 2, 2], dtype=torch.int32)
        _, nan_c, _, _, mins, maxs = ck.segment_multistat(data, codes, 4)
        assert nan_c[:, 0].tolist() == [2.0, 0.0, 0.0, 0.0]
        assert mins[:, 0].tolist() == [np.inf, -0.5, 2.0, np.inf]
        assert maxs[:, 0].tolist() == [-np.inf, np.inf, 4.0, -np.inf]

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fused_segment_stats_matches_reference(self, dtype):
        from flox_tpu.kernels import fused_segment_stats as ref_fused

        want_names = ("sum", "nansum", "min", "max", "nanmin", "nanmax", "len", "nanlen")
        data, codes = _multistat_inputs(5, 2, 320, 4, dtype)
        with flox_tpu.set_options(**PALLAS):
            ref = ref_fused(codes, _to_ref(data, dtype), size=4, want=want_names)
        with flox_tpu_torch.set_options(**_port_options()):
            got = pk.fused_segment_stats(
                torch.from_numpy(codes), _to_torch(data, dtype), size=4, want=want_names
            )
        assert ref is not None and got is not None
        for name in want_names:
            r = np.asarray(ref[name]).astype(np.float64)
            g = got[name].to(torch.float64).numpy()
            if name in ("sum", "nansum"):
                finite = np.isfinite(r)
                np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=name)
                np.testing.assert_array_equal(g[~finite], r[~finite], err_msg=name)
                tol = 1e-5 * _abs_sums(data, np.where(codes >= 4, -1, codes), 4).T
                assert np.all(np.abs(g[finite] - r[finite]) <= tol[finite]), name
            else:
                np.testing.assert_array_equal(g, r, err_msg=name)

    def test_fused_stats_guards(self):
        data = torch.ones(2, 64)
        codes = torch.zeros(64, dtype=torch.int64)
        with flox_tpu_torch.set_options(segment_sum_impl="scatter"):
            assert pk.fused_segment_stats(codes, data, size=2, want=("sum", "nanlen")) is None
        with flox_tpu_torch.set_options(pallas_minmax_num_groups_max=1):
            assert pk.fused_segment_stats(codes, data, size=2, want=("sum", "min")) is None
        assert pk.fused_segment_stats(codes, data.double(), size=2, want=("sum", "min")) is None
        assert pk.fused_segment_stats(codes, data, size=2, want=("len", "nanlen")) is None
        assert pk.fused_segment_stats(codes, data, size=2, want=("sum", "min")) is not None


# ---------------------------------------------------------------------------
# the whole slice: groupby_aggregate_many against the reference
# ---------------------------------------------------------------------------


def _both(data, *by, funcs, dtype_name="float32", **kw):
    import jax.numpy as jnp

    ref_in = jnp.asarray(data).astype(jnp.bfloat16) if dtype_name == "bfloat16" else data
    with flox_tpu.set_options(**PALLAS):
        ref, *rgroups = flox_tpu.groupby_aggregate_many(ref_in, *by, funcs=funcs, engine="jax",
                                                        **kw)
    port_in = _to_torch(data, dtype_name)
    with flox_tpu_torch.set_options(**_port_options()):
        got, *pgroups = flox_tpu_torch.groupby_aggregate_many(port_in, *by, funcs=funcs,
                                                              device="cpu", **kw)
    assert tuple(got) == tuple(funcs)
    for p, r in zip(pgroups, rgroups):
        np.testing.assert_array_equal(p, np.asarray(r))
    return got, ref


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("funcs", FUNC_SETS, ids="+".join)
def test_aggregate_many_matches_reference(funcs, dtype_name):
    data = _data(0)
    if dtype_name == "float64":
        data = data.astype(np.float64)
    got, ref = _both(data, _labels(0), funcs=funcs, dtype_name=dtype_name,
                     expected_groups=np.arange(6.0))
    for f in funcs:
        _check(got[f], ref[f], exact=f in EXACT, label=f)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(3, 0), (0,)], ids=str)
def test_aggregate_many_zero_length_axis(shape, dtype_name):
    """The trio over a reduced axis of length 0 (ROADMAP C1): every group is
    empty, and each statistic is the reference's exactly, in shape and dtype
    (NaN throughout)."""
    funcs = ("nanmean", "nanmin", "nanmax")
    got, ref = _both(np.zeros(shape, dtype_name), np.zeros(0, int), funcs=funcs,
                     expected_groups=np.arange(6))
    for f in funcs:
        assert tuple(got[f].shape) == shape[:-1] + (6,)
        _check(got[f], ref[f], exact=True, label=f)


@pytest.mark.parametrize(
    "funcs,kw",
    [
        (("count", "mean", "std", "min", "max"),
         {"fill_value": {"mean": -1.0, "max": 9.0}, "finalize_kwargs": {"std": {"ddof": 1}}}),
        (("nanvar", "nanmean"), {"finalize_kwargs": {"ddof": 1}, "fill_value": 7.0}),
        (("nanmean", "nanmin", "nanmax"), {"min_count": 12}),
        (("sum", "prod", "all", "any"), {"min_count": 3, "fill_value": {"sum": -5.0}}),
        (("sum", "count", "nanmax"), {"dtype": {"sum": np.float64}}),
    ],
    ids=["fill-dict+ddof", "fill+ddof", "min_count", "min_count+fill", "dtype-dict"],
)
def test_aggregate_many_options(funcs, kw):
    got, ref = _both(_data(1), _labels(1), funcs=funcs, expected_groups=np.arange(6.0), **kw)
    for f in funcs:
        _check(got[f], ref[f], exact=f in EXACT, label=f)


@pytest.mark.parametrize("funcs", FUNC_SETS[:2], ids="+".join)
def test_aggregate_many_discovered_groups_two_bys_and_leading_dims(funcs):
    data = _data(2, shape=(2, 3, 120))
    rng = np.random.default_rng(2)
    got, ref = _both(data, _labels(2), funcs=funcs)
    for f in funcs:
        _check(got[f], ref[f], exact=f in EXACT, label=f)
    by1, by2 = rng.integers(0, 3, 120), rng.integers(0, 4, 120)
    got, ref = _both(data, by1, by2, funcs=funcs,
                     expected_groups=(np.arange(3), np.arange(4)))
    for f in funcs:
        assert tuple(got[f].shape) == (2, 3, 3, 4)
        _check(got[f], ref[f], exact=f in EXACT, label=f)


@pytest.mark.parametrize("axis", [-1, (1, 2)])
def test_aggregate_many_partial_axis(axis):
    data = _data(3, shape=(2, 3, 40))
    by = np.random.default_rng(3).integers(0, 4, size=(3, 40))
    got, ref = _both(data, by, funcs=("nanmean", "nanmax", "count"), axis=axis,
                     expected_groups=np.arange(4))
    for f in got:
        _check(got[f], ref[f], exact=f in EXACT, label=f)


def test_aggregate_many_int_and_bool_data():
    rng = np.random.default_rng(4)
    ints = rng.integers(-50, 50, size=(2, 90)).astype(np.int32)
    labels = rng.integers(0, 4, 90)
    funcs = ("sum", "count", "min", "max", "mean", "var", "prod")
    got, ref = _both(ints, labels, funcs=funcs)
    for f in funcs:
        # mean/var of int32 data work in float32 on both sides (the kernels'
        # dtype) and present float64: the float32 bar applies
        _check(got[f], ref[f], exact=f in EXACT | {"sum", "prod"}, label=f, f32_work=True)
    bools = rng.random((2, 90)) < 0.5
    got, ref = _both(bools, labels, funcs=("sum", "count", "all", "any"))
    for f in got:
        _check(got[f], ref[f], exact=True, label=f)
    with pytest.raises(NotImplementedError, match="bool data"):
        flox_tpu_torch.groupby_aggregate_many(bools, labels, funcs=("mean", "max"), device="cpu")


# ---------------------------------------------------------------------------
# fused equals sequential on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "funcs",
    FUNC_SETS + [("count", "nanmean", "nanstd", "nanmin", "nanmax"),
                 ("mean", "nanmean", "var", "nanvar")],
    ids="+".join,
)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_equals_sequential(funcs, dtype_name):
    data = _to_torch(_data(5), dtype_name)
    labels = _labels(5)
    out, groups = flox_tpu_torch.groupby_aggregate_many(data, labels, funcs=funcs, device="cpu")
    for f in funcs:
        seq, seq_groups = flox_tpu_torch.groupby_reduce(data, labels, func=f, device="cpu")
        assert out[f].dtype == seq.dtype, f
        np.testing.assert_array_equal(out[f].to(torch.float64).numpy(),
                                      seq.to(torch.float64).numpy(), err_msg=f)
        np.testing.assert_array_equal(groups, seq_groups)


def test_all_nan_group_per_statistic():
    vals = np.array([1.0, np.nan, np.nan, 4.0] * 4)
    labels = np.array([0, 1, 1, 0] * 4)
    funcs = ("nansum", "nanmean", "nanmin", "count")
    out, _ = flox_tpu_torch.groupby_aggregate_many(vals.astype(np.float32), labels, funcs=funcs,
                                                   device="cpu")
    assert out["nansum"][1].item() == 0.0
    assert np.isnan(out["nanmean"][1].item()) and np.isnan(out["nanmin"][1].item())
    assert out["count"].tolist() == [8, 0]


# ---------------------------------------------------------------------------
# the planner and the launches
# ---------------------------------------------------------------------------


def test_planner_shares_legs():
    fused = plan_fused(("mean", "var", "std"), None, torch.float64, None, 0, None)
    assert fused.chunk == (("var_chunk", {"skipna": False}),)
    assert fused.slots[0]["sum"] == (0, 1) and fused.slots[0]["count"] == (0, 2)
    fused = plan_fused(("sum", "mean", "count"), None, torch.float64, None, 0, None)
    names = [c[0] if isinstance(c, tuple) else c for c in fused.chunk]
    assert names.count("sum") == 1 and names.count("nanlen") == 1
    with pytest.raises(NotImplementedError, match="cannot fuse"):
        plan_fused(("mean", "argmax"), None, torch.float64, None, 0, None)
    with pytest.raises(ValueError, match="duplicate"):
        plan_fused(("mean", "mean"), None, torch.float64, None, 0, None)
    assert {"mean", "var", "min", "max", "count"} <= FUSABLE_FUNCS


def _count_calls(monkeypatch, *names):
    calls = {n: 0 for n in names}
    for n in names:
        real = getattr(ck, n)

        def wrapped(*a, _real=real, _n=n, **k):
            calls[_n] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ck, n, wrapped)
    return calls


@pytest.mark.parametrize(
    "funcs,want",
    [
        # segment_sum_raw is the segment-sum kernel's one entry: every
        # segment-sum pass, through segment_sum or directly, calls it once
        (("nanmean", "nanmin", "nanmax"),
         {"segment_multistat": 1, "segment_sum_raw": 0, "segment_minmax": 0}),
        # the climatology set: count/min/max ride one multi-statistic pass;
        # var_chunk's (total, count) is one segment-sum pass and its squared
        # deviations one more
        (("count", "nanmean", "nanstd", "nanmin", "nanmax"),
         {"segment_multistat": 1, "segment_sum_raw": 2, "segment_minmax": 0}),
        (("nanmean",), {"segment_multistat": 0, "segment_sum_raw": 1, "segment_minmax": 0}),
    ],
    ids=lambda v: "+".join(v) if isinstance(v, tuple) else "",
)
def test_kernel_calls_per_fused_call(monkeypatch, funcs, want):
    calls = _count_calls(monkeypatch, *want)
    data = _data(6, nan=0.05)
    flox_tpu_torch.groupby_aggregate_many(data, _labels(6), funcs=funcs, device="cpu")
    assert calls == want


def test_cpu_runs_launch_no_kernel():
    before = dict(ck.LAUNCHES)
    flox_tpu_torch.groupby_aggregate_many(_data(7), _labels(7), funcs=FUNC_SETS[0], device="cpu")
    assert ck.LAUNCHES == before


# ---------------------------------------------------------------------------
# the port's contract: devices, unported branches, imports
# ---------------------------------------------------------------------------


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flox_tpu_torch.groupby_aggregate_many(np.ones(4), np.zeros(4), funcs=("sum",))
    with pytest.raises(RuntimeError, match="CUDA"):
        flox_tpu_torch.groupby_scan(np.ones(4), np.zeros(4), func="cumsum")


@pytest.mark.parametrize(
    "kw,item",
    [({"method": "map-reduce"}, "A7"), ({"engine": "numpy"}, "A6")],
)
def test_unported_branches_name_roadmap_item(kw, item):
    # engine="numpy" is ported (A6): the reference's host-engine result; so is
    # method= (A7): the plan on the one-rank default mesh, against the
    # reference's on its default mesh
    ref, rgroups = flox_tpu.groupby_aggregate_many(np.ones(4), np.zeros(4), funcs=("sum",), **kw)
    got, pgroups = flox_tpu_torch.groupby_aggregate_many(np.ones(4), np.zeros(4), funcs=("sum",),
                                                         device="cpu", **kw)
    np.testing.assert_array_equal(got["sum"].numpy(), np.asarray(ref["sum"]))
    np.testing.assert_array_equal(pgroups, np.asarray(rgroups))


def test_autotune_option_names_roadmap_item():
    # the autotuner is ported: the reference's switch carries over
    assert from_reference({"autotune": True}) == {"autotune": True}
    assert from_reference({"autotune": False}) == {"autotune": False}


@pytest.mark.parametrize("funcs", [("nanmean", "nanmax"), ("count", "nanstd")],
                         ids=lambda f: "+".join(f))
@pytest.mark.parametrize("engine", ["torch", "sort"])
def test_dense_intermediate_ceiling(funcs, engine, monkeypatch):
    """Over ``dense_intermediate_bytes_max`` the fused path raises the
    reference's ValueError, with the reference's estimate, for either engine
    (the sort engine runs the dense fused path, as in the reference), and
    offers the reference's remedies, mesh= among them."""
    rng = np.random.default_rng(12)
    vals = rng.normal(size=(16, 512))
    labels = rng.integers(0, 300_000, 512)
    eg = np.arange(300_000)
    # the reference's ceiling goes into both option dicts it may read:
    # flox_tpu.fusion bound OPTIONS at import, while set_options and core read
    # flox_tpu.options.OPTIONS, which a reload of that module (one of the
    # reference's option tests does one) replaces with another dict
    for opts in (ref_fusion.OPTIONS, ref_options.OPTIONS):
        monkeypatch.setitem(opts, "dense_intermediate_bytes_max", 2**20)
    with pytest.raises(ValueError) as ref_err:
        flox_tpu.groupby_aggregate_many(vals, labels, funcs=funcs, expected_groups=eg,
                                        engine={"torch": "jax"}.get(engine, engine))
    with flox_tpu_torch.set_options(dense_intermediate_bytes_max=2**20):
        with pytest.raises(ValueError) as port_err:
            flox_tpu_torch.groupby_aggregate_many(vals, labels, funcs=funcs, expected_groups=eg,
                                                  engine=engine, device="cpu")
    assert "dense_intermediate_bytes_max" in str(port_err.value)
    port_msg, port_remedies = str(port_err.value).split(" Options: ")
    ref_msg, ref_remedies = str(ref_err.value).split(" Options: ")
    assert port_msg == ref_msg
    assert "mesh=" in ref_remedies and port_remedies == ref_remedies
    # under the ceiling the same call runs, and the sort engine is the dense path
    small = np.arange(600)
    got, _ = flox_tpu_torch.groupby_aggregate_many(vals, labels % 600, funcs=funcs,
                                                   expected_groups=small, engine=engine,
                                                   device="cpu")
    want, _ = flox_tpu_torch.groupby_aggregate_many(vals, labels % 600, funcs=funcs,
                                                    expected_groups=small, device="cpu")
    for f in funcs:
        assert torch.equal(got[f].isnan(), want[f].isnan())
        assert torch.equal(torch.nan_to_num(got[f]), torch.nan_to_num(want[f]))


def test_new_entry_points_import_no_jax_in_fresh_process():
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, flox_tpu_torch\n"
        "out, g = flox_tpu_torch.groupby_aggregate_many(np.arange(8.0), np.arange(8) % 2,"
        " funcs=('nanmean', 'nanmax'), device='cpu')\n"
        "assert out['nanmax'].tolist() == [6.0, 7.0], out\n"
        "s = flox_tpu_torch.groupby_scan(np.arange(4.0), np.array([0, 1, 0, 1]),"
        " func='cumsum', device='cpu')\n"
        "assert s.tolist() == [0.0, 1.0, 2.0, 4.0], s\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flox_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["flox_tpu_torch.fusion", "flox_tpu_torch.scan"])
def test_doctests(module):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module), verbose=False)
    assert results.attempted > 0
    assert results.failed == 0
