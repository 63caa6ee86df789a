"""The port's eager ``groupby_reduce`` (flox_tpu_torch) against flox_tpu's, on
the CPU.

The reference runs with ``engine="jax"`` under
``set_options(segment_sum_impl="pallas", segment_minmax_impl="pallas")``, so
the segment reductions that reach a kernel on the card reach the Pallas
kernels here, in interpret mode. The port runs with ``device="cpu"`` under the
same option set carried across (``options.from_reference``), where its kernel
wrappers run their plain versions. Inputs are numpy arrays made from a seed.

Tolerances:
* integer results, counts and min/max: exact;
* float32: ``rtol=1e-5, atol=1e-6``, the reference's own bar for its Pallas
  path against scatter (tests/test_kernels.py, ``TestPallasPath``): the two
  sides add in different orders;
* float64 (the scatter route on both sides): ``rtol=1e-12``, the reference's
  scatter-vs-scatter bar;
* bfloat16: within one bfloat16 ulp, compared in float32. Both sides
  accumulate in float32 and round once to bfloat16 at the end, so float32
  values that differ in their last bits may round one bf16 ulp apart.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flox_tpu
from flox_tpu import options as ref_options
import flox_tpu_torch
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import factorize as pfct
from flox_tpu_torch.options import from_reference
from flox_tpu_torch.types import Bins

REPO = Path(__file__).resolve().parent.parent
PALLAS = dict(segment_sum_impl="pallas", segment_minmax_impl="pallas")
FUNCS = ["sum", "nansum", "mean", "nanmean", "var", "nanvar", "std", "nanstd",
         "count", "min", "max", "nanmin", "nanmax"]
EXACT_FUNCS = {"count", "min", "max", "nanmin", "nanmax"}


def _both(data, *by, dtype_name="float32", **kw):
    """Run the reference and the port on the same inputs; return both
    results (the port's as a tensor) and both group tuples."""
    import jax.numpy as jnp

    ref_in = jnp.asarray(data).astype(jnp.bfloat16) if dtype_name == "bfloat16" else data
    with flox_tpu.set_options(**PALLAS):
        ref, *rgroups = flox_tpu.groupby_reduce(ref_in, *by, engine="jax", **kw)
        port_opts = from_reference(dict(ref_options.OPTIONS))
    port_in = torch.from_numpy(np.ascontiguousarray(data))
    if dtype_name == "bfloat16":
        port_in = port_in.to(torch.bfloat16)
    with flox_tpu_torch.set_options(**port_opts):
        got, *pgroups = flox_tpu_torch.groupby_reduce(port_in, *by, device="cpu", **kw)
    return got, np.asarray(ref), pgroups, rgroups


def _dtype_name(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype).removeprefix("torch.")


def _check(got: torch.Tensor, ref: np.ndarray, *, exact: bool = False):
    assert got.device.type == "cpu"
    assert _dtype_name(got) == ref.dtype.name, (got.dtype, ref.dtype)
    assert tuple(got.shape) == ref.shape
    if not got.is_floating_point():
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    g = got.to(torch.float64).numpy()
    r = ref.astype(np.float64)
    if exact:
        np.testing.assert_array_equal(g, r)
    elif got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        ok = ~np.isnan(g)
        big = np.maximum(np.abs(g[ok]), np.abs(r[ok]))
        ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
        with np.errstate(invalid="ignore"):  # inf - inf where both are inf
            assert np.all((g[ok] == r[ok]) | (np.abs(g[ok] - r[ok]) <= ulp))
    elif got.dtype == torch.float64:
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-14, equal_nan=True)
    else:
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True)


def _data(seed, shape=(4, 96), nan=0.1, inf=True):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(np.float32)
    data[rng.random(shape) < nan] = np.nan
    if inf:
        data.reshape(-1, shape[-1])[0, 5] = np.inf
        data.reshape(-1, shape[-1])[-1, 7] = -np.inf
    return data


def _labels(seed, n=96):
    """Float labels 0..4 with label 3 absent and some NaN (missing) labels."""
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, 5, n).astype(np.float64)
    labels[labels == 3] = 0
    labels[rng.random(n) < 0.08] = np.nan
    return labels


EXPECTED = np.arange(6.0)  # 3 and 5 never occur: two empty groups


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("func", FUNCS)
def test_func_sweep(func, dtype_name):
    data = _data(0)
    if dtype_name == "float64":
        data = data.astype(np.float64)
    got, ref, pg, rg = _both(data, _labels(0), func=func, dtype_name=dtype_name,
                             expected_groups=EXPECTED)
    _check(got, ref, exact=func in EXACT_FUNCS)
    np.testing.assert_array_equal(pg[0], rg[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(3, 0), (0,)], ids=str)
@pytest.mark.parametrize("func", ["sum", "nanmean", "max", "count"])
def test_zero_length_axis(func, shape, dtype):
    """A reduced axis of length 0 (ROADMAP C1): every group is empty, and the
    port gives the reference's result exactly, in shape and dtype (zeros for
    sum and count, NaN for nanmean and max)."""
    got, ref, pg, rg = _both(np.zeros(shape, dtype), np.zeros(0, int), func=func,
                             expected_groups=np.arange(6))
    assert tuple(got.shape) == shape[:-1] + (6,)
    _check(got, ref, exact=True)
    np.testing.assert_array_equal(pg[0], rg[0])


@pytest.mark.parametrize("func", ["sum", "nansum", "mean", "count", "min", "max", "nanmin",
                                  "nanmax"])
def test_int32_exact(func):
    rng = np.random.default_rng(3)
    data = rng.integers(-50, 50, size=(3, 80)).astype(np.int32)
    got, ref, _, _ = _both(data, _labels(3, 80), func=func, expected_groups=EXPECTED)
    _check(got, ref, exact=True)


@pytest.mark.parametrize(
    "func,kw",
    [
        ("sum", {"min_count": 18}),
        ("nansum", {"fill_value": np.nan}),
        ("nanmax", {"min_count": 18}),
        ("max", {"fill_value": -1.0}),
        ("count", {"fill_value": -1}),
        ("mean", {"fill_value": 0.0}),
        ("nanvar", {"fill_value": 7.0, "finalize_kwargs": {"ddof": 1}}),
        ("std", {"finalize_kwargs": {"ddof": 1}}),
        ("sum", {"dtype": np.float64}),
    ],
)
def test_fill_value_min_count_dtype(func, kw):
    got, ref, _, _ = _both(_data(1), _labels(1), func=func, expected_groups=EXPECTED, **kw)
    _check(got, ref, exact=func in EXACT_FUNCS)


@pytest.mark.parametrize("func", ["nanmean", "max", "count"])
def test_discovered_groups_and_unsorted(func):
    labels = _labels(2)
    got, ref, pg, rg = _both(_data(2), labels, func=func)
    _check(got, ref, exact=func in EXACT_FUNCS)
    np.testing.assert_array_equal(pg[0], rg[0])
    expected = np.array([4.0, 0.0, 2.0, 5.0])
    got, ref, pg, rg = _both(_data(2), labels, func=func, expected_groups=expected, sort=False)
    _check(got, ref, exact=func in EXACT_FUNCS)
    np.testing.assert_array_equal(pg[0], rg[0])


@pytest.mark.parametrize("func", ["nanmean", "nanmax", "var"])
def test_two_bys(func):
    rng = np.random.default_rng(4)
    by1 = rng.integers(0, 3, 96)
    by2 = rng.integers(0, 4, 96)
    got, ref, pg, rg = _both(_data(4), by1, by2, func=func,
                             expected_groups=(np.arange(3), np.arange(4)))
    assert tuple(got.shape) == (4, 3, 4)
    _check(got, ref, exact=func in EXACT_FUNCS)
    for p, r in zip(pg, rg):
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("axis", [-1, (1, 2), 1])
@pytest.mark.parametrize("func", ["nansum", "nanmean", "min"])
def test_partial_axis(func, axis):
    data = _data(5, shape=(2, 3, 40))
    rng = np.random.default_rng(5)
    by = rng.integers(0, 4, size=(3, 40))
    got, ref, _, _ = _both(data, by, func=func, axis=axis, expected_groups=np.arange(4))
    _check(got, ref, exact=func in EXACT_FUNCS)


def test_bins():
    rng = np.random.default_rng(6)
    values = rng.random(96)
    edges = np.array([0.0, 0.25, 0.5, 1.0])
    got, ref, pg, rg = _both(_data(6), values, func="nanmean", expected_groups=edges, isbin=True)
    _check(got, ref)
    np.testing.assert_array_equal(pg[0]["left"], np.asarray(rg[0].left))
    np.testing.assert_array_equal(pg[0]["right"], np.asarray(rg[0].right))


@pytest.mark.parametrize("func", ["sum", "count"])
def test_bool_data(func):
    rng = np.random.default_rng(7)
    data = rng.random((2, 50)) < 0.5
    got, ref, _, _ = _both(data, rng.integers(0, 3, 50), func=func)
    _check(got, ref, exact=True)


# ---------------------------------------------------------------------------
# factorize against the reference's (numpy in place of pandas)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize(
    "labels",
    [
        np.array([3.0, np.nan, 1.0, 3.0, 2.0, np.nan, 1.0]),
        np.array(["b", "a", "c", "a", "b"]),
        np.array([5, 2, 2, 9, 5, 0]),
        np.array(["2020-01-02", "NaT", "2020-01-01", "2020-01-02"], dtype="datetime64[ns]"),
    ],
)
def test_factorize_matches_reference(labels, sort):
    from flox_tpu import factorize as rfct

    got = pfct.factorize_((labels,), axes=(0,), sort=sort)
    want = rfct.factorize_((labels,), axes=(0,), sort=sort)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], np.asarray(want[1][0]))
    assert got[2:5] == want[2:5]


@pytest.mark.parametrize("closed", ["right", "left"])
def test_binning_matches_pd_cut(closed):
    import pandas as pd

    from flox_tpu import factorize as rfct

    values = np.array([0.0, 0.1, 0.25, 0.3, 0.5, 0.99, 1.0, 1.5, np.nan, -0.2])
    edges = np.array([0.0, 0.25, 0.5, 1.0])
    got, _ = pfct.factorize_single(values, Bins(edges, closed=closed))
    want, _ = rfct.factorize_single(
        values, pd.IntervalIndex.from_breaks(edges, closed=closed)
    )
    np.testing.assert_array_equal(got, want)


def test_factorize_expected_and_multi_by():
    from flox_tpu import factorize as rfct

    by1 = np.array([[0, 1, 2, 7], [1, 1, 0, 2]])
    by2 = np.array([[1, 0, 0, 1], [1, 1, 0, 0]])
    exp = (np.array([0, 1, 2]), np.array([0, 1]))
    got = pfct.factorize_((by1, by2), axes=(1,), expected_groups=exp)
    want = rfct.factorize_((by1, by2), axes=(1,), expected_groups=exp)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2:5] == want[2:5]
    assert got[5].offset_group and want[5].offset_group


# ---------------------------------------------------------------------------
# routing: the main path goes through the segment-sum kernel's wrapper once
# ---------------------------------------------------------------------------


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(ck, name)

    def wrapped(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(ck, name, wrapped)
    return calls


def test_nanmean_is_one_fused_kernel_pass(monkeypatch):
    raw = _count_calls(monkeypatch, "segment_sum_raw")
    data = _data(8, nan=0.05)
    flox_tpu_torch.groupby_reduce(data, _labels(8), func="nanmean", device="cpu")
    assert raw == [torch.float32]


@pytest.mark.parametrize(
    "opts,dtype,size,calls",
    [
        ({}, np.float32, 12, 1),
        ({"segment_sum_impl": "scatter"}, np.float32, 12, 0),
        ({}, np.float64, 12, 0),
        ({}, np.float32, 600, 0),  # past pallas_num_groups_max: the radix-binning kernel
        ({"pallas_num_groups_max": 8}, np.float32, 12, 0),
    ],
)
def test_sum_routing(monkeypatch, opts, dtype, size, calls):
    seen = _count_calls(monkeypatch, "segment_sum")
    rng = np.random.default_rng(9)
    data = rng.normal(size=(2, 700)).astype(dtype)
    labels = rng.integers(0, size, 700)
    with flox_tpu_torch.set_options(**opts):
        out, _ = flox_tpu_torch.groupby_reduce(data, labels, func="sum", device="cpu",
                                               expected_groups=np.arange(size))
    assert len(seen) == calls
    want = np.zeros((2, size))
    for g in range(size):
        want[:, g] = data[:, labels == g].astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "dtype,size,calls", [(np.float32, 12, 1), (np.int32, 12, 1), (np.float64, 12, 0),
                         (np.float32, 200, 0)],
)
def test_minmax_routing(monkeypatch, dtype, size, calls):
    seen = _count_calls(monkeypatch, "segment_minmax")
    rng = np.random.default_rng(10)
    data = (rng.normal(size=(2, 300)) * 100).astype(dtype)
    labels = rng.integers(0, size, 300)
    flox_tpu_torch.groupby_reduce(data, labels, func="nanmax", device="cpu",
                                  expected_groups=np.arange(size))
    assert len(seen) == calls


def test_cpu_runs_launch_no_kernel():
    before = dict(ck.LAUNCHES)
    flox_tpu_torch.groupby_reduce(_data(11), _labels(11), func="nanmean", device="cpu")
    assert ck.LAUNCHES == before


# ---------------------------------------------------------------------------
# the port's own contract: devices, unported branches, imports
# ---------------------------------------------------------------------------


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), func="sum")
    with pytest.raises(RuntimeError, match="CUDA"):
        flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), func="sum", device="cuda")


def test_result_is_tensor_on_device_and_groups_numpy():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out, groups = flox_tpu_torch.groupby_reduce(t, np.array([1, 0, 1]), func="sum", device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert isinstance(groups, np.ndarray)
    assert out.tolist() == [[1.0, 2.0], [4.0, 8.0]]


@pytest.mark.parametrize(
    "kw,item",
    [
        # A2 (median) is ported: it reduces now (test_a2_median_reduces). A6 is
        # ported: engine="numpy" reduces on the host engine, and a string
        # reindex raises the reference's own error (a TypeError). A7 is
        # ported: method= runs the one-rank default mesh (the reference's
        # runs its default mesh of every device)
        pytest.param({"func": "sum", "engine": "numpy"}, "A6", id="kw1-A6"),
        pytest.param({"func": "sum", "engine": "sort", "reindex": "blockwise"}, "A6",
                     id="kw2-A6"),
        pytest.param({"func": "sum", "method": "map-reduce"}, "A7", id="kw3-A7"),
    ],
)
def test_unported_branches_name_roadmap_item(kw, item):
    # every branch is ported: the reference's result, or the reference's error
    try:
        ref, rgroups = flox_tpu.groupby_reduce(np.ones(4), np.zeros(4), **kw)
    except Exception as err:  # noqa: BLE001 - the port must raise the same type
        with pytest.raises(type(err)):
            flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), device="cpu", **kw)
        return
    got, pgroups = flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(pgroups, np.asarray(rgroups))


def test_a2_median_reduces():
    """The call that raised naming A2 before the reduction family was ported."""
    out, groups = flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), func="median",
                                                device="cpu")
    assert out.tolist() == [1.0] and groups.tolist() == [0.0]


def test_from_reference_maps_option_names():
    opts = from_reference({"segment_sum_impl": "pallas", "segment_minmax_impl": "scatter",
                           "pallas_accum": "dd", "default_engine": "jax"})
    assert opts == {"segment_sum_impl": "kernel", "segment_minmax_impl": "scatter",
                    "pallas_accum": "dd", "default_engine": "torch"}
    assert from_reference({"segment_sum_impl": "radixbin"}) == {"segment_sum_impl": "radixbin"}
    # the host numpy engine is ported (A6): the option carries across
    assert from_reference({"default_engine": "numpy"}) == {"default_engine": "numpy"}


def _port_sources():
    return sorted((REPO / "flox_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _port_sources(),
    ids=lambda p: p.relative_to(REPO).as_posix().removeprefix("flox_tpu_torch/"))
def test_port_imports_no_jax_no_reference_no_toplevel_pandas(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flox_tpu"), (path, name)
            if root == "pandas":
                assert node not in tree.body, f"{path}: module-level pandas import"


def test_import_in_fresh_process_without_pandas():
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, flox_tpu_torch\n"
        "out, g = flox_tpu_torch.groupby_reduce(np.arange(4.0), np.array([0, 1, 0, 1]),"
        " func='nanmean', device='cpu')\n"
        "assert out.tolist() == [1.0, 2.0], out\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flox_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["flox_tpu_torch", "flox_tpu_torch.core",
                                    "flox_tpu_torch.options"])
def test_doctests(module):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module), verbose=False)
    assert results.attempted > 0
    assert results.failed == 0
