"""The port's sparse inputs, ``reindex`` strategies and SPARSE_COO result leg
(flox_tpu_torch) against flox_tpu's, on the CPU.

The reference reduces a ``jax.experimental.sparse.BCOO``; the port the
``torch.sparse_coo_tensor`` of the same seeded numpy data (coalesced, or with
its stored values split into duplicate entries, which the port must coalesce
first). Reindexing compares the containers densely: the reference's BCOO or
HostCOO against the port's sparse tensor or HostCOO.

Tolerances: integer results and counts exactly; min/max exactly; float64
sums and means ``rtol=1e-12, atol=1e-14``; float32 ``rtol=1e-5, atol=1e-6``
(both sides add the stored values in different orders). Result dtypes are
compared exactly.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import sparse as jsparse

import flox_tpu
from flox_tpu import dtypes as rdtypes
from flox_tpu import reindex as rreindex

import flox_tpu_torch
from flox_tpu_torch import dtypes as pdtypes
from flox_tpu_torch import reindex as preindex
from flox_tpu_torch.reindex import HostCOO, ReindexArrayType, ReindexStrategy
from flox_tpu_torch.sparse import SPARSE_FUNCS, is_sparse_array, sparse_groupby_reduce

FUNCS = sorted(SPARSE_FUNCS)


def _case(kind: str, dtype: str):
    """(dense data, codes, size): 3 rows x 60 columns over 5 groups, group 4
    holding only implicit zeros, 60 % of the values zero."""
    rng = np.random.default_rng(21)
    n, size = 60, 5
    codes = rng.integers(0, 4, n).astype(np.int64)
    dense = np.round(rng.normal(size=(3, n)) * 10, 1)
    dense[rng.random((3, n)) < 0.6] = 0.0
    codes[-3:] = 4
    dense[:, -3:] = 0.0
    if kind == "nan" and dtype != "int32":
        dense[rng.random((3, n)) < 0.1] = np.nan
        dense[1, codes == 2] = np.nan  # a group of stored NaNs and implicit zeros
    if kind == "nan-labels":
        codes[rng.random(n) < 0.2] = -1
    if kind == "1d":
        dense = dense[0]
    return dense.astype(dtype), codes, size


def _port_sparse(dense: np.ndarray, duplicates: bool) -> torch.Tensor:
    t = torch.from_numpy(dense).to_sparse().coalesce()
    if not duplicates:
        return t
    # each stored value split into two entries at the same index (the halves
    # of an integer, or value and 0 for floats): uncoalesced
    idx, vals = t.indices(), t.values()
    first = vals // 2 if not vals.is_floating_point() else vals
    return torch.sparse_coo_tensor(torch.cat([idx, idx], 1), torch.cat([first, vals - first]),
                                   t.shape)


def _compare(got: torch.Tensor, ref, exact: bool):
    ref = np.asarray(ref)
    g = got.numpy()
    assert g.dtype == ref.dtype, (g.dtype, ref.dtype)
    if exact or ref.dtype.kind in "iub":
        np.testing.assert_array_equal(g, ref)
    elif ref.dtype == np.float32:
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
    else:
        np.testing.assert_allclose(g, ref, rtol=1e-12, atol=1e-14, equal_nan=True)


@pytest.mark.parametrize("kind", ["2d", "1d", "nan", "nan-labels"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
@pytest.mark.parametrize("func", FUNCS)
def test_sparse_matches_reference(func, dtype, kind):
    dense, codes, size = _case(kind, dtype)
    ref, rgroups = flox_tpu.groupby_reduce(jsparse.BCOO.fromdense(jnp.asarray(dense)), codes,
                                           func=func)
    got, pgroups = flox_tpu_torch.groupby_reduce(_port_sparse(dense, duplicates=False), codes,
                                                 func=func, device="cpu")
    np.testing.assert_array_equal(pgroups, np.asarray(rgroups))
    _compare(got, ref, exact="min" in func or "max" in func)


@pytest.mark.parametrize("func", FUNCS)
def test_sparse_uncoalesced_input(func):
    """Duplicate indices are summed by coalescing before anything is counted."""
    dense, codes, size = _case("2d", "int32")
    ref, _ = flox_tpu.groupby_reduce(jsparse.BCOO.fromdense(jnp.asarray(dense)), codes, func=func)
    got, _ = flox_tpu_torch.groupby_reduce(_port_sparse(dense, duplicates=True), codes,
                                           func=func, device="cpu")
    _compare(got, ref, exact=True)


def test_sparse_csr_input():
    dense, codes, _ = _case("nan", "float64")
    ref, _ = flox_tpu.groupby_reduce(jsparse.BCOO.fromdense(jnp.asarray(dense)), codes,
                                     func="nanmean")
    csr = torch.from_numpy(dense).to_sparse_csr()
    assert is_sparse_array(csr)
    got, _ = flox_tpu_torch.groupby_reduce(csr, codes, func="nanmean", device="cpu")
    _compare(got, ref, exact=False)


@pytest.mark.parametrize("kw", [
    {"func": "sum", "expected_groups": np.array([0, 1, 2])},
    {"func": "sum", "expected_groups": np.array([0, 1, 2]), "fill_value": -999.0},
    {"func": "min", "expected_groups": np.array([0, 1, 2])},
    {"func": "nanmax", "fill_value": 7.0},
    {"func": "mean", "dtype": np.float32},
], ids=["expected", "sum-fill", "int-min-promotes", "nanmax-fill", "dtype"])
@pytest.mark.parametrize("dtype", ["float64", "int32"])
def test_sparse_fills_and_options(kw, dtype):
    dense = np.array([3, 0, 5, 0], dtype=dtype)
    codes = np.array([0, 0, 2, 2])
    ref, rgroups = flox_tpu.groupby_reduce(jsparse.BCOO.fromdense(jnp.asarray(dense)), codes,
                                           **kw)
    got, pgroups = flox_tpu_torch.groupby_reduce(torch.from_numpy(dense).to_sparse(), codes,
                                                 device="cpu", **kw)
    np.testing.assert_array_equal(pgroups, np.asarray(rgroups))
    _compare(got, ref, exact=True)


@pytest.mark.parametrize("kw,err,match", [
    ({"func": "var"}, NotImplementedError, "sparse grouped"),
    ({"func": "nansum", "min_count": 2}, NotImplementedError, "min_count"),
    ({"func": "nansum", "axis": -1}, NotImplementedError, "axis"),
    ({"func": "nansum", "finalize_kwargs": {"ddof": 1}}, NotImplementedError, "finalize"),
    ({"func": "nansum", "reindex": ReindexStrategy(array_type=ReindexArrayType.SPARSE_COO)},
     NotImplementedError, "SPARSE_COO"),
    ({"func": "nansum", "method": "map-reduce"}, NotImplementedError, "A7"),
])
def test_sparse_refusals(kw, err, match):
    mat = torch.ones(4).to_sparse()
    with pytest.raises(err, match=match):
        flox_tpu_torch.groupby_reduce(mat, np.array([0, 0, 1, 1]), device="cpu", **kw)


def test_sparse_not_fusable():
    with pytest.raises(NotImplementedError, match="not fusable"):
        flox_tpu_torch.groupby_aggregate_many(torch.ones(4).to_sparse(), np.array([0, 0, 1, 1]),
                                              funcs=("sum", "max"), device="cpu")


def test_sparse_reducer_direct_on_device_of_input():
    mat = torch.tensor([[1.0, 0.0, 2.0, 0.0]]).to_sparse()
    out = sparse_groupby_reduce(mat, np.array([0, 0, 1, 1]), func="nanmax", size=2)
    assert out.device.type == "cpu" and out.tolist() == [[1.0, 2.0]]


# ---------------------------------------------------------------------------
# reindex_ and the sparse containers
# ---------------------------------------------------------------------------


def _dense(container):
    if isinstance(container, torch.Tensor):
        return container.to_dense().numpy()
    if isinstance(container, jsparse.BCOO):
        return np.asarray(container.todense())
    return container.todense()


@pytest.mark.parametrize("fill", [0.0, np.nan, 5.0, "NA", "INF", None],
                         ids=["zero", "nan", "five", "NA", "INF", "none"])
@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_reindex_sparse_coo_matches_reference(fill, dtype):
    vals = np.array([[1, 2, 3], [4, 5, 6]], dtype=dtype)
    found, target = [10, 3, 250], np.arange(300)
    rfill = {"NA": rdtypes.NA, "INF": rdtypes.INF}.get(fill, fill)
    pfill = {"NA": pdtypes.NA, "INF": pdtypes.INF}.get(fill, fill)
    if fill is None:
        with pytest.raises(ValueError, match="fill_value"):
            preindex.reindex_sparse_coo(vals, found, target, fill_value=None, device="cpu")
        return
    ref = rreindex.reindex_sparse_coo(vals, pd.Index(found), pd.RangeIndex(300),
                                      fill_value=rfill)
    got = preindex.reindex_sparse_coo(vals, found, target, fill_value=pfill, device="cpu")
    assert isinstance(got, torch.Tensor) == isinstance(ref, jsparse.BCOO)
    assert isinstance(got, HostCOO) == isinstance(ref, rreindex.HostCOO)
    r, g = _dense(ref), _dense(got)
    assert g.dtype == r.dtype and g.shape == r.shape
    np.testing.assert_array_equal(g, r)


def test_reindex_sparse_coo_reorder_only():
    ref = rreindex.reindex_sparse_coo(np.array([1.0, 2.0, 3.0]), pd.Index([2, 0, 1]),
                                      pd.Index([0, 1, 2]), fill_value=None)
    got = preindex.reindex_sparse_coo(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64),
                                      [2, 0, 1], [0, 1, 2], fill_value=None)
    assert got.layout == torch.sparse_coo and got.device.type == "cpu"
    np.testing.assert_array_equal(_dense(got), _dense(ref))


@pytest.mark.parametrize("array_kind", ["numpy", "tensor"])
@pytest.mark.parametrize("fill", [None, "NA", "INF", -1.5])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_reindex_dense_matches_reference(array_kind, fill, dtype):
    vals = np.arange(12, dtype=dtype).reshape(3, 4)
    from_, to = np.array([5, 1, 7, 3]), np.array([1, 2, 3, 5, 9])
    rfill = {"NA": rdtypes.NA, "INF": rdtypes.INF}.get(fill, fill)
    pfill = {"NA": pdtypes.NA, "INF": pdtypes.INF}.get(fill, fill)
    ref = rreindex.reindex_(vals, pd.Index(from_), pd.Index(to), fill_value=rfill)
    arr = torch.from_numpy(vals) if array_kind == "tensor" else vals
    got = preindex.reindex_(arr, from_, to, fill_value=pfill)
    g = got.numpy() if array_kind == "tensor" else got
    assert g.dtype == ref.dtype
    np.testing.assert_array_equal(g, ref)


@pytest.mark.parametrize("index,target", [
    (np.array([3.0, np.nan, 1.0]), np.array([np.nan, 1.0, 2.0, 3.0])),
    (np.array(["b", "a", None], dtype=object), np.array(["a", None, "c"], dtype=object)),
    (np.array(["2001-01-02", "2001-01-01"], dtype="datetime64[ns]"),
     np.array(["2001-01-01", "NaT", "2001-01-03"], dtype="datetime64[ns]")),
], ids=["float-nan", "object", "datetime"])
def test_get_indexer_matches_pandas(index, target):
    np.testing.assert_array_equal(preindex.get_indexer(index, target),
                                  pd.Index(index).get_indexer(target))


def test_strategy_validation():
    s = ReindexStrategy(blockwise=False, array_type=ReindexArrayType.SPARSE_COO)
    assert s.array_type is ReindexArrayType.SPARSE_COO
    with pytest.raises(ValueError, match="blockwise=True"):
        ReindexStrategy(blockwise=True, array_type=ReindexArrayType.SPARSE_COO)
    assert ReindexStrategy().set_blockwise_for_numpy().blockwise is True


# ---------------------------------------------------------------------------
# groupby_reduce(reindex=...)
# ---------------------------------------------------------------------------

SPARSE_COO = ReindexStrategy(array_type=ReindexArrayType.SPARSE_COO)


def _reindex_case():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(3, 40))
    labels = rng.choice(np.array([2, 7, 30]), 40)
    return data, labels, np.arange(50)


@pytest.mark.parametrize("engine", ["torch", "sort"])
@pytest.mark.parametrize("func", ["sum", "nansum", "count", "nanmean", "max", "nanmin"])
def test_sparse_coo_result_leg(func, engine):
    data, labels, universe = _reindex_case()
    ref_engine = "jax" if engine == "torch" else "sort"
    ref, rgroups = flox_tpu.groupby_reduce(data, labels, func=func, expected_groups=universe,
                                           engine=ref_engine, reindex=SPARSE_COO_REF)
    got, pgroups = flox_tpu_torch.groupby_reduce(data, labels, func=func,
                                                 expected_groups=universe, engine=engine,
                                                 reindex=SPARSE_COO, device="cpu")
    np.testing.assert_array_equal(pgroups, np.asarray(rgroups))
    assert isinstance(got, HostCOO) == isinstance(ref, rreindex.HostCOO)
    r, g = _dense(ref), _dense(got)
    assert g.dtype == r.dtype
    np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-14, equal_nan=True)


SPARSE_COO_REF = rreindex.ReindexStrategy(array_type=rreindex.ReindexArrayType.SPARSE_COO)


@pytest.mark.parametrize("reindex", [
    None, True, False, ReindexStrategy(), ReindexStrategy(blockwise=False),
    ReindexStrategy(array_type=ReindexArrayType.NUMPY),
], ids=["none", "true", "false", "default", "blockwise-false", "numpy"])
def test_dense_strategies_are_the_dense_result(reindex):
    data, labels, universe = _reindex_case()
    want, _ = flox_tpu_torch.groupby_reduce(data, labels, func="nanmean",
                                            expected_groups=universe, device="cpu")
    got, _ = flox_tpu_torch.groupby_reduce(data, labels, func="nanmean",
                                           expected_groups=universe, reindex=reindex,
                                           device="cpu")
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("kw,err", [
    ({"func": "first", "reindex": SPARSE_COO}, ValueError),
    ({"func": "nanvar", "reindex": SPARSE_COO}, ValueError),
    ({"func": "sum", "reindex": "blockwise"}, TypeError),
])
def test_reindex_refusals_match_reference(kw, err):
    rkw = dict(kw, reindex=SPARSE_COO_REF if kw["reindex"] is SPARSE_COO else kw["reindex"])
    with pytest.raises(err):
        flox_tpu.groupby_reduce(np.ones(4), np.zeros(4), engine="jax", **rkw)
    with pytest.raises(err):
        flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), device="cpu", **kw)


def test_sparse_coo_leg_two_groupers_refused():
    with pytest.raises(NotImplementedError, match="single `by`"):
        flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), np.zeros(4), func="sum",
                                      reindex=SPARSE_COO, device="cpu")
