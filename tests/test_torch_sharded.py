"""The port's multi-device runtime (flox_tpu_torch.parallel) against flox_tpu's
mesh programs, on the CPU.

A world of 4 gloo ranks (``tests/torch_mesh_world.py``) is spawned once for
the module and runs every case of ``torch_mesh_world.CASE_IDS`` on every
rank: each rank passes the same global inputs and gets the whole result.
Each case is its own test here: the ranks' results must agree with each
other bit for bit (the result is replicated), and rank 0's with flox_tpu's
on ``make_mesh(4)`` (a (2, 2) ``("dcn", "ici")`` mesh for the ``mesh2``
cases) on the same inputs, in this process. Expected errors must be the
reference's type. The world has a deadline: a hung rank fails the module's
tests, it does not stall the run (``test_hung_rank_fails_within_deadline``).

In-process tests hold the one-rank default mesh (no ``torch.distributed``)
against the port's eager path.

Tolerances: integer, bool, count, extrema, first/last and positions
exactly; float64 ``rtol=1e-12, atol=1e-12``, the bar ``test_torch_core.py``
uses for float64 (both sides add in float64, their collectives in different
orders); datetimes exactly.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import flox_tpu
from flox_tpu.parallel import make_mesh as ref_make_mesh
import flox_tpu_torch

import torch_mesh_world as W

REPO = Path(__file__).resolve().parent.parent

EXACT_FUNCS = {"count", "min", "max", "nanmin", "nanmax", "first", "last", "nanfirst",
               "nanlast", "all", "any"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's outcome on every rank: ``[{case: outcome}, ...]``."""
    return W.run_world(W.CASE_IDS, str(tmp_path_factory.mktemp("mesh_world")))


_REF_MESHES: dict = {}


def _ref_mesh(kind):
    if kind not in _REF_MESHES:
        _REF_MESHES[kind] = (ref_make_mesh(W.NRANKS) if kind == "1d" else
                             ref_make_mesh(shape=(2, 2), axis_names=("dcn", "ici")))
    return _REF_MESHES[kind]


def _rms_ref():
    import jax.numpy as jnp

    from flox_tpu.kernels import generic_kernel

    def sq_sum(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        a = jnp.asarray(array)
        return generic_kernel("nansum", group_idx, a * a, size=size, fill_value=0.0)

    def cnt(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return generic_kernel("nanlen", group_idx, array, size=size)

    return flox_tpu.Aggregation(
        "rms", numpy=(sq_sum, cnt), chunk=(sq_sum, cnt),
        combine=(lambda s: s.sum(0), lambda s: s.sum(0)),
        finalize=lambda ss, n, **kw: (ss / n) ** 0.5,
        fill_value={"intermediate": (0.0, 0)}, final_fill_value=np.nan,
    )


def _ref_case(cid: str):
    """The case on flox_tpu: ``(result, *groups)`` as numpy."""
    from flox_tpu import rechunk
    from flox_tpu.aggregations import SCANS
    from flox_tpu.parallel import sharded_groupby_scan

    c = W.case(cid)
    kw = dict(c["kw"], mesh=_ref_mesh(c["mesh"]))
    args = c["args"]
    if cid == "many-cohorts":
        # the reference's cohorts program cannot gather a fused plan's tuple
        # of results (a TypeError in its moveaxis): its map-reduce program
        # computes the same statistics
        kw["method"] = "map-reduce"
    if c["special"] == "rms":
        kw["func"] = _rms_ref()
    elif c["special"] == "reshard":
        layout = rechunk.reshard_for_blockwise(args[1], W.NRANKS)
        args = (np.asarray(layout.apply(args[0])), layout.codes)
        kw["expected_groups"] = np.arange(7)
    elif c["special"] == "dtensor":
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        args = (jax.device_put(jnp.asarray(args[0]), NamedSharding(kw["mesh"], P("data"))),
                args[1])
    elif c["special"] == "scan_direct":
        scan = SCANS[kw.pop("func")]
        return (np.asarray(sharded_groupby_scan(args[0], args[1], scan, **kw)),)
    elif c["special"] in ("xr_reshard", "xr_cohorts"):
        from flox_tpu import xarray as rxr, xrlite

        da = xrlite.DataArray(args[0], dims=("x", "time"), coords={"label": ("time", args[1])})
        if c["special"] == "xr_cohorts":
            return (np.asarray(rxr.rechunk_for_cohorts(da, "time", args[1], [0], chunksize=20)),)
        out, codes, _groups = rxr.rechunk_for_blockwise(da, "time", args[1], n_shards=W.NRANKS)
        args = (np.asarray(out.data), codes)
    with flox_tpu.set_options(**({"dense_intermediate_bytes_max": c["ceiling"]}
                                 if c["ceiling"] else {})):
        out = getattr(flox_tpu, c["entry"])(*args, **kw)
    if not isinstance(out, tuple):
        out = (out,)
    return tuple({k: np.asarray(v) for k, v in o.items()} if isinstance(o, dict)
                 else np.asarray(o) for o in out)


def _same(a, b) -> bool:
    """Bit equality of two host results, NaN equal to NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind in "fc":
        return np.array_equal(a, b, equal_nan=True)
    if a.dtype.kind in "mM":
        return np.array_equal(a.view("int64"), b.view("int64"))
    return np.array_equal(a, b)


def _close(got, ref, exact: bool, what: str) -> None:
    if isinstance(ref, dict):
        assert tuple(got) == tuple(ref), what
        for k in ref:
            _close(got[k], ref[k], exact or k in EXACT_FUNCS, f"{what}[{k}]")
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.dtype.kind in "mM":
        np.testing.assert_array_equal(got.view("int64"), ref.view("int64"), err_msg=what)
    elif ref.dtype.kind in "fc" and not exact:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12, equal_nan=True,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("cid", W.CASE_IDS)
def test_world_matches_reference(world, cid):
    outcomes = [rank[cid] for rank in world]
    first = outcomes[0]
    for r, o in enumerate(outcomes[1:], start=1):
        assert o[0] == first[0], (cid, r, o, first)
        if first[0] == "ok":
            assert all(_same(a, b) for a, b in zip(o[1], first[1])), f"rank {r} differs"
        else:
            assert o[1] == first[1], (cid, r, o[1], first[1])
    try:
        ref = _ref_case(cid)
    except Exception as err:  # noqa: BLE001 - the port must raise the same type
        assert first[0] == "err", f"{cid}: the reference raised {err!r}, the port did not"
        assert first[1] == type(err).__name__, (first, err)
        return
    assert first[0] == "ok", f"{cid}: the port raised {first[1]}: {first[2]}"
    got = first[1]
    assert len(got) == len(ref), cid
    func = W.case(cid)["kw"].get("func")
    exact = isinstance(func, str) and (func in EXACT_FUNCS or "arg" in func)
    _close(got[0], ref[0], exact, cid)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=f"{cid} groups")


@pytest.mark.parametrize("cid", [c for c in W.CASE_IDS if c.startswith("blocked-")
                                 and "raises" not in c])
def test_blocked_program_ran(world, cid):
    """Above the lowered ceiling the additive reductions take the blocked
    owner-by-owner program (its debug line on every rank)."""
    for rank in world:
        assert any("blocked owner-by-owner" in line for line in rank[cid][2]), cid


def test_cohorts_order_stat_warns(world):
    for rank in world:
        assert any("no ownership win" in line for line in rank["orderstat-cohorts"][2])


@pytest.mark.parametrize("cid,match", [
    ("mesh2-bogus-axis", "no axes"),
    ("blocked-raises-peak", "even the blocked"),
    ("blocked-raises-non-additive", "dense_intermediate_bytes_max"),
    ("orderstat-mode-raises", "blockwise"),
])
def test_world_errors_name_their_cause(world, cid, match):
    for rank in world:
        assert rank[cid][0] == "err" and match in rank[cid][2], rank[cid]


def test_hung_rank_fails_within_deadline(tmp_path):
    """A rank that never reaches a collective fails the world at its
    deadline; every rank is terminated."""
    t0 = time.monotonic()
    with pytest.raises(W.WorldFailed, match="deadline"):
        W.run_world(["hang"], str(tmp_path), world=2, deadline_s=5.0, timeout_s=60.0,
                    hang_rank=1)
    assert time.monotonic() - t0 < 5.0 + 25.0


# ---------------------------------------------------------------------------
# the one-rank default mesh, in process, against the port's eager path
# ---------------------------------------------------------------------------

ONE_RANK_FUNCS = ["sum", "nansum", "mean", "nanmean", "var", "nanvar", "max", "nanmin",
                  "count", "argmax", "nanargmin", "first", "nanlast", "prod", "any",
                  "nanmedian", "quantile"]


@pytest.mark.parametrize("method", ["map-reduce", "cohorts", "blockwise"])
@pytest.mark.parametrize("func", ONE_RANK_FUNCS)
def test_one_rank_default_mesh_equals_eager(func, method):
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(3, 50))
    vals[:, rng.random(50) < 0.2] = np.nan
    labels = rng.integers(0, 6, 50)
    fkw = {"q": [0.2, 0.7]} if func == "quantile" else None
    eager, groups = flox_tpu_torch.groupby_reduce(vals, labels, func=func, device="cpu",
                                                  finalize_kwargs=fkw)
    if func in ("nanmedian", "quantile") and method == "cohorts":
        with pytest.warns(UserWarning, match="no ownership win"):
            got, g2 = flox_tpu_torch.groupby_reduce(vals, labels, func=func, device="cpu",
                                                    method=method, finalize_kwargs=fkw)
    else:
        got, g2 = flox_tpu_torch.groupby_reduce(vals, labels, func=func, device="cpu",
                                                method=method, finalize_kwargs=fkw)
    assert got.device.type == "cpu" and got.dtype == eager.dtype
    np.testing.assert_array_equal(g2, groups)
    np.testing.assert_array_equal(got.numpy(), eager.numpy())


@pytest.mark.parametrize("func", W.SCAN_FUNCS)
def test_one_rank_scan_equals_eager(func):
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(2, 40))
    vals[:, rng.random(40) < 0.2] = np.nan
    labels = rng.integers(0, 4, 40)
    eager = flox_tpu_torch.groupby_scan(vals, labels, func=func, device="cpu")
    got = flox_tpu_torch.groupby_scan(vals, labels, func=func, device="cpu", method="blelloch")
    np.testing.assert_array_equal(got.numpy(), eager.numpy())


def test_one_rank_aggregate_many_equals_eager():
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(3, 60))
    labels = rng.integers(0, 5, 60)
    funcs = ("count", "nanmean", "nanstd", "nanmin", "nanmax")
    eager, _ = flox_tpu_torch.groupby_aggregate_many(vals, labels, funcs=funcs, device="cpu")
    got, _ = flox_tpu_torch.groupby_aggregate_many(vals, labels, funcs=funcs, device="cpu",
                                                   method="map-reduce")
    for f in funcs:
        torch.testing.assert_close(got[f], eager[f], rtol=1e-12, atol=1e-12)


def test_default_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flox_tpu_torch.groupby_reduce(np.ones(4), np.zeros(4), func="sum", method="map-reduce")


def test_only_the_collective_layer_calls_torch_distributed():
    pkg = REPO / "flox_tpu_torch"
    calls = ("import torch.distributed", "from torch.distributed", "dist.")
    users = sorted(str(p.relative_to(REPO)) for p in pkg.rglob("*.py")
                   if any(c in p.read_text() for c in calls) and p.name != "mesh.py")
    assert users == [], users


def test_parallel_imports_no_jax_in_fresh_process():
    code = ("import sys\n"
            "pre = 'jax' in sys.modules  # an interpreter may import it at startup\n"
            "import flox_tpu_torch.parallel, flox_tpu_torch.cohorts, flox_tpu_torch.rechunk\n"
            "import flox_tpu_torch.visualize\n"
            "assert pre or 'jax' not in sys.modules\n"
            "assert 'flox_tpu' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


@pytest.mark.parametrize("method", ["map-reduce", "cohorts"])
def test_one_rank_prefactorized_equals_eager(method):
    """A prefactorized ``by`` on the mesh: its staged codes feed the program
    (cohorts reads the host codes)."""
    rng = np.random.default_rng(6)
    vals = rng.normal(size=(3, 50))
    labels = rng.integers(0, 6, 50)
    pf = flox_tpu_torch.prefactorize(labels, device="cpu")
    eager, groups = flox_tpu_torch.groupby_reduce(vals, pf, func="nanmean", device="cpu")
    got, g2 = flox_tpu_torch.groupby_reduce(vals, pf, func="nanmean", method=method,
                                            device="cpu")
    np.testing.assert_array_equal(g2, groups)
    np.testing.assert_array_equal(got.numpy(), eager.numpy())
    funcs = ("nanmean", "nanmax")
    eager_many, _ = flox_tpu_torch.groupby_aggregate_many(vals, pf, funcs=funcs, device="cpu")
    many, _ = flox_tpu_torch.groupby_aggregate_many(vals, pf, funcs=funcs, method=method,
                                                    device="cpu")
    for f in funcs:
        np.testing.assert_array_equal(many[f].numpy(), eager_many[f].numpy())
