"""The port's streamed mesh runtime (``mesh=`` on the three
``streaming_groupby_*`` entry points) against flox_tpu's, on the CPU.

A world of 4 gloo ranks (``tests/torch_mesh_world.py``) is spawned once for
the module and runs every case of ``torch_mesh_world.STREAM_CASE_IDS`` on
every rank: the reference's ``TestMeshStreaming``, ``TestMeshStreamingBlocked``,
``TestMeshStreamingScan`` and mesh order-statistic cases
(tests/test_streaming.py) and the mesh cases of tests/test_resilience.py, on
the same inputs. The ranks' results must agree with each other bit for bit
(every rank gets the whole result), and rank 0's with flox_tpu's streamed
call on a 4-device mesh (``make_mesh(4)``; a (2, 2) ``("dcn", "ici")`` mesh for
the two-axis case) in this process, at the reference test's own bar:

* integers, counts, extrema, positions and datetimes exactly;
* float64 reductions ``rtol=1e-12`` (TestMeshStreaming), the blocked
  variance ``rtol=1e-9`` (TestMeshStreamingBlocked), scans ``rtol=1e-10,
  atol=1e-12`` (TestMeshStreamingScan);
* interpolated quantiles 2 ulp of their dtype (``rtol=5e-16`` in float64,
  the reference's bar; ``2**-22`` in float32): the reference's compiler
  fuses the interpolation into one multiply-add (ROADMAP, Queue C).

In-process tests hold a one-rank mesh (no ``torch.distributed``, so no NCCL)
against the single-device stream bit for bit. The checkpoint tests spawn
fresh worlds that resume from the spilled snapshots; the world has a
deadline, and a rank that raises before the final combine fails the world
within it.
"""

import time

import numpy as np
import pytest

import jax  # noqa: F401 - tests/conftest.py configures it; the reference needs it

import flox_tpu
import flox_tpu.streaming as ref_streaming
from flox_tpu.parallel import make_mesh as ref_make_mesh
import flox_tpu_torch
from flox_tpu_torch.parallel import make_mesh
from flox_tpu_torch.parallel.mesh import shard_bounds

import torch_mesh_world as W

EXACT_FUNCS = {"count", "min", "max", "nanmin", "nanmax", "first", "last", "nanfirst",
               "nanlast", "all", "any"}
QUANTILE_CASES = {"stream-median-nan", "stream-quantile-2axis", "stream-nanmedian",
                  "stream-nanquantile", "stream-kill-quantile", "stream-tail-nanmedian"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every streamed case's outcome on every rank: ``[{case: outcome}, ...]``."""
    return W.run_world(W.STREAM_CASE_IDS, str(tmp_path_factory.mktemp("stream_world")))


_REF_MESHES: dict = {}


def _ref_mesh(kind):
    if kind not in _REF_MESHES:
        _REF_MESHES[kind] = (ref_make_mesh(W.NRANKS) if kind == "1d" else
                             ref_make_mesh(shape=(2, 2), axis_names=("dcn", "ici")))
    return _REF_MESHES[kind]


def _rms_ref():
    import jax.numpy as jnp

    from flox_tpu.kernels import generic_kernel

    def sq(gi, a, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return generic_kernel("nansum", gi, jnp.asarray(a) ** 2, size=size, fill_value=0.0)

    def ct(gi, a, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return generic_kernel("nanlen", gi, a, size=size)

    return flox_tpu.Aggregation(
        "rms", numpy=(sq, ct), chunk=(sq, ct),
        combine=(lambda s: s.sum(0), lambda s: s.sum(0)),
        finalize=lambda ss, nn, **kw: (ss / nn) ** 0.5,
        fill_value={"intermediate": (0.0, 0)}, final_fill_value=np.nan,
    )


def _ref_case(cid: str):
    """The case on flox_tpu's streamed mesh runtime (uninterrupted): the
    result and its groups as numpy."""
    c = W.stream_case(cid)
    kw = dict(c["kw"], mesh=_ref_mesh(c["mesh"]))
    args = c["args"]
    fn = getattr(ref_streaming, c["entry"])
    if c["special"] == "rms":
        kw["func"] = _rms_ref()
    elif c["special"] == "dense":
        kw["engine"] = "jax"
    with flox_tpu.set_options(**({"dense_intermediate_bytes_max": c["ceiling"]}
                                 if c["ceiling"] else {})):
        if c["special"] == "writer":
            buf = np.empty(args[0].shape, np.int64)
            assert fn(*args, out=lambda s, e, res: buf.__setitem__((..., slice(s, e)), res),
                      **kw) is None
            return (buf,)
        out = fn(*args, **kw)
    if not isinstance(out, tuple):
        out = (out,)
    return tuple({k: np.asarray(v) for k, v in o.items()} if isinstance(o, dict)
                 else np.asarray(o) for o in out)


def _same(a, b) -> bool:
    """Bit equality of two host results, any NaN equal to any NaN (the mesh
    combine re-injects NaN where a rank's extreme was NaN)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind in "fc":
        nan = np.isnan(a)
        return bool((nan == np.isnan(b)).all()) and a[~nan].tobytes() == b[~nan].tobytes()
    return a.tobytes() == b.tobytes()


def _bar(cid: str, func, ref) -> dict | None:
    """The reference test's tolerance for the case; None: exact."""
    if ref.dtype.kind not in "fc":
        return None
    if isinstance(func, str) and (func in EXACT_FUNCS or "arg" in func):
        return None
    if cid in QUANTILE_CASES:
        ulp = np.finfo(ref.dtype).eps
        return dict(rtol=float(2.25 * ulp) if ref.dtype == np.float64 else float(2 * ulp),
                    atol=0)
    if cid.startswith("stream-scan") or cid in ("stream-kill-scan", "stream-tail-nancumsum"):
        return dict(rtol=1e-10, atol=1e-12)
    if cid in ("stream-blocked-nanvar", "stream-blocked-dense-nanvar"):
        return dict(rtol=1e-9, atol=0)
    return dict(rtol=1e-12, atol=0)


def _close(got, ref, cid, func, what) -> None:
    if isinstance(ref, dict):
        assert tuple(got) == tuple(ref), what
        for k in ref:
            _close(got[k], ref[k], cid, k, f"{what}[{k}]")
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.dtype.kind in "mM":
        np.testing.assert_array_equal(got.view("int64"), ref.view("int64"), err_msg=what)
        return
    bar = _bar(cid, func, ref)
    if bar is None:
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=what, **bar)


@pytest.mark.parametrize("cid", W.STREAM_CASE_IDS)
def test_stream_world_matches_reference(world, cid):
    outcomes = [rank[cid] for rank in world]
    first = outcomes[0]
    try:
        ref = _ref_case(cid)
    except Exception as err:  # noqa: BLE001 - the port must raise the same type
        assert all(o[0] == "err" for o in outcomes), f"{cid}: the reference raised {err!r}"
        assert first[1] == type(err).__name__, (first, err)
        return
    assert first[0] == "ok", f"{cid}: the port raised {first[1]}: {first[2]}"
    for r, o in enumerate(outcomes[1:], start=1):
        assert o[0] == "ok", (cid, r, o)
        # replicated: every rank holds the same whole result
        assert all(_same(a, b) for a, b in zip(o[1][:len(ref)], first[1][:len(ref)])), (
            f"{cid}: rank {r} differs")
    got = first[1]
    func = W.stream_case(cid)["kw"].get("func")
    _close(got[0], ref[0], cid, func, cid)
    for g, r in zip(got[1:len(ref)], ref[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=f"{cid} groups")


def test_each_rank_loads_only_its_shard(world):
    """A loader is called with the rank's own columns of every slab (after
    the one-column probe); the reference's loader sees whole slabs."""
    vals, _ = W.stream_case("stream-loader")["args"]
    n, batch_len = vals.shape[-1], 512
    for r, rank in enumerate(world):
        calls = [tuple(c) for c in rank["stream-loader"][1][-1]]
        assert calls[0] == (0, 1)  # the dtype probe
        want = []
        for s in range(0, n, batch_len):
            e = min(s + batch_len, n)
            lo, hi = shard_bounds(e - s, W.NRANKS, r)
            want.append((s + lo, s + hi))
        assert sorted(calls[1:]) == sorted(want), r


@pytest.mark.parametrize("cid", ["stream-blocked-dense-sum", "stream-blocked-dense-nanvar"])
def test_blocked_form_ran(world, cid):
    """With the dense engine pinned above the lowered ceiling, every rank
    takes the owner-by-owner form (its debug line)."""
    for rank in world:
        assert any("blocked owner-by-owner" in line for line in rank[cid][2]), cid


def test_batch_len_rounds_up_to_the_shards():
    from flox_tpu_torch.streaming import _mesh_batch_len

    class Comm:
        size = 4

    assert _mesh_batch_len(1001, Comm) == 1004
    assert _mesh_batch_len(1000, Comm) == 1000
    assert _mesh_batch_len(1001, None) == 1001


# ---------------------------------------------------------------------------
# a world of one: bit for bit the single-device stream
# ---------------------------------------------------------------------------


def _one_rank_pairs(call):
    mesh = make_mesh(device_type="cpu")  # no torch.distributed: a LocalMesh
    return call(device="cpu"), call(mesh=mesh)


@pytest.mark.parametrize("func", W.STREAM_FUNCS + ["nanmedian", "quantile"])
def test_world_of_one_is_the_single_device_stream(func):
    vals, labels = W.stream_case("stream-sum")["args"]
    v = vals if func not in ("any", "all") else ~np.isnan(vals)
    fkw = {"q": [0.25, 0.75]} if func == "quantile" else None
    a, b = _one_rank_pairs(lambda **kw: flox_tpu_torch.streaming_groupby_reduce(
        v[:, :3000], labels[:3000], func=func, batch_len=700, finalize_kwargs=fkw, **kw)[0])
    assert _same(a.numpy(), b.numpy()), func


@pytest.mark.parametrize("func", W.SCAN_FUNCS)
def test_world_of_one_scan_is_the_single_device_stream(func):
    vals, labels = W.stream_case("stream-scan-cumsum")["args"]
    a, b = _one_rank_pairs(lambda **kw: flox_tpu_torch.streaming_groupby_scan(
        vals, labels, func=func, batch_len=1000, **kw))
    assert _same(a, b), func


def test_world_of_one_aggregate_many_and_blocked():
    vals, labels = W.stream_case("stream-sum")["args"]
    funcs = ("count", "nanmean", "nanstd", "nanmin", "nanmax")
    a, b = _one_rank_pairs(lambda **kw: flox_tpu_torch.streaming_groupby_aggregate_many(
        vals, labels, funcs=funcs, batch_len=997, **kw)[0])
    assert _same({k: v.numpy() for k, v in a.items()}, {k: v.numpy() for k, v in b.items()})
    c = W.stream_case("stream-blocked-100k")
    single = flox_tpu_torch.streaming_groupby_reduce(*c["args"], device="cpu", **c["kw"])[0]
    with flox_tpu_torch.set_options(dense_intermediate_bytes_max=c["ceiling"]):
        blocked = flox_tpu_torch.streaming_groupby_reduce(
            *c["args"], mesh=make_mesh(device_type="cpu"), **c["kw"])[0]
    assert _same(single.numpy(), blocked.numpy())


# ---------------------------------------------------------------------------
# checkpoints across processes, and a failing rank
# ---------------------------------------------------------------------------


def test_resume_in_fresh_processes(tmp_path):
    """Two ranks killed at slab 2 resume there in a fresh world; when only
    rank 1 was killed (rank 0 failed in the final combine, its snapshot one
    slab further), the cursors disagree and both ranks start over. Both equal
    an uninterrupted run bit for bit (the fresh run of the second case)."""
    def world(name, spill, kill):
        return W.run_resume_world(str(tmp_path / name), str(tmp_path / spill), kill, world=2)

    killed = world("kill", "spill1", "all")
    assert all(o == ("killed",) for o in killed), killed
    resumed = world("resume", "spill1", "none")
    assert all(o[0] == "ok" and o[2] == 2 for o in resumed), resumed  # resumed after slab 2

    one = world("kill1", "spill2", "one")
    assert one[1] == ("killed",), one
    assert one[0] is None or one[0][0] == "err", one
    again = world("again", "spill2", "none")
    assert all(o[0] == "ok" and o[2] is None for o in again), again  # no agreed cursor
    want = again[0][1].tobytes()
    assert all(o[1].tobytes() == want for o in resumed + again)


def test_rank_raising_before_the_combine_fails_within_deadline(tmp_path):
    deadline = 60.0
    t0 = time.monotonic()
    try:
        outcomes = W.run_world(["stream-raise"], str(tmp_path), deadline_s=deadline,
                               timeout_s=10.0)
    except W.WorldFailed:
        outcomes = None  # the deadline terminated the waiting ranks
    assert time.monotonic() - t0 < deadline + 30
    if outcomes is not None:
        assert outcomes[1]["stream-raise"][:2] == ("err", "ValueError"), outcomes[1]
        for r, rank in enumerate(outcomes):
            assert rank["stream-raise"][0] == "err", (r, rank)
