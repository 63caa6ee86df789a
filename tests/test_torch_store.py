"""The port's durable incremental aggregation store (``flox_tpu_torch.store``,
``flox_tpu_torch.serve.stores``) held against flox_tpu's.

Each case of the reference's ``tests/test_store.py`` runs on both stores with
the same slabs: the port's queries equal the reference store's (exact for
counts and extrema, and for the additive family on integer-valued data;
within the reference test's ``1e-12`` for the variance family and NaN data),
every kill point of the recovery matrix reopens the port's store bit for bit
as an uninterrupted port run, and a store directory that flox_tpu wrote
(engines ``"numpy"`` and ``"jax"``) opens in the port and answers the same
query: the on-disk format is the reference's. The port's stores reduce on the
CPU here (``device="cpu"``); without it the default engine raises for want of
CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import flox_tpu
import flox_tpu_torch
from flox_tpu import store as ref_store
from flox_tpu.fusion import groupby_aggregate_many as ref_aggregate_many
from flox_tpu_torch import cache, faults, telemetry
from flox_tpu_torch.multiarray import PresentGroups, merge_present_var
from flox_tpu_torch.store import (
    IncrementalAggregationStore,
    StoreCorruptionError,
    open_store,
    read_checksummed_npz,
    write_checksummed_npz,
)
from flox_tpu_torch.telemetry import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FUNCS = ("sum", "count", "min", "max", "mean", "var", "nanstd")
#: exact on integer-valued float64 data: sums of small integers are exact in
#: binary64 whatever the association, so every merge order gives the same bits
EXACT = ("sum", "count", "min", "max", "mean")
SIZE = 23


@pytest.fixture(autouse=True)
def _clean_state():
    METRICS.reset()
    cache.clear_all()
    yield
    cache.clear_all()


def _slabs(nslabs=4, n=120, seed=7, integer=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nslabs):
        codes = rng.integers(0, SIZE, n)
        vals = (rng.integers(-50, 50, n).astype(np.float64) if integer
                else rng.normal(size=n))
        out.append((codes, vals))
    return out


def _host(res: dict) -> dict:
    return {f: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for f, v in res.items()}


def _ref_inline(slabs, funcs=FUNCS, **kw):
    codes = np.concatenate([c for c, _ in slabs])
    vals = np.concatenate([v for _, v in slabs])
    res, _ = ref_aggregate_many(vals, codes, funcs=funcs, expected_groups=np.arange(SIZE), **kw)
    return _host(res)


def _check(store_res, oracle, funcs=FUNCS):
    got, want = _host(store_res), _host(oracle)
    for f in funcs:
        assert got[f].dtype == want[f].dtype, f
        if f in EXACT:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-12, atol=1e-12, err_msg=f)


def _same(a: dict, b: dict, funcs=FUNCS):
    a, b = _host(a), _host(b)
    for f in funcs:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _fill(path, slabs, funcs=FUNCS, **create_kw):
    create_kw.setdefault("device", "cpu")
    s = IncrementalAggregationStore.create(path, funcs=funcs, size=SIZE, **create_kw)
    for codes, vals in slabs:
        s.append(codes, vals)
    return s


def _ref_fill(path, slabs, funcs=FUNCS, **create_kw):
    s = ref_store.IncrementalAggregationStore.create(path, funcs=funcs, size=SIZE, **create_kw)
    for codes, vals in slabs:
        s.append(codes, vals)
    return s


class TestChecksummedNpz:
    def test_round_trip(self, tmp_path):
        p = str(tmp_path / "x.npz")
        arrays = {"a": np.arange(5.0), "b": np.array([[1, 2], [3, 4]], dtype=np.int32)}
        write_checksummed_npz(p, arrays, {"kind": "t", "gen": 3})
        got, meta = read_checksummed_npz(p)
        assert meta["kind"] == "t" and meta["gen"] == 3
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])
            assert got[k].dtype == arrays[k].dtype

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_cross_package_format(self, tmp_path, writer):
        p = str(tmp_path / "x.npz")
        arrays = {"a": np.arange(7.0), "b": np.arange(6, dtype=np.int64).reshape(2, 3)}
        write = write_checksummed_npz if writer == "port" else ref_store.write_checksummed_npz
        read = ref_store.read_checksummed_npz if writer == "port" else read_checksummed_npz
        write(p, arrays, {"gen": 1})
        got, meta = read(p)
        assert meta == {"gen": 1}
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])

    def test_bit_flip_detected(self, tmp_path):
        p = str(tmp_path / "x.npz")
        write_checksummed_npz(p, {"a": np.arange(100.0)}, {})
        data = bytearray(open(p, "rb").read())
        data[len(data) // 2] ^= 0x04
        open(p, "wb").write(bytes(data))
        with pytest.raises(StoreCorruptionError):
            read_checksummed_npz(p)

    def test_truncation_detected(self, tmp_path):
        p = str(tmp_path / "x.npz")
        write_checksummed_npz(p, {"a": np.arange(100.0)}, {})
        data = open(p, "rb").read()
        open(p, "wb").write(data[: len(data) // 2])
        with pytest.raises(StoreCorruptionError):
            read_checksummed_npz(p)

    def test_headerless_npz_rejected(self, tmp_path):
        p = str(tmp_path / "x.npz")
        np.savez(p, a=np.arange(3))
        with pytest.raises(StoreCorruptionError, match="header"):
            read_checksummed_npz(p)

    def test_future_format_rejected(self, tmp_path):
        p = str(tmp_path / "x.npz")
        hdr = json.dumps({"format": 99, "meta": {}, "digests": {}}).encode()
        np.savez(p, __header__=np.frombuffer(hdr, dtype=np.uint8))
        with pytest.raises(StoreCorruptionError, match="future"):
            read_checksummed_npz(p)

    def test_missing_file_is_filenotfound(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            read_checksummed_npz(str(tmp_path / "nope.npz"))


class TestMergePresentVar:
    """The carry's variance merge against the reference's on the same
    present-group layers."""

    @staticmethod
    def _triple(module, present, vals_by_group, size=6):
        m2, tot, cnt = [], [], []
        for g in present:
            v = np.asarray(vals_by_group[g], dtype=np.float64)
            cnt.append(float(len(v)))
            tot.append(float(v.sum()))
            m2.append(float(((v - v.mean()) ** 2).sum()))
        present = np.asarray(present)
        return tuple(module.PresentGroups(present, np.asarray(x + [0.0]), size)
                     for x in (m2, tot, cnt))

    @pytest.mark.parametrize("layout", ["overlapping", "disjoint"])
    def test_matches_reference(self, layout):
        from flox_tpu import multiarray as ref_ma
        from flox_tpu_torch import multiarray as port_ma

        rng = np.random.default_rng(3)
        groups = {g: rng.normal(size=int(rng.integers(1, 9))) for g in range(6)}
        pa, pb = ([0, 2, 3], [2, 3, 5]) if layout == "overlapping" else ([0, 1], [4, 5])
        got = port_ma.merge_present_var(self._triple(port_ma, pa, groups),
                                        self._triple(port_ma, pb, groups))
        want = ref_ma.merge_present_var(self._triple(ref_ma, pa, groups),
                                        self._triple(ref_ma, pb, groups))
        for g_pg, w_pg in zip(got, want):
            np.testing.assert_array_equal(g_pg.present, w_pg.present)
            np.testing.assert_allclose(np.asarray(g_pg.values), np.asarray(w_pg.values),
                                       rtol=1e-12, atol=1e-12)

    def test_single_pass_equivalence(self):
        m2, tot, cnt = merge_present_var(
            tuple(PresentGroups(np.array([1]), np.array([x, 0.0]), 3) for x in (2.0, 4.0, 2.0)),
            tuple(PresentGroups(np.array([1]), np.array([x, 0.0]), 3) for x in (0.5, 9.0, 2.0)))
        # [1, 3] then [4, 5]: m2 is the sum of squared deviations of all four
        vals = np.array([1.0, 3.0, 4.0, 5.0])
        assert cnt.scatter_dense()[1] == 4.0 and tot.scatter_dense()[1] == vals.sum()
        np.testing.assert_allclose(m2.scatter_dense()[1], ((vals - vals.mean()) ** 2).sum())


class TestStoreBasics:
    def test_direct_ctor_rejected(self, tmp_path):
        with pytest.raises(TypeError, match="create"):
            IncrementalAggregationStore(str(tmp_path / "s"))

    def test_create_twice_rejected(self, tmp_path):
        p = str(tmp_path / "s")
        IncrementalAggregationStore.create(p, funcs=("sum",), size=4, device="cpu")
        with pytest.raises(FileExistsError):
            IncrementalAggregationStore.create(p, funcs=("sum",), size=4, device="cpu")

    def test_open_missing_rejected(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            IncrementalAggregationStore.open(str(tmp_path / "nope"), device="cpu")

    def test_create_validation(self, tmp_path):
        with pytest.raises(ValueError, match="engine"):
            IncrementalAggregationStore.create(str(tmp_path / "a"), funcs=("sum",), size=4,
                                               engine="pallas", device="cpu")
        with pytest.raises(ValueError, match="size"):
            IncrementalAggregationStore.create(str(tmp_path / "b"), funcs=("sum",), size=0,
                                               device="cpu")

    def test_default_engine_runs_on_cuda(self, tmp_path):
        # the port's entry points run on the card unless the caller names
        # the CPU: without CUDA the default store raises, and writes nothing
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        p = str(tmp_path / "s")
        with pytest.raises(RuntimeError, match="CUDA"):
            IncrementalAggregationStore.create(p, funcs=("sum",), size=4)
        assert not os.path.exists(os.path.join(p, "journal.log"))
        s = IncrementalAggregationStore.create(p, funcs=("sum",), size=4, device="cpu")
        assert s.engine == "torch" and s.device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            IncrementalAggregationStore.open(p)

    def test_numpy_engine_when_named(self, tmp_path):
        slabs = _slabs()
        s = _fill(str(tmp_path / "s"), slabs, engine="numpy", device=None)
        assert s.engine == "numpy" and s.device == torch.device("cpu")
        _check(s.query(), _ref_inline(slabs, engine="numpy"))
        assert json.loads(open(os.path.join(s.path, "journal.log")).readline()
                          .rsplit("\t#", 1)[0])["engine"] == "numpy"

    def test_append_query_matches_reference_store(self, tmp_path):
        slabs = _slabs()
        s = _fill(str(tmp_path / "p"), slabs)
        r = _ref_fill(str(tmp_path / "r"), slabs)
        _check(s.query(), r.query())
        _check(s.query(), _ref_inline(slabs, engine="numpy"))
        for f, v in s.query().items():
            assert isinstance(v, torch.Tensor) and v.device == torch.device("cpu"), f

    def test_plan_persisted_across_open(self, tmp_path):
        p = str(tmp_path / "s")
        IncrementalAggregationStore.create(
            p, funcs=("sum", "var"), size=9, array_dtype="float32", min_count=2,
            finalize_kwargs={"var": {"ddof": 1}}, device="cpu")
        s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.funcs == ("sum", "var")
        assert s2.size == 9
        assert s2.array_dtype == np.dtype("float32")
        assert s2.min_count == 2
        assert s2.finalize_kwargs == {"var": {"ddof": 1}}
        assert s2.engine == "torch"

    def test_reopen_bit_identical(self, tmp_path):
        s = _fill(str(tmp_path / "s"), _slabs())
        before = s.query()
        s2 = IncrementalAggregationStore.open(s.path, device="cpu")
        assert not s2.recovered
        _same(s2.query(), before)

    def test_duplicate_slab_is_noop(self, tmp_path):
        slabs = _slabs(2)
        s = _fill(str(tmp_path / "s"), slabs)
        before = s.query()
        gen = s.gen
        ack = s.append(*slabs[0])
        assert ack["ack"] == "slab_already_ingested"
        assert s.gen == gen
        assert METRICS.counters()["store.duplicates"] == 1
        _same(s.query(), before)

    def test_fingerprint_is_the_references(self, tmp_path):
        # the same slab keys the same idempotency record in both packages
        codes, vals = _slabs(1)[0]
        p = _fill(str(tmp_path / "p"), [])
        r = _ref_fill(str(tmp_path / "r"), [])
        assert p.append(codes, vals)["slab"] == r.append(codes, vals)["slab"]

    def test_slab_id_overrides_fingerprint(self, tmp_path):
        slabs = _slabs(2)
        s = IncrementalAggregationStore.create(str(tmp_path / "s"), funcs=FUNCS, size=SIZE,
                                               device="cpu")
        s.append(*slabs[0], slab_id="batch-0")
        ack = s.append(*slabs[1], slab_id="batch-0")
        assert ack["ack"] == "slab_already_ingested"
        _check(s.query(), _ref_inline(slabs[:1], engine="numpy"))

    def test_out_of_range_codes_dropped(self, tmp_path):
        s = IncrementalAggregationStore.create(str(tmp_path / "s"), funcs=("sum", "count"),
                                               size=4, device="cpu")
        s.append(np.array([0, -1, 2, 99]), np.array([1.0, 100.0, 3.0, 100.0]))
        res = _host(s.query())
        np.testing.assert_array_equal(res["sum"], [1.0, 0.0, 3.0, 0.0])
        np.testing.assert_array_equal(res["count"], [1, 0, 1, 0])

    def test_all_invalid_slab_is_journal_only(self, tmp_path):
        s = IncrementalAggregationStore.create(str(tmp_path / "s"), funcs=("sum",), size=4,
                                               device="cpu")
        ack = s.append(np.array([-1, 77]), np.array([1.0, 2.0]))
        assert ack["ack"] == "ingested" and s.gen == 1
        assert not [f for f in os.listdir(s.path) if f.startswith("seg-")]
        s2 = IncrementalAggregationStore.open(s.path, device="cpu")
        assert s2.gen == 1
        assert s2.append(np.array([-1, 77]), np.array([1.0, 2.0]))["ack"] == (
            "slab_already_ingested")

    def test_empty_store_query(self, tmp_path):
        funcs = ("sum", "count", "mean")
        s = IncrementalAggregationStore.create(str(tmp_path / "s"), funcs=funcs, size=5,
                                               device="cpu")
        r = ref_store.IncrementalAggregationStore.create(str(tmp_path / "r"), funcs=funcs,
                                                         size=5)
        res = _host(s.query())
        np.testing.assert_array_equal(res["sum"], np.zeros(5))
        np.testing.assert_array_equal(res["count"], np.zeros(5, dtype=np.int64))
        assert np.isnan(res["mean"]).all()
        _check(s.query(), r.query(), funcs)

    def test_query_subset_and_unknown(self, tmp_path):
        s = _fill(str(tmp_path / "s"), _slabs(2))
        res = s.query(("mean", "max"))
        assert sorted(res) == ["max", "mean"]
        with pytest.raises(ValueError, match="median"):
            s.query(("median",))

    def test_shape_mismatch_rejected(self, tmp_path):
        s = IncrementalAggregationStore.create(str(tmp_path / "s"), funcs=("sum",), size=4,
                                               device="cpu")
        with pytest.raises(ValueError, match="trailing axis"):
            s.append(np.array([0, 1]), np.array([1.0, 2.0, 3.0]))

    def test_info_snapshot(self, tmp_path):
        s = _fill(str(tmp_path / "s"), _slabs(3))
        r = _ref_fill(str(tmp_path / "r"), _slabs(3))
        info, rinfo = s.info(), r.info()
        assert info["gen"] == 3 and info["slabs"] == 3
        assert info["segments"] == 3 and info["nbytes"] > 0
        for key in ("gen", "slabs", "n_present", "segments", "nbytes", "funcs", "size"):
            assert info[key] == rinfo[key], key
        json.dumps(info)

    def test_open_store_convenience(self, tmp_path):
        p = str(tmp_path / "s")
        with pytest.raises(FileNotFoundError):
            open_store(p, device="cpu")
        s = open_store(p, create={"funcs": ("sum",), "size": 4}, device="cpu")
        s.append(np.array([1]), np.array([5.0]))
        s2 = open_store(p, create={"funcs": ("sum",), "size": 4}, device="cpu")
        assert s2.gen == 1

    def test_tensor_slabs(self, tmp_path):
        slabs = _slabs(3)
        s = _fill(str(tmp_path / "s"), [(torch.from_numpy(c), torch.from_numpy(v))
                                          for c, v in slabs])
        _same(s.query(), _fill(str(tmp_path / "n"), slabs).query())

    def test_trio_is_one_multistat_pass_per_append(self, tmp_path, monkeypatch):
        """The fusable legs of a slab are one pass of the multi-statistic
        kernel (its plain version here, on the CPU)."""
        from flox_tpu_torch import cuda_kernels as ck

        calls = []
        plain = ck.segment_multistat_plain
        monkeypatch.setattr(ck, "segment_multistat_plain",
                            lambda *a, **k: calls.append(1) or plain(*a, **k))
        rng = np.random.default_rng(0)
        s = IncrementalAggregationStore.create(
            str(tmp_path / "s"), funcs=("nanmean", "nanmin", "nanmax"), size=12,
            array_dtype="float32", device="cpu")
        month = (np.arange(960) // 80) % 12
        for i in range(3):
            s.append(month[i * 320:(i + 1) * 320],
                     rng.normal(size=(4, 320)).astype(np.float32))
        assert len(calls) == 3


def _writes_per_append(tmp_path, slabs):
    """(first, last) 1-based durable-write ordinals of the last append of a
    create + append-all run."""
    with faults.store_inject() as plan:
        s = IncrementalAggregationStore.create(str(tmp_path / "probe"), funcs=FUNCS, size=SIZE,
                                               device="cpu")
        for codes, vals in slabs[:-1]:
            s.append(codes, vals)
        before = plan.writes
        s.append(*slabs[-1])
        after = plan.writes
    return before + 1, after


class TestRecoveryMatrix:
    """Kill, tear or flip at every durable write of the last append, then
    reopen (crash recovery), re-append and query: bit for bit the
    uninterrupted port run, and equal to the reference store's query."""

    @pytest.fixture(scope="class")
    def control(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("ctrl")
        slabs = _slabs()
        s = _fill(str(tmp / "ctrl"), slabs)
        r = _ref_fill(str(tmp / "ref"), slabs)
        return slabs, _host(s.query()), _host(r.query())

    @pytest.mark.parametrize("action", ["kill", "torn", "flip"])
    @pytest.mark.parametrize("offset", [0, 1])  # the journal write, the segment write
    def test_crash_during_append(self, tmp_path, control, action, offset):
        slabs, ctrl, ref = control
        first, last = _writes_per_append(tmp_path, slabs)
        assert last - first == 1, "an append is one journal write and one segment write"
        key = {"kill": "kill_at", "torn": "torn_at", "flip": "flip_at"}[action]
        p = str(tmp_path / "s")
        with faults.store_inject(**{key: (first + offset,)}):
            s = IncrementalAggregationStore.create(p, funcs=FUNCS, size=SIZE, device="cpu")
            for codes, vals in slabs[:-1]:
                s.append(codes, vals)
            try:
                s.append(*slabs[-1])
            except faults.StoreWriteKilled:
                pass
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.gen in (len(slabs) - 1, len(slabs))
        s2.append(*slabs[-1])
        assert s2.gen == len(slabs)
        _same(s2.query(), ctrl)
        _check(s2.query(), ref)

    def test_torn_journal_tail_counts_recovery(self, tmp_path, control):
        slabs, _, _ = control
        first, _ = _writes_per_append(tmp_path, slabs)
        p = str(tmp_path / "s")
        with faults.store_inject(torn_at=(first,)):
            s = IncrementalAggregationStore.create(p, funcs=FUNCS, size=SIZE, device="cpu")
            for codes, vals in slabs[:-1]:
                s.append(codes, vals)
            with pytest.raises(faults.StoreWriteKilled):
                s.append(*slabs[-1])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.recovered
        assert METRICS.counters()["store.recoveries"] == 1
        assert s2.gen == len(slabs) - 1

    def test_torn_tail_is_truncated_so_reappend_survives_reopen(self, tmp_path, control):
        slabs, ctrl, _ = control
        first, _ = _writes_per_append(tmp_path, slabs)
        p = str(tmp_path / "s")
        with faults.store_inject(torn_at=(first,)):
            s = IncrementalAggregationStore.create(p, funcs=FUNCS, size=SIZE, device="cpu")
            for codes, vals in slabs[:-1]:
                s.append(codes, vals)
            with pytest.raises(faults.StoreWriteKilled):
                s.append(*slabs[-1])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.append(*slabs[-1])["ack"] == "ingested"
        s3 = IncrementalAggregationStore.open(p, device="cpu")
        assert not s3.recovered
        assert s3.gen == len(slabs)
        assert s3.append(*slabs[-1])["ack"] == "slab_already_ingested"
        _same(s3.query(), ctrl)

    def test_crash_before_any_append(self, tmp_path):
        p = str(tmp_path / "s")
        with faults.store_inject(kill_at=(2,)):  # the first append's journal write
            s = IncrementalAggregationStore.create(p, funcs=("sum",), size=4, device="cpu")
            with pytest.raises(faults.StoreWriteKilled):
                s.append(np.array([0]), np.array([1.0]))
        s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.gen == 0
        assert s2.append(np.array([0]), np.array([1.0]))["ack"] == "ingested"

    def test_mid_history_corruption_typed_error(self, tmp_path, control):
        slabs, _, _ = control
        p = str(tmp_path / "s")
        _fill(p, slabs)
        segs = sorted(f for f in os.listdir(p) if f.startswith("seg-"))
        victim = os.path.join(p, segs[1])
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(data))
        with pytest.raises(StoreCorruptionError) as exc_info:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                IncrementalAggregationStore.open(p, device="cpu")
        assert exc_info.value.segment == segs[1]
        assert os.path.exists(victim + ".corrupt")
        assert not os.path.exists(victim)

    def test_deleted_tail_segment_rolls_back(self, tmp_path, control):
        slabs, ctrl, _ = control
        p = str(tmp_path / "s")
        _fill(p, slabs)
        segs = sorted(f for f in os.listdir(p) if f.startswith("seg-"))
        os.unlink(os.path.join(p, segs[-1]))
        with pytest.warns(RuntimeWarning, match="rolling back"):
            s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.recovered and s2.gen == len(slabs) - 1
        s2.append(*slabs[-1])
        _same(s2.query(), ctrl)

    def test_orphan_tmp_cleaned_on_open(self, tmp_path):
        p = str(tmp_path / "s")
        _fill(p, _slabs(2))
        open(os.path.join(p, "seg-00000009.npz.tmp"), "wb").write(b"junk")
        open(os.path.join(p, "seg-00000009.npz"), "wb").write(b"junk")
        IncrementalAggregationStore.open(p, device="cpu")
        left = os.listdir(p)
        assert "seg-00000009.npz.tmp" not in left
        assert "seg-00000009.npz" not in left

    def test_write_log_matches_reference(self, tmp_path, control):
        """The same sequence of durable writes, kind by kind, as the
        reference store's: the fault ordinals mean the same thing."""
        slabs, _, _ = control
        logs = []
        for name, fill in (("p", _fill), ("r", _ref_fill)):
            inject = faults.store_inject if name == "p" else flox_tpu.faults.store_inject
            with inject() as plan:
                fill(str(tmp_path / name), slabs).compact()
            logs.append([(kind, fn) for _, kind, fn, _ in plan.log])
        assert logs[0] == logs[1]


class TestReferenceDirectories:
    """A store directory that flox_tpu wrote opens in the port and answers the
    same query: the on-disk format is the reference's."""

    @pytest.mark.parametrize("engine", ["numpy", "jax"])
    @pytest.mark.parametrize("compacted", [False, True])
    def test_port_opens_reference_store(self, tmp_path, engine, compacted):
        slabs = _slabs()
        p = str(tmp_path / "r")
        r = _ref_fill(p, slabs, engine=engine)
        if compacted:
            r.compact()
        want = r.query()
        s = IncrementalAggregationStore.open(p, device="cpu")
        # the reference's "jax" engine opens as the port's "torch"
        assert s.engine == {"numpy": "numpy", "jax": "torch"}[engine]
        assert s.gen == len(slabs) and not s.recovered
        _check(s.query(), want)
        # and it goes on appending: the next slab folds into the same carry
        extra = _slabs(1, seed=11)
        s.append(*extra[0])
        r2 = _ref_fill(str(tmp_path / "r2"), slabs + extra, engine=engine)
        _check(s.query(), r2.query())

    def test_reference_opens_port_store_for_queries(self, tmp_path):
        slabs = _slabs()
        s = _fill(str(tmp_path / "p"), slabs)
        s.compact()
        r = ref_store.IncrementalAggregationStore.open(s.path)
        assert r.gen == len(slabs)
        _check(s.query(), r.query())


class TestCompaction:
    def test_compact_preserves_results(self, tmp_path):
        slabs = _slabs()
        s = _fill(str(tmp_path / "s"), slabs)
        before = _host(s.query())
        out = s.compact()
        assert out["compacted"] and out["segments"] == 1
        assert len([f for f in os.listdir(s.path) if f.startswith("seg-")]) == 1
        for store in (s, IncrementalAggregationStore.open(s.path, device="cpu")):
            _same(store.query(), before)

    def test_compact_then_append_then_compact(self, tmp_path):
        slabs = _slabs(6)
        s = _fill(str(tmp_path / "s"), slabs[:3])
        s.compact()
        for codes, vals in slabs[3:]:
            s.append(codes, vals)
        s.compact()
        s2 = IncrementalAggregationStore.open(s.path, device="cpu")
        assert s2.gen == 6 and s2.info()["segments"] == 1
        _check(s2.query(), _ref_inline(slabs, engine="numpy"))

    def test_compact_noop_cases(self, tmp_path):
        s = IncrementalAggregationStore.create(str(tmp_path / "s"), funcs=("sum",), size=4,
                                               device="cpu")
        assert not s.compact()["compacted"]
        s.append(np.array([0]), np.array([1.0]))
        assert not s.compact()["compacted"]

    @pytest.mark.parametrize("op,ordinal", [("segment", 1), ("journal", 1)])
    def test_crash_during_compact(self, tmp_path, op, ordinal):
        slabs = _slabs()
        ctrl = _ref_inline(slabs, engine="numpy")
        p = str(tmp_path / "s")
        s = _fill(p, slabs)
        with faults.store_inject(kill_at=(ordinal,), op=op):
            with pytest.raises(faults.StoreWriteKilled):
                s.compact()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.gen == len(slabs)
        _check(s2.query(), ctrl)

    @pytest.mark.parametrize("ordinal", [1, 2, 4])
    def test_crash_during_swap_delete(self, tmp_path, ordinal):
        slabs = _slabs()
        ctrl = _ref_inline(slabs, engine="numpy")
        p = str(tmp_path / "s")
        s = _fill(p, slabs)
        with faults.store_inject(kill_at=(ordinal,), op="swap"):
            with pytest.raises(faults.StoreWriteKilled):
                s.compact()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            s2 = IncrementalAggregationStore.open(p, device="cpu")
        assert s2.gen == len(slabs) and s2.info()["segments"] == 1
        _check(s2.query(), ctrl)
        live = [f for f in os.listdir(p) if f.startswith("seg-") and f.endswith(".npz")]
        assert len(live) == 1

    def test_auto_compact_threshold(self, tmp_path):
        slabs = _slabs(6)
        with flox_tpu_torch.set_options(store_compact_threshold=2):
            s = _fill(str(tmp_path / "s"), slabs)
        assert s.info()["segments"] <= 3
        assert METRICS.counters()["store.compactions"] >= 1
        _check(s.query(), _ref_inline(slabs, engine="numpy"))


class TestInlineEquivalence:
    """query == the one-shot fused aggregation over the concatenated history,
    whichever engine the inline side used."""

    @pytest.mark.parametrize("inline_engine", ["numpy", "jax", "sort"])
    def test_reference_engines(self, tmp_path, inline_engine):
        slabs = _slabs()
        s = _fill(str(tmp_path / "s"), slabs)
        _check(s.query(), _ref_inline(slabs, engine=inline_engine))

    @pytest.mark.parametrize("engine", ["torch", "sort", "numpy"])
    def test_port_engines(self, tmp_path, engine):
        slabs = _slabs()
        s = _fill(str(tmp_path / "s"), slabs)
        codes = np.concatenate([c for c, _ in slabs])
        vals = np.concatenate([v for _, v in slabs])
        res, _ = flox_tpu_torch.groupby_aggregate_many(
            vals, codes, funcs=FUNCS, expected_groups=np.arange(SIZE), engine=engine,
            device="cpu")
        _check(s.query(), res)

    def test_mesh(self, tmp_path):
        from flox_tpu.parallel.mesh import make_mesh

        slabs = _slabs(4, n=128)
        s = _fill(str(tmp_path / "s"), slabs)
        _check(s.query(), _ref_inline(slabs, method="map-reduce", mesh=make_mesh()))

    def test_reference_jax_engine_store(self, tmp_path):
        slabs = _slabs()
        s = _fill(str(tmp_path / "s"), slabs)
        r = _ref_fill(str(tmp_path / "r"), slabs, engine="jax")
        _check(s.query(), r.query())

    def test_nan_data(self, tmp_path):
        rng = np.random.default_rng(5)
        slabs = []
        for _ in range(3):
            codes = rng.integers(0, SIZE, 90)
            vals = rng.normal(size=90)
            vals[rng.random(90) < 0.2] = np.nan
            slabs.append((codes, vals))
        funcs = ("nansum", "count", "nanmax", "nanmean", "nanstd")
        s = _fill(str(tmp_path / "s"), slabs, funcs=funcs)
        r = _ref_fill(str(tmp_path / "r"), slabs, funcs=funcs)
        got, want = _host(s.query()), _host(r.query())
        oracle = _ref_inline(slabs, funcs=funcs, engine="numpy")
        for f in funcs:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-12, atol=1e-12, err_msg=f)
            np.testing.assert_allclose(got[f], oracle[f], rtol=1e-12, atol=1e-12, err_msg=f)

    def test_float32_trio(self, tmp_path):
        """The card's configuration: nanmean/nanmin/nanmax of float32 slabs,
        against the reference store at the float32 bar (extrema exact)."""
        rng = np.random.default_rng(9)
        funcs = ("nanmean", "nanmin", "nanmax")
        slabs = [((np.arange(300) // 25 + 3 * i) % 12, rng.normal(size=(5, 300)).astype("f4"))
                 for i in range(4)]
        s = IncrementalAggregationStore.create(str(tmp_path / "s"), funcs=funcs, size=12,
                                               array_dtype="float32", device="cpu")
        r = ref_store.IncrementalAggregationStore.create(str(tmp_path / "r"), funcs=funcs,
                                                         size=12, array_dtype="float32")
        for c, v in slabs:
            s.append(c, v)
            r.append(c, v)
        got, want = _host(s.query()), _host(r.query())
        for f in ("nanmin", "nanmax"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_allclose(got["nanmean"], want["nanmean"], rtol=1e-5, atol=1e-6)
        assert got["nanmean"].dtype == np.float32


class TestOptions:
    def test_validation(self):
        for bad in ({"store_compact_threshold": -1}, {"store_fsync": "maybe"},
                    {"store_root": 123}):
            with pytest.raises(ValueError):
                flox_tpu_torch.set_options(**bad)

    def test_fsync_off_still_correct(self, tmp_path):
        slabs = _slabs(2)
        with flox_tpu_torch.set_options(store_fsync="off"):
            s = _fill(str(tmp_path / "s"), slabs)
        s2 = IncrementalAggregationStore.open(s.path, device="cpu")
        _check(s2.query(), _ref_inline(slabs, engine="numpy"))

    def test_options_carried_from_reference(self):
        from flox_tpu_torch.options import from_reference

        opts = from_reference({"store_root": "/x", "store_compact_threshold": 3,
                               "store_fsync": "off"})
        assert opts == {"store_root": "/x", "store_compact_threshold": 3, "store_fsync": "off"}


class TestCheckpointHardening:
    """The streaming checkpointer's spills ride the store's checksummed
    format: a damaged spill warns and means a fresh run."""

    KEY = ("stream", "sum", 64, 8, 5, (), "fp", None, None, ())

    def _spill(self, tmp_path):
        from flox_tpu_torch.resilience import Snapshot, _dump_snapshot

        p = str(tmp_path / "ckpt.npz")
        _dump_snapshot(p, Snapshot(key=self.KEY, phase=1, slabs_done=4,
                                   payload=(torch.arange(6.0),)))
        return p

    def test_round_trip(self, tmp_path):
        from flox_tpu_torch.resilience import _load_snapshot

        got = _load_snapshot(self._spill(tmp_path), self.KEY)
        assert got is not None and got.slabs_done == 4 and got.phase == 1
        assert torch.equal(got.payload[0], torch.arange(6.0))

    @pytest.mark.parametrize("damage", ["truncate", "bitflip"])
    def test_damaged_spill_restarts_fresh(self, tmp_path, damage):
        from flox_tpu_torch.resilience import _load_snapshot

        p = self._spill(tmp_path)
        data = bytearray(open(p, "rb").read())
        if damage == "truncate":
            data = data[: len(data) // 2]
        else:
            data[len(data) // 2] ^= 0x01
        open(p, "wb").write(bytes(data))
        with pytest.warns(RuntimeWarning, match="corrupt"):
            assert _load_snapshot(p, self.KEY) is None


class TestServeStores:
    @pytest.fixture(autouse=True)
    def _root(self, tmp_path):
        from flox_tpu.serve import stores as ref_stores

        with flox_tpu_torch.set_options(store_root=str(tmp_path)), \
                flox_tpu.set_options(store_root=str(tmp_path / "reference")):
            yield str(tmp_path)
        ref_stores.clear()

    def test_unknown_store_typed(self):
        from flox_tpu_torch.serve import stores

        with pytest.raises(stores.UnknownStoreError) as exc_info:
            stores.query("nope", device="cpu")
        assert exc_info.value.code == "unknown_store"

    def test_no_root_typed(self):
        from flox_tpu_torch.serve import stores

        with flox_tpu_torch.set_options(store_root=None):
            with pytest.raises(stores.UnknownStoreError, match="store root"):
                stores.query("x", device="cpu")

    def test_bad_names_typed(self):
        from flox_tpu_torch.serve import stores

        for bad in ("", None, "../evil", "a/b", ".hidden"):
            with pytest.raises(stores.UnknownStoreError):
                stores.resolve(bad, device="cpu")

    def test_append_query_roundtrip(self):
        from flox_tpu.serve import stores as ref_stores
        from flox_tpu_torch.serve import stores

        slabs = _slabs(3)
        create = {"funcs": list(FUNCS), "size": SIZE}
        for codes, vals in slabs:
            ack = stores.append("t", codes, vals, create=create, device="cpu")
            ref_stores.append("r", codes, vals, create=create)
        assert ack["ack"] == "ingested" and ack["gen"] == 3
        got = stores.query("t")
        assert all(isinstance(v, np.ndarray) for v in got.values())
        _check(got, ref_stores.query("r"))
        _check(got, _ref_inline(slabs, engine="numpy"))

    def test_query_device_cache_invalidated_by_append(self):
        from flox_tpu_torch.serve import stores

        slabs = _slabs(3)
        create = {"funcs": list(FUNCS), "size": SIZE}
        stores.append("t", *slabs[0], create=create, device="cpu")
        stores.query("t")
        stores.query("t")
        assert METRICS.counters().get("store.query_device_hits", 0) == 1
        stores.append("t", *slabs[1])
        res = stores.query("t")
        assert METRICS.counters().get("store.query_device_hits", 0) == 1
        _check(res, _ref_inline(slabs[:2], engine="numpy"))

    def test_restage_all_recovers(self):
        from flox_tpu_torch.serve import stores

        create = {"funcs": list(FUNCS), "size": SIZE}
        for codes, vals in _slabs(2):
            stores.append("t", codes, vals, create=create, device="cpu")
        before = stores.query("t")
        assert stores.restage_all() == 1
        assert METRICS.counters()["store.restaged"] == 1
        _same(stores.query("t"), before)

    def test_corruption_typed_and_quarantined(self, _root):
        from flox_tpu_torch.serve import stores

        p = os.path.join(_root, "bad")
        del_me = _fill(p, _slabs(3))
        del del_me
        segs = sorted(f for f in os.listdir(p) if f.startswith("seg-"))
        victim = os.path.join(p, segs[0])
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(data))
        with pytest.raises(stores.StoreCorruptedError) as exc_info:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                stores.query("bad", device="cpu")
        assert exc_info.value.code == "store_corruption"
        assert os.path.exists(victim + ".corrupt")

    def test_list_stores_sees_unopened(self, _root):
        from flox_tpu_torch.serve import stores

        _fill(os.path.join(_root, "cold"), _slabs(1))
        stores.append("hot", *_slabs(1)[0], create={"funcs": ["sum"], "size": SIZE},
                      device="cpu")
        rows = {r["store"]: r for r in stores.list_stores()}
        assert rows["hot"]["open"] is True
        assert rows["cold"]["open"] is False

    def test_cache_stats_and_clear_all(self):
        from flox_tpu_torch.serve import stores

        stores.append("t", *_slabs(1)[0], create={"funcs": ["sum", "mean"], "size": SIZE},
                      device="cpu")
        panel = cache.stats()["stores"]
        assert panel["stores"] == 1 and panel["generations"] == {"t": 1}
        assert panel["state_bytes"] > 0
        cache.clear_all()
        assert stores.stores_stats()["stores"] == 0
        assert stores.query("t", device="cpu")["sum"].shape == (SIZE,)

    def test_debug_stores_payload(self):
        from flox_tpu_torch.exposition import _Handler
        from flox_tpu_torch.serve import stores

        stores.append("t", *_slabs(1)[0], create={"funcs": ["sum"], "size": SIZE},
                      device="cpu")
        stores.query("t")
        body, status = _Handler._stores("")
        assert status == 200
        payload = json.loads(body)
        rows = {r["store"]: r for r in payload["stores"]}
        assert rows["t"]["gen"] == 1 and rows["t"]["device"] == "cpu"
        assert "cost_by_store" in payload

    def test_gauges_track_table(self):
        from flox_tpu_torch.serve import stores

        stores.append("t", *_slabs(1)[0], create={"funcs": ["sum"], "size": SIZE},
                      device="cpu")
        g = METRICS.gauges()
        assert g["store.open_stores"] == 1.0 and g["store.state_bytes"] > 0
        stores.clear()
        assert METRICS.gauges()["store.open_stores"] == 0.0

    def test_cost_ledger_rows(self):
        from flox_tpu_torch.serve import stores

        with flox_tpu_torch.set_options(telemetry=True):
            stores.append("t", *_slabs(1)[0], create={"funcs": ["sum"], "size": SIZE},
                          device="cpu")
            stores.query("t")
            by_ds = telemetry.cost_by_dataset()
            by_prog = telemetry.cost_by_program()
        assert "t" in by_ds
        assert "store.append[fused[sum]]" in by_prog and "store.query[fused[sum]]" in by_prog


class TestProtocol:
    """append/query/compact/list_stores over ``python -m
    flox_tpu_torch.serve --device cpu``, typed error payloads included."""

    def test_line_protocol(self, tmp_path):
        lines = [
            {"id": "1", "op": "append", "store": "s1", "codes": [0, 1, 1, 2],
             "array": [1.0, 2.0, 3.0, 4.0], "create": {"funcs": ["sum", "count"], "size": 4}},
            {"id": "2", "op": "append", "store": "s1", "codes": [0, 1, 1, 2],
             "array": [1.0, 2.0, 3.0, 4.0]},
            {"id": "3", "op": "query", "store": "s1"},
            {"id": "4", "op": "compact", "store": "s1"},
            {"id": "5", "op": "list_stores"},
            {"id": "6", "op": "query", "store": "missing"},
        ]
        env = dict(os.environ, FLOX_TPU_STORE_ROOT=str(tmp_path))
        env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
        out = subprocess.run(
            [sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu"],
            input="\n".join(json.dumps(line) for line in lines) + "\n",
            capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
        )
        assert out.returncode == 0, out.stderr
        got = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
        by_op = {}
        for g in got:
            by_op.setdefault(g["op"], []).append(g)
        assert [g["ack"] for g in by_op["append"]] == ["ingested", "slab_already_ingested"]
        queries = [g for g in by_op["query"] if g.get("ok")]
        assert queries[0]["result"]["sum"] == [1.0, 5.0, 4.0, 0.0]
        assert queries[0]["result"]["count"] == [1, 2, 1, 0]
        assert by_op["compact"][0]["ok"]
        assert any(r["store"] == "s1" for r in by_op["list_stores"][0]["stores"])
        err = [g for g in by_op["query"] if not g.get("ok")][0]
        assert err["code"] == "unknown_store"
        # the directory is the reference's format: flox_tpu reads it
        r = ref_store.IncrementalAggregationStore.open(str(tmp_path / "s1"))
        np.testing.assert_array_equal(r.query()["sum"], [1.0, 5.0, 4.0, 0.0])
