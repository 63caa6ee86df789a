"""The port's autotuner (flox_tpu_torch.autotune) against the reference's.

The reference's behaviours on the port: the store, its bands and EWMA, the
version and the decision fingerprint, persistence and the two-process warm
start, the wired decision points, the stream observations and picks, the
seeds and the regression sentinel, the options. Parity: the same
record/decide sequences give the same winners, versions and fingerprints in
both packages, and a store file written by either loads in the other with
the candidate names mapped. The port's own rules: seeds only from CUDA
records, a sweep swallows no exception, the engine family never leaves the
card, off is bit for bit the untuned dispatch, and one key is swept once
however many threads ask. The reference is called through its autotune
functions only, never through its dispatch path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import flox_tpu.options as ref_options
import flox_tpu_torch
from flox_tpu import autotune as ref_autotune, cache as ref_cache
from flox_tpu_torch import autotune, cache, core, costmodel, fusion, kernels, profiling
from flox_tpu_torch.options import from_reference, scoped, trace_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_store():
    with flox_tpu_torch.set_options(autotune=False, autotune_cache_path=None):
        cache.clear_all()
        yield
        cache.clear_all()


@pytest.fixture
def ref_store(monkeypatch):
    """The reference's store, emptied, marked loaded (no seeding from the
    repo's files), with its tuner switch flipped through its option dict."""
    ref_cache.clear_all()
    monkeypatch.setitem(ref_options.OPTIONS, "autotune_cache_path", None)
    monkeypatch.setitem(ref_options.OPTIONS, "autotune", False)
    ref_autotune._AUTOTUNE_STATE["loaded"] = True
    yield
    ref_cache.clear_all()


def _seed_segment_sum(winner="kernel", loser="scatter", **kw):
    keykw = dict(dtype="float32", ngroups=12, nelems=1 << 20)
    keykw.update(kw)
    autotune.record("segment_sum", winner, 50.0, **keykw)
    autotune.record("segment_sum", loser, 10.0, **keykw)
    return keykw


def _vals(shape=(3, 4096), seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


class TestStore:
    @pytest.mark.parametrize("kw", [
        dict(dtype="float32", ngroups=12, nelems=1 << 20),
        dict(dtype="float64", ngroups=15, nelems=(1 << 20) + 7),
        dict(dtype="bfloat16", ngroups=0, nelems=0),
        dict(dtype=None, ngroups=36524, nelems=215_482_368),
    ])
    def test_make_key_bands(self, kw):
        key = autotune.make_key("segment_sum", platform="cpu", **kw)
        assert key == ref_autotune.make_key("segment_sum", platform="cpu", **kw)
        assert autotune.make_key("segment_sum", platform="cpu", **dict(
            kw, dtype=getattr(torch, kw["dtype"]) if kw["dtype"] else None)) == key

    def test_known_key_and_neighbours(self):
        k = autotune.make_key("segment_sum", dtype="float32", ngroups=12, nelems=1 << 20,
                              platform="cpu")
        assert k == "segment_sum|cpu|float32|g4|e11"
        assert autotune.make_key("segment_sum", dtype=torch.float32, ngroups=15,
                                 nelems=(1 << 20) + 7, platform="cpu") == k
        assert autotune.make_key("segment_sum", dtype="float32", ngroups=12, nelems=1 << 28,
                                 platform="cpu") != k
        # the platform is the data's device
        assert autotune.platform_of("cpu") == "cpu"
        assert autotune.platform_of(torch.device("cuda", 0)) == "cuda"

    def test_record_then_decide(self):
        kw = _seed_segment_sum()
        assert autotune.decide("segment_sum", "scatter", ["scatter", "kernel"], **kw) == "scatter"
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.decide("segment_sum", "scatter", ["scatter", "kernel"],
                                   **kw) == "kernel"

    def test_decide_restricted_to_eligible_candidates(self):
        kw = _seed_segment_sum()
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.decide("segment_sum", "scatter", ["scatter"], **kw) == "scatter"
            # a candidate the port lacks never wins
            autotune.record("segment_sum", "matmul", 999.0, **kw)
            assert autotune.decide("segment_sum", "scatter", ["scatter", "kernel"],
                                   **kw) == "kernel"

    def test_nearest_band_lookup_with_tolerance(self):
        _seed_segment_sum(nelems=1 << 20)
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.decide("segment_sum", "scatter", ["scatter", "kernel"],
                                   dtype="float32", ngroups=12, nelems=1 << 22) == "kernel"
            autotune.record("engine", "numpy", 99.0, dtype="float64", nelems=1 << 8)
            autotune.record("engine", "torch", 1.0, dtype="float64", nelems=1 << 8)
            assert autotune.decide("engine", "torch", ["numpy", "torch"], dtype="float64",
                                   nelems=1 << 24) == "torch"

    def test_highcard_group_band_tolerance(self):
        autotune.record("highcard", "sort", 99.0, dtype="float32", ngroups=1 << 20,
                        nelems=1 << 16)
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.decide("highcard", "dense", ("dense", "sort"), dtype="float32",
                                   ngroups=1 << 19, nelems=1 << 16) == "sort"
            assert autotune.decide("highcard", "dense", ("dense", "sort"), dtype="float32",
                                   ngroups=1 << 14, nelems=1 << 16) == "dense"

    def test_ewma_flips_winner_and_bumps_version(self):
        kw = dict(dtype="float32", ngroups=12, nelems=1 << 20)
        autotune.record("segment_sum", "scatter", 10.0, **kw)
        with flox_tpu_torch.set_options(autotune=True):
            v0 = autotune.decision_fingerprint()
            autotune.record("segment_sum", "kernel", 50.0, **kw)
            v1 = autotune.decision_fingerprint()
            assert v1 != v0
            autotune.record("segment_sum", "kernel", 60.0, **kw)
            assert autotune.decision_fingerprint() == v1

    def test_fingerprint_constant_when_disabled(self):
        fp0 = autotune.decision_fingerprint()
        _seed_segment_sum()
        assert autotune.decision_fingerprint() == fp0 == (False,)
        assert trace_fingerprint()[-1] == (False,)

    def test_flip_changes_the_dispatcher_program_key(self):
        kw = dict(dtype="float32", ngroups=12, nelems=1 << 20)
        with flox_tpu_torch.set_options(autotune=True):
            autotune.record("segment_sum", "scatter", 10.0, **kw)
            before = trace_fingerprint()
            autotune.record("segment_sum", "kernel", 50.0, **kw)
            assert trace_fingerprint() != before

    def test_clear_all_resets_in_memory_store(self):
        kw = _seed_segment_sum()
        assert cache.stats()["autotune"] > 0
        cache.clear_all()
        assert cache.stats()["autotune"] == 0
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.decide("segment_sum", "scatter", ["scatter", "kernel"],
                                   **kw) == "scatter"
        assert autotune.decision_record()["sweeps"] == 0
        assert not autotune._AUTOTUNE_STATE.get("attempted")

    def test_invalid_gbps_is_ignored(self):
        autotune.record("segment_sum", "kernel", 0.0, nelems=1 << 20)
        autotune.record("segment_sum", "kernel", -1.0, nelems=1 << 20)
        autotune.record("segment_sum", "kernel", float("nan"), nelems=1 << 20)
        assert cache.stats()["autotune"] == 0


#: record/decide sequences replayed on both packages; names in the port's
#: spelling, mapped to the reference's for its replay
SEQUENCES = {
    "flip": [("r", "segment_sum", "scatter", 10.0, 12, 1 << 20),
             ("d", "segment_sum", "scatter", ("scatter", "kernel"), 12, 1 << 20),
             ("r", "segment_sum", "kernel", 50.0, 12, 1 << 20),
             ("d", "segment_sum", "scatter", ("scatter", "kernel"), 12, 1 << 20),
             ("r", "segment_sum", "scatter", 200.0, 12, 1 << 20),
             ("r", "segment_sum", "scatter", 200.0, 12, 1 << 20),
             ("d", "segment_sum", "kernel", ("scatter", "kernel"), 14, 1 << 22)],
    "nearest": [("r", "quantile", "select", 30.0, 12, 1 << 16),
                ("r", "quantile", "sort", 20.0, 12, 1 << 28),
                ("d", "quantile", "sort", ("sort", "select"), 12, 1 << 18),
                ("d", "quantile", "sort", ("sort", "select"), 12, 1 << 26),
                ("d", "quantile", "sort", ("sort", "select"), 12, 1 << 60)],
    "engine": [("r", "engine", "numpy", 9.0, 0, 512),
               ("r", "engine", "torch", 3.0, 0, 512),
               ("d", "engine", "torch", ("numpy", "torch"), 0, 600),
               ("d", "engine", "torch", ("numpy", "torch"), 0, 1 << 20),
               ("r", "engine", "torch", 90.0, 0, 512),
               ("d", "engine", "torch", ("numpy", "torch"), 0, 512)],
    "highcard": [("r", "highcard", "dense", 5.0, 1 << 20, 1 << 16),
                 ("r", "highcard", "sort", 7.0, 1 << 20, 1 << 16),
                 ("d", "highcard", "dense", ("dense", "sort"), 1 << 19, 1 << 20),
                 ("d", "highcard", "dense", ("dense", "sort"), 1 << 10, 1 << 16)],
}
_TO_REF = {"kernel": "pallas", "torch": "jax"}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_sequences_same_winners_versions_fingerprints(name, ref_store, monkeypatch):
    autotune._AUTOTUNE_STATE["loaded"] = True
    monkeypatch.setitem(ref_options.OPTIONS, "autotune", True)
    got, want = [], []
    with flox_tpu_torch.set_options(autotune=True):
        for step in SEQUENCES[name]:
            kind, family, a, b, ngroups, nelems = step
            kw = dict(dtype="float32", ngroups=ngroups, nelems=nelems, platform="cpu")
            if kind == "r":
                autotune.record(family, a, b, **kw)
                ref_autotune.record(family, _TO_REF.get(a, a), b, **kw)
            else:
                kw.pop("platform")
                got.append(autotune.decide(family, a, b, platform="cpu", **kw))
                ref = ref_autotune.decide(family, _TO_REF.get(a, a),
                                          [_TO_REF.get(c, c) for c in b], **kw)
                want.append({v: k for k, v in _TO_REF.items()}.get(ref, ref))
            got.append(autotune.decision_fingerprint())
            want.append(ref_autotune.decision_fingerprint())
    assert got == want
    assert autotune._AUTOTUNE_STATE.get("version") == ref_autotune._AUTOTUNE_STATE.get("version")


class TestPersistence:
    def test_round_trip_same_decision(self, tmp_path):
        kw = _seed_segment_sum()
        path = str(tmp_path / "autotune.json")
        assert autotune.save(path) == path
        cache.clear_all()
        with flox_tpu_torch.set_options(autotune=True, autotune_cache_path=path):
            assert autotune.decide("segment_sum", "scatter", ["scatter", "kernel"],
                                   **kw) == "kernel"

    def test_save_is_atomic_no_tmp_left_behind(self, tmp_path):
        _seed_segment_sum()
        path = str(tmp_path / "store" / "autotune.json")
        autotune.save(path)
        assert json.load(open(path))["records"]
        assert [f for f in os.listdir(tmp_path / "store") if f != "autotune.json"] == []

    @pytest.mark.parametrize(
        "content",
        ["{truncated", '{"version": 999, "records": {}}', '{"version": 1}', "[1, 2]"],
        ids=["corrupt", "alien-version", "partial", "wrong-type"],
    )
    def test_corrupt_cache_falls_back_with_warning(self, tmp_path, content):
        path = str(tmp_path / "autotune.json")
        with open(path, "w") as f:
            f.write(content)
        with flox_tpu_torch.set_options(autotune=True, autotune_cache_path=path):
            with pytest.warns(RuntimeWarning, match="falling back to heuristics"):
                chosen = autotune.decide("segment_sum", "scatter", ["scatter", "kernel"],
                                         dtype="float32", ngroups=12, nelems=1 << 20)
        assert chosen == "scatter"

    def test_missing_cache_file_is_silent(self, tmp_path):
        import warnings

        path = str(tmp_path / "never-written.json")
        with flox_tpu_torch.set_options(autotune=True, autotune_cache_path=path):
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                autotune.decide("segment_sum", "scatter", ["scatter"], dtype="float32",
                                ngroups=12, nelems=1 << 20)

    def test_second_process_decides_without_resweeping(self, tmp_path):
        kw = _seed_segment_sum()
        path = str(tmp_path / "autotune.json")
        autotune.save(path)
        cache.clear_all()
        with flox_tpu_torch.set_options(autotune=True, autotune_cache_path=path):
            chosen = autotune.decide("segment_sum", "scatter", ["scatter", "kernel"], **kw)
            rec = autotune.decision_record()
        assert chosen == "kernel"
        assert rec["sweeps"] == 0 and rec["cache_hits"] >= 1

    def test_cross_process_cache_hits(self, tmp_path):
        """Two real processes on one cache file: the first sweeps, the second
        serves every decision from the file, and the results agree bit for
        bit."""
        path = str(tmp_path / "autotune.json")
        code = (
            "import json, numpy as np\n"
            "import flox_tpu_torch\n"
            "from flox_tpu_torch import autotune\n"
            "v = np.random.default_rng(0).normal(size=(4, 3000)).astype(np.float32)\n"
            "l = np.repeat(np.arange(5), 600)\n"
            "out, _ = flox_tpu_torch.groupby_reduce(v, l, func='nanmean', device='cpu')\n"
            "autotune.save()\n"
            "rec = autotune.decision_record()\n"
            "print(json.dumps({'sweeps': rec['sweeps'], 'hits': rec['cache_hits'],"
            " 'entries': rec['entries'], 'out': out.numpy().tolist()}))\n"
        )
        env = dict(os.environ, FLOX_TPU_AUTOTUNE="1", FLOX_TPU_AUTOTUNE_CACHE_PATH=path)
        env.pop("FLOX_TPU_TELEMETRY", None)
        outs = []
        for _ in range(2):
            proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                                  capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, proc.stderr
            outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        assert outs[0]["sweeps"] >= 1
        assert outs[1]["sweeps"] == 0
        assert outs[1]["entries"] >= outs[0]["entries"]
        assert outs[1]["hits"] >= 1
        assert outs[1]["out"] == outs[0]["out"]

    def test_save_merges_existing_disk_store(self, tmp_path):
        path = str(tmp_path / "autotune.json")
        _seed_segment_sum()
        autotune.save(path)
        cache.clear_all()
        autotune.record("stream_prefetch", "4", 10.0, nelems=1 << 20)
        autotune.save(path)
        families = {k.split("|")[0] for k in json.load(open(path))["records"]}
        assert families == {"segment_sum", "stream_prefetch"}

    def test_reference_store_file_loads_with_names_mapped(self, tmp_path, ref_store):
        path = str(tmp_path / "ref.json")
        kw = dict(dtype="float32", ngroups=12, nelems=1 << 20, platform="cpu")
        ref_autotune.record("segment_sum", "pallas", 80.0, **kw)
        ref_autotune.record("segment_sum", "matmul", 40.0, **kw)
        ref_autotune.record("segment_sum", "scatter", 20.0, **kw)
        ref_autotune.record("engine", "jax", 9.0, dtype="float64", nelems=512, platform="cpu")
        ref_autotune.record("engine", "numpy", 3.0, dtype="float64", nelems=512,
                            platform="cpu")
        assert ref_autotune.save(path) == path
        assert autotune.load(path)
        rec = autotune.lookup("segment_sum", **kw)
        assert set(rec["candidates"]) == {"kernel", "matmul", "scatter"}
        assert rec["candidates"]["kernel"]["gbps"] == 80.0
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.decide("segment_sum", "scatter", ("scatter", "kernel"),
                                   **kw) == "kernel"
            # matmul has no counterpart: never eligible
            assert autotune.decide("segment_sum", "scatter", ("scatter",), **kw) == "scatter"
            assert autotune.decide("engine", "numpy", ("numpy", "torch"), dtype="float64",
                                   nelems=512, platform="cpu") == "torch"

    def test_port_store_file_loads_in_the_reference(self, tmp_path, ref_store):
        path = str(tmp_path / "port.json")
        _seed_segment_sum(platform="cpu")
        autotune.record("quantile", "select", 7.0, dtype="float32", ngroups=12,
                        nelems=1 << 20, platform="cpu")
        autotune.save(path)
        assert ref_autotune.load(path)
        assert set(ref_autotune._AUTOTUNE_CACHE) == set(autotune._AUTOTUNE_CACHE)

    def test_seed_defers_to_real_observations(self):
        kw = dict(dtype="float32", ngroups=12, nelems=1 << 20, platform="cuda")
        autotune.record("quantile", "sort", 5.0, source="observed", **kw)
        autotune.record("quantile", "select", 99.0, source="seed", **kw)
        assert list(autotune.lookup("quantile", **kw)["candidates"]) == ["sort"]


def _bench_record(platform):
    return {
        "platform": platform,
        "value": 800.0,
        "impl_sweep_gbps": {"scatter": 120.0, "matmul": 700.0, "pallas": 800.0},
        "quantile_gbps": {"sort": 90.0, "select": 300.0},
        "highcard": {"ngroups": 1 << 20, "nelems": 1 << 16, "dense_gbps": 3.0,
                     "sort_gbps": 9.0},
        "fused": {"fused_sweep_gbps": {"fused": 50.0, "sequential": 20.0}},
        "streaming": {"gbps_sync": 10.0, "gbps_prefetch": 20.0},
        "workload": {"nlat": 181, "nlon": 360, "ntime": 26304, "ngroups": 12},
    }


class TestSeedAndSentinel:
    def test_seed_on_the_repo_files_gives_zero_records(self):
        # every committed round is a JAX CPU fallback or a TPU sweep
        assert autotune.seed() == 0
        assert cache.stats()["autotune"] == 0

    def test_seed_keeps_only_cuda_records(self, tmp_path):
        with open(tmp_path / "BENCH_TPU_LAST.json", "w") as f:
            json.dump(_bench_record("tpu"), f)
        os.makedirs(tmp_path / "BENCH_HISTORY")
        with open(tmp_path / "BENCH_HISTORY" / "bench_runs.jsonl", "w") as f:
            f.write(json.dumps(_bench_record("cpu")) + "\n")
        assert autotune.seed(str(tmp_path)) == 0
        with open(tmp_path / "BENCH_HISTORY" / "bench_runs.jsonl", "a") as f:
            f.write(json.dumps(_bench_record("cuda")) + "\n")
        assert autotune.seed(str(tmp_path)) == 3 + 2 + 2 + 2
        assert all(k.split("|")[1] == "cuda" for k in autotune._AUTOTUNE_CACHE)
        rec = autotune.lookup("segment_sum", dtype="float32", ngroups=12,
                              nelems=181 * 360 * 26304, platform="cuda")
        assert set(rec["candidates"]) == {"scatter", "matmul", "kernel"}
        assert rec["source"] == "seed"

    def test_seed_not_suppressed_by_partial_disk_store(self, tmp_path, monkeypatch):
        autotune.record("stream_prefetch", "4", 10.0, nelems=1 << 20)
        path = str(tmp_path / "autotune.json")
        autotune.save(path)
        cache.clear_all()
        os.makedirs(tmp_path / "BENCH_HISTORY")
        with open(tmp_path / "BENCH_HISTORY" / "bench_runs.jsonl", "w") as f:
            f.write(json.dumps({"platform": "cuda", "impl_sweep_gbps": {"pallas": 9.0}}) + "\n")
        monkeypatch.setattr(autotune, "_repo_root", lambda: str(tmp_path))
        with flox_tpu_torch.set_options(autotune=True, autotune_cache_path=path):
            rec = autotune.decision_record()
        assert any(k.startswith("stream_prefetch|") for k in rec["winners"])
        assert [v for v in rec["winners"].values() if v["source"] == "seed"]

    def test_sentinel_flags_regression(self, tmp_path):
        hist = tmp_path / "bench_runs.jsonl"
        hist.write_text(json.dumps({"platform": "cuda", "value": 10.0,
                                    "impl_sweep_gbps": {"scatter": 10.0}}) + "\n")
        verdict = autotune.regression_sentinel({"headline": 8.0, "segment_sum[scatter]": 9.9},
                                               history_path=str(hist), platform="cuda")
        assert verdict["status"] == "regression" and verdict["regressed"] == ["headline"]
        assert verdict["families"]["segment_sum[scatter]"]["regressed"] is False

    def test_sentinel_ok_within_threshold(self, tmp_path):
        hist = tmp_path / "bench_runs.jsonl"
        hist.write_text(json.dumps({"platform": "cpu", "value": 10.0}) + "\n")
        assert autotune.regression_sentinel({"headline": 9.0}, history_path=str(hist),
                                            platform="cpu")["status"] == "ok"

    def test_sentinel_ignores_other_platform_rounds(self, tmp_path):
        hist = tmp_path / "bench_runs.jsonl"
        hist.write_text(json.dumps({"platform": "tpu", "value": 1000.0}) + "\n")
        verdict = autotune.regression_sentinel({"headline": 5.0}, history_path=str(hist),
                                               platform="cuda")
        assert verdict["status"] == "ok" and verdict["compared_against"] is None

    def test_sentinel_on_the_repo_history_finds_no_card_round(self):
        verdict = autotune.regression_sentinel({"headline": 1.0}, platform="cuda")
        assert verdict["compared_against"] is None
        assert verdict["families"]["headline"]["previous"] is None

    def test_sentinel_matches_workload(self, tmp_path):
        hist = tmp_path / "bench_runs.jsonl"
        full = {"nlat": 181, "nlon": 360, "ntime": 26304, "ngroups": 12}
        tiny = {"nlat": 4, "nlon": 16, "ntime": 2000, "ngroups": 12}
        hist.write_text(json.dumps({"platform": "cpu", "value": 10.0, "workload": full}) + "\n")
        assert autotune.regression_sentinel({"headline": 0.5}, history_path=str(hist),
                                            platform="cpu", workload=tiny)["status"] == "ok"
        assert autotune.regression_sentinel({"headline": 0.5}, history_path=str(hist),
                                            platform="cpu",
                                            workload=full)["status"] == "regression"

    def test_sentinel_equals_the_reference(self, tmp_path):
        hist = tmp_path / "bench_runs.jsonl"
        hist.write_text("".join(json.dumps(r) + "\n" for r in (
            {"platform": "cpu", "value": 10.0, "quantile_gbps": {"sort": 4.0}},
            {"platform": "cpu", "value": 12.0, "streaming": {"gbps_sync": 3.0}},
        )))
        current = {"headline": 9.0, "quantile[sort]": 1.0, "streaming[sync]": 3.0}
        for skip in (0, 1):
            assert autotune.regression_sentinel(
                current, history_path=str(hist), platform="cpu", skip_rounds=skip
            ) == ref_autotune.regression_sentinel(current, history_path=str(hist),
                                                  platform="cpu", skip_rounds=skip)

    def test_sentinel_missing_history_is_ok(self, tmp_path):
        assert autotune.regression_sentinel(
            {"headline": 5.0}, history_path=str(tmp_path / "nope.jsonl"),
            platform="cpu")["status"] == "ok"

    def test_sentinel_cli_report_only(self, capsys):
        assert autotune.main(["sentinel"]) == 0
        assert json.loads(capsys.readouterr().out)["status"] in ("ok", "regression")

    def test_report_cli(self, capsys):
        _seed_segment_sum()
        assert autotune.main(["report"]) == 0
        assert json.loads(capsys.readouterr().out)["entries"] == 1

    def test_compare_families_equals_the_reference(self):
        cur, prev = {"a": 5.0, "b": 10.0, "c": -1.0}, {"a": 10.0, "b": 9.0}
        assert autotune.compare_families(cur, prev) == ref_autotune.compare_families(cur, prev)


class TestDispatchWiring:
    def test_record_only_is_bit_identical(self):
        vals, codes = _vals(), np.arange(4096) % 7
        calls = [("nansum", {}), ("nanmean", {}),
                 ("nanquantile", {"finalize_kwargs": {"q": 0.9}})]

        def run():
            return [flox_tpu_torch.groupby_reduce(vals, codes, func=f, device=CPU, **kw)[0]
                    for f, kw in calls]

        baseline = run()
        for plat in ("cpu", "cuda"):
            autotune.record("segment_sum", "scatter", 99.0, dtype="float32", ngroups=7,
                            nelems=vals.size, platform=plat)
            autotune.record("quantile", "select", 99.0, dtype="float32", ngroups=7,
                            nelems=vals.size, platform=plat)
            autotune.record("engine", "numpy", 99.0, dtype="float32", nelems=vals.size,
                            platform=plat)
        for a, b in zip(baseline, run()):
            assert torch.equal(a, b)
        assert autotune.decision_record()["sweeps"] == 0

    def test_segment_sum_impl_consults_store(self):
        data = torch.zeros((8, 4096), dtype=torch.float32)
        assert kernels._segment_sum_impl(data, 12) == "kernel"
        autotune.record("segment_sum", "scatter", 99.0, dtype="float32", ngroups=12,
                        nelems=data.numel(), platform="cpu")
        assert kernels._segment_sum_impl(data, 12) == "kernel"  # still off
        with flox_tpu_torch.set_options(autotune=True):
            assert kernels._segment_sum_impl(data, 12) == "scatter"
            with flox_tpu_torch.set_options(segment_sum_impl="kernel"):
                assert kernels._segment_sum_impl(data, 12) == "kernel"

    def test_kernels_are_no_candidates_on_the_cpu(self):
        data = torch.zeros((8, 4096), dtype=torch.float32)
        autotune.record("segment_sum", "kernel", 99.0, dtype="float32", ngroups=12,
                        nelems=data.numel(), platform="cpu")
        autotune.record("segment_sum", "radixbin", 98.0, dtype="float32", ngroups=12,
                        nelems=data.numel(), platform="cpu")
        autotune.record("segment_sum", "scatter", 1.0, dtype="float32", ngroups=12,
                        nelems=data.numel(), platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            assert kernels._segment_sum_impl(data, 12) == "scatter"

    def test_quantile_choice_consults_store(self):
        data = torch.zeros((8, 4096), dtype=torch.float32)
        assert kernels._quantile_impl_choice(data, 12) == "sort"
        autotune.record("quantile", "select", 99.0, dtype="float32", ngroups=12,
                        nelems=data.numel(), platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            assert kernels._quantile_impl_choice(data, 12) == "select"
            with flox_tpu_torch.set_options(quantile_impl="sort"):
                assert kernels._quantile_impl_choice(data, 12) == "sort"

    def test_engine_choice_consults_store(self):
        arr = np.zeros(512, dtype=np.float64)
        assert core._tuned_engine("torch", arr, CPU) == "torch"
        autotune.record("engine", "numpy", 99.0, dtype="float64", nelems=512, platform="cpu")
        autotune.record("engine", "torch", 1.0, dtype="float64", nelems=512, platform="cpu")
        assert core._tuned_engine("torch", arr, CPU) == "torch"  # off
        with flox_tpu_torch.set_options(autotune=True):
            assert core._tuned_engine("torch", arr, CPU) == "numpy"
            # tensors are on their device already; default_engine pins
            assert core._tuned_engine("torch", torch.from_numpy(arr), CPU) == "torch"
            with flox_tpu_torch.set_options(default_engine="sort"):
                assert core._tuned_engine("torch", arr, CPU) == "torch"
            out, _ = flox_tpu_torch.groupby_reduce(np.arange(512.0), np.arange(512) % 4,
                                                   func="sum", device=CPU)
            # an explicit engine is never second-guessed
            ref, _ = flox_tpu_torch.groupby_reduce(np.arange(512.0), np.arange(512) % 4,
                                                   func="sum", device=CPU, engine="numpy")
        assert torch.equal(out, ref)

    @pytest.mark.parametrize("device", ["cuda", "cuda:0", None])
    def test_engine_family_never_picks_numpy_on_cuda(self, device):
        arr = np.zeros(512, dtype=np.float64)
        for plat in ("cpu", "cuda"):
            autotune.record("engine", "numpy", 99.0, dtype="float64", nelems=512,
                            platform=plat)
            autotune.record("engine", "torch", 1.0, dtype="float64", nelems=512,
                            platform=plat)
        with flox_tpu_torch.set_options(autotune=True):
            assert core._tuned_engine("torch", arr, device) == "torch"
            assert core._tuned_engine("torch", arr, CPU) == "numpy"
        assert autotune.decision_record()["sweeps"] == 0

    def test_autotuned_run_matches_heuristic_run_numerically(self):
        vals, codes = _vals((4, 2048), seed=1), np.arange(2048) % 5
        base, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device=CPU)
        autotune.record("segment_sum", "scatter", 99.0, dtype="float32", ngroups=5,
                        nelems=vals.size, platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            tuned, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device=CPU)
        np.testing.assert_allclose(base.numpy(), tuned.numpy(), rtol=1e-5, atol=1e-6)

    def test_engine_sweep_records_under_swept_band(self):
        with flox_tpu_torch.set_options(autotune=True):
            nelems = 10_000_000
            autotune.prime_engine("float64", nelems)
            assert autotune.lookup("engine", dtype="float64", nelems=nelems,
                                   platform="cpu") is None
            in_band = autotune._SWEEP_ENGINE_N_MAX
            autotune.prime_engine("float64", in_band)
            assert autotune.make_key("engine", dtype="float64", nelems=in_band,
                                     platform="cpu") in autotune._AUTOTUNE_CACHE
            rec = autotune.lookup("engine", dtype="float64", nelems=in_band, platform="cpu")
            assert set(rec["candidates"]) == {"numpy", "torch"}

    def test_prime_reduce_sweeps_once_per_key(self):
        # a tensor: host arrays on the CPU would consult the engine family too
        vals, codes = torch.from_numpy(_vals((4, 3000))), np.repeat(np.arange(5), 600)
        with flox_tpu_torch.set_options(autotune=True):
            flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device=CPU)
            s1 = autotune.decision_record()["sweeps"]
            assert s1 >= 1
            flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device=CPU)
            assert autotune.decision_record()["sweeps"] == s1
        # on the CPU only index_add_ is a segment-sum candidate
        key = autotune.make_key("segment_sum", dtype="float32", ngroups=5,
                                nelems=vals.numel(), platform="cpu")
        assert set(autotune._AUTOTUNE_CACHE[key]["candidates"]) == {"scatter"}

    def test_quantile_sweep_times_sort_and_select(self):
        vals, codes = torch.from_numpy(_vals((4, 3000))), np.repeat(np.arange(5), 600)
        with flox_tpu_torch.set_options(autotune=True):
            got, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmedian", device=CPU)
        key = autotune.make_key("quantile", dtype="float32", ngroups=5, nelems=vals.numel(),
                                platform="cpu")
        assert set(autotune._AUTOTUNE_CACHE[key]["candidates"]) == {"sort", "select"}
        want, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmedian", device=CPU)
        assert torch.equal(got, want)  # the median selects: both lowerings are exact

    def test_sweep_swallows_no_exception(self, monkeypatch):
        def broken(*args, **kwargs):
            raise RuntimeError("kernel failed to launch")

        vals, codes = _vals((4, 3000)), np.repeat(np.arange(5), 600)
        monkeypatch.setattr(kernels, "generic_kernel", broken)
        with flox_tpu_torch.set_options(autotune=True):
            with pytest.raises(RuntimeError, match="failed to launch"):
                flox_tpu_torch.groupby_reduce(vals, codes, func="nansum", device=CPU)
            assert not autotune._AUTOTUNE_STATE.get("in_sweep")
            assert autotune.decision_record()["sweeps"] == 1

    def test_raising_candidate_propagates_out_of_the_sweep(self):
        def runner(cand):
            if cand == "kernel":
                def run():
                    raise RuntimeError("nvcc failed")
                return run
            return lambda: None

        with flox_tpu_torch.set_options(autotune=True):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                autotune._sweep("segment_sum", ("scatter", "kernel"), runner, 1 << 20,
                                dtype="float32", ngroups=12, nelems=1 << 20, device=CPU)
        assert not autotune._AUTOTUNE_STATE.get("in_sweep")

    def test_rerouted_candidate_is_not_timed(self):
        with flox_tpu_torch.set_options(autotune=True):
            autotune._sweep("segment_sum", ("scatter", "kernel"),
                            lambda c: (lambda: None) if c == "scatter" else None, 1 << 20,
                            dtype="float32", ngroups=12, nelems=1 << 20, device=CPU)
        rec = autotune.lookup("segment_sum", dtype="float32", ngroups=12, nelems=1 << 20,
                              platform="cpu")
        assert set(rec["candidates"]) == {"scatter"}

    def test_two_threads_sweep_one_key_once(self, monkeypatch):
        calls = []
        real = autotune._sweep_segment_sum

        def slow(*args, **kwargs):
            calls.append(args)
            time.sleep(0.2)
            return real(*args, **kwargs)

        monkeypatch.setattr(autotune, "_sweep_segment_sum", slow)
        barrier, errors = threading.Barrier(4), []

        def worker():
            try:
                barrier.wait(timeout=10)
                with flox_tpu_torch.set_options(autotune=True):
                    pass
                autotune.prime_reduce("nansum", "float32", 12, 1 << 20, CPU)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        with flox_tpu_torch.set_options(autotune=True):
            threads = [threading.Thread(target=worker) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        assert not errors and len(calls) == 1
        assert autotune.decision_record()["sweeps"] == 1

    def test_sweep_option_flips_stay_in_the_calling_context(self):
        seen = {}

        def runner(cand):
            def run():
                seen[cand] = flox_tpu_torch.OPTIONS["segment_sum_impl"]
                t = threading.Thread(target=lambda: seen.setdefault(
                    f"{cand}-other", flox_tpu_torch.OPTIONS["segment_sum_impl"]))
                t.start()
                t.join()
            return lambda: _scoped_call(cand, run)

        def _scoped_call(cand, run):
            with scoped(segment_sum_impl=cand):
                run()

        with flox_tpu_torch.set_options(autotune=True):
            autotune._sweep("segment_sum", ("scatter", "kernel"), runner, 1 << 20,
                            dtype="float32", ngroups=12, nelems=1 << 20, device=CPU)
        assert seen["scatter"] == "scatter" and seen["kernel"] == "kernel"
        assert seen["scatter-other"] == seen["kernel-other"] == "auto"
        assert flox_tpu_torch.OPTIONS["segment_sum_impl"] == "auto"

    def test_sweep_budget_bounds_sweeps(self, monkeypatch):
        monkeypatch.setattr(autotune, "_SWEEP_BUDGET", 2)
        with flox_tpu_torch.set_options(autotune=True):
            for n in (16, 1 << 18, 1 << 32, 1 << 46):  # element bands 7 apart
                autotune.prime_reduce("nansum", "float32", 12, n, CPU)
        assert autotune.decision_record()["sweeps"] == 2

    def test_highcard_family_consults_store(self):
        vals = torch.from_numpy(_vals((2, 4096)))
        codes = (np.arange(4096) * 37) % 70000
        kw = dict(expected_groups=np.arange(70000), func="nansum", device=CPU)
        off, _ = flox_tpu_torch.groupby_reduce(vals, codes, **kw)
        autotune.record("highcard", "dense", 99.0, dtype="float32", ngroups=70000,
                        nelems=vals.numel(), platform="cpu")
        autotune.record("highcard", "sort", 1.0, dtype="float32", ngroups=70000,
                        nelems=vals.numel(), platform="cpu")
        arr = vals
        agg = flox_tpu_torch.aggregations._initialize_aggregation(
            "nansum", None, arr.dtype, None, 0, None)
        route = [core._route_highcard("torch", codes, arr, (2,), 70000, agg, explicit=False)]
        with flox_tpu_torch.set_options(autotune=True):
            route.append(core._route_highcard("torch", codes, arr, (2,), 70000, agg,
                                              explicit=False))
            tuned, _ = flox_tpu_torch.groupby_reduce(vals, codes, **kw)
        assert route == ["sort", "torch"]
        np.testing.assert_allclose(tuned.numpy(), off.numpy(), rtol=1e-6, atol=1e-6)

    def test_highcard_sweep_runs_both_engines(self):
        vals = torch.from_numpy(_vals((2, 4096)))
        codes = (np.arange(4096) * 37) % 70000
        with flox_tpu_torch.set_options(autotune=True):
            flox_tpu_torch.groupby_reduce(vals, codes, expected_groups=np.arange(70000),
                                          func="nansum", device=CPU)
        keys = [k for k in autotune._AUTOTUNE_CACHE if k.startswith("highcard|cpu|float32")]
        assert len(keys) == 1
        assert set(autotune._AUTOTUNE_CACHE[keys[0]]["candidates"]) == {"dense", "sort"}

    def test_fused_family_sequential_branch(self):
        vals, codes = torch.from_numpy(_vals((3, 1000))), np.arange(1000) % 9
        funcs = ("nanmean", "nanmax", "count")
        fused, groups = flox_tpu_torch.groupby_aggregate_many(vals, codes, funcs=funcs,
                                                              device=CPU)
        autotune.record("fused", "sequential", 99.0, dtype="float32", ngroups=9,
                        nelems=vals.numel(), platform="cpu")
        autotune.record("fused", "fused", 1.0, dtype="float32", ngroups=9,
                        nelems=vals.numel(), platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            seq, sgroups = flox_tpu_torch.groupby_aggregate_many(vals, codes, funcs=funcs,
                                                                 device=CPU)
            # the sequential branch is one groupby_reduce per statistic (whose
            # own segment-sum choice the tuner makes: index_add_ on the CPU)
            for f in funcs:
                assert torch.equal(seq[f], flox_tpu_torch.groupby_reduce(
                    vals, codes, func=f, device=CPU, engine="torch")[0]), f
        assert list(seq) == list(funcs)
        for f in funcs:
            np.testing.assert_allclose(seq[f].numpy(), fused[f].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(sgroups, groups)

    @pytest.mark.parametrize("device_type, kernel_ok, radixbin_ok, want", [
        ("cuda", True, True, ["kernel", "radixbin"]),
        ("cuda", False, True, ["radixbin"]),
        ("cuda", False, False, ["scatter"]),
        ("cpu", True, True, ["scatter"]),
    ])
    def test_segment_sum_candidates_never_leave_the_kernels_on_cuda(
            self, device_type, kernel_ok, radixbin_ok, want):
        assert kernels._tuned_sum_candidates(device_type, kernel_ok, radixbin_ok) == want
        key = dict(dtype="float32", ngroups=12, nelems=1 << 20, platform=device_type)
        autotune.record("segment_sum", "scatter", 99.0, **key)
        autotune.record("segment_sum", "radixbin", 5.0, **key)
        autotune.record("segment_sum", "kernel", 1.0, **key)
        fallback = "kernel" if kernel_ok else "radixbin" if radixbin_ok else "scatter"
        with flox_tpu_torch.set_options(autotune=True):
            got = autotune.decide("segment_sum", fallback, want, **key)
        # the store's fastest eligible candidate: never index_add_ where a
        # kernel's guards pass on the card
        assert got == ("radixbin" if "radixbin" in want else want[0])

    @pytest.mark.parametrize("heuristic, func, size, device_type, want", [
        ("sort", "nanmean", 36524, "cuda", ("sort",)),  # dense would be index_add_
        ("sort", "nanmean", 10000, "cuda", ("dense", "sort")),  # both on the kernels
        ("dense", "nanmean", 36524, "cuda", ("dense", "sort")),  # a move to sort is safe
        ("sort", "nanmax", 1000, "cuda", ("sort",)),  # past the extrema kernel's 128
        ("sort", "prod", 1000, "cuda", ("sort",)),  # no kernel known: stay
        ("sort", "nanmean", 36524, "cpu", ("dense", "sort")),
    ])
    def test_highcard_candidates_never_leave_the_kernels_on_cuda(
            self, heuristic, func, size, device_type, want):
        agg = flox_tpu_torch.aggregations._initialize_aggregation(
            func, None, torch.float32, None, 0, None)
        assert core._highcard_candidates(heuristic, agg, torch.float32, size,
                                         device_type) == want

    def test_fused_family_is_not_asked_on_a_mesh(self):
        arr = torch.zeros((3, 1000))
        autotune.record("fused", "sequential", 99.0, dtype="float32", ngroups=9,
                        nelems=arr.numel(), platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            assert fusion._fused_loses("torch", arr, 9)
            assert not fusion._fused_loses("torch", arr, 9, mesh=object())

    def test_mesh_ranks_agree_on_tuned_choices(self, tmp_path):
        import torch_mesh_world as W

        outs = W.run_world(["tuned-ranks"], str(tmp_path), world=2, deadline_s=120,
                           timeout_s=30)
        got = [o["tuned-ranks"] for o in outs]
        assert all(g[0] == "ok" for g in got), got
        (r0, r1) = (g[1] for g in got)
        # each rank picked from its own store ...
        assert r0[-1].tolist() == [1 << 16, 0] and r1[-1].tolist() == [1 << 18, 1]
        # ... and every rank ran the same stream and the same fused pass
        for a, b in zip(r0[:-1], r1[:-1]):
            assert a.tobytes() == b.tobytes()
        tuned, untuned, mean_on, max_on, mean_off, max_off = r0[:-1]
        assert tuned.tobytes() == untuned.tobytes()
        assert mean_on.tobytes() == mean_off.tobytes() and max_on.tobytes() == max_off.tobytes()

    def test_prior_is_unavailable_on_the_cpu(self):
        with flox_tpu_torch.set_options(telemetry=True, costmodel=True):
            assert costmodel.analytic_prior("fused", "sequential", ("fused", "sequential"),
                                            platform="cpu") is None
            with flox_tpu_torch.set_options(autotune=True):
                assert autotune.decide("fused", "sequential", ("fused", "sequential"),
                                       dtype="float32", ngroups=9, nelems=1000,
                                       platform="cpu") == "sequential"


class TestStreaming:
    def _data(self, shape=(8, 4000)):
        return _vals(shape), (np.arange(shape[1]) // 300) % 12

    def test_stream_reports_feed_the_store_record_only(self):
        data, month = self._data()
        flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean", batch_len=1000,
                                                device=CPU)
        prefixes = {k.split("|")[0] for k in autotune.decision_record()["winners"]}
        assert {"stream_prefetch", "stream_slab"} <= prefixes
        assert all(k.split("|")[1] == "cpu" for k in autotune._AUTOTUNE_CACHE)

    def test_streaming_autotuned_matches_heuristic(self):
        data, month = self._data()
        base = flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean",
                                                       device=CPU)[0]
        with flox_tpu_torch.set_options(autotune=True):
            tuned = flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean",
                                                            device=CPU)[0]
        # the first pass recorded its one slab's band (2^16 bytes), which the
        # tuned pass then picks: two slabs, folded in another order
        np.testing.assert_allclose(base.numpy(), tuned.numpy(), rtol=1e-5, atol=1e-6)

    def test_pick_stream_prefetch_identity_without_records(self):
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.pick_stream_prefetch(2, nelems=1 << 20) == 2

    def test_pick_stream_batch_bytes_identity_without_records(self):
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.pick_stream_batch_bytes(256 * 2**20, nelems=1 << 30) == 256 * 2**20

    def test_pick_stream_prefetch_serves_recorded_winner(self):
        autotune.record("stream_prefetch", "4", 10.0, nelems=1 << 20, platform="cpu")
        autotune.record("stream_prefetch", "2", 1.0, nelems=1 << 20, platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            assert autotune.pick_stream_prefetch(2, nelems=1 << 20, platform="cpu") == 4
            assert autotune.pick_stream_prefetch(2, nelems=1 << 20, platform="cuda") == 2

    def test_tuned_prefetch_reaches_the_stream(self):
        data, month = self._data((4, 4000))
        autotune.record("stream_prefetch", "0", 99.0, nelems=data.size, platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            with profiling.stream_monitor() as reports:
                flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean",
                                                        batch_len=997, device=CPU)
        assert reports[0].prefetch == 0

    def test_explicit_stream_prefetch_is_never_adapted(self):
        data, month = self._data((4, 4000))
        autotune.record("stream_prefetch", "0", 99.0, nelems=data.size, platform="cpu")
        with flox_tpu_torch.set_options(autotune=True, stream_prefetch=2):
            with profiling.stream_monitor() as reports:
                flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean",
                                                        batch_len=997, device=CPU)
        assert reports[0].prefetch == 2

    def test_explicit_batch_bytes_is_never_adapted(self):
        data, month = self._data((64, 20000))
        autotune.record("stream_slab", "2^16", 99.0, nelems=data.size, platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            with profiling.stream_monitor() as reports:
                flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean",
                                                        batch_bytes=256 * 2**20, device=CPU)
        assert len(reports[0].slabs) == 1

    def test_checkpoint_path_pins_stream_slab_sizing(self, tmp_path):
        data, month = self._data((64, 20000))
        autotune.record("stream_slab", "2^16", 99.0, nelems=data.size, platform="cpu")
        with flox_tpu_torch.set_options(autotune=True):
            with profiling.stream_monitor() as adapted:
                flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean",
                                                        device=CPU)
        with flox_tpu_torch.set_options(autotune=True,
                                        stream_checkpoint_path=str(tmp_path / "ckpt.npz")):
            with profiling.stream_monitor() as pinned:
                flox_tpu_torch.streaming_groupby_reduce(data, month, func="nanmean",
                                                        device=CPU)
        assert len(adapted[0].slabs) > len(pinned[0].slabs) == 1


class TestOptions:
    def test_validated_at_set_time(self):
        for bad in ({"autotune": 1}, {"autotune_cache_path": ""}, {"slo_path": ""},
                    {"slo_canary_interval": -1.0}, {"slo_canary_interval": 7200.0},
                    {"fleet_port": 70000}, {"fleet_scrape_interval": 0.01},
                    {"fleet_replicas": ""}):
            with pytest.raises(ValueError):
                flox_tpu_torch.set_options(**bad)

    def test_env_mirrors_seed_defaults(self):
        code = (
            "from flox_tpu_torch.options import OPTIONS\n"
            "assert OPTIONS['autotune'] is True\n"
            "assert OPTIONS['autotune_cache_path'] == '/tmp/at.json'\n"
            "assert OPTIONS['slo_canary_interval'] == 1.5\n"
            "assert OPTIONS['fleet_port'] == 9100\n"
            "assert OPTIONS['fleet_scrape_interval'] == 2.0\n"
            "assert OPTIONS['slo_path'] is None\n"
            "print('ok')\n"
        )
        env = dict(os.environ, FLOX_TPU_AUTOTUNE="1", FLOX_TPU_AUTOTUNE_CACHE_PATH="/tmp/at.json",
                   FLOX_TPU_SLO_CANARY_INTERVAL="1.5", FLOX_TPU_FLEET_PORT="9100",
                   FLOX_TPU_FLEET_SCRAPE_INTERVAL="0.001")
        env.pop("FLOX_TPU_SLO_PATH", None)
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "ok" in proc.stdout

    def test_from_reference_carries_the_new_options(self):
        opts = dict(ref_options.OPTIONS, autotune=True, autotune_cache_path="/tmp/x.json",
                    slo_canary_interval=0.5, fleet_port=9200, fleet_replicas="a=http://x:1",
                    slo_path="/tmp/slo.json", fleet_scrape_interval=0.5)
        got = from_reference(opts)
        for key in ("autotune", "autotune_cache_path", "slo_canary_interval", "fleet_port",
                    "fleet_replicas", "slo_path", "fleet_scrape_interval"):
            assert got[key] == opts[key], key
        with flox_tpu_torch.set_options(**got):
            assert flox_tpu_torch.OPTIONS["autotune"] is True
        # the reference's keys the port keeps no counterpart of
        assert set(ref_options.OPTIONS) - set(flox_tpu_torch.OPTIONS) == {
            "matmul_block_bytes", "matmul_num_groups_max", "numpy_engine_max_elems",
            "rechunk_blockwise_chunk_size_threshold", "rechunk_blockwise_num_chunks_threshold"}

    def test_report_cli_module(self, tmp_path):
        path = str(tmp_path / "store.json")
        _seed_segment_sum()
        autotune.save(path)
        proc = subprocess.run([sys.executable, "-m", "flox_tpu_torch.autotune", "report",
                               "--path", path], cwd=REPO, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout)
        assert out["entries"] == 1
        assert list(out["winners"].values())[0]["winner"] == "kernel"
