"""The port's resident dataset registry (``flox_tpu_torch.serve.registry``)
held against flox_tpu's (``tests/test_serve_registry.py``'s cases).

A registry-referenced request answers bit for bit the same data submitted
inline (dense and sort engines, row and mask selectors, fused statistic
sets), and equal to the reference registry's answer; a hit skips factorize,
the host-to-device copy and payload hashing; the budget evicts the stalest
unpinned entry; unknown names are typed errors; restaging after a device
loss answers the same bits; the sharding decision follows the threshold,
the world size and divisibility alone. Every put and dispatch here names
the CPU.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flox_tpu
import flox_tpu_torch
from flox_tpu_torch import cache, telemetry
from flox_tpu_torch.factorize import Prefactorized, prefactorize
from flox_tpu_torch.serve import AggregationRequest, UnknownDatasetError, aot, registry
from flox_tpu_torch.serve import Dispatcher as _Dispatcher
from flox_tpu_torch.telemetry import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state():
    with flox_tpu_torch.set_options(serve_aot_dir=None):
        cache.clear_all()
        yield
        cache.clear_all()
        aot.deconfigure()


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def Dispatcher(**kw):
    return _Dispatcher(device="cpu", **kw)


def put(name, array=None, by=None, **kw):
    return registry.put(name, array, by, device="cpu", **kw)


def groupby_reduce(*a, **kw):
    return flox_tpu_torch.groupby_reduce(*a, device="cpu", **kw)


def _payload(n=256, ngroups=7, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n).astype(dtype), rng.integers(0, ngroups, size=n)


async def _one(d, **kw):
    return await d.submit(AggregationRequest(**kw))


def _submit(**kw):
    async def main():
        d = Dispatcher()
        try:
            return await _one(d, **kw)
        finally:
            await d.close()

    return run(main())


def _ref_submit(name, values, labels, **kw):
    """The reference registry's answer to the same request."""
    from flox_tpu.serve import Dispatcher as RefDispatcher, registry as ref_registry

    async def main():
        d = RefDispatcher()
        try:
            return await d.submit(dataset=name, **kw)
        finally:
            await d.close()

    with flox_tpu.set_options(serve_aot_dir=None):
        ref_registry.put(name, array=values, by=labels)
        try:
            return asyncio.run(main())
        finally:
            ref_registry.clear()


class TestBitIdentity:
    @pytest.mark.parametrize("engine", [None, "sort"])
    @pytest.mark.parametrize("func", ["sum", "nanmean", "max"])
    def test_registry_matches_inline(self, func, engine):
        values, labels = _payload()
        put("ds", values, labels)
        inline = _submit(func=func, array=values, by=labels, engine=engine)
        hit = _submit(func=func, dataset="ds", engine=engine)
        np.testing.assert_array_equal(hit.result, inline.result)
        np.testing.assert_array_equal(hit.groups, inline.groups)

    @pytest.mark.parametrize("func", ["sum", "nanmean", "max", ("sum", "mean", "max")])
    def test_registry_matches_reference_registry(self, func):
        values, labels = _payload()
        values[::13] = np.nan
        put("ds", values, labels)
        hit = _submit(func=func, dataset="ds")
        want = _ref_submit("ds", values, labels, func=func)
        np.testing.assert_array_equal(hit.groups, np.asarray(want.groups))
        got = hit.result if isinstance(hit.result, dict) else {"_": hit.result}
        ref = want.result if isinstance(want.result, dict) else {"_": want.result}
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-12, atol=1e-12)

    def test_row_range_selector(self):
        values, labels = _payload(n=512)
        put("ds", values, labels)
        universe = np.unique(labels)
        hit = _submit(func="sum", dataset="ds", rows=[64, 400])
        expect, egroups = groupby_reduce(values[64:400], labels[64:400], func="sum",
                                         expected_groups=universe)
        np.testing.assert_array_equal(hit.result, expect.numpy())
        np.testing.assert_array_equal(hit.groups, np.asarray(egroups))
        want = _ref_submit("ds", values, labels, func="sum", rows=[64, 400])
        np.testing.assert_allclose(hit.result, np.asarray(want.result), rtol=1e-12)

    def test_boolean_mask_selector(self):
        values, labels = _payload(n=512)
        put("ds", values, labels)
        mask = (np.arange(512) % 3) == 0
        hit = _submit(func="nanmean", dataset="ds", mask=mask.tolist())
        expect, _ = groupby_reduce(values[mask], labels[mask], func="nanmean",
                                   expected_groups=np.unique(labels))
        np.testing.assert_array_equal(hit.result, expect.numpy())

    def test_fused_multi_stat(self):
        values, labels = _payload()
        put("ds", values, labels)
        funcs = ("sum", "mean", "max")
        hit = _submit(func=list(funcs), dataset="ds")
        expect, _ = flox_tpu_torch.groupby_aggregate_many(values, labels, funcs=funcs,
                                                          device="cpu")
        for f in funcs:
            np.testing.assert_array_equal(hit.result[f], expect[f].numpy())

    def test_mesh_prefactorized_matches_raw(self):
        from flox_tpu_torch.parallel import make_mesh

        values, labels = _payload(n=264)
        mesh = make_mesh(device_type="cpu")
        raw, _ = groupby_reduce(values, labels, func="sum", method="map-reduce", mesh=mesh)
        pf = prefactorize(labels, device="cpu")
        assert isinstance(pf, Prefactorized)
        via_pf, _ = groupby_reduce(values, pf, func="sum", method="map-reduce", mesh=mesh)
        assert torch.equal(via_pf, raw)

    def test_labels_resident_inline_array(self):
        values, labels = _payload()
        put("labels-only", by=labels)
        hit = _submit(func="mean", dataset="labels-only", array=values)
        expect, _ = groupby_reduce(values, labels, func="mean")
        np.testing.assert_array_equal(hit.result, expect.numpy())

    def test_data_required_when_entry_has_none(self):
        _, labels = _payload()
        put("labels-only", by=labels)
        with pytest.raises(ValueError, match="holds no data array"):
            _submit(func="mean", dataset="labels-only")

    def test_resident_tensor_is_on_the_device(self):
        values, labels = _payload(dtype=np.float32)
        info = put("ds", values, labels)
        entry = registry.resolve("ds")
        assert isinstance(entry.data, torch.Tensor) and entry.data.dtype == torch.float32
        assert info["device"] == "cpu" and not info["sharded"]
        assert entry.pf.codes_dev is not None


class TestFastPath:
    def test_hit_skips_factorize_and_h2d(self):
        values, labels = _payload(n=1024)
        with flox_tpu_torch.set_options(telemetry=True):
            put("ds", values, labels)

            async def main():
                d = Dispatcher()
                try:
                    await _one(d, func="sum", dataset="ds")
                    telemetry.drain()
                    h2d0 = METRICS.get("bytes.h2d")
                    hits0 = METRICS.get("registry.hits")
                    await _one(d, func="sum", dataset="ds")
                    return ([r["name"] for r in telemetry.drain() if r.get("type") == "span"],
                            METRICS.get("bytes.h2d") - h2d0,
                            METRICS.get("registry.hits") - hits0)
                finally:
                    await d.close()

            span_names, h2d_delta, hits_delta = run(main())
        assert "factorize" not in span_names and "serve.execute" in span_names
        assert h2d_delta == 0
        assert hits_delta == 1

    def test_hit_path_never_hashes_payload(self, monkeypatch):
        from flox_tpu_torch.serve import dispatcher as dmod

        values, labels = _payload()
        put("ds", values, labels)
        calls = []
        real = dmod._digest_payload

        async def counting(arr):
            calls.append(arr.nbytes)
            return await real(arr)

        monkeypatch.setattr(dmod, "_digest_payload", counting)
        res = _submit(func="sum", dataset="ds")
        assert calls == []
        np.testing.assert_array_equal(res.result, groupby_reduce(values, labels, func="sum")[0])

    def test_inline_digest_memoized_per_request_object(self, monkeypatch):
        from flox_tpu_torch.serve import dispatcher as dmod

        values, labels = _payload()
        req = AggregationRequest(func="sum", array=values, by=labels)

        async def main():
            d = Dispatcher()
            try:
                await d.submit(req)
                assert getattr(req, "_payload_digests", None) is not None

                async def boom(arr):  # pragma: no cover - must not run
                    raise AssertionError("payload rehashed on resubmit")

                monkeypatch.setattr(dmod, "_digest_payload", boom)
                return await d.submit(req)
            finally:
                await d.close()

        np.testing.assert_array_equal(run(main()).result,
                                      groupby_reduce(values, labels, func="sum")[0])

    def test_registry_hits_coalesce(self):
        values, labels = _payload()
        put("ds", values, labels)
        K = 6

        async def main():
            d = Dispatcher()
            await _one(d, func="sum", dataset="ds")
            before = METRICS.get("serve.dispatches")
            results = await asyncio.gather(*[_one(d, func="sum", dataset="ds")
                                             for _ in range(K)])
            await d.close()
            return results, METRICS.get("serve.dispatches") - before

        results, dispatches = run(main())
        assert dispatches == 1
        for r in results[1:]:
            np.testing.assert_array_equal(r.result, results[0].result)
        assert registry.resolve("ds").pins == 0

    def test_aot_manifest_records_dataset_and_warms(self, tmp_path):
        values, labels = _payload()
        with flox_tpu_torch.set_options(serve_aot_dir=str(tmp_path)):
            put("ds", values, labels)
            _submit(func="sum", dataset="ds")
            mpath = aot.save_manifest()
            specs = list(json.loads(mpath.read_text())["programs"].values())
            assert any(s.get("dataset") == "ds" for s in specs)
            assert all(s["dtype"] == "float64" for s in specs)
            assert aot.warmup(device="cpu") >= 1

    def test_large_fingerprint_is_chunked_and_stable(self, monkeypatch):
        """A payload above the chunk size digests chunk by chunk on threads,
        with the same fingerprint every time and another for other bytes."""
        monkeypatch.setattr(registry, "_FINGERPRINT_CHUNK", 1024)
        values, labels = _payload(n=4096)
        a = registry._content_fingerprint(labels, values, None)
        assert a == registry._content_fingerprint(labels, values.copy(), None)
        other = values.copy()
        other[-1] += 1.0
        assert a != registry._content_fingerprint(labels, other, None)


class TestBudgetAndEviction:
    def test_lru_evicts_stalest_past_budget(self):
        values, labels = _payload(n=4096, dtype=np.float32)
        one_entry = put("a", values, labels)["nbytes"]
        with flox_tpu_torch.set_options(registry_budget_bytes=int(one_entry * 1.5)):
            ev0 = METRICS.get("registry.evictions")
            info = put("b", values + 1, labels)
            assert info["evicted"] == ["a"]
            assert METRICS.get("registry.evictions") - ev0 == 1
            with pytest.raises(UnknownDatasetError):
                registry.resolve("a")
            assert registry.resolve("b").name == "b"

    def test_pinned_entry_survives_eviction(self):
        values, labels = _payload(n=4096, dtype=np.float32)
        one_entry = put("a", values, labels)["nbytes"]
        entry_a = registry.resolve("a")
        registry.pin(entry_a)
        try:
            with flox_tpu_torch.set_options(registry_budget_bytes=int(one_entry * 1.5)):
                assert put("b", values + 1, labels)["evicted"] == []
            assert registry.resolve("a").name == "a"
        finally:
            registry.unpin(entry_a)
        with flox_tpu_torch.set_options(registry_budget_bytes=int(one_entry * 1.5)):
            registry.resolve("b")
            assert "a" in put("c", values + 2, labels)["evicted"]

    def test_budget_zero_is_unenforced(self):
        values, labels = _payload()
        with flox_tpu_torch.set_options(registry_budget_bytes=0):
            put("a", values, labels)
            info = put("b", values + 1, labels)
        assert info["evicted"] == []
        assert len(registry.list_datasets()) == 2

    def test_registry_knob_validation(self):
        for bad in ({"registry_budget_fraction": 0.0}, {"registry_budget_bytes": -1},
                    {"registry_shard_threshold_bytes": -5}):
            with pytest.raises(ValueError):
                flox_tpu_torch.set_options(**bad)

    def test_budget_without_a_card_is_the_byte_option(self):
        with flox_tpu_torch.set_options(registry_budget_bytes=12345):
            assert registry.budget_bytes() == (12345 if not torch.cuda.is_available()
                                               else registry.budget_bytes())


class TestSharding:
    """The sharding decision: the threshold, the world's size and
    divisibility alone."""

    @pytest.mark.parametrize("world,nbytes,length,want", [
        (1, 2 << 30, 26304, 1),      # one rank: never sharded
        (4, 2 << 30, 26304, 4),      # above the threshold, divisible
        (4, 2 << 30, 26305, 1),      # not divisible
        (4, 1 << 20, 26304, 1),      # below the threshold
    ])
    def test_shard_count(self, monkeypatch, world, nbytes, length, want):
        from flox_tpu_torch.parallel import mesh

        monkeypatch.setattr(mesh, "world_size", lambda: world)
        assert registry._shard_count(nbytes, length) == want

    def test_threshold_zero_never_shards(self, monkeypatch):
        from flox_tpu_torch.parallel import mesh

        monkeypatch.setattr(mesh, "world_size", lambda: 4)
        with flox_tpu_torch.set_options(registry_shard_threshold_bytes=0):
            assert registry._shard_count(2 << 30, 26304) == 1

    def test_one_rank_put_above_threshold_stays_whole(self):
        values, labels = _payload(n=2048)
        with flox_tpu_torch.set_options(registry_shard_threshold_bytes=1024):
            info = put("ds", values, labels)
        assert not info["sharded"] and isinstance(registry.resolve("ds").data, torch.Tensor)


class TestFaultDomain:
    def test_unknown_dataset_typed_error(self):
        misses0 = METRICS.get("registry.misses")
        with pytest.raises(UnknownDatasetError) as exc:
            _submit(func="sum", dataset="never-put")
        assert exc.value.code == "unknown_dataset"
        assert METRICS.get("registry.misses") - misses0 == 1

    def test_delete_with_inflight_request_is_safe(self):
        values, labels = _payload(n=2048)
        put("ds", values, labels)
        expect, _ = groupby_reduce(values, labels, func="sum")

        async def main():
            d = Dispatcher()
            try:
                task = asyncio.ensure_future(_one(d, func="sum", dataset="ds"))
                for _ in range(3):
                    await asyncio.sleep(0)
                assert registry.delete("ds") is True
                return await task
            finally:
                await d.close()

        np.testing.assert_array_equal(run(main()).result, expect.numpy())
        with pytest.raises(UnknownDatasetError):
            _submit(func="sum", dataset="ds")

    def test_selector_validation(self):
        values, labels = _payload()
        put("ds", values, labels)
        with pytest.raises(ValueError, match="not both"):
            _submit(func="sum", dataset="ds", rows=[0, 8], mask=[True] * len(values))
        with pytest.raises(ValueError, match="require a 'dataset'"):
            _submit(func="sum", array=values, by=labels, rows=[0, 8])
        with pytest.raises(ValueError, match="fixed at put time"):
            _submit(func="sum", dataset="ds", by=labels)

    def test_restage_all_after_device_loss(self):
        from flox_tpu_torch import device

        values, labels = _payload()
        put("ds", values, labels)
        before = _submit(func="sum", dataset="ds")
        old = registry.resolve("ds").data
        device.reinitialize()
        assert registry.restage_all() == 1
        assert registry.resolve("ds").data is not old
        after = _submit(func="sum", dataset="ds")
        np.testing.assert_array_equal(after.result, before.result)


class TestStateRegistration:
    def test_stats_and_clear_all(self):
        values, labels = _payload()
        put("ds", values, labels)
        with flox_tpu_torch.set_options(telemetry=True):
            _submit(func="sum", dataset="ds")
        st = cache.stats()
        assert st["registry"]["datasets"] == 1 and st["registry"]["bytes"] > 0
        assert "ds" in st["cost_by_dataset"]
        assert st["cost_by_dataset"]["ds"]["dispatches"] >= 1
        cache.clear_all()
        assert registry.list_datasets() == []
        assert cache.stats()["registry"]["datasets"] == 0
        assert METRICS.get("registry.datasets") == 0

    def test_debug_table_shape(self):
        values, labels = _payload()
        put("ds", values, labels)
        table = registry.debug_table()
        assert table["bytes"] > 0
        assert table["datasets"][0]["name"] == "ds" and table["datasets"][0]["nbytes"] > 0
        assert "budget_bytes" in table and "evictions" in table

    def test_put_validation(self):
        with pytest.raises(ValueError, match="requires 'by'"):
            put("ds", np.ones(8))
        with pytest.raises(ValueError, match="do not align"):
            put("ds", np.ones(8), np.zeros(9, dtype=np.int64))
        with pytest.raises(ValueError):
            put("", by=np.zeros(8, dtype=np.int64))

    def test_put_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.put("ds", np.ones(4), np.zeros(4, dtype=np.int64))
        assert registry.list_datasets() == []


class TestProtocol:
    def test_put_del_list_roundtrip_cli(self):
        env = dict(os.environ, FLOX_TPU_TELEMETRY="1")
        env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
        values = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0]
        labels = [0, 0, 1, 1, 2, 2]
        lines = "\n".join(json.dumps(m) for m in [
            {"op": "put_dataset", "name": "t", "array": values, "by": labels},
            {"op": "list_datasets"},
            {"id": "hit", "func": "sum", "dataset": "t"},
            {"id": "rows", "func": "sum", "dataset": "t", "rows": [0, 4]},
            {"id": "inline", "func": "sum", "array": values, "by": labels},
            {"id": "missing", "func": "sum", "dataset": "nope"},
            {"id": "bad", "func": "sum", "dataset": "t", "by": labels},
            {"op": "del_dataset", "name": "t"},
            {"id": "gone", "func": "sum", "dataset": "t"},
            {"op": "drain"},
        ])
        proc = subprocess.run([sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu"],
                              input=lines, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        recs = {}
        for raw in proc.stdout.splitlines():
            rec = json.loads(raw)
            recs[rec.get("id") or rec.get("op")] = rec
        put_rec = recs["put_dataset"]
        assert put_rec["ok"] and put_rec["name"] == "t" and put_rec["nbytes"] > 0
        assert put_rec["ngroups"] == 3 and put_rec["device"] == "cpu"
        listed = recs["list_datasets"]
        assert listed["ok"] and listed["datasets"][0]["name"] == "t"
        assert listed["stats"]["datasets"] == 1
        assert recs["hit"]["ok"] and recs["inline"]["ok"]
        assert recs["hit"]["result"] == recs["inline"]["result"] == [3.0, 12.0, 48.0]
        assert recs["rows"]["ok"] and recs["rows"]["result"] == [3.0, 12.0, 0.0]
        assert recs["missing"]["ok"] is False and recs["missing"]["code"] == "unknown_dataset"
        assert recs["bad"]["ok"] is False and recs["bad"]["code"] == "protocol"
        assert recs["del_dataset"]["ok"] and recs["del_dataset"]["deleted"]
        assert recs["gone"]["ok"] is False and recs["gone"]["code"] == "unknown_dataset"
