"""The port's serving front-end (``flox_tpu_torch.serve``) held against
flox_tpu's (``tests/test_serve.py``'s cases).

Every dispatcher here reduces on the CPU (``Dispatcher(device="cpu")``, the
serve loop with ``--device cpu``); without it the default device is CUDA and
raises. The contracts: coalescing (K identical requests, one dispatch),
micro-batching (one dispatch, one pass of the kernel's plain version, rows
bit for bit their solo calls), concurrency correctness, admission control,
option scoping, the LRU, the warmup manifest and the warm restart with zero
``nvcc`` builds, the JSON-lines protocol, and the same request lines
answered as the reference dispatcher answers them. The kernel loader and the
launch counters are held safe under the dispatcher's worker threads.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import flox_tpu
import flox_tpu_torch
from flox_tpu_torch import _build, cache, cuda_kernels as ck, serve
from flox_tpu_torch.cache import LRUCache
from flox_tpu_torch.options import OPTIONS, explicitly_set, scoped, set_options
from flox_tpu_torch.serve import (
    AggregationRequest,
    DeadlineExceededError,
    LoadShedError,
    aot,
)
from flox_tpu_torch.telemetry import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state():
    with set_options(serve_aot_dir=None):
        cache.clear_all()
        yield
        cache.clear_all()
        aot.deconfigure()


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def Dispatcher(**kw):
    kw.setdefault("device", "cpu")
    return serve.Dispatcher(**kw)


def groupby_reduce(*args, **kw):
    return flox_tpu_torch.groupby_reduce(*args, device="cpu", **kw)


def _payload(n=64, ngroups=5, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n).astype(dtype), rng.integers(0, ngroups, size=n)


def _count_plain(monkeypatch, name: str) -> list:
    calls: list = []
    plain = getattr(ck, name)
    monkeypatch.setattr(ck, name, lambda *a, **k: calls.append(1) or plain(*a, **k))
    return calls


class TestDevice:
    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.Dispatcher()
        assert Dispatcher().device == torch.device("cpu")

    def test_results_are_host_arrays(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher()
            single = await d.submit(func="sum", array=values, by=labels)
            multi = await d.submit(func=["sum", "max"], array=values, by=labels)
            await d.close()
            return single, multi

        single, multi = run(main())
        assert isinstance(single.result, np.ndarray) and isinstance(single.groups, np.ndarray)
        assert all(isinstance(v, np.ndarray) for v in multi.result.values())


class TestCoalescing:
    def test_identical_requests_one_dispatch_all_correct(self):
        values, labels = _payload()
        expect, egroups = groupby_reduce(values, labels, func="sum")
        K = 8

        async def main():
            d = Dispatcher()
            before = METRICS.get("serve.dispatches")
            results = await asyncio.gather(
                *[d.submit(func="sum", array=values, by=labels) for _ in range(K)])
            await d.close()
            return results, METRICS.get("serve.dispatches") - before

        results, dispatches = run(main())
        assert dispatches == 1
        for r in results:
            np.testing.assert_array_equal(r.result, expect.numpy())
            np.testing.assert_array_equal(r.groups, np.asarray(egroups))
        assert sorted(r.coalesced for r in results) == [False] + [True] * (K - 1)
        assert METRICS.get("serve.coalesced") == K - 1
        assert all(r.queue_ms >= 0 for r in results)

    def test_different_payloads_do_not_coalesce(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            before = METRICS.get("serve.dispatches")
            await asyncio.gather(d.submit(func="sum", array=values, by=labels),
                                 d.submit(func="sum", array=values + 1.0, by=labels))
            await d.close()
            return METRICS.get("serve.dispatches") - before

        assert run(main()) == 2

    def test_different_option_scopes_do_not_coalesce(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            before = METRICS.get("serve.dispatches")
            results = await asyncio.gather(
                d.submit(func="sum", array=values, by=labels),
                d.submit(func="sum", array=values, by=labels,
                         options={"default_engine": "numpy"}))
            await d.close()
            return results, METRICS.get("serve.dispatches") - before

        results, dispatches = run(main())
        assert dispatches == 2
        np.testing.assert_allclose(results[0].result, results[1].result)

    def test_ambient_scope_is_part_of_the_program_key(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=1)
            before = METRICS.get("serve.dispatches")

            async def scoped_submit():
                with scoped(default_engine="numpy"):
                    return await d.submit(func="sum", array=values, by=labels)

            results = await asyncio.gather(scoped_submit(),
                                           d.submit(func="sum", array=values, by=labels))
            await d.close()
            return results, METRICS.get("serve.dispatches") - before

        results, dispatches = run(main())
        assert dispatches == 2
        np.testing.assert_allclose(results[0].result, results[1].result)

    def test_execution_error_fans_out_to_every_waiter(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher()
            results = await asyncio.gather(
                *[d.submit(func="definitely-not-a-reduction", array=values, by=labels)
                  for _ in range(3)], return_exceptions=True)
            await d.close()
            return results

        results = run(main())
        assert len(results) == 3 and all(isinstance(r, Exception) for r in results)
        assert METRICS.get("serve.errors") == 1


class TestMicroBatching:
    def test_batched_rows_bit_identical_to_solo(self):
        values, labels = _payload()
        payloads = [values + i for i in range(4)]
        solo = [groupby_reduce(p, labels, func="sum")[0].numpy() for p in payloads]

        async def main():
            d = Dispatcher(batch_window=0.05)
            before = METRICS.get("serve.dispatches")
            results = await asyncio.gather(
                *[d.submit(func="sum", array=p, by=labels) for p in payloads])
            await d.close()
            return results, METRICS.get("serve.dispatches") - before

        results, dispatches = run(main())
        assert dispatches == 1
        assert [r.batch_size for r in results] == [4, 4, 4, 4]
        for r, expect in zip(results, solo):
            np.testing.assert_array_equal(r.result, expect)

    @pytest.mark.parametrize("func,plain", [
        ("nanmean", "segment_sum_raw_plain"),
        ("nanmax", "segment_minmax_plain"),
        (["nanmean", "nanmin", "nanmax"], "segment_multistat_plain"),
    ])
    def test_one_batch_is_one_kernel_pass(self, monkeypatch, func, plain):
        """Eight float32 payloads stacked into one dispatch reach the kernel
        once: on the CPU, one call of its plain version for the batch."""
        rng = np.random.default_rng(1)
        labels = (np.arange(96) // 8) % 12
        payloads = [rng.normal(size=(3, 96)).astype(np.float32) for _ in range(8)]
        calls = _count_plain(monkeypatch, plain)

        async def main():
            d = Dispatcher(batch_window=0.05)
            results = await asyncio.gather(
                *[d.submit(func=func, array=p, by=labels) for p in payloads])
            await d.close()
            return results

        results = run(main())
        assert len(calls) == 1 and [r.batch_size for r in results] == [8] * 8
        for p, r in zip(payloads, results):
            if isinstance(func, list):
                want = flox_tpu_torch.groupby_aggregate_many(p, labels, funcs=tuple(func),
                                                             device="cpu")[0]
                for f in func:
                    np.testing.assert_array_equal(r.result[f], want[f].numpy())
            else:
                np.testing.assert_array_equal(r.result, groupby_reduce(p, labels, func=func)[0])

    def test_batch_respects_microbatch_max(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(microbatch_max=2, batch_window=0.05)
            before = METRICS.get("serve.dispatches")
            await asyncio.gather(
                *[d.submit(func="sum", array=values + i, by=labels) for i in range(4)])
            await d.close()
            return METRICS.get("serve.dispatches") - before

        assert run(main()) == 2

    def test_oversized_and_unbatchable_dispatch_alone(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(batch_window=0.05)
            with set_options(serve_microbatch_max_elems=8):
                big = await asyncio.gather(d.submit(func="sum", array=values, by=labels),
                                           d.submit(func="sum", array=values + 1, by=labels))
            quant = await asyncio.gather(
                d.submit(func="quantile", array=values, by=labels, finalize_kwargs={"q": 0.5}),
                d.submit(func="quantile", array=values + 1, by=labels,
                         finalize_kwargs={"q": 0.5}))
            await d.close()
            return big, quant

        big, quant = run(main())
        assert [r.batch_size for r in big] == [1, 1]
        assert [r.batch_size for r in quant] == [1, 1]
        expect = groupby_reduce(values, labels, func="quantile", finalize_kwargs={"q": 0.5})[0]
        np.testing.assert_array_equal(quant[0].result, expect.numpy())


class TestConcurrencyCorrectness:
    def test_mixed_scopes_concurrent_equals_sequential(self):
        requests = []
        for i in range(12):
            values, labels = _payload(seed=i, ngroups=3 + i % 4)
            requests.append(AggregationRequest(
                func=["sum", "nanmean", "max", "prod"][i % 4], array=values, by=labels,
                options={} if i % 3 == 0 else {"default_engine": ["numpy", "torch"][i % 2]}))
        sequential = []
        for req in requests:
            with scoped(**req.options):
                result, groups = groupby_reduce(req.array, req.by, func=req.func)
            sequential.append((result.numpy(), np.asarray(groups)))

        async def main():
            d = Dispatcher()
            out = await asyncio.gather(*[d.submit(req) for req in requests])
            await d.close()
            return out

        for served, (expect, egroups) in zip(run(main()), sequential):
            np.testing.assert_array_equal(served.result, expect)
            np.testing.assert_array_equal(served.groups, egroups)

    def test_pending_registry_empties_after_serving(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher()
            await asyncio.gather(
                *[d.submit(func="sum", array=values + i, by=labels) for i in range(4)])
            await d.close()

        run(main())
        stats = cache.stats()
        assert stats["serve_pending"] == 0
        assert stats["serve_coalesce"] == 0
        assert stats["serve_batches"] == 0


class TestAgainstReference:
    """The same request lines through both dispatchers: equal results and
    groups (float sums within 1e-12; the reference sums on its numpy or XLA
    engine, the port in torch)."""

    LINES = [
        {"func": "sum", "seed": 0, "ngroups": 5},
        {"func": "nanmean", "seed": 1, "ngroups": 7},
        {"func": "max", "seed": 2, "ngroups": 3},
        {"func": "count", "seed": 3, "ngroups": 4},
        {"func": "var", "seed": 4, "ngroups": 6},
        {"func": ["mean", "min", "max"], "seed": 5, "ngroups": 5},
        {"func": ["count", "nanmean", "nanstd", "nanmin", "nanmax"], "seed": 6, "ngroups": 8},
        {"func": "quantile", "seed": 7, "ngroups": 4, "finalize_kwargs": {"q": 0.25}},
        {"func": "nanargmax", "seed": 8, "ngroups": 4},
    ]

    def test_same_lines_same_answers(self):
        from flox_tpu import serve as ref_serve

        reqs = []
        for line in self.LINES:
            values, labels = _payload(seed=line["seed"], ngroups=line["ngroups"])
            values[::11] = np.nan
            reqs.append(dict(func=line["func"], array=values, by=labels,
                             finalize_kwargs=line.get("finalize_kwargs")))

        async def main(dispatcher):
            out = await asyncio.gather(*[dispatcher.submit(**r) for r in reqs])
            await dispatcher.close()
            return out

        with flox_tpu.set_options(serve_aot_dir=None):
            want = run(main(ref_serve.Dispatcher()))
        got = run(main(Dispatcher()))
        for line, g, w in zip(self.LINES, got, want):
            np.testing.assert_array_equal(g.groups, w.groups)
            gr = g.result if isinstance(g.result, dict) else {"_": g.result}
            wr = w.result if isinstance(w.result, dict) else {"_": w.result}
            assert gr.keys() == wr.keys(), line
            for k in gr:
                a, b = np.asarray(gr[k]), np.asarray(wr[k])
                if a.dtype.kind in "iub":
                    np.testing.assert_array_equal(a, b, err_msg=str(line))
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=str(line))


class TestAdmissionControl:
    def test_load_shed_beyond_queue_depth(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(queue_depth=2, batch_window=0.05)
            results = await asyncio.gather(
                *[d.submit(func="sum", array=values + i, by=labels) for i in range(5)],
                return_exceptions=True)
            await d.close()
            return results

        results = run(main())
        shed = [r for r in results if isinstance(r, LoadShedError)]
        served = [r for r in results if not isinstance(r, Exception)]
        assert len(shed) == 3 and len(served) == 2
        assert METRICS.get("serve.shed") == 3
        assert all(r.code == "load_shed" and r.retry_after_ms >= 1.0 for r in shed)

    def test_queue_depth_zero_disables_admission_control(self):
        values, labels = _payload()

        async def main():
            d = Dispatcher(queue_depth=0)
            results = await asyncio.gather(
                *[d.submit(func="sum", array=values + i, by=labels) for i in range(8)])
            await d.close()
            return results

        assert len(run(main())) == 8

    def test_expired_request_cancelled_without_poisoning_queue(self):
        values, labels = _payload()
        expect = groupby_reduce(values, labels, func="sum")[0].numpy()

        async def main():
            d = Dispatcher(batch_window=0.2)
            before = METRICS.get("serve.dispatches")
            with pytest.raises(DeadlineExceededError):
                await d.submit(func="sum", array=values, by=labels, deadline=0.01)
            await d.close()
            abandoned_dispatches = METRICS.get("serve.dispatches") - before
            after = await d.submit(func="sum", array=values, by=labels)
            await d.close()
            return abandoned_dispatches, after

        abandoned_dispatches, after = run(main())
        assert abandoned_dispatches == 0
        assert METRICS.get("serve.batches_abandoned") == 1
        assert METRICS.get("serve.deadline_exceeded") == 1
        np.testing.assert_array_equal(after.result, expect)
        assert cache.stats()["serve_pending"] == 0

    def test_one_expired_waiter_does_not_cancel_peers(self):
        values, labels = _payload()
        expect = groupby_reduce(values, labels, func="sum")[0].numpy()

        async def main():
            d = Dispatcher(batch_window=0.15)
            patient = asyncio.create_task(d.submit(func="sum", array=values, by=labels))
            await asyncio.sleep(0)
            with pytest.raises(DeadlineExceededError):
                await d.submit(func="sum", array=values, by=labels, deadline=0.01)
            result = await patient
            await d.close()
            return result

        np.testing.assert_array_equal(run(main()).result, expect)


class TestScopedOptions:
    def test_overlay_reads_and_restores(self):
        base = OPTIONS["default_engine"]
        with scoped(default_engine="numpy"):
            assert OPTIONS["default_engine"] == "numpy"
            assert OPTIONS.get("default_engine") == "numpy"
        assert OPTIONS["default_engine"] == base

    def test_nested_scopes_innermost_wins(self):
        with scoped(default_engine="numpy", telemetry=True):
            with scoped(default_engine="sort"):
                assert OPTIONS["default_engine"] == "sort"
                assert OPTIONS["telemetry"] is True
            assert OPTIONS["default_engine"] == "numpy"

    def test_validation_at_entry(self):
        with pytest.raises(ValueError):
            scoped(default_engine="fortran")
        with pytest.raises(ValueError):
            scoped(not_an_option=1)

    def test_explicitly_set_respects_scope(self):
        assert not explicitly_set("stream_prefetch")
        with scoped(stream_prefetch=3):
            assert explicitly_set("stream_prefetch")
        assert not explicitly_set("stream_prefetch")
        with set_options(stream_prefetch=3):
            assert explicitly_set("stream_prefetch")
        assert not explicitly_set("stream_prefetch")

    def test_set_options_inside_scope_restores_global_base(self):
        base = OPTIONS["stream_prefetch"]
        with scoped(stream_prefetch=7):
            with set_options(stream_prefetch=5):
                assert OPTIONS["stream_prefetch"] == 7
            assert dict.__getitem__(OPTIONS, "stream_prefetch") == base
        assert OPTIONS["stream_prefetch"] == base

    def test_threads_start_unscoped(self):
        seen = {}

        def worker():
            seen["engine"] = OPTIONS["default_engine"]

        with scoped(default_engine="numpy"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert seen["engine"] == dict.__getitem__(OPTIONS, "default_engine")

    def test_asyncio_tasks_and_to_thread_inherit_creating_scope(self):
        async def probe():
            return OPTIONS["default_engine"]

        async def main():
            with scoped(default_engine="numpy"):
                inside = asyncio.create_task(probe())
                threaded = await asyncio.to_thread(lambda: OPTIONS["default_engine"])
            outside = asyncio.create_task(probe())
            return await inside, threaded, await outside

        inside, threaded, outside = run(main())
        assert inside == threaded == "numpy"
        assert outside == dict.__getitem__(OPTIONS, "default_engine")

    def test_concurrent_scopes_isolated(self):
        async def hold(engine, barrier):
            with scoped(default_engine=engine):
                await barrier.wait()
                return OPTIONS["default_engine"]

        async def main():
            barrier = asyncio.Event()
            tasks = [asyncio.create_task(hold("numpy", barrier)),
                     asyncio.create_task(hold("sort", barrier))]
            await asyncio.sleep(0)
            barrier.set()
            return await asyncio.gather(*tasks)

        assert run(main()) == ["numpy", "sort"]

    def test_trace_fingerprint_follows_scope(self):
        from flox_tpu_torch.options import trace_fingerprint

        base = trace_fingerprint()
        with scoped(segment_sum_impl="scatter"):
            assert trace_fingerprint() != base
            assert "scatter" in trace_fingerprint()
        assert trace_fingerprint() == base

    def test_serve_options_carried_from_reference(self):
        from flox_tpu_torch.options import from_reference

        keys = ("serve_queue_depth", "serve_deadline", "serve_microbatch_max",
                "serve_batch_window", "serve_microbatch_max_elems", "serve_drain_timeout",
                "serve_watchdog_timeout", "serve_breaker_threshold", "serve_breaker_cooldown",
                "serve_aot_dir", "metrics_port", "registry_budget_fraction",
                "registry_budget_bytes", "registry_shard_threshold_bytes", "store_root",
                "store_compact_threshold", "store_fsync")
        from flox_tpu.options import OPTIONS as REF_OPTIONS

        ported = from_reference(dict(REF_OPTIONS))
        for key in keys:
            assert ported[key] == REF_OPTIONS[key], key
        for key, bad in (("serve_queue_depth", -1), ("serve_microbatch_max", 0),
                         ("registry_budget_fraction", 0.0), ("metrics_port", 70000)):
            with pytest.raises(ValueError):
                set_options(**{key: bad})


class TestLRUCache:
    def test_lru_evicts_one_stale_entry(self):
        lru = LRUCache(maxsize=3)
        for i in range(3):
            lru[i] = f"p{i}"
        assert lru.get(0) == "p0"
        lru[3] = "p3"
        assert lru.evictions == 1
        assert 1 not in lru
        assert set(lru.keys()) == {0, 2, 3}
        assert len(lru) == 3

    def test_lru_mapping_surface(self):
        lru = LRUCache(maxsize=4)
        lru["a"] = 1
        assert lru["a"] == 1 and "a" in lru
        assert lru.get("missing", 7) == 7
        assert lru.items() == [("a", 1)] and lru.values() == [1]
        assert lru.pop("a") == 1 and lru.pop("a", None) is None
        with pytest.raises(KeyError):
            lru["gone"]
        with pytest.raises(ValueError):
            LRUCache(maxsize=0)

    def test_lru_renews_hot_key_under_traffic(self):
        lru = LRUCache(maxsize=8)
        lru["hot"] = "hot"
        for i in range(12):
            lru[("cold", i)] = i
            assert lru.get("hot") == "hot"
        assert lru.evictions == 5

    def test_clear_all_resets_serve_tables(self):
        from flox_tpu_torch.serve.aot import _MANIFEST_MEMO
        from flox_tpu_torch.serve.dispatcher import _COALESCE_CACHE, _PENDING_REGISTRY

        _MANIFEST_MEMO["d"] = {"func": "sum"}
        _PENDING_REGISTRY[99] = object()
        _COALESCE_CACHE[("k",)] = object()
        cache.clear_all()
        assert not _MANIFEST_MEMO and not _PENDING_REGISTRY and not _COALESCE_CACHE
        stats = cache.stats()
        for key in ("serve_pending", "serve_coalesce", "serve_batches", "serve_aot_manifest"):
            assert stats[key] == 0
        json.dumps(stats, default=str)


class TestAOT:
    def test_record_reduce_roundtrips_through_manifest(self, tmp_path):
        with set_options(serve_aot_dir=str(tmp_path)):
            spec = dict(func="sum", shape=(8,), dtype="float64", by_shape=(8,),
                        by_dtype="int64", ngroups=2, agg_kwargs={"fill_value": None},
                        options={})
            assert aot.record_reduce(**spec)
            assert not aot.record_reduce(**spec)
            payload = json.loads((tmp_path / "manifest.json").read_text())
            assert payload["version"] == 1 and len(payload["programs"]) == 1
            cache.clear_all()
            assert aot.warmup(device="cpu") == 1
            assert cache.stats()["serve_aot_manifest"] == 1

    def test_manifest_is_the_references(self, tmp_path):
        """A manifest either package writes, the other replays."""
        from flox_tpu.serve import aot as ref_aot

        with set_options(serve_aot_dir=str(tmp_path)):
            assert aot.record_reduce(func="nanmean", shape=(3, 16), dtype="float32",
                                     by_shape=(16,), by_dtype="int64", ngroups=4,
                                     agg_kwargs={}, options={})
        with flox_tpu.set_options(serve_aot_dir=str(tmp_path)):
            try:
                ref_aot._MANIFEST_MEMO.clear()
                assert ref_aot.warmup() == 1
            finally:
                ref_aot._MANIFEST_MEMO.clear()
                ref_aot.deconfigure()

    def test_unreplayable_specs_are_skipped(self, tmp_path):
        with set_options(serve_aot_dir=str(tmp_path)):
            assert not aot.record_reduce(func=lambda x: x, shape=(4,), dtype="float64",
                                         by_shape=(4,), by_dtype="int64", ngroups=1,
                                         agg_kwargs={}, options={})
            assert not aot.record_reduce(func="sum", shape=(4,), dtype="float64",
                                         by_shape=(4,), by_dtype="int64", ngroups=1,
                                         agg_kwargs={"finalize_kwargs": {"fn": lambda x: x}},
                                         options={})
        assert not aot.record_reduce(func="sum", shape=(4,), dtype="float64", by_shape=(4,),
                                     by_dtype="int64", ngroups=1, agg_kwargs={}, options={})

    def test_corrupt_manifest_warns_and_serves(self, tmp_path, caplog):
        (tmp_path / "manifest.json").write_text("{not json")
        with set_options(serve_aot_dir=str(tmp_path)):
            assert aot.warmup(device="cpu") == 0
            assert any("unreadable AOT manifest" in r.message for r in caplog.records)
            assert aot.record_reduce(func="sum", shape=(4,), dtype="float64", by_shape=(4,),
                                     by_dtype="int64", ngroups=1, agg_kwargs={}, options={})

    def test_manifest_save_merges_across_processes(self, tmp_path):
        with set_options(serve_aot_dir=str(tmp_path)):
            aot.record_reduce(func="sum", shape=(8,), dtype="float64", by_shape=(8,),
                              by_dtype="int64", ngroups=2, agg_kwargs={}, options={})
            cache.clear_all()
            aot.record_reduce(func="max", shape=(16,), dtype="float32", by_shape=(16,),
                              by_dtype="int64", ngroups=4, agg_kwargs={}, options={})
            payload = json.loads((tmp_path / "manifest.json").read_text())
            assert {spec["func"] for spec in payload["programs"].values()} == {"sum", "max"}

    def test_concurrent_saves_from_worker_threads(self, tmp_path):
        """The dispatcher's worker threads record specs at once: every save
        lands, and the manifest holds them all."""
        barrier = threading.Barrier(8)
        errors = []

        def worker(i):
            try:
                barrier.wait(timeout=30)
                aot.record_reduce(func="sum", shape=(8 + i,), dtype="float64",
                                  by_shape=(8 + i,), by_dtype="int64", ngroups=2,
                                  agg_kwargs={}, options={})
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        with set_options(serve_aot_dir=str(tmp_path)):
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not errors
        payload = json.loads((tmp_path / "manifest.json").read_text())
        assert len(payload["programs"]) == 8
        assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]

    def test_dispatcher_records_served_programs(self, tmp_path):
        values, labels = _payload()
        with set_options(serve_aot_dir=str(tmp_path)):
            async def main():
                d = Dispatcher()
                await d.submit(func="sum", array=values, by=labels)
                await d.close()

            run(main())
            payload = json.loads((tmp_path / "manifest.json").read_text())
            (spec,) = payload["programs"].values()
            assert spec["func"] == "sum"
            assert tuple(spec["shape"]) == values.shape and spec["dtype"] == "float64"
            assert spec["ngroups"] == len(np.unique(labels))

    def test_configure_loads_no_library_off_cuda(self, tmp_path, monkeypatch):
        calls = []
        monkeypatch.setattr(_build, "load_all", lambda: calls.append(1))
        assert aot.configure(str(tmp_path), device="cpu") == tmp_path
        assert aot.configure(str(tmp_path)) == tmp_path
        assert not calls

    def test_two_process_smoke_warm_restart_zero_builds(self, tmp_path):
        """Process A serves and records its programs; process B restarts
        against the same directory, warms up, and answers its first request
        identically with zero ``nvcc`` builds (``_build.build`` counted)."""
        outs = _run_serve_cli(tmp_path)
        assert outs["a"]["response"]["ok"], outs["a"]
        assert outs["a"]["stats"]["compiles"] == 0
        assert outs["b"]["warmup"] == {"warmed": 1, "compiles": 0}
        assert outs["b"]["response"]["ok"], outs["b"]
        assert outs["b"]["stats"]["compiles"] == 0
        assert outs["b"]["builds"] == 0
        assert outs["b"]["response"]["result"] == outs["a"]["response"]["result"]


_COUNTING_SERVE = """
import sys
from flox_tpu_torch import _build
calls = []
real = _build.build
_build.build = lambda *a, **k: calls.append(1) or real(*a, **k)
from flox_tpu_torch.serve.__main__ import main
rc = main(sys.argv[1:])
print('{"builds": %d}' % len(calls))
sys.exit(rc)
"""


def _run_serve_cli(tmp_path):
    """``python -m flox_tpu_torch.serve`` twice against one warmup directory,
    with ``_build.build`` wrapped to count calls."""
    env = dict(os.environ, FLOX_TPU_TELEMETRY="1")
    env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
    lines = "\n".join([
        json.dumps({"id": "r", "func": "sum", "array": [1.0, 2.0, 4.0, 8.0], "by": [0, 0, 1, 1]}),
        json.dumps({"op": "drain"}),
        json.dumps({"op": "stats"}),
    ])
    outs = {}
    for name, extra in (("a", []), ("b", ["--warmup"])):
        proc = subprocess.run(
            [sys.executable, "-c", _COUNTING_SERVE, "--device", "cpu", "--aot-dir",
             str(tmp_path), *extra],
            input=lines, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out = {}
        for rec in (json.loads(line) for line in proc.stdout.splitlines() if line.strip()):
            if "warmed" in rec:
                out["warmup"] = rec
            elif rec.get("op") == "stats":
                out["stats"] = rec
            elif rec.get("id") == "r":
                out["response"] = rec
            elif "builds" in rec:
                out["builds"] = rec["builds"]
        outs[name] = out
    return outs


def _serve_script(tmp_path, lines, *args, env_extra=None):
    script = tmp_path / "requests.jsonl"
    script.write_text("\n".join(line if isinstance(line, str) else json.dumps(line)
                                for line in lines) + "\n")
    env = dict(os.environ, **(env_extra or {}))
    env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
    if not env_extra or "FLOX_TPU_TELEMETRY" not in env_extra:
        env.pop("FLOX_TPU_TELEMETRY", None)
    proc = subprocess.run(
        [sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu", "--input",
         str(script), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return {rec.get("id", rec.get("op")): rec
            for rec in (json.loads(line) for line in proc.stdout.splitlines() if line.strip())}


class TestProtocol:
    def test_jsonl_loop_serves_and_reports_errors(self, tmp_path):
        records = _serve_script(tmp_path, [
            {"id": "ok", "func": "sum", "array": [1.0, 2.0, 4.0], "by": [0, 1, 1]},
            {"id": "exec", "func": "no_such_agg", "array": [1.0, 2.0], "by": [0, 1]},
            "this is not json",
            {"id": "bad", "func": "sum", "bogus_field": 1},
            {"op": "nonsense"},
            {"op": "drain"},
            {"op": "stats"},
        ])
        assert records["ok"]["ok"] and records["ok"]["result"] == [1.0, 6.0]
        assert not records["exec"]["ok"] and records["exec"]["error"] != "protocol"
        assert records["exec"]["code"] == "execution"
        assert records["line-3"]["error"] == "protocol"
        assert records["bad"]["error"] == "protocol"
        assert "bogus_field" in records["bad"]["message"]
        assert records["line-5"]["error"] == "protocol"
        assert records["drain"]["ok"]
        assert records["stats"]["counters"]["serve.requests"] == 2
        assert records["stats"]["cache"]["serve_pending"] == 0

    def test_traceparent_propagates_and_echoes_over_protocol(self, tmp_path):
        trace32, span16 = "ab" * 16, "cd" * 8
        records = _serve_script(tmp_path, [
            {"id": "traced", "func": "sum", "array": [1.0, 2.0, 4.0], "by": [0, 1, 1],
             "traceparent": f"00-{trace32}-{span16}-01"},
            {"id": "plain", "func": "sum", "array": [1.0, 2.0, 8.0], "by": [0, 1, 1]},
            {"op": "drain"},
        ], "--replica-id", "rep-a", env_extra={"FLOX_TPU_TELEMETRY": "1"})
        traced = records["traced"]
        assert traced["ok"] and traced["trace_id"] == trace32
        echoed = traced["traceparent"].split("-")
        assert echoed[0] == "00" and echoed[1] == trace32 and echoed[2] != span16
        assert "traceparent" not in records["plain"]

    def test_same_lines_as_reference_loop(self, tmp_path):
        """One script through both serve loops: the same answers."""
        lines = [
            {"id": "a", "func": "sum", "array": [1.0, 2.0, 4.0, 8.0], "by": [0, 0, 1, 1]},
            {"id": "b", "func": ["mean", "min", "max"], "array": [1.0, 2.0, 4.0, 8.0],
             "by": [0, 0, 1, 1]},
            {"id": "c", "func": "nanmax", "array": [1.0, float("nan"), 4.0], "by": [2, 2, 0]},
            {"op": "drain"},
        ]
        script = tmp_path / "requests.jsonl"
        script.write_text("\n".join(json.dumps(line) for line in lines) + "\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("FLOX_TPU_TELEMETRY", None)
        env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
        ref = subprocess.run([sys.executable, "-m", "flox_tpu.serve", "--input", str(script)],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
        assert ref.returncode == 0, ref.stderr
        want = {r["id"]: r for r in map(json.loads, ref.stdout.splitlines()) if "id" in r}
        got = _serve_script(tmp_path, lines)
        for rid in ("a", "b", "c"):
            assert got[rid]["ok"] and want[rid]["ok"], (got[rid], want[rid])
            assert got[rid]["groups"] == want[rid]["groups"], rid
            assert got[rid]["result"] == want[rid]["result"], rid

    def test_canary_interval_names_the_slo_item(self, tmp_path):
        # the SLO plane is ported: the loop runs canary cycles on the period,
        # and their probes are counted in the stats panel
        proc = subprocess.Popen(
            [sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu",
             "--canary-interval", "0.2"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=REPO, text=True)
        try:
            first = json.loads(proc.stdout.readline())
            assert first == {"op": "canary", "interval": 0.2}
            deadline = time.monotonic() + 60
            probes = 0
            while probes < 6 and time.monotonic() < deadline:
                time.sleep(0.3)
                proc.stdin.write('{"op": "stats"}\n')
                proc.stdin.flush()
                stats = json.loads(proc.stdout.readline())
                probes = stats["cache"]["slo"]["canary"]["probes"]
            assert probes >= 6, stats["cache"]["slo"]
            assert stats["cache"]["slo"]["canary"]["failures"] == 0
            proc.stdin.write('{"op": "shutdown"}\n')
            proc.stdin.flush()
            out, err = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, err
        assert json.loads(out.splitlines()[-1])["op"] == "shutdown"

    def test_default_device_refuses_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        proc = subprocess.run([sys.executable, "-m", "flox_tpu_torch.serve"], input="",
                              cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "CUDA" in proc.stderr


class TestKernelLoaderThreads:
    """The dispatcher runs batches on worker threads: the kernel loader and
    the launch counters must be safe there."""

    def test_library_built_and_loaded_once(self, tmp_path, monkeypatch):
        builds, loads = [], []
        lib_path = tmp_path / "libfake.so"
        monkeypatch.setattr(_build, "_LIBS", {})
        monkeypatch.setattr(_build, "library_path", lambda name: lib_path)

        def fake_build(names):
            builds.append(list(names))
            threading.Event().wait(0.05)  # a slow nvcc, so that threads pile up
            lib_path.write_bytes(b"")
            return {}

        class FakeLib:
            def __init__(self, path):
                loads.append(path)
                self.flox_error_string = type("F", (), {})()

        monkeypatch.setattr(_build, "build", fake_build)
        monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
        barrier = threading.Barrier(8)
        got = []

        def worker():
            barrier.wait(timeout=30)
            got.append(_build.library("segment_sum"))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(got) == 8 and all(g is got[0] for g in got)
        assert builds == [["segment_sum"]] and len(loads) == 1

    def test_build_temporaries_are_per_thread(self, tmp_path, monkeypatch):
        """Two builds of one library never share a temporary file."""
        seen = []

        class FakeProc:
            returncode = 0

            def __init__(self, cmd, **kw):
                seen.append(cmd[cmd.index("-o") + 1])
                open(seen[-1], "wb").close()

            def communicate(self):
                return "", None

        monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"lib{name}.so")
        monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
        before = dict(_build.BUILDS)
        barrier = threading.Barrier(4)

        def worker():
            barrier.wait(timeout=30)
            _build.build(["segment_sum"])

        # the library stays missing, so every thread builds: build() skips
        # what exists
        monkeypatch.setattr(_build.os, "replace", lambda a, b: None)
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(seen) == 4 and len(set(seen)) == 4
        assert _build.BUILDS["count"] - before["count"] == 4
        _build.BUILDS.update(before)

    def test_launch_counts_are_consistent(self):
        ck.reset_launches()
        barrier = threading.Barrier(8)

        def worker():
            barrier.wait(timeout=30)
            for _ in range(2000):
                ck._count_launch("segment_sum")

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert ck.LAUNCHES["segment_sum"] == 16000
        ck.reset_launches()
        assert set(ck.LAUNCHES.values()) == {0}

    def test_concurrent_plain_calls(self):
        """Plain-path calls on eight threads: each equals its single-thread
        result, and none counts a launch (no kernel ran)."""
        rng = np.random.default_rng(2)
        data = [torch.from_numpy(rng.normal(size=(4, 257)).astype(np.float32))
                for _ in range(8)]
        codes = torch.from_numpy((np.arange(257) % 12).astype(np.int32))
        want = [ck.segment_sum_raw(x, codes, 12, "kahan") for x in data]
        ck.reset_launches()
        got = [None] * 8
        barrier = threading.Barrier(8)

        def worker(i):
            barrier.wait(timeout=30)
            for _ in range(5):
                got[i] = ck.segment_sum_raw(data[i], codes, 12, "kahan")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b)
        assert set(ck.LAUNCHES.values()) == {0}
