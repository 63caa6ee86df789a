"""The port's streaming pipeline (flox_tpu_torch.pipeline) on the CPU, and
its CUDA staging on the card.

Mirrors ``tests/test_pipeline.py``: in-order bounded prefetch, teardown,
ragged tails, reverse and skipped streams, the loader contract, the throttle
and the option validation. The reference's donation-probe and cache-registry
tests have no counterpart (nothing is traced or donated; the cache plane is
ROADMAP A9), and its padded-tail test becomes a ragged-tail one (the port
does not pad slabs to a static shape). The pinned-buffer path runs only on a
CUDA device: its tests are in ``tests/test_torch_cuda_streaming.py``.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest
import torch

import flox_tpu
import flox_tpu_torch
from flox_tpu_torch import options as popts
from flox_tpu_torch.pipeline import (DispatchThrottle, SlabStager, _SlabPrefetcher,
                                     prefetch_occupancy, stream_slabs)


def _stager(data, codes, *, n, batch_len, lead_shape=(), device="cpu", loader=None):
    return SlabStager(loader or (lambda s, e: data[..., s:e]), codes, n=n,
                      batch_len=batch_len, lead_shape=lead_shape, device=device)


def _materialize(it):
    # per-slab state taken while iterating: stream_slabs drops the device
    # references once the consumer moves on
    return [(s.start, s.stop, s.data.clone(), s.codes.clone(), s.codes_host.copy(), s.offset)
            for s in it]


class TestSlabPrefetcher:
    def test_delivers_in_order_under_concurrency(self):
        rng = random.Random(0)
        delays = [rng.uniform(0, 0.01) for _ in range(40)]

        def stage(i):
            time.sleep(delays[i])
            return i

        assert list(_SlabPrefetcher(stage, range(40), depth=4)) == list(range(40))

    def test_bounded_in_flight(self):
        in_flight, peak, lock = [], [0], threading.Lock()

        def stage(i):
            with lock:
                in_flight.append(i)
                peak[0] = max(peak[0], len(in_flight))
            time.sleep(0.005)
            with lock:
                in_flight.remove(i)
            return i

        consumed = []
        for item in _SlabPrefetcher(stage, range(20), depth=3):
            consumed.append(item)
            time.sleep(0.002)
        assert consumed == list(range(20))
        assert peak[0] <= 3

    def test_error_surfaces_at_position_and_tears_down(self):
        def stage(i):
            if i == 3:
                raise ValueError("bad slab 3")
            return i

        pf = _SlabPrefetcher(stage, range(10), depth=2)
        got = []
        with pytest.raises(ValueError, match="bad slab 3"):
            for item in pf:
                got.append(item)
        assert got == [0, 1, 2]
        assert pf._pool is None

    def test_close_midstream_leaves_no_threads(self):
        def stage(i):
            time.sleep(0.005)
            return i

        pf = _SlabPrefetcher(stage, range(100), depth=4)
        assert next(pf) == 0
        pf.close()
        time.sleep(0.1)
        assert not [t for t in threading.enumerate() if "flox-torch-stage" in t.name]


    def test_prefetch_occupancy_counts_in_flight(self):
        """The occupancy gauge is the slabs submitted and not yet taken:
        ``depth`` while a pass runs (one refilled per slab taken), short of
        it at the tail, and 0 after a pass ends, is closed, or fails."""
        assert prefetch_occupancy() == 0
        pf = _SlabPrefetcher(lambda i: i, range(5), depth=3)
        seen = [prefetch_occupancy()]
        for _ in pf:
            seen.append(prefetch_occupancy())
        assert seen == [3, 3, 3, 2, 1, 0]
        assert prefetch_occupancy() == 0
        pf = _SlabPrefetcher(lambda i: i, range(100), depth=4)
        assert next(pf) == 0 and prefetch_occupancy() == 4
        pf.close()
        assert prefetch_occupancy() == 0

        def stage(i):
            if i == 2:
                raise ValueError("bad slab 2")
            return i

        with pytest.raises(ValueError, match="bad slab 2"):
            list(_SlabPrefetcher(stage, range(10), depth=2))
        assert prefetch_occupancy() == 0


class TestStreamSlabs:
    def test_ragged_tail_codes_and_offset(self):
        codes = np.arange(10, dtype=np.int32)
        data = np.arange(10.0)
        slabs = _materialize(stream_slabs(_stager(data, codes, n=10, batch_len=4),
                                          prefetch=0))
        assert [(s[0], s[1]) for s in slabs] == [(0, 4), (4, 8), (8, 10)]
        assert slabs[-1][2].tolist() == [8.0, 9.0]  # no padding: the tail is ragged
        assert slabs[-1][3].tolist() == [8, 9] and slabs[-1][3].dtype == torch.int32
        assert slabs[-1][4].tolist() == [8, 9]
        assert [s[5] for s in slabs] == [0, 4, 8]

    def test_reverse(self):
        codes = np.arange(10, dtype=np.int32)
        data = np.arange(10.0)
        slabs = _materialize(stream_slabs(_stager(data, codes, n=10, batch_len=4),
                                          prefetch=2, reverse=True))
        assert [(s[0], s[1]) for s in slabs] == [(8, 10), (4, 8), (0, 4)]
        assert slabs[0][2].shape == (2,)

    def test_prefetched_matches_sync_bytes(self):
        rng = np.random.default_rng(0)
        data = rng.normal(size=(3, 100))
        codes = rng.integers(0, 5, 100).astype(np.int32)

        def collect(depth):
            st = _stager(data, codes, n=100, batch_len=33, lead_shape=(3,))
            return [(s.data.numpy().tobytes(), s.codes.numpy().tobytes())
                    for s in stream_slabs(st, prefetch=depth)]

        assert collect(0) == collect(3)

    @pytest.mark.parametrize("depth", [0, 2])
    def test_skip_drops_leading_stream_order(self, depth):
        codes = np.arange(10, dtype=np.int32)
        data = np.arange(10.0)

        def starts(**kw):
            st = _stager(data, codes, n=10, batch_len=4)
            return [s.start for s in stream_slabs(st, prefetch=depth, **kw)]

        assert starts(skip=1) == [4, 8]
        assert starts(skip=1, reverse=True) == [4, 0]  # reversed: the trailing batches
        assert starts(skip=3) == []

    @pytest.mark.parametrize("depth", [0, 2])
    def test_loader_contract_shape_violation(self, depth):
        codes = np.arange(100, dtype=np.int32)
        data = np.arange(100.0)

        def bad(s, e):
            return np.zeros(7) if s == 40 else data[s:e]

        st = _stager(data, codes, n=100, batch_len=20, loader=bad)
        with pytest.raises(ValueError, match=r"loader contract.*\[40:60\)"):
            for _ in stream_slabs(st, prefetch=depth):
                pass

    def test_loader_contract_dtype_violation(self):
        codes = np.arange(100, dtype=np.int32)
        data = np.arange(100.0)

        def bad(s, e):
            sl = data[s:e]
            return sl.astype(np.float32) if s >= 60 else sl

        st = _stager(data, codes, n=100, batch_len=20, loader=bad)
        with pytest.raises(ValueError, match=r"\[60:80\).*float32.*float64"):
            for _ in stream_slabs(st, prefetch=0):
                pass

    def test_report_counts_bytes_and_slabs(self):
        from flox_tpu_torch import profiling

        data = np.ones((2, 50), dtype=np.float32)
        codes = np.zeros(50, dtype=np.int32)
        with profiling.stream_monitor() as reports:
            for _ in stream_slabs(_stager(data, codes, n=50, batch_len=16, lead_shape=(2,)),
                                  prefetch=1, label="unit"):
                pass
        (rep,) = reports
        assert rep.label == "unit" and rep.nbatches == len(rep.slabs) == 4
        assert rep.nbytes == data.nbytes
        assert all(s.data is None for s in rep.slabs)  # no device slab kept alive


def test_dispatch_throttle_reads_option():
    with flox_tpu_torch.set_options(stream_dispatch_depth=3):
        th = DispatchThrottle()
    assert th.depth == 3
    for _ in range(7):
        th.tick(torch.device("cpu"))  # a CPU carry has nothing to wait for
    DispatchThrottle(depth=0).tick(torch.device("cpu"))


def test_stream_option_validation():
    for bad in (dict(stream_prefetch=-1), dict(stream_prefetch=65), dict(stream_prefetch=True),
                dict(stream_dispatch_depth=-2), dict(stream_donate="maybe"),
                dict(stream_retries=-1), dict(stream_backoff=-0.5),
                dict(stream_backoff=float("inf")), dict(stream_slab_timeout=-1.0),
                dict(stream_checkpoint_every=-1), dict(stream_checkpoint_path="")):
        with pytest.raises(ValueError):
            flox_tpu_torch.set_options(**bad)
    with flox_tpu_torch.set_options(stream_prefetch=0, stream_dispatch_depth=0,
                                    stream_donate="off", stream_retries=0,
                                    stream_backoff=0.0, stream_slab_timeout=0.0,
                                    stream_checkpoint_every=0, stream_checkpoint_path=None):
        pass


def test_stream_options_match_reference_defaults_and_carry_over():
    from flox_tpu import options as ropts

    keys = [k for k in popts.OPTIONS if k.startswith("stream_")]
    assert len(keys) == 8
    ref_defaults = ropts.OPTIONS.copy()
    for k in keys:
        assert popts.OPTIONS[k] == ref_defaults[k], k
    with flox_tpu.set_options(stream_prefetch=5, stream_retries=7, stream_donate="off"):
        carried = popts.from_reference(dict(ropts.OPTIONS))
    assert (carried["stream_prefetch"], carried["stream_retries"],
            carried["stream_donate"]) == (5, 7, "off")
