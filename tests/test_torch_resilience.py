"""The port's resilience layer (flox_tpu_torch.resilience, faults) on the CPU.

Mirrors ``tests/test_resilience.py``, driving the port's own fault hooks:
the classifier (against the reference's verdicts, plus torch's
``OutOfMemoryError`` and the sticky CUDA errors, built as exceptions here),
retry and backoff, the OOM halving ladder, kill and resume, and the loader
contract. Results are held bit for bit to the port's own uninterrupted run,
and the uninterrupted runs to the reference's streaming results at the
1e-10 bar of ``tests/test_torch_streaming.py``. Not mirrored: the mesh cases
(ROADMAP A8b), the compile-count assertion of the reference's ladder
(nothing is traced here, so there is no retrace to count) and
``cache.clear_all`` (ROADMAP A9).
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

import flox_tpu
from flox_tpu import faults as rfaults
from flox_tpu import resilience as rres
from flox_tpu import streaming as rst
import flox_tpu_torch
from flox_tpu_torch import faults, profiling
from flox_tpu_torch.resilience import (DEVICE_LOST, FATAL, OOM, TRANSIENT, _SNAPSHOTS,
                                       RetryPolicy, StreamCounters, _ladder_half,
                                       classify_error, register_transient, seed_backoff)
from flox_tpu_torch.streaming import streaming_groupby_reduce as _psgr
from flox_tpu_torch.streaming import streaming_groupby_scan as _psgs


def streaming_groupby_reduce(*args, **kw):
    return _psgr(*args, device="cpu", **kw)


def streaming_groupby_scan(*args, **kw):
    return _psgs(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n = 3000
    vals = rng.normal(size=(3, n))
    vals[:, ::11] = np.nan
    labels = rng.integers(0, 7, n)
    return vals, labels


@pytest.fixture(autouse=True)
def _clean_snapshots():
    _SNAPSHOTS.clear()
    yield
    _SNAPSHOTS.clear()


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).tobytes()


def _stage_threads():
    return [t for t in threading.enumerate() if "flox-torch-stage" in t.name]


def _fresh_python(script):
    """Run ``script`` in a new interpreter (the port importable) and return
    the JSON its last line prints."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(flox_tpu_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------

_SHARED_CASES = [
    IOError("read failed"), OSError("connection reset"), ConnectionError("refused"),
    TimeoutError("slow backend"), BrokenPipeError(), ValueError("bad arg"),
    TypeError("not callable"), KeyError("missing"), IndexError("oob"),
    NotImplementedError("nope"), FileNotFoundError("/wrong/path/chunk.0.0"),
    PermissionError("denied"), IsADirectoryError("/data"), NotADirectoryError("/data/f/x"),
    MemoryError(),
]


class TestClassifier:
    @pytest.mark.parametrize("exc", _SHARED_CASES, ids=lambda e: type(e).__name__)
    def test_verdict_is_the_references(self, exc):
        assert classify_error(exc) == rres.classify_error(exc)

    @pytest.mark.parametrize("pair", [
        (faults.SimulatedOOM, rfaults.SimulatedOOM),
        (faults.StreamKilled, rfaults.StreamKilled),
        (faults.SimulatedDeviceLoss, rfaults.SimulatedDeviceLoss),
    ], ids=lambda p: p[0].__name__)
    def test_simulated_faults_classify_as_the_references(self, pair):
        mine, ref = pair
        assert classify_error(mine("slab")) == rres.classify_error(ref("slab"))
        assert str(mine("slab")) == str(ref("slab"))

    def test_non_recoverable_os_can_opt_back_in(self):
        from flox_tpu_torch.resilience import _TRANSIENT_TYPES

        assert classify_error(FileNotFoundError("s3 404")) == FATAL
        register_transient(FileNotFoundError)
        try:
            assert classify_error(FileNotFoundError("s3 404")) == TRANSIENT
        finally:
            _TRANSIENT_TYPES.remove(FileNotFoundError)

    def test_register_transient_extends(self):
        class ThrottlingError(Exception):
            pass

        assert classify_error(ThrottlingError()) == FATAL
        register_transient(ThrottlingError)
        assert classify_error(ThrottlingError()) == TRANSIENT
        with pytest.raises(TypeError):
            register_transient("not a type")

    def test_torch_out_of_memory_is_oom_by_type(self):
        # by type, whatever the message says
        assert classify_error(torch.cuda.OutOfMemoryError("allocator refused")) == OOM
        assert classify_error(torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB")) == OOM
        assert classify_error(RuntimeError("CUDA error: out of memory")) == OOM

    @pytest.mark.parametrize("msg", [
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: unspecified launch failure",
        "CUDA error: device-side assert triggered",
        "CUDA error: misaligned address",
        "CUDA error: an illegal instruction was encountered",
        # a sticky error whose text also names memory must not enter the ladder
        "CUDA error: an illegal memory access was encountered (out of memory?)",
    ])
    def test_sticky_cuda_errors_never_retry_or_split(self, msg):
        assert classify_error(RuntimeError(msg)) == DEVICE_LOST
        wrapped = ValueError("wrapper")
        wrapped.__cause__ = RuntimeError(msg)
        assert classify_error(wrapped) == DEVICE_LOST

    def test_accelerator_error_is_device_lost(self):
        acc = getattr(torch, "AcceleratorError", None)
        if acc is None:
            pytest.skip("this torch has no torch.AcceleratorError")
        try:
            exc = acc("CUDA error: something sticky")
        except TypeError:
            exc = acc.__new__(acc)
        assert classify_error(exc) == DEVICE_LOST

    def test_sticky_error_is_not_retried_by_the_stager(self, data):
        vals, labels = data
        flaky = faults.FlakyLoader(
            lambda s, e: vals[:, s:e],
            {1400: RuntimeError("CUDA error: unspecified launch failure")}, times=-1)
        with flox_tpu_torch.set_options(stream_retries=5, stream_backoff=0.001):
            with pytest.raises(RuntimeError, match="unspecified launch failure"):
                streaming_groupby_reduce(flaky, labels, func="nanmean", batch_len=700)
        assert flaky.loads_of(1400) == 1

    def test_sticky_error_in_a_step_never_enters_the_ladder(self, data):
        from flox_tpu_torch.resilience import dispatch_slab

        class _Slab:
            start, stop = 0, 10

        calls = []

        def apply_fn(carry, sl):
            calls.append(sl)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        with pytest.raises(RuntimeError, match="illegal memory access"):
            dispatch_slab(apply_fn, None, _Slab(), stager=object())
        assert len(calls) == 1


class TestClassifierWrappedChains:
    def test_cause_chain_unwraps_transient(self):
        outer = RuntimeError("loader wrapper")
        outer.__cause__ = IOError("read failed")
        assert classify_error(outer) == TRANSIENT

    def test_context_chain_unwraps_transient(self):
        try:
            try:
                raise IOError("flaky read")
            except IOError:
                raise ValueError("raised while handling")  # noqa: B904
        except ValueError as exc:
            assert classify_error(exc) == TRANSIENT

    def test_cause_chain_unwraps_oom_and_device_loss(self):
        outer = RuntimeError("wrapper")
        outer.__cause__ = torch.cuda.OutOfMemoryError("cuda oom")
        assert classify_error(outer) == OOM
        outer = KeyError("wrapper")
        outer.__cause__ = faults.SimulatedDeviceLoss("card")
        assert classify_error(outer) == DEVICE_LOST

    def test_nested_two_level_chain(self):
        mid = RuntimeError("mid wrapper")
        mid.__cause__ = OSError("socket reset")
        outer = RuntimeError("outer wrapper")
        outer.__cause__ = mid
        assert classify_error(outer) == TRANSIENT

    def test_plain_fatal_stays_fatal(self):
        outer = RuntimeError("genuine bug")
        outer.__cause__ = TypeError("still a bug")
        assert classify_error(outer) == FATAL

    def test_self_referential_chain_terminates(self):
        exc = RuntimeError("cyclic")
        exc.__context__ = exc
        assert classify_error(exc) == FATAL

    def test_transient_outer_never_consults_chain(self):
        outer = IOError("transient outer")
        outer.__cause__ = TypeError("fatal inner")
        assert classify_error(outer) == TRANSIENT


# ---------------------------------------------------------------------------
# retry with backoff and a per-slab deadline
# ---------------------------------------------------------------------------


class TestBackoffJitter:
    def test_full_jitter_spreads_within_cap(self):
        seed_backoff(7)
        delays = [RetryPolicy(backoff=0.1).delay(2) for _ in range(64)]
        cap = 0.1 * 4
        assert all(0 < d <= cap for d in delays)
        assert len({round(d, 9) for d in delays}) > 8
        assert min(delays) < cap / 4 and max(delays) > cap / 2

    def test_seeded_schedule_is_reproducible(self):
        policy = RetryPolicy(backoff=0.05)
        seed_backoff(123)
        first = [policy.delay(a) for a in range(6)]
        seed_backoff(123)
        assert [policy.delay(a) for a in range(6)] == first

    def test_zero_backoff_stays_zero(self):
        assert RetryPolicy(backoff=0.0).delay(3) == 0.0

    def test_jittered_retries_stay_bit_identical(self, data):
        vals, labels = data
        base, _ = streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=700)
        seed_backoff(99)
        flaky = faults.FlakyLoader(lambda s, e: vals[:, s:e], {700: IOError}, times=2)
        with flox_tpu_torch.set_options(stream_backoff=0.001):
            got, _ = streaming_groupby_reduce(flaky, labels, func="nanmean", batch_len=700)
        assert _bits(got) == _bits(base)
        assert flaky.loads_of(700) == 3


class TestRetryBackoff:
    @pytest.mark.parametrize("depth", [0, 2])
    def test_transient_fault_retried_bit_identical(self, data, depth):
        vals, labels = data
        base, _ = streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=700)
        ref, _ = rst.streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=700)
        np.testing.assert_allclose(base.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
        flaky = faults.FlakyLoader(lambda s, e: vals[:, s:e], {1400: IOError}, times=2)
        with flox_tpu_torch.set_options(stream_prefetch=depth, stream_backoff=0.001):
            with profiling.stream_monitor() as reports:
                got, _ = streaming_groupby_reduce(flaky, labels, func="nanmean", batch_len=700)
        assert _bits(got) == _bits(base)
        assert flaky.loads_of(1400) == 3  # two injected failures and the success
        assert reports[0].retries == 2 and reports[0].backoff_ms > 0
        assert "retries 2" in reports[0].summary()

    @pytest.mark.parametrize("depth", [0, 3])
    def test_exhausted_retries_surface_original_exception(self, data, depth):
        vals, labels = data
        with flox_tpu_torch.set_options(stream_prefetch=depth, stream_retries=2,
                                        stream_backoff=0.001):
            flaky = faults.FlakyLoader(lambda s, e: vals[:, s:e],
                                       {1400: IOError("loader died at 1400")}, times=3)
            with pytest.raises(IOError, match="loader died at 1400"):
                streaming_groupby_reduce(flaky, labels, func="nanmean", batch_len=700)
        time.sleep(0.05)
        assert not _stage_threads()

    def test_fatal_error_never_retried(self, data):
        vals, labels = data
        flaky = faults.FlakyLoader(lambda s, e: vals[:, s:e],
                                   {1400: TypeError("bug, not weather")}, times=-1)
        with flox_tpu_torch.set_options(stream_retries=5, stream_backoff=0.001):
            with pytest.raises(TypeError, match="bug, not weather"):
                streaming_groupby_reduce(flaky, labels, func="nanmean", batch_len=700)
        assert flaky.loads_of(1400) == 1

    def test_slab_deadline_bounds_backoff(self, data):
        vals, labels = data
        flaky = faults.FlakyLoader(lambda s, e: vals[:, s:e], {1400: IOError}, times=-1)
        t0 = time.perf_counter()
        with flox_tpu_torch.set_options(stream_retries=50, stream_backoff=30.0,
                                        stream_slab_timeout=0.05):
            with pytest.raises(TimeoutError, match="stream_slab_timeout"):
                streaming_groupby_reduce(flaky, labels, func="nanmean", batch_len=700)
        assert time.perf_counter() - t0 < 10.0

    def test_scan_and_quantile_retry_too(self, data):
        vals, labels = data
        base_scan = streaming_groupby_scan(vals, labels, func="nancumsum", batch_len=700)
        flaky = faults.FlakyLoader(lambda s, e: vals[:, s:e], {1400: IOError}, times=1)
        with flox_tpu_torch.set_options(stream_backoff=0.001):
            got = streaming_groupby_scan(flaky, labels, func="nancumsum", batch_len=700)
        assert _bits(got) == _bits(base_scan)
        v32 = vals.astype(np.float32)
        base_q, _ = streaming_groupby_reduce(v32, labels, func="nanmedian", batch_len=1000)
        flaky_q = faults.FlakyLoader(lambda s, e: v32[:, s:e], {1000: IOError}, times=2)
        with flox_tpu_torch.set_options(stream_backoff=0.001):
            got_q, _ = streaming_groupby_reduce(flaky_q, labels, func="nanmedian",
                                                batch_len=1000)
        assert _bits(got_q) == _bits(base_q)


# ---------------------------------------------------------------------------
# the OOM ladder
# ---------------------------------------------------------------------------


class TestOOMSplit:
    def test_reduce_split_completes_and_matches(self, data):
        vals, labels = data
        ref, _ = streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=700)
        with faults.inject(oom_at=[1400]) as plan:
            with profiling.stream_monitor() as reports:
                got, _ = streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=700)
        assert [rec for rec in plan.log if rec[0] == "SimulatedOOM"] == [
            ("SimulatedOOM", 1400, 2100)]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, equal_nan=True)
        assert reports[0].oom_splits == 1
        assert "oom-splits 1" in reports[0].summary()

    def test_real_torch_oom_in_a_step_splits(self, data, monkeypatch):
        # a step that raises torch's own OutOfMemoryError on a full-width slab
        # and fits at half the width: the ladder halves it once
        from flox_tpu_torch import streaming as pst

        vals, labels = data
        ref, _ = streaming_groupby_reduce(vals, labels, func="nansum", batch_len=700)
        real = pst._slab_stats
        widths = []

        def tight(agg, slab, *a, **kw):
            widths.append(slab.shape[-1])
            if slab.shape[-1] > 512:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
            return real(agg, slab, *a, **kw)

        monkeypatch.setattr(pst, "_slab_stats", tight)
        with profiling.stream_monitor() as reports:
            got, _ = streaming_groupby_reduce(vals, labels, func="nansum", batch_len=700)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12)
        assert max(w for w in widths if w <= 512) == 512
        assert reports[0].oom_splits == 4  # the four 700-wide slabs, not the 200-wide tail

    def test_position_reductions_split_exactly(self, data):
        vals, labels = data
        v = np.nan_to_num(vals, nan=0.5)
        ref, _ = streaming_groupby_reduce(v, labels, func="argmax", batch_len=700)
        with faults.inject(oom_at=[700, 2100]):
            got, _ = streaming_groupby_reduce(v, labels, func="argmax", batch_len=700)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        rref, _ = rst.streaming_groupby_reduce(v, labels, func="argmax", batch_len=700)
        np.testing.assert_array_equal(got.numpy(), np.asarray(rref))

    def test_recursive_split(self, data):
        vals, labels = data
        ref, _ = streaming_groupby_reduce(vals, labels, func="sum", batch_len=700)
        with faults.inject(oom_at=[1400], oom_times=2):
            with profiling.stream_monitor() as reports:
                got, _ = streaming_groupby_reduce(vals, labels, func="sum", batch_len=700)
        assert reports[0].oom_splits == 2
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12)

    def test_ladder_half_descends_for_any_quantum(self):
        for length, quantum in ((1000, 1), (512, 1), (3, 1), (1000, 8), (24, 6), (18, 6),
                                (12, 6)):
            assert _ladder_half(length, quantum) == rres._ladder_half(length, quantum)
        for quantum in (1, 2, 3, 5, 6, 7, 8):
            length = 16 * quantum
            while length > quantum:
                half = _ladder_half(length, quantum)
                assert quantum <= half < length and half % quantum == 0
                length = half

    def test_unsplittable_oom_surfaces(self, data):
        vals, labels = data
        with faults.inject(oom_at=[1400], oom_times=-1):
            with pytest.raises(faults.SimulatedOOM, match="RESOURCE_EXHAUSTED"):
                streaming_groupby_reduce(vals, labels, func="sum", batch_len=700)

    def test_highcard_hint_when_the_ladder_bottoms_out(self, data):
        from flox_tpu_torch.resilience import HighCardinalityOOMError

        vals, labels = data
        with flox_tpu_torch.set_options(sort_engine_min_groups=8):
            with faults.inject(oom_at=[1400], oom_times=-1):
                with pytest.raises(HighCardinalityOOMError, match="engine='sort'"):
                    streaming_groupby_reduce(vals, labels, func="sum", batch_len=700,
                                             expected_groups=np.arange(16), engine="torch")
        assert classify_error(HighCardinalityOOMError("x")) == FATAL

    def test_scan_split_forward_and_reverse(self, data):
        vals, labels = data
        for func in ("nancumsum", "bfill"):
            ref = streaming_groupby_scan(vals, labels, func=func, batch_len=700)
            with faults.inject(oom_at=[1400]):
                got = streaming_groupby_scan(vals, labels, func=func, batch_len=700)
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12, equal_nan=True)

    def test_quantile_split(self, data):
        vals, labels = data
        v32 = vals.astype(np.float32)
        ref, _ = streaming_groupby_reduce(v32, labels, func="nanmedian", batch_len=1000)
        with faults.inject(oom_at=[1000]):
            got, _ = streaming_groupby_reduce(v32, labels, func="nanmedian", batch_len=1000)
        assert _bits(got) == _bits(ref)  # counting passes are exact


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


class _KillScenario:
    """One kill and resume: ``baseline()`` the uninterrupted bytes, ``run()``
    the (killed, then resumed) attempt. The scan writes into a NaN-filled
    buffer, so a slab that neither run covers fails the comparison."""

    def __init__(self, kind, vals, labels, batch_len=500):
        self.kind = kind
        self.labels = labels
        self.batch_len = batch_len
        # float32 keys: 33 passes, not 65
        self.vals = vals.astype(np.float32) if kind == "quantile" else vals
        if kind == "scan":
            self.buf = np.full(vals.shape, np.nan)
        self.kill_plan = ({"kill_after": 8} if kind == "quantile"
                          else {"kill_at": [2 * batch_len]})

    def prepare(self):
        if self.kind == "scan":
            self.buf[...] = np.nan

    def run(self):
        if self.kind == "scan":
            r = streaming_groupby_scan(
                self.vals, self.labels, func="nancumsum", batch_len=self.batch_len,
                out=lambda s, e, res: self.buf.__setitem__((..., slice(s, e)), res))
            assert r is None
            return self.buf.tobytes()
        func = "nanmedian" if self.kind == "quantile" else "nanmean"
        got, _ = streaming_groupby_reduce(self.vals, self.labels, func=func,
                                          batch_len=self.batch_len)
        return _bits(got)

    def baseline(self):
        self.prepare()
        return self.run()


class TestKillResume:
    @pytest.mark.parametrize("depth", [0, 2])
    @pytest.mark.parametrize("kind", ["reduce", "scan", "quantile"])
    def test_single_device_bit_identical(self, data, kind, depth):
        vals, labels = data
        sc = _KillScenario(kind, vals, labels)
        with flox_tpu_torch.set_options(stream_prefetch=depth):
            base = sc.baseline()
            with flox_tpu_torch.set_options(stream_checkpoint_every=2):
                sc.prepare()
                with faults.inject(**sc.kill_plan):
                    with pytest.raises(faults.StreamKilled):
                        sc.run()
                assert len(_SNAPSHOTS) == 1
                with profiling.stream_monitor() as reports:
                    resumed = sc.run()
                assert reports[-1].counters.resumed_at is not None
        assert resumed == base
        assert _SNAPSHOTS == {}  # done() dropped the snapshot

    def test_resume_skips_processed_slabs(self, data):
        vals, labels = data
        calls = []

        def loader(s, e):
            calls.append((s, e))
            return vals[:, s:e]

        base, _ = streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=500)
        with flox_tpu_torch.set_options(stream_checkpoint_every=2):
            with faults.inject(kill_at=[4 * 500]):
                with pytest.raises(faults.StreamKilled):
                    streaming_groupby_reduce(loader, labels, func="nanmean", batch_len=500)
            calls.clear()
            got, _ = streaming_groupby_reduce(loader, labels, func="nanmean", batch_len=500)
        assert _bits(got) == _bits(base)
        assert min(s for s, e in calls if e - s > 1) == 4 * 500

    def test_npz_spill_survives_process_death(self, data, tmp_path):
        """Killed here, resumed in a fresh interpreter from the spill alone:
        the builtin legs (mean's and var's finalize, the arg legs) key the
        snapshot by name, so the second process finds it, starts from the
        dead run's cursor, matches the uninterrupted bits and deletes it."""
        vals, labels = data
        funcs = ("nanmean", "nanvar", "nanargmax")
        base = {}
        for func in funcs:
            base[func] = _bits(streaming_groupby_reduce(vals, labels, func=func,
                                                        batch_len=500)[0])
            with flox_tpu_torch.set_options(stream_checkpoint_every=2,
                                            stream_checkpoint_path=str(tmp_path / func)):
                with faults.inject(kill_at=[4 * 500]):
                    with pytest.raises(faults.StreamKilled):
                        streaming_groupby_reduce(vals, labels, func=func, batch_len=500)
            assert len(list((tmp_path / func).glob("*.npz"))) == 1
        np.savez(tmp_path / "data.npz", vals=vals, labels=labels)
        script = f"""
import json, sys
import numpy as np
import flox_tpu_torch
from flox_tpu_torch import profiling
z = np.load({str(tmp_path / "data.npz")!r})
out = {{}}
for func in {funcs!r}:
    with flox_tpu_torch.set_options(stream_checkpoint_every=2,
                                    stream_checkpoint_path={str(tmp_path)!r} + "/" + func):
        with profiling.stream_monitor() as reports:
            got, _ = flox_tpu_torch.streaming_groupby_reduce(
                z["vals"], z["labels"], func=func, batch_len=500, device="cpu")
    np.save({str(tmp_path)!r} + "/" + func + ".npy", got.numpy())
    out[func] = reports[-1].counters.resumed_at
print(json.dumps(out))
"""
        resumed = _fresh_python(script)
        for func in funcs:
            assert resumed[func] == 4, (func, resumed)
            assert _bits(np.load(tmp_path / f"{func}.npy")) == base[func], func
            assert list((tmp_path / func).glob("*.npz")) == [], func

    def test_builtin_checkpoint_identities_hold_across_processes(self):
        """Every builtin aggregation's and scan's checkpoint identity is the
        same string in a fresh interpreter; a lambda's is not reused."""
        src = """
import torch
from flox_tpu_torch.aggregations import AGGREGATIONS, SCANS, _initialize_aggregation
from flox_tpu_torch.streaming import _agg_identity, _scan_ckpt_id
out = {}
for name in sorted(AGGREGATIONS):
    kw = {"q": 0.5} if "quantile" in name else {}
    out[name] = _agg_identity(_initialize_aggregation(name, None, torch.float64, None, 0, kw))
for name in sorted(SCANS):
    out["scan:" + name] = _scan_ckpt_id(SCANS[name])
"""
        from flox_tpu_torch.aggregations import Scan
        from flox_tpu_torch.streaming import _scan_ckpt_id

        here = {}
        exec(src, here)
        assert _fresh_python(src + "print(__import__('json').dumps(out))") == here["out"]
        lam = Scan("cumsum", scan="cumsum", reduction="sum", binary_op=lambda a, b: a + b,
                   identity=0)
        assert str(id(lam.binary_op)) in _scan_ckpt_id(lam)

    def test_spill_round_trips_bfloat16_and_var_triples(self, tmp_path):
        from flox_tpu_torch.multiarray import MultiArray
        from flox_tpu_torch.resilience import Snapshot, _dump_snapshot, _load_snapshot

        payload = ([torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                    MultiArray((torch.ones(3), torch.zeros(3, dtype=torch.float64),
                                torch.full((3,), 2.0)))], torch.arange(3, dtype=torch.int32))
        path = str(tmp_path / "s.npz")
        _dump_snapshot(path, Snapshot(key=("k",), phase=3, slabs_done=5, payload=payload))
        snap = _load_snapshot(path, ("k",))
        assert (snap.phase, snap.slabs_done) == (3, 5)
        (bf, ma), cnt = snap.payload
        assert bf.dtype == torch.bfloat16 and torch.equal(bf, payload[0][0])
        assert all(torch.equal(a, b) for a, b in zip(ma.arrays, payload[0][1].arrays))
        assert torch.equal(cnt, payload[1])
        assert _load_snapshot(path, ("other",)) is None

    def test_corrupt_spill_falls_back_to_fresh_run(self, data, tmp_path):
        vals, labels = data
        base, _ = streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=500)
        target = tmp_path / "snap.npz"
        target.write_bytes(b"not an npz at all")
        with flox_tpu_torch.set_options(stream_checkpoint_every=2,
                                        stream_checkpoint_path=str(target)):
            with pytest.warns(RuntimeWarning, match="corrupt"):
                got, _ = streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=500)
        assert _bits(got) == _bits(base)

    def test_scan_without_writer_not_checkpointed(self, data):
        vals, labels = data
        with flox_tpu_torch.set_options(stream_checkpoint_every=1):
            streaming_groupby_scan(vals, labels, func="nancumsum", batch_len=500)
            with faults.inject(kill_at=[3 * 500]):
                with pytest.raises(faults.StreamKilled):
                    streaming_groupby_scan(vals, labels, func="nancumsum", batch_len=500)
            assert _SNAPSHOTS == {}

    def test_disabled_by_default(self, data):
        vals, labels = data
        with faults.inject(kill_at=[2 * 500]):
            with pytest.raises(faults.StreamKilled):
                streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=500)
        assert _SNAPSHOTS == {}

    def test_different_agg_identity_misses_stale_snapshot(self, data):
        vals, labels = data
        v32 = np.nan_to_num(vals, nan=0.0).astype(np.float32)
        base64, _ = streaming_groupby_reduce(v32, labels, func="nansum", dtype=np.float64,
                                             batch_len=500)
        with flox_tpu_torch.set_options(stream_checkpoint_every=2):
            with faults.inject(kill_at=[4 * 500]):
                with pytest.raises(faults.StreamKilled):
                    streaming_groupby_reduce(v32, labels, func="nansum", dtype=np.float32,
                                             batch_len=500)
            assert len(_SNAPSHOTS) == 1
            got, _ = streaming_groupby_reduce(v32, labels, func="nansum", dtype=np.float64,
                                              batch_len=500)
        assert _bits(got) == _bits(base64)
        assert len(_SNAPSHOTS) == 1  # the float32 snapshot was never touched

    def test_scan_checkpoint_identity_distinguishes_custom_scans(self):
        from flox_tpu_torch.aggregations import SCANS, Scan
        from flox_tpu_torch.streaming import _scan_ckpt_id

        builtin = SCANS["cumsum"]
        custom = Scan("cumsum", scan="cumsum", reduction="sum", binary_op=lambda a, b: a + b,
                      identity=0)
        assert _scan_ckpt_id(custom) != _scan_ckpt_id(builtin)
        assert _scan_ckpt_id(builtin) == _scan_ckpt_id(SCANS["cumsum"])

    def test_changed_data_tripwire_misses_stale_snapshot(self, data):
        vals, labels = data
        v2 = vals.copy()
        v2[:, 0] = 5.0  # column 0 is NaN in the fixture: the probe gets new bytes
        base2, _ = streaming_groupby_reduce(v2, labels, func="nanmean", batch_len=500)
        with flox_tpu_torch.set_options(stream_checkpoint_every=2):
            with faults.inject(kill_at=[4 * 500]):
                with pytest.raises(faults.StreamKilled):
                    streaming_groupby_reduce(vals, labels, func="nanmean", batch_len=500)
            assert len(_SNAPSHOTS) == 1
            got, _ = streaming_groupby_reduce(v2, labels, func="nanmean", batch_len=500)
        assert _bits(got) == _bits(base2)
        assert len(_SNAPSHOTS) == 1


# ---------------------------------------------------------------------------
# loader contract
# ---------------------------------------------------------------------------


class TestLoaderContract:
    @pytest.mark.parametrize("depth", [0, 2])
    def test_wrong_shape_names_slab_range(self, data, depth):
        vals, labels = data
        bad = faults.misshaping_loader(lambda s, e: vals[:, s:e], at=1400, shape=(3, 11))
        with flox_tpu_torch.set_options(stream_prefetch=depth):
            with pytest.raises(ValueError, match=r"slab \[1400:2100\).*\(3, 11\)"):
                streaming_groupby_reduce(bad, labels, func="nanmean", batch_len=700)

    def test_dtype_drift_names_slab_range(self, data):
        vals, labels = data

        def bad(s, e):
            sl = vals[:, s:e]
            return sl.astype(np.float32) if s >= 1400 else sl

        with pytest.raises(ValueError, match=r"slab \[1400:2100\).*float32"):
            streaming_groupby_reduce(bad, labels, func="nanmean", batch_len=700)

    def test_contract_violation_not_retried(self, data):
        vals, labels = data
        calls = []

        def bad(s, e):
            calls.append((s, e))
            return np.zeros((3, 5)) if s == 1400 else vals[:, s:e]

        with flox_tpu_torch.set_options(stream_retries=5, stream_backoff=0.001):
            with pytest.raises(ValueError, match="loader contract"):
                streaming_groupby_reduce(bad, labels, func="nanmean", batch_len=700)
        assert len([c for c in calls if c[0] == 1400]) == 1


class TestOptionValidation:
    @pytest.mark.parametrize("kwargs", [
        {"stream_retries": -1}, {"stream_retries": 2.5}, {"stream_retries": True},
        {"stream_backoff": -0.1}, {"stream_backoff": "fast"},
        {"stream_backoff": float("nan")}, {"stream_backoff": float("inf")},
        {"stream_slab_timeout": float("nan")}, {"stream_slab_timeout": -1},
        {"stream_checkpoint_every": -2}, {"stream_checkpoint_every": 1.5},
        {"stream_checkpoint_path": ""}, {"stream_checkpoint_path": 123},
    ], ids=str)
    def test_invalid_values_raise_at_set_time(self, kwargs):
        with pytest.raises(ValueError):
            flox_tpu_torch.set_options(**kwargs)
        with pytest.raises(ValueError):  # the reference refuses the same values
            flox_tpu.set_options(**kwargs)

    def test_valid_values_roundtrip(self, tmp_path):
        with flox_tpu_torch.set_options(stream_retries=0, stream_backoff=0,
                                        stream_slab_timeout=1.5, stream_checkpoint_every=3,
                                        stream_checkpoint_path=tmp_path):
            from flox_tpu_torch.options import OPTIONS

            assert OPTIONS["stream_checkpoint_every"] == 3
        assert RetryPolicy.from_options() == RetryPolicy()


class TestFaultHarness:
    def test_plan_is_deterministic(self, data):
        vals, labels = data
        logs = []
        for depth in (0, 2):
            with flox_tpu_torch.set_options(stream_prefetch=depth):
                with faults.inject(oom_at=[1400]) as plan:
                    streaming_groupby_reduce(vals, labels, func="sum", batch_len=700)
            logs.append(list(plan.log))
        assert logs[0] == logs[1]
        assert ("SimulatedOOM", 1400, 2100) in logs[0]

    def test_inject_nests_and_restores(self):
        assert not faults.active()
        with faults.inject(kill_after=100):
            assert faults.active()
            with faults.inject(oom_at=[0]):
                assert faults.active()
            assert faults.active()
        assert not faults.active()

    def test_poke_noop_without_plan(self):
        faults.poke(0, 100)

    def test_counters_are_threadsafe_accumulators(self):
        c = StreamCounters()

        def spin():
            for _ in range(1000):
                c.record_retry(0.001)

        ts = [threading.Thread(target=spin) for _ in range(4)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert c.retries == 4000
        assert abs(c.backoff_ms - 4000 * 1.0) < 1e-6


def test_staging_oom_enters_the_ladder(data):
    """A slab too large to stage (here the loader's own MemoryError for spans
    past 512 columns) comes out of the prefetch worker as an error slab, and
    the ladder stages it again in halves."""
    vals, labels = data
    ref, _ = streaming_groupby_reduce(vals, labels, func="nansum", batch_len=700)
    widths = []

    def loader(s, e):
        widths.append(e - s)
        if e - s > 512:
            raise MemoryError(f"cannot hold [{s}:{e})")
        return vals[:, s:e]

    for depth in (0, 2):
        with flox_tpu_torch.set_options(stream_prefetch=depth):
            with profiling.stream_monitor() as reports:
                got, _ = streaming_groupby_reduce(loader, labels, func="nansum", batch_len=700)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12)
        assert reports[0].oom_splits == 4
