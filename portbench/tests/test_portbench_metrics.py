"""The metric arithmetic and the readers (CPU, synthetic inputs)."""

import math
from types import SimpleNamespace

import pytest

from portbench import devtrace, tracemath
from portbench.spec import Spec

SPEC = Spec()
H100 = SPEC.peaks("NVIDIA H100 80GB HBM3")


def test_rate_is_all_bytes_over_the_whole_window():
    assert tracemath.rate_gbps(54.7e9, 400, 10.25) == pytest.approx(54.7 * 400 / 10.25)
    run = SimpleNamespace(calls=400, window_s=10.25, bytes_global=54.7e9)
    assert SPEC.reader("reduce_gbps")(run) == pytest.approx(2134.634146)
    assert SPEC.reader("reduce_gbps")(SimpleNamespace(calls=0, window_s=1.0,
                                                      bytes_global=1)) is None


def test_p95_over_all_calls_and_the_200_call_rule():
    assert tracemath.p95([0.01] * 199) is None
    calls = [i / 1000 for i in range(1, 201)]  # 1..200 ms
    assert tracemath.p95(calls) == pytest.approx(0.190)  # rank ceil(0.95 * 200) = 190
    run = SimpleNamespace(call_s=calls[::-1])
    assert SPEC.reader("call_p95_ms")(run) == pytest.approx(190.0)
    assert SPEC.reader("call_p95_ms")(SimpleNamespace(call_s=calls[:150])) is None
    assert tracemath.p95([0.001] * 299 + [1.0]) == pytest.approx(0.001)


def test_idle_share_from_synthetic_intervals():
    ops = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0), (90.0, 120.0)]
    assert tracemath.union(ops) == [(0.0, 20.0), (30.0, 40.0), (90.0, 120.0)]
    assert tracemath.busy_us(ops, 0.0, 100.0) == 40.0
    assert tracemath.gaps(ops, 0.0, 100.0) == [(20.0, 30.0), (40.0, 90.0)]
    assert tracemath.idle_share(ops, 0.0, 100.0) == pytest.approx(0.6)


def test_roofline_from_the_frozen_byte_formula():
    # month nanmean of the one-card ERA5 share: input, codes, one result leg
    nbytes = tracemath.call_bytes(519840, 26304, 4, 12, 1)
    assert nbytes == 519840 * 26304 * 4 + 26304 * 4 + 519840 * 12 * 4
    bound_s = nbytes / 3.35e12
    assert bound_s == pytest.approx(16.33e-3, rel=1e-3)
    assert tracemath.roofline_pct(nbytes, 3.35e12, 2 * bound_s) == pytest.approx(50.0)


def _trace(csrc_s=0.048, other_s=0.002, nccl_s=0.0, calls=2, wall_s=0.060, busy_s=0.051):
    return {"calls": calls, "wall_s": wall_s, "busy_s": busy_s, "ops": 10,
            "kind_s": {"csrc": csrc_s, "nccl": nccl_s, "other": other_s},
            "span_s": {"groupby_reduce": 0.004, "factorize": 0.0002}, "entry": "groupby_reduce"}


def test_per_layer_readers():
    nbytes = 3.35e12 * 0.012  # 12 ms at the peak
    run = SimpleNamespace(trace=_trace(), peaks=H100, bytes_card=nbytes)
    assert SPEC.reader("kernel_roofline")(run) == pytest.approx(50.0)  # 24 ms a call
    assert SPEC.reader("other_device_ms")(run) == pytest.approx(1.0)
    assert SPEC.reader("factorize_ms")(run) == pytest.approx(0.1)
    assert SPEC.reader("host_call_ms")(run) == pytest.approx(2.0)
    assert SPEC.reader("device_idle_pct")(run) == pytest.approx(15.0)
    assert SPEC.reader("collective_ms")(run) is None  # no NCCL: nothing, never 0
    run.trace = _trace(nccl_s=0.02)
    assert SPEC.reader("collective_ms")(run) == pytest.approx(10.0)
    run.trace = _trace(csrc_s=0.0)
    assert SPEC.reader("kernel_roofline")(run) is None
    run.trace, run.peaks = _trace(), None
    assert SPEC.reader("kernel_roofline")(run) is None
    assert SPEC.reader("factorize_ms")(SimpleNamespace(trace=None)) is None


def test_kernel_names_and_kinds():
    names = tracemath.csrc_kernels()
    assert {"segment_reduce_kernel", "radixbin_kernel"} <= set(names)
    kind = tracemath.kind
    assert kind("void segment_reduce_kernel<float, 2>(float const*, int)", names) == "csrc"
    assert kind("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", names) == "nccl"
    assert kind("void at::native::vectorized_elementwise_kernel<4>", names) == "other"
    assert kind("my_segment_reduce_kernel_copy", names) == "other"


def test_summary_labels_gaps_by_the_open_span():
    calls = [(1.0, 1.010), (1.010, 1.020)]  # seconds
    ops = [("void segment_reduce_kernel<float>", 1.002e6, 1.009e6),
           ("memcpy", 1.012e6, 1.013e6), ("void segment_reduce_kernel<float>", 1.013e6, 1.019e6)]
    spans = [("groupby_reduce", 1.0e6, 1.0015e6), ("groupby_reduce/factorize", 1.0e6, 1.0005e6),
             ("groupby_reduce", 1.010e6, 1.0115e6)]
    s = devtrace.summarize(ops, spans, calls, ["segment_reduce_kernel"], "groupby_reduce")
    assert s["calls"] == 2 and s["wall_s"] == pytest.approx(0.020)
    assert s["busy_s"] == pytest.approx(0.014)
    assert s["kind_s"]["csrc"] == pytest.approx(0.013) and s["kind_s"]["other"] == pytest.approx(
        0.001)
    idle = dict(s["idle_gaps"])
    assert idle["groupby_reduce/factorize"] == pytest.approx(0.0005)
    assert idle["groupby_reduce"] == pytest.approx(0.001 + 0.0015)
    assert idle["harness (between calls)"] == pytest.approx(0.0005 + 0.001 + 0.0005 + 0.001)
    assert s["span_s"]["groupby_reduce"] == pytest.approx(0.003)
    assert s["device_ops"][0] == ["void segment_reduce_kernel<float>", pytest.approx(0.013)]


def _slice(shift_us=0.0, drop_call=None, csrc_us=7000.0):
    """Two 10 ms calls, each with one hand-written kernel and one copy;
    ``shift_us`` moves every op on the host clock, ``drop_call`` loses a
    call's ops."""
    calls = [(1.0, 1.010), (1.010, 1.020)]
    ops = []
    for i, (t0, _) in enumerate(calls):
        if i == drop_call:
            continue
        a = t0 * 1e6 + 1000.0 + shift_us
        ops += [("void segment_reduce_kernel<float>", a, a + csrc_us),
                ("memcpy", a + csrc_us + 500.0, a + csrc_us + 1000.0)]
    return devtrace.summarize(ops, [], calls, ["segment_reduce_kernel"], "groupby_reduce")


def test_device_times_need_no_host_clock():
    """An offset between the clocks moves no device time: the profiler holds
    the slice's ops alone, so their durations are read whole."""
    aligned, shifted = _slice(), _slice(shift_us=2.07e6)
    for key in ("busy_s", "kind_s", "device_ops", "ops"):
        assert shifted[key] == aligned[key], key
    assert aligned["busy_s"] == pytest.approx(0.015)


def test_a_slice_that_cannot_be_read_fails_loudly():
    nbytes = 3.35e12 * 0.005  # 5 ms at the peak: the kernel's 7 ms is 71 %
    assert devtrace.faults(_slice(), nbytes, 3.35e12) == []
    assert devtrace.faults(_slice(shift_us=500.0), nbytes, 3.35e12) == []  # within tolerance
    shifted = devtrace.faults(_slice(shift_us=2.07e6), nbytes, 3.35e12)
    assert any("outside the slice" in f for f in shifted)
    assert any("2 of the slice's 2 calls" in f for f in shifted)
    assert any("1 of the slice's 2 calls" in f
               for f in devtrace.faults(_slice(drop_call=1), nbytes, 3.35e12))
    over = devtrace.faults(_slice(), 3.35e12 * 0.008, 3.35e12)  # 8 ms: over 100 %
    assert len(over) == 1 and "under the" in over[0]
    assert devtrace.faults(_slice(), 3.35e12 * 0.008, None) == []  # no peak known
    empty = devtrace.summarize([], [], [(1.0, 1.01)], [], "groupby_reduce")
    assert devtrace.faults(empty, nbytes, 3.35e12) == ["the profiler recorded no device operation"]
    busy = dict(_slice(), busy_s=0.03)
    assert any("busy" in f for f in devtrace.faults(busy, nbytes, 3.35e12))


def test_calls_without_device_work():
    ops = [(0.0, 10.0), (20.0, 30.0), (100.0, 110.0)]
    calls = [(0.0, 5e-6), (12e-6, 18e-6), (40e-6, 50e-6), (105e-6, 200e-6)]
    assert tracemath.calls_without(ops, calls, 1.0) == 2
    assert tracemath.calls_without(ops, calls, 3.0) == 1  # (12, 18) widened reaches both


def test_span_paths_align_on_the_calls():
    records = [{"type": "span", "name": "groupby_reduce", "id": 1, "parent": None,
                "ts_us": 10.0, "dur_us": 100.0},
               {"type": "span", "name": "factorize", "id": 2, "parent": 1,
                "ts_us": 12.0, "dur_us": 5.0}]
    spans = devtrace.span_paths(records, "groupby_reduce", [(2.0, 2.001)])
    assert spans[0] == ("groupby_reduce", pytest.approx(2e6), pytest.approx(2e6 + 100))
    assert spans[1][0] == "groupby_reduce/factorize"
    assert spans[1][1] == pytest.approx(2e6 + 2)
    assert math.isclose(spans[1][2] - spans[1][1], 5.0)


class _FakeCell:
    """A cell whose call sleeps ``call_s``: the window's loop alone."""

    def __init__(self, call_s):
        from types import SimpleNamespace

        self.call_s = call_s
        self.seed = 3
        self.device = SimpleNamespace(type="cpu")
        self.traffic = {"entry": "groupby_reduce"}

    def sync(self):
        pass

    def timed_call(self):
        import time

        t0 = time.perf_counter()
        time.sleep(self.call_s)
        return ("result",), t0, time.perf_counter()


@pytest.mark.parametrize("plan", [(5, 4), (50, 4), (2, 30)])
def test_window_profiles_one_slice(monkeypatch, plan):
    """One profiled slice of the planned length, started once: at its call
    or half-way through the window, whichever comes first, and held open
    past the deadline until it has its calls."""
    from portbench import cellrun

    started = []

    class FakeSlice:
        def __init__(self, device_type):
            started.append(device_type)

        def start(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(cellrun.devtrace, "Slice", FakeSlice)
    monkeypatch.setattr(cellrun.Window, "_slice_start", lambda self: (
        setattr(self, "slice", FakeSlice("cpu")), self.slice.start(),
        setattr(self, "slicing", True)))
    monkeypatch.setattr(cellrun.Window, "_slice_stop", lambda self: (
        setattr(self, "slicing", False), setattr(self, "trace_slice", None)))
    w = cellrun.Window(_FakeCell(0.01), 0.2, plan)
    w.run()
    assert len(started) == 1
    assert len(w.slice_calls) == plan[1]
    assert w.kept == ("result",) and 0 <= w.kept_index < len(w.times)
    assert w.window_s >= 0.2 and w.failed == 0


@pytest.mark.parametrize("first", [1, 5, 40])
def test_mesh_window_asks_rank_0_at_checkpoints(first):
    """With ``agree``, the loop asks only at its checkpoints, runs the
    number of calls rank 0 names, and ends once rank 0 names none."""
    from portbench import cellrun

    asked = []

    def agree(more):
        asked.append(more)
        return more

    w = cellrun.Window(_FakeCell(0.01), 0.2, None, agree, first)
    w.run()
    assert asked[-1] == 0 and all(m > 0 for m in asked[:-1])
    assert len(asked) <= 4  # not a host exchange a call
    assert w.window_s >= 0.2 and len(w.times) >= first
