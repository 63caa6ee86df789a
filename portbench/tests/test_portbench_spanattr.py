"""Device ops charged to the span that launched them, and the new readers
(CPU, synthetic inputs)."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import cellrun, devtrace, spanattr, tracemath
from portbench.spec import Spec

SPEC = Spec()


def test_ops_go_to_the_innermost_span_of_their_launch_not_of_their_time():
    ranges = [("groupby_reduce", 1, 0.0, 100.0), ("dispatch", 1, 10.0, 90.0),
              ("launch", 1, 20.0, 21.0), ("legs", 1, 30.0, 40.0)]
    launches = {7: (1, 20.5), 8: (1, 35.0), 9: (1, 95.0), 10: (1, 150.0)}
    # each op ran on the card long after its launch, some inside other ranges
    ops = [(7, 0, 200.0, 20200.0), (8, 0, 20200.0, 23200.0), (9, 0, 23200.0, 24200.0),
           (10, 0, 300.0, 2300.0), (11, 0, 35.0, 4035.0)]
    got = spanattr.span_device_s(ops, launches, {}, ranges)
    assert got == pytest.approx({"launch": 0.020, "legs": 0.003, "groupby_reduce": 0.001,
                                 spanattr.NONE: 0.002 + 0.004})  # 11: no launch in the trace


def test_an_op_without_its_launch_follows_its_cpu_op():
    ranges = [("collective", 1, 0.0, 10.0)]
    ops = [(5, 42, 0.0, 5e5), (6, 43, 5.0, 2.5e5 + 5.0)]
    got = spanattr.span_device_s(ops, {}, {42: (1, 4.0), 43: (1, 12.0)}, ranges)
    assert got == {"collective": 0.5, spanattr.NONE: 0.25}


def test_threads_keep_their_own_ranges():
    ranges = [("legs", 1, 0.0, 10.0), ("stage", 2, 0.0, 3.0)]
    launches = {1: (2, 5.0),  # thread 2 opened ranges, none open at 5.0
                2: (2, 1.0),
                3: (99, 5.0)}  # a thread that opened none: every range is looked at
    ops = [(1, 0, 0.0, 1e6), (2, 0, 0.0, 2e6), (3, 0, 0.0, 4e6)]
    got = spanattr.span_device_s(ops, launches, {}, ranges)
    assert got == {spanattr.NONE: 1.0, "stage": 2.0, "legs": 4.0}


def test_innermost_bounds_and_nesting():
    ranges = [("a", 0.0, 10.0), ("b", 2.0, 4.0), ("c", 4.0, 6.0)]
    got = spanattr.innermost(ranges, [(0.0, "t0"), (3.0, "t3"), (4.0, "t4"), (10.0, "t10"),
                                      (11.0, "t11")])
    assert got == {"t0": "a", "t3": "b", "t4": "c", "t10": "a", "t11": None}


def test_ranges_that_are_no_span_are_left_out():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_event("collective", cpu, 0.0, 100.0, note=True),
              _event("nccl:all_reduce", cpu, 10.0, 90.0, note=True),  # torch's own range
              _event("cudaLaunchKernel", cpu, 20.0, 25.0, eid=3),
              _event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", cuda, 30.0, 530.0, eid=3)]
    records = [{"type": "span", "name": "collective", "attrs": {"nbytes": 8}}]
    got = spanattr.summary_keys(events, records)
    assert got["span_device_s"] == pytest.approx({"collective": 500e-6})
    every = spanattr.span_device_s(*spanattr.from_events(events))
    assert every == pytest.approx({"nccl:all_reduce": 500e-6})


def test_span_nbytes_sums_by_name():
    records = [{"type": "span", "name": "collective", "attrs": {"nbytes": 10}},
               {"type": "span", "name": "collective", "attrs": {"nbytes": 5}},
               {"type": "span", "name": "launch", "attrs": {"nbytes": 7, "kernel": "k"}},
               {"type": "span", "name": "legs", "attrs": {}},
               {"type": "event", "name": "retry", "attrs": {"nbytes": 3}}]
    assert spanattr.span_nbytes(records) == {"collective": 15.0, "launch": 7.0}


def _event(name, device, start, end, eid=0, linked=0, thread=1, note=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=note,
                           time_range=SimpleNamespace(start=start, end=end), id=eid,
                           linked_correlation_id=linked, thread=thread)


def _replayed_window(skew=0.0):
    """A window with a slice of two calls replayed: the profiler's events and
    the telemetry records as a traced run leaves them, the device's clock
    ``skew`` us off the host's."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_event(devtrace.ANCHOR, cpu, 0.0, 0.0, note=True)]
    records = []
    for c in range(2):
        t = 100.0 + 1000.0 * c
        events += [
            _event("groupby_reduce", cpu, t, t + 800.0, note=True),
            _event("dispatch", cpu, t + 50.0, t + 700.0, note=True),
            _event("launch", cpu, t + 100.0, t + 110.0, note=True),
            _event("legs", cpu, t + 200.0, t + 260.0, note=True),
            _event("cudaLaunchKernel", cpu, t + 105.0, t + 108.0, eid=10 + c),
            _event("aten::div", cpu, t + 210.0, t + 220.0, eid=500 + c),
            _event("cudaLaunchKernel", cpu, t + 212.0, t + 215.0, eid=20 + c, linked=500 + c),
            _event("groupby_reduce", cuda, t + 300.0, t + 700.0, note=True),  # an annotation
            _event("void flox::segment_reduce_kernel<float>", cuda, t + 120.0 + skew,
                   t + 600.0 + skew, eid=10 + c),
            _event("void at::native::vectorized_elementwise_kernel<4>", cuda, t + 600.0 + skew,
                   t + 640.0 + skew, eid=20 + c, linked=500 + c),
        ]
        records += [
            {"type": "span", "name": "groupby_reduce", "id": 10 * c + 1, "parent": None,
             "ts_us": t, "dur_us": 800.0, "attrs": {}},
            {"type": "span", "name": "dispatch", "id": 10 * c + 3, "parent": 10 * c + 1,
             "ts_us": t + 50.0, "dur_us": 650.0, "attrs": {}},
            {"type": "span", "name": "launch", "id": 10 * c + 2, "parent": 10 * c + 3,
             "ts_us": t + 100.0, "dur_us": 10.0, "attrs": {"kernel": "segment_sum",
                                                           "nbytes": 4096}},
            {"type": "span", "name": "legs", "id": 10 * c + 4, "parent": 10 * c + 3,
             "ts_us": t + 200.0, "dur_us": 60.0, "attrs": {}},
        ]
    w = cellrun.Window(SimpleNamespace(traffic={"entry": "groupby_reduce"}), 1.0)
    w.slice = devtrace.Slice("cuda")
    w.slice.prof = SimpleNamespace(events=lambda: events)
    w.slice.anchor = 0.0
    w.records = records
    w.slice_calls = [((100.0 + 1000.0 * c) / 1e6, (900.0 + 1000.0 * c) / 1e6) for c in range(2)]
    return w


def _with_span_keys(w, kernels):
    """The harness's summary of a replayed slice, and the same with the two
    keys of :func:`spanattr.summary_keys` added."""
    before = w.trace(kernels)
    return before, {**before, **spanattr.summary_keys(w.slice.prof.events(), w.records)}


def test_the_summary_keeps_every_key_it_had():
    kernels = ["segment_reduce_kernel"]
    before, after = _with_span_keys(_replayed_window(), kernels)
    assert set(after) == set(before) | {"span_device_s", "span_nbytes"}
    assert {k: after[k] for k in before} == before
    assert before["kind_s"]["csrc"] == pytest.approx(2 * 480e-6)  # the annotation is no op
    assert after["span_device_s"] == pytest.approx({"launch": 2 * 480e-6, "legs": 2 * 40e-6})
    assert after["span_device_s"]["launch"] == pytest.approx(after["kind_s"]["csrc"])
    assert after["span_nbytes"] == {"launch": 8192.0}
    assert spanattr.legs_device_ms(after) == pytest.approx(0.040)


def test_a_skewed_device_clock_leaves_device_time_by_span_as_it_is():
    kernels = ["segment_reduce_kernel"]
    _, true = _with_span_keys(_replayed_window(), kernels)
    _, skewed = _with_span_keys(_replayed_window(skew=-40.0), kernels)
    assert skewed["span_device_s"] == pytest.approx(true["span_device_s"])


def _trace(span_s=None, nccl_s=0.0, calls=4):
    return {"calls": calls, "wall_s": 1.0, "busy_s": 0.9, "ops": 10,
            "kind_s": {"csrc": 0.5, "nccl": nccl_s, "other": 0.1},
            "span_s": span_s or {"groupby_reduce": 0.1}, "entry": "groupby_reduce"}


def test_bins_ms_reads_the_bins_spans():
    read = SPEC.reader("bins_ms")
    assert read(SimpleNamespace(trace=_trace({"groupby_reduce": 0.1, "bins": 0.002}))) == \
        pytest.approx(0.5)
    assert read(SimpleNamespace(trace=_trace())) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_collective_gbps_reads_what_the_cell_must_move():
    read = SPEC.reader("collective_gbps")
    # era5-doy-4card: the whole grid's 1,038,240 rows, 6576 hours a card,
    # 366 days of the year; a mean all-reduces sums and counts
    card = tracemath.call_bytes(721 * 1440, 26304 // 4, 4, 366, 1)
    run = SimpleNamespace(world=4, bytes_card=card, trace=_trace(nccl_s=0.08))  # 20 ms a call
    want = 2 * 721 * 1440 * 366 * 4
    assert read(run) == pytest.approx(want / 0.020 / 1e9)
    assert read(SimpleNamespace(world=4, bytes_card=card + 4, trace=run.trace)) is None
    assert read(SimpleNamespace(world=1, bytes_card=card, trace=run.trace)) is None
    assert read(SimpleNamespace(world=4, bytes_card=card, trace=_trace())) is None  # no NCCL
    assert read(SimpleNamespace(world=4, bytes_card=card, trace=None)) is None


def test_legs_device_ms():
    assert spanattr.legs_device_ms({"calls": 2, "span_device_s": {
        "legs": 0.010, "finalize": 0.002, "launch": 0.5}}) == pytest.approx(6.0)
    assert spanattr.legs_device_ms({"calls": 2, "span_device_s": {"launch": 0.5}}) is None
    assert spanattr.legs_device_ms({"calls": 2}) is None
