"""A device trace of a short slice of the window, and the program's spans.

``torch.profiler`` records the device's operations (CUPTI) from just before
the slice's first call to just after its last call's synchronize, so every
operation it holds belongs to the slice: the device times are sums of the
operations' own durations, which need no clock but the device's. The
program's own telemetry spans (on only in a traced run) say what the host
was doing. To label the idle gaps both come onto the host's ``perf_counter``
clock in microseconds: the profiler's through an anchor range recorded at a
known ``perf_counter`` time, the spans' through the calls' own start times.
A slice whose operations do not then fall inside its calls is not read
(:func:`faults`).
"""

from __future__ import annotations

import math
import statistics
import time

from . import tracemath

ANCHOR = "portbench.anchor"


class Slice:
    """Profiles the calls made between :meth:`start` and :meth:`stop`."""

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type
        self.prof = None
        self.anchor = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.anchor = time.perf_counter()
        with record_function(ANCHOR):
            pass

    def stop(self) -> None:
        self.prof.stop()

    def device_ops(self) -> list[tuple[str, float, float]]:
        """``(name, start_us, end_us)`` of every device operation."""
        from torch.autograd import DeviceType

        events = list(self.prof.events())
        anchors = [e for e in events if e.name == ANCHOR and e.device_type == DeviceType.CPU]
        if not anchors:
            return []
        offset = self.anchor * 1e6 - anchors[0].time_range.start
        return [(e.name, e.time_range.start + offset, e.time_range.end + offset)
                for e in events
                if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def span_paths(records: list[dict], entry: str,
               calls: list[tuple[float, float]]) -> list[tuple[str, float, float]]:
    """The spans as ``(path, start_us, end_us)`` on the ``perf_counter``
    clock: the path joins the names from the root down; the offset is the
    median gap between each call's start and its root span's."""
    spans = [r for r in records if r.get("type") == "span"]
    by_id = {r["id"]: r for r in spans}

    def path(r):
        names = []
        while r is not None:
            names.append(r["name"])
            r = by_id.get(r.get("parent"))
        return "/".join(reversed(names))

    roots = sorted((r for r in spans if r["name"] == entry and r.get("parent") not in by_id),
                   key=lambda r: r["ts_us"])
    if not roots or not calls:
        return []
    pairs = list(zip(calls[-len(roots):], roots[-len(calls):]))
    offset = statistics.median(t0 * 1e6 - r["ts_us"] for (t0, _), r in pairs)
    return [(path(r), r["ts_us"] + offset, r["ts_us"] + r["dur_us"] + offset) for r in spans]


TOLERANCE_US = 1000.0  # how far an aligned operation may stray past its call


def summarize(ops, spans, calls: list[tuple[float, float]], kernels: list[str],
              entry: str) -> dict:
    """What the per-layer readers read of one traced slice. ``ops`` are
    every operation the profiler recorded, all of them the slice's."""
    lo, hi = calls[0][0] * 1e6, calls[-1][1] * 1e6
    intervals = [(a, b) for _, a, b in ops]
    by_kind = {"csrc": 0.0, "nccl": 0.0, "other": 0.0}
    by_name: dict = {}
    for n, a, b in ops:
        by_kind[tracemath.kind(n, kernels)] += (b - a) / 1e6
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    idle: dict = {}
    for a, b in tracemath.gaps(intervals, lo, hi):
        for label, us in tracemath.attribute(a, b, spans, "harness (between calls)"):
            idle[label] = idle.get(label, 0.0) + us / 1e6
    span_s: dict = {}
    for p, a, b in spans:
        if a >= lo - 1.0 and b <= hi + 1.0:
            leaf = p.rsplit("/", 1)[-1]
            span_s[leaf] = span_s.get(leaf, 0.0) + (b - a) / 1e6
    busy = tracemath.busy_us(intervals, -math.inf, math.inf)
    return {
        "calls": len(calls),
        "wall_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "ops": len(ops),
        "kind_s": by_kind,
        "span_s": span_s,
        "entry": entry,
        "device_ops": tracemath.top(by_name),
        "idle_gaps": tracemath.top(idle),
        "outside_s": (busy - tracemath.busy_us(intervals, lo - TOLERANCE_US,
                                               hi + TOLERANCE_US)) / 1e6,
        "calls_without_ops": tracemath.calls_without(intervals, calls, TOLERANCE_US),
    }


def faults(summary: dict, bytes_per_call: float, bytes_per_s: float | None) -> list[str]:
    """Why a traced slice on a card cannot be read, or nothing: no device
    operation; operations that, aligned to the host clock, fall outside the
    slice or leave a call without one (an offset between the clocks, or
    operations lost); the device busier than the slice was long; the
    hand-written kernels faster than the peak memory rate allows for the
    bytes a call must move (operations counted short)."""
    if summary["ops"] == 0:
        return ["the profiler recorded no device operation"]
    out = []
    if summary["outside_s"] > 0.01 * summary["busy_s"]:
        out.append(f"{summary['outside_s']:.6f} s of the {summary['busy_s']:.6f} s of device "
                   "operations fall outside the slice's calls on the host clock")
    if summary["calls_without_ops"]:
        out.append(f"{summary['calls_without_ops']} of the slice's {summary['calls']} calls "
                   "hold no device operation")
    if summary["busy_s"] > 1.01 * summary["wall_s"]:
        out.append(f"the device was busy {summary['busy_s']:.6f} s in a slice of "
                   f"{summary['wall_s']:.6f} s")
    csrc = summary["kind_s"]["csrc"] / summary["calls"]
    if bytes_per_s and 0 < csrc < bytes_per_call / bytes_per_s:
        out.append(f"the hand-written kernels took {csrc * 1e3:.6f} ms a call, under the "
                   f"{bytes_per_call / bytes_per_s * 1e3:.6f} ms that the call's bytes take at "
                   "the peak memory rate")
    return out
