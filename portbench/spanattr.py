"""Device time by the program span that launched it, on the profiler's clock.

While a ``torch.profiler`` records, each of the program's telemetry spans is
also a ``record_function`` range of the profiler's trace (a host range on
the thread that opened it). CUPTI gives each device op the correlation id of
the runtime call that launched it, and ``torch.profiler`` links it besides
to the CPU op it ran under. So an op is tied to its launch through its
correlation id, and to the innermost range open on the launching thread at
that launch, all on the profiler's own clock: no offset between two clocks
is guessed, and the op's own time plays no part. An op launched outside
every range counts under :data:`NONE`.

Pure Python over plain tuples, so the CPU tests hold every rule here;
:func:`from_events` reads them out of the profiler's events.
"""

from __future__ import annotations

NONE = "(none)"
#: the steps whose device ops are the work around the kernels: the
#: elementwise passes after a kernel returns, the eager combine, the finalize
LEGS = ("legs", "combine", "finalize")


def innermost(ranges: list[tuple[str, float, float]],
              queries: list[tuple[float, object]]) -> dict:
    """``{key: name}`` of the innermost range open at each query's time
    (``(t, key)``), or ``None`` where none is. Ranges nest as spans do;
    one that starts at a query's time holds it, as one that ends there."""
    events = [(a, 0, i) for i, (_, a, _) in enumerate(ranges)]
    events += [(t, 1, k) for t, k in queries]
    events += [(b, 2, i) for i, (_, _, b) in enumerate(ranges)]
    events.sort(key=lambda e: (e[0], e[1]))
    stack: list[int] = []
    out: dict = {}
    for _, what, x in events:
        if what == 0:
            stack.append(x)
        elif what == 1:
            out[x] = ranges[stack[-1]][0] if stack else None
        elif stack and stack[-1] == x:
            stack.pop()
        else:
            stack.remove(x)
    return out


def span_device_s(ops: list[tuple[int, int, float, float]], launches: dict, cpu_ops: dict,
                  ranges: list[tuple[str, int, float, float]]) -> dict[str, float]:
    """Device seconds by the innermost span's name (:data:`NONE` outside
    every span).

    ``ops``: ``(correlation, linked correlation, start_us, end_us)`` of each
    device op; ``launches``: ``{correlation: (thread, t_us)}`` of the runtime calls;
    ``cpu_ops``: ``{correlation: (thread, t_us)}`` of the CPU ops, for an op
    whose launch the trace lacks; ``ranges``: ``(name, thread, start_us,
    end_us)`` of the span ranges. A launch is looked up among its own
    thread's ranges, or among all where its thread opened none (the
    profiler may number a runtime call's thread apart from its ops')."""
    threads: dict = {}
    for name, tid, a, b in ranges:
        threads.setdefault(tid, []).append((name, a, b))
    every = [(name, a, b) for name, _, a, b in ranges]
    queries: dict = {}
    for i, (corr, linked, _, _) in enumerate(ops):
        at = launches.get(corr) or cpu_ops.get(linked)
        if at is None:
            continue
        tid, t = at
        queries.setdefault(tid if tid in threads else None, []).append((t, i))
    names: dict = {}
    for tid, qs in queries.items():
        names.update(innermost(threads[tid] if tid is not None else every, qs))
    out: dict[str, float] = {}
    for i, (_, _, a, b) in enumerate(ops):
        name = names.get(i) or NONE
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def span_nbytes(records: list[dict]) -> dict[str, float]:
    """The ``nbytes`` attributes of the telemetry span records, summed by
    span name."""
    out: dict[str, float] = {}
    for r in records:
        if r.get("type") == "span" and "nbytes" in r.get("attrs", {}):
            out[r["name"]] = out.get(r["name"], 0.0) + float(r["attrs"]["nbytes"])
    return out


def from_events(events, names=None) -> tuple[list, dict, dict, list]:
    """``(ops, launches, cpu_ops, ranges)`` for :func:`span_device_s` out of
    ``torch.profiler``'s events (``prof.events()``). Device ops are the
    CUDA events that are not annotations; ranges the host annotations named
    in ``names`` (the program's spans; all where ``None``: torch opens
    ranges of its own, such as ``nccl:all_reduce`` inside a collective);
    launches the CUDA API calls (``cuda*``, ``cu*``)."""
    from torch.autograd import DeviceType

    ops, launches, cpu_ops, ranges = [], {}, {}, []
    for e in events:
        note = bool(getattr(e, "is_user_annotation", False))
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not note:
                ops.append((e.id, getattr(e, "linked_correlation_id", 0) or 0, start, end))
        elif e.device_type == DeviceType.CPU:
            if note:
                if names is None or e.name in names:
                    ranges.append((e.name, e.thread, start, end))
            elif e.name.startswith("cu"):
                launches[e.id] = (e.thread, start)
            else:
                cpu_ops[e.id] = (e.thread, start)
    return ops, launches, cpu_ops, ranges


def span_names(records: list[dict]) -> set:
    """The names of the program's spans among the telemetry records."""
    return {r["name"] for r in records if r.get("type") == "span"}


def summary_keys(events, records: list[dict]) -> dict:
    """The two keys a traced slice's summary gains: ``span_device_s`` (over
    the ranges of the spans among ``records``) and ``span_nbytes``."""
    return {"span_device_s": span_device_s(*from_events(events, span_names(records))),
            "span_nbytes": span_nbytes(records)}


def legs_device_ms(trace: dict) -> float | None:
    """Device ms a call of the ops launched innermost under :data:`LEGS`, or
    ``None`` where no such span ran."""
    by = (trace or {}).get("span_device_s") or {}
    if not any(k in by for k in LEGS):
        return None
    return sum(by.get(k, 0.0) for k in LEGS) / trace["calls"] * 1e3
