"""Arithmetic of the benchmark's numbers: intervals, percentiles, bytes.

Pure Python over plain lists, so the CPU tests hold every formula here. The
device trace arrives as ``(name, start_us, end_us)`` triples and the
program's spans as ``(path, start_us, end_us)`` triples, both on the host's
``perf_counter`` clock in microseconds.
"""

from __future__ import annotations

import bisect
import math
import re
from pathlib import Path

from . import spec

P95_MIN_CALLS = 200  # a 95th percentile with ten calls beyond it
CSRC = spec.ROOT / "flox_tpu_torch" / "csrc"

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def p95(values: list[float]) -> float | None:
    """The nearest-rank 95th percentile, or ``None`` under
    :data:`P95_MIN_CALLS` values."""
    if len(values) < P95_MIN_CALLS:
        return None
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]


def rate_gbps(bytes_per_call: float, calls: int, window_s: float) -> float:
    """Bytes of all the calls completed in the window over its wall time."""
    return bytes_per_call * calls / window_s / 1e9


def call_bytes(rows: int, cols: int, itemsize: int, groups: int, legs: int,
               out_itemsize: int = 4, code_itemsize: int = 4) -> int:
    """The bytes a grouped reduction must move: its input once, its codes
    once, each result leg once."""
    return rows * cols * itemsize + cols * code_itemsize + legs * rows * groups * out_itemsize


def union(intervals: list[tuple[float, float]], lo: float = -math.inf,
          hi: float = math.inf) -> list[tuple[float, float]]:
    """The intervals merged, clipped to ``[lo, hi]``."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def calls_without(intervals, calls: list[tuple[float, float]], tolerance_us: float) -> int:
    """How many calls (``(start_s, end_s)``) no interval overlaps, each call
    widened by ``tolerance_us`` on both sides."""
    merged = union(intervals)
    ends = [b for _, b in merged]
    missing = 0
    for t0, t1 in calls:
        i = bisect.bisect_right(ends, t0 * 1e6 - tolerance_us)  # the first that ends after
        if i == len(merged) or merged[i][0] >= t1 * 1e6 + tolerance_us:
            missing += 1
    return missing


def idle_share(intervals, lo: float, hi: float) -> float:
    return 1.0 - busy_us(intervals, lo, hi) / (hi - lo)


def roofline_pct(nbytes: float, bytes_per_s: float, seconds: float) -> float:
    """The least time the bytes take at the peak rate, as a share of
    ``seconds``, in percent."""
    return 100.0 * (nbytes / bytes_per_s) / seconds


def csrc_kernels(csrc: Path = CSRC) -> list[str]:
    """The names of the program's hand-written CUDA kernels: every
    ``__global__`` function under ``flox_tpu_torch/csrc``."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return sorted(names)


def kind(name: str, kernels: list[str]) -> str:
    """``"csrc"``, ``"nccl"`` or ``"other"`` for a device op's name."""
    if "nccl" in name.lower():
        return "nccl"
    if any(re.search(rf"\b{k}\b", name) for k in kernels):
        return "csrc"
    return "other"


def label_at(t: float, spans: list[tuple[str, float, float]], idle: str) -> str:
    """The innermost span open at ``t``, or ``idle``."""
    best, width = idle, math.inf
    for path, a, b in spans:
        if a <= t <= b and b - a < width:
            best, width = path, b - a
    return best


def attribute(a: float, b: float, spans: list[tuple[str, float, float]],
              idle: str) -> list[tuple[str, float]]:
    """The stretch ``[a, b]`` cut at every span boundary inside it, each piece
    labelled by the innermost span open over it (or ``idle``)."""
    inside = [s for s in spans if s[1] < b and s[2] > a]
    cuts = sorted({a, b} | {t for _, s0, s1 in inside for t in (s0, s1) if a < t < b})
    return [(label_at((x + y) / 2, inside, idle), y - x) for x, y in zip(cuts, cuts[1:])]


def top(pairs: dict, n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]
