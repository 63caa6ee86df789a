#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (flox_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--reps 10]

Phases; any failure exits nonzero:

1. build the CUDA kernels from flox_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together;
2. hold each kernel against its plain PyTorch version on the card: the
   segment-sum kernel over {plain, kahan, dd} x {float32, bfloat16} x
   size {1, 12, 512} x {random, sorted codes} with NaN, +-inf and
   out-of-range codes, bit-identical to the radix-binning kernel on the same
   input, plus the reference's Kahan and double-double accuracy bars and
   run-to-run bit identity; the segment-sum and multi-statistic kernels'
   sums and markers bit-identical to a float32 column-order emulation of
   their walk at {37, 64, 600} rows (full and partial 256-row tiles), and
   their empty results at N = 0 without a launch; the segment-min/max kernel over {min, max} x {float32,
   bfloat16, int32} x size {1, 12, 128}, exactly; the multi-statistic kernel
   over {plain, kahan, dd} x {float32, bfloat16} x size {1, 12, 128}, its
   sums and markers bit-identical to the segment-sum kernel's and its
   extrema to the segment-min/max kernel's on NaN-parked data; the
   segmented-cumsum kernel over {cumsum, nancumsum} x {float32, bfloat16} x
   size {1, 12, 127} within ``n_g * u * cumsum|x|`` plus one ulp, with the
   reference's overflow, NaN and stickiness cases; the radix-binning kernel
   over {plain, kahan, dd} x {float32, bfloat16} x size {12, 512, 513, 1096,
   4096, 16384} x {sorted, random codes} x {37, 600} rows at the
   segment-sum kernel's bars with exact markers and bit-identical reruns, on
   random codes bit-identical to the same data with its columns gathered
   into code order, and at ({64, 600}, 2048) over 513 groups bit-identical
   to a float32 column-order emulation of its discipline in torch;
3. drive the main path on (lat*lon, time) = (65160, 26304) float32 data made
   on the card from ``--seed`` with the month labels of the repo's benchmark
   (12 groups): ``groupby_reduce`` nanmean, nanmax and var;
   ``groupby_aggregate_many`` of (nanmean, nanmin, nanmax) and of the
   climatology set (count, nanmean, nanstd, nanmin, nanmax);
   ``groupby_scan`` nancumsum and cumsum; ffill on a cut of 2048 rows; the
   daily means and sums (``np.arange(26304) // 24``, 1096 groups, the
   radix-binning kernel); and the sort engine on a cut of 8192 rows, with
   the days counted from 1940-01-01 over a 36524-day universe. Each call
   runs with the launch counts set to 0 just before it, must launch exactly
   its kernels, and is checked against a float64 (or exact) reduction of the
   same data on the card (the sort engine against the daily call, bit for
   bit);
4. time, with CUDA events (median of ``--reps`` runs after a warm-up), each
   kernel at the main path's shapes against its bound, its plain version and
   one library call (or a labelled yardstick), and the end-to-end calls; the
   radix-binning kernel also on random codes over 4096 groups and on skewed
   codes, and the segment-sum and multi-statistic kernels on code patterns
   off the main path (:func:`pattern_times`: hour of day, random codes over
   12 groups, and for the segment-sum kernel over 512), each output first
   held against the plain version; then, from a ``torch.profiler`` trace
   (:func:`device_breakdown`), each kernel wrapper's and end-to-end call's
   device busy time, the share in this repo's kernels, and the device's
   idle share.

It then prints the peak device memory, the card's name and power limit, one
JSON line of the kernels, and, last, ``{"ok": true, "device": {...}}``.
Without CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
U32 = 2.0**-24  # unit roundoff of float32

NLAT, NLON, NTIME, NGROUPS = 181, 360, 26304, 12
NDAYS = NTIME // 24  # 1096 day groups of the hourly steps
DAY0 = 29220  # 2020-01-01 in days since 1940-01-01, ERA5's first day
NUNIVERSE = 36524  # the days 1940-01-01 to 2039-12-31
SORT_ROWS = 8192  # the sort engine's cut: its dense result is scattered on the host
DEVICE = "cuda"


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def month_labels(ntime: int) -> np.ndarray:
    """Month-of-year labels of hourly steps, as the repo's benchmark makes them."""
    day = np.arange(ntime, dtype=np.int64) // 24
    return ((day % 365) // 30.44).astype(np.int32) % 12


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality that counts NaN equal to NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])
    return torch.equal(a, b)


def bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def abs_sums(data: torch.Tensor, codes: torch.Tensor, size: int) -> torch.Tensor:
    """Per (group, row) sum of |finite values| in float64: the scale of a sum's
    rounding error."""
    x = torch.where(torch.isfinite(data), data.abs(), 0).double()
    idx = torch.where((codes >= 0) & (codes < size), codes, size).long()
    out = torch.zeros((data.shape[0], size + 1), dtype=torch.float64, device=data.device)
    return out.index_add_(1, idx, x)[:, :size].T


def _sum_bar(accum: str, n: int, scale: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The segment-sum kernels' bar against their plain version, per (group,
    row), with S = ``scale``: plain, (n + chunks + 5) u S (the plain
    version's running sum, <= (n - 1) u S, plus the kernel's sequential walk,
    <= (n_g - 1) u S, with room for the chunk tree of an earlier design);
    kahan and dd, 8 u S + 1 ulp (the compensated walk's own error, <= 2 u S
    + O(n u^2) S, the carry, <= 2 u |s|, and the final rounding)."""
    if accum == "plain":
        return (n + -(-n // 32) + 5) * U32 * scale
    return 8 * U32 * scale + want.double().abs() * 2 * U32


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from flox_tpu_torch import _build

    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    print(f"[build] {seconds:.2f} s wall for {sorted(report) or 'nothing (already built)'}")
    for name, r in report.items():
        print(f"[build] {name}: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    for name in _build.SOURCES:
        _build.library(name)  # loads, or raises
    return seconds


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _sum_case(gen, k, n, size, dtype):
    dev = DEVICE
    data = torch.randn((k, n), generator=gen, device=dev) * 10
    r = torch.rand((k, n), generator=gen, device=dev)
    data[r < 0.03] = float("nan")
    data[(r >= 0.03) & (r < 0.04)] = float("inf")
    data[(r >= 0.04) & (r < 0.05)] = float("-inf")
    codes = torch.randint(-1, size + 3, (n,), generator=gen, device=dev, dtype=torch.int32)
    return data.to(dtype), codes


def phase_kernels(seed: int) -> dict:
    from flox_tpu_torch import cuda_kernels as ck

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    worst = {"segment_sum": 0.0, "segment_minmax": 0.0}
    k, n = 37, 4099  # odd shapes: ragged stages and row tiles
    for size, dtype in itertools.product((1, 12, 512), (torch.float32, torch.bfloat16)):
        data, codes = _sum_case(gen, k, n, size, dtype)
        for order in ("random", "sorted"):
            if order == "sorted":
                codes = torch.sort(codes).values
            scale = abs_sums(data, codes, size)
            oracle = ck.segment_sum_raw_plain(data, codes, size, "dd")[0]  # f64-accumulated
            idx = torch.where((codes >= 0) & (codes < size), codes, size).long()
            n_g = torch.bincount(idx, minlength=size + 1)[:size, None].double()
            for accum in ("plain", "kahan", "dd"):
                got = ck.segment_sum_raw(data, codes, size, accum)
                again = ck.segment_sum_raw(data, codes, size, accum)
                want = ck.segment_sum_raw_plain(data, codes, size, accum)
                radixbin = ck.segment_sum_radixbin_raw(data, codes, size, accum)
                torch.cuda.synchronize()
                tag = f"segment_sum size={size} {dtype} {order} {accum}"
                check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)),
                      f"{tag}: two launches differ")
                check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, radixbin)),
                      f"{tag}: differs from segment_sum_radixbin_raw")
                for i, name in ((1, "nan"), (2, "+inf"), (3, "-inf")):
                    check(torch.equal(got[i], want[i]), f"{tag}: {name} counts differ")
                err = (got[0].double() - want[0].double()).abs()
                if accum == "plain":
                    # the kernel alone: a sequential f32 sum of the group's
                    # n_g columns, <= (n_g - 1) u S, plus one ulp for the
                    # rounding of the float64 sum to float32
                    own = (got[0].double() - oracle.double()).abs()
                    ulp = torch.abs(oracle).double() * 2 * U32
                    check(bool((own <= (n_g - 1).clamp(min=0) * U32 * scale + ulp).all()),
                          f"{tag}: off the float64 sum by {own.max().item()}")
                check(bool((err <= _sum_bar(accum, n, scale, want[0])).all()),
                      f"{tag}: max |kernel - plain| {err.max().item()}")
                worst["segment_sum"] = max(worst["segment_sum"], err.max().item())
    print("[kernels] segment-sum sweep: bit-identical to the radix-binning kernel on random and "
          "sorted codes; markers exact; plain within (n_g - 1) u S + 1 ulp of float64")
    _walk_emulation_sweep(ck, gen)
    _accuracy_bars(ck)
    for size in (1, 12, 128):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            if dtype == torch.int32:
                data = torch.randint(-10**6, 10**6, (k, n), generator=gen, device=DEVICE,
                                     dtype=torch.int32)
            else:
                data = torch.randn((k, n), generator=gen, device=DEVICE)
                data[torch.rand((k, n), generator=gen, device=DEVICE) < 0.001] = float("nan")
                data = data.to(dtype)
            codes = torch.randint(-1, size + 3, (n,), generator=gen, device=DEVICE,
                                  dtype=torch.int32)
            for op in ("min", "max"):
                got = ck.segment_minmax(data, codes, size, op)
                again = ck.segment_minmax(data, codes, size, op)
                want = ck.segment_minmax_plain(data, codes, size, op)
                torch.cuda.synchronize()
                tag = f"segment_minmax size={size} {dtype} {op}"
                check(same(got, again), f"{tag}: two launches differ")
                check(same(got, want), f"{tag}: differs from the plain version")
    worst["segment_multistat"] = _multistat_sweep(ck, gen, k, n)
    worst["segment_cumsum"] = _cumsum_sweep(ck, gen, k, n)
    _scan_semantics(ck)
    worst["segment_sum_radixbin"] = _radixbin_sweep(ck, gen, k, n)
    print(f"[kernels] all sweeps agree; max |segment_sum - plain| {worst['segment_sum']!r}, "
          f"|segment_multistat - plain| {worst['segment_multistat']!r}, "
          f"|segment_cumsum - plain| {worst['segment_cumsum']!r}, "
          f"|segment_sum_radixbin - plain| {worst['segment_sum_radixbin']!r}")
    return worst


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _column_order_sums(data, codes, size: int, accum: str):
    """The function of the segment-sum, multi-statistic and radix-binning
    kernels' walk emulated in float32 torch ops:
    per (group, row), a sequential walk over the group's columns in column
    order, each non-finite value zero-filled and counted, under the plain,
    kahan or dd discipline of csrc/segment_reduce.cuh and
    csrc/segment_radixbin.cu, one torch op per rounded float operation (so
    nothing is fused or contracted). Step t
    updates every group's t-th column at once, vectorised over rows.
    Returns ``(sums, nan_c, pos_c, neg_c)``, each (size, K) float32."""
    k, n = data.shape
    dev = data.device
    x = data.float()
    idx = torch.where((codes >= 0) & (codes < size), codes, size).long()
    sidx, order = torch.sort(idx, stable=True)
    counts = torch.bincount(sidx, minlength=size + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sidx]
    hi = torch.zeros((size + 1, k), device=dev)
    lo, nan_c, pos_c, neg_c = (torch.zeros_like(hi) for _ in range(4))
    for t in range(int(counts[:size].max())):
        sel = (rank == t) & (sidx < size)
        g, v = sidx[sel], x[:, order[sel]].T
        isnan, ispos, isneg = torch.isnan(v), torch.isposinf(v), torch.isneginf(v)
        nan_c[g] += isnan.float()
        pos_c[g] += ispos.float()
        neg_c[g] += isneg.float()
        z = torch.where(isnan | ispos | isneg, 0.0, v)
        h, l = hi[g], lo[g]
        if accum == "plain":
            h = h + z
        elif accum == "kahan":
            y = z - l
            tt = h + y
            l = (tt - h) - y
            h = tt
        else:
            c = z * 4097.0
            z_hi = c - (c - z)
            z_lo = z - z_hi
            huge = z.abs() > 8e34
            z_hi = torch.where(huge, z, z_hi)
            z_lo = torch.where(huge, 0.0, z_lo)
            s, e1 = _two_sum(z_hi, z_lo)
            h, e2 = _two_sum(h, s)
            h, l = _two_sum(h, l + (e1 + e2))
        hi[g], lo[g] = h, l
    return hi[:size], nan_c[:size], pos_c[:size], neg_c[:size]


def _walk_emulation_sweep(ck, gen) -> None:
    """B1 and B2 against the column-order emulation of their walk
    (:func:`_column_order_sums`), bit for bit, sums and markers, at 37, 64
    and 600 rows (one partial 256-row tile, two full ones and a partial one)
    over {plain, kahan, dd} x {float32, bfloat16} x {random, sorted codes} x
    size {1, 12, 128, 512} (B2 to its cap of 128); then both at N = 0, where
    they return the empty-group values without a launch."""
    for rows, dtype in itertools.product((37, 64, 600), (torch.float32, torch.bfloat16)):
        for size in (1, 12, 128, 512):
            data, codes = _sum_case(gen, rows, 2048, size, dtype)
            for order in ("random", "sorted"):
                if order == "sorted":
                    codes = torch.sort(codes).values
                for accum in ("plain", "kahan", "dd"):
                    want = _column_order_sums(data, codes, size, accum)
                    got = ck.segment_sum_raw(data, codes, size, accum)
                    multi = ck.segment_multistat(data, codes, size, accum) if size <= 128 else ()
                    torch.cuda.synchronize()
                    tag = f"({rows}, 2048) size={size} {dtype} {order} {accum}"
                    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
                          f"segment_sum {tag}: differs from the column-order emulation")
                    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(multi[:4], want)),
                          f"segment_multistat {tag}: differs from the column-order emulation")
    ck.reset_launches()
    empty = torch.zeros((37, 0), device=DEVICE)
    none = torch.zeros(0, dtype=torch.int32, device=DEVICE)
    sums = ck.segment_sum_raw(empty, none, 12, "kahan")
    multi = ck.segment_multistat(empty, none, 12, "kahan")
    check(all(t.shape == (12, 37) and not t.any() for t in (*sums, *multi[:4]))
          and bool(torch.isposinf(multi[4]).all()) and bool(torch.isneginf(multi[5]).all()),
          "N = 0: the empty-group values differ")
    check(not any(ck.LAUNCHES.values()), f"N = 0: launches {ck.LAUNCHES}")
    print("[kernels] segment-sum and multi-statistic walks: the column-order emulation bit for "
          "bit at 37, 64 and 600 rows; N = 0 gives the empty-group values with no launch")


def _radixbin_sweep(ck, gen, k: int, n: int) -> float:
    """B5 against its plain version at B1's bars, with the markers exact and
    reruns bit-identical, over sorted and random codes, each with -1 and
    out-of-range codes; on random codes, bit-identical to B5 on the same data
    with its columns gathered by the stable argsort of the codes and the codes
    sorted (the gather path against the contiguous one); and, at 2048 columns
    over 513 groups, bit-identical to the column-order emulation of its
    discipline (:func:`_column_order_sums`). Each check runs at ``k`` rows
    (within one 256-row tile of the kernel) and at 600 rows (two full tiles
    and a partial one)."""
    worst = 0.0
    for rows in (64, 600):
        for dtype in (torch.float32, torch.bfloat16):
            data, codes = _sum_case(gen, rows, 2048, 513, dtype)
            for order in ("random", "sorted"):
                if order == "sorted":
                    codes = torch.sort(codes).values
                for accum in ("plain", "kahan", "dd"):
                    got = ck.segment_sum_radixbin_raw(data, codes, 513, accum)
                    want = _column_order_sums(data, codes, 513, accum)
                    torch.cuda.synchronize()
                    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
                          f"segment_sum_radixbin ({rows}, 2048) size=513 {dtype} {order} "
                          f"{accum}: differs from the column-order emulation")
    for size, rows, dtype in itertools.product((12, 512, 513, 1096, 4096, 16384), (k, 600),
                                               (torch.float32, torch.bfloat16)):
        data, codes = _sum_case(gen, rows, n, size, dtype)
        for order in ("random", "sorted"):
            if order == "sorted":
                codes = torch.sort(codes).values
            scale = abs_sums(data, codes, size)
            for accum in ("plain", "kahan", "dd"):
                tag = f"segment_sum_radixbin ({rows}, {n}) size={size} {dtype} {order} {accum}"
                got = ck.segment_sum_radixbin_raw(data, codes, size, accum)
                again = ck.segment_sum_radixbin_raw(data, codes, size, accum)
                want = ck.segment_sum_radixbin_plain(data, codes, size, accum)
                if order == "random":
                    sorted_codes, perm = torch.sort(codes, stable=True)
                    gathered = ck.segment_sum_radixbin_raw(
                        data[:, perm].contiguous(), sorted_codes, size, accum)
                    torch.cuda.synchronize()
                    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, gathered)),
                          f"{tag}: differs from the same columns gathered into code order")
                torch.cuda.synchronize()
                check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)),
                      f"{tag}: two launches differ")
                for i, name in ((1, "nan"), (2, "+inf"), (3, "-inf")):
                    check(torch.equal(got[i], want[i]), f"{tag}: {name} counts differ")
                err = (got[0].double() - want[0].double()).abs()
                check(bool((err <= _sum_bar(accum, n, scale, want[0])).all()),
                      f"{tag}: max |kernel - plain| {err.max().item()}")
                worst = max(worst, err.max().item())
    print("[kernels] radix-binning sweep: the column-order emulation bit for bit; random codes "
          "equal to their columns gathered into code order bit for bit; markers exact; sums "
          "within B1's bars")
    return worst


def _multistat_sweep(ck, gen, k: int, n: int) -> float:
    """B2 against B1, B3 and its plain version: sums and markers bit-identical
    to segment_sum_raw, extrema exactly segment_minmax's on NaN-parked data,
    sums within segment_sum's bar of the plain version, reruns bit-identical."""
    worst = 0.0
    for size in (1, 12, 128):
        for dtype in (torch.float32, torch.bfloat16):
            data, codes = _sum_case(gen, k, n, size, dtype)
            isnan = torch.isnan(data)
            lo = torch.where(isnan, float("inf"), data).to(dtype)
            hi = torch.where(isnan, float("-inf"), data).to(dtype)
            scale = abs_sums(data, codes, size)
            for accum in ("plain", "kahan", "dd"):
                got = ck.segment_multistat(data, codes, size, accum)
                again = ck.segment_multistat(data, codes, size, accum)
                raw = ck.segment_sum_raw(data, codes, size, accum)
                mins = ck.segment_minmax(lo, codes, size, "min")
                maxs = ck.segment_minmax(hi, codes, size, "max")
                want = ck.segment_multistat_plain(data, codes, size, accum)
                torch.cuda.synchronize()
                tag = f"segment_multistat size={size} {dtype} {accum}"
                check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)),
                      f"{tag}: two launches differ")
                check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got[:4], raw)),
                      f"{tag}: sums or markers differ from segment_sum_raw")
                check(torch.equal(bits(got[4]), bits(mins)) and torch.equal(bits(got[5]),
                                                                            bits(maxs)),
                      f"{tag}: extrema differ from segment_minmax on NaN-parked data")
                for i in (1, 2, 3):
                    check(torch.equal(got[i], want[i]), f"{tag}: markers differ from plain")
                check(same(got[4], want[4]) and same(got[5], want[5]),
                      f"{tag}: extrema differ from the plain version")
                err = (got[0].double() - want[0].double()).abs()
                check(bool((err <= _sum_bar(accum, n, scale, want[0])).all()),
                      f"{tag}: max |kernel - plain| {err.max().item()}")
                worst = max(worst, err.max().item())
    return worst


def _cumsum_bound(x: torch.Tensor, idx: torch.Tensor, groups: int) -> torch.Tensor:
    """``n_g * u * cumsum|x|`` per element of ``x`` (K, N), float64: the
    rounding-error bound of a float32 grouped running sum in any order."""
    ax = torch.where(torch.isfinite(x), x.double().abs(), 0.0)
    out = torch.zeros_like(ax)
    for g in range(groups):
        cols = torch.nonzero(idx == g).squeeze(1)
        if cols.numel():
            out[:, cols] = cols.numel() * U32 * torch.cumsum(ax[:, cols], dim=1)
    return out


def _cumsum_agrees(got, want, x, idx, groups, tag) -> float:
    """Non-finite positions equal; finite ones within the bound plus one ulp
    of the result in its dtype. Returns the max |got - want|."""
    g, w = got.double(), want.double()
    check(torch.equal(torch.isnan(g), torch.isnan(w)), f"{tag}: NaN positions differ")
    check(torch.equal(torch.isposinf(g), torch.isposinf(w))
          and torch.equal(torch.isneginf(g), torch.isneginf(w)), f"{tag}: inf positions differ")
    fin = torch.isfinite(w)
    ulp = torch.where(fin, w, 0.0).abs() * (2.0**-7 if got.dtype == torch.bfloat16 else 2.0**-23)
    err = torch.where(fin, (g - w).abs(), 0.0)
    tol = _cumsum_bound(x, idx, groups) + ulp
    check(bool((err <= tol).all()), f"{tag}: max |kernel - plain| {err.max().item()}")
    return err.max().item()


def _cumsum_sweep(ck, gen, k: int, n: int) -> float:
    worst = 0.0
    for size in (1, 12, 127):
        for dtype in (torch.float32, torch.bfloat16):
            # few non-finite values, so that most running sums stay finite
            data = torch.randn((k, n), generator=gen, device=DEVICE) * 10
            data[torch.rand((k, n), generator=gen, device=DEVICE) < 0.002] = float("nan")
            data[0, n // 3], data[-1, n // 2] = float("inf"), float("-inf")
            data = data.to(dtype)
            codes = torch.randint(-1, size + 3, (n,), generator=gen, device=DEVICE,
                                  dtype=torch.int32)
            idx = torch.where((codes >= 0) & (codes < size), codes, size)
            for skipna in (False, True):
                got = ck.segment_cumsum(data, codes, size, skipna)
                again = ck.segment_cumsum(data, codes, size, skipna)
                want = ck.segment_cumsum_plain(data, codes, size, skipna)
                torch.cuda.synchronize()
                tag = f"segment_cumsum size={size} {dtype} skipna={skipna}"
                check(torch.equal(bits(got), bits(again)), f"{tag}: two launches differ")
                check(got.dtype == dtype and got.shape == data.shape, f"{tag}: {got.dtype}")
                worst = max(worst, _cumsum_agrees(got, want, data, idx, size + 1, tag))
    return worst


def _scan_semantics(ck) -> None:
    """The reference's IEEE cases for its scan kernel (tests/test_kernels.py,
    TestPallasScan), on the CUDA kernel."""

    def scan(vals, codes, size, skipna=False):
        data = torch.from_numpy(np.asarray(vals, np.float32).reshape(1, -1)).to(DEVICE)
        c = torch.from_numpy(np.asarray(codes, np.int32)).to(DEVICE)
        return ck.segment_cumsum(data, c, size, skipna)[0].cpu().numpy()

    n = 1100
    codes = np.arange(n) % 2
    vals = np.where(codes == 0, 3e38, 1.0)
    got = scan(vals, codes, 2)
    check(np.array_equal(got[codes == 1], np.arange(1, n // 2 + 1, dtype=np.float32))
          and np.isposinf(got[codes == 0][-1]) and not np.isnan(got).any(),
          "scan: a carry overflow leaked into another group")
    vals = np.full(n, 3e38)
    vals[400:] = -3e38
    got = scan(vals, np.zeros(n), 1)
    check(np.isposinf(got[1:]).all() and np.isfinite(got[0]),
          "scan: opposite-sign overflow did not keep the first inf")
    vals = np.zeros(200)
    vals[:2], vals[5] = 3e38, -np.inf
    got = scan(vals, np.zeros(200), 1)
    check(np.isposinf(got[1:5]).all() and np.isnan(got[5:]).all(),
          "scan: overflow then an opposite inf is not NaN")
    vals = np.ones(400)
    vals[30] = np.nan
    codes = np.arange(400) % 3
    got = scan(vals, codes, 3)
    g0 = np.flatnonzero(codes == 0)
    check(np.isnan(got[g0[g0 >= 30]]).all() and np.isfinite(got[g0[g0 < 30]]).all()
          and np.isfinite(got[codes != 0]).all(), "scan: NaN did not poison just its group")
    rng = np.random.default_rng(99)
    vals = rng.choice([-1.0, 1.0], 1600) * rng.uniform(1e38, 3e38, 1600)
    codes = np.arange(1600) % 3
    for skipna in (False, True):
        got = scan(vals, codes, 3, skipna)
        for g in range(3):
            ok = np.isfinite(got[codes == g])
            first_bad = int(np.argmax(~ok)) if (~ok).any() else len(ok)
            check(ok[:first_bad].all() and not ok[first_bad:].any(),
                  f"scan: group {g} (skipna={skipna}) left its non-finite state")
    print("[kernels] scan IEEE cases hold (carry overflow, opposite signs, NaN, stickiness)")


def _accuracy_bars(ck) -> None:
    """The reference's bars for its Pallas kernel (tests/test_kernels.py:
    test_pallas_kahan_accuracy and TestPallasDoubleDouble), on the kernel."""

    def ksum(data_n, codes, size, accum):
        data = torch.from_numpy(np.ascontiguousarray(data_n.reshape(1, -1))).to(DEVICE)
        out = ck.segment_sum(data, torch.from_numpy(codes).to(DEVICE), size, accum)
        return out[:, 0].double().cpu().numpy()

    rng = np.random.default_rng(0)
    data = rng.normal(1e4, 1, size=100_000).astype(np.float32)
    codes = np.zeros(data.size, np.int32)
    oracle = data.astype(np.float64).sum()
    kahan, plain = ksum(data, codes, 1, "kahan")[0], ksum(data, codes, 1, "plain")[0]
    ulp = float(np.spacing(np.float32(oracle)))
    check(abs(kahan - oracle) <= ulp, f"kahan bar: |{kahan} - {oracle}| > 1 ulp")
    check(abs(kahan - oracle) <= abs(plain - oracle), "kahan bar: worse than plain")
    print(f"[kernels] kahan bar: kahan err {kahan - oracle!r}, plain err {plain - oracle!r}, "
          f"ulp {ulp!r}")

    rng = np.random.default_rng(1)
    data = rng.normal(1e4, 1, size=200_000).astype(np.float32)
    codes = (np.arange(data.size) % 3).astype(np.int32)
    got = ksum(data, codes, 3, "dd")
    for g in range(3):
        want = np.float32(data[codes == g].astype(np.float64).sum())
        check(got[g] == want, f"dd bar: group {g}: {got[g]} != {want}")

    data = np.zeros(4096, np.float32)
    data[:2048], data[2048:] = 3e7, -3e7
    data[0] += 1.0
    got = ksum(data, np.zeros(4096, np.int32), 1, "dd")[0]
    check(got == np.float32(data.astype(np.float64).sum()), f"dd cancellation: {got}")

    big = np.full(256, 2e34, np.float32)
    got = ksum(big, np.zeros(256, np.int32), 1, "dd")[0]
    check(got == np.float32(big.astype(np.float64).sum()), f"dd large values: {got}")
    print("[kernels] dd bars hold (correct rounding, cancellation, large values)")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def _f64_reference(data, codes, size, func, block=8192):
    """float64 (var, nanstd, nanmean, sum) or exact (nanmax, nanmin) per-group
    reduction of ``data`` (K, N), in row blocks to bound memory."""
    idx = codes.long()
    out = []
    cnt = torch.bincount(idx, minlength=size).double()
    for r0 in range(0, data.shape[0], block):
        x = data[r0 : r0 + block]
        if func in ("nanmax", "nanmin"):
            op = func[3:]
            o = torch.full((x.shape[0], size), float("-inf" if op == "max" else "inf"),
                           device=x.device)
            out.append(o.scatter_reduce_(1, idx.expand_as(x), x, "a" + op, include_self=True))
            continue
        x = x.double()
        s = torch.zeros((x.shape[0], size), dtype=torch.float64, device=x.device)
        s.index_add_(1, idx, x)
        if func == "sum":
            out.append(s)
            continue
        mean = s / cnt
        if func == "nanmean":
            out.append(mean)
            continue
        dev = x - mean.index_select(1, idx)
        m2 = torch.zeros_like(s).index_add_(1, idx, dev * dev)
        out.append(torch.sqrt(m2 / cnt) if func == "nanstd" else m2 / cnt)
    return torch.cat(out)


def _drive(ck, name: str, fn, want: dict, totals: dict):
    """One call of the main path, with the launch counts set to 0 just before
    it and read just after; fails unless they are ``want`` (zeros elsewhere)."""
    ck.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = dict(ck.LAUNCHES)
    for kk, v in got.items():
        totals[kk] += v
    expect = {kk: want.get(kk, 0) for kk in got}
    check(got == expect, f"{name}: launches {got}, expected {expect}")
    print(f"[main] {name}: launches {got}")
    return out


def _check_close(name, out, ref, tol_rel=1e-5):
    err = (out.double() - ref).abs()
    tol = 1e-6 + tol_rel * ref.abs()  # float32 sums and division
    check(bool((err <= tol).all()), f"{name}: max err {err.max().item()}")
    print(f"[main] {name}: max |err| vs float64 {err.max().item()!r}")


def _check_scan_full(name, out, data, codes, want=None):
    """A full-width grouped cumsum of finite data against ``want`` (default: a
    float64 ``torch.cumsum`` of each group's gathered columns), group by group,
    within ``n_g * u * cumsum|x|`` plus one ulp. Returns the max |error|."""
    check(out.shape == data.shape and out.dtype == data.dtype, f"{name}: {out.dtype}")
    worst = 0.0
    for g in range(NGROUPS):
        cols = torch.nonzero(codes == g).squeeze(1)
        x = data.index_select(1, cols).double()
        ref = torch.cumsum(x, dim=1) if want is None else want.index_select(1, cols).double()
        tol = cols.numel() * U32 * torch.cumsum(x.abs_(), dim=1)
        del x
        err = (out.index_select(1, cols).double() - ref).abs_()
        tol += ref.abs_() * 2.0**-23
        check(bool((err <= tol).all()), f"{name}: group {g} max err {err.max().item()}")
        worst = max(worst, err.max().item())
        del ref, tol, err
    print(f"[main] {name}: max |err| vs {'float64 grouped cumsum' if want is None else 'plain'}"
          f" {worst!r}")
    return worst


def _ffill_cut(ck, data, month, rows: int) -> None:
    """ffill has no kernel: run it on the first ``rows`` rows with NaN holes,
    against a sequential numpy forward fill per group on the host."""
    import flox_tpu_torch

    x = data[:rows].clone()
    rows = x.shape[0]
    x[torch.rand(x.shape, device=DEVICE) < 0.3] = float("nan")
    out = flox_tpu_torch.groupby_scan(x, month, func="ffill").cpu().numpy()
    xs = x.cpu().numpy()
    want = np.empty_like(xs)
    last = np.full((rows, NGROUPS), np.nan, np.float32)
    for c, g in enumerate(month):
        col = xs[:, c]
        last[:, g] = np.where(np.isnan(col), last[:, g], col)
        want[:, c] = last[:, g]
    check(np.array_equal(out, want, equal_nan=True), "ffill differs from the sequential fill")
    print(f"[main] ffill on the first {rows} rows (30% NaN): exact")


def make_data(seed: int) -> torch.Tensor:
    """The (lat*lon, time) float32 benchmark array, random normal from ``seed``,
    made on the card."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return torch.randn((NLAT * NLON, NTIME), generator=gen, device=DEVICE, dtype=torch.float32)


def phase_main_path(seed: int):
    import flox_tpu_torch
    from flox_tpu_torch import cuda_kernels as ck

    data = make_data(seed)
    k, n = data.shape
    month = month_labels(n)
    codes = torch.from_numpy(month).to(DEVICE)
    print(f"[main] data {tuple(data.shape)} float32, {data.numel() * 4 / 1e9:.2f} GB, "
          f"{NGROUPS} groups")
    totals = {kk: 0 for kk in ck.LAUNCHES}

    def reduce(func):
        out, groups = flox_tpu_torch.groupby_reduce(data, month, func=func)
        check(np.array_equal(groups, np.arange(NGROUPS)), f"{func}: groups {groups}")
        return out

    def many(funcs):
        out, groups = flox_tpu_torch.groupby_aggregate_many(data, month, funcs=funcs)
        check(tuple(out) == funcs, f"{funcs}: keys {tuple(out)}")
        check(np.array_equal(groups, np.arange(NGROUPS)), f"{funcs}: groups {groups}")
        return out

    # groupby_reduce: nanmean is one segment-sum launch, nanmax one
    # segment-min/max launch, var two segment-sum launches
    results = {
        "nanmean": _drive(ck, "nanmean", lambda: reduce("nanmean"), {"segment_sum": 1}, totals),
        "nanmax": _drive(ck, "nanmax", lambda: reduce("nanmax"), {"segment_minmax": 1}, totals),
        "var": _drive(ck, "var", lambda: reduce("var"), {"segment_sum": 2}, totals),
    }
    for func, out in results.items():
        check(tuple(out.shape) == (k, NGROUPS) and out.dtype == torch.float32,
              f"{func}: result {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{func}: non-finite values in the result")
        ref = _f64_reference(data, codes, NGROUPS, func)
        if func == "nanmax":
            check(torch.equal(out, ref), "nanmax differs from scatter_reduce amax")
            print("[main] nanmax: exact")
        else:
            _check_close(func, out, ref)
        del ref

    # the fused sets: one multi-statistic pass serves mean, min and max
    trio = ("nanmean", "nanmin", "nanmax")
    got = _drive(ck, "aggregate_many(nanmean, nanmin, nanmax)", lambda: many(trio),
                 {"segment_multistat": 1}, totals)
    check(torch.equal(got["nanmean"], results["nanmean"])
          and torch.equal(got["nanmax"], results["nanmax"]),
          "fused nanmean/nanmax differ from groupby_reduce's")
    check(torch.equal(got["nanmin"], _f64_reference(data, codes, NGROUPS, "nanmin")),
          "fused nanmin differs from scatter_reduce amin")
    print("[main] aggregate_many trio: nanmean and nanmax bit-identical to groupby_reduce, "
          "nanmin exact")
    clim = ("count", "nanmean", "nanstd", "nanmin", "nanmax")
    got2 = _drive(ck, "aggregate_many(climatology)", lambda: many(clim),
                  {"segment_multistat": 1, "segment_sum": 2}, totals)
    count = torch.bincount(codes, minlength=NGROUPS).expand(k, NGROUPS)
    check(got2["count"].dtype == torch.int64 and torch.equal(got2["count"], count),
          "climatology count differs from bincount")
    for f in ("nanmean", "nanmin", "nanmax"):
        check(torch.equal(got2[f], got[f]), f"climatology {f} differs from the trio's")
    _check_close("climatology nanstd", got2["nanstd"],
                 _f64_reference(data, codes, NGROUPS, "nanstd"))
    del got, got2, results
    torch.cuda.empty_cache()

    # grouped scans: one segmented-cumsum launch each
    scan_err = 0.0
    outs = {}
    for func in ("nancumsum", "cumsum"):
        outs[func] = _drive(ck, f"groupby_scan({func})",
                            lambda f=func: flox_tpu_torch.groupby_scan(data, month, func=f),
                            {"segment_cumsum": 1}, totals)
        scan_err = max(scan_err, _check_scan_full(func, outs[func], data, codes))
    check(torch.equal(outs["cumsum"], outs["nancumsum"]),
          "cumsum and nancumsum differ on data without NaN")
    del outs
    _ffill_cut(ck, data, month, rows=2048)
    torch.cuda.empty_cache()
    _daily_and_sort(ck, data, totals)
    torch.cuda.empty_cache()
    print(f"[main] launches over the main path {totals}")
    print(f"[memory] peak device memory so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return data, month, codes, totals, scan_err


def _daily_and_sort(ck, data, totals) -> None:
    """The high-cardinality path: the daily means and sums (1096 groups, one
    radix-binning launch each) at full width, then the sort engine on the
    first SORT_ROWS rows with the days counted from 1940-01-01 over a 36524-day
    universe (1096 present, capacity 2048, one radix-binning launch), whose
    present columns must be the daily means bit for bit and the rest NaN."""
    import flox_tpu_torch
    from flox_tpu_torch import kernels as pk

    k, n = data.shape
    day = np.arange(n, dtype=np.int64) // 24
    day_codes = torch.from_numpy(day).to(DEVICE)

    def daily(func):
        out, groups = flox_tpu_torch.groupby_reduce(data, day, func=func)
        check(np.array_equal(groups, np.arange(NDAYS)), f"daily {func}: groups {groups[:4]}...")
        check(tuple(out.shape) == (k, NDAYS) and out.dtype == torch.float32,
              f"daily {func}: result {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"daily {func}: non-finite values")
        return out

    means = _drive(ck, "daily nanmean (1096 groups)", lambda: daily("nanmean"),
                   {"segment_sum_radixbin": 1}, totals)
    _check_close("daily nanmean", means, _f64_reference(data, day_codes, NDAYS, "nanmean"))
    sums = _drive(ck, "daily sum (1096 groups)", lambda: daily("sum"),
                  {"segment_sum_radixbin": 1}, totals)
    # a sum of 24 values that cancels to near 0 has no relative bar: hold it
    # to the kernel's own (kahan, the default), as phase 2 does, and count
    # the sums that the nanmean's bar, 1e-6 + 1e-5 |ref|, would refuse
    ref = _f64_reference(data, day_codes, NDAYS, "sum")
    scale = torch.cat([abs_sums(data[r : r + 8192], day_codes, NDAYS).T
                       for r in range(0, k, 8192)])
    err = (sums.double() - ref).abs()
    bar = _sum_bar("kahan", n, scale, ref)
    check(bool((err <= bar).all()), f"daily sum: max err {err.max().item()}")
    past_mean_bar = int((err > 1e-6 + 1e-5 * ref.abs()).sum())
    print(f"[main] daily sum: max |err| vs float64 {err.max().item()!r}, max err / bar "
          f"{(err / bar).max().item()!r}; {past_mean_bar} of {err.numel()} sums past "
          f"1e-6 + 1e-5 |ref|")
    del sums, ref, scale, err, bar
    torch.cuda.empty_cache()

    cut = data[:SORT_ROWS]
    labels = DAY0 + day
    universe = np.arange(NUNIVERSE)

    def sort_call():
        out, groups = flox_tpu_torch.groupby_reduce(cut, labels, func="nanmean",
                                                    expected_groups=universe, engine="sort")
        check(np.array_equal(groups, universe), "sort engine: groups differ from the universe")
        return out

    out = _drive(ck, f"sort engine nanmean ({SORT_ROWS} rows, {NUNIVERSE}-day universe)",
                 sort_call, {"segment_sum_radixbin": 1}, totals)
    present = pk.present_groups(labels, NUNIVERSE)
    cap = pk.present_cap(len(present), NUNIVERSE)
    check(tuple(out.shape) == (cut.shape[0], NUNIVERSE) and out.dtype == torch.float32
          and out.device.type == torch.device(DEVICE).type,
          f"sort engine: result {tuple(out.shape)} {out.dtype} on {out.device}")
    check(len(present) == NDAYS and cap == 2048, f"sort engine: {len(present)} present, cap {cap}")
    cols = torch.from_numpy(present).to(DEVICE)
    check(torch.equal(bits(out.index_select(1, cols)), bits(means[: cut.shape[0]])),
          "sort engine: present columns differ from the daily means")
    absent = torch.ones(NUNIVERSE, dtype=torch.bool, device=DEVICE)
    absent[cols] = False
    check(bool(torch.isnan(out[:, absent]).all()), "sort engine: an absent column is not NaN")
    print(f"[main] sort engine: {len(present)} present groups, capacity {cap}; present columns "
          f"bit-identical to the daily means, {int(absent.sum())} absent columns NaN")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def phase_times(data, month, codes, reps: int, launches: dict) -> list[dict]:
    import flox_tpu_torch
    from flox_tpu_torch import cuda_kernels as ck

    k, n = data.shape
    size = NGROUPS
    codes32 = codes.to(torch.int32)
    idx = codes.long()
    entries = []

    # B1 at the main path's shapes (kahan, the default accumulation)
    got = ck.segment_sum_raw(data, codes32, size, "kahan")
    want = ck.segment_sum_raw_plain(data, codes32, size, "kahan")
    torch.cuda.synchronize()
    for i in (1, 2, 3):
        check(torch.equal(got[i], want[i]), "full width: marker counts differ")
    scale = abs_sums(data, codes32, size)
    err = (got[0].double() - want[0].double()).abs()
    check(bool((err <= _sum_bar("kahan", n, scale, want[0])).all()),
          f"full width: segment_sum off its plain version by {err.max().item()}")
    sum_err = err.max().item()
    del got, want, scale, err
    torch.cuda.empty_cache()

    ms = time_ms(lambda: ck.segment_sum_raw(data, codes32, size, "kahan"), reps)
    plain_ms = time_ms(lambda: ck.segment_sum_raw_plain(data, codes32, size, "kahan"),
                       max(2, reps // 4))
    torch.cuda.empty_cache()
    acc = torch.zeros((k, size), device=DEVICE)
    # the data holds no non-finite value, so its zero-filled copy is itself
    library_ms = time_ms(lambda: acc.zero_().index_add_(1, idx, data), max(2, reps // 4))
    nbytes = data.numel() * data.element_size() + n * 4 + 4 * size * k * 4
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * data.numel() / F32_FLOPS) * 1e3
    entries.append({
        "name": "segment_sum", "route": "cuda", "source": "flox_tpu_torch/csrc/segment_sum.cu",
        "replaces": "flox_tpu/pallas_kernels.py:68", "launches": launches["segment_sum"],
        "max_abs_err": sum_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms,
    })
    print(f"[times] segment_sum kahan: {ms!r} ms (bound {bound_ms!r} ms), plain {plain_ms!r} "
          f"ms, index_add_ (sums only, no markers) {library_ms!r} ms")

    # B3 at the shapes nanmax gives it (the data holds no NaN to map)
    got = ck.segment_minmax(data, codes32, size, "max")
    want = ck.segment_minmax_plain(data, codes32, size, "max")
    check(same(got, want), "full width: segment_minmax differs from its plain version")
    mm_err = (got - want).abs().max().item()
    del got, want
    ms = time_ms(lambda: ck.segment_minmax(data, codes32, size, "max"), reps)
    plain_ms = time_ms(lambda: ck.segment_minmax_plain(data, codes32, size, "max"),
                       max(2, reps // 4))
    out = torch.empty((k, size), device=DEVICE)
    library_ms = time_ms(
        lambda: out.fill_(float("-inf")).scatter_reduce_(
            1, idx.expand(k, n), data, "amax", include_self=True),
        max(2, reps // 4),
    )
    nbytes = data.numel() * data.element_size() + n * 4 + size * k * 4
    bound_ms = max(nbytes / HBM_BYTES_PER_S, data.numel() / F32_FLOPS) * 1e3
    entries.append({
        "name": "segment_minmax", "route": "cuda",
        "source": "flox_tpu_torch/csrc/segment_minmax.cu",
        "replaces": "flox_tpu/pallas_kernels.py:248", "launches": launches["segment_minmax"],
        "max_abs_err": mm_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms,
    })
    print(f"[times] segment_minmax max: {ms!r} ms (bound {bound_ms!r} ms), plain {plain_ms!r} "
          f"ms, scatter_reduce amax {library_ms!r} ms")

    # B2 at the shapes the fused sets give it (kahan)
    b1_ms, b3_ms = entries[0]["ms"], ms
    got = ck.segment_multistat(data, codes32, size, "kahan")
    raw = ck.segment_sum_raw(data, codes32, size, "kahan")
    want = ck.segment_multistat_plain(data, codes32, size, "kahan")
    torch.cuda.synchronize()
    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got[:4], raw)),
          "full width: segment_multistat sums or markers differ from segment_sum_raw")
    check(all(torch.equal(got[i], want[i]) for i in (1, 2, 3))
          and same(got[4], want[4]) and same(got[5], want[5]),
          "full width: segment_multistat markers or extrema differ from the plain version")
    scale = abs_sums(data, codes32, size)
    err = (got[0].double() - want[0].double()).abs()
    check(bool((err <= _sum_bar("kahan", n, scale, want[0])).all()),
          f"full width: segment_multistat off its plain version by {err.max().item()}")
    ms_err = err.max().item()
    del got, raw, want, scale, err
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ck.segment_multistat(data, codes32, size, "kahan"), reps)
    plain_ms = time_ms(lambda: ck.segment_multistat_plain(data, codes32, size, "kahan"),
                       max(2, reps // 4))
    torch.cuda.empty_cache()
    nbytes = data.numel() * data.element_size() + n * 4 + 6 * size * k * 4
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 4 * data.numel() / F32_FLOPS) * 1e3
    entries.append({
        "name": "segment_multistat", "route": "cuda",
        "source": "flox_tpu_torch/csrc/segment_multistat.cu",
        "replaces": "flox_tpu/pallas_kernels.py:371", "launches": launches["segment_multistat"],
        "max_abs_err": ms_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
    })
    print(f"[times] segment_multistat kahan: {ms!r} ms (bound {bound_ms!r} ms), plain "
          f"{plain_ms!r} ms; no one library call computes sums, markers, min and max "
          f"(library_ms null); unfused yardstick B1 + B3 = {b1_ms + b3_ms!r} ms, "
          f"B1 + 2 B3 (min and max) = {b1_ms + 2 * b3_ms!r} ms")

    # B4 at the shapes groupby_scan gives it (nancumsum)
    got = ck.segment_cumsum(data, codes32, size, True)
    want = ck.segment_cumsum_plain(data, codes32, size, True)
    torch.cuda.synchronize()
    cs_err = _check_scan_full("segment_cumsum full width", got, data, codes, want=want)
    del got, want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ck.segment_cumsum(data, codes32, size, True), reps)
    plain_ms = time_ms(lambda: ck.segment_cumsum_plain(data, codes32, size, True), 2)
    torch.cuda.empty_cache()
    # yardstick, not the same function: one ungrouped cumsum over (K, N), one
    # read plus one write of the data
    library_ms = time_ms(lambda: torch.cumsum(data, dim=1), max(2, reps // 4))
    torch.cuda.empty_cache()
    nbytes = 2 * data.numel() * data.element_size() + n * 4
    bound_ms = max(nbytes / HBM_BYTES_PER_S, data.numel() / F32_FLOPS) * 1e3
    entries.append({
        "name": "segment_cumsum", "route": "cuda",
        "source": "flox_tpu_torch/csrc/segment_cumsum.cu",
        "replaces": "flox_tpu/pallas_kernels.py:516", "launches": launches["segment_cumsum"],
        "max_abs_err": cs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms,
    })
    print(f"[times] segment_cumsum nancumsum: {ms!r} ms (bound {bound_ms!r} ms), plain "
          f"{plain_ms!r} ms, torch.cumsum over (K, N) ungrouped (a yardstick, not the same "
          f"function) {library_ms!r} ms")

    entries.append(_radixbin_times(ck, data, reps, launches))
    pattern_times(data, reps)

    day = np.arange(n, dtype=np.int64) // 24
    nbytes = data.numel() * data.element_size()
    calls = {
        "nanmean": lambda: flox_tpu_torch.groupby_reduce(data, month, func="nanmean"),
        "daily nanmean (1096 groups)": lambda: flox_tpu_torch.groupby_reduce(
            data, day, func="nanmean"),
        "aggregate_many(nanmean, nanmin, nanmax)": lambda: flox_tpu_torch.groupby_aggregate_many(
            data, month, funcs=("nanmean", "nanmin", "nanmax")),
        "aggregate_many(count, nanmean, nanstd, nanmin, nanmax)":
            lambda: flox_tpu_torch.groupby_aggregate_many(
                data, month, funcs=("count", "nanmean", "nanstd", "nanmin", "nanmax")),
        "groupby_scan(nancumsum)": lambda: flox_tpu_torch.groupby_scan(
            data, month, func="nancumsum"),
    }
    # what each fused set replaces: one groupby_reduce per statistic
    for funcs in (("nanmean", "nanmin", "nanmax"),
                  ("count", "nanmean", "nanstd", "nanmin", "nanmax")):
        calls[f"sequential groupby_reduce ({', '.join(funcs)})"] = (
            lambda fs=funcs: [flox_tpu_torch.groupby_reduce(data, month, func=f) for f in fs])
    for name, fn in calls.items():
        e2e_ms = time_ms(fn, max(3, reps // 2))
        torch.cuda.empty_cache()
        gbps = nbytes / (e2e_ms * 1e-3) / 1e9
        print(f"[times] end-to-end {name}: {e2e_ms!r} ms, {gbps!r} GB/s of input")
    device_breakdown({
        "segment_sum_raw kahan": lambda: ck.segment_sum_raw(data, codes32, size, "kahan"),
        "segment_multistat kahan": lambda: ck.segment_multistat(data, codes32, size, "kahan"),
        **{name: calls[name] for name in list(calls)[:5]},
    })
    cut = data[:SORT_ROWS]
    e2e_ms = time_ms(lambda: flox_tpu_torch.groupby_reduce(
        cut, DAY0 + day, func="nanmean", expected_groups=np.arange(NUNIVERSE), engine="sort"),
        max(3, reps // 2))
    gbps = cut.numel() * cut.element_size() / (e2e_ms * 1e-3) / 1e9
    print(f"[times] end-to-end sort engine nanmean ({SORT_ROWS} rows, {NUNIVERSE}-day universe, "
          f"host scatter included): {e2e_ms!r} ms, {gbps!r} GB/s of input")
    _sort_breakdown(cut, day)
    return entries


_OUR_KERNELS = ("segment_reduce_kernel", "segment_minmax_kernel", "segment_cumsum_kernel",
                "radixbin_kernel")


def device_breakdown(calls: dict, reps: int = 3) -> None:
    """Where each call's time goes, from a ``torch.profiler`` trace of
    ``reps`` calls after a warm-up: the host-clock wall time per call (the
    calls end in a synchronize), the device's busy time (all kernels and
    copies), the share of it in this repo's kernels, and the idle share,
    1 - busy / wall. Tracing adds a few microseconds per launch to the wall
    time. Prints "not measured" when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not events:
            print(f"[profile] {name}: device time not measured (the trace holds none)")
            continue
        mine = [e for e in events if any(k in e.name for k in _OUR_KERNELS)]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
        ours = sum(e.time_range.elapsed_us() for e in mine) / 1e3 / reps
        print(f"[profile] {name}: wall {wall!r} ms a call (host clock, traced), device busy "
              f"{busy!r} ms ({ours!r} in this repo's kernels, {busy - ours!r} in "
              f"{(len(events) - len(mine)) // reps} other device ops), idle share "
              f"{1 - busy / wall!r}")
        torch.cuda.empty_cache()


def pattern_times(data, reps: int) -> dict:
    """B1 and B2 (kahan) on code patterns off the main path, at the width of
    ``data``: hour of day (``arange(N) % 24``, 24 groups, runs of one
    column), random codes over 12 groups, and, for B1 alone (B2 caps at 128
    groups), random codes over 512. Each output is first held against the
    plain version (markers exact, sums at B1's kahan bar, extrema exact).
    Uses only the wrappers' Python signatures, which the kernels' earlier
    designs share, so it also times a checkout of an earlier commit:
    ``python3 -c "import chip_smoke as c; c.pattern_times(c.make_data(0), 10)"``
    run there with this file on ``sys.path`` first. Returns ``{name: ms}``."""
    from flox_tpu_torch import cuda_kernels as ck

    k, n = data.shape
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    patterns = (
        ("hour of day (24 groups, runs of 1)", torch.arange(n, device=DEVICE) % 24, 24),
        ("random codes over 12 groups", torch.randint(0, 12, (n,), generator=gen,
                                                      device=DEVICE), 12),
        ("random codes over 512 groups", torch.randint(0, 512, (n,), generator=gen,
                                                       device=DEVICE), 512),
    )
    times = {}
    for name, codes, size in patterns:
        codes = codes.to(torch.int32)
        kernels = [("segment_sum", ck.segment_sum_raw, ck.segment_sum_raw_plain)]
        if size <= 128:
            kernels.append(("segment_multistat", ck.segment_multistat,
                            ck.segment_multistat_plain))
        for kname, fn, plain in kernels:
            got = fn(data, codes, size, "kahan")
            want = plain(data, codes, size, "kahan")
            torch.cuda.synchronize()
            tag = f"{kname}, {name}"
            check(all(torch.equal(a, b) for a, b in zip(got[1:4], want[1:4])),
                  f"{tag}: marker counts differ from the plain version")
            check(all(same(a, b) for a, b in zip(got[4:], want[4:])),
                  f"{tag}: extrema differ from the plain version")
            scale = torch.cat([abs_sums(data[r : r + 8192], codes, size)
                               for r in range(0, k, 8192)], 1)
            err = (got[0].double() - want[0].double()).abs()
            check(bool((err <= _sum_bar("kahan", n, scale, want[0])).all()),
                  f"{tag}: off its plain version by {err.max().item()}")
            del got, want, scale
            torch.cuda.empty_cache()
            ms = time_ms(lambda f=fn, c=codes, sz=size: f(data, c, sz, "kahan"), max(2, reps // 2))
            torch.cuda.empty_cache()
            outs = 6 if kname == "segment_multistat" else 4
            nbytes = data.numel() * data.element_size() + n * 4 + outs * size * k * 4
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            times[tag] = ms
            print(f"[times] {kname} kahan, {name}: {ms!r} ms (bound {bound!r} ms), max |kernel - "
                  f"plain| {err.max().item()!r}")
    return times


def _sort_breakdown(cut, day) -> None:
    """Where the sort-engine call's time goes, outside its one kernel: the
    host scatter of the compact (rows, 2048) result to the dense (rows,
    36524) layout (its copy to the host included), on the host clock, and
    the dense result's copy back to the card, on the card's clock."""
    from flox_tpu_torch import kernels as pk

    present = pk.present_groups(DAY0 + day, NUNIVERSE)
    cap = pk.present_cap(len(present), NUNIVERSE)
    compact = torch.zeros((cut.shape[0], cap), device=DEVICE)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        dense = pk.scatter_present_dense(compact, present, NUNIVERSE)
        walls.append((time.perf_counter() - t0) * 1e3)
    copy_ms = time_ms(lambda: dense.to(DEVICE), 3)
    print(f"[times] sort engine, outside the kernel: host scatter of ({cut.shape[0]}, {cap}) to "
          f"({cut.shape[0]}, {NUNIVERSE}) {statistics.median(walls)!r} ms (host clock, median of "
          f"3), copy of the {dense.numel() * 4 / 1e9:.2f} GB dense result to the card "
          f"{copy_ms!r} ms")


def _radixbin_full_check(ck, data, codes, size: int, name: str) -> float:
    """B5 kahan at the main path's width against its plain version: markers
    exact, sums within B1's kahan bar. Returns the max |kernel - plain|."""
    k, n = data.shape
    got = ck.segment_sum_radixbin_raw(data, codes, size, "kahan")
    want = ck.segment_sum_radixbin_plain(data, codes, size, "kahan")
    torch.cuda.synchronize()
    for i in (1, 2, 3):
        check(torch.equal(got[i], want[i]), f"{name}: radix-binning marker counts differ")
    scale = torch.cat([abs_sums(data[r : r + 8192], codes, size) for r in range(0, k, 8192)], 1)
    err = (got[0].double() - want[0].double()).abs()
    check(bool((err <= _sum_bar("kahan", n, scale, want[0])).all()),
          f"{name}: segment_sum_radixbin off its plain version by {err.max().item()}")
    worst = err.max().item()
    print(f"[times] segment_sum_radixbin kahan, {name}: max |kernel - plain| {worst!r}, "
          f"markers exact")
    del got, want, scale, err
    torch.cuda.empty_cache()
    return worst


def _radixbin_times(ck, data, reps: int, launches: dict) -> dict:
    """B5 at the daily means' shapes (kahan) against its bound, its plain
    version and index_add_; then on random codes over 4096 groups (each
    block gathers its groups' columns) and on skewed codes (the first half of
    the columns in group 0, the rest daily), each against the same kind of
    bound. Each code set's output is first held against the plain version
    at B1's kahan bar, with the markers exact."""
    k, n = data.shape
    day = (torch.arange(n, device=DEVICE) // 24).to(torch.int32)
    size = NDAYS
    rb_err = _radixbin_full_check(ck, data, day, size, "daily codes")

    ms = time_ms(lambda: ck.segment_sum_radixbin_raw(data, day, size, "kahan"), reps)
    plain_ms = time_ms(lambda: ck.segment_sum_radixbin_plain(data, day, size, "kahan"),
                       max(2, reps // 4))
    torch.cuda.empty_cache()
    acc = torch.zeros((k, size), device=DEVICE)
    idx = day.long()
    # the data holds no non-finite value, so its zero-filled copy is itself
    library_ms = time_ms(lambda: acc.zero_().index_add_(1, idx, data), max(2, reps // 4))
    del acc
    nbytes = data.numel() * data.element_size() + n * 4 + 4 * size * k * 4
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * data.numel() / F32_FLOPS) * 1e3
    print(f"[times] segment_sum_radixbin kahan, daily codes (1096 groups, sorted): {ms!r} ms "
          f"(bound {bound_ms!r} ms), plain {plain_ms!r} ms, index_add_ (sums only, no "
          f"markers) {library_ms!r} ms")

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    rsize = 4096
    rnd = torch.randint(0, rsize, (n,), generator=gen, device=DEVICE, dtype=torch.int32)
    skew = torch.where(torch.arange(n, device=DEVICE) < n // 2, 0, day).to(torch.int32)
    for name, codes, csize in (
        (f"random codes over {rsize} groups (gathered columns)", rnd, rsize),
        (f"skewed codes (columns [0, {n // 2}) in group 0, the rest daily; {size} groups)",
         skew, size),
    ):
        _radixbin_full_check(ck, data, codes, csize, name)
        c_ms = time_ms(lambda c=codes, s=csize: ck.segment_sum_radixbin_raw(data, c, s, "kahan"),
                       max(2, reps // 4))
        torch.cuda.empty_cache()
        c_bytes = data.numel() * data.element_size() + n * 4 + 4 * csize * k * 4
        c_bound = max(c_bytes / HBM_BYTES_PER_S, 2 * data.numel() / F32_FLOPS) * 1e3
        print(f"[times] segment_sum_radixbin kahan, {name}: {c_ms!r} ms (bound {c_bound!r} ms, "
              f"one read of the data)")
    return {
        "name": "segment_sum_radixbin", "route": "cuda",
        "source": "flox_tpu_torch/csrc/segment_radixbin.cu",
        "replaces": "flox_tpu/pallas_kernels.py:973",
        "launches": launches["segment_sum_radixbin"], "max_abs_err": rb_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import flox_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    phase_kernels(args.seed)
    data, month, codes, launches, _scan_err = phase_main_path(args.seed)
    entries = phase_times(data, month, codes, args.reps, launches)
    print(f"[memory] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched on the main path")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
