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
   their empty results at N = 0 without a launch; the segment-min/max kernel
   over {min, max} x {float32, bfloat16, int32} x size {1, 12, 128, 512} x
   {random, sorted, hour-of-day codes}, exactly, NaN propagating and empty
   groups at the identity; the multi-statistic kernel
   over {plain, kahan, dd} x {float32, bfloat16} x size {1, 12, 128}, its
   sums and markers bit-identical to the segment-sum kernel's and its
   extrema to the segment-min/max kernel's on NaN-parked data; the
   segmented-cumsum kernel over {cumsum, nancumsum} x {float32, bfloat16} x
   size {1, 12, 127} within ``n_g * u * cumsum|x|`` plus one ulp, with the
   reference's overflow, NaN and stickiness cases, and bit-identical to a
   float32 column-order emulation of its walk over {cumsum, nancumsum} x
   {float32, bfloat16} x size {1, 12, 127, 511} x {random, sorted codes} x
   {37, 300} rows x {128, 256} rows per block, with NaN, +-inf and
   overflowing values; the radix-binning kernel
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
   the days counted from 1940-01-01 over a 36524-day universe; the rest of
   the reduction family: nanargmax and argmin, nanfirst and nanlast,
   nanmedian and nanquantile(q=(0.1, 0.5, 0.9)) by sort and by radix select,
   and mode of int32 classes 0-9 made from the seed, with each call's peak
   device memory; datetime64 nanmax/nanfirst, timedelta64 nanmean/ffill and
   bool sum/any on 2048 rows and string nanfirst/nanlast/count on 16 (host
   arrays by nature); then the segment-min/max kernel's int32 instance
   against its plain version at full width; then the label layers
   (:func:`_label_layers`): ``xarray_reduce`` on the array viewed as an xrlite
   (lat, lon, time) DataArray by month, by day and by 18 latitude bands, and
   on a Dataset of it and the int32 classes (nanmax), ``groupby_reduce_device``
   with the month labels on the card, prefactorized month labels through
   ``groupby_reduce`` and ``groupby_aggregate_many``, a sparse tensor at 1 %
   density (nansum, nanmean, nanmax, count), the sort engine's result packed
   with ``reindex=SPARSE_COO``, the host numpy engine on 2048 rows, and
   ``memory_stats``; then streaming from host memory (:func:`phase_streaming`):
   the array copied once to a host numpy array and streamed back through
   ``streaming_groupby_reduce`` nanmean by month at the default 256 MiB
   slabs (pinned buffers, a side copy stream, prefetch 2), bit for bit the
   slab-order fold of the eager calls on the same slabs, with its peak device
   memory held under (prefetch + 2) slabs plus the accumulators and timed at
   prefetch 0 and 2 beside the host fill and host-to-device rates; the daily
   nanmean and the trio streamed the same way; and on the SORT_ROWS cut the
   streamed nanquantile (33 passes, bit for bit the eager select path), a
   streamed nancumsum into a host writer, the streamed sort engine on
   day-aligned slabs (bit for bit the eager one), a loader, a simulated OOM
   that the ladder halves, a real ``torch.cuda.OutOfMemoryError`` under a
   memory cap, and a killed stream resumed from its checkpoint bit for bit.
   Each call runs with the launch
   counts set to 0 just before it, must launch exactly its kernels, and is
   checked against a float64 (or exact) reduction of the same data on the
   card (the sort engine against the daily call, bit for bit; positions,
   first/last and mode exactly; the quantiles' two paths bit for bit);
   then the multi-device runtime (:func:`phase_mesh_all`): in a
   ``torch.distributed`` world of one rank (NCCL, a file store in a temp
   dir) over ``make_mesh()``, at full width, map-reduce nanmean, cohorts
   nanvar, map-reduce nanargmax, the Blelloch nancumsum, blockwise nanmedian
   and map-reduce nanquantile(0.1, 0.5, 0.9) by the (distributed) radix
   select, cohorts nansum, the trio by map-reduce and the daily nanmean by
   map-reduce, each with its launches counted from 0 and its peak memory,
   bit for bit against the eager call and both timed (:func:`phase_mesh`);
   then two spawned gloo ranks sharing the card (NCCL refuses two ranks on
   one device) on the data cut to 8192 rows, made on the host from the seed
   by each rank, which moves only its columns to the card: the calls of
   ``__graft_entry__.dryrun_multichip`` without its streaming ones, each
   rank's results held against the world of one's on the same cut, with the
   same launches, under a deadline (:func:`phase_mesh_ranks`);
4. time, with CUDA events (median of ``--reps`` runs after a warm-up), each
   kernel at the main path's shapes against its bound, its plain version and
   one library call (or a labelled yardstick), and the end-to-end calls; the
   radix-binning kernel also on random codes over 4096 groups and on skewed
   codes, the segmented-cumsum kernel with 128 and with 256 rows per block,
   and the segment-sum, multi-statistic, segment-min/max and
   segmented-cumsum kernels on code patterns off the main path
   (:func:`pattern_times`: hour of day, random codes over 12 groups, and for
   the segment-sum kernel over 512), each output first held against the
   plain version; the reduction family's and the label layers' calls with
   their launches a call (and the label layers' peak memory); then, from a ``torch.profiler`` trace (:func:`device_breakdown`), each
   kernel wrapper's and end-to-end call's device busy time, the share in
   this repo's kernels, and the device's idle share.

It then prints the peak device memory, the card's name and power limit, one
JSON line of the kernels, and, last, ``{"ok": true, "device": {...}}``.

``--mesh-cards N`` runs only the build and :func:`phase_mesh_cards`: the
full-width mesh calls on N NCCL ranks, one card each, against one card's
eager calls (exact, or within the float32 bars of other summation orders).
Without CUDA it exits nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
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
    for rows in (k, 600):  # a partial tile of 256 rows; two full ones and a partial one
        _minmax_sweep(ck, gen, rows, n)
    worst["segment_multistat"] = _multistat_sweep(ck, gen, k, n)
    worst["segment_cumsum"] = _cumsum_sweep(ck, gen, k, n)
    _scan_semantics(ck)
    _scan_emulation_sweep(ck, gen)
    worst["segment_sum_radixbin"] = _radixbin_sweep(ck, gen, k, n)
    print(f"[kernels] all sweeps agree; max |segment_sum - plain| {worst['segment_sum']!r}, "
          f"|segment_multistat - plain| {worst['segment_multistat']!r}, "
          f"|segment_cumsum - plain| {worst['segment_cumsum']!r}, "
          f"|segment_sum_radixbin - plain| {worst['segment_sum_radixbin']!r}")
    return worst


def _minmax_sweep(ck, gen, k: int, n: int) -> None:
    """B3 against its plain version, exactly, over {min, max} x {float32,
    bfloat16, int32} x size {1, 12, 128, 512} x {random, sorted, hour-of-day
    codes}: floats with NaN (which propagates to its group), random codes
    with -1 and out-of-range codes and, from 3 groups up, group 1 left empty
    (it must hold the op's identity); reruns identical."""
    from flox_tpu_torch.cuda_kernels import minmax_identity

    for size, dtype in itertools.product((1, 12, 128, 512),
                                         (torch.float32, torch.bfloat16, torch.int32)):
        if dtype == torch.int32:
            data = torch.randint(-10**6, 10**6, (k, n), generator=gen, device=DEVICE,
                                 dtype=torch.int32)
        else:
            data = torch.randn((k, n), generator=gen, device=DEVICE)
            data[torch.rand((k, n), generator=gen, device=DEVICE) < 0.001] = float("nan")
            data = data.to(dtype)
        codes = torch.randint(-1, size + 3, (n,), generator=gen, device=DEVICE,
                              dtype=torch.int32)
        if size > 2:
            codes[codes == 1] = 0
        for order in ("random", "sorted", "hour of day"):
            if order == "sorted":
                codes = torch.sort(codes).values
            elif order == "hour of day":
                codes = (torch.arange(n, device=DEVICE) % 24).to(torch.int32)
            for op in ("min", "max"):
                got = ck.segment_minmax(data, codes, size, op)
                again = ck.segment_minmax(data, codes, size, op)
                want = ck.segment_minmax_plain(data, codes, size, op)
                torch.cuda.synchronize()
                tag = f"segment_minmax ({k}, {n}) size={size} {dtype} {order} {op}"
                check(same(got, again), f"{tag}: two launches differ")
                check(same(got, want), f"{tag}: differs from the plain version")
                if size > 2 and order != "hour of day":
                    check(bool((got[1] == minmax_identity(op, dtype)).all()),
                          f"{tag}: the empty group is not at the identity")
                if dtype != torch.int32:
                    idx = torch.where((codes >= 0) & (codes < size), codes, size).long()
                    nans = torch.zeros((size + 1, k), device=DEVICE).index_add_(
                        0, idx, torch.isnan(data).T.float())
                    check(torch.equal(torch.isnan(got), nans[:size] > 0),
                          f"{tag}: NaN does not propagate to just its groups")
    print(f"[kernels] segment-min/max sweep at ({k}, {n}): equal to the plain version on random, "
          "sorted and hour-of-day codes; NaN propagates; empty groups at the identity")


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


def _scan_column_order(data, codes, size: int, skipna: bool):
    """The function of the segmented-cumsum kernel's walk (csrc/
    segment_cumsum.cu) emulated in float32 torch ops: per (group, row), a
    sequential running sum of the finite values in column order, one torch
    op per rounding; NaN (unless ``skipna``), +inf and -inf set sticky
    markers, as does the first overflow of the running sum while the group
    has none; NaN beats inf and +inf with -inf is NaN; bfloat16 is rounded
    back per element. The missing labels scan as group ``size``. Step t
    takes every group's t-th column at once, vectorised over rows. Returns
    (K, N) in the data dtype."""
    k, n = data.shape
    dev = data.device
    x = data.float()
    idx = torch.where((codes >= 0) & (codes < size), codes, size).long()
    sidx, order = torch.sort(idx, stable=True)
    counts = torch.bincount(sidx, minlength=size + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sidx]
    run = torch.zeros((size + 1, k), device=dev)
    seen_n, seen_p, seen_m = (torch.zeros((size + 1, k), dtype=torch.bool, device=dev)
                              for _ in range(3))
    out = torch.empty((k, n), device=dev)
    for t in range(int(counts.max()) if n else 0):
        sel = rank == t
        g, cols = sidx[sel], order[sel]
        v = x[:, cols].T
        r = torch.where(torch.isfinite(v), run[g] + v, run[g])
        fresh = ~(seen_n[g] | seen_p[g] | seen_m[g])
        ovf = fresh & torch.isinf(r)
        p = seen_p[g] | torch.isposinf(v) | (ovf & (r > 0))
        m = seen_m[g] | torch.isneginf(v) | (ovf & (r < 0))
        nn = seen_n[g] if skipna else seen_n[g] | torch.isnan(v)
        run[g], seen_n[g], seen_p[g], seen_m[g] = r, nn, p, m
        res = torch.where(p, float("inf"), r)
        res = torch.where(m, float("-inf"), res)
        out[:, cols] = torch.where(nn | (p & m), float("nan"), res).T
    return out.to(data.dtype)


def _scan_emulation_sweep(ck, gen) -> None:
    """B4 against the column-order emulation of its walk
    (:func:`_scan_column_order`), bit for bit, and two launches identical,
    over {cumsum, nancumsum} x {float32, bfloat16} x size {1, 12, 127, 511}
    x {random, sorted codes} at (37, 300) and (300, 300): a partial tile of
    128 rows, and two full ones plus a partial one. The data holds NaN, +-inf
    and values of +-3e38, whose running sums overflow."""
    for rows, dtype in itertools.product((37, 300), (torch.float32, torch.bfloat16)):
        for size in (1, 12, 127, 511):
            data = torch.randn((rows, 300), generator=gen, device=DEVICE) * 10
            r = torch.rand((rows, 300), generator=gen, device=DEVICE)
            data[r < 0.01] = float("nan")
            data[(r >= 0.01) & (r < 0.015)] = float("inf")
            data[(r >= 0.015) & (r < 0.02)] = float("-inf")
            data[(r >= 0.02) & (r < 0.03)] = 3e38
            data[(r >= 0.03) & (r < 0.04)] = -3e38
            data = data.to(dtype)
            codes = torch.randint(-1, size + 3, (300,), generator=gen, device=DEVICE,
                                  dtype=torch.int32)
            for order, skipna in itertools.product(("random", "sorted"), (False, True)):
                if order == "sorted":
                    codes = torch.sort(codes).values
                got = ck.segment_cumsum(data, codes, size, skipna)
                again = ck.segment_cumsum(data, codes, size, skipna)
                want = _scan_column_order(data, codes, size, skipna)
                torch.cuda.synchronize()
                tag = f"segment_cumsum ({rows}, 300) size={size} {dtype} {order} skipna={skipna}"
                check(torch.equal(bits(got), bits(again)), f"{tag}: two launches differ")
                bad = torch.nonzero(bits(got) != bits(want))
                check(bad.numel() == 0,
                      f"{tag}: differs from the column-order emulation at {bad.shape[0]} "
                      f"places, first {bad[:1].tolist()}: "
                      f"{got[tuple(bad[0])].item() if bad.numel() else None!r} against "
                      f"{want[tuple(bad[0])].item() if bad.numel() else None!r}")
    print("[kernels] segmented-cumsum walk: the column-order emulation bit for bit at 37 and 300 "
          "rows, sizes 1 to 511, with NaN, inf and overflow")


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


def _check_scan_full(name, out, data, codes, want=None, groups=NGROUPS):
    """A full-width grouped cumsum of finite data over ``groups`` groups
    against ``want`` (default: a float64 ``torch.cumsum`` of each group's
    gathered columns), group by group, within ``n_g * u * cumsum|x|`` plus
    one ulp. Returns the max |error|."""
    check(out.shape == data.shape and out.dtype == data.dtype, f"{name}: {out.dtype}")
    worst = 0.0
    for g in range(groups):
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
    _reduction_family(ck, data, month, codes, totals, seed)
    _round_trips(ck, data, month, totals)
    torch.cuda.empty_cache()
    _label_layers(ck, data, month, totals, seed)
    torch.cuda.empty_cache()
    print(f"[main] launches over the main path {totals}")
    print(f"[memory] peak device memory so far "
          f"{max(_PEAK_SEEN[0], torch.cuda.max_memory_allocated()) / 1e9:.2f} GB")
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
# phase 3, continued: the rest of the reduction family at full width
# ---------------------------------------------------------------------------

#: the highest device memory seen before a per-call peak was taken
_PEAK_SEEN = [0]


def _drive_peak(ck, name: str, fn, want: dict, totals: dict):
    """:func:`_drive` with the call's own peak device memory printed: the
    peak above what was held before the call."""
    torch.cuda.synchronize()
    _PEAK_SEEN[0] = max(_PEAK_SEEN[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = _drive(ck, name, fn, want, totals)
    peak = torch.cuda.max_memory_allocated()
    print(f"[memory] {name}: peak {peak / 1e9:.2f} GB, {(peak - held) / 1e9:.2f} GB above the "
          f"{held / 1e9:.2f} GB held before it")
    return out


def _quantile_oracle(data, cols, qs) -> torch.Tensor:
    """float64 per-group quantiles of ``data`` (K, N), numpy's linear method:
    (len(qs), K, groups)."""
    out = torch.empty((len(qs), data.shape[0], len(cols)), dtype=torch.float64, device=DEVICE)
    for g, c in enumerate(cols):
        s = torch.sort(data.index_select(1, c).double(), dim=1).values
        for i, q in enumerate(qs):
            h = q * (c.numel() - 1)
            lo, hi = int(np.floor(h)), int(np.ceil(h))
            out[i, :, g] = s[:, lo] + (h - lo) * (s[:, hi] - s[:, lo])
        del s
    return out


def _reduction_family(ck, data, month, codes, totals, seed: int) -> None:
    """The argreductions, first/last, quantiles by sort and by radix select,
    and mode at full width, each with its kernels' launches checked:
    nanargmax 2 segment-min/max launches (float32 values, int32 positions),
    argmin 3 (and the first-NaN positions), nanfirst and nanlast 1 each
    (int32 positions), nanmedian and the sorted nanquantile none (torch
    sort), the selected nanquantile 32 segment-sum launches per row block
    (one counting pass per bit), mode of int32 classes 2 (int32 run lengths
    and positions). Then B3's int32 instance against its plain version at
    full width."""
    import flox_tpu_torch
    from flox_tpu_torch import kernels as pk

    k, n = data.shape
    cols = [torch.nonzero(codes == g).squeeze(1) for g in range(NGROUPS)]

    def reduce(func, arr=data, **kw):
        out, groups = flox_tpu_torch.groupby_reduce(arr, month, func=func, **kw)
        check(np.array_equal(groups, np.arange(NGROUPS)), f"{func}: groups {groups}")
        return out

    am = _drive_peak(ck, "nanargmax", lambda: reduce("nanargmax"), {"segment_minmax": 2}, totals)
    ai = _drive_peak(ck, "argmin", lambda: reduce("argmin"), {"segment_minmax": 3}, totals)
    for name, out, op in (("nanargmax", am, torch.argmax), ("argmin", ai, torch.argmin)):
        check(out.dtype == torch.int64 and tuple(out.shape) == (k, NGROUPS),
              f"{name}: result {tuple(out.shape)} {out.dtype}")
        for g, c in enumerate(cols):  # torch.argmax/argmin: the first extreme
            check(torch.equal(out[:, g], c[op(data.index_select(1, c), dim=1)]),
                  f"{name}: group {g} differs from the first extreme column")
    print("[main] nanargmax, argmin: exact (the first column holding each group's extreme)")
    del am, ai
    nf = _drive_peak(ck, "nanfirst", lambda: reduce("nanfirst"), {"segment_minmax": 1}, totals)
    nl = _drive_peak(ck, "nanlast", lambda: reduce("nanlast"), {"segment_minmax": 1}, totals)
    for name, out, at in (("nanfirst", nf, 0), ("nanlast", nl, -1)):
        want = data.index_select(1, torch.stack([c[at] for c in cols]))
        check(out.dtype == torch.float32 and torch.equal(bits(out), bits(want)),
              f"{name}: differs from each group's {'first' if at == 0 else 'last'} column")
    print("[main] nanfirst, nanlast: exact")
    del nf, nl
    torch.cuda.empty_cache()

    qs = (0.1, 0.5, 0.9)
    med = _drive_peak(ck, "nanmedian (sort)", lambda: reduce("nanmedian"), {}, totals)
    with flox_tpu_torch.set_options(quantile_impl="sort"):
        qsort = _drive_peak(ck, "nanquantile q=(0.1, 0.5, 0.9) (sort)",
                            lambda: reduce("nanquantile", finalize_kwargs={"q": qs}), {}, totals)
    blocks = len(pk._quantile_rows(data, len(qs), "linear", True))
    with flox_tpu_torch.set_options(quantile_impl="select"):
        qsel = _drive_peak(ck, f"nanquantile q=(0.1, 0.5, 0.9) (select, {blocks} row blocks)",
                           lambda: reduce("nanquantile", finalize_kwargs={"q": qs}),
                           {"segment_sum": 32 * blocks}, totals)
    check(tuple(qsort.shape) == (3, k, NGROUPS) and qsort.dtype == torch.float32,
          f"nanquantile: result {tuple(qsort.shape)} {qsort.dtype}")
    check(torch.equal(bits(qsort), bits(qsel)), "nanquantile: sort and select differ")
    print("[main] nanquantile: the sort and select paths bit-identical")
    oracle = _quantile_oracle(data, cols, (0.5,) + qs)
    _check_close("nanmedian", med, oracle[0])
    for i, q in enumerate(qs):
        _check_close(f"nanquantile q={q}", qsort[i], oracle[i + 1])
    del med, qsort, qsel, oracle
    torch.cuda.empty_cache()

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    classes = torch.randint(0, 10, (k, n), generator=gen, device=DEVICE, dtype=torch.int32)
    mo = _drive_peak(ck, "mode (int32 classes 0-9)", lambda: reduce("mode", arr=classes),
                     {"segment_minmax": 2}, totals)
    check(mo.dtype == torch.int32 and tuple(mo.shape) == (k, NGROUPS),
          f"mode: result {tuple(mo.shape)} {mo.dtype}")
    for g, c in enumerate(cols):
        sub = classes.index_select(1, c).long()
        counts = torch.zeros((k, 10), dtype=torch.int64, device=DEVICE).scatter_add_(
            1, sub, torch.ones_like(sub))
        # torch.argmax takes the first of tied counts: the smallest class
        check(torch.equal(mo[:, g].long(), torch.argmax(counts, dim=1)),
              f"mode: group {g} differs from the bincount oracle")
        del sub, counts
    print("[main] mode: exact (bincount per group, ties to the smallest value)")
    del mo, classes
    torch.cuda.empty_cache()

    wide = torch.randint(-2**31, 2**31 - 1, (k, n), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    codes32 = codes.to(torch.int32)
    for op in ("min", "max"):
        got = ck.segment_minmax(wide, codes32, NGROUPS, op)
        check(torch.equal(got, ck.segment_minmax_plain(wide, codes32, NGROUPS, op)),
              f"full width: segment_minmax int32 {op} differs from its plain version")
    print(f"[kernels] segment_minmax int32 min and max at full width ({k}, {n}): exact")
    del wide, got
    torch.cuda.empty_cache()


def _round_trips(ck, data, month, totals, rows: int = 2048) -> None:
    """Datetime64, timedelta64, bool and string inputs on the first ``rows``
    rows (16 for strings): these are host numpy arrays by nature (torch has
    no datetime or string dtype; the port views datetimes as int64 and
    reduces strings through float64 positions), checked exactly against
    numpy per-group oracles on the host. Their launches: the datetime
    nanfirst takes int32 positions (1 segment-min/max launch); int64,
    float64, bool and position reductions otherwise run on torch ops."""
    import flox_tpu_torch

    x = data[:rows].cpu().numpy()
    rows, n = x.shape
    cols = [np.flatnonzero(month == g) for g in range(NGROUPS)]
    nat = np.iinfo(np.int64).min
    hours = (np.arange(n) * 3600 * 10**9).astype("timedelta64[ns]")
    t = (np.datetime64("2020-01-01T00:00:00", "ns") + hours
         + (x * 6e10).astype(np.int64).astype("timedelta64[ns]"))
    t[x > 2.0] = np.datetime64("NaT")
    ti = t.view("int64")

    def reduce(func, arr, **kw):
        return flox_tpu_torch.groupby_reduce(arr, month, func=func, **kw)[0]

    got = _drive(ck, "datetime64 nanmax", lambda: reduce("nanmax", t), {}, totals)
    want = np.stack([np.where(ti[:, c] == nat, nat, ti[:, c]).max(1) for c in cols], 1)
    check(got.dtype == t.dtype and np.array_equal(got.view("int64"), want),
          "datetime64 nanmax differs")
    got = _drive(ck, "datetime64 nanfirst", lambda: reduce("nanfirst", t),
                 {"segment_minmax": 1}, totals)
    want = []
    for c in cols:
        valid = ti[:, c] != nat
        first = np.argmax(valid, axis=1)
        want.append(np.where(valid.any(1), ti[np.arange(rows), c[first]], nat))
    check(got.dtype == t.dtype and np.array_equal(got.view("int64"), np.stack(want, 1)),
          "datetime64 nanfirst differs")
    td = (x * 1e9).astype("int64").view("timedelta64[ns]")
    td[x < -2.0] = np.timedelta64("NaT")
    tdi = td.view("int64")
    got = _drive(ck, "timedelta64 nanmean", lambda: reduce("nanmean", td), {}, totals)
    want = np.stack([np.nanmean(np.where(tdi[:, c] == nat, np.nan, tdi[:, c].astype(np.float64)),
                                axis=1) for c in cols], 1)
    err = np.abs(got.view("int64") - np.round(want)).max()
    check(got.dtype == td.dtype and err <= 1, f"timedelta64 nanmean off by {err} ns")
    got = _drive(ck, "timedelta64 ffill", lambda: flox_tpu_torch.groupby_scan(
        td, month, func="ffill"), {}, totals)
    want = np.empty_like(tdi)
    last = np.full((rows, NGROUPS), nat)
    for c, g in enumerate(month):
        last[:, g] = np.where(tdi[:, c] == nat, last[:, g], tdi[:, c])
        want[:, c] = last[:, g]
    check(got.dtype == td.dtype and np.array_equal(got.view("int64"), want),
          "timedelta64 ffill differs from the sequential fill")
    b = x > 0
    got = _drive(ck, "bool sum", lambda: reduce("sum", b), {}, totals)
    want = np.stack([b[:, c].sum(1) for c in cols], 1)
    check(got.dtype == torch.int64 and np.array_equal(got.cpu().numpy(), want), "bool sum differs")
    got = _drive(ck, "bool any", lambda: reduce("any", b), {}, totals)
    check(got.dtype == torch.bool and np.array_equal(got.cpu().numpy(), want > 0),
          "bool any differs")
    s = np.char.mod("%d", np.round(x[:16] * 100).astype(np.int64))
    for func, at in (("nanfirst", 0), ("nanlast", -1)):
        got = _drive(ck, f"string {func} (16 rows)", lambda f=func: reduce(f, s), {}, totals)
        check(np.array_equal(got, s[:, [c[at] for c in cols]]), f"string {func} differs")
    got = _drive(ck, "string count (16 rows)", lambda: reduce("count", s), {}, totals)
    check(np.array_equal(got.cpu().numpy(), np.tile([len(c) for c in cols], (s.shape[0], 1))),
          "string count differs")
    print(f"[main] datetime64 nanmax/nanfirst, timedelta64 nanmean/ffill, bool sum/any on "
          f"{rows} rows and string nanfirst/nanlast/count on 16: exact")


# ---------------------------------------------------------------------------
# phase 3, continued: the label layers (A6) at full width
# ---------------------------------------------------------------------------

LAT_EDGES = np.arange(-90, 91, 10)  # 18 latitude bands, right-closed as pd.cut


def _classes(shape, seed: int) -> torch.Tensor:
    """int32 classes 0-9 made on the card from ``seed`` (mode's data)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    return torch.randint(0, 10, shape, generator=gen, device=DEVICE, dtype=torch.int32)


def label_objects(data, month, seed: int) -> dict:
    """The benchmark array as an xrlite ``DataArray`` of dims (lat, lon, time)
    (a view, no copy) with ``month`` (1-12), ``day`` and ``lat`` coordinates;
    a ``Dataset`` of it and the int32 classes; the month labels on the card;
    the prefactorized month labels; and a sparse (65160, 26304) tensor at 1 %
    density made from ``seed`` (random positions, so a few repeat: it is
    left uncoalesced)."""
    import flox_tpu_torch
    from flox_tpu_torch import xrlite

    k, n = data.shape
    dims = ("lat", "lon", "time")
    coords = {"lat": np.linspace(-90.0, 90.0, NLAT), "month": ("time", month + 1),
              "day": ("time", np.arange(n) // 24)}
    da = xrlite.DataArray(data.view(NLAT, NLON, n), dims=dims, coords=coords, name="t2m")
    cls = xrlite.DataArray(_classes(data.shape, seed).view(NLAT, NLON, n), dims=dims,
                           name="cls")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 2)
    nnz = int(0.01 * k * n)
    flat = torch.randint(0, k * n, (nnz,), generator=gen, device=DEVICE)
    # multiples of 1/64: the repeated positions sum exactly in any order
    vals = torch.round(torch.randn(nnz, generator=gen, device=DEVICE) * 64) / 64
    sparse = torch.sparse_coo_tensor(torch.stack([flat // n, flat % n]), vals, (k, n))
    return {
        "da": da,
        "ds": xrlite.Dataset({"t2m": da, "cls": cls}, coords={"month": ("time", month + 1)}),
        "month_dev": torch.from_numpy(month + 1).to(DEVICE),
        "pf": flox_tpu_torch.prefactorize(month),
        "sparse": sparse,
    }


def label_calls(data, month, objs: dict) -> dict:
    """The label layers' end-to-end calls as phase 3 drives them, with the
    kernels each must launch: ``{name: (fn, {kernel: launches})}``."""
    import flox_tpu_torch
    from flox_tpu_torch.reindex import ReindexArrayType, ReindexStrategy

    xr = flox_tpu_torch.xarray_reduce
    day = np.arange(data.shape[1]) // 24
    trio = ("nanmean", "nanmin", "nanmax")
    calls = {
        "xarray_reduce(da, 'month', nanmean)": (
            lambda: xr(objs["da"], "month", func="nanmean"), {"segment_sum": 1}),
        "xarray_reduce(da, 'day', nanmean)": (
            lambda: xr(objs["da"], "day", func="nanmean"), {"segment_sum_radixbin": 1}),
        "xarray_reduce(ds, 'month', nanmax)": (
            lambda: xr(objs["ds"], "month", func="nanmax"), {"segment_minmax": 2}),
        "xarray_reduce(da, 'lat', nanmean, 18 bins)": (
            lambda: xr(objs["da"], "lat", func="nanmean", isbin=True,
                       expected_groups=LAT_EDGES), {"segment_sum": 1}),
        "groupby_reduce_device(month on the card, nanmean)": (
            lambda: flox_tpu_torch.groupby_reduce_device(
                data, objs["month_dev"], func="nanmean", expected_values=np.arange(1, 13)),
            {"segment_sum": 1}),
        "groupby_reduce(prefactorized month, nanmean)": (
            lambda: flox_tpu_torch.groupby_reduce(data, objs["pf"], func="nanmean")[0],
            {"segment_sum": 1}),
        "aggregate_many(prefactorized month, nanmean, nanmin, nanmax)": (
            lambda: flox_tpu_torch.groupby_aggregate_many(data, objs["pf"], funcs=trio)[0],
            {"segment_multistat": 1}),
    }
    for func in ("nansum", "nanmean", "nanmax", "count"):
        calls[f"sparse {func} (1 % density)"] = (
            lambda f=func: flox_tpu_torch.groupby_reduce(objs["sparse"], month, func=f)[0], {})
    calls[f"sort engine nanmean, SPARSE_COO ({SORT_ROWS} rows)"] = (
        lambda: flox_tpu_torch.groupby_reduce(
            data[:SORT_ROWS], DAY0 + day, func="nanmean", expected_groups=np.arange(NUNIVERSE),
            engine="sort", reindex=ReindexStrategy(array_type=ReindexArrayType.SPARSE_COO))[0],
        {"segment_sum_radixbin": 1})
    calls["groupby_reduce(engine='numpy'), 2048 rows"] = (
        lambda: flox_tpu_torch.groupby_reduce(data[:2048], month, func="nanmean",
                                              engine="numpy")[0], {})
    return calls


def _label_layers(ck, data, month, totals, seed: int) -> None:
    """xarray_reduce on an xrlite DataArray and Dataset, groupby_reduce_device,
    prefactorized labels, sparse inputs, the SPARSE_COO result leg and the
    host numpy engine at full width, each with its launches and peak memory
    checked, against the matching groupby_reduce call (bit for bit, or
    exactly) or a float64 reduction of the same data on the card."""
    import flox_tpu_torch
    from flox_tpu_torch import device as pdevice, kernels as pk
    from flox_tpu_torch.reindex import HostCOO
    from flox_tpu_torch.types import Bins

    k, n = data.shape
    objs = label_objects(data, month, seed)
    calls = label_calls(data, month, objs)
    runs = iter(calls.items())

    def drive():
        name, (fn, want) = next(runs)
        return name, _drive_peak(ck, name, fn, want, totals)

    def reduce(arr, by, func, **kw):
        return flox_tpu_torch.groupby_reduce(arr, by, func=func, **kw)[0]

    def bit_equal(name, got, want):
        check(got.dtype == want.dtype and torch.equal(bits(got), bits(want)),
              f"{name}: differs from groupby_reduce")
        print(f"[main] {name}: bit-identical to groupby_reduce")

    means = reduce(data, month, "nanmean")
    name, out = drive()
    check(out.dims == ("lat", "lon", "month") and isinstance(out.data, torch.Tensor)
          and out.data.device.type == torch.device(DEVICE).type,
          f"{name}: dims {out.dims}, {type(out.data)}")
    check(np.array_equal(out["month"].data, np.arange(1, 13)), f"{name}: month coordinate")
    bit_equal(name, out.data, means.view(NLAT, NLON, NGROUPS))
    del out

    day = np.arange(n) // 24
    name, out = drive()
    check(out.dims == ("lat", "lon", "day") and np.array_equal(out["day"].data, np.arange(NDAYS)),
          f"{name}: dims {out.dims}")
    bit_equal(name, out.data, reduce(data, day, "nanmean").view(NLAT, NLON, NDAYS))
    del out
    torch.cuda.empty_cache()

    name, out = drive()
    cls = objs["ds"]["cls"].data.reshape(k, n)
    for var, arr in (("t2m", data), ("cls", cls)):
        got = out[var]
        check(got.dims == ("month", "lat", "lon"), f"{name} {var}: dims {got.dims}")
        want = reduce(arr, month, "nanmax").view(NLAT, NLON, NGROUPS).permute(2, 0, 1)
        check(got.data.dtype == want.dtype and torch.equal(got.data, want),
              f"{name} {var}: differs from groupby_reduce")
    print(f"[main] {name}: float32 and int32 members exactly groupby_reduce's")
    del out, cls
    torch.cuda.empty_cache()

    name, out = drive()
    lat = objs["da"]["lat"].data
    coord = out["lat_bins"].data
    check(out.dims == ("lat_bins", "lon", "time") and tuple(out.shape) == (18, NLON, n),
          f"{name}: dims {out.dims} {tuple(out.shape)}")
    check(isinstance(coord, Bins) and coord.closed == "right"
          and np.array_equal(coord.edges, LAT_EDGES), f"{name}: coordinate {coord!r}")
    rows3 = data.view(NLAT, NLON * n)
    worst = 0.0
    for b in range(len(LAT_EDGES) - 1):
        idx = np.flatnonzero((lat > LAT_EDGES[b]) & (lat <= LAT_EDGES[b + 1]))
        ref = rows3[torch.as_tensor(idx, device=DEVICE)].double().mean(0)
        err = (out.data[b].reshape(-1).double() - ref).abs()
        check(bool((err <= 1e-6 + 1e-5 * ref.abs()).all()), f"{name}: band {b} off by "
              f"{err.max().item()}")
        worst = max(worst, err.max().item())
        del ref, err
    print(f"[main] {name}: max |err| vs float64 {worst!r}")
    del out
    torch.cuda.empty_cache()

    name, out = drive()
    bit_equal(name, out, means)
    name, out = drive()
    bit_equal(name, out, means)
    name, out = drive()
    fused = flox_tpu_torch.groupby_aggregate_many(data, month, funcs=tuple(out))[0]
    for f, t in out.items():
        bit_equal(f"{name} {f}", t, fused[f])
    del out, fused
    torch.cuda.empty_cache()

    sparse = objs["sparse"]
    dense = sparse.to_dense()
    coalesced = sparse.coalesce().indices()
    seg = coalesced[0] * NGROUPS + objs["month_dev"].index_select(0, coalesced[1]) - 1
    stored_max = int(torch.bincount(seg, minlength=k * NGROUPS).max())
    codes = torch.from_numpy(month).to(DEVICE)
    for func in ("nansum", "nanmean", "nanmax", "count"):
        name, out = drive()
        check(tuple(out.shape) == (k, NGROUPS), f"{name}: shape {tuple(out.shape)}")
        if func == "count":
            want = torch.bincount(codes, minlength=NGROUPS).expand(k, NGROUPS)
            check(torch.equal(out.long(), want), f"{name}: differs from the column counts")
        elif func == "nanmax":
            check(torch.equal(out, reduce(dense, month, "nanmax")),
                  f"{name}: differs from the dense nanmax")
        elif func == "nanmean":
            _check_close(name, out, _f64_reference(dense, codes, NGROUPS, "nanmean"))
        else:
            ref = _f64_reference(dense, codes, NGROUPS, "sum")
            scale = torch.cat([abs_sums(dense[r : r + 8192], codes, NGROUPS).T
                               for r in range(0, k, 8192)])
            err = (out.double() - ref).abs()
            check(bool((err <= _sum_bar("plain", stored_max, scale, ref)).all()),
                  f"{name}: max err {err.max().item()}")
            print(f"[main] {name}: max |err| vs float64 {err.max().item()!r} (at most "
                  f"{stored_max} stored values a group and row)")
            del ref, scale, err
        if func in ("count", "nanmax"):
            print(f"[main] {name}: exact")
    print(f"[main] sparse input: {sparse._nnz()} entries, "
          f"{coalesced.shape[1]} after coalescing")
    del dense, coalesced, seg, out
    torch.cuda.empty_cache()

    name, out = drive()
    dense_sort = reduce(data[:SORT_ROWS], DAY0 + day, "nanmean",
                        expected_groups=np.arange(NUNIVERSE), engine="sort")
    present = pk.present_groups(DAY0 + day, NUNIVERSE)
    check(isinstance(out, HostCOO) and out.shape == (SORT_ROWS, NUNIVERSE)
          and np.isnan(out.fill_value) and np.array_equal(out.columns, present),
          f"{name}: {type(out).__name__} {getattr(out, 'shape', None)}")
    check(np.array_equal(out.data.view(np.int32),
                         dense_sort.index_select(1, torch.from_numpy(present).to(DEVICE))
                         .cpu().numpy().view(np.int32)),
          f"{name}: stored columns differ from the dense result")
    print(f"[main] {name}: {len(present)} stored columns bit-identical to the dense result, "
          f"the rest its NaN fill")
    del out, dense_sort

    name, out = drive()
    check(out.device.type == torch.device(DEVICE).type, f"{name}: result on {out.device}")
    _check_close(name, out, reduce(data[:2048], month, "nanmean").double())

    torch.cuda.synchronize()
    stats = pdevice.memory_stats()
    check(stats is not None and stats["devices"] == torch.cuda.device_count()
          and stats["bytes_in_use"] == torch.cuda.memory_allocated()
          and stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
          and stats["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory,
          f"memory_stats {stats} differs from torch.cuda's allocator counters")
    print(f"[main] memory_stats: {stats}, torch.cuda's counters")
    del objs, calls


def label_times(ck, data, month, seed: int, reps: int) -> dict:
    """Each label-layer call's median time (CUDA events, after a warm-up),
    its launches a call and its peak device memory above what was held before
    it. Returns the xarray calls, for the profile."""
    import flox_tpu_torch

    objs = label_objects(data, month, seed)
    calls = label_calls(data, month, objs)
    nbytes = NLAT * NLON * NTIME * 4
    # the adapter's cost: the months call against the groupby_reduce call it
    # makes, in turns (plain, adapter, adapter, plain)
    pair = {"groupby_reduce(data, month, nanmean)":
            lambda: flox_tpu_torch.groupby_reduce(data, month, func="nanmean"),
            "xarray_reduce(da, 'month', nanmean)":
            calls["xarray_reduce(da, 'month', nanmean)"][0]}
    for name in (*pair, *reversed(pair)):
        print(f"[times] in turns, {name}: {time_ms(pair[name], reps)!r} ms")
    for name, (fn, _want) in calls.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ck.reset_launches()
        e2e_ms = time_ms(fn, reps)
        peak = torch.cuda.max_memory_allocated() - held
        per_call = {kk: v // (reps + 1) for kk, v in ck.LAUNCHES.items() if v}
        torch.cuda.empty_cache()
        print(f"[times] end-to-end {name}: {e2e_ms!r} ms, {nbytes / (e2e_ms * 1e-3) / 1e9!r} "
              f"GB/s of the full array, launches a call {per_call}, peak {peak / 1e9:.2f} GB "
              f"above the {held / 1e9:.2f} GB held")
    return {name: fn for name, (fn, _w) in calls.items() if name.startswith("xarray_reduce")}


def _family_calls(data, month, seed: int) -> dict:
    """The reduction family's end-to-end calls as phase 3 drives them, for
    timing and the profile."""
    import flox_tpu_torch

    classes = _classes(data.shape, seed)
    qs = {"q": (0.1, 0.5, 0.9)}

    def reduce(func, arr=data, impl="auto", **kw):
        with flox_tpu_torch.set_options(quantile_impl=impl):
            return flox_tpu_torch.groupby_reduce(arr, month, func=func, **kw)

    return {
        "nanargmax": lambda: reduce("nanargmax"),
        "argmin": lambda: reduce("argmin"),
        "nanfirst": lambda: reduce("nanfirst"),
        "nanlast": lambda: reduce("nanlast"),
        "nanmedian (sort)": lambda: reduce("nanmedian"),
        "nanquantile q=(0.1, 0.5, 0.9) (sort)": lambda: reduce("nanquantile", impl="sort",
                                                               finalize_kwargs=qs),
        "nanquantile q=(0.1, 0.5, 0.9) (select)": lambda: reduce("nanquantile", impl="select",
                                                                 finalize_kwargs=qs),
        "mode (int32 classes 0-9)": lambda: reduce("mode", arr=classes),
    }


def _family_times(ck, calls: dict, reps: int) -> None:
    """Each call's median time (CUDA events, after a warm-up) and its kernel
    launches a call."""
    nbytes = NLAT * NLON * NTIME * 4
    for name, fn in calls.items():
        ck.reset_launches()
        e2e_ms = time_ms(fn, reps)
        per_call = {kk: v // (reps + 1) for kk, v in ck.LAUNCHES.items() if v}
        torch.cuda.empty_cache()
        print(f"[times] end-to-end {name}: {e2e_ms!r} ms, {nbytes / (e2e_ms * 1e-3) / 1e9!r} "
              f"GB/s of input, launches a call {per_call}")


# ---------------------------------------------------------------------------
# phase 3, continued: the multi-device runtime (flox_tpu_torch.parallel)
# ---------------------------------------------------------------------------

MESH_ROWS = 8192  # the two-rank phase's cut of the rows
MESH_DEADLINE_S = 420.0  # the two-rank phase's deadline, spawn to exit


def _once_ms(fn):
    """One run of ``fn`` timed with CUDA events: ``(result, ms)``."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _result(out):
    """The result of an entry point: its tensor, or for groupby_aggregate_many
    its dict (the group values dropped)."""
    return out[0] if isinstance(out, tuple) else out


def _same_result(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[kk], b[kk]) for kk in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a.view("int64"), b.view("int64"))
    return same(a, b)


def _mesh_calls(data, month, mesh, mesh2) -> list:
    """The mesh calls of the full-width phase, each beside its eager
    counterpart: ``(name, mesh call, eager call, options, slow)``; ``mesh2``
    is a (1, 1) ("dcn", "ici") mesh."""
    import flox_tpu_torch as ft

    n = data.shape[-1]
    day = np.arange(n, dtype=np.int64) // 24
    qs = {"q": (0.1, 0.5, 0.9)}
    trio = ("nanmean", "nanmin", "nanmax")
    select = {"quantile_impl": "select"}

    def red(func, method, labels=month, **kw):
        return (lambda: ft.groupby_reduce(data, labels, func=func, method=method, mesh=mesh, **kw),
                lambda: ft.groupby_reduce(data, labels, func=func, **kw))

    return [
        ("map-reduce nanmean", *red("nanmean", "map-reduce"), {}, False),
        ("cohorts nanvar (ddof=1)", *red("nanvar", "cohorts", finalize_kwargs={"ddof": 1}),
         {}, False),
        ("map-reduce nanargmax", *red("nanargmax", "map-reduce"), {}, False),
        ("Blelloch nancumsum",
         lambda: ft.groupby_scan(data, month, func="nancumsum", method="blelloch", mesh=mesh),
         lambda: ft.groupby_scan(data, month, func="nancumsum"), {}, False),
        ("blockwise nanmedian (select)", *red("nanmedian", "blockwise"), select, True),
        ("map-reduce nanquantile q=(0.1, 0.5, 0.9) (select)",
         *red("nanquantile", "map-reduce", finalize_kwargs=qs), select, True),
        ("cohorts nansum", *red("nansum", "cohorts"), {}, False),
        ("map-reduce aggregate_many(nanmean, nanmin, nanmax)",
         lambda: ft.groupby_aggregate_many(data, month, funcs=trio, method="map-reduce",
                                           mesh=mesh),
         lambda: ft.groupby_aggregate_many(data, month, funcs=trio), {}, False),
        ("map-reduce daily nanmean (1096 groups)", *red("nanmean", "map-reduce", labels=day),
         {}, False),
        ("map-reduce nanmean over (dcn, ici)",
         lambda: ft.groupby_reduce(data, month, func="nanmean", method="map-reduce", mesh=mesh2,
                                   axis_name=("dcn", "ici")),
         lambda: ft.groupby_reduce(data, month, func="nanmean"), {}, False),
    ]


def _mesh_launches(data) -> dict:
    """The kernel launches each full-width mesh call must make: the shard
    (here the whole array) goes through the eager path's kernels, plus the
    Blelloch scan's block sums (B1) and the argreduction's extreme values
    (B3); the radix select's 32 counting passes run per row block."""
    from flox_tpu_torch import kernels as pk

    median_blocks = len(pk._quantile_rows(data, 1, "linear", True))
    quantile_blocks = len(pk._quantile_rows(data, 3, "linear", True))
    return {
        "map-reduce nanmean": {"segment_sum": 1},
        "cohorts nanvar (ddof=1)": {"segment_sum": 2},
        "map-reduce nanargmax": {"segment_minmax": 3},
        "Blelloch nancumsum": {"segment_cumsum": 1, "segment_sum": 1},
        "blockwise nanmedian (select)": {"segment_sum": 32 * median_blocks},
        "map-reduce nanquantile q=(0.1, 0.5, 0.9) (select)":
            {"segment_sum": 32 * quantile_blocks},
        "cohorts nansum": {"segment_sum": 1},
        "map-reduce aggregate_many(nanmean, nanmin, nanmax)": {"segment_multistat": 1},
        "map-reduce daily nanmean (1096 groups)": {"segment_sum_radixbin": 1},
        "map-reduce nanmean over (dcn, ici)": {"segment_sum": 1},
    }


def _world_of_one(tmp: str) -> None:
    """A torch.distributed world of one rank: NCCL on the card (gloo when
    rehearsing on the CPU), on a file store in ``tmp``."""
    import torch.distributed as dist

    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", world_size=1, rank=0)


def phase_mesh(data, month, totals: dict, reps: int) -> list:
    """The multi-device runtime at full width on a world of one rank: each
    mesh call with its launches checked (the counts set to 0 just before it),
    its peak memory, bit for bit against the eager call on the same data,
    and both timed (CUDA events; the select calls once each, the others the
    median of ``reps`` after a warm-up)."""
    import flox_tpu_torch
    from flox_tpu_torch import cuda_kernels as ck
    from flox_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device_type=DEVICE)
    mesh2 = make_mesh(shape=(1, 1), axis_names=("dcn", "ici"), device_type=DEVICE)
    print(f"[mesh] world of one: {mesh}, {mesh2}")
    want = _mesh_launches(data)
    rows = []
    for name, mesh_fn, eager_fn, opts, slow in _mesh_calls(data, month, mesh, mesh2):
        with flox_tpu_torch.set_options(**opts):
            got, ms = _once_ms(lambda: _drive_peak(ck, f"mesh {name}", mesh_fn, want[name],
                                                   totals))
            ref, eager_ms = _once_ms(eager_fn)
            check(_same_result(_result(got), _result(ref)),
                  f"mesh {name}: differs from the eager call")
            del got, ref
            torch.cuda.empty_cache()
            if not slow:
                ms = time_ms(mesh_fn, reps)
                eager_ms = time_ms(eager_fn, reps)
                torch.cuda.empty_cache()
        rows.append((name, ms, eager_ms))
        print(f"[mesh] {name}: bit-identical to eager; {ms!r} ms, eager {eager_ms!r} ms, "
              f"mesh path's own cost {ms - eager_ms!r} ms")
    _mesh_rechunk(ck, data, month, mesh, totals)
    return rows


def _mesh_rechunk(ck, data, month, mesh, totals: dict) -> None:
    """``xarray.rechunk_for_blockwise`` of the array as an xrlite DataArray
    (every month made shard-local: on one rank, the columns in month order, a
    6.86 GB copy), its blockwise nanmean (B1 1) against a float64 mean, and
    ``xarray.rechunk_for_cohorts`` chunk lengths of the months."""
    import flox_tpu_torch as ft
    from flox_tpu_torch import xarray as fx, xrlite

    da = xrlite.DataArray(data, dims=("cell", "time"), coords={"month": ("time", month)})
    (out, codes, groups), ms = _once_ms(lambda: fx.rechunk_for_blockwise(da, "time", month))
    check(out.dims == ("cell", "time") and tuple(out.data.shape) == tuple(data.shape)
          and np.array_equal(groups, np.arange(NGROUPS)), f"rechunk_for_blockwise: {out.dims}")
    got = _drive_peak(ck, "mesh blockwise nanmean after xarray.rechunk_for_blockwise",
                      lambda: ft.groupby_reduce(out.data, codes, func="nanmean",
                                                method="blockwise", mesh=mesh,
                                                expected_groups=np.arange(NGROUPS))[0],
                      {"segment_sum": 1}, totals)
    _check_close("blockwise nanmean after rechunk_for_blockwise", got,
                 _f64_reference(data, torch.from_numpy(month).to(DEVICE), NGROUPS, "nanmean"))
    del out, got
    torch.cuda.empty_cache()
    chunks = fx.rechunk_for_cohorts(da, "time", month, force_new_chunk_at=[0])
    check(sum(chunks) == data.shape[1], f"rechunk_for_cohorts: {sum(chunks)} columns")
    print(f"[mesh] xarray.rechunk_for_blockwise {ms!r} ms (the permute copy); "
          f"rechunk_for_cohorts: {len(chunks)} chunks")


# ---------------------------------------------------------------------------
# phase 3, continued: streaming host slabs through the card
# ---------------------------------------------------------------------------

#: streaming's default slab budget (flox_tpu_torch.streaming._DEFAULT_BATCH_BYTES)
STREAM_BATCH_BYTES = 256 * 2**20


def _stream_len(k: int, itemsize: int = 4) -> int:
    """Columns a slab of the default budget holds, as the streaming runtime
    derives them."""
    return max(1, STREAM_BATCH_BYTES // (k * itemsize))


def _slab_fold(data, labels, batch_len: int, funcs: tuple, groups: int) -> dict:
    """The fold, in slab order, of the port's eager ``groupby_aggregate_many``
    on the same slabs the stream stages (device copies of ``data``'s columns):
    sums and counts added, extrema by ``fmin``/``fmax`` (a slab's absent group
    holds the NaN fill)."""
    import flox_tpu_torch

    acc: dict = {}
    n = data.shape[-1]
    for s in range(0, n, batch_len):
        e = min(n, s + batch_len)
        out, _ = flox_tpu_torch.groupby_aggregate_many(
            data[:, s:e].contiguous(), labels[s:e], funcs=funcs,
            expected_groups=np.arange(groups))
        for f, v in out.items():
            if f not in acc:
                acc[f] = v
            elif f in ("nanmin", "nanmax"):
                acc[f] = (torch.fmin if f == "nanmin" else torch.fmax)(acc[f], v)
            else:
                acc[f] = acc[f] + v
    return acc


def _fold_mean(fold: dict) -> torch.Tensor:
    return fold["nansum"] / fold["count"]


def _link_rates(host: np.ndarray, batch_len: int, reps: int = 5) -> tuple[float, float]:
    """The two rates a streamed slab passes through, each alone: the host fill
    (the loader's strided column slab copied into a pinned buffer, one
    thread) and the pinned host-to-device copy (CUDA events), in GB/s."""
    k = host.shape[0]
    pinned = torch.empty((k, batch_len), dtype=torch.float32, pin_memory=True)
    dev = torch.empty((k, batch_len), dtype=torch.float32, device=DEVICE)
    nbytes = pinned.numel() * 4
    fills = []
    for i in range(reps):
        s = (i * batch_len) % (host.shape[1] - batch_len)
        t0 = time.perf_counter()
        np.copyto(pinned.numpy(), host[:, s:s + batch_len])
        fills.append(time.perf_counter() - t0)
    fill_gbps = nbytes / statistics.median(fills) / 1e9
    h2d_ms = time_ms(lambda: dev.copy_(pinned, non_blocking=True), reps)
    del pinned, dev
    return fill_gbps, nbytes / (h2d_ms * 1e-3) / 1e9


def phase_streaming(data, month, codes, totals: dict) -> dict:
    """Streaming from host memory (``streaming_groupby_*``) at full width and
    on the SORT_ROWS cut: each streamed call with its launches counted from 0,
    bit for bit the slab-order fold of the eager calls on the same slabs and
    within the float64 bar; the peak device memory of the streamed nanmean
    against ``(prefetch + 2)`` slabs plus the accumulators; prefetch 0 against
    2; then quantiles, the scan, the sort engine, a loader, and the faults:
    a simulated OOM, a real one under a memory cap, and a kill with its
    resume. Returns the measured numbers."""
    import flox_tpu_torch
    from flox_tpu_torch import cuda_kernels as ck, faults, profiling, streaming as pst

    k, n = data.shape
    t_host = time.perf_counter()
    host = data.cpu().numpy()
    month = np.asarray(month)
    print(f"[stream] host copy of the data {host.nbytes / 1e9:.2f} GB in "
          f"{time.perf_counter() - t_host:.2f} s")
    batch_len = _stream_len(k)
    nslabs = -(-n // batch_len)
    slab_bytes = k * batch_len * 4
    acc_bytes = 16 * k * NGROUPS * 4  # the carry and the step's (K, groups) temporaries
    out = {"batch_len": batch_len, "nslabs": nslabs, "slab_bytes": slab_bytes}
    fill_gbps, h2d_gbps = _link_rates(host, batch_len)
    out.update(fill_gbps=fill_gbps, h2d_gbps=h2d_gbps)
    print(f"[stream] {nslabs} slabs of {batch_len} columns ({slab_bytes / 1e6:.1f} MB); one "
          f"thread fills a pinned slab at {fill_gbps!r} GB/s; pinned host-to-device "
          f"{h2d_gbps!r} GB/s")
    codes = torch.as_tensor(month, device=DEVICE)

    # -- the main path at full width: nanmean by month, prefetch 2 ---------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _PEAK_SEEN[0] = max(_PEAK_SEEN[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with profiling.stream_monitor() as reports:
        got = _drive(ck, "streamed nanmean (months, prefetch 2)",
                     lambda: pst.streaming_groupby_reduce(host, month, func="nanmean")[0],
                     {"segment_sum": nslabs}, totals)
    peak = torch.cuda.max_memory_allocated() - held
    bound = (2 + 2) * slab_bytes + acc_bytes
    out.update(peak_bytes=peak, peak_bound=bound)
    print(f"[memory] streamed nanmean: peak {peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB "
          f"held, bound (prefetch + 2) slabs + accumulators {bound / 1e9:.3f} GB")
    check(peak <= bound, f"streamed nanmean: peak {peak} above the bound {bound}")
    check(got.device.type == torch.device(DEVICE).type and tuple(got.shape) == (k, NGROUPS)
          and got.dtype == torch.float32, f"streamed nanmean: {got.shape} {got.dtype}")
    fold = _slab_fold(data, month, batch_len, ("nansum", "count"), NGROUPS)
    check(torch.equal(bits(got), bits(_fold_mean(fold))),
          "streamed nanmean differs from the slab-order fold of the eager calls")
    _check_close("streamed nanmean", got, _f64_reference(data, codes, NGROUPS, "nanmean"))
    print("[stream] streamed nanmean: bit for bit the slab-order fold of eager nansum/count")
    del fold
    rep = reports[0]
    print(f"[stream] {rep.summary()}")

    # -- prefetch 0 against 2: wall time, host-to-device rate, overlap -----
    for depth in (0, 2, 0, 2):
        with flox_tpu_torch.set_options(stream_prefetch=depth):
            with profiling.stream_monitor() as reps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = pst.streaming_groupby_reduce(host, month, func="nanmean")[0]
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        check(torch.equal(bits(again), bits(got)), f"prefetch {depth}: other bits")
        r = reps[0]
        gbps = host.nbytes / (wall * 1e-3) / 1e9
        out.setdefault(f"prefetch{depth}", []).append(
            {"ms": wall, "gbps": gbps, "overlap": r.overlap_fraction, "wait_ms": r.wait_ms,
             "load_ms": r.load_ms, "stage_ms": r.stage_ms, "dispatch_ms": r.dispatch_ms})
        print(f"[stream] streamed nanmean prefetch {depth}: {wall!r} ms, {gbps!r} GB/s of input; "
              f"overlap {r.overlap_fraction!r}, wait {r.wait_ms!r} ms, load {r.load_ms!r} ms, "
              f"stage {r.stage_ms!r} ms, dispatch {r.dispatch_ms!r} ms")
    del again
    # the card's busy time in a stream (B1, the slab copies, the merges)
    # and its idle share, from a trace of one call at the default prefetch
    device_breakdown({"streamed nanmean (months, prefetch 2)":
                      lambda: pst.streaming_groupby_reduce(host, month, func="nanmean")[0]},
                     reps=1)

    # -- also at full width: the daily nanmean (B5) and the trio (B2) ------
    day = np.arange(n, dtype=np.int64) // 24
    daily = _drive(ck, "streamed daily nanmean (1096 groups)",
                   lambda: pst.streaming_groupby_reduce(host, day, func="nanmean")[0],
                   {"segment_sum_radixbin": nslabs}, totals)
    fold = _slab_fold(data, day, batch_len, ("nansum", "count"), NDAYS)
    check(torch.equal(bits(daily), bits(_fold_mean(fold))),
          "streamed daily nanmean differs from the slab-order fold")
    _check_close("streamed daily nanmean", daily,
                 _f64_reference(data, torch.from_numpy(day).to(DEVICE), NDAYS, "nanmean"))
    del daily, fold
    trio = ("nanmean", "nanmin", "nanmax")
    got3 = _drive(ck, "streamed aggregate_many(nanmean, nanmin, nanmax)",
                  lambda: pst.streaming_groupby_aggregate_many(host, month, funcs=trio)[0],
                  {"segment_multistat": nslabs}, totals)
    fold = _slab_fold(data, month, batch_len, ("nansum", "count", "nanmin", "nanmax"), NGROUPS)
    check(torch.equal(bits(got3["nanmean"]), bits(_fold_mean(fold)))
          and torch.equal(got3["nanmin"], fold["nanmin"])
          and torch.equal(got3["nanmax"], fold["nanmax"]),
          "streamed trio differs from the slab-order fold")
    check(torch.equal(got3["nanmean"], got), "streamed trio nanmean differs from nanmean's")
    check(torch.equal(got3["nanmax"], _f64_reference(data, codes, NGROUPS, "nanmax")),
          "streamed nanmax differs from scatter_reduce amax")
    print("[stream] streamed daily nanmean and trio: bit for bit their slab-order folds, "
          "within the float64 bar, extrema exact")
    del got3, fold, got
    torch.cuda.empty_cache()

    # -- the cut: quantiles, the scan, the sort engine, a loader, faults ----
    rows = SORT_ROWS
    cut = data[:rows]
    cut_host = host[:rows]
    cut_len = _stream_len(rows)
    cut_slabs = -(-n // cut_len)
    qs = [0.1, 0.5, 0.9]
    q = _drive(ck, f"streamed nanquantile 3 q ({rows} rows, 33 passes)",
               lambda: pst.streaming_groupby_reduce(cut_host, month, func="nanquantile",
                                                    finalize_kwargs={"q": qs})[0],
               {"segment_sum": 32 * cut_slabs}, totals)
    with flox_tpu_torch.set_options(quantile_impl="select"):
        eager_q, _ = flox_tpu_torch.groupby_reduce(cut, month, func="nanquantile",
                                                   finalize_kwargs={"q": qs})
    check(torch.equal(bits(q), bits(eager_q)),
          "streamed nanquantile differs from the eager select path")
    print("[stream] streamed nanquantile: bit for bit the eager select path")
    del q, eager_q

    written = np.full(cut_host.shape, np.nan, dtype=np.float32)

    def writer(s, e, res):
        written[:, s:e] = res

    _drive(ck, f"streamed nancumsum ({rows} rows, host writer)",
           lambda: pst.streaming_groupby_scan(cut_host, month, func="nancumsum", out=writer),
           {"segment_cumsum": cut_slabs, "segment_sum": cut_slabs}, totals)
    eager_scan = flox_tpu_torch.groupby_scan(cut, month, func="nancumsum")
    _check_scan_full("streamed nancumsum", torch.from_numpy(written).to(DEVICE), cut, codes,
                     want=eager_scan)
    del written, eager_scan
    torch.cuda.empty_cache()

    labels = DAY0 + day
    universe = np.arange(NUNIVERSE)
    # day-aligned slabs: no day straddles two slabs, so every group's sum is
    # one slab's, as the eager call's is one pass's
    day_len = (cut_len // 24) * 24
    sorted_ = _drive(ck, f"streamed sort engine nanmean ({rows} rows, {NUNIVERSE}-day universe)",
                     lambda: pst.streaming_groupby_reduce(
                         cut_host, labels, func="nanmean", expected_groups=universe,
                         engine="sort", batch_len=day_len)[0],
                     {"segment_sum_radixbin": -(-n // day_len)}, totals)
    eager_sort, _ = flox_tpu_torch.groupby_reduce(cut, labels, func="nanmean",
                                                  expected_groups=universe, engine="sort")
    check(torch.equal(bits(sorted_), bits(eager_sort)),
          "streamed sort engine differs from the eager sort engine")
    print(f"[stream] streamed sort engine (slabs of {day_len} columns, whole days): bit for bit "
          "the eager sort engine")
    del sorted_, eager_sort

    def loader(s, e):
        return cut_host[:, s:e]

    by_loader = _drive(ck, f"streamed nanmean from a loader ({rows} rows)",
                       lambda: pst.streaming_groupby_reduce(loader, month, func="nanmean")[0],
                       {"segment_sum": cut_slabs}, totals)
    base = pst.streaming_groupby_reduce(cut_host, month, func="nanmean")[0]
    check(torch.equal(bits(by_loader), bits(base)), "the loader form differs from the host array")
    print("[stream] loader callable(start, stop): bit for bit the host-array form")
    ref = _f64_reference(cut, codes, NGROUPS, "nanmean")

    with faults.inject(oom_at=[cut_len]) as plan:
        with profiling.stream_monitor() as reps:
            split = pst.streaming_groupby_reduce(cut_host, month, func="nanmean")[0]
    check(reps[0].oom_splits == 1 and ("SimulatedOOM", cut_len, 2 * cut_len) in plan.log,
          f"simulated OOM: {reps[0].oom_splits} splits, log {plan.log}")
    _check_close("streamed nanmean, a simulated OOM halved", split, ref)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total_mem = torch.cuda.get_device_properties(0).total_memory
    reserved = torch.cuda.memory_reserved()
    room = 0.45e9  # a 0.86 GB slab and its 0.54 GB half do not fit, a quarter does
    try:
        torch.cuda.set_per_process_memory_fraction((reserved + room) / total_mem)
        with profiling.stream_monitor() as reps:
            capped = pst.streaming_groupby_reduce(cut_host, month, func="nanmean",
                                                  batch_bytes=2 * 2**30)[0]
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    widths = sorted({s.stop - s.start for s in reps[0].slabs})
    check(reps[0].oom_splits >= 1, "real OOM: the ladder never split")
    _check_close("streamed nanmean under a memory cap", capped, ref)
    out["real_oom_splits"] = reps[0].oom_splits
    print(f"[stream] real torch.cuda.OutOfMemoryError under a cap of {room / 1e9:.2f} GB above "
          f"the {reserved / 1e9:.2f} GB reserved: {reps[0].oom_splits} halvings of a 2 GiB "
          f"request; counters {reps[0].counters}")
    del capped, split, widths

    with flox_tpu_torch.set_options(stream_checkpoint_every=1):
        with faults.inject(kill_at=[2 * cut_len]):
            try:
                pst.streaming_groupby_reduce(cut_host, month, func="nanmean")
            except faults.StreamKilled:
                pass
            else:
                check(False, "the stream was not killed")
        with profiling.stream_monitor() as reps:
            resumed = pst.streaming_groupby_reduce(cut_host, month, func="nanmean")[0]
    check(reps[0].counters.resumed_at == 2, f"resumed at {reps[0].counters.resumed_at}")
    check(torch.equal(bits(resumed), bits(base)), "the resumed stream differs")
    print("[stream] StreamKilled at slab 2 with stream_checkpoint_every=1: the resumed stream "
          "is bit for bit the uninterrupted one")
    del resumed, base, by_loader, ref, host
    torch.cuda.empty_cache()
    print(f"[stream] launches so far {totals}")
    return out


def phase_mesh_all(data, month, totals: dict, seed: int, reps: int) -> None:
    """:func:`phase_mesh` and :func:`phase_mesh_ranks` inside a world of one
    rank, torn down after them."""
    import shutil
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    _world_of_one(tmp)
    try:
        phase_mesh(data, month, totals, reps)
        torch.cuda.empty_cache()
        phase_mesh_ranks(seed)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[mesh] the multi-device phases: {time.perf_counter() - t0:.1f} s")


# -- two gloo ranks sharing the card ----------------------------------------


def make_cut(seed: int, rows: int, ntime: int) -> np.ndarray:
    """The two-rank phase's (rows, ntime) float32 data, made on the host from
    ``seed``, so that each rank moves only its own columns to the card."""
    return np.random.default_rng(seed).standard_normal((rows, ntime), dtype=np.float32)


def _rms_aggregation():
    """A custom Aggregation: root mean square by two callable legs, summed
    over the shards by callable combines."""
    from flox_tpu_torch import Aggregation
    from flox_tpu_torch.kernels import generic_kernel

    def sq_sum(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return generic_kernel("nansum", group_idx, array * array, size=size, fill_value=0.0)

    def cnt(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return generic_kernel("nanlen", group_idx, array, size=size)

    return Aggregation("rms", numpy=(sq_sum, cnt), chunk=(sq_sum, cnt),
                       combine=(lambda s: s.sum(0), lambda s: s.sum(0)),
                       finalize=lambda ss, n, **kw: (ss / n) ** 0.5,
                       fill_value={"intermediate": (0.0, 0)}, final_fill_value=np.nan)


def _rank_calls(cut: np.ndarray, seed: int, mesh, nranks: int) -> list:
    """The mesh calls of ``__graft_entry__.dryrun_multichip`` without its
    streaming ones, on the cut: ``(name, call, bar)``, where bar is "exact",
    "sum" (float32 sums and divisions: 1e-6 + 1e-5 |ref|) or "scan". The
    blocked call lowers the dense-intermediate ceiling so that its 100,000
    groups block over ``nranks`` ranks; a world of one runs it dense."""
    import flox_tpu_torch as ft

    rows, n = cut.shape
    month = month_labels(n)
    per = -(-n // 2)
    local = np.arange(n) // per  # shard-local groups over two shards
    interleaved = 2 * ((np.arange(n) % per) % 6) + local  # shard s: codes s, s+2, ...
    rng = np.random.default_rng(seed + 2)
    td = rng.integers(1, 10**6, (64, n)).astype("timedelta64[ns]")
    td[rng.random((64, n)) < 0.05] = np.timedelta64("NaT")
    wide = rng.integers(0, 100_000, n)
    few = cut[:256]
    # 256 rows x 100,000 groups: the dense estimate (counts, sums, counts)
    # is 3 x 102.4 MB; the blocked peak over two ranks 102.4 + 153.6 MB
    ceiling = 280_000_000 if nranks > 1 else None
    qs = {"q": (0.1, 0.5, 0.9)}

    def red(arr, labels, func, method, **kw):
        return lambda: ft.groupby_reduce(arr, labels, func=func, method=method, mesh=mesh, **kw)

    def with_options(fn, **opts):
        def call():
            with ft.set_options(**opts):
                return fn()
        return call

    return [
        ("map-reduce nanmean", red(cut, month, "nanmean", "map-reduce"), "sum"),
        ("cohorts nanvar", red(cut, month, "nanvar", "cohorts"), "sum"),
        ("map-reduce nanargmax", red(cut, month, "nanargmax", "map-reduce"), "exact"),
        ("Blelloch cumsum", lambda: ft.groupby_scan(cut, month, func="cumsum",
                                                    method="blelloch", mesh=mesh), "scan"),
        ("Blelloch timedelta cumsum with NaT",
         lambda: ft.groupby_scan(td, month, func="cumsum", method="blelloch", mesh=mesh),
         "exact"),
        ("blockwise nanmedian, shard-local codes (select)",
         with_options(red(cut, local, "nanmedian", "blockwise"), quantile_impl="select"),
         "exact"),
        ("blockwise cumsum, shard-local codes",
         lambda: ft.groupby_scan(cut, local, func="cumsum", method="blockwise", mesh=mesh),
         "exact"),
        ("cohort-aligned nansum, interleaved codes",
         red(cut, interleaved, "nansum", "cohorts"), "sum"),
        ("custom rms Aggregation", red(cut, month, _rms_aggregation(), "map-reduce"), "sum"),
        ("blocked nanmean, 100,000 groups (256 rows)",
         with_options(red(few, wide, "nanmean", "map-reduce",
                          expected_groups=np.arange(100_000)),
                      **({"dense_intermediate_bytes_max": ceiling} if ceiling else {})),
         "sum"),
        ("map-reduce nanmedian (select)", red(cut, month, "nanmedian", "map-reduce"), "exact"),
        ("map-reduce nanquantile q=(0.1, 0.5, 0.9) (select)",
         red(cut, month, "nanquantile", "map-reduce", finalize_kwargs=qs), "exact"),
    ]


def _to_host(out):
    out = _result(out)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out


def _run_rank_calls(ck, cut, seed, mesh, nranks) -> dict:
    """Every call of :func:`_rank_calls`: ``{name: (host result, launches,
    ms)}``."""
    out = {}
    for name, fn, _bar in _rank_calls(cut, seed, mesh, nranks):
        ck.reset_launches()
        got, ms = _once_ms(fn) if DEVICE == "cuda" else (fn(), 0.0)
        out[name] = (_to_host(got), {kk: v for kk, v in ck.LAUNCHES.items() if v}, ms)
        del got
    return out


def _agree(name: str, bar: str, got, want, cut) -> str:
    """``got`` (a rank's result) against ``want`` (the world of one's) to
    ``bar``; returns a line for the log, raises on disagreement."""
    if bar == "exact" or got.dtype.kind not in "f":
        check(got.dtype == want.dtype and got.shape == want.shape
              and np.array_equal(got.view(f"int{8 * got.itemsize}"),
                                 want.view(f"int{8 * want.itemsize}")),
              f"{name}: differs from the world of one")
        return f"{name}: bit-identical"
    check(got.dtype == want.dtype and got.shape == want.shape, f"{name}: {got.dtype} {got.shape}")
    g, w = got.astype(np.float64), want.astype(np.float64)
    err = np.abs(g - w)
    check(bool(np.array_equal(np.isnan(g), np.isnan(w))), f"{name}: NaN positions differ")
    err = np.where(np.isnan(w), 0.0, err)
    if bar == "sum":
        tol = 1e-6 + 1e-5 * np.abs(np.nan_to_num(w))
    else:  # scan: n_g u cumsum|x| of each group, plus one ulp
        codes = month_labels(cut.shape[-1])
        scale = np.zeros_like(g)
        for grp in range(NGROUPS):
            cols = np.flatnonzero(codes == grp)
            scale[:, cols] = cols.size * U32 * np.cumsum(np.abs(cut[:, cols].astype(np.float64)),
                                                         axis=1)
        tol = scale + np.abs(w) * 2.0**-23
    check(bool((err <= tol).all()), f"{name}: max err {err.max()!r} past its bar")
    return f"{name}: max |err| {err.max()!r} within the {bar} bar"


def _mesh_rank(rank: int, world: int, init_file: str, out_dir: str, seed: int, rows: int,
               ntime: int, device: str, timeout_s: float) -> None:
    """One gloo rank of the two-rank phase: makes the cut from ``seed``, runs
    the calls, and holds each result against the world of one's."""
    import json as json_
    import pickle
    import traceback
    from datetime import timedelta

    global DEVICE
    DEVICE = device
    torch.set_num_threads(1)
    report = {"rank": rank, "ok": False, "lines": []}
    try:
        import torch.distributed as dist

        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
        from flox_tpu_torch import cuda_kernels as ck
        from flox_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device_type=device)
        cut = make_cut(seed, rows, ntime)
        with open(os.path.join(out_dir, "one.pkl"), "rb") as f:
            one = pickle.load(f)
        got = _run_rank_calls(ck, cut, seed, mesh, world)
        for name, _fn, bar in _rank_calls(cut, seed, mesh, world):
            res, launches, ms = got[name]
            check(launches == one[name][1],
                  f"{name}: launches {launches}, the world of one's {one[name][1]}")
            line = _agree(name, bar, res, one[name][0], cut)
            report["lines"].append(f"{line}; launches {launches}; {ms!r} ms")
        dist.destroy_process_group()
        report["ok"] = True
    except Exception:  # noqa: BLE001 - the parent fails the phase with it
        report["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json_.dump(report, f)


def phase_mesh_ranks(seed: int, rows: int = MESH_ROWS) -> None:
    """The mesh calls on a gloo world of two spawned ranks that share the
    card (NCCL refuses two ranks on one device), on the data cut to ``rows``
    rows: each rank's results against the world of one's on the same cut,
    which this process computes first on its own one-rank mesh. The phase
    has a deadline; any rank's failure fails it."""
    import pickle
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from flox_tpu_torch import cuda_kernels as ck
    from flox_tpu_torch.parallel import make_mesh

    cut = make_cut(seed, rows, NTIME)
    one = _run_rank_calls(ck, cut, seed, make_mesh(device_type=DEVICE), 1)
    del cut
    torch.cuda.empty_cache()
    for name, (_res, launches, ms) in one.items():
        print(f"[ranks] world of one, {name}: launches {launches}, {ms!r} ms")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        with open(os.path.join(tmp, "one.pkl"), "wb") as f:
            pickle.dump(one, f)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank, args=(r, 2, os.path.join(tmp, "init"), tmp, seed,
                                                     rows, NTIME, DEVICE, 120.0))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        end = time.monotonic() + MESH_DEADLINE_S
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        check(not hung, f"ranks {hung} missed the {MESH_DEADLINE_S} s deadline")
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.json")
            check(os.path.exists(path), f"rank {r} exited with code {p.exitcode} and no report")
            with open(path) as f:
                report = json.load(f)
            check(report["ok"], f"rank {r} failed:\n{report.get('error')}")
            for line in report["lines"]:
                print(f"[ranks] rank {r}: {line}")
        print(f"[ranks] two gloo ranks on one card, {rows} rows: every call agrees with the "
              f"world of one ({time.perf_counter() - t0:.1f} s from spawn to exit)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- NCCL ranks, one card each (python3 chip_smoke.py --mesh-cards 4) ---------


def _card_calls(data, month, mesh, mesh2, nranks: int) -> list:
    """The mesh calls of the multi-card phase at full width: ``(name, mesh
    call, eager call, bar, options)``; bar as :func:`_agree_card`'s.
    Blockwise runs on codes that put one group on each shard."""
    import flox_tpu_torch as ft

    n = data.shape[-1]
    day = np.arange(n, dtype=np.int64) // 24
    local = np.arange(n) // -(-n // nranks)
    qs = {"q": (0.1, 0.5, 0.9)}
    trio = ("nanmean", "nanmin", "nanmax")
    select = {"quantile_impl": "select"}

    def red(func, method, labels=month, m=mesh, **kw):
        return (lambda: ft.groupby_reduce(data, labels, func=func, method=method, mesh=m, **kw),
                lambda: ft.groupby_reduce(data, labels, func=func, device=DEVICE,
                                          **{k: v for k, v in kw.items() if k != "axis_name"}))

    return [
        ("map-reduce nanmean", *red("nanmean", "map-reduce"), "mean", {}),
        ("cohorts nanvar (ddof=1)", *red("nanvar", "cohorts", finalize_kwargs={"ddof": 1}),
         "mean", {}),
        ("map-reduce nanargmax", *red("nanargmax", "map-reduce"), "exact", {}),
        ("Blelloch nancumsum",
         lambda: ft.groupby_scan(data, month, func="nancumsum", method="blelloch", mesh=mesh),
         lambda: ft.groupby_scan(data, month, func="nancumsum", device=DEVICE), "scan", {}),
        ("blockwise nanmedian, shard-local codes (select)",
         *red("nanmedian", "blockwise", labels=local), "exact", select),
        ("map-reduce nanquantile q=(0.1, 0.5, 0.9) (select)",
         *red("nanquantile", "map-reduce", finalize_kwargs=qs), "exact", select),
        ("cohorts nansum", *red("nansum", "cohorts"), "sum", {}),
        ("map-reduce aggregate_many(nanmean, nanmin, nanmax)",
         lambda: ft.groupby_aggregate_many(data, month, funcs=trio, method="map-reduce",
                                           mesh=mesh),
         lambda: ft.groupby_aggregate_many(data, month, funcs=trio, device=DEVICE), "mean", {}),
        ("map-reduce daily nanmean (1096 groups)", *red("nanmean", "map-reduce", labels=day),
         "mean", {}),
        ("map-reduce nanmean over (dcn, ici)",
         *red("nanmean", "map-reduce", m=mesh2, axis_name=("dcn", "ici")), "mean", {}),
    ]


def _agree_card(name: str, bar: str, got, want, data, month) -> str:
    """A multi-card result against the one-card eager call: "exact" bit for
    bit; "mean" within 1e-6 + 1e-5 |ref| (float32 sums of other partial
    orders, then divided); "sum" within the plain segment-sum bar of the
    group's |x| sum; "scan" within ``n_g u cumsum|x|`` plus one ulp."""
    if isinstance(want, dict):
        return "; ".join(_agree_card(f"{name}[{k}]", "exact" if k in ("nanmin", "nanmax")
                                     else bar, got[k], want[k], data, month) for k in want)
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: {got.shape} {got.dtype}")
    if bar == "exact":
        check(same(got, want), f"{name}: differs from the one-card call")
        return f"{name}: bit-identical"
    codes = torch.from_numpy(month).to(data.device)
    if bar == "scan":
        return f"{name}: max |err| {_check_scan_full(name, got, data, codes, want=want)!r}"
    err = (got.double() - want.double()).abs()
    if bar == "sum":
        tol = _sum_bar("plain", data.shape[-1], abs_sums(data, codes, NGROUPS).T, want)
    else:
        tol = 1e-6 + 1e-5 * want.double().abs()
    check(bool((err <= tol).all()), f"{name}: max err {err.max().item()!r} past its bar")
    return f"{name}: max |err| {err.max().item()!r} within the {bar} bar"


def _mesh_card(rank: int, world: int, init_file: str, out_dir: str, seed: int, reps: int,
               timeout_s: float, device: str, shape: tuple) -> None:
    """One NCCL rank of the multi-card phase, on card ``rank``: makes the
    ``shape`` data on its card from ``seed``, runs each mesh call (timed;
    the select calls once), and on rank 0 holds it against the one-card
    eager call and times that too. ``device="cpu"`` (gloo, untimed)
    rehearses it."""
    import traceback
    from datetime import timedelta

    global DEVICE, NLAT, NLON, NTIME
    DEVICE, (NLAT, NLON, NTIME) = device, (shape[0], 1, shape[1])
    torch.set_num_threads(1)
    report = {"rank": rank, "ok": False, "lines": []}
    try:
        import flox_tpu_torch
        import torch.distributed as dist
        from flox_tpu_torch import cuda_kernels as ck
        from flox_tpu_torch.parallel import make_mesh

        on_card = device == "cuda"
        if on_card:
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if on_card else "gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s))
        once = _once_ms if on_card else (lambda fn: (fn(), 0.0))
        mesh = make_mesh(device_type=device)
        mesh2 = make_mesh(shape=(2, world // 2), axis_names=("dcn", "ici"), device_type=device)
        data = make_data(seed)
        month = month_labels(data.shape[-1])
        for name, mesh_fn, eager_fn, bar, opts in _card_calls(data, month, mesh, mesh2, world):
            with flox_tpu_torch.set_options(**opts):
                ck.reset_launches()
                got, ms = once(mesh_fn)
                launches = {kk: v for kk, v in ck.LAUNCHES.items() if v}
                if not opts and on_card:
                    ms = time_ms(mesh_fn, reps)
                line = f"{name}: {ms!r} ms on {world} cards, launches {launches}"
                if rank == 0:
                    want, eager_ms = once(eager_fn)
                    if not opts and on_card:
                        eager_ms = time_ms(eager_fn, reps)
                    line += (f", one card {eager_ms!r} ms; "
                             + _agree_card(name, bar, _result(got), _result(want), data, month))
                    del want
                del got
                torch.cuda.empty_cache()
            report["lines"].append(line)
        report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        dist.destroy_process_group()
        report["ok"] = True
    except Exception:  # noqa: BLE001 - the parent fails the phase with it
        report["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"card{rank}.json"), "w") as f:
        json.dump(report, f)


def phase_mesh_cards(seed: int, ncards: int, reps: int, device: str = "cuda") -> None:
    """The mesh calls at full width on ``ncards`` NCCL ranks, one card each
    (each makes the data on its card and reduces its columns), against one
    card's eager calls. The phase has a deadline; any rank's failure fails
    it."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    check(device != "cuda" or torch.cuda.device_count() >= ncards,
          f"--mesh-cards {ncards} needs {ncards} cards; {torch.cuda.device_count()} found")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_card, args=(r, ncards, os.path.join(tmp, "init"), tmp,
                                                     seed, reps, 300.0, device,
                                                     (NLAT * NLON, NTIME)))
                 for r in range(ncards)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        end = time.monotonic() + MESH_DEADLINE_S
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        check(not hung, f"ranks {hung} missed the {MESH_DEADLINE_S} s deadline")
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"card{r}.json")
            check(os.path.exists(path), f"rank {r} exited with code {p.exitcode} and no report")
            with open(path) as f:
                report = json.load(f)
            check(report["ok"], f"rank {r} failed:\n{report.get('error')}")
            if r == 0:
                for line in report["lines"]:
                    print(f"[cards] {line}")
            print(f"[cards] rank {r}: peak device memory {report['peak_gb']:.2f} GB")
        print(f"[cards] {ncards} NCCL ranks, one card each: every call agrees with one card "
              f"({time.perf_counter() - t0:.1f} s from spawn to exit)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def phase_times(data, month, codes, reps: int, launches: dict, seed: int = 0) -> list[dict]:
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
        "nanmax": lambda: flox_tpu_torch.groupby_reduce(data, month, func="nanmax"),
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
    family = _family_calls(data, month, seed)
    # one timed run after the warm-up (the select quantile alone takes 3.7 s)
    # and two traced ones keep the script near its time with the mesh phases
    _family_times(ck, family, 1)
    labels = label_times(ck, data, month, seed, max(3, reps // 2))
    device_breakdown({**wrapper_calls(data), **{name: calls[name] for name in list(calls)[:6]},
                      **family, **labels}, reps=2)
    del family, labels
    torch.cuda.empty_cache()
    cut = data[:SORT_ROWS]
    e2e_ms = time_ms(lambda: flox_tpu_torch.groupby_reduce(
        cut, DAY0 + day, func="nanmean", expected_groups=np.arange(NUNIVERSE), engine="sort"),
        max(3, reps // 2))
    gbps = cut.numel() * cut.element_size() / (e2e_ms * 1e-3) / 1e9
    print(f"[times] end-to-end sort engine nanmean ({SORT_ROWS} rows, {NUNIVERSE}-day universe, "
          f"host scatter included): {e2e_ms!r} ms, {gbps!r} GB/s of input")
    _sort_breakdown(cut, day)
    return entries


# B1-B3 are instances of segment_reduce_kernel; segment_minmax_kernel is B3's
# symbol before it was one, so that the profile of an earlier checkout
# (see pattern_times) counts it too
_OUR_KERNELS = ("segment_reduce_kernel", "segment_minmax_kernel", "segment_cumsum_kernel",
                "radixbin_kernel")


def wrapper_calls(data) -> dict:
    """The kernel wrappers at the main path's month codes, as
    :func:`device_breakdown` takes them: B1 and B2 kahan, B3 max (nanmax's
    call) and B4 nancumsum. Only the wrappers' Python signatures, which the
    kernels' earlier designs share, so that it also profiles an earlier
    checkout (see :func:`pattern_times`)."""
    from flox_tpu_torch import cuda_kernels as ck

    codes = torch.from_numpy(month_labels(data.shape[1])).to(DEVICE).to(torch.int32)
    return {
        "segment_sum_raw kahan": lambda: ck.segment_sum_raw(data, codes, NGROUPS, "kahan"),
        "segment_multistat kahan": lambda: ck.segment_multistat(data, codes, NGROUPS, "kahan"),
        "segment_minmax max": lambda: ck.segment_minmax(data, codes, NGROUPS, "max"),
        "segment_cumsum nancumsum": lambda: ck.segment_cumsum(data, codes, NGROUPS, True),
    }


def device_breakdown(calls: dict, reps: int = 3) -> None:
    """Where each call's time goes, from a ``torch.profiler`` trace of
    ``reps`` calls after a warm-up: the host-clock wall time per call (the
    calls end in a synchronize), the device's busy time (all kernels and
    copies), the share of it in this repo's kernels, and the idle share,
    1 - busy / wall. Where the other device ops take more than 1 ms a call,
    the three that take most, by kernel name. Tracing adds a few
    microseconds per launch to the wall time. Prints "not measured" when the
    trace holds no device time."""
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
        # a ``record_function`` range (the streaming runtime's ``timed``) is
        # mirrored on the device's timeline as an annotation: not device work
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
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
        if busy - ours > 1.0:
            by_name: dict = {}
            mine_ids = {id(e) for e in mine}
            for e in events:
                if id(e) not in mine_ids:
                    by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
            print(f"[profile]   {name}, other ops taking most: " + "; ".join(
                f"{us / 1e3 / reps:.3f} ms {op[:70]}" for op, us in top))
        torch.cuda.empty_cache()


def pattern_times(data, reps: int) -> dict:
    """B1 and B2 (kahan), B3 (max) and B4 (nancumsum) on code patterns off
    the main path, at the width of ``data``: hour of day (``arange(N) % 24``,
    24 groups, runs of one column), random codes over 12 groups, and random
    codes over 512 for B1 and B3 (B1-B3 take at most 512 groups, B4 at most
    511; B2 walks as B1 does, so B1 stands for it there). Each output
    is first held against the plain version (markers exact, sums at B1's
    kahan bar, extrema exact, running sums within ``n_g u cumsum|x|`` plus
    one ulp). Uses only the wrappers' Python signatures, which the kernels'
    earlier designs share, so it also times a checkout of an earlier commit:
    ``python3 -c "import chip_smoke as c; d = c.make_data(0);
    c.pattern_times(d, 10); c.device_breakdown(c.wrapper_calls(d))"``
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
        got = ck.segment_minmax(data, codes, size, "max")
        check(same(got, ck.segment_minmax_plain(data, codes, size, "max")),
              f"segment_minmax, {name}: differs from the plain version")
        del got
        ms = time_ms(lambda c=codes, sz=size: ck.segment_minmax(data, c, sz, "max"),
                     max(2, reps // 2))
        bound = (data.numel() * data.element_size() + n * 4 + size * k * 4) / HBM_BYTES_PER_S * 1e3
        times[f"segment_minmax, {name}"] = ms
        print(f"[times] segment_minmax max, {name}: {ms!r} ms (bound {bound!r} ms), exact")
        torch.cuda.empty_cache()
        if size + 1 > 512:
            continue
        got = ck.segment_cumsum(data, codes, size, True)
        want = ck.segment_cumsum_plain(data, codes, size, True)
        err = _check_scan_full(f"segment_cumsum, {name}", got, data, codes, want=want,
                               groups=size)
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda c=codes, sz=size: ck.segment_cumsum(data, c, sz, True),
                     max(2, reps // 2))
        torch.cuda.empty_cache()
        bound = (2 * data.numel() * data.element_size() + n * 4) / HBM_BYTES_PER_S * 1e3
        times[f"segment_cumsum, {name}"] = ms
        print(f"[times] segment_cumsum nancumsum, {name}: {ms!r} ms (bound {bound!r} ms), max "
              f"|kernel - plain| {err!r}")
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
    parser.add_argument("--mesh-cards", type=int, default=0,
                        help="run only the multi-card mesh phase on this many cards")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import flox_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    if args.mesh_cards:
        phase_mesh_cards(args.seed, args.mesh_cards, max(3, args.reps // 2))
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
        print(f"[total] {time.perf_counter() - t0:.1f} s")
        return 0
    phase_kernels(args.seed)
    data, month, codes, launches, _scan_err = phase_main_path(args.seed)
    phase_streaming(data, month, codes, launches)
    phase_mesh_all(data, month, launches, args.seed, max(3, args.reps // 2))
    entries = phase_times(data, month, codes, args.reps, launches, args.seed)
    print(f"[memory] peak device memory "
          f"{max(_PEAK_SEEN[0], torch.cuda.max_memory_allocated()) / 1e9:.2f} GB")
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
