#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (flox_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--reps 10]

Phases; any failure exits nonzero:

1. build the CUDA kernels from flox_tpu_torch/csrc with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch version on the card: the
   segment-sum kernel over {plain, kahan, dd} x {float32, bfloat16} x
   size {1, 12, 512} with NaN, +-inf and out-of-range codes, plus the
   reference's Kahan and double-double accuracy bars and run-to-run bit
   identity; the segment-min/max kernel over {min, max} x {float32,
   bfloat16, int32} x size {1, 12, 128}, exactly;
3. drive the main path, ``groupby_reduce(data, month, func="nanmean")``, on
   (lat*lon, time) = (65160, 26304) float32 data made on the card from
   ``--seed`` with the month labels of the repo's benchmark (12 groups), then
   ``nanmax`` and ``var`` on the same data; count the kernel launches of each
   call and check each result against a float64 (or exact) reduction of the
   same rows on the card;
4. time, with CUDA events (median of ``--reps`` runs after a warm-up), each
   kernel at the main path's shapes against its bound, its plain version,
   one library call for the same sums / maxima, and the end-to-end nanmean.

It then prints the card's name and power limit, one JSON line of the kernels,
and, last, ``{"ok": true, "device": {...}}``. Without CUDA it exits nonzero
before printing any result.
"""

from __future__ import annotations

import argparse
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
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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
            if "registers" in line or "spill" in line:
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
    k, n = 37, 4099  # odd shapes: ragged chunks and blocks
    for size in (1, 12, 512):
        for dtype in (torch.float32, torch.bfloat16):
            data, codes = _sum_case(gen, k, n, size, dtype)
            scale = abs_sums(data, codes, size)
            oracle = ck.segment_sum_raw_plain(data, codes, size, "dd")[0]  # f64-accumulated
            for accum in ("plain", "kahan", "dd"):
                got = ck.segment_sum_raw(data, codes, size, accum)
                again = ck.segment_sum_raw(data, codes, size, accum)
                want = ck.segment_sum_raw_plain(data, codes, size, accum)
                torch.cuda.synchronize()
                tag = f"segment_sum size={size} {dtype} {accum}"
                check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)),
                      f"{tag}: two launches differ")
                for i, name in ((1, "nan"), (2, "+inf"), (3, "-inf")):
                    check(torch.equal(got[i], want[i]), f"{tag}: {name} counts differ")
                err = (got[0].double() - want[0].double()).abs()
                ulp = torch.abs(want[0]).double() * 2 * U32
                chunks = -(-n // 32)
                if accum == "plain":
                    # kernel <= (chunks + 5) u S, plain version <= (n - 1) u S
                    tol = (n + chunks + 5) * U32 * scale
                    own = (got[0].double() - oracle.double()).abs()
                    check(bool((own <= (chunks + 5) * U32 * scale + ulp).all()),
                          f"{tag}: off the float64 sum by {own.max().item()}")
                else:
                    # chunk tree <= 5 u S, compensated carry <= 2 u |s|, final rounding
                    tol = 8 * U32 * scale + ulp
                check(bool((err <= tol).all()), f"{tag}: max |kernel - plain| {err.max().item()}")
                worst["segment_sum"] = max(worst["segment_sum"], err.max().item())
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
    print(f"[kernels] all sweeps agree; max |segment_sum - plain| {worst['segment_sum']!r}")
    return worst


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
    """float64 (var, nanmean) or exact (nanmax) per-group reduction of
    ``data`` (K, N), in row blocks to bound memory."""
    idx = codes.long()
    out = []
    cnt = torch.bincount(idx, minlength=size).double()
    for r0 in range(0, data.shape[0], block):
        x = data[r0 : r0 + block]
        if func == "nanmax":
            o = torch.full((x.shape[0], size), float("-inf"), device=x.device)
            out.append(o.scatter_reduce_(1, idx.expand_as(x), x, "amax", include_self=True))
            continue
        x = x.double()
        s = torch.zeros((x.shape[0], size), dtype=torch.float64, device=x.device)
        mean = s.index_add_(1, idx, x) / cnt
        if func == "nanmean":
            out.append(mean)
            continue
        dev = x - mean.index_select(1, idx)
        m2 = torch.zeros_like(s).index_add_(1, idx, dev * dev)
        out.append(m2 / cnt)
    return torch.cat(out)


def phase_main_path(seed: int):
    import flox_tpu_torch
    from flox_tpu_torch import cuda_kernels as ck

    k, n = NLAT * NLON, NTIME
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    data = torch.randn((k, n), generator=gen, device=DEVICE, dtype=torch.float32)
    month = month_labels(n)
    codes = torch.from_numpy(month).to(DEVICE)
    print(f"[main] data {tuple(data.shape)} float32, {data.numel() * 4 / 1e9:.2f} GB, "
          f"{NGROUPS} groups")

    ck.reset_launches()  # the main path's run: nanmean, then nanmax, then var
    per_call = {}
    results = {}
    for func in ("nanmean", "nanmax", "var"):
        before = dict(ck.LAUNCHES)
        out, groups = flox_tpu_torch.groupby_reduce(data, month, func=func)
        torch.cuda.synchronize()
        per_call[func] = {kk: ck.LAUNCHES[kk] - before[kk] for kk in ck.LAUNCHES}
        check(tuple(out.shape) == (k, NGROUPS) and out.dtype == torch.float32,
              f"{func}: result {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{func}: non-finite values in the result")
        check(np.array_equal(groups, np.arange(NGROUPS)), f"{func}: groups {groups}")
        results[func] = out
    launches = dict(ck.LAUNCHES)
    print(f"[main] launches per call {per_call}; whole run {launches}")
    check(per_call["nanmean"] == {"segment_sum": 1, "segment_minmax": 0},
          "nanmean must be one segment-sum launch (the fused path)")
    check(per_call["nanmax"] == {"segment_sum": 0, "segment_minmax": 1},
          "nanmax must be one segment-min/max launch")
    check(per_call["var"] == {"segment_sum": 2, "segment_minmax": 0},
          "var must be two segment-sum launches")

    for func, out in results.items():
        ref = _f64_reference(data, codes, NGROUPS, func)
        if func == "nanmax":
            check(torch.equal(out, ref), "nanmax differs from scatter_reduce amax")
            print("[main] nanmax: exact")
        else:
            err = (out.double() - ref).abs()
            tol = 1e-6 + 1e-5 * ref.abs()  # float32 sums and division
            check(bool((err <= tol).all()), f"{func}: max err {err.max().item()}")
            print(f"[main] {func}: max |err| vs float64 {err.max().item()!r}")
        del ref
    del results
    torch.cuda.empty_cache()
    return data, month, codes, launches


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
    check(bool((err <= 8 * U32 * scale + want[0].double().abs() * 2 * U32).all()),
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

    e2e_ms = time_ms(lambda: flox_tpu_torch.groupby_reduce(data, month, func="nanmean"),
                     max(3, reps // 2))
    gbps = data.numel() * data.element_size() / (e2e_ms * 1e-3) / 1e9
    print(f"[times] end-to-end nanmean: {e2e_ms!r} ms, {gbps!r} GB/s")
    return entries


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
    data, month, codes, launches = phase_main_path(args.seed)
    entries = phase_times(data, month, codes, args.reps, launches)
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
