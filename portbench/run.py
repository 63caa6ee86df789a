"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. A cell on several cards spawns one process a
card (NCCL, file-based rendezvous under ``TMPDIR``); rank 0 is this process
and prints the line. Without as many CUDA cards as the cell asks for, it
exits with code 2 and prints no result; so it does, with code 3, where any
rank has loaded JAX or the JAX package, and with code 4 where a traced slice
could not be read. With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # noqa: E402 - the process's start, as near as Python reads it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flox_tpu")  # top-level module names


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def card_power_limits(count: int) -> list[str]:
    """``power.limit`` of the first ``count`` cards, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()][:count]


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


def rank_run(spec, args: dict, device: str, nrows: int | None, hook, t_start: float,
             rank: int = 0, world: int = 1, init_file: str | None = None) -> dict | None:
    """Set-up, window, trace and reference on one rank; rank 0 returns the
    result. ``device="cpu"`` (gloo between ranks) runs the same path on the
    CPU at a small ``nrows``, for the tests."""
    import torch

    from . import cellrun, devtrace, tracemath
    from .world import joined

    t_imports = time.perf_counter()
    with joined(device, rank, world, init_file) as (dist, dev):
        marks = {"imports": t_imports}
        if dev.type == "cuda":
            torch.zeros(1, device=dev)  # the CUDA context
        marks["context"] = time.perf_counter()
        import flox_tpu_torch
        from flox_tpu_torch import _build

        marks["program"] = time.perf_counter()

        if hook is not None:
            hook()
        builds0 = dict(_build.BUILDS)
        if device == "cuda":
            _build.load_all()
        marks["kernels"] = time.perf_counter()
        mesh = None
        if world > 1:
            from flox_tpu_torch.parallel import make_mesh

            mesh = make_mesh(device_type=dev.type)
        cell = cellrun.Cell(spec, args["workload"], args["seed"], dev, rank, world, nrows)
        cell.make_data(mesh)
        cell.sync()
        marks["data"] = time.perf_counter()
        warm = [cell.timed_call() for _ in range(2)]
        marks["warm"] = time.perf_counter()
        warm_s = warm[-1][2] - warm[-1][1]
        del warm
        if dist is not None:
            t = torch.tensor([warm_s], dtype=torch.float64, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            warm_s = float(t.item())
        seconds = float(args["seconds"])
        trace = bool(args["trace"])
        plan = None
        if trace:
            flox_tpu_torch.set_options(telemetry=True)
            plan = cellrun.slice_plan(warm_s, max(1, math.ceil(seconds / warm_s)))
        agree = None
        if dist is not None:
            # rank 0's clock ends the window, over a host (gloo) group so that
            # the device trace holds the program's ops alone
            host_group = dist.new_group(backend="gloo")

            def agree(more: int) -> int:
                t = torch.tensor([more], dtype=torch.int64)
                dist.broadcast(t, src=0, group=host_group)
                return int(t.item())
        window = cellrun.Window(cell, seconds, plan, agree, max(1, math.ceil(seconds / warm_s)))
        if dist is not None:
            dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        at, setup_parts = t_start, {}
        for k, t in marks.items():
            setup_parts[k], at = t - at, t
        window.run()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        peaks = spec.peaks(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
        summary = window.trace(tracemath.csrc_kernels()) if trace else None
        trace_faults = []
        if summary is not None and dev.type == "cuda":
            trace_faults = devtrace.faults(summary, cell.bytes_card(),
                                           peaks["hbm_bytes_per_s"] if peaks else None)
            for f in trace_faults:
                log(f"rank {rank}: traced slice not read: {f}")
        if trace:
            flox_tpu_torch.set_options(telemetry=False)
        builds = {k: _build.BUILDS[k] - builds0[k] for k in builds0}
        # the program's state is freed before the reference runs
        kept, window.kept, window.slice = window.kept, None, None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        if kept is None:
            numbers = {"missing_result": 1}
        elif world > 1:
            numbers = cell.judge(kept, cell.remade_blocks(cell.my_blocks()))
        else:
            numbers = cell.judge(kept, cell.resident_blocks())
        ref_s = time.perf_counter() - t_ref
        del kept
        # what every rank loaded, and whether its trace could be read, by name
        flags = {f"loaded.{m}": float(m in forbidden_modules()) for m in FORBIDDEN}
        flags["trace_faults"] = float(len(trace_faults))
        worst, total = cellrun.over_ranks(
            {**{k: numbers.get(k, 0) for k in cellrun.WORST}, "peak": peak, **flags},
            {**{k: numbers.get(k, 0) for k in cellrun.TOTAL}, "busy": summary["busy_s"]
             if summary else 0.0, "failed": window.failed}, dist, dev)
        numbers = {k: worst[k] for k in cellrun.WORST} | {k: total[k] for k in cellrun.TOTAL}
        if rank != 0:
            return None
        run = SimpleNamespace(
            calls=len(window.times) - window.failed, call_s=list(window.times),
            window_s=window.window_s, bytes_global=cell.bytes_global(),
            bytes_card=cell.bytes_card(), peak_bytes=int(worst["peak"]),
            setup_s=setup_s, trace=summary, world=world, peaks=peaks)
        return {
            "run": run, "numbers": numbers, "failed": int(total["failed"]),
            "errors": window.errors[:3],
            "attempted": len(window.times), "builds": builds, "warm_s": warm_s,
            "kept_index": window.kept_index, "reference_s": ref_s,
            "busy_s": total["busy"] / world,
            "limits": cell.cell["limits"], "device": dev, "setup_parts": setup_parts,
            "loaded": sorted(m for m in FORBIDDEN if worst[f"loaded.{m}"]),
            "trace_faults": int(worst["trace_faults"]),
        }


def run_cell(spec, args: dict, device: str = "cuda", nrows: int | None = None, hook=None,
             t_start: float = T_START) -> dict:
    """One run of a cell; a cell on several chips spawns its other ranks."""
    world = int(spec.cell(args["workload"])["chips"])
    common = (spec, args, device, nrows, hook, t_start)
    if world == 1:
        return rank_run(*common)
    from . import world as ranks

    return ranks.run(rank_run, common, world)


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------


def result_line(spec, args: dict, out: dict) -> dict:
    """The last line: the metrics this cell reports, the device, the trace's
    breakdown, and last the numbers compared with their limits."""
    run = out["run"]
    trace = bool(args["trace"])
    metrics = {}
    for m in spec.metrics(args["workload"], trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers, limits = out["numbers"], out["limits"]
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    correct = (out["failed"] == 0 and numbers.get("compared", 0) > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    dev = out["device"]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "count": run.world,
              "memory_peak_bytes": int(run.peak_bytes)}
    if dev.type == "cuda":
        import torch

        device["kind"] = torch.cuda.get_device_name(dev)
        device["power_limit"] = card_power_limits(run.world)
    line = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = run.trace["wall_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line.update({
        "workload": args["workload"], "seed": args["seed"], "calls": run.calls,
        "window_s": run.window_s, "warm_call_s": out["warm_s"], "kept_call": out["kept_index"],
        "reference_s": out["reference_s"], "setup_parts": out["setup_parts"],
        "torch_import_s": out.get("torch_import_s"),
        "compiled": out["builds"], "errors": out["errors"],
        "checks": checks,
    })
    return line


def main(argv=None) -> int:
    a = parse(argv)
    args = {"workload": a.workload, "seed": a.seed, "seconds": a.seconds, "trace": a.trace}
    from .spec import Spec

    spec = Spec()
    chips = int(spec.cell(a.workload)["chips"])
    import torch

    # Set-up is timed from here. Importing torch takes 6-13 s on a card's
    # host and swings by a third with the host's load; no change to the
    # program moves it, so it is reported beside set-up and not in it.
    t_start = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{a.workload} needs {chips} CUDA card(s); this machine has {have}: no run")
        return 2
    out = run_cell(spec, args, t_start=t_start)
    out["torch_import_s"] = t_start - T_START
    line = result_line(spec, args, out)
    found = sorted(set(forbidden_modules()) | set(out["loaded"]))
    if found:
        log(f"modules that must not load were loaded: {found}: no result")
        return 3
    if out["trace_faults"]:
        log("the traced slice could not be read on some rank (above): no result")
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
