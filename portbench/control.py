"""The readings that a cell's correctness limits are set from.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

On the cell's own cards and at its own size: for each of ``--seeds``, the
program's timed call once on fresh data and the numbers the harness
compares (the lower readings); for each of ``--control-seeds``, the same
numbers of the control, the reference computed from inputs rounded to
bfloat16 with float32 sums (the upper readings). One JSON line a seed on
standard output; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_numbers(cell) -> dict:
    """The control's numbers over this rank's blocks of the whole array."""
    import torch

    from .reference import grouped

    judge = grouped.Judge(cell.config["field"]["std"])
    codes = torch.as_tensor(cell.codes, device=cell.device)
    func = cell.traffic["kwargs"]["func"]
    for _, _, x in cell.remade_blocks(cell.my_blocks()):
        want = grouped.reduce_block(x, codes, cell.ngroups, func)
        judge.add(grouped.reduce_block(x, codes, cell.ngroups, func, "bfloat16"), want)
    return {"max_rel_err": judge.max_rel_err, "nonfinite_mismatch": judge.nonfinite_mismatch,
            "compared": judge.compared}


def readings(spec, name: str, seeds: list[int], control: list[int], device: str,
             nrows: int | None, rank: int = 0, world: int = 1,
             init_file: str | None = None) -> None:
    import torch

    from . import cellrun
    from .world import joined

    mesh = None
    with joined(device, rank, world, init_file) as (dist, dev):
        if world > 1:
            from flox_tpu_torch.parallel import make_mesh

            mesh = make_mesh(device_type=dev.type)
        for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in control]:
            t0 = time.perf_counter()
            cell = cellrun.Cell(spec, name, seed, dev, rank, world, nrows)
            if kind == "program":
                cell.make_data(mesh)
                out, _, _ = cell.timed_call()
                blocks = (cell.remade_blocks(cell.my_blocks()) if world > 1
                          else cell.resident_blocks())
                numbers = cell.judge(out, blocks)
                del out
                cell.data = cell.local = None
            else:
                numbers = control_numbers(cell)
            worst, total = cellrun.over_ranks({k: numbers.get(k, 0) for k in cellrun.WORST},
                                              {k: numbers.get(k, 0) for k in cellrun.TOTAL},
                                              dist, dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            if rank == 0:
                print(json.dumps({"workload": name, "kind": kind, "seed": seed,
                                  "seconds": time.perf_counter() - t0, **worst, **total}),
                      flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=None)
    a = p.parse_args(argv)
    from .spec import Spec

    spec = Spec()
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = [int(s) for s in a.control_seeds.split(",") if s]
    world = int(spec.cell(a.workload)["chips"])
    common = (spec, a.workload, seeds, control, a.device, a.rows)
    if world == 1:
        readings(*common)
    else:
        from . import world as ranks

        ranks.run(readings, common, world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
