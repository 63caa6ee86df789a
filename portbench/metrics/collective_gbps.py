"""collective_gbps: the bytes rank 0's combine must move a call over its NCCL
device time a call, in GB/s (1 GB = 1e9 bytes).

The bytes are the harness's own, from the cell's shapes, as
``tracemath.call_bytes`` counts a call's: a grouped reduction sharded along
the reduced axis combines, for each (row, group), the partial results its
function needs (a mean: a sum and a count), four bytes each, and an
all-reduce moves each buffer once. Neither how the program counts its bytes
nor how many collectives it makes moves them. The cell is the one of this
metric's cells whose shapes give the run's bytes on a card. The time is the
profiled slice's NCCL kernels (as ``collective_ms``). Nothing where no
collective ran or no cell matches."""

import numpy as np

from portbench import cellrun, tracemath
from portbench.spec import Spec

#: the partial results a function combines for each (row, group): a mean's
#: sum and count
PARTIALS = {"nanmean": 2}
PARTIAL_BYTES = 4  # float32 sums, int32 counts


def must_move(run) -> float | None:
    """The bytes a call's combine must move on a card, or ``None``."""
    spec = Spec()
    metric = next(m for m in spec.bench["per_layer"] if m["name"] == "collective_gbps")
    for name in metric.get("workloads", []):
        if spec.workload(name)["chips"] != run.world:
            continue
        cell = cellrun.Cell(spec, name, 0, "cpu", 0, run.world)
        itemsize = np.dtype(cell.config["field"]["dtype"]).itemsize
        legs = int(cell.traffic.get("result_legs", 1))
        if tracemath.call_bytes(cell.nrows, cell.hi - cell.lo, itemsize, cell.ngroups,
                                legs) != run.bytes_card:
            continue
        partials = PARTIALS.get(cell.traffic.get("kwargs", {}).get("func"))
        if partials is None:
            return None
        return float(partials * legs * cell.nrows * cell.ngroups * PARTIAL_BYTES)
    return None


def read(run):
    t = run.trace
    if t is None or t["kind_s"]["nccl"] <= 0:
        return None
    nbytes = must_move(run)
    if nbytes is None:
        return None
    return nbytes / (t["kind_s"]["nccl"] / t["calls"]) / 1e9
