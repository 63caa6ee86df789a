"""collective_ms: device milliseconds per call in NCCL's kernels on rank 0,
from the profiler's trace. Nothing where no collective ran."""


def read(run):
    t = run.trace
    if t is None or t["kind_s"]["nccl"] <= 0:
        return None
    return t["kind_s"]["nccl"] / t["calls"] * 1e3
