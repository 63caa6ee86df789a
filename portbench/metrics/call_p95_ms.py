"""call_p95_ms: the nearest-rank 95th percentile of the wall time of every
call in the window, entry to result ready (host clock; rank 0 in a sharded
cell). Nothing under 200 calls: a tail needs ten calls beyond it."""

from portbench import tracemath


def read(run):
    p = tracemath.p95(run.call_s)
    return None if p is None else p * 1e3
