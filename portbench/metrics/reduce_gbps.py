"""reduce_gbps: the input bytes (1 GB = 1e9 bytes) of all the calls completed
in the window, over the window's wall time (host clock). A sharded cell
counts the global array's bytes."""

from portbench import tracemath


def read(run):
    if run.calls == 0 or run.window_s <= 0:
        return None
    return tracemath.rate_gbps(run.bytes_global, run.calls, run.window_s)
