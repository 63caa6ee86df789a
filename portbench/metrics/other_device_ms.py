"""other_device_ms: device milliseconds per call in operations that are
neither the program's hand-written kernels nor NCCL's (the wrappers'
binning, finalize, copies), from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t["ops"] == 0:
        return None
    return t["kind_s"]["other"] / t["calls"] * 1e3
