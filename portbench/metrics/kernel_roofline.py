"""kernel_roofline: the least time the bytes a call must move take at the
card's peak memory rate (``peaks.json``), as a share of the device time of
the program's hand-written kernels (every ``__global__`` under
``flox_tpu_torch/csrc``) per call, in percent. Nothing when those kernels
did not run or the card is not in the table."""

from portbench import tracemath


def read(run):
    t = run.trace
    if t is None or run.peaks is None or t["kind_s"]["csrc"] <= 0:
        return None
    return tracemath.roofline_pct(run.bytes_card, run.peaks["hbm_bytes_per_s"],
                                  t["kind_s"]["csrc"] / t["calls"])
