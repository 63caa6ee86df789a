"""device_idle_pct: 1 - device busy / the traced slice's wall time, in
percent, where busy is the union of the device's operations on rank 0's
card. Nothing where the trace holds no device operation."""


def read(run):
    t = run.trace
    if t is None or t["ops"] == 0 or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
