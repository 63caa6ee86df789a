"""bins_ms: host milliseconds per call in the program's ``bins`` spans, the
binning of the codes before each hand-written kernel (telemetry on in the
traced run). Nothing where the path opens none."""


def read(run):
    t = run.trace
    if t is None or "bins" not in t["span_s"]:
        return None
    return t["span_s"]["bins"] / t["calls"] * 1e3
