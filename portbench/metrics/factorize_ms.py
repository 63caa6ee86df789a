"""factorize_ms: host milliseconds per call in the program's ``factorize``
span (telemetry on in the traced run). Nothing where the path opens none."""


def read(run):
    t = run.trace
    if t is None or "factorize" not in t["span_s"]:
        return None
    return t["span_s"]["factorize"] / t["calls"] * 1e3
