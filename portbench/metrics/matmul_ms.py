"""matmul_ms: host milliseconds per call in the program's ``matmul`` spans,
the one-hot GEMM's block loop (telemetry on in the traced run). Nothing
where the path opens none."""


def read(run):
    t = run.trace
    if t is None or "matmul" not in t["span_s"]:
        return None
    return t["span_s"]["matmul"] / t["calls"] * 1e3
