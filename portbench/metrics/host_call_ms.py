"""host_call_ms: host milliseconds per call in the program's root span of
the entry point (``groupby_reduce``), entry to return, before the
synchronize that waits for the card."""


def read(run):
    t = run.trace
    if t is None or t["entry"] not in t["span_s"]:
        return None
    return t["span_s"][t["entry"]] / t["calls"] * 1e3
