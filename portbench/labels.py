"""The traffic generator: labels from a configuration's calendar.

A traffic mix (``traffic/<name>.json``) names its entry point, its keyword
arguments and its groupers, each a calendar field of the time axis as an
analyst's ``groupby("time.<field>")`` or ``resample`` would pass it: numpy
arrays, no pandas. The calendar is the configuration's ``time`` block:
``start`` (an ISO date or hour), ``step`` (``"1h"`` or ``"1D"``) and
``count``.
"""

from __future__ import annotations

import numpy as np

_UNITS = {"h": "h", "D": "D"}


def timestamps(time: dict) -> np.ndarray:
    """The time axis: ``count`` steps of ``step`` from ``start``."""
    step = time["step"]
    n, unit = int(step[:-1] or 1), _UNITS[step[-1]]
    start = np.datetime64(time["start"], unit)
    return start + np.arange(int(time["count"]), dtype=np.int64) * np.timedelta64(n, unit)


def _days(t: np.ndarray) -> np.ndarray:
    return t.astype("datetime64[D]")


FIELDS = {
    # time.month: 1..12
    "month": lambda t: (t.astype("datetime64[M]").astype(np.int64) % 12) + 1,
    # resample(time="1D"): the day, as days since 1970-01-01
    "day": lambda t: _days(t).astype(np.int64),
    # time.dayofyear: 1..366
    "dayofyear": lambda t: (_days(t) - t.astype("datetime64[Y]").astype("datetime64[D]"))
    .astype(np.int64) + 1,
    # time.hour: 0..23
    "hour": lambda t: (t - _days(t).astype(t.dtype)).astype("timedelta64[h]").astype(np.int64),
}


def groupers(traffic: dict, config: dict) -> list[np.ndarray]:
    """The ``by`` arrays of a traffic mix over a configuration's calendar."""
    t = timestamps(config["time"])
    return [FIELDS[name](t) for name in traffic["by"]]


def run_lengths(labels: np.ndarray) -> np.ndarray:
    """Lengths of the runs of equal consecutive labels."""
    edges = np.flatnonzero(np.diff(labels)) + 1
    return np.diff(np.concatenate([[0], edges, [labels.size]]))
