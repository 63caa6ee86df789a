"""Shared types of the port (counterpart of ``flox_tpu/types.py``, trimmed to
what the eager path and ``factorize`` use)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass(frozen=True)
class FactorProps:
    """Bookkeeping emitted by factorization (parity: flox ``types.FactorProps``)."""

    offset_group: bool  # labels were offset per leading position (partial-axis reduce)
    nan_sentinel: bool  # -1 codes were remapped to an extra trailing group
    nanmask: Any  # host bool mask of missing-label positions (or None)


@dataclass(frozen=True, eq=False)
class Bins:
    """Interval bins given by their sorted edges: the pandas-free stand-in for
    a ``pd.IntervalIndex`` built with ``from_breaks``.

    ``closed="right"`` is ``pd.cut``'s default: bin ``i`` holds
    ``edges[i] < v <= edges[i + 1]``; ``closed="left"`` holds
    ``edges[i] <= v < edges[i + 1]``.
    """

    edges: np.ndarray
    closed: str = "right"

    def __post_init__(self) -> None:
        if self.closed not in ("right", "left"):
            raise ValueError(f"closed must be 'right' or 'left'; got {self.closed!r}")
        if np.ndim(self.edges) != 1 or len(self.edges) < 2:
            raise ValueError("bins need at least two edges in a 1-D array")

    def __len__(self) -> int:
        return len(self.edges) - 1

    def values(self) -> np.ndarray:
        """The bins as a 1-D structured array with fields ``left`` and ``right``."""
        edges = np.asarray(self.edges)
        out = np.empty(len(self), dtype=[("left", edges.dtype), ("right", edges.dtype)])
        out["left"] = edges[:-1]
        out["right"] = edges[1:]
        return out
