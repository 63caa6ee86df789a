"""Debug visualizers for group/shard/cohort layouts, the port of
``flox_tpu/visualize.py`` (host numpy). matplotlib is optional and imported
only inside the functions; every entry point raises a clear error when it is
missing.
"""

from __future__ import annotations

import numpy as np

from . import factorize as fct

__all__ = ["visualize_groups_1d", "visualize_cohorts_2d", "visualize_groups_2d"]


def _require_mpl():
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("matplotlib is required for flox_tpu_torch.visualize")
    import matplotlib.pyplot as plt

    return plt


def _shard_boundaries(n: int, chunks) -> list[int]:
    bounds = [0]
    for c in chunks:
        bounds.append(bounds[-1] + c)
    return bounds


def visualize_groups_1d(labels, chunks=None, ax=None, colors=None):
    """Color-striped view of 1-D labels with shard boundaries overlaid."""
    plt = _require_mpl()
    labels = np.asarray(labels).reshape(-1)
    codes, groups = fct.factorize_single(labels, None, sort=True)
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 1.5))
    ax.imshow(codes[np.newaxis, :], aspect="auto", cmap=colors or "tab20", interpolation="none")
    if chunks is not None:
        for b in _shard_boundaries(len(labels), chunks)[1:-1]:
            ax.axvline(b - 0.5, color="k", lw=1.5)
    ax.set_yticks([])
    ax.set_xlabel("position")
    return ax


def visualize_cohorts_2d(chunks_cohorts, nlabels: int, nchunks: int, ax=None):
    """Heatmap of the cohort assignment: chunk x label membership."""
    plt = _require_mpl()
    grid = np.zeros((nchunks, nlabels))
    for ci, (chunk_ids, labels) in enumerate(chunks_cohorts.items(), start=1):
        for c in chunk_ids:
            for lab in labels:
                grid[c, lab] = ci
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    ax.imshow(grid, aspect="auto", cmap="tab20", interpolation="none")
    ax.set_xlabel("label")
    ax.set_ylabel("shard")
    return ax


def visualize_groups_2d(labels, ax=None, **kwargs):
    """2-D label map (zonal-stats style)."""
    plt = _require_mpl()
    labels = np.asarray(labels)
    codes, _ = fct.factorize_single(labels.reshape(-1), None, sort=True)
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(codes.reshape(labels.shape), cmap="tab20", interpolation="none", **kwargs)
    return ax
