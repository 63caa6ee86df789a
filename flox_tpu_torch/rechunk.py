"""Resharding helpers: lay data out so groups are shard-local (L3), the port
of ``flox_tpu/rechunk.py`` (host numpy, plus ``BlockwiseLayout.apply`` on
tensors).

Dask chunks can have arbitrary sizes, so flox *moves chunk boundaries* to
group boundaries. Mesh shards are equal-sized, so the
equivalent transformation is a **permutation + padding**: order elements by
group, assign whole groups to shards balancing element counts, and pad each
shard to a common length with missing labels (code -1, which every kernel
ignores). The result feeds ``method='blockwise'`` — each group's members
live entirely on one shard, so no collective combine is needed, and order
statistics (median/quantile/mode) become mesh-executable.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any

import numpy as np

logger = logging.getLogger("flox_tpu_torch.rechunk")

__all__ = ["reshard_for_blockwise", "BlockwiseLayout", "rechunk_for_blockwise", "rechunk_for_cohorts"]


@dataclass(frozen=True)
class BlockwiseLayout:
    """A shard-local-groups layout produced by :func:`reshard_for_blockwise`.

    ``permutation``: host int64 array, indices into the original trailing
    axis for each padded slot (-1 = padding).
    ``codes``: group codes per padded slot (-1 = padding).
    ``n_shards`` / ``shard_len``: the padded geometry.
    """

    permutation: np.ndarray
    codes: np.ndarray
    n_shards: int
    shard_len: int

    def apply(self, array, device=None):
        """Gather ``array`` (..., N) into the padded blockwise layout: a
        tensor on ``array``'s device for a tensor, else on ``device``
        (``cuda`` unless the caller asks for the CPU). Padding slots are NaN
        for floating data (every kernel ignores their code, -1)."""
        import torch

        from . import utils

        if isinstance(array, torch.Tensor):
            arr = array if device is None else array.to(utils.resolve_device(device))
        else:
            arr = utils.as_tensor(array, utils.resolve_device(device))
        perm = torch.as_tensor(np.where(self.permutation < 0, 0, self.permutation),
                               device=arr.device)
        out = arr.index_select(-1, perm)
        if out.is_floating_point() or out.is_complex():
            invalid = torch.as_tensor(self.permutation < 0, device=arr.device)
            out = torch.where(invalid, float("nan"), out)
        return out


def reshard_for_blockwise(codes: np.ndarray, n_shards: int) -> BlockwiseLayout:
    """Compute a permutation that makes every group shard-local.

    Greedy longest-processing-time assignment of groups to shards (balanced
    element counts), then per-shard concatenation with padding to the max
    shard length. Flox moves dask chunk boundaries to group boundaries;
    equal-size mesh shards need the permutation form instead.
    """
    codes = np.asarray(codes).reshape(-1)
    n = codes.shape[0]
    valid = codes >= 0
    uniq, counts = np.unique(codes[valid], return_counts=True)

    # greedy LPT: biggest group to the least-loaded shard
    order = np.argsort(counts)[::-1]
    loads = np.zeros(n_shards, dtype=np.int64)
    assignment = {}
    for gi in order:
        s = int(np.argmin(loads))
        assignment[uniq[gi]] = s
        loads[s] += counts[gi]
    shard_len = int(loads.max()) if len(uniq) else 1

    # build per-shard index lists (stable within group: original order kept).
    # One stable sort by code gives every group's positions contiguously —
    # O(n log n) total instead of a per-group O(n) scan.
    perm = np.full((n_shards, shard_len), -1, dtype=np.int64)
    out_codes = np.full((n_shards, shard_len), -1, dtype=np.int64)
    cursors = np.zeros(n_shards, dtype=np.int64)
    valid_idx = np.flatnonzero(valid)
    by_code = valid_idx[np.argsort(codes[valid_idx], kind="stable")]
    starts = np.concatenate([[0], np.cumsum(counts)])
    for gi, g in enumerate(uniq):
        s = assignment[g]
        idx = by_code[starts[gi] : starts[gi + 1]]
        c = cursors[s]
        perm[s, c : c + idx.size] = idx
        out_codes[s, c : c + idx.size] = g
        cursors[s] += idx.size

    logger.debug(
        "reshard_for_blockwise: %d groups over %d shards, shard_len=%d (pad %.1f%%)",
        len(uniq), n_shards, shard_len,
        100.0 * (n_shards * shard_len - int(valid.sum())) / max(n_shards * shard_len, 1),
    )
    return BlockwiseLayout(
        permutation=perm.reshape(-1),
        codes=out_codes.reshape(-1),
        n_shards=n_shards,
        shard_len=shard_len,
    )


def rechunk_for_blockwise(
    array: Any, axis: int, labels: Any, n_shards: int | None = None, device: Any = None
) -> tuple:
    """Returns ``(resharded_array, resharded_codes, groups)`` ready for
    ``groupby_reduce(..., method='blockwise')``: ``axis`` moved last and laid
    out over ``n_shards`` shards (default: the ranks of the
    ``torch.distributed`` world, 1 without one). The array is a tensor on
    ``device`` (see :meth:`BlockwiseLayout.apply`). This always reshards.
    """
    import torch

    from . import factorize as fct
    from .parallel.mesh import world_size

    if n_shards is None:
        n_shards = world_size()
    codes, groups = fct.factorize_single(np.asarray(labels).reshape(-1), None, sort=True)
    layout = reshard_for_blockwise(codes, n_shards)
    ndim = array.ndim if isinstance(array, torch.Tensor) else np.ndim(array)
    if axis % ndim != ndim - 1:
        array = (array.movedim(axis, -1) if isinstance(array, torch.Tensor)
                 else np.moveaxis(np.asarray(array), axis, -1))
    return layout.apply(array, device), layout.codes, groups


def rechunk_for_cohorts(
    array: Any,
    axis: int,
    labels: Any,
    force_new_chunk_at: Any,
    chunksize: int | None = None,
    debug: bool = False,
) -> tuple[int, ...] | tuple[tuple[int, ...], list[int]]:
    """Chunk boundaries anchored at label-pattern starts.

    For periodic labels (day-of-year, month), placing a boundary wherever a
    label in ``force_new_chunk_at`` begins makes every chunk hold one period
    segment, so the same label subset recurs in the same chunk position — the
    layout that makes cohorts maximally effective. Returns the chunk-length
    tuple (feed it to cohorts.find_group_cohorts, or use the lengths as
    shard sizes after reshard_for_blockwise-style padding).
    """
    labels = np.asarray(labels).reshape(-1)
    n = labels.shape[0]
    if array is not None:
        ax_len = np.shape(array)[axis]
        if ax_len != n:
            raise ValueError(
                f"labels (length {n}) do not align with array axis {axis} (length {ax_len})"
            )
    anchors = np.atleast_1d(np.asarray(force_new_chunk_at))
    is_anchor = np.isin(labels, anchors)
    # boundary at the first position of every run of an anchor label
    starts = np.flatnonzero(is_anchor & np.r_[True, ~is_anchor[:-1]])
    anchor_bounds = [0]
    for pos in starts:
        if pos == 0:
            continue
        # hysteresis: keep chunks near the target size
        if chunksize is not None and (pos - anchor_bounds[-1]) < max(1, chunksize // 2):
            continue
        anchor_bounds.append(int(pos))
    anchor_bounds.append(n)
    # subdivide within periods: chunks at the SAME offset of every period
    # then hold the same label subset — that repetition is what makes
    # cohorts effective (one anchor-to-anchor chunk would hold the whole
    # cycle and degrade to map-reduce). Default: ~4 chunks per period.
    if chunksize is None and len(anchor_bounds) > 2:
        min_period = min(b - a for a, b in zip(anchor_bounds[:-1], anchor_bounds[1:]))
        chunksize = max(1, min_period // 4)
    boundaries = [0]
    for a, b in zip(anchor_bounds[:-1], anchor_bounds[1:]):
        seg = b - a
        if chunksize is not None and seg > chunksize:
            nparts = -(-seg // chunksize)
            for p in range(1, nparts):
                boundaries.append(a + (seg * p) // nparts)
        if b != boundaries[-1]:
            boundaries.append(b)
    chunks = tuple(b - a for a, b in zip(boundaries[:-1], boundaries[1:]) if b > a)
    logger.debug(
        "rechunk_for_cohorts: %d chunks, sizes %s...", len(chunks), chunks[:5]
    )
    if debug:
        return chunks, boundaries
    return chunks
