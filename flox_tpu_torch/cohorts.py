"""Cohort detection: the method-selection brain (L3) of the port, a host
copy of ``flox_tpu/cohorts.py`` (numpy and scipy, no torch).

``find_group_cohorts`` builds a sparse boolean bitmask ``S[chunk, label]``,
walks a decision ladder (single chunk -> blockwise; every label in one chunk
-> blockwise; single cohort -> map-reduce; ...), and otherwise measures
*containment* ``C = S.T @ S / chunks_per_label`` and greedily merges labels
whose chunk-sets overlap >= 75 % into cohorts.

A "chunk" is a shard of the reduced axis (``chunks_from_shards``: equal
slices of ``ceil(N / n_shards)``, the last short). The ladder's outcomes map
to the three mesh programs (``parallel.mapreduce``):

* ``blockwise`` -- every group is shard-local already; skip the combine.
* ``cohorts``  -- labels cluster into shard-subsets; psum_scatter ownership
  pays off because each rank finalizes only its cohort's groups
  (``ownership_permutation`` aligns the ownership tiles with them).
* ``map-reduce`` -- labels are spread over most shards; dense psum combine.

Every rank computes the same answer from the same global codes, so the
choice never splits the ranks.
"""

from __future__ import annotations

import logging
import math
from typing import Sequence

import numpy as np


logger = logging.getLogger("flox_tpu_torch.cohorts")

__all__ = ["find_group_cohorts", "chunks_from_shards", "ownership_permutation"]


def ownership_permutation(
    mapping: dict[tuple[int, ...], list[int]], size: int, n_shards: int
) -> np.ndarray | None:
    """Group-ownership permutation aligning psum_scatter slices with cohorts.

    ``mapping`` is ``find_group_cohorts``' cohort → labels dict. The cohorts
    mesh program scatters the group axis in ``n_shards`` equal tiles — tile
    ``d`` lands on device ``d`` — so ownership is positional. This computes a
    permutation placing each cohort's labels in the tiles of the shards that
    actually hold the cohort's data (the locality economics of the
    reference's per-cohort subgraphs, cohorts.py:109-301, expressed as a
    static gather): device ``d`` then finalizes groups whose rows mostly
    live on ``d``, and downstream shard-local consumers read their own
    groups without cross-device traffic.

    Returns ``perm`` of length ``n_shards * ceil(size / n_shards)`` mapping
    slot → group id (ids ≥ ``size`` are padding), or None when the mapping
    gives no usable locality (empty, or one cohort spanning everything).
    """
    if not mapping:
        return None
    cap = math.ceil(size / n_shards)
    size_pad = cap * n_shards
    load = [0] * n_shards
    slots: list[list[int]] = [[] for _ in range(n_shards)]

    def place(label: int, prefs: Sequence[int]) -> None:
        for d in prefs:
            if load[d] < cap:
                slots[d].append(label)
                load[d] += 1
                return
        d = int(np.argmin(load))
        slots[d].append(label)
        load[d] += 1

    assigned = np.zeros(size, dtype=bool)
    # widest cohorts first so their preferred shards still have capacity
    for chunk_set, labels in sorted(mapping.items(), key=lambda kv: -len(kv[1])):
        prefs = sorted(
            (d for d in chunk_set if d < n_shards), key=lambda d: load[d]
        )
        for lab in labels:
            if 0 <= lab < size and not assigned[lab]:
                place(int(lab), prefs)
                assigned[lab] = True
    for lab in np.flatnonzero(~assigned):
        place(int(lab), ())

    perm = np.full(size_pad, size, dtype=np.int64)  # `size` = zero-pad column
    for d in range(n_shards):
        start = d * cap
        perm[start : start + len(slots[d])] = slots[d]
    identity = np.arange(size_pad)
    identity[size:] = size
    if np.array_equal(perm, identity):
        return None  # positional ownership is already aligned
    return perm


def chunks_from_shards(n: int, n_shards: int) -> tuple[int, ...]:
    """Equal-slice chunk lengths for a sharded axis (last shard may be short)."""
    per = math.ceil(n / n_shards)
    chunks = []
    left = n
    while left > 0:
        take = min(per, left)
        chunks.append(take)
        left -= take
    return tuple(chunks)


def _is_nested_chunks(chunks) -> bool:
    """Multi-axis chunk grids are sequences of per-axis chunk tuples."""
    return bool(len(chunks)) and isinstance(chunks[0], (tuple, list, np.ndarray))


def _chunk_ids(shape: tuple[int, ...], chunks) -> np.ndarray:
    """Flattened chunk index per element of an nD label array chunked by a
    per-axis grid (row-major over the block grid, matching dask's
    block_id ordering in the reference's bitmask, cohorts.py:34-105)."""
    cid: np.ndarray | None = None
    ndim = len(shape)
    for ax, ch in enumerate(chunks):
        ch = tuple(int(c) for c in ch)
        if sum(ch) != shape[ax]:
            raise ValueError(
                f"chunks for axis {ax} sum to {sum(ch)}, label axis is {shape[ax]}"
            )
        bounds = np.cumsum(ch)
        block = np.searchsorted(bounds, np.arange(shape[ax]), side="right").astype(np.int64)
        bshape = [1] * ndim
        bshape[ax] = shape[ax]
        block = block.reshape(bshape)
        cid = block if cid is None else cid * len(ch) + block
    return np.broadcast_to(cid, shape)


def _label_chunk_bitmask(labels: np.ndarray, chunks, nlabels: int):
    """Sparse boolean S[chunk, label]: does chunk i contain label j?

    Parity: _compute_label_chunk_bitmask (cohorts.py:34-105). ``chunks`` is
    a chunk-length sequence over the flattened labels, or — for nD label
    arrays chunked on every axis (the reference's NWM county case) — a
    sequence of per-axis chunk tuples. The reference's write-True-uniques
    trick becomes a per-chunk ``np.unique`` / a coo-dedup here — the chunk
    count is small (shards), so this stays cheap.
    """
    import scipy.sparse

    if _is_nested_chunks(chunks):
        labels = np.asarray(labels)
        if labels.ndim != len(chunks):
            raise ValueError(
                f"nested chunks describe {len(chunks)} axes but labels have "
                f"{labels.ndim} dims"
            )
        cid = _chunk_ids(labels.shape, chunks).reshape(-1)
        flat = labels.reshape(-1)
        keep = flat >= 0
        nchunks = int(np.prod([len(c) for c in chunks]))
        mat = scipy.sparse.csc_array(
            (np.ones(int(keep.sum()), dtype=np.int64), (cid[keep], flat[keep])),
            shape=(nchunks, nlabels), dtype=np.int64,
        )
        mat.data = np.ones_like(mat.data)  # construction summed duplicates
        return mat

    labels = np.asarray(labels).reshape(-1)
    rows: list[np.ndarray] = []
    cols: list[np.ndarray] = []
    start = 0
    for i, c in enumerate(chunks):
        seg = labels[start : start + c]
        start += c
        uniq = np.unique(seg[seg >= 0])
        rows.append(np.full(uniq.shape, i, dtype=np.int64))
        cols.append(uniq)
    rows_a = np.concatenate(rows) if rows else np.empty(0, dtype=np.int64)
    cols_a = np.concatenate(cols) if cols else np.empty(0, dtype=np.int64)
    data = np.ones(rows_a.shape, dtype=np.int64)
    return scipy.sparse.csc_array(
        (data, (rows_a, cols_a)), shape=(len(chunks), nlabels), dtype=np.int64
    )


_COHORTS_CACHE: dict = {}


def find_group_cohorts(
    labels,
    chunks: Sequence[int],
    expected_groups=None,
    merge: bool = True,
) -> tuple[str, dict[tuple[int, ...], list[int]]]:
    """Detect cohorts and recommend an execution method.

    Returns ``(method, chunks_cohorts)`` where ``method`` is one of
    "blockwise" | "cohorts" | "map-reduce" and ``chunks_cohorts`` maps a
    tuple of chunk indices to the list of labels they own (empty for
    map-reduce, as in the reference). ``merge=False`` skips the containment
    merge and returns one cohort per label (parity: cohorts.py merge flag).

    Results are memoized on a label fingerprint — repeated reductions over
    the same layout (e.g. one climatology per training step) skip the
    O(nlabels²) containment analysis (parity: the reference memoizes its
    chunk analyses through cachey, cache.py:7-9).

    Decision ladder parity: cohorts.py:109-301.
    """
    import hashlib

    nested = _is_nested_chunks(chunks)
    labels = np.asarray(labels) if nested else np.asarray(labels).reshape(-1)
    key = (
        hashlib.sha1(np.ascontiguousarray(labels)).hexdigest(),
        labels.shape,
        tuple(tuple(int(x) for x in c) for c in chunks) if nested else tuple(chunks),
        None if expected_groups is None else len(expected_groups),
        merge,
    )
    hit = _COHORTS_CACHE.get(key)
    if hit is not None:
        return hit
    out = _find_group_cohorts(labels, chunks, expected_groups, merge)
    if len(_COHORTS_CACHE) > 128:
        _COHORTS_CACHE.clear()
    _COHORTS_CACHE[key] = out
    return out


def _find_group_cohorts(
    labels: np.ndarray,
    chunks: Sequence[int],
    expected_groups,
    merge: bool,
) -> tuple[str, dict[tuple[int, ...], list[int]]]:
    if expected_groups is None:
        nlabels = int(labels.max()) + 1 if labels.size and labels.max() >= 0 else 0
    else:
        nlabels = len(expected_groups)
    nchunks = (
        int(np.prod([len(c) for c in chunks]))
        if _is_nested_chunks(chunks)
        else len(chunks)
    )

    if nlabels == 0:
        return "map-reduce", {}

    # single chunk: everything is local (cohorts.py:151-152)
    if nchunks == 1:
        logger.debug("find_group_cohorts: single chunk -> blockwise")
        return "blockwise", {(0,): list(range(nlabels))}

    bitmask = _label_chunk_bitmask(labels, chunks, nlabels)
    chunks_per_label = np.asarray(bitmask.sum(axis=0)).reshape(-1)
    present = chunks_per_label > 0

    # every label lives in exactly one chunk -> blockwise (cohorts.py:182-184)
    if (chunks_per_label[present] == 1).all():
        coo = bitmask.tocoo()
        mapping: dict[tuple[int, ...], list[int]] = {}
        for chunk, label in zip(coo.coords[0], coo.coords[1]):
            mapping.setdefault((int(chunk),), []).append(int(label))
        logger.debug("find_group_cohorts: one chunk per label -> blockwise")
        return "blockwise", mapping

    # single cohort: every label occupies every chunk (cohorts.py:187-189)
    if (chunks_per_label[present] == nchunks).all():
        logger.debug("find_group_cohorts: all labels in all chunks -> map-reduce")
        return "map-reduce", {}

    if not merge:
        coo = bitmask.tocoo()
        per_label: dict[int, set[int]] = {}
        for chunk, label in zip(coo.coords[0], coo.coords[1]):
            per_label.setdefault(int(label), set()).add(int(chunk))
        raw: dict[tuple[int, ...], list[int]] = {}
        for lab, cset in sorted(per_label.items()):
            raw.setdefault(tuple(sorted(cset)), []).append(lab)
        return "cohorts", raw

    # containment matrix C[i, j] = |chunks(i) ∩ chunks(j)| / |chunks(i)|
    # (cohorts.py:241-244)
    S = bitmask.T  # (nlabels, nchunks)
    overlap = (S @ S.T).astype(np.float64)  # (nlabels, nlabels)
    denom = np.where(chunks_per_label > 0, chunks_per_label, 1).astype(np.float64)
    containment = overlap.multiply(1.0 / denom[:, None]).tocsr()

    # sparsity guard: highly-overlapping labels -> map-reduce (cohorts.py:220-237)
    sparsity = containment.nnz / max(nlabels * nlabels, 1)
    MAX_SPARSITY = 0.4
    if sparsity > MAX_SPARSITY:
        logger.debug(
            "find_group_cohorts: containment sparsity %.2f > %.2f -> map-reduce",
            sparsity, MAX_SPARSITY,
        )
        return "map-reduce", {}

    # greedy merge of labels with containment >= 0.75 (cohorts.py:256-290)
    THRESHOLD = 0.75
    bcoo = bitmask.tocoo()
    label_chunks: dict[int, set[int]] = {}
    for chunk, label in zip(bcoo.coords[0], bcoo.coords[1]):
        label_chunks.setdefault(int(label), set()).add(int(chunk))
    indptr, indices, data = containment.indptr, containment.indices, containment.data
    merged: dict[tuple[int, ...], list[int]] = {}
    assigned = np.full(nlabels, False)
    order = np.argsort(-chunks_per_label)  # widest labels first
    for lab in order:
        lab = int(lab)
        if not present[lab] or assigned[lab]:
            continue
        row_cols = indices[indptr[lab] : indptr[lab + 1]]
        row_vals = data[indptr[lab] : indptr[lab + 1]]
        members = [
            int(j)
            for j, v in zip(row_cols, row_vals)
            if v >= THRESHOLD and not assigned[j] and present[j]
        ]
        if lab not in members:
            members.append(lab)
        chunk_set: set[int] = set()
        for m in members:
            assigned[m] = True
            chunk_set.update(label_chunks[m])
        merged.setdefault(tuple(sorted(chunk_set)), []).extend(sorted(members))

    ncohorts = len(merged)
    if ncohorts == 1:
        logger.debug("find_group_cohorts: merged into one cohort -> map-reduce")
        return "map-reduce", {}
    logger.debug("find_group_cohorts: %d cohorts -> cohorts", ncohorts)
    return "cohorts", merged
