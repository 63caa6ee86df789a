"""Factorization: labels -> dense integer group codes, on the host.

The host half of ``flox_tpu/factorize.py`` (``factorize_single``,
``ravel_multi_codes``, ``offset_labels``, ``factorize_``,
``factorize_cached``), written with numpy alone so that the package imports
where pandas is absent:

* ``pd.factorize(sort=True)`` becomes ``np.unique(..., return_inverse=True)``,
  with NaN/NaT labels (which ``np.unique`` sorts last and keeps) mapped to
  code -1;
* alignment against ``expected_groups`` becomes ``searchsorted`` plus an
  equality check;
* interval binning becomes ``searchsorted`` with ``pd.cut``'s closed-side
  rules (:class:`~flox_tpu_torch.types.Bins`).

Missing or unmatched labels get code ``-1`` everywhere. Group values come out
as numpy arrays (a structured ``left``/``right`` array for bins).
"""

from __future__ import annotations

import hashlib
from typing import Any, Sequence

import numpy as np

from . import utils
from .types import Bins, FactorProps

__all__ = [
    "factorize_",
    "factorize_cached",
    "factorize_single",
    "offset_labels",
    "ravel_multi_codes",
]


def _view_if_datetime(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind in "mM":
        return values.view("int64")
    return values


def _unique_codes(flat: np.ndarray, sort: bool) -> tuple[np.ndarray, np.ndarray]:
    """``pd.factorize`` without pandas: (codes with -1 for missing, groups)."""
    null = utils.isnull_host(flat)
    present = flat[~null] if null.any() else flat
    if sort:
        groups, inverse = np.unique(present, return_inverse=True)
    else:
        # first-appearance order, as pd.factorize(sort=False) gives it
        uniq, first, inverse = np.unique(present, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        groups, inverse = uniq[order], rank[inverse]
    codes = np.full(flat.shape, -1, dtype=np.int64)
    codes[~null] = inverse.reshape(-1)
    return codes, groups


def _align(flat: np.ndarray, expect: np.ndarray) -> np.ndarray:
    """Codes of ``flat`` in ``expect`` (positions in its given order), -1 where
    a label is not among them: ``searchsorted`` on the sorted values plus an
    equality check."""
    if len(expect) == 0:
        return np.full(flat.shape, -1, dtype=np.int64)
    sorter = np.argsort(expect, kind="stable")
    ordered = expect[sorter]
    pos = np.searchsorted(ordered, flat, side="left")
    pos_c = np.clip(pos, 0, len(ordered) - 1)
    with np.errstate(invalid="ignore"):
        hit = (pos < len(ordered)) & (ordered[pos_c] == flat)
    return np.where(hit, sorter[pos_c], -1).astype(np.int64)


def _bin(flat: np.ndarray, bins: Bins) -> np.ndarray:
    """Interval codes with ``pd.cut`` semantics; out-of-range and NaN -> -1."""
    # integer (incl. datetime64-viewed int64) values stay integral: a float
    # cast would round ns-resolution timestamps
    edges = _view_if_datetime(np.asarray(bins.edges))
    vals = _view_if_datetime(np.asarray(flat))
    with np.errstate(invalid="ignore"):
        if bins.closed == "right":
            codes = np.searchsorted(edges, vals, side="left") - 1
            invalid = (vals <= edges[0]) | (vals > edges[-1])
        else:
            codes = np.searchsorted(edges, vals, side="right") - 1
            invalid = (vals < edges[0]) | (vals >= edges[-1])
    invalid |= utils.isnull_host(flat)
    codes = codes.astype(np.int64, copy=False)
    codes[invalid] = -1
    return codes


def factorize_single(
    flat: np.ndarray,
    expect: np.ndarray | Bins | None,
    *,
    sort: bool = True,
) -> tuple[np.ndarray, np.ndarray | Bins]:
    """Codes for one label array: ``(codes int64 with -1 for missing, groups)``.

    ``expect`` is ``None`` (discover the labels), a :class:`Bins`, or an array
    of expected values. With ``sort=True`` the expected values are sorted
    first, so the groups axis of the result is ordered whatever order the user
    gave (parity: ``flox_tpu.factorize.factorize_single``).
    """
    flat = np.asarray(flat).reshape(-1)
    if expect is None:
        return _unique_codes(flat, sort)
    if isinstance(expect, Bins):
        return _bin(flat, expect), expect
    expect = np.asarray(expect)
    if sort:
        expect = np.sort(expect)
    codes = _align(flat, expect)
    if utils.isnull_host(flat).any():  # NaN never equals an expected NaN
        codes[utils.isnull_host(flat)] = -1
    return codes, expect


def ravel_multi_codes(codes: Sequence[np.ndarray], shape: tuple[int, ...]) -> np.ndarray:
    """Combine per-by codes into one flat code over the product grid.

    Any component code of -1 (missing) makes the combined code -1.
    """
    if len(codes) == 1:
        return codes[0]
    missing = np.zeros(codes[0].shape, dtype=bool)
    clipped = []
    for c in codes:
        missing |= c < 0
        clipped.append(np.where(c < 0, 0, c))
    flat = np.ravel_multi_index(clipped, shape, mode="wrap").astype(np.int64)
    flat[missing] = -1
    return flat


def offset_labels(codes: np.ndarray, ngroups: int) -> tuple[np.ndarray, int]:
    """Make group codes disjoint per leading position.

    ``codes`` has shape (M, N) where N covers the reduced axes; the output has
    the same shape with row ``i`` offset by ``i * ngroups``, and the new total
    size is ``M * ngroups``.
    """
    m = codes.shape[0]
    offset = np.arange(m, dtype=np.int64)[:, None] * ngroups
    out = np.where(codes < 0, -1, codes + offset)
    return out, m * ngroups


def factorize_(
    by: Sequence[np.ndarray],
    axes: tuple[int, ...],
    expected_groups: Sequence[np.ndarray | Bins | None] | None = None,
    *,
    sort: bool = True,
) -> tuple[np.ndarray, tuple[Any, ...], tuple[int, ...], int, int, FactorProps]:
    """Multi-``by`` factorization.

    Returns ``(codes, found_groups, group_shape, ngroups, size, props)`` where
    ``codes`` has the shape of ``by[0]`` (or is offset-expanded to (M, N) when
    ``axes`` is a strict subset of the by dims), ``ngroups`` is the dense
    product-grid size, and ``size`` is the segment count the kernels allocate.
    """
    if expected_groups is None:
        expected_groups = [None] * len(by)

    codes_per_by: list[np.ndarray] = []
    found: list[Any] = []
    for b, expect in zip(by, expected_groups):
        b = np.asarray(b)
        codes, groups = factorize_single(b, expect, sort=sort)
        codes_per_by.append(codes.reshape(b.shape))
        found.append(groups)

    group_shape = tuple(len(g) for g in found)
    ngroups = int(np.prod(group_shape)) if group_shape else 0
    codes = ravel_multi_codes([c.reshape(-1) for c in codes_per_by], group_shape).reshape(
        codes_per_by[0].shape
    )

    offset = len(axes) < codes.ndim
    if offset:
        # leading (non-reduced) label dims become rows; the reduced axes must
        # be the trailing block (core moves them there first)
        if tuple(axes) != tuple(range(codes.ndim - len(axes), codes.ndim)):
            raise ValueError(
                f"factorize_ requires the reduced axes to be trailing; got axes={axes} "
                f"for a {codes.ndim}-d label array"
            )
        nred = int(np.prod([codes.shape[ax] for ax in axes]))
        codes, size = offset_labels(codes.reshape(-1, nred), ngroups)
    else:
        size = ngroups

    nanmask = codes < 0
    props = FactorProps(
        offset_group=offset, nan_sentinel=False, nanmask=nanmask if nanmask.any() else None
    )
    return codes, tuple(found), group_shape, ngroups, size, props


# ---------------------------------------------------------------------------
# memoized factorization: repeated reductions over the same labels (e.g. a
# per-step climatology) skip the unique pass
# ---------------------------------------------------------------------------

_FACTORIZE_CACHE: dict = {}  # insertion-ordered: oldest first
_FACTORIZE_CACHE_BYTES = [0]
_FACTORIZE_MAX_INPUT_BYTES = 1 << 26  # don't fingerprint labels over 64 MB
_FACTORIZE_BUDGET_BYTES = 1 << 28  # cached codes arrays: 256 MB total


def _fingerprint_array(a: np.ndarray) -> tuple:
    if not a.flags["C_CONTIGUOUS"] and a.nbytes > (1 << 24):
        # hashing would first materialize a large copy; not worth it
        raise TypeError("skip cache: large non-contiguous labels")
    if a.dtype.kind == "O":
        raise TypeError("skip cache: object labels have no stable bytes")
    return (a.shape, a.dtype.str, hashlib.sha1(np.ascontiguousarray(a)).hexdigest())


def _fingerprint_expected(e) -> tuple | None:
    if e is None:
        return None
    if isinstance(e, Bins):
        return ("bins", e.closed, _fingerprint_array(np.asarray(e.edges)))
    return ("values", _fingerprint_array(np.asarray(e)))


def factorize_cached(by, axes, expected_groups=None, *, sort: bool = True):
    """Memoizing wrapper over :func:`factorize_` (same signature and returns).

    Byte-budgeted LRU: entries are evicted oldest-first once the cached codes
    exceed the budget.
    """
    total = sum(np.asarray(b).nbytes for b in by)
    if total > _FACTORIZE_MAX_INPUT_BYTES:
        return factorize_(by, axes, expected_groups, sort=sort)
    try:
        key = (
            tuple(_fingerprint_array(np.asarray(b)) for b in by),
            tuple(axes),
            None
            if expected_groups is None
            else tuple(_fingerprint_expected(e) for e in expected_groups),
            sort,
        )
    except TypeError:  # exotic or large non-contiguous labels: just compute
        return factorize_(by, axes, expected_groups, sort=sort)
    hit = _FACTORIZE_CACHE.get(key)
    if hit is not None:
        _FACTORIZE_CACHE[key] = _FACTORIZE_CACHE.pop(key)  # refresh LRU position
        return hit
    out = factorize_(by, axes, expected_groups, sort=sort)
    _FACTORIZE_CACHE[key] = out
    _FACTORIZE_CACHE_BYTES[0] += int(np.asarray(out[0]).nbytes)
    while _FACTORIZE_CACHE_BYTES[0] > _FACTORIZE_BUDGET_BYTES and len(_FACTORIZE_CACHE) > 1:
        evicted = _FACTORIZE_CACHE.pop(next(iter(_FACTORIZE_CACHE)))
        _FACTORIZE_CACHE_BYTES[0] -= int(np.asarray(evicted[0]).nbytes)
    return out
