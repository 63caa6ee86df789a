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

The device half (``flox_tpu/factorize.py``'s ``factorize_device``,
``bin_device`` and ``Prefactorized``) computes codes with ``torch.searchsorted``
on the labels' device when the groups are known, and keeps a factorize-once
artifact whose codes are staged on the device, so that later reductions over
the same labels skip both the factorization and the codes' copy.
"""

from __future__ import annotations

import hashlib
from typing import Any, Sequence

import numpy as np
import torch

from . import kernels, utils
from .types import Bins, FactorProps

__all__ = [
    "Prefactorized",
    "bin_device",
    "factorize_",
    "factorize_cached",
    "factorize_device",
    "factorize_single",
    "offset_labels",
    "prefactorize",
    "prefactorized_from_host",
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


# ---------------------------------------------------------------------------
# device-resident factorization: known groups, codes by searchsorted on the
# labels' device
# ---------------------------------------------------------------------------


def _on_device(by, values, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``by`` and the sorted ``values`` it is searched in, as tensors of one
    dtype on ``device`` (``cuda`` unless the caller names another)."""
    dev = utils.resolve_device(device)
    by_t = utils.as_tensor(by, dev)
    vals = utils.as_tensor(values, dev)
    common = torch.promote_types(by_t.dtype, vals.dtype)
    return by_t.to(common), vals.to(common)


def factorize_device(by, expected_values, *, device=None) -> torch.Tensor:
    """int32 codes of ``by`` in the *sorted, unique* ``expected_values``, on
    the device: ``torch.searchsorted`` plus an equality check; unmatched and
    NaN labels give -1."""
    by_t, vals = _on_device(by, expected_values, device)
    idx = torch.searchsorted(vals, by_t, side="left")
    idx_c = idx.clamp(0, vals.shape[0] - 1)
    valid = vals[idx_c] == by_t
    return torch.where(valid, idx_c, -1).to(torch.int32)


def bin_device(by, edges, closed: str = "right", *, device=None) -> torch.Tensor:
    """int32 interval codes of ``by`` on the device, with ``pd.cut``
    semantics: out-of-range and NaN labels give -1."""
    by_t, e = _on_device(by, edges, device)
    if closed == "right":
        codes = torch.searchsorted(e, by_t, side="left") - 1
        valid = (by_t > e[0]) & (by_t <= e[-1])
    else:
        codes = torch.searchsorted(e, by_t, side="right") - 1
        valid = (by_t >= e[0]) & (by_t < e[-1])
    return torch.where(valid, codes, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# prefactorized labels: the factorize-once artifact
# ---------------------------------------------------------------------------


class Prefactorized:
    """A factorization computed once and reused across reductions: codes,
    group tables, the sort engine's present table, and device stages.

    Pass it as the single ``by`` of ``groupby_reduce`` or
    ``groupby_aggregate_many``: those calls skip the factorization and the
    codes' copy to the device, because the dense codes (``codes_dev``) and
    the sort engine's compact codes (``ccodes_dev``) were staged on the
    device by :meth:`stage`. The host copies (``codes``, ``ccodes``) serve the
    numpy engine and restaging.
    """

    __slots__ = (
        "codes", "codes_dev", "ccodes", "ccodes_dev", "present", "ncap",
        "found_groups", "group_shape", "ngroups", "size", "n",
        "by_shape", "by_dtype", "props", "fingerprint",
    )

    @property
    def shape(self) -> tuple:
        return self.by_shape

    @property
    def dtype(self) -> np.dtype:
        return self.by_dtype

    @property
    def ndim(self) -> int:
        return len(self.by_shape)

    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Prefactorized(shape={self.by_shape}, ngroups={self.ngroups}, "
            f"size={self.size}, present={len(self.present)}, "
            f"staged={self.codes_dev is not None})"
        )

    def device_nbytes(self) -> int:
        """Bytes this artifact holds on its device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.codes_dev, self.ccodes_dev) if t is not None)

    def stage(self, device=None) -> "Prefactorized":
        """(Re-)stage the dense and compact codes on ``device`` (``cuda``
        unless the caller names another); idempotent by value."""
        dev = utils.resolve_device(device)
        self.codes_dev = torch.as_tensor(self.codes, device=dev)
        self.ccodes_dev = torch.as_tensor(self.ccodes, device=dev)
        return self

    def _derive(self, codes: np.ndarray, codes_dev, by_shape: tuple) -> "Prefactorized":
        """A selector view sharing this artifact's group tables: new codes,
        the same groups and size, the sort tables recomputed for the
        selection."""
        out = _new_artifact(codes, self.found_groups, self.group_shape, self.ngroups,
                            self.size, by_shape, self.by_dtype, self.props, None)
        out.codes_dev = codes_dev
        # the view's compact codes are new host values: one small copy
        out.ccodes_dev = (None if codes_dev is None
                          else torch.as_tensor(out.ccodes, device=codes_dev.device))
        return out

    def slice_rows(self, start: int, stop: int) -> "Prefactorized":
        """Row-range view over the flat span: host codes sliced, device codes
        sliced on the device."""
        start, stop = int(start), int(stop)
        if not (0 <= start < stop <= self.n):
            raise ValueError(f"row range [{start}, {stop}) out of bounds for span {self.n}")
        sub = np.ascontiguousarray(self.codes[start:stop])
        dev = self.codes_dev[start:stop] if self.codes_dev is not None else None
        return self._derive(sub, dev, (int(sub.size),))

    def select_mask(self, mask) -> "Prefactorized":
        """Boolean-mask view over the flat span: a gather of the staged codes
        on the device (only the small index vector is copied there)."""
        mask = utils.asarray_host(mask).astype(bool).reshape(-1)
        if int(mask.size) != self.n:
            raise ValueError(f"mask length {mask.size} != dataset span {self.n}")
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            raise ValueError("mask selects no rows")
        sub = np.ascontiguousarray(self.codes[idx])
        dev = None
        if self.codes_dev is not None:
            dev = self.codes_dev.index_select(
                0, torch.as_tensor(idx, device=self.codes_dev.device))
        return self._derive(sub, dev, (int(sub.size),))


def _new_artifact(codes_flat: np.ndarray, found_groups, group_shape, ngroups: int, size: int,
                  by_shape: tuple, by_dtype, props, fingerprint, present=None, ncap=None,
                  ccodes=None) -> Prefactorized:
    pf = Prefactorized()
    pf.codes = codes_flat
    pf.found_groups = tuple(found_groups)
    pf.group_shape = tuple(int(g) for g in group_shape)
    pf.ngroups = int(ngroups)
    pf.size = int(size)
    pf.n = int(codes_flat.size)
    pf.by_shape = tuple(int(s) for s in by_shape)
    pf.by_dtype = np.dtype(by_dtype)
    pf.props = props
    pf.fingerprint = fingerprint
    pf.present = (kernels.present_groups(codes_flat, pf.size) if present is None
                  else np.asarray(present, dtype=np.int64))
    pf.ncap = kernels.present_cap(len(pf.present), pf.size) if ncap is None else int(ncap)
    pf.ccodes = (kernels.compact_codes(codes_flat, pf.present) if ccodes is None
                 else np.ascontiguousarray(ccodes, dtype=np.int32))
    pf.codes_dev = None
    pf.ccodes_dev = None
    return pf


def prefactorize(by, expected_groups=None, *, sort: bool = True, stage: bool = True,
                 fingerprint: str | None = None, device=None) -> Prefactorized:
    """Factorize ``by`` once, with the sort engine's present tables and (by
    default) the codes staged on ``device`` (``cuda`` unless the caller names
    another).

    Reduces over all of ``by``'s axes: the kept axes of a reduction belong to
    the data's leading dims.
    """
    b = utils.asarray_host(by)
    if b.size == 0:
        raise ValueError("cannot prefactorize empty labels")
    expected_idx = None
    if expected_groups is not None:
        from .core import _convert_expected, _normalize_expected

        expected_idx = _convert_expected(_normalize_expected(expected_groups, 1), (False,), sort)
    codes, found_groups, grp_shape, ngroups, size, props = factorize_cached(
        (b,), axes=tuple(range(b.ndim)), expected_groups=expected_idx, sort=sort
    )
    if ngroups == 0 or size == 0:
        raise ValueError("No groups to reduce over (empty expected_groups?)")
    codes_flat = np.ascontiguousarray(np.asarray(codes).reshape(-1), dtype=np.int64)
    pf = _new_artifact(codes_flat, found_groups, grp_shape, ngroups, size, b.shape, b.dtype,
                       props, fingerprint)
    return pf.stage(device) if stage else pf


def prefactorized_from_host(fields: dict, *, stage: bool = True, device=None) -> Prefactorized:
    """A :class:`Prefactorized` from an artifact's host fields, as built by
    another implementation of the same factorization (the state carried
    across): ``codes``, ``ccodes``, ``present``, ``ncap``, ``found_groups``,
    ``group_shape``, ``ngroups``, ``size``, ``by_shape`` and ``by_dtype``.
    Group tables may be numpy arrays or pandas indexes (read as their
    values)."""
    codes = np.ascontiguousarray(utils.asarray_host(fields["codes"]).reshape(-1),
                                 dtype=np.int64)
    found = tuple(g if isinstance(g, Bins) else utils.asarray_host(getattr(g, "values", g))
                  for g in fields["found_groups"])
    nanmask = codes < 0
    props = FactorProps(offset_group=False, nan_sentinel=False,
                        nanmask=nanmask if nanmask.any() else None)
    pf = _new_artifact(codes, found, fields["group_shape"], fields["ngroups"], fields["size"],
                       fields["by_shape"], fields["by_dtype"], props, None,
                       present=utils.asarray_host(fields["present"]), ncap=fields["ncap"],
                       ccodes=utils.asarray_host(fields["ccodes"]))
    return pf.stage(device) if stage else pf


def clear_caches() -> None:
    """Drop the factorization memo (the device layer's ``reinitialize``)."""
    _FACTORIZE_CACHE.clear()
    _FACTORIZE_CACHE_BYTES[0] = 0
