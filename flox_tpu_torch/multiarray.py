"""MultiArray: a tuple of tensors that flows through the reduction machinery as
one value, and PresentGroups: the host form of the sort engine's compact
results (counterpart of ``flox_tpu/multiarray.py``).

The port uses MultiArray for the variance triple ``(m2, total, count)`` that
``kernels.var_chunk`` returns and that ``aggregations._finalize_slot`` reads.
PresentGroups, :func:`_combine_identity` and :func:`merge_present_var` are
numpy, copied from the reference.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MultiArray", "PresentGroups", "merge_present_var"]


class MultiArray:
    __slots__ = ("arrays",)

    def __init__(self, arrays) -> None:
        self.arrays = tuple(arrays)

    def __repr__(self) -> str:
        return f"MultiArray({self.arrays!r})"


# ---------------------------------------------------------------------------
# PresentGroups: the compact (present-groups) layer of the sort engine
# ---------------------------------------------------------------------------


def _combine_identity(op: str, dtype):
    """Identity element of a combine op: what a group absent from one side of
    a merge contributes (min/max as ``kernels.minmax_identity``, in numpy)."""
    dt = np.dtype(dtype)
    if op == "sum":
        return dt.type(0)
    if op == "prod":
        return dt.type(1)
    if op in ("max", "min"):
        if dt.kind == "f":
            return dt.type(-np.inf if op == "max" else np.inf)
        info = np.iinfo(dt)
        return dt.type(info.min if op == "max" else info.max)
    raise ValueError(f"no identity for combine op {op!r}")


class PresentGroups:
    """A ``(present_codes, values)`` pair: one grouped-reduction layer whose
    trailing axis covers only the groups actually present, not the label
    universe.

    ``present``: sorted unique dense codes, shape ``(n_present,)``.
    ``values``: ``(..., cap)`` with ``cap >= n_present``; column ``j < n_present``
    belongs to dense group ``present[j]``. When ``cap > n_present`` the first
    pad column carries the pipeline's empty-group value, which
    :meth:`scatter_dense` uses as the dense fill, so the expansion equals a
    dense run bit for bit. ``size``: the dense label universe.
    """

    __slots__ = ("present", "values", "size")

    def __init__(self, present, values, size: int) -> None:
        self.present = np.asarray(present).reshape(-1)
        self.values = values
        self.size = int(size)
        if np.asarray(values).shape[-1] < len(self.present):
            raise ValueError(
                f"values trailing axis {np.asarray(values).shape[-1]} cannot "
                f"hold {len(self.present)} present groups"
            )

    @property
    def n_present(self) -> int:
        return int(self.present.shape[0])

    def __repr__(self) -> str:
        return (
            f"PresentGroups(n_present={self.n_present}, size={self.size}, "
            f"values={np.asarray(self.values).shape})"
        )

    def scatter_dense(self):
        """Expand to the dense ``(..., size)`` layout, host-side: absent groups
        take the first pad column's (empty-group) value."""
        res = np.asarray(self.values)
        npres = self.n_present
        if npres >= self.size:
            return np.ascontiguousarray(res[..., : self.size])
        if res.shape[-1] <= npres:
            raise ValueError(
                "scatter_dense needs >= 1 pad column when groups are absent "
                f"(cap {res.shape[-1]}, n_present {npres})"
            )
        fill = res[..., npres : npres + 1]
        out = np.empty(res.shape[:-1] + (self.size,), dtype=res.dtype)
        out[...] = fill
        out[..., self.present] = res[..., :npres]
        return out

    def merge(self, other: "PresentGroups", combine: str) -> "PresentGroups":
        """Union-merge two present-group intermediates under one combine op
        ("sum" | "prod" | "max" | "min"): a group absent from one side
        contributes the op's identity, and the union is re-banded with a pad
        column carrying the identity, so the merged layer scatters like any
        other. Finalized values (a mean, a variance) do not merge: merge the
        intermediates and finalize once."""
        if self.size != other.size:
            raise ValueError(f"universe mismatch: {self.size} != {other.size}")
        union = np.union1d(self.present, other.present)
        n_u = len(union)
        a = np.asarray(self.values)
        b = np.asarray(other.values)
        dtype = np.result_type(a.dtype, b.dtype)
        ident = _combine_identity(combine, dtype)
        cap = n_u + 1 if n_u < self.size else n_u
        lead = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        out = np.full(lead + (cap,), ident, dtype=dtype)
        ia = np.searchsorted(union, self.present)
        ib = np.searchsorted(union, other.present)
        out[..., ia] = a[..., : self.n_present]
        bb = np.broadcast_to(b[..., : other.n_present], lead + (other.n_present,))
        sel = out[..., ib]
        if combine == "sum":
            out[..., ib] = sel + bb
        elif combine == "prod":
            out[..., ib] = sel * bb
        elif combine == "max":
            out[..., ib] = np.maximum(sel, bb)
        elif combine == "min":
            out[..., ib] = np.minimum(sel, bb)
        else:
            raise ValueError(f"unsupported combine op {combine!r}")
        return PresentGroups(union, out, self.size)


def merge_present_var(a, b):
    """Chan-merge two var-triple layers on the union of their present sets.

    ``a`` and ``b`` are ``(m2, total, count)`` triples of
    :class:`PresentGroups`, each side's three leaves sharing one present
    table. A group absent from a side contributes the empty triple
    ``(0, 0, 0)``, the Chan identity.
    """
    m2a, ta, na = a
    m2b, tb, nb = b
    if ta.size != tb.size:
        raise ValueError(f"universe mismatch: {ta.size} != {tb.size}")
    union = np.union1d(ta.present, tb.present)
    n_u = len(union)
    cap = n_u + 1 if n_u < ta.size else n_u
    ft = np.result_type(np.asarray(m2a.values).dtype, np.asarray(m2b.values).dtype)

    def _expand(pg: PresentGroups, dtype):
        v = np.asarray(pg.values)
        out = np.zeros(v.shape[:-1] + (cap,), dtype=dtype)
        out[..., np.searchsorted(union, pg.present)] = v[..., : pg.n_present]
        return out

    em2a, eta, ena = (_expand(x, ft) for x in (m2a, ta, na))
    em2b, etb, enb = (_expand(x, ft) for x in (m2b, tb, nb))
    nab = ena + enb
    tab = eta + etb
    with np.errstate(invalid="ignore", divide="ignore"):
        mua = eta / np.where(ena > 0, ena, 1)
        mub = etb / np.where(enb > 0, enb, 1)
        muab = tab / np.where(nab > 0, nab, 1)
        m2 = em2a + em2b + ena * (mua - muab) ** 2 + enb * (mub - muab) ** 2
    return tuple(PresentGroups(union, arr, ta.size) for arr in (m2, tab, nab))
