"""The plain reference: grouped reductions in float64, in row blocks.

Plain PyTorch (``index_add_``, ``scatter_reduce_``), on whatever device the
data is on. It builds its own codes from the labels the harness hands to
both sides, and imports nothing of the program under test. Each func here
gives the float64 result of one block of rows; :func:`judge` holds the
program's result to it.

The control (:func:`reduce_block` with ``precision="bfloat16"``) is the same
reference with its inputs rounded to bfloat16 and its sums kept in float32,
as a kernel that stores the data in bfloat16 would compute it.
"""

from __future__ import annotations

import numpy as np
import torch


def codes_of(by: list[np.ndarray]) -> tuple[np.ndarray, list[np.ndarray], tuple[int, ...]]:
    """Codes over the sorted unique values of each grouper, raveled."""
    uniques, inverses = [], []
    for b in by:
        u, inv = np.unique(np.asarray(b).reshape(-1), return_inverse=True)
        uniques.append(u)
        inverses.append(inv)
    shape = tuple(len(u) for u in uniques)
    codes = np.ravel_multi_index(tuple(inverses), shape) if len(by) > 1 else inverses[0]
    return codes.astype(np.int64), uniques, shape


def _sums(x: torch.Tensor, codes: torch.Tensor, size: int, acc) -> torch.Tensor:
    out = torch.zeros((x.shape[0], size), dtype=acc, device=x.device)
    return out.index_add_(1, codes, x.to(acc))


def _extreme(x: torch.Tensor, codes: torch.Tensor, size: int, op: str, skipna: bool,
             acc) -> torch.Tensor:
    x = x.to(acc)
    nan = torch.isnan(x)
    fill = float("-inf") if op == "amax" else float("inf")
    idx = codes.expand_as(x)
    out = torch.full((x.shape[0], size), fill, dtype=acc, device=x.device)
    out.scatter_reduce_(1, idx, torch.where(nan, fill, x), op, include_self=True)
    counts = _sums((~nan).to(acc), codes, size, acc)
    if skipna:
        return torch.where(counts > 0, out, float("nan"))
    nans = _sums(nan.to(acc), codes, size, acc)
    return torch.where(nans > 0, float("nan"), out)


def _moments(x: torch.Tensor, codes: torch.Tensor, size: int, skipna: bool, acc):
    x = x.to(acc)
    valid = ~torch.isnan(x) if skipna else torch.ones_like(x, dtype=torch.bool)
    xs = torch.where(valid, x, 0.0) if skipna else x
    n = _sums(valid.to(acc), codes, size, acc)
    s = _sums(xs, codes, size, acc)
    return xs, valid, n, s


def _mean(x, codes, size, skipna, acc):
    _, _, n, s = _moments(x, codes, size, skipna, acc)
    return s / n


def _var(x, codes, size, skipna, acc, ddof=0):
    xs, valid, n, s = _moments(x, codes, size, skipna, acc)
    mean = s / n
    dev = torch.where(valid, xs - mean.index_select(1, codes), 0.0)
    m2 = _sums(dev * dev, codes, size, acc)
    return m2 / (n - ddof)


FUNCS = {
    "sum": lambda x, c, g, a: _sums(x, c, g, a),
    "nansum": lambda x, c, g, a: _sums(torch.nan_to_num(x.to(a), nan=0.0), c, g, a),
    "count": lambda x, c, g, a: _sums((~torch.isnan(x)).to(a), c, g, a),
    "mean": lambda x, c, g, a: _mean(x, c, g, False, a),
    "nanmean": lambda x, c, g, a: _mean(x, c, g, True, a),
    "var": lambda x, c, g, a: _var(x, c, g, False, a),
    "nanvar": lambda x, c, g, a: _var(x, c, g, True, a),
    "std": lambda x, c, g, a: torch.sqrt(_var(x, c, g, False, a)),
    "nanstd": lambda x, c, g, a: torch.sqrt(_var(x, c, g, True, a)),
    "max": lambda x, c, g, a: _extreme(x, c, g, "amax", False, a),
    "nanmax": lambda x, c, g, a: _extreme(x, c, g, "amax", True, a),
    "min": lambda x, c, g, a: _extreme(x, c, g, "amin", False, a),
    "nanmin": lambda x, c, g, a: _extreme(x, c, g, "amin", True, a),
}


def reduce_block(x: torch.Tensor, codes: torch.Tensor, size: int, func: str,
                 precision: str = "float64") -> torch.Tensor:
    """``func`` of each row of ``x`` (rows, N) over ``codes`` (N,) into
    ``size`` groups: float64, or the bfloat16 control."""
    if precision == "float64":
        return FUNCS[func](x, codes, size, torch.float64)
    if precision == "bfloat16":
        return FUNCS[func](x.to(torch.bfloat16).to(torch.float32), codes, size, torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


class Judge:
    """Running comparison of a result, block by block, with the reference.

    ``max_rel_err``: the widest gap ``|got - want| / max(|want|, scale)`` over
    the outputs that are finite on both sides (``scale``: the field's spread,
    so a mean near zero is not divided by zero). ``nonfinite_mismatch``: the
    outputs finite on one side only, or NaN on one side and infinite on the
    other."""

    def __init__(self, scale: float):
        self.scale = float(scale)
        self.max_rel_err = 0.0
        self.nonfinite_mismatch = 0
        self.compared = 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        got = got.to(torch.float64)
        fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
        both = fin_g & fin_w
        bad = (fin_g != fin_w) | (~fin_g & ~fin_w & (torch.isnan(got) != torch.isnan(want)))
        self.nonfinite_mismatch += int(bad.sum())
        if bool(both.any()):
            gap = (got - want).abs() / want.abs().clamp_min(self.scale)
            self.max_rel_err = max(self.max_rel_err, float(gap[both].max()))
        self.compared += want.numel()
