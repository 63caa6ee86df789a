"""Aggregation blueprints, registry and engine dispatch of the port (the
eager slice of ``flox_tpu/aggregations.py``).

An :class:`Aggregation` names the kernels of its eager path and its final
fill value and dtype. :func:`_initialize_aggregation` resolves those against
the input's dtype. The registry holds the reductions this slice ports; the
chunk/combine stages of the reference belong to the multi-device runtime
(ROADMAP A7) and the rest of the family to A2.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from . import dtypes, utils

__all__ = ["AGGREGATIONS", "Aggregation", "generic_aggregate", "_initialize_aggregation"]


def generic_aggregate(
    group_idx,
    array,
    *,
    engine: str,
    func: str | Callable,
    axis: int = -1,
    size: int,
    fill_value=None,
    dtype=None,
    **kwargs,
):
    """Engine dispatcher: a callable runs as it is; a name runs the torch
    engine's kernel of that name."""
    if callable(func):
        return func(
            group_idx, array, axis=axis, size=size, fill_value=fill_value, dtype=dtype, **kwargs
        )
    if engine != "torch":
        raise ValueError(f"Unknown engine {engine!r}; the port has only 'torch'.")
    from . import kernels

    return kernels.generic_kernel(
        func, group_idx, array, axis=axis, size=size, fill_value=fill_value, dtype=dtype, **kwargs
    )


@dataclass
class Aggregation:
    """Declarative recipe for one grouped reduction.

    ``numpy`` lists the kernels of the eager path; with more than one,
    ``finalize`` folds their results. Entries may be callables with the
    engine plugin signature ``f(group_idx, array, *, axis, size, fill_value,
    dtype, **kw)``. After :func:`_initialize_aggregation`, ``final_dtype`` is
    a torch dtype and ``final_fill_value`` a concrete scalar.
    """

    name: str
    numpy: tuple[str | Callable, ...] = ()
    finalize: Callable | None = None
    final_fill_value: Any = dtypes.NA
    final_dtype: Any = None
    preserves_dtype: bool = False
    # resolved by _initialize_aggregation:
    finalize_kwargs: dict[str, Any] = field(default_factory=dict)
    min_count: int = 0

    def __post_init__(self):
        if not self.numpy:
            self.numpy = (self.name,)


AGGREGATIONS: dict[str, Aggregation] = {}


def _register(agg: Aggregation) -> None:
    AGGREGATIONS[agg.name] = agg


_register(Aggregation("count", numpy=("nanlen",), final_fill_value=0, final_dtype=np.intp))
for _nm in ("sum", "nansum"):
    _register(Aggregation(_nm, final_fill_value=0))
for _nm in ("mean", "nanmean", "var", "nanvar", "std", "nanstd"):
    _register(Aggregation(_nm, final_fill_value=dtypes.NA))
for _nm in ("max", "nanmax", "min", "nanmin"):
    _register(Aggregation(_nm, final_fill_value=dtypes.NA, preserves_dtype=True))


def _initialize_aggregation(
    func: str | Aggregation,
    dtype,
    array_dtype: torch.dtype,
    fill_value,
    min_count: int,
    finalize_kwargs: dict[str, Any] | None,
) -> Aggregation:
    """Resolve a registry template into a concrete plan (parity: the
    reference's ``_initialize_aggregation``).

    Promotions and fill values are resolved in numpy dtypes; bfloat16, which
    numpy lacks, resolves through float32 and comes back as bfloat16 where
    the result keeps the input's float dtype.
    """
    if isinstance(func, Aggregation):
        agg = copy.deepcopy(func)
    else:
        try:
            agg = copy.deepcopy(AGGREGATIONS[func])
        except KeyError:
            raise NotImplementedError(
                f"aggregation {func!r} is not ported yet (the rest of the reduction "
                "family is ROADMAP A2)"
            ) from None

    agg.finalize_kwargs = dict(finalize_kwargs or {})
    agg.min_count = min_count
    bf16 = dtype is torch.bfloat16 or (dtype is None and array_dtype is torch.bfloat16)
    np_request = None if dtype is None else utils.numpy_dtype(dtype)
    np_array = utils.numpy_dtype(array_dtype)

    if agg.final_dtype is not None and dtype is None:
        final = np.dtype(agg.final_dtype)
    else:
        final = dtypes.normalize_dtype(
            np_request, np_array, preserves_dtype=agg.preserves_dtype, fill_value=fill_value
        )
        if not agg.preserves_dtype and agg.name not in ("sum", "nansum"):
            # mean/var/etc. of int data is float
            if agg.name != "count" and final.kind in "iub":
                final = np.result_type(final, np.float64)

    # with min_count the default fill must be a missing marker (NaN), not the
    # reduction identity: that is the whole point of min_count
    if fill_value is None:
        fill_value = dtypes.NA if min_count > 0 else agg.final_fill_value
    if fill_value in (dtypes.NA, dtypes.INF, dtypes.NINF):
        if fill_value is dtypes.NA:
            promoted, _ = dtypes.maybe_promote(final)
            fill_value = dtypes.get_fill_value(promoted, dtypes.NA)
        else:
            fill_value = dtypes.get_fill_value(final, fill_value)
    agg.final_fill_value = fill_value
    agg.final_dtype = (
        torch.bfloat16 if bf16 and final == np.float32 else utils.torch_dtype(final)
    )
    return agg
