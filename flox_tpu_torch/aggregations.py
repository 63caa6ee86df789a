"""Aggregation blueprints, registry and engine dispatch of the port (the
eager slice of ``flox_tpu/aggregations.py``).

An :class:`Aggregation` names the kernels of its eager path, its chunk legs
(what the fusion planner merges) and its final fill value and dtype.
:func:`_initialize_aggregation` resolves those against the input's dtype. The
registry holds the reference's whole family with its ``combine`` ops, the
merges that the multi-device runtime (``parallel.mapreduce``) applies across
shards. Order statistics (median, quantile, mode) are blockwise-only
(``chunk is None``): they need every element of a group at once, or, for
quantiles on a mesh, the distributed radix select.

Multi-statistic fusion (:func:`plan_fused`, :func:`fused_chunk_stats`) merges
N statistics into one deduplicated set of chunk legs for
``fusion.groupby_aggregate_many``; the scans' blueprints (:class:`Scan`) serve
``scan.groupby_scan``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Literal

import numpy as np
import torch

from . import dtypes, utils
from .multiarray import MultiArray

__all__ = [
    "AGGREGATIONS",
    "FUSABLE_FUNCS",
    "SCANS",
    "Aggregation",
    "FusedAggregation",
    "Scan",
    "fused_chunk_stats",
    "generic_aggregate",
    "is_supported_aggregation",
    "plan_fused",
    "set_nat_final_fill",
    "shift_nat_identity_fills",
    "_initialize_aggregation",
    "_initialize_scan",
]


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
    """Engine dispatcher: a callable runs as it is; a name runs the named
    engine's kernel of that name ("torch": dense over ``size`` groups;
    "sort": over the groups present, scattered back to ``size``; "numpy": the
    host engine, on CPU tensors, returning CPU tensors)."""
    if callable(func):
        return func(
            group_idx, array, axis=axis, size=size, fill_value=fill_value, dtype=dtype, **kwargs
        )
    from . import kernels

    if engine == "torch":
        return kernels.generic_kernel(
            func, group_idx, array, axis=axis, size=size, fill_value=fill_value, dtype=dtype,
            **kwargs
        )
    if engine == "sort":
        return kernels.sort_kernel(
            func, group_idx, array, axis=axis, size=size, fill_value=fill_value, dtype=dtype,
            **kwargs
        )
    if engine == "numpy":
        from . import engine_numpy

        if dtype is not None:
            dtype = utils.numpy_dtype(dtype)
        out = engine_numpy.generic_kernel(
            func, _to_host(group_idx), _to_host(array), axis=axis, size=size,
            fill_value=fill_value, dtype=dtype, **kwargs
        )
        if isinstance(out, MultiArray):
            return MultiArray(_from_host(a) for a in out.arrays)
        return _from_host(out)
    raise ValueError(f"Unknown engine {engine!r}; expected 'torch', 'sort' or 'numpy'.")


def _to_host(x) -> np.ndarray:
    """A CPU tensor (or array) as numpy for the host engine; bfloat16, which
    numpy lacks, as float32 (the engine accumulates it in float32 anyway)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _from_host(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclass
class Aggregation:
    """Declarative recipe for one grouped reduction.

    ``numpy`` lists the kernels of the eager path; with more than one,
    ``finalize`` folds their results. Entries may be callables with the
    engine plugin signature ``f(group_idx, array, *, axis, size, fill_value,
    dtype, **kw)``. ``chunk`` lists the intermediate legs with their
    ``fill_value["intermediate"]``, as the reference names them; the fusion
    planner and the mesh programs read them. ``combine`` holds one merge op
    per leg for the mesh programs: "sum", "max", "min", "prod", "var" (the
    Chan merge of the variance triple), "first"/"last", or a callable that
    folds the shards' stacked intermediates, ``op(stacked)`` with ``stacked``
    (n_shards, ..., size) -> (..., size); with chunk legs, ``finalize``
    turns the merged legs into the result. After
    :func:`_initialize_aggregation`,
    ``final_dtype`` is a torch dtype and ``final_fill_value`` a concrete
    scalar.
    """

    name: str
    numpy: tuple[str | Callable, ...] = ()
    chunk: tuple[Any, ...] = ()
    combine: tuple[Any, ...] | None = None
    finalize: Callable | None = None
    fill_value: dict[str, Any] = field(default_factory=dict)  # {"intermediate": (...)}
    final_fill_value: Any = dtypes.NA
    final_dtype: Any = None
    reduction_type: Literal["reduce", "argreduce"] = "reduce"
    preserves_dtype: bool = False
    new_dims_func: Callable | None = None  # finalize_kwargs -> sizes of new leading dims
    # resolved by _initialize_aggregation:
    finalize_kwargs: dict[str, Any] = field(default_factory=dict)
    min_count: int = 0

    def __post_init__(self):
        if not self.numpy:
            self.numpy = (self.name,)

    @property
    def blockwise_only(self) -> bool:
        """Order statistics have no chunk legs: they need every element of a
        group at once."""
        return self.chunk is None

    def new_dims(self) -> tuple[int, ...]:
        """Sizes of the leading dims the result gains (a vector ``q``)."""
        if self.new_dims_func is None:
            return ()
        return self.new_dims_func(**self.finalize_kwargs)


AGGREGATIONS: dict[str, Aggregation] = {}


def _register(agg: Aggregation) -> None:
    AGGREGATIONS[agg.name] = agg


def _inter(*fills) -> dict:
    return {"intermediate": fills}


def _mean_finalize(total, count, **kw) -> torch.Tensor:
    return total / count


def _var_finalize(ma: MultiArray, ddof=0, **kw) -> torch.Tensor:
    m2, _total, count = ma.arrays
    denom = count - ddof
    out = m2 / torch.where(denom > 0, denom, 1)
    return torch.where(denom > 0, out, float("nan"))


def _std_finalize(ma: MultiArray, ddof=0, **kw) -> torch.Tensor:
    return torch.sqrt(_var_finalize(ma, ddof=ddof))


_register(Aggregation("count", numpy=("nanlen",), chunk=("nanlen",), combine=("sum",),
                      fill_value=_inter(0), final_fill_value=0, final_dtype=np.intp))
for _nm in ("sum", "nansum"):
    _register(Aggregation(_nm, chunk=(_nm,), combine=("sum",), fill_value=_inter(0),
                          final_fill_value=0))
for _nm in ("prod", "nanprod"):
    _register(Aggregation(_nm, chunk=(_nm,), combine=("prod",), fill_value=_inter(1),
                          final_fill_value=1))
for _nm, _sum, _len in (("mean", "sum", "len"), ("nanmean", "nansum", "nanlen")):
    _register(Aggregation(_nm, chunk=(_sum, _len), combine=("sum", "sum"),
                          finalize=_mean_finalize, fill_value=_inter(0, 0),
                          final_fill_value=dtypes.NA))
for _nm in ("var", "nanvar", "std", "nanstd"):
    _register(Aggregation(_nm, chunk=(("var_chunk", {"skipna": _nm.startswith("nan")}),),
                          combine=("var",),
                          finalize=_std_finalize if "std" in _nm else _var_finalize,
                          fill_value=_inter(0), final_fill_value=dtypes.NA))
for _nm, _sentinel in (("max", dtypes.NINF), ("nanmax", dtypes.NINF), ("min", dtypes.INF),
                       ("nanmin", dtypes.INF)):
    _register(Aggregation(_nm, chunk=(_nm,), combine=(_nm.removeprefix("nan"),),
                          fill_value=_inter(_sentinel), final_fill_value=dtypes.NA,
                          preserves_dtype=True))
_register(Aggregation("all", chunk=("all",), combine=("min",), fill_value=_inter(True),
                      final_fill_value=True, final_dtype=np.bool_))
_register(Aggregation("any", chunk=("any",), combine=("max",), fill_value=_inter(False),
                      final_fill_value=False, final_dtype=np.bool_))


def _pick_second(a, b, **kw):
    """The argreductions' finalize: of the (extreme value, position) legs, the
    position."""
    return b


def _quantile_new_dims(q=0.5, **kw) -> tuple[int, ...]:
    return () if np.ndim(q) == 0 else (len(q),)


# argreductions: the eager path is the kernel itself; the chunk legs pair the
# extreme value with its position, which the mesh programs merge across shards
# (parallel.mapreduce._combine_arg)
for _nm in ("argmax", "argmin", "nanargmax", "nanargmin"):
    _register(Aggregation(_nm, chunk=(_nm.replace("arg", ""), _nm),
                          combine=(_nm.removeprefix("nan"),),
                          finalize=_pick_second, reduction_type="argreduce",
                          fill_value=_inter(dtypes.NINF if "max" in _nm else dtypes.INF, -1),
                          final_fill_value=-1, final_dtype=np.intp))
for _nm in ("first", "last", "nanfirst", "nanlast"):
    _register(Aggregation(_nm, chunk=(_nm,), combine=(_nm.removeprefix("nan"),),
                          fill_value=_inter(dtypes.NA), final_fill_value=dtypes.NA,
                          preserves_dtype=True))
# order statistics: blockwise-only (chunk=None), as in the reference
for _nm in ("median", "nanmedian"):
    _register(Aggregation(_nm, chunk=None, final_fill_value=dtypes.NA))
for _nm in ("quantile", "nanquantile"):
    _register(Aggregation(_nm, chunk=None, final_fill_value=dtypes.NA,
                          new_dims_func=_quantile_new_dims))
for _nm in ("mode", "nanmode"):
    _register(Aggregation(_nm, chunk=None, final_fill_value=dtypes.NA, preserves_dtype=True))


def is_supported_aggregation(func: str) -> bool:
    """Whether ``func`` names an aggregation of the registry."""
    return func in AGGREGATIONS


def set_nat_final_fill(agg: Aggregation, fill_value) -> None:
    """Dtype-preserving datetime reductions: the missing marker is NaT
    (INT64_MIN on the int64 view), never float NaN, which would corrupt
    nanosecond timestamps; an explicit datetime or NaT fill is viewed as its
    int64 value. The final dtype is the int64 view."""
    if fill_value is None:
        agg.final_fill_value = np.iinfo(np.int64).min
    elif isinstance(agg.final_fill_value, (np.datetime64, np.timedelta64)):
        agg.final_fill_value = int(agg.final_fill_value.astype("int64"))
    agg.final_dtype = torch.int64


def shift_nat_identity_fills(agg: Aggregation) -> None:
    """The NINF-resolved empty fill of an int64 leg (INT64_MIN) is the NaT
    marker itself: shift it by one, so that a group absent from one shard is
    not taken for a NaT-holding one when the mesh combine re-injects NaT."""
    nat = np.iinfo(np.int64).min
    agg.fill_value["intermediate"] = tuple(
        (fv + 1 if isinstance(fv, (int, np.integer)) and fv == nat else fv)
        for fv in agg.fill_value.get("intermediate", ())
    )


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
            raise ValueError(f"Unsupported aggregation: {func!r}") from None

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
        if not agg.preserves_dtype and agg.name not in ("sum", "nansum", "prod", "nanprod"):
            # mean/var/etc. of int data is float
            if agg.name not in ("count", "all", "any") and final.kind in "iub":
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
    # intermediate fills against the working dtype: the input's for the
    # dtype-preserving reductions and for the argreductions (whose first leg
    # is the extreme value), else the final one
    work = np_array if agg.preserves_dtype or agg.reduction_type == "argreduce" else final
    agg.fill_value = {"intermediate": tuple(
        dtypes.get_fill_value(work, fv) if fv in (dtypes.NA, dtypes.INF, dtypes.NINF) else fv
        for fv in agg.fill_value.get("intermediate", ())
    )}
    return agg


# ---------------------------------------------------------------------------
# multi-statistic fusion: one chunk plan serving N requested statistics
# ---------------------------------------------------------------------------

#: statistics the fusion planner can merge into one chunk plan. Argreductions,
#: first/last and order statistics keep their sequential paths.
FUSABLE_FUNCS = frozenset(
    {
        "sum", "nansum", "prod", "nanprod", "count",
        "min", "nanmin", "max", "nanmax",
        "mean", "nanmean", "var", "nanvar", "std", "nanstd",
        "all", "any",
    }
)

_SKIPNA_FUNCS = frozenset(
    {"nansum", "nanprod", "count", "nanmin", "nanmax", "nanmean", "nanvar", "nanstd"}
)

_VAR_FUNCS = frozenset({"var", "nanvar", "std", "nanstd"})

#: chunk legs that the one-pass kernels (segment-sum, multi-statistic) serve
_ONE_PASS_LEGS = frozenset({"sum", "nansum", "min", "nanmin", "max", "nanmax", "len", "nanlen"})


@dataclass
class FusedAggregation(Aggregation):
    """A multi-output aggregation: one deduplicated chunk plan serving N
    requested statistics (see :func:`plan_fused`).

    ``chunk`` / ``fill_value["intermediate"]`` / ``eager_dtypes`` describe the
    legs; ``slots`` maps each statistic, in request order, to its legs, and
    :meth:`finalize_fused` folds the legs into the per-statistic results.
    """

    aggs: tuple = ()
    funcs: tuple = ()
    slots: tuple = ()
    eager_dtypes: tuple = ()

    def finalize_fused(self, inters) -> tuple:
        """Legs -> the finalized per-statistic results, request order. Every
        statistic reads its own presence leg: skipna and propagating
        statistics disagree about what "empty" means."""
        return tuple(
            _finalize_slot(agg, slot, inters, self.min_count)
            for agg, slot in zip(self.aggs, self.slots)
        )


def _read_leg(inters, addr):
    """A leg address: an int (the whole leg) or (leg, leaf) into a
    :class:`MultiArray` leg (the variance triple's total and count)."""
    if isinstance(addr, tuple):
        leg, leaf = addr
        return inters[leg].arrays[leaf]
    return inters[addr]


def _masked_fill(result: torch.Tensor, empty, fill_value) -> torch.Tensor:
    """``fill_value`` where ``empty``, under the final-fill promotion rules: a
    NaN fill promotes an integer or bool result to float64, any other float
    fill is cast to the result dtype."""
    if fill_value is None:
        return result
    inexact = result.is_floating_point() or result.is_complex()
    if utils.is_nan_fill(fill_value) and not inexact:
        result = result.to(torch.float64)
    fv = torch.as_tensor(fill_value).to(device=result.device, dtype=result.dtype)
    return torch.where(torch.as_tensor(empty, device=result.device), fv, result)


def _finalize_slot(agg: Aggregation, slot: dict, inters, min_count: int) -> torch.Tensor:
    """One statistic's result from the legs."""
    kind = slot["kind"]
    if kind == "var":
        ma = inters[slot["leg"]]
        fin = _std_finalize if slot["std"] else _var_finalize
        out = fin(ma, **agg.finalize_kwargs)
        present = ma.arrays[2] > 0
    elif kind == "mean":
        total = _read_leg(inters, slot["sum"])
        cnt = _read_leg(inters, slot["count"])
        out = total / cnt.to(total.dtype)
        present = cnt > 0
    elif kind == "count":
        out = inters[slot["leg"]]
        present = out > 0
    else:  # "direct": sum/prod/min/max/all/any, the leg is the value
        out = inters[slot["leg"]]
        present = _read_leg(inters, slot["present"]) > 0
    out = _masked_fill(out, ~present, agg.final_fill_value)
    if min_count > 0:
        out = _masked_fill(out, inters[slot["nanlen"]] < min_count, agg.final_fill_value)
    return out


def plan_fused(funcs, dtype, array_dtype, fill_value, min_count: int,
               finalize_kwargs) -> FusedAggregation:
    """Merge N statistic blueprints into one chunk plan (parity: the
    reference's ``plan_fused``).

    ``fill_value``, ``dtype`` and ``finalize_kwargs`` may be per-statistic
    dicts (``{"var": ...}``) or one value for all. Identical legs collapse;
    when a variance-family statistic shares its skipna mode with mean, mean
    reads the variance triple's (total, count) leaves instead of adding legs.
    """
    funcs = tuple(funcs)
    if not funcs:
        raise ValueError("groupby_aggregate_many needs at least one func")
    if len(set(funcs)) != len(funcs):
        raise ValueError(f"duplicate funcs in {funcs!r}")
    bad = [f for f in funcs if not isinstance(f, str) or f not in FUSABLE_FUNCS]
    if bad:
        raise NotImplementedError(
            f"cannot fuse {bad!r}: fusable statistics are {sorted(FUSABLE_FUNCS)} "
            "(argreductions, first/last and order statistics keep their sequential paths)"
        )

    def per_func(v, f):
        return v.get(f) if isinstance(v, dict) else v

    aggs = tuple(
        _initialize_aggregation(f, per_func(dtype, f), array_dtype, per_func(fill_value, f),
                                min_count, per_func(finalize_kwargs, f) or {})
        for f in funcs
    )

    legs: list[tuple] = []  # (entry, combine, fill, eager_dtype)
    index: dict[tuple, int] = {}

    def add_leg(entry, combine, fill, eager_dtype=None) -> int:
        name, kw = (entry[0], tuple(sorted(entry[1].items()))) if isinstance(entry, tuple) \
            else (entry, ())
        key = (name, kw, repr(fill), None if eager_dtype is None else str(eager_dtype))
        if key not in index:
            index[key] = len(legs)
            legs.append((entry, combine, fill, eager_dtype))
        return index[key]

    # variance triples first, so that mean can read their leaves
    var_leg: dict[bool, int] = {}
    for f, agg in zip(funcs, aggs):
        if f in _VAR_FUNCS:
            skipna = f in _SKIPNA_FUNCS
            var_leg.setdefault(skipna, add_leg(agg.chunk[0], "var",
                                               agg.fill_value["intermediate"][0]))
    nanlen_leg = add_leg("nanlen", "sum", 0) if min_count > 0 else None

    slots: list[dict] = []
    for f, agg in zip(funcs, aggs):
        skipna = f in _SKIPNA_FUNCS
        if f in _VAR_FUNCS:
            slot = {"kind": "var", "leg": var_leg[skipna], "std": f in ("std", "nanstd")}
        elif f in ("mean", "nanmean"):
            if skipna in var_leg:
                t = var_leg[skipna]
                slot = {"kind": "mean", "sum": (t, 1), "count": (t, 2)}
            else:
                # the float work dtype, so int inputs promote as the mean kernel does
                s = add_leg(agg.chunk[0], "sum", 0, eager_dtype=agg.final_dtype)
                slot = {"kind": "mean", "sum": s, "count": add_leg(agg.chunk[1], "sum", 0)}
        elif f == "count":
            slot = {"kind": "count", "leg": add_leg("nanlen", "sum", 0)}
        else:
            edt = agg.final_dtype if f in ("sum", "nansum", "prod", "nanprod") else None
            leg = add_leg(agg.chunk[0], agg.combine[0], agg.fill_value["intermediate"][0],
                          eager_dtype=edt)
            # nanmin/nanmax of an all-NaN group is missing, but nansum/nanprod
            # of one is the identity: only zero-element groups take the fill
            presence = "nanlen" if f in ("nanmin", "nanmax") else "len"
            slot = {"kind": "direct", "leg": leg, "present": add_leg(presence, "sum", 0)}
        if min_count > 0:
            slot["nanlen"] = nanlen_leg
        slots.append(slot)

    return FusedAggregation(
        name="fused[" + "+".join(funcs) + "]",
        numpy=funcs,
        chunk=tuple(leg[0] for leg in legs),
        combine=tuple(leg[1] for leg in legs),
        fill_value={"intermediate": tuple(leg[2] for leg in legs)},
        final_fill_value=0,
        min_count=min_count,
        aggs=aggs,
        funcs=funcs,
        slots=tuple(slots),
        eager_dtypes=tuple(leg[3] for leg in legs),
    )


def fused_chunk_stats(agg: FusedAggregation, group_idx, array, *, size: int,
                      engine: str = "torch") -> list:
    """Run the fused chunk plan: one intermediate per leg.

    The legs that one kernel pass can serve (sums, counts, min and max of the
    same float data, with no pending dtype cast) go to
    ``kernels.fused_segment_stats`` together: one segment-sum pass, or one
    multi-statistic pass when a min or max leg is among them. The other legs,
    all of them when the kernels' guards fail, and every leg of the host
    engine (``engine="numpy"``), run one reduction each.
    """
    from . import kernels

    names = [leg[0] if isinstance(leg, tuple) else leg for leg in agg.chunk]
    one_pass = [
        n in _ONE_PASS_LEGS and agg.eager_dtypes[i] in (None, array.dtype)
        for i, n in enumerate(names)
    ]
    fused: dict[int, torch.Tensor] = {}
    wanted = tuple(dict.fromkeys(n for n, ok in zip(names, one_pass) if ok))
    if engine == "torch" and len(wanted) >= 2:
        got = kernels.fused_segment_stats(group_idx, array, size=size, want=wanted)
        if got is not None:
            fused = {i: got[n] for i, (n, ok) in enumerate(zip(names, one_pass)) if ok}

    inters = []
    for i, (entry, fv) in enumerate(zip(agg.chunk, agg.fill_value["intermediate"])):
        if i in fused:
            inters.append(fused[i])
            continue
        name, extra = (entry[0], dict(entry[1])) if isinstance(entry, tuple) else (entry, {})
        inters.append(
            generic_aggregate(group_idx, array, engine=engine, func=name, size=size,
                              fill_value=fv, dtype=agg.eager_dtypes[i], **extra)
        )
    return inters


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


@dataclass
class Scan:
    """Blueprint of a grouped scan (parity: the reference's ``Scan``).

    ``scan`` is the within-device kernel; ``reduction``, ``binary_op`` and
    ``identity`` describe the carry across shards of the multi-device scan
    (``parallel.scan``); ``mode`` says how a carry combines with a block.
    """

    name: str
    scan: str
    reduction: str
    binary_op: Callable | None
    identity: Any
    mode: Literal["apply_binary_op", "ffill"] = "apply_binary_op"
    preserves_dtype: bool = False


SCANS: dict[str, Scan] = {
    "cumsum": Scan("cumsum", scan="cumsum", reduction="sum", binary_op=None, identity=0),
    "nancumsum": Scan("nancumsum", scan="nancumsum", reduction="nansum", binary_op=None,
                      identity=0),
    "ffill": Scan("ffill", scan="ffill", reduction="nanlast", binary_op=None, identity=np.nan,
                  mode="ffill", preserves_dtype=True),
    "bfill": Scan("bfill", scan="bfill", reduction="nanfirst", binary_op=None, identity=np.nan,
                  mode="ffill", preserves_dtype=True),
}


def _initialize_scan(func: str | Scan) -> Scan:
    if isinstance(func, Scan):
        return copy.deepcopy(func)
    try:
        return copy.deepcopy(SCANS[func])
    except KeyError:
        raise ValueError(f"Unsupported scan: {func!r}") from None
