"""Multi-statistic fusion: ``groupby_aggregate_many`` (the port of
``flox_tpu/fusion.py``).

A climatology asking for mean, std, min and max over the same labels would
read the data once per statistic through ``groupby_reduce``. Here the fusion
planner (``aggregations.plan_fused``) merges the requested statistics into
one deduplicated set of chunk legs: mean reads the variance triple's total
and count, presence counts collapse to one leg, and the sums, counts, minima
and maxima of float32/bfloat16 data come from one pass of the multi-statistic
kernel (``cuda_kernels.segment_multistat``). Each result equals the
corresponding ``groupby_reduce(..., func=f)`` call.

The chain is ``core.groupby_reduce``'s up to the kernels: labels normalized
and factorized on the host (or taken from a ``Prefactorized`` artifact, whose
codes are staged on the device), data flattened to (..., N) on the device. As
in the reference, ``engine="sort"`` runs this dense fused path, and a plan
whose dense (..., size) intermediates would pass
``dense_intermediate_bytes_max`` raises; ``engine="numpy"`` runs every leg on
the host engine and copies the results to the device. With ``method=``
("map-reduce" or "cohorts") or ``mesh=`` the whole plan runs as one mesh
program (``parallel.mapreduce``): one shard-local pass, one combine of the
deduplicated legs, the results replicated on every rank.

Telemetry sees the reference's spans (``groupby_aggregate_many`` over
``factorize``, ``dispatch`` or ``combine``, and ``finalize``); the fused
dispatch is billed to the cost ledger once for the whole statistic set, under
:func:`fused_program_label`, with its device time and cost card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import factorize as fct, telemetry, utils
from .aggregations import FUSABLE_FUNCS, FusedAggregation, fused_chunk_stats, plan_fused
from .core import (
    _assert_by_is_aligned,
    _astype_final,
    _choose_engine,
    _convert_expected,
    _group_values,
    _normalize_expected,
    _normalize_isbin,
    _normalize_reduce_axes,
    _resolve_devices,
    _staged,
    _tuned_engine,
    dense_intermediate_bytes,
)
from .options import OPTIONS
from .sparse import is_sparse_array

__all__ = ["FUSABLE_FUNCS", "finalize_many", "fused_program_label", "groupby_aggregate_many",
           "store_program_label"]

_ADDLIKE = frozenset({"sum", "nansum", "prod", "nanprod"})
_BOOLSAFE = frozenset({"all", "any", "count"})


def fused_program_label(funcs) -> str:
    """The cost-ledger program label of a fused statistic set."""
    return "fused[" + "+".join(funcs) + "]"


def store_program_label(kind: str, funcs) -> str:
    """The cost-ledger program label of a durable-store operation
    (``store.append[fused[sum+count]]``): the operation around the fused
    statistic set the store carries."""
    return f"store.{kind}[{fused_program_label(funcs)}]"


def finalize_many(fused: FusedAggregation, results, out_shape=None) -> dict:
    """Per-statistic final dtype casts (and reshape): ``{func: tensor}``."""
    out = {}
    for f, agg, r in zip(fused.funcs, fused.aggs, results):
        r = _astype_final(r, agg)
        if out_shape is not None and tuple(r.shape) != tuple(out_shape):
            r = r.reshape(out_shape)
        out[f] = r
    return out


def groupby_aggregate_many(
    array: Any,
    *by: Any,
    funcs: tuple | list = ("sum", "count", "min", "max", "var"),
    expected_groups: Any = None,
    sort: bool = True,
    isbin: Any = False,
    axis: Any = None,
    fill_value: Any = None,
    dtype: Any = None,
    min_count: int | None = None,
    engine: str | None = None,
    finalize_kwargs: dict | None = None,
    method: str | None = None,
    mesh: Any = None,
    axis_name: str | tuple[str, ...] = "data",
    device: Any = None,
) -> tuple:
    """N grouped statistics in one pass over the data (the signature of
    ``flox_tpu.groupby_aggregate_many``, plus ``device``).

    Returns ``(results, *groups)``: ``results`` maps each requested func, in
    request order, to a tensor on ``device``. ``funcs`` are names from
    :data:`FUSABLE_FUNCS`. ``fill_value``, ``dtype`` and ``finalize_kwargs``
    take one value for all statistics or a per-func dict, e.g.
    ``finalize_kwargs={"var": {"ddof": 1}}``. ``device`` defaults to ``cuda``
    and raises ``RuntimeError`` when CUDA is missing; pass ``device="cpu"`` to
    run on the CPU. ``method``/``mesh``/``axis_name`` run the plan over a
    mesh as ``groupby_reduce`` does (``method`` defaults to "map-reduce").

    Examples
    --------
    >>> import numpy as np
    >>> from flox_tpu_torch import groupby_aggregate_many
    >>> values = np.array([1.0, 2.0, 4.0, 8.0])
    >>> labels = np.array([0, 0, 1, 1])
    >>> out, groups = groupby_aggregate_many(
    ...     values, labels, funcs=("sum", "max"), device="cpu")
    >>> out["sum"]
    tensor([ 3., 12.], dtype=torch.float64)
    >>> out["max"]
    tensor([2., 8.], dtype=torch.float64)
    """
    with telemetry.span("groupby_aggregate_many", funcs=list(funcs), method=method):
        return _aggregate_many_impl(
            array, *by, funcs=tuple(funcs), expected_groups=expected_groups, sort=sort,
            isbin=isbin, axis=axis, fill_value=fill_value, dtype=dtype, min_count=min_count,
            engine=engine, finalize_kwargs=finalize_kwargs, method=method, mesh=mesh,
            axis_name=axis_name, device=device,
        )


def _mesh_fused(fused: FusedAggregation, arr_flat, codes_flat, size: int, out_shape: tuple,
                method, mesh, axis_name) -> dict:
    from .parallel.mapreduce import sharded_groupby_reduce

    with telemetry.span("combine", method=method or "map-reduce", size=size):
        results = sharded_groupby_reduce(arr_flat, codes_flat, fused, size=size, mesh=mesh,
                                         axis_name=axis_name, method=method or "map-reduce")
    with telemetry.span("finalize"):
        return finalize_many(fused, results, out_shape)


def _aggregate_many_impl(array, *by, funcs: tuple, expected_groups, sort, isbin, axis,
                         fill_value, dtype, min_count, engine, finalize_kwargs, method, mesh,
                         axis_name, device) -> tuple:
    if not by:
        raise TypeError("Must pass at least one `by`")
    if method not in (None, "map-reduce", "cohorts"):
        raise NotImplementedError(
            "groupby_aggregate_many supports method=None (eager) and 'map-reduce'/'cohorts' "
            "on a mesh; 'blockwise' finalizes per shard through the single-statistic "
            "kernels: run sequential groupby_reduce calls there."
        )
    if is_sparse_array(array):
        raise NotImplementedError(
            "sparse inputs are not fusable; run sequential groupby_reduce calls")
    nby = len(by)
    if nby == 1 and isinstance(by[0], fct.Prefactorized):
        return _aggregate_many_prefactorized(
            array, by[0], funcs=funcs, expected_groups=expected_groups, isbin=isbin, axis=axis,
            fill_value=fill_value, dtype=dtype, min_count=min_count, engine=engine,
            finalize_kwargs=finalize_kwargs, method=method, mesh=mesh, axis_name=axis_name,
            device=device,
        )
    engine_explicit = engine is not None
    engine = _choose_engine(engine)
    if not engine_explicit and method is None and mesh is None:
        engine = _tuned_engine(engine, array, device)
    mesh, dev, work = _resolve_devices(array, engine, method, mesh, device)

    bys = [utils.asarray_host(b) for b in by]
    bys = list(np.broadcast_arrays(*bys)) if nby > 1 else bys
    arr = _fusable_tensor(array, funcs, work)
    _assert_by_is_aligned(tuple(arr.shape), bys)
    expected = _normalize_expected(expected_groups, nby)
    expected_idx = _convert_expected(expected, _normalize_isbin(isbin, nby), sort)

    arr, bys, n_keep, bndim = _normalize_reduce_axes(arr, bys, axis)
    keep_by_shape = tuple(bys[0].shape[:n_keep])
    with telemetry.span("factorize", nby=nby) as fsp:
        codes, found_groups, grp_shape, ngroups, size, _props = fct.factorize_cached(
            tuple(bys), axes=tuple(range(n_keep, bndim)), expected_groups=expected_idx,
            sort=sort
        )
        fsp.set(ngroups=ngroups, size=size)
    if ngroups == 0 or size == 0:
        raise ValueError("No groups to reduce over (empty expected_groups?)")

    min_count_ = 0 if min_count is None else min_count
    fused = plan_fused(funcs, dtype, arr.dtype, fill_value, min_count_, finalize_kwargs)

    span = int(np.prod(bys[0].shape)) if bys[0].size else 0
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (span,))
    out_shape = lead_shape + keep_by_shape + grp_shape
    if _fused_loses(engine, arr_flat, size, mesh):
        return _sequential(array, by, funcs, fill_value=fill_value, dtype=dtype,
                           finalize_kwargs=finalize_kwargs, min_count=min_count,
                           expected_groups=expected_groups, sort=sort, isbin=isbin, axis=axis,
                           engine=engine, method=method, mesh=mesh, axis_name=axis_name,
                           device=device)
    if mesh is not None:
        out = _mesh_fused(fused, arr_flat, np.asarray(codes).reshape(-1), size, out_shape,
                          method, mesh, axis_name)
        return (out,) + _group_values(found_groups)
    codes_flat = torch.as_tensor(np.asarray(codes).reshape(-1), device=work)
    out = _run_fused(fused, codes_flat, arr_flat, size, out_shape, engine, dev)
    return (out,) + _group_values(found_groups)


def _fused_loses(engine: str, arr_flat: torch.Tensor, size: int, mesh=None) -> bool:
    """The autotuner's ``fused`` family (tuner on, dense engine, no mesh):
    whether sequential ``groupby_reduce`` calls won for this band. A mesh
    call is never asked: its ranks hold stores of their own, and a split
    between the fused and the sequential programs would hang their
    collectives. Nothing in the port records a ``fused`` observation (the
    reference's come from its bench), so only a loaded store file reaches
    the sequential branch."""
    if not (OPTIONS["autotune"] and engine == "torch" and mesh is None):
        return False
    from . import autotune

    choice = autotune.decide("fused", "fused", ("fused", "sequential"),
                             dtype=autotune.dtype_name(arr_flat.dtype), ngroups=size,
                             nelems=arr_flat.numel(), platform=arr_flat.device.type)
    return choice == "sequential"


def _sequential(array, by: tuple, funcs: tuple, *, fill_value, dtype, finalize_kwargs,
                min_count, **common) -> tuple:
    """One ``groupby_reduce`` per statistic: the losing branch of the
    ``fused`` family, and what the fused pass is measured against."""
    from .core import groupby_reduce

    def pick(v, f):
        return v.get(f) if isinstance(v, dict) else v

    results, groups = {}, ()
    for f in funcs:
        r, *groups = groupby_reduce(array, *by, func=f, fill_value=pick(fill_value, f),
                                    dtype=pick(dtype, f),
                                    finalize_kwargs=pick(finalize_kwargs, f),
                                    min_count=min_count, **common)
        results[f] = r
    return (results, *groups)


def _fusable_tensor(array, funcs: tuple, device: torch.device) -> torch.Tensor:
    """The data of a fused call as a tensor on ``device``: numeric only, and
    bools under core's rule, set-wide."""
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
        if array.dtype.kind in "OSUmM":
            raise NotImplementedError(
                f"groupby_aggregate_many supports numeric data; got {array.dtype} "
                "(datetime/object inputs keep the sequential groupby_reduce path)"
            )
    arr = utils.as_tensor(array, device)
    if arr.dtype == torch.bool:
        # core's bool rule, set-wide: additive reductions need the int view;
        # all/any/count are bool-native. A set mixing bools into float or
        # extrema statistics has no one input view that matches every
        # sequential call.
        if set(funcs) <= _BOOLSAFE:
            pass
        elif set(funcs) <= (_ADDLIKE | _BOOLSAFE):
            arr = arr.to(torch.int64)
        else:
            raise NotImplementedError(
                f"bool data fuses only {sorted(_ADDLIKE | _BOOLSAFE)}; run "
                f"{sorted(set(funcs) - _ADDLIKE - _BOOLSAFE)} sequentially"
            )
    return arr


def _aggregate_many_prefactorized(array, pf: "fct.Prefactorized", *, funcs: tuple,
                                  expected_groups, isbin, axis, fill_value, dtype, min_count,
                                  engine, finalize_kwargs, method, mesh, axis_name,
                                  device) -> tuple:
    """The fused statistics over a :class:`~flox_tpu_torch.factorize.
    Prefactorized` ``by``: the inline body from the engine choice on, minus
    the factorization and minus the codes' copy (the staged ``codes_dev``
    feeds the kernels)."""
    bad = [name for name, val in (("expected_groups", expected_groups), ("axis", axis))
           if val is not None]
    if isbin not in (False, (False,)):
        bad.append("isbin")
    if bad:
        raise NotImplementedError(
            f"Prefactorized `by` does not support {bad}: the factorization is fixed when "
            "the artifact is built (prefactorize again with other groups)"
        )
    engine = _choose_engine(engine)
    mesh, dev, work = _resolve_devices(array, engine, method, mesh, device)
    arr = _fusable_tensor(array, funcs, work)
    bndim = len(pf.by_shape)
    if arr.ndim < bndim or tuple(arr.shape[arr.ndim - bndim:]) != tuple(pf.by_shape):
        raise ValueError(
            f"`array` with shape {tuple(arr.shape)} does not align with the prefactorized "
            f"`by` shape {pf.by_shape}"
        )
    min_count_ = 0 if min_count is None else min_count
    fused = plan_fused(funcs, dtype, arr.dtype, fill_value, min_count_, finalize_kwargs)
    lead_shape = tuple(arr.shape[: arr.ndim - bndim])
    arr_flat = arr.reshape(lead_shape + (pf.n,))
    if _fused_loses(engine, arr_flat, pf.size, mesh):
        return _sequential(array, (pf,), funcs, fill_value=fill_value, dtype=dtype,
                           finalize_kwargs=finalize_kwargs, min_count=min_count, engine=engine,
                           method=method, mesh=mesh, axis_name=axis_name, device=device)
    if mesh is not None:
        staged = pf.codes_dev is not None and pf.codes_dev.device == dev and method != "cohorts"
        out = _mesh_fused(fused, arr_flat, pf.codes_dev if staged else pf.codes, pf.size,
                          lead_shape + pf.group_shape, method, mesh, axis_name)
        return (out,) + _group_values(pf.found_groups)
    out = _run_fused(fused, _staged(pf.codes_dev, pf.codes, work), arr_flat, pf.size,
                     lead_shape + pf.group_shape, engine, dev)
    return (out,) + _group_values(pf.found_groups)


def _run_fused(fused: FusedAggregation, codes_flat: torch.Tensor, arr_flat: torch.Tensor,
               size: int, out_shape: tuple, engine: str, dev: torch.device) -> dict:
    """The chunk legs and every finalize of a fused plan: on the host engine
    with one copy of each result to ``dev``, or dense on the device under the
    dense-intermediate ceiling (the sort engine included, as in the
    reference)."""
    if engine == "numpy":
        inters = fused_chunk_stats(fused, codes_flat, arr_flat, size=size, engine="numpy")
        with telemetry.span("finalize"):
            out = finalize_many(fused, fused.finalize_fused(inters), out_shape)
        return {f: r.to(dev) for f, r in out.items()}
    lead_elems = int(np.prod(arr_flat.shape[:-1]))
    est = dense_intermediate_bytes(lead_elems, size, arr_flat.dtype, fused)
    ceiling = OPTIONS["dense_intermediate_bytes_max"]
    if est > ceiling:
        raise ValueError(
            f"{fused.name!r} over {size} groups needs ~{utils.fmt_bytes(est)} "
            f"of dense (..., size) device intermediates, above the "
            f"{utils.fmt_bytes(ceiling)} dense_intermediate_bytes_max ceiling. "
            "Options: pass mesh=; reduce expected_groups; or raise "
            "set_options(dense_intermediate_bytes_max=...)."
        )

    from . import costmodel

    with telemetry.span("dispatch", engine="torch", nstats=len(fused.funcs), size=size):
        with telemetry.device_timer(arr_flat.device) as timer, costmodel.capture() as cap:
            results = fused.finalize_fused(
                fused_chunk_stats(fused, codes_flat, arr_flat, size=size, engine="torch"))
    if telemetry.enabled():
        # the data is billed once for the whole statistic set: that 1x-vs-Nx
        # ledger delta is the fusion win, per program label
        prog = fused_program_label(fused.funcs)
        telemetry.sample_hbm(program=prog)
        costmodel.ensure_card(prog, cap, arr_flat.device)
        telemetry.observe_cost(prog, timer=timer, nbytes=arr_flat.numel() * arr_flat.element_size()
                               + codes_flat.numel() * codes_flat.element_size())
    with telemetry.span("finalize"):
        return finalize_many(fused, results, out_shape)
