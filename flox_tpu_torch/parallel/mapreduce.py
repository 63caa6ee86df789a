"""Sharded groupby reductions: the mesh programs of the multi-device runtime
(L5), the port of ``flox_tpu/parallel/mapreduce.py``.

The reference's three execution methods map onto programs as follows:

* ``map-reduce``: a shard-local chunk reduce producing dense (..., size)
  intermediates, then collectives as the combine: ``psum`` for additive legs,
  ``pmax``/``pmin`` for extrema (with the NaN/NaT channel re-injected), a
  two-psum Chan merge for the variance triple, (value, global position)
  pairs for argreductions and first/last, and an all_gather plus fold for
  ``prod`` and user callables. Quantiles and medians run here too: their
  radix-select counting passes are psum'd (``kernels._quantile_impl``).
* ``cohorts``: ``psum_scatter`` distributes group ownership (aligned with the
  detected cohorts by ``cohorts.ownership_permutation``); each rank finalizes
  its tile of groups, and the tiles are all-gathered. Above the
  dense-intermediate ceiling, additive reductions run the blocked
  owner-by-owner program: a loop over the owner blocks, one reduction of
  the shard and one psum per block, so no (..., size) intermediate exists.
* ``blockwise``: no combine; valid when every group lies on one shard (after
  ``rechunk.reshard_for_blockwise``); the shard that saw a group owns it.

Every rank calls :func:`sharded_groupby_reduce` with the same global inputs.
A rank reduces only its columns ``[r*L, min((r+1)*L, N))``, ``L = ceil(N /
n_shards)``, moving only those to its device (no padded copy), with the same
kernels as the eager path, and returns the full result, replicated, as a
plain tensor on its device. Every decision that fixes which collectives run
(the method, blocked or not, the cohort permutation, the kernels' row blocks)
is taken from quantities all ranks hold alike: the global codes, ``size`` and
the global shape. The reference's program cache has no counterpart: nothing
here is traced or compiled, so every call builds its program (the
``program-build`` span) and runs it (the ``program`` span, over the
collectives' ``collective`` spans); the run is billed to the cost ledger
under ``mesh[<agg>/<method>]`` with the rank's device time and cost card.
"""

from __future__ import annotations

import logging
import math
import warnings
from typing import Any

import numpy as np
import torch

from .. import telemetry, utils
from ..aggregations import Aggregation, FusedAggregation, _masked_fill, shift_nat_identity_fills
from ..core import _est_itemsize, dense_intermediate_bytes
from ..multiarray import MultiArray
from ..options import OPTIONS
from .mesh import (Collectives, collectives, default_mesh, dtensor_local, is_dtensor, mesh_device,
                   shard_bounds)

__all__ = ["resolve_mesh", "sharded_groupby_reduce"]

logger = logging.getLogger("flox_tpu_torch.parallel.mapreduce")

#: the "no candidate" global position of argreductions and first/last
_BIG = np.iinfo(np.int64).max

#: legs that one segment-sum pass serves with the counts channel
_SUM_COUNT_LEGS = frozenset({"sum", "nansum", "len", "nanlen"})


def resolve_mesh(mesh, device) -> tuple[Any, torch.device]:
    """The mesh of a call and the device its rank reduces on: ``mesh``'s own
    device, or, without a mesh, :func:`~.mesh.default_mesh` on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    if mesh is None:
        dev = utils.resolve_device(device)
        return default_mesh(dev), dev
    dev = mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device={device!r} differs from the mesh's device type "
                         f"{mesh.device_type!r}")
    return mesh, dev


# ---------------------------------------------------------------------------
# the shard-local stage
# ---------------------------------------------------------------------------


def _local_chunk(agg: Aggregation, codes_sh, arr_sh, size: int, nat: bool) -> list:
    """The agg's chunk legs on this shard: one intermediate per leg. Entries
    may be kernel names or user callables with the plugin signature."""
    from ..aggregations import fused_chunk_stats
    from ..kernels import generic_kernel

    if isinstance(agg, FusedAggregation):
        # deduplicated legs, the one-pass kernels' subsets collapsed
        return fused_chunk_stats(agg, codes_sh, arr_sh, size=size, engine="torch")
    inters = []
    fills = agg.fill_value.get("intermediate", ())
    for entry, fv in zip(agg.chunk, list(fills) + [None] * len(agg.chunk)):
        name, extra = (entry[0], dict(entry[1])) if isinstance(entry, tuple) else (entry, {})
        if nat:
            extra["nat"] = True
        if callable(name):
            inters.append(name(codes_sh, arr_sh, size=size, fill_value=fv, **extra))
            continue
        if name in ("sum", "nansum", "prod", "nanprod"):
            # bf16 intermediates travel in the f32 accumulator; the cast to
            # the final dtype happens once, at finalize
            extra["keep_acc"] = True
        if name.startswith("var_chunk"):
            extra.update(agg.finalize_kwargs)
        inters.append(generic_kernel(name, codes_sh, arr_sh, size=size, fill_value=fv, **extra))
    return inters


def _local_counts(codes_sh, arr_sh, size: int, skipna: bool, nat: bool) -> torch.Tensor:
    from ..kernels import generic_kernel

    kw = {"nat": True} if nat else {}
    return generic_kernel("nanlen" if skipna else "len", codes_sh, arr_sh, size=size, **kw)


def _local_stage(agg: Aggregation, codes_sh, arr_sh, size: int, nat: bool,
                 count_skipna: bool) -> tuple[list, torch.Tensor | None]:
    """The chunk legs and the counts channel of this shard. Sum and count
    legs of float data come from one segment-sum pass with the counts, as
    the eager mean does; counts are int32 whichever route ran, so every rank
    sends the same dtypes. A fused plan has no counts channel (None): each
    of its statistics reads its own presence leg."""
    from ..kernels import fused_segment_stats

    if isinstance(agg, FusedAggregation):
        return _local_chunk(agg, codes_sh, arr_sh, size, nat), None
    counts_name = "nanlen" if count_skipna else "len"
    names = agg.chunk
    if names and not nat and all(isinstance(e, str) for e in names):
        want = tuple(dict.fromkeys((*names, counts_name)))
        if set(want) <= _SUM_COUNT_LEGS and {"sum", "nansum"} & set(want):
            got = fused_segment_stats(codes_sh, arr_sh, size=size, want=want)
            if got is not None:
                with telemetry.span("legs"):
                    legs = [got[n].to(torch.int32) if n in ("len", "nanlen") else got[n]
                            for n in names]
                    return legs, got[counts_name].to(torch.int32)
    legs = _local_chunk(agg, codes_sh, arr_sh, size, nat)
    if len(names) == 1 and isinstance(names[0], tuple) and names[0][0] == "var_chunk" and (
            dict(names[0][1]).get("skipna", True) == count_skipna):
        # the variance triple's count leaf is the counts channel: float,
        # exact below 2^24, and the threshold test stays right above it
        return legs, legs[0].arrays[2].to(torch.int32)
    return legs, _local_counts(codes_sh, arr_sh, size, count_skipna, nat).to(torch.int32)


def _local_firstlast(codes_sh, arr_sh, size: int, *, skipna: bool, last: bool, nat: bool,
                     offset: int):
    """(value, global int64 position) per group of this shard for the
    first/last combine; a group with no candidate holds -1 (last) or _BIG."""
    from ..kernels import (_BIG as _BIG32, _flat, _gather_positions, _iota_like, _nan_mask,
                           _safe_codes, _seg, _unflat)

    codes = _safe_codes(codes_sh, size)
    data, lead = _flat(arr_sh)
    mask = _nan_mask(data, nat) if skipna else None
    iota = _iota_like(data)
    if mask is not None:
        iota = torch.where(mask, iota, -1 if last else _BIG32)
    pos = _seg("max" if last else "min", iota, codes, size)
    ok = (pos >= 0) & (pos < _BIG32)
    val = _gather_positions(data, pos)
    gpos = torch.where(ok, pos.to(torch.int64) + offset, -1 if last else _BIG)
    return _unflat(val, lead), _unflat(gpos, lead)


# ---------------------------------------------------------------------------
# combines (collectives)
# ---------------------------------------------------------------------------


def _combine_simple(op: str, x: torch.Tensor, comm: Collectives, nat: bool = False):
    if op == "sum":
        return comm.psum(x)
    if op in ("max", "min"):
        out = comm.pmax(x) if op == "max" else comm.pmin(x)
        # what a collective MAX/MIN does with NaN is the backend's; numpy's
        # min/max propagate it: re-inject the missing marker where any
        # shard's intermediate had it (NaN, or INT64_MIN = NaT on int64 views)
        if x.is_floating_point():
            has_nan = comm.psum(torch.isnan(x).to(torch.int32)) > 0
            out = torch.where(has_nan, float("nan"), out)
        elif nat and x.dtype == torch.int64:
            marker = np.iinfo(np.int64).min
            has_nat = comm.psum((x == marker).to(torch.int32)) > 0
            out = torch.where(has_nat, marker, out)
        return out
    if op == "prod":
        return comm.all_gather(x).prod(dim=0)
    raise ValueError(f"Unknown combine op {op!r}")


def _combine_var(ma: MultiArray, comm: Collectives) -> MultiArray:
    """The Chan merge of the variance triples: two psums and one of the
    adjusted second moments."""
    m2, total, n = ma.arrays
    big_n = comm.psum(n)
    big_t = comm.psum(total)
    mu = big_t / torch.where(big_n > 0, big_n, 1)
    mu_d = total / torch.where(n > 0, n, 1)
    adj = n * (mu_d - mu) ** 2
    return MultiArray((comm.psum(m2 + adj), big_t, big_n))


def _combine_arg(val, idx, comm: Collectives, arg_of_max: bool, nat: bool = False):
    gv = _combine_simple("max" if arg_of_max else "min", val, comm, nat=nat)
    hit = val == gv
    if val.is_floating_point():
        # NaN-propagating argreductions: shards whose extreme is NaN contend
        hit = hit | (torch.isnan(val) & torch.isnan(gv))
    gidx = comm.pmin(torch.where(hit & (idx >= 0), idx, _BIG))
    return gv, torch.where(gidx < _BIG, gidx, -1)


def _combine_firstlast(val, pos, comm: Collectives, last: bool):
    vals = comm.all_gather(val)  # (ndev, ..., size)
    poss = comm.all_gather(pos)
    pick = (poss.argmax(dim=0) if last else poss.argmin(dim=0)).unsqueeze(0)
    return vals.gather(0, pick).squeeze(0)


def _combine_intermediates(agg: Aggregation, inters: list, comm: Collectives, nat: bool) -> list:
    """Cross-shard combine of dense per-shard intermediates: [value, global
    position] for argreductions and first/last, else one entry per
    ``agg.combine`` op."""
    skipna = agg.name.startswith("nan") or agg.name == "count"
    nat_markers = nat and not skipna
    if agg.reduction_type == "argreduce":
        return list(_combine_arg(inters[0], inters[1], comm,
                                 arg_of_max="max" in str(agg.chunk[1]), nat=nat_markers))
    if agg.combine in (("first",), ("last",)):
        return [_combine_firstlast(inters[0], inters[1], comm, last=agg.combine == ("last",))]
    combined = []
    for inter, op in zip(inters, agg.combine):
        if op == "var":
            combined.append(_combine_var(inter, comm))
        elif callable(op):
            # user folds see every shard's intermediate stacked on dim 0
            if isinstance(inter, MultiArray):
                combined.append(op(MultiArray(comm.all_gather(a) for a in inter.arrays)))
            else:
                combined.append(op(comm.all_gather(inter)))
        else:
            combined.append(_combine_simple(op, inter, comm, nat=nat_markers))
    return combined


def _apply_final_fill(result, counts, agg: Aggregation):
    """Groups below the contribution threshold take the final fill; counts
    are (..., size), right-aligned with the result (whose leading dims may
    hold quantile's q). None: the result holds its fill already."""
    if isinstance(agg.final_fill_value, str):
        raise TypeError("string fill values are not supported on device")
    if counts is None:
        return result
    return _masked_fill(result, counts < max(agg.min_count, 1), agg.final_fill_value)


def _finalize_combined(agg: Aggregation, combined: list, counts):
    """The combined intermediates finalized: the elementwise passes after
    the collectives (a ``legs`` span)."""
    with telemetry.span("legs"):
        if isinstance(agg, FusedAggregation):
            # every statistic reads its own presence leg
            return agg.finalize_fused(combined)
        if agg.reduction_type == "argreduce":
            result = combined[1]
        elif agg.finalize is not None:
            result = agg.finalize(*combined, **agg.finalize_kwargs)
        else:
            result = combined[0]
        return _apply_final_fill(result, counts, agg)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

#: order statistics whose kernel distributes by psum-ing the radix-select
#: counting passes; mode needs contiguous sorted groups and is not here
_DISTRIBUTED_ORDER_STATS = ("median", "nanmedian", "quantile", "nanquantile")


def _is_additive(agg: Aggregation) -> bool:
    """Combines that psum / psum_scatter can distribute by group ownership."""
    return agg.reduction_type != "argreduce" and bool(agg.combine) and all(
        op in ("sum", "var") for op in agg.combine
    )


def _route_ceiling(agg: Aggregation, size: int, lead_elems: int, dtype, ndev: int,
                   method: str) -> bool:
    """Whether the blocked owner-by-owner program runs: above
    ``dense_intermediate_bytes_max``, additive reductions block when the
    replicated result plus est/ndev fit; everything else raises."""
    est = dense_intermediate_bytes(lead_elems, size, dtype, agg, ndev)
    ceiling = OPTIONS["dense_intermediate_bytes_max"]
    if est <= ceiling or method not in ("map-reduce", "cohorts"):
        return False
    blocked_est = lead_elems * size * _est_itemsize(dtype) + est // ndev
    if _is_additive(agg) and blocked_est <= ceiling:
        logger.debug(
            "dense intermediates ~%s exceed dense_intermediate_bytes_max (%s): using the "
            "blocked owner-by-owner program", utils.fmt_bytes(est), utils.fmt_bytes(ceiling))
        return True
    how = (
        "its combine cannot be distributed by group ownership"
        if not _is_additive(agg)
        else f"even the blocked owner-by-owner program needs ~{utils.fmt_bytes(blocked_est)}"
        f"/device over {ndev} device(s)"
    )
    raise ValueError(
        f"{agg.name!r} over {size} groups needs ~{utils.fmt_bytes(est)} of dense (..., size) "
        f"intermediates per device, above the {utils.fmt_bytes(ceiling)} "
        f"dense_intermediate_bytes_max ceiling, and {how}. Options: use engine='sort' "
        "(set_options(default_engine='sort'): intermediates and collectives then cover only "
        "the groups actually present); reduce expected_groups; shard over more devices; use "
        "method='blockwise' after rechunk.reshard_for_blockwise (whole groups per shard, no "
        "dense combine); or raise set_options(dense_intermediate_bytes_max=...) if the device "
        "really has the headroom."
    )


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def sharded_groupby_reduce(
    array: Any,
    codes: Any,
    agg: Aggregation,
    *,
    size: int,
    mesh: Any = None,
    axis_name: str | tuple[str, ...] = "data",
    method: str = "map-reduce",
    nat: bool = False,
    device: Any = None,
) -> Any:
    """Run one grouped reduction as a sharded program over ``mesh``.

    ``array``: the global (..., N) data (numpy, or a tensor anywhere), or a
    ``DTensor`` sharded along N over the mesh; ``codes``: the global (N,)
    codes, -1 = missing (numpy, or a tensor). Returns the finalized dense
    result on this rank's device, replicated: (*new_dims, ..., size), or a
    tuple of them for a :class:`~flox_tpu_torch.aggregations.FusedAggregation`.
    """
    mesh, dev = resolve_mesh(mesh, device)
    comm = collectives(mesh, axis_name)
    ndev = comm.size

    if agg.blockwise_only and method != "blockwise":
        if agg.name not in _DISTRIBUTED_ORDER_STATS:
            raise NotImplementedError(
                f"{agg.name!r} needs whole groups on one shard; use method='blockwise' with "
                "shard-local groups (rechunk.reshard_for_blockwise prepares that layout)."
            )
        if method == "cohorts":
            warnings.warn(
                f"method='cohorts' has no ownership win for order statistics; {agg.name!r} "
                "runs the distributed radix-select 'map-reduce' program instead",
                UserWarning, stacklevel=2,
            )
        method = "map-reduce"
    if nat:
        shift_nat_identity_fills(agg)

    shape = tuple(array.shape)
    lead_elems = math.prod(shape[:-1])
    blocked = _route_ceiling(agg, size, lead_elems, array.dtype, ndev, method)
    if blocked:
        method = "cohorts"  # blocked execution lives in the cohorts program

    cohort_perm = None
    if method == "cohorts" and not blocked:
        # align the psum_scatter ownership tiles with the detected cohorts
        from ..cohorts import chunks_from_shards, find_group_cohorts, ownership_permutation

        codes_np = utils.asarray_host(codes).reshape(-1)
        _, mapping = find_group_cohorts(codes_np, chunks_from_shards(codes_np.shape[0], ndev),
                                        expected_groups=range(size))
        cohort_perm = ownership_permutation(mapping, size, ndev)

    n = shape[-1]
    lo, hi = shard_bounds(n, ndev, comm.index)
    arr_sh = dtensor_local(array, comm) if is_dtensor(array) else array[..., lo:hi]
    arr_sh = utils.as_tensor(arr_sh, dev).contiguous()
    codes_sh = torch.as_tensor(codes[lo:hi], device=dev)
    size_pad = size + (-size) % ndev if method == "cohorts" else size
    from .. import costmodel

    with telemetry.span("program-build", agg=agg.name, method=method, ndev=ndev, size=size):
        program = _build_program(agg, size=size, size_pad=size_pad, method=method, comm=comm,
                                 offset=lo, nat=nat, cohort_perm=cohort_perm, blocked=blocked)
    with telemetry.span("program"):
        with telemetry.device_timer(dev) as timer, costmodel.capture() as cap:
            result = program(arr_sh, codes_sh)
    if telemetry.enabled():
        prog = f"mesh[{agg.name}/{method}]"
        telemetry.sample_hbm(program=prog)
        costmodel.ensure_card(prog, cap, dev)
        telemetry.observe_cost(prog, timer=timer, nbytes=arr_sh.numel() * arr_sh.element_size()
                               + codes_sh.numel() * codes_sh.element_size())
    return result


def _tiles_to_groups(result_own, comm: Collectives):
    """All-gather each rank's tile of the group axis (..., t) into the full
    (..., ndev * t), tile ``d`` from rank ``d``; leaf-wise over tuples."""
    if isinstance(result_own, tuple):
        return tuple(_tiles_to_groups(r, comm) for r in result_own)
    full = comm.all_gather(result_own.movedim(-1, 0))  # (ndev, t, ...)
    return full.reshape((-1,) + tuple(full.shape[2:])).movedim(0, -1)


def _pscatter(x: torch.Tensor, comm: Collectives) -> torch.Tensor:
    """psum_scatter over the trailing (group) axis: this rank's tile."""
    return comm.psum_scatter(x.movedim(-1, 0)).movedim(0, -1)


def _map_result(fn, result):
    return tuple(fn(r) for r in result) if isinstance(result, tuple) else fn(result)


def _build_program(agg: Aggregation, *, size, size_pad, method, comm: Collectives, offset, nat,
                   cohort_perm=None, blocked=False):
    ndev = comm.size
    skipna = agg.name.startswith("nan") or agg.name == "count"
    # min_count thresholds count non-NaN contributions
    count_skipna = skipna or agg.min_count > 0

    def numpy_kernel(f, codes_sh, arr_sh, **extra):
        """One whole-reduction (agg.numpy) kernel: the one place the
        order-statistic and blockwise programs assemble their kwargs."""
        kw = dict(agg.finalize_kwargs)
        if nat:
            kw["nat"] = True
        kw.update(extra)
        if callable(f):
            return f(codes_sh, arr_sh, size=size, fill_value=None, **kw)
        from ..kernels import generic_kernel

        return generic_kernel(f, codes_sh, arr_sh, size=size, fill_value=None, **kw)

    def orderstat_program(arr_sh, codes_sh):
        """Distributed quantile/median: one kernel call whose radix-select
        counting passes psum across shards, so the selected value is rebuilt
        from the global counts and is replicated by construction."""
        counts = comm.psum(_local_counts(codes_sh, arr_sh, size, count_skipna, nat))
        result = numpy_kernel(agg.numpy[0], codes_sh, arr_sh, axis_name=comm)
        return _apply_final_fill(result, counts, agg)

    def mapreduce_program(arr_sh, codes_sh):
        if agg.reduction_type == "argreduce":
            from ..kernels import generic_kernel

            # a group without candidates holds -1, the default final fill:
            # the counts channel matters only for min_count or another fill
            counts_local = (_local_counts(codes_sh, arr_sh, size, count_skipna, nat)
                            if agg.min_count > 0 or agg.final_fill_value != -1 else None)
            val_f, arg_f = agg.chunk  # e.g. ("max", "argmax")
            kw = {"nat": True} if nat else {}
            val = generic_kernel(val_f, codes_sh, arr_sh, size=size,
                                 fill_value=agg.fill_value["intermediate"][0], **kw)
            local_arg = generic_kernel(arg_f, codes_sh, arr_sh, size=size, fill_value=-1, **kw)
            inters = [val, torch.where(local_arg >= 0, local_arg.to(torch.int64) + offset, -1)]
        elif agg.combine in (("first",), ("last",)):
            counts_local = _local_counts(codes_sh, arr_sh, size, count_skipna, nat)
            inters = list(_local_firstlast(codes_sh, arr_sh, size, skipna=skipna,
                                           last=agg.combine == ("last",), nat=nat, offset=offset))
        else:
            inters, counts_local = _local_stage(agg, codes_sh, arr_sh, size, nat, count_skipna)
        counts = None if counts_local is None else comm.psum(counts_local)
        return _finalize_combined(agg, _combine_intermediates(agg, inters, comm, nat), counts)

    def combine_additive(inters):
        return [_combine_var(inter, comm) if op == "var"
                else _combine_simple(op, inter, comm, nat=nat and not skipna)
                for inter, op in zip(inters, agg.combine)]

    def blocked_cohorts_program(arr_sh, codes_sh):
        """No dense (..., size) buffer: a loop over the ndev owner blocks,
        each reducing only its groups into (..., size_pad/ndev) and psum-ing
        them; the owner keeps its block. The data makes ndev passes, the
        price of the memory ceiling."""
        b = size_pad // ndev
        owned = None
        for d in range(ndev):
            in_block = (codes_sh >= d * b) & (codes_sh < (d + 1) * b)
            bc = torch.where(in_block, codes_sh - d * b, -1)
            inters, counts_local = _local_stage(agg, bc, arr_sh, b, nat, count_skipna)
            counts = None if counts_local is None else comm.psum(counts_local)
            outs = combine_additive(inters)
            if d == comm.index:
                owned = (outs, counts)
        result_own = _finalize_combined(agg, *owned)
        return _map_result(lambda r: r[..., :size], _tiles_to_groups(result_own, comm))

    def cohorts_program(arr_sh, codes_sh):
        # psum_scatter needs every leg additive; others run map-reduce
        if not _is_additive(agg):
            return mapreduce_program(arr_sh, codes_sh)
        if blocked:
            return blocked_cohorts_program(arr_sh, codes_sh)
        if cohort_perm is not None:
            perm_t = torch.as_tensor(cohort_perm, device=arr_sh.device)
            inv = np.empty(size, dtype=np.int64)
            valid = cohort_perm < size
            inv[cohort_perm[valid]] = np.flatnonzero(valid)
            inv_t = torch.as_tensor(inv, device=arr_sh.device)

        def to_slots(x):
            """Pad the group axis and place groups in their ownership slots."""
            if size_pad != size:
                x = torch.nn.functional.pad(x, (0, size_pad - size))
            return x.index_select(-1, perm_t) if cohort_perm is not None else x

        def from_slots(full):
            """The gathered slot layout in group order, cropped."""
            return full.index_select(-1, inv_t) if cohort_perm is not None else full[..., :size]

        inters, counts_local = _local_stage(agg, codes_sh, arr_sh, size, nat, count_skipna)
        counts_own = None if counts_local is None else _pscatter(to_slots(counts_local), comm)
        owned = []
        for inter, op in zip(inters, agg.combine):
            if op == "var":
                # the Chan adjustment needs the owners' means broadcast back
                m2, total, nn = inter.arrays
                mu_d = total / torch.where(nn > 0, nn, 1)
                big_t = _pscatter(to_slots(total), comm)
                big_n = _pscatter(to_slots(nn), comm)
                mu = big_t / torch.where(big_n > 0, big_n, 1)
                adj = nn * (mu_d - from_slots(_tiles_to_groups(mu, comm))) ** 2
                owned.append(MultiArray((_pscatter(to_slots(m2 + adj), comm), big_t, big_n)))
            else:
                owned.append(_pscatter(to_slots(inter), comm))
        result_own = _finalize_combined(agg, owned, counts_own)
        return _map_result(from_slots, _tiles_to_groups(result_own, comm))

    def blockwise_program(arr_sh, codes_sh):
        counts_local = _local_counts(codes_sh, arr_sh, size, count_skipna, nat)
        locals_ = [numpy_kernel(f, codes_sh, arr_sh) for f in agg.numpy]
        if agg.reduction_type == "argreduce" and len(locals_) > 1:
            result_local = locals_[1]
        elif agg.finalize is not None and len(agg.numpy) > 1:
            result_local = agg.finalize(*locals_, **agg.finalize_kwargs)
        else:
            result_local = locals_[0]
        if agg.reduction_type == "argreduce":
            result_local = torch.where(result_local >= 0, result_local.to(torch.int64) + offset,
                                       -1)
        # owner: the shard that saw the group (exactly one, after
        # reshard_for_blockwise)
        counts_all = comm.all_gather(counts_local)  # (ndev, ..., size)
        res_all = comm.all_gather(result_local)  # (ndev, *new, ..., size)
        owner = (counts_all > 0).to(torch.uint8).argmax(dim=0)
        extra = res_all.ndim - 1 - owner.ndim  # new dims (quantile's q)
        pick = owner.reshape((1,) * extra + tuple(owner.shape)).expand(res_all.shape[1:])
        result = res_all.gather(0, pick.unsqueeze(0)).squeeze(0)
        return _apply_final_fill(result, comm.psum(counts_local), agg)

    if method == "map-reduce":
        return orderstat_program if agg.blockwise_only else mapreduce_program
    if method == "cohorts":
        return cohorts_program
    if method == "blockwise":
        return blockwise_program
    raise ValueError(f"Unknown method {method!r}")
