"""Sharded grouped scans: the mesh Blelloch scan (L5), the port of
``flox_tpu/parallel/scan.py``.

Every rank scans its own columns and then:

1. computes its per-group block summary (the block sum for cumsum; the last
   valid value for ffill, the first for bfill): the Blelloch "preop";
2. exchanges the summaries with ONE ``all_gather`` (ndev x size values) and
   folds the shards strictly before it (after it, for bfill): the
   cross-shard "binop". For cumsum that fold is a select-then-sum, and a
   had-NaT channel rides the same gather for non-skipna timedelta scans;
   for ffill it picks the nearest shard with a valid value;
3. applies the carry per element through the group codes.

``method="blockwise"`` skips the exchange: valid only when every group is
shard-local (checked on the host). The scanned shards are all-gathered into
the full result, replicated on every rank.

:func:`stream_scan_step` is the streaming x mesh step (the reference's
``build_stream_scan_step``): the same Blelloch program on a rank's shard of
one slab, plus a replicated per-group carry from the slabs before it.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from .. import telemetry, utils
from ..aggregations import Scan
from .mapreduce import resolve_mesh
from .mesh import Collectives, collectives, shard_bounds

__all__ = ["sharded_groupby_scan", "stream_scan_step"]


def sharded_groupby_scan(
    array: Any,
    codes: Any,
    scan: Scan,
    *,
    size: int,
    mesh: Any = None,
    axis_name: str | tuple[str, ...] = "data",
    dtype: Any = None,
    method: str = "blelloch",
    nat: bool = False,
    device: Any = None,
) -> torch.Tensor:
    """Sharded grouped scan over the trailing axis of the global (..., N)
    ``array`` by the global (N,) ``codes``. Returns the (..., N) result on
    this rank's device, replicated."""
    mesh, dev = resolve_mesh(mesh, device)
    comm = collectives(mesh, axis_name)
    ndev = comm.size
    if method == "blockwise":
        _validate_shard_local(utils.asarray_host(codes).reshape(-1), ndev)
    n = array.shape[-1]
    lo, hi = shard_bounds(n, ndev, comm.index)
    arr_sh = utils.as_tensor(array[..., lo:hi], dev).contiguous()
    if dtype is not None:
        arr_sh = arr_sh.to(utils.torch_dtype(dtype))
    codes_sh = torch.as_tensor(codes[lo:hi], device=dev)
    lead = tuple(arr_sh.shape[:-1])
    arr2 = arr_sh.reshape(math.prod(lead), hi - lo)  # K, not -1: a shard may be empty
    with telemetry.span(f"flox:mesh-scan[{scan.name}/{method}]", ndev=ndev, size=size):
        if method == "blockwise":
            from ..kernels import generic_kernel

            out = generic_kernel(scan.scan, codes_sh, arr2, size=size, nat=nat)
        else:
            out = _blelloch(scan, arr2, codes_sh, size=size, comm=comm, nat=nat)
        return gather_shards(out, comm, n).reshape(lead + (n,))


def gather_shards(out: torch.Tensor, comm: Collectives, n: int) -> torch.Tensor:
    """The (K, N) whole of every rank's (K, n_local) shard of an axis of
    length ``n`` split by ``shard_bounds``, replicated: every shard padded to
    ``ceil(n / ndev)`` columns and all-gathered."""
    ndev = comm.size
    if ndev == 1:
        return out
    per = -(-n // ndev)
    parts = comm.all_gather(torch.nn.functional.pad(out, (0, per - out.shape[-1])))
    return parts.permute(1, 0, 2).reshape(out.shape[0], ndev * per)[:, :n]


def stream_scan_step(scan: Scan, arr: torch.Tensor, codes: torch.Tensor, *, size: int,
                     comm: Collectives, nat: bool, carry: tuple | None):
    """One slab of the streamed mesh scan on this rank's (K, n_local) shard:
    ``(out_shard, carry_a, carry_b)``. ``carry`` is None on the first slab,
    else the replicated ``(per-group sums, had-NaT)`` of cumsum-mode scans or
    ``(per-group edge value, has-value)`` of ffill/bfill, folded from every
    rank's shard of the slabs before (after, for bfill). The new carry is
    computed from the gathered summaries, so it is the same on every rank."""
    return _blelloch(scan, arr, codes, size=size, comm=comm, nat=nat, carry=carry,
                     stream=True)


def _validate_shard_local(codes: np.ndarray, ndev: int) -> None:
    """Blockwise precondition: every group's positions within one shard."""
    n = codes.shape[0]
    shard_len = -(-n // ndev) if n else 1
    valid = codes >= 0
    if not valid.any():
        return
    shard_of = np.arange(n) // shard_len
    order = np.argsort(codes[valid], kind="stable")
    grp = codes[valid][order]
    shd = shard_of[valid][order]
    boundaries = np.flatnonzero(np.diff(grp)) + 1
    firsts = np.r_[0, boundaries]
    lasts = np.r_[boundaries, grp.size] - 1
    bad = np.flatnonzero(shd[firsts] != shd[lasts])
    if bad.size:
        i = firsts[bad[0]]
        raise ValueError(
            f"method='blockwise' needs every group on one shard, but group "
            f"{int(grp[i])} spans shards {int(shd[i])}..{int(shd[lasts[bad[0]]])}; "
            "reshard first (rechunk.reshard_for_blockwise) or use method='blelloch'."
        )


def _blelloch(scan: Scan, arr: torch.Tensor, codes: torch.Tensor, *, size: int,
              comm: Collectives, nat: bool, carry: tuple | None = None, stream: bool = False):
    """The Blelloch program on this rank's shard ``arr`` (K, n_local);
    ``stream``: :func:`stream_scan_step`'s form, with ``carry`` in and out."""
    from ..kernels import (_NAT_INT, _nan_mask, _per_element, _safe_codes, fused_segment_stats,
                           generic_kernel)

    ndev, me = comm.size, comm.index
    local = generic_kernel(scan.scan, codes, arr, size=size, nat=nat)
    safe = _safe_codes(codes, size)
    before = torch.arange(ndev, device=arr.device)
    if scan.mode == "apply_binary_op":
        # NaT is a sentinel, not an IEEE value: block sums take it as zero,
        # and non-skipna poisoning crosses shards through a had-NaT channel
        is_nat = arr == _NAT_INT if nat else None
        summed = torch.where(is_nat, 0, arr) if nat else arr
        # float data: one segment-sum pass with the NaN channel, no masked copy
        block = fused_segment_stats(codes, summed, size=size, want=(scan.reduction,))
        block = (block[scan.reduction] if block is not None else generic_kernel(
            scan.reduction, codes, summed, size=size, fill_value=0)).to(local.dtype)
        poison_channel = nat and scan.scan == "cumsum"
        if poison_channel:
            had = generic_kernel("sum", codes, is_nat.to(torch.int32), size=size, fill_value=0)
            g = comm.all_gather(torch.stack([block, had.to(block.dtype)]))  # (ndev, 2, K, size)
            gathered, g_had = g[:, 0], g[:, 1] > 0
        else:
            gathered = comm.all_gather(block)  # (ndev, K, size)
        mask = (before < me).reshape(ndev, 1, 1)
        poison = (mask & g_had).any(dim=0) if poison_channel else None
        if me == 0:
            out = local  # no shard before the first: its carry is zero
        else:
            # exclusive prefix over the shards strictly before this one: a
            # select-then-sum, since NaN * 0 would poison every carry
            before_sum = torch.where(mask, gathered, torch.zeros(
                (), dtype=gathered.dtype, device=arr.device)).sum(dim=0)
            carry_e = _per_element(before_sum.to(local.dtype), safe)
            # in place unless the NaT test below still reads ``local``
            out = local + carry_e if poison_channel else local.add_(carry_e)
        if stream:
            # the slabs before: their per-group totals add to every element,
            # and this slab's totals over every shard join the carry
            slab_sum = gathered.sum(dim=0)
            if carry is None:
                new_sums = slab_sum
            else:
                out = out + _per_element(carry[0].to(out.dtype), safe)
                new_sums = carry[0] + slab_sum.to(carry[0].dtype)
            if poison_channel:
                slab_had = g_had.any(dim=0)
                if carry is not None:
                    poison = poison | (carry[1] > 0)
                    slab_had = slab_had | (carry[1] > 0)
                new_had = slab_had.to(torch.int8)
            else:
                new_had = None if carry is None else carry[1]
        if poison_channel:
            poison_e = _per_element(poison.to(torch.int8), safe) > 0
            out = torch.where(poison_e | (local == _NAT_INT), _NAT_INT, out)
        return (out, new_sums, new_had) if stream else out

    # ffill/bfill: the carry is the last (first) valid value per group in
    # the shards strictly before (after) this one
    reverse = scan.name == "bfill"
    valid = generic_kernel("nanlen", codes, arr, size=size, nat=nat) > 0
    edge = generic_kernel("nanfirst" if reverse else "nanlast", codes, arr, size=size,
                          fill_value=float("nan") if arr.is_floating_point() else 0, nat=nat)
    g_vals = comm.all_gather(edge)  # (ndev, K, size)
    g_valid = comm.all_gather(valid.expand_as(edge))
    dev_idx = before.reshape(ndev, 1, 1)
    eligible = g_valid & ((dev_idx > me) if reverse else (dev_idx < me))
    if reverse:
        pick = torch.where(eligible, dev_idx, ndev).amin(dim=0)
    else:
        pick = torch.where(eligible, dev_idx, -1).amax(dim=0)
    has_carry = (pick >= 0) & (pick < ndev)
    from_shards = g_vals.gather(0, pick.clamp(0, ndev - 1).unsqueeze(0)).squeeze(0)
    carry_e = _per_element(from_shards, safe)
    has_e = _per_element(has_carry.to(torch.int8), safe) > 0
    mask = _nan_mask(local, nat)
    still = ~mask if mask is not None else torch.zeros_like(has_e)
    out = torch.where(still & has_e & (codes >= 0), carry_e, local)
    if not stream:
        return out
    # the slabs before (after, for bfill): positions still missing take
    # their carry; this slab's edge over every shard replaces it where the
    # slab has a valid value
    any_valid = g_valid.any(dim=0)
    pick_all = (torch.where(g_valid, dev_idx, ndev).amin(dim=0) if reverse
                else torch.where(g_valid, dev_idx, -1).amax(dim=0))
    slab_edge = g_vals.gather(0, pick_all.clamp(0, ndev - 1).unsqueeze(0)).squeeze(0)
    if carry is None:
        return out, slab_edge, any_valid.to(torch.int8)
    prev_val, prev_has = carry
    mask2 = _nan_mask(out, nat)
    still2 = ~mask2 if mask2 is not None else torch.zeros_like(has_e)
    prev_e = _per_element(prev_has.to(torch.int8), safe) > 0
    out = torch.where(still2 & prev_e & (codes >= 0), _per_element(prev_val, safe).to(out.dtype),
                      out)
    new_val = torch.where(any_valid, slab_edge.to(prev_val.dtype), prev_val)
    return out, new_val, (prev_has.to(torch.bool) | any_valid).to(torch.int8)
