"""The data: a seeded field on the card, made in row blocks.

A configuration's ``field`` block gives the dtype, the mean and spread of a
normal field, and the share of whole rows that are NaN on every step (land
in a sea-surface field). Each block of ``gen_rows`` rows of each shard of the
time axis is drawn by a generator of its own on the card, seeded from
``(seed, shard, block)``, so the reference can remake any block alone.
"""

from __future__ import annotations

import numpy as np
import torch

GEN_ROWS = 32768  # rows a generator call fills
_NAN_STREAM = 0x4C414E44  # the seed stream of the NaN rows


def _seed64(*words: int) -> int:
    state = np.random.SeedSequence([w % 2**64 for w in words]).generate_state(2, np.uint32)
    return int(state[0]) | int(state[1]) << 32


def block_seed(seed: int, shard: int, block: int) -> int:
    return _seed64(seed, shard, block)


def gen_rows(config: dict) -> int:
    return int(config.get("gen_rows", GEN_ROWS))


def nan_rows(config: dict, seed: int, nrows: int) -> np.ndarray:
    """Sorted indices of the rows that are NaN on every step."""
    share = float(config["field"].get("nan_rows_share", 0.0))
    k = int(round(share * nrows))
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, _NAN_STREAM]))
    return np.sort(rng.choice(nrows, size=k, replace=False)).astype(np.int64)


def _fill(out: torch.Tensor, config: dict, seed: int, shard: int, block: int,
          nan_local: np.ndarray) -> None:
    field = config["field"]
    gen = torch.Generator(device=out.device)
    gen.manual_seed(block_seed(seed, shard, block))
    out.normal_(float(field["mean"]), float(field["std"]), generator=gen)
    if nan_local.size:
        out.index_fill_(0, torch.as_tensor(nan_local, device=out.device), float("nan"))


def _nan_in(nan: np.ndarray, r0: int, r1: int) -> np.ndarray:
    lo, hi = np.searchsorted(nan, [r0, r1])
    return nan[lo:hi] - r0


def make_shard(config: dict, nrows: int, ncols: int, seed: int, shard: int,
               device) -> torch.Tensor:
    """The ``(nrows, ncols)`` columns of time shard ``shard``."""
    dtype = getattr(torch, config["field"]["dtype"])
    out = torch.empty((nrows, ncols), dtype=dtype, device=device)
    nan = nan_rows(config, seed, nrows)
    step = gen_rows(config)
    for b, r0 in enumerate(range(0, nrows, step)):
        r1 = min(r0 + step, nrows)
        _fill(out[r0:r1], config, seed, shard, b, _nan_in(nan, r0, r1))
    return out


def remake_block(config: dict, nrows: int, ncols: int, seed: int, shard: int, block: int,
                 device) -> torch.Tensor:
    """Block ``block`` of :func:`make_shard`'s result, made alone."""
    dtype = getattr(torch, config["field"]["dtype"])
    step = gen_rows(config)
    r0 = block * step
    r1 = min(r0 + step, nrows)
    out = torch.empty((r1 - r0, ncols), dtype=dtype, device=device)
    _fill(out, config, seed, shard, block, _nan_in(nan_rows(config, seed, nrows), r0, r1))
    return out


def shard_bounds(n: int, nshards: int, index: int) -> tuple[int, int]:
    """Columns ``[lo, hi)`` of shard ``index``: ``ceil(n / nshards)`` a shard,
    the way a ``DTensor`` sharded along its last axis lays them out."""
    per = -(-n // nshards)
    lo = min(index * per, n)
    return lo, min(lo + per, n)
