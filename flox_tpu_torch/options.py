"""Global options of the port (counterpart of ``flox_tpu/options.py``).

The knobs of the eager reduction path and of streaming are here. Of the
reference's eight ``stream_*`` knobs, ``stream_donate`` is accepted and
validated but has no effect: nothing is traced, so there is no buffer
donation, and the streaming carry is updated in place always. The names of the
engine, accumulation, group-cap and ceiling knobs are the reference's, so
that one option set can drive both packages (:func:`from_reference`).
"""

from __future__ import annotations

import math
import os
from typing import Any

__all__ = ["OPTIONS", "VALID_ACCUMS", "from_reference", "set_options"]

#: cross-chunk accumulation disciplines of the segment-sum kernel
VALID_ACCUMS = ("plain", "kahan", "dd")

OPTIONS: dict[str, Any] = {
    # engine of a call that names none: "torch" (dense accumulators over the
    # label universe), "sort" (the present-groups engine: accumulators over
    # the groups actually present, for huge label universes) or "numpy" (the
    # host engine; the result is copied to the call's device)
    "default_engine": "torch",
    # label-universe size from which a call left to the dense engine weighs
    # the sort engine (density heuristic, ``core._route_highcard``)
    "sort_engine_min_groups": 1 << 16,
    # segment-sum implementation, for f32/bf16 data with N >= 8:
    #   "auto"     - the segment-sum kernel up to ``pallas_num_groups_max``
    #                groups, the radix-binning kernel up to
    #                ``radixbin_num_groups_max``, else ``index_add_``
    #   "kernel"   - the segment-sum kernel up to its cap, else ``index_add_``
    #   "radixbin" - the radix-binning kernel up to its cap, else ``index_add_``
    #   "scatter"  - ``index_add_``, an explicit request that is honoured
    "segment_sum_impl": "auto",
    # accumulation discipline of the segment-sum kernel:
    #   "plain" - an f32 running sum
    #   "kahan" - compensated summation (default)
    #   "dd"    - double-double (hi, lo) f32 pair with Dekker-split addends
    "pallas_accum": "kahan",
    # group-count ceiling of the segment-sum kernel: its accumulators sit in
    # shared memory, one set per row and group
    "pallas_num_groups_max": 512,
    # group-count ceiling of the radix-binning kernel: it splits the group
    # axis into 512-wide blocks, so the bound is output bytes, not memory
    "radixbin_num_groups_max": 1 << 14,
    # device-byte ceiling of the dense (..., size) intermediates of one call:
    # above it a call left to the dense engine goes to the sort engine, and an
    # explicit dense request raises naming engine="sort"
    "dense_intermediate_bytes_max": 8 * 2**30,
    # segment-min/max implementation, the same three policies as above
    "segment_minmax_impl": "auto",
    # group-count ceiling of the segment-min/max kernel
    "pallas_minmax_num_groups_max": 128,
    # grouped cumsum/nancumsum: "auto" and "kernel" take the hand-written
    # segmented-cumsum kernel when its guards pass (f32/bf16 data, size + 1
    # <= ``pallas_scan_num_groups_max``, N >= 8); "segmented" is an explicit
    # request for the sort + log-depth segmented scan of torch ops
    "scan_impl": "auto",
    # group-count ceiling of the segmented-cumsum kernel, the missing-label
    # group included: its per-group carries sit in shared memory
    "pallas_scan_num_groups_max": 128,
    # grouped order statistics (quantile, median): "sort" is a lexicographic
    # (code, value) sort of each row; "select" is the sort-free radix
    # bisection, one counting segment-sum (the segment-sum kernel) per bit
    # of the data's width; "auto" resolves to "sort", as in the reference
    # with its measured dispatch off
    "quantile_impl": "auto",
    # streaming (``pipeline``, ``resilience``): how many slabs the staging
    # pool holds in flight, loaded into pinned host buffers and copied to the
    # card on a side stream while the card reduces the slab before; 0 stages
    # inline (the same bytes land either way). Depth > 1 loads concurrently,
    # so the loader must take concurrent (start, stop) calls
    "stream_prefetch": 2,
    # synchronize the carry every K dispatched slabs, so the host cannot run
    # far ahead of the card with staged slabs; 0 disables the throttle
    "stream_dispatch_depth": 8,
    # accepted for the reference's option set and validated, with no effect:
    # the port updates the carry in place always (nothing is traced, so
    # there is no buffer donation to turn on or off)
    "stream_donate": "auto",
    # extra attempts of a slab's load and staging after a transient failure
    # (``resilience.classify_error``); retries + 1 attempts in all
    "stream_retries": 2,
    # base backoff in seconds between attempts, doubled per attempt (full
    # jitter below that cap)
    "stream_backoff": 0.05,
    # per-slab deadline in seconds over all attempts and backoffs; 0: none
    "stream_slab_timeout": 0.0,
    # snapshot the carry to the host every K processed slabs, so that a
    # killed stream resumes bit for bit; 0 disables checkpointing
    "stream_checkpoint_every": 0,
    # spill target of the snapshots: a directory (one .npz per stream) or a
    # literal .npz path, for a resume in another process; None keeps them in
    # this process only
    "stream_checkpoint_path": None,
}

_IMPLS = ("auto", "scatter", "kernel")


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _is_finite_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


_VALIDATORS = {
    "default_engine": lambda x: x in ("torch", "sort", "numpy"),
    "sort_engine_min_groups": lambda x: _is_int(x) and x >= 1,
    "segment_sum_impl": lambda x: x in (*_IMPLS, "radixbin"),
    "pallas_accum": lambda x: x in VALID_ACCUMS,
    "pallas_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "radixbin_num_groups_max": lambda x: isinstance(x, int) and x >= 0,
    "dense_intermediate_bytes_max": lambda x: isinstance(x, int) and x >= 2**20,
    "segment_minmax_impl": lambda x: x in _IMPLS,
    "pallas_minmax_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "scan_impl": lambda x: x in ("auto", "segmented", "kernel"),
    "pallas_scan_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "quantile_impl": lambda x: x in ("auto", "sort", "select"),
    # streaming knobs are validated when set: a negative depth or retry count
    # raises here, not hours into a stream (bool is no int here)
    "stream_prefetch": lambda x: _is_int(x) and 0 <= x <= 64,
    "stream_dispatch_depth": lambda x: _is_int(x) and x >= 0,
    "stream_donate": lambda x: x in ("auto", "on", "off"),
    "stream_retries": lambda x: _is_int(x) and 0 <= x <= 1000,
    "stream_backoff": lambda x: _is_finite_num(x) and x >= 0,
    "stream_slab_timeout": lambda x: _is_finite_num(x) and x >= 0,
    "stream_checkpoint_every": lambda x: _is_int(x) and x >= 0,
    "stream_checkpoint_path": lambda x: x is None or (
        isinstance(x, (str, os.PathLike)) and bool(str(x))),
}


class set_options:
    """Context manager / global setter for options.

    >>> import flox_tpu_torch
    >>> with flox_tpu_torch.set_options(pallas_accum="dd"):
    ...     pass
    """

    def __init__(self, **kwargs: Any) -> None:
        self.old: dict[str, Any] = {}
        for k, v in kwargs.items():
            if k not in OPTIONS:
                raise ValueError(
                    f"argument name {k!r} is not in the set of valid options {set(OPTIONS)!r}"
                )
            if not _VALIDATORS[k](v):
                raise ValueError(f"option {k!r} given an invalid value: {v!r}")
            self.old[k] = OPTIONS[k]
        OPTIONS.update(kwargs)

    def __enter__(self) -> None:
        return None

    def __exit__(self, *args: Any) -> None:
        OPTIONS.update(self.old)


#: reference implementation names with no counterpart in the port, and the
#: ROADMAP item that will bring one
_UNPORTED_IMPLS = {
    "matmul": "none (the one-hot GEMM is not queued; use 'auto' or 'kernel')",
}

#: the reference's engine names in the port
_ENGINES = {"jax": "torch", "sort": "sort", "numpy": "numpy"}


def from_reference(opts: dict) -> dict:
    """The port's options for the reference's ``OPTIONS`` (a plain dict).

    Keys the port has are carried over; the reference's ``"pallas"``
    implementation maps to the port's ``"kernel"`` and its ``"jax"`` engine to
    ``"torch"``. Keys the port lacks are ignored. An implementation the port
    has not got, or the reference's measured dispatch (``autotune=True``),
    raises ``NotImplementedError`` naming the ROADMAP item.
    """
    if opts.get("autotune"):
        raise NotImplementedError(
            "autotune=True (measured dispatch, including the fused-vs-sequential "
            "choice of groupby_aggregate_many) has no counterpart in the port yet; "
            "ROADMAP item: A9"
        )
    out: dict[str, Any] = {}
    for key in OPTIONS:
        if key not in opts:
            continue
        value = opts[key]
        if key == "default_engine":
            value = _ENGINES.get(value, value)
        elif key.endswith("_impl"):
            if value == "pallas":
                value = "kernel"
            elif value in _UNPORTED_IMPLS:
                raise NotImplementedError(
                    f"{key}={value!r} has no counterpart in the port yet; "
                    f"ROADMAP item: {_UNPORTED_IMPLS[value]}"
                )
        if not _VALIDATORS[key](value):
            raise ValueError(f"option {key!r}: the port cannot take {value!r}")
        out[key] = value
    return out
