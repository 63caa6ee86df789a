"""Global options of the port (counterpart of ``flox_tpu/options.py``).

Only the knobs that the eager reduction path reads are here. The names of the
accumulation and group-cap knobs are the reference's, so that one option set
can drive both packages (:func:`from_reference`).
"""

from __future__ import annotations

from typing import Any

__all__ = ["OPTIONS", "VALID_ACCUMS", "from_reference", "set_options"]

#: cross-chunk accumulation disciplines of the segment-sum kernel
VALID_ACCUMS = ("plain", "kahan", "dd")

OPTIONS: dict[str, Any] = {
    # segment-sum implementation: "auto" and "kernel" take the hand-written
    # segment-sum kernel when its guards pass (f32/bf16 data, at most
    # ``pallas_num_groups_max`` groups, N >= 8); "scatter" is an explicit
    # request for ``index_add_`` and is honoured.
    "segment_sum_impl": "auto",
    # accumulation discipline of the segment-sum kernel:
    #   "plain" - an f32 running sum
    #   "kahan" - compensated summation (default)
    #   "dd"    - double-double (hi, lo) f32 pair with Dekker-split addends
    "pallas_accum": "kahan",
    # group-count ceiling of the segment-sum kernel: its accumulators sit in
    # shared memory, one set per row and group
    "pallas_num_groups_max": 512,
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
}

_IMPLS = ("auto", "scatter", "kernel")

_VALIDATORS = {
    "segment_sum_impl": lambda x: x in _IMPLS,
    "pallas_accum": lambda x: x in VALID_ACCUMS,
    "pallas_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "segment_minmax_impl": lambda x: x in _IMPLS,
    "pallas_minmax_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
    "scan_impl": lambda x: x in ("auto", "segmented", "kernel"),
    "pallas_scan_num_groups_max": lambda x: isinstance(x, int) and 0 <= x <= 512,
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
    "radixbin": "A5 (the radix-binning kernel, Queue B5)",
    "matmul": "none (the one-hot GEMM is not queued; use 'auto' or 'kernel')",
}


def from_reference(opts: dict) -> dict:
    """The port's options for the reference's ``OPTIONS`` (a plain dict).

    Keys the port has are carried over; the reference's ``"pallas"``
    implementation maps to the port's ``"kernel"``. Keys the port lacks are
    ignored. An implementation the port has not got, or the reference's
    measured dispatch (``autotune=True``), raises ``NotImplementedError``
    naming the ROADMAP item.
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
        if key.endswith("_impl"):
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
