"""MultiArray: a tuple of tensors that flows through the reduction machinery as
one value (counterpart of ``flox_tpu/multiarray.py``).

The port uses it for the variance triple ``(m2, total, count)`` that
``kernels.var_chunk`` returns and that ``aggregations._finalize_slot`` reads.
"""

from __future__ import annotations

__all__ = ["MultiArray"]


class MultiArray:
    __slots__ = ("arrays",)

    def __init__(self, arrays) -> None:
        self.arrays = tuple(arrays)

    def __repr__(self) -> str:
        return f"MultiArray({self.arrays!r})"
