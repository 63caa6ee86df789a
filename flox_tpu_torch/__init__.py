"""flox_tpu_torch: the PyTorch/CUDA port of flox_tpu's grouped reductions,
multi-statistic fusion, grouped scans, high-cardinality (sort) engine, label
layers, xarray adapter, multi-device runtime (``parallel``: ``method=``
and ``mesh=`` over ``torch.distributed``) and single-device streaming of host
arrays larger than the card (``streaming_groupby_*``, with ``pipeline``,
``resilience``, ``faults`` and ``profiling``).

It runs on one NVIDIA GPU (Hopper, sm_90a) by default, with hand-written
CUDA kernels for the hot segment reductions and scans (``cuda_kernels``), and
on the CPU when the caller passes ``device="cpu"``. It imports neither JAX nor
flox_tpu, and imports without pandas.

>>> import numpy as np, flox_tpu_torch
>>> out, groups = flox_tpu_torch.groupby_reduce(
...     np.array([1.0, 2.0, 4.0]), np.array([0, 0, 1]), func="nanmean", device="cpu")
>>> out
tensor([1.5000, 4.0000], dtype=torch.float64)
"""

from . import cohorts, faults, kernels, profiling, resilience, xrlite
from .aggregations import Aggregation, Scan, is_supported_aggregation
from .core import groupby_reduce
from .device import codes_device, groupby_reduce_device
from .dtypes import INF, NA, NINF
from .factorize import Prefactorized, factorize_, factorize_single, prefactorize
from .fusion import FUSABLE_FUNCS, groupby_aggregate_many
from .multiarray import MultiArray
from .options import OPTIONS, set_options
from .rechunk import rechunk_for_blockwise, rechunk_for_cohorts, reshard_for_blockwise
from .reindex import ReindexArrayType, ReindexStrategy
from .scan import groupby_scan
from .streaming import (streaming_groupby_aggregate_many, streaming_groupby_reduce,
                        streaming_groupby_scan)
from .xarray import xarray_reduce

__all__ = [
    "Aggregation",
    "FUSABLE_FUNCS",
    "INF",
    "MultiArray",
    "NA",
    "NINF",
    "OPTIONS",
    "Prefactorized",
    "ReindexArrayType",
    "ReindexStrategy",
    "Scan",
    "codes_device",
    "cohorts",
    "factorize_",
    "factorize_single",
    "faults",
    "groupby_aggregate_many",
    "groupby_reduce",
    "groupby_reduce_device",
    "groupby_scan",
    "is_supported_aggregation",
    "kernels",
    "prefactorize",
    "profiling",
    "rechunk_for_blockwise",
    "rechunk_for_cohorts",
    "reshard_for_blockwise",
    "resilience",
    "set_options",
    "streaming_groupby_aggregate_many",
    "streaming_groupby_reduce",
    "streaming_groupby_scan",
    "xarray_reduce",
    "xrlite",
]
