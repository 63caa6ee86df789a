"""flox_tpu_torch: the PyTorch/CUDA port of flox_tpu's grouped reductions,
multi-statistic fusion, grouped scans and high-cardinality (sort) engine.

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

from .core import groupby_reduce
from .fusion import groupby_aggregate_many
from .options import OPTIONS, set_options
from .scan import groupby_scan

__all__ = ["OPTIONS", "groupby_aggregate_many", "groupby_reduce", "groupby_scan", "set_options"]
