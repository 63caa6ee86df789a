"""The multi-device runtime (L5): grouped reductions and scans over a
``torch.distributed`` mesh, the port of ``flox_tpu/parallel``.

=======================  ==============================================
flox_tpu (JAX mesh)      flox_tpu_torch (torch.distributed)
=======================  ==============================================
``shard_map`` program     the same function, run by every rank's process
``lax.psum``              ``all_reduce`` SUM
``pmax`` / ``pmin``       ``all_reduce`` MAX / MIN
``all_gather``            ``all_gather_into_tensor``
``psum_scatter``          ``reduce_scatter_tensor``
``jax.sharding.Mesh``     ``DeviceMesh`` with named dims, or a one-rank
                          ``LocalMesh`` without ``torch.distributed``
=======================  ==============================================

Every rank calls an entry point with the same global inputs, reduces its own
columns of the reduced axis with the eager path's kernels, and gets the full
result back, replicated. Dense intermediates over ``expected_groups`` are
what give every shard's contribution the same shape, which the collectives
need.
"""

from .mapreduce import sharded_groupby_reduce
from .mesh import LocalMesh, axis_size, make_mesh
from .scan import sharded_groupby_scan

__all__ = [
    "LocalMesh",
    "axis_size",
    "make_mesh",
    "sharded_groupby_reduce",
    "sharded_groupby_scan",
]
