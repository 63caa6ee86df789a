"""Meshes and the collective layer of the multi-device runtime (L5).

The reference runs one program over all devices from one controller:
``shard_map`` over a ``jax.sharding.Mesh``, with XLA collectives as the
combine. PyTorch runs one process per rank, so ``shard_map`` has no
counterpart here: every rank calls the entry point with the same global
inputs, runs the shard-local stage on its own columns in its own process, and
calls the collectives of this module explicitly, in the same order as every
other rank.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(:func:`make_mesh`), or, in a process where ``torch.distributed`` is not
initialized, a :class:`LocalMesh` of one rank whose collectives are the
identity on the local tensor. :class:`Collectives` is the one place that
calls ``torch.distributed``: ``psum`` (``all_reduce`` SUM), ``pmax`` and
``pmin`` (MAX, MIN), ``all_gather`` (``all_gather_into_tensor``) and
``psum_scatter`` (``reduce_scatter_tensor``) over one mesh dim or a tuple of
them, reduced as one flattened group whose rank order is major-to-minor, as
``PartitionSpec((a0, a1))`` orders the reference's shards.

The backend is the world's: NCCL for CUDA tensors, one rank per card; gloo
for the CPU, and for ranks that share one card (NCCL refuses two ranks on one
device). Both take the four collectives on CUDA and CPU tensors. Neither
reduces bools or int16, which travel as uint8 and int32; complex values
travel as (real, imag) pairs, and only their sums are defined.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from .. import telemetry

__all__ = [
    "Collectives",
    "LocalMesh",
    "axis_size",
    "collectives",
    "default_mesh",
    "dtensor_local",
    "is_dtensor",
    "make_mesh",
    "mesh_device",
    "norm_axes",
    "shard_bounds",
    "shard_last_axis",
    "world_rank",
    "world_size",
]


class LocalMesh:
    """A one-rank mesh for a process without ``torch.distributed``: every
    dim has size 1, and its collectives are the identity."""

    def __init__(self, device_type: str, mesh_dim_names: Sequence[str]):
        self.device_type = device_type
        self.mesh_dim_names = tuple(mesh_dim_names)
        self.shape = (1,) * len(self.mesh_dim_names)

    def __repr__(self) -> str:
        return f"LocalMesh({self.device_type!r}, {self.mesh_dim_names})"


def world_rank() -> int:
    """This process's rank in its ``torch.distributed`` world (0 when it is
    not initialized)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    """The ranks of this process's ``torch.distributed`` world (1 when it is
    not initialized)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(
    n_devices: int | None = None,
    axis_name: str = "data",
    *,
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] | None = None,
    device_type: str = "cuda",
) -> Any:
    """A 1-D mesh over ``n_devices`` ranks (default: the whole world), or a
    multi-dim mesh via ``shape``/``axis_names``, e.g. ``make_mesh(shape=(2,
    4), axis_names=("dcn", "ici"))`` (then pass ``axis_name=("dcn", "ici")``
    to the entry points to shard over both).

    The mesh spans the whole ``torch.distributed`` world, one rank per
    element; without an initialized world it is a :class:`LocalMesh` of one
    rank. ``device_type`` is where the entry points run: "cuda" (the
    default, which raises without CUDA) or "cpu".
    """
    import torch.distributed as dist

    if shape is not None:
        if axis_names is None or len(axis_names) != len(shape):
            raise ValueError("axis_names must match shape")
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    else:
        names = (axis_name,)
    world = world_size()
    need = math.prod(shape) if shape is not None else (world if n_devices is None else n_devices)
    if need > world:
        raise ValueError(f"Requested {need} devices; only {world} available.")
    if need < world:
        raise ValueError(
            f"Requested {need} devices of a world of {world}: a mesh spans every rank of "
            "the torch.distributed world (one process per device)."
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda') needs a CUDA device; pass device_type='cpu' to "
            "run on the CPU."
        )
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    if not dist.is_initialized():
        return LocalMesh(device_type, names)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape if shape is not None else (need,),
                            mesh_dim_names=names)


_DEFAULT_MESHES: dict = {}


def default_mesh(device: torch.device) -> Any:
    """The mesh of a call that names a ``method=`` but no ``mesh=``: the
    world's 1-D "data" mesh when ``torch.distributed`` is initialized, else a
    one-rank :class:`LocalMesh`, on ``device``'s type (the reference's
    one-device default mesh)."""
    import torch.distributed as dist

    key = (device.type, id(dist.group.WORLD) if dist.is_initialized() else None)
    mesh = _DEFAULT_MESHES.get(key)
    if mesh is None:
        mesh = _DEFAULT_MESHES[key] = make_mesh(device_type=device.type)
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` reduces on: the CPU, or its current
    CUDA device."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh is on CUDA and this process has no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _dim_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def norm_axes(axis_name, mesh=None) -> tuple[str, ...]:
    """A single mesh dim name or a tuple of them (e.g. ("dcn", "ici")),
    validated against the mesh when given."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if mesh is not None:
        missing = [a for a in axes if a not in _dim_names(mesh)]
        if missing:
            raise ValueError(f"mesh has no axes {missing}; mesh axes: {_dim_names(mesh)}")
    return axes


def _dim_size(mesh, name: str) -> int:
    return mesh.shape[_dim_names(mesh).index(name)]


def axis_size(mesh, axes) -> int:
    """The number of shards over the named mesh dims."""
    return math.prod(_dim_size(mesh, a) for a in norm_axes(axes, mesh))


def collectives(mesh, axis_name) -> "Collectives":
    return Collectives(mesh, norm_axes(axis_name, mesh))


class Collectives:
    """The collectives of one flattened group of mesh dims.

    ``size`` is the number of shards, ``index`` this rank's flattened
    position (major-to-minor over ``axes``). Every method takes and returns
    tensors on the rank's device; inputs need not be contiguous.
    """

    def __init__(self, mesh, axes: tuple[str, ...]):
        self.mesh = mesh
        self.axes = axes
        if isinstance(mesh, LocalMesh):
            self._groups: list = []
            self.size, self.index = 1, 0
            return
        self._groups = [mesh.get_group(a) for a in axes]
        self._sizes = [_dim_size(mesh, a) for a in axes]
        index = 0
        for a, n in zip(axes, self._sizes):
            index = index * n + mesh.get_local_rank(a)
        self.size, self.index = math.prod(self._sizes), index

    # -- the wire ------------------------------------------------------------

    def _span(self, op: str, x: torch.Tensor, wire: torch.dtype, nbytes: int):
        """The ``collective`` span of one collective, around its wire copy and
        its calls: the op, the dtypes, ``nbytes`` (the largest buffer of each
        call, summed over the calls: the bytes an all-reduce reduces, an
        all-gather's output, a reduce-scatter's input) and the ranks. It adds
        to the ``mesh.collectives`` and ``mesh.collective_bytes`` counters."""
        telemetry.count("mesh.collectives")
        telemetry.count("mesh.collective_bytes", nbytes)
        return telemetry.span("collective", op=op, dtype=_dtype_name(x.dtype),
                              wire_dtype=_dtype_name(wire), nbytes=nbytes, ranks=self.size)

    def _reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist

        if not self._groups:
            return x
        if x.is_complex():
            if op != "sum":
                raise TypeError(f"{op} over complex values is not defined")
            return torch.view_as_complex(self._reduce(torch.view_as_real(x), op))
        # bools and int16 have no reduction on the wire of NCCL or gloo
        wire = torch.uint8 if x.dtype == torch.bool else (
            torch.int32 if x.dtype == torch.int16 else x.dtype)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
        nbytes = x.numel() * wire.itemsize * len(self._groups)
        with self._span("p" + op, x, wire, nbytes):
            buf = x.to(wire, copy=True).contiguous()
            for g in self._groups:
                dist.all_reduce(buf, op=rop, group=g)
        return buf > 0 if x.dtype == torch.bool else buf.to(x.dtype)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the shards (bools count as int32)."""
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        return self._reduce(x, "sum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "max")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "min")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` stacked on a new leading dim, in flattened
        rank order: (size, *x.shape)."""
        import torch.distributed as dist

        if not self._groups:
            return x.unsqueeze(0)
        if x.is_complex():
            return torch.view_as_complex(self.all_gather(torch.view_as_real(x)))
        wire = torch.uint8 if x.dtype == torch.bool else x.dtype
        nbytes, part = 0, x.numel() * wire.itemsize
        for n in reversed(self._sizes):
            part *= n
            nbytes += part
        with self._span("all_gather", x, wire, nbytes):
            buf = x.to(wire).reshape(-1).contiguous()
            # minor dim first: each pass puts one more dim in front, so the
            # result is (n_major, ..., n_minor, *x.shape), flattened major first
            for g, n in zip(reversed(self._groups), reversed(self._sizes)):
                out = torch.empty(n * buf.numel(), dtype=buf.dtype, device=buf.device)
                # the same call under its newer name where torch has it
                getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, buf, group=g)
                buf = out
        out = buf.reshape((self.size,) + tuple(x.shape))
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the shards of ``x`` (size * t, ...), of which this
        rank keeps tile ``index`` along dim 0: (t, ...)."""
        import torch.distributed as dist

        if not self._groups:
            return x
        if x.shape[0] % self.size:
            raise ValueError(f"psum_scatter: dim 0 ({x.shape[0]}) is not a multiple of "
                             f"{self.size} shards")
        if x.is_complex() or x.dtype in (torch.bool, torch.int16):
            t = x.shape[0] // self.size
            return self.psum(x)[self.index * t: (self.index + 1) * t]
        nbytes, part = 0, x.numel() * x.element_size()
        for n in self._sizes:
            nbytes += part
            part //= n
        reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
        with self._span("psum_scatter", x, x.dtype, nbytes):
            buf = x.contiguous()
            # major dim first: each pass keeps this rank's chunk of the dim it sums
            for g, n in zip(self._groups, self._sizes):
                out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                                  device=buf.device)
                reduce_scatter(out, buf, group=g)
                buf = out
        return buf


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# shards of the reduced axis
# ---------------------------------------------------------------------------


def shard_bounds(n: int, nshards: int, index: int) -> tuple[int, int]:
    """Columns ``[lo, hi)`` of shard ``index`` of an axis of length ``n``:
    the reference's split, ``ceil(n / nshards)`` columns a shard, the last
    short or empty. No padded copy of the data is made."""
    per = -(-n // nshards)
    lo = min(index * per, n)
    return lo, min(lo + per, n)


def shard_last_axis(t: torch.Tensor, mesh) -> Any:
    """``t`` as a ``DTensor`` sharded along its last axis over every dim of
    ``mesh`` (the serving registry's sharded put)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    return distribute_tensor(t, mesh, [Shard(t.ndim - 1)] * mesh.ndim)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (tested
    without importing the module)."""
    return type(x).__name__ == "DTensor" and hasattr(x, "to_local")


def dtensor_local(x, comm: Collectives) -> torch.Tensor:
    """The local columns of a DTensor sharded along its last dim over
    ``comm``'s mesh dims (and replicated over the others), used as they lie:
    the counterpart of a sharded ``jax.Array``. Raises ``ValueError`` for any
    other layout."""
    if x.device_mesh != comm.mesh:
        raise ValueError("the DTensor lives on another mesh than the call's mesh=")
    last = x.ndim - 1
    for name, placement in zip(_dim_names(comm.mesh), x.placements):
        want_shard = name in comm.axes
        if want_shard != (placement.is_shard() and placement.dim % x.ndim == last) or (
                not want_shard and not placement.is_replicate()):
            raise ValueError(
                f"a DTensor input must be sharded along its last dim over the mesh dims "
                f"{comm.axes} and replicated over the others; got placements {x.placements}")
    local = x.to_local()
    lo, hi = shard_bounds(x.shape[-1], comm.size, comm.index)
    if local.shape[-1] != hi - lo:
        raise ValueError(
            f"the DTensor's local shard has {local.shape[-1]} columns; the mesh split of "
            f"{x.shape[-1]} columns over {comm.size} shards gives this rank {hi - lo}")
    return local
