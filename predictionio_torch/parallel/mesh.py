"""Device mesh over the ranks of a ``torch.distributed`` world.

Counterpart of ``predictionio_tpu/parallel/mesh.py``. The JAX package
lays its devices out as a ``jax.sharding.Mesh`` and lets XLA insert the
collectives; the port has one device per process, so a mesh's axes run
over the ranks: over an initialized world :func:`create_mesh` makes a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the axes, and each axis's process group carries the ops' explicit
collectives (:func:`axis_group`). In a process with no world the mesh
is a :class:`SingleMesh` of size 1, which needs no process group. Ops
take ``mesh is None`` or a mesh of size 1 as the unsharded path, as the
JAX package's ``ops/als.py`` does.

Axis convention (the built-in algorithms'):

  - ``data``  — batch / entity dimension (users, examples): DP
  - ``model`` — feature / item dimension

``MeshContext`` is the port's
:class:`~predictionio_torch.parallel.context.DeviceContext`, which
carries the mesh beside its device. Engine code written against the JAX
package (a project its ``pio template get`` scaffolded, which the port's
project loader runs with its imports rewritten, ``workflow/variant.py``)
types its context by that name.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from predictionio_torch.parallel.context import DeviceContext

#: the declared mesh axis names; built-in code shards over these only
MESH_AXES: Tuple[str, ...] = ("data", "model")

MeshContext = DeviceContext


class SingleMesh:
    """The mesh of a process with no world: every axis of size 1, no
    process group. It has the two ``DeviceMesh`` attributes the port
    reads (``mesh_dim_names``, ``shape``)."""

    def __init__(self, axes: Dict[str, int]):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(1 for _ in axes)

    def __repr__(self) -> str:
        return f"SingleMesh({dict(zip(self.mesh_dim_names, self.shape))})"


def local_device_count() -> int:
    """Devices this process computes on: one, the port's rule."""
    return 1


def _device_type() -> str:
    """The world's device type: the rank's device's, else what the
    default group's backend carries."""
    from predictionio_torch.parallel import multihost

    if multihost._rank_device is not None:
        return multihost._rank_device.type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence] = None):
    """A mesh from axis name -> size over the world's ranks; one size
    may be -1 (inferred). Default ``{"data": -1, "model": 1}``: every
    rank on the ``data`` axis, pure DP. ``devices`` is accepted for the
    JAX package's signature and must number the world's ranks. Over an
    initialized world: a ``DeviceMesh`` (every rank must call this, as
    it makes the axes' process groups); with no world: a
    :class:`SingleMesh`. The kernel-library cache is checked first, as
    the JAX function turns its compile cache on here."""
    from predictionio_torch.parallel.compile_cache import (
        enable_persistent_cache)

    enable_persistent_cache()
    n = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None and len(list(devices)) != n:
        raise ValueError(f"{len(list(devices))} devices for a world of {n} "
                         "ranks (one device per process)")
    axes = dict(axes or {"data": -1, "model": 1})
    unknown = [k for k, v in axes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one mesh axis may be -1")
    known = math.prod(v for v in axes.values() if v != -1)
    if unknown:
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        axes[unknown[0]] = n // known
    if math.prod(axes.values()) != n:
        raise ValueError(f"mesh {axes} does not cover {n} ranks")
    if not dist.is_initialized():
        return SingleMesh(axes)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(),
                      torch.arange(n).reshape(tuple(axes.values())),
                      mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` of ``mesh``; 1 for no mesh or an axis the
    mesh does not name."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[list(mesh.mesh_dim_names).index(axis)])


def mesh_size(mesh) -> int:
    """Ranks in ``mesh`` (1 for None)."""
    return 1 if mesh is None else math.prod(int(s) for s in mesh.shape)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis`` (None on a
    mesh of size 1)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str) -> int:
    """This rank's position along ``axis``."""
    group = axis_group(mesh, axis)
    return 0 if group is None else dist.get_rank(group)


def named_sharding(mesh, *spec) -> list:
    """DTensor placements for a PartitionSpec-like ``spec`` (one axis
    name or None per tensor dim): mesh dim ``a`` shards the tensor dim
    that names it (``Shard(i)``), and replicates otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, s in enumerate(spec) if s == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def replicated(mesh) -> list:
    """DTensor placements replicating over every mesh dim."""
    return named_sharding(mesh)


__all__ = ["MESH_AXES", "MeshContext", "SingleMesh", "axis_group",
           "axis_rank", "axis_size", "create_mesh", "local_device_count",
           "mesh_size", "named_sharding", "replicated"]
