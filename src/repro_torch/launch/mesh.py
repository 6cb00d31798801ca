"""Mesh construction (functions only: nothing is placed or allocated).

Counterpart of ``repro/launch/mesh.py``.  A mesh is one of two kinds (both
read by :mod:`repro_torch.dist.sharding`):

* a :class:`~repro_torch.dist.sharding.StackedMesh` — every rank in this
  process, on one device, each axis a
  :class:`~repro_torch.dist.transport.StackedTransport`;
* under an initialised ``torch.distributed`` process group, a
  ``DeviceMesh`` of the processes (``init_device_mesh``), whose axis groups
  the :class:`~repro_torch.dist.transport.ProcessGroupTransport` runs over.

The production meshes are the reference's: one pod (data=16, model=16) =
256 chips, or two pods (pod=2, data=16, model=16) = 512, the "pod" axis
carrying data parallelism across pods.  Here they are shapes to resolve
specs against.
"""

from __future__ import annotations

import math

from repro_torch.dist.sharding import StackedMesh


def make_production_mesh(*, multi_pod: bool = False) -> StackedMesh:
    """The (16, 16) or (2, 16, 16) production mesh, shape only: for specs
    (``repro_torch.launch.specs``); no tensor is placed on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return StackedMesh(shape, axes)


def make_mesh(shape, axes, device=None):
    """A mesh of ``shape`` over ``axes``: a ``DeviceMesh`` of the processes
    when a process group is initialised (its world must be the mesh's
    size), else a :class:`StackedMesh` on ``device``."""
    import torch.distributed as dist
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        if dist.get_world_size() != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"processes, the group has "
                             f"{dist.get_world_size()}")
        kind = "cuda" if str(device or "cpu").startswith("cuda") else "cpu"
        return init_device_mesh(kind, shape, mesh_dim_names=axes)
    return StackedMesh(shape, axes, device)


def make_host_mesh(device=None):
    """Whatever ranks exist, as a 1-D data mesh: the process group's, or
    this process alone."""
    import torch.distributed as dist
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    return make_mesh((n,), ("data",), device)
