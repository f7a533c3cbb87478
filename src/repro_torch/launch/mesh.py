"""Mesh construction (the reference package's ``launch/mesh.py``) over the
ranks of the ``torch.distributed`` world.

Functions, not module-level constants: importing this module touches no
process group.

  single-pod : (16, 16)    dims (data, model)          = 256 ranks
  multi-pod  : (2, 16, 16) dims (pod, data, model)     = 512 ranks

A rank is one device: the world is started by ``torchrun`` (or
``repro_torch.distributed.init_world``), ``nccl`` on the cards, ``gloo``
on the CPU, and the meshes take the device type of the world's backend.
"""

from __future__ import annotations

from repro_torch.models.sharding import device_type

__all__ = ["make_production_mesh", "batch_axes", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | None = None):
    """The production mesh; raises unless the world has 256 (or, multi-pod,
    512) ranks.  ``device`` is its device type (default the world's:
    ``cuda`` under ``nccl``, else ``cpu``); a fake world
    (``launch/dryrun.py``) names the one it stands in for."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = shape[0] * shape[1] * (shape[2] if multi_pod else 1)
    if dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} needs a world of {n} "
                         f"ranks; this one has {dist.get_world_size()}")
    return init_device_mesh(device or device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int | None = None, model: int = 1):
    """A small ``(data, model)`` mesh over the world's ranks (tests, smoke
    runs); ``data`` defaults to the world's size over ``model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return init_device_mesh(device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
