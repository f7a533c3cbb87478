"""Elastic scaling: rebuild the mesh from whatever ranks are alive and
reshard state onto it — plus the file-based membership registry the
multi-process serving fleet coordinates through (the reference package's
``distributed/elastic.py``).

Checkpoints are mesh-agnostic (``checkpoint/checkpointer.py`` saves
gathered values by path), so elasticity is:

    mesh' = best_mesh(live ranks)
    target' = the state laid out on mesh' (param_specs, ...)
    state' = checkpointer.restore(step, target')

``best_mesh`` picks the largest (data, model) factorisation with model ≤
the requested TP degree; ``reshard`` moves a live tree between meshes
directly (``DTensor.redistribute`` on one mesh, through ``full_tensor``
and ``distribute_tensor`` between two), for downsizing without a restart.
``abstract_like`` is the reference's ``ShapeDtypeStruct`` tree: tensors on
the ``meta`` device with their mesh and spec.

``torch.distributed`` is imported inside the mesh helpers: serving-fleet
executor processes import this module only for :class:`FleetMembership`.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import torch

from repro_torch.core.durable import atomic_write_bytes

__all__ = ["best_mesh", "best_mesh_shape", "reshard", "abstract_like",
           "FleetMembership"]


def best_mesh_shape(n: int, model_parallel: int = 1) -> tuple[int, int]:
    """``(data, model)`` for ``n`` ranks: the TP degree asked for, halved
    until it divides ``n``."""
    tp = model_parallel
    while tp > 1 and n % tp != 0:
        tp //= 2
    return n // tp, tp


def best_mesh(world=None, *, model_parallel: int = 1,
              axis_names=("data", "model")):
    """The ``(data, model)`` ``DeviceMesh`` (of the world's device type)
    over ``world``: the first ``world`` ranks (an int), those ranks (a
    list), or every rank of the process group (None)."""
    if world is None:
        import torch.distributed as dist
        world = dist.get_world_size()
    ranks = list(range(world)) if isinstance(world, int) else list(world)
    dp, tp = best_mesh_shape(len(ranks), model_parallel)
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.sharding import device_type
    return DeviceMesh(device_type(),
                      torch.tensor(ranks[:dp * tp]).reshape(dp, tp),
                      mesh_dim_names=tuple(axis_names))


def abstract_like(tree, mesh, spec_fn):
    """``tree`` with each tensor an ``AbstractTensor`` on ``mesh``: its
    shape and dtype on the ``meta`` device and ``spec_fn(path, leaf)``,
    a PartitionSpec."""
    from repro_torch.models.sharding import AbstractTensor, map_tensors
    return map_tensors(lambda path, t: AbstractTensor(
        torch.empty(t.shape, dtype=t.dtype, device="meta"), mesh,
        spec_fn(path, t)), tree)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _onto(leaf: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``leaf`` laid out by ``spec`` on ``mesh``: redistributed on its own
    mesh, else gathered whole and each rank's shard cut from it (every
    rank holds the whole value, so nothing is sent)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.models.sharding import placements
    target = placements(spec, mesh)
    if isinstance(leaf, DTensor):
        if leaf.device_mesh == mesh:
            return leaf.redistribute(mesh, target)
        leaf = leaf.full_tensor()
    return distribute_tensor(leaf.detach().to(_mesh_device(mesh)), mesh,
                             target, src_data_rank=None)


def reshard(tree, mesh, spec_fn):
    """Move a live tree onto ``mesh``, each tensor laid out by
    ``spec_fn(path, leaf)``; a mesh of another size than the tree's goes
    through ``full_tensor`` (a collective over the old mesh's ranks).  An
    ``nn.Module`` has its parameters replaced in place (the same
    ``requires_grad``) and is returned; other trees come back new."""
    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(mod) if mod else tree
            setattr(owner, leaf, torch.nn.Parameter(
                _onto(p, mesh, spec_fn(name, p)),
                requires_grad=p.requires_grad))
        return tree
    from repro_torch.models.sharding import map_tensors
    return map_tensors(lambda path, t: _onto(t, mesh, spec_fn(path, t)), tree)


class FleetMembership:
    """File-based membership registry for a serving fleet.

    One JSON file per member under ``root`` (conventionally
    ``<registry>/members/``), written atomically so a reader never sees a
    torn record.  Liveness is heartbeat-based: a member rewrites its file
    (fresh wall-clock stamp) on its poll tick, and :meth:`members` treats
    anything older than ``stale_s`` as dead — a SIGKILLed executor
    disappears from the roster without anyone cleaning up after it.  This
    is deliberately the weakest coordination primitive that works on a
    shared filesystem (local fleet today, NFS-mounted multi-host registry
    tomorrow): no daemon, no locks, idempotent registration.
    """

    def __init__(self, root: str | Path, *, stale_s: float = 30.0) -> None:
        if stale_s <= 0:
            raise ValueError("stale_s must be > 0")
        self.root = Path(root)
        self.stale_s = float(stale_s)

    def _path(self, name: str) -> Path:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in str(name)) or "member"
        return self.root / f"{safe}.json"

    def register(self, name: str, **meta) -> Path:
        """(Re)announce a member; extra keyword facts (pid, fingerprint
        slug, ...) ride along in its record."""
        record = {"name": str(name), "pid": os.getpid(),
                  "t": time.time(), **meta}
        path = self._path(name)
        atomic_write_bytes(path, json.dumps(
            record, sort_keys=True).encode("utf-8"))
        return path

    def heartbeat(self, name: str, **meta) -> None:
        """Refresh the member's liveness stamp (same write as register)."""
        self.register(name, **meta)

    def members(self, *, live_only: bool = True) -> list[dict]:
        """Current roster, sorted by name; with ``live_only`` (default)
        members whose heartbeat is older than ``stale_s`` are dropped.
        Torn/corrupt records are skipped, never raised."""
        if not self.root.is_dir():
            return []
        now = time.time()
        out = []
        for path in sorted(self.root.glob("*.json")):
            try:
                rec = json.loads(path.read_text())
            except (ValueError, OSError):
                continue
            if not isinstance(rec, dict):
                continue
            if live_only and now - float(rec.get("t", 0)) > self.stale_s:
                continue
            out.append(rec)
        return out

    def deregister(self, name: str) -> None:
        try:
            self._path(name).unlink()
        except FileNotFoundError:
            pass
