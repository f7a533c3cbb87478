"""Logical-axis sharding rules (MaxText-style) for the (pod, data, model)
mesh: the reference package's ``models/sharding.py`` on
``torch.distributed.tensor`` (DTensor) in place of GSPMD.

Tensors are annotated with *logical* axis names; a :class:`ShardingRules`
table maps each logical name to zero or more mesh axes.  Changing the table
re-shards the whole model, and single-pod and multi-pod meshes reuse one
model definition (``batch`` → ``("data",)`` or ``("pod", "data")``).

A logical dim is only sharded if its size divides the product of the mapped
mesh axes — otherwise it silently falls back to replication (e.g. MQA's
kv_heads=1 across a 16-way model axis).

The reference and its counterparts here:

- ``jax.sharding.Mesh`` with axes ``("data", "model")``, ``("pod", "data",
  "model")`` or ``("stage",)``: a ``DeviceMesh`` with the same
  ``mesh_dim_names``; ``jax.sharding.AbstractMesh`` (shape only):
  :class:`AbstractMesh`;
- a ``PartitionSpec`` from ``logical_spec``: :class:`PartitionSpec`, the
  same per-dim tuple of mesh axes, and :func:`placements`, one
  ``Shard(d)`` or ``Replicate()`` a mesh dim;
- ``with_sharding_constraint`` (:func:`constrain`): ``DTensor.redistribute``
  to those placements;
- ``jax.device_put(x, NamedSharding)``: ``distribute_tensor`` /
  ``DTensor.from_local``;
- ``jax.ShapeDtypeStruct`` with a sharding: :class:`AbstractTensor`.

The spec functions read only a mesh's dim names and sizes, so they take a
live ``DeviceMesh`` or an :class:`AbstractMesh` alike and need no process
group: a ``(16, 16)`` spec is computed in a world of one.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

__all__ = ["ShardingRules", "DEFAULT_RULES", "MULTIPOD_RULES", "AbstractMesh",
           "AbstractTensor", "PartitionSpec", "mesh_shape", "mesh_axis_size",
           "logical_spec", "placements", "constrain", "device_type",
           "map_tensors"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name → tuple of mesh axis names (() = replicate)."""
    table: Mapping[str, tuple[str, ...]]

    def axes_for(self, name: str | None) -> tuple[str, ...]:
        if name is None:
            return ()
        return tuple(self.table.get(name, ()))

    def replace(self, **updates: tuple[str, ...]) -> "ShardingRules":
        t = dict(self.table)
        for k, v in updates.items():
            t[k] = tuple(v)
        return ShardingRules(t)


_BASE_TABLE = {
    # activations
    "batch": ("data",),
    "batch_attn": ("data",),     # attention-region batch (may add 'model'
                                 # when heads don't divide the TP axis)
    "seq": (),                   # sharded for long-context cells (SP)
    "kv_seq": (),
    "embed": (),                 # d_model on activations: replicated
    "heads": ("model",),
    "kv_heads": ("model",),
    # params — TP axis per Megatron; FSDP axis shards the complement
    "vocab": ("model",),
    "embed_fsdp": ("data",),     # FSDP dim of weight matrices
    "mlp": ("model",),           # d_ff / column-parallel out dim
    "qkv": ("model",),
    "o_in": ("model",),          # row-parallel in dim
    "experts": ("model",),       # EP
    "expert_cap": (),            # capacity/slot parallelism fallback
    "expert_mlp": (),            # within-expert width (EP precludes TP here)
    "ssm_inner": ("model",),
    "lora": (),
    "conv": (),
    "norm": (),
    "state": (),
}

DEFAULT_RULES = ShardingRules(dict(_BASE_TABLE))
MULTIPOD_RULES = DEFAULT_RULES.replace(batch=("pod", "data"),
                                       embed_fsdp=("data",))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and dim names without devices or a process group (the
    reference's ``jax.sharding.AbstractMesh``): what the spec functions
    read of a ``DeviceMesh``, under the same attribute names."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and dim names "
                             f"{self.mesh_dim_names} differ in length")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name, or a
    tuple of them (the dim split over those axes, the first outermost) — the
    reference's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def device_type() -> str:
    """The device type of the world's ranks, and so of its meshes:
    ``"cuda"`` under ``nccl``, ``"cpu"`` under ``gloo``."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def map_tensors(fn, tree, path: str = ""):
    """``tree`` (dicts, lists, tuples, NamedTuples) with each tensor leaf
    ``t`` at ``path`` (keys, indices or fields joined by ``/``) replaced by
    ``fn(path, t)``; other leaves (a cache's ``len``) stay."""
    join = (lambda k: f"{path}/{k}" if path else str(k))
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v, join(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v, join(i))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def mesh_shape(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axis_size(mesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def logical_spec(rules: ShardingRules, mesh, names: Sequence[str | None],
                 dims: Sequence[int] | None = None) -> PartitionSpec:
    """PartitionSpec from logical names; non-divisible dims replicate."""
    parts = []
    for i, name in enumerate(names):
        axes = rules.axes_for(name)
        if not axes:
            parts.append(None)
            continue
        if dims is not None:
            # progressively drop trailing axes until the dim divides —
            # e.g. batch=('data','model') degrades to ('data',) for small B
            while axes:
                size = mesh_axis_size(mesh, axes)
                if size > 1 and dims[i] % size == 0:
                    break
                axes = axes[:-1]
            if not axes:
                parts.append(None)
                continue
        parts.append(axes if len(axes) > 1 else axes[0])
    return PartitionSpec(*parts)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.  A tensor dim split over several axes is ``Shard(d)``
    on each; DTensor splits it over the mesh dims in their order, so the
    entry must list its axes in that order (``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of {tuple(spec)}")
            out[i] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, rules: ShardingRules, mesh,
              *names: str | None) -> torch.Tensor:
    """``x`` redistributed to the layout its logical names give
    (``with_sharding_constraint``; a no-op off-mesh).  A plain tensor (one
    the model made inside the step: a mask, a position table) counts as
    replicated on ``mesh``."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    spec = logical_spec(rules, mesh, names, dims=x.shape)
    target = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


@dataclasses.dataclass(frozen=True)
class AbstractTensor:
    """A tensor's shape and dtype on the ``meta`` device with its mesh and
    spec (the reference's ``jax.ShapeDtypeStruct(..., sharding=
    NamedSharding(mesh, spec))``): what a sharded tensor would be, with
    nothing allocated."""
    meta: torch.Tensor
    mesh: object
    spec: PartitionSpec

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype

    @property
    def ndim(self) -> int:
        return self.meta.dim()

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)
