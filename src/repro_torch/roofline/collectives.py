"""Collective-communication bytes of an eager step (the counterpart of the
reference package's ``roofline/hlo_parse.py``).

The reference scans compiled HLO for its collectives.  The port has no
HLO: its collectives are the ``_c10d_functional`` ops that DTensor's
redistributions (and ``torch.distributed``'s functional collectives)
dispatch, which :class:`CollectiveCounter`, a ``TorchDispatchMode``, sees
as they run, on the rank's local tensors:

    all_gather_into_tensor    all-gather
    all_reduce                all-reduce
    reduce_scatter_tensor     reduce-scatter
    all_to_all_single         all-to-all  (and DTensor's shard_dim_alltoall)
    a point-to-point send     collective-permute

``wait_tensor`` is ignored.  Operand bytes follow the reference's
definitions: a gather's operand is its input shard, a reduce-scatter's is
its whole input, the others' their input.  Wire bytes per rank differ
from operand bytes by a ring factor (x2(n-1)/n for all-reduce, x(n-1)/n
for gather/scatter); :func:`wire_bytes` gives them.

A DTensor op reaches the mode first with the DTensors themselves: the
mode declines it (``NotImplemented``), so DTensor's own dispatch runs with
the mode still on the stack and its local ops and collectives pass
through the mode one by one.  DTensor's sharding propagation runs the op
once more on stand-ins of the global shapes; those calls are not the
rank's and are not counted.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["COLLECTIVE_KINDS", "CollectiveCounter", "LocalDispatchMode",
           "wire_bytes"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: op name (without its namespace) -> kind
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor",
               "c10d")


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective as it ran on this rank."""
    kind: str
    op: str
    dtype: torch.dtype
    shapes: tuple               # the operands' local shapes
    group: int
    operand_bytes: int
    result_bytes: int


def collective_event(func, args, kwargs) -> CollectiveEvent | None:
    """The :class:`CollectiveEvent` of the op ``func`` on ``args``, or None
    for an op that is not a collective (``wait_tensor`` among them)."""
    ns, _, name = func._schema.name.partition("::")
    kind = _KIND_OF.get(name)
    if ns not in _NAMESPACES or kind is None:
        return None
    inputs = [t for t in tree_leaves(args[:1]) if isinstance(t, torch.Tensor)]
    if not inputs:
        return None
    nbytes = _bytes(inputs)
    if kind == "all-gather":
        group = int(args[1])
        result = nbytes * group
    elif kind == "reduce-scatter":
        group = int(args[2])
        result = nbytes // group
    elif kind == "collective-permute":
        group, result = 2, nbytes
    else:
        group = _group_size(kwargs.get("group_name", args[-1]))
        result = nbytes
    return CollectiveEvent(kind=kind, op=name, dtype=inputs[0].dtype,
                           shapes=tuple(tuple(t.shape) for t in inputs),
                           group=group, operand_bytes=nbytes,
                           result_bytes=result)


def summarize(events) -> dict:
    """``{kind: {"count", "operand_bytes", "result_bytes"}}`` plus
    ``total_operand_bytes`` and ``total_count`` (the reference's
    ``parse_collectives`` dict)."""
    out: dict = {k: {"count": 0, "operand_bytes": 0, "result_bytes": 0}
                 for k in COLLECTIVE_KINDS}
    for e in events:
        out[e.kind]["count"] += 1
        out[e.kind]["operand_bytes"] += e.operand_bytes
        out[e.kind]["result_bytes"] += e.result_bytes
    out["total_operand_bytes"] = sum(
        out[k]["operand_bytes"] for k in COLLECTIVE_KINDS)
    out["total_count"] = sum(out[k]["count"] for k in COLLECTIVE_KINDS)
    return out


_PROPAGATING = [0]      # > 0 while DTensor propagates a global-shape op


class LocalDispatchMode(TorchDispatchMode):
    """A dispatch mode that sees the ops a rank runs on its local tensors:
    a DTensor op is declined so DTensor's dispatch runs beneath the mode,
    and DTensor's sharding propagation (the op run on stand-ins of the
    global shapes, to learn the output's shape) passes through unseen.
    Subclasses implement :meth:`record`, called after each seen op with
    its output."""

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        fn = ShardingPropagator._propagate_tensor_meta_non_cached
        if not getattr(fn, "_unseen", False):
            def unseen(prop, *a, **k):
                _PROPAGATING[0] += 1
                try:
                    return fn(prop, *a, **k)
                finally:
                    _PROPAGATING[0] -= 1
            unseen._unseen = True
            ShardingPropagator._propagate_tensor_meta_non_cached = unseen
            self._restore = fn
        else:
            self._restore = None
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._restore is not None:
                from torch.distributed.tensor._sharding_prop import (
                    ShardingPropagator)
                ShardingPropagator._propagate_tensor_meta_non_cached = \
                    self._restore

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _PROPAGATING[0]:
            self.record(func, args, kwargs, out)
        return out

    def record(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


class CollectiveCounter(LocalDispatchMode):
    """Counts the collectives a rank issues while the mode is on::

        with CollectiveCounter() as cc:
            step()
        cc.summary()      # the reference's parse_collectives dict

    ``events`` keeps each one (:class:`CollectiveEvent`: kind, op, dtype,
    local shapes, group size, operand and result bytes)."""

    def __init__(self) -> None:
        super().__init__()
        self.events: list[CollectiveEvent] = []

    def record(self, func, args, kwargs, out) -> None:
        event = collective_event(func, args, kwargs)
        if event is not None:
            self.events.append(event)

    def summary(self) -> dict:
        return summarize(self.events)


def wire_bytes(kind: str, operand_bytes: int, group: int) -> float:
    """Ring-algorithm bytes actually crossing links, per participant."""
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return operand_bytes * 2.0 * (group - 1) / group
    if kind in ("all-gather", "reduce-scatter"):
        return operand_bytes * (group - 1) / group * (
            group if kind == "all-gather" else 1)
    return float(operand_bytes)
