"""Per-rank FLOP, byte, collective and memory counts of one eager step
(what the reference package reads from ``compiled.cost_analysis()`` and
``memory_analysis()``).

:func:`count_step` runs ``fn`` under :class:`StepCounter`, a
:class:`~repro_torch.roofline.collectives.LocalDispatchMode`: every op
the rank runs on its local tensors passes through it, the ops DTensor
runs on each rank's shards (after any redistribution its sharding
propagation inserts) among them, and the ops of a ``Ctx.local`` region as
they are.  A dispatch mode that counted the DTensor ops themselves would
count the global work (the whole mesh's), not the rank's.

- FLOPs: ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions, fused attention) on the local
  shapes.
- bytes: each op's tensor operands and results, summed, for every op
  that is not a view or metadata query and not an allocation alone
  (``empty``): what the eager port reads and writes, with no fusion.
  That is more than XLA's ``bytes accessed`` for the same program, whose
  fused elementwise chains keep their intermediates out of HBM; a chain
  of n elementwise ops here reads and writes n tensors.
- coll: the collectives' dict (:func:`~repro_torch.roofline.collectives.
  summarize`), with every event in ``coll_events``.
- memory: ``argument_bytes``, the local bytes of ``fn``'s tensor inputs
  (a DTensor's local shard, as its placements cut it; a module's
  parameters); ``output_bytes``, those of its outputs; ``temp_bytes``,
  the high-water mark of the storages the step allocated and still held
  (each storage counted from the op that made it to its release);
  ``peak_bytes = temp + argument``, as the reference's record has it.

Under ``FakeTensorMode`` with fake DTensors (:func:`fake_dtensor`, as
``launch/dryrun.py`` makes them) the step allocates nothing and launches
nothing, and the counts are those of rank 0 of the mesh.  On real
tensors the same counter counts a real step.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._pytree import tree_leaves

from .collectives import (LocalDispatchMode, collective_event, summarize)

__all__ = ["StepCounter", "count_step", "local_bytes", "fake_dtensor"]

#: ops that only allocate (no bytes read or written)
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}
#: collective bookkeeping (``wait_tensor`` hands back its input) and
#: metadata ops: no bytes moved, nothing allocated
_NO_BYTES = {"wait_tensor", "_wrap_tensor_autograd", "device", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
             "_local_scalar_dense"}


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """The bytes of the tensors of ``tree`` (dicts, lists, tuples, an
    ``nn.Module``'s parameters) as this rank holds them: a DTensor's local
    shard."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            yield from _tensors(leaf)
        elif isinstance(leaf, torch.Tensor):
            yield _local(leaf)


class StepCounter(LocalDispatchMode):
    """FLOPs, bytes, collectives and live memory of the ops a rank runs
    while the mode is on (see the module's docstring)."""

    def __init__(self, held=()) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.events = []
        self.live = 0
        self.high = 0
        # the storages of the inputs, which the step does not allocate
        self._held = {id(t.untyped_storage()) for t in _tensors(held)}
        self._owned: dict[int, int] = {}

    def _release(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def record(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        event = collective_event(func, args, kwargs)
        if event is not None:
            self.events.append(event)
        name = func._schema.name.partition("::")[2]
        if func.is_view or name in _NO_BYTES:
            return          # nothing moved, nothing allocated
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if name not in _ALLOCATIONS:
            operands = [t for t in tree_leaves((args, kwargs))
                        if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in operands + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._owned or key in self._held:
                continue
            self._owned[key] = st.nbytes()
            weakref.finalize(st, self._release, key)
            self.live += self._owned[key]
            self.high = max(self.high, self.live)


def count_step(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once under :class:`StepCounter`:
    ``{flops, bytes, coll, coll_events, argument_bytes, output_bytes,
    temp_bytes, peak_bytes}`` for this rank."""
    argument_bytes = local_bytes((args, kwargs))
    counter = StepCounter(held=(args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "coll": summarize(counter.events),
            "coll_events": counter.events,
            "argument_bytes": argument_bytes,
            "output_bytes": local_bytes(out),
            "temp_bytes": counter.high,
            "peak_bytes": counter.high + argument_bytes}


def fake_dtensor(shape, dtype, mesh, spec, device, *,
                 requires_grad: bool = False):
    """A DTensor of global ``shape`` laid out by ``spec`` on ``mesh`` whose
    local shard (rank 0's) is a tensor of the active ``FakeTensorMode`` on
    ``device``: nothing allocated."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.models.sharding import placements
    pl = placements(spec, mesh)
    shape = torch.Size(shape)
    with unset_fake_temporarily():
        local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
        stride = torch.empty(shape, device="meta").stride()
    t = torch.empty(local, dtype=dtype, device=device)
    out = DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                             stride=stride)
    return out.requires_grad_() if requires_grad else out
