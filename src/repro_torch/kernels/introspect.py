"""Launch and copy introspection for the port's structural contracts (the
reference package's ``kernels/introspect.py``, which walks jaxprs).

Three things that numerics alone cannot witness:

* **launches** — every kernel wrapper calls :func:`record_launch` with the
  grid its C launcher reports having launched (an out-parameter of every
  launcher in ``csrc/``), so a count or a grid read here is what ran on
  the card, not a second derivation.  One lock guards the counts: the
  serving layer launches from a pool of worker threads.
  :func:`capture_launches` collects the calling thread's launches, which
  is exact under concurrency because a wrapper records on the thread that
  launched.
* **copies** — :class:`CopyCounter`, a ``TorchDispatchMode``, counts the
  ATen ops that materialise operand data (pads, clones and copies, cats
  and stacks, gathers) on the dispatch path.  The masked kernels promise
  zero such ops in ``run_op`` (the reference's
  ``test_no_pad_or_slice_in_dispatch``).  Views and ``torch.empty``
  outputs are not copies.
* **grids** — :func:`full_grid_for` and :func:`packed_grid_for` give the
  CUDA grid ``(x, y, z)`` each kernel launches, and
  :func:`packed_slot_ratio` the blocks of ``tri`` over those of
  ``tri_packed``.  The reference's ``BENCH_kernels.json`` records a ratio
  of the same name for the TPU, but its grid cells count contraction steps
  too (here the contraction loop runs inside a block), so the two ratios
  do not compare.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading

from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["KERNELS", "record_launch", "launch_counts", "reset_launches",
           "capture_launches", "CopyCounter", "copy_op_counts",
           "COPY_OPS", "grid_slots", "full_grid_for", "packed_grid_for",
           "packed_slot_ratio"]

#: the kernels whose launches are recorded (``trsm`` counts the GEMM
#: launches a solve issues, which ``gemm`` counts too)
KERNELS = ("gemm", "symm", "rank_k", "rank_k_packed", "trmm", "trmm_packed",
           "trsm")

_LOCK = threading.Lock()
_COUNTS: collections.Counter = collections.Counter()
_LOCAL = threading.local()


def record_launch(kernel: str, grid) -> None:
    """Count one launch of ``kernel`` with the CUDA ``grid`` it ran."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    grid = tuple(int(g) for g in grid)
    with _LOCK:
        _COUNTS[kernel] += 1
    for sink in getattr(_LOCAL, "sinks", ()):
        sink.append((kernel, grid))


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`."""
    with _LOCK:
        return {k: _COUNTS[k] for k in KERNELS}


def reset_launches() -> None:
    with _LOCK:
        _COUNTS.clear()


@contextlib.contextmanager
def capture_launches():
    """Collect ``(kernel, grid)`` of every launch the calling thread makes
    inside the block into the list it yields."""
    sink: list = []
    sinks = getattr(_LOCAL, "sinks", None)
    if sinks is None:
        sinks = _LOCAL.sinks = []
    sinks.append(sink)
    try:
        yield sink
    finally:
        # by identity: an equal list of an enclosing capture is not this one
        del sinks[next(i for i, s in enumerate(sinks) if s is sink)]


# ---------------------------------------------------------------------------
# copies on the dispatch path
# ---------------------------------------------------------------------------

#: ATen ops (overload packets) that materialise operand data; views,
#: ``empty`` and the kernels' own launches (ctypes, no ATen op) are not
#: among them
COPY_OPS = ("constant_pad_nd", "clone", "copy_", "_to_copy", "cat", "stack",
            "index", "gather", "index_select")


class CopyCounter(TorchDispatchMode):
    """Counts :data:`COPY_OPS` dispatched while the mode is active, by op
    name, in :attr:`counts`."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in COPY_OPS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def copy_op_counts(fn, *args, **kwargs) -> dict[str, int]:
    """Counts of :data:`COPY_OPS` in ``fn(*args, **kwargs)``."""
    with CopyCounter() as counter:
        fn(*args, **kwargs)
    return dict(counter.counts)


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

def grid_slots(grid) -> int:
    return math.prod(grid)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def full_grid_for(op: str, dims: tuple[int, ...], bm: int,
                  bn: int | None = None, *, batch: int = 1
                  ) -> tuple[int, int, int]:
    """The CUDA grid of the ``full``/``tri`` kernel (gemm and symm have only
    that one) of ``op`` at ``dims`` under the output tile ``bm x bn``
    (syrk/syr2k: the square tile ``bm``; ``bn`` is their contraction block
    and not part of the grid)."""
    if op == "gemm":
        m, _, n = dims
        return (_cdiv(n, bn), _cdiv(m, bm), batch)
    if op in ("symm", "trmm"):
        m, n = dims
        return (_cdiv(n, bn), _cdiv(m, bm), batch)
    if op in ("syrk", "syr2k"):
        nb = _cdiv(dims[0], bm)
        return (nb, nb, batch)
    raise ValueError(f"no full grid for {op!r}")


def packed_grid_for(op: str, dims: tuple[int, ...], bm: int,
                    bn: int | None = None, *, batch: int = 1
                    ) -> tuple[int, int, int]:
    """The CUDA grid of the ``tri_packed`` kernel: the ``nb (nb + 1) / 2``
    lower tiles for syrk/syr2k (``csrc/rank_k_packed.cu``), the n-tiles
    times ``ceil(nb / 2)`` row-block pairs for trmm
    (``csrc/trmm_packed.cu``)."""
    if op in ("syrk", "syr2k"):
        nb = _cdiv(dims[0], bm)
        return (nb * (nb + 1) // 2, 1, batch)
    if op == "trmm":
        m, n = dims
        return (_cdiv(n, bn), _cdiv(_cdiv(m, bm), 2), batch)
    raise ValueError(f"no packed grid for {op!r}")


def packed_slot_ratio(op: str, dims: tuple[int, ...], bm: int,
                      bn: int | None = None) -> float:
    """Blocks ``tri`` launches over blocks ``tri_packed`` launches."""
    return grid_slots(full_grid_for(op, dims, bm, bn)) / \
        grid_slots(packed_grid_for(op, dims, bm, bn))
