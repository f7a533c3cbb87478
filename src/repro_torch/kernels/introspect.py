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
* **device windows** — :func:`launch_window` times the kernels the
  calling thread launches inside the block: every wrapper passes its
  launcher a pair of CUDA events (:func:`launch_events`), which the
  launcher records on its stream just before and just after its launch,
  within the one C call.  So the window holds the kernels' device time
  and none of the host's work around them (the decision, the backend
  lookup, the wrapper's checks, and any wait for the GIL, which events
  recorded from Python on an idle stream would count).  The install's
  timer (``core/timing.py``) and the service's bucket telemetry both
  read it.
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

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["KERNELS", "record_launch", "launch_counts", "reset_launches",
           "capture_launches", "launch_events", "launch_window",
           "LaunchWindow", "CopyCounter", "copy_op_counts",
           "COPY_OPS", "grid_slots", "full_grid_for", "packed_grid_for",
           "packed_slot_ratio"]

#: the kernels whose launches are recorded (``trsm`` the substitution of
#: ``csrc/trsm.cu``, ``trsm_inv`` its diagonal-block inverses)
KERNELS = ("gemm", "symm", "rank_k", "rank_k_packed", "trmm", "trmm_packed",
           "trsm", "trsm_inv")

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


class LaunchWindow:
    """The kernels one thread launched inside a :func:`launch_window`
    block: a pair of CUDA events for each launch, which its C launcher
    records on its stream just before and just after the launch, within
    the one call (``csrc/launch_grid.cuh``'s ``TimedLaunch``)."""
    __slots__ = ("spans",)

    def __init__(self) -> None:
        self.spans: list[tuple] = []

    @property
    def launches(self) -> int:
        return len(self.spans)

    def seconds(self) -> float | None:
        """Device seconds of the launches, summed (waits for each end
        event); None when nothing was launched."""
        if not self.spans:
            return None
        total = 0.0
        for start, end in self.spans:
            end.synchronize()
            total += start.elapsed_time(end)
        return total / 1e3


def launch_events() -> tuple:
    """The ``(start, end)`` event handles a kernel wrapper passes to its
    launcher: inside a :func:`launch_window` two new CUDA events of the
    window (each recorded once on the current stream here, so that PyTorch
    reads them; the launcher records them again around its launch),
    outside one ``(None, None)`` — the launcher then records nothing."""
    window = getattr(_LOCAL, "window", None)
    if window is None:
        return None, None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    end.record()
    window.spans.append((start, end))
    return start.cuda_event, end.cuda_event


@contextlib.contextmanager
def launch_window():
    """Yield a :class:`LaunchWindow` timing the kernels the calling thread
    launches inside the block (windows do not nest: an inner block times
    its own launches and the outer one resumes after it)."""
    outer = getattr(_LOCAL, "window", None)
    window = _LOCAL.window = LaunchWindow()
    try:
        yield window
    finally:
        _LOCAL.window = outer


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
    and not part of the grid).  The GEMM's grid x counts the n-tiles of
    every slice of :func:`~repro_torch.kernels.gemm.split_plan`.  ``trsm``
    is its substitution kernel, one block per column strip and item;
    ``trsm_inv`` its inverse kernel, one block per diagonal block, chunk of
    :data:`~repro_torch.kernels.trsm.INV_COLS` columns and item."""
    if op == "gemm":
        # the n-tiles times the slices of a split contraction (grid x)
        from .gemm import split_plan
        m, k, n = dims
        return (_cdiv(n, bn) * split_plan(m, n, k, bm, bn)[0], _cdiv(m, bm),
                batch)
    if op in ("symm", "trmm"):
        m, n = dims
        return (_cdiv(n, bn), _cdiv(m, bm), batch)
    if op in ("syrk", "syr2k"):
        nb = _cdiv(dims[0], bm)
        return (nb, nb, batch)
    if op == "trsm":
        return (_cdiv(dims[1], bn), 1, batch)
    if op == "trsm_inv":
        from .trsm import INV_COLS
        return (_cdiv(dims[0], bm), bm // INV_COLS, batch)
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
