"""The ``cpu_blocked`` backend: numpy blocked BLAS L3 on the host's cores
(``kernels/cpu_blocked.py``; the reference package's ``backends/cpu.py``).

The same blocked algorithms the card's kernels run, expressed in numpy,
where the (bm, bk, bn) knob has real cache-hierarchy effects.  In the
paper's MKL-vs-BLIS comparison it plays the second baseline library.  It
runs on ``device="cpu"`` only, takes and returns torch CPU tensors (their
numpy views, no copy) and computes in float32 or float64 (precision ``d``
of an install).  It is reachable by name and sits in no chain: a request
for another backend never lands here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.knobs import (Knob, KnobSpace, _grid_parallelism,
                                    block_knob_space)

from .base import Backend

__all__ = ["CpuBlockedBackend", "knob_space_for"]

#: the baseline dims of the default (max-parallelism) knob, as the
#: reference's ``Backend.default_knob``
_BASELINE_DIMS = (4096, 4096, 4096)


def knob_space_for(op: str, *, small: bool = False,
                   sizes: tuple[int, ...] | None = None) -> KnobSpace:
    """Candidate block configs per subroutine (the reference's generic
    ``kernels/ops.py::knob_space_for``).

    GEMM tunes (bm, bk, bn); the 2-dim subroutines tune (bm, bn) with the
    A-dimension block tied to bm (square A tiles), plus the kernel variant
    for the triangular/symmetric-output ops: 'full', 'tri' and
    'tri_packed'.  ``sizes`` overrides the block-edge candidates."""
    if sizes is None:
        sizes = (128, 256) if small else (128, 256, 512)
    if op == "gemm":
        return block_knob_space(bms=sizes, bks=sizes, bns=sizes)
    variants = ("full", "tri", "tri_packed") \
        if op in ("syrk", "syr2k", "trmm") else ("full",)
    space = block_knob_space(bms=sizes, bks=(128,), bns=sizes,
                             variants=variants)
    # collapse bk (unused for 2-dim ops) out of the candidate identity
    seen, cands = set(), []
    for k in space:
        d = k.dict
        key = (d["bm"], d["bn"], d["variant"])
        if key not in seen:
            seen.add(key)
            cands.append({"bm": d["bm"], "bk": d["bm"], "bn": d["bn"],
                          "variant": d["variant"]})
    return KnobSpace("blocks", cands, parallelism_fn=_grid_parallelism)


class CpuBlockedBackend(Backend):
    name = "cpu_blocked"

    #: cache-scale block edges (vs the card's tile edges)
    DEFAULT_SIZES = (64, 128, 256)

    def __init__(self, *, device: torch.device | str = "cpu") -> None:
        super().__init__(device=device)
        if self.device.type != "cpu":
            raise ValueError(f"cpu_blocked runs on the CPU, not on "
                             f"{self.device}")

    def on(self, device: torch.device | str) -> "CpuBlockedBackend":
        if torch.device(device).type != "cpu":
            raise ValueError(f"cpu_blocked runs on the CPU, not on {device}")
        return super().on(device)

    def supports_dtype(self, dtype) -> bool:
        if isinstance(dtype, torch.dtype):
            return dtype in (torch.float32, torch.float64)
        return np.dtype(dtype) in (np.float32, np.float64)

    def knob_space(self, op: str, *,
                   sizes: tuple[int, ...] | None = None) -> KnobSpace:
        return knob_space_for(op, sizes=tuple(sizes or self.DEFAULT_SIZES))

    def default_knob(self, op: str) -> Knob:
        space = self.knob_space(op)
        dims = _BASELINE_DIMS[:3 if op == "gemm" else 2]
        return space.candidates[int(np.argmax(space.parallelism_vec(dims)))]

    def execute(self, op: str, operands: tuple, knob: Knob | None = None,
                **kw) -> torch.Tensor:
        from repro_torch.kernels.cpu_blocked import run_blocked
        if knob is None:
            knob = self.default_knob(op)
        arrays = tuple(x.detach().numpy() for x in self.prepare(operands))
        return torch.from_numpy(run_blocked(op, arrays, knob, **kw))

    def execute_stacked(self, op: str, operands: tuple,
                        knob: Knob | None = None, **kw) -> torch.Tensor:
        """Item by item over the leading batch axis; an operand of one
        rank lower than the stack is shared across it."""
        operands = self.prepare(operands)
        rank = max(x.dim() for x in operands)
        width = next(x.shape[0] for x in operands if x.dim() == rank)
        return torch.stack([
            self.execute(op, tuple(x[i] if x.dim() == rank else x
                                   for x in operands), knob, **kw)
            for i in range(width)])
