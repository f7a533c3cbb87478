"""The ``ref`` backend: the PyTorch oracles of ``kernels/ref.py``.

It is reachable only by asking for it by name (the port has no fallback
chain).  Its knob space is a single no-op candidate so the tuner/runtime
machinery stays total over it.
"""

from __future__ import annotations

import torch

from repro_torch.core.knobs import Knob, KnobSpace, _grid_parallelism

from .base import Backend

__all__ = ["RefBackend"]


class RefBackend(Backend):
    name = "ref"

    def knob_space(self, op: str, *,
                   sizes: tuple[int, ...] | None = None) -> KnobSpace:
        edge = (sizes or (128,))[0]
        return KnobSpace("blocks",
                         [{"bm": edge, "bk": edge, "bn": edge,
                           "variant": "full"}],
                         parallelism_fn=_grid_parallelism)

    def default_knob(self, op: str) -> Knob:
        return self.knob_space(op).candidates[0]      # the only candidate

    def execute(self, op: str, operands: tuple, knob: Knob | None = None,
                **kw) -> torch.Tensor:
        # the oracles broadcast over a leading batch axis, so a stack is one
        # call; syrk/syr2k read C as the knob's variant says
        from repro_torch.kernels.ref import REFS
        if op in ("syrk", "syr2k") and knob is not None:
            kw = {"variant": knob.dict.get("variant", "full"), **kw}
        return REFS[op](*self.prepare(operands), **kw)
