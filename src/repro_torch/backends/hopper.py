"""The ``hopper`` backend: the port's hand-written CUDA kernels for the H100
(``kernels.ops``), in place of the reference package's ``pallas`` backend.

It runs on the CUDA card by default and raises where there is none.  Bound
to the CPU (``HopperBackend(device="cpu")`` or ``run_op(..., device="cpu")``)
it computes each kernel's plain PyTorch version, which is how the tests
drive it on hosts without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.knobs import Knob, KnobSpace

from .base import Backend

__all__ = ["HopperBackend"]


class HopperBackend(Backend):
    name = "hopper"

    def ops(self) -> tuple[str, ...]:
        from repro_torch.kernels.ops import HOPPER_OPS
        return tuple(HOPPER_OPS)

    def knob_space(self, op: str, *,
                   sizes: tuple[int, ...] | None = None) -> KnobSpace:
        from repro_torch.kernels.ops import knob_space_for
        return knob_space_for(op, sizes=tuple(sizes) if sizes else None)

    def supports_dtype(self, dtype) -> bool:
        """float32 and bfloat16, as the reference's Pallas backend reports
        them (it takes every dtype narrower than 8 bytes and reports
        float64 unsupported): every op has a bfloat16 kernel
        (``csrc/{gemm,symm,rank_k,rank_k_packed,trmm,trmm_packed,trsm}_
        bf16.cu``).  float16 stays unreported until its kernels exist,
        the one dtype on which the two differ.  Reporting bfloat16 asks
        for no install at 2 bytes: calibration's precisions are ``s`` and
        ``d`` (``launch/calibrate.py::PRECISIONS``), so a bf16 call takes
        the default knob."""
        if isinstance(dtype, torch.dtype):
            return dtype in (torch.float32, torch.bfloat16)
        return np.dtype(dtype).name in ("float32", "bfloat16")

    def default_knob(self, op: str) -> Knob:
        from repro_torch.kernels.ops import default_knob
        return default_knob(op)

    def execute(self, op: str, operands: tuple, knob: Knob | None = None,
                **kw) -> torch.Tensor:
        # a stack is one launch: the batch is the kernel's grid z axis
        from repro_torch.kernels.ops import HOPPER_OPS
        return HOPPER_OPS[op](*self.prepare(operands), knob=knob, **kw)
