"""The ``Backend`` protocol — one pluggable "black-box BLAS" implementation.

The paper demonstrates the same ML runtime-selection mechanism on two baseline
BLAS libraries (MKL and BLIS); this repo generalises that to any executable
L3 implementation.  A backend bundles everything the ADSALA pipeline needs to
treat an implementation as a tunable black box:

  * ``ops()``          — the subroutines it can execute,
  * ``knob_space(op)`` — its discrete per-op runtime-config candidates
                         (the ``nt`` analogue; here the kernel's tile),
  * ``default_knob(op)`` — the paper's baseline config (max parallelism),
  * ``timer_fn(op, dtype)`` — a timer for install-time calibration,
  * ``execute(op, operands, knob)`` — run the op under a chosen config.

A backend runs on one ``device``: operands are moved there, results stay
there.  :meth:`Backend.on` gives the same backend on another device (the
tests run the ``hopper`` backend on the CPU, where its kernels compute their
plain versions).  Install-time tuning, persistence, runtime decisions and
dispatch are all keyed by ``backend.name``.
"""

from __future__ import annotations

import abc
import copy
from typing import Callable

import torch

from repro_torch.core.knobs import Knob, KnobSpace
from repro_torch.core.timing import time_callable

__all__ = ["Backend", "L3_OPS"]

#: the six BLAS L3 subroutines of paper Table I
L3_OPS = ("gemm", "symm", "syrk", "syr2k", "trmm", "trsm")


class Backend(abc.ABC):
    """One executable BLAS L3 implementation with a tunable knob space."""

    #: registry key; also the tag on persisted artifacts and runtime caches
    name: str = "abstract"

    def __init__(self, *, device: torch.device | str = "cuda") -> None:
        self.device = torch.device(device)

    def on(self, device: torch.device | str) -> "Backend":
        """This backend bound to ``device`` (itself when already there)."""
        device = torch.device(device)
        if device == self.device:
            return self
        view = copy.copy(self)
        view.device = device
        return view

    # -- capability ----------------------------------------------------------
    def ops(self) -> tuple[str, ...]:
        return L3_OPS

    def is_available(self) -> bool:
        """Whether this backend's device exists on this host."""
        if self.device.type == "cuda":
            return torch.cuda.is_available()
        return self.device.type == "cpu"

    def supports_dtype(self, dtype) -> bool:
        """Whether this backend executes ``dtype`` at full precision."""
        return True

    # -- knob space ----------------------------------------------------------
    @abc.abstractmethod
    def knob_space(self, op: str, *,
                   sizes: tuple[int, ...] | None = None) -> KnobSpace:
        """Candidate execution configs for ``op`` on this backend."""

    @abc.abstractmethod
    def default_knob(self, op: str) -> Knob:
        """Baseline config (paper: max threads) = max parallelism."""

    # -- execution -----------------------------------------------------------
    @abc.abstractmethod
    def execute(self, op: str, operands: tuple, knob: Knob | None = None,
                **kw) -> torch.Tensor:
        """Run ``op`` on ``operands`` (moved to this backend's device) under
        ``knob``; returns the result on the device."""

    def execute_stacked(self, op: str, operands: tuple,
                        knob: Knob | None = None, **kw) -> torch.Tensor:
        """Run ``op`` over operands carrying a leading batch axis — the
        serving layer's bucket-execution primitive (one knob covers the
        whole stack).  Operands of one-lower rank than the stack are shared
        across it.  The port's executors take the batch axis natively, so
        this is :meth:`execute`."""
        return self.execute(op, operands, knob, **kw)

    def prepare(self, operands: tuple) -> tuple:
        """Operands as tensors on this backend's device (no copy for a
        tensor already there)."""
        return tuple(torch.as_tensor(x, device=self.device) for x in operands)

    def make_operands(self, op: str, dims: tuple[int, ...],
                      dtype: torch.dtype = torch.float32,
                      seed: int = 0) -> tuple:
        """Standard-normal calibration inputs of the right shapes for
        ``op``, drawn on this backend's device from a generator seeded
        with ``seed``.  The reference package draws its calibration
        operands with numpy on the host; drawing them on the card keeps
        hundreds of MB of operands from crossing the bus for every
        sampled dims, at the price of other values than the reference's
        for the same seed (the timings do not depend on the values).

        The shapes follow the reference's
        ``kernels/cpu_blocked.py::make_operands``; trsm's A gets ``m * I``
        added, which makes it diagonally dominant, so the timing sweep
        solves well-conditioned systems."""
        if op == "gemm":
            m, k, n = dims
            shapes = ((m, k), (k, n))
        elif op in ("symm", "trmm", "trsm"):
            m, n = dims
            shapes = ((m, m), (m, n))
        elif op == "syrk":
            shapes = (tuple(dims),)
        elif op == "syr2k":
            shapes = (tuple(dims), tuple(dims))
        else:
            raise ValueError(f"no calibration operands for {op!r} yet; "
                             f"known: gemm, symm, syrk, syr2k, trmm, trsm")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        out = tuple(torch.randn(shape, generator=gen, device=self.device,
                                dtype=dtype) for shape in shapes)
        if op == "trsm":
            out[0].diagonal().add_(dims[0])
        return out

    # -- calibration ---------------------------------------------------------
    def timer_fn(self, op: str, dtype: torch.dtype = torch.float32, *,
                 warmup: int = 1,
                 repeats: int = 2) -> Callable[[tuple, Knob], float]:
        """``timer(dims, knob) -> seconds`` for the install-time sweep, with
        operand caching across the per-dims knob sweep."""
        cache: dict = {"dims": None, "operands": None}

        def timer(dims: tuple, knob: Knob) -> float:
            if cache["dims"] != dims:
                cache["operands"] = None      # free the last dims' operands
                cache["operands"] = self.make_operands(
                    op, dims, dtype, seed=hash(dims) % (2 ** 31))
                cache["dims"] = dims
            operands = cache["operands"]
            return time_callable(lambda: self.execute(op, operands, knob),
                                 device=self.device, warmup=warmup,
                                 repeats=repeats)

        return timer

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r}, " \
               f"device={str(self.device)!r})"
