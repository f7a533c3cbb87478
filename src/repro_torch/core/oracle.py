"""Analytic H100 time oracle for the Hopper kernels' knobs.

The install pipeline measures its labels on the card (``core/timing.py``).
This oracle stands in for those measurements where the card cannot be
timed: rehearsing an install on a CPU-only host (the same sampling,
features, preprocessing, model selection and runtime argmin, against a
deterministic cost surface), and pruning knob candidates that cannot win
at a harvested call site before an install pays to time them
(``roofline/costing.py::prune_dominated_candidates``).

It keeps the reference package's three-term form and its per-op operation
and byte counts, with the TPU's parts replaced by the card's:

  compute   = waves x work a CTA x CTAs an SM holds at once
              / (SM rate x tile efficiency)
  memory    = bytes(blocking) / HBM rate       (A re-read ceil(n/bn) times,
                                                B re-read ceil(m/bm) times,
                                                C read and written once)
  overhead  = launches x launch cost + CTAs an SM runs x CTA cost

  t = max(compute, memory) + overhead  (+ optional lognormal noise)

The CTAs are the knob's grid (:func:`~repro_torch.core.knobs.
_grid_parallelism`, the feature the runtime's models see, at the output's
dims: syrk and syr2k's n x n), quantised into
waves over the card's SMs at the occupancy the tile's launch parameters
allow (``kernels/gemm.py::mainloop_params``: threads, shared bytes).  The
tile efficiency grows with the pass's area over its perimeter (operand
reuse from shared memory) and with the contraction step (fewer barriers
a k-step), and is 0.6 at the largest pass and step: the f32 mainloop ran
at 54-59 % of the f32 bound at its best tiles on an H100 (``chip_smoke.py``
phase 7, ``PERF.md``).  The launch and CTA costs are modelling constants,
not measurements.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .knobs import HOPPER_CONTRACTION_STEP, Knob, _grid_parallelism

__all__ = ["GpuSpec", "H100_SXM", "oracle_time", "cta_occupancy",
           "tile_efficiency"]


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """One card's rates for the oracle.

    :data:`H100_SXM` is the NVIDIA H100 SXM (80 GB HBM3) at its 700 W power
    limit: 67 TFLOP/s IEEE float32 on the CUDA cores and 3.35 TB/s of HBM3
    (NVIDIA's data sheet; the bound ``chip_smoke.py`` and ``PERF.md`` hold
    the kernels to), 132 SMs of 2048 threads, 64 K registers and 228 KB of
    shared memory each.  A card set below 700 W runs slower under load."""
    name: str = "NVIDIA H100 SXM 80GB HBM3, 700 W"
    peak_flops_f32: float = 67e12        # IEEE f32, CUDA cores
    hbm_bw: float = 3.35e12              # bytes/s
    sms: int = 132
    threads_per_sm: int = 2048
    regs_per_sm: int = 65536
    smem_per_sm: int = 233472            # bytes
    max_ctas_per_sm: int = 32
    launch_s: float = 4e-6               # a launch's fixed cost (model)
    cta_s: float = 0.5e-6                # a CTA's prologue/epilogue (model)
    best_efficiency: float = 0.6         # the mainloop at its best tile


H100_SXM = GpuSpec()


def _tile(op: str, knob: dict) -> tuple[int, int, int]:
    """The (bm, bk, bn) the kernel of ``op`` runs for ``knob``: the GEMM's
    own, symm/trmm/trsm's output tile with the fixed contraction step,
    syrk/syr2k's square ``bm`` tile with ``bn`` as the contraction block."""
    bm, bn = int(knob["bm"]), int(knob["bn"])
    if op == "gemm":
        return bm, int(knob["bk"]), bn
    if op in ("syrk", "syr2k"):
        return bm, bn, bm
    return bm, HOPPER_CONTRACTION_STEP, bn


#: shared bytes the mainloop's cp.async ring may take (half a block's
#: 227 KB, ``kernels/gemm.py::RING_BUDGET``)
_RING_BUDGET = 232448 // 2


def _launch_params(bm: int, bk: int, bn: int) -> tuple[int, int, int]:
    """(threads, shared bytes, accumulators a thread) of the f32 mainloop
    for the tile, as ``kernels/gemm.py::mainloop_params`` derives them
    (copied here so the oracle imports no kernel module)."""
    pm, pn = (bm, bn) if bm * bn <= 128 * 128 else (min(bm, 128),
                                                     min(bn, 128))
    threads = min(256, max(128, pm * pn // 64))
    stage = 4 * bk * (pm + pn)
    stages = next((s for s in (4, 3) if s * stage <= _RING_BUDGET), 2)
    return threads, stages * stage, pm * pn // threads


def cta_occupancy(bm: int, bk: int, bn: int, spec: GpuSpec = H100_SXM) -> int:
    """CTAs of this tile one SM holds at once: limited by threads, shared
    memory and registers (the accumulators plus 64 a thread)."""
    threads, smem, acc = _launch_params(bm, bk, bn)
    regs = min(255, acc + 64) * threads
    occ = min(spec.threads_per_sm // threads, spec.smem_per_sm // max(1, smem),
              spec.regs_per_sm // regs, spec.max_ctas_per_sm)
    return max(1, occ)


def tile_efficiency(bm: int, bk: int, bn: int,
                    spec: GpuSpec = H100_SXM) -> float:
    """Share of an SM's f32 rate the mainloop reaches with this tile:
    ``best_efficiency`` x (pass area over perimeter, against a 128 x 128
    pass) x (the k-step's work over its barrier, against a step of 64)."""
    pm, pn = min(bm, 128), min(bn, 128)
    reuse = (pm * pn / (pm + pn)) / 64.0
    step = (bk / (bk + 16)) / (64 / 80)
    return spec.best_efficiency * min(1.0, reuse) * min(1.0, step)


def _flops_bytes(op: str, dims: tuple[int, ...], knob: dict,
                 dtype_bytes: int) -> tuple[float, float]:
    """Operations and bytes of one call (the reference package's
    ``core/oracle.py::_flops_bytes``, unchanged)."""
    bm, bk, bn = knob["bm"], knob["bk"], knob["bn"]
    variant = knob.get("variant", "full")
    if op == "gemm":
        m, k, n = dims
        flops = 2.0 * m * k * n
        rbytes = dtype_bytes * (m * k * math.ceil(n / bn)
                                + k * n * math.ceil(m / bm) + 2 * m * n)
        return flops, rbytes
    if op == "symm":
        m, n = dims
        flops = 2.0 * m * m * n
        rbytes = dtype_bytes * (m * m * math.ceil(n / bn)
                                + m * n * math.ceil(m / bm) + 2 * m * n)
        return flops, rbytes
    if op in ("syrk", "syr2k"):
        n, k = dims
        mult = 2.0 if op == "syr2k" else 1.0
        tri = 0.55 if variant == "tri" else 1.0   # tri kernels do ~half FLOPs
        flops = mult * 2.0 * n * n * k * tri
        rbytes = dtype_bytes * (mult * n * k * math.ceil(n / bn) * tri
                                + 2 * n * n)
        return flops, rbytes
    if op in ("trmm", "trsm"):
        m, n = dims
        tri = 0.55 if variant == "tri" else 1.0
        flops = m * m * n * tri * (1.0 if op == "trmm" else 1.0)
        flops *= 2.0
        rbytes = dtype_bytes * (m * m * math.ceil(n / bn) * tri
                                + 2 * m * n * math.ceil(m / bm))
        return flops, rbytes
    raise ValueError(op)


def oracle_time(op: str, dims: tuple[int, ...], knob, *,
                dtype_bytes: int = 4, spec: GpuSpec = H100_SXM,
                noise_rng: np.random.Generator | None = None,
                noise_sigma: float = 0.03) -> float:
    """Predicted seconds for one call of ``op`` at ``dims`` under ``knob``
    on ``spec`` (the kernels compute in float32 whatever ``dtype_bytes``
    says of the operands' size)."""
    kd = knob.dict if hasattr(knob, "dict") else dict(knob)
    dims = tuple(int(d) for d in dims)
    flops, rbytes = _flops_bytes(op, dims, kd, dtype_bytes)
    bm, bk, bn = _tile(op, kd)
    # the output's tiles: syrk/syr2k's (n, k) dims hold an n x n output
    out_dims = (dims[0], dims[0]) if op in ("syrk", "syr2k") else dims
    ctas = max(1, int(math.ceil(_grid_parallelism(
        Knob(tuple(sorted(kd.items()))), out_dims))))
    occ = cta_occupancy(bm, bk, bn, spec)
    waves = math.ceil(ctas / (spec.sms * occ))
    per_sm = min(occ, math.ceil(ctas / spec.sms))
    sm_rate = spec.peak_flops_f32 / spec.sms
    t_compute = (waves * (flops / ctas) * per_sm
                 / (sm_rate * tile_efficiency(bm, bk, bn, spec)))
    t_memory = rbytes / spec.hbm_bw
    launches = 2 if op == "trsm" else 1
    t_overhead = (launches * spec.launch_s
                  + math.ceil(ctas / spec.sms) * spec.cta_s)
    t = max(t_compute, t_memory) + t_overhead
    if noise_rng is not None:
        t *= float(np.exp(noise_rng.normal(0.0, noise_sigma)))
    return float(t)

