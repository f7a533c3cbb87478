"""KnobSpace — the discrete runtime execution-config space ADSALA tunes over.

The paper's knob is the thread count ``nt ∈ {1..cores×HT}``.  On TPU the
runtime-variable knob of a BLAS L3 kernel is its Pallas block configuration
``(bm, bk, bn)`` (DESIGN.md §2).  Both are *finite discrete sets whose choice
changes runtime but not semantics* — the ADSALA mechanism (predict the runtime
of every candidate, run the argmin) only needs:

  * an enumeration of candidates,
  * a scalar ``parallelism(candidate, dims)`` measure that plays the role of
    ``nt`` in the paper's Table-III features.

On the H100 the knob is the CUDA kernel's tile: ``(bm, bk, bn)`` for GEMM
(:func:`hopper_knob_space`), ``(bm, bn)`` and the kernel variant for the
2-dim subroutines (:func:`hopper_2d_knob_space`); launch parameters
(threads, shared memory, a contraction step) are derived from the tile,
never tuned beside it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Sequence

import numpy as np

__all__ = ["Knob", "KnobSpace", "block_knob_space", "hopper_knob_space",
           "hopper_2d_knob_space", "thread_knob_space", "HOPPER_TILES_MN",
           "HOPPER_TILES_K", "HOPPER_CONTRACTION_STEP", "HOPPER_2D_VARIANTS"]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One candidate execution config (an arbitrary mapping of named fields)."""
    values: tuple[tuple[str, Any], ...]

    @property
    def dict(self) -> dict:
        return dict(self.values)

    def __getitem__(self, k: str) -> Any:
        return self.dict[k]

    def __repr__(self) -> str:  # compact, stable — used as cache/registry keys
        return "Knob(" + ",".join(f"{k}={v}" for k, v in self.values) + ")"


class KnobSpace:
    """A named, enumerable space of execution configs."""

    def __init__(self, name: str, candidates: Sequence[dict],
                 parallelism_fn=None) -> None:
        self.name = name
        self.candidates: list[Knob] = [
            Knob(tuple(sorted(c.items()))) for c in candidates
        ]
        if not self.candidates:
            raise ValueError("empty knob space")
        self._parallelism_fn = parallelism_fn

    def __len__(self) -> int:
        return len(self.candidates)

    def __iter__(self):
        return iter(self.candidates)

    def parallelism(self, knob: Knob, dims: tuple[int, ...]) -> float:
        """The ``nt``-analogue feature for this knob at these dims."""
        if self._parallelism_fn is not None:
            return float(self._parallelism_fn(knob, dims))
        if "nt" in knob.dict:
            return float(knob["nt"])
        raise ValueError("knob space has no parallelism definition")

    def parallelism_vec(self, dims: tuple[int, ...]) -> np.ndarray:
        return np.array([self.parallelism(c, dims) for c in self.candidates])

    def index(self, knob: Knob) -> int:
        return self.candidates.index(knob)

    # -- persistence ------------------------------------------------------
    def get_state(self) -> dict:
        return {"name": self.name,
                "candidates": [c.dict for c in self.candidates]}


def thread_knob_space(max_threads: int, *,
                      powers_of_two: bool = False) -> KnobSpace:
    """The paper's literal knob: nt ∈ {1..max_threads} (or powers of two)."""
    if powers_of_two:
        nts = [2 ** i for i in range(int(math.log2(max_threads)) + 1)]
    else:
        nts = list(range(1, max_threads + 1))
    return KnobSpace("threads", [{"nt": t} for t in nts],
                     parallelism_fn=lambda k, dims: k["nt"])


def _grid_parallelism(knob: Knob, dims: tuple[int, ...]) -> float:
    """Parallel Pallas grid cells = ceil(m/bm)*ceil(n/bn) — the nt analogue.

    The ``tri_packed`` variant launches only the lower-triangle blocks, so
    its cell count carries the packed fraction: (cm+1)/2 live row blocks
    per column on average instead of cm.  This is what makes the variant
    *learnable* — it is the only knob-dependent feature channel, and
    without the adjustment full/tri_packed candidates would produce
    byte-identical Table-III rows the model provably cannot separate.
    ('full' and 'tri' launch the same grid — tri's dead cells still occupy
    slots — so those two deliberately share a feature row and tie.)
    Legacy persisted spaces contain no tri_packed candidates, so their
    features are bit-for-bit unchanged.
    """
    d = knob.dict
    if len(dims) == 3:
        m, _, n = dims
    else:
        m, n = dims
    cm = math.ceil(m / d["bm"])
    cn = math.ceil(n / d["bn"])
    if d.get("variant") == "tri_packed":
        return (cm + 1) * cn / 2.0
    return cm * cn


def block_knob_space(
    *,
    bms: Sequence[int] = (128, 256, 512),
    bks: Sequence[int] = (128, 256, 512),
    bns: Sequence[int] = (128, 256, 512),
    vmem_limit_bytes: int = 96 * 1024 * 1024,
    dtype_bytes: int = 4,
    variants: Sequence[str] = ("full",),
) -> KnobSpace:
    """TPU BLAS knob space: Pallas block shapes (bm, bk, bn) (+ kernel variant).

    Candidates whose VMEM working set (A, B, C + accumulator tiles) exceeds
    ``vmem_limit_bytes`` are excluded — they could never be launched.
    ``variants`` optionally adds the triangle-aware kernel variants
    (DESIGN.md §7.4) to the search space.
    """
    cands = []
    for bm, bk, bn, var in itertools.product(bms, bks, bns, variants):
        vmem = dtype_bytes * (bm * bk + bk * bn + 2 * bm * bn)
        if vmem <= vmem_limit_bytes:
            cands.append({"bm": bm, "bk": bk, "bn": bn, "variant": var})
    return KnobSpace("blocks", cands, parallelism_fn=_grid_parallelism)


#: tile edges the Hopper GEMM kernel is instantiated for (kernels/csrc/gemm.cu)
HOPPER_TILES_MN = (64, 128, 256)
HOPPER_TILES_K = (16, 32, 64)

#: shared memory one H100 block may use (227 KB of the SM's 256 KB)
HOPPER_SMEM_BYTES = 232448
#: threads one block may hold
HOPPER_MAX_THREADS = 1024
#: accumulators each thread of the kernel keeps (an 8 x 8 register tile)
HOPPER_ACC_PER_THREAD = 64


def hopper_knob_space(
    *,
    bms: Sequence[int] = HOPPER_TILES_MN,
    bks: Sequence[int] = HOPPER_TILES_K,
    bns: Sequence[int] = HOPPER_TILES_MN,
    dtype_bytes: int = 4,
) -> KnobSpace:
    """H100 GEMM knob space: the CUDA kernel's tile ``(bm, bk, bn)``.

    This replaces :func:`block_knob_space`'s 96 MiB VMEM filter with the
    card's limits: one A and one B tile in shared memory
    (``dtype_bytes * bk * (bm + bn)`` within 227 KB) and ``bm * bn / 64``
    threads (each holding an 8 x 8 accumulator tile) within 1024.  Only
    tiles the kernel is instantiated for are accepted.  The space keeps the
    name ``"blocks"`` and :func:`_grid_parallelism` (the CTA count), which
    the registry and the compiled fast path key on.
    """
    for edge in (*bms, *bns):
        if edge not in HOPPER_TILES_MN:
            raise ValueError(f"no Hopper GEMM instantiation for bm/bn={edge}")
    for edge in bks:
        if edge not in HOPPER_TILES_K:
            raise ValueError(f"no Hopper GEMM instantiation for bk={edge}")
    cands = []
    for bm, bk, bn in itertools.product(bms, bks, bns):
        smem = dtype_bytes * bk * (bm + bn)
        threads = bm * bn // HOPPER_ACC_PER_THREAD
        if smem <= HOPPER_SMEM_BYTES and threads <= HOPPER_MAX_THREADS:
            cands.append({"bm": bm, "bk": bk, "bn": bn, "variant": "full"})
    return KnobSpace("blocks", cands, parallelism_fn=_grid_parallelism)


#: contraction step of the kernels that take a bm x bn output tile and no
#: bk of their own (symm, trmm, and the GEMMs of trsm): a launch parameter,
#: never a candidate.  Every best tile of a 27-tile sweep of the GEMM kernel
#: over the llama3-8b linears on an H100 had bk=64 (``chip_smoke.py``).
HOPPER_CONTRACTION_STEP = 64

#: the 2-dim subroutines with a Hopper kernel, and their kernel variants
#: (the reference's ``kernels/ops.py::knob_space_for``)
HOPPER_2D_VARIANTS = {"symm": ("full",), "syrk": ("full", "tri", "tri_packed"),
                      "syr2k": ("full", "tri", "tri_packed"),
                      "trmm": ("full", "tri", "tri_packed"),
                      "trsm": ("full",)}


def _rank_k_smem_bytes(bm: int, bk: int, *, two: bool,
                       dtype_bytes: int) -> int:
    """Shared memory of a rank-k block: the transposed row tiles of A (and
    B for syr2k) for rows i and j, and the packed kernel's output tile."""
    operands = (4 if two else 2) * bk * (bm + 1)
    return dtype_bytes * max(operands, bm * (bm + 1))


def hopper_2d_knob_space(
    op: str,
    *,
    bms: Sequence[int] = HOPPER_TILES_MN,
    bns: Sequence[int] | None = None,
    dtype_bytes: int = 4,
) -> KnobSpace:
    """H100 knob space of a 2-dim subroutine, with the reference's meaning
    of each field (``src/repro/kernels/ops.py::knob_space_for``):

    * symm, trmm and trsm: ``bm x bn`` is the output tile, edges from
      :data:`HOPPER_TILES_MN`; the contraction step is
      :data:`HOPPER_CONTRACTION_STEP`; trmm has the variants ``full``,
      ``tri`` and ``tri_packed``;
    * syrk and syr2k: ``bm`` is the square output tile and ``bn`` the
      contraction block, from :data:`HOPPER_TILES_K`; the variants are
      ``full``, ``tri`` and ``tri_packed``.

    ``bk`` repeats ``bm`` and is unused, as in the reference.  Tiles of
    1024 threads (``bm * bn / 64`` or ``bm * bm / 64``) are left out: the
    GEMM kernel's 256x256 tiles spill 1488-2696 bytes a thread (its
    ``-Xptxas -v`` report for ``sm_90a``).  ``full`` and ``tri`` launch
    the same grid and so share a feature row (:func:`_grid_parallelism`),
    as in the reference, and ``tri_packed`` has a row of its own.
    """
    if op not in HOPPER_2D_VARIANTS:
        raise ValueError(f"no Hopper kernel for {op!r}; ported 2-dim ops: "
                         f"{sorted(HOPPER_2D_VARIANTS)}")
    rank_k = op in ("syrk", "syr2k")
    if bns is None:
        bns = HOPPER_TILES_K if rank_k else HOPPER_TILES_MN
    for edge in bms:
        if edge not in HOPPER_TILES_MN:
            raise ValueError(f"no Hopper {op} instantiation for bm={edge}")
    for edge in bns:
        if edge not in (HOPPER_TILES_K if rank_k else HOPPER_TILES_MN):
            raise ValueError(f"no Hopper {op} instantiation for bn={edge}")
    cands = []
    for bm, bn, var in itertools.product(bms, bns, HOPPER_2D_VARIANTS[op]):
        if rank_k:
            threads = bm * bm // HOPPER_ACC_PER_THREAD
            smem = _rank_k_smem_bytes(bm, bn, two=op == "syr2k",
                                      dtype_bytes=dtype_bytes)
        else:
            threads = bm * bn // HOPPER_ACC_PER_THREAD
            smem = dtype_bytes * HOPPER_CONTRACTION_STEP * (bm + 1 + bn)
        if smem <= HOPPER_SMEM_BYTES and threads < HOPPER_MAX_THREADS:
            cands.append({"bm": bm, "bk": bm, "bn": bn, "variant": var})
    return KnobSpace("blocks", cands, parallelism_fn=_grid_parallelism)
