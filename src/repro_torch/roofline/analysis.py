"""Three-term roofline of a dry-run cell (the reference package's
``roofline/analysis.py``) on the H100's constants.

    compute    = FLOPs a rank / peak FLOP/s
    memory     = bytes a rank / HBM bytes/s
    collective = collective operand bytes a rank / (link bytes/s x links)

The counts are per rank (``roofline/counting.py::count_step``), as the
reference's ``cost_analysis()`` numbers are per device; ``chips`` scales
them to the whole step for ``useful_ratio``.  ``model_flops`` is 6·N·D
(dense) or 6·N_active·D (MoE) for a train step, 2·N(_active)·D for
inference, so MODEL_FLOPs over the counted FLOPs flags recomputation
(remat) and redundant work.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.oracle import H100_SXM

__all__ = ["HW", "RooflineReport", "roofline", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's rates, under the reference's field names."""
    # NVIDIA H100 SXM 80GB HBM3, 700 W: bf16 dense on the tensor cores
    # (NVIDIA's data sheet; 1,979 TFLOP/s is the 2:4-sparse figure).  The
    # dry run counts serving weights in compute_dtype, as the reference
    # does; an f32 cell's rate is H100_SXM.peak_flops_f32 (67e12)
    peak_flops: float = 989.4e12
    # NVIDIA H100 SXM 80GB HBM3, 700 W: HBM3 bytes/s (core/oracle.py)
    hbm_bw: float = H100_SXM.hbm_bw
    # NVIDIA H100 SXM 80GB HBM3, 700 W: one NVLink 4 link's bytes/s in
    # one direction (NVIDIA's data sheet: 900 GB/s both ways over 18)
    ici_bw: float = 25e9
    # NVIDIA H100 SXM 80GB HBM3, 700 W: NVLink 4 links a card
    ici_links: int = 18


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops_: float
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape, active_params: int) -> float:
    """6·N·D for train, 2·N·D for inference steps (D = processed tokens)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params * tokens


def roofline(*, arch: str, shape: str, mesh: str, chips: int,
             hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             model_flops_: float, hw: HW = HW()) -> RooflineReport:
    """The three terms of one rank's counts (``hlo_*`` keep the
    reference's names; the port's counts come from the eager step, not
    from HLO)."""
    r = RooflineReport(arch=arch, shape=shape, mesh=mesh, chips=chips,
                       hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
                       collective_bytes=collective_bytes,
                       model_flops_=model_flops_)
    r.t_compute = hlo_flops / hw.peak_flops
    r.t_memory = hlo_bytes / hw.hbm_bw
    r.t_collective = collective_bytes / (hw.ici_bw * hw.ici_links)
    terms = {"compute": r.t_compute, "memory": r.t_memory,
             "collective": r.t_collective}
    r.bottleneck = max(terms, key=terms.get)
    r.useful_ratio = (model_flops_ / (hlo_flops * chips)
                      if hlo_flops else 0.0)
    return r
