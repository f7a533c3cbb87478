"""Oracle-driven pruning of an install's knob space.

The reference package's ``roofline/costing.py`` also costs sharded model
programs from XLA's compiled cost analysis; of it the port keeps only the
pruning step, on the H100 oracle (:mod:`repro_torch.core.oracle`).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.knobs import KnobSpace
from repro_torch.core.oracle import oracle_time

__all__ = ["prune_dominated_candidates"]


def prune_dominated_candidates(op: str, space: KnobSpace, dims_list,
                               *, dtype_bytes: int = 4,
                               slack: float = 0.15) -> KnobSpace:
    """Drop knob candidates the analytic oracle proves dominated at every
    harvested call site.

    For each dims in ``dims_list`` (e.g. the dims of
    ``roofline.harvest.harvest_decision_keys``), score every candidate with
    the deterministic H100 oracle and keep the union of all candidates
    within ``(1 + slack)`` of that dims' best.  A candidate outside the band
    at *every* site cannot win under any model whose error is below the
    slack, so the install need not time it.  Returns a new
    :class:`~repro_torch.core.knobs.KnobSpace` under the same name with the
    same parallelism function (never empty: each site contributes at least
    its argmin).
    """
    dims_list = [tuple(d) for d in dims_list]
    if not dims_list:
        return space
    keep: set[int] = set()
    for dims in dims_list:
        times = np.array([oracle_time(op, dims, c, dtype_bytes=dtype_bytes)
                          for c in space.candidates])
        band = times.min() * (1.0 + slack)
        keep.update(int(i) for i in np.flatnonzero(times <= band))
    cands = [space.candidates[i].dict for i in sorted(keep)]
    return KnobSpace(space.name, cands,
                     parallelism_fn=space._parallelism_fn)
