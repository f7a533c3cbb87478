"""Install-time data gathering (paper §III-A / §IV-B).

Quasi-random (scrambled Halton) dimension samples × full knob sweep, each
timed by a caller-provided ``timer_fn(dims, knob) -> seconds``.  Times are
stored densely as (samples, knobs) so the selection stage can compute
ideal/estimated speedups against the measured optimum (paper Table VI).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from . import features as F
from .halton import sample_dims
from .knobs import Knob, KnobSpace

__all__ = ["TimingDataset", "gather"]


@dataclasses.dataclass
class TimingDataset:
    op: str
    dims: np.ndarray          # (S, ndims) int64
    times: np.ndarray         # (S, K) seconds
    knob_space: KnobSpace
    dtype_bytes: int
    gather_seconds: float = 0.0

    @property
    def n_samples(self) -> int:
        return self.dims.shape[0]

    def flatten(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (X_features, y_times, sample_index) flattened over knobs."""
        S, K = self.times.shape
        dims_rep = np.repeat(self.dims, K, axis=0)
        nt = np.concatenate([self.knob_space.parallelism_vec(tuple(d))
                             for d in self.dims])
        X = F.build_features(self.op, dims_rep, nt)
        y = self.times.reshape(-1)
        sample_idx = np.repeat(np.arange(S), K)
        return X, y, sample_idx

    def default_knob_index(self) -> int:
        """The baseline config: maximum parallelism (paper: max threads).

        For block knobs this is the candidate with the *largest grid
        parallelism on a reference shape* — i.e. the smallest (bm, bn) —
        matching the paper's "use all available parallelism" default.
        """
        ref = tuple(int(v) for v in self.dims.max(axis=0))
        p = self.knob_space.parallelism_vec(ref)
        return int(np.argmax(p))

    def get_state(self) -> dict:
        return {"op": self.op, "dims": self.dims, "times": self.times,
                "knobs": self.knob_space.get_state(),
                "dtype_bytes": self.dtype_bytes,
                "gather_seconds": self.gather_seconds}


def gather(
    op: str,
    knob_space: KnobSpace,
    timer_fn: Callable[[tuple[int, ...], Knob], float],
    *,
    n_samples: int = 250,
    dim_lo: int = 16,
    dim_hi: int = 2048,
    max_footprint_bytes: int | None = 32 * 1024 * 1024,
    dtype_bytes: int = 4,
    seed: int = 0,
    progress: Callable[[int, int], None] | None = None,
) -> TimingDataset:
    """Sweep Halton-sampled dims × every knob candidate through ``timer_fn``."""
    ndims = F.SUBROUTINE_NDIMS[op]

    def fp_bytes(d: tuple[int, ...]) -> int:
        return F.footprint_words(op, d) * dtype_bytes

    dims = sample_dims(n_samples, ndims, lo=dim_lo, hi=dim_hi,
                       max_footprint_bytes=max_footprint_bytes,
                       footprint_fn=fp_bytes, seed=seed)
    S, K = dims.shape[0], len(knob_space)
    times = np.empty((S, K), dtype=np.float64)
    t0 = time.perf_counter()
    for i, drow in enumerate(dims):
        d = tuple(int(v) for v in drow)
        for j, knob in enumerate(knob_space):
            times[i, j] = timer_fn(d, knob)
        if progress is not None:
            progress(i + 1, S)
    return TimingDataset(op=op, dims=dims, times=times, knob_space=knob_space,
                         dtype_bytes=dtype_bytes,
                         gather_seconds=time.perf_counter() - t0)
