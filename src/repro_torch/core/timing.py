"""Timing harness (the paper's install-time "timing program").

Times a zero-argument callable: warmup calls, then the median of
``repeats`` timed calls.  Work on a CUDA device is timed with a pair of
``torch.cuda.Event``s on the current stream around each call, read after
the end event has completed, so the time is the card's and not the time
the host took to enqueue.  Work on the CPU is timed on the host clock (CPU
tensors compute synchronously).  Exceptions raised by the callable
propagate: a calibration that cannot run must not record a time.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

__all__ = ["time_callable"]


def time_callable(fn: Callable[[], object], *,
                  device: torch.device | str = "cpu", warmup: int = 1,
                  repeats: int = 3) -> float:
    """Median seconds of ``fn`` over ``repeats`` runs on ``device``."""
    device = torch.device(device)
    times: list[float] = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            for _ in range(warmup):
                fn()
            stream = torch.cuda.current_stream()
            for _ in range(max(repeats, 1)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                fn()
                end.record(stream)
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
        return float(np.median(times))
    if device.type != "cpu":
        raise ValueError(f"no timer for device {device}")
    for _ in range(warmup):
        fn()
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
