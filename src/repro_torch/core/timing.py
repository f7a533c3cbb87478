"""Timing harness (the paper's install-time "timing program").

Times a zero-argument callable: warmup calls, then the median of
``repeats`` timed calls.  Work on a CUDA device is timed with a pair of
``torch.cuda.Event``s on the current stream, read after the end event has
completed, so the time is the card's and not the time the host took to
enqueue.  Where the callable launches the port's kernels, the events are
those of ``kernels/introspect.py::launch_window``, which each launcher
records around its own launch, so the host's work ahead of the launch
(the wrapper's checks and argument conversion), which an idle stream
would otherwise count as device time, stays out of the label — the same
quantity the serving layer's bucket telemetry measures.  A
callable that launches none of them is timed between events recorded
around the call.  Work on the CPU is timed on the host clock (CPU
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
            from repro_torch.kernels.introspect import launch_window
            stream = torch.cuda.current_stream()
            for _ in range(max(repeats, 1)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with launch_window() as window:
                    start.record(stream)
                    fn()
                    end.record(stream)
                end.synchronize()
                kernels = window.seconds()
                times.append(kernels if kernels is not None
                             else start.elapsed_time(end) / 1e3)
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
