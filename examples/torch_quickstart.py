"""Quickstart of the PyTorch/CUDA port: install the GEMM's tile on the
card with measured CUDA-event timings, then call ``run_op``, which picks
the argmin-predicted tile per call, memoized across repeated shapes.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --samples 8 --dim-hi 96

On the H100 (the default device) every call launches the hand-written
GEMM kernel (``src/repro_torch/kernels/csrc/gemm.cu``); ``--device cpu``
times and runs the kernel's plain PyTorch version instead, which
rehearses the flow and nothing more.
"""

import argparse

import torch

from repro_torch.backends import resolve_backend
from repro_torch.core import AdsalaRuntime, install_subroutine
from repro_torch.core.timing import time_callable
from repro_torch.kernels.ops import run_op


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="device to install and run on (default: the card)")
    p.add_argument("--samples", type=int, default=40)
    p.add_argument("--dim-hi", type=int, default=2048)
    args = p.parse_args(argv)

    # 1. install: Halton-sampled dims, every candidate tile timed, the ML
    #    model trained and selected by its estimated speedup
    be = resolve_backend("hopper", device=args.device)
    space = be.knob_space("gemm")
    print(f"installing gemm on {be.device}: {args.samples} dims x "
          f"{len(space.candidates)} tiles ...")
    sub = install_subroutine(
        "gemm", space, be.timer_fn("gemm", warmup=1, repeats=2),
        n_samples=args.samples, dim_lo=16, dim_hi=args.dim_hi,
        max_footprint_bytes=4 * 3 * args.dim_hi ** 2,
        candidates=("LinearRegression", "DecisionTree"), tune_trials=1,
        backend=be.name)
    print(f"selected model: {sub.model_name}")
    for r in sub.reports:
        print(f"  {r.name:18s} est_speedup={r.estimated_mean_speedup:.2f} "
              f"eval={r.eval_time_us:.0f}us")

    # 2. runtime: one decision a call, memoized by dims
    rt = AdsalaRuntime()
    rt.register(sub)
    default = be.default_knob("gemm")
    hi = args.dim_hi
    for dims in ((hi, hi // 8, hi), (hi // 16, hi, hi // 2), (hi, hi, 8)):
        a, b = be.make_operands("gemm", dims)
        out = run_op("gemm", (a, b), runtime=rt, device=be.device)
        want = a.double() @ b.double()
        err = ((out.double() - want).abs().max() / want.abs().max()).item()
        knob = rt.select("gemm", dims, dtype_bytes=4, backend=be.name)
        t_def = time_callable(lambda: be.execute("gemm", (a, b), default),
                              device=be.device, warmup=1, repeats=3)
        t_ml = time_callable(lambda: be.execute("gemm", (a, b), knob),
                             device=be.device, warmup=1, repeats=3)
        print(f"dims={dims}: default={t_def * 1e3:.3f}ms "
              f"adsala={t_ml * 1e3:.3f}ms speedup={t_def / t_ml:.2f}x "
              f"knob={knob.dict} rel err vs float64 {err:.1e}")
    stats = rt.stats.for_backend(be.name)
    print(f"decisions: model_evals {stats.model_evals} cache_hits "
          f"{stats.cache_hits} default_calls {stats.default_calls}")
    return sub


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
