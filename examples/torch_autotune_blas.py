"""One subroutine's full loop on the port's ``hopper`` backend: the
install with measured CUDA-event timings, the model-selection table
(paper Table VI) and the held-out speedup over the default tile (paper
Table VII's row), the model's decision time included.

    PYTHONPATH=src python examples/torch_autotune_blas.py --op gemm
    PYTHONPATH=src python examples/torch_autotune_blas.py --op syrk \\
        --samples 60
    PYTHONPATH=src python examples/torch_autotune_blas.py --device cpu \\
        --op trmm --samples 8 --dim-hi 96 --tests 3

The ops are gemm, symm, syrk, syr2k, trmm and trsm, each a hand-written
kernel on the H100 (the default device); ``--device cpu`` times their
plain PyTorch versions instead, a rehearsal of the flow.
"""

import argparse
import time

import numpy as np

from repro_torch.backends import resolve_backend
from repro_torch.core import (SUBROUTINE_NDIMS, footprint_words,
                              install_subroutine, sample_dims)
from repro_torch.core.timing import time_callable


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--op", default="gemm")
    p.add_argument("--device", default=None,
                   help="device to install and run on (default: the card)")
    p.add_argument("--samples", type=int, default=60)
    p.add_argument("--dim-hi", type=int, default=4096)
    p.add_argument("--tests", type=int, default=15,
                   help="held-out dims the speedup is taken over")
    args = p.parse_args(argv)
    op = args.op

    be = resolve_backend("hopper", device=args.device)
    footprint = 4 * 3 * args.dim_hi ** 2
    sub = install_subroutine(
        op, be.knob_space(op), be.timer_fn(op, warmup=1, repeats=2),
        n_samples=args.samples, dim_lo=16, dim_hi=args.dim_hi,
        max_footprint_bytes=footprint, tune_trials=1, backend=be.name,
        candidates=("LinearRegression", "DecisionTree", "KNN", "XGBoost"),
        progress=lambda i, n: print(f"  gathered {i}/{n}", end="\r"))
    print(f"\n== [{be.name} on {be.device}] {op}: model selection (paper "
          f"Table VI), best {sub.model_name}")
    for r in sorted(sub.reports, key=lambda r: -r.estimated_mean_speedup):
        print(f"  {r.name:18s} nrmse={r.normalized_rmse:.2f} "
              f"ideal={r.ideal_mean_speedup:.2f} eval={r.eval_time_us:7.0f}us "
              f"est={r.estimated_mean_speedup:.2f}")

    # held-out dims (another Halton seed): the default tile against the
    # model's choice, the decision's host time charged to the model
    default = be.default_knob(op)
    test = sample_dims(args.tests, SUBROUTINE_NDIMS[op], lo=16,
                       hi=args.dim_hi, max_footprint_bytes=footprint,
                       footprint_fn=lambda d: footprint_words(op, d) * 4,
                       seed=777)
    speedups = []
    for row in test:
        dims = tuple(int(v) for v in row)
        operands = be.make_operands(op, dims)
        t0 = time.perf_counter()
        knob = sub.select(dims)
        t_eval = time.perf_counter() - t0
        t_def = time_callable(lambda: be.execute(op, operands, default),
                              device=be.device, warmup=1, repeats=3)
        t_ml = time_callable(lambda: be.execute(op, operands, knob),
                             device=be.device, warmup=1, repeats=3)
        speedups.append(t_def / (t_ml + t_eval))
    sp = np.array(speedups)
    print(f"== [{be.name} on {be.device}] {op}: held-out speedup over "
          f"{len(sp)} dims (paper Table VII): mean={sp.mean():.2f} "
          f"median={np.median(sp):.2f} min={sp.min():.2f} max={sp.max():.2f}")
    return sp


if __name__ == "__main__":
    main()
