#!/usr/bin/env python3
"""What the retuner's telemetry measures on the card, per op.

Installs the six ops on the card (``repro_torch.launch.calibrate``, a
small sweep), then at the service phase's shape of ``chip_smoke.py``
((512, 512), gemm (512, 512, 512)) prints, for the knob the installed
model serves:

* the installed model's prediction for one call;
* one call timed as the install's labels were timed before the launch
  window (CUDA events around ``Backend.execute`` on an idle stream), and
  as they are timed now (``core/timing.py``: the kernels' device time);
* a stack of 1, 2, 4 and 8 items through ``run_op``: the span of events
  around the call and the kernels' device time, each per item;
* each op's traffic alone through a ``BlasService`` with a default
  ``Retuner`` (4 client threads, 8 requests each a window, ``max_batch``
  8, 2 workers, as ``chip_smoke.py`` phase 5): the mean batch, a
  request's share of its bucket's span, the mean of the service's probes
  (one item alone, its kernels' device time), and the drift EWMA the
  retuner reads from them.

Run on a machine with the card:
``python3 scripts/torch_retune_telemetry.py [--samples 64]``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"gemm": ((512, 512), (512, 512)), "symm": ((512, 512), (512, 512)),
          "syrk": ((512, 512),), "syr2k": ((512, 512), (512, 512)),
          "trmm": ((512, 512), (512, 512)), "trsm": ((512, 512), (512, 512))}
WIDTHS = (1, 2, 4, 8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--windows", type=int, default=3)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.backends import resolve_backend
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.core.timing import time_callable
    from repro_torch.kernels import ops
    from repro_torch.launch import calibrate
    from repro_torch.serving import BlasService, Retuner, ServeConfig

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"[telemetry] card {card}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="telemetry_"))
    try:
        for op in ops.HOPPER_OPS:
            calibrate.main(["--out", str(tmp), "--ops", op, "--samples",
                            str(args.samples), "--dim-lo", "8", "--dim-hi",
                            "4096", "--footprint-mb", "200",
                            "--tune-trials", "1", "--candidates",
                            "LinearRegression,DecisionTree,KNN,XGBoost"])
        rt = AdsalaRuntime()
        ModelRegistry(tmp / "models").load_into(rt, backend="hopper")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    be = resolve_backend("hopper")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(op, width=None):
        lead = () if width is None else (width,)
        out = [torch.randn(lead + s, generator=gen, device="cuda")
               for s in SHAPES[op]]
        if op == "trsm":
            out[0].diagonal(dim1=-2, dim2=-1).add_(512.0)
        return tuple(out)

    def span_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    for op in ops.HOPPER_OPS:
        x = operands(op)
        dims = ops.dims_of(op, tuple(tuple(t.shape) for t in x))
        knob = rt.select(op, dims, 4, backend="hopper")
        sub = rt.subroutine(op, 4, "hopper")
        pred = float(rt.predictor(op, 4, "hopper").predict_times(dims)[
            sub.knob_space.index(knob)]) * 1e3
        old = span_ms(lambda: be.execute(op, x, knob))
        new = time_callable(lambda: be.execute(op, x, knob), device="cuda",
                            warmup=1, repeats=10) * 1e3
        print(f"[telemetry:{op}] [{card}] dims {dims} knob {knob}: "
              f"predicted {pred:.4f} ms; one call, events around "
              f"execute {old:.4f} ms, kernels' device time {new:.4f} ms",
              flush=True)
        for w in WIDTHS:
            xs = operands(op, w)
            sp = span_ms(lambda: ops.run_op(op, xs, knob=knob, runtime=rt))
            kt = time_callable(lambda: ops.run_op(op, xs, knob=knob,
                                                  runtime=rt),
                               device="cuda", warmup=1, repeats=10) * 1e3
            print(f"[telemetry:{op}] [{card}] stack of {w}: span "
                  f"{sp:.4f} ms ({sp / w:.4f} an item), kernels "
                  f"{kt:.4f} ms ({kt / w:.4f} an item; "
                  f"{kt / w / pred:.3f} x predicted, {kt / w / new:.3f} x "
                  f"one call)", flush=True)

        # this op's traffic alone through the service
        traffic = [[(op, operands(op)) for _ in range(8)] for _ in range(4)]
        cfg = ServeConfig(max_batch=8, linger_ms=2.0, workers=2)
        ret = Retuner(rt)
        with BlasService(runtime=rt, config=cfg, retuner=ret) as svc, \
                concurrent.futures.ThreadPoolExecutor(4) as pool:
            def client(reqs):
                return [svc.submit(o, xs) for o, xs in reqs]
            for f in [f for part in pool.map(client, traffic)
                      for f in part]:
                f.result(timeout=120)
            svc.drain(timeout=60)
            ret.baseline()                   # past the warm-up window
            st0 = dict(vars(svc.stats))
            for _ in range(args.windows):
                for f in [f for part in pool.map(client, traffic)
                          for f in part]:
                    f.result(timeout=120)
                svc.drain(timeout=60)
                ret.observe()
            st = vars(svc.stats)
        done = st["completed"] - st0["completed"]
        batches = st["batches"] - st0["batches"]
        bucket = rt.stats.buckets[("hopper", op, 4, dims)]
        ewma, n = ret.drift(op, 4, "hopper")
        print(f"[telemetry:{op}] [{card}] service, {args.windows} windows of "
              f"32: mean batch {done / max(1, batches):.3f}; its bucket's "
              f"span a request "
              f"{1e3 * (st['exec_sum'] - st0['exec_sum']) / max(1, done):.4f}"
              f" ms; {bucket.exec_items} probes (one item alone, its "
              f"kernels) {1e3 * bucket.mean_exec_per_item:.4f} ms "
              f"({bucket.mean_exec_per_item * 1e3 / pred:.3f} x predicted); "
              f"retuner EWMA {ewma} over {n} samples", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
