#!/usr/bin/env python3
"""Requests per second of the port's in-process ``BlasService`` on the card,
without and with a retuner attached, against one ``run_op`` per request, on
``chip_smoke.py`` phase 5's traffic: 4 client threads, 8 requests of each of
the six ops at (512, 512) a thread (gemm (512, 512, 512)), ``max_batch`` 8,
2 workers, the backends' default knobs (no install).  With a retuner the
service probes one bucket per key and ``step()`` (``serving/retune.py``),
and a ``step()`` follows every window, as in ``chip_smoke.py``'s retune
phase.  One round times one window of each mode, in turns; the script prints
every window and the median per mode.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed, so one
call can time two checkouts in turns (parent, change, change, parent) on the
same card; a checkout without ``serving/retune.py`` times no retuner:

    python3 scripts/torch_service_rate.py --src build/parent/src --label parent
"""

from __future__ import annotations

import argparse
import concurrent.futures
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
THREADS, PER_THREAD, SHAPE = 4, 8, 512
MAX_BATCH, WORKERS = 8, 2


def traffic(torch) -> list:
    """Per client thread, its requests: seeded operands on the card, trsm's
    A diagonally dominant, syrk's C symmetric."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    s = SHAPE
    shapes = {"gemm": [(s, s), (s, s)], "symm": [(s, s), (s, s)],
              "syrk": [(s, s)], "syr2k": [(s, s), (s, s)],
              "trmm": [(s, s), (s, s)], "trsm": [(s, s), (s, s)]}
    out = []
    for _ in range(THREADS):
        reqs = []
        for _ in range(PER_THREAD):
            for op, sh in shapes.items():
                xs = [torch.randn(x, generator=gen, device="cuda")
                      for x in sh]
                if op == "trsm":
                    xs[0].diagonal().add_(s)
                reqs.append((op, tuple(xs)))
        out.append(reqs)
    return out


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.core import AdsalaRuntime
    from repro_torch.kernels import ops
    from repro_torch.serving import BlasService, ServeConfig
    try:
        from repro_torch.serving import Retuner
    except ImportError:
        Retuner = None

    if not torch.cuda.is_available():
        print("[rate] no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    work = traffic(torch)
    flat = [r for part in work for r in part]
    cfg = ServeConfig(max_batch=MAX_BATCH, linger_ms=2.0, workers=WORKERS)
    rt = AdsalaRuntime()
    services = {"service": BlasService(runtime=rt, config=cfg)}
    retuner = None
    if Retuner is not None:
        retuner = Retuner(AdsalaRuntime())
        services["service+retuner"] = BlasService(
            runtime=retuner.runtime, config=cfg, retuner=retuner)
    pool = concurrent.futures.ThreadPoolExecutor(THREADS)

    def window(mode: str) -> float:
        t0 = time.perf_counter()
        if mode == "single":
            for op, xs in flat:
                ops.run_op(op, xs, runtime=rt)
            torch.cuda.synchronize()
        else:
            svc = services[mode]
            futures = list(pool.map(
                lambda reqs: [svc.submit(op, xs) for op, xs in reqs], work))
            for part in futures:
                for f in part:
                    f.result(timeout=300)
        dt = time.perf_counter() - t0
        if mode == "service+retuner":
            services[mode].drain(timeout=60)
            retuner.step()
        return dt

    modes = ["single", *services]
    try:
        for mode in modes:                  # warm-up: builds, decisions
            window(mode)
        rates = {mode: [] for mode in modes}
        for _ in range(args.rounds):
            for mode in modes:
                rates[mode].append(len(flat) / window(mode))
    finally:
        pool.shutdown()
        for svc in services.values():
            svc.close()
    for mode in modes:
        print(f"[rate] [{card}] {args.label}: {mode} "
              f"{statistics.median(rates[mode])} requests/s (median of "
              f"{args.rounds}; windows {rates[mode]})", flush=True)
    if retuner is not None:
        print(f"[rate] [{card}] {args.label}: the retuner took "
              f"{retuner.stats.samples} samples", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
