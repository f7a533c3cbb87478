#!/usr/bin/env python3
"""Does steady serving traffic read as drift?  The steady part of
``chip_smoke.py``'s retune phase, repeated, for two probe sizes and two
host loads.

Installs the six ops on the card (``repro_torch.launch.calibrate``, a
small sweep), then runs, ``--reps`` times for each probe size (1 timed
call, and ``serving.service.PROBE_REPEATS``) and each host load (idle,
and ``--load`` processes spinning on the CPU): phase 5's traffic
(``chip_smoke.service_requests``, 4 client threads) through a
``BlasService`` with a default ``Retuner`` on a fresh runtime, one cold
window, ``baseline()``, then ``chip_smoke.RETUNE_WINDOWS`` windows with a
``step()`` after each, as the retune phase does.  For each run it prints
the drift events, the fewest samples any op gave, each op's last EWMA
and the largest relative error one sample fed the EWMA (``|ratio /
anchor - 1|``, the drift signal's unit).  A run fails
``chip_smoke.report_retune``'s check when it has a drift event or an op
with fewer than ``min_samples`` samples.

Run on a machine with the card:
``python3 scripts/torch_retune_steady.py [--reps 10] [--load 6]``.
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
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--load", type=int, default=6)
    args = p.parse_args(argv)

    import torch

    import chip_smoke
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.kernels import ops
    from repro_torch.launch import calibrate
    from repro_torch.serving import (BlasService, RetuneConfig, Retuner,
                                     ServeConfig)
    from repro_torch.serving import service as service_mod

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"[steady] card {card}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="steady_"))
    for op in ops.HOPPER_OPS:
        calibrate.main(["--out", str(tmp), "--ops", op, "--samples",
                        str(args.samples), "--dim-lo", "8", "--dim-hi",
                        "4096", "--footprint-mb", "200", "--tune-trials",
                        "1", "--candidates", "LinearRegression,DecisionTree"])
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
    traffic = [chip_smoke.service_requests(torch, gen)
               for _ in range(chip_smoke.SERVICE_THREADS)]
    cfg = ServeConfig(max_batch=chip_smoke.SERVICE_MAX_BATCH, linger_ms=2.0,
                      workers=chip_smoke.SERVICE_WORKERS)

    def run(repeats: int) -> dict:
        service_mod.PROBE_REPEATS = repeats
        rt = AdsalaRuntime()
        ModelRegistry(tmp / "models").load_into(rt, backend="hopper")
        ret = Retuner(rt)
        worst = {}
        ingest = ret._ingest

        def traced(backend, op, dtype_bytes, dims, measured):
            st = ret._state.get((backend, op, dtype_bytes))
            before = None if st is None else (st.ewma, st.n)
            ok = ingest(backend, op, dtype_bytes, dims, measured)
            st = ret._state.get((backend, op, dtype_bytes))
            if ok and st is not None and st.n and (
                    before is None or st.n > before[1]):
                a = ret.config.ewma_alpha
                prev = None if before is None else before[0]
                err = st.ewma if prev is None \
                    else (st.ewma - (1 - a) * prev) / a
                worst[op] = max(worst.get(op, 0.0), err)
            return ok

        ret._ingest = traced
        with BlasService(runtime=rt, config=cfg, retuner=ret) as svc, \
                concurrent.futures.ThreadPoolExecutor(
                    chip_smoke.SERVICE_THREADS) as pool:
            chip_smoke._service_windows(svc, pool, traffic, 1)
            ret.baseline()
            events0 = ret.stats.drift_events
            _, swapped, _ = chip_smoke._service_windows(
                svc, pool, traffic, chip_smoke.RETUNE_WINDOWS,
                after=ret.step)
        drift = {op: ret.drift(op, 4, "hopper") for op in ops.HOPPER_OPS}
        return {"events": ret.stats.drift_events - events0,
                "swapped": swapped,
                "min_samples": min(n for _, n in drift.values()),
                "ewma": {op: e for op, (e, _) in drift.items()},
                "worst": worst}

    failed = {}
    probe = service_mod.PROBE_REPEATS
    for load in (0, args.load):
        spinners = [subprocess.Popen([sys.executable, "-c",
                                      "while True: pass"])
                    for _ in range(load)]
        try:
            for rep in range(args.reps):
                for repeats in (1, probe):
                    r = run(repeats)
                    bad = bool(r["events"] or r["swapped"]
                               or r["min_samples"]
                               < RetuneConfig().min_samples)
                    failed.setdefault((load, repeats), []).append(bad)
                    print(f"[steady] [{card}] load {load} probe of "
                          f"{repeats} rep {rep}: {r['events']} drift "
                          f"events, fewest samples {r['min_samples']}, "
                          f"last EWMA " + ", ".join(
                              f"{op} {e:.3f}" for op, e in r["ewma"].items()
                              if e is not None)
                          + "; largest one-sample error " + ", ".join(
                              f"{op} {e:.3f}"
                              for op, e in r["worst"].items())
                          + (" FAILS the check" if bad else ""), flush=True)
        finally:
            for s in spinners:
                s.kill()
                s.wait()
    shutil.rmtree(tmp, ignore_errors=True)
    for (load, repeats), bads in failed.items():
        print(f"[steady] [{card}] load {load}, probe of {repeats}: "
              f"{sum(bads)} of {len(bads)} runs fail the check", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
