"""Install-time calibration (paper Fig. 1a) — the ADSALA "installation" on
the H100.

Runs the full pipeline per BLAS L3 subroutine × precision:

    Halton sampling → timing sweep of the backend's kernels on the card
    (CUDA events) → features → LOF → Yeo-Johnson/standardize/corr-prune →
    per-model hyper-tuning → estimated-speedup model selection → persist
    artifacts + datasets.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.calibrate \
        --out runs/adsala_torch --samples 60 --ops gemm,symm --precisions s

``--ops`` defaults to every subroutine the backend lists (for ``hopper``:
all six, gemm, symm, syrk, syr2k, trmm and trsm).

``--backend`` selects the execution backend being calibrated (default
``hopper``); each artifact is backend-tagged (``hopper__gemm_b4.adsala``).
``--device cpu`` times the kernels' plain versions on the CPU instead: the
times say nothing about the card, but drive the same flow where there is
none.  Precisions: s = float32, d = float64; the ``hopper`` backend takes
float32 only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.backends import get_backend, resolve_backend
from repro_torch.core import ModelRegistry, install_subroutine

PRECISIONS = {"s": torch.float32, "d": torch.float64}
DEFAULT_BACKEND = "hopper"


def calibrate_one(op: str, prec: str, out: Path, *, backend: str, samples: int,
                  dim_lo: int, dim_hi: int, footprint_mb: float,
                  sizes: tuple[int, ...] | None, tune_trials: int, seed: int,
                  candidates=None, device=None, log=print) -> dict:
    dtype = PRECISIONS[prec]
    dtype_bytes = dtype.itemsize
    be = resolve_backend(backend, device=device)
    if not be.supports_dtype(dtype):
        raise ValueError(f"backend {be.name!r} does not take {dtype} "
                         f"(precision {prec!r})")
    space = be.knob_space(op, sizes=sizes)
    timer = be.timer_fn(op, dtype)
    t0 = time.perf_counter()
    kw = {}
    if candidates:
        kw["candidates"] = candidates
    sub = install_subroutine(
        op, space, timer, n_samples=samples, dim_lo=dim_lo, dim_hi=dim_hi,
        max_footprint_bytes=int(footprint_mb * 1e6), dtype_bytes=dtype_bytes,
        tune_trials=tune_trials, seed=seed, backend=be.name,
        progress=lambda i, n: (log(f"  [{op}/{prec}] gathered {i}/{n}")
                               if i % 25 == 0 else None), **kw)
    wall = time.perf_counter() - t0
    reg = ModelRegistry(out / "models")
    path = reg.save(sub)

    # persist the training dataset (for the heatmap figures, Fig. 4/5)
    ds_dir = out / "datasets"
    ds_dir.mkdir(parents=True, exist_ok=True)
    np.savez(ds_dir / f"{be.name}__{op}_{prec}.npz", dims=sub.dataset.dims,
             times=sub.dataset.times,
             knobs=json.dumps([k.dict for k in sub.dataset.knob_space]),
             default_idx=sub.dataset.default_knob_index())

    report = {
        "op": op, "prec": prec, "backend": be.name,
        "device": str(be.device),
        "best_model": sub.model_name,
        "wall_seconds": wall,
        "gather_seconds": sub.dataset.gather_seconds,
        "n_samples": int(sub.dataset.n_samples),
        "n_knobs": len(space),
        "artifact": str(path),
        "models": [r.row() for r in sub.reports],
    }
    log(f"  [{be.name}:{op}/{prec}] done in {wall:.1f}s "
        f"(gather {sub.dataset.gather_seconds:.1f}s); best={sub.model_name}")
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/adsala_torch")
    p.add_argument("--backend", default=DEFAULT_BACKEND)
    p.add_argument("--device", default=None,
                   help="device to calibrate on (default: the backend's)")
    p.add_argument("--ops", default="",
                   help="comma-separated subroutines (default: every op "
                        "the backend lists)")
    p.add_argument("--precisions", default="s")
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--dim-lo", type=int, default=8)
    p.add_argument("--dim-hi", type=int, default=16384)
    p.add_argument("--footprint-mb", type=float, default=400.0)
    p.add_argument("--sizes", default="",
                   help="bm/bn tile edges (default: every Hopper edge)")
    p.add_argument("--tune-trials", type=int, default=3)
    p.add_argument("--candidates", default="")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sizes = tuple(int(s) for s in args.sizes.split(",") if s) or None
    cands = tuple(c for c in args.candidates.split(",") if c) or None
    # merge with any prior report (partial recalibrations replace their rows)
    report_path = out / "calibration_report.json"
    reports = []
    if report_path.exists():
        reports = json.loads(report_path.read_text())
    ops = [op for op in args.ops.split(",") if op] \
        or list(get_backend(args.backend).ops())
    for op in ops:
        for prec in args.precisions.split(","):
            print(f"[calibrate] {args.backend}:{op}/{prec} ...", flush=True)
            entry = calibrate_one(
                op, prec, out, backend=args.backend,
                samples=args.samples, dim_lo=args.dim_lo,
                dim_hi=args.dim_hi, footprint_mb=args.footprint_mb,
                sizes=sizes, tune_trials=args.tune_trials, seed=args.seed,
                candidates=cands, device=args.device,
                log=lambda m: print(m, flush=True))
            reports = [r for r in reports
                       if not (r["op"] == op and r["prec"] == prec
                               and r["backend"] == entry["backend"])]
            reports.append(entry)
            report_path.write_text(json.dumps(reports, indent=2))
    print(f"[calibrate] all done → {report_path}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
