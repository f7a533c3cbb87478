#!/usr/bin/env python3
"""Time trmm's ``tri`` variant on an H100 under the two orders in which its
grid may walk the row blocks: top first (grid y = row block) and heaviest
first (grid y = the last row block first; under ``tri`` row block i does
i + 1 contraction steps, so the longest blocks start first and the tail of
the launch shrinks).

The order is one expression of ``csrc/trmm.cu`` (the kernel's ``row0``).
This script builds ``trmm.cu`` twice, with that expression set to each
order and everything else as the checkout has it, loads both libraries and
times them alternated (top, heavy, heavy, top, per round) with CUDA events
at the preconditioner's trmm call ``(4096, 4096) @ (4096, 14336)`` and at
the stacked ``(8, 512, 512)`` call, under every tile.  It fails if the two
orders differ by one bit.  Run from the root of a checkout on a machine
with the card:

    python3 scripts/trmm_row_order.py [--rounds 3]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: the kernel's row0 under each order
ORDERS = {"top": "blockIdx.y * BM",
          "heavy": "(gridDim.y - 1 - blockIdx.y) * BM"}
ROW0 = re.compile(r"const int row0 = [^;]*;")
#: the calls timed: (batch or None, m, n)
CALLS = ((None, 4096, 14336), (8, 512, 512))
SEED = 0


def build(order: str, out_dir: Path) -> ctypes.CDLL:
    """``trmm.cu`` with the row walk of ``order``, built with the port's
    nvcc flags into ``out_dir``."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "trmm.cu").read_text()
    if len(ROW0.findall(src)) != 1:
        raise SystemExit("trmm.cu: expected one `const int row0 = ...;`")
    cu = out_dir / f"trmm_{order}.cu"
    cu.write_text(ROW0.sub(f"const int row0 = {ORDERS[order]};", src))
    lib = out_dir / f"libtrmm_{order}.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build.nvcc_path(), *flags, "-I",
                           str(_build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {order}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trmm_row_order: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import trmm as TM
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"[env] {card}", flush=True)
    out_dir = _build.BUILD_DIR / "row_order"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = {}
    with concurrent.futures.ThreadPoolExecutor(len(ORDERS)) as pool:
        libs = dict(zip(ORDERS, pool.map(lambda o: build(o, out_dir),
                                         ORDERS)))
    for order, lib in libs.items():
        fn = lib.repro_trmm_f32
        fn.argtypes = [*TM._ARGTYPES["trmm"], ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        fns[order] = fn
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(order, a, b, out, bm, bn, batch):
        sab, sbb, sob = (a.stride(0), b.stride(0), out.stride(0)) \
            if batch else (0, 0, 0)
        vec = G.vec_aligned((a, a.stride(-2), sab), (b, b.stride(-2), sbb))
        m, n = b.shape[-2:]
        rc = fns[order](bm, bn, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        m, n, batch or 1, sab, a.stride(-2), sbb,
                        b.stride(-2), sob, out.stride(-2), 1.0, 1, int(vec),
                        stream, _build.launch_grid())
        if rc != 0:
            raise SystemExit(f"{order} {bm}x{bn}: CUDA error {rc}")

    for batch, m, n in CALLS:
        lead = (batch,) if batch else ()
        per_set = 4 * (m * m + m * n) * (batch or 1)
        sets = [(torch.randn(*lead, m, m, generator=gen, device="cuda"),
                 torch.randn(*lead, m, n, generator=gen, device="cuda"))
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        outs = {o: torch.empty(*lead, m, n, device="cuda") for o in ORDERS}
        iters = 5 if per_set > 200e6 else 50
        label = f"{lead + (m, m)} @ {lead + (m, n)}"
        sums = {o: 0.0 for o in ORDERS}
        for bm, bn in sorted(TM.TILES):
            for order in ORDERS:
                launch(order, *sets[0], outs[order], bm, bn, batch)
            if not torch.equal(outs["top"].view(torch.int32),
                               outs["heavy"].view(torch.int32)):
                raise SystemExit(f"{label} {bm}x{bn}: the orders differ")
            times = {o: [] for o in ORDERS}
            for _ in range(args.rounds):
                for order in ("top", "heavy", "heavy", "top"):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for i in range(iters):
                        launch(order, *sets[i % len(sets)], outs[order], bm,
                               bn, batch)
                    end.record()
                    end.synchronize()
                    times[order].append(start.elapsed_time(end) / iters)
            med = {o: statistics.median(t) for o, t in times.items()}
            for o in ORDERS:
                sums[o] += med[o]
            print(f"[order] [{card}] {label} {bm}x{bn}/tri: top "
                  f"{med['top']:.4f} ms ({min(times['top']):.4f}-"
                  f"{max(times['top']):.4f}), heavy first "
                  f"{med['heavy']:.4f} ms ({min(times['heavy']):.4f}-"
                  f"{max(times['heavy']):.4f}), heavy/top "
                  f"{med['heavy'] / med['top']:.4f}; bits equal",
                  flush=True)
        print(f"[order] [{card}] {label} sum of the medians over "
              f"{len(TM.TILES)} tiles: top {sums['top']:.4f} ms, heavy "
              f"first {sums['heavy']:.4f} ms, heavy/top "
              f"{sums['heavy'] / sums['top']:.4f}", flush=True)
        del sets, outs
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
