#!/usr/bin/env python3
"""Time trmm on an H100 under every candidate of its knob space (8 tiles x
``full``, ``tri``, ``tri_packed``) at the preconditioner's trmm call
``(4096, 4096) @ (4096, 14336)`` and at the stacked ``(8, 512, 512)`` call,
with CUDA events, operands cycled through about 120 MB so they come from
HBM.  ``--src`` names the ``src`` directory whose ``repro_torch`` is
timed, so one call can time two checkouts in turns (parent, change,
change, parent) on the same card:

    python3 scripts/trmm_knob_times.py --src ../parent/src --label parent

Prints one ``[knob]`` line per call and candidate, and the sum over the
candidates of each call.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the calls timed: (batch or None, m, n)
CALLS = ((None, 4096, 14336), (8, 512, 512))
SEED = 1


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("trmm_knob_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    from repro_torch.kernels import trmm as TM
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"[env] {card}; {args.label}: {TM.__file__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    space = ops.knob_space_for("trmm")
    for batch, m, n in CALLS:
        lead = (batch,) if batch else ()
        per_set = 4 * (m * m + m * n) * (batch or 1)
        sets = [(torch.randn(*lead, m, m, generator=gen, device="cuda"),
                 torch.randn(*lead, m, n, generator=gen, device="cuda"))
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        iters = 3 if per_set > 200e6 else 20
        label = f"{lead + (m, m)} @ {lead + (m, n)}"
        total = 0.0
        for knob in space:
            kw = dict(bm=knob["bm"], bn=knob["bn"], variant=knob["variant"])
            for a, b in sets:
                TM.trmm(a, b, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                TM.trmm(*sets[i % len(sets)], **kw)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
            total += ms
            print(f"[knob] [{card}] {args.label} {label} "
                  f"{kw['bm']}x{kw['bn']}/{kw['variant']} {ms:.4f} ms",
                  flush=True)
        print(f"[knob] [{card}] {args.label} {label} sum over "
              f"{len(space)} candidates {total:.4f} ms", flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
