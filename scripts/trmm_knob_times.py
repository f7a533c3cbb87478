#!/usr/bin/env python3
"""Time one op on an H100 under every candidate of its knob space, with CUDA
events, operands cycled through about 120 MB so they come from HBM:

* ``--op trmm`` (the default): 8 tiles x ``full``, ``tri``, ``tri_packed``
  at the preconditioner's trmm call ``(4096, 4096) @ (4096, 14336)`` and at
  the stacked ``(8, 512, 512)`` call;
* ``--op syrk``: 6 tiles x the 3 variants at the preconditioner's
  ``L = 0.05 G G^T + 0.95 L`` call, G ``(4096, 14336)``, and at the stacked
  ``(8, 512, 512)`` call;
* ``--op syr2k``: the same 18 candidates at ``(4096, 4096)`` and at the
  stacked ``(8, 512, 512)`` call;
* ``--op trsm``: its 8 tiles at the preconditioner's trsm call, tril(A)
  ``(4096, 4096)`` against B ``(4096, 14336)``, and at the stacked
  ``(8, 512, 512)`` call, A made diagonally dominant (``+ m * I``).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed, so
one call can time two checkouts in turns (parent, change, change, parent)
on the same card:

    python3 scripts/trmm_knob_times.py --op syrk --src ../parent/src \
        --label parent

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
#: per op, the calls timed: (operand shapes, keywords)
CALLS = {
    "trmm": (([(4096, 4096), (4096, 14336)], {}),
             ([(8, 512, 512), (8, 512, 512)], {})),
    "syrk": (([(4096, 14336), (4096, 4096)], {"alpha": 0.05, "beta": 0.95}),
             ([(8, 512, 512)], {})),
    "syr2k": (([(4096, 4096), (4096, 4096)], {}),
              ([(8, 512, 512), (8, 512, 512)], {})),
    "trsm": (([(4096, 4096), (4096, 14336)], {}),
             ([(8, 512, 512), (8, 512, 512)], {})),
}
SEED = 1


def _kernel(op: str, knob):
    """The wrapper of ``op`` called under ``knob`` on operands."""
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    from repro_torch.kernels import trsm as T
    if op == "trsm":
        return lambda a, b, **kw: T.trsm(a, b, bm=knob["bm"], bn=knob["bn"])
    if op == "trmm":
        return lambda a, b, **kw: TM.trmm(
            a, b, bm=knob["bm"], bn=knob["bn"], variant=knob["variant"])
    fn = K.syrk if op == "syrk" else K.syr2k
    return lambda *xs, **kw: fn(*xs, bm=knob["bm"], bk=knob["bn"],
                                variant=knob["variant"], **kw)


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--op", choices=sorted(CALLS), default="trmm")
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("trmm_knob_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"[env] {card}; {args.label}: {ops.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    space = ops.knob_space_for(args.op)
    for shapes, kw in CALLS[args.op]:
        per_set = 4 * sum(math.prod(s) for s in shapes)
        sets = [[torch.randn(s, generator=gen, device="cuda") for s in shapes]
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        if args.op == "trsm":
            for xs in sets:
                xs[0].diagonal(dim1=-2, dim2=-1).add_(shapes[0][-1])
        iters = 3 if per_set > 200e6 else 20
        label = f"{args.op} " + " ".join(str(s) for s in shapes)
        total = 0.0
        for knob in space:
            fn = _kernel(args.op, knob)
            for xs in sets:
                fn(*xs, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(*sets[i % len(sets)], **kw)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
            total += ms
            print(f"[knob] [{card}] {args.label} {label} "
                  f"{knob['bm']}x{knob['bn']}/{knob['variant']} {ms:.4f} ms",
                  flush=True)
        print(f"[knob] [{card}] {args.label} {label} sum over "
              f"{len(space)} candidates {total:.4f} ms", flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
