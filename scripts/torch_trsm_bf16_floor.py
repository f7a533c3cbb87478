#!/usr/bin/env python3
"""How far apart two right answers of the bf16 TRSM lie, on the card.

The bf16 scheme (``kernels/trsm.py``: the reference's ``trsm_pallas`` on
bf16) rounds R_i = bf16(alpha B_i) - bf16(A[i, :i] @ X[:i]) to bf16 before
X_i = bf16(D_i^-1 @ R_i), so two float32 summation orders of the same
scheme can put an element of X one or two bf16 ulps apart, and X carries
that down the block rows.  For each seed and each of ``chip_smoke.py``'s
phase-5b trsm calls ((4096, 4096) against (4096, 14336), and the
(8, 512, 512) stack), on coupled operands (m I + (sqrt(m) / 2) N(0, 1))
and on the standard ones (N(0, 1) + m I), this prints, relative to the
largest output:

- the kernels (``run_op``, default knob) against ``trsm_plain``;
- ``trsm_plain`` against the same scheme with float64 sums
  (``chip_smoke.trsm_plain_f64_sums``): the scheme's own sum-order floor;
- the kernels against that float64-summed scheme;
- both against a float64 solve of the same bf16 values;
- a substitution that drops the first 64 indices of each step 0 (the
  control ``chip_smoke.py`` holds above its limit);
- the worst element of the first reading: its value in the kernels' and
  the plain result, in bf16 ulps of that element.

``--after-checks`` draws each seed's operands as a probe run did: one
(300, 300) x (300, 257) coupled draw, then ``chip_smoke.check_trsm_bf16``
on the same generator, then the calls (coupled only).  Run from the root
of a checkout on a machine with the card::

    python3 -u scripts/torch_trsm_bf16_floor.py --seeds 0 1 2
    python3 -u scripts/torch_trsm_bf16_floor.py --seeds 0 --after-checks
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--after-checks", action="store_true")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import trsm as T

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._sh("nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader").splitlines()[0]
    kd = ops.default_knob("trsm").dict
    bm = kd["bm"]
    cases = [c for c in cs.bf16_precond_cases() if c["op"] == "trsm"]
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if args.after_checks:
            cs.make_operands(torch, gen, "trsm", [(300, 300), (300, 257)],
                             coupled=True)
            cs.check_trsm_bf16(torch, lambda *shape: torch.randn(
                shape, generator=gen, device="cuda"))
        for case in cases:
            for coupled in (True,) if args.after_checks else (True, False):
                a, b = (x.bfloat16() for x in cs.make_operands(
                    torch, gen, "trsm", case["shapes"], coupled=coupled))
                out = ops.run_op("trsm", (a, b), backend="hopper")
                plain = T.trsm_plain(a, b, bm=bm)
                f64_sums = cs.trsm_plain_f64_sums(a, b, bm=bm)
                exact = torch.linalg.solve_triangular(
                    torch.tril(a.double()), b.double(), upper=False)
                dropped = T.trsm_plain(cs.trsm_dropped_a(a, bm), b, bm=bm)
                d = (out.float() - plain.float()).abs().flatten()
                i = int(d.argmax())
                got, want = out.flatten()[i].item(), plain.flatten()[i].item()
                ulp = 2.0 ** (math.floor(math.log2(abs(want))) - 7) \
                    if want else float("nan")
                print(f"[trsm_bf16:floor] [{card}] seed {seed} "
                      f"{'after checks ' if args.after_checks else ''}"
                      f"{case['label']} "
                      f"{'coupled' if coupled else 'standard'}: kernels vs "
                      f"plain {cs._rel_err(out, plain):.3e} | plain vs "
                      f"float64 sums {cs._rel_err(plain, f64_sums):.3e} | "
                      f"kernels vs float64 sums "
                      f"{cs._rel_err(out, f64_sums):.3e} | vs float64 "
                      f"solve: kernels {cs._rel_err(out, exact):.3e}, plain "
                      f"{cs._rel_err(plain, exact):.3e} | dropped "
                      f"{cs.TRSM_DROP} of each step 0 "
                      f"{cs._rel_err(dropped, plain):.3e} | worst element "
                      f"{got!r} vs {want!r} ({abs(got - want) / ulp:.0f} "
                      f"ulps; max |plain| "
                      f"{plain.float().abs().max().item()!r}) | elements "
                      f"apart {(out != plain).float().mean().item():.3e}",
                      flush=True)
                del a, b, out, plain, f64_sums, exact, dropped
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
