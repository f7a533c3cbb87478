#!/usr/bin/env python3
"""Time the bf16 rank-k kernels (``csrc/rank_k_bf16.cu``,
``csrc/rank_k_packed_bf16.cu``) on the card under design variants that
differ from the checkout's by one constant each, side by side.

Each variant is a set of textual substitutions in a copy of ``csrc/``
(:data:`VARIANTS`; ``base`` is the checkout as it is): the block order's
group of tile rows (``kGroup``: ``rows`` walks the grid row by row, as
the kernels did before the groups), the contraction indices a stage holds
(``kStep``), and the blocks an SM the wgmma loop's tile is meant to hold
(which sets the ring's depth).  Every substitution must apply exactly
once, so a variant that no longer matches the source fails.  The script
builds both sources of every variant with the port's nvcc flags, all at
once, and times them in turns (the order reversed every other round) with
CUDA events at phase 5b's three big rank-k calls (``chip_smoke.
bf16_precond_cases``: the L = G G^T and R = G^T G syrk updates and the
(4096, 4096) syr2k) under ``full``, ``tri`` and ``tri_packed`` at bm 64
and 128 (bk 16; the kernels stage 64 contraction indices at every bk),
with each time's share of the bf16 bound.  Every variant computes the
same bits: the script fails if one differs from ``base`` at any call.
Run from the root of a checkout on a machine with the card:

    python3 -u scripts/torch_rank_k_variants.py \\
        --variants base,rows,group64,step32,blocks2,blocks6 --rounds 2
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_GROUP = ("rank_k_tile_bf16.cuh", "constexpr int kGroup = 16;")
_STEP = ("rank_k_tile_bf16.cuh", "constexpr int kStep = 64;")
_BLOCKS = ("bf16_wgmma_mainloop.cuh",
           "cmax(1, cmin(4, 512 / (WARPGROUPS * (ACC + 64))))")


def _blocks(most: int, regs: int = 512) -> list:
    return [(*_BLOCKS, f"cmax(1, cmin({most}, {regs} / (WARPGROUPS * "
                       f"(ACC + 64))))")]


#: variant -> [(file of csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    "rows": [(*_GROUP, "constexpr int kGroup = 1;")],
    "group4": [(*_GROUP, "constexpr int kGroup = 4;")],
    "group64": [(*_GROUP, "constexpr int kGroup = 64;")],
    "step32": [(*_STEP, "constexpr int kStep = 32;")],
    # bm 64: 2 or 3 blocks an SM and a deeper ring; or 6, two stages
    "blocks2": _blocks(2),
    "blocks3": _blocks(3),
    "blocks6": _blocks(6, 640),
}
SOURCES = ("rank_k_bf16", "rank_k_packed_bf16")
KNOBS = [(bm, var) for bm in (64, 128)
         for var in ("full", "tri", "tri_packed")]


def csrc_copy(variant: str, root: Path, table: dict | None = None) -> Path:
    """A copy of ``csrc/`` with the substitutions of ``variant`` in
    ``table`` (:data:`VARIANTS` by default)."""
    from repro_torch.kernels import _build
    out = root / variant
    shutil.copytree(_build.CSRC, out)
    for name, text, new in (VARIANTS if table is None else table)[variant]:
        path = out / name
        src = path.read_text()
        if src.count(text) != 1:
            raise SystemExit(f"{variant}: {name} holds {src.count(text)} "
                             f"copies of {text!r}, expected one")
        path.write_text(src.replace(text, new))
    return out


def build(job) -> tuple:
    from repro_torch.kernels import _build
    variant, name, csrc = job
    lib = csrc.parent / f"lib{name}_{variant}.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build.nvcc_path(), *flags, "-o", str(lib),
                           str(csrc / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {variant} {name}:\n"
                         f"{proc.stderr[-4000:]}")
    return (variant, name), lib


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default="base,rows,step32,blocks2")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    variants = args.variants.split(",")
    if variants[0] != "base" or any(v not in VARIANTS for v in variants):
        raise SystemExit(f"--variants: base first, then of {list(VARIANTS)}")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = cs._sh("nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader").splitlines()[0]
    tmp = Path(tempfile.mkdtemp(prefix="rank_k_variants_"))
    copies = {v: csrc_copy(v, tmp) for v in variants}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(pool.map(build, [(v, n, copies[v]) for v in variants
                                     for n in SOURCES]))

    def use(variant):
        # the wrappers load their library through _build: point it at the
        # variant's
        for name in SOURCES:
            _build._LIBS[name] = ctypes.CDLL(str(libs[variant, name]))
        _build._FUNCS.clear()

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    big = [c for c in cs.bf16_precond_cases()
           if c["op"] in ("syrk", "syr2k") and "stacked" not in c["label"]]
    for case in big:
        op, shapes, kw = case["op"], case["shapes"], case["kw"]
        per_set = 2 * sum(math.prod(s) for s in shapes)
        sets = [[x.bfloat16() for x in cs.make_operands(torch, gen, op,
                                                        shapes)]
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        bound_ms, _ = cs._bound(op, shapes, kw, bf16=True)
        want = {}
        for rnd in range(args.rounds):
            for variant in variants if rnd % 2 == 0 else variants[::-1]:
                use(variant)
                parts = []
                for bm, var in KNOBS:
                    kd = {"bm": bm, "bn": 16, "bk": bm, "variant": var}
                    fn = cs._kernel_fn(op, kd, kw)
                    out = fn(*sets[0]).view(torch.int16)
                    if want.setdefault((bm, var), out) is not out and \
                            not torch.equal(out, want[bm, var]):
                        raise SystemExit(f"[variants] {variant} differs from "
                                         f"base bit for bit: {case['label']} "
                                         f"{bm}x16/{var}")
                    del out
                    ms = cs._time_ms(torch, fn, sets, iters=5)
                    parts.append(f"{bm}x16/{var} {ms:.4f} ms "
                                 f"({100 * bound_ms / ms:.1f} %)")
                print(f"[variants] [{card}] {case['label']} {variant} "
                      f"round {rnd}: " + ", ".join(parts), flush=True)
        del sets, want
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
