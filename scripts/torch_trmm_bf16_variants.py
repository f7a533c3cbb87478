#!/usr/bin/env python3
"""Time the bf16 trmm kernels (``csrc/trmm_bf16.cu``,
``csrc/trmm_packed_bf16.cu``) on the card under design variants that
differ from the checkout's by one constant each, side by side.

Each variant is a set of textual substitutions in a copy of ``csrc/``
(:data:`VARIANTS`; ``base`` is the checkout as it is): the block order's
group of column tiles (``kGroup``: ``rows`` walks the grid row by row with
the column tiles fastest, the order before the groups; ``group1`` walks it
column by column), and how a step across the diagonal (``cross_threads``:
written by the threads from the stored triangle) or above it
(``above_threads``: zeros written by the threads) stages A.  Every
substitution must apply exactly once, so a variant that no longer matches
the source fails.  The script builds both sources of every variant with
the port's nvcc flags, all at once (``scripts/torch_rank_k_variants.py``'s
``build``), and times them in turns (the order reversed every other round)
with CUDA events at phase 5b's big trmm call (``chip_smoke.
bf16_precond_cases``: tril(A) (4096, 4096) against G (4096, 14336)) under
``full``, ``tri`` and ``tri_packed`` at :data:`TILES`, with each time's
share of the bf16 bound.  Every variant computes the same bits: the script
fails if one differs from ``base``.  Run from the root of a checkout on a
machine with the card:

    python3 -u scripts/torch_trmm_bf16_variants.py \\
        --variants base,rows,group1,cross_threads --rounds 2
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import importlib.util
import math
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_GROUP = ("trmm_tile_bf16.cuh", "constexpr int kGroup = 16;")
_CROSS = ("trmm_tile_bf16.cuh", "constexpr bool kCrossByTma = true;")
_ABOVE = ("trmm_tile_bf16.cuh", "constexpr bool kAboveByTma = true;")

#: variant -> [(file of csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    "rows": [(*_GROUP, "constexpr int kGroup = 1 << 20;")],
    "group1": [(*_GROUP, "constexpr int kGroup = 1;")],
    "group4": [(*_GROUP, "constexpr int kGroup = 4;")],
    "group8": [(*_GROUP, "constexpr int kGroup = 8;")],
    "group32": [(*_GROUP, "constexpr int kGroup = 32;")],
    "cross_threads": [(*_CROSS, "constexpr bool kCrossByTma = false;")],
    "above_threads": [(*_ABOVE, "constexpr bool kAboveByTma = false;")],
}
SOURCES = ("trmm_bf16", "trmm_packed_bf16")
TILES = ((64, 64), (128, 128), (128, 256))
KNOBS = [(bm, bn, var) for bm, bn in TILES
         for var in ("full", "tri", "tri_packed")]


@functools.cache
def _rank_k_variants():
    """``scripts/torch_rank_k_variants.py``, whose copy and build this
    script shares."""
    path = Path(__file__).resolve().parent / "torch_rank_k_variants.py"
    spec = importlib.util.spec_from_file_location("rank_k_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def csrc_copy(variant: str, root: Path) -> Path:
    """A copy of ``csrc/`` with the substitutions of ``variant``."""
    return _rank_k_variants().csrc_copy(variant, root, VARIANTS)


def compare(torch, variants: list[str], rounds: int,
            knobs=tuple(KNOBS)) -> None:
    """Builds ``variants`` of the imported package's ``csrc/`` and prints
    a ``[variants:trmm]`` line a variant and round: the big call's times
    under ``knobs`` ``(bm, bn, variant)``.  Fails if a variant's bits
    differ from the first's."""
    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = cs._sh("nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader").splitlines()[0]
    shared = _rank_k_variants()
    tmp = Path(tempfile.mkdtemp(prefix="trmm_variants_"))
    copies = {v: csrc_copy(v, tmp) for v in variants}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(pool.map(shared.build, [(v, n, copies[v])
                                            for v in variants
                                            for n in SOURCES]))
    loaded = {name: _build._LIBS.get(name) for name in SOURCES}

    def use(variant):
        # the wrappers load their library through _build: point it at the
        # variant's
        for name in SOURCES:
            _build._LIBS[name] = ctypes.CDLL(str(libs[variant, name]))
        _build._FUNCS.clear()

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
    case = next(c for c in cs.bf16_precond_cases()
                if c["op"] == "trmm" and "stacked" not in c["label"])
    shapes, kw = case["shapes"], case["kw"]
    per_set = 2 * sum(math.prod(s) for s in shapes)
    sets = [[x.bfloat16() for x in cs.make_operands(torch, gen, "trmm",
                                                    shapes)]
            for _ in range(max(1, math.ceil(120e6 / per_set)))]
    bound_ms, _ = cs._bound("trmm", shapes, kw, bf16=True)
    want = {}
    for rnd in range(rounds):
        for variant in variants if rnd % 2 == 0 else variants[::-1]:
            use(variant)
            parts = []
            for bm, bn, var in knobs:
                fn = cs._kernel_fn("trmm", {"bm": bm, "bn": bn,
                                            "variant": var}, kw)
                out = fn(*sets[0]).view(torch.int16)
                if want.setdefault((bm, bn, var), out) is not out and \
                        not torch.equal(out, want[bm, bn, var]):
                    raise SystemExit(f"[variants:trmm] {variant} differs "
                                     f"from {variants[0]} bit for bit: "
                                     f"{bm}x{bn}/{var}")
                del out
                ms = cs._time_ms(torch, fn, sets, iters=5)
                parts.append(f"{bm}x{bn}/{var} {ms:.4f} ms "
                             f"({100 * bound_ms / ms:.1f} %)")
            print(f"[variants:trmm] [{card}] {case['label']} {variant} "
                  f"round {rnd}: " + ", ".join(parts), flush=True)
    # the checkout's own libraries again
    for name, lib in loaded.items():
        if lib is None:
            _build._LIBS.pop(name, None)
        else:
            _build._LIBS[name] = lib
    _build._FUNCS.clear()


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default="base,rows,group1")
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
    compare(torch, variants, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
