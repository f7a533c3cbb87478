#!/usr/bin/env python3
"""Two versions of the port's bf16 GEMM, SYMM, rank-k and TRMM kernels
side by side, on the card.

For the checkout whose ``src`` is given (this one by default), this prints
on the card it runs on:

- ``[ab:host]``: the host's µs a call of the GEMM wrapper on bf16 and on
  float32 operands of (8,64)@(64,64) and of a decode step's (4,1,4096) @
  (4096,4096), at the default tile (CUDA events around 500 back-to-back
  calls: the card's work is too small to matter);
- ``[ab:gemm_bf16]``: the bf16 GEMM at ``chip_smoke.py``'s phase-7 linear
  shapes (T = 8 and 2048 against each llama3-8b weight), at the default
  tile and the best of the space, beside the bf16 bound and the share of
  it, and the default tile's total over the 8 calls;
- ``[ab:symm_bf16]``: the bf16 SYMM at phase 5b's two calls, at the
  default tile and the best, and the default's total;
- ``[ab:rank_k_bf16]``: the bf16 SYRK and SYR2K at phase 5b's five calls
  (the L = G G^T and R = G^T G updates, the (4096,4096) syr2k, both
  (8,512,512) stacks) under ``full``, ``tri`` and ``tri_packed``, each at
  the default tile and the best tile of the variant, with its share of the
  bf16 bound, beside ``torch.addmm`` (``torch.matmul`` without C) in bf16;
  then each kernel's default total over the calls (``rank_k_bf16``:
  ``full`` and ``tri``; ``rank_k_packed_bf16``: ``tri_packed``), as phase 7
  sums them;
- ``[ab:trmm_bf16]``: the bf16 TRMM at phase 5b's two calls (the big
  tril(L) against G and the (8,512,512) stack) under ``full``, ``tri``
  and ``tri_packed``, each at the default tile and the best tile of the
  variant, with its share of the bf16 bound, beside ``torch.matmul`` of
  ``tril(A)`` in bf16; then each kernel's default total over the calls
  (``trmm_bf16``: ``full`` and ``tri``; ``trmm_packed_bf16``:
  ``tri_packed``), as phase 7 sums them;
- ``[ab:precond]``: the bf16 trsm call at phase 5b's calls at the default
  tile (``trsm_inv_bf16`` then ``trsm_bf16``), and the default totals of
  the trmm kernels and of trsm;
- ``[ab:trsm_bf16]``: the bf16 TRSM's substitution (``trsm_bf16``, from
  its bm's inverses) at phase 5b's two calls, at the default tile and the
  best tile of the space, with its share of the bf16 bound, beside
  ``torch.linalg.solve_triangular`` (bf16 where PyTorch takes it, else
  float32 on upcast operands); then the default's total over the calls,
  as phase 7 sums it;
- with ``--orders``, ``[variants:trmm]``: the bf16 trmm kernels of that
  ``src`` built once more under the block order before the column groups
  (``scripts/torch_trmm_bf16_variants.py``'s ``rows``) and timed beside
  its own at the big call, bit for bit the same (a checkout whose sources
  have no column groups fails);
- ``[ab:6g]``: the device time a call (``torch.profiler``, the kernels'
  own time) of the bf16 GEMM at the default tile at phase 6g's shapes,
  llama3-8b's four kinds of linear and its LM head in a prefill of 4 x 128
  tokens, (512, d) @ (d, n), and a decode step, a stack of 4 rows
  (4, 1, d) against the shared weight, and a step's total (one layer's 7
  linears x 32 layers, and the head);
- with ``--build``, first ``[ab:build]``: every kernel source of that
  ``src`` (``chip_smoke.KERNEL_SOURCES``) built at once into a fresh
  directory, as phase 2 builds them, and each source's seconds of nvcc;
- with ``--checks``, ``chip_smoke.check_gemm_bf16``,
  ``check_symm_trmm_bf16``, ``check_rank_k_bf16`` and
  ``check_trsm_bf16`` (phase 3's bf16 gemm, symm, trmm, syrk, syr2k and
  trsm checks, this checkout's version of them) run on that ``src``:
  their lines carry each kernel's largest elementwise excess over one
  bf16 ulp plus the float32 slack.

Run from the root of a checkout, the versions in turns (a parent unpacked
with ``git archive`` into a directory ``.gitignore`` lists)::

    python3 -u scripts/torch_bf16_ab.py --src build/parent/src --label parent
    python3 -u scripts/torch_bf16_ab.py --label change --checks --orders
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--checks", action="store_true")
    parser.add_argument("--build", action="store_true")
    parser.add_argument("--orders", action="store_true")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._sh("nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader").splitlines()[0]
    label = f"[{card}] {args.label}"
    if args.build:
        import concurrent.futures
        import tempfile
        import time
        from repro_torch.kernels import _build
        # a fresh build directory: nothing built before is reused
        _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="bf16_ab_build_"))

        def timed(name):
            t0 = time.perf_counter()
            _build.build(name)
            return time.perf_counter() - t0

        # the sources of that checkout (an older one may have fewer)
        names = [n for n in cs.KERNEL_SOURCES
                 if (_build.CSRC / f"{n}.cu").exists()]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            seconds = dict(zip(names, pool.map(timed, names)))
        print(f"[ab:build] {label}: {time.perf_counter() - t0:.1f} s; "
              + ", ".join(f"{name} {sec:.1f}" for name, sec in
                          sorted(seconds.items(), key=lambda kv: -kv[1])),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)

    def brand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    kd = ops.default_knob("gemm").dict
    tile = {key: kd[key] for key in ("bm", "bk", "bn")}
    host = {}
    for shape in (((8, 64), (64, 64)),
                  ((4, 1, cs.D_MODEL), (cs.D_MODEL, cs.D_MODEL))):
        x, w = brand(*shape[0]), brand(*shape[1])
        for name, ops_ in (("bf16", (x, w)),
                           ("float32", (x.float(), w.float()))):
            host[shape, name] = 1e3 * cs._time_ms(
                torch, lambda a, b: G.gemm(a, b, **tile), [ops_], iters=500)
    print(f"[ab:host] {label}: GEMM wrapper a call at the default tile "
          + "; ".join(f"{a}@{b} {name} {us:.2f} us"
                      for ((a, b), name), us in host.items()), flush=True)

    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    space = ops.knob_space_for("gemm")
    total = 0.0
    for t in cs.TOKENS:
        for k, n in cs.LINEARS:
            shapes = [[t, k], [k, n]]
            per_set = 2 * sum(math.prod(s) for s in shapes)
            sets = [[brand(*s) for s in shapes]
                    for _ in range(max(1, math.ceil(120e6 / per_set)))]
            ms = cs._time_ms(torch, cs._kernel_fn("gemm", kd, {}), sets)
            best_ms, best = min(
                ((cs._time_ms(torch, cs._kernel_fn("gemm", k_.dict, {}), sets,
                              iters=3), k_.dict) for k_ in space),
                key=lambda v: v[0])
            bound_ms, bound_by = cs._bound("gemm", shapes, {}, bf16=True)
            total += ms
            print(f"[ab:gemm_bf16] {label} T={t} ({t},{k})@({k},{n}): "
                  f"default {ms:.4f} ms ({100 * bound_ms / ms:.1f} % of "
                  f"bound), best {cs._knob_str('gemm', best)} {best_ms:.4f} "
                  f"ms ({100 * bound_ms / best_ms:.1f} %), bound "
                  f"{bound_ms:.4f} ms ({bound_by})", flush=True)
            del sets
    print(f"[ab:gemm_bf16] {label}: default over {2 * len(cs.LINEARS)} "
          f"calls {total:.4f} ms", flush=True)

    sd = ops.default_knob("symm").dict
    total = 0.0
    for case in cs.bf16_precond_cases():
        if case["op"] != "symm":
            continue
        shapes = case["shapes"]
        per_set = 2 * sum(math.prod(s) for s in shapes)
        sets = [[x.bfloat16() for x in cs.make_operands(
                    torch, gen, "symm", shapes)]
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        ms = cs._time_ms(torch, cs._kernel_fn("symm", sd, {}), sets)
        best_ms, best = min(
            ((cs._time_ms(torch, cs._kernel_fn("symm", k_.dict, {}), sets,
                          iters=3), k_.dict)
             for k_ in ops.knob_space_for("symm")), key=lambda v: v[0])
        bound_ms, _ = cs._bound("symm", shapes, {}, bf16=True)
        total += ms
        print(f"[ab:symm_bf16] {label} {case['label']}: default {ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f} % of bound), best "
              f"{cs._knob_str('symm', best)} {best_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms", flush=True)
        del sets
    print(f"[ab:symm_bf16] {label}: default over 5b's 2 calls "
          f"{total:.4f} ms", flush=True)
    rank_k_and_precond(torch, cs, ops, gen, label)
    trsm_ab(torch, cs, ops, gen, label)
    matmul.allow_bf16_reduced_precision_reduction = reduced
    if args.orders:
        sys.path.insert(0, str(ROOT / "scripts"))
        import torch_trmm_bf16_variants as variants
        variants.compare(torch, ["base", "rows"], 2,
                         knobs=[(bm, bn, var)
                                for bm, bn in ((64, 64), (128, 128))
                                for var in ("full", "tri", "tri_packed")])

    # phase 6g's GEMMs: a layer's q, k, v, o, gate, up, down, and the head
    layer = ((cs.D_MODEL, cs.D_MODEL), (cs.D_MODEL, cs.KV_WIDTH),
             (cs.D_MODEL, cs.KV_WIDTH), (cs.D_MODEL, cs.D_MODEL),
             (cs.D_MODEL, cs.D_FF), (cs.D_MODEL, cs.D_FF),
             (cs.D_FF, cs.D_MODEL))
    head = (cs.D_MODEL, 128256)
    for what, lead in (("prefill", (512,)), ("decode", (4, 1))):
        step = 0.0
        parts = []
        for k, n in sorted({*layer, head}):
            x, w = brand(*lead, k), brand(k, n)
            ms = cs._device_ms(torch, lambda a, b: G.gemm(a, b, **tile),
                               [(x, w)], iters=20)
            step += ms * (32 * layer.count((k, n)) + ((k, n) == head))
            parts.append(f"{k}x{n} {ms:.4f}")
            del x, w
        print(f"[ab:6g] {label} {what} {lead + ('d',)} @ (d, n), device ms "
              f"a call: {', '.join(parts)}; a {what} step's GEMMs "
              f"{step:.3f} ms", flush=True)

    if args.checks:
        check = torch.Generator(device="cuda").manual_seed(cs.SEED)

        def rand(*shape):
            return torch.randn(shape, generator=check, device="cuda")

        print(f"[ab:checks] {label}:", flush=True)
        cs.check_gemm_bf16(torch, rand)
        cs.check_symm_trmm_bf16(torch, rand)
        cs.check_rank_k_bf16(torch, rand)
        cs.check_trsm_bf16(torch, rand)
    return 0


def rank_k_and_precond(torch, cs, ops, gen, label: str) -> None:
    """The ``[ab:rank_k_bf16]``, ``[ab:trmm_bf16]`` and ``[ab:precond]``
    lines: phase 5b's calls on bf16 operands (``cs.make_operands``, cycled
    through > 120 MB), CUDA events around back-to-back calls."""
    from repro_torch.core.knobs import HOPPER_2D_VARIANTS
    totals = {}
    for case in cs.bf16_precond_cases():
        op, shapes, kw = case["op"], case["shapes"], case["kw"]
        if op not in ("syrk", "syr2k", "trmm", "trsm"):
            continue
        per_set = 2 * sum(math.prod(s) for s in shapes)
        sets = [[x.bfloat16() for x in cs.make_operands(
                    torch, gen, op, shapes,
                    coupled=case.get("coupled", False))]
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        default = ops.default_knob(op).dict
        bound_ms, _ = cs._bound(op, shapes, kw, bf16=True)
        if op == "trsm":
            ms = cs._time_ms(torch, cs._kernel_fn(op, default, kw), sets)
            totals["trsm"] = totals.get("trsm", 0.0) + ms
            print(f"[ab:precond] {label} {case['label']}: trsm call "
                  f"(trsm_inv_bf16, trsm_bf16) default "
                  f"{cs._knob_str(op, default)} {ms:.4f} ms", flush=True)
            del sets
            continue
        parts = []
        for var in HOPPER_2D_VARIANTS[op]:
            kd = {**default, "variant": var}
            ms = cs._time_ms(torch, cs._kernel_fn(op, kd, kw), sets)
            name = cs.kernel_of(op, kd, torch.bfloat16)
            totals[name] = totals.get(name, 0.0) + ms
            best_ms, best = min(
                ((cs._time_ms(torch, cs._kernel_fn(op, k.dict, kw), sets,
                              iters=3), k.dict)
                 for k in ops.knob_space_for(op) if k["variant"] == var),
                key=lambda v: v[0])
            parts.append(f"{var} default {ms:.4f} ms "
                         f"({100 * bound_ms / ms:.1f} % of bound), best "
                         f"{cs._knob_str(op, best)} {best_ms:.4f} ms "
                         f"({100 * bound_ms / best_ms:.1f} %)")
        lib, prep = cs._library_fn(torch, op, kw, shapes)
        lib_sets = [prep(xs) for xs in sets] if prep else sets
        library_ms = cs._time_ms(torch, lib, lib_sets)
        what = "torch.addmm" if kw else "torch.matmul"
        if op == "trmm":
            what += " of tril(A)"
        tag = "trmm_bf16" if op == "trmm" else "rank_k_bf16"
        print(f"[ab:{tag}] {label} {case['label']}: "
              + " | ".join(parts) + f" | library ({what} bf16) "
              f"{library_ms:.4f} ms ({100 * bound_ms / library_ms:.1f} "
              f"%) | bound {bound_ms:.4f} ms", flush=True)
        del sets, lib_sets
    for name in ("rank_k_bf16", "rank_k_packed_bf16"):
        print(f"[ab:rank_k_bf16] {label}: {name} default over 5b's 5 calls "
              f"{totals[name]:.4f} ms", flush=True)
    for name in ("trmm_bf16", "trmm_packed_bf16"):
        print(f"[ab:trmm_bf16] {label}: {name} default over 5b's 2 calls "
              f"{totals[name]:.4f} ms", flush=True)
    print(f"[ab:precond] {label}: default over 5b's calls "
          + ", ".join(f"{name} {totals[name]:.4f} ms" for name in
                      ("trmm_bf16", "trmm_packed_bf16", "trsm")), flush=True)


def _trsm_sets(torch, cs, gen, case):
    """A trsm case's bf16 operand sets (coupled, cycled through > 120
    MB)."""
    shapes = case["shapes"]
    per_set = 2 * sum(math.prod(s) for s in shapes)
    return [[x.bfloat16() for x in cs.make_operands(
                torch, gen, "trsm", shapes, coupled=True)]
            for _ in range(max(1, math.ceil(120e6 / per_set)))]


def trsm_ab(torch, cs, ops, gen, label: str) -> None:
    """The ``[ab:trsm_bf16]`` lines: ``trsm_bf16`` at phase 5b's two trsm
    calls, from each bm's inverses (made once, outside the timing), CUDA
    events around back-to-back calls, as phase 7 times it."""
    from repro_torch.kernels import trsm as T
    default = ops.default_knob("trsm").dict
    lib_dtype = cs._solve_dtype(torch)
    total = 0.0
    for case in cs.bf16_precond_cases():
        if case["op"] != "trsm":
            continue
        shapes, kw = case["shapes"], case["kw"]
        sets = _trsm_sets(torch, cs, gen, case)
        invs = {bm: [(a, b, T.diag_inverses(a, bm=bm)) for a, b in sets]
                for bm in sorted({t[0] for t in T.TILES})}

        def sub(kd):
            return lambda a, b, inv: T.substitute(a, b, inv, bm=kd["bm"],
                                                  bn=kd["bn"], **kw)

        ms = cs._time_ms(torch, sub(default), invs[default["bm"]])
        best_ms, best = min(
            ((cs._time_ms(torch, sub(k.dict), invs[k["bm"]], iters=3),
              k.dict) for k in ops.knob_space_for("trsm")),
            key=lambda v: v[0])
        lib_sets = [[x.to(lib_dtype) for x in xs] for xs in sets]
        library_ms = cs._time_ms(
            torch, lambda a, b: torch.linalg.solve_triangular(
                a, b, upper=False), lib_sets)
        bound_ms, bound_by = cs._bound("trsm", shapes, kw, bf16=True)
        total += ms
        print(f"[ab:trsm_bf16] {label} {case['label']}: default "
              f"{cs._knob_str('trsm', default)} {ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f} % of bound), best "
              f"{cs._knob_str('trsm', best)} {best_ms:.4f} ms "
              f"({100 * bound_ms / best_ms:.1f} %) | library "
              f"({str(lib_dtype).removeprefix('torch.')} solve_triangular) "
              f"{library_ms:.4f} ms ({100 * bound_ms / library_ms:.1f} %) "
              f"| bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        del sets, invs, lib_sets
    print(f"[ab:trsm_bf16] {label}: trsm_bf16 default over 5b's 2 calls "
          f"{total:.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
