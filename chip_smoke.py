#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Drives the port's main path end to end, through the entry points a user
calls, and fails (non-zero exit) if any phase fails:

1. environment: the card's name and power limit, CUDA, nvcc;
2. build: every kernel source from this checkout, with nvcc's
   ``-Xptxas -v`` report (registers, shared memory, spills);
3. kernel vs plain: the GEMM kernel under every tile of the Hopper knob
   space against a float64 oracle on ragged and aligned shapes,
   ``alpha``/``beta`` with C, stacks with per-item and shared B, held to
   ``F32_TOL`` (tighter than the reference conformance harness's 5e-4, so
   that a TF32 product fails it); stacked results must equal per-item
   results bit for bit;
4. install: ``repro_torch.launch.calibrate`` times the kernel on the card
   and persists ``hopper__gemm_b4.adsala`` into a temporary registry;
5. serve: a fresh process loads that artifact into a new ``AdsalaRuntime``
   and runs ``run_op("gemm", ...)`` on the llama3-8b linear shapes (d_model
   4096, 8 KV heads x 128, d_ff 14336) at 8 and 2048 tokens, plus one
   bucket-shaped stack with a shared weight; every decision must come from
   the model, every call must launch the kernel and every result must be
   within ``F32_TOL`` of the plain version;
6. times (CUDA events): the kernel under the tuned and the default tile
   and under the best tile of the space (a sweep of all 27), ``torch.matmul``
   as a yardstick the port never calls, the plain version and the float32
   bound of the card.

Run from the root of a checkout on a machine with the card:
``python3 chip_smoke.py``.  The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors and times.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

#: the kernel sources of the main path, built side by side
KERNEL_SOURCES = ("gemm",)

#: the reference conformance harness's ragged GEMM dims
#: (src/repro/backends/conformance.py RAGGED_DIMS["gemm"]) and one aligned
KERNEL_DIMS = ((129, 65, 257), (1, 300, 384), (300, 300, 300),
               (256, 512, 384))
STACK = 3
#: max relative error (to the largest output) of the kernel vs a float64
#: oracle and of a served result vs the plain version.  The reference
#: conformance harness allows 5e-4 for float32; this limit sits above the
#: IEEE-f32 readings on the H100 (1.1e-6 and 4.3e-6) and below what TF32
#: inputs (a 10-bit mantissa, unit roundoff 2**-11) give, so a TF32 path
#: fails it.  Phase 3 checks that TF32-rounded inputs do exceed it.
F32_TOL = 2e-5

#: llama3-8b (src/repro/configs/llama3_8b.py): the (k, n) of its linears
D_MODEL, KV_WIDTH, D_FF = 4096, 8 * 128, 14336
LINEARS = ((D_MODEL, D_MODEL), (D_MODEL, KV_WIDTH), (D_MODEL, D_FF),
           (D_FF, D_MODEL))
TOKENS = (8, 2048)
BUCKET = (8, 128, D_MODEL)          # a serving bucket against one weight

#: published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: calibration settings of phase 4: 256 Halton dims x 27 tiles gather in
#: under a minute on the card; the four families fit in well under one
CALIBRATE_ARGS = ("--backend", "hopper", "--ops", "gemm", "--precisions", "s",
                  "--samples", "256", "--dim-lo", "8", "--dim-hi", "16384",
                  "--footprint-mb", "400", "--tune-trials", "1",
                  "--candidates", "LinearRegression,DecisionTree,KNN,XGBoost")


def serve_cases() -> list[tuple[str, tuple[int, ...], tuple[int, ...]]]:
    """(label, A shape, B shape) of the main path's GEMMs."""
    cases = [(f"T={t} ({t},{k})@({k},{n})", (t, k), (k, n))
             for t in TOKENS for k, n in LINEARS]
    b, s, d = BUCKET
    cases.append((f"bucket ({b},{s},{d})@({d},{d})", BUCKET, (d, d)))
    return cases


def _sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _rel_err(got, want) -> float:
    want = want.double()
    return ((got.double() - want).abs().max()
            / (want.abs().max() + 1e-9)).item()


def _tf32(x):
    """``x`` with its mantissa rounded to TF32's 10 bits, as a TF32 product
    reads its float32 inputs."""
    import torch
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bound(a_shape, b_shape) -> tuple[float, str]:
    """Least ms the card needs for one GEMM: each operand read once, the
    output written once, against the f32 operations at the CUDA-core peak."""
    *lead, m, k = a_shape
    n = b_shape[-1]
    batch = lead[0] if lead else 1
    flops = 2.0 * batch * m * n * k
    nbytes = 4.0 * (batch * m * k + math.prod(b_shape) + batch * m * n)
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _time_ms(torch, fn, sets, iters: int = 10) -> float:
    """Mean ms of ``fn(*operands)`` per call on the card: CUDA events around
    ``iters`` calls after a warmup, cycling through operand ``sets`` so the
    operands come from HBM and not from the 50 MB L2."""
    for ops in sets:
        fn(*ops)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 5, in a fresh process --------------------------------------------

def serve_main(registry_dir: str) -> None:
    """Load the installed artifact into a new runtime and serve the main
    path's GEMMs; prints one ``SERVE_RESULT {json}`` line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rt = AdsalaRuntime()
    loaded = ModelRegistry(registry_dir).load_into(rt, backend="hopper")
    if loaded != 1 or not rt.has("gemm", 4, "hopper"):
        raise SystemExit(f"expected hopper__gemm_b4.adsala in {registry_dir}, "
                         f"loaded {loaded}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(label, torch.randn(a, generator=gen, device="cuda"),
              torch.randn(b, generator=gen, device="cuda"))
             for label, a, b in serve_cases()]
    torch.cuda.synchronize()

    G.LAUNCHES = 0
    outs, per_call = [], []
    for _label, a, b in cases:
        before = G.LAUNCHES
        outs.append(ops.run_op("gemm", (a, b), backend="hopper", runtime=rt))
        per_call.append(G.LAUNCHES - before)
    torch.cuda.synchronize()
    launches = G.LAUNCHES

    stats = rt.stats
    rows, max_abs, max_rel = [], 0.0, 0.0
    for (label, a, b), out, n in zip(cases, outs, per_call):
        dims = ops.dims_of("gemm", (tuple(a.shape), tuple(b.shape)))
        knob = rt.peek("gemm", dims, 4, "hopper")
        plain = G.gemm_plain(a, b)
        if tuple(out.shape) != tuple(plain.shape) or \
                not bool(torch.isfinite(out).all()):
            raise SystemExit(f"{label}: bad output {tuple(out.shape)}")
        max_abs = max(max_abs, (out - plain).abs().max().item())
        rel = _rel_err(out, plain)
        max_rel = max(max_rel, rel)
        rows.append({"label": label, "a": list(a.shape), "b": list(b.shape),
                     "knob": knob.dict if knob is not None else None,
                     "launches": n, "rel_err": rel})
    print("SERVE_RESULT " + json.dumps({
        "rows": rows, "launches": launches, "max_abs_err": max_abs,
        "max_rel_err": max_rel, "model_evals": stats.model_evals,
        "default_calls": stats.default_calls,
        "eval_failures": stats.eval_failures, "calls": stats.calls}),
        flush=True)


# -- the main run -------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops
    from repro_torch.launch import calibrate

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. environment
    card = _sh("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()[0]
    print(f"[env] {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    print("[env] " + _sh(_build.nvcc_path(), "--version").splitlines()[-1],
          flush=True)

    # 2. build every kernel source, all nvcc runs started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for name, _ in zip(KERNEL_SOURCES,
                           pool.map(_build.build, KERNEL_SOURCES)):
            for line in _build.ptxas_report(name).splitlines():
                if "registers" in line or "spill" in line \
                        or "Compiling entry" in line:
                    print(f"[build:{name}] {line.strip()}")
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f} s", flush=True)

    # 3. the kernel against its plain version and a float64 oracle
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    space = ops.knob_space_for("gemm")
    worst, worst_abs, checks, tf32_least = 0.0, 0.0, 0, math.inf
    for m, k, n in KERNEL_DIMS:
        a, b, c = rand(m, k), rand(k, n), rand(m, n)
        # the limit must reject a product of TF32-rounded inputs
        tf32_err = _rel_err(_tf32(a).double() @ _tf32(b).double(),
                            a.double() @ b.double())
        tf32_least = min(tf32_least, tf32_err)
        if not tf32_err > F32_TOL:
            raise SystemExit(f"[kernel] TF32-rounded inputs at {(m, k, n)} "
                             f"pass the limit ({tf32_err:.3e})")
        sa, sb, sc = rand(STACK, m, k), rand(STACK, k, n), rand(STACK, m, n)
        cases = [((a, b, None), 1.0, 0.0), ((a, b, c), 0.5, 2.0),
                 ((sa, sb, sc), 0.5, 2.0), ((sa, b, sc), 0.5, 2.0)]
        for knob in space:
            kd = knob.dict
            tile = dict(bm=kd["bm"], bk=kd["bk"], bn=kd["bn"])
            for (x, y, z), alpha, beta in cases:
                got = G.gemm(x, y, z, alpha=alpha, beta=beta, **tile)
                plain = G.gemm_plain(x, y, z, alpha=alpha, beta=beta)
                oracle = alpha * torch.matmul(x.double(), y.double())
                if z is not None:
                    oracle = oracle + beta * z.double()
                err = _rel_err(got, oracle)
                worst = max(worst, err)
                worst_abs = max(worst_abs, (got - plain).abs().max().item())
                checks += 1
                if not err < F32_TOL:
                    raise SystemExit(f"[kernel] {kd} {tuple(x.shape)}@"
                                     f"{tuple(y.shape)}: rel err {err:.3e}")
                if x.dim() == 3:
                    for i in range(STACK):
                        one = G.gemm(x[i], y[i] if y.dim() == 3 else y, z[i],
                                     alpha=alpha, beta=beta, **tile)
                        if not torch.equal(one, got[i]):
                            raise SystemExit(f"[kernel] {kd}: stacked item "
                                             f"{i} differs from per-item")
    torch.cuda.synchronize()
    print(f"[kernel] {checks} checks over {len(space)} tiles: max rel err "
          f"{worst:.3e} (< {F32_TOL}), max abs err vs plain {worst_abs:.3e}, "
          f"stacked == per-item bit for bit; TF32-rounded inputs: least rel "
          f"err {tf32_least:.3e} (> {F32_TOL})", flush=True)
    # a yardstick only: the library's product with TF32 allowed
    a, b = rand(256, 512), rand(512, 384)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lib_tf32 = _rel_err(torch.matmul(a, b), a.double() @ b.double())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[kernel] torch.matmul with TF32 allowed at (256,512,384): rel "
          f"err {lib_tf32:.3e}", flush=True)

    # 4. install on the card, 5. serve from a fresh process
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        calibrate.main(["--out", str(tmp), *CALIBRATE_ARGS])
        report = json.loads((tmp / "calibration_report.json").read_text())[0]
        print(f"[install] {report['artifact']}: best {report['best_model']}, "
              f"{report['n_samples']} dims x {report['n_knobs']} tiles, "
              f"gather {report['gather_seconds']:.1f} s, total "
              f"{report['wall_seconds']:.1f} s", flush=True)
        for row in report["models"]:
            print(f"[install] {row['name']}: estimated mean speedup "
                  f"{row['estimated_mean_speedup']:.3f}, ideal "
                  f"{row['ideal_mean_speedup']:.3f}, normalized rmse "
                  f"{row['normalized_rmse']:.3f}, eval "
                  f"{row['eval_time_us']:.1f} us")
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.serve_main("
             f"{str(tmp / 'models')!r})"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"[serve] fresh process failed "
                             f"({proc.returncode}):\n{proc.stdout[-4000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    served = json.loads(next(line for line in proc.stdout.splitlines()
                             if line.startswith("SERVE_RESULT "))
                        .split(" ", 1)[1])
    for row in served["rows"]:
        print(f"[serve] {row['label']}: knob {row['knob']} launches "
              f"{row['launches']} rel err {row['rel_err']:.2e}")
    print(f"[serve] model_evals {served['model_evals']} default_calls "
          f"{served['default_calls']} eval_failures "
          f"{served['eval_failures']} launches {served['launches']}",
          flush=True)
    if served["model_evals"] <= 0 or served["default_calls"] != 0 \
            or served["eval_failures"] != 0:
        raise SystemExit("[serve] decisions did not come from the model")
    if any(row["launches"] < 1 for row in served["rows"]):
        raise SystemExit("[serve] a call did not launch the kernel")
    if not served["max_rel_err"] < F32_TOL:
        raise SystemExit(f"[serve] rel err {served['max_rel_err']:.3e}")

    # 6. times on the main path's shapes
    default = ops.default_knob("gemm").dict
    totals = {"ms": 0.0, "default_ms": 0.0, "best_ms": 0.0, "plain_ms": 0.0,
              "library_ms": 0.0, "bound_ms": 0.0, "ops_bound_ms": 0.0}
    for row in served["rows"]:
        a_shape, b_shape = tuple(row["a"]), tuple(row["b"])
        per_set = 4 * (math.prod(a_shape) + math.prod(b_shape))
        sets = [(rand(*a_shape), rand(*b_shape))
                for _ in range(max(1, math.ceil(120e6 / per_set)))]

        def tiled(kd):
            return lambda x, y: G.gemm(x, y, bm=kd["bm"], bk=kd["bk"],
                                       bn=kd["bn"])

        ms = _time_ms(torch, tiled(row["knob"]), sets)
        default_ms = _time_ms(torch, tiled(default), sets)
        library_ms = _time_ms(torch, torch.matmul, sets)
        plain_ms = _time_ms(torch, G.gemm_plain, sets)
        bound_ms, bound_by = _bound(a_shape, b_shape)
        # every tile of the space: the best the knob could have done here
        best_ms, best = min(((_time_ms(torch, tiled(k.dict), sets, iters=3),
                              k.dict) for k in space), key=lambda t: t[0])
        del sets
        for key, v in (("ms", ms), ("default_ms", default_ms),
                       ("best_ms", best_ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("bound_ms", bound_ms)):
            totals[key] += v
        if bound_by == "operations":
            totals["ops_bound_ms"] += bound_ms
        print(f"[times] [{card}] {row['label']}: tuned {row['knob']['bm']}x"
              f"{row['knob']['bk']}x{row['knob']['bn']} {ms:.4f} ms | default "
              f"{default['bm']}x{default['bk']}x{default['bn']} "
              f"{default_ms:.4f} ms | tuned/default speedup "
              f"{default_ms / ms:.3f}x | library (torch.matmul) "
              f"{library_ms:.4f} ms | plain {plain_ms:.4f} ms | bound "
              f"{bound_ms:.4f} ms ({bound_by}) | best tile "
              f"{best['bm']}x{best['bk']}x{best['bn']} {best_ms:.4f} ms "
              f"(best/default {default_ms / best_ms:.3f}x) | launches/call "
              f"{row['launches']}", flush=True)
    print(f"[times] [{card}] main path total: tuned {totals['ms']:.4f} ms, "
          f"default {totals['default_ms']:.4f} ms "
          f"({totals['default_ms'] / totals['ms']:.3f}x), best tiles "
          f"{totals['best_ms']:.4f} ms, library "
          f"{totals['library_ms']:.4f} ms, bound {totals['bound_ms']:.4f} ms",
          flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:55",
        "launches": served["launches"],
        "max_abs_err": served["max_abs_err"],
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if 2 * totals["ops_bound_ms"]
                     >= totals["bound_ms"] else "bytes"),
        "library_ms": totals["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
