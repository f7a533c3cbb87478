#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Drives the port's main paths end to end, through the entry points a user
calls, and fails (non-zero exit) if any phase fails:

1. environment: the card's name and power limit, CUDA, nvcc;
2. build: every kernel source from this checkout (``gemm``, ``symm``,
   ``rank_k``, ``rank_k_packed``, ``trmm``, ``trmm_packed``), all nvcc runs
   started together, with nvcc's ``-Xptxas -v`` report (registers, shared
   memory, spills);
3. kernel vs oracle: every kernel under every candidate of its Hopper knob
   space against a float64 oracle, held to ``F32_TOL`` (tighter than the
   reference conformance harness's 5e-4, so that a TF32 product fails it):
   the GEMM on ragged and aligned shapes, ``alpha``/``beta`` with C, stacks
   with per-item and shared B; symm, syrk/syr2k, trmm (every variant) and
   trsm through the port's conformance harness on its ragged dims and one
   aligned shape, with and without C, single and stacked (the error taken
   relative to ``conformance.error_scale``: the largest output, floored
   for a 1 x 1 syr2k whose one dot product may cancel).  Stacked results
   must equal per-item results bit for bit, and syrk/syr2k/trmm
   ``tri_packed`` must equal ``tri`` bit for bit.  Then the structural
   contracts: ``run_op`` equals the padded run (``kernels/padded_ref.py``)
   bit for bit for gemm, symm, syrk, syr2k and trmm under every variant at
   ragged and one-row dims (trsm within 1e-5), with no copy op on its
   dispatch path (trsm: no pad), and every launch's recorded grid equals
   ``introspect.full_grid_for``/``packed_grid_for``, ``tri_packed``
   launching fewer blocks than ``tri``;
4. install: ``repro_torch.launch.calibrate`` times the kernels on the card
   and persists ``hopper__{gemm,symm,syrk,syr2k,trmm,trsm}_b4.adsala`` into
   a temporary registry;
5. serve: a fresh process loads those artifacts into a new
   ``AdsalaRuntime`` and calls ``run_op``: the GEMMs of the llama3-8b
   linears (d_model 4096, 8 KV heads x 128, d_ff 14336) at 8 and 2048
   tokens and one serving bucket with a shared weight; and the operations
   of a Shampoo-style preconditioner of its (4096, 14336) MLP weight G:
   ``syrk`` for L = G G^T and R = G^T G (each as an update
   ``0.05 * G G^T + 0.95 * L`` of the last one), ``symm`` of a (4096, 4096)
   sym(A) against G, ``syr2k`` at (4096, 4096), ``trmm`` of its Cholesky
   factor tril(L) (4096, 4096) against G (whitening G with a triangular
   factor), ``trsm`` of a (4096, 4096) tril(A) against G, and one stacked
   (8, 512, 512) call per op.  Every decision must come from the model,
   every call must launch exactly the kernels its knob names (trsm:
   ``2 ceil(m / bm) - 1`` GEMMs) and every result must be within
   ``F32_TOL`` of the plain version.  Then syrk and syr2k run the stacked
   call, and trmm both its calls, once under each variant with the tile
   the model chose (a caller that pins the variant through ``run_op(...,
   knob=...)``), which must give tri_packed == tri bit for bit.  Last, a
   ``BlasService`` on the card under the same runtime: 4 client threads
   submit 192 requests together (32 of each op at the preconditioner-block
   shape), one warm-up window and then 5 timed ones, every future within
   ``F32_TOL`` of the plain version of its request, the recorded launches
   equal to the buckets executed, mean batch above 1, no failure;
   requests/s through the service against one ``run_op`` per request, in
   windows alternated with the service's, as median, min and max;
6. times (CUDA events) of every served call: the kernel under the tuned and
   the default knob and under the best knob of a sweep of its whole space,
   the plain version, a library call the port never makes (``torch.matmul``,
   ``torch.addmm``, ``torch.linalg.solve_triangular``) and the float32
   bound of the card.

The launch counts come from ``repro_torch.kernels.introspect``: each path
(the ``run_op`` calls, then the service) is driven with the counts set to 0
just before it and read just after; launches made by the comparisons of
phase 3 do not count.

Run from the root of a checkout on a machine with the card:
``python3 chip_smoke.py``.  The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors and times.

``python3 -u chip_smoke.py --repeat-checks N`` runs phases 1 and 2 and then
phase 3 N times, each repeat under a 120 s watchdog that prints every
thread's stack and exits if it trips: a stress run of the checks, which
prints no result line.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import faulthandler
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

#: the kernel sources of the main paths, built side by side
KERNEL_SOURCES = ("gemm", "symm", "rank_k", "rank_k_packed", "trmm",
                  "trmm_packed")

#: the reference conformance harness's ragged GEMM dims
#: (src/repro/backends/conformance.py RAGGED_DIMS["gemm"]) and one aligned
KERNEL_DIMS = ((129, 65, 257), (1, 300, 384), (300, 300, 300),
               (256, 512, 384))
#: one aligned shape beside RAGGED_DIMS for the 2-dim ops
ALIGNED_2D = (256, 384)
STACK = 3
#: max relative error (to the largest output) of the kernel vs a float64
#: oracle and of a served result vs the plain version.  The reference
#: conformance harness allows 5e-4 for float32; this limit sits above the
#: IEEE-f32 readings on the H100 (1.1e-6 and 4.3e-6 for the GEMM) and below
#: what TF32 inputs (a 10-bit mantissa, unit roundoff 2**-11) give, so a
#: TF32 path fails it.  Phase 3 checks that TF32-rounded inputs exceed it.
F32_TOL = 2e-5

#: llama3-8b (src/repro/configs/llama3_8b.py): the (k, n) of its linears
D_MODEL, KV_WIDTH, D_FF = 4096, 8 * 128, 14336
LINEARS = ((D_MODEL, D_MODEL), (D_MODEL, KV_WIDTH), (D_MODEL, D_FF),
           (D_FF, D_MODEL))
TOKENS = (8, 2048)
BUCKET = (8, 128, D_MODEL)          # a serving bucket against one weight
#: the stacked call of each 2-dim op
STACKED_2D = (8, 512, 512)
#: the service phase: client threads, requests of each op per thread, the
#: request shape (gemm: (512, 512, 512)), the flush size and the workers
SERVICE_THREADS, SERVICE_PER_THREAD = 4, 8
SERVICE_SHAPE = (512, 512)
SERVICE_MAX_BATCH, SERVICE_WORKERS = 8, 2
#: timed windows of the whole traffic, through the service and as one
#: run_op per request, alternated after one warm-up window of each
SERVICE_WINDOWS = 5
#: seconds the fresh serving process may take
SERVE_TIMEOUT_S = 600

#: published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: calibration settings of phase 4, and the Halton dims each op installs
#: with (log-scaled, so most are small: the six gather in about two
#: minutes on the card)
CALIBRATE_ARGS = ("--backend", "hopper", "--precisions", "s",
                  "--dim-lo", "8", "--dim-hi", "16384",
                  "--footprint-mb", "400", "--tune-trials", "1",
                  "--candidates", "LinearRegression,DecisionTree,KNN,XGBoost")
CALIBRATE_SAMPLES = {"gemm": 256, "symm": 256, "syrk": 256, "syr2k": 192,
                     "trmm": 192, "trsm": 192}

#: the kernels the main paths launch: name -> (route, source, TPU kernel)
KERNELS = {
    "gemm": ("cuda", "src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:55"),
    "symm": ("cuda", "src/repro_torch/kernels/csrc/symm.cu",
             "src/repro/kernels/symm.py:38"),
    "rank_k": ("cuda", "src/repro_torch/kernels/csrc/rank_k.cu",
               "src/repro/kernels/syrk.py:73"),
    "rank_k_packed": ("cuda", "src/repro_torch/kernels/csrc/rank_k_packed.cu",
                      "src/repro/kernels/syrk.py:132"),
    "trmm": ("cuda", "src/repro_torch/kernels/csrc/trmm.cu",
             "src/repro/kernels/trmm.py:57"),
    "trmm_packed": ("cuda", "src/repro_torch/kernels/csrc/trmm_packed.cu",
                    "src/repro/kernels/trmm.py:85"),
    "trsm": ("cuda", "src/repro_torch/kernels/trsm.py",
             "src/repro/kernels/trsm.py:41"),
}


def serve_cases() -> list[dict]:
    """The main paths' calls: label, op, operand shapes and keywords."""
    cases = [{"label": f"T={t} ({t},{k})@({k},{n})", "op": "gemm",
              "shapes": [[t, k], [k, n]], "kw": {}}
             for t in TOKENS for k, n in LINEARS]
    b, s, d = BUCKET
    cases.append({"label": f"bucket ({b},{s},{d})@({d},{d})", "op": "gemm",
                  "shapes": [list(BUCKET), [d, d]], "kw": {}})
    ema = {"alpha": 0.05, "beta": 0.95}
    for n, k in ((D_MODEL, D_FF), (D_FF, D_MODEL)):
        cases.append({"label": f"syrk L=GG^T A ({n},{k}) C ({n},{n})",
                      "op": "syrk", "shapes": [[n, k], [n, n]], "kw": ema})
    cases += [
        {"label": f"symm sym(A) ({D_MODEL},{D_MODEL}) B ({D_MODEL},{D_FF})",
         "op": "symm", "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_FF]],
         "kw": {}},
        {"label": f"syr2k A,B ({D_MODEL},{D_MODEL})", "op": "syr2k",
         "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_MODEL]], "kw": {}},
        {"label": f"trmm tril(L) ({D_MODEL},{D_MODEL}) G ({D_MODEL},{D_FF})",
         "op": "trmm", "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_FF]],
         "kw": {}},
        {"label": f"trsm tril(A) ({D_MODEL},{D_MODEL}) B ({D_MODEL},{D_FF})",
         "op": "trsm", "shapes": [[D_MODEL, D_MODEL], [D_MODEL, D_FF]],
         "kw": {}},
    ]
    bt, m, n = STACKED_2D
    for op, shapes in (("symm", [[bt, m, m], [bt, m, n]]),
                       ("syrk", [[bt, m, n]]),
                       ("syr2k", [[bt, m, n], [bt, m, n]]),
                       ("trmm", [[bt, m, m], [bt, m, n]]),
                       ("trsm", [[bt, m, m], [bt, m, n]])):
        cases.append({"label": f"{op} stacked {STACKED_2D}", "op": op,
                      "shapes": shapes, "kw": {}})
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


def _bound(op: str, shapes, kw) -> tuple[float, str]:
    """Least ms the card needs for one call: its BLAS operation count at
    the f32 CUDA-core peak (gemm 2mnk, symm 2m^2n, syrk n^2k, syr2k 2n^2k,
    trmm and trsm m^2n) against each input read once and the output
    written once (a triangular or symmetric A counted as its lower
    triangle)."""
    first = shapes[0]
    batch = first[0] if len(first) == 3 else 1
    with_c = kw.get("beta", 0.0) != 0.0
    if op == "gemm":
        m, k = first[-2:]
        n = shapes[1][-1]
        flops = 2.0 * batch * m * n * k
        words = batch * m * k + math.prod(shapes[1]) + batch * m * n
    elif op in ("symm", "trmm", "trsm"):
        m, n = first[-1], shapes[1][-1]
        flops = batch * m * m * n * (2.0 if op == "symm" else 1.0)
        words = batch * (m * (m + 1) / 2 + 2 * m * n)
    else:
        n, k = first[-2:]
        two = op == "syr2k"
        flops = batch * n * n * k * (2.0 if two else 1.0)
        words = batch * ((2 if two else 1) * n * k + n * n
                         + (n * (n + 1) / 2 if with_c else 0))
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, 4.0 * words / HBM_BYTES_PER_S
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


def kernel_of(op: str, knob: dict) -> str:
    """The kernel (a key of :data:`KERNELS`) a call of ``op`` under
    ``knob`` runs."""
    if op in ("syrk", "syr2k"):
        return "rank_k_packed" if knob["variant"] == "tri_packed" \
            else "rank_k"
    if op == "trmm":
        return "trmm_packed" if knob["variant"] == "tri_packed" else "trmm"
    return op


def _expected_launches(op: str, knob: dict, shapes) -> dict:
    if op == "trsm":
        n_gemm = 2 * -(-shapes[0][-1] // knob["bm"]) - 1
        return {"gemm": n_gemm, "trsm": n_gemm}
    return {kernel_of(op, knob): 1}


def make_operands(torch, gen, op: str, shapes):
    """Seeded operands of a case on the card: standard normal, trsm's A
    made diagonally dominant (``+ m * I``) and syrk's C symmetric."""
    xs = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    if op == "trsm":
        xs[0].diagonal(dim1=-2, dim2=-1).add_(shapes[0][-1])
    if op == "syrk" and len(xs) == 2:
        xs[1] = 0.5 * (xs[1] + xs[1].mT)
    return xs


def plain_of(op: str, knob: dict):
    """The plain PyTorch version of ``op`` under ``knob`` (its variant)."""
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import symm as S
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    from repro_torch.kernels import trsm as T
    if op == "gemm":
        return G.gemm_plain
    if op == "symm":
        return S.symm_plain
    if op == "trmm":
        return TM.trmm_plain
    if op == "trsm":
        return T.trsm_plain
    if op == "syrk":
        return lambda a, c=None, **kw: K.rank_k_plain(
            a, None, c, variant=knob["variant"], **kw)
    return lambda a, b, c=None, **kw: K.rank_k_plain(
        a, b, c, variant=knob["variant"], **kw)


# -- phase 5, in a fresh process --------------------------------------------

def serve_main(registry_dir: str) -> None:
    """Load the installed artifacts into a new runtime and serve the main
    paths' calls, then the same runtime behind a ``BlasService``; prints
    one ``SERVE_RESULT {json}`` line."""
    # a stuck phase prints every thread's stack before the parent's
    # timeout kills this process
    faulthandler.dump_traceback_later(SERVE_TIMEOUT_S - 20, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.core.knobs import Knob
    from repro_torch.kernels import introspect, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rt = AdsalaRuntime()
    loaded = ModelRegistry(registry_dir).load_into(rt, backend="hopper")
    missing = [op for op in ops.HOPPER_OPS if not rt.has(op, 4, "hopper")]
    if loaded != len(ops.HOPPER_OPS) or missing:
        raise SystemExit(f"expected hopper__{{op}}_b4.adsala for every op "
                         f"in {registry_dir}, loaded {loaded}, missing "
                         f"{missing}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, pinned = [], []

    def call(case, operands, knob=None):
        with introspect.capture_launches() as launched:
            out = ops.run_op(case["op"], tuple(operands), backend="hopper",
                             runtime=rt, knob=knob, **case["kw"])
        torch.cuda.synchronize()
        launches = {}
        for kernel, _grid in launched:
            launches[kernel] = launches.get(kernel, 0) + 1
        if knob is None:
            dims = ops.dims_of(case["op"],
                               tuple(tuple(x.shape) for x in operands))
            knob = rt.peek(case["op"], dims, 4, "hopper")
        kd = knob.dict
        plain = plain_of(case["op"], kd)(*operands, **case["kw"])
        if tuple(out.shape) != tuple(plain.shape) or \
                not bool(torch.isfinite(out).all()):
            raise SystemExit(f"{case['label']}: bad output "
                             f"{tuple(out.shape)}")
        want = _expected_launches(case["op"], kd, case["shapes"])
        rows.append({**case, "knob": kd, "launches": launches,
                     "expected_launches": want,
                     "kernel": kernel_of(case["op"], kd),
                     "rel_err": _rel_err(out, plain),
                     "abs_err": (out - plain).abs().max().item()})
        return out

    # the run_op path: counts from 0 just before, read just after
    introspect.reset_launches()
    for case in serve_cases():
        operands = make_operands(torch, gen, case["op"], case["shapes"])
        call(case, operands)
        if case["op"] == "trmm" or (case["op"] in ("syrk", "syr2k")
                                    and "stacked" in case["label"]):
            pinned.append((case, operands))
        del operands
    stats = rt.stats
    served = len(rows)
    # a caller that pins the variant: the stacked rank-k calls and both
    # trmm calls under each variant, with the tile the model chose
    for case, operands in pinned:
        model = dict(rows[[r["label"] for r in rows].index(case["label"])]
                     ["knob"])
        outs = {}
        for variant in ("full", "tri", "tri_packed"):
            knob = Knob(tuple(sorted({**model, "variant": variant}.items())))
            outs[variant] = call({**case, "label": f"{case['label']} pinned "
                                  f"{variant}", "pinned": True},
                                 operands, knob)
        if not torch.equal(outs["tri"].view(torch.int32),
                           outs["tri_packed"].view(torch.int32)):
            raise SystemExit(f"[serve] {case['label']}: tri_packed != tri "
                             f"bit for bit")
    launches = introspect.launch_counts()
    service = serve_service(torch, rt)
    print("SERVE_RESULT " + json.dumps({
        "rows": rows, "served": served, "launches": launches,
        "model_evals": stats.model_evals,
        "default_calls": stats.default_calls,
        "eval_failures": stats.eval_failures, "calls": stats.calls,
        "service": service}), flush=True)


def service_requests(torch, gen) -> list[tuple[str, tuple]]:
    """The service phase's traffic, per client thread: 8 requests of each
    of the six ops, at the preconditioner-block shape (512, 512) and for
    gemm (512, 512, 512), seeded operands on the card."""
    m, n = SERVICE_SHAPE
    shapes = {"gemm": [[m, m], [m, n]], "symm": [[m, m], [m, n]],
              "syrk": [[m, n]], "syr2k": [[m, n], [m, n]],
              "trmm": [[m, m], [m, n]], "trsm": [[m, m], [m, n]]}
    return [(op, tuple(make_operands(torch, gen, op, shapes[op])))
            for _ in range(SERVICE_PER_THREAD) for op in shapes]


def serve_service(torch, rt) -> dict:
    """The service phase, on the card under the installed runtime: four
    client threads submit their requests together.  After one warm-up
    window of the whole traffic (the cold decisions of new shapes, the
    workers' streams), :data:`SERVICE_WINDOWS` windows through the service
    alternate with as many windows of one ``run_op`` per request on the
    same requests.  Checks every result of the service windows against the
    plain version of its own request and their launches against the
    buckets they executed."""
    from repro_torch.kernels import introspect, ops
    from repro_torch.serving import BlasService, ServeConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    traffic = [service_requests(torch, gen) for _ in range(SERVICE_THREADS)]
    flat = [r for part in traffic for r in part]
    torch.cuda.synchronize()
    cfg = ServeConfig(max_batch=SERVICE_MAX_BATCH, linger_ms=2.0,
                      workers=SERVICE_WORKERS)
    before = rt.stats

    def batches(svc) -> dict:
        return {key: (b.batches, b.exec_seconds)
                for key, b in svc.bucket_stats().items() if key[0] == "hopper"}

    with BlasService(runtime=rt, config=cfg) as svc, \
            concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
        def client(reqs):
            return [svc.submit(op, operands) for op, operands in reqs]

        def service_window():
            t0 = time.perf_counter()
            futures = list(pool.map(client, traffic))
            outs = [f.result(timeout=300) for part in futures for f in part]
            dt = time.perf_counter() - t0
            # a worker books its stats just after it resolves the futures
            if not svc.drain(timeout=60):
                raise SystemExit("[service] requests still in flight")
            return dt, outs

        def single_window():
            t0 = time.perf_counter()
            for op, operands in flat:
                ops.run_op(op, operands, runtime=rt)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        service_window()
        single_window()
        st0, buckets0 = dataclasses.replace(svc.stats), batches(svc)
        launches = {k: 0 for k in KERNELS}
        service_s, single_s, results = [], [], []
        for _ in range(SERVICE_WINDOWS):
            introspect.reset_launches()
            dt, outs = service_window()
            for kernel, count in introspect.launch_counts().items():
                launches[kernel] += count
            service_s.append(dt)
            results.append(outs)
            single_s.append(single_window())
        st, buckets1 = svc.stats, batches(svc)
    after = rt.stats
    worst = 0.0
    for i, (op, operands) in enumerate(flat):
        dims = ops.dims_of(op, tuple(tuple(x.shape) for x in operands))
        knob = rt.peek(op, dims, 4, "hopper").dict
        want = plain_of(op, knob)(*operands)
        for outs in results:
            err = _rel_err(outs[i], want)
            worst = max(worst, err)
            if not err < F32_TOL:
                raise SystemExit(f"[service] {op} {knob}: rel err {err:.3e}")
    # every launch belongs to a bucket the service executed
    expected = {k: 0 for k in KERNELS}
    knobs, spans = {}, {}
    for key, (n_batches, exec_s) in buckets1.items():
        _be, op, _bytes, dims = key
        knob = rt.peek(op, dims, 4, "hopper").dict
        knobs[op] = _knob_str(op, knob)
        shapes = [[dims[0], dims[0]]] if op in ("symm", "trmm", "trsm") \
            else [[dims[0], dims[1]]]
        n0, exec0 = buckets0.get(key, (0, 0.0))
        n_batches -= n0
        spans[op] = 1e3 * (exec_s - exec0) / max(1, n_batches)
        for kernel, count in _expected_launches(op, knob, shapes).items():
            expected[kernel] += count * n_batches
    completed = st.completed - st0.completed
    failed = st.failed - st0.failed
    n_batches = st.batches - st0.batches
    return {"requests": len(flat) * SERVICE_WINDOWS, "completed": completed,
            "failed": failed, "batches": n_batches,
            "mean_batch": (completed + failed) / max(1, n_batches),
            "launches": launches, "expected_launches": expected,
            "knobs": knobs, "max_rel_err": worst, "bucket_ms": spans,
            "window_requests": len(flat),
            "service_s": service_s, "single_s": single_s,
            "mean_bucket_ms": 1e3 * (st.exec_sum - st0.exec_sum)
            / max(1, completed),
            "model_evals": after.model_evals - before.model_evals,
            "default_calls": after.default_calls - before.default_calls,
            "eval_failures": after.eval_failures - before.eval_failures}


# -- phase 3 ----------------------------------------------------------------

def check_gemm(torch, rand) -> None:
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ops
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
    print(f"[kernel:gemm] {checks} checks over {len(space)} tiles: max rel "
          f"err {worst:.3e} (< {F32_TOL}), max abs err vs plain "
          f"{worst_abs:.3e}, stacked == per-item bit for bit; TF32-rounded "
          f"inputs: least rel err {tf32_least:.3e} (> {F32_TOL})", flush=True)
    # a yardstick only: the library's product with TF32 allowed
    a, b = rand(256, 512), rand(512, 384)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lib_tf32 = _rel_err(torch.matmul(a, b), a.double() @ b.double())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[kernel:gemm] torch.matmul with TF32 allowed at (256,512,384): "
          f"rel err {lib_tf32:.3e}", flush=True)


def check_2d_ops(torch, rand) -> None:
    """symm, syrk/syr2k, trmm and trsm under every candidate of their
    spaces."""
    from repro_torch.backends import conformance as C
    from repro_torch.kernels import ops
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    for op in ("symm", "syrk", "syr2k", "trmm", "trsm"):
        space = ops.knob_space_for(op)
        dims_list = (*C.RAGGED_DIMS[op], ALIGNED_2D)
        worst, checks = 0.0, 0
        for knob in space:
            for dims in dims_list:
                for stacked, with_c in ((0, False), (0, True),
                                        (STACK, True)):
                    res = C.check_backend_op(
                        "hopper", op, dims=dims, tol=F32_TOL, knob=knob,
                        stacked=stacked, with_c=with_c, alpha=0.5, beta=2.0,
                        seed=checks)
                    checks += 1
                    if not res.ok:
                        raise SystemExit(f"[kernel:{op}] {res.line()}")
                    worst = max(worst, res.rel_err)
            # the stack equals its items bit for bit
            x = [rand(STACK, *s) for s in _shapes_2d(op, (129, 257))]
            if op == "trsm":
                x[0].diagonal(dim1=-2, dim2=-1).add_(129)
            kw = {"alpha": 0.5} if op in ("trmm", "trsm") \
                else {"alpha": 0.5, "beta": 2.0}
            if op not in ("trmm", "trsm"):
                x.append(rand(STACK, 129, 257 if op == "symm" else 129))
            got = ops.HOPPER_OPS[op](*x, knob=knob, **kw)
            for i in range(STACK):
                one = ops.HOPPER_OPS[op](*(t[i] for t in x), knob=knob, **kw)
                if not torch.equal(one, got[i]):
                    raise SystemExit(f"[kernel:{op}] {knob}: stacked item "
                                     f"{i} differs from per-item")
        torch.cuda.synchronize()
        print(f"[kernel:{op}] {checks} conformance checks over {len(space)} "
              f"candidates x {dims_list} (single, C, stack of {STACK}): max "
              f"rel err vs float64 {worst:.3e} (< {F32_TOL}); stacked == "
              f"per-item bit for bit", flush=True)
    # tri_packed == tri, bit for bit
    pairs = 0
    for op, fn in (("syrk", K.syrk), ("syr2k", K.syr2k)):
        for n, k in (*C.RAGGED_DIMS[op], ALIGNED_2D):
            x = [rand(n, k) for _ in range(1 if op == "syrk" else 2)]
            c = rand(n, n)
            for bm, bk in sorted(K.TILES):
                for cc, beta in ((None, 0.0), (c, 2.0)):
                    tri = fn(*x, cc, bm=bm, bk=bk, alpha=0.5, beta=beta,
                             variant="tri")
                    packed = fn(*x, cc, bm=bm, bk=bk, alpha=0.5, beta=beta,
                                variant="tri_packed")
                    pairs += 1
                    if not torch.equal(tri.view(torch.int32),
                                       packed.view(torch.int32)):
                        raise SystemExit(f"[kernel:{op}] tri_packed != tri "
                                         f"at {(n, k)} tile {bm}x{bk}")
    for m, n in (*C.RAGGED_DIMS["trmm"], ALIGNED_2D):
        a, b = rand(m, m), rand(m, n)
        for bm, bn in sorted(TM.TILES):
            tri = TM.trmm(a, b, bm=bm, bn=bn, alpha=0.5, variant="tri")
            packed = TM.trmm(a, b, bm=bm, bn=bn, alpha=0.5,
                             variant="tri_packed")
            pairs += 1
            if not torch.equal(tri.view(torch.int32),
                               packed.view(torch.int32)):
                raise SystemExit(f"[kernel:trmm] tri_packed != tri at "
                                 f"{(m, n)} tile {bm}x{bn}")
    torch.cuda.synchronize()
    print(f"[kernel:rank_k,trmm] tri_packed == tri bit for bit in {pairs} "
          f"pairs (syrk, syr2k with and without C; trmm)", flush=True)


#: the ragged and one-row dims of the reference's zero-copy tests
#: (tests/test_zero_copy_kernels.py RAGGED and its one-row dims)
CONTRACT_DIMS = {"gemm": ((129, 65, 257), (1, 300, 384)),
                 "symm": ((129, 257), (1, 384)),
                 "syrk": ((129, 65), (1, 384)),
                 "syr2k": ((129, 65), (1, 384)),
                 "trmm": ((129, 257), (1, 384)),
                 "trsm": ((129, 257),)}


def check_contracts(torch, rand) -> list[str]:
    """The zero-copy and packed-grid contracts on the card: ``run_op`` ==
    the padded run bit for bit (trsm within 1e-5), no copy op on the
    dispatch path (trsm: no pad), every recorded grid equal to its formula
    and ``tri_packed`` launching fewer blocks than ``tri``.  Returns the
    ``packed_slot_ratio`` lines."""
    from repro_torch.kernels import introspect as I
    from repro_torch.kernels import ops
    from repro_torch.kernels.padded_ref import block_knob, padded_run
    checks = 0
    for op, dims_list in CONTRACT_DIMS.items():
        variants = ("full", "tri", "tri_packed") \
            if op in ("syrk", "syr2k", "trmm") else ("full",)
        for dims in dims_list:
            if op == "gemm":
                xs = (rand(dims[0], dims[1]), rand(dims[1], dims[2]))
            elif op in ("symm", "trmm", "trsm"):
                xs = (rand(dims[0], dims[0]), rand(*dims))
                if op == "trsm":
                    xs[0].diagonal().add_(dims[0])
            else:
                xs = tuple(rand(*dims) for _ in range(1 + (op == "syr2k")))
            for var in variants:
                knob = block_knob(op, 128, var)
                counts = I.copy_op_counts(ops.run_op, op, xs, knob=knob)
                with I.capture_launches() as launched:
                    got = ops.run_op(op, xs, knob=knob)
                want = padded_run(op, xs, variant=var)
                checks += 1
                if op == "trsm":
                    if "constant_pad_nd" in counts:
                        raise SystemExit(f"[contract] trsm pads: {counts}")
                    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                        raise SystemExit("[contract] trsm masked != padded "
                                         "within 1e-5")
                    continue
                if counts:
                    raise SystemExit(f"[contract] {op} {var} at {dims}: copy "
                                     f"ops on the dispatch path {counts}")
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise SystemExit(f"[contract] {op} {var} at {dims}: "
                                     f"masked != padded bit for bit")
                packed = var == "tri_packed"
                grid = (I.packed_grid_for if packed else I.full_grid_for)(
                    op, dims, 128, 128)
                if launched != [(kernel_of(op, {"variant": var}), grid)]:
                    raise SystemExit(f"[contract] {op} {var} at {dims}: "
                                     f"launched {launched}, formula {grid}")
    torch.cuda.synchronize()
    print(f"[contract] {checks} runs: masked == padded bit for bit (trsm "
          f"within 1e-5), no copy op in run_op's dispatch (trsm: no pad), "
          f"recorded grids == formulas", flush=True)
    lines = []
    for op, dims, bm, bn in (("syrk", (D_MODEL, D_FF), 128, 64),
                             ("syrk", (D_FF, D_MODEL), 128, 64),
                             ("syr2k", (D_MODEL, D_MODEL), 128, 64),
                             ("trmm", (D_MODEL, D_FF), 128, 128),
                             ("syrk", STACKED_2D[1:], 128, 64),
                             ("trmm", STACKED_2D[1:], 128, 128)):
        full = I.grid_slots(I.full_grid_for(op, dims, bm, bn))
        packed = I.grid_slots(I.packed_grid_for(op, dims, bm, bn))
        if not packed < full:
            raise SystemExit(f"[contract] {op} tri_packed launches {packed} "
                             f"blocks, tri {full}")
        lines.append(f"{op} {dims} bm={bm}: tri {full} blocks, tri_packed "
                     f"{packed}, packed_slot_ratio "
                     f"{I.packed_slot_ratio(op, dims, bm, bn):.4f}")
    # and on a launch: the recorded grids of the stacked calls
    for op, shapes in (("syrk", [STACKED_2D]),
                       ("trmm", [STACKED_2D, STACKED_2D])):
        xs = tuple(rand(*s) for s in shapes)
        for var in ("tri", "tri_packed"):
            knob = block_knob(op, 128, var)
            with I.capture_launches() as launched:
                ops.run_op(op, xs, knob=knob)
            grid = (I.packed_grid_for if var == "tri_packed"
                    else I.full_grid_for)(op, STACKED_2D[1:], 128, 128,
                                          batch=STACKED_2D[0])
            if launched != [(kernel_of(op, {"variant": var}), grid)]:
                raise SystemExit(f"[contract] {op} {var}: launched "
                                 f"{launched}, formula {grid}")
    torch.cuda.synchronize()
    for line in lines:
        print(f"[contract] {line}", flush=True)
    return lines


def _shapes_2d(op: str, dims) -> list:
    a, b = dims
    if op in ("symm", "trmm", "trsm"):
        return [(a, a), (a, b)]
    return [(a, b)] * (1 if op == "syrk" else 2)


# -- phase 6 ----------------------------------------------------------------

def _kernel_fn(op: str, kd: dict, kw: dict):
    """The kernel of ``op`` under the knob ``kd``, called on operands."""
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import symm as S
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    from repro_torch.kernels import trsm as T
    if op == "gemm":
        return lambda x, y: G.gemm(x, y, bm=kd["bm"], bk=kd["bk"],
                                   bn=kd["bn"])
    if op == "symm":
        return lambda x, y: S.symm(x, y, bm=kd["bm"], bn=kd["bn"])
    if op == "trmm":
        return lambda x, y: TM.trmm(x, y, bm=kd["bm"], bn=kd["bn"],
                                    variant=kd["variant"])
    if op == "trsm":
        return lambda x, y: T.trsm(x, y, bm=kd["bm"], bn=kd["bn"])
    fn = K.syrk if op == "syrk" else K.syr2k
    return lambda *xs: fn(*xs, bm=kd["bm"], bk=kd["bn"],
                          variant=kd["variant"], **kw)


def _library_fn(torch, op: str, kw: dict, shapes):
    """One PyTorch call (or two matmuls for syr2k) computing the same
    function, and the operand transform it needs outside the timing."""
    if op == "gemm":
        return torch.matmul, None
    if op == "symm":
        from repro_torch.kernels.ref import sym_lower
        return torch.matmul, lambda xs: [sym_lower(xs[0]), xs[1]]
    if op == "trmm":
        return torch.matmul, lambda xs: [torch.tril(xs[0]), xs[1]]
    if op == "trsm":
        return (lambda a, b: torch.linalg.solve_triangular(a, b,
                                                           upper=False),
                None)
    if op == "syrk":
        if len(shapes) == 2:
            return (lambda a, c: torch.addmm(c, a, a.mT, beta=kw["beta"],
                                             alpha=kw["alpha"]), None)
        return (lambda a: torch.matmul(a, a.mT)), None
    return (lambda a, b: torch.matmul(a, b.mT) + torch.matmul(b, a.mT)), None


def time_rows(torch, card: str, rows: list[dict]) -> dict:
    """Phase 6: time every served call; returns per-kernel totals."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "ops_bound_ms": 0.0}
              for name in KERNELS}
    per_op = {}
    for row in rows:
        op, kw, shapes = row["op"], row["kw"], row["shapes"]
        per_set = 4 * sum(math.prod(s) for s in shapes)
        sets = [make_operands(torch, gen, op, shapes)
                for _ in range(max(1, math.ceil(120e6 / per_set)))]
        big = per_set > 200e6
        ms = _time_ms(torch, _kernel_fn(op, row["knob"], kw), sets,
                      iters=3 if big else 10)
        plain = plain_of(op, row["knob"])
        plain_ms = _time_ms(torch, lambda *xs: plain(*xs, **kw), sets,
                            iters=3 if big else 10)
        lib, prep = _library_fn(torch, op, kw, shapes)
        lib_sets = [prep(s) for s in sets] if prep else sets
        library_ms = _time_ms(torch, lib, lib_sets, iters=3 if big else 10)
        del lib_sets
        bound_ms, bound_by = _bound(op, shapes, kw)
        t = totals[row["kernel"]]
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["library_ms"] += library_ms
        t["bound_ms"] += bound_ms
        if bound_by == "operations":
            t["ops_bound_ms"] += bound_ms
        line = (f"[times] [{card}] {row['label']}: {op} knob "
                f"{_knob_str(op, row['knob'])} {ms:.4f} ms")
        if row.get("pinned"):
            print(f"{line} (pinned) | plain {plain_ms:.4f} ms | library "
                  f"{library_ms:.4f} ms | bound {bound_ms:.4f} ms "
                  f"({bound_by}) | launches {row['launches']}", flush=True)
            del sets
            continue
        default = ops.default_knob(op).dict
        default_ms = _time_ms(torch, _kernel_fn(op, default, kw), sets,
                              iters=3 if big else 10)
        # every candidate of the space: the best the knob could have done
        best_ms, best = min(
            ((_time_ms(torch, _kernel_fn(op, k.dict, kw), sets,
                       iters=1 if big else 3), k.dict)
             for k in ops.knob_space_for(op)), key=lambda v: v[0])
        del sets
        acc = per_op.setdefault(op, {"ms": 0.0, "default_ms": 0.0,
                                     "best_ms": 0.0})
        acc["ms"] += ms
        acc["default_ms"] += default_ms
        acc["best_ms"] += best_ms
        print(f"{line} | default {_knob_str(op, default)} "
              f"{default_ms:.4f} ms | tuned/default {default_ms / ms:.3f}x "
              f"| best {_knob_str(op, best)} {best_ms:.4f} ms (best/default "
              f"{default_ms / best_ms:.3f}x) | plain {plain_ms:.4f} ms | "
              f"library {library_ms:.4f} ms | bound {bound_ms:.4f} ms "
              f"({bound_by}) | launches {row['launches']}", flush=True)
    for op, acc in per_op.items():
        print(f"[times] [{card}] {op} served calls: tuned {acc['ms']:.4f} "
              f"ms, default {acc['default_ms']:.4f} ms "
              f"({acc['default_ms'] / acc['ms']:.3f}x), best knobs "
              f"{acc['best_ms']:.4f} ms", flush=True)
    return totals


def _knob_str(op: str, kd: dict) -> str:
    """A GEMM tile as bm x bk x bn; a 2-dim knob as bm x bn (its bk only
    repeats bm), with the variant of syrk/syr2k/trmm."""
    if op == "gemm":
        return f"{kd['bm']}x{kd['bk']}x{kd['bn']}"
    if op in ("syrk", "syr2k", "trmm"):
        return f"{kd['bm']}x{kd['bn']}/{kd['variant']}"
    return f"{kd['bm']}x{kd['bn']}"


# -- the main run -------------------------------------------------------------

def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, introspect, ops
    from repro_torch.launch import calibrate

    if tuple(KERNELS) != introspect.KERNELS:
        raise SystemExit(f"chip_smoke.KERNELS {tuple(KERNELS)} differs from "
                         f"the recorder's {introspect.KERNELS}")
    repeats = 0
    if argv:
        if len(argv) != 2 or argv[0] != "--repeat-checks":
            raise SystemExit("usage: chip_smoke.py [--repeat-checks N]")
        repeats = int(argv[1])

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    # within the runner's 1200 s: a stuck phase prints every thread's stack
    faulthandler.dump_traceback_later(1150, exit=True)

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
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. every kernel against a float64 oracle and its plain version
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if repeats:
        for i in range(repeats):
            faulthandler.dump_traceback_later(120, exit=True)
            t0 = time.perf_counter()
            check_gemm(torch, rand)
            check_2d_ops(torch, rand)
            check_contracts(torch, rand)
            print(f"[repeat {i + 1}/{repeats}] clean in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0
    check_gemm(torch, rand)
    check_2d_ops(torch, rand)
    check_contracts(torch, rand)
    print(f"[kernel] {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. install on the card, 5. serve from a fresh process
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        for op in ops.HOPPER_OPS:
            calibrate.main(["--out", str(tmp), "--ops", op, "--samples",
                            str(CALIBRATE_SAMPLES[op]), *CALIBRATE_ARGS])
        reports = json.loads((tmp / "calibration_report.json").read_text())
        for report in reports:
            print(f"[install] {report['artifact']}: best "
                  f"{report['best_model']}, {report['n_samples']} dims x "
                  f"{report['n_knobs']} knobs, gather "
                  f"{report['gather_seconds']:.1f} s, total "
                  f"{report['wall_seconds']:.1f} s", flush=True)
            for row in report["models"]:
                print(f"[install:{report['op']}] {row['name']}: estimated "
                      f"mean speedup {row['estimated_mean_speedup']:.3f}, "
                      f"ideal {row['ideal_mean_speedup']:.3f}, normalized "
                      f"rmse {row['normalized_rmse']:.3f}, eval "
                      f"{row['eval_time_us']:.1f} us")
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.serve_main("
             f"{str(tmp / 'models')!r})"],
            cwd=ROOT, capture_output=True, text=True,
            timeout=SERVE_TIMEOUT_S)
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
        print(f"[serve] {row['label']}: knob "
              f"{_knob_str(row['op'], row['knob'])} "
              f"launches {row['launches']} rel err vs plain "
              f"{row['rel_err']:.2e}")
    print(f"[serve] model_evals {served['model_evals']} default_calls "
          f"{served['default_calls']} eval_failures "
          f"{served['eval_failures']} calls {served['calls']} for "
          f"{served['served']} served calls; launches {served['launches']}",
          flush=True)
    if served["model_evals"] <= 0 or served["default_calls"] != 0 \
            or served["eval_failures"] != 0:
        raise SystemExit("[serve] decisions did not come from the model")
    for row in served["rows"]:
        if row["launches"] != row["expected_launches"]:
            raise SystemExit(f"[serve] {row['label']}: launches "
                             f"{row['launches']}, expected "
                             f"{row['expected_launches']}")
        if not row["rel_err"] < F32_TOL:
            raise SystemExit(f"[serve] {row['label']}: rel err "
                             f"{row['rel_err']:.3e}")
    unlaunched = [k for k in KERNELS if served["launches"][k] < 1]
    if unlaunched:
        raise SystemExit(f"[serve] the main paths never launched "
                         f"{unlaunched}")
    svc = served["service"]
    print(f"[service] [{card}] {svc['requests']} requests in "
          f"{SERVICE_WINDOWS} windows of {svc['window_requests']} from "
          f"{SERVICE_THREADS} threads (max_batch {SERVICE_MAX_BATCH}, "
          f"{SERVICE_WORKERS} workers, a CUDA stream each): completed "
          f"{svc['completed']}, failed {svc['failed']}, {svc['batches']} "
          f"buckets, mean batch {svc['mean_batch']:.3f}, mean bucket span "
          f"{svc['mean_bucket_ms']:.4f} ms (CUDA events on the worker's "
          f"stream); knobs {svc['knobs']}; max rel err vs plain "
          f"{svc['max_rel_err']:.2e}", flush=True)
    print(f"[service] [{card}] mean bucket span per op (ms): "
          + ", ".join(f"{op} {ms:.4f}" for op, ms in
                      sorted(svc["bucket_ms"].items())), flush=True)
    rates = {}
    for name, key in (("through the service", "service_s"),
                      ("as one run_op each", "single_s")):
        per_window = sorted(svc["window_requests"] / s for s in svc[key])
        rates[key] = per_window[len(per_window) // 2]
        print(f"[service] [{card}] requests/s {name}: median "
              f"{rates[key]:.1f}, min {per_window[0]:.1f}, max "
              f"{per_window[-1]:.1f} over {len(per_window)} windows "
              f"({' '.join(f'{r:.1f}' for r in per_window)})", flush=True)
    print(f"[service] [{card}] service / single (medians) "
          f"{rates['service_s'] / rates['single_s']:.3f}x", flush=True)
    print(f"[service] launches {svc['launches']} (expected from the buckets "
          f"{svc['expected_launches']}); model_evals {svc['model_evals']} "
          f"default_calls {svc['default_calls']} eval_failures "
          f"{svc['eval_failures']}", flush=True)
    if svc["completed"] != svc["requests"] or svc["failed"] \
            or not svc["mean_batch"] > 1.0:
        raise SystemExit("[service] lost or failed requests, or no batching")
    if svc["launches"] != svc["expected_launches"]:
        raise SystemExit("[service] launches differ from the buckets")
    if svc["default_calls"] or svc["eval_failures"]:
        raise SystemExit("[service] decisions did not come from the model")

    # 6. times on the main paths' shapes
    totals = time_rows(torch, card, served["rows"])
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        t = totals[name]
        errs = [r["abs_err"] for r in served["rows"]
                if (r["op"] == "trsm" if name == "trsm"
                    else r["kernel"] == name and r["op"] != "trsm")]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": max(errs), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if 2 * t["ops_bound_ms"]
                         >= t["bound_ms"] else "bytes"),
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
