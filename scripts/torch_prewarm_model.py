#!/usr/bin/env python
"""Ahead-of-time install + decision prewarm for a model served by the
PyTorch/CUDA port (``src/repro_torch``).

The offline half of "the first request pays zero model evaluations":

  1. **harvest** — run the routed model's programs on the meta device as
     ``ServeSession`` runs them (:func:`repro_torch.roofline.harvest.
     harvest_decision_keys`) for the requested (batch, seq) points; every
     GEMM decision-cache key the server will ask for falls out, with no
     weights and no arithmetic.
  2. **prune** — score the backend's knob space with the analytic H100
     oracle at each harvested call site and drop the candidates it proves
     dominated (:func:`repro_torch.roofline.costing.
     prune_dominated_candidates`, ``--prune-slack``; < 0 keeps them all).
  3. **install** — the ADSALA install of ``gemm`` over the pruned space,
     persisted through a :class:`~repro_torch.core.registry.ModelRegistry`.
     ``--timer wallclock`` (default) times the kernels on the backend's
     device, the card (``core/timing.py``'s CUDA events); ``--timer
     oracle`` is a rehearsal on any host against the analytic H100 oracle,
     nothing timed.  Each artifact records its timer (``timer`` in its
     state: ``"oracle"`` or ``"wallclock <device name>"``).
  4. **prewarm** — resolve every harvested key through ``select_many`` and
     persist the filled cache with ``save_decision_cache``; a serving
     process that ``load_into`` + ``load_decision_cache``-s this registry
     serves its first request from cache hits alone.

The script then checks step 4: a fresh runtime built from the registry
replays the harvested keys, and the script exits nonzero if any of them
costs a model evaluation.

    python scripts/torch_prewarm_model.py --arch llama3-8b \\
        --registry runs/adsala_prewarm          # on the card
    python scripts/torch_prewarm_model.py --arch llama3-8b --smoke-config \\
        --registry /tmp/adsala_models --timer oracle   # a CPU rehearsal
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _parse_ints(text: str) -> tuple[int, ...]:
    return tuple(int(v) for v in text.split(",") if v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3-8b",
                   help="architecture id (repro_torch.configs registry)")
    p.add_argument("--smoke-config", action="store_true",
                   help="use the reduced smoke config (CPU hosts)")
    p.add_argument("--layers", type=int, default=None,
                   help="serve this many layers of the config (a cut depth)")
    p.add_argument("--registry", required=True,
                   help="artifact directory to install into")
    p.add_argument("--batch", default="4",
                   help="comma list of serving batch sizes to harvest")
    p.add_argument("--seq", default="128",
                   help="comma list of prompt lengths to harvest")
    p.add_argument("--max-new", type=int, default=32,
                   help="new tokens a request generates (sizes the cache)")
    p.add_argument("--backend", default="hopper")
    p.add_argument("--device", default=None,
                   help="device the wallclock timer runs on (default: the "
                        "backend's own, the card)")
    p.add_argument("--timer", choices=("wallclock", "oracle"),
                   default="wallclock",
                   help="install calibration timer (wallclock = the "
                        "kernels timed on the device, the card; oracle = a "
                        "rehearsal against the analytic H100 model on any "
                        "host, nothing timed)")
    p.add_argument("--sizes", default="",
                   help="knob-space tile edges before pruning (default: "
                        "the backend's full space)")
    p.add_argument("--n-samples", type=int, default=60,
                   help="install-time Halton samples")
    p.add_argument("--footprint-mb", type=float, default=32.0,
                   help="largest operand footprint a sample may have")
    p.add_argument("--tune-trials", type=int, default=2)
    p.add_argument("--candidates", default="",
                   help="comma list of model families (default: all)")
    p.add_argument("--prune-slack", type=float, default=0.15,
                   help="oracle-dominance band; < 0 disables pruning")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from repro_torch.backends import get_backend, resolve_backend
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.oracle import oracle_time
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.core.runtime import AdsalaRuntime
    from repro_torch.core.tuner import install_subroutine
    from repro_torch.roofline.costing import prune_dominated_candidates
    from repro_torch.roofline.harvest import harvest_decision_keys

    cfg = (get_smoke_config if args.smoke_config else get_config)(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    # the oracle timer needs no device: the backend is looked up by name
    backend = (resolve_backend(args.backend, device=args.device)
               if args.timer == "wallclock" else get_backend(args.backend))
    registry = ModelRegistry(args.registry)
    runtime = AdsalaRuntime()

    # 1. harvest --------------------------------------------------------------
    t0 = time.perf_counter()
    keys: list[tuple] = []
    seen: set[tuple] = set()
    for B in _parse_ints(args.batch):
        for S in _parse_ints(args.seq):
            for key in harvest_decision_keys(cfg, batch_size=B, seq_len=S,
                                             max_new=args.max_new):
                key = (backend.name, *key[1:])
                if key not in seen:
                    seen.add(key)
                    keys.append(key)
    ops = sorted({k[1] for k in keys})
    dtype_bytes = sorted({k[2] for k in keys})
    print(f"[prewarm] {cfg.name}: harvested {len(keys)} decision keys "
          f"(ops={ops}, dtype_bytes={dtype_bytes}) "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    if not keys:
        print("[prewarm] nothing to install (model routes no GEMMs?)")
        return 1

    # 2+3. prune + install, one artifact per (op, dtype_bytes) ---------------
    sizes = _parse_ints(args.sizes) or None
    for op in ops:
        for db in dtype_bytes:
            dims_list = [k[3] for k in keys if k[1] == op and k[2] == db]
            if not dims_list:
                continue
            space = backend.knob_space(op, sizes=sizes)
            full = len(space)
            if args.prune_slack >= 0:
                space = prune_dominated_candidates(
                    op, space, dims_list, dtype_bytes=db,
                    slack=args.prune_slack)
            if args.timer == "oracle":
                def timer(dims, knob, _op=op, _db=db):
                    return oracle_time(_op, dims, knob, dtype_bytes=_db)
                timed_by = "oracle"
            else:
                timer = backend.timer_fn(op, getattr(torch, f"float{db * 8}"))
                timed_by = "wallclock " + (
                    torch.cuda.get_device_name(backend.device)
                    if backend.device.type == "cuda" else "cpu")
            lo = max(16, min(min(d) for d in dims_list))
            hi = max(max(d) for d in dims_list)
            kw = {}
            if args.candidates:
                kw["candidates"] = tuple(args.candidates.split(","))
            t1 = time.perf_counter()
            sub = install_subroutine(
                op, space, timer, n_samples=args.n_samples,
                dim_lo=lo, dim_hi=max(hi, lo + 1), dtype_bytes=db,
                max_footprint_bytes=int(args.footprint_mb * 2 ** 20),
                backend=backend.name, tune_trials=args.tune_trials, **kw)
            sub.timer = timed_by
            registry.save(sub)
            runtime.register(sub)
            print(f"[prewarm] installed {backend.name}/{op} b{db} "
                  f"({args.timer} timer): model={sub.model_name}, knobs "
                  f"{full}->{len(space)} (oracle-pruned), dims [{lo}, {hi}], "
                  f"{time.perf_counter() - t1:.1f}s", flush=True)

    # 4. prewarm the decision cache ------------------------------------------
    requests = [(op, dims, db, be) for (be, op, db, dims) in keys]
    runtime.select_many(requests, record_hits=False)
    path = registry.save_decision_cache(runtime)
    evals = runtime.stats.for_backend(backend.name).model_evals
    print(f"[prewarm] cached {len(requests)} decisions "
          f"({evals} model evals) -> {path}", flush=True)

    # verify: a fresh runtime hydrated from the registry replays every
    # harvested key as a cache hit — zero model evaluations
    fresh = AdsalaRuntime()
    registry.load_into(fresh, backend=backend.name)
    registry.load_decision_cache(fresh)
    for op, dims, db, be in requests:
        fresh.select_or_default(op, dims, db, backend.default_knob(op),
                                backend=be)
    st = fresh.stats.for_backend(backend.name)
    ok = st.model_evals == 0 and st.default_calls == 0
    print(f"[prewarm] replay from persisted cache: {st.model_evals} model "
          f"evals, {st.default_calls} default calls across {len(requests)} "
          f"keys ({'OK' if ok else 'FAIL'})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
