"""Phases 6c, 6d and 8a-8c of ``chip_smoke.py`` alone, for two or more
checkouts of the port on one card, so that their serving and training
times can be compared with nothing else on the host.

Each tree runs its own ``chip_smoke.py`` from its own root: its kernels
are built first (untimed), then zamba2-1.2b (6c) and rwkv6-1.6b (6d) are
served and the trainer's phases 8a-8c run, each in a fresh process as
``chip_smoke.py`` runs them, and each phase's lines are printed as
``chip_smoke.py`` prints them, under an ``[ab] <tree> run <k>`` header.
Phase 4's install and the prewarm (which the model phases read) are made
once, from the first tree, and shared, so that every tree serves from the
same decisions.  Give the trees in the order to run them, a tree as often
as it should run (parent, change, change, parent).

Usage (on a machine with the card):
    python3 scripts/torch_phase_ab.py runs/ab/parent . . runs/ab/parent
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

INSTALL = """
import json, sys
from pathlib import Path
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.kernels import ops
from repro_torch.launch import calibrate
out = Path(sys.argv[1])
card = chip_smoke._sh("nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader").splitlines()[0]
for op in ops.HOPPER_OPS:
    calibrate.main(["--out", str(out), "--ops", op, "--samples",
                    str(chip_smoke.CALIBRATE_SAMPLES[op]),
                    *chip_smoke.CALIBRATE_ARGS])
chip_smoke.prewarm_phase(card, out)
"""

BUILD = """
import concurrent.futures, sys
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.kernels import _build
with concurrent.futures.ThreadPoolExecutor(len(chip_smoke.KERNEL_SOURCES)) as pool:
    list(pool.map(_build.build, chip_smoke.KERNEL_SOURCES))
"""

ARCHS = ("zamba2-1.2b", "rwkv6-1.6b")


def _run(tree: Path, code: str, *args: str, timeout: float,
         env: dict | None = None) -> str:
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tree,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"[ab] {tree}: a process failed "
                         f"({proc.returncode}):\n{proc.stdout[-4000:]}")
    return proc.stdout


def _smoke(tree: Path):
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{abs(hash(str(tree)))}", tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trees", nargs="+", type=Path)
    args = p.parse_args(argv)
    trees = [t.resolve() for t in args.trees]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"[ab] {card}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase_ab_"))
    t0 = time.perf_counter()
    _run(trees[0], INSTALL, str(tmp), timeout=600)
    print(f"[ab] install and prewarm from {trees[0]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for tree in dict.fromkeys(trees):
        t0 = time.perf_counter()
        _run(tree, BUILD, timeout=600)
        print(f"[ab] {tree}: kernels built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs: dict[Path, int] = {}
    for tree in trees:
        runs[tree] = runs.get(tree, 0) + 1
        smoke = _smoke(tree)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            filter(None, (str(tree / "src"), os.environ.get("PYTHONPATH"))))}
        print(f"[ab] {tree} run {runs[tree]}", flush=True)
        for arch in ARCHS:
            tag, *_, timeout = smoke.MODEL_PHASES[arch]
            t0 = time.perf_counter()
            out = _run(tree, f"import chip_smoke; chip_smoke.model_main("
                             f"{str(tmp / 'models')!r}, {arch!r})",
                       timeout=timeout)
            res = json.loads(next(line for line in out.splitlines()
                                  if line.startswith("MODEL_RESULT "))
                             .split(" ", 1)[1])
            smoke.report_model(card, arch, res)
            print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s",
                  flush=True)
        t0 = time.perf_counter()
        out = _run(tree, f"import chip_smoke; chip_smoke.train_main("
                         f"{str(tmp / 'train')!r})",
                   timeout=smoke.TRAIN_TIMEOUT_S, env=env)
        for line in out.splitlines():
            if line.startswith("[train"):
                print(line)
        print(f"[train] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
