"""The PyTorch port stands alone: importing it loads neither JAX, nor the
reference package ``repro``, nor msgpack, and no port source imports them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(from\s+(repro|jax|msgpack)(\.|\s)|import\s+(repro|jax|msgpack)"
    r"(\.|\s|,|$))", re.MULTILINE)


def test_import_loads_no_jax_repro_or_msgpack():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.kernels.ops, "
        "repro_torch.kernels.symm, repro_torch.kernels.syrk, "
        "repro_torch.kernels.trsm, repro_torch.kernels.trmm, "
        "repro_torch.kernels.introspect, repro_torch.kernels.padded_ref, "
        "repro_torch.backends.conformance, repro_torch.launch.calibrate, "
        "repro_torch.serving, repro_torch.serving.service, "
        "repro_torch.configs, repro_torch.models, "
        "repro_torch.launch.serve, repro_torch.core.oracle, "
        "repro_torch.roofline, repro_torch.roofline.harvest, "
        "repro_torch.roofline.costing, repro_torch.serving.retune, "
        "repro_torch.serving.fleet, repro_torch.distributed, "
        "repro_torch.distributed.elastic, repro_torch.optim, "
        "repro_torch.data, repro_torch.checkpoint, "
        "repro_torch.launch.train, "
        "repro_torch.distributed.fault_tolerance, "
        "repro_torch.models.sharding, repro_torch.launch.mesh, "
        "repro_torch.launch.specs, repro_torch.distributed.pipeline, "
        "repro_torch.distributed.world, repro_torch.launch.dryrun, "
        "repro_torch.roofline.analysis, repro_torch.roofline.collectives, "
        "repro_torch.roofline.counting, repro_torch.backends.cpu, "
        "repro_torch.kernels.cpu_blocked\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'msgpack') or m.startswith(('jax.', 'repro.', 'msgpack.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC.parent,
                          env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_source_imports_nothing_of_repro(path):
    text = path.read_text()
    assert "import repro." not in text
    assert _FORBIDDEN.search(text) is None, _FORBIDDEN.search(text).group(0)


def test_static_check_catches_reference_imports():
    for line in ("from repro.core import knobs", "import repro.kernels",
                 "import jax", "from jax import numpy", "import msgpack"):
        assert _FORBIDDEN.search(line), line
    for line in ("from repro_torch.core import knobs", "import repro_torch",
                 "import numpy as np"):
        assert not _FORBIDDEN.search(line), line


def test_the_scan_covers_the_serving_package():
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"serving/__init__.py", "serving/service.py", "serving/budget.py",
            "serving/faults.py", "kernels/trmm.py", "kernels/introspect.py",
            "kernels/padded_ref.py", "configs/base.py",
            "models/layers.py", "models/transformer.py",
            "models/moe.py", "models/mla.py",
            "launch/serve.py", "core/oracle.py", "roofline/harvest.py",
            "roofline/costing.py", "serving/retune.py", "serving/fleet.py",
            "distributed/elastic.py", "optim/adamw.py",
            "optim/compression.py", "data/pipeline.py",
            "checkpoint/checkpointer.py", "launch/train.py",
            "distributed/fault_tolerance.py", "models/sharding.py",
            "launch/mesh.py", "launch/specs.py", "distributed/pipeline.py",
            "distributed/world.py"} <= scanned


def test_chip_smoke_imports_nothing_of_repro():
    """The chip machine has no JAX: the smoke script imports only the port."""
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert _FORBIDDEN.search(text) is None, _FORBIDDEN.search(text).group(0)
    assert "import repro." not in text


def test_prewarm_script_imports_nothing_of_repro(tmp_path):
    """``scripts/torch_prewarm_model.py``, run to its end (the oracle timer
    on a smoke config), leaves no module of JAX, the reference package or
    msgpack loaded, and its source imports none."""
    script = SRC.parent / "scripts" / "torch_prewarm_model.py"
    text = script.read_text()
    assert _FORBIDDEN.search(text) is None and "import repro." not in text
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(script)!r}, '--arch', 'zamba2-1.2b', "
        f"'--smoke-config', '--registry', {str(tmp_path)!r}, '--batch', "
        "'1', '--seq', '8', '--n-samples', '12', '--tune-trials', '1', "
        "'--candidates', 'LinearRegression', '--timer', 'oracle']\n"
        "try:\n"
        "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'msgpack') or m.startswith(('jax.', 'repro.', 'msgpack.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC.parent,
                          env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "replay from persisted cache: 0 model evals" in proc.stdout
