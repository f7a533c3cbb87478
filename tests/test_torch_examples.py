"""The port-side examples (``examples/torch_*.py``) on the CPU at tiny
sizes: each runs through ``--device cpu`` (on the card by default) and
imports only the port."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_autotune_blas", "torch_serve_batched",
         "torch_train_lm")

#: the same scan as tests/test_torch_imports.py: no import of the reference
#: package, JAX or msgpack
_FORBIDDEN = re.compile(
    r"^\s*(from\s+(repro|jax|msgpack)(\.|\s)|import\s+(repro|jax|msgpack)"
    r"(\.|\s|,|$))", re.MULTILINE)


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    text = (EXAMPLES / f"{name}.py").read_text()
    assert _FORBIDDEN.search(text) is None, _FORBIDDEN.search(text).group(0)
    assert "from repro_torch" in text


def test_quickstart_installs_and_serves_on_the_cpu(capsys):
    sub = _load("torch_quickstart").main(["--device", "cpu", "--samples",
                                          "8", "--dim-hi", "96"])
    assert sub.op == "gemm" and sub.backend == "hopper"
    text = capsys.readouterr().out
    assert text.count("rel err vs float64") == 3
    assert "model_evals 3" in text and "default_calls 0" in text


@pytest.mark.parametrize("op", ("gemm", "syrk", "trsm"))
def test_autotune_blas_reports_held_out_speedups_on_the_cpu(op, capsys):
    sp = _load("torch_autotune_blas").main(
        ["--device", "cpu", "--op", op, "--samples", "8", "--dim-hi", "96",
         "--tests", "3"])
    assert sp.shape == (3,) and np.all(np.isfinite(sp)) and np.all(sp > 0)
    text = capsys.readouterr().out
    assert f"{op}: model selection" in text and "held-out speedup" in text


@pytest.mark.parametrize("arch", ("llama3-8b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b", "whisper-medium",
                                  "internvl2-76b"))
def test_serve_batched_serves_the_smoke_model_on_the_cpu(arch, capsys):
    out = _load("torch_serve_batched").main(["--arch", arch, "--device",
                                             "cpu"])
    assert out.shape == (4, 16) and out.dtype == np.int32
    assert "on cpu" in capsys.readouterr().out


def test_train_lm_reduces_the_loss_on_the_cpu(tmp_path, capsys):
    """The reduced llama3 trains 50 steps (the loss logged at steps 25 and
    50 must drop) and checkpoints at its last step."""
    out = _load("torch_train_lm").main(["--device", "cpu", "--steps", "50",
                                        "--ckpt", str(tmp_path)])
    assert out["final_step"] == 50
    assert [h["step"] for h in out["history"]] == [25, 50]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert "on cpu" in capsys.readouterr().out
    assert (tmp_path / "step_50" / "manifest").exists()
