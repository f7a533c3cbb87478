"""The port's install → persist → fresh runtime → run_op loop on the CPU, its
artifact encoding, its refusal to fall back, its timer, and its PyTorch
oracles against the reference package's."""

import json

import numpy as np
import pytest
import torch

import repro.kernels.ref as ref_oracles
from repro_torch.backends import (HopperBackend, get_backend, resolve_backend)
from repro_torch.core import AdsalaRuntime, ModelRegistry
from repro_torch.core.registry import pack_state, unpack_state
from repro_torch.core.timing import time_callable
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_oracles
from repro_torch.launch import calibrate


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """A tiny calibration on the CPU: the plain version's timings mean
    nothing about the card, but drive the whole install flow."""
    out = tmp_path_factory.mktemp("cal")
    calibrate.main(["--out", str(out), "--device", "cpu", "--samples", "12",
                    "--dim-lo", "8", "--dim-hi", "96", "--footprint-mb", "1",
                    "--sizes", "64,128", "--tune-trials", "1",
                    "--candidates", "LinearRegression,DecisionTree"])
    return out


def test_calibrate_writes_hopper_artifact(installed):
    # --ops defaults to every op the hopper backend lists
    models = installed / "models"
    report = json.loads((installed / "calibration_report.json").read_text())
    assert [(r["backend"], r["op"], r["prec"], r["device"])
            for r in report] == [("hopper", op, "s", "cpu")
                                 for op in ops.HOPPER_OPS]
    # --sizes 64,128: 2x3x2 GEMM tiles, 2x2 symm/trsm output tiles, 2x2
    # trmm output tiles x 3 variants, and 2 square tiles x 3 contraction
    # blocks x 3 variants for syrk/syr2k
    assert {r["op"]: r["n_knobs"] for r in report} == \
        {"gemm": 12, "symm": 4, "syrk": 18, "syr2k": 18, "trmm": 12,
         "trsm": 4}
    for op in ops.HOPPER_OPS:
        assert (models / f"hopper__{op}_b4.adsala").exists()
        assert (installed / "datasets" / f"hopper__{op}_s.npz").exists()


def test_fresh_runtime_serves_model_chosen_knob(installed):
    rt = AdsalaRuntime()
    assert ModelRegistry(installed / "models").load_into(rt) == \
        len(ops.HOPPER_OPS)
    assert all(rt.has(op, 4, "hopper") for op in ops.HOPPER_OPS)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 40, 24)).astype(np.float32)
    b = rng.standard_normal((24, 56)).astype(np.float32)
    out = ops.run_op("gemm", (a, b), runtime=rt, device="cpu")
    st = rt.stats
    assert (st.model_evals, st.cache_hits, st.default_calls) == (1, 0, 0)
    knob = rt.peek("gemm", (40, 24, 56), 4, "hopper")
    assert knob in rt.subroutine("gemm", 4, "hopper").knob_space.candidates
    again = ops.run_op("gemm", (a, b), runtime=rt, device="cpu")
    st = rt.stats
    assert (st.model_evals, st.cache_hits, st.default_calls) == (1, 1, 0)
    assert torch.equal(out, again)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5, atol=1e-5)


def test_artifact_state_round_trips_bit_for_bit(installed):
    path = installed / "models" / "hopper__gemm_b4.adsala"
    state = unpack_state(path.read_bytes())
    assert pack_state(state) == path.read_bytes()
    weird = {"a": np.array([np.nan, np.inf, -0.0, 1e-300]),
             "i": np.arange(6, dtype=np.int64).reshape(2, 3),
             "nested": [{"x": np.float32(1.5)}, None, True]}
    back = unpack_state(pack_state(weird))
    assert back["a"].dtype == np.float64
    assert back["a"].tobytes() == weird["a"].tobytes()
    assert np.array_equal(back["i"], weird["i"])
    assert back["nested"] == [{"x": 1.5}, None, True]


def test_hopper_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.ones((4, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.run_op("gemm", (a, a))
    with pytest.raises(RuntimeError):
        resolve_backend("hopper")
    assert resolve_backend("hopper", device="cpu").device.type == "cpu"


def test_unregistered_backend_raises_and_never_resolves_to_ref():
    with pytest.raises(KeyError):
        resolve_backend("pallas")
    with pytest.raises(KeyError):
        ops.run_op("gemm", (np.ones((2, 2), np.float32),) * 2,
                   backend="nope", device="cpu")


def test_backend_binding_and_dtypes():
    be = get_backend("hopper")
    assert isinstance(be, HopperBackend) and be.device.type == "cuda"
    cpu = be.on("cpu")
    assert cpu is not be and cpu.device.type == "cpu" and be.on("cuda") is be
    assert be.supports_dtype(torch.float32)
    assert be.supports_dtype(np.float32)
    assert not be.supports_dtype(torch.float64)
    assert be.ops() == ("gemm", "symm", "syrk", "syr2k", "trmm", "trsm")
    with pytest.raises(ValueError, match="float64"):
        calibrate.calibrate_one("gemm", "d", None, backend="hopper",
                                samples=2, dim_lo=8, dim_hi=16,
                                footprint_mb=1, sizes=None, tune_trials=1,
                                seed=0, device="cpu")


def test_calibration_operands_are_seeded_on_the_device():
    be = get_backend("hopper").on("cpu")
    x = be.make_operands("gemm", (5, 7, 3), seed=4)
    y = be.make_operands("gemm", (5, 7, 3), seed=4)
    assert [t.shape for t in x] == [(5, 7), (7, 3)]
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert x[0].device.type == "cpu" and x[0].dtype == torch.float32
    with pytest.raises(ValueError, match="herk"):
        be.make_operands("herk", (5, 3))


def test_timer_propagates_failures():
    def boom():
        raise ZeroDivisionError
    with pytest.raises(ZeroDivisionError):
        time_callable(boom, device="cpu")
    assert time_callable(lambda: None, device="cpu", repeats=2) >= 0.0


def _oracle_operands(op, seed=0):
    rng = np.random.default_rng(seed)
    m, n = 24, 16

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    a = rand(m, m) + m * np.eye(m, dtype=np.float32)
    return {"gemm": (rand(m, 20), rand(20, n), rand(m, n)),
            "symm": (a, rand(m, n), rand(m, n)),
            "syrk": (rand(m, 20), rand(m, m)),
            "syr2k": (rand(m, 20), rand(m, 20), rand(m, m)),
            "trmm": (a, rand(m, n)),
            "trsm": (a, rand(m, n))}[op]


@pytest.mark.parametrize("op", ("gemm", "symm", "syrk", "syr2k", "trmm",
                                "trsm"))
def test_torch_oracles_match_reference_oracles(op):
    operands = _oracle_operands(op)
    kw = {"alpha": 0.75} if op in ("trmm", "trsm") else \
        {"alpha": 0.75, "beta": 1.25}
    want = np.asarray(ref_oracles.REFS[op](*operands, **kw), np.float64)
    got = port_oracles.REFS[op](*map(torch.from_numpy, operands), **kw)
    assert got.dtype == torch.float32
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert err < 5e-4
    via_backend = resolve_backend("ref", device="cpu").execute(op, operands,
                                                               **kw)
    assert torch.equal(via_backend, got)
