"""SYMM parity: the port's ``run_op("symm", ...)`` against the reference
package's Pallas SYMM (interpret mode) on the same seeded numpy inputs, both
held to a float64 oracle, and the kernel wrapper's checks.  The kernel
itself is tested on the card by ``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro_torch.backends.conformance import oracle
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import symm as S

#: float32 tolerance of the reference conformance harness: max relative
#: error against float64 (the port and the reference sum in other orders)
TOL = 5e-4

#: the reference's RAGGED_DIMS["symm"] (backends/conformance.py) + aligned
DIMS = ((129, 257), (1, 384), (300, 300), (256, 384))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _case(name, dims, seed=0):
    rng = np.random.default_rng(seed)
    m, n = dims

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if name == "plain":
        return (rand(m, m), rand(m, n)), {}
    if name == "beta":
        return (rand(m, m), rand(m, n), rand(m, n)), {"alpha": 0.5,
                                                      "beta": 2.0}
    if name == "stack":
        return (rand(3, m, m), rand(3, m, n), rand(3, m, n)), \
            {"alpha": 1.5, "beta": -1.0}
    raise ValueError(name)


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("case", ("plain", "beta", "stack"))
def test_run_op_matches_reference_pallas(case, dims):
    operands, kw = _case(case, dims)
    want = oracle("symm", operands, **kw)
    got = ops.run_op("symm", operands, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < TOL
    ref = np.asarray(ref_ops.run_op("symm", operands, backend="pallas",
                                    interpret=True, **kw))
    assert _rel(ref, want) < TOL
    assert _rel(got.numpy(), ref.astype(np.float64)) < TOL


def test_only_the_lower_triangle_of_a_is_read():
    (a, b, c), kw = _case("beta", (129, 257))
    lower_only = np.where(np.tri(129, dtype=bool), a, np.float32(np.nan))
    got = ops.run_op("symm", (lower_only, b, c), device="cpu", **kw)
    want = ops.run_op("symm", (a, b, c), device="cpu", **kw)
    assert torch.equal(got, want)


def test_run_op_under_every_knob_on_cpu():
    operands, kw = _case("beta", (129, 257))
    want = oracle("symm", operands, **kw)
    for knob in ops.knob_space_for("symm"):
        got = ops.run_op("symm", operands, knob=knob, device="cpu", **kw)
        assert _rel(got.numpy(), want) < TOL


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    operands, kw = _case("stack", (33, 9))
    a, b, c = map(torch.from_numpy, operands)
    before = S.LAUNCHES
    got = S.symm(a, b, c, bm=64, bn=64, **kw)
    assert torch.equal(got, S.symm_plain(a, b, c, **kw))
    assert S.LAUNCHES == before


def test_plain_version_matches_torch_reference_oracle():
    operands, kw = _case("beta", (48, 40))
    a, b, c = map(torch.from_numpy, operands)
    assert torch.allclose(S.symm_plain(a, b, c, **kw),
                          port_ref.symm(a, b, c, **kw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["float64", "tile", "square", "rows",
                                 "stride", "c_shape", "stack"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a, b = torch.randn(16, 16), torch.randn(16, 12)
    c, tile = None, dict(bm=64, bn=64)
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "tile":
        tile = dict(bm=256, bn=256)           # 1024 threads: not in the space
    elif bad == "square":
        a = torch.randn(16, 8)
    elif bad == "rows":
        b = torch.randn(9, 12)
    elif bad == "stride":
        b = torch.randn(12, 16).t()
    elif bad == "c_shape":
        c = torch.randn(12, 16)
    elif bad == "stack":
        b = torch.randn(2, 16, 12)
    with pytest.raises((TypeError, ValueError)):
        S.symm(a, b, c, alpha=1.0, beta=1.0, **tile)
