"""GEMM parity: the port's ``run_op("gemm", ...)`` against the reference
package's Pallas GEMM (interpret mode) on the same seeded numpy inputs, both
held to a float64 oracle, and the kernel wrapper's checks.  The kernel
itself is tested on the card by ``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro_torch.kernels import gemm as G
from repro_torch.kernels.introspect import launch_counts
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref

#: float32 tolerance of the reference conformance harness: max relative
#: error against float64 (the port and the reference sum in other orders)
TOL = 5e-4

#: the reference's RAGGED_DIMS["gemm"] (backends/conformance.py) + aligned
DIMS = ((128, 256, 128), (129, 65, 257), (1, 300, 384), (300, 300, 300))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _oracle(a, b, c=None, alpha=1.0, beta=0.0):
    out = alpha * (a.astype(np.float64) @ b.astype(np.float64))
    if c is not None and beta != 0.0:
        out = out + beta * c.astype(np.float64)
    return out


def _case(name, dims, seed=0):
    rng = np.random.default_rng(seed)
    m, k, n = dims

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if name == "plain":
        return (rand(m, k), rand(k, n)), {}
    if name == "beta":
        return (rand(m, k), rand(k, n), rand(m, n)), {"alpha": 0.5,
                                                      "beta": 2.0}
    if name == "stack":
        return (rand(3, m, k), rand(3, k, n), rand(3, m, n)), {"alpha": 1.5,
                                                               "beta": -1.0}
    if name == "shared_b":
        return (rand(3, m, k), rand(k, n)), {}
    raise ValueError(name)


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("case", ("plain", "beta", "stack", "shared_b"))
def test_run_op_matches_reference_pallas(case, dims):
    operands, kw = _case(case, dims)
    want = _oracle(*operands, **kw)
    got = ops.run_op("gemm", operands, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < TOL
    if case == "shared_b":
        # the reference's stacked shared-weight path is held to the oracle
        # only: its bitwise test fails on this jax (ROADMAP Queue 3)
        return
    ref = np.asarray(ref_ops.run_op("gemm", operands, backend="pallas",
                                    interpret=True, **kw))
    assert _rel(ref, want) < TOL
    assert _rel(got.numpy(), ref.astype(np.float64)) < TOL


def test_run_op_under_every_knob_on_cpu():
    (a, b, c), kw = _case("beta", (129, 65, 257))
    want = _oracle(a, b, c, **kw)
    for knob in ops.knob_space_for("gemm"):
        got = ops.run_op("gemm", (a, b, c), knob=knob, device="cpu", **kw)
        assert _rel(got.numpy(), want) < TOL


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    (a, b, c), kw = _case("stack", (33, 17, 9))
    a, b, c = map(torch.from_numpy, (a, b, c))
    before = launch_counts()
    got = G.gemm(a, b, c, bm=64, bk=16, bn=64, **kw)
    assert torch.equal(got, G.gemm_plain(a, b, c, **kw))
    assert launch_counts() == before


def test_plain_version_matches_torch_reference_oracle():
    (a, b, c), kw = _case("beta", (48, 32, 40))
    a, b, c = map(torch.from_numpy, (a, b, c))
    assert torch.allclose(G.gemm_plain(a, b, c, **kw),
                          port_ref.gemm(a, b, c, **kw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["float64", "tile", "inner", "stride",
                                 "c_shape", "stack"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a, b = torch.randn(16, 8), torch.randn(8, 12)
    c, tile = None, dict(bm=64, bk=16, bn=64)
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "tile":
        tile = dict(bm=32, bk=16, bn=64)
    elif bad == "inner":
        b = torch.randn(9, 12)
    elif bad == "stride":
        a = torch.randn(8, 16).t()
    elif bad == "c_shape":
        c = torch.randn(12, 16)
    elif bad == "stack":
        b = torch.randn(2, 8, 12)
    with pytest.raises((TypeError, ValueError)):
        G.gemm(a, b, c, alpha=1.0, beta=1.0, **tile)
