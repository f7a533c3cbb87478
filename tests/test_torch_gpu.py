"""The hand-written GEMM kernel on a CUDA card: against a float64 oracle
under every tile of the Hopper knob space, and stacked == per-item bit for
bit.  The card's tests skip where there is none; the check that their limit
rejects TF32 runs anywhere.  This file imports nothing of the reference
package, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops

#: max relative error vs float64.  The reference conformance harness allows
#: 5e-4 for float32; this is above IEEE-f32 sums (about 1e-6 here) and below
#: a product of TF32-rounded inputs (about 3e-4), so the kernel's precision
#: is held, not only its semantics.
TOL = 2e-5

#: the reference's RAGGED_DIMS["gemm"] (backends/conformance.py) + aligned
DIMS = ((128, 256, 128), (129, 65, 257), (1, 300, 384), (300, 300, 300))


def _tf32(x):
    """``x`` with its mantissa rounded to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("m,k,n", DIMS)
def test_tolerance_rejects_tf32_inputs(m, k, n):
    gen = torch.Generator().manual_seed(2)
    a = torch.randn(m, k, generator=gen)
    b = torch.randn(k, n, generator=gen)
    want = a.double() @ b.double()

    def err(got):
        return ((got - want).abs().max() / want.abs().max()).item()

    assert err((a @ b).double()) < TOL
    assert err(_tf32(a).double() @ _tf32(b).double()) > TOL


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GEMM kernel has no CPU mode")


@pytest.mark.gpu
def test_kernel_matches_plain_over_the_knob_space():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in DIMS:
        a = torch.randn(3, m, k, generator=gen, device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        c = torch.randn(3, m, n, generator=gen, device="cuda")
        want = 0.5 * (a.double() @ b.double()) + 2.0 * c.double()
        for knob in ops.knob_space_for("gemm"):
            kd = knob.dict
            got = G.gemm(a, b, c, bm=kd["bm"], bk=kd["bk"], bn=kd["bn"],
                         alpha=0.5, beta=2.0)
            err = ((got.double() - want).abs().max()
                   / want.abs().max()).item()
            assert err < TOL, (kd, (m, k, n), err)


@pytest.mark.gpu
def test_kernel_stacked_equals_per_item_bitwise():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(4, 129, 65, generator=gen, device="cuda")
    b = torch.randn(4, 65, 257, generator=gen, device="cuda")
    w = torch.randn(65, 257, generator=gen, device="cuda")
    for knob in ops.knob_space_for("gemm"):
        tile = {k: knob[k] for k in ("bm", "bk", "bn")}
        for bb in (b, w):
            stacked = G.gemm(a, bb, **tile)
            for i in range(4):
                one = G.gemm(a[i], bb[i] if bb.dim() == 3 else bb, **tile)
                assert torch.equal(one, stacked[i]), (tile, i)
