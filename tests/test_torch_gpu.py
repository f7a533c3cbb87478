"""The hand-written kernels on a CUDA card (GEMM, SYMM, the rank-k kernels
of SYRK/SYR2K, the TRMM kernels, and TRSM on the GEMM): against a float64
oracle and their plain versions under every candidate of their Hopper knob
spaces, stacked == per-item bit for bit, tri_packed == tri bit for bit;
masked == padded bit for bit, no copy op on the dispatch path, and the
recorded grids equal to the grid formulas.  The card's
tests skip where there is none; the check that their limit rejects TF32
runs anywhere.  This file imports nothing of the reference
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


# -- symm, syrk/syr2k and trsm ------------------------------------------------

#: the reference's RAGGED_DIMS for the 2-dim ops (backends/conformance.py)
#: + one aligned shape
DIMS_2D = ((129, 257), (1, 384), (300, 300), (256, 384))
STACK = 3


def _rel(got, want) -> float:
    want = want.double()
    return ((got.double() - want).abs().max()
            / (want.abs().max() + 1e-9)).item()


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def _sym(a):
    lo = torch.tril(a)
    return lo + torch.tril(a, -1).mT


@pytest.mark.gpu
def test_symm_kernel_matches_plain_over_the_knob_space():
    _need_card()
    from repro_torch.kernels import symm as S
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    for m, n in DIMS_2D:
        a, b, c = _rand(gen, STACK, m, m), _rand(gen, STACK, m, n), \
            _rand(gen, STACK, m, n)
        want = 0.5 * (_sym(a.double()) @ b.double()) + 2.0 * c.double()
        plain = S.symm_plain(a, b, c, alpha=0.5, beta=2.0)
        for knob in ops.knob_space_for("symm"):
            got = S.symm(a, b, c, bm=knob["bm"], bn=knob["bn"], alpha=0.5,
                         beta=2.0)
            assert _rel(got, want) < TOL, (knob, (m, n))
            assert _rel(got, plain) < TOL, (knob, (m, n))
            for i in range(STACK):
                one = S.symm(a[i], b[i], c[i], bm=knob["bm"], bn=knob["bn"],
                             alpha=0.5, beta=2.0)
                assert torch.equal(one, got[i]), (knob, i)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_rank_k_kernels_match_plain_over_the_knob_space(op):
    _need_card()
    from repro_torch.kernels import syrk as K
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    fn = K.syrk if op == "syrk" else K.syr2k
    for n, k in DIMS_2D:
        a, b = _rand(gen, STACK, n, k), _rand(gen, STACK, n, k)
        c = _rand(gen, STACK, n, n)         # not symmetric: full adds it as is
        ops_ = (a,) if op == "syrk" else (a, b)
        for knob in ops.knob_space_for(op):
            var = knob["variant"]
            tile = dict(bm=knob["bm"], bk=knob["bn"], variant=var)
            got = fn(*ops_, c, alpha=0.5, beta=2.0, **tile)
            plain = K.rank_k_plain(a, None if op == "syrk" else b, c,
                                   alpha=0.5, beta=2.0, variant=var)
            assert _rel(got, plain) < TOL, (knob, (n, k))
            for i in range(STACK):
                one = fn(*(x[i] for x in ops_), c[i], alpha=0.5, beta=2.0,
                         **tile)
                assert torch.equal(one, got[i]), (knob, i)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_tri_packed_equals_tri_bitwise(op):
    _need_card()
    from repro_torch.kernels import syrk as K
    gen = torch.Generator(device="cuda").manual_seed(5)
    fn = K.syrk if op == "syrk" else K.syr2k
    for n, k in DIMS_2D:
        a, b = _rand(gen, n, k), _rand(gen, n, k)
        c = _rand(gen, n, n)
        ops_ = (a,) if op == "syrk" else (a, b)
        for bm, bk in sorted(K.TILES):
            for cc, beta in ((None, 0.0), (c, 2.0)):
                tri = fn(*ops_, cc, bm=bm, bk=bk, alpha=0.5, beta=beta,
                         variant="tri")
                packed = fn(*ops_, cc, bm=bm, bk=bk, alpha=0.5, beta=beta,
                            variant="tri_packed")
                assert torch.equal(tri.view(torch.int32),
                                   packed.view(torch.int32)), (bm, bk, n, k)


@pytest.mark.gpu
def test_trsm_residual_is_small_and_stacked_equals_per_item():
    _need_card()
    from repro_torch.kernels import trsm as T
    gen = torch.Generator(device="cuda").manual_seed(6)
    for m, n in DIMS_2D:
        a = _rand(gen, STACK, m, m) + m * torch.eye(m, device="cuda")
        b = _rand(gen, STACK, m, n)
        lower = torch.tril(a.double())
        want = torch.linalg.solve_triangular(lower, 1.5 * b.double(),
                                             upper=False)
        for knob in ops.knob_space_for("trsm"):
            x = T.trsm(a, b, bm=knob["bm"], bn=knob["bn"], alpha=1.5)
            resid = (lower @ x.double() - 1.5 * b.double()).abs().max()
            scale = (lower.abs().max() * x.double().abs().max()).item()
            assert resid.item() / scale < TOL, (knob, (m, n))
            assert _rel(x, want) < TOL, (knob, (m, n))
            for i in range(STACK):
                one = T.trsm(a[i], b[i], bm=knob["bm"], bn=knob["bn"],
                             alpha=1.5)
                assert torch.equal(one, x[i]), (knob, i)


# -- trmm and the zero-copy contracts -----------------------------------------

@pytest.mark.gpu
def test_trmm_kernels_match_plain_over_the_knob_space():
    _need_card()
    from repro_torch.kernels import introspect as I
    from repro_torch.kernels import trmm as TM
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    for m, n in DIMS_2D:
        a, b = _rand(gen, STACK, m, m), _rand(gen, STACK, m, n)
        want = 0.5 * (torch.tril(a.double()) @ b.double())
        plain = TM.trmm_plain(a, b, alpha=0.5)
        for knob in ops.knob_space_for("trmm"):
            var = knob["variant"]
            tile = dict(bm=knob["bm"], bn=knob["bn"], variant=var)
            with I.capture_launches() as launched:
                got = TM.trmm(a, b, alpha=0.5, **tile)
            grid = (I.packed_grid_for if var == "tri_packed"
                    else I.full_grid_for)("trmm", (m, n), knob["bm"],
                                          knob["bn"], batch=STACK)
            kernel = "trmm_packed" if var == "tri_packed" else "trmm"
            assert launched == [(kernel, grid)], (knob, launched)
            assert _rel(got, want) < TOL, (knob, (m, n))
            assert _rel(got, plain) < TOL, (knob, (m, n))
            for i in range(STACK):
                one = TM.trmm(a[i], b[i], alpha=0.5, **tile)
                assert torch.equal(one, got[i]), (knob, i)
            if var == "tri_packed":
                tri = TM.trmm(a, b, alpha=0.5, **{**tile, "variant": "tri"})
                assert torch.equal(tri.view(torch.int32),
                                   got.view(torch.int32)), (knob, (m, n))


#: the ragged and one-row dims of the reference's zero-copy tests
_ZC_DIMS = {"gemm": ((129, 65, 257), (1, 300, 384)),
            "symm": ((129, 257), (1, 384)), "syrk": ((129, 65), (1, 384)),
            "syr2k": ((129, 65), (1, 384)), "trmm": ((129, 257), (1, 384))}


@pytest.mark.gpu
@pytest.mark.parametrize("op", sorted(_ZC_DIMS))
def test_masked_equals_padded_bitwise_with_no_copy_in_dispatch(op):
    _need_card()
    from repro_torch.kernels import introspect as I
    from repro_torch.kernels.padded_ref import block_knob, padded_run
    gen = torch.Generator(device="cuda").manual_seed(8)
    variants = ("full", "tri", "tri_packed") \
        if op in ("syrk", "syr2k", "trmm") else ("full",)
    for dims in _ZC_DIMS[op]:
        if op == "gemm":
            xs = (_rand(gen, dims[0], dims[1]), _rand(gen, dims[1], dims[2]))
        elif op in ("symm", "trmm"):
            xs = (_rand(gen, dims[0], dims[0]), _rand(gen, *dims))
        else:
            xs = tuple(_rand(gen, *dims) for _ in range(1 + (op == "syr2k")))
        for var in variants:
            knob = block_knob(op, 128, var)
            counts = I.copy_op_counts(ops.run_op, op, xs, knob=knob)
            assert counts == {}, (op, var, counts)
            got = ops.run_op(op, xs, knob=knob)
            want = padded_run(op, xs, variant=var)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (op, dims, var)


@pytest.mark.gpu
def test_trsm_masked_matches_padded_with_no_pad():
    _need_card()
    from repro_torch.kernels import introspect as I
    from repro_torch.kernels.padded_ref import block_knob, padded_run
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = _rand(gen, 129, 129) + 129 * torch.eye(129, device="cuda")
    b = _rand(gen, 129, 257)
    knob = block_knob("trsm", 128)
    counts = I.copy_op_counts(ops.run_op, "trsm", (a, b), knob=knob)
    assert "constant_pad_nd" not in counts
    got = ops.run_op("trsm", (a, b), knob=knob)
    want = padded_run("trsm", (a, b))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_service_on_the_card_resolves_computed_rows():
    """A ``BlasService`` on the card, two workers launching on streams of
    their own: every future holds its own request's result once it
    resolves (read here on the default stream), and the bucket spans come
    from CUDA events."""
    _need_card()
    from repro_torch.core import AdsalaRuntime
    from repro_torch.kernels.trmm import trmm_plain
    from repro_torch.serving import BlasService, ServeConfig
    gen = torch.Generator(device="cuda").manual_seed(10)
    reqs = [(_rand(gen, 256, 256), _rand(gen, 256, 192)) for _ in range(16)]
    with BlasService(runtime=AdsalaRuntime(),
                     config=ServeConfig(max_batch=4, workers=2)) as svc:
        outs = [f.result(timeout=120) for f in
                [svc.submit("trmm", r, alpha=0.5) for r in reqs]]
        for (a, b), out in zip(reqs, outs):
            assert out.is_cuda
            want = trmm_plain(a, b, alpha=0.5)
            err = ((out - want).abs().max() / want.abs().max()).item()
            assert err < TOL
        assert svc.drain(timeout=60)
    assert svc.stats.completed == 16 and svc.stats.failed == 0
    assert svc.stats.exec_sum > 0
