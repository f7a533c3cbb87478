"""The hand-written kernels on a CUDA card (GEMM, SYMM, the rank-k kernels
of SYRK/SYR2K, the TRMM kernels, and TRSM's inverse and substitution
kernels): against a float64
oracle and their plain versions under every candidate of their Hopper knob
spaces, stacked == per-item bit for bit, tri_packed == tri bit for bit;
masked == padded bit for bit, no copy op on the dispatch path, and the
recorded grids equal to the grid formulas; the GEMM's split-k on a ragged
shape, its unaligned-stride path equal to the aligned one bit for bit (symm,
syrk/syr2k and trmm too), ``tri``'s rank-k output symmetric bit for bit,
trmm's A read nowhere above its diagonal, a TRSM call launching its two
kernels and nothing else, and the launch parameters built into the
kernels equal to their Python mirrors; the dense, MoE, zamba2 and rwkv6
smoke models routed on the card against their plain versions; a retune
step on the card's telemetry and a one-executor fleet on the card; two
train steps of the llama3 smoke model on the card, and one on a (1, 1)
mesh in a world of one under NCCL against the unsharded step.  The card's
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


# -- the GEMM's split-k, the aligned and unaligned copies ---------------------

#: a ragged GEMM of few output tiles: its contraction splits under every tile
SPLIT_DIMS = (7, 1300, 1000)


@pytest.mark.gpu
def test_split_k_matches_float64_and_stacked_equals_per_item():
    _need_card()
    from repro_torch.kernels import introspect as I
    m, k, n = SPLIT_DIMS
    gen = torch.Generator(device="cuda").manual_seed(11)
    a = torch.randn(3, m, k, generator=gen, device="cuda")
    b = torch.randn(k, n, generator=gen, device="cuda")
    c = torch.randn(3, m, n, generator=gen, device="cuda")
    want = 0.5 * (a.double() @ b.double()) + 2.0 * c.double()
    for knob in ops.knob_space_for("gemm"):
        bm, bk, bn = knob["bm"], knob["bk"], knob["bn"]
        assert G.split_plan(m, n, k, bm, bn)[0] > 1, knob
        with I.capture_launches() as launched:
            got = G.gemm(a, b, c, bm=bm, bk=bk, bn=bn, alpha=0.5, beta=2.0)
        assert launched == [("gemm", I.full_grid_for("gemm", SPLIT_DIMS, bm,
                                                     bn, batch=3))]
        err = ((got.double() - want).abs().max() / want.abs().max()).item()
        assert err < TOL, (knob, err)
        for i in range(3):
            one = G.gemm(a[i], b, c[i], bm=bm, bk=bk, bn=bn, alpha=0.5,
                         beta=2.0)
            assert torch.equal(one.view(torch.int32),
                               got[i].view(torch.int32)), (knob, i)


@pytest.mark.gpu
def test_split_k_masked_equals_padded_bitwise():
    _need_card()
    from repro_torch.kernels import introspect as I
    from repro_torch.kernels.padded_ref import block_knob, padded_run
    m, k, n = SPLIT_DIMS
    gen = torch.Generator(device="cuda").manual_seed(12)
    xs = (_rand(gen, m, k), _rand(gen, k, n))
    knob = block_knob("gemm", 128)
    assert G.split_plan(m, n, k, 128, 128)[0] > 1
    with I.capture_launches() as launched:
        got = ops.run_op("gemm", xs, knob=knob)
    assert launched == [("gemm", I.full_grid_for("gemm", SPLIT_DIMS, 128,
                                                 128))]
    want = padded_run("gemm", xs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _unaligned(x):
    """``x``'s values in a view whose leading stride is one float longer:
    not a multiple of 4 when x's is, so the kernels take 4-byte copies."""
    wide = torch.zeros(*x.shape[:-1], x.shape[-1] + 1, device=x.device)
    wide[..., :x.shape[-1]] = x
    return wide[..., :x.shape[-1]]


@pytest.mark.gpu
def test_unaligned_strides_equal_aligned_bitwise():
    _need_card()
    from repro_torch.kernels import symm as S
    gen = torch.Generator(device="cuda").manual_seed(13)
    for m, k, n in ((129, 256, 384), (8, 4096, 1024)):
        a, b, c = _rand(gen, m, k), _rand(gen, k, n), _rand(gen, m, n)
        assert G.vec_aligned((a, k, 0), (b, n, 0))
        assert not G.vec_aligned((_unaligned(a), k + 1, 0))
        for knob in ops.knob_space_for("gemm"):
            tile = {key: knob[key] for key in ("bm", "bk", "bn")}
            aligned = G.gemm(a, b, c, alpha=0.5, beta=2.0, **tile)
            for x, y in ((_unaligned(a), b), (a, _unaligned(b)),
                         (_unaligned(a), _unaligned(b))):
                got = G.gemm(x, y, c, alpha=0.5, beta=2.0, **tile)
                assert torch.equal(got.view(torch.int32),
                                   aligned.view(torch.int32)), (tile, m)
    a, b = _rand(gen, STACK, 256, 256), _rand(gen, STACK, 256, 384)
    for knob in ops.knob_space_for("symm"):
        tile = dict(bm=knob["bm"], bn=knob["bn"])
        aligned = S.symm(a, b, **tile)
        got = S.symm(_unaligned(a), _unaligned(b), **tile)
        assert torch.equal(got.view(torch.int32),
                           aligned.view(torch.int32)), tile


@pytest.mark.gpu
def test_kernels_are_built_with_their_python_mirrors():
    """The launch parameters compiled into gemm.cu, symm.cu, trmm.cu,
    trmm_packed.cu, rank_k.cu and rank_k_packed.cu and the C split plan
    equal ``mainloop_params``, ``rank_k_params`` and ``split_plan``."""
    _need_card()
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import symm as S
    from repro_torch.kernels import syrk as K
    from repro_torch.kernels import trmm as TM
    out = (ctypes.c_int * 4)()
    gemm_lib, symm_lib = _build.load("gemm"), _build.load("symm")
    for bm, bk, bn in sorted(G.TILES):
        assert gemm_lib.repro_gemm_f32_config(bm, bk, bn, out) == 0
        p = G.mainloop_params(bm, bk, bn)
        assert list(out) == [p["threads"], p["stages"], p["smem"],
                             p["passes"]]
        for m, k, n in (*DIMS, SPLIT_DIMS, (8, 4096, 1024),
                        (8, 14336, 4096), (128, 3968, 14336)):
            gemm_lib.repro_gemm_f32_split(m, n, k, bm, bn, out)
            assert (out[0], out[1]) == G.split_plan(m, n, k, bm, bn)
    for bm, bn in sorted(S.TILES):
        assert symm_lib.repro_symm_f32_config(bm, bn, out) == 0
        p = G.mainloop_params(bm, 64, bn)
        assert list(out) == [p["threads"], p["stages"], p["smem"],
                             p["passes"]]
    for name in ("trmm", "trmm_packed"):
        config = getattr(_build.load(name), f"repro_{name}_f32_config")
        for bm, bn in sorted(TM.TILES):
            assert config(bm, bn, out) == 0, (name, bm, bn)
            p = G.mainloop_params(bm, 64, bn)
            assert list(out) == [p["threads"], p["stages"], p["smem"],
                                 p["passes"]], (name, bm, bn)
    for name in ("rank_k", "rank_k_packed"):
        config = getattr(_build.load(name), f"repro_{name}_f32_config")
        for bm, bk in sorted(K.TILES):
            assert config(bm, bk, out) == 0, (name, bm, bk)
            p = K.rank_k_params(bm, bk)
            assert list(out) == [p["threads"], p["stages"], p["smem"],
                                 p["passes"]], (name, bm, bk)


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


#: syrk/syr2k (n, k) of the copy-path checks: ragged (k not a multiple of
#: 4, so both paths copy 4 bytes), one row, and aligned (16-byte copies)
_RANK_K_PATH_DIMS = ((129, 65), (1, 384), (256, 384))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_rank_k_unaligned_strides_equal_aligned_bitwise(op):
    _need_card()
    from repro_torch.kernels import syrk as K
    gen = torch.Generator(device="cuda").manual_seed(16)
    fn = K.syrk if op == "syrk" else K.syr2k
    for n, k in _RANK_K_PATH_DIMS:
        for lead in ((), (STACK,)):
            a, b = _rand(gen, *lead, n, k), _rand(gen, *lead, n, k)
            c = _rand(gen, *lead, n, n)
            assert G.vec_aligned((a, k, n * k), (b, k, n * k)) == \
                (k % 4 == 0)
            pairs = [((_unaligned(a),), (a,))] if op == "syrk" else \
                [((_unaligned(a), b), (a, b)), ((a, _unaligned(b)), (a, b)),
                 ((_unaligned(a), _unaligned(b)), (a, b))]
            for knob in ops.knob_space_for(op):
                kw = dict(bm=knob["bm"], bk=knob["bn"], alpha=0.5, beta=2.0,
                          variant=knob["variant"])
                for unal, al in pairs:
                    want = fn(*al, c, **kw).view(torch.int32)
                    got = fn(*unal, c, **kw)
                    assert torch.equal(got.view(torch.int32), want), \
                        (knob, lead, n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_rank_k_tri_is_symmetric_bitwise(op):
    """``tri`` stores each lower tile with its mirror in the kernel (and a
    diagonal tile's upper triangle from its lower one): the output equals
    its transpose bit for bit, with and without C, single and stacked."""
    _need_card()
    from repro_torch.kernels import syrk as K
    gen = torch.Generator(device="cuda").manual_seed(17)
    fn = K.syrk if op == "syrk" else K.syr2k
    for n, k in DIMS_2D:
        for lead in ((), (STACK,)):
            xs = [_rand(gen, *lead, n, k) for _ in range(1 + (op == "syr2k"))]
            c = _rand(gen, *lead, n, n)     # not symmetric: read lower-stored
            for bm, bk in sorted(K.TILES):
                for cc, beta in ((None, 0.0), (c, 2.0)):
                    got = fn(*xs, cc, bm=bm, bk=bk, alpha=0.5, beta=beta,
                             variant="tri")
                    bits = got.view(torch.int32)
                    assert torch.equal(bits, bits.mT), (bm, bk, n, k, lead)


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


@pytest.mark.gpu
def test_trsm_kernels_match_their_plain_versions_over_the_knob_space():
    """``trsm_inv`` against ``diag_inverses_plain`` and ``tril(D) D^-1 =
    I``; ``trsm`` against ``substitute_plain`` fed the same inverses; both
    stacks equal to their items bit for bit."""
    _need_card()
    from repro_torch.kernels import trsm as T
    gen = torch.Generator(device="cuda").manual_seed(11)
    for m, n in DIMS_2D:
        a = _rand(gen, STACK, m, m) + m * torch.eye(m, device="cuda")
        b = _rand(gen, STACK, m, n)
        for knob in ops.knob_space_for("trsm"):
            bm, bn = knob["bm"], knob["bn"]
            inv = T.diag_inverses(a, bm=bm)
            full, last = T.diag_inverses_plain(a, bm)
            for got, want in zip(T.inverse_blocks(inv, m, bm), (full, last)):
                if want is not None:
                    assert _rel(got, want) < TOL, (knob, (m, n))
            for i in range(-(-m // bm)):
                lo, hi = i * bm, min(m, (i + 1) * bm)
                d = torch.tril(a[:, lo:hi, lo:hi]).double()
                di = inv[:, i, :hi - lo, :hi - lo].double()
                eye = torch.eye(hi - lo, dtype=torch.float64, device="cuda")
                scale = (d.abs() @ di.abs()).max().item()
                assert (d @ di - eye).abs().max().item() / scale < TOL
            x = T.substitute(a, b, inv, bm=bm, bn=bn, alpha=1.5)
            want = torch.empty_like(b)
            T.substitute_plain(a, b, want, *T.inverse_blocks(inv, m, bm),
                               bm=bm, bn=bn, alpha=1.5)
            assert _rel(x, want) < TOL, (knob, (m, n))
            for i in range(STACK):
                one = T.diag_inverses(a[i], bm=bm)
                assert torch.equal(one.view(torch.int32),
                                   inv[i].view(torch.int32)), (knob, i)
                one = T.substitute(a[i], b[i], inv[i], bm=bm, bn=bn,
                                   alpha=1.5)
                assert torch.equal(one.view(torch.int32),
                                   x[i].view(torch.int32)), (knob, i)


@pytest.mark.gpu
def test_trsm_launches_its_two_kernels_and_no_library_solve(monkeypatch):
    """A CUDA call makes one ``trsm_inv`` and one ``trsm`` launch, with the
    grids of ``full_grid_for``, no GEMM, and never calls
    ``torch.linalg.solve_triangular``."""
    _need_card()
    from repro_torch.kernels import introspect as I

    def refuse(*args, **kwargs):
        raise AssertionError("solve_triangular on the CUDA path")

    gen = torch.Generator(device="cuda").manual_seed(12)
    a = _rand(gen, 8, 300, 300) + 300 * torch.eye(300, device="cuda")
    b = _rand(gen, 8, 300, 257)
    want = torch.linalg.solve_triangular(torch.tril(a.double()),
                                         0.5 * b.double(), upper=False)
    monkeypatch.setattr(torch.linalg, "solve_triangular", refuse)
    for knob in ops.knob_space_for("trsm"):
        with I.capture_launches() as launched:
            x = ops.run_op("trsm", (a, b), knob=knob, alpha=0.5)
        assert launched == [
            ("trsm_inv", I.full_grid_for("trsm_inv", (300, 257), knob["bm"],
                                         batch=8)),
            ("trsm", I.full_grid_for("trsm", (300, 257), knob["bm"],
                                     knob["bn"], batch=8))], knob
        assert _rel(x, want) < TOL, knob


@pytest.mark.gpu
def test_trsm_is_built_with_its_python_mirror():
    """The launch parameters compiled into trsm.cu equal ``trsm_params``."""
    _need_card()
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import trsm as T
    out = (ctypes.c_int * 7)()
    config = _build.load("trsm").repro_trsm_f32_config
    for bm, bn in sorted(T.TILES):
        assert config(bm, bn, out) == 0, (bm, bn)
        p = T.trsm_params(bm, bn)
        assert list(out) == [p[k] for k in (
            "threads", "stages", "smem", "passes", "inv_threads", "inv_smem",
            "block_workspace")], (bm, bn)


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


#: trmm dims of the copy-path checks: ragged, and aligned (16-byte copies)
_TRMM_PATH_DIMS = ((129, 257), (256, 384))


@pytest.mark.gpu
def test_trmm_unaligned_strides_equal_aligned_bitwise():
    _need_card()
    from repro_torch.kernels import trmm as TM
    gen = torch.Generator(device="cuda").manual_seed(14)
    for m, n in _TRMM_PATH_DIMS:
        for lead in ((), (STACK,)):
            a, b = _rand(gen, *lead, m, m), _rand(gen, *lead, m, n)
            # the aligned shape takes the 16-byte copies
            assert G.vec_aligned((a, m, m * m), (b, n, m * n)) == \
                (m % 4 == 0)
            for knob in ops.knob_space_for("trmm"):
                kw = dict(bm=knob["bm"], bn=knob["bn"], alpha=0.5,
                          variant=knob["variant"])
                want = TM.trmm(a, b, **kw).view(torch.int32)
                for x, y in ((_unaligned(a), b), (a, _unaligned(b)),
                             (_unaligned(a), _unaligned(b))):
                    got = TM.trmm(x, y, **kw)
                    assert torch.equal(got.view(torch.int32), want), \
                        (knob, lead, m, n)


@pytest.mark.gpu
def test_trmm_reads_nothing_above_the_diagonal():
    """NaN everywhere above A's diagonal gives the bits of the A it came
    from, under every knob and on both copy paths."""
    _need_card()
    from repro_torch.kernels import trmm as TM
    gen = torch.Generator(device="cuda").manual_seed(15)
    for m, n in _TRMM_PATH_DIMS:
        upper = torch.ones(m, m, dtype=torch.bool, device="cuda").triu(1)
        for lead in ((), (STACK,)):
            a, b = _rand(gen, *lead, m, m), _rand(gen, *lead, m, n)
            nans = torch.where(upper, float("nan"), a)
            for knob in ops.knob_space_for("trmm"):
                kw = dict(bm=knob["bm"], bn=knob["bn"], alpha=0.5,
                          variant=knob["variant"])
                want = TM.trmm(a, b, **kw).view(torch.int32)
                for x, y in ((nans, b), (_unaligned(nans), _unaligned(b))):
                    got = TM.trmm(x, y, **kw)
                    assert torch.equal(got.view(torch.int32), want), \
                        (knob, lead, m, n)


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("llama3_8b", "granite_20b"))
def test_routed_smoke_model_on_the_card_matches_its_unrouted_run(arch):
    """The dense smoke model on the card: routed, every linear one launch of
    the GEMM kernel (7 or 6 per block and the head per pass) and logits
    within ``TOL`` of the unrouted run (``torch.matmul``, TF32 off) on the
    same weights; prefill and a decode step the same."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import AdsalaRuntime
    from repro_torch.kernels import introspect
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              use_pallas_gemm=True)
    plain = dataclasses.replace(cfg, use_pallas_gemm=False)
    model = tf.init_params(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen, device="cuda")
    per_pass = (7 if cfg.mlp_type == "swiglu" else 6) * cfg.n_layers + 1

    def err(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    with torch.inference_mode():
        introspect.reset_launches()
        got, _ = tf.forward(model, {"tokens": toks}, cfg,
                            runtime=AdsalaRuntime())
        torch.cuda.synchronize()
        assert introspect.launch_counts()["gemm"] == per_pass
        want, _ = tf.forward(model, {"tokens": toks}, plain)
        assert err(got, want) < TOL
        outs = {}
        for c in (cfg, plain):
            caches = tf.init_decode_state(c, 2, 32, dtype=torch.float32)
            last, caches = tf.prefill(model, {"tokens": toks}, caches, c)
            step, _ = tf.decode_step(model, toks[:, :1], caches, c)
            outs[c.use_pallas_gemm] = (last, step)
        for got, want in zip(outs[True], outs[False]):
            assert got.is_cuda and err(got, want) < TOL


@pytest.mark.gpu
def test_routed_moe_mla_model_on_the_card_matches_its_unrouted_run():
    """deepseek-v2-lite's smoke model (MLA, a dense first layer, MoE layers
    with a shared expert) on the card, routed: the GEMM kernel launched
    once per linear and expert stack (28 a prefill, 25 a decode step), each
    MoE layer within ``TOL`` of its plain version on the same input, the
    logits of a prefill and a decode step within ``TOL`` of the unrouted
    run; 3 requests, so a decode step's expert stacks have m = 3.  Once
    warm, neither pass makes the host wait on the card."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import AdsalaRuntime
    from repro_torch.kernels import introspect
    from repro_torch.models import Ctx, moe_ffn
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("deepseek_v2_lite"),
                              compute_dtype="float32", use_pallas_gemm=True)
    plain = dataclasses.replace(cfg, use_pallas_gemm=False)
    model = tf.init_params(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (3, 24), generator=gen, device="cuda")
    rt = AdsalaRuntime()
    moe_layers = [blk.moe for blk in model.layers if blk.kind == "moe"]
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append((mod, args[0].clone())))
        for m in moe_layers]

    def err(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    with torch.inference_mode():
        outs, launches = {}, []
        for c in (cfg, plain):
            caches = tf.init_decode_state(c, 3, 32, dtype=torch.float32)
            introspect.reset_launches()
            last, caches = tf.prefill(model, {"tokens": toks}, caches, c,
                                      runtime=rt)
            torch.cuda.synchronize()
            launches.append(introspect.launch_counts()["gemm"])
            step, _ = tf.decode_step(model, toks[:, :1], caches, c,
                                     runtime=rt)
            torch.cuda.synchronize()
            launches.append(introspect.launch_counts()["gemm"] - launches[-1])
            outs[c.use_pallas_gemm] = (last, step)
        for h in hooks:
            h.remove()
        assert launches == [28, 25, 0, 0]
        for got, want in zip(outs[True], outs[False]):
            assert got.is_cuda and err(got, want) < TOL
        routed_inputs = inputs[:2 * len(moe_layers)]
        assert {tuple(x.shape) for _, x in routed_inputs} == {
            (3, 24, cfg.d_model), (3, 1, cfg.d_model)}
        for mod, x in routed_inputs:
            got, _ = moe_ffn(mod, x, Ctx(cfg, rt), with_aux=False)
            want, _ = moe_ffn(mod, x, Ctx(plain), with_aux=False)
            assert err(got, want) < TOL
        # warm: the same passes again with every synchronising call an error
        caches = tf.init_decode_state(cfg, 3, 32, dtype=torch.float32)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, caches = tf.prefill(model, {"tokens": toks}, caches, cfg,
                                   runtime=rt)
            tf.decode_step(model, toks[:, :1], caches, cfg, runtime=rt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,per_pass", [("zamba2_1p2b", 27),
                                           ("rwkv6_1p6b", 25)])
def test_routed_recurrent_smoke_model_on_the_card_matches_its_unrouted_run(
        arch, per_pass):
    """The zamba2 (Mamba2 blocks and the shared attention block) and rwkv6
    smoke models on the card, routed: the GEMM kernel launched once per
    linear a pass (zamba2 27, rwkv6 25; the LoRA products, convolutions and
    scans stay plain), the logits of a forward, a prefill of two chunks
    and 3 decode steps within ``TOL`` of the unrouted run on the same
    weights, the recurrent states too.  Once warm, neither pass makes the
    host wait on the card."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import AdsalaRuntime
    from repro_torch.kernels import introspect
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              use_pallas_gemm=True)
    plain = dataclasses.replace(cfg, use_pallas_gemm=False)
    model = tf.init_params(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    toks = torch.randint(0, cfg.vocab, (3, 24), generator=gen, device="cuda")
    rt = AdsalaRuntime()

    def err(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    def leaves(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, list):
            return [t for child in node for t in leaves(child)]
        return [node] if isinstance(node, torch.Tensor) else []

    with torch.inference_mode():
        introspect.reset_launches()
        got, _ = tf.forward(model, {"tokens": toks}, cfg, runtime=rt)
        torch.cuda.synchronize()
        assert introspect.launch_counts()["gemm"] == per_pass
        want, _ = tf.forward(model, {"tokens": toks}, plain)
        assert err(got, want) < TOL
        outs, states = {}, {}
        for c in (cfg, plain):
            caches = tf.init_decode_state(c, 3, 32, dtype=torch.float32)
            introspect.reset_launches()
            last, caches = tf.prefill(model, {"tokens": toks}, caches, c,
                                      runtime=rt)
            passes = [last]
            for t in range(3):
                step, _ = tf.decode_step(model, toks[:, t:t + 1], caches, c,
                                         runtime=rt)
                passes.append(step)
            torch.cuda.synchronize()
            assert introspect.launch_counts()["gemm"] == (
                4 * per_pass if c.use_pallas_gemm else 0)
            outs[c.use_pallas_gemm] = passes
            states[c.use_pallas_gemm] = leaves(caches)
        for got, want in zip(outs[True], outs[False]):
            assert got.is_cuda and err(got, want) < TOL
        for got, want in zip(states[True], states[False]):
            assert err(got, want) < TOL
        # warm: the same passes again with every synchronising call an error
        caches = tf.init_decode_state(cfg, 3, 32, dtype=torch.float32)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, caches = tf.prefill(model, {"tokens": toks}, caches, cfg,
                                   runtime=rt)
            tf.decode_step(model, toks[:, :1], caches, cfg, runtime=rt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_retune_step_and_one_executor_fleet_on_the_card(tmp_path):
    """A GEMM model installed on the card (a few samples), served through
    a ``BlasService`` with a retuner: one bucket of the key (a probe: one
    claim per step) books its first item's call, within 2x of the install's
    own timer at the same dims and knob, the retuner samples and anchors
    it, and the
    served knob's time x 4 fed as telemetry is detected, refit, saved
    under the next version and swapped in one ``step()``.  Then a fleet of
    one executor process on the card over the same registry: it resolves
    the sub-registry of this card and its results equal the in-process
    ``run_op`` under the same model bit for bit."""
    _need_card()
    import numpy as np

    from repro_torch.backends import resolve_backend
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.core import install_subroutine
    from repro_torch.serving import (BlasService, FleetConfig, FleetService,
                                     RetuneConfig, Retuner, ServeConfig)
    torch.backends.cuda.matmul.allow_tf32 = False
    be = resolve_backend("hopper")
    sub = install_subroutine(
        "gemm", ops.knob_space_for("gemm", sizes=(64, 128)),
        be.timer_fn("gemm"), n_samples=8, dim_lo=64, dim_hi=512,
        tune_trials=1, candidates=("DecisionTree",), use_lof=False)
    reg = ModelRegistry(tmp_path).for_fingerprint(create=True)
    reg.save(sub)
    rt = AdsalaRuntime()
    rt.register(sub)
    ret = Retuner(rt, registry=reg, config=RetuneConfig(
        min_samples=1, anchor_samples=1, interval_s=3600.0, tune_trials=1))
    gen = torch.Generator(device="cuda").manual_seed(21)
    work = [(torch.randn(256, 256, generator=gen, device="cuda"),
             torch.randn(256, 256, generator=gen, device="cuda"))
            for _ in range(12)]
    with BlasService(runtime=rt, config=ServeConfig(max_batch=4,
                                                    linger_ms=1.0),
                     retuner=ret) as svc:
        outs = [f.result(timeout=120)
                for f in [svc.submit("gemm", xs) for xs in work]]
    for (a, b), got in zip(work, outs):
        want = a.double() @ b.double()
        assert ((got - want).abs().max() / want.abs().max()).item() < TOL
    key = next(k for k in rt.stats.buckets if k[1] == "gemm")
    bucket = rt.stats.buckets[key]
    # with a retuner attached one bucket a step books its first item run
    # alone: one call, the quantity the install's labels measure
    assert bucket.exec_seconds > 0 and bucket.exec_items == 1
    assert bucket.batches == 3 and bucket.requests == len(work)
    per_call = bucket.mean_exec_per_item
    label = be.timer_fn("gemm")(key[3], rt.peek("gemm", key[3], 4, "hopper"))
    assert 0.5 < per_call / label < 2.0
    assert ret.observe() == 1
    rt.record_batch("gemm", key[3], 4, "hopper", 4,
                    exec_seconds=4 * 4.0 * per_call, exec_items=4)
    version = sub.artifact_version
    assert ret.step() == [("hopper", "gemm", 4)]
    assert rt.subroutine("gemm", 4, "hopper").artifact_version == version + 1
    fleet = FleetService(fleet=FleetConfig(processes=1,
                                           registry_root=str(tmp_path)),
                         config=ServeConfig(max_batch=4, linger_ms=1.0))
    try:
        futs = [fleet.submit("gemm", xs) for xs in work]
        got = [f.result(timeout=300) for f in futs]
        stats = fleet.fleet_stats()[0]
    finally:
        fleet.close()
    fresh = AdsalaRuntime()
    reg.load_into(fresh, backend="hopper")
    for (a, b), g in zip(work, got):
        want = ops.run_op("gemm", (a, b), runtime=fresh).cpu()
        assert torch.equal(g, want)
    assert stats["resolution"]["mode"] == "exact"
    assert torch.cuda.get_device_name(0).lower() in \
        stats["resolution"]["gpu"]
    assert stats["device_name"] == torch.cuda.get_device_name(0)
    assert np.isfinite(per_call)


@pytest.mark.gpu
def test_two_train_steps_of_the_smoke_llama3_on_the_card(tmp_path):
    """``TrainLoop`` on the card (its default device): two steps of the
    llama3 smoke config at its own numerics (bf16 compute), finite losses
    and gradient norms, the parameters moved, and no hand-written kernel
    launched (the training step never routes)."""
    _need_card()
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMDataset, make_device_batch
    from repro_torch.kernels import introspect
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig

    cfg = get_smoke_config("llama3-8b")
    loop = TrainLoop(cfg=cfg, adamw=AdamWConfig(lr=1e-3, warmup_steps=1),
                     ckpt=Checkpointer(tmp_path),
                     dataset=SyntheticLMDataset(vocab=cfg.vocab, seq_len=64,
                                                global_batch=4))
    state = loop.init_state()
    before = [p.detach().clone() for p in state["params"].parameters()]
    assert before[0].is_cuda
    introspect.reset_launches()
    for step in range(2):
        batch = make_device_batch(loop.dataset.batch_at(step), loop.device)
        p, o, ef, m = loop.step_fn(state["params"], state["opt"],
                                   state["ef"], batch)
        state = {"params": p, "opt": o, "ef": ef}
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    torch.cuda.synchronize()
    assert sum(introspect.launch_counts().values()) == 0
    assert int(state["opt"].step) == 2
    assert all(not torch.equal(a, b) for a, b in
               zip(before, state["params"].parameters()))


@pytest.mark.gpu
def test_sharded_step_on_a_world_of_one_matches_the_unsharded_step(tmp_path):
    """Phase 9a of ``chip_smoke.py`` at the llama3 smoke config's width and
    2 layers, float32 with TF32 off: one ``TrainLoop`` step on a (1, 1)
    ("data", "model") mesh in a world of one under NCCL against one
    unsharded step from the same weights: the loss within 1e-6 relative,
    every gradient within 1e-6 of its max |g|, the parameters after the
    step a median |diff| <= 1e-6 apart, and no hand-written kernel
    launched."""
    _need_card()
    import dataclasses
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMDataset, make_global_batch
    from repro_torch.distributed import best_mesh, close_world, init_world
    from repro_torch.kernels import introspect
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    device = init_world("cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = best_mesh(model_parallel=2)
        assert tuple(mesh.shape) == (1, 1)
        cfg = dataclasses.replace(get_smoke_config("llama3-8b"), n_layers=2,
                                  compute_dtype="float32")
        ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=64, global_batch=4)
        out = {}
        introspect.reset_launches()
        for name, m in (("mesh", mesh), ("one", None)):
            loop = TrainLoop(cfg=cfg, adamw=AdamWConfig(lr=1e-3,
                                                        warmup_steps=1),
                             ckpt=Checkpointer(tmp_path / name), dataset=ds,
                             device=device, mesh=m)
            state = loop.init_state()
            batch = make_global_batch(ds.batch_at(0), m,
                                      None if m is None else batch_axes(m),
                                      device=device)
            loss, _ = loss_fn(state["params"], batch, cfg, mesh=m,
                              rules=loop.rules)
            loss.backward()
            grads = {}
            for k, p in state["params"].named_parameters():
                g = p.grad
                if m is not None:
                    g = g.redistribute(mesh, p.placements).full_tensor()
                grads[k] = g.clone()
            state["params"].zero_grad(set_to_none=True)
            p, *_ = loop.step_fn(state["params"], state["opt"], state["ef"],
                                 batch)
            params = {k: (v.full_tensor() if m is not None else v).detach()
                      for k, v in p.named_parameters()}
            loss = loss.full_tensor() if m is not None else loss
            out[name] = (float(loss.detach()), grads, params)
        torch.cuda.synchronize()
        assert sum(introspect.launch_counts().values()) == 0
        (ls, gs, ps), (lu, gu, pu) = out["mesh"], out["one"]
        assert abs(ls - lu) <= 1e-6 * abs(lu)
        for k, g in gu.items():
            assert (gs[k] - g).abs().max() <= 1e-6 * g.abs().max(), k
        # a first AdamW step moves an entry by about lr whatever its
        # gradient's size, so one whose gradient's sign differs at
        # rounding level may move 2 lr apart
        diffs = torch.cat([(ps[k] - w).abs().flatten()
                           for k, w in pu.items()])
        assert diffs.median() <= 1e-6 and diffs.max() <= 2e-3
    finally:
        close_world()
        torch.backends.cuda.matmul.allow_tf32 = tf32
