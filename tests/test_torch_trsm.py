"""TRSM parity: the port's ``run_op("trsm", ...)`` (blocked forward
substitution, run here on the plain versions of its two kernels: the
diagonal-block inverses and the substitution on the GEMM's plain version)
against the reference package's Pallas TRSM (interpret mode) on the same
seeded numpy inputs, both held to a float64 oracle; the blocked scheme's
GEMM calls; the kernels' grids and launch parameters; and the wrapper's
checks.  The kernels (``csrc/trsm.cu``) are tested on the card by
``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro_torch.backends import HopperBackend
from repro_torch.backends.conformance import oracle
from repro_torch.kernels import gemm as G
from repro_torch.kernels import introspect as I
from repro_torch.kernels.introspect import launch_counts
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import trsm as T

#: float32 tolerance of the reference conformance harness
TOL = 5e-4

#: the reference's RAGGED_DIMS["trsm"] (backends/conformance.py) + aligned
DIMS = ((129, 257), (1, 384), (300, 300), (256, 384))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _case(name, dims, seed=0):
    """A made diagonally dominant (``+ m * I``), as the calibration operands
    of both packages are, so the solve is well conditioned."""
    rng = np.random.default_rng(seed)
    m, n = dims
    lead = (3,) if name == "stack" else ()
    a = rng.standard_normal(lead + (m, m)).astype(np.float32)
    a = (a + m * np.eye(m, dtype=np.float32)).astype(np.float32)
    b = rng.standard_normal(lead + (m, n)).astype(np.float32)
    kw = {} if name == "plain" else {"alpha": 1.5}
    return (a, b), kw


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("case", ("plain", "alpha", "stack"))
def test_run_op_matches_reference_pallas(case, dims):
    operands, kw = _case(case, dims)
    want = oracle("trsm", operands, **kw)
    got = ops.run_op("trsm", operands, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < TOL
    ref = np.asarray(ref_ops.run_op("trsm", operands, backend="pallas",
                                    interpret=True, **kw))
    assert _rel(ref, want) < TOL
    assert _rel(got.numpy(), ref.astype(np.float64)) < TOL


def test_run_op_under_every_knob_on_cpu():
    operands, kw = _case("stack", (300, 40))
    want = oracle("trsm", operands, **kw)
    for knob in ops.knob_space_for("trsm"):
        got = ops.run_op("trsm", operands, knob=knob, device="cpu", **kw)
        assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("m,bm", [(129, 64), (256, 64), (300, 128),
                                  (1, 64), (256, 256)])
def test_blocked_scheme_makes_two_gemms_per_block_row(monkeypatch, m, bm):
    calls = []
    real = G.gemm

    def spy(a, b, c=None, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), kw["bk"],
                      c is not None))
        return real(a, b, c, **kw)

    monkeypatch.setattr(G, "gemm", spy)
    (a, b), _ = _case("alpha", (m, 40))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x = T.trsm(ta, tb, bm=bm, bn=64, alpha=1.5)
    nblk = -(-m // bm)
    assert len(calls) == 2 * nblk - 1
    assert all(bk == 64 for _, _, bk, _ in calls)
    # the update R_i = alpha B_i - A[i, :i] @ X[:i] uses the beta*C epilogue
    assert sum(has_c for *_, has_c in calls) == nblk - 1
    # the ragged last diagonal block is solved at its true size
    last = m - (nblk - 1) * bm
    assert calls[-1][0] == (last, last)
    assert _rel(x.numpy(), oracle("trsm", (a, b), alpha=1.5)) < TOL


def test_stacked_equals_per_item_on_cpu():
    (a, b), kw = _case("stack", (129, 33))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x = T.trsm(ta, tb, bm=64, bn=64, **kw)
    for i in range(3):
        one = T.trsm(ta[i], tb[i], bm=64, bn=64, **kw)
        assert torch.allclose(one, x[i], rtol=1e-6, atol=1e-7)


def test_wrapper_on_cpu_launches_nothing_and_matches_plain():
    (a, b), kw = _case("alpha", (129, 33))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = launch_counts()
    x = T.trsm(ta, tb, bm=64, bn=64, **kw)
    assert launch_counts() == before
    assert torch.allclose(x, T.trsm_plain(ta, tb, **kw), rtol=1e-5,
                          atol=1e-6)
    assert torch.allclose(T.trsm_plain(ta, tb, **kw),
                          port_ref.trsm(ta, tb, **kw), rtol=1e-5, atol=1e-6)


def test_calibration_operands_are_diagonally_dominant():
    be = HopperBackend(device="cpu")
    a, b = be.make_operands("trsm", (48, 40), seed=3)
    assert a.shape == (48, 48) and b.shape == (48, 40)
    off = torch.tril(a, -1).abs().sum(-1)
    assert bool((a.diagonal() > off / 2).all())


@pytest.mark.parametrize("bad", ["tile", "square", "rows", "stack",
                                 "float64"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a, b = torch.randn(16, 16) + 16 * torch.eye(16), torch.randn(16, 12)
    tile = dict(bm=64, bn=64)
    if bad == "tile":
        tile = dict(bm=32, bn=64)
    elif bad == "square":
        a = torch.randn(16, 8)
    elif bad == "rows":
        b = torch.randn(9, 12)
    elif bad == "stack":
        b = torch.randn(2, 16, 12)
    elif bad == "float64":
        a, b = a.double(), b.double()
    with pytest.raises((TypeError, ValueError)):
        T.trsm(a, b, **tile)


# -- the two kernels' plain versions, grids and launch parameters ------------

#: the knob space's diagonal blocks
BMS = sorted({k["bm"] for k in ops.knob_space_for("trsm")})


@pytest.mark.parametrize("m", (1, 63, 129, 300))
@pytest.mark.parametrize("bm", BMS)
def test_diag_inverses_plain_inverts_every_block(m, bm):
    (a, _b), _ = _case("stack", (m, 4), seed=m)
    ta = torch.from_numpy(a)
    full, last = T.diag_inverses_plain(ta, bm)
    nfull, rag = divmod(m, bm)
    assert (full is None) == (nfull == 0) and (last is None) == (rag == 0)
    if rag:
        # the ragged last block at its true size
        assert tuple(last.shape) == (3, rag, rag)
    for i in range(-(-m // bm)):
        lo, hi = i * bm, min(m, (i + 1) * bm)
        inv = full[:, i] if hi - lo == bm else last
        d = torch.tril(ta[:, lo:hi, lo:hi]).double()
        eye = torch.eye(hi - lo, dtype=torch.float64)
        assert float((d @ inv.double() - eye).abs().max()) < 1e-5
        # lower triangular, as the kernel's workspace holds it
        assert torch.equal(inv, torch.tril(inv))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("bm", BMS)
def test_substitute_plain_matches_reference_pallas(dims, bm):
    operands, kw = _case("alpha", dims)
    a, b = map(torch.from_numpy, operands)
    x = torch.empty_like(b)
    T.substitute_plain(a, b, x, *T.diag_inverses_plain(a, bm), bm=bm, bn=64,
                       **kw)
    want = oracle("trsm", operands, **kw)
    ref = np.asarray(ref_ops.run_op("trsm", operands, backend="pallas",
                                    interpret=True, **kw))
    assert _rel(x.numpy(), want) < TOL
    assert _rel(x.numpy(), ref.astype(np.float64)) < TOL


@pytest.mark.parametrize("bm", BMS)
def test_kernel_wrappers_on_cpu_run_the_plain_scheme(bm):
    """``diag_inverses`` packs the plain inverses into the kernel's
    workspace layout, and ``substitute`` from it equals ``trsm``."""
    (a, b), kw = _case("stack", (300, 33))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    inv = T.diag_inverses(ta, bm=bm)
    assert tuple(inv.shape) == (3, -(-300 // bm), bm, bm)
    for got, want in zip(T.inverse_blocks(inv, 300, bm),
                         T.diag_inverses_plain(ta, bm)):
        assert (got is None) == (want is None)
        if want is not None:
            assert torch.equal(got, want)
    x = T.substitute(ta, tb, inv, bm=bm, bn=128, **kw)
    assert torch.equal(x, T.trsm(ta, tb, bm=bm, bn=128, **kw))
    with pytest.raises(ValueError):
        T.substitute(ta, tb, inv[:, :1], bm=bm, bn=128)


@pytest.mark.parametrize("bn,blocks", [(64, 224), (128, 112), (256, 56)])
def test_grids_at_the_main_path_shapes(bn, blocks):
    big, stack = (4096, 14336), (512, 512)
    for bm in BMS:
        if (bm, bn) not in T.TILES:
            continue
        assert I.full_grid_for("trsm", big, bm, bn) == (blocks, 1, 1)
        assert I.full_grid_for("trsm", stack, bm, bn, batch=8) == \
            (512 // bn, 1, 8)
        assert I.full_grid_for("trsm_inv", big, bm) == \
            (4096 // bm, bm // T.INV_COLS, 1)
        assert I.full_grid_for("trsm_inv", stack, bm, batch=8) == \
            (512 // bm, bm // T.INV_COLS, 8)
    assert I.full_grid_for("trsm_inv", (129, 257), 128) == (2, 2, 1)
    with pytest.raises(ValueError):
        I.packed_grid_for("trsm", big, 128, bn)


@pytest.mark.parametrize("tile", sorted(T.TILES), ids=lambda t: "%dx%d" % t)
def test_trsm_params_fit_the_card(tile):
    bm, bn = tile
    p = T.trsm_params(bm, bn)
    assert 128 <= p["threads"] <= 256
    assert p["smem"] <= G.SMEM_MAX and p["inv_smem"] <= G.SMEM_MAX
    assert p["inv_threads"] == T.INV_COLS and bm % T.INV_COLS == 0
    # the substitution runs the mainloop of the (bm, 64, bn) tile
    assert {k: p[k] for k in G.mainloop_params(bm, 64, bn)} == \
        G.mainloop_params(bm, 64, bn)
    # one diagonal block's inverse; the big call holds 4096 / bm of them
    assert p["block_workspace"] == 4 * bm * bm
    assert (4096 // bm) * p["block_workspace"] == 4 * 4096 * bm


def test_the_recorder_knows_both_kernels():
    assert {"trsm", "trsm_inv"} <= set(I.KERNELS)
