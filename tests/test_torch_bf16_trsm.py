"""The port's TRSM on bfloat16 operands against the reference package's
(``trsm_pallas`` in interpret mode: every intermediate in A's dtype, so the
inverses, ``alpha * B_i``, each update, each difference and each ``X_i``
rounded to bf16), at the reference's knob (bm = bn = 128) and at bm 64.

On the CPU the port's ``run_op`` computes the kernels' plain version: the
blocked scheme with the reference's four roundings a block row, the
inverses solved in float32 and rounded once (``diag_inverses_plain``,
``substitute_plain``); the kernels themselves (``csrc/trsm_bf16.cu``) are
held to the same plain version on the card by ``test_torch_gpu.py`` and
``chip_smoke.py``.

Two kinds of operand: the reference's own (``make_operands``: N(0, 1) +
m I), on which the whole off-diagonal update moves X by about two bf16
ulps, and coupled ones (m I + (sqrt(m) / 2) N(0, 1)), on which it moves X
by about half of max|X|, so that a wrong update shows.  The readings
behind the limits, over this file's 18 cases of each kind (``python
tests/test_torch_bf16_trsm.py`` prints them; a CPU host, the reference in
interpret mode): the port lies 2.4e-3 to 5.1e-3 of the largest output
from the reference on the former (limit 2^-7 = 7.8e-3) and 3.5e-3 to
7.1e-3 on the latter (limit 2^-6: XLA's bf16 inverses, solved in bf16,
are one ulp off the float32 solve rounded once in some entries, and the
coupled update carries such steps down the block rows); the float32
scheme rounded once at the end lies up to 9.7e-3 from the reference, so
the port rounds where the reference rounds.  Both lie within the
reference's own 0.1 of float64 (``tests/test_kernels.py::test_pallas_bf16``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.knobs as ref_knobs
import repro.kernels.ops as ref_ops
from repro.kernels.cpu_blocked import make_operands
from repro_torch.core import AdsalaRuntime
from repro_torch.kernels import gemm as G
from repro_torch.kernels import introspect as I
from repro_torch.kernels import ops
from repro_torch.kernels import trsm as T
from repro_torch.serving import BlasService, ServeConfig
from test_torch_gpu import _chip_smoke

#: max |port - reference| / max |reference|, per kind of operand
RTOL = {"standard": 2.0 ** -7, "coupled": 2.0 ** -6}
#: the reference's own bound for its bf16 trsm against float32
#: (tests/test_kernels.py::test_pallas_bf16)
REF_TOL = 0.1
#: the cases: alpha, and the stack of 3
CASES = {"alpha1": ((), 1.0), "alpha05": ((), 0.5), "stack": ((3,), -1.5)}
#: a block's shape, a ragged one and one of several block rows
DIMS = ((128, 128), (100, 130), (300, 300))
KINDS = ("standard", "coupled")
BMS = (128, 64)
WAIT = 120


def _ids(d):
    return "x".join(map(str, d))


def _operands(kind, case, dims, seed=3):
    """Seeded float32 numpy A and B, both packages rounding the same values
    to bf16 (round to nearest even): the reference's ``make_operands``, an
    item a seed for the stack, or coupled operands."""
    lead, alpha = CASES[case]
    m, n = dims
    items = []
    for i in range(lead[0] if lead else 1):
        if kind == "standard":
            items.append(make_operands("trsm", dims, np.float32,
                                       seed=seed + i))
            continue
        rng = np.random.default_rng(seed + i)
        a = (np.sqrt(m) / 2) * rng.standard_normal((m, m))
        a = (a + m * np.eye(m)).astype(np.float32)
        items.append((a, rng.standard_normal((m, n)).astype(np.float32)))
    a, b = (np.stack(x) if lead else x[0] for x in zip(*items))
    return (a, b), alpha


def _port(operands):
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in operands)


def _port_knob(bm):
    return next(k for k in ops.knob_space_for("trsm")
                if k["bm"] == bm and k["bn"] == bm)


@functools.lru_cache(maxsize=None)
def _reference(kind, case, dims, bm):
    """The reference's bf16 run of a case as float64 numpy (its operands
    checked equal to the port's)."""
    operands, alpha = _operands(kind, case, dims)
    port = _port(operands)
    ref = tuple(jnp.asarray(x, jnp.bfloat16) for x in operands)
    for p, r in zip(port, ref):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(r.astype(jnp.float32)))
    out = ref_ops.run_op("trsm", ref, backend="pallas",
                         knob=ref_knobs.Knob((("bm", bm), ("bn", bm))),
                         interpret=True, alpha=alpha)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32), np.float64)


def _run(port, alpha, bm):
    got = ops.run_op("trsm", port, knob=_port_knob(bm), device="cpu",
                     alpha=alpha)
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    return got


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_trsm_bf16_matches_reference_pallas(kind, case, dims, bm):
    operands, alpha = _operands(kind, case, dims)
    got = _run(_port(operands), alpha, bm).double().numpy()
    want = _reference(kind, case, dims, bm)
    assert got.shape == want.shape
    assert _rel(got, want) < RTOL[kind]


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_trsm_bf16_within_the_reference_tolerance_of_float64(kind, case,
                                                             dims, bm):
    operands, alpha = _operands(kind, case, dims)
    port = _port(operands)
    a, b = (x.double() for x in port)
    want = torch.linalg.solve_triangular(torch.tril(a), alpha * b,
                                         upper=False).numpy()
    assert _rel(_run(port, alpha, bm).double().numpy(), want) < REF_TOL
    assert _rel(_reference(kind, case, dims, bm), want) < REF_TOL


@pytest.mark.parametrize("bm", sorted({t[0] for t in T.TILES}))
def test_diag_inverses_bf16_are_the_float32_ones_rounded(bm):
    """``diag_inverses`` of a bf16 A: the float32 inverses of the same
    values rounded once, bit for bit, in the kernels' workspace layout."""
    (a, _b), _ = _operands("coupled", "stack", (300, 300))
    ta = torch.from_numpy(a).bfloat16()
    got = T.diag_inverses(ta, bm=bm)
    assert got.dtype == torch.bfloat16
    want = T.diag_inverses(ta.float(), bm=bm).bfloat16()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("m,bm", ((100, 128), (128, 128), (64, 64)))
def test_one_block_is_one_rounded_product(m, bm):
    """At m <= bm the scheme is one block row: X = bf16(bf16(D^-1) @
    bf16(alpha B)), here computed apart, bit for bit."""
    (a, b), alpha = _operands("standard", "alpha05", (m, 40))
    ta, tb = _port((a, b))
    dinv = torch.linalg.solve_triangular(
        torch.tril(ta.float()), torch.eye(m), upper=False).bfloat16()
    r = (alpha * tb.float()).bfloat16()
    want = torch.matmul(dinv.float(), r.float()).bfloat16()
    got = T.trsm(ta, tb, bm=bm, bn=64, alpha=alpha)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_trsm_plain_bf16_is_the_blocked_scheme():
    """The bf16 plain version needs its diagonal block, runs the scheme the
    wrapper runs on the CPU, and lies apart from one float32 solve rounded
    once; its float32 meaning is unchanged."""
    (a, b), alpha = _operands("coupled", "alpha05", (300, 300))
    ta, tb = _port((a, b))
    with pytest.raises(ValueError, match="bm"):
        T.trsm_plain(ta, tb, alpha=alpha)
    for bm in (64, 128):
        got = T.trsm_plain(ta, tb, alpha=alpha, bm=bm)
        assert torch.equal(got.view(torch.int16),
                           T.trsm(ta, tb, bm=bm, bn=64, alpha=alpha)
                           .view(torch.int16))
    once = torch.linalg.solve_triangular(torch.tril(ta.float()),
                                         alpha * tb.float(),
                                         upper=False).bfloat16()
    assert not torch.equal(got, once)
    fa, fb = ta.float(), tb.float()
    assert torch.equal(T.trsm_plain(fa, fb, alpha=alpha, bm=64),
                       T.trsm_plain(fa, fb, alpha=alpha))


#: a wrong dtype for one operand or both: B float32 beside bf16, float16
#: and float64 throughout
_BAD = {"mixed": lambda a, b: (a, b.float()),
        "float16": lambda a, b: (a.half(), b.half()),
        "float64": lambda a, b: (a.double(), b.double())}


@pytest.mark.parametrize("bad", sorted(_BAD))
def test_trsm_bf16_rejects_mixed_and_other_dtypes(bad):
    a = (torch.randn(6, 6) + 6 * torch.eye(6)).bfloat16()
    b = torch.randn(6, 5).bfloat16()
    with pytest.raises(TypeError, match="all of one dtype"):
        T.trsm(*_BAD[bad](a, b), bm=64, bn=64)
    with pytest.raises(TypeError, match="all of one dtype"):
        ops.run_op("trsm", _BAD[bad](a, b), device="cpu")
    assert T.trsm(a, b, bm=64, bn=64).dtype == torch.bfloat16


@pytest.mark.parametrize("lead", ((), (3,)), ids=("single", "stack"))
def test_trsm_bf16_nan_above_a_diagonal_changes_no_bit(lead):
    (a, b), alpha = _operands("coupled", "stack" if lead else "alpha05",
                              (100, 130))
    ta, tb = _port((a, b))
    upper = torch.ones(100, 100, dtype=torch.bool).triu(1)
    nans = torch.where(upper, torch.tensor(float("nan"),
                                           dtype=torch.bfloat16), ta)
    zeros = torch.where(upper, torch.zeros((), dtype=torch.bfloat16), ta)
    got = T.trsm(nans, tb, bm=64, bn=64, alpha=alpha)
    want = T.trsm(zeros, tb, bm=64, bn=64, alpha=alpha)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert bool(torch.isfinite(got).all())


def test_trsm_bf16_stacked_equals_per_item():
    (a, b), alpha = _operands("coupled", "stack", (300, 300))
    ta, tb = _port((a, b))
    x = T.trsm(ta, tb, bm=64, bn=128, alpha=alpha)
    for i in range(3):
        one = T.trsm(ta[i], tb[i], bm=64, bn=128, alpha=alpha)
        assert torch.equal(one.view(torch.int16), x[i].view(torch.int16))


def test_trsm_bf16_decision_is_the_default_knob_at_two_bytes():
    """A bf16 call asks the runtime under its 2-byte key, finds no model
    (installs are float32 only) and takes the backend's default knob."""
    (a, b), alpha = _operands("standard", "alpha05", (100, 130))
    rt = AdsalaRuntime()
    port = _port((a, b))
    got = ops.run_op("trsm", port, runtime=rt, device="cpu", alpha=alpha)
    stats = rt.stats.for_backend("hopper")
    assert stats.default_calls == 1 and stats.model_evals == 0
    assert not rt.has("trsm", 2, "hopper")
    bm = ops.default_knob("trsm")["bm"]
    assert torch.equal(got, T.trsm_plain(*port, alpha=alpha, bm=bm))


def test_service_keeps_bf16_and_float32_trsm_apart():
    """bf16 and float32 trsm requests of one shape land in buckets of their
    own (the key holds the dtype bytes), and every result keeps its
    request's dtype and equals its plain version under the default
    knob."""
    bm = ops.default_knob("trsm")["bm"]
    reqs = []
    for i in range(12):
        (a, b), _ = _operands("coupled", "alpha1", (40, 24), seed=i)
        dtype = (torch.bfloat16, torch.float32)[i % 2]
        reqs.append(tuple(torch.from_numpy(x).to(dtype) for x in (a, b)))
    rt = AdsalaRuntime()
    with BlasService(runtime=rt, config=ServeConfig(max_batch=8,
                                                    linger_ms=2.0, workers=2),
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("trsm", xs) for xs in reqs]]
        assert svc.drain(timeout=60)
    for xs, out in zip(reqs, outs):
        assert out.dtype == xs[0].dtype
        want = T.trsm(*xs, bm=bm, bn=ops.default_knob("trsm")["bn"])
        assert torch.equal(out, want)
    keys = {key for key in rt.stats.buckets if key[0] == "hopper"}
    assert keys == {("hopper", "trsm", nbytes, (40, 24))
                    for nbytes in (2, 4)}
    assert svc.stats.completed == len(reqs) and svc.stats.failed == 0


@pytest.mark.parametrize("tile", sorted(T.TILES), ids=lambda t: "%dx%d" % t)
def test_trsm_bf16_launch_params_fit_the_card(tile):
    """The bf16 substitution runs the wgmma loop's tile of ``(bm, 64,
    bn)``: passes of ``min(bm, 128)`` rows and every column, a warpgroup per
    64 rows of a pass, A's K-major rows swizzled over 128 bytes.  Its
    shared region (``bm x bn`` bf16 values for B_i and R_i) and the ring
    fit the SM over the blocks an SM is meant to hold (2 at most, the grid
    being a block a strip; 1 where 2 leave fewer than 3 stages), with 2-16
    stages, as many as fit, every stage, slab and the region on the
    swizzle's 1024-byte repeat.
    Its inverse kernel keeps the float32 one's threads and shared bytes,
    and a diagonal block's inverse takes 2 bytes an entry; the float32
    parameters are unchanged."""
    bm, bn = tile
    p = T.trsm_params(bm, bn, torch.bfloat16)
    loop = G.mainloop_params(bm, 64, bn, torch.bfloat16)
    keep = ("pass", "passes", "threads", "warpgroups", "swizzle")
    assert {k: p[k] for k in keep} == {k: loop[k] for k in keep}
    pm, pn = p["pass"]
    assert pm == min(bm, 128) and pn == bn and p["passes"] == bm // pm
    assert p["warpgroups"] == pm // 64 and p["swizzle"] == 128
    assert p["region"] == 2 * bm * bn
    assert p["region"] % G.SWIZZLE_REPEAT == 0
    stage = 2 * 64 * (pm + pn)
    assert stage % G.SWIZZLE_REPEAT == 0

    def budget(blocks):
        return G.SMEM_SM // blocks - 4 * G.SWIZZLE_REPEAT - p["region"]

    assert 1 <= p["blocks"] <= min(2, loop["blocks"])
    assert p["blocks"] == (2 if loop["blocks"] >= 2
                           and budget(2) >= 3 * stage else 1)
    assert 2 <= p["stages"] <= G.WGMMA_MAX_STAGES
    assert p["stages"] == G.WGMMA_MAX_STAGES or \
        (p["stages"] + 1) * stage > budget(p["blocks"])
    assert p["stages"] == 2 or p["stages"] * stage <= budget(p["blocks"])
    assert p["smem"] == G.SWIZZLE_REPEAT + p["region"] \
        + p["stages"] * (stage + 28)
    # one block within a block's limit, the blocks within the SM with the
    # card's 1 KB a block
    assert p["smem"] <= G.SMEM_MAX
    assert p["blocks"] * (p["smem"] + 1024) <= G.SMEM_SM
    assert p["inv_threads"] == T.INV_COLS
    assert p["inv_smem"] == 4 * bm * (T.INV_COLS + 2 * T.INV_ROWS)
    assert p["block_workspace"] == 2 * bm * bm
    f32 = T.trsm_params(bm, bn)
    assert f32 == {**G.mainloop_params(bm, 64, bn), "inv_threads": 64,
                   "inv_smem": p["inv_smem"], "block_workspace": 4 * bm * bm}
    with pytest.raises(TypeError):
        T.trsm_params(bm, bn, torch.float16)


def test_bf16_kernels_launch_the_f32_grids():
    big, stack = (4096, 14336), (512, 512)
    for bm, bn in sorted(T.TILES):
        for dims, batch in ((big, 1), (stack, 8)):
            assert I.full_grid_for("trsm_bf16", dims, bm, bn, batch=batch) \
                == I.full_grid_for("trsm", dims, bm, bn, batch=batch)
            assert I.full_grid_for("trsm_inv_bf16", dims, bm, batch=batch) \
                == I.full_grid_for("trsm_inv", dims, bm, batch=batch)
    assert {"trsm_bf16", "trsm_inv_bf16"} <= set(I.KERNELS)
    assert T.KERNEL_OF[torch.bfloat16] == {
        "trsm_inv": ("trsm_inv_bf16", "repro_trsm_inv_bf16"),
        "trsm": ("trsm_bf16", "repro_trsm_bf16")}


@pytest.mark.parametrize("dtype,sfx", ((torch.float32, ""),
                                       (torch.bfloat16, "_bf16")))
def test_chip_smoke_names_the_trsm_kernels_of_each_dtype(dtype, sfx):
    """Phase 5b's launch gates expect the kernels the wrapper records."""
    cs = _chip_smoke()
    knob = ops.default_knob("trsm").dict
    assert cs.kernel_of("trsm", knob, dtype) == f"trsm{sfx}"
    assert cs._expected_launches("trsm", knob, dtype) == \
        {f"trsm_inv{sfx}": 1, f"trsm{sfx}": 1}
    for step in ("trsm", "trsm_inv"):
        name = f"{step}{sfx}"
        assert T.KERNEL_OF[dtype][step][0] == name and name in cs.KERNELS
        assert dtype == torch.float32 or name in cs.PRECOND_BF16_KERNELS
    assert "trsm_bf16" in cs.KERNEL_SOURCES
    assert tuple(cs.KERNELS) == I.KERNELS


def test_chip_smoke_bf16_bounds_of_the_trsm_calls():
    """The bf16 bounds phase 7 prints for phase 5b's trsm calls: m^2 n at
    989.4 TFLOP/s bounds the big call, the bytes at 3.35 TB/s (2 an
    element) the stack; both calls run on coupled operands."""
    cs = _chip_smoke()
    calls = [c for c in cs.bf16_precond_cases() if c["op"] == "trsm"]
    assert [c["shapes"] for c in calls] == [
        [[4096, 4096], [4096, 14336]], [[8, 512, 512], [8, 512, 512]]]
    assert all(c["coupled"] for c in calls)
    got = [(round(ms, 4), by) for ms, by in
           (cs._bound("trsm", c["shapes"], c["kw"], bf16=True)
            for c in calls)]
    assert got == [(0.2431, "operations"), (0.0031, "bytes")]
    flops, nbytes = cs._work("trsm", calls[0]["shapes"], {}, 2)
    assert flops == 4096 * 4096 * 14336
    assert nbytes == 2 * (4096 * 4097 / 2 + 2 * 4096 * 14336)
    flops, nbytes = cs._inverse_work(4096, 64, 1, 2)
    assert flops == 64 * 64 ** 3 / 3 and nbytes == 2 * 64 * 64 * 65


def test_chip_smoke_trsm_control_reads_above_the_limit():
    """The control phases 3 and 5b read: the plain scheme with the first
    64 contraction indices of every step 0 dropped lies above
    ``TRSM_BF16_TOL`` (two bf16 ulps of the largest output, 5b's limit) on
    coupled operands at (300, 300) under the default bm, and further above
    it than on the standard operands, whose
    off-diagonal update shrinks as 1 / sqrt(m) against X (at (300, 300) it
    still reads above the limit; at the preconditioner's m = 4096 it does
    not)."""
    cs = _chip_smoke()
    bm = ops.default_knob("trsm")["bm"]
    gen = torch.Generator().manual_seed(5)
    read = {}
    for coupled in (False, True):
        a, b = (x.bfloat16() for x in cs.make_operands(
            torch, gen, "trsm", [(300, 300), (300, 300)], coupled=coupled,
            device="cpu"))
        plain = T.trsm_plain(a, b, bm=bm, alpha=0.5)
        dropped = cs.trsm_dropped_a(a, bm)
        assert torch.equal(dropped[:bm], a[:bm])
        assert not bool(dropped[bm:, :cs.TRSM_DROP].any())
        assert torch.equal(dropped[bm:, cs.TRSM_DROP:], a[bm:, cs.TRSM_DROP:])
        read[coupled] = cs._rel_err(T.trsm_plain(dropped, b, bm=bm,
                                                 alpha=0.5), plain)
    assert read[True] > cs.TRSM_BF16_TOL > cs.BF16_TOL
    assert read[True] > 2 * read[False]
    with pytest.raises(ValueError):
        cs.trsm_dropped_a(a, 32)


@pytest.mark.parametrize("kind", KINDS)
def test_chip_smoke_float64_sums_keep_the_schemes_roundings(kind):
    """``trsm_plain_f64_sums``, the sum-order reading phase 5b prints: the
    plain scheme's inverses and four roundings with float64 sums.  At one
    block row (one rounded product) it lies within one bf16 ulp of the
    largest output of ``trsm_plain``; past one block row within
    ``TRSM_BF16_TOL`` of ``trsm_plain`` and of the reference's bf16 run."""
    cs = _chip_smoke()
    (a, b), alpha = _operands(kind, "stack", (300, 300))
    ta, tb = _port((a, b))
    got = cs.trsm_plain_f64_sums(ta, tb, bm=64, alpha=alpha)
    assert got.dtype == torch.bfloat16 and got.shape == tb.shape
    plain = T.trsm_plain(ta, tb, bm=64, alpha=alpha)
    assert cs._rel_err(got, plain) <= cs.TRSM_BF16_TOL
    ref = torch.from_numpy(_reference(kind, "stack", (300, 300), 64))
    assert cs._rel_err(got, ref) <= cs.TRSM_BF16_TOL
    one = cs.trsm_plain_f64_sums(ta[0, :64, :64], tb[0, :64], bm=64,
                                 alpha=alpha)
    assert cs._rel_err(one, T.trsm_plain(ta[0, :64, :64], tb[0, :64],
                                         bm=64, alpha=alpha)) <= cs.BF16_TOL


def _readings() -> None:
    """The readings behind this file's limits, printed: each kind of
    operand's distance (relative to the largest output) of the port's bf16
    scheme from the reference's bf16 run over every case, of the port's
    float32 scheme rounded once at the end (every intermediate float32),
    and of both from a float64 solve of the same bf16 values."""
    for kind in KINDS:
        port, f32, exact = [], [], []
        for case in sorted(CASES):
            for dims in DIMS:
                for bm in BMS:
                    operands, alpha = _operands(kind, case, dims)
                    ta, tb = _port(operands)
                    ref = _reference(kind, case, dims, bm)
                    got = _run((ta, tb), alpha, bm).double().numpy()
                    once = T.trsm(ta.float(), tb.float(), bm=bm, bn=bm,
                                  alpha=alpha).bfloat16().double().numpy()
                    x64 = torch.linalg.solve_triangular(
                        torch.tril(ta.double()), alpha * tb.double(),
                        upper=False).numpy()
                    port.append(_rel(got, ref))
                    f32.append(_rel(once, ref))
                    exact.append((_rel(got, x64), _rel(ref, x64)))
        print(f"{kind}: port vs reference {min(port):.3e} to "
              f"{max(port):.3e} (limit {RTOL[kind]:.3e}); float32 "
              f"intermediates rounded once vs reference {min(f32):.3e} to "
              f"{max(f32):.3e}; vs float64: port up to "
              f"{max(p for p, _ in exact):.3e}, reference up to "
              f"{max(r for _, r in exact):.3e} (limit {REF_TOL})")


if __name__ == "__main__":
    _readings()
