"""The port's SYRK and SYR2K on bfloat16 operands against the reference
package's (``syrk_pallas`` and ``syr2k_pallas`` in interpret mode: bf16 in,
a float32 accumulator, the output in A's dtype), under each of the three
variants against the reference run under the same variant knob.

On the CPU the port's ``run_op`` computes the kernels' plain version
(``rank_k_plain``: float32 products and sums, one rounding to bf16, the
rounded lower triangle mirrored under ``tri`` and ``tri_packed``); the
tensor-core kernels themselves (``csrc/rank_k_bf16.cu``,
``csrc/rank_k_packed_bf16.cu``, on the wgmma loop) are held to the same
plain version on the card by ``test_torch_gpu.py`` and ``chip_smoke.py``;
here their launch parameters' and block order's Python mirrors are
checked against the card's limits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.knobs as ref_knobs
import repro.kernels.ops as ref_ops
from repro_torch.core import AdsalaRuntime
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels import syrk as K
from repro_torch.serving import BlasService, ServeConfig
from test_torch_gpu import _chip_smoke

#: one bf16 ulp of each element: two roundings of float32 sums that differ
#: only in their order land at most one ulp apart
RTOL = 2.0 ** -7
#: the reference's own bound for its bf16 kernels against float32
#: (tests/test_kernels.py::test_pallas_bf16)
REF_TOL = 0.05
#: test_pallas_bf16's dims and a ragged shape (n, k)
DIMS = ((128, 128), (100, 130))
CASES = ("plain", "beta", "stack")
OPS = ("syrk", "syr2k")
VARIANTS = ("full", "tri", "tri_packed")
WAIT = 120


def _ids(d):
    return "x".join(map(str, d))


def _operands(op, case, dims, seed=3):
    """Seeded float32 numpy operands of ``op`` (A, B for syr2k, then C) and
    the call's keywords; both packages round the same values to bf16
    (round to nearest even).  C is not symmetric: ``full`` adds it as
    given, ``tri`` and ``tri_packed`` its lower triangle."""
    rng = np.random.default_rng(seed)
    n, k = dims
    lead = (3,) if case == "stack" else ()

    def rand(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)

    xs = (rand(n, k),) if op == "syrk" else (rand(n, k), rand(n, k))
    if case == "plain":
        return xs, {}
    return (*xs, rand(n, n)), {"alpha": 0.5, "beta": 2.0}


def _port(operands):
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in operands)


def _ref_knob(variant):
    return ref_knobs.Knob((("bk", 128), ("bm", 128), ("bn", 128),
                           ("variant", variant)))


def _port_knob(op, variant):
    return next(k for k in ops.knob_space_for(op)
                if k["variant"] == variant and k["bm"] == 128
                and k["bn"] == 64)


@functools.lru_cache(maxsize=None)
def _reference(op, case, dims, variant):
    """The reference's bf16 run of a case as float64 numpy, and the same
    bf16 values as the port's operands (checked equal)."""
    operands, kw = _operands(op, case, dims)
    port = _port(operands)
    ref = tuple(jnp.asarray(x, jnp.bfloat16) for x in operands)
    for p, r in zip(port, ref):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(r.astype(jnp.float32)))
    out = ref_ops.run_op(op, ref, backend="pallas", knob=_ref_knob(variant),
                         interpret=True, **kw)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32), np.float64)


def _oracle(op, operands, variant, alpha=1.0, beta=0.0):
    """float64 of the bf16-rounded operands under ``variant``'s C
    semantics and mirror."""
    xs = [x.double() for x in operands]
    a = xs[0]
    if op == "syrk":
        out = alpha * (a @ a.mT)
    else:
        b = xs[1]
        out = alpha * (a @ b.mT + b @ a.mT)
    c = xs[-1] if len(xs) == (2 if op == "syrk" else 3) else None
    if c is not None and beta != 0.0:
        out = out + beta * (c if variant == "full" else torch.tril(c))
    if variant != "full":
        out = torch.tril(out) + torch.tril(out, -1).mT
    return out.numpy()


def _atol(op, port, alpha=1.0, beta=0.0):
    """float32 sums taken in another order (syrk k, syr2k 2k products a
    sum, each at most max|A| max|B|) and the float32 epilogue's rounding
    of beta C, as chip_smoke's limit allows for them."""
    cs = _chip_smoke()
    return cs._bf16_slack(op, port, alpha, beta)


def _run(op, port, kw, variant):
    got = ops.run_op(op, port, knob=_port_knob(op, variant), device="cpu",
                     **kw)
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    return got


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("op", OPS)
def test_rank_k_bf16_matches_reference_pallas(op, variant, case, dims):
    operands, kw = _operands(op, case, dims)
    port = _port(operands)
    got = _run(op, port, kw, variant).double().numpy()
    want = _reference(op, case, dims, variant)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=_atol(op, port, **kw))


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("op", OPS)
def test_rank_k_bf16_within_the_reference_tolerance_of_float64(op, variant,
                                                               case, dims):
    operands, kw = _operands(op, case, dims)
    port = _port(operands)
    want = _oracle(op, port, variant, **kw)
    scale = np.abs(want).max()
    got = _run(op, port, kw, variant).double().numpy()
    assert np.abs(got - want).max() / scale < REF_TOL
    ref = _reference(op, case, dims, variant)
    assert np.abs(ref - want).max() / scale < REF_TOL


#: a wrong dtype for one operand or all: B (syr2k) or C (syrk) float32
#: beside bf16, float16 and float64 throughout
_BAD = {"mixed": lambda xs: (xs[0], xs[1].float(), *xs[2:]),
        "float16": lambda xs: tuple(x.half() for x in xs),
        "float64": lambda xs: tuple(x.double() for x in xs)}


@pytest.mark.parametrize("bad", sorted(_BAD))
@pytest.mark.parametrize("op", OPS)
def test_rank_k_bf16_rejects_mixed_and_other_dtypes(op, bad):
    a, b, c = (torch.randn(6, 5).bfloat16(), torch.randn(6, 5).bfloat16(),
               torch.randn(6, 6).bfloat16())
    if op == "syrk":
        xs = (a, c)

        def fn(a, c):
            return K.syrk(a, c, beta=1.0, bm=64, bk=16)
    else:
        xs = (a, b, c)

        def fn(a, b, c):
            return K.syr2k(a, b, c, beta=1.0, bm=64, bk=16)
    with pytest.raises(TypeError, match="all of one dtype"):
        fn(*_BAD[bad](xs))
    assert fn(*xs).dtype == torch.bfloat16


@pytest.mark.parametrize("lead", ((), (3,)), ids=("single", "stack"))
@pytest.mark.parametrize("op", OPS)
def test_rank_k_bf16_c_strict_upper_triangle_changes_no_bit(op, lead):
    """NaN in C's strict upper triangle gives the bits of zeros there under
    ``tri`` and ``tri_packed`` (C is read as lower-stored), and the two
    variants give the same bits."""
    operands, kw = _operands(op, "stack" if lead else "beta", (100, 130))
    *xs, c = _port(operands)
    upper = torch.ones(100, 100, dtype=torch.bool).triu(1)
    nans = torch.where(upper, torch.tensor(float("nan"), dtype=c.dtype), c)
    zeros = torch.where(upper, torch.zeros((), dtype=c.dtype), c)
    outs = {}
    for variant in ("tri", "tri_packed"):
        got = _run(op, (*xs, nans), kw, variant)
        want = _run(op, (*xs, zeros), kw, variant)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert torch.equal(got.view(torch.int16),
                           got.mT.contiguous().view(torch.int16))
        outs[variant] = got
    assert torch.equal(outs["tri"].view(torch.int16),
                       outs["tri_packed"].view(torch.int16))


@pytest.mark.parametrize("op", OPS)
def test_rank_k_bf16_decision_is_the_default_knob_at_two_bytes(op):
    """A bf16 call asks the runtime under its 2-byte key, finds no model
    (installs are float32 only) and takes the backend's default knob."""
    operands, kw = _operands(op, "beta", (100, 130))
    rt = AdsalaRuntime()
    ops.run_op(op, _port(operands), runtime=rt, device="cpu", **kw)
    stats = rt.stats.for_backend("hopper")
    assert stats.default_calls == 1 and stats.model_evals == 0
    assert not rt.has(op, 2, "hopper")


def test_service_keeps_bf16_and_float32_syrk_apart():
    """bf16 and float32 syrk requests of one shape land in buckets of
    their own (the key holds the dtype bytes), and every result keeps its
    request's dtype and equals its plain version."""
    rng = np.random.default_rng(6)
    reqs = []
    for i in range(12):
        a = torch.from_numpy(rng.standard_normal((32, 24), np.float32))
        reqs.append((a.to((torch.bfloat16, torch.float32)[i % 2]),))
    rt = AdsalaRuntime()
    with BlasService(runtime=rt, config=ServeConfig(max_batch=8,
                                                    linger_ms=2.0, workers=2),
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("syrk", xs) for xs in reqs]]
        assert svc.drain(timeout=60)
    variant = ops.default_knob("syrk")["variant"]
    for xs, out in zip(reqs, outs):
        assert out.dtype == xs[0].dtype
        assert torch.equal(out, K.rank_k_plain(xs[0], variant=variant))
    keys = {key for key in rt.stats.buckets if key[0] == "hopper"}
    assert keys == {("hopper", "syrk", nbytes, (32, 24))
                    for nbytes in (2, 4)}
    assert svc.stats.completed == len(reqs) and svc.stats.failed == 0


@pytest.mark.parametrize("bm,bk", sorted(K.TILES))
def test_rank_k_bf16_launch_params_fit_the_card(bm, bk):
    """Both bf16 rank-k kernels run the wgmma loop's ``bm x bm`` tile in
    one pass, a warpgroup per 64 rows, at a step of 64 contraction indices
    whatever the knob's ``bk``: a stage of two K-major ``bm x 64`` regions
    of 128-byte rows under the 128-byte swizzle, each region and the stage
    on the swizzle's 1024-byte repeat; 2-16 stages, as many as fit in the
    SM's shared memory over the blocks an SM is meant to hold; the
    epilogue's rounded ``bm x (bm + 2)`` park inside the ring, and the
    transposed reads of 32 neighbouring park rows in distinct banks."""
    p = K.rank_k_params(bm, bk, torch.bfloat16)
    assert p == K.rank_k_params(bm, 64, torch.bfloat16)
    assert p["step"] == K.BF16_STEP == 64 and p["swizzle"] == 2 * 64
    assert p["pass"] == (bm, bm) and p["passes"] == 1
    assert p["warpgroups"] == bm // 64 and p["threads"] == 128 * (bm // 64)
    # a thread's bm / 2 accumulators and 64 registers beside them, over
    # the SM's 2048 threads of 64K registers
    assert p["blocks"] == min(4, 512 // (p["warpgroups"] * (bm // 2 + 64)))
    region = bm * 2 * K.BF16_STEP
    stage = 2 * region
    assert region % G.SWIZZLE_REPEAT == 0 and stage % G.SWIZZLE_REPEAT == 0
    budget = G.SMEM_SM // p["blocks"] - 4 * G.SWIZZLE_REPEAT
    assert 2 <= p["stages"] <= G.WGMMA_MAX_STAGES
    assert p["stages"] * stage <= budget
    assert p["stages"] == G.WGMMA_MAX_STAGES or \
        (p["stages"] + 1) * stage > budget
    ring = p["stages"] * stage
    assert p["park"] == 2 * bm * (bm + 2) <= ring
    assert p["smem"] == max(G.SWIZZLE_REPEAT + p["stages"] * (stage + 16),
                            p["park"]) <= G.SMEM_MAX
    assert p["blocks"] * (p["smem"] + 1024) <= G.SMEM_SM
    words = (bm + 2) // 2
    assert len({(r * words) % 32 for r in range(32)}) == 32
    # the float32 kernels' parameters are their own
    assert K.rank_k_params(bm, bk)["park"] == 4 * bm * (bm + 1)
    assert "step" not in K.rank_k_params(bm, bk)


@pytest.mark.parametrize("variant", VARIANTS)
def test_rank_k_bf16_block_order_is_a_bijection(variant):
    """The bf16 kernels' block order (``tile_of_block``, the mirror of
    ``csrc/rank_k_tile_bf16.cuh``'s maps) sends every launched block of
    the variant's grid to a distinct tile inside the grid, at every nb of
    1-300; ``tri_packed`` covers exactly the tiles on and below the
    diagonal, and under ``tri`` the blocks that return at once (j > i) are
    exactly the tiles above it.  The blocks in flight cover compact groups:
    the first ``BLOCK_GROUP * nb`` blocks of ``full`` lie in the first
    ``BLOCK_GROUP`` tile rows."""
    for nb in range(1, 301):
        blocks = nb * (nb + 1) // 2 if variant == "tri_packed" else nb * nb
        i, j = K.tile_of_block(variant, nb, torch.arange(blocks))
        assert bool(((0 <= j) & (j < nb) & (0 <= i) & (i < nb)).all()), nb
        assert torch.unique(i * nb + j).numel() == blocks, nb
        if variant == "tri_packed":
            assert bool((j <= i).all()), nb
        elif variant == "tri":
            returning = j > i
            assert int(returning.sum()) == nb * (nb - 1) // 2, nb
            assert torch.unique(i[~returning] * nb + j[~returning]).numel() \
                == nb * (nb + 1) // 2
        else:
            first = min(K.BLOCK_GROUP, nb) * nb
            assert bool((i[:first] < K.BLOCK_GROUP).all()), nb
    assert K.tile_of_block(variant, 40, 0) == (0, 0)


@pytest.mark.parametrize("variant,dtype,kernel", (
    ("full", torch.float32, "rank_k"), ("tri", torch.float32, "rank_k"),
    ("tri_packed", torch.float32, "rank_k_packed"),
    ("full", torch.bfloat16, "rank_k_bf16"),
    ("tri", torch.bfloat16, "rank_k_bf16"),
    ("tri_packed", torch.bfloat16, "rank_k_packed_bf16")))
def test_chip_smoke_names_the_rank_k_kernel_of_each_dtype(variant, dtype,
                                                          kernel):
    """Phase 5b's launch gates expect the kernel the wrapper records."""
    cs = _chip_smoke()
    for op in OPS:
        assert cs.kernel_of(op, {"variant": variant}, dtype) == kernel
        assert cs._expected_launches(op, {"variant": variant}, dtype) == \
            {kernel: 1}
    form = "rank_k_packed" if variant == "tri_packed" else "rank_k"
    assert K.KERNEL_OF[dtype][form][0] == kernel
    assert kernel in cs.KERNELS
    assert dtype == torch.float32 or kernel in cs.PRECOND_BF16_KERNELS


def test_chip_smoke_bf16_bounds_of_the_rank_k_calls():
    """The bf16 bounds phase 7 prints for phase 5b's rank-k calls: the
    BLAS count (syrk n^2 k, syr2k 2 n^2 k) at 989.4 TFLOP/s lies above the
    bytes at 3.35 TB/s, 2 bytes an element, for the three big calls; the
    stacks are bound by their bytes."""
    cs = _chip_smoke()
    rank_k = [c for c in cs.bf16_precond_cases()
              if c["op"] in OPS]
    got = [(round(ms, 4), by) for ms, by in
           (cs._bound(c["op"], c["shapes"], c["kw"], bf16=True)
            for c in rank_k)]
    assert got[:3] == [(0.2431, "operations"), (0.8508, "operations"),
                       (0.1389, "operations")]
    assert [by for _, by in got[3:]] == ["bytes", "bytes"]
    flops, nbytes = cs._work("syrk", rank_k[0]["shapes"], rank_k[0]["kw"],
                             2)
    assert flops == 4096 * 4096 * 14336
    assert nbytes == 2 * (4096 * 14336 + 4096 * 4096 + 4096 * 4097 / 2)


@pytest.mark.parametrize("op", OPS)
def test_chip_smoke_bf16_limit_rejects_a_wrong_rank_k_kernel(op):
    """The limit phases 3 and 5b hold a bf16 rank-k kernel to (each element
    within one bf16 ulp of plain's, beside the float32 slack) passes the
    plain version against itself and the reference's kernel, and rejects
    what a kernel that drops its first k-step of 16, or beta C, would give
    at the shape of the preconditioner's L = G G^T update cut to (256,
    1024) (alpha 0.05, beta 0.95, C symmetric)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(7)
    n, k = 256, 1024
    xs = [rng.standard_normal((n, k)).astype(np.float32)
          for _ in range(1 if op == "syrk" else 2)]
    c = rng.standard_normal((n, n)).astype(np.float32)
    operands = (*xs, (0.5 * (c + c.T)).astype(np.float32))
    kw = {"alpha": 0.05, "beta": 0.95}
    port = _port(operands)
    *ys, cc = port
    b = ys[1] if op == "syr2k" else None
    plain = K.rank_k_plain(ys[0], b, cc, **kw)
    slack = cs._bf16_slack(op, port, **kw)
    ref = ref_ops.run_op(op, tuple(jnp.asarray(x, jnp.bfloat16)
                                   for x in operands),
                         backend="pallas", knob=_ref_knob("full"),
                         interpret=True, **kw)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert cs._bf16_excess(plain, plain, slack) == 0.0
    assert cs._bf16_excess(ref, plain, slack) <= 1.0
    dropped = [y[:, 16:] for y in ys]
    wrong_k = K.rank_k_plain(dropped[0], dropped[1] if b is not None
                             else None, cc, **kw)
    wrong_c = K.rank_k_plain(ys[0], b, None, alpha=kw["alpha"])
    assert cs._bf16_excess(wrong_k, plain, slack) > 1.0
    assert cs._bf16_excess(wrong_c, plain, slack) > 1.0


def test_rank_k_variants_script_applies_to_the_checkout(tmp_path):
    """``scripts/torch_rank_k_variants.py`` times the bf16 rank-k kernels
    under variants that change one constant of ``csrc/`` each: every
    substitution applies exactly once to this checkout's sources, and
    ``base`` is the sources as they are."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_rank_k_variants.py"
    spec = importlib.util.spec_from_file_location("rank_k_variants", path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    from repro_torch.kernels import _build
    for name in variants.VARIANTS:
        out = variants.csrc_copy(name, tmp_path)
        changed = sorted(p.name for p in out.iterdir()
                         if p.read_text() != (_build.CSRC / p.name)
                         .read_text())
        assert changed == sorted({f for f, _, _ in
                                  variants.VARIANTS[name]}), name
    assert variants.VARIANTS["base"] == []
