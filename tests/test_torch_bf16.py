"""The port's GEMM on bfloat16 operands against the reference package's
(``gemm_pallas`` in interpret mode: bf16 in, a float32 accumulator, the
output in A's dtype), and the routed smoke models at their configs' own
``compute_dtype="bfloat16"`` against the reference's on the same weights.

On the CPU the port's ``run_op`` computes the kernel's plain version
(``gemm_plain``: float32 products and sums, one rounding to bf16); the
tensor-core kernel itself (``csrc/gemm_bf16.cu``) is held to the same
plain version on the card by ``test_torch_gpu.py`` and ``chip_smoke.py``.
symm and trmm take bf16 too (``test_torch_bf16_symm_trmm.py``), as do
syrk and syr2k (``test_torch_bf16_rank_k.py``) and trsm
(``test_torch_bf16_trsm.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.kernels.ops as ref_ops
from repro.core.runtime import AdsalaRuntime as RefRuntime
from repro.models import transformer as rtf
import repro_torch.configs as pconfigs
from repro_torch.core import AdsalaRuntime
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels.trsm import trsm_params
from repro_torch.models import transformer as ptf

#: one bf16 ulp at the top binade: two roundings of float32 sums that
#: differ only in their order land at most one ulp apart
RTOL = 2.0 ** -7
#: the reference's own bound for its bf16 kernels against float32
#: (tests/test_kernels.py::test_pallas_bf16)
REF_TOL = 0.05
#: test_pallas_bf16's dims, a ragged shape (the reference's padding case)
DIMS = ((128, 128, 128), (100, 50, 130))
CASES = ("plain", "beta", "stack", "shared_b")


def _operands(case, dims, seed=3):
    """Seeded float32 numpy operands and the call's keywords; both
    packages round the same values to bf16 (round to nearest even)."""
    rng = np.random.default_rng(seed)
    m, k, n = dims

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if case == "plain":
        return (rand(m, k), rand(k, n)), {}
    if case == "beta":
        return (rand(m, k), rand(k, n), rand(m, n)), {"alpha": 0.5,
                                                      "beta": 2.0}
    if case == "stack":
        return (rand(3, m, k), rand(3, k, n), rand(3, m, n)), {"alpha": 1.5,
                                                               "beta": -1.0}
    if case == "shared_b":
        return (rand(3, m, k), rand(k, n)), {}
    raise ValueError(case)


def _both(operands):
    """The operands as bf16 tensors for the port and bf16 arrays for the
    reference, checked to hold the same values."""
    port = tuple(torch.from_numpy(x).to(torch.bfloat16) for x in operands)
    ref = tuple(jnp.asarray(x, jnp.bfloat16) for x in operands)
    for p, r in zip(port, ref):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(r.astype(jnp.float32)))
    return port, ref


def _oracle(operands, alpha=1.0, beta=0.0):
    """float64 of the bf16-rounded operands."""
    xs = [x.double().numpy() for x in operands]
    out = alpha * (xs[0] @ xs[1])
    if len(xs) == 3 and beta != 0.0:
        out = out + beta * xs[2]
    return out


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("case", CASES)
def test_gemm_bf16_matches_reference_pallas(case, dims):
    operands, kw = _operands(case, dims)
    port, ref = _both(operands)
    got = ops.run_op("gemm", port, device="cpu", **kw)
    want = ref_ops.run_op("gemm", ref, backend="pallas", interpret=True,
                          **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape
    got = got.double().numpy()
    want = np.asarray(want.astype(jnp.float32), np.float64)
    k = dims[1]
    a, b = (x.double().abs().max().item() for x in port[:2])
    atol = k * 2.0 ** -22 * a * b
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("case", CASES)
def test_gemm_bf16_within_the_reference_tolerance_of_float64(case, dims):
    operands, kw = _operands(case, dims)
    port, ref = _both(operands)
    want = _oracle(port, **kw)
    scale = np.abs(want).max()
    got = ops.run_op("gemm", port, device="cpu", **kw).double().numpy()
    assert np.abs(got - want).max() / scale < REF_TOL
    out = ref_ops.run_op("gemm", ref, backend="pallas", interpret=True, **kw)
    out = np.asarray(out.astype(jnp.float32), np.float64)
    assert np.abs(out - want).max() / scale < REF_TOL


def test_gemm_rejects_mixed_and_other_dtypes():
    a = torch.randn(4, 8).bfloat16()
    b = torch.randn(8, 3).bfloat16()
    with pytest.raises(TypeError, match="all of one dtype"):
        G.gemm(a, b.float(), bm=64, bk=16, bn=64)
    with pytest.raises(TypeError, match="all of one dtype"):
        G.gemm(a, b, torch.zeros(4, 3), beta=1.0, bm=64, bk=16, bn=64)
    with pytest.raises(TypeError):
        G.gemm(a.half(), b.half(), bm=64, bk=16, bn=64)
    assert G.gemm(a, b, bm=64, bk=16, bn=64).dtype == torch.bfloat16


def test_vec_aligned_counts_bytes():
    """16-byte copies take strides of 8 bf16 elements, 4 float32 ones."""
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    assert G.vec_aligned((x, 64, 0), (x, 8, 512))
    assert not G.vec_aligned((x, 4, 0))
    assert G.vec_aligned((x.float(), 4, 0))
    assert not G.vec_aligned((x, 65, 0))


def test_bf16_mainloop_params_fit_the_card():
    """Every tile's bf16 ring fits the shared memory of the blocks an SM is
    meant to hold, with at least 2 stages, one warpgroup per 64 rows of a
    pass of at most 128 rows and every column but in 256x256 (wgmma's
    m64nNk16, N <= 256), the accumulators and 64 more registers a thread
    within a register partition, and A's rows swizzled over their 2 bk
    bytes (the mirror of ``csrc/bf16_wgmma_mainloop.cuh``)."""
    for bm, bk, bn in sorted(G.TILES):
        p = G.mainloop_params(bm, bk, bn, torch.bfloat16)
        pm, pn = p["pass"]
        assert pm == min(bm, 128) and pn <= 256 and pn % 64 == 0
        assert pn == (128 if (bm, bn) == (256, 256) else bn)
        assert p["passes"] * pm * pn == bm * bn
        assert p["warpgroups"] == pm // 64 in (1, 2)
        assert p["threads"] == 128 * p["warpgroups"]
        assert 1 <= p["blocks"] <= 4
        assert p["blocks"] * p["warpgroups"] * (pn // 2 + 64) <= 512
        assert p["swizzle"] == 2 * bk in (32, 64, 128)
        stage = 2 * bk * (pm + pn)
        assert stage % G.SWIZZLE_REPEAT == 0
        assert 2 <= p["stages"] <= G.WGMMA_MAX_STAGES
        # a group of 64 contraction indices in flight beside the next
        assert p["stages"] >= 2 * (64 // bk)
        assert p["smem"] == G.SWIZZLE_REPEAT + p["stages"] * (stage + 16)
        # the blocks fit the SM with 2 KB more each (static shared memory
        # and the card's reserve), and one block fits a block's limit
        assert p["blocks"] * (p["smem"] + 2048) <= G.SMEM_SM
        assert p["smem"] + 1024 <= G.SMEM_MAX
        # as deep as the budget allows
        budget = G.SMEM_SM // p["blocks"] - 4 * G.SWIZZLE_REPEAT
        assert p["stages"] == G.WGMMA_MAX_STAGES \
            or (p["stages"] + 1) * stage > budget
    # the default tile: four blocks an SM, each a ring of 13 stages of 4 KB
    p = G.mainloop_params(64, 16, 64, torch.bfloat16)
    assert (p["blocks"], p["stages"], p["smem"]) == (4, 13, 54480)
    # the bf16 trsm substitution's tile at a step of 64: the wgmma loop's
    # threads and passes, its own blocks an SM, ring and shared region
    p, t = G.mainloop_params(64, 64, 64, torch.bfloat16), \
        trsm_params(64, 64, torch.bfloat16)
    keep = ("pass", "passes", "threads", "warpgroups", "swizzle")
    assert {k: t[k] for k in keep} == {k: p[k] for k in keep}
    assert (t["blocks"], t["stages"], t["region"]) == (2, 6, 8192)


# ---------------------------------------------------------------------------
# the routed smoke models at their own bf16 compute dtype
# ---------------------------------------------------------------------------

B, S = 2, 16


def _cfgs(arch, **kw):
    kw = dict(use_pallas_gemm=True, **kw)
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **kw))


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.long)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _reference_passes(params, cfg, toks, dtype, nxt=None):
    """The reference's routed forward, prefill and one decode step under
    ``cfg``, caches in ``dtype``; the step is fed ``nxt``, or the
    prefill's greedy token when None."""
    batch = {"tokens": jnp.asarray(toks)}
    rt = RefRuntime()
    logits, _ = rtf.forward(params, batch, cfg, runtime=rt)
    caches = rtf.init_decode_state(cfg, B, S + 4, dtype=dtype)
    last, caches = rtf.prefill(params, batch, caches, cfg, runtime=rt)
    if nxt is None:
        nxt = np.asarray(jnp.argmax(last[:, -1:], -1).astype(jnp.int32))
    step, _ = rtf.decode_step(params, jnp.asarray(nxt), caches, cfg,
                              runtime=rt)
    assert rt.stats.for_backend("pallas").default_calls > 0     # routed
    return {"forward": logits, "prefill": last, "decode": step}, nxt


@pytest.fixture(scope="module", params=("llama3_8b", "deepseek_v2_lite"))
def bf16_pair(request):
    """Per arch: the reference's routed passes at the config's bf16 and at
    float32 on one seeded set of weights, and the port's model on them."""
    rcfg, pcfg = _cfgs(request.param)
    assert rcfg.compute_dtype == pcfg.compute_dtype == "bfloat16"
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (B, S),
                                             dtype=np.int32)
    ref, nxt = _reference_passes(params, rcfg, toks, jnp.bfloat16)
    f32 = dataclasses.replace(rcfg, compute_dtype="float32")
    ref32, _ = _reference_passes(params, f32, toks, jnp.float32, nxt)
    return {"pcfg": pcfg, "toks": toks, "next": nxt,
            "model": ptf.from_reference(pcfg, jax.tree.map(np.asarray,
                                                           params),
                                        device="cpu"),
            "ref": {k: np.asarray(v.astype(jnp.float32))
                    for k, v in ref.items()},
            "ref32": {k: np.asarray(v) for k, v in ref32.items()}}


def _limit(pair, name):
    """2 x the reference's own bf16-vs-float32 distance on this pass."""
    return 2.0 * _rel(pair["ref"][name], pair["ref32"][name])


def test_bf16_forward_matches_reference_routed(bf16_pair):
    rt = AdsalaRuntime()
    got, _ = ptf.forward(bf16_pair["model"], {"tokens": _t(bf16_pair["toks"])},
                         bf16_pair["pcfg"], runtime=rt)
    assert got.dtype == torch.bfloat16
    assert rt.stats.for_backend("hopper").default_calls > 0     # routed
    assert _rel(got.float(), bf16_pair["ref"]["forward"]) \
        < _limit(bf16_pair, "forward")


def test_bf16_prefill_and_decode_match_reference_routed(bf16_pair):
    cfg = bf16_pair["pcfg"]
    caches = ptf.init_decode_state(cfg, B, S + 4, dtype=torch.bfloat16,
                                   device="cpu")
    last, caches = ptf.prefill(bf16_pair["model"],
                               {"tokens": _t(bf16_pair["toks"])}, caches,
                               cfg, runtime=AdsalaRuntime())
    assert last.dtype == torch.bfloat16
    assert _rel(last.float(), bf16_pair["ref"]["prefill"]) \
        < _limit(bf16_pair, "prefill")
    step, _ = ptf.decode_step(bf16_pair["model"], _t(bf16_pair["next"]),
                              caches, cfg, runtime=AdsalaRuntime())
    assert step.dtype == torch.bfloat16
    assert _rel(step.float(), bf16_pair["ref"]["decode"]) \
        < _limit(bf16_pair, "decode")
