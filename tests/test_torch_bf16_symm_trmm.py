"""The port's SYMM and TRMM on bfloat16 operands against the reference
package's (``symm_pallas`` and ``trmm_pallas`` in interpret mode: bf16 in,
a float32 accumulator, the output in A's dtype), trmm under each of its
three variants against the reference run under the same variant knob.

On the CPU the port's ``run_op`` computes the kernels' plain versions
(``symm_plain``, ``trmm_plain``: float32 products and sums, one rounding
to bf16); the tensor-core kernels themselves (``csrc/symm_bf16.cu``,
``csrc/trmm_bf16.cu``, ``csrc/trmm_packed_bf16.cu``) are held to the same
plain versions on the card by ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.knobs as ref_knobs
import repro.kernels.ops as ref_ops
from repro_torch.core import AdsalaRuntime
from repro_torch.kernels import ops
from repro_torch.kernels import symm as S
from repro_torch.kernels import trmm as TM
from repro_torch.serving import BlasService, ServeConfig
from test_torch_gpu import _chip_smoke

#: one bf16 ulp at the top binade: two roundings of float32 sums that
#: differ only in their order land at most one ulp apart
RTOL = 2.0 ** -7
#: the reference's own bound for its bf16 kernels against float32
#: (tests/test_kernels.py::test_pallas_bf16)
REF_TOL = 0.05
#: test_pallas_bf16's dims and a ragged shape (m, n)
DIMS = ((128, 128), (100, 130))
SYMM_CASES = ("plain", "beta", "stack")
TRMM_CASES = ("plain", "stack")
VARIANTS = ("full", "tri", "tri_packed")
WAIT = 120


def _ids(d):
    return "x".join(map(str, d))


def _operands(op, case, dims, seed=3):
    """Seeded float32 numpy operands of ``op`` and the call's keywords;
    both packages round the same values to bf16 (round to nearest even)."""
    rng = np.random.default_rng(seed)
    m, n = dims
    lead = (3,) if case == "stack" else ()

    def rand(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)

    if op == "trmm":
        return (rand(m, m), rand(m, n)), ({"alpha": 0.5} if case == "stack"
                                          else {})
    if case == "plain":
        return (rand(m, m), rand(m, n)), {}
    if case == "beta":
        return (rand(m, m), rand(m, n), rand(m, n)), {"alpha": 0.5,
                                                      "beta": 2.0}
    return (rand(m, m), rand(m, n), rand(m, n)), {"alpha": 1.5, "beta": -1.0}


def _port(operands):
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in operands)


def _ref_knob(variant):
    return ref_knobs.Knob((("bk", 128), ("bm", 128), ("bn", 128),
                           ("variant", variant)))


def _port_knob(variant):
    return next(k for k in ops.knob_space_for("trmm")
                if k["variant"] == variant and k["bm"] == 64
                and k["bn"] == 128)


@functools.lru_cache(maxsize=None)
def _reference(op, case, dims, variant=None):
    """The reference's bf16 run of a case as float64 numpy, and the same
    bf16 values as the port's operands (checked equal)."""
    operands, kw = _operands(op, case, dims)
    port = _port(operands)
    ref = tuple(jnp.asarray(x, jnp.bfloat16) for x in operands)
    for p, r in zip(port, ref):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(r.astype(jnp.float32)))
    knob = None if variant is None else _ref_knob(variant)
    out = ref_ops.run_op(op, ref, backend="pallas", knob=knob,
                         interpret=True, **kw)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32), np.float64)


def _oracle(op, operands, alpha=1.0, beta=0.0):
    """float64 of the bf16-rounded operands."""
    xs = [x.double() for x in operands]
    if op == "symm":
        lower = torch.ones(xs[0].shape[-2:], dtype=torch.bool).tril()
        a = torch.where(lower, xs[0], xs[0].mT)
    else:
        a = torch.tril(xs[0])
    out = alpha * (a @ xs[1])
    if len(xs) == 3 and beta != 0.0:
        out = out + beta * xs[2]
    return out.numpy()


def _run(op, port, kw, variant=None):
    knob = None if variant is None else _port_knob(variant)
    got = ops.run_op(op, port, knob=knob, device="cpu", **kw)
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    return got


def _assert_close_to_reference(port, got, want):
    assert tuple(got.shape) == want.shape
    m = port[0].shape[-1]
    a, b = (x.double().abs().max().item() for x in port[:2])
    atol = m * 2.0 ** -22 * a * b
    np.testing.assert_allclose(got.double().numpy(), want, rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", SYMM_CASES)
def test_symm_bf16_matches_reference_pallas(case, dims):
    operands, kw = _operands("symm", case, dims)
    port = _port(operands)
    _assert_close_to_reference(port, _run("symm", port, kw),
                               _reference("symm", case, dims))


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", TRMM_CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_trmm_bf16_matches_reference_pallas(variant, case, dims):
    operands, kw = _operands("trmm", case, dims)
    port = _port(operands)
    _assert_close_to_reference(port, _run("trmm", port, kw, variant),
                               _reference("trmm", case, dims, variant))


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", SYMM_CASES)
def test_symm_bf16_within_the_reference_tolerance_of_float64(case, dims):
    operands, kw = _operands("symm", case, dims)
    port = _port(operands)
    want = _oracle("symm", port, **kw)
    scale = np.abs(want).max()
    got = _run("symm", port, kw).double().numpy()
    assert np.abs(got - want).max() / scale < REF_TOL
    ref = _reference("symm", case, dims)
    assert np.abs(ref - want).max() / scale < REF_TOL


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
@pytest.mark.parametrize("case", TRMM_CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_trmm_bf16_within_the_reference_tolerance_of_float64(variant, case,
                                                             dims):
    operands, kw = _operands("trmm", case, dims)
    port = _port(operands)
    want = _oracle("trmm", port, **kw)
    scale = np.abs(want).max()
    got = _run("trmm", port, kw, variant).double().numpy()
    assert np.abs(got - want).max() / scale < REF_TOL
    ref = _reference("trmm", case, dims, variant)
    assert np.abs(ref - want).max() / scale < REF_TOL


#: a wrong dtype for one operand or all: mixed with float32, float16 and
#: float64 throughout
_BAD = {"mixed_b": lambda xs: (xs[0], xs[1].float(), *xs[2:]),
        "float16": lambda xs: tuple(x.half() for x in xs),
        "float64": lambda xs: tuple(x.double() for x in xs)}


@pytest.mark.parametrize("bad", sorted(_BAD))
@pytest.mark.parametrize("op", ("symm", "trmm"))
def test_bf16_kernels_reject_mixed_and_other_dtypes(op, bad):
    xs = (torch.randn(6, 6).bfloat16(), torch.randn(6, 5).bfloat16())
    fn = (lambda a, b: S.symm(a, b, bm=64, bn=64)) if op == "symm" else \
        (lambda a, b: TM.trmm(a, b, bm=64, bn=64))
    with pytest.raises(TypeError, match="all of one dtype"):
        fn(*_BAD[bad](xs))
    assert fn(*xs).dtype == torch.bfloat16


def test_symm_bf16_rejects_a_c_of_another_dtype():
    a, b = torch.randn(6, 6).bfloat16(), torch.randn(6, 5).bfloat16()
    with pytest.raises(TypeError, match="all of one dtype"):
        S.symm(a, b, torch.zeros(6, 5), beta=1.0, bm=64, bn=64)
    assert S.symm(a, b, torch.zeros(6, 5).bfloat16(), beta=1.0, bm=64,
                  bn=64).dtype == torch.bfloat16


@pytest.mark.parametrize("lead", ((), (3,)), ids=("single", "stack"))
@pytest.mark.parametrize("op", ("symm", "trmm"))
def test_bf16_strict_upper_triangle_changes_no_bit(op, lead):
    """NaN above A's diagonal gives the bits of zeros there: neither op
    reads A's strict upper triangle (trmm under every variant)."""
    operands, kw = _operands(op, "stack" if lead else "plain", (100, 130))
    a, *rest = _port(operands)
    upper = torch.ones(100, 100, dtype=torch.bool).triu(1)
    nans = torch.where(upper, torch.tensor(float("nan"), dtype=a.dtype), a)
    zeros = torch.where(upper, torch.zeros((), dtype=a.dtype), a)
    for variant in (None,) if op == "symm" else VARIANTS:
        got = _run(op, (nans, *rest), kw, variant)
        want = _run(op, (zeros, *rest), kw, variant)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("op", ("symm", "trmm"))
def test_bf16_decision_is_the_default_knob_at_two_bytes(op):
    """A bf16 call asks the runtime under its 2-byte key, finds no model
    (installs are float32 only) and takes the backend's default knob."""
    operands, kw = _operands(op, "plain", (100, 130))
    rt = AdsalaRuntime()
    ops.run_op(op, _port(operands), runtime=rt, device="cpu", **kw)
    stats = rt.stats.for_backend("hopper")
    assert stats.default_calls == 1 and stats.model_evals == 0
    assert not rt.has(op, 2, "hopper")


def test_service_never_mixes_dtypes_in_a_bucket():
    """bf16 and float32 requests of one op and shape land in buckets of
    their own (the key holds the dtype bytes and names), and every result
    keeps its request's dtype and equals its plain version."""
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(12):
        a = torch.from_numpy(rng.standard_normal((32, 32), np.float32))
        b = torch.from_numpy(rng.standard_normal((32, 24), np.float32))
        op = ("symm", "trmm")[i % 2]
        dtype = (torch.bfloat16, torch.float32)[(i // 2) % 2]
        reqs.append((op, (a.to(dtype), b.to(dtype))))
    rt = AdsalaRuntime()
    with BlasService(runtime=rt, config=ServeConfig(max_batch=8,
                                                    linger_ms=2.0, workers=2),
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit(op, xs) for op, xs in reqs]]
        assert svc.drain(timeout=60)
    plain = {"symm": S.symm_plain, "trmm": TM.trmm_plain}
    for (op, xs), out in zip(reqs, outs):
        assert out.dtype == xs[0].dtype
        assert torch.equal(out, plain[op](*xs))
    keys = {key for key in rt.stats.buckets if key[0] == "hopper"}
    assert keys == {("hopper", op, nbytes, (32, 24))
                    for op in ("symm", "trmm") for nbytes in (2, 4)}
    assert svc.stats.completed == len(reqs) and svc.stats.failed == 0


@pytest.mark.parametrize("variant,dtype,kernel", (
    ("full", torch.float32, "trmm"), ("tri", torch.float32, "trmm"),
    ("tri_packed", torch.float32, "trmm_packed"),
    ("full", torch.bfloat16, "trmm_bf16"), ("tri", torch.bfloat16,
                                            "trmm_bf16"),
    ("tri_packed", torch.bfloat16, "trmm_packed_bf16")))
def test_chip_smoke_names_the_kernel_of_each_dtype(variant, dtype, kernel):
    """Phase 5b's launch gates expect the kernel the wrapper records."""
    cs = _chip_smoke()
    assert cs.kernel_of("trmm", {"variant": variant}, dtype) == kernel
    assert cs._expected_launches("trmm", {"variant": variant}, dtype) == \
        {kernel: 1}
    symm = "symm_bf16" if dtype == torch.bfloat16 else "symm"
    assert cs.kernel_of("symm", {"variant": "full"}, dtype) == symm
    assert set(cs.PRECOND_BF16_KERNELS) <= set(cs.KERNELS)
    from repro_torch.kernels import introspect as I
    assert tuple(cs.KERNELS) == I.KERNELS


def test_chip_smoke_bf16_bounds_of_the_preconditioner():
    """The bf16 bounds phase 7 prints for phase 5b's big calls: the useful
    operations at 989.4 TFLOP/s (2 m^2 n for symm, m^2 n for trmm) lie
    above the bytes at 3.35 TB/s, 2 bytes an element."""
    cs = _chip_smoke()
    big = {c["op"]: c["shapes"] for c in cs.bf16_precond_cases()
           if len(c["shapes"][0]) == 2}
    ms, by = cs._bound("symm", big["symm"], {}, bf16=True)
    assert by == "operations" and round(ms, 4) == 0.4862
    ms, by = cs._bound("trmm", big["trmm"], {}, bf16=True)
    assert by == "operations" and round(ms, 4) == 0.2431
    flops, nbytes = cs._work("trmm", big["trmm"], {}, 2)
    assert nbytes == 2 * (4096 * 4097 / 2 + 2 * 4096 * 14336)
