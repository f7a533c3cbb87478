"""SYRK / SYR2K parity: the port's ``run_op("syrk" | "syr2k", ...)`` under
every kernel variant against the reference package's Pallas rank-k kernels
(interpret mode) under the same variant, on the same seeded numpy inputs,
both held to a float64 oracle; the variants' C semantics; and the kernel
wrappers' checks.  The kernels themselves are tested on the card by
``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import repro.core.knobs as ref_knobs
import repro.kernels.ops as ref_ops
from repro_torch.backends.conformance import oracle
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import syrk as K
from repro_torch.kernels.introspect import launch_counts

#: float32 tolerance of the reference conformance harness
TOL = 5e-4

#: the reference's RAGGED_DIMS["syrk"] (backends/conformance.py) + aligned
DIMS = ((129, 257), (1, 384), (300, 300), (256, 384))
VARIANTS = ("full", "tri", "tri_packed")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _case(op, name, dims, seed=0):
    """Operands (A[, B][, C]) and keywords; C is not symmetric, so the
    variants' C semantics show."""
    rng = np.random.default_rng(seed)
    n, k = dims
    lead = (3,) if name == "stack" else ()

    def rand(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)

    ab = (rand(n, k),) if op == "syrk" else (rand(n, k), rand(n, k))
    if name == "plain":
        return ab, {}
    kw = {"alpha": 0.5, "beta": 2.0} if name == "beta" \
        else {"alpha": 1.5, "beta": -1.0}
    return ab + (rand(n, n),), kw


def _knobs(op, variant):
    """A port knob and a reference knob of ``variant``."""
    port = next(k for k in ops.knob_space_for(op)
                if k["variant"] == variant and k["bm"] == 64
                and k["bn"] == 32)
    ref = ref_knobs.Knob((("bk", 128), ("bm", 128), ("bn", 128),
                          ("variant", variant)))
    return port, ref


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("case", ("plain", "beta", "stack"))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_run_op_matches_reference_pallas(op, variant, case, dims):
    operands, kw = _case(op, case, dims)
    port_knob, ref_knob = _knobs(op, variant)
    want = oracle(op, operands, variant=variant, **kw)
    got = ops.run_op(op, operands, knob=port_knob, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < TOL
    ref = np.asarray(ref_ops.run_op(op, operands, backend="pallas",
                                    knob=ref_knob, interpret=True, **kw))
    assert _rel(ref, want) < TOL
    assert _rel(got.numpy(), ref.astype(np.float64)) < TOL


@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_full_adds_c_as_given_like_the_reference(op):
    """The reference's Pallas ``full`` adds a non-symmetric C as it is, both
    triangles; ``tri``/``tri_packed`` read C as lower-stored.  The port
    keeps both semantics."""
    operands, kw = _case(op, "beta", (129, 65), seed=4)
    c = operands[-1]
    results = {}
    for variant in VARIANTS:
        port_knob, ref_knob = _knobs(op, variant)
        got = ops.run_op(op, operands, knob=port_knob, device="cpu",
                         **kw).numpy()
        ref = np.asarray(ref_ops.run_op(op, operands, backend="pallas",
                                        knob=ref_knob, interpret=True, **kw))
        assert _rel(got, ref.astype(np.float64)) < TOL
        results[variant] = got
    full = results["full"]
    assert not np.allclose(full, full.T)            # C's upper half shows
    prod = full - kw["beta"] * c
    assert np.allclose(prod, prod.T, atol=1e-3)     # the product is symmetric
    for variant in ("tri", "tri_packed"):
        assert np.array_equal(results[variant], results[variant].T)
        assert not np.allclose(results[variant], full, atol=1e-2)


@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_run_op_under_every_knob_on_cpu(op):
    operands, kw = _case(op, "beta", (129, 257))
    for knob in ops.knob_space_for(op):
        want = oracle(op, operands, variant=knob["variant"], **kw)
        got = ops.run_op(op, operands, knob=knob, device="cpu", **kw)
        assert _rel(got.numpy(), want) < TOL


def test_default_and_served_knobs_pass_bn_as_the_contraction_block(
        monkeypatch):
    seen = {}

    def spy(a, b, c, **kw):
        seen.update(kw)
        return K.rank_k_plain(a, b, c, alpha=kw["alpha"], beta=kw["beta"],
                              variant=kw["variant"])

    monkeypatch.setattr(K, "_rank_k", spy)
    knob = next(k for k in ops.knob_space_for("syr2k")
                if (k["bm"], k["bn"], k["variant"]) == (128, 16, "tri"))
    operands, _ = _case("syr2k", "plain", (40, 24))
    ops.run_op("syr2k", operands, knob=knob, device="cpu")
    assert (seen["bm"], seen["bk"], seen["variant"]) == (128, 16, "tri")


@pytest.mark.parametrize("op", ("syrk", "syr2k"))
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(op):
    operands, kw = _case(op, "stack", (33, 9))
    ts = tuple(map(torch.from_numpy, operands))
    before = launch_counts()
    for variant in VARIANTS:
        if op == "syrk":
            got = K.syrk(ts[0], ts[1], bm=64, bk=16, variant=variant, **kw)
            want = K.rank_k_plain(ts[0], None, ts[1], variant=variant, **kw)
        else:
            got = K.syr2k(*ts, bm=64, bk=16, variant=variant, **kw)
            want = K.rank_k_plain(*ts, variant=variant, **kw)
        assert torch.equal(got, want)
    assert launch_counts() == before


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_version_matches_torch_reference_oracle(variant):
    operands, kw = _case("syr2k", "beta", (48, 32))
    a, b, c = map(torch.from_numpy, operands)
    assert torch.allclose(K.rank_k_plain(a, b, c, variant=variant, **kw),
                          port_ref.syr2k(a, b, c, variant=variant, **kw),
                          rtol=1e-5, atol=1e-5)
    assert torch.allclose(K.rank_k_plain(a, None, c, variant=variant, **kw),
                          port_ref.syrk(a, c, variant=variant, **kw),
                          rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["float64", "tile", "variant", "b_shape",
                                 "stride", "c_shape", "rank"])
def test_wrapper_refuses_what_the_kernels_do_not_take(bad):
    a, b = torch.randn(16, 8), torch.randn(16, 8)
    c, tile, variant = None, dict(bm=64, bk=16), "full"
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "tile":
        tile = dict(bm=256, bk=16)        # 1024 threads: not in the space
    elif bad == "variant":
        variant = "packed"
    elif bad == "b_shape":
        b = torch.randn(16, 9)
    elif bad == "stride":
        a = torch.randn(8, 16).t()
    elif bad == "c_shape":
        c = torch.randn(16, 12)
    elif bad == "rank":
        a, b = torch.randn(2, 2, 16, 8), torch.randn(2, 2, 16, 8)
    with pytest.raises((TypeError, ValueError)):
        K.syr2k(a, b, c, alpha=1.0, beta=1.0, variant=variant, **tile)


@pytest.mark.parametrize("op", ("syrk", "syr2k"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_makes_one_launch_with_vec_and_no_pass_after_it(
        monkeypatch, op, variant):
    """The launch half of the wrapper, with a recording launcher in place
    of the built library: one launch of the kernel of the variant and the
    operands' dtype with its C symbol, the tile, the flags (``two``, ``tri``
    for ``rank_k.cu`` and ``rank_k_bf16.cu``, ``has_c``) and ``vec`` (true
    for aligned operands, false for a view with an unaligned leading
    stride), the recorded grid, and no tensor op at all around it: ``tri``
    is stored with its mirror by the kernel, not by a pass after it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import introspect as I
    calls, dispatched = [], []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            dispatched.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    def launcher(name, argtypes, symbol=None):
        def fn(*args):
            assert len(args) == len(argtypes) + 1     # + the grid
            calls.append((name, symbol, args[:-1]))
            args[-1][:] = (7, 1, 3)
            return 0
        return fn

    monkeypatch.setattr(K._build, "launcher", launcher)
    two = op == "syr2k"
    form = "rank_k_packed" if variant == "tri_packed" else "rank_k"
    for dtype, kernel, symbol in (
            (torch.float32, form, f"repro_{form}_f32"),
            (torch.bfloat16, f"{form}_bf16", f"repro_{form}_bf16")):
        a, b, c = (torch.randn(3, 40, 24).to(dtype),
                   torch.randn(3, 40, 24).to(dtype),
                   torch.randn(3, 40, 40).to(dtype))
        # one element more a row: unaligned for either dtype
        wide = torch.zeros(3, 40, 25, dtype=dtype)
        wide[..., :24] = a
        for x, vec in ((a, 1), (wide[..., :24], 0)):
            out = torch.empty(3, 40, 40, dtype=dtype)
            with I.capture_launches() as launched, Ops():
                K._launch(x, b if two else None, c, out, 40, 24, 3, bm=128,
                          bk=32, alpha=0.5, beta=2.0, variant=variant,
                          stream=0)
            assert launched == [(kernel, (7, 1, 3))]
            assert dispatched == []
            name, sym, args = calls.pop()
            assert (name, sym) == (kernel, symbol) and args[:2] == (128, 32)
            assert args[6:9] == (40, 24, 3)
            assert args[9:17] == (x.stride(0), x.stride(1),
                                  960 if two else 0, 24 if two else 0,
                                  1600, 40, 1600, 40)
            # alpha, beta, then the stream and no launch events outside a
            # window
            assert args[17:19] == (0.5, 2.0) and args[-3:] == (0, None, None)
            flags = args[19:-3]
            assert flags == ((int(two), 1, vec) if form == "rank_k_packed"
                             else (int(two), int(variant == "tri"), 1,
                                   vec)), flags

