"""TRMM parity: the port's ``run_op("trmm", ...)`` under every kernel variant
against the reference package's Pallas TRMM (interpret mode) under the same
variant, on the same seeded numpy inputs, both held to a float64 oracle; the
knob space, default knob and Table-III feature rows of trmm; and the kernel
wrapper's checks.  The kernels themselves are tested on the card by
``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import repro.core.knobs as ref_knobs
import repro.kernels.ops as ref_ops
from repro_torch.backends.conformance import oracle
from repro_torch.core import knobs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import trmm as TM
from repro_torch.kernels.introspect import launch_counts

#: float32 tolerance of the reference conformance harness: max relative
#: error against float64 (the port and the reference sum in other orders)
TOL = 5e-4

#: the reference's RAGGED_DIMS["trmm"] (backends/conformance.py) + aligned
DIMS = ((129, 257), (1, 384), (300, 300), (256, 384))
VARIANTS = ("full", "tri", "tri_packed")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _case(name, dims, seed=0):
    rng = np.random.default_rng(seed)
    m, n = dims
    lead = (3,) if name == "stack" else ()

    def rand(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)

    kw = {} if name == "plain" else {"alpha": 0.5 if name == "alpha"
                                     else -1.5}
    return (rand(m, m), rand(m, n)), kw


def _knobs(variant):
    """A port knob and a reference knob of ``variant``."""
    port = next(k for k in ops.knob_space_for("trmm")
                if k["variant"] == variant and k["bm"] == 64
                and k["bn"] == 128)
    ref = ref_knobs.Knob((("bk", 128), ("bm", 128), ("bn", 128),
                          ("variant", variant)))
    return port, ref


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("case", ("plain", "alpha", "stack"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_run_op_matches_reference_pallas(variant, case, dims):
    operands, kw = _case(case, dims)
    want = oracle("trmm", operands, **kw)
    port_knob, ref_knob = _knobs(variant)
    got = ops.run_op("trmm", operands, knob=port_knob, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < TOL
    ref = np.asarray(ref_ops.run_op("trmm", operands, backend="pallas",
                                    knob=ref_knob, interpret=True, **kw))
    assert _rel(ref, want) < TOL
    assert _rel(got.numpy(), ref.astype(np.float64)) < TOL


def test_only_the_lower_triangle_of_a_is_read():
    (a, b), kw = _case("alpha", (129, 257))
    lower_only = np.where(np.tri(129, dtype=bool), a, np.float32(np.nan))
    for variant in VARIANTS:
        knob, _ = _knobs(variant)
        got = ops.run_op("trmm", (lower_only, b), knob=knob, device="cpu",
                         **kw)
        want = ops.run_op("trmm", (a, b), knob=knob, device="cpu", **kw)
        assert torch.equal(got, want), variant


def test_run_op_under_every_knob_on_cpu():
    operands, kw = _case("stack", (129, 257))
    want = oracle("trmm", operands, **kw)
    for knob in ops.knob_space_for("trmm"):
        got = ops.run_op("trmm", operands, knob=knob, device="cpu", **kw)
        assert _rel(got.numpy(), want) < TOL


def test_stacked_run_op_equals_its_items():
    (a, b), kw = _case("stack", (300, 40))
    knob, _ = _knobs("tri_packed")
    stacked = ops.run_op("trmm", (a, b), knob=knob, device="cpu", **kw)
    for i in range(3):
        one = ops.run_op("trmm", (a[i], b[i]), knob=knob, device="cpu", **kw)
        assert torch.allclose(one, stacked[i], rtol=1e-6, atol=1e-6)


def test_knob_variant_and_tile_reach_the_wrapper(monkeypatch):
    seen = {}
    real = TM.trmm

    def spy(a, b, **kw):
        seen.update(kw)
        return real(a, b, **kw)

    monkeypatch.setattr(TM, "trmm", spy)
    knob = next(k for k in ops.knob_space_for("trmm")
                if (k["bm"], k["bn"], k["variant"]) == (256, 64, "tri"))
    operands, _ = _case("plain", (40, 24))
    ops.run_op("trmm", operands, knob=knob, device="cpu", alpha=2.0)
    assert seen == {"bm": 256, "bn": 64, "alpha": 2.0, "variant": "tri"}


@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_passes_tile_variant_flag_and_vec_to_the_launcher(
        monkeypatch, variant):
    """The launch half of the wrapper, with a recording launcher in place
    of the built library: the kernel of the variant, the tile, the ``tri``
    flag (``trmm.cu`` only), ``vec`` true for aligned operands and false
    for a view with an unaligned leading stride, and the recorded grid."""
    from repro_torch.kernels import introspect as I
    calls = []

    def launcher(name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes) + 1     # + the grid
            calls.append((name, args[:-1]))
            args[-1][:] = (7, 8, 3)
            return 0
        return fn

    monkeypatch.setattr(TM._build, "launcher", launcher)
    a, b = torch.randn(3, 40, 40), torch.randn(3, 40, 24)
    wide = torch.zeros(3, 40, 41)
    wide[..., :40] = a
    kernel = "trmm_packed" if variant == "tri_packed" else "trmm"
    for x, vec in ((a, 1), (wide[..., :40], 0)):
        out = torch.empty(3, 40, 24)
        with I.capture_launches() as launched:
            TM._launch(x, b, out, 40, 24, 3, bm=128, bn=64, alpha=0.5,
                       variant=variant, stream=0)
        assert launched == [(kernel, (7, 8, 3))]
        name, args = calls.pop()
        assert name == kernel and args[:2] == (128, 64)
        assert args[5:8] == (40, 24, 3)
        assert args[8:14] == (x.stride(0), x.stride(1), 960, 24, 960, 24)
        # alpha, then the stream and no launch events outside a window
        assert args[14] == 0.5 and args[-3:] == (0, None, None)
        flags = args[15:-3]
        assert flags == ((vec,) if kernel == "trmm_packed"
                         else (int(variant == "tri"), vec)), flags


def test_space_has_24_candidates_in_blocks():
    space = ops.knob_space_for("trmm")
    pairs = {(bm, bn) for bm in (64, 128, 256) for bn in (64, 128, 256)} \
        - {(256, 256)}
    assert len(space) == 24
    assert {(k["bm"], k["bn"]) for k in space} == pairs == set(TM.TILES)
    assert {k["variant"] for k in space} == set(VARIANTS)
    assert all(k["bk"] == k["bm"] for k in space)
    assert space.name == "blocks"
    assert space._parallelism_fn is knobs._grid_parallelism
    assert {k["variant"] for k in ref_ops.knob_space_for("trmm")} == \
        set(VARIANTS)


def test_default_knob_is_max_parallelism():
    kd = ops.default_knob("trmm").dict
    assert (kd["bm"], kd["bn"], kd["variant"]) == (64, 64, "full")
    space = ops.knob_space_for("trmm")
    assert space.parallelism(ops.default_knob("trmm"), (4096, 4096)) == \
        space.parallelism_vec((4096, 4096)).max()


@pytest.mark.parametrize("dims", ((4096, 14336), (512, 512), (129, 257)))
def test_tri_packed_feature_row_differs_from_tri(dims):
    space = ops.knob_space_for("trmm")
    by = {(k["bm"], k["bn"], k["variant"]): space.parallelism(k, dims)
          for k in space}
    for bm, bn in TM.TILES:
        # full and tri launch the same grid and share a row, as in the
        # reference; tri_packed carries the packed fraction (cm + 1) / 2
        assert by[(bm, bn, "full")] == by[(bm, bn, "tri")]
        cm = -(-dims[0] // bm)
        if cm > 1:
            assert by[(bm, bn, "tri_packed")] < by[(bm, bn, "tri")]
        ref_knob = ref_knobs.Knob((("bk", bm), ("bm", bm), ("bn", bn),
                                   ("variant", "tri_packed")))
        assert by[(bm, bn, "tri_packed")] == \
            ref_knobs._grid_parallelism(ref_knob, dims)


def test_dims_of_matches_reference():
    for shapes in (((48, 48), (48, 40)), ((3, 129, 129), (3, 129, 257))):
        assert ops.dims_of("trmm", shapes) == \
            ref_ops.dims_of("trmm", tuple(s[-2:] for s in shapes))


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    (a, b), kw = _case("stack", (33, 9))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = launch_counts()
    for variant in VARIANTS:
        got = TM.trmm(ta, tb, bm=64, bn=64, variant=variant, **kw)
        assert torch.equal(got, TM.trmm_plain(ta, tb, **kw))
    assert launch_counts() == before


def test_plain_version_matches_torch_reference_oracle():
    (a, b), kw = _case("alpha", (48, 40))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.allclose(TM.trmm_plain(ta, tb, **kw),
                          port_ref.trmm(ta, tb, **kw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["float64", "tile", "variant", "square",
                                 "rows", "stride", "stack", "device"])
def test_wrapper_refuses_what_the_kernels_do_not_take(bad):
    a, b = torch.randn(16, 16), torch.randn(16, 12)
    tile, variant = dict(bm=64, bn=64), "tri"
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "tile":
        tile = dict(bm=256, bn=256)           # 1024 threads: not in the space
    elif bad == "variant":
        variant = "packed"
    elif bad == "square":
        a = torch.randn(16, 8)
    elif bad == "rows":
        b = torch.randn(9, 12)
    elif bad == "stride":
        b = torch.randn(12, 16).t()
    elif bad == "stack":
        b = torch.randn(2, 16, 12)
    elif bad == "device":
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises((TypeError, ValueError)):
        TM.trmm(a, b, alpha=1.0, variant=variant, **tile)
