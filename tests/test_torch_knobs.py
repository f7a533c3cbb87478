"""The port's Hopper knob space and its Table-III features, held against the
reference package's knob and feature code on the same seeded inputs."""

import numpy as np
import pytest

import repro.core.features as ref_features
import repro.core.knobs as ref_knobs
import repro.kernels.ops as ref_ops
from repro_torch.core import features, knobs
from repro_torch.kernels import ops

ALL_TILES = {(bm, bk, bn) for bm in (64, 128, 256) for bk in (16, 32, 64)
             for bn in (64, 128, 256)}


def _tiles(space):
    return {(k["bm"], k["bk"], k["bn"]) for k in space}


def test_hopper_space_holds_every_instantiated_tile():
    space = ops.knob_space_for("gemm")
    assert len(space) == 27
    assert _tiles(space) == ALL_TILES
    assert all(k["variant"] == "full" for k in space)
    # the registry and the compiled fast path key on this name and fn
    assert space.name == "blocks"
    assert space._parallelism_fn is knobs._grid_parallelism


def test_hopper_space_filters_by_shared_memory_and_threads():
    # at 8 bytes an element the 256x64x256 tiles need 256 KiB > 227 KB
    space = knobs.hopper_knob_space(dtype_bytes=8)
    assert _tiles(space) == ALL_TILES - {(256, 64, 256)}
    for bm, bk, bn in _tiles(knobs.hopper_knob_space()):
        assert 4 * bk * (bm + bn) <= knobs.HOPPER_SMEM_BYTES
        assert bm * bn // 64 <= knobs.HOPPER_MAX_THREADS


@pytest.mark.parametrize("kw", [{"bms": (32,)}, {"bks": (128,)},
                                {"bns": (512,)}])
def test_hopper_space_refuses_tiles_without_a_kernel(kw):
    with pytest.raises(ValueError):
        knobs.hopper_knob_space(**kw)


def test_sizes_restrict_the_mn_edges():
    space = ops.knob_space_for("gemm", sizes=(64, 128))
    assert _tiles(space) == {t for t in ALL_TILES if 256 not in (t[0], t[2])}


def test_default_knob_is_max_parallelism():
    kd = ops.default_knob("gemm").dict
    assert (kd["bm"], kd["bn"]) == (64, 64)
    assert kd["bk"] == 16
    space = ops.knob_space_for("gemm")
    par = space.parallelism_vec((4096, 4096, 4096))
    assert space.parallelism(ops.default_knob("gemm"),
                             (4096, 4096, 4096)) == par.max()


#: the 2-dim spaces: (bm, bn) pairs and variants
SPACES_2D = {
    "symm": ({(bm, bn) for bm in (64, 128, 256) for bn in (64, 128, 256)}
             - {(256, 256)}, ("full",)),
    "trsm": ({(bm, bn) for bm in (64, 128, 256) for bn in (64, 128, 256)}
             - {(256, 256)}, ("full",)),
    "trmm": ({(bm, bn) for bm in (64, 128, 256) for bn in (64, 128, 256)}
             - {(256, 256)}, ("full", "tri", "tri_packed")),
    "syrk": ({(bm, bn) for bm in (64, 128) for bn in (16, 32, 64)},
             ("full", "tri", "tri_packed")),
    "syr2k": ({(bm, bn) for bm in (64, 128) for bn in (16, 32, 64)},
              ("full", "tri", "tri_packed")),
}


@pytest.mark.parametrize("op", sorted(SPACES_2D))
def test_2d_spaces_hold_the_instantiated_tiles_and_variants(op):
    pairs, variants = SPACES_2D[op]
    space = ops.knob_space_for(op)
    assert len(space) == len(pairs) * len(variants)
    assert {(k["bm"], k["bn"]) for k in space} == pairs
    assert {k["variant"] for k in space} == set(variants)
    # bk repeats bm and is unused, as in the reference's 2-dim spaces
    assert all(k["bk"] == k["bm"] for k in space)
    assert space.name == "blocks"
    assert space._parallelism_fn is knobs._grid_parallelism


@pytest.mark.parametrize("op", sorted(SPACES_2D))
def test_2d_spaces_leave_out_tiles_of_1024_threads(op):
    for k in ops.knob_space_for(op):
        side = k["bm"] if op in ("syrk", "syr2k") else k["bn"]
        assert k["bm"] * side // 64 < 1024


def test_rank_k_space_fields_keep_the_reference_meaning():
    # bm is the square output tile, bn the contraction block (the
    # reference's bk = kb["bn"]); the contraction blocks are the GEMM's bk
    for op in ("syrk", "syr2k"):
        assert {k["bn"] for k in ops.knob_space_for(op)} == \
            set(knobs.HOPPER_TILES_K)
    ref = ref_ops.knob_space_for("syrk")
    assert {k["variant"] for k in ref} == \
        {k["variant"] for k in ops.knob_space_for("syrk")}


def test_2d_space_sizes_restrict_the_output_tile():
    space = ops.knob_space_for("symm", sizes=(64, 128))
    assert {(k["bm"], k["bn"]) for k in space} == \
        {(bm, bn) for bm in (64, 128) for bn in (64, 128)}
    space = ops.knob_space_for("syrk", sizes=(64,))
    assert {k["bm"] for k in space} == {64} and len(space) == 9


@pytest.mark.parametrize("kw", [{"bms": (32,)}, {"bns": (512,)}])
@pytest.mark.parametrize("op", ("symm", "syrk"))
def test_2d_space_refuses_tiles_without_a_kernel(op, kw):
    with pytest.raises(ValueError):
        knobs.hopper_2d_knob_space(op, **kw)


@pytest.mark.parametrize("op,want", [
    ("symm", (64, 64, "full")), ("trsm", (64, 64, "full")),
    ("syrk", (64, 16, "full")), ("syr2k", (64, 16, "full"))])
def test_2d_default_knob_is_max_parallelism(op, want):
    kd = ops.default_knob(op).dict
    assert (kd["bm"], kd["bn"], kd["variant"]) == want
    space = ops.knob_space_for(op)
    par = space.parallelism_vec((4096, 4096))
    assert space.parallelism(ops.default_knob(op), (4096, 4096)) == par.max()


@pytest.mark.parametrize("op,shapes", [
    ("symm", ((48, 48), (48, 40))), ("symm", ((3, 129, 129), (3, 129, 257))),
    ("syrk", ((129, 257),)), ("syrk", ((5, 1, 384), (5, 1, 1))),
    ("syr2k", ((300, 300), (300, 300))), ("syr2k", ((4096, 14336),) * 2),
    ("trsm", ((4096, 4096), (4096, 14336))), ("trsm", ((8, 512, 512),) * 2),
])
def test_2d_dims_of_matches_reference_and_ignores_batch(op, shapes):
    got = ops.dims_of(op, shapes)
    assert got == ref_ops.dims_of(op, shapes)
    assert got == ops.dims_of(op, tuple(s[-2:] for s in shapes))


@pytest.mark.parametrize("op", sorted(SPACES_2D))
def test_2d_grid_parallelism_matches_reference(op):
    dims_list = [(1, 384), (129, 257), (4096, 14336), (14336, 4096)]
    for cand in ops.knob_space_for(op):
        ref_knob = ref_knobs.Knob(cand.values)
        for dims in dims_list:
            assert knobs._grid_parallelism(cand, dims) == \
                ref_knobs._grid_parallelism(ref_knob, dims)


@pytest.mark.parametrize("shapes", [
    ((33, 64), (64, 96)),
    ((5, 33, 64), (64, 96)),
    ((5, 33, 64), (5, 64, 96)),
    ((1, 300), (300, 384)),
    ((129, 65), (65, 257)),
    ((8, 128, 4096), (4096, 4096)),
    ((2, 1, 1), (2, 1, 1)),
    ((7, 14336), (14336, 4096)),
])
def test_dims_of_matches_reference_and_ignores_batch(shapes):
    got = ops.dims_of("gemm", shapes)
    assert got == ref_ops.dims_of("gemm", shapes)
    assert got == ops.dims_of("gemm", tuple(s[-2:] for s in shapes))


def test_grid_parallelism_matches_reference():
    dims_list = [(1, 300, 384), (129, 65, 257), (4096, 4096, 14336)]
    for cand in ops.knob_space_for("gemm"):
        ref_knob = ref_knobs.Knob(cand.values)
        for dims in dims_list:
            assert knobs._grid_parallelism(cand, dims) == \
                ref_knobs._grid_parallelism(ref_knob, dims)


@pytest.mark.parametrize("op", features.SUBROUTINES)
def test_build_features_bit_identical_to_reference(op):
    rng = np.random.default_rng(11)
    nd = features.SUBROUTINE_NDIMS[op]
    dims = rng.integers(1, 16384, size=(64, nd)).astype(np.int64)
    nt = rng.integers(1, 4096, size=64).astype(np.float64)
    got = features.build_features(op, dims, nt)
    want = ref_features.build_features(op, dims, nt)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert features.feature_names(nd) == ref_features.feature_names(nd)
