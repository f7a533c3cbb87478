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


@pytest.mark.parametrize("op", ("symm", "syrk", "syr2k", "trmm", "trsm"))
def test_unported_ops_have_no_hopper_space(op):
    with pytest.raises(ValueError):
        ops.knob_space_for(op)
    with pytest.raises(ValueError):
        ops.dims_of(op, ((48, 48), (48, 40)))


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
