"""The GEMM's split-k plan and the launch parameters of the shared f32
mainloop (``csrc/sgemm_mainloop.cuh``), checked without a card: every tile
of the GEMM, symm, syrk/syr2k and trmm knob spaces stays within the H100's
limits, the split never depends on the batch, padding to multiples of 128
(``padded_run``) keeps every slice boundary, and the grid formula counts
the slices.  The card checks the C mirror of both rules
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 2)."""

import importlib.util
import itertools
from pathlib import Path

import pytest

from repro_torch.kernels import gemm as G
from repro_torch.kernels import introspect as I
from repro_torch.kernels import symm as S
from repro_torch.kernels import syrk as K
from repro_torch.kernels import trmm as TM

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: the ragged and one-row dims of the zero-copy contracts (tests/
#: test_torch_gpu.py ``_ZC_DIMS["gemm"]``) and the split shape beside them
_ZC_DIMS = ((129, 65, 257), (1, 300, 384), (7, 1300, 1000))


def _main_path_dims():
    """(m, k, n) of every GEMM the chip smoke serves (the llama3-8b linears
    at each token count, the serving bucket per item)."""
    dims = [(t, k, n) for t in chip_smoke.TOKENS for k, n in chip_smoke.LINEARS]
    _b, s, d = chip_smoke.BUCKET
    return dims + [(s, d, d)]


def _all_dims():
    return (*chip_smoke.KERNEL_DIMS, *_ZC_DIMS, *_main_path_dims(),
            *chip_smoke.CONTRACT_DIMS["gemm"])


def _rup(v, b=128):
    return -(-v // b) * b


def _boundaries(k, slices, length):
    return [(s * length, min(k, (s + 1) * length)) for s in range(slices)]


@pytest.mark.parametrize("bm,bk,bn", sorted(G.TILES))
def test_gemm_launch_params_fit_the_card(bm, bk, bn):
    p = G.mainloop_params(bm, bk, bn)
    pm, pn = p["pass"]
    assert 128 <= p["threads"] <= 256 and p["threads"] % 32 == 0
    assert pm * pn <= G.MAX_PASS and bm % pm == 0 and bn % pn == 0
    assert p["passes"] * pm * pn == bm * bn
    tm, tn = p["thread_tile"]
    assert (tm, tn) in ((4, 8), (8, 8))
    assert tm * tn * p["threads"] == pm * pn
    assert 2 <= p["stages"] <= 4
    assert p["smem"] == p["stages"] * 4 * bk * (pm + pn) <= G.SMEM_MAX
    # the most stages the ring budget allows, at least two
    assert p["stages"] == 2 or \
        (p["stages"] + 1) * 4 * bk * (pm + pn) > G.RING_BUDGET or \
        p["stages"] == 4


@pytest.mark.parametrize("bm,bn", sorted(S.TILES))
def test_symm_launch_params_fit_the_card(bm, bn):
    p = G.mainloop_params(bm, 64, bn)
    assert 128 <= p["threads"] <= 256
    assert p["smem"] <= G.SMEM_MAX and 2 <= p["stages"] <= 4
    assert p["passes"] * p["pass"][0] * p["pass"][1] == bm * bn


@pytest.mark.parametrize("bm,bn", sorted(TM.TILES))
def test_trmm_launch_params_fit_the_card(bm, bn):
    """Both trmm kernels run the mainloop under ``Tile<bm, bn, 64>``: 4-8
    warps, a ring within the card's shared memory, and passes whose rows
    start on a contraction step, so ``tri`` ends every pass on one."""
    p = G.mainloop_params(bm, 64, bn)
    pm, _pn = p["pass"]
    assert 128 <= p["threads"] <= 256 and p["threads"] % 32 == 0
    assert p["smem"] <= G.SMEM_MAX and 2 <= p["stages"] <= 4
    assert p["passes"] * p["pass"][0] * p["pass"][1] == bm * bn
    assert pm % 64 == 0 and bm % pm == 0


@pytest.mark.parametrize("bm,bk", sorted(K.TILES))
def test_rank_k_launch_params_fit_the_card(bm, bk):
    """Both rank-k kernels run the mainloop's ``bm x bm`` tile in one pass
    with a stage of ``bm x bk`` A floats and ``bm x (bk + 4)`` B floats (B
    staged as rows, padded so a quarter warp's 16-byte reads hit distinct
    banks): 4-8 warps, a ring of 2-4 stages within the card's shared
    memory, and the epilogue's parked ``bm x (bm + 1)`` tile within the
    ring it reuses."""
    p = K.rank_k_params(bm, bk)
    assert p["threads"] == (128 if bm == 64 else 256)
    assert p["thread_tile"] == ((4, 8) if bm == 64 else (8, 8))
    assert p["passes"] == 1 and p["pass"] == (bm, bm)
    stage = 4 * (bm * bk + bm * (bk + 4))
    assert 2 <= p["stages"] <= 4 and p["smem"] == p["stages"] * stage
    assert p["smem"] <= G.SMEM_MAX
    assert p["stages"] == 2 or p["stages"] == 4 or \
        (p["stages"] + 1) * stage > G.RING_BUDGET
    assert p["park"] == 4 * bm * (bm + 1) <= p["smem"]
    # the B rows a quarter warp reads (8 consecutive tx, 16 bytes each)
    # start in distinct groups of 4 banks
    assert len({(t * (bk + 4)) % 32 for t in range(8)}) == 8


def test_default_tile_gets_four_warps_and_the_big_tiles_run_in_passes():
    assert G.mainloop_params(64, 16, 64)["threads"] == 128
    assert G.mainloop_params(64, 16, 64)["thread_tile"] == (4, 8)
    # trmm's default 64x64 too (8 x 8 accumulators a thread: 2 warps)
    assert G.mainloop_params(64, 64, 64)["threads"] == 128
    assert G.mainloop_params(256, 64, 256)["passes"] == 4
    assert G.mainloop_params(128, 64, 256)["passes"] == 2
    assert G.mainloop_params(128, 64, 128)["passes"] == 1


@pytest.mark.parametrize("bm,bn", sorted({(t[0], t[2]) for t in G.TILES}))
def test_split_plan_covers_k_in_aligned_slices(bm, bn):
    for m, k, n in (*_all_dims(), (8, 4096, 1024), (128, 3968, 14336),
                    (1, 1, 1), (300, 0, 300)):
        slices, length = G.split_plan(m, n, k, bm, bn)
        tiles = -(-m // bm) * -(-n // bn)
        if slices == 1:
            assert length == k
            continue
        assert tiles < G.HOPPER_SMS and length % G.SPLIT_ALIGN == 0
        assert (slices - 1) * length < k <= slices * length
        assert -(-n // bn) * slices < 2 ** 31


def test_split_plan_fills_the_card_for_decode():
    # the T=8 linears of llama3-8b under the default 64x16x64 tile
    assert G.split_plan(8, 1024, 4096, 64, 64) == (16, 256)
    assert G.split_plan(8, 4096, 4096, 64, 64) == (8, 512)
    assert G.split_plan(8, 4096, 14336, 64, 64) == (28, 512)
    # 224 output tiles fill the card: no split
    assert G.split_plan(8, 14336, 4096, 64, 64) == (1, 4096)
    # one tile, k within one slice: no split
    assert G.split_plan(129, 257, 65, 64, 128) == (1, 65)


@pytest.mark.parametrize("batch", (1, 2, 3, 8, 64))
def test_split_does_not_depend_on_the_batch(batch):
    for m, k, n in _all_dims():
        for bm, _bk, bn in G.TILES:
            one = I.full_grid_for("gemm", (m, k, n), bm, bn)
            stacked = I.full_grid_for("gemm", (m, k, n), bm, bn, batch=batch)
            assert stacked == (one[0], one[1], batch)


@pytest.mark.parametrize("dims", sorted(set(_all_dims())))
def test_padding_to_128_keeps_the_slices(dims):
    """``padded_run`` pads m, n and k to multiples of 128 and runs the same
    tile; wherever padding keeps the output tile count (every tile whose
    edges are multiples of 128, the padded run's 128 x 128 among them) the
    slices and their boundaries stay, so masked == padded holds bit for
    bit."""
    m, k, n = dims
    for bm, bn in itertools.product((128, 256), repeat=2):
        plan = G.split_plan(m, n, k, bm, bn)
        padded = G.split_plan(_rup(m), _rup(n), _rup(k), bm, bn)
        assert plan[0] == padded[0], (dims, bm, bn)
        if plan[0] > 1:
            assert _boundaries(k, *plan)[:-1] == \
                _boundaries(_rup(k), *padded)[:-1]
            assert plan[1] == padded[1]


def test_the_contract_shapes_include_a_split():
    # the split shape of the masked == padded contract splits under the
    # padded run's tile, so the contract holds the reduction too
    assert G.split_plan(7, 1000, 1300, 128, 128)[0] > 1
    assert (7, 1300, 1000) in chip_smoke.CONTRACT_DIMS["gemm"]


@pytest.mark.parametrize("bm,bn", [(64, 64), (128, 128), (256, 256),
                                   (64, 256)])
def test_grid_formula_counts_the_slices(bm, bn):
    for m, k, n in _all_dims():
        slices, _ = G.split_plan(m, n, k, bm, bn)
        assert I.full_grid_for("gemm", (m, k, n), bm, bn) == \
            (-(-n // bn) * slices, -(-m // bm), 1)


def test_vec_aligned_needs_pointer_and_strides():
    import torch
    x = torch.zeros(8, 68)
    assert G.vec_aligned((x, 68, 0))
    assert not G.vec_aligned((x, 65, 0))
    assert not G.vec_aligned((x[:, 1:], 68, 0))
    assert not G.vec_aligned((x, 68, 6))
