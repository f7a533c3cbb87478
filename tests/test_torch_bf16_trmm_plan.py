"""The Python mirrors of the bf16 trmm kernels (``csrc/trmm_bf16.cu``,
``csrc/trmm_packed_bf16.cu`` on the wgmma + TMA mainloop, through
``csrc/trmm_tile_bf16.cuh``): the per-pass step plan, the block order and
the launch parameters, against what the kernels' design requires.  The
kernels themselves are held to these mirrors on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``'s phase 2.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gemm as G
from repro_torch.kernels import symm as S
from repro_torch.kernels import trmm as TM

VARIANTS = ("full", "tri", "tri_packed")


def _ranks(variant, nb):
    return range(-(-nb // 2)) if variant == "tri_packed" else range(nb)


@pytest.mark.parametrize("bm,bn", sorted(TM.TILES))
def test_trmm_bf16_step_plan_covers_the_stored_triangle(bm, bn):
    """At every m of 1-600, over the blocks of each variant's grid: every
    row lies in exactly one pass; every stored ``(r, k)``, ``k <= r < m``,
    lies in exactly one step of its row's pass (``full``: every ``k < m``);
    a step is ``across`` exactly when its pass rows x 64 indices hold
    elements on both sides of the diagonal, ``below`` when all lie on or
    below it, ``above`` (``full`` only) when all lie above it; and a
    ``tri_packed`` block runs ``tri``'s passes of its two row blocks, in
    order, as one sequence."""
    pm, step = min(bm, 128), TM.BF16_STEP
    for m in range(1, 601):
        nb = -(-m // bm)
        lower = np.tril(np.ones((m, m), bool))
        plans = {}
        for variant in VARIANTS:
            cover = np.zeros((m, m), np.int32)
            rows = np.zeros(m, np.int32)
            plans[variant] = []
            for rank in _ranks(variant, nb):
                plan = TM.step_plan(variant, m, bm,
                                    TM.block_rows(variant, m, bm, rank))
                plans[variant].append(plan)
                for prow0, kinds in plan:
                    assert prow0 % 64 == 0 and 0 <= prow0 < m
                    rows[prow0:prow0 + pm] += 1
                    for s, kind in enumerate(kinds):
                        k0 = s * step
                        cover[prow0:prow0 + pm, k0:k0 + step] += 1
                        stored = k0 <= prow0 + pm - 1
                        upper = k0 + step - 1 > prow0
                        assert kind == ("across" if stored and upper else
                                        "below" if stored else "above"), \
                            (m, variant, prow0, k0)
                    if variant != "full":
                        assert "above" not in kinds, (m, variant, prow0)
            assert (rows == 1).all(), (m, variant)
            if variant == "full":
                assert (cover == 1).all(), (m, variant)
            else:
                assert (cover[lower] == 1).all(), (m, variant)
        for p, plan in enumerate(plans["tri_packed"]):
            hi = nb - 1 - p
            assert plan == plans["tri"][p] + (plans["tri"][hi] if hi != p
                                              else []), (m, p)


@pytest.mark.parametrize("variant", VARIANTS)
def test_trmm_bf16_block_order_is_a_bijection(variant):
    """The bf16 kernels' block order (``tile_of_block``, the mirror of
    ``block_tile`` in ``csrc/trmm_bf16.cu`` and ``csrc/trmm_packed_bf16.cu``)
    sends every launched block of the variant's grid, ``nx`` column tiles by
    ``nb`` row blocks (``tri_packed``: ``ceil(nb / 2)`` pairs), to a
    distinct tile inside it.  The blocks in flight cover compact groups:
    the first ``BLOCK_GROUP`` column tiles' blocks come first, and under
    ``full`` and ``tri`` a group starts with its last (longest) row
    block."""
    for nx in (1, 2, 3, 7, 8, 9, 17, 224):
        for nb in range(1, 70):
            ny = -(-nb // 2) if variant == "tri_packed" else nb
            blocks = nx * ny
            rank, col = TM.tile_of_block(variant, nx, nb,
                                         torch.arange(blocks))
            assert bool(((0 <= rank) & (rank < ny) & (0 <= col)
                         & (col < nx)).all()), (nx, nb)
            assert torch.unique(rank * nx + col).numel() == blocks, (nx, nb)
            first = min(TM.BLOCK_GROUP, nx) * ny
            assert bool((col[:first] < TM.BLOCK_GROUP).all()), (nx, nb)
            lead = rank[:min(TM.BLOCK_GROUP, nx)]
            assert bool((lead == (0 if variant == "tri_packed"
                                  else nb - 1)).all()), (nx, nb)
    rank, col = TM.tile_of_block(variant, 40, 5, 0)
    assert (int(rank), int(col)) == (0 if variant == "tri_packed" else 4, 0)


@pytest.mark.parametrize("bm,bn", sorted(TM.TILES))
def test_trmm_bf16_launch_params_fit_the_card(bm, bn):
    """Both bf16 trmm kernels run the wgmma loop's tile that symm compiles
    for the same ``(bm, bn)``: passes of ``min(bm, 128)`` rows and every
    column, a warpgroup per 64 rows of a pass, a stage of A's K-major
    ``pm x 64`` window (128-byte rows under the 128-byte swizzle) and B's
    ``64 x bn`` slabs, each on the swizzle's 1024-byte repeat; 2-16
    stages, as many as fit in the SM's shared memory over the blocks an SM
    is meant to hold.  The float32 kernels' parameters are their own."""
    assert (bm, bn) in S.TILES
    p = G.mainloop_params(bm, TM.BF16_STEP, bn, torch.bfloat16)
    pm, pn = p["pass"]
    assert pm == min(bm, 128) and pn == bn and p["passes"] == bm // pm
    assert p["warpgroups"] == pm // 64 and p["threads"] == 128 * (pm // 64)
    assert p["swizzle"] == 2 * TM.BF16_STEP == 128
    assert p["blocks"] == max(1, min(4, 512 // (p["warpgroups"]
                                                * (pn // 2 + 64))))
    a_region, slab = pm * 2 * TM.BF16_STEP, TM.BF16_STEP * 2 * 64
    stage = a_region + pn // 64 * slab
    assert a_region % G.SWIZZLE_REPEAT == 0 and slab % G.SWIZZLE_REPEAT == 0
    budget = G.SMEM_SM // p["blocks"] - 4 * G.SWIZZLE_REPEAT
    assert 2 <= p["stages"] <= G.WGMMA_MAX_STAGES
    assert p["stages"] * stage <= budget
    assert p["stages"] == G.WGMMA_MAX_STAGES or \
        (p["stages"] + 1) * stage > budget
    assert p["smem"] == G.SWIZZLE_REPEAT + p["stages"] * (stage + 16) \
        <= G.SMEM_MAX
    assert p["blocks"] * (p["smem"] + 1024) <= G.SMEM_SM
    # the float32 kernels: the f32 mainloop's tile at a step of 64
    f32 = G.mainloop_params(bm, 64, bn)
    fpm, fpn = (bm, bn) if bm * bn <= G.MAX_PASS else (min(bm, 128),
                                                       min(bn, 128))
    assert f32["pass"] == (fpm, fpn) and "warpgroups" not in f32
    assert f32["threads"] == min(256, max(128, fpm * fpn // 64))
    assert f32["stages"] == G.ring_stages(4 * 64 * (fpm + fpn))


def test_trmm_variants_script_applies_to_the_checkout(tmp_path):
    """``scripts/torch_trmm_bf16_variants.py`` times the bf16 trmm kernels
    under variants that change one constant of ``csrc/trmm_tile_bf16.cuh``
    each: every substitution applies exactly once to this checkout's
    sources, and ``base`` is the sources as they are."""
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_trmm_bf16_variants.py"
    spec = importlib.util.spec_from_file_location("trmm_variants", path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    for name in variants.VARIANTS:
        out = variants.csrc_copy(name, tmp_path)
        changed = sorted(p.name for p in out.iterdir()
                         if p.read_text() != (_build.CSRC / p.name)
                         .read_text())
        assert changed == sorted({f for f, _, _ in
                                  variants.VARIANTS[name]}), name
    assert variants.VARIANTS["base"] == []
