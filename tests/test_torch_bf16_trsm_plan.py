"""The Python mirror of the bf16 trsm substitution's step sequence
(``csrc/trsm_bf16.cu`` on the wgmma + TMA mainloop) and the protocol that
holds a copy of X's rows back until the epilogue that stored them has
ended.  The kernel itself is held to this mirror on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``'s phase 2.
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import trsm as T

STEP = 64
#: m of 1-600, in five ranges a case
M_RANGES = [range(lo, lo + 120) for lo in range(1, 601, 120)]


def _ms_id(ms):
    return "m%d-%d" % (ms[0], ms[-1])


@pytest.mark.parametrize("ms", M_RANGES, ids=_ms_id)
@pytest.mark.parametrize("bm,bn", sorted(T.TILES))
def test_trsm_bf16_step_plan_covers_every_product_once(bm, bn, ms):
    """At every m: every row of a block row lies in exactly one pass of
    each step; step 0's passes cover every contraction index ``k < lo`` of
    their block row once, step 1's every ``k`` below ``min(prow + pass
    rows, r)`` once, in steps of 64 from 0; block rows run in order, step 0
    before step 1, the passes of each top-down; A comes from A's block row
    (step 0) or the inverses (step 1), and B from X's rows by TMA (step 0)
    or from the region that holds ``R_i`` (step 1)."""
    pm = min(bm, 128)
    for m in ms:
        nb = -(-m // bm)
        plan = T.step_plan(m, bm, bn)
        keys = [(s.i, s.step, s.prow, s.k0) for s in plan]
        assert len(set(keys)) == len(keys), m
        want = []
        for i in range(nb):
            lo, r = i * bm, min(bm, m - i * bm)
            prows = list(range(0, r, pm))
            rows = sum((list(range(p, min(p + pm, r))) for p in prows), [])
            assert rows == list(range(r)), (m, i)
            want += [(i, 0, p, k) for p in prows for k in range(0, lo, STEP)]
            want += [(i, 1, p, k) for p in prows
                     for k in range(0, min(p + pm, r), STEP)]
        assert keys == want, m
        for s in plan:
            assert (s.a, s.b) == (("inv", "r_region") if s.step
                                  else ("A", "x_tma")), (m, s)


@pytest.mark.parametrize("ms", M_RANGES, ids=_ms_id)
@pytest.mark.parametrize("bm,bn", sorted(T.TILES))
def test_trsm_bf16_copies_of_x_wait_for_their_stores(bm, bn, ms):
    """The kernel's protocol on the plan, step by step, with the tile's
    ring (``trsm_params``' stages): lanes of warp 0 fill the first STAGES
    steps or leave them pending; the release of step h (after the step
    after it is issued, or at the end of its pass) fills step h + STAGES
    if its epoch has come, else leaves it pending; the end of each step of
    a block row advances the epoch and fills the pending steps whose epoch
    has come, and the end of a block row's step 1 has stored and fenced
    its rows of X.  Every step is copied exactly once and before it is
    consumed (no wait can outlast the protocol), no step waits past the
    step it belongs to, and no copy of X's rows is issued before they are
    stored: the rows it reads are counted as the simulation stores them,
    not from the plan's epochs."""
    stages = T.trsm_params(bm, bn, torch.bfloat16)["stages"]
    for m in ms:
        nb = -(-m // bm)
        plan = T.step_plan(m, bm, bn)
        total = len(plan)
        # the rows of X stored and fenced when each step was copied
        issued, pending = {}, {}
        state = {"epoch": 0, "stored": 0}

        def refill(f):
            if plan[f].epoch <= state["epoch"]:
                assert f not in issued, (m, f)
                issued[f] = state["stored"]
            else:
                pending[f % stages] = f

        def release(h):
            if h + stages < total:
                refill(h + stages)

        for f in range(min(stages, total)):
            refill(f)
        g = 0
        for i in range(nb):
            for step in (0, 1):
                run = 2 * i + step
                while g < total and plan[g][:2] == (i, step):
                    # a pass: each step's products, then the release of
                    # the step before; its last step's release at its end
                    first = g
                    while g < total and plan[g][:3] == plan[first][:3]:
                        s = plan[g]
                        assert g in issued, (m, g, s, "consumed, not copied")
                        assert s.epoch <= run, (m, s)
                        if g > first:
                            release(g - 1)
                        g += 1
                    release(g - 1)
                if step:
                    state["stored"] = min(m, (i + 1) * bm)
                state["epoch"] = run + 1
                for stage, f in list(pending.items()):
                    if plan[f].epoch <= state["epoch"]:
                        del pending[stage]
                        refill(f)
        assert g == total and sorted(issued) == list(range(total)), m
        assert not pending, m
        for f, stored in issued.items():
            s = plan[f]
            if s.b == "x_tma":
                assert min(s.k0 + STEP, m) <= stored, (m, f, s, stored)


def test_trsm_bf16_mirror_constants_are_the_kernels():
    """The substitution's source includes the wgmma loop, and the mma.sync
    loop is gone: no source of the port includes it."""
    src = (_build.CSRC / "trsm_bf16.cu").read_text()
    assert '#include "bf16_wgmma_mainloop.cuh"' in src
    assert not (_build.CSRC / "bf16_mainloop.cuh").exists()
    assert not any("bf16_mainloop.cuh" in p.read_text()
                   for p in _build.CSRC.iterdir())
