"""The port's H100 cost oracle (``repro_torch/core/oracle.py``) and the
oracle-driven pruning of a knob space (``repro_torch/roofline/costing.py``)
on the CPU: the per-op operation and byte counts against the reference
package's v5e oracle, the tile's launch parameters against the kernels'
own mirror, wave quantisation, and pruning that keeps every site's argmin
and never empties a space."""

import numpy as np
import pytest

import repro.core.oracle as ref_oracle
from repro_torch.core import ModelRegistry, install_subroutine
from repro_torch.core import knobs, oracle
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops
from repro_torch.roofline import prune_dominated_candidates

DIMS = {"gemm": ((1, 4096, 4096), (512, 512, 512), (129, 65, 257),
                 (4096, 14336, 4096), (8, 128, 128256)),
        "symm": ((512, 512), (4096, 14336), (129, 257)),
        "syrk": ((512, 512), (4096, 14336), (1, 384)),
        "syr2k": ((512, 512), (4096, 4096), (129, 65)),
        "trmm": ((512, 512), (4096, 14336), (129, 257)),
        "trsm": ((512, 512), (4096, 14336), (1, 300))}


@pytest.mark.parametrize("op", sorted(DIMS))
def test_counts_equal_the_reference(op):
    for dims in DIMS[op]:
        for knob in ops.knob_space_for(op):
            for db in (2, 4, 8):
                assert oracle._flops_bytes(op, dims, knob.dict, db) == \
                    ref_oracle._flops_bytes(op, dims, knob.dict, db)


def test_launch_parameters_mirror_the_mainloop():
    for bm in (64, 128, 256):
        for bn in (64, 128, 256):
            for bk in (16, 32, 64, 128, 256):
                p = G.mainloop_params(bm, bk, bn)
                threads, smem, acc = oracle._launch_params(bm, bk, bn)
                assert (threads, smem) == (p["threads"], p["smem"])
                assert acc == p["thread_tile"][0] * p["thread_tile"][1]
                assert oracle.cta_occupancy(bm, bk, bn) >= 1


def test_wave_quantisation_and_spec():
    spec = oracle.H100_SXM
    assert (spec.sms, spec.peak_flops_f32, spec.hbm_bw) == (132, 67e12,
                                                            3.35e12)
    assert "H100" in spec.name and "700 W" in spec.name
    knob = {"bm": 128, "bk": 64, "bn": 128, "variant": "full"}
    slots = spec.sms * oracle.cta_occupancy(128, 64, 128)
    # one CTA past a full wave costs a second wave of the same work each
    full = oracle.oracle_time("gemm", (128 * slots, 4096, 128), knob)
    over = oracle.oracle_time("gemm", (128 * (slots + 1), 4096, 128), knob)
    assert over > 1.8 * full - 2 * spec.launch_s
    # a bigger pass and a longer k-step are at least as efficient
    assert oracle.tile_efficiency(128, 64, 128) == spec.best_efficiency
    assert oracle.tile_efficiency(64, 16, 64) < \
        oracle.tile_efficiency(128, 64, 128)
    # deterministic, and the noise is lognormal around it
    t = oracle.oracle_time("trsm", (512, 512), ops.default_knob("trsm"))
    assert t == oracle.oracle_time("trsm", (512, 512),
                                   ops.default_knob("trsm"))
    rng = np.random.default_rng(0)
    noisy = [oracle.oracle_time("trsm", (512, 512), ops.default_knob("trsm"),
                                noise_rng=rng) for _ in range(64)]
    assert 0.9 * t < np.median(noisy) < 1.1 * t


@pytest.mark.parametrize("op", sorted(DIMS))
def test_prune_keeps_every_sites_argmin(op):
    space = ops.knob_space_for(op)
    sites = DIMS[op]
    pruned = prune_dominated_candidates(op, space, sites, slack=0.15)
    assert 1 <= len(pruned) <= len(space)
    assert pruned.name == space.name == "blocks"
    assert pruned._parallelism_fn is knobs._grid_parallelism
    kept = set(pruned.candidates)
    for dims in sites:
        times = [oracle.oracle_time(op, dims, c) for c in space.candidates]
        assert space.candidates[int(np.argmin(times))] in kept
    # no slack: the union of the sites' fastest (ties included: a twin the
    # oracle cannot tell apart) and nothing else
    tight = prune_dominated_candidates(op, space, sites, slack=0.0)
    fastest = set()
    for dims in sites:
        times = np.array([oracle.oracle_time(op, dims, c)
                          for c in space.candidates])
        fastest |= {space.candidates[i]
                    for i in np.flatnonzero(times == times.min())}
    assert set(tight.candidates) == fastest
    # no sites: the space as it is
    assert prune_dominated_candidates(op, space, []) is space


def test_pruned_install_round_trips_with_its_parallelism(tmp_path):
    space = prune_dominated_candidates("gemm", ops.knob_space_for("gemm"),
                                       DIMS["gemm"], slack=0.15)
    sub = install_subroutine(
        "gemm", space, lambda d, k: oracle.oracle_time("gemm", d, k),
        n_samples=16, dim_lo=16, dim_hi=512, tune_trials=1,
        candidates=("DecisionTree",), use_lof=False)
    reg = ModelRegistry(tmp_path)
    reg.save(sub)
    loaded = reg.load_all(backend="hopper")[0]
    assert loaded.knob_space.candidates == space.candidates
    assert loaded.knob_space._parallelism_fn is knobs._grid_parallelism
    for dims in ((64, 64, 64), (300, 200, 100)):
        assert loaded.select(dims) == sub.select(dims)



def test_launch_window_outside_and_empty():
    """Outside a window a wrapper passes its launcher no events; a window
    that saw no launch has no time (the service then books its span)."""
    from repro_torch.kernels.introspect import (LaunchWindow, launch_events,
                                                launch_window)
    assert launch_events() == (None, None)
    with launch_window() as window:
        pass
    assert window.launches == 0 and window.seconds() is None
    assert LaunchWindow().spans == []
