"""Decisions: the port's install pipeline, artifact and runtime pick the same
model, predict the same times and choose the same tiles as the reference
package's, fed the same timing dataset — and a reference artifact carried
across with ``subroutine_from_state`` decides exactly as it did."""

import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.knobs as ref_knobs
import repro_torch.core as core
from repro_torch.core import knobs
from repro_torch.core.registry import pack_state, subroutine_from_state
from repro_torch.kernels import ops

#: the model families cheap enough to fit here many times over; the forest
#: and boosting families fit through the same tree code as DecisionTree
FAMILIES = ("LinearRegression", "BayesianRidge", "DecisionTree", "KNN")


def _cost(dims: np.ndarray, cands: list[dict]) -> np.ndarray:
    """A seeded synthetic cost surface over (dims, tile): compute at a
    tile-dependent rate, a per-CTA cost, wave quantisation over 132 SMs,
    and lognormal noise.  Scaled so the smallest time (~30 ms) dwarfs a
    model's measured evaluation time, which model selection charges."""
    rng = np.random.default_rng(5)
    out = np.empty((dims.shape[0], len(cands)))
    for i, (m, k, n) in enumerate(dims.astype(np.float64)):
        for j, c in enumerate(cands):
            ctas = np.ceil(m / c["bm"]) * np.ceil(n / c["bn"])
            waves = np.ceil(ctas / 132.0)
            rate = 1e10 * (c["bm"] * c["bn"]) ** 0.5 / (1 + 16.0 / c["bk"])
            out[i, j] = (2 * waves * c["bm"] * c["bn"] * k / rate
                         + 3e-6 + 1e-8 * ctas)
    return 1e4 * out * rng.lognormal(0.0, 0.03, size=out.shape)


@pytest.fixture(scope="module")
def datasets():
    cands = [k.dict for k in ops.knob_space_for("gemm")]
    dims = core.sample_dims(48, 3, lo=8, hi=16384, seed=3)
    times = _cost(dims, cands)
    port_space = knobs.KnobSpace("blocks", cands,
                                 parallelism_fn=knobs._grid_parallelism)
    ref_space = ref_knobs.KnobSpace("blocks", cands,
                                    parallelism_fn=ref_knobs._grid_parallelism)
    port_ds = core.TimingDataset(op="gemm", dims=dims, times=times,
                                 knob_space=port_space, dtype_bytes=4)
    ref_ds = ref_core.TimingDataset(op="gemm", dims=dims.copy(),
                                    times=times.copy(), knob_space=ref_space,
                                    dtype_bytes=4)
    return port_ds, ref_ds


def _grid():
    rng = np.random.default_rng(9)
    fixed = [(8, 4096, 4096), (2048, 4096, 14336), (1, 300, 384),
             (129, 65, 257), (16384, 16, 16384)]
    return fixed + [tuple(int(v) for v in rng.integers(8, 16384, size=3))
                    for _ in range(20)]


def _install(pkg, ds, candidates):
    return pkg.install_subroutine("gemm", ds.knob_space, None, dataset=ds,
                                  candidates=candidates, tune_trials=1,
                                  seed=0, backend="hopper")


def _assert_same_decisions(port_sub, ref_sub):
    assert port_sub.model_name == ref_sub.model_name
    port_rt, ref_rt = core.AdsalaRuntime(), ref_core.AdsalaRuntime()
    port_rt.register(port_sub)
    ref_rt.register(ref_sub)
    for dims in _grid():
        assert np.array_equal(port_sub.predict_times(dims),
                              ref_sub.predict_times(dims))
        assert port_sub.select(dims).dict == ref_sub.select(dims).dict
        assert port_rt.select("gemm", dims, 4, backend="hopper").dict == \
            ref_rt.select("gemm", dims, 4, backend="hopper").dict


@pytest.mark.parametrize("family", FAMILIES)
def test_install_decides_as_reference(datasets, family):
    port_ds, ref_ds = datasets
    _assert_same_decisions(_install(core, port_ds, (family,)),
                           _install(ref_core, ref_ds, (family,)))


def test_model_selection_picks_reference_model(datasets):
    port_ds, ref_ds = datasets
    port_sub = _install(core, port_ds, FAMILIES)
    ref_sub = _install(ref_core, ref_ds, FAMILIES)
    fields = ("name", "test_rmse", "normalized_rmse", "ideal_mean_speedup",
              "ideal_aggregate_speedup")
    assert [[getattr(r, f) for f in fields] for r in port_sub.reports] == \
        [[getattr(r, f) for f in fields] for r in ref_sub.reports]
    # selection charges each model's measured evaluation time, so families
    # whose ideal speedups lie within 0.1 % may legitimately swap places
    ideal = {r.name: r.ideal_mean_speedup for r in ref_sub.reports}
    top = max(ideal.values())
    tied = {name for name, v in ideal.items() if v >= top * (1 - 1e-3)}
    assert port_sub.model_name in tied and ref_sub.model_name in tied
    ref_model = {r.name: r.model for r in ref_sub.reports}
    _assert_same_decisions(port_sub, dataclasses.replace(
        ref_sub, model=ref_model[port_sub.model_name],
        model_name=port_sub.model_name))


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_artifact_carried_across(datasets, family):
    _, ref_ds = datasets
    ref_sub = _install(ref_core, ref_ds, (family,))
    state = ref_sub.get_state()
    port_sub = subroutine_from_state(state)
    assert port_sub.backend == "hopper"
    assert port_sub.knob_space.name == "blocks"
    _assert_same_decisions(port_sub, ref_sub)
    # and through the port's own JSON artifact encoding
    again = subroutine_from_state(core.unpack_state(pack_state(state)))
    _assert_same_decisions(again, ref_sub)
