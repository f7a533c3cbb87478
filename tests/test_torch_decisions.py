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
#: one tree fit to a boosted ensemble's predictions (``core/distill.py``),
#: held apart from FAMILIES so model selection's comparison stays as it was
DISTILLED = ("DistilledTree",)


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


def _grid(ndims: int = 3):
    rng = np.random.default_rng(9)
    fixed = [(8, 4096, 4096), (2048, 4096, 14336), (1, 300, 384),
             (129, 65, 257), (16384, 16, 16384)] if ndims == 3 else \
        [(4096, 14336), (14336, 4096), (4096, 4096), (512, 512), (1, 384),
         (129, 257), (16384, 16)]
    return fixed + [tuple(int(v) for v in rng.integers(8, 16384, size=ndims))
                    for _ in range(20)]


def _install(pkg, ds, candidates, op="gemm"):
    return pkg.install_subroutine(op, ds.knob_space, None, dataset=ds,
                                  candidates=candidates, tune_trials=1,
                                  seed=0, backend="hopper")


def _assert_same_decisions(port_sub, ref_sub, op="gemm"):
    assert port_sub.model_name == ref_sub.model_name
    port_rt, ref_rt = core.AdsalaRuntime(), ref_core.AdsalaRuntime()
    port_rt.register(port_sub)
    ref_rt.register(ref_sub)
    for dims in _grid(3 if op == "gemm" else 2):
        assert np.array_equal(port_sub.predict_times(dims),
                              ref_sub.predict_times(dims))
        assert port_sub.select(dims).dict == ref_sub.select(dims).dict
        assert port_rt.select(op, dims, 4, backend="hopper").dict == \
            ref_rt.select(op, dims, 4, backend="hopper").dict


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


@pytest.fixture(scope="module")
def distilled(datasets):
    """A DistilledTree install by each package on the same dataset."""
    port_ds, ref_ds = datasets
    return {family: (_install(core, port_ds, (family,)),
                     _install(ref_core, ref_ds, (family,)))
            for family in DISTILLED}


@pytest.mark.parametrize("family", DISTILLED)
def test_distilled_install_decides_as_reference(distilled, family):
    _assert_same_decisions(*distilled[family])


@pytest.mark.parametrize("family", DISTILLED)
def test_distilled_reference_artifact_carried_across(distilled, family):
    _assert_carried_across(distilled[family][1])


def test_registries_hold_the_reference_families():
    """Every model family the reference registers at import, the port
    registers too: an install may name any of them, and an artifact of any
    of them unpacks."""
    from repro.core.ml import MODEL_REGISTRY as ref_registry
    from repro_torch.core.ml import MODEL_REGISTRY as port_registry
    assert sorted(port_registry) == sorted(ref_registry)
    assert len(port_registry) == 10 and "DistilledTree" in port_registry


def test_distilled_tree_lowers_to_predicated_tree(distilled):
    """A DistilledTree install compiles to the predicated single-tree
    lowering, as the reference's does, and predicts the times of the
    artifact's own path bit for bit."""
    from repro.core.fastpath import compile_predictor as ref_compile
    from repro_torch.core.fastpath import compile_predictor
    port_sub, ref_sub = distilled["DistilledTree"]
    cp, ref_cp = compile_predictor(port_sub), ref_compile(ref_sub)
    assert cp is not None and cp.lowering == "predicated-tree"
    assert ref_cp.lowering == cp.lowering
    for dims in _grid():
        assert np.array_equal(cp.predict_times(dims),
                              port_sub.predict_times(dims)), dims
        assert np.array_equal(cp.predict_times(dims),
                              ref_cp.predict_times(dims)), dims
        assert cp.select(dims) == port_sub.select(dims)


def _assert_carried_across(ref_sub):
    state = ref_sub.get_state()
    port_sub = subroutine_from_state(state)
    assert port_sub.backend == "hopper"
    assert port_sub.knob_space.name == "blocks"
    _assert_same_decisions(port_sub, ref_sub)
    # and through the port's own JSON artifact encoding
    again = subroutine_from_state(core.unpack_state(pack_state(state)))
    _assert_same_decisions(again, ref_sub)


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_artifact_carried_across(datasets, family):
    _, ref_ds = datasets
    _assert_carried_across(_install(ref_core, ref_ds, (family,)))


# -- the 2-dim subroutines ----------------------------------------------------

def _cost_2d(op: str, dims: np.ndarray, cands: list[dict]) -> np.ndarray:
    """A seeded synthetic cost surface over (dims, knob) for a 2-dim op: the
    op's operations at a tile-dependent rate (the rank-k variants doing the
    full product, the lower triangle plus idle blocks, or the packed
    triangle), wave quantisation over 132 SMs, a per-CTA cost and
    lognormal noise."""
    rng = np.random.default_rng(7)
    out = np.empty((dims.shape[0], len(cands)))
    for i, (d0, d1) in enumerate(dims.astype(np.float64)):
        for j, c in enumerate(cands):
            bm, bn = c["bm"], c["bn"]
            if op in ("syrk", "syr2k"):
                tiles = np.ceil(d0 / bm)
                ctas = tiles * tiles if c["variant"] != "tri_packed" \
                    else tiles * (tiles + 1) / 2
                live = tiles * tiles if c["variant"] == "full" \
                    else tiles * (tiles + 1) / 2
                work = live * bm * bm * d1 * (2 if op == "syr2k" else 1)
                rate = 1e10 * bm / (1 + 16.0 / bn)
            else:
                ctas = np.ceil(d0 / bm) * np.ceil(d1 / bn)
                work = ctas * bm * bn * d0
                rate = 1e10 * (bm * bn) ** 0.5
            waves = np.ceil(ctas / 132.0)
            out[i, j] = work / rate * waves / max(ctas / 132.0, 1.0) \
                + 3e-6 + 1e-8 * ctas
    return 1e4 * out * rng.lognormal(0.0, 0.03, size=out.shape)


@pytest.fixture(scope="module", params=("symm", "syrk", "syr2k", "trsm"))
def datasets_2d(request):
    op = request.param
    cands = [k.dict for k in ops.knob_space_for(op)]
    dims = core.sample_dims(48, 2, lo=8, hi=16384, seed=4)
    times = _cost_2d(op, dims, cands)
    port_space = knobs.KnobSpace("blocks", cands,
                                 parallelism_fn=knobs._grid_parallelism)
    ref_space = ref_knobs.KnobSpace("blocks", cands,
                                    parallelism_fn=ref_knobs._grid_parallelism)
    port_ds = core.TimingDataset(op=op, dims=dims, times=times,
                                 knob_space=port_space, dtype_bytes=4)
    ref_ds = ref_core.TimingDataset(op=op, dims=dims.copy(),
                                    times=times.copy(), knob_space=ref_space,
                                    dtype_bytes=4)
    return op, port_ds, ref_ds


@pytest.mark.parametrize("family", ("LinearRegression", "DecisionTree",
                                    "KNN"))
def test_2d_install_decides_as_reference(datasets_2d, family):
    op, port_ds, ref_ds = datasets_2d
    _assert_same_decisions(_install(core, port_ds, (family,), op),
                           _install(ref_core, ref_ds, (family,), op), op)
