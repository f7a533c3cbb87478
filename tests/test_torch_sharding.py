"""The port's sharding specs against the reference's, in-process, with no
process group: ``rules_for``, ``logical_spec``, ``param_specs`` (the port's
per-layer parameters through the path map, the reference's stack dims
taken off), ``cache_specs``, ``input_specs`` and ``total_params`` for all
10 architectures at their full configs, on the meshes (1, 1), (4, 2),
(16, 16) and (2, 16, 16) — shape only: the reference's
``jax.sharding.AbstractMesh``, the port's ``AbstractMesh``; parameter and
cache shapes from ``jax.eval_shape`` and from the ``meta`` device.  Also
``bubble_fraction`` and ``best_mesh``'s factorisation.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh

import repro.configs as rconfigs
from repro.distributed import best_mesh as ref_best_mesh
from repro.distributed.pipeline import bubble_fraction as ref_bubble
from repro.launch import specs as rspecs
from repro.models import sharding as rsharding
from repro.models import transformer as rtf
import repro_torch.configs as pconfigs
from repro_torch.distributed import (abstract_like, best_mesh_shape,
                                     bubble_fraction)
from repro_torch.launch import specs as pspecs
from repro_torch.models import sharding as psharding
from repro_torch.models import transformer as ptf

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, m) for a in pconfigs.ARCHITECTURES for m in MESHES]
#: the decode cache the cache specs are taken on
CACHE_B, CACHE_T = 128, 4096


def _meshes(name):
    shape, axes = MESHES[name]
    return RefAbstractMesh(shape, axes), psharding.AbstractMesh(shape, axes)


def _norm(spec) -> tuple:
    """A spec's entries as tuples of mesh axes (None: replicated)."""
    out = []
    for e in spec:
        out.append(None if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def _table(rules) -> dict:
    return {k: tuple(v) for k, v in rules.table.items()}


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = rconfigs.get_config(arch)
    return jax.eval_shape(lambda: rtf.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dict(ptf.Transformer(pconfigs.get_config(arch),
                                device="meta").named_parameters())


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_rules_for_matches_reference(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    for kind in ("train", "prefill", "decode"):
        assert _table(pspecs.rules_for(pmesh, kind)) == \
            _table(rspecs.rules_for(rmesh, kind))
        assert _table(pspecs.rules_for(pmesh, kind, pcfg)) == \
            _table(rspecs.rules_for(rmesh, kind, rcfg))


@pytest.mark.parametrize("mesh", MESHES)
def test_logical_spec_matches_reference(mesh):
    """Every logical name of the base table and the names that degrade:
    dims that divide, dims that do not (replicated), a two-axis batch that
    degrades to its first axis."""
    rmesh, pmesh = _meshes(mesh)
    names = sorted(psharding.DEFAULT_RULES.table)
    assert names == sorted(rsharding.DEFAULT_RULES.table)
    rules = [(psharding.DEFAULT_RULES, rsharding.DEFAULT_RULES),
             (psharding.MULTIPOD_RULES, rsharding.MULTIPOD_RULES),
             (psharding.DEFAULT_RULES.replace(batch=("data", "model")),
              rsharding.DEFAULT_RULES.replace(batch=("data", "model")))]
    for prules, rrules in rules:
        if "pod" not in MESHES[mesh][1] and any(
                "pod" in v for v in prules.table.values()):
            continue
        for dims in ((512, 4096), (48, 7), (16, 1), (2, 256)):
            for a in names + [None]:
                for b in names + [None]:
                    want = rsharding.logical_spec(rrules, rmesh, (a, b), dims)
                    got = psharding.logical_spec(prules, pmesh, (a, b), dims)
                    assert _norm(got) == _norm(want), (a, b, dims)
            assert _norm(psharding.logical_spec(prules, pmesh, names)) == \
                _norm(rsharding.logical_spec(rrules, rmesh, names))


def _ref_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_param_specs_match_reference(arch, mesh):
    """Each port parameter's spec is its reference leaf's spec with the
    stack dims (always unsharded) taken off, under the train and the
    decode rules."""
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    shapes = _ref_param_shapes(arch)
    named = _port_params(arch)
    for kind in ("train", "decode"):
        rrules = rspecs.rules_for(rmesh, kind, rcfg)
        prules = pspecs.rules_for(pmesh, kind, pcfg)
        want_tree = rspecs.param_specs(shapes, rrules, rmesh)
        got = pspecs.param_specs(pcfg, named, prules, pmesh)
        assert got.keys() == named.keys()
        for key, spec in got.items():
            path, idx = ptf._reference_slot(pcfg, key)
            want = _norm(_ref_leaf(want_tree, path))
            assert want[:len(idx)] == (None,) * len(idx), key
            assert _norm(spec) == want[len(idx):], key
            # the placements a DTensor would take
            assert len(psharding.placements(spec, pmesh)) == len(
                MESHES[mesh][0])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, psharding.PartitionSpec):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_cache_specs_match_reference(arch, mesh):
    """Each layer's cache tensors take the reference's trailing spec
    entries (its cache stacks layers, and zamba2's mamba states a second
    time); the KV caches shard heads, or seq where kv_heads do not divide
    the model axis, as the reference decides."""
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    rrules = rspecs.rules_for(rmesh, "decode", rcfg)
    prules = pspecs.rules_for(pmesh, "decode", pcfg)
    rcaches = jax.eval_shape(lambda: rtf.init_decode_state(
        rcfg, CACHE_B, CACHE_T))
    want_tree = rspecs.cache_specs(rcfg, rcaches, rrules, rmesh)
    abstract, got_tree = pspecs.abstract_caches(pcfg, CACHE_B, CACHE_T,
                                                prules, pmesh)
    # the port's layer index → (segment, index in it)
    where = [(si, i) for si, (_, rep) in enumerate(pcfg.segments())
             for i in range(rep)]
    n = 0
    for path, spec in _leaves(got_tree):
        if path[-1] == "len":
            assert isinstance(spec, int)
            continue
        si, _ = where[path[0]]
        rpath = [si] + [k for k in path[1:] if not isinstance(k, int)]
        want = _norm(_ref_leaf(want_tree, rpath))
        got = _norm(spec)
        assert want[-len(got):] == got, path
        assert all(e is None for e in want[:-len(got)]), path
        assert _ref_leaf(abstract, path).spec == spec
        n += 1
    assert n


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_input_specs_match_reference(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    for name, shape in pconfigs.SHAPES.items():
        if not pconfigs.shape_applicable(pcfg, shape)[0]:
            continue
        want = rspecs.input_specs(rcfg, rconfigs.SHAPES[name], rmesh)
        got = pspecs.input_specs(pcfg, shape, pmesh)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == w.shape, (name, k)
            assert _norm(got[k].spec) == _norm(w.sharding.spec), (name, k)
            assert got[k].meta.device.type == "meta"


@pytest.mark.parametrize("arch", pconfigs.ARCHITECTURES)
def test_total_params_matches_reference(arch):
    assert pspecs.total_params(pconfigs.get_config(arch)) == \
        rspecs.total_params(rconfigs.get_config(arch))


@pytest.mark.parametrize("arch", ["llama3_8b", "deepseek_v2_lite",
                                  "zamba2_1p2b"])
def test_abstract_train_state_allocates_nothing(arch):
    """Parameters and moments on the ``meta`` device with the parameter's
    spec; the step replicated."""
    _, pmesh = _meshes("16x16")
    cfg = pconfigs.get_config(arch)
    rules = pspecs.rules_for(pmesh, "train")
    params, opt, specs = pspecs.abstract_train_state(cfg, rules, pmesh)
    assert params.keys() == opt.mu.keys() == opt.nu.keys() == specs.keys()
    for k, a in params.items():
        assert a.meta.device.type == "meta" and a.spec == specs[k]
        assert opt.mu[k].spec == a.spec and opt.mu[k].dtype == torch.float32
    assert opt.step.spec == () and opt.step.dtype == torch.int32


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 4), (4, 4), (4, 16),
                                          (8, 3)])
def test_bubble_fraction_matches_reference(stages, micro):
    assert bubble_fraction(stages, micro) == ref_bubble(stages, micro)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_best_mesh_factorisation_matches_reference(tp):
    """Worlds of 1-8 ranks: the reference's ``best_mesh`` over that many
    (repeated) jax devices against the port's factorisation."""
    dev = jax.devices()[0]
    for n in range(1, 9):
        want = ref_best_mesh([dev] * n, model_parallel=tp).devices.shape
        assert best_mesh_shape(n, tp) == want


def test_placements_of_a_two_axis_dim_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    _, pmesh = _meshes("2x16x16")
    spec = psharding.PartitionSpec(("pod", "data"), None, "model")
    assert psharding.placements(spec, pmesh) == (Shard(0), Shard(0),
                                                 Shard(2))
    assert psharding.placements(psharding.PartitionSpec(), pmesh) == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        psharding.placements(psharding.PartitionSpec(("data", "pod")), pmesh)
    assert np.prod(pmesh.shape) == pmesh.size() == 512


def test_abstract_like_is_meta_tensors_with_their_specs():
    """The reference's ``abstract_like``: a tree's tensors as shapes and
    dtypes on the ``meta`` device with the spec ``spec_fn`` gives each,
    other leaves kept."""
    _, pmesh = _meshes("4x2")
    tree = {"w": torch.ones(8, 6), "cache": [{"k": torch.zeros(
        4, 2, dtype=torch.int64), "len": 3}]}
    out = abstract_like(tree, pmesh, lambda path, t: psharding.PartitionSpec(
        "data" if path == "w" else None, None))
    assert out["cache"][0]["len"] == 3
    w, k = out["w"], out["cache"][0]["k"]
    assert w.meta.device.type == k.meta.device.type == "meta"
    assert (w.shape, w.dtype, k.dtype) == ((8, 6), torch.float32,
                                          torch.int64)
    assert w.spec == ("data", None) and k.spec == (None, None)
    assert w.placements[0].is_shard(0) and not w.placements[1].is_shard()
