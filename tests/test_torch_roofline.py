"""The port's roofline (``roofline/{analysis,collectives,counting,
costing}.py`` and ``launch/dryrun.py``'s pure parts) against the
reference package's and against counts made by hand.

- ``model_flops``, ``_active_params`` and ``cell_units`` for the 10
  architectures x 4 shapes, ``roofline()`` on the same ``HW`` values,
  ``corrected_costs`` on seeded records, ``wire_bytes`` on a grid and
  ``COLLECTIVE_KINDS``: equal to the reference's.
- ``HW`` carries the H100's constants and no v5e number.
- The per-rank counter on a fake (4, 4) world: a column-then-row-parallel
  MLP's FLOPs and its one all-reduce by hand, where a count of the DTensor
  ops (``FlopCounterMode``) reads the whole mesh's 16x.
- FLOP parity with the reference's program: the smoke config of every
  architecture (unrouted, float32), prefill, decode and a train step's
  loss and gradients, the port's counted FLOPs against 2·batch·m·k·n over
  the ``dot_general`` equations of the reference's ``jax.make_jaxpr``
  (each scan body times its ``length``).  A ``dot_general`` without a
  contracted dim (Mamba2's and RWKV6's state updates) is an elementwise
  product, which ``torch.einsum`` multiplies and torch's formulas do not
  count: it is printed beside the count and left out of it.  Prefill and
  decode exact.  The train step within 1 % of the reference as it runs,
  its chunk steps (the flash kv step, the SSD and WKV chunk steps) under
  ``jax.checkpoint``: the port's chunk loops recompute what those
  checkpoints recompute, five products a flash block in the backward
  pass, ten an SSD or WKV chunk.  No loop of these programs has a trip
  count that is not static.
- ``argument_bytes`` of every architecture x {train, prefill, decode} x
  {16x16, 2x16x16}, from the port's specs with no world, against the
  shard bytes of the reference's abstract state
  (``NamedSharding(AbstractMesh, spec).shard_shape``).
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh

import repro.configs as rconfigs
import repro.models as rmodels
from repro.launch import specs as rspecs
from repro.roofline import analysis as ranalysis
from repro.roofline import costing as rcosting
from repro.roofline import hlo_parse as rhlo
import repro_torch.configs as pconfigs
from repro_torch.launch import dryrun as pdryrun
from repro_torch.launch import specs as pspecs
from repro_torch.models import sharding as psharding
from repro_torch.roofline import analysis as panalysis
from repro_torch.roofline import collectives as pcoll
from repro_torch.roofline import costing as pcosting

ARCHS = pconfigs.ARCHITECTURES


def _reference_dryrun():
    """The reference's ``launch/dryrun.py``.  Importing it sets
    ``XLA_FLAGS`` to 512 host devices for its own CLI; the variable is put
    back, so that a test that starts JAX's backend later in this process
    gets the devices it would have had."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


rdryrun = _reference_dryrun()
SHAPES = tuple(pconfigs.SHAPES)


# ---------------------------------------------------------------------------
# the reference's pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_active_params_and_units_match_reference(arch):
    pcfg, rcfg = pconfigs.get_config(arch), rconfigs.get_config(arch)
    assert pdryrun._active_params(pcfg) == rdryrun._active_params(rcfg)
    for name in SHAPES:
        pshape, rshape = pconfigs.SHAPES[name], rconfigs.SHAPES[name]
        n = pdryrun._active_params(pcfg)
        assert panalysis.model_flops(pcfg, pshape, n) == \
            ranalysis.model_flops(rcfg, rshape, n)
        got = [dataclasses.asdict(u) for u in pcosting.cell_units(pcfg,
                                                                  pshape)]
        want = [dataclasses.asdict(u) for u in rcosting.cell_units(rcfg,
                                                                   rshape)]
        assert got == want, name


def test_roofline_matches_reference_on_the_same_hw():
    rng = np.random.default_rng(0)
    hw = panalysis.HW()
    rhw = ranalysis.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                       ici_bw=hw.ici_bw, ici_links=hw.ici_links)
    for _ in range(50):
        kw = dict(arch="a", shape="s", mesh="single",
                  chips=int(rng.choice([256, 512])),
                  hlo_flops=float(rng.uniform(0, 1e15)),
                  hlo_bytes=float(rng.uniform(0, 1e12)),
                  collective_bytes=float(rng.uniform(0, 1e11)),
                  model_flops_=float(rng.uniform(0, 1e17)))
        assert panalysis.roofline(**kw).as_dict() == \
            ranalysis.roofline(**kw, hw=rhw).as_dict()
    zero = dict(arch="a", shape="s", mesh="m", chips=1, hlo_flops=0.0,
                hlo_bytes=1.0, collective_bytes=0.0, model_flops_=1.0)
    assert panalysis.roofline(**zero).as_dict() == \
        ranalysis.roofline(**zero, hw=rhw).as_dict()


def test_hw_is_the_h100_with_no_v5e_number():
    hw = panalysis.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.ici_links) == \
        (989.4e12, 3.35e12, 25e9, 18)
    v5e = ranalysis.HW()
    for f in dataclasses.fields(hw):
        assert getattr(hw, f.name) != getattr(v5e, f.name), f.name
    assert [f.name for f in dataclasses.fields(hw)] == \
        [f.name for f in dataclasses.fields(v5e)]
    import inspect
    src = inspect.getsource(panalysis.HW)
    assert src.count("NVIDIA H100 SXM 80GB HBM3, 700 W") == 4


def test_corrected_costs_match_reference_on_seeded_records():
    rng = np.random.default_rng(1)
    for _ in range(20):
        prod = {k: float(rng.uniform(0, 1e12)) for k in ("flops", "bytes",
                                                          "coll")}
        precs, rrecs = [], []
        for _ in range(int(rng.integers(1, 5))):
            kw = dict(kind="attn", count=int(rng.integers(1, 40)),
                      prod_copies=int(rng.integers(0, 3)),
                      loop_family="attn", trips=int(rng.integers(0, 64)),
                      n_instances=int(rng.integers(1, 3)))
            once = {k: float(rng.uniform(0, 1e10)) for k in prod}
            total = {k: float(rng.uniform(0, 1e11)) for k in prod}
            precs.append({"unit": pcosting.Unit(**kw), "once": once,
                          "total": total})
            rrecs.append({"unit": rcosting.Unit(**kw), "once": once,
                          "total": total})
        assert pcosting.corrected_costs(prod, precs) == \
            rcosting.corrected_costs(prod, rrecs)


def test_wire_bytes_and_kinds_match_reference():
    assert pcoll.COLLECTIVE_KINDS == rhlo.COLLECTIVE_KINDS
    for kind in rhlo.COLLECTIVE_KINDS:
        for nbytes in (0, 1, 4096, 3 * 2 ** 30 + 7):
            for group in (0, 1, 2, 16, 256, 512):
                assert pcoll.wire_bytes(kind, nbytes, group) == \
                    rhlo.wire_bytes(kind, nbytes, group)


# ---------------------------------------------------------------------------
# the per-rank counter against a hand count, on a fake (4, 4) world
# ---------------------------------------------------------------------------

def test_per_rank_counter_matches_the_hand_counted_mlp():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.roofline.counting import count_step, fake_dtensor
    B, d, f = 64, 32, 128
    with pdryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        P = psharding.PartitionSpec
        with FakeTensorMode():
            x = fake_dtensor((B, d), torch.float32, mesh,
                                     P("data", None), "cpu")
            w1 = fake_dtensor((d, f), torch.float32, mesh,
                                      P(None, "model"), "cpu")
            w2 = fake_dtensor((f, d), torch.float32, mesh,
                                      P("model", None), "cpu")

            def mlp(x, w1, w2):
                return (torch.relu(x @ w1) @ w2).redistribute(
                    mesh, [Shard(0), Replicate()])

            got = count_step(mlp, x, w1, w2)
            with FlopCounterMode(display=False) as global_count:
                mlp(x, w1, w2)
    per_rank = 2 * (B // 4) * d * (f // 4) * 2
    assert got["flops"] == per_rank
    assert got["coll"]["total_count"] == 1
    assert got["coll"]["all-reduce"] == {
        "count": 1, "operand_bytes": (B // 4) * d * 4,
        "result_bytes": (B // 4) * d * 4}
    (event,) = got["coll_events"]
    assert (event.kind, event.group, event.dtype) == ("all-reduce", 4,
                                                      torch.float32)
    # what a count of the DTensor ops reads: the whole mesh's work
    assert global_count.get_total_flops() == 16 * per_rank
    assert got["argument_bytes"] == 4 * ((B // 4) * d + d * (f // 4)
                                         + (f // 4) * d)
    assert got["output_bytes"] == (B // 4) * d * 4


def test_collective_counter_alone_gives_the_reference_dict():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.roofline.counting import fake_dtensor
    with pdryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        P = psharding.PartitionSpec
        with FakeTensorMode():
            x = fake_dtensor((8, 16), torch.float32, mesh,
                                     P(None, "model"), "cpu")
            with pcoll.CollectiveCounter() as cc:
                y = x.redistribute(mesh, [Replicate(), Replicate()])
                y.redistribute(mesh, [Shard(0), Replicate()])
    out = cc.summary()
    assert set(out) == set(rhlo.COLLECTIVE_KINDS) | {"total_operand_bytes",
                                                      "total_count"}
    assert out["all-gather"] == {"count": 1, "operand_bytes": 8 * 4 * 4,
                                 "result_bytes": 8 * 16 * 4}
    assert out["total_count"] == 1     # Replicate -> Shard is a local chunk


# ---------------------------------------------------------------------------
# FLOP parity with the reference's program
# ---------------------------------------------------------------------------

def _dot_flops(jaxpr, mult: int = 1) -> tuple[int, int]:
    """2·batch·m·k·n over the ``dot_general`` equations of ``jaxpr`` and
    its sub-jaxprs, a scan body counted ``length`` times: ``(with a
    contracted dim, without one)``.  A ``dot_general`` with no contracted
    dim is an elementwise product (k = 1), which ``torch.einsum``
    computes as a multiply and torch's FLOP formulas do not count."""
    total, outer = 0, 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            ls, rs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            prod = lambda dims: int(np.prod(dims)) if dims else 1
            n = mult * 2 * prod([ls[i] for i in lb]) \
                * prod([ls[i] for i in lc]) \
                * prod([ls[i] for i in range(len(ls))
                        if i not in lc and i not in lb]) \
                * prod([rs[i] for i in range(len(rs))
                        if i not in rc and i not in rb])
            if lc:
                total += n
            else:
                outer += n
            continue
        assert eqn.primitive.name != "while", "a loop of unknown trips"
        inner = mult * (eqn.params["length"]
                        if eqn.primitive.name == "scan" else 1)
        for v in eqn.params.values():
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                sub = getattr(x, "jaxpr", x)
                if hasattr(sub, "eqns"):
                    t, o = _dot_flops(sub, inner)
                    total, outer = total + t, outer + o
    return total, outer


B_PAR, S_PAR = 2, 64


def _parity_setup(arch):
    from repro_torch.models import init_params
    pcfg = dataclasses.replace(pconfigs.get_smoke_config(arch),
                               compute_dtype="float32",
                               use_pallas_gemm=False)
    rcfg = dataclasses.replace(rconfigs.get_smoke_config(arch),
                               compute_dtype="float32",
                               use_pallas_gemm=False)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, pcfg.vocab, (B_PAR, S_PAR)),
             "labels": rng.integers(0, pcfg.vocab, (B_PAR, S_PAR))}
    if pcfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B_PAR, pcfg.enc_seq, pcfg.d_model)).astype(np.float32)
    if pcfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B_PAR, pcfg.vision_tokens, pcfg.d_model)).astype(np.float32)
    max_len = S_PAR + pcfg.vision_tokens + 8
    rparams = jax.eval_shape(
        lambda: rmodels.init_params(jax.random.PRNGKey(0), rcfg))
    rcaches = jax.eval_shape(lambda: rmodels.init_decode_state(
        rcfg, B_PAR, max_len, dtype="float32"))
    model = init_params(0, pcfg, device="cpu")
    return pcfg, rcfg, batch, max_len, rparams, rcaches, model


def _torch_batch(batch, keys):
    return {k: (torch.from_numpy(batch[k]).long()
                if batch[k].dtype.kind == "i" else torch.from_numpy(batch[k]))
            for k in keys}


@pytest.mark.parametrize("arch", ARCHS)
def test_counted_flops_match_the_reference_jaxpr(arch):
    from repro_torch.models import (decode_step, init_decode_state,
                                    loss_fn, prefill)
    from repro_torch.roofline.counting import count_step
    pcfg, rcfg, batch, max_len, rparams, rcaches, model = \
        _parity_setup(arch)
    rb = {k: jnp.asarray(v, jnp.float32 if v.dtype.kind == "f"
                         else jnp.int32) for k, v in batch.items()}
    inputs = [k for k in batch if k != "labels"]

    # prefill
    want, outer = _dot_flops(jax.make_jaxpr(
        lambda p, b, c: rmodels.prefill(p, b, c, rcfg))(
            rparams, {k: rb[k] for k in inputs}, rcaches).jaxpr)
    caches = init_decode_state(pcfg, B_PAR, max_len, dtype=torch.float32,
                               device="cpu")
    with torch.no_grad():
        got = count_step(lambda: prefill(model, _torch_batch(batch, inputs),
                                         caches, pcfg))
    print(f"{arch}: prefill FLOPs {got['flops']} vs the reference's {want}"
          f" (+ {outer} of products without contraction)")
    assert got["flops"] == want, ("prefill", got["flops"], want)

    # decode: one token (Whisper against a zero encoder output)
    kw, tkw = {}, {}
    if pcfg.family == "audio":
        kw["enc_out"] = jnp.zeros((B_PAR, rcfg.enc_seq, rcfg.d_model))
        tkw["enc_out"] = torch.zeros((B_PAR, pcfg.enc_seq, pcfg.d_model))
    want, outer = _dot_flops(jax.make_jaxpr(
        lambda p, t, c: rmodels.decode_step(p, t, c, rcfg, **kw))(
            rparams, jnp.zeros((B_PAR, 1), jnp.int32), rcaches).jaxpr)
    with torch.no_grad():
        got = count_step(lambda: decode_step(
            model, torch.zeros((B_PAR, 1), dtype=torch.long), caches, pcfg,
            **tkw))
    print(f"{arch}: decode FLOPs {got['flops']} vs the reference's {want}"
          f" (+ {outer} of products without contraction)")
    assert got["flops"] == want, ("decode", got["flops"], want)

    # a train step's loss and gradients
    def ref_train():
        return _dot_flops(jax.make_jaxpr(
            lambda p, b: jax.value_and_grad(
                lambda q: rmodels.loss_fn(q, b, rcfg)[0])(p))(
                    rparams, rb).jaxpr)

    want, outer = ref_train()
    model.requires_grad_(True)
    tb = _torch_batch(batch, list(batch))

    def step():
        loss, _ = loss_fn(model, tb, pcfg)
        loss.backward()

    got = count_step(step)["flops"]
    gap = got / want - 1.0
    print(f"{arch}: train FLOPs {got} vs the reference's {want} as it runs, "
          f"its chunk steps recomputed ({gap:+.4%}; + {outer} of products "
          f"without contraction)")
    assert abs(gap) <= 0.01


# ---------------------------------------------------------------------------
# argument bytes against the reference's abstract state
# ---------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_shard_bytes(tree) -> int:
    """The shard bytes of every leaf of the reference's abstract tree."""
    total = 0
    for leaf in jax.tree.leaves(tree):
        shard = leaf.sharding.shard_shape(leaf.shape)
        total += int(np.prod(shard)) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_shard_bytes(arch):
    """The port's tokens and labels are int64 (its gathers' index dtype),
    the reference's int32; the reference's caches carry a ``len`` counter
    a layer (int32, replicated), the port's a Python int: the sums are
    compared with those two differences accounted for, leaf by leaf."""
    pcfg, rcfg = pconfigs.get_config(arch), rconfigs.get_config(arch)
    for mesh_name, (shape, axes) in MESHES.items():
        rmesh = RefAbstractMesh(shape, axes)
        pmesh = psharding.AbstractMesh(shape, axes)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            rshape, pshape = rconfigs.SHAPES[name], pconfigs.SHAPES[name]
            rrules = rspecs.rules_for(rmesh, rshape.kind, rcfg)
            prules = pspecs.rules_for(pmesh, pshape.kind, pcfg)
            binputs = rspecs.input_specs(rcfg, rshape, rmesh)
            tokens = sum(int(np.prod(v.sharding.shard_shape(v.shape)))
                         for k, v in binputs.items()
                         if k in ("tokens", "labels"))
            lens = 0
            if rshape.kind == "train":
                aparams, astate, _ = rspecs.abstract_train_state(
                    rcfg, rrules, rmesh)
                want = _ref_shard_bytes((aparams, astate, binputs))
            else:
                aparams, _ = rspecs.abstract_params(rcfg, rrules, rmesh)
                aparams = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                    s.shape, np.dtype(rcfg.compute_dtype)
                    if s.dtype == np.float32 else s.dtype,
                    sharding=s.sharding), aparams)
                acaches, _ = rspecs.abstract_caches(
                    rcfg, rshape.global_batch, rshape.seq_len, rrules,
                    rmesh)
                lens = sum(4 * int(np.prod(v.shape)) for path, v in
                           jax.tree_util.tree_leaves_with_path(acaches)
                           if str(path[-1]) == "['len']")
                want = _ref_shard_bytes((aparams, binputs, acaches))
            got = pdryrun.argument_bytes(pcfg, pshape, pmesh, prules)
            assert got == want + 4 * tokens - lens, (mesh_name, name)
