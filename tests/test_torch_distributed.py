"""The port's sharded path on the CPU: two ``gloo`` worlds, of 4 ranks and
then of 2, each rank a spawned process that rendezvouses through a file
under a temporary directory (no port), runs one thread, and writes what
it computed for the tests to read.  Each world runs the sharded halves of
several tests (a module fixture) and is killed, and its tests fail, if it
has not ended within ``JOIN_S``.

Held against the port's own unsharded path on the same seed: a (2, 2)
DP x TP ``TrainLoop``, a (2, 2) expert-parallel MoE loss, a (1, 2)
prefill and decode, a (2, 1) step with int8 compression, GPipe over 4
stages, a checkpoint saved by a world of 4 restored by a world of 2, and
``main --model-parallel 2`` in a world of 2.  The DP x TP loop and the EP
loss are also held against the reference package on the same weights
(the port's seed-0 model carried across with ``to_reference``) and
batches: its ``jax.value_and_grad(loss_fn)`` and its ``TrainLoop``.  JAX
is imported only inside those reference helpers, which run in the test
process: a spawned rank imports only this module's own dependencies.
"""

import dataclasses
import multiprocessing as mp
import time
import traceback

import numpy as np
import pytest
import torch

#: the seconds a world has to run to its end
JOIN_S = 120.0
B, S = 4, 32
ADAMW = dict(lr=1e-3, total_steps=20, warmup_steps=2)


def _entry(fn, rank, world, rdv, out, args):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        result = fn(rank, world, *args)
        if rank == 0:
            torch.save(result, out)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, tmp_path, *args):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks;
    returns rank 0's result."""
    tag = f"{fn.__name__}_{world}_{time.monotonic_ns()}"
    rdv, out = tmp_path / f"{tag}.rdv", tmp_path / f"{tag}.pt"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(rdv), str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{fn.__name__}: a world of {world} ran past {JOIN_S}s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{fn.__name__}: rank exit codes {codes}"
    return torch.load(out, weights_only=False)


def _cfg(arch, **kw):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **kw)


def _loop(cfg, ckpt, mesh=None, **kw):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig
    return TrainLoop(cfg=cfg, adamw=AdamWConfig(**ADAMW),
                     ckpt=Checkpointer(ckpt),
                     dataset=SyntheticLMDataset(vocab=cfg.vocab, seq_len=S,
                                                global_batch=B),
                     device="cpu", mesh=mesh, log_every=1, **kw)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _train(loop, steps):
    """(the first step's gradients as ``step_fn`` hands them on, whole:
    ``grads`` to the int8 round trip if there is one, else to
    ``adamw_update``, and ``updates`` to ``adamw_update`` after the round
    trip; the losses; the final parameters whole; the names of the
    parameters sharded on 'model')."""
    from repro_torch.launch import train
    seen = {}

    def spy(name, key):
        real = getattr(train, name)

        def fn(*args):
            grads = args[key]
            if name not in seen:    # every rank gathers: a collective
                seen[name] = {k: _whole(g).clone() for k, g in grads.items()}
            return real(*args)
        return real, fn

    reals = {}
    for name, key in (("compress_decompress", 0), ("adamw_update", 1)):
        reals[name], fn = spy(name, key)
        setattr(train, name, fn)
    try:
        res = loop.run(steps, start_step=0, state=loop.init_state())
    finally:
        for name, real in reals.items():
            setattr(train, name, real)
    updates = seen["adamw_update"]
    grads = seen.get("compress_decompress", updates)
    model = res["state"]["params"]
    tp = []
    if loop.mesh is not None:
        from torch.distributed.tensor import Shard
        i = loop.mesh.mesh_dim_names.index("model")
        tp = [k for k, p in model.named_parameters()
              if isinstance(p.placements[i], Shard)]
    return {"grads": grads, "updates": updates,
            "compressed": "compress_decompress" in seen,
            "losses": [h["loss"] for h in res["history"]],
            "params": {k: _whole(p.detach()).clone()
                       for k, p in model.named_parameters()},
            "tp": tp}


def _check_train(got, want, steps):
    """Losses within 1e-5 relative; each first-step gradient within 1e-5
    of its max; after an int8 round trip, each entry the optimiser reads
    at most one int8 step (max / 127) apart, where a rounding-level
    difference crosses a rounding boundary, and their median within 1e-5
    of the max; each final parameter a median |diff| <= 1e-6 and at most
    2·lr·steps apart (what AdamW moves an entry whose gradient sign flips
    at rounding level)."""
    for g, w in zip(got["losses"], want["losses"], strict=True):
        assert abs(g - w) <= 1e-5 * abs(w)
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        err = (got["grads"][k] - w).abs().max()
        assert err <= 1e-5 * w.abs().max().clamp_min(1e-30), k
    assert got["updates"].keys() == want["updates"].keys()
    for k, w in want["updates"].items():
        top = w.abs().max().clamp_min(1e-30)
        diff = (got["updates"][k] - w).abs()
        assert got["compressed"] == want["compressed"]
        if not want["compressed"]:
            assert diff.max() <= 1e-5 * top, k
        else:
            assert diff.max() <= top / 127 * (1 + 1e-5), k
            assert diff.median() <= 1e-5 * top, k
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        diff = (got["params"][k] - w).abs()
        assert diff.median() <= 1e-6, k
        assert diff.max() <= 2 * ADAMW["lr"] * steps, k


# ---------------------------------------------------------------------------
# the reference package, in the test process only
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def reference_of(arch, **kw):
    """``(the port's config, the reference's, the port's seed-0 weights as
    the reference's parameter tree of jax arrays)`` for ``arch`` at the
    smoke size in float32 (``kw`` replaced in both configs)."""
    import jax
    import jax.numpy as jnp
    import repro.configs as rconfigs
    from repro_torch.models import init_params, to_reference
    cfg = _cfg(arch, **kw)
    rcfg = dataclasses.replace(rconfigs.get_smoke_config(arch),
                               compute_dtype="float32", **kw)
    tree = to_reference(cfg, dict(init_params(0, cfg, device="cpu")
                                  .named_parameters()))
    return cfg, rcfg, jax.tree.map(jnp.asarray, tree)


def reference_loss_and_grads(rcfg, params, batch: dict):
    """The reference's ``value_and_grad(loss_fn)`` of ``batch`` (numpy):
    ``(loss, moe_aux, gradient tree of numpy arrays)``."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as rtf
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i"
                            else v) for k, v in batch.items()}
    (loss, aux), grads = jax.value_and_grad(
        lambda p: rtf.loss_fn(p, batch, rcfg), has_aux=True)(params)
    return float(loss), float(aux["moe_aux"]), jax.tree.map(np.asarray,
                                                           grads)


def assert_grads_match_reference(cfg, grads: dict, want, tol: float):
    """Each of the port's gradients (by parameter name), stacked as the
    reference stacks them, within ``tol`` of its leaf's max |value|."""
    import jax
    from repro_torch.models import to_reference
    errs = jax.tree.map(_rel, to_reference(cfg, grads), want)
    worst = max(jax.tree.leaves(errs))
    assert worst <= tol, jax.tree_util.tree_flatten_with_path(errs)


def _reference_train(steps, root):
    """The reference's ``TrainLoop`` on its mesh from the port's seed-0
    llama3-8b smoke weights: its first step's gradients, its losses, its
    final parameters."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import Checkpointer as RefCheckpointer
    from repro.data import SyntheticLMDataset as RefSynthetic
    from repro.distributed import best_mesh as ref_best_mesh
    from repro.launch.train import TrainLoop as RefTrainLoop
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import init_adamw as ref_init_adamw
    cfg, rcfg, params = reference_of("llama3_8b")
    loop = RefTrainLoop(cfg=rcfg, adamw=RefAdamWConfig(**ADAMW),
                        mesh=ref_best_mesh(), ckpt=RefCheckpointer(root),
                        dataset=RefSynthetic(vocab=rcfg.vocab, seq_len=S,
                                             global_batch=B), log_every=1)
    _, _, grads = reference_loss_and_grads(rcfg, params,
                                           loop.dataset.batch_at(0))
    res = loop.run(steps, start_step=0,
                   state={"params": params, "opt": ref_init_adamw(params),
                          "ef": {"_": jnp.zeros(())}})
    return {"cfg": cfg, "grads": grads,
            "losses": [h["loss"] for h in res["history"]],
            "params": jax.tree.map(np.asarray, res["state"]["params"])}


# ---------------------------------------------------------------------------
# (2, 2) DP x TP TrainLoop
# ---------------------------------------------------------------------------

def _dp_tp_rank(rank, world, ckpt, steps):
    from repro_torch.launch.mesh import make_host_mesh
    return _train(_loop(_cfg("llama3_8b"), f"{ckpt}/r{rank}",
                        make_host_mesh(2, 2)), steps)


def _four_ranks(rank, world, root):
    """The sharded halves on a world of 4: the (2, 2) ``TrainLoop``, EP,
    GPipe, and the checkpoint the world of 2 restores."""
    return {"dp_tp": _dp_tp_rank(rank, world, f"{root}/dp", 3),
            "ep": _ep_rank(rank, world),
            "pipe": _pipe_rank(rank, world, _pipe_input()),
            "save": _save_rank(rank, world, f"{root}/ck")}


def _two_ranks(rank, world, root):
    """The sharded halves on a world of 2, after the world of 4: the
    (1, 2) serve, the (2, 1) compressed steps, the restore of the world of
    4's checkpoint, ``main --model-parallel 2``."""
    return {"serve": _serve_rank(rank, world, _prompts()),
            "compressed": _compressed_rank(rank, world, f"{root}/c", 2),
            "restore": _restore_rank(rank, world, f"{root}/ck"),
            "main": _main_rank(rank, world, f"{root}/m")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("worlds")
    four = _spawn(_four_ranks, 4, root, str(root))
    return {**four, **_spawn(_two_ranks, 2, root, str(root)), "root": root}


def test_dp_tp_train_loop_matches_the_unsharded_loop(worlds, tmp_path):
    """Three steps on a (2, 2) ("data", "model") mesh: losses within 1e-5
    relative, step-1 gradients within 1e-5 of their max, final parameters
    a median |diff| <= 1e-6 and at most 2·lr·steps apart (what AdamW moves
    an entry whose gradient sign flips at rounding level), and some
    parameter sharded on "model"."""
    got = worlds["dp_tp"]
    want = _train(_loop(_cfg("llama3_8b"), tmp_path / "one"), 3)
    _check_train(got, want, 3)
    assert got["tp"]


def test_dp_tp_train_loop_matches_the_reference_loop(worlds, tmp_path):
    """The same three (2, 2) steps against the reference's ``TrainLoop``
    from the same weights on the same batches: each loss within 1e-5
    relative, each first-step gradient (as ``step_fn`` hands it to
    ``adamw_update``) within 1e-4 of its leaf's max, and each final
    parameter leaf a median |diff| <= 1e-6 and at most 2·lr·steps apart
    (AdamW's step is about lr whatever the gradient's size, so an entry
    whose gradient is near zero moves by rounding noise times lr/eps:
    the unsharded loop reads 1.1e-5 on 3 of lm_head's 16,384 entries)."""
    import jax
    from repro_torch.models import to_reference
    got = worlds["dp_tp"]
    want = _reference_train(3, tmp_path / "ref")
    for g, w in zip(got["losses"], want["losses"], strict=True):
        assert abs(g - w) <= 1e-5 * abs(w)
    assert_grads_match_reference(want["cfg"], got["grads"], want["grads"],
                                 1e-4)
    diffs = jax.tree.map(lambda g, w: np.abs(g - w),
                         to_reference(want["cfg"], got["params"]),
                         want["params"])
    for path, diff in jax.tree_util.tree_flatten_with_path(diffs)[0]:
        assert np.median(diff) <= 1e-6, path
        assert diff.max() <= 2 * ADAMW["lr"] * 3, path


# ---------------------------------------------------------------------------
# (2, 2) expert parallelism
# ---------------------------------------------------------------------------

def _moe_batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)),
            "labels": rng.integers(0, cfg.vocab, (B, S))}


def _ep_rank(rank, world):
    from torch.distributed.tensor import Shard
    from repro_torch.data import make_global_batch
    from repro_torch.distributed import reshard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import param_specs, rules_for
    from repro_torch.models import init_params, loss_fn
    cfg = _cfg("granite_moe_3b")
    mesh = make_host_mesh(2, 2)
    rules = rules_for(mesh, "train", cfg)
    model = init_params(0, cfg, device="cpu")
    specs = param_specs(cfg, model, rules, mesh)
    reshard(model, mesh, lambda name, _: specs[name])
    batch = make_global_batch(_moe_batch(cfg), mesh, ("data",))
    with torch.no_grad():
        loss, m = loss_fn(model, batch, cfg, mesh=mesh, rules=rules)
    wg = model.layers[0].moe.wg
    return {"loss": float(_whole(loss)), "aux": float(_whole(m["moe_aux"])),
            "ep": isinstance(wg.placements[1], Shard)
            and wg.placements[1].dim == 0}


def test_expert_parallel_moe_loss_matches_the_unsharded_loss(worlds):
    """granite-moe-3b's smoke config on (2, 2), the experts sharded on
    "model": the loss and the load-balancing loss within 1e-5."""
    from repro_torch.data import make_device_batch
    from repro_torch.models import init_params, loss_fn
    got = worlds["ep"]
    cfg = _cfg("granite_moe_3b")
    with torch.no_grad():
        loss, m = loss_fn(init_params(0, cfg, device="cpu"),
                          make_device_batch(_moe_batch(cfg), "cpu"), cfg)
    assert got["ep"]
    assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    assert abs(got["aux"] - float(m["moe_aux"])) <= 1e-5 * abs(
        float(m["moe_aux"]))


def test_expert_parallel_moe_loss_matches_the_reference(worlds):
    """The same (2, 2) EP run against the reference's ``loss_fn`` on the
    same weights and batch: the loss and the load-balancing loss within
    1e-5 relative."""
    got = worlds["ep"]
    _, rcfg, params = reference_of("granite_moe_3b")
    loss, aux, _ = reference_loss_and_grads(rcfg, params,
                                            _moe_batch(_cfg("granite_moe_3b")))
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    assert abs(got["aux"] - aux) <= 1e-5 * abs(aux)


# ---------------------------------------------------------------------------
# (1, 2) serving
# ---------------------------------------------------------------------------

def _serve(cfg, model, mesh, rules, prompts, steps=4):
    """Greedy prefill + ``steps`` decode steps: (the logits of each call
    whole, the tokens)."""
    from repro_torch.data import make_global_batch
    from repro_torch.distributed import reshard
    from repro_torch.launch.specs import cache_leaf_spec
    from repro_torch.models import decode_step, init_decode_state, prefill
    caches = init_decode_state(cfg, B, S + steps + 1, dtype=torch.float32,
                               device="cpu")
    axes = None
    if mesh is not None:
        caches = reshard(caches, mesh, lambda p, t: cache_leaf_spec(
            cfg, rules, mesh, p, t))
        axes = ("data",)

    def place(x):
        return make_global_batch({"x": x}, mesh, axes, device="cpu")["x"]

    kw = dict(mesh=mesh, rules=rules)
    with torch.no_grad():
        logits, _ = prefill(model, {"tokens": place(prompts)}, caches, cfg,
                            **kw)
        out, toks = [_whole(logits)], []
        for _ in range(steps):
            tok = out[-1][:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
            logits, _ = decode_step(model, place(tok.numpy()), caches, cfg,
                                    **kw)
            out.append(_whole(logits))
    return out, torch.cat(toks, dim=1)


def _serve_rank(rank, world, prompts):
    from repro_torch.distributed import reshard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import ServeSession
    from repro_torch.launch.specs import param_specs, rules_for
    from repro_torch.models import init_params
    cfg = _cfg("llama3_8b")
    mesh = make_host_mesh(1, 2)
    rules = rules_for(mesh, "decode", cfg)
    model = init_params(0, cfg, device="cpu")
    specs = param_specs(cfg, model, rules, mesh)
    reshard(model, mesh, lambda name, _: specs[name])
    logits, toks = _serve(cfg, model, mesh, rules, prompts)
    sess = ServeSession(cfg=cfg, params=model, max_len=S + 8, device="cpu",
                        mesh=mesh, rules=rules)
    return {"logits": logits, "tokens": toks,
            "generated": sess.generate(prompts, max_new=4)}


def _prompts():
    return np.random.default_rng(1).integers(0, 256, (B, S))


def test_sharded_prefill_and_decode_match_the_unsharded(worlds):
    """llama3-8b's smoke config served on (1, 2): prefill and 4 decode
    steps' logits within 1e-5 of their max, the greedy tokens equal, and
    ``ServeSession(mesh=...)`` generating the same tokens."""
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models import init_params
    prompts = _prompts()
    got = worlds["serve"]
    cfg = _cfg("llama3_8b")
    model = init_params(0, cfg, device="cpu")
    logits, toks = _serve(cfg, model, None, None, prompts)
    for g, w in zip(got["logits"], logits, strict=True):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    assert torch.equal(got["tokens"], toks)
    sess = ServeSession(cfg=cfg, params=model, max_len=S + 8, device="cpu")
    np.testing.assert_array_equal(got["generated"],
                                  sess.generate(prompts, max_new=4))
    np.testing.assert_array_equal(got["generated"], toks.numpy())


# ---------------------------------------------------------------------------
# (2, 1) with int8 gradient compression
# ---------------------------------------------------------------------------

def _compressed_rank(rank, world, ckpt, steps):
    from repro_torch.launch.mesh import make_host_mesh
    return _train(_loop(_cfg("llama3_8b"), f"{ckpt}/r{rank}",
                        make_host_mesh(2, 1), grad_compression=True), steps)


def test_compressed_sharded_step_matches_the_unsharded_compressed_step(
        worlds, tmp_path):
    """Two steps with int8 compression and error feedback on (2, 1): the
    per-tensor scale reduces across the data shards, so the sharded step
    is the unsharded one within the DP-step tolerances."""
    got = worlds["compressed"]
    want = _train(_loop(_cfg("llama3_8b"), tmp_path / "one",
                        grad_compression=True), 2)
    _check_train(got, want, 2)


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _pipe_weights():
    return torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, 16)).astype(np.float32) * 0.3)


def _pipe_rank(rank, world, x):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import gpipe_forward
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    return gpipe_forward(lambda w, h: torch.tanh(h @ w),
                         _pipe_weights()[rank], x, mesh=mesh,
                         n_microbatches=4)


def _pipe_input():
    return torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 16)).astype(np.float32))


def test_gpipe_matches_the_sequential_stages(worlds):
    """4 stages of ``tanh(h @ w)``, 4 microbatches: within 1e-5 of the
    stages run in turn (the reference's test)."""
    from repro_torch.distributed import bubble_fraction
    x = _pipe_input()
    got = worlds["pipe"]
    want = x
    for w in _pipe_weights():
        want = torch.tanh(want @ w)
    assert got.shape == x.shape
    assert (got - want).abs().max() <= 1e-5
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)


# ---------------------------------------------------------------------------
# elastic: a world of 4 saves, a world of 2 restores
# ---------------------------------------------------------------------------

def _whole_state(state):
    return {"params": {k: _whole(p.detach()).clone()
                       for k, p in state["params"].named_parameters()},
            "mu": {k: _whole(t).clone() for k, t in state["opt"].mu.items()},
            "step": int(_whole(state["opt"].step))}


def _save_rank(rank, world, ckpt):
    from repro_torch.distributed import reshard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import param_specs
    loop = _loop(_cfg("llama3_8b"), ckpt, make_host_mesh(2, 2))
    res = loop.run(2, start_step=0, state=loop.init_state())
    state = res["state"]
    saved = _whole_state(state)
    # a live move to a (4, 1) mesh keeps every value
    other = make_host_mesh(4, 1)
    from repro_torch.launch.specs import rules_for
    rules = rules_for(other, "train")
    specs = param_specs(loop.cfg, state["params"], rules, other)
    moved = reshard(state["params"], other, lambda name, _: specs[name])
    same = all(torch.equal(_whole(p.detach()), saved["params"][k])
               for k, p in moved.named_parameters())
    return {"saved": saved, "reshard_equal": same}


def _restore_rank(rank, world, ckpt):
    from repro_torch.launch.mesh import make_host_mesh
    loop = _loop(_cfg("llama3_8b"), ckpt, make_host_mesh(1, 2))
    step, state = loop.restore_or_init(seed=7)
    return {"step": step, "state": _whole_state(state)}


def test_a_world_of_four_saves_and_a_world_of_two_restores(worlds):
    """Two steps on (2, 2) saved at step 2; a (1, 2) world of 2 restores it
    bit for bit (over its own init from another seed), as does the
    unsharded loop; a live ``reshard`` onto a (4, 1) mesh keeps every
    value."""
    ckpt = str(worlds["root"] / "ck")
    got, back = worlds["save"], worlds["restore"]
    assert got["reshard_equal"]
    assert back["step"] == 2
    step, one = _loop(_cfg("llama3_8b"), ckpt).restore_or_init(seed=7)
    assert step == 2
    for state in (back["state"], _whole_state(one)):
        assert state["step"] == got["saved"]["step"] == 2
        for part in ("params", "mu"):
            for k, want in got["saved"][part].items():
                assert torch.equal(state[part][k], want), (part, k)


# ---------------------------------------------------------------------------
# main --model-parallel 2 in a world of 2
# ---------------------------------------------------------------------------

def _main_rank(rank, world, ckpt):
    from torch.distributed.tensor import Shard
    import torch.distributed as dist
    from repro_torch.launch import train
    out = train.main(["--smoke", "--device", "cpu", "--model-parallel", "2",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt", ckpt])
    model = out["state"]["params"]
    mesh = next(model.parameters()).device_mesh
    from repro_torch.launch.mesh import make_production_mesh
    try:
        make_production_mesh()
        production = None
    except ValueError as e:
        production = str(e)
    return {"shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "production": production,
            "tp": any(isinstance(p.placements[1], Shard)
                      for p in model.parameters()),
            "loss": out["history"][-1]["loss"], "step": out["final_step"],
            "world_up": dist.is_initialized()}


def test_main_model_parallel_two_trains_on_a_world_of_two(worlds):
    """``main --model-parallel 2`` joins the world it finds (2 ranks),
    trains on a (1, 2) mesh with some parameter sharded on "model", and
    leaves that world up for its owner; the production mesh refuses a
    world of 2."""
    got = worlds["main"]
    assert "256" in got["production"]
    assert got["shape"] == {"data": 1, "model": 2}
    assert got["tp"] and got["step"] == 2 and np.isfinite(got["loss"])
    assert got["world_up"]
