"""The port's training path (``repro_torch.models.transformer.loss_fn``, the
losses of ``models/layers.py``, remat, ``launch/train.py``) against the
reference package's on the same weights and batches, on the CPU.

Both packages get the parameters of one seeded reference ``init_params``
(the port through ``from_reference``) and the same numpy batch.  The
reference's ``jax.value_and_grad(loss_fn)`` is held against the port's
``loss_fn`` and ``backward()`` for every architecture, leaf by leaf (the
port's gradients carried back with ``to_reference``), in float32 with the
MoE capacity ample as ``tests/test_models.py`` runs its equivalence tests.
Also: the VLM's loss pad, the chunked CE against the materialised one,
every remat mode against none, the routed config under grad, and three
``TrainLoop`` steps against the reference's ``TrainLoop`` on its mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.data import SyntheticLMDataset as RefSynthetic
from repro.distributed import best_mesh
from repro.launch.train import TrainLoop as RefTrainLoop
from repro.models import layers as rl
from repro.models import mamba2 as rm2
from repro.models import rwkv6 as rrw
from repro.models import transformer as rtf
from repro.optim import AdamWConfig as RefAdamWConfig
import repro_torch.configs as pconfigs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train
from repro_torch.launch.train import TrainLoop
from repro_torch.models import layers as pl
from repro_torch.models import mamba2 as pm2
from repro_torch.models import rwkv6 as prw
from repro_torch.models import transformer as ptf
from repro_torch.optim import AdamWConfig

#: the loss's relative error, and each gradient leaf's max |error| over its
#: max |reference| value.  The two sum float32 products in other orders;
#: the smoke configs read at most 2e-7 (loss) and 1e-5 (a gradient leaf).
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 24


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfgs(arch, **kw):
    """The reference's and the port's smoke config, float32 compute, the
    MoE capacity ample (no token dropped)."""
    kw = dict(compute_dtype="float32", capacity_factor=8.0, **kw)
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **kw))


def _batch(cfg, seed=0) -> dict:
    """Tokens and labels (the last position masked) of (B, S), Whisper's
    frames or the VLM's vision embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, -1] = -1
    batch["labels"] = labels
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(model, batch, cfg):
    model.requires_grad_(True)
    loss, metrics = ptf.loss_fn(model, _torch_batch(batch), cfg)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss.detach(), metrics, grads


@pytest.mark.parametrize("arch", pconfigs.ARCHITECTURES)
def test_loss_and_every_gradient_match_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree.map(np.asarray, params)
    batch = _batch(rcfg)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: rtf.loss_fn(p, jax.tree.map(jnp.asarray, batch), rcfg),
        has_aux=True)(params)
    model = ptf.from_reference(pcfg, tree, device="cpu")
    # the parameters carry back unchanged
    jax.tree.map(np.testing.assert_array_equal, tree, ptf.to_reference(
        pcfg, dict(model.named_parameters())))
    got, metrics, pgrads = _port_loss_and_grads(model, batch, pcfg)
    assert abs(float(got) - float(loss)) <= LOSS_TOL * abs(float(loss))
    assert float(metrics["moe_aux"].detach()) == pytest.approx(
        float(aux["moe_aux"]), rel=LOSS_TOL, abs=1e-7)
    assert all(g is not None for g in pgrads.values())
    errs = jax.tree.map(_rel, ptf.to_reference(pcfg, pgrads),
                        jax.tree.map(np.asarray, grads))
    worst = max(jax.tree.leaves(errs))
    assert worst <= GRAD_TOL, jax.tree_util.tree_flatten_with_path(errs)


def test_vlm_loss_skips_the_vision_prefix():
    """The VLM's loss is the CE of the text positions' logits alone: the
    vision tokens ahead of the prompt carry labels -1."""
    _, cfg = _cfgs("internvl2_76b", ce_chunk=0)
    model = ptf.init_params(0, cfg, device="cpu")
    batch = _torch_batch(_batch(cfg))
    loss, metrics = ptf.loss_fn(model, batch, cfg)
    logits, _ = ptf.forward(model, batch, cfg)
    assert logits.shape[1] == cfg.vision_tokens + S
    want = pl.cross_entropy(logits[:, cfg.vision_tokens:], batch["labels"])
    assert torch.allclose(metrics["ce"], want, rtol=1e-6, atol=0)
    assert torch.equal(loss, metrics["ce"])       # no MoE term


@pytest.mark.parametrize("chunk", (5, 16, 2048))
@pytest.mark.parametrize("z_loss", (0.0, 1e-4))
def test_chunked_cross_entropy_matches_materialised_and_reference(chunk,
                                                                   z_loss):
    """Chunks that do not divide S (padded with label -1), one chunk, and
    chunks over the whole sequence; labels < 0 masked; value and gradients
    against the (B, S, V) logits' CE, and the value against the
    reference's chunked CE."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    labels = rng.integers(-1, 50, (B, S)).astype(np.int32)
    xs = [torch.from_numpy(x).requires_grad_(True) for _ in range(2)]
    ws = [torch.from_numpy(w).requires_grad_(True) for _ in range(2)]
    lab = torch.from_numpy(labels).long()
    got = pl.chunked_cross_entropy(xs[0], ws[0], lab, chunk=chunk,
                                   z_loss=z_loss)
    want = pl.cross_entropy(xs[1] @ ws[1], lab, z_loss=z_loss)
    got.backward()
    want.backward()
    got, want = float(got.detach()), float(want.detach())
    assert got == pytest.approx(want, rel=1e-6)
    assert _rel(xs[0].grad, xs[1].grad) <= 1e-6
    assert _rel(ws[0].grad, ws[1].grad) <= 1e-6
    ref = rl.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(labels), chunk=chunk,
                                   z_loss=z_loss)
    assert got == pytest.approx(float(ref), rel=1e-6)


@pytest.mark.parametrize("repeat", range(1, 65))
def test_nest_factors_match_reference(repeat):
    assert ptf._nest_factors(repeat) == rtf._nest_factors(repeat)


def _count_block_calls(monkeypatch):
    calls = []
    forward = ptf.Block.forward

    def counted(self, *a, **kw):
        calls.append(self.kind)
        return forward(self, *a, **kw)

    monkeypatch.setattr(ptf.Block, "forward", counted)
    return calls


#: block forward calls of one forward + backward at 8 layers: the forward
#: and each mode's recomputation.  ``nested`` (4 groups of 2): a group's
#: recomputation runs its blocks up to its last block's input, which is all
#: it saved (the checkpoint's early stop), then each block's own: 8 + 4 + 8
REMAT_CALLS = {"none": 8, "block": 16, "dots": 16, "nested": 20}


@pytest.mark.parametrize("remat", ("block", "dots", "nested"))
def test_remat_changes_no_number(remat, monkeypatch):
    """llama3's smoke config at 8 layers (``nested``: 4 groups of 2) and
    Whisper's (its encoder's blocks): the loss and every gradient under
    ``remat`` equal those without remat bit for bit, and the blocks run
    as often as the scheme recomputes them."""
    for arch, layers in (("llama3_8b", 8), ("whisper_medium", None)):
        kw = {"n_layers": layers} if layers else {}
        _, cfg = _cfgs(arch, remat="none", **kw)
        batch = _batch(cfg)
        out = {}
        for mode in ("none", remat):
            model = ptf.init_params(0, dataclasses.replace(cfg, remat=mode),
                                    device="cpu")
            calls = _count_block_calls(monkeypatch)
            out[mode] = _port_loss_and_grads(
                model, batch, dataclasses.replace(cfg, remat=mode))
            monkeypatch.undo()
            if arch == "llama3_8b":
                assert len(calls) == REMAT_CALLS[mode], (mode, len(calls))
        (l0, _, g0), (l1, _, g1) = out["none"], out[remat]
        assert torch.equal(l0, l1)
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (arch, k)


def _scan_grads(ref_fn, port_fn, inputs: dict, wrt: tuple):
    """Gradients of sum(y * ry) + sum(h * rh) through both scans: the
    reference's by ``jax.grad``, the port's by ``backward()``."""
    rng = np.random.default_rng(5)
    y0, h0 = ref_fn(**{k: jnp.asarray(v) for k, v in inputs.items()})
    ry = rng.standard_normal(y0.shape).astype(np.float32)
    rh = rng.standard_normal(h0.shape).astype(np.float32)

    def ref_loss(*args):
        y, h = ref_fn(**{**{k: jnp.asarray(v) for k, v in inputs.items()},
                         **dict(zip(wrt, args))})
        return (y * ry).sum() + (h * rh).sum()

    want = jax.grad(ref_loss, argnums=tuple(range(len(wrt))))(
        *(jnp.asarray(inputs[k]) for k in wrt))
    ts = {k: torch.from_numpy(v).requires_grad_(k in wrt)
          for k, v in inputs.items()}
    y, h = port_fn(**ts)
    ((y * torch.from_numpy(ry)).sum() + (h * torch.from_numpy(rh)).sum()
     ).backward()
    return [ts[k].grad for k in wrt], [np.asarray(g) for g in want]


def test_scan_gradients_at_the_clamps_tie_match_reference():
    """Both chunked scans with a running log-decay that reaches the -30
    floor exactly (steps of -7.5: -7.5, -15, -22.5, -30, ...): at the tie
    ``jnp.maximum`` passes each side half the gradient, and so must the
    port (``torch.clamp_min`` would pass the input all of it)."""
    rcfg, pcfg = _cfgs("zamba2_1p2b", ssm_chunk=8, ssm_groups=1)
    rng = np.random.default_rng(4)
    H, P, N, T = 2, 4, 16, 8
    inputs = {"x": rng.standard_normal((B, T, H, P)).astype(np.float32),
              "dt": np.full((B, T, H), 7.5, np.float32),
              "A": np.full((H,), -1.0, np.float32),
              "B_in": rng.standard_normal((B, T, 1, N)).astype(np.float32),
              "C_in": rng.standard_normal((B, T, 1, N)).astype(np.float32),
              "h0": rng.standard_normal((B, H, P, N)).astype(np.float32)}
    got, want = _scan_grads(
        lambda **kw: rm2._ssd_chunked(cfg=rcfg, **kw),
        lambda **kw: pm2._ssd_chunked(cfg=pcfg, **kw), inputs, ("dt", "A"))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    K = 4
    inputs = {"r": rng.standard_normal((B, T, H, K)).astype(np.float32),
              "k": rng.standard_normal((B, T, H, K)).astype(np.float32),
              "v": rng.standard_normal((B, T, H, K)).astype(np.float32),
              "w_log": np.full((B, T, H, K), -7.5, np.float32),
              "u": rng.standard_normal((H, K)).astype(np.float32),
              "S0": rng.standard_normal((B, H, K, K)).astype(np.float32)}
    got, want = _scan_grads(
        lambda **kw: rrw._wkv_chunked(chunk=8, **kw),
        lambda **kw: prw._wkv_chunked(chunk=8, **kw), inputs, ("w_log",))
    assert _rel(got[0], want[0]) <= 1e-5


def test_routed_config_under_grad_raises():
    """The tuned GEMM has no backward (nor has the reference's Pallas
    GEMM): loss_fn refuses a routing config whose parameters want
    gradients, on every device, and computes the loss without them."""
    _, cfg = _cfgs("llama3_8b", use_pallas_gemm=True)
    model = ptf.init_params(0, cfg, device="cpu")
    batch = _torch_batch(_batch(cfg))
    loss, _ = ptf.loss_fn(model, batch, cfg)          # no gradient wanted
    assert torch.isfinite(loss)
    model.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        ptf.loss_fn(model, batch, cfg)
    with torch.no_grad():
        assert torch.equal(ptf.loss_fn(model, batch, cfg)[0], loss)


def test_train_loop_matches_reference_train_loop(tmp_path):
    """Three steps of the port's ``TrainLoop`` on the CPU from the
    reference's initial weights and optimiser state (carried across)
    against the reference's ``TrainLoop`` on its mesh: every loss within
    1e-5, and the parameters and both moments after the third step within
    1e-4 of their largest value."""
    rcfg, pcfg = _cfgs("llama3_8b")
    kw = dict(lr=1e-3, total_steps=20, warmup_steps=2)
    rds = RefSynthetic(vocab=rcfg.vocab, seq_len=32, global_batch=4)
    ref = RefTrainLoop(cfg=rcfg, adamw=RefAdamWConfig(**kw), mesh=best_mesh(),
                       ckpt=RefCheckpointer(tmp_path / "ref"), dataset=rds,
                       log_every=1)
    rstate = ref.init_state()
    tree = jax.tree.map(np.asarray, rstate["params"])
    opt = jax.tree.map(np.asarray, rstate["opt"])
    rres = ref.run(3, start_step=0, state=rstate)
    ours = TrainLoop(cfg=pcfg, adamw=AdamWConfig(**kw),
                     ckpt=Checkpointer(tmp_path / "port"),
                     dataset=SyntheticLMDataset(vocab=pcfg.vocab, seq_len=32,
                                                global_batch=4),
                     device="cpu", log_every=1)
    state = {"params": ptf.from_reference(pcfg, tree, device="cpu"
                                          ).requires_grad_(True),
             "opt": ptf.adamw_state_from_reference(pcfg, opt, device="cpu"),
             "ef": {"_": torch.zeros(())}}
    res = ours.run(3, start_step=0, state=state)
    assert [h["step"] for h in res["history"]] == [1, 2, 3]
    for got, want in zip(res["history"], rres["history"], strict=True):
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * want["loss"]
    final = res["state"]
    rfinal = jax.tree.map(np.asarray, rres["state"])
    assert int(final["opt"].step) == int(rfinal["opt"].step) == 3
    pairs = [(dict(final["params"].named_parameters()), rfinal["params"]),
             (final["opt"].mu, rfinal["opt"].mu),
             (final["opt"].nu, rfinal["opt"].nu)]
    for named, want in pairs:
        errs = jax.tree.map(_rel, ptf.to_reference(pcfg, named), want)
        assert max(jax.tree.leaves(errs)) <= 1e-4


def test_adamw_state_carries_from_reference():
    """A reference optimiser state after one update, carried to the port,
    holds the same step and moments under the port's parameter names."""
    from repro.optim import adamw_update, init_adamw
    rcfg, pcfg = _cfgs("zamba2_1p2b")
    params = rtf.init_params(jax.random.PRNGKey(1), rcfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
    _, st, _ = adamw_update(params, grads, init_adamw(params),
                            RefAdamWConfig())
    st = jax.tree.map(np.asarray, st)
    carried = ptf.adamw_state_from_reference(pcfg, st, device="cpu")
    assert int(carried.step) == 1 and carried.step.dtype == torch.int32
    names = dict(ptf.init_params(0, pcfg, device="cpu").named_parameters())
    assert carried.mu.keys() == carried.nu.keys() == names.keys()
    jax.tree.map(np.testing.assert_array_equal,
                 ptf.to_reference(pcfg, carried.mu), st.mu)
    jax.tree.map(np.testing.assert_array_equal,
                 ptf.to_reference(pcfg, carried.nu), st.nu)


def test_from_reference_rejects_a_leaf_the_port_lacks():
    rcfg, pcfg = _cfgs("llama3_8b")
    tree = jax.tree.map(np.asarray, rtf.init_params(jax.random.PRNGKey(0),
                                                    rcfg))
    tree["final_norm"]["bias"] = np.zeros(rcfg.d_model, np.float32)
    with pytest.raises(ValueError, match="bias"):
        ptf.from_reference(pcfg, tree, device="cpu")


def test_main_trains_the_smoke_model_on_the_cpu(tmp_path, capsys):
    out = train.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--ckpt", str(tmp_path)])
    assert out["final_step"] == 3
    assert np.isfinite(out["history"][-1]["loss"])
    assert "[train] done at step 3" in capsys.readouterr().out
    assert Checkpointer(tmp_path).latest_step() == 3


def test_main_model_parallel_two_in_a_world_of_one_trains_unsharded(
        tmp_path, capsys):
    """``--model-parallel 2`` in a world of one: ``best_mesh`` gives (1, 1),
    which shards nothing, so the loop runs the single-device step on
    plain tensors."""
    out = train.main(["--smoke", "--device", "cpu", "--model-parallel", "2",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt", str(tmp_path)])
    assert "[train] mesh {'data': 1, 'model': 1} on cpu" in \
        capsys.readouterr().out
    assert out["final_step"] == 2 and np.isfinite(out["history"][-1]["loss"])
    assert all(type(p) is torch.nn.Parameter
               for p in out["state"]["params"].parameters())


def test_train_entry_points_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = pconfigs.get_smoke_config("llama3_8b")
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainLoop(cfg=cfg, adamw=AdamWConfig(), ckpt=Checkpointer(tmp_path),
                  dataset=ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--ckpt", str(tmp_path)])
