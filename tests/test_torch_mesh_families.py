"""Every model family's sharded loss and gradients on the CPU: one ``gloo``
world of 4 ranks (spawned, a file rendezvous under a temporary directory,
one thread a rank, killed past ``JOIN_S``) runs the smoke configs of the
architectures ``tests/test_torch_distributed.py`` does not train — MLA +
MoE (deepseek-v2-lite), MoE (granite-moe), hybrid (zamba2), SSM (rwkv6),
audio (whisper), VLM (internvl2) and the other dense ones (qwen1.5 with
its QKV bias, starcoder2 and granite-20b with GELU MLPs, granite-20b's
MQA) — on a (2, 2) ("data", "model") mesh under the train rules, and
each is held on the same seed and batch against the port's unsharded
loss and ``backward``, and against the reference package's
``jax.value_and_grad(loss_fn)`` on the same weights (carried across with
``to_reference``, in the test process only): the loss within 1e-5
relative, each gradient within 1e-4 of its max (the sharded sums run in
other orders).
"""

import dataclasses

import numpy as np
import pytest

from test_torch_distributed import (_spawn, assert_grads_match_reference,
                                    reference_loss_and_grads)

ARCHS = ("deepseek_v2_lite", "granite_moe_3b", "zamba2_1p2b", "rwkv6_1p6b",
         "whisper_medium", "internvl2_76b", "qwen15_4b", "starcoder2_15b",
         "granite_20b")
B, S = 4, 16


def _cfg(arch):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", capacity_factor=8.0)


def _batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _loss_and_grads(cfg, mesh):
    """The loss and every gradient, whole, of the seed-0 model."""
    from repro_torch.data import make_global_batch
    from repro_torch.distributed import reshard
    from repro_torch.launch.specs import param_specs, rules_for
    from repro_torch.models import init_params, loss_fn
    model = init_params(0, cfg, device="cpu").requires_grad_(True)
    rules = None
    if mesh is not None:
        rules = rules_for(mesh, "train")
        specs = param_specs(cfg, model, rules, mesh)
        reshard(model, mesh, lambda name, _: specs[name])
    batch = make_global_batch(_batch(cfg), mesh,
                              None if mesh is None else ("data",),
                              device="cpu")
    loss, _ = loss_fn(model, batch, cfg, mesh=mesh, rules=rules)
    loss.backward()
    grads = {}
    for k, p in model.named_parameters():
        g = p.grad
        if mesh is not None:
            g = g.redistribute(p.device_mesh, p.placements).full_tensor()
        grads[k] = g
    if mesh is not None:
        loss = loss.full_tensor()
    return float(loss.detach()), grads


def _families_rank(rank, world):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2)
    return {arch: _loss_and_grads(_cfg(arch), mesh) for arch in ARCHS}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return _spawn(_families_rank, 4, tmp_path_factory.mktemp("families"))


@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_and_gradients_on_a_mesh_match_unsharded(arch, sharded):
    loss, grads = sharded[arch]
    want_loss, want = _loss_and_grads(_cfg(arch), None)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert grads.keys() == want.keys()
    for k, w in want.items():
        assert (grads[k] - w).abs().max() <= 1e-4 * w.abs().max().clamp_min(
            1e-30), k


@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_and_gradients_on_a_mesh_match_reference(arch, sharded):
    """The sharded loss and every gathered gradient against the
    reference's ``value_and_grad`` of its ``loss_fn`` on the same weights
    and batch."""
    from test_torch_distributed import reference_of
    loss, grads = sharded[arch]
    cfg, rcfg, params = reference_of(arch, capacity_factor=8.0)
    want_loss, _, want = reference_loss_and_grads(rcfg, params, _batch(cfg))
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert_grads_match_reference(cfg, grads, want, 1e-4)
