"""The checks ``chip_smoke.py``'s model phases make, on the CPU at the smoke
configs: the layer inputs, caches and final hidden states its hooks
capture replay each pass bit for bit (every layer's output is the next
layer's captured input, Whisper's last encoder block's, normed, the
cross-attention's ``enc_out``, the head's output is the pass's logits),
its one-ulp nudge of the GEMM weights moves them and puts them back bit
for bit, and the GEMM launches it expects from the config are the routed
calls a pass makes.  On the card the same helpers hold the routed model
to the plain one (``chip_smoke.py`` phases 6 to 6f)."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as pconfigs
from repro_torch.core import AdsalaRuntime
from repro_torch.launch.serve import stub_inputs
from repro_torch.models import transformer as ptf
from repro_torch.models.layers import rmsnorm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCHS = ("llama3_8b", "deepseek_v2_lite", "zamba2_1p2b", "rwkv6_1p6b",
         "whisper_medium", "internvl2_76b")
B, S, STEPS = 2, 12, 3


def _setup(arch, **kw):
    cfg = dataclasses.replace(pconfigs.get_smoke_config(arch),
                              compute_dtype="float32", **kw)
    model = ptf.init_params(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    extra = {k: torch.from_numpy(v) for k, v in stub_inputs(
        cfg, B, np.random.default_rng(2)).items()}
    return cfg, model, tokens, extra


def _passes(model, cfg, tokens, extra, rt=None) -> list:
    """The logits of a prefill (Whisper's encoder run once) and ``STEPS``
    teacher-forced decode steps at their true positions."""
    caches = ptf.init_decode_state(cfg, B, S + STEPS + cfg.vision_tokens,
                                   torch.float32, device="cpu")
    last, enc_out = chip_smoke._prefill(ptf, model, cfg, rt, tokens, extra,
                                        caches)
    out = [last]
    for t in range(STEPS):
        out.append(ptf.decode_step(model, tokens[:, t:t + 1], caches, cfg,
                                   runtime=rt, enc_out=enc_out,
                                   pos=S + t)[0])
    return out


@pytest.mark.parametrize("arch", ARCHS)
@torch.inference_mode()
def test_captured_inputs_replay_every_pass(arch):
    cfg, model, tokens, extra = _setup(arch)
    layer_in, finals, remove = chip_smoke._layer_inputs(torch, model)
    logits = _passes(model, cfg, tokens, extra)
    remove()
    _passes(model, cfg, tokens, extra)
    n = len(model.layers)
    n_enc = len(chip_smoke._hooked_layers(model)) - n
    assert n_enc == cfg.n_enc_layers
    # the encoder once, at the prefill; the decoder every pass
    assert len(layer_in) == n * (STEPS + 1) + n_enc
    assert len(finals) == STEPS + 1
    outs = chip_smoke._layer_outputs(model, cfg, None, layer_in)
    passes = 0
    for j, ((name, _, _, _), out) in enumerate(zip(layer_in, outs,
                                                   strict=True)):
        if name == f"layers.{n - 1}":
            assert torch.equal(out[:, -1:], finals[passes]), (arch, j)
            passes += 1
        elif name == f"encoder.blocks.{n_enc - 1}":
            nxt, _, _, kwargs = layer_in[j + 1]
            assert nxt == "layers.0"
            assert torch.equal(rmsnorm(model.encoder.norm, out),
                               kwargs["enc_out"]), (arch, j)
        else:
            assert torch.equal(out, layer_in[j + 1][1]), (arch, j)
    assert passes == STEPS + 1
    heads = chip_smoke._head_outputs(model, cfg, None, finals)
    for got, want in zip(heads, logits, strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
@torch.inference_mode()
def test_one_ulp_moves_the_gemm_weights_and_puts_them_back(arch):
    cfg, model, tokens, extra = _setup(arch)
    weights = chip_smoke._gemm_weights(model)
    before = [w.clone() for w in weights]
    want = _passes(model, cfg, tokens, extra)

    def nudged():
        assert all(torch.equal(w, torch.nextafter(b, b.new_tensor(math.inf)))
                   for w, b in zip(weights, before, strict=True))
        return _passes(model, cfg, tokens, extra)

    floor = chip_smoke._logits_err(
        chip_smoke._one_ulp(torch, weights, nudged), want)
    assert 0 < floor < 1e-4
    assert all(torch.equal(w, b) for w, b in zip(weights, before,
                                                 strict=True))


@pytest.mark.parametrize("arch", ARCHS)
@torch.inference_mode()
def test_gemm_calls_from_the_config_are_the_routed_calls(arch):
    """What the model phases expect a generate to launch, from the config
    (the encoder once, the prefill, each decode step), is what the routed
    passes call ``run_op`` for: one decision each."""
    cfg, model, tokens, extra = _setup(arch, use_pallas_gemm=True)
    rt = AdsalaRuntime()
    _passes(model, cfg, tokens, extra, rt)
    rk = chip_smoke._reckoning(cfg, B, S, S + STEPS + cfg.vision_tokens)
    assert (rk["calls_encoder"], rk["calls_prefill"], rk["calls_decode"]) \
        == (chip_smoke._encoder_calls(cfg), chip_smoke._gemm_calls(cfg, False),
            chip_smoke._gemm_calls(cfg, True))
    assert rt.stats.for_backend("hopper").default_calls == \
        rk["calls_encoder"] + rk["calls_prefill"] + STEPS * rk["calls_decode"]
    assert rk["prefill_flop"] > 0 and rk["decode_flop"] > 0
    assert (rk["cross_flop"] > 0) == (cfg.family == "audio")
