"""The checks ``chip_smoke.py``'s model phases make, on the CPU at the smoke
configs: the layer inputs, caches and final hidden states its hooks
capture replay each pass bit for bit (every layer's output is the next
layer's captured input, the head's output is the pass's logits), and its
one-ulp nudge of the GEMM weights moves them and puts them back bit for
bit.  On the card the same helpers hold the routed model to the plain one
(``chip_smoke.py`` phases 6 to 6d)."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

import repro_torch.configs as pconfigs
from repro_torch.models import transformer as ptf

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCHS = ("llama3_8b", "deepseek_v2_lite", "zamba2_1p2b", "rwkv6_1p6b")
B, S, STEPS = 2, 12, 3


def _setup(arch):
    cfg = dataclasses.replace(pconfigs.get_smoke_config(arch),
                              compute_dtype="float32")
    model = ptf.init_params(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, tokens


def _passes(model, cfg, tokens) -> list:
    """The logits of a prefill and ``STEPS`` teacher-forced decode steps."""
    caches = ptf.init_decode_state(cfg, B, S + STEPS, torch.float32,
                                   device="cpu")
    out = [ptf.prefill(model, {"tokens": tokens}, caches, cfg)[0]]
    for t in range(STEPS):
        out.append(ptf.decode_step(model, tokens[:, t:t + 1], caches,
                                   cfg)[0])
    return out


@pytest.mark.parametrize("arch", ARCHS)
@torch.inference_mode()
def test_captured_inputs_replay_every_pass(arch):
    cfg, model, tokens = _setup(arch)
    layer_in, finals, remove = chip_smoke._layer_inputs(torch, model)
    logits = _passes(model, cfg, tokens)
    remove()
    _passes(model, cfg, tokens)
    n = len(model.layers)
    assert len(layer_in) == n * (STEPS + 1) and len(finals) == STEPS + 1
    outs = chip_smoke._layer_outputs(model, cfg, None, layer_in)
    for j, ((i, _, _, _), out) in enumerate(zip(layer_in, outs,
                                                strict=True)):
        if i + 1 < n:
            assert torch.equal(out, layer_in[j + 1][1]), (arch, j)
        else:
            assert torch.equal(out[:, -1:], finals[j // n]), (arch, j)
    heads = chip_smoke._head_outputs(model, cfg, None, finals)
    for got, want in zip(heads, logits, strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
@torch.inference_mode()
def test_one_ulp_moves_the_gemm_weights_and_puts_them_back(arch):
    cfg, model, tokens = _setup(arch)
    weights = chip_smoke._gemm_weights(model)
    before = [w.clone() for w in weights]
    want = _passes(model, cfg, tokens)

    def nudged():
        assert all(torch.equal(w, torch.nextafter(b, b.new_tensor(math.inf)))
                   for w, b in zip(weights, before, strict=True))
        return _passes(model, cfg, tokens)

    floor = chip_smoke._logits_err(
        chip_smoke._one_ulp(torch, weights, nudged), want)
    assert 0 < floor < 1e-4
    assert all(torch.equal(w, b) for w, b in zip(weights, before,
                                                 strict=True))
