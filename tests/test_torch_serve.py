"""The port's serving driver (``repro_torch.launch.serve``) against the
reference package's: ``ServeSession.generate`` on the same weights and
prompts, its sampling, its launch count per pass, and ``main`` on the CPU
(with and without installed artifacts)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.launch.serve import ServeSession as RefSession
from repro.models import transformer as rtf
import repro_torch.configs as pconfigs
from repro_torch.core import AdsalaRuntime
from repro_torch.launch import calibrate, serve
from repro_torch.launch.serve import ServeSession
from repro_torch.models import transformer as ptf

#: as tests/test_torch_models.py: the two packages' logits agree within
#: 1e-5 of the largest, so a greedy token whose top-2 margin is above ten
#: times that must agree
TOL = 1e-5
B, PROMPT, NEW = 2, 8, 6


def _routed(get, arch):
    return dataclasses.replace(get(arch), compute_dtype="float32",
                               use_pallas_gemm=True)


def _margins(model, cfg, prompts, tokens) -> np.ndarray:
    """The port's top-2 logit margin over the largest logit at every
    generated position, teacher-forced on ``tokens``: (B, NEW)."""
    caches = ptf.init_decode_state(cfg, B, PROMPT + NEW + 8,
                                   dtype=torch.float32, device="cpu")
    logits, _ = ptf.prefill(model, {"tokens": torch.tensor(prompts,
                                                           dtype=torch.long)},
                            caches, cfg)
    steps = [logits]
    for t in range(NEW - 1):
        logits, _ = ptf.decode_step(
            model, torch.tensor(tokens[:, t:t + 1], dtype=torch.long),
            caches, cfg)
        steps.append(logits)
    lg = torch.cat(steps, dim=1)                              # (B, NEW, V)
    top2 = lg.topk(2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]) / lg.abs().amax()).numpy()


@pytest.mark.parametrize("arch", ("llama3_8b", "granite_20b",
                                  "granite_moe_3b", "deepseek_v2_lite",
                                  "zamba2_1p2b", "rwkv6_1p6b"))
def test_greedy_tokens_match_reference_session(arch):
    rcfg = _routed(rconfigs.get_smoke_config, arch)
    pcfg = _routed(pconfigs.get_smoke_config, arch)
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    model = ptf.from_reference(pcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    prompts = np.random.default_rng(1).integers(0, rcfg.vocab, (B, PROMPT),
                                                dtype=np.int32)
    want = RefSession(cfg=rcfg, params=params,
                      max_len=PROMPT + NEW + 8).generate(prompts,
                                                         max_new=NEW)
    got = ServeSession(cfg=pcfg, params=model, max_len=PROMPT + NEW + 8,
                       device="cpu").generate(prompts, max_new=NEW)
    assert got.shape == want.shape == (B, NEW) and got.dtype == np.int32
    margins = _margins(model, pcfg, prompts, np.asarray(want))
    compared = 0
    for b in range(B):
        for t in range(NEW):
            if margins[b, t] <= 10 * TOL:
                break               # a near-tie: later tokens may part
            assert got[b, t] == want[b, t], (b, t, margins[b, t])
            compared += 1
    assert compared >= B * NEW // 2


def test_every_pass_routes_every_linear_through_run_op():
    """The chip smoke's launch count on the CPU: one run_op GEMM per linear
    and pass, for the prefill and each of the max_new decode steps."""
    cfg = _routed(pconfigs.get_smoke_config, "llama3_8b")
    rt = AdsalaRuntime()
    model = ptf.init_params(0, cfg, device="cpu")
    sess = ServeSession(cfg=cfg, params=model, max_len=PROMPT + NEW + 8,
                        runtime=rt, device="cpu")
    prompts = np.zeros((B, PROMPT), np.int32)
    sess.generate(prompts, max_new=NEW)
    per_pass = 7 * cfg.n_layers + 1
    assert rt.stats.for_backend("hopper").default_calls == \
        per_pass * (1 + NEW)


def test_temperature_sampling_is_seeded():
    cfg = _routed(pconfigs.get_smoke_config, "qwen15_4b")
    model = ptf.init_params(0, cfg, device="cpu")
    sess = ServeSession(cfg=cfg, params=model, max_len=32, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (B, PROMPT))
    a = sess.generate(prompts, max_new=NEW, temperature=1.5, seed=3)
    b = sess.generate(prompts, max_new=NEW, temperature=1.5, seed=3)
    c = sess.generate(prompts, max_new=NEW, temperature=1.5, seed=4)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < cfg.vocab


def test_session_refuses_a_model_on_another_device():
    cfg = _routed(pconfigs.get_smoke_config, "llama3_8b")
    model = ptf.init_params(0, cfg, device="meta")
    with pytest.raises(ValueError, match="weights lie on"):
        ServeSession(cfg=cfg, params=model, max_len=16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeSession(cfg=cfg, params=model, max_len=16)


def test_main_serves_the_routed_smoke_model_on_the_cpu(capsys):
    out = serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "8",
                      "--max-new", "4"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert "llama3-smoke on cpu" in text
    assert "model_evals 0 default_calls 110" in text   # 22 x (1 + 4) passes


@pytest.mark.parametrize("arch,name,calls", [
    # 3 GQA blocks x (4 + 3 expert stacks) + the head, every pass
    ("granite-moe-3b-a800m", "granite-moe-smoke", 22 * 5),
    # prefill: MLA's 4 linears a layer, the dense MLP's 3, the MoE layers'
    # 3 stacks and 3 shared linears, the head; decode: MLA's 3
    ("deepseek-v2-lite-16b", "deepseek-v2-lite-smoke", 28 + 25 * 4),
], ids=["granite_moe_3b", "deepseek_v2_lite"])
def test_main_serves_the_moe_smoke_models_on_the_cpu(arch, name, calls,
                                                      capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "8",
                      "--max-new", "4"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    text = capsys.readouterr().out
    assert f"{name} on cpu" in text
    assert f"model_evals 0 default_calls {calls}" in text


@pytest.mark.parametrize("arch,name,calls", [
    # 2 supers x (2 mamba blocks x 2 + in_proj + 4 attention + 3 MLP), the
    # tail mamba block's 2 and the head, every pass
    ("zamba2-1.2b", "zamba2-smoke", 27 * 5),
    # 3 RWKV6 layers x 8 linears and the head, every pass
    ("rwkv6-1.6b", "rwkv6-smoke", 25 * 5),
], ids=["zamba2_1p2b", "rwkv6_1p6b"])
def test_main_serves_the_recurrent_smoke_models_on_the_cpu(arch, name, calls,
                                                           capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "8",
                      "--max-new", "4"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    text = capsys.readouterr().out
    assert f"{name} on cpu" in text
    assert f"model_evals 0 default_calls {calls}" in text


def test_main_takes_knobs_from_installed_artifacts(tmp_path, capsys):
    calibrate.main(["--out", str(tmp_path), "--device", "cpu", "--ops",
                    "gemm", "--samples", "12", "--dim-lo", "8", "--dim-hi",
                    "96", "--footprint-mb", "1", "--sizes", "64",
                    "--tune-trials", "1", "--candidates", "DecisionTree"])
    capsys.readouterr()
    serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                "--prompt-len", "8", "--max-new", "2",
                "--models", str(tmp_path / "models")])
    text = capsys.readouterr().out
    assert "loaded 1 hopper artifacts" in text
    assert " default_calls 0" in text and "model_evals 0 " not in text
