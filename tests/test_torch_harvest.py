"""The port's harvest, pruning and prewarm on the CPU: the decision keys a
served model asks for, harvested on the meta device
(``repro_torch/roofline/harvest.py``), against the keys a live
``ServeSession`` run asks of a recording runtime, and against the
reference package's harvest; the meta step of ``run_op``; the ATen call-site
map; ``scripts/torch_prewarm_model.py --timer oracle`` leaving a registry
whose decisions a fresh runtime replays without a model evaluation.

Deliberate differences from the reference's ``harvest_decision_keys``:

* the port runs the programs of a generate (prefill, then decode at the
  true position; Whisper's encoder once, before the prefill), the
  reference ``forward``/``prefill``/``decode_step`` with a cache of
  ``seq_len + 1``; with ``programs`` and ``max_len`` set to the
  reference's, the keys agree for the dense, MoE, hybrid and SSM families;
* the reference's ``abstract_batch`` draws Whisper's frames 80 wide and the
  VLM's patches 32 wide, which its own smoke configs' embeddings do not
  take, so its harvest raises for the audio and VLM families: those are
  held against the live session only.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import repro.configs as ref_configs
from repro.roofline.harvest import harvest_decision_keys as ref_harvest
from repro_torch.configs import get_smoke_config
from repro_torch.core import AdsalaRuntime, ModelRegistry
from repro_torch.kernels import introspect
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeSession, stub_inputs
from repro_torch.models import transformer as tf
from repro_torch.roofline import (Recorder, dot_call_sites,
                                  harvest_decision_keys)

FAMILIES = ("llama3-8b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
            "zamba2-1.2b", "rwkv6-1.6b", "whisper-medium", "internvl2-76b")
#: the families the reference's harvest runs on (see the module docstring)
REF_FAMILIES = ("llama3-8b", "qwen1.5-4b", "granite-moe-3b-a800m",
                "deepseek-v2-lite-16b", "zamba2-1.2b", "rwkv6-1.6b")
B, S, NEW = 2, 8, 3


def _live_keys(arch: str) -> set:
    """The keys a CPU ``ServeSession.generate`` asks of a recording
    runtime, at the served config (routed, float32)."""
    cfg = dataclasses.replace(get_smoke_config(arch), use_pallas_gemm=True,
                              compute_dtype="float32")
    rec = Recorder()
    params = tf.init_params(0, cfg, device="cpu")
    sess = ServeSession(cfg=cfg, params=params,
                        max_len=S + NEW + 8 + cfg.vision_tokens, runtime=rec,
                        device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    sess.generate(prompts, max_new=NEW, **stub_inputs(cfg, B, rng))
    return set(rec.keys)


@pytest.mark.parametrize("arch", FAMILIES)
def test_harvest_equals_live_session_keys(arch):
    keys = harvest_decision_keys(get_smoke_config(arch), batch_size=B,
                                 seq_len=S, max_new=NEW)
    assert len(keys) == len(set(keys))                 # distinct, in order
    assert set(keys) == _live_keys(arch)
    assert all(k[0] == "hopper" and k[1] == "gemm" and k[2] == 4
               for k in keys)


@pytest.mark.parametrize("arch", REF_FAMILIES)
def test_harvest_equals_reference_harvest(arch):
    cfg = get_smoke_config(arch)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                                  compute_dtype="float32")
    want = {("hopper", *k[1:]) for k in ref_harvest(ref_cfg, batch_size=B,
                                                     seq_len=S)}
    assert all(k[0] == "pallas" for k in ref_harvest(ref_cfg, batch_size=B,
                                                      seq_len=S))
    got = set(harvest_decision_keys(
        cfg, batch_size=B, seq_len=S, max_len=S + 1,
        programs=("forward", "prefill", "decode")))
    assert got == want


class _NonMeta(TorchDispatchMode):
    """Counts ATen outputs that are not on the meta device."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.found += [str(func) for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)
                       and t.device.type != "meta"]
        return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_harvest_creates_no_tensor_with_data(arch):
    before = introspect.launch_counts()
    with _NonMeta() as mode:
        harvest_decision_keys(get_smoke_config(arch), batch_size=B,
                              seq_len=S, max_new=NEW,
                              programs=("forward", "prefill", "decode"))
    assert mode.found == []
    assert introspect.launch_counts() == before        # no kernel launched


def test_meta_step_records_the_cards_key_and_returns_a_meta_output():
    rec = Recorder()
    a = torch.empty((4, 8, 64), device="meta")
    w = torch.empty((64, 96), device="meta")
    out = ops.run_op("gemm", (a, w), runtime=rec)
    assert out.device.type == "meta" and tuple(out.shape) == (4, 8, 96)
    assert rec.keys == [("hopper", "gemm", 4, (8, 64, 96))]
    shapes = {"symm": ((5, 5), (5, 7)), "trmm": ((5, 5), (5, 7)),
              "trsm": ((3, 5, 5), (3, 5, 7)), "syrk": ((5, 9),),
              "syr2k": ((5, 9), (5, 9))}
    want = {"symm": (5, 7), "trmm": (5, 7), "trsm": (3, 5, 7),
            "syrk": (5, 5), "syr2k": (5, 5)}
    for op, sh in shapes.items():
        x = tuple(torch.empty(s, device="meta") for s in sh)
        assert tuple(ops.run_op(op, x, runtime=rec).shape) == want[op]
    # a model behind a real runtime: the decision is made (a model eval),
    # the key then cached, no kernel and no plain version runs
    rt = AdsalaRuntime()
    out = ops.run_op("gemm", (a, w), runtime=rt)
    assert out.device.type == "meta"
    assert rt.stats.default_calls == 1


def test_meta_step_is_reachable_only_from_meta_operands():
    """A CPU operand computes the plain version; a CUDA request on a host
    without a card raises (no fallback to the meta step or the CPU)."""
    a = torch.randn(4, 6)
    w = torch.randn(6, 3)
    out = ops.run_op("gemm", (a, w), device="cpu")
    assert out.device.type == "cpu"
    torch.testing.assert_close(out, a @ w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="does not have"):
            ops.run_op("gemm", (a, w))
    with pytest.raises(Exception):
        # one meta and one CPU operand: not a meta step
        ops.run_op("gemm", (torch.empty((4, 6), device="meta"), w),
                   device="cpu")


def test_dot_call_sites_sees_unrouted_matmuls_only():
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              compute_dtype="float32")
    params = tf.init_params(0, cfg, device="meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.long, device="meta")}
    plain = dot_call_sites(tf.forward, params, batch,
                           dataclasses.replace(cfg, use_pallas_gemm=False))
    routed_cfg = dataclasses.replace(cfg, use_pallas_gemm=True)
    routed = dot_call_sites(tf.forward, params, batch, routed_cfg,
                            runtime=Recorder())
    linears = {k[3][1:] for k in harvest_decision_keys(
        cfg, batch_size=B, seq_len=S, programs=("forward",))}
    # the plain config's linears reach ATen as matmuls (the batch folded
    # into m by aten.matmul); routed, they do not: the LM head's (d, vocab)
    # is there only unrouted
    assert linears <= {d[1:] for _, d, _ in plain}
    head = (cfg.d_model, cfg.vocab)
    assert head in linears and head not in {d[1:] for _, d, _ in routed}
    assert all(op == "gemm" and db == 4 for op, _, db in plain)
    # attention's products are there in both
    assert routed and set(routed) <= set(plain)
    assert len(routed) < len(plain)


def test_prewarm_script_oracle_timer_gives_zero_evals(tmp_path):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_prewarm_model.py"
    spec = importlib.util.spec_from_file_location("torch_prewarm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = ["--arch", "rwkv6-1.6b", "--smoke-config", "--registry",
            str(tmp_path), "--batch", "2", "--seq", "8", "--n-samples", "16",
            "--tune-trials", "1", "--candidates",
            "LinearRegression,DecisionTree"]
    if not torch.cuda.is_available():
        # the default timer is the card's: without one the script refuses
        # before it installs anything
        with pytest.raises(RuntimeError, match="runs on cuda"):
            mod.main(args)
        assert not any(tmp_path.iterdir())
    assert mod.main([*args, "--timer", "oracle"]) == 0
    keys = harvest_decision_keys(get_smoke_config("rwkv6-1.6b"),
                                 batch_size=2, seq_len=8)
    fresh = AdsalaRuntime()
    reg = ModelRegistry(tmp_path)
    assert reg.load_into(fresh, backend="hopper") == 1
    # the artifact says it was never timed on a card
    assert fresh.subroutine("gemm", 4, "hopper").timer == "oracle"
    assert reg.load_decision_cache(fresh) == len(keys)
    for be, op, db, dims in keys:
        fresh.select_or_default(op, dims, db, ops.default_knob(op),
                                backend=be)
    st = fresh.stats.for_backend("hopper")
    assert st.model_evals == 0 and st.default_calls == 0
    assert st.cache_hits == len(keys)
