"""The port's training substrate (``repro_torch.optim``, ``.data``,
``.checkpoint``, ``.distributed.fault_tolerance``) on the CPU: the
reference's ``tests/test_substrate.py`` cases on the port, and parity with
the reference on the same inputs (AdamW over 3 steps, the cosine schedule,
the int8 round trip and both datasets bit for bit)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import ByteCorpusDataset as RefByteCorpus
from repro.data import SyntheticLMDataset as RefSynthetic
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import compress_decompress as ref_compress_decompress
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro.optim import init_adamw as ref_init_adamw
from repro.optim import quantize_int8 as ref_quantize_int8
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import (ByteCorpusDataset, SyntheticLMDataset,
                              make_device_batch)
from repro_torch.distributed import (PreemptionGuard, RetryPolicy,
                                     StragglerDetector)
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_update,
                               clip_by_global_norm, compress_decompress,
                               cosine_schedule, dequantize_int8, global_norm,
                               init_adamw, init_error_feedback, quantize_int8)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                      total_steps=200, grad_clip=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_adamw(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(params, g, state, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] < lrs[9] <= 1.0                  # warmup
    assert abs(lrs[10] - 1.0) < 0.05               # peak
    assert abs(lrs[100] - 0.1) < 0.02              # floor
    assert all(a >= b - 1e-6 for a, b in zip(lrs[10:], lrs[11:]))  # decay


def test_grad_clip_bounds_global_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) > 100
    assert float(global_norm(clipped)) <= 1.0 + 1e-5


def _ref_tree(tree: dict) -> dict:
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


@pytest.mark.parametrize("clip", (1.0, 1e-3))
def test_adamw_update_matches_reference_over_three_steps(clip):
    """The same parameters and gradients through both updates: parameters
    and both moments within 1e-6 of the reference's, relative, each step,
    with the clip slack (1.0) and biting (1e-3); lr and grad norm too."""
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "table": (32, 4)}
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, grad_clip=clip)
    cfg, rcfg = AdamWConfig(**kw), RefAdamWConfig(**kw)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    rparams = _ref_tree(params)
    state, rstate = init_adamw(params), ref_init_adamw(rparams)
    for step in range(3):
        grads = {k: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)) for k, s in
            shapes.items()}
        rparams, rstate, rm = ref_adamw_update(rparams, _ref_tree(grads),
                                               rstate, rcfg)
        params, state, m = adamw_update(params, grads, state, cfg)
        assert int(state.step) == int(rstate.step) == step + 1
        for k in shapes:
            assert _rel(params[k], rparams[k]) <= 1e-6, (step, k)
            assert _rel(state.mu[k], rstate.mu[k]) <= 1e-6, (step, k)
            assert _rel(state.nu[k], rstate.nu[k]) <= 1e-6, (step, k)
        assert _rel(m["lr"], rm["lr"]) <= 1e-6
        assert _rel(m["grad_norm"], rm["grad_norm"]) <= 1e-6


def test_adamw_update_keeps_its_scalars_on_the_device_as_tensors():
    params = {"w": torch.ones(4)}
    grads = {"w": torch.ones(4)}
    new_p, state, m = adamw_update(params, grads, init_adamw(params),
                                   AdamWConfig())
    assert new_p["w"] is params["w"]              # written in place
    assert isinstance(state, AdamWState)
    for t in (state.step, m["lr"], m["grad_norm"]):
        assert isinstance(t, torch.Tensor) and t.dim() == 0
    assert state.step.dtype == torch.int32


@pytest.mark.parametrize("step", (0, 1, 5, 10, 55, 100, 150))
def test_cosine_schedule_matches_reference(step):
    """Warmup (0-10), the peak, mid decay, the end and past it."""
    kw = dict(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = float(cosine_schedule(AdamWConfig(**kw), torch.tensor(step)))
    want = float(ref_cosine_schedule(RefAdamWConfig(**kw),
                                     jnp.asarray(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s = quantize_int8(g)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - g).abs().numpy()
    assert err.max() <= float(s) / 2 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    """With EF, the accumulated applied gradient tracks the true sum."""
    rng = np.random.default_rng(1)
    true = rng.standard_normal(256).astype(np.float32) * 1e-3
    ef = init_error_feedback({"w": torch.zeros(256)})
    applied = np.zeros(256)
    for _ in range(50):
        out, ef = compress_decompress({"w": torch.from_numpy(true)}, ef)
        applied += out["w"].numpy()
    np.testing.assert_allclose(applied / 50, true,
                               atol=np.abs(true).max() * 0.05 + 1e-6)


def test_compress_decompress_matches_reference_bitwise():
    """int8 values and scale equal bit for bit, and so the round trip and
    the error buffers, over 3 steps of error feedback; the inputs include
    exact halves (round half to even) and an all-zero tensor (the 1e-30
    scale floor)."""
    rng = np.random.default_rng(2)
    halves = (np.arange(-8, 9) + 0.5).astype(np.float32) / 127 * 8.5
    shapes = {"w": (33, 7), "z": (5,)}
    ef = init_error_feedback({k: torch.zeros(s) for k, s in shapes.items()})
    ref_ef = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    for step in range(3):
        grads = {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
                 "z": np.zeros(5, np.float32)}
        if step == 0:
            grads["w"].flat[:len(halves)] = halves
        q, s = quantize_int8(torch.from_numpy(grads["w"]))
        rq, rs = ref_quantize_int8(jnp.asarray(grads["w"]))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert np.float32(s) == np.float32(rs)
        out, ef = compress_decompress(
            {k: torch.from_numpy(v) for k, v in grads.items()}, ef)
        rout, ref_ef = ref_compress_decompress(
            {k: jnp.asarray(v) for k, v in grads.items()}, ref_ef)
        for k in shapes:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(rout[k]))
            np.testing.assert_array_equal(ef[k].numpy(),
                                          np.asarray(ref_ef[k]))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_synthetic_dataset_deterministic_and_resumable():
    ds = SyntheticLMDataset(vocab=100, seq_len=16, global_batch=4, seed=3)
    b1 = ds.batch_at(41)
    b2 = ds.batch_at(41)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(ds.batch_at(42)["tokens"], b1["tokens"])
    assert b1["labels"][0, -1] == -1
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_byte_corpus_dataset(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_text("the quick brown fox jumps over the lazy dog. " * 50)
    ds = ByteCorpusDataset(path=p, seq_len=32, global_batch=2, seed=0)
    b = ds.batch_at(0)
    assert b["tokens"].shape == (2, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("seed,step", ((0, 0), (3, 41), (7, 100_000)))
def test_datasets_match_reference_bitwise(tmp_path, seed, step):
    ours = SyntheticLMDataset(vocab=128256, seq_len=128, global_batch=8,
                              seed=seed).batch_at(step)
    ref = RefSynthetic(vocab=128256, seq_len=128, global_batch=8,
                       seed=seed).batch_at(step)
    p = tmp_path / "corpus.txt"
    p.write_text("a short corpus, repeated to fill a batch")
    ours_b = ByteCorpusDataset(path=p, seq_len=64, global_batch=4,
                               seed=seed).batch_at(step)
    ref_b = RefByteCorpus(path=p, seq_len=64, global_batch=4,
                          seed=seed).batch_at(step)
    for got, want in ((ours, ref), (ours_b, ref_b)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_make_device_batch_places_indices_as_int64():
    batch = SyntheticLMDataset(vocab=50, seq_len=8, global_batch=2).batch_at(0)
    batch["vision"] = np.ones((2, 3, 4), np.float32)
    out = make_device_batch(batch, "cpu")
    assert out["tokens"].dtype == out["labels"].dtype == torch.int64
    assert out["vision"].dtype == torch.float32
    np.testing.assert_array_equal(out["labels"].numpy(), batch["labels"])


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.standard_normal((8, 4)).astype(np.float32)),
                       "b": torch.from_numpy(
                           rng.standard_normal(4).astype(np.float32))},
            "opt": AdamWState(step=torch.tensor(7, dtype=torch.int32),
                              mu={"w": torch.ones(3)}, nu={"w": torch.ones(3)}),
            "layers": [torch.arange(5), torch.zeros(2, dtype=torch.float64)]}


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "opt": AdamWState(torch.zeros_like(tree["opt"].step),
                              {"w": torch.zeros(3)}, {"w": torch.zeros(3)}),
            "layers": [torch.zeros_like(t) for t in tree["layers"]]}


def _leaves(tree):
    return [tree["params"]["w"], tree["params"]["b"], tree["opt"].step,
            tree["opt"].mu["w"], tree["opt"].nu["w"], *tree["layers"]]


def test_checkpoint_save_restore_exact(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _tree()
    ck.save(10, t)
    assert ck.latest_step() == 10
    target = _zeros_like(t)
    restored = ck.restore(10, target)
    assert restored is target                    # filled in place
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _tree(s))
    ck.wait()
    assert ck.steps() == [3, 4]


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    """Training goes on writing the tensors in place after ``save_async``:
    the checkpoint holds the values at the call."""
    ck = Checkpointer(tmp_path)
    t = _tree()
    want = t["params"]["w"].clone()
    ck.save_async(1, t)
    t["params"]["w"].add_(1.0)
    ck.wait()
    restored = ck.restore(1, _zeros_like(t))
    assert torch.equal(restored["params"]["w"], want)


def test_checkpoint_atomicity_no_torn_dirs(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, _tree())
    # a stale tmp dir from a crashed writer must be invisible
    (tmp_path / "step_6.tmp").mkdir()
    assert ck.latest_step() == 5


def test_checkpoint_restores_a_module_and_rejects_a_wrong_shape(tmp_path):
    ck = Checkpointer(tmp_path)
    src = torch.nn.Linear(4, 3)
    ck.save(1, {"params": src})
    dst = torch.nn.Linear(4, 3)                  # requires_grad parameters
    ck.restore(1, {"params": dst})
    assert torch.equal(dst.weight, src.weight)
    assert torch.equal(dst.bias, src.bias)
    assert (tmp_path / "step_1" / "manifest").read_text().startswith("{")
    with pytest.raises(ValueError, match="params/weight"):
        ck.restore(1, {"params": torch.nn.Linear(4, 2)})


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_straggler_detector_flags_slow_step():
    det = StragglerDetector(threshold=3.0, min_steps=3)
    for _ in range(10):
        assert not det.observe(1.0)
    assert det.observe(10.0)
    assert det.stragglers == 1
    # EWMA not poisoned by the straggler
    assert det.expected_step_seconds < 1.5


def test_retry_policy_retries_then_succeeds():
    calls = []

    def fn(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("node died")
        return "ok"

    out = RetryPolicy(max_retries=3).run(fn, sleep=lambda s: None)
    assert out == "ok" and calls == [0, 1, 2]


def test_retry_policy_exhausts():
    def fn(attempt):
        raise RuntimeError("permafail")

    with pytest.raises(RuntimeError):
        RetryPolicy(max_retries=1).run(fn, sleep=lambda s: None)


def test_preemption_guard_flag():
    g = PreemptionGuard(install_handlers=False)
    assert not g.preempted
    g.simulate()
    assert g.preempted


# ---------------------------------------------------------------------------
# end-to-end: train → preempt → resume (on the CPU)
# ---------------------------------------------------------------------------

def test_train_resume_after_preemption(tmp_path):
    """A preemption at step 6 checkpoints and exits; a fresh loop resumes
    from it, and its losses and parameters at step 10 equal an
    uninterrupted run's bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import TrainLoop

    cfg = get_smoke_config("llama3-8b")
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=32, global_batch=2)
    guard = PreemptionGuard(install_handlers=False)

    class Preempting:                 # the notice arrives during step 6
        def batch_at(self, step):
            if step == 5:
                guard.simulate()
            return ds.batch_at(step)

    def loop(root, dataset):
        return TrainLoop(cfg=cfg, adamw=AdamWConfig(total_steps=20),
                         ckpt=Checkpointer(root), dataset=dataset,
                         device="cpu", ckpt_every=4, log_every=1)

    first = loop(tmp_path / "a", Preempting())
    res = first.run(10, guard=guard, start_step=0,
                    state=first.init_state())
    assert res["final_step"] == 6
    assert first.ckpt.steps() == [4, 6]
    second = loop(tmp_path / "a", ds)
    step, state = second.restore_or_init()
    assert step == 6
    for (name, p), q in zip(state["params"].named_parameters(),
                            res["state"]["params"].parameters()):
        assert torch.equal(p, q), name
    res2 = second.run(10, start_step=step, state=state)
    assert res2["final_step"] == 10
    plain = loop(tmp_path / "b", ds).run(10)
    assert [h["loss"] for h in res["history"] + res2["history"]] == \
        [h["loss"] for h in plain["history"]]
    for p, q in zip(res2["state"]["params"].parameters(),
                    plain["state"]["params"].parameters()):
        assert torch.equal(p, q)
