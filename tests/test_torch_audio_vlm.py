"""The port's audio and VLM families (Whisper's encoder, cross-attention and
sinusoid positions; the VLM's vision projection) against the reference
package's on the same weights.

Both packages get the parameters of one seeded reference ``init_params``
(the port through ``from_reference``) and the same numpy inputs.  The
reference runs routed (``use_pallas_gemm=True``: every dense matmul a
Pallas GEMM in interpret mode, as ``tests/test_torch_models.py`` runs it);
the port runs routed on the CPU, where every ``run_op`` GEMM is the
kernel's plain version.  Compared: ``attention``'s options (K and V from
another sequence, bidirectional, without RoPE, at given positions, with a
cache), ``_sinusoid``, ``_run_encoder``, ``forward``, ``prefill`` and
``decode_step`` of the whisper and internvl2 smoke configs (Whisper's at
the token's true position), the routed calls a pass, Whisper's served
greedy tokens against a reference loop at the true positions, ``main`` on
the CPU and its cache sizing, and the full-size parameter counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core.runtime import AdsalaRuntime as RefRuntime
from repro.models import layers as rl
from repro.models import transformer as rtf
from repro.models.sharding import DEFAULT_RULES
import repro_torch.configs as pconfigs
from repro_torch.core import AdsalaRuntime
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeSession, stub_inputs
from repro_torch.models import layers as pl
from repro_torch.models import transformer as ptf

#: max |port - reference| over the largest |reference| value, as in
#: tests/test_torch_models.py: the two sum float32 products in other orders
TOL = 1e-5

ARCHS = ("whisper_medium", "internvl2_76b")
B, S = 2, 12
PROMPT, NEW = 8, 6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfgs(arch, **kw):
    """The reference's and the port's smoke config, routed, in float32."""
    kw = dict(compute_dtype="float32", use_pallas_gemm=True, **kw)
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **kw))


def _rctx(rcfg, rt=None):
    return rl.Ctx(rcfg, None, DEFAULT_RULES, rt or RefRuntime())


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.long)


def _linears(cfg, *, decode: bool) -> int:
    """Routed matmuls of one decoder pass: 10 a ``"dec_cross"`` layer
    (self- and cross-attention's q, k, v, o, the GELU MLP's two), 7 an
    ``"attn"`` layer with a SwiGLU MLP, the LM head, and the VLM's vision
    projection at the prefill; Whisper's encoder adds 6 a layer where a
    pass runs it."""
    mlp = 3 if cfg.mlp_type == "swiglu" else 2
    if cfg.family == "audio":
        return (8 + mlp) * cfg.n_layers + 1
    return (4 + mlp) * cfg.n_layers + 1 + (0 if decode else 1)


def _encoder_calls(cfg) -> int:
    return (4 + (3 if cfg.mlp_type == "swiglu" else 2)) * cfg.n_enc_layers


# ---------------------------------------------------------------------------
# the pieces: attention's options, the sinusoid, the encoder
# ---------------------------------------------------------------------------

def _attention_pair(arch, seed):
    rcfg, pcfg = _cfgs(arch)
    p = rl.init_attention(jax.random.PRNGKey(seed), rcfg)
    mod = pl.Attention(pcfg, device="meta")
    mod.load_state_dict({f"{k}.{f}": torch.tensor(np.asarray(v))
                         for k, lin in p.items() for f, v in lin.items()},
                        strict=True, assign=True)
    return rcfg, pcfg, p, mod


@pytest.mark.parametrize("arch,kw,kv_len,cached", [
    # Whisper's cross-attention: K, V from a longer sequence whose length
    # is no multiple of the kv chunk (padded kv positions masked)
    ("whisper_medium", dict(causal=False, use_rope=False), 40, False),
    # Whisper's encoder: bidirectional, no RoPE
    ("whisper_medium", dict(causal=False, use_rope=False), None, False),
    # Whisper's decoder self-attention without a cache
    ("whisper_medium", dict(use_rope=False), None, False),
    # ... and with one, the prompt, then one step
    ("whisper_medium", dict(use_rope=False), None, True),
    # GQA, bidirectional with RoPE
    ("internvl2_76b", dict(causal=False), None, False),
    # RoPE at given positions
    ("internvl2_76b", dict(positions=np.arange(5, 5 + S)[None]), None,
     False),
    # the VLM's backbone with a cache (RoPE at the cache's positions)
    ("internvl2_76b", {}, None, True),
], ids=["cross_kv_x", "bidirectional", "causal_no_rope",
        "cache_no_rope", "bidirectional_rope", "positions", "cache_rope"])
def test_attention_options_match_reference(arch, kw, kv_len, cached):
    rcfg, pcfg, p, mod = _attention_pair(arch, 1)
    x = _x((B, S, rcfg.d_model), 2)
    rkw, pkw = dict(kw), dict(kw)
    if "positions" in kw:
        rkw["positions"] = jnp.asarray(kw["positions"])
        pkw["positions"] = torch.from_numpy(kw["positions"])
    if kv_len is not None:
        kv = _x((B, kv_len, rcfg.d_model), 3)
        rkw["kv_x"], pkw["kv_x"] = jnp.asarray(kv), torch.from_numpy(kv)
    pctx = pl.Ctx(pcfg, AdsalaRuntime())
    if not cached:
        want, _ = rl.attention(p, jnp.asarray(x), _rctx(rcfg), **rkw)
        got, cache = pl.attention(mod, torch.from_numpy(x), pctx, **pkw)
        assert cache is None
        assert got.shape == want.shape == (B, S, rcfg.d_model)
        assert _rel(got, want) < TOL
        return
    T = S + 4
    shape = (B, T, rcfg.kv_heads, rcfg.hd())
    rcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
              "len": jnp.zeros((), jnp.int32)}
    pcache = {"k": torch.zeros(shape), "v": torch.zeros(shape), "len": 0}
    step = _x((B, 1, rcfg.d_model), 4)
    for inp in (x, step):
        want, rcache = rl.attention(p, jnp.asarray(inp), _rctx(rcfg),
                                    cache=rcache, **rkw)
        got, pcache = pl.attention(mod, torch.from_numpy(inp), pctx,
                                   cache=pcache, **pkw)
        assert _rel(got, want) < TOL
    assert pcache["len"] == int(rcache["len"]) == S + 1
    assert _rel(pcache["k"], rcache["k"]) < TOL


@pytest.mark.parametrize("seq,d,offset", [(32, 64, 0), (32, 64, 37),
                                          (1, 1024, 37)],
                         ids=["offset_0", "offset_37", "decode_step"])
def test_sinusoid_matches_reference(seq, d, offset):
    want = np.asarray(rtf._sinusoid(seq, d, offset))
    got = ptf._sinusoid(seq, d, offset)
    assert got.shape == want.shape == (seq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_sinusoid_at_the_encoder_length_is_its_float32_formula():
    """At Whisper's 1,500 frames the two packages' float32 frequencies
    ``exp(-2i ln(1e4) / d)`` differ by one ulp at some columns (XLA's and
    PyTorch's ``exp`` round differently), which position ``p`` scales into
    an argument apart by up to ``p`` ulps of a frequency at most 1: ~1.2e-4
    of the sine at p = 1,499.  So the port's table is held to float64
    sines and cosines of its own float32 arguments, and to the reference's
    within that bound, 1500 * 2**-23."""
    seq, d = 1500, 1024
    got = ptf._sinusoid(seq, d).numpy()
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                    * (-np.log(10000.0) / d)).numpy()
    args = (np.arange(seq, dtype=np.float32)[:, None] * div).astype(
        np.float64)
    exact = np.stack([np.sin(args), np.cos(args)], axis=-1).reshape(seq, d)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    want = np.asarray(rtf._sinusoid(seq, d))
    np.testing.assert_allclose(got, want, rtol=0, atol=seq * 2.0 ** -23)


@pytest.fixture(scope="module")
def whisper():
    rcfg, pcfg = _cfgs("whisper_medium")
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    model = ptf.from_reference(pcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    return rcfg, pcfg, params, model


@pytest.mark.parametrize("seq", (32, 40), ids=["enc_seq", "padded_chunks"])
def test_run_encoder_matches_reference(whisper, seq):
    rcfg, pcfg, params, model = whisper
    frames = _x((B, seq, rcfg.d_model), 5)
    want = rtf._run_encoder(params, jnp.asarray(frames), _rctx(rcfg))
    rt = AdsalaRuntime()
    got = ptf._run_encoder(model, torch.from_numpy(frames), pl.Ctx(pcfg, rt))
    assert got.shape == want.shape == (B, seq, rcfg.d_model)
    assert _rel(got, want) < TOL
    assert rt.stats.for_backend("hopper").default_calls == \
        _encoder_calls(pcfg)


# ---------------------------------------------------------------------------
# the models: forward, prefill, decode_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Per arch: both configs, both models on the same weights, the inputs,
    and the reference's routed forward, prefill of the first S - 1 tokens
    and the decode step of token S - 1 at its true position."""
    rcfg, pcfg = _cfgs(request.param)
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    model = ptf.from_reference(pcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (B, S),
                                             dtype=np.int32)
    extra = stub_inputs(rcfg, B, np.random.default_rng(1))
    rt = RefRuntime()
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    logits, _ = rtf.forward(params, batch, rcfg, runtime=rt)
    max_len = S + rcfg.vision_tokens + 4
    caches = rtf.init_decode_state(rcfg, B, max_len, dtype=jnp.float32)
    last, caches = rtf.prefill(params, {**batch, "tokens": batch["tokens"][
        :, :-1]}, caches, rcfg, runtime=rt)
    enc_out = (rtf._run_encoder(params, batch["frames"], _rctx(rcfg, rt))
               if rcfg.family == "audio" else None)
    step, _ = rtf.decode_step(params, batch["tokens"][:, -1:], caches, rcfg,
                              runtime=rt, enc_out=enc_out, pos=S - 1)
    assert rt.stats.for_backend("pallas").default_calls > 0   # routed
    return {"rcfg": rcfg, "pcfg": pcfg, "model": model, "toks": toks,
            "extra": extra, "max_len": max_len,
            "ref": {"forward": np.asarray(logits), "prefill": np.asarray(last),
                    "decode": np.asarray(step)}}


def _batch(pair, tokens):
    return {"tokens": _t(tokens),
            **{k: torch.from_numpy(v) for k, v in pair["extra"].items()}}


def test_forward_matches_reference_routed(pair):
    cfg = pair["pcfg"]
    rt = AdsalaRuntime()
    got, aux = ptf.forward(pair["model"], _batch(pair, pair["toks"]), cfg,
                           runtime=rt)
    assert got.shape == pair["ref"]["forward"].shape == (
        B, S + cfg.vision_tokens, cfg.vocab)
    assert float(aux) == 0.0
    assert _rel(got, pair["ref"]["forward"]) < TOL
    # every dense matmul went through run_op: one decision each
    assert rt.stats.for_backend("hopper").default_calls == \
        _linears(cfg, decode=False) + _encoder_calls(cfg)


def test_prefill_and_decode_match_reference_routed(pair):
    cfg, model = pair["pcfg"], pair["model"]
    caches = ptf.init_decode_state(cfg, B, pair["max_len"],
                                   dtype=torch.float32, device="cpu")
    assert len(caches) == cfg.n_layers
    rt = AdsalaRuntime()
    batch = _batch(pair, pair["toks"][:, :-1])
    enc_out = (ptf._run_encoder(model, batch["frames"], pl.Ctx(cfg, rt))
               if cfg.family == "audio" else None)
    last, caches = ptf.prefill(model, batch, caches, cfg, runtime=rt,
                               enc_out=enc_out)
    assert _rel(last, pair["ref"]["prefill"]) < TOL
    calls = rt.stats.for_backend("hopper").default_calls
    assert calls == _linears(cfg, decode=False) + _encoder_calls(cfg)
    step, caches = ptf.decode_step(model, _t(pair["toks"][:, -1:]), caches,
                                   cfg, runtime=rt, enc_out=enc_out,
                                   pos=S - 1)
    assert step.shape == (B, 1, cfg.vocab)
    assert _rel(step, pair["ref"]["decode"]) < TOL
    assert rt.stats.for_backend("hopper").default_calls - calls == \
        _linears(cfg, decode=True)
    assert all(c["len"] == S + cfg.vision_tokens for c in caches)
    # the step at its true position is the forward's last position
    full, _ = ptf.forward(model, _batch(pair, pair["toks"]), cfg)
    assert _rel(step[:, 0], full[:, -1]) < TOL


def test_whisper_prefill_runs_the_encoder_itself(whisper):
    rcfg, cfg, _, model = whisper
    frames = torch.from_numpy(_x((B, cfg.enc_seq, cfg.d_model), 6))
    toks = _t(np.arange(B * 4).reshape(B, 4) % cfg.vocab)
    runs = []
    for enc_out in (None, ptf._run_encoder(model, frames, pl.Ctx(cfg))):
        caches = ptf.init_decode_state(cfg, B, 8, dtype=torch.float32,
                                       device="cpu")
        runs.append(ptf.prefill(model, {"tokens": toks, "frames": frames},
                                caches, cfg, enc_out=enc_out)[0])
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="needs enc_out"):
        ptf.decode_step(model, toks[:, :1], caches, cfg, pos=4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_whisper_session_greedy_tokens_match_reference_at_true_positions(
        whisper):
    """The session encodes once and decodes token t at position P + t: the
    reference's prefill and decode_step(pos=P + t), greedy, on the same
    weights (the reference's own session decodes at position 0)."""
    rcfg, cfg, params, model = whisper
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, PROMPT),
                                                dtype=np.int32)
    frames = _x((B, cfg.enc_seq, cfg.d_model), 7)
    rt = RefRuntime()
    caches = rtf.init_decode_state(rcfg, B, PROMPT + NEW + 8,
                                   dtype=jnp.float32)
    enc_out = rtf._run_encoder(params, jnp.asarray(frames), _rctx(rcfg, rt))
    logits, caches = rtf.prefill(params, {"tokens": jnp.asarray(prompts),
                                          "frames": jnp.asarray(frames)},
                                 caches, rcfg, runtime=rt)
    want = []
    for t in range(NEW):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, caches = rtf.decode_step(params, tok, caches, rcfg,
                                         runtime=rt, enc_out=enc_out,
                                         pos=PROMPT + t)
    want = np.concatenate(want, axis=1)
    prt = AdsalaRuntime()
    got = ServeSession(cfg=cfg, params=model, max_len=PROMPT + NEW + 8,
                       runtime=prt, device="cpu").generate(
        prompts, max_new=NEW, frames=frames)
    assert got.shape == want.shape == (B, NEW) and got.dtype == np.int32
    # the encoder once, then the prefill and NEW decode steps
    assert prt.stats.for_backend("hopper").default_calls == \
        _encoder_calls(cfg) + (1 + NEW) * _linears(cfg, decode=True)
    # the port's top-2 margins, teacher-forced on the reference's tokens
    caches = ptf.init_decode_state(cfg, B, PROMPT + NEW + 8,
                                   dtype=torch.float32, device="cpu")
    enc = ptf._run_encoder(model, torch.from_numpy(frames), pl.Ctx(cfg))
    lg = [ptf.prefill(model, {"tokens": _t(prompts)}, caches, cfg,
                      enc_out=enc)[0]]
    for t in range(NEW - 1):
        lg.append(ptf.decode_step(model, _t(want[:, t:t + 1]), caches, cfg,
                                  enc_out=enc, pos=PROMPT + t)[0])
    lg = torch.cat(lg, dim=1)
    top2 = lg.topk(2, dim=-1).values
    margins = ((top2[..., 0] - top2[..., 1]) / lg.abs().amax()).numpy()
    compared = 0
    for b in range(B):
        for t in range(NEW):
            if margins[b, t] <= 10 * TOL:
                break               # a near-tie: later tokens may part
            assert got[b, t] == want[b, t], (b, t, margins[b, t])
            compared += 1
    assert compared >= B * NEW // 2


@pytest.mark.parametrize("arch,name,calls", [
    # the encoder (2 x 6) once, then 2 dec_cross layers x 10 and the head,
    # every pass
    ("whisper-medium", "whisper-smoke", 12 + 21 * 5),
    # 3 layers x 7 and the head, every pass, and the vision projection at
    # the prefill
    ("internvl2-76b", "internvl2-smoke", 23 + 22 * 4),
], ids=ARCHS)
def test_main_serves_the_smoke_model_on_the_cpu(arch, name, calls, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "8",
                      "--max-new", "4"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    text = capsys.readouterr().out
    assert f"{name} on cpu" in text
    assert f"model_evals 0 default_calls {calls}" in text


def test_main_sizes_the_cache_for_the_vision_tokens(monkeypatch, capsys):
    """The VLM's prefill writes vision_tokens + prompt_len positions, so the
    cache holds them besides max_new + 8 (at full size 256 + 16 + 16 + 8,
    where prompt_len + max_new + 8 = 40 would overflow)."""
    seen = []

    class Spy(ServeSession):
        def __post_init__(self):
            seen.append(self.max_len)
            super().__post_init__()

    monkeypatch.setattr(serve, "ServeSession", Spy)
    for arch in ("internvl2-76b", "llama3-8b"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--requests", "1", "--prompt-len", "8", "--max-new",
                    "4"])
    capsys.readouterr()
    vision = pconfigs.get_smoke_config("internvl2-76b").vision_tokens
    assert seen == [8 + 4 + 8 + vision, 8 + 4 + 8]
    # without that room the port's attention refuses the prefill
    cfg = dataclasses.replace(pconfigs.get_smoke_config("internvl2-76b"),
                              compute_dtype="float32")
    model = ptf.init_params(0, cfg, device="cpu")
    caches = ptf.init_decode_state(cfg, 1, 8 + 4 + 8, dtype=torch.float32,
                                   device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        ptf.prefill(model, {"tokens": torch.zeros((1, 16), dtype=torch.long),
                            "vision": torch.zeros((1, vision, cfg.d_model))},
                    caches, cfg)


# ---------------------------------------------------------------------------
# construction and parameter counts
# ---------------------------------------------------------------------------

def test_whisper_decode_state_is_the_self_attention_cache_only():
    cfg = pconfigs.get_smoke_config("whisper_medium")
    model = ptf.init_params(0, cfg, device="cpu")
    assert [type(m).__name__ for m in model.layers] == \
        ["DecCross"] * cfg.n_layers
    assert len(model.encoder.blocks) == cfg.n_enc_layers
    assert all(b.kind == "enc" for b in model.encoder.blocks)
    caches = ptf.init_decode_state(cfg, 2, 10, dtype=torch.float32,
                                   device="cpu")
    assert len(caches) == cfg.n_layers
    for c in caches:
        assert set(c) == {"k", "v", "len"} and c["len"] == 0
        assert c["k"].shape == (2, 10, cfg.kv_heads, cfg.hd())


@pytest.mark.parametrize("arch,layers,count", [
    ("whisper-medium", None, 810_987_520),
    ("internvl2-76b", None, 70_620_815_360),
    # the depth the chip smoke serves the VLM at: it does not fit the card
    ("internvl2-76b", 16, 15_858_933_760),
], ids=["whisper_medium", "internvl2_76b", "internvl2_76b_16_layers"])
def test_parameter_count_equals_reference(arch, layers, count):
    kw = {} if layers is None else {"n_layers": layers}
    cfg = dataclasses.replace(pconfigs.get_config(arch), **kw)
    assert ptf.param_count(ptf.init_params(0, cfg, device="meta")) == count
    rcfg = dataclasses.replace(rconfigs.get_config(arch), **kw)
    shapes = jax.eval_shape(lambda: rtf.init_params(jax.random.PRNGKey(0),
                                                    rcfg))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) \
        == count
