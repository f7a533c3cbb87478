"""The port's dense transformer (``repro_torch.configs``, ``.models``) against
the reference package's on the same weights.

Both packages get the parameters of one seeded reference ``init_params``
(the port through ``from_reference``) and the same numpy tokens.  The
reference runs routed (``use_pallas_gemm=True``: every dense matmul a
Pallas GEMM in interpret mode, as ``tests/test_model_dispatch.py`` runs
it); the port runs routed on the CPU, where every ``run_op`` GEMM is the
kernel's plain version.  Compared: ``forward``, ``prefill`` and
``decode_step`` logits of the four dense smoke configs, the attention,
RoPE, RMSNorm and MLP pieces, the routing gates, and the full llama3-8b
parameter count.
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
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as pl
from repro_torch.models import transformer as ptf

#: max |port - reference| over the largest |reference| value.  The two sum
#: float32 products in other orders (the reference's Pallas GEMM in k-tiles
#: of its knob, the port's plain version in torch.matmul's order); over the
#: smoke configs' three layers that reads about 1e-6.
TOL = 1e-5

#: the dense family: GQA, QKV bias, GELU with GQA, MQA (kv_heads=1)
DENSE = ("llama3_8b", "qwen15_4b", "starcoder2_15b", "granite_20b")
B, S = 2, 16


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfgs(arch, **kw):
    """The reference's and the port's smoke config, routed, in float32."""
    kw = dict(compute_dtype="float32", use_pallas_gemm=True, **kw)
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **kw))


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.long)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """Per dense arch: both configs, both models on the same weights, and
    the reference's routed forward, prefill and one decode step."""
    rcfg, pcfg = _cfgs(request.param)
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    model = ptf.from_reference(pcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    toks = _tokens(rcfg.vocab, (B, S))
    batch = {"tokens": jnp.asarray(toks)}
    rt = RefRuntime()
    logits, _ = rtf.forward(params, batch, rcfg, runtime=rt)
    caches = rtf.init_decode_state(rcfg, B, S + 4, dtype=jnp.float32)
    last, caches = rtf.prefill(params, batch, caches, rcfg, runtime=rt)
    nxt = np.asarray(jnp.argmax(last[:, -1:], -1).astype(jnp.int32))
    step, _ = rtf.decode_step(params, jnp.asarray(nxt), caches, rcfg,
                              runtime=rt)
    assert rt.stats.for_backend("pallas").default_calls > 0   # routed
    return {"arch": request.param, "rcfg": rcfg, "pcfg": pcfg,
            "model": model, "toks": toks, "next": nxt,
            "ref": {"forward": np.asarray(logits), "prefill": np.asarray(last),
                    "decode": np.asarray(step)}}


def _linears(cfg) -> int:
    """Routed matmuls of one pass: 7 per block (q, k, v, o and the MLP's
    three or two, SwiGLU or GELU) and the LM head."""
    per_block = 7 if cfg.mlp_type == "swiglu" else 6
    return per_block * cfg.n_layers + 1


def test_forward_matches_reference_routed(pair):
    rt = AdsalaRuntime()
    got, aux = ptf.forward(pair["model"], {"tokens": _t(pair["toks"])},
                           pair["pcfg"], runtime=rt)
    assert got.shape == pair["ref"]["forward"].shape == (
        B, S, pair["pcfg"].vocab)
    assert float(aux) == 0.0
    assert _rel(got, pair["ref"]["forward"]) < TOL
    # every dense matmul went through run_op: one decision each
    assert rt.stats.for_backend("hopper").default_calls == \
        _linears(pair["pcfg"])


def test_prefill_and_decode_match_reference_routed(pair):
    cfg = pair["pcfg"]
    caches = ptf.init_decode_state(cfg, B, S + 4, dtype=torch.float32,
                                   device="cpu")
    ptrs = [(c["k"].data_ptr(), c["v"].data_ptr()) for c in caches]
    last, caches = ptf.prefill(pair["model"], {"tokens": _t(pair["toks"])},
                               caches, cfg)
    assert last.shape == (B, 1, cfg.vocab)
    assert _rel(last, pair["ref"]["prefill"]) < TOL
    step, caches = ptf.decode_step(pair["model"], _t(pair["next"]), caches,
                                   cfg)
    assert step.shape == (B, 1, cfg.vocab)
    assert _rel(step, pair["ref"]["decode"]) < TOL
    # the caches were written in place, up to their length and no further
    assert [(c["k"].data_ptr(), c["v"].data_ptr()) for c in caches] == ptrs
    for c in caches:
        assert c["len"] == S + 1
        assert bool(c["k"][:, :S + 1].abs().sum(-1).gt(0).all())
        assert not c["k"][:, S + 1:].any() and not c["v"][:, S + 1:].any()


def test_decode_step_overflowing_the_cache_raises():
    _, cfg = _cfgs("llama3_8b")
    model = ptf.init_params(0, cfg, device="cpu")
    caches = ptf.init_decode_state(cfg, 1, 4, dtype=torch.float32,
                                   device="cpu")
    ptf.prefill(model, {"tokens": _t(_tokens(cfg.vocab, (1, 4)))}, caches,
                cfg)
    with pytest.raises(ValueError, match="do not fit"):
        ptf.decode_step(model, _t([[1]]), caches, cfg)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def _qkv(seed, S=40, T=48, H=4, KH=2, D=16):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return r(2, S, H, D), r(2, T, KH, D), r(2, T, KH, D)


@pytest.mark.parametrize("chunks,causal_skip,q_offset,valid", [
    ((16, 16), False, 0, None),
    ((8, 24), False, 0, None),
    ((16, 16), True, 0, None),
    ((16, 16), False, 8, (48, 30)),
    ((8, 24), True, 8, (48, 30)),
], ids=["16x16", "8x24", "causal_skip", "offset_valid", "8x24_skip_offset"])
def test_flash_attention_matches_reference(chunks, causal_skip, q_offset,
                                           valid):
    q, k, v = _qkv(1)
    kw = dict(causal=True, q_offset=q_offset, q_chunk=chunks[0],
              k_chunk=chunks[1], causal_skip=causal_skip)
    want = rl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_valid_len=None if valid is None
                              else jnp.asarray(valid), **kw)
    got = pl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             kv_valid_len=None if valid is None
                             else torch.tensor(valid), **kw)
    assert got.shape == want.shape == q.shape
    assert _rel(got, want) < TOL


def test_flash_attention_non_causal_matches_reference():
    q, k, v = _qkv(2, S=20, T=36)
    want = rl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False, q_chunk=8, k_chunk=16)
    got = pl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=False, q_chunk=8,
                             k_chunk=16)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("kh", (2, 1), ids=["gqa", "mqa"])
def test_dense_decode_attention_matches_reference(kh):
    q, k, v = _qkv(3, S=1, T=24, KH=kh)
    want = rl._dense_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), 17)
    got = pl._dense_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), 17)
    assert got.shape == want.shape == q.shape
    assert _rel(got, want) < TOL


def test_rope_at_llama3_theta_to_position_4096():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4096, 2, 128)).astype(np.float32)
    pos = np.arange(4096, dtype=np.int32)[None]
    want = rl.rope(jnp.asarray(x), jnp.asarray(pos), theta=5e5)
    got = pl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=5e5)
    assert _rel(got, want) < TOL
    # a rotation: the norm of each (x1, x2) pair is kept
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    norm = pl.Norm(64, device="cpu")
    norm.scale.copy_(torch.from_numpy(scale))
    want = rl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert _rel(pl.rmsnorm(norm, torch.from_numpy(x)), want) < TOL


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(x)),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((exact - got).abs().max()) > 1e-4   # the forms differ


@pytest.mark.parametrize("arch", ("llama3_8b", "starcoder2_15b"),
                         ids=["swiglu", "gelu"])
def test_mlp_matches_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    p = rl.init_mlp(jax.random.PRNGKey(1), rcfg.d_model, rcfg.d_ff,
                    mlp_type=rcfg.mlp_type)
    mod = pl.MLP(pcfg.d_model, pcfg.d_ff, mlp_type=pcfg.mlp_type,
                 device="meta")
    mod.load_state_dict({f"{k}.w": torch.from_numpy(np.array(v["w"]))
                         for k, v in p.items()}, assign=True)
    x = np.random.default_rng(6).standard_normal(
        (2, 8, rcfg.d_model)).astype(np.float32)
    want = rl.mlp(p, jnp.asarray(x), rl.Ctx(rcfg, None, DEFAULT_RULES))
    got = pl.mlp(mod, torch.from_numpy(x), pl.Ctx(pcfg))
    assert _rel(got, want) < TOL


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_routing_respects_config_gates():
    rcfg, pcfg = _cfgs("qwen15_4b")
    plain = dataclasses.replace(pcfg, use_pallas_gemm=False)
    x = torch.ones(2, 8, pcfg.d_model)
    w = torch.ones(pcfg.d_model, 32)
    assert not pl.Ctx(plain).routes_gemm(x)
    assert not pl.Ctx(pcfg).routes_gemm(torch.ones(pcfg.d_model))
    ctx = pl.Ctx(pcfg, AdsalaRuntime())
    assert ctx.routes_gemm(x) and ctx.routes_gemm(x[0])
    assert torch.equal(pl.routed_matmul(x, w, ctx), x @ w)
    assert ctx.runtime.stats.for_backend("hopper").default_calls == 1
    # the reference's gates agree (meshless)
    assert rl.Ctx(rcfg, None, DEFAULT_RULES).routes_gemm(jnp.ones((2, 8, 4)))
    assert not rl.Ctx(dataclasses.replace(rcfg, use_pallas_gemm=False), None,
                      DEFAULT_RULES).routes_gemm(jnp.ones((2, 8, 4)))


def test_routed_matmul_high_rank_leading_axes(monkeypatch):
    """Two or more leading axes fold into one stack against the shared 2-D
    weight: one run_op, on the activations' device."""
    _, cfg = _cfgs("qwen15_4b")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 64)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    calls = []
    real = kops.run_op

    def spy(op, operands, **kw):
        calls.append((op, [tuple(o.shape) for o in operands], kw))
        return real(op, operands, **kw)

    monkeypatch.setattr(kops, "run_op", spy)
    got = pl.routed_matmul(x, w, pl.Ctx(cfg))
    assert got.shape == (2, 3, 8, 32)
    np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), rtol=1e-6,
                               atol=1e-6)
    ((op, shapes, kw),) = calls
    assert op == "gemm" and shapes == [(6, 8, 64), (64, 32)]
    assert kw["device"] == x.device and kw["backend"] == "hopper"
    # a (B, S, d) activation keeps its stack axis, no fold
    pl.routed_matmul(x[0], w, pl.Ctx(cfg))
    assert calls[1][1] == [(3, 8, 64), (64, 32)]


def test_routed_matmul_never_falls_back(monkeypatch):
    """A failing GEMM fails the linear: no retry on torch.matmul."""
    _, cfg = _cfgs("llama3_8b")

    def broken(*a, **k):
        raise RuntimeError("GEMM kernel launch failed")

    monkeypatch.setattr(kops, "run_op", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        pl.routed_matmul(torch.ones(2, 3, 8), torch.ones(8, 4), pl.Ctx(cfg))


# ---------------------------------------------------------------------------
# configs, construction, parameter count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", rconfigs.ARCHITECTURES)
def test_configs_carry_across_field_by_field(arch):
    assert pconfigs.ARCHITECTURES == rconfigs.ARCHITECTURES
    assert pconfigs.ALIASES == rconfigs.ALIASES
    for get in ("get_config", "get_smoke_config"):
        ref = dataclasses.asdict(getattr(rconfigs, get)(arch))
        port = dataclasses.asdict(getattr(pconfigs, get)(arch))
        assert ref.pop("gemm_backend") == "pallas"
        assert port.pop("gemm_backend") == "hopper"
        ref.pop("gemm_interpret")
        assert port == ref
    assert pconfigs.get_config(arch).segments() == \
        rconfigs.get_config(arch).segments()


def test_llama3_8b_parameter_count_equals_reference():
    cfg = pconfigs.get_config("llama3-8b")
    model = ptf.init_params(0, cfg, device="meta")
    assert ptf.param_count(model) == 8_030_261_248
    shapes = jax.eval_shape(lambda: rtf.init_params(
        jax.random.PRNGKey(0), rconfigs.get_config("llama3-8b")))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) \
        == 8_030_261_248


def test_init_scales_follow_the_reference():
    cfg = dataclasses.replace(pconfigs.get_smoke_config("llama3_8b"),
                              d_model=256, d_ff=512, n_heads=8, kv_heads=2)
    model = ptf.init_params(3, cfg, device="cpu")
    blk = model.layers[0]
    for lin, std in ((blk.attn.wq, 256 ** -0.5), (blk.mlp.wd, 512 ** -0.5),
                     (blk.attn.wo, 256 ** -0.5), (model.lm_head, 0.02)):
        assert abs(float(lin.w.std()) / std - 1) < 0.05
    assert abs(float(model.embed.table.std()) / 0.02 - 1) < 0.05
    assert torch.equal(blk.ln1.scale, torch.ones(256))
    assert not any(p.requires_grad for p in model.parameters())
    again = ptf.init_params(3, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = pconfigs.get_smoke_config("llama3_8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptf.init_params(0, cfg)
