"""The port's recurrent families (``repro_torch.models.mamba2``, ``.rwkv6``
and the ``"mamba2"``, ``"zamba_super"`` and ``"rwkv6"`` block kinds)
against the reference package's on the same weights.

Both packages get the parameters of one seeded reference ``init_*`` (the
port loads them as its state dict, or through ``from_reference``) and the
same numpy inputs.  The reference runs routed (``use_pallas_gemm=True``:
every routed linear a Pallas GEMM in interpret mode, as
``tests/test_torch_moe.py`` runs it); the port runs routed on the CPU,
where every ``run_op`` GEMM is the kernel's plain version.  Compared: the
chunked scans (SSD and WKV) at ragged lengths over several chunks and in
the regime where the reference's −30 clamp of the running log-decay bites,
the causal convolution and the token shift, both mixers without state,
with state at prefill and over decode steps (the states too), and
``forward``, ``prefill`` and ``decode_step`` of the zamba2 and rwkv6 smoke
configs; the routed calls a pass; the full-size parameter counts.
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
from repro.models import mamba2 as rm2
from repro.models import rwkv6 as rrw
from repro.models import transformer as rtf
from repro.models.sharding import DEFAULT_RULES
import repro_torch.configs as pconfigs
from repro_torch.core import AdsalaRuntime
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as pl
from repro_torch.models import mamba2 as pm2
from repro_torch.models import rwkv6 as prw
from repro_torch.models import transformer as ptf

#: max |port - reference| over the largest |reference| value, as in
#: tests/test_torch_moe.py: the two sum float32 products in other orders
TOL = 1e-5

ARCHS = ("zamba2_1p2b", "rwkv6_1p6b")
B, S = 2, 20


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfgs(arch, **kw):
    """The reference's and the port's smoke config, routed, in float32."""
    kw = dict(compute_dtype="float32", use_pallas_gemm=True, **kw)
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **kw))


def _rctx(rcfg):
    return rl.Ctx(rcfg, None, DEFAULT_RULES, RefRuntime())


def _load(module, tree):
    """``module`` (built on the meta device) holding the reference's
    parameter dict ``tree``."""
    state = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, f"{prefix}{key}.")
        else:
            state[prefix[:-1]] = torch.tensor(np.asarray(node))

    walk(tree, "")
    module.load_state_dict(state, strict=True, assign=True)
    return module


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.long)


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


# ---------------------------------------------------------------------------
# the chunked scans
# ---------------------------------------------------------------------------

def _ssd_inputs(seq, G, seed, *, H=4, P=8, N=16):
    return {"x": _x((B, seq, H, P), seed),
            "dt": _softplus(_x((B, seq, H), seed + 1)),
            "A": -np.exp(_x((H,), seed + 2, 0.5)),
            "B_in": _x((B, seq, G, N), seed + 3),
            "C_in": _x((B, seq, G, N), seed + 4),
            "h0": _x((B, H, P, N), seed + 5)}


def _ssd_both(inp, rcfg, pcfg):
    want_y, want_h = rm2._ssd_chunked(
        *(jnp.asarray(inp[k]) for k in ("x", "dt", "A", "B_in", "C_in")),
        rcfg, jnp.asarray(inp["h0"]))
    got_y, got_h = pm2._ssd_chunked(
        *(torch.from_numpy(inp[k]) for k in ("x", "dt", "A", "B_in", "C_in")),
        pcfg, torch.from_numpy(inp["h0"]))
    return (got_y, got_h), (np.asarray(want_y), np.asarray(want_h))


def _ssd_recurrence(inp):
    """The SSD recurrence token by token in float64 (no clamp)."""
    x, dt, A = (inp[k].astype(np.float64) for k in ("x", "dt", "A"))
    H = x.shape[2]
    rep = H // inp["B_in"].shape[2]
    Bh = np.repeat(inp["B_in"].astype(np.float64), rep, axis=2)
    Ch = np.repeat(inp["C_in"].astype(np.float64), rep, axis=2)
    h = inp["h0"].astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        h = h * np.exp(dt[:, t] * A)[:, :, None, None] + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("seq,G", [(37, 1), (37, 2), (16, 2), (5, 1)],
                         ids=["ragged", "ragged_G2", "whole", "short"])
def test_ssd_chunked_matches_reference(seq, G):
    """Chunk 8: 5 chunks with padding, 2 whole chunks, one short chunk;
    G = 2 groups over 4 heads (``repeat_interleave``, not ``repeat``)."""
    rcfg, pcfg = _cfgs("zamba2_1p2b", ssm_chunk=8, ssm_groups=G)
    inp = _ssd_inputs(seq, G, seq + G)
    (got_y, got_h), (want_y, want_h) = _ssd_both(inp, rcfg, pcfg)
    assert got_y.shape == want_y.shape == inp["x"].shape
    assert _rel(got_y, want_y) < TOL and _rel(got_h, want_h) < TOL
    # here the decay never reaches the clamp: both are the recurrence
    rec_y, rec_h = _ssd_recurrence(inp)
    assert _rel(got_y, rec_y) < 1e-4 and _rel(got_h, rec_h) < 1e-4


def _wkv_inputs(seq, seed, *, H=4, K=8, w_mean=-1.0, w_std=0.5):
    return {"r": _x((B, seq, H, K), seed), "k": _x((B, seq, H, K), seed + 1),
            "v": _x((B, seq, H, K), seed + 2),
            "w_log": -np.exp(w_mean + _x((B, seq, H, K), seed + 3, w_std)),
            "u": _x((H, K), seed + 4, 0.1),
            "S0": _x((B, H, K, K), seed + 5)}


def _wkv_both(inp, chunk):
    keys = ("r", "k", "v", "w_log", "u")
    want_y, want_s = rrw._wkv_chunked(*(jnp.asarray(inp[k]) for k in keys),
                                      chunk, jnp.asarray(inp["S0"]))
    got_y, got_s = prw._wkv_chunked(*(torch.from_numpy(inp[k]) for k in keys),
                                    chunk, torch.from_numpy(inp["S0"]))
    return (got_y, got_s), (np.asarray(want_y), np.asarray(want_s))


def _wkv_recurrence(inp):
    """The WKV recurrence token by token in float64 (no clamp)."""
    r, k, v, w_log = (inp[n].astype(np.float64)
                      for n in ("r", "k", "v", "w_log"))
    u = inp["u"].astype(np.float64)
    S = inp["S0"].astype(np.float64)
    ys = []
    for t in range(r.shape[1]):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, t],
                            S + u[None, :, :, None] * kv))
        S = S * np.exp(w_log[:, t])[..., None] + kv
    return np.stack(ys, axis=1), S


@pytest.mark.parametrize("seq", (37, 16, 5), ids=["ragged", "whole",
                                                  "short"])
def test_wkv_chunked_matches_reference(seq):
    inp = _wkv_inputs(seq, seq)
    (got_y, got_s), (want_y, want_s) = _wkv_both(inp, 8)
    assert got_y.shape == want_y.shape == inp["r"].shape
    assert _rel(got_y, want_y) < TOL and _rel(got_s, want_s) < TOL
    rec_y, rec_s = _wkv_recurrence(inp)
    assert _rel(got_y, rec_y) < 1e-4 and _rel(got_s, rec_s) < 1e-4


def test_ssd_in_the_clamped_regime_matches_reference():
    """One chunk of 128 at the full configs' decays (dt = softplus(N(0,1)),
    about 0.8 a token, A = -1): the running log-decay passes -30 after
    about 35 tokens.  Port and reference agree there, while both stand
    far from the recurrence past that point and in the final state; before
    it, both are the recurrence."""
    rcfg, pcfg = _cfgs("zamba2_1p2b", ssm_chunk=256)   # the full config's
    inp = _ssd_inputs(128, 1, 7)
    inp["A"] = -np.ones_like(inp["A"])
    inp["h0"] = np.zeros_like(inp["h0"])
    (got_y, got_h), (want_y, want_h) = _ssd_both(inp, rcfg, pcfg)
    assert _rel(got_y, want_y) < TOL and _rel(got_h, want_h) < TOL
    cum = np.cumsum(-inp["dt"].astype(np.float64), axis=1)   # (B, S, H)
    t_clamp = int(np.argmax((cum < -30).any(axis=(0, 2))))
    assert 20 < t_clamp < 60
    rec_y, rec_h = _ssd_recurrence(inp)
    got_y = got_y.double().numpy()
    scale = np.abs(rec_y).max()
    before = np.abs(got_y[:, :t_clamp] - rec_y[:, :t_clamp]).max() / scale
    late = np.abs(got_y[:, 100:] - rec_y[:, 100:]).max() / scale
    assert before < 1e-4 and late > 0.1
    assert _rel(got_h, rec_h) > 0.5                   # the state is lost


def test_wkv_in_the_clamped_regime_matches_reference():
    """One chunk of 128 (rwkv_chunk) at the initial decay, w_log about
    -exp(-1) = -0.37: the clamp bites after about 81 tokens.  Port and
    reference agree; both stand far from the recurrence in the final
    state and, by a smaller share, in the late outputs."""
    inp = _wkv_inputs(128, 9, w_mean=-1.0, w_std=0.1)
    inp["S0"] = np.zeros_like(inp["S0"])
    (got_y, got_s), (want_y, want_s) = _wkv_both(inp, 128)
    assert _rel(got_y, want_y) < TOL and _rel(got_s, want_s) < TOL
    cum = np.cumsum(inp["w_log"].astype(np.float64), axis=1)
    t_clamp = int(np.argmax((cum < -30).any(axis=(0, 2, 3))))
    assert 60 < t_clamp < 100
    rec_y, rec_s = _wkv_recurrence(inp)
    got_y = got_y.double().numpy()
    scale = np.abs(rec_y).max()
    before = np.abs(got_y[:, :t_clamp] - rec_y[:, :t_clamp]).max() / scale
    late = np.abs(got_y[:, 100:] - rec_y[:, 100:]).max() / scale
    assert before < 1e-4 and late > 0.1
    assert _rel(got_s, rec_s) > 0.5


# ---------------------------------------------------------------------------
# the small pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", (1, 3, 11))
def test_causal_conv_matches_reference(seq):
    x, w, b = _x((B, seq, 24), 1), _x((4, 24), 2), _x((24,), 3)
    want = rm2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = pm2._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    assert got.shape == want.shape and _rel(got, want) < TOL


@pytest.mark.parametrize("with_prev", (False, True), ids=["zeros", "carry"])
def test_shift_matches_reference(with_prev):
    x, prev = _x((B, 6, 16), 4), _x((B, 16), 5)
    want = rrw._shift(jnp.asarray(x), jnp.asarray(prev) if with_prev
                      else None)
    got = prw._shift(torch.from_numpy(x), torch.from_numpy(prev)
                     if with_prev else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the mixers: without state, prefill with state, decode steps
# ---------------------------------------------------------------------------

def _mamba_pair(G=1):
    rcfg, pcfg = _cfgs("zamba2_1p2b", ssm_chunk=8, ssm_groups=G)
    p = rm2.init_mamba2(jax.random.PRNGKey(3), rcfg)
    # nonzero biases, decays and skips, so each parameter reaches the output
    p = dict(p, A_log=jnp.asarray(_x(p["A_log"].shape, 11, 0.5)),
             dt_bias=jnp.asarray(_x(p["dt_bias"].shape, 12, 0.5)),
             D=jnp.asarray(_x(p["D"].shape, 13)),
             conv_b=jnp.asarray(_x(p["conv_b"].shape, 14, 0.1)))
    mod = _load(pm2.Mamba2(pcfg, device="meta"), jax.tree.map(np.asarray, p))
    return rcfg, pcfg, p, mod, rm2.mamba2_mixer, pm2.mamba2_mixer


def _rwkv_pair():
    rcfg, pcfg = _cfgs("rwkv6_1p6b", rwkv_chunk=8)
    p = rrw.init_rwkv6(jax.random.PRNGKey(4), rcfg)
    p = dict(p, ln_bias=jnp.asarray(_x(p["ln_bias"].shape, 15, 0.1)),
             w0=jnp.asarray(-1.0 + _x(p["w0"].shape, 16, 0.3)))
    mod = _load(prw.RWKV6(pcfg, device="meta"), jax.tree.map(np.asarray, p))
    return rcfg, pcfg, p, mod, rrw.rwkv6_block, prw.rwkv6_block


MIXERS = {"mamba2": _mamba_pair, "mamba2_G2": lambda: _mamba_pair(2),
          "rwkv6": _rwkv_pair}


@pytest.mark.parametrize("which", MIXERS)
def test_mixer_without_state_matches_reference(which):
    rcfg, pcfg, p, mod, rfn, pfn = MIXERS[which]()
    x = _x((B, 37, rcfg.d_model), 6)
    want, none = rfn(p, jnp.asarray(x), _rctx(rcfg))
    got, state = pfn(mod, torch.from_numpy(x), pl.Ctx(pcfg))
    assert none is None and state is None
    assert got.shape == want.shape == x.shape and _rel(got, want) < TOL


def _state_pair(which, rcfg, pcfg):
    """A zeroed state of each package for ``which``, its float32 leaves
    then filled with the same random values (a carried state)."""
    if which.startswith("mamba2"):
        rstate = rm2.init_mamba2_state(rcfg, B, jnp.float32)
        pstate = pm2.init_mamba2_state(pcfg, B, torch.float32, "cpu")
    else:
        rstate = rrw.init_rwkv6_state(rcfg, B, jnp.float32)
        pstate = prw.init_rwkv6_state(pcfg, B, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in pstate.items()} == {
        k: tuple(v.shape) for k, v in rstate.items()}
    assert all(v.dtype == torch.float32 for v in pstate.values())
    for i, key in enumerate(sorted(rstate)):
        val = _x(rstate[key].shape, 20 + i, 0.3)
        rstate[key] = jnp.asarray(val)
        pstate[key].copy_(torch.from_numpy(val))
    return rstate, pstate


@pytest.mark.parametrize("which", MIXERS)
def test_mixer_prefill_then_decode_matches_reference(which):
    """A prefill of 13 tokens (two chunks of 8) from a carried state, then
    4 one-token steps: the outputs and every state leaf after each pass,
    the port's written in place."""
    rcfg, pcfg, p, mod, rfn, pfn = MIXERS[which]()
    rstate, pstate = _state_pair(which, rcfg, pcfg)
    ptrs = {k: v.data_ptr() for k, v in pstate.items()}
    for i, n in enumerate((13, 1, 1, 1, 1)):
        x = _x((B, n, rcfg.d_model), 30 + i)
        want, rstate = rfn(p, jnp.asarray(x), _rctx(rcfg), state=rstate)
        got, out = pfn(mod, torch.from_numpy(x), pl.Ctx(pcfg), state=pstate)
        assert out is pstate
        assert got.shape == want.shape == x.shape and _rel(got, want) < TOL
        for key, val in rstate.items():
            assert _rel(pstate[key], val) < TOL, (i, key)
    assert {k: v.data_ptr() for k, v in pstate.items()} == ptrs


def test_mamba2_conv_state_holds_the_last_inputs_also_at_a_short_prefill():
    """A prefill of 2 tokens (fewer than W - 1 = 3): the convolution's
    state keeps the carried row before the 2 new inputs, as the
    reference's ``hist[:, -(W-1):]``."""
    rcfg, pcfg, p, mod, rfn, pfn = MIXERS["mamba2"]()
    rstate, pstate = _state_pair("mamba2", rcfg, pcfg)
    x = _x((B, 2, rcfg.d_model), 40)
    _, rstate = rfn(p, jnp.asarray(x), _rctx(rcfg), state=rstate)
    before = pstate["conv"][:, -1].clone()
    pfn(mod, torch.from_numpy(x), pl.Ctx(pcfg), state=pstate)
    assert torch.equal(pstate["conv"][:, 0], before)
    assert _rel(pstate["conv"], rstate["conv"]) < TOL


# ---------------------------------------------------------------------------
# the whole model: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Per arch: both configs, both models on the same weights, and the
    reference's routed forward, prefill and two decode steps."""
    rcfg, pcfg = _cfgs(request.param)
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    model = ptf.from_reference(pcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (B, S),
                                             dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    rt = RefRuntime()
    logits, _ = rtf.forward(params, batch, rcfg, runtime=rt)
    caches = rtf.init_decode_state(rcfg, B, S + 4, dtype=jnp.float32)
    last, caches = rtf.prefill(params, batch, caches, rcfg, runtime=rt)
    prefill_last = np.asarray(last)
    steps, nxt = [], []
    for _ in range(2):
        nxt.append(np.asarray(jnp.argmax(last[:, -1:], -1).astype(jnp.int32)))
        last, caches = rtf.decode_step(params, jnp.asarray(nxt[-1]), caches,
                                       rcfg, runtime=rt)
        steps.append(np.asarray(last))
    assert rt.stats.for_backend("pallas").default_calls > 0   # routed
    return {"rcfg": rcfg, "pcfg": pcfg, "model": model, "toks": toks,
            "next": nxt, "ref": {"forward": np.asarray(logits),
                                 "prefill": prefill_last, "decode": steps}}


def test_layers_follow_the_segments(pair):
    cfg, model = pair["pcfg"], pair["model"]
    kinds = [blk.kind for blk in model.layers]
    assert kinds == [k for k, r in cfg.segments() for _ in range(r)]
    if cfg.family == "hybrid":
        assert kinds == ["zamba_super"] * 2 + ["mamba2"]
        assert all(len(blk.mamba) == cfg.shared_attn_every
                   for blk in model.layers[:2])
        assert isinstance(model.shared_attn, ptf.Block)
    else:
        assert kinds == ["rwkv6"] * cfg.n_layers
        assert model.shared_attn is None


def test_forward_matches_reference_routed(pair):
    got, aux = ptf.forward(pair["model"], {"tokens": _t(pair["toks"])},
                           pair["pcfg"], runtime=AdsalaRuntime())
    assert got.shape == pair["ref"]["forward"].shape == (
        B, S, pair["pcfg"].vocab)
    assert _rel(got, pair["ref"]["forward"]) < TOL
    assert float(aux) == 0.0


def _leaves(node) -> list:
    """The tensors of a nest of dicts and lists."""
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, list):
        return [t for child in node for t in _leaves(child)]
    return [node] if isinstance(node, torch.Tensor) else []


def test_prefill_and_decode_match_reference_routed(pair):
    """A prefill and two decode steps, the per-kind caches written in
    place."""
    cfg = pair["pcfg"]
    caches = ptf.init_decode_state(cfg, B, S + 4, dtype=torch.float32,
                                   device="cpu")
    tensors = _leaves(caches)
    ptrs = [t.data_ptr() for t in tensors]
    last, caches = ptf.prefill(pair["model"], {"tokens": _t(pair["toks"])},
                               caches, cfg)
    assert last.shape == (B, 1, cfg.vocab)
    assert _rel(last, pair["ref"]["prefill"]) < TOL
    for nxt, want in zip(pair["next"], pair["ref"]["decode"]):
        step, caches = ptf.decode_step(pair["model"], _t(nxt), caches, cfg)
        assert step.shape == (B, 1, cfg.vocab) and _rel(step, want) < TOL
    assert [t.data_ptr() for t in tensors] == ptrs
    if cfg.family == "hybrid":
        assert set(caches[0]) == {"mamba", "attn"}
        assert len(caches[0]["mamba"]) == cfg.shared_attn_every
        assert caches[0]["attn"]["len"] == S + 2
        assert set(caches[-1]) == {"ssm", "conv"}
    else:
        assert all(set(c) == {"tm_prev", "cm_prev", "S"} for c in caches)


def _calls_a_pass(cfg) -> int:
    """Routed calls a pass from the config: zamba2's mamba2 block 2
    (in_proj, out_proj); a zamba_super its blocks', its in_proj and the
    shared block's 4 attention and 3 MLP linears; an rwkv6 layer 8; and the
    LM head."""
    per = {"mamba2": 2, "zamba_super": 2 * cfg.shared_attn_every + 1 + 4 + 3,
           "rwkv6": 8}
    return sum(r * per[k] for k, r in cfg.segments()) + 1


@pytest.mark.parametrize("arch,per_pass", [("zamba2_1p2b", 27),
                                           ("rwkv6_1p6b", 25)])
def test_every_routed_linear_is_one_run_op_and_no_lora_is_routed(
        arch, per_pass, monkeypatch):
    """Every linear one ``run_op`` GEMM a pass, prefill and decode alike,
    its weight the stored ``Linear.w``; the LoRA products (``lora_A``,
    ``lora_B``, ``w_lora_A``, ``w_lora_B``) and the scans stay plain."""
    _, cfg = _cfgs(arch)
    assert _calls_a_pass(cfg) == per_pass
    model = ptf.init_params(0, cfg, device="cpu")
    linears = {m.w.data_ptr() for m in model.modules()
               if isinstance(m, pl.Linear)}
    lora = {getattr(m, n).data_ptr() for m in model.modules()
            if isinstance(m, prw.RWKV6)
            for n in ("lora_A", "lora_B", "w_lora_A", "w_lora_B")}
    runs = []
    real = kops.run_op

    def spy(op, operands, **kw):
        runs.append((op, operands[1].dim(), operands[1].data_ptr()))
        return real(op, operands, **kw)

    monkeypatch.setattr(kops, "run_op", spy)
    rt = AdsalaRuntime()
    caches = ptf.init_decode_state(cfg, B, S + 4, dtype=torch.float32,
                                   device="cpu")
    toks = torch.zeros((B, S), dtype=torch.long)
    ptf.prefill(model, {"tokens": toks}, caches, cfg, runtime=rt)
    assert len(runs) == per_pass
    ptf.decode_step(model, toks[:, :1], caches, cfg, runtime=rt)
    assert len(runs) == 2 * per_pass
    ptf.forward(model, {"tokens": toks}, cfg, runtime=rt)
    assert len(runs) == 3 * per_pass
    assert {(op, dim) for op, dim, _ in runs} == {("gemm", 2)}
    ptrs = {ptr for _, _, ptr in runs}
    assert ptrs == linears and not ptrs & lora
    assert rt.stats.for_backend("hopper").default_calls == len(runs)


def test_shared_block_is_one_module_read_by_every_super():
    _, cfg = _cfgs("zamba2_1p2b")
    model = ptf.init_params(0, cfg, device="cpu")
    seen = []
    hook = model.shared_attn.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape))
    ptf.forward(model, {"tokens": torch.zeros((B, 6), dtype=torch.long)},
                cfg)
    hook.remove()
    assert seen == [(B, 6, cfg.d_model)] * 2
    names = [n for n, _ in model.named_parameters() if "attn.wq" in n]
    assert names == ["shared_attn.attn.wq.w"]


# ---------------------------------------------------------------------------
# full-size parameter counts and initial scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,count", [
    ("zamba2-1.2b", 1_220_805_504),
    ("rwkv6-1.6b", 1_615_497_216),
], ids=["zamba2_1p2b", "rwkv6_1p6b"])
def test_parameter_count_equals_reference(arch, count):
    cfg = pconfigs.get_config(arch)
    model = ptf.init_params(0, cfg, device="meta")
    assert ptf.param_count(model) == count
    assert len(model.layers) == sum(r for _, r in cfg.segments())
    shapes = jax.eval_shape(lambda: rtf.init_params(
        jax.random.PRNGKey(0), rconfigs.get_config(arch)))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) \
        == count


def test_init_scales_follow_the_reference():
    cfg = dataclasses.replace(pconfigs.get_smoke_config("zamba2_1p2b"),
                              d_model=256)
    model = ptf.init_params(3, cfg, device="cpu")
    sup, mixer = model.layers[0], model.layers[0].mamba[0].mixer
    for w, std in ((mixer.in_proj.w, 256 ** -0.5),
                   (mixer.out_proj.w, 512 ** -0.5), (mixer.conv_w, 0.1),
                   (sup.in_proj.w, 512 ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.05
    assert torch.equal(mixer.D, torch.ones_like(mixer.D))
    assert not mixer.A_log.any() and not mixer.dt_bias.any()
    cfg = dataclasses.replace(pconfigs.get_smoke_config("rwkv6_1p6b"),
                              d_model=256)
    blk = ptf.init_params(3, cfg, device="cpu").layers[0]
    for w, std in ((blk.lora_A, 0.01), (blk.w_lora_B, 0.01), (blk.u, 0.1),
                   (blk.wr.w, 256 ** -0.5), (blk.cm_wv.w, cfg.d_ff ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.05
    assert torch.equal(blk.w0, torch.full_like(blk.w0, -1.0))
    assert torch.equal(blk.mu, torch.full_like(blk.mu, 0.5))
