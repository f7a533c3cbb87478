"""The port's MoE family (``repro_torch.models.moe``, ``.mla`` and the
``"moe"`` block kind) against the reference package's on the same weights.

Both packages get the parameters of one seeded reference ``init_*`` (the
port loads them as its state dict, or through ``from_reference``) and the
same numpy inputs.  The reference runs routed (``use_pallas_gemm=True``:
every dense matmul and every expert stack a Pallas GEMM in interpret mode,
as ``tests/test_torch_models.py`` runs it); the port runs routed on the
CPU, where every ``run_op`` GEMM is the kernel's plain version.  Compared:
the slot positions, ``moe_ffn`` with and without capacity drops, MLA in
its three forms, and ``forward``, ``prefill`` and ``decode_step`` of the
two MoE smoke configs (granite-moe: GQA, no shared experts; deepseek-v2-lite:
MLA, shared experts, a dense first layer); the expert stacks' ``run_op``
calls; the full-size parameter counts.
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
from repro.models import mla as rmla
from repro.models import moe as rmoe
from repro.models import transformer as rtf
from repro.models.sharding import DEFAULT_RULES
import repro_torch.configs as pconfigs
from repro_torch.core import AdsalaRuntime
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as pl
from repro_torch.models import mla as pmla
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as ptf

#: max |port - reference| over the largest |reference| value, as in
#: tests/test_torch_models.py: the two sum float32 products in other
#: orders; over the smoke configs that reads about 1e-6
TOL = 1e-5

MOE = ("granite_moe_3b", "deepseek_v2_lite")
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


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.long)


# ---------------------------------------------------------------------------
# slot positions and the MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,G,SK", [(3, 3, 48), (8, 2, 200), (64, 4, 768)],
                         ids=["3x48", "8x200", "64x768"])
def test_positions_in_expert_match_reference(E, G, SK):
    """Random expert ids, most repeated many times within a row."""
    ids = np.random.default_rng(E).integers(0, E, (G, SK), dtype=np.int32)
    want = np.asarray(rmoe._positions_in_expert(jnp.asarray(ids)))
    got = pmoe._positions_in_expert(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    # a slot's rank counts the earlier slots of its expert in its row
    for g in range(G):
        seen: dict = {}
        for s in range(SK):
            assert got[g, s] == seen.get(ids[g, s], 0)
            seen[ids[g, s]] = got[g, s] + 1


def _moe_pair(arch, seed=1):
    rcfg, pcfg = _cfgs(arch)
    p = rmoe.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rcfg, pcfg, p, _load(pmoe.MoE(pcfg, device="meta"),
                                jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("seq", (16, 1), ids=["prefill", "decode"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, seq):
    rcfg, pcfg, p, mod = _moe_pair(arch)
    x = _x((B, seq, rcfg.d_model), 2)
    want, want_aux = rmoe.moe_ffn(p, jnp.asarray(x), _rctx(rcfg))
    got, aux = pmoe.moe_ffn(mod, torch.from_numpy(x), pl.Ctx(pcfg))
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) < TOL
    assert abs(float(aux) - float(want_aux)) < TOL * abs(float(want_aux))
    # the module call is the serving form: the same output, no aux
    out, none = mod(torch.from_numpy(x), pl.Ctx(pcfg))
    assert none is None and torch.equal(out, got)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_drops_past_capacity_as_the_reference(arch):
    """S * K / E above 64 at the smoke width (C after rounding 192), and a
    router that sends nearly every token to expert 0 first: its slots past
    C are dropped, the output holds the other experts' shares."""
    rcfg, pcfg, p, _ = _moe_pair(arch)
    seq, d = 512, rcfg.d_model
    u = _x((d,), 3)
    w = np.array(p["router"]["w"])
    w[:, 0] = 4.0 * u / float(u @ u)            # expert 0's logit ~ 4
    p = dict(p, router={"w": jnp.asarray(w)})
    mod = _load(pmoe.MoE(pcfg, device="meta"), jax.tree.map(np.asarray, p))
    x = 0.3 * _x((B, seq, d), 4) + u
    C = pmoe.capacity(pcfg, seq)
    assert seq * pcfg.top_k / pcfg.n_experts > 64 and C == 192
    _, _, top_e = pmoe.route(mod, torch.from_numpy(x), pcfg.top_k)
    pos = pmoe._positions_in_expert(top_e.reshape(B, -1))
    assert int((pos >= C).sum()) > B * (seq - C) // 2   # most of expert 0's
    want, want_aux = rmoe.moe_ffn(p, jnp.asarray(x), _rctx(rcfg))
    got, aux = pmoe.moe_ffn(mod, torch.from_numpy(x), pl.Ctx(pcfg))
    assert _rel(got, want) < TOL
    assert abs(float(aux) - float(want_aux)) < TOL * abs(float(want_aux))


def test_capacity_follows_the_reference_formula():
    cfg = pconfigs.get_config("deepseek-v2-lite-16b")
    assert pmoe.capacity(cfg, 1) == 1            # decode: ceil(6/64) * 1.25
    assert pmoe.capacity(cfg, 128) == 64         # 15, rounded up to 64
    assert pmoe.capacity(cfg, 4096) == 512       # 384 * 1.25 = 480 -> 512


# ---------------------------------------------------------------------------
# MLA in its three forms
# ---------------------------------------------------------------------------

def _mla_pair():
    rcfg, pcfg = _cfgs("deepseek_v2_lite")
    p = rmla.init_mla(jax.random.PRNGKey(5), rcfg)
    return rcfg, pcfg, p, _load(pmla.MLA(pcfg, device="meta"),
                                jax.tree.map(np.asarray, p))


def test_mla_uncached_matches_reference():
    rcfg, pcfg, p, mod = _mla_pair()
    x = _x((B, 40, rcfg.d_model), 6)        # two q and k chunks of 32
    want, none = rmla.mla_attention(p, jnp.asarray(x), _rctx(rcfg))
    got, cache = pmla.mla_attention(mod, torch.from_numpy(x), pl.Ctx(pcfg))
    assert none is None and cache is None
    assert got.shape == want.shape and _rel(got, want) < TOL


@pytest.mark.parametrize("steps", [(12,), (12, 5), (12, 1, 1), (12, 5, 1)],
                         ids=["prefill", "prefill_offset", "decode",
                              "prefill_offset_decode"])
def test_mla_cached_matches_reference(steps):
    """Cached passes of ``steps`` tokens each, in order: a first prefill, a
    second prefill at an offset (the whole latent cache expanded, valid up
    to its length), and absorbed decode steps."""
    rcfg, pcfg, p, mod = _mla_pair()
    T = 40
    rcache = rmla.init_mla_cache(rcfg, B, T, jnp.float32)
    pcache = pmla.init_mla_cache(pcfg, B, T, torch.float32, "cpu")
    ptrs = (pcache["c_kv"].data_ptr(), pcache["k_rope"].data_ptr())
    for i, n in enumerate(steps):
        x = _x((B, n, rcfg.d_model), 7 + i)
        want, rcache = rmla.mla_attention(p, jnp.asarray(x), _rctx(rcfg),
                                          cache=rcache)
        got, pcache = pmla.mla_attention(mod, torch.from_numpy(x),
                                         pl.Ctx(pcfg), cache=pcache)
        assert got.shape == want.shape == (B, n, rcfg.d_model)
        assert _rel(got, want) < TOL
    length = sum(steps)
    assert pcache["len"] == int(rcache["len"]) == length
    assert (pcache["c_kv"].data_ptr(), pcache["k_rope"].data_ptr()) == ptrs
    for key in ("c_kv", "k_rope"):
        assert _rel(pcache[key][:, :length], rcache[key][:, :length]) < TOL
        assert not pcache[key][:, length:].any()


def test_mla_cache_overflow_raises():
    _, pcfg, _, mod = _mla_pair()
    cache = pmla.init_mla_cache(pcfg, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        pmla.mla_attention(mod, torch.zeros(1, 5, pcfg.d_model),
                           pl.Ctx(pcfg), cache=cache)


# ---------------------------------------------------------------------------
# the whole model: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def pair(request):
    """Per MoE arch: both configs, both models on the same weights, and
    the reference's routed forward (logits and aux), prefill and one
    decode step."""
    rcfg, pcfg = _cfgs(request.param)
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    model = ptf.from_reference(pcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (B, S),
                                             dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    rt = RefRuntime()
    logits, aux = rtf.forward(params, batch, rcfg, runtime=rt)
    caches = rtf.init_decode_state(rcfg, B, S + 4, dtype=jnp.float32)
    last, caches = rtf.prefill(params, batch, caches, rcfg, runtime=rt)
    nxt = np.asarray(jnp.argmax(last[:, -1:], -1).astype(jnp.int32))
    step, _ = rtf.decode_step(params, jnp.asarray(nxt), caches, rcfg,
                              runtime=rt)
    assert rt.stats.for_backend("pallas").default_calls > 0   # routed
    return {"rcfg": rcfg, "pcfg": pcfg, "model": model, "toks": toks,
            "next": nxt, "ref": {"forward": np.asarray(logits),
                                 "aux": float(aux),
                                 "prefill": np.asarray(last),
                                 "decode": np.asarray(step)}}


def test_layers_follow_the_segments(pair):
    cfg, model = pair["pcfg"], pair["model"]
    kinds = [blk.kind for blk in model.layers]
    assert kinds == [k for k, r in cfg.segments() for _ in range(r)]
    assert len(kinds) == cfg.n_layers and kinds[-1] == "moe"
    attn = pmla.MLA if cfg.use_mla else pl.Attention
    assert all(isinstance(blk.attn, attn) for blk in model.layers)


def test_forward_matches_reference_routed(pair):
    got, aux = ptf.forward(pair["model"], {"tokens": _t(pair["toks"])},
                           pair["pcfg"], runtime=AdsalaRuntime())
    assert got.shape == pair["ref"]["forward"].shape == (
        B, S, pair["pcfg"].vocab)
    assert _rel(got, pair["ref"]["forward"]) < TOL
    want = pair["ref"]["aux"]
    assert want > 0 and abs(float(aux) - want) < TOL * want


def test_prefill_and_decode_match_reference_routed(pair):
    cfg = pair["pcfg"]
    caches = ptf.init_decode_state(cfg, B, S + 4, dtype=torch.float32,
                                   device="cpu")
    last, caches = ptf.prefill(pair["model"], {"tokens": _t(pair["toks"])},
                               caches, cfg)
    assert last.shape == (B, 1, cfg.vocab)
    assert _rel(last, pair["ref"]["prefill"]) < TOL
    step, caches = ptf.decode_step(pair["model"], _t(pair["next"]), caches,
                                   cfg)
    assert step.shape == (B, 1, cfg.vocab)
    assert _rel(step, pair["ref"]["decode"]) < TOL
    assert all(c["len"] == S + 1 for c in caches)
    if cfg.use_mla:
        assert set(caches[0]) == {"c_kv", "k_rope", "len"}
        assert caches[0]["c_kv"].shape == (B, S + 4, cfg.kv_lora)


def _moe_calls(cfg) -> int:
    return sum(r for k, r in cfg.segments() if k == "moe")


@pytest.mark.parametrize("arch", MOE)
def test_expert_stacks_are_one_run_op_each_with_the_stored_weight(
        arch, monkeypatch):
    """Per MoE layer and pass: 3 ``run_op`` GEMMs with a 3-D weight, the
    expert-major stack ``(E, B * C, d)`` against the parameter itself (no
    copy); every linear's weight through ``routed_matmul`` is 2-D, so none
    takes its plain ``x @ w`` branch."""
    _, cfg = _cfgs(arch)
    model = ptf.init_params(0, cfg, device="cpu")
    stored = {getattr(blk.moe, n).data_ptr() for blk in model.layers
              if blk.kind == "moe" for n in ("wg", "wu", "wd")}
    runs, linears = [], []
    real_run, real_routed = kops.run_op, pl.routed_matmul

    def run_spy(op, operands, **kw):
        runs.append((op, tuple(operands[0].shape), tuple(operands[1].shape),
                     operands[1].data_ptr()))
        return real_run(op, operands, **kw)

    def routed_spy(x, w, ctx):
        linears.append(w.dim())
        return real_routed(x, w, ctx)

    monkeypatch.setattr(kops, "run_op", run_spy)
    monkeypatch.setattr(pl, "routed_matmul", routed_spy)
    monkeypatch.setattr(ptf, "routed_matmul", routed_spy)   # the LM head
    rt = AdsalaRuntime()
    caches = ptf.init_decode_state(cfg, B, S + 4, dtype=torch.float32,
                                   device="cpu")
    toks = torch.zeros((B, S), dtype=torch.long)
    ptf.prefill(model, {"tokens": toks}, caches, cfg, runtime=rt)
    n_prefill = len(runs)
    ptf.decode_step(model, toks[:, :1], caches, cfg, runtime=rt)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    for lo, hi, seq in ((0, n_prefill, S), (n_prefill, len(runs), 1)):
        stacks = [r for r in runs[lo:hi] if len(r[2]) == 3]
        assert len(stacks) == 3 * _moe_calls(cfg)
        rows = B * pmoe.capacity(cfg, seq)
        for i, (op, a, w, ptr) in enumerate(stacks):
            assert op == "gemm" and ptr in stored
            assert (a, w) == (((E, rows, d), (E, d, f)) if i % 3 < 2
                              else ((E, rows, f), (E, f, d)))
    assert linears and set(linears) == {2}
    assert len(runs) == len(linears) + 3 * _moe_calls(cfg) * 2
    assert rt.stats.for_backend("hopper").default_calls == len(runs)


def test_aux_is_left_out_of_the_serving_passes(monkeypatch):
    """prefill and decode_step never ask for the load-balancing loss."""
    _, cfg = _cfgs("deepseek_v2_lite")
    model = ptf.init_params(0, cfg, device="cpu")
    asked = []
    real = pmoe.moe_ffn

    def spy(p, x, ctx, *, with_aux=True):
        asked.append(with_aux)
        return real(p, x, ctx, with_aux=with_aux)

    monkeypatch.setattr(pmoe, "moe_ffn", spy)
    caches = ptf.init_decode_state(cfg, 1, 8, dtype=torch.float32,
                                   device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    ptf.prefill(model, {"tokens": toks}, caches, cfg)
    ptf.decode_step(model, toks[:, :1], caches, cfg)
    assert asked == [False] * (2 * _moe_calls(cfg))
    ptf.forward(model, {"tokens": toks}, cfg)
    assert asked[-_moe_calls(cfg):] == [True] * _moe_calls(cfg)


# ---------------------------------------------------------------------------
# full-size parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,count", [
    ("granite-moe-3b-a800m", 3_374_295_552),
    ("deepseek-v2-lite-16b", 15_706_484_224),
], ids=["granite_moe_3b", "deepseek_v2_lite"])
def test_parameter_count_equals_reference(arch, count):
    cfg = pconfigs.get_config(arch)
    model = ptf.init_params(0, cfg, device="meta")
    assert ptf.param_count(model) == count
    assert len(model.layers) == cfg.n_layers
    shapes = jax.eval_shape(lambda: rtf.init_params(
        jax.random.PRNGKey(0), rconfigs.get_config(arch)))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) \
        == count


def test_init_scales_follow_the_reference():
    cfg = dataclasses.replace(pconfigs.get_smoke_config("deepseek_v2_lite"),
                              d_model=256, moe_d_ff=384, n_experts=16)
    model = ptf.init_params(3, cfg, device="cpu")
    moe = model.layers[1].moe
    for w, std in ((moe.wg, 256 ** -0.5), (moe.wu, 256 ** -0.5),
                   (moe.wd, 384 ** -0.5), (moe.router.w, 256 ** -0.5),
                   (moe.shared.wd.w, 384 ** -0.5),
                   (model.layers[0].attn.wkv_b.w, cfg.kv_lora ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.05
    assert moe.router.w.dtype == torch.float32
    assert torch.equal(model.layers[0].attn.kv_norm.scale,
                       torch.ones(cfg.kv_lora))
