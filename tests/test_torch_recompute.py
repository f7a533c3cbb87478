"""The chunk loops' recompute (``models/layers.py::flash_attention``,
``models/mamba2.py::_ssd_chunked``, ``models/rwkv6.py::_wkv_chunked``):
under autograd each loop is one ``torch.autograd.Function`` that keeps
its inputs, its output and a little more (the flash rows' log-sum-exp,
the recurrences' state at each chunk boundary) and recomputes each
block's intermediates in its backward pass, as the reference's
``jax.checkpoint`` of its kv step and chunk steps does.

- Gradients against the reference's ``jax.grad`` on the same seeded
  numpy inputs (float32): flash attention causal and not, GQA and MQA,
  ``kv_valid_len`` with a ``q_offset``, ``causal_skip``, S and T that are
  not a multiple of the block, several kv blocks, a value head width
  other than the key's (MLA); the SSD and WKV loops at ragged lengths,
  with two groups, and in the regime where the -30 floor of the running
  log-decay bites.
- The bytes one call keeps for its backward pass
  (``torch.autograd.graph.saved_tensors_hooks``): the flash loop's are
  its inputs, output and log-sum-exp, the same at 1 and at 64 blocks; the
  recurrences' their inputs and one state a chunk.
- One train step (``loss_fn`` and ``backward``) of llama3-8b's,
  zamba2-1.2b's and rwkv6-1.6b's smoke configs under each remat mode:
  the loss and every gradient within 1e-5 of their max against autograd
  through the same loops with every intermediate kept (the port before
  the recompute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import layers as rl
from repro.models import mamba2 as rm2
from repro.models import rwkv6 as rrw
import repro_torch.configs as pconfigs
from repro_torch.models import layers as pl
from repro_torch.models import mamba2 as pm2
from repro_torch.models import rwkv6 as prw
from repro_torch.models import transformer as ptf

#: each gradient's max |port - reference| over its max |reference|
#: (float32; the cases read at most ~1e-6)
GRAD_TOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _grads(ref_fn, port_fn, inputs: dict, wrt: tuple, seed: int = 7):
    """The gradients of sum(out · r) (summed over every output) with
    respect to ``wrt``: the reference's by ``jax.grad``, the port's by
    ``backward()``, as (port, reference) lists."""
    rng = np.random.default_rng(seed)
    outs = ref_fn(**{k: jnp.asarray(v) for k, v in inputs.items()})
    outs = outs if isinstance(outs, tuple) else (outs,)
    rs = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]

    def ref_loss(*args):
        got = ref_fn(**{**{k: jnp.asarray(v) for k, v in inputs.items()},
                        **dict(zip(wrt, args))})
        got = got if isinstance(got, tuple) else (got,)
        return sum((o * r).sum() for o, r in zip(got, rs))

    want = jax.grad(ref_loss, argnums=tuple(range(len(wrt))))(
        *(jnp.asarray(inputs[k]) for k in wrt))
    ts = {k: (torch.from_numpy(v).requires_grad_(k in wrt)
              if isinstance(v, np.ndarray) else v)
          for k, v in inputs.items()}
    got = port_fn(**ts)
    got = got if isinstance(got, tuple) else (got,)
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(got, rs)).backward()
    return [ts[k].grad for k in wrt], [np.asarray(w) for w in want]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(S, T, H, KH, D, Dv, seed=1):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((2, S, H, D)).astype(np.float32),
            "k": rng.standard_normal((2, T, KH, D)).astype(np.float32),
            "v": rng.standard_normal((2, T, KH, Dv)).astype(np.float32)}


#: (S, T, H, KH, D, Dv, q_chunk, k_chunk, causal, causal_skip, q_offset,
#: kv_valid_len)
FLASH = {
    "causal_gqa_4x3_blocks": (40, 40, 4, 2, 16, 16, 16, 16, True, False, 0,
                              None),
    "causal_skip_ragged": (37, 37, 6, 2, 16, 16, 8, 8, True, True, 0, None),
    "causal_skip_8x24": (40, 48, 4, 2, 16, 16, 8, 24, True, True, 8,
                         (48, 30)),
    "offset_valid_len": (40, 48, 4, 2, 16, 16, 16, 16, True, False, 8,
                         (48, 30)),
    "non_causal_mqa_ragged": (20, 36, 4, 1, 16, 16, 8, 16, False, False, 0,
                              None),
    "mla_value_width": (33, 33, 4, 4, 24, 16, 16, 8, True, True, 0, None),
    "one_block": (12, 12, 4, 2, 8, 8, 32, 32, True, False, 0, None),
}


@pytest.mark.parametrize("case", FLASH)
def test_flash_gradients_match_reference(case):
    S, T, H, KH, D, Dv, qc, kc, causal, skip, off, valid = FLASH[case]
    kw = dict(causal=causal, q_offset=off, q_chunk=qc, k_chunk=kc,
              causal_skip=skip)
    vl = None if valid is None else np.asarray(valid)
    got, want = _grads(
        lambda **t: rl.flash_attention(
            **t, kv_valid_len=None if vl is None else jnp.asarray(vl), **kw),
        lambda **t: pl.flash_attention(
            **t, kv_valid_len=None if vl is None else torch.from_numpy(vl),
            **kw),
        _qkv(S, T, H, KH, D, Dv), ("q", "k", "v"))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= GRAD_TOL, (case, name, _rel(g, w))


def _saved_bytes(fn) -> tuple[int, object]:
    """The bytes of the tensors one call of ``fn`` saves for its backward
    pass, and its output."""
    sizes = []

    def pack(t):
        sizes.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(sizes), out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def test_flash_keeps_no_score_chain():
    """The flash loop keeps q, k, v, its output and each query row's
    log-sum-exp: the same bytes at 1 block as at 8 x 8, where keeping the
    blocks' scores (B·Cq·H·Ck floats each) would grow with them."""
    inputs = {k: torch.from_numpy(v).requires_grad_()
              for k, v in _qkv(64, 64, 4, 2, 16, 16).items()}
    q = inputs["q"]
    lse = q.shape[0] * q.shape[1] * q.shape[2] * 4     # (B, S, G, KH) f32
    saved = {}
    for chunk in (64, 32, 8):
        saved[chunk], out = _saved_bytes(lambda: pl.flash_attention(
            **inputs, causal=True, q_chunk=chunk, k_chunk=chunk))
        assert saved[chunk] <= _nbytes(*inputs.values(), out) + lse
    assert saved[64] == saved[32] == saved[8]


# ---------------------------------------------------------------------------
# the SSD and WKV chunk loops
# ---------------------------------------------------------------------------

def _ssd_inputs(S, G, dt_hi, seed=1, H=4, P=4, N=8):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((2, S, H, P)).astype(np.float32),
            "dt": (rng.random((2, S, H)) * dt_hi).astype(np.float32),
            "A": -np.exp(rng.standard_normal(H)).astype(np.float32),
            "B_in": rng.standard_normal((2, S, G, N)).astype(np.float32),
            "C_in": rng.standard_normal((2, S, G, N)).astype(np.float32),
            "h0": rng.standard_normal((2, H, P, N)).astype(np.float32)}


def _wkv_inputs(T, w_hi, seed=2, H=3, K=4):
    rng = np.random.default_rng(seed)
    out = {k: rng.standard_normal((2, T, H, K)).astype(np.float32)
           for k in ("r", "k", "v")}
    out["w_log"] = -(rng.random((2, T, H, K)) * w_hi).astype(np.float32)
    out["u"] = rng.standard_normal((H, K)).astype(np.float32)
    out["S0"] = rng.standard_normal((2, H, K, K)).astype(np.float32)
    return out


def _ssd_cfgs(chunk, G):
    kw = dict(ssm_chunk=chunk, ssm_groups=G)
    return (dataclasses.replace(rconfigs.get_smoke_config("zamba2_1p2b"),
                                **kw),
            dataclasses.replace(pconfigs.get_smoke_config("zamba2_1p2b"),
                                **kw))


#: (S, groups, max dt, chunk): the running log-decay passes -30 within a
#: chunk at dt up to 4 over 32 positions
SSD = {"ragged": (37, 1, 0.5, 8), "two_groups": (37, 2, 0.5, 8),
       "whole": (16, 2, 0.5, 8), "shorter_than_a_chunk": (5, 1, 0.5, 8),
       "clamped": (40, 1, 4.0, 32)}


@pytest.mark.parametrize("case", SSD)
def test_ssd_gradients_match_reference(case):
    S, G, dt_hi, chunk = SSD[case]
    rcfg, pcfg = _ssd_cfgs(chunk, G)
    wrt = ("x", "dt", "A", "B_in", "C_in", "h0")
    got, want = _grads(lambda **t: rm2._ssd_chunked(cfg=rcfg, **t),
                       lambda **t: pm2._ssd_chunked(cfg=pcfg, **t),
                       _ssd_inputs(S, G, dt_hi), wrt)
    for name, g, w in zip(wrt, got, want):
        assert _rel(g, w) <= GRAD_TOL, (case, name, _rel(g, w))


#: (T, max -log w, chunk): the decay passes -30 within a chunk at -log w
#: up to 3 over 32 positions
WKV = {"ragged": (37, 0.3, 8), "whole": (16, 0.3, 8),
       "shorter_than_a_chunk": (5, 0.3, 8), "clamped": (40, 3.0, 32)}


@pytest.mark.parametrize("case", WKV)
def test_wkv_gradients_match_reference(case):
    T, w_hi, chunk = WKV[case]
    wrt = ("r", "k", "v", "w_log", "u", "S0")
    got, want = _grads(lambda **t: rrw._wkv_chunked(chunk=chunk, **t),
                       lambda **t: prw._wkv_chunked(chunk=chunk, **t),
                       _wkv_inputs(T, w_hi), wrt)
    for name, g, w in zip(wrt, got, want):
        assert _rel(g, w) <= GRAD_TOL, (case, name, _rel(g, w))


@pytest.mark.parametrize("chunk", (8, 32))
def test_recurrences_keep_inputs_and_one_state_a_chunk(chunk):
    """The SSD and WKV loops keep their inputs and the state entering each
    chunk (the first is the initial state itself): at 40 positions 5 or 2
    states, nothing of (L x L) a chunk."""
    S, nc = 40, -(-40 // chunk)
    _, pcfg = _ssd_cfgs(chunk, 1)
    ts = {k: torch.from_numpy(v).requires_grad_()
          for k, v in _ssd_inputs(S, 1, 0.5).items()}
    saved, _ = _saved_bytes(lambda: pm2._ssd_chunked(cfg=pcfg, **ts))
    assert saved == _nbytes(*ts.values()) + (nc - 1) * _nbytes(ts["h0"])
    ts = {k: torch.from_numpy(v).requires_grad_()
          for k, v in _wkv_inputs(S, 0.3).items()}
    saved, _ = _saved_bytes(lambda: prw._wkv_chunked(chunk=chunk, **ts))
    assert saved == _nbytes(*ts.values()) + (nc - 1) * _nbytes(ts["S0"])


# ---------------------------------------------------------------------------
# a train step under each remat mode
# ---------------------------------------------------------------------------

def _keep_everything(monkeypatch):
    """The three loops run under plain autograd, every intermediate kept
    for the backward pass (the port before the recompute)."""
    monkeypatch.setattr(pl._FlashAttention, "apply",
                        lambda q, k, v, vl, geo:
                        pl._flash_forward(q, k, v, vl, geo)[0])
    monkeypatch.setattr(pm2._SSDChunked, "apply",
                        lambda *a: pm2._ssd_loop(*a)[:2])
    monkeypatch.setattr(prw._WKVChunked, "apply",
                        lambda *a: prw._wkv_loop(*a)[:2])


def _loss_and_grads(cfg, batch):
    model = ptf.init_params(0, cfg, device="cpu")
    model.requires_grad_(True)
    loss, _ = ptf.loss_fn(model, batch, cfg)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


#: the smoke configs at 8 layers (``nested``: 4 groups of 2), with more
#: than one block or chunk at the batch's 24 positions; zamba2 at one
#: super-block of 6 Mamba2 layers and its shared attention
TRAIN = {"llama3_8b": dict(n_layers=8, attn_q_chunk=8, attn_k_chunk=8),
         "zamba2_1p2b": dict(n_layers=6, ssm_chunk=8, attn_q_chunk=8,
                             attn_k_chunk=8),
         "rwkv6_1p6b": dict(n_layers=8, rwkv_chunk=8)}


@pytest.mark.parametrize("remat", ("none", "block", "dots", "nested"))
@pytest.mark.parametrize("arch", TRAIN)
def test_train_step_under_remat_matches_the_kept_intermediates(
        arch, remat, monkeypatch):
    cfg = dataclasses.replace(pconfigs.get_smoke_config(arch),
                              compute_dtype="float32", remat=remat,
                              **TRAIN[arch])
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
             for k in ("tokens", "labels")}
    loss, grads = _loss_and_grads(cfg, batch)
    _keep_everything(monkeypatch)
    want_loss, want = _loss_and_grads(cfg, batch)
    assert abs(float(loss - want_loss)) <= 1e-5 * abs(float(want_loss))
    assert grads.keys() == want.keys()
    for k in want:
        assert _rel(grads[k], want[k]) <= 1e-5, (k, _rel(grads[k], want[k]))
