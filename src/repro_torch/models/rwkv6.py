"""RWKV6 "Finch": attention-free token mixing with data-dependent decay (the
reference package's ``models/rwkv6.py``).

Time-mix recurrence (per head, K = V = head_dim):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t          S: (K, V)
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

with a per-channel, per-token decay w_t = exp(−exp(w0 + lora(x_t))) and
data-dependent token-shift lerps.  Computed in chunks: within a chunk the
recurrence is a decay-weighted (L × L) score matmul through the
exp-difference factorisation

    exp(cum_{t−1} − cum_s) = (r_t ⊙ e^{cum_{t−1}}) · (k_s ⊙ e^{−cum_s})

with ``cum`` clamped at −30 at the source position (``k_sc``, ``k_end``),
as the reference clamps it: once a chunk's cumulative decay passes −30,
late tokens' contributions and what they add to the carried state shrink
by ``exp(cum_s + 30)``.  A Python loop over the chunks carries the
(B, H, K, V) state (the reference's ``lax.scan``); decode is the one-token
recurrence.

The routed linears are ``wr``, ``wk``, ``wv``, ``wg``, ``wo`` and the
channel mix's ``cm_wk``, ``cm_wv``, ``cm_wr``.  The LoRA products stay
plain matmuls, as the reference keeps them outside ``routed_matmul``.  A
state passed in is written in place.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import (Ctx, Linear, Norm, _param, flat_safe, linear, rmsnorm,
                     torch_dtype)
from .mamba2 import _floor_grad, _reverse_cumsum

__all__ = ["RWKV6", "rwkv6_block", "init_rwkv6_state"]

#: the floor of a chunk's running log-decay at a source position (taken
#: with ``torch.maximum``, whose gradient at a tie is split in half as
#: ``jnp.maximum``'s is; ``clamp_min`` would pass all of it)
CUM_FLOOR = -30.0


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    K = cfg.rwkv_head_dim
    return cfg.d_model // K, K


class RWKV6(nn.Module):
    """One RWKV6 layer (block kind ``"rwkv6"``), its parameters under the
    reference's names: the pre-norms ``ln1``, ``ln2``; the time mix's lerps
    ``mu_x`` ``(d,)`` and ``mu`` ``(5, d)`` (0.5), their LoRA ``lora_A``
    ``(d, 5·L)`` and ``lora_B`` ``(5, L, d)``, the decay ``w0`` (−1) and its
    LoRA ``w_lora_A``, ``w_lora_B`` (all LoRA weights ~ N(0, 0.01)), the
    projections ``wr``, ``wk``, ``wv``, ``wg``, ``wo``, the bonus ``u``
    ``(H, K)`` ~ N(0, 0.1) and the per-head norm ``ln_scale``, ``ln_bias``;
    the channel mix's lerps ``cm_mu_k``, ``cm_mu_r`` and ``cm_wk``, ``cm_wv``,
    ``cm_wr``."""

    kind = "rwkv6"

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        d, f, L = cfg.d_model, cfg.d_ff, cfg.rwkv_lora
        H, K = _heads(cfg)
        dtype = torch_dtype(cfg.param_dtype)
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.ln1 = Norm(d, dtype=dtype, device=device)
        self.ln2 = Norm(d, dtype=dtype, device=device)
        self.mu_x = _param((d,), fill=0.5, **kw)
        self.mu = _param((5, d), fill=0.5, **kw)
        self.lora_A = _param((d, 5 * L), std=0.01, **kw)
        self.lora_B = _param((5, L, d), std=0.01, **kw)
        self.w0 = _param((d,), fill=-1.0, **kw)
        self.w_lora_A = _param((d, L), std=0.01, **kw)
        self.w_lora_B = _param((L, d), std=0.01, **kw)
        self.wr = Linear(d, d, **kw)
        self.wk = Linear(d, d, **kw)
        self.wv = Linear(d, d, **kw)
        self.wg = Linear(d, d, **kw)
        self.u = _param((H, K), std=0.1, **kw)
        self.ln_scale = _param((H, K), fill=1.0, **kw)
        self.ln_bias = _param((H, K), **kw)
        self.wo = Linear(d, d, **kw)
        self.cm_mu_k = _param((d,), fill=0.5, **kw)
        self.cm_mu_r = _param((d,), fill=0.5, **kw)
        self.cm_wk = Linear(d, f, **kw)
        self.cm_wv = Linear(f, d, **kw)
        self.cm_wr = Linear(d, d, **kw)

    def forward(self, x: torch.Tensor, ctx: Ctx,
                cache: dict | None = None) -> torch.Tensor:
        return rwkv6_block(self, x, ctx, state=cache)[0]


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """``{tm_prev, cm_prev: (batch, d) in dtype, S: (batch, H, K, K)
    float32}`` zeroed on ``device``."""
    H, K = _heads(cfg)
    return {"tm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device),
            "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device),
            "S": torch.zeros((batch, H, K, K), dtype=torch.float32,
                             device=device)}


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} along the sequence; position 0 takes ``prev`` (the decode
    carry), or zeros without one."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _shifted(ctx: Ctx, x: torch.Tensor,
             prev: torch.Tensor | None) -> torch.Tensor:
    """:func:`_shift` batch-local on whole rows under a mesh."""
    rows = ("batch", None, None)
    return ctx.local(_shift, [x, prev],
                     [rows, None if prev is None else ("batch", None)], rows)


def _wkv_chunked(r, k, v, w_log, u, chunk: int, S0):
    """r, k, v: (B, T, H, K); w_log: (B, T, H, K) = log w ≤ 0; u: (H, K);
    S0: (B, H, K, K) float32 → (y (B, T, H, K) float32, S_final).

    Under autograd the loop is one :class:`_WKVChunked`: it keeps the
    inputs and the state entering each chunk, and its backward reruns each
    chunk step from its state (the reference's scan of a
    ``jax.checkpoint``-ed chunk step)."""
    args = (r, k, v, w_log, u, S0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _WKVChunked.apply(*args, chunk)
    return _wkv_loop(*args, chunk)[:2]


def _wkv_chunk(t: torch.Tensor, c: int, L: int) -> torch.Tensor:
    """Chunk ``c`` of ``t`` (B, T, H, K) in float32, padded to ``L``."""
    tc = t[:, c * L:(c + 1) * L].float()
    pad = L - tc.shape[1]
    return F.pad(tc, (0, 0, 0, 0, 0, pad)) if pad else tc


def _wkv_step(S, rc, kc, vc, lw, u, mask_strict):
    """One chunk of the WKV recurrence from the state ``S``: (y (B, L, H,
    K), the state after the chunk)."""
    cum = torch.cumsum(lw, dim=1)                            # ≤ 0
    cum_cl = torch.maximum(cum, cum.new_full((), CUM_FLOOR))
    cum_prev = F.pad(cum, (0, 0, 0, 0, 1, 0))[:, :-1]        # exclusive
    r_sc = rc * torch.exp(cum_prev)                          # ≤ rc
    k_sc = kc * torch.exp(-cum_cl)                           # ≤ e^30 kc
    scores = torch.einsum("blhk,bshk->bhls", r_sc, k_sc)
    scores = torch.where(mask_strict[None, None], scores, 0.0)
    y = torch.einsum("bhls,bshk->blhk", scores, vc)
    # the current token's bonus
    bonus = torch.einsum("blhk,blhk->blh", rc, u[None, None] * kc)
    y = y + bonus[..., None] * vc
    # the carried state
    y = y + torch.einsum("blhk,bhkv->blhv", r_sc, S)
    k_end = kc * torch.exp(cum[:, -1:] - cum_cl)
    S = S * torch.exp(cum[:, -1])[..., None] + \
        torch.einsum("bshk,bshv->bhkv", k_end, vc)
    return y, S


def _strict_lower(L: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device), -1)


def _wkv_loop(r, k, v, w_log, u, S0, chunk: int):
    """The chunk loop: (y (B, T, H, K) float32, the final state, the state
    entering each chunk)."""
    T = r.shape[1]
    L = min(chunk, T)
    mask_strict = _strict_lower(L, r.device)
    S, ys, carries = S0, [], []
    for c in range(-(-T // L)):
        carries.append(S)
        y, S = _wkv_step(S, *(_wkv_chunk(t, c, L) for t in (r, k, v, w_log)),
                         u, mask_strict)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], S, carries


def _wkv_step_grads(S, rc, kc, vc, lw, u, mask_strict, gy, gS):
    """The cotangents of :func:`_wkv_step`'s ``(S, rc, kc, vc, lw, u)``
    from those of its outputs, ``gy`` (B, L, H, K) and ``gS`` (B, H, K,
    K), by hand: the scores and the bonus recomputed (two products), then
    the eight products of their vjp and the elementwise chain back to
    ``lw``, as the reference's ``jax.checkpoint``-ed chunk step computes
    them."""
    cum = torch.cumsum(lw, dim=1)
    cum_cl = torch.maximum(cum, cum.new_full((), CUM_FLOOR))
    e_prev = torch.exp(F.pad(cum, (0, 0, 0, 0, 1, 0))[:, :-1])
    r_sc = rc * e_prev
    e_neg = torch.exp(-cum_cl)
    k_sc = kc * e_neg
    m = mask_strict[None, None]
    scores = torch.where(m, torch.einsum("blhk,bshk->bhls", r_sc, k_sc), 0.0)
    uk = u[None, None] * kc
    bonus = torch.einsum("blhk,blhk->blh", rc, uk)
    end = torch.exp(cum[:, -1])                              # (B, H, K)
    e_end = torch.exp(cum[:, -1:] - cum_cl)
    k_end = kc * e_end
    # y = scores·v + bonus·v + r_sc·S
    g_sc = torch.where(m, torch.einsum("blhk,bshk->bhls", gy, vc), 0.0)
    g_v = torch.einsum("bhls,blhk->bshk", scores, gy) + bonus[..., None] * gy
    g_bonus = (gy * vc).sum(-1)
    g_rsc = torch.einsum("blhv,bhkv->blhk", gy, S) + \
        torch.einsum("bhls,bshk->blhk", g_sc, k_sc)
    g_ksc = torch.einsum("bhls,blhk->bshk", g_sc, r_sc)
    g_S = torch.einsum("blhk,blhv->bhkv", r_sc, gy) + gS * end[..., None]
    # S' = S·e^cum_end + k_endᵀ·v
    g_kend = torch.einsum("bhkv,bshv->bshk", gS, vc)
    g_v = g_v + torch.einsum("bshk,bhkv->bshv", k_end, gS)
    g_uk = g_bonus[..., None] * rc
    g_r = g_bonus[..., None] * uk + g_rsc * e_prev
    g_k = g_ksc * e_neg + g_kend * e_end + g_uk * u[None, None]
    # the exponents: cum_prev, -cum_cl, cum_end - cum_cl
    g_cl = -g_ksc * k_sc - g_kend * k_end
    g_end = (g_kend * k_end).sum(1) + (gS * S).sum(-1) * end
    g_cum = _floor_grad(cum, g_cl) + F.pad((g_rsc * r_sc)[:, 1:],
                                           (0, 0, 0, 0, 0, 1))
    g_cum = torch.cat([g_cum[:, :-1], (g_cum[:, -1] + g_end)[:, None]], 1)
    return (g_S, g_r, g_k, g_v, _reverse_cumsum(g_cum, 1),
            (g_uk * kc).sum((0, 1)))


class _WKVChunked(torch.autograd.Function):
    """:func:`_wkv_chunked` under autograd: the forward is
    :func:`_wkv_loop`, keeping the inputs and the state entering each
    chunk; the backward goes through the chunks in reverse and takes each
    chunk's cotangents from its state with :func:`_wkv_step_grads`."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, S0, chunk):
        y, S, carries = _wkv_loop(r, k, v, w_log, u, S0, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, w_log, u, *carries)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        r, k, v, w_log, u, *carries = ctx.saved_tensors
        L = min(ctx.chunk, r.shape[1])
        mask_strict = _strict_lower(L, r.device)
        dy, uf = dy.float(), u.float()
        du = torch.zeros_like(uf)
        # each chunk's cotangents written into its rows
        grads = [torch.empty(t.shape, dtype=torch.float32, device=t.device)
                 for t in (r, k, v, w_log)]
        for c in reversed(range(len(carries))):
            sl = slice(c * L, (c + 1) * L)
            gy = dy[:, sl]
            n = gy.shape[1]
            if n < L:
                gy = F.pad(gy, (0, 0, 0, 0, 0, L - n))
            dS, *chunk_grads, g_u = _wkv_step_grads(
                carries[c], *(_wkv_chunk(t, c, L) for t in (r, k, v, w_log)),
                uf, mask_strict, gy, dS)
            for out, g in zip(grads, chunk_grads):
                out[:, sl] = g[:, :n]
            du = du + g_u
        dr, dk, dv, dw = (g.to(t.dtype)
                          for g, t in zip(grads, (r, k, v, w_log)))
        return dr, dk, dv, dw, du.to(u.dtype), dS, None


def _wkv(r, k, v, w_log, u, S0=None, *, chunk: int, decode: bool):
    """The WKV recurrence on one shard: ``(y (B, S, H, K) float32,
    S_new)``, the one-token step when ``decode``, else the chunked scan
    from ``S0`` (zero without one)."""
    if decode:
        rt, kt, vt = (t[:, 0].float() for t in (r, k, v))
        y = torch.einsum("bhk,bhkv->bhv", rt, S0) + \
            torch.einsum("bhk,bhk,bhv->bhv", rt, u[None] * kt, vt)
        S_new = S0 * torch.exp(w_log[:, 0])[..., None] + \
            torch.einsum("bhk,bhv->bhkv", kt, vt)
        return y[:, None], S_new                             # (B, 1, H, K)
    if S0 is None:
        B, _, H, K = r.shape
        S0 = r.new_zeros((B, H, K, K), dtype=torch.float32)
    return _wkv_chunked(r, k, v, w_log, u, chunk, S0)


def rwkv6_block(p: RWKV6, x: torch.Tensor, ctx: Ctx, *,
                state: dict | None = None):
    """The whole RWKV6 layer (time mix, then channel mix), pre-norm
    residual.  x: (B, S, D) → (y, state).  With ``state`` (serving) its
    ``tm_prev``, ``cm_prev`` (the normed last rows) and ``S`` are read and
    written in place: S == 1 runs the one-token recurrence."""
    cfg = ctx.cfg
    B, S, D = x.shape
    H, K = _heads(cfg)

    x_res = x
    x = rmsnorm(p.ln1, x)

    # ---------------- time mix ----------------
    dx = _shifted(ctx, x, None if state is None else state["tm_prev"]) - x
    xx = x + dx * ctx.cast(p.mu_x)
    lora = torch.tanh(flat_safe(lambda t: t @ ctx.cast(p.lora_A), xx, ctx)
                      ).reshape(B, S, 5, -1)
    dd = flat_safe(lambda t: torch.einsum("bsfl,fld->bsfd", t,
                                          ctx.cast(p.lora_B)), lora, ctx)
    mixed = x[:, :, None] + dx[:, :, None] * (ctx.cast(p.mu)[None, None]
                                              + dd)           # (B, S, 5, D)
    xr, xk, xv, xg, xw = mixed.unbind(2)

    r = linear(p.wr, xr, ctx).reshape(B, S, H, K)
    k = linear(p.wk, xk, ctx).reshape(B, S, H, K)
    v = linear(p.wv, xv, ctx).reshape(B, S, H, K)
    g = linear(p.wg, xg, ctx)
    w_lora = flat_safe(lambda t: torch.tanh(t @ ctx.cast(p.w_lora_A))
                       @ ctx.cast(p.w_lora_B), xw, ctx)
    w_log = -torch.exp(p.w0.float() + w_lora.float())
    w_log = w_log.reshape(B, S, H, K)

    # the head-parallel region (the reference's r, k, v and S layouts)
    hn, sn = ("batch", None, "heads", None), ("batch", "heads", None, None)
    args, names = [r, k, v, w_log, p.u.float()], [hn, hn, hn, hn,
                                                  ("heads", None)]
    if state is not None:
        args.append(state["S"])
        names.append(sn)
    y, S_new = ctx.local(
        functools.partial(_wkv, chunk=cfg.rwkv_chunk,
                          decode=state is not None and S == 1),
        args, names, (hn, sn))

    # per-head group norm (the population variance, as jnp.var), gate, out
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, correction=0)[..., None]
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y * p.ln_scale.float()[None, None] + p.ln_bias.float()[None, None]
    y = y.reshape(B, S, D).to(x.dtype) * F.silu(g)
    h_res = x_res + linear(p.wo, y, ctx, out_logical="embed")
    h = rmsnorm(p.ln2, h_res)

    # ---------------- channel mix ----------------
    dh = _shifted(ctx, h, None if state is None else state["cm_prev"]) - h
    hk = h + dh * ctx.cast(p.cm_mu_k)
    hr = h + dh * ctx.cast(p.cm_mu_r)
    kk = torch.square(F.relu(linear(p.cm_wk, hk, ctx, out_logical="mlp")))
    out = h_res + torch.sigmoid(linear(p.cm_wr, hr, ctx)) * \
        linear(p.cm_wv, kk, ctx, out_logical="embed")

    if state is not None:
        state["tm_prev"].copy_(x[:, -1])
        state["cm_prev"].copy_(h[:, -1])
        state["S"].copy_(S_new)
    return out, state
