"""Mamba2 (SSD) mixer in its chunked state-space dual form (the reference
package's ``models/mamba2.py``).

Sequence mixing is the scalar-decay SSD recurrence

    h_t = exp(dt_t·A) · h_{t-1} + dt_t · B_t ⊗ x_t        h: (H, P, N)
    y_t = C_t · h_t + D ⊙ x_t

computed in chunks of ``cfg.ssm_chunk``: within a chunk the recurrence is a
masked (L × L) decay-weighted matmul, and a Python loop over the chunks
carries the (B, H, P, N) state (the reference's ``lax.scan``).  Decode is
the recurrence applied to one token: O(1) state a layer.

The chunk keeps the reference's clamp of the running log-decay at −30,
applied to the source position only (``decay``, ``decay_to_end``): once a
chunk's cumulative decay passes −30, a pair's decay is ``exp(cum_t + 30)``
and not ``exp(cum_t − cum_s)``, which drops most of what late tokens add.
The port is held to the reference, so it keeps that trait.

The routed linears are ``in_proj`` and ``out_proj``; the convolution, the
scan and the decode recurrence stay plain PyTorch, as the reference keeps
them outside its Pallas GEMM.  A state passed in is written in place.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import (Ctx, Linear, Norm, _model_rank, _param, linear, rmsnorm,
                     torch_dtype)

__all__ = ["Mamba2", "mamba2_mixer", "init_mamba2_state"]

#: the floor of a chunk's running log-decay at a source position (taken
#: with ``torch.maximum``, whose gradient at a tie is split in half as
#: ``jnp.maximum``'s is; ``clamp_min`` would pass all of it)
CUM_FLOOR = -30.0


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


class Mamba2(nn.Module):
    """``in_proj`` ``(d, 2·d_inner + 2·G·N + H)``, the depthwise causal
    convolution ``conv_w`` ``(W, conv_dim)`` ~ N(0, 0.1) and ``conv_b``, the
    per-head ``A_log`` (0), ``D`` (1) and ``dt_bias`` (0), the gated
    ``norm`` over ``d_inner`` and ``out_proj`` ``(d_inner, d)``."""

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        d_inner, n_heads, conv_dim = _dims(cfg)
        dtype = torch_dtype(cfg.param_dtype)
        kw = dict(dtype=dtype, device=device, gen=gen)
        proj_out = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + n_heads
        self.in_proj = Linear(cfg.d_model, proj_out, **kw)
        self.conv_w = _param((cfg.conv_width, conv_dim), std=0.1, **kw)
        self.conv_b = _param((conv_dim,), **kw)
        self.A_log = _param((n_heads,), **kw)
        self.D = _param((n_heads,), fill=1.0, **kw)
        self.dt_bias = _param((n_heads,), **kw)
        self.norm = Norm(d_inner, dtype=dtype, device=device)
        self.out_proj = Linear(d_inner, cfg.d_model, **kw)


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """``{ssm: (batch, H, P, N) float32, conv: (batch, W - 1, conv_dim)}``
    zeroed on ``device``, the convolution's history in ``dtype``."""
    _, n_heads, conv_dim = _dims(cfg)
    return {"ssm": torch.zeros((batch, n_heads, cfg.ssm_headdim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                                dtype=dtype, device=device)}


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of width W over the sequence axis of
    ``xBC`` (B, S, C), as shifted adds."""
    W = w.shape[0]
    out = xBC * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[W - 1 - i]
    return out + b


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, _, _ = _dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: 2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, xBC, dt


def _ssd_chunked(x, dt, A, B_in, C_in, cfg: ModelConfig, h0,
                 heads: slice | None = None):
    """x: (B, S, H, P), dt: (B, S, H), A: (H,), B_in/C_in: (B, S, G, N),
    h0: (B, H, P, N) float32 → (y (B, S, H, P) float32, h_final).  On a
    shard the H heads are the model's ``heads``, whose B and C are taken
    from the groups' (None: the H heads are all of them)."""
    Bsz, S, H, P = x.shape
    L = min(cfg.ssm_chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_in = F.pad(B_in, (0, 0, 0, 0, 0, pad))
        C_in = F.pad(C_in, (0, 0, 0, 0, 0, pad))
    Bh, Ch = (_head_rows(t, cfg, heads, H, dim=2).float()    # (B, S, H, N)
              for t in (B_in, C_in))
    x, dt = x.float(), dt.float()
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    h, ys = h0, []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bh[:, sl], Ch[:, sl]
        cum = torch.cumsum(dtc * A, dim=1)                   # (B, L, H) ≤ 0
        cum_cl = torch.maximum(cum, cum.new_full((), CUM_FLOOR))
        # intra-chunk: scores[t,s] = (C_t·B_s)·exp(cum_t−cum_s)·dt_s, s ≤ t
        cb = torch.einsum("blhn,bshn->blsh", Cc, Bc)
        decay = torch.exp(cum[:, :, None, :] - cum_cl[:, None, :, :])
        scores = torch.where(mask[None, :, :, None], cb * decay, 0.0)
        scores = scores * dtc[:, None, :, :]
        y_intra = torch.einsum("blsh,bshp->blhp", scores, xc)
        # inter-chunk: what the carried state contributes
        y_inter = torch.einsum("blhn,bhpn->blhp",
                               Cc * torch.exp(cum)[..., None], h)
        decay_to_end = torch.exp(cum[:, -1:, :] - cum_cl)    # (B, L, H)
        dBx = torch.einsum("blh,blhn,blhp->bhpn", dtc * decay_to_end, Bc, xc)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + dBx
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def _head_rows(t: torch.Tensor, cfg: ModelConfig, heads: slice | None,
               H: int, dim: int) -> torch.Tensor:
    """The groups' rows of ``t`` (``G`` on ``dim``) repeated to each of the
    ``H`` heads, or to the model's heads cut to ``heads``."""
    if heads is None:
        return t.repeat_interleave(H // cfg.ssm_groups, dim=dim)
    rep = _dims(cfg)[1] // cfg.ssm_groups
    return t.repeat_interleave(rep, dim=dim).narrow(dim, heads.start,
                                                    heads.stop - heads.start)


def mamba2_mixer(p: Mamba2, x: torch.Tensor, ctx: Ctx, *,
                 state: dict | None = None):
    """x: (B, S, D) → (y (B, S, D), state).  With ``state`` (serving) its
    ``ssm`` and ``conv`` are read and written in place: S == 1 runs the
    one-token recurrence, a longer S the chunked scan from the carried
    state.  Under a mesh the scan runs in the head-parallel region
    (:meth:`Ctx.local`)."""
    cfg = ctx.cfg
    Bsz, S, _ = x.shape
    d_inner, n_heads, _ = _dims(cfg)
    N, G, P = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_headdim

    z, xBC, dt = _split(cfg, linear(p.in_proj, x, ctx,
                                    out_logical="ssm_inner"))
    w, b = ctx.cast(p.conv_w), ctx.cast(p.conv_b)
    # the convolution shifts along the sequence: batch-local, whole rows
    rows = ("batch", None, None)
    if state is None:
        xBC = ctx.local(_causal_conv, [xBC, w, b],
                        [rows, (None, None), (None,)], rows)
    else:
        hist = torch.cat([state["conv"].to(xBC.dtype), xBC], dim=1)
        xBC = ctx.local(_causal_conv, [hist, w, b],
                        [rows, (None, None), (None,)], rows)[:, -S:]
        state["conv"].copy_(hist[:, -(cfg.conv_width - 1):])
    xBC = F.silu(xBC)

    x_ssm = xBC[..., :d_inner].reshape(Bsz, S, n_heads, P)
    B_in = xBC[..., d_inner: d_inner + G * N].reshape(Bsz, S, G, N)
    C_in = xBC[..., d_inner + G * N:].reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + p.dt_bias.float())          # (B, S, H)
    A = -torch.exp(p.A_log.float())                          # (H,) < 0

    # the head-parallel region (the reference's x, Bh, Ch and h layouts)
    xn, hn = ("batch", None, "heads", None), ("batch", "heads", None, None)
    gn = ("batch", None, None, None)
    args = [x_ssm, dt, A, B_in, C_in]
    names = [xn, ("batch", None, "heads"), ("heads",), gn, gn]
    if state is not None:
        args.append(state["ssm"])
        names.append(hn)
    y, h = ctx.local(
        functools.partial(_scan, cfg=cfg, decode=state is not None and S == 1,
                          model_rank=_model_rank(ctx)),
        args, names, (xn, hn))
    if state is not None:
        state["ssm"].copy_(h)

    y = y + p.D.float()[None, None, :, None] * x_ssm.float()
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    return linear(p.out_proj, y, ctx, out_logical="embed"), state


def _scan(x_ssm, dt, A, B_in, C_in, h0=None, *, cfg: ModelConfig,
          decode: bool, model_rank: int):
    """The SSD scan on one shard: ``(y (B, S, H, P) float32, h)``, the
    one-token recurrence when ``decode``, else the chunked scan from
    ``h0`` (zero without one).  The shard's H heads are the
    ``model_rank``-th block of the model's."""
    Bsz, S, H, P = x_ssm.shape
    n_heads = _dims(cfg)[1]
    heads = (None if H == n_heads
             else slice(model_rank * H, (model_rank + 1) * H))
    if decode:
        # the one-token recurrence, no chunk machinery
        dA = torch.exp(dt[:, 0] * A)                         # (B, H)
        Bh, Ch = (_head_rows(t[:, 0], cfg, heads, H, dim=1).float()
                  for t in (B_in, C_in))
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dt[:, 0], Bh,
                           x_ssm[:, 0].float())
        h = h0 * dA[:, :, None, None] + dBx
        return torch.einsum("bhn,bhpn->bhp", Ch, h)[:, None], h
    if h0 is None:
        h0 = x_ssm.new_zeros((Bsz, H, P, cfg.ssm_state), dtype=torch.float32)
    return _ssd_chunked(x_ssm, dt, A, B_in, C_in, cfg, h0, heads)
