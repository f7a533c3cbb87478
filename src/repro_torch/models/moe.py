"""Mixture-of-Experts FFN with sort-based capacity dispatch (the reference
package's ``models/moe.py``).

Tokens are routed by a stable sort over expert ids; a slot's position in
its expert comes from segment arithmetic on the sorted ids, and dispatch
and combine are a scatter-add and a gather (data movement, no FLOPs).
Capacity is fixed, ``C = ceil(S * top_k / E) * capacity_factor`` rounded up
to 64 when ``S > 1``, and the slots past it are dropped.

When the config routes its GEMMs, each of the three expert matmuls is one
``run_op`` GEMM over an expert-major stack ``(E, B * C, d)`` against the
stored ``(E, d, f)`` weight: per item its own B, read as stored.  The
router stays a plain float32 ``torch.matmul``, as the reference keeps it
outside ``run_op``.

Nothing here makes the host wait on the card: no ``.item()``, no
``.nonzero()``, no boolean-mask indexing.  The router's load-balancing
loss is computed only when asked for (``forward``); ``prefill`` and
``decode_step`` drop it, as the reference's do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

from .layers import MLP, Ctx, Linear, _param, mlp, torch_dtype

__all__ = ["MoE", "moe_ffn", "route", "capacity"]


class MoE(nn.Module):
    """The router ``(d, E)`` in float32, the expert weights ``wg``, ``wu``
    ``(E, d, f)`` and ``wd`` ``(E, f, d)`` at the reference's scales
    (``1/sqrt(d)``, ``1/sqrt(f)``), and the shared experts, one SwiGLU MLP of
    width ``n_shared_experts * f``, where the config has them."""

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
        dtype = torch_dtype(cfg.param_dtype)
        kw = dict(device=device, gen=gen)
        self.router = Linear(d, e, dtype=torch.float32, **kw)
        self.wg = _param((e, d, f), dtype=dtype, std=1.0 / math.sqrt(d), **kw)
        self.wu = _param((e, d, f), dtype=dtype, std=1.0 / math.sqrt(d), **kw)
        self.wd = _param((e, f, d), dtype=dtype, std=1.0 / math.sqrt(f), **kw)
        self.shared = (MLP(d, cfg.n_shared_experts * f, mlp_type="swiglu",
                           dtype=dtype, **kw)
                       if cfg.n_shared_experts else None)

    def forward(self, x: torch.Tensor, ctx: Ctx, *, with_aux: bool = False):
        """:func:`moe_ffn` over this module, the load-balancing loss left
        out unless asked for (a module call, so hooks see the input)."""
        return moe_ffn(self, x, ctx, with_aux=with_aux)


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert and sequence for ``S`` tokens (the reference's
    integer formula, rounded up to 64 when ``S > 1``)."""
    C = max(1, int(-(-S * cfg.top_k // cfg.n_experts) * cfg.capacity_factor))
    if S > 1:
        C = -(-C // 64) * 64
    return C


def route(p: MoE, x: torch.Tensor, k: int):
    """The router in float32: ``(probs (B, S, E), top_p, top_e (B, S, k))``,
    ``top_p`` renormalised over the ``k`` chosen experts."""
    probs = torch.softmax(x.float() @ p.router.w, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def _expert_matmul(t: torch.Tensor, w: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``einsum("becd,edf->becf", t, w)``; routed, the ``(B, E, C, d)`` slab
    folds into an expert-major stack ``(E, B * C, d)`` and runs as one
    ``run_op`` GEMM against the 3-D weight, one knob for all experts."""
    if not ctx.routes_gemm(t):
        return torch.einsum("becd,edf->becf", t, w)
    B, E, C, D = t.shape
    t3 = t.transpose(0, 1).reshape(E, B * C, D)
    y = kops.run_op("gemm", (t3, w), backend=ctx.cfg.gemm_backend,
                    runtime=ctx.runtime, device=t3.device)
    return y.reshape(E, B, C, -1).transpose(0, 1)


def _positions_in_expert(e_flat: torch.Tensor) -> torch.Tensor:
    """Each slot's rank within its expert, slots taken in a stable sort by
    expert id.  e_flat: (G, S*K) int → (G, S*K) int64."""
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.take_along_dim(e_flat, order, dim=-1)
    idx = torch.arange(se.shape[-1], device=se.device).expand_as(se)
    boundary = torch.cat([torch.ones_like(se[:, :1], dtype=torch.bool),
                          se[:, 1:] != se[:, :-1]], dim=-1)
    seg_start = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
    # back through the inverse permutation of the sort
    return torch.empty_like(idx).scatter_(-1, order, idx - seg_start)


def moe_ffn(p: MoE, x: torch.Tensor, ctx: Ctx, *, with_aux: bool = True):
    """x: (B, S, D) → (out (B, S, D), aux), ``aux`` the Switch-style
    load-balancing loss ``E * sum_e f_e * mean p_e`` (None unless
    ``with_aux``)."""
    cfg = ctx.cfg
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)

    # routing (f32)
    probs, top_p, top_e = route(p, x, K)
    aux = None
    if with_aux:
        density = F.one_hot(top_e[..., 0], E).float().mean((0, 1))
        aux = E * torch.sum(density * probs.mean((0, 1)))

    # slot bookkeeping: a dropped slot goes to the pad row E * C
    e_flat = top_e.reshape(B, S * K)
    w_flat = top_p.reshape(B, S * K)
    pos = _positions_in_expert(e_flat)
    keep = pos < C
    dest = torch.where(keep, e_flat * C + pos, E * C)

    # dispatch: token s to its K slots (repeat_interleave along S, as a
    # view), scatter-added into the capacity buffer
    x_slots = x[:, :, None, :].expand(B, S, K, D).reshape(B, S * K, D)
    buf = x.new_zeros((B, E * C + 1, D))
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf.index_put_((bidx, dest), x_slots * keep[..., None].to(x.dtype),
                   accumulate=True)
    buf = buf[:, :E * C].reshape(B, E, C, D)

    # the experts
    wg, wu, wd = ctx.cast(p.wg), ctx.cast(p.wu), ctx.cast(p.wd)
    h = F.silu(_expert_matmul(buf, wg, ctx)) * _expert_matmul(buf, wu, ctx)
    y = _expert_matmul(h, wd, ctx)

    # combine: gather each slot's row (the pad row is zero), weight, sum
    y = torch.cat([y.reshape(B, E * C, D), y.new_zeros((B, 1, D))], dim=1)
    gathered = torch.take_along_dim(y, dest[..., None], dim=1)
    gathered = gathered * (w_flat * keep)[..., None].to(y.dtype)
    out = gathered.reshape(B, S, K, D).sum(dim=2)

    if p.shared is not None:
        out = out + mlp(p.shared, x, ctx)
    return out, aux
