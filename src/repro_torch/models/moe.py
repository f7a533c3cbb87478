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

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

from .layers import MLP, Ctx, Linear, _param, flat_safe, mlp, torch_dtype

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
    return _top_k(x.float() @ p.router.w, k)


def _top_k(logits: torch.Tensor, k: int):
    probs = torch.softmax(logits, dim=-1)
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


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor, *, ctx: Ctx) -> torch.Tensor:
    """The SwiGLU experts on the capacity slab ``buf`` (B, E, C, d): on
    each rank's experts (or capacity slots) under a mesh, its FSDP
    shards of the weights gathered."""
    h = F.silu(_expert_matmul(buf, wg, ctx)) * _expert_matmul(buf, wu, ctx)
    return _expert_matmul(h, wd, ctx)


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
    ``with_aux``).

    Under a mesh the routing, dispatch and combine run batch-local
    (:meth:`Ctx.local`: each rank its batch rows, the whole sequence),
    and the expert FFN in an expert-parallel region: EP when the experts
    divide the model axis, else slot-parallel over the capacity dim
    (``expert_cap``), the weights' FSDP shards gathered."""
    cfg = ctx.cfg
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)

    # routing (f32), then the slot bookkeeping and the dispatch, batch-local
    # (the reference's x_slots, dest and buf layouts)
    logits = flat_safe(lambda t: t.float() @ p.router.w, x, ctx)
    buf, dest, wk, probs, top1 = ctx.local(
        functools.partial(_dispatch, E=E, K=K, C=C, with_aux=with_aux),
        [x, logits], [("batch", None, "embed"), ("batch", None, None)],
        (("batch", None, None), ("batch", None), ("batch", None),
         ("batch", None, None), ("batch", None, None)))
    aux = None
    if with_aux:
        aux = E * torch.sum(top1.mean((0, 1)) * probs.mean((0, 1)))

    # the experts: EP over 'model' when the experts divide it, otherwise
    # slot-parallel over the capacity dim with replicated expert weights
    slab = ("batch", "experts", "expert_cap", None)
    wn = ("experts", None, None)
    y = ctx.local(functools.partial(_experts, ctx=ctx),
                  [buf.reshape(B, E, C, D), ctx.cast(p.wg), ctx.cast(p.wu),
                   ctx.cast(p.wd)], [slab, wn, wn, wn], slab)

    # combine, batch-local
    out = ctx.local(functools.partial(_combine, K=K), [y, dest, wk],
                    [("batch", None, None, None), ("batch", None),
                     ("batch", None)], ("batch", None, None))
    out = ctx.cons(out, "batch", "seq", "embed")

    if p.shared is not None:
        out = out + mlp(p.shared, x, ctx)
    return out, aux


def _dispatch(x: torch.Tensor, logits: torch.Tensor, *, E: int, K: int,
              C: int, with_aux: bool):
    """Softmax, top-k, each slot's place in its expert and the scatter of
    the tokens into the capacity buffer: ``(buf (B, E * C, D), dest (B, S *
    K), wk (B, S * K) the kept slots' weights, probs (B, S, E), top1 (B, S,
    E) the first choice one-hot)``; ``probs`` and ``top1`` are None unless
    ``with_aux``."""
    B, S, D = x.shape
    probs, top_p, top_e = _top_k(logits, K)
    top1 = F.one_hot(top_e[..., 0], E).float() if with_aux else None

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
    return (buf[:, :E * C], dest, w_flat * keep,
            probs if with_aux else None, top1)


def _combine(y: torch.Tensor, dest: torch.Tensor, wk: torch.Tensor, *,
             K: int) -> torch.Tensor:
    """Each slot's row of the experts' output ``y`` (B, E, C, D) (the pad
    row is zero), weighted by ``wk``, summed over a token's K slots:
    (B, S, D)."""
    B, E, C, D = y.shape
    y = torch.cat([y.reshape(B, E * C, D), y.new_zeros((B, 1, D))], dim=1)
    gathered = torch.take_along_dim(y, dest[..., None], dim=1)
    gathered = gathered * wk[..., None].to(y.dtype)
    return gathered.reshape(B, -1, K, D).sum(dim=2)
