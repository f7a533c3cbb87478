"""Multi-head Latent Attention (DeepSeek-V2) with its low-rank KV cache (the
reference package's ``models/mla.py``), in its three forms:

* uncached (``forward``): the latent ``c_kv`` is expanded through ``wkv_b``
  to per-head K/V and runs through blockwise flash attention;
* cached prefill (``S > 1``): the same over the whole latent cache, from
  position ``len``;
* decode (``S == 1``): the *absorbed* form, ``q_nope`` folded through the
  key half of ``wkv_b`` so the scores are taken against the
  ``(T, kv_lora)`` latent cache itself, and the context expanded through
  the value half once.  Its einsums stay plain PyTorch, as the reference
  computes them outside its Pallas GEMM; the routed linears are ``wq``,
  ``wkv_a`` and ``wo`` (and ``wkv_b`` in the other two forms).

The cache holds ``kv_lora + qk_rope_dim`` floats a token and is written in
place, like the dense cache.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from . import layers
from .layers import (NEG, Ctx, Linear, Norm, _model_rank, flash_attention,
                     linear, merge_heads, rmsnorm, rope, split_heads,
                     torch_dtype)

__all__ = ["MLA", "mla_attention", "init_mla_cache"]


class MLA(nn.Module):
    """``wq`` to ``n_heads x (qk_nope + qk_rope)``, ``wkv_a`` to the latent
    and the shared RoPE key (``kv_lora + qk_rope``), ``kv_norm``, ``wkv_b``
    from the latent to ``n_heads x (qk_nope + v_head)``, and ``wo``."""

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        d = cfg.d_model
        h, nope, rp, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                           cfg.v_head_dim)
        dtype = torch_dtype(cfg.param_dtype)
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.wq = Linear(d, h * (nope + rp), **kw)
        self.wkv_a = Linear(d, cfg.kv_lora + rp, **kw)
        self.kv_norm = Norm(cfg.kv_lora, dtype=dtype, device=device)
        self.wkv_b = Linear(cfg.kv_lora, h * (nope + vd), **kw)
        self.wo = Linear(h * vd, d, **kw)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    """``{c_kv: (batch, max_len, kv_lora), k_rope: (batch, max_len,
    qk_rope_dim), len: 0}``, zeroed on ``device``."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device),
            "len": 0}


def mla_attention(p: MLA, x: torch.Tensor, ctx: Ctx, *,
                  cache: dict | None = None):
    """Returns ``(out (B, S, d), cache)``; ``cache`` (None uncached) is
    written in place at ``len``.  Under a mesh RoPE, the cache write and
    the attention run in the head-parallel region (:meth:`Ctx.local`), seq
    unsharded (the SP boundary)."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    h, nope, rp, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)

    kv_a = linear(p.wkv_a, x, ctx)
    c_kv = rmsnorm(p.kv_norm, kv_a[..., :cfg.kv_lora])
    k_rope_new = kv_a[..., cfg.kv_lora:]                  # (B, S, rp), 1 head
    qn, rows = ("batch", None, "heads", None), ("batch", None, None)
    q = split_heads(linear(p.wq, x, ctx), h, nope + rp, ctx, qn)

    if cache is None:
        kv = split_heads(linear(p.wkv_b, c_kv, ctx), h, nope + vd, ctx, qn)
        out = ctx.local(functools.partial(_uncached, cfg=cfg),
                        [q, kv, k_rope_new], [qn, qn, rows], qn)
        return linear(p.wo, merge_heads(out, ctx), ctx,
                      out_logical="embed"), None

    # cached: write the latent and the rotated key at len, then attend
    start = cache["len"]
    if start + S > cache["c_kv"].shape[1]:
        raise ValueError(f"the cache holds {cache['c_kv'].shape[1]} "
                         f"positions; {start} are taken and {S} more do not "
                         f"fit")
    out, c, kr = ctx.local(
        functools.partial(_cached, ctx=ctx, start=start,
                          model_rank=_model_rank(ctx)),
        [q, c_kv, k_rope_new, cache["c_kv"], cache["k_rope"],
         ctx.cast(p.wkv_b.w)],
        [qn, rows, rows, rows, rows, (None, None)], (qn, rows, rows))
    if ctx.mesh is not None:
        # the latent cache's own layout (seq over 'model') takes the
        # written copy back
        for key, new in (("c_kv", c), ("k_rope", kr)):
            if tuple(cache[key].placements) != tuple(new.placements):
                cache[key] = new.redistribute(ctx.mesh, cache[key].placements)
    cache["len"] = start + S
    return linear(p.wo, merge_heads(out, ctx), ctx,
                  out_logical="embed"), cache


def _uncached(q, kv, k_rope, *, cfg: ModelConfig):
    """RoPE and flash attention of the uncached form on one shard: the
    latent expanded to per-head ``kv`` (B, S, h, nope + vd), the shared
    key ``k_rope`` (B, S, rp) broadcast over the heads."""
    B, S, h, _ = q.shape
    nope, rp = cfg.qk_nope_dim, cfg.qk_rope_dim
    positions = torch.arange(S, device=q.device)[None, :]
    q_rope = rope(q[..., nope:], positions, theta=cfg.rope_theta)
    k_rope = rope(k_rope[:, :, None, :], positions,
                  theta=cfg.rope_theta)[:, :, 0]
    k = torch.cat([kv[..., :nope],
                   k_rope[:, :, None, :].expand(B, S, h, rp)], dim=-1)
    return flash_attention(torch.cat([q[..., :nope], q_rope], dim=-1), k,
                           kv[..., nope:], causal=True,
                           q_chunk=cfg.attn_q_chunk,
                           k_chunk=cfg.attn_k_chunk,
                           causal_skip=cfg.causal_skip)


def _cached(q, c_kv, k_rope_new, c, kr, w, *, ctx: Ctx, start: int,
            model_rank: int):
    """The cached forms on one shard: the latent ``c_kv`` and the rotated
    key written into the caches ``c``/``kr`` at ``start``, then the
    expanded prefill (``S > 1``) or the absorbed decode over them.  ``w``
    is ``wkv_b``'s weight, of which the shard's query heads read their
    own."""
    cfg = ctx.cfg
    B, S, hl, _ = q.shape
    h, nope, rp, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
    if hl != h:
        w = w.reshape(cfg.kv_lora, h, nope + vd)[
            :, model_rank * hl:(model_rank + 1) * hl].reshape(
                cfg.kv_lora, hl * (nope + vd))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    positions = start + torch.arange(S, device=q.device)[None, :]
    q_rope = rope(q_rope, positions, theta=cfg.rope_theta)
    k_rope_new = rope(k_rope_new[:, :, None, :], positions,
                      theta=cfg.rope_theta)[:, :, 0]
    c[:, start:start + S] = c_kv
    kr[:, start:start + S] = k_rope_new
    cc, krc = ctx.cast(c), ctx.cast(kr)

    if S > 1:
        # prefill: the whole latent cache expanded, blockwise flash (the
        # absorbed form would materialise S x T scores a head)
        T = cc.shape[1]
        kv = layers.routed_matmul(cc, w, ctx).reshape(B, T, hl, nope + vd)
        k = torch.cat([kv[..., :nope],
                       krc[:, :, None, :].expand(B, T, hl, rp)], dim=-1)
        out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k,
                              kv[..., nope:], causal=True, q_offset=start,
                              q_chunk=cfg.attn_q_chunk,
                              k_chunk=cfg.attn_k_chunk,
                              kv_valid_len=torch.full((B,), start + S,
                                                      device=q.device))
        return out, c, kr

    # decode: the absorbed form over the latent cache
    w_b = w.reshape(cfg.kv_lora, hl, nope + vd)
    w_kb, w_vb = w_b[..., :nope], w_b[..., nope:]
    q_c = torch.einsum("bshn,lhn->bshl", q_nope, w_kb)
    scale = 1.0 / math.sqrt(nope + rp)
    scores = (torch.einsum("bshl,btl->bsht", q_c, cc)
              + torch.einsum("bshr,btr->bsht", q_rope, krc)) * scale
    k_pos = torch.arange(cc.shape[1], device=q.device)[None, None, None, :]
    ok = (k_pos < start + S) & (k_pos <= positions[:, :, None, None])
    scores = torch.where(ok, scores.float(), NEG)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx_c = torch.einsum("bsht,btl->bshl", attn, cc)
    return torch.einsum("bshl,lhv->bshv", ctx_c, w_vb), c, kr
