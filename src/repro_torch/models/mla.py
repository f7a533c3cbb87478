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

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import (NEG, Ctx, Linear, Norm, flash_attention, linear,
                     rmsnorm, rope, torch_dtype)

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


def _expand(p: MLA, c_kv: torch.Tensor, k_rope: torch.Tensor, ctx: Ctx):
    """Per-head K and V from the latent ``(B, T, kv_lora)`` and the shared
    rotated key ``(B, T, rp)``."""
    cfg = ctx.cfg
    B, T, _ = c_kv.shape
    h, nope, rp = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kv = linear(p.wkv_b, c_kv, ctx).reshape(B, T, h, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   k_rope[:, :, None, :].expand(B, T, h, rp)], dim=-1)
    return k, kv[..., nope:]


def mla_attention(p: MLA, x: torch.Tensor, ctx: Ctx, *,
                  cache: dict | None = None):
    """Returns ``(out (B, S, d), cache)``; ``cache`` (None uncached) is
    written in place at ``len``."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    h, nope, rp, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)

    kv_a = linear(p.wkv_a, x, ctx)
    c_kv = rmsnorm(p.kv_norm, kv_a[..., :cfg.kv_lora])
    k_rope_new = kv_a[..., cfg.kv_lora:]                  # (B, S, rp), 1 head
    q = linear(p.wq, x, ctx).reshape(B, S, h, nope + rp)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    if cache is None:
        positions = torch.arange(S, device=x.device)[None, :]
        q_rope = rope(q_rope, positions, theta=cfg.rope_theta)
        k_rope = rope(k_rope_new[:, :, None, :], positions,
                      theta=cfg.rope_theta)[:, :, 0]
        k, v = _expand(p, c_kv, k_rope, ctx)
        out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                              causal=True, q_chunk=cfg.attn_q_chunk,
                              k_chunk=cfg.attn_k_chunk,
                              causal_skip=cfg.causal_skip)
        return linear(p.wo, out.reshape(B, S, h * vd), ctx), None

    # cached: write the latent and the rotated key at len, then attend
    start = cache["len"]
    c, kr = cache["c_kv"], cache["k_rope"]
    if start + S > c.shape[1]:
        raise ValueError(f"the cache holds {c.shape[1]} positions; "
                         f"{start} are taken and {S} more do not fit")
    positions = start + torch.arange(S, device=x.device)[None, :]
    q_rope = rope(q_rope, positions, theta=cfg.rope_theta)
    k_rope_new = rope(k_rope_new[:, :, None, :], positions,
                      theta=cfg.rope_theta)[:, :, 0]
    c[:, start:start + S] = c_kv
    kr[:, start:start + S] = k_rope_new
    cache["len"] = start + S
    c, kr = ctx.cast(c), ctx.cast(kr)

    if S > 1:
        # prefill: the whole latent cache expanded, blockwise flash (the
        # absorbed form would materialise S x T scores a head)
        k, v = _expand(p, c, kr, ctx)
        out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                              causal=True, q_offset=start,
                              q_chunk=cfg.attn_q_chunk,
                              k_chunk=cfg.attn_k_chunk,
                              kv_valid_len=torch.full((B,), start + S,
                                                      device=x.device))
        return linear(p.wo, out.reshape(B, S, h * vd), ctx), cache

    # decode: the absorbed form over the latent cache
    w_b = ctx.cast(p.wkv_b.w).reshape(cfg.kv_lora, h, nope + vd)
    w_kb, w_vb = w_b[..., :nope], w_b[..., nope:]
    q_c = torch.einsum("bshn,lhn->bshl", q_nope, w_kb)
    scale = 1.0 / math.sqrt(nope + rp)
    scores = (torch.einsum("bshl,btl->bsht", q_c, c)
              + torch.einsum("bshr,btr->bsht", q_rope, kr)) * scale
    k_pos = torch.arange(c.shape[1], device=x.device)[None, None, None, :]
    ok = (k_pos < start + S) & (k_pos <= positions[:, :, None, None])
    scores = torch.where(ok, scores.float(), NEG)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_c = torch.einsum("bsht,btl->bshl", attn, c)
    out = torch.einsum("bshl,lhv->bshv", ctx_c, w_vb)
    return linear(p.wo, out.reshape(B, S, h * vd), ctx), cache
