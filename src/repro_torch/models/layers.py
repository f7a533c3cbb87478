"""Shared layers of the dense transformer (the dense half of the reference
package's ``models/layers.py``): RMSNorm, RoPE, embeddings, linears routed
through the ADSALA-tuned GEMM, SwiGLU/GELU MLPs, and memory-bounded
blockwise (flash-style) attention with GQA/MQA.

The weights live in small ``nn.Module``s that store them as the reference
does: a linear's ``w`` is ``(d_in, d_out)`` row-major, which is how the
GEMM kernel reads B, so no call copies or transposes a weight
(``nn.Linear``'s ``(out, in)`` layout would).  The functions take those
modules; ``Ctx`` threads the model config and the runtime serving the
routed matmuls' knob decisions through the stack.

Training pieces (the cross-entropy losses) wait for the training slice,
so the parameters carry no gradient.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

__all__ = ["Ctx", "Linear", "Norm", "Embedding", "Attention", "MLP",
           "torch_dtype", "linear", "routed_matmul", "rmsnorm", "embed",
           "rope", "attention", "mlp", "flash_attention"]

#: the score of a masked position (the reference's ``NEG``)
NEG = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names (``"float32"``, ``"bfloat16"``)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"no torch dtype {name!r}")
    return dtype


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    runtime: object = None            # AdsalaRuntime | None (None → global)

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch_dtype(self.cfg.compute_dtype))

    def routes_gemm(self, x: torch.Tensor) -> bool:
        """Whether a dense matmul on ``x`` goes through the tuned runtime
        (opt-in via config; the sharded path of the reference waits for
        the distributed slice)."""
        return self.cfg.use_pallas_gemm and x.dim() >= 2


def routed_matmul(x: torch.Tensor, w: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``x @ w`` dispatched through :func:`repro_torch.kernels.ops.run_op` —
    knob selection, decision cache and backend keying all come from the
    ADSALA runtime carried on ``ctx`` (``None`` → the process-global
    runtime) — on the activations' device.

    Activations keep their leading batch axis: ``(B, S, d) @ (d, n)`` runs
    as one stacked GEMM whose 2-D weight is shared across the stack (read
    at batch stride 0, never copied); two or more leading axes fold into
    one stack axis.  On a CUDA tensor this launches the GEMM kernel or
    raises; on a CPU tensor it computes the kernel's plain version.  Plain
    ``x @ w`` when the config does not route."""
    if not ctx.routes_gemm(x) or w.dim() != 2:
        return x @ w
    lead = x.shape[:-2]
    x3 = x.reshape(-1, *x.shape[-2:]) if len(lead) > 1 else x
    y = kops.run_op("gemm", (x3, w), backend=ctx.cfg.gemm_backend,
                    runtime=ctx.runtime, device=x.device)
    return y.reshape(*lead, *y.shape[-2:]) if len(lead) > 1 else y


# ---------------------------------------------------------------------------
# parameter modules: the reference's param dicts, field for field
# ---------------------------------------------------------------------------

def _param(shape, *, dtype, device, gen, std: float | None = None,
           fill: float = 0.0) -> nn.Parameter:
    """A parameter drawn from N(0, std) with ``gen`` (or filled with
    ``fill``) on ``device``; left unset on the ``meta`` device."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.device.type != "meta":
        if std is None:
            t.fill_(fill)
        else:
            t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """``w`` ``(d_in, d_out)`` ~ N(0, scale) (default ``1/sqrt(d_in)``) and
    an optional zero bias ``b``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 scale: float | None = None, dtype=torch.float32,
                 device=None, gen=None) -> None:
        super().__init__()
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        self.w = _param((d_in, d_out), dtype=dtype, device=device, gen=gen,
                        std=scale)
        self.register_parameter(
            "b", _param((d_out,), dtype=dtype, device=device, gen=gen)
            if bias else None)


class Norm(nn.Module):
    def __init__(self, d: int, *, dtype=torch.float32, device=None) -> None:
        super().__init__()
        self.scale = _param((d,), dtype=dtype, device=device, gen=None,
                            fill=1.0)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, dtype=torch.float32,
                 device=None, gen=None) -> None:
        super().__init__()
        self.table = _param((vocab, d), dtype=dtype, device=device, gen=gen,
                            std=0.02)


class Attention(nn.Module):
    """The GQA projections: ``wq`` to ``n_heads`` heads, ``wk``/``wv`` to
    ``kv_heads`` (with the QKV bias where the config has one), ``wo`` back
    at scale ``1/sqrt(n_heads * hd)``."""

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        d, hd = cfg.d_model, cfg.hd()
        kw = dict(dtype=torch_dtype(cfg.param_dtype), device=device, gen=gen)
        self.wq = Linear(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d, cfg.kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, cfg.kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(cfg.n_heads * hd, d,
                         scale=1.0 / math.sqrt(cfg.n_heads * hd), **kw)


class MLP(nn.Module):
    """SwiGLU (``wg``, ``wu``, ``wd``) or GELU (``w1``, ``w2``)."""

    def __init__(self, d: int, d_ff: int, *, mlp_type: str = "swiglu",
                 dtype=torch.float32, device=None, gen=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.swiglu = mlp_type == "swiglu"
        if self.swiglu:
            self.wg = Linear(d, d_ff, **kw)
            self.wu = Linear(d, d_ff, **kw)
            self.wd = Linear(d_ff, d, **kw)
        else:
            self.w1 = Linear(d, d_ff, **kw)
            self.w2 = Linear(d_ff, d, **kw)


# ---------------------------------------------------------------------------
# linear / norm / embedding
# ---------------------------------------------------------------------------

def linear(p: Linear, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    y = routed_matmul(x, ctx.cast(p.w), ctx)
    if p.b is not None:
        y = y + ctx.cast(p.b)
    return y


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p.scale.float()).to(dt)


def embed(p: Embedding, ids: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    return ctx.cast(p.table[ids])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's frequencies, computed in float64 numpy and used in
    float32; cached per device, so a step copies nothing to the card."""
    freqs = 1.0 / (theta ** (np.arange(0, half) / half))
    return torch.from_numpy(freqs).to(device=device, dtype=torch.float32)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D) rotated by ``positions`` (..., S)."""
    half = x.shape[-1] // 2
    ang = positions[..., None].float() * _rope_freqs(half, float(theta),
                                                     x.device)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise (flash-style) attention — memory-bounded for long contexts
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, q_chunk: int = 1024,
                    k_chunk: int = 1024, kv_valid_len=None,
                    causal_skip: bool = False) -> torch.Tensor:
    """Online-softmax attention over kv chunks (the reference's, with Python
    loops in place of its scans).

    q: (B, S, H, D); k, v: (B, T, KH, D) with H = G·KH (GQA groups).
    ``q_offset`` — absolute position of q[0] (decode: cache length).
    ``kv_valid_len`` — optional (B,) number of valid cache entries.
    ``causal_skip`` — skip the kv blocks a causal q block cannot reach.

    Never materialises more than (B, Cq, H, Ck) scores.
    """
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, S)
    k_chunk = min(k_chunk, T)
    nq = -(-S // q_chunk)
    nk = -(-T // k_chunk)
    Sp, Tp = nq * q_chunk, nk * k_chunk
    if Sp != S:
        q = F.pad(q, (0, 0, 0, 0, 0, Sp - S))
    if Tp != T:
        k = F.pad(k, (0, 0, 0, 0, 0, Tp - T))
        v = F.pad(v, (0, 0, 0, 0, 0, Tp - T))
    dev = q.device
    # inputs keep their dtype; f32 only inside the chunk step (scores,
    # softmax and accumulators), as the reference's einsums accumulate
    qc = q.reshape(B, nq, q_chunk, KH, G, D)
    kc = k.reshape(B, nk, k_chunk, KH, D)
    vc = v.reshape(B, nk, k_chunk, KH, Dv)
    outs = []
    for i in range(nq):
        qi = qc[:, i].float()                        # (B, Cq, KH, G, D)
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, q_chunk, G, KH), NEG, device=dev)
        l = torch.zeros((B, q_chunk, G, KH), device=dev)
        acc = torch.zeros((B, q_chunk, G, KH, Dv), device=dev)
        hi = nk
        if causal_skip and causal:
            hi = min(nk, (q_offset + (i + 1) * q_chunk - 1) // k_chunk + 1)
        for j in range(hi):
            kj, vj = kc[:, j].float(), vc[:, j]
            # scores: (B, Cq, G, KH, Ck)
            s = torch.einsum("bqhgd,bkhd->bqghk", qi, kj) * scale
            k_pos = j * k_chunk + torch.arange(k_chunk, device=dev)
            mask = (k_pos < T)[None, :]
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(mask[None, :, None, None, :], s, NEG)
            if kv_valid_len is not None:
                ok = k_pos[None, :] < kv_valid_len[:, None]       # (B, Ck)
                s = torch.where(ok[:, None, None, None, :], s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG * 0.5, 0.0, p)   # fully-masked guard
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqghk,bkhd->bqghd", p.to(v.dtype).float(), vj.float())
            m = m_new
        out_i = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out_i.permute(0, 1, 3, 2, 4).to(q.dtype))
    # (B, nq, Cq, KH, G, Dv) → heads h = kh·G + g, matching the q projection
    out = torch.stack(outs, dim=1).reshape(B, Sp, KH * G, Dv)[:, :S]
    return out.to(q.dtype)


def _dense_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, start: int) -> torch.Tensor:
    """Single-shot attention for decode (S == 1): one einsum over the
    whole cache.  q: (B, S, H, D); k, v: (B, T, KH, D/Dv); valid positions
    are < start + S."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    q_ = q.reshape(B, S, KH, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqghk", q_, k.float()) * scale
    k_pos = torch.arange(T, device=q.device)[None, None, None, None, :]
    q_pos = (start + torch.arange(S, device=q.device))[None, :, None, None,
                                                       None]
    s = torch.where(k_pos <= q_pos, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqghk,bkhd->bqghd", p.to(v.dtype).float(), v.float())
    out = out.permute(0, 1, 3, 2, 4).reshape(B, S, KH * G, -1)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def attention(p: Attention, x: torch.Tensor, ctx: Ctx, *,
              cache: dict | None = None):
    """Causal GQA self-attention with RoPE (the reference's, as its
    ``"attn"`` blocks call it).  ``cache`` (decode): {k, v: (B, T, KH, D);
    len: int}, written in place at ``len`` (the reference's functional
    update) and returned alongside the output."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    hd = cfg.hd()
    q = linear(p.wq, x, ctx).reshape(B, S, cfg.n_heads, hd)
    k = linear(p.wk, x, ctx).reshape(B, S, cfg.kv_heads, hd)
    v = linear(p.wv, x, ctx).reshape(B, S, cfg.kv_heads, hd)
    if cache is not None:
        start = cache["len"]
        ck, cv = cache["k"], cache["v"]
        if start + S > ck.shape[1]:
            raise ValueError(f"the cache holds {ck.shape[1]} positions; "
                             f"{start} are taken and {S} more do not fit")
        positions = start + torch.arange(S, device=x.device)[None, :]
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
        ck[:, start:start + S] = k
        cv[:, start:start + S] = v
        cache["len"] = start + S
        if S == 1:
            out = _dense_decode_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                          start)
        else:
            valid = torch.full((B,), start + S, device=x.device)
            out = flash_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                  causal=True, q_offset=start,
                                  q_chunk=min(cfg.attn_q_chunk, S),
                                  k_chunk=cfg.attn_k_chunk,
                                  kv_valid_len=valid)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
        out = flash_attention(q, k, v, causal=True,
                              q_chunk=cfg.attn_q_chunk,
                              k_chunk=cfg.attn_k_chunk,
                              causal_skip=cfg.causal_skip)
    out = linear(p.wo, out.reshape(B, S, cfg.n_heads * hd), ctx)
    return out, cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp(p: MLP, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    if p.swiglu:
        h = F.silu(linear(p.wg, x, ctx)) * linear(p.wu, x, ctx)
        return linear(p.wd, h, ctx)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(linear(p.w1, x, ctx), approximate="tanh")
    return linear(p.w2, h, ctx)
