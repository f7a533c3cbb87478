"""Shared layers of the dense transformer (the dense half of the reference
package's ``models/layers.py``): RMSNorm, RoPE, embeddings, linears routed
through the ADSALA-tuned GEMM, SwiGLU/GELU MLPs, and memory-bounded
blockwise (flash-style) attention with GQA/MQA.

The weights live in small ``nn.Module``s that store them as the reference
does: a linear's ``w`` is ``(d_in, d_out)`` row-major, which is how the
GEMM kernel reads B, so no call copies or transposes a weight
(``nn.Linear``'s ``(out, in)`` layout would).  The functions take those
modules; ``Ctx`` threads the model config and the runtime serving the
routed matmuls' knob decisions through the stack, and under a device mesh
the mesh and the logical sharding rules: ``Ctx.cons`` lays an activation
out by its logical names (the reference's ``ctx.cons`` sites, at the same
points), and ``Ctx.local`` runs a head-, batch- or expert-parallel region
on each rank's shards (``shard_map`` in JAX terms), so that the tensors a
region builds (positions, masks, chunk offsets) stay plain.

The training pieces are the losses, ``cross_entropy`` and
``chunked_cross_entropy``.  The parameters are made with
``requires_grad=False``, so serving keeps no autograd state; a trainer
(``launch/train.py``) turns gradients on for its own model.  The
accumulating steps (norms, softmax, the losses) run in float32 for every
compute dtype but float64, which they keep, so that a float64 copy of a
model evaluates the same function in float64 throughout.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

from .sharding import (DEFAULT_RULES, ShardingRules, constrain, logical_spec,
                       placements)

__all__ = ["Ctx", "Linear", "Norm", "Embedding", "Attention", "MLP",
           "torch_dtype", "linear", "routed_matmul", "rmsnorm", "embed",
           "rope", "attention", "mlp", "flash_attention", "cross_entropy",
           "chunked_cross_entropy", "split_heads", "merge_heads"]

#: the score of a masked position (the reference's ``NEG``)
NEG = -1e30


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its accumulation dtype: float32, or float64 if it is."""
    return x if x.dtype == torch.float64 else x.float()


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names (``"float32"``, ``"bfloat16"``)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"no torch dtype {name!r}")
    return dtype


@dataclasses.dataclass
class Ctx:
    """The model config, the runtime serving the routed matmuls' knob
    decisions, and, under a device mesh, the mesh and the logical sharding
    rules (``models/sharding.py``) that lay out the activations."""
    cfg: ModelConfig
    runtime: object = None            # AdsalaRuntime | None (None → global)
    mesh: object = None               # DeviceMesh | None
    rules: ShardingRules = DEFAULT_RULES

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch_dtype(self.cfg.compute_dtype))

    def cons(self, x: torch.Tensor, *names) -> torch.Tensor:
        """``x`` laid out by its logical names (the reference's
        ``with_sharding_constraint``); ``x`` itself off-mesh."""
        if self.mesh is None:
            return x
        return constrain(x, self.rules, self.mesh, *names)

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the model builds inside a step (a position table) as a
        DTensor replicated on the mesh; ``x`` itself off-mesh."""
        if self.mesh is None:
            return x
        return self.cons(x, *(None,) * x.dim())

    def local(self, fn, args, names, out_names):
        """``fn(*args)`` on each rank's shards (the reference's
        head-/batch-parallel regions, ``shard_map`` in JAX terms): each
        tensor of ``args`` is laid out by its logical names in ``names``
        (``None`` passes an argument as it is) and ``fn`` gets the local
        shards, plain tensors; its outputs, a tensor or a tuple, become
        DTensors by ``out_names``, each name sized as the inputs' dim of
        that name (``None`` returns an output as it is).  Off-mesh it is
        ``fn(*args)``.  ``fn`` must compute each output shard from the
        input shards alone: every dim an output is sharded on is one of
        the inputs'.  The one exception is a named combine across a mesh
        dim (:func:`combine_over_model`), after which every rank of that
        dim holds the same value: such an output is replicated there."""
        if self.mesh is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor, Partial, Replicate
        sizes: dict = {}
        laid = []
        for x, n in zip(args, names, strict=True):
            if n is not None:
                x = self.cons(x, *n)
                for name, size in zip(n, x.shape):
                    if (name is not None
                            and sizes.setdefault(name, size) != size):
                        raise ValueError(f"logical dim {name!r} is {size} "
                                         f"and {sizes[name]} in one region")
            laid.append(x)
        # the mesh dims the region splits its work over; an input
        # replicated on one of them feeds each rank's share of the work, so
        # its gradient is the sum of the ranks' (Partial)
        split = {i for x, n in zip(laid, names) if n is not None
                 for i, pl in enumerate(x.placements) if pl.is_shard()}
        local_args = [
            x if n is None else x.to_local(grad_placements=[
                pl if pl.is_shard() else
                Partial() if i in split else Replicate()
                for i, pl in enumerate(x.placements)])
            for x, n in zip(laid, names)]
        outs = fn(*local_args)
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        wrapped = []
        for o, n in zip(outs, (out_names,) if single else out_names,
                        strict=True):
            if n is None or o is None:
                wrapped.append(o)
                continue
            dims = [sizes[name] if name is not None else o.shape[d]
                    for d, name in enumerate(n)]
            spec = logical_spec(self.rules, self.mesh, n, dims=dims)
            wrapped.append(DTensor.from_local(
                o, self.mesh, placements(spec, self.mesh), run_check=False))
        return wrapped[0] if single else tuple(wrapped)

    def routes_gemm(self, x: torch.Tensor) -> bool:
        """Whether a dense matmul on ``x`` goes through the tuned runtime:
        opt-in via config, single-device only (the sharded path keeps
        plain matmuls on DTensors, as the reference's keeps jnp matmuls
        for GSPMD to partition)."""
        return (self.cfg.use_pallas_gemm and self.mesh is None
                and x.dim() >= 2)


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
        return flat_safe(lambda t: t @ w, x, ctx)
    lead = x.shape[:-2]
    x3 = x.reshape(-1, *x.shape[-2:]) if len(lead) > 1 else x
    y = kops.run_op("gemm", (x3, w), backend=ctx.cfg.gemm_backend,
                    runtime=ctx.runtime, device=x.device)
    return y.reshape(*lead, *y.shape[-2:]) if len(lead) > 1 else y


def _middle_whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its middle dims (all but the first and the last)
    gathered whole."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and 0 < p.dim % x.dim() < x.dim() - 1
          else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


class _MiddleWholeGrad(torch.autograd.Function):
    """The identity, whose gradient comes back with its middle dims
    whole."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _middle_whole(g)


def flat_safe(op, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``op(x)`` for an ``op`` that flattens ``x``'s leading dims (a matmul,
    an einsum), under a mesh with ``x``'s middle dims gathered whole (the
    sequence parallelism's all-gather ahead of a matmul) and its result's
    gradient alike: DTensor flattens dims only where no dim but the first
    of them is sharded."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or x.dim() <= 2:
        return op(x)     # off-mesh, or a shard inside a Ctx.local region
    return _MiddleWholeGrad.apply(op(_middle_whole(x)))


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

def linear(p: Linear, x: torch.Tensor, ctx: Ctx, *,
           out_logical: str | None = None) -> torch.Tensor:
    y = routed_matmul(x, ctx.cast(p.w), ctx)
    if p.b is not None:
        y = y + ctx.cast(p.b)
    if out_logical is not None:
        # 'embed' outputs are inter-block activations → carry the SP seq
        # sharding; head/mlp-parallel outputs leave seq unsharded.
        seq_name = "seq" if out_logical == "embed" else None
        y = ctx.cons(y, "batch", seq_name, out_logical)
    return y


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = _acc(x)
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p.scale.to(x32.dtype)).to(dt)


def embed(p: Embedding, ids: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather.
    # Under a mesh the gather is batch-local against the whole table (an
    # all-gather of its vocab and FSDP shards; its gradient a partial sum
    # reduce-scattered back), as GSPMD lowers it
    x = ctx.local(_gather_rows, [p.table, ids],
                  [(None, None), ("batch", None)], ("batch", None, None))
    return ctx.cons(ctx.cast(x), "batch", "seq", "embed")


def _gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's frequencies, computed in float64 numpy and used in
    float32; cached per device, so a step copies nothing to the card.  On
    the meta device (a harvest) only the shape is made."""
    if device.type == "meta":
        return torch.empty(half, dtype=torch.float32, device=device)
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

    Never materialises more than (B, Cq, H, Ck) scores.  Under autograd
    the loop is one :class:`_FlashAttention`: it keeps q, k, v, the output
    and each query row's log-sum-exp, and its backward recomputes every
    block's scores (the reference's ``jax.checkpoint`` of its kv step, the
    flash-attention memory contract).
    """
    geo = _FlashGeometry.of(q, k, v, causal=causal, q_offset=q_offset,
                            q_chunk=q_chunk, k_chunk=k_chunk,
                            causal_skip=causal_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_valid_len, geo)
    return _flash_forward(q, k, v, kv_valid_len, geo)[0]


@dataclasses.dataclass(frozen=True)
class _FlashGeometry:
    """The block layout of one :func:`flash_attention` call."""
    B: int
    S: int
    T: int
    KH: int
    G: int
    D: int
    Dv: int
    causal: bool
    q_offset: int
    q_chunk: int
    k_chunk: int
    causal_skip: bool

    @classmethod
    def of(cls, q, k, v, *, causal, q_offset, q_chunk, k_chunk,
           causal_skip) -> "_FlashGeometry":
        B, S, H, D = q.shape
        T, KH = k.shape[1], k.shape[2]
        return cls(B, S, T, KH, H // KH, D, v.shape[-1], causal, q_offset,
                   min(q_chunk, S), min(k_chunk, T), causal_skip)

    @property
    def nq(self) -> int:
        return -(-self.S // self.q_chunk)

    @property
    def nk(self) -> int:
        return -(-self.T // self.k_chunk)

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.D)

    def blocks(self, i: int) -> int:
        """The kv blocks q block ``i`` visits."""
        if self.causal_skip and self.causal:
            return min(self.nk, (self.q_offset + (i + 1) * self.q_chunk - 1)
                       // self.k_chunk + 1)
        return self.nk

    def q_blocks(self, t):
        """A tensor of q's layout (B, S, H, ·) padded to whole blocks, as
        (B, nq, Cq, KH, G, ·)."""
        Sp = self.nq * self.q_chunk
        if Sp != self.S:
            t = F.pad(t, (0, 0, 0, 0, 0, Sp - self.S))
        return t.reshape(self.B, self.nq, self.q_chunk, self.KH, self.G,
                         t.shape[-1])

    def kv_blocks(self, t):
        """k or v (B, T, KH, ·) padded to whole blocks, as (B, nk, Ck, KH,
        ·)."""
        Tp = self.nk * self.k_chunk
        if Tp != self.T:
            t = F.pad(t, (0, 0, 0, 0, 0, Tp - self.T))
        return t.reshape(self.B, self.nk, self.k_chunk, self.KH,
                         t.shape[-1])

    def q_pos(self, i: int, dev) -> torch.Tensor:
        return (self.q_offset + i * self.q_chunk
                + torch.arange(self.q_chunk, device=dev))

    def scores(self, qi, kj, q_pos, j: int, kv_valid_len) -> torch.Tensor:
        """The scores (B, Cq, G, KH, Ck) of a q block against kv block
        ``j``, in the accumulation dtype, masked positions at ``NEG``."""
        s = torch.einsum("bqhgd,bkhd->bqghk", qi, kj) * self.scale
        k_pos = j * self.k_chunk + torch.arange(self.k_chunk,
                                                device=qi.device)
        mask = (k_pos < self.T)[None, :]
        if self.causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = torch.where(mask[None, :, None, None, :], s, NEG)
        if kv_valid_len is not None:
            ok = k_pos[None, :] < kv_valid_len[:, None]       # (B, Ck)
            s = torch.where(ok[:, None, None, None, :], s, NEG)
        return s


def _flash_forward(q, k, v, kv_valid_len, geo: _FlashGeometry):
    """The online-softmax loop: (out (B, S, H, Dv) in q's dtype, the
    log-sum-exp of each query row's scores (B, Sp, G, KH) in the
    accumulation dtype)."""
    B, KH, G, Dv = geo.B, geo.KH, geo.G, geo.Dv
    dev = q.device
    # inputs keep their dtype; f32 only inside the chunk step (scores,
    # softmax and accumulators), as the reference's einsums accumulate
    qc, kc, vc = geo.q_blocks(q), geo.kv_blocks(k), geo.kv_blocks(v)
    outs, lses = [], []
    for i in range(geo.nq):
        qi = _acc(qc[:, i])                          # (B, Cq, KH, G, D)
        q_pos = geo.q_pos(i, dev)
        m = torch.full((B, geo.q_chunk, G, KH), NEG, dtype=qi.dtype,
                       device=dev)
        l = torch.zeros((B, geo.q_chunk, G, KH), dtype=qi.dtype, device=dev)
        acc = torch.zeros((B, geo.q_chunk, G, KH, Dv), dtype=qi.dtype,
                          device=dev)
        for j in range(geo.blocks(i)):
            kj, vj = _acc(kc[:, j]), vc[:, j]
            s = geo.scores(qi, kj, q_pos, j, kv_valid_len)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG * 0.5, 0.0, p)   # fully-masked guard
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqghk,bkhd->bqghd", _acc(p.to(v.dtype)), _acc(vj))
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out_i = acc / l[..., None]
        outs.append(out_i.permute(0, 1, 3, 2, 4).to(q.dtype))
        lses.append(m + torch.log(l))
    # (B, nq, Cq, KH, G, Dv) → heads h = kh·G + g, matching the q projection
    out = torch.stack(outs, dim=1).reshape(B, -1, KH * G, Dv)[:, :geo.S]
    return out.to(q.dtype), torch.cat(lses, dim=1)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` under autograd.  The forward is the loop of
    :func:`_flash_forward`; it keeps q, k, v, the output and the rows'
    log-sum-exp.  The backward walks the same blocks, recomputing each
    block's scores and probabilities ``p = exp(s - lse)`` from them: five
    products a block (the scores, ``dv += pᵀ·do``, ``dp = do·vᵀ``, ``dq +=
    ds·k``, ``dk += dsᵀ·q``, with ``ds = p ∘ (dp − rowsum(do ∘ out))``),
    as many as the reference's recomputed kv step and its vjp."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid_len, geo):
        out, lse = _flash_forward(q, k, v, kv_valid_len, geo)
        ctx.geo = geo
        ctx.save_for_backward(q, k, v, kv_valid_len, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid_len, out, lse = ctx.saved_tensors
        geo = ctx.geo
        Cq, dev = geo.q_chunk, q.device
        qc, kc, vc = geo.q_blocks(q), geo.kv_blocks(k), geo.kv_blocks(v)
        do_c, o_c = geo.q_blocks(dout), geo.q_blocks(out)
        # the cotangents, accumulated block by block in place (no atomics)
        acc = torch.float64 if q.dtype == torch.float64 else torch.float32
        dq = torch.zeros(qc.shape, dtype=acc, device=dev)
        dk = torch.zeros(kc.shape, dtype=acc, device=dev)
        dv = torch.zeros(vc.shape, dtype=acc, device=dev)
        for i in range(geo.nq):
            qi = _acc(qc[:, i])                      # (B, Cq, KH, G, D)
            doi = _acc(do_c[:, i])                   # (B, Cq, KH, G, Dv)
            # rowsum(do ∘ out) as (B, Cq, G, KH, 1)
            di = (doi * _acc(o_c[:, i])).sum(-1).transpose(2, 3)[..., None]
            lse_i = lse[:, i * Cq:(i + 1) * Cq, :, :, None]
            q_pos = geo.q_pos(i, dev)
            for j in range(geo.blocks(i)):
                kj = _acc(kc[:, j])
                s = geo.scores(qi, kj, q_pos, j, kv_valid_len)
                p = torch.exp(s - lse_i)
                p = torch.where(s <= NEG * 0.5, 0.0, p)
                dv[:, j] += torch.einsum("bqghk,bqhgd->bkhd",
                                         _acc(p.to(v.dtype)), doi)
                dp = torch.einsum("bqhgd,bkhd->bqghk", doi, _acc(vc[:, j]))
                ds = p * (dp - di)
                dq[:, i] += torch.einsum("bqghk,bkhd->bqhgd", ds, kj)
                dk[:, j] += torch.einsum("bqghk,bqhgd->bkhd", ds, qi)
        B, S, H, D = q.shape
        return ((dq.reshape(B, -1, H, D)[:, :S] * geo.scale).to(q.dtype),
                (dk.flatten(1, 2)[:, :geo.T] * geo.scale).to(k.dtype),
                dv.flatten(1, 2)[:, :geo.T].to(v.dtype), None, None)


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
              kv_x: torch.Tensor | None = None, causal: bool = True,
              positions: torch.Tensor | None = None,
              cache: dict | None = None, use_rope: bool = True):
    """GQA attention (the reference's): self-attention on ``x``, or
    cross-attention with K and V projected from ``kv_x`` (whose length may
    differ from the query's), causal or not, with RoPE at ``positions``
    (default: the cache's length onwards, or 0 onwards) unless
    ``use_rope`` is False.  ``cache`` (decode): {k, v: (B, T, KH, D); len:
    int}, written in place at ``len`` (the reference's functional update)
    and returned alongside the output; a call with ``kv_x`` has none.

    Under a mesh RoPE, the cache write and the attention run in the
    head-parallel region (:meth:`Ctx.local`) on each rank's heads and
    batch rows; seq is unsharded there (under SP rules this boundary is
    the all-gather / reduce-scatter pair).  A decode step over a cache
    whose sequence is sharded on ``model`` (the SP fallback, where the kv
    heads do not divide that axis) keeps the cache sharded
    (:func:`_decode_over_seq_shards`); a prefill gathers it."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    hd = cfg.hd()
    kv_in = x if kv_x is None else kv_x
    T = kv_in.shape[1]
    if cache is not None and cache["len"] + S > cache["k"].shape[1]:
        raise ValueError(f"the cache holds {cache['k'].shape[1]} positions; "
                         f"{cache['len']} are taken and {S} more do not fit")
    if cache is not None and S == 1 and seq_sharded(ctx, cache["k"]):
        out = _decode_over_seq_shards(p, x, kv_in, ctx, positions, cache,
                                      use_rope=use_rope)
        cache["len"] += S
        return linear(p.wo, merge_heads(out, ctx), ctx,
                      out_logical="embed"), cache
    qn = ("batch_attn", None, "heads", None)
    kn = ("batch_attn", "kv_seq", "kv_heads", None)
    q = split_heads(linear(p.wq, x, ctx), cfg.n_heads, hd, ctx, qn)
    k = split_heads(linear(p.wk, kv_in, ctx), cfg.kv_heads, hd, ctx, kn)
    v = split_heads(linear(p.wv, kv_in, ctx), cfg.kv_heads, hd, ctx, kn)
    pos_names = (None if positions is None or positions.shape[0] != B
                 else ("batch_attn", None))
    args, names = [q, k, v, positions], [qn, kn, kn, pos_names]
    cn = ("batch_attn", None, "kv_heads", None)
    if cache is not None:
        args += [cache["k"], cache["v"]]
        names += [cn, cn]
    region = functools.partial(_attention_core, cfg=cfg, causal=causal,
                               use_rope=use_rope,
                               start=None if cache is None else cache["len"],
                               model_rank=_model_rank(ctx))
    if cache is None:
        out = ctx.local(region, args, names, qn)
    else:
        out, ck, cv = ctx.local(region, args, names, (qn, cn, cn))
        if ctx.mesh is not None:
            # a cache laid out otherwise than the region (a seq-sharded
            # cache at a prefill) takes the written copy back in its own
            # layout
            for key, new in (("k", ck), ("v", cv)):
                if tuple(cache[key].placements) != tuple(new.placements):
                    cache[key] = new.redistribute(ctx.mesh,
                                                  cache[key].placements)
        cache["len"] += S
    out = linear(p.wo, merge_heads(out, ctx), ctx, out_logical="embed")
    return out, cache


# ---------------------------------------------------------------------------
# decode over a cache whose sequence is sharded on 'model'
# ---------------------------------------------------------------------------

#: the logical name of a cache's sequence sharded over 'model' (the SP
#: fallback of ``launch/specs.py::cache_logical_names``)
SEQ_SHARDS = "kv_seq_model"


def seq_sharded(ctx: Ctx, cache_t: torch.Tensor) -> bool:
    """Whether the cache tensor ``cache_t`` (B, T, ...) has its sequence
    sharded over the mesh's ``model`` dim."""
    if ctx.mesh is None or "model" not in ctx.mesh.mesh_dim_names:
        return False
    from torch.distributed.tensor import Shard
    return cache_t.placements[
        ctx.mesh.mesh_dim_names.index("model")] == Shard(1)


def seq_shard_region(ctx: Ctx) -> Ctx:
    """``ctx`` with :data:`SEQ_SHARDS` mapped to ``model``, so that a
    region takes a seq-sharded cache in its own layout."""
    return dataclasses.replace(ctx, rules=ctx.rules.replace(
        **{SEQ_SHARDS: ("model",)}))


def shard_offset(ctx: Ctx, local_len: int) -> int:
    """The global position of this rank's first cache row, its sequence
    split evenly over ``model``."""
    return _model_rank(ctx) * local_len


def decode_partials(s: torch.Tensor, v: torch.Tensor, eq: str):
    """One shard's pieces of a softmax over the last dim of the scores
    ``s`` (float32, masked at ``NEG``): the max ``m``, ``l = Σ exp(s −
    m)`` and ``o = einsum(eq, exp(s − m), v)``, in float32; a shard with
    no valid position gives ``l = o = 0``."""
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= NEG * 0.5, 0.0, p)
    return m, p.sum(-1), torch.einsum(eq, _acc(p.to(v.dtype)), _acc(v))


def combine_over_model(ctx: Ctx, m: torch.Tensor, l: torch.Tensor,
                       o: torch.Tensor) -> torch.Tensor:
    """The softmax-weighted sum across the ``model`` group from each
    rank's :func:`decode_partials` (the log-sum-exp form of one softmax
    over the whole sequence): the all-reduced max ``m*``, then ``l`` and
    ``o`` rescaled by ``exp(m − m*)`` and summed in one all-reduce;
    ``o / l``.  ``o`` has one dim more than ``m`` and ``l``."""
    from torch.distributed import _functional_collectives as funcol
    group = ctx.mesh.get_group("model")
    m_all = funcol.all_reduce(m, "max", group)
    c = torch.exp(m - m_all)[..., None]
    lo = funcol.all_reduce(torch.cat([o * c, l[..., None] * c], dim=-1),
                           "sum", group)
    return lo[..., :-1] / torch.clamp_min(lo[..., -1:], 1e-30)


def _decode_over_seq_shards(p: Attention, x, kv_in, ctx: Ctx, positions,
                            cache: dict, *, use_rope: bool) -> torch.Tensor:
    """A decode step's attention (S == 1) over a cache whose sequence is
    sharded over ``model``, without gathering it: the region takes the
    one-token q, k and v with every head and batch over the batch axes
    alone, the cache in its own layout; the rank holding position ``len``
    writes k and v there, each rank scores its own rows, and
    :func:`combine_over_model` joins them.  Returns the output (B, 1, H,
    hd), whole on ``model``."""
    cfg, hd = ctx.cfg, ctx.cfg.hd()
    B = x.shape[0]
    rows, cn = ("batch", None, None, None), ("batch", SEQ_SHARDS, None, None)
    q = split_heads(linear(p.wq, x, ctx), cfg.n_heads, hd, ctx, rows)
    k = split_heads(linear(p.wk, kv_in, ctx), cfg.kv_heads, hd, ctx, rows)
    v = split_heads(linear(p.wv, kv_in, ctx), cfg.kv_heads, hd, ctx, rows)
    pos_names = (None if positions is None or positions.shape[0] != B
                 else ("batch", None))
    region = functools.partial(_decode_shard, ctx=ctx, use_rope=use_rope,
                               start=cache["len"])
    return seq_shard_region(ctx).local(
        region, [q, k, v, positions, cache["k"], cache["v"]],
        [rows, rows, rows, pos_names, cn, cn], rows)


def _decode_shard(q, k, v, positions, ck, cv, *, ctx: Ctx, use_rope: bool,
                  start: int):
    """RoPE, the cache write and this rank's share of the decode attention
    of :func:`_decode_over_seq_shards` on its rows ``ck``, ``cv``."""
    cfg = ctx.cfg
    B, S, H, D = q.shape
    Tl, KH = ck.shape[1], ck.shape[2]
    G = H // KH
    if use_rope:
        if positions is None:
            positions = start + torch.arange(S, device=q.device)[None, :]
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    lo = shard_offset(ctx, Tl)
    if lo <= start < lo + Tl:
        ck[:, start - lo:start - lo + S] = k
        cv[:, start - lo:start - lo + S] = v
    kc, vc = ck.to(q.dtype), cv.to(q.dtype)
    s = torch.einsum("bqhgd,bkhd->bqghk", q.reshape(B, S, KH, G, D).float(),
                     kc.float()) * (1.0 / math.sqrt(D))
    k_pos = lo + torch.arange(Tl, device=q.device)
    s = torch.where(k_pos <= start, s, NEG)
    out = combine_over_model(
        ctx, *decode_partials(s, vc, "bqghk,bkhd->bqghd"))
    return out.permute(0, 1, 3, 2, 4).reshape(B, S, H, -1).to(q.dtype)


def split_heads(y: torch.Tensor, n: int, hd: int, ctx: Ctx,
                names) -> torch.Tensor:
    """A projection's output ``y`` (B, T, n·hd) viewed as (B, T, n, hd).
    Under a mesh ``y`` is first laid out as the head-parallel region
    takes the view (its logical ``names``): a column shard that would cut
    a head (``n`` not dividing the ``model`` axis) is gathered, and the
    batch and sequence move to the region's axes, where GSPMD reshards
    the reference's."""
    B, T = y.shape[:2]
    if ctx.mesh is not None:
        spec = logical_spec(ctx.rules, ctx.mesh, names, dims=(B, T, n, hd))
        target = placements((spec[0], spec[1], spec[2]), ctx.mesh)
        if tuple(y.placements) != target:
            y = y.redistribute(ctx.mesh, target)
    return y.reshape(B, T, n, hd)


class _GradInLayout(torch.autograd.Function):
    """The identity, whose gradient comes back in the forward value's
    layout."""

    @staticmethod
    def forward(ctx, y):
        ctx.placements = tuple(y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def merge_heads(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The head-parallel region's output ``x`` (B, T, n, hd) as (B, T,
    n·hd).  Under a mesh its gradient comes back in the merged value's
    layout, which the view back to heads takes (a column shard of the
    gradient that cut a head could not be viewed)."""
    y = x.reshape(*x.shape[:2], -1)
    return y if ctx.mesh is None else _GradInLayout.apply(y)


def _model_rank(ctx: Ctx) -> int:
    """This rank's coordinate on the mesh's ``model`` dim (0 off-mesh)."""
    if ctx.mesh is None:
        return 0
    return ctx.mesh.get_local_rank("model")


def _kv_heads_for(q: torch.Tensor, k: torch.Tensor, n_heads: int,
                  kv_heads: int, model_rank: int) -> slice:
    """The kv heads of ``k`` that this shard's query heads read: all of
    them unless the query heads are sharded and the kv heads are not (MQA,
    or kv_heads not dividing the model axis), then the kv heads of this
    rank's query heads."""
    h, kh = q.shape[2], k.shape[2]
    if h * kv_heads == n_heads * kh:
        return slice(None)
    group = n_heads // kv_heads
    if h % group and group % h:
        raise NotImplementedError(
            f"{h} query heads a shard straddle GQA groups of {group}")
    lo = model_rank * h // group
    return slice(lo, lo + max(h // group, 1))


def _attention_core(q, k, v, positions, ck=None, cv=None, *, cfg, causal,
                    use_rope, start, model_rank):
    """RoPE, the cache write and the attention of :func:`attention` on one
    shard (the whole tensors off-mesh)."""
    B, S = q.shape[:2]
    kv = _kv_heads_for(q, k, cfg.n_heads, cfg.kv_heads, model_rank)
    if start is not None:
        if use_rope:
            if positions is None:
                positions = start + torch.arange(S, device=q.device)[None, :]
            q = rope(q, positions, theta=cfg.rope_theta)
            k = rope(k, positions, theta=cfg.rope_theta)
        ck[:, start:start + S] = k
        cv[:, start:start + S] = v
        kc, vc = ck[:, :, kv].to(q.dtype), cv[:, :, kv].to(q.dtype)
        if S == 1:
            out = _dense_decode_attention(q, kc, vc, start)
        else:
            valid = torch.full((B,), start + S, device=q.device)
            out = flash_attention(q, kc, vc, causal=causal, q_offset=start,
                                  q_chunk=min(cfg.attn_q_chunk, S),
                                  k_chunk=cfg.attn_k_chunk,
                                  kv_valid_len=valid)
        return out, ck, cv
    k, v = k[:, :, kv], v[:, :, kv]
    if use_rope:
        if positions is None:
            positions = torch.arange(S, device=q.device)[None, :].expand(B, S)
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    return flash_attention(q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
                           k_chunk=cfg.attn_k_chunk,
                           causal_skip=cfg.causal_skip)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp(p: MLP, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    if p.swiglu:
        h = F.silu(linear(p.wg, x, ctx, out_logical="mlp")) * \
            linear(p.wu, x, ctx, out_logical="mlp")
        return linear(p.wd, h, ctx, out_logical="embed")
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(linear(p.w1, x, ctx, out_logical="mlp"), approximate="tanh")
    return linear(p.w2, h, ctx, out_logical="embed")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim.  On a DTensor sharded there (a
    vocab-parallel head) it is the max, the shifted exponentials and
    their sum, each reducing across the shards as a small partial result,
    where DTensor would gather the whole vocabulary for ``logsumexp``."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(logits, DTensor) or \
            Shard(logits.dim() - 1) not in logits.placements:
        return torch.logsumexp(logits, dim=-1)
    m = logits.detach().amax(-1, keepdim=True)
    return (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[
        ..., 0]


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  On a DTensor whose last dim is sharded (a
    vocab-parallel head) each rank picks the labels in its slice of the
    vocabulary and the result is their partial sum across the slices (the
    gradient a scatter into the rank's own slice), where DTensor's gather
    would take its backward over the whole vocabulary."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    vocab = logits.dim() - 1
    if not isinstance(logits, DTensor) or Shard(vocab) not in \
            logits.placements:
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    axis = pl.index(Shard(vocab))
    labels = labels.redistribute(mesh, [
        p if isinstance(p, Shard) and p.dim < vocab else Replicate()
        for p in pl])
    local = logits.to_local(grad_placements=pl)
    n = local.shape[-1]
    idx = labels.to_local() - mesh.get_local_rank(axis) * n
    inside = (idx >= 0) & (idx < n)
    picked = torch.gather(local, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    out = [Partial() if p == Shard(vocab) else p for p in pl]
    return DTensor.from_local(torch.where(inside, picked, 0.0), mesh, out,
                              run_check=False)


def _nll_sums(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """The sum of the next-token NLL (with ``z_loss * lse**2``) over the
    positions whose label is >= 0, and their count."""
    logits = _acc(logits)
    lse = _logsumexp(logits)
    ll = _label_logit(logits, labels.clamp_min(0).long())
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).to(logits.dtype)
    return (nll * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE in float32; labels < 0 are masked out."""
    tot, cnt = _nll_sums(logits, labels, z_loss)
    return tot / torch.clamp_min(cnt, 1.0)


def _chunk_sums(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                z_loss: float):
    logits = x @ w
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor):
        # the logits' gradient in their own layout (rows by batch, columns
        # by vocabulary), which the head's matmul takes back
        logits = _GradInLayout.apply(logits)
    return _nll_sums(logits, labels, z_loss)


def chunked_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 2048,
                          z_loss: float = 0.0) -> torch.Tensor:
    """CE fused with the LM head over sequence chunks of ``chunk``
    positions: under autograd each chunk runs under
    ``torch.utils.checkpoint``, which keeps its inputs and recomputes its
    logits in the backward pass, so the (B, S, V) float32 logits are never
    held at once (at a 128k vocabulary the dominant memory term of a train
    step).  x: (B, S, D) after the final norm; w: (D, V)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = cnt = 0.0
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        if torch.is_grad_enabled():
            t, n = checkpoint(_chunk_sums, x[:, sl], w, labels[:, sl],
                              z_loss, use_reentrant=False)
        else:
            t, n = _chunk_sums(x[:, sl], w, labels[:, sl], z_loss)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)
