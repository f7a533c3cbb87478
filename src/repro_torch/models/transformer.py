"""Model assembler of every family of the reference package's
``models/transformer.py`` (dense, MoE, hybrid, SSM, audio and VLM), with
the reference's functions over them: ``init_params``, ``forward``,
``init_decode_state``, ``prefill``, ``decode_step`` and ``param_count``,
and :func:`from_reference`, which carries the reference's parameter pytree
across.

Block kinds:
  attn        pre-LN attention (GQA, or MLA) + MLP     (dense, VLM backbone)
  moe         pre-LN attention (GQA or MLA) + MoE      (granite-moe, deepseek)
  mamba2      pre-LN Mamba2 mixer                      (zamba2's tail)
  zamba_super k x mamba2 + the one SHARED attn+MLP block (zamba2)
  rwkv6       the self-contained RWKV6 layer           (rwkv6)
  enc         bidirectional attention + MLP, no RoPE   (whisper's encoder)
  dec_cross   causal self-attention + cross-attention + MLP, no RoPE
                                                       (whisper's decoder)

Where the reference scans each segment's layers over parameters stacked on
a leading axis, the port holds one module per layer, the segments of
``cfg.segments()`` in order, and loops over them.  Decode caches are one
per layer (a KV or latent cache, a Mamba2 or RWKV6 state, or a
``zamba_super``'s states and KV cache), written in place.

Whisper's encoder (``encoder``: ``"enc"`` blocks and a norm) reads stub
frame embeddings with sinusoid positions, and its decoder embeds tokens at
sinusoid positions too; the VLM's ``vision_proj`` maps stub patch
embeddings into the token stream ahead of the prompt.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import (MLP, Attention, Ctx, Embedding, Linear, Norm,
                     attention, embed, linear, mlp, rmsnorm, routed_matmul,
                     torch_dtype)
from .mamba2 import Mamba2, init_mamba2_state, mamba2_mixer
from .mla import MLA, init_mla_cache, mla_attention
from .moe import MoE
from .rwkv6 import RWKV6, init_rwkv6_state

__all__ = ["Block", "DecCross", "Encoder", "Mamba2Block", "ZambaSuper",
           "Transformer", "init_params", "forward", "init_decode_state",
           "prefill", "decode_step", "param_count", "from_reference"]

#: the block kinds the port runs
_KINDS = ("attn", "moe", "mamba2", "zamba_super", "rwkv6", "enc",
          "dec_cross")


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for a config whose layer stack has a block kind the port does
    not run."""
    if any(kind not in _KINDS for kind, _ in cfg.segments()):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) needs block kinds {cfg.segments()}; "
            f"the port runs {_KINDS}")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a host
    without one (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device} "
                           f"(torch.cuda.is_available() is False); pass "
                           f"device='cpu' to run on the CPU")
    return device


class Block(nn.Module):
    """Pre-LN attention, GQA or MLA (``cfg.use_mla``), then an MLP (block
    kind ``"attn"``) or an MoE FFN (``"moe"``); or Whisper's encoder block
    (``"enc"``): GQA attention, bidirectional, then an MLP.  The audio
    family's attention has no RoPE."""

    def __init__(self, cfg: ModelConfig, kind: str = "attn", *, device=None,
                 gen=None) -> None:
        super().__init__()
        if kind not in ("attn", "moe", "enc"):
            raise ValueError(f"no attention block kind {kind!r}")
        self.kind = kind
        dtype = torch_dtype(cfg.param_dtype)
        self.ln1 = Norm(cfg.d_model, dtype=dtype, device=device)
        self.attn = (MLA(cfg, device=device, gen=gen)
                     if cfg.use_mla and kind != "enc"
                     else Attention(cfg, device=device, gen=gen))
        self.ln2 = Norm(cfg.d_model, dtype=dtype, device=device)
        if kind == "moe":
            self.moe = MoE(cfg, device=device, gen=gen)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, mlp_type=cfg.mlp_type,
                           dtype=dtype, device=device, gen=gen)

    def forward(self, x: torch.Tensor, ctx: Ctx, cache: dict | None = None,
                *, with_aux: bool = False):
        """Returns ``(x, aux)``: ``aux`` the MoE load-balancing loss when
        ``with_aux`` and the block has one, else None."""
        h = rmsnorm(self.ln1, x)
        if isinstance(self.attn, MLA):
            a, _ = mla_attention(self.attn, h, ctx, cache=cache)
        else:
            a, _ = attention(self.attn, h, ctx, causal=self.kind != "enc",
                             cache=cache,
                             use_rope=ctx.cfg.family != "audio")
        x = x + a
        h = rmsnorm(self.ln2, x)
        if self.kind == "moe":
            m, aux = self.moe(h, ctx, with_aux=with_aux)
            return x + m, aux
        return x + mlp(self.mlp, h, ctx), None


class DecCross(nn.Module):
    """Block kind ``"dec_cross"`` (Whisper's decoder): causal
    self-attention without RoPE (``ln1``, ``attn``; the layer's KV cache),
    cross-attention to the encoder's output (``ln_x``, ``xattn``; no cache,
    K and V projected from ``enc_out`` at every call, as the reference
    does), then the MLP (``ln2``, ``mlp``)."""

    kind = "dec_cross"

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        self.ln1 = Norm(cfg.d_model, dtype=dtype, device=device)
        self.attn = Attention(cfg, device=device, gen=gen)
        self.ln_x = Norm(cfg.d_model, dtype=dtype, device=device)
        self.xattn = Attention(cfg, device=device, gen=gen)
        self.ln2 = Norm(cfg.d_model, dtype=dtype, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, mlp_type=cfg.mlp_type,
                       dtype=dtype, device=device, gen=gen)

    def forward(self, x: torch.Tensor, ctx: Ctx, cache: dict | None = None,
                *, enc_out: torch.Tensor) -> torch.Tensor:
        a, _ = attention(self.attn, rmsnorm(self.ln1, x), ctx, cache=cache,
                         use_rope=False)
        x = x + a
        c, _ = attention(self.xattn, rmsnorm(self.ln_x, x), ctx,
                         kv_x=enc_out, causal=False, use_rope=False)
        x = x + c
        return x + mlp(self.mlp, rmsnorm(self.ln2, x), ctx)


class Encoder(nn.Module):
    """Whisper's encoder: ``n_enc_layers`` ``"enc"`` blocks and the final
    ``norm``."""

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(cfg, "enc", device=device, gen=gen)
            for _ in range(cfg.n_enc_layers))
        self.norm = Norm(cfg.d_model, dtype=torch_dtype(cfg.param_dtype),
                         device=device)


class Mamba2Block(nn.Module):
    """Block kind ``"mamba2"``: the pre-norm ``ln`` and the Mamba2
    ``mixer``, residual."""

    kind = "mamba2"

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        self.ln = Norm(cfg.d_model, dtype=torch_dtype(cfg.param_dtype),
                       device=device)
        self.mixer = Mamba2(cfg, device=device, gen=gen)

    def forward(self, x: torch.Tensor, ctx: Ctx,
                cache: dict | None = None) -> torch.Tensor:
        m, _ = mamba2_mixer(self.mixer, rmsnorm(self.ln, x), ctx,
                            state=cache)
        return x + m


class ZambaSuper(nn.Module):
    """Block kind ``"zamba_super"`` (zamba2): ``shared_attn_every``
    ``"mamba2"`` blocks, then the model's one shared attention + MLP block
    on ``in_proj`` ``(2d, d)`` of the hidden state concatenated with the
    embedded input ``x0`` (the reference's ``_shared_attn_block``)."""

    kind = "zamba_super"

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        self.mamba = nn.ModuleList(
            Mamba2Block(cfg, device=device, gen=gen)
            for _ in range(cfg.shared_attn_every))
        self.in_proj = Linear(2 * cfg.d_model, cfg.d_model,
                              dtype=torch_dtype(cfg.param_dtype),
                              device=device, gen=gen)

    def forward(self, x: torch.Tensor, ctx: Ctx, cache: dict | None, *,
                shared: Block, x0: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.mamba):
            x = blk(x, ctx, None if cache is None else cache["mamba"][j])
        u = linear(self.in_proj, torch.cat([x, x0], dim=-1), ctx)
        u, _ = shared(u, ctx, None if cache is None else cache["attn"])
        return x + u


def _make_block(cfg: ModelConfig, kind: str, *, device, gen) -> nn.Module:
    if kind in ("attn", "moe"):
        return Block(cfg, kind, device=device, gen=gen)
    if kind == "dec_cross":
        return DecCross(cfg, device=device, gen=gen)
    if kind == "mamba2":
        return Mamba2Block(cfg, device=device, gen=gen)
    if kind == "zamba_super":
        return ZambaSuper(cfg, device=device, gen=gen)
    if kind == "rwkv6":
        return RWKV6(cfg, device=device, gen=gen)
    raise ValueError(f"no block kind {kind!r} in the port")


class Transformer(nn.Module):
    """Embedding, the blocks of ``cfg.segments()`` (and zamba2's shared
    block, Whisper's encoder, the VLM's vision projection), final norm and
    LM head, at the reference's initial scales (``1/sqrt(d_in)`` for a
    linear, ``wo`` ``1/sqrt(n_heads * hd)``, the embedding and the head
    0.02), drawn with ``gen`` on ``device`` (left unset on the ``meta``
    device)."""

    def __init__(self, cfg: ModelConfig, *, device=None, gen=None) -> None:
        super().__init__()
        _check_ported(cfg)
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=dtype,
                               device=device, gen=gen)
        self.final_norm = Norm(cfg.d_model, dtype=dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Linear(cfg.d_model, cfg.vocab, scale=0.02,
                               dtype=dtype, device=device, gen=gen))
        self.layers = nn.ModuleList(
            _make_block(cfg, kind, device=device, gen=gen)
            for kind, repeat in cfg.segments() for _ in range(repeat))
        # zamba2: one attention + MLP block shared by every zamba_super
        self.shared_attn = (Block(cfg, "attn", device=device, gen=gen)
                            if cfg.family == "hybrid" else None)
        self.encoder = (Encoder(cfg, device=device, gen=gen)
                        if cfg.family == "audio" else None)
        self.vision_proj = (Linear(cfg.d_model, cfg.d_model, dtype=dtype,
                                   device=device, gen=gen)
                            if cfg.family == "vlm" else None)

    def forward(self, x: torch.Tensor, ctx: Ctx, caches: list | None = None,
                *, with_aux: bool = False, enc_out: torch.Tensor | None = None):
        """The embedded input ``x`` (B, S, d) through the layers: ``(x,
        aux)``, the hidden states after the last block (before the final
        norm) and, when ``with_aux``, the MoE load-balancing loss summed
        over the layers (float32; zero without MoE layers), else None.
        ``caches`` (one per layer) are written in place; ``enc_out`` is
        what Whisper's cross-attention reads."""
        x0 = x                    # what the shared block reads beside x
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        for i, block in enumerate(self.layers):
            cache = None if caches is None else caches[i]
            if block.kind == "zamba_super":
                x = block(x, ctx, cache, shared=self.shared_attn, x0=x0)
            elif block.kind == "dec_cross":
                x = block(x, ctx, cache, enc_out=enc_out)
            elif isinstance(block, Block):
                x, a = block(x, ctx, cache, with_aux=with_aux)
                if a is not None:
                    aux = aux + a
            else:
                x = block(x, ctx, cache)
        return x, aux


def init_params(seed: int, cfg: ModelConfig, *,
                device="cuda") -> Transformer:
    """The model with weights drawn from ``seed`` by a ``torch.Generator``
    on ``device`` itself (the reference's ``init_params(key, cfg)``): no
    host copy of the weights, which for llama3-8b in float32 are 32 GB.
    The same shapes and scales as the reference, not the same bits
    (:func:`from_reference` carries those across)."""
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
    return Transformer(cfg, device=device, gen=gen)


def from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    """The reference's parameter pytree (``repro.models.init_params``, its
    leaves as numpy arrays) as the port's model on ``device``.  The
    reference stacks each segment's per-layer parameters on a leading axis,
    a ``zamba_super``'s mamba blocks on a second one, and Whisper's encoder
    blocks on one; they are unstacked into the layer list (each super's
    ``mamba`` list, the encoder's ``blocks``) here."""
    device = resolve_device(device)
    model = Transformer(cfg, device="meta")
    state = {}

    def walk(node, prefix: str, idx: tuple = ()) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, f"{prefix}{key}.", idx)
            return
        state[prefix[:-1]] = np.asarray(node)[idx]

    for key, node in tree.items():
        if key == "segments":
            # segment si's item j is the layer at the segment's offset + j
            offset = 0
            for seg, (kind, repeat) in zip(node, cfg.segments(),
                                           strict=True):
                for j in range(repeat):
                    at = f"layers.{offset + j}."
                    if kind == "zamba_super":
                        walk(seg["in_proj"], f"{at}in_proj.", (j,))
                        for i in range(cfg.shared_attn_every):
                            walk(seg["mamba"], f"{at}mamba.{i}.", (j, i))
                    else:
                        walk(seg, at, (j,))
                offset += repeat
        elif key == "encoder":
            for j in range(cfg.n_enc_layers):
                walk(node["blocks"], f"encoder.blocks.{j}.", (j,))
            walk(node["norm"], "encoder.norm.")
        else:
            walk(node, f"{key}.")
    model.load_state_dict(
        {k: torch.tensor(v, device=device) for k, v in state.items()},
        strict=True, assign=True)
    return model


def param_count(params: Transformer) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# forward / serving
# ---------------------------------------------------------------------------

def _sinusoid(seq: int, d: int, offset: int = 0, *,
              device=None) -> torch.Tensor:
    """Whisper's sinusoid positions ``offset .. offset + seq - 1``: (seq,
    d), sines in the even columns and cosines in the odd ones, in float32
    (the reference's)."""
    pos = offset + torch.arange(seq, device=device,
                                dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / d))
    return torch.stack([torch.sin(pos * div), torch.cos(pos * div)],
                       dim=-1).reshape(seq, d)


def _run_encoder(params: Transformer, frames: torch.Tensor,
                 ctx: Ctx) -> torch.Tensor:
    """Whisper's encoder over the stub frame embeddings (B, enc_seq, d):
    sinusoid positions, the ``"enc"`` blocks, the final norm."""
    x = ctx.cast(frames)
    x = x + _sinusoid(x.shape[1], x.shape[2],
                      device=x.device).to(x.dtype)[None]
    for block in params.encoder.blocks:
        x, _ = block(x, ctx, None)
    return rmsnorm(params.encoder.norm, x)


def _embed_inputs(params: Transformer, batch: dict, ctx: Ctx) -> torch.Tensor:
    """The prompt embedded: the VLM's projected vision tokens ahead of the
    tokens, Whisper's tokens at sinusoid positions 0 onwards."""
    cfg = ctx.cfg
    x = embed(params.embed, batch["tokens"], ctx)
    if cfg.family == "vlm":
        vis = linear(params.vision_proj, batch["vision"].to(x.dtype), ctx)
        x = torch.cat([vis, x], dim=1)
    if cfg.family == "audio":
        x = x + _sinusoid(x.shape[1], x.shape[2],
                          device=x.device).to(x.dtype)[None]
    return x


def _encoded(params: Transformer, batch: dict, ctx: Ctx, enc_out):
    """Whisper's encoder output: ``enc_out`` when the caller has it, else
    the encoder run on ``batch["frames"]``; None for the other families."""
    if ctx.cfg.family != "audio" or enc_out is not None:
        return enc_out
    return _run_encoder(params, batch["frames"], ctx)


def _logits(params: Transformer, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    x = rmsnorm(params.final_norm, x)
    if params.lm_head is not None:
        w = ctx.cast(params.lm_head.w)
    else:
        w = ctx.cast(params.embed.table).T
    return routed_matmul(x, w, ctx)


def forward(params: Transformer, batch: dict, cfg: ModelConfig, *,
            runtime=None):
    """batch: {tokens (B, S); Whisper's frames (B, enc_seq, d) or the VLM's
    vision (B, vision_tokens, d)} → (logits (B, S', V), aux), S' counting
    the VLM's vision tokens too.  ``runtime`` — the AdsalaRuntime serving
    the routed matmuls' knob decisions when the config routes (None → the
    process-global runtime).  ``aux`` is the reference's MoE
    load-balancing loss summed over the layers, zero without MoE layers."""
    ctx = Ctx(cfg, runtime)
    x = _embed_inputs(params, batch, ctx)
    x, aux = params(x, ctx, with_aux=True,
                    enc_out=_encoded(params, batch, ctx, None))
    return _logits(params, x, ctx), aux


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda") -> list:
    """One cache per layer, zeroed on ``device``, by block kind: an
    attention block's ``{k, v: (batch, max_len, kv_heads, hd); len}`` (a
    ``"dec_cross"`` block's self-attention's; its cross-attention has
    none), or MLA's latent cache ``{c_kv, k_rope, len}`` (``models/mla.py``)
    where the config has ``use_mla``; a ``"mamba2"`` block's state ``{ssm,
    conv}`` (``models/mamba2.py``); a ``"zamba_super"``'s ``{mamba: [one
    state a mamba block], attn: its own KV cache for the shared block}``;
    an ``"rwkv6"`` layer's ``{tm_prev, cm_prev, S}`` (``models/rwkv6.py``).
    The VLM's ``max_len`` must hold its vision tokens too."""
    _check_ported(cfg)
    device = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.hd())

    def one(kind: str):
        if kind in ("attn", "moe", "dec_cross"):
            if cfg.use_mla and kind != "dec_cross":
                return init_mla_cache(cfg, batch, max_len, dtype, device)
            return {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device),
                    "len": 0}
        if kind == "mamba2":
            return init_mamba2_state(cfg, batch, dtype, device)
        if kind == "rwkv6":
            return init_rwkv6_state(cfg, batch, dtype, device)
        # zamba_super: its blocks' states and its own KV cache
        return {"mamba": [one("mamba2")
                          for _ in range(cfg.shared_attn_every)],
                "attn": one("attn")}

    return [one(kind) for kind, repeat in cfg.segments()
            for _ in range(repeat)]


def prefill(params: Transformer, batch: dict, caches: list,
            cfg: ModelConfig, *, runtime=None, enc_out=None):
    """Run the prompt (the batch of :func:`forward`) through the model
    filling the caches (in place).  Returns (last-token logits (B, 1, V),
    caches).  Whisper's encoder runs on ``batch["frames"]`` unless the
    caller passes its output as ``enc_out``."""
    ctx = Ctx(cfg, runtime)
    x = _embed_inputs(params, batch, ctx)
    x, _ = params(x, ctx, caches, enc_out=_encoded(params, batch, ctx,
                                                   enc_out))
    return _logits(params, x[:, -1:], ctx), caches


def decode_step(params: Transformer, token: torch.Tensor, caches: list,
                cfg: ModelConfig, *, runtime=None, enc_out=None, pos: int = 0):
    """One-token step. token: (B, 1) → (logits (B, 1, V), caches), the
    caches written in place.  Whisper needs the encoder's output
    ``enc_out`` and the token's absolute position ``pos`` (its sinusoid
    offset); the other families read positions from the cache."""
    ctx = Ctx(cfg, runtime)
    x = embed(params.embed, token, ctx)
    if cfg.family == "audio":
        if enc_out is None:
            raise ValueError("whisper decode needs enc_out from prefill")
        x = x + _sinusoid(1, x.shape[2], pos,
                          device=x.device).to(x.dtype)[None]
    x, _ = params(x, ctx, caches, enc_out=enc_out)
    return _logits(params, x, ctx), caches
