"""Model assembler of every family of the reference package's
``models/transformer.py`` (dense, MoE, hybrid, SSM, audio and VLM), with
the reference's functions over them: ``init_params``, ``forward``,
``loss_fn``, ``init_decode_state``, ``prefill``, ``decode_step`` and
``param_count``; :func:`from_reference`, which carries the reference's
parameter pytree across, its inverse :func:`to_reference` (parameters or
gradients as the reference's stacked tree), and
:func:`adamw_state_from_reference`, which carries an optimiser state.

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

Under autograd the layer loop recomputes activations as ``cfg.remat``
says, through ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): ``"block"`` checkpoints every block, ``"dots"``
keeps the outputs of the matmuls without batch axes and recomputes the
rest, and ``"nested"`` checkpoints groups of blocks whose blocks are each
checkpointed again (:func:`_scan_stack`), so only one activation a group
outlives the forward pass.  Remat changes memory, never numbers.

``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take ``mesh=``
and ``rules=`` as the reference's do: the parameters, the batch and the
caches then DTensors on the mesh, the activations laid out by the rules
between the blocks (``models/sharding.py``, ``Ctx``).

Whisper's encoder (``encoder``: ``"enc"`` blocks and a norm) reads stub
frame embeddings with sinusoid positions, and its decoder embeds tokens at
sinusoid positions too; the VLM's ``vision_proj`` maps stub patch
embeddings into the token stream ahead of the prompt.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.optim import AdamWState

from .layers import (MLP, Attention, Ctx, Embedding, Linear, Norm,
                     attention, chunked_cross_entropy, cross_entropy, embed,
                     linear, mlp, rmsnorm, routed_matmul, torch_dtype)
from .mamba2 import Mamba2, init_mamba2_state, mamba2_mixer
from .mla import MLA, init_mla_cache, mla_attention
from .moe import MoE
from .rwkv6 import RWKV6, init_rwkv6_state
from .sharding import DEFAULT_RULES

__all__ = ["Block", "DecCross", "Encoder", "Mamba2Block", "ZambaSuper",
           "Transformer", "init_params", "forward", "loss_fn",
           "init_decode_state", "prefill", "decode_step", "param_count",
           "from_reference", "to_reference", "adamw_state_from_reference"]

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
        remat = (ctx.cfg.remat if caches is None and torch.is_grad_enabled()
                 else "none")

        def body(x, aux, i):
            block = self.layers[i]
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
            # the inter-block activation layout (SP shards seq here)
            return ctx.cons(x, "batch", "seq", "embed"), aux

        offset = 0
        for _, repeat in ctx.cfg.segments():
            x, aux = _scan_stack(body, x, aux,
                                 range(offset, offset + repeat), remat)
            offset += repeat
        return x, aux


#: the ops whose outputs ``remat="dots"`` keeps: the matmuls without batch
#: axes (the reference's ``dots_with_no_batch_dims_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, remat: str):
    """``fn`` under ``torch.utils.checkpoint`` as ``remat`` says (the
    reference's ``_maybe_remat``): as it is for ``"none"``, saving only the
    matmuls without batch axes for ``"dots"``, else recomputed whole."""
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _nest_factors(repeat: int) -> tuple[int, int]:
    """Factor repeat = r1·r2 minimising r1+r2 (nested remat grouping)."""
    best = (1, repeat)
    for a in range(2, int(math.isqrt(repeat)) + 1):
        if repeat % a == 0:
            best = (repeat // a, a)
    return best


def _scan_stack(body, x, aux, layers: range, remat: str):
    """``x, aux = body(x, aux, i)`` for each layer ``i`` of one segment, with
    the remat scheme ``remat``.  ``"nested"`` at 8 or more layers that
    factor as r1 groups of r2: each group is checkpointed and each block in
    it again, so r1 group inputs outlive the forward pass instead of one a
    layer (the reference's two-level scan)."""
    if remat == "nested" and len(layers) >= 8:
        r1, r2 = _nest_factors(len(layers))
        if r1 > 1 and r2 > 1:
            inner = _maybe_remat(body, "block")

            def group(x, aux, g):
                for i in layers[g * r2:(g + 1) * r2]:
                    x, aux = inner(x, aux, i)
                return x, aux

            outer = _maybe_remat(group, "block")
            for g in range(r1):
                x, aux = outer(x, aux, g)
            return x, aux
    fn = _maybe_remat(body, remat)
    for i in layers:
        x, aux = fn(x, aux, i)
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


def _reference_slot(cfg: ModelConfig, key: str) -> tuple[tuple, tuple]:
    """Where the port's parameter ``key`` lives in the reference's pytree:
    the path of keys to its stacked leaf, and its index there.  The
    reference stacks each segment's per-layer parameters on a leading
    axis, a ``zamba_super``'s mamba blocks on a second one, and Whisper's
    encoder blocks on one; the port holds them as the layer list (each
    super's ``mamba`` list, the encoder's ``blocks``)."""
    parts = key.split(".")
    if parts[0] == "layers":
        i, rest = int(parts[1]), parts[2:]
        offset = 0
        for si, (kind, repeat) in enumerate(cfg.segments()):
            if i < offset + repeat:
                break
            offset += repeat
        if kind == "zamba_super" and rest[0] == "mamba":
            return ("segments", si, "mamba", *rest[2:]), \
                (i - offset, int(rest[1]))
        return ("segments", si, *rest), (i - offset,)
    if parts[:2] == ["encoder", "blocks"]:
        return ("encoder", "blocks", *parts[3:]), (int(parts[2]),)
    return tuple(parts), ()


def _leaf_paths(tree, path: tuple = ()):
    if isinstance(tree, dict):
        for key, child in tree.items():
            yield from _leaf_paths(child, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaf_paths(child, path + (i,))
    else:
        yield path


def _named_from_reference(cfg: ModelConfig, tree, device) -> dict:
    """A pytree shaped like the reference's parameters (its leaves numpy
    arrays) as a dict of tensors on ``device`` keyed by the port's
    parameter names.  Raises unless every leaf of ``tree`` is used."""
    device = resolve_device(device)
    out, used = {}, set()
    for key in Transformer(cfg, device="meta").state_dict():
        path, idx = _reference_slot(cfg, key)
        node = tree
        for k in path:
            node = node[k]
        out[key] = torch.tensor(np.asarray(node)[idx], device=device)
        used.add(path)
    extra = set(_leaf_paths(tree)) - used
    if extra:
        raise ValueError(f"reference leaves the port has no parameter for: "
                         f"{sorted(map(str, extra))}")
    return out


def from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    """The reference's parameter pytree (``repro.models.init_params``, its
    leaves as numpy arrays) as the port's model on ``device``."""
    model = Transformer(cfg, device="meta")
    model.load_state_dict(_named_from_reference(cfg, tree, device),
                          strict=True, assign=True)
    return model


def to_reference(cfg: ModelConfig, named: dict) -> dict:
    """The inverse of :func:`from_reference`: tensors keyed by the port's
    parameter names (a model's parameters, or their gradients) as the
    reference's stacked pytree of numpy arrays."""
    tree: dict = {}
    for key, t in named.items():
        path, idx = _reference_slot(cfg, key)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        arr = t.detach().cpu().numpy()
        if idx:
            node.setdefault(path[-1], {})[idx] = arr
        else:
            node[path[-1]] = arr

    def stacked(node):
        if not isinstance(node, dict):
            return node
        if all(isinstance(k, tuple) for k in node):      # per-layer slices
            idx = sorted(node)
            first = node[idx[0]]
            shape = tuple(max(i[d] for i in idx) + 1
                          for d in range(len(idx[0])))
            out = np.empty(shape + first.shape, first.dtype)
            for i in idx:
                out[i] = node[i]
            return out
        out = {k: stacked(v) for k, v in node.items()}
        if all(isinstance(k, int) for k in out):          # the segments
            return [out[k] for k in sorted(out)]
        return out

    return stacked(tree)


def adamw_state_from_reference(cfg: ModelConfig, state,
                               device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (its step and its moments' pytrees as
    numpy arrays) as the port's, its moments keyed by parameter name on
    ``device``, so a reference run resumes in the port."""
    device = resolve_device(device)
    return AdamWState(
        step=torch.tensor(np.asarray(state.step), dtype=torch.int32,
                          device=device),
        mu=_named_from_reference(cfg, state.mu, device),
        nu=_named_from_reference(cfg, state.nu, device))


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
    x = x + ctx.replicate(_sinusoid(x.shape[1], x.shape[2],
                                    device=x.device).to(x.dtype)[None])
    remat = ctx.cfg.remat if torch.is_grad_enabled() else "none"

    def body(x, block):
        return block(x, ctx, None)[0]

    body = _maybe_remat(body, remat)
    for block in params.encoder.blocks:
        x = body(x, block)
    return rmsnorm(params.encoder.norm, x)


def _embed_inputs(params: Transformer, batch: dict, ctx: Ctx) -> torch.Tensor:
    """The prompt embedded: the VLM's projected vision tokens ahead of the
    tokens, Whisper's tokens at sinusoid positions 0 onwards."""
    cfg = ctx.cfg
    x = embed(params.embed, batch["tokens"], ctx)
    if cfg.family == "vlm":
        vis = linear(params.vision_proj, batch["vision"].to(x.dtype), ctx)
        x = ctx.cons(torch.cat([vis, x], dim=1), "batch", "seq", "embed")
    if cfg.family == "audio":
        x = x + ctx.replicate(_sinusoid(x.shape[1], x.shape[2],
                                        device=x.device).to(x.dtype)[None])
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
    return ctx.cons(routed_matmul(x, w, ctx), "batch", None, "vocab")


def forward(params: Transformer, batch: dict, cfg: ModelConfig, *,
            mesh=None, rules=None, runtime=None):
    """batch: {tokens (B, S); Whisper's frames (B, enc_seq, d) or the VLM's
    vision (B, vision_tokens, d)} → (logits (B, S', V), aux), S' counting
    the VLM's vision tokens too.  ``runtime`` — the AdsalaRuntime serving
    the routed matmuls' knob decisions when the config routes (None → the
    process-global runtime).  ``aux`` is the reference's MoE
    load-balancing loss summed over the layers, zero without MoE layers.
    Under ``mesh`` (a ``DeviceMesh``; the parameters and the batch
    DTensors on it) the activations are laid out by ``rules`` (default
    ``DEFAULT_RULES``)."""
    ctx = Ctx(cfg, runtime, mesh, rules or DEFAULT_RULES)
    x = _embed_inputs(params, batch, ctx)
    x, aux = params(x, ctx, with_aux=True,
                    enc_out=_encoded(params, batch, ctx, None))
    return _logits(params, x, ctx), aux


def loss_fn(params: Transformer, batch: dict, cfg: ModelConfig, *,
            mesh=None, rules=None, runtime=None, moe_aux_coef: float = 0.01):
    """The training loss of ``batch`` ({tokens, labels (B, S); Whisper's
    frames or the VLM's vision as in :func:`forward`}): the mean next-token
    CE over the labels >= 0 (the VLM's vision positions carry none) plus
    ``moe_aux_coef`` times the MoE load-balancing loss.  Returns ``(loss,
    {"ce", "moe_aux"})``.  With ``cfg.ce_chunk`` the LM head and the CE
    run fused over sequence chunks (:func:`chunked_cross_entropy`).
    ``mesh`` and ``rules`` as in :func:`forward`.

    Raises ``ValueError`` for a config that routes its matmuls through the
    tuned GEMM (``use_pallas_gemm``) when gradients are to flow: the GEMM
    kernel has no backward, nor has the reference's Pallas GEMM, whose
    training step never routes."""
    if cfg.use_pallas_gemm and torch.is_grad_enabled() and any(
            p.requires_grad for p in params.parameters()):
        raise ValueError(
            f"{cfg.name}: use_pallas_gemm routes the matmuls through the "
            f"tuned GEMM kernel, which has no backward (nor has the "
            f"reference's); train with use_pallas_gemm=False")
    ctx = Ctx(cfg, runtime, mesh, rules or DEFAULT_RULES)
    x = _embed_inputs(params, batch, ctx)
    x, aux = params(x, ctx, with_aux=True,
                    enc_out=_encoded(params, batch, ctx, None))
    labels = batch["labels"]
    if cfg.family == "vlm":   # the vision prefix carries no LM loss
        pad = torch.full(batch["vision"].shape[:2], -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([ctx.cons(ctx.replicate(pad), "batch", None),
                            labels], dim=1)
    # the loss reads whole sequences (its chunks slice them)
    x = ctx.cons(rmsnorm(params.final_norm, x), "batch", None, "embed")
    w = (ctx.cast(params.lm_head.w) if params.lm_head is not None
         else ctx.cast(params.embed.table).T)
    # the head's FSDP shards gathered (vocab-parallel logits, batch-local
    # rows), as GSPMD gathers an FSDP weight ahead of its matmul
    w = ctx.cons(w, None, "vocab")
    if cfg.ce_chunk:
        ce = chunked_cross_entropy(x, w, labels, chunk=cfg.ce_chunk)
    else:
        ce = cross_entropy(ctx.cons(x @ w, "batch", "seq", "vocab"), labels)
    return ce + moe_aux_coef * aux, {"ce": ce, "moe_aux": aux}


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
            cfg: ModelConfig, *, mesh=None, rules=None, runtime=None,
            enc_out=None):
    """Run the prompt (the batch of :func:`forward`) through the model
    filling the caches (in place).  Returns (last-token logits (B, 1, V),
    caches).  Whisper's encoder runs on ``batch["frames"]`` unless the
    caller passes its output as ``enc_out``.  ``mesh`` and ``rules`` as in
    :func:`forward`; the caches then DTensors laid out by
    ``launch/specs.py::cache_specs``."""
    ctx = Ctx(cfg, runtime, mesh, rules or DEFAULT_RULES)
    x = _embed_inputs(params, batch, ctx)
    x, _ = params(x, ctx, caches, enc_out=_encoded(params, batch, ctx,
                                                   enc_out))
    x = ctx.cons(x, "batch", None, "embed")         # whole rows to slice
    return _logits(params, x[:, -1:], ctx), caches


def decode_step(params: Transformer, token: torch.Tensor, caches: list,
                cfg: ModelConfig, *, mesh=None, rules=None, runtime=None,
                enc_out=None, pos: int = 0):
    """One-token step. token: (B, 1) → (logits (B, 1, V), caches), the
    caches written in place.  Whisper needs the encoder's output
    ``enc_out`` and the token's absolute position ``pos`` (its sinusoid
    offset); the other families read positions from the cache.  ``mesh``
    and ``rules`` as in :func:`prefill`."""
    ctx = Ctx(cfg, runtime, mesh, rules or DEFAULT_RULES)
    x = embed(params.embed, token, ctx)
    if cfg.family == "audio":
        if enc_out is None:
            raise ValueError("whisper decode needs enc_out from prefill")
        x = x + ctx.replicate(_sinusoid(1, x.shape[2], pos,
                                        device=x.device).to(x.dtype)[None])
    x, _ = params(x, ctx, caches, enc_out=enc_out)
    return _logits(params, x, ctx), caches
