"""Model assembler of the dense, MoE, hybrid and SSM families (the block
kinds ``"attn"``, ``"moe"``, ``"mamba2"``, ``"zamba_super"`` and ``"rwkv6"``
of the reference package's ``models/transformer.py``), with the reference's
functions over them: ``init_params``, ``forward``, ``init_decode_state``,
``prefill``, ``decode_step`` and ``param_count``, and
:func:`from_reference`, which carries the reference's parameter pytree
across.

Block kinds:
  attn        pre-LN attention (GQA, or MLA) + MLP     (dense)
  moe         pre-LN attention (GQA or MLA) + MoE      (granite-moe, deepseek)
  mamba2      pre-LN Mamba2 mixer                      (zamba2's tail)
  zamba_super k x mamba2 + the one SHARED attn+MLP block (zamba2)
  rwkv6       the self-contained RWKV6 layer           (rwkv6)

Where the reference scans each segment's layers over parameters stacked on
a leading axis, the port holds one module per layer, the segments of
``cfg.segments()`` in order, and loops over them.  Decode caches are one
per layer (a KV or latent cache, a Mamba2 or RWKV6 state, or a
``zamba_super``'s states and KV cache), written in place.

Whisper's encoder and cross-attention and the VLM's vision projection are
later slices of the port: those families raise ``NotImplementedError``
rather than run something else.
"""

from __future__ import annotations

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

__all__ = ["Block", "Mamba2Block", "ZambaSuper", "Transformer",
           "init_params", "forward", "init_decode_state", "prefill",
           "decode_step", "param_count", "from_reference"]

#: what each unported family waits for (ROADMAP.md Queue 1 item 8, in its
#: order)
_UNPORTED = {
    "audio": "Whisper's encoder and cross-attention",
    "vlm": "the VLM's vision projection",
}
#: the block kinds the port runs
_KINDS = ("attn", "moe", "mamba2", "zamba_super", "rwkv6")


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for a config the port cannot run yet."""
    what = _UNPORTED.get(cfg.family)
    if what is None and any(kind not in _KINDS
                            for kind, _ in cfg.segments()):
        what = f"block kinds {cfg.segments()}"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) needs {what}, not ported yet: "
            f"ROADMAP.md Queue 1 item 8 (the dense, moe, hybrid and ssm "
            f"families are ported)")


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
    kind ``"attn"``) or an MoE FFN (``"moe"``)."""

    def __init__(self, cfg: ModelConfig, kind: str = "attn", *, device=None,
                 gen=None) -> None:
        super().__init__()
        if kind not in ("attn", "moe"):
            raise ValueError(f"no attention block kind {kind!r}")
        self.kind = kind
        dtype = torch_dtype(cfg.param_dtype)
        self.ln1 = Norm(cfg.d_model, dtype=dtype, device=device)
        self.attn = (MLA(cfg, device=device, gen=gen) if cfg.use_mla
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
        attend = mla_attention if isinstance(self.attn, MLA) else attention
        a, _ = attend(self.attn, rmsnorm(self.ln1, x), ctx, cache=cache)
        x = x + a
        h = rmsnorm(self.ln2, x)
        if self.kind == "moe":
            m, aux = self.moe(h, ctx, with_aux=with_aux)
            return x + m, aux
        return x + mlp(self.mlp, h, ctx), None


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
    if kind == "mamba2":
        return Mamba2Block(cfg, device=device, gen=gen)
    if kind == "zamba_super":
        return ZambaSuper(cfg, device=device, gen=gen)
    if kind == "rwkv6":
        return RWKV6(cfg, device=device, gen=gen)
    raise ValueError(f"no block kind {kind!r} in the port")


class Transformer(nn.Module):
    """Embedding, the blocks of ``cfg.segments()`` (and zamba2's shared
    block), final norm and LM head, at the reference's initial scales
    (``1/sqrt(d_in)`` for a linear, ``wo`` ``1/sqrt(n_heads * hd)``, the
    embedding and the head 0.02), drawn with ``gen`` on ``device`` (left
    unset on the ``meta`` device)."""

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

    def forward(self, tokens: torch.Tensor, ctx: Ctx,
                caches: list | None = None, *, with_aux: bool = False):
        """``(x, aux)``: the hidden states after the last block (before the
        final norm) and, when ``with_aux``, the MoE load-balancing loss
        summed over the layers (float32; zero without MoE layers), else
        None.  ``caches`` (one per layer) are written in place."""
        x = embed(self.embed, tokens, ctx)
        x0 = x                    # what the shared block reads beside x
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        for i, block in enumerate(self.layers):
            cache = None if caches is None else caches[i]
            if block.kind == "zamba_super":
                x = block(x, ctx, cache, shared=self.shared_attn, x0=x0)
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
    and a ``zamba_super``'s mamba blocks on a second one; they are
    unstacked into the layer list (and each super's ``mamba`` list)
    here."""
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

def _logits(params: Transformer, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    x = rmsnorm(params.final_norm, x)
    if params.lm_head is not None:
        w = ctx.cast(params.lm_head.w)
    else:
        w = ctx.cast(params.embed.table).T
    return routed_matmul(x, w, ctx)


def forward(params: Transformer, batch: dict, cfg: ModelConfig, *,
            runtime=None):
    """batch: {tokens (B, S)} → (logits (B, S, V), aux).  ``runtime`` —
    the AdsalaRuntime serving the routed matmuls' knob decisions when the
    config routes (None → the process-global runtime).  ``aux`` is the
    reference's MoE load-balancing loss summed over the layers, zero for
    the dense family."""
    ctx = Ctx(cfg, runtime)
    x, aux = params(batch["tokens"], ctx, with_aux=True)
    return _logits(params, x, ctx), aux


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda") -> list:
    """One cache per layer, zeroed on ``device``, by block kind: an
    attention block's ``{k, v: (batch, max_len, kv_heads, hd); len}``, or
    MLA's latent cache ``{c_kv, k_rope, len}`` (``models/mla.py``) where the
    config has ``use_mla``; a ``"mamba2"`` block's state ``{ssm, conv}``
    (``models/mamba2.py``); a ``"zamba_super"``'s ``{mamba: [one state a
    mamba block], attn: its own KV cache for the shared block}``; an
    ``"rwkv6"`` layer's ``{tm_prev, cm_prev, S}`` (``models/rwkv6.py``)."""
    _check_ported(cfg)
    device = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.hd())

    def one(kind: str):
        if kind in ("attn", "moe"):
            if cfg.use_mla:
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
            cfg: ModelConfig, *, runtime=None):
    """Run the prompt through the model filling the caches (in place).
    Returns (last-token logits (B, 1, V), caches)."""
    ctx = Ctx(cfg, runtime)
    x, _ = params(batch["tokens"], ctx, caches)
    return _logits(params, x[:, -1:], ctx), caches


def decode_step(params: Transformer, token: torch.Tensor, caches: list,
                cfg: ModelConfig, *, runtime=None):
    """One-token step. token: (B, 1) → (logits (B, 1, V), caches), the
    caches written in place."""
    ctx = Ctx(cfg, runtime)
    x, _ = params(token, ctx, caches)
    return _logits(params, x, ctx), caches
