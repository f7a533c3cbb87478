"""Model assembler of the dense and MoE families (the ``"attn"`` and
``"moe"`` block kinds of the reference package's ``models/transformer.py``):
pre-LN blocks in an ``nn.ModuleList``, attention (GQA, or MLA where the
config has ``use_mla``) followed by an MLP or an MoE FFN, with the
reference's functions over them: ``init_params``, ``forward``,
``init_decode_state``, ``prefill``, ``decode_step`` and ``param_count``,
and :func:`from_reference`, which carries the reference's parameter pytree
across.

Where the reference scans each segment's layers over parameters stacked on
a leading axis, the port holds one module per layer, the segments of
``cfg.segments()`` in order, and loops over them.  Decode caches are one
dict per layer, written in place.

The other families (Mamba2, RWKV6, the zamba2 hybrid, Whisper's encoder
and cross-attention, the VLM's vision projection) are later slices of the
port: they raise ``NotImplementedError`` rather than run something else.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import (MLP, Attention, Ctx, Embedding, Linear, Norm,
                     attention, embed, mlp, rmsnorm, routed_matmul,
                     torch_dtype)
from .mla import MLA, init_mla_cache, mla_attention
from .moe import MoE

__all__ = ["Block", "Transformer", "init_params", "forward",
           "init_decode_state", "prefill", "decode_step", "param_count",
           "from_reference"]

#: what each unported family waits for (ROADMAP.md Queue 1 item 8, in its
#: order)
_UNPORTED = {
    "hybrid": "the Mamba2 mixer and zamba2's shared block",
    "ssm": "the RWKV6 block",
    "audio": "Whisper's encoder and cross-attention",
    "vlm": "the VLM's vision projection",
}
#: the block kinds the port runs
_KINDS = ("attn", "moe")


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for a config the port cannot run yet."""
    what = _UNPORTED.get(cfg.family)
    if what is None and any(kind not in _KINDS
                            for kind, _ in cfg.segments()):
        what = f"block kinds {cfg.segments()}"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) needs {what}, not ported yet: "
            f"ROADMAP.md Queue 1 item 8 (the dense and moe families are "
            f"ported)")


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
        if kind not in _KINDS:
            raise ValueError(f"no block kind {kind!r} in the port")
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
        """Returns ``(x, cache, aux)``: ``aux`` the MoE load-balancing loss
        when ``with_aux`` and the block has one, else None."""
        attend = mla_attention if isinstance(self.attn, MLA) else attention
        a, cache = attend(self.attn, rmsnorm(self.ln1, x), ctx, cache=cache)
        x = x + a
        h = rmsnorm(self.ln2, x)
        if self.kind == "moe":
            m, aux = self.moe(h, ctx, with_aux=with_aux)
            return x + m, cache, aux
        return x + mlp(self.mlp, h, ctx), cache, None


class Transformer(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and LM head, at the
    reference's initial scales (``1/sqrt(d_in)`` for a linear, ``wo``
    ``1/sqrt(n_heads * hd)``, the embedding and the head 0.02), drawn with
    ``gen`` on ``device`` (left unset on the ``meta`` device)."""

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
            Block(cfg, kind, device=device, gen=gen)
            for kind, repeat in cfg.segments() for _ in range(repeat))

    def forward(self, tokens: torch.Tensor, ctx: Ctx,
                caches: list | None = None, *, with_aux: bool = False):
        """``(x, aux)``: the hidden states after the last block (before the
        final norm) and, when ``with_aux``, the MoE load-balancing loss
        summed over the layers (float32; zero without MoE layers), else
        None.  ``caches`` (one dict per layer) are written in place."""
        x = embed(self.embed, tokens, ctx)
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        for i, block in enumerate(self.layers):
            x, _, a = block(x, ctx, None if caches is None else caches[i],
                            with_aux=with_aux)
            if a is not None:
                aux = aux + a
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
    reference stacks each segment's per-layer parameters on a leading axis;
    they are unstacked into the layer list here."""
    device = resolve_device(device)
    model = Transformer(cfg, device="meta")
    state = {}

    def walk(node, prefix: str, layer: int | None = None) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, f"{prefix}{key}.", layer)
            return
        arr = np.asarray(node)
        state[prefix[:-1]] = arr if layer is None else arr[layer]

    for key, node in tree.items():
        if key == "segments":
            # segment si's item j is the layer at the segment's offset + j
            offset = 0
            for seg, (_, repeat) in zip(node, cfg.segments(), strict=True):
                for j in range(repeat):
                    walk(seg, f"layers.{offset + j}.", j)
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
    """One cache per layer, zeroed on ``device``: ``{k, v: (batch, max_len,
    kv_heads, hd); len}``, or MLA's latent cache ``{c_kv, k_rope, len}``
    (``models/mla.py``) where the config has ``use_mla``."""
    _check_ported(cfg)
    device = resolve_device(device)
    if cfg.use_mla:
        return [init_mla_cache(cfg, batch, max_len, dtype, device)
                for _ in range(cfg.n_layers)]
    shape = (batch, max_len, cfg.kv_heads, cfg.hd())
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}
            for _ in range(cfg.n_layers)]


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
