"""Sharding-spec assignment for params, optimizer state, caches and inputs
(the reference package's ``launch/specs.py``).

Params are classified by path (suffix patterns) into column-parallel,
row-parallel, expert, embedding, … logical layouts; ``logical_spec`` then
maps logical names → mesh axes under the active :class:`ShardingRules` and
silently degrades to replication where a dim doesn't divide (MQA kv=1,
odd vocab sizes).

The reference stacks each segment's layers on leading axes, which are
always unsharded; the port holds one module a layer (``layers.1.attn.wq.w``)
and has no such axes.  A port parameter is classified under its
reference path (``models/transformer.py::_reference_slot``,
``segments/0/attn/wq/w``) with the stack dims counted in, and its spec is
the reference's without those leading ``None``s.  Caches are per layer
too, and their specs are the reference's trailing entries.

Serve-time KV caches choose between head-sharding (kv_heads divisible by the
model axis) and sequence-sharding (the SP fallback for MQA/low-kv archs and
the MLA latent cache) — decided per-arch at spec time.

Every function here reads only the mesh's dim names and sizes: a
``DeviceMesh`` or a shape-only :class:`~repro_torch.models.sharding.
AbstractMesh`.  The ``abstract_*`` builders make the model and caches on
the ``meta`` device and allocate nothing.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, Shape
from repro_torch.models.sharding import (DEFAULT_RULES, MULTIPOD_RULES,
                                         AbstractTensor, PartitionSpec,
                                         ShardingRules, logical_spec,
                                         map_tensors, mesh_axis_size,
                                         mesh_shape)

__all__ = ["param_logical_names", "param_specs", "cache_logical_names",
           "cache_leaf_spec", "cache_specs", "input_specs", "rules_for",
           "total_params", "abstract_params", "abstract_train_state",
           "abstract_caches"]

_ROW_PARALLEL = ("wo", "wd", "w2", "out_proj", "cm_wv")
_REPLICATED_SUFFIX = ("scale", "bias", "b", "A_log", "D", "dt_bias", "u",
                      "mu", "mu_x", "w0", "ln_scale", "ln_bias", "cm_mu_k",
                      "cm_mu_r")


def rules_for(mesh, shape_kind: str,
              cfg: ModelConfig | None = None) -> ShardingRules:
    """Default rules per execution kind: train uses FSDP over 'data' and
    Megatron-style sequence parallelism (seq → 'model' between blocks);
    serve keeps weights replicated across 'data' (no per-step gather)
    UNLESS the bf16 weights would exceed ~6 GB a device under TP alone
    (internvl2-76b), in which case serve keeps the FSDP axis and pays the
    per-layer gather."""
    model_n = mesh_shape(mesh)["model"]
    base = (MULTIPOD_RULES if "pod" in mesh.mesh_dim_names
            else DEFAULT_RULES)
    if cfg is not None and cfg.n_heads % model_n != 0:
        # heads can't shard over TP → partition attention compute by batch
        # over ('data','model') instead of replicating it model-axis-wide
        base = base.replace(batch_attn=base.axes_for("batch") + ("model",))
    if cfg is not None and cfg.n_experts and cfg.n_experts % model_n != 0:
        # experts can't shard over TP → slot-parallel expert compute
        base = base.replace(expert_cap=("model",))
    if shape_kind in ("train", "prefill"):
        base = base.replace(seq=("model",))
    if shape_kind in ("prefill", "decode"):
        keep_fsdp = False
        if cfg is not None:
            per_chip = (2 * total_params(cfg)) / model_n
            keep_fsdp = per_chip > 6e9
        if not keep_fsdp:
            base = base.replace(embed_fsdp=())
    return base


def total_params(cfg: ModelConfig) -> int:
    """Approximate TOTAL parameter count (all experts for MoE)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd = cfg.hd()
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    attn = d * cfg.n_heads * hd + 2 * d * cfg.kv_heads * hd + \
        cfg.n_heads * hd * d
    if cfg.use_mla:
        attn = (d * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                + d * (cfg.kv_lora + cfg.qk_rope_dim)
                + cfg.kv_lora * cfg.n_heads *
                (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
    if cfg.family == "ssm":
        per = 5 * d * d + 2 * d * cfg.d_ff
    elif cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        per = 2 * d * d_in + d_in * d
    elif cfg.n_experts:
        ff = 3 * d * (cfg.moe_d_ff or cfg.d_ff) * \
            (cfg.n_experts + cfg.n_shared_experts)
        per = attn + ff
    else:
        ff = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
        per = attn + ff
    total = emb + L * per
    if cfg.family == "audio":
        total += cfg.n_enc_layers * (4 * d * d + 2 * d * cfg.d_ff)
    return int(total)


def param_logical_names(path: str, ndim: int) -> tuple:
    """Trailing logical axis names for a param leaf at the reference path
    ``path`` (``/``-joined) whose stacked form has ``ndim`` dims."""
    parts = path.split("/")
    leafname = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    if path.endswith("embed/table"):
        return ("vocab", "embed_fsdp")
    if path.endswith("lm_head/w"):
        return ("embed_fsdp", "vocab")
    if parent == "moe" or (len(parts) > 1 and parts[-1] in
                           ("wg", "wu", "wd") and ndim == 3):
        if leafname in ("wg", "wu"):
            return ("experts", "embed_fsdp", "expert_mlp")
        if leafname == "wd":
            return ("experts", "expert_mlp", "embed_fsdp")
    if leafname == "conv_w":
        return (None, "ssm_inner")
    if leafname == "conv_b":
        return ("ssm_inner",)
    if leafname in _REPLICATED_SUFFIX or "lora" in leafname:
        return (None,) * min(ndim, 3)
    if leafname == "w":
        if parent in _ROW_PARALLEL:
            return ("o_in", "embed_fsdp")
        if parent == "wkv_b":
            return (None, "qkv")
        if parent == "in_proj":
            return ("embed_fsdp", "ssm_inner")
        if parent == "router":
            return (None, None)
        return ("embed_fsdp", "qkv")      # column-parallel default
    if leafname == "b":
        return ("qkv",)
    return (None,) * min(ndim, 2)


def _param_spec(cfg: ModelConfig, key: str, shape, rules: ShardingRules,
                mesh) -> PartitionSpec:
    """The spec of the port's parameter ``key`` of ``shape``: the
    reference's spec of its stacked leaf, the stack dims taken off."""
    from repro_torch.models.transformer import _reference_slot
    path, idx = _reference_slot(cfg, key)
    ndim = len(shape) + len(idx)
    trailing = param_logical_names("/".join(map(str, path)), ndim)[:ndim]
    names = (None,) * (ndim - len(trailing)) + tuple(trailing)
    if any(n is not None for n in names[:len(idx)]):
        raise ValueError(f"{key}: a stack dim of its reference leaf has the "
                         f"logical names {names[:len(idx)]}")
    return logical_spec(rules, mesh, names[len(idx):], dims=tuple(shape))


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(cfg: ModelConfig, params, rules: ShardingRules,
                mesh) -> dict:
    """``{name: PartitionSpec}`` for a model's parameters (a
    ``Transformer``, real or on the ``meta`` device, or a dict of tensors
    keyed by parameter name)."""
    return {k: _param_spec(cfg, k, p.shape, rules, mesh)
            for k, p in _named(params).items()}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_logical_names(cfg: ModelConfig, path: str, ndim: int,
                        mesh) -> tuple:
    model_n = mesh_shape(mesh)["model"]
    heads_shardable = cfg.kv_heads % model_n == 0
    leaf = path.split("/")[-1]
    if leaf in ("k", "v"):
        if heads_shardable:
            return ("batch", None, "kv_heads", None)
        return ("batch", "kv_seq_model", None, None)    # SP fallback
    if leaf in ("c_kv", "k_rope"):
        return ("batch", "kv_seq_model", None)          # MLA latent cache
    if leaf == "ssm":
        return ("batch", "heads", None, None)
    if leaf == "conv":
        return ("batch", None, "ssm_inner")
    if leaf == "S":
        return ("batch", "heads", None, None)
    if leaf in ("tm_prev", "cm_prev"):
        return ("batch", None)
    if leaf == "len":
        return ()
    return (None,) * ndim


def cache_leaf_spec(cfg: ModelConfig, rules: ShardingRules, mesh, path: str,
                    leaf: torch.Tensor) -> PartitionSpec:
    """The spec of one cache tensor at ``path`` (its leaf name is what
    counts)."""
    ndim = leaf.dim()
    names = cache_logical_names(cfg, path, ndim, mesh)
    names = ((None,) * (ndim - len(names)) + tuple(names)
             )[-ndim:] if ndim else ()
    return logical_spec(rules.replace(kv_seq_model=("model",)), mesh, names,
                        dims=tuple(leaf.shape))


def cache_specs(cfg: ModelConfig, caches, rules: ShardingRules, mesh):
    """The caches' tree (``init_decode_state``'s, one entry a layer) with a
    PartitionSpec in place of every tensor."""
    return map_tensors(lambda p, t: cache_leaf_spec(cfg, rules, mesh, p, t),
                     caches)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: Shape, mesh) -> dict:
    """:class:`AbstractTensor` stand-ins (sharded, on the ``meta`` device,
    nothing allocated) for every model input of this (arch × shape) cell;
    tokens are int64, the index dtype of the port's gathers."""
    from repro_torch.launch.mesh import batch_axes
    B = shape.global_batch
    S = shape.seq_len
    baxes = batch_axes(mesh)
    bspec = (baxes if B % mesh_axis_size(mesh, baxes) == 0 else None)
    if isinstance(bspec, tuple) and len(bspec) == 1:
        bspec = bspec[0]

    def tok(b, s):
        return AbstractTensor(torch.empty((b, s), dtype=torch.int64,
                                          device="meta"),
                              mesh, PartitionSpec(bspec, None))

    def dense(b, s, d):
        return AbstractTensor(torch.empty((b, s, d), dtype=torch.float32,
                                          device="meta"),
                              mesh, PartitionSpec(bspec, None, None))

    if shape.kind == "train" or shape.kind == "prefill":
        seq_tokens = S - (cfg.vision_tokens if cfg.family == "vlm" else 0)
        batch = {"tokens": tok(B, seq_tokens)}
        if shape.kind == "train":
            batch["labels"] = tok(B, seq_tokens)
        if cfg.family == "vlm":
            batch["vision"] = dense(B, cfg.vision_tokens, cfg.d_model)
        if cfg.family == "audio":
            batch["frames"] = dense(B, cfg.enc_seq, cfg.d_model)
        return batch
    # decode: one new token against a seq_len cache
    batch = {"tokens": tok(B, 1)}
    if cfg.family == "audio":
        batch["enc_out"] = dense(B, cfg.enc_seq, cfg.d_model)
    return batch


# ---------------------------------------------------------------------------
# abstract state builders (the meta device — no allocation)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, rules: ShardingRules, mesh):
    """``({name: AbstractTensor}, {name: PartitionSpec})`` of the model's
    parameters, built on the ``meta`` device."""
    from repro_torch.models.transformer import Transformer
    named = dict(Transformer(cfg, device="meta").named_parameters())
    specs = param_specs(cfg, named, rules, mesh)
    return ({k: AbstractTensor(p.detach(), mesh, specs[k])
             for k, p in named.items()}, specs)


def abstract_train_state(cfg: ModelConfig, rules: ShardingRules, mesh):
    """(abstract params, abstract AdamW state, param specs): the float32
    moments inherit their parameter's spec, the step is replicated."""
    from repro_torch.optim import AdamWState
    aparams, pspecs = abstract_params(cfg, rules, mesh)

    def moment(a: AbstractTensor) -> AbstractTensor:
        return AbstractTensor(torch.empty(a.shape, dtype=torch.float32,
                                          device="meta"), mesh, a.spec)

    step = AbstractTensor(torch.empty((), dtype=torch.int32, device="meta"),
                          mesh, PartitionSpec())
    opt = AdamWState(step=step,
                     mu={k: moment(a) for k, a in aparams.items()},
                     nu={k: moment(a) for k, a in aparams.items()})
    return aparams, opt, pspecs


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int,
                    rules: ShardingRules, mesh, dtype=torch.bfloat16):
    """(the caches' tree with an AbstractTensor a tensor, their specs),
    built on the ``meta`` device."""
    from repro_torch.models.transformer import init_decode_state
    caches = init_decode_state(cfg, batch, max_len, dtype=dtype,
                               device="meta")
    specs = cache_specs(cfg, caches, rules, mesh)
    return (map_tensors(lambda p, t: AbstractTensor(
        t, mesh, cache_leaf_spec(cfg, rules, mesh, p, t)), caches), specs)
