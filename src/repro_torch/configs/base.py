"""Model configuration schema shared by all 10 assigned architectures (the
reference package's ``configs/base.py``, field for field, so a reference
config carries across).

A config is a frozen dataclass; the layer stack is described by
``segments()`` — a list of (block_kind, repeat) pairs that the model
assembler (``repro_torch.models.transformer``) turns into a list of layers.
Two fields differ from the reference: ``gemm_backend`` defaults to the
port's ``"hopper"``, and ``gemm_interpret`` (the Pallas interpret mode) has
no meaning here and is gone.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ModelConfig", "Shape", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0                 # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    mlp_type: Literal["swiglu", "gelu"] = "swiglu"

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width
    first_dense_layers: int = 0       # leading dense-FFN layers (deepseek)
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ------------------------------------------------------
    use_mla: bool = False
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 64
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # --- RWKV6 ----------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128
    rwkv_lora: int = 64

    # --- hybrid (zamba2): one shared attn+mlp block applied every k layers ---
    shared_attn_every: int = 6

    # --- encoder-decoder (whisper) --------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 1500               # 30 s of audio → 1500 frames (stub)

    # --- VLM (internvl): stubbed ViT frontend → patch-embedding prefix -------
    vision_tokens: int = 0

    # --- numerics / execution -------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: Literal["none", "block", "dots", "nested"] = "nested"
    ce_chunk: int = 2048              # fused-CE seq tile (0 = materialise)
    unroll_attn: int = 1              # costing: inline N flash kv trips
    unroll_ssm: int = 1               # costing: inline N SSD/WKV chunk trips
    attn_q_chunk: int = 1024          # blockwise-attention q tile
    attn_k_chunk: int = 1024          # blockwise-attention kv tile
    causal_skip: bool = False         # skip fully-masked kv blocks (§Perf)
    use_pallas_gemm: bool = False     # route dense matmuls through run_op
    gemm_backend: str = "hopper"      # run_op backend key for routed matmuls

    # ------------------------------------------------------------------------
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def segments(self) -> list[tuple[str, int]]:
        """(block_kind, repeat) pairs, in order."""
        if self.family == "hybrid":   # zamba2: 6×(super = 6·mamba+shared) + 2
            supers, tail = divmod(self.n_layers, self.shared_attn_every)
            segs = [("zamba_super", supers)]
            if tail:
                segs.append(("mamba2", tail))
            return segs
        if self.family == "ssm":
            return [("rwkv6", self.n_layers)]
        if self.family == "moe":
            segs = []
            if self.first_dense_layers:
                segs.append(("attn", self.first_dense_layers))
            segs.append(("moe", self.n_layers - self.first_dense_layers))
            return segs
        if self.family == "audio":    # decoder side; encoder handled apart
            return [("dec_cross", self.n_layers)]
        return [("attn", self.n_layers)]   # dense, vlm backbone

    def is_decoder_only(self) -> bool:
        return self.family not in ("audio",)

    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing → long_500k applies."""
        return self.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# The assigned input-shape set (one per cell of the dry-run/roofline table)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(applicable?, reason-if-not) — the skip rules from the assignment."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, "full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""
