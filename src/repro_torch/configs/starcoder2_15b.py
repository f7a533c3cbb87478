"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
(GELU MLP) vocab=49152, RoPE (arXiv:2402.19173)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, kv_heads=4,
    d_ff=24576, vocab=49152,
    mlp_type="gelu", rope_theta=1e5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, kv_heads=2,
        d_ff=256, vocab=256,
        mlp_type="gelu",
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
