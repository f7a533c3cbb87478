"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 (SwiGLU)
vocab=128256, rope_theta=500000 (arXiv:2407.21783)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=8,
    d_ff=14336, vocab=128256,
    mlp_type="swiglu", rope_theta=5e5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, kv_heads=2,
        d_ff=160, vocab=256,
        mlp_type="swiglu",
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
