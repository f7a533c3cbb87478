"""qwen1.5-4b [dense] — 40L d_model=2560 20H (kv=20) d_ff=6912 (SwiGLU)
vocab=151936, QKV bias [hf:Qwen/Qwen1.5 family]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, kv_heads=20,
    d_ff=6912, vocab=151936,
    qkv_bias=True, mlp_type="swiglu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, kv_heads=4,
        d_ff=160, vocab=256,
        qkv_bias=True, mlp_type="swiglu",
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
