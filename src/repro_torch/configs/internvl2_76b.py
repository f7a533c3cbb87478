"""internvl2-76b [vlm] — InternViT + InternLM2 backbone (arXiv:2404.16821).
Backbone only: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The ViT frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (B, 256, d_model) prepended to the token stream through a
learned projection."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, kv_heads=8,
    d_ff=28672, vocab=128256,
    mlp_type="swiglu", rope_theta=5e5, vision_tokens=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=3, d_model=64, n_heads=4, kv_heads=2,
        d_ff=160, vocab=256,
        mlp_type="swiglu", vision_tokens=8,
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
