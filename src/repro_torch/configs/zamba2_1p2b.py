"""zamba2-1.2b [hybrid] — Mamba2 backbone + one SHARED attention+MLP block
applied every 6 layers (arXiv:2411.15242).  38L = 6 super-blocks (6 mamba +
shared attn each) + 2 tail mamba layers.  The shared block reads
concat(hidden, embedding) through a per-invocation input projection."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_groups=1, ssm_chunk=256,
    shared_attn_every=6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, kv_heads=4,
        d_ff=128, vocab=256,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_groups=1,
        ssm_chunk=16, shared_attn_every=2,
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
