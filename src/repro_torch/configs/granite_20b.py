"""granite-20b [dense] — 52L d_model=6144 48H MQA (kv=1) d_ff=24576 (GELU)
vocab=49152, code model (arXiv:2405.04324).  kv=1 cannot shard across the
16-way model axis → KV projections replicate (models/sharding.py fallback)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, kv_heads=1,
    d_ff=24576, vocab=49152,
    mlp_type="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, kv_heads=1,
        d_ff=256, vocab=256,
        mlp_type="gelu",
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
