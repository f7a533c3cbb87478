"""rwkv6-1.6b [ssm] "Finch" — attention-free, data-dependent decay
(arXiv:2404.05892).  24L, d_model=2048, channel-mix d_ff=7168 (3.5×d),
vocab=65536; 32 heads of 64 (d_model/64)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, kv_heads=32,
    d_ff=7168, vocab=65536,
    rwkv_head_dim=64, rwkv_chunk=128, rwkv_lora=64,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=4, kv_heads=4,
        d_ff=224, vocab=256,
        rwkv_head_dim=16, rwkv_chunk=16, rwkv_lora=8, remat="none",
    )
