"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8),
per-expert d_ff=512, vocab=49155, MoE 40 experts top-8
[hf:ibm-granite family].  NOTE: the assignment's structured field says 40e;
its inline note says 32 — we follow the structured field (DESIGN.md §4)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8, moe_d_ff=512, capacity_factor=1.25,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, kv_heads=2,
        d_ff=96, vocab=256,
        n_experts=8, top_k=2, moe_d_ff=96, capacity_factor=1.25,
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
