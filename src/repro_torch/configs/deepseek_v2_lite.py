"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed experts top-6
+ 2 shared experts, per-expert d_ff=1408, layer 0 dense FFN (d_ff=10944),
27L d_model=2048 16H, vocab=102400 (arXiv:2405.04434).
NOTE: the assignment's inline note says "160 routed" — that describes full
V2; the structured field (64e top-6) matches V2-*Lite* and is what we build
(DESIGN.md §4)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, kv_heads=16,
    d_ff=10944, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_dense_layers=1, capacity_factor=1.25,
    use_mla=True, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, kv_heads=4,
        d_ff=160, vocab=256,
        n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=48,
        first_dense_layers=1, capacity_factor=1.25,
        use_mla=True, kv_lora=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
