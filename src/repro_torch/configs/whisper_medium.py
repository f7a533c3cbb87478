"""whisper-medium [audio] — encoder-decoder, 24 enc + 24 dec layers,
d_model=1024 16H d_ff=4096 (GELU) vocab=51865 (arXiv:2212.04356).
The conv frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings (B, 1500, d_model); sinusoidal positions, no RoPE."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, kv_heads=16,
    d_ff=4096, vocab=51865,
    mlp_type="gelu", n_enc_layers=24, enc_seq=1500,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, kv_heads=4,
        d_ff=128, vocab=256,
        mlp_type="gelu", n_enc_layers=2, enc_seq=32,
        attn_q_chunk=32, attn_k_chunk=32, remat="none",
    )
