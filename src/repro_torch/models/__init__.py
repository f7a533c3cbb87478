"""The model zoo on the port (the reference package's ``models``): every
family of it, dense, MoE, hybrid (zamba2), SSM (rwkv6), audio (Whisper's
encoder and cross-attention) and VLM (the vision projection).  Public API:
init_params / forward / loss_fn / init_decode_state / prefill /
decode_step / param_count, and from_reference / to_reference /
adamw_state_from_reference to carry parameters, gradients and an
optimiser state between the reference and the port."""

from .layers import (Ctx, chunked_cross_entropy, cross_entropy,
                     flash_attention)
from .mamba2 import Mamba2, init_mamba2_state, mamba2_mixer
from .mla import MLA, init_mla_cache, mla_attention
from .moe import MoE, moe_ffn
from .rwkv6 import RWKV6, init_rwkv6_state, rwkv6_block
from .transformer import (Block, DecCross, Encoder, Mamba2Block, Transformer,
                          ZambaSuper, adamw_state_from_reference,
                          decode_step, forward, from_reference,
                          init_decode_state, init_params, loss_fn,
                          param_count, prefill, to_reference)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params",
           "loss_fn", "param_count", "prefill", "from_reference",
           "to_reference", "adamw_state_from_reference", "Block",
           "DecCross", "Encoder", "Mamba2Block", "ZambaSuper", "Transformer",
           "Ctx", "cross_entropy", "chunked_cross_entropy",
           "flash_attention", "MLA", "mla_attention", "init_mla_cache",
           "MoE", "moe_ffn", "Mamba2", "mamba2_mixer", "init_mamba2_state",
           "RWKV6", "rwkv6_block", "init_rwkv6_state"]
