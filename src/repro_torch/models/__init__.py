"""The model zoo on the port (the reference package's ``models``): the
dense, MoE, hybrid (zamba2) and SSM (rwkv6) families so far.  Public API:
init_params / forward / init_decode_state / prefill / decode_step /
param_count, and from_reference to carry the reference's parameters
across."""

from .layers import Ctx, flash_attention
from .mamba2 import Mamba2, init_mamba2_state, mamba2_mixer
from .mla import MLA, init_mla_cache, mla_attention
from .moe import MoE, moe_ffn
from .rwkv6 import RWKV6, init_rwkv6_state, rwkv6_block
from .transformer import (Block, Mamba2Block, Transformer, ZambaSuper,
                          decode_step, forward, from_reference,
                          init_decode_state, init_params, param_count,
                          prefill)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params",
           "param_count", "prefill", "from_reference", "Block",
           "Mamba2Block", "ZambaSuper", "Transformer", "Ctx",
           "flash_attention", "MLA", "mla_attention", "init_mla_cache",
           "MoE", "moe_ffn", "Mamba2", "mamba2_mixer", "init_mamba2_state",
           "RWKV6", "rwkv6_block", "init_rwkv6_state"]
