"""The model zoo on the port (the reference package's ``models``), the dense
and MoE families so far.  Public API: init_params / forward /
init_decode_state / prefill / decode_step / param_count, and from_reference
to carry the reference's parameters across."""

from .layers import Ctx, flash_attention
from .mla import MLA, init_mla_cache, mla_attention
from .moe import MoE, moe_ffn
from .transformer import (Block, Transformer, decode_step, forward,
                          from_reference, init_decode_state, init_params,
                          param_count, prefill)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params",
           "param_count", "prefill", "from_reference", "Block",
           "Transformer", "Ctx", "flash_attention", "MLA", "mla_attention",
           "init_mla_cache", "MoE", "moe_ffn"]
