"""Optimizer substrate (the reference package's ``optim``): AdamW, cosine
schedule, global-norm clipping and int8 gradient compression with error
feedback, as plain functions over dicts of tensors keyed by parameter
name."""

from .adamw import (AdamWConfig, AdamWState, adamw_update, clip_by_global_norm,
                    cosine_schedule, global_norm, init_adamw)
from .compression import (compress_decompress, dequantize_int8,
                          init_error_feedback, quantize_int8)

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "init_adamw",
           "compress_decompress", "dequantize_int8", "init_error_feedback",
           "quantize_int8"]
