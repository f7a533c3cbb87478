"""Int8 gradient compression with error feedback (the reference package's
``optim/compression.py``), over dicts of tensors keyed by parameter name.

Per-tensor symmetric int8 quantisation (scale = max|g| / 127, floored at
1e-30).  The quantisation residual is carried in an error-feedback buffer
and added to the next step's gradient, so the compression's bias vanishes
over time (Karimireddy et al. 2019).  On one card nothing crosses a link:
the round trip is what a data-parallel all-reduce of the int8 tensors
would apply to the gradients.  On DTensor gradients (a sharded
``TrainLoop``) the scale's ``max|g|`` reduces across the shards, so the
sharded round trip is the unsharded one.
"""

from __future__ import annotations

import torch

__all__ = ["init_error_feedback", "compress_decompress", "quantize_int8",
           "dequantize_int8"]


def quantize_int8(g: torch.Tensor):
    """``(q, scale)``: ``g`` rounded half to even (``torch.round``, as
    ``jnp.round``) in units of ``scale``, as int8."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def compress_decompress(grads: dict, ef: dict):
    """The int8 round trip with error feedback: ``(decompressed grads, new
    error buffers)``, both new dicts."""
    out, new_ef = {}, {}
    for k, g in grads.items():
        g32 = g.float() + ef[k]
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        out[k], new_ef[k] = deq.to(g.dtype), g32 - deq
    return out, new_ef
