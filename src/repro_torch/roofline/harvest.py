"""Ahead-of-time harvest of a served model's BLAS3 decision keys.

Every routed matmul asks the runtime for its knob under the key
``(backend, op, dtype_bytes, dims)``, and the dims follow from the shapes
alone.  So the complete set of keys a served model will ask for is a
property of its shapes, and can be harvested without weights or
arithmetic: the port's own programs run on the ``meta`` device (tensors
with shapes and no data), where ``kernels/ops.py::run_op`` takes its
shape-only step — the decision is asked of the runtime, an empty meta
tensor comes back, no kernel runs.

  * :func:`harvest_decision_keys` — run a config's programs as
    ``launch/serve.py::ServeSession`` runs them (Whisper's encoder once,
    the prefill with the VLM's vision projection ahead of the prompt, a
    decode step at the true position) under a :class:`Recorder` and return
    every distinct key.  ``scripts/torch_prewarm_model.py`` feeds these
    through ``select_many`` + ``ModelRegistry.save_decision_cache`` so the
    first real request pays no model evaluation.

  * :func:`dot_call_sites` — the matmuls that do *not* go through
    ``run_op`` (attention scores, MLA's absorbed einsums, the router, the
    plain config's linears): a ``TorchDispatchMode`` that records every
    ``aten.mm``/``bmm``/``addmm``/``baddbmm`` on meta tensors.  Routed GEMMs
    never reach ATen on the meta device, so they are left out, as the
    reference's jaxpr walk leaves out Pallas kernel bodies.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.runtime import DEFAULT_BACKEND, AdsalaRuntime

__all__ = ["HarvestedKey", "Recorder", "harvest_decision_keys",
           "dot_call_sites", "abstract_batch"]

#: one decision-cache key: (backend, op, dtype_bytes, dims)
HarvestedKey = tuple


class Recorder(AdsalaRuntime):
    """An :class:`AdsalaRuntime` that *records* decision keys instead of
    evaluating models.  Every ``select_or_default`` logs its key and returns
    the caller's default knob — no artifacts consulted, no model evals, so
    running a routed program under it is pure bookkeeping."""

    def __init__(self) -> None:
        super().__init__()
        self.keys: list[HarvestedKey] = []
        self._seen: set[HarvestedKey] = set()

    def select_or_default(self, op, dims, dtype_bytes, default, *,
                          backend=DEFAULT_BACKEND):
        key = (backend, op, int(dtype_bytes),
               tuple(int(d) for d in dims))
        if key not in self._seen:
            self._seen.add(key)
            self.keys.append(key)
        return default


def abstract_batch(cfg, batch_size: int, seq_len: int) -> dict:
    """Meta tensors of one input batch of ``cfg``'s modality mix, with the
    shapes ``ServeSession.generate`` gives them: the prompt tokens, the
    VLM's ``vision`` (B, vision_tokens, d_model) and Whisper's ``frames``
    (B, enc_seq, d_model)."""
    meta = {"device": "meta"}
    batch = {"tokens": torch.empty((batch_size, seq_len), dtype=torch.long,
                                   **meta)}
    if cfg.vision_tokens:
        batch["vision"] = torch.empty(
            (batch_size, cfg.vision_tokens, cfg.d_model), **meta)
    if cfg.family == "audio":
        batch["frames"] = torch.empty(
            (batch_size, cfg.enc_seq, cfg.d_model), **meta)
    return batch


@torch.inference_mode()
def harvest_decision_keys(cfg, *, batch_size: int = 1, seq_len: int = 128,
                          max_new: int = 32, max_len: int | None = None,
                          programs: tuple[str, ...] = ("prefill", "decode")
                          ) -> list[HarvestedKey]:
    """Every distinct decision-cache key the served model will request for
    ``batch_size`` prompts of ``seq_len`` tokens.

    Runs the programs of a generate on the meta device under a
    :class:`Recorder`: ``"prefill"`` (Whisper's encoder first, once, as
    the session runs it; the VLM's vision projection inside the prefill)
    and ``"decode"`` (one step at position ``seq_len``: every step has the
    same shapes), or ``"forward"`` (the training-style pass over the whole
    batch).  The cache holds ``max_len`` positions, by default as
    ``launch/serve.py::main`` sizes it (MLA's absorbed prefill projects the
    whole cache, so its keys depend on the length).  The
    config is forced onto the routed float32 path; an unrouted config
    would harvest nothing.  No tensor with data is created.
    """
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    # as launch/serve.py::main serves it: routed, float32
    rcfg = dataclasses.replace(cfg, use_pallas_gemm=True,
                               compute_dtype="float32")
    rec = Recorder()
    params = tf.init_params(0, rcfg, device="meta")
    batch = abstract_batch(rcfg, batch_size, seq_len)
    frames = batch.pop("frames", None)
    if "forward" in programs:
        tf.forward(params, dict(batch, **({"frames": frames}
                                          if frames is not None else {})),
                   rcfg, runtime=rec)
    if "prefill" in programs or "decode" in programs:
        if max_len is None:
            max_len = seq_len + max_new + 8 + rcfg.vision_tokens
        caches = tf.init_decode_state(rcfg, batch_size, max_len,
                                      dtype=torch.float32, device="meta")
        enc_out = (tf._run_encoder(params, frames, Ctx(rcfg, rec))
                   if frames is not None else None)
        if "prefill" in programs:
            tf.prefill(params, batch, caches, rcfg, runtime=rec,
                       enc_out=enc_out)
        if "decode" in programs:
            token = torch.empty((batch_size, 1), dtype=torch.long,
                                device="meta")
            tf.decode_step(params, token, caches, rcfg, runtime=rec,
                           enc_out=enc_out, pos=seq_len)
    return rec.keys


# ---------------------------------------------------------------------------
# ATen-level call-site map (matmuls outside run_op)
# ---------------------------------------------------------------------------

_MATMULS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2),
            "baddbmm": (1, 2)}


class _DotSites(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.sites: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        pos = _MATMULS.get(name)
        if pos is not None:
            a, b = args[pos[0]], args[pos[1]]
            if a.device.type == "meta" and b.device.type == "meta":
                m, k = a.shape[-2:]
                self.sites.append(("gemm", (int(m), int(k),
                                            int(b.shape[-1])),
                                   int(a.dtype.itemsize)))
        return func(*args, **(kwargs or {}))


def dot_call_sites(fn, *args, **kwargs) -> list[tuple]:
    """``(op, (m, k, n), dtype_bytes)`` for every ATen matmul (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``) on meta tensors reached when running
    ``fn(*args, **kwargs)`` (a batched product's batch axis left out of
    the dims; routed GEMMs excluded — ``run_op`` dispatches those)."""
    with _DotSites() as mode:
        fn(*args, **kwargs)
    return mode.sites
