"""Batched serving driver: batched prefill, then step-synchronous batched
decode (the reference package's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu --requests 2 --prompt-len 8 --max-new 8

``main`` serves the *routed* model (``use_pallas_gemm=True``, float32
compute, as the reference's routed paths run it): every dense matmul —
QKV or MLA's projections, the output projection, the MLP, Mamba2's and
RWKV6's projections, zamba2's shared-block input projection and the LM
head — is one ``run_op`` GEMM, and so is each of an MoE layer's three
expert matmuls over all its experts; on the card each launches the
hand-written Hopper kernel under the knob the runtime picks.  The dense,
MoE, hybrid and SSM families serve (``--arch llama3-8b``,
``granite-moe-3b-a800m``, ``deepseek-v2-lite-16b``, ``zamba2-1.2b``,
``rwkv6-1.6b``, ...); the recurrent ones carry their O(1) state a layer
from the prefill into the decode steps.  ``--models DIR`` loads the installed artifacts of
``DIR`` (``repro_torch.launch.calibrate --out X`` writes them to
``X/models``) so the knobs come from the learned model; without it every
decision is the default knob.  ``--device`` defaults to the card.

There is no jit: each routed matmul calls ``run_op``, whose decision cache
makes a repeated shape a lock-free hit.  The generated tokens stay on the
device until the last step, so the host never waits on the card between
steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import AdsalaRuntime, ModelRegistry
from repro_torch.models import (decode_step, init_decode_state, init_params,
                                prefill)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import resolve_device

__all__ = ["ServeSession", "main"]


@dataclasses.dataclass
class ServeSession:
    cfg: ModelConfig
    params: torch.nn.Module
    max_len: int
    runtime: object = None            # AdsalaRuntime | None (None → global)
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        where = {p.device.type for p in self.params.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"the model's weights lie on {sorted(where)}, "
                             f"the session serves on {self.device}")

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, *, max_new: int = 32,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """prompts: (B, S_prompt) int → (B, max_new) int32.  Greedy at
        ``temperature`` 0, else sampled with a ``torch.Generator`` seeded
        with ``seed``."""
        cfg = self.cfg
        B = prompts.shape[0]
        caches = init_decode_state(cfg, B, self.max_len,
                                   dtype=torch_dtype(cfg.compute_dtype),
                                   device=self.device)
        tokens = torch.as_tensor(np.asarray(prompts, dtype=np.int64),
                                 device=self.device)
        logits, caches = prefill(self.params, {"tokens": tokens}, caches,
                                 cfg, runtime=self.runtime)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = self._sample(logits[:, -1], temperature, gen)
        for _ in range(max_new):
            out.append(tok)
            logits, caches = decode_step(self.params, tok, caches, cfg,
                                         runtime=self.runtime)
            tok = self._sample(logits[:, -1], temperature, gen)
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        if temperature <= 0.0:
            return logits.argmax(-1, keepdim=True)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--models", default=None,
                   help="registry directory of installed artifacts")
    args = p.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, use_pallas_gemm=True,
                              compute_dtype="float32")
    runtime = AdsalaRuntime()
    if args.models:
        loaded = ModelRegistry(args.models).load_into(
            runtime, backend=cfg.gemm_backend)
        print(f"[serve] loaded {loaded} {cfg.gemm_backend} artifacts from "
              f"{args.models}")
    params = init_params(0, cfg, device=args.device)
    sess = ServeSession(cfg=cfg, params=params,
                        max_len=args.prompt_len + args.max_new + 8,
                        runtime=runtime, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.requests, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    out = sess.generate(prompts, max_new=args.max_new,
                        temperature=args.temperature)
    dt = time.perf_counter() - t0
    toks = args.requests * args.max_new
    stats = runtime.stats.for_backend(cfg.gemm_backend)
    print(f"[serve] {cfg.name} on {sess.device}: generated {out.shape} in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s incl. prefill); knob decisions "
          f"model_evals {stats.model_evals} default_calls "
          f"{stats.default_calls}")
    print(out[:, :12])
    return out


if __name__ == "__main__":
    main()
