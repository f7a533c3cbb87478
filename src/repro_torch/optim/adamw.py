"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (the reference package's ``optim/adamw.py``), over dicts of
tensors keyed by parameter name.

The update is the reference's formula, ``delta = mhat / (sqrt(vhat) + eps)
+ wd * p`` and then ``p - lr * delta``, written into the parameters and
moments in place, one tensor at a time (so its temporaries are one
tensor's size, not the whole model's).  The step counter, the learning
rate, the bias corrections and the clip's scale stay 0-dim tensors on the
parameters' device: a step makes no host sync.

The tensors may be DTensors (a sharded ``TrainLoop``): the global norm
then reduces across the shards, so the sharded update is the unsharded
one.

``adamw_update`` and ``clip_by_global_norm`` run inside
``torch.profiler.record_function`` ranges of their names, so a profile of a
train step reads their device time apart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "init_adamw", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-dim int32, on the parameters' device
    mu: dict
    nu: dict


def init_adamw(params: dict) -> AdamWState:
    """Zero float32 moments shaped like each parameter, on its device (a
    DTensor parameter's moments are DTensors of its placements, and the
    step is then replicated on its mesh)."""
    first = next(iter(params.values()))
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    mesh = getattr(first, "device_mesh", None)
    if mesh is not None:
        from torch.distributed.tensor import Replicate, distribute_tensor
        step = distribute_tensor(step, mesh, [Replicate()] * mesh.ndim)
    return AdamWState(
        step=step,
        mu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()})


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to ``min_lr_frac``
    of it at ``total_steps``; ``step`` a tensor, the result a float32
    tensor on its device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict) -> torch.Tensor:
    """The float32 l2 norm of every tensor of ``tree`` together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    """``grads`` scaled so that their global norm is at most ``max_norm``
    (a new dict; the tensors are scaled in place), and the norm before."""
    with torch.profiler.record_function("clip_by_global_norm"):
        gn = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        for g in grads.values():
            g.mul_(scale.to(g.dtype))
    return grads, gn


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState,
                 cfg: AdamWConfig):
    """One AdamW step over ``params`` (written in place) with ``grads``
    (clipped in place).  Returns ``(params, new_state, metrics)``: the
    state's moments are updated in place, its step is a new tensor, and
    ``metrics`` holds ``lr`` and ``grad_norm`` as device tensors."""
    with torch.profiler.record_function("adamw_update"):
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
        step = state.step + 1
        lr = cosine_schedule(cfg, step)
        b1c = 1.0 - torch.pow(cfg.b1, step.float())
        b2c = 1.0 - torch.pow(cfg.b2, step.float())
        for k, p in params.items():
            g32 = grads[k].float()
            m, v = state.mu[k], state.nu[k]
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            delta.add_(cfg.weight_decay * p.float())
            p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), \
        {"lr": lr, "grad_norm": gn}
