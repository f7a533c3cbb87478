"""Fault-tolerant training driver (the reference package's
``launch/train.py``), on one device or across a device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --steps 20 --batch 8 --seq 128 --ckpt runs/ckpt
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --model-parallel 2

Composes the substrate: the model zoo (``--arch``), the deterministic
resumable data pipeline, AdamW (with optional int8 gradient compression
and error feedback), async atomic checkpointing with auto-resume, the
preemption guard, straggler detection, and bounded retry with an elastic
re-mesh.  It trains on the card unless ``--device cpu`` is given, and
raises without one.

``main`` meshes as the reference does: it joins the ``torchrun`` world
(or starts a world of one, ``distributed/world.py``) and every (re)try
builds the ``(data, model)`` mesh afresh with
``best_mesh(model_parallel=...)``.  A mesh of one rank shards nothing, so
there the loop takes the single-device path, which computes the same step
(``chip_smoke.py`` phase 9a holds the two bit-equal) without DTensor's
host cost per op.  Under a mesh (``TrainLoop(mesh=...)``)
the parameters are DTensors laid out by ``param_specs`` under
``rules_for(mesh, "train")`` (FSDP over ``data``, Megatron TP and SP over
``model``), their moments alike, the step replicated, and every batch is
sharded over the batch axes (``make_global_batch``).  With no mesh the
loop is the single-device path.

Where the reference compiles its step (``jit`` with donated buffers), the
port runs it eagerly: ``TrainLoop.step_fn`` is the loss, ``backward``,
each gradient brought to its parameter's layout (the data-parallel
all-reduce), the optional compression and ``adamw_update``, which write
the parameters and moments in place.  The model's matmuls are plain
``torch.matmul`` in the config's ``compute_dtype`` (bf16 by default), as in
the reference, whose training step never routes through the tuned GEMM.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMDataset, make_global_batch
from repro_torch.distributed import (PreemptionGuard, RetryPolicy,
                                     StragglerDetector, best_mesh,
                                     close_world, init_world, reshard)
from repro_torch.launch.mesh import batch_axes
from repro_torch.launch.specs import param_specs, rules_for
from repro_torch.models import init_params, loss_fn
from repro_torch.models.transformer import resolve_device
from repro_torch.optim import (AdamWConfig, adamw_update, compress_decompress,
                               init_adamw, init_error_feedback)

__all__ = ["TrainLoop", "main"]


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class TrainLoop:
    cfg: object
    adamw: AdamWConfig
    ckpt: Checkpointer
    dataset: object
    device: object = "cuda"
    grad_compression: bool = False
    ckpt_every: int = 50
    log_every: int = 10
    straggler: StragglerDetector = dataclasses.field(
        default_factory=StragglerDetector)
    mesh: object = None               # DeviceMesh | None (one device)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.rules = None
        if self.mesh is not None:
            if self.mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is of {self.mesh.device_type} "
                                 f"ranks; the loop trains on {self.device}")
            if self.device.type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self.rules = rules_for(self.mesh, "train")

    def step_fn(self, params, opt_state, ef, batch):
        """One train step: the loss of ``batch``, its gradients, the
        optional int8 round trip, the AdamW update (``params``, a model,
        and the moments written in place).  Returns ``(params, opt_state,
        ef, metrics)``, the metrics (loss, ce, moe_aux, lr, grad_norm)
        tensors on the device: the step makes no host sync.  Under a mesh
        each gradient is brought to its parameter's placements before the
        optimiser reads it (a gradient of a weight replicated over
        ``data`` comes back as a partial sum there: this is the
        data-parallel all-reduce), and the metrics are gathered whole."""
        named = dict(params.named_parameters())
        params.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(params, batch, self.cfg, mesh=self.mesh,
                                rules=self.rules)
        loss.backward()
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        if self.mesh is not None:
            grads = {k: g.redistribute(named[k].device_mesh,
                                       named[k].placements)
                     for k, g in grads.items()}
        if self.grad_compression:
            grads, ef = compress_decompress(grads, ef)
        _, opt_state, om = adamw_update(named, grads, opt_state, self.adamw)
        params.zero_grad(set_to_none=True)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **om}
        if self.mesh is not None:
            out = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                   for k, v in out.items()}
        return params, opt_state, ef, out

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict:
        """``{"params": the model from seed on the device, gradients on;
        "opt": zero AdamW moments; "ef": the error-feedback buffers}``.
        Under a mesh the parameters are drawn whole (the same values on
        every mesh) and each is laid out by ``param_specs`` in turn, so no
        more than one whole parameter outlives its layout; the moments and
        buffers follow their parameter's placements."""
        params = init_params(seed, self.cfg, device=self.device)
        params.requires_grad_(True)
        if self.mesh is not None:
            specs = param_specs(self.cfg, params, self.rules, self.mesh)
            reshard(params, self.mesh, lambda name, _: specs[name])
        named = dict(params.named_parameters())
        ef = (init_error_feedback(named) if self.grad_compression
              else {"_": torch.zeros((), device=self.device)})
        return {"params": params, "opt": init_adamw(named), "ef": ef}

    def restore_or_init(self, seed: int = 0):
        state = self.init_state(seed)
        step = self.ckpt.latest_step()
        if step is None:
            return 0, state
        restored = self.ckpt.restore(step, state)
        print(f"[train] resumed from step {step}", flush=True)
        return step, restored

    # -- loop ----------------------------------------------------------------
    def run(self, steps: int, *, guard: PreemptionGuard | None = None,
            start_step: int | None = None, state=None) -> dict:
        guard = guard or PreemptionGuard(install_handlers=False)
        if state is None:
            start_step, state = self.restore_or_init()
        step = start_step or 0
        history = []
        baxes = None if self.mesh is None else batch_axes(self.mesh)
        while step < steps:
            t0 = time.perf_counter()
            batch = make_global_batch(self.dataset.batch_at(step),
                                      self.mesh, baxes, device=self.device)
            p, o, ef, metrics = self.step_fn(state["params"], state["opt"],
                                             state["ef"], batch)
            state = {"params": p, "opt": o, "ef": ef}
            _sync(self.device)
            dt = time.perf_counter() - t0
            if self.straggler.observe(dt):
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(ewma {self.straggler.expected_step_seconds:.2f}s)",
                      flush=True)
            step += 1
            if step % self.log_every == 0 or step == steps:
                loss = float(metrics["loss"])
                history.append({"step": step, "loss": loss,
                                "sec_per_step": dt})
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if step % self.ckpt_every == 0 or step == steps:
                self.ckpt.save_async(step, state)
            if guard.preempted:
                print("[train] preemption signal — checkpoint + clean exit",
                      flush=True)
                self.ckpt.save(step, state)
                break
        self.ckpt.wait()
        return {"final_step": step, "history": history, "state": state}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-runnable)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card; "
                        "under torchrun cuda:LOCAL_RANK)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt", default="runs/ckpt")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--grad-compression", action="store_true")
    p.add_argument("--max-retries", type=int, default=2)
    args = p.parse_args(argv)
    device = init_world(args.device)   # raises without the card asked for

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dataset = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                                 global_batch=args.batch)
    adamw = AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5))
    guard = PreemptionGuard()

    def attempt(retry_i: int):
        # elastic: every (re)try builds the mesh from the live ranks and
        # the loop afresh, and resumes from the latest checkpoint
        mesh = best_mesh(model_parallel=args.model_parallel)
        print(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"on {device}", flush=True)
        loop = TrainLoop(cfg=cfg, adamw=adamw, ckpt=Checkpointer(args.ckpt),
                         dataset=dataset, device=device,
                         mesh=mesh if mesh.size() > 1 else None,
                         grad_compression=args.grad_compression,
                         ckpt_every=args.ckpt_every)
        return loop.run(args.steps, guard=guard)

    try:
        result = RetryPolicy(max_retries=args.max_retries).run(
            attempt,
            on_retry=lambda i, e, d: print(
                f"[train] attempt {i} failed ({e}); re-meshing in {d:.0f}s",
                flush=True))
    finally:
        close_world()
    print(f"[train] done at step {result['final_step']}")
    return result


if __name__ == "__main__":
    main()
