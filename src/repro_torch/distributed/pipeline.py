"""Pipeline parallelism: a GPipe-style microbatch schedule over a stage
axis (the reference package's ``distributed/pipeline.py``).

For the assigned model sizes DP×TP(×EP) is the efficient regime (stage
bubbles waste >10% at these depths); this module provides the PP schedule
as a first-class option for deeper-than-memory models and is exercised by
tests on a small mesh.

The layer stack is split into S stages, one a rank of the mesh's
``"stage"`` dim, each rank holding its own stage's parameters.  Each
microbatch flows stage by stage: at every tick each stage runs the
activation it holds and passes its output to the next stage
(``dist.batch_isend_irecv`` where the reference has ``jax.lax.ppermute``).
The classic GPipe schedule runs S + M - 1 ticks for M microbatches; bubble
fraction (S-1)/(S+M-1).  The last stage holds the outputs and broadcasts
them to every stage (the reference's ``psum`` of masked copies).
"""

from __future__ import annotations

import torch

__all__ = ["gpipe_forward", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)


def gpipe_forward(stage_fn, stage_params, x: torch.Tensor, *, mesh,
                  n_microbatches: int, stage_axis: str = "stage"):
    """Run ``stage_fn(stage_params, x)`` through the S stages of ``mesh``'s
    ``stage_axis``.

    stage_params: this rank's stage's parameters (any object
    ``stage_fn`` takes).  x: the (B, ...) global batch, the same on every
    rank; B must divide into ``n_microbatches``, and a stage's output has
    its input's shape.  Returns the pipeline output (the shape of x) on
    every rank.
    """
    import torch.distributed as dist
    S = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    sid = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"a batch of {B} does not split into "
                         f"{n_microbatches} microbatches")
    mb = B // n_microbatches
    micro = x.reshape(n_microbatches, mb, *x.shape[1:])
    nxt = dist.get_global_rank(group, (sid + 1) % S)
    prv = dist.get_global_rank(group, (sid - 1) % S)

    buf = torch.zeros_like(micro[0])
    outs = torch.zeros_like(micro)
    for t in range(S + n_microbatches - 1):
        if sid == 0:            # stage 0 ingests microbatch t, if in range
            cur = micro[t] if t < n_microbatches else torch.zeros_like(buf)
        else:
            cur = buf
        y = stage_fn(stage_params, cur)
        if sid == S - 1 and t >= S - 1:      # the last stage emits t-(S-1)
            outs[t - (S - 1)] = y
        # rotate activations to the next stage
        if S == 1:
            buf = y
            continue
        buf = torch.empty_like(y)
        y = y.contiguous()
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, y, nxt, group),
                 dist.P2POp(dist.irecv, buf, prv, group)]):
            req.wait()
    # only the last stage's outputs are real: broadcast them
    dist.broadcast(outs, src=dist.get_global_rank(group, S - 1), group=group)
    return outs.reshape(B, *x.shape[1:])
