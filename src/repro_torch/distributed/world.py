"""The process group a sharded run lives in.

``init_world(device)`` starts the ``torch.distributed`` world of this
process: the one ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, with its ``MASTER_ADDR``/``MASTER_PORT`` rendezvous), or,
without those, a world of one over a ``FileStore`` in a temporary
directory.  The backend is ``nccl`` on ``cuda:LOCAL_RANK`` and ``gloo`` on
the CPU.  There is no fallback: asking for ``cuda`` without a card raises,
an NCCL failure raises, and no rank moves to the CPU.  A world that is
already up (a test that rendezvoused its ranks itself) is used as it is.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --model-parallel 2
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

__all__ = ["init_world", "close_world"]

#: the temporary directory of a world of one this module started, or ""
#: for a world it did not start (None: no world started here)
_OWNED: str | None = None


def init_world(device="cuda") -> torch.device:
    """Start (or join) the world and return this rank's device:
    ``cuda:LOCAL_RANK`` for a ``cuda`` device, else the CPU."""
    global _OWNED
    import torch.distributed as dist
    from repro_torch.models.transformer import resolve_device
    device = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if device.type == "cuda" else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                **kw)
        _OWNED = ""
    else:
        tmp = tempfile.mkdtemp(prefix="repro_world_")
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, **kw)
        _OWNED = tmp
    return device


def close_world() -> None:
    """Destroy the world :func:`init_world` started (nothing for a world
    it found up)."""
    global _OWNED
    import torch.distributed as dist
    if _OWNED is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    if _OWNED:
        shutil.rmtree(_OWNED, ignore_errors=True)
    _OWNED = None
