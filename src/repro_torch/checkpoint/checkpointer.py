"""Fault-tolerant checkpointing: async, atomic, device-agnostic (the
reference package's ``checkpoint/checkpointer.py``).

Layout: ``<root>/step_<n>/`` holding one raw-bytes file per leaf of the
state tree plus a JSON ``manifest`` (each leaf's path, file, dtype and
shape; the reference packs it with msgpack).  A tree is nested dicts,
lists and tuples (a ``NamedTuple`` such as ``AdamWState`` by its field
names) whose leaves are tensors; an ``nn.Module`` stands for the dict of
its named parameters.

Guarantees:
  * **atomicity** — written to ``step_<n>.tmp`` then ``os.replace``'d; a
    crash mid-write never leaves a directory that ``latest_step`` picks up;
  * **async** — ``save_async`` copies every tensor to the host before its
    writer thread starts (training goes on changing the tensors in place;
    ``wait()`` joins);
  * **device-agnostic restore** — ``restore`` copies each saved leaf into
    the caller's tensor at the same path, on that tensor's device, so a
    state saved from the card restores onto the CPU and back;
  * **mesh-agnostic** — a DTensor leaf is saved as its gathered value
    (``full_tensor``, a collective every rank makes on the calling thread
    before the writer starts), and only rank 0 writes; ``restore`` lays
    each value out on the target's mesh and placements, so a state saved
    on one mesh restores onto another, or onto no mesh;
  * **GC** — keep the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
from torch import nn

__all__ = ["Checkpointer"]


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` pairs of ``tree`` in order, a path the keys, indices
    or field names from the root joined by ``/``."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, child in items:
        out += _flatten_with_paths(child, f"{prefix}/{key}" if prefix
                                   else str(key))
    return out


def _is_dtensor(leaf) -> bool:
    return hasattr(leaf, "device_mesh") and isinstance(leaf, torch.Tensor)


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory, as numpy (a DTensor's gathered
    value: a collective)."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _snapshot(tree) -> tuple[list, bool]:
    """The tree's ``(path, host copy)`` pairs, and whether the save is a
    collective (a DTensor leaf): then every rank gathers and rank 0
    writes."""
    leaves = _flatten_with_paths(tree)
    collective = any(_is_dtensor(leaf) for _, leaf in leaves)
    return [(p, _to_host(leaf)) for p, leaf in leaves], collective


def _writes(collective: bool) -> bool:
    import torch.distributed as dist
    return not collective or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


class Checkpointer:
    def __init__(self, root: str | Path, *, keep: int = 3) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._collective = False

    # -- discovery -----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree) -> Path:
        leaves, collective = _snapshot(tree)
        final = self.root / f"step_{step}"
        if _writes(collective):
            self._write(step, leaves)
        if collective:
            _barrier()
        return final

    def save_async(self, step: int, tree) -> None:
        self.wait()
        leaves, collective = _snapshot(tree)
        self._collective = collective
        if _writes(collective):
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; after a collective save every rank waits for
        rank 0's write, so a restore that follows reads it on each."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective:
            self._collective = False
            _barrier()

    def _write(self, step: int, leaves: list[tuple[str, np.ndarray]]) -> Path:
        final = self.root / f"step_{step}"
        tmp = self.root / f"step_{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = []
        for i, (p, arr) in enumerate(leaves):
            fname = f"leaf_{i:05d}.bin"
            (tmp / fname).write_bytes(arr.tobytes())
            manifest.append({"path": p, "file": fname,
                             "dtype": str(arr.dtype),
                             "shape": list(arr.shape)})
        (tmp / "manifest").write_text(json.dumps(
            {"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, step: int, target):
        """Copy checkpoint ``step`` into ``target``, a tree of tensors of
        the saved paths, shapes and dtypes, each on the device it is to
        live on, a DTensor on its mesh and placements (each rank keeps its
        shard of the saved value; the copy runs without autograd, so
        parameters that require grad are filled too).  Returns
        ``target``."""
        d = self.root / f"step_{step}"
        manifest = json.loads((d / "manifest").read_text())
        by_path = {m["path"]: m for m in manifest["leaves"]}
        with torch.no_grad():
            for p, tgt in _flatten_with_paths(target):
                m = by_path[p]
                # np.frombuffer is read-only: copy before torch shares it
                arr = np.frombuffer((d / m["file"]).read_bytes(),
                                    dtype=m["dtype"]).reshape(m["shape"])
                src = torch.from_numpy(arr.copy())
                if src.shape != tgt.shape or src.dtype != tgt.dtype:
                    raise ValueError(
                        f"checkpoint leaf {p!r} is {src.dtype} "
                        f"{tuple(src.shape)}; the target is {tgt.dtype} "
                        f"{tuple(tgt.shape)}")
                if _is_dtensor(tgt):
                    from torch.distributed.tensor import distribute_tensor
                    tgt.to_local().copy_(distribute_tensor(
                        src.to(tgt.to_local().device), tgt.device_mesh,
                        tgt.placements, src_data_rank=None).to_local())
                else:
                    tgt.copy_(src)
        return target

    def restore_latest(self, target):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target)
