"""Data pipeline: deterministic and resumable (the reference package's
``data/pipeline.py``; its two datasets are numpy-only and copied here).

``SyntheticLMDataset`` makes reproducible LM batches *statelessly from the
step index*: resuming after a preemption needs no iterator state, only the
restored step counter (the checkpoint carries it).  Each batch comes from a
numpy generator seeded with ``(seed, step)``, so the batch of any step can
be made again anywhere.

``ByteCorpusDataset`` is the "real data" path of the examples: a byte-level
tokenizer over a text file with the same stateless step → batch indexing.

``make_device_batch`` puts a batch of host arrays on one device;
``make_global_batch`` places it on a mesh, its batch dim sharded over the
batch axes (each rank keeps its slice of the host batch, which every rank
makes alike from the step).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

__all__ = ["SyntheticLMDataset", "ByteCorpusDataset", "make_device_batch",
           "make_global_batch"]


@dataclasses.dataclass
class SyntheticLMDataset:
    """Markov-ish synthetic token stream: the next token depends on the
    previous token plus per-step noise, a learnable but non-trivial signal,
    so a falling training loss is a meaningful smoke check."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        base = rng.integers(0, V, size=(B, 1))
        steps = rng.integers(1, 7, size=(B, S))
        toks = (base + np.cumsum(steps, axis=1)) % V
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1                      # no target for final position
        return {"tokens": tokens, "labels": labels}


@dataclasses.dataclass
class ByteCorpusDataset:
    """Byte-level LM over a text corpus, stateless step → batch indexing."""
    path: str | Path
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        raw = Path(self.path).read_bytes()
        if len(raw) < (self.seq_len + 1) * 2:
            raw = raw * ((self.seq_len + 1) * 2 // max(len(raw), 1) + 1)
        self.data = np.frombuffer(raw, dtype=np.uint8)

    @property
    def vocab(self) -> int:
        return 256

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 9_999_991 + step) & 0x7FFFFFFF)
        B, S = self.global_batch, self.seq_len
        starts = rng.integers(0, len(self.data) - S - 1, size=B)
        tokens = np.stack([self.data[s:s + S] for s in starts]).astype(np.int32)
        labels = np.stack([self.data[s + 1:s + S + 1] for s in starts]
                          ).astype(np.int32)
        return {"tokens": tokens, "labels": labels}


def make_device_batch(batch: dict[str, np.ndarray],
                      device) -> dict[str, torch.Tensor]:
    """The host arrays of ``batch`` as tensors on ``device``: integer
    arrays (tokens, labels) as int64, the index dtype of PyTorch's gathers;
    the rest (Whisper's frames, the VLM's vision embeddings) as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def make_global_batch(batch: dict[str, np.ndarray], mesh,
                      batch_axes=("data",), device=None) -> dict:
    """Place host arrays on ``mesh``, batch dim sharded over
    ``batch_axes``: DTensors whose local shards are this rank's rows of
    the host arrays (integers as int64, as :func:`make_device_batch`).
    With ``mesh=None`` the plain tensors on ``device``."""
    if mesh is None:
        return make_device_batch(batch, device)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.sharding import PartitionSpec, placements
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
    axes = tuple(batch_axes)
    out = {}
    for k, t in make_device_batch(batch, device).items():
        spec = PartitionSpec(axes if len(axes) > 1 else axes[0],
                             *([None] * (t.dim() - 1)))
        out[k] = distribute_tensor(t, mesh, placements(spec, mesh),
                                   src_data_rank=None)
    return out
