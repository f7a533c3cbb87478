"""Data substrate (the reference package's ``data``): deterministic,
resumable pipelines, and batches placed on one device or on a mesh."""
from .pipeline import (ByteCorpusDataset, SyntheticLMDataset,
                       make_device_batch, make_global_batch)
__all__ = ["ByteCorpusDataset", "SyntheticLMDataset", "make_device_batch",
           "make_global_batch"]
