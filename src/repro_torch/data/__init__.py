"""Data substrate (the reference package's ``data``): deterministic,
resumable pipelines, and batches placed on one device."""
from .pipeline import ByteCorpusDataset, SyntheticLMDataset, make_device_batch
__all__ = ["ByteCorpusDataset", "SyntheticLMDataset", "make_device_batch"]
