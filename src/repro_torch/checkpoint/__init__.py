"""Fault-tolerant checkpointing: async, atomic, restored into the
caller's tensors on their device."""
from .checkpointer import Checkpointer
__all__ = ["Checkpointer"]
