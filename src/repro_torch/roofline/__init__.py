"""Ahead-of-time harvest of a served model's decision keys and the
oracle-driven pruning of an install's knob space (the reference package's
HLO parsing and sharded costing are not ported)."""
from .costing import prune_dominated_candidates
from .harvest import (Recorder, abstract_batch, dot_call_sites,
                      harvest_decision_keys)

__all__ = ["Recorder", "abstract_batch", "dot_call_sites",
           "harvest_decision_keys", "prune_dominated_candidates"]
