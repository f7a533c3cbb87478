"""Distributed runtime: fault tolerance (``PreemptionGuard``,
``StragglerDetector``, ``RetryPolicy``) and fleet coordination, file-based
membership with heartbeats (``FleetMembership``).  Meshes, resharding and
the sharded training step wait for the distributed slice."""
from .elastic import FleetMembership
from .fault_tolerance import PreemptionGuard, RetryPolicy, StragglerDetector

__all__ = ["FleetMembership", "PreemptionGuard", "RetryPolicy",
           "StragglerDetector"]
