"""Distributed runtime: the process group (``init_world``), the elastic
mesh helpers (``best_mesh``, ``reshard``, ``abstract_like``), GPipe
pipeline parallelism (``gpipe_forward``), fault tolerance
(``PreemptionGuard``, ``StragglerDetector``, ``RetryPolicy``) and fleet
coordination, file-based membership with heartbeats
(``FleetMembership``)."""
from .elastic import (FleetMembership, abstract_like, best_mesh,
                      best_mesh_shape, reshard)
from .fault_tolerance import PreemptionGuard, RetryPolicy, StragglerDetector
from .pipeline import bubble_fraction, gpipe_forward
from .world import close_world, init_world

__all__ = ["FleetMembership", "PreemptionGuard", "RetryPolicy",
           "StragglerDetector", "abstract_like", "best_mesh",
           "best_mesh_shape", "bubble_fraction", "close_world",
           "gpipe_forward", "init_world", "reshard"]
