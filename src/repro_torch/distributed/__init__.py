"""Fleet coordination: file-based membership with heartbeats
(``FleetMembership``).  Meshes, resharding and the sharded training step
wait for the distributed slice."""
from .elastic import FleetMembership

__all__ = ["FleetMembership"]
