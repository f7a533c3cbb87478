"""Roofline analysis of the port: the per-rank FLOP, byte, collective
and memory counts of an eager step (``counting``, ``collectives``, the
counterpart of the reference package's HLO parsing), the three-term
roofline on the H100 (``analysis``), the per-block units of a dry-run
cell (``costing``), plus the ahead-of-time harvest of a served model's
decision keys and the oracle-driven pruning of an install's knob space."""
from .analysis import HW, RooflineReport, model_flops, roofline
from .collectives import COLLECTIVE_KINDS, CollectiveCounter, wire_bytes
from .costing import (Unit, cell_units, corrected_costs,
                      prune_dominated_candidates, unit_costs)
from .counting import StepCounter, count_step
from .harvest import (Recorder, abstract_batch, dot_call_sites,
                      harvest_decision_keys)

__all__ = ["HW", "RooflineReport", "model_flops", "roofline",
           "COLLECTIVE_KINDS", "CollectiveCounter", "wire_bytes",
           "StepCounter", "count_step", "Unit", "cell_units", "unit_costs",
           "corrected_costs", "Recorder", "abstract_batch",
           "dot_call_sites", "harvest_decision_keys",
           "prune_dominated_candidates"]
