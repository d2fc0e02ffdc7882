"""Placement-planner subsystem: partition-tree search + predictive slice fitting.

The greedy ``smallest_admissible``/first-fit packing in ``core/collocation.py``
reproduces the paper's central caveat — MIG's rigid partitioning "may create
sub-optimal GPU utilization for more dynamic mixed workloads" — but never
tries to beat it. This package is the planning layer that does:

  enumerator   every valid partition config of the placement tree
               (core/profiles.py), with memoized canonical forms and the
               legal incremental transitions from a live layout — the
               search space of "Optimal Workload Placement on MIG"
               (arXiv:2409.06646) over our paper-faithful algebra;
  costmodel    MISO-style (arXiv:2207.11428) predictive slice fitting: each
               job's throughput on each candidate slice estimated from its
               characterization record or, when the record is missing,
               predicted from the full-device roofline profile — no
               simulated reconfiguration required;
  optimizer    exact search over (partition config x job->slice assignment)
               maximizing (priority-weighted jobs placed, SLO-constrained
               goodput, residual flexibility), with a beam fallback above a
               size threshold and a reported optimality gap.

Import discipline: like the rest of the scheduling stack this package is
jax-free (tests/test_jax_free_core.py) — it builds on ``core/profiles.py``'s
placement algebra and mirrors ``partitioner.verify_disjoint``'s invariant
(disjoint spans == disjoint device rectangles) without touching meshes.
"""
from repro_torch.core.planner.costmodel import PlanningCostModel, SliceEstimate
from repro_torch.core.planner.enumerator import (
    canonical_form,
    enumerate_configs,
    expansions,
    flexibility,
    free_placements,
    maximal_configs,
    profile_multisets,
    transition,
)
from repro_torch.core.planner.optimizer import PlacementPlan, plan_placements

__all__ = [
    "PlanningCostModel",
    "SliceEstimate",
    "canonical_form",
    "enumerate_configs",
    "expansions",
    "flexibility",
    "free_placements",
    "maximal_configs",
    "profile_multisets",
    "transition",
    "PlacementPlan",
    "plan_placements",
]
