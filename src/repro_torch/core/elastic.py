"""Elastic re-partitioning: the MIG-reconfiguration analogue for pod slices.

Fault model: a *slice unit* (32-chip block) becomes unhealthy — chips lost,
links flapping, or persistent stragglers localized to the block. MIG's answer
is to destroy and re-create GPU instances around the bad slice; ours is the
same algebra on the placement tree:

  1. mark failed units; every instance whose span intersects them dies;
  2. jobs from dead instances re-enter the queue (priority bumped so they
     reclaim capacity first), joined by still-pending jobs;
  3. the scheduler re-packs onto the surviving units — the placement tree is
     filtered to placements that avoid failed units;
  4. re-placed jobs resume from their last checkpoint (checkpoint/),
     which is exactly the paper's "no interference" guarantee doing real
     work: survivors never restart, because their instances were untouched.

Elastic *scale-up* is the same path in reverse: units returning to health
re-enter the free set and the next scheduling round may widen placements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.core.collocation import Assignment, CollocationScheduler, Schedule
from repro_torch.core.device import get_sku
from repro_torch.core.instance import JobSpec
from repro_torch.core.profiles import Placement
from repro_torch.core.sharing import CollocationMode

# priority bump applied to killed jobs so they reclaim capacity first when
# they re-enter the queue (shared with the cluster's failure/migration path)
REQUEUE_PRIORITY_BUMP = 10


def span_units(pl: Placement, sku=None) -> Set[int]:
    """Slice units an instance placement occupies on ``sku`` (the full
    profile owns every unit by the SKU invariant; default A100-40GB)."""
    return set(get_sku(sku).units(pl))


def split_by_failure(
    assignments: Sequence[Assignment], failed: Set[int], sku=None
) -> Tuple[List[JobSpec], List[Assignment]]:
    """Partition assignments into (killed job specs, surviving assignments).

    Killed jobs come back with their priority bumped — the elastic-repack
    re-queue semantics both ``ElasticController.repack`` and the cluster's
    FAILURE event handler apply. Survivors are returned untouched (F3: their
    instances never intersected the failed units, so they keep running).

    Gang members (specs carrying ``gang``) fail collectively: a gang
    advances in lockstep, so losing one member stalls the rest — any
    member whose span intersects the failed units drags its same-device
    siblings into the killed set too, never leaving them behind as
    orphans to be silently re-timed. The cluster's FAILURE handler then
    widens the kill to the gang's *other* devices and re-queues the gang
    once (core/cluster.py).
    """
    hit_gangs: Set[str] = set()
    for a in assignments:
        gang = getattr(a.job, "gang", None)
        if gang and span_units(a.placement, sku) & failed:
            hit_gangs.add(gang)
    killed: List[JobSpec] = []
    survivors: List[Assignment] = []
    for a in assignments:
        gang = getattr(a.job, "gang", None)
        if span_units(a.placement, sku) & failed or (gang in hit_gangs):
            killed.append(
                dataclasses.replace(a.job, priority=a.job.priority + REQUEUE_PRIORITY_BUMP)
            )
        else:
            survivors.append(a)
    return killed, survivors


@dataclasses.dataclass
class RepackEvent:
    failed_units: Tuple[int, ...]
    killed_jobs: Tuple[str, ...]
    survivors: Tuple[str, ...]
    new_schedule: Schedule
    resumed_from_checkpoint: Tuple[str, ...]


class ElasticController:
    """Tracks unit health and drives repacking through the scheduler."""

    def __init__(self, scheduler: CollocationScheduler):
        self.scheduler = scheduler
        self.failed: Set[int] = set()

    def mark_failed(self, units: Sequence[int]) -> None:
        self.failed.update(units)

    def mark_healthy(self, units: Sequence[int]) -> None:
        self.failed.difference_update(units)

    def _span_units(self, pl: Placement) -> Set[int]:
        return span_units(pl, self.scheduler.sku)

    def repack(self, schedule: Schedule) -> RepackEvent:
        """Kill intersecting instances, re-pack their jobs onto survivors.

        Shared modes (naive/MPS) have no isolation to fall back on: every
        job spans the whole device, so any unit failure kills the entire
        job set and nothing can be re-placed on the degraded device — the
        contrapositive of the paper's F3 isolation finding. The cluster's
        admission queue (not this controller) re-homes those jobs.
        """
        if schedule.mode != CollocationMode.MIG:
            # (re-queueing with the priority bump is the caller's job — the
            # cluster's FAILURE handler does it; this event only reports)
            return RepackEvent(
                failed_units=tuple(sorted(self.failed)),
                killed_jobs=tuple(a.job.name for a in schedule.assignments),
                survivors=(),
                new_schedule=Schedule([], [], mode=schedule.mode),
                resumed_from_checkpoint=(),
            )

        killed, survivors = split_by_failure(
            schedule.assignments, self.failed, self.scheduler.sku
        )

        # re-pack ONLY the killed jobs into the remaining free units: the
        # scheduler sees survivors' units + failed units as occupied.
        occupied = set(self.failed)
        for a in survivors:
            occupied |= span_units(a.placement, self.scheduler.sku)
        partial = self.scheduler.schedule(
            killed, blocked_units=frozenset(occupied), mode=CollocationMode.MIG
        )

        new = Schedule(
            survivors + partial.assignments, partial.rejections, mode=schedule.mode
        )
        return RepackEvent(
            failed_units=tuple(sorted(self.failed)),
            killed_jobs=tuple(j.name for j in killed),
            survivors=tuple(a.job.name for a in survivors),
            new_schedule=new,
            resumed_from_checkpoint=tuple(
                a.job.name for a in partial.assignments
            ),
        )
