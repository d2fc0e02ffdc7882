"""All-or-nothing gang placement search over a fleet of MIG devices.

The cluster (core/cluster.py) cannot place a gang one slice at a time —
either every member gets a slice or none do, and *where* the members land
changes the gang's effective step time through the communication model
(comms.py). This module owns the search; the cluster supplies the fleet
through two callbacks so the search stays scheduler-agnostic and jax-free:

  capacities  per-device member capacity (how many members an otherwise
              unchanged device admits right now), in fleet order;
  probe       place a specific contiguous rank block on a specific device,
              returning the concrete (placement, member step) pairs the
              device's scheduler would bind — or None if they no longer
              all fit together.

Two candidate splits are generated and scored under a lexicographic
objective, mirroring the placement planner's style (core/planner/):

  pack    fewest devices: capacity-descending greedy fill — the
          co-located shape, contiguous same-device slice sets;
  spread  one member per device round-robin — the scattered shape the
          comms model prices against.

``prefer="colocate"`` scores (spread asc, priced gang step asc, device
names) so pack wins whenever feasible; ``prefer="scatter"`` flips the
spread term — that knob is what benchmarks/report.py's gang table uses to
show co-located strictly beating scattered goodput. Ranks are assigned to
devices in contiguous blocks, so tensor-parallel neighbours (the
fastest-varying, chattiest axis — parallelism.py's rank layout) share a
device whenever the split allows it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.core.gang.comms import DEFAULT_LINK, LinkModel, comm_overhead_s
from repro_torch.core.gang.parallelism import Parallelism

# probe(device_index, ranks) -> [(placement, member_step_s), ...] or None
ProbeFn = Callable[[int, Sequence[int]], Optional[List[Tuple[Any, float]]]]


@dataclasses.dataclass(frozen=True)
class MemberSlot:
    """One gang member bound to one device slice."""

    rank: int
    device: str
    placement: Any  # core/profiles.py Placement — opaque here
    step_s: float  # the member's solo step on its slice (pre-comms)


@dataclasses.dataclass(frozen=True)
class GangPlan:
    """A feasible all-or-nothing placement for every member of a gang."""

    slots: Tuple[MemberSlot, ...]  # rank order
    step_s: float  # effective gang step: max member + comm overhead
    comm_s: float  # the comm overhead term alone
    spread: int  # distinct devices spanned

    @property
    def devices(self) -> Tuple[str, ...]:
        """Device per rank — what the cluster records on the ClusterJob."""
        return tuple(s.device for s in self.slots)

    def provenance(self) -> dict:
        """Decision summary for the trace layer (core/obs/): where every
        rank landed and what the candidate cost — the terms the pack/spread
        search ranked by, so a ``gang_place`` instant explains why this
        layout beat the alternatives."""
        return {
            "devices": sorted(set(self.devices)),
            "slots": [
                f"r{s.rank}:{s.device}:{s.placement.profile}" for s in self.slots
            ],
            "spread": self.spread,
            "step_s": self.step_s,
            "comm_s": self.comm_s,
        }


def split_counts(
    capacities: Sequence[int], world_size: int, prefer: str
) -> Optional[List[Tuple[int, int]]]:
    """Assign ``world_size`` members to devices as ``(device_index, count)``
    blocks, or None when the fleet lacks capacity.

    ``prefer="colocate"``: capacity-descending greedy — provably the
    minimum device count for independent per-device capacities.
    ``prefer="scatter"``: round-robin one member at a time over every
    device with spare capacity, maximizing the number of devices spanned.
    Ties break on fleet order (device index), keeping the split a pure
    function of the capacity vector — the determinism contract.
    """
    if world_size > sum(capacities):
        return None
    if prefer == "scatter":
        counts = [0] * len(capacities)
        left = world_size
        while left > 0:
            progressed = False
            for i, cap in enumerate(capacities):
                if counts[i] < cap:
                    counts[i] += 1
                    left -= 1
                    progressed = True
                    if left == 0:
                        break
            if not progressed:  # pragma: no cover - guarded by the sum check
                return None
        return [(i, c) for i, c in enumerate(counts) if c > 0]
    order = sorted(range(len(capacities)), key=lambda i: (-capacities[i], i))
    split: List[Tuple[int, int]] = []
    left = world_size
    for i in order:
        if left == 0:
            break
        take = min(capacities[i], left)
        if take > 0:
            split.append((i, take))
            left -= take
    return split if left == 0 else None


def _realize(
    split: Sequence[Tuple[int, int]],
    device_names: Sequence[str],
    par: Parallelism,
    probe: ProbeFn,
    collective_s: float,
    link: LinkModel,
) -> Optional[GangPlan]:
    """Probe a split into a concrete GangPlan; None if any block fails."""
    slots: List[MemberSlot] = []
    rank = 0
    for dev_idx, count in split:
        ranks = list(range(rank, rank + count))
        placed = probe(dev_idx, ranks)
        if placed is None or len(placed) != count:
            return None
        for r, (pl, step) in zip(ranks, placed):
            slots.append(MemberSlot(r, device_names[dev_idx], pl, float(step)))
        rank += count
    rank_device = {s.rank: s.device for s in slots}
    comm = comm_overhead_s(par, rank_device, collective_s, link)
    step = max(s.step_s for s in slots) + comm
    return GangPlan(
        slots=tuple(slots),
        step_s=float(step),
        comm_s=float(comm),
        spread=len({s.device for s in slots}),
    )


def plan_gang(
    par: Parallelism,
    device_names: Sequence[str],
    capacities: Sequence[int],
    probe: ProbeFn,
    collective_s: float,
    *,
    prefer: str = "colocate",
    link: LinkModel = DEFAULT_LINK,
) -> Optional[GangPlan]:
    """Search for an all-or-nothing placement of ``par.world_size`` members.

    Both candidate splits are realized and scored lexicographically:
    colocate prefers (fewer devices, lower comm-priced gang step, device
    names); scatter prefers (more devices, ...). Returns the winner, or
    None when no candidate covers every member — admission stays
    all-or-nothing, the caller never sees a partial gang.
    """
    if prefer not in ("colocate", "scatter"):
        raise ValueError(f"prefer must be 'colocate' or 'scatter', got {prefer!r}")
    if len(device_names) != len(capacities):
        raise ValueError("device_names and capacities must align")
    world_size = par.world_size
    candidates: List[GangPlan] = []
    for mode in ("colocate", "scatter"):
        split = split_counts(capacities, world_size, mode)
        if split is None:
            continue
        plan = _realize(split, device_names, par, probe, collective_s, link)
        if plan is not None:
            candidates.append(plan)
    if not candidates:
        return None
    sign = 1 if prefer == "colocate" else -1
    return min(
        candidates, key=lambda p: (sign * p.spread, p.step_s, p.devices)
    )
