"""Communication cost model for gang placements.

Prices the *inter-member* collectives a gang adds on top of each member's
own (intra-slice) step, as a per-step overhead in seconds. Two link
classes, mirroring the hardware the placement decides between:

  intra   members on the SAME device: MIG slices share the package, so
          member-to-member traffic rides the on-device fabric (NVLink
          class) at the baseline bandwidth the characterization records'
          ``collective_s`` is already expressed in;
  cross   members on DIFFERENT devices: traffic crosses the node
          interconnect at a fraction of that bandwidth and pays a
          per-step hop latency.

That asymmetry is the whole point of gang-aware placement: a co-located
slice set is strictly cheaper than a scattered one whenever the gang
exchanges any bytes at all (and never more expensive — the latency term
alone breaks the tie for pure-compute gangs).

Traffic volume is derived from the solo record's ``collective_s`` — the
same derive-don't-invent convention the phase demand vectors use
(core/workload.py): an axis of degree d moves ``(d-1)/d`` of a ring
all-reduce's bytes per member, weighted by how chatty the axis is
(tensor >> data >> pipeline; see AXIS_TRAFFIC and runtime/pipeline.py /
sharding/plan.py for the mechanics each weight abstracts).

Jax-free; imports only the sibling parallelism module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

from repro_torch.core.gang.parallelism import Parallelism, axis_rank_groups

#: Per-axis traffic weight, as a multiple of the solo record's
#: ``collective_s``: TP all-reduces boundary activations every layer
#: (the full collective budget), ZeRO-DP gathers weights/reduces grads
#: once per layer but overlaps with compute, PP only ships stage-boundary
#: activations (runtime/pipeline.py's single ppermute per tick).
AXIS_TRAFFIC: Dict[str, float] = {
    "tensor": 1.0,
    "pipeline": 0.35,
    "data": 0.6,
}


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Relative link speeds, normalized to the on-device fabric = 1.0."""

    #: Cross-device interconnect bandwidth as a fraction of the on-device
    #: fabric (NVLink-to-IB class ratio).
    cross_bandwidth_frac: float = 0.25
    #: Per-step latency charged for each cross-device ring hop.
    cross_latency_s: float = 25e-6

    def __post_init__(self):
        if not (0.0 < self.cross_bandwidth_frac <= 1.0):
            raise ValueError(
                "cross_bandwidth_frac must be in (0, 1], got "
                f"{self.cross_bandwidth_frac}"
            )
        if self.cross_latency_s < 0.0:
            raise ValueError("cross_latency_s must be >= 0")


DEFAULT_LINK = LinkModel()


def ring_links(group: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Ring-neighbour rank pairs of one collective group: the links a
    ring all-reduce (or the GPipe stage chain) actually stresses. Two
    members share a single link; three or more close the ring."""
    g = list(group)
    if len(g) < 2:
        return ()
    if len(g) == 2:
        return ((g[0], g[1]),)
    return tuple(
        (g[i], g[(i + 1) % len(g)]) for i in range(len(g))
    )


def comm_overhead_s(
    par: Parallelism,
    rank_device: Mapping[int, str],
    collective_s: float,
    link: LinkModel = DEFAULT_LINK,
) -> float:
    """Per-step inter-member communication overhead of one placement.

    ``rank_device`` maps every rank to the device hosting its slice.
    Per axis of degree d: each group moves ``weight * collective_s *
    (d-1)/d`` per step, split evenly over its ring links; intra-device
    links carry their share at baseline bandwidth, cross-device links at
    ``cross_bandwidth_frac`` of it plus the hop latency. All members on
    one device => the cross terms vanish entirely.
    """
    collective_s = max(0.0, float(collective_s))
    total = 0.0
    for axis, groups in axis_rank_groups(par).items():
        d = par.axis_degrees()[axis]
        axis_bytes_s = AXIS_TRAFFIC[axis] * collective_s * (d - 1) / d
        for group in groups:
            links = ring_links(group)
            if not links:
                continue
            per_link = axis_bytes_s / len(links)
            for a, b in links:
                if rank_device[a] == rank_device[b]:
                    total += per_link
                else:
                    total += per_link / link.cross_bandwidth_frac
                    total += link.cross_latency_s
    return total


def gang_step_s(
    member_step_s: Sequence[float],
    par: Parallelism,
    rank_device: Mapping[int, str],
    collective_s: float,
    link: LinkModel = DEFAULT_LINK,
) -> float:
    """Effective gang step time: the slowest member (a gang advances in
    lockstep — every collective is a barrier) plus the placement's
    communication overhead."""
    if not member_step_s:
        return 0.0
    return max(member_step_s) + comm_overhead_s(
        par, rank_device, collective_s, link
    )


def placement_spread(rank_device: Mapping[int, str]) -> int:
    """Distinct devices a placement spans (1 == fully co-located)."""
    return len(set(rank_device.values()))
