"""Gang scheduling: multi-slice / multi-device jobs (Flex-MIG direction).

Jax-free subsystem (tests/test_jax_free_core.py). Three modules:

  parallelism.py  the tensor/pipeline/data descriptor a gang job carries,
                  member memory math, rank/axis layout;
  comms.py        the per-link communication cost model that prices
                  co-located vs scattered slice sets into step time;
  placement.py    all-or-nothing gang placement search over the fleet —
                  scheduler-agnostic (the cluster supplies capacities and
                  a probe callback), re-exported separately so the cheap
                  descriptor imports in instance.py/workload.py never pull
                  the search machinery.

See docs/gang_scheduling.md for the admission protocol and failure
semantics.
"""
from repro_torch.core.gang.comms import (
    AXIS_TRAFFIC,
    DEFAULT_LINK,
    LinkModel,
    comm_overhead_s,
    gang_step_s,
    placement_spread,
    ring_links,
)
from repro_torch.core.gang.parallelism import (
    PARALLELISMS,
    SHARDABLE_FRACTION,
    Parallelism,
    axis_rank_groups,
    gang_of_member,
    gang_world_size,
    is_gang,
    member_memory_fraction,
    member_name,
    rank_coords,
    resolve_parallelism,
)

__all__ = [
    "AXIS_TRAFFIC",
    "DEFAULT_LINK",
    "LinkModel",
    "PARALLELISMS",
    "SHARDABLE_FRACTION",
    "Parallelism",
    "axis_rank_groups",
    "comm_overhead_s",
    "gang_of_member",
    "gang_step_s",
    "gang_world_size",
    "is_gang",
    "member_memory_fraction",
    "member_name",
    "placement_spread",
    "rank_coords",
    "resolve_parallelism",
    "ring_links",
]
