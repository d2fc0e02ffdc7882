"""Parallelism descriptors for gang-scheduled multi-slice jobs.

A gang is one logical job executed by ``world_size`` cooperating members,
each on its own MIG slice. The descriptor records how the job's work is
split across the members — the same three axes ``sharding/plan.py`` builds
GSPMD meshes from:

  tensor    Megatron-style TP: weights column/row-sharded over the axis,
            activations all-reduced every layer (plan.py's ``model`` axis).
            The chattiest axis — per-layer activation collectives.
  pipeline  GPipe stages (runtime/pipeline.py): layers partitioned, only
            boundary activations cross the axis once per microbatch tick.
            The quietest axis.
  data      ZeRO-3 data parallelism (plan.py's 'zero' variant): batch
            sharded, per-layer weight gathers + gradient reduce-scatters.

The descriptor is the scheduling-side mirror of those runtime modules: it
carries exactly what admission and the comms cost model need — how much
memory each member must budget (:func:`member_memory_fraction`) and which
rank pairs exchange traffic on which axis (:func:`axis_rank_groups`).

Import discipline: this module is the root of the jax-free gang subsystem
and imports nothing from ``repro`` — ``core/instance.py`` and
``core/workload.py`` both depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

#: Fraction of a member's working set that shards with the model-parallel
#: degree (weights, optimizer state, the sharded activations); the rest —
#: replicated activations, staging buffers, the runtime — is resident on
#: every member regardless of the split. The 0.85 figure matches the
#: ZeRO-3/TP regime of sharding/plan.py where parameters and optimizer
#: state dominate the footprint of the large configs.
SHARDABLE_FRACTION = 0.85


@dataclasses.dataclass(frozen=True)
class Parallelism:
    """How a gang splits one job over ``world_size`` members.

    Rank layout is row-major with ``tensor`` fastest-varying (the
    convention of sharding/plan.py's merged meshes):
    ``rank = (data_idx * pipeline + pipe_idx) * tensor + tensor_idx``.
    """

    tensor: int = 1
    pipeline: int = 1
    data: int = 1

    def __post_init__(self):
        for axis in ("tensor", "pipeline", "data"):
            d = getattr(self, axis)
            if not (isinstance(d, int) and d >= 1):
                raise ValueError(
                    f"Parallelism.{axis} must be an int >= 1, got {d!r}"
                )

    @property
    def world_size(self) -> int:
        return self.tensor * self.pipeline * self.data

    @property
    def model_degree(self) -> int:
        """Ways the *model state* is split (TP x PP) — data parallelism
        replicates parameters, so it never shrinks a member's footprint
        here (the ZeRO gather re-materializes them layer by layer)."""
        return self.tensor * self.pipeline

    def axis_degrees(self) -> Dict[str, int]:
        return {"tensor": self.tensor, "pipeline": self.pipeline,
                "data": self.data}

    @property
    def label(self) -> str:
        return f"tp{self.tensor}.pp{self.pipeline}.dp{self.data}"


#: Descriptors the simulator CLI accepts by name (launch/simulate.py
#: errors with this list on unknown values).
PARALLELISMS: Dict[str, Parallelism] = {
    "tp2": Parallelism(tensor=2),
    "tp4": Parallelism(tensor=4),
    "pp2": Parallelism(pipeline=2),
    "pp4": Parallelism(pipeline=4),
    "dp2": Parallelism(data=2),
    "tp2.pp2": Parallelism(tensor=2, pipeline=2),
}


def resolve_parallelism(job) -> Parallelism:
    """Descriptor lookup for every spelling a caller may hold: a
    registry name (KeyError listing the registered choices on a miss —
    the CLI's unknown-value contract), a :class:`Parallelism` itself, or
    a job carrying one. A job without a descriptor resolves to plain
    data-parallel over its ``world_size`` (weights replicated — the
    conservative default)."""
    if isinstance(job, str):
        try:
            return PARALLELISMS[job]
        except KeyError:
            raise KeyError(
                f"unknown parallelism {job!r}; registered: "
                + ", ".join(sorted(PARALLELISMS))
            ) from None
    if isinstance(job, Parallelism):
        return job
    p = getattr(job, "parallelism", None)
    if p is not None:
        return p
    return Parallelism(data=max(1, int(getattr(job, "world_size", 1))))


def gang_world_size(job) -> int:
    """Member count of ``job`` — 1 for every pre-gang JobSpec/Workload."""
    return int(getattr(job, "world_size", 1) or 1)


def is_gang(job) -> bool:
    return gang_world_size(job) > 1


def member_memory_fraction(par: Parallelism) -> float:
    """Fraction of the solo-job working set one member must hold.

    ``(1 - S) + S / model_degree`` with S the shardable fraction: the
    model-parallel split divides parameters/optimizer state, the rest is
    replicated on every member. Degree 1 (pure DP) is exactly 1.0 — each
    member holds the whole model, as plan.py's zero variant does between
    layer gathers at its per-layer peak."""
    m = max(1, par.model_degree)
    return (1.0 - SHARDABLE_FRACTION) + SHARDABLE_FRACTION / m


def member_name(gang_name: str, rank: int) -> str:
    """Per-member assignment key — unique within a device's assignment
    map, recoverable back to the gang via :func:`gang_of_member`."""
    return f"{gang_name}#r{rank}"


def gang_of_member(name: str) -> str:
    """Inverse of :func:`member_name` (identity for non-member names)."""
    base, sep, rank = name.rpartition("#r")
    if sep and rank.isdigit():
        return base
    return name


def rank_coords(par: Parallelism, rank: int) -> Tuple[int, int, int]:
    """(tensor_idx, pipe_idx, data_idx) of ``rank`` under the row-major
    layout documented on :class:`Parallelism`."""
    t = rank % par.tensor
    p = (rank // par.tensor) % par.pipeline
    d = rank // (par.tensor * par.pipeline)
    return t, p, d


def axis_rank_groups(par: Parallelism) -> Dict[str, List[Tuple[int, ...]]]:
    """Per axis: the rank groups that communicate over it (one group per
    fixed setting of the other two axes). Groups for degree-1 axes are
    omitted — no traffic flows on them."""
    out: Dict[str, List[Tuple[int, ...]]] = {}
    ws = par.world_size
    ranks = list(range(ws))
    for axis in ("tensor", "pipeline", "data"):
        if par.axis_degrees()[axis] == 1:
            continue
        groups: Dict[Tuple[int, int], List[int]] = {}
        for r in ranks:
            t, p, d = rank_coords(par, r)
            key = {
                "tensor": (p, d),
                "pipeline": (t, d),
                "data": (t, p),
            }[axis]
            groups.setdefault(key, []).append(r)
        out[axis] = [tuple(g) for _, g in sorted(groups.items())]
    return out
