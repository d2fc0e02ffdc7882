"""Workload API v2: phase-aware demand traces for training AND inference.

The paper's collocation verdicts assume steady-state *training* jobs: one
flat demand vector per job for its whole lifetime (the `JobSpec` model).
But its own sub-saturation argument — collocation wins exactly when a job
leaves engines idle — applies even more strongly to inference, and related
work shows the flat model is the wrong abstraction for mixed fleets:
MIGPerf (Zhang et al., 2023) measures training+inference mixes on MIG
behaving qualitatively differently from training-only mixes, and MISO
(Li et al., 2022) shows demand-aware dynamic reconfiguration beating any
static partition. Both need a workload whose resource demand *varies over
time*. This module is that abstraction:

  Workload      a named sequence of phases plus a kind-specific objective:
                  TRAIN  warmup -> steady -> checkpoint, objective =
                         throughput (useful steps per second);
                  SERVE  prefill -> decode, objective = step-latency SLO
                         attainment on the latency-sensitive decode steps;
  Phase         one lifecycle stage with its own duration model (a fixed
                step count, or elastic — absorbing the remaining steps)
                and its own per-resource demand vector;
  DemandTrace   the per-phase demand vector, expressed as multipliers over
                the *steady-state* roofline/DCGM vector the characterization
                pipeline already measures (telemetry/roofline.py). Steady is
                the identity by construction — phase demand is derived from
                the existing telemetry, never a parallel set of constants.

Phase demand semantics (why multipliers, not absolutes): a job's absolute
step-time terms depend on which instance profile it lands on — the char DB
carries one record per (arch, shape, profile). A phase scales every record
the same way (a checkpoint burst is memory-heavy on a 1g.5gb slice and on
the full device alike), so the multiplier form composes with the whole
existing characterization machinery for free: ``phase_step_s`` rescales any
record, and ``SoloProfile.scaled`` (core/sharing.py) feeds the active
phase's vector into the shared-mode contention models.

`JobSpec` stays supported as a thin single-phase adapter
(:func:`from_jobspec` — one elastic ``steady`` phase, identity demand), so
every existing entry point, artifact, and test runs unchanged: identity
demand leaves every characterization record's step time and footprint
untouched (``phase_step_s`` returns ``rec["step_s"]`` verbatim,
``SoloProfile.scaled`` returns ``self``). Note the one deliberate model
change that is *not* phase-gated: the MPS dispatch-queue latency factor
(core/sharing.py) also re-times flat-job mixes whose aggregate compute
demand saturates — that is the mechanism change, not an adapter leak.

Import discipline: this module is part of the jax-free scheduling stack
(see tests/test_jax_free_core.py) — it may import core/instance.py,
core/sharing.py, and core/gang/parallelism.py only.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ShapeSuite
from repro_torch.core.gang.parallelism import (
    Parallelism,
    gang_world_size,
    member_memory_fraction,
    resolve_parallelism,
)
from repro_torch.core.instance import JobSpec


class WorkloadKind(str, enum.Enum):
    """What the job is for — selects the objective the cluster optimizes."""

    TRAIN = "train"  # objective: throughput (useful steps / second)
    SERVE = "serve"  # objective: p99 step latency / SLO attainment


@dataclasses.dataclass(frozen=True)
class DemandTrace:
    """Per-resource demand vector of one phase, as multipliers over the
    steady-state roofline vector (compute_s / memory_s / collective_s /
    dispatch-latency / peak memory) from the characterization record.

    The identity trace IS the steady phase: demand derived from the
    measured telemetry, nothing invented."""

    compute: float = 1.0
    memory: float = 1.0
    collective: float = 1.0
    latency: float = 1.0
    mem_bytes: float = 1.0  # scales the phase's peak working set

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not v >= 0.0:
                raise ValueError(f"DemandTrace.{f.name} must be >= 0, got {v}")

    @property
    def is_identity(self) -> bool:
        return self == STEADY_DEMAND


#: Steady training / generic demand — the telemetry-derived baseline.
STEADY_DEMAND = DemandTrace()

#: First steps after (re)placement: cold caches, compiler autotuning, input
#: pipeline warm-up — compute and dispatch run fat until traces settle.
WARMUP_DEMAND = DemandTrace(compute=1.25, memory=1.10, latency=2.0)

#: Checkpoint burst: parameters + optimizer state stream out through HBM to
#: the host; the MXU mostly idles, and the serialization staging buffer
#: raises the peak working set slightly above steady state.
CHECKPOINT_DEMAND = DemandTrace(
    compute=0.15, memory=2.5, collective=0.5, mem_bytes=1.05
)

#: Prefill: one dense forward pass over the prompt — compute-shaped like a
#: third of a training step (no backward, no optimizer), working set roughly
#: halved (weights + KV cache, no gradients or optimizer state).
PREFILL_DEMAND = DemandTrace(
    compute=0.40, memory=0.35, collective=0.30, mem_bytes=0.50
)

#: Decode: one token per step — tiny compute, weight/KV-cache streaming
#: dominates the busy time, and the dispatch-latency floor dominates the
#: step. This is the paper's GRACT << 1 sub-saturation regime, which is why
#: inference is collocation's best case — and its latency SLO the most
#: exposed to neighbours.
DECODE_DEMAND = DemandTrace(
    compute=0.05, memory=0.60, collective=0.10, mem_bytes=0.45
)


@dataclasses.dataclass(frozen=True)
class Phase:
    """One lifecycle stage: a demand vector plus a duration model.

    ``steps`` is the duration in steps; ``None`` marks the phase *elastic*
    — it absorbs however many steps the fixed phases leave over (at most
    one phase of a workload may be elastic). ``latency_sensitive`` marks
    the steps the serve SLO is scored on (decode)."""

    name: str
    demand: DemandTrace = STEADY_DEMAND
    steps: Optional[int] = None
    latency_sensitive: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("phase needs a name")
        if self.steps is not None and self.steps < 0:
            raise ValueError(f"phase {self.name!r}: steps must be >= 0")


@dataclasses.dataclass(frozen=True)
class PhaseSpan:
    """A phase resolved onto a concrete step interval [start, end)."""

    name: str
    demand: DemandTrace
    start_step: int
    end_step: int
    latency_sensitive: bool = False

    @property
    def steps(self) -> int:
        return self.end_step - self.start_step


@dataclasses.dataclass(frozen=True)
class Workload:
    """A job as a named sequence of phases with a kind-specific objective.

    Field layout is a strict superset of what the scheduler and cluster
    read off a ``JobSpec`` (name / arch / suite / priority / min_profile),
    so a Workload flows through ``CollocationScheduler`` and ``Cluster``
    anywhere a JobSpec does."""

    name: str
    arch: str
    suite: ShapeSuite
    kind: WorkloadKind = WorkloadKind.TRAIN
    phases: Tuple[Phase, ...] = (Phase("steady"),)
    priority: int = 0
    # floor on the MIG profile the scheduler may pick (straggler repack)
    min_profile: Optional[str] = None
    # SERVE objective: per-step latency target on latency-sensitive steps
    slo_step_s: Optional[float] = None
    # gang scheduling (core/gang/): > 1 => this job runs as world_size
    # cooperating members, each on its own MIG slice, admitted
    # all-or-nothing; parallelism describes the tensor/pipeline/data
    # split (None = plain data parallelism over world_size)
    world_size: int = 1
    parallelism: Optional[Parallelism] = None
    # gang this workload is a *member* of — set only on the per-rank specs
    # the cluster binds to slices (mirrors JobSpec.gang); user-submitted
    # workloads leave it None
    gang: Optional[str] = None

    def __post_init__(self):
        if not self.phases:
            raise ValueError(f"workload {self.name!r} needs at least one phase")
        elastic = [p.name for p in self.phases if p.steps is None]
        if len(elastic) > 1:
            raise ValueError(
                f"workload {self.name!r}: at most one elastic phase, "
                f"got {elastic}"
            )
        if self.world_size < 1:
            raise ValueError(
                f"workload {self.name!r}: world_size must be >= 1, "
                f"got {self.world_size}"
            )
        if self.parallelism is not None and (
            self.parallelism.world_size != self.world_size
        ):
            raise ValueError(
                f"workload {self.name!r}: parallelism "
                f"{self.parallelism.label} implies world_size "
                f"{self.parallelism.world_size}, declared {self.world_size}"
            )

    @property
    def peak_demand_multiplier(self) -> float:
        """Phase-peak memory multiplier — what admission must budget for:
        the job will live through its hungriest phase on this placement."""
        return max(p.demand.mem_bytes for p in self.phases)

    @property
    def objective(self) -> str:
        return "slo" if self.kind == WorkloadKind.SERVE else "throughput"

    def resolve(self, total_steps: int) -> Tuple[PhaseSpan, ...]:
        """Pin the phase sequence onto ``total_steps`` concrete steps.

        Fixed phases take their declared steps (clamped when the budget
        runs out); the elastic phase absorbs the remainder. If no phase is
        elastic, the last phase that fits extends to cover the tail, so the
        spans always partition [0, total_steps) exactly."""
        total = max(1, int(total_steps))
        fixed = sum(p.steps for p in self.phases if p.steps is not None)
        elastic_steps = max(0, total - fixed)
        spans = []
        cursor = 0
        for p in self.phases:
            n = elastic_steps if p.steps is None else p.steps
            n = min(n, total - cursor)
            if n <= 0:
                continue
            spans.append(
                PhaseSpan(p.name, p.demand, cursor, cursor + n,
                          p.latency_sensitive)
            )
            cursor += n
        if not spans:  # total smaller than every declared phase: first wins
            p = self.phases[0]
            return (PhaseSpan(p.name, p.demand, 0, total, p.latency_sensitive),)
        if cursor < total:  # no elastic phase (or it got 0): extend the tail
            last = spans[-1]
            spans[-1] = dataclasses.replace(last, end_step=total)
        return tuple(spans)


def span_at(spans: Sequence[PhaseSpan], steps_done: float) -> PhaseSpan:
    """The span containing ``steps_done`` (the last span once past the end)."""
    for s in spans:
        if steps_done < s.end_step:
            return s
    return spans[-1]


# -- constructors --------------------------------------------------------------


def train_workload(
    name: str,
    arch: str,
    suite: ShapeSuite,
    *,
    warmup_steps: int = 5,
    checkpoint_steps: int = 2,
    priority: int = 0,
    min_profile: Optional[str] = None,
) -> Workload:
    """Training job: warmup burst, elastic steady bulk, checkpoint drain."""
    return Workload(
        name=name,
        arch=arch,
        suite=suite,
        kind=WorkloadKind.TRAIN,
        phases=(
            Phase("warmup", WARMUP_DEMAND, warmup_steps),
            Phase("steady", STEADY_DEMAND, None),
            Phase("checkpoint", CHECKPOINT_DEMAND, checkpoint_steps),
        ),
        priority=priority,
        min_profile=min_profile,
    )


def serve_workload(
    name: str,
    arch: str,
    suite: ShapeSuite,
    *,
    slo_step_s: float,
    prefill_steps: int = 2,
    priority: int = 0,
    min_profile: Optional[str] = None,
) -> Workload:
    """Inference session: prefill burst, then elastic latency-bound decode."""
    return Workload(
        name=name,
        arch=arch,
        suite=suite,
        kind=WorkloadKind.SERVE,
        phases=(
            Phase("prefill", PREFILL_DEMAND, prefill_steps),
            Phase("decode", DECODE_DEMAND, None, latency_sensitive=True),
        ),
        priority=priority,
        min_profile=min_profile,
        slo_step_s=float(slo_step_s),
    )


def from_jobspec(spec: JobSpec) -> Workload:
    """The backward-compat adapter: one elastic steady phase, identity
    demand — byte-for-byte the old flat-JobSpec behaviour."""
    return Workload(
        name=spec.name,
        arch=spec.arch,
        suite=spec.suite,
        kind=WorkloadKind.TRAIN,
        phases=(Phase("steady", STEADY_DEMAND, None),),
        priority=spec.priority,
        min_profile=spec.min_profile,
        world_size=spec.world_size,
        parallelism=spec.parallelism,
        gang=spec.gang,
    )


def as_workload(job: Union[JobSpec, Workload]) -> Workload:
    """Normalize either job type to the phase-aware form."""
    if isinstance(job, Workload):
        return job
    if isinstance(job, JobSpec):
        return from_jobspec(job)
    raise TypeError(f"expected JobSpec or Workload, got {type(job).__name__}")


def peak_demand_multiplier(job: Union[JobSpec, Workload]) -> float:
    """Phase-peak memory multiplier for admission; 1.0 for flat JobSpecs.

    For gang members (``world_size > 1``) the phase peak is further scaled
    by the member memory fraction (core/gang/parallelism.py): one member
    budgets only its shard of the model state, which is exactly what lets
    a job no single slice admits run as a gang of smaller slices."""
    base = job.peak_demand_multiplier if isinstance(job, Workload) else 1.0
    if gang_world_size(job) > 1:
        base *= member_memory_fraction(resolve_parallelism(job))
    return base


def member_demand(job: Union[JobSpec, Workload], demand: DemandTrace) -> DemandTrace:
    """One gang member's demand vector for an active phase: busy-time
    terms divide by ``world_size`` (the work is split), the collective
    term survives untouched (members still run the solo program's own
    collectives — inter-member traffic is priced separately by
    core/gang/comms.py), and ``mem_bytes`` scales by the member memory
    fraction. Identity for world_size 1."""
    ws = gang_world_size(job)
    if ws <= 1:
        return demand
    frac = member_memory_fraction(resolve_parallelism(job))
    return DemandTrace(
        compute=demand.compute / ws,
        memory=demand.memory / ws,
        collective=demand.collective,
        latency=demand.latency,
        mem_bytes=demand.mem_bytes * frac,
    )


# -- record algebra ------------------------------------------------------------


def phase_step_s(rec: Mapping, demand: DemandTrace) -> float:
    """Step time of one phase on one characterized instance record.

    The record's roofline terms are scaled by the phase's demand vector and
    re-maxed; whatever part of the recorded step was not busy time (the
    dispatch-latency floor) scales with the latency multiplier. Identity
    demand returns ``rec["step_s"]`` exactly — flat JobSpecs keep their old
    predicted step times to the bit."""
    step = float(rec.get("step_s", 0.0))
    if demand.is_identity:
        return step
    compute = float(rec.get("compute_s", step))
    memory = float(rec.get("memory_s", 0.0))
    collective = float(rec.get("collective_s", 0.0))
    busy = max(compute, memory, collective)
    residual = max(0.0, step - busy)  # the record's dispatch-latency floor
    scaled_busy = max(
        compute * demand.compute,
        memory * demand.memory,
        collective * demand.collective,
    )
    return residual * demand.latency + scaled_busy


