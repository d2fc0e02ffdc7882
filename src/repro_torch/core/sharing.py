"""Collocation modes: naive time-slicing, MPS spatial sharing, MIG partitioning.

The paper's central axis is *how* concurrent training jobs share one device:

  NAIVE  multiple processes submitted to the same device; the driver
         time-slices contexts, so jobs run serially at quantum granularity
         and every switch pays a context-switch + cold-cache penalty;
  MPS    a single shared context; jobs run *concurrently* and partition the
         SMs / memory system spatially, so they contend for whichever
         resource their aggregate demand oversubscribes;
  MIG    hardware partitioning into instances (core/profiles.py); slices are
         interference-free but rigid, and enabling MIG reserves a compute
         slice (F6).

This module gives the two shared modes analytic contention models over the
same roofline terms the characterization pipeline already produces
(telemetry/roofline.py), so all three modes are scored in one currency:
per-job effective step time.

Model. A job's solo profile on the full (non-partitioned) device is its
roofline busy terms plus a per-step dispatch-latency floor::

    busy_s = max(compute_s, memory_s, collective_s)
    step_s = busy_s + latency_s

``latency_s`` is host dispatch / synchronization time during which the
device engines are idle — exactly the sub-saturation the paper measures as
GRACT < 1 and the reason collocation wins at all. Per-resource *activity
fractions* (the DCGM analogues SMACT / DRAMA) follow as ``u_r = r / step_s``.

MPS — spatial sharing with bandwidth contention. Concurrent jobs share each
resource proportionally: resource ``r``'s contention factor is
``F_r = max(1, sum_j u_rj)``; job i's effective terms are ``r_i * F_r`` and
its effective step is ``latency_i * F_lat + max_r(r_i * F_r)``, where the
dispatch-latency factor ``F_lat = max(1, sum_j u_compute_j)`` models kernel
launches queueing behind co-resident jobs' in-flight compute once aggregate
SM demand saturates. Sub-saturating mixes (all ``sum u_r <= 1``) run
interference-free — the paper's headline collocation win; saturated mixes
stretch proportionally, which conserves aggregate resource throughput (fair
sharing). The latency term is what makes training+inference mixes behave
differently from training-only mixes (MIGPerf's finding): a decode step is
almost all dispatch latency, so a saturating training neighbour inflates
its p99 even when no bandwidth resource is contended. All jobs share one
memory space: aggregate footprint must fit the device (the paper's OOM
constraint).

NAIVE — time-slicing with switch overhead. Each quantum runs one job
exclusively; nothing overlaps across jobs, so a scheduling round costs the
*sum* of solo steps, inflated by ``NAIVE_SWITCH_OVERHEAD_FRAC`` (context
switch, pipeline drain, cold cache). Every job's effective step is the full
round: naive collocation never beats sequential execution in this model and
shares the same aggregate-memory constraint — it loses on memory pressure
first (the paper's observed failure mode).

MIG — the existing interference-free partitioning: per-instance records from
``InstanceRuntime.characterize`` are used as-is, every interference factor
is exactly 1.0, and memory admission is per-slice (core/collocation.py).

A useful theorem (test_sharing.py asserts it on the paper grid): MPS
aggregate throughput >= naive aggregate throughput for *any* job mix —
``step_mps_i <= k * step_i`` since every ``F_r <= k`` and ``F_lat <= k``
(each activity fraction is at most 1), so by AM-HM
``sum 1/step_mps_i >= k / sum step_j > naive``'s ``k / ((1+o) sum step_j)``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core.slice_unit import HBM_PER_CHIP

# Per-step host dispatch + sync latency floor (engines idle). This is the
# analytic stand-in for the paper's observed sub-saturation: small workloads
# are latency-dominated, so spatial sharing overlaps their idle time.
STEP_LATENCY_S = 1e-3

# Fractional penalty per time-slice quantum under naive sharing: context
# switch, pipeline drain, cold cache on re-entry.
NAIVE_SWITCH_OVERHEAD_FRAC = 0.07


class CollocationMode(str, enum.Enum):
    """How concurrent jobs share one device."""

    NAIVE = "naive"
    MPS = "mps"
    MIG = "mig"


_RESOURCES = ("compute_s", "memory_s", "collective_s")


@dataclasses.dataclass(frozen=True)
class SoloProfile:
    """One job's solo roofline profile on the full, non-partitioned device."""

    name: str
    compute_s: float
    memory_s: float
    collective_s: float
    latency_s: float = STEP_LATENCY_S
    peak_bytes_per_device: float = 0.0

    @property
    def busy_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_s(self) -> float:
        return self.busy_s + self.latency_s

    def activity(self, resource: str) -> float:
        """DCGM-analogue busy fraction of ``resource`` over the solo step."""
        return getattr(self, resource) / self.step_s if self.step_s else 0.0

    def scaled(self, demand) -> "SoloProfile":
        """This profile under a phase's demand vector (core/workload.py):
        every roofline term, the latency floor, and the working set are
        multiplied by the phase's per-resource demand. Identity demand
        returns ``self`` unchanged, so flat (steady-only) jobs keep their
        exact old contention inputs."""
        if getattr(demand, "is_identity", False):
            return self
        return SoloProfile(
            name=self.name,
            compute_s=self.compute_s * demand.compute,
            memory_s=self.memory_s * demand.memory,
            collective_s=self.collective_s * demand.collective,
            latency_s=self.latency_s * demand.latency,
            peak_bytes_per_device=self.peak_bytes_per_device * demand.mem_bytes,
        )

    @classmethod
    def from_record(
        cls,
        name: str,
        rec: Mapping,
        *,
        undiscount_compute: float = 1.0,
        latency_s: float = STEP_LATENCY_S,
    ) -> "SoloProfile":
        """Build a solo profile from a characterization-DB record.

        Records written by ``launch/collocate.py`` carry the three roofline
        terms; minimal records (tests, hand-built DBs) may only carry
        ``step_s`` — then the step is treated as pure dominant-resource busy
        time (compute). ``undiscount_compute`` removes the F6 reserved-slice
        discount when the record was characterized with MIG enabled but the
        shared modes run with MIG off (no reserved slice).
        """
        step = float(rec.get("step_s", 0.0))
        compute = float(rec.get("compute_s", step)) * undiscount_compute
        memory = float(rec.get("memory_s", 0.0))
        coll = float(rec.get("collective_s", 0.0))
        return cls(
            name=name,
            compute_s=compute,
            memory_s=memory,
            collective_s=coll,
            latency_s=latency_s,
            peak_bytes_per_device=float(rec.get("peak_bytes_per_device", 0.0)),
        )


@dataclasses.dataclass
class SharedModeReport:
    """Outcome of running a job set under one shared collocation mode."""

    mode: CollocationMode
    effective_step_s: Dict[str, float]  # job name -> effective step time
    interference: Dict[str, float]  # job name -> effective / solo (>= 1)
    contention: Dict[str, float]  # resource -> F_r (1.0 == no contention)
    aggregate_peak_bytes: float
    hbm_budget_bytes: float

    @property
    def fits(self) -> bool:
        return self.aggregate_peak_bytes <= self.hbm_budget_bytes

    @property
    def throughput_jobs_per_s(self) -> float:
        return sum(1.0 / t for t in self.effective_step_s.values() if t > 0)

    @property
    def max_interference(self) -> float:
        return max(self.interference.values(), default=1.0)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["mode"] = self.mode.value
        d["fits"] = self.fits
        d["throughput_jobs_per_s"] = self.throughput_jobs_per_s
        return d


def _aggregate_peak(jobs: Sequence[SoloProfile]) -> float:
    # Shared modes replicate every job's working set on every chip (the
    # non-partitioned device runs each job sharded over all chips), so
    # per-chip footprints add. MIG instead places jobs on disjoint chips.
    return sum(j.peak_bytes_per_device for j in jobs)


def mps_contention(
    jobs: Sequence[SoloProfile], *, hbm_budget_bytes: int = HBM_PER_CHIP
) -> SharedModeReport:
    """MPS: concurrent spatial sharing with proportional contention.

    The interference factor per resource is the aggregate activity demand
    ``sum_j u_rj`` from the roofline telemetry, floored at 1 (idle capacity
    absorbs sub-saturating demand for free). The dispatch-latency floor
    contends on aggregate *compute* activity: kernel launches queue behind
    in-flight kernels once the SMs saturate, which is how a saturating
    training neighbour hurts a latency-dominated decode step even though no
    bandwidth resource is oversubscribed (the MIGPerf mechanism).
    """
    contention = {}
    for r in _RESOURCES:
        demand = sum(j.activity(r) for j in jobs)
        contention[r] = max(1.0, demand)
    contention["latency_s"] = max(
        1.0, sum(j.activity("compute_s") for j in jobs)
    )
    eff: Dict[str, float] = {}
    interference: Dict[str, float] = {}
    for j in jobs:
        busy = max(getattr(j, r) * contention[r] for r in _RESOURCES)
        step = j.latency_s * contention["latency_s"] + busy
        eff[j.name] = step
        interference[j.name] = step / j.step_s if j.step_s else 1.0
    return SharedModeReport(
        mode=CollocationMode.MPS,
        effective_step_s=eff,
        interference=interference,
        contention=contention,
        aggregate_peak_bytes=_aggregate_peak(jobs),
        hbm_budget_bytes=hbm_budget_bytes,
    )


def naive_contention(
    jobs: Sequence[SoloProfile],
    *,
    hbm_budget_bytes: int = HBM_PER_CHIP,
    switch_overhead_frac: float = NAIVE_SWITCH_OVERHEAD_FRAC,
) -> SharedModeReport:
    """Naive process collocation: exclusive time-slicing, round-robin.

    Each job completes one step per round; the round is the sum of solo
    steps plus the per-quantum switch penalty, and nothing overlaps across
    jobs.
    """
    k = len(jobs)
    overhead = switch_overhead_frac if k > 1 else 0.0
    round_s = (1.0 + overhead) * sum(j.step_s for j in jobs)
    eff = {j.name: round_s for j in jobs}
    interference = {
        j.name: round_s / j.step_s if j.step_s else 1.0 for j in jobs
    }
    return SharedModeReport(
        mode=CollocationMode.NAIVE,
        effective_step_s=eff,
        interference=interference,
        contention=dict.fromkeys((*_RESOURCES, "latency_s"), 1.0),  # exclusive while scheduled
        aggregate_peak_bytes=_aggregate_peak(jobs),
        hbm_budget_bytes=hbm_budget_bytes,
    )


def mig_report(
    jobs: Sequence[SoloProfile],
    instance_step_s: Mapping[str, float],
    *,
    hbm_budget_bytes: int = HBM_PER_CHIP,
) -> SharedModeReport:
    """MIG partitioning expressed in the shared-mode currency.

    ``instance_step_s`` maps each job to its per-instance characterized step
    time; interference is 1.0 by construction (isolation, F3), and memory
    admission already happened per-slice in the scheduler, so the aggregate
    footprint check is vacuous here (each job's chips are its own).
    """
    eff = {j.name: float(instance_step_s[j.name]) for j in jobs}
    return SharedModeReport(
        mode=CollocationMode.MIG,
        effective_step_s=eff,
        interference={j.name: 1.0 for j in jobs},
        contention=dict.fromkeys((*_RESOURCES, "latency_s"), 1.0),
        aggregate_peak_bytes=0.0,
        hbm_budget_bytes=hbm_budget_bytes,
    )


def shared_mode_report(
    mode: CollocationMode,
    jobs: Sequence[SoloProfile],
    *,
    hbm_budget_bytes: int = HBM_PER_CHIP,
    switch_overhead_frac: float = NAIVE_SWITCH_OVERHEAD_FRAC,
) -> SharedModeReport:
    """Dispatch to the contention model for a *shared* mode (not MIG).

    ``hbm_budget_bytes`` and ``switch_overhead_frac`` are per-device-SKU
    knobs (core/device.py) — the scheduler threads its SKU's values in;
    the defaults are the A100-40GB baseline."""
    if mode == CollocationMode.MPS:
        return mps_contention(jobs, hbm_budget_bytes=hbm_budget_bytes)
    if mode == CollocationMode.NAIVE:
        return naive_contention(
            jobs,
            hbm_budget_bytes=hbm_budget_bytes,
            switch_overhead_frac=switch_overhead_frac,
        )
    raise ValueError(f"{mode} is not a shared mode — use the MIG scheduler path")


def device_busy_fraction(jobs: Sequence[SoloProfile]) -> float:
    """GRACT analogue for a shared (non-partitioned) device: the busiest
    engine's aggregate activity demand across the collocated jobs, clamped
    to 1. Sub-saturating mixes score < 1 — the idle fraction the paper
    measures as GRACT < 1 and the cluster simulator integrates into its
    per-device utilization metric (core/cluster.py)."""
    if not jobs:
        return 0.0
    return min(
        1.0, max(sum(j.activity(r) for j in jobs) for r in _RESOURCES)
    )


def sequential_time_s(jobs: Sequence[SoloProfile]) -> float:
    """Baseline the paper compares every mode against: run the jobs one
    after another, each alone on the full device."""
    return sum(j.step_s for j in jobs)


# -- precomputed-terms fast path (cluster re-timing storms) ---------------------
#
# The cluster simulator re-prices a shared device's whole co-resident set on
# every arrival, departure, and phase transition. The full path builds
# SharedModeReport objects (dicts, interference ratios, rejection prose)
# that the re-timing loop never reads; at city scale that object churn — and
# re-deriving each profile's activity fractions per call — dominates the
# event loop. ``SoloTerms`` freezes one scaled profile's contention inputs
# into a flat tuple once, and ``shared_effective_steps`` replays *exactly*
# the arithmetic of mps_contention / naive_contention over those tuples (the
# same sums in the same order, so results are bit-identical — the contract
# tests/test_retime_equivalence.py enforces against the full path).


class SoloTerms(NamedTuple):
    """One scaled solo profile reduced to the contention model's inputs."""

    compute_s: float
    memory_s: float
    collective_s: float
    latency_s: float
    step_s: float
    u_compute: float
    u_memory: float
    u_collective: float


def solo_terms(profile: SoloProfile) -> SoloTerms:
    """Freeze ``profile``'s contention inputs (same floats as the properties
    the full model reads — ``activity`` is evaluated once per resource)."""
    return SoloTerms(
        profile.compute_s,
        profile.memory_s,
        profile.collective_s,
        profile.latency_s,
        profile.step_s,
        profile.activity("compute_s"),
        profile.activity("memory_s"),
        profile.activity("collective_s"),
    )


def shared_effective_steps(
    mode: CollocationMode,
    terms: Sequence[SoloTerms],
    *,
    switch_overhead_frac: float = NAIVE_SWITCH_OVERHEAD_FRAC,
) -> Tuple[float, ...]:
    """Effective step times for a co-resident set, in input order.

    Bit-identical to ``mps_contention`` / ``naive_contention`` on the same
    set: every sum runs over the jobs in the same order and every max takes
    its operands in the same resource order, so no float can drift between
    this and the report-building path."""
    if mode == CollocationMode.NAIVE:
        overhead = switch_overhead_frac if len(terms) > 1 else 0.0
        round_s = (1.0 + overhead) * sum(t.step_s for t in terms)
        return tuple(round_s for _ in terms)
    if mode != CollocationMode.MPS:
        raise ValueError(f"{mode} is not a shared mode — use the MIG scheduler path")
    f_compute = max(1.0, sum(t.u_compute for t in terms))
    f_memory = max(1.0, sum(t.u_memory for t in terms))
    f_collective = max(1.0, sum(t.u_collective for t in terms))
    f_latency = max(1.0, sum(t.u_compute for t in terms))
    return tuple(
        t.latency_s * f_latency
        + max(t.compute_s * f_compute, t.memory_s * f_memory, t.collective_s * f_collective)
        for t in terms
    )


def busy_fraction_from_terms(terms: Sequence[SoloTerms]) -> float:
    """``device_busy_fraction`` over pre-frozen terms — same sums, same
    resource order, bit-identical result."""
    if not terms:
        return 0.0
    return min(
        1.0,
        max(
            sum(t.u_compute for t in terms),
            sum(t.u_memory for t in terms),
            sum(t.u_collective for t in terms),
        ),
    )
