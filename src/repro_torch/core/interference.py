"""Isolation verifier + shared-mode interference quantifier (PyTorch twin of
``repro.core.interference``).

Two complementary halves of the paper's interference story live here:

  * for MIG (partitioned) layouts, ``verify_isolation`` *proves* the paper's
    F3 finding structurally — co-located instances cannot interfere;
  * for the shared modes (naive / MPS) isolation is impossible by
    construction, so ``quantify_interference`` instead *quantifies* the
    predicted interference from the mode's contention model
    (core/sharing.py): per-job slowdown factors, the contended resources,
    and whether the mix fits shared memory at all.

On the A100 the paper *measures* that co-located MIG instances do not
interfere (per-instance epoch time is unchanged). The port checks, for a
concrete layout of one card:

  V1  memory-unit disjointness — no memory unit of the card belongs to two
      instances (the reference checks that no chip does);
  V2  collective containment — every collective of the job's traced step
      spans only ranks of the instance's own (``telemetry/counts.py``'s
      ``collective_summary`` groups; the reference reads HLO replica groups);
  V3  program equivalence — the fingerprint of the traced op sequence, the
      per-device memory and the step of a job on instance X are identical to
      the same job's on any other instance of the same profile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.instance import InstanceRecord
from repro_torch.core.partitioner import InstanceDevice
from repro_torch.core.sharing import (
    CollocationMode,
    SoloProfile,
    mig_report,
    shared_mode_report,
)

@dataclasses.dataclass
class IsolationReport:
    disjoint: bool
    collectives_contained: bool
    programs_identical: bool
    detail: Dict[str, str]

    @property
    def isolated(self) -> bool:
        return self.disjoint and self.collectives_contained and self.programs_identical


def check_disjoint(instances: Sequence[InstanceDevice]) -> Tuple[bool, str]:
    seen: Dict[int, str] = {}
    for inst in instances:
        for unit in range(*inst.units):
            if unit in seen:
                return False, f"memory unit {unit} in {seen[unit]} and {inst.label}"
            seen[unit] = inst.label
    return True, ""


def check_collective_containment(
    collectives: Dict, device_ids: Sequence[int], n_local_devices: int
) -> Tuple[bool, str]:
    """Every collective's group must index only the instance's own ranks.

    ``collectives`` is ``telemetry.counts.collective_summary`` of the job's
    traced step; its groups hold ranks 0..n-1 of the process group the step
    ran in, and any rank >= n_local would reach outside the instance.
    """
    for grp in collectives["groups"]:
        for rank in grp:
            if rank >= n_local_devices:
                return False, f"group {grp} exceeds instance size {n_local_devices}"
    return True, ""


def check_program_equivalence(records: Sequence[InstanceRecord]) -> Tuple[bool, str]:
    """Same job on same profile ⇒ identical compiled program + costs."""
    by_profile: Dict[Tuple[str, str, str], List[InstanceRecord]] = {}
    for r in records:
        by_profile.setdefault((r.job.split("#")[0], r.arch, r.profile), []).append(r)
    for key, rs in by_profile.items():
        fp0, r0 = rs[0].hlo_fingerprint, rs[0]
        for r in rs[1:]:
            if r.hlo_fingerprint != fp0:
                return False, f"{key}: fingerprint {r.hlo_fingerprint} != {fp0}"
            if (r.peak_bytes_per_device, r.step_s) != (
                r0.peak_bytes_per_device,
                r0.step_s,
            ):
                return False, f"{key}: cost mismatch across instances"
    return True, ""


@dataclasses.dataclass
class InterferenceQuant:
    """Predicted interference for one job mix under one collocation mode.

    ``slowdown`` maps each job to effective/solo step time (1.0 == no
    interference); ``contended`` lists resources whose aggregate demand
    exceeds capacity; ``fits`` is the shared-memory admission verdict.
    """

    mode: CollocationMode
    slowdown: Dict[str, float]
    contended: List[str]
    fits: bool

    @property
    def interference_free(self) -> bool:
        return all(abs(s - 1.0) < 1e-9 for s in self.slowdown.values())

    @property
    def max_slowdown(self) -> float:
        return max(self.slowdown.values(), default=1.0)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["mode"] = self.mode.value
        d["interference_free"] = self.interference_free
        d["max_slowdown"] = self.max_slowdown
        return d


def quant_from_report(rep) -> InterferenceQuant:
    """Derive the interference quantification from an already-computed
    ``SharedModeReport`` (avoids re-running the contention model when the
    caller, e.g. launch/collocate.py, holds one)."""
    contended = [r for r, f in rep.contention.items() if f > 1.0 + 1e-12]
    if rep.mode == CollocationMode.NAIVE and len(rep.effective_step_s) > 1:
        contended = ["device"]  # the whole device is the contended resource
    return InterferenceQuant(
        mode=rep.mode,
        slowdown=dict(rep.interference),
        contended=contended,
        fits=rep.fits,
    )


def quantify_interference(
    mode: CollocationMode,
    jobs: Sequence[SoloProfile],
    mig_instance_step_s: Dict[str, float] | None = None,
) -> InterferenceQuant:
    """Predict per-job interference for ``jobs`` collocated under ``mode``.

    MIG returns all-1.0 slowdowns (F3: proven isolation, see
    ``verify_isolation``); the shared modes return the contention model's
    per-job stretch — MPS only above aggregate saturation of a resource,
    naive always (time-slicing serializes every neighbour's step).
    """
    mode = CollocationMode(mode)
    if mode == CollocationMode.MIG:
        rep = mig_report(jobs, mig_instance_step_s or {j.name: j.step_s for j in jobs})
    else:
        rep = shared_mode_report(mode, jobs)
    return quant_from_report(rep)


def verify_isolation(
    instances: Sequence[InstanceDevice],
    records: Sequence[InstanceRecord],
    collectives: Dict[str, Dict] | None = None,
) -> IsolationReport:
    """V1-V3 for one layout; ``collectives`` maps an instance's label to the
    collective summary of the job it runs."""
    d_ok, d_why = check_disjoint(instances)
    c_ok, c_why = True, ""
    if collectives:
        for inst in instances:
            summary = collectives.get(inst.label)
            if summary is None:
                continue
            # one process on one device: the instance's only rank is 0
            ok, why = check_collective_containment(summary, [0], 1)
            if not ok:
                c_ok, c_why = False, f"{inst.label}: {why}"
                break
    p_ok, p_why = check_program_equivalence(records)
    return IsolationReport(
        disjoint=d_ok,
        collectives_contained=c_ok,
        programs_identical=p_ok,
        detail={"disjoint": d_why, "contained": c_why, "identical": p_why},
    )
