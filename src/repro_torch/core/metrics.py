"""Device-group metric aggregation — the paper's §4.2 reporting, derived.

The paper reports GRACT/SMACT/SMOCC/DRAMA twice per experiment: once per
*instance* and once for the *full device*, where unoccupied slice units pull
the device-level number down (their engines are idle). We reproduce both
views from the per-instance characterization records:

    instance-level  = the record's own DCGM analogues;
    device-level    = sum_i(metric_i * mem_units_i) / 8   (idle units = 0).

This reproduces the paper's headline structure: 1g.5gb-parallel maximizes
device-level activity for small workloads, 7g.40gb-one minimizes it, and a
single small instance barely registers at device level.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.device import get_sku
from repro_torch.core.instance import InstanceRecord


@dataclasses.dataclass
class DeviceGroupReport:
    """One paper 'device group' (e.g. ``2g.10gb parallel``) row."""

    group: str  # "1g.5gb one" | "1g.5gb parallel" | "non-MIG" ...
    workload: str
    instance_metrics: List[Dict[str, float]]  # per instance
    device_metrics: Dict[str, float]  # unit-weighted over the full pod
    occupied_units: int

    def to_dict(self):
        return dataclasses.asdict(self)


_METRICS = ("gract", "smact", "smocc_proxy", "drama")


def device_group_report(
    group: str, workload: str, records: Sequence[InstanceRecord], sku=None
) -> DeviceGroupReport:
    dev = get_sku(sku)
    inst_metrics = [dict(r.dcgm) for r in records]
    occupied = sum(dev.profile(r.profile).mem_units for r in records)
    device = {}
    for m in _METRICS:
        device[m] = sum(
            r.dcgm[m] * dev.profile(r.profile).mem_units for r in records
        ) / dev.n_units
    return DeviceGroupReport(
        group=group,
        workload=workload,
        instance_metrics=inst_metrics,
        device_metrics=device,
        occupied_units=occupied,
    )


def epoch_time_s(record: InstanceRecord, samples_per_epoch: int, batch: int) -> float:
    """Paper metric #1: step-time roofline x steps per epoch."""
    steps = -(-samples_per_epoch // batch)
    return record.step_s * steps


def throughput_jobs_per_s(records: Sequence[InstanceRecord]) -> float:
    """Aggregate work rate of a parallel device group (jobs / second),
    where each job contributes 1/step_s. The paper's F2 compares this to
    running the same jobs sequentially on the full-device profile."""
    return sum(1.0 / r.step_s for r in records if r.step_s > 0)


def collocation_speedup(
    parallel: Sequence[InstanceRecord], isolated_full: InstanceRecord
) -> float:
    """F2: time(sequential on 7g) / time(parallel on k instances).

    k jobs sequentially on the full device take k * step_full; in parallel
    they take max_i(step_i). Ratio > 1 means collocation wins.
    """
    k = len(parallel)
    t_seq = k * isolated_full.step_s
    t_par = max(r.step_s for r in parallel)
    return t_seq / t_par if t_par else 0.0


@dataclasses.dataclass
class ModeComparison:
    """One row of the paper's naive-vs-MPS-vs-MIG comparison for a workload:
    k jobs collocated under ``mode`` vs running them sequentially solo."""

    workload: str
    mode: str
    k_jobs: int
    effective_step_s: float  # slowest collocated job's step
    solo_step_s: float  # one job alone on the full device
    fits: bool
    # neighbour-induced slowdown: collocated step / what the job would do on
    # the same resources without neighbours. 1.0 for MIG by construction
    # (F3 — a slice's step is slice-sized whether or not neighbours exist);
    # effective/solo for the shared modes.
    max_interference: float = 1.0

    @property
    def speedup_vs_sequential(self) -> float:
        """k jobs sequentially take k*solo; collocated they finish together
        after max effective step. > 1 means collocation wins (F2)."""
        if not self.fits or self.effective_step_s <= 0:
            return 0.0
        return (self.k_jobs * self.solo_step_s) / self.effective_step_s


def mode_comparison(
    workload: str,
    mode: str,
    records: Sequence[InstanceRecord],
    solo_step_s: float,
    *,
    interference: Optional[float] = None,
) -> ModeComparison:
    """One comparison row. ``interference`` defaults to effective/solo (the
    shared-mode semantics); pass 1.0 explicitly for MIG rows (F3)."""
    effective = max((r.step_s for r in records), default=0.0)
    if interference is None:
        interference = effective / solo_step_s if solo_step_s else 0.0
    return ModeComparison(
        workload=workload,
        mode=mode,
        k_jobs=len(records),
        effective_step_s=effective,
        solo_step_s=solo_step_s,
        fits=all(r.fits for r in records),
        max_interference=interference,
    )


def format_mode_table(rows: Sequence[ModeComparison]) -> str:
    """The paper's headline table: collocation speedup per mode."""
    hdr = (
        f"{'workload':<16}{'mode':<8}{'k':>3}{'solo_s':>10}{'coll_s':>10}"
        f"{'speedup':>9}{'interf':>8}{'fits':>6}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.workload:<16}{r.mode:<8}{r.k_jobs:>3}{r.solo_step_s:>10.5f}"
            f"{r.effective_step_s:>10.5f}{r.speedup_vs_sequential:>8.2f}x"
            f"{r.max_interference:>7.2f}x{str(r.fits):>6}"
        )
    return "\n".join(lines)


def format_group_table(reports: Sequence[DeviceGroupReport]) -> str:
    hdr = (
        f"{'group':<22}{'workload':<16}{'n_inst':>7}"
        f"{'GRACT':>8}{'SMACT':>8}{'SMOCC':>8}{'DRAMA':>8}  (device-level)"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        d = r.device_metrics
        lines.append(
            f"{r.group:<22}{r.workload:<16}{len(r.instance_metrics):>7}"
            f"{d['gract']:>8.3f}{d['smact']:>8.3f}"
            f"{d['smocc_proxy']:>8.3f}{d['drama']:>8.3f}"
        )
    return "\n".join(lines)
