"""Predictive slice fitting: what does this job get out of that slice?

MISO (arXiv:2207.11428) shows a job's best MIG slice can be *predicted*
from measurements taken without reconfiguring — their probe is MPS spatial
sharing, whose contention algebra our ``core/sharing.py`` already expresses
over roofline activity fractions. This cost model is the planner's version
of that idea, in two tiers:

  1. characterized slices: the (arch, shape, profile) record exists in the
     characterization DB — the estimate is the record's step time rescaled
     by the job's active-phase demand vector (``workload.phase_step_s``),
     exactly what the greedy scheduler would predict. Bit-identical inputs,
     so planner-vs-greedy differences are pure *placement* effects.
  2. predicted slices: the record is missing — the estimate is derived from
     the job's full-device solo profile by the same roofline scaling the
     analytic characterization uses (busy terms grow as the inverse slice
     fraction, compute additionally pays the profile's F6 discount, the
     dispatch-latency floor is slice-size-invariant). This is the MISO
     move: one full-device measurement prices every slice in the tree.

Each estimate carries an SLO-constrained *goodput* (steps/s, zeroed for a
serve job whose predicted step misses its SLO — the same currency as
``ClusterReport.goodput_steps_per_s``), which is what the optimizer
maximizes. Estimates are memoized on (SKU, arch, shape, profile, demand,
peak multiplier, SLO): the planner's inner loop prices thousands of
(job x slice) pairs per dispatch and the vectors repeat heavily — and the
SKU in the key guarantees two generations' estimates can never
cross-contaminate (tests/test_device.py proves it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

from repro_torch.core.device import DeviceSKU, format_gib, get_sku
from repro_torch.core.workload import (
    STEADY_DEMAND,
    DemandTrace,
    peak_demand_multiplier,
    phase_step_s,
)
from repro_torch.core.slice_unit import HBM_PER_CHIP

_FULL_PROFILE = "7g.40gb"  # default-SKU shim; SKU-aware code reads sku.full_profile


def record_fits(
    rec: Mapping, peak_mult: float, *, budget_bytes: int = HBM_PER_CHIP
) -> bool:
    """The one memory-admission predicate, shared with
    ``CollocationScheduler.admissible``: flat jobs (peak multiplier 1.0)
    keep the record's own ``fits`` verdict bit for bit (absent key ==
    reject — the record never proved the job fits); phase-aware workloads
    re-budget their phase-peak working set against the slice's HBM
    (``budget_bytes`` — the SKU's per-chip slice budget)."""
    if peak_mult == 1.0:
        return bool(rec.get("fits", False))
    return (
        float(rec.get("peak_bytes_per_device", 0.0)) * peak_mult
        <= budget_bytes
    )


@dataclasses.dataclass(frozen=True)
class SliceEstimate:
    """One (job, slice) price: can it run there, and how fast."""

    profile: str
    fits: bool
    reason: str  # empty when fits
    step_s: float  # predicted per-step time under the given demand
    goodput: float  # steps/s if fits and (for serve) SLO-met, else 0.0
    slo_ok: Optional[bool]  # None for jobs without a step-latency SLO
    predicted: bool  # True when derived MISO-style (no record for the slice)

    @property
    def throughput(self) -> float:
        """Unconstrained steps/s (SLO-blind) — rank_modes' currency."""
        return 1.0 / self.step_s if self.fits and self.step_s > 0 else 0.0


def predict_record(full_rec: Mapping, profile: str, sku=None) -> Dict[str, float]:
    """Derive a slice record from the full-device record, MISO-style.

    The busy terms scale with the inverse of the slice's chip fraction
    (mem_units/8), compute additionally pays the slice's F6 discount
    relative to the full profile's, and the dispatch-latency residual of
    the recorded step carries over unchanged (host-side time does not
    shrink with the slice). The per-device peak is kept as-recorded — the
    replicated working set (params, per-chip activations) dominates it and
    does not shrink with chip count; the sharded remainder makes this a
    slightly optimistic ``fits``, which is why measured records always win
    when present (docs/placement.md)."""
    dev = get_sku(sku)
    step = float(full_rec.get("step_s", 0.0))
    compute = float(full_rec.get("compute_s", step))
    memory = float(full_rec.get("memory_s", 0.0))
    collective = float(full_rec.get("collective_s", 0.0))
    busy = max(compute, memory, collective)
    residual = max(0.0, step - busy)
    frac = dev.profile(profile).mem_units / dev.n_units
    full_frac = dev.profile(dev.full_profile).mem_units / dev.n_units
    scale = full_frac / frac
    disc = dev.compute_discount(profile) / dev.compute_discount(dev.full_profile)
    out_compute = compute * scale / disc
    out_memory = memory * scale
    out_collective = collective * scale
    out_busy = max(out_compute, out_memory, out_collective)
    return {
        "fits": None,  # decided by the caller against the HBM budget
        "step_s": out_busy + residual,
        "compute_s": out_compute,
        "memory_s": out_memory,
        "collective_s": out_collective,
        "peak_bytes_per_device": float(
            full_rec.get("peak_bytes_per_device", 0.0)
        ),
    }


class PlanningCostModel:
    """Memoized (job x slice x phase) estimates over a characterization DB.

    The DB is treated as immutable for the model's lifetime (the same
    contract ``CollocationScheduler`` holds); swap the model, not the DB.
    Records must be keyed by the SKU's own profile names (an 80GB fleet's
    DB speaks 1g.10gb, not 1g.5gb); the cache keys carry ``sku.name`` so a
    model can never serve another generation's estimate.
    """

    def __init__(
        self,
        char_db: Mapping[Tuple[str, str, str], Mapping],
        *,
        sku: Union[None, str, DeviceSKU] = None,
    ):
        self.char_db = char_db
        self.sku = get_sku(sku)
        self._cache: Dict[Tuple, SliceEstimate] = {}

    def estimate(
        self,
        job,
        profile: str,
        demand: DemandTrace = STEADY_DEMAND,
    ) -> SliceEstimate:
        """Price ``job`` on a ``profile`` slice under a phase's demand.

        Admission mirrors ``CollocationScheduler.admissible`` bit for bit:
        flat jobs (peak multiplier 1.0) keep the record's own ``fits``
        verdict, phase-aware workloads re-budget their phase-peak working
        set against the slice's HBM."""
        peak_mult = peak_demand_multiplier(job)
        slo = getattr(job, "slo_step_s", None)
        key = (self.sku.name, job.arch, job.suite.name, profile, demand,
               peak_mult, slo)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        est = self._estimate(job.arch, job.suite.name, profile, demand,
                             peak_mult, slo)
        self._cache[key] = est
        return est

    def _estimate(
        self,
        arch: str,
        shape: str,
        profile: str,
        demand: DemandTrace,
        peak_mult: float,
        slo: Optional[float],
    ) -> SliceEstimate:
        budget = self.sku.slice_bytes
        rec = self.char_db.get((arch, shape, profile))
        predicted = False
        if rec is None:
            full = self.char_db.get((arch, shape, self.sku.full_profile))
            if full is None:
                return SliceEstimate(
                    profile=profile,
                    fits=False,
                    reason=f"no characterization for {(arch, shape, profile)}"
                    " and no full-device record to predict from",
                    step_s=0.0,
                    goodput=0.0,
                    slo_ok=None,
                    predicted=True,
                )
            rec = predict_record(full, profile, sku=self.sku)
            predicted = True
        if predicted:
            # no measured verdict to honour: budget the predicted phase
            # peak directly against the slice HBM
            fits = (
                float(rec.get("peak_bytes_per_device", 0.0)) * peak_mult
                <= budget
            )
        else:
            fits = record_fits(rec, peak_mult, budget_bytes=budget)
        if not fits:
            need = float(rec.get("peak_bytes_per_device", 0.0)) * peak_mult
            return SliceEstimate(
                profile=profile,
                fits=False,
                reason=(
                    f"OOM: needs {format_gib(need)} GiB/chip (phase peak) "
                    f"> {format_gib(budget)} GiB HBM on {profile}"
                ),
                step_s=0.0,
                goodput=0.0,
                slo_ok=None,
                predicted=predicted,
            )
        step = float(phase_step_s(rec, demand))
        slo_ok = None if slo is None else (step <= slo)
        goodput = 1.0 / step if step > 0 and slo_ok is not False else 0.0
        return SliceEstimate(
            profile=profile,
            fits=True,
            reason="",
            step_s=step,
            goodput=goodput,
            slo_ok=slo_ok,
            predicted=predicted,
        )
