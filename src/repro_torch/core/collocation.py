"""Collocation scheduler: place jobs under a collocation mode.

The paper demonstrates *why* (3x throughput for sub-saturating workloads,
admission limits, no interference); this module is the *how* a production
cluster acts on it. The scheduler is mode-aware (core/sharing.py): MIG packs
jobs onto partitioned instances via the placement tree; NAIVE and MPS place
them together on the full non-partitioned device and predict each job's
effective step time from the mode's contention model. ``best_mode`` scores a
job mix under all three modes and picks the winner — reproducing the paper's
recommendation that MPS wins for a single user's homogeneous training jobs,
MIG when model sizes align with the partitioning options, and naive never.

The MIG path implements:

  * admission control — a job may only be placed on a profile whose
    per-device HBM budget covers the job's compiled peak memory (reproduces
    F5: medium/large OOM on 1g.5gb as a scheduler rejection, not a crash);
  * packing — smallest admissible profile first (maximizes instances per
    pod, which is the paper's throughput lever), widened to bigger
    profiles only when the small slots are exhausted; with
    ``use_planner=True`` the (profile, start) choice comes instead from
    exact/beam search over the whole partition tree (core/planner), which
    keeps the larger profiles' few legal starts unfragmented — greedy
    first-fit's known blind spot (docs/placement.md);
  * layout search — candidate layouts come from the paper-faithful
    placement tree (core/profiles.py), scored by predicted aggregate
    throughput from the characterization DB;
  * straggler mitigation — per-job step-time EMA; a job drifting > tol
    above its predicted step time is marked for repack to a larger profile
    (isolation F3 guarantees repacking cannot hurt neighbours).

The characterization DB is a dict {(arch, shape, profile): record-dict}
produced by ``launch/collocate.py`` (compiled dry-runs per instance shape) —
the same artifact the paper builds by measuring 135 hours of runs, built
here in minutes analytically.

Jobs may be flat ``JobSpec``s or phase-aware ``Workload``s
(core/workload.py) — the two share the fields the scheduler reads.
Admission always budgets the *phase-peak* working set; predicted step times
are for each job's currently active phase (``active_phases``), defaulting
to steady — which reproduces the flat-JobSpec numbers exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.device import DEFAULT_SKU, DeviceSKU, format_gib, get_sku
from repro_torch.core.instance import JobSpec
from repro_torch.core.planner import PlacementPlan, PlanningCostModel, plan_placements
from repro_torch.core.planner.costmodel import record_fits
from repro_torch.core.profiles import Placement, homogeneous_layout
from repro_torch.core.sharing import (
    CollocationMode,
    SharedModeReport,
    SoloProfile,
    SoloTerms,
    shared_mode_report,
)
from repro_torch.core.sharing import solo_terms as profile_terms
from repro_torch.core.workload import (
    STEADY_DEMAND,
    DemandTrace,
    peak_demand_multiplier,
    phase_step_s,
)

CharKey = Tuple[str, str, str]  # (arch, shape, profile)


def is_sku_keyed_db(char_db) -> bool:
    """True when ``char_db`` is the mixed-fleet shape ``{sku_name: db}``
    rather than one flat ``{CharKey: record}`` DB — a char DB speaks one
    SKU's profile names, so heterogeneous fleets carry one DB per
    generation. The single shape test shared by ``Cluster`` and
    ``launch/simulate.py``."""
    return bool(char_db) and all(isinstance(k, str) for k in char_db)


@dataclasses.dataclass
class Assignment:
    job: JobSpec
    placement: Placement
    predicted_step_s: float

    @property
    def profile(self) -> str:
        return self.placement.profile


@dataclasses.dataclass
class Rejection:
    job: JobSpec
    reason: str


@dataclasses.dataclass
class Schedule:
    assignments: List[Assignment]
    rejections: List[Rejection]
    mode: CollocationMode = CollocationMode.MIG
    shared_report: Optional[SharedModeReport] = None  # NAIVE/MPS only
    plan: Optional[PlacementPlan] = None  # planned MIG path only

    @property
    def placements(self) -> List[Placement]:
        return [a.placement for a in self.assignments]

    def throughput(self) -> float:
        return sum(
            1.0 / a.predicted_step_s
            for a in self.assignments
            if a.predicted_step_s > 0
        )


@dataclasses.dataclass
class ModeDecision:
    """Outcome of ``best_mode``: the winner plus every mode's scorecard."""

    mode: CollocationMode
    schedules: Dict[CollocationMode, Schedule]

    @property
    def schedule(self) -> Schedule:
        return self.schedules[self.mode]

    def scores(self) -> Dict[CollocationMode, Tuple[int, float]]:
        return {
            m: (len(s.assignments), s.throughput())
            for m, s in self.schedules.items()
        }


# profile order: smallest first — the paper's throughput-maximizing choice.
# Default-SKU shims: the scheduler itself reads ``self.sku.profile_order`` /
# ``self.sku.full_profile`` so other device generations get their own.
_PROFILE_ORDER = DEFAULT_SKU.profile_order


# Full-device profile the shared modes (naive / MPS) run on.
_FULL_PROFILE = DEFAULT_SKU.full_profile

# Preference when modes tie on (jobs placed, aggregate throughput): the
# paper recommends MPS as the most flexible, MIG next, naive last.
MODE_PREFERENCE = (CollocationMode.MPS, CollocationMode.MIG, CollocationMode.NAIVE)
_MODE_PREFERENCE = MODE_PREFERENCE  # backwards-compat alias

# Import-time guard: a new CollocationMode member MUST take an explicit
# position in MODE_PREFERENCE — a silent fallback would change every
# tie-broken verdict in the repo without a single test naming the cause.
_UNRANKED = [m for m in CollocationMode if m not in MODE_PREFERENCE]
assert not _UNRANKED and len(MODE_PREFERENCE) == len(CollocationMode), (
    f"MODE_PREFERENCE must rank every CollocationMode exactly once; "
    f"unranked: {[m.value for m in _UNRANKED]}, "
    f"preference: {[m.value for m in MODE_PREFERENCE]}"
)
del _UNRANKED

# Explicit tie-break rank (0 = most preferred). KeyError here is impossible
# while the assert above holds.
_PREFERENCE_RANK: Dict[CollocationMode, int] = {
    m: i for i, m in enumerate(MODE_PREFERENCE)
}


def rank_modes(schedules: Dict[CollocationMode, Schedule]) -> CollocationMode:
    """Winner under the lexicographic ranking ``best_mode`` documents:
    (jobs placed, aggregate throughput), exact ties broken by the explicit
    ``_PREFERENCE_RANK`` position (MPS > MIG > naive — covered for every
    mode by the import-time assert above).

    Shared with the cluster's migration policy (core/cluster.py), which
    evaluates candidate schedules without committing the scheduler's
    straggler-prediction state the way ``best_mode`` does.
    """
    return max(
        schedules,
        key=lambda m: (
            len(schedules[m].assignments),
            schedules[m].throughput(),
            -_PREFERENCE_RANK[m],
        ),
    )


class CollocationScheduler:
    """Mode-aware placer: MIG placement-tree packing or shared-device
    scheduling under the naive / MPS contention models."""

    def __init__(
        self,
        char_db: Dict[CharKey, dict],
        *,
        chips_per_unit: int = 32,
        partitioned: bool = True,
        straggler_tol: float = 1.5,
        ema_alpha: float = 0.25,
        mode: CollocationMode = CollocationMode.MIG,
        use_planner: bool = False,
        sku: Union[None, str, DeviceSKU] = None,
    ):
        self.char_db = char_db
        # the device generation this scheduler places onto (core/device.py):
        # its placement tree, slice budgets, and shared-mode knobs. The
        # char DB must speak this SKU's profile names.
        self.sku = get_sku(sku)
        self.chips_per_unit = chips_per_unit
        self.partitioned = partitioned
        self.straggler_tol = straggler_tol
        self.ema_alpha = ema_alpha
        self.mode = CollocationMode(mode)
        # route MIG placement through the partition-tree optimizer
        # (core/planner) instead of greedy smallest-admissible first-fit
        self.use_planner = bool(use_planner)
        # optional online calibrator (core/calib/online.py): when attached
        # (the cluster wires it), predict_step multiplies its memoized base
        # prediction by the calibrator's running per-(sku, arch, profile)
        # residual — corrections stay OUT of the memo so they can evolve
        # between calls without poisoning the cache. None = exact pre-calib
        # behaviour (the byte-determinism contract for untouched runs).
        self.calibrator = None
        self._cost_model: Optional[PlanningCostModel] = None
        self._ema: Dict[str, float] = {}
        self._predicted: Dict[str, float] = {}
        # the residual each job's last prediction carried (1.0 = none):
        # Cluster.observe_step divides it back out so the calibrator's
        # EWMA tracks measured-vs-BASE even when the residual has moved
        # since the job was priced
        self._applied_residual: Dict[str, float] = {}
        # memoized lookups: the char DB is immutable for the scheduler's
        # lifetime, so (arch, shape, profile, phase) step predictions and
        # per-arch solo profiles are computed once — the planner's inner
        # loop and the cluster's shared-device re-timing on every
        # arrival/departure hit these paths thousands of times
        # key: (arch, shape, profile, demand, phase-peak multiplier)
        self._step_cache: Dict[Tuple, float] = {}
        self._solo_cache: Dict[Tuple[str, str, str], Optional[SoloProfile]] = {}
        # cluster fast-path memos (core/cluster.py incremental re-timing):
        # scaled contention terms per (SKU, arch, shape, demand) and the
        # shared-mode admission verdict per (SKU, arch, shape, peak mult)
        self._terms_cache: Dict[Tuple, Optional[SoloTerms]] = {}
        self._shared_admit_cache: Dict[Tuple, Optional[Tuple[float, bool]]] = {}

    @property
    def cost_model(self) -> PlanningCostModel:
        """Lazily built predictive cost model over the same char DB."""
        if self._cost_model is None:
            self._cost_model = PlanningCostModel(self.char_db, sku=self.sku)
        return self._cost_model

    # -- admission ------------------------------------------------------------

    def admissible(self, job, profile: str) -> Tuple[bool, str]:
        """Memory admission on the job's *phase-peak* working set.

        A placement must survive the job's hungriest phase (e.g. the
        checkpoint burst's serialization buffer), so the record's steady
        footprint is scaled by the workload's peak demand multiplier. Flat
        ``JobSpec``s have multiplier 1.0 and keep the record's own ``fits``
        verdict bit-for-bit; a phase-aware workload re-evaluates against
        the HBM budget — which can also *admit* where steady training OOMs
        (a serve session's decode working set is roughly half a train
        step's)."""
        rec = self.char_db.get((job.arch, job.suite.name, profile))
        if rec is None:
            return False, f"no characterization for {(job.arch, job.suite.name, profile)}"
        mult = peak_demand_multiplier(job)
        # the one shared admission predicate — the planner cost model must
        # reach the same verdict on the same record (core/planner/costmodel)
        fits = record_fits(rec, mult, budget_bytes=self.sku.slice_bytes)
        if not fits:
            return False, (
                f"OOM: needs "
                f"{format_gib(rec['peak_bytes_per_device'] * mult)} GiB/chip "
                f"(phase peak) > {format_gib(self.sku.slice_bytes)} GiB HBM "
                f"on {profile}"
            )
        return True, ""

    def smallest_admissible(self, job: JobSpec) -> Optional[str]:
        order = self.sku.profile_order
        start = 0
        if job.min_profile is not None and job.min_profile in order:
            # straggler-repack floor: never place below this profile again.
            # A floor naming another generation's profile (a repack victim
            # retried on a different SKU in a mixed fleet) does not bind —
            # slice names, like slice budgets, are per-SKU.
            start = order.index(job.min_profile)
        for prof in order[start:]:
            ok, _ = self.admissible(job, prof)
            if ok:
                return prof
        return None

    # -- packing ----------------------------------------------------------------

    def schedule(
        self,
        jobs: Sequence[JobSpec],
        *,
        blocked_units: frozenset = frozenset(),
        mode: Optional[CollocationMode] = None,
        existing: Sequence[Placement] = (),
        active_phases: Optional[Mapping[str, DemandTrace]] = None,
        preferred: Optional[Mapping[str, Placement]] = None,
    ) -> Schedule:
        """Place ``jobs`` under ``mode`` (defaults to the scheduler's own).

        MIG is a greedy pack: sort by priority desc, give each job its
        smallest admissible profile at the lowest free placement offset;
        upgrade to a larger profile only if the small ones are exhausted.
        ``blocked_units`` are unavailable slice units (failed hardware or
        surviving neighbours during an elastic repack). ``existing`` are
        placements already live on the device (the cluster's incremental
        admission path): their units are occupied AND they participate in
        layout validation, so profile exclusions and the compute-slice
        budget hold across the union, not just the new jobs. NAIVE/MPS
        share the full device instead — see ``_schedule_shared``.

        ``active_phases`` maps job name -> the demand vector of the phase
        the job is *currently in* (core/workload.py): predicted step times
        are for that phase, and the shared-mode contention models consume
        the active-phase vectors of the whole co-resident set. Memory
        admission always uses phase-peak regardless. Jobs absent from the
        map are timed at their steady (identity) demand — the flat-JobSpec
        behaviour.

        ``preferred`` (planner path only) maps job names to the instances
        they currently hold: a re-partition plan treats keeping them in
        place as the objective right after serving the most jobs, since
        every move costs a checkpoint rollback (core/planner/optimizer.py).
        """
        mode = CollocationMode(mode if mode is not None else self.mode)
        active_phases = active_phases or {}
        if mode != CollocationMode.MIG:
            return self._schedule_shared(jobs, mode, active_phases)
        if self.use_planner:
            return self._schedule_mig_planned(
                jobs,
                blocked_units=blocked_units,
                existing=existing,
                active_phases=active_phases,
                preferred=preferred,
            )
        # (the MIG overhead slice is a *compute* budget — enforced by
        # validate_layout's slice-count check — not a blocked memory unit;
        # the full-device profile owns all units by the SKU invariant)
        sku = self.sku
        order = sku.profile_order
        free = [True] * sku.n_units
        for u in blocked_units:
            free[u] = False
        existing = list(existing)
        for pl in existing:
            for u in sku.units(pl):
                free[u] = False
        assignments: List[Assignment] = []
        rejections: List[Rejection] = []

        def try_place(profile: str) -> Optional[Placement]:
            p = sku.profile(profile)
            for s in p.starts:
                span = range(s, s + p.mem_units)
                if all(free[u] for u in span):
                    ok, _ = sku.validate_layout(
                        existing
                        + [Placement(a.profile, a.placement.start) for a in assignments]
                        + [Placement(profile, s)],
                        partitioned=self.partitioned,
                    )
                    if ok:
                        for u in span:
                            free[u] = False
                        return Placement(profile, s)
            return None

        for job in sorted(jobs, key=lambda j: -j.priority):
            placed = False
            start_prof = self.smallest_admissible(job)
            if start_prof is None:
                reasons = [
                    f"{p}: {self.admissible(job, p)[1]}" for p in order
                ]
                rejections.append(Rejection(job, "; ".join(reasons[:2])))
                continue
            for prof in order[order.index(start_prof):]:
                ok, _ = self.admissible(job, prof)
                if not ok:
                    continue
                pl = try_place(prof)
                if pl is not None:
                    demand = active_phases.get(job.name, STEADY_DEMAND)
                    a = Assignment(job, pl, self.predict_step(job, prof, demand))
                    assignments.append(a)
                    placed = True
                    break
            if not placed:
                rejections.append(Rejection(job, "no free placement slot"))
        return Schedule(assignments, rejections, mode=CollocationMode.MIG)

    def _schedule_mig_planned(
        self,
        jobs: Sequence[JobSpec],
        *,
        blocked_units: frozenset = frozenset(),
        existing: Sequence[Placement] = (),
        active_phases: Mapping[str, DemandTrace] = {},
        preferred: Optional[Mapping[str, Placement]] = None,
    ) -> Schedule:
        """MIG placement via the partition-tree optimizer (core/planner).

        Same contract as the greedy path — every job is either assigned or
        rejected, ``existing`` placements are fixed and jointly validated,
        ``blocked_units`` are untouchable — but the (profile, start) choice
        comes from exact/beam search over the whole placement tree instead
        of smallest-admissible first-fit, and the returned ``Schedule``
        carries the ``PlacementPlan`` (optimality + gap included)."""
        plan = plan_placements(
            list(jobs),
            self.cost_model,
            existing=existing,
            blocked_units=frozenset(blocked_units),
            active_phases=active_phases,
            preferred=preferred,
            partitioned=self.partitioned,
        )
        by_name = {j.name: j for j in jobs}
        assignments: List[Assignment] = []
        for job in sorted(jobs, key=lambda j: -j.priority):
            pl = plan.assignments.get(job.name)
            if pl is None:
                continue
            demand = active_phases.get(job.name, STEADY_DEMAND)
            assignments.append(
                Assignment(job, pl, self.predict_step(job, pl.profile, demand))
            )
        rejections = [
            Rejection(by_name[name], reason) for name, reason in plan.unplaced
        ]
        return Schedule(
            assignments, rejections, mode=CollocationMode.MIG, plan=plan
        )

    def predict_step(self, job, profile: str, demand: DemandTrace = STEADY_DEMAND) -> float:
        """Predicted per-step time of ``job`` on a MIG ``profile`` under a
        phase's demand vector, recorded for straggler detection. The one
        source of truth for MIG step prediction — the scheduler's packing
        path and the cluster's phase-transition re-timing both call it.

        Memoized on (SKU, arch, shape, profile, demand, phase-peak
        multiplier): the char DB is immutable, so identical lookups (the
        planner inner loop, shared re-timing storms) stop recomputing the
        phase algebra — and the SKU in the key means a scheduler re-homed
        onto another generation can never serve a stale step time
        (tests/test_device.py). A profile with no record of its own falls
        back to the planner cost model's MISO-style prediction from the
        full-device record — whose fits/KeyError verdict depends on the
        job's phase-peak working set, hence the multiplier in the key."""
        key = (self.sku.name, job.arch, job.suite.name, profile, demand,
               peak_demand_multiplier(job))
        step = self._step_cache.get(key)
        if step is None:
            rec = self.char_db.get((job.arch, job.suite.name, profile))
            if rec is None:
                est = self.cost_model.estimate(job, profile, demand)
                if not est.fits or est.step_s <= 0:
                    # keep the old loud-failure contract: a step prediction
                    # for an uncharacterized, unpredictable slice is a bug
                    # in the caller, not a 0.0
                    raise KeyError((job.arch, job.suite.name, profile))
                step = float(est.step_s)
            else:
                step = float(phase_step_s(rec, demand))
            self._step_cache[key] = step
        if self.calibrator is not None:
            # applied after the memo on purpose: the cache holds the char
            # DB's immutable base prediction, the residual is live state
            r = self.calibrator.residual(
                sku=self.sku.name, arch=job.arch, profile=profile
            )
            step *= r
            self._applied_residual[job.name] = r
        self._predicted[job.name] = step
        return step

    def applied_residual(self, job_name: str) -> float:
        """The calibrator residual ``job_name``'s last prediction carried
        (1.0 when no calibrator, or the job was never priced here)."""
        return self._applied_residual.get(job_name, 1.0)

    # -- shared modes (naive / MPS) ------------------------------------------------

    def solo_profile(self, job: JobSpec) -> Optional[SoloProfile]:
        """The job's solo roofline profile on the full, non-partitioned
        device, from the characterization DB. Shared modes run with MIG
        disabled, so the F6 reserved-slice discount baked into the 7g record
        is removed.

        Memoized per (SKU, arch, shape) — only the profile's ``name`` is
        job-specific, so the cached arch profile is re-labelled per job
        instead of re-deriving the roofline terms on every arrival,
        departure, and re-timing."""
        base = self._solo_base(job.arch, job.suite.name)
        if base is None:
            return None
        return dataclasses.replace(base, name=job.name)

    def _solo_base(self, arch: str, suite_name: str) -> Optional[SoloProfile]:
        """The memoized arch-named solo profile behind ``solo_profile``."""
        full = self.sku.full_profile
        key = (self.sku.name, arch, suite_name)
        if key not in self._solo_cache:
            rec = self.char_db.get((arch, suite_name, full))
            self._solo_cache[key] = (
                None
                if rec is None
                else SoloProfile.from_record(
                    arch,
                    rec,
                    undiscount_compute=self.sku.compute_discount(full),
                    latency_s=self.sku.step_latency_s,
                )
            )
        return self._solo_cache[key]

    def solo_terms(self, job, demand) -> Optional[SoloTerms]:
        """Memoized contention terms of the job's solo profile scaled by a
        phase ``demand`` vector — the cluster's incremental re-timing input
        (core/cluster.py). Bit-identical to freezing
        ``solo_profile(job).scaled(demand)``: the scaling runs through the
        same ``SoloProfile.scaled`` arithmetic before the terms are taken.
        None when the full-device record is missing (same jobs the shared
        scheduling path rejects)."""
        key = (self.sku.name, job.arch, job.suite.name, demand)
        if key not in self._terms_cache:
            base = self._solo_base(job.arch, job.suite.name)
            self._terms_cache[key] = (
                None if base is None else profile_terms(base.scaled(demand))
            )
        return self._terms_cache[key]

    def shared_admission(self, job) -> Optional[Tuple[float, bool]]:
        """Memoized shared-mode admission inputs: ``(phase-peak bytes,
        solo-fits)`` — exactly the quantities ``_schedule_shared`` derives
        per job before summing footprints against the HBM budget. None when
        the job has no full-device characterization (the no-record
        rejection). Keyed on the phase-peak multiplier so a workload whose
        plan changes its memory peak can never reuse a stale verdict."""
        mult = peak_demand_multiplier(job)
        key = (self.sku.name, job.arch, job.suite.name, mult)
        if key not in self._shared_admit_cache:
            base = self._solo_base(job.arch, job.suite.name)
            if base is None:
                self._shared_admit_cache[key] = None
            else:
                peak_bytes = base.peak_bytes_per_device * mult
                full = self.sku.full_profile
                fits = (
                    self.char_db[(job.arch, job.suite.name, full)].get("fits", False)
                    if mult == 1.0
                    else peak_bytes <= self.sku.slice_bytes
                )
                self._shared_admit_cache[key] = (peak_bytes, bool(fits))
        return self._shared_admit_cache[key]

    def _schedule_shared(
        self,
        jobs: Sequence[JobSpec],
        mode: CollocationMode,
        active_phases: Mapping[str, DemandTrace] = {},
    ) -> Schedule:
        """Place jobs together on the full device under a shared mode.

        Admission is the paper's memory constraint: shared modes replicate
        every job's working set on every chip, so per-chip footprints add
        and the aggregate must fit HBM — budgeted at each job's *phase-peak*
        footprint, since a neighbour's checkpoint burst lands in the same
        memory space. Jobs are admitted in priority order until the budget
        is exhausted; the mode's contention model then predicts every
        admitted job's effective step time from the *currently active*
        phase vectors (a decode-heavy neighbour loads the memory system and
        dispatch queue very differently from a checkpoint burst).
        """
        assignments: List[Assignment] = []
        rejections: List[Rejection] = []
        admitted: List[Tuple[JobSpec, SoloProfile]] = []
        full = self.sku.full_profile
        budget = self.sku.slice_bytes
        used = 0.0
        for job in sorted(jobs, key=lambda j: -j.priority):
            prof = self.solo_profile(job)
            if prof is None:
                rejections.append(
                    Rejection(
                        job,
                        f"no characterization for "
                        f"{(job.arch, job.suite.name, full)}",
                    )
                )
                continue
            peak_mult = peak_demand_multiplier(job)
            peak_bytes = prof.peak_bytes_per_device * peak_mult
            solo_fits = (
                self.char_db[(job.arch, job.suite.name, full)].get("fits", False)
                if peak_mult == 1.0
                else peak_bytes <= budget
            )
            if not solo_fits:
                rejections.append(
                    Rejection(job, "OOM: does not fit the full device solo")
                )
                continue
            if used + peak_bytes > budget:
                rejections.append(
                    Rejection(
                        job,
                        f"OOM under {mode.value}: aggregate phase-peak "
                        f"footprint {format_gib(used + peak_bytes)} GiB "
                        f"> {format_gib(budget)} GiB shared HBM",
                    )
                )
                continue
            used += peak_bytes
            admitted.append(
                (job, prof.scaled(active_phases.get(job.name, STEADY_DEMAND)))
            )

        report = None
        if admitted:
            report = shared_mode_report(
                mode,
                [p for _, p in admitted],
                hbm_budget_bytes=budget,
                switch_overhead_frac=self.sku.naive_switch_overhead_frac,
            )
            for job, prof in admitted:
                step = report.effective_step_s[prof.name]
                a = Assignment(job, Placement(full, 0), float(step))
                assignments.append(a)
                self._predicted[job.name] = a.predicted_step_s
        return Schedule(assignments, rejections, mode=mode, shared_report=report)

    # -- mode search -----------------------------------------------------------------

    def best_mode(self, jobs: Sequence[JobSpec]) -> ModeDecision:
        """Score the job mix under all three modes; pick the winner.

        Modes are ranked lexicographically by (jobs placed, aggregate
        throughput in jobs/s) — a mode that serves more of the mix beats a
        faster mode that rejects jobs (the paper's admission findings F5),
        throughput breaks the tie, and on exact ties the paper's
        recommendation order applies: MPS > MIG > naive.
        """
        schedules = {m: self.schedule(jobs, mode=m) for m in CollocationMode}
        best = rank_modes(schedules)
        # the trial schedules above each overwrote _predicted; straggler
        # detection must compare against the mode actually deployed
        for a in schedules[best].assignments:
            self._predicted[a.job.name] = a.predicted_step_s
        return ModeDecision(mode=best, schedules=schedules)

    # -- straggler mitigation -----------------------------------------------------

    def observe_step(self, job_name: str, step_s: float) -> None:
        prev = self._ema.get(job_name)
        self._ema[job_name] = (
            step_s if prev is None else (1 - self.ema_alpha) * prev + self.ema_alpha * step_s
        )

    def reset_observation(self, job_name: str) -> None:
        """Forget a job's step-time EMA — called when the job is re-placed
        on a different profile, where the old observations no longer apply."""
        self._ema.pop(job_name, None)

    def stragglers(self) -> List[str]:
        out = []
        for name, ema in self._ema.items():
            pred = self._predicted.get(name)
            if pred and ema > self.straggler_tol * pred:
                out.append(name)
        return out

    def repack_plan(self, schedule: Schedule) -> Dict[str, str]:
        """job -> larger-profile suggestion for flagged stragglers."""
        plan = {}
        order = self.sku.profile_order
        straggling = set(self.stragglers())
        for a in schedule.assignments:
            if a.job.name not in straggling:
                continue
            bigger = order[min(order.index(a.profile) + 1, len(order) - 1)]
            ok, _ = self.admissible(a.job, bigger)
            if ok and bigger != a.profile:
                plan[a.job.name] = bigger
        return plan


def paper_experiment_grid(
    workloads: Sequence[str], suite, sku: Union[None, str, DeviceSKU] = None
) -> List[Tuple[str, str, List[Placement]]]:
    """The paper's §3.4 run matrix: for each profile x workload, an isolated
    ('one') run and a max-instances homogeneous ('parallel') run, plus the
    non-MIG full-device baseline."""
    dev = get_sku(sku)
    grid: List[Tuple[str, str, List[Placement]]] = []
    for w in workloads:
        for prof in dev.profile_order:
            grid.append(
                (w, f"{prof} one", [Placement(prof, dev.profile(prof).starts[0])])
            )
            par = homogeneous_layout(prof, sku=dev)
            if len(par) > 1:
                grid.append((w, f"{prof} parallel", par))
        grid.append((w, "non-MIG", [Placement(dev.full_profile, 0)]))
    return grid
