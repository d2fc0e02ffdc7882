"""Event-driven multi-device cluster: dynamic arrivals, live reconfiguration.

The one-shot ``CollocationScheduler.schedule(jobs)`` answers the paper's
*static* question — how should a fixed batch share one device. Its sharpest
*temporal* finding ("MIG's rigid partitioning may create sub-optimal GPU
utilization for more dynamic mixed workloads") needs an always-on cluster:
jobs arrive over time, finish, free capacity, and the fleet's partitioning
decisions age as the mix drifts. This module is that state machine.

A ``Cluster`` owns N ``DeviceState``s — a heterogeneous fleet where each
device has its own ``CollocationMode`` (some MIG-partitioned, others
MPS/naive-shared), its own ``DeviceSKU`` (core/device.py — a fleet may mix
GPU generations, each with its own placement tree and slice budgets), and
its own ``CollocationScheduler`` instance holding the per-device placement
and straggler state. The cluster is driven by a discrete-event loop
(core/events.py):

  submit(job, arrival_s)  pushes an ARRIVAL; at fire time the job enters
                          the priority + backfill admission queue
                          (core/queueing.py) — *waiting replaces the
                          one-shot scheduler's "reject forever"*; only jobs
                          that cannot run on any empty device under any
                          allowed mode are rejected outright;
  COMPLETION              derived from the job's predicted step time x its
                          remaining steps (epoch_time_s x epochs algebra);
                          frees capacity, re-times shared neighbours whose
                          contention just dropped, and re-drains the queue;
  PHASE_TRANSITION        a placed job crosses a boundary of its workload's
                          phase plan (core/workload.py): its demand vector
                          changes, so a MIG job re-times itself while a
                          shared device re-times *every* co-resident job
                          (a neighbour entering its checkpoint burst or
                          decode phase changes everyone's contention), and
                          the adaptive policy gets a migration look;
  FAILURE / REPAIR        slice-unit health events; the MIG path reuses the
                          elastic-repack split (core/elastic.py) — jobs on
                          intersecting instances die, survivors keep
                          running untouched (F3); on a *shared* device any
                          failure kills every job (no isolation — F3's
                          contrapositive);
  RECONFIG_DONE           ends a mode migration and re-opens the device.

Mode migration is the dynamic half of the paper made executable: under the
``adaptive`` policy, whenever the (running + queued) composition drifts,
each device re-runs the ``best_mode`` ranking (collocation.rank_modes) and
— if another mode would serve strictly more of the mix, or the same number
at meaningfully higher throughput — re-partitions live. The cost is charged
with the existing checkpoint-store semantics (checkpoint/store.py): a
checkpoint is valid at epoch granularity, so every displaced job rolls its
progress back to the last completed epoch (work since the last manifest is
lost and re-done), re-enters the queue priority-bumped like an elastic
repack victim, and the device is down for ``reconfig_cost_s`` while it
re-partitions. That charge is exactly what lets the simulator reproduce
MIG rigidity as *measured queueing delay* rather than prose: an all-MIG
fleet on a mixed dynamic trace accrues waiting time that an all-MPS fleet
does not, while MIG still wins the partition-aligned static trace
(benchmarks/cluster_sim.py prints both).

Jobs are phase-aware ``Workload``s (training: warmup / steady / checkpoint;
serving: prefill / decode) or flat ``JobSpec``s through the single-phase
adapter. Serving jobs carry a per-step latency SLO scored over their decode
steps; the end-of-run report adds SLO attainment and mixed-fleet goodput
(useful train steps + SLO-met serve steps per second) to the queueing
metrics, which is what lets benchmarks/cluster_sim.py show inference
flipping the collocation verdict (MIGPerf's finding).

Straggler mitigation folds in as an event handler too: ``observe_step``
feeds the per-device EMA, and a flagged straggler is checkpointed,
re-queued with a ``min_profile`` floor one profile larger (the repack_plan
suggestion), and re-placed — the one-shot plan turned into a live action.

Gang jobs (core/gang/ — the Flex-MIG direction): a spec with
``world_size > 1`` runs as k cooperating members, each on its own MIG
slice, possibly across devices. Admission is all-or-nothing: the gang
placement search (core/gang/placement.py) either finds a slice for every
member or the gang waits whole — after ``gang_reserve_after_s`` of
waiting, a GANG_RESERVE event grants the oldest blocked gang the
admission queue's device reservation so backfilling singletons stop
refilling the capacity it needs (the starvation bound; reservations
release deterministically on placement or rejection). A placed gang is
ONE ClusterJob registered in every member device's ``running`` map, with
per-rank assignments keyed ``name#r<rank>``; its effective step is the
slowest member plus the communication overhead (core/gang/comms.py), so
co-located slice sets strictly beat scattered ones. One member's slice
failing kills the whole gang — surviving members are torn down on their
devices and the gang re-queues once, priority-bumped, resuming from its
last coordinated checkpoint (``elastic.split_by_failure`` maps the hit
member back to its gang). Gangs are MIG-only: shared-mode fleets reject
them at arrival, and the adaptive/planner migration paths leave
gang-hosting devices alone.

Determinism: given the same submitted trace, every run is bit-identical —
events tie-break in push order, queues order by (priority, arrival, seq),
and nothing reads wall clocks or unseeded RNG. launch/simulate.py layers a
seeded synthetic arrival-trace generator on top and tests/test_cluster.py
pins byte-identical artifacts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core.collocation import (
    Assignment,
    CharKey,
    CollocationScheduler,
    Schedule,
    is_sku_keyed_db,
    rank_modes,
)
from repro_torch.core.device import DEFAULT_SKU, DeviceSKU, get_sku
from repro_torch.core.device import DEFAULT_RECONFIG_COST_S as _BASE_RECONFIG_COST_S
from repro_torch.core.elastic import REQUEUE_PRIORITY_BUMP, split_by_failure
from repro_torch.core.events import Event, EventKind, EventQueue
from repro_torch.core.forecast import (
    ForecastConfig,
    RateForecast,
    forecast_provenance,
    next_tick,
    plan_autoscale,
    wave_amortizes,
)
from repro_torch.core.gang.comms import DEFAULT_LINK, LinkModel, gang_step_s
from repro_torch.core.gang.parallelism import (
    gang_world_size,
    member_name,
    resolve_parallelism,
)
from repro_torch.core.gang.placement import GangPlan, plan_gang
from repro_torch.core.instance import JobSpec
from repro_torch.core.calib.online import OnlineCalibrator
from repro_torch.core.obs import TraceRecorder
from repro_torch.core.profiles import Placement
from repro_torch.core.queueing import AdmissionQueue, QueueEntry
from repro_torch.core.sharing import (
    CollocationMode,
    busy_fraction_from_terms,
    device_busy_fraction,
    shared_effective_steps,
)
from repro_torch.core.workload import (
    PhaseSpan,
    Workload,
    as_workload,
    member_demand,
    peak_demand_multiplier,
    span_at,
)

# Live re-partitioning penalty: drain + MIG instance destroy/create + MPS
# daemon restart + checkpoint restore of the displaced jobs. Charged per
# migration on top of the per-job epoch rollback. Aliases the device
# model's baseline (core/device.py) so the two cannot drift; per-device
# SKUs scale it (Cluster._device_reconfig_cost).
DEFAULT_RECONFIG_COST_S = _BASE_RECONFIG_COST_S

# Checkpoint cadence the rollback models: train.py saves one manifest per
# epoch, and checkpoint/store.py makes a checkpoint visible only once its
# manifest lands — so a displaced job resumes from the last *epoch* boundary.
CHECKPOINT_EVERY_EPOCHS = 1


@dataclasses.dataclass
class ClusterJob:
    """A submitted job plus its simulation state.

    ``spec`` is either a flat ``JobSpec`` (adapted to a single steady
    phase) or a phase-aware ``Workload``; ``plan`` is the workload's phase
    sequence resolved onto this job's concrete step count at submit time.
    The job's *current* phase is always derived from ``steps_done``, so
    checkpoint rollbacks re-enter the right phase for free."""

    spec: Union[JobSpec, Workload]
    arrival_s: float
    epochs: int = 1
    samples_per_epoch: int = 3200
    plan: Tuple[PhaseSpan, ...] = ()
    kind: str = "train"
    slo_step_s: Optional[float] = None
    # -- runtime state ------------------------------------------------------
    steps_done: float = 0.0
    step_s: float = 0.0  # current effective step time on its device
    device: Optional[str] = None
    last_update_s: float = 0.0
    started_s: Optional[float] = None  # first placement (queueing delay end)
    finished_s: Optional[float] = None
    migrations: int = 0
    straggler_repacks: int = 0
    lost_steps: float = 0.0  # progress re-done after checkpoint rollbacks
    phase_transitions: int = 0
    slo_steps: float = 0.0  # latency-sensitive steps executed (serve)
    slo_met_steps: float = 0.0  # of those, steps whose step_s met the SLO
    token: int = 0  # completion-event generation (lazy invalidation)
    pending_event: Optional[Event] = None  # in-heap lifecycle event, if any
    rejected_reason: Optional[str] = None
    # -- gang runtime state (world_size > 1 only) ---------------------------
    member_devices: Tuple[str, ...] = ()  # device per member rank, placed
    gang_requeues: int = 0  # gang-wide failure re-queues
    gang_spread: int = 0  # distinct devices at the last placement
    gang_reserve_pending: bool = False  # a GANG_RESERVE event is in-heap

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def world_size(self) -> int:
        return gang_world_size(self.spec)

    def current_span(self) -> PhaseSpan:
        return span_at(self.plan, self.steps_done)

    def active_demand(self):
        return self.current_span().demand

    @property
    def slo_attainment(self) -> Optional[float]:
        if self.slo_step_s is None or self.slo_steps <= 0:
            return None
        return self.slo_met_steps / self.slo_steps

    @property
    def steps_per_epoch(self) -> int:
        return max(1, -(-self.samples_per_epoch // self.spec.suite.global_batch))

    @property
    def total_steps(self) -> int:
        return self.steps_per_epoch * self.epochs

    @property
    def remaining_steps(self) -> float:
        return max(0.0, self.total_steps - self.steps_done)

    @property
    def queueing_delay_s(self) -> Optional[float]:
        if self.started_s is None:
            return None
        return self.started_s - self.arrival_s

    @property
    def jct_s(self) -> Optional[float]:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s

    def rollback_to_checkpoint(self) -> float:
        """Roll progress back to the last saved checkpoint; return the lost
        steps (the reconfiguration charge beyond the device downtime)."""
        cadence = self.steps_per_epoch * CHECKPOINT_EVERY_EPOCHS
        kept = math.floor(self.steps_done / cadence) * cadence
        lost = self.steps_done - kept
        self.steps_done = float(kept)
        self.lost_steps += lost
        return lost

    def to_row(self) -> Dict:
        row = {
            "name": self.name,
            "arch": self.spec.arch,
            "kind": self.kind,
            "priority": self.spec.priority,
            "arrival_s": self.arrival_s,
            "started_s": self.started_s,
            "finished_s": self.finished_s,
            "queueing_delay_s": self.queueing_delay_s,
            "jct_s": self.jct_s,
            "total_steps": self.total_steps,
            "phases": [s.name for s in self.plan],
            "phase_transitions": self.phase_transitions,
            "slo_step_s": self.slo_step_s,
            "slo_attainment": self.slo_attainment,
            "migrations": self.migrations,
            "straggler_repacks": self.straggler_repacks,
            "lost_steps": self.lost_steps,
            "rejected_reason": self.rejected_reason,
        }
        # schema extension only where the gang axis is exercised: rows for
        # singleton jobs stay byte-identical to the pre-gang artifacts —
        # the same conditional-key rule DeviceState.to_row applies to SKUs
        if self.world_size > 1:
            row["world_size"] = self.world_size
            row["parallelism"] = resolve_parallelism(self.spec).label
            row["gang_requeues"] = self.gang_requeues
            row["gang_spread"] = self.gang_spread
        return row


@dataclasses.dataclass
class DeviceState:
    """One device of the fleet: its SKU, mode, scheduler, live placements."""

    name: str
    mode: CollocationMode
    scheduler: CollocationScheduler
    sku: DeviceSKU = DEFAULT_SKU
    running: Dict[str, ClusterJob] = dataclasses.field(default_factory=dict)
    assignments: Dict[str, Assignment] = dataclasses.field(default_factory=dict)
    failed_units: Set[int] = dataclasses.field(default_factory=set)
    reconfiguring_until: float = float("-inf")
    pending_mode: Optional[CollocationMode] = None
    migrations: int = 0
    reconfig_cost_s: float = 0.0
    last_migration_s: float = float("-inf")
    straggler_repacks: int = 0
    busy_integral_s: float = 0.0
    last_busy_update_s: float = 0.0
    mode_history: List[Tuple[float, str]] = dataclasses.field(default_factory=list)

    def available(self, t: float) -> bool:
        return t >= self.reconfiguring_until

    def occupied_units(self) -> Set[int]:
        occ = set(self.failed_units)
        for a in self.assignments.values():
            occ |= self.sku.units(a.placement)
        return occ

    def to_row(self) -> Dict:
        row = {
            "name": self.name,
            "mode": self.mode.value,
            "mode_history": list(self.mode_history),
            "migrations": self.migrations,
            "reconfig_cost_s": self.reconfig_cost_s,
            "straggler_repacks": self.straggler_repacks,
            "failed_units": sorted(self.failed_units),
        }
        # schema extension only where the hardware axis is exercised: rows
        # for the default SKU stay byte-identical to the pre-device-model
        # artifacts (the a100-40gb compatibility contract) — by name, the
        # same rule launch/simulate.py applies to its cells
        if self.sku.name != DEFAULT_SKU.name:
            row["sku"] = self.sku.name
        return row


@dataclasses.dataclass
class ClusterReport:
    """End-of-run metrics — the currency benchmarks/cluster_sim.py prints."""

    policy: str
    n_devices: int
    horizon_s: float
    makespan_s: float
    completed: int
    completed_train: int
    completed_serve: int
    rejected: int
    still_queued: int
    still_running: int
    mean_jct_s: float
    p95_jct_s: float
    mean_queueing_delay_s: float
    max_queueing_delay_s: float
    throughput_jobs_per_s: float
    # SERVE objective: fraction of executed latency-sensitive (decode)
    # steps whose effective step time met the session's SLO; 1.0 when the
    # trace has no serve steps.
    slo_attainment: float
    # mixed-fleet goodput: useful train steps (net of rollback re-work)
    # plus SLO-met serve steps, per second of horizon.
    goodput_steps_per_s: float
    phase_transitions: int
    utilization: Dict[str, float]  # device -> busy fraction, plus "mean"
    migrations: int
    reconfig_cost_s: float
    lost_steps: float
    straggler_repacks: int
    hol_blocked_events: int
    jobs: List[Dict]
    devices: List[Dict]
    migration_events: List[Dict]
    failure_events: List[Dict]
    # forecast-policy block (estimator + autoscaler counters); None — and
    # absent from to_dict() — for every other policy, so forecast-free
    # artifacts stay byte-identical to pre-forecast ones.
    forecast: Optional[Dict] = None

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        if d.get("forecast") is None:
            d.pop("forecast", None)
        return d


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class Cluster:
    """N devices + admission queue + event loop; see module docstring."""

    def __init__(
        self,
        char_db: Union[Dict[CharKey, dict], Dict[str, Dict[CharKey, dict]]],
        devices: Sequence[Union[
            Tuple[str, Union[CollocationMode, str]],
            Tuple[str, Union[CollocationMode, str], Union[str, DeviceSKU]],
        ]],
        *,
        policy: str = "static",  # "static" | "adaptive" | "planner" | "forecast"
        reconfig_cost_s: float = DEFAULT_RECONFIG_COST_S,
        migration_cooldown_s: float = 5.0,
        migration_hysteresis: float = 0.10,
        migration_window: int = 8,
        scheduler_kwargs: Optional[Dict] = None,
        retime: str = "incremental",
        gang_reserve_after_s: float = 8.0,
        gang_placement: str = "colocate",
        gang_link: Optional[LinkModel] = None,
        forecast: Optional[ForecastConfig] = None,
        trace: Optional[TraceRecorder] = None,
        calibrator: Optional[OnlineCalibrator] = None,
    ):
        """``devices`` entries are ``(name, mode)`` — the default SKU — or
        ``(name, mode, sku)`` for a heterogeneous-generation fleet
        (core/device.py). ``char_db`` is a flat characterization DB shared
        by every device, or — since a char DB speaks one SKU's profile
        names — a ``{sku_name: db}`` mapping for mixed fleets.

        ``retime`` selects the shared-device re-pricing engine:
        ``"incremental"`` (default) batches same-timestamp re-timings,
        serves contention steps from a composition memo, and skips
        admission-queue scans that cannot succeed; ``"full"`` re-runs the
        complete scheduling model on every event — the reference path the
        equivalence suite (tests/test_retime_equivalence.py) holds the
        fast one byte-identical to.

        ``gang_reserve_after_s`` is the gang starvation bound: how long a
        queued gang waits unplaced before a GANG_RESERVE event grants it
        the queue's device reservation. ``gang_placement`` selects the
        placement search's preference — ``"colocate"`` (default; fewest
        devices, the comm-cheap shape) or ``"scatter"`` (one member per
        device — the baseline benchmarks/report.py's gang table prices
        against). ``gang_link`` overrides the link cost model
        (core/gang/comms.py).

        ``forecast`` configures the forecast-driven autoscaler
        (core/forecast/) and requires ``policy="forecast"`` — that policy
        keeps the adaptive policy's reactive machinery and adds a
        FORECAST_TICK clock that pre-warms decode-capable devices ahead
        of the predicted serve ramp (docs/autoscaling.md).

        ``trace`` attaches a ``TraceRecorder`` (core/obs/): every
        scheduler decision, job lifecycle span, occupancy interval, and
        event-boundary counter sample is recorded against sim time
        (docs/observability.md). Tracing is purely observational — a
        traced run's report and artifacts are byte-identical to an
        untraced one.

        ``calibrator`` attaches an ``OnlineCalibrator`` (core/calib/):
        every ``observe_step`` sample additionally folds into running
        per-(SKU, arch, profile) EWMA residuals, and each device
        scheduler's ``predict_step`` multiplies its base prediction by
        the current residual — predictions tighten as measured evidence
        accumulates (MISO's online refinement). Unlike ``trace`` this IS
        behavioural: corrected step times change packing and completion
        clocks, which is why it is opt-in and ``None`` by default."""
        if policy not in ("static", "adaptive", "planner", "forecast"):
            raise ValueError(f"unknown policy {policy!r}")
        if forecast is not None and policy != "forecast":
            raise ValueError("a forecast config requires policy='forecast'")
        if retime not in ("incremental", "full"):
            raise ValueError(f"unknown retime mode {retime!r}")
        if gang_placement not in ("colocate", "scatter"):
            raise ValueError(f"unknown gang_placement {gang_placement!r}")
        self.policy = policy
        self.retime = retime
        self.gang_reserve_after_s = float(gang_reserve_after_s)
        self.gang_placement = gang_placement
        self.gang_link = gang_link if gang_link is not None else DEFAULT_LINK
        self.reconfig_cost_s = float(reconfig_cost_s)
        self.migration_cooldown_s = float(migration_cooldown_s)
        self.migration_hysteresis = float(migration_hysteresis)
        self.migration_window = int(migration_window)
        kwargs = dict(scheduler_kwargs or {})
        if policy == "planner":
            # the planner policy's whole point: MIG placement decisions come
            # from the partition-tree optimizer, not greedy first-fit
            kwargs.setdefault("use_planner", True)
        per_sku_db = is_sku_keyed_db(char_db)
        self.devices: Dict[str, DeviceState] = {}
        for spec in devices:
            name, mode = spec[0], CollocationMode(spec[1])
            sku = get_sku(spec[2] if len(spec) > 2 else None)
            if per_sku_db:
                db = char_db.get(sku.name)
                if db is None:
                    raise KeyError(
                        f"char_db has no entry for SKU {sku.name!r} "
                        f"(device {name!r}); has: {', '.join(char_db)}"
                    )
            else:
                db = char_db
            self.devices[name] = DeviceState(
                name=name,
                mode=mode,
                sku=sku,
                scheduler=CollocationScheduler(db, mode=mode, sku=sku, **kwargs),
            )
            if calibrator is not None:
                self.devices[name].scheduler.calibrator = calibrator
        if not self.devices:
            raise ValueError("a cluster needs at least one device")
        self.events = EventQueue()
        self.queue = AdmissionQueue()
        self.jobs: Dict[str, ClusterJob] = {}
        self.now = 0.0
        self.completed: List[str] = []
        self.rejected: List[Tuple[str, str]] = []
        self.migration_events: List[Dict] = []
        self.failure_events: List[Dict] = []
        # -- incremental re-timing state -----------------------------------
        # devices whose shared co-resident set changed at _dirty_t and have
        # not been re-priced yet (all marks in one batch share a timestamp;
        # the flush points guarantee a flush before any later event)
        self._dirty: Dict[str, float] = {}
        self._dirty_t = 0.0
        # effective-step memo per (mode, sku, ordered co-resident terms key)
        self._shared_steps_cache: Dict[Tuple, Tuple[float, ...]] = {}
        self._busy_cache: Dict[Tuple, float] = {}
        self._unplaceable_cache: Dict[Tuple, Optional[str]] = {}
        # gang arrival capacity memo (incremental engine), keyed like
        # _unplaceable_cache plus the gang shape — see _gang_unplaceable
        self._gang_capacity_cache: Dict[Tuple, int] = {}
        self._trial_reps: Optional[
            List[Tuple[CollocationScheduler, Tuple[CollocationMode, ...]]]
        ] = None
        # dispatch skip-scan: capacity only shrinks between these epoch
        # bumps, so entries that failed a full scan stay blocked until one
        self._capacity_epoch = 0
        self._blocked_epoch: Optional[int] = None
        self._blocked_keys: Set[str] = set()
        self._blocked_floor_key: Optional[Tuple] = None
        self._pending_entries: List[QueueEntry] = []
        self._next_reopen = float("inf")
        # -- forecast autoscaling state (policy="forecast" only) -----------
        self.forecast_config = (
            forecast
            if forecast is not None
            else (ForecastConfig() if policy == "forecast" else None)
        )
        self._fc_estimator = (
            self.forecast_config.build_estimator()
            if self.forecast_config is not None
            else None
        )
        self._fc_tick_pending = False
        self._fc_ticks = 0
        self._fc_last: Optional[RateForecast] = None
        self._fc_peak_rate = 0.0
        # latest serve spec seen: the representative the per-device
        # serve-capacity trials size the warm set against
        self._fc_serve_rep: Optional[Union[JobSpec, Workload]] = None
        self._fc_serve_seen = 0
        self._fc_session_s: Optional[float] = None  # EWMA of serve service time
        self._fc_capacity_cache: Dict[Tuple, int] = {}
        self._fc_prewarm_flips = 0
        self._fc_prewarm_preempts = 0
        self._fc_reactive = 0
        self._dev_index = {name: i for i, name in enumerate(self.devices)}
        # set to a list to record the live event stream (time, kind,
        # payload-sans-token) — the equivalence harness's comparison hook
        self.event_log: Optional[List[Tuple]] = None
        # instrumentation the perf suite reads (NOT part of the report —
        # the report schema is pinned by the artifact byte-compat contract)
        self.perf: Dict[str, int] = {
            "events_processed": 0,
            "retime_requests": 0,
            "retime_flushes": 0,
            "retime_jobs_repriced": 0,
            "retime_batched": 0,
            "shared_steps_hits": 0,
            "shared_steps_misses": 0,
            "dispatch_full_scans": 0,
            "dispatch_fast_scans": 0,
        }
        # -- observability (core/obs/) -------------------------------------
        # normalized to None when detached/disabled so every hook below is
        # a single attribute check on the hot path
        self.trace = trace if (trace is not None and trace.enabled) else None
        # online calibration (core/calib/): observe_step feeds it, the
        # device schedulers read it (wired above); None = no refinement
        self.calibrator = calibrator
        if self.trace is not None:
            self.trace.track("scheduler")
            self.trace.track("queue")
            self.trace.track("jobs")
            for name in self.devices:
                self.trace.track(f"dev:{name}")
            self.queue.attach_trace(self.trace, lambda: self.now)
            self._tr_queue_start: Dict[str, float] = {}
            self._tr_phase: Dict[str, Tuple[str, float]] = {}
            self._tr_occ: Dict[Tuple[str, str], Tuple[float, str]] = {}
            self._tr_fc_arrivals = 0
            self._tr_fc_last_tick_s = 0.0

    # -- trace input -----------------------------------------------------------

    def submit(
        self,
        spec: Union[JobSpec, Workload],
        arrival_s: float,
        *,
        epochs: int = 1,
        samples_per_epoch: int = 3200,
    ) -> ClusterJob:
        """Register a job to arrive at ``arrival_s`` (dynamic arrival).

        ``spec`` may be a flat ``JobSpec`` (single steady phase via the
        adapter) or a phase-aware ``Workload``; its phase sequence is
        resolved onto the job's concrete step count here, once."""
        if spec.name in self.jobs:
            raise KeyError(f"job {spec.name!r} already submitted")
        wl = as_workload(spec)
        cj = ClusterJob(
            spec=spec,
            arrival_s=float(arrival_s),
            epochs=int(epochs),
            samples_per_epoch=int(samples_per_epoch),
            kind=wl.kind.value,
            slo_step_s=wl.slo_step_s,
        )
        cj.plan = wl.resolve(cj.total_steps)
        self.jobs[spec.name] = cj
        self.events.push(arrival_s, EventKind.ARRIVAL, (spec.name,))
        return cj

    def inject_failure(self, device: str, units: Sequence[int], at_s: float) -> None:
        self.events.push(at_s, EventKind.FAILURE, (device, tuple(units)))

    def inject_repair(self, device: str, units: Sequence[int], at_s: float) -> None:
        self.events.push(at_s, EventKind.REPAIR, (device, tuple(units)))

    # -- event loop --------------------------------------------------------------

    def tick(self) -> Optional[Event]:
        """Process the next event; returns it (None if the heap is empty).

        Deferred shared re-pricings (the incremental engine's same-timestamp
        batch) are flushed before popping a strictly later event and again
        before control returns, so code stepping tick-by-tick always sees a
        consistent cluster between calls — only *within* a same-time run of
        events can step times be momentarily stale, which is exactly the
        window the full path's redundant intermediate re-timings occupy."""
        self._flush_if_due()
        if not self.events:
            return None
        ev = self.events.pop()
        self.now = max(self.now, ev.time_s)
        self.perf["events_processed"] += 1
        t = ev.time_s
        if self.event_log is not None:
            self._log_event(ev)
        if ev.kind == EventKind.ARRIVAL:
            self._on_arrival(ev.payload[0], t)
        elif ev.kind == EventKind.COMPLETION:
            self._on_completion(*ev.payload, t=t)
        elif ev.kind == EventKind.PHASE_TRANSITION:
            self._on_phase_transition(*ev.payload, t=t)
        elif ev.kind == EventKind.RECONFIG_DONE:
            self._on_reconfig_done(ev.payload[0], t)
        elif ev.kind == EventKind.FAILURE:
            self._on_failure(ev.payload[0], ev.payload[1], t)
        elif ev.kind == EventKind.REPAIR:
            self._on_repair(ev.payload[0], ev.payload[1], t)
        elif ev.kind == EventKind.GANG_RESERVE:
            self._on_gang_reserve(ev.payload[0], t)
        elif ev.kind == EventKind.FORECAST_TICK:
            self._on_forecast_tick(t)
        if self.trace is not None:
            self._trace_counters(t)
        self._flush_if_due()
        return ev

    def _flush_if_due(self) -> None:
        """Flush deferred re-pricings unless the next event shares their
        timestamp (then the batch is still open — flushing now would do
        work the rest of the same-time run immediately invalidates)."""
        if self._dirty:
            nt = self.events.peek_time()
            if nt is None or nt > self._dirty_t:
                self._flush_retimes()

    def run_until(self, t_end: float) -> None:
        while True:
            if self._dirty:
                nt = self.events.peek_time()
                if nt is None or nt > self._dirty_t:
                    self._flush_retimes()
                    continue  # the flush may schedule events <= t_end
            nt = self.events.peek_time()
            if nt is None or nt > t_end:
                break
            self.tick()
        self.now = max(self.now, t_end)

    def run(self) -> "ClusterReport":
        """Drain every event and return the end-of-run report."""
        while self.events or self._dirty:
            self.tick()
        return self.report()

    def _log_event(self, ev: Event) -> None:
        """Append the event to ``event_log`` if it is *live* — the stream
        both re-timing engines must agree on. Stale (token-mismatched)
        lifecycle events are omitted: the full path pops and drops them,
        the incremental path tombstones them before they surface; and the
        token itself is stripped from the payload because it counts
        re-timings, which is precisely what the engines do differently."""
        payload = ev.payload
        if ev.kind in (EventKind.COMPLETION, EventKind.PHASE_TRANSITION):
            dev_name, name, token = payload
            cj = self.jobs.get(name)
            dev = self.devices.get(dev_name)
            if (
                cj is None
                or dev is None
                or cj.token != token
                or name not in dev.running
            ):
                return
            payload = (dev_name, name)
        self.event_log.append((round(ev.time_s, 9), ev.kind.value, payload))

    # -- trace hooks (core/obs/) -------------------------------------------------
    #
    # Every method below is called only when ``self.trace`` is attached, and
    # none of them touch scheduler state — tracing a run cannot change it
    # (tests/test_obs.py pins a traced cell byte-identical to an untraced
    # one). Span bookkeeping lives cluster-side: occupancy and phase
    # intervals open here and close on completion/displacement, so the
    # recorder only ever sees closed spans.

    def _trace_counters(self, t: float) -> None:
        """Sample the counter series on an event boundary (post-handler)."""
        tr = self.trace
        tr.counter("queue_depth", t, len(self.queue))
        tr.counter("warm_set", t, len(self.queue.prewarmed_devices))
        running = 0
        for dev in self.devices.values():
            tr.counter(f"util:{dev.name}", t, round(self._busy_fraction(dev), 6))
            running += len(dev.running)
        tr.counter("running_jobs", t, running)
        slo_steps = 0.0
        slo_met = 0.0
        for j in self.jobs.values():
            slo_steps += j.slo_steps
            slo_met += j.slo_met_steps
        tr.counter(
            "slo_attainment",
            t,
            round(slo_met / slo_steps, 6) if slo_steps > 0 else 1.0,
        )

    def _tr_note_dispatch(self, cj: ClusterJob, t: float, *, first: bool) -> None:
        """Close the job's queued span and record the dispatch decision."""
        t0 = self._tr_queue_start.pop(cj.name, cj.arrival_s)
        self.trace.span("queue", f"{cj.name} queued", t0, t, cat="queue")
        self.trace.instant(
            "scheduler",
            "dispatch",
            t,
            args={
                "job": cj.name,
                "device": cj.device or "",
                "wait_s": round(t - t0, 9),
                "first": first,
            },
        )
        self._tr_phase[cj.name] = (cj.current_span().name, t)

    def _tr_close_phase(self, cj: ClusterJob, t: float) -> None:
        ph = self._tr_phase.pop(cj.name, None)
        if ph is not None:
            self.trace.span("jobs", f"{cj.name}:{ph[0]}", ph[1], t, cat="phase")

    def _tr_occupy(self, dev_name: str, key: str, label: str, t: float) -> None:
        self._tr_occ[(dev_name, key)] = (t, label)

    def _tr_release_occ(self, dev_name: str, key: str, t: float) -> None:
        rec = self._tr_occ.pop((dev_name, key), None)
        if rec is not None:
            self.trace.span(f"dev:{dev_name}", rec[1], rec[0], t, cat="occupancy")

    def _tr_completion_sample(self, cj: ClusterJob, profile: str, t: float) -> None:
        """Lifetime-average measured step vs the final predicted rate —
        the sample the calibration item gets even without live
        ``observe_step`` telemetry."""
        if cj.started_s is None or t <= cj.started_s or cj.total_steps <= 0:
            return
        self.trace.step_sample(
            t,
            cj.name,
            cj.spec.arch,
            profile,
            (t - cj.started_s) / cj.total_steps,
            cj.step_s,
            source="completion",
        )

    # -- handlers ---------------------------------------------------------------

    def _enqueue(self, name: str, cj: ClusterJob, t: float) -> None:
        """Queue a job for dispatch, remembering the entry as a fresh
        placement candidate for the skip-scan dispatcher."""
        e = self.queue.push(name, cj, priority=cj.spec.priority, enqueued_s=t)
        self._pending_entries.append(e)
        if self.trace is not None:
            self._tr_queue_start[name] = t

    def _on_arrival(self, name: str, t: float) -> None:
        cj = self.jobs[name]
        if cj.world_size > 1:
            reason = self._gang_unplaceable(cj)
        else:
            reason = self._definitely_unplaceable(cj.spec)
        if reason is not None:
            cj.rejected_reason = reason
            self.rejected.append((name, reason))
            if self.trace is not None:
                self.trace.instant(
                    "scheduler", "reject", t, args={"job": name, "reason": reason}
                )
            return
        if self._fc_estimator is not None:
            self._fc_observe_arrival(cj, t)
        self._enqueue(name, cj, t)
        self._dispatch(t)
        self._maybe_migrate(t)

    def _on_completion(self, dev_name: str, name: str, token: int, *, t: float) -> None:
        dev = self.devices[dev_name]
        cj = self.jobs[name]
        if cj.token != token or name not in dev.running:
            return  # stale event — the job was re-timed, migrated, or killed
        cj.pending_event = None  # this event; it just left the heap
        if cj.world_size > 1:
            self._finish_gang(cj, t)
            return
        self._accrue_busy(dev, t)
        self._update_progress(dev, t)
        cj.steps_done = float(cj.total_steps)  # clamp fp residue
        cj.finished_s = t
        cj.device = None
        if self.trace is not None:
            self._tr_close_phase(cj, t)
            self._tr_release_occ(dev.name, name, t)
            self._tr_completion_sample(cj, dev.assignments[name].profile, t)
        del dev.running[name]
        del dev.assignments[name]
        self.completed.append(name)
        if (
            self._fc_estimator is not None
            and cj.kind == "serve"
            and cj.started_s is not None
        ):
            # learn the serve session's device-holding time — the
            # "service time" in the autoscaler's Little's-law sizing
            self._fc_note_session(t - cj.started_s)
        self._capacity_epoch += 1
        if dev.mode != CollocationMode.MIG and dev.running:
            # a departure lowers the contention factors for every neighbour
            self._retime_shared(dev, t)
        self._dispatch(t)
        self._maybe_migrate(t)

    def _finish_gang(self, cj: "ClusterJob", t: float) -> None:
        """Gang completion: every member device frees its slice at once —
        the lifecycle event lives on the primary (rank-0) device, but the
        gang occupies all of ``member_devices``."""
        for dname in dict.fromkeys(cj.member_devices):
            d = self.devices[dname]
            self._accrue_busy(d, t)
            self._update_progress(d, t)
        cj.steps_done = float(cj.total_steps)  # clamp fp residue
        cj.finished_s = t
        cj.device = None
        if self.trace is not None:
            self._tr_close_phase(cj, t)
        for rank, dname in enumerate(cj.member_devices):
            d = self.devices[dname]
            d.running.pop(cj.name, None)
            d.assignments.pop(member_name(cj.name, rank), None)
            if self.trace is not None:
                self._tr_release_occ(dname, member_name(cj.name, rank), t)
        cj.member_devices = ()
        self.completed.append(cj.name)
        self._capacity_epoch += 1
        # members are MIG-only: no shared neighbours to re-time
        self._dispatch(t)
        self._maybe_migrate(t)

    def _on_phase_transition(self, dev_name: str, name: str, token: int, *, t: float) -> None:
        """A placed job crossed into its next phase: its demand vector — and
        with it every shared neighbour's contention — just changed."""
        dev = self.devices[dev_name]
        cj = self.jobs[name]
        if cj.token != token or name not in dev.running:
            return  # stale event — the job was re-timed, migrated, or killed
        cj.pending_event = None  # this event; it just left the heap
        self._accrue_busy(dev, t)
        self._update_progress(dev, t)
        # snap fp residue onto the integer boundary the event fired for, so
        # the derived current phase is exactly the next span
        boundary = round(cj.steps_done)
        if abs(cj.steps_done - boundary) < 1e-6:
            cj.steps_done = float(boundary)
        cj.phase_transitions += 1
        if self.trace is not None:
            self._tr_close_phase(cj, t)
            self._tr_phase[name] = (cj.current_span().name, t)
        if dev.mode == CollocationMode.MIG:
            if cj.world_size > 1:
                # every member re-prices at the new demand; the gang step
                # is the slowest member plus the (unchanged-placement)
                # communication overhead
                self._reprice_gang(cj, t)
                self._maybe_migrate(t)
                return
            # isolation (F3): only this job's own step time changes
            a = dev.assignments[name]
            cj.step_s = dev.scheduler.predict_step(
                cj.spec, a.profile, cj.active_demand()
            )
            a.predicted_step_s = cj.step_s
            self._schedule_next_event(dev, cj, t)
        else:
            # shared device: the new vector feeds everyone's contention
            self._retime_shared(dev, t)
        # a demand change is composition drift — let the adaptive policy
        # reconsider the device partitioning
        self._maybe_migrate(t)

    def _on_reconfig_done(self, dev_name: str, t: float) -> None:
        dev = self.devices[dev_name]
        self._accrue_busy(dev, t)
        if dev.pending_mode is not None:
            dev.mode = dev.pending_mode
            dev.scheduler.mode = dev.pending_mode
            dev.pending_mode = None
            dev.mode_history.append((t, dev.mode.value))
        self._capacity_epoch += 1  # the device re-opened
        self._dispatch(t)

    def _on_failure(self, dev_name: str, units: Sequence[int], t: float) -> None:
        dev = self.devices[dev_name]
        self._accrue_busy(dev, t)
        self._update_progress(dev, t)
        dev.failed_units |= set(units)
        self._capacity_epoch += 1
        self._dirty.pop(dev.name, None)  # a pending re-price of the dead set
        if dev.mode == CollocationMode.MIG:
            killed_specs, survivors = split_by_failure(
                list(dev.assignments.values()), dev.failed_units, dev.sku
            )
            survivor_names = {a.job.name for a in survivors}
        else:
            # no isolation on a shared device: every job dies with it
            killed_specs = [
                dataclasses.replace(
                    cj.spec, priority=cj.spec.priority + REQUEUE_PRIORITY_BUMP
                )
                for cj in dev.running.values()
            ]
            survivor_names = set()
        killed_names = []
        hit_gangs: List[str] = []
        for spec in killed_specs:
            killed_names.append(spec.name)
            gang = getattr(spec, "gang", None)
            if gang is not None:
                # a member spec: the whole gang dies with it — widen the
                # kill to the gang's other devices and re-queue it once
                if gang not in hit_gangs:
                    hit_gangs.append(gang)
                continue
            self._displace(dev, spec.name, t, new_spec=spec)
        for gang in hit_gangs:
            self._requeue_gang(self.jobs[gang], t)
        self.failure_events.append(
            {
                "t_s": t,
                "device": dev_name,
                "units": sorted(set(units)),
                "killed": killed_names,
                "survivors": sorted(survivor_names),
            }
        )
        self._dispatch(t)
        self._maybe_migrate(t)

    def _on_repair(self, dev_name: str, units: Sequence[int], t: float) -> None:
        dev = self.devices[dev_name]
        self._accrue_busy(dev, t)
        dev.failed_units -= set(units)
        self._capacity_epoch += 1
        self._dispatch(t)
        self._maybe_migrate(t)

    # -- admission: priority + backfill -------------------------------------------

    def _definitely_unplaceable(self, spec: JobSpec) -> Optional[str]:
        """A job is rejected outright only if no device could run it even
        empty, under any mode the policy allows — everything else waits.

        An empty-device trial depends only on the device's (SKU, mode) —
        same char DB and placement tree — so dedupe to one trial per
        reachable (SKU, mode) pair instead of one per device: the first
        device of each SKU stands in for its generation. A mixed fleet is
        the point: a big-memory job unplaceable on every 40GB tree waits
        for (or lands on) the 80GB devices instead of being rejected.

        The verdict depends only on (arch, shape, repack floor, phase-peak
        multiplier) — the fleet's reachable (SKU, mode) pairs are fixed for
        a run under every policy (static/planner modes never change;
        adaptive trials all modes regardless) — so the incremental engine
        memoizes it per that key: a 10^5-arrival trace drawing from a
        handful of registry shapes pays for the trial schedules once."""
        if self.retime == "incremental":
            key = (
                spec.arch,
                spec.suite.name,
                getattr(spec, "min_profile", None),
                peak_demand_multiplier(spec),
            )
            if key not in self._unplaceable_cache:
                self._unplaceable_cache[key] = self._unplaceable_scan(spec)
            return self._unplaceable_cache[key]
        return self._unplaceable_scan(spec)

    def _unplaceable_scan(self, spec: JobSpec) -> Optional[str]:
        if self._trial_reps is None:
            reps: Dict[str, CollocationScheduler] = {}
            sku_modes: Dict[str, Tuple[CollocationMode, ...]] = {}
            for d in self.devices.values():
                if d.sku.name not in reps:
                    reps[d.sku.name] = d.scheduler
                    sku_modes[d.sku.name] = ()
                if self.policy in ("adaptive", "forecast"):
                    sku_modes[d.sku.name] = tuple(CollocationMode)
                elif d.mode not in sku_modes[d.sku.name]:
                    sku_modes[d.sku.name] += (d.mode,)
            self._trial_reps = [
                (reps[sn], sku_modes[sn]) for sn in reps
            ]
        last_reason = "no devices"
        for scheduler, modes in self._trial_reps:
            # trial schedules must not leave straggler predictions behind
            # for jobs that were never deployed
            snapshot = dict(scheduler._predicted)
            try:
                for m in modes:
                    trial = scheduler.schedule([spec], mode=m)
                    if trial.assignments:
                        return None
                    if trial.rejections:
                        last_reason = trial.rejections[0].reason
            finally:
                scheduler._predicted = snapshot
        return f"unplaceable on any empty device: {last_reason}"

    def _dispatch(self, t: float) -> None:
        """Drain the admission queue: strict priority order with backfill —
        a blocked high-priority job does not stop later entries that fit.

        The incremental engine remembers the outcome: between capacity
        epochs (completion / failure / repair / reconfiguration / displace)
        placements only *shrink* capacity, and phase transitions never
        change placeability (admission budgets the phase-peak working set,
        a per-job constant) — so entries that failed the last full scan
        must still fail, and only entries queued since then are tried."""
        if self._dirty and self.queue:
            # re-price before placing: the candidate admission below reads
            # the co-resident sets the deferred re-timings are about to touch
            self._flush_retimes()
        if self.retime != "incremental":
            self._dispatch_scan(t, self.queue.ordered())
            return
        if t >= self._next_reopen:
            # a reconfiguring device re-opened purely by time passing (its
            # RECONFIG_DONE shares this timestamp but may not have popped
            # yet) — conservative: rescan everything
            self._recompute_next_reopen(t)
            self._blocked_epoch = None
        if self._blocked_epoch == self._capacity_epoch:
            self.perf["dispatch_fast_scans"] += 1
            pending = [
                e
                for e in self._pending_entries
                if self.queue.get(e.key) is e and e.key not in self._blocked_keys
            ]
            self._pending_entries = []
            pending.sort(key=QueueEntry.sort_key)
            self._dispatch_scan(t, pending, known_blocked=True)
            return
        self.perf["dispatch_full_scans"] += 1
        self._pending_entries = []
        self._blocked_keys = set()
        self._blocked_floor_key = None
        self._dispatch_scan(t, self.queue.ordered())
        self._blocked_epoch = self._capacity_epoch

    def _dispatch_scan(
        self, t: float, entries: List[QueueEntry], *, known_blocked: bool = False
    ) -> None:
        """One in-order placement pass over ``entries``. With
        ``known_blocked`` the pass is a fast scan over fresh candidates
        only: previously blocked entries are not re-tried, but still count
        as "an earlier entry is blocked" for backfill-overtake accounting
        when they sort ahead of a candidate that places."""
        blocked_any = False
        floor = self._blocked_floor_key
        for entry in entries:
            cj = entry.item
            placed = False
            if cj.world_size > 1:
                placed = self._try_place_gang(cj, t)
            else:
                for dev in self._placement_order(cj):
                    if self._try_place(dev, cj, t):
                        placed = True
                        break
            if placed:
                self.queue.remove(entry.key)
                first = cj.started_s is None
                if cj.started_s is None:
                    cj.started_s = t
                if self.trace is not None:
                    self._tr_note_dispatch(cj, t, first=first)
                if blocked_any or (
                    known_blocked
                    and floor is not None
                    and floor < entry.sort_key()
                ):
                    self.queue.note_backfill_overtake()
                    if self.trace is not None:
                        self.trace.instant(
                            "scheduler",
                            "backfill_overtake",
                            t,
                            args={"job": cj.name, "device": cj.device or ""},
                        )
            else:
                blocked_any = True
                if self.retime == "incremental":
                    self._blocked_keys.add(entry.key)
                    k = entry.sort_key()
                    if floor is None or k < floor:
                        floor = k
        self._blocked_floor_key = floor

    def _placement_order(self, cj: ClusterJob):
        """Device iteration order for singleton placement. The forecast
        policy routes serve sessions decode-first — MIG (or MIG-pending)
        devices ahead of shared ones — so sessions land on the warmed
        slices instead of crowding the shared training devices. Every
        other policy keeps the fleet's insertion order (the byte-compat
        contract for existing artifacts)."""
        if self.policy != "forecast" or cj.kind != "serve":
            return self.devices.values()
        return sorted(
            self.devices.values(),
            key=lambda d: (
                0 if (d.pending_mode or d.mode) == CollocationMode.MIG else 1,
                self._dev_index[d.name],
            ),
        )

    def _recompute_next_reopen(self, t: float) -> None:
        nxt = float("inf")
        for d in self.devices.values():
            if d.reconfiguring_until > t:
                nxt = min(nxt, d.reconfiguring_until)
        self._next_reopen = nxt

    def _try_place(self, dev: DeviceState, cj: ClusterJob, t: float) -> bool:
        if not dev.available(t):
            return False
        if self.queue.reserved_against(cj.name, dev.name):
            if self.trace is not None:
                self.trace.instant(
                    "scheduler",
                    "veto_reserved",
                    t,
                    args={
                        "job": cj.name,
                        "device": dev.name,
                        "held_by": self.queue.reserved_by,
                    },
                )
            return False  # held for a starved gang — backfill must not refill
        if self.queue.prewarm_blocks(dev.name, cj.kind):
            if self.trace is not None:
                self.trace.instant(
                    "scheduler",
                    "veto_prewarm",
                    t,
                    args={
                        "job": cj.name,
                        "device": dev.name,
                        "warmed_for": self.queue.prewarmed_kind(dev.name),
                    },
                )
            return False  # pre-warmed for another kind ahead of a ramp
        if dev.mode == CollocationMode.MIG:
            sched = dev.scheduler.schedule(
                [cj.spec],
                blocked_units=frozenset(dev.failed_units),
                mode=CollocationMode.MIG,
                existing=[a.placement for a in dev.assignments.values()],
                active_phases={cj.name: cj.active_demand()},
            )
            if not sched.assignments:
                return False
            self._accrue_busy(dev, t)
            self._bind(dev, cj, sched.assignments[0], t)
            return True
        # shared device (naive / MPS): re-admit the whole set so the mode's
        # contention model re-times everyone; the candidate is admitted only
        # if every already-running job keeps its place (no preemption).
        if dev.failed_units:
            return False  # degraded shared device takes no new work
        if self.retime == "incremental":
            fast = self._try_place_shared_fast(dev, cj, t)
            if fast is not None:
                return fast
        specs = [j.spec for j in dev.running.values()] + [cj.spec]
        active = {j.name: j.active_demand() for j in dev.running.values()}
        active[cj.name] = cj.active_demand()
        sched = dev.scheduler.schedule(specs, mode=dev.mode, active_phases=active)
        placed_names = {a.job.name for a in sched.assignments}
        if cj.name not in placed_names:
            return False
        if not all(n in placed_names for n in dev.running):
            return False
        self._accrue_busy(dev, t)
        self._update_progress(dev, t)
        dev.running[cj.name] = cj
        cj.device = dev.name
        cj.last_update_s = t
        if self.trace is not None:
            self._tr_occupy(dev.name, cj.name, f"{cj.name} {dev.mode.value}", t)
        for a in sched.assignments:
            j = dev.running[a.job.name]
            j.step_s = a.predicted_step_s
            dev.assignments[a.job.name] = a
            self._schedule_next_event(dev, j, t)
        self._dirty.pop(dev.name, None)  # the full re-admission re-priced all
        return True

    def _try_place_shared_fast(
        self, dev: DeviceState, cj: ClusterJob, t: float
    ) -> Optional[bool]:
        """Shared-device admission without rebuilding the scheduling model:
        replay ``_schedule_shared``'s admission scan (priority order, running
        footprints prefix-summed against the HBM budget) from the memoized
        per-job verdicts, then re-price the grown set through the
        contention-step memo. Returns None to defer to the full model in
        the cases it owns (a *running* job failing re-admission cannot
        happen — footprint sums of a subset are monotone — but the full
        path is the authority if it ever did)."""
        order = sorted(
            list(dev.running.values()) + [cj], key=lambda j: -j.spec.priority
        )
        budget = dev.sku.slice_bytes
        used = 0.0
        for j in order:
            adm = dev.scheduler.shared_admission(j.spec)
            if adm is None or not adm[1] or used + adm[0] > budget:
                if j is cj:
                    return False
                return None  # pragma: no cover - running jobs always re-admit
            used += adm[0]
        steps = self._shared_steps(dev, order)
        if steps is None:  # pragma: no cover - admitted jobs have records
            return None
        self._accrue_busy(dev, t)
        self._update_progress(dev, t)
        dev.running[cj.name] = cj
        cj.device = dev.name
        cj.last_update_s = t
        if self.trace is not None:
            self._tr_occupy(dev.name, cj.name, f"{cj.name} {dev.mode.value}", t)
        self._apply_shared_steps(dev, order, steps, t)
        self._dirty.pop(dev.name, None)  # the placement re-priced everyone
        return True

    def _bind(self, dev: DeviceState, cj: ClusterJob, a: Assignment, t: float) -> None:
        """Bind a job to its MIG instance and schedule its next lifecycle
        event from ``t`` — the one binding invariant, shared by the
        dispatch path and the replan commit (which binds at the *end* of
        the reconfiguration window)."""
        dev.assignments[cj.name] = a
        dev.running[cj.name] = cj
        cj.device = dev.name
        cj.step_s = a.predicted_step_s
        cj.last_update_s = t
        if self.trace is not None:
            self._tr_occupy(
                dev.name, cj.name, f"{cj.name} {a.placement.profile}", t
            )
        self._schedule_next_event(dev, cj, t)

    # -- gang scheduling (core/gang/) -------------------------------------------

    def _member_specs(self, cj: ClusterJob) -> List[Workload]:
        """Per-rank member specs: the gang's workload re-labelled
        ``name#r<rank>`` with ``gang`` set, so admission prices the member
        memory fraction (workload.peak_demand_multiplier) and
        elastic.split_by_failure can map a hit member back to its gang."""
        wl = as_workload(cj.spec)
        return [
            dataclasses.replace(wl, name=member_name(cj.name, r), gang=cj.name)
            for r in range(cj.world_size)
        ]

    def _gang_collective_s(self, cj: ClusterJob, dev: DeviceState) -> float:
        """Per-step collective seconds the comms model scales per axis: the
        full-device solo record's collective term under the gang's active
        demand — inter-member traffic tracks the whole job's collective
        volume, not the member-scaled busy terms."""
        rec = dev.scheduler.char_db.get(
            (cj.spec.arch, cj.spec.suite.name, dev.sku.full_profile)
        )
        if rec is None:
            return 0.0
        return float(rec.get("collective_s", 0.0)) * cj.active_demand().collective

    def _gang_devices(self, cj: ClusterJob, t: float) -> List[DeviceState]:
        """MIG devices the gang may place on right now, fleet order."""
        return [
            dev
            for dev in self.devices.values()
            if dev.mode == CollocationMode.MIG
            and dev.available(t)
            and not self.queue.reserved_against(cj.name, dev.name)
            and not self.queue.prewarm_blocks(dev.name, cj.kind)
        ]

    def _try_place_gang(self, cj: ClusterJob, t: float) -> bool:
        """All-or-nothing gang placement: probe every eligible device's
        member capacity under its current occupancy, hand the capacity
        vector to the placement search (core/gang/placement.py), and bind
        the winning plan — or note the gang blocked (starting the
        starvation-bound clock) and place nothing."""
        members = self._member_specs(cj)
        mdemand = member_demand(cj.spec, cj.active_demand())
        devs = self._gang_devices(cj, t)
        if not devs:
            self._gang_note_blocked(cj, t)
            return False
        active = {m.name: mdemand for m in members}
        snapshots = [(d, dict(d.scheduler._predicted)) for d in devs]
        try:

            def trial(dev: DeviceState, chunk: List[Workload]):
                return dev.scheduler.schedule(
                    chunk,
                    blocked_units=frozenset(dev.failed_units),
                    mode=CollocationMode.MIG,
                    existing=[a.placement for a in dev.assignments.values()],
                    active_phases={m.name: active[m.name] for m in chunk},
                )

            caps = [len(trial(d, members).assignments) for d in devs]

            def probe(idx: int, ranks: Sequence[int]):
                chunk = [members[r] for r in ranks]
                sched = trial(devs[idx], chunk)
                if len(sched.assignments) != len(chunk):
                    return None
                by_name = {a.job.name: a for a in sched.assignments}
                return [
                    (by_name[m.name].placement, by_name[m.name].predicted_step_s)
                    for m in chunk
                ]

            plan = plan_gang(
                resolve_parallelism(cj.spec),
                [d.name for d in devs],
                caps,
                probe,
                self._gang_collective_s(cj, devs[0]),
                prefer=self.gang_placement,
                link=self.gang_link,
            )
        finally:
            # trial schedules must not leave straggler predictions behind
            for d, snap in snapshots:
                d.scheduler._predicted = snap
        if plan is None:
            self._gang_note_blocked(cj, t)
            return False
        self._bind_gang(cj, members, plan, t)
        return True

    def _bind_gang(
        self, cj: ClusterJob, members: List[Workload], plan: GangPlan, t: float
    ) -> None:
        """Bind every member to its planned slice. The gang is ONE
        ClusterJob registered in each member device's running map (the
        progress guard makes the multi-registration idempotent); its
        single lifecycle event lives on the primary (rank-0) device."""
        if self.trace is not None:
            self.trace.instant(
                "scheduler",
                "gang_place",
                t,
                args={
                    "gang": cj.name,
                    "prefer": self.gang_placement,
                    **plan.provenance(),
                },
            )
        for slot in plan.slots:
            dev = self.devices[slot.device]
            self._accrue_busy(dev, t)
            dev.assignments[member_name(cj.name, slot.rank)] = Assignment(
                members[slot.rank], slot.placement, slot.step_s
            )
            dev.running[cj.name] = cj
            if self.trace is not None:
                self._tr_occupy(
                    slot.device,
                    member_name(cj.name, slot.rank),
                    f"{cj.name}#r{slot.rank} {slot.placement.profile}",
                    t,
                )
        cj.member_devices = plan.devices
        cj.gang_spread = plan.spread
        cj.device = plan.slots[0].device
        cj.step_s = plan.step_s
        cj.last_update_s = t
        # the reservation veto (if this gang held one) lifts when the
        # dispatcher removes the entry — blocked singletons may fit again
        self._capacity_epoch += 1
        self._schedule_next_event(self.devices[cj.device], cj, t)

    def _reprice_gang(self, cj: ClusterJob, t: float) -> None:
        """Phase transition on a gang: re-price every member at the new
        demand vector and re-derive the comm-priced gang step. Placements
        do not move — only the demand changed (F3 per member slice)."""
        mdemand = member_demand(cj.spec, cj.active_demand())
        steps = []
        rank_device: Dict[int, str] = {}
        for rank, dname in enumerate(cj.member_devices):
            d = self.devices[dname]
            a = d.assignments[member_name(cj.name, rank)]
            step = d.scheduler.predict_step(a.job, a.profile, mdemand)
            a.predicted_step_s = step
            steps.append(step)
            rank_device[rank] = dname
        primary = self.devices[cj.member_devices[0]]
        cj.step_s = gang_step_s(
            steps,
            resolve_parallelism(cj.spec),
            rank_device,
            self._gang_collective_s(cj, primary),
            self.gang_link,
        )
        self._schedule_next_event(primary, cj, t)

    def _requeue_gang(self, cj: ClusterJob, t: float) -> None:
        """Gang-wide failure re-queue: one member's slice died, so every
        surviving member is torn down on its device and the gang re-enters
        the queue once, priority-bumped, rolled back to its last
        coordinated checkpoint — members advance in lockstep, so a partial
        gang can make no progress."""
        for dname in dict.fromkeys(cj.member_devices):
            d = self.devices[dname]
            self._accrue_busy(d, t)
            self._update_progress(d, t)
        for rank, dname in enumerate(cj.member_devices):
            d = self.devices[dname]
            d.running.pop(cj.name, None)
            d.assignments.pop(member_name(cj.name, rank), None)
            if self.trace is not None:
                self._tr_release_occ(dname, member_name(cj.name, rank), t)
        if self.trace is not None:
            self._tr_close_phase(cj, t)
        cj.member_devices = ()
        cj.rollback_to_checkpoint()
        cj.token += 1
        if cj.pending_event is not None:
            self.events.tombstone(cj.pending_event)
            cj.pending_event = None
        cj.device = None
        cj.spec = dataclasses.replace(
            cj.spec, priority=cj.spec.priority + REQUEUE_PRIORITY_BUMP
        )
        cj.gang_requeues += 1
        self._capacity_epoch += 1
        self._enqueue(cj.name, cj, t)

    # -- gang starvation bound (reserve-or-release) ----------------------------

    def _gang_note_blocked(self, cj: ClusterJob, t: float) -> None:
        """A gang just failed a placement pass: start the starvation-bound
        clock (once). Holders of the reservation simply keep waiting for
        their reserved devices to drain — the heartbeat re-check is driven
        by the GANG_RESERVE event itself."""
        if self.trace is not None:
            self.trace.instant(
                "scheduler",
                "gang_blocked",
                t,
                args={"gang": cj.name, "world_size": cj.world_size},
            )
        if not cj.gang_reserve_pending and self.queue.reserved_by != cj.name:
            self._push_gang_reserve(cj, t)

    def _push_gang_reserve(self, cj: ClusterJob, t: float) -> None:
        if cj.gang_reserve_pending:
            return
        cj.gang_reserve_pending = True
        self.events.push(
            t + self.gang_reserve_after_s, EventKind.GANG_RESERVE, (cj.name,)
        )

    def _on_gang_reserve(self, name: str, t: float) -> None:
        """The starvation bound elapsed for a queued gang: grant it the
        admission queue's (exclusive) device reservation so backfilling
        singletons stop refilling the capacity it needs, then re-drain.
        Re-fires as a heartbeat while the gang waits — re-checking (and
        widening) the reserved set against failures, and rejecting the
        gang outright if the fleet can no longer host it at all."""
        cj = self.jobs.get(name)
        if cj is None:
            return
        cj.gang_reserve_pending = False
        if name not in self.queue or cj.device is not None:
            return  # stale: the gang placed (or was rejected) while waiting
        if self.queue.reserved_by not in (None, name):
            # another gang holds the claim (it was blocked first); retry
            # after its reservation resolves
            self._push_gang_reserve(cj, t)
            return
        devices = self._gang_reservation_set(cj)
        if devices is None:
            self._reject_queued_gang(
                cj,
                "gang capacity lost: surviving MIG devices cannot host "
                f"{cj.world_size} members even when empty",
                t,
            )
            return
        self.queue.reserve(name, devices)
        self._capacity_epoch += 1
        self._push_gang_reserve(cj, t)  # heartbeat until placed/rejected
        self._dispatch(t)

    def _reject_queued_gang(self, cj: ClusterJob, reason: str, t: float) -> None:
        self.queue.remove(cj.name)  # releases any reservation it held
        cj.rejected_reason = reason
        self.rejected.append((cj.name, reason))
        if self.trace is not None:
            self.trace.instant(
                "scheduler", "gang_reject", t, args={"gang": cj.name, "reason": reason}
            )
        self._capacity_epoch += 1  # a released reservation re-opens devices
        self._dispatch(t)

    def _gang_member_capacity(
        self, dev: DeviceState, members: List[Workload], mdemand, *, blocked
    ) -> int:
        """How many gang members an *empty* tree of this device could host
        (its running jobs drain; ``blocked`` carries the failed units)."""
        if dev.mode != CollocationMode.MIG:
            return 0
        snapshot = dict(dev.scheduler._predicted)
        try:
            sched = dev.scheduler.schedule(
                members,
                blocked_units=frozenset(blocked),
                mode=CollocationMode.MIG,
                active_phases={m.name: mdemand for m in members},
            )
            return len(sched.assignments)
        finally:
            dev.scheduler._predicted = snapshot

    def _gang_reservation_set(self, cj: ClusterJob) -> Optional[List[str]]:
        """The concrete device set reserved for a starved gang: the fewest
        devices (capacity-descending, fleet order on ties) whose empty
        trees — minus currently failed units — cover ``world_size``
        members. None when the surviving fleet cannot cover the gang."""
        members = self._member_specs(cj)
        mdemand = member_demand(cj.spec, cj.active_demand())
        caps = [
            (
                self._gang_member_capacity(
                    dev, members, mdemand, blocked=dev.failed_units
                ),
                i,
                dev.name,
            )
            for i, dev in enumerate(self.devices.values())
        ]
        caps.sort(key=lambda c: (-c[0], c[1]))
        chosen: List[str] = []
        left = cj.world_size
        for cap, _, dname in caps:
            if left <= 0:
                break
            if cap <= 0:
                break  # sorted: nothing useful follows
            chosen.append(dname)
            left -= cap
        return chosen if left <= 0 else None

    def _gang_unplaceable(self, cj: ClusterJob) -> Optional[str]:
        """Arrival-time gang rejection: the fleet's *pristine* MIG trees
        (no failed units — the repair path may heal) must be able to host
        every member at once. Shared-only fleets reject gangs outright —
        members need slice isolation. Memoized per (SKU composition is
        fixed) gang shape under the incremental engine, mirroring
        _definitely_unplaceable."""
        spec = cj.spec
        key = (
            spec.arch,
            spec.suite.name,
            getattr(spec, "min_profile", None),
            peak_demand_multiplier(spec),
            cj.world_size,
        )
        if self.retime == "incremental" and key in self._gang_capacity_cache:
            total = self._gang_capacity_cache[key]
        else:
            members = self._member_specs(cj)
            mdemand = member_demand(cj.spec, cj.active_demand())
            total = sum(
                self._gang_member_capacity(dev, members, mdemand, blocked=())
                for dev in self.devices.values()
            )
            self._gang_capacity_cache[key] = total
        if total >= cj.world_size:
            return None
        return (
            f"gang unplaceable: fleet MIG capacity {total} member slices "
            f"< world_size {cj.world_size}"
        )

    def _retime_shared(self, dev: DeviceState, t: float) -> None:
        """Re-price a shared device after a departure or a neighbour's
        phase transition (progress must already be up to date at ``t``) —
        the contention inputs are the *active phase* vectors of whatever is
        co-resident now.

        The incremental engine *invalidates* every co-resident lifecycle
        event now — exactly like the full engine's eager re-push, so a
        same-timestamp boundary event of a neighbour is absorbed into the
        re-price rather than firing — but defers the actual re-pricing
        until the same-timestamp batch closes (a run of k events at one
        instant re-prices the survivors once, not k times); the full
        engine re-runs the whole scheduling model immediately."""
        self.perf["retime_requests"] += 1
        if self.retime == "incremental":
            if self._dirty:
                if t > self._dirty_t:  # pragma: no cover - direct-call safety
                    self._flush_retimes()
                elif dev.name in self._dirty:
                    self.perf["retime_batched"] += 1
            self._dirty[dev.name] = t
            self._dirty_t = t
            for j in dev.running.values():
                j.token += 1
                if j.pending_event is not None:
                    self.events.tombstone(j.pending_event)
                    j.pending_event = None
            return
        self._retime_shared_full(dev, t)

    def _retime_shared_full(self, dev: DeviceState, t: float) -> None:
        """The reference re-pricing: re-run the full contention model."""
        sched = dev.scheduler.schedule(
            [j.spec for j in dev.running.values()],
            mode=dev.mode,
            active_phases={
                j.name: j.active_demand() for j in dev.running.values()
            },
        )
        self.perf["retime_jobs_repriced"] += len(sched.assignments)
        for a in sched.assignments:
            j = dev.running[a.job.name]
            j.step_s = a.predicted_step_s
            dev.assignments[a.job.name] = a
            self._schedule_next_event(dev, j, t)

    def _flush_retimes(self) -> None:
        """Close the deferred-re-timing batch: re-price every marked device
        at its mark time. Runs before any strictly later event is popped,
        before any placement, and before a migration look — the three
        consumers of fresh step times."""
        if not self._dirty:
            return
        marks = list(self._dirty.items())
        self._dirty.clear()
        for name, mt in marks:
            dev = self.devices[name]
            if not dev.running or dev.mode == CollocationMode.MIG:
                continue  # drained (or repartitioned) before the batch closed
            self.perf["retime_flushes"] += 1
            order = sorted(dev.running.values(), key=lambda j: -j.spec.priority)
            steps = self._shared_steps(dev, order)
            if steps is None:  # pragma: no cover - running jobs have records
                self._retime_shared_full(dev, mt)
                continue
            self._apply_shared_steps(dev, order, steps, mt)

    def _shared_steps(
        self, dev: DeviceState, order: List[ClusterJob]
    ) -> Optional[Tuple[float, ...]]:
        """Effective steps for a shared co-resident set (admission order),
        memoized per (mode, SKU, ordered (arch, shape, demand) tuples) —
        the phase-transition-schedule memo: a composition the fleet has
        priced before (the common case on a city-scale trace drawing from
        a small registry) is a dict hit, not a contention-model run."""
        key = (
            dev.mode,
            dev.sku.name,
            tuple(
                (j.spec.arch, j.spec.suite.name, j.active_demand())
                for j in order
            ),
        )
        steps = self._shared_steps_cache.get(key)
        if steps is not None:
            self.perf["shared_steps_hits"] += 1
            return steps
        terms = []
        for j in order:
            tm = dev.scheduler.solo_terms(j.spec, j.active_demand())
            if tm is None:
                return None
            terms.append(tm)
        steps = shared_effective_steps(
            dev.mode,
            terms,
            switch_overhead_frac=dev.sku.naive_switch_overhead_frac,
        )
        self.perf["shared_steps_misses"] += 1
        if len(self._shared_steps_cache) > 200_000:
            self._shared_steps_cache.clear()  # bound memory on huge traces
        self._shared_steps_cache[key] = steps
        return steps

    def _apply_shared_steps(
        self,
        dev: DeviceState,
        order: List[ClusterJob],
        steps: Tuple[float, ...],
        t: float,
    ) -> None:
        """Commit re-priced steps in admission order — the same per-job
        writes (step_s, assignment, straggler prediction, next lifecycle
        event) the full path performs, in the same order."""
        full = dev.sku.full_profile
        predicted = dev.scheduler._predicted
        for j, step in zip(order, steps):
            j.step_s = step
            a = dev.assignments.get(j.name)
            if a is None:
                dev.assignments[j.name] = Assignment(
                    j.spec, Placement(full, 0), step
                )
            else:
                a.job = j.spec
                a.predicted_step_s = step
            predicted[j.name] = step
            self._schedule_next_event(dev, j, t)
        self.perf["retime_jobs_repriced"] += len(order)

    def _schedule_next_event(self, dev: DeviceState, cj: ClusterJob, t: float) -> None:
        """Schedule the job's next lifecycle event at its current step rate:
        COMPLETION if its active phase runs to the end of the job, else the
        PHASE_TRANSITION at the phase boundary. Either way the previous
        pending event is token-invalidated AND tombstoned, so the heap
        reclaims it without waiting for its time to come up."""
        cj.token += 1
        if cj.pending_event is not None:
            self.events.tombstone(cj.pending_event)
        span = cj.current_span()
        if span.end_step >= cj.total_steps:
            finish = t + cj.remaining_steps * cj.step_s
            cj.pending_event = self.events.push(
                finish, EventKind.COMPLETION, (dev.name, cj.name, cj.token)
            )
        else:
            boundary = t + max(0.0, span.end_step - cj.steps_done) * cj.step_s
            cj.pending_event = self.events.push(
                boundary, EventKind.PHASE_TRANSITION, (dev.name, cj.name, cj.token)
            )

    # -- progress & utilization accounting ------------------------------------------

    def _update_progress(self, dev: DeviceState, t: float) -> None:
        """Advance every running job by the elapsed interval at its current
        step rate. Events fire at every phase boundary, so a segment never
        straddles two phases — the whole delta belongs to the span that was
        active at the segment's start, which is what the serve-SLO ledger
        scores latency-sensitive (decode) steps against.

        A job bound during a re-partition has ``last_update_s`` in the
        *future* (it starts stepping only when the device re-opens); a
        neighbour's event firing inside that window must not rewind it —
        progress never runs backwards, and the downtime stays unscored."""
        for j in dev.running.values():
            if t <= j.last_update_s:
                continue  # not yet stepping (bound inside a reconfig window)
            if j.step_s > 0:
                span = j.current_span()  # span at segment start
                delta = min(
                    (t - j.last_update_s) / j.step_s,
                    float(j.total_steps) - j.steps_done,
                )
                if delta > 0 and span.latency_sensitive and j.slo_step_s:
                    j.slo_steps += delta
                    if j.step_s <= j.slo_step_s:
                        j.slo_met_steps += delta
                j.steps_done = min(float(j.total_steps), j.steps_done + delta)
            j.last_update_s = t

    def _busy_fraction(self, dev: DeviceState) -> float:
        if not dev.running:
            return 0.0
        if dev.mode == CollocationMode.MIG:
            # unit-weighted occupancy — the device-level GRACT aggregation
            # of core/metrics.py with active instances counted as busy
            occupied = sum(
                dev.sku.profile(a.profile).mem_units
                for a in dev.assignments.values()
            )
            return min(1.0, occupied / dev.sku.n_units)
        if self.retime == "incremental":
            # memoized per co-resident composition: busy fraction is a pure
            # function of the (arch, shape, demand) multiset, and _accrue_busy
            # recomputes it on every event touching the device
            key = (
                dev.sku.name,
                tuple(
                    (j.spec.arch, j.spec.suite.name, j.active_demand())
                    for j in dev.running.values()
                ),
            )
            frac = self._busy_cache.get(key)
            if frac is None:
                terms = []
                for j in dev.running.values():
                    tm = dev.scheduler.solo_terms(j.spec, j.active_demand())
                    if tm is not None:
                        terms.append(tm)
                frac = busy_fraction_from_terms(terms)
                if len(self._busy_cache) > 200_000:
                    self._busy_cache.clear()
                self._busy_cache[key] = frac
            return frac
        profiles = []
        for j in dev.running.values():
            p = dev.scheduler.solo_profile(j.spec)
            if p is not None:
                profiles.append(p.scaled(j.active_demand()))
        return device_busy_fraction(profiles)

    def _accrue_busy(self, dev: DeviceState, t: float) -> None:
        """Integrate the device's busy fraction up to ``t`` — call BEFORE
        mutating the running set so the old occupancy covers the interval."""
        dt = t - dev.last_busy_update_s
        if dt > 0:
            dev.busy_integral_s += self._busy_fraction(dev) * dt
            dev.last_busy_update_s = t

    # -- per-device costs --------------------------------------------------------

    def _device_reconfig_cost(self, dev: DeviceState) -> float:
        """Downtime charged when ``dev`` re-partitions: the cluster's
        configured cost scaled by the SKU's reconfig cost relative to the
        baseline — so the operator's --reconfig-cost flag and the device
        generation's knob (an H100 re-partitions faster) compose. Exactly
        the configured cost on baseline-cost SKUs (ratio 1.0)."""
        return self.reconfig_cost_s * (
            dev.sku.reconfig_cost_s / _BASE_RECONFIG_COST_S
        )

    # -- displacement (failure / migration / straggler repack) ----------------------

    def _displace(
        self,
        dev: DeviceState,
        name: str,
        t: float,
        *,
        new_spec: Optional[JobSpec] = None,
        count_migration: bool = False,
        count_repack: bool = False,
    ) -> None:
        """Kill a running job, roll it back to its last checkpoint, and
        re-queue it (priority-bumped) — the shared tail of the failure,
        migration, and straggler-repack handlers."""
        cj = dev.running.pop(name)
        dev.assignments.pop(name, None)
        if self.trace is not None:
            self._tr_release_occ(dev.name, name, t)
            self._tr_close_phase(cj, t)
        cj.rollback_to_checkpoint()
        cj.token += 1  # invalidate the in-flight completion event
        if cj.pending_event is not None:
            self.events.tombstone(cj.pending_event)
            cj.pending_event = None
        cj.device = None
        if new_spec is not None:
            cj.spec = new_spec
        if count_migration:
            cj.migrations += 1
        if count_repack:
            cj.straggler_repacks += 1
        self._capacity_epoch += 1
        if not dev.running:
            self._dirty.pop(dev.name, None)  # nothing left to re-price
        self._enqueue(name, cj, t)

    # -- mode migration ---------------------------------------------------------

    def _maybe_migrate(self, t: float) -> None:
        if self.policy == "static":
            return
        if self._dirty and self.queue:
            # migration trials rank candidate schedules against the live
            # composition — close the re-pricing batch first (the phase
            # -transition handler reaches here without passing _dispatch)
            self._flush_retimes()
        if self.policy == "planner":
            self._maybe_replan(t)
            return
        for dev in self.devices.values():
            if not dev.available(t):
                continue
            if self.queue.is_prewarmed(dev.name):
                # warmed for the predicted ramp (forecast policy): the
                # reactive pressure loop must not flip it back for the
                # queued training the veto is deliberately starving
                continue
            if not self.queue:
                # no queue pressure: the composition has not outgrown the
                # current partitioning, so reconfiguring (and killing the
                # running jobs back to their checkpoints) cannot pay off
                continue
            if any(j.world_size > 1 for j in dev.running.values()):
                # a gang member's slice must not be re-partitioned from
                # under the gang — its siblings on other devices would
                # stall; gang capacity changes only through completion,
                # failure, or the gang's own re-queue
                continue
            # gangs are placed by the all-or-nothing gang path, never by a
            # single device's mode trial — exclude them from the pressure
            # window (a gang-only queue is no reason to flip this device)
            queued_specs = [
                e.item.spec
                for e in self.queue.ordered()[: self.migration_window]
                if e.item.world_size == 1
            ]
            if not queued_specs:
                continue
            specs = [j.spec for j in dev.running.values()] + queued_specs
            if not specs:
                continue
            if dev.running and t - dev.last_migration_s < self.migration_cooldown_s:
                continue  # empty devices may flip freely (nothing to kill)
            # running jobs are scored at their active phase (queued ones at
            # steady) — a device full of decode phases ranks differently
            # from the same archs mid-checkpoint
            active = {j.name: j.active_demand() for j in dev.running.values()}
            snapshot = dict(dev.scheduler._predicted)
            schedules: Dict[CollocationMode, Schedule] = {}
            for m in CollocationMode:
                if m == CollocationMode.MIG:
                    schedules[m] = dev.scheduler.schedule(
                        specs,
                        blocked_units=frozenset(dev.failed_units),
                        mode=m,
                        active_phases=active,
                    )
                elif dev.failed_units:
                    # a degraded device cannot run a shared mode at all
                    # (_try_place refuses it), so the trial must be empty —
                    # otherwise a failed-unit MIG device would "migrate" to
                    # MPS and then strand every job
                    schedules[m] = Schedule([], [], mode=m)
                else:
                    schedules[m] = dev.scheduler.schedule(
                        specs, mode=m, active_phases=active
                    )
            # trial schedules must not poison the straggler predictions of
            # the jobs actually deployed
            dev.scheduler._predicted = snapshot
            best = rank_modes(schedules)
            if best == dev.mode:
                continue
            cur, cand = schedules[dev.mode], schedules[best]
            better = len(cand.assignments) > len(cur.assignments) or (
                len(cand.assignments) == len(cur.assignments)
                and cand.throughput()
                >= (1 + self.migration_hysteresis) * cur.throughput()
            )
            if better:
                self._migrate(dev, best, t)
                if self.policy == "forecast":
                    self._fc_reactive += 1

    def _migrate(
        self,
        dev: DeviceState,
        new_mode: CollocationMode,
        t: float,
        *,
        kind: Optional[str] = None,
    ) -> None:
        self._accrue_busy(dev, t)
        self._update_progress(dev, t)
        cost = self._device_reconfig_cost(dev)
        requeued = []
        for name in list(dev.running):
            cj = dev.running[name]
            bumped = dataclasses.replace(
                cj.spec, priority=cj.spec.priority + REQUEUE_PRIORITY_BUMP
            )
            self._displace(dev, name, t, new_spec=bumped, count_migration=True)
            requeued.append(name)
        dev.pending_mode = new_mode
        dev.reconfiguring_until = t + cost
        self._next_reopen = min(self._next_reopen, dev.reconfiguring_until)
        self._capacity_epoch += 1  # the device closed; its jobs re-queued
        self._dirty.pop(dev.name, None)
        dev.migrations += 1
        dev.reconfig_cost_s += cost
        dev.last_migration_s = t
        event = {
            "t_s": t,
            "device": dev.name,
            "from": dev.mode.value,
            "to": new_mode.value,
            "requeued": requeued,
            "reconfig_cost_s": cost,
        }
        if kind is not None:
            # only forecast pre-warm flips tag a kind; the reactive path's
            # dict stays schema-identical to pre-forecast artifacts
            event["kind"] = kind
        self.migration_events.append(event)
        if self.trace is not None:
            self.trace.span(
                f"dev:{dev.name}",
                f"reconfig {event['from']}->{event['to']}",
                t,
                t + cost,
                cat="reconfig",
            )
            self.trace.instant(
                "scheduler",
                "migrate",
                t,
                args={
                    "device": dev.name,
                    "from": event["from"],
                    "to": event["to"],
                    "requeued": list(requeued),
                    "cost_s": cost,
                    "kind": kind or "reactive",
                },
            )
        self.events.push(t + cost, EventKind.RECONFIG_DONE, (dev.name,))

    # -- plan-driven re-partitions (planner policy) -----------------------------------

    def _maybe_replan(self, t: float) -> None:
        """Planner policy: when queued jobs cannot be placed incrementally,
        ask the partition-tree optimizer for a *from-scratch* plan over the
        running + queued mix (``preferred`` pins the running jobs' current
        instances, so eviction is a last resort) and commit it only when

          * it serves strictly more jobs than the device currently runs, and
          * the re-partition pays for itself before the device would free
            capacity naturally: downtime plus the slowest displaced job's
            redone work must undercut the earliest pending completion —
            re-partitioning a device that is about to drain anyway only
            buys back queueing delay the completion would erase for free.

        Committing is a re-partition: every running job whose planned
        instance differs from its live one is displaced through the
        standard checkpoint-rollback path, the device pays
        ``reconfig_cost_s`` downtime before the re-planned placements
        start stepping, and the event is recorded next to mode migrations
        (kind="replan"). Survivors whose instances the plan keeps run
        through the reconfiguration untouched — MIG instance create/destroy
        does not disturb neighbouring instances (F3)."""
        if not self.queue:
            return
        for dev in self.devices.values():
            if not self.queue:
                return  # drained by a replan committed on an earlier device
            if dev.mode != CollocationMode.MIG or not dev.available(t):
                continue
            if any(j.world_size > 1 for j in dev.running.values()):
                continue  # never re-partition a gang member's device
            if dev.running and t - dev.last_migration_s < self.migration_cooldown_s:
                continue
            # recomputed per device on purpose: a committed replan above
            # removed its placed jobs from the queue. Gangs are placed by
            # the all-or-nothing gang path, not a one-device replan.
            queued = [
                e.item
                for e in self.queue.ordered()[: self.migration_window]
                if e.item.world_size == 1
            ]
            specs = [j.spec for j in dev.running.values()] + [
                j.spec for j in queued
            ]
            # bring progress up to ``t`` first: the pays-off check below
            # compares rollback work and time-to-relief, and both are
            # computed from steps_done — stale values (no event since
            # placement) would understate the redo and overstate the
            # relief, approving replans whose real cost exceeds the bar
            self._accrue_busy(dev, t)
            self._update_progress(dev, t)
            active = {j.name: j.active_demand() for j in dev.running.values()}
            preferred = {
                name: a.placement for name, a in dev.assignments.items()
            }
            snapshot = dict(dev.scheduler._predicted)
            trial = dev.scheduler.schedule(
                specs,
                blocked_units=frozenset(dev.failed_units),
                mode=CollocationMode.MIG,
                active_phases=active,
                preferred=preferred,
            )
            dev.scheduler._predicted = snapshot
            if len(trial.assignments) <= len(dev.running):
                continue  # a re-partition must serve strictly more jobs
            placed_names = {a.job.name for a in trial.assignments}
            if any(name not in placed_names for name in dev.running):
                # re-partitions may shuffle running jobs to open holes, but
                # never evict one to the queue: pushing a job's completion
                # out lengthens the trace's critical path for a gain the
                # next natural completion would have delivered anyway
                continue
            if not self._replan_pays_off(dev, trial, t):
                continue
            self._commit_replan(dev, trial, t)

    def _replan_pays_off(self, dev: DeviceState, trial, t: float) -> bool:
        """Downtime + the slowest displaced job's redone work must finish
        before the device's earliest pending completion frees capacity."""
        if not dev.running:
            return True
        cost = self._device_reconfig_cost(dev)
        planned = {a.job.name: a.placement for a in trial.assignments}
        planned_step = {a.job.name: a.predicted_step_s for a in trial.assignments}
        relief_s = min(
            (
                cj.remaining_steps * cj.step_s
                for cj in dev.running.values()
                if cj.step_s > 0
            ),
            default=float("inf"),
        )
        redo_s = 0.0
        for name, cj in dev.running.items():
            if planned.get(name) == dev.assignments[name].placement:
                continue  # kept in place: no rollback
            cadence = cj.steps_per_epoch * CHECKPOINT_EVERY_EPOCHS
            lost = cj.steps_done - math.floor(cj.steps_done / cadence) * cadence
            # the lost steps are redone at the *planned* slice's rate,
            # which may be slower than the one the job is moved off
            step = max(cj.step_s, planned_step.get(name, cj.step_s))
            redo_s = max(redo_s, lost * step)
        return cost + redo_s < relief_s

    def _commit_replan(self, dev: DeviceState, trial, t: float) -> None:
        planned = {a.job.name: a.placement for a in trial.assignments}
        cost = self._device_reconfig_cost(dev)
        self._accrue_busy(dev, t)
        self._update_progress(dev, t)
        kept, displaced = [], []
        for name in list(dev.running):
            if planned.get(name) == dev.assignments[name].placement:
                planned.pop(name)  # survivor: instance untouched
                kept.append(name)
                continue
            cj = dev.running[name]
            bumped = dataclasses.replace(
                cj.spec, priority=cj.spec.priority + REQUEUE_PRIORITY_BUMP
            )
            self._displace(dev, name, t, new_spec=bumped, count_migration=True)
            displaced.append(name)
        # the device is down while it re-partitions; planned jobs are bound
        # to their instances now but only start stepping once it re-opens.
        # Score the downtime window's utilization at the *kept* occupancy
        # (survivors run through it; the new instances sit idle until the
        # device re-opens — same convention as the adaptive migrate path,
        # whose emptied device scores the window at zero).
        t_eff = t + cost
        dev.busy_integral_s += self._busy_fraction(dev) * (t_eff - t)
        dev.last_busy_update_s = t_eff
        placed = []
        for name, pl in planned.items():
            if name not in self.queue:
                continue  # displaced by the plan but left unplaced by it
            cj = self.jobs[name]
            self.queue.remove(name)
            step = dev.scheduler.predict_step(
                cj.spec, pl.profile, cj.active_demand()
            )
            self._bind(dev, cj, Assignment(cj.spec, pl, step), t_eff)
            first = cj.started_s is None
            if cj.started_s is None:
                cj.started_s = t_eff
            if self.trace is not None:
                self._tr_note_dispatch(cj, t_eff, first=first)
            placed.append(name)
        dev.reconfiguring_until = t_eff
        self._next_reopen = min(self._next_reopen, dev.reconfiguring_until)
        self._capacity_epoch += 1  # bindings + queue removals changed state
        dev.migrations += 1
        dev.reconfig_cost_s += cost
        dev.last_migration_s = t
        self.migration_events.append(
            {
                "t_s": t,
                "device": dev.name,
                "from": dev.mode.value,
                "to": dev.mode.value,
                "kind": "replan",
                "kept": sorted(kept),
                "requeued": displaced,
                "placed": sorted(placed),
                "optimality": trial.plan.optimality if trial.plan else None,
                "gap": trial.plan.gap if trial.plan else None,
                "reconfig_cost_s": cost,
            }
        )
        if self.trace is not None:
            self.trace.span(
                f"dev:{dev.name}",
                f"replan {dev.mode.value}",
                t,
                t_eff,
                cat="reconfig",
            )
            prov = (
                trial.plan.provenance()
                if trial.plan is not None
                else {
                    "layout": [],
                    "optimality": None,
                    "gap": None,
                    "configs_evaluated": 0,
                }
            )
            self.trace.instant(
                "scheduler",
                "replan",
                t,
                args={
                    "device": dev.name,
                    "kept": sorted(kept),
                    "requeued": list(displaced),
                    "placed": sorted(placed),
                    "cost_s": cost,
                    **prov,
                },
            )
        self.events.push(t_eff, EventKind.RECONFIG_DONE, (dev.name,))

    # -- forecast-driven autoscaling (forecast policy) --------------------------------
    #
    # The forecast policy is the adaptive policy's reactive machinery plus
    # a proactive loop: a FORECAST_TICK clock (fixed ``tick_s`` grid, armed
    # lazily on the first admitted arrival, re-armed while the cluster is
    # live) refreshes the arrival-rate forecast (core/forecast/estimator)
    # and re-sizes the warm set — decode-capable (MIG) devices held for the
    # predicted serve ramp by pre-warm reservations (core/queueing.py),
    # which veto training backfill without blocking serve sessions. Warming
    # a device may re-partition it (``_migrate`` with kind="prewarm") or,
    # if it is already MIG, demote its low-priority training into the
    # trough through the checkpoint-rollback displace path; either action
    # is gated by ``wave_amortizes`` — the same downtime + rollback
    # economics as the planner's pays-off bar, priced against the
    # forecast's conservative lower band instead of the realized queue.

    def _fc_observe_arrival(self, cj: ClusterJob, t: float) -> None:
        """Feed an admitted arrival into the estimator and arm the tick
        clock. Only serve arrivals move the rate — the autoscaler sizes
        decode capacity, so training arrivals are not its signal."""
        if cj.kind == "serve":
            self._fc_estimator.observe(t)
            self._fc_serve_seen += 1
            self._fc_serve_rep = cj.spec
            if self.trace is not None:
                self._tr_fc_arrivals += 1
        self._ensure_forecast_tick(t)

    def _fc_note_session(self, service_s: float) -> None:
        if service_s <= 0.0:
            return
        alpha = self.forecast_config.session_alpha
        if self._fc_session_s is None:
            self._fc_session_s = service_s
        else:
            self._fc_session_s += alpha * (service_s - self._fc_session_s)

    def _ensure_forecast_tick(self, t: float) -> None:
        if self._fc_tick_pending:
            return
        nt = next_tick(t, self.forecast_config.tick_s)
        self.events.push(nt, EventKind.FORECAST_TICK, ())
        self._fc_tick_pending = True

    def _on_forecast_tick(self, t: float) -> None:
        self._fc_tick_pending = False
        cfg = self.forecast_config
        self._fc_ticks += 1
        fc = self._fc_estimator.forecast(t, cfg.horizon_s)
        self._fc_last = fc
        if self.trace is not None:
            # realized rate over the tick window that just closed — the
            # ground truth this tick's prediction is scored against
            window = t - self._tr_fc_last_tick_s
            realized = self._tr_fc_arrivals / window if window > 0 else 0.0
            self.trace.instant(
                "scheduler",
                "forecast_tick",
                t,
                args=forecast_provenance(fc, round(realized, 9)),
            )
            self._tr_fc_arrivals = 0
            self._tr_fc_last_tick_s = t
        if fc.rate_per_s > self._fc_peak_rate:
            self._fc_peak_rate = fc.rate_per_s
        if self._fc_autoscale(t, fc):
            # reservations / modes changed: released devices may admit
            # queued training now, warmed slices may admit queued sessions
            self._dispatch(t)
        if not self.events and self.queue:
            # drain guard: nothing is in flight anywhere (running jobs
            # always hold a pending lifecycle event) yet work is queued —
            # holding warm slices now would starve it *forever*, since the
            # predicted wave, when it actually arrives, re-arms this clock
            # through its own arrivals and can re-warm then. Yield every
            # reservation and let the reactive machinery take over.
            released = False
            for dev in self.devices.values():
                if self.queue.prewarm_release(dev.name):
                    released = True
            if released:
                self._capacity_epoch += 1
                self._dispatch(t)
                self._maybe_migrate(t)  # queued work may need a mode flip
        # re-arm while the simulation is live (an empty heap here means
        # fully drained — or wedged in a way more ticks cannot fix)
        if self.events:
            self._ensure_forecast_tick(t)

    def _fc_candidate_order(self, t: float) -> List[DeviceState]:
        """Warm-set candidates in preference order: devices already
        reserved first (so the target prefix keeps them), then devices
        already decode-partitioned, then empty devices, then busy shared
        devices — ties broken by fleet order. Gang hosts are never
        candidates (their slices must not move under the gang), and an
        unreserved device that is mid-reconfiguration is not reachable."""
        ranked = []
        for dev in self.devices.values():
            if any(j.world_size > 1 for j in dev.running.values()):
                continue
            reserved = self.queue.is_prewarmed(dev.name)
            if not reserved and not dev.available(t):
                continue
            eff_mode = dev.pending_mode or dev.mode
            if reserved:
                rank = 0
            elif eff_mode == CollocationMode.MIG:
                rank = 1
            elif not dev.running:
                rank = 2
            else:
                rank = 3
            ranked.append((rank, self._dev_index[dev.name], dev))
        ranked.sort(key=lambda r: (r[0], r[1]))
        return [dev for _, _, dev in ranked]

    def _fc_serve_capacity(self, dev: DeviceState, rep) -> int:
        """How many concurrent sessions like ``rep`` the device could host
        decode-partitioned (MIG), from a trial schedule of clones on its
        empty tree — memoized per (SKU, health, shape) like the admission
        verdicts, since traces draw sessions from a handful of shapes."""
        key = (
            dev.sku.name,
            frozenset(dev.failed_units),
            rep.arch,
            rep.suite.name,
            peak_demand_multiplier(rep),
        )
        cached = self._fc_capacity_cache.get(key)
        if cached is not None:
            return cached
        probes = [
            dataclasses.replace(rep, name=f"__fc_probe_{i}")
            for i in range(max(1, dev.sku.n_units))
        ]
        snapshot = dict(dev.scheduler._predicted)
        trial = dev.scheduler.schedule(
            probes,
            blocked_units=frozenset(dev.failed_units),
            mode=CollocationMode.MIG,
        )
        dev.scheduler._predicted = snapshot
        cap = len(trial.assignments)
        self._fc_capacity_cache[key] = cap
        return cap

    def _fc_autoscale(self, t: float, fc: RateForecast) -> bool:
        """Re-size the warm set against the forecast; True if anything
        changed (reservations, modes, displaced jobs)."""
        cfg = self.forecast_config
        rep = self._fc_serve_rep
        session_s = self._fc_session_s
        if rep is None or session_s is None:
            return False  # nothing learned yet: no sessions seen/finished
        if self._dirty:
            # displacement decisions below read steps_done — price the
            # open re-timing batch first (same idiom as _maybe_migrate)
            self._flush_retimes()
        order = self._fc_candidate_order(t)
        if not order:
            return False
        caps = [float(self._fc_serve_capacity(d, rep)) for d in order]
        reserved = sum(1 for d in order if self.queue.is_prewarmed(d.name))
        decision = plan_autoscale(
            fc, session_s=session_s, device_caps=caps, reserved=reserved, cfg=cfg
        )
        changed = False
        if decision.release > 0:
            drop = decision.release
            for dev in reversed(order):  # shed from the least-preferred end
                if drop == 0:
                    break
                if self.queue.prewarm_release(dev.name):
                    self._capacity_epoch += 1  # training may place here again
                    drop -= 1
                    changed = True
        if decision.prewarm > 0:
            for dev in order[: decision.target_devices]:
                if self.queue.is_prewarmed(dev.name):
                    continue
                if self._fc_prewarm_device(
                    dev, fc, session_s, decision.target_devices, t
                ):
                    changed = True
        return changed

    def _fc_prewarm_device(
        self,
        dev: DeviceState,
        fc: RateForecast,
        session_s: float,
        share: int,
        t: float,
    ) -> bool:
        """Warm one device for the ramp: re-partition to MIG if needed
        (displacing everything through checkpoint rollback), or demote its
        low-priority training if it is already decode-capable — iff the
        forecast's conservative wave amortizes the downtime + redo."""
        cfg = self.forecast_config
        if dev.running and t - dev.last_migration_s < self.migration_cooldown_s:
            return False  # same thrash bound as the reactive path
        needs_flip = (dev.pending_mode or dev.mode) != CollocationMode.MIG
        if needs_flip:
            victims = list(dev.running)
            cost = self._device_reconfig_cost(dev)
        else:
            victims = [
                name
                for name, cj in dev.running.items()
                if cj.kind != "serve"
                and cj.spec.priority < cfg.demote_priority_below
            ]
            cost = 0.0  # MIG instance create/destroy is isolated (F3)
        if victims:
            # redo is computed from steps_done — bring progress up to t
            self._accrue_busy(dev, t)
            self._update_progress(dev, t)
        redo_s = 0.0
        for name in victims:
            cj = dev.running[name]
            cadence = cj.steps_per_epoch * CHECKPOINT_EVERY_EPOCHS
            lost = cj.steps_done - math.floor(cj.steps_done / cadence) * cadence
            redo_s = max(redo_s, lost * cj.step_s)
        if not wave_amortizes(
            fc,
            session_s=session_s,
            share_devices=share,
            cost_s=cost + redo_s,
            cfg=cfg,
        ):
            return False
        if needs_flip:
            self._migrate(dev, CollocationMode.MIG, t, kind="prewarm")
            self._fc_prewarm_flips += 1
        elif victims:
            for name in victims:
                cj = dev.running[name]
                bumped = dataclasses.replace(
                    cj.spec, priority=cj.spec.priority + REQUEUE_PRIORITY_BUMP
                )
                self._displace(dev, name, t, new_spec=bumped, count_migration=True)
                self._fc_prewarm_preempts += 1
            self.migration_events.append(
                {
                    "t_s": t,
                    "device": dev.name,
                    "from": dev.mode.value,
                    "to": dev.mode.value,
                    "kind": "prewarm_preempt",
                    "requeued": victims,
                    "reconfig_cost_s": 0.0,
                }
            )
        self.queue.prewarm(dev.name, "serve")
        self._capacity_epoch += 1  # the backfill veto changed placement options
        return True

    # -- straggler mitigation (EMA -> live repack) -----------------------------------

    def observe_step(self, job_name: str, step_s: float, at_s: Optional[float] = None) -> None:
        """Feed a measured step time into the owning device's straggler EMA
        and act on any job that drifted past tolerance: checkpoint it and
        re-queue it with a ``min_profile`` floor one profile up (the
        repack_plan suggestion made live)."""
        t = self.now if at_s is None else float(at_s)
        self.now = max(self.now, t)
        cj = self.jobs.get(job_name)
        if cj is None or cj.device is None:
            return
        if cj.world_size > 1:
            return  # gangs pace at the slowest member + comms; there is no
            # single bigger slice a straggler repack could move them to
        dev = self.devices[cj.device]
        if self.trace is not None or self.calibrator is not None:
            a = dev.assignments.get(job_name)
            profile = a.placement.profile if a is not None else dev.mode.value
            if self.trace is not None:
                self.trace.step_sample(
                    t,
                    job_name,
                    cj.spec.arch,
                    profile,
                    step_s,
                    cj.step_s,
                    source="observe",
                )
            if self.calibrator is not None:
                # MISO online refinement: fold the measured-vs-predicted
                # sample into the running residual for this (SKU, arch,
                # slice); the next predict_step on the key is corrected.
                # The residual the job's prediction carried is divided
                # back out (the scheduler recorded it at pricing time),
                # so the EWMA estimates measured-vs-base exactly.
                self.calibrator.observe(
                    sku=dev.sku.name,
                    arch=cj.spec.arch,
                    profile=profile,
                    measured_s=step_s,
                    predicted_s=cj.step_s,
                    t_s=t,
                    applied_residual=dev.scheduler.applied_residual(job_name),
                )
        dev.scheduler.observe_step(job_name, step_s)
        if dev.mode != CollocationMode.MIG:
            return  # shared modes have no bigger slice to repack onto
        sched = Schedule(list(dev.assignments.values()), [], mode=CollocationMode.MIG)
        plan = dev.scheduler.repack_plan(sched)
        acted = False
        for name, bigger in plan.items():
            if name not in dev.running:
                continue
            if not acted:
                self._accrue_busy(dev, t)
                self._update_progress(dev, t)
                acted = True
            jc = dev.running[name]
            bumped = dataclasses.replace(
                jc.spec,
                priority=jc.spec.priority + REQUEUE_PRIORITY_BUMP,
                min_profile=bigger,
            )
            if self.trace is not None:
                self.trace.instant(
                    "scheduler",
                    "straggler_repack",
                    t,
                    args={"job": name, "device": dev.name, "min_profile": bigger},
                )
            self._displace(dev, name, t, new_spec=bumped, count_repack=True)
            dev.scheduler.reset_observation(name)
            dev.straggler_repacks += 1
        if acted:
            self._dispatch(t)

    # -- reporting --------------------------------------------------------------

    def report(self) -> ClusterReport:
        if self._dirty:
            self._flush_retimes()  # report on re-priced, not stale, rates
        horizon = self.now
        if not self.events:
            # fully drained. The pre-tombstone event loop popped every
            # stale event too, advancing the clock to the latest time ever
            # scheduled — keep that horizon semantics (utilization and
            # goodput denominators) without paying for the dead pops.
            horizon = max(horizon, self.events.max_time_pushed)
            self.now = horizon
        for dev in self.devices.values():
            self._accrue_busy(dev, horizon)
        done = [self.jobs[n] for n in self.completed]
        jcts = sorted(j.jct_s for j in done)
        delays = sorted(
            j.queueing_delay_s
            for j in self.jobs.values()
            if j.queueing_delay_s is not None
        )
        arrivals = [j.arrival_s for j in self.jobs.values() if j.rejected_reason is None]
        finishes = [j.finished_s for j in done]
        makespan = (max(finishes) - min(arrivals)) if finishes and arrivals else 0.0
        util = {
            d.name: (d.busy_integral_s / horizon if horizon > 0 else 0.0)
            for d in self.devices.values()
        }
        util["mean"] = sum(util.values()) / len(self.devices)
        slo_steps = sum(j.slo_steps for j in self.jobs.values())
        slo_met = sum(j.slo_met_steps for j in self.jobs.values())
        useful_steps = sum(
            (j.slo_met_steps if j.kind == "serve" else j.steps_done)
            for j in self.jobs.values()
        )
        forecast = None
        if self.policy == "forecast":
            cfg = self.forecast_config
            forecast = {
                "estimator": cfg.estimator,
                "period_s": cfg.period_s,
                "tick_s": cfg.tick_s,
                "horizon_s": cfg.horizon_s,
                "ticks": self._fc_ticks,
                "serve_arrivals": self._fc_serve_seen,
                "session_s": (
                    self._fc_session_s if self._fc_session_s is not None else 0.0
                ),
                "peak_rate_per_s": self._fc_peak_rate,
                "prewarm_flips": self._fc_prewarm_flips,
                "prewarm_preempts": self._fc_prewarm_preempts,
                "reactive_migrations": self._fc_reactive,
                "prewarms_made": self.queue.prewarms_made,
                "prewarms_released": self.queue.prewarms_released,
            }
        return ClusterReport(
            policy=self.policy,
            n_devices=len(self.devices),
            horizon_s=horizon,
            makespan_s=makespan,
            completed=len(self.completed),
            completed_train=sum(
                1 for n in self.completed if self.jobs[n].kind == "train"
            ),
            completed_serve=sum(
                1 for n in self.completed if self.jobs[n].kind == "serve"
            ),
            rejected=len(self.rejected),
            still_queued=len(self.queue),
            still_running=sum(len(d.running) for d in self.devices.values()),
            mean_jct_s=sum(jcts) / len(jcts) if jcts else 0.0,
            p95_jct_s=_quantile(jcts, 0.95),
            mean_queueing_delay_s=sum(delays) / len(delays) if delays else 0.0,
            max_queueing_delay_s=delays[-1] if delays else 0.0,
            throughput_jobs_per_s=(
                len(self.completed) / makespan if makespan > 0 else 0.0
            ),
            slo_attainment=(slo_met / slo_steps if slo_steps > 0 else 1.0),
            goodput_steps_per_s=(useful_steps / horizon if horizon > 0 else 0.0),
            phase_transitions=sum(
                j.phase_transitions for j in self.jobs.values()
            ),
            utilization=util,
            migrations=sum(d.migrations for d in self.devices.values()),
            reconfig_cost_s=sum(d.reconfig_cost_s for d in self.devices.values()),
            lost_steps=sum(j.lost_steps for j in self.jobs.values()),
            straggler_repacks=sum(
                d.straggler_repacks for d in self.devices.values()
            ),
            hol_blocked_events=self.queue.hol_blocked_events,
            jobs=[j.to_row() for j in self.jobs.values()],
            devices=[d.to_row() for d in self.devices.values()],
            migration_events=list(self.migration_events),
            failure_events=list(self.failure_events),
            forecast=forecast,
        )
