"""Placement optimizer: exact search over (partition config x assignment).

The objective is lexicographic, extending the ranking the rest of the stack
already uses (``collocation.rank_modes`` scores (jobs placed, throughput)):

  1. placed weight   — sum of (1 + priority) over placed jobs: serving more
                       of the mix beats any speed win, and a high-priority
                       job is never left queued to squeeze in low-priority
                       ones (the admission-first finding F5);
  2. kept weight     — sum of (1 + priority) over jobs assigned exactly
                       their *current* instance (the ``preferred`` map).
                       Among plans serving the same weight, touch as few
                       running jobs as possible: every displaced job pays a
                       checkpoint rollback, so a re-partition plan must
                       justify each eviction with a placement it could not
                       otherwise have (zero when no preferences are given —
                       fresh placements are unaffected);
  3. flexibility     — how many placements the resulting layout still
                       admits (enumerator.flexibility): prefer the plan
                       that preserves future capacity. This is the
                       anti-fragmentation term — it steers 1g jobs off the
                       start offsets that strand the larger profiles' few
                       legal starts;
  4. compute thrift  — fewer compute slices consumed. Slice units can tie
                       on flexibility (a nearly full device admits nothing
                       either way) while the compute budget still differs:
                       a lone medium job taking 4g.20gb over 3g.20gb burns
                       an extra slice *and* arms the 4g+3g exclusion
                       against the next arrival. Spare compute, like spare
                       units, has option value in an online stream — a
                       lone job is never upgraded to a fatter slice it
                       merely prefers;
  5. goodput         — sum of SLO-constrained steps/s over placed jobs
                       (a serve job on a slice that misses its SLO counts
                       zero — the cluster's goodput currency). With the
                       capacity terms pinned, this is where MISO-style
                       slice fitting acts: among capacity-equivalent plans
                       it routes each job to the slice that serves it best
                       (e.g. the compute-bound job of a pair gets the
                       bigger slice of a fixed layout);
  6. canonical order — deterministic final tie-break (byte-stable plans).

Exact path (<= ``exact_max_jobs`` jobs): for every valid config reachable
from the live layout (enumerator.expansions) whose new slots could all be
occupied, a DP over (slot, job-subset) finds the best assignment; the best
(config, assignment) pair over the whole tree is provably optimal under
the objective — tests/test_planner.py checks it against brute force.

Beam path (larger instances): jobs in deterministic order, a beam of
partial layouts, each expanded by every feasible placement of the next job
(or leaving it unplaced), scored by the same objective. The reported
``gap`` bounds the distance to optimal: it compares the achieved (weight,
goodput) to the conflict-free upper bound where every job gets its best
slice — gap 0.0 means provably optimal even off the exact path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.device import DEFAULT_SKU, DeviceSKU, Placement
from repro_torch.core.planner.costmodel import PlanningCostModel, SliceEstimate
from repro_torch.core.planner.enumerator import (
    canonical_form,
    expansions,
    flexibility,
    free_placements,
    transition,
)
from repro_torch.core.workload import STEADY_DEMAND, DemandTrace

# smallest-first, same order the greedy scheduler widens through (the
# default SKU's; per-SKU plans read ``sku.profile_order`` instead)
PROFILE_ORDER: Tuple[str, ...] = DEFAULT_SKU.profile_order

#: Above this many candidate jobs the optimizer switches to the beam path.
EXACT_MAX_JOBS = 6

#: Beam width of the fallback search (partial layouts kept per job step).
BEAM_WIDTH = 12


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """The planner's product: a full partition layout plus job assignments.

    ``layout`` includes the live (``existing``) placements; ``assignments``
    covers only the newly planned jobs. ``optimality`` is ``"exact"`` when
    the plan came from exhaustive partition-tree search, ``"beam"``
    otherwise; ``gap`` is an upper bound on the relative (weight, goodput)
    left on the table (0.0 == provably optimal)."""

    layout: Tuple[Placement, ...]
    existing: Tuple[Placement, ...]
    assignments: Mapping[str, Placement]
    step_s: Mapping[str, float]
    unplaced: Tuple[Tuple[str, str], ...]  # (job name, reason)
    placed_weight: float
    kept_weight: float
    goodput: float
    flexibility: int
    optimality: str  # "exact" | "beam"
    gap: float
    configs_evaluated: int
    # the device generation the plan was searched over — needed so `score`
    # prices compute thrift with the right tree
    sku: DeviceSKU = DEFAULT_SKU

    @property
    def score(self) -> Tuple[float, float, int, int, float]:
        """The full lexicographic objective the optimizer ranks by —
        including the compute-thrift term, so comparing two plans via
        ``score`` agrees with the search's own ordering."""
        return (
            self.placed_weight,
            self.kept_weight,
            self.flexibility,
            -_compute_slices(self.layout, self.sku),
            self.goodput,
        )

    def transition(self) -> Tuple[Tuple[Placement, ...], ...]:
        """(kept, destroyed, created) relative to the live layout."""
        return transition(self.existing, self.layout)

    def provenance(self) -> Dict[str, object]:
        """Committed-vs-considered summary for the trace layer (core/obs/):
        the layout this plan commits, which search tier chose it, the
        optimality gap bound, and how much of the partition tree was
        evaluated — everything a ``replan`` decision instant must explain."""
        return {
            "layout": [f"{pl.profile}@{pl.start}" for pl in self.layout],
            "optimality": self.optimality,
            "gap": self.gap,
            "configs_evaluated": self.configs_evaluated,
            "placed_weight": self.placed_weight,
            "kept_weight": self.kept_weight,
            "goodput": self.goodput,
            "unplaced": [name for name, _ in self.unplaced],
        }


def _job_weight(job) -> float:
    return 1.0 + float(getattr(job, "priority", 0))


def _compute_slices(cfg: Sequence[Placement], sku: DeviceSKU = DEFAULT_SKU) -> int:
    return sum(sku.profile(pl.profile).compute_slices for pl in cfg)


def _eligible_profiles(job, sku: DeviceSKU) -> Tuple[str, ...]:
    """Profiles the job may use, honouring its straggler-repack floor (a
    floor naming another generation's profile does not bind — same
    convention as ``CollocationScheduler.smallest_admissible``)."""
    order = sku.profile_order
    floor = getattr(job, "min_profile", None)
    start = order.index(floor) if floor and floor in order else 0
    return order[start:]


def _estimates(
    jobs: Sequence,
    cost: PlanningCostModel,
    active_phases: Mapping[str, DemandTrace],
    sku: DeviceSKU,
) -> List[Dict[str, SliceEstimate]]:
    """Per job: profile -> estimate, restricted to eligible+fitting slices."""
    out = []
    for job in jobs:
        demand = active_phases.get(job.name, STEADY_DEMAND)
        ests = {}
        for prof in _eligible_profiles(job, sku):
            est = cost.estimate(job, prof, demand)
            if est.fits:
                ests[prof] = est
        out.append(ests)
    return out


def _unplaced_reason(job, cost, active_phases, sku: DeviceSKU) -> str:
    demand = active_phases.get(job.name, STEADY_DEMAND)
    reasons = [
        f"{p}: {cost.estimate(job, p, demand).reason}"
        for p in _eligible_profiles(job, sku)
        if not cost.estimate(job, p, demand).fits
    ]
    if len(reasons) == len(_eligible_profiles(job, sku)):
        return "; ".join(reasons[:2])
    return "no free placement slot in the best plan"


def _config_key(cfg: Sequence[Placement]) -> Tuple[Tuple[int, str], ...]:
    return tuple((pl.start, pl.profile) for pl in cfg)


def _kept(job, slot: Placement, preferred: Mapping[str, Placement]) -> float:
    return _job_weight(job) if preferred.get(job.name) == slot else 0.0


def plan_placements(
    jobs: Sequence,
    cost: PlanningCostModel,
    *,
    existing: Sequence[Placement] = (),
    blocked_units: FrozenSet[int] = frozenset(),
    active_phases: Optional[Mapping[str, DemandTrace]] = None,
    preferred: Optional[Mapping[str, Placement]] = None,
    partitioned: bool = True,
    exact_max_jobs: int = EXACT_MAX_JOBS,
    beam_width: int = BEAM_WIDTH,
) -> PlacementPlan:
    """Plan placements for ``jobs`` on top of a live layout.

    Running jobs keep their instances (``existing`` placements are fixed);
    the plan only creates new ones. A from-scratch re-partition plan is
    ``existing=()`` with ``preferred`` mapping each running job to its
    current instance — the kept-weight term then makes eviction a last
    resort, and the *caller* (core/cluster.py) is responsible for charging
    the displaced jobs' rollback and the device downtime when it commits
    such a plan.

    The partition tree searched is the cost model's device generation
    (``cost.sku``) — heterogeneous fleets plan each device over its own
    tree."""
    active_phases = active_phases or {}
    preferred = preferred or {}
    jobs = list(jobs)
    blocked_units = frozenset(blocked_units)
    sku = cost.sku
    existing_cfg = canonical_form(existing)
    ests = _estimates(jobs, cost, active_phases, sku)

    if len(jobs) <= exact_max_jobs:
        best = _plan_exact(
            jobs, ests, existing_cfg, blocked_units, partitioned, preferred,
            sku,
        )
        optimality, gap = "exact", 0.0
        configs_evaluated = best.pop("configs_evaluated")
    else:
        best = _plan_beam(
            jobs, ests, existing_cfg, blocked_units, partitioned, preferred,
            beam_width, sku,
        )
        configs_evaluated = best.pop("configs_evaluated")
        optimality = "beam"
        # conflict-free upper bound: every job on its own best slice
        ub_w = sum(_job_weight(j) for j, e in zip(jobs, ests) if e)
        ub_g = sum(
            max(e.goodput for e in je.values()) for je in ests if je
        )
        gap = 0.0
        if ub_w > best["weight"] and ub_w > 0:
            gap = max(gap, (ub_w - best["weight"]) / ub_w)
        if ub_g > best["goodput"] and ub_g > 0:
            gap = max(gap, (ub_g - best["goodput"]) / ub_g)

    assignments: Dict[str, Placement] = best["assignments"]
    step_s = {name: best["steps"][name] for name in assignments}
    unplaced = tuple(
        (j.name, _unplaced_reason(j, cost, active_phases, sku))
        for j in jobs
        if j.name not in assignments
    )
    layout = canonical_form(list(existing_cfg) + list(assignments.values()))
    return PlacementPlan(
        layout=layout,
        existing=existing_cfg,
        assignments=assignments,
        step_s=step_s,
        unplaced=unplaced,
        placed_weight=best["weight"],
        kept_weight=best["kept"],
        goodput=best["goodput"],
        flexibility=flexibility(
            layout, blocked_units=blocked_units, partitioned=partitioned,
            sku=sku,
        ),
        optimality=optimality,
        gap=gap,
        configs_evaluated=configs_evaluated,
        sku=sku,
    )


def _plan_exact(
    jobs, ests, existing_cfg, blocked_units, partitioned, preferred, sku
) -> Dict:
    """Exhaustive (config x assignment) search, optimal under the model."""
    existing_set = set(existing_cfg)
    best_state: Dict = {
        "assignments": {},
        "steps": {},
        "weight": 0.0,
        "kept": 0.0,
        "goodput": 0.0,
    }
    best_score = (-1.0, -1.0, -1, 1 << 10, -1.0)
    best_key: Optional[Tuple] = None
    n = len(jobs)
    configs = expansions(
        existing_cfg, blocked_units=blocked_units, partitioned=partitioned,
        sku=sku,
    )
    for cfg in configs:
        slots = [pl for pl in cfg if pl not in existing_set]
        if len(slots) > n:
            continue
        # DP over slots: every slot must take a distinct job (layouts with
        # unused slots are enumerated separately as smaller configs).
        # Within a config, flexibility and compute cost are constants, so
        # the DP maximizes the remaining objective (weight, kept, goodput).
        dp: Dict[int, Tuple[float, float, float]] = {0: (0.0, 0.0, 0.0)}
        parents: List[Dict[int, Tuple[int, int]]] = []
        feasible = True
        for slot in slots:
            ndp: Dict[int, Tuple[float, float, float]] = {}
            parent: Dict[int, Tuple[int, int]] = {}
            for mask, (w, k, g) in dp.items():
                for ji in range(n):
                    if mask & (1 << ji):
                        continue
                    est = ests[ji].get(slot.profile)
                    if est is None:
                        continue
                    nm = mask | (1 << ji)
                    val = (
                        w + _job_weight(jobs[ji]),
                        k + _kept(jobs[ji], slot, preferred),
                        g + est.goodput,
                    )
                    if nm not in ndp or val > ndp[nm]:
                        ndp[nm] = val
                        parent[nm] = (mask, ji)
            if not ndp:
                feasible = False
                break
            dp = ndp
            parents.append(parent)
        if not feasible:
            continue
        mask, (w, k, g) = max(dp.items(), key=lambda kv: (kv[1], -kv[0]))
        flex = flexibility(
            cfg, blocked_units=blocked_units, partitioned=partitioned, sku=sku
        )
        score = (w, k, flex, -_compute_slices(cfg, sku), g)
        key = _config_key(cfg)
        if score > best_score or (
            score == best_score and (best_key is None or key < best_key)
        ):
            # reconstruct the winning assignment
            assignments: Dict[str, Placement] = {}
            steps: Dict[str, float] = {}
            m = mask
            for si in range(len(slots) - 1, -1, -1):
                pm, ji = parents[si][m]
                job = jobs[ji]
                assignments[job.name] = slots[si]
                steps[job.name] = ests[ji][slots[si].profile].step_s
                m = pm
            best_score, best_key = score, key
            best_state = {
                "assignments": assignments,
                "steps": steps,
                "weight": w,
                "kept": k,
                "goodput": g,
            }
    best_state["configs_evaluated"] = len(configs)
    return best_state


def _plan_beam(
    jobs, ests, existing_cfg, blocked_units, partitioned, preferred,
    beam_width, sku
) -> Dict:
    """Beam search over partial layouts; same objective, bounded width."""
    order = sorted(
        range(len(jobs)),
        key=lambda i: (
            -_job_weight(jobs[i]),
            -max((e.goodput for e in ests[i].values()), default=0.0),
            jobs[i].name,
        ),
    )
    # state: (layout, assignments, steps, weight, kept, goodput)
    State = Tuple[
        Tuple[Placement, ...], Dict[str, Placement], Dict[str, float],
        float, float, float,
    ]
    states: List[State] = [(existing_cfg, {}, {}, 0.0, 0.0, 0.0)]
    expanded = 0

    def assign_key(assign: Dict[str, Placement]) -> Tuple:
        return tuple(
            sorted((n, pl.start, pl.profile) for n, pl in assign.items())
        )

    for i in order:
        job, je = jobs[i], ests[i]
        nxt: Dict[Tuple, State] = {}

        def consider(st: State) -> None:
            key = (_config_key(st[0]), assign_key(st[1]))
            if key not in nxt:
                nxt[key] = st

        for layout, assign, steps, w, k, g in states:
            consider((layout, assign, steps, w, k, g))  # leave job unplaced
            for pl in free_placements(
                layout, blocked_units=blocked_units, partitioned=partitioned,
                sku=sku,
            ):
                est = je.get(pl.profile)
                if est is None:
                    continue
                expanded += 1
                consider(
                    (
                        canonical_form(list(layout) + [pl]),
                        {**assign, job.name: pl},
                        {**steps, job.name: est.step_s},
                        w + _job_weight(job),
                        k + _kept(job, pl, preferred),
                        g + est.goodput,
                    )
                )
        states = sorted(
            nxt.values(),
            key=lambda st: (
                -st[3],
                -st[4],
                -flexibility(
                    st[0], blocked_units=blocked_units, partitioned=partitioned,
                    sku=sku,
                ),
                _compute_slices(st[0], sku),
                -st[5],
                _config_key(st[0]),
                assign_key(st[1]),
            ),
        )[:beam_width]
    layout, assign, steps, w, k, g = states[0]
    return {
        "assignments": assign,
        "steps": steps,
        "weight": w,
        "kept": k,
        "goodput": g,
        "configs_evaluated": expanded,
    }
