"""Trace-driven cluster simulation driver — the paper's dynamic half.

Where launch/collocate.py reproduces the paper's *static* §3.4 grid (one
batch of jobs, one device), this driver exercises the event-driven cluster
(core/cluster.py): a fleet of devices, each with its own collocation mode,
fed by a seeded synthetic arrival trace over the existing workload registry.
Every (scenario x fleet-policy) cell runs the *same* trace, so the printed
differences are pure policy effects:

  scenarios
    aligned_static   partition-aligned jobs, all at t=0 — the mix MIG is
                     built for (each job exactly fills a 1g.5gb slice and
                     its replicated working set makes shared modes admit
                     only ~half the set at once);
    mixed_dynamic    Poisson arrivals over tiny/medium/large jobs — the
                     "more dynamic mixed workloads" for which the paper
                     calls MIG's rigid partitioning sub-optimal; rigidity
                     shows up as queueing delay, not prose;
    drift            the composition drifts mid-trace (partition-aligned
                     burst, then a flood of tiny jobs) — exercises live
                     mode migration under the ``best`` policy, including
                     its checkpoint-rollback + reconfiguration charge;
    train_serve_mix  phase-aware training jobs (warmup / steady /
                     checkpoint) interleaved with Poisson inference
                     sessions (prefill / latency-SLO decode) over the
                     registry's serve shapes — the MIGPerf mixed fleet.
                     The per-fleet SLO-attainment and goodput columns show
                     inference flipping the collocation verdict: MIG's
                     isolated slices protect decode latency that MPS's
                     shared dispatch queue sacrifices to the saturating
                     training neighbours.
    fragmentation    a 1g-job stream followed by 2g-class jobs whose only
                     legal starts greedy first-fit has already blocked —
                     the placement-tree fragmentation the planner fleet
                     avoids (docs/placement.md).
    gang_pipeline    multi-slice gang jobs (core/gang/) on a mixed
                     80GB/40GB fleet: qwen2-72b-class trainers that fit
                     *no* single slice run as world_size-4 tensor+pipeline
                     gangs spanning two 80GB devices, 2g-class trainers
                     run as world_size-2 tensor gangs that co-locate on
                     one device, and singleton filler backfills around the
                     gangs' all-or-nothing reservations. Opt-in family
                     (like city_scale) — the default 30-cell grid is
                     unchanged; see docs/gang_scheduling.md.
    diurnal_serve    serve sessions arriving at 10x the train_serve_mix
                     rate, rate-modulated over three synthetic days, over
                     batch training — the forecast policy's testbed
                     (opt-in family; core/forecast/, docs/autoscaling.md).

  policies
    all-mig / all-mps / all-naive   homogeneous static fleets;
    best                            best-mode-per-device with live
                                    reconfiguration (adaptive policy);
    planner                         all-MIG hardware, placements chosen by
                                    the partition-tree optimizer
                                    (core/planner) with plan-driven
                                    re-partitions charged like migrations;
    forecast                        best's hardware + reactive machinery,
                                    plus a FORECAST_TICK loop that prices
                                    the predicted serve wave and pre-warms
                                    decode slices ahead of it.

The characterization DB is synthesized analytically from per-arch roofline
terms (busy seconds, replicated + sharded working-set fractions) over the
real MIG profile algebra (core/profiles.py, F6 compute discounts included),
so the simulation runs in milliseconds with no compilation; ``--db`` swaps
in records measured by launch/collocate.py instead.

Determinism contract: ``--seed`` fixes the trace and the cluster event loop
is reproducible, so the same seed yields a byte-identical
``artifacts/cluster/_summary.json`` (asserted by tests/test_cluster.py and
the CI smoke step).

Usage:
  python -m repro.launch.simulate [--steps 60] [--seed 0] [--devices 4]
                                  [--out artifacts/cluster]
                                  [--scenarios ...] [--policies ...]
"""
import argparse
import dataclasses
import json
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import CONFIGS
from repro_torch.core.calib.records import seed_provenance
from repro_torch.core.cluster import Cluster
from repro_torch.core.collocation import is_sku_keyed_db
from repro_torch.core.forecast import ForecastConfig
from repro_torch.core.device import DEFAULT_SKU, SKUS, DeviceSKU, format_gib, get_sku
from repro_torch.core.gang.parallelism import PARALLELISMS, resolve_parallelism
from repro_torch.core.obs import EXPORTERS, TraceRecorder

# The seeded trace generators live in launch/traces.py (one copy of the
# Poisson / diurnal / burst stream machinery); the historical public names
# are re-exported here because this module *is* the scenario registry.
from repro_torch.launch.traces import (  # noqa: F401  (re-exports)
    DIURNAL_SERVE_MEAN_INTERARRIVAL_S,
    GANG_XLARGE_PARALLELISM,
    SERVE_SLO_S,
    SERVE_SUITE,
    SIM_SAMPLES_PER_EPOCH,
    SIM_SUITE,
    TraceItem,
    aligned_static_trace,
    city_burst_trace,
    city_diurnal_trace,
    diurnal_serve_params,
    diurnal_serve_trace,
    drift_trace,
    fragmentation_trace,
    gang_pipeline_trace,
    hetero_sku_trace,
    make_trace,
    mixed_dynamic_trace,
    train_serve_mix_trace,
)
from repro_torch.core.sharing import CollocationMode
from repro_torch.core.slice_unit import HBM_PER_CHIP

# Analytic workload catalog over registry archs. Terms are full-device
# solo values: ``busy_s`` the dominant roofline term per step, ``repl``
# the per-chip working-set fraction that is replicated (params, per-chip
# activations — does not shrink with more chips), ``shard`` the fraction
# that shards away with chip count. Classes:
#   tiny     latency-dominated (GRACT << 1) — collocation's best case;
#   aligned  tiny compute but a slice-sized working set: exactly fills a
#            1g.5gb, so 7 of them tile a MIG device while shared modes can
#            only admit ~4 before aggregate HBM runs out;
#   medium   fits nothing below 3g.20gb;
#   large    full-device only (7g.40gb), saturating.
#   twog     too big for 1g.5gb, fits from 2g.10gb up — but 2g's only legal
#            starts are units {0, 2, 4}, so greedy first-fit 1g packing
#            strands it while the planner's flexibility tie-break keeps a
#            legal start open (the fragmentation scenario's pivot class).
#   xlarge   working set bigger than the whole 40GB part: its full-device
#            solo peak exceeds every a100-40gb/a30-24gb slice budget, so
#            only the 80GB generations' full slice admits it (serve
#            sessions halve the working set but still need > 16 GiB) — the
#            hetero_sku scenario's pivot class.
SIM_WORKLOADS: Dict[str, Dict] = {
    "resnet_small": {"cls": "tiny", "busy_s": 1.0e-4, "repl": 0.05, "shard": 0.005},
    "whisper-base": {"cls": "tiny", "busy_s": 1.5e-4, "repl": 0.06, "shard": 0.005},
    "granite-3-2b": {"cls": "aligned", "busy_s": 1.0e-4, "repl": 0.20, "shard": 0.005},
    "stablelm-12b": {"cls": "twog", "busy_s": 8.0e-4, "repl": 0.30, "shard": 0.10},
    "resnet_medium": {"cls": "medium", "busy_s": 4.0e-3, "repl": 0.22, "shard": 0.22},
    "llama3-8b": {"cls": "medium", "busy_s": 5.0e-3, "repl": 0.24, "shard": 0.20},
    "resnet_large": {"cls": "large", "busy_s": 2.0e-2, "repl": 0.35, "shard": 0.35},
    "qwen2-72b": {"cls": "xlarge", "busy_s": 3.0e-2, "repl": 2.60, "shard": 0.80},
}

#: The catalog's busy/footprint terms are defined on the 8-unit A100-40GB
#: baseline device; other SKUs scale by their own unit count and
#: compute_scale (synthetic_char_db).
_BASELINE_UNITS = DEFAULT_SKU.n_units

#: The mixed-generation fleet the hetero_sku scenario provisions (cycled
#: over --devices): the paper's part, its doubled-memory sibling, and the
#: 4-slice A30 — three placement trees in one cluster.
HETERO_FLEET_SKUS = ("a100-40gb", "a100-80gb", "a30-24gb")

#: The gang_pipeline fleet (cycled over --devices): the 80GB generation
#: first so a default 4-device fleet holds two a100-80gb — the only
#: devices whose 3g/4g slices admit a qwen2-72b tensor+pipeline gang
#: member, so the world_size-4 gangs *must* span both (docs/
#: gang_scheduling.md walks the memory math).
GANG_FLEET_SKUS = ("a100-80gb", "a100-40gb")

SCENARIO_HELP = {
    "aligned_static": "partition-aligned batch at t=0 — the mix MIG is built for",
    "mixed_dynamic": "Poisson arrivals over tiny/medium/large jobs (MIG rigidity)",
    "drift": "aligned burst then tiny-job flood — exercises live migration",
    "train_serve_mix": "phase-aware training + latency-SLO inference sessions",
    "fragmentation": "1g stream then 2g-class jobs — greedy first-fit strands "
                     "a slice the placement planner keeps open",
    "hetero_sku": "mixed-generation fleet (a100-40gb + a100-80gb + a30-24gb): "
                  "the queue drains each job onto whichever tree fits it; "
                  "big-memory serve jobs only fit the 80GB slices",
}
# The city_scale family is registered separately: its cells belong to the
# perf scoreboard (benchmarks/sim_perf.py runs them at 10^5+ arrivals over
# hundreds of devices) and are opt-in via --scenarios, not part of the
# default artifact grid — the 30 (scenario x policy) cells above stay the
# byte-pinned determinism surface.
CITY_SCENARIO_HELP = {
    "city_diurnal": "city-scale session stream: Poisson arrivals rate-"
                    "modulated by a diurnal cycle (serve-heavy mix) — the "
                    "scoreboard's steady-load cell (benchmarks/sim_perf.py)",
    "city_burst": "city-scale session stream: Markov-modulated Poisson "
                  "with short high-rate bursts — the queue-depth stressor "
                  "cell on the scoreboard",
}
# The gang family is opt-in for the same reason as city_scale: its cells
# carry gang-only schema keys, so keeping it out of the default grid keeps
# the 30 byte-pinned cells untouched while the equivalence suite still
# sweeps it (tests/test_retime_equivalence.py runs ALL_SCENARIOS).
GANG_SCENARIO_HELP = {
    "gang_pipeline": "multi-slice gangs (world_size 4 tensor+pipeline "
                     "qwen2-72b + world_size 2 tensor 2g-class) with "
                     "singleton filler on the 80GB/40GB gang fleet — "
                     "all-or-nothing admission, co-located beats scattered "
                     "(core/gang/, docs/gang_scheduling.md)",
}
# The forecast family is opt-in for the same reason as city_scale: the
# default 30-cell grid stays the byte-pinned determinism surface, and the
# equivalence suite sweeps this family via ALL_SCENARIOS.
FORECAST_SCENARIO_HELP = {
    "diurnal_serve": "diurnal serve sessions (10x the train_serve_mix "
                     "rate, three synthetic days) over batch training — "
                     "the forecast policy's autoscaling testbed "
                     "(core/forecast/, docs/autoscaling.md)",
}
POLICY_HELP = {
    "all-mig": "homogeneous MIG fleet, greedy first-fit placement",
    "all-mps": "homogeneous MPS fleet (spatial sharing)",
    "all-naive": "homogeneous naive time-slicing fleet",
    "best": "best-mode-per-device with live reconfiguration (adaptive)",
    "planner": "MIG fleet placed by the partition-tree optimizer "
               "(core/planner), with plan-driven re-partitions",
    "forecast": "adaptive fleet + forecast-driven autoscaling: estimates "
                "the serve arrival wave (core/forecast) and pre-warms "
                "decode slices ahead of the predicted ramp",
}
SCENARIOS = tuple(SCENARIO_HELP)
CITY_SCENARIOS = tuple(CITY_SCENARIO_HELP)
GANG_SCENARIOS = tuple(GANG_SCENARIO_HELP)
FORECAST_SCENARIOS = tuple(FORECAST_SCENARIO_HELP)
ALL_SCENARIOS = (
    SCENARIOS + CITY_SCENARIOS + GANG_SCENARIOS + FORECAST_SCENARIOS
)
POLICIES = tuple(POLICY_HELP)

#: gang placement preferences the cluster accepts (core/cluster.py) —
#: "scatter" exists so the gang report can price the counterfactual.
GANG_PLACEMENTS = ("colocate", "scatter")
#: world sizes the registered parallelism descriptors span — the legal
#: values for --gang-world-size (argparse lists these on a bad value).
GANG_WORLD_SIZES = tuple(sorted({
    resolve_parallelism(p).world_size for p in PARALLELISMS
}))


def synthetic_char_db(
    workloads: Optional[Dict[str, Dict]] = None,
    suite: ShapeSuite = SIM_SUITE,
    sku: Union[None, str, DeviceSKU] = None,
) -> Dict[Tuple[str, str, str], dict]:
    """Characterization records per (arch, suite, profile), analytically,
    over one device SKU's placement tree (default: the paper's A100-40GB —
    byte-identical records to the pre-device-model catalog).

    Mirrors what launch/collocate.py measures: per-profile step time from
    the roofline terms with the F6 compute discount, and per-chip peak
    memory from the replicated + sharded working-set split. The catalog
    terms are defined on the 8-unit baseline device, so a slice's busy
    time scales with the baseline-relative unit fraction (an A30's full
    4-unit device is half an A100 pod) divided by the SKU's generation
    speedup, and ``fits`` budgets the absolute working set against the
    SKU's own slice bytes. All archs must exist in the workload registry —
    the trace generator draws real keys.
    """
    dev = get_sku(sku)
    workloads = workloads if workloads is not None else SIM_WORKLOADS
    db: Dict[Tuple[str, str, str], dict] = {}
    for arch, w in workloads.items():
        if arch not in CONFIGS:
            raise KeyError(f"{arch!r} is not a registry arch")
        for prof in dev.profiles:
            chips_frac = prof.mem_units / _BASELINE_UNITS  # of baseline pod
            disc = dev.compute_discount(prof.name)
            compute_s = w["busy_s"] / chips_frac / disc / dev.compute_scale
            memory_s = 0.3 * compute_s
            collective_s = 0.1 * compute_s
            peak_bytes = (w["repl"] + w["shard"] / chips_frac) * HBM_PER_CHIP
            db[(arch, suite.name, prof.name)] = {
                "fits": peak_bytes <= dev.slice_bytes,
                "step_s": compute_s + dev.step_latency_s,
                "compute_s": compute_s,
                "memory_s": memory_s,
                "collective_s": collective_s,
                "peak_bytes_per_device": peak_bytes,
                # where these numbers come from (core/calib/records.py):
                # the A100-40GB terms are anchored to the paper's measured
                # device; every other generation is scaled constants. Inert
                # to the schedulers, load-bearing for calibration and the
                # report's provenance column.
                "provenance": seed_provenance(dev.name),
            }
    return db


def synthetic_sku_dbs(
    sku_names: Sequence[str],
) -> Dict[str, Dict[Tuple[str, str, str], dict]]:
    """Per-SKU characterization DBs (each speaks its own profile names) —
    the ``char_db`` shape ``Cluster`` takes for a mixed-generation fleet."""
    return {
        name: synthetic_char_db(sku=name)
        for name in dict.fromkeys(sku_names)
    }


def load_char_db(artifact_dir: Path) -> Dict[Tuple[str, str, str], dict]:
    """Build the char DB from measured launch/collocate.py artifacts."""
    db: Dict[Tuple[str, str, str], dict] = {}
    for f in sorted(Path(artifact_dir).glob("*.json")):
        if f.name.startswith("_"):
            continue
        cell = json.loads(f.read_text())
        if cell.get("mode") not in ("mig", "solo"):
            continue
        for rec in cell.get("records", []):
            db[(rec["arch"], rec["shape"], rec["profile"])] = rec
    if not db:
        raise FileNotFoundError(f"no characterization records under {artifact_dir}")
    return db


def make_fleet(
    policy: str, n_devices: int, skus: Sequence[str] = ("a100-40gb",)
) -> Tuple[List[Tuple[str, CollocationMode, str]], str]:
    """(device list, cluster policy) for a fleet-mode policy. ``skus`` is
    cycled over the devices — one name for a homogeneous-generation fleet,
    several (hetero_sku) for a mixed one."""
    def fleet(mode: CollocationMode) -> List[Tuple[str, CollocationMode, str]]:
        return [
            (f"d{i}", mode, skus[i % len(skus)]) for i in range(n_devices)
        ]

    modes = {
        "all-mig": CollocationMode.MIG,
        "all-mps": CollocationMode.MPS,
        "all-naive": CollocationMode.NAIVE,
    }
    if policy in modes:
        return fleet(modes[policy]), "static"
    if policy == "best":
        # start from the paper's single-user recommendation (MPS) and let
        # per-device best_mode re-partition live as the mix drifts
        return fleet(CollocationMode.MPS), "adaptive"
    if policy == "planner":
        # same hardware as all-mig; only the placement decisions differ —
        # the printed deltas against all-mig are pure planner effects
        return fleet(CollocationMode.MIG), "planner"
    if policy == "forecast":
        # same starting hardware as best (the trough favours shared
        # training); the printed deltas against best are pure effects of
        # the proactive pre-warm loop (core/forecast/)
        return fleet(CollocationMode.MPS), "forecast"
    raise ValueError(
        f"unknown fleet policy {policy!r}; choose from: {', '.join(POLICIES)}"
    )


# -- cell execution ----------------------------------------------------------------


def forecast_config_for(scenario: str, n_jobs: int) -> ForecastConfig:
    """Scenario-matched forecast knobs for ``policy="forecast"`` cells.

    The diurnal_serve family pins the seasonal estimator's period to the
    trace's synthetic day (launch/traces.py derives day length from the
    job count), with the tick and horizon scaled to fractions of it —
    ~40 forecasts per day, pricing an eighth of a day ahead. Every other
    scenario runs the library defaults: with no seasonal structure to
    learn the estimator stays in cold start (zero lower band), the
    amortization gate never fires, and the policy degrades gracefully to
    its reactive-adaptive core."""
    if scenario in FORECAST_SCENARIOS:
        day_s = diurnal_serve_params(n_jobs)["day_s"]
        return ForecastConfig(
            period_s=day_s,
            n_bins=16,
            tick_s=day_s / 40.0,
            horizon_s=day_s / 8.0,
        )
    return ForecastConfig()


def run_cell(
    scenario: str,
    policy: str,
    *,
    seed: int = 0,
    n_jobs: int = 60,
    n_devices: int = 4,
    reconfig_cost_s: float = 0.5,
    char_db: Optional[Dict] = None,
    sku: str = "a100-40gb",
    retime: str = "incremental",
    gang_placement: str = "colocate",
    gang_parallelism: str = "tp2",
    gang_reserve_after_s: float = 0.5,
    gang_degrade: bool = False,
    trace: Optional[TraceRecorder] = None,
) -> Dict:
    """One (scenario x policy) simulation; returns the artifact cell dict.

    ``sku`` selects the fleet's device generation (--sku); the hetero_sku
    scenario overrides it with the fixed mixed-generation fleet and
    gang_pipeline with the 80GB-first gang fleet. When ``char_db`` is
    None, per-SKU synthetic DBs are built; a flat measured DB (--db) only
    speaks one SKU's profile names, so it is rejected for any other
    fleet. ``retime`` selects the cluster's re-pricing engine (--retime):
    the incremental default or the full reference path — the two must
    produce byte-identical cells (tests/test_retime_equivalence), so the
    choice is deliberately not recorded in the artifact schema.

    The ``gang_*`` knobs only matter when the trace contains gang jobs
    (the gang_pipeline family): placement preference and starvation bound
    are forwarded to the cluster, ``gang_parallelism`` picks the 2g-class
    gangs' descriptor, and ``gang_degrade`` collapses every gang spec to
    a world_size-1 singleton — the full-slice-only baseline the gang
    report prices (benchmarks/report.py gang), under which the qwen2-72b
    class fits nothing and is rejected instead of sharded.

    ``trace`` attaches a ``TraceRecorder`` (core/obs/, --trace): the cell
    dict is byte-identical either way — tracing is purely observational —
    and the caller exports the recorder afterwards."""
    fleet_skus: Tuple[str, ...] = (
        HETERO_FLEET_SKUS if scenario == "hetero_sku"
        else GANG_FLEET_SKUS if scenario == "gang_pipeline"
        else (sku,)
    )
    for name in fleet_skus:
        get_sku(name)  # fail fast on unknown SKU names
    if char_db is None:
        db: Dict = synthetic_sku_dbs(fleet_skus)
    elif is_sku_keyed_db(char_db):
        db = char_db  # already per-SKU
    elif set(fleet_skus) != {"a100-40gb"}:
        raise ValueError(
            "a flat characterization DB (--db) speaks a100-40gb profile "
            f"names only; the {scenario!r} fleet needs SKUs "
            f"{sorted(set(fleet_skus))} — drop --db or run the default SKU"
        )
    else:
        db = char_db
    devices, cluster_policy = make_fleet(policy, n_devices, fleet_skus)
    cluster = Cluster(
        db,
        devices,
        policy=cluster_policy,
        reconfig_cost_s=reconfig_cost_s,
        migration_cooldown_s=1.0,
        retime=retime,
        gang_placement=gang_placement,
        gang_reserve_after_s=gang_reserve_after_s,
        forecast=(
            forecast_config_for(scenario, n_jobs)
            if cluster_policy == "forecast"
            else None
        ),
        trace=trace,
    )
    jobs = make_trace(
        scenario, seed, n_jobs, n_devices, gang_parallelism=gang_parallelism
    )
    if gang_degrade:
        jobs = [
            (t, dataclasses.replace(spec, world_size=1, parallelism=None)
             if getattr(spec, "world_size", 1) > 1 else spec, epochs)
            for t, spec, epochs in jobs
        ]
    for arrival_s, spec, epochs in jobs:
        cluster.submit(
            spec, arrival_s, epochs=epochs, samples_per_epoch=SIM_SAMPLES_PER_EPOCH
        )
    report = cluster.run()
    cell = {
        "scenario": scenario,
        "policy": policy,
        "seed": seed,
        "n_jobs": len(jobs),
        "n_devices": n_devices,
        "reconfig_cost_s": reconfig_cost_s,
        "status": "OK",
        "report": report.to_dict(),
    }
    # schema extension only where the hardware axis is exercised — default
    # single-SKU cells stay byte-identical to the pre-device-model artifacts
    if len(set(fleet_skus)) > 1:
        cell["fleet_skus"] = list(fleet_skus)
    elif fleet_skus[0] != "a100-40gb":
        cell["sku"] = fleet_skus[0]
    if scenario in GANG_SCENARIOS:
        cell["gang_placement"] = gang_placement
        cell["gang_parallelism"] = gang_parallelism
        if gang_degrade:
            cell["gang_degrade"] = True
    return cell


def summarize_cell(cell: Dict) -> Dict:
    r = cell["report"]
    return {
        "scenario": cell["scenario"],
        "policy": cell["policy"],
        "n_jobs": cell["n_jobs"],
        "makespan_s": r["makespan_s"],
        "mean_jct_s": r["mean_jct_s"],
        "mean_queueing_delay_s": r["mean_queueing_delay_s"],
        "max_queueing_delay_s": r["max_queueing_delay_s"],
        "utilization_mean": r["utilization"]["mean"],
        "completed": r["completed"],
        "completed_train": r.get("completed_train", r["completed"]),
        "completed_serve": r.get("completed_serve", 0),
        "rejected": r["rejected"],
        "still_queued": r["still_queued"],
        "migrations": r["migrations"],
        "reconfig_cost_s": r["reconfig_cost_s"],
        "lost_steps": r["lost_steps"],
        "slo_attainment": r.get("slo_attainment", 1.0),
        "goodput_steps_per_s": r.get("goodput_steps_per_s", 0.0),
        "phase_transitions": r.get("phase_transitions", 0),
    }


def run_all(
    *,
    seed: int = 0,
    n_jobs: int = 60,
    n_devices: int = 4,
    reconfig_cost_s: float = 0.5,
    scenarios: Sequence[str] = SCENARIOS,
    policies: Sequence[str] = POLICIES,
    char_db: Optional[Dict] = None,
    sku: str = "a100-40gb",
    retime: str = "incremental",
) -> List[Dict]:
    if char_db is None:
        # one per-SKU DB set shared by every cell (covers the selected
        # fleet SKU plus the hetero fleet's generations)
        char_db = synthetic_sku_dbs((sku,) + HETERO_FLEET_SKUS)
    return [
        run_cell(
            sc,
            po,
            seed=seed,
            n_jobs=n_jobs,
            n_devices=n_devices,
            reconfig_cost_s=reconfig_cost_s,
            char_db=char_db,
            sku=sku,
            retime=retime,
        )
        for sc in scenarios
        for po in policies
    ]


def _rounded(obj, ndigits: int = 9):
    """Recursively round floats so artifacts are byte-stable."""
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: _rounded(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_rounded(v, ndigits) for v in obj]
    return obj


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(_rounded(obj), indent=2, sort_keys=True) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__ and __doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60,
                    help="number of jobs in each generated arrival trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--out", default="artifacts/cluster")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--policies", default=",".join(POLICIES))
    ap.add_argument("--reconfig-cost", type=float, default=0.5,
                    help="device downtime charged per mode migration (s)")
    ap.add_argument("--sku", default="a100-40gb", choices=sorted(SKUS),
                    help="device generation of the fleet (core/device.py); "
                         "the hetero_sku scenario always provisions its "
                         "fixed mixed-generation fleet instead")
    ap.add_argument("--retime", default="incremental",
                    choices=("incremental", "full"),
                    help="cluster re-pricing engine: the incremental "
                         "deferred-batch path (default) or the full "
                         "reference path; both produce byte-identical "
                         "artifacts (tests/test_retime_equivalence.py)")
    ap.add_argument("--db", default=None,
                    help="load the char DB from collocate.py artifacts "
                         "instead of the synthetic catalog (a100-40gb "
                         "profile names — default SKU fleets only)")
    ap.add_argument("--gang-placement", default="colocate",
                    choices=GANG_PLACEMENTS,
                    help="gang placement preference (core/gang/placement): "
                         "pack members onto as few devices as possible "
                         "(default) or scatter them — the counterfactual "
                         "the gang report prices (benchmarks/report.py)")
    ap.add_argument("--gang-parallelism", default="tp2",
                    choices=sorted(PARALLELISMS),
                    help="parallelism descriptor for the gang_pipeline "
                         "scenario's 2g-class gangs (core/gang/"
                         "parallelism.py registry)")
    ap.add_argument("--gang-world-size", type=int, default=None,
                    choices=GANG_WORLD_SIZES,
                    help="expected world size of the 2g-class gangs; "
                         "purely a cross-check — it must equal the "
                         "--gang-parallelism descriptor's world size "
                         "(world_size is always derived, never free)")
    ap.add_argument("--trace", action="store_true",
                    help="record a deterministic scheduler trace per cell "
                         "(core/obs/) and export it next to the artifact "
                         "as _trace__<scenario>__<policy>.json (Perfetto) "
                         "and _counters__<scenario>__<policy>.json")
    ap.add_argument("--trace-exporter", default=None,
                    choices=sorted(EXPORTERS) + ["both"],
                    help="which trace export(s) --trace writes "
                         "(default: both)")
    ap.add_argument("--list", action="store_true",
                    help="print the registered scenarios, fleet policies, "
                         "and device SKUs, and exit")
    args = ap.parse_args(argv)

    if args.list:
        print("scenarios:")
        for name, desc in SCENARIO_HELP.items():
            print(f"  {name:<16} {desc}")
        print("city-scale scenarios (scoreboard family, opt-in via --scenarios):")
        for name, desc in CITY_SCENARIO_HELP.items():
            print(f"  {name:<16} {desc}")
        print("gang scenarios (multi-slice family, opt-in via --scenarios):")
        for name, desc in GANG_SCENARIO_HELP.items():
            print(f"  {name:<16} {desc}")
        print("forecast scenarios (autoscaling family, opt-in via --scenarios):")
        for name, desc in FORECAST_SCENARIO_HELP.items():
            print(f"  {name:<16} {desc}")
        print("gang parameters:")
        print(f"  placements       {', '.join(GANG_PLACEMENTS)} (--gang-placement)")
        print("  parallelisms     world_size is derived: tensor x pipeline x data")
        for pname in sorted(PARALLELISMS):
            par = resolve_parallelism(pname)
            print(f"    {pname:<14} {par.label} (world_size {par.world_size})")
        print("fleet policies:")
        for name, desc in POLICY_HELP.items():
            print(f"  {name:<16} {desc}")
        print("device SKUs:")
        for name, dev in SKUS.items():
            default = " (default)" if dev is DEFAULT_SKU else ""
            print(
                f"  {name:<16} {dev.n_units} units x "
                f"{format_gib(dev.slice_bytes)} GiB/slice, "
                f"{dev.n_compute_slices} compute slices, "
                f"{len(dev.profiles)} profiles{default}"
            )
        print("trace exporters (--trace, --trace-exporter):")
        print("  perfetto         Chrome-trace-event JSON (ui.perfetto.dev)")
        print("  counters         flat counter series + step samples")
        print("  both             write both files per cell (default)")
        return 0

    # fail fast with the registered choices listed — not a KeyError
    # traceback (or a silently FAILed artifact cell) deep in the run loop
    scenarios = [s.strip() for s in args.scenarios.split(",") if s.strip()]
    policies = [p.strip() for p in args.policies.split(",") if p.strip()]
    unknown = [s for s in scenarios if s not in ALL_SCENARIOS]
    if unknown:
        ap.error(
            f"unknown scenario(s): {', '.join(unknown)} "
            f"(choose from: {', '.join(ALL_SCENARIOS)})"
        )
    unknown = [p for p in policies if p not in POLICIES]
    if unknown:
        ap.error(
            f"unknown fleet polic(y|ies): {', '.join(unknown)} "
            f"(choose from: {', '.join(POLICIES)})"
        )
    if not scenarios or not policies:
        ap.error("need at least one scenario and one fleet policy")
    if args.gang_world_size is not None:
        par = resolve_parallelism(args.gang_parallelism)
        if args.gang_world_size != par.world_size:
            ap.error(
                f"--gang-world-size {args.gang_world_size} does not match "
                f"--gang-parallelism {args.gang_parallelism} ({par.label}, "
                f"world_size {par.world_size}); world_size is derived from "
                "the descriptor — registered choices: "
                + ", ".join(
                    f"{p}={resolve_parallelism(p).world_size}"
                    for p in sorted(PARALLELISMS)
                )
            )
    if args.db and args.sku != "a100-40gb":
        ap.error(
            "--db loads a flat measured characterization DB, which speaks "
            "a100-40gb profile names only; it cannot drive a "
            f"--sku {args.sku} fleet"
        )
    if args.trace_exporter is not None and not args.trace:
        ap.error("--trace-exporter requires --trace")
    exporter = args.trace_exporter or "both"

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    char_db = (
        load_char_db(Path(args.db))
        if args.db
        else synthetic_sku_dbs((args.sku,) + HETERO_FLEET_SKUS)
    )

    summaries: List[Dict] = []
    failures = 0
    for scenario in scenarios:
        if args.db and scenario in ("hetero_sku",) + GANG_SCENARIOS:
            # a flat measured DB cannot price a mixed-generation fleet's
            # per-SKU trees — documented skip, not a failure (the synthetic
            # catalog path still covers the scenario)
            print(
                f"[SKIP] {scenario}: --db is a flat a100-40gb DB; the "
                "mixed-generation fleet needs per-SKU records",
                flush=True,
            )
            continue
        for policy in policies:
            try:
                recorder = TraceRecorder() if args.trace else None
                cell = run_cell(
                    scenario,
                    policy,
                    seed=args.seed,
                    n_jobs=args.steps,
                    n_devices=args.devices,
                    reconfig_cost_s=args.reconfig_cost,
                    char_db=char_db,
                    sku=args.sku,
                    retime=args.retime,
                    gang_placement=args.gang_placement,
                    gang_parallelism=args.gang_parallelism,
                    trace=recorder,
                )
                _dump(out_dir / f"{scenario}__{policy}.json", cell)
                if recorder is not None:
                    # "_"-prefixed so artifact loaders that glob cell files
                    # (benchmarks/common.load_cluster) skip trace exports
                    prefixes = {"perfetto": "_trace", "counters": "_counters"}
                    for ex_name in (
                        sorted(EXPORTERS) if exporter == "both" else [exporter]
                    ):
                        _dump(
                            out_dir
                            / f"{prefixes[ex_name]}__{scenario}__{policy}.json",
                            EXPORTERS[ex_name](recorder),
                        )
                s = summarize_cell(cell)
                summaries.append(s)
                print(
                    f"[OK]   {scenario:<16} {policy:<10} jobs={s['n_jobs']:>3} "
                    f"makespan={s['makespan_s']:.2f}s jct={s['mean_jct_s']:.2f}s "
                    f"qdelay={s['mean_queueing_delay_s']:.3f}s "
                    f"util={s['utilization_mean']:.2f} migr={s['migrations']}",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001
                failures += 1
                print(f"[FAIL] {scenario} {policy}: {e}", flush=True)
                traceback.print_exc(limit=3)
    _dump(
        out_dir / "_summary.json",
        {
            "seed": args.seed,
            "steps": args.steps,
            "devices": args.devices,
            "cells": summaries,
            "failures": failures,
        },
    )
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
