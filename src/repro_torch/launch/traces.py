"""Seeded synthetic arrival-trace generators — the simulation's load side.

Every scenario in launch/simulate.py draws its trace from this module so
the stream machinery exists exactly once: a handful of arrival-time
processes (homogeneous Poisson, sinusoidally rate-modulated "diurnal"
Poisson, Markov-modulated bursts) composed with a handful of session
builders (phase-aware training jobs, latency-SLO inference sessions,
multi-slice gangs). The generators draw from a scenario-salted
``random.Random(f"{seed}:{scenario}")`` handed in by ``make_trace``, and
the *order* of RNG draws per arrival is part of the determinism contract:
the seed-0 artifacts are byte-pinned by tests/test_cluster.py and CI, so
refactors here must preserve each generator's exact draw sequence.

Time processes (all lazy iterators so per-arrival draws interleave with
gap draws in the original order):

  poisson_times    constant-rate exponential gaps;
  diurnal_times    each gap scaled by the instantaneous rate of a
                   sinusoidal day cycle (0.35x trough to 1.65x peak by
                   default) — equivalent to thinning without discarding
                   draws;
  mmpp_times       calm stretches punctuated by short high-rate bursts.

The ``diurnal_serve`` scenario (forecast-driven autoscaling,
docs/autoscaling.md) composes ``diurnal_times`` with the city session
builder at 10x the ``train_serve_mix`` session rate over several
synthetic days, so the seasonal estimator (core/forecast/) has completed
periods to learn from.
"""
import dataclasses
import math
import random
from typing import Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.configs.base import ShapeSuite
from repro_torch.core.gang.parallelism import Parallelism, resolve_parallelism
from repro_torch.core.instance import JobSpec
from repro_torch.core.workload import Workload, serve_workload, train_workload

# One shape suite for the whole simulation: batch 32 (the paper's §3.4
# setting), 3200 samples/epoch -> 100 steps per epoch.
SIM_SUITE = ShapeSuite("sim", 1024, 32, "train")
SIM_SAMPLES_PER_EPOCH = 3200

# The registry's serve shape: same shape-suite name as SIM_SUITE (the char
# DB is keyed by suite *name*), decode kind like configs.base.DECODE_32K.
SERVE_SUITE = ShapeSuite("sim", 1024, 32, "decode")

# Per-arch p99 step-latency SLO for inference sessions: ~15% headroom over
# the decode step on a MIG 1g.5gb slice, so an isolated slice always
# attains it while a dispatch-queue factor F_lat >= ~1.4 under shared
# collocation with saturating training neighbours misses it. The xlarge
# serve arch is budgeted against its only admissible slice — the 80GB
# generation's full profile.
SERVE_SLO_S = {"whisper-base": 1.4e-3, "granite-3-2b": 1.35e-3,
               "qwen2-72b": 9.0e-3}

_MIX = (  # mixed_dynamic draw weights
    ("resnet_small", 0.35),
    ("whisper-base", 0.20),
    ("resnet_medium", 0.20),
    ("llama3-8b", 0.10),
    ("resnet_large", 0.15),
)

# train_serve_mix: phase-aware training jobs (warmup/steady/checkpoint) are
# drawn from the saturating archs — their steady compute demand is what
# loads the MPS dispatch queue — while inference sessions (prefill/decode,
# latency-sensitive) are drawn from the small archs whose decode working
# set tiles MIG's 1g.5gb slices.
_TRAIN_MIX = (
    ("llama3-8b", 0.40),
    ("resnet_medium", 0.30),
    ("resnet_large", 0.15),
    ("resnet_small", 0.15),
)
_SERVE_MIX = (("whisper-base", 0.55), ("granite-3-2b", 0.45))

# The city session mixes: archs every fleet mode admits on every
# registered SKU, so the city generators double as ordinary (small)
# scenario cells and as the 10^5-arrival scoreboard traces.
_CITY_SERVE_MIX = (("whisper-base", 0.60), ("granite-3-2b", 0.40))
_CITY_TRAIN_MIX = (
    ("resnet_small", 0.45),
    ("llama3-8b", 0.30),
    ("resnet_medium", 0.25),
)

TraceItem = Tuple[float, Union[JobSpec, Workload], int]  # (arrival_s, spec, epochs)


def weighted(rng: random.Random, mix) -> str:
    """One weighted draw from a ((name, weight), ...) mix — exactly one
    ``rng.random()`` call, whatever the outcome."""
    x = rng.random()
    acc = 0.0
    for arch, w in mix:
        acc += w
        if x < acc:
            return arch
    return mix[-1][0]


def _pick_arch(rng: random.Random) -> str:
    return weighted(rng, _MIX)


# -- arrival-time processes --------------------------------------------------------
#
# All three are lazy iterators: each ``next()`` draws exactly the gap for
# that arrival, so a consumer that interleaves per-arrival draws (arch
# picks, epoch counts) reproduces the draw order of the original inlined
# loops byte-for-byte.


def poisson_times(
    rng: random.Random, n: int, mean_interarrival_s: float, *, start_s: float = 0.0
) -> Iterator[float]:
    """Homogeneous Poisson arrivals: ``n`` exponential gaps at a constant
    rate, accumulated from ``start_s`` (the accumulation order is part of
    the byte-stability contract — gaps sum into the running ``t``, never
    into a separate offset)."""
    t = start_s
    for _ in range(n):
        t += rng.expovariate(1.0 / mean_interarrival_s)
        yield t


def diurnal_times(
    rng: random.Random,
    n: int,
    mean_interarrival_s: float,
    *,
    amplitude: float = 0.65,
    day_s: Optional[float] = None,
) -> Iterator[float]:
    """Non-homogeneous Poisson arrivals whose rate follows a sinusoidal
    day cycle (``1 - amplitude`` in the trough to ``1 + amplitude`` at the
    peak). ``day_s`` sets the period; the default spans the whole trace
    with one synthetic day (the city_diurnal contract — a 10^5-arrival
    scoreboard run and a 60-job test cell sweep the same load shape).
    Each exponential gap is scaled by the instantaneous rate (equivalent
    to thinning, without discarding draws)."""
    t = 0.0
    if day_s is None:
        day_s = max(n, 1) * mean_interarrival_s
    for _ in range(n):
        rate_x = 1.0 + amplitude * math.sin((t / day_s) * 2.0 * math.pi)
        t += rng.expovariate(rate_x / mean_interarrival_s)
        yield t


def mmpp_times(
    rng: random.Random,
    n: int,
    *,
    calm_interarrival_s: float,
    burst_interarrival_s: float,
    max_burst: int,
    burst_prob: float = 0.08,
    min_burst: int = 5,
) -> Iterator[float]:
    """Markov-modulated Poisson arrivals: calm stretches punctuated by
    short bursts of ``min_burst..max_burst`` arrivals at the burst rate."""
    t = 0.0
    burst_left = 0
    for _ in range(n):
        if burst_left == 0 and rng.random() < burst_prob:
            burst_left = rng.randint(min_burst, max_burst)
        if burst_left > 0:
            burst_left -= 1
            t += rng.expovariate(1.0 / burst_interarrival_s)
        else:
            t += rng.expovariate(1.0 / calm_interarrival_s)
        yield t


# -- session builders --------------------------------------------------------------


def serve_session(rng: random.Random, name: str, mix=_SERVE_MIX) -> Workload:
    """A latency-SLO inference session over a weighted serve mix: a
    prefill burst plus an elastic decode tail, priority 1 so
    latency-sensitive work is dispatched ahead of batch training."""
    arch = weighted(rng, mix)
    return serve_workload(
        name,
        arch,
        SERVE_SUITE,
        slo_step_s=SERVE_SLO_S[arch],
        prefill_steps=4,
        priority=1,
    )


def train_job(rng: random.Random, name: str, mix=_TRAIN_MIX) -> Workload:
    """A phase-aware (warmup/steady/checkpoint) training job over a
    weighted training mix."""
    arch = weighted(rng, mix)
    return train_workload(name, arch, SIM_SUITE, warmup_steps=5, checkpoint_steps=3)


def _city_session(rng: random.Random, t: float, i: int, serve_frac: float,
                  prefix: str = "ct") -> TraceItem:
    """One city arrival: a latency-SLO inference session (probability
    ``serve_frac`` — city streams are serve-heavy) or a phase-aware
    training job."""
    if rng.random() < serve_frac:
        return (t, serve_session(rng, f"{prefix}{i}", _CITY_SERVE_MIX), 1)
    return (t, train_job(rng, f"{prefix}{i}", _CITY_TRAIN_MIX), 1)


# -- scenario traces ---------------------------------------------------------------


def aligned_static_trace(rng: random.Random, n_jobs: int, n_devices: int) -> List[TraceItem]:
    """Partition-aligned batch: slice-sized jobs, all submitted at t=0."""
    n = min(n_jobs, 7 * n_devices)
    return [
        (0.0, JobSpec(f"al{i}", "granite-3-2b", SIM_SUITE), 3) for i in range(n)
    ]


def mixed_dynamic_trace(
    rng: random.Random, n_jobs: int, *, mean_interarrival_s: float = 0.2
) -> List[TraceItem]:
    """Poisson arrivals over the tiny/medium/large mix."""
    trace: List[TraceItem] = []
    for i, t in enumerate(poisson_times(rng, n_jobs, mean_interarrival_s)):
        arch = _pick_arch(rng)
        prio = 2 if rng.random() < 0.10 else 0
        epochs = rng.randint(1, 3)
        trace.append((t, JobSpec(f"dy{i}", arch, SIM_SUITE, priority=prio), epochs))
    return trace


def drift_trace(rng: random.Random, n_jobs: int, n_devices: int) -> List[TraceItem]:
    """Composition drift: a partition-aligned burst, then a tiny-job flood
    — the queue mix the adaptive policy answers with a live mode migration."""
    trace: List[TraceItem] = []
    n_aligned = min(7 * n_devices, max(1, n_jobs // 2))
    for i in range(n_aligned):
        trace.append(
            (0.01 * i, JobSpec(f"ph1-{i}", "granite-3-2b", SIM_SUITE), 2)
        )
    flood = poisson_times(rng, max(0, n_jobs - n_aligned), 0.005, start_s=4.0)
    for i, t in enumerate(flood):  # near-burst: > 7 per device in flight
        arch = "resnet_small" if rng.random() < 0.7 else "whisper-base"
        trace.append((t, JobSpec(f"ph2-{i}", arch, SIM_SUITE), rng.randint(1, 2)))
    return trace


def train_serve_mix_trace(
    rng: random.Random, n_jobs: int, *, mean_interarrival_s: float = 0.05
) -> List[TraceItem]:
    """Training jobs and inference sessions interleaved on one Poisson
    stream — the mixed fleet MIGPerf measures. ~40% of arrivals are
    phase-aware training jobs over the saturating archs; the rest are
    latency-SLO inference sessions (priority 1: latency-sensitive work is
    dispatched ahead of batch training) whose 100-step session is a
    prefill burst plus an elastic decode tail."""
    trace: List[TraceItem] = []
    for i, t in enumerate(poisson_times(rng, n_jobs, mean_interarrival_s)):
        if rng.random() < 0.4:
            wl = train_job(rng, f"tr{i}")
            trace.append((t, wl, rng.randint(1, 2)))
        else:
            trace.append((t, serve_session(rng, f"sv{i}"), 1))
    return trace


def fragmentation_trace(
    rng: random.Random, n_jobs: int, n_devices: int
) -> List[TraceItem]:
    """The planner's showcase: a stream of slice-sized 1g jobs followed by
    2g-class jobs (stablelm-12b: OOMs on 1g.5gb, fits 2g.10gb). Greedy
    first-fit packs the 1g jobs at the lowest start offsets, which blocks
    all three of 2g's legal starts (units 0, 2, 4) while free units remain
    — the 2g jobs strand until the 1g cohort drains. The planner's
    flexibility tie-break parks the same 1g jobs on offsets that keep a 2g
    start open, so the 2g jobs place on arrival."""
    trace: List[TraceItem] = []
    n_small = min(5 * n_devices, max(1, (n_jobs * 2) // 3))
    for i in range(n_small):
        trace.append(
            (0.005 * i, JobSpec(f"fr-s{i}", "granite-3-2b", SIM_SUITE), 3)
        )
    big = poisson_times(rng, max(0, n_jobs - n_small), 0.03, start_s=0.08)
    for i, t in enumerate(big):
        trace.append((t, JobSpec(f"fr-b{i}", "stablelm-12b", SIM_SUITE), 1))
    return trace


def hetero_sku_trace(
    rng: random.Random, n_jobs: int, *, mean_interarrival_s: float = 0.05
) -> List[TraceItem]:
    """The mixed-generation fleet's mix on one Poisson stream: ~25%
    big-memory inference sessions (xlarge: the 80GB generation's full
    slice is the only instance in the whole fleet that admits their
    working set), plus slice-aligned 1g jobs (fit every tree), 2g-class
    jobs (fit the 40/80GB 2g slices and the A30's 2g.12gb), and tiny
    filler. The queue, not the operator, routes each job to whichever
    generation's placement tree fits it."""
    trace: List[TraceItem] = []
    for i, t in enumerate(poisson_times(rng, n_jobs, mean_interarrival_s)):
        x = rng.random()
        if x < 0.25:
            wl = serve_workload(
                f"hx{i}",
                "qwen2-72b",
                SERVE_SUITE,
                slo_step_s=SERVE_SLO_S["qwen2-72b"],
                prefill_steps=4,
                priority=1,
            )
            trace.append((t, wl, 1))
        elif x < 0.55:
            trace.append(
                (t, JobSpec(f"ha{i}", "granite-3-2b", SIM_SUITE), rng.randint(1, 2))
            )
        elif x < 0.80:
            trace.append((t, JobSpec(f"ht{i}", "stablelm-12b", SIM_SUITE), 1))
        else:
            trace.append(
                (t, JobSpec(f"hs{i}", "resnet_small", SIM_SUITE), rng.randint(1, 2))
            )
    return trace


#: The gang_pipeline headline class: a qwen2-72b-class trainer whose
#: working set fits *no* single slice in the fleet (xlarge as a train
#: job), sharded tensor=2 x pipeline=2 into four members that each fit an
#: 80GB-generation 3g/4g slice — two members per a100-80gb, so the gang
#: spans both 80GB devices all-or-nothing.
GANG_XLARGE_PARALLELISM = Parallelism(tensor=2, pipeline=2)


def _gang_train(name: str, arch: str, par: Parallelism) -> Workload:
    """A phase-aware training gang: ``train_workload``'s warmup/steady/
    checkpoint plan with the gang descriptor stamped on (the registry
    helpers build singletons; gangs are the same plan, wider)."""
    return dataclasses.replace(
        train_workload(name, arch, SIM_SUITE, warmup_steps=5, checkpoint_steps=3),
        world_size=par.world_size,
        parallelism=par,
    )


def gang_pipeline_trace(
    rng: random.Random,
    n_jobs: int,
    *,
    mean_interarrival_s: float = 0.05,
    parallelism: str = "tp2",
) -> List[TraceItem]:
    """Multi-slice gangs with singleton filler on one Poisson stream:
    ~12% qwen2-72b world_size-4 tensor+pipeline gangs (fit *only* as a
    gang — full-slice-only placement rejects them outright), ~28%
    2g-class gangs under the ``parallelism`` descriptor (fit everywhere,
    so the co-located-vs-scattered comparison is theirs to decide), and
    ~60% slice-aligned / tiny singletons that backfill around the gangs'
    reservations — the head-of-line pressure the starvation bound caps."""
    par = resolve_parallelism(parallelism)
    trace: List[TraceItem] = []
    for i, t in enumerate(poisson_times(rng, n_jobs, mean_interarrival_s)):
        x = rng.random()
        if x < 0.12:
            trace.append(
                (t, _gang_train(f"gq{i}", "qwen2-72b", GANG_XLARGE_PARALLELISM), 1)
            )
        elif x < 0.40:
            trace.append(
                (t, _gang_train(f"gs{i}", "stablelm-12b", par), rng.randint(1, 2))
            )
        elif x < 0.75:
            trace.append(
                (t, JobSpec(f"ga{i}", "granite-3-2b", SIM_SUITE), rng.randint(1, 2))
            )
        else:
            trace.append((t, JobSpec(f"gt{i}", "resnet_small", SIM_SUITE), 1))
    return trace


def city_diurnal_trace(
    rng: random.Random,
    n_jobs: int,
    *,
    mean_interarrival_s: float = 0.02,
    serve_frac: float = 0.70,
) -> List[TraceItem]:
    """Diurnal city load: a non-homogeneous Poisson stream whose rate
    follows a sinusoidal day cycle (0.35x in the trough to 1.65x at the
    peak), one synthetic day per trace regardless of ``n_jobs`` — so a
    10^5-arrival scoreboard run and a 60-job test cell sweep the same
    load shape."""
    return [
        _city_session(rng, t, i, serve_frac)
        for i, t in enumerate(diurnal_times(rng, n_jobs, mean_interarrival_s))
    ]


def city_burst_trace(
    rng: random.Random,
    n_jobs: int,
    *,
    calm_interarrival_s: float = 0.05,
    burst_interarrival_s: float = 0.004,
    max_burst: int = 12,
    serve_frac: float = 0.70,
) -> List[TraceItem]:
    """Bursty city load: a Markov-modulated Poisson stream — calm
    stretches punctuated by short bursts at ~12x the calm rate (session
    storms). The burst windows are what drive ``peak_depth`` on the
    admission queue, the scoreboard's burst-pressure column."""
    times = mmpp_times(
        rng,
        n_jobs,
        calm_interarrival_s=calm_interarrival_s,
        burst_interarrival_s=burst_interarrival_s,
        max_burst=max_burst,
    )
    return [_city_session(rng, t, i, serve_frac) for i, t in enumerate(times)]


# -- diurnal_serve: the forecast-driven autoscaling trace --------------------------

#: Session rate of the diurnal_serve stream: 10x the train_serve_mix
#: default (0.05 s mean interarrival) — the "production wave" rate the
#: ROADMAP's predictive-autoscaling item asks for.
DIURNAL_SERVE_MEAN_INTERARRIVAL_S = 0.005
#: Synthetic days per trace. Several completed periods let the seasonal
#: estimator (core/forecast/estimator.py) learn the daily profile on day
#: one and pre-warm ahead of the day-two ramp.
DIURNAL_SERVE_DAYS = 3
#: Arrivals per --steps unit: the trace densifies the session stream
#: instead of lengthening it, so ``--steps 60`` spans the same three-day
#: window at 20x the arrival count (1200 sessions).
DIURNAL_SERVE_ARRIVALS_PER_JOB = 20
#: Fraction of arrivals that are latency-SLO serve sessions.
DIURNAL_SERVE_FRAC = 0.70


def diurnal_serve_params(n_jobs: int) -> Dict[str, float]:
    """The derived shape of a diurnal_serve trace for ``n_jobs`` steps:
    arrival count and synthetic day length. launch/simulate.py uses
    ``day_s`` to configure the forecast policy's seasonal period so the
    estimator's bins line up with the trace's day cycle."""
    n = max(1, n_jobs) * DIURNAL_SERVE_ARRIVALS_PER_JOB
    day_s = n * DIURNAL_SERVE_MEAN_INTERARRIVAL_S / DIURNAL_SERVE_DAYS
    return {"n_arrivals": n, "day_s": day_s}


def diurnal_serve_trace(
    rng: random.Random,
    n_jobs: int,
    *,
    serve_frac: float = DIURNAL_SERVE_FRAC,
) -> List[TraceItem]:
    """The forecast policy's showcase: diurnal serve sessions layered
    over batch training at 10x the train_serve_mix session rate, three
    synthetic days per trace (city_diurnal's rate machinery with an
    explicit multi-day period). Day one is the seasonal estimator's
    learning period; days two and three are where ``policy="forecast"``
    pre-warms decode slices ahead of the ramp the reactive policy only
    answers after SLO misses accumulate."""
    p = diurnal_serve_params(n_jobs)
    times = diurnal_times(
        rng,
        int(p["n_arrivals"]),
        DIURNAL_SERVE_MEAN_INTERARRIVAL_S,
        day_s=p["day_s"],
    )
    return [_city_session(rng, t, i, serve_frac, prefix="ds") for i, t in enumerate(times)]


def make_trace(
    scenario: str,
    seed: int,
    n_jobs: int,
    n_devices: int,
    *,
    gang_parallelism: str = "tp2",
) -> List[TraceItem]:
    # fresh, scenario-salted RNG: identical trace for every policy
    rng = random.Random(f"{seed}:{scenario}")
    if scenario == "aligned_static":
        return aligned_static_trace(rng, n_jobs, n_devices)
    if scenario == "mixed_dynamic":
        return mixed_dynamic_trace(rng, n_jobs)
    if scenario == "drift":
        return drift_trace(rng, n_jobs, n_devices)
    if scenario == "train_serve_mix":
        return train_serve_mix_trace(rng, n_jobs)
    if scenario == "fragmentation":
        return fragmentation_trace(rng, n_jobs, n_devices)
    if scenario == "hetero_sku":
        return hetero_sku_trace(rng, n_jobs)
    if scenario == "gang_pipeline":
        return gang_pipeline_trace(rng, n_jobs, parallelism=gang_parallelism)
    if scenario == "city_diurnal":
        return city_diurnal_trace(rng, n_jobs)
    if scenario == "city_burst":
        return city_burst_trace(rng, n_jobs)
    if scenario == "diurnal_serve":
        return diurnal_serve_trace(rng, n_jobs)
    from repro_torch.launch.simulate import ALL_SCENARIOS  # registry lives with the CLI

    raise ValueError(
        f"unknown scenario {scenario!r}; choose from: {', '.join(ALL_SCENARIOS)}"
    )
