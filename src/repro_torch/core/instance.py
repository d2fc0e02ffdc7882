"""Instance runtime: one MIG-instance analogue bound to a training job
(PyTorch twin of ``repro.core.instance``).

``JobSpec``, ``InstanceRecord`` and ``compute_discount`` are the reference's.
``InstanceRuntime`` is rewritten for one CUDA card: the reference lowers the
job's step on the instance's sub-mesh and prices the compiled program; the
port runs the job's real step (``launch/lowering.py::build_cell``: the train
step with ``job.grad_accum`` microbatches, the prefill, or one decode step)
and measures it, once per (arch, suite, grad_accum), in ``measure_job``:

  * ``step_s``: the median of ``TIMED_STEPS`` steps after ``WARMUP_STEPS``,
    by CUDA events (by the host clock on the CPU). A step of g microbatches
    counts as g steps toward both: ceil(WARMUP_STEPS / g) whole steps warm
    up and ceil(TIMED_STEPS / g) are timed, at least one each;
  * ``peak_bytes_per_device``: ``torch.cuda.max_memory_allocated`` over the
    timed steps, its counter reset after the warm-up, less what the process
    held before the job was built (not measured on the CPU, where it is 0).
    The warm-up is left out because cuDNN's autotuner tries its algorithms
    there, in workspaces sized to the memory that is free, and only in a
    process that has not tuned these shapes yet: with it in, the peak would
    depend on what the process ran before;
  * FLOPs, bytes, collectives and the fingerprint of one more whole step,
    traced (``telemetry/counts.py``; on the card each launch of a
    hand-written kernel is an entry of its own, with the FLOPs of its
    products); the bytes by the reference's fused traffic model
    (``telemetry/hlo.py``), as the reference's record reads
    ``hlo_flops_bytes``;
  * the step's output is finite: the loss of a train step, the logits of a
    prefill or decode step.

A record of the whole card (``partitioned=False``, the "non-MIG" solo) carries
the measured step. A MIG instance cannot be carved without root and
``nvidia-smi -mig``, so a MIG record's step is the reference's algebra over
the measured counts, ``max(compute_s / compute_discount, memory_s,
collective_s)`` with the instance owning ``mem_units / n_units`` of the
card's compute and bandwidth, plus the job's latency: the measured step less
the whole card's roofline (host dispatch, launches, kernels below their
roofs), which the reference's roofline steps do not have and the port's
measured ones do. The shared cells split the solo step the same way
(``launch/collocate.py``), so every step of a characterization is of one
kind. Its peak is the measured one and its budget the instance's share of
the card's memory (``core/partitioner.py``). The DCGM analogues divide by
the record's step. ``measured_fields`` names the record fields that came
from the device.

The compute:memory slice asymmetry (3g.40gb = 3/7 compute, 4/8 memory, plus
the reserved 8th compute slice MIG keeps for itself) is the reference's
``compute_discount = min(1, compute_slices/mem_units)``.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ShapeSuite
from repro_torch.telemetry import constants as C
from repro_torch.telemetry import roofline as rl

if TYPE_CHECKING:
    from repro_torch.core.gang.parallelism import Parallelism
    from repro_torch.core.partitioner import InstanceDevice

WARMUP_STEPS = 3
TIMED_STEPS = 10


def compute_discount(
    profile: str, *, partitioned: bool = True, sku=None
) -> float:
    """F6 analytically — delegates to the device model (core/device.py);
    ``sku=None`` keeps the old A100-40GB module-global behaviour."""
    from repro_torch.core.device import get_sku

    return get_sku(sku).compute_discount(profile, partitioned=partitioned)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training/serving job the scheduler may place on an instance."""

    name: str  # unique job id ("hparam-3", "resnet_small#0")
    arch: str  # registry key (resnet_small, llama3-8b, ...)
    suite: ShapeSuite
    steps: int = 100
    grad_accum: int = 1
    priority: int = 0  # higher preempts lower on elastic repack
    # floor on the MIG profile the scheduler may pick — set by the straggler
    # repack path so a re-queued straggler lands on a larger slice
    min_profile: Optional[str] = None
    # gang scheduling (core/gang/): > 1 makes this a gang of cooperating
    # members, each needing its own MIG slice, admitted all-or-nothing
    world_size: int = 1
    # how the gang splits its work (tensor/pipeline/data); None = plain
    # data parallelism over world_size (core/gang/parallelism.py)
    parallelism: Optional["Parallelism"] = None
    # gang this spec is a *member* of — set only on the per-rank specs the
    # cluster binds to slices, so elastic.split_by_failure can map a hit
    # member back to its gang; user-submitted jobs leave it None
    gang: Optional[str] = None

    def __post_init__(self):
        if self.world_size < 1:
            raise ValueError(
                f"job {self.name!r}: world_size must be >= 1, "
                f"got {self.world_size}"
            )
        if self.parallelism is not None and (
            self.parallelism.world_size != self.world_size
        ):
            raise ValueError(
                f"job {self.name!r}: parallelism {self.parallelism.label} "
                f"implies world_size {self.parallelism.world_size}, "
                f"declared {self.world_size}"
            )


@dataclasses.dataclass
class InstanceRecord:
    """Characterization of one job on one instance — a paper table row."""

    job: str
    arch: str
    shape: str
    profile: str
    start: int
    chips: int
    hbm_budget_bytes: int
    peak_bytes_per_device: float
    fits: bool
    step_s: float
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    mfu: float
    dcgm: Dict[str, float]
    device_ids: Tuple[int, ...] = ()
    hlo_fingerprint: str = ""
    # collocation mode the record was characterized under: "mig" (partitioned
    # instance), "solo" (full non-partitioned device), or a shared mode
    # ("naive"/"mps") for analytically-derived effective records.
    mode: str = "mig"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class JobMeasurement:
    """One job's step as it ran on one device; every cell that places the
    job reuses it (the program is the same on every instance)."""

    step_s: float  # median of the timed steps
    peak_bytes: float  # 0.0 where not measured (the CPU)
    flops: float  # the op counters over one traced step
    bytes: float  # telemetry/hlo.py's traffic model over the same step
    fingerprint: str
    collectives: Dict
    peak_flops: float  # the card's peak for the type the products compute in
    model_flops: float
    measured: Tuple[str, ...]  # fields of a whole-card record this measured
    #: the hand-written kernels' entries in the counted step: name ->
    #: (launches, FLOPs); none off the card, where their plain versions run
    kernels: Dict[str, Tuple[int, float]] = dataclasses.field(default_factory=dict)


def measure_job(job: JobSpec, cfg, device: torch.device) -> JobMeasurement:
    """Build ``job``'s step from the model config ``cfg`` on ``device`` and
    measure it (module docstring)."""
    from repro_torch.launch.lowering import active_params, build_cell
    from repro_torch.launch.train import cudnn_flags
    from repro_torch.telemetry.counts import count_step

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device)
    g = job.grad_accum
    warmup, timed = max(1, math.ceil(WARMUP_STEPS / g)), max(1, math.ceil(TIMED_STEPS / g))
    model, state, batch, step = build_cell(cfg, job.suite, device, grad_accum=g)
    times = []
    with cudnn_flags():
        for i in range(warmup + timed):
            if on_card and i == warmup:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            if on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, out = step(state, batch)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                state, out = step(state, batch)
                seconds = time.perf_counter() - t0
            if i >= warmup:
                times.append(seconds)
        what = "loss" if job.suite.kind == "train" else "logits"
        finite = bool(torch.isfinite(out[what]).all())
        peak = float(torch.cuda.max_memory_allocated(device) - held) if on_card else 0.0
        _, counts = count_step(lambda: step(state, batch), inputs=(state, batch))
    if not finite:
        raise FloatingPointError(f"{job.name}: {what} not finite after {warmup + timed} steps")
    del state, batch, out
    if on_card:
        torch.cuda.empty_cache()
    return JobMeasurement(
        step_s=statistics.median(times),
        peak_bytes=peak,
        flops=counts.flops,
        bytes=counts.hbm_bytes,
        fingerprint=counts.fingerprint,
        collectives=counts.collectives,
        peak_flops=C.PEAK_FLOPS[counts.product_dtype],
        model_flops=rl.model_flops(cfg, job.suite, active_params(cfg, model.param_count())),
        measured=("step_s", "peak_bytes_per_device", "hlo_fingerprint") if on_card
        else ("step_s", "hlo_fingerprint"),
        kernels=counts.kernels,
    )


class InstanceRuntime:
    """An instance of the card plus the machinery to characterize jobs on it.

    ``measurements`` maps (arch, suite, grad_accum) to the job's
    ``JobMeasurement``; pass one dict to every runtime of a characterization
    so that each job is measured once.
    """

    def __init__(
        self,
        inst: InstanceDevice,
        *,
        partitioned: bool = True,
        sku=None,
        measurements: Optional[Dict[Tuple[str, ShapeSuite, int], JobMeasurement]] = None,
    ):
        from repro_torch.core.device import get_sku

        self.inst = inst
        self.sku = get_sku(sku)
        self.hbm_budget = inst.hbm_budget_bytes
        self.partitioned = partitioned
        self.measurements = {} if measurements is None else measurements

    @property
    def profile(self) -> str:
        return self.inst.profile

    @property
    def label(self) -> str:
        return self.inst.label

    def device_ids(self) -> Tuple[int, ...]:
        """The memory units the instance owns."""
        return tuple(range(*self.inst.units))

    def measure(self, job: JobSpec) -> JobMeasurement:
        """The job's measurement, made at the registry's config of
        ``job.arch`` unless ``measurements`` already holds it."""
        from repro_torch.configs.registry import get_config

        key = (job.arch, job.suite, job.grad_accum)
        if key not in self.measurements:
            self.measurements[key] = measure_job(job, get_config(job.arch), self.inst.device)
        return self.measurements[key]

    def measured_fields(self, job: JobSpec) -> Tuple[str, ...]:
        """The fields of this runtime's record of ``job`` that came from the
        device: a MIG record's step is reckoned, and its budget is a share of
        the card's memory; its ``fits`` holds the measured peak to that budget."""
        m = self.measure(job)
        fields = [f for f in m.measured if not self.partitioned or f != "step_s"]
        if "peak_bytes_per_device" in fields:
            fields += ["fits"] if self.partitioned else ["hbm_budget_bytes", "fits"]
        return tuple(fields)

    # -- characterization ---------------------------------------------------

    def characterize(self, job: JobSpec) -> InstanceRecord:
        """Measure ``job`` (once) and derive the paper row for this instance;
        a train, prefill or decode job, as the reference's takes any."""
        m = self.measure(job)
        share = self.sku.profile(self.profile).mem_units / self.sku.n_units
        report = rl.RooflineReport(
            arch=job.arch,
            shape=job.suite.name,
            mesh=self.label,
            chips=1,
            flops_per_device=m.flops,
            hbm_bytes_per_device=m.bytes,
            wire_bytes_per_device=float(m.collectives["per_device_wire_bytes"]),
            model_flops_global=m.model_flops,
            peak_mem_bytes_per_device=m.peak_bytes,
            collective_detail=m.collectives,
            peak_flops=m.peak_flops,
        )
        disc = compute_discount(
            self.profile, partitioned=self.partitioned, sku=self.sku
        )
        # the instance's share of the card's compute and bandwidth; asymmetric
        # profiles' compute discounted (see module docstring)
        terms = {
            "compute": report.compute_s / share / disc,
            "memory": report.memory_s / share,
            "collective": report.collective_s,
        }
        # the measured step less the whole card's busy time (module docstring)
        latency = max(0.0, m.step_s - report.step_s)
        step_s = max(terms.values()) + latency if self.partitioned else m.step_s
        dcgm = dict(
            rl.dcgm_analogues(report),
            gract=min(1.0, max(terms["compute"], terms["memory"]) / step_s),
            smact=min(1.0, terms["compute"] / step_s),
            drama=min(1.0, terms["memory"] / step_s),
        )
        return InstanceRecord(
            job=job.name,
            arch=job.arch,
            shape=job.suite.name,
            profile=self.profile,
            start=self.inst.placement.start,
            chips=1,
            hbm_budget_bytes=self.hbm_budget,
            peak_bytes_per_device=m.peak_bytes,
            fits=bool(m.peak_bytes <= self.hbm_budget),
            step_s=float(step_s),
            compute_s=float(terms["compute"]),
            memory_s=float(terms["memory"]),
            collective_s=float(terms["collective"]),
            bound=max(terms, key=terms.get),
            mfu=float(m.model_flops / (step_s * share * m.peak_flops)) if step_s else 0.0,
            dcgm=dcgm,
            device_ids=self.device_ids(),
            hlo_fingerprint=m.fingerprint,
            mode="mig" if self.partitioned else "solo",
        )
