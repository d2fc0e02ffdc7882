"""Calibration harness: measure (arch, shape, slice) cells, regenerate records.

MIGPerf's method made executable: characterize each workload per (model,
slice) by *running* it there, then let the measurements replace the
hand-seeded constants. The harness drives a pluggable backend per
(arch, shape, profile) key and folds the observations back into a
:class:`~repro.core.calib.records.CharDB`:

  ``StubBackend``    a deterministic seeded ground-truth oracle: it
                     perturbs the seed catalog with a systematic per-arch
                     scale, a smooth per-slice skew (the MISO residual),
                     and small per-key noise — all derived from SHA-256 of
                     the seed, so two runs are byte-identical and CI can
                     exercise the *entire* pipeline (measure -> fit ->
                     refine -> evaluate) with no accelerator;
  ``KernelBackend``  the measured path: times the port's CUDA kernels at
                     the calibration shapes of ``kernels/calibration.py``
                     with CUDA events on the card (their plain versions by
                     the host clock on the CPU, when asked; *not*
                     byte-deterministic either way) — then prices non-full
                     slices from the measured full-device observation
                     MISO-style (``predict_record``), exactly the
                     one-measurement-prices-every-slice move.

``run_calibration`` is the loop: measure the plan's keys (by default the
MISO probe set — full device + smallest slice per (arch, shape)), fit
per-arch x per-slice residual corrections from the measured-vs-seed
ratios (core/calib/fit), refine every unmeasured seed entry, and return
the calibrated DB with full provenance. Only ``KernelBackend`` imports
torch and the kernel stack, lazily.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.calib.fit import (
    ResidualFit,
    evaluate_db,
    fit_residuals,
    refine_db,
    with_profile_interpolation,
)
from repro_torch.core.calib.records import CharDB, CharKey, CharRecord
from repro_torch.core.device import DeviceSKU, get_sku


def _unit(*tag: object) -> float:
    """Deterministic uniform in [0, 1) from a stable hash of ``tag`` —
    byte-identical across processes and platforms (unlike ``hash()``,
    which is salted per interpreter)."""
    digest = hashlib.sha256("|".join(str(t) for t in tag).encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


@dataclasses.dataclass(frozen=True)
class Observation:
    """One backend measurement of an (arch, shape, profile) cell."""

    arch: str
    shape: str
    profile: str
    step_s: float
    compute_s: float
    memory_s: float
    collective_s: float
    peak_bytes_per_device: float
    fits: bool
    n_samples: int
    backend: str
    provenance: str = "measured"

    @property
    def key(self) -> CharKey:
        return (self.arch, self.shape, self.profile)

    def to_record(self) -> CharRecord:
        return CharRecord(
            arch=self.arch,
            shape=self.shape,
            profile=self.profile,
            step_s=self.step_s,
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            peak_bytes_per_device=self.peak_bytes_per_device,
            fits=self.fits,
            provenance=self.provenance,
            source=self.backend,
            n_samples=self.n_samples,
        )


class StubBackend:
    """Seeded deterministic ground truth over a seed catalog.

    The "hardware" this backend pretends to be differs from the seed
    catalog by exactly the error modes calibration must recover:

    - a per-arch systematic scale in [0.8, 1.25) — the wrong ``busy_s``
      constant for that architecture;
    - a smooth per-slice skew ``1 + gamma * (1 - frac)`` shared across
      archs (``gamma`` in [-0.15, 0.25) per seed) — sub-linear slice
      scaling the analytic inverse-fraction model misses (the paper's F1
      is exactly such a curve);
    - per-key multiplicative noise within ±1.5% — measurement jitter, the
      floor calibrated error converges to.

    Peak memory and ``fits`` verdicts pass through unchanged: the stub
    models timing error, not admission error.
    """

    name = "stub"

    def __init__(
        self,
        seed_db: Mapping[CharKey, Mapping],
        *,
        sku: Union[None, str, DeviceSKU] = None,
        seed: int = 0,
        n_samples: int = 3,
    ) -> None:
        self.seed_db = seed_db
        self.sku = get_sku(sku)
        self.seed = int(seed)
        self.n_samples = int(n_samples)
        self._gamma = -0.15 + 0.4 * _unit(self.seed, "slice-skew")

    def _scales(self, arch: str, shape: str, profile: str) -> float:
        frac = self.sku.profile(profile).mem_units / self.sku.n_units
        arch_scale = 0.8 + 0.45 * _unit(self.seed, "arch", arch)
        skew = 1.0 + self._gamma * (1.0 - frac)
        noise = 1.0 + 0.03 * (_unit(self.seed, "noise", arch, shape, profile) - 0.5)
        return arch_scale * skew * noise

    def true_record(self, key: CharKey) -> Dict:
        """What the pretend hardware would actually report for ``key``."""
        arch, shape, profile = key
        rec = self.seed_db[key]
        scale = self._scales(arch, shape, profile)
        compute = float(rec.get("compute_s", rec.get("step_s", 0.0))) * scale
        memory = float(rec.get("memory_s", 0.0)) * scale
        collective = float(rec.get("collective_s", 0.0)) * scale
        seed_busy = max(
            float(rec.get("compute_s", 0.0)),
            float(rec.get("memory_s", 0.0)),
            float(rec.get("collective_s", 0.0)),
        )
        residual = max(0.0, float(rec.get("step_s", 0.0)) - seed_busy)
        return {
            "fits": bool(rec.get("fits", False)),
            "step_s": max(compute, memory, collective) + residual,
            "compute_s": compute,
            "memory_s": memory,
            "collective_s": collective,
            "peak_bytes_per_device": float(rec.get("peak_bytes_per_device", 0.0)),
        }

    def true_step_s(self, key: CharKey) -> float:
        """Ground-truth oracle for ``evaluate_db``."""
        return float(self.true_record(key)["step_s"])

    def measure(self, arch: str, shape: str, profile: str) -> Observation:
        rec = self.true_record((arch, shape, profile))
        return Observation(
            arch=arch,
            shape=shape,
            profile=profile,
            step_s=rec["step_s"],
            compute_s=rec["compute_s"],
            memory_s=rec["memory_s"],
            collective_s=rec["collective_s"],
            peak_bytes_per_device=rec["peak_bytes_per_device"],
            fits=rec["fits"],
            n_samples=self.n_samples,
            backend=self.name,
        )


class KernelBackend:
    """Measured path: time the port's CUDA kernels at the calibration shapes.

    Full-device cells are the mean time, between two CUDA events, of the
    arch's kernel family on the card (``kernels/calibration.py`` maps archs
    to kernels and owns the shapes: flash attention, decode attention or the
    WKV6 scan). Non-full slices are then priced from the arch's *measured*
    full-device observation by the planner's MISO scaling
    (``predict_record``) and stamped ``predicted`` — one real measurement
    prices the whole tree, which is the MISO result this repo leans on.
    ``device="cpu"`` (only when the caller asks) runs the kernels' plain
    versions and times them with the host clock, so the pipeline
    (provenance, fitting, serialization) runs end to end with no card; those
    times are not step times of any GPU.
    """

    name = "kernels"

    def __init__(
        self,
        seed_db: Mapping[CharKey, Mapping],
        *,
        sku: Union[None, str, DeviceSKU] = None,
        n_samples: int = 2,
        device: str = "cuda",
    ) -> None:
        self.seed_db = seed_db
        self.sku = get_sku(sku)
        self.n_samples = int(n_samples)
        self.device = str(device)
        self._full_cache: Dict[Tuple[str, str], Dict] = {}

    @staticmethod
    def available(device: str = "cuda") -> bool:
        kind = str(device).split(":")[0]
        if kind == "cpu":
            return True
        if kind != "cuda":
            return False
        import torch

        return torch.cuda.is_available()

    def _measure_full(self, arch: str, shape: str) -> Dict:
        key = (arch, shape)
        if key not in self._full_cache:
            from repro_torch.kernels.calibration import measure_calibration_kernel

            meas = measure_calibration_kernel(arch, device=self.device, n=self.n_samples)
            rec = dict(self.seed_db[(arch, shape, self.sku.full_profile)])
            # the kernel's wall time *is* the measured compute term; the
            # seed's memory/collective proportions ride along so the record
            # stays phase-complete (workload demand vectors scale them)
            seed_c = float(rec.get("compute_s", rec.get("step_s", 1.0))) or 1.0
            ratio = meas["wall_s"] / seed_c
            rec["compute_s"] = meas["wall_s"]
            rec["memory_s"] = float(rec.get("memory_s", 0.0)) * ratio
            rec["collective_s"] = float(rec.get("collective_s", 0.0)) * ratio
            busy = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
            rec["step_s"] = busy + self.sku.step_latency_s
            rec["max_err_vs_ref"] = meas["max_err_vs_ref"]
            self._full_cache[key] = rec
        return self._full_cache[key]

    def measure(self, arch: str, shape: str, profile: str) -> Observation:
        from repro_torch.core.planner.costmodel import predict_record

        full = self._measure_full(arch, shape)
        if profile == self.sku.full_profile:
            rec, provenance = full, "measured"
        else:
            rec = predict_record(full, profile, sku=self.sku)
            rec["fits"] = bool(
                self.seed_db.get((arch, shape, profile), {}).get("fits", False)
            )
            provenance = "predicted"
        return Observation(
            arch=arch,
            shape=shape,
            profile=profile,
            step_s=float(rec["step_s"]),
            compute_s=float(rec["compute_s"]),
            memory_s=float(rec["memory_s"]),
            collective_s=float(rec["collective_s"]),
            peak_bytes_per_device=float(rec["peak_bytes_per_device"]),
            fits=bool(rec["fits"]),
            n_samples=self.n_samples,
            backend=self.name,
            provenance=provenance,
        )


BACKENDS = ("stub", "kernels")


def make_backend(
    name: str,
    seed_db: Mapping[CharKey, Mapping],
    *,
    sku: Union[None, str, DeviceSKU] = None,
    seed: int = 0,
    device: str = "cuda",
):
    if name == "stub":
        return StubBackend(seed_db, sku=sku, seed=seed)
    if name == "kernels":
        if not KernelBackend.available(device):
            raise RuntimeError(
                f"the kernels backend times the CUDA kernels on device {device!r}, "
                "which this machine does not have; pass --device cpu to time "
                "their plain versions, or use --backend stub (the deterministic path)"
            )
        return KernelBackend(seed_db, sku=sku, device=device)
    raise ValueError(f"unknown backend {name!r}; choose from {BACKENDS}")


# -- the calibration loop ---------------------------------------------------


def miso_probe_keys(
    seed_db: Mapping[CharKey, Mapping],
    sku: Union[None, str, DeviceSKU] = None,
) -> Tuple[CharKey, ...]:
    """The default measurement plan: per (arch, shape), the full-device
    profile plus the smallest slice — the two endpoints that pin the
    slice-residual curve (MISO measures the full device; MIGPerf says the
    endpoints differ most). Keys the seed DB does not know are skipped."""
    dev = get_sku(sku)
    order = dev.profile_order  # smallest first
    probes = (order[0], dev.full_profile)
    keys = []
    for arch, shape in sorted({(a, s) for a, s, _ in seed_db}):
        for prof in dict.fromkeys(probes):
            if (arch, shape, prof) in seed_db:
                keys.append((arch, shape, prof))
    return tuple(keys)


@dataclasses.dataclass
class CalibrationResult:
    """Everything one calibration pass produced."""

    sku: str
    backend: str
    seed_db: CharDB
    calibrated: CharDB
    fit: ResidualFit
    observations: List[Observation]
    measured_keys: Tuple[CharKey, ...]

    def summary(self) -> Dict:
        return {
            "sku": self.sku,
            "backend": self.backend,
            "n_keys": len(self.calibrated),
            "n_measured": len(self.measured_keys),
            "provenance": self.calibrated.provenance_counts(),
            "fit": self.fit.to_doc(),
        }


def run_calibration(
    seed_db: Mapping[CharKey, Mapping],
    backend,
    *,
    sku: Union[None, str, DeviceSKU] = None,
    seed: Optional[int] = None,
    plan: Optional[Sequence[CharKey]] = None,
    seed_provenance: Optional[str] = None,
) -> CalibrationResult:
    """One full calibration pass: measure -> fit -> refine -> merge.

    ``seed_db`` is the hand-seeded plain mapping (loads as
    ``extrapolated`` unless entries carry their own provenance or
    ``seed_provenance`` overrides); ``plan`` defaults to the MISO probe
    set. The returned DB has ``measured`` entries at plan keys (or
    ``predicted`` where the backend itself derived the slice), ``refined``
    entries where the fit corrected an extrapolation, and untouched seed
    entries where there was no evidence to apply."""
    dev = get_sku(sku)
    seed_doc = CharDB.from_plain_db(
        seed_db, sku=dev.name, provenance=seed_provenance, seed=seed
    )
    keys = tuple(plan) if plan is not None else miso_probe_keys(seed_db, dev)
    observations = [backend.measure(*key) for key in keys]
    fit = fit_residuals(
        (
            (o.arch, o.profile, o.step_s, float(seed_db[o.key]["step_s"]))
            for o in observations
            if o.key in seed_db
        ),
        sku=dev.name,
    )
    fit = with_profile_interpolation(
        fit,
        {p.name: p.mem_units / dev.n_units for p in dev.profiles},
    )
    calibrated = refine_db(seed_doc, fit)
    calibrated.merge(o.to_record() for o in observations)
    return CalibrationResult(
        sku=dev.name,
        backend=backend.name,
        seed_db=seed_doc,
        calibrated=calibrated,
        fit=fit,
        observations=observations,
        measured_keys=keys,
    )


def calibration_report(
    result: CalibrationResult, truth_step_s
) -> Dict:
    """Seed-vs-calibrated error scorecard against a ground-truth oracle
    (``StubBackend.true_step_s`` in CI; a real backend's re-measurement
    pass on hardware). The acceptance inequality lives here: calibrated
    mean error strictly below seed mean error."""
    seed_eval = evaluate_db(result.seed_db, truth_step_s)
    calib_eval = evaluate_db(result.calibrated, truth_step_s)
    return {
        "sku": result.sku,
        "backend": result.backend,
        "n_keys": seed_eval["n"],
        "n_measured": len(result.measured_keys),
        "seed_mean_abs_rel_err": seed_eval["mean_abs_rel_err"],
        "calibrated_mean_abs_rel_err": calib_eval["mean_abs_rel_err"],
        "seed_max_abs_rel_err": seed_eval["max_abs_rel_err"],
        "calibrated_max_abs_rel_err": calib_eval["max_abs_rel_err"],
        "error_reduction": (
            1.0
            - calib_eval["mean_abs_rel_err"] / seed_eval["mean_abs_rel_err"]
            if seed_eval["mean_abs_rel_err"] > 0.0
            else 0.0
        ),
        "provenance": result.calibrated.provenance_counts(),
    }
