"""Predicted-vs-measured error fitting: the MISO residual, re-derived.

``predict_step`` prices a slice from analytic records; a calibration
backend (core/calib/harness) or the trace layer's step samples
(core/obs) say what the slice *actually* did. This module closes the gap
with two moves:

1. **Aggregation** — ``step_error_rows`` folds raw measured-vs-predicted
   samples into the per-(arch, slice) error table. It is the one copy of
   that aggregation: ``benchmarks/report.py trace`` renders it (markdown
   and, with ``--format json``, as a ``calib_step_error/v1`` document)
   and the fitting below consumes the same rows, so the harness and the
   report can never disagree about what the error is.

2. **Fitting** — ``fit_residuals`` factors the observed ratios
   measured/predicted into a per-arch scale times a per-profile (slice)
   residual, geometric-mean in log space. That is exactly the shape of
   the MISO claim: a full-device profile predicts every slice up to a
   smooth per-slice correction. ``refine_db`` then applies the fitted
   correction to every *unmeasured* seed entry (provenance ``refined``),
   and ``evaluate_db`` scores any DB against a ground-truth oracle —
   the seed-vs-calibrated delta `benchmarks/report.py calibrate` prints
   and CI gates on.

Everything is jax-free, deterministic, and order-independent (sums are
taken over sorted keys).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.core.calib.records import CharDB, CharKey, CharRecord

ERROR_SCHEMA = "calib_step_error/v1"


# -- sample aggregation (shared with benchmarks/report.py trace) ------------


def step_error_rows(samples: Iterable[Mapping]) -> List[Dict]:
    """Fold step samples (``TraceRecorder.samples`` schema: dicts with
    ``arch``/``profile``/``measured_s``/``predicted_s``) into the
    per-(arch, slice) error table — n, mean measured, mean predicted,
    mean |relative error|."""
    by_key: Dict[Tuple[str, str], List[Mapping]] = {}
    for s in samples:
        by_key.setdefault((s["arch"], s["profile"]), []).append(s)
    rows = []
    for (arch, profile), group in sorted(by_key.items()):
        n = len(group)
        rows.append(
            {
                "arch": arch,
                "profile": profile,
                "n": n,
                "measured_s": sum(s["measured_s"] for s in group) / n,
                "predicted_s": sum(s["predicted_s"] for s in group) / n,
                "rel_err": sum(
                    abs(s["measured_s"] - s["predicted_s"]) / s["predicted_s"]
                    for s in group
                    if s["predicted_s"] > 0.0
                )
                / n,
            }
        )
    return rows


def step_error_doc(
    samples: Iterable[Mapping], *, meta: Optional[Mapping] = None
) -> Dict:
    """The machine-readable step-error document ``benchmarks/report.py
    trace --format json`` emits and ``fit_from_error_doc`` consumes."""
    doc = {"schema": ERROR_SCHEMA, "rows": step_error_rows(samples)}
    if meta:
        doc.update({k: meta[k] for k in sorted(meta)})
    return doc


# -- residual fitting -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResidualFit:
    """Multiplicative corrections factored as per-arch x per-profile.

    ``correction(arch, profile)`` is what a seed prediction must be
    multiplied by to match the measurements; unseen archs/profiles fall
    back to 1.0 (no evidence, no correction)."""

    sku: str
    per_arch: Mapping[str, float]
    per_profile: Mapping[str, float]
    n_pairs: int

    def correction(self, arch: str, profile: str) -> float:
        return self.per_arch.get(arch, 1.0) * self.per_profile.get(profile, 1.0)

    def to_doc(self) -> Dict:
        return {
            "sku": self.sku,
            "n_pairs": self.n_pairs,
            "per_arch": dict(sorted(self.per_arch.items())),
            "per_profile": dict(sorted(self.per_profile.items())),
        }


def _geomean(values: List[float]) -> float:
    return math.exp(sum(math.log(v) for v in values) / len(values))


def fit_residuals(
    pairs: Iterable[Tuple[str, str, float, float]], *, sku: str
) -> ResidualFit:
    """Fit per-arch and per-profile corrections from ``(arch, profile,
    measured_s, predicted_s)`` pairs.

    Two-stage geometric-mean factorization: the per-arch scale absorbs
    each architecture's systematic bias (the wrong ``busy_s`` constant),
    then the per-profile residual absorbs what is left — the slice-level
    MISO residual shared across archs. Non-positive pairs are skipped."""
    clean = sorted(
        (a, p, m / pr)
        for a, p, m, pr in pairs
        if m > 0.0 and pr > 0.0
    )
    if not clean:
        return ResidualFit(sku=sku, per_arch={}, per_profile={}, n_pairs=0)
    by_arch: Dict[str, List[float]] = {}
    for arch, _, ratio in clean:
        by_arch.setdefault(arch, []).append(ratio)
    per_arch = {arch: _geomean(rs) for arch, rs in sorted(by_arch.items())}
    by_prof: Dict[str, List[float]] = {}
    for arch, prof, ratio in clean:
        by_prof.setdefault(prof, []).append(ratio / per_arch[arch])
    per_profile = {p: _geomean(rs) for p, rs in sorted(by_prof.items())}
    return ResidualFit(
        sku=sku, per_arch=per_arch, per_profile=per_profile, n_pairs=len(clean)
    )


def with_profile_interpolation(
    fit: ResidualFit, profile_fracs: Mapping[str, float]
) -> ResidualFit:
    """Fill per-profile corrections for *unmeasured* profiles by
    log-linear interpolation over the slice fraction.

    The MISO residual is smooth in how much of the device a slice is
    (``mem_units / n_units``): measuring the endpoints (full device +
    smallest slice) pins the curve, and every profile in between gets the
    interpolated residual instead of the no-evidence 1.0. Fractions
    outside the measured range clamp to the nearest endpoint."""
    known = sorted(
        (profile_fracs[p], r)
        for p, r in fit.per_profile.items()
        if p in profile_fracs and r > 0.0
    )
    if len(known) < 2:
        return fit
    fracs = [f for f, _ in known]
    logs = [math.log(r) for _, r in known]
    filled = dict(fit.per_profile)
    for prof, frac in sorted(profile_fracs.items()):
        if prof in filled:
            continue
        if frac <= fracs[0]:
            filled[prof] = math.exp(logs[0])
            continue
        if frac >= fracs[-1]:
            filled[prof] = math.exp(logs[-1])
            continue
        for i in range(1, len(fracs)):
            if frac <= fracs[i]:
                w = (frac - fracs[i - 1]) / (fracs[i] - fracs[i - 1])
                filled[prof] = math.exp(
                    logs[i - 1] * (1.0 - w) + logs[i] * w
                )
                break
    return dataclasses.replace(fit, per_profile=filled)


def fit_from_error_doc(doc: Mapping, *, sku: str) -> ResidualFit:
    """Fit residuals from a ``calib_step_error/v1`` document (the
    ``report.py trace --format json`` output) — the satellite contract:
    the harness consumes the report's table instead of re-deriving it."""
    if doc.get("schema") != ERROR_SCHEMA:
        raise ValueError(
            f"not a {ERROR_SCHEMA} document: schema={doc.get('schema')!r}"
        )
    return fit_residuals(
        (
            (row["arch"], row["profile"], row["measured_s"], row["predicted_s"])
            for row in doc.get("rows", ())
        ),
        sku=sku,
    )


# -- DB refinement + evaluation ---------------------------------------------


def refine_record(rec: CharRecord, corr: float) -> CharRecord:
    """Apply a multiplicative correction to a record's busy terms (the
    host-side latency residual of the step does not scale with the
    device, so it carries over unchanged — same convention as
    ``predict_record``)."""
    busy = max(rec.compute_s, rec.memory_s, rec.collective_s)
    residual = max(0.0, rec.step_s - busy)
    return dataclasses.replace(
        rec,
        step_s=busy * corr + residual,
        compute_s=rec.compute_s * corr,
        memory_s=rec.memory_s * corr,
        collective_s=rec.collective_s * corr,
        provenance="refined",
        source="fit",
    )


def refine_db(seed: CharDB, fit: ResidualFit) -> CharDB:
    """Seed DB with every non-measured entry corrected by the fit.

    Measured entries pass through untouched (a fit can never overwrite a
    measurement); everything else becomes ``refined``."""
    out = CharDB(seed.sku, seed=seed.seed)
    for key in sorted(seed.records):
        rec = seed.records[key]
        if rec.provenance == "measured" and rec.n_samples > 0:
            out.add(rec)
            continue
        corr = fit.correction(rec.arch, rec.profile)
        out.add(refine_record(rec, corr) if corr != 1.0 else rec)
    return out


def evaluate_db(
    db: CharDB,
    truth_step_s: Callable[[CharKey], float],
    *,
    keys: Optional[Iterable[CharKey]] = None,
) -> Dict:
    """Mean |relative step error| of ``db`` against a ground-truth oracle
    (a calibration backend's true step time per key). Returns the summary
    plus per-(arch, profile) rows — the ``report.py calibrate`` table."""
    use = sorted(keys) if keys is not None else sorted(db.records)
    rows = []
    errs = []
    for key in use:
        rec = db.records.get(key)
        if rec is None or rec.step_s <= 0.0:
            continue
        true = truth_step_s(key)
        if true <= 0.0:
            continue
        err = abs(rec.step_s - true) / true
        errs.append(err)
        rows.append(
            {
                "arch": key[0],
                "shape": key[1],
                "profile": key[2],
                "predicted_s": rec.step_s,
                "true_s": true,
                "rel_err": err,
                "provenance": rec.provenance,
            }
        )
    return {
        "n": len(errs),
        "mean_abs_rel_err": sum(errs) / len(errs) if errs else 0.0,
        "max_abs_rel_err": max(errs) if errs else 0.0,
        "rows": rows,
    }
