"""Calibration CLI: regenerate the char DB from measured observations.

    PYTHONPATH=src python -m repro_torch.launch.calibrate                 \\
        [--backend stub|kernels] [--device cuda|cpu] [--seed 0]           \\
        [--skus a100-40gb,...] [--out artifacts/calib]                    \\
        [--from-trace step_error.json]

The executable form of the calibration loop (docs/calibration.md): per
SKU, load the hand-seeded analytic catalog (``launch/simulate.py``),
measure the MISO probe set through the chosen backend (core/calib/
harness — the deterministic seeded stub by default; ``--backend
kernels`` times the port's CUDA kernels on the card, or their plain
versions with ``--device cpu``),
fit per-arch x per-slice residual corrections, refine every unmeasured
entry, and write the calibrated DB plus a scorecard:

  artifacts/calib/calib_db__<sku>.json   the ``calib_char_db/v1``
                                         document — every entry carries
                                         provenance (measured / predicted
                                         / refined / extrapolated);
  artifacts/calib/_summary.json          per-SKU seed-vs-calibrated error
                                         vs the stub's ground truth, the
                                         fitted residuals, and the online
                                         EWMA convergence demo.

Stub-backend artifacts are **byte-deterministic per seed** (the CI
``calibrate`` job runs the harness twice and byte-compares; floats are
rounded exactly like the cluster artifacts). ``--from-trace`` instead
fits residuals from a ``calib_step_error/v1`` document — the output of
``python -m benchmarks.report trace --format json`` — so a live
simulation's step samples calibrate the DB without re-deriving the error
aggregation.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.core.calib import (
    OnlineCalibrator,
    StubBackend,
    calibration_report,
    fit_from_error_doc,
    make_backend,
    refine_db,
    run_calibration,
)
from repro_torch.core.calib.records import CharDB
from repro_torch.core.device import SKUS, get_sku
from repro_torch.core.metrics import epoch_time_s
from repro_torch.launch.simulate import _dump, synthetic_char_db
from repro_torch.launch.traces import SIM_SAMPLES_PER_EPOCH

#: Steps of the online-refinement convergence demo per measured key, and
#: the batch the epoch-time view of an observation assumes (the simulation
#: trace default).
ONLINE_DEMO_STEPS = 12
CALIB_BATCH = 32


def _epoch_s(step_s: float) -> float:
    """Epoch-time view of a measured step: the core.metrics algebra at the
    simulation trace's samples per epoch (the same product as
    benchmarks/time_per_epoch.py's helper, which this package does not
    import)."""
    rec = type("R", (), {"step_s": step_s})()
    return epoch_time_s(rec, SIM_SAMPLES_PER_EPOCH, CALIB_BATCH)


def online_demo(backend: StubBackend, seed_db, *, sku) -> dict:
    """MISO's online-refinement claim as a deterministic convergence run.

    Feed ``ONLINE_DEMO_STEPS`` ground-truth step samples per measured key
    through an ``OnlineCalibrator`` exactly as ``Cluster.observe_step``
    does (predicted = the calibrator-corrected seed prediction, so the
    self-referencing feedback path is the one exercised), and report the
    prediction error at the first and last step: the EWMA must tighten."""
    dev = get_sku(sku)
    calib = OnlineCalibrator()
    first_errs, last_errs = [], []
    for key in sorted(seed_db):
        arch, _, profile = key
        true_s = backend.true_step_s(key)
        base_s = float(seed_db[key]["step_s"])
        if true_s <= 0.0 or base_s <= 0.0:
            continue
        for step in range(ONLINE_DEMO_STEPS):
            predicted_s = calib.correct(
                base_s, sku=dev.name, arch=arch, profile=profile
            )
            err = abs(predicted_s - true_s) / true_s
            if step == 0:
                first_errs.append(err)
            if step == ONLINE_DEMO_STEPS - 1:
                last_errs.append(err)
            calib.observe(
                sku=dev.name,
                arch=arch,
                profile=profile,
                measured_s=true_s,
                predicted_s=predicted_s,
                t_s=float(step),
            )
    return {
        "steps_per_key": ONLINE_DEMO_STEPS,
        "n_keys": len(first_errs),
        "first_step_mean_abs_rel_err": (
            sum(first_errs) / len(first_errs) if first_errs else 0.0
        ),
        "last_step_mean_abs_rel_err": (
            sum(last_errs) / len(last_errs) if last_errs else 0.0
        ),
        "n_observed": calib.n_observed,
        "residuals": calib.snapshot()["residuals"],
    }


def calibrate_sku(
    sku_name: str, *, backend_name: str, seed: int, device: str = "cuda"
) -> tuple:
    """One SKU's full pass: (calibrated CharDB, summary dict)."""
    dev = get_sku(sku_name)
    seed_db = synthetic_char_db(sku=dev)
    backend = make_backend(backend_name, seed_db, sku=dev, seed=seed, device=device)
    result = run_calibration(seed_db, backend, sku=dev, seed=seed)
    summary = result.summary()
    summary["observations"] = [
        {
            "arch": o.arch,
            "shape": o.shape,
            "profile": o.profile,
            "step_s": o.step_s,
            "epoch_time_s": _epoch_s(o.step_s),
            "provenance": o.provenance,
            "n_samples": o.n_samples,
        }
        for o in result.observations
    ]
    if isinstance(backend, StubBackend):
        # only the stub carries its own ground truth; a kernel run's
        # scorecard needs a second measurement pass on real hardware
        summary["scorecard"] = calibration_report(result, backend.true_step_s)
        summary["online"] = online_demo(backend, seed_db, sku=dev)
    return result.calibrated, summary


def calibrate_from_trace(doc_path: Path, sku_name: str, *, seed: int) -> tuple:
    """Fit residuals from a ``calib_step_error/v1`` document (``report.py
    trace --format json``) and refine the SKU's seed catalog with them —
    no backend run; the simulation's own step samples are the evidence."""
    doc = json.loads(Path(doc_path).read_text())
    dev = get_sku(sku_name)
    fit = fit_from_error_doc(doc, sku=dev.name)
    seed_db = CharDB.from_plain_db(
        synthetic_char_db(sku=dev), sku=dev.name, seed=seed
    )
    calibrated = refine_db(seed_db, fit)
    return calibrated, {
        "sku": dev.name,
        "backend": "trace",
        "source": str(doc_path),
        "n_keys": len(calibrated),
        "n_rows": len(doc.get("rows", ())),
        "provenance": calibrated.provenance_counts(),
        "fit": fit.to_doc(),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__ and __doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="stub", choices=("stub", "kernels"),
                    help="measurement backend (core/calib/harness): the "
                         "deterministic seeded stub (default; what CI "
                         "byte-compares) or the CUDA kernel path (timed "
                         "with CUDA events — not byte-deterministic)")
    ap.add_argument("--device", default="cuda",
                    help="where --backend kernels runs: cuda (the kernels) "
                         "or cpu (their plain versions, by the host clock)")
    ap.add_argument("--skus", default=",".join(sorted(SKUS)),
                    help="comma-separated SKUs to calibrate")
    ap.add_argument("--out", default="artifacts/calib")
    ap.add_argument("--from-trace", default=None, metavar="DOC.json",
                    help="fit from a calib_step_error/v1 document "
                         "(benchmarks/report.py trace --format json) "
                         "instead of running a backend; applies to the "
                         "first --skus entry")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    skus = [s for s in args.skus.split(",") if s]
    summaries = {}
    if args.from_trace is not None:
        sku = skus[0]
        db, summary = calibrate_from_trace(
            Path(args.from_trace), sku, seed=args.seed
        )
        _dump(out / f"calib_db__{sku}.json", db.to_doc())
        summaries[sku] = summary
        print(f"calibrate[{sku}] <- {args.from_trace}: "
              f"{summary['n_rows']} error rows, {summary['provenance']}")
    else:
        for sku in skus:
            db, summary = calibrate_sku(
                sku, backend_name=args.backend, seed=args.seed, device=args.device
            )
            _dump(out / f"calib_db__{sku}.json", db.to_doc())
            summaries[sku] = summary
            card = summary.get("scorecard")
            if card is not None:
                print(
                    f"calibrate[{sku}] backend={args.backend} seed={args.seed}: "
                    f"err {card['seed_mean_abs_rel_err']:.4f} -> "
                    f"{card['calibrated_mean_abs_rel_err']:.4f} "
                    f"(-{100.0 * card['error_reduction']:.1f}%)"
                )
            else:
                print(f"calibrate[{sku}] backend={args.backend}: "
                      f"{summary['provenance']}")
    _dump(out / "_summary.json", {"seed": args.seed, "backend": args.backend,
                                  "skus": summaries})
    print(f"wrote {len(summaries)} calibrated DB(s) + _summary.json -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
