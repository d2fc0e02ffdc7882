"""core/calib: close the loop from measured kernels to the char DB.

Versioned provenance-carrying characterization records (records),
measurement backends + the calibration loop (harness), residual fitting
and DB refinement (fit), and live EWMA refinement off the cluster's step
samples (online). The kernel backend imports torch lazily.
"""
from repro_torch.core.calib.fit import (
    ERROR_SCHEMA,
    ResidualFit,
    evaluate_db,
    fit_from_error_doc,
    fit_residuals,
    refine_db,
    refine_record,
    step_error_doc,
    step_error_rows,
    with_profile_interpolation,
)
from repro_torch.core.calib.harness import (
    BACKENDS,
    CalibrationResult,
    KernelBackend,
    Observation,
    StubBackend,
    calibration_report,
    make_backend,
    miso_probe_keys,
    run_calibration,
)
from repro_torch.core.calib.online import OnlineCalibrator
from repro_torch.core.calib.records import (
    PROVENANCES,
    SCHEMA,
    CharDB,
    CharKey,
    CharRecord,
    seed_provenance,
)

__all__ = [
    "BACKENDS",
    "ERROR_SCHEMA",
    "PROVENANCES",
    "SCHEMA",
    "CalibrationResult",
    "CharDB",
    "CharKey",
    "CharRecord",
    "KernelBackend",
    "Observation",
    "OnlineCalibrator",
    "ResidualFit",
    "StubBackend",
    "calibration_report",
    "evaluate_db",
    "fit_from_error_doc",
    "fit_residuals",
    "make_backend",
    "miso_probe_keys",
    "refine_db",
    "refine_record",
    "run_calibration",
    "seed_provenance",
    "step_error_doc",
    "step_error_rows",
    "with_profile_interpolation",
]
