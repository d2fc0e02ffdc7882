"""Online refinement: EWMA residual corrections from live step samples.

The static pipeline (harness -> fit -> refine) runs *before* a
simulation; this module is the MISO "refine online" half — the loop
closing *during* one. ``Cluster.observe_step`` already turns every
completed step into a measured-vs-predicted sample (the PR 9 trace
layer); an :class:`OnlineCalibrator` attached to the cluster folds each
sample into a running per-(sku, arch, profile) multiplicative residual,
and ``CollocationScheduler.predict_step`` multiplies its memoized base
prediction by the current residual — so predictions tighten as evidence
accumulates, without ever touching the char DB or the memo cache.

Determinism: the state is a pure fold over the observation sequence
(EWMA, no clocks, no randomness), so identical runs produce identical
residuals — the byte-determinism contract survives. Runs that do not
attach a calibrator are untouched: the scheduler hook multiplies by
nothing when ``calibrator`` is ``None``.

Convergence note: the samples feed back through the very predictions the
calibrator corrects (predicted_s already includes the current residual).
The update therefore divides the correction back out — it estimates the
ratio measured / *base* prediction — so the residual converges to the
true bias instead of compounding against itself. Jax-free stdlib.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

ResidualKey = Tuple[str, str, str]  # (sku, arch, profile)

#: Default EWMA smoothing: one sample moves the residual 20% of the way
#: to its observed ratio — fast enough to converge within a short run's
#: worth of steps, slow enough that one outlier step cannot whipsaw the
#: scheduler's packing decisions.
DEFAULT_ALPHA = 0.2

#: Residuals clamp to [1/BOUND, BOUND]; a wildly corrupt sample (a stall,
#: a clock glitch) can nudge predictions, never invert them.
DEFAULT_BOUND = 4.0


@dataclasses.dataclass
class _Residual:
    value: float = 1.0
    n: int = 0
    last_t_s: float = 0.0


class OnlineCalibrator:
    """Running per-(sku, arch, profile) multiplicative step corrections.

    ``observe`` folds one measured-vs-predicted sample in (EWMA in the
    ratio domain); ``correct`` applies the current residual to a base
    prediction; ``snapshot`` exports the state as a sorted plain dict
    (artifact- and report-ready).
    """

    def __init__(
        self, *, alpha: float = DEFAULT_ALPHA, bound: float = DEFAULT_BOUND
    ) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if bound < 1.0:
            raise ValueError(f"bound must be >= 1, got {bound}")
        self.alpha = float(alpha)
        self.bound = float(bound)
        self._residuals: Dict[ResidualKey, _Residual] = {}
        self.n_observed = 0

    # -- the fold -------------------------------------------------------

    def observe(
        self,
        *,
        sku: str,
        arch: str,
        profile: str,
        measured_s: float,
        predicted_s: float,
        t_s: float = 0.0,
        applied_residual: Optional[float] = None,
    ) -> float:
        """Fold one step sample in; returns the updated residual.

        ``predicted_s`` is the scheduler's *corrected* prediction (what
        ``predict_step`` returned, i.e. base x some residual) — the
        correction is divided back out so the EWMA tracks measured/base,
        not measured/corrected. ``applied_residual`` is the residual that
        prediction actually carried (the scheduler records it per job at
        pricing time; a job priced before the residual moved is divided
        by its *stale* value, not today's). When omitted, the current
        residual is assumed — exact only for callers that re-price on
        every step. Non-positive samples are ignored."""
        if measured_s <= 0.0 or predicted_s <= 0.0:
            return self.residual(sku=sku, arch=arch, profile=profile)
        key = (sku, arch, profile)
        st = self._residuals.setdefault(key, _Residual())
        r_applied = applied_residual if applied_residual else st.value
        base_s = predicted_s / r_applied if r_applied > 0.0 else predicted_s
        ratio = measured_s / base_s
        ratio = min(max(ratio, 1.0 / self.bound), self.bound)
        st.value = (1.0 - self.alpha) * st.value + self.alpha * ratio
        st.value = min(max(st.value, 1.0 / self.bound), self.bound)
        st.n += 1
        st.last_t_s = float(t_s)
        self.n_observed += 1
        return st.value

    # -- reads ----------------------------------------------------------

    def residual(self, *, sku: str, arch: str, profile: str) -> float:
        st = self._residuals.get((sku, arch, profile))
        return st.value if st is not None else 1.0

    def correct(
        self, step_s: float, *, sku: str, arch: str, profile: str
    ) -> float:
        """Apply the current residual to a base prediction — the hook
        ``CollocationScheduler.predict_step`` calls after its memo."""
        return step_s * self.residual(sku=sku, arch=arch, profile=profile)

    def snapshot(self) -> Dict:
        """Sorted, JSON-ready view of the state (launch/calibrate.py
        writes this into the calibration artifact)."""
        return {
            "alpha": self.alpha,
            "bound": self.bound,
            "n_observed": self.n_observed,
            "residuals": [
                {
                    "sku": k[0],
                    "arch": k[1],
                    "profile": k[2],
                    "residual": st.value,
                    "n": st.n,
                    "last_t_s": st.last_t_s,
                }
                for k, st in sorted(self._residuals.items())
            ],
        }

    def __len__(self) -> int:
        return len(self._residuals)
