"""Forecast → fleet-partition planning, as pure functions.

The cluster (core/cluster.py) owns all state — device modes, running
jobs, reservations. On every FORECAST_TICK it gathers the current
forecast plus per-device serve capacities and asks this module two
questions:

- :func:`plan_autoscale` — *how many* decode-capable devices should be
  warm to absorb the predicted concurrent serve sessions, and therefore
  how many pre-warm reservations to add or release;
- :func:`wave_amortizes` — *is it worth it*: does the conservative
  (lower-band) predicted serve demand amortize the reconfiguration
  downtime plus checkpoint-rollback redo the flip would cost? This is
  the same economics as the planner's ``_replan_pays_off`` gate, fed by
  the forecast instead of the realized queue.

Keeping these pure (no cluster imports, plain floats in / dataclass
out) keeps them unit-testable and jax-free.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.forecast.estimator import (
    ESTIMATORS,
    RateForecast,
    make_estimator,
)

__all__ = [
    "ForecastConfig",
    "AutoscaleDecision",
    "plan_autoscale",
    "wave_amortizes",
    "next_tick",
    "forecast_provenance",
]


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    """Knobs for ``Cluster(policy="forecast")``.

    estimator        which arrival-rate estimator drives the autoscaler
                     ("seasonal" | "ewma" | "window").
    period_s         seasonal period (the synthetic "day" of the trace).
    n_bins           phase bins per period for the seasonal profile.
    window_s/tau_s   knobs for the structure-free estimators (and the
                     seasonal cold-start fallback).
    tick_s           FORECAST_TICK cadence; ticks ride a fixed grid so
                     both re-timing engines fire them at identical times.
    horizon_s        lookahead window the autoscaler prices.
    headroom         capacity margin over the predicted concurrency.
    amortize_factor  how many times over the predicted wave must cover a
                     flip's downtime + redo before we pay it (>=1 is
                     conservative).
    release_hysteresis  fraction of the warm set's capacity the *upper*
                     band must fall below before reservations are
                     released — avoids thrash at the band edge.
    session_alpha    EWMA weight for the serve session service-time
                     estimate learned from completions.
    demote_priority_below  running jobs with priority strictly below
                     this are preempted (checkpoint-rollback requeue,
                     not killed) when their device is pre-warmed.
    """

    estimator: str = "seasonal"
    period_s: float = 1.0
    n_bins: int = 16
    window_s: float = 0.25
    tau_s: float = 0.25
    tick_s: float = 0.05
    horizon_s: float = 0.5
    headroom: float = 1.2
    amortize_factor: float = 1.0
    release_hysteresis: float = 0.7
    session_alpha: float = 0.3
    demote_priority_below: int = 1

    def __post_init__(self) -> None:
        if self.estimator not in ESTIMATORS:
            raise ValueError(
                f"unknown estimator {self.estimator!r} "
                f"(choose from {sorted(ESTIMATORS)})"
            )
        for field in ("period_s", "tick_s", "horizon_s", "headroom"):
            if getattr(self, field) <= 0.0:
                raise ValueError(f"{field} must be positive")
        if not 0.0 <= self.release_hysteresis <= 1.0:
            raise ValueError("release_hysteresis must be in [0, 1]")

    def build_estimator(self):
        return make_estimator(
            self.estimator,
            window_s=self.window_s,
            tau_s=self.tau_s,
            period_s=self.period_s,
            n_bins=self.n_bins,
        )


@dataclasses.dataclass(frozen=True)
class AutoscaleDecision:
    """Target warm set emitted by :func:`plan_autoscale`.

    ``target_devices`` is a prefix length into the candidate order the
    cluster supplied: the first ``target_devices`` candidates should be
    warm (decode-capable + reserved), the rest should not. ``prewarm``
    and ``release`` are the deltas against the currently reserved count.
    """

    predicted_sessions: float
    target_devices: int
    prewarm: int
    release: int


def _prefix_for(demand: float, caps: Sequence[float]) -> int:
    """Smallest candidate prefix whose summed capacity covers demand."""
    if demand <= 0.0:
        return 0
    total = 0.0
    for i, cap in enumerate(caps):
        total += cap
        if total >= demand:
            return i + 1
    return len(caps)


def plan_autoscale(
    fc: RateForecast,
    *,
    session_s: float,
    device_caps: Sequence[float],
    reserved: int,
    cfg: ForecastConfig,
) -> AutoscaleDecision:
    """Size the warm set from the forecast.

    ``device_caps`` lists each candidate device's concurrent-serve
    capacity (sessions it can host decode-capable), in the cluster's
    preference order — already-reserved devices first so the target
    prefix naturally keeps them. Little's law sizes the demand:
    predicted concurrent sessions = rate x service time, padded by
    ``cfg.headroom``. Releases are sized against the *upper* band and
    damped by ``release_hysteresis`` so a noisy trough does not flap
    reservations that the next ramp would immediately re-acquire.
    """
    if session_s <= 0.0 or not device_caps:
        return AutoscaleDecision(0.0, 0, 0, max(0, reserved))
    predicted = fc.rate_per_s * session_s * cfg.headroom
    target = _prefix_for(predicted, device_caps)
    if target > reserved:
        return AutoscaleDecision(predicted, target, target - reserved, 0)
    # Shrinking: only release what even the optimistic (upper-band)
    # demand cannot use, and only once it clears the hysteresis margin.
    upper_demand = fc.upper_per_s * session_s * cfg.headroom
    upper_target = _prefix_for(upper_demand, device_caps)
    keep = max(target, upper_target)
    if keep < reserved:
        held_cap = sum(device_caps[:reserved])
        if held_cap > 0.0 and upper_demand > cfg.release_hysteresis * held_cap:
            keep = reserved  # still inside the hysteresis band: hold
    release = max(0, reserved - keep)
    return AutoscaleDecision(predicted, max(target, reserved - release), 0, release)


def wave_amortizes(
    fc: RateForecast,
    *,
    session_s: float,
    share_devices: int,
    cost_s: float,
    cfg: ForecastConfig,
) -> bool:
    """Does the conservative predicted wave pay for one device flip?

    The flip costs ``cost_s`` seconds (reconfiguration downtime plus the
    worst checkpoint-rollback redo among displaced jobs). The wave
    conservatively brings ``lower_per_s x session_s x horizon_s``
    serve-busy seconds, spread across ``share_devices`` warm devices.
    A seasonal estimator in cold start reports ``lower_per_s == 0`` and
    therefore never pays for a flip — day one is for learning.
    """
    if cost_s <= 0.0:
        return True
    share = max(1, share_devices)
    wave_busy_s = fc.lower_per_s * session_s * fc.horizon_s / share
    return wave_busy_s >= cfg.amortize_factor * cost_s


def next_tick(t: float, tick_s: float) -> float:
    """Next grid-aligned tick strictly after t (grid anchored at 0).

    Guarded against float quantization: when t sits exactly on a grid
    point but ``t / tick_s`` rounds *down* (e.g. 0.0375 / 0.0025 ->
    14.999...), the naive floor+1 lands back on t and the tick clock
    would stop advancing — re-arming itself at the same timestamp
    forever. Bump until strictly past t."""
    k = math.floor(t / tick_s) + 1.0
    nt = k * tick_s
    while nt <= t:
        k += 1.0
        nt = k * tick_s
    return nt


def forecast_provenance(fc: RateForecast, realized_per_s: float) -> dict:
    """Predicted band vs realized arrivals, for the trace layer (core/obs/).

    The cluster measures ``realized_per_s`` over the tick window that just
    closed and records one ``forecast_tick`` decision instant per tick —
    the per-tick absolute error series that ``benchmarks/report.py trace``
    summarizes, and the ground truth the estimator is judged against."""
    return {
        "rate_per_s": fc.rate_per_s,
        "lower_per_s": fc.lower_per_s,
        "upper_per_s": fc.upper_per_s,
        "horizon_s": fc.horizon_s,
        "realized_per_s": realized_per_s,
        "abs_err_per_s": abs(fc.rate_per_s - realized_per_s),
        "in_band": bool(fc.lower_per_s <= realized_per_s <= fc.upper_per_s),
    }
