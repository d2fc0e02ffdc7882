"""Arrival-rate estimators over the cluster's event stream.

Every estimator consumes a strictly non-decreasing sequence of arrival
timestamps via ``observe(t)`` and answers ``forecast(t, horizon_s)``
with a :class:`RateForecast` — a predicted mean arrival rate over
``[t, t + horizon_s]`` plus a confidence band. All three are pure
stdlib/math code (no jax, no numpy) and fully deterministic functions
of the observation stream: the only randomness in a simulation enters
through the seeded trace, so two runs over the same trace produce
byte-identical forecasts.

Three estimators, increasing in structure:

- :class:`WindowedRateEstimator` — counts arrivals in a sliding window;
  the band is the Poisson standard error of the count. Zero lag, no
  memory beyond the window, blind to seasonality.
- :class:`EWMARateEstimator` — exponentially-weighted instantaneous
  rate with a continuous-time decay ``exp(-dt / tau_s)``, plus an
  exponentially-weighted variance for the band. Smooth, but always
  trails a ramp by ~``tau_s``.
- :class:`SeasonalRateEstimator` — learns a per-bin diurnal profile
  from *completed* periods and integrates it over the forecast window,
  so it predicts the morning ramp *before* it happens. During the first
  (incomplete) period it falls back to an internal EWMA and reports a
  zero lower band — "I have seen no full day yet" — which downstream
  gating treats as insufficient evidence to pay for a re-partition.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

# Two-sided 95% normal quantile used for every confidence band.
Z95 = 1.96

__all__ = [
    "RateForecast",
    "WindowedRateEstimator",
    "EWMARateEstimator",
    "SeasonalRateEstimator",
    "ESTIMATORS",
    "make_estimator",
]


@dataclasses.dataclass(frozen=True)
class RateForecast:
    """Predicted mean arrival rate over ``[at_s, at_s + horizon_s]``."""

    at_s: float
    horizon_s: float
    rate_per_s: float
    lower_per_s: float
    upper_per_s: float
    source: str
    # How many completed seasonal periods back the prediction (0 for the
    # structure-free estimators and during a seasonal cold start).
    periods: int = 0

    @property
    def expected_arrivals(self) -> float:
        return self.rate_per_s * self.horizon_s


def _band(rate: float, se: float) -> Tuple[float, float]:
    return (max(0.0, rate - Z95 * se), rate + Z95 * se)


class WindowedRateEstimator:
    """Sliding-window arrival counter with a Poisson error band."""

    name = "window"

    def __init__(self, window_s: float = 0.25) -> None:
        if window_s <= 0.0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.window_s = float(window_s)
        self._times: Deque[float] = deque()
        self.n_observed = 0

    def _evict(self, t: float) -> None:
        cutoff = t - self.window_s
        times = self._times
        while times and times[0] <= cutoff:
            times.popleft()

    def observe(self, t: float) -> None:
        self.n_observed += 1
        self._times.append(t)
        self._evict(t)

    def forecast(self, t: float, horizon_s: float) -> RateForecast:
        self._evict(t)
        n = len(self._times)
        rate = n / self.window_s
        # Poisson standard error of the window count; with an empty
        # window use the se of a single count so the upper band stays
        # non-degenerate ("we could have just missed one").
        se = math.sqrt(max(n, 1)) / self.window_s
        lower, upper = _band(rate, se)
        return RateForecast(
            at_s=t,
            horizon_s=horizon_s,
            rate_per_s=rate,
            lower_per_s=lower,
            upper_per_s=upper,
            source=self.name,
        )


class EWMARateEstimator:
    """Exponentially-weighted instantaneous rate with variance band.

    Each arrival contributes the instantaneous rate ``1 / dt`` (dt =
    gap since the previous arrival), blended with the continuous-time
    weight ``1 - exp(-dt / tau_s)`` so the smoothing is invariant to
    how irregular the arrivals are.
    """

    name = "ewma"

    def __init__(self, tau_s: float = 0.25) -> None:
        if tau_s <= 0.0:
            raise ValueError(f"tau_s must be positive, got {tau_s}")
        self.tau_s = float(tau_s)
        self._last_t: Optional[float] = None
        self._rate = 0.0
        self._var = 0.0
        self.n_observed = 0

    def observe(self, t: float) -> None:
        self.n_observed += 1
        if self._last_t is None:
            self._last_t = t
            return
        dt = max(t - self._last_t, 1e-12)
        self._last_t = t
        inst = 1.0 / dt
        w = 1.0 - math.exp(-dt / self.tau_s)
        diff = inst - self._rate
        self._rate += w * diff
        # Exponentially-weighted variance (West 1979 incremental form).
        self._var = (1.0 - w) * (self._var + w * diff * diff)

    def forecast(self, t: float, horizon_s: float) -> RateForecast:
        rate = self._rate
        if self._last_t is not None and rate > 0.0:
            # A silence much longer than the expected gap is evidence the
            # rate has collapsed; decay the estimate for the excess.
            silence = max(0.0, t - self._last_t)
            grace = 3.0 / rate
            if silence > grace:
                rate *= math.exp(-(silence - grace) / self.tau_s)
        se = math.sqrt(max(self._var, 0.0))
        lower, upper = _band(rate, se)
        return RateForecast(
            at_s=t,
            horizon_s=horizon_s,
            rate_per_s=rate,
            lower_per_s=lower,
            upper_per_s=upper,
            source=self.name,
        )


class SeasonalRateEstimator:
    """Learns a per-bin daily profile from completed periods.

    Time is folded modulo ``period_s`` into ``n_bins`` equal phase
    bins. While a period is in flight its bin counts accumulate; when
    the clock rolls past a period boundary the counts are finalized
    into a per-bin rate profile (up to ``max_periods`` kept, oldest
    dropped). A forecast integrates the across-period mean profile over
    the phase window ``[t, t + horizon_s]`` — which is what lets it see
    tomorrow's ramp in today's history. The band is the across-period
    standard error per bin (Poisson se when only one period has
    completed). Before any period completes it falls back to an
    internal :class:`EWMARateEstimator` with a zero lower band.
    """

    name = "seasonal"

    def __init__(
        self,
        period_s: float = 1.0,
        n_bins: int = 16,
        tau_s: float = 0.25,
        max_periods: int = 8,
    ) -> None:
        if period_s <= 0.0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        if n_bins < 1:
            raise ValueError(f"n_bins must be >= 1, got {n_bins}")
        self.period_s = float(period_s)
        self.n_bins = int(n_bins)
        self.bin_s = self.period_s / self.n_bins
        self.max_periods = int(max_periods)
        self._cur_period: Optional[int] = None
        self._counts = [0] * self.n_bins
        # Completed-period profiles: list of per-bin rates (arrivals/s).
        self._profiles: List[List[float]] = []
        self._recent = EWMARateEstimator(tau_s=tau_s)
        self.n_observed = 0

    # -- period bookkeeping -------------------------------------------------

    def _period_of(self, t: float) -> int:
        return int(math.floor(t / self.period_s))

    def _bin_of(self, t: float) -> int:
        phase = t - self._period_of(t) * self.period_s
        return min(int(phase / self.bin_s), self.n_bins - 1)

    def _roll(self, t: float) -> None:
        pid = self._period_of(t)
        if self._cur_period is None:
            # First observation: anchor without fabricating empty
            # profiles for periods the estimator never watched.
            self._cur_period = pid
            return
        while self._cur_period < pid:
            profile = [c / self.bin_s for c in self._counts]
            self._profiles.append(profile)
            if len(self._profiles) > self.max_periods:
                self._profiles.pop(0)
            self._counts = [0] * self.n_bins
            self._cur_period += 1

    # -- observation --------------------------------------------------------

    def observe(self, t: float) -> None:
        self.n_observed += 1
        self._roll(t)
        self._counts[self._bin_of(t)] += 1
        self._recent.observe(t)

    # -- forecasting --------------------------------------------------------

    def _bin_stats(self, b: int) -> Tuple[float, float]:
        """Across-period (mean rate, standard error) for phase bin b."""
        k = len(self._profiles)
        vals = [p[b] for p in self._profiles]
        mean = sum(vals) / k
        if k >= 2:
            var = sum((v - mean) ** 2 for v in vals) / (k - 1)
            se = math.sqrt(var / k)
        else:
            # One completed period: Poisson se of the single bin count.
            se = math.sqrt(max(mean, 1.0 / self.bin_s) / self.bin_s)
        return mean, se

    def forecast(self, t: float, horizon_s: float) -> RateForecast:
        self._roll(t)
        if not self._profiles:
            # Cold start: no completed period yet. Report the reactive
            # EWMA view but with a floored lower band, so evidence-gated
            # consumers (the autoscaler) don't pay for structure we have
            # not actually observed.
            fb = self._recent.forecast(t, horizon_s)
            return RateForecast(
                at_s=t,
                horizon_s=horizon_s,
                rate_per_s=fb.rate_per_s,
                lower_per_s=0.0,
                upper_per_s=fb.upper_per_s,
                source=f"{self.name}:warmup",
            )
        # Integrate the mean profile (and band) over the phase window.
        horizon = max(horizon_s, 1e-12)
        pos = t
        remaining = horizon
        rate_w = 0.0
        se_w = 0.0
        while remaining > 1e-12:
            phase = pos - self._period_of(pos) * self.period_s
            b = min(int(phase / self.bin_s), self.n_bins - 1)
            seg = min(remaining, (b + 1) * self.bin_s - phase)
            if seg <= self.bin_s * 1e-9:
                # float edge at a bin boundary: the residual to the next
                # boundary can quantize to a denormal sliver that would
                # never drain ``remaining`` — step a full bin instead
                seg = min(remaining, self.bin_s)
            mean, se = self._bin_stats(b)
            rate_w += mean * seg
            se_w += se * seg
            pos += seg
            remaining -= seg
        rate = rate_w / horizon
        se = se_w / horizon
        lower, upper = _band(rate, se)
        return RateForecast(
            at_s=t,
            horizon_s=horizon_s,
            rate_per_s=rate,
            lower_per_s=lower,
            upper_per_s=upper,
            source=self.name,
            periods=len(self._profiles),
        )


ESTIMATORS: Dict[str, Callable[..., object]] = {
    WindowedRateEstimator.name: WindowedRateEstimator,
    EWMARateEstimator.name: EWMARateEstimator,
    SeasonalRateEstimator.name: SeasonalRateEstimator,
}


def make_estimator(
    name: str,
    *,
    window_s: float = 0.25,
    tau_s: float = 0.25,
    period_s: float = 1.0,
    n_bins: int = 16,
):
    """Build a named estimator with the knobs it understands."""
    if name == WindowedRateEstimator.name:
        return WindowedRateEstimator(window_s=window_s)
    if name == EWMARateEstimator.name:
        return EWMARateEstimator(tau_s=tau_s)
    if name == SeasonalRateEstimator.name:
        return SeasonalRateEstimator(period_s=period_s, n_bins=n_bins, tau_s=tau_s)
    raise ValueError(
        f"unknown estimator {name!r} (choose from {sorted(ESTIMATORS)})"
    )
