"""Forecast-driven autoscaling (jax-free, like the rest of the
scheduling stack).

``estimator.py`` turns the cluster's arrival stream into a rate forecast
with a confidence band (windowed / EWMA / seasonal-diurnal);
``policy.py`` converts the forecast into a target decode-capable device
count and gates each pre-warm re-partition on the predicted wave
amortizing the reconfiguration downtime + checkpoint rollback. The
cluster integration — the FORECAST_TICK event, pre-warm reservations,
``Cluster(policy="forecast")`` — lives in core/cluster.py and
core/queueing.py. See docs/autoscaling.md.
"""
from repro_torch.core.forecast.estimator import (  # noqa: F401
    ESTIMATORS,
    EWMARateEstimator,
    RateForecast,
    SeasonalRateEstimator,
    WindowedRateEstimator,
    make_estimator,
)
from repro_torch.core.forecast.policy import (  # noqa: F401
    AutoscaleDecision,
    ForecastConfig,
    forecast_provenance,
    next_tick,
    plan_autoscale,
    wave_amortizes,
)
