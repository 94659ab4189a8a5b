"""Predictive control plane: training-free workload forecasting
(counterpart of ``cruise_control_tpu/forecast/``; K15 is
``kernels/forecast.py``).

The reactive loops (detector/, analyzer/) act only on the *current* windowed
load; this package projects each partition's per-metric history forward a
configurable horizon so goal violations can be detected — and healed —
before they exist. See docs/DESIGN.md §21.
"""
from cruise_control_tpu_torch.forecast.forecaster import (
    ForecastKnobs,
    ForecastResult,
    WorkloadForecaster,
    forecast_batch,
    forecast_reference,
)

__all__ = [
    "ForecastKnobs",
    "ForecastResult",
    "WorkloadForecaster",
    "forecast_batch",
    "forecast_reference",
]
