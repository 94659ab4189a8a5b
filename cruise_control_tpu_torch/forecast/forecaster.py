"""Deterministic, training-free workload forecaster (counterpart of
``cruise_control_tpu/forecast/forecaster.py``).

Model: per (entity, metric) series over the aggregator's completed windows,
a masked Holt double-exponential smoother (level + trend) blended with a
plain EWMA. Holt extrapolates the trend ``horizon`` windows ahead (the
pre-breach signal); the EWMA term anchors the blend so a single noisy
window cannot launch the forecast (Holt-Winters without the seasonal term —
the history ring is far shorter than any season).

Device shape: one launch of the hand-written K15 kernel
(``kernels/forecast.py``, ``csrc/forecast.cu``) over the dense
``f32[E, W, M]`` history, one thread per (entity, metric) series; the knobs
(alpha, beta, blend, horizon) are kernel arguments, so knob changes build
nothing. On a CPU device the kernel's plain twin runs. The history arrives
through the monitor's zero-copy window-view seam
(``LoadMonitor.partition_window_view``), so a steady tick with no new window
costs a cache-key comparison and nothing else.

No RNG anywhere: the forecast is a pure function of the history, so reruns
of the same (scenario, seed) are bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.env import resolve_device
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.kernels.forecast import forecast_batch
from cruise_control_tpu_torch.monitor.aggregator.sample_aggregator import Extrapolation
from cruise_control_tpu_torch.monitor.metricdef import (
    AggregationFunction,
    PARTITION_METRIC_DEF,
    PARTITION_METRIC_TO_RESOURCE,
)

# A resource's load is "predicted to rise" when forecast/current exceeds this
# ratio; below it the predicted detector treats the cluster as steady and does
# no optimizer work at all (the zero-new-compiles steady path).
RISE_THRESHOLD = 1.02

# Denominator floor for forecast/current ratios (units: CPU %, KB/s, MB — all
# far above this). Current loads at/below the floor yield scale 1.0: a series
# that has never carried load cannot signal a surge.
_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ForecastKnobs:
    """Forecast tuning (``forecast.*`` keys); alpha, beta, blend and the
    horizon in windows are K15's f32 arguments."""
    alpha: float = 0.45        # level / EWMA smoothing weight
    beta: float = 0.25         # trend smoothing weight
    blend: float = 0.5         # Holt weight in the Holt/EWMA blend
    horizon_ms: int = 300_000  # how far ahead the forecast looks
    max_scale: float = 8.0     # clamp on forecast/current load ratios


def forecast_reference(values, wmask, alpha, beta, blend, horizon_w):
    """Per-series python-loop reference of :func:`forecast_batch`, without
    the reference program's FMA contractions (tests only; O(E*W*M)
    python)."""
    values = np.asarray(values, np.float32)
    E, W, M = values.shape
    alpha = np.float32(alpha)
    beta = np.float32(beta)
    blend = np.float32(blend)
    horizon_w = np.float32(horizon_w)
    one = np.float32(1.0)
    out = np.zeros((E, M), np.float32)
    for e in range(E):
        for mi in range(M):
            level = trend = ewma = np.float32(0.0)
            seen = False
            for w in range(W):
                if not wmask[e, w]:
                    continue
                xi = values[e, w, mi]
                if not seen:
                    level, trend, ewma, seen = xi, np.float32(0.0), xi, True
                else:
                    lvl_s = alpha * xi + (one - alpha) * (level + trend)
                    trend = beta * (lvl_s - level) + (one - beta) * trend
                    level = lvl_s
                    ewma = alpha * xi + (one - alpha) * ewma
            if seen:
                fc = blend * (level + horizon_w * trend) + (one - blend) * ewma
                out[e, mi] = max(fc, np.float32(0.0))
    return out


@dataclasses.dataclass
class ForecastResult:
    """One horizon-ahead projection of the monitored workload."""
    entities: list                # aggregator row order (partition keys)
    forecast: np.ndarray          # f32[E, M] per-model-metric forecast
    last: np.ndarray              # f64[E, M] latest completed-window value
    scale: np.ndarray             # f64[E, NUM_RESOURCES] forecast/current ratio
    generation: tuple             # (load_generation, num_windows) stamp
    horizon_ms: int
    rising: bool                  # any per-resource scale above RISE_THRESHOLD

    def max_scale_per_resource(self) -> np.ndarray:
        """f64[NUM_RESOURCES] — the hottest predicted ratio per resource."""
        return (self.scale.max(axis=0) if self.scale.size
                else np.ones(NUM_RESOURCES))


class WorkloadForecaster:
    """Caching front-end: monitor window view in, :class:`ForecastResult` out.

    The forecast generation is ``(load_generation, num_windows)`` — it moves
    exactly when a new window rolls into the ring, so per-tick callers hit
    the memo until then. Knob changes invalidate the memo (new math).
    ``device`` is where K15 runs ("cuda" by default; "cpu" runs its twin)."""

    def __init__(self, monitor, knobs: ForecastKnobs | None = None, device="cuda"):
        self.device = resolve_device(device)
        self._monitor = monitor
        self._knobs = knobs or ForecastKnobs()
        self._cache: tuple[tuple, ForecastResult] | None = None
        self.forecasts_computed = 0
        self.cache_hits = 0

    @property
    def knobs(self) -> ForecastKnobs:
        return self._knobs

    def set_knobs(self, knobs: ForecastKnobs) -> None:
        self._knobs = knobs
        self._cache = None

    def forecast(self) -> ForecastResult | None:
        """Project the current history ``horizon_ms`` ahead; None when the
        ring holds fewer than 2 completed windows (no trend to read)."""
        agg, gen = self._monitor.partition_window_view()
        E = len(agg.entities)
        W = len(agg.window_starts_ms)
        if E == 0 or W < 2:
            return None
        key = (gen, W, self._knobs)
        if self._cache is not None and self._cache[0] == key:
            self.cache_hits += 1
            return self._cache[1]
        window_ms = agg.window_starts_ms[1] - agg.window_starts_ms[0]
        horizon_w = float(self._knobs.horizon_ms) / float(max(window_ms, 1))
        wmask = agg.extrapolations != Extrapolation.NO_VALID_EXTRAPOLATION
        fc = forecast_batch(
            torch.from_numpy(np.ascontiguousarray(agg.values, np.float32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(wmask)).to(self.device),
            np.float32(self._knobs.alpha), np.float32(self._knobs.beta),
            np.float32(self._knobs.blend), np.float32(horizon_w)).cpu().numpy()
        vals = np.asarray(agg.values)
        last = vals[:, -1, :]
        # The scale denominator must sit on the same reduction basis as the
        # model's load columns (_reduced_entity_loads): AVG metrics enter the
        # model as the masked mean over valid windows, LATEST metrics as the
        # last valid window. A last-window denominator lags the mean during a
        # ramp and biases forecast/current low — predictions then fire late.
        nvalid = np.maximum(wmask.sum(axis=1), 1)
        mean = (vals * wmask[:, :, None]).sum(axis=1) / nvalid[:, None]
        last_valid = vals[np.arange(E),
                          W - 1 - np.argmax(wmask[:, ::-1], axis=1), :]
        scale = np.ones((E, NUM_RESOURCES))
        for name, resource in PARTITION_METRIC_TO_RESOURCE.items():
            info = PARTITION_METRIC_DEF.info(name)
            mid = info.metric_id
            basis = (last_valid
                     if info.aggregation == AggregationFunction.LATEST
                     else mean)
            cur = basis[:, mid]
            ratio = fc[:, mid] / np.maximum(cur, _EPS)
            ratio = np.where(cur <= _EPS, 1.0, ratio)
            scale[:, resource] = np.clip(ratio, 0.0, self._knobs.max_scale)
        result = ForecastResult(
            entities=agg.entities, forecast=fc, last=last, scale=scale,
            generation=(gen, W), horizon_ms=self._knobs.horizon_ms,
            rising=bool((scale > RISE_THRESHOLD).any()))
        self._cache = (key, result)
        self.forecasts_computed += 1
        return result

    def state_json(self) -> dict:
        k = self._knobs
        out = {
            "horizonMs": k.horizon_ms,
            "alpha": k.alpha,
            "beta": k.beta,
            "blend": k.blend,
            "maxScale": k.max_scale,
            "forecastsComputed": self.forecasts_computed,
            "cacheHits": self.cache_hits,
        }
        if self._cache is not None:
            res = self._cache[1]
            out["generation"] = list(res.generation)
            out["rising"] = res.rising
            out["maxScalePerResource"] = [
                round(float(v), 4) for v in res.max_scale_per_resource()]
        return out
