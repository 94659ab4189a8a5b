"""(Counterpart of ``cruise_control_tpu/detector/metric_anomaly.py``, with the port's imports.)
Percentile-based metric anomaly finding.

Reference: cruise-control-core/.../detector/metricanomaly/
PercentileMetricAnomalyFinder.java — a broker metric is anomalous when its
latest value exceeds the upper-percentile (default 95th) of its own history
scaled up, or falls below the lower percentile (default 2nd); and
MetricAnomalyFinder SPI (core detector/metricanomaly/MetricAnomalyFinder.java).
"""
from __future__ import annotations

import numpy as np

from cruise_control_tpu_torch.detector.anomalies import AnomalyType, MetricAnomaly


class PercentileMetricAnomalyFinder:
    """Finds brokers whose interested metrics spike vs their own history."""

    INTERESTED_METRICS = ("BROKER_LOG_FLUSH_TIME_MS_999TH",
                          "BROKER_PRODUCE_LOCAL_TIME_MS_999TH")

    def __init__(self, upper_percentile: float = 95.0, lower_percentile: float = 2.0,
                 upper_margin: float = 0.5, lower_margin: float = 0.2,
                 anomaly_cls=MetricAnomaly):
        self.upper_percentile = upper_percentile
        self.lower_percentile = lower_percentile
        self.upper_margin = upper_margin
        self.lower_margin = lower_margin
        self._anomaly_cls = anomaly_cls   # metric.anomaly.class

    def configure(self, config, **extra):
        if config is not None:
            self.upper_percentile = config.get_double(
                "metric.anomaly.percentile.upper.threshold")
            self.lower_percentile = config.get_double(
                "metric.anomaly.percentile.lower.threshold")
            cls = config.get_class("metric.anomaly.class")
            if cls is not None:
                self._anomaly_cls = cls

    def anomalies(self, history: dict, current: dict, now_ms: float) -> list:
        """history: broker -> {metric: np.ndarray of past window values};
        current: broker -> {metric: latest value}."""
        out = []
        for broker, metrics in current.items():
            hist = history.get(broker, {})
            for name in self.INTERESTED_METRICS:
                if name not in metrics or name not in hist:
                    continue
                h = np.asarray(hist[name], dtype=float)
                if h.size < 5:           # not enough history to judge
                    continue
                cur = float(metrics[name])
                upper = np.percentile(h, self.upper_percentile) * (1 + self.upper_margin)
                lower = np.percentile(h, self.lower_percentile) * self.lower_margin
                if cur > upper or (lower > 0 and cur < lower):
                    out.append(self._anomaly_cls(
                        anomaly_type=AnomalyType.METRIC_ANOMALY, detected_ms=now_ms,
                        broker_ids=[broker], metric_name=name,
                        description=f"broker {broker} {name}={cur:.2f} outside "
                                    f"[{lower:.2f}, {upper:.2f}]"))
        return out
