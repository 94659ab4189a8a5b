"""(Counterpart of ``cruise_control_tpu/detector/topic_anomaly.py``, with the port's imports.)
Topic anomaly finders.

Reference: detector/TopicAnomalyDetector.java (52),
TopicReplicationFactorAnomalyFinder.java (topics whose RF differs from the
desired RF) and PartitionSizeAnomalyFinder.java (partitions larger than the
configured threshold).
"""
from __future__ import annotations

from cruise_control_tpu_torch.detector.anomalies import AnomalyType, TopicAnomaly


class TopicReplicationFactorAnomalyFinder:
    def __init__(self, target_rf: int = 3):
        self.target_rf = target_rf

    def configure(self, config, **extra):
        if config is not None:
            self.target_rf = config.get_int("self.healing.target.topic.replication.factor")

    def anomalies(self, backend, now_ms: float) -> list:
        bad: dict[str, dict] = {}
        for (topic, _p), info in backend.partitions().items():
            rf = len(info.replicas)
            if rf != self.target_rf:
                entry = bad.setdefault(topic, {"targetRF": self.target_rf,
                                               "partitionsWithBadRF": 0})
                entry["partitionsWithBadRF"] += 1
        if not bad:
            return []
        return [TopicAnomaly(
            anomaly_type=AnomalyType.TOPIC_ANOMALY, detected_ms=now_ms,
            bad_topics=bad,
            description=f"topics with replication factor != {self.target_rf}: "
                        f"{sorted(bad)}")]


class PartitionSizeAnomalyFinder:
    def __init__(self, threshold_mb: float = 1_000_000.0):
        self.threshold_mb = threshold_mb

    def configure(self, config, **extra):
        if config is not None:
            self.threshold_mb = config.get_double("provision.partition.size.threshold.mb")

    def anomalies(self, backend, now_ms: float) -> list:
        oversized = {f"{t}-{p}": info.size_mb
                     for (t, p), info in backend.partitions().items()
                     if info.size_mb > self.threshold_mb}
        if not oversized:
            return []
        return [TopicAnomaly(
            anomaly_type=AnomalyType.TOPIC_ANOMALY, detected_ms=now_ms,
            bad_topics={}, fixable=False,
            description=f"oversized partitions (> {self.threshold_mb} MB): "
                        f"{sorted(oversized)}")]
