"""(Counterpart of ``cruise_control_tpu/monitor/metricdef.py``, copied with the
port's imports.) Metric taxonomy: raw broker/topic/partition metrics -> model metrics.

Reference:
- cruise-control-metrics-reporter/.../metric/RawMetricType.java:26-95 — the 63
  raw types emitted by the in-broker reporter, scoped BROKER/TOPIC/PARTITION.
- cruise-control/.../monitor/metricdefinition/KafkaMetricDef.java:42-137 — maps
  raw types onto ~20 model metrics, each with an aggregation function
  (AVG / MAX / LATEST) and a resource group.
- cruise-control-core/.../metricdef/MetricDef.java — name <-> id registry.

The model-metric ids here are stable column indices used by the aggregator's
dense [entity, window, metric] arrays.
"""
from __future__ import annotations

import dataclasses
import enum

from cruise_control_tpu_torch.common.resources import Resource


class MetricScope(enum.Enum):
    BROKER = "BROKER"
    TOPIC = "TOPIC"
    PARTITION = "PARTITION"


class AggregationFunction(enum.Enum):
    AVG = "AVG"
    MAX = "MAX"
    LATEST = "LATEST"


# ---------------------------------------------------------------------------
# Raw metric types (RawMetricType.java:26-95; same names, same scopes)
# ---------------------------------------------------------------------------
_BROKER_RAW = [
    "ALL_TOPIC_BYTES_IN", "ALL_TOPIC_BYTES_OUT", "ALL_TOPIC_REPLICATION_BYTES_IN",
    "ALL_TOPIC_REPLICATION_BYTES_OUT", "ALL_TOPIC_FETCH_REQUEST_RATE",
    "ALL_TOPIC_PRODUCE_REQUEST_RATE", "ALL_TOPIC_MESSAGES_IN_PER_SEC",
    "BROKER_PRODUCE_REQUEST_RATE", "BROKER_CONSUMER_FETCH_REQUEST_RATE",
    "BROKER_FOLLOWER_FETCH_REQUEST_RATE", "BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT",
    "BROKER_REQUEST_QUEUE_SIZE", "BROKER_RESPONSE_QUEUE_SIZE",
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX", "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN",
    "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX", "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN",
    "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX", "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN",
    "BROKER_PRODUCE_TOTAL_TIME_MS_MAX", "BROKER_PRODUCE_TOTAL_TIME_MS_MEAN",
    "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX", "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN",
    "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX", "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN",
    "BROKER_PRODUCE_LOCAL_TIME_MS_MAX", "BROKER_PRODUCE_LOCAL_TIME_MS_MEAN",
    "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX", "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN",
    "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX", "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN",
    "BROKER_LOG_FLUSH_RATE", "BROKER_LOG_FLUSH_TIME_MS_MAX", "BROKER_LOG_FLUSH_TIME_MS_MEAN",
    "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH", "BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_999TH",
    "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_50TH", "BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_999TH",
    "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_50TH", "BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_999TH",
    "BROKER_PRODUCE_TOTAL_TIME_MS_50TH", "BROKER_PRODUCE_TOTAL_TIME_MS_999TH",
    "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_50TH", "BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_999TH",
    "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_50TH", "BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_999TH",
    "BROKER_PRODUCE_LOCAL_TIME_MS_50TH", "BROKER_PRODUCE_LOCAL_TIME_MS_999TH",
    "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_50TH", "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH",
    "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_50TH", "BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH",
    "BROKER_LOG_FLUSH_TIME_MS_50TH", "BROKER_LOG_FLUSH_TIME_MS_999TH",
    "BROKER_CPU_UTIL",
]
_TOPIC_RAW = [
    "TOPIC_BYTES_IN", "TOPIC_BYTES_OUT", "TOPIC_REPLICATION_BYTES_IN",
    "TOPIC_REPLICATION_BYTES_OUT", "TOPIC_FETCH_REQUEST_RATE",
    "TOPIC_PRODUCE_REQUEST_RATE", "TOPIC_MESSAGES_IN_PER_SEC",
]
_PARTITION_RAW = ["PARTITION_SIZE"]

RAW_METRIC_TYPES: dict[str, MetricScope] = {}
for _n in _BROKER_RAW:
    RAW_METRIC_TYPES[_n] = MetricScope.BROKER
for _n in _TOPIC_RAW:
    RAW_METRIC_TYPES[_n] = MetricScope.TOPIC
for _n in _PARTITION_RAW:
    RAW_METRIC_TYPES[_n] = MetricScope.PARTITION


@dataclasses.dataclass(frozen=True)
class MetricInfo:
    name: str
    metric_id: int
    aggregation: AggregationFunction
    group: str  # resource group name ("CPU"/"NW_IN"/"NW_OUT"/"DISK" or "")


class MetricDef:
    """Registry mapping metric name <-> id (core MetricDef.java role)."""

    def __init__(self, infos: list[MetricInfo]):
        self._by_name = {m.name: m for m in infos}
        self._by_id = {m.metric_id: m for m in infos}
        if len(self._by_id) != len(infos):
            raise ValueError("duplicate metric ids")

    def info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def info_by_id(self, metric_id: int) -> MetricInfo:
        return self._by_id[metric_id]

    def all(self) -> list[MetricInfo]:
        return sorted(self._by_name.values(), key=lambda m: m.metric_id)

    @property
    def num_metrics(self) -> int:
        return len(self._by_name)

    def ids_in_group(self, group: str) -> list[int]:
        return [m.metric_id for m in self.all() if m.group == group]


def _defs(entries) -> MetricDef:
    return MetricDef([MetricInfo(name, i, agg, group)
                      for i, (name, agg, group) in enumerate(entries)])


# Partition-entity model metrics (KafkaMetricDef COMMON_METRIC_DEF subset):
A = AggregationFunction
PARTITION_METRIC_DEF = _defs([
    ("CPU_USAGE", A.AVG, "CPU"),
    ("DISK_USAGE", A.LATEST, "DISK"),
    ("LEADER_BYTES_IN", A.AVG, "NW_IN"),
    ("LEADER_BYTES_OUT", A.AVG, "NW_OUT"),
    ("FOLLOWER_BYTES_IN", A.AVG, "NW_IN"),
    ("REPLICATION_BYTES_IN_RATE", A.AVG, "NW_IN"),
    ("REPLICATION_BYTES_OUT_RATE", A.AVG, "NW_OUT"),
    ("MESSAGE_IN_RATE", A.AVG, ""),
    ("PRODUCE_RATE", A.AVG, ""),
    ("FETCH_RATE", A.AVG, ""),
])

# Broker-entity model metrics (KafkaMetricDef BROKER_METRIC_DEF subset):
BROKER_METRIC_DEF = _defs([
    ("BROKER_CPU_UTIL", A.AVG, "CPU"),
    ("ALL_TOPIC_BYTES_IN", A.AVG, "NW_IN"),
    ("ALL_TOPIC_BYTES_OUT", A.AVG, "NW_OUT"),
    ("ALL_TOPIC_REPLICATION_BYTES_IN", A.AVG, "NW_IN"),
    ("ALL_TOPIC_REPLICATION_BYTES_OUT", A.AVG, "NW_OUT"),
    ("BROKER_PRODUCE_REQUEST_RATE", A.AVG, ""),
    ("BROKER_CONSUMER_FETCH_REQUEST_RATE", A.AVG, ""),
    ("BROKER_FOLLOWER_FETCH_REQUEST_RATE", A.AVG, ""),
    ("BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT", A.AVG, ""),
    ("BROKER_LOG_FLUSH_RATE", A.AVG, ""),
    ("BROKER_LOG_FLUSH_TIME_MS_MEAN", A.AVG, ""),
    ("BROKER_LOG_FLUSH_TIME_MS_999TH", A.AVG, ""),
    ("BROKER_PRODUCE_LOCAL_TIME_MS_MEAN", A.AVG, ""),
    ("BROKER_PRODUCE_LOCAL_TIME_MS_999TH", A.AVG, ""),
    ("BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN", A.AVG, ""),
    ("BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN", A.AVG, ""),
])

# Mapping of partition model metric -> Resource column for ClusterTensor loads
PARTITION_METRIC_TO_RESOURCE = {
    "CPU_USAGE": Resource.CPU,
    "LEADER_BYTES_IN": Resource.NW_IN,
    "LEADER_BYTES_OUT": Resource.NW_OUT,
    "DISK_USAGE": Resource.DISK,
}
