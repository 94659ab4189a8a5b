"""(Counterpart of ``cruise_control_tpu/detector/maintenance.py``, with the port's imports.)
Maintenance events.

Reference: detector/MaintenanceEventDetector.java (83) +
MaintenanceEventTopicReader.java — operators submit maintenance plans
(ADD_BROKER/REMOVE_BROKER/DEMOTE_BROKER/REBALANCE/FIX_OFFLINE_REPLICAS/
TOPIC_REPLICATION_FACTOR) to a Kafka topic; IdempotenceCache.java dedups
re-delivered plans. Here the reader SPI pulls from a JSONL spool directory
(one plan per line: {"type": "REMOVE_BROKER", "brokers": [3], "ts": ...}).
"""
from __future__ import annotations

import json
import os

from cruise_control_tpu_torch.detector.anomalies import AnomalyType, MaintenanceEvent


class IdempotenceCache:
    """Drops plans already seen within the retention window, remembering at
    most ``max_size`` recent plans (detector/IdempotenceCache.java;
    AnomalyDetectorConfig maintenance.event.{enable.idempotence,
    max.idempotence.cache.size, idempotence.retention.ms}). ``enabled=False``
    turns the cache into a pass-through."""

    def __init__(self, retention_ms: float = 180_000.0, max_size: int = 25,
                 enabled: bool = True):
        self._retention = retention_ms
        self._max = max_size
        self._enabled = enabled
        self._seen: dict[str, float] = {}

    def seen_before(self, key: str, now_ms: float) -> bool:
        if not self._enabled:
            return False
        self._seen = {k: t for k, t in self._seen.items()
                      if now_ms - t < self._retention}
        if key in self._seen:
            return True
        if len(self._seen) >= self._max:
            oldest = min(self._seen, key=self._seen.get)
            del self._seen[oldest]
        self._seen[key] = now_ms
        return False


def _event_from_dict(d: dict, now_ms: float, event_cls=MaintenanceEvent):
    """One parsed plan dict -> MaintenanceEvent (shared by every reader);
    ``event_cls`` is the pluggable maintenance.event.class."""
    return event_cls(
        anomaly_type=AnomalyType.MAINTENANCE_EVENT,
        detected_ms=now_ms, plan_type=d.get("type", ""),
        brokers=d.get("brokers", []), topics=d.get("topics", {}),
        description=f"maintenance plan {d.get('type')}")


class FileMaintenanceEventReader:
    def __init__(self, path: str = ""):
        self._path = path
        self._offset = 0
        self._event_cls = MaintenanceEvent

    def configure(self, config, **extra):
        path = extra.get("path") or (config.get_string("maintenance.event.path")
                                     if config is not None else "")
        if path:
            self._path = path
        if config is not None:
            self._event_cls = (config.get_class("maintenance.event.class")
                               or MaintenanceEvent)

    def read_events(self, now_ms: float) -> list:
        if not self._path:
            return []
        spool = os.path.join(self._path, "maintenance_events.jsonl")
        if not os.path.exists(spool):
            return []
        events = []
        with open(spool) as f:
            f.seek(self._offset)
            for line in f:
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                events.append(_event_from_dict(d, now_ms, self._event_cls))
            self._offset = f.tell()
        return events


class TopicMaintenanceEventReader:
    """Maintenance plans consumed from a TOPIC transport
    (detector/MaintenanceEventTopicReader.java role: the reference reads the
    __MaintenanceEvent Kafka topic from a stored offset forward; here the
    same length-prefixed topic-log transport the metrics reporter uses,
    reporter/topic.FileMetricsTopic, carries JSON-encoded plans and the
    reader tracks its consumer offset). Producers submit with
    :func:`submit_maintenance_plan`."""

    def __init__(self, path: str = ""):
        self._path = path
        self._topic = None
        self._offset = 0
        self._event_cls = MaintenanceEvent

    def configure(self, config, **extra):
        path = extra.get("path") or (
            config.get_string("maintenance.event.topic.path")
            if config is not None else "")
        if path:
            self._path = path
        if config is not None:
            self._event_cls = (config.get_class("maintenance.event.class")
                               or MaintenanceEvent)

    def _ensure(self):
        if self._topic is None and self._path:
            from cruise_control_tpu_torch.reporter.topic import FileMetricsTopic
            self._topic = FileMetricsTopic(self._path)
        return self._topic

    def read_events(self, now_ms: float) -> list:
        topic = self._ensure()
        if topic is None:
            return []
        events = []
        for next_offset, payload in topic.consume(self._offset):
            self._offset = next_offset
            try:
                d = json.loads(payload.decode())
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            events.append(_event_from_dict(d, now_ms, self._event_cls))
        return events


def submit_maintenance_plan(path: str, plan_type: str, brokers=(),
                            topics=None) -> None:
    """Operator-side producer (MaintenanceEventTopicReader's write
    counterpart): append one plan to the maintenance topic log."""
    from cruise_control_tpu_torch.reporter.topic import FileMetricsTopic
    FileMetricsTopic(path).append([json.dumps(
        {"type": plan_type, "brokers": list(brokers),
         "topics": dict(topics or {})}).encode()])
