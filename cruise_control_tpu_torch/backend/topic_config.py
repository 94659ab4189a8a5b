"""(Counterpart of ``cruise_control_tpu/backend/topic_config.py``, copied with the
port's imports.) TopicConfigProvider SPI.

Reference: config/TopicConfigProvider.java (KafkaCruiseControlConfig
``topic.config.provider.class``, default KafkaTopicConfigProvider): serves
per-topic config overlaid on the cluster default — the consumer here is the
concurrency adjuster's min-ISR safety check (``min.insync.replicas``).
"""
from __future__ import annotations

MIN_INSYNC_REPLICAS = "min.insync.replicas"


class TopicConfigProvider:
    """SPI: per-topic config maps."""

    def configure(self, config) -> None:
        pass

    def topic_config(self, topic: str) -> dict:
        raise NotImplementedError

    def min_insync_replicas(self, topic: str) -> int:
        return int(self.topic_config(topic).get(MIN_INSYNC_REPLICAS, 1))


class BackendTopicConfigProvider(TopicConfigProvider):
    """Reads topic configs from the cluster backend when it exposes them
    (``backend.topic_configs() -> {topic: {key: value}}``); topics without
    overrides fall back to the cluster default min.insync.replicas of 1."""

    def __init__(self, backend=None):
        self._backend = backend

    def attach(self, backend) -> None:
        self._backend = backend

    def topic_config(self, topic: str) -> dict:
        getter = getattr(self._backend, "topic_configs", None)
        if getter is None:
            return {}
        return getter().get(topic, {})
