"""(Counterpart of ``cruise_control_tpu/detector/notifier.py``, with the port's imports.)
Anomaly notifiers.

Reference: detector/notifier/AnomalyNotifier.java SPI returning a
FIX / CHECK(delay) / IGNORE verdict per anomaly;
SelfHealingNotifier.java — per-type self-healing enable switches + the
broker-failure grace ladder (alert after broker.failure.alert.threshold.ms,
self-heal after broker.failure.self.healing.threshold.ms);
SlackSelfHealingNotifier / AlertaSelfHealingNotifier (webhook alerting — here
a pluggable alert sink since the environment has no egress); NoopNotifier.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import logging

from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType, BrokerFailures

LOG = logging.getLogger("cruise_control_tpu_torch.notifier")


class Action(enum.Enum):
    FIX = "FIX"
    CHECK = "CHECK"
    IGNORE = "IGNORE"


@dataclasses.dataclass
class NotificationResult:
    action: Action
    delay_ms: float = 0.0


class NoopNotifier:
    def configure(self, config, **extra):
        pass

    def on_anomaly(self, anomaly: Anomaly, now_ms: float) -> NotificationResult:
        return NotificationResult(Action.IGNORE)

    def self_healing_enabled(self) -> dict:
        return {t.name: False for t in AnomalyType}


class SelfHealingNotifier:
    """SelfHealingNotifier.java analogue."""

    def __init__(self):
        self._enabled: dict[AnomalyType, bool] = {t: False for t in AnomalyType}
        self.alert_threshold_ms = 900_000.0
        self.self_healing_threshold_ms = 1_800_000.0
        # fixability gate (AnomalyDetectorConfig fixable.failed.broker.
        # {count,percentage}.threshold): mass failures look like a network
        # partition — self-healing must not try to evacuate half the cluster
        self.fixable_broker_count_threshold = 10
        self.fixable_broker_pct_threshold = 0.4
        self._num_brokers = lambda: 0   # live cluster size supplier
        self._alert_sink = None     # callable(dict) for Slack/Alerta-style fanout
        self._alerted: set[int] = set()

    def configure(self, config, alert_sink=None, **extra):
        if config is not None:
            master = config.get_boolean("self.healing.enabled")
            per_type = {
                AnomalyType.BROKER_FAILURE: "broker.failures.self.healing.enabled",
                AnomalyType.GOAL_VIOLATION: "goal.violations.self.healing.enabled",
                AnomalyType.DISK_FAILURE: "disk.failures.self.healing.enabled",
                AnomalyType.METRIC_ANOMALY: "metric.anomaly.self.healing.enabled",
                AnomalyType.TOPIC_ANOMALY: "topic.anomaly.self.healing.enabled",
                AnomalyType.MAINTENANCE_EVENT: "maintenance.event.self.healing.enabled",
                AnomalyType.PREDICTED_GOAL_VIOLATION:
                    "predicted.goal.violations.self.healing.enabled",
            }
            for t, key in per_type.items():
                explicit = config.get(key)
                self._enabled[t] = master if explicit is None else bool(explicit)
            self.alert_threshold_ms = float(config.get_int("broker.failure.alert.threshold.ms"))
            self.self_healing_threshold_ms = float(
                config.get_int("broker.failure.self.healing.threshold.ms"))
            self.fixable_broker_count_threshold = config.get_int(
                "fixable.failed.broker.count.threshold")
            self.fixable_broker_pct_threshold = config.get_double(
                "fixable.failed.broker.percentage.threshold")
        if alert_sink is not None:
            self._alert_sink = alert_sink
        if extra.get("num_brokers_supplier") is not None:
            self._num_brokers = extra["num_brokers_supplier"]

    def set_self_healing(self, anomaly_type: AnomalyType, enabled: bool) -> None:
        self._enabled[anomaly_type] = enabled

    def self_healing_enabled(self) -> dict:
        return {t.name: v for t, v in self._enabled.items()}

    def _alert(self, anomaly: Anomaly, auto_fix: bool) -> None:
        if anomaly.anomaly_id in self._alerted:
            return
        self._alerted.add(anomaly.anomaly_id)
        payload = {"anomaly": anomaly.to_json(), "autoFixTriggered": auto_fix}
        LOG.warning("anomaly alert: %s", json.dumps(payload))
        if self._alert_sink is not None:
            try:
                self._alert_sink(payload)
            except Exception:          # alert failure must not break detection
                LOG.exception("alert sink failed")

    def on_anomaly(self, anomaly: Anomaly, now_ms: float) -> NotificationResult:
        enabled = self._enabled.get(anomaly.anomaly_type, False)
        if isinstance(anomaly, BrokerFailures):
            # mass failures are unfixable by evacuation (fixable.failed.
            # broker.*.threshold): alert only, never FIX. The percentage
            # check needs the live cluster size; when no supplier was wired
            # (size 0 = unknown) only the absolute count gate applies.
            n_failed = len(anomaly.failed_brokers)
            n_total = self._num_brokers()
            if (n_failed > self.fixable_broker_count_threshold
                    or (n_total > 0 and n_failed / n_total
                        > self.fixable_broker_pct_threshold)):
                self._alert(anomaly, auto_fix=False)
                return NotificationResult(Action.IGNORE)
            # grace ladder: wait, then alert, then fix
            first_failure = min(anomaly.failed_brokers.values(), default=now_ms)
            alert_at = first_failure + self.alert_threshold_ms
            fix_at = first_failure + self.self_healing_threshold_ms
            if now_ms < alert_at:
                return NotificationResult(Action.CHECK, alert_at - now_ms)
            if now_ms < fix_at:
                self._alert(anomaly, auto_fix=False)
                return NotificationResult(Action.CHECK, fix_at - now_ms)
            self._alert(anomaly, auto_fix=enabled)
            return NotificationResult(Action.FIX if enabled else Action.IGNORE)
        self._alert(anomaly, auto_fix=enabled)
        if not enabled or not anomaly.fixable:
            return NotificationResult(Action.IGNORE)
        return NotificationResult(Action.FIX)


def _post_json(url: str, payload: dict, headers: dict | None = None,
               timeout_s: float = 10.0) -> None:
    import urllib.request
    data = json.dumps(payload).encode("utf-8")
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout_s):
        pass


class SlackSelfHealingNotifier(SelfHealingNotifier):
    """Slack webhook alerting (SlackSelfHealingNotifier.java: posts
    {text, channel, username, icon_emoji} to slack.self.healing.notifier.webhook)."""

    def __init__(self, webhook: str = "", channel: str = "",
                 user: str = "Cruise Control", icon: str = ":information_source:"):
        super().__init__()
        self.webhook = webhook
        self.channel = channel
        self.user = user
        self.icon = icon
        self._alert_sink = self._post

    def configure(self, config, **extra):
        if config is not None:
            self.webhook = config.get_string(
                "slack.self.healing.notifier.webhook") or self.webhook
            self.channel = config.get_string(
                "slack.self.healing.notifier.channel") or self.channel
        super().configure(config, alert_sink=self._post, **extra)

    def _post(self, payload: dict) -> None:
        if not self.webhook:
            return
        text = (f"{payload['anomaly'].get('type', 'ANOMALY')}: "
                f"{payload['anomaly'].get('description', '')} "
                f"(autoFixTriggered={payload['autoFixTriggered']})")
        _post_json(self.webhook, {"text": text, "channel": self.channel,
                                  "username": self.user,
                                  "icon_emoji": self.icon})


class AlertaSelfHealingNotifier(SelfHealingNotifier):
    """Alerta API alerting (AlertaSelfHealingNotifier.java: POSTs AlertaMessage
    objects to alerta.self.healing.notifier.api.url with an API key)."""

    def __init__(self, api_url: str = "", api_key: str = "",
                 environment: str = "Production"):
        super().__init__()
        self.api_url = api_url
        self.api_key = api_key
        self.environment = environment
        self._alert_sink = self._post

    def configure(self, config, **extra):
        if config is not None:
            self.api_url = config.get_string(
                "alerta.self.healing.notifier.api.url") or self.api_url
            self.api_key = config.get_string(
                "alerta.self.healing.notifier.api.key") or self.api_key
            self.environment = config.get_string(
                "alerta.self.healing.notifier.environment") or self.environment
        super().configure(config, alert_sink=self._post, **extra)

    def _post(self, payload: dict) -> None:
        if not self.api_url:
            return
        anomaly = payload["anomaly"]
        _post_json(
            f"{self.api_url.rstrip('/')}/alert",
            {"environment": self.environment,
             "event": anomaly.get("type", "ANOMALY"),
             "resource": "cruise-control",
             "severity": "critical" if payload["autoFixTriggered"] else "warning",
             "text": anomaly.get("description", ""),
             "service": ["cruise-control"]},
            headers={"Authorization": f"Key {self.api_key}"} if self.api_key else {})


class AlertFileNotifier(SelfHealingNotifier):
    """Stands in for Slack/Alerta webhook notifiers (zero-egress environment):
    appends alert JSON lines to a file."""

    def __init__(self, path: str = ""):
        super().__init__()
        self._path = path

    def configure(self, config, **extra):
        super().configure(config, alert_sink=self._append, **extra)

    def _append(self, payload: dict) -> None:
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(payload) + "\n")
