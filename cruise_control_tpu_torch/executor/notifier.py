"""(Counterpart of ``cruise_control_tpu/executor/notifier.py``, with the port's imports.)
ExecutorNotifier SPI.

Reference: executor/ExecutorNotifier.java (ExecutorConfig
``executor.notifier.class``): notified once per finished proposal execution
with the outcome, so deployments can page/post on completion independently of
the anomaly notifier.
"""
from __future__ import annotations

import dataclasses
import logging

LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ExecutorNotification:
    """Outcome of one proposal execution (ExecutorNotification.java field
    role: what ran, who asked for it, how it ended)."""
    operation: str          # e.g. "rebalance", "self-healing:BROKER_FAILURE"
    success: bool
    stopped_by_user: bool
    num_replica_movements: int
    num_leadership_movements: int
    detail: str = ""

    def summary(self) -> str:
        state = ("stopped" if self.stopped_by_user
                 else "succeeded" if self.success else "FAILED")
        return (f"execution {state}: {self.operation} "
                f"({self.num_replica_movements} moves, "
                f"{self.num_leadership_movements} leadership)"
                + (f" — {self.detail}" if self.detail else ""))


class ExecutorNotifier:
    """SPI: receives an ExecutorNotification when an execution finishes."""

    def configure(self, config) -> None:
        pass

    def on_execution_finished(self, notification: ExecutorNotification) -> None:
        raise NotImplementedError


class LoggingExecutorNotifier(ExecutorNotifier):
    """Default: log the outcome (ExecutorNotifier's reference default logs
    via OPERATION_LOGGER)."""

    def __init__(self):
        self.notifications: list[ExecutorNotification] = []  # inspectable

    def on_execution_finished(self, notification: ExecutorNotification) -> None:
        self.notifications.append(notification)
        (LOG.info if notification.success else LOG.warning)(
            "%s", notification.summary())
