"""(Counterpart of ``cruise_control_tpu/detector/anomalies.py``, with the port's imports.)
Anomaly types + self-healing fix plans.

Reference: detector/ KafkaAnomaly subclasses (GoalViolations.java,
BrokerFailures.java, DiskFailures.java, SlowBrokers.java, TopicAnomaly,
MaintenanceEvent) and notifier/KafkaAnomalyType.java (priority order:
BROKER_FAILURE=0, MAINTENANCE_EVENT=1, DISK_FAILURE=2, METRIC_ANOMALY=3,
GOAL_VIOLATION=4, TOPIC_ANOMALY=5 — smaller = handled first). Each anomaly's
``fix(cruise_control)`` routes through the same optimizer/executor path as the
REST handlers (RemoveBrokersRunnable / RebalanceRunnable /
FixOfflineReplicasRunnable role).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time


class AnomalyType(enum.IntEnum):
    """Smaller value = higher handling priority (KafkaAnomalyType.java:32-42).

    PREDICTED_GOAL_VIOLATION is ours (no reference analogue): a goal breach
    the forecast subsystem expects within the horizon but which does not
    exist yet. Deliberately the LOWEST priority — every real, present
    anomaly heals before a speculative one."""
    BROKER_FAILURE = 0
    MAINTENANCE_EVENT = 1
    DISK_FAILURE = 2
    METRIC_ANOMALY = 3
    GOAL_VIOLATION = 4
    TOPIC_ANOMALY = 5
    PREDICTED_GOAL_VIOLATION = 6


_seq = itertools.count()


@dataclasses.dataclass
class Anomaly:
    anomaly_type: AnomalyType
    detected_ms: float
    description: str = ""
    anomaly_id: int = dataclasses.field(default_factory=lambda: next(_seq))
    fixable: bool = True

    # explicit causal-span handle for the fix path (common/tracing.Span):
    # the detector manager sets it around fix() via fix_with_span so each
    # fix can parent its facade operation span — an explicit handle on the
    # anomaly object, never thread-local/context magic (class attribute,
    # not a dataclass field: to_json and field order stay untouched)
    fix_span = None

    def fix(self, cruise_control) -> dict | None:
        """Self-heal through the facade; returns an operation summary."""
        return None

    def fix_with_span(self, cruise_control, span=None) -> dict | None:
        """Run the fix with ``span`` (the manager's verdict span) as the
        explicit parent handle for the operation it dispatches."""
        self.fix_span = span
        try:
            return self.fix(cruise_control)
        finally:
            self.fix_span = None

    def sort_key(self):
        return (int(self.anomaly_type), self.detected_ms, self.anomaly_id)

    def to_json(self) -> dict:
        return {"anomalyId": self.anomaly_id, "type": self.anomaly_type.name,
                "detectedMs": self.detected_ms, "description": self.description,
                "fixable": self.fixable}


@dataclasses.dataclass
class BrokerFailures(Anomaly):
    failed_brokers: dict = dataclasses.field(default_factory=dict)  # id -> failure ts

    def fix(self, cruise_control):
        """RemoveBrokersRunnable role: move all replicas off the dead brokers
        using self-healing goals."""
        return cruise_control.remove_brokers(
            sorted(self.failed_brokers), self_healing=True,
            reason=f"self-healing broker failure: {sorted(self.failed_brokers)}",
            parent_span=self.fix_span)


@dataclasses.dataclass
class DiskFailures(Anomaly):
    failed_disks: dict = dataclasses.field(default_factory=dict)  # broker -> [logdir]

    def fix(self, cruise_control):
        """FixOfflineReplicasRunnable role."""
        return cruise_control.fix_offline_replicas(
            self_healing=True,
            reason=f"self-healing disk failure: {self.failed_disks}",
            parent_span=self.fix_span)


@dataclasses.dataclass
class GoalViolations(Anomaly):
    violated_goals_fixable: list = dataclasses.field(default_factory=list)
    violated_goals_unfixable: list = dataclasses.field(default_factory=list)

    def fix(self, cruise_control):
        if not self.violated_goals_fixable:
            return None
        return cruise_control.rebalance(
            self_healing=True, triggered_by_goal_violation=True,
            reason=f"self-healing goal violation: {self.violated_goals_fixable}",
            parent_span=self.fix_span)


@dataclasses.dataclass
class PredictedGoalViolations(Anomaly):
    """A forecast-horizon goal breach that does not exist yet.

    Unlike :class:`GoalViolations` the fix does NOT re-optimize the current
    (still clean) state — that round would be a no-op. The detector already
    optimized the forecast-scaled model when it emitted this anomaly; the
    fix executes those precomputed proposals through the facade's normal
    operation-span -> pipeline/executor path, so the heal lands BEFORE the
    breach with full span lineage."""
    violated_goals_fixable: list = dataclasses.field(default_factory=list)
    violated_goals_unfixable: list = dataclasses.field(default_factory=list)
    optimizer_result: object = None   # OptimizerResult on the forecast state
    forecast_generation: tuple = ()   # (load_generation, num_windows) stamp
    horizon_ms: int = 0

    def fix(self, cruise_control):
        if not self.violated_goals_fixable or self.optimizer_result is None:
            return None
        out = cruise_control.execute_precomputed(
            self.optimizer_result, operation="forecast_heal",
            reason=(f"pre-breach heal, predicted violation in "
                    f"{self.horizon_ms} ms: {self.violated_goals_fixable}"),
            self_healing=True, parent_span=self.fix_span)
        if cruise_control.speculative_proposals_enabled:
            # speculative precompute: the post-heal state is the best guess
            # at the next /proposals answer — install it now, stamped; the
            # generation rules drop it if the prediction does not hold
            cruise_control.refresh_speculative_proposals()
        return out


@dataclasses.dataclass
class MetricAnomaly(Anomaly):
    broker_ids: list = dataclasses.field(default_factory=list)
    metric_name: str = ""

    def fix(self, cruise_control):
        return None  # reference default: alert only (fix via SlowBrokers)


@dataclasses.dataclass
class SlowBrokers(Anomaly):
    slow_brokers: dict = dataclasses.field(default_factory=dict)  # id -> score
    remove: bool = False

    def fix(self, cruise_control):
        brokers = sorted(self.slow_brokers)
        if self.remove:
            return cruise_control.remove_brokers(
                brokers, self_healing=True,
                reason=f"self-healing slow broker removal: {brokers}",
                parent_span=self.fix_span)
        return cruise_control.demote_brokers(
            brokers, reason=f"self-healing slow broker demotion: {brokers}",
            parent_span=self.fix_span)


@dataclasses.dataclass
class TopicAnomaly(Anomaly):
    bad_topics: dict = dataclasses.field(default_factory=dict)

    def fix(self, cruise_control):
        return cruise_control.fix_topic_replication_factor(
            self.bad_topics, reason="self-healing topic replication factor",
            parent_span=self.fix_span)


@dataclasses.dataclass
class MaintenanceEvent(Anomaly):
    plan_type: str = ""      # ADD_BROKER/REMOVE_BROKER/DEMOTE_BROKER/REBALANCE/
                             # FIX_OFFLINE_REPLICAS/TOPIC_REPLICATION_FACTOR
    brokers: list = dataclasses.field(default_factory=list)
    topics: dict = dataclasses.field(default_factory=dict)

    def fix(self, cruise_control):
        pt = self.plan_type.upper()
        reason = f"maintenance event {pt}"
        if pt == "REMOVE_BROKER":
            return cruise_control.remove_brokers(self.brokers, reason=reason,
                                                 parent_span=self.fix_span)
        if pt == "ADD_BROKER":
            # self-healing context: balance onto the new hardware
            # best-effort — a transiently-unsatisfiable hard goal mid-fault
            # must not abort the plan (campaigns caught the strict chain
            # raising while a concurrent broker death was unhealed)
            return cruise_control.add_brokers(self.brokers, reason=reason,
                                              skip_hard_goal_check=True,
                                              parent_span=self.fix_span)
        if pt == "DEMOTE_BROKER":
            return cruise_control.demote_brokers(self.brokers, reason=reason,
                                                 parent_span=self.fix_span)
        if pt == "REBALANCE":
            return cruise_control.rebalance(reason=reason,
                                            parent_span=self.fix_span)
        if pt == "FIX_OFFLINE_REPLICAS":
            return cruise_control.fix_offline_replicas(
                reason=reason, parent_span=self.fix_span)
        if pt == "TOPIC_REPLICATION_FACTOR":
            return cruise_control.fix_topic_replication_factor(
                self.topics, reason=reason, parent_span=self.fix_span)
        raise ValueError(f"unknown maintenance plan type {self.plan_type!r}")
