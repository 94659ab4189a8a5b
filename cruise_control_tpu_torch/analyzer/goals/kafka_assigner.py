"""Kafka-assigner mode goals (counterpart of
``cruise_control_tpu/analyzer/goals/kafka_assigner.py``).

Reference: analyzer/kafkaassigner/ — KafkaAssignerEvenRackAwareGoal.java
(strict rack awareness: each replica of a partition on a distinct rack) and
KafkaAssignerDiskUsageDistributionGoal.java (disk balancing that keeps each
broker's replica count by swapping replicas between broker pairs). The
``kafka_assigner`` request parameter substitutes these for their standard
counterparts (GoalBasedOperationRunnable kafka-assigner mode).

The disk goal runs on the K7 swap kernel's resource-distribution family
alone: with replica moves and leadership transfers off, its finisher has
nothing to scan and returns at once.
"""
from __future__ import annotations

import dataclasses

from cruise_control_tpu_torch.analyzer.goals.distribution import DiskUsageDistributionGoal
from cruise_control_tpu_torch.analyzer.goals.rack import RackAwareGoal


@dataclasses.dataclass(frozen=True)
class KafkaAssignerEvenRackAwareGoal(RackAwareGoal):
    """RackAwareGoal's contract under the assigner's name (the reference's
    ensureRackAware: distinct racks per partition, hard)."""

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "KafkaAssignerEvenRackAwareGoal")


@dataclasses.dataclass(frozen=True)
class KafkaAssignerDiskUsageDistributionGoal(DiskUsageDistributionGoal):
    """Disk balancing by swaps only: per-broker replica counts are kept."""

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "KafkaAssignerDiskUsageDistributionGoal")
        object.__setattr__(self, "uses_replica_moves", False)
        object.__setattr__(self, "uses_leadership_moves", False)
        object.__setattr__(self, "uses_swaps", True)


# GoalBasedOperationRunnable's kafka-assigner substitution table
KAFKA_ASSIGNER_SUBSTITUTION = {
    "RackAwareGoal": "KafkaAssignerEvenRackAwareGoal",
    "RackAwareDistributionGoal": "KafkaAssignerEvenRackAwareGoal",
    "DiskUsageDistributionGoal": "KafkaAssignerDiskUsageDistributionGoal",
}


def kafka_assigner_goal_names(names: list[str]) -> list[str]:
    """Map a goal list into kafka-assigner mode, each substituted goal once
    (the mode runs exactly its two goals when none are requested)."""
    if not names:
        return ["KafkaAssignerEvenRackAwareGoal",
                "KafkaAssignerDiskUsageDistributionGoal"]
    out = []
    for n in names:
        mapped = KAFKA_ASSIGNER_SUBSTITUTION.get(n, n)
        if mapped not in out:
            out.append(mapped)
    return out
