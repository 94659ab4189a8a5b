"""Goal registry of the port. Names match the reference's class names.

The port so far carries the move-branch goals of its first slice; every
other goal of the reference raises ``NotImplementedError`` naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

from cruise_control_tpu_torch.analyzer.env import BalancingConstraint, OptimizationOptions
from cruise_control_tpu_torch.analyzer.goals.base import GoalKernel
from cruise_control_tpu_torch.analyzer.goals.capacity import (
    CapacityGoal, DiskCapacityGoal, NetworkInboundCapacityGoal, ReplicaCapacityGoal,
)
from cruise_control_tpu_torch.analyzer.goals.distribution import ReplicaDistributionGoal
from cruise_control_tpu_torch.analyzer.goals.rack import RackAwareGoal

GOAL_CLASSES: dict[str, type] = {
    "RackAwareGoal": RackAwareGoal,
    "ReplicaCapacityGoal": ReplicaCapacityGoal,
    "DiskCapacityGoal": DiskCapacityGoal,
    "NetworkInboundCapacityGoal": NetworkInboundCapacityGoal,
    "ReplicaDistributionGoal": ReplicaDistributionGoal,
}

# the reference's other goals (cruise_control_tpu/analyzer/goals/__init__.py)
NOT_PORTED_GOALS = (
    "RackAwareDistributionGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
    "DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
    "LeaderReplicaDistributionGoal", "PotentialNwOutGoal",
    "LeaderBytesInDistributionGoal", "TopicReplicaDistributionGoal",
    "MinTopicLeadersPerBrokerGoal", "PreferredLeaderElectionGoal",
    "IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal",
    "KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal",
)


def make_goal(name: str, constraint: BalancingConstraint | None = None,
              options: OptimizationOptions | None = None) -> GoalKernel:
    cls = GOAL_CLASSES.get(name)
    if cls is None:
        if name in NOT_PORTED_GOALS:
            raise NotImplementedError(
                f"goal {name!r} is not ported yet (ROADMAP.md Queue 1 item 4, "
                f"goal kernels); ported: {sorted(GOAL_CLASSES)}")
        raise ValueError(f"unknown goal {name!r}; known: "
                         f"{sorted(GOAL_CLASSES) + sorted(NOT_PORTED_GOALS)}")
    return cls(constraint=constraint or BalancingConstraint(),
               options=options or OptimizationOptions())


def make_goals(names, constraint=None, options=None) -> list[GoalKernel]:
    return [make_goal(n, constraint, options) for n in names]


__all__ = [
    "GOAL_CLASSES", "GoalKernel", "make_goal", "make_goals", "CapacityGoal",
    "DiskCapacityGoal", "NetworkInboundCapacityGoal", "ReplicaCapacityGoal",
    "ReplicaDistributionGoal", "RackAwareGoal",
]
