"""Goal registry of the port. Names match the reference's class names.

The port carries every goal of the reference: the sixteen of the default
chain (``DEFAULT_GOALS`` of the reference's config/defaults.py),
``RackAwareDistributionGoal``, the two kafka-assigner goals, the two
intra-broker disk goals (``intra.broker.goals``) and
``PreferredLeaderElectionGoal`` (a one-shot pass the optimizer runs after
the chain, never a chain goal).
"""
from __future__ import annotations

from cruise_control_tpu_torch.analyzer.env import BalancingConstraint, OptimizationOptions
from cruise_control_tpu_torch.analyzer.goals.base import GoalKernel
from cruise_control_tpu_torch.analyzer.goals.capacity import (
    CapacityGoal, CpuCapacityGoal, DiskCapacityGoal, NetworkInboundCapacityGoal,
    NetworkOutboundCapacityGoal, ReplicaCapacityGoal,
)
from cruise_control_tpu_torch.analyzer.goals.distribution import (
    CpuUsageDistributionGoal, DiskUsageDistributionGoal, LeaderReplicaDistributionGoal,
    NetworkInboundUsageDistributionGoal, NetworkOutboundUsageDistributionGoal,
    ReplicaDistributionGoal, ResourceDistributionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.intra_broker import (
    IntraBrokerDiskCapacityGoal, IntraBrokerDiskUsageDistributionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.kafka_assigner import (
    KAFKA_ASSIGNER_SUBSTITUTION, KafkaAssignerDiskUsageDistributionGoal,
    KafkaAssignerEvenRackAwareGoal, kafka_assigner_goal_names,
)
from cruise_control_tpu_torch.analyzer.goals.leader_election import (
    PreferredLeaderElectionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.network import (
    LeaderBytesInDistributionGoal, PotentialNwOutGoal,
)
from cruise_control_tpu_torch.analyzer.goals.rack import (
    RackAwareDistributionGoal, RackAwareGoal,
)
from cruise_control_tpu_torch.analyzer.goals.topic import (
    MinTopicLeadersPerBrokerGoal, TopicReplicaDistributionGoal,
)

GOAL_CLASSES: dict[str, type] = {
    "RackAwareGoal": RackAwareGoal,
    "RackAwareDistributionGoal": RackAwareDistributionGoal,
    "MinTopicLeadersPerBrokerGoal": MinTopicLeadersPerBrokerGoal,
    "ReplicaCapacityGoal": ReplicaCapacityGoal,
    "DiskCapacityGoal": DiskCapacityGoal,
    "NetworkInboundCapacityGoal": NetworkInboundCapacityGoal,
    "NetworkOutboundCapacityGoal": NetworkOutboundCapacityGoal,
    "CpuCapacityGoal": CpuCapacityGoal,
    "ReplicaDistributionGoal": ReplicaDistributionGoal,
    "PotentialNwOutGoal": PotentialNwOutGoal,
    "DiskUsageDistributionGoal": DiskUsageDistributionGoal,
    "NetworkInboundUsageDistributionGoal": NetworkInboundUsageDistributionGoal,
    "NetworkOutboundUsageDistributionGoal": NetworkOutboundUsageDistributionGoal,
    "CpuUsageDistributionGoal": CpuUsageDistributionGoal,
    "TopicReplicaDistributionGoal": TopicReplicaDistributionGoal,
    "LeaderReplicaDistributionGoal": LeaderReplicaDistributionGoal,
    "LeaderBytesInDistributionGoal": LeaderBytesInDistributionGoal,
    "IntraBrokerDiskCapacityGoal": IntraBrokerDiskCapacityGoal,
    "IntraBrokerDiskUsageDistributionGoal": IntraBrokerDiskUsageDistributionGoal,
    "PreferredLeaderElectionGoal": PreferredLeaderElectionGoal,
    "KafkaAssignerEvenRackAwareGoal": KafkaAssignerEvenRackAwareGoal,
    "KafkaAssignerDiskUsageDistributionGoal": KafkaAssignerDiskUsageDistributionGoal,
}


def make_goal(name: str, constraint: BalancingConstraint | None = None,
              options: OptimizationOptions | None = None) -> GoalKernel:
    cls = GOAL_CLASSES.get(name)
    if cls is None:
        raise ValueError(f"unknown goal {name!r}; known: {sorted(GOAL_CLASSES)}")
    return cls(constraint=constraint or BalancingConstraint(),
               options=options or OptimizationOptions())


def make_goals(names, constraint=None, options=None) -> list[GoalKernel]:
    return [make_goal(n, constraint, options) for n in names]


__all__ = [
    "GOAL_CLASSES", "GoalKernel", "make_goal", "make_goals", "CapacityGoal",
    "KAFKA_ASSIGNER_SUBSTITUTION", "KafkaAssignerDiskUsageDistributionGoal",
    "KafkaAssignerEvenRackAwareGoal", "RackAwareDistributionGoal",
    "kafka_assigner_goal_names",
    "CpuCapacityGoal", "CpuUsageDistributionGoal", "DiskCapacityGoal",
    "DiskUsageDistributionGoal", "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal", "LeaderBytesInDistributionGoal",
    "LeaderReplicaDistributionGoal", "MinTopicLeadersPerBrokerGoal",
    "NetworkInboundCapacityGoal", "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundCapacityGoal", "NetworkOutboundUsageDistributionGoal",
    "PotentialNwOutGoal", "PreferredLeaderElectionGoal", "RackAwareGoal",
    "ReplicaCapacityGoal", "ReplicaDistributionGoal", "ResourceDistributionGoal",
    "TopicReplicaDistributionGoal",
]
