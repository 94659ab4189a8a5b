"""Static optimization environment (counterpart of
``cruise_control_tpu/analyzer/env.py``).

Everything the goal kernels need that does NOT change while optimizing: the
per-replica leader/follower loads, capacities, rack map, the partition ->
replica membership table, exclusion masks and the balancing thresholds. The
mutable part lives in ``state.EngineState``.

The port keeps every index column as int64 (torch's index dtype) and every
count as int32 on the device; the reference's int16/int8 compact tables
were an HBM diet for the TPU and change no value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.model.cluster_tensor import (
    ClusterMeta, ClusterTensor, bucket_size,
)

BALANCE_MARGIN = 0.9  # ResourceDistributionGoal.java:57 / ReplicaDistributionAbstractGoal.java:30


def resolve_device(device) -> torch.device:
    """The explicit device of a port entry point. ``cuda`` without a card
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class BalancingConstraint:
    """Constraint bundle (BalancingConstraint.java)."""
    resource_balance_percentage: tuple = (1.10, 1.10, 1.10, 1.10)   # indexed by Resource
    capacity_threshold: tuple = (0.7, 0.8, 0.8, 0.8)
    low_utilization_threshold: tuple = (0.0, 0.0, 0.0, 0.0)
    max_replicas_per_broker: int = 10_000
    replica_balance_percentage: float = 1.10
    leader_replica_balance_percentage: float = 1.10
    topic_replica_balance_percentage: float = 3.00
    topic_replica_balance_min_gap: int = 2
    topic_replica_balance_max_gap: int = 40
    goal_violation_distribution_threshold_multiplier: float = 1.0
    min_topic_leaders_per_broker: int = 1

    @classmethod
    def from_config(cls, cfg) -> "BalancingConstraint":
        """The constraint of a ``config.cruise_control_config`` (env.py:58)."""
        names = ("cpu", "network.inbound", "network.outbound", "disk")
        return cls(
            resource_balance_percentage=tuple(
                cfg.get_double(f"{n}.balance.threshold") for n in names),
            capacity_threshold=tuple(
                cfg.get_double(f"{n}.capacity.threshold") for n in names),
            low_utilization_threshold=tuple(
                cfg.get_double(f"{n}.low.utilization.threshold") for n in names),
            max_replicas_per_broker=cfg.get_int("max.replicas.per.broker"),
            replica_balance_percentage=cfg.get_double("replica.count.balance.threshold"),
            leader_replica_balance_percentage=cfg.get_double(
                "leader.replica.count.balance.threshold"),
            topic_replica_balance_percentage=cfg.get_double(
                "topic.replica.count.balance.threshold"),
            topic_replica_balance_min_gap=cfg.get_int("topic.replica.count.balance.min.gap"),
            topic_replica_balance_max_gap=cfg.get_int("topic.replica.count.balance.max.gap"),
            goal_violation_distribution_threshold_multiplier=cfg.get_double(
                "goal.violation.distribution.threshold.multiplier"),
            min_topic_leaders_per_broker=cfg.get_int("min.topic.leaders.per.broker"),
        )


@dataclasses.dataclass(frozen=True)
class OptimizationOptions:
    """Per-run options (analyzer/OptimizationOptions.java)."""
    triggered_by_goal_violation: bool = False
    fix_offline_replicas_only: bool = False
    fast_mode: bool = False


@dataclasses.dataclass(frozen=True)
class ClusterEnv:
    leader_load: torch.Tensor          # f32[R, M]
    follower_load: torch.Tensor        # f32[R, M]
    broker_capacity: torch.Tensor      # f32[B, M]
    broker_rack: torch.Tensor          # i64[B]
    broker_alive: torch.Tensor         # bool[B]
    broker_new: torch.Tensor           # bool[B]
    broker_demoted: torch.Tensor       # bool[B]
    broker_excluded_for_replica_move: torch.Tensor   # bool[B]
    broker_excluded_for_leadership: torch.Tensor     # bool[B]
    broker_disk_capacity: torch.Tensor  # f32[B, D]
    broker_disk_alive: torch.Tensor     # bool[B, D]
    replica_partition: torch.Tensor    # i64[R]
    replica_topic: torch.Tensor        # i64[R]
    replica_topic_excluded: torch.Tensor  # bool[R] topic_excluded at replica granularity
    replica_valid: torch.Tensor        # bool[R]
    replica_original_broker: torch.Tensor  # i64[R]
    partition_replicas: torch.Tensor   # i64[P, F] replica indices, -1 padded
    partition_topic: torch.Tensor      # i64[P]
    topic_excluded: torch.Tensor       # bool[T]
    topic_min_leaders: torch.Tensor    # bool[T]
    dst_candidate: torch.Tensor        # bool[B] allowed destinations (alive, not excluded)
    num_real_racks: int                # ACTUAL rack count
    num_racks: int                     # padded rack-axis size (>= real)
    max_rf: int                        # padded membership-table width
    # the f32 env has no bf16 load tables (``SweepEnv`` has)
    sweep_loads = None

    @property
    def device(self) -> torch.device:
        return self.leader_load.device

    @property
    def num_brokers(self) -> int:
        return self.broker_capacity.shape[0]

    @property
    def num_replicas(self) -> int:
        return self.leader_load.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.partition_replicas.shape[0]

    @property
    def num_topics(self) -> int:
        return self.topic_excluded.shape[0]


@dataclasses.dataclass(frozen=True)
class SweepEnv(ClusterEnv):
    """The bf16 policy's sweep view of an env (``engine._sweep_env``):
    ``sweep_loads`` holds the [R, M] leader / follower loads in bf16, which
    the keying sweep (K1 keying) reads; ``leader_load`` / ``follower_load``
    hold the same values upcast to f32 for the [K]-row score tables."""
    sweep_loads: tuple | None = None


def build_partition_replicas(ct: ClusterTensor) -> np.ndarray:
    """[P, F] replica-index membership table from the (static) partition ids
    (sort + cumcount, no per-replica Python loop)."""
    part = np.asarray(ct.replica_partition)
    valid = np.asarray(ct.replica_valid)
    P = ct.num_partitions
    idx = np.flatnonzero(valid).astype(np.int32)
    if idx.size == 0:
        return np.full((P, 1), -1, np.int32)
    order = np.argsort(part[idx], kind="stable")
    sorted_idx = idx[order]
    sorted_part = part[sorted_idx]
    is_start = np.ones(sorted_part.size, bool)
    is_start[1:] = sorted_part[1:] != sorted_part[:-1]
    group_start = np.maximum.accumulate(np.where(is_start,
                                                 np.arange(sorted_part.size), 0))
    rank = np.arange(sorted_part.size) - group_start
    F = int(rank.max()) + 1
    table = np.full((P, F), -1, np.int32)
    table[sorted_part, rank] = sorted_idx
    return table


def padded_partition_table(ct: ClusterTensor) -> np.ndarray:
    """Host [P, F] membership table with the RF width bucketed (padded with
    -1 members); kept on the host for proposal diffing."""
    table = build_partition_replicas(ct)
    F = bucket_size(table.shape[1], 4)
    if F != table.shape[1]:
        table = np.pad(table, [(0, 0), (0, F - table.shape[1])],
                       constant_values=-1)
    return table


def make_env(ct: ClusterTensor, meta: ClusterMeta,
             topic_min_leaders_mask: np.ndarray | None = None,
             partition_table: np.ndarray | None = None,
             device="cuda") -> ClusterEnv:
    """Upload the static cluster tables to ``device``."""
    dev = resolve_device(device)
    table = (padded_partition_table(ct) if partition_table is None
             else partition_table)
    T = ct.num_topics
    tml = (np.zeros(T, bool) if topic_min_leaders_mask is None
           else np.asarray(topic_min_leaders_mask, bool))

    def t(a, dtype):
        return torch.tensor(np.asarray(a), device=dev).to(dtype)

    f32, i64 = torch.float32, torch.int64
    broker_alive = t(ct.broker_alive, torch.bool)
    excl_move = t(ct.broker_excluded_for_replica_move, torch.bool)
    topic_excluded = t(ct.topic_excluded, torch.bool)
    replica_topic = t(ct.replica_topic, i64)
    return ClusterEnv(
        leader_load=t(ct.leader_load, f32),
        follower_load=t(ct.follower_load, f32),
        broker_capacity=t(ct.broker_capacity, f32),
        broker_rack=t(ct.broker_rack, i64),
        broker_alive=broker_alive,
        broker_new=t(ct.broker_new, torch.bool),
        broker_demoted=t(ct.broker_demoted, torch.bool),
        broker_excluded_for_replica_move=excl_move,
        broker_excluded_for_leadership=t(ct.broker_excluded_for_leadership,
                                         torch.bool),
        broker_disk_capacity=t(ct.broker_disk_capacity, f32),
        broker_disk_alive=t(ct.broker_disk_alive, torch.bool),
        replica_partition=t(ct.replica_partition, i64),
        replica_topic=replica_topic,
        replica_topic_excluded=topic_excluded[replica_topic],
        replica_valid=t(ct.replica_valid, torch.bool),
        replica_original_broker=t(ct.replica_original_broker, i64),
        partition_replicas=t(table, i64),
        partition_topic=t(ct.partition_topic, i64),
        topic_excluded=topic_excluded,
        topic_min_leaders=t(tml, torch.bool),
        dst_candidate=broker_alive & ~excl_move,
        num_real_racks=int(meta.num_racks),
        num_racks=bucket_size(meta.num_racks, 8),
        max_rf=int(table.shape[1]),
    )


def capacity_stripe_key(env: ClusterEnv) -> torch.Tensor:
    """f32[B] total configured capacity of each allowed destination broker
    (-inf elsewhere): the state-independent broker ranking of the
    segment-parallel finisher."""
    total = env.broker_capacity.sum(dim=1)
    return torch.where(env.dst_candidate, total,
                       torch.full_like(total, -torch.inf))


# ---------------------------------------------------------------------------
# Threshold math (GoalUtils.java:515 computeResourceUtilizationBalanceThreshold)
# ---------------------------------------------------------------------------
def balance_percentage_with_margin(constraint: BalancingConstraint, resource: int,
                                   triggered_by_goal_violation: bool) -> float:
    pct = constraint.resource_balance_percentage[resource]
    if triggered_by_goal_violation:
        pct *= constraint.goal_violation_distribution_threshold_multiplier
    return (pct - 1.0) * BALANCE_MARGIN


def resource_balance_limits(avg_utilization_pct: torch.Tensor,
                            constraint: BalancingConstraint,
                            resource: int, triggered_by_goal_violation: bool):
    """(lower, upper) f32 utilization-percentage thresholds for a resource
    (GoalUtils.java:515-545 incl. the low-utilization special cases)."""
    margin_pct = balance_percentage_with_margin(constraint, resource,
                                                triggered_by_goal_violation)
    low_thresh = constraint.low_utilization_threshold[resource]
    avg = avg_utilization_pct.to(torch.float32)
    is_low = avg <= low_thresh
    lower = torch.where(is_low, torch.zeros_like(avg),
                        avg * max(0.0, 1.0 - margin_pct))
    upper = avg * (1.0 + margin_pct)
    upper = torch.where(is_low, torch.clamp(upper, min=low_thresh * BALANCE_MARGIN),
                        upper)
    return lower, upper
