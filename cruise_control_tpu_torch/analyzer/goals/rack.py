"""Rack-awareness goals (counterpart of
``cruise_control_tpu/analyzer/goals/rack.py``).

Reference: analyzer/goals/RackAwareGoal.java:235 (hard: no two replicas of a
partition share a rack) and RackAwareDistributionGoal.java:415 (relaxed: a
rack may hold ceil(RF / racks) replicas of a partition). State is the
partition x rack membership count ``st.part_rack_count``. As previous goals
both veto a move through one per-row rack limit (``rack_limit``: 1, or
ceil(RF / racks)), which the K2 and K7 kernels evaluate.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, GoalKernel, load_sum, offline_bump, row_sum4,
)
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.kernels import segment_count
from cruise_control_tpu_torch.kernels.move_score import GOAL_RACK, GOAL_RACK_DIST


def _replica_corack_count(env: ClusterEnv, st: EngineState) -> torch.Tensor:
    """i32[R]: OTHER replicas of this replica's partition in its rack."""
    rack = env.broker_rack[st.replica_broker]
    return st.part_rack_count[env.replica_partition, rack] - 1


def _rack_move_tables(env: ClusterEnv, st: EngineState, cand, family, was_violating,
                      limit=None):
    """The rack families' tables: row_f[:, 0] = was violating or offline,
    row_f[:, 1] = the row's rack limit (GOAL_RACK_DIST); col_f[0] = the
    score ``1 + 0.5 * (1 - util_frac[b])`` that prefers low-utilization
    destinations (the feasibility is the kernel's, from ``others``)."""
    cap = torch.clamp(row_sum4(env.broker_capacity), min=1e-6)
    util_frac = row_sum4(st.util) / cap
    score = 1.0 + 0.5 * (1.0 - util_frac)
    K, B = cand.shape[0], env.num_brokers
    row_f = torch.zeros((K, 4), dtype=torch.float32, device=cand.device)
    row_f[:, 0] = was_violating.to(torch.float32)
    if limit is not None:
        row_f[:, 1] = limit.to(torch.float32)
    col_f = torch.zeros((4, B), dtype=torch.float32, device=cand.device)
    col_f[0] = score
    return family, row_f, col_f


@dataclasses.dataclass(frozen=True)
class RackAwareGoal(GoalKernel):
    def __post_init__(self):
        object.__setattr__(self, "name", "RackAwareGoal")
        object.__setattr__(self, "is_hard", True)
        object.__setattr__(self, "wave_safe", True)

    def _violating(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        return (_replica_corack_count(env, st) > 0) & env.replica_valid

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        """Count of rack-violating (or offline) replicas per broker."""
        viol = self._violating(env, st) | (st.replica_offline & env.replica_valid)
        return segment_count(st.replica_broker, env.num_brokers,
                             viol.to(torch.int32)).to(torch.float32)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        viol = self._violating(env, st)
        offline = st.replica_offline & env.replica_valid
        load = load_sum(env, st)
        key = torch.where(viol | offline, -load, torch.full_like(load, NEG_INF))
        return offline_bump(env, key, offline)

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Feasible iff the destination rack holds no other replica of the
        partition (kernel side); the score prefers low-utilization brokers."""
        p = env.replica_partition[cand]
        cur_rack = env.broker_rack[st.replica_broker[cand]]
        corack = st.part_rack_count[p, cur_rack] - 1
        was_violating = (corack > 0) | st.replica_offline[cand]
        return _rack_move_tables(env, st, cand, GOAL_RACK, was_violating)

    def rack_limit(self, env: ClusterEnv, part):
        """``accept_move``: no other replica of the partition in the
        destination rack (``others == 0``, i.e. ``others + 1 <= 1``)."""
        return torch.ones_like(part, dtype=torch.int32)

    def violated(self, env: ClusterEnv, st: EngineState):
        return self._violating(env, st).any()


def _max_per_rack(env: ClusterEnv, rf: torch.Tensor) -> torch.Tensor:
    """i32: ceil(rf / racks), the f32 division of the reference (rack.py:123)."""
    return torch.ceil(rf.to(torch.float32) / float(max(env.num_real_racks, 1))).to(
        torch.int32)


@dataclasses.dataclass(frozen=True)
class RackAwareDistributionGoal(GoalKernel):
    """Relaxed rack awareness (RackAwareDistributionGoal.java:415): replicas
    of a partition spread across racks as evenly as possible, a rack holding
    at most ceil(RF / num_racks) of them."""

    def __post_init__(self):
        object.__setattr__(self, "name", "RackAwareDistributionGoal")
        object.__setattr__(self, "is_hard", True)
        object.__setattr__(self, "wave_safe", True)

    def _limit(self, env: ClusterEnv) -> torch.Tensor:
        """i32[P] the per-partition rack limit."""
        return _max_per_rack(env, (env.partition_replicas >= 0).sum(dim=1))

    def _violating(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        rack = env.broker_rack[st.replica_broker]
        count = st.part_rack_count[env.replica_partition, rack]
        limit = self._limit(env)[env.replica_partition]
        return (count > limit) & env.replica_valid

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        viol = self._violating(env, st) | (st.replica_offline & env.replica_valid)
        return segment_count(st.replica_broker, env.num_brokers,
                             viol.to(torch.int32)).to(torch.float32)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        viol = self._violating(env, st)
        offline = st.replica_offline & env.replica_valid
        load = load_sum(env, st)
        key = torch.where(viol | offline, -load, torch.full_like(load, NEG_INF))
        return offline_bump(env, key, offline)

    def rack_limit(self, env: ClusterEnv, part):
        """i32[K] ``_max_per_rack_for`` (rack.py:123): ``accept_move`` keeps
        ``others + 1 <= ceil(RF / racks)``."""
        return _max_per_rack(env, (env.partition_replicas[part] >= 0).sum(dim=1))

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Feasible iff the destination rack stays within the limit (kernel
        side, ``others + 1 <= limit``) and the row was violating or offline;
        the score prefers low-utilization brokers."""
        p = env.replica_partition[cand]
        limit = self.rack_limit(env, p)
        cur_rack = env.broker_rack[st.replica_broker[cand]]
        was_violating = (st.part_rack_count[p, cur_rack] > limit) | st.replica_offline[cand]
        return _rack_move_tables(env, st, cand, GOAL_RACK_DIST, was_violating, limit)

    def violated(self, env: ClusterEnv, st: EngineState):
        return self._violating(env, st).any()
