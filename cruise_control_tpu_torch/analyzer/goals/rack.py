"""RackAwareGoal (counterpart of ``cruise_control_tpu/analyzer/goals/rack.py``).

Reference: analyzer/goals/RackAwareGoal.java:235 (hard: no two replicas of a
partition share a rack). State is the partition x rack membership count
``st.part_rack_count``.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import NEG_INF, GoalKernel, row_sum4
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.kernels import segment_count
from cruise_control_tpu_torch.kernels.move_score import GOAL_RACK


def _replica_corack_count(env: ClusterEnv, st: EngineState) -> torch.Tensor:
    """i32[R]: OTHER replicas of this replica's partition in its rack."""
    rack = env.broker_rack[st.replica_broker]
    return st.part_rack_count[env.replica_partition, rack] - 1


@dataclasses.dataclass(frozen=True)
class RackAwareGoal(GoalKernel):
    def __post_init__(self):
        object.__setattr__(self, "name", "RackAwareGoal")
        object.__setattr__(self, "is_hard", True)
        object.__setattr__(self, "wave_safe", True)
        object.__setattr__(self, "rack_veto", True)

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
        load = row_sum4(st.effective_load(env))
        key = torch.where(viol | offline, -load, torch.full_like(load, NEG_INF))
        return torch.where(offline, key + 1e12, key)

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Feasible iff the destination rack holds no other replica of the
        partition (kernel side); the score prefers low-utilization brokers."""
        p = env.replica_partition[cand]
        cur_rack = env.broker_rack[st.replica_broker[cand]]
        corack = st.part_rack_count[p, cur_rack] - 1
        was_violating = (corack > 0) | st.replica_offline[cand]
        cap = torch.clamp(row_sum4(env.broker_capacity), min=1e-6)
        util_frac = row_sum4(st.util) / cap
        score = 1.0 + 0.5 * (1.0 - util_frac)
        K, B = cand.shape[0], env.num_brokers
        row_f = torch.zeros((K, 4), dtype=torch.float32, device=cand.device)
        row_f[:, 0] = was_violating.to(torch.float32)
        col_f = torch.zeros((4, B), dtype=torch.float32, device=cand.device)
        col_f[0] = score
        return GOAL_RACK, row_f, col_f

    def violated(self, env: ClusterEnv, st: EngineState):
        return self._violating(env, st).any()
