"""ReplicaDistributionGoal and LeaderReplicaDistributionGoal (counterpart of
``cruise_control_tpu/analyzer/goals/distribution.py``, count distribution).

Reference: ReplicaDistributionAbstractGoal.java (limit math :70-90) with
ReplicaDistributionGoal.java:356 and LeaderReplicaDistributionGoal.java:369. Limits are ceil/floor of
avg * (1 +- (pct - 1) * 0.9), in f32 like the reference. Scores are
violation-measure gains; a move may not create a NEW violation at either
endpoint.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import BALANCE_MARGIN, ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, WAVE_COUNT, WAVE_DIMS, WAVE_LEADER_COUNT, GoalKernel, broker_lookup,
    row_sum4, spread_jitter,
)
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.kernels.leadership import (
    LEAD_LEADER_DIST, LeadTables, Veto,
)
from cruise_control_tpu_torch.kernels.move_score import (
    GOAL_LEADER_DIST, GOAL_REPLICA_DIST,
)


def _violation(u, lower, upper):
    return torch.clamp(u - upper, min=0.0) + torch.clamp(lower - u, min=0.0)


def _count_limits(counts_total, n_alive, balance_pct, triggered, multiplier):
    """(lower, upper) f32 integer limits (ReplicaDistributionAbstractGoal.java:70-90)."""
    f32 = torch.float32
    avg = counts_total / torch.clamp(n_alive, min=1)
    pct = torch.tensor(balance_pct * multiplier if triggered else balance_pct,
                       dtype=f32, device=avg.device)
    adj = (pct - 1.0) * BALANCE_MARGIN
    upper = torch.ceil(avg * (1.0 + adj))
    lower = torch.floor(avg * torch.clamp(1.0 - adj, min=0.0))
    return lower.to(f32), upper.to(f32)


@dataclasses.dataclass(frozen=True)
class ReplicaDistributionGoal(GoalKernel):
    """Even replica counts (ReplicaDistributionGoal.java:356)."""

    def __post_init__(self):
        object.__setattr__(self, "name", "ReplicaDistributionGoal")

    def _limits(self, env: ClusterEnv, st: EngineState):
        n_alive = env.broker_alive.sum().to(torch.float32)
        # all replicas count toward the average: replicas on dead brokers
        # must land on alive ones
        total = st.replica_count.sum().to(torch.float32)
        lower, upper = _count_limits(
            total, n_alive, self.constraint.replica_balance_percentage,
            self.options.triggered_by_goal_violation,
            self.constraint.goal_violation_distribution_threshold_multiplier)
        zero = torch.zeros(env.num_brokers, dtype=torch.float32, device=env.device)
        return (torch.where(env.broker_alive, lower, zero),
                torch.where(env.broker_alive, upper, zero))

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.replica_count.to(torch.float32)
        return torch.maximum(c - upper, lower - c)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        lower, upper = self._limits(env, st)
        c = st.replica_count.to(torch.float32)
        per = broker_lookup(st.replica_broker, c - upper, c - 1.0 - lower,
                            row_sum4(st.util))
        over = per[:, 0] > 0
        any_deficit = (lower - c > 0).any()
        donor = per[:, 1] >= 0
        load = row_sum4(st.effective_load(env))
        movable = env.replica_valid & (over | (any_deficit & donor))
        offline = st.replica_offline & env.replica_valid
        # light replicas first; the hash jitter spreads the pool across brokers
        tiebreak = ((1.0 - load / torch.clamp(per[:, 2], min=1e-9))
                    * spread_jitter(env.num_replicas, env.device))
        key = torch.where(movable | offline, tiebreak, torch.full_like(load, NEG_INF))
        return torch.where(offline, key + 1e12, key)

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """The count gain of ``_gain(c[src], c[dst], 1.0, ...)`` (kernel side);
        offline healing scores 1 + room / (upper + 1)."""
        lower, upper = self._limits(env, st)
        c = st.replica_count.to(torch.float32)
        src = st.replica_broker[cand]
        row_f = torch.stack([c[src], lower[src], upper[src],
                             st.replica_offline[cand].to(torch.float32)], dim=1)
        heal = 1.0 + torch.clamp(upper - c - 1.0, min=0.0) / (upper + 1.0)
        col_f = torch.stack([c, lower, upper, heal])
        return GOAL_REPLICA_DIST, row_f, col_f

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.replica_count.to(torch.float32)
        src = torch.where(c > upper, torch.full_like(c, torch.inf), c - lower)
        return {WAVE_COUNT: (src, upper - c)}

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.replica_count.to(torch.float32)
        B = env.num_brokers
        src = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        dst = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        src[:, WAVE_COUNT] = c - lower
        dst[:, WAVE_COUNT] = upper - c
        return src, dst

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.replica_count.to(torch.float32)
        return (torch.clamp(c - upper, min=0.0), torch.clamp(lower - c, min=0.0),
                WAVE_COUNT)

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        _lower, upper = self._limits(env, st)
        return upper - st.replica_count.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class LeaderReplicaDistributionGoal(GoalKernel):
    """Even leader counts (LeaderReplicaDistributionGoal.java:369): prefers
    leadership transfers, falls back to moving leader replicas."""

    def __post_init__(self):
        object.__setattr__(self, "name", "LeaderReplicaDistributionGoal")
        object.__setattr__(self, "uses_leadership_moves", True)
        object.__setattr__(self, "leadership_primary", True)
        object.__setattr__(self, "deep_tail", True)

    def _limits(self, env: ClusterEnv, st: EngineState):
        n_alive = env.broker_alive.sum().to(torch.float32)
        total = st.leader_count.sum().to(torch.float32)
        lower, upper = _count_limits(
            total, n_alive, self.constraint.leader_replica_balance_percentage,
            self.options.triggered_by_goal_violation,
            self.constraint.goal_violation_distribution_threshold_multiplier)
        zero = torch.zeros(env.num_brokers, dtype=torch.float32, device=env.device)
        return (torch.where(env.broker_alive, lower, zero),
                torch.where(env.broker_alive, upper, zero))

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        return torch.maximum(c - upper, lower - c)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        over = broker_lookup(st.replica_broker, c - upper)[:, 0] > 0
        load = row_sum4(st.effective_load(env))
        movable = (env.replica_valid & st.replica_is_leader & over
                   & ~st.replica_offline)
        return torch.where(movable, -load, torch.full_like(load, NEG_INF))

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """The leader-count gain of ``_gain(c[src], c[dst], 1.0, ...)`` x 0.9
        (kernel side): leadership transfers are the cheaper action."""
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        src = st.replica_broker[cand]
        zk = torch.zeros_like(c[src])
        row_f = torch.stack([c[src], lower[src], upper[src], zk], dim=1)
        col_f = torch.stack([c, lower, upper, torch.zeros_like(c)])
        return GOAL_LEADER_DIST, row_f, col_f

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        src = torch.where(c > upper, torch.full_like(c, torch.inf), c - lower)
        return {WAVE_LEADER_COUNT: (src, upper - c)}

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        B = env.num_brokers
        src = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        dst = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        src[:, WAVE_LEADER_COUNT] = c - lower
        dst[:, WAVE_LEADER_COUNT] = upper - c
        return src, dst

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        return (torch.clamp(c - upper, min=0.0), torch.clamp(lower - c, min=0.0),
                WAVE_LEADER_COUNT)

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        _lower, upper = self._limits(env, st)
        return upper - st.leader_count.to(torch.float32)

    def leader_key(self, env: ClusterEnv, st: EngineState, severity):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        per = broker_lookup(st.replica_broker, c - upper, st.leader_util[:, 2])
        over = per[:, 0] > 0
        nw = env.leader_load[:, 2] - env.follower_load[:, 2]
        ok = env.replica_valid & st.replica_is_leader & over & ~st.replica_offline
        # light partitions first; the hash jitter spreads the pool
        tiebreak = ((1.0 - nw / torch.clamp(per[:, 1], min=1e-9))
                    * spread_jitter(env.num_replicas, env.device))
        return torch.where(ok, tiebreak, torch.full_like(tiebreak, NEG_INF))

    def lead_tables(self, env: ClusterEnv, st: EngineState, cand):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        src = st.replica_broker[cand]
        vso = _violation(c[src], lower[src], upper[src])
        vsn = _violation(c[src] - 1.0, lower[src], upper[src])
        return LeadTables(LEAD_LEADER_DIST, torch.stack([c, lower, upper]).contiguous(),
                          torch.stack([vso, vsn]).contiguous())

    def lead_vetoes(self, env: ClusterEnv, st: EngineState, cand):
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        src = st.replica_broker[cand]
        src_ok = (c[src] - 1 >= lower[src]) | (c[src] > upper[src])
        ones = torch.ones(cand.shape[0], dtype=torch.float32, device=env.device)
        return src_ok, [Veto(c.contiguous(), upper.contiguous(), x_row=ones)]
