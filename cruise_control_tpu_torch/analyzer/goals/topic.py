"""MinTopicLeadersPerBrokerGoal (counterpart of
``cruise_control_tpu/analyzer/goals/topic.py`` :204-310).

Reference: MinTopicLeadersPerBrokerGoal.java:452: topics flagged in
``env.topic_min_leaders`` keep at least ``min_topic_leaders_per_broker``
leaders on every eligible broker (alive, not excluded for leadership, not
demoted). State: ``st.topic_leader_count`` [T, B].
TopicReplicaDistributionGoal uses swaps and is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import NEG_INF, GoalKernel, row_sum4
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.kernels.leadership import LEAD_MIN_TOPIC, LeadTables
from cruise_control_tpu_torch.kernels.move_score import GOAL_MIN_TOPIC


@dataclasses.dataclass(frozen=True)
class MinTopicLeadersPerBrokerGoal(GoalKernel):
    """Hard goal: flagged topics keep their leader minimum per broker."""

    def __post_init__(self):
        object.__setattr__(self, "name", "MinTopicLeadersPerBrokerGoal")
        object.__setattr__(self, "is_hard", True)
        object.__setattr__(self, "uses_leadership_moves", True)
        object.__setattr__(self, "leadership_primary", True)

    def _min(self) -> int:
        return self.constraint.min_topic_leaders_per_broker

    def _eligible(self, env: ClusterEnv) -> torch.Tensor:
        return (env.broker_alive & ~env.broker_excluded_for_leadership
                & ~env.broker_demoted)

    def _need_col(self, env: ClusterEnv) -> torch.Tensor:
        """f32[B]: the leader minimum at eligible brokers, 0 elsewhere."""
        elig = self._eligible(env)
        return torch.where(elig, torch.full(elig.shape, float(self._min()),
                                            device=env.device),
                           torch.zeros(elig.shape, device=env.device))

    def _deficit(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        """f32[T, B] missing leaders per (min-leader topic, eligible broker)."""
        c = st.topic_leader_count.to(torch.float32)
        need = torch.where(env.topic_min_leaders[:, None], self._need_col(env)[None, :],
                           torch.zeros_like(c))
        return torch.clamp(need - c, min=0.0)

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        # integer-valued terms: the column sums are exact in any order
        return self._deficit(env, st).sum(dim=0)

    def violated(self, env: ClusterEnv, st: EngineState):
        return (self._deficit(env, st) > 0).any()

    def _surplus(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        tlc = st.topic_leader_count[env.replica_topic, st.replica_broker]
        return tlc.to(torch.float32) > float(self._min())

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        """Leader replicas of min-leader topics on surplus brokers."""
        is_min_topic = env.topic_min_leaders[env.replica_topic]
        load = row_sum4(st.effective_load(env))
        movable = (env.replica_valid & st.replica_is_leader & is_min_topic
                   & self._surplus(env, st) & ~st.replica_offline)
        offline = st.replica_offline & env.replica_valid
        key = torch.where(movable | offline, -load, torch.full_like(load, NEG_INF))
        return torch.where(offline, key + 1e12, key)

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """gain = min(deficit[t, b], 1) over the (topic, broker) table
        (kernel side); offline healing scores 1."""
        t = env.replica_topic[cand]
        K = cand.shape[0]
        row_f = torch.zeros((K, 4), dtype=torch.float32, device=cand.device)
        row_f[:, 0] = st.replica_offline[cand].to(torch.float32)
        row_f[:, 1] = env.topic_min_leaders[t].to(torch.float32)
        col_f = torch.zeros((4, env.num_brokers), dtype=torch.float32, device=cand.device)
        col_f[0] = self._need_col(env)
        return GOAL_MIN_TOPIC, row_f, col_f

    def move_topic_table(self, env: ClusterEnv, st: EngineState, cand):
        return (env.replica_topic[cand].contiguous(),
                st.topic_leader_count.contiguous())

    def _src_ok(self, env: ClusterEnv, st: EngineState, cand, leader_only: bool):
        t = env.replica_topic[cand]
        src = st.replica_broker[cand]
        c_ts = st.topic_leader_count[t, src].to(torch.float32)
        guarded = env.topic_min_leaders[t] & self._eligible(env)[src]
        if leader_only:
            guarded = guarded & st.replica_is_leader[cand]
        return (c_ts - 1.0 >= float(self._min())) | ~guarded

    def move_row_veto(self, env: ClusterEnv, st: EngineState, cand):
        """accept_move: never take a leader of a min-leader topic off a broker
        that would drop below the minimum."""
        return self._src_ok(env, st, cand, leader_only=True)

    def leader_key(self, env: ClusterEnv, st: EngineState, severity):
        ok = (env.replica_valid & st.replica_is_leader
              & env.topic_min_leaders[env.replica_topic] & self._surplus(env, st)
              & ~st.replica_offline)
        return torch.where(ok, torch.ones(ok.shape, device=env.device),
                           torch.full(ok.shape, NEG_INF, device=env.device))

    def lead_tables(self, env: ClusterEnv, st: EngineState, cand):
        t = env.replica_topic[cand]
        fb = torch.zeros((3, env.num_brokers), dtype=torch.float32, device=env.device)
        fb[0] = self._need_col(env)
        fk = torch.zeros((2, cand.shape[0]), dtype=torch.float32, device=env.device)
        fk[0] = env.topic_min_leaders[t].to(torch.float32)
        return LeadTables(LEAD_MIN_TOPIC, fb, fk, row_t=t.contiguous(),
                          tab=st.topic_leader_count.contiguous())

    def lead_vetoes(self, env: ClusterEnv, st: EngineState, cand):
        return self._src_ok(env, st, cand, leader_only=False), []

    def wave_topic_budgets(self, env: ClusterEnv, st: EngineState, topics,
                           src_b, dst_b, d_count, d_leader):
        """A wave may drain leaders of a guarded (topic, src) pair down to
        the minimum; gaining leaders never violates it."""
        c_ts = st.topic_leader_count[topics, src_b].to(torch.float32)
        guarded = env.topic_min_leaders[topics] & self._eligible(env)[src_b]
        src_slack = torch.where(guarded, c_ts - float(self._min()),
                                torch.full_like(c_ts, torch.inf))
        return d_leader, src_slack, torch.full_like(src_slack, torch.inf)
