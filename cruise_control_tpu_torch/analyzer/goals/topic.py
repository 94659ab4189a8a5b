"""Topic-granularity goals (counterpart of
``cruise_control_tpu/analyzer/goals/topic.py``).

Reference: TopicReplicaDistributionGoal.java:598 (each topic's replicas
spread evenly: per-broker count within gap-clamped ceil/floor limits around
the topic average, gapBasedBalanceLimit :119-131) and
MinTopicLeadersPerBrokerGoal.java:452 (topics flagged in
``env.topic_min_leaders`` keep at least ``min_topic_leaders_per_broker``
leaders on every eligible broker: alive, not excluded for leadership, not
demoted). State: ``st.topic_broker_count`` / ``st.topic_leader_count``
[T, B].
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import BALANCE_MARGIN, ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, GoalKernel, load_sum, offline_bump,
)
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.kernels.leadership import LEAD_MIN_TOPIC, LeadTables
from cruise_control_tpu_torch.kernels.move_score import GOAL_MIN_TOPIC, GOAL_TOPIC_REPLICA
from cruise_control_tpu_torch.kernels.swap import SWAP_TOPIC_REPLICA, SwapTables


@dataclasses.dataclass(frozen=True)
class TopicReplicaDistributionGoal(GoalKernel):
    """Each topic's replicas spread evenly over the alive brokers; swaps are
    the count-neutral escape when replica-count bands veto plain moves."""

    def __post_init__(self):
        object.__setattr__(self, "name", "TopicReplicaDistributionGoal")
        object.__setattr__(self, "uses_swaps", True)

    def _limits(self, env: ClusterEnv, st: EngineState):
        """(lower[T], upper[T]) per-topic per-broker count limits: the int
        topic totals over the alive-broker count in f32, then the
        gap-clamped ceil/floor band. Topic totals are move-invariant, so
        the reference's per-candidate form (row sums of the [T, B] table)
        gives the same values; memoized per (env, count table)."""
        memo = getattr(self, "_memo", None)
        if memo is not None and memo[0] is env and memo[1] is st.topic_broker_count:
            return memo[2]
        n_alive = torch.clamp(env.broker_alive.sum(), min=1).to(torch.float32)
        avg = st.topic_broker_count.sum(dim=1).to(torch.float32) / n_alive
        c = self.constraint
        pct = c.topic_replica_balance_percentage
        if self.options.triggered_by_goal_violation:
            pct *= c.goal_violation_distribution_threshold_multiplier
        adj = (pct - 1.0) * BALANCE_MARGIN
        upper = torch.ceil(avg * (1.0 + adj))
        lower = torch.floor(avg * max(0.0, 1.0 - adj))
        # gap clamp (gapBasedBalanceLimit)
        ceil_avg = torch.ceil(avg)
        upper = torch.minimum(
            torch.maximum(upper, ceil_avg + c.topic_replica_balance_min_gap),
            ceil_avg + c.topic_replica_balance_max_gap)
        lo_min = torch.clamp(torch.floor(avg) - c.topic_replica_balance_max_gap, min=0.0)
        lo_max = torch.clamp(torch.floor(avg) - c.topic_replica_balance_min_gap, min=0.0)
        lower = torch.minimum(torch.maximum(lower, lo_min), lo_max)
        limits = (lower, upper)
        object.__setattr__(self, "_memo", (env, st.topic_broker_count, limits))
        return limits

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        c = st.topic_broker_count.to(torch.float32)
        over = torch.clamp(c - upper[:, None], min=0.0)
        under = torch.clamp(lower[:, None] - c, min=0.0)
        # integer-valued terms: the column sums are exact in any order
        sev = (over + under).sum(dim=0)
        return torch.where(env.broker_alive, sev,
                           torch.maximum(sev, st.replica_count.to(torch.float32)))

    def _count_at(self, st: EngineState, topics, brokers) -> torch.Tensor:
        return st.topic_broker_count[topics, brokers].to(torch.float32)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        lower, upper = self._limits(env, st)
        t = env.replica_topic
        c_tb = self._count_at(st, t, st.replica_broker)
        over = c_tb > upper[t]
        c = st.topic_broker_count.to(torch.float32)
        any_deficit_t = ((lower[:, None] - c) > 0).any(dim=1)
        donor = c_tb - 1 >= lower[t]
        load = load_sum(env, st)
        movable = env.replica_valid & (over | (any_deficit_t[t] & donor))
        offline = st.replica_offline & env.replica_valid
        key = torch.where(movable | offline, -load, torch.full_like(load, NEG_INF))
        return offline_bump(env, key, offline)

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Per row: the topic's limits, the source's excess reduction
        min(max(c_src - up, 0), 1) (-inf when the move would leave the
        source deficient: no destination can then score) and the offline
        flag; the destination's deficit reduction, new-excess check and
        heal score 1 + max(up - c - 1, 0) / (up + 1) read the [T, B] table
        on the kernel side."""
        lower, upper = self._limits(env, st)
        t = env.replica_topic[cand]
        lo, up = lower[t], upper[t]
        c_src = self._count_at(st, t, st.replica_broker[cand])
        excess_red = torch.clamp(torch.clamp(c_src - up, min=0.0), max=1.0)
        src_ok = torch.clamp(lo - (c_src - 1.0), min=0.0) <= 0.0
        excess_red = torch.where(src_ok, excess_red, torch.full_like(excess_red, NEG_INF))
        row_f = torch.stack([lo, up, excess_red,
                             st.replica_offline[cand].to(torch.float32)], dim=1)
        col_f = torch.zeros((4, env.num_brokers), dtype=torch.float32, device=env.device)
        return GOAL_TOPIC_REPLICA, row_f, col_f

    def move_topic_table(self, env: ClusterEnv, st: EngineState, cand):
        return (env.replica_topic[cand].contiguous(),
                st.topic_broker_count.contiguous())

    def move_row_veto(self, env: ClusterEnv, st: EngineState, cand):
        """accept_move's source leg (topic.py:128): the source keeps at least
        the topic's lower limit, or sheds an excess."""
        lower, upper = self._limits(env, st)
        t = env.replica_topic[cand]
        src_c = self._count_at(st, t, st.replica_broker[cand])
        return (src_c - 1.0 >= lower[t]) | (src_c > upper[t])

    def move_topic_veto(self, env: ClusterEnv, st: EngineState):
        """accept_move's destination leg: count[t, b] + 1 <= upper[t]."""
        return self._limits(env, st)[1]

    def wave_topic_budgets(self, env: ClusterEnv, st: EngineState, topics,
                           src_b, dst_b, d_count, d_leader):
        """A wave may shed a (topic, broker) pair down to the topic's lower
        limit and fill one up to its upper limit."""
        lower, upper = self._limits(env, st)
        return (d_count, self._count_at(st, topics, src_b) - lower[topics],
                upper[topics] - self._count_at(st, topics, dst_b))

    # -- swaps: exchange replicas of two topics so both counts improve while
    # every broker's replica count is untouched --
    def swap_out_key(self, env: ClusterEnv, st: EngineState, severity):
        _lower, upper = self._limits(env, st)
        t = env.replica_topic
        over = self._count_at(st, t, st.replica_broker) > upper[t]
        load = load_sum(env, st)
        ok = env.replica_valid & over & ~st.replica_offline
        return torch.where(ok, -load, torch.full_like(load, NEG_INF))

    def swap_in_key(self, env: ClusterEnv, st: EngineState, severity):
        lower, _upper = self._limits(env, st)
        t = env.replica_topic
        can_leave = self._count_at(st, t, st.replica_broker) - 1.0 >= lower[t]
        load = load_sum(env, st)
        ok = env.replica_valid & can_leave & ~st.replica_offline
        return torch.where(ok, -load, torch.full_like(load, NEG_INF))

    def swap_tables(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """(g_out + g_in) x 0.95 over the per-topic limits (kernel side)."""
        lower, upper = self._limits(env, st)
        return SwapTables(SWAP_TOPIC_REPLICA, tl=torch.stack([lower, upper]).contiguous())


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
        load = load_sum(env, st)
        movable = (env.replica_valid & st.replica_is_leader & is_min_topic
                   & self._surplus(env, st) & ~st.replica_offline)
        offline = st.replica_offline & env.replica_valid
        key = torch.where(movable | offline, -load, torch.full_like(load, NEG_INF))
        return offline_bump(env, key, offline)

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
