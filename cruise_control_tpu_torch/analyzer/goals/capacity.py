"""Hard capacity goals, move path (counterpart of
``cruise_control_tpu/analyzer/goals/capacity.py``).

Reference: analyzer/goals/CapacityGoal.java:479 (+ DiskCapacityGoal,
NetworkInbound/OutboundCapacityGoal, CpuCapacityGoal) and
ReplicaCapacityGoal.java:345: every alive
broker's utilization of the goal's resource stays under ``capacity_threshold
* capacity``; replica counts under ``max.replicas.per.broker``. Dead brokers
must end up empty.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, WAVE_COUNT, WAVE_DIMS, GoalKernel, MoveTerm, candidate_load, load_sum,
    offline_bump, sweep_keys, sweep_round,
)
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.common.resources import EPSILON_ABS, RESOURCES
from cruise_control_tpu_torch.kernels.keys import KEY_CAPACITY, KEY_LEAD_DELTA
from cruise_control_tpu_torch.kernels.leadership import LEAD_CAPACITY, LeadTables, Veto
from cruise_control_tpu_torch.kernels.move_score import (
    GOAL_CAPACITY, GOAL_REPLICA_CAPACITY,
)
from cruise_control_tpu_torch.kernels.swap import VETO_NET_CAPACITY, SwapAccept, SwapVeto

# absolute violation tolerances per resource column, as f32 (Resource.java)
RESOURCE_EPS = torch.tensor([EPSILON_ABS[r] for r in RESOURCES], dtype=torch.float32)
_EPS_ON: dict = {}
LEAD_SCORE_BF16 = 0.98828125     # bf16(0.99)


def resource_eps(device, resource: int) -> torch.Tensor:
    """0-d f32 ``RESOURCE_EPS[resource]`` on ``device``, uploaded once per
    device: a fresh upload per use would wait for the stream each time."""
    eps = _EPS_ON.get(device)
    if eps is None:
        eps = _EPS_ON[device] = RESOURCE_EPS.to(device)
    return eps[resource]


def _inf_slack(B: int, device) -> torch.Tensor:
    return torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class CapacityGoal(GoalKernel):
    """Base of the per-resource capacity goals. ``resource`` is the column."""
    resource: int = 3  # DISK

    def __post_init__(self):
        object.__setattr__(self, "is_hard", True)
        object.__setattr__(self, "uses_leadership_moves", True)

    def _eps(self, env: ClusterEnv) -> torch.Tensor:
        return resource_eps(env.device, self.resource)

    def _limit(self, env: ClusterEnv) -> torch.Tensor:
        """f32[B]: allowed utilization; 0 for dead brokers."""
        thresh = self.constraint.capacity_threshold[self.resource]
        cap = env.broker_capacity[:, self.resource]
        return torch.where(env.broker_alive, thresh * cap, torch.zeros_like(cap))

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        return st.util[:, self.resource] - self._limit(env) - self._eps(env)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        """Movable replicas of over-limit brokers by load, offline first
        (K1 keying)."""
        return sweep_keys(KEY_CAPACITY, env, st, self.resource, [severity])

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Feasible iff util + load <= limit; score = load + 0.01 * headroom
        / capacity (offline healing: 1 + headroom / capacity)."""
        l = candidate_load(env, st, cand)[:, self.resource]
        limit = self._limit(env)
        util = st.util[:, self.resource]
        headroom = torch.clamp(limit - util, min=0.0)
        cap = torch.clamp(env.broker_capacity[:, self.resource], min=1e-6)
        row_f = torch.zeros((cand.shape[0], 4), dtype=torch.float32, device=cand.device)
        row_f[:, 0] = l
        row_f[:, 1] = st.replica_offline[cand].to(torch.float32)
        col_f = torch.stack([util, limit, 0.01 * headroom / cap,
                             1.0 + headroom / cap])
        return GOAL_CAPACITY, row_f, col_f

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        limit = self._limit(env) + self._eps(env)
        return {int(self.resource): (None, limit - st.util[:, self.resource])}

    def accept_move_terms(self, env: ClusterEnv, st: EngineState):
        """capacity.py:70: ``util[b] + l <= limit + eps``."""
        return [MoveTerm(int(self.resource), st.util[:, self.resource],
                         self._limit(env) + self._eps(env))]

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        util = st.util[:, self.resource]
        limit = self._limit(env) + self._eps(env)
        src = _inf_slack(env.num_brokers, env.device)
        dst = _inf_slack(env.num_brokers, env.device)
        dst[:, self.resource] = limit - util
        return src, dst

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        excess = torch.clamp(st.util[:, self.resource] - self._limit(env), min=0.0)
        return excess, torch.zeros_like(excess), self.resource

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        return self._limit(env) - st.util[:, self.resource]

    # -- leadership (CPU / NW_OUT shift with leadership) --
    def _lead_delta(self, env: ClusterEnv) -> torch.Tensor:
        """f32[R] what gaining leadership adds to a replica's broker."""
        return env.leader_load[:, self.resource] - env.follower_load[:, self.resource]

    def leader_key(self, env: ClusterEnv, st: EngineState, severity):
        """Online leaders of over-limit brokers by leader - follower delta
        (K1 keying)."""
        return sweep_keys(KEY_LEAD_DELTA, env, st, self.resource, [severity])

    def lead_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Feasible iff the member's broker stays under the limit after
        gaining the member's leader - follower delta; score 0.99 x the
        candidate's own delta (a slight preference for replica moves)."""
        delta = self._lead_delta(env)
        util = st.util[:, self.resource]
        fb = torch.stack([util, self._limit(env), torch.zeros_like(util)])
        if env.sweep_loads is None:
            score = delta[cand] * 0.99 + 0.0
        else:
            # the reference's bf16 program materializes the candidate's delta
            # and the score as bf16 arrays, 0.99 is a bf16 constant and its
            # simplifier drops the + 0.0 (a -0.0 delta keeps its sign)
            score = sweep_round(env, sweep_round(env, delta[cand]) * LEAD_SCORE_BF16)
        fk = torch.stack([score, torch.zeros_like(delta[cand])])
        return LeadTables(LEAD_CAPACITY, fb.contiguous(), fk.contiguous(),
                          fr=delta.contiguous())

    def lead_vetoes(self, env: ClusterEnv, st: EngineState, cand):
        limit = self._limit(env) + self._eps(env)
        return None, [Veto(st.util[:, self.resource].contiguous(), limit,
                           x_rep=self._lead_delta(env).contiguous())]

    def swap_accept(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """Net-aware (capacity.py:134-148): both brokers stay under the limit
        after the exchange, ``util -+ (l_out - l_in) <= limit + eps``."""
        def load(cand):
            return candidate_load(env, st, cand)[:, self.resource].contiguous()

        return SwapAccept(vetoes=[SwapVeto(
            VETO_NET_CAPACITY, st.util[:, self.resource].contiguous(),
            self._limit(env) + self._eps(env), load(cand_out), load(cand_in))])


@dataclasses.dataclass(frozen=True)
class CpuCapacityGoal(CapacityGoal):
    resource: int = 0

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "CpuCapacityGoal")


@dataclasses.dataclass(frozen=True)
class NetworkOutboundCapacityGoal(CapacityGoal):
    resource: int = 2

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "NetworkOutboundCapacityGoal")


@dataclasses.dataclass(frozen=True)
class NetworkInboundCapacityGoal(CapacityGoal):
    resource: int = 1

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "NetworkInboundCapacityGoal")
        object.__setattr__(self, "uses_leadership_moves", False)  # NW_IN leadership-invariant


@dataclasses.dataclass(frozen=True)
class DiskCapacityGoal(CapacityGoal):
    resource: int = 3

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "DiskCapacityGoal")
        object.__setattr__(self, "uses_leadership_moves", False)  # DISK leadership-invariant


@dataclasses.dataclass(frozen=True)
class ReplicaCapacityGoal(GoalKernel):
    """Max replicas per broker (ReplicaCapacityGoal.java:345)."""

    def __post_init__(self):
        object.__setattr__(self, "name", "ReplicaCapacityGoal")
        object.__setattr__(self, "is_hard", True)

    def _max(self) -> int:
        return self.constraint.max_replicas_per_broker

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        limit = torch.where(env.broker_alive, self._max(), 0)
        return (st.replica_count - limit).to(torch.float32)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        on_bad = severity[st.replica_broker] > 0
        load = load_sum(env, st)
        offline = st.replica_offline & env.replica_valid
        key = torch.where(env.replica_valid & on_bad, -load,
                          torch.full_like(load, NEG_INF))
        return offline_bump(env, key, offline)

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Feasible iff the destination stays within the cap; score prefers
        the most headroom."""
        feasible = (st.replica_count + 1) <= self._max()
        headroom = torch.clamp(self._max() - st.replica_count, min=0).to(torch.float32)
        score = 1.0 + 0.001 * headroom / max(self._max(), 1)
        col_f = torch.zeros((4, env.num_brokers), dtype=torch.float32, device=cand.device)
        col_f[0] = feasible.to(torch.float32)
        col_f[1] = score
        row_f = torch.zeros((cand.shape[0], 4), dtype=torch.float32, device=cand.device)
        return GOAL_REPLICA_CAPACITY, row_f, col_f

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        c = st.replica_count.to(torch.float32)
        return {WAVE_COUNT: (None, float(self._max()) - c)}

    def accept_move_terms(self, env: ClusterEnv, st: EngineState):
        """capacity.py:217: ``count[b] + 1 <= max`` (counts are f32-exact)."""
        c = st.replica_count.to(torch.float32)
        return [MoveTerm(WAVE_COUNT, c, torch.full_like(c, float(self._max())))]

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        c = st.replica_count.to(torch.float32)
        src = _inf_slack(env.num_brokers, env.device)
        dst = _inf_slack(env.num_brokers, env.device)
        dst[:, WAVE_COUNT] = float(self._max()) - c
        return src, dst

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        c = st.replica_count.to(torch.float32)
        excess = torch.clamp(c - float(self._max()), min=0.0)
        return excess, torch.zeros_like(excess), WAVE_COUNT

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        return float(self._max()) - st.replica_count.to(torch.float32)

    def swap_accept(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """Swaps are count-neutral: always accepted (capacity.py:246)."""
        return SwapAccept()
