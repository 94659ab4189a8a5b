"""Network-centric soft goals (counterpart of
``cruise_control_tpu/analyzer/goals/network.py``).

Reference: PotentialNwOutGoal.java:372 (each broker's potential outbound —
the NW_OUT it would serve if every hosted replica led — stays under the
NW_OUT capacity threshold) and LeaderBytesInDistributionGoal.java:293
(leader bytes-in under the balance upper limit, by leadership transfers).
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv, resource_balance_limits
from cruise_control_tpu_torch.analyzer.goals.base import (
    WAVE_DIMS, WAVE_LEADER_NW_IN, WAVE_POT_NW_OUT, GoalKernel, MoveTerm, sweep_keys, xla_sum,
)
from cruise_control_tpu_torch.analyzer.goals.capacity import resource_eps
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels.keys import KEY_LEAD_LOAD, KEY_POT_NW_OUT
from cruise_control_tpu_torch.kernels.leadership import LEAD_BYTES_IN, LeadTables, Veto
from cruise_control_tpu_torch.kernels.move_score import GOAL_CAPACITY
from cruise_control_tpu_torch.kernels.swap import VETO_DIRECTED, SwapAccept, SwapVeto

NW_IN = int(Resource.NW_IN)
NW_OUT = int(Resource.NW_OUT)


@dataclasses.dataclass(frozen=True)
class PotentialNwOutGoal(GoalKernel):
    def __post_init__(self):
        object.__setattr__(self, "name", "PotentialNwOutGoal")

    def _limit(self, env: ClusterEnv) -> torch.Tensor:
        thresh = self.constraint.capacity_threshold[NW_OUT]
        cap = env.broker_capacity[:, NW_OUT]
        return torch.where(env.broker_alive, thresh * cap, torch.zeros_like(cap))

    def _eps(self, env: ClusterEnv) -> torch.Tensor:
        return resource_eps(env.device, NW_OUT)

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        return st.potential_nw_out - self._limit(env) - self._eps(env)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        """Replicas of over-limit brokers by leader NW_OUT, offline first
        (K1 keying)."""
        return sweep_keys(KEY_POT_NW_OUT, env, st, NW_OUT, [severity])

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """The capacity family on potential NW_OUT: feasible iff pot + the
        replica's leader NW_OUT fits the limit."""
        limit = self._limit(env)
        pnw = st.potential_nw_out
        headroom = torch.clamp(limit - pnw, min=0.0)
        cap = torch.clamp(env.broker_capacity[:, NW_OUT], min=1e-6)
        row_f = torch.zeros((cand.shape[0], 4), dtype=torch.float32, device=cand.device)
        row_f[:, 0] = env.leader_load[cand, NW_OUT]
        row_f[:, 1] = st.replica_offline[cand].to(torch.float32)
        col_f = torch.stack([pnw, limit, 0.01 * headroom / cap, 1.0 + headroom / cap])
        return GOAL_CAPACITY, row_f, col_f

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        limit = self._limit(env) + self._eps(env)
        return {WAVE_POT_NW_OUT: (None, limit - st.potential_nw_out)}

    def accept_move_terms(self, env: ClusterEnv, st: EngineState):
        """network.py:59: ``pnw[b] + leader NW_OUT <= limit + eps``."""
        return [MoveTerm(WAVE_POT_NW_OUT, st.potential_nw_out,
                         self._limit(env) + self._eps(env))]

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        limit = self._limit(env) + self._eps(env)
        B = env.num_brokers
        src = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        dst = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        dst[:, WAVE_POT_NW_OUT] = limit - st.potential_nw_out
        return src, dst

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        excess = torch.clamp(st.potential_nw_out - self._limit(env), min=0.0)
        return excess, torch.zeros_like(excess), WAVE_POT_NW_OUT

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        return self._limit(env) - st.potential_nw_out

    def swap_accept(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """Both directed legs of ``accept_move`` (network.py:59-62): the
        destination's potential NW_OUT plus the arriving replica's leader
        NW_OUT fits the limit, ``pnw[b] + pot <= limit + eps``."""
        pot = env.leader_load[:, NW_OUT]
        return SwapAccept(vetoes=[SwapVeto(
            VETO_DIRECTED, st.potential_nw_out, self._limit(env) + self._eps(env),
            pot[cand_out].contiguous(), pot[cand_in].contiguous())])


@dataclasses.dataclass(frozen=True)
class LeaderBytesInDistributionGoal(GoalKernel):
    """Leader bytes-in under the balance upper limit; leadership transfers
    only."""

    def __post_init__(self):
        object.__setattr__(self, "name", "LeaderBytesInDistributionGoal")
        object.__setattr__(self, "uses_replica_moves", False)
        object.__setattr__(self, "uses_leadership_moves", True)
        object.__setattr__(self, "deep_tail", True)

    def _limits(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        """f32[B] upper limit of leader NW_IN (the reference enforces only
        the upper bound). The two f32 sums follow the oracle's order; the
        result is memoized per (env, leader_util) since a pass reads it
        several times."""
        memo = getattr(self, "_memo", None)
        if memo is not None and memo[0] is env and memo[1] is st.leader_util:
            return memo[2]
        alive = env.broker_alive
        cap = env.broker_capacity[:, NW_IN]
        zero = torch.zeros_like(cap)
        total = xla_sum(torch.where(alive, st.leader_util[:, NW_IN], zero))
        total_cap = torch.clamp(xla_sum(torch.where(alive, cap, zero)), min=1e-6)
        _lower, upper_pct = resource_balance_limits(
            total / total_cap, self.constraint, NW_IN,
            self.options.triggered_by_goal_violation)
        upper = torch.where(alive, upper_pct * cap, zero)
        object.__setattr__(self, "_memo", (env, st.leader_util, upper))
        return upper

    def _eps(self, env: ClusterEnv) -> torch.Tensor:
        return resource_eps(env.device, NW_IN)

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        return st.leader_util[:, NW_IN] - self._limits(env, st) - self._eps(env)

    def leader_key(self, env: ClusterEnv, st: EngineState, severity):
        """Online leaders of over-limit brokers by leader NW_IN (K1 keying)."""
        return sweep_keys(KEY_LEAD_LOAD, env, st, NW_IN, [severity])

    def lead_tables(self, env: ClusterEnv, st: EngineState, cand):
        """Feasible iff the member's broker stays within the upper limit
        after gaining the partition's leader bytes-in; score the excess the
        source sheds."""
        upper = self._limits(env, st)
        util = st.leader_util[:, NW_IN]
        src = st.replica_broker[cand]
        lin = env.leader_load[cand, NW_IN]
        excess_red = torch.minimum(torch.clamp(util[src] - upper[src], min=0.0), lin)
        fb = torch.stack([util, upper, torch.zeros_like(util)])
        return LeadTables(LEAD_BYTES_IN, fb.contiguous(),
                          torch.stack([lin, excess_red]).contiguous())

    def lead_vetoes(self, env: ClusterEnv, st: EngineState, cand):
        upper = self._limits(env, st)
        return None, [Veto(st.leader_util[:, NW_IN].contiguous(),
                           upper + self._eps(env),
                           x_row=env.leader_load[cand, NW_IN].contiguous())]

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        upper = self._limits(env, st) + self._eps(env)
        B = env.num_brokers
        src = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        dst = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        dst[:, WAVE_LEADER_NW_IN] = upper - st.leader_util[:, NW_IN]
        return src, dst

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        excess = torch.clamp(st.leader_util[:, NW_IN] - self._limits(env, st), min=0.0)
        return excess, torch.zeros_like(excess), WAVE_LEADER_NW_IN

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        return self._limits(env, st) - st.leader_util[:, NW_IN]
