"""Soft distribution goals (counterpart of
``cruise_control_tpu/analyzer/goals/distribution.py``).

Reference: ResourceDistributionGoal.java (balance thresholds :239-282,
move-out / move-in / leadership / swaps :384-862) with its four
per-resource subclasses, and ReplicaDistributionAbstractGoal.java (limit
math :70-90) with ReplicaDistributionGoal.java:356 and
LeaderReplicaDistributionGoal.java:369. Resource limits are avg utilization
% over alive brokers times (1 +- (pct - 1) * 0.9) with the low-utilization
cases (GoalUtils.java:515); count limits are ceil/floor of avg * (1 +-
(pct - 1) * 0.9); all in f32 like the reference. Scores are
violation-measure gains; an action may not create a NEW violation at
either endpoint.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.env import (
    BALANCE_MARGIN, ClusterEnv, resource_balance_limits,
)
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, WAVE_COUNT, WAVE_DIMS, WAVE_LEADER_COUNT, GoalKernel, MoveTerm, broker_lookup,
    candidate_load, load_sum, row_sum4, spread_jitter, sweep_keys, sweep_round, xla_sum,
)
from cruise_control_tpu_torch.analyzer.goals.capacity import resource_eps
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.kernels.keys import (
    KEY_DIST, KEY_LEAD_DELTA, KEY_SWAP_IN, KEY_SWAP_OUT,
)
from cruise_control_tpu_torch.kernels.leadership import (
    LEAD_CAPACITY, LEAD_LEADER_DIST, LeadTables, Veto,
)
from cruise_control_tpu_torch.kernels.move_score import (
    GOAL_LEADER_DIST, GOAL_REPLICA_DIST, GOAL_RESOURCE_DIST,
)
from cruise_control_tpu_torch.kernels.swap import (
    SWAP_RESOURCE_DIST, VETO_DIRECTED_EXEMPT, VETO_NET_BAND, SwapAccept, SwapTables,
    SwapVeto,
)


def _violation(u, lower, upper):
    return torch.clamp(u - upper, min=0.0) + torch.clamp(lower - u, min=0.0)


@dataclasses.dataclass(frozen=True)
class ResourceDistributionGoal(GoalKernel):
    """Each alive broker's utilization of ``resource`` inside the balance
    band (ResourceDistributionGoal.java). Moves, leadership transfers (CPU
    and NW_OUT follow leadership) and, as the last resort of a pass, swaps."""
    resource: int = 3  # DISK

    def __post_init__(self):
        object.__setattr__(self, "uses_leadership_moves", self.resource in (0, 2))
        object.__setattr__(self, "deep_tail", True)
        object.__setattr__(self, "uses_swaps", True)

    def _eps(self, env: ClusterEnv) -> torch.Tensor:
        return resource_eps(env.device, self.resource)

    def _limits(self, env: ClusterEnv, st: EngineState):
        """(lower[B], upper[B]) absolute utilization limits; dead broker 0/0.
        The two f32 sums follow the oracle's order; memoized per (env,
        util) since a pass reads them several times."""
        memo = getattr(self, "_memo", None)
        if memo is not None and memo[0] is env and memo[1] is st.util:
            return memo[2]
        alive = env.broker_alive
        cap = env.broker_capacity[:, self.resource]
        zero = torch.zeros_like(cap)
        total_util = xla_sum(torch.where(alive, st.util[:, self.resource], zero))
        total_cap = torch.clamp(xla_sum(torch.where(alive, cap, zero)), min=1e-6)
        lower_pct, upper_pct = resource_balance_limits(
            total_util / total_cap, self.constraint, self.resource,
            self.options.triggered_by_goal_violation)
        limits = (torch.where(alive, lower_pct * cap, zero),
                  torch.where(alive, upper_pct * cap, zero))
        object.__setattr__(self, "_memo", (env, st.util, limits))
        return limits

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        eps = self._eps(env)
        return torch.maximum(util - upper - eps, lower - util - eps)

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        """Replicas that can land somewhere, on excess brokers (or donors
        when some broker is deficient), by their fraction of their broker's
        utilization; offline replicas first."""
        lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        eps = self._eps(env)
        any_deficit = ((lower - util) > eps).any()
        headroom = torch.where(env.dst_candidate, upper - util,
                               torch.full_like(util, NEG_INF))
        # K1 keying: excess source (util - upper > eps) or a donor
        # (util - load >= lower) while some broker is deficient, the load
        # fitting max(headroom) + eps; key load / util, offline first
        return sweep_keys(KEY_DIST, env, st, self.resource, [util - upper, util, lower],
                          [eps, any_deficit, headroom.max() + eps])

    def move_tables(self, env: ClusterEnv, st: EngineState, cand):
        """``_gain(util[src], util[b], l, ...)`` (the source's violations
        before and after per row, the destination's on the kernel side);
        offline healing scores 1 + max(upper - util - l, 0) / capacity."""
        l = candidate_load(env, st, cand)[:, self.resource]
        lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        src = st.replica_broker[cand]
        vso = _violation(util[src], lower[src], upper[src])
        vsn = _violation(util[src] - l, lower[src], upper[src])
        row_f = torch.stack([vso, vsn, l, st.replica_offline[cand].to(torch.float32)],
                            dim=1)
        cap = torch.clamp(env.broker_capacity[:, self.resource], min=1e-6)
        return GOAL_RESOURCE_DIST, row_f, torch.stack([util, lower, upper, cap])

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        eps = self._eps(env)
        src = torch.where(util > upper, torch.full_like(util, torch.inf),
                          util - lower + eps)
        return {int(self.resource): (src, upper - util + eps)}

    def accept_move_terms(self, env: ClusterEnv, st: EngineState):
        """distribution.py:161: ``util[b] + l <= upper + eps``."""
        _lower, upper = self._limits(env, st)
        return [MoveTerm(int(self.resource), st.util[:, self.resource],
                         upper + self._eps(env))]

    def accept_move_source(self, env: ClusterEnv, st: EngineState, cand):
        """distribution.py:170-173: ``util[src] - l >= lower[src] - eps``, or
        the source already above ``upper``."""
        l = candidate_load(env, st, cand)[:, self.resource]
        lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        src = st.replica_broker[cand]
        return (util[src] - l >= lower[src] - self._eps(env)) | (util[src] > upper[src])

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        eps = self._eps(env)
        B = env.num_brokers
        src = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        dst = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32, device=env.device)
        src[:, self.resource] = util - lower + eps
        dst[:, self.resource] = upper - util + eps
        return src, dst

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        return (torch.clamp(util - upper, min=0.0), torch.clamp(lower - util, min=0.0),
                self.resource)

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        _lower, upper = self._limits(env, st)
        return upper - st.util[:, self.resource]

    # -- leadership (CPU and NW_OUT follow leadership) --
    def _lead_delta(self, env: ClusterEnv) -> torch.Tensor:
        return env.leader_load[:, self.resource] - env.follower_load[:, self.resource]

    def leader_key(self, env: ClusterEnv, st: EngineState, severity):
        _lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        # K1 keying: online leaders on excess brokers (util - upper > eps)
        # by leader - follower delta
        return sweep_keys(KEY_LEAD_DELTA, env, st, self.resource, [util - upper],
                          [self._eps(env)])

    def lead_tables(self, env: ClusterEnv, st: EngineState, cand):
        """The capacity family: feasible iff the member's broker stays under
        ``upper`` after gaining the member's leader - follower delta
        (``max(u + d - up, 0) <= 0``); the score is the excess the source
        sheds, -inf where it sheds none."""
        _lower, upper = self._limits(env, st)
        util = st.util[:, self.resource]
        delta = self._lead_delta(env)
        src = st.replica_broker[cand]
        # the reference's bf16 program materializes the candidate's delta as
        # a bf16 array (``[:, None]`` after the subtraction); the members'
        # deltas ``fr`` enter their sums unrounded
        gain = torch.minimum(torch.clamp(util[src] - upper[src], min=0.0),
                             sweep_round(env, delta[cand]))
        gain = torch.where(gain > 0, gain, torch.full_like(gain, NEG_INF))
        fb = torch.stack([util, upper, torch.zeros_like(util)])
        fk = torch.stack([gain, torch.zeros_like(gain)])
        return LeadTables(LEAD_CAPACITY, fb.contiguous(), fk.contiguous(),
                          fr=delta.contiguous())

    def lead_vetoes(self, env: ClusterEnv, st: EngineState, cand):
        _lower, upper = self._limits(env, st)
        return None, [Veto(st.util[:, self.resource].contiguous(),
                           (upper + self._eps(env)).contiguous(),
                           x_rep=self._lead_delta(env).contiguous())]

    # -- swaps (rebalanceBySwappingLoadOut/In, ResourceDistributionGoal.java:598,:697) --
    def swap_out_key(self, env: ClusterEnv, st: EngineState, severity):
        """Replicas on out-of-band brokers, largest load first."""
        return sweep_keys(KEY_SWAP_OUT, env, st, self.resource, [severity])

    def swap_in_key(self, env: ClusterEnv, st: EngineState, severity):
        """Replicas on brokers not above the upper limit, smallest first."""
        _lower, upper = self._limits(env, st)
        return sweep_keys(KEY_SWAP_IN, env, st, self.resource,
                          [st.util[:, self.resource] - upper])

    def _swap_loads(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        return (candidate_load(env, st, cand_out)[:, self.resource].contiguous(),
                candidate_load(env, st, cand_in)[:, self.resource].contiguous())

    def swap_tables(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """``_gain(util[b_out], util[b_in], l_out - l_in, ...) x 0.95``
        (kernel side)."""
        lower, upper = self._limits(env, st)
        l_out, l_in = self._swap_loads(env, st, cand_out, cand_in)
        fb = torch.stack([st.util[:, self.resource], lower, upper]).contiguous()
        return SwapTables(SWAP_RESOURCE_DIST, fb=fb, x_out=l_out, x_in=l_in)

    def swap_accept(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """Net-aware (distribution.py:259-273): neither endpoint newly out
        of band after the exchange."""
        lower, upper = self._limits(env, st)
        l_out, l_in = self._swap_loads(env, st, cand_out, cand_in)
        return SwapAccept(vetoes=[SwapVeto(
            VETO_NET_BAND, st.util[:, self.resource].contiguous(), upper.contiguous(),
            l_out, l_in, lo=lower.contiguous())])


@dataclasses.dataclass(frozen=True)
class CpuUsageDistributionGoal(ResourceDistributionGoal):
    resource: int = 0

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "CpuUsageDistributionGoal")


@dataclasses.dataclass(frozen=True)
class NetworkInboundUsageDistributionGoal(ResourceDistributionGoal):
    resource: int = 1

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "NetworkInboundUsageDistributionGoal")


@dataclasses.dataclass(frozen=True)
class NetworkOutboundUsageDistributionGoal(ResourceDistributionGoal):
    resource: int = 2

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "NetworkOutboundUsageDistributionGoal")


@dataclasses.dataclass(frozen=True)
class DiskUsageDistributionGoal(ResourceDistributionGoal):
    resource: int = 3

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "DiskUsageDistributionGoal")


# ---------------------------------------------------------------------------
# Count-based distribution
# ---------------------------------------------------------------------------
def _count_limits(counts_total, n_alive, balance_pct, triggered, multiplier):
    """(lower, upper) f32 integer limits (ReplicaDistributionAbstractGoal.java:70-90)."""
    f32 = np.float32
    avg = counts_total / torch.clamp(n_alive, min=1)
    # the band factors in f32 on the host, as the reference folds them
    adj = (f32(balance_pct * multiplier if triggered else balance_pct) - f32(1.0)) \
        * f32(BALANCE_MARGIN)
    upper = torch.ceil(avg * float(f32(1.0) + adj))
    lower = torch.floor(avg * float(max(f32(0.0), f32(1.0) - adj)))
    return lower.to(torch.float32), upper.to(torch.float32)


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
        load = load_sum(env, st)
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

    def accept_move_terms(self, env: ClusterEnv, st: EngineState):
        """distribution.py:381: ``count[b] + 1 <= upper``."""
        _lower, upper = self._limits(env, st)
        return [MoveTerm(WAVE_COUNT, st.replica_count.to(torch.float32), upper)]

    def accept_move_source(self, env: ClusterEnv, st: EngineState, cand):
        """distribution.py:386: ``count[src] - 1 >= lower[src]``, or the
        source above ``upper``."""
        lower, upper = self._limits(env, st)
        c = st.replica_count.to(torch.float32)
        src = st.replica_broker[cand]
        return (c[src] - 1 >= lower[src]) | (c[src] > upper[src])

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

    def swap_accept(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """Swaps are count-neutral: always accepted (distribution.py:421)."""
        return SwapAccept()


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
        load = load_sum(env, st)
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

    def accept_move_terms(self, env: ClusterEnv, st: EngineState):
        """distribution.py:474: ``leaders[b] + 1 <= upper`` for rows that
        move a leader (a follower row's zero delta is exempt)."""
        _lower, upper = self._limits(env, st)
        return [MoveTerm(WAVE_LEADER_COUNT, st.leader_count.to(torch.float32), upper,
                         exempt=True)]

    def accept_move_source(self, env: ClusterEnv, st: EngineState, cand):
        """distribution.py:479-482: a leader row needs ``leaders[src] - 1 >=
        lower[src]`` or its source above ``upper``; a follower row passes."""
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)
        src = st.replica_broker[cand]
        src_ok = (c[src] - 1 >= lower[src]) | (c[src] > upper[src])
        return ~st.replica_is_leader[cand] | src_ok

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

    def swap_accept(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """Both directed legs of ``accept_move`` (distribution.py:474): a
        leg that moves a leader needs room under ``upper`` at its
        destination (``c + 1 <= upper``) and its source above ``lower`` (or
        in excess); a follower leg passes."""
        lower, upper = self._limits(env, st)
        c = st.leader_count.to(torch.float32)

        def leg(cand):
            lead = st.replica_is_leader[cand]
            src = st.replica_broker[cand]
            src_ok = (c[src] - 1 >= lower[src]) | (c[src] > upper[src])
            return ~lead | src_ok, lead.to(torch.float32)

        row_out, x_out = leg(cand_out)
        row_in, x_in = leg(cand_in)
        return SwapAccept(row_out=row_out, row_in=row_in, vetoes=[SwapVeto(
            VETO_DIRECTED_EXEMPT, c.contiguous(), upper.contiguous(), x_out, x_in)])
