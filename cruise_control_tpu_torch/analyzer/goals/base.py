"""Goal kernel SPI, move path (counterpart of
``cruise_control_tpu/analyzer/goals/base.py``).

A goal is a frozen dataclass of pure functions over (ClusterEnv,
EngineState):

- ``broker_severity``  f32[B]: > 0 where the goal needs work on that broker;
- ``replica_key``      f32[R]: ranking of replicas worth moving (-inf = not
  a candidate), fed to the K1 top-k;
- ``move_tables``      the goal's score in the K2 kernel's family form: a
  goal family id plus f32[K, 4] per-row and f32[4, B] per-broker tables
  computed with the reference's own arithmetic (``kernels.move_score``);
- ``accept_move_rooms`` / ``wave_budgets`` / ``wave_gain_budgets``: the
  interval forms of acceptance and the cumulative wave budgets;
- ``violated`` / ``stat``.

The reference's [K, B] ``legit_move_mask`` is evaluated inside the K2
kernel; ``legit_move_rows`` prepares its per-row and per-broker inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import (
    BalancingConstraint, ClusterEnv, OptimizationOptions,
)
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.kernels.select import mul32

NEG_INF = -torch.inf

# Budgeted-wave delta dimensions (engine-wide convention): what one applied
# action adds to its destination broker / removes from its source broker.
#   0..3  utilization delta (CPU, NW_IN, NW_OUT, DISK)
#   4     replica count      5  leader count
#   6     potential NW_OUT   7  leader NW_IN (0 in move waves)
WAVE_DIMS = 8
WAVE_COUNT = 4
WAVE_LEADER_COUNT = 5
WAVE_POT_NW_OUT = 6
WAVE_LEADER_NW_IN = 7
# zero-delta rows of these dims pass their rooms outright
WAVE_ZERO_EXEMPT_DIMS = (WAVE_LEADER_COUNT,)


def row_sum4(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 resource columns, left to right (the oracle's order)."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]


@dataclasses.dataclass(frozen=True)
class GoalKernel:
    """Base goal. Subclasses override the kernel methods; all fields static."""
    constraint: BalancingConstraint = BalancingConstraint()
    options: OptimizationOptions = OptimizationOptions()

    name: str = dataclasses.field(default="GoalKernel", init=False)
    is_hard: bool = dataclasses.field(default=False, init=False)
    uses_replica_moves: bool = dataclasses.field(default=True, init=False)
    uses_leadership_moves: bool = dataclasses.field(default=False, init=False)
    uses_swaps: bool = dataclasses.field(default=False, init=False)
    uses_disk_moves: bool = dataclasses.field(default=False, init=False)
    leadership_primary: bool = dataclasses.field(default=False, init=False)
    # acceptance can't be broken by a multi-move wave under the partition
    # first-touch rule (rack/topic structured goals)
    wave_safe: bool = dataclasses.field(default=False, init=False)
    deep_tail: bool = dataclasses.field(default=False, init=False)
    # a previous-goal veto with no interval form (RackAwareGoal): the K2
    # kernel evaluates it from the partition's per-rack counts
    rack_veto: bool = dataclasses.field(default=False, init=False)

    def broker_severity(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        raise NotImplementedError

    def replica_key(self, env: ClusterEnv, st: EngineState,
                    severity: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def move_tables(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """(family, row_f f32[K, 4], col_f f32[4, B]) of ``move_score``."""
        raise NotImplementedError

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        """Optional ``{dim: (src_room[B] | None, dst_room[B] | None)}``."""
        return None

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        """Optional ``(src_slack[B, WAVE_DIMS], dst_slack[B, WAVE_DIMS])``."""
        return None

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        """Optional ``(src_gain[B], dst_gain[B], dim)`` of the ACTIVE goal."""
        return None

    def violated(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        return (self.broker_severity(env, st) > 0).any()

    def stat(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        """Scalar the goal tries to reduce."""
        return torch.clamp(self.broker_severity(env, st), min=0.0).sum()


def broker_lookup(rb: torch.Tensor, *cols: torch.Tensor) -> torch.Tensor:
    """f32[R, len(cols)]: per-broker columns gathered at replica positions."""
    return torch.stack([c.to(torch.float32) for c in cols], dim=1)[rb]


def spread_jitter(num_replicas: int, device) -> torch.Tensor:
    """[R] deterministic per-replica multiplier in [0.5, 1.0) (the uint32
    hash of base.py:340-360) that keeps one many-light-replica broker from
    monopolizing the candidate pool."""
    idx = torch.arange(num_replicas, dtype=torch.int64, device=device)
    h = mul32(idx, 2654435761)
    return 0.5 + (h >> 9).to(torch.float32) / 16777216.0


def candidate_load(env: ClusterEnv, st: EngineState, cand: torch.Tensor) -> torch.Tensor:
    """f32[K, M] current effective load rows of the candidate replicas."""
    lead = st.replica_is_leader[cand][:, None]
    return torch.where(lead, env.leader_load[cand], env.follower_load[cand])


def legit_move_rows(env: ClusterEnv, st: EngineState, cand: torch.Tensor,
                    options: OptimizationOptions):
    """Inputs of the [K, B] ``legit_move_mask`` (base.py:369-414) that the K2
    kernel expands: ``sib_b`` i64[K, F] (brokers hosting another replica of
    the candidate's partition, -1 elsewhere), ``replica_ok`` bool[K] (valid,
    topic not excluded unless offline, offline-only mode), and the broker
    masks ``dst_ok`` (allowed destination) and ``new_ok`` (no new brokers,
    or b is new; the back-home exception is per row)."""
    members = env.partition_replicas[env.replica_partition[cand]]          # [K, F]
    member_broker = st.replica_broker[torch.clamp(members, min=0)]
    sibling = (members >= 0) & (members != cand[:, None])
    sib_b = torch.where(sibling, member_broker, torch.full_like(member_broker, -1))
    offline = st.replica_offline[cand]
    topic_ok = ~env.topic_excluded[env.replica_topic[cand]] | offline
    replica_ok = env.replica_valid[cand] & topic_ok
    if options.fix_offline_replicas_only:
        replica_ok = replica_ok & offline
    new_ok = env.broker_new | ~env.broker_new.any()
    return sib_b.contiguous(), replica_ok, env.dst_candidate, new_ok
