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
- ``accept_move_terms`` / ``accept_move_source`` / ``accept_move``: the
  interval-form ``accept_move`` in the goal's own arithmetic (destination
  terms ``lhs[b] + d <= bound[b]`` for K2's per-goal veto form, the source
  rows, and their [K, B] composition);
- ``leader_key`` / ``lead_tables`` / ``lead_vetoes``: the leadership
  counterparts (``leader_key`` f32[R] feeds K1; ``lead_tables`` is the
  goal's ``leadership_score`` in the K6 kernel's family form and
  ``lead_vetoes`` its ``accept_leadership`` as a previously optimized goal,
  see ``kernels.leadership``);
- ``wave_topic_budgets`` / ``segment_room_key``: per-(topic, broker) wave
  budgets and the finisher's broker-coloring key;
- ``swap_out_key`` / ``swap_in_key`` / ``swap_tables`` / ``swap_accept``:
  the swap counterparts (the two K1 keys; ``swap_score`` in the K7
  kernel's family form; ``accept_swap`` as a previously optimized goal, see
  ``kernels.swap``);
- ``disk_rule`` / ``disk_move_score`` / ``accept_disk_move``: the
  intra-broker disk counterparts (``disk_rule`` is the goal's
  ``disk_move_score`` and ``accept_disk_move`` in the K8 kernels' family
  form, see ``kernels.disk``; None for a goal indifferent to logdirs);
- ``violated`` / ``stat``.

The reference's [K, B] ``legit_move_mask``, [K, F]
``legit_leadership_mask``, [K1, K2] ``legit_swap_mask`` and [K, D]
``legit_disk_move_mask`` are evaluated inside the K2 / K6 / K7 / K8
kernels; ``legit_move_rows`` / ``legit_lead_rows`` / ``swap_pairs`` /
``disk_state`` prepare their inputs. ``move_score`` /
``leadership_score`` / ``accept_leadership`` / ``swap_score`` /
``accept_swap`` give the plain values of the same tables (the kernels'
twins), for tests and for the reader.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from cruise_control_tpu_torch.analyzer.env import (
    BalancingConstraint, ClusterEnv, OptimizationOptions,
)
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import disk as disk_k
from cruise_control_tpu_torch.kernels import leadership as lead_k
from cruise_control_tpu_torch.kernels import move_score as move_k
from cruise_control_tpu_torch.kernels import probe as probe_k
from cruise_control_tpu_torch.kernels import swap as swap_k
from cruise_control_tpu_torch.kernels.keys import OFFLINE_BUMP_BF16, env_loads, replica_keys
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


XLA_SUM_WINDOW = 32


@dataclasses.dataclass(frozen=True)
class MoveTerm:
    """One destination-side term of a goal's ``accept_move``: a move row k
    to broker b passes iff ``lhs[b] + d[k, dim] <= bound[b]`` in f32 (add,
    then compare), or ``exempt`` and ``d[k, dim] == 0``. ``lhs`` is the
    state's column of ``dim`` (``util[:, dim]`` for dims 0-3,
    ``replica_count``, ``leader_count``, ``potential_nw_out``) as the goal
    reads it; ``bound`` the goal's own (``upper + eps``, not ``upper - util
    + eps``)."""
    dim: int
    lhs: torch.Tensor
    bound: torch.Tensor
    exempt: bool = False


def _seq_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right f32 sum over dim 1 of [m, w], starting from +0.0."""
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum of a 1-D tensor in the CPU oracle's order. XLA rewrites a
    long reduce into windows of 32 (the input padded with zeros evenly on
    both sides), each window summed left to right from +0.0, recursively,
    and sums the last <= 32 values left to right."""
    while x.shape[0] > XLA_SUM_WINDOW:
        n = x.shape[0]
        m = -(-n // XLA_SUM_WINDOW)
        lo = (m * XLA_SUM_WINDOW - n) // 2
        xp = torch.zeros(m * XLA_SUM_WINDOW, dtype=x.dtype, device=x.device)
        xp[lo:lo + n] = x
        x = _seq_sum_rows(xp.view(m, XLA_SUM_WINDOW))
    return _seq_sum_rows(x[None, :])[0]


def row_sum4(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 resource columns, left to right (the oracle's order)."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]


def sweep_round(env: ClusterEnv, x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (and upcast) on the bf16 sweep view, where the
    reference materializes a bf16 array; the identity on the f32 env."""
    return x if env.sweep_loads is None else x.to(torch.bfloat16).float()


def load_sum(env: ClusterEnv, st: EngineState) -> torch.Tensor:
    """f32[R] sum of each replica's effective load over the four resources
    (``jnp.sum(effective_load, axis=1)``; a bf16 array under the bf16
    policy, so rounded there)."""
    return sweep_round(env, row_sum4(st.effective_load(env)))


def offline_bump(env: ClusterEnv, key: torch.Tensor, offline: torch.Tensor) -> torch.Tensor:
    """``where(offline, key + 1e12, key)`` of a key that is a bf16 array in
    the reference under the bf16 policy: there the constant is bf16(1e12)
    and the result is rounded to bf16."""
    if env.sweep_loads is None:
        return torch.where(offline, key + 1e12, key)
    return sweep_round(env, torch.where(offline, key + OFFLINE_BUMP_BF16, key))


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

    def broker_severity(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        raise NotImplementedError

    def replica_key(self, env: ClusterEnv, st: EngineState,
                    severity: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def move_tables(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """(family, row_f f32[K, 4], col_f f32[4, B]) of ``move_score``."""
        raise NotImplementedError

    def rack_limit(self, env: ClusterEnv, part: torch.Tensor):
        """Optional i32[K]: a rack goal's ``accept_move`` as a previous goal,
        the most replicas of partition ``part[k]`` one rack may hold
        (``others + 1 <= limit``, evaluated by the K2 and K7 kernels from
        the partitions' per-rack counts)."""
        return None

    def move_row_veto(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """Optional bool[K]: a custom ``accept_move`` veto that depends on
        the row only (it is folded into the K2 kernel's row legitimacy)."""
        return None

    def move_score(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """f32[K, B] score of moving candidate k to broker b (no legitimacy):
        the K2 twin's arithmetic on this goal's tables."""
        family, row_f, col_f = self.move_tables(env, st, cand)
        others = None
        if family in move_k.RACK_FAMILIES:
            others = move_k.rack_others(partition_rack_rows(env, st, cand),
                                        st.replica_broker[cand], env.broker_rack)
        return move_k.goal_score_plain(family, others, row_f, col_f, cand.shape[0],
                                       env.num_brokers,
                                       self.move_topic_table(env, st, cand))

    def move_topic_table(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """(row_t i64[K], i32[T, B] table) of a family that reads a
        per-(topic, broker) count (MinTopicLeadersPerBrokerGoal,
        TopicReplicaDistributionGoal)."""
        return None

    def move_topic_veto(self, env: ClusterEnv, st: EngineState):
        """Optional f32[T]: a custom ``accept_move`` veto on the destination's
        (row topic, broker) replica count, ``count[t, b] + 1 <= up[t]``
        (TopicReplicaDistributionGoal; the K2 and K7 kernels evaluate it)."""
        return None

    def accept_move_rooms(self, env: ClusterEnv, st: EngineState):
        """Optional ``{dim: (src_room[B] | None, dst_room[B] | None)}``."""
        return None

    def accept_move_terms(self, env: ClusterEnv, st: EngineState):
        """Optional [MoveTerm, ...]: the destination side of this goal's
        interval-form ``accept_move`` in the goal's own arithmetic (K2's
        per-goal veto form, ``chain_cache=False``). None: no interval form."""
        return None

    def accept_move_source(self, env: ClusterEnv, st: EngineState,
                           cand: torch.Tensor):
        """Optional bool[K]: the source side of the interval-form
        ``accept_move``, one comparison per row in the reference's form."""
        return None

    def accept_move(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """bool[K, B] veto as a previously optimized goal (base.py:129): the
        source rows AND every term, ``lhs[b] + d[k, dim] <= bound[b]`` (zero
        deltas pass an exempt term). The plain twin of K2's per-goal form;
        accepts everything without terms. The rack, row and topic vetoes
        have no [K, B] form here: K2 evaluates them from ``rack_limit``,
        ``move_row_veto`` and ``move_topic_veto``."""
        if (overrides(self, "rack_limit") or overrides(self, "move_row_veto")
                or overrides(self, "move_topic_veto")):
            raise NotImplementedError(f"{self.name}: a custom veto has no [K, B] form")
        K, B = cand.shape[0], env.num_brokers
        ok = torch.ones((K, B), dtype=torch.bool, device=env.device)
        src = self.accept_move_source(env, st, cand)
        if src is not None:
            ok = ok & src[:, None]
        d = move_delta_rows(env, st, cand)
        for t in self.accept_move_terms(env, st) or ():
            dd = d[:, t.dim:t.dim + 1]
            okt = (t.lhs[None, :] + dd) <= t.bound[None, :]
            if t.exempt:
                okt = okt | (dd == 0)
            ok = ok & okt
        return ok

    def wave_budgets(self, env: ClusterEnv, st: EngineState):
        """Optional ``(src_slack[B, WAVE_DIMS], dst_slack[B, WAVE_DIMS])``."""
        return None

    def wave_gain_budgets(self, env: ClusterEnv, st: EngineState):
        """Optional ``(src_gain[B], dst_gain[B], dim)`` of the ACTIVE goal."""
        return None

    def wave_topic_budgets(self, env: ClusterEnv, st: EngineState, topics,
                           src_b, dst_b, d_count, d_leader):
        """Optional ``(delta f32[N], src_slack f32[N], dst_slack f32[N])``:
        the goal's per-(topic, broker) count constraint in wave form."""
        return None

    def segment_room_key(self, env: ClusterEnv, st: EngineState):
        """Optional f32[B] destination-room key of the finisher's broker
        coloring (None: the chain's combined rooms decide)."""
        return None

    # --- leadership -------------------------------------------------------
    def leader_key(self, env: ClusterEnv, st: EngineState, severity):
        return torch.full((env.num_replicas,), NEG_INF, dtype=torch.float32,
                          device=env.device)

    def lead_tables(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """``kernels.leadership.LeadTables`` of ``leadership_score``."""
        raise NotImplementedError(f"{self.name} has no leadership score")

    def lead_vetoes(self, env: ClusterEnv, st: EngineState, cand: torch.Tensor):
        """(row_ok bool[K] | None, [Veto, ...]): this goal's
        ``accept_leadership`` as a previously optimized goal. Default:
        accept everything."""
        return None, []

    def leadership_score(self, env: ClusterEnv, st: EngineState, cand):
        """f32[K, F] (no legitimacy): the K6 twin's score on the tables."""
        members = lead_member_rows(env, cand)
        return lead_k.family_score_plain(self.lead_tables(env, st, cand),
                                         members, st.replica_broker)

    def accept_leadership(self, env: ClusterEnv, st: EngineState, cand):
        """bool[K, F] veto as a previously optimized goal."""
        members = lead_member_rows(env, cand)
        row_ok, vetoes = self.lead_vetoes(env, st, cand)
        ok = lead_k.vetoes_plain(vetoes, members, st.replica_broker)
        if row_ok is not None:
            ok = ok & row_ok[:, None]
        return ok

    # --- swaps ------------------------------------------------------------
    def swap_out_key(self, env: ClusterEnv, st: EngineState, severity):
        """f32[R] ranking of replicas to swap OUT of violating brokers."""
        return torch.full((env.num_replicas,), NEG_INF, dtype=torch.float32,
                          device=env.device)

    def swap_in_key(self, env: ClusterEnv, st: EngineState, severity):
        """f32[R] ranking of replicas to swap IN."""
        return torch.full((env.num_replicas,), NEG_INF, dtype=torch.float32,
                          device=env.device)

    def swap_tables(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """``kernels.swap.SwapTables`` of ``swap_score``."""
        raise NotImplementedError(f"{self.name} has no swap score")

    def swap_accept(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """``kernels.swap.SwapAccept``: this goal's ``accept_swap`` as a
        previously optimized goal. The default (base.py:236-246) is both
        directed legs of ``accept_move`` in its own arithmetic: the rack
        legs (each side's rack limit), the row-only veto of each side and
        the topic veto's destination legs. A goal whose ``accept_move`` has
        an interval form overrides this (never with its rooms, which may
        differ by one ulp)."""
        if overrides(self, "accept_move_rooms"):
            raise NotImplementedError(f"{self.name}: accept_swap of an interval-"
                                      f"form accept_move must be written out")
        row_out = row_in = None
        if overrides(self, "move_row_veto"):
            row_out = self.move_row_veto(env, st, cand_out)
            row_in = self.move_row_veto(env, st, cand_in)
        return swap_k.SwapAccept(
            row_out=row_out, row_in=row_in,
            lim_out=self.rack_limit(env, env.replica_partition[cand_out]),
            lim_in=self.rack_limit(env, env.replica_partition[cand_in]),
            topic_up=self.move_topic_veto(env, st))

    def swap_score(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """f32[K1, K2] (no legitimacy): the K7 twin's score on the tables."""
        pairs = swap_pairs(env, st, cand_out, cand_in, ())
        return swap_k.family_score_plain(
            pairs, self.swap_tables(env, st, cand_out, cand_in))

    def accept_swap(self, env: ClusterEnv, st: EngineState, cand_out, cand_in):
        """bool[K1, K2] veto as a previously optimized goal."""
        acc = self.swap_accept(env, st, cand_out, cand_in)
        ones_out = torch.ones(cand_out.shape[0], dtype=torch.bool, device=env.device)
        ones_in = torch.ones(cand_in.shape[0], dtype=torch.bool, device=env.device)
        pairs = swap_pairs(env, st, cand_out, cand_in, (acc,), ones_out, ones_in)
        return (swap_k.vetoes_plain(pairs) & pairs.row_ok_out[:, None]
                & pairs.row_ok_in[None, :])

    # --- intra-broker disk moves ----------------------------------------
    def disk_rule(self):
        """``kernels.disk.DiskRule`` of this goal's ``disk_move_score`` and
        ``accept_disk_move``; None: no disk score, every disk move accepted
        (broker-level goals are indifferent to logdir placement)."""
        return None

    def disk_move_score(self, env: ClusterEnv, st: EngineState, cand):
        """f32[K, D] (no legitimacy): improvement from moving candidate k to
        logdir d of its own broker; -inf where not self-satisfied."""
        rule = self.disk_rule()
        if rule is None:
            return torch.full((cand.shape[0], env.broker_disk_capacity.shape[1]),
                              NEG_INF, dtype=torch.float32, device=env.device)
        return disk_k.score_plain(rule, disk_state(env, st), cand)

    def accept_disk_move(self, env: ClusterEnv, st: EngineState, cand):
        """bool[K, D] veto of an intra-broker move as a previous goal."""
        rule = self.disk_rule()
        if rule is None:
            return torch.ones((cand.shape[0], env.broker_disk_capacity.shape[1]),
                              dtype=torch.bool, device=env.device)
        return disk_k.accept_plain(rule, disk_state(env, st), cand)

    def violated(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        return (self.broker_severity(env, st) > 0).any()

    def stat(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        """Scalar the goal tries to reduce (summed in the oracle's order)."""
        return xla_sum(torch.clamp(self.broker_severity(env, st), min=0.0))

    def seeded_work_probe(self, env: ClusterEnv, st: EngineState,
                          seed_mask: torch.Tensor) -> torch.Tensor:
        """bool 0-d (goals/base.py:268): would any seed-mask row rank
        eligible (> -inf) for an action kind this goal uses? Its replica
        key (moves or disk moves), leader key and swap-out key, the keys the
        engine masks, reduced by K13 (``kernels.seeded_probe``). False
        proves every selection pool of the goal's pass loop all -inf."""
        methods = self.seeded_work_methods()
        if not methods:
            return torch.zeros((), dtype=torch.bool, device=env.device)
        sev = self.broker_severity(env, st)
        keys = [getattr(self, m)(env, st, sev).contiguous() for m in methods]
        return probe_k.seeded_probe(seed_mask, keys)

    def seeded_work_methods(self) -> list:
        """The key functions ``seeded_work_probe`` reads, in its order: the
        replica key (moves or disk moves), the leader key, the swap-out
        key, for the action kinds the goal uses."""
        out = []
        if self.uses_replica_moves or self.uses_disk_moves:
            out.append("replica_key")
        if self.uses_leadership_moves:
            out.append("leader_key")
        if self.uses_swaps:
            out.append("swap_out_key")
        return out


def overrides(g: GoalKernel, name: str) -> bool:
    """Does goal ``g`` override the base method ``name``?"""
    return getattr(type(g), name) is not getattr(GoalKernel, name)


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


def move_delta_rows(env: ClusterEnv, st: EngineState, cand: torch.Tensor) -> torch.Tensor:
    """f32[K, WAVE_DIMS] wave-delta rows of candidate MOVES (engine.py
    ``_move_delta_rows``): the effective load, one replica, the leader flag,
    the leader NW_OUT, no leader NW_IN."""
    K = cand.shape[0]
    lead = st.replica_is_leader[cand]
    eff = torch.where(lead[:, None], env.leader_load[cand], env.follower_load[cand])
    one = torch.ones((K, 1), dtype=eff.dtype, device=eff.device)
    return torch.cat([
        eff, one, lead[:, None].to(eff.dtype),
        env.leader_load[cand, Resource.NW_OUT][:, None],
        torch.zeros((K, 1), dtype=eff.dtype, device=eff.device),
    ], dim=1).contiguous()


def partition_rack_rows(env: ClusterEnv, st: EngineState, cand: torch.Tensor):
    """i64[K, racks]: the per-rack replica counts of each row's partition."""
    return st.part_rack_count[env.replica_partition[cand]].to(torch.int64).contiguous()


def min_limit(a, b):
    """The elementwise minimum of two optional limits (None: no limit)."""
    return b if a is None else a if b is None else torch.minimum(a, b)


def sibling_brokers(env: ClusterEnv, st: EngineState, cand: torch.Tensor):
    """i64[K, F]: brokers hosting another replica of each candidate's
    partition, -1 elsewhere."""
    members = env.partition_replicas[env.replica_partition[cand]]          # [K, F]
    member_broker = st.replica_broker[torch.clamp(members, min=0)]
    sibling = (members >= 0) & (members != cand[:, None])
    return torch.where(sibling, member_broker,
                       torch.full_like(member_broker, -1)).contiguous()


def new_broker_ok(env: ClusterEnv) -> torch.Tensor:
    """bool[B]: the new-broker rule's destinations (every broker when the
    cluster has no new broker, else the new ones; the back-home exception
    is per row)."""
    return env.broker_new | ~env.broker_new.any()


def legit_move_rows(env: ClusterEnv, st: EngineState, cand: torch.Tensor,
                    options: OptimizationOptions):
    """Inputs of the [K, B] ``legit_move_mask`` (base.py:369-414) that the K2
    kernel expands: ``sib_b`` i64[K, F] (brokers hosting another replica of
    the candidate's partition, -1 elsewhere), ``replica_ok`` bool[K] (valid,
    topic not excluded unless offline, offline-only mode), and the broker
    masks ``dst_ok`` (allowed destination) and ``new_ok`` (no new brokers,
    or b is new; the back-home exception is per row)."""
    sib_b = sibling_brokers(env, st, cand)
    offline = st.replica_offline[cand]
    topic_ok = ~env.topic_excluded[env.replica_topic[cand]] | offline
    replica_ok = env.replica_valid[cand] & topic_ok
    if options.fix_offline_replicas_only:
        replica_ok = replica_ok & offline
    return sib_b, replica_ok, env.dst_candidate, new_broker_ok(env)


def legit_swap_rows(env: ClusterEnv, st: EngineState, cand: torch.Tensor):
    """bool[K]: the row part of ``legit_swap_mask`` (base.py:417-451):
    valid, online, topic not excluded, and the row's broker an allowed
    destination (each broker receives the other row's replica)."""
    return (env.replica_valid[cand] & ~st.replica_offline[cand]
            & ~env.replica_topic_excluded[cand]
            & env.dst_candidate[st.replica_broker[cand]])


def swap_pairs(env: ClusterEnv, st: EngineState, cand_out, cand_in, accepts,
               row_ok_out=None, row_ok_in=None) -> swap_k.SwapPairs:
    """The K7 inputs of the pairs (cand_out[i], cand_in[j]): the brokers,
    siblings, original brokers and topics of both sides, ``row_ok_*``
    (default: ``legit_swap_rows``) ANDed with the row-only parts of every
    ``SwapAccept`` in ``accepts``, whose vetoes, rack limits (their
    minimum) and topic veto fold into the kernel's inputs."""
    if row_ok_out is None:
        row_ok_out = legit_swap_rows(env, st, cand_out)
    if row_ok_in is None:
        row_ok_in = legit_swap_rows(env, st, cand_in)
    vetoes, lim_out, lim_in, topic_up = [], None, None, None
    for a in accepts:
        if a.row_out is not None:
            row_ok_out = row_ok_out & a.row_out
        if a.row_in is not None:
            row_ok_in = row_ok_in & a.row_in
        vetoes.extend(a.vetoes)
        lim_out = min_limit(lim_out, a.lim_out)
        lim_in = min_limit(lim_in, a.lim_in)
        if a.topic_up is not None:
            if topic_up is not None:
                raise NotImplementedError("two topic vetoes in one chain")
            topic_up = a.topic_up.contiguous()
    prow_out = prow_in = None
    if lim_out is not None:
        prow_out = partition_rack_rows(env, st, cand_out)
        prow_in = partition_rack_rows(env, st, cand_in)
        lim_out, lim_in = lim_out.contiguous(), lim_in.contiguous()
    return swap_k.SwapPairs(
        b_out=st.replica_broker[cand_out].contiguous(),
        b_in=st.replica_broker[cand_in].contiguous(),
        sib_out=sibling_brokers(env, st, cand_out),
        sib_in=sibling_brokers(env, st, cand_in),
        orig_out=env.replica_original_broker[cand_out].contiguous(),
        orig_in=env.replica_original_broker[cand_in].contiguous(),
        row_ok_out=row_ok_out.contiguous(), row_ok_in=row_ok_in.contiguous(),
        new_ok=new_broker_ok(env), broker_rack=env.broker_rack,
        t_out=env.replica_topic[cand_out].contiguous(),
        t_in=env.replica_topic[cand_in].contiguous(),
        tab=st.topic_broker_count, prow_out=prow_out, prow_in=prow_in,
        lim_out=lim_out, lim_in=lim_in, vetoes=vetoes, topic_up=topic_up)


def lead_member_rows(env: ClusterEnv, cand: torch.Tensor) -> torch.Tensor:
    """i64[K, F]: replicas of each candidate's partition (-1 padded)."""
    return env.partition_replicas[env.replica_partition[cand]].contiguous()


def legit_lead_rows(env: ClusterEnv, st: EngineState, cand: torch.Tensor):
    """Inputs of the [K, F] ``legit_leadership_mask`` (base.py:471-487)
    that the K6 kernel expands: the row part (the candidate leads its
    partition and its topic is not excluded) and the broker part (alive,
    not demoted, not excluded for leadership)."""
    row_ok = (st.replica_is_leader[cand] & env.replica_valid[cand]
              & ~env.topic_excluded[env.replica_topic[cand]])
    broker_ok = (env.broker_alive & ~env.broker_demoted
                 & ~env.broker_excluded_for_leadership)
    return row_ok, broker_ok


def legit_leadership_mask(env: ClusterEnv, st: EngineState, cand: torch.Tensor):
    """bool[K, F] legit leadership-transfer targets (the plain form of what
    the K6 kernel evaluates)."""
    members = lead_member_rows(env, cand)
    row_ok, broker_ok = legit_lead_rows(env, st, cand)
    return lead_k.legit_plain(cand, members, row_ok, broker_ok,
                              st.replica_broker, st.replica_offline)


def disk_state(env: ClusterEnv, st: EngineState) -> disk_k.DiskState:
    """The K8 kernels' view of the intra-broker state."""
    return disk_k.DiskState(
        rb=st.replica_broker, rlead=st.replica_is_leader,
        lead_disk=env.leader_load[:, Resource.DISK].contiguous(),
        foll_disk=env.follower_load[:, Resource.DISK].contiguous(),
        rvalid=env.replica_valid, rtexcl=env.replica_topic_excluded,
        balive=env.broker_alive, dalive=env.broker_disk_alive,
        dcap=env.broker_disk_capacity, rdisk=st.replica_disk,
        roff=st.replica_offline, moved=st.moved, dutil=st.disk_util)


def legit_disk_move_mask(env: ClusterEnv, st: EngineState, cand: torch.Tensor):
    """bool[K, D] legit intra-broker destinations (base.py:456; the plain form
    of what the K8 kernels evaluate): destination logdir alive with capacity
    and not the current one, replica valid on an alive broker, topic not
    excluded unless the replica sits on a dead disk."""
    return disk_k.legit_plain(disk_state(env, st), cand)


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """A ``replica_keys`` launch a goal's key function asked for, not yet
    made: its family, load column, broker rows f32[n, B], scalars f32[3]
    and logdir rows f32[n, B, D] (or None). The fleet's lane engine
    collects one per running lane and launches them together
    (``kernels.replica_keys_lanes``)."""
    family: int
    col: int
    bt: torch.Tensor
    sc: torch.Tensor
    dt: torch.Tensor | None


_KEY_CAPTURE = threading.local()


@contextlib.contextmanager
def capture_keys():
    """Inside this block (this thread only) ``sweep_keys`` returns its
    ``KeySpec`` instead of launching the keying kernel."""
    _KEY_CAPTURE.on = True
    try:
        yield
    finally:
        _KEY_CAPTURE.on = False


def sweep_keys(family: int, env: ClusterEnv, st: EngineState, col: int, rows: list,
               scalars=None, disk=None) -> torch.Tensor:
    """f32[R] keys of one ``replica_keys`` family (K1 keying) over the env's
    keying tables (bf16 on the sweep view): ``rows`` are its f32[B] broker
    rows, ``scalars`` up to three 0-d f32 values (zeros by default),
    ``disk`` its (replica_disk, f32[n, B, D] logdir rows). Under
    ``capture_keys`` it returns the launch's ``KeySpec`` instead."""
    sc = torch.zeros(3, dtype=torch.float32, device=env.device)
    for i, s in enumerate(scalars or ()):
        sc[i] = s           # a device-side copy or fill: no host read
    rdisk, dt = disk if disk is not None else (None, None)
    bt = torch.stack([r.to(torch.float32) for r in rows]).contiguous()
    dt = None if dt is None else dt.contiguous()
    if getattr(_KEY_CAPTURE, "on", False):
        return KeySpec(family, col, bt, sc, dt)
    return replica_keys(family, env_loads(env), col, st.replica_broker,
                        st.replica_is_leader, st.replica_offline, env.replica_valid,
                        bt, sc, rdisk, dt)
