"""The greedy optimization engine (counterpart of
``cruise_control_tpu/analyzer/engine.py``): the intra-broker disk, move,
leadership and swap branches, the exhaustive finisher and the chunked
early-exit dispatch.

One goal runs as a budgeted loop of PASSES; a pass is

    1. severity = goal.broker_severity(state)                    f32[B]
       intra-broker goals: the disk branch (K1 top-K of goal.replica_key,
         stall-salted; K8 [K, D] score and per-row best; a stable sort by
         value; K8's ordered walk re-scores each row against the live state
         and applies it)
    2. leadership-primary goals: the leadership branch first
         (K1 top-KL of goal.leader_key, K6 [KL, F] score, K3 admission,
         batched transfer apply on K4/K5); replica moves only when it
         landed nothing
    3. the move branch: K1 top-(K*W) of goal.replica_key, stall-salted;
         per wave K2 [K, B] score, destination spread, K3 admission, K4
         batched apply
    4. other leadership goals: the leadership branch when no move landed
    5. swap goals: the swap branch when neither moves nor transfers landed
         (K1 top-K of swap_out_key and, salted apart, of swap_in_key; K7
         [K1, K2] pair score and per-row best; a stable sort by value; K7
         first-use admission; the two-leg batched apply on K4/K5).

The engine's options, as the reference's: ``compact_keying`` selects at the
move, leadership and swap sites through the pooled K1 (``select_pooled``:
the eligible rows compacted and counted on the device, the pool or the full
sweep chosen there); ``chain_cache=False`` scores moves against the previous
goals' own ``accept_move`` terms (K2's per-goal veto form) instead of the
folded rooms, in the waves, the exhaustive move scan and the segment waves.
A chain with a goal that vetoes an action kind without a cumulative wave
form (``wave_budgets``, ``wave_topic_budgets`` or ``wave_safe``) takes the
reference's fallbacks for that kind: the one-move-per-broker move wave
(``first_touch_win``, plain torch) and the sequential leadership walk
(``_seq_leads``: K6 at one row, ``state.apply_leadership``); its finisher
then runs its legacy waves through them.

A goal still violated when its loop exits gets the exhaustive FINISHER:
rounds of full-R scans (K1 compaction of the eligible rows, K2 with T = 1
over [chunk, B], K6 over [chunk, F]) whose top true-gain actions apply in
segment-parallel waves (K2 with the room-ranked column order, K6 per broker
color, K3 with N = K * S rows). Swap goals add a swap tail once a round's
scans read zero (salted swap passes until one applies nothing) and a swap
clause to the certificate (no positive swap in the goal's unsalted top-K
window, K7). A round whose scans find nothing proves a single-action
fixpoint.

Under the bf16 precision policy (``compute_dtype="bfloat16"``, what "auto"
resolves to at 262,144 replicas or more) every branch of the pass loop keys
and scores on the sweep view (``_sweep_env``, ``_sweep_state``): the K1
keying kernel reads the [R, M] loads in bf16, the score tables read them
upcast, the broker accumulators are the compensated f32 sums; everything
else, the finisher included, stays on the f32 env and state.

The reference runs the loop as one ``lax.while_loop`` program; here it is a
host loop over device tensors with one small device->host read per pass
(plus one per branch gate for leadership and swap goals), per finisher
wave, per swap-tail pass and per scan. Capturing a pass as a CUDA graph is
later work (K11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv, SweepEnv, capacity_stripe_key
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, WAVE_DIMS, WAVE_ZERO_EXEMPT_DIMS, GoalKernel, disk_state, overrides,
    lead_member_rows, legit_lead_rows, legit_move_rows, legit_swap_rows, min_limit,
    move_delta_rows, swap_pairs,
)
from cruise_control_tpu_torch.analyzer.state import (
    EngineState, apply_leadership, apply_leaderships_batched, apply_moves_batched,
    apply_swaps_batched,
)
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import (
    compact_eligible, disk_apply, disk_rows, leadership_rows, move_score_classes,
    select_candidates, swap_admission, swap_rows, wave_admission,
)
from cruise_control_tpu_torch.kernels.move_score import RACK_FAMILIES


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Engine knobs, every field and default as in the reference (see its
    docstrings). ``compact_keying`` runs the pooled K1 at the reference's
    ``_select_candidates`` sites; ``chain_cache=False`` scores moves against
    the previous goals' own ``accept_move`` terms (K2's per-goal veto form)
    instead of the folded rooms. The sharded engine (``mesh``) raises in
    ``check_supported``."""
    max_iters: int = 4096
    num_candidates: int = 64          # K: replica-move candidates per iteration
    num_leader_candidates: int = 32   # KL: leadership candidates per iteration
    num_swap_candidates: int = 32     # K1/K2: swap-out / swap-in candidates
    num_dst_choices: int = 16         # T: per-row destination spread (wave width)
    min_gain: float = 1e-9            # scores below this count as no progress
    stall_retries: int = 8
    tail_pass_budget: int = 64
    tail_total_budget: int = 192
    sat_stall_retries: int = 2
    sat_tail_passes: int = 8
    stat_window: int = 24
    stat_slope_min: float = 1e-3
    finisher_rounds: int = 12
    max_finisher_rounds: int = 12
    finisher_candidates: int = 1760
    finisher_waves: int = 6
    scan_chunk: int = 1024
    finisher_swap_passes: int = 64
    pass_waves: int = 1
    max_pass_waves: int = 4
    pass_chunk: int = 8
    compact_keying: bool = False
    compact_pool: int = 8192
    chain_cache: bool = True
    finisher_segments: int = 8
    max_finisher_segments: int = 8
    compute_dtype: str = "auto"
    mesh: object = None
    finisher_overlap: bool = False


def check_supported(params: EngineParams) -> None:
    """Raise for the engine option whose path is not ported yet, the mesh."""
    if params.compute_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {params.compute_dtype!r}")
    if params.mesh is not None:
        raise NotImplementedError("the sharded engine is not ported yet "
                                  "(ROADMAP.md Queue 1 item 15)")


# ---------------------------------------------------------------------------
# The precision policy (engine.py:59-111)
# ---------------------------------------------------------------------------
# Under the bf16 policy only the SCORING sweeps read the [R, M] leader /
# follower loads in bf16: the candidate keyings (K1 keying, which reads the
# bf16 tables) and the score tables of K2, K6, K7 and K8's row scores (f32
# tables built from the same values upcast). Legitimacy, chain rooms and
# vetoes, delta rows, wave admission, applies, refresh, severities, verdicts,
# the exhaustive scans and every stage of the finisher read the f32 env and
# state. The reference computes its bf16 expressions in f32 inside its XLA
# program and rounds where it materializes a bf16 array; the goals do the
# same (``goals.base.sweep_round``).
def _sweep_env(env: ClusterEnv, params: EngineParams) -> ClusterEnv:
    """engine.py:85: the sweep view of the env, built once per goal; the
    env itself unless the policy resolved to bf16 ("auto" reaching the
    engine unresolved means f32), so every f32 path is bit for bit as it
    was. The view keeps the bf16 tables in ``sweep_loads`` and their values
    upcast to f32 in ``leader_load`` / ``follower_load`` (``SweepEnv``)."""
    if params.compute_dtype != "bfloat16":
        return env
    lead = env.leader_load.to(torch.bfloat16).contiguous()
    foll = env.follower_load.to(torch.bfloat16).contiguous()
    fields = {f.name: getattr(env, f.name) for f in dataclasses.fields(ClusterEnv)}
    return SweepEnv(**dict(fields, leader_load=lead.float(), follower_load=foll.float()),
                    sweep_loads=(lead, foll))


def _sweep_state(st: EngineState, params: EngineParams) -> EngineState:
    """engine.py:98: the per-pass compensated view of the broker
    accumulators the scores difference (``util + util_residual``,
    ``leader_util + leader_util_residual`` in f32); the identity under f32."""
    return _compensated(st) if params.compute_dtype == "bfloat16" else st


def _compensated(st: EngineState) -> EngineState:
    return dataclasses.replace(st, util=st.util + st.util_residual,
                               leader_util=st.leader_util + st.leader_util_residual)


def _sweep_view(env: ClusterEnv, st: EngineState, env_sw: ClusterEnv | None):
    """(env, state) a branch's keying and score tables read: the sweep view
    with the compensated state, or (env, st) itself in exact mode
    (``env_sw`` None, the finisher) and under f32."""
    if env_sw is None or env_sw.sweep_loads is None:
        return env, st
    return env_sw, _compensated(st)


def _custom_move_veto(g: GoalKernel) -> bool:
    """A previous-goal move veto with no interval form: the rack-limit
    veto, a row veto or a (topic, broker) count veto, folded by the K2
    kernel."""
    return (overrides(g, "rack_limit") or overrides(g, "move_row_veto")
            or overrides(g, "move_topic_veto"))


def _vetoes_moves(g: GoalKernel) -> bool:
    return overrides(g, "accept_move_rooms") or _custom_move_veto(g)


def _wave_budget_capable(g: GoalKernel, leadership: bool = False) -> bool:
    """engine.py:538: can multi-action waves preserve this goal's
    acceptance? Yes with cumulative budgets (per broker or per (topic,
    broker)), the first-touch rule (wave_safe), or no veto of the action
    kind in question."""
    if overrides(g, "wave_budgets") or g.wave_safe:
        return True
    if overrides(g, "wave_topic_budgets"):
        return True
    if leadership:
        return not overrides(g, "lead_vetoes")
    return not _vetoes_moves(g)


def _chain_capable(goals, leadership: bool = False) -> bool:
    """Does every goal of ``goals`` keep its acceptance under a budgeted
    wave of this action kind? Else the chain takes the reference's fallback:
    the one-move-per-broker wave for moves (engine.py:862-867), ``seq_body``
    for leadership transfers (:1023-1045)."""
    return all(_wave_budget_capable(g, leadership) for g in goals)


def compact_pool(params: EngineParams) -> int | None:
    """K1's ``compact_pool`` argument: the pooled keying's pool floor under
    ``compact_keying`` (engine.py ``_select_candidates`` :179-225), None for
    the full sweep."""
    return params.compact_pool if params.compact_keying else None


def _lead_delta_rows(env: ClusterEnv, rep: torch.Tensor) -> torch.Tensor:
    """f32[K, WAVE_DIMS] per-broker deltas of gaining / losing leadership of
    ``rep`` (engine.py:1057-1067): the leader - follower shift, no count,
    one leader, no potential NW_OUT, the leader's bytes-in."""
    delta = env.leader_load[rep] - env.follower_load[rep]
    K = rep.shape[0]
    zero = torch.zeros((K, 1), dtype=delta.dtype, device=delta.device)
    one = torch.ones((K, 1), dtype=delta.dtype, device=delta.device)
    return torch.cat([delta, zero, one, zero,
                      env.leader_load[rep, Resource.NW_IN][:, None]], dim=1).contiguous()


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Stable descending order of f32 ``x`` with -0.0 tied to +0.0, as the
    reference's sort compares them (CUDA's radix sort would put -0.0 after
    +0.0; adding +0.0 makes every zero +0.0 first)."""
    return torch.argsort(-x + 0.0, stable=True)


def _combined_move_rooms(prev_goals: tuple, env: ClusterEnv, st: EngineState):
    """({dim: (src_room | None, dst_room | None)}, custom): the chain's
    interval-form vetoes folded into per-dim MIN room tables, and the goals
    whose veto has no interval form (the rack goals' rack-limit veto, the
    MinTopicLeadersPerBrokerGoal row veto, TopicReplicaDistributionGoal's
    row and (topic, broker) count vetoes), which the K2 kernel folds."""
    rooms: dict = {}
    custom = []
    for g in prev_goals:
        rm = g.accept_move_rooms(env, st)
        if rm is None:
            if _custom_move_veto(g):
                custom.append(g)
            continue
        for dim, (s, d) in rm.items():
            cs, cd = rooms.get(dim, (None, None))
            rooms[dim] = (
                s if cs is None else cs if s is None else torch.minimum(cs, s),
                d if cd is None else cd if d is None else torch.minimum(cd, d))
    return rooms, tuple(custom)


def _fold_move_terms(prev_goals: tuple, env: ClusterEnv, st: EngineState):
    """(goals with a source side, {dim: (lhs f32[B], bound f32[B])}): the
    chain's per-goal ``accept_move`` terms for K2's per-goal veto form.
    Terms of one dim read the same state column, so their bounds fold by
    ``min`` exactly (``x <= a and x <= b`` iff ``x <= min(a, b)``)."""
    src_goals, dims = [], {}
    for g in prev_goals:
        terms = g.accept_move_terms(env, st)
        if terms is None:
            if overrides(g, "accept_move_rooms"):
                raise NotImplementedError(f"{g.name}: rooms without accept_move terms")
            continue
        if overrides(g, "accept_move_source"):
            src_goals.append(g)
        for t in terms:
            if t.exempt != (t.dim in WAVE_ZERO_EXEMPT_DIMS):
                raise ValueError(f"{g.name}: a dim-{t.dim} term's exemption is not "
                                 f"K2's")
            cur = dims.get(t.dim)
            dims[t.dim] = (t.lhs, t.bound if cur is None else torch.minimum(cur[1], t.bound))
    return tuple(src_goals), dims


def _chain_move_vetoes(prev_goals: tuple, env: ClusterEnv, st: EngineState,
                       chain_cache: bool = True):
    """(rooms, custom, terms): the chain's move vetoes as K2 takes them,
    folded into rooms (``chain_cache``, ``_combined_move_rooms``; terms
    None) or as the goals' own terms (``_fold_move_terms``; rooms {}). The
    rack, row and topic vetoes (``custom``) have no interval form and take
    K2's custom path either way (engine.py:754-765)."""
    if chain_cache:
        return (*_combined_move_rooms(prev_goals, env, st), None)
    custom = tuple(g for g in prev_goals if _custom_move_veto(g))
    return {}, custom, _fold_move_terms(prev_goals, env, st)


def _score_args(env: ClusterEnv, st: EngineState, goal: GoalKernel, rooms: dict,
                custom, cand, kv, d_rows, T: int, order_b=None,
                row_ok=None, env_sw: ClusterEnv | None = None, terms=None) -> tuple:
    """Positional arguments of the K2 launch (``kernels.move_score_classes``)
    for the [K, B] stage: the per-row legitimacy (``kv > -inf``, or
    ``row_ok`` when given), source rooms, row vetoes and goal rows, the
    per-broker destination rooms and goal columns; with ``terms``
    (``_fold_move_terms``) the per-goal form instead of ``rooms``: each
    goal's source rows and the terms' left-hand columns and bounds.
    Legitimacy, rooms and vetoes read (env, st); the goal's score tables
    read the sweep view of ``env_sw`` (engine.py:776-786)."""
    B = env.num_brokers
    src_b = st.replica_broker[cand]
    part = env.replica_partition[cand]
    sib_b, replica_ok, dst_ok, new_ok = legit_move_rows(env, st, cand, goal.options)
    row_ok = replica_ok & ((kv > NEG_INF) if row_ok is None else row_ok)
    rack_lim = None
    tveto = None
    for g in custom:
        rack_lim = min_limit(rack_lim, g.rack_limit(env, part))
        if overrides(g, "move_row_veto"):
            row_ok = row_ok & g.move_row_veto(env, st, cand)
        up = g.move_topic_veto(env, st)
        if up is not None:
            if tveto is not None:
                raise NotImplementedError("two topic vetoes in one chain")
            row_t = env.replica_topic[cand].contiguous()
            tveto = (row_t, st.topic_broker_count, up[row_t].contiguous())
    dst_room = torch.full((WAVE_DIMS, B), torch.inf, dtype=torch.float32,
                          device=env.device)
    room_mask = 0
    dst_lhs = None
    if terms is not None:
        src_goals, dims = terms
        for g in src_goals:
            row_ok = row_ok & g.accept_move_source(env, st, cand)
        dst_lhs = torch.zeros_like(dst_room)
        for dim in sorted(dims):
            dst_lhs[dim], dst_room[dim] = dims[dim]
            room_mask |= 1 << dim
    for dim in sorted(rooms):
        s, dstr = rooms[dim]
        dd = d_rows[:, dim]
        if s is not None:
            ok = dd <= s[src_b]
            if dim in WAVE_ZERO_EXEMPT_DIMS:
                ok = ok | (dd == 0)
            row_ok = row_ok & ok
        if dstr is not None:
            dst_room[dim] = dstr
            room_mask |= 1 << dim
    env_k, st_k = _sweep_view(env, st, env_sw)
    family, row_f, col_f = goal.move_tables(env_k, st_k, cand)
    prow = None
    if family in RACK_FAMILIES or rack_lim is not None:
        prow = st.part_rack_count[part].to(torch.int64).contiguous()
    if rack_lim is not None:
        rack_lim = rack_lim.contiguous()
    return (family, T, src_b.contiguous(),
            env.replica_original_broker[cand].contiguous(), sib_b,
            row_ok.contiguous(), d_rows, dst_room, room_mask, prow, rack_lim,
            row_f.contiguous(), col_f.contiguous(), dst_ok, new_ok, env.broker_rack,
            order_b, goal.move_topic_table(env_k, st_k, cand), tveto, dst_lhs)


def chain_slack(env: ClusterEnv, st: EngineState, goals: tuple):
    """(src_slack, dst_slack) f32[B, WAVE_DIMS]: the MIN over the chain's
    ``wave_budgets`` (inf where no goal constrains a dim)."""
    B = env.num_brokers
    src_slack = torch.full((B, WAVE_DIMS), torch.inf, dtype=torch.float32,
                           device=env.device)
    dst_slack = src_slack.clone()
    for g in goals:
        bud = g.wave_budgets(env, st)
        if bud is None:
            continue
        src_slack = torch.minimum(src_slack, bud[0])
        dst_slack = torch.minimum(dst_slack, bud[1])
    return src_slack.contiguous(), dst_slack.contiguous()


def topic_budget_args(env: ClusterEnv, st: EngineState, goals: tuple, topics,
                      src_b, dst_b, d_count, d_leader):
    """K3's ``topic`` argument: every chain goal's ``wave_topic_budgets``
    as columns, or None when no goal has one."""
    cols = [g.wave_topic_budgets(env, st, topics, src_b, dst_b, d_count, d_leader)
            for g in goals]
    cols = [c for c in cols if c is not None]
    if not cols:
        return None
    return (topics.contiguous(), env.num_topics,
            torch.stack([c[0].to(torch.float32) for c in cols], 1).contiguous(),
            torch.stack([c[1] for c in cols], 1).contiguous(),
            torch.stack([c[2] for c in cols], 1).contiguous())


class FirstTouchWave(NamedTuple):
    """A score-sorted MOVE wave of a chain with a non-budget goal: the
    reference's one-move-per-broker admission (``first_touch_win``)."""
    num_brokers: int
    num_partitions: int
    part: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    wave_ok: torch.Tensor


def first_touch_win(w: FirstTouchWave) -> torch.Tensor:
    """bool[N] engine.py:855-867: in score order, a positive row is admitted
    when it is the first positive row to touch its partition and the first
    to touch its source and its destination broker (either role): each
    first touch is a scatter-min of the guarded positions, int32 and
    deterministic."""
    N = w.part.shape[0]
    dev = w.part.device
    posn = torch.arange(N, dtype=torch.int32, device=dev)
    guarded = torch.where(w.wave_ok, posn, torch.full_like(posn, N + 1))
    first_part = torch.full((w.num_partitions,), N + 1, dtype=torch.int32, device=dev)
    first_part = first_part.scatter_reduce(0, w.part, guarded, reduce="amin")
    first_b = torch.full((w.num_brokers,), N + 1, dtype=torch.int32, device=dev)
    first_b = (first_b.scatter_reduce(0, w.src, guarded, reduce="amin")
               .scatter_reduce(0, w.dst, guarded, reduce="amin"))
    return (w.wave_ok & (first_b[w.src] == posn) & (first_b[w.dst] == posn)
            & (first_part[w.part] == posn))


def admit(args) -> torch.Tensor:
    """bool[N] winners of a move or leadership wave: K3 on its arguments,
    or the one-move-per-broker wave (``FirstTouchWave``)."""
    if isinstance(args, FirstTouchWave):
        return first_touch_win(args)
    return wave_admission(*args)


def _admit_moves(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                 prev_goals: tuple, r_sorted, src_s, dst_s, d, wave_ok,
                 kgroup=None):
    """Admission of a score-sorted MOVE wave: the positional K3 arguments
    (partition first-touch, budgets with d_count = 1 and d_leader =
    is_leader), or, when a chain goal has no wave budget, the
    one-move-per-broker wave (``FirstTouchWave``)."""
    chain = (goal, *prev_goals)
    if not _chain_capable(chain):
        if kgroup is not None:
            raise ValueError("a segment wave needs a budget-capable chain")
        return FirstTouchWave(env.num_brokers, env.num_partitions,
                              env.replica_partition[r_sorted], src_s, dst_s, wave_ok)
    src_slack, dst_slack = chain_slack(env, st, chain)
    lead = st.replica_is_leader[r_sorted].to(torch.float32)
    topics = env.replica_topic[r_sorted]
    topic = topic_budget_args(env, st, chain, topics, src_s, dst_s,
                              torch.ones_like(lead), lead)
    return (d, src_s, dst_s, wave_ok.contiguous(),
            env.replica_partition[r_sorted].contiguous(), src_slack, dst_slack,
            goal.wave_gain_budgets(env, st),
            st.replica_offline[r_sorted].contiguous(), None, kgroup, topic,
            env.num_partitions)


def _admit_leads(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                 prev_goals: tuple, r_sorted, dst_rep, src_b, dst_b, wave_ok,
                 kgroup=None) -> tuple:
    """Positional K3 arguments of a score-sorted LEADERSHIP wave (own
    source / destination deltas, d_count = 0, d_leader = 1, no gain
    escape, no partition first-touch)."""
    chain = (goal, *prev_goals)
    src_slack, dst_slack = chain_slack(env, st, chain)
    n = r_sorted.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=env.device)
    topic = topic_budget_args(env, st, chain, env.replica_topic[r_sorted], src_b,
                              dst_b, zeros, torch.ones_like(zeros))
    return (_lead_delta_rows(env, r_sorted), src_b.contiguous(), dst_b.contiguous(),
            wave_ok.contiguous(), None, src_slack, dst_slack,
            goal.wave_gain_budgets(env, st), None, _lead_delta_rows(env, dst_rep),
            kgroup, topic, None)


def _score_prep(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                prev_goals: tuple, params: EngineParams, cand, kv,
                env_sw: ClusterEnv | None = None):
    """(wave-delta rows, K2 arguments) of a move wave over ``cand``."""
    d_rows = move_delta_rows(env, st, cand)
    rooms, custom, terms = _chain_move_vetoes(prev_goals, env, st, params.chain_cache)
    T = min(params.num_dst_choices, env.num_brokers)
    return d_rows, _score_args(env, st, goal, rooms, custom, cand, kv, d_rows, T,
                               env_sw=env_sw, terms=terms)


def _admission_from_scores(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                           prev_goals: tuple, params: EngineParams, cand, d_rows,
                           cls_val, cls_q):
    """Fan a scored wave's rows across destination classes and sort them;
    returns (rows in score order, their destinations, the K3 arguments)."""
    K = cand.shape[0]
    B = env.num_brokers
    T = min(params.num_dst_choices, B)
    Bp = -(-B // T) * T
    # destination spread: the row at sorted position j prefers its best
    # destination in class (j mod T) when that class scores, else its
    # global best (lowest column among the max-achieving classes)
    posn = torch.arange(K, device=env.device)
    cols = cls_q * T + torch.arange(T, device=env.device)[None, :]
    best_val = cls_val.max(dim=1).values
    glob_dst = torch.where(cls_val == best_val[:, None], cols, Bp).min(dim=1).values
    order = _desc_order(best_val)
    rank = torch.empty_like(posn)
    rank[order] = posn
    cls = rank % T
    aff_val = cls_val[posn, cls]
    aff_dst = cls_q[posn, cls] * T + cls
    use_aff = aff_val > params.min_gain
    dst_u = torch.where(use_aff, aff_dst, glob_dst)
    val_u = torch.where(use_aff, aff_val, best_val)

    r_sorted = cand[order]
    src_s = st.replica_broker[r_sorted].contiguous()
    dst_s = dst_u[order].contiguous()
    wave_ok = val_u[order] > params.min_gain
    args = _admit_moves(env, st, goal, prev_goals, r_sorted, src_s, dst_s,
                        d_rows[order].contiguous(), wave_ok)
    return r_sorted, dst_s, args


def _admission_args(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                    prev_goals: tuple, params: EngineParams, cand, kv,
                    env_sw: ClusterEnv | None = None):
    """Score a wave (K2) and fan its rows across destination classes;
    returns (rows in score order, their destinations, the K3 arguments)."""
    d_rows, score_args = _score_prep(env, st, goal, prev_goals, params, cand, kv,
                                     env_sw)
    cls_val, cls_q = move_score_classes(*score_args)
    return _admission_from_scores(env, st, goal, prev_goals, params, cand, d_rows,
                                  cls_val, cls_q)


def _move_wave(env: ClusterEnv, st: EngineState, goal: GoalKernel,
               prev_goals: tuple, params: EngineParams, cand, kv,
               env_sw: ClusterEnv | None = None):
    """ONE scored admission wave over ``cand``: re-score against the live
    state (K2, its tables from the sweep view of ``env_sw``; None is exact
    mode), fan rows across destination classes, admit under the chain's
    cumulative budgets (K3; a chain with a non-budget goal: one move per
    broker) and apply the winners in one batch (K4).
    Returns (state, n_applied as a device scalar)."""
    r_sorted, dst_s, args = _admission_args(env, st, goal, prev_goals, params,
                                            cand, kv, env_sw)
    win = admit(args)
    st = apply_moves_batched(env, st, r_sorted, dst_s, win)
    return st, win.sum()


def _move_branch_batched(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                         prev_goals: tuple, params: EngineParams,
                         severity: torch.Tensor, stall: int, cand=None, kv=None,
                         env_sw: ClusterEnv | None = None,
                         seed_mask: torch.Tensor | None = None):
    """Key once (K1 keying on the sweep view, K1 with the seed mask), then
    up to ``pass_waves`` rank-banded waves; a wave that admits nothing ends
    the pass. ``cand``/``kv`` override the selection (the finisher's
    non-segmented waves, in exact mode). Returns (state, n_applied device
    scalar, waves run)."""
    if cand is not None:
        st, n = _move_wave(env, st, goal, prev_goals, params, cand, kv, env_sw)
        return st, n, 1
    R = env.num_replicas
    K = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(K, 1)))
    env_k, st_k = _sweep_view(env, st, env_sw)
    key = goal.replica_key(env_k, st_k, severity)
    k_all = min(K * W, R)
    kv_all, cand_all = select_candidates(key.contiguous(), k_all, stall,
                                         seed_mask=seed_mask,
                                         compact_pool=compact_pool(params))
    waves = min(max(int(params.pass_waves), 1), W)
    total = torch.zeros((), dtype=torch.int64, device=env.device)
    run = 0
    for w in range(waves):
        st, n = _move_wave(env, st, goal, prev_goals, params,
                           cand_all[w * K:(w + 1) * K], kv_all[w * K:(w + 1) * K],
                           env_sw)
        total = total + n
        run += 1
        if w + 1 < waves and int(n) == 0:
            break
    return st, total, run


def _lead_args(env: ClusterEnv, st: EngineState, goal: GoalKernel,
               prev_goals: tuple, cand, row_extra,
               env_sw: ClusterEnv | None = None) -> tuple:
    """Positional arguments of the K6 launch (``kernels.leadership_rows``):
    legitimacy inputs, the chain's folded ``accept_leadership`` vetoes and
    the active goal's ``leadership_score`` tables (from the sweep view of
    ``env_sw``)."""
    members = lead_member_rows(env, cand)
    row_ok, broker_ok = legit_lead_rows(env, st, cand)
    row_ok = row_ok & row_extra
    vetoes = []
    for g in prev_goals:
        r, v = g.lead_vetoes(env, st, cand)
        if r is not None:
            row_ok = row_ok & r
        vetoes.extend(v)
    return (cand.contiguous(), members, row_ok.contiguous(), broker_ok,
            st.replica_broker, st.replica_offline,
            goal.lead_tables(*_sweep_view(env, st, env_sw), cand), vetoes)


def _lead_admission_args(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                         prev_goals: tuple, params: EngineParams, lcand, lkv,
                         env_sw: ClusterEnv | None = None):
    """Score a leadership wave over ``lcand`` (K6) and sort it by gain;
    returns (rows in score order, their destination replicas, the K3
    arguments)."""
    best_val, f_all = leadership_rows(*_lead_args(env, st, goal, prev_goals, lcand,
                                                  lkv > NEG_INF, env_sw))
    return _lead_admission_from_scores(env, st, goal, prev_goals, params, lcand,
                                       best_val, f_all)


def _lead_admission_from_scores(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                                prev_goals: tuple, params: EngineParams, lcand,
                                best_val, f_all):
    """The K6 rows of a leadership wave sorted by gain: (rows in score
    order, their destination replicas, the K3 arguments)."""
    KL = lcand.shape[0]
    order = _desc_order(best_val)
    posn = torch.arange(KL, device=env.device)
    r_sorted = lcand[order]
    members = env.partition_replicas[env.replica_partition[r_sorted]]
    dst_rep = torch.clamp(members[posn, f_all[order]], min=0)
    wave_ok = best_val[order] > params.min_gain
    src_b = st.replica_broker[r_sorted]
    dst_b = st.replica_broker[dst_rep]
    args = _admit_leads(env, st, goal, prev_goals, r_sorted, dst_rep, src_b, dst_b,
                        wave_ok)
    return r_sorted, dst_rep, args


def _leadership_branch_batched(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                               prev_goals: tuple, params: EngineParams,
                               severity: torch.Tensor, stall: int, cand=None,
                               kv=None, env_sw: ClusterEnv | None = None,
                               seed_mask: torch.Tensor | None = None):
    """engine.py:968: one [KL, F] scoring pass (K6), then budgeted wave
    admission (K3; each candidate leads a distinct partition) and one
    batched transfer apply, or, when a chain goal has no leadership budget,
    the sequential walk (``_seq_leads``); the keying and the score tables
    read the sweep view of ``env_sw`` (None: exact mode). Returns (state,
    n_applied device scalar)."""
    if cand is None:
        kl = min(params.num_leader_candidates, env.num_replicas)
        lkey = goal.leader_key(*_sweep_view(env, st, env_sw), severity)
        lkv, lcand = select_candidates(lkey.contiguous(), kl, stall, seed_mask=seed_mask,
                                       compact_pool=compact_pool(params))
    else:
        lkv, lcand = kv, cand
    if not _chain_capable((goal, *prev_goals), leadership=True):
        best_val, _f = leadership_rows(*_lead_args(env, st, goal, prev_goals, lcand,
                                                   lkv > NEG_INF, env_sw))
        return _seq_leads(env, st, goal, prev_goals, params, lcand, best_val)
    r_sorted, dst_rep, args = _lead_admission_args(env, st, goal, prev_goals, params,
                                                   lcand, lkv, env_sw)
    win = wave_admission(*args)
    st = apply_leaderships_batched(env, st, r_sorted, dst_rep, win)
    return st, win.sum()


def _seq_leads(env: ClusterEnv, st: EngineState, goal: GoalKernel, prev_goals: tuple,
               params: EngineParams, lcand, best_val):
    """engine.py:1023-1045 ``seq_body``, the leadership fallback of a chain
    with a non-budget goal: walk the first ``min(n_pos, KL)`` rows in score
    order (``n_pos`` the rows scoring above ``min_gain``, one host read),
    re-score each against the live state with K6 at one row (exact f32, the
    chain's leadership vetoes folded), and apply it with
    ``apply_leadership(enabled=ok)``. Each row reads the state the previous
    one wrote, so the rows run one by one; the count stays on the device.
    Returns (state, n_applied device scalar)."""
    idx = lcand[_desc_order(best_val)]
    n_pos = min(int((best_val > params.min_gain).sum()), lcand.shape[0])
    n = torch.zeros((), dtype=torch.int64, device=env.device)
    every = torch.ones(1, dtype=torch.bool, device=env.device)
    for i in range(n_pos):
        r = idx[i:i + 1]
        v, f = leadership_rows(*_lead_args(env, st, goal, prev_goals, r, every))
        dst = torch.clamp(lead_member_rows(env, r)[0, f[0]], min=0)
        ok = env.replica_valid[r[0]] & (v[0] > params.min_gain)
        st = apply_leadership(env, st, r[0], dst, ok)
        n = n + ok.to(torch.int64)
    return st, n


def _swap_args(env: ClusterEnv, st: EngineState, goal: GoalKernel, prev_goals: tuple,
               cand_out, okv, cand_in, ikv, env_sw: ClusterEnv | None = None):
    """(SwapPairs, SwapTables) of the K7 ``swap_rows`` launch: the
    ``legit_swap_mask`` row parts with ``kv > -inf``, every previous goal's
    ``accept_swap`` folded, the active goal's ``swap_score`` tables (from
    the sweep view of ``env_sw``)."""
    accepts = [g.swap_accept(env, st, cand_out, cand_in) for g in prev_goals]
    pairs = swap_pairs(env, st, cand_out, cand_in, accepts,
                       legit_swap_rows(env, st, cand_out) & (okv > NEG_INF),
                       legit_swap_rows(env, st, cand_in) & (ikv > NEG_INF))
    return pairs, goal.swap_tables(*_sweep_view(env, st, env_sw), cand_out, cand_in)


def _swap_pools(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                params: EngineParams, severity, stall: int,
                seed_mask: torch.Tensor | None = None):
    """(okv, cand_out, ikv, cand_in): the out pool of ``swap_out_key`` and
    the in pool of ``swap_in_key`` (K1, salted apart by 101 on a stalled
    pass), k = min(num_swap_candidates, R, 128) each (engine.py:1106), keyed
    on (env, st) as given (the sweep view in the pass loop). ``seed_mask`` masks the out pool
    only: swap counterparties can live anywhere (engine.py:158-160)."""
    k = min(params.num_swap_candidates, env.num_replicas, 128)
    pool = compact_pool(params)
    okv, cand_out = select_candidates(goal.swap_out_key(env, st, severity).contiguous(), k,
                                      stall, seed_mask=seed_mask, compact_pool=pool)
    ikv, cand_in = select_candidates(goal.swap_in_key(env, st, severity).contiguous(), k,
                                     stall, salt=101, compact_pool=pool)
    return okv, cand_out, ikv, cand_in


def _swap_branch_batched(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                         prev_goals: tuple, params: EngineParams,
                         severity: torch.Tensor, stall: int,
                         env_sw: ClusterEnv | None = None,
                         seed_mask: torch.Tensor | None = None,
                         fold_legs: bool = False):
    """engine.py:1080: one [K1, K2] scoring pass (K7 ``swap_rows``), the
    rows in stable descending value order, the first-use admission (K7
    ``swap_admission``: brokers in either role, the in-candidate and both
    partitions first-use among the eligible rows) and one two-leg batched
    apply; the pools and the pair score tables read the sweep view of
    ``env_sw`` (None: exact mode, the finisher's swap tail). Returns
    (state, n_applied device scalar). ``fold_legs``: the apply's residuals
    as the chunked pass loop folds them (``state.apply_swaps_batched``)."""
    env_k, st_k = _sweep_view(env, st, env_sw)
    okv, cand_out, ikv, cand_in = _swap_pools(env_k, st_k, goal, params, severity,
                                              stall, seed_mask)
    pairs, tables = _swap_args(env, st, goal, prev_goals, cand_out, okv, cand_in, ikv,
                               env_sw)
    best_val, best_j, _n = swap_rows(pairs, tables, params.min_gain)
    r_out, r_in, adm = _swap_admission_inputs(env, pairs, cand_out, cand_in, best_val,
                                              best_j)
    win = swap_admission(*adm, params.min_gain)
    st = apply_swaps_batched(env, st, r_out, r_in, win, fold_legs)
    return st, win.sum()


def _swap_admission_inputs(env: ClusterEnv, pairs, cand_out, cand_in, best_val, best_j):
    """The K7 rows in stable descending value order: (out replicas, in
    replicas, the ``swap_admission`` row inputs)."""
    order = _desc_order(best_val)
    r_out = cand_out[order]
    j_s = best_j[order].contiguous()
    r_in = cand_in[j_s]
    return r_out, r_in, (best_val[order].contiguous(), pairs.b_out[order].contiguous(),
                         pairs.b_in[j_s].contiguous(), j_s,
                         env.replica_partition[r_out].contiguous(),
                         env.replica_partition[r_in].contiguous())


def _swap_window_positives(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                           prev_goals: tuple, params: EngineParams) -> int:
    """engine.py:1385: the accepted positive-gain swaps in the goal's own
    unsalted top-K swap window at this state (the certificate's swap
    clause), from K7's per-row positive counts."""
    severity = goal.broker_severity(env, st)
    # the reference keys this window with a direct top-k, never the pooled K1
    k = min(params.num_swap_candidates, env.num_replicas, 128)
    okv, cand_out = select_candidates(goal.swap_out_key(env, st, severity).contiguous(), k, 0)
    ikv, cand_in = select_candidates(goal.swap_in_key(env, st, severity).contiguous(), k, 0,
                                     salt=101)
    pairs, tables = _swap_args(env, st, goal, prev_goals, cand_out, okv, cand_in, ikv)
    _best, _j, positives = swap_rows(pairs, tables, params.min_gain, what="window")
    return int(positives.sum())


def _disk_move_branch_batched(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                              prev_goals: tuple, params: EngineParams,
                              severity: torch.Tensor, stall: int,
                              env_sw: ClusterEnv | None = None,
                              seed_mask: torch.Tensor | None = None):
    """engine.py:1197: the intra-broker analogue of the move branch. K1 keys
    the top-K candidates (destinations are the D logdirs of each
    candidate's own broker), K8 ``disk_rows`` gives each row's best masked
    score, the rows sort stably by it (descending) and K8 ``disk_apply``
    walks them in that order, re-scoring each against the live state
    (``_rescore_disk_move_row``) and applying it when both scores exceed
    ``min_gain``. The keying and ``disk_rows``' score read the sweep view
    of ``env_sw``; its vetoes and the walk read the f32 loads. Returns
    (state, n_applied device scalar)."""
    kd = min(params.num_candidates, env.num_replicas)
    env_k, st_k = _sweep_view(env, st, env_sw)
    key = goal.replica_key(env_k, st_k, severity)
    kv, cand = select_candidates(key.contiguous(), kd, stall, seed_mask=seed_mask)
    ds = disk_state(env, st)
    rule = goal.disk_rule()
    vetoes = [r for r in (g.disk_rule() for g in prev_goals) if r is not None]
    ds_k = disk_state(env_k, st_k)
    best = disk_rows(dataclasses.replace(ds, slead_disk=ds_k.lead_disk,
                                         sfoll_disk=ds_k.foll_disk),
                     cand, kv, rule, vetoes)
    order = _desc_order(best)
    dutil, rdisk, roff, moved, n = disk_apply(ds, cand, best, order.contiguous(), rule,
                                              vetoes, params.min_gain)
    st = dataclasses.replace(st, disk_util=dutil, replica_disk=rdisk,
                             replica_offline=roff, moved=moved)
    return st, n


# ---------------------------------------------------------------------------
# The exhaustive finisher
# ---------------------------------------------------------------------------
def _compact_eligible(eligible: torch.Tensor, pad_len: int):
    """(order i64[pad_len], n int): engine.py:1257 on the K1 compaction."""
    order, n = compact_eligible(eligible.contiguous(), pad_len)
    return order, int(n)


def _scatter_rows(R: int, idx, v, d, gain, dst):
    """gain[idx] = v, dst[idx] = d for real rows (sentinel R dropped)."""
    gain_x = torch.cat([gain, gain[:1]])
    dst_x = torch.cat([dst, dst[:1]])
    gain_x[idx] = v
    dst_x[idx] = d
    return gain_x[:R], dst_x[:R]


def _exhaustive_move_scan(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                          prev_goals: tuple, chunk: int, chain_cache: bool = True):
    """(gain f32[R], dst i64[R]) — engine.py:1270: every eligible replica's
    best single-move gain over ALL destinations under legitimacy and chain
    acceptance (-inf where none exists; the folded rooms, or the goals' own
    terms without ``chain_cache``), swept over the compacted eligible rows
    in [chunk, B] launches of K2 with T = 1."""
    R = env.num_replicas
    chunk = min(chunk, R)
    eligible = goal.replica_key(env, st, goal.broker_severity(env, st)) > NEG_INF
    order, n = _compact_eligible(eligible, -(-R // chunk) * chunk)
    rooms, custom, terms = _chain_move_vetoes(prev_goals, env, st, chain_cache)
    gain = torch.full((R,), NEG_INF, dtype=torch.float32, device=env.device)
    dst = torch.zeros(R, dtype=torch.int64, device=env.device)
    for i in range(-(-n // chunk)):
        idx = order[i * chunk:(i + 1) * chunk]
        cand = torch.clamp(idx, max=R - 1)
        d_rows = move_delta_rows(env, st, cand)
        cls_val, cls_q = move_score_classes(*_score_args(
            env, st, goal, rooms, custom, cand, None, d_rows, 1, row_ok=idx < R,
            terms=terms))
        gain, dst = _scatter_rows(R, idx, cls_val[:, 0], cls_q[:, 0], gain, dst)
    return gain, dst


def _exhaustive_lead_scan(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                          prev_goals: tuple, chunk: int):
    """(gain f32[R], dst_rep i64[R]) — engine.py:1341: every eligible
    leader's best transfer over all its followers, in [chunk, F] launches
    of K6 over the compacted eligible rows."""
    R = env.num_replicas
    chunk = min(chunk, R)
    eligible = goal.leader_key(env, st, goal.broker_severity(env, st)) > NEG_INF
    order, n = _compact_eligible(eligible, -(-R // chunk) * chunk)
    gain = torch.full((R,), NEG_INF, dtype=torch.float32, device=env.device)
    dst = torch.zeros(R, dtype=torch.int64, device=env.device)
    for i in range(-(-n // chunk)):
        idx = order[i * chunk:(i + 1) * chunk]
        cand = torch.clamp(idx, max=R - 1)
        v, f = leadership_rows(*_lead_args(env, st, goal, prev_goals, cand, idx < R))
        members = lead_member_rows(env, cand)
        d = torch.clamp(members[torch.arange(cand.shape[0], device=env.device), f],
                        min=0)
        gain, dst = _scatter_rows(R, idx, v, d, gain, dst)
    return gain, dst


def _segment_broker_order(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                          prev_goals: tuple, S: int) -> torch.Tensor:
    """i64[Bp] (Bp = ceil(B/S)*S) — engine.py:1430: brokers ranked by
    remaining destination room (the goal's ``segment_room_key``, else the
    chain's combined destination rooms, else the static capacity stripe),
    dealt round-robin: ordered column j belongs to segment j % S."""
    B = env.num_brokers
    key = goal.segment_room_key(env, st)
    if key is None:
        rooms, _custom = _combined_move_rooms((goal, *prev_goals), env, st)
        dst_rooms = [d for (_s, d) in rooms.values() if d is not None]
        if dst_rooms:
            key = dst_rooms[0]
            for d in dst_rooms[1:]:
                key = torch.minimum(key, d)
        else:
            key = capacity_stripe_key(env)
    key = torch.where(env.dst_candidate, key.to(torch.float32),
                      torch.full((B,), NEG_INF, device=env.device))
    order = _desc_order(key)
    Bp = -(-B // S) * S
    if Bp > B:
        order = torch.cat([order, torch.arange(B, Bp, device=env.device)])
    return order.contiguous()


def _boundary_count(B: int, win, src_b, dst_b) -> torch.Tensor:
    """Admitted rows sharing a broker (either role) with an EARLIER admitted
    row: the cross-segment actions the budgets re-validated."""
    N = win.shape[0]
    posn = torch.arange(N, device=win.device)
    wposn = torch.where(win, posn, N + 1)
    first_b = torch.full((B,), N + 1, dtype=torch.int64, device=win.device)
    first_b = first_b.scatter_reduce(0, src_b, wposn, reduce="amin")
    first_b = first_b.scatter_reduce(0, dst_b, wposn, reduce="amin")
    return (win & ((first_b[src_b] != posn) | (first_b[dst_b] != posn))).sum()


def _segments(params: EngineParams, env: ClusterEnv) -> tuple[int, int]:
    S = max(2, min(params.max_finisher_segments, env.num_brokers))
    return S, min(max(int(params.finisher_segments), 1), S)


def _segment_move_args(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                       prev_goals: tuple, params: EngineParams, cand, kv):
    """The K2 and K3 stages of a segment move wave: (rows in score order,
    their sources, their destinations, the K3 arguments)."""
    K = cand.shape[0]
    S, active = _segments(params, env)
    d_rows = move_delta_rows(env, st, cand)
    src_b = st.replica_broker[cand]
    rooms, custom, terms = _chain_move_vetoes(prev_goals, env, st, params.chain_cache)
    order_b = _segment_broker_order(env, st, goal, prev_goals, S)
    vals, q_best = move_score_classes(*_score_args(
        env, st, goal, rooms, custom, cand, kv, d_rows, S, order_b=order_b, terms=terms))
    seg = torch.arange(S, device=env.device)
    dsts = order_b[q_best * S + seg[None, :]]
    vals = torch.where(seg[None, :] < active, vals, torch.full_like(vals, NEG_INF))
    KS = K * S
    k_of = torch.repeat_interleave(torch.arange(K, device=env.device), S)
    val_f = vals.reshape(KS)
    order_r = _desc_order(val_f)
    k_s = k_of[order_r]
    r_sorted = cand[k_s]
    src_s = src_b[k_s].contiguous()
    dst_s = dsts.reshape(KS)[order_r].contiguous()
    wave_ok = val_f[order_r] > params.min_gain
    args = _admit_moves(env, st, goal, prev_goals, r_sorted, src_s, dst_s,
                        d_rows[k_s].contiguous(), wave_ok,
                        kgroup=(k_s.contiguous(), K))
    return r_sorted, src_s, dst_s, args


def _segment_move_wave(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                       prev_goals: tuple, params: EngineParams, cand, kv):
    """engine.py:1469: ONE segment-parallel finisher wave. The [K, B] exact
    re-score runs once (K2 over the room-ordered columns), every candidate
    contributes its best destination in each of the S broker segments, and
    the K*S rows are admitted together in score order (K3: one row per
    candidate, partition first-touch, cumulative budgets) and applied in
    one batch. Returns (state, n_applied, n_boundary) as device scalars."""
    r_sorted, src_s, dst_s, args = _segment_move_args(env, st, goal, prev_goals,
                                                      params, cand, kv)
    win = wave_admission(*args)
    st = apply_moves_batched(env, st, r_sorted, dst_s, win)
    return st, win.sum(), _boundary_count(env.num_brokers, win, src_s, dst_s)


def _segment_lead_args(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                       prev_goals: tuple, params: EngineParams, cand, kv):
    """The K6 and K3 stages of a segment leadership wave: (rows in score
    order, their new leaders, sources, destinations, the K3 arguments)."""
    KL = cand.shape[0]
    S, active = _segments(params, env)
    order_b = _segment_broker_order(env, st, goal, prev_goals, S)
    Bp = order_b.shape[0]
    colrank = torch.empty(Bp, dtype=torch.int64, device=env.device)
    colrank[order_b] = torch.arange(Bp, device=env.device)
    _best, _f, vals, fbest = leadership_rows(
        *_lead_args(env, st, goal, prev_goals, cand, kv > NEG_INF),
        color=(colrank % S).contiguous(), S=S, active=active)
    dst_rep_all = torch.clamp(lead_member_rows(env, cand), min=0)
    KS = KL * S
    k_of = torch.repeat_interleave(torch.arange(KL, device=env.device), S)
    val_f = vals.reshape(KS)
    order_r = _desc_order(val_f)
    k_s = k_of[order_r]
    r_sorted = cand[k_s]
    dst_rep = dst_rep_all[k_s, fbest.reshape(KS)[order_r]]
    wave_ok = val_f[order_r] > params.min_gain
    src_b = st.replica_broker[r_sorted]
    dst_b = st.replica_broker[dst_rep]
    args = _admit_leads(env, st, goal, prev_goals, r_sorted, dst_rep, src_b, dst_b,
                        wave_ok, kgroup=(k_s.contiguous(), KL))
    return r_sorted, dst_rep, src_b, dst_b, args


def _segment_lead_wave(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                       prev_goals: tuple, params: EngineParams, cand, kv):
    """engine.py:1578: each candidate leader contributes its best follower
    per destination-broker color (K6 with the coloring); the KL*S transfer
    rows are admitted together (K3, one transfer per candidate) and applied
    in one batch. Returns (state, n_applied, n_boundary)."""
    r_sorted, dst_rep, src_b, dst_b, args = _segment_lead_args(
        env, st, goal, prev_goals, params, cand, kv)
    win = wave_admission(*args)
    st = apply_leaderships_batched(env, st, r_sorted, dst_rep, win)
    return st, win.sum(), _boundary_count(env.num_brokers, win, src_b, dst_b)


def _finisher_wave(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                   prev_goals: tuple, params: EngineParams, gain: torch.Tensor,
                   leadership: bool):
    """engine.py:1669: up to ``finisher_waves`` rank-banded waves of the
    highest true-gain candidates of one scan (exact top-(K*W) by K1), each
    re-scored against the live state; waves stop once one admits nothing.
    Returns (state, applied, boundary) as host ints."""
    R = env.num_replicas
    K = min(params.finisher_candidates, R)
    W = max(1, min(params.finisher_waves, R // max(K, 1)))
    kv_all, cand_all = select_candidates(gain[:R].contiguous(), K * W, 0)
    severity = goal.broker_severity(env, st)
    chain = (goal, *prev_goals)
    use_seg = params.max_finisher_segments >= 2 and _chain_capable(chain, leadership)
    total = boundary = 0
    for w in range(W):
        cand = cand_all[w * K:(w + 1) * K]
        kv = kv_all[w * K:(w + 1) * K]
        kv = torch.where(kv > params.min_gain, kv, torch.full_like(kv, NEG_INF))
        nb = 0
        if leadership:
            if use_seg:
                st, n, nb = _segment_lead_wave(env, st, goal, prev_goals, params,
                                               cand, kv)
            else:
                st, n = _leadership_branch_batched(env, st, goal, prev_goals,
                                                   params, severity, 0,
                                                   cand=cand, kv=kv)
        else:
            if use_seg:
                st, n, nb = _segment_move_wave(env, st, goal, prev_goals, params,
                                               cand, kv)
            else:
                st, n, _w = _move_branch_batched(env, st, goal, prev_goals,
                                                 params, severity, 0,
                                                 cand=cand, kv=kv)
        # one device->host read for both counts (an int count is filled on
        # the device: uploading it would wait for the stream)
        n, nb = (int(x) for x in torch.stack([
            x if isinstance(x, torch.Tensor)
            else torch.full((), x, dtype=torch.int64, device=env.device)
            for x in (n, nb)]).tolist())
        total += n
        boundary += nb
        if n == 0:
            break
    return st, total, boundary


def _finisher(env: ClusterEnv, st: EngineState, goal: GoalKernel,
              prev_goals: tuple, params: EngineParams, run: bool):
    """engine.py:1743: while ``run`` (the goal was still violated when its
    budgeted loop exited) and a round applies anything, scan and wave-apply
    moves, then transfers; a swap goal whose round drained both scans runs
    up to ``finisher_swap_passes`` salted swap passes (stall = the pass
    index) until one applies nothing. A round that applies nothing ends the
    loop with a certificate when its scans found zero positive actions and,
    for a swap goal, its unsalted swap window holds no positive swap.
    Returns (st, proven, moves_left, leads_left, swaps_left, rounds,
    applied, boundary, segments)."""
    use_moves = goal.uses_replica_moves
    use_leads = goal.uses_leadership_moves
    if params.max_finisher_rounds <= 0 or not (use_moves or use_leads):
        return st, False, -1, -1, -1, 0, 0, 0, 0
    big = 2 ** 27
    rounds, prev_m, prev_l, total, bnd = 0, big, big, 0, 0
    mleft = lleft = big
    done = clean = False
    while run and not done and rounds < params.finisher_rounds:
        st_entry = st
        mleft = lleft = applied = 0
        if use_moves:
            gain, _ = _exhaustive_move_scan(env, st, goal, prev_goals,
                                            params.scan_chunk, params.chain_cache)
            mleft = int((gain > params.min_gain).sum())
            st, n, nb = _finisher_wave(env, st, goal, prev_goals, params, gain,
                                       leadership=False)
            applied += n
            bnd += nb
        if use_leads:
            scan_st = st_entry if (params.finisher_overlap and use_moves) else st
            gain, _ = _exhaustive_lead_scan(env, scan_st, goal, prev_goals,
                                            params.scan_chunk)
            lleft = int((gain > params.min_gain).sum())
            st, n, nb = _finisher_wave(env, st, goal, prev_goals, params, gain,
                                       leadership=True)
            applied += n
            bnd += nb
        if (goal.uses_swaps and params.finisher_swap_passes > 0
                and mleft == 0 and lleft == 0):
            it, last = 0, 1
            while last > 0 and it < params.finisher_swap_passes:
                st, k = _swap_branch_batched(env, st, goal, prev_goals, params,
                                             goal.broker_severity(env, st), it)
                last = int(k)
                applied += last
                it += 1
        done = (applied == 0 or not bool(goal.violated(env, st))
                or (mleft + lleft > 0
                    and mleft + lleft > (prev_m + prev_l) * 7 // 8))
        clean = applied == 0
        prev_m, prev_l = mleft, lleft
        rounds += 1
        total += applied
    ran = run and rounds > 0
    if not ran:
        mleft = lleft = -1
    swleft = -1
    if goal.uses_swaps and ran:
        swleft = _swap_window_positives(env, st, goal, prev_goals, params)
    proven = (run and clean and (mleft == 0 or not use_moves)
              and (lleft == 0 or not use_leads)
              and (swleft == 0 or not goal.uses_swaps))
    chain = (goal, *prev_goals)
    seg_capable = params.max_finisher_segments >= 2 and (
        (use_moves and _chain_capable(chain)) or (use_leads and _chain_capable(chain, True)))
    segments = _segments(params, env)[1] if (seg_capable and ran) else 0
    return st, proven, mleft, lleft, swleft, rounds, total, bnd, segments


# ---------------------------------------------------------------------------
# The budgeted pass loop
# ---------------------------------------------------------------------------
def _loop_scalar_init():
    """The budgeted loop's scalar carries: (it, n_applied, stall, dribble,
    sat, win_stat, win_dribble, plateau, tailp, b_moves, b_leads, b_swaps,
    b_disk, b_waves)."""
    return dict(it=0, n_applied=0, stall=0, dribble=0, sat=False,
                win_stat=np.float32(np.inf), win_dribble=0, plateau=False,
                tailp=0, b_moves=0, b_leads=0, b_swaps=0, b_disk=0, b_waves=0)


def _cond(c: dict, params: EngineParams) -> bool:
    stall_cap = (min(params.stall_retries, params.sat_stall_retries) if c["sat"]
                 else params.stall_retries)
    tail_cap = (min(params.tail_pass_budget, params.sat_tail_passes) if c["sat"]
                else params.tail_pass_budget)
    return (c["stall"] <= stall_cap and c["dribble"] <= tail_cap
            and c["tailp"] <= params.tail_total_budget
            and c["it"] < params.max_iters and not c["plateau"])


def _step(env, st, goal, prev_goals, params, c: dict, env_sw=None, seed_mask=None,
          fold_legs=False):
    """One pass (the reference's ``step``, engine.py:1953-2074). The gated
    branches reuse the pass-start severity, as the reference does: a branch
    that applied nothing left the state untouched. Every branch keys and
    scores on the sweep view of ``env_sw`` (``_sweep_env``); ``seed_mask``
    (bool[R], a reduced round's dirty set; None on full rounds) masks the
    four budgeted keyings (engine.py:943, :995, :1119, :1218); ``fold_legs``
    is the chunked pass loop's residual fold of a swap wave."""
    severity = goal.broker_severity(env, st)
    c["tailp"] += int((c["stall"] + c["dribble"]) > 0)
    explore = c["stall"] + c["dribble"]
    lead_first = goal.uses_leadership_moves and goal.leadership_primary
    zero = torch.zeros((), dtype=torch.int64, device=env.device)
    n_leads = n_moves = n_swaps = n_disk = zero
    if goal.uses_disk_moves:
        st, n_disk = _disk_move_branch_batched(env, st, goal, prev_goals, params,
                                               severity, explore, env_sw, seed_mask)
    n_waves = 0
    leads_now = 0
    if lead_first:
        st, n_leads = _leadership_branch_batched(env, st, goal, prev_goals, params,
                                                 severity, explore, env_sw=env_sw,
                                                 seed_mask=seed_mask)
        leads_now = int(n_leads)
    if goal.uses_replica_moves and leads_now == 0:
        st, n_moves, n_waves = _move_branch_batched(env, st, goal, prev_goals,
                                                    params, severity, explore,
                                                    env_sw=env_sw, seed_mask=seed_mask)
    if goal.uses_leadership_moves and not lead_first:
        if int(n_moves) == 0:
            st, n_leads = _leadership_branch_batched(env, st, goal, prev_goals,
                                                     params, severity, explore,
                                                     env_sw=env_sw, seed_mask=seed_mask)
    if goal.uses_swaps and int(n_moves + n_leads) == 0:
        st, n_swaps = _swap_branch_batched(env, st, goal, prev_goals, params,
                                           severity, explore, env_sw, seed_mask,
                                           fold_legs)
    # the pass's closing device->host read
    _close_pass(c, params, torch.stack(_pass_row(env, st, goal, n_disk, n_moves, n_leads,
                                                 n_swaps)).tolist(), n_waves)
    return st


def _pass_row(env, st, goal, n_disk, n_moves, n_leads, n_swaps) -> list:
    """The f32 device scalars a pass closes on: its four action counts, the
    goal's verdict and its stat."""
    return [n_disk.to(torch.float32), n_moves.to(torch.float32),
            n_leads.to(torch.float32), n_swaps.to(torch.float32),
            goal.violated(env, st).to(torch.float32),
            goal.stat(env, st).to(torch.float32)]


def _close_pass(c: dict, params: EngineParams, row: list, n_waves: int) -> None:
    """Update the loop's scalar carries from a pass's closing read ``row``
    (``_pass_row``'s values on the host)."""
    disk, moves, leads, swaps, viol, stat_now = row
    disk, moves, leads, swaps = int(disk), int(moves), int(leads), int(swaps)
    applied = disk + moves + leads + swaps
    stat_now = np.float32(stat_now)
    c["b_disk"] += disk
    c["b_moves"] += moves
    c["b_leads"] += leads
    c["b_swaps"] += swaps
    c["b_waves"] += n_waves
    c["stall"] = 0 if applied > 0 else c["stall"] + 1
    is_dribble = applied < max(1, params.num_candidates // 128)
    c["dribble"] += int(is_dribble)
    c["sat"] = is_dribble and not viol
    roll = c["dribble"] - c["win_dribble"] >= params.stat_window
    flat = ((c["win_stat"] - stat_now)
            < np.float32(params.stat_slope_min) * max(c["win_stat"], np.float32(1e-6)))
    c["plateau"] = c["plateau"] or (roll and bool(flat))
    if roll:
        c["win_stat"] = stat_now
        c["win_dribble"] = c["dribble"]
    c["it"] += 1
    c["n_applied"] += applied


def _info(goal, params, c: dict, stat_before: float, violated: bool, fin: dict,
          stat_after: float) -> dict:
    """The reference's per-goal info dict (engine.py:2151-2183)."""
    budget_exit = (c["it"] >= params.max_iters
                   or c["dribble"] > params.tail_pass_budget
                   or c["tailp"] > params.tail_total_budget
                   or c["plateau"])
    hit_max_iters = (c["stall"] <= params.stall_retries and budget_exit
                     and violated and not fin["fixpoint_proven"])
    return {"iterations": c["n_applied"] + fin["finisher_actions"],
            "passes": c["it"],
            "violated_after": violated,
            "hit_max_iters": hit_max_iters,
            "plateau_exit": c["plateau"],
            "fixpoint_proven": fin["fixpoint_proven"],
            "finisher_rounds": fin["finisher_rounds"],
            "moves_remaining": fin["moves_remaining"],
            "leads_remaining": fin["leads_remaining"],
            "swap_window_remaining": fin["swap_window_remaining"],
            "stat_before": stat_before,
            "move_actions": c["b_moves"],
            "lead_actions": c["b_leads"],
            "swap_actions": c["b_swaps"],
            "disk_actions": c["b_disk"],
            "move_waves": c["b_waves"],
            "finisher_actions": fin["finisher_actions"],
            "finisher_segments": fin["finisher_segments"],
            "finisher_boundary": fin["finisher_boundary"],
            "stat": stat_after}


_NO_FINISHER = {"fixpoint_proven": False, "moves_remaining": -1,
                "leads_remaining": -1, "swap_window_remaining": -1,
                "finisher_rounds": 0, "finisher_actions": 0,
                "finisher_boundary": 0, "finisher_segments": 0}


def _goal_finish(env, st, goal, prev_goals, params, run: bool):
    """The finisher gated on ``run``, as a dict of its counts."""
    (st, proven, mleft, lleft, swleft, rounds, applied, bnd,
     segments) = _finisher(env, st, goal, prev_goals, params, run)
    return st, {"fixpoint_proven": bool(proven), "moves_remaining": mleft,
                "leads_remaining": lleft, "swap_window_remaining": swleft,
                "finisher_rounds": rounds, "finisher_actions": applied,
                "finisher_boundary": bnd, "finisher_segments": segments}


def _goal_loop(env: ClusterEnv, st: EngineState, goal: GoalKernel,
               prev_goals: tuple, params: EngineParams, finisher: bool = True,
               chunk: int = 0, seed_mask: torch.Tensor | None = None,
               allow_cert_skip: bool = False):
    """One goal's budgeted loop (engine.py:2110). ``finisher=False`` is the
    fused-prefix form; with ``finisher=True`` the exhaustive finisher runs
    when the goal exits violated (it compiles out, as in the reference,
    when ``max_finisher_rounds <= 0``).

    ``chunk > 0`` is the chunked dispatch (engine.py:2452): the host stops
    at a chunk boundary of ``chunk`` passes as soon as the loop's own
    condition exits OR a whole chunk admitted zero actions (QUIESCE: zero
    admissions leave the state bit-unchanged, so every later budgeted pass
    would re-rank the same starved pools); the info then adds
    ``passes_skipped``, ``quiesce_chunk``, ``chunks`` and
    ``finisher_skipped``.

    ``seed_mask`` (bool[R] or None) keys the budgeted selection pools from a
    reduced round's dirty set (K1's seed mask); the finisher's scans stay
    unmasked, so a certificate is a full-R proof. ``allow_cert_skip``
    (chunked only; the caller established that the carried round proved
    this goal a persistent violated fixpoint and the chain applied nothing
    before it) skips the finisher of a goal that quiesced with zero
    actions: the info then says ``fixpoint_proven False`` and
    ``finisher_skipped True`` and the caller patches the certificate from
    the carryover (engine.py:2534-2538)."""
    check_supported(params)
    env_sw = _sweep_env(env, params)
    stat_before = float(goal.stat(env, st))
    c = _loop_scalar_init()
    quiesce_chunk, chunks, applied_prev = -1, 0, 0
    while True:
        lim = c["it"] + chunk if chunk > 0 else math.inf
        while _cond(c, params) and c["it"] < lim:
            st = _step(env, st, goal, prev_goals, params, c, env_sw, seed_mask,
                       fold_legs=chunk > 0)
        chunks += 1
        if chunk <= 0 or not _cond(c, params):
            break
        if c["n_applied"] == applied_prev:
            quiesce_chunk = chunks - 1
            break
        applied_prev = c["n_applied"]
    fin = dict(_NO_FINISHER)
    finisher_skipped = False
    if finisher:
        run = bool(goal.violated(env, st))
        if (run and chunk > 0 and allow_cert_skip and quiesce_chunk >= 0
                and c["n_applied"] == 0):
            finisher_skipped = True
        else:
            st, fin = _goal_finish(env, st, goal, prev_goals, params, run)
    violated, stat_after = torch.stack([goal.violated(env, st).to(torch.float32),
                                        goal.stat(env, st).to(torch.float32)]).tolist()
    info = _info(goal, params, c, stat_before, bool(violated), fin, stat_after)
    if chunk > 0:
        info.update(passes_skipped=passes_skipped(c, params, quiesce_chunk),
                    quiesce_chunk=quiesce_chunk, chunks=chunks,
                    finisher_skipped=finisher_skipped)
    return st, info


def passes_skipped(c: dict, params: EngineParams, quiesce_chunk: int) -> int:
    """The budgeted passes a quiesced goal did not dispatch (0 when it did
    not quiesce)."""
    if quiesce_chunk < 0:
        return 0
    stall_cap = (min(params.stall_retries, params.sat_stall_retries)
                 if c["sat"] else params.stall_retries)
    return max(0, min(params.max_iters - c["it"],
                      params.tail_total_budget + 1 - c["tailp"],
                      stall_cap + 1 - c["stall"]))


def optimize_goal(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                  prev_goals: tuple = (), params: EngineParams = EngineParams(),
                  seed_mask: torch.Tensor | None = None):
    """Run one goal to completion (the per-goal program). Returns (state,
    info dict)."""
    return _goal_loop(env, st, goal, tuple(prev_goals), params, finisher=True,
                      seed_mask=seed_mask)


def optimize_goal_chunked(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                          prev_goals: tuple = (),
                          params: EngineParams = EngineParams(),
                          seed_mask: torch.Tensor | None = None,
                          allow_cert_skip: bool = False):
    """engine.py:2452: the budgeted loop in chunks of ``pass_chunk`` passes
    with the quiesce exit, then the finisher, or its certificate-gated skip
    (see ``_goal_loop``)."""
    return _goal_loop(env, st, goal, tuple(prev_goals), params, finisher=True,
                      chunk=max(params.pass_chunk, 1), seed_mask=seed_mask,
                      allow_cert_skip=allow_cert_skip)


def goal_probe(goal: GoalKernel, env: ClusterEnv, st: EngineState,
               seed_mask: torch.Tensor) -> dict:
    """engine.py ``_compiled_goal_probe`` (:2298): the chain short-circuit's
    probe of a reduced goal, as host values: its verdict, whether any
    seed-mask row ranks eligible for an action it uses (K13,
    ``GoalKernel.seeded_work_probe``) and its stat, in one read.
    ``violated False`` and ``has_work False`` prove the goal program a
    no-op on this state."""
    viol, work, stat = torch.stack([
        goal.violated(env, st).to(torch.float32),
        goal.seeded_work_probe(env, st, seed_mask).to(torch.float32),
        goal.stat(env, st).to(torch.float32)]).tolist()
    return {"violated": bool(viol), "has_work": bool(work), "stat": stat}
