"""The greedy optimization engine, move branch (counterpart of
``cruise_control_tpu/analyzer/engine.py``).

One goal runs as a budgeted loop of PASSES; a pass is

    1. severity = goal.broker_severity(state)                    f32[B]
    2. cand     = K1 top-(K*W) of goal.replica_key(state), stall-salted
    3. per wave: K2 [K, B] legitimacy + chain rooms + rack veto + score ->
                 per-class best; destination spread (plain torch);
                 K3 budgeted admission; K4 batched apply.

The reference runs the loop as one ``lax.while_loop`` program; here it is a
host loop over device tensors with ONE small device->host read per pass
(the applied count, the verdict and the stat that the loop's exit
conditions need). Capturing a pass as a CUDA graph is later work (K11).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, WAVE_DIMS, WAVE_ZERO_EXEMPT_DIMS, GoalKernel, legit_move_rows,
)
from cruise_control_tpu_torch.analyzer.state import EngineState, apply_moves_batched
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import (
    move_score_classes, select_candidates, wave_admission,
)


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Engine knobs, every field and default as in the reference (see its
    docstrings). The port reads the budgeted-loop fields; options of paths
    it has not ported raise in ``check_supported``."""
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
    """Raise for the engine options whose paths are not ported yet."""
    if params.compute_dtype == "bfloat16":
        raise NotImplementedError("bf16 score sweeps are not ported yet "
                                  "(ROADMAP.md Queue 1 item 5, precision policy)")
    if params.compact_keying:
        raise NotImplementedError("compact_keying is not ported yet "
                                  "(ROADMAP.md Queue 2 K1, _compact_eligible)")
    if not params.chain_cache:
        raise NotImplementedError("chain_cache=False (per-goal accept masks) is "
                                  "not ported yet (ROADMAP.md Queue 1 item 5)")
    if params.mesh is not None:
        raise NotImplementedError("the sharded engine is not ported yet "
                                  "(ROADMAP.md Queue 1 item 15)")


def check_goal_supported(goal: GoalKernel) -> None:
    if goal.uses_leadership_moves or goal.uses_swaps or goal.uses_disk_moves:
        raise NotImplementedError(
            f"{goal.name}: the leadership / swap / disk branches are not ported "
            f"yet (ROADMAP.md Queue 1 item 5)")


def _move_delta_rows(env: ClusterEnv, st: EngineState, cand: torch.Tensor) -> torch.Tensor:
    """f32[K, WAVE_DIMS] wave-delta rows of candidate MOVES."""
    K = cand.shape[0]
    lead = st.replica_is_leader[cand]
    eff = torch.where(lead[:, None], env.leader_load[cand], env.follower_load[cand])
    one = torch.ones((K, 1), dtype=eff.dtype, device=eff.device)
    return torch.cat([
        eff, one, lead[:, None].to(eff.dtype),
        env.leader_load[cand, Resource.NW_OUT][:, None],
        torch.zeros((K, 1), dtype=eff.dtype, device=eff.device),
    ], dim=1).contiguous()


def _combined_move_rooms(prev_goals: tuple, env: ClusterEnv, st: EngineState):
    """({dim: (src_room | None, dst_room | None)}, rack_veto): the chain's
    interval-form vetoes folded into per-dim MIN room tables, and whether a
    previous goal vetoes by rack (the one custom veto ported so far)."""
    rooms: dict = {}
    rack_veto = False
    for g in prev_goals:
        if g.rack_veto:
            rack_veto = True
            continue
        rm = g.accept_move_rooms(env, st)
        if rm is None:
            continue
        for dim, (s, d) in rm.items():
            cs, cd = rooms.get(dim, (None, None))
            rooms[dim] = (
                s if cs is None else cs if s is None else torch.minimum(cs, s),
                d if cd is None else cd if d is None else torch.minimum(cd, d))
    return rooms, rack_veto


def _score_args(env: ClusterEnv, st: EngineState, goal: GoalKernel, rooms: dict,
                rack_veto: bool, cand, kv, d_rows, T: int) -> tuple:
    """Arguments of the K2 launch (``kernels.move_score_classes``) for the
    [K, B] stage of a wave: the per-row legitimacy, source rooms and goal
    rows, the per-broker destination rooms and goal columns."""
    B = env.num_brokers
    src_b = st.replica_broker[cand]
    sib_b, replica_ok, dst_ok, new_ok = legit_move_rows(env, st, cand, goal.options)
    row_ok = replica_ok & (kv > NEG_INF)
    dst_room = torch.full((WAVE_DIMS, B), torch.inf, dtype=torch.float32,
                          device=env.device)
    room_mask = 0
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
    family, row_f, col_f = goal.move_tables(env, st, cand)
    prow = None
    if goal.rack_veto or rack_veto:
        prow = st.part_rack_count[env.replica_partition[cand]].to(torch.int64)
    return (family, T, src_b.contiguous(),
            env.replica_original_broker[cand].contiguous(), sib_b,
            row_ok.contiguous(), d_rows, dst_room, room_mask, prow, rack_veto,
            row_f.contiguous(), col_f.contiguous(), dst_ok, new_ok, env.broker_rack)


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
            if not g.wave_safe:
                raise NotImplementedError(
                    f"{g.name}: the one-move-per-broker wave is not ported yet "
                    f"(ROADMAP.md Queue 1 item 5)")
            continue
        src_slack = torch.minimum(src_slack, bud[0])
        dst_slack = torch.minimum(dst_slack, bud[1])
    return src_slack.contiguous(), dst_slack.contiguous()


def _admission_args(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                    prev_goals: tuple, params: EngineParams, cand, kv):
    """Score a wave (K2) and fan its rows across destination classes;
    returns (rows in score order, their destinations, the K3 arguments)."""
    K = cand.shape[0]
    B = env.num_brokers
    d_rows = _move_delta_rows(env, st, cand)
    src_b = st.replica_broker[cand]
    rooms, rack_veto = _combined_move_rooms(prev_goals, env, st)
    T = min(params.num_dst_choices, B)
    Bp = -(-B // T) * T
    cls_val, cls_q = move_score_classes(
        *_score_args(env, st, goal, rooms, rack_veto, cand, kv, d_rows, T))
    # destination spread: the row at sorted position j prefers its best
    # destination in class (j mod T) when that class scores, else its
    # global best (lowest column among the max-achieving classes)
    posn = torch.arange(K, device=env.device)
    cols = cls_q * T + torch.arange(T, device=env.device)[None, :]
    best_val = cls_val.max(dim=1).values
    glob_dst = torch.where(cls_val == best_val[:, None], cols, Bp).min(dim=1).values
    order = torch.argsort(-best_val, stable=True)
    rank = torch.empty_like(posn)
    rank[order] = posn
    cls = rank % T
    aff_val = cls_val[posn, cls]
    aff_dst = cls_q[posn, cls] * T + cls
    use_aff = aff_val > params.min_gain
    dst_u = torch.where(use_aff, aff_dst, glob_dst)
    val_u = torch.where(use_aff, aff_val, best_val)

    r_sorted = cand[order]
    src_s = src_b[order].contiguous()
    dst_s = dst_u[order].contiguous()
    wave_ok = (val_u[order] > params.min_gain).contiguous()
    src_slack, dst_slack = chain_slack(env, st, (goal, *prev_goals))
    args = (d_rows[order].contiguous(), src_s, dst_s, wave_ok,
            env.replica_partition[r_sorted].contiguous(), src_slack, dst_slack,
            goal.wave_gain_budgets(env, st),
            st.replica_offline[r_sorted].contiguous())
    return r_sorted, dst_s, args


def _move_wave(env: ClusterEnv, st: EngineState, goal: GoalKernel,
               prev_goals: tuple, params: EngineParams, cand, kv):
    """ONE scored admission wave over ``cand``: re-score against the live
    state (K2), fan rows across destination classes, admit under the chain's
    cumulative budgets (K3) and apply the winners in one batch (K4).
    Returns (state, n_applied as a device scalar)."""
    r_sorted, dst_s, args = _admission_args(env, st, goal, prev_goals, params,
                                            cand, kv)
    win = wave_admission(*args)
    st = apply_moves_batched(env, st, r_sorted, dst_s, win)
    return st, win.sum()


def _move_branch_batched(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                         prev_goals: tuple, params: EngineParams,
                         severity: torch.Tensor, stall: int):
    """Key once (K1), then up to ``pass_waves`` rank-banded waves; a wave
    that admits nothing ends the pass. Returns (state, n_applied device
    scalar, waves run)."""
    R = env.num_replicas
    K = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(K, 1)))
    key = goal.replica_key(env, st, severity)
    k_all = min(K * W, R)
    kv_all, cand_all = select_candidates(key.contiguous(), k_all, stall,
                                         exact=goal.is_hard or k_all >= R)
    waves = min(max(int(params.pass_waves), 1), W)
    total = torch.zeros((), dtype=torch.int64, device=env.device)
    run = 0
    for w in range(waves):
        st, n = _move_wave(env, st, goal, prev_goals, params,
                           cand_all[w * K:(w + 1) * K], kv_all[w * K:(w + 1) * K])
        total = total + n
        run += 1
        if w + 1 < waves and int(n) == 0:
            break
    return st, total, run


def _loop_scalar_init():
    """The budgeted loop's scalar carries: (it, n_applied, stall, dribble,
    sat, win_stat, win_dribble, plateau, tailp, b_moves, b_waves)."""
    return dict(it=0, n_applied=0, stall=0, dribble=0, sat=False,
                win_stat=np.float32(np.inf), win_dribble=0, plateau=False,
                tailp=0, b_moves=0, b_waves=0)


def _cond(c: dict, params: EngineParams) -> bool:
    stall_cap = (min(params.stall_retries, params.sat_stall_retries) if c["sat"]
                 else params.stall_retries)
    tail_cap = (min(params.tail_pass_budget, params.sat_tail_passes) if c["sat"]
                else params.tail_pass_budget)
    return (c["stall"] <= stall_cap and c["dribble"] <= tail_cap
            and c["tailp"] <= params.tail_total_budget
            and c["it"] < params.max_iters and not c["plateau"])


def _step(env, st, goal, prev_goals, params, c: dict):
    """One pass (the reference's ``step`` with the move branch only)."""
    severity = goal.broker_severity(env, st)
    c["tailp"] += int((c["stall"] + c["dribble"]) > 0)
    explore = c["stall"] + c["dribble"]
    st, n_moves, n_waves = _move_branch_batched(env, st, goal, prev_goals, params,
                                                severity, explore)
    # the pass's one device->host read
    applied, viol, stat_now = torch.stack([
        n_moves.to(torch.float32), goal.violated(env, st).to(torch.float32),
        goal.stat(env, st).to(torch.float32)]).tolist()
    applied = int(applied)
    stat_now = np.float32(stat_now)
    c["b_moves"] += applied
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
    return st


def _goal_loop(env: ClusterEnv, st: EngineState, goal: GoalKernel,
               prev_goals: tuple, params: EngineParams, finisher: bool = True):
    """One goal's budgeted loop. ``finisher=True`` stands for the reference's
    per-goal program, whose exhaustive finisher compiles out only when
    ``max_finisher_rounds <= 0``; the finisher is not ported yet, so the port
    requires that (or ``finisher=False``, the fused-prefix form)."""
    check_supported(params)
    check_goal_supported(goal)
    if finisher and params.max_finisher_rounds > 0:
        raise NotImplementedError("the exhaustive finisher is not ported yet "
                                  "(ROADMAP.md Queue 1 item 6); pass "
                                  "max_finisher_rounds=0")
    stat_before = float(goal.stat(env, st))
    c = _loop_scalar_init()
    while _cond(c, params):
        st = _step(env, st, goal, prev_goals, params, c)
    violated = bool(goal.violated(env, st))
    budget_exit = (c["it"] >= params.max_iters
                   or c["dribble"] > params.tail_pass_budget
                   or c["tailp"] > params.tail_total_budget
                   or c["plateau"])
    hit_max_iters = (c["stall"] <= params.stall_retries and budget_exit
                     and violated)
    return st, {"iterations": c["n_applied"], "passes": c["it"],
                "violated_after": violated,
                "hit_max_iters": hit_max_iters,
                "plateau_exit": c["plateau"],
                "fixpoint_proven": False,
                "finisher_rounds": 0,
                "moves_remaining": -1,
                "leads_remaining": -1,
                "swap_window_remaining": -1,
                "stat_before": stat_before,
                "move_actions": c["b_moves"],
                "lead_actions": 0,
                "swap_actions": 0,
                "disk_actions": 0,
                "move_waves": c["b_waves"],
                "finisher_actions": 0,
                "finisher_segments": 0,
                "finisher_boundary": 0,
                "stat": float(goal.stat(env, st))}


def optimize_goal(env: ClusterEnv, st: EngineState, goal: GoalKernel,
                  prev_goals: tuple = (), params: EngineParams = EngineParams()):
    """Run one goal to completion. Returns (state, info dict)."""
    return _goal_loop(env, st, goal, tuple(prev_goals), params, finisher=True)
