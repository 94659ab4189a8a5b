"""The fleet's lane stack and its budgeted pass loop (K14's first part;
counterpart of ``cruise_control_tpu/analyzer/engine.py`` ``_compiled_fleet_chunk``
:2324, ``_compiled_fleet_chunk_gated`` :2391 and
``cruise_control_tpu/analyzer/optimizer.py`` ``_compiled_stack`` :2554).

The reference stacks K same-bucket tenants along a leading axis and
``vmap``s one goal's chunk program over them. Here the tenants' env and
state tensors are stacked into one ``LaneStack`` ([L, ...] tensors), each
lane's solo ``ClusterEnv`` / ``EngineState`` is a zero-copy view of its
slice, and the pass loop is a host loop over the stack that keeps one carry
dict per lane:

- the move, leadership and swap branches run for every lane that takes
  them in one launch per stage: the K1 keying (``replica_keys_lanes``), K1
  (``select_candidates_lanes``), then K2 (``move_score_classes_lanes``) and
  K3 (``wave_admission_lanes``) for a move wave, K6
  (``leadership_rows_lanes``) and K3 for a leadership wave, K7
  (``swap_rows_lanes``, ``swap_admission_lanes``) for a swap wave, and the
  K4/K5 applies with the lane folded into the segment ids
  (``state.apply_moves_lanes``, ``apply_leaderships_lanes``,
  ``apply_swaps_lanes``; a swap wave's residual fold per lane in its solo
  order);
- the goals' SPI (severity, keys' broker rows, move tables, rooms, budgets,
  verdicts, stats) is evaluated per lane on the lane's views, so every
  cluster-wide reduction (thresholds, averages, balance limits) is the solo
  run's, in the solo order; its [La, ...] outputs are stacked into the
  lane kernels' operands;
- the disk branch runs the solo code lane by lane on the views and writes
  the lanes that ran back into the stack; so do the move branch of a chain
  with a goal that has no move-wave budget (the one-move-per-broker wave)
  and the leadership branch of a chain with a goal that has no leadership
  budget (``seq_body``);
- ``compact_keying`` keys every lane through the pooled K1's lane form
  (``select_pooled_lanes``: each lane takes its branch on the device) and
  ``chain_cache=False`` scores every lane through K2's per-goal veto form,
  as the reference vmaps one goal program with the shared params;
- the gated chain's probe (``probe_lanes``) keys every lane at once and
  answers every lane in one K13 launch (``seeded_probe_lanes``); its
  verdicts and stats stay the goals' torch functions, per lane;
- a pass makes the same host reads at any L: one per branch gate and one
  [La, 6] read that closes the pass for every lane.

A frozen or finished lane is never written and costs no launch: each stage
launches for the list of running lanes only. Each lane's trajectory is its
solo run's (``engine._step``), bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from cruise_control_tpu_torch.analyzer.engine import (
    EngineParams, _admission_from_scores, _chain_capable, _close_pass, _cond,
    _disk_move_branch_batched, _lead_admission_from_scores, _lead_args,
    _leadership_branch_batched, _loop_scalar_init, _move_branch_batched, _pass_row,
    _score_prep, _swap_admission_inputs, _swap_args, _sweep_env, _sweep_view, compact_pool,
)
from cruise_control_tpu_torch.analyzer.env import ClusterEnv, SweepEnv
from cruise_control_tpu_torch.analyzer.goals.base import (
    NEG_INF, GoalKernel, KeySpec, capture_keys,
)
from cruise_control_tpu_torch.analyzer.state import (
    EngineState, apply_leaderships_lanes, apply_moves_lanes, apply_swaps_lanes,
)
from cruise_control_tpu_torch.kernels import (
    leadership_rows_lanes, move_score_classes_lanes, replica_keys_lanes,
    seeded_probe_lanes, select_candidates_lanes, swap_admission_lanes,
    swap_rows_lanes, wave_admission_lanes,
)
from cruise_control_tpu_torch.kernels.build import lane_index
from cruise_control_tpu_torch.kernels.keys import env_loads

_ENV_INTS = ("num_real_racks", "num_racks", "max_rf")


def _tensor_fields(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls) if f.name not in _ENV_INTS]


def _env_view(env_b: ClusterEnv, lane_env: ClusterEnv, l: int) -> ClusterEnv:
    kw = {f: getattr(env_b, f)[l] for f in _tensor_fields(ClusterEnv)}
    kw.update({f: getattr(lane_env, f) for f in _ENV_INTS})
    if isinstance(env_b, SweepEnv) and env_b.sweep_loads is not None:
        return SweepEnv(**kw, sweep_loads=tuple(t[l] for t in env_b.sweep_loads))
    return ClusterEnv(**kw)


def _state_view(st_b: EngineState, l: int) -> EngineState:
    return EngineState(**{f.name: getattr(st_b, f.name)[l]
                          for f in dataclasses.fields(EngineState)})


def read_values(xs: list) -> list:
    """One device->host read of a list of 0-d device scalars."""
    if not xs:
        return []
    return torch.stack([x.to(torch.float32) for x in xs]).tolist()


class LaneStack:
    """L same-bucket tenants' env and state stacked along a leading lane
    axis (``_compiled_stack``: a copy, so the tenants' own tensors are never
    written), with each lane's solo view."""

    def __init__(self, envs: list, sts: list):
        shape0 = self._shapes(envs[0])
        for e in envs[1:]:
            if self._shapes(e) != shape0:
                raise ValueError("optimizations_batched requires same-shape-bucket "
                                 "sessions (stack the fleet by bucket first)")
        self.size = len(envs)
        self.lane_envs = list(envs)
        self.env_b = ClusterEnv(**{f: torch.stack([getattr(e, f) for e in envs])
                                   for f in _tensor_fields(ClusterEnv)},
                                **{f: getattr(envs[0], f) for f in _ENV_INTS})
        self.st_b = EngineState(**{f.name: torch.stack([getattr(s, f.name) for s in sts])
                                   for f in dataclasses.fields(EngineState)})
        self.envs = [_env_view(self.env_b, envs[l], l) for l in range(self.size)]
        self.sts = [_state_view(self.st_b, l) for l in range(self.size)]
        self._sweep: dict = {}

    @staticmethod
    def _shapes(env: ClusterEnv) -> tuple:
        return (tuple((f, tuple(getattr(env, f).shape), getattr(env, f).dtype)
                      for f in _tensor_fields(ClusterEnv))
                + (env.num_racks, env.max_rf))

    @property
    def num_replicas(self) -> int:
        return self.env_b.leader_load.shape[1]

    @property
    def device(self) -> torch.device:
        return self.env_b.leader_load.device

    def sweep(self, params: EngineParams):
        """(stacked sweep env, per-lane sweep views) of the precision policy
        (``engine._sweep_env``; the env itself under f32)."""
        key = params.compute_dtype
        if key not in self._sweep:
            sw_b = _sweep_env(self.env_b, params)
            views = (self.envs if sw_b is self.env_b else
                     [_env_view(sw_b, self.lane_envs[l], l) for l in range(self.size)])
            self._sweep[key] = (sw_b, views)
        return self._sweep[key]

    def write_lanes(self, lanes: list, sts: list) -> None:
        """Write the new states of ``lanes`` into the stack: one lane's by a
        copy into its views, several lanes' by one indexed write per field
        for all of them (fields every lane left as its view are skipped)."""
        idx = lane_index(lanes, self.device) if len(lanes) > 1 else None
        for f in dataclasses.fields(EngineState):
            vals = [getattr(st, f.name) for st in sts]
            if all(v.data_ptr() == getattr(self.sts[l], f.name).data_ptr()
                   for v, l in zip(vals, lanes)):
                continue
            if idx is None:
                getattr(self.sts[lanes[0]], f.name).copy_(vals[0])
            else:
                getattr(self.st_b, f.name)[idx] = torch.stack(vals)

    def state_copy(self, l: int) -> EngineState:
        """Lane ``l``'s state as tensors of its own."""
        v = self.sts[l]
        return EngineState(**{f.name: getattr(v, f.name).clone()
                              for f in dataclasses.fields(EngineState)})


def lane_keys(stack: LaneStack, goal: GoalKernel, lanes: list, severity: dict,
              params: EngineParams | None, method: str = "replica_key") -> torch.Tensor:
    """f32[La, R] keys of the running lanes: the goal's key function
    ``method`` (``replica_key``, ``leader_key``, ``swap_out_key`` or
    ``swap_in_key``) per lane on its sweep view of ``params``' precision
    (None: the exact env), the K1 keying launched once for all of them (or
    the goal's plain torch keys stacked)."""
    sw_b, sw = stack.sweep(params) if params is not None else (stack.env_b, stack.envs)
    fn = getattr(goal, method)
    with capture_keys():
        specs = [fn(*_sweep_view(stack.envs[l], stack.sts[l], sw[l]), severity[l])
                 for l in lanes]
    if not isinstance(specs[0], KeySpec):
        return torch.stack(specs).contiguous()
    fam, col = specs[0].family, specs[0].col
    if any((s.family, s.col) != (fam, col) for s in specs):
        raise ValueError("lane_keys: lanes disagree on the keying family")
    st_b = stack.st_b
    intra = specs[0].dt is not None
    return replica_keys_lanes(
        fam, env_loads(sw_b), col, st_b.replica_broker, st_b.replica_is_leader,
        st_b.replica_offline, stack.env_b.replica_valid, lanes,
        torch.stack([s.bt for s in specs]).contiguous(),
        torch.stack([s.sc for s in specs]).contiguous(),
        st_b.replica_disk if intra else None,
        torch.stack([s.dt for s in specs]).contiguous() if intra else None)


def move_branch_lanes(stack: LaneStack, goal: GoalKernel, prev_goals: tuple,
                      params: EngineParams, severity: dict, explore: dict,
                      lanes: list, seed_masks: dict):
    """``engine._move_branch_batched`` for the running lanes ``lanes``: key
    once, then up to ``pass_waves`` rank-banded waves; each lane leaves the
    wave loop at its own zero-admission wave and later waves carry only the
    lanes still admitting. Returns ({lane: n_applied device scalar},
    {lane: waves run})."""
    R = stack.num_replicas
    K = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(K, 1)))
    k_all = min(K * W, R)
    _sw_b, sw = stack.sweep(params)
    key = lane_keys(stack, goal, lanes, severity, params)
    mask = lane_masks(stack, lanes, seed_masks)
    kv_all, cand_all = select_candidates_lanes(key, k_all, [explore[l] for l in lanes],
                                               seed_mask=mask,
                                               compact_pool=compact_pool(params))
    waves = min(max(int(params.pass_waves), 1), W)
    total = {l: torch.zeros((), dtype=torch.int64, device=stack.device) for l in lanes}
    runs = {l: 0 for l in lanes}
    live = list(range(len(lanes)))
    for w in range(waves):
        lw = [lanes[j] for j in live]
        cands = [cand_all[j, w * K:(w + 1) * K] for j in live]
        preps = [_score_prep(stack.envs[l], stack.sts[l], goal, prev_goals, params,
                             cand, kv_all[j, w * K:(w + 1) * K], sw[l])
                 for l, j, cand in zip(lw, live, cands)]
        # a room dimension some lanes lack reads +inf there: the union of
        # the lanes' room masks is exact for each of them
        room_mask = 0
        for _d, a in preps:
            room_mask |= a[8]
        score_args = [a[:8] + (room_mask,) + a[9:] for _d, a in preps]
        cls_val, cls_q = move_score_classes_lanes(score_args)
        fins = [_admission_from_scores(stack.envs[l], stack.sts[l], goal, prev_goals,
                                       params, cand, d_rows, cls_val[i], cls_q[i])
                for i, (l, cand, (d_rows, _a)) in enumerate(zip(lw, cands, preps))]
        win = wave_admission_lanes([f[2] for f in fins])
        apply_moves_lanes([stack.envs[l] for l in lw], [stack.sts[l] for l in lw],
                          torch.stack([f[0] for f in fins]),
                          torch.stack([f[1] for f in fins]), win, into=(stack.st_b, lw))
        n = win.sum(dim=1)
        for i, l in enumerate(lw):
            total[l] = total[l] + n[i]
            runs[l] += 1
        if w + 1 < waves:
            admitted = [int(x) for x in n.tolist()]
            live = [j for j, a in zip(live, admitted) if a > 0]
            if not live:
                break
    return total, runs


def lane_masks(stack: LaneStack, lanes: list, seed_masks: dict):
    """bool[La, R] seed masks of the running lanes (all ones for a lane
    without one), or None when no lane has one."""
    if all(seed_masks.get(l) is None for l in lanes):
        return None
    ones = torch.ones(stack.num_replicas, dtype=torch.bool, device=stack.device)
    return torch.stack([ones if seed_masks.get(l) is None else seed_masks[l]
                        for l in lanes]).contiguous()


def probe_lanes(stack: LaneStack, goal: GoalKernel, lanes: list,
                masks: list) -> torch.Tensor:
    """bool[La]: ``GoalKernel.seeded_work_probe`` of every running lane
    against its seed mask (``masks``: bool[R] per lane), each key kind keyed
    once for all lanes and ONE K13 launch (``seeded_probe_lanes``; engine.py
    ``_compiled_fleet_probe`` :2377)."""
    methods = goal.seeded_work_methods()
    if not methods:
        return torch.zeros(len(lanes), dtype=torch.bool, device=stack.device)
    sev = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes}
    keys = [lane_keys(stack, goal, lanes, sev, None, m) for m in methods]
    return seeded_probe_lanes(torch.stack(masks).contiguous(), keys)


def lead_branch_lanes(stack: LaneStack, goal: GoalKernel, prev_goals: tuple,
                      params: EngineParams, severity: dict, explore: dict,
                      lanes: list, seed_masks: dict) -> dict:
    """``engine._leadership_branch_batched`` for the running lanes
    ``lanes``: the leader keys (K1 keying), K1, K6 and K3 each launched once
    for every lane, the goals' SPI per lane on its views, and one folded
    apply. Returns {lane: n_applied device scalar}."""
    kl = min(params.num_leader_candidates, stack.num_replicas)
    _sw_b, sw = stack.sweep(params)
    key = lane_keys(stack, goal, lanes, severity, params, "leader_key")
    lkv, lcand = select_candidates_lanes(key, kl, [explore[l] for l in lanes],
                                         seed_mask=lane_masks(stack, lanes, seed_masks),
                                         compact_pool=compact_pool(params))
    envs = [stack.envs[l] for l in lanes]
    sts = [stack.sts[l] for l in lanes]
    best, f_all = leadership_rows_lanes(
        [_lead_args(envs[j], sts[j], goal, prev_goals, lcand[j], lkv[j] > NEG_INF, sw[l])
         for j, l in enumerate(lanes)],
        stacked=(lanes, stack.st_b.replica_broker, stack.st_b.replica_offline))
    adm = [_lead_admission_from_scores(envs[j], sts[j], goal, prev_goals, params,
                                       lcand[j], best[j], f_all[j])
           for j in range(len(lanes))]
    win = wave_admission_lanes([a[2] for a in adm])
    new = apply_leaderships_lanes(envs, sts, torch.stack([a[0] for a in adm]),
                                  torch.stack([a[1] for a in adm]), win)
    stack.write_lanes(lanes, new)
    n = win.sum(dim=1)
    return {l: n[j] for j, l in enumerate(lanes)}


def swap_branch_lanes(stack: LaneStack, goal: GoalKernel, prev_goals: tuple,
                      params: EngineParams, severity: dict, explore: dict,
                      lanes: list, seed_masks: dict, fold_legs: bool) -> dict:
    """``engine._swap_branch_batched`` for the running lanes ``lanes``: the
    out and in pools (K1 keying and K1, each once for every lane; the seed
    mask on the out pool only), K7 ``swap_rows`` and ``swap_admission``
    once each, the goals' SPI per lane on its views, and one two-leg folded
    apply (each lane's residual fold in its solo order). Returns {lane:
    n_applied device scalar}."""
    k = min(params.num_swap_candidates, stack.num_replicas, 128)
    _sw_b, sw = stack.sweep(params)
    stalls = [explore[l] for l in lanes]
    pool = compact_pool(params)
    okv, cand_out = select_candidates_lanes(
        lane_keys(stack, goal, lanes, severity, params, "swap_out_key"), k, stalls,
        seed_mask=lane_masks(stack, lanes, seed_masks), compact_pool=pool)
    ikv, cand_in = select_candidates_lanes(
        lane_keys(stack, goal, lanes, severity, params, "swap_in_key"), k, stalls,
        salt=101, compact_pool=pool)
    envs = [stack.envs[l] for l in lanes]
    sts = [stack.sts[l] for l in lanes]
    args = [_swap_args(envs[j], sts[j], goal, prev_goals, cand_out[j], okv[j], cand_in[j],
                       ikv[j], sw[l]) for j, l in enumerate(lanes)]
    best, best_j, _n = swap_rows_lanes(
        [a[0] for a in args], [a[1] for a in args], params.min_gain,
        stacked=(lanes, stack.env_b.broker_rack, stack.st_b.topic_broker_count))
    adm = [_swap_admission_inputs(envs[j], args[j][0], cand_out[j], cand_in[j], best[j],
                                  best_j[j]) for j in range(len(lanes))]
    win = swap_admission_lanes(*(torch.stack([a[2][i] for a in adm]) for i in range(6)),
                               params.min_gain)
    new = apply_swaps_lanes(envs, sts, torch.stack([a[0] for a in adm]),
                            torch.stack([a[1] for a in adm]), win, fold_legs)
    stack.write_lanes(lanes, new)
    n = win.sum(dim=1)
    return {l: n[j] for j, l in enumerate(lanes)}


def fleet_step(stack: LaneStack, goal: GoalKernel, prev_goals: tuple, lane_params: dict,
               carries: dict, act: list, seed_masks: dict, fold_legs: bool) -> None:
    """One pass (``engine._step``) of every lane in ``act``."""
    dev = stack.device
    severity = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in act}
    explore = {}
    for l in act:
        c = carries[l]
        c["tailp"] += int((c["stall"] + c["dribble"]) > 0)
        explore[l] = c["stall"] + c["dribble"]
    lead_first = goal.uses_leadership_moves and goal.leadership_primary
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_disk, n_moves, n_leads, n_swaps = ({l: zero for l in act} for _ in range(4))
    n_waves = {l: 0 for l in act}

    def solo(branch, l):
        """One lane's branch on its views (the solo code), written back."""
        p = lane_params[l]
        _sw_b, sw = stack.sweep(p)
        st, *rest = branch(stack.envs[l], stack.sts[l], goal, prev_goals, p, severity[l],
                           explore[l], env_sw=sw[l], seed_mask=seed_masks.get(l))
        stack.write_lanes([l], [st])
        return rest

    def leads(lanes_now):
        if _chain_capable((goal, *prev_goals), leadership=True):
            n_leads.update(lead_branch_lanes(stack, goal, prev_goals,
                                             lane_params[lanes_now[0]], severity, explore,
                                             lanes_now, seed_masks))
        else:
            for l in lanes_now:
                n_leads[l], = solo(_leadership_branch_batched, l)

    if goal.uses_disk_moves:
        for l in act:
            n_disk[l], = solo(_disk_move_branch_batched, l)
    leads_now = {l: 0 for l in act}
    if lead_first:
        leads(act)
        leads_now = dict(zip(act, (int(x) for x in read_values([n_leads[l] for l in act]))))
    if goal.uses_replica_moves:
        ml = [l for l in act if leads_now[l] == 0]
        if not _chain_capable((goal, *prev_goals)):
            for l in ml:
                n_moves[l], n_waves[l] = solo(_move_branch_batched, l)
        elif ml:
            totals, runs = move_branch_lanes(stack, goal, prev_goals, lane_params[ml[0]],
                                             severity, explore, ml, seed_masks)
            n_moves.update(totals)
            n_waves.update(runs)
    if goal.uses_leadership_moves and not lead_first:
        moved = read_values([n_moves[l] for l in act])
        ll = [l for l, m in zip(act, moved) if int(m) == 0]
        if ll:
            leads(ll)
    if goal.uses_swaps:
        landed = read_values([n_moves[l] + n_leads[l] for l in act])
        sl = [l for l, m in zip(act, landed) if int(m) == 0]
        if sl:
            n_swaps.update(swap_branch_lanes(stack, goal, prev_goals, lane_params[sl[0]],
                                             severity, explore, sl, seed_masks, fold_legs))
    # the pass's closing device->host read, one [La, 6] read for every lane
    rows = torch.stack([torch.stack(_pass_row(stack.envs[l], stack.sts[l], goal,
                                              n_disk[l], n_moves[l], n_leads[l],
                                              n_swaps[l]))
                        for l in act]).tolist()
    for l, row in zip(act, rows):
        _close_pass(carries[l], lane_params[l], row, n_waves[l])


def fleet_goal_loop(stack: LaneStack, goal: GoalKernel, prev_goals: tuple,
                    lane_params: dict, lanes: list, chunk: int, seed_masks: dict):
    """The budgeted loop of one goal for the lanes ``lanes``
    (``engine._goal_loop`` before its finisher, per lane). ``chunk > 0`` is
    the chunked dispatch: at each chunk boundary a lane whose chunk
    admitted nothing while its loop condition held quiesces and freezes
    (engine.py ``_compiled_fleet_chunk``), the others keep stepping.
    Returns ({lane: carries}, {lane: quiesce chunk or -1}, {lane: stat at
    entry})."""
    stat_entry = dict(zip(lanes, read_values([goal.stat(stack.envs[l], stack.sts[l])
                                              for l in lanes])))
    carries = {l: _loop_scalar_init() for l in lanes}
    quiesce = {l: -1 for l in lanes}
    applied_prev = {l: 0 for l in lanes}
    frozen: set = set()
    chunks = 0
    while True:
        lim = {l: (carries[l]["it"] + chunk if chunk > 0 else math.inf) for l in lanes}
        while True:
            act = [l for l in lanes if l not in frozen
                   and _cond(carries[l], lane_params[l]) and carries[l]["it"] < lim[l]]
            if not act:
                break
            fleet_step(stack, goal, prev_goals, lane_params, carries, act, seed_masks,
                       fold_legs=chunk > 0)
        chunks += 1
        if chunk <= 0:
            break
        live = False
        for l in lanes:
            c = carries[l]
            if l in frozen or not _cond(c, lane_params[l]):
                continue
            if c["n_applied"] == applied_prev[l]:
                quiesce[l] = chunks - 1
                frozen.add(l)
                continue
            applied_prev[l] = c["n_applied"]
            live = True
        if not live:
            break
    return carries, quiesce, stat_entry
