"""Mutable engine state + incremental maintenance (counterpart of
``cruise_control_tpu/analyzer/state.py``: batched moves, batched swaps and
batched leadership transfers).

The pass loop carries this dataclass of device tensors and applies the
reference's bookkeeping as batched segment updates per wave; ``refresh``
recomputes everything from the assignment (the ground truth the tests hold
the incremental path against). Every segment sum goes through the K4/K5
kernels (``kernels.segment``): float sums in the oracle's row order, integer
tallies by atomics — deterministic run to run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import segment_count, segment_sum
from cruise_control_tpu_torch.kernels.build import lane_index


@dataclasses.dataclass(frozen=True)
class EngineState:
    replica_broker: torch.Tensor      # i64[R]
    replica_is_leader: torch.Tensor   # bool[R]
    replica_offline: torch.Tensor     # bool[R]
    replica_disk: torch.Tensor        # i64[R]
    util: torch.Tensor                # f32[B, M] total hosted load
    leader_util: torch.Tensor         # f32[B, M] leader-replica load only
    potential_nw_out: torch.Tensor    # f32[B] leader-mode NW_OUT of hosted replicas
    replica_count: torch.Tensor       # i32[B]
    leader_count: torch.Tensor        # i32[B]
    part_rack_count: torch.Tensor     # i32[P, K]
    topic_broker_count: torch.Tensor  # i32[T, B]
    topic_leader_count: torch.Tensor  # i32[T, B]
    disk_util: torch.Tensor           # f32[B, D]
    moved: torch.Tensor               # bool[R] relocated during this optimization
    leadership_moved: torch.Tensor    # bool[R]
    # Neumaier residuals of the incremental util / leader_util updates
    # (``util + util_residual`` is the compensated sum); refresh zeroes them
    util_residual: torch.Tensor       # f32[B, M]
    leader_util_residual: torch.Tensor  # f32[B, M]

    def effective_load(self, env: ClusterEnv) -> torch.Tensor:
        load = torch.where(self.replica_is_leader[:, None], env.leader_load,
                           env.follower_load)
        return torch.where(env.replica_valid[:, None], load, torch.zeros_like(load))


def init_state(env: ClusterEnv, replica_broker, replica_is_leader,
               replica_offline, replica_disk) -> EngineState:
    """Engine state of the given (host) assignment, derived tables refreshed."""
    dev = env.device

    def t(a, dtype):
        return torch.tensor(np.asarray(a), device=dev).to(dtype)

    return state_from_assignment(env, t(replica_broker, torch.int64),
                                 t(replica_is_leader, torch.bool),
                                 t(replica_offline, torch.bool),
                                 t(replica_disk, torch.int64))


def state_from_assignment(env: ClusterEnv, replica_broker: torch.Tensor,
                          replica_is_leader: torch.Tensor,
                          replica_offline: torch.Tensor,
                          replica_disk: torch.Tensor) -> EngineState:
    """Engine state of an assignment already on the device (i64 broker and
    logdir columns, bool flags): zeroed tallies, then ``refresh``. Shared by
    ``init_state`` and the resident session's finalize, so a sync is bit for
    bit a rebuild."""
    dev = env.device
    B, P, T, R = env.num_brokers, env.num_partitions, env.num_topics, env.num_replicas
    f32, i32 = torch.float32, torch.int32
    st = EngineState(
        replica_broker=replica_broker,
        replica_is_leader=replica_is_leader,
        replica_offline=replica_offline,
        replica_disk=replica_disk,
        util=torch.zeros_like(env.broker_capacity),
        leader_util=torch.zeros_like(env.broker_capacity),
        potential_nw_out=torch.zeros(B, dtype=f32, device=dev),
        replica_count=torch.zeros(B, dtype=i32, device=dev),
        leader_count=torch.zeros(B, dtype=i32, device=dev),
        part_rack_count=torch.zeros((P, env.num_racks), dtype=i32, device=dev),
        topic_broker_count=torch.zeros((T, B), dtype=i32, device=dev),
        topic_leader_count=torch.zeros((T, B), dtype=i32, device=dev),
        disk_util=torch.zeros_like(env.broker_disk_capacity),
        moved=torch.zeros(R, dtype=torch.bool, device=dev),
        leadership_moved=torch.zeros(R, dtype=torch.bool, device=dev),
        util_residual=torch.zeros_like(env.broker_capacity),
        leader_util_residual=torch.zeros_like(env.broker_capacity),
    )
    return refresh(env, st)


def refresh_sum_inputs(env: ClusterEnv, st: EngineState):
    """(values f32[R, 9], seg i64[R]) of refresh's per-broker float sums:
    columns util[4], leader_util[4], potential NW_OUT."""
    valid = env.replica_valid
    lead = st.replica_is_leader & valid
    zero = torch.zeros_like(env.leader_load)
    vals = torch.cat([
        st.effective_load(env),
        torch.where(lead[:, None], env.leader_load, zero),
        torch.where(valid, env.leader_load[:, Resource.NW_OUT],
                    torch.zeros_like(valid, dtype=torch.float32))[:, None],
    ], dim=1)
    return vals.contiguous(), st.replica_broker


def refresh_disk_inputs(env: ClusterEnv, st: EngineState):
    """(values f32[R, 1], seg i64[R], nseg) of refresh's per-logdir disk
    sums: segment ``broker * D + logdir``."""
    B, D = env.broker_disk_capacity.shape
    load = st.effective_load(env)
    return (load[:, Resource.DISK:Resource.DISK + 1].contiguous(),
            st.replica_broker * D + st.replica_disk, B * D)


def refresh(env: ClusterEnv, st: EngineState) -> EngineState:
    """Recompute all derived state from the assignment (ground truth)."""
    B, P, T = env.num_brokers, env.num_partitions, env.num_topics
    Kr = env.num_racks
    D = env.broker_disk_capacity.shape[1]
    rb = st.replica_broker
    valid = env.replica_valid
    lead = st.replica_is_leader & valid
    sums = segment_sum(*refresh_sum_inputs(env, st), B)
    vw = valid.to(torch.int32)
    lw = lead.to(torch.int32)
    flat = env.replica_partition * Kr + env.broker_rack[rb]
    tflat = env.replica_topic * B + rb
    du = segment_sum(*refresh_disk_inputs(env, st))
    util = sums[:, 0:4].contiguous()
    return dataclasses.replace(
        st, util=util, leader_util=sums[:, 4:8].contiguous(),
        potential_nw_out=sums[:, 8].contiguous(),
        replica_count=segment_count(rb, B, vw),
        leader_count=segment_count(rb, B, lw),
        part_rack_count=segment_count(flat, P * Kr, vw).view(P, Kr),
        topic_broker_count=segment_count(tflat, T * B, vw).view(T, B),
        topic_leader_count=segment_count(tflat, T * B, lw).view(T, B),
        disk_util=du.view(B, D),
        util_residual=torch.zeros_like(util),
        leader_util_residual=torch.zeros_like(util))


def apply_sum_inputs(env: ClusterEnv, st: EngineState, replicas: torch.Tensor,
                     dsts: torch.Tensor, mask: torch.Tensor):
    """(values f32[2W, 9], seg i64[2W], init f32[B, 9]) of one wave's
    chained per-broker float update: every source row (negated, in row
    order), then every destination row; columns util[4], leader_util[4],
    potential NW_OUT. Masked rows get segment -1 (they add nothing)."""
    is_leader = st.replica_is_leader[replicas]
    src = st.replica_broker[replicas]
    zero = torch.zeros((replicas.shape[0], 4), dtype=torch.float32,
                       device=replicas.device)
    load = torch.where(is_leader[:, None], env.leader_load[replicas],
                       env.follower_load[replicas])
    load = torch.where(mask[:, None], load, zero)
    lead_load = torch.where((mask & is_leader)[:, None], env.leader_load[replicas],
                            zero)
    pot = torch.where(mask, env.leader_load[replicas, Resource.NW_OUT],
                      zero[:, 0])
    row = torch.cat([load, lead_load, pot[:, None]], dim=1)          # [W, 9]
    vals = torch.cat([-row, row]).contiguous()                        # src, then dst
    none = torch.full_like(src, -1)
    seg = torch.cat([torch.where(mask, src, none), torch.where(mask, dsts, none)])
    init = torch.cat([st.util, st.leader_util, st.potential_nw_out[:, None]],
                     dim=1).contiguous()
    return vals, seg, init


def residual_inputs(st: EngineState, util: torch.Tensor, leader_util: torch.Tensor,
                    vals: torch.Tensor, seg: torch.Tensor, chained: bool = False):
    """(values f32[N, 8], seg, init f32[B, 8]) of one wave's Neumaier
    residual update (``_kahan_scatter2``'s ``res + ((acc - new) + agg)``,
    ``agg`` the wave's util / leader_util deltas scattered into zeros) as
    XLA:CPU evaluates it: its simplifier folds the scatter into zeros into
    the add, so the deltas add, in the scatter's row order, onto
    ``res + (acc - new)`` when ``res`` enters the program as a value (a
    loop carry: every apply of the pass loop and the finisher), and onto
    ``acc - new`` alone when ``res`` is the previous apply's scatter output
    in the same program (``chained``; a swap wave folds its two legs
    together, ``swap_residual_inputs``). ``vals`` are the wave's rows (util and
    leader_util deltas first), ``util`` / ``leader_util`` the updated
    tallies."""
    init = torch.cat([st.util - util, st.leader_util - leader_util], dim=1)
    if not chained:
        init = torch.cat([st.util_residual, st.leader_util_residual], dim=1) + init
    return vals[:, :8].contiguous(), seg, init.contiguous()


def apply_move_count_inputs(env: ClusterEnv, st: EngineState, replicas: torch.Tensor,
                            dsts: torch.Tensor, mask: torch.Tensor):
    """The ``segment_count`` arguments (seg, nseg, weights, init) of one
    wave's replica_count, leader_count, part_rack_count, topic_broker_count
    and topic_leader_count updates: -1 at every enabled row's source, +1 at
    its destination."""
    B, P, T, Kr = env.num_brokers, env.num_partitions, env.num_topics, env.num_racks
    is_leader = st.replica_is_leader[replicas]
    src = st.replica_broker[replicas]
    one = mask.to(torch.int32)
    lone = (mask & is_leader).to(torch.int32)
    w1 = torch.cat([-one, one])
    wl = torch.cat([-lone, lone])
    both = torch.cat([src, dsts])
    pidx = env.replica_partition[replicas]
    tidx = env.replica_topic[replicas]
    prc_seg = torch.cat([pidx * Kr + env.broker_rack[src],
                         pidx * Kr + env.broker_rack[dsts]])
    t_seg = torch.cat([tidx * B + src, tidx * B + dsts])
    return ((both, B, w1, st.replica_count), (both, B, wl, st.leader_count),
            (prc_seg, P * Kr, w1, st.part_rack_count.reshape(-1)),
            (t_seg, T * B, w1, st.topic_broker_count.reshape(-1)),
            (t_seg, T * B, wl, st.topic_leader_count.reshape(-1)))


def apply_disk_sum_inputs(env: ClusterEnv, st: EngineState, replicas: torch.Tensor,
                          dsts: torch.Tensor, mask: torch.Tensor, dl: torch.Tensor):
    """(values f32[2W, 1], seg i64[2W], nseg, init f32[B * D, 1], dst_disk
    i64[W]) of one wave's per-logdir disk update: ``-dl`` at every source
    logdir, then ``+dl`` at the destination's most-free alive logdir, read
    at the pre-wave state (dead logdirs read -inf, first maximum wins).
    Masked rows get segment -1."""
    B, D = env.broker_disk_capacity.shape
    src = st.replica_broker[replicas]
    free = torch.where(env.broker_disk_alive[dsts],
                       env.broker_disk_capacity[dsts] - st.disk_util[dsts],
                       torch.full((dsts.shape[0], D), -torch.inf,
                                  device=dsts.device))
    dst_disk = torch.argmax(free, dim=1)
    none = torch.full_like(src, -1)
    seg = torch.cat([torch.where(mask, src * D + st.replica_disk[replicas], none),
                     torch.where(mask, dsts * D + dst_disk, none)])
    return (torch.cat([-dl, dl])[:, None].contiguous(), seg, B * D,
            st.disk_util.reshape(B * D, 1).contiguous(), dst_disk)


def apply_moves_batched(env: ClusterEnv, st: EngineState, replicas: torch.Tensor,
                        dsts: torch.Tensor, mask: torch.Tensor,
                        chained: bool = False) -> EngineState:
    """Apply a WAVE of moves: ``replicas[W]`` relocate to ``dsts[W]`` where
    ``mask[W]``. Masked rows add zero and never write the assignment;
    enabled rows must be unique. Float tallies follow the reference's
    chained ``.at[src].add(-x).at[dst].add(x)`` order, with the Neumaier
    residual of ``_kahan_scatter2`` (``residual_inputs``; ``chained``: this
    wave directly follows another apply in the reference's program)."""
    return apply_moves_lanes([env], [st], replicas[None], dsts[None], mask[None],
                             chained)[0]


def _fold(parts: list, width: int, index: int = 1) -> tuple:
    """Concatenate per-lane segment-sum / count arguments with lane j's
    segment ids offset by ``j * width`` (negative ids stay skipped), so one
    launch serves every lane and each lane's rows keep their solo order."""
    if len(parts) == 1:
        return tuple(parts[0])
    cols = list(zip(*parts))
    seg = torch.cat([torch.where(sg >= 0, sg + j * width, sg)
                     for j, sg in enumerate(cols[index])])
    return tuple(seg if i == index else torch.cat(c) if isinstance(c[0], torch.Tensor)
                 else c[0] for i, c in enumerate(cols))


def apply_moves_lanes(envs: list, sts: list, replicas: torch.Tensor,
                      dsts: torch.Tensor, mask: torch.Tensor,
                      chained: bool = False, into: tuple | None = None):
    """``apply_moves_batched`` of La lanes (``envs`` / ``sts`` their solo
    views, ``replicas`` / ``dsts`` / ``mask`` [La, W]) with the K4/K5
    launches shared: every segment sum and count folds the lane into its
    segment ids (``lane * B + broker``), each lane's rows contiguous and in
    their solo order, so every f32 sum keeps its order. Returns the lanes'
    new states, or, with ``into`` = (a lane stack's [L, ...] state, the
    lanes' indices in it), writes them into those rows of the stack (one
    write per field for all lanes) and returns None."""
    La = len(envs)
    env0 = envs[0]
    B, P, T = env0.num_brokers, env0.num_partitions, env0.num_topics
    Kr = env0.num_racks
    D = env0.broker_disk_capacity.shape[1]
    W = replicas.shape[1]
    ins = [apply_sum_inputs(envs[j], sts[j], replicas[j], dsts[j], mask[j])
           for j in range(La)]
    vals, seg, init = _fold(ins, B)
    out = segment_sum(vals, seg, La * B, init).view(La, B, -1)
    res_in = [residual_inputs(sts[j], out[j, :, 0:4], out[j, :, 4:8], ins[j][0],
                              ins[j][1], chained) for j in range(La)]
    rvals, rseg, rinit = _fold(res_in, B)
    res = segment_sum(rvals, rseg, La * B, rinit).view(La, B, -1)
    counts = [apply_move_count_inputs(envs[j], sts[j], replicas[j], dsts[j], mask[j])
              for j in range(La)]
    tallies = []
    for kind in range(5):
        per = [counts[j][kind] for j in range(La)]
        nseg = per[0][1]
        if La == 1:
            tallies.append(segment_count(*per[0]).view(1, nseg))
            continue
        segs = torch.cat([a[0] + j * nseg for j, a in enumerate(per)])
        tallies.append(segment_count(segs, La * nseg, torch.cat([a[2] for a in per]),
                                     torch.cat([a[3] for a in per])).view(La, nseg))
    disk_in = [apply_disk_sum_inputs(envs[j], sts[j], replicas[j], dsts[j], mask[j],
                                     ins[j][0][W:, Resource.DISK]) for j in range(La)]
    dvals, dseg, _n, dinit, _dd = _fold(disk_in, B * D)
    du = segment_sum(dvals, dseg, La * B * D, dinit).view(La, B * D)
    if into is not None:
        st_b, lanes = into
        if chained:
            raise ValueError("a lane stack's move wave is never chained")
        idx = lane_index(lanes, replicas.device)
        st_b.util[idx] = out[:, :, 0:4]
        st_b.leader_util[idx] = out[:, :, 4:8]
        st_b.potential_nw_out[idx] = out[:, :, 8]
        st_b.util_residual[idx] = res[:, :, 0:4]
        st_b.leader_util_residual[idx] = res[:, :, 4:8]
        st_b.replica_count[idx] = tallies[0]
        st_b.leader_count[idx] = tallies[1]
        st_b.part_rack_count[idx] = tallies[2].view(La, P, Kr)
        st_b.topic_broker_count[idx] = tallies[3].view(La, T, B)
        st_b.topic_leader_count[idx] = tallies[4].view(La, T, B)
        st_b.disk_util[idx] = du.view(La, B, D)
        j, w = torch.nonzero(mask, as_tuple=True)
        flat = idx[j] * st_b.replica_broker.shape[1] + replicas[j, w]
        st_b.replica_broker.view(-1)[flat] = dsts[j, w]
        st_b.replica_disk.view(-1)[flat] = torch.stack([d[4] for d in disk_in])[j, w]
        st_b.replica_offline.view(-1)[flat] = False
        st_b.moved.view(-1)[flat] = True
        return None
    out_states = []
    for j in range(La):
        st = sts[j]
        util_res, lead_res = res[j, :, 0:4], res[j, :, 4:8]
        if chained:
            util_res = st.util_residual + util_res
            lead_res = st.leader_util_residual + lead_res
        en = torch.nonzero(mask[j]).flatten()
        r_en = replicas[j][en]
        replica_broker = st.replica_broker.clone()
        replica_broker[r_en] = dsts[j][en]
        replica_disk = st.replica_disk.clone()
        replica_disk[r_en] = disk_in[j][4][en]
        offline = st.replica_offline.clone()
        offline[r_en] = False
        moved = st.moved.clone()
        moved[r_en] = True
        rc, lc, prc, tbc, tlc = (t[j] for t in tallies)
        out_states.append(dataclasses.replace(
            st, replica_broker=replica_broker, replica_disk=replica_disk,
            replica_offline=offline, util=out[j, :, 0:4].contiguous(),
            leader_util=out[j, :, 4:8].contiguous(),
            potential_nw_out=out[j, :, 8].contiguous(), replica_count=rc.contiguous(),
            leader_count=lc.contiguous(), part_rack_count=prc.reshape(P, Kr),
            topic_broker_count=tbc.reshape(T, B), topic_leader_count=tlc.reshape(T, B),
            disk_util=du[j].reshape(B, D), util_residual=util_res.contiguous(),
            leader_util_residual=lead_res.contiguous(), moved=moved))
    return out_states


def apply_swaps_batched(env: ClusterEnv, st: EngineState, r_out: torch.Tensor,
                        r_in: torch.Tensor, mask: torch.Tensor,
                        fold_legs: bool = False) -> EngineState:
    """Apply a WAVE of swaps (``r_out[W]`` <-> ``r_in[W]`` where ``mask[W]``)
    as two batched move waves (state.py:442-452): the out leg first, both
    legs reading their brokers from the pre-wave state. The swap admission
    keeps the wave's rows on disjoint brokers and partitions, so the two
    replica sets are disjoint and each leg's sources are untouched by the
    other leg. The Neumaier residuals follow the reference's program: leg
    by leg (the second leg ``chained``) in a program of its own or the
    per-goal pass loop, and with ``fold_legs`` as the chunked pass loop
    folds the two legs into one update (``swap_residual_inputs``)."""
    return apply_swaps_lanes([env], [st], r_out[None], r_in[None], mask[None],
                             fold_legs)[0]


def apply_swaps_lanes(envs: list, sts: list, r_out: torch.Tensor, r_in: torch.Tensor,
                      mask: torch.Tensor, fold_legs: bool = False) -> list:
    """``apply_swaps_batched`` of La lanes (``r_out`` / ``r_in`` / ``mask``
    [La, W]): each leg one ``apply_moves_lanes`` for every lane, and with
    ``fold_legs`` one residual segment sum for every lane, each lane's rows
    in its solo order (``swap_residual_inputs``). Returns the new states."""
    La = len(envs)
    b_out = torch.stack([sts[j].replica_broker[r_out[j]] for j in range(La)])
    b_in = torch.stack([sts[j].replica_broker[r_in[j]] for j in range(La)])
    sts1 = apply_moves_lanes(envs, sts, r_out, b_in, mask)
    sts2 = apply_moves_lanes(envs, sts1, r_in, b_out, mask, chained=True)
    if not fold_legs:
        return sts2
    parts = []
    for j in range(La):
        v1, s1, _ = apply_sum_inputs(envs[j], sts[j], r_out[j], b_in[j], mask[j])
        v2, s2, _ = apply_sum_inputs(envs[j], sts1[j], r_in[j], b_out[j], mask[j])
        parts.append(swap_residual_inputs(sts[j], sts1[j], sts2[j], v1, s1, v2, s2))
    B = envs[0].num_brokers
    vals, seg, init = _fold(parts, B)
    res = segment_sum(vals, seg, La * B, init).view(La, B, -1)
    return [dataclasses.replace(sts2[j], util_residual=res[j, :, 0:4].contiguous(),
                                leader_util_residual=res[j, :, 4:8].contiguous())
            for j in range(La)]


def swap_residual_inputs(st: EngineState, st1: EngineState, st2: EngineState,
                         v1: torch.Tensor, s1: torch.Tensor, v2: torch.Tensor,
                         s2: torch.Tensor):
    """(values f32[4W, 8], seg, init f32[B, 8]) of a swap wave's residual
    update as the reference's chunked pass loop folds its two
    ``_kahan_scatter2`` calls (read off its XLA:CPU program,
    ``_compiled_goal_chunk(...).lower(...).compile().as_text()``): one init ``(res + (acc - new1)) +
    (new1 - new2)``, then every source delta of both legs (leg 2's, then
    leg 1's) and then every destination delta (leg 1's, then leg 2's), each
    broker's in row order. The admission puts a broker in one role of one
    row, so a broker leaving in leg 1 adds its leg-1 delta before its leg-2
    one and a broker receiving in leg 1 the other way round. ``st``, ``st1``
    and ``st2`` are the states before, between and after the legs; ``v`` /
    ``s`` each leg's ``apply_sum_inputs`` rows (sources, then destinations)."""
    W = v1.shape[0] // 2
    cat = torch.cat
    acc = cat([st.util, st.leader_util], dim=1)
    new1 = cat([st1.util, st1.leader_util], dim=1)
    new2 = cat([st2.util, st2.leader_util], dim=1)
    res = cat([st.util_residual, st.leader_util_residual], dim=1)
    init = (res + (acc - new1)) + (new1 - new2)
    vals = cat([v2[:W, :8], v1[:W, :8], v1[W:, :8], v2[W:, :8]])
    seg = cat([s2[:W], s1[:W], s1[W:], s2[W:]])
    return vals.contiguous(), seg, init.contiguous()


def apply_lead_sum_inputs(env: ClusterEnv, st: EngineState, src: torch.Tensor,
                          dst: torch.Tensor, mask: torch.Tensor):
    """(values f32[2W, 8], seg i64[2W], init f32[B, 8]) of one leadership
    wave's chained per-broker float update: every source row (in row order),
    then every destination row; columns util[4] (the leader - follower
    shift) and leader_util[4]."""
    bs = st.replica_broker[src]
    bd = st.replica_broker[dst]
    delta_s = env.leader_load[src] - env.follower_load[src]
    delta_d = env.leader_load[dst] - env.follower_load[dst]
    rows_s = torch.cat([-delta_s, -env.leader_load[src]], dim=1)
    rows_d = torch.cat([delta_d, env.leader_load[dst]], dim=1)
    vals = torch.cat([rows_s, rows_d]).contiguous()
    none = torch.full_like(bs, -1)
    seg = torch.cat([torch.where(mask, bs, none), torch.where(mask, bd, none)])
    init = torch.cat([st.util, st.leader_util], dim=1).contiguous()
    return vals, seg, init


def apply_lead_count_inputs(env: ClusterEnv, st: EngineState, src: torch.Tensor,
                            dst: torch.Tensor, mask: torch.Tensor):
    """The ``segment_count`` arguments (seg, nseg, weights, init) of one
    leadership wave's leader_count and topic_leader_count updates: -1 at
    every enabled source row's broker, +1 at its destination's."""
    B, T = env.num_brokers, env.num_topics
    bs = st.replica_broker[src]
    bd = st.replica_broker[dst]
    one = mask.to(torch.int32)
    w = torch.cat([-one, one])
    t = env.replica_topic[src]
    return ((torch.cat([bs, bd]), B, w, st.leader_count),
            (torch.cat([t * B + bs, t * B + bd]), T * B, w,
             st.topic_leader_count.reshape(-1)))


def apply_leaderships_batched(env: ClusterEnv, st: EngineState, src: torch.Tensor,
                              dst: torch.Tensor, mask: torch.Tensor) -> EngineState:
    """Apply a WAVE of leadership transfers ``src[W] -> dst[W]`` (same
    partition per row, distinct partitions across enabled rows) where
    ``mask[W]``. Float tallies follow the reference's chained
    ``.at[src].add(-x).at[dst].add(y)`` order with the Neumaier residual of
    ``_kahan_scatter2`` (``residual_inputs``); masked rows add nothing
    (segment -1); the leader
    flags clear at the sources and set at the destinations (OR-style, so a
    masked row never writes)."""
    return apply_leaderships_lanes([env], [st], src[None], dst[None], mask[None])[0]


def apply_leaderships_lanes(envs: list, sts: list, src: torch.Tensor, dst: torch.Tensor,
                            mask: torch.Tensor) -> list:
    """``apply_leaderships_batched`` of La lanes (``src`` / ``dst`` /
    ``mask`` [La, W]) with the K4/K5 launches shared: every segment sum and
    count folds the lane into its segment ids, each lane's rows contiguous
    and in their solo order, so every f32 sum keeps its order. Returns the
    lanes' new states."""
    La = len(envs)
    env0 = envs[0]
    B, T, R = env0.num_brokers, env0.num_topics, env0.num_replicas
    ins = [apply_lead_sum_inputs(envs[j], sts[j], src[j], dst[j], mask[j])
           for j in range(La)]
    vals, seg, init = _fold(ins, B)
    out = segment_sum(vals, seg, La * B, init).view(La, B, -1)
    res_in = [residual_inputs(sts[j], out[j, :, 0:4], out[j, :, 4:8], ins[j][0],
                              ins[j][1]) for j in range(La)]
    rvals, rseg, rinit = _fold(res_in, B)
    res = segment_sum(rvals, rseg, La * B, rinit).view(La, B, -1)
    counts = [apply_lead_count_inputs(envs[j], sts[j], src[j], dst[j], mask[j])
              for j in range(La)]
    tallies = []
    for kind in range(2):
        per = [counts[j][kind] for j in range(La)]
        nseg = per[0][1]
        if La == 1:
            tallies.append(segment_count(*per[0]).view(1, nseg))
            continue
        segs = torch.cat([a[0] + j * nseg for j, a in enumerate(per)])
        tallies.append(segment_count(segs, La * nseg, torch.cat([a[2] for a in per]),
                                     torch.cat([a[3] for a in per])).view(La, nseg))
    one = mask.to(torch.int32).reshape(-1)
    lane_off = (torch.arange(La, device=src.device) * R)[:, None]
    zeros = torch.zeros(La * R, dtype=torch.int32, device=src.device)
    cleared = (zeros.index_add(0, (src + lane_off).reshape(-1), one) > 0).view(La, R)
    granted = (zeros.index_add(0, (dst + lane_off).reshape(-1), one) > 0).view(La, R)
    return [dataclasses.replace(
        sts[j],
        replica_is_leader=(sts[j].replica_is_leader & ~cleared[j]) | granted[j],
        util=out[j, :, 0:4].contiguous(), leader_util=out[j, :, 4:8].contiguous(),
        leader_count=tallies[0][j].contiguous(),
        topic_leader_count=tallies[1][j].reshape(T, B),
        leadership_moved=sts[j].leadership_moved | cleared[j] | granted[j],
        util_residual=res[j, :, 0:4].contiguous(),
        leader_util_residual=res[j, :, 4:8].contiguous())
        for j in range(La)]


# ---------------------------------------------------------------------------
# Single actions (state.py:26, :190-457): the sequential fallbacks' applies
# ---------------------------------------------------------------------------
def state_index_dtypes(env: ClusterEnv):
    """(broker_dt, disk_dt, count_dt) of this env's engine state
    (state.py:26). The port keeps no compact tables (see ``env``): index
    columns are int64, counts int32, whatever the env."""
    return torch.int64, torch.int64, torch.int32


def _pair_rows(acc: torch.Tensor, a, d_a, b, d_b) -> torch.Tensor:
    """``acc.at[a].add(d_a).at[b].add(d_b)`` for one row index each: row a
    first, then row b (the same row twice adds twice, in that order)."""
    new = acc.clone()
    new[a] = new[a] + d_a
    new[b] = new[b] + d_b
    return new


def _kahan_pair(acc: torch.Tensor, res: torch.Tensor, a, d_a, b, d_b):
    """``_kahan_scatter2`` of one action (state.py:83) as the reference's
    loop programs evaluate it (``residual_inputs``): the accumulator
    chained row a then row b; the residual ``res + (acc - new)``, then the
    two deltas added in that order."""
    new = _pair_rows(acc, a, d_a, b, d_b)
    return new, _pair_rows(res + (acc - new), a, d_a, b, d_b)


def _gate(en: torch.Tensor, new: EngineState, old: EngineState) -> EngineState:
    """``new`` where ``en``, else ``old`` field by field, so a disabled
    action leaves every bit of the state as it was (a masked +0.0 would
    turn a -0.0 tally into +0.0)."""
    return EngineState(**{f.name: torch.where(en, getattr(new, f.name), getattr(old, f.name))
                          for f in dataclasses.fields(EngineState)})


def apply_move(env: ClusterEnv, st: EngineState, replica, dst,
               enabled=True) -> EngineState:
    """Relocate ``replica`` to broker ``dst`` (state.py:190) with the
    reference's bookkeeping, in plain torch on the device: no float atomics,
    no read back to the host. The destination logdir is the alive one with
    the most free space (first maximum). ``enabled`` (bool or 0-d bool
    tensor) masks the whole update: disabled, the state is unchanged bit for
    bit."""
    dev = st.replica_broker.device
    en = torch.as_tensor(enabled, dtype=torch.bool, device=dev)
    replica = torch.as_tensor(replica, dtype=torch.int64, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.int64, device=dev)
    src = st.replica_broker[replica]
    is_leader = st.replica_is_leader[replica]
    zero = torch.zeros_like(env.leader_load[replica])
    load = torch.where(en, torch.where(is_leader, env.leader_load[replica],
                                       env.follower_load[replica]), zero)
    util, util_res = _kahan_pair(st.util, st.util_residual, src, -load, dst, load)
    lead_load = torch.where(en & is_leader, env.leader_load[replica], zero)
    leader_util, lead_res = _kahan_pair(st.leader_util, st.leader_util_residual,
                                        src, -lead_load, dst, lead_load)
    pot_delta = torch.where(en, env.leader_load[replica, Resource.NW_OUT], zero[0])
    pot = _pair_rows(st.potential_nw_out, src, -pot_delta, dst, pot_delta)
    one = en.to(torch.int32)
    lone = (en & is_leader).to(torch.int32)
    rc = _pair_rows(st.replica_count, src, -one, dst, one)
    lc = _pair_rows(st.leader_count, src, -lone, dst, lone)
    p = env.replica_partition[replica]
    prc = _pair_rows(st.part_rack_count, (p, env.broker_rack[src]), -one,
                     (p, env.broker_rack[dst]), one)
    t = env.replica_topic[replica]
    tbc = _pair_rows(st.topic_broker_count, (t, src), -one, (t, dst), one)
    tlc = _pair_rows(st.topic_leader_count, (t, src), -lone, (t, dst), lone)
    free = torch.where(env.broker_disk_alive[dst],
                       env.broker_disk_capacity[dst] - st.disk_util[dst],
                       torch.full_like(st.disk_util[dst], -torch.inf))
    dst_disk = torch.argmax(free)
    src_disk = st.replica_disk[replica]
    disk_load = load[Resource.DISK]
    du = _pair_rows(st.disk_util, (src, src_disk), -disk_load, (dst, dst_disk), disk_load)

    def put(col, v):
        out = col.clone()
        out[replica] = v
        return out

    new = dataclasses.replace(
        st, replica_broker=put(st.replica_broker, dst),
        replica_offline=put(st.replica_offline, False), replica_disk=put(st.replica_disk,
                                                                         dst_disk),
        util=util, leader_util=leader_util, potential_nw_out=pot, replica_count=rc,
        leader_count=lc, part_rack_count=prc, topic_broker_count=tbc,
        topic_leader_count=tlc, disk_util=du, util_residual=util_res,
        leader_util_residual=lead_res, moved=put(st.moved, True))
    return _gate(en, new, st)


def apply_leadership(env: ClusterEnv, st: EngineState, src_replica, dst_replica,
                     enabled=True) -> EngineState:
    """Transfer leadership ``src_replica -> dst_replica`` (same partition;
    state.py:255) in plain torch on the device. ``enabled`` masks the update
    to a no-op that leaves the state unchanged bit for bit."""
    dev = st.replica_broker.device
    en = torch.as_tensor(enabled, dtype=torch.bool, device=dev)
    s = torch.as_tensor(src_replica, dtype=torch.int64, device=dev)
    d = torch.as_tensor(dst_replica, dtype=torch.int64, device=dev)
    enf = en.to(st.util.dtype)
    bs = st.replica_broker[s]
    bd = st.replica_broker[d]
    delta_s = (env.leader_load[s] - env.follower_load[s]) * enf
    delta_d = (env.leader_load[d] - env.follower_load[d]) * enf
    util, util_res = _kahan_pair(st.util, st.util_residual, bs, -delta_s, bd, delta_d)
    leader_util, lead_res = _kahan_pair(st.leader_util, st.leader_util_residual,
                                        bs, -env.leader_load[s] * enf,
                                        bd, env.leader_load[d] * enf)
    one = en.to(torch.int32)
    lc = _pair_rows(st.leader_count, bs, -one, bd, one)
    t = env.replica_topic[s]
    tlc = _pair_rows(st.topic_leader_count, (t, bs), -one, (t, bd), one)
    lead = st.replica_is_leader.clone()
    lead[s] = lead[s] & ~en
    lead[d] = lead[d] | en
    lmoved = st.leadership_moved.clone()
    lmoved[s] = lmoved[s] | en
    lmoved[d] = lmoved[d] | en
    new = dataclasses.replace(st, replica_is_leader=lead, util=util,
                              leader_util=leader_util, leader_count=lc,
                              topic_leader_count=tlc, util_residual=util_res,
                              leader_util_residual=lead_res, leadership_moved=lmoved)
    return _gate(en, new, st)


def apply_swap(env: ClusterEnv, st: EngineState, replica_a, replica_b,
               enabled=True) -> EngineState:
    """Exchange the brokers of two replicas (state.py:432): two
    ``apply_move``s, both brokers read before the first."""
    b_a = st.replica_broker[replica_a]
    b_b = st.replica_broker[replica_b]
    st = apply_move(env, st, replica_a, b_b, enabled)
    return apply_move(env, st, replica_b, b_a, enabled)


def no_op_move(st: EngineState) -> EngineState:
    """state.py:455: the state itself."""
    return st
