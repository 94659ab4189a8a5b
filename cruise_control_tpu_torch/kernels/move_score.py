"""K2 ``move_score_classes``: the [K, B] move-wave score fusion with its
per-destination-class best.

Replaces ``cruise_control_tpu/analyzer/engine.py`` ``_move_wave`` /
``_score_class_rows`` (:767-792) with ``_rooms_move_mask`` (:693),
``goals/base.py`` ``legit_move_mask`` (:369), ``RackAwareGoal.accept_move``
(rack.py:72), ``RackAwareDistributionGoal.accept_move`` (rack.py:144),
``TopicReplicaDistributionGoal.accept_move`` (topic.py:120) and the active
goal's ``move_score``. For every (candidate k, destination b) it evaluates
legitimacy (allowed destination, new-broker rule, not self, no sibling
replica on b), the chain's combined destination rooms, the rack-limit veto
when a rack goal is a previous goal (``others + 1 <= rack_lim[k]``, where
``others`` counts the row partition's replicas in b's rack other than the
row itself; RackAwareGoal's limit is 1, RackAwareDistributionGoal's
ceil(RF / racks), a chain holding both takes the minimum), the topic veto when
TopicReplicaDistributionGoal is one (``tab[t, b] + 1 <= up[k]``; its
source leg folds into ``row_ok``), and the active goal's score; then it
reduces each row to the best value and its lowest strided index ``q`` in
every class ``b % T`` (``jnp.argmax``'s first-max rule). With a column
order ``order_b`` (the segment-parallel finisher's broker coloring,
``_segment_move_wave`` :1504-1522) ordered column j holds broker
``order_b[j]`` (pad columns ``>= B`` score ``-inf``) and the classes
are ``j % T`` over the ordered columns; ``T = 1`` is the exhaustive move
scan's plain row argmax (``_exhaustive_move_scan`` :1302-1317).

Goal families (``GOAL_*``): the goal precomputes its [B]-level columns
(``col_f`` f32[4, B]) and per-row values (``row_f`` f32[K, 4]) with the
reference's own arithmetic; the kernel does only the [K, B] part.

The per-goal veto form (``chain_cache=False``: ``_score_class_rows`` with
the previous goals' own ``accept_move`` masks, engine.py :754-765): with
``dst_lhs`` f32[8, B] given, ``dst_room`` holds each constrained dim's
bound and the column test is the goals' expression ``lhs[b] + d[k, c] <=
bound[b]`` (add, then compare) rather than the folded room ``d[k, c] <=
bound[b] - lhs[b]``, which can differ by one ulp at a band edge; its
launches count on ``move_score_terms`` (``move_score_terms_lanes``).

``move_score_classes_lanes`` is the fleet's lane form (K14): the solo
arguments of La lanes, stacked into [La, ...] tensors, in ONE launch (grid
dimension y = lane); each lane's result is its solo launch's. Its twin
loops the solo twin over the lanes.

CUDA kernel (``csrc/move_score.cu``): one CTA per candidate row, threads
over B, scores staged in shared memory, one thread per class for the
reduction. Bound: bytes (the [B]-level tables are read once per row from
L2; the work is a few dozen operations per (k, b)).
"""
from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, library, ptr, register, stack_lanes, stream_ptr,
)

KERNEL = register("move_score_classes",
                  "cruise_control_tpu_torch/kernels/csrc/move_score.cu",
                  "cruise_control_tpu/analyzer/engine.py:767")

KERNEL_LANES = register("move_score_classes_lanes",
                        "cruise_control_tpu_torch/kernels/csrc/move_score.cu",
                        "cruise_control_tpu/analyzer/optimizer.py:2563")
KERNEL_TERMS = register("move_score_terms",
                        "cruise_control_tpu_torch/kernels/csrc/move_score.cu",
                        "cruise_control_tpu/analyzer/engine.py:754")
KERNEL_TERMS_LANES = register("move_score_terms_lanes",
                              "cruise_control_tpu_torch/kernels/csrc/move_score.cu",
                              "cruise_control_tpu/analyzer/engine.py:754")

GOAL_RACK = 0              # RackAwareGoal
GOAL_CAPACITY = 1          # CapacityGoal (Disk / NetworkInbound / ...)
GOAL_REPLICA_CAPACITY = 2  # ReplicaCapacityGoal
GOAL_REPLICA_DIST = 3      # ReplicaDistributionGoal
GOAL_MIN_TOPIC = 4         # MinTopicLeadersPerBrokerGoal
GOAL_LEADER_DIST = 5       # LeaderReplicaDistributionGoal
GOAL_RESOURCE_DIST = 6     # ResourceDistributionGoal (the four usage goals)
GOAL_TOPIC_REPLICA = 7     # TopicReplicaDistributionGoal
GOAL_RACK_DIST = 8         # RackAwareDistributionGoal
RACK_FAMILIES = (GOAL_RACK, GOAL_RACK_DIST)
WAVE_DIMS = 8
EXEMPT_MASK = 1 << 5       # WAVE_LEADER_COUNT: zero-delta rows pass its rooms
MAX_F = 64
MAX_SMEM = 48 * 1024
# launches by goal family since the last ``kernels.reset_launches()``
FAMILY_LAUNCHES: dict[int, int] = {}


def _violation(u, lower, upper):
    return torch.clamp(u - upper, min=0.0) + torch.clamp(lower - u, min=0.0)


def goal_score_plain(goal_kind, others, row_f, col_f, K, B, topic=None):
    """f32[K, B] the family's score from its tables (no legitimacy)."""
    neg = torch.full((K, B), -torch.inf, dtype=torch.float32, device=row_f.device)
    if goal_kind == GOAL_RACK:
        ok = (others == 0) & (row_f[:, 0] != 0)[:, None]
        return torch.where(ok, col_f[0][None, :].expand(K, B), neg)
    if goal_kind == GOAL_RACK_DIST:
        # row_f[:, 0] = was violating or offline, row_f[:, 1] = the rack limit
        ok = ((others + 1).to(torch.float32) <= row_f[:, 1:2]) & (row_f[:, 0] != 0)[:, None]
        return torch.where(ok, col_f[0][None, :].expand(K, B), neg)
    if goal_kind == GOAL_CAPACITY:
        l = row_f[:, 0:1]
        feasible = (col_f[0][None, :] + l) <= col_f[1][None, :]
        s = torch.where((row_f[:, 1] != 0)[:, None], col_f[3][None, :].expand(K, B),
                        l + col_f[2][None, :])
        return torch.where(feasible, s, neg)
    if goal_kind == GOAL_REPLICA_CAPACITY:
        return torch.where((col_f[0] != 0)[None, :], col_f[1][None, :].expand(K, B),
                           neg)
    if goal_kind == GOAL_REPLICA_DIST:
        c_s, lo_s, up_s = row_f[:, 0], row_f[:, 1], row_f[:, 2]
        c_d, lo_d, up_d = col_f[0], col_f[1], col_f[2]
        vso = _violation(c_s, lo_s, up_s)
        vsn = _violation(c_s - 1.0, lo_s, up_s)
        vdo = _violation(c_d, lo_d, up_d)
        vdn = _violation(c_d + 1.0, lo_d, up_d)
        gain = (vso - vsn)[:, None] + (vdo - vdn)[None, :]
        feasible = (vsn <= vso)[:, None] & (vdn <= vdo)[None, :]
        s = torch.where(feasible & (gain > 0), gain, neg)
        return torch.where((row_f[:, 3] != 0)[:, None], col_f[3][None, :].expand(K, B), s)
    if goal_kind == GOAL_MIN_TOPIC:
        row_t, tab = topic
        c = tab.reshape(-1, B)[row_t].to(torch.float32)
        need = torch.where((row_f[:, 1] != 0)[:, None], col_f[0][None, :].expand(K, B),
                           torch.zeros_like(c))
        gain = torch.clamp(torch.clamp(need - c, min=0.0), max=1.0)
        s = torch.where(gain > 0, gain, neg)
        return torch.where((row_f[:, 0] != 0)[:, None], torch.ones_like(s), s)
    if goal_kind == GOAL_LEADER_DIST:
        c_s, lo_s, up_s = row_f[:, 0], row_f[:, 1], row_f[:, 2]
        c_d, lo_d, up_d = col_f[0], col_f[1], col_f[2]
        vso = _violation(c_s, lo_s, up_s)
        vsn = _violation(c_s - 1.0, lo_s, up_s)
        vdo = _violation(c_d, lo_d, up_d)
        vdn = _violation(c_d + 1.0, lo_d, up_d)
        gain = (vso - vsn)[:, None] + (vdo - vdn)[None, :]
        feasible = (vsn <= vso)[:, None] & (vdn <= vdo)[None, :]
        return torch.where(feasible & (gain > 0), gain * 0.9, neg)
    if goal_kind == GOAL_RESOURCE_DIST:
        vso, vsn, l = row_f[:, 0:1], row_f[:, 1:2], row_f[:, 2:3]
        u, lo, up, cap = col_f[0][None, :], col_f[1][None, :], col_f[2][None, :], col_f[3][None, :]
        vdo = _violation(u, lo, up)
        vdn = _violation(u + l, lo, up)
        gain = (vso - vsn) + (vdo - vdn)
        feasible = (vsn <= vso) & (vdn <= vdo)
        heal = 1.0 + torch.clamp((up - u) - l, min=0.0) / cap
        s = torch.where(feasible & (gain > 0), gain, neg)
        return torch.where((row_f[:, 3] != 0)[:, None], heal, s)
    if goal_kind == GOAL_TOPIC_REPLICA:
        row_t, tab = topic
        c = tab.reshape(-1, B)[row_t].to(torch.float32)
        lo, up, exr = row_f[:, 0:1], row_f[:, 1:2], row_f[:, 2:3]
        deficit = torch.clamp(torch.clamp(lo - c, min=0.0), max=1.0)
        new_excess = torch.clamp((c + 1.0) - up, min=0.0)
        gain = exr + deficit
        s = torch.where((new_excess <= 0.0) & (gain > 0), gain, neg)
        heal = 1.0 + torch.clamp((up - c) - 1.0, min=0.0) / (up + 1.0)
        return torch.where((row_f[:, 3] != 0)[:, None], heal, s)
    raise ValueError(f"unknown goal kind {goal_kind}")


def rack_others(prow, cur_b, broker_rack):
    """i64[K, B]: replicas of each row's partition in b's rack, the row
    itself not counted when b shares its current rack."""
    K, B = cur_b.shape[0], broker_rack.shape[0]
    cur_rack = broker_rack[cur_b]
    return (prow.gather(1, broker_rack[None, :].expand(K, B))
            - (broker_rack[None, :] == cur_rack[:, None]).to(prow.dtype))


def move_score_classes_plain(goal_kind, T, cur_b, orig_b, sib_b, row_ok, d_rows,
                             dst_room, room_mask, prow, rack_lim, row_f, col_f,
                             dst_ok, new_ok, broker_rack, order_b=None, topic=None,
                             tveto=None, dst_lhs=None):
    K, B = cur_b.shape[0], dst_ok.shape[0]
    bidx = torch.arange(B, device=cur_b.device)
    ok = (dst_ok[None, :] & (new_ok[None, :] | (bidx[None, :] == orig_b[:, None]))
          & (bidx[None, :] != cur_b[:, None]))
    ok = ok & ~(sib_b[:, :, None] == bidx[None, None, :]).any(dim=1)
    for c in range(WAVE_DIMS):
        if room_mask >> c & 1:
            if dst_lhs is None:
                okc = d_rows[:, c:c + 1] <= dst_room[c][None, :]
            else:
                okc = (dst_lhs[c][None, :] + d_rows[:, c:c + 1]) <= dst_room[c][None, :]
            if EXEMPT_MASK >> c & 1:
                okc = okc | (d_rows[:, c] == 0)[:, None]
            ok = ok & okc
    if tveto is not None:
        row_t, vtab, vup = tveto
        ok = ok & ((vtab.reshape(-1, B)[row_t].to(torch.float32) + 1.0) <= vup[:, None])
    others = None
    if prow is not None:
        others = rack_others(prow, cur_b, broker_rack)
        if rack_lim is not None:
            ok = ok & (others + 1 <= rack_lim[:, None])
    score = goal_score_plain(goal_kind, others, row_f, col_f, K, B, topic)
    sc = torch.where(ok & row_ok[:, None], score,
                     torch.full_like(score, -torch.inf))
    Bq = -(-B // T) if order_b is None else order_b.shape[0] // T
    if Bq * T > B:
        sc = torch.cat([sc, torch.full((K, Bq * T - B), -torch.inf,
                                       device=sc.device)], dim=1)
    if order_b is not None:
        sc = sc[:, order_b]
    sv = sc.reshape(K, Bq, T)
    best = sv.max(dim=1).values
    qs = torch.arange(Bq, device=sc.device)[None, :, None]
    q = torch.where(sv == best[:, None, :], qs, Bq).min(dim=1).values
    return best, q


_SIGNATURES = {"cc_move_score_classes": [I] * 9 + [P] * 22,
               "cc_move_score_classes_lanes": [I] * 10 + [ctypes.c_longlong] * 2
               + [P] * 22}


# dtypes of the launch's tensor operands, in their C order
_DTYPES = (torch.int64, torch.int64, torch.int64, torch.bool, torch.float32, torch.float32,
           torch.float32, torch.int64, torch.int32, torch.float32, torch.float32,
           torch.bool, torch.bool, torch.int64, torch.int64, torch.int64, torch.int32,
           torch.int32, torch.float32)


def move_score_classes(goal_kind: int, T: int, cur_b, orig_b, sib_b, row_ok,
                       d_rows, dst_room, room_mask: int, prow, rack_lim,
                       row_f, col_f, dst_ok, new_ok, broker_rack, order_b=None,
                       topic=None, tveto=None, dst_lhs=None):
    """(cls_val f32[K, T], cls_q i64[K, T]): per row, the best score and its
    lowest strided index q over each destination class ``b % T`` (or, with
    ``order_b`` i64[Bp], over each class ``j % T`` of the ordered columns).
    ``topic`` = (row_t i64[K], table i32[T, B]) for GOAL_MIN_TOPIC and
    GOAL_TOPIC_REPLICA; ``tveto`` = (row_t, table i32[T, B], up f32[K]) the
    topic veto's destination leg.

    Row inputs [K]: ``cur_b``/``orig_b`` i64 (current / original broker),
    ``sib_b`` i64[K, F] (brokers of the other replicas of the row's
    partition, -1 padded), ``row_ok`` bool (replica-level legitimacy, kv >
    -inf and the source-side rooms), ``d_rows`` f32[K, 8] (wave deltas),
    ``prow`` i64[K, racks] (the row partition's per-rack replica counts; for
    the rack families or the rack-limit veto, else None), ``rack_lim``
    i32[K] (the rack-limit veto's per-row limit, None: no veto), ``row_f``
    f32[K, 4]. Broker inputs [B]:
    ``dst_room`` f32[8, B] (combined destination rooms; dims in
    ``room_mask``), ``col_f`` f32[4, B], ``dst_ok``/``new_ok`` bool,
    ``broker_rack`` i64. ``dst_lhs`` f32[8, B]: the per-goal veto form's
    left-hand columns (``dst_room`` then holds the bounds); None: rooms."""
    if not cur_b.is_cuda:
        return move_score_classes_plain(goal_kind, T, cur_b, orig_b, sib_b, row_ok,
                                        d_rows, dst_room, room_mask, prow,
                                        rack_lim, row_f, col_f, dst_ok, new_ok,
                                        broker_rack, order_b, topic, tveto, dst_lhs)
    K, F = sib_b.shape
    B = dst_ok.shape[0]
    Bp = -(-B // T) * T if order_b is None else order_b.shape[0]
    if (F > MAX_F or Bp * 4 > MAX_SMEM or not 0 < T <= 1024 or Bp % T
            or Bp < B):
        raise ValueError(f"move_score_classes: unsupported F={F}, B={B}, T={T}, "
                         f"Bp={Bp}")
    if (goal_kind in RACK_FAMILIES or rack_lim is not None) and prow is None:
        raise ValueError("the rack families and the rack-limit veto need prow")
    if rack_lim is not None and rack_lim.shape != (K,):
        raise ValueError("move_score_classes: rack_lim is one limit per row")
    if goal_kind in (GOAL_MIN_TOPIC, GOAL_TOPIC_REPLICA) and topic is None:
        raise ValueError("the topic families need their topic table")
    row_t, tab = topic if topic is not None else (None, None)
    vtab = vup = None
    if tveto is not None:
        vrow_t, vtab, vup = tveto
        row_t = vrow_t if row_t is None else row_t   # both are the rows' topics
    tensors = [cur_b, orig_b, sib_b, row_ok, d_rows, dst_room, dst_lhs, prow, rack_lim,
               row_f, col_f, dst_ok, new_ok, broker_rack, order_b, row_t, tab, vtab, vup]
    for t, dt in zip(tensors, _DTYPES):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError("move_score_classes: wrong dtype, layout or device")
    Kr = prow.shape[1] if prow is not None else 0
    cls_val = torch.empty((K, T), dtype=torch.float32, device=cur_b.device)
    cls_q = torch.empty((K, T), dtype=torch.int64, device=cur_b.device)
    err = library("move_score", _SIGNATURES).cc_move_score_classes(
        K, B, T, F, Kr, int(goal_kind), int(room_mask), EXEMPT_MASK, Bp,
        *(ptr(t) for t in tensors), ptr(cls_val), ptr(cls_q), stream_ptr())
    check(err, "move_score_classes")
    (KERNEL if dst_lhs is None else KERNEL_TERMS).count(
        "ordered" if order_b is not None else f"T={T}")
    FAMILY_LAUNCHES[goal_kind] = FAMILY_LAUNCHES.get(goal_kind, 0) + 1
    return cls_val, cls_q


def move_score_classes_lanes_plain(lane_args: list):
    outs = [move_score_classes_plain(*a) for a in lane_args]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def move_score_classes_lanes(lane_args: list):
    """(cls_val f32[La, K, T], cls_q i64[La, K, T]): ``move_score_classes``
    of each lane's positional argument tuple in ``lane_args``. The integer
    arguments (goal family, T, room mask) must agree across the lanes."""
    head = lane_args[0]
    goal_kind, T, room_mask = head[0], head[1], head[8]
    for a in lane_args[1:]:
        if (a[0], a[1], a[8]) != (goal_kind, T, room_mask):
            raise ValueError("move_score_classes_lanes: lanes disagree on the "
                             "family, T or room mask")
    if not head[2].is_cuda:
        return move_score_classes_lanes_plain(lane_args)
    La = len(lane_args)
    (cur_b, orig_b, sib_b, row_ok, d_rows, dst_room, prow, rack_lim, row_f, col_f,
     dst_ok, new_ok, broker_rack, order_b, topic, tveto, dst_lhs) = (
        stack_lanes([a[i] if i < len(a) else None for a in lane_args],
                    "move_score_classes_lanes")
        for i in (2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19))
    _La, K, F = sib_b.shape
    B = dst_ok.shape[1]
    Bp = -(-B // T) * T if order_b is None else order_b.shape[1]
    if (F > MAX_F or Bp * 4 > MAX_SMEM or not 0 < T <= 1024 or Bp % T
            or Bp < B):
        raise ValueError(f"move_score_classes_lanes: unsupported F={F}, B={B}, "
                         f"T={T}, Bp={Bp}")
    if (goal_kind in RACK_FAMILIES or rack_lim is not None) and prow is None:
        raise ValueError("the rack families and the rack-limit veto need prow")
    if goal_kind in (GOAL_MIN_TOPIC, GOAL_TOPIC_REPLICA) and topic is None:
        raise ValueError("the topic families need their topic table")
    row_t, tab = topic if topic is not None else (None, None)
    vtab = vup = None
    if tveto is not None:
        vrow_t, vtab, vup = tveto
        row_t = vrow_t if row_t is None else row_t
    tensors = [cur_b, orig_b, sib_b, row_ok, d_rows, dst_room, dst_lhs, prow, rack_lim,
               row_f, col_f, dst_ok, new_ok, broker_rack, order_b, row_t, tab, vtab, vup]
    for t, dt in zip(tensors, _DTYPES):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError("move_score_classes_lanes: wrong dtype, layout or device")
    Kr = prow.shape[2] if prow is not None else 0
    tab_n = tab[0].numel() if tab is not None else 0
    vtab_n = vtab[0].numel() if vtab is not None else 0
    cls_val = torch.empty((La, K, T), dtype=torch.float32, device=cur_b.device)
    cls_q = torch.empty((La, K, T), dtype=torch.int64, device=cur_b.device)
    err = library("move_score", _SIGNATURES).cc_move_score_classes_lanes(
        La, K, B, T, F, Kr, int(goal_kind), int(room_mask), EXEMPT_MASK, Bp, tab_n,
        vtab_n, *(ptr(t) for t in tensors), ptr(cls_val), ptr(cls_q), stream_ptr())
    check(err, "move_score_classes_lanes")
    (KERNEL_LANES if dst_lhs is None else KERNEL_TERMS_LANES).count(f"L={La} T={T}")
    FAMILY_LAUNCHES[goal_kind] = FAMILY_LAUNCHES.get(goal_kind, 0) + 1
    return cls_val, cls_q
