"""K3 ``wave_admission``: budgeted admission of one score-sorted wave of
moves or leadership transfers.

Replaces ``cruise_control_tpu/analyzer/engine.py`` ``_wave_admission``
(:555), ``_group_cumsum`` (:648), the partition first-touch of
``_move_wave`` (:846-851) and the one-row-per-candidate and partition
first-touch of the segment waves (:1552-1557, :1639-1640). In score order
a row is admitted iff it is the first wave row of its candidate (segment
waves) and of its partition (move waves), its per-(topic, broker)
cumulative count deltas stay within every chain goal's per-topic slack, its
per-source and per-destination cumulative deltas (rank-0 rows exempt) stay
within the chain's combined slack (+1e-4), and the active goal still has
gain budget at one endpoint (or the row escapes the cap, e.g. offline
healing). Leadership waves pass their own source and destination deltas
(``d_dst``): the destination gains the other replica's loads.

``_group_cumsum`` takes a GLOBAL inclusive cumsum in stable group order and
subtracts the prefix before each group start. The CPU oracle's XLA lowers
``jnp.cumsum`` through its reduce-window rewriter: rows in blocks of 16,
each block scanned left to right, the block totals scanned the same way
(recursively), and the exclusive block prefix added back. ``xla_cumsum``
reproduces that order exactly, so the sums match the oracle bit for bit.

``wave_admission_lanes`` is the fleet's lane form (K14): the solo
arguments of La lanes stacked into [La, ...] tensors, in ONE launch
sequence (grid dimension y = lane; ``side_scan`` runs one CTA per (side,
lane)); each lane's verdicts are its solo launch's. Its twin loops the solo
twin over the lanes.

CUDA kernel (``csrc/wave_admission.cu``): first-touch tables by integer
atomicMin; one CTA per side sorts (group, row) keys in shared memory (N <=
16,384), scans in the XLA order and finds group starts with a block-wide
prefix max (no walk back, so the cost does not grow with N^2); one thread
per row decides. Bound: latency (one CTA per side).
"""
from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch.kernels.build import (
    IP, I, P, check, library, ptr, register, stack_lanes, stream_ptr,
)

KERNEL = register("wave_admission",
                  "cruise_control_tpu_torch/kernels/csrc/wave_admission.cu",
                  "cruise_control_tpu/analyzer/engine.py:555")
KERNEL_LANES = register("wave_admission_lanes",
                        "cruise_control_tpu_torch/kernels/csrc/wave_admission.cu",
                        "cruise_control_tpu/analyzer/optimizer.py:2563")
MAX_K = 16384
SCAN_BASE = 16


def _seq_scan(x: torch.Tensor, exclusive: bool) -> torch.Tensor:
    """Left-to-right f32 scan over dim 0 of [n, ...] starting from +0.0."""
    acc = torch.zeros_like(x[0])
    out = torch.empty_like(x)
    for i in range(x.shape[0]):
        if exclusive:
            out[i] = acc
        acc = acc + x[i]
        if not exclusive:
            out[i] = acc
    return out


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over dim 0 of f32[n, C] in the CPU oracle's order."""
    n = x.shape[0]
    if n <= SCAN_BASE:
        return _seq_scan(x, exclusive=False)
    m = -(-n // SCAN_BASE)
    xp = torch.zeros((m * SCAN_BASE,) + tuple(x.shape[1:]), dtype=x.dtype,
                     device=x.device)
    xp[:n] = x
    blocks = xp.view((m, SCAN_BASE) + tuple(x.shape[1:])).transpose(0, 1)
    L = _seq_scan(blocks, exclusive=False).transpose(0, 1)       # [m, 16, C]
    t = L[:, SCAN_BASE - 1]
    if m <= SCAN_BASE:
        E = _seq_scan(t, exclusive=True)
    else:
        G = xla_cumsum(t)
        E = torch.cat([torch.zeros_like(G[:1]), G[:-1]])
    return (L + E[:, None]).reshape((m * SCAN_BASE,) + tuple(x.shape[1:]))[:n]


def group_cumsum(groups: torch.Tensor, d: torch.Tensor):
    """(cum f32[K, C], rank i64[K]): ``_group_cumsum`` — per-group inclusive
    prefix sums in stable group order, from one global cumsum."""
    K = groups.shape[0]
    idx = torch.arange(K, device=groups.device)
    order = torch.argsort(groups, stable=True)
    ds = d[order]
    gs = groups[order]
    cums = xla_cumsum(ds)
    is_start = torch.ones(K, dtype=torch.bool, device=groups.device)
    is_start[1:] = gs[1:] != gs[:-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    base = torch.where((start_idx > 0)[:, None],
                       cums[torch.clamp(start_idx - 1, min=0)],
                       torch.zeros_like(cums))
    cum = torch.empty_like(d)
    cum[order] = cums - base
    rank = torch.empty(K, dtype=torch.int64, device=groups.device)
    rank[order] = idx - start_idx
    return cum, rank


def _first_touch(groups, ok, n_groups):
    """bool[N]: row i is the first ``ok`` row of its group."""
    N = groups.shape[0]
    posn = torch.arange(N, device=groups.device)
    inf = N + 1
    guarded = torch.where(ok, posn, inf)
    first = torch.full((n_groups,), inf, dtype=torch.int64, device=groups.device)
    first = first.scatter_reduce(0, groups, guarded, reduce="amin")
    return first[groups] == posn


def wave_admission_plain(d, src_b, dst_b, wave_ok, part, src_slack, dst_slack,
                         gain, gain_escape, d_dst=None, kgroup=None, topic=None,
                         num_parts=None):
    K = d.shape[0]
    B = src_slack.shape[0]
    posn = torch.arange(K, device=d.device)
    ok = wave_ok
    if kgroup is not None:
        ok = ok & _first_touch(kgroup[0], ok, kgroup[1])
    part_ok = None
    if part is not None:
        n_parts = num_parts if num_parts is not None else int(part.max()) + 1
        part_ok = _first_touch(part, ok, n_parts)
    d_dst = d if d_dst is None else d_dst
    ds = torch.where(ok[:, None], d, torch.zeros_like(d))
    dd = torch.where(ok[:, None], d_dst, torch.zeros_like(d_dst))
    win = ok
    if topic is not None:
        topics, nT, tdelta, ts_slack, td_slack = topic
        tdel = torch.where(ok[:, None], tdelta, torch.zeros_like(tdelta))
        cum_s, rank_s = group_cumsum(torch.where(ok, topics * B + src_b, nT * B + posn),
                                     tdel)
        cum_d, rank_d = group_cumsum(torch.where(ok, topics * B + dst_b, nT * B + posn),
                                     tdel)
        free = tdel == 0
        win = win & ((free | (rank_s == 0)[:, None] | (cum_s <= ts_slack + 1e-4))
                     & (free | (rank_d == 0)[:, None] | (cum_d <= td_slack + 1e-4))
                     ).all(dim=1)
    cum_src, rank_src = group_cumsum(torch.where(ok, src_b, B + posn), ds)
    cum_dst, rank_dst = group_cumsum(torch.where(ok, dst_b, B + posn), dd)
    src_fit = (rank_src == 0) | (cum_src <= src_slack[src_b] + 1e-4).all(dim=1)
    dst_fit = (rank_dst == 0) | (cum_dst <= dst_slack[dst_b] + 1e-4).all(dim=1)
    win = win & src_fit & dst_fit
    if gain is not None:
        src_gain, dst_gain, dim = gain
        excl_src = cum_src[:, dim] - ds[:, dim]
        excl_dst = cum_dst[:, dim] - dd[:, dim]
        sg, dg = src_gain[src_b], dst_gain[dst_b]
        gain_ok = ((sg > 0) & (excl_src < sg)) | ((dg > 0) & (excl_dst < dg))
        if gain_escape is not None:
            gain_ok = gain_ok | gain_escape
        win = win & gain_ok
    if part_ok is not None:
        win = win & part_ok
    return win


_SIGNATURES = {"cc_wave_admission": [I] * 7 + [P] * 22 + [IP, P],
               "cc_wave_admission_lanes": [I] * 8 + [P] * 22 + [IP, P]}


def wave_admission(d, src_b, dst_b, wave_ok, part, src_slack, dst_slack,
                   gain, gain_escape, d_dst=None, kgroup=None, topic=None,
                   num_parts=None):
    """bool[N] admitted rows of a score-sorted wave. ``d`` f32[N, 8] source
    deltas (``d_dst`` the destination deltas when they differ); ``src_b`` /
    ``dst_b`` i64[N]; ``wave_ok`` bool[N]; ``part`` i64[N] partitions for the
    partition first-touch (None: none; ``num_parts`` their count);
    ``kgroup`` = (i64[N] candidate of each row, count) for the
    one-row-per-candidate rule; ``topic`` = (topics i64[N], num_topics,
    delta f32[N, G], src_slack f32[N, G], dst_slack f32[N, G]) the chain's
    per-(topic, broker) budgets; ``*_slack`` f32[B, 8] the combined chain
    slack; ``gain`` = (src_gain f32[B], dst_gain f32[B], dim) of the active
    goal, or None; ``gain_escape`` bool[N] or None."""
    if not d.is_cuda:
        return wave_admission_plain(d, src_b, dst_b, wave_ok, part, src_slack,
                                    dst_slack, gain, gain_escape, d_dst, kgroup,
                                    topic, num_parts)
    N = d.shape[0]
    B = src_slack.shape[0]
    if not 0 < N <= MAX_K or d.shape[1] != 8:
        raise ValueError(f"wave_admission supports 0 < N <= {MAX_K} rows of 8 dims")
    d_dst = d if d_dst is None else d_dst
    if topic is not None:
        topics, nT, tdelta, ts_slack, td_slack = topic
        G = tdelta.shape[1]
    else:
        topics = tdelta = ts_slack = td_slack = None
        nT, G = 0, 0
    if gain is not None:
        src_gain, dst_gain, dim = gain
    else:
        src_gain = dst_gain = None
        dim = -1
    kg, nk = kgroup if kgroup is not None else (None, 0)
    np_ = 0
    if part is not None:
        np_ = num_parts if num_parts is not None else int(part.max()) + 1
    checks = ((d, torch.float32), (d_dst, torch.float32), (src_b, torch.int64),
              (dst_b, torch.int64), (wave_ok, torch.bool), (kg, torch.int64),
              (part, torch.int64), (topics, torch.int64), (tdelta, torch.float32),
              (ts_slack, torch.float32), (td_slack, torch.float32),
              (src_slack, torch.float32), (dst_slack, torch.float32),
              (src_gain, torch.float32), (dst_gain, torch.float32),
              (gain_escape, torch.bool))
    for t, dt in checks:
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError("wave_admission: wrong dtype, layout or device")
    dev = d.device
    n16 = -(-N // SCAN_BASE) * SCAN_BASE
    sides = 4 if G else 2
    fscratch = torch.empty(sides * (2 * n16 * 8 + 64 * 8), dtype=torch.float32,
                           device=dev)
    cum = torch.empty(sides * N * 8, dtype=torch.float32, device=dev)
    rank = torch.empty(sides * N, dtype=torch.int32, device=dev)
    first = torch.empty(max(1, nk + np_), dtype=torch.int32, device=dev)
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    win = torch.empty(N, dtype=torch.bool, device=dev)
    launches = ctypes.c_int(0)
    err = library("wave_admission", _SIGNATURES).cc_wave_admission(
        N, B, int(nT), int(G), int(dim), int(nk), int(np_), ptr(d), ptr(d_dst),
        ptr(src_b), ptr(dst_b), ptr(wave_ok), ptr(kg), ptr(part), ptr(topics),
        ptr(tdelta), ptr(ts_slack), ptr(td_slack), ptr(src_slack), ptr(dst_slack),
        ptr(src_gain), ptr(dst_gain), ptr(gain_escape), ptr(first), ptr(ok),
        ptr(fscratch), ptr(cum), ptr(rank), ptr(win), ctypes.byref(launches),
        stream_ptr())
    check(err, "wave_admission")
    KERNEL.count(f"N={N}", launches.value)
    return win


def wave_admission_lanes_plain(lane_args: list) -> torch.Tensor:
    return torch.stack([wave_admission_plain(*a) for a in lane_args])


def _stack_l(vals):
    return stack_lanes(vals, "wave_admission_lanes")


def wave_admission_lanes(lane_args: list) -> torch.Tensor:
    """bool[La, N]: ``wave_admission`` of each lane's positional argument
    tuple in ``lane_args`` (N, the gain dimension, the candidate and
    partition counts and the topic budget shape must agree across lanes)."""
    head = lane_args[0]
    if not head[0].is_cuda:
        return wave_admission_lanes_plain(lane_args)
    La = len(lane_args)
    padded = [tuple(a) + (None,) * (13 - len(a)) for a in lane_args]
    d, src_b, dst_b, wave_ok, part, src_slack, dst_slack = (
        _stack_l([a[i] for a in padded]) for i in range(7))
    d_dst = _stack_l([a[0] if a[9] is None else a[9] for a in padded])
    gains = [a[7] for a in padded]
    gain_escape = _stack_l([a[8] for a in padded])
    kgs = [a[10] for a in padded]
    topics_ = [a[11] for a in padded]
    nps = {a[12] for a in padded}
    _La, N, _C = d.shape
    B = src_slack.shape[1]
    if not 0 < N <= MAX_K or d.shape[2] != 8:
        raise ValueError(f"wave_admission_lanes supports 0 < N <= {MAX_K} rows of 8 dims")
    if any(g is None for g in gains) and not all(g is None for g in gains):
        raise ValueError("wave_admission_lanes: a gain budget in some lanes only")
    if gains[0] is not None:
        dims = {g[2] for g in gains}
        if len(dims) != 1:
            raise ValueError("wave_admission_lanes: lanes disagree on the gain dim")
        src_gain = _stack_l([g[0] for g in gains])
        dst_gain = _stack_l([g[1] for g in gains])
        dim = dims.pop()
    else:
        src_gain = dst_gain = None
        dim = -1
    if kgs[0] is not None:
        if len({kg[1] for kg in kgs}) != 1:
            raise ValueError("wave_admission_lanes: lanes disagree on the candidates")
        kg, nk = _stack_l([kg[0] for kg in kgs]), kgs[0][1]
    else:
        kg, nk = _stack_l(kgs), 0
    if topics_[0] is not None:
        if len({(t[1], t[2].shape[1]) for t in topics_}) != 1:
            raise ValueError("wave_admission_lanes: lanes disagree on the topic budgets")
        topics, nT = _stack_l([t[0] for t in topics_]), topics_[0][1]
        tdelta, ts_slack, td_slack = (_stack_l([t[i] for t in topics_]) for i in (2, 3, 4))
        G = tdelta.shape[2]
    else:
        _stack_l(topics_)
        topics = tdelta = ts_slack = td_slack = None
        nT, G = 0, 0
    np_ = 0
    if part is not None:
        if len(nps) != 1:
            raise ValueError("wave_admission_lanes: lanes disagree on the partitions")
        np_ = nps.pop()
        if np_ is None:
            np_ = int(part.max()) + 1
    checks = ((d, torch.float32), (d_dst, torch.float32), (src_b, torch.int64),
              (dst_b, torch.int64), (wave_ok, torch.bool), (kg, torch.int64),
              (part, torch.int64), (topics, torch.int64), (tdelta, torch.float32),
              (ts_slack, torch.float32), (td_slack, torch.float32),
              (src_slack, torch.float32), (dst_slack, torch.float32),
              (src_gain, torch.float32), (dst_gain, torch.float32),
              (gain_escape, torch.bool))
    for t, dt in checks:
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError("wave_admission_lanes: wrong dtype, layout or device")
    dev = d.device
    n16 = -(-N // SCAN_BASE) * SCAN_BASE
    sides = 4 if G else 2
    fscratch = torch.empty(La * sides * (2 * n16 * 8 + 64 * 8), dtype=torch.float32,
                           device=dev)
    cum = torch.empty(La * sides * N * 8, dtype=torch.float32, device=dev)
    rank = torch.empty(La * sides * N, dtype=torch.int32, device=dev)
    first = torch.empty(La * max(1, nk + np_), dtype=torch.int32, device=dev)
    ok = torch.empty((La, N), dtype=torch.bool, device=dev)
    win = torch.empty((La, N), dtype=torch.bool, device=dev)
    launches = ctypes.c_int(0)
    err = library("wave_admission", _SIGNATURES).cc_wave_admission_lanes(
        La, N, B, int(nT), int(G), int(dim), int(nk), int(np_), ptr(d), ptr(d_dst),
        ptr(src_b), ptr(dst_b), ptr(wave_ok), ptr(kg), ptr(part), ptr(topics),
        ptr(tdelta), ptr(ts_slack), ptr(td_slack), ptr(src_slack), ptr(dst_slack),
        ptr(src_gain), ptr(dst_gain), ptr(gain_escape), ptr(first), ptr(ok),
        ptr(fscratch), ptr(cum), ptr(rank), ptr(win), ctypes.byref(launches),
        stream_ptr())
    check(err, "wave_admission_lanes")
    KERNEL_LANES.count(f"L={La} N={N}", launches.value)
    return win
