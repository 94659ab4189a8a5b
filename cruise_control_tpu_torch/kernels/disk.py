"""K8 ``disk_rows`` and ``disk_apply``: the intra-broker disk branch.

``disk_rows`` replaces ``cruise_control_tpu/analyzer/engine.py``
``_disk_move_branch_batched``'s ``_disk_rows`` (:1222-1230) with
``goals/base.py`` ``legit_disk_move_mask`` (:456), every previous goal's
``accept_disk_move`` and the active goal's ``disk_move_score``. For every
(candidate k, logdir d of its own broker) it evaluates legitimacy (the
destination logdir is alive with capacity and differs from the current one,
the replica is valid on an alive broker, its topic is not excluded unless it
sits on a dead disk), the folded vetoes, ``kv > -inf`` and the score, and
reduces each row to its maximum. Its score reads ``slead_disk`` /
``sfoll_disk`` when given (the bf16 sweep view's DISK loads, upcast: the
reference's ``disk_move_score`` reads ``env_sw``), its vetoes and legitimacy
the f32 loads.

``disk_apply`` replaces the sequential ``fori_loop`` of the same branch
(:1238-1253) with ``_rescore_disk_move_row`` (:1186) and ``state.py``
``apply_disk_move`` (:404): in the given (stable, descending) order of the
row maxima, each row with ``best > min_gain`` re-scores its D logdirs against
the live state, takes the lowest-index maximum and, when both the row's
maximum and the re-score exceed ``min_gain``, moves the replica: the DISK
load leaves the source logdir and lands on the destination, the replica's
logdir changes, the offline flag clears when the destination heals it and
``moved`` is set. The wrapper copies ``disk_util``, ``replica_disk``,
``replica_offline`` and ``moved`` and the kernel updates the copies in place.

Families (``DiskRule``), each with the reference's own arithmetic:

- ``DISK_CAPACITY`` (IntraBrokerDiskCapacityGoal, ``a`` = the DISK capacity
  threshold): the per-logdir limit ``a * cap`` on valid logdirs (0 on the
  others); score ``l + (0.01 * headroom) / cap`` for a replica on an
  over-limit logdir, ``1 + headroom / cap`` for one on a dead disk (the
  healing case), where the move fits; veto ``util + l <= limit + DISK_EPS``.
- ``DISK_BAND`` (IntraBrokerDiskUsageDistributionGoal, ``a`` / ``b`` = 1 +/-
  the band's deviation): the band ``avg * a`` / ``avg * b`` around the
  broker's utilization over its valid logdirs (sums over D left to right
  from 0, as XLA:CPU reduces a minor axis); score the decrease of the
  source's plus the destination's distance outside the band; veto
  ``pct + l / cap <= upper + PCT_EPS`` on valid logdirs.

CUDA kernels (``csrc/disk_move.cu``): ``disk_rows`` runs one thread per
(row, logdir), the row's D scores through shared memory to one thread that
keeps the first maximum; ``disk_apply`` runs one thread that walks the rows
in order, re-scoring with the same device function against the live
``disk_util`` of the row's broker (the band of that broker recomputed from
its live row). Bound: ``disk_rows`` bytes (a few gathers per (k, d));
``disk_apply`` latency: its rows form one dependent chain of global reads.
Rows of different brokers touch disjoint state (``disk_util[b]``, the band
of b, the row's own replica), so one warp per broker segment, each walking
its rows in order, would be exact too (a later step).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import EPSILON_ABS, Resource
from cruise_control_tpu_torch.kernels.build import (
    I, P, check, library, ptr, register, stream_ptr,
)

KERNEL_ROWS = register("disk_rows", "cruise_control_tpu_torch/kernels/csrc/disk_move.cu",
                       "cruise_control_tpu/analyzer/engine.py:1222")
KERNEL_APPLY = register("disk_apply",
                        "cruise_control_tpu_torch/kernels/csrc/disk_move.cu",
                        "cruise_control_tpu/analyzer/engine.py:1238")

DISK_CAPACITY = 0   # IntraBrokerDiskCapacityGoal
DISK_BAND = 1       # IntraBrokerDiskUsageDistributionGoal
DISK_EPS = EPSILON_ABS[Resource.DISK]   # 100 MB absolute tolerance
PCT_EPS = 1e-4
CAP_FLOOR = 1e-6
MAX_D = 32
F32 = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class DiskRule:
    """An intra-broker goal's ``disk_move_score`` (as the active goal) or its
    ``accept_disk_move`` (as a previous goal) in family form."""
    family: int
    a: float            # capacity threshold | 1 + band deviation
    b: float = 0.0      # — | 1 - band deviation


@dataclasses.dataclass
class DiskState:
    """The state both kernels read (``disk_apply`` writes the last four
    kinds of its copies)."""
    rb: torch.Tensor            # i64[R] replica broker
    rlead: torch.Tensor         # bool[R]
    lead_disk: torch.Tensor     # f32[R] DISK load as leader
    foll_disk: torch.Tensor     # f32[R] DISK load as follower
    rvalid: torch.Tensor        # bool[R]
    rtexcl: torch.Tensor        # bool[R] topic excluded
    balive: torch.Tensor        # bool[B]
    dalive: torch.Tensor        # bool[B, D]
    dcap: torch.Tensor          # f32[B, D]
    rdisk: torch.Tensor         # i64[R] replica logdir
    roff: torch.Tensor          # bool[R] offline
    moved: torch.Tensor         # bool[R]
    dutil: torch.Tensor         # f32[B, D]
    # the DISK loads ``disk_rows``' score reads (the bf16 sweep view's,
    # upcast); None: lead_disk / foll_disk. Vetoes and the walk read those.
    slead_disk: torch.Tensor | None = None
    sfoll_disk: torch.Tensor | None = None


def score_state(ds: DiskState) -> DiskState:
    """``ds`` with the loads the score reads."""
    if ds.slead_disk is None:
        return ds
    return dataclasses.replace(ds, lead_disk=ds.slead_disk, foll_disk=ds.sfoll_disk)


# ---------------------------------------------------------------------------
# plain PyTorch (the twins, and the goals' own arithmetic)
# ---------------------------------------------------------------------------
def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 of [B, D], left to right from +0.0 (XLA:CPU's order
    for a reduce over a minor axis)."""
    acc = torch.zeros_like(x[:, 0])
    for d in range(x.shape[1]):
        acc = acc + x[:, d]
    return acc


def disk_valid(ds: DiskState) -> torch.Tensor:
    """bool[B, D]: configured, alive logdirs on alive brokers."""
    return ds.dalive & (ds.dcap > 0) & ds.balive[:, None]


def disk_limit(ds: DiskState, thresh: float) -> torch.Tensor:
    """f32[B, D]: allowed utilization per logdir; 0 on invalid logdirs."""
    return torch.where(disk_valid(ds), thresh * ds.dcap, torch.zeros_like(ds.dcap))


def disk_band(ds: DiskState, up_f: float, lo_f: float):
    """(pct f32[B, D], lower f32[B], upper f32[B], valid bool[B, D])."""
    valid = disk_valid(ds)
    zero = torch.zeros_like(ds.dcap)
    cap = torch.where(valid, ds.dcap, zero)
    util = torch.where(valid, ds.dutil, zero)
    avg = row_sum(util) / torch.clamp(row_sum(cap), min=CAP_FLOOR)
    pct = ds.dutil / torch.clamp(ds.dcap, min=CAP_FLOOR)
    return pct, avg * lo_f, avg * up_f, valid


def band_violation(p, up, lo):
    return torch.clamp(p - up, min=0.0) + torch.clamp(lo - p, min=0.0)


def candidate_disk_load(ds: DiskState, cand: torch.Tensor) -> torch.Tensor:
    """f32[K] DISK load of each candidate in its current role."""
    return torch.where(ds.rlead[cand], ds.lead_disk[cand], ds.foll_disk[cand])


def on_dead_disk(ds: DiskState) -> torch.Tensor:
    """bool[R]: the replica sits on a dead or unconfigured logdir of an alive
    broker (the intra-broker healing case)."""
    b = ds.rb
    d = torch.clamp(ds.rdisk, min=0)
    bad = ~(ds.dalive[b, d] & (ds.dcap[b, d] > 0))
    return ds.rvalid & ds.balive[b] & bad


def legit_plain(ds: DiskState, cand: torch.Tensor) -> torch.Tensor:
    """bool[K, D] ``legit_disk_move_mask``."""
    b = ds.rb[cand]
    D = ds.dcap.shape[1]
    dst_alive = ds.dalive[b] & (ds.dcap[b] > 0)
    cur = ds.rdisk[cand]
    not_self = torch.arange(D, device=cand.device)[None, :] != cur[:, None]
    valid = ds.rvalid[cand] & ds.balive[b]
    dead = ~ds.dalive[b, torch.clamp(cur, min=0)]
    topic_ok = ~ds.rtexcl[cand] | dead
    return dst_alive & not_self & (valid & topic_ok)[:, None]


def accept_plain(rule: DiskRule, ds: DiskState, cand: torch.Tensor) -> torch.Tensor:
    """bool[K, D] ``accept_disk_move`` of a previous goal."""
    l = candidate_disk_load(ds, cand)
    b = ds.rb[cand]
    if rule.family == DISK_CAPACITY:
        return ds.dutil[b] + l[:, None] <= disk_limit(ds, rule.a)[b] + DISK_EPS
    if rule.family == DISK_BAND:
        cap = torch.clamp(ds.dcap[b], min=CAP_FLOOR)
        pct, _lower, upper, valid = disk_band(ds, rule.a, rule.b)
        after = pct[b] + l[:, None] / cap
        return ~valid[b] | (after <= upper[b][:, None] + PCT_EPS)
    raise ValueError(f"unknown disk family {rule.family}")


def score_plain(rule: DiskRule, ds: DiskState, cand: torch.Tensor) -> torch.Tensor:
    """f32[K, D] ``disk_move_score`` of the active goal (no legitimacy)."""
    K = cand.shape[0]
    posn = torch.arange(K, device=cand.device)
    l = candidate_disk_load(ds, cand)
    b = ds.rb[cand]
    cur = torch.clamp(ds.rdisk[cand], min=0)
    cap = torch.clamp(ds.dcap[b], min=CAP_FLOOR)
    neg = torch.full((K, ds.dcap.shape[1]), -torch.inf, dtype=torch.float32,
                     device=cand.device)
    if rule.family == DISK_CAPACITY:
        limit = disk_limit(ds, rule.a)[b]
        util = ds.dutil[b]
        feasible = util + l[:, None] <= limit
        src_over = util[posn, cur] > limit[posn, cur] + DISK_EPS
        dead = on_dead_disk(ds)[cand]
        headroom = torch.clamp(limit - util, min=0.0)
        score = l[:, None] + 0.01 * headroom / cap
        score = torch.where(dead[:, None], 1.0 + headroom / cap, score)
        return torch.where(feasible & (src_over | dead)[:, None], score, neg)
    if rule.family == DISK_BAND:
        pct, lower, upper, valid = disk_band(ds, rule.a, rule.b)
        dl = l[:, None] / cap
        src_pct = pct[b][posn, cur]
        src_cap = cap[posn, cur]
        up, lo = upper[b], lower[b]
        v_src_before = band_violation(src_pct, up, lo)
        v_src_after = band_violation(src_pct - l / src_cap, up, lo)
        v_dst_before = band_violation(pct[b], up[:, None], lo[:, None])
        v_dst_after = band_violation(pct[b] + dl, up[:, None], lo[:, None])
        gain = (v_src_before - v_src_after)[:, None] + (v_dst_before - v_dst_after)
        return torch.where(valid[b], gain, neg)
    raise ValueError(f"unknown disk family {rule.family}")


def masked_scores_plain(ds: DiskState, cand, rule: DiskRule, vetoes) -> torch.Tensor:
    """f32[K, D]: the score where legitimate and every veto accepts, else
    -inf (``_rescore_disk_move_row`` for each row)."""
    m = legit_plain(ds, cand)
    for v in vetoes:
        m = m & accept_plain(v, ds, cand)
    s = score_plain(rule, score_state(ds), cand)
    return torch.where(m, s, torch.full_like(s, -torch.inf))


def disk_rows_plain(ds: DiskState, cand, kv, rule: DiskRule, vetoes) -> torch.Tensor:
    sc = masked_scores_plain(ds, cand, rule, vetoes)
    sc = torch.where((kv > -torch.inf)[:, None], sc, torch.full_like(sc, -torch.inf))
    return sc.max(dim=1).values


def disk_apply_plain(ds: DiskState, cand, best, order, rule: DiskRule, vetoes,
                     min_gain: float):
    """The sequential walk on copies of the written state (see the module
    doc). Returns (dutil, rdisk, roff, moved, n_applied i64 scalar)."""
    ds = dataclasses.replace(ds, dutil=ds.dutil.clone(), rdisk=ds.rdisk.clone(),
                             roff=ds.roff.clone(), moved=ds.moved.clone())
    best_h = best.tolist()
    mg = float(np.float32(min_gain))     # the f32 comparison of the kernel
    n = 0
    for k in order.tolist():
        if not best_h[k] > mg:
            break
        r = cand[k:k + 1]
        row = masked_scores_plain(ds, r, rule, vetoes)[0]
        d = int(torch.argmax(row))
        if not float(row[d]) > mg:
            continue
        rr = int(r)
        b = int(ds.rb[rr])
        src = int(ds.rdisk[rr])
        l = candidate_disk_load(ds, r)[0]
        ds.dutil[b, src] = ds.dutil[b, src] + (-l)
        ds.dutil[b, d] = ds.dutil[b, d] + l
        ds.rdisk[rr] = d
        if bool(ds.dalive[b, d]) and bool(ds.balive[b]):
            ds.roff[rr] = False
        ds.moved[rr] = True
        n += 1
    n_t = torch.tensor(n, dtype=torch.int64, device=cand.device)
    return ds.dutil, ds.rdisk, ds.roff, ds.moved, n_t


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
_SIGNATURES = {
    "cc_disk_rows": [I] * 5 + [F32] * 4 + [P] * 17,
    "cc_disk_apply": [I] * 5 + [F32] * 5 + [P] * 18,
}
_F32, _I64, _BOOL = torch.float32, torch.int64, torch.bool


def _rule_args(rule: DiskRule, vetoes):
    """(family, vflags, a, b, veto capacity threshold, veto band factor):
    at most one capacity and one band veto."""
    vflags, vcap, vup = 0, 0.0, 0.0
    for v in vetoes:
        bit = 1 << v.family
        if vflags & bit:
            raise NotImplementedError("two intra-broker vetoes of one kind in a chain")
        vflags |= bit
        if v.family == DISK_CAPACITY:
            vcap = v.a
        else:
            vup = v.a
    return int(rule.family), vflags, rule.a, rule.b, vcap, vup


def _state_tensors(ds: DiskState):
    tensors = [ds.rb, ds.rlead, ds.lead_disk, ds.foll_disk, ds.rvalid, ds.rtexcl,
               ds.balive, ds.dalive, ds.dcap]
    dts = [_I64, _BOOL, _F32, _F32, _BOOL, _BOOL, _BOOL, _BOOL, _F32]
    return tensors, dts


def _check_inputs(what: str, tensors, dts):
    for t, dt in zip(tensors, dts):
        if t.dtype != dt or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"{what}: wrong dtype, layout or device")


def disk_rows(ds: DiskState, cand, kv, rule: DiskRule, vetoes) -> torch.Tensor:
    """f32[K]: each candidate's best masked intra-broker move score."""
    if not cand.is_cuda:
        return disk_rows_plain(ds, cand, kv, rule, vetoes)
    K = cand.shape[0]
    B, D = ds.dcap.shape
    if not (0 < K and 0 < D <= MAX_D):
        raise ValueError(f"disk_rows: unsupported K={K} D={D}")
    st_t, st_dt = _state_tensors(ds)
    sc = score_state(ds)
    st_t = st_t[:4] + [sc.lead_disk, sc.foll_disk] + st_t[4:]
    st_dt = st_dt[:4] + [_F32, _F32] + st_dt[4:]
    tensors = st_t + [ds.rdisk, ds.dutil, cand, kv]
    _check_inputs("disk_rows", tensors, st_dt + [_I64, _F32, _I64, _F32])
    family, vflags, a, b, vcap, vup = _rule_args(rule, vetoes)
    best = torch.empty(K, dtype=_F32, device=cand.device)
    err = library("disk_move", _SIGNATURES).cc_disk_rows(
        K, B, D, family, vflags, a, b, vcap, vup,
        *(ptr(t) for t in tensors), ptr(best), stream_ptr())
    check(err, "disk_rows")
    KERNEL_ROWS.count(f"K={K} D={D}")
    return best


def disk_apply(ds: DiskState, cand, best, order, rule: DiskRule, vetoes,
               min_gain: float):
    """(dutil, rdisk, roff, moved, n_applied i64 scalar) after the ordered
    walk (see the module doc); the inputs are not modified."""
    if not cand.is_cuda:
        return disk_apply_plain(ds, cand, best, order, rule, vetoes, min_gain)
    K = cand.shape[0]
    B, D = ds.dcap.shape
    if not (0 < K and 0 < D <= MAX_D):
        raise ValueError(f"disk_apply: unsupported K={K} D={D}")
    st_t, st_dt = _state_tensors(ds)
    _check_inputs("disk_apply", st_t + [ds.rdisk, ds.roff, ds.moved, ds.dutil, cand,
                                        best, order],
                  st_dt + [_I64, _BOOL, _BOOL, _F32, _I64, _F32, _I64])
    family, vflags, a, b, vcap, vup = _rule_args(rule, vetoes)
    dutil, rdisk = ds.dutil.clone(), ds.rdisk.clone()
    roff, moved = ds.roff.clone(), ds.moved.clone()
    n = torch.empty((), dtype=_I64, device=cand.device)
    err = library("disk_move", _SIGNATURES).cc_disk_apply(
        K, B, D, family, vflags, a, b, vcap, vup, float(min_gain),
        *(ptr(t) for t in st_t), ptr(cand), ptr(best), ptr(order),
        ptr(rdisk), ptr(roff), ptr(moved), ptr(dutil), ptr(n), stream_ptr())
    check(err, "disk_apply")
    KERNEL_APPLY.count(f"K={K} D={D}")
    return dutil, rdisk, roff, moved, n
