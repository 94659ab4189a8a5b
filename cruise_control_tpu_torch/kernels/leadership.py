"""K6 ``leadership_rows``: the [K, F] leadership-transfer score fusion with
its per-row best and per-segment bests.

Replaces ``cruise_control_tpu/analyzer/engine.py``
``_leadership_branch_batched`` / ``_lead_rows`` (:1003-1013), the rows of
``_exhaustive_lead_scan`` (:1354-1365) and ``_segment_lead_wave``'s
``_seg_lead_rows`` (:1597-1613), with ``goals/base.py``
``legit_leadership_mask`` (:471), every previous goal's
``accept_leadership`` and the active goal's ``leadership_score``. For every
(candidate leader k, partition member f) it evaluates legitimacy (the member
exists, is not the candidate, is online, its broker is alive, not demoted and
not excluded for leadership), the folded vetoes and the score; then it
reduces each row to the best value and its first argmax f, and, given a
broker coloring, to the best per color ``s < active`` (``jnp.argmax``'s
first-max rule; an all ``-inf`` row gives f = 0).

Goal families (``LEAD_*``): the goal precomputes its [B]-level columns
(``fb`` f32[3, B]), one per-replica column (``fr`` f32[R], read at the
member) and per-row values (``fk`` f32[2, K]) with the reference's own
arithmetic; the kernel does only the per-(k, f) gathers, compares and
selects. A veto (``Veto``) is ``a[db] + x <= c[db]`` with ``db`` the
member's broker and ``x`` a per-member-replica or per-row value: every
``accept_leadership`` of the reference's chain has that form once its
row-only part is folded into ``row_ok``.

``leadership_rows_lanes`` is the fleet's lane form (K14): the solo
arguments of La lanes stacked into [La, ...] tensors (the assignment read
from a lane stack's rows at a lane index list), ONE launch (grid dimension
y = lane); each lane's result is its solo launch's. Its twin loops the
solo twin over the lanes. ``leadership_rows`` is the same launch with one
lane.

CUDA kernel (``csrc/leadership_score.cu``): one thread per candidate row
(F is 3 or 4, so a CTA of 128 threads holds 128 rows and no lane idles on a
short F loop); the member scores live in registers. Bound: bytes (a few
gathers per (k, f)).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from cruise_control_tpu_torch.kernels.build import (
    IP, I, P, check, lane_index, lane_operand, library, ptr, register, stream_ptr,
)

KERNEL = register("leadership_rows",
                  "cruise_control_tpu_torch/kernels/csrc/leadership_score.cu",
                  "cruise_control_tpu/analyzer/engine.py:1003")
KERNEL_LANES = register("leadership_rows_lanes",
                        "cruise_control_tpu_torch/kernels/csrc/leadership_score.cu",
                        "cruise_control_tpu/analyzer/engine.py:2324")

LEAD_CAPACITY = 0      # CapacityGoal (Cpu / NetworkOutbound)
LEAD_MIN_TOPIC = 1     # MinTopicLeadersPerBrokerGoal
LEAD_BYTES_IN = 2      # LeaderBytesInDistributionGoal
LEAD_LEADER_DIST = 3   # LeaderReplicaDistributionGoal
MAX_F = 32
MAX_S = 64
MAX_V = 31


@dataclasses.dataclass
class LeadTables:
    """A goal's ``leadership_score`` in family form."""
    family: int
    fb: torch.Tensor                    # f32[3, B] broker columns
    fk: torch.Tensor                    # f32[2, K] row columns
    fr: torch.Tensor | None = None      # f32[R] member-replica column
    row_t: torch.Tensor | None = None   # i64[K] row topic (LEAD_MIN_TOPIC)
    tab: torch.Tensor | None = None     # i32[T, B] (LEAD_MIN_TOPIC)


@dataclasses.dataclass
class Veto:
    """``a[db] + x <= c[db]``; ``x`` is ``x_rep[member]`` or ``x_row[k]``."""
    a: torch.Tensor                      # f32[B]
    c: torch.Tensor                      # f32[B]
    x_rep: torch.Tensor | None = None    # f32[R]
    x_row: torch.Tensor | None = None    # f32[K]


def _violation(u, lower, upper):
    return torch.clamp(u - upper, min=0.0) + torch.clamp(lower - u, min=0.0)


def legit_plain(cand, members, row_ok, broker_ok, rb, roff):
    m = torch.clamp(members, min=0)
    db = rb[m]
    return ((members >= 0) & (members != cand[:, None]) & broker_ok[db] & ~roff[m]
            & row_ok[:, None])


def vetoes_plain(vetoes, members, rb):
    m = torch.clamp(members, min=0)
    db = rb[m]
    ok = torch.ones(members.shape, dtype=torch.bool, device=members.device)
    for v in vetoes:
        x = v.x_rep[m] if v.x_rep is not None else v.x_row[:, None]
        ok = ok & ((v.a[db] + x) <= v.c[db])
    return ok


def family_score_plain(t: LeadTables, members, rb):
    m = torch.clamp(members, min=0)
    db = rb[m]
    neg = torch.full(members.shape, -torch.inf, dtype=torch.float32,
                     device=members.device)
    if t.family == LEAD_CAPACITY:
        feasible = (t.fb[0][db] + t.fr[m]) <= t.fb[1][db]
        return torch.where(feasible, t.fk[0][:, None].expand_as(neg), neg)
    if t.family == LEAD_MIN_TOPIC:
        B = t.fb.shape[1]
        c = t.tab.reshape(-1)[t.row_t[:, None] * B + db].to(torch.float32)
        need = torch.where((t.fk[0] != 0)[:, None], t.fb[0][db],
                           torch.zeros_like(c))
        gain = torch.clamp(torch.clamp(need - c, min=0.0), max=1.0)
        return torch.where(gain > 0, gain, neg)
    if t.family == LEAD_BYTES_IN:
        new_excess = torch.clamp((t.fb[0][db] + t.fk[0][:, None]) - t.fb[1][db],
                                 min=0.0)
        ok = (new_excess <= 0.0) & (t.fk[1] > 0)[:, None]
        return torch.where(ok, t.fk[1][:, None].expand_as(neg), neg)
    if t.family == LEAD_LEADER_DIST:
        vso, vsn = t.fk[0][:, None], t.fk[1][:, None]
        c_d, lo_d, up_d = t.fb[0][db], t.fb[1][db], t.fb[2][db]
        vdo = _violation(c_d, lo_d, up_d)
        vdn = _violation(c_d + 1.0, lo_d, up_d)
        gain = (vso - vsn) + (vdo - vdn)
        ok = (vsn <= vso) & (vdn <= vdo) & (gain > 0)
        return torch.where(ok, gain, neg)
    raise ValueError(f"unknown leadership family {t.family}")


def leadership_rows_plain(cand, members, row_ok, broker_ok, rb, roff, tables,
                          vetoes, color=None, S=0, active=0):
    ok = legit_plain(cand, members, row_ok, broker_ok, rb, roff)
    ok = ok & vetoes_plain(vetoes, members, rb)
    score = family_score_plain(tables, members, rb)
    sc = torch.where(ok, score, torch.full_like(score, -torch.inf))
    best, f = sc.max(dim=1).values, torch.argmax(sc, dim=1)
    if not S:
        return best, f
    K = sc.shape[0]
    seg_of = color[rb[torch.clamp(members, min=0)]]
    posn = torch.arange(K, device=sc.device)
    vals, fs = [], []
    for s in range(S):
        ms = torch.where(seg_of == s, sc, torch.full_like(sc, -torch.inf))
        fsel = torch.argmax(ms, dim=1)
        v = ms[posn, fsel]
        vals.append(v if s < active else torch.full_like(v, -torch.inf))
        fs.append(fsel)
    return best, f, torch.stack(vals, 1), torch.stack(fs, 1)


_SIGNATURES = {"cc_leadership_rows_lanes": [I] * 11 + [ctypes.c_longlong] + [P] * 21
               + [IP, P]}

_DTYPES = (torch.int64, torch.int64, torch.bool, torch.int64, torch.bool, torch.bool,
           torch.float32, torch.float32, torch.float32, torch.int64, torch.int32,
           torch.float32, torch.float32, torch.float32, torch.float32, torch.int64)


def _veto_tensors(veto_lists: list, R: int, K: int, dev):
    """(va, vc, vxr, vxk, vrow_mask) of La lanes' veto lists (the same kinds
    in every lane): f32[La * V, B] / [La * V, R] / [La * V, K], one stack
    each for all lanes (zeros where a veto reads the other x), and the mask
    whose bit v says veto v reads its per-row x."""
    vetoes = [v for vs in veto_lists for v in vs]
    if not vetoes:
        return None, None, None, None, 0
    f32 = torch.float32
    zr = torch.zeros(R, dtype=f32, device=dev)
    zk = torch.zeros(K, dtype=f32, device=dev)
    return (torch.stack([v.a for v in vetoes]).contiguous(),
            torch.stack([v.c for v in vetoes]).contiguous(),
            torch.stack([zr if v.x_rep is None else v.x_rep for v in vetoes]),
            torch.stack([zk if v.x_row is None else v.x_row for v in vetoes]),
            sum(1 << i for i, v in enumerate(veto_lists[0]) if v.x_rep is None))


def _check_stacked(lane_args: list, stacked, what: str) -> None:
    lanes, rb, roff = stacked
    if len(lanes) != len(lane_args) or any(
            a[4].data_ptr() != rb[l].data_ptr() or a[5].data_ptr() != roff[l].data_ptr()
            for a, l in zip(lane_args, lanes)):
        raise ValueError(f"{what}: a lane's assignment is not its stack row")


def _launch(lane_args: list, stacked, color, S: int, active: int, what: str, kernel,
            shape: str):
    """The one launch behind both wrappers: La = ``len(lane_args)`` lanes,
    the assignment read from ``stacked``'s rows at its lane index list, or
    (``stacked`` None) one lane, the solo launch, its operands as they are.
    Returns (best, f[, seg_val, seg_f]) with a leading lane axis when
    La > 1."""
    La = len(lane_args)
    head = lane_args[0]
    K, F = head[1].shape
    B = head[3].shape[0]
    R = head[4].shape[0]
    V = len(head[7])
    if F > MAX_F or S > MAX_S or K <= 0 or V > MAX_V:
        raise ValueError(f"{what}: unsupported K={K} F={F} S={S} V={V}")
    dev = head[0].device
    cand, members, row_ok, broker_ok = (
        lane_operand([a[i] for a in lane_args], what) for i in range(4))
    if stacked is None:
        rb, roff, lanes_t = head[4], head[5], None
    else:
        lanes, rb, roff = stacked
        lanes_t = lane_index(lanes, dev)
    fb, fr, fk, row_t, tab = (lane_operand([getattr(a[6], f) for a in lane_args], what)
                              for f in ("fb", "fr", "fk", "row_t", "tab"))
    # bit v of vrow_mask: veto v reads its per-row x (x_row), else the member's
    va, vc, vxr, vxk, vrow_mask = _veto_tensors([a[7] for a in lane_args], R, K, dev)
    tensors = [cand, members, row_ok, rb, roff, broker_ok, fb, fr, fk, row_t, tab,
               va, vc, vxr, vxk, color]
    for t, dt in zip(tensors, _DTYPES):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError(f"{what}: wrong dtype, layout or device")
    lead = (La,) if La > 1 else ()
    best = torch.empty(lead + (K,), dtype=torch.float32, device=dev)
    fbest = torch.empty(lead + (K,), dtype=torch.int64, device=dev)
    seg_val = torch.empty((K, S), dtype=torch.float32, device=dev) if S else None
    seg_f = torch.empty((K, S), dtype=torch.int64, device=dev) if S else None
    tab_n = head[6].tab.numel() if tab is not None else 0
    launches = ctypes.c_int(0)
    err = library("leadership_score", _SIGNATURES).cc_leadership_rows_lanes(
        La, K, F, B, R, int(head[6].family), V, int(S), int(active),
        int(head[6].fb.shape[0]), vrow_mask, tab_n, ptr(lanes_t),
        *(ptr(t) for t in tensors), ptr(best), ptr(fbest), ptr(seg_val), ptr(seg_f),
        ctypes.byref(launches), stream_ptr())
    check(err, what)
    kernel.count(shape, launches.value)
    if not S:
        return best, fbest
    return best, fbest, seg_val, seg_f


def leadership_rows(cand, members, row_ok, broker_ok, rb, roff, tables: LeadTables,
                    vetoes: list, color=None, S: int = 0, active: int = 0):
    """(best f32[K], f i64[K]) and, with ``S > 0``, (seg_val f32[K, S],
    seg_f i64[K, S]) of the masked leadership scores. ``cand`` i64[K],
    ``members`` i64[K, F] (-1 padded), ``row_ok`` bool[K] (candidate-level
    legitimacy and vetoes), ``broker_ok`` bool[B], ``rb`` i64[R] /
    ``roff`` bool[R] the assignment, ``color`` i64[B] the broker coloring.
    The one-lane launch of ``leadership_rows_lanes``' kernel (the segment
    wave's ``S > 0`` is solo only)."""
    if not cand.is_cuda:
        return leadership_rows_plain(cand, members, row_ok, broker_ok, rb, roff,
                                     tables, vetoes, color, S, active)
    K = members.shape[0]
    return _launch([(cand, members, row_ok, broker_ok, rb, roff, tables, vetoes)], None,
                   color, S, active, "leadership_rows", KERNEL,
                   f"segments S={S}" if S else f"K={K}")


def leadership_rows_lanes_plain(lane_args: list):
    outs = [leadership_rows_plain(*a) for a in lane_args]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def leadership_rows_lanes(lane_args: list, stacked: tuple):
    """(best f32[La, K], f i64[La, K]): ``leadership_rows`` of each lane's
    positional argument tuple (cand, members, row_ok, broker_ok, rb, roff,
    tables, vetoes) in ``lane_args``, in one launch. The lanes must agree on
    the goal family, the number and kinds of vetoes and every shape.
    ``stacked`` = (the lanes' indices in their lane stack, its i64[L, R]
    ``replica_broker``, its bool[L, R] ``replica_offline``): each lane's
    ``rb`` / ``roff`` must be its stack row, which the kernel reads at the
    index instead of a new stack."""
    _check_stacked(lane_args, stacked, "leadership_rows_lanes")
    head = lane_args[0]
    fam = head[6].family
    kinds = [v.x_rep is None for v in head[7]]
    for a in lane_args[1:]:
        if a[6].family != fam or [v.x_rep is None for v in a[7]] != kinds:
            raise ValueError("leadership_rows_lanes: lanes disagree on the family "
                             "or the vetoes")
    if not head[0].is_cuda:
        return leadership_rows_lanes_plain(lane_args)
    La, K = len(lane_args), head[1].shape[0]
    best, fbest = _launch(lane_args, stacked, None, 0, 0, "leadership_rows_lanes",
                          KERNEL_LANES, f"L={La} K={K}")
    return best.view(La, K), fbest.view(La, K)
