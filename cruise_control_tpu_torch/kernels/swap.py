"""K7 ``swap_rows`` and ``swap_admission``: the [K1, K2] swap-pair score
fusion with its per-row best, and the first-use admission of one
score-sorted swap wave.

``swap_rows`` replaces ``cruise_control_tpu/analyzer/engine.py``
``_swap_branch_batched``'s ``_swap_rows`` (:1129-1141) and the rows of
``_swap_window_positives`` (:1414-1420), with ``goals/base.py``
``legit_swap_mask`` (:417), every previous goal's ``accept_swap`` and the
active goal's ``swap_score``. For every pair (out candidate i, in candidate
j) it evaluates legitimacy (different brokers, no sibling of either
partition on the other broker, the new-broker rule, the row-level checks
folded into ``row_ok_out`` / ``row_ok_in``), the folded vetoes and the
family score; then it reduces each row to its best value, the lowest j
among equal maxima (``jnp.argmax``'s rule; an all ``-inf`` row gives j = 0)
and the count of pairs scoring above ``min_gain`` (the window clause of the
finisher's certificate).

``swap_admission`` replaces the first-use admission of
``_swap_branch_batched`` (:1146-1177): in score order, row p wins iff its
value exceeds ``min_gain`` and no EARLIER row q whose value exceeds
``min_gain`` shares a broker (either role), the in-candidate or a partition
(either side) with it. That is the reference's ``.at[].min`` first use: an
earlier eligible row blocks even when it lost itself. The stable sort by
``-best_val`` in between stays a torch stable sort (``engine._desc_order``).

Vetoes (``SwapVeto``) are the previous goals' ``accept_swap`` in one of
four kinds, each read at the pair's two brokers ``bo`` / ``bi`` with the
per-row values ``x_out[i]`` / ``x_in[j]``:

- ``VETO_NET_CAPACITY`` (CapacityGoal): ``a[bo] - net <= c[bo]`` and
  ``a[bi] + net <= c[bi]``, ``net = x_out - x_in``;
- ``VETO_NET_BAND`` (ResourceDistributionGoal): ``_gain``'s feasibility of
  moving ``net`` from ``bo`` to ``bi`` in the band ``[lo, c]``;
- ``VETO_DIRECTED`` (the default accept_swap: both directed legs of
  ``accept_move``): ``a[bi] + x_out <= c[bi]`` and ``a[bo] + x_in <= c[bo]``;
- ``VETO_DIRECTED_EXEMPT``: the same, a leg with a zero value passes
  outright (LeaderReplicaDistributionGoal: only leaders are band-checked).

The rack-limit veto (the legs of RackAwareGoal and
RackAwareDistributionGoal, from the partitions' per-rack counts: each
directed leg keeps ``others + 1 <= lim`` with the moving row's own limit,
``lim_out[i]`` or ``lim_in[j]``, the chain's minimum) and the topic veto
(TopicReplicaDistributionGoal's destination legs, ``tab[t, b] + 1 <=
up[t]``) come as per-row limits and a per-topic table; every row-only part
of a veto is folded into ``row_ok_out`` / ``row_ok_in``.

Families (``SWAP_*``): resource distribution ``_gain(u[bo], u[bi], net,
...) x 0.95`` over ``fb`` = (util, lower, upper) f32[3, B]; topic replica
``(g_out + g_in) x 0.95`` with the same-topic exclusion over the per-topic
limits ``tl`` = (lower, upper) f32[2, T] and the [T, B] count table.

CUDA kernels (``csrc/swap.cu``): ``swap_rows`` runs one CTA per out row i
with one thread per in candidate j (K2 <= 128); the scores go to shared
memory and one thread scans them with a strict '>' (lowest j wins ties).
``swap_admission`` runs one CTA with one thread per sorted row and an
O(K1^2) pairwise check, exact in integers and free of atomics. Bound:
latency: at [32, 32] the work is a few kilobytes and ~1e4 operations, far
below one launch's overhead.

``swap_rows_lanes`` and ``swap_admission_lanes`` are the fleet's lane forms
(K14): La lanes' solo arguments stacked into [La, ...] tensors (the broker
racks and topic counts read from a lane stack's rows at a lane index list),
ONE launch each (grid dimension y = lane); each lane's result is its solo
launch's. Their twins loop the solo twins over the lanes. ``swap_rows`` and
``swap_admission`` are the same launches with one lane.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, lane_index, lane_operand, library, ptr, register, stream_ptr,
)

KERNEL_ROWS = register("swap_rows", "cruise_control_tpu_torch/kernels/csrc/swap.cu",
                       "cruise_control_tpu/analyzer/engine.py:1129")
KERNEL_ADMISSION = register("swap_admission",
                            "cruise_control_tpu_torch/kernels/csrc/swap.cu",
                            "cruise_control_tpu/analyzer/engine.py:1146")
KERNEL_ROWS_LANES = register("swap_rows_lanes",
                             "cruise_control_tpu_torch/kernels/csrc/swap.cu",
                             "cruise_control_tpu/analyzer/engine.py:2324")
KERNEL_ADMISSION_LANES = register("swap_admission_lanes",
                                  "cruise_control_tpu_torch/kernels/csrc/swap.cu",
                                  "cruise_control_tpu/analyzer/engine.py:2324")

SWAP_RESOURCE_DIST = 0   # ResourceDistributionGoal (the four usage goals)
SWAP_TOPIC_REPLICA = 1   # TopicReplicaDistributionGoal

VETO_NET_CAPACITY = 0
VETO_NET_BAND = 1
VETO_DIRECTED = 2
VETO_DIRECTED_EXEMPT = 3

MAX_K2 = 128
MAX_K1 = 1024
MAX_F = 64
MAX_V = 16          # the veto kinds travel as 2 bits each in one int
F32 = ctypes.c_float


@dataclasses.dataclass
class SwapVeto:
    """One previous goal's ``accept_swap`` term (see the module doc)."""
    kind: int
    a: torch.Tensor                     # f32[B]
    c: torch.Tensor                     # f32[B]
    x_out: torch.Tensor                 # f32[K1]
    x_in: torch.Tensor                  # f32[K2]
    lo: torch.Tensor | None = None      # f32[B] (VETO_NET_BAND)


@dataclasses.dataclass
class SwapAccept:
    """A goal's ``accept_swap`` as a previously optimized goal: row-only
    parts, vetoes, the rack limits of both sides' rows (None: no rack
    veto) and the topic veto's per-topic upper limit (None: no topic
    veto)."""
    row_out: torch.Tensor | None = None     # bool[K1]
    row_in: torch.Tensor | None = None      # bool[K2]
    vetoes: list = dataclasses.field(default_factory=list)
    lim_out: torch.Tensor | None = None     # i32[K1]
    lim_in: torch.Tensor | None = None      # i32[K2]
    topic_up: torch.Tensor | None = None    # f32[T]


@dataclasses.dataclass
class SwapTables:
    """The active goal's ``swap_score`` in family form."""
    family: int
    fb: torch.Tensor | None = None      # f32[3, B] util, lower, upper
    x_out: torch.Tensor | None = None   # f32[K1] out rows' load
    x_in: torch.Tensor | None = None    # f32[K2] in rows' load
    tl: torch.Tensor | None = None      # f32[2, T] per-topic lower, upper


@dataclasses.dataclass
class SwapPairs:
    """Row-level inputs of the pair stage. ``sib_*`` i64[K, F] hold the
    brokers of the other replicas of each row's partition (-1 padded);
    ``row_ok_*`` the row-level legitimacy, ``kv > -inf`` and the folded
    row-only vetoes; ``new_ok`` bool[B] the new-broker rule's brokers (all
    true when the cluster has no new broker, else the new ones; a leg may
    also go back to the moving replica's original broker); ``prow_*``
    i64[K, racks] the per-rack replica counts of each row's partition and
    ``lim_*`` i32[K] its rack limit (rack veto, else None); ``t_*`` the
    rows' topics and ``tab`` i32[T, B] the (topic, broker) replica
    counts."""
    b_out: torch.Tensor
    b_in: torch.Tensor
    sib_out: torch.Tensor
    sib_in: torch.Tensor
    orig_out: torch.Tensor
    orig_in: torch.Tensor
    row_ok_out: torch.Tensor
    row_ok_in: torch.Tensor
    new_ok: torch.Tensor
    broker_rack: torch.Tensor
    t_out: torch.Tensor
    t_in: torch.Tensor
    tab: torch.Tensor
    prow_out: torch.Tensor | None = None
    prow_in: torch.Tensor | None = None
    lim_out: torch.Tensor | None = None
    lim_in: torch.Tensor | None = None
    vetoes: list = dataclasses.field(default_factory=list)
    topic_up: torch.Tensor | None = None


def _violation(u, lower, upper):
    return torch.clamp(u - upper, min=0.0) + torch.clamp(lower - u, min=0.0)


def gain_plain(us, ud, l, los, ups, lod, upd):
    """``distribution._gain``: (gain, feasible) of moving ``l`` src -> dst."""
    vso = _violation(us, los, ups)
    vdo = _violation(ud, lod, upd)
    vsn = _violation(us - l, los, ups)
    vdn = _violation(ud + l, lod, upd)
    return (vso - vsn) + (vdo - vdn), (vsn <= vso) & (vdn <= vdo)


def legit_plain(p: SwapPairs) -> torch.Tensor:
    """bool[K1, K2]: ``legit_swap_mask`` from the row inputs."""
    bo, bi = p.b_out[:, None], p.b_in[None, :]
    ok = bo != bi
    ok = ok & ~(p.sib_out[:, :, None] == p.b_in[None, None, :]).any(dim=1)
    ok = ok & ~(p.sib_in[:, :, None] == p.b_out[None, None, :]).any(dim=1).T
    ok = ok & ((p.new_ok[p.b_in][None, :] | (bi == p.orig_out[:, None]))
               & (p.new_ok[p.b_out][:, None] | (bo == p.orig_in[None, :])))
    return ok & p.row_ok_out[:, None] & p.row_ok_in[None, :]


def vetoes_plain(p: SwapPairs) -> torch.Tensor:
    """bool[K1, K2]: the folded vetoes, rack and topic legs."""
    bo, bi = p.b_out, p.b_in
    ok = torch.ones((bo.shape[0], bi.shape[0]), dtype=torch.bool, device=bo.device)
    for v in p.vetoes:
        xo, xi = v.x_out[:, None], v.x_in[None, :]
        if v.kind == VETO_NET_CAPACITY:
            net = xo - xi
            ok = ok & ((v.a[bo][:, None] - net) <= v.c[bo][:, None])
            ok = ok & ((v.a[bi][None, :] + net) <= v.c[bi][None, :])
        elif v.kind == VETO_NET_BAND:
            _g, feas = gain_plain(v.a[bo][:, None], v.a[bi][None, :], xo - xi,
                                  v.lo[bo][:, None], v.c[bo][:, None],
                                  v.lo[bi][None, :], v.c[bi][None, :])
            ok = ok & feas
        else:
            leg_out = (v.a[bi][None, :] + xo) <= v.c[bi][None, :]
            leg_in = (v.a[bo][:, None] + xi) <= v.c[bo][:, None]
            if v.kind == VETO_DIRECTED_EXEMPT:
                leg_out = leg_out | (xo == 0)
                leg_in = leg_in | (xi == 0)
            ok = ok & leg_out & leg_in
    if p.prow_out is not None:
        r_o, r_i = p.broker_rack[bo], p.broker_rack[bi]
        same = (r_o[:, None] == r_i[None, :]).to(p.prow_out.dtype)
        out_leg = p.prow_out[:, r_i] - same
        in_leg = p.prow_in[:, r_o].T - same
        ok = ok & (out_leg + 1 <= p.lim_out[:, None]) & (in_leg + 1 <= p.lim_in[None, :])
    if p.topic_up is not None:
        c_oi = p.tab[p.t_out[:, None], bi[None, :]].to(torch.float32)
        c_io = p.tab[p.t_in[None, :], bo[:, None]].to(torch.float32)
        ok = ok & ((c_oi + 1.0) <= p.topic_up[p.t_out][:, None])
        ok = ok & ((c_io + 1.0) <= p.topic_up[p.t_in][None, :])
    return ok


def family_score_plain(p: SwapPairs, t: SwapTables) -> torch.Tensor:
    """f32[K1, K2] the family's score (no legitimacy)."""
    bo, bi = p.b_out, p.b_in
    neg = torch.full((bo.shape[0], bi.shape[0]), -torch.inf, dtype=torch.float32,
                     device=bo.device)
    if t.family == SWAP_RESOURCE_DIST:
        u, lo, up = t.fb[0], t.fb[1], t.fb[2]
        net = t.x_out[:, None] - t.x_in[None, :]
        gain, feas = gain_plain(u[bo][:, None], u[bi][None, :], net,
                                lo[bo][:, None], up[bo][:, None],
                                lo[bi][None, :], up[bi][None, :])
        return torch.where(feas & (gain > 0), gain * 0.95, neg)
    if t.family == SWAP_TOPIC_REPLICA:
        to, ti = p.t_out, p.t_in
        lower, upper = t.tl[0], t.tl[1]
        c = p.tab.to(torch.float32)

        def viol(cc, lo, up):
            return torch.clamp(cc - up, min=0.0) + torch.clamp(lo - cc, min=0.0)

        lo_o, up_o = lower[to][:, None], upper[to][:, None]
        c_oo = c[to, bo][:, None]
        c_oi = c[to[:, None], bi[None, :]]
        g_out = (viol(c_oo, lo_o, up_o) - viol(c_oo - 1.0, lo_o, up_o)
                 + viol(c_oi, lo_o, up_o) - viol(c_oi + 1.0, lo_o, up_o))
        nv_out = ((viol(c_oo - 1.0, lo_o, up_o) > viol(c_oo, lo_o, up_o))
                  | (viol(c_oi + 1.0, lo_o, up_o) > viol(c_oi, lo_o, up_o)))
        lo_i, up_i = lower[ti][None, :], upper[ti][None, :]
        c_ii = c[ti, bi][None, :]
        c_io = c[ti[None, :], bo[:, None]]
        g_in = (viol(c_ii, lo_i, up_i) - viol(c_ii - 1.0, lo_i, up_i)
                + viol(c_io, lo_i, up_i) - viol(c_io + 1.0, lo_i, up_i))
        nv_in = ((viol(c_ii - 1.0, lo_i, up_i) > viol(c_ii, lo_i, up_i))
                 | (viol(c_io + 1.0, lo_i, up_i) > viol(c_io, lo_i, up_i)))
        gain = g_out + g_in
        feas = ~nv_out & ~nv_in & (to[:, None] != ti[None, :])
        return torch.where(feas & (gain > 0), gain * 0.95, neg)
    raise ValueError(f"unknown swap family {t.family}")


def swap_scores_plain(p: SwapPairs, t: SwapTables) -> torch.Tensor:
    """f32[K1, K2]: the masked pair scores."""
    ok = legit_plain(p) & vetoes_plain(p)
    score = family_score_plain(p, t)
    return torch.where(ok, score, torch.full_like(score, -torch.inf))


def swap_rows_plain(p: SwapPairs, t: SwapTables, min_gain: float):
    sc = swap_scores_plain(p, t)
    best = sc.max(dim=1).values
    return best, torch.argmax(sc, dim=1), (sc > min_gain).sum(dim=1).to(torch.int32)


def swap_admission_plain(val, b_out, b_in, j, p_out, p_in, min_gain: float):
    ok = val > min_gain
    n = val.shape[0]
    posn = torch.arange(n, device=val.device)
    earlier = posn[None, :] < posn[:, None]                   # [p, q]: q < p

    def meet(x, y):
        return x[:, None] == y[None, :]

    share = (meet(b_out, b_out) | meet(b_out, b_in) | meet(b_in, b_out)
             | meet(b_in, b_in) | meet(j, j) | meet(p_out, p_out)
             | meet(p_out, p_in) | meet(p_in, p_out) | meet(p_in, p_in))
    return ok & ~(earlier & share & ok[None, :]).any(dim=1)


_SIGNATURES = {
    "cc_swap_rows_lanes": [I] * 11 + [F32] + [P] * 32,
    "cc_swap_admission_lanes": [I, I, F32] + [P] * 8,
}

_I64, _F32, _BOOL, _I32 = torch.int64, torch.float32, torch.bool, torch.int32


def _check_inputs(what: str, pairs):
    for t, dt in pairs:
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError(f"{what}: wrong dtype, layout or device")


def _check_lane(p: SwapPairs, t: SwapTables, what: str) -> None:
    """The argument checks of one lane's (``SwapPairs``, ``SwapTables``)."""
    K1, K2 = p.b_out.shape[0], p.b_in.shape[0]
    F = p.sib_out.shape[1]
    V = len(p.vetoes)
    if not (0 < K1 <= MAX_K1 and 0 < K2 <= MAX_K2 and F <= MAX_F
            and p.sib_in.shape[1] == F and V <= MAX_V):
        raise ValueError(f"{what}: unsupported K1={K1} K2={K2} F={F} V={V}")
    if any(v.kind not in (VETO_NET_CAPACITY, VETO_NET_BAND, VETO_DIRECTED,
                          VETO_DIRECTED_EXEMPT) for v in p.vetoes):
        raise ValueError(f"{what}: unknown veto kind")
    rack = (p.prow_out, p.prow_in, p.lim_out, p.lim_in)
    if any(x is None for x in rack) != all(x is None for x in rack):
        raise ValueError(f"{what}: the rack veto needs both prow tables and limits")
    if p.lim_out is not None and (p.lim_out.shape != (K1,) or p.lim_in.shape != (K2,)):
        raise ValueError(f"{what}: the rack limits are one per row")
    if t.family == SWAP_RESOURCE_DIST and (t.fb is None or t.x_out is None
                                           or t.x_in is None):
        raise ValueError(f"{what}: the resource family needs fb, x_out, x_in")
    if t.family == SWAP_TOPIC_REPLICA and t.tl is None:
        raise ValueError(f"{what}: the topic family needs tl")


def _lane_kinds(p: SwapPairs, t: SwapTables) -> tuple:
    """What the lanes of one launch must share: the family, the veto kinds
    and whether the topic and rack vetoes are on."""
    return (t.family, [v.kind for v in p.vetoes], p.topic_up is None, p.lim_out is None)


def _lane_shapes(p: SwapPairs) -> tuple:
    return (p.b_out.shape, p.b_in.shape, p.sib_out.shape, p.tab.shape,
            None if p.prow_out is None else p.prow_out.shape)


def _check_stacked(pairs: list, stacked, what: str) -> None:
    lanes, rack, tab = stacked
    if len(lanes) != len(pairs) or any(
            p.broker_rack.data_ptr() != rack[l].data_ptr()
            or p.tab.data_ptr() != tab[l].data_ptr() for p, l in zip(pairs, lanes)):
        raise ValueError(f"{what}: a lane's racks or topic counts are not its stack row")


def _rows_launch(pairs: list, tables: list, min_gain: float, stacked, what: str):
    """The one ``swap_rows`` launch behind both wrappers: La =
    ``len(pairs)`` lanes, the broker racks and (topic, broker) counts read
    from ``stacked``'s rows at its lane index list, or (``stacked`` None)
    one lane, the solo launch, its operands as they are. Returns (best,
    best_j, positives), with a leading lane axis when La > 1."""
    La = len(pairs)
    head_p, head_t = pairs[0], tables[0]
    shapes = _lane_shapes(head_p)
    for p, t in zip(pairs, tables):
        _check_lane(p, t, what)
        if _lane_shapes(p) != shapes:
            raise ValueError(f"{what}: lanes disagree on a shape")
    K1, K2 = head_p.b_out.shape[0], head_p.b_in.shape[0]
    F = head_p.sib_out.shape[1]
    Tn, B = head_p.tab.shape
    V = len(head_p.vetoes)
    Kr = head_p.prow_out.shape[1] if head_p.prow_out is not None else 0
    dev = head_p.b_out.device

    def per_lane(get):
        return lane_operand([get(p, t) for p, t in zip(pairs, tables)], what)

    if stacked is None:
        rack, tab, lanes_t = head_p.broker_rack, head_p.tab, None
    else:
        lanes, rack, tab = stacked
        lanes_t = lane_index(lanes, dev)
    va = vc = vl = vxo = vxi = None
    vkinds = sum(v.kind << (2 * i) for i, v in enumerate(head_p.vetoes))
    if V:
        # one stack per field for every lane's vetoes: [La * V, ...]
        vetoes = [v for p in pairs for v in p.vetoes]
        va = torch.stack([v.a for v in vetoes]).contiguous()
        vc = torch.stack([v.c for v in vetoes]).contiguous()
        vl = torch.stack([v.a if v.lo is None else v.lo for v in vetoes]).contiguous()
        vxo = torch.stack([v.x_out for v in vetoes]).contiguous()
        vxi = torch.stack([v.x_in for v in vetoes]).contiguous()
    fields = ("b_out", "b_in", "sib_out", "sib_in", "orig_out", "orig_in", "row_ok_out",
              "row_ok_in", "new_ok")
    tensors = ([per_lane(lambda p, t, f=f: getattr(p, f)) for f in fields] + [rack]
               + [per_lane(lambda p, t, f=f: getattr(p, f))
                  for f in ("prow_out", "prow_in", "lim_out", "lim_in", "t_out", "t_in")]
               + [tab, va, vc, vl, vxo, vxi]
               + [per_lane(lambda p, t, f=f: getattr(t, f))
                  for f in ("fb", "x_out", "x_in", "tl")]
               + [per_lane(lambda p, t: p.topic_up)])
    _check_inputs(what, zip(tensors, (
        _I64, _I64, _I64, _I64, _I64, _I64, _BOOL, _BOOL, _BOOL, _I64, _I64, _I64,
        _I32, _I32, _I64, _I64, _I32, _F32, _F32, _F32, _F32, _F32, _F32, _F32, _F32,
        _F32, _F32)))
    lead = (La,) if La > 1 else ()
    best = torch.empty(lead + (K1,), dtype=_F32, device=dev)
    best_j = torch.empty(lead + (K1,), dtype=_I64, device=dev)
    cnt = torch.empty(lead + (K1,), dtype=_I32, device=dev)
    err = library("swap", _SIGNATURES).cc_swap_rows_lanes(
        La, K1, K2, F, B, Tn, Kr, int(head_t.family), V,
        int(head_p.topic_up is not None), vkinds, float(min_gain), ptr(lanes_t),
        *(ptr(x) for x in tensors), ptr(best), ptr(best_j), ptr(cnt), stream_ptr())
    check(err, what)
    return best, best_j, cnt


def swap_rows(p: SwapPairs, t: SwapTables, min_gain: float, what: str = "pass"):
    """(best f32[K1], best_j i64[K1], positives i32[K1]) of the masked
    [K1, K2] pair scores: per out row the best value, its lowest argmax j
    and the count of pairs scoring above ``min_gain``. ``what`` names the
    caller in the launch count's shape key (``pass`` for a swap pass,
    ``window`` for the certificate's window). The one-lane launch of
    ``swap_rows_lanes``' kernel."""
    if not p.b_out.is_cuda:
        return swap_rows_plain(p, t, min_gain)
    out = _rows_launch([p], [t], min_gain, None, "swap_rows")
    KERNEL_ROWS.count(f"{what} [{p.b_out.shape[0]}, {p.b_in.shape[0]}]")
    return out


def swap_rows_lanes_plain(pairs: list, tables: list, min_gain: float):
    outs = [swap_rows_plain(p, t, min_gain) for p, t in zip(pairs, tables)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def swap_rows_lanes(pairs: list, tables: list, min_gain: float, stacked: tuple):
    """(best f32[La, K1], best_j i64[La, K1], positives i32[La, K1]):
    ``swap_rows`` of each lane's (``SwapPairs``, ``SwapTables``) in one
    launch. The lanes must agree on the family, the veto kinds, the rack
    and topic vetoes' presence and every shape. ``stacked`` = (the lanes'
    indices in their lane stack, its i64[L, B] ``broker_rack``, its i32[L,
    T, B] ``topic_broker_count``): each lane's ``broker_rack`` / ``tab``
    must be its stack row, which the kernel reads at the index instead of a
    new stack."""
    _check_stacked(pairs, stacked, "swap_rows_lanes")
    kinds = _lane_kinds(pairs[0], tables[0])
    if any(_lane_kinds(p, t) != kinds for p, t in zip(pairs[1:], tables[1:])):
        raise ValueError("swap_rows_lanes: lanes disagree on the family or the vetoes")
    if not pairs[0].b_out.is_cuda:
        return swap_rows_lanes_plain(pairs, tables, min_gain)
    La, K1 = len(pairs), pairs[0].b_out.shape[0]
    best, best_j, cnt = _rows_launch(pairs, tables, min_gain, stacked, "swap_rows_lanes")
    KERNEL_ROWS_LANES.count(f"L={La} [{K1}, {pairs[0].b_in.shape[0]}]")
    return best.view(La, K1), best_j.view(La, K1), cnt.view(La, K1)


def _admission_launch(val, rows: list, min_gain: float, what: str):
    """The one ``swap_admission`` launch behind both wrappers: ``val`` f32
    and ``rows`` i64, each [K1] (one lane) or [La, K1]."""
    La, n = (1, val.shape[0]) if val.dim() == 1 else val.shape
    if not 0 < n <= MAX_K1:
        raise ValueError(f"{what}: unsupported K1={n}")
    _check_inputs(what, [(val, _F32)] + [(x, _I64) for x in rows])
    if any(x.shape != val.shape for x in rows):
        raise ValueError(f"{what}: every input has one value per row")
    win = torch.empty(val.shape, dtype=_BOOL, device=val.device)
    err = library("swap", _SIGNATURES).cc_swap_admission_lanes(
        La, n, float(min_gain), ptr(val), *(ptr(x) for x in rows), ptr(win),
        stream_ptr())
    check(err, what)
    return win


def swap_admission(val, b_out, b_in, j, p_out, p_in, min_gain: float):
    """bool[K1] winners of one score-sorted swap wave (see the module doc).
    Every input is per sorted row: ``val`` f32, the rest i64. The one-lane
    launch of ``swap_admission_lanes``' kernel."""
    if not val.is_cuda:
        return swap_admission_plain(val, b_out, b_in, j, p_out, p_in, min_gain)
    win = _admission_launch(val, [b_out, b_in, j, p_out, p_in], min_gain,
                            "swap_admission")
    KERNEL_ADMISSION.count(f"K1={val.shape[0]}")
    return win


def swap_admission_lanes_plain(val, b_out, b_in, j, p_out, p_in, min_gain: float):
    return torch.stack([swap_admission_plain(val[i], b_out[i], b_in[i], j[i], p_out[i],
                                             p_in[i], min_gain)
                        for i in range(val.shape[0])])


def swap_admission_lanes(val, b_out, b_in, j, p_out, p_in, min_gain: float):
    """bool[La, K1]: ``swap_admission`` of each lane's score-sorted wave
    (every input [La, K1]: ``val`` f32, the rest i64) in one launch."""
    if not val.is_cuda:
        return swap_admission_lanes_plain(val, b_out, b_in, j, p_out, p_in, min_gain)
    if val.dim() != 2:
        raise ValueError("swap_admission_lanes: every input is [La, K1]")
    win = _admission_launch(val, [b_out, b_in, j, p_out, p_in], min_gain,
                            "swap_admission_lanes")
    KERNEL_ADMISSION_LANES.count(f"L={val.shape[0]} K1={val.shape[1]}")
    return win
