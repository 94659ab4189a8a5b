"""K3 ``wave_admission``: budgeted wave admission of one sorted move wave.

Replaces ``cruise_control_tpu/analyzer/engine.py`` ``_wave_admission``
(:555), ``_group_cumsum`` (:648) and the partition first-touch of
``_move_wave`` (:846-851). In score order a row is admitted iff it is the
first wave row of its partition, its per-source and per-destination
cumulative deltas (rank-0 rows exempt) stay within the chain's combined
slack (+1e-4), and the active goal still has gain budget at one endpoint
(or the row escapes the cap, e.g. offline healing).

``_group_cumsum`` takes a GLOBAL inclusive cumsum in stable group order and
subtracts the prefix before each group start. The CPU oracle's XLA lowers
``jnp.cumsum`` through its reduce-window rewriter: rows in blocks of 16,
each block scanned left to right, the block totals scanned the same way
(recursively), and the exclusive block prefix added back. ``xla_cumsum``
reproduces that order exactly, so the sums match the oracle bit for bit.

CUDA kernel (``csrc/wave_admission.cu``): one CTA for the whole wave
(K <= 2048): bitonic sort of (group, row) keys in shared memory, the XLA-order
scan, ranks by walking back to the group start, O(K^2/2) partition
first-touch. Bound: operations are trivial; it is latency-bound (one CTA).
"""
from __future__ import annotations

import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, library, ptr, register, stream_ptr,
)

KERNEL = register("wave_admission",
                  "cruise_control_tpu_torch/kernels/csrc/wave_admission.cu",
                  "cruise_control_tpu/analyzer/engine.py:555")
MAX_K = 2048
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


def wave_admission_plain(d, src_b, dst_b, wave_ok, part, src_slack, dst_slack,
                         gain, gain_escape):
    K = d.shape[0]
    B = src_slack.shape[0]
    posn = torch.arange(K, device=d.device)
    # partition first-touch: the first wave row of each partition
    inf = K + 1
    guarded = torch.where(wave_ok, posn, inf)
    P = int(part.max()) + 1 if K else 1
    first = torch.full((P,), inf, dtype=torch.int64, device=d.device)
    first = first.scatter_reduce(0, part, guarded, reduce="amin")
    part_ok = first[part] == posn
    dd = torch.where(wave_ok[:, None], d, torch.zeros_like(d))
    cum_src, rank_src = group_cumsum(torch.where(wave_ok, src_b, B + posn), dd)
    cum_dst, rank_dst = group_cumsum(torch.where(wave_ok, dst_b, B + posn), dd)
    src_fit = (rank_src == 0) | (cum_src <= src_slack[src_b] + 1e-4).all(dim=1)
    dst_fit = (rank_dst == 0) | (cum_dst <= dst_slack[dst_b] + 1e-4).all(dim=1)
    win = part_ok & wave_ok & src_fit & dst_fit
    if gain is not None:
        src_gain, dst_gain, dim = gain
        excl_src = cum_src[:, dim] - dd[:, dim]
        excl_dst = cum_dst[:, dim] - dd[:, dim]
        sg, dg = src_gain[src_b], dst_gain[dst_b]
        gain_ok = (((sg > 0) & (excl_src < sg)) | ((dg > 0) & (excl_dst < dg))
                   | gain_escape)
        win = win & gain_ok
    return win


_SIGNATURES = {"cc_wave_admission": [I] * 4 + [P] * 14}


def wave_admission(d, src_b, dst_b, wave_ok, part, src_slack, dst_slack,
                   gain, gain_escape):
    """bool[K] admitted rows of a score-sorted move wave (partition
    first-touch included). ``d`` f32[K, 8] deltas; ``src_b``/``dst_b``/
    ``part`` i64[K]; ``wave_ok``/``gain_escape`` bool[K]; ``*_slack``
    f32[B, 8] combined chain slack; ``gain`` = (src_gain f32[B], dst_gain
    f32[B], dim) of the active goal, or None."""
    if not d.is_cuda:
        return wave_admission_plain(d, src_b, dst_b, wave_ok, part, src_slack,
                                    dst_slack, gain, gain_escape)
    K = d.shape[0]
    B = src_slack.shape[0]
    if not 0 < K <= MAX_K or d.shape[1] != 8:
        raise ValueError(f"wave_admission supports 0 < K <= {MAX_K} rows of 8 dims")
    for t, dt in ((d, torch.float32), (src_b, torch.int64), (dst_b, torch.int64),
                  (wave_ok, torch.bool), (part, torch.int64),
                  (src_slack, torch.float32), (dst_slack, torch.float32),
                  (gain_escape, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("wave_admission: wrong dtype, layout or device")
    if gain is not None:
        src_gain, dst_gain, dim = gain
        src_gain, dst_gain = src_gain.contiguous(), dst_gain.contiguous()
    else:
        src_gain = dst_gain = None
        dim = -1
    m16 = -(-K // SCAN_BASE) * SCAN_BASE
    fscratch = torch.empty(m16 * 8 + 2 * K * 8, dtype=torch.float32, device=d.device)
    iscratch = torch.empty(2 * K, dtype=torch.int32, device=d.device)
    win = torch.empty(K, dtype=torch.bool, device=d.device)
    err = library("wave_admission", _SIGNATURES).cc_wave_admission(
        K, B, int(dim), int(gain is not None), ptr(d), ptr(src_b), ptr(dst_b),
        ptr(wave_ok), ptr(part), ptr(src_slack), ptr(dst_slack), ptr(src_gain),
        ptr(dst_gain), ptr(gain_escape), ptr(fscratch), ptr(iscratch), ptr(win),
        stream_ptr())
    check(err, "wave_admission")
    KERNEL.launches += 1
    return win
