"""K4/K5 ``segment_sum`` and ``segment_count``: the deterministic segment
sums of the state refresh and of the batched move apply.

Replace ``cruise_control_tpu/analyzer/state.py`` ``refresh`` (:142) /
``_init_packed`` (:116) and the scatters of ``apply_moves_batched`` (:332)
with ``_kahan_scatter2`` (:83).

``segment_sum`` (floats): ``out[s] = (((init[s] + v_a) + v_b) + ...)`` over
the rows with ``seg == s`` in row order — the order of the CPU oracle's
scatter-add, which applies updates one by one. A chained
``acc.at[a].add(da).at[b].add(db)`` is one call over the concatenated rows.
Rows with ``seg < 0`` are skipped (a masked apply row adds zero).
No float atomics: runs are bit-identical run to run.

``segment_count`` (integer tallies): integer atomics, exact in any order.

CUDA kernels (``csrc/segment_sum.cu``): ``segment_sum`` runs one CTA per
segment that streams the segment ids in tiles, compacts the tile's matching
rows in order (warp ballots) and accumulates them column by column in row
order; ``segment_count`` is one atomicAdd per row. Bound: bytes for
``segment_count``; ``segment_sum`` re-reads the ids once per segment
(O(N x segments) from L2), so it is far above its byte bound by design of
this first version.
"""
from __future__ import annotations

import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, library, ptr, register, stream_ptr,
)

KERNEL_SUM = register("segment_sum",
                      "cruise_control_tpu_torch/kernels/csrc/segment_sum.cu",
                      "cruise_control_tpu/analyzer/state.py:83")
KERNEL_COUNT = register("segment_count",
                        "cruise_control_tpu_torch/kernels/csrc/segment_sum.cu",
                        "cruise_control_tpu/analyzer/state.py:142")
MAX_COLS = 32


def segment_sum_plain(values, seg, nseg, init=None):
    """Ordered per-segment accumulation: step j adds each segment's j-th row
    (one row per segment per step, so every add is a plain f32 add)."""
    C = values.shape[1]
    acc = (torch.zeros((nseg, C), dtype=torch.float32, device=values.device)
           if init is None else init.clone())
    keep = (seg >= 0) & (seg < nseg)
    rows = torch.nonzero(keep).flatten()
    s = seg[rows]
    order = torch.argsort(s, stable=True)
    rows, s = rows[order], s[order]
    if rows.numel() == 0:
        return acc
    counts = torch.bincount(s, minlength=nseg)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rows.numel(), device=values.device) - starts[s]
    # the rows grouped by rank: step j is one contiguous slice
    by_rank = torch.argsort(rank, stable=True)
    rows, s = rows[by_rank], s[by_rank]
    lo = 0
    for hi in torch.cumsum(torch.bincount(rank), 0).tolist():
        sj = s[lo:hi]
        acc[sj] = acc[sj] + values[rows[lo:hi]]
        lo = hi
    return acc


def segment_count_plain(seg, nseg, weights=None, init=None):
    out = (torch.zeros(nseg, dtype=torch.int32, device=seg.device)
           if init is None else init.clone())
    keep = (seg >= 0) & (seg < nseg)
    w = (torch.ones_like(seg, dtype=torch.int32) if weights is None
         else weights.to(torch.int32))
    return out.index_add_(0, seg[keep], w[keep])


_SIGNATURES = {"cc_segment_sum": [P, P, I, I, I, P, P, P],
               "cc_segment_count": [P, P, I, I, P, P]}


def segment_sum(values: torch.Tensor, seg: torch.Tensor, nseg: int,
                init: torch.Tensor | None = None) -> torch.Tensor:
    """f32[nseg, C]: ``init`` (or zeros) plus the rows of ``values`` f32[N, C]
    of each segment ``seg`` i64[N], added in row order."""
    if not values.is_cuda:
        return segment_sum_plain(values, seg, nseg, init)
    N, C = values.shape
    if C > MAX_COLS or nseg <= 0:
        raise ValueError(f"segment_sum supports 1..{MAX_COLS} columns, got {C}")
    for t, dt in ((values, torch.float32), (seg, torch.int64), (init, torch.float32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError("segment_sum: wrong dtype, layout or device")
    if init is not None and tuple(init.shape) != (nseg, C):
        raise ValueError("segment_sum: init must be [nseg, C]")
    out = torch.empty((nseg, C), dtype=torch.float32, device=values.device)
    err = library("segment_sum", _SIGNATURES).cc_segment_sum(
        ptr(values), ptr(seg), N, C, nseg, ptr(init), ptr(out), stream_ptr())
    check(err, "segment_sum")
    KERNEL_SUM.count(f"N={N} C={C} nseg={nseg}")
    return out


def segment_count(seg: torch.Tensor, nseg: int, weights: torch.Tensor | None = None,
                  init: torch.Tensor | None = None) -> torch.Tensor:
    """i32[nseg]: ``init`` (or zeros) plus ``weights`` (or ones) i32[N] per
    segment ``seg`` i64[N]; rows outside [0, nseg) are skipped."""
    if not seg.is_cuda:
        return segment_count_plain(seg, nseg, weights, init)
    for t, dt in ((seg, torch.int64), (weights, torch.int32), (init, torch.int32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError("segment_count: wrong dtype, layout or device")
    out = (torch.zeros(nseg, dtype=torch.int32, device=seg.device)
           if init is None else init.clone())
    err = library("segment_sum", _SIGNATURES).cc_segment_count(
        ptr(seg), ptr(weights), seg.shape[0], nseg, ptr(out), stream_ptr())
    check(err, "segment_count")
    KERNEL_COUNT.count(f"N={seg.shape[0]} nseg={nseg}")
    return out
