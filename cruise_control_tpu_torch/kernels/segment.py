"""K4/K5 ``segment_sum`` and ``segment_count``: the deterministic segment
sums of the state refresh and of the batched move apply.

Replace ``cruise_control_tpu/analyzer/state.py`` ``refresh`` (:142) /
``_init_packed`` (:116) and the scatters of ``apply_moves_batched`` (:332)
with ``_kahan_scatter2`` (:83).

``segment_sum`` (floats): ``out[s] = (((init[s] + v_a) + v_b) + ...)`` over
the rows with ``seg == s`` in row order — the order of the CPU oracle's
scatter-add, which applies updates one by one. A chained
``acc.at[a].add(da).at[b].add(db)`` is one call over the concatenated rows.
Rows with ``seg < 0`` or ``seg >= nseg`` are skipped (a masked apply row
adds zero). No float atomics: runs are bit-identical run to run.

``segment_count`` (integer tallies): integer atomics, exact in any order.

CUDA kernels (``csrc/segment_sum.cu``), two forms of ``segment_sum``, one
counted launch of the wrapper either way:

- the scan form, one CUDA launch: one CTA per segment streams every
  segment id, compacts its rows in order (warp ballots) and adds them
  column by column. It reads N ids per segment, O(N x nseg) from L2, so it
  serves the small products only: the move apply (3,520 rows -> 1,024
  segments), the leadership apply (256 -> 1,024), the swap legs (64 ->
  1,024) and the fleet's lane applies.
- the list form, ``3 p + 2`` CUDA launches for ``p`` radix passes (two up
  to 65,536 segments): a stable LSD radix sort of the row ids by segment
  builds every segment's row list once; a warp per segment (a CTA per
  segment longer than 256 rows) then adds each list in row order. Every id
  is read three times a pass and every value once; a long segment's chain
  of dependent adds is its floor (the padding rows all sit in segment 0).

The cut-over: the scan form while ``N * nseg`` is at most ``SCAN_FORM_MAX``
(2^25) and ``N`` at most ``SCAN_FORM_ROWS`` (32,768; each of its CTAs reads
all N ids, so a few segments of many rows would leave the card idle), the
list form otherwise. ``chip_smoke.py`` phase 3 times both forms at the main
path's shapes (device time per call, NVIDIA H100 80GB HBM3 at 700 W, PERF.md
§6): the scan form is faster up to 20,000 x 1,024 (0.040 against 0.045 ms)
and at every apply (0.003-0.028 ms against the list form's 0.026-0.046 ms,
whose 8 launches cost about 0.03 ms whatever the size); the list form from
40,000 x 1,024 (0.050 against 0.078 ms) up (refresh's 114,688 x 9 -> 1,024:
0.056 against 0.236 ms). ``segment_count`` is one atomicAdd per row. Bound:
bytes for both.
"""
from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch.kernels.build import (
    IP, LL, I, P, check, library, ptr, register, stream_ptr,
)

KERNEL_SUM = register("segment_sum",
                      "cruise_control_tpu_torch/kernels/csrc/segment_sum.cu",
                      "cruise_control_tpu/analyzer/state.py:83")
KERNEL_COUNT = register("segment_count",
                        "cruise_control_tpu_torch/kernels/csrc/segment_sum.cu",
                        "cruise_control_tpu/analyzer/state.py:142")
MAX_COLS = 32
# the cut-over (the module docstring): the scan form at most these
SCAN_FORM_MAX = 1 << 25
SCAN_FORM_ROWS = 1 << 15
SCAN, LIST = 0, 1


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


_SIGNATURES = {"cc_segment_sum": [P, P, I, I, I, P, P, P, LL, I, IP, P],
               "cc_segment_count": [P, P, I, I, P, P]}


def scratch_words(N: int) -> int:
    """int32 words of the list form's scratch (``csrc/segment_sum.cu``
    ``scratch_words``, which refuses a smaller one): keys and row ids twice,
    the 256-bin histogram of each 4,096-row tile, the valid-row count and
    the list of segments longer than 256 rows."""
    return 4 * N + 256 * -(-N // 4096) + 3 + 3 * (N // 256 + 1)


def form_for(N: int, nseg: int) -> int:
    """The form the wrapper launches for ``N`` rows into ``nseg`` segments."""
    return SCAN if N * nseg <= SCAN_FORM_MAX and N <= SCAN_FORM_ROWS else LIST


def segment_sum(values: torch.Tensor, seg: torch.Tensor, nseg: int,
                init: torch.Tensor | None = None, form: int | None = None) -> torch.Tensor:
    """f32[nseg, C]: ``init`` (or zeros) plus the rows of ``values`` f32[N, C]
    of each segment ``seg`` i64[N], added in row order. ``form`` (SCAN or
    LIST) overrides the cut-over, for the timings that set it."""
    if not values.is_cuda:
        return segment_sum_plain(values, seg, nseg, init)
    N, C = values.shape
    if not 0 < C <= MAX_COLS or nseg <= 0:
        raise ValueError(f"segment_sum supports 1..{MAX_COLS} columns, got {C}")
    for t, dt in ((values, torch.float32), (seg, torch.int64), (init, torch.float32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
            raise ValueError("segment_sum: wrong dtype, layout or device")
    if init is not None and tuple(init.shape) != (nseg, C):
        raise ValueError("segment_sum: init must be [nseg, C]")
    if form is None:
        form = form_for(N, nseg)
    out = torch.empty((nseg, C), dtype=torch.float32, device=values.device)
    scratch = (torch.empty(scratch_words(N), dtype=torch.int32, device=values.device)
               if form == LIST else None)
    launches = ctypes.c_int(0)
    err = library("segment_sum", _SIGNATURES).cc_segment_sum(
        ptr(values), ptr(seg), N, C, nseg, ptr(init), ptr(out), ptr(scratch),
        0 if scratch is None else scratch.numel(), form, ctypes.byref(launches),
        stream_ptr())
    check(err, "segment_sum")
    KERNEL_SUM.count(f"N={N} C={C} nseg={nseg}", launches.value)
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
