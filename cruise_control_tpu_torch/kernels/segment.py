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

``segment_count`` (integer tallies): ``out[s] = init[s] + sum(w[i])`` over
the rows with ``seg == s``; exact in any order. ``segment_counts`` takes up
to ``MAX_TALLIES`` of them in one launch: refresh's five tallies, a move
apply's five and a leadership apply's two are one CUDA launch each, where
they were two per tally (a ``zeros`` / ``clone`` of ``init``, then the
count). ``segment_count`` is its one-tally case.

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
0.056 against 0.236 ms). Bound: bytes.

``segment_counts``: one launch (``csrc/segment_sum.cu``), in one of two
forms that ``count_plan`` picks per call:

- the owned form (tallies of at most ``OWNED_ROWS`` rows and at most
  ``OWNED_READS`` row reads in all: the applies at 1,000 brokers): each
  block owns ``OWNED_SEGS`` segments of one tally, starts them from
  ``init`` in shared memory, streams all the tally's rows, counts those in
  its range and writes its range. No grid barrier, no global atomic; every
  block reads all N rows, so it serves small N over few segments only.
- the grid form (refresh, the severities): a cooperative launch that
  writes ``init`` (or zeros) into every output, synchronises the grid, then
  counts. A cooperative launch rather than a last-block ticket: the ticket
  needs a zeroed scratch and a counter that outlive the call (a second
  launch, or a persistent buffer shared by every caller), and its last
  block would add the whole of ``init`` alone. ``count_chunk`` plans each
  tally: a shared-memory histogram per chunk of ``SMEM_ROWS_PER_BIN *
  nseg`` rows (one block a chunk, one global atomic per non-zero bin) where
  that chunk is at most ``SMEM_AUTO_ROWS`` rows and the tally has one;
  warp-aggregated global atomics (one per distinct segment of a warp's 32
  rows) otherwise.

Rows of weight 0 are skipped in both. The cut-overs are the card's
(device time, NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6): a slice
apply's five tallies (3,520
rows) 0.0093 ms owned, 0.0192 ms on the grid; rung 4's (3,520 rows into 20
million partition x rack and 14.7 million topic x broker segments) 0.2665
ms owned, 0.1579 ms on the grid (the copy of ``init`` is its bound, 0.12
ms); a refresh's five at 114,688 rows 0.0236 ms on the grid, 0.0609 ms
owned. The histograms against global atomics for every tally, in one
process (``chip_smoke.py``'s A/B): a refresh's five tallies at 114,688
rows 0.034 against 0.048 ms, 114,688 rows of weight 1 into 1,024 brokers
0.008 against 0.020 ms; the same shape with mostly zero weights (the rack
goal's violating replicas) 0.008 against 0.005 ms (PERF.md section 6).
Bound: bytes (each id and weight read once, each output written once).
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
KERNEL_COUNTS = register("segment_counts",
                         "cruise_control_tpu_torch/kernels/csrc/segment_sum.cu",
                         "cruise_control_tpu/analyzer/state.py:158")
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


def segment_counts_plain(tallies):
    """``segment_count_plain`` of each (seg, nseg, weights, init)."""
    return [segment_count_plain(*t) for t in tallies]


class _Tally(ctypes.Structure):
    """One tally of ``cc_segment_counts`` (``csrc/segment_sum.cu`` Tally)."""
    _fields_ = [("seg", ctypes.c_void_p), ("w", ctypes.c_void_p),
                ("init", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("nseg", ctypes.c_longlong),
                ("chunk", ctypes.c_longlong)]


_SIGNATURES = {"cc_segment_sum": [P, P, I, I, I, P, P, P, LL, I, IP, P],
               "cc_segment_counts": [ctypes.POINTER(_Tally), I, I, IP, P]}
MAX_TALLIES = 5
# the forms of segment_counts: OWNED (the C entry point's ``owned`` flag:
# blocks own segment ranges and stream every row; at most OWNED_ROWS rows a
# tally) and GRID (the cooperative launch, each tally on a shared-memory
# histogram or on global atomics as ``count_chunk`` plans), which
# ``count_plan`` picks between; SMEM and GLOBAL are the grid form with
# every tally forced onto one of the two, for the checks and timings that
# hold each to the twin
OWNED, GRID, SMEM, GLOBAL = 0, 1, 2, 3
OWNED_ROWS = 16384
OWNED_SEGS = 2048          # segments a block of the owned form owns (csrc kOwnedSegs)
OWNED_READS = 1 << 22      # row reads of the owned form (its blocks x N) at most
SMEM_BINS = 12288          # csrc kSmemBins: 48 KB of int bins
SMEM_ROWS_PER_BIN = 4
SMEM_AUTO_ROWS = 4096


def count_chunk(n: int, nseg: int, form: int) -> int:
    """Rows per shared-memory chunk of a tally of ``n`` rows into ``nseg``
    segments in ``form``, 0 for global atomics (and in the owned form):
    GRID takes a chunk of ``SMEM_ROWS_PER_BIN * nseg`` rows where that is
    at most ``SMEM_AUTO_ROWS`` and the tally has that many rows; SMEM
    forces one (``nseg <= SMEM_BINS``), GLOBAL none."""
    chunk = SMEM_ROWS_PER_BIN * nseg
    if form in (OWNED, GLOBAL):
        return 0
    if form == SMEM:
        if nseg > SMEM_BINS:
            raise ValueError(f"segment_counts: nseg {nseg} exceeds {SMEM_BINS} "
                             f"shared-memory bins")
        return chunk
    return chunk if chunk <= SMEM_AUTO_ROWS and n >= chunk else 0


def count_plan(tallies) -> int:
    """The form of one ``segment_counts`` launch: OWNED while every tally
    has at most OWNED_ROWS rows and its blocks read at most OWNED_READS
    rows in all (every block streams its tally's rows: the applies at
    1,000 brokers); GRID otherwise (refresh, the severities, and the
    applies at 7,000 brokers, whose partition x rack and topic x broker
    tallies span millions of segments, so copying init is the work)."""
    if max(t[0].shape[0] for t in tallies) > OWNED_ROWS:
        return GRID
    reads = sum(-(-nseg // OWNED_SEGS) * seg.shape[0] for seg, nseg, _w, _i in tallies)
    return OWNED if reads <= OWNED_READS else GRID


def pack_tallies(tallies, outs, form: int):
    """The ``cc_segment_counts`` descriptor array of ``tallies`` ((seg,
    nseg, weights, init) each) writing into ``outs``, for ``form``."""
    arr = (_Tally * len(tallies))()
    for d, (seg, nseg, w, init), out in zip(arr, tallies, outs):
        n = seg.shape[0]
        d.seg, d.w, d.init, d.out = (0 if t is None else t.data_ptr()
                                     for t in (seg, w, init, out))
        d.n, d.nseg, d.chunk = n, nseg, count_chunk(n, nseg, form)
    return arr


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


def _counts(tallies, kernel, shape: str, form: int | None):
    if not 0 < len(tallies) <= MAX_TALLIES:
        raise ValueError(f"segment_counts takes 1..{MAX_TALLIES} tallies, got {len(tallies)}")
    for seg, nseg, w, init in tallies:
        for t, dt in ((seg, torch.int64), (w, torch.int32), (init, torch.int32)):
            if t is not None and (t.dtype != dt or not t.is_contiguous() or not t.is_cuda):
                raise ValueError("segment_count: wrong dtype, layout or device")
        if seg.dim() != 1 or nseg <= 0:
            raise ValueError(f"segment_count: seg must be 1-D and nseg > 0, got {nseg}")
        if w is not None and w.shape != seg.shape:
            raise ValueError("segment_count: weights must match seg")
        if init is not None and tuple(init.shape) != (nseg,):
            raise ValueError("segment_count: init must be [nseg]")
    dev = tallies[0][0].device
    outs = [torch.empty(nseg, dtype=torch.int32, device=dev) for _s, nseg, _w, _i in tallies]
    form = count_plan(tallies) if form is None else form
    arr = pack_tallies(tallies, outs, form)
    launches = ctypes.c_int(0)
    err = library("segment_sum", _SIGNATURES).cc_segment_counts(
        arr, len(tallies), int(form == OWNED), ctypes.byref(launches), stream_ptr())
    check(err, f"segment_count (step {-launches.value})" if err else "segment_count")
    kernel.count(shape, launches.value)
    return outs


def segment_counts(tallies) -> list:
    """[i32[nseg]] of each (seg i64[N], nseg, weights i32[N] or None, init
    i32[nseg] or None) in ``tallies`` (at most ``MAX_TALLIES``), in one
    launch: ``init`` (or zeros) plus the weights (or ones) per segment; rows
    outside [0, nseg) are skipped."""
    return _segment_counts(tallies, None)


def _segment_counts(tallies, form: int | None) -> list:
    """``segment_counts`` in ``form`` (OWNED, GRID, SMEM or GLOBAL; None:
    ``count_plan``'s), for the checks and timings that hold each form to the
    twin."""
    if not tallies[0][0].is_cuda:
        return segment_counts_plain(tallies)
    return _counts(tallies, KERNEL_COUNTS,
                   f"tallies={len(tallies)} N={tallies[0][0].shape[0]}", form)


def segment_count(seg: torch.Tensor, nseg: int, weights: torch.Tensor | None = None,
                  init: torch.Tensor | None = None) -> torch.Tensor:
    """i32[nseg]: ``init`` (or zeros) plus ``weights`` (or ones) i32[N] per
    segment ``seg`` i64[N]; rows outside [0, nseg) are skipped. The
    one-tally case of ``segment_counts``."""
    if not seg.is_cuda:
        return segment_count_plain(seg, nseg, weights, init)
    return _counts([(seg, nseg, weights, init)], KERNEL_COUNT,
                   f"N={seg.shape[0]} nseg={nseg}", None)[0]
