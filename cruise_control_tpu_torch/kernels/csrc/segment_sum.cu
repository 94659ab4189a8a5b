// K4/K5 segment_sum / segment_count: deterministic segment sums for the
// engine state's refresh and batched move apply.
//
// Replaces cruise_control_tpu/analyzer/state.py refresh (:142),
// _init_packed (:116), the scatters of apply_moves_batched (:332) and
// _kahan_scatter2 (:83). The CPU oracle's scatter-add applies updates one
// at a time in row order, so a segment's float sum is
//   ((init + v_first) + v_second) + ...
// segment_sum reproduces exactly that order without float atomics.
//
// Two forms, one launch sequence each; the wrapper picks one by N x nseg
// (kernels/segment.py holds the cut-over and the times behind it):
//
// The scan form (one launch, small N x nseg: the move, leadership and swap
// applies): one CTA (256 threads) per segment streams the segment ids in
// tiles of 256 rows, finds the tile's rows of its segment with warp
// ballots, compacts them in row order into shared memory, and threads
// c < C accumulate column c over them in order. Every CTA reads all N ids,
// so its cost is O(N x nseg): cheap only while that product is small.
//
// The list form (refresh's shapes, up to 1,048,576 rows and 28,672
// segments): the rows of each segment are put in one list, once, by a
// stable LSD radix sort of the row ids keyed by segment (8-bit digits, one
// pass per byte of nseg - 1: two passes up to 65,536 segments). Each pass
// is three launches: per-tile digit histograms (4,096 rows a tile), one
// exclusive scan of them (digit-major, so the scan gives every (digit,
// tile) its global offset), and a scatter whose rank inside the tile comes
// from warp match_any rounds in row order, so equal keys keep row order.
// Rows with seg < 0 or seg >= nseg never enter the lists. The sums then read
// each segment's ids in row order: one warp per segment (bounds by a
// 32-ary search of the sorted keys, a chunk of 32 rows' values staged in
// shared memory, lanes c < C adding column c), and one CTA per segment
// longer than kLong rows (the padding rows all sit in segment 0: 16,362 at
// R 114,688, 71,023 at rung 5), which stages chunks of rows with all its
// warps while warp 0 adds the previous chunk (64 KB of dynamic shared
// memory, its attribute set once per process). Every id is read three times
// per pass and every value once; the floor of a long segment is its chain
// of dependent f32 adds. No float atomics: the bits are the twin's, every
// run.
//
// segment_count: integer tallies, out[s] = init[s] + sum of w[i] over the
// rows with seg[i] == s, for up to five tallies in ONE launch (refresh's
// five, a move apply's five, a leadership apply's two; the single call is
// the one-tally case), in one of two forms (kernels/segment.py count_plan):
// - owned (small N, the applies): each block owns kOwnedSegs segments of
//   one tally, starts them from init in shared memory, streams all the
//   tally's rows and counts those in its range with shared atomics, then
//   writes its range: no grid barrier and no global atomic.
// - grid (refresh, the severities): one cooperative launch. Phase 1 writes
//   init (or zeros) into every output, grid-stride; a grid barrier
//   (cooperative groups, the launch sized to the blocks the card holds at
//   once, queried once per process, device and shared-memory size); phase 2
//   counts. A tally whose host plan gives it a chunk counts each chunk of
//   rows into a shared-memory histogram, one block a chunk, and flushes
//   each non-zero bin with one global atomic; the others use
//   warp-aggregated global atomics (__match_any_sync on the segment id, one
//   atomic per distinct segment of a warp's 32 rows).
// Rows of weight 0 add nothing and are skipped (refresh's padding rows all
// sit in segment 0 with weight 0). Integer atomics, exact in any order.
// Bound: bytes (each id and weight read once, each output written once).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// one tally of the grouped count; the host builds the array (ctypes
// mirrors this layout: kernels/segment.py _Tally)
struct Tally {
  const long long* seg;
  const int* w;        // nullptr: every row weighs 1
  const int* init;     // nullptr: zeros
  int* out;
  long long n;
  long long nseg;
  long long chunk;     // rows per shared-memory chunk; 0: global atomics
};

namespace {

constexpr int kMaxTallies = 5;
constexpr int kCountThreads = 256;
constexpr long long kSmemBins = 12288;   // 48 KB of int bins
constexpr int kSmemStep = 4096;          // the histograms' shared memory, rounded up to this
constexpr int kMaxDevices = 64;

struct Tallies {
  Tally t[kMaxTallies];
  int count;
};

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// --- the scan form --------------------------------------------------------
__global__ void segment_sum_scan(const float* __restrict__ vals,
                                 const long long* __restrict__ seg, int N, int C,
                                 const float* __restrict__ init,
                                 float* __restrict__ out) {
  __shared__ int rows[kThreads];
  __shared__ int wcount[kWarps];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float acc = 0.0f;
  if (tid < C && init != nullptr) acc = init[(long long)s * C + tid];
  for (int base = 0; base < N; base += kThreads) {
    const int i = base + tid;
    const bool hit = i < N && seg[i] == (long long)s;
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = wcount[w];
      if (w < warp) off += cnt;
      total += cnt;
    }
    if (hit) rows[off + __popc(ballot & ((1u << lane) - 1u))] = i;
    __syncthreads();
    if (tid < C) {
      for (int j = 0; j < total; ++j) acc = acc + vals[(long long)rows[j] * C + tid];
    }
    __syncthreads();
  }
  if (tid < C) out[(long long)s * C + tid] = acc;
}

// --- the list form: stable radix sort of the row ids by segment -----------
constexpr int kTile = 4096;              // rows of one radix tile
constexpr int kRounds = kTile / kThreads;  // 16 rounds of 32 rows per warp
constexpr int kWarpRows = kTile / kWarps;  // 512 consecutive rows per warp
constexpr int kBins = 256;
constexpr int kScanThreads = 1024;
constexpr int kLong = 256;               // longer segments: seg_sum_long
constexpr int kLongThreads = 512;
constexpr int kStage = 8192;             // floats per staging buffer
constexpr unsigned kNoKey = 0xFFFFFFFFu;

// the key of row i of a pass: pass 0 reads the segment ids (rows outside
// [0, nseg) have none), later passes the previous pass's sorted keys
__device__ __forceinline__ unsigned row_key(const long long* __restrict__ seg,
                                            const unsigned* __restrict__ keys,
                                            int limit, int nseg, int i) {
  if (i >= limit) return kNoKey;
  if (keys != nullptr) return keys[i];
  const long long s = seg[i];
  return (s >= 0 && s < nseg) ? (unsigned)s : kNoKey;
}

__global__ void radix_hist(const long long* __restrict__ seg,
                           const unsigned* __restrict__ keys,
                           const int* __restrict__ nvalid, int n, int nseg, int shift,
                           int ntiles, int* __restrict__ tilehist) {
  __shared__ int h[kBins];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int b = tid; b < kBins; b += kThreads) h[b] = 0;
  __syncthreads();
  const int limit = keys != nullptr ? *nvalid : n;
  const int base = blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const unsigned key = row_key(seg, keys, limit, nseg, base + r * kThreads + tid);
    const int d = key == kNoKey ? kBins : (int)((key >> shift) & 255u);
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < kBins && __ffs(peers) - 1 == lane) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int b = tid; b < kBins; b += kThreads) tilehist[b * ntiles + blockIdx.x] = h[b];
}

// exclusive prefix sum of v over the block (blockDim a multiple of 32);
// ``sums`` is shared scratch of 32 ints; *total gets the block's sum
__device__ __forceinline__ int block_excl_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) sums[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? sums[warp - 1] : 0;
  *total = sums[nw - 1];
  __syncthreads();
  return before + x - v;
}

// one CTA: a[0..m) <- its exclusive prefix sums (m a multiple of 4, read
// as int4, the next 4,096 prefetched while a block scan runs on these);
// *total <- the sum (the valid rows, the same every pass); *zero <- 0 (the
// long-segment list)
__global__ void scan_excl(int* __restrict__ a, int m, int* __restrict__ total,
                          int* __restrict__ zero) {
  __shared__ int sums[32];
  int4* a4 = reinterpret_cast<int4*>(a);
  const int m4 = m / 4;
  const int4 none = make_int4(0, 0, 0, 0);
  int4 cur = (int)threadIdx.x < m4 ? a4[threadIdx.x] : none;
  int carry = 0;
  for (int base = 0; base < m4; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int4 nxt = i + kScanThreads < m4 ? a4[i + kScanThreads] : none;
    int all;
    const int ex = carry + block_excl_scan(cur.x + cur.y + cur.z + cur.w, sums, &all);
    if (i < m4) a4[i] = make_int4(ex, ex + cur.x, ex + cur.x + cur.y,
                                  ex + cur.x + cur.y + cur.z);
    carry += all;
    cur = nxt;
  }
  if (threadIdx.x == 0) {
    *total = carry;
    if (zero != nullptr) *zero = 0;
  }
}

__global__ void radix_scatter(const long long* __restrict__ seg,
                              const unsigned* __restrict__ keys_in,
                              const int* __restrict__ ids_in,
                              const int* __restrict__ nvalid, int n, int nseg, int shift,
                              int ntiles, const int* __restrict__ offs,
                              unsigned* __restrict__ keys_out, int* __restrict__ ids_out) {
  __shared__ int wcnt[kWarps][kBins];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int b = tid; b < kWarps * kBins; b += kThreads) (&wcnt[0][0])[b] = 0;
  __syncthreads();
  const int limit = keys_in != nullptr ? *nvalid : n;
  const int base = blockIdx.x * kTile + warp * kWarpRows;
  unsigned key[kRounds];
  int id[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = base + r * 32 + lane;
    key[r] = row_key(seg, keys_in, limit, nseg, i);
    const bool ok = key[r] != kNoKey;
    const int d = ok ? (int)((key[r] >> shift) & 255u) : kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = ok ? wcnt[warp][d] : 0;
    rank[r] = before + __popc(peers & ((1u << lane) - 1u));
    id[r] = ok ? (ids_in != nullptr ? ids_in[i] : i) : -1;
    __syncwarp();
    if (ok && __ffs(peers) - 1 == lane) wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per digit: the tile's global offset plus the earlier warps' counts
  for (int d = tid; d < kBins; d += kThreads) {
    int acc = offs[d * ntiles + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w][d];
      wcnt[w][d] = acc;
      acc += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (key[r] == kNoKey) continue;
    const int pos = wcnt[warp][(key[r] >> shift) & 255u] + rank[r];
    keys_out[pos] = key[r];
    ids_out[pos] = id[r];
  }
}

// first j in [0, n) with keys[j] >= s (keys ascending): a 32-ary search,
// every lane of the warp probing one point a step
__device__ __forceinline__ int warp_lower_bound(const unsigned* __restrict__ keys, int n,
                                                unsigned s, int lane) {
  int lo = 0, hi = n;   // keys[< lo] < s <= keys[>= hi]
  while (hi > lo) {
    const long long len = hi - lo;
    const int p = lo + (int)((len * lane) / 32);   // non-decreasing in lane
    const int c = __popc(__ballot_sync(kFull, keys[p] < s));   // a prefix of lanes
    if (c == 0) return lo;
    const int last = __shfl_sync(kFull, p, c - 1);
    const int next = __shfl_sync(kFull, p, c & 31);
    lo = last + 1;
    if (c < 32) hi = next;
  }
  return lo;
}

// stage rows [b, b + cnt) of the list, C values each, into st (row-major):
// thread t of nt takes column t % C of every (nt / C)-th row from row t / C,
// no division in the loop (the loads must leave the issue slots to the
// warp that adds), and issues 16 id loads, then 16 value loads, at a time
__device__ __forceinline__ void stage_rows(float* st, const float* __restrict__ vals,
                                           const int* __restrict__ ids, int C, int b,
                                           int cnt, int t, int nt) {
  constexpr int kU = 16;
  const int step = nt / C;
  if (t >= step * C) return;
  const int col = t % C;
  for (int row = t / C; row < cnt; row += kU * step) {
    int id[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = row + u * step;
      id[u] = r < cnt ? ids[b + r] : 0;
    }
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = row + u * step;
      v[u] = r < cnt ? vals[(long long)id[u] * C + col] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = row + u * step;
      if (r < cnt) st[r * C + col] = v[u];
    }
  }
}

// acc + st[0] + st[C] + ... + st[(cnt - 1) C], in that order: the loads of
// the next 16 rows are issued between the adds of these 16, so the chain of
// dependent adds, not the shared-memory latency, sets the pace
__device__ __forceinline__ float add_rows(float acc, const float* st, int C, int cnt) {
  constexpr int kB = 16;
  const int full = cnt / kB * kB;
  if (full > 0) {
    float x[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) x[u] = st[u * C];
    for (int r = kB; r < full; r += kB) {
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const float nx = st[(r + u) * C];
        acc = acc + x[u];
        x[u] = nx;
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) acc = acc + x[u];
  }
  for (int r = full; r < cnt; ++r) acc = acc + st[r * C];
  return acc;
}

// one warp per segment of at most kLong rows; longer ones go to the list
// of seg_sum_long (entries: segment, begin, end)
__global__ void seg_sum_short(const float* __restrict__ vals, int C,
                              const unsigned* __restrict__ keys,
                              const int* __restrict__ ids, const int* __restrict__ nvalid,
                              int nseg, const float* __restrict__ init,
                              float* __restrict__ out, int* __restrict__ long_list) {
  __shared__ float stage[kWarps][32 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= nseg) return;   // whole warps only: no block barrier below
  const int nv = *nvalid;
  const int beg = warp_lower_bound(keys, nv, (unsigned)s, lane);
  const int end = warp_lower_bound(keys, nv, (unsigned)s + 1u, lane);
  if (end - beg > kLong) {
    if (lane == 0) {
      const int j = atomicAdd(long_list, 1);
      long_list[1 + 3 * j] = s;
      long_list[2 + 3 * j] = beg;
      long_list[3 + 3 * j] = end;
    }
    return;
  }
  float acc = 0.0f;
  if (lane < C && init != nullptr) acc = init[(long long)s * C + lane];
  float* st = stage[warp];
  for (int b = beg; b < end; b += 32) {
    const int cnt = min(32, end - b);
    stage_rows(st, vals, ids, C, b, cnt, lane, 32);
    __syncwarp();
    if (lane < C) acc = add_rows(acc, st + lane, C, cnt);
    __syncwarp();
  }
  if (lane < C) out[(long long)s * C + lane] = acc;
}

// one CTA per long segment (grid-stride over the list): warps 1.. stage
// the next chunk of rows into one buffer (kStage floats, dynamic shared
// memory) while warp 0 adds the other's
__global__ void seg_sum_long(const float* __restrict__ vals, int C,
                             const int* __restrict__ ids, const float* __restrict__ init,
                             float* __restrict__ out, const int* __restrict__ long_list) {
  extern __shared__ float stage[];   // [2][kStage]
  const int tid = threadIdx.x;
  const int rows_per = kStage / C;
  const int nlong = long_list[0];
  for (int j = blockIdx.x; j < nlong; j += gridDim.x) {
    const int s = long_list[1 + 3 * j], beg = long_list[2 + 3 * j],
              end = long_list[3 + 3 * j];
    float acc = 0.0f;
    if (tid < C && init != nullptr) acc = init[(long long)s * C + tid];
    __syncthreads();   // the previous segment's last chunk is consumed
    stage_rows(stage, vals, ids, C, beg, min(rows_per, end - beg), tid, kLongThreads);
    __syncthreads();
    for (int c = 0, b = beg; b < end; ++c, b += rows_per) {
      const int cnt = min(rows_per, end - b);
      const int nb = b + rows_per;
      if (tid < 32) {
        if (tid < C) acc = add_rows(acc, stage + (c & 1) * kStage + tid, C, cnt);
      } else if (nb < end) {
        stage_rows(stage + ((c + 1) & 1) * kStage, vals, ids, C, nb,
                   min(rows_per, end - nb), tid - 32, kLongThreads - 32);
      }
      __syncthreads();
    }
    if (tid < C) out[(long long)s * C + tid] = acc;
  }
}

__global__ void __launch_bounds__(kCountThreads) segment_counts_kernel(Tallies g) {
  extern __shared__ int hist[];
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kMaxTallies; ++j) {
    if (j >= g.count) break;
    const Tally t = g.t[j];
    // 16 bytes a thread where both ends are aligned (a large tally's copy
    // of init is the launch's bound), then the tail
    long long head = 0;
    if ((((uintptr_t)t.out | (uintptr_t)t.init) & 15) == 0) {
      head = t.nseg & ~3LL;
      int4* o4 = reinterpret_cast<int4*>(t.out);
      const int4* i4 = reinterpret_cast<const int4*>(t.init);
      for (long long s = gtid; s < head / 4; s += nthreads)
        o4[s] = t.init != nullptr ? i4[s] : make_int4(0, 0, 0, 0);
    }
    for (long long s = head + gtid; s < t.nseg; s += nthreads)
      t.out[s] = t.init != nullptr ? t.init[s] : 0;
  }
  cg::this_grid().sync();
#pragma unroll
  for (int j = 0; j < kMaxTallies; ++j) {
    if (j >= g.count) break;
    const Tally t = g.t[j];
    if (t.chunk > 0) {
      const int nseg = (int)t.nseg;
      for (long long c0 = (long long)blockIdx.x * t.chunk; c0 < t.n;
           c0 += (long long)gridDim.x * t.chunk) {
        for (int s = threadIdx.x; s < nseg; s += blockDim.x) hist[s] = 0;
        __syncthreads();
        const long long c1 = c0 + t.chunk < t.n ? c0 + t.chunk : t.n;
        for (long long i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
          const long long s = t.seg[i];
          const int w = t.w != nullptr ? t.w[i] : 1;
          if (w != 0 && s >= 0 && s < nseg) atomicAdd(&hist[s], w);
        }
        __syncthreads();
        for (int s = threadIdx.x; s < nseg; s += blockDim.x) {
          const int h = hist[s];
          if (h != 0) atomicAdd(&t.out[s], h);
        }
        __syncthreads();
      }
    } else {
      // whole warps walk the rows (the base is warp-uniform), so every
      // lane takes part in the match
      for (long long base = gtid - lane; base < t.n; base += nthreads) {
        const long long i = base + lane;
        long long key = -1;
        int w = 0;
        if (i < t.n) {
          const long long s = t.seg[i];
          w = t.w != nullptr ? t.w[i] : 1;
          if (w != 0 && s >= 0 && s < t.nseg) key = s;
        }
        const unsigned peers = __match_any_sync(kFull, key);
        if (key >= 0) {
          const int total = __reduce_add_sync(peers, w);
          if (__ffs(peers) - 1 == lane) atomicAdd(&t.out[key], total);
        }
      }
    }
  }
}

// the owned form: each block owns kOwnedSegs segments of one tally (the
// tally's blocks start at first[j]), starts them from init in shared
// memory, streams all the tally's rows and counts those in its range, then
// writes its range. No atomic leaves the block and no barrier crosses
// blocks; every block reads all N rows, so it serves small N only.
constexpr int kOwnedSegs = 2048;
constexpr int kOwnedThreads = 512;
constexpr int kOwnedUnroll = 4;   // rows a thread loads before it counts them

struct OwnedPlan {
  long long first[kMaxTallies + 1];
};

__global__ void __launch_bounds__(kOwnedThreads) segment_counts_owned(Tallies g, OwnedPlan p) {
  __shared__ int hist[kOwnedSegs];
  int j = 0;
#pragma unroll
  for (int i = 1; i < kMaxTallies; ++i)
    if (i < g.count && (long long)blockIdx.x >= p.first[i]) j = i;
  Tally t = g.t[0];
  long long first = p.first[0];
#pragma unroll
  for (int i = 1; i < kMaxTallies; ++i)
    if (i == j) {
      t = g.t[i];
      first = p.first[i];
    }
  const long long lo = ((long long)blockIdx.x - first) * kOwnedSegs;
  const int m = (int)(t.nseg - lo < kOwnedSegs ? t.nseg - lo : kOwnedSegs);
  for (int s = threadIdx.x; s < m; s += blockDim.x) hist[s] = t.init != nullptr ? t.init[lo + s] : 0;
  __syncthreads();
  // kOwnedUnroll rows a thread in flight: the rows' loads are independent,
  // so one latency serves them all
  for (long long base = threadIdx.x; base < t.n; base += kOwnedUnroll * blockDim.x) {
    long long s[kOwnedUnroll];
    int w[kOwnedUnroll];
#pragma unroll
    for (int u = 0; u < kOwnedUnroll; ++u) {
      const long long i = base + (long long)u * blockDim.x;
      s[u] = i < t.n ? t.seg[i] - lo : -1;
      w[u] = i < t.n ? (t.w != nullptr ? t.w[i] : 1) : 0;
    }
#pragma unroll
    for (int u = 0; u < kOwnedUnroll; ++u)
      if (s[u] >= 0 && s[u] < m && w[u] != 0) atomicAdd(&hist[s[u]], w[u]);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < m; s += blockDim.x) t.out[lo + s] = hist[s];
}

int radix_passes(int nseg) {
  int bits = 0;
  while (bits < 31 && ((long long)(nseg - 1) >> bits) > 0) ++bits;
  return bits <= 8 ? 1 : (bits + 7) / 8;
}

long long tiles_of(int N) { return (N + kTile - 1) / kTile; }

long long long_cap(int N) { return N / kLong + 1; }

// int32 words of the list form's scratch (kernels/segment.py sizes it the
// same way; a smaller one is refused): keys and ids twice (ping-pong), the
// tile histograms, the valid-row count and the long-segment list
long long scratch_words(int N) {
  return 4LL * N + (long long)kBins * tiles_of(N) + 2 + 1 + 3 * long_cap(N);
}

}  // namespace

// form 0: the scan form (scratch unused); form 1: the list form.
// *launches (host memory) gets the number of CUDA launches made.
extern "C" int cc_segment_sum(const float* vals, const long long* seg, int N,
                              int C, int nseg, const float* init, float* out,
                              int* scratch, long long words, int form, int* launches,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  *launches = 0;
  if (C <= 0 || C > 32 || nseg <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (form == 0 || N == 0) {
    segment_sum_scan<<<nseg, kThreads, 0, stream>>>(vals, seg, N, C, init, out);
    *launches = 1;
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || words < scratch_words(N))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (int)tiles_of(N);
  unsigned* keys[2] = {(unsigned*)scratch, (unsigned*)scratch + N};
  int* ids[2] = {scratch + 2LL * N, scratch + 3LL * N};
  int* tilehist = scratch + 4LL * N;
  int* nvalid = tilehist + (long long)kBins * ntiles;
  int* long_list = nvalid + 2;
  const int passes = radix_passes(nseg);
  for (int p = 0; p < passes; ++p) {
    const unsigned* kin = p == 0 ? nullptr : keys[(p + 1) & 1];
    const int* iin = p == 0 ? nullptr : ids[(p + 1) & 1];
    radix_hist<<<ntiles, kThreads, 0, stream>>>(seg, kin, nvalid, N, nseg, 8 * p, ntiles,
                                                tilehist);
    scan_excl<<<1, kScanThreads, 0, stream>>>(tilehist, kBins * ntiles, nvalid,
                                              p == passes - 1 ? long_list : nullptr);
    radix_scatter<<<ntiles, kThreads, 0, stream>>>(seg, kin, iin, nvalid, N, nseg, 8 * p,
                                                   ntiles, tilehist, keys[p & 1],
                                                   ids[p & 1]);
  }
  const unsigned* skeys = keys[(passes - 1) & 1];
  const int* sids = ids[(passes - 1) & 1];
  seg_sum_short<<<(nseg + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      vals, C, skeys, sids, nvalid, nseg, init, out, long_list);
  const long long cap = long_cap(N);
  const int grid = (int)(cap < 264 ? cap : 264);
  constexpr int kLongSmem = 2 * kStage * sizeof(float);
  static bool smem_set = false;   // once per process (a repeat is harmless)
  if (!smem_set) {
    cudaFuncSetAttribute(seg_sum_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kLongSmem);
    smem_set = true;
  }
  seg_sum_long<<<grid, kLongThreads, kLongSmem, stream>>>(vals, C, sids, init, out,
                                                          long_list);
  *launches = 3 * passes + 2;
  return (int)cudaGetLastError();
}

// the blocks of segment_counts_kernel the current device holds at once
// with smem bytes of dynamic shared memory (a multiple of kSmemStep): its
// cooperative launch's grid at most; queried once per process, device and
// size (13 sizes occur); 0 when the query fails (*err gets why)
static int count_residency(size_t smem, cudaError_t* err) {
  constexpr int kSizes = (int)(kSmemBins * sizeof(int) / kSmemStep) + 1;
  static int resident[kMaxDevices][kSizes] = {};   // 0: not queried yet (a repeat is harmless)
  const int k = (int)(smem / kSmemStep);
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  const bool kept = dev >= 0 && dev < kMaxDevices && k < kSizes;
  if (kept && resident[dev][k] > 0) return resident[dev][k];
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_counts_kernel,
                                                         kCountThreads, smem);
  if (*err != cudaSuccess) return 0;
  if (per_sm <= 0) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (kept) resident[dev][k] = per_sm * sms;
  return per_sm * sms;
}

// the grouped count: tallies[0..count) (host memory) in one launch, of
// the owned form (owned != 0) or the grid form (one cooperative launch);
// *launches (host memory) gets the number of CUDA launches made, or on an
// error minus the step that failed (1 the arguments, 2 the residency
// query, 3 the launch)
extern "C" int cc_segment_counts(const Tally* tallies, int count, int owned, int* launches,
                                 void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  *launches = -1;
  if (count <= 0 || count > kMaxTallies) return (int)cudaErrorInvalidValue;
  Tallies g{};
  g.count = count;
  OwnedPlan plan{};
  long long need = 1, bins = 0;
  for (int j = 0; j < count; ++j) {
    const Tally& t = tallies[j];
    if (t.n < 0 || t.nseg <= 0 || t.chunk < 0 || (t.seg == nullptr && t.n > 0) ||
        t.out == nullptr || (t.chunk > 0 && (t.nseg > kSmemBins || owned)))
      return (int)cudaErrorInvalidValue;
    g.t[j] = t;
    const long long work = t.n > t.nseg ? t.n : t.nseg;
    const long long blocks = (work + kCountThreads - 1) / kCountThreads;
    if (blocks > need) need = blocks;
    if (t.chunk > 0 && t.nseg > bins) bins = t.nseg;
    plan.first[j + 1] = plan.first[j] + (t.nseg + kOwnedSegs - 1) / kOwnedSegs;
  }
  for (int j = count + 1; j <= kMaxTallies; ++j) plan.first[j] = plan.first[count];
  if (owned) {
    if (plan.first[count] > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    *launches = -3;
    segment_counts_owned<<<(unsigned)plan.first[count], kOwnedThreads, 0, stream>>>(g, plan);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) *launches = 1;
    return (int)err;
  }
  const size_t smem = (size_t)((bins * sizeof(int) + kSmemStep - 1) / kSmemStep) * kSmemStep;
  *launches = -2;
  cudaError_t err = cudaSuccess;
  const long long resident = count_residency(smem, &err);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(need < resident ? need : resident);
  void* args[] = {&g};
  *launches = -3;
  err = cudaLaunchCooperativeKernel((const void*)segment_counts_kernel, dim3(grid),
                                    dim3(kCountThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  *launches = 1;
  return (int)cudaGetLastError();
}
