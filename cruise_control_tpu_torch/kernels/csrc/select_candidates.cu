// K1 select_candidates: stall-salted exact top-k with lowest-index ties.
//
// Replaces cruise_control_tpu/analyzer/engine.py _stall_explore (:123),
// _top_candidates (:166) and _select_candidates (:179). The CPU oracle's
// lax.top_k (and approx_max_k, which falls back to it) orders by value in
// total order (-0.0 < +0.0) and breaks ties toward the lowest index: rows
// rank by the 64-bit composite (sortable_bits(key) << 32) | ~slot, unique
// per row, larger first.
//
// Design (at most 7 launches a call, one workspace):
//   memset   the lane's histograms and counters;
//   pass A   salts each key (the uint32 hash of engine.py:143-149), stores
//            its 32 sortable bits u and builds the histogram of u's top 12
//            bits; the lane's last block to finish (an atomic ticket)
//            chooses the digit that holds the k-th largest u;
//   pass B   the same over bits 19..8 of the rows with that prefix;
//   pass C   over bits 7..0, keeping each tile's histogram: the k-th u, T,
//            is now known, with `need`, the rows of u == T that go in;
//   gather   every row with u > T goes in (an atomic slot), and the first
//            `need` rows with u == T in slot order: the tie rows of the
//            earlier tiles come from pass C's tile histograms, the rank
//            inside the tile from a block scan, so ties go lowest index
//            first with no further pass;
//   sort     each chunk of 512 composites is sorted in shared memory
//            (bitonic, one CTA per chunk, so k = 7,040 spreads over 14 SMs
//            where one CTA of 1,024 threads bound the sort by its issue
//            rate); with more than one chunk
//   merge    places each composite at its index in its chunk plus the
//            composites above it in the other chunks: binary searches in
//            shared memory, which holds the lane's k sorted composites (up
//            to 128 KB at k = 16,384, the attribute set once a process).
// The selection reads the keys once and the 4-byte u twice. Bound: bytes.
//
// The optional seed mask (engine.py _mask_key :153, dirty-set seeding of a
// reduced round) sends every row outside it to -inf BEFORE salting; the
// salt maps -inf to -inf, so this equals the reference's mask-then-salt.
// A null mask (full rounds) reads every key as it is.
//
// Lanes (K14, the fleet's tenant axis): cc_select_candidates_lanes runs L
// independent selections in the same launches, grid dimension y = lane.
// Lane j reads key / mask row j of [L, n], salts with its own stall and
// keeps its own histograms, counters and composites, so each lane's output
// is bit for bit a solo launch on its row. The solo entry point is L = 1.
//
// Pooled keying (engine.py _select_candidates with compact_keying, :179-225):
// cc_select_pooled first compacts each lane's eligible rows (key > -inf
// after the seed mask) with the compaction launches below and leaves the
// eligible count on the device. Each lane then chooses its branch ON THE
// DEVICE from that count, as the reference's lax.cond does: the pool (its
// first `pool` compacted slots, padded with the sentinel n) when the count
// is at most `pool`, else the full n rows. Every block past its lane's live
// length (pool or n) returns at once, so a pooled lane costs the pool's
// rows; there is no host read and each lane of a fleet launch chooses for
// itself. In the pooled branch pass A reads key[order[j]] and hashes
// order[j], the ORIGINAL replica id (_stall_explore(..., idx=idx)), so every
// live row's value is the full sweep's; slots keep the ids' order, so ties
// still go lowest id first, and every live row comes out as the full path
// orders it. Pad slots (-inf, below every live row) come out with kv -inf
// and id n - 1, the reference's min(order, R - 1). Pass A's choosing block
// adds one to the branch counter (pooled, full) of its lane, on the device.
//
// compact_eligible replaces engine.py _compact_eligible (:1257): the indices
// of the true entries of bool[n] in index order, the tail padded with the
// sentinel n, and their count. Four launches: per-tile counts, one scan of
// the tile counts, each tile writing its rows at its offset plus the row's
// rank among the tile's true rows (warp ballots + a block scan of the warp
// counts), then the pads. No atomics: the order is the index order by
// construction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t sortable_bits(float v) {
  uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_sortable(uint32_t s) {
  uint32_t u = (s & 0x80000000u) ? (s & 0x7FFFFFFFu) : ~s;
  return __uint_as_float(u);
}

// the pooled branch of a lane: its eligible count fits the pool (never
// with elig_n null, the full-only launches)
__device__ __forceinline__ bool pooled_lane(const long long* elig_n, long long lane,
                                            int pool) {
  return elig_n != nullptr && elig_n[lane] <= (long long)pool;
}

constexpr int kSelThreads = 512;
constexpr int kSelTile = 2048;                      // slots of one block
constexpr int kSelRounds = kSelTile / kSelThreads;
constexpr int kBinsWide = 4096;                     // 12-bit digits: passes A, B
constexpr int kBinsLast = 256;                      // 8-bit digit: pass C
constexpr int kChunk = 512;                         // composites a sort CTA holds
constexpr int kSortThreads = 256;
constexpr int kMaxK = 16384;
// per lane, zeroed each call: the three histograms and the counters
constexpr long long kZeroWords = 2 * kBinsWide + kBinsLast + 8;
enum { kTicket = 0, kPrefix = 3, kKrem = 4, kGt = 5 };

struct LaneWs {
  unsigned* hist[3];
  unsigned* ctl;
};

__device__ __forceinline__ LaneWs lane_ws(unsigned* ws, long long lane) {
  unsigned* b = ws + lane * kZeroWords;
  return {{b, b + kBinsWide, b + 2 * kBinsWide}, b + 2 * kBinsWide + kBinsLast};
}

// the sortable bits of slot i's salted key (key, mask, order: the lane's)
__device__ __forceinline__ uint32_t slot_bits(const float* __restrict__ key,
                                              const unsigned char* __restrict__ mask,
                                              const long long* __restrict__ order,
                                              bool pooled, int n, int stall, int salt,
                                              int i) {
  uint32_t id = (uint32_t)i;
  float v;
  if (pooled) {
    // slot i of the compacted pool: an eligible row (it passed the mask)
    // or the sentinel n (a pad, -inf)
    const long long p = order[i];
    const bool real = p < n;
    id = real ? (uint32_t)p : (uint32_t)(n - 1);
    v = real ? key[p] : -INFINITY;
  } else {
    v = (mask == nullptr || mask[i]) ? key[i] : -INFINITY;
  }
  if (stall > 0) {
    uint32_t h = id * 2246822519u
                 + ((uint32_t)stall + (uint32_t)salt) * 3266489917u;
    h = (h ^ (h >> 15)) * 2654435761u;
    float r01 = __fdiv_rn((float)(h >> 8), 16777216.0f);
    v = (v > -INFINITY) ? __fadd_rn(r01, (v >= 5e11f) ? 2.0f : 0.0f)
                        : -INFINITY;
  }
  return sortable_bits(v);
}

// one shared-memory histogram add per group of lanes with the same digit
// (d < 0: no row); every lane of the warp calls it
__device__ __forceinline__ void hist_add(unsigned* h, int d) {
  const unsigned peers = __match_any_sync(kFull, d);
  if (d >= 0 && __ffs(peers) - 1 == (int)(threadIdx.x & 31))
    atomicAdd(&h[d], (unsigned)__popc(peers));
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

// adds the block's histogram into the lane's; true in the lane's last block
// to do so (an atomic ticket), which then sees every block's adds
__device__ bool flush_and_last(const unsigned* h, int nbins, unsigned* gh,
                               unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    const unsigned c = h[b];
    if (c != 0u) atomicAdd(&gh[b], c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// in the lane's last block: the digit b of the rows with the current prefix
// such that those with a digit above b are fewer than krem and those with a
// digit >= b are not; prefix |= b << shift, krem -= the rows above b
__device__ void choose_digit(const unsigned* gh, int nbins, int shift, unsigned krem,
                             unsigned* ctl) {
  __shared__ int sums[32];
  const int per = (nbins + (int)blockDim.x - 1) / (int)blockDim.x;
  const int top = nbins - (int)threadIdx.x * per;   // bins [top - per, top), highest first
  unsigned s = 0u;
  for (int j = 1; j <= per; ++j) {
    if (top - j >= 0) s += __ldcg(&gh[top - j]);
  }
  int total;
  const unsigned above = (unsigned)block_excl_scan((int)s, sums, &total);
  if (above < krem && krem <= above + s) {
    unsigned cum = above;
    for (int j = 1; j <= per; ++j) {
      const unsigned c = __ldcg(&gh[top - j]);
      if (cum + c >= krem) {
        ctl[kPrefix] |= (unsigned)(top - j) << shift;
        ctl[kKrem] = krem - cum;
        break;
      }
      cum += c;
    }
  }
}

__global__ void sel_pass_a(const float* __restrict__ key,
                           const unsigned char* __restrict__ mask, int n, int k,
                           int stall0, const int* __restrict__ stalls, int salt,
                           const long long* __restrict__ elig_n,
                           const long long* __restrict__ order, int pool,
                           unsigned* __restrict__ ubuf, unsigned* ws, u64* branch) {
  __shared__ unsigned h[kBinsWide];
  const long long lane = blockIdx.y;
  const bool pooled = pooled_lane(elig_n, lane, pool);
  const int live = pooled ? pool : n;
  key += lane * n;
  if (mask != nullptr) mask += lane * n;
  if (order != nullptr) order += lane * n;
  ubuf += lane * n;
  const int stall = stalls != nullptr ? stalls[lane] : stall0;
  for (int b = threadIdx.x; b < kBinsWide; b += kSelThreads) h[b] = 0u;
  __syncthreads();
  const int base = blockIdx.x * kSelTile;
  for (int r = 0; r < kSelRounds; ++r) {
    const int i = base + r * kSelThreads + threadIdx.x;
    int d = -1;
    if (i < live) {
      const uint32_t u = slot_bits(key, mask, order, pooled, n, stall, salt, i);
      ubuf[i] = u;
      d = (int)(u >> 20);
    }
    hist_add(h, d);
  }
  const LaneWs w = lane_ws(ws, lane);
  if (flush_and_last(h, kBinsWide, w.hist[0], &w.ctl[kTicket])) {
    choose_digit(w.hist[0], kBinsWide, 20, (unsigned)k, w.ctl);
    if (branch != nullptr && threadIdx.x == 0) atomicAdd(&branch[pooled ? 0 : 1], 1ull);
  }
}

// pass B (which 1: bits 19..8) and pass C (which 2: bits 7..0, with each
// tile's histogram kept in tilehist [L, ntiles, 256]) over the rows whose
// higher bits are the prefix chosen so far
__global__ void sel_pass_next(const long long* __restrict__ elig_n, int n, int pool,
                              const unsigned* __restrict__ ubuf, unsigned* ws, int which,
                              unsigned* __restrict__ tilehist) {
  __shared__ unsigned h[kBinsWide];
  const long long lane = blockIdx.y;
  const int live = pooled_lane(elig_n, lane, pool) ? pool : n;
  ubuf += lane * n;
  const LaneWs w = lane_ws(ws, lane);
  const unsigned prefix = w.ctl[kPrefix], krem = w.ctl[kKrem];
  const int shift = which == 1 ? 8 : 0, nbins = which == 1 ? kBinsWide : kBinsLast;
  const int above = which == 1 ? 20 : 8;
  for (int b = threadIdx.x; b < nbins; b += kSelThreads) h[b] = 0u;
  __syncthreads();
  const int base = blockIdx.x * kSelTile;
  for (int r = 0; r < kSelRounds; ++r) {
    const int i = base + r * kSelThreads + threadIdx.x;
    int d = -1;
    if (i < live) {
      const uint32_t u = ubuf[i];
      if ((u >> above) == (prefix >> above)) d = (int)((u >> shift) & (unsigned)(nbins - 1));
    }
    hist_add(h, d);
  }
  if (tilehist != nullptr) {
    __syncthreads();
    unsigned* th = tilehist + (lane * gridDim.x + blockIdx.x) * kBinsLast;
    for (int b = threadIdx.x; b < kBinsLast; b += kSelThreads) th[b] = h[b];
  }
  if (flush_and_last(h, nbins, w.hist[which], &w.ctl[kTicket + which]))
    choose_digit(w.hist[which], nbins, shift, krem, w.ctl);
}

__device__ __forceinline__ u64 composite(uint32_t u, int slot) {
  return ((u64)u << 32) | (u64)(~(uint32_t)slot);
}

// every slot with u > T (an atomic position below k - need) and the first
// `need` slots with u == T in slot order (positions k - need ...)
__global__ void sel_gather(const long long* __restrict__ elig_n, int n, int k, int pool,
                           const unsigned* __restrict__ ubuf, unsigned* ws,
                           const unsigned* __restrict__ tilehist, u64* __restrict__ sel) {
  __shared__ int sums[32];
  const long long lane = blockIdx.y;
  const int live = pooled_lane(elig_n, lane, pool) ? pool : n;
  ubuf += lane * n;
  sel += lane * k;
  const LaneWs w = lane_ws(ws, lane);
  const unsigned T = w.ctl[kPrefix];
  const int need = (int)w.ctl[kKrem];
  const unsigned* th = tilehist + lane * gridDim.x * kBinsLast + (T & 255u);
  int part = 0;
  for (int t = threadIdx.x; t < (int)blockIdx.x; t += kSelThreads) part += (int)th[t * kBinsLast];
  int tie;
  block_excl_scan(part, sums, &tie);   // the tie rows of the earlier tiles
  const int base = blockIdx.x * kSelTile;
  if (base >= live) return;   // whole blocks only: the scans below are block-wide
  for (int r = 0; r < kSelRounds; ++r) {
    const int i = base + r * kSelThreads + threadIdx.x;
    const bool ok = i < live;
    const uint32_t u = ok ? ubuf[i] : 0u;
    const bool eq = ok && u == T;
    int ties;
    const int rank = tie + block_excl_scan(eq ? 1 : 0, sums, &ties);
    if (ok && u > T) sel[atomicAdd(&w.ctl[kGt], 1u)] = composite(u, i);
    if (eq && rank < need) sel[k - need + rank] = composite(u, i);
    tie += ties;
  }
}

// the output of the composite of rank `rank` in its lane
__device__ __forceinline__ void write_out(u64 c, int rank, float* out_kv,
                                          long long* out_idx, const long long* order,
                                          bool pooled, int n) {
  const uint32_t slot = ~(uint32_t)(c & 0xFFFFFFFFull);
  out_kv[rank] = from_sortable((uint32_t)(c >> 32));
  long long id = (long long)slot;
  if (pooled) {
    // a pooled lane's pad slots: id n - 1, as min(order, R - 1)
    const long long p = order[slot];
    id = p < n ? p : (long long)(n - 1);
  }
  out_idx[rank] = id;
}

// bitonic sort (descending) of one chunk of kChunk composites in shared
// memory, one CTA per chunk; with one chunk it writes the outputs, else the
// sorted chunk for sel_merge
__global__ void sel_sort(const u64* __restrict__ sel, int k, u64* __restrict__ sorted,
                         float* __restrict__ out_kv, long long* __restrict__ out_idx,
                         const long long* __restrict__ elig_n,
                         const long long* __restrict__ order, int pool, int n) {
  __shared__ u64 s[kChunk];
  const long long lane = blockIdx.y;
  const int c0 = blockIdx.x * kChunk;
  const int len = min(kChunk, k - c0);
  int cp = 2;
  while (cp < len) cp <<= 1;
  sel += lane * k + c0;
  for (int i = threadIdx.x; i < cp; i += kSortThreads) s[i] = i < len ? sel[i] : 0ull;
  __syncthreads();
  for (int size = 2; size <= cp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < cp; i += kSortThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const bool desc = (i & size) == 0;
          const u64 a = s[i], b = s[j];
          if (desc ? (a < b) : (a > b)) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  if (gridDim.x == 1) {
    const bool pooled = pooled_lane(elig_n, lane, pool);
    for (int i = threadIdx.x; i < len; i += kSortThreads)
      write_out(s[i], i, out_kv + lane * k, out_idx + lane * k,
                order != nullptr ? order + lane * n : nullptr, pooled, n);
  } else {
    for (int i = threadIdx.x; i < len; i += kSortThreads) sorted[lane * k + c0 + i] = s[i];
  }
}

// each composite's rank: its index in its chunk plus, in every other chunk,
// the composites above it (binary searches in shared memory, which holds
// the lane's k sorted composites; they are unique)
__global__ void sel_merge(const u64* __restrict__ sorted, int k, float* __restrict__ out_kv,
                          long long* __restrict__ out_idx,
                          const long long* __restrict__ elig_n,
                          const long long* __restrict__ order, int pool, int n) {
  extern __shared__ u64 all[];
  const long long lane = blockIdx.y;
  const bool pooled = pooled_lane(elig_n, lane, pool);
  sorted += lane * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) all[i] = sorted[i];
  __syncthreads();
  const int c0 = blockIdx.x * kChunk;
  const int len = min(kChunk, k - c0);
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const u64 e = all[c0 + j];
    int rank = j;
    for (int c = 0; c < (int)gridDim.x; ++c) {
      if (c == (int)blockIdx.x) continue;
      const u64* a = all + c * kChunk;
      int lo = 0, hi = min(kChunk, k - c * kChunk);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] > e) lo = mid + 1;
        else hi = mid;
      }
      rank += lo;
    }
    write_out(e, rank, out_kv + lane * k, out_idx + lane * k,
              order != nullptr ? order + lane * n : nullptr, pooled, n);
  }
}

// 32-bit words of a selection's workspace (kernels/select.py sizes it the
// same way; a smaller one is refused): per lane the zeroed histograms and
// counters, the salted bits of every slot, pass C's tile histograms, the k
// selected and the k sorted composites
long long ws_words(int L, int n, int k) {
  const long long ntiles = (n + kSelTile - 1) / kSelTile;
  const long long ub = ((long long)L * n + 1) & ~1LL;
  return L * kZeroWords + ub + L * ntiles * kBinsLast + 4LL * L * k;
}

constexpr int kTile = 1024;   // rows of one compaction tile

// row i of lane `lane` is eligible: elig[i] when given (compact_eligible),
// else key > -inf after the seed mask (the pooled selection's prefix)
__device__ __forceinline__ bool eligible_at(const unsigned char* __restrict__ elig,
                                            const float* __restrict__ key,
                                            const unsigned char* __restrict__ mask,
                                            long long lane, int n, int i) {
  if (i >= n) return false;
  if (elig != nullptr) return elig[i] != 0;
  const long long j = lane * n + i;
  return (mask == nullptr || mask[j]) && key[j] > -INFINITY;
}

__global__ void tile_counts(const unsigned char* __restrict__ elig,
                            const float* __restrict__ key,
                            const unsigned char* __restrict__ mask, int n,
                            int* __restrict__ counts) {
  __shared__ int wc[kTile / 32];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const long long lane = blockIdx.y;
  counts += lane * gridDim.x;
  const bool hit = eligible_at(elig, key, mask, lane, n, i);
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
  if ((threadIdx.x & 31) == 0) wc[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kTile / 32; ++w) t += wc[w];
    counts[blockIdx.x] = t;
  }
}

__global__ void scan_counts(int* __restrict__ counts, int nb,
                            long long* __restrict__ total) {
  counts += (long long)blockIdx.x * nb;
  total += blockIdx.x;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int b = 0; b < nb; ++b) {
      const int c = counts[b];
      counts[b] = acc;
      acc += c;
    }
    *total = acc;
  }
}

__global__ void tile_write(const unsigned char* __restrict__ elig,
                           const float* __restrict__ key,
                           const unsigned char* __restrict__ mask, int n,
                           const int* __restrict__ offsets,
                           long long* __restrict__ order, long long stride) {
  __shared__ int wc[kTile / 32];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  offsets += (long long)blockIdx.y * gridDim.x;
  order += (long long)blockIdx.y * stride;
  const bool hit = eligible_at(elig, key, mask, blockIdx.y, n, i);
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
  if (lane == 0) wc[warp] = __popc(ballot);
  __syncthreads();
  if (hit) {
    int off = offsets[blockIdx.x];
    for (int w = 0; w < warp; ++w) off += wc[w];
    order[off + __popc(ballot & ((1u << lane) - 1u))] = (long long)i;
  }
}

__global__ void pad_tail(long long* __restrict__ order, int pad_len, int n,
                         const long long* __restrict__ total, long long stride) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  order += (long long)blockIdx.y * stride;
  if (p < pad_len && p >= total[blockIdx.y]) order[p] = (long long)n;
}

// the compaction of L lanes (grid y = lane): per-tile counts, one scan per
// lane, the writes, the pads up to pad_len; elig given (L = 1) or key/mask
static void launch_compact(const unsigned char* elig, const float* key,
                           const unsigned char* mask, int L, int n, int pad_len,
                           int* counts, long long* order, long long stride,
                           long long* total, cudaStream_t stream) {
  const int nb = (n + kTile - 1) / kTile;
  tile_counts<<<dim3(nb, L), kTile, 0, stream>>>(elig, key, mask, n, counts);
  scan_counts<<<L, 32, 0, stream>>>(counts, nb, total);
  tile_write<<<dim3(nb, L), kTile, 0, stream>>>(elig, key, mask, n, counts, order, stride);
  pad_tail<<<dim3((pad_len + 255) / 256, L), 256, 0, stream>>>(order, pad_len, n, total,
                                                              stride);
}


}  // namespace

extern "C" int cc_compact_eligible(const unsigned char* elig, int n, int pad_len,
                                   int* counts, long long* order,
                                   long long* total, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || pad_len < n) return (int)cudaErrorInvalidValue;
  launch_compact(elig, nullptr, nullptr, 1, n, pad_len, counts, order, 0, total, stream);
  return (int)cudaGetLastError();
}

// *launches (host memory) gets the number of CUDA launches (the memset
// included) each entry point made
static int launch_select(const float* key, const unsigned char* mask, int L, int n,
                         int k, int stall, const int* stalls, int salt, unsigned* ws,
                         long long words, float* out_kv, long long* out_idx, int* launches,
                         cudaStream_t stream, const long long* elig_n = nullptr,
                         const long long* order = nullptr, int pool = 0,
                         u64* branch = nullptr) {
  if (L <= 0 || L > 65535 || n <= 0 || k <= 0 || k > n || k > kMaxK || ws == nullptr ||
      words < ws_words(L, n, k))
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + kSelTile - 1) / kSelTile;
  unsigned* ubuf = ws + L * kZeroWords;
  unsigned* tilehist = ubuf + (((long long)L * n + 1) & ~1LL);
  u64* sel = (u64*)(tilehist + L * ntiles * kBinsLast);
  u64* sorted = sel + (long long)L * k;
  cudaMemsetAsync(ws, 0, L * kZeroWords * sizeof(unsigned), stream);
  const dim3 grid((unsigned)ntiles, L);
  sel_pass_a<<<grid, kSelThreads, 0, stream>>>(key, mask, n, k, stall, stalls, salt, elig_n,
                                               order, pool, ubuf, ws, branch);
  sel_pass_next<<<grid, kSelThreads, 0, stream>>>(elig_n, n, pool, ubuf, ws, 1, nullptr);
  sel_pass_next<<<grid, kSelThreads, 0, stream>>>(elig_n, n, pool, ubuf, ws, 2, tilehist);
  sel_gather<<<grid, kSelThreads, 0, stream>>>(elig_n, n, k, pool, ubuf, ws, tilehist, sel);
  const dim3 chunks((k + kChunk - 1) / kChunk, L);
  sel_sort<<<chunks, kSortThreads, 0, stream>>>(sel, k, sorted, out_kv, out_idx, elig_n,
                                                order, pool, n);
  if (chunks.x > 1) {
    static bool smem_set = false;   // once per process (a repeat is harmless)
    if (!smem_set) {
      cudaFuncSetAttribute(sel_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxK * (int)sizeof(u64));
      smem_set = true;
    }
    sel_merge<<<chunks, kChunk, k * sizeof(u64), stream>>>(sorted, k, out_kv, out_idx,
                                                           elig_n, order, pool, n);
  }
  *launches += chunks.x > 1 ? 7 : 6;
  return (int)cudaGetLastError();
}

extern "C" int cc_select_candidates(const float* key, const unsigned char* mask, int n,
                                    int k, int stall, int salt, unsigned* ws,
                                    long long words, float* out_kv, long long* out_idx,
                                    int* launches, void* stream_ptr) {
  *launches = 0;
  return launch_select(key, mask, 1, n, k, stall, nullptr, salt, ws, words, out_kv,
                       out_idx, launches, (cudaStream_t)stream_ptr);
}

// L lanes: key / mask [L, n], stalls int32[L] on the device, outputs [L, k]
extern "C" int cc_select_candidates_lanes(const float* key, const unsigned char* mask,
                                          int L, int n, int k, const int* stalls, int salt,
                                          unsigned* ws, long long words, float* out_kv,
                                          long long* out_idx, int* launches,
                                          void* stream_ptr) {
  *launches = 0;
  if (stalls == nullptr) return (int)cudaErrorInvalidValue;
  return launch_select(key, mask, L, n, k, 0, stalls, salt, ws, words, out_kv, out_idx,
                       launches, (cudaStream_t)stream_ptr);
}

// Pooled keying of L lanes (L = 1 and stalls null: the solo launch with
// stall0): the compaction of each lane's eligible rows into order [L, n]
// with its count in elig_n [L], then the selection over the pool or the
// full rows, chosen per lane on the device; branch[0] / branch[1] count the
// lanes that took the pooled / full branch. pool < n, 2k <= pool.
extern "C" int cc_select_pooled(const float* key, const unsigned char* mask, int L,
                                int n, int k, int pool, int stall0, const int* stalls,
                                int salt, int* counts, long long* order,
                                long long* elig_n, unsigned* ws, long long words,
                                float* out_kv, long long* out_idx, u64* branch,
                                int* launches, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  *launches = 0;
  if (L <= 0 || L > 65535 || n <= 0 || pool <= 0 || pool >= n || k <= 0 ||
      2 * k > pool || (L > 1 && stalls == nullptr))
    return (int)cudaErrorInvalidValue;
  launch_compact(nullptr, key, mask, L, n, pool, counts, order, n, elig_n, stream);
  *launches = 4;
  return launch_select(key, mask, L, n, k, stall0, stalls, salt, ws, words, out_kv,
                       out_idx, launches, stream, elig_n, order, pool, branch);
}
