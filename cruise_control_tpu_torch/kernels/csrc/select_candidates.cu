// K1 select_candidates: stall-salted exact top-k with lowest-index ties.
//
// Replaces cruise_control_tpu/analyzer/engine.py _stall_explore (:123),
// _top_candidates (:166) and _select_candidates (:179). The CPU oracle's
// lax.top_k (and approx_max_k, which falls back to it) orders by value in
// total order (-0.0 < +0.0) and breaks ties toward the lowest index; the
// 64-bit composite below sorts exactly so.
//
// Design: one pass salts each key and packs
//   comp[i] = (sortable_bits(key) << 32) | ~i
// (unique per row, larger composite = earlier in the output). An 8-pass,
// 8-bit radix select finds the k-th largest composite T (histogram kernel +
// one-thread bucket choice per pass, all on the stream: no host sync). The k
// rows with comp >= T are gathered and ordered by a single-CTA bitonic sort
// in shared memory (k <= 16384: 128 KB of dynamic shared memory, opted into
// with cudaFuncSetAttribute; the finisher's top-k takes k = K * W = 10,560).
// Bound: bytes — the keys are read once, but the radix passes re-read the
// 8-byte composites eight times.
//
// The optional seed mask (engine.py _mask_key :153, dirty-set seeding of a
// reduced round) sends every row outside it to -inf BEFORE salting; the
// salt maps -inf to -inf, so this equals the reference's mask-then-salt.
// A null mask (full rounds) reads every key as it is.
//
// Lanes (K14, the fleet's tenant axis): cc_select_candidates_lanes runs L
// independent selections in the same launches, grid dimension y = lane.
// Lane j reads key / mask row j of [L, n], salts with its own stall and
// keeps its own composites, radix state and histogram, so each lane's
// output is bit for bit a solo launch on its row (ties lowest index first
// within the lane). The solo entry point is the L = 1 case.
//
// Pooled keying (engine.py _select_candidates with compact_keying, :179-225):
// cc_select_pooled first compacts each lane's eligible rows (key > -inf
// after the seed mask) with the compaction launches below and leaves the
// eligible count on the device. The selection then chooses its branch ON
// THE DEVICE from that count, as the reference's lax.cond does: the pool
// (its first `pool` compacted slots, padded with the sentinel n) when the
// count is at most `pool`, else the full n rows. Grids are sized for n and
// threads past the lane's live length return, so there is no host read and
// each lane of a fleet launch chooses for itself. In the pooled branch
// salt_pack reads key[order[j]] and hashes order[j], the ORIGINAL replica
// id (_stall_explore(..., idx=idx)), so every live row's composite is the
// full sweep's and the live rows come out bit for bit as the full path
// orders them. Pad slots (-inf, below every live row) carry their position
// in the low word to stay unique and come out with kv -inf and id n - 1,
// the reference's min(order, R - 1). init_state adds one to the branch
// counter (pooled, full) of each lane it initialises, on the device.
//
// compact_eligible replaces engine.py _compact_eligible (:1257): the indices
// of the true entries of bool[n] in index order, the tail padded with the
// sentinel n, and their count. Three launches: per-tile counts, one scan of
// the tile counts, then each tile writes its rows at its offset plus the
// row's rank among the tile's true rows (warp ballots + a block scan of the
// warp counts). No atomics: the order is the index order by construction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

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

__device__ __forceinline__ int live_len(const long long* elig_n, long long lane, int n,
                                        int pool) {
  return pooled_lane(elig_n, lane, pool) ? pool : n;
}

__global__ void salt_pack(const float* __restrict__ key,
                          const unsigned char* __restrict__ mask, int n,
                          int stall0, const int* __restrict__ stalls, int salt,
                          const long long* __restrict__ elig_n,
                          const long long* __restrict__ order, int pool,
                          u64* __restrict__ comp) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long lane = blockIdx.y;
  if (i >= live_len(elig_n, lane, n, pool)) return;
  key += lane * n;
  if (mask != nullptr) mask += lane * n;
  comp += lane * n;
  const int stall = stalls != nullptr ? stalls[lane] : stall0;
  uint32_t id = (uint32_t)i, low = ~(uint32_t)i;
  float v;
  if (pooled_lane(elig_n, lane, pool)) {
    // slot i of the compacted pool: an eligible row (it passed the mask)
    // or the sentinel n (a pad, -inf, its position keeps it unique)
    const long long p = order[lane * n + i];
    const bool real = p < n;
    id = real ? (uint32_t)p : (uint32_t)(n - 1);
    low = real ? ~id : ~(uint32_t)i;
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
  comp[i] = ((u64)sortable_bits(v) << 32) | (u64)low;
}

// state[0] = prefix of the k-th composite found so far, state[1] = rank of
// the k-th within the current prefix, state[2] = gather counter.
__global__ void init_state(u64* state, unsigned int* hist, int k,
                           const long long* __restrict__ elig_n, int pool,
                           u64* __restrict__ branch) {
  const long long lane = blockIdx.x;
  state += 4 * lane;
  hist += 256 * lane;
  if (threadIdx.x == 0) {
    state[0] = 0ull;
    state[1] = (u64)k;
    state[2] = 0ull;
    if (branch != nullptr) atomicAdd(&branch[pooled_lane(elig_n, lane, pool) ? 0 : 1], 1ull);
  }
  for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0u;
}

__global__ void radix_hist(const u64* __restrict__ comp, int n,
                           const u64* __restrict__ state, int shift,
                           unsigned int* __restrict__ hist,
                           const long long* __restrict__ elig_n, int pool) {
  __shared__ unsigned int sh[256];
  const long long lane = blockIdx.y;
  const int n_live = live_len(elig_n, lane, n, pool);
  comp += lane * n;
  state += 4 * lane;
  hist += 256 * lane;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) sh[b] = 0u;
  __syncthreads();
  const u64 prefix = state[0];
  const u64 mask = (shift >= 56) ? 0ull : ~((1ull << (shift + 8)) - 1ull);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_live;
       i += gridDim.x * blockDim.x) {
    u64 c = comp[i];
    if ((c & mask) == (prefix & mask)) {
      atomicAdd(&sh[(unsigned)((c >> shift) & 255ull)], 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    if (sh[b]) atomicAdd(&hist[b], sh[b]);
  }
}

__global__ void radix_choose(u64* state, unsigned int* hist, int shift) {
  state += 4 * blockIdx.x;
  hist += 256 * blockIdx.x;
  if (threadIdx.x == 0) {
    const u64 k_rem = state[1];
    u64 cum = 0ull;
    for (int b = 255; b >= 0; --b) {
      const u64 h = (u64)hist[b];
      if (cum + h >= k_rem) {
        state[0] |= ((u64)b << shift);
        state[1] = k_rem - cum;
        break;
      }
      cum += h;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0u;
}

__global__ void gather_top(const u64* __restrict__ comp, int n, int k, u64* state,
                           u64* __restrict__ sel, const long long* __restrict__ elig_n,
                           int pool) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long lane = blockIdx.y;
  if (i >= live_len(elig_n, lane, n, pool)) return;
  comp += lane * n;
  state += 4 * lane;
  sel += lane * k;
  const u64 c = comp[i];
  if (c >= state[0]) {
    const u64 p = atomicAdd(&state[2], 1ull);
    sel[p] = c;
  }
}

__global__ void bitonic_top(const u64* __restrict__ sel, int k, int kpad,
                            float* __restrict__ out_kv,
                            long long* __restrict__ out_idx,
                            const long long* __restrict__ elig_n, int pool, int n) {
  extern __shared__ u64 s[];
  const long long lane = blockIdx.x;
  const bool pooled = pooled_lane(elig_n, lane, pool);
  sel += lane * k;
  out_kv += lane * k;
  out_idx += lane * k;
  for (int i = threadIdx.x; i < kpad; i += blockDim.x) {
    s[i] = (i < k) ? sel[i] : 0ull;   // pads sort below every real row
  }
  __syncthreads();
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kpad; i += blockDim.x) {
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
  const uint32_t neg_inf = sortable_bits(-INFINITY);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const u64 c = s[i];
    const uint32_t hi = (uint32_t)(c >> 32);
    out_kv[i] = from_sortable(hi);
    // a pooled lane's -inf slots are pads: id n - 1, as min(order, R - 1)
    out_idx[i] = (pooled && hi == neg_inf)
                     ? (long long)(n - 1)
                     : (long long)(~(uint32_t)(c & 0xFFFFFFFFull));
  }
}

constexpr int kTile = 1024;

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

static int launch_select(const float* key, const unsigned char* mask, int L, int n,
                         int k, int stall, const int* stalls, int salt, u64* comp,
                         u64* sel, u64* state, unsigned int* hist, float* out_kv,
                         long long* out_idx, cudaStream_t stream,
                         const long long* elig_n = nullptr,
                         const long long* order = nullptr, int pool = 0,
                         u64* branch = nullptr) {
  if (L <= 0 || L > 65535 || n <= 0 || k <= 0 || k > n || k > 16384)
    return (int)cudaErrorInvalidValue;
  int kpad = 1;
  while (kpad < k) kpad <<= 1;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const int hist_blocks = blocks < 1024 ? blocks : 1024;
  init_state<<<L, 256, 0, stream>>>(state, hist, k, elig_n, pool, branch);
  salt_pack<<<dim3(blocks, L), threads, 0, stream>>>(key, mask, n, stall, stalls, salt,
                                                     elig_n, order, pool, comp);
  for (int shift = 56; shift >= 0; shift -= 8) {
    radix_hist<<<dim3(hist_blocks, L), threads, 0, stream>>>(comp, n, state, shift,
                                                            hist, elig_n, pool);
    radix_choose<<<L, 256, 0, stream>>>(state, hist, shift);
  }
  gather_top<<<dim3(blocks, L), threads, 0, stream>>>(comp, n, k, state, sel, elig_n,
                                                      pool);
  const int smem = kpad * (int)sizeof(u64);
  cudaFuncSetAttribute(bitonic_top, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  bitonic_top<<<L, 1024, smem, stream>>>(sel, k, kpad, out_kv, out_idx, elig_n, pool, n);
  return (int)cudaGetLastError();
}

extern "C" int cc_select_candidates(const float* key,
                                    const unsigned char* mask, int n, int k,
                                    int stall,
                                    int salt, u64* comp, u64* sel,
                                    u64* state, unsigned int* hist,
                                    float* out_kv, long long* out_idx,
                                    void* stream_ptr) {
  return launch_select(key, mask, 1, n, k, stall, nullptr, salt, comp, sel, state,
                       hist, out_kv, out_idx, (cudaStream_t)stream_ptr);
}

// L lanes: key / mask [L, n], stalls int32[L] on the device, scratch and
// outputs with one row per lane (comp [L, n], sel [L, k], state [L, 4],
// hist [L, 256], out [L, k]).
extern "C" int cc_select_candidates_lanes(const float* key,
                                          const unsigned char* mask, int L, int n,
                                          int k, const int* stalls, int salt,
                                          u64* comp, u64* sel, u64* state,
                                          unsigned int* hist, float* out_kv,
                                          long long* out_idx, void* stream_ptr) {
  if (stalls == nullptr) return (int)cudaErrorInvalidValue;
  return launch_select(key, mask, L, n, k, 0, stalls, salt, comp, sel, state, hist,
                       out_kv, out_idx, (cudaStream_t)stream_ptr);
}

// Pooled keying of L lanes (L = 1 and stalls null: the solo launch with
// stall0): the compaction of each lane's eligible rows into order [L, n]
// with its count in elig_n [L], then the selection over the pool or the
// full rows, chosen per lane on the device; branch[0] / branch[1] count the
// lanes that took the pooled / full branch. pool < n, 2k <= pool.
extern "C" int cc_select_pooled(const float* key, const unsigned char* mask, int L,
                                int n, int k, int pool, int stall0, const int* stalls,
                                int salt, int* counts, long long* order,
                                long long* elig_n, u64* comp, u64* sel, u64* state,
                                unsigned int* hist, float* out_kv, long long* out_idx,
                                u64* branch, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (L <= 0 || L > 65535 || n <= 0 || pool <= 0 || pool >= n || k <= 0 ||
      2 * k > pool || (L > 1 && stalls == nullptr))
    return (int)cudaErrorInvalidValue;
  launch_compact(nullptr, key, mask, L, n, pool, counts, order, n, elig_n, stream);
  return launch_select(key, mask, L, n, k, stall0, stalls, salt, comp, sel, state, hist,
                       out_kv, out_idx, stream, elig_n, order, pool, branch);
}
