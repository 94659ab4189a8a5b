// K3 wave_admission: budgeted admission of one score-sorted wave of moves or
// leadership transfers.
//
// Replaces cruise_control_tpu/analyzer/engine.py _wave_admission (:555),
// _group_cumsum (:648), the partition first-touch of _move_wave (:846-851)
// and the one-row-per-candidate / partition first-touch of the segment
// waves (_segment_move_wave :1552-1557, _segment_lead_wave :1639-1640).
//
// For each side (source, destination, and with per-(topic, broker) budgets
// the topic-source and topic-destination pairs) rows group by their key
// (rows outside the wave are singletons), a stable sort orders the groups,
// ONE global inclusive cumsum runs in sorted order and the prefix before
// each group start is subtracted (the reference's arithmetic, not a
// per-group restart). The cumsum follows the CPU oracle's XLA order: blocks
// of 16 scanned left to right, the block totals scanned the same way
// (recursively, as many levels as the row count needs), the exclusive block
// prefix added back.
//
// Design, five launches on the stream:
//   ft_init / ft_cand / ft_part: first-touch tables by integer atomicMin
//     (the minimum row position per candidate and per partition: exact in
//     any order), giving the wave rows `ok` and the partition winners;
//   side_scan: one CTA (1024 threads) per side: bitonic sort of unique
//     (group << 32 | row) keys in dynamic shared memory (N <= 16384: 128 KB),
//     the XLA-order scan in global scratch, group starts by a block-wide
//     prefix max (O(N), no walk back), per-row in-group cumsum and rank;
//   finish: one thread per row: budget compares, gain caps, the verdict.
// Bound: latency; the sorts are O(N log^2 N) on one CTA per side.
//
// Lanes (K14, the fleet's tenant axis): grid dimension y = lane, so
// side_scan runs one CTA per (side, lane). Every input is the [L, ...]
// stack of L solo launches' arguments (rows [L, N, ...], slack and gain
// tables [L, B, ...]); each lane has its own first-touch tables, scratch,
// cumsums and ranks, so its verdicts are its solo launch's bit for bit.
// The solo entry point is L = 1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kMaxN = 16384;
constexpr int kDims = 8;
constexpr int kBase = 16;
constexpr int kThreads = 1024;
constexpr int kInf = 0x7FFFFFFF;

__global__ void ft_init(int* __restrict__ first, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  first += (long long)blockIdx.y * n;
  if (j < n) first[j] = kInf;
}

__global__ void ft_cand(int N, const unsigned char* __restrict__ wave_ok,
                        const long long* __restrict__ kgroup,
                        int* __restrict__ first_k, int nfirst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long y = blockIdx.y;
  wave_ok += y * N;
  kgroup += y * N;
  first_k += y * nfirst;
  if (i < N && wave_ok[i]) atomicMin(&first_k[kgroup[i]], i);
}

__global__ void ft_part(int N, const unsigned char* __restrict__ wave_ok,
                        const long long* __restrict__ kgroup,
                        const int* __restrict__ first_k,
                        const long long* __restrict__ part,
                        int* __restrict__ first_p, unsigned char* __restrict__ ok,
                        int nfirst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long y = blockIdx.y;
  wave_ok += y * N;
  if (kgroup != nullptr) kgroup += y * N;
  first_k += y * nfirst;
  if (part != nullptr) part += y * N;
  first_p += y * nfirst;
  ok += y * N;
  bool o = wave_ok[i] != 0;
  if (kgroup != nullptr) o = o && first_k[kgroup[i]] == i;
  ok[i] = o ? 1 : 0;
  if (part != nullptr && o) atomicMin(&first_p[part[i]], i);
}

// Inclusive scan over the rows of X[rows][C] in the XLA reduce-window
// rewriter's order. `scratch` holds the levels of block totals.
__device__ void xla_scan(float* X, int n, int C, float* scratch) {
  const int tid = threadIdx.x;
  float* lvl[8];
  int len[8];
  lvl[0] = X;
  len[0] = n;
  int depth = 0;
  float* next = scratch;
  while (len[depth] > kBase) {
    float* a = lvl[depth];
    const int m = (len[depth] + kBase - 1) / kBase;
    for (int task = tid; task < m * C; task += blockDim.x) {
      const int blk = task / C, c = task % C;
      float acc = 0.0f;
      for (int j = 0; j < kBase; ++j) {
        const int r = blk * kBase + j;
        acc = acc + a[r * C + c];
        a[r * C + c] = acc;
      }
    }
    __syncthreads();
    const int mpad = ((m + kBase - 1) / kBase) * kBase;
    for (int task = tid; task < mpad * C; task += blockDim.x) {
      const int blk = task / C, c = task % C;
      next[task] = blk < m ? a[(blk * kBase + kBase - 1) * C + c] : 0.0f;
    }
    __syncthreads();
    ++depth;
    lvl[depth] = next;
    len[depth] = m;
    next += mpad * C;
  }
  {
    float* a = lvl[depth];
    if (tid < C) {
      float acc = 0.0f;
      for (int r = 0; r < len[depth]; ++r) {
        acc = acc + a[r * C + tid];
        a[r * C + tid] = acc;
      }
    }
    __syncthreads();
  }
  for (int d = depth - 1; d >= 0; --d) {
    float* a = lvl[d];
    const float* g = lvl[d + 1];
    for (int task = tid; task < len[d] * C; task += blockDim.x) {
      const int r = task / C, c = task % C;
      const int blk = r / kBase;
      const float e = blk == 0 ? 0.0f : g[(blk - 1) * C + c];
      a[task] = a[task] + e;
    }
    __syncthreads();
  }
}

// sides: 0 source, 1 destination, 2 topic-source, 3 topic-destination
__global__ void side_scan(int N, int B, int nT, int G,
                          const unsigned char* __restrict__ ok,
                          const long long* __restrict__ src_b,
                          const long long* __restrict__ dst_b,
                          const long long* __restrict__ topics,
                          const float* __restrict__ d_src,
                          const float* __restrict__ d_dst,
                          const float* __restrict__ tdelta, float* __restrict__ fscratch,
                          int fstride, float* __restrict__ cum, int* __restrict__ rank,
                          int sides) {
  extern __shared__ u64 keys[];
  __shared__ int chunk_max[kThreads];
  const int side = blockIdx.x;
  {
    const long long y = blockIdx.y;
    ok += y * N;
    src_b += y * N;
    dst_b += y * N;
    if (topics != nullptr) topics += y * N;
    d_src += y * N * kDims;
    d_dst += y * N * kDims;
    if (tdelta != nullptr) tdelta += y * N * G;
    fscratch += y * sides * (long long)fstride;
    cum += y * sides * (long long)N * kDims;
    rank += y * sides * (long long)N;
  }
  const int tid = threadIdx.x;
  const int C = side < 2 ? kDims : G;
  int kpad = 1;
  while (kpad < N) kpad <<= 1;
  const long long* bro = (side == 0 || side == 2) ? src_b : dst_b;
  for (int i = tid; i < kpad; i += blockDim.x) {
    if (i < N) {
      uint32_t g;
      if (side < 2) {
        g = ok[i] ? (uint32_t)bro[i] : (uint32_t)(B + i);
      } else {
        g = ok[i] ? (uint32_t)(topics[i] * B + bro[i]) : (uint32_t)(nT * B + i);
      }
      keys[i] = ((u64)g << 32) | (u64)(uint32_t)i;
    } else {
      keys[i] = ~0ull;
    }
  }
  __syncthreads();
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < kpad; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool asc = (i & size) == 0;
          const u64 a = keys[i], b = keys[j];
          if (asc ? (a > b) : (a < b)) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int n16 = ((N + kBase - 1) / kBase) * kBase;
  float* W = fscratch + (long long)side * fstride;
  float* lv = W + n16 * kDims;
  for (int task = tid; task < n16 * C; task += blockDim.x) {
    const int s = task / C, c = task % C;
    float v = 0.0f;
    if (s < N) {
      const int r = (int)(keys[s] & 0xFFFFFFFFull);
      if (ok[r]) {
        v = side == 0 ? d_src[r * kDims + c]
            : side == 1 ? d_dst[r * kDims + c] : tdelta[r * G + c];
      }
    }
    W[task] = v;
  }
  __syncthreads();
  xla_scan(W, N, C, lv);
  // group starts: start(s) = max over s' <= s of (is_start(s') ? s' : 0)
  const int per = (N + kThreads - 1) / kThreads;
  const int lo = tid * per, hi = min(N, lo + per);
  int run = 0;
  for (int s = lo; s < hi; ++s) {
    if (s == 0 || (keys[s] >> 32) != (keys[s - 1] >> 32)) run = s;
  }
  chunk_max[tid] = run;
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int t = 0; t < kThreads; ++t) {
      const int v = chunk_max[t];
      chunk_max[t] = acc;
      acc = v > acc ? v : acc;
    }
  }
  __syncthreads();
  run = chunk_max[tid];
  float* cum_side = cum + (long long)side * N * kDims;
  int* rank_side = rank + (long long)side * N;
  for (int s = lo; s < hi; ++s) {
    if (s == 0 || (keys[s] >> 32) != (keys[s - 1] >> 32)) run = s;
    const int r = (int)(keys[s] & 0xFFFFFFFFull);
    rank_side[r] = s - run;
    for (int c = 0; c < C; ++c) {
      const float base = run > 0 ? W[(run - 1) * C + c] : 0.0f;
      cum_side[r * kDims + c] = W[s * C + c] - base;
    }
  }
}

__global__ void finish(int N, int G, int gain_dim, const unsigned char* __restrict__ ok,
                       const long long* __restrict__ part,
                       const int* __restrict__ first_p,
                       const long long* __restrict__ src_b,
                       const long long* __restrict__ dst_b,
                       const float* __restrict__ d_src, const float* __restrict__ d_dst,
                       const float* __restrict__ src_slack,
                       const float* __restrict__ dst_slack,
                       const float* __restrict__ tdelta,
                       const float* __restrict__ ts_slack,
                       const float* __restrict__ td_slack,
                       const float* __restrict__ src_gain,
                       const float* __restrict__ dst_gain,
                       const unsigned char* __restrict__ gain_escape,
                       const float* __restrict__ cum, const int* __restrict__ rank,
                       unsigned char* __restrict__ win, int B, int sides, int nfirst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  {
    const long long y = blockIdx.y;
    ok += y * N;
    if (part != nullptr) part += y * N;
    first_p += y * nfirst;
    src_b += y * N;
    dst_b += y * N;
    d_src += y * N * kDims;
    d_dst += y * N * kDims;
    src_slack += y * B * kDims;
    dst_slack += y * B * kDims;
    if (tdelta != nullptr) {
      tdelta += y * N * G;
      ts_slack += y * N * G;
      td_slack += y * N * G;
    }
    if (src_gain != nullptr) {
      src_gain += y * B;
      dst_gain += y * B;
    }
    if (gain_escape != nullptr) gain_escape += y * N;
    cum += y * sides * (long long)N * kDims;
    rank += y * sides * (long long)N;
    win += y * N;
  }
  const bool o = ok[i] != 0;
  bool admit = o;
  const float* cum0 = cum;
  const float* cum1 = cum + (long long)N * kDims;
  for (int g = 0; g < G && admit; ++g) {
    const float delta = o ? tdelta[i * G + g] : 0.0f;
    const bool freed = delta == 0.0f;
    const float* cum2 = cum + 2ll * N * kDims;
    const float* cum3 = cum + 3ll * N * kDims;
    const bool a = freed || rank[2 * N + i] == 0
                   || cum2[i * kDims + g] <= ts_slack[i * G + g] + 1e-4f;
    const bool b = freed || rank[3 * N + i] == 0
                   || cum3[i * kDims + g] <= td_slack[i * G + g] + 1e-4f;
    admit = a && b;
  }
  const long long sb = src_b[i], db = dst_b[i];
  if (admit && rank[i] != 0) {
    for (int c = 0; c < kDims; ++c) {
      admit = admit && cum0[i * kDims + c] <= src_slack[sb * kDims + c] + 1e-4f;
    }
  }
  if (admit && rank[N + i] != 0) {
    for (int c = 0; c < kDims; ++c) {
      admit = admit && cum1[i * kDims + c] <= dst_slack[db * kDims + c] + 1e-4f;
    }
  }
  if (admit && gain_dim >= 0) {
    const float ds = o ? d_src[i * kDims + gain_dim] : 0.0f;
    const float dd = o ? d_dst[i * kDims + gain_dim] : 0.0f;
    const float excl_src = cum0[i * kDims + gain_dim] - ds;
    const float excl_dst = cum1[i * kDims + gain_dim] - dd;
    const float sg = src_gain[sb], dg = dst_gain[db];
    admit = (sg > 0.0f && excl_src < sg) || (dg > 0.0f && excl_dst < dg)
            || (gain_escape != nullptr && gain_escape[i] != 0);
  }
  if (admit && part != nullptr) admit = first_p[part[i]] == i;
  win[i] = admit ? 1 : 0;
}

}  // namespace

extern "C" int cc_wave_admission_lanes(
    int L, int N, int B, int nT, int G, int gain_dim, int nk, int np,
    const float* d_src, const float* d_dst, const long long* src_b,
    const long long* dst_b, const unsigned char* wave_ok, const long long* kgroup,
    const long long* part, const long long* topics, const float* tdelta,
    const float* ts_slack, const float* td_slack, const float* src_slack,
    const float* dst_slack, const float* src_gain, const float* dst_gain,
    const unsigned char* gain_escape, int* first, unsigned char* ok,
    float* fscratch, float* cum, int* rank, unsigned char* win, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (L <= 0 || L > 65535 || N <= 0 || N > kMaxN || G < 0 || G > kDims ||
      gain_dim >= kDims)
    return (int)cudaErrorInvalidValue;
  if ((kgroup != nullptr && nk <= 0) || (part != nullptr && np <= 0))
    return (int)cudaErrorInvalidValue;
  if (G > 0 && (topics == nullptr || tdelta == nullptr)) return (int)cudaErrorInvalidValue;
  const int tpb = 256;
  const int nb = (N + tpb - 1) / tpb;
  int* first_k = first;
  int* first_p = first + (nk > 0 ? nk : 0);
  const int nfirst = (nk > 0 ? nk : 0) + (np > 0 ? np : 0);
  const int nf = nfirst > 0 ? nfirst : 1;   // the per-lane stride of `first`
  if (nfirst > 0)
    ft_init<<<dim3((nfirst + tpb - 1) / tpb, L), tpb, 0, stream>>>(first, nf);
  if (kgroup != nullptr)
    ft_cand<<<dim3(nb, L), tpb, 0, stream>>>(N, wave_ok, kgroup, first_k, nf);
  ft_part<<<dim3(nb, L), tpb, 0, stream>>>(N, wave_ok, kgroup, first_k, part, first_p,
                                            ok, nf);
  int kpad = 1;
  while (kpad < N) kpad <<= 1;
  const int smem = kpad * (int)sizeof(u64);
  cudaFuncSetAttribute(side_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int n16 = ((N + kBase - 1) / kBase) * kBase;
  const int fstride = 2 * n16 * kDims + 64 * kDims;
  const int sides = G > 0 ? 4 : 2;
  side_scan<<<dim3(sides, L), kThreads, smem, stream>>>(
      N, B, nT, G, ok, src_b, dst_b, topics, d_src, d_dst, tdelta, fscratch,
      fstride, cum, rank, sides);
  finish<<<dim3(nb, L), tpb, 0, stream>>>(N, G, gain_dim, ok, part, first_p, src_b,
                                          dst_b, d_src, d_dst, src_slack, dst_slack,
                                          tdelta, ts_slack, td_slack, src_gain,
                                          dst_gain, gain_escape, cum, rank, win, B,
                                          sides, nf);
  return (int)cudaGetLastError();
}

extern "C" int cc_wave_admission(
    int N, int B, int nT, int G, int gain_dim, int nk, int np,
    const float* d_src, const float* d_dst, const long long* src_b,
    const long long* dst_b, const unsigned char* wave_ok, const long long* kgroup,
    const long long* part, const long long* topics, const float* tdelta,
    const float* ts_slack, const float* td_slack, const float* src_slack,
    const float* dst_slack, const float* src_gain, const float* dst_gain,
    const unsigned char* gain_escape, int* first, unsigned char* ok,
    float* fscratch, float* cum, int* rank, unsigned char* win, void* stream_ptr) {
  return cc_wave_admission_lanes(1, N, B, nT, G, gain_dim, nk, np, d_src, d_dst, src_b,
                                 dst_b, wave_ok, kgroup, part, topics, tdelta,
                                 ts_slack, td_slack, src_slack, dst_slack, src_gain,
                                 dst_gain, gain_escape, first, ok, fscratch, cum, rank,
                                 win, stream_ptr);
}
