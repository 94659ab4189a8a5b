// K3 wave_admission: budgeted admission of one score-sorted move wave.
//
// Replaces cruise_control_tpu/analyzer/engine.py _wave_admission (:555),
// _group_cumsum (:648) and the partition first-touch of _move_wave
// (:846-851). For each side (source, destination): rows group by broker
// (rows outside the wave are singletons B + row), a stable sort orders the
// groups, ONE global inclusive cumsum runs in sorted order and the prefix
// before each group start is subtracted (the reference's arithmetic, not a
// per-group restart). The cumsum follows the CPU oracle's XLA order: blocks
// of 16 scanned left to right, block totals scanned the same way, the
// exclusive block prefix added back.
//
// Design: one CTA (1024 threads) for the whole wave, K <= 2048. Stable
// group order = bitonic sort of unique (group << 32 | row) keys in shared
// memory. Ranks walk back to the group start; partition first-touch is an
// O(K^2/2) scan over earlier rows. Bound: latency (a single CTA; the work
// is a few hundred thousand operations).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kMaxK = 2048;
constexpr int kDims = 8;
constexpr int kBase = 16;
constexpr int kMaxM1 = kMaxK / kBase;   // 128 level-1 blocks
constexpr int kMaxM2 = kMaxM1 / kBase;  // 8 level-2 blocks

// In-place inclusive scan over rows of W[n16][8] (rows >= n are zero) in
// the XLA reduce-window rewriter's order.
__device__ void xla_scan(float* W, int n, float* lvl2, float* excl1,
                         float* excl2) {
  const int tid = threadIdx.x;
  if (n <= kBase) {
    if (tid < kDims) {
      float acc = 0.0f;
      for (int r = 0; r < n; ++r) {
        acc = acc + W[r * kDims + tid];
        W[r * kDims + tid] = acc;
      }
    }
    __syncthreads();
    return;
  }
  const int m1 = (n + kBase - 1) / kBase;
  for (int task = tid; task < m1 * kDims; task += blockDim.x) {
    const int blk = task / kDims, c = task % kDims;
    float acc = 0.0f;
    for (int j = 0; j < kBase; ++j) {
      const int r = blk * kBase + j;
      acc = acc + W[r * kDims + c];
      W[r * kDims + c] = acc;
    }
  }
  __syncthreads();
  if (m1 <= kBase) {
    if (tid < kDims) {
      float acc = 0.0f;
      for (int blk = 0; blk < m1; ++blk) {
        excl1[blk * kDims + tid] = acc;
        acc = acc + W[(blk * kBase + kBase - 1) * kDims + tid];
      }
    }
  } else {
    const int m2 = (m1 + kBase - 1) / kBase;
    for (int task = tid; task < m2 * kDims; task += blockDim.x) {
      const int b2 = task / kDims, c = task % kDims;
      float acc = 0.0f;
      for (int j = 0; j < kBase; ++j) {
        const int blk = b2 * kBase + j;
        const float t = blk < m1 ? W[(blk * kBase + kBase - 1) * kDims + c] : 0.0f;
        acc = acc + t;
        lvl2[blk * kDims + c] = acc;
      }
    }
    __syncthreads();
    if (tid < kDims) {
      float acc = 0.0f;
      for (int b2 = 0; b2 < m2; ++b2) {
        excl2[b2 * kDims + tid] = acc;
        acc = acc + lvl2[(b2 * kBase + kBase - 1) * kDims + tid];
      }
    }
    __syncthreads();
    for (int task = tid; task < m1 * kDims; task += blockDim.x) {
      const int j = task / kDims, c = task % kDims;
      excl1[j * kDims + c] =
          j == 0 ? 0.0f
                 : lvl2[(j - 1) * kDims + c] + excl2[((j - 1) / kBase) * kDims + c];
    }
  }
  __syncthreads();
  for (int task = tid; task < n * kDims; task += blockDim.x) {
    const int r = task / kDims, c = task % kDims;
    W[task] = W[task] + excl1[(r / kBase) * kDims + c];
  }
  __syncthreads();
}

__global__ void wave_admission_kernel(
    int K, int B, int gain_dim, int has_gain, const float* __restrict__ d,
    const long long* __restrict__ src_b, const long long* __restrict__ dst_b,
    const unsigned char* __restrict__ wave_ok, const long long* __restrict__ part,
    const float* __restrict__ src_slack, const float* __restrict__ dst_slack,
    const float* __restrict__ src_gain, const float* __restrict__ dst_gain,
    const unsigned char* __restrict__ gain_escape, float* __restrict__ fscratch,
    int* __restrict__ iscratch, unsigned char* __restrict__ win) {
  __shared__ u64 keys[kMaxK];
  __shared__ int order[kMaxK];
  __shared__ int spart[kMaxK];
  __shared__ unsigned char sok[kMaxK];
  __shared__ float lvl2[kMaxM1 * kDims];
  __shared__ float excl1[kMaxM1 * kDims];
  __shared__ float excl2[kMaxM2 * kDims];
  const int tid = threadIdx.x;
  int kpad = 1;
  while (kpad < K) kpad <<= 1;
  const int n16 = ((K + kBase - 1) / kBase) * kBase;
  float* W = fscratch;                       // [n16][8] sorted-order scan
  float* cum[2] = {fscratch + n16 * kDims, fscratch + n16 * kDims + K * kDims};
  int* rank[2] = {iscratch, iscratch + K};

  for (int i = tid; i < K; i += blockDim.x) {
    spart[i] = (int)part[i];
    sok[i] = wave_ok[i];
  }
  __syncthreads();

  for (int side = 0; side < 2; ++side) {
    const long long* bro = side == 0 ? src_b : dst_b;
    for (int i = tid; i < kpad; i += blockDim.x) {
      if (i < K) {
        const uint32_t g = sok[i] ? (uint32_t)bro[i] : (uint32_t)(B + i);
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
    for (int s = tid; s < K; s += blockDim.x) {
      order[s] = (int)(keys[s] & 0xFFFFFFFFull);
    }
    __syncthreads();
    for (int task = tid; task < n16 * kDims; task += blockDim.x) {
      const int s = task / kDims, c = task % kDims;
      float v = 0.0f;
      if (s < K) {
        const int r = order[s];
        v = sok[r] ? d[r * kDims + c] : 0.0f;
      }
      W[task] = v;
    }
    __syncthreads();
    xla_scan(W, K, lvl2, excl1, excl2);
    for (int s = tid; s < K; s += blockDim.x) {
      const u64 g = keys[s] >> 32;
      int start = s;
      while (start > 0 && (keys[start - 1] >> 32) == g) --start;
      const int r = order[s];
      rank[side][r] = s - start;
      for (int c = 0; c < kDims; ++c) {
        const float base = start > 0 ? W[(start - 1) * kDims + c] : 0.0f;
        cum[side][r * kDims + c] = W[s * kDims + c] - base;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < K; i += blockDim.x) {
    const bool ok = sok[i] != 0;
    bool admit = ok;
    for (int j = 0; j < i && admit; ++j) {
      if (sok[j] && spart[j] == spart[i]) admit = false;   // partition first-touch
    }
    const long long sb = src_b[i], db = dst_b[i];
    if (admit && rank[0][i] != 0) {
      for (int c = 0; c < kDims; ++c) {
        admit = admit && cum[0][i * kDims + c] <= src_slack[sb * kDims + c] + 1e-4f;
      }
    }
    if (admit && rank[1][i] != 0) {
      for (int c = 0; c < kDims; ++c) {
        admit = admit && cum[1][i * kDims + c] <= dst_slack[db * kDims + c] + 1e-4f;
      }
    }
    if (admit && has_gain) {
      const float dd = ok ? d[i * kDims + gain_dim] : 0.0f;
      const float excl_src = cum[0][i * kDims + gain_dim] - dd;
      const float excl_dst = cum[1][i * kDims + gain_dim] - dd;
      const float sg = src_gain[sb], dg = dst_gain[db];
      admit = (sg > 0.0f && excl_src < sg) || (dg > 0.0f && excl_dst < dg)
              || gain_escape[i] != 0;
    }
    win[i] = admit ? 1 : 0;
  }
}

}  // namespace

extern "C" int cc_wave_admission(int K, int B, int gain_dim, int has_gain,
                                 const float* d, const long long* src_b,
                                 const long long* dst_b,
                                 const unsigned char* wave_ok,
                                 const long long* part, const float* src_slack,
                                 const float* dst_slack, const float* src_gain,
                                 const float* dst_gain,
                                 const unsigned char* gain_escape,
                                 float* fscratch, int* iscratch,
                                 unsigned char* win, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (has_gain && (gain_dim < 0 || gain_dim >= kDims)) return (int)cudaErrorInvalidValue;
  wave_admission_kernel<<<1, 1024, 0, stream>>>(
      K, B, gain_dim, has_gain, d, src_b, dst_b, wave_ok, part, src_slack,
      dst_slack, src_gain, dst_gain, gain_escape, fscratch, iscratch, win);
  return (int)cudaGetLastError();
}
