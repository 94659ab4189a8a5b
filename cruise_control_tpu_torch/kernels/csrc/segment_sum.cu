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
// Design: segment_sum launches one CTA (256 threads = 8 warps) per segment.
// The CTA streams the segment ids in tiles of 256 rows, finds the tile's
// rows of its segment with warp ballots, compacts them in row order into
// shared memory, and threads c < C accumulate column c over them in order.
// Every CTA re-reads all N ids (from L2), so the cost is O(N x segments):
// simple and exact; a sort-based version is the later, faster step.
// segment_count adds integer weights with atomics (exact in any order).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void segment_sum_kernel(const float* __restrict__ vals,
                                   const long long* __restrict__ seg, int N,
                                   int C, const float* __restrict__ init,
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
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
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

__global__ void segment_count_kernel(const long long* __restrict__ seg,
                                     const int* __restrict__ w, int N, int nseg,
                                     int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long s = seg[i];
  if (s >= 0 && s < nseg) atomicAdd(&out[s], w != nullptr ? w[i] : 1);
}

}  // namespace

extern "C" int cc_segment_sum(const float* vals, const long long* seg, int N,
                              int C, int nseg, const float* init, float* out,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (C <= 0 || C > 32 || nseg <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<nseg, kThreads, 0, stream>>>(vals, seg, N, C, init, out);
  return (int)cudaGetLastError();
}

extern "C" int cc_segment_count(const long long* seg, const int* w, int N,
                                int nseg, int* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (nseg <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  segment_count_kernel<<<(N + 255) / 256, 256, 0, stream>>>(seg, w, N, nseg, out);
  return (int)cudaGetLastError();
}
