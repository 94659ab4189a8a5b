// K5 session_finalize: the per-replica half of a resident session's sync.
//
// Replaces cruise_control_tpu/analyzer/session.py _sync_finalize (:102),
// the part before its refresh: unpack the bit-packed leadership upload
// (jnp.unpackbits is big-endian: replica r is bit 7 - r % 8 of byte r / 8),
// recompute the offline flags from broker and logdir liveness
// (offline = (!alive[b] | !disk_alive[b, d]) & valid), re-derive the
// topic-exclusion hoist (replica_topic_excluded = topic_excluded[topic])
// and destination candidacy (dst_candidate = alive & !excluded_for_move).
// The state's tallies then come from the existing refresh launches
// (segment_sum.cu), exactly as init_state runs them.
//
// Design: one thread per replica slot; threads r < B also write
// dst_candidate[r]. Gather indices are clamped into range, as XLA clamps
// an out-of-bounds gather. Bound: bytes (the three i64 index columns
// dominate: about 28 bytes read and 3 written per replica).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long clamp_idx(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void finalize_kernel(const uint8_t* __restrict__ lead_packed,
                                const long long* __restrict__ broker,
                                const long long* __restrict__ disk,
                                const long long* __restrict__ topic,
                                const bool* __restrict__ valid,
                                const bool* __restrict__ alive,
                                const bool* __restrict__ disk_alive,
                                const bool* __restrict__ topic_excluded,
                                const bool* __restrict__ excl_move, int R,
                                int B, int D, int T, bool* __restrict__ is_leader,
                                bool* __restrict__ offline,
                                bool* __restrict__ rtexcl,
                                bool* __restrict__ dst_candidate) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < B) dst_candidate[r] = alive[r] && !excl_move[r];
  if (r >= R) return;
  is_leader[r] = ((lead_packed[r >> 3] >> (7 - (r & 7))) & 1u) != 0u;
  const long long b = clamp_idx(broker[r], B);
  const long long d = clamp_idx(disk[r], D);
  offline[r] = (!alive[b] || !disk_alive[b * D + d]) && valid[r];
  rtexcl[r] = topic_excluded[clamp_idx(topic[r], T)];
}

}  // namespace

extern "C" int cc_session_finalize(const uint8_t* lead_packed,
                                   const long long* broker,
                                   const long long* disk,
                                   const long long* topic, const bool* valid,
                                   const bool* alive, const bool* disk_alive,
                                   const bool* topic_excluded,
                                   const bool* excl_move, int R, int B, int D,
                                   int T, bool* is_leader, bool* offline,
                                   bool* rtexcl, bool* dst_candidate,
                                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (R <= 0 || B <= 0 || D <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int n = R > B ? R : B;
  const int threads = 256;
  finalize_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      lead_packed, broker, disk, topic, valid, alive, disk_alive,
      topic_excluded, excl_move, R, B, D, T, is_leader, offline, rtexcl,
      dst_candidate);
  return (int)cudaGetLastError();
}
