// K13 seeded_probe: would any seed-mask row rank eligible for any action?
//
// Replaces cruise_control_tpu/analyzer/goals/base.py seeded_work_probe
// (:268), the reduction inside engine.py _compiled_goal_probe (:2298):
// any over r of mask[r] & (key_j[r] > -inf), for up to three f32[R] key
// arrays (the replica, leader and swap-out keys the goal uses). The goal's
// verdict and stat come from its own torch functions.
//
// Design: a grid-stride loop, a warp vote (__any_sync), one shared flag per
// block and one integer atomicOr into the i32 result, which the wrapper
// zeroes. OR is order-free, so the result is deterministic. NaN keys
// compare false, as in the reference. Bound: bytes (the mask and the keys
// read once).
//
// Lane form (K14, engine.py _compiled_fleet_probe :2377, the tenant vmap of
// the probe): cc_seeded_probe_lanes takes La lanes' masks and keys stacked
// [La, R] and answers every lane in one launch, grid dimension y = lane,
// one flag per lane. The solo launch is the L = 1 case.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void probe_kernel(const uint8_t* __restrict__ mask,
                             const float* __restrict__ k0,
                             const float* __restrict__ k1,
                             const float* __restrict__ k2, int R,
                             int* __restrict__ flag) {
  const long long lane = blockIdx.y;
  mask += lane * R;
  k0 += lane * R;
  if (k1 != nullptr) k1 += lane * R;
  if (k2 != nullptr) k2 += lane * R;
  flag += lane;
  __shared__ int block_hit;
  if (threadIdx.x == 0) block_hit = 0;
  __syncthreads();
  bool hit = false;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R && !hit;
       r += gridDim.x * blockDim.x) {
    if (mask[r]) {
      hit = k0[r] > -INFINITY || (k1 != nullptr && k1[r] > -INFINITY) ||
            (k2 != nullptr && k2[r] > -INFINITY);
    }
  }
  if (__any_sync(0xFFFFFFFFu, hit) && (threadIdx.x & 31) == 0) {
    block_hit = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_hit) atomicOr(flag, 1);
}

}  // namespace

extern "C" int cc_seeded_probe_lanes(int L, const uint8_t* mask, const float* k0,
                                     const float* k1, const float* k2, int R,
                                     int* flag, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (L <= 0 || L > 65535 || R <= 0 || k0 == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (R + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  const dim3 grid(blocks, L);
  probe_kernel<<<grid, threads, 0, stream>>>(mask, k0, k1, k2, R, flag);
  return (int)cudaGetLastError();
}
