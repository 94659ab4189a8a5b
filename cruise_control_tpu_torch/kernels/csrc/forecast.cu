// K15 forecast: masked Holt level + trend blended with an EWMA, per series.
//
// Replaces cruise_control_tpu/forecast/forecaster.py _holt_ewma_series
// (:59) under forecast_batch (:87): for every (entity e, metric m) series
// x[e, 0..W-1, m] with the valid-window mask mask[e, w], scan the windows
// in order carrying level, trend, ewma and seen; an invalid window leaves
// the carry untouched, the first valid one seeds (level = x, trend = 0,
// ewma = x). The forecast is blend * (level + horizon_w * trend)
// + (1 - blend) * ewma, clamped at 0 where the series was ever seen, else 0.
//
// Design: one thread per series, the carry in registers, the mask byte read
// once per window. The operations follow the reference's text in order. The
// reference's XLA:CPU program contracts five of its multiply-adds into FMAs
// (found by experiment; see kernels/forecast.py); the build's --fmad=false
// keeps every other multiply and add rounded on its own, and __fmaf_rn
// places the five FMAs where XLA:CPU has them, so the f32 bits are the plain
// twin's and the reference's. The knobs arrive as f32; the complements
// (1 - alpha, 1 - beta, 1 - blend) are rounded in f32 as the reference's
// traced scalars are. Bound: bytes (values, mask, output).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void forecast_kernel(const float* __restrict__ values,
                                const uint8_t* __restrict__ mask, int E, int W,
                                int M, float alpha, float beta, float blend,
                                float horizon_w, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)E * M) return;
  const int e = (int)(t / M);
  const int m = (int)(t % M);
  const float one_a = 1.0f - alpha;
  const float one_b = 1.0f - beta;
  const float one_blend = 1.0f - blend;
  float level = 0.0f, trend = 0.0f, ewma = 0.0f;
  bool seen = false;
  const float* x_row = values + (long long)e * W * M + m;
  const uint8_t* m_row = mask + (long long)e * W;
  for (int w = 0; w < W; ++w) {
    const float xi = x_row[(long long)w * M];
    if (!m_row[w]) continue;
    if (seen) {
      const float lvl_s = __fmaf_rn(alpha, xi, one_a * (level + trend));
      const float trd_s = __fmaf_rn(one_b, trend, beta * (lvl_s - level));
      const float ew_s = __fmaf_rn(alpha, xi, one_a * ewma);
      level = lvl_s;
      trend = trd_s;
      ewma = ew_s;
    } else {
      level = xi;
      trend = 0.0f;
      ewma = xi;
      seen = true;
    }
  }
  float res = 0.0f;
  if (seen) {
    const float inner = __fmaf_rn(horizon_w, trend, level);
    // a one-window program contracts the blend's other product
    const float fc = W == 1 ? __fmaf_rn(one_blend, ewma, blend * inner)
                            : __fmaf_rn(blend, inner, one_blend * ewma);
    res = fc > 0.0f ? fc : 0.0f;
    if (fc != fc) res = fc;  // NaN propagates, as jnp.maximum does
  }
  out[t] = res;
}

}  // namespace

extern "C" int cc_forecast(const float* values, const uint8_t* mask, int E,
                           int W, int M, float alpha, float beta, float blend,
                           float horizon_w, float* out, int* launches,
                           void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  *launches = 0;
  if (E < 0 || W <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)E * M;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  forecast_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      values, mask, E, W, M, alpha, beta, blend, horizon_w, out);
  *launches = 1;
  return (int)cudaGetLastError();
}
