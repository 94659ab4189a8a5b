// K7 swap_rows: [K1, K2] swap-pair legitimacy + folded chain vetoes +
// active-goal swap score, reduced per out row to the best value, its lowest
// argmax j and the count of pairs above min_gain.
// K7 swap_admission: first-use admission of one score-sorted swap wave.
//
// swap_rows replaces cruise_control_tpu/analyzer/engine.py
// _swap_branch_batched's _swap_rows (:1129-1141) and the rows of
// _swap_window_positives (:1414-1420), with goals/base.py legit_swap_mask
// (:417), the accept_swap of every previous goal and the swap_score of
// ResourceDistributionGoal (distribution.py:243-257) and
// TopicReplicaDistributionGoal (topic.py:160-194); the rack legs of
// RackAwareGoal and RackAwareDistributionGoal (base.py accept_swap :236 over
// their accept_move) take each moving row's own rack limit, others + 1 <=
// lim_out[i] / lim_in[j]. swap_admission replaces
// the .at[].min first-use admission of _swap_branch_batched (:1146-1177).
// The goal's [B]-level columns (fb), per-row loads and per-topic limits
// arrive precomputed with the reference's arithmetic; every float operation
// here is one IEEE add/sub/mul/max/compare (built with --fmad=false, no
// flush to zero: max(u + d - up, 0) <= 0 equals u + d <= up only with
// denormals kept).
//
// Design: swap_rows runs one CTA per out row, one thread per in candidate
// (K2 <= 128); the out row's sibling brokers sit in shared memory, the
// pair scores are staged in shared memory and thread 0 scans them with a
// strict '>' so the lowest j wins ties. swap_admission runs one CTA, one
// thread per sorted row, each checking every earlier eligible row: O(K1^2)
// integer compares, no atomics. Bound: latency (a few kilobytes and ~1e4
// operations at [32, 32]).
//
// Lane forms (K14, the fleet's tenant axis of engine.py _compiled_fleet_chunk
// :2324 over _swap_rows and the admission): cc_swap_rows_lanes and
// cc_swap_admission_lanes take La lanes' operands stacked [La, ...] and run
// grid dimension y = lane; each lane reads its own slice of every operand
// (with a lane index list, the broker racks and the (topic, broker) counts
// are row lanes[y] of a lane stack's tensors), so each lane's rows are its
// solo launch's bit for bit. The solo launches are the L = 1 case.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kResourceDist = 0;
constexpr int kTopicReplica = 1;
constexpr int kNetCapacity = 0;
constexpr int kNetBand = 1;
constexpr int kDirected = 2;
constexpr int kDirectedExempt = 3;
constexpr int kMaxK2 = 128;
constexpr int kMaxF = 64;

__device__ __forceinline__ float violation(float u, float lo, float up) {
  return fmaxf(u - up, 0.0f) + fmaxf(lo - u, 0.0f);
}

// distribution.py _gain: the violation-measure decrease of moving l from
// src to dst, and whether neither endpoint's violation grows.
__device__ __forceinline__ bool band_gain(float us, float ud, float l, float los,
                                          float ups, float lod, float upd,
                                          float* gain) {
  const float vso = violation(us, los, ups);
  const float vdo = violation(ud, lod, upd);
  const float vsn = violation(us - l, los, ups);
  const float vdn = violation(ud + l, lod, upd);
  *gain = (vso - vsn) + (vdo - vdn);
  return (vsn <= vso) && (vdn <= vdo);
}

__global__ void swap_rows_kernel(
    int K1, int K2, int F, int B, int T, int Kr, int family, int V,
    int topic_veto, int vkinds, float min_gain, const long long* __restrict__ lanes,
    const long long* __restrict__ b_out, const long long* __restrict__ b_in,
    const long long* __restrict__ sib_out, const long long* __restrict__ sib_in,
    const long long* __restrict__ orig_out, const long long* __restrict__ orig_in,
    const unsigned char* __restrict__ row_ok_out,
    const unsigned char* __restrict__ row_ok_in,
    const unsigned char* __restrict__ new_ok,
    const long long* __restrict__ broker_rack,
    const long long* __restrict__ prow_out, const long long* __restrict__ prow_in,
    const int* __restrict__ lim_out, const int* __restrict__ lim_in,
    const long long* __restrict__ t_out, const long long* __restrict__ t_in,
    const int* __restrict__ tab, const float* __restrict__ va, const float* __restrict__ vc,
    const float* __restrict__ vl, const float* __restrict__ vxo,
    const float* __restrict__ vxi, const float* __restrict__ fb,
    const float* __restrict__ fo, const float* __restrict__ fi,
    const float* __restrict__ tl, const float* __restrict__ topic_up,
    float* __restrict__ best, long long* __restrict__ best_j,
    int* __restrict__ positives) {
  __shared__ float sc[kMaxK2];
  __shared__ long long sib[kMaxF];
  const int i = blockIdx.x;
  // the lane's slice of every operand (lane 0: the solo launch)
  const long long lane = blockIdx.y;
  const long long row = lanes != nullptr ? lanes[lane] : lane;
  broker_rack += row * B;
  tab += row * (long long)T * B;
  if (lane > 0) {
    b_out += lane * K1;
    b_in += lane * K2;
    sib_out += lane * K1 * F;
    sib_in += lane * K2 * F;
    orig_out += lane * K1;
    orig_in += lane * K2;
    row_ok_out += lane * K1;
    row_ok_in += lane * K2;
    new_ok += lane * B;
    if (prow_out != nullptr) prow_out += lane * K1 * Kr;
    if (prow_in != nullptr) prow_in += lane * K2 * Kr;
    if (lim_out != nullptr) lim_out += lane * K1;
    if (lim_in != nullptr) lim_in += lane * K2;
    t_out += lane * K1;
    t_in += lane * K2;
    if (V > 0) {
      va += lane * V * B;
      vc += lane * V * B;
      vl += lane * V * B;
      vxo += lane * V * K1;
      vxi += lane * V * K2;
    }
    if (fb != nullptr) fb += lane * 3 * B;
    if (fo != nullptr) fo += lane * K1;
    if (fi != nullptr) fi += lane * K2;
    if (tl != nullptr) tl += lane * 2 * T;
    if (topic_up != nullptr) topic_up += lane * T;
    best += lane * K1;
    best_j += lane * K1;
    positives += lane * K1;
  }
  for (int f = threadIdx.x; f < F; f += blockDim.x) sib[f] = sib_out[(long long)i * F + f];
  __syncthreads();

  const int j = threadIdx.x;
  if (j < K2) {
    float s = -INFINITY;
    const long long bo = b_out[i];
    const long long bi = b_in[j];
    bool ok = row_ok_out[i] && row_ok_in[j] && bo != bi;
    for (int f = 0; f < F && ok; ++f) ok = sib[f] != bi;
    for (int f = 0; f < F && ok; ++f) ok = sib_in[(long long)j * F + f] != bo;
    if (ok) ok = (new_ok[bi] || bi == orig_out[i]) && (new_ok[bo] || bo == orig_in[j]);
    for (int v = 0; v < V && ok; ++v) {
      const float* a = va + (long long)v * B;
      const float* c = vc + (long long)v * B;
      const float xo = vxo[(long long)v * K1 + i];
      const float xi = vxi[(long long)v * K2 + j];
      const int kind = (vkinds >> (2 * v)) & 3;
      if (kind == kNetCapacity) {
        const float net = xo - xi;
        ok = ((a[bo] - net) <= c[bo]) && ((a[bi] + net) <= c[bi]);
      } else if (kind == kNetBand) {
        const float* lo = vl + (long long)v * B;
        float g;
        ok = band_gain(a[bo], a[bi], xo - xi, lo[bo], c[bo], lo[bi], c[bi], &g);
      } else if (kind == kDirected || kind == kDirectedExempt) {
        bool leg_out = (a[bi] + xo) <= c[bi];
        bool leg_in = (a[bo] + xi) <= c[bo];
        if (kind == kDirectedExempt) {
          leg_out = leg_out || xo == 0.0f;
          leg_in = leg_in || xi == 0.0f;
        }
        ok = leg_out && leg_in;
      }
    }
    if (ok && lim_out != nullptr) {
      const long long r_o = broker_rack[bo];
      const long long r_i = broker_rack[bi];
      const long long same = r_o == r_i ? 1 : 0;
      ok = (prow_out[(long long)i * Kr + r_i] - same + 1 <= (long long)lim_out[i]) &&
           (prow_in[(long long)j * Kr + r_o] - same + 1 <= (long long)lim_in[j]);
    }
    if (ok && topic_veto) {
      const long long to = t_out[i];
      const long long ti = t_in[j];
      ok = ((float)tab[to * B + bi] + 1.0f <= topic_up[to]) &&
           ((float)tab[ti * B + bo] + 1.0f <= topic_up[ti]);
    }
    if (ok && family == kResourceDist) {
      float gain;
      const bool feasible = band_gain(fb[bo], fb[bi], fo[i] - fi[j], fb[B + bo],
                                      fb[2 * B + bo], fb[B + bi], fb[2 * B + bi], &gain);
      s = (feasible && gain > 0.0f) ? gain * 0.95f : -INFINITY;
    } else if (ok && family == kTopicReplica) {
      const long long to = t_out[i];
      const long long ti = t_in[j];
      const float lo_o = tl[to], up_o = tl[T + to];
      const float lo_i = tl[ti], up_i = tl[T + ti];
      const float c_oo = (float)tab[to * B + bo];
      const float c_oi = (float)tab[to * B + bi];
      const float c_ii = (float)tab[ti * B + bi];
      const float c_io = (float)tab[ti * B + bo];
      const float v_oo = violation(c_oo, lo_o, up_o);
      const float v_oo1 = violation(c_oo - 1.0f, lo_o, up_o);
      const float v_oi = violation(c_oi, lo_o, up_o);
      const float v_oi1 = violation(c_oi + 1.0f, lo_o, up_o);
      const float v_ii = violation(c_ii, lo_i, up_i);
      const float v_ii1 = violation(c_ii - 1.0f, lo_i, up_i);
      const float v_io = violation(c_io, lo_i, up_i);
      const float v_io1 = violation(c_io + 1.0f, lo_i, up_i);
      const float g_out = ((v_oo - v_oo1) + v_oi) - v_oi1;
      const float g_in = ((v_ii - v_ii1) + v_io) - v_io1;
      const bool nv_out = (v_oo1 > v_oo) || (v_oi1 > v_oi);
      const bool nv_in = (v_ii1 > v_ii) || (v_io1 > v_io);
      const float gain = g_out + g_in;
      const bool feasible = !nv_out && !nv_in && to != ti;
      s = (feasible && gain > 0.0f) ? gain * 0.95f : -INFINITY;
    }
    sc[j] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = sc[0];
    int bj = 0;
    int n = 0;
    for (int q = 0; q < K2; ++q) {
      const float v = sc[q];
      if (v > bv) {
        bv = v;
        bj = q;
      }
      if (v > min_gain) ++n;
    }
    best[i] = bv;
    best_j[i] = bj;
    positives[i] = n;
  }
}

__global__ void swap_admission_kernel(int K1, float min_gain,
                                      const float* __restrict__ val,
                                      const long long* __restrict__ b_out,
                                      const long long* __restrict__ b_in,
                                      const long long* __restrict__ jj,
                                      const long long* __restrict__ p_out,
                                      const long long* __restrict__ p_in,
                                      unsigned char* __restrict__ win) {
  const int p = threadIdx.x;
  if (p >= K1) return;
  const long long lane = blockIdx.y;
  val += lane * K1;
  b_out += lane * K1;
  b_in += lane * K1;
  jj += lane * K1;
  p_out += lane * K1;
  p_in += lane * K1;
  win += lane * K1;
  const long long bo = b_out[p], bi = b_in[p], j = jj[p];
  const long long po = p_out[p], pi = p_in[p];
  bool ok = val[p] > min_gain;
  for (int q = 0; q < p && ok; ++q) {
    if (!(val[q] > min_gain)) continue;
    const long long qbo = b_out[q], qbi = b_in[q];
    const long long qpo = p_out[q], qpi = p_in[q];
    const bool share = qbo == bo || qbo == bi || qbi == bo || qbi == bi || jj[q] == j ||
                       qpo == po || qpo == pi || qpi == po || qpi == pi;
    if (share) ok = false;
  }
  win[p] = ok ? 1 : 0;
}

}  // namespace

extern "C" int cc_swap_rows_lanes(
    int L, int K1, int K2, int F, int B, int T, int Kr, int family, int V,
    int topic_veto, int vkinds, float min_gain, const long long* lanes,
    const long long* b_out,
    const long long* b_in, const long long* sib_out, const long long* sib_in,
    const long long* orig_out, const long long* orig_in,
    const unsigned char* row_ok_out, const unsigned char* row_ok_in,
    const unsigned char* new_ok, const long long* broker_rack,
    const long long* prow_out, const long long* prow_in, const int* lim_out,
    const int* lim_in, const long long* t_out, const long long* t_in, const int* tab,
    const float* va,
    const float* vc, const float* vl, const float* vxo, const float* vxi,
    const float* fb, const float* fo, const float* fi, const float* tl,
    const float* topic_up, float* best, long long* best_j, int* positives,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (L <= 0 || L > 65535 || K1 <= 0 || K2 <= 0 || K2 > kMaxK2 || F > kMaxF || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (V > 16 || (V > 0 && (va == nullptr || vc == nullptr || vl == nullptr ||
                            vxo == nullptr || vxi == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((lim_out == nullptr) != (lim_in == nullptr)) return (int)cudaErrorInvalidValue;
  if (lim_out != nullptr && (prow_out == nullptr || prow_in == nullptr || Kr <= 0))
    return (int)cudaErrorInvalidValue;
  if (topic_veto && topic_up == nullptr) return (int)cudaErrorInvalidValue;
  if (family == kResourceDist && (fb == nullptr || fo == nullptr || fi == nullptr))
    return (int)cudaErrorInvalidValue;
  if (family == kTopicReplica && tl == nullptr) return (int)cudaErrorInvalidValue;
  if (family != kResourceDist && family != kTopicReplica) return (int)cudaErrorInvalidValue;
  const dim3 grid(K1, L);
  swap_rows_kernel<<<grid, kMaxK2, 0, stream>>>(
      K1, K2, F, B, T, Kr, family, V, topic_veto, vkinds, min_gain, lanes, b_out,
      b_in, sib_out, sib_in, orig_out, orig_in, row_ok_out, row_ok_in, new_ok,
      broker_rack, prow_out, prow_in, lim_out, lim_in, t_out, t_in, tab, va, vc, vl,
      vxo, vxi, fb, fo, fi, tl, topic_up, best, best_j, positives);
  return (int)cudaGetLastError();
}

extern "C" int cc_swap_admission_lanes(int L, int K1, float min_gain, const float* val,
                                       const long long* b_out, const long long* b_in,
                                       const long long* jj, const long long* p_out,
                                       const long long* p_in, unsigned char* win,
                                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (L <= 0 || L > 65535 || K1 <= 0 || K1 > 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(1, L);
  swap_admission_kernel<<<grid, ((K1 + 31) / 32) * 32, 0, stream>>>(
      K1, min_gain, val, b_out, b_in, jj, p_out, p_in, win);
  return (int)cudaGetLastError();
}
