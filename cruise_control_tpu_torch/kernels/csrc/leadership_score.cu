// K6 leadership_rows: [K, F] leadership-transfer legitimacy + folded chain
// vetoes + active-goal score, reduced to the best (value, first f) per row
// and, given a broker coloring, per color.
//
// Replaces cruise_control_tpu/analyzer/engine.py _lead_rows (:1003-1013),
// the rows of _exhaustive_lead_scan (:1354-1365) and _seg_lead_rows
// (:1597-1613), with goals/base.py legit_leadership_mask (:471), the
// accept_leadership of CapacityGoal, MinTopicLeadersPerBrokerGoal,
// LeaderReplicaDistributionGoal and LeaderBytesInDistributionGoal, and the
// leadership_score of the same four families. The goal's [B]-level columns
// (fb), member-replica column (fr) and per-row values (fk) arrive
// precomputed with the reference's arithmetic; every float operation here
// is one IEEE add/sub/min/max/compare (built with --fmad=false).
//
// Design: one thread per candidate row, F (<= 32, in practice 3-4) member
// scores in registers; a strict '>' scan keeps the first maximum. Bound:
// bytes (a handful of gathers per (k, f)).
//
// Lane form (K14, the fleet's tenant axis of engine.py _compiled_fleet_chunk
// :2324 over _lead_rows): cc_leadership_rows_lanes takes La lanes' operands
// stacked [La, ...] and runs grid dimension y = lane; each lane reads its
// own slice of every operand (its tables, vetoes and assignment; with a lane
// index list, the assignment is row lanes[y] of a lane stack's [L, R]
// tensors), so each lane's rows are its solo launch's bit for bit. The solo
// launch is the L = 1 case.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCapacity = 0;
constexpr int kMinTopic = 1;
constexpr int kBytesIn = 2;
constexpr int kLeaderDist = 3;
constexpr int kMaxF = 32;
constexpr int kMaxS = 64;

__device__ __forceinline__ float violation(float u, float lo, float up) {
  return fmaxf(u - up, 0.0f) + fmaxf(lo - u, 0.0f);
}

__global__ void leadership_rows_kernel(
    int K, int F, int B, int R, int family, int V, int S, int active, int vrow_mask,
    int nfb, long long tab_n, const long long* __restrict__ lanes,
    const long long* __restrict__ cand, const long long* __restrict__ members,
    const unsigned char* __restrict__ row_ok, const long long* __restrict__ rb,
    const unsigned char* __restrict__ roff,
    const unsigned char* __restrict__ broker_ok, const float* __restrict__ fb,
    const float* __restrict__ fr, const float* __restrict__ fk,
    const long long* __restrict__ row_t, const int* __restrict__ tab,
    const float* __restrict__ va,
    const float* __restrict__ vc, const float* __restrict__ vxr,
    const float* __restrict__ vxk, const long long* __restrict__ color,
    float* __restrict__ best, long long* __restrict__ fbest,
    float* __restrict__ seg_val, long long* __restrict__ seg_f) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  // the lane's slice of every operand (lane 0: the solo launch)
  const long long lane = blockIdx.y;
  cand += lane * K;
  members += lane * K * F;
  row_ok += lane * K;
  const long long row = lanes != nullptr ? lanes[lane] : lane;
  rb += row * R;
  roff += row * R;
  broker_ok += lane * B;
  fb += lane * nfb * B;
  if (fr != nullptr) fr += lane * R;
  fk += lane * 2 * K;
  if (row_t != nullptr) row_t += lane * K;
  if (tab != nullptr) tab += lane * tab_n;
  if (V > 0) {
    va += lane * V * B;
    vc += lane * V * B;
    vxr += lane * V * R;
    vxk += lane * V * K;
  }
  if (color != nullptr) color += lane * B;
  best += lane * K;
  fbest += lane * K;
  if (S > 0) {
    seg_val += lane * K * S;
    seg_f += lane * K * S;
  }
  const long long c_k = cand[k];
  const bool rok = row_ok[k] != 0;
  const float k0 = fk[k];
  const float k1 = fk[K + k];
  float sc[kMaxF];
  long long dbs[kMaxF];
  for (int f = 0; f < F; ++f) {
    const long long mem = members[(long long)k * F + f];
    const long long m = mem < 0 ? 0 : mem;
    const long long db = rb[m];
    dbs[f] = db;
    bool ok = rok && mem >= 0 && mem != c_k && broker_ok[db] && !roff[m];
    for (int v = 0; v < V && ok; ++v) {
      const float x = ((vrow_mask >> v) & 1) == 0 ? vxr[(long long)v * R + m]
                                                  : vxk[(long long)v * K + k];
      ok = (va[(long long)v * B + db] + x) <= vc[(long long)v * B + db];
    }
    float s = -INFINITY;
    if (ok) {
      const float b0 = fb[db];
      if (family == kCapacity) {
        s = (b0 + fr[m]) <= fb[B + db] ? k0 : -INFINITY;
      } else if (family == kMinTopic) {
        const float c = (float)tab[row_t[k] * B + db];
        const float need = k0 != 0.0f ? b0 : 0.0f;
        const float gain = fminf(fmaxf(need - c, 0.0f), 1.0f);
        s = gain > 0.0f ? gain : -INFINITY;
      } else if (family == kBytesIn) {
        const float nex = fmaxf((b0 + k0) - fb[B + db], 0.0f);
        s = (nex <= 0.0f && k1 > 0.0f) ? k1 : -INFINITY;
      } else if (family == kLeaderDist) {
        const float lo = fb[B + db], up = fb[2 * B + db];
        const float vdo = violation(b0, lo, up);
        const float vdn = violation(b0 + 1.0f, lo, up);
        const float gain = (k0 - k1) + (vdo - vdn);
        s = (k1 <= k0 && vdn <= vdo && gain > 0.0f) ? gain : -INFINITY;
      }
    }
    sc[f] = s;
  }
  float bv = sc[0];
  int bf = 0;
  for (int f = 1; f < F; ++f) {
    if (sc[f] > bv) {
      bv = sc[f];
      bf = f;
    }
  }
  best[k] = bv;
  fbest[k] = bf;
  for (int s = 0; s < S; ++s) {
    float v = -INFINITY;
    int fs = 0;
    bool any = false;
    for (int f = 0; f < F; ++f) {
      const float x = color[dbs[f]] == s ? sc[f] : -INFINITY;
      if (!any || x > v) {
        v = x;
        fs = f;
        any = true;
      }
    }
    seg_val[(long long)k * S + s] = s < active ? v : -INFINITY;
    seg_f[(long long)k * S + s] = fs;
  }
}

}  // namespace

extern "C" int cc_leadership_rows_lanes(
    int L, int K, int F, int B, int R, int family, int V, int S, int active, int nfb,
    int vrow_mask, long long tab_n, const long long* lanes,
    const long long* cand, const long long* members, const unsigned char* row_ok,
    const long long* rb, const unsigned char* roff,
    const unsigned char* broker_ok, const float* fb, const float* fr,
    const float* fk, const long long* row_t, const int* tab,
    const float* va, const float* vc, const float* vxr, const float* vxk,
    const long long* color, float* best, long long* fbest, float* seg_val,
    long long* seg_f, int* launches, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  *launches = 0;
  if (L <= 0 || L > 65535 || K <= 0 || F <= 0 || F > kMaxF || S < 0 || S > kMaxS ||
      nfb < 1 || V > 31)
    return (int)cudaErrorInvalidValue;
  if (family == kCapacity && (fr == nullptr || nfb < 2)) return (int)cudaErrorInvalidValue;
  if (family == kMinTopic && (tab == nullptr || row_t == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((family == kBytesIn && nfb < 2) || (family == kLeaderDist && nfb < 3))
    return (int)cudaErrorInvalidValue;
  if (S > 0 && (color == nullptr || seg_val == nullptr || seg_f == nullptr))
    return (int)cudaErrorInvalidValue;
  if (V > 0 && (va == nullptr || vc == nullptr || vxr == nullptr || vxk == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((K + threads - 1) / threads, L);
  leadership_rows_kernel<<<grid, threads, 0, stream>>>(
      K, F, B, R, family, V, S, active, vrow_mask, nfb, tab_n, lanes, cand, members, row_ok,
      rb, roff, broker_ok, fb, fr, fk, row_t, tab, va, vc, vxr, vxk, color, best,
      fbest, seg_val, seg_f);
  *launches = 1;
  return (int)cudaGetLastError();
}
