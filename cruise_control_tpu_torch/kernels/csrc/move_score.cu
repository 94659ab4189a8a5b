// K2 move_score_classes: [K, B] move legitimacy + chain rooms + rack-limit
// veto + active-goal score, reduced to the best (value, lowest q) per
// destination class b % T.
//
// Replaces cruise_control_tpu/analyzer/engine.py _score_class_rows
// (:767-792) with _rooms_move_mask (:693), goals/base.py legit_move_mask
// (:369), RackAwareGoal.accept_move (goals/rack.py:72) and
// RackAwareDistributionGoal.accept_move (:144) as previous goals (one
// per-row rack limit lim[k], the chain's minimum: others + 1 <= lim[k]), and
// the move_score of RackAwareGoal, RackAwareDistributionGoal (:129, its
// limit ceil(RF / racks) per row), CapacityGoal (and PotentialNwOutGoal, the
// same family on potential NW_OUT), ReplicaCapacityGoal, ReplicaDistributionGoal,
// MinTopicLeadersPerBrokerGoal, LeaderReplicaDistributionGoal,
// ResourceDistributionGoal (distribution.py:117-133) and
// TopicReplicaDistributionGoal (topic.py:97-118), and the destination leg
// of TopicReplicaDistributionGoal.accept_move (topic.py:120-130) as a
// previous goal (vtab[t, b] + 1 <= vup[k]; its source leg is row-only). With a
// column order (order_b, the finisher's broker coloring of
// _segment_move_wave :1504-1522) ordered column j holds broker order_b[j];
// T = 1 is the exhaustive move scan's row argmax (:1302-1317). The goal's [B]-level columns (col_f) and per-row
// values (row_f) arrive precomputed with the reference's arithmetic; every
// float operation here is one IEEE add/sub/compare (built with --fmad=false).
//
// Per-goal veto form (chain_cache=False, engine.py _score_class_rows
// :767-792 with the prev goals' own accept_move masks): with dst_lhs given,
// dst_room holds each dim's BOUND and the column test is the goals' own
// expression lhs[b] + d[k][c] <= bound[b] (add, then compare) instead of
// the folded room d[k][c] <= bound[b] - lhs[b], which can differ by one ulp
// at a band edge. Terms of one dim read the same lhs column, so the host
// folds their bounds by min, which is exact.
//
// Lanes (K14, the fleet's tenant axis): grid dimension y = lane. Every
// input and output is the [L, ...] stack of L solo launches' arguments
// (row tables [L, K, ...], broker tables [L, ..., B], topic tables
// [L, T, B]); lane y reads and writes only its own slices, so each lane is
// its solo launch bit for bit. The solo entry point is L = 1.
//
// Design: one CTA per candidate row; threads stride over the Bp columns; the row's
// sibling brokers sit in shared memory; scores are staged in shared memory
// (Bp = ceil(B/T)*T floats, -inf padded) and one thread per class walks its
// B/T strided values with a strict '>' so the lowest q wins ties. Bound:
// bytes — the [B]-level tables stream from L2 for every row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGoalRack = 0;
constexpr int kGoalCapacity = 1;
constexpr int kGoalReplicaCapacity = 2;
constexpr int kGoalReplicaDist = 3;
constexpr int kGoalMinTopic = 4;
constexpr int kGoalLeaderDist = 5;
constexpr int kGoalResourceDist = 6;
constexpr int kGoalTopicReplica = 7;
constexpr int kGoalRackDist = 8;
constexpr int kMaxF = 64;
constexpr int kDims = 8;

__device__ __forceinline__ float violation(float u, float lo, float up) {
  return fmaxf(u - up, 0.0f) + fmaxf(lo - u, 0.0f);
}

__global__ void move_score_kernel(
    int B, int T, int F, int Kr, int goal_kind, int room_mask, int exempt_mask,
    int Bp, const long long* __restrict__ cur_b,
    const long long* __restrict__ orig_b, const long long* __restrict__ sib_b,
    const unsigned char* __restrict__ row_ok, const float* __restrict__ d_rows,
    const float* __restrict__ dst_room, const float* __restrict__ dst_lhs,
    const long long* __restrict__ prow,
    const int* __restrict__ rack_lim, const float* __restrict__ row_f,
    const float* __restrict__ col_f,
    const unsigned char* __restrict__ dst_ok,
    const unsigned char* __restrict__ new_ok,
    const long long* __restrict__ broker_rack,
    const long long* __restrict__ order_b, const long long* __restrict__ row_t,
    const int* __restrict__ tab, const int* __restrict__ vtab,
    const float* __restrict__ vup, float* __restrict__ cls_val,
    long long* __restrict__ cls_q, int K, long long tab_n, long long vtab_n) {
  extern __shared__ float sc[];
  __shared__ long long sib[kMaxF];
  const int k = blockIdx.x;
  {
    const long long y = blockIdx.y;
    const long long yK = y * K, yB = y * B;
    cur_b += yK;
    orig_b += yK;
    sib_b += yK * F;
    row_ok += yK;
    d_rows += yK * kDims;
    dst_room += yB * kDims;
    if (dst_lhs != nullptr) dst_lhs += yB * kDims;
    if (prow != nullptr) prow += yK * Kr;
    if (rack_lim != nullptr) rack_lim += yK;
    row_f += yK * 4;
    col_f += yB * 4;
    dst_ok += yB;
    new_ok += yB;
    broker_rack += yB;
    if (order_b != nullptr) order_b += y * Bp;
    if (row_t != nullptr) row_t += yK;
    if (tab != nullptr) tab += y * tab_n;
    if (vtab != nullptr) vtab += y * vtab_n;
    if (vup != nullptr) vup += yK;
    cls_val += yK * T;
    cls_q += yK * T;
  }
  const int Bq = Bp / T;
  for (int f = threadIdx.x; f < F; f += blockDim.x) sib[f] = sib_b[(long long)k * F + f];
  __syncthreads();

  const bool rok = row_ok[k] != 0;
  const long long cb = cur_b[k];
  const long long ob = orig_b[k];
  const bool need_rack =
      goal_kind == kGoalRack || goal_kind == kGoalRackDist || rack_lim != nullptr;
  const long long crack = need_rack ? broker_rack[cb] : 0;
  const long long lim_k = rack_lim != nullptr ? (long long)rack_lim[k] : 0;
  float d[kDims];
#pragma unroll
  for (int c = 0; c < kDims; ++c) d[c] = d_rows[(long long)k * kDims + c];
  const float r0 = row_f[k * 4 + 0];
  const float r1 = row_f[k * 4 + 1];
  const float r2 = row_f[k * 4 + 2];
  const float r3 = row_f[k * 4 + 3];
  // per-row halves of the count goals' _gain (src side)
  const float vso = violation(r0, r1, r2);
  const float vsn = violation(r0 - 1.0f, r1, r2);
  const long long trow = row_t != nullptr ? row_t[k] * B : 0;
  const float vup_k = vtab != nullptr ? vup[k] : 0.0f;

  for (int j = threadIdx.x; j < Bp; j += blockDim.x) {
    const long long b = order_b != nullptr ? order_b[j] : (long long)j;
    float s = -INFINITY;
    if (rok && b < B) {
      bool ok = dst_ok[b] && (new_ok[b] || b == ob) && (b != cb);
      for (int f = 0; f < F && ok; ++f) ok = sib[f] != b;
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        if ((room_mask >> c) & 1) {
          const long long cb_ = (long long)c * B + b;
          bool okc = dst_lhs != nullptr ? __fadd_rn(dst_lhs[cb_], d[c]) <= dst_room[cb_]
                                        : d[c] <= dst_room[cb_];
          if ((exempt_mask >> c) & 1) okc = okc || (d[c] == 0.0f);
          ok = ok && okc;
        }
      }
      if (ok && vtab != nullptr) ok = (float)vtab[trow + b] + 1.0f <= vup_k;
      long long others = 1;
      if (ok && need_rack) {
        const long long rb = broker_rack[b];
        others = prow[(long long)k * Kr + rb] - (rb == crack ? 1 : 0);
        if (rack_lim != nullptr) ok = others + 1 <= lim_k;
      }
      if (ok) {
        const float c0 = col_f[b];
        const float c1 = col_f[B + b];
        const float c2 = col_f[2 * B + b];
        const float c3 = col_f[3 * B + b];
        if (goal_kind == kGoalRack) {
          s = (others == 0 && r0 != 0.0f) ? c0 : -INFINITY;
        } else if (goal_kind == kGoalRackDist) {
          // r0 = was violating or offline, r1 = the row's rack limit
          s = ((float)(others + 1) <= r1 && r0 != 0.0f) ? c0 : -INFINITY;
        } else if (goal_kind == kGoalCapacity) {
          const bool feasible = (c0 + r0) <= c1;
          const float v = (r1 != 0.0f) ? c3 : (r0 + c2);
          s = feasible ? v : -INFINITY;
        } else if (goal_kind == kGoalReplicaCapacity) {
          s = (c0 != 0.0f) ? c1 : -INFINITY;
        } else if (goal_kind == kGoalReplicaDist) {
          const float vdo = violation(c0, c1, c2);
          const float vdn = violation(c0 + 1.0f, c1, c2);
          const float gain = (vso - vsn) + (vdo - vdn);
          const bool feasible = (vsn <= vso) && (vdn <= vdo);
          s = (r3 != 0.0f) ? c3 : ((feasible && gain > 0.0f) ? gain : -INFINITY);
        } else if (goal_kind == kGoalMinTopic) {
          const float c = (float)tab[trow + b];
          const float need = (r1 != 0.0f) ? c0 : 0.0f;
          const float gain = fminf(fmaxf(need - c, 0.0f), 1.0f);
          s = (r0 != 0.0f) ? 1.0f : (gain > 0.0f ? gain : -INFINITY);
        } else if (goal_kind == kGoalLeaderDist) {
          const float vdo = violation(c0, c1, c2);
          const float vdn = violation(c0 + 1.0f, c1, c2);
          const float gain = (vso - vsn) + (vdo - vdn);
          const bool feasible = (vsn <= vso) && (vdn <= vdo);
          s = (feasible && gain > 0.0f) ? gain * 0.9f : -INFINITY;
        } else if (goal_kind == kGoalResourceDist) {
          // r0, r1 = the source's violation before / after, r2 = the
          // load, r3 = offline; c0..c3 = util, lower, upper, capacity
          const float vdo = violation(c0, c1, c2);
          const float vdn = violation(c0 + r2, c1, c2);
          const float gain = (r0 - r1) + (vdo - vdn);
          const bool feasible = (r1 <= r0) && (vdn <= vdo);
          const float heal = 1.0f + fmaxf((c2 - c0) - r2, 0.0f) / c3;
          s = (r3 != 0.0f) ? heal : ((feasible && gain > 0.0f) ? gain : -INFINITY);
        } else if (goal_kind == kGoalTopicReplica) {
          // r0, r1 = the row topic's lower / upper, r2 = the source's
          // excess reduction (-inf when the source leg is infeasible),
          // r3 = offline
          const float c = (float)tab[trow + b];
          const float deficit = fminf(fmaxf(r0 - c, 0.0f), 1.0f);
          const float new_excess = fmaxf((c + 1.0f) - r1, 0.0f);
          const float gain = r2 + deficit;
          const float heal = 1.0f + fmaxf((r1 - c) - 1.0f, 0.0f) / (r1 + 1.0f);
          s = (r3 != 0.0f) ? heal
                           : ((new_excess <= 0.0f && gain > 0.0f) ? gain : -INFINITY);
        }
      }
    }
    sc[j] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < T; c += blockDim.x) {
    float best = sc[c];
    int bq = 0;
    for (int q = 1; q < Bq; ++q) {
      const float v = sc[q * T + c];
      if (v > best) {
        best = v;
        bq = q;
      }
    }
    cls_val[(long long)k * T + c] = best;
    cls_q[(long long)k * T + c] = bq;
  }
}

}  // namespace

extern "C" int cc_move_score_classes_lanes(
    int L, int K, int B, int T, int F, int Kr, int goal_kind, int room_mask,
    int exempt_mask, int Bp, long long tab_n, long long vtab_n,
    const long long* cur_b, const long long* orig_b, const long long* sib_b,
    const unsigned char* row_ok, const float* d_rows, const float* dst_room,
    const float* dst_lhs, const long long* prow, const int* rack_lim, const float* row_f,
    const float* col_f, const unsigned char* dst_ok, const unsigned char* new_ok,
    const long long* broker_rack, const long long* order_b, const long long* row_t,
    const int* tab, const int* vtab, const float* vup, float* cls_val,
    long long* cls_q, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (L <= 0 || L > 65535 || K <= 0 || B <= 0 || T <= 0 || F > kMaxF || Bp < B ||
      Bp % T != 0)
    return (int)cudaErrorInvalidValue;
  if (order_b == nullptr && Bp != ((B + T - 1) / T) * T) return (int)cudaErrorInvalidValue;
  if ((goal_kind == kGoalMinTopic || goal_kind == kGoalTopicReplica) &&
      (row_t == nullptr || tab == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vtab != nullptr && (row_t == nullptr || vup == nullptr)) return (int)cudaErrorInvalidValue;
  if ((goal_kind == kGoalRack || goal_kind == kGoalRackDist || rack_lim != nullptr) &&
      (prow == nullptr || Kr <= 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Bp * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  move_score_kernel<<<dim3(K, L), 256, smem, stream>>>(
      B, T, F, Kr, goal_kind, room_mask, exempt_mask, Bp, cur_b,
      orig_b, sib_b, row_ok, d_rows, dst_room, dst_lhs, prow, rack_lim, row_f, col_f,
      dst_ok, new_ok, broker_rack, order_b, row_t, tab, vtab, vup, cls_val, cls_q, K,
      tab_n, vtab_n);
  return (int)cudaGetLastError();
}

extern "C" int cc_move_score_classes(
    int K, int B, int T, int F, int Kr, int goal_kind, int room_mask,
    int exempt_mask, int Bp, const long long* cur_b,
    const long long* orig_b, const long long* sib_b, const unsigned char* row_ok,
    const float* d_rows, const float* dst_room, const float* dst_lhs,
    const long long* prow, const int* rack_lim, const float* row_f, const float* col_f,
    const unsigned char* dst_ok,
    const unsigned char* new_ok, const long long* broker_rack,
    const long long* order_b, const long long* row_t, const int* tab,
    const int* vtab, const float* vup, float* cls_val, long long* cls_q,
    void* stream_ptr) {
  return cc_move_score_classes_lanes(
      1, K, B, T, F, Kr, goal_kind, room_mask, exempt_mask, Bp, 0, 0, cur_b, orig_b,
      sib_b, row_ok, d_rows, dst_room, dst_lhs, prow, rack_lim, row_f, col_f, dst_ok,
      new_ok,
      broker_rack, order_b, row_t, tab, vtab, vup, cls_val, cls_q, stream_ptr);
}
