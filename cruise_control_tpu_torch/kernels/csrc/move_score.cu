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
// Design (tiles of rows; one instantiation per goal family and per-goal
// form, so the family's branch is resolved at compile time): one CTA takes
// a tile of TR candidate rows of one lane (1 to 16, kernels/move_score.py
// launch_plan: 4 at the slice's K 1,760 x B 1,024, 8 at rung 4's K 1,760 x
// B 7,168). The tile's per-row constants (the deltas of the room dims,
// compacted to the dims in room_mask; row_f and the source halves; current
// / original broker and rack; the rack limit; the topic row; the siblings)
// sit in shared memory, read as 16-byte vectors. The tile's work is T * S
// units on up to 512 threads: unit (c, s) walks the columns q * T + c of
// class c for q = s, s + S, ... in ascending q; each column's tables
// (dst_ok, new_ok, the room dims, dst_lhs in the per-goal form,
// broker_rack, col_f) are read once into registers and scored against
// every row of the tile, so a CTA reads each [B]-level table once per tile
// of rows, not once per row as the earlier design did (one CTA per row:
// 40-70 bytes x B x K from L2 a call). Each unit keeps its rows' running
// bests (value, q) in shared memory, a slot per (row, thread). With S > 1
// the S units of one class meet there: G lanes per (row, class) combine
// the S partials and a shuffle tree of width G finishes, so T = 1 (the
// exhaustive scan) spreads over every thread. No score is staged, so B has
// no cap beyond the index range. Bound: operations, a few dozen a (row,
// column) pair, at the latency of each pair's chain of shared-memory reads
// and compares; the walk itself (the column reads, every column vetoed)
// takes about a quarter of rung 4's time (PERF.md section 6).
// Staging the column tables in shared memory a chunk at a time, two or four
// columns a thread at once, the next column's loads issued ahead, 1,024
// threads a CTA, and the rows unrolled with their bests in registers each
// measured no faster there (PERF.md section 6).
//
// The tie rule is a total order, so any reduction order gives the same
// bits: a NaN beats every number, else the larger value wins, else the
// lower q (-0.0 == +0.0, so the first of equal zeros wins). That is the
// plain twin's rule: max over q (NaN if any is NaN) and the lowest q
// holding it, with q = Bq when the best is NaN (no q compares equal to it).
// A class of -inf scores gives q 0.
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

// the kernel's operands (one lane's, or the [L, ...] stacks of L lanes)
struct Args {
  int B, T, F, Kr, goal_kind, Bp, K, S, G, tile;
  int nd, dims, exempt;   // the room dims in room_mask, compacted (4 bits each)
  long long tab_n, vtab_n;
  const long long* cur_b;
  const long long* orig_b;
  const long long* sib_b;
  const unsigned char* row_ok;
  const float* d_rows;
  const float* dst_room;
  const float* dst_lhs;
  const long long* prow;
  const int* rack_lim;
  const float* row_f;
  const float* col_f;
  const unsigned char* dst_ok;
  const unsigned char* new_ok;
  const long long* broker_rack;
  const long long* order_b;
  const long long* row_t;
  const int* tab;
  const int* vtab;
  const float* vup;
  float* cls_val;
  long long* cls_q;
};

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoQ = 0x7FFFFFFF;   // the empty running best's q

// (v, q) beats (bv, bq): a NaN beats any number; else the larger value;
// else the lower q. A total order (q is unique within a class).
__device__ __forceinline__ bool better(float v, int q, float bv, int bq) {
  const bool nv = isnan(v), nb = isnan(bv);
  if (nv || nb) return nv && (!nb || q < bq);
  return v > bv || (v == bv && q < bq);
}

// one candidate row's constants in shared memory, read as 16-byte vectors
// (only the ones the family and the launch's options use)
struct RowC {
  float4 d03, d47;   // the wave deltas
  float4 rf;         // row_f
  float4 aux;        // the source halves vso, vsn of the count goals; vup
  int4 ids;          // ok, current broker, original broker, topic row * B
  int4 rack;         // current rack, rack limit, the room dims that pass
};

// one column's tables in registers, read once for every row of the tile
template <bool LHS>
struct Col {
  int b;               // the broker; >= B: a pad column
  bool ok, nok;        // dst_ok, new_ok
  int rb;              // its rack (the rack families and the rack-limit veto)
  float room[kDims];   // the rooms (bounds with LHS) of the dims in room_mask
  float lhs[LHS ? kDims : 1];
  float c0, c1, c2, c3;
};

// The score of row rc against column col: legitimacy, the rooms, the topic
// veto, the rack-limit veto, then the family's score; the previous design's
// IEEE operations in its order.
template <int KIND, bool LHS>
__device__ __forceinline__ float score(const Args& a, const RowC& rc, const int* sib,
                                       long long prow_row, const Col<LHS>& col,
                                       const long long* prow, const int* tab,
                                       const int* vtab) {
  const int b = col.b;
  const int4 ids = rc.ids;
  bool ok = ids.x && (col.nok || b == ids.z) && (b != ids.y);   // col.ok: the caller's
  // the first four siblings as one vector (slots past F hold -1), the
  // rest, where a partition has more replicas, one by one
  const int4 s4 = *reinterpret_cast<const int4*>(sib);
  ok = ok && s4.x != b && s4.y != b && s4.z != b && s4.w != b;
  for (int f = 4; f < a.F && ok; ++f) ok = sib[f] != b;
  if (!ok) return -INFINITY;
  const float dd[kDims] = {rc.d03.x, rc.d03.y, rc.d03.z, rc.d03.w,
                           rc.d47.x, rc.d47.y, rc.d47.z, rc.d47.w};
  // one bit a room dim that fails; a dim in the row's pass mask (exempt
  // with a zero delta) passes whatever its room
  unsigned fail = 0;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    if (i >= a.nd) break;   // warp-uniform: no issue slot for absent dims
    bool okc;
    if constexpr (LHS)
      okc = __fadd_rn(col.lhs[i], dd[i]) <= col.room[i];
    else
      okc = dd[i] <= col.room[i];
    fail |= (okc ? 0u : 1u) << i;
  }
  ok = (fail & ~(unsigned)rc.rack.z) == 0;
  if (!ok) return -INFINITY;
  if (vtab != nullptr && !((float)vtab[ids.w + b] + 1.0f <= rc.aux.z)) return -INFINITY;
  constexpr bool kRackFamily = KIND == kGoalRack || KIND == kGoalRackDist;
  long long others = 1;
  if (kRackFamily || a.rack_lim != nullptr) {
    const int4 rk = rc.rack;
    others = prow[prow_row + col.rb] - (col.rb == rk.x ? 1 : 0);
    if (a.rack_lim != nullptr && !(others + 1 <= (long long)rk.y)) return -INFINITY;
  }
  const float r0 = rc.rf.x, r1 = rc.rf.y, r2 = rc.rf.z, r3 = rc.rf.w;
  const float c0 = col.c0, c1 = col.c1, c2 = col.c2, c3 = col.c3;
  if constexpr (KIND == kGoalRack) {
    return (others == 0 && r0 != 0.0f) ? c0 : -INFINITY;
  } else if constexpr (KIND == kGoalRackDist) {
    // r0 = was violating or offline, r1 = the row's rack limit
    return ((float)(others + 1) <= r1 && r0 != 0.0f) ? c0 : -INFINITY;
  } else if constexpr (KIND == kGoalCapacity) {
    const bool feasible = (c0 + r0) <= c1;
    const float v = (r1 != 0.0f) ? c3 : (r0 + c2);
    return feasible ? v : -INFINITY;
  } else if constexpr (KIND == kGoalReplicaCapacity) {
    return (c0 != 0.0f) ? c1 : -INFINITY;
  } else if constexpr (KIND == kGoalReplicaDist || KIND == kGoalLeaderDist) {
    const float vso = rc.aux.x, vsn = rc.aux.y;
    const float vdo = violation(c0, c1, c2);
    const float vdn = violation(c0 + 1.0f, c1, c2);
    const float gain = (vso - vsn) + (vdo - vdn);
    const bool feasible = (vsn <= vso) && (vdn <= vdo);
    if constexpr (KIND == kGoalReplicaDist)
      return (r3 != 0.0f) ? c3 : ((feasible && gain > 0.0f) ? gain : -INFINITY);
    else
      return (feasible && gain > 0.0f) ? gain * 0.9f : -INFINITY;
  } else if constexpr (KIND == kGoalMinTopic) {
    const float cnt = (float)tab[ids.w + b];
    const float need = (r1 != 0.0f) ? c0 : 0.0f;
    const float gain = fminf(fmaxf(need - cnt, 0.0f), 1.0f);
    return (r0 != 0.0f) ? 1.0f : (gain > 0.0f ? gain : -INFINITY);
  } else if constexpr (KIND == kGoalResourceDist) {
    // r0, r1 = the source's violation before / after, r2 = the load, r3 =
    // offline; c0..c3 = util, lower, upper, capacity
    if (r3 != 0.0f) return 1.0f + fmaxf((c2 - c0) - r2, 0.0f) / c3;
    const float vdo = violation(c0, c1, c2);
    const float vdn = violation(c0 + r2, c1, c2);
    const float gain = (r0 - r1) + (vdo - vdn);
    const bool feasible = (r1 <= r0) && (vdn <= vdo);
    return (feasible && gain > 0.0f) ? gain : -INFINITY;
  } else {   // kGoalTopicReplica
    // r0, r1 = the row topic's lower / upper, r2 = the source's excess
    // reduction (-inf when the source leg is infeasible), r3 = offline
    const float cnt = (float)tab[ids.w + b];
    if (r3 != 0.0f) return 1.0f + fmaxf((r1 - cnt) - 1.0f, 0.0f) / (r1 + 1.0f);
    const float deficit = fminf(fmaxf(r0 - cnt, 0.0f), 1.0f);
    const float new_excess = fmaxf((cnt + 1.0f) - r1, 0.0f);
    const float gain = r2 + deficit;
    return (new_excess <= 0.0f && gain > 0.0f) ? gain : -INFINITY;
  }
}

constexpr int kMaxTile = 16;
constexpr int kMaxThreads = 512;

// whether a later q's score replaces the running best bv in an ascending
// walk: the tie rule's order there (an equal value keeps the earlier q; a
// NaN replaces any number and is never replaced)
__device__ __forceinline__ bool take(float sc, float bv) {
  return !isnan(bv) && !(sc <= bv);
}

// column b's tables (b >= B: a pad column, -inf for every row)
template <bool LHS>
__device__ __forceinline__ Col<LHS> load_col(const Args& a, int b, const float* dst_room,
                                             const float* dst_lhs,
                                             const unsigned char* dst_ok,
                                             const unsigned char* new_ok,
                                             const long long* broker_rack, const float* col_f,
                                             bool need_rack) {
  Col<LHS> col;
  const int B = a.B;
  col.b = b;
  col.ok = false;
  col.nok = false;
  col.rb = 0;
  col.c0 = col.c1 = col.c2 = col.c3 = 0.0f;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    col.room[i] = 0.0f;
    if constexpr (LHS) col.lhs[i] = 0.0f;
  }
  if (b < B) {
    col.ok = dst_ok[b] != 0;
    col.nok = new_ok[b] != 0;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      if (i >= a.nd) break;
      const int d = (a.dims >> (4 * i)) & 15;
      col.room[i] = dst_room[d * B + b];
      if constexpr (LHS) col.lhs[i] = dst_lhs[d * B + b];
    }
    col.rb = need_rack ? (int)broker_rack[b] : 0;
    col.c0 = col_f[b];
    col.c1 = col_f[B + b];
    col.c2 = col_f[2 * B + b];
    col.c3 = col_f[3 * B + b];
  }
  return col;
}

template <int KIND, bool LHS>
__global__ void __launch_bounds__(kMaxThreads) move_score_tile(Args a) {
  // the running bests: [tile][blockDim] values, then as many qs
  extern __shared__ unsigned char best_raw[];
  __shared__ RowC s_row[kMaxTile];
  __shared__ __align__(16) int s_sib[kMaxTile][kMaxF];
  const int B = a.B, T = a.T, F = a.F, K = a.K, TR = a.tile;
  const long long y = blockIdx.y;
  const long long yK = y * K, yB = y * B;
  const float* dst_room = a.dst_room + yB * kDims;
  const float* dst_lhs = LHS ? a.dst_lhs + yB * kDims : nullptr;
  const long long* prow = a.prow != nullptr ? a.prow + yK * a.Kr : nullptr;
  const float* col_f = a.col_f + yB * 4;
  const unsigned char* dst_ok = a.dst_ok + yB;
  const unsigned char* new_ok = a.new_ok + yB;
  const long long* broker_rack = a.broker_rack + yB;
  const long long* order_b = a.order_b != nullptr ? a.order_b + y * a.Bp : nullptr;
  const int* tab = a.tab != nullptr ? a.tab + y * a.tab_n : nullptr;
  const int* vtab = a.vtab != nullptr ? a.vtab + y * a.vtab_n : nullptr;
  constexpr bool kRackFamily = KIND == kGoalRack || KIND == kGoalRackDist;
  const bool need_rack = kRackFamily || a.rack_lim != nullptr;

  // the tile's rows
  const int k0 = blockIdx.x * TR;
  const int nrows = K - k0 < TR ? K - k0 : TR;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const long long k = yK + k0 + r;
    const int cb = (int)a.cur_b[k];
    const float* rf = a.row_f + k * 4;
    const float* d = a.d_rows + k * kDims;
    RowC rc;
    float dc[kDims];   // the deltas of the room dims, compacted
#pragma unroll
    for (int i = 0; i < kDims; ++i) dc[i] = i < a.nd ? d[(a.dims >> (4 * i)) & 15] : 0.0f;
    rc.d03 = make_float4(dc[0], dc[1], dc[2], dc[3]);
    rc.d47 = make_float4(dc[4], dc[5], dc[6], dc[7]);
    rc.rf = make_float4(rf[0], rf[1], rf[2], rf[3]);
    // per-row halves of the count goals' _gain (src side)
    rc.aux = make_float4(violation(rf[0], rf[1], rf[2]), violation(rf[0] - 1.0f, rf[1], rf[2]),
                         vtab != nullptr ? a.vup[k] : 0.0f, 0.0f);
    rc.ids = make_int4(a.row_ok[k] != 0, cb, (int)a.orig_b[k],
                       a.row_t != nullptr ? (int)a.row_t[k] * B : 0);
    int pass = 0;   // the exempt dims whose delta is zero: they pass any room
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      if (i < a.nd && ((a.exempt >> i) & 1) && dc[i] == 0.0f) pass |= 1 << i;
    rc.rack = make_int4(need_rack ? (int)broker_rack[cb] : 0,
                        a.rack_lim != nullptr ? a.rack_lim[k] : 0, pass, 0);
    s_row[r] = rc;
  }
  for (int i = threadIdx.x; i < nrows * F; i += blockDim.x)
    s_sib[i / F][i % F] = (int)a.sib_b[(yK + k0) * F + i];
  for (int i = threadIdx.x; i < nrows * 4; i += blockDim.x)
    if (i % 4 >= F) s_sib[i / 4][i % 4] = -1;
  __syncthreads();

  const int S = a.S;
  const int Bq = a.Bp / T;
  const int units = T * S;
  const int nt = blockDim.x, me = threadIdx.x;
  // the running bests in shared memory ([r][thread]); with S > 1 unit u is
  // thread u and its bests are the partials the reduction reads
  float* pv = reinterpret_cast<float*>(best_raw);
  int* pq = reinterpret_cast<int*>(pv + TR * nt);
  float* my_pv = pv + me;
  int* my_pq = pq + me;
  for (int u = threadIdx.x; u < units; u += nt) {
    const int c = u % T, s0 = u / T;
    for (int r = 0; r < nrows; ++r) {
      pv[r * nt + me] = -INFINITY;
      pq[r * nt + me] = s0;   // the walk's first q: a class of -inf gives it
    }
    for (int q = s0; q < Bq; q += S) {
      const Col<LHS> col = load_col<LHS>(
          a, order_b != nullptr ? (int)order_b[q * T + c] : q * T + c, dst_room, dst_lhs,
          dst_ok, new_ok, broker_rack, col_f, need_rack);
#pragma unroll 1
      for (int r = 0; r < nrows; ++r) {
        if (!col.ok) break;   // -inf for every row: no best moves
        const float sc = score<KIND, LHS>(a, s_row[r], s_sib[r], (long long)(k0 + r) * a.Kr,
                                          col, prow, tab, vtab);
        if (take(sc, my_pv[r * nt])) {
          my_pv[r * nt] = sc;
          my_pq[r * nt] = q;
        }
      }
    }
    if (S == 1) {
      for (int r = 0; r < nrows; ++r) {
        const long long at = (yK + k0 + r) * T + c;
        const float v = pv[r * nt + me];
        a.cls_val[at] = v;
        a.cls_q[at] = isnan(v) ? Bq : pq[r * nt + me];
      }
    }
  }
  if (S == 1) return;
  __syncthreads();
  // G lanes per (row, class): each combines every G-th of the S partials
  // by the tie rule, then a shuffle tree of width G (a power of two dividing
  // 32); the loop bound is block-uniform, so whole warps shuffle
  const int G = a.G;
  const int groups = nt / G;
  const int gi = threadIdx.x / G, gl = threadIdx.x % G;
  const int pairs = nrows * T;
  for (int p0 = 0; p0 < pairs; p0 += groups) {
    const int p = p0 + gi;
    const bool live = p < pairs;
    const int r = live ? p / T : 0, c = live ? p % T : 0;
    float v = -INFINITY;
    int qq = kNoQ;
    if (live) {
      for (int s0 = gl; s0 < S; s0 += G) {
        const float ov = pv[r * nt + s0 * T + c];
        const int oq = pq[r * nt + s0 * T + c];
        if (better(ov, oq, v, qq)) {
          v = ov;
          qq = oq;
        }
      }
    }
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, v, off, G);
      const int oq = __shfl_down_sync(kFull, qq, off, G);
      if (better(ov, oq, v, qq)) {
        v = ov;
        qq = oq;
      }
    }
    if (live && gl == 0) {
      const long long at = (yK + k0 + r) * T + c;
      a.cls_val[at] = v;
      a.cls_q[at] = isnan(v) ? Bq : qq;
    }
  }
}

template <int KIND>
int launch_kind(const Args& a, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                int* launches) {
  if (a.dst_lhs != nullptr)
    move_score_tile<KIND, true><<<grid, threads, smem, stream>>>(a);
  else
    move_score_tile<KIND, false><<<grid, threads, smem, stream>>>(a);
  *launches = 1;
  return (int)cudaGetLastError();
}

}  // namespace

// tile: rows per CTA (1 to 16); S: sub-streams per class (every S-th q
// each); G: the reduction's lanes per (row, class), a power of two up to
// 32; threads: the CTA's threads, a multiple of 32 and of G, at least T * S
// when S > 1
extern "C" int cc_move_score_classes_lanes(
    int L, int K, int B, int T, int F, int Kr, int goal_kind, int room_mask,
    int exempt_mask, int Bp, int tile, int S, int G, int threads, long long tab_n,
    long long vtab_n, const long long* cur_b, const long long* orig_b,
    const long long* sib_b, const unsigned char* row_ok, const float* d_rows,
    const float* dst_room, const float* dst_lhs, const long long* prow, const int* rack_lim,
    const float* row_f, const float* col_f, const unsigned char* dst_ok,
    const unsigned char* new_ok, const long long* broker_rack, const long long* order_b,
    const long long* row_t, const int* tab, const int* vtab, const float* vup,
    float* cls_val, long long* cls_q, int* launches, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  *launches = 0;
  if (L <= 0 || L > 65535 || K <= 0 || B <= 0 || T <= 0 || F < 0 || F > kMaxF || Bp < B ||
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
  const int Bq = Bp / T;
  if (tile < 1 || tile > kMaxTile || tile * threads * 8 > 32 * 1024 || S < 1 || S > Bq ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || G < 1 ||
      G > 32 || (G & (G - 1)) != 0 || threads % G != 0 || (S > 1 && T * S > threads))
    return (int)cudaErrorInvalidValue;
  // the kernel's int column, room and topic-table indices
  if ((long long)B * kDims > 0x7FFFFFFFLL || tab_n > 0x7FFFFFFFLL || vtab_n > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  int nd = 0, dims = 0, exempt = 0;
  for (int d = 0; d < kDims; ++d) {
    if (!((room_mask >> d) & 1)) continue;
    dims |= d << (4 * nd);
    if ((exempt_mask >> d) & 1) exempt |= 1 << nd;
    ++nd;
  }
  Args a{B, T, F, Kr, goal_kind, Bp, K, S, G, tile, nd, dims, exempt, tab_n, vtab_n,
         cur_b, orig_b, sib_b, row_ok, d_rows, dst_room, dst_lhs, prow, rack_lim, row_f,
         col_f, dst_ok, new_ok, broker_rack, order_b, row_t, tab, vtab, vup, cls_val, cls_q};
  const size_t smem = (size_t)tile * threads * (sizeof(float) + sizeof(int));
  const dim3 grid((K + tile - 1) / tile, L);
  switch (goal_kind) {
    case kGoalRack: return launch_kind<kGoalRack>(a, grid, threads, smem, stream, launches);
    case kGoalCapacity: return launch_kind<kGoalCapacity>(a, grid, threads, smem, stream, launches);
    case kGoalReplicaCapacity:
      return launch_kind<kGoalReplicaCapacity>(a, grid, threads, smem, stream, launches);
    case kGoalReplicaDist:
      return launch_kind<kGoalReplicaDist>(a, grid, threads, smem, stream, launches);
    case kGoalMinTopic: return launch_kind<kGoalMinTopic>(a, grid, threads, smem, stream, launches);
    case kGoalLeaderDist:
      return launch_kind<kGoalLeaderDist>(a, grid, threads, smem, stream, launches);
    case kGoalResourceDist:
      return launch_kind<kGoalResourceDist>(a, grid, threads, smem, stream, launches);
    case kGoalTopicReplica:
      return launch_kind<kGoalTopicReplica>(a, grid, threads, smem, stream, launches);
    case kGoalRackDist: return launch_kind<kGoalRackDist>(a, grid, threads, smem, stream, launches);
    default: return (int)cudaErrorInvalidValue;
  }
}
