// K1 keying replica_keys: the [R]-sized candidate-key sweeps of the goals
// that read the load tables.
//
// Replaces the goals' key functions as cruise_control_tpu/analyzer/engine.py
// calls them on its precision policy's sweep view (_sweep_env :85,
// _sweep_state :98; call sites :929-933, :984-995, :1106, :1205-1208):
// CapacityGoal.replica_key / leader_key (goals/capacity.py:48, :101),
// PotentialNwOutGoal.replica_key (goals/network.py:40),
// LeaderBytesInDistributionGoal.leader_key (network.py:115),
// ResourceDistributionGoal.replica_key / leader_key / swap_out_key /
// swap_in_key (goals/distribution.py:86, :183, :232, :240) and the two
// intra-broker goals' replica_key (goals/intra_broker.py:77, :147).
//
// Per row r: the load column `col` of the leader and follower tables, read
// in their own dtype (float, or __nv_bfloat16 under the bf16 policy) and
// upcast at the load; the replica's broker, leader / offline / valid flags;
// per-broker rows bt[n][B] and scalars sc[3] (and per-logdir rows
// dt[n][B * D] for the intra families) that the caller computed with plain
// torch: severities, utilizations, limits, any_deficit, max(headroom) + eps.
// Arithmetic in f32 in the reference's order (built with --fmad=false, so
// no contraction). Under the bf16 policy a family whose reference key is a
// bf16 array rounds its key once to bf16 (round to nearest even) at the
// end, and its offline bump adds bf16(1e12) instead of f32(1e12).
//
// Lanes (K14, the fleet's tenant axis): grid dimension y = lane position j.
// The [R]-sized tables (loads, broker, flags, logdir) are the lane stack's
// [L, R, ...] tensors, read at lane lanes[j] (the running subset of the
// stack); the per-broker rows, scalars and logdir rows are [La, ...] with
// one row per position j, and so is the output. Each lane's keys are its
// solo launch's, bit for bit; the solo entry point is La = 1 with no lane
// list.
//
// Design: one thread per replica; no shared memory, no atomics, every
// output written by one thread. Bound: bytes (about 19 bytes a replica
// under bf16; the [R, M] rows are 8 bytes under bf16, so a warp's column
// reads touch the whole table, which bf16 halves).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

enum Family {
  kCapacity = 0,
  kPotNwOut = 1,
  kLeadDelta = 2,
  kLeadLoad = 3,
  kDist = 4,
  kSwapOut = 5,
  kSwapIn = 6,
  kIntraCapacity = 7,
  kIntraUsage = 8,
};

struct Args {
  long long R;
  int M, col, family, round_out, B, D, nbt, nsc, ndt;
  const long long* lanes;
  float bump;
  const long long* rb;
  const unsigned char* lead;
  const unsigned char* off;
  const unsigned char* valid;
  const float* bt;
  const float* sc;
  const long long* rdisk;
  const float* dt;
};

__device__ __forceinline__ float upcast(float x) { return x; }
__device__ __forceinline__ float upcast(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void replica_keys_kernel(Args a, const T* __restrict__ L,
                                    const T* __restrict__ F, float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long long y = blockIdx.y;
  const long long lane = a.lanes != nullptr ? a.lanes[y] : y;
  L += lane * a.R * a.M;
  F += lane * a.R * a.M;
  out += y * a.R;
  a.rb += lane * a.R;
  a.lead += lane * a.R;
  a.off += lane * a.R;
  a.valid += lane * a.R;
  if (a.rdisk != nullptr) a.rdisk += lane * a.R;
  a.bt += y * a.nbt * (long long)a.B;
  a.sc += y * a.nsc;
  if (a.dt != nullptr) a.dt += y * a.ndt * (long long)a.B * a.D;
  const long long b = a.rb[r];
  const bool v = a.valid[r] != 0;
  const bool ld = a.lead[r] != 0;
  const bool off = a.off[r] != 0;
  const bool offl = off && v;
  const float lc = upcast(L[r * a.M + a.col]);
  const float fc = upcast(F[r * a.M + a.col]);
  const float eff = v ? (ld ? lc : fc) : 0.0f;     // effective_load
  const float* bt0 = a.bt;
  const float* bt1 = a.bt + a.B;
  const float* bt2 = a.bt + 2 * (long long)a.B;
  float key = -INFINITY;
  bool bump = false;
  switch (a.family) {
    case kCapacity:
    case kPotNwOut: {
      const float load = a.family == kCapacity ? eff : lc;
      if (v && bt0[b] > 0.0f && (load > 0.0f || offl)) key = load;
      bump = offl;
      break;
    }
    case kLeadDelta:
    case kLeadLoad: {
      const float val = a.family == kLeadDelta ? lc - fc : lc;
      if (v && ld && bt0[b] > a.sc[0] && val > 0.0f && !off) key = val;
      break;
    }
    case kDist: {
      const float util = bt1[b];
      const bool excess = bt0[b] > a.sc[0];
      const bool donor = (util - eff) >= bt2[b];
      const bool fits = eff <= a.sc[2];
      const bool movable = v && eff > 0.0f && fits && (excess || (a.sc[1] != 0.0f && donor));
      if (movable || offl) key = __fdiv_rn(eff, fmaxf(util, 1e-9f));
      bump = offl;
      break;
    }
    case kSwapOut:
      if (v && bt0[b] > 0.0f && !off) key = eff;
      break;
    case kSwapIn:
      if (v && bt0[b] <= 0.0f && !off) key = -eff;
      break;
    case kIntraCapacity:
    case kIntraUsage: {
      const long long d = a.rdisk[r] < 0 ? 0 : a.rdisk[r];
      const long long i = b * a.D + d;
      const long long BD = (long long)a.B * a.D;
      const float load = ld ? lc : fc;               // candidate_disk_load
      if (a.family == kIntraCapacity) {
        const bool balive = bt0[b] != 0.0f;
        const bool over = a.dt[i] > a.dt[BD + i];
        const bool dead = v && balive && a.dt[2 * BD + i] != 0.0f;
        if (v && balive && (over || dead)) key = load;
        bump = dead;
      } else {
        const bool donor = a.dt[i] > bt1[b];
        if (v && bt0[b] > 0.0f && donor && load > 0.0f) key = load;
      }
      break;
    }
    default:
      break;
  }
  if (bump) key = key + a.bump;                      // -inf stays -inf
  if (a.round_out) key = __bfloat162float(__float2bfloat16_rn(key));
  out[r] = key;
}

}  // namespace

static int launch_keys(int La, const long long* lanes, int R, int M, int col,
                       int family, int is_bf16, int round_out, int B, int D, int nbt,
                       int nsc, int ndt, float bump, const void* L, const void* F,
                       const long long* rb, const unsigned char* lead,
                       const unsigned char* off, const unsigned char* valid,
                       const float* bt, const float* sc, const long long* rdisk,
                       const float* dt, float* out, int* launches,
                       cudaStream_t stream) {
  *launches = 0;
  if (La <= 0 || La > 65535 || R <= 0 || M <= 0 || col < 0 || col >= M ||
      family < kCapacity || family > kIntraUsage || B <= 0 || nbt <= 0 || nsc < 3)
    return (int)cudaErrorInvalidValue;
  if ((family == kIntraCapacity || family == kIntraUsage) &&
      (D <= 0 || rdisk == nullptr || dt == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.R = R; a.M = M; a.col = col; a.family = family; a.round_out = round_out;
  a.B = B; a.D = D; a.nbt = nbt; a.nsc = nsc; a.ndt = ndt; a.lanes = lanes;
  a.bump = bump;
  a.rb = rb; a.lead = lead; a.off = off; a.valid = valid;
  a.bt = bt; a.sc = sc; a.rdisk = rdisk; a.dt = dt;
  const long long grid = ((long long)R + kThreads - 1) / kThreads;
  const dim3 g((unsigned)grid, (unsigned)La);
  if (is_bf16) {
    replica_keys_kernel<__nv_bfloat16><<<g, kThreads, 0, stream>>>(
        a, (const __nv_bfloat16*)L, (const __nv_bfloat16*)F, out);
  } else {
    replica_keys_kernel<float><<<g, kThreads, 0, stream>>>(
        a, (const float*)L, (const float*)F, out);
  }
  *launches = 1;
  return (int)cudaGetLastError();
}

extern "C" int cc_replica_keys(
    int R, int M, int col, int family, int is_bf16, int round_out, int B, int D,
    float bump, const void* L, const void* F, const long long* rb,
    const unsigned char* lead, const unsigned char* off, const unsigned char* valid,
    const float* bt, const float* sc, const long long* rdisk, const float* dt,
    float* out, int* launches, void* stream_ptr) {
  return launch_keys(1, nullptr, R, M, col, family, is_bf16, round_out, B, D, 1, 3, 0,
                     bump, L, F, rb, lead, off, valid, bt, sc, rdisk, dt, out, launches,
                     (cudaStream_t)stream_ptr);
}

// La lanes of a lane stack: the [R]-sized tables are [L, R, ...] read at
// lanes[j] (i64[La] on the device); bt [La, nbt, B], sc [La, nsc], dt
// [La, ndt, B, D] and out [La, R] have one row per position j.
extern "C" int cc_replica_keys_lanes(
    int La, const long long* lanes, int R, int M, int col, int family, int is_bf16,
    int round_out, int B, int D, int nbt, int nsc, int ndt, float bump, const void* L,
    const void* F, const long long* rb, const unsigned char* lead,
    const unsigned char* off, const unsigned char* valid, const float* bt,
    const float* sc, const long long* rdisk, const float* dt, float* out,
    int* launches, void* stream_ptr) {
  *launches = 0;
  if (lanes == nullptr) return (int)cudaErrorInvalidValue;
  return launch_keys(La, lanes, R, M, col, family, is_bf16, round_out, B, D, nbt, nsc,
                     ndt, bump, L, F, rb, lead, off, valid, bt, sc, rdisk, dt, out, launches,
                     (cudaStream_t)stream_ptr);
}
