// K8 disk_rows / disk_apply: the intra-broker disk branch.
//
// disk_rows replaces cruise_control_tpu/analyzer/engine.py
// _disk_move_branch_batched's _disk_rows (:1222-1230) with goals/base.py
// legit_disk_move_mask (:456), the previous goals' accept_disk_move and the
// active goal's disk_move_score (goals/intra_broker.py :87-102 capacity,
// :162-183 band): [K, D] legitimacy & vetoes & kv > -inf & score, reduced to
// each row's maximum.
//
// disk_apply replaces the same branch's sequential fori_loop (:1238-1253),
// _rescore_disk_move_row (:1186) and state.py apply_disk_move (:404): rows in
// the given order, each re-scored against the live state with the SAME device
// function, lowest-index argmax, ok = best > min_gain & row[d] > min_gain,
// apply (disk_util -= l at the source logdir, += l at the destination,
// replica_disk, replica_offline cleared when the destination heals it,
// moved).
//
// Every float operation is the reference's, one IEEE op at a time (built
// with --fmad=false): sums over D left to right from +0.0 (XLA:CPU's order
// for a minor-axis reduce), (0.01 * headroom) / cap, then + l.
//
// Design: disk_rows runs one thread per (row, logdir); the D scores of a row
// meet in shared memory and the row's logdir-0 thread keeps the first
// maximum. Bound: bytes (a few gathers per (k, d)). disk_apply runs ONE
// thread that walks the rows in order (the reference's loop is sequential:
// a row re-scores against every earlier row's move). Bound: latency, one
// dependent chain of global reads per row. Rows of different brokers touch
// disjoint state, so one warp per broker segment would be exact too.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCapacity = 0;
constexpr int kBand = 1;
constexpr float kDiskEps = 100.0f;
constexpr float kPctEps = 1e-4f;
constexpr float kCapFloor = 1e-6f;
constexpr int kMaxD = 32;
constexpr int kRowsThreads = 256;

struct Disk {
  int B, D, family, vflags;
  float a, b, vcap, vup;
  const long long* rb;
  const unsigned char* rlead;
  const float* lead_disk;
  const float* foll_disk;
  const float* slead_disk;  // the loads the score reads (the sweep view's
  const float* sfoll_disk;  // under the bf16 policy; lead/foll_disk else)
  const unsigned char* rvalid;
  const unsigned char* rtexcl;
  const unsigned char* balive;
  const unsigned char* dalive;
  const float* dcap;
  const long long* rdisk;   // live (disk_apply writes it)
  const float* dutil;       // live (disk_apply writes it)
};

__device__ __forceinline__ float band_viol(float p, float up, float lo) {
  return fmaxf(p - up, 0.0f) + fmaxf(lo - p, 0.0f);
}

__device__ __forceinline__ bool valid_at(const Disk& s, long long b, int d) {
  const long long i = b * s.D + d;
  return s.dalive[i] && s.dcap[i] > 0.0f && s.balive[b];
}

// the band's average of broker b: sum of util over valid logdirs / max(sum of
// capacity over valid logdirs, 1e-6), both sums left to right from +0.0
__device__ float band_avg(const Disk& s, long long b) {
  float su = 0.0f, sc = 0.0f;
  for (int d = 0; d < s.D; ++d) {
    const bool v = valid_at(s, b, d);
    su = su + (v ? s.dutil[b * s.D + d] : 0.0f);
    sc = sc + (v ? s.dcap[b * s.D + d] : 0.0f);
  }
  return su / fmaxf(sc, kCapFloor);
}

// legitimacy & vetoes & score of moving replica r to logdir d of its own
// broker, against the state as it is now (-inf where not allowed)
__device__ float disk_score(const Disk& s, long long r, int d) {
  const long long b = s.rb[r];
  const long long cur = s.rdisk[r];
  const long long cc = cur < 0 ? 0 : cur;
  const long long i = b * s.D + d;
  const long long ic = b * s.D + cc;
  const bool bal = s.balive[b] != 0;
  // legit_disk_move_mask
  const bool dst_alive = s.dalive[i] && s.dcap[i] > 0.0f;
  const bool on_dead = !s.dalive[ic];
  const bool topic_ok = !s.rtexcl[r] || on_dead;
  bool ok = dst_alive && (long long)d != cur && s.rvalid[r] && bal && topic_ok;
  if (!ok) return -INFINITY;
  const float l = s.rlead[r] ? s.lead_disk[r] : s.foll_disk[r];
  const float ls = s.rlead[r] ? s.slead_disk[r] : s.sfoll_disk[r];
  const float util = s.dutil[i];
  const bool valid_d = valid_at(s, b, d);
  const float capm = fmaxf(s.dcap[i], kCapFloor);
  const bool need_avg = s.family == kBand || (s.vflags & 2);
  const float avg = need_avg ? band_avg(s, b) : 0.0f;
  // previous goals' accept_disk_move
  if (s.vflags & 1) {
    const float limit = valid_d ? s.vcap * s.dcap[i] : 0.0f;
    if (!(util + l <= limit + kDiskEps)) return -INFINITY;
  }
  if (s.vflags & 2) {
    const float after = util / capm + l / capm;
    if (valid_d && !(after <= avg * s.vup + kPctEps)) return -INFINITY;
  }
  if (s.family == kCapacity) {
    const float limit = valid_d ? s.a * s.dcap[i] : 0.0f;
    const bool valid_c = valid_at(s, b, (int)cc);
    const float limit_c = valid_c ? s.a * s.dcap[ic] : 0.0f;
    const bool feasible = util + ls <= limit;
    const bool src_over = s.dutil[ic] > limit_c + kDiskEps;
    const bool dead = s.rvalid[r] && bal && !(s.dalive[ic] && s.dcap[ic] > 0.0f);
    if (!(feasible && (src_over || dead))) return -INFINITY;
    const float headroom = fmaxf(limit - util, 0.0f);
    return dead ? 1.0f + headroom / capm : ls + (0.01f * headroom) / capm;
  }
  // kBand
  if (!valid_d) return -INFINITY;
  const float up = avg * s.a;
  const float lo = avg * s.b;
  const float src_cap = fmaxf(s.dcap[ic], kCapFloor);
  const float src_pct = s.dutil[ic] / src_cap;
  const float pct = util / capm;
  const float vsb = band_viol(src_pct, up, lo);
  const float vsa = band_viol(src_pct - ls / src_cap, up, lo);
  const float vdb = band_viol(pct, up, lo);
  const float vda = band_viol(pct + ls / capm, up, lo);
  return (vsb - vsa) + (vdb - vda);
}

__global__ void disk_rows_kernel(Disk s, int K, const long long* __restrict__ cand,
                                 const float* __restrict__ kv,
                                 float* __restrict__ best) {
  __shared__ float sc[kRowsThreads];
  const int rows = blockDim.x / s.D;
  const int local = threadIdx.x / s.D;
  const int d = threadIdx.x % s.D;
  const long long k = (long long)blockIdx.x * rows + local;
  const bool live = local < rows && k < K;
  if (live) sc[threadIdx.x] = kv[k] > -INFINITY ? disk_score(s, cand[k], d) : -INFINITY;
  __syncthreads();
  if (live && d == 0) {
    float m = sc[threadIdx.x];
    for (int j = 1; j < s.D; ++j) m = sc[threadIdx.x + j] > m ? sc[threadIdx.x + j] : m;
    best[k] = m;
  }
}

__global__ void disk_apply_kernel(Disk s, int K, float min_gain,
                                  const long long* __restrict__ cand,
                                  const float* __restrict__ best,
                                  const long long* __restrict__ order,
                                  long long* rdisk, unsigned char* roff,
                                  unsigned char* moved, float* dutil,
                                  long long* n_applied) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  long long n = 0;
  for (int i = 0; i < K; ++i) {
    const long long k = order[i];
    if (!(best[k] > min_gain)) break;   // rows sorted by best, descending
    const long long r = cand[k];
    float bv = disk_score(s, r, 0);
    int bd = 0;
    for (int d = 1; d < s.D; ++d) {
      const float v = disk_score(s, r, d);
      if (v > bv) { bv = v; bd = d; }
    }
    if (!(bv > min_gain)) continue;
    const long long b = s.rb[r];
    const float l = s.rlead[r] ? s.lead_disk[r] : s.foll_disk[r];
    const long long src = rdisk[r];
    dutil[b * s.D + src] = dutil[b * s.D + src] + (-l);
    dutil[b * s.D + bd] = dutil[b * s.D + bd] + l;
    rdisk[r] = bd;
    if (s.dalive[b * s.D + bd] && s.balive[b]) roff[r] = 0;
    moved[r] = 1;
    ++n;
  }
  *n_applied = n;
}

Disk make_disk(int B, int D, int family, int vflags, float a, float b, float vcap,
               float vup, const long long* rb, const unsigned char* rlead,
               const float* lead_disk, const float* foll_disk,
               const float* slead_disk, const float* sfoll_disk,
               const unsigned char* rvalid, const unsigned char* rtexcl,
               const unsigned char* balive, const unsigned char* dalive,
               const float* dcap, const long long* rdisk, const float* dutil) {
  Disk s;
  s.B = B; s.D = D; s.family = family; s.vflags = vflags;
  s.a = a; s.b = b; s.vcap = vcap; s.vup = vup;
  s.rb = rb; s.rlead = rlead; s.lead_disk = lead_disk; s.foll_disk = foll_disk;
  s.slead_disk = slead_disk; s.sfoll_disk = sfoll_disk;
  s.rvalid = rvalid; s.rtexcl = rtexcl; s.balive = balive; s.dalive = dalive;
  s.dcap = dcap; s.rdisk = rdisk; s.dutil = dutil;
  return s;
}

}  // namespace

extern "C" int cc_disk_rows(
    int K, int B, int D, int family, int vflags, float a, float b, float vcap,
    float vup, const long long* rb, const unsigned char* rlead,
    const float* lead_disk, const float* foll_disk, const float* slead_disk,
    const float* sfoll_disk, const unsigned char* rvalid,
    const unsigned char* rtexcl, const unsigned char* balive,
    const unsigned char* dalive, const float* dcap, const long long* rdisk,
    const float* dutil, const long long* cand, const float* kv, float* best,
    void* stream_ptr) {
  if (K <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Disk s = make_disk(B, D, family, vflags, a, b, vcap, vup, rb, rlead, lead_disk,
                     foll_disk, slead_disk, sfoll_disk, rvalid, rtexcl, balive,
                     dalive, dcap, rdisk, dutil);
  const int rows = kRowsThreads / D;
  const int grid = (K + rows - 1) / rows;
  disk_rows_kernel<<<grid, rows * D, 0, stream>>>(s, K, cand, kv, best);
  return (int)cudaGetLastError();
}

extern "C" int cc_disk_apply(
    int K, int B, int D, int family, int vflags, float a, float b, float vcap,
    float vup, float min_gain, const long long* rb, const unsigned char* rlead,
    const float* lead_disk, const float* foll_disk, const unsigned char* rvalid,
    const unsigned char* rtexcl, const unsigned char* balive,
    const unsigned char* dalive, const float* dcap, const long long* cand,
    const float* best, const long long* order, long long* rdisk,
    unsigned char* roff, unsigned char* moved, float* dutil, long long* n_applied,
    void* stream_ptr) {
  if (K <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Disk s = make_disk(B, D, family, vflags, a, b, vcap, vup, rb, rlead, lead_disk,
                     foll_disk, lead_disk, foll_disk, rvalid, rtexcl, balive, dalive,
                     dcap, rdisk, dutil);
  disk_apply_kernel<<<1, 32, 0, stream>>>(s, K, min_gain, cand, best, order, rdisk,
                                          roff, moved, dutil, n_applied);
  return (int)cudaGetLastError();
}
