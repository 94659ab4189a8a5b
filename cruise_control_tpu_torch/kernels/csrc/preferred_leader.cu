// K12 preferred_leader: the preferred-leader election pass.
//
// Replaces cruise_control_tpu/analyzer/goals/leader_election.py
// PreferredLeaderElectionGoal._preferred_leader (:36), _current_leader
// (:69), violated (:27) and apply (:77), as optimizer.py _compiled_ple
// (:287) runs them. Per partition p over its F members (-1 padded):
// eligible = member exists, broker alive and not leadership-excluded,
// replica online; demoted = broker demoted. While any broker is demoted the
// preferred leader is the first eligible member after the demoted ones are
// sorted last (first minimum of f + F * demoted, 2F + 1 where not
// eligible), for partitions hosting a demoted member; otherwise the
// position-0 member when eligible and not demoted. The current leader is
// the first member flagged leader. A partition with members whose
// preferred leader exists and differs from the current one counts as
// violating; with apply, a partition whose current leader also exists
// flips: leader flag off at the current row, on at the preferred row, both
// rows marked leadership_moved.
//
// Design: one thread per partition. A partition's members are distinct
// replicas, so every flag write of one thread lands on rows no other
// thread reads or writes (no atomics on the flags). The violation count is
// one integer atomicAdd per block (exact in any order). Each block first
// reduces broker_demoted over B into shared memory (B bytes from L2).
// Bound: bytes (F gathers per partition).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void preferred_leader_kernel(
    int Pn, int F, int B, int apply, const long long* __restrict__ members,
    const long long* __restrict__ rb, const unsigned char* __restrict__ roff,
    const unsigned char* __restrict__ alive, const unsigned char* __restrict__ excl,
    const unsigned char* __restrict__ demoted, const unsigned char* rlead_in,
    unsigned char* rlead, unsigned char* moved, int* n_violated) {
  __shared__ int any_demoted;
  __shared__ int block_count;
  if (threadIdx.x == 0) { any_demoted = 0; block_count = 0; }
  __syncthreads();
  int mine = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) mine |= demoted[b] ? 1 : 0;
  if (mine) atomicOr(&any_demoted, 1);
  __syncthreads();
  const bool demotion = any_demoted != 0;

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < Pn) {
    const long long* row = members + p * F;
    bool has = false, any_ok = false, any_dem = false, any_lead = false;
    int best_order = 2 * F + 2, first = 0;
    long long cur = -1;
    long long m0 = 0;
    bool ok0 = false, dem0 = false;
    for (int f = 0; f < F; ++f) {
      const long long mem = row[f];
      const long long m = mem < 0 ? 0 : mem;
      const bool valid = mem >= 0;
      const long long b = rb[m];
      const bool ok = valid && alive[b] && !excl[b] && !roff[m];
      const bool dem = valid && demoted[b];
      has = has || valid;
      any_ok = any_ok || ok;
      any_dem = any_dem || dem;
      const int order = ok ? f + (dem ? F : 0) : 2 * F + 1;
      if (order < best_order) { best_order = order; first = f; }
      if (f == 0) { m0 = m; ok0 = ok; dem0 = dem; }
      if (!any_lead && valid && rlead_in[m]) { any_lead = true; cur = mem; }
    }
    long long pref;
    if (demotion) {
      const long long mf = row[first];
      pref = (any_ok && any_dem) ? (mf < 0 ? 0 : mf) : -1;
    } else {
      pref = (ok0 && !dem0) ? m0 : -1;
    }
    if (has && pref >= 0 && pref != cur) {
      atomicAdd(&block_count, 1);
      if (apply && cur >= 0) {
        rlead[cur] = 0;
        rlead[pref] = 1;
        moved[cur] = 1;
        moved[pref] = 1;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(n_violated, block_count);
}

}  // namespace

extern "C" int cc_preferred_leader(
    int Pn, int F, int B, int R, int apply, const long long* members,
    const long long* rb, const unsigned char* roff, const unsigned char* alive,
    const unsigned char* excl, const unsigned char* demoted,
    const unsigned char* rlead_in, unsigned char* rlead, unsigned char* moved,
    int* n_violated, int* launches, void* stream_ptr) {
  (void)R;
  *launches = 0;
  if (Pn <= 0 || F <= 0 || F > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int grid = (Pn + kThreads - 1) / kThreads;
  preferred_leader_kernel<<<grid, kThreads, 0, stream>>>(
      Pn, F, B, apply, members, rb, roff, alive, excl, demoted, rlead_in, rlead,
      moved, n_violated);
  *launches = 1;
  return (int)cudaGetLastError();
}
