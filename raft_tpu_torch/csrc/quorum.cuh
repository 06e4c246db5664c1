// The majority commit-index reduction shared by the quorum kernels
// (quorum.cu) and the round kernel (round.cu): reference
// quorum/majority.go:126-172, the per-lane body of
// raft_tpu/ops/quorum_pallas.py _committed_kernel / _joint_kernel.
//
// RAFT_HD marks functions that compile for the card and, for a host build
// of the lane logic, as plain C++.

#pragma once

#ifndef RAFT_HD
#ifdef __CUDACC__
#define RAFT_HD __host__ __device__ __forceinline__
#else
#define RAFT_HD inline
#endif
#endif

namespace raft {

constexpr int kCommittedInf = 2147483647;

// One majority half: (committed, empty) of V acked indexes under a mask.
template <int V>
RAFT_HD void reduce_half(const int (&match)[V], const bool (&mask)[V],
                         int &committed, bool &empty) {
  int r[V];
  int n = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    r[j] = mask[j] ? match[j] : -1;
    n += mask[j] ? 1 : 0;
  }
  // odd-even transposition network (quorum_pallas._sorted_cols:60-69)
#pragma unroll
  for (int rnd = 0; rnd < V; ++rnd) {
#pragma unroll
    for (int j = rnd & 1; j < V - 1; j += 2) {
      const int lo = (r[j] < r[j + 1] ? r[j] : r[j + 1]);
      const int hi = (r[j] < r[j + 1] ? r[j + 1] : r[j]);
      r[j] = lo;
      r[j + 1] = hi;
    }
  }
  // V - n pad values of -1 sort to the front, so position V - q is the
  // reference's n - q: r[V - 1 - n / 2], taken as the last c with n >= 2c
  // (only positions V - 1 - V/2 .. V - 1 are ever picked, so the network's
  // lower outputs are dead code)
  int picked = r[V - 1];
#pragma unroll
  for (int c = 1; c <= V / 2; ++c) picked = n >= 2 * c ? r[V - 1 - c] : picked;
  committed = picked;
  empty = (n == 0);
}

// MajorityConfig.CommittedIndex of one half, an empty one counting as
// 2^31-1.
template <int V>
RAFT_HD int majority_committed(const int (&match)[V], const bool (&mask)[V]) {
  int c;
  bool e;
  reduce_half<V>(match, mask, c, e);
  return e ? kCommittedInf : c;
}

// JointConfig.CommittedIndex (joint.go:49-56): the min of both halves.
template <int V>
RAFT_HD int joint_committed(const int (&match)[V], const bool (&in)[V],
                            const bool (&out)[V]) {
  const int a = majority_committed<V>(match, in);
  const int b = majority_committed<V>(match, out);
  return a < b ? a : b;
}

constexpr int kBadV = 1;  // cudaErrorInvalidValue

}  // namespace raft

// Launch LAUNCH(V) for the runtime voter count v (the kernels instantiate
// V = 1..8); any other v returns raft::kBadV from the caller.
#define RAFT_V_SWITCH(v, LAUNCH)         \
  switch (v) {                           \
    case 1: LAUNCH(1); break;            \
    case 2: LAUNCH(2); break;            \
    case 3: LAUNCH(3); break;            \
    case 4: LAUNCH(4); break;            \
    case 5: LAUNCH(5); break;            \
    case 6: LAUNCH(6); break;            \
    case 7: LAUNCH(7); break;            \
    case 8: LAUNCH(8); break;            \
    default: return raft::kBadV;         \
  }
