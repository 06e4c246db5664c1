// Commit-index quorum kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (raft_tpu_torch/ops/quorum_cuda.py).
//
// Replaces the three Pallas TPU kernels of raft_tpu/ops/quorum_pallas.py:
//   committed_kernel  <- _committed_kernel (:99), via committed_pallas (:155)
//   joint_kernel      <- _joint_kernel (:106), via joint_committed_pallas (:178)
//   joint_kernel_vm   <- _joint_kernel_vm (:120), via joint_committed_packed (:205)
//
// What they compute (reference quorum/majority.go:126-172, joint.go:49-56):
// per lane, mask absent voters to -1, sort the V acked indexes ascending
// with an odd-even transposition network, and pick element V - (n/2 + 1),
// n the number of voters; an empty voter set gives 2^31-1, the identity of
// the joint min. The joint form runs both halves over one match row and
// takes their min.
//
// The per-lane reduction, reduce_half<V>, lives in quorum.cuh, shared with
// the round kernel (round.cu).
//
// Design. One thread per lane. V is a template parameter (1..8), so the
// network unrolls fully and the V values live in registers; nothing is
// staged in shared memory because nothing is reused across lanes. The
// Pallas kernels padded N to 1024-lane tiles and V to 8 sublanes; here
// each thread masks the ragged edge (i >= n) and reads exactly V columns,
// so no padding is needed. Masks are read as uint8 (torch bool storage).
//
// Bound. The work is a few dozen integer compares per lane, so the bytes
// bound it. At the fused round's shape (N = 196,608 lanes per block of
// 65,536 groups, V = 3) joint_kernel reads 12 B of match and 6 B of masks
// and writes 4 B per lane: 22 B/lane, about 4.3 MB, about 1.3 us at the
// H100's 3.35 TB/s. A launch costs more than that, so the kernel is held
// to being right; fusing it into the round is the megakernel's work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum.cuh"

namespace {

using raft::kCommittedInf;
using raft::reduce_half;

constexpr int kThreads = 256;

template <int V>
__global__ void committed_kernel(const int *__restrict__ match,
                                 const uint8_t *__restrict__ mask,
                                 int *__restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int m[V];
  bool k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = match[i * V + j];
    k[j] = mask[i * V + j] != 0;
  }
  int c;
  bool e;
  reduce_half<V>(m, k, c, e);
  out[i] = e ? kCommittedInf : c;
}

template <int V>
__global__ void joint_kernel(const int *__restrict__ match,
                             const uint8_t *__restrict__ mask_in,
                             const uint8_t *__restrict__ mask_out,
                             int *__restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int m[V];
  bool a_m[V], b_m[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = match[i * V + j];
    a_m[j] = mask_in[i * V + j] != 0;
    b_m[j] = mask_out[i * V + j] != 0;
  }
  int a, b;
  bool a_e, b_e;
  reduce_half<V>(m, a_m, a, a_e);
  reduce_half<V>(m, b_m, b, b_e);
  out[i] = min(a_e ? kCommittedInf : a, b_e ? kCommittedInf : b);
}

// Voter-major operands: row j of each [8, stride] int32 array holds voter
// j of every lane (quorum_pallas.pack_voter_major).
template <int V>
__global__ void joint_kernel_vm(const int *__restrict__ match,
                                const int *__restrict__ mask_in,
                                const int *__restrict__ mask_out,
                                int *__restrict__ out, long long n,
                                long long stride) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int m[V];
  bool a_m[V], b_m[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = match[j * stride + i];
    a_m[j] = mask_in[j * stride + i] != 0;
    b_m[j] = mask_out[j * stride + i] != 0;
  }
  int a, b;
  bool a_e, b_e;
  reduce_half<V>(m, a_m, a, a_e);
  reduce_half<V>(m, b_m, b, b_e);
  out[i] = min(a_e ? kCommittedInf : a, b_e ? kCommittedInf : b);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError(); n >= 1.
extern "C" int raft_committed(const void *match, const void *mask, void *out,
                              long long n, int v, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(V)                                                        \
  committed_kernel<V><<<blocks_for(n), kThreads, 0, s>>>(                \
      (const int *)match, (const uint8_t *)mask, (int *)out, n)
  RAFT_V_SWITCH(v, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int raft_joint_committed(const void *match, const void *mask_in,
                                    const void *mask_out, void *out,
                                    long long n, int v, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(V)                                                        \
  joint_kernel<V><<<blocks_for(n), kThreads, 0, s>>>(                    \
      (const int *)match, (const uint8_t *)mask_in,                      \
      (const uint8_t *)mask_out, (int *)out, n)
  RAFT_V_SWITCH(v, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int raft_joint_committed_vm(const void *match, const void *mask_in,
                                       const void *mask_out, void *out,
                                       long long n, long long stride, int v,
                                       void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(V)                                                        \
  joint_kernel_vm<V><<<blocks_for(n), kThreads, 0, s>>>(                 \
      (const int *)match, (const int *)mask_in, (const int *)mask_out,   \
      (int *)out, n, stride)
  RAFT_V_SWITCH(v, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
