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
// What bounds them. The work is a few dozen integer operations per lane
// over 22 B (joint_kernel at the fused round's shape: N = 196,608 lanes per
// block of 65,536 groups, V = 3, 12 B of match, 6 B of masks and 4 B out),
// so the bytes bound them: 4.3 MB, 1.29 us at the H100's 3.35 TB/s. One
// launch is a single wave, and on the card it costs (PERF.md, NVIDIA H100
// 80GB HBM3 at 700 W): about 0.9 us for an empty launch of the same
// grid; about 3.8 us (L2 cold) and 1.7 us (warm) for a plain int4 read of
// the same bytes, which is the floor under any design; and on top of that,
// the arithmetic of the last warps to receive their data, which nothing
// else overlaps.
//
// Design of committed_kernel and joint_kernel (lane-major [N, V] operands):
// - One quad of four lanes a thread. Thread q owns lanes 4q..4q+3, whose
//   match rows are 16V contiguous bytes (V 16-byte loads) and whose rows of
//   each mask are 4V contiguous bytes (V 32-bit loads); the four results
//   leave in one 16-byte store. At V = 3 joint_kernel issues 10 memory
//   instructions per 4 lanes (one lane a thread took 40), and the sectors
//   a warp's loads touch are used whole.
// - The quad's arithmetic is the tail that the memory phase cannot hide, so
//   it is kept short: reduce_half<V> (quorum.cuh) picks among the only
//   positions a voter count can select, so the network's lower outputs are
//   dead code, and each mask byte is tested (!= 0, as the plain version
//   reads a bool, whatever its storage holds) in its word. The four lanes'
//   chains interleave in registers.
// - Loads take the read-only path (ld.global.nc) with no eviction hint: the
//   eager round reads voters_in and voters_out again right after.
// - The ragged edge: the last n % 4 lanes belong to the last thread, which
//   reads them with scalar loads, so nothing is padded or left out.
// - The 16-byte and 4-byte accesses need match and out 16-byte aligned and
//   each mask 4-byte aligned. The wrapper checks match and the masks and
//   allocates out itself; the fused round's operands are whole allocations
//   of the caching allocator (512-byte aligned) in every block of
//   BlockedFusedCluster: torch.where's result for match, and the state's
//   voters_in / voters_out, which the eager round never slices.
// - kThreads = 384: at the bench shape that is 49,152 quad-threads in 128
//   blocks, one block an SM, and the cheapest empty launch. In an
//   exploratory sweep, 64-192 threads read 0.2-3.4 % slower warm, 256 (two
//   blocks on some SMs) 5.7 % and 32 slower still (PERF.md).
// - V is a template parameter, 1..8, so every array unrolls into registers.
//
// Everything outside __CUDACC__ also compiles as plain C++: the host
// entries raft_committed_host / raft_joint_committed_host run the same
// quad body (loads, unpacking, ragged edge) for every thread index in
// turn.
//
// joint_kernel_vm keeps the first port's design: one thread per lane over
// voter-major int32 rows.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "quorum.cuh"

namespace raft {

constexpr int kThreads = 384;  // quad-threads a block

// 16 bytes (four int32) at p, 16-byte aligned, through the read-only path.
RAFT_HD void load16(const int *p, int *r) {
#ifdef __CUDA_ARCH__
  const int4 x = __ldg(reinterpret_cast<const int4 *>(p));
  r[0] = x.x;
  r[1] = x.y;
  r[2] = x.z;
  r[3] = x.w;
#else
  memcpy(r, p, 16);
#endif
}

// 4 bytes at p, 4-byte aligned, through the read-only path.
RAFT_HD uint32_t load4(const uint8_t *p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const unsigned int *>(p));
#else
  uint32_t w;
  memcpy(&w, p, 4);
  return w;
#endif
}

RAFT_HD void store16(int *p, const int (&r)[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4 *>(p) = make_int4(r[0], r[1], r[2], r[3]);
#else
  memcpy(p, r, 16);
#endif
}

// One lane's commit index from its V voter columns: the majority half
// under a (H = 1), or the joint min under a and b (H = 2).
template <int V, int H>
RAFT_HD int lane_committed(const int (&m)[V], const bool (&a)[V], const bool (&b)[V]) {
  return H == 2 ? joint_committed<V>(m, a, b) : majority_committed<V>(m, a);
}

// The lanes of thread q (see the note at the head of the file): the
// majority half under mask_a (H = 1), or the joint min under mask_a and
// mask_b (H = 2; mask_b is read only then).
template <int V, int H>
RAFT_HD void quad(const int *match, const uint8_t *mask_a, const uint8_t *mask_b,
                  int *out, long long n, long long q) {
  const long long i0 = 4 * q;
  if (i0 + 4 <= n) {
    int m[4 * V];
    uint32_t w[2][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      load16(match + i0 * V + 4 * j, m + 4 * j);
      w[0][j] = load4(mask_a + i0 * V + 4 * j);
      w[1][j] = H == 2 ? load4(mask_b + i0 * V + 4 * j) : 0u;
    }
    int r[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int ml[V];
      bool a[V], b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int x = l * V + j;  // byte x of the quad's mask rows
        ml[j] = m[x];
        a[j] = ((w[0][x >> 2] >> (8 * (x & 3))) & 0xffu) != 0;
        b[j] = ((w[1][x >> 2] >> (8 * (x & 3))) & 0xffu) != 0;
      }
      r[l] = lane_committed<V, H>(ml, a, b);
    }
    store16(out + i0, r);
    return;
  }
  for (long long i = i0; i < n; ++i) {  // the last n % 4 lanes
    int ml[V];
    bool a[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ml[j] = match[i * V + j];
      a[j] = mask_a[i * V + j] != 0;
      b[j] = H == 2 && mask_b[i * V + j] != 0;
    }
    out[i] = lane_committed<V, H>(ml, a, b);
  }
}

// Quad-threads for n lanes: one per quad, the last one also taking a
// partial quad.
RAFT_HD long long quads(long long n) { return (n + 3) / 4; }

}  // namespace raft

#ifdef __CUDACC__

namespace {

using raft::kCommittedInf;
using raft::kThreads;
using raft::reduce_half;

template <int V>
__global__ void __launch_bounds__(kThreads)
    committed_kernel(const int *__restrict__ match, const uint8_t *__restrict__ mask,
                     int *__restrict__ out, long long n) {
  raft::quad<V, 1>(match, mask, nullptr, out, n,
                   blockIdx.x * (long long)kThreads + threadIdx.x);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    joint_kernel(const int *__restrict__ match, const uint8_t *__restrict__ mask_in,
                 const uint8_t *__restrict__ mask_out, int *__restrict__ out, long long n) {
  raft::quad<V, 2>(match, mask_in, mask_out, out, n,
                   blockIdx.x * (long long)kThreads + threadIdx.x);
}

// Voter-major operands: row j of each [8, stride] int32 array holds voter
// j of every lane (quorum_pallas.pack_voter_major).
constexpr int kThreadsVm = 256;

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

inline unsigned quad_blocks(long long n) {
  return (unsigned)((raft::quads(n) + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError(); n >= 1.
// match and out 16-byte aligned, each [N, V] bool mask 4-byte aligned.
extern "C" int raft_committed(const void *match, const void *mask, void *out,
                              long long n, int v, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(V)                                                        \
  committed_kernel<V><<<quad_blocks(n), kThreads, 0, s>>>(               \
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
  joint_kernel<V><<<quad_blocks(n), kThreads, 0, s>>>(                   \
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
  const unsigned blocks = (unsigned)((n + kThreadsVm - 1) / kThreadsVm);
#define LAUNCH(V)                                                        \
  joint_kernel_vm<V><<<blocks, kThreadsVm, 0, s>>>(                      \
      (const int *)match, (const int *)mask_in, (const int *)mask_out,   \
      (int *)out, n, stride)
  RAFT_V_SWITCH(v, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The floor under committed_kernel and joint_kernel, for measurement
// (chip_smoke.py's kernels phase), on their grid for n lanes: an empty
// kernel, and a read of `words` 16-byte words of src, up to kFloorWords a
// quad-thread (word t + k * threads for thread t, so neighbouring threads
// read neighbouring words, every load issued before any is used), that
// stores one 16-byte word a thread, as the kernels store their four
// results.
namespace {

constexpr int kFloorWords = 8;

__global__ void __launch_bounds__(kThreads) floor_empty() {}

__global__ void __launch_bounds__(kThreads)
    floor_read(const int4 *__restrict__ src, long long words, int4 *__restrict__ out,
               long long threads) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= threads) return;
  int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kFloorWords; ++k) {
    const long long i = t + k * threads;
    if (i < words) {
      const int4 x = __ldg(src + i);
      acc.x ^= x.x;
      acc.y ^= x.y;
      acc.z ^= x.z;
      acc.w ^= x.w;
    }
  }
  out[t] = acc;
}

}  // namespace

extern "C" int raft_quorum_floor_empty(long long n, void *stream) {
  floor_empty<<<quad_blocks(n), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// out holds quads(n) 16-byte words; returns raft::kBadV when `words` is
// more than the quad-threads read.
extern "C" int raft_quorum_floor_read(const void *src, long long words, void *out,
                                      long long n, void *stream) {
  if (words > kFloorWords * raft::quads(n)) return raft::kBadV;
  floor_read<<<quad_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int4 *)src, words, (int4 *)out, raft::quads(n));
  return (int)cudaGetLastError();
}

#else

namespace {

template <int V, int H>
void quads_host(const void *match, const void *mask_a, const void *mask_b, void *out,
                long long n) {
  for (long long q = 0; q < raft::quads(n); ++q)
    raft::quad<V, H>((const int *)match, (const uint8_t *)mask_a, (const uint8_t *)mask_b,
                     (int *)out, n, q);
}

}  // namespace

// The kernels' quad body on the CPU, thread index after thread index, with
// the same arguments as raft_committed / raft_joint_committed but no
// stream; returns 0, or 1 for a V outside 1..8.
extern "C" int raft_committed_host(const void *match, const void *mask, void *out,
                                   long long n, int v) {
#define LAUNCH(V) quads_host<V, 1>(match, mask, nullptr, out, n)
  RAFT_V_SWITCH(v, LAUNCH)
#undef LAUNCH
  return 0;
}

extern "C" int raft_joint_committed_host(const void *match, const void *mask_in,
                                         const void *mask_out, void *out, long long n,
                                         int v) {
#define LAUNCH(V) quads_host<V, 2>(match, mask_in, mask_out, out, n)
  RAFT_V_SWITCH(v, LAUNCH)
#undef LAUNCH
  return 0;
}

#endif
