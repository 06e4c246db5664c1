// The round megakernel for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (raft_tpu_torch/ops/round_cuda.py).
//
// Replaces the Pallas TPU kernel of raft_tpu/ops/pallas_round.py:
//   round_kernel  <- make_call(kc).kernel (:564-732), pl.pallas_call (:745),
//                    reached from pallas_rounds (:389)
//
// What it computes: kc rounds of route_fabric + fused_round
// (raft_tpu_torch/ops/fused.py) over the lanes of a block, with the carry
// read from device memory once and written back once. Its plain PyTorch
// version is ops/pallas_round.py round_kernel_ref, and the two agree on
// every carry leaf and every partials row, exactly (integer state).
//
// Design. One thread per lane; a CUDA block covers whole raft groups (its
// lane count is a multiple of V), so routing never leaves the block and no
// grid-wide sync is needed.
// - Carry: each thread loads its lane's slim state columns, widening the
//   narrow dtypes to int32 (struct Lane), runs the rounds, narrows between
//   rounds (replaying the slim casts, so K rounds in one launch equal K
//   launches of one round bit for bit) and stores once.
// - Routing without a transposed copy: lane g*V+j reads its inbound cell i
//   straight from the outbound fabric of lane g*V+i, slot j; the mute cut
//   (sender or receiver muted) applies at the read, the self slot passes
//   through. The fabric of round k is written to a second buffer
//   (ping-pong between the output fabric and a scratch fabric, one
//   __syncthreads() per round), never to the one being read.
// - The commit index and vote tallies are per lane over its own [V]
//   progress rows: raft::joint_committed / reduce_half<V> of quorum.cuh,
//   shared with quorum.cu.
// - Metrics: per-thread counter deltas, latency bucket and lat_sum, summed
//   into the block's partials row for the round with shared-memory integer
//   atomics (exact in any order); the rows are summed outside the kernel.
// - The source is laid out as device functions that mirror the Python
//   modules (ops/log.py, ops/progress.py, ops/step.py, ops/fused.py), so a
//   leaf that differs points at one function.
//
// Bound. A lane's round is a few thousand integer operations on its own
// carry; the carry itself (about 750 B/lane slim at the bench shape) is
// read once and written once per launch, so at the bench shape the bytes
// bound it (chip_smoke.py computes both bounds from the real tensors).
// This first version keeps the widened carry in local memory (ptxas
// reports the stack frame and spills); staging it through shared memory,
// coalescing the column loads and keeping it in registers is later work.
//
// Argument packing. The pointer table follows the dataclass field order of
// RaftState, LaneConfig, Fabric and LocalOps; the X-macro tables below are
// that order, with each leaf's storage dtype and shape, and
// tests/test_torch_pallas_round.py holds them against the dataclasses.
// Everything not under __CUDACC__ also compiles as plain C++ (the host
// entry raft_round_host runs the same lane code on the CPU).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "quorum.cuh"

// ---------------------------------------------------------------------------
// leaf tables: X(name, storage dtype, shape)
//   shapes: LANE [N], PEER [N,V], WIN [N,W], INFL [N,V,F], READ [N,R],
//           READ_PEER [N,R,V], ENT [N,V,E]

#define RAFT_STATE_FIELDS(X)              \
  X(id, I32, LANE)                        \
  X(term, I32, LANE)                      \
  X(vote, I32, LANE)                      \
  X(state, I8, LANE)                      \
  X(lead, I32, LANE)                      \
  X(lead_transferee, I32, LANE)           \
  X(is_learner, BOOL, LANE)               \
  X(pending_conf_index, I32, LANE)        \
  X(uncommitted_size, I32, LANE)          \
  X(election_elapsed, I16, LANE)          \
  X(heartbeat_elapsed, I16, LANE)         \
  X(randomized_election_timeout, I16, LANE) \
  X(rng, U32, LANE)                       \
  X(log_term, I32, WIN)                   \
  X(log_type, I8, WIN)                    \
  X(log_bytes, I32, WIN)                  \
  X(last, I32, LANE)                      \
  X(stabled, I32, LANE)                   \
  X(committed, I32, LANE)                 \
  X(applying, I32, LANE)                  \
  X(applied, I32, LANE)                   \
  X(snap_index, I32, LANE)                \
  X(snap_term, I32, LANE)                 \
  X(pending_snap_index, I32, LANE)        \
  X(pending_snap_term, I32, LANE)         \
  X(avail_snap_index, I32, LANE)          \
  X(avail_snap_term, I32, LANE)           \
  X(snap_unavailable, BOOL, LANE)         \
  X(prs_id, I32, PEER)                    \
  X(voters_in, BOOL, PEER)                \
  X(voters_out, BOOL, PEER)               \
  X(learners, BOOL, PEER)                 \
  X(learners_next, BOOL, PEER)            \
  X(auto_leave, BOOL, LANE)               \
  X(pr_match, I32, PEER)                  \
  X(pr_next, I32, PEER)                   \
  X(pr_state, I8, PEER)                   \
  X(pr_pending_snapshot, I32, PEER)       \
  X(pr_recent_active, BOOL, PEER)         \
  X(pr_msg_app_flow_paused, BOOL, PEER)   \
  X(votes, I8, PEER)                      \
  X(infl_index, I32, INFL)                \
  X(infl_bytes, I32, INFL)                \
  X(infl_start, I8, PEER)                 \
  X(infl_count, I8, PEER)                 \
  X(infl_total_bytes, I32, PEER)          \
  X(ro_ctx, I32, READ)                    \
  X(ro_from, I32, READ)                   \
  X(ro_index, I32, READ)                  \
  X(ro_acks, BOOL, READ_PEER)             \
  X(ro_seq, I32, READ)                    \
  X(ro_next_seq, I32, LANE)               \
  X(pri_ctx, I32, READ)                   \
  X(pri_from, I32, READ)                  \
  X(rs_ctx, I32, READ)                    \
  X(rs_index, I32, READ)                  \
  X(rs_count, I8, LANE)                   \
  X(error_bits, I32, LANE)

#define RAFT_CFG_FIELDS(X)                     \
  X(election_tick, I32, LANE)                  \
  X(heartbeat_tick, I32, LANE)                 \
  X(max_size_per_msg, I32, LANE)               \
  X(max_uncommitted_size, I32, LANE)           \
  X(max_committed_size_per_ready, I32, LANE)   \
  X(max_inflight, I32, LANE)                   \
  X(max_inflight_bytes, I32, LANE)             \
  X(check_quorum, BOOL, LANE)                  \
  X(pre_vote, BOOL, LANE)                      \
  X(read_only_lease_based, BOOL, LANE)         \
  X(disable_proposal_forwarding, BOOL, LANE)   \
  X(step_down_on_removal, BOOL, LANE)          \
  X(disable_conf_change_validation, BOOL, LANE)

// Fabric leaves: channel_field (the `self_` channel is named `self`)
#define RAFT_FABRIC_FIELDS(X)   \
  X(rep_kind, I8, PEER)         \
  X(rep_term, I32, PEER)        \
  X(rep_index, I32, PEER)       \
  X(rep_log_term, I32, PEER)    \
  X(rep_commit, I32, PEER)      \
  X(rep_reject, BOOL, PEER)     \
  X(rep_reject_hint, I32, PEER) \
  X(rep_n_ents, I8, PEER)       \
  X(rep_ent_term, I32, ENT)     \
  X(rep_ent_type, I8, ENT)      \
  X(rep_ent_bytes, I32, ENT)    \
  X(rep_snap_index, I32, PEER)  \
  X(rep_snap_term, I32, PEER)   \
  X(hb_kind, I8, PEER)          \
  X(hb_term, I32, PEER)         \
  X(hb_commit, I32, PEER)       \
  X(hb_context, I32, PEER)      \
  X(vote_kind, I8, PEER)        \
  X(vote_term, I32, PEER)       \
  X(vote_index, I32, PEER)      \
  X(vote_log_term, I32, PEER)   \
  X(vote_reject, BOOL, PEER)    \
  X(vote_context, I32, PEER)    \
  X(vresp_kind, I8, PEER)       \
  X(vresp_term, I32, PEER)      \
  X(vresp_reject, BOOL, PEER)   \
  X(self_kind, I8, LANE)        \
  X(self_term, I32, LANE)       \
  X(self_index, I32, LANE)

#define RAFT_OPS_FIELDS(X)   \
  X(hup, BOOL, LANE)         \
  X(prop_n, I32, LANE)       \
  X(prop_bytes, I32, LANE)   \
  X(transfer_to, I32, LANE)  \
  X(read_ctx, I32, LANE)     \
  X(forget, BOOL, LANE)      \
  X(prop_cc, I32, LANE)      \
  X(beat, BOOL, LANE)

namespace raft {

// compile-time capacities of the per-thread arrays (the wrapper raises on a
// Shape above them)
constexpr int kMaxW = 64;  // log_window
constexpr int kMaxE = 8;   // max_msg_entries
constexpr int kMaxF = 8;   // max_inflight
constexpr int kMaxR = 8;   // max_read_index
constexpr int kMaxCta = 256;  // lanes (threads) per CUDA block

#define RAFT_COUNT(name, dt, shape) +1
constexpr int kStateN = 0 RAFT_STATE_FIELDS(RAFT_COUNT);
constexpr int kCfgN = 0 RAFT_CFG_FIELDS(RAFT_COUNT);
constexpr int kFabN = 0 RAFT_FABRIC_FIELDS(RAFT_COUNT);
constexpr int kOpsN = 0 RAFT_OPS_FIELDS(RAFT_COUNT);
#undef RAFT_COUNT

// The pointer table, in this order (round_cuda.py builds the same list):
enum : int {
  P_STATE_IN = 0,                  // RaftState leaves without cfg, slim
  P_CFG = P_STATE_IN + kStateN,    // LaneConfig leaves (read only)
  P_FAB_IN = P_CFG + kCfgN,        // Fabric leaves, slim (the outbox)
  P_OPS = P_FAB_IN + kFabN,        // LocalOps leaves
  P_MUTE = P_OPS + kOpsN,          // [N] bool, or null
  P_SAMP_INDEX_IN,                 // [N] i32 (metrics on)
  P_SAMP_ROUND_IN,                 // [N] i32 (metrics on)
  P_ROUND_CTR,                     // [] i32 (metrics on)
  P_STATE_OUT,
  P_FAB_OUT = P_STATE_OUT + kStateN,
  P_FAB_SCR = P_FAB_OUT + kFabN,   // scratch fabric (kc > 1)
  P_SAMP_INDEX_OUT = P_FAB_SCR + kFabN,
  P_SAMP_ROUND_OUT,
  P_PARTIALS,                      // [kc, n / cta, kPartialWidth] i32
  kNumPtrs
};

// flags
enum : int {
  F_MUTE = 1,
  F_METRICS = 2,
  F_TICK = 4,
  F_AUTO_PROPOSE = 8,
  F_LAG = 16,          // auto_compact_lag given
  F_OPS = 32,          // this launch applies its LocalOps ...
  F_OPS_ROUND0 = 64,   // ... in its first round only
};

// partials row (raft_tpu/ops/pallas_round.py:109-120 with metrics on)
constexpr int kCounters = 13;  // metrics/device.py COUNTERS
constexpr int kBuckets = 11;   // metrics/device.py N_BUCKETS
constexpr int kPartUsed = kCounters + kBuckets + 1;
constexpr int kPartialWidth = 128;
enum : int {
  C_ELECTIONS_STARTED = 0, C_ELECTIONS_WON, C_LEADER_CHANGES, C_COMMITS,
  C_PROPOSALS, C_PROPOSALS_DROPPED, C_MSGS_APP, C_MSGS_APP_RESP,
  C_MSGS_HEARTBEAT, C_MSGS_HEARTBEAT_RESP, C_MSGS_VOTE, C_MSGS_VOTE_RESP,
  C_READ_INDEX_SERVED,
  C_HIST0 = kCounters,
  C_LAT_SUM = kCounters + kBuckets,
};

// types.py
enum : int {
  MSG_APP = 3, MSG_APP_RESP = 4, MSG_VOTE = 5, MSG_VOTE_RESP = 6,
  MSG_SNAP = 7, MSG_HEARTBEAT = 8, MSG_HEARTBEAT_RESP = 9,
  MSG_TIMEOUT_NOW = 14, MSG_PRE_VOTE = 17, MSG_PRE_VOTE_RESP = 18,
  MSG_NONE = 63,
};
enum : int { FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, PRE_CANDIDATE = 3 };
enum : int { PROBE = 0, REPLICATE = 1, SNAPSHOT = 2 };
enum : int { PENDING = 0, GRANTED = 1, REJECTED = 2 };
enum : int { VOTE_WON = 1, VOTE_LOST = 2, VOTE_PENDING = 3 };
enum : int { PRE_ELECTION = 0, ELECTION = 1, TRANSFER = 2 };
constexpr int ENTRY_CONF_CHANGE_V2 = 2;

// ops/log.py error bits
constexpr int ERR_COMMIT_OUT_OF_RANGE = 1;
constexpr int ERR_CONFLICT_BELOW_COMMIT = 2;
constexpr int ERR_APPEND_BELOW_COMMIT = 4;
constexpr int ERR_WINDOW_OVERFLOW = 8;
constexpr int ERR_APPLIED_OUT_OF_RANGE = 16;
constexpr int ERR_INDEX_NEAR_OVERFLOW = 32;
constexpr int INDEX_OVERFLOW_MARGIN = 1 << 30;
constexpr int BIG = 2147483647;

struct Args {
  void *p[kNumPtrs];
  long long n;
  int w, e, f, r;
  int kc;     // rounds in this launch
  int flags;
  int lag;    // auto_compact_lag when F_LAG
};

struct Dims {
  long long n;
  int w, e, f, r;
};

// ---------------------------------------------------------------------------
// the widened per-lane carry, one member per leaf

#define RAFT_CT_I32 int
#define RAFT_CT_I16 int
#define RAFT_CT_I8 int
#define RAFT_CT_BOOL bool
#define RAFT_CT_U32 uint32_t
#define RAFT_ST_I32 int32_t
#define RAFT_ST_I16 int16_t
#define RAFT_ST_I8 int8_t
#define RAFT_ST_BOOL uint8_t
#define RAFT_ST_U32 uint32_t
#define RAFT_DIMS_LANE
#define RAFT_DIMS_PEER [V]
#define RAFT_DIMS_WIN [kMaxW]
#define RAFT_DIMS_INFL [V][kMaxF]
#define RAFT_DIMS_READ [kMaxR]
#define RAFT_DIMS_READ_PEER [kMaxR][V]
#define RAFT_DIMS_ENT [V][kMaxE]
#define RAFT_MEMBER(name, dt, shape) RAFT_CT_##dt name RAFT_DIMS_##shape;

template <int V>
struct Lane {
  RAFT_STATE_FIELDS(RAFT_MEMBER)
};

template <int V>
struct Cfg {
  RAFT_CFG_FIELDS(RAFT_MEMBER)
};

// a routed inbox or an outbox: cell i of a PEER leaf is member i
template <int V>
struct Fab {
  RAFT_FABRIC_FIELDS(RAFT_MEMBER)
};

template <int V>
struct Ops {
  RAFT_OPS_FIELDS(RAFT_MEMBER)
};

// ---------------------------------------------------------------------------
// leaf I/O: load (widen), store (narrow), and the narrow->widen round trip

enum : int { LOAD = 0, STORE = 1, ROUNDTRIP = 2, LOAD_ROUTED = 3 };

template <int OP, typename ST, typename CT>
RAFT_HD void io1(void *p, long long off, CT &x) {
  if (OP == LOAD || OP == LOAD_ROUTED) {
    x = (CT)((const ST *)p)[off];
  } else if (OP == STORE) {
    ((ST *)p)[off] = (ST)x;
  } else {
    x = (CT)(ST)x;
  }
}

template <int OP, typename ST, typename CT>
RAFT_HD void io_LANE(void *p, CT &x, long long i, int v, const Dims &) {
  (void)v;
  io1<OP, ST>(p, i, x);
}

// PEER: own slot j of lane i, or, routed, the sender's slot for this lane
template <int OP, typename ST, typename CT, int V>
RAFT_HD void io_PEER(void *p, CT (&x)[V], long long i, int, const Dims &) {
  const long long base = i - i % V;
  const int me = (int)(i % V);
  for (int j = 0; j < V; ++j) {
    const long long off = OP == LOAD_ROUTED ? (base + j) * V + me : i * V + j;
    io1<OP, ST>(p, off, x[j]);
  }
}

template <int OP, typename ST, typename CT, int V>
RAFT_HD void io_ENT(void *p, CT (&x)[V][kMaxE], long long i, int,
                    const Dims &d) {
  const long long base = i - i % V;
  const int me = (int)(i % V);
  for (int j = 0; j < V; ++j) {
    const long long row = OP == LOAD_ROUTED ? (base + j) * V + me : i * V + j;
    for (int k = 0; k < d.e; ++k) io1<OP, ST>(p, row * d.e + k, x[j][k]);
  }
}

template <int OP, typename ST, typename CT>
RAFT_HD void io_WIN(void *p, CT (&x)[kMaxW], long long i, int,
                    const Dims &d) {
  for (int s = 0; s < d.w; ++s) io1<OP, ST>(p, i * d.w + s, x[s]);
}

template <int OP, typename ST, typename CT, int V>
RAFT_HD void io_INFL(void *p, CT (&x)[V][kMaxF], long long i, int,
                     const Dims &d) {
  for (int j = 0; j < V; ++j)
    for (int q = 0; q < d.f; ++q)
      io1<OP, ST>(p, (i * V + j) * d.f + q, x[j][q]);
}

template <int OP, typename ST, typename CT>
RAFT_HD void io_READ(void *p, CT (&x)[kMaxR], long long i, int,
                     const Dims &d) {
  for (int q = 0; q < d.r; ++q) io1<OP, ST>(p, i * d.r + q, x[q]);
}

template <int OP, typename ST, typename CT, int V>
RAFT_HD void io_READ_PEER(void *p, CT (&x)[kMaxR][V], long long i, int,
                          const Dims &d) {
  for (int q = 0; q < d.r; ++q)
    for (int j = 0; j < V; ++j)
      io1<OP, ST>(p, (i * d.r + q) * V + j, x[q][j]);
}

#define RAFT_IO(name, dt, shape)                                          \
  io_##shape<OP, RAFT_ST_##dt>(ptrs ? ptrs[k] : nullptr, obj.name, i, V, \
                                d);                                      \
  ++k;

template <int OP, int V>
RAFT_HD void io_state(void *const *ptrs, Lane<V> &obj, long long i,
                      const Dims &d) {
  int k = 0;
  RAFT_STATE_FIELDS(RAFT_IO)
}

template <int OP, int V>
RAFT_HD void io_cfg(void *const *ptrs, Cfg<V> &obj, long long i,
                    const Dims &d) {
  int k = 0;
  RAFT_CFG_FIELDS(RAFT_IO)
}

template <int OP, int V>
RAFT_HD void io_fab(void *const *ptrs, Fab<V> &obj, long long i,
                    const Dims &d) {
  int k = 0;
  RAFT_FABRIC_FIELDS(RAFT_IO)
}

template <int OP, int V>
RAFT_HD void io_ops(void *const *ptrs, Ops<V> &obj, long long i,
                    const Dims &d) {
  int k = 0;
  RAFT_OPS_FIELDS(RAFT_IO)
}

#undef RAFT_IO

RAFT_HD int imin(int a, int b) { return a < b ? a : b; }
RAFT_HD int imax(int a, int b) { return a < b ? b : a; }
RAFT_HD int clampi(int x, int lo, int hi) { return imin(imax(x, lo), hi); }
// Python's floor modulo (torch.remainder) for a positive modulus
RAFT_HD int fmod_pos(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

template <int V>
RAFT_HD void clear_fab(Fab<V> &f, const Dims &d) {
  for (int j = 0; j < V; ++j) {
    f.rep_kind[j] = MSG_NONE;
    f.rep_term[j] = f.rep_index[j] = f.rep_log_term[j] = f.rep_commit[j] = 0;
    f.rep_reject[j] = false;
    f.rep_reject_hint[j] = f.rep_n_ents[j] = 0;
    for (int k = 0; k < d.e; ++k)
      f.rep_ent_term[j][k] = f.rep_ent_type[j][k] = f.rep_ent_bytes[j][k] = 0;
    f.rep_snap_index[j] = f.rep_snap_term[j] = 0;
    f.hb_kind[j] = MSG_NONE;
    f.hb_term[j] = f.hb_commit[j] = f.hb_context[j] = 0;
    f.vote_kind[j] = MSG_NONE;
    f.vote_term[j] = f.vote_index[j] = f.vote_log_term[j] = 0;
    f.vote_reject[j] = false;
    f.vote_context[j] = 0;
    f.vresp_kind[j] = MSG_NONE;
    f.vresp_term[j] = 0;
    f.vresp_reject[j] = false;
  }
  f.self_kind = MSG_NONE;
  f.self_term = f.self_index = 0;
}

template <int V>
RAFT_HD void clear_ops(Ops<V> &o) {
  o.hup = o.forget = o.beat = false;
  o.prop_n = o.prop_bytes = o.transfer_to = o.read_ctx = o.prop_cc = 0;
}

}  // namespace raft

namespace raft {

// The winning inbox cell of a channel as the [N] message view the step
// handlers read (fused.py _select_row / _msg_view), with the fields they
// use; absent fields are 0.
struct Msg {
  int type, frm, log_term, index, commit, context, n_ents;
  int ent_term[kMaxE], ent_type[kMaxE], ent_bytes[kMaxE];
  int snap_index, snap_term;
};

RAFT_HD void clear_msg(Msg &m) {
  m.type = m.frm = m.log_term = m.index = m.commit = 0;
  m.context = m.n_ents = 0;
  for (int k = 0; k < kMaxE; ++k) m.ent_term[k] = m.ent_type[k] = m.ent_bytes[k] = 0;
  m.snap_index = m.snap_term = 0;
}

// state.py draw_timeout / rng_next, in native uint32
RAFT_HD int draw_timeout(uint32_t rng, int election_tick) {
  return election_tick + (int)((rng >> 16) % (uint32_t)election_tick);
}
RAFT_HD uint32_t rng_next(uint32_t rng) { return rng * 1664525u + 1013904223u; }

// One lane's round. Member functions mirror the Python functions of the
// same name; every masked tensor update becomes `if (mask)` on this lane.
template <int V>
struct Round {
  Lane<V> &L;
  const Cfg<V> &c;
  const Fab<V> &in;
  Fab<V> &out;
  const Dims &d;
  int ss;          // self slot (step.self_slot), -1 when untracked
  bool is_self[V];
  bool send_sel[V], send_sie[V];

  RAFT_HD Round(Lane<V> &l, const Cfg<V> &cf, const Fab<V> &inb, Fab<V> &o,
                const Dims &dims)
      : L(l), c(cf), in(inb), out(o), d(dims) {
    // step.find_slot(state, state.id): the first hot slot
    ss = -1;
    for (int j = V - 1; j >= 0; --j)
      if (L.prs_id[j] == L.id && L.prs_id[j] != 0) ss = j;
    for (int j = 0; j < V; ++j) {
      is_self[j] = j == ss;
      send_sel[j] = send_sie[j] = false;
    }
  }

  RAFT_HD bool voter(int j) const { return L.voters_in[j] || L.voters_out[j]; }
  RAFT_HD void err(bool cond, int bit) {
    if (cond) L.error_bits |= bit;
  }

  // ---- ops/log.py ----------------------------------------------------

  RAFT_HD int slot_of(int idx) const { return idx & (d.w - 1); }

  RAFT_HD int window_index(int s) const {
    const int first = L.snap_index + 1;
    return first + ((s - first) & (d.w - 1));
  }

  RAFT_HD int term_at(int idx) const {
    const int raw = L.log_term[slot_of(idx)];
    int t = (idx > L.snap_index && idx <= L.last) ? raw : 0;
    if (idx == L.snap_index) t = L.snap_term;
    if (L.pending_snap_index > 0 && idx == L.pending_snap_index)
      t = L.pending_snap_term;
    return t;
  }

  RAFT_HD int last_term() const { return term_at(L.last); }

  RAFT_HD void commit_to(int tocommit) {
    const bool bad = tocommit > L.last;
    err(tocommit > L.committed && bad, ERR_COMMIT_OUT_OF_RANGE);
    L.committed = imax(L.committed, imin(tocommit, L.last));
  }

  RAFT_HD bool maybe_commit(int max_index, int term) {
    const bool ok =
        max_index > L.committed && term != 0 && term_at(max_index) == term;
    commit_to(ok ? max_index : 0);
    return ok;
  }

  RAFT_HD void applied_to(int idx) {
    const bool bad = L.committed < idx || idx < L.applied;
    idx = imin(imax(idx, L.applied), L.committed);
    err(bad, ERR_APPLIED_OUT_OF_RANGE);
    L.applied = idx;
    L.applying = imax(L.applying, idx);
  }

  RAFT_HD void append(int prev, const int *et, const int *ety, const int *eb,
                      int n) {
    const bool act = n > 0;
    err(act && prev < L.committed, ERR_APPEND_BELOW_COMMIT);
    const bool overflow = act && prev + n - L.snap_index > d.w;
    err(overflow, ERR_WINDOW_OVERFLOW);
    const bool ok = act && prev >= L.committed && !overflow;
    if (ok) {
      const int slot0 = slot_of(prev + 1);
      for (int k = 0; k < d.e; ++k) {
        if (k < n) {
          const int s = (slot0 + k) % d.w;
          L.log_term[s] = et[k];
          L.log_type[s] = ety[k];
          L.log_bytes[s] = eb[k];
        }
      }
    }
    const int new_last = ok ? prev + n : L.last;
    err(ok && new_last >= INDEX_OVERFLOW_MARGIN, ERR_INDEX_NEAR_OVERFLOW);
    L.last = new_last;
    if (ok) L.stabled = imin(L.stabled, prev);
    L.applying = imin(L.applying, new_last);
  }

  RAFT_HD int find_conflict(int prev, const int *et, int n) const {
    int ci = BIG;
    for (int k = 0; k < d.e; ++k) {
      const int idx = prev + 1 + k;
      if (k < n && term_at(idx) != et[k]) ci = imin(ci, idx);
    }
    return ci == BIG ? 0 : ci;
  }

  // returns lastnewi (0 when not ok)
  RAFT_HD int maybe_append(int index, int log_term, int committed,
                           const int *et, const int *ety, const int *eb,
                           int n, bool &ok) {
    ok = term_at(index) == log_term;
    const int lastnewi = index + n;
    const int ci = find_conflict(index, et, n);
    err(ok && ci != 0 && ci <= L.committed, ERR_CONFLICT_BELOW_COMMIT);
    const int shift = ci > 0 ? ci - index - 1 : 0;
    int st[kMaxE], sty[kMaxE], sb[kMaxE];
    const int s0 = fmod_pos(shift, d.e);
    for (int k = 0; k < d.e; ++k) {
      const int src = (s0 + k) % d.e;
      st[k] = et[src];
      sty[k] = ety[src];
      sb[k] = eb[src];
    }
    const int n_keep = (ok && ci > 0) ? n - shift : 0;
    append(ci > 0 ? ci - 1 : 0, st, sty, sb, n_keep);
    commit_to(ok ? imin(committed, lastnewi) : 0);
    return ok ? lastnewi : 0;
  }

  // the rollback index of find_conflict_by_term / fused._fcbt_nv
  RAFT_HD int conflict_index(int index, int term) const {
    int best = -1;
    for (int s = 0; s < d.w; ++s) {
      const int idx = window_index(s);
      if (idx <= L.last && idx <= index && L.log_term[s] <= term)
        best = imax(best, idx);
    }
    const bool snap_ok = L.snap_index <= index && L.snap_term <= term;
    best = imax(best, snap_ok ? L.snap_index : -1);
    if (index > L.last) best = index;
    const int below = imin(index, L.snap_index - 1);
    if (best < 0) best = imax(below, 0);
    return imax(best, 0);
  }

  RAFT_HD void find_conflict_by_term(int index, int term, int &hi,
                                     int &ht) const {
    hi = conflict_index(index, term);
    ht = index > L.last ? 0 : term_at(hi);
  }

  RAFT_HD void compact(int to_index, int to_term) {
    if (to_index > L.snap_index && to_index <= L.applied) {
      L.snap_index = to_index;
      L.snap_term = to_term;
    }
  }

  RAFT_HD void restore_snapshot(int idx, int term, bool mask) {
    if (!mask) return;
    for (int s = 0; s < d.w; ++s) L.log_term[s] = L.log_type[s] = L.log_bytes[s] = 0;
    L.last = L.stabled = L.committed = L.snap_index = idx;
    L.snap_term = term;
    L.pending_snap_index = idx;
    L.pending_snap_term = term;
    L.applying = imin(L.applying, idx);
    L.applied = imin(L.applied, idx);
  }

  RAFT_HD int bytes_between(int lo, int hi) const {
    int sum = 0;
    for (int s = 0; s < d.w; ++s) {
      const int idx = window_index(s);
      if (idx <= L.last && idx > lo && idx <= hi) sum += L.log_bytes[s];
    }
    return sum;
  }

  RAFT_HD bool has_unapplied_conf_changes() const {
    bool any = false;
    for (int s = 0; s < d.w; ++s) {
      const int idx = window_index(s);
      if (idx <= L.last && idx > L.applied && idx <= L.committed &&
          L.log_type[s] != 0)
        any = true;
    }
    return any;
  }

  // ---- ops/progress.py (one peer cell j) -----------------------------

  RAFT_HD void reset_state(int j, int to_state) {
    L.pr_state[j] = to_state;
    L.pr_msg_app_flow_paused[j] = false;
    L.pr_pending_snapshot[j] = 0;
    L.infl_start[j] = 0;
    L.infl_count[j] = 0;
    L.infl_total_bytes[j] = 0;
  }

  RAFT_HD void become_probe(int j, bool sel) {
    if (!sel) return;
    const int next = L.pr_state[j] == SNAPSHOT
                         ? imax(L.pr_match[j] + 1, L.pr_pending_snapshot[j] + 1)
                         : L.pr_match[j] + 1;
    reset_state(j, PROBE);
    L.pr_next[j] = next;
  }

  RAFT_HD void become_replicate(int j, bool sel) {
    if (!sel) return;
    reset_state(j, REPLICATE);
    L.pr_next[j] = L.pr_match[j] + 1;
  }

  RAFT_HD void become_snapshot(int j, bool sel, int snapshot_index) {
    if (!sel) return;
    reset_state(j, SNAPSHOT);
    L.pr_pending_snapshot[j] = snapshot_index;
  }

  RAFT_HD bool inflights_full(int j) const {
    const int cap = imin(c.max_inflight, d.f);
    const bool cap_hit = L.infl_count[j] >= cap;
    const int max_bytes = c.max_inflight_bytes;
    const bool bytes_hit = max_bytes != 0 && L.infl_total_bytes[j] >= max_bytes;
    return cap_hit || bytes_hit;
  }

  RAFT_HD void inflights_add(int j, bool sel, int index, int bytes) {
    sel = sel && !inflights_full(j);
    if (!sel) return;
    const int pos = fmod_pos(L.infl_start[j] + L.infl_count[j], d.f);
    L.infl_index[j][pos] = index;
    L.infl_bytes[j][pos] = bytes;
    L.infl_count[j] += 1;
    L.infl_total_bytes[j] += bytes;
  }

  RAFT_HD void inflights_free_le(int j, bool sel, int to) {
    int n_free = 0, b_free = 0;
    for (int k = 0; k < d.f; ++k) {
      const bool live = k < L.infl_count[j];
      const int pos = fmod_pos(L.infl_start[j] + k, d.f);
      if (live && L.infl_index[j][pos] <= to) {
        n_free += 1;
        b_free += L.infl_bytes[j][pos];
      }
    }
    if (!sel) return;
    const int new_count = L.infl_count[j] - n_free;
    L.infl_start[j] = new_count == 0 ? 0 : fmod_pos(L.infl_start[j] + n_free, d.f);
    L.infl_count[j] = new_count;
    L.infl_total_bytes[j] -= b_free;
  }

  RAFT_HD void update_on_entries_send(int j, bool sel, int n, int bytes) {
    const bool repl = sel && L.pr_state[j] == REPLICATE;
    const bool probe = sel && L.pr_state[j] == PROBE;
    const bool sending = n > 0;
    const int last = L.pr_next[j] + n - 1;
    inflights_add(j, repl && sending, last, bytes);
    if (repl && sending) L.pr_next[j] = last + 1;
    if (repl)
      L.pr_msg_app_flow_paused[j] = inflights_full(j);
    else if (probe && sending)
      L.pr_msg_app_flow_paused[j] = true;
  }

  RAFT_HD bool maybe_update(int j, bool sel, int n) {
    const bool updated = sel && L.pr_match[j] < n;
    if (updated) {
      L.pr_match[j] = n;
      L.pr_msg_app_flow_paused[j] = false;
    }
    if (sel) L.pr_next[j] = imax(L.pr_next[j], n + 1);
    return updated;
  }

  RAFT_HD bool maybe_decr_to(int j, bool sel, int rejected, int match_hint) {
    const bool repl = L.pr_state[j] == REPLICATE;
    const bool repl_ok = sel && repl && rejected > L.pr_match[j];
    const bool probe_ok = sel && !repl && L.pr_next[j] - 1 == rejected;
    const int new_next = repl_ok ? L.pr_match[j] + 1
                                 : imax(imin(rejected, match_hint + 1), 1);
    const bool changed = repl_ok || probe_ok;
    if (changed) L.pr_next[j] = new_next;
    if (probe_ok) L.pr_msg_app_flow_paused[j] = false;
    return changed;
  }

  RAFT_HD bool is_paused(int j) const {
    return L.pr_state[j] == SNAPSHOT ? true : L.pr_msg_app_flow_paused[j];
  }

  // ---- ops/quorum.py ---------------------------------------------------

  static RAFT_HD int majority_vote(const int (&votes)[V], const bool (&mask)[V]) {
    int n = 0, granted = 0, missing = 0;
    for (int j = 0; j < V; ++j) {
      n += mask[j];
      granted += mask[j] && votes[j] == GRANTED;
      missing += mask[j] && votes[j] == PENDING;
    }
    const int q = n / 2 + 1;
    const int res = granted >= q ? VOTE_WON
                                 : (granted + missing >= q ? VOTE_PENDING : VOTE_LOST);
    return n == 0 ? VOTE_WON : res;
  }

  RAFT_HD int joint_vote(const int (&votes)[V]) const {
    const int r1 = majority_vote(votes, L.voters_in);
    const int r2 = majority_vote(votes, L.voters_out);
    const bool any_lost = r1 == VOTE_LOST || r2 == VOTE_LOST;
    return any_lost ? VOTE_LOST : imax(r1, r2);
  }

  RAFT_HD void want_send(int j, bool cell, bool sie) {
    send_sel[j] = send_sel[j] || cell;
    send_sie[j] = send_sie[j] || (cell && sie);
  }

  // ---- ops/step.py ---------------------------------------------------

  RAFT_HD bool promotable() const {
    const bool is_lr = L.learners[ss < 0 ? 0 : ss];
    return ss >= 0 && !is_lr && L.pending_snap_index == 0;
  }

  RAFT_HD void reset(bool mask, int term) {
    if (!mask) return;
    const bool term_changed = L.term != term;
    L.rng = rng_next(L.rng);
    const int rand_to = draw_timeout(L.rng, c.election_tick);
    L.term = term;
    if (term_changed) L.vote = 0;
    L.lead = 0;
    L.election_elapsed = 0;
    L.heartbeat_elapsed = 0;
    L.randomized_election_timeout = rand_to;
    L.lead_transferee = 0;
    for (int j = 0; j < V; ++j) L.votes[j] = PENDING;
    L.pending_conf_index = 0;
    L.uncommitted_size = 0;
    for (int q = 0; q < d.r; ++q) {
      L.ro_ctx[q] = L.ro_from[q] = L.ro_index[q] = L.ro_seq[q] = 0;
      for (int j = 0; j < V; ++j) L.ro_acks[q][j] = false;
    }
    L.ro_next_seq = 1;
    for (int j = 0; j < V; ++j) {
      if (L.prs_id[j] == 0) continue;
      reset_state(j, PROBE);
      L.pr_match[j] = is_self[j] ? L.last : 0;
      L.pr_next[j] = L.last + 1;
      L.pr_recent_active[j] = false;
    }
  }

  RAFT_HD void become_follower(bool mask, int term, int lead) {
    reset(mask, term);
    if (mask) {
      L.lead = lead;
      L.state = FOLLOWER;
    }
  }

  RAFT_HD void become_candidate(bool mask) {
    reset(mask, L.term + (mask ? 1 : 0));
    if (mask) {
      L.vote = L.id;
      L.state = CANDIDATE;
    }
  }

  RAFT_HD void become_pre_candidate(bool mask) {
    if (!mask) return;
    for (int j = 0; j < V; ++j) L.votes[j] = PENDING;
    L.lead = 0;
    L.state = PRE_CANDIDATE;
  }

  RAFT_HD void put_self(bool mask, int type, int term, int index) {
    if (!mask) return;
    out.self_kind = type;
    out.self_term = term;
    out.self_index = index;
  }

  // leader local append + self-ack; entry terms are the lane's term
  RAFT_HD bool append_entry(bool mask, const int *ety, const int *eb, int n) {
    int sz = 0;
    for (int k = 0; k < d.e; ++k) sz += eb[k];
    const bool refuse = L.uncommitted_size > 0 && sz > 0 &&
                        L.uncommitted_size + sz > c.max_uncommitted_size;
    const bool ok = mask && !refuse && L.last + n - L.snap_index <= d.w;
    if (ok) L.uncommitted_size += sz;
    int stamped[kMaxE];
    for (int k = 0; k < kMaxE; ++k) stamped[k] = L.term;
    append(L.last, stamped, ety, eb, ok ? n : 0);
    put_self(ok, MSG_APP_RESP, L.term, L.last);
    return ok;
  }

  RAFT_HD void become_leader(bool mask) {
    reset(mask, L.term);
    if (mask) {
      L.lead = L.id;
      L.state = LEADER;
      L.pending_conf_index = L.last;
    }
    for (int j = 0; j < V; ++j) {
      const bool sel_self = mask && is_self[j];
      become_replicate(j, sel_self);
      if (sel_self) L.pr_recent_active[j] = true;
    }
    int zeros[kMaxE] = {0};
    append_entry(mask, zeros, zeros, mask ? 1 : 0);
  }

  RAFT_HD void maybe_send_append() {
    const bool has_avail = L.avail_snap_index != 0;
    const int send_si = has_avail ? L.avail_snap_index : L.snap_index;
    const int send_st = has_avail ? L.avail_snap_term : L.snap_term;
    for (int j = 0; j < V; ++j) {
      bool sel = send_sel[j] && L.prs_id[j] != 0 && !is_self[j] && !is_paused(j);
      const int prev = L.pr_next[j] - 1;
      const int prev_term = term_at(prev);
      const bool throttled = L.pr_state[j] == REPLICATE && inflights_full(j);
      const int n_avail = imax(L.last - prev, 0);
      int n_send = throttled ? 0 : imin(n_avail, d.e);
      const int slot0 = L.pr_next[j] & (d.w - 1);
      int et[kMaxE], ety[kMaxE], eb[kMaxE];
      int cum = 0, n_fit = 0;
      for (int k = 0; k < d.e; ++k) {
        const int s = (slot0 + k) % d.w;
        et[k] = L.log_term[s];
        ety[k] = L.log_type[s];
        eb[k] = k < n_send ? L.log_bytes[s] : 0;
        cum += eb[k];
        n_fit += cum <= c.max_size_per_msg;
      }
      n_send = n_send > 0 ? clampi(imin(n_send, n_fit), 1, d.e) : 0;
      int sent_bytes = 0;
      for (int k = 0; k < d.e; ++k) {
        if (k >= n_send) et[k] = ety[k] = eb[k] = 0;
        sent_bytes += eb[k];
      }
      sel = sel && (n_send > 0 || send_sie[j]);
      const bool need_snap = prev < L.snap_index;
      const bool snap_sel =
          sel && need_snap && L.pr_recent_active[j] && !L.snap_unavailable;
      const bool app_sel = sel && !need_snap;
      become_snapshot(j, snap_sel, send_si);
      if (snap_sel) {
        out.rep_kind[j] = MSG_SNAP;
        out.rep_term[j] = L.term;
        out.rep_snap_index[j] = send_si;
        out.rep_snap_term[j] = send_st;
      }
      if (app_sel) {
        out.rep_kind[j] = MSG_APP;
        out.rep_term[j] = L.term;
        out.rep_index[j] = prev;
        out.rep_log_term[j] = prev_term;
        out.rep_commit[j] = L.committed;
        out.rep_n_ents[j] = n_send;
        for (int k = 0; k < d.e; ++k) {
          out.rep_ent_term[j][k] = et[k];
          out.rep_ent_type[j][k] = ety[k];
          out.rep_ent_bytes[j][k] = eb[k];
        }
      }
      update_on_entries_send(j, app_sel, n_send, sent_bytes);
    }
  }

  RAFT_HD void bcast_heartbeat(bool mask, int ctx) {
    for (int j = 0; j < V; ++j) {
      if (!(mask && L.prs_id[j] != 0 && !is_self[j])) continue;
      out.hb_kind[j] = MSG_HEARTBEAT;
      out.hb_term[j] = L.term;
      out.hb_commit[j] = imin(L.pr_match[j], L.committed);
      out.hb_context[j] = ctx;
    }
  }

  RAFT_HD void campaign(bool mask, int ctype) {
    const bool pre = mask && ctype == PRE_ELECTION;
    const bool real = mask && ctype != PRE_ELECTION;
    become_pre_candidate(pre);
    become_candidate(real);
    const int ask_term = pre ? L.term + 1 : L.term;
    const int vote_t = pre ? MSG_PRE_VOTE : MSG_VOTE;
    const int resp_t = pre ? MSG_PRE_VOTE_RESP : MSG_VOTE_RESP;
    bool self_voter = false;
    for (int j = 0; j < V; ++j) self_voter = self_voter || (voter(j) && is_self[j]);
    put_self(mask && self_voter, resp_t, ask_term, 0);
    const int lt = last_term();
    for (int j = 0; j < V; ++j) {
      if (!(mask && voter(j) && !is_self[j])) continue;
      out.vote_kind[j] = vote_t;
      out.vote_term[j] = ask_term;
      out.vote_index[j] = L.last;
      out.vote_log_term[j] = lt;
      out.vote_context[j] = ctype == TRANSFER ? TRANSFER : 0;
    }
  }

  RAFT_HD bool hup(bool mask, int ctype) {
    const bool ok = mask && L.state != LEADER && promotable() &&
                    !has_unapplied_conf_changes();
    campaign(ok, ctype);
    return ok;
  }

  // put_reply of a MsgAppResp to raft id `to` (slot to-1)
  RAFT_HD void reply_app_resp(bool mask, int to, int term, int index) {
    if (!(mask && to >= 1 && to <= V)) return;
    const int j = to - 1;
    out.rep_kind[j] = MSG_APP_RESP;
    out.rep_term[j] = term;
    out.rep_index[j] = index;
  }

  RAFT_HD void handle_append_entries(bool mask, const Msg &m) {
    const bool stale = mask && m.index < L.committed;
    reply_app_resp(stale, m.frm, L.term, L.committed);
    const bool live = mask && !stale;
    bool ok;
    const int lastnewi =
        maybe_append(live ? m.index : -1, m.log_term, m.commit, m.ent_term,
                     m.ent_type, m.ent_bytes, live ? m.n_ents : 0, ok);
    reply_app_resp(live && ok, m.frm, L.term, lastnewi);
    int hi, ht;
    find_conflict_by_term(imin(m.index, L.last), m.log_term, hi, ht);
    if (live && !ok && m.frm >= 1 && m.frm <= V) {
      const int j = m.frm - 1;
      out.rep_kind[j] = MSG_APP_RESP;
      out.rep_term[j] = L.term;
      out.rep_index[j] = m.index;
      out.rep_reject[j] = true;
      out.rep_reject_hint[j] = hi;
      out.rep_log_term[j] = ht;
    }
  }

  RAFT_HD void handle_heartbeat(bool mask, const Msg &m) {
    commit_to(mask ? m.commit : 0);
    if (mask && m.frm >= 1 && m.frm <= V) {
      const int j = m.frm - 1;
      out.hb_kind[j] = MSG_HEARTBEAT_RESP;
      out.hb_term[j] = L.term;
      out.hb_context[j] = m.context;
    }
  }

  RAFT_HD void handle_snapshot(bool mask, const Msg &m) {
    const int sidx = m.snap_index, sterm = m.snap_term;
    const bool stale = mask && sidx <= L.committed;
    const bool ff = mask && !stale && term_at(sidx) == sterm;
    commit_to(ff ? sidx : 0);
    reply_app_resp(stale || ff, m.frm, L.term, L.committed);
    const bool doit = mask && !stale && !ff && L.state == FOLLOWER;
    restore_snapshot(sidx, sterm, doit);
    reply_app_resp(doit, m.frm, L.term, L.last);
  }
};

// ---- ops/fused.py fused_round, for one lane ----------------------------

struct Events {
  int v[kPartUsed];
};

struct Sampler {  // metrics/device.py samp_index / samp_round of this lane
  int index, round;
};

// One round of lane `L` on its routed inbox `in` (mute cut applied) into
// the cleared outbox `out`. round_ctr is the metrics round counter before
// this round; ev gets this lane's metric deltas.
template <int V>
RAFT_HD void fused_round_lane(Lane<V> &L, const Cfg<V> &c, const Fab<V> &in,
                              const Ops<V> &ops, bool mute_self,
                              const bool (&peer_mute)[V], int flags, int lag,
                              int round_ctr, Sampler &samp, Fab<V> &out,
                              Events &ev, const Dims &d) {
  Round<V> R(L, c, in, out, d);
  const bool *is_self = R.is_self;
  const bool metrics = flags & F_METRICS;
  for (int x = 0; x < kPartUsed; ++x) ev.v[x] = 0;
  const int lead0 = L.lead, committed0 = L.committed;

  // ---- tick (raft.go:823-862) ----
  bool fire_hup = false, fire_beat = false, fire_cq = false;
  if (flags & F_TICK) {
    const bool is_leader0 = L.state == LEADER;
    int ee = L.election_elapsed + 1;
    int he = is_leader0 ? L.heartbeat_elapsed + 1 : L.heartbeat_elapsed;
    fire_hup = !is_leader0 && R.promotable() && ee >= L.randomized_election_timeout;
    const bool lead_etick = is_leader0 && ee >= c.election_tick;
    fire_cq = lead_etick && c.check_quorum;
    if (fire_hup || lead_etick) ee = 0;
    fire_beat = is_leader0 && he >= c.heartbeat_tick;
    if (fire_beat) he = 0;
    L.election_elapsed = ee;
    L.heartbeat_elapsed = he;
    if (lead_etick) L.lead_transferee = 0;
  }

  // ---- presence ----
  bool rep_p[V], hb_p[V], vote_p[V], vresp_p[V];
  for (int i = 0; i < V; ++i) {
    rep_p[i] = in.rep_kind[i] != MSG_NONE;
    hb_p[i] = in.hb_kind[i] != MSG_NONE;
    vote_p[i] = in.vote_kind[i] != MSG_NONE;
    vresp_p[i] = in.vresp_kind[i] != MSG_NONE;
  }
  const bool self_p = in.self_kind != MSG_NONE;

  // ---- term ladder (raft.go:1053-1139) ----
  const bool in_lease =
      c.check_quorum && L.lead != 0 && L.election_elapsed < c.election_tick;
  bool is_vreq[V], lease_ignored[V];
  int t_new = 0;
  for (int i = 0; i < V; ++i) {
    const bool keep_vote = in.vote_kind[i] == MSG_PRE_VOTE;
    const bool keep_vresp = in.vresp_kind[i] == MSG_PRE_VOTE_RESP && !in.vresp_reject[i];
    const bool force = in.vote_context[i] == TRANSFER;
    is_vreq[i] = in.vote_kind[i] == MSG_VOTE || in.vote_kind[i] == MSG_PRE_VOTE;
    lease_ignored[i] = vote_p[i] && is_vreq[i] && in.vote_term[i] > L.term &&
                       !force && in_lease;
    t_new = imax(t_new, rep_p[i] ? in.rep_term[i] : 0);
    t_new = imax(t_new, hb_p[i] ? in.hb_term[i] : 0);
    t_new = imax(t_new, (vote_p[i] && !keep_vote && !lease_ignored[i]) ? in.vote_term[i] : 0);
    t_new = imax(t_new, (vresp_p[i] && !keep_vresp) ? in.vresp_term[i] : 0);
  }
  t_new = imax(t_new, (self_p && in.self_kind == MSG_APP_RESP) ? in.self_term : 0);
  const bool step_down = t_new > L.term;
  int ldr_member = 0;
  for (int i = 0; i < V; ++i) {
    const bool from_rep = rep_p[i] && in.rep_term[i] == t_new &&
                          (in.rep_kind[i] == MSG_APP || in.rep_kind[i] == MSG_SNAP);
    const bool from_hb = hb_p[i] && in.hb_term[i] == t_new && in.hb_kind[i] == MSG_HEARTBEAT;
    ldr_member = imax(ldr_member, (from_rep || from_hb) ? i + 1 : 0);
  }
  R.become_follower(step_down, t_new, ldr_member);

  // lower-term handling (raft.go:1087-1139)
  bool rep_live[V], hb_live[V], vote_live[V];
  for (int i = 0; i < V; ++i) {
    const bool low_rep = rep_p[i] && in.rep_term[i] < L.term;
    const bool low_hb = hb_p[i] && in.hb_term[i] < L.term;
    const bool low_vote = vote_p[i] && in.vote_term[i] < L.term;
    const bool ping = (c.check_quorum || c.pre_vote) &&
                      ((low_rep && in.rep_kind[i] == MSG_APP) ||
                       (low_hb && in.hb_kind[i] == MSG_HEARTBEAT));
    if (ping) {
      out.rep_kind[i] = MSG_APP_RESP;
      out.rep_term[i] = L.term;
    }
    if (low_vote && in.vote_kind[i] == MSG_PRE_VOTE) {
      out.vresp_kind[i] = MSG_PRE_VOTE_RESP;
      out.vresp_term[i] = L.term;
      out.vresp_reject[i] = true;
    }
    rep_live[i] = rep_p[i] && !low_rep;
    hb_live[i] = hb_p[i] && !low_hb;
    vote_live[i] = vote_p[i] && !low_vote && !lease_ignored[i];
  }

  // ---- winning append-family message (raft.go:1732-1795) ----
  bool any_app = false;
  int win = 0;
  for (int i = V - 1; i >= 0; --i) {
    const bool cell = rep_live[i] &&
                      (in.rep_kind[i] == MSG_APP || in.rep_kind[i] == MSG_SNAP) &&
                      in.rep_term[i] == L.term;
    if (cell) {
      any_app = true;
      win = i;
    }
  }
  Msg m;
  clear_msg(m);
  if (any_app) {
    m.type = in.rep_kind[win];
    m.index = in.rep_index[win];
    m.log_term = in.rep_log_term[win];
    m.commit = in.rep_commit[win];
    m.n_ents = in.rep_n_ents[win];
    for (int k = 0; k < d.e; ++k) {
      m.ent_term[k] = in.rep_ent_term[win][k];
      m.ent_type[k] = in.rep_ent_type[win][k];
      m.ent_bytes[k] = in.rep_ent_bytes[win][k];
    }
    m.snap_index = in.rep_snap_index[win];
    m.snap_term = in.rep_snap_term[win];
  }
  const int m_frm = any_app ? win + 1 : 0;
  m.frm = m_frm;
  const bool is_cand = L.state == CANDIDATE || L.state == PRE_CANDIDATE;
  R.become_follower(any_app && is_cand, L.term, m_frm);
  if (any_app && L.state == FOLLOWER) {
    L.lead = m_frm;
    L.election_elapsed = 0;
  }
  R.handle_append_entries(any_app && m.type == MSG_APP && L.state == FOLLOWER, m);
  const bool is_snap = any_app && m.type == MSG_SNAP;
  R.handle_snapshot(is_snap, m);
  if (is_snap && L.pending_snap_index != 0) {
    L.applied = imax(L.applied, L.pending_snap_index);
    L.applying = imax(L.applying, L.pending_snap_index);
    L.pending_snap_index = 0;
    L.pending_snap_term = 0;
  }

  // ---- winning heartbeat (raft.go:1772-1775) ----
  bool any_hb = false;
  int hwin = 0;
  for (int i = V - 1; i >= 0; --i) {
    if (hb_live[i] && in.hb_kind[i] == MSG_HEARTBEAT && in.hb_term[i] == L.term) {
      any_hb = true;
      hwin = i;
    }
  }
  Msg h;
  clear_msg(h);
  if (any_hb) {
    h.type = in.hb_kind[hwin];
    h.commit = in.hb_commit[hwin];
    h.context = in.hb_context[hwin];
  }
  const int h_frm = any_hb ? hwin + 1 : 0;
  h.frm = h_frm;
  R.become_follower(any_hb && is_cand, L.term, h_frm);
  if (any_hb && L.state == FOLLOWER) {
    L.lead = h_frm;
    L.election_elapsed = 0;
  }
  R.handle_heartbeat(any_hb && L.state == FOLLOWER, h);

  // ---- vote casting: grant at most one candidate (raft.go:1164-1212) ----
  {
    const int lt = R.last_term();
    bool grantable[V], is_pv[V], vreq_cell[V];
    bool any_real = false;
    int gwin = 0;
    for (int i = V - 1; i >= 0; --i) {
      vreq_cell[i] = vote_live[i] && is_vreq[i];
      is_pv[i] = in.vote_kind[i] == MSG_PRE_VOTE;
      const bool pv_ahead = is_pv[i] && in.vote_term[i] > L.term;
      const bool cur = vreq_cell[i] &&
                       ((in.vote_kind[i] == MSG_VOTE && in.vote_term[i] == L.term) || pv_ahead);
      const bool can_vote =
          L.vote == i + 1 || (L.vote == 0 && L.lead == 0) || pv_ahead;
      const bool up2d = in.vote_log_term[i] > lt ||
                        (in.vote_log_term[i] == lt && in.vote_index[i] >= L.last);
      grantable[i] = cur && can_vote && up2d;
      if (grantable[i] && !is_pv[i]) {
        any_real = true;
        gwin = i;
      }
    }
    bool real_grant = false;
    for (int i = 0; i < V; ++i) {
      const bool real_cell = grantable[i] && !is_pv[i] && i == gwin && any_real;
      const bool grant = (grantable[i] && is_pv[i]) || real_cell;
      real_grant = real_grant || real_cell;
      const int resp_kind = is_pv[i] ? MSG_PRE_VOTE_RESP : MSG_VOTE_RESP;
      if (grant) {
        out.vresp_kind[i] = resp_kind;
        out.vresp_term[i] = in.vote_term[i];
      }
      if (vreq_cell[i] && !grant) {
        out.vresp_kind[i] = resp_kind;
        out.vresp_term[i] = L.term;
        out.vresp_reject[i] = true;
      }
    }
    if (real_grant) {
      L.vote = gwin + 1;
      L.election_elapsed = 0;
    }
  }

  // ---- TimeoutNow -> transfer campaign (raft.go:1713-1719) ----
  bool ton = false;
  for (int i = 0; i < V; ++i)
    ton = ton || (vote_live[i] && in.vote_kind[i] == MSG_TIMEOUT_NOW &&
                  in.vote_term[i] == L.term);
  ton = ton && L.state == FOLLOWER;

  // ---- leader fan-in ----
  bool is_leader = L.state == LEADER;
  for (int j = 0; j < V; ++j) {
    const bool in_snap = is_leader && L.pr_state[j] == SNAPSHOT;
    if ((flags & F_MUTE) && in_snap && (mute_self || peer_mute[j]))
      L.pr_pending_snapshot[j] = 0;
    R.become_probe(j, in_snap);
    if (in_snap) L.pr_msg_app_flow_paused[j] = true;
  }

  // MsgAppResp cells, including the self-ack (raft.go:1333-1526)
  const bool self_ar = self_p && in.self_kind == MSG_APP_RESP &&
                       in.self_term == L.term && is_leader;
  bool ar_cell[V], acc_cell[V], advanced[V], old_paused[V];
  int ar_index[V];
  bool advanced_lane = false;
  for (int j = 0; j < V; ++j) {
    ar_cell[j] = rep_live[j] && in.rep_kind[j] == MSG_APP_RESP &&
                 in.rep_term[j] == L.term && is_leader;
    const bool self_ar_cell = self_ar && is_self[j];
    const bool ar_all = ar_cell[j] || self_ar_cell;
    ar_index[j] = self_ar_cell ? in.self_index : in.rep_index[j];
    if (ar_all) L.pr_recent_active[j] = true;
    const bool rej_cell = ar_cell[j] && in.rep_reject[j];
    acc_cell[j] = ar_all && !rej_cell;
    const int next_probe = in.rep_log_term[j] > 0
                               ? R.conflict_index(in.rep_reject_hint[j], in.rep_log_term[j])
                               : in.rep_reject_hint[j];
    const bool decreased = R.maybe_decr_to(j, rej_cell, ar_index[j], next_probe);
    R.become_probe(j, decreased && L.pr_state[j] == REPLICATE);
    R.want_send(j, decreased, true);
    old_paused[j] = R.is_paused(j);
    const bool updated = R.maybe_update(j, acc_cell[j], ar_index[j]);
    const bool probe_refresh = acc_cell[j] && L.pr_match[j] == ar_index[j] &&
                               L.pr_state[j] == PROBE;
    advanced[j] = updated || probe_refresh;
    R.become_replicate(j, advanced[j] && L.pr_state[j] == PROBE);
    const bool from_snap = advanced[j] && L.pr_state[j] == SNAPSHOT &&
                           L.pr_match[j] + 1 >= L.snap_index + 1;
    R.become_probe(j, from_snap);
    R.become_replicate(j, from_snap);
    R.inflights_free_le(j, advanced[j] && L.pr_state[j] == REPLICATE, ar_index[j]);
    advanced_lane = advanced_lane || advanced[j];
  }

  // the commit index: one joint-quorum reduction per lane
  {
    int match[V];
    for (int j = 0; j < V; ++j) match[j] = R.voter(j) ? L.pr_match[j] : 0;
    const int mci = joint_committed<V>(match, L.voters_in, L.voters_out);
    const bool committed_adv = R.maybe_commit(advanced_lane ? mci : 0, L.term);
    for (int j = 0; j < V; ++j) {
      R.want_send(j, committed_adv, true);
      R.want_send(j, advanced[j] && !committed_adv && !is_self[j], old_paused[j]);
    }
  }

  // leadership transfer completion (raft.go:1519-1524)
  for (int j = 0; j < V; ++j) {
    if (acc_cell[j] && advanced[j] && j + 1 == L.lead_transferee &&
        L.pr_match[j] == L.last) {
      out.vote_kind[j] = MSG_TIMEOUT_NOW;
      out.vote_term[j] = L.term;
    }
  }

  // MsgHeartbeatResp cells (raft.go:1527-1561)
  bool hr_cell[V];
  for (int j = 0; j < V; ++j) {
    hr_cell[j] = hb_live[j] && in.hb_kind[j] == MSG_HEARTBEAT_RESP &&
                 in.hb_term[j] == L.term && is_leader;
    if (hr_cell[j]) {
      L.pr_recent_active[j] = true;
      L.pr_msg_app_flow_paused[j] = false;
    }
    R.want_send(j, hr_cell[j] && (L.pr_match[j] < L.last || L.pr_state[j] == PROBE), true);
  }

  // ReadIndex acks via heartbeat ctx (raft.go:1548-1561)
  {
    const int r = d.r;
    bool hit_any[kMaxR], release[kMaxR], put[kMaxR];
    bool acks[kMaxR][V];
    int won_seq = -1;
    for (int q = 0; q < r; ++q) {
      hit_any[q] = false;
      int ro_votes[V];
      for (int i = 0; i < V; ++i) {
        const bool hit = hr_cell[i] && L.ro_ctx[q] == in.hb_context[i] && L.ro_ctx[q] != 0;
        hit_any[q] = hit_any[q] || hit;
        acks[q][i] = L.ro_acks[q][i] || hit;
        ro_votes[i] = acks[q][i] ? GRANTED : PENDING;
      }
      const bool won = L.ro_ctx[q] != 0 && R.joint_vote(ro_votes) == VOTE_WON && hit_any[q];
      won_seq = imax(won_seq, won ? L.ro_seq[q] : -1);
    }
    for (int q = 0; q < r; ++q) release[q] = L.ro_ctx[q] != 0 && L.ro_seq[q] <= won_seq;
    int dst_c[kMaxR];
    int n_put = 0;
    for (int q = 0; q < r; ++q) {
      int rank = 0;
      for (int p = 0; p < r; ++p) rank += release[p] && L.ro_seq[p] < L.ro_seq[q];
      const int dst_slot = L.rs_count + rank;
      put[q] = release[q] && dst_slot < r;
      dst_c[q] = clampi(dst_slot, 0, r - 1);
      n_put += put[q];
    }
    // ohm.scatter_set: a target slot takes the sum of the values put there
    int new_ctx[kMaxR], new_index[kMaxR];
    for (int t = 0; t < r; ++t) {
      bool hit = false;
      int vc = 0, vi = 0;
      for (int q = 0; q < r; ++q) {
        if (put[q] && dst_c[q] == t) {
          hit = true;
          vc += L.ro_ctx[q];
          vi += L.ro_index[q];
        }
      }
      new_ctx[t] = hit ? vc : L.rs_ctx[t];
      new_index[t] = hit ? vi : L.rs_index[t];
    }
    for (int t = 0; t < r; ++t) {
      L.rs_ctx[t] = new_ctx[t];
      L.rs_index[t] = new_index[t];
    }
    L.rs_count = imin(L.rs_count + n_put, r);
    for (int q = 0; q < r; ++q) {
      if (put[q]) L.ro_ctx[q] = L.ro_from[q] = L.ro_index[q] = L.ro_seq[q] = 0;
      for (int i = 0; i < V; ++i) L.ro_acks[q][i] = put[q] ? false : acks[q][i];
    }
    ev.v[C_READ_INDEX_SERVED] += n_put;
  }

  // Msg(Pre)VoteResp cells -> poll (raft.go:1041-1049, 1647-1666)
  bool pre_won, real_won;
  {
    const int my_resp = L.state == PRE_CANDIDATE ? MSG_PRE_VOTE_RESP : MSG_VOTE_RESP;
    const bool self_vr = self_p && in.self_kind == my_resp && is_cand;
    bool any_vr = false;
    for (int i = 0; i < V; ++i) {
      const bool live = vresp_p[i] && !(in.vresp_term[i] < L.term);
      const bool vr_cell = live && in.vresp_kind[i] == my_resp && is_cand;
      const bool vr_all = vr_cell || (self_vr && is_self[i]);
      const bool vr_rej = vr_cell && in.vresp_reject[i];
      if (vr_all && R.voter(i)) L.votes[i] = vr_rej ? REJECTED : GRANTED;
      any_vr = any_vr || vr_all;
    }
    int votes[V];
    for (int i = 0; i < V; ++i) votes[i] = L.votes[i];
    const int res = R.joint_vote(votes);
    const bool tallied = any_vr && is_cand;
    const bool won = tallied && res == VOTE_WON;
    const bool lost = tallied && res == VOTE_LOST;
    pre_won = won && L.state == PRE_CANDIDATE;
    real_won = won && L.state == CANDIDATE;
    R.become_leader(real_won);
    for (int j = 0; j < V; ++j) R.want_send(j, real_won, true);
    R.become_follower(lost, L.term, 0);
  }

  // ---- local inputs ----
  int ctype = c.pre_vote ? PRE_ELECTION : ELECTION;
  if (ton) ctype = TRANSFER;
  if (pre_won) ctype = ELECTION;
  const bool hup_fired = R.hup(fire_hup || ops.hup || ton || pre_won, ctype);
  ev.v[C_ELECTIONS_STARTED] += hup_fired;
  ev.v[C_ELECTIONS_WON] += real_won;

  // CheckQuorum (raft.go:1231-1243)
  is_leader = L.state == LEADER;
  {
    const bool cq = fire_cq && is_leader;
    int active[V];
    for (int j = 0; j < V; ++j)
      active[j] = (L.pr_recent_active[j] || is_self[j]) ? GRANTED : REJECTED;
    const bool alive = R.joint_vote(active) == VOTE_WON;
    R.become_follower(cq && !alive, L.term, 0);
    for (int j = 0; j < V; ++j)
      if (cq && !is_self[j]) L.pr_recent_active[j] = false;
  }

  // heartbeats (MsgBeat) carry the newest pending ReadIndex ctx
  is_leader = L.state == LEADER;
  {
    int best = -1, newest = 0;
    bool any_live = false;
    for (int q = 0; q < d.r; ++q) {
      const int key = L.ro_ctx[q] != 0 ? L.ro_seq[q] : -1;
      any_live = any_live || L.ro_ctx[q] != 0;
      if (q == 0 || key > best) {
        best = key;
        newest = q;
      }
    }
    const int beat_ctx = any_live ? L.ro_ctx[newest] : 0;
    R.bcast_heartbeat((fire_beat || ops.beat) && is_leader, beat_ctx);
  }

  // proposals (raft.go:1244-1302)
  {
    const int prop_n = (flags & F_AUTO_PROPOSE) ? imax(ops.prop_n, is_leader ? 1 : 0)
                                                : ops.prop_n;
    const bool prop = prop_n > 0 && is_leader && L.lead_transferee == 0 && R.ss >= 0;
    const int pn = imin(prop_n, d.e);
    int zeros[kMaxE] = {0}, eb[kMaxE];
    for (int k = 0; k < d.e; ++k) eb[k] = (k < pn && prop) ? ops.prop_bytes : 0;
    const bool appended = R.append_entry(prop, zeros, eb, pn);
    for (int j = 0; j < V; ++j) R.want_send(j, appended, true);
    ev.v[C_PROPOSALS] += appended ? pn : 0;
    ev.v[C_PROPOSALS_DROPPED] += prop_n > 0 && !appended;
    if (metrics && appended && samp.index == 0) {  // metrics.arm_sample
      samp.index = L.last;
      samp.round = round_ctr + 1;
    }
  }

  // conf-change proposal (raft.go:1259-1301)
  {
    const bool want_cc = ops.prop_cc > 0 && is_leader && L.lead_transferee == 0 && R.ss >= 0;
    bool joint = false;
    for (int j = 0; j < V; ++j) joint = joint || L.voters_out[j];
    const bool pending_cc = L.pending_conf_index > L.applied;
    const bool refused = pending_cc || (ops.prop_cc == 2 ? !joint : joint);
    const bool cc_ok = want_cc && !refused;
    int zeros[kMaxE] = {0}, cc_type[kMaxE] = {0};
    cc_type[0] = cc_ok ? ENTRY_CONF_CHANGE_V2 : 0;
    const bool cc_appended = R.append_entry(want_cc, cc_type, zeros, 1);
    if (cc_appended && cc_ok) L.pending_conf_index = L.last;
    for (int j = 0; j < V; ++j) R.want_send(j, cc_appended, true);
    ev.v[C_PROPOSALS] += cc_appended;
    ev.v[C_PROPOSALS_DROPPED] += want_cc && (refused || !cc_appended);
  }

  // transfer-leadership request (raft.go:1587-1618)
  {
    const int tt = ops.transfer_to;
    const int t_slot = clampi(tt - 1, 0, V - 1);
    const bool t_ok = is_leader && tt != 0 && tt != L.lead_transferee && tt != L.id &&
                      tt >= 1 && tt <= V && L.prs_id[t_slot] != 0 && !L.learners[t_slot];
    if (t_ok) {
      L.election_elapsed = 0;
      L.lead_transferee = tt;
    }
    for (int j = 0; j < V; ++j) {
      const bool t_cell = j == t_slot && t_ok;
      const bool t_ready = t_cell && L.pr_match[j] == L.last;
      if (t_ready) {
        out.vote_kind[j] = MSG_TIMEOUT_NOW;
        out.vote_term[j] = L.term;
      }
      R.want_send(j, t_cell && !t_ready, true);
    }
  }

  // ReadIndex at the leader (raft.go:1303-1332)
  {
    const int r = d.r;
    const bool ri = ops.read_ctx != 0 && is_leader;
    const bool ri_ok = ri && R.term_at(L.committed) == L.term;
    int n_in = 0, n_out = 0;
    for (int j = 0; j < V; ++j) {
      n_in += L.voters_in[j];
      n_out += L.voters_out[j];
    }
    const bool single = n_in <= 1 && n_out == 0;
    const bool immediate = ri_ok && (single || c.read_only_lease_based);
    const bool enq = ri_ok && !immediate;
    bool any_free = false;
    int first_free = 0;
    for (int q = r - 1; q >= 0; --q) {
      if (L.ro_ctx[q] == 0) {
        any_free = true;
        first_free = q;
      }
    }
    const bool can_enq = enq && any_free;
    if (can_enq) {
      const int q = first_free;
      L.ro_ctx[q] = ops.read_ctx;
      L.ro_from[q] = L.id;
      L.ro_index[q] = L.committed;
      for (int j = 0; j < V; ++j) L.ro_acks[q][j] = is_self[j];
      L.ro_seq[q] = L.ro_next_seq;
    }
    L.ro_next_seq += can_enq;
    R.bcast_heartbeat(can_enq, ops.read_ctx);
    const bool imm_room = immediate && L.rs_count < r;
    ev.v[C_READ_INDEX_SERVED] += imm_room;
    if (imm_room) {
      const int q = clampi(L.rs_count, 0, r - 1);
      L.rs_ctx[q] = ops.read_ctx;
      L.rs_index[q] = L.committed;
      L.rs_count += 1;
    }
  }

  // forget leader (raft.go:1700-1708)
  if (ops.forget && L.state == FOLLOWER && L.lead != 0 && !c.read_only_lease_based)
    L.lead = 0;

  // ---- the single coalesced append fan-out ----
  R.maybe_send_append();

  // ---- synchronous persist + apply ----
  L.stabled = L.last;
  const int applied_bytes = R.bytes_between(L.applied, L.committed);
  R.applied_to(L.committed);
  L.uncommitted_size = imax(L.uncommitted_size - applied_bytes, 0);
  if (flags & F_LAG) {
    L.avail_snap_index = L.applied;
    L.avail_snap_term = R.term_at(L.applied);
    const int target = imax(L.snap_index, L.applied - lag);
    R.compact(target, R.term_at(target));
  }

  if (!metrics) return;
  // ---- end-of-round measurement ----
  for (int j = 0; j < V; ++j) {
    ev.v[C_MSGS_APP] += out.rep_kind[j] == MSG_APP || out.rep_kind[j] == MSG_SNAP;
    ev.v[C_MSGS_APP_RESP] += out.rep_kind[j] == MSG_APP_RESP;
    ev.v[C_MSGS_HEARTBEAT] += out.hb_kind[j] == MSG_HEARTBEAT;
    ev.v[C_MSGS_HEARTBEAT_RESP] += out.hb_kind[j] == MSG_HEARTBEAT_RESP;
    ev.v[C_MSGS_VOTE] += out.vote_kind[j] != MSG_NONE;
    ev.v[C_MSGS_VOTE_RESP] += out.vresp_kind[j] != MSG_NONE;
  }
  ev.v[C_LEADER_CHANGES] += L.lead != lead0 && L.lead != 0;
  ev.v[C_COMMITS] += L.committed - committed0;
  // metrics.observe_commit_latency
  const bool done = samp.index > 0 && L.committed >= samp.index;
  if (done) {
    const int lat = round_ctr + 1 - samp.round;
    const int edges[kBuckets - 1] = {1, 2, 3, 4, 6, 8, 12, 16, 24, 32};
    int b = 0;
    for (int x = 0; x < kBuckets - 1; ++x) b += lat > edges[x];
    ev.v[C_HIST0 + b] += 1;
    ev.v[C_LAT_SUM] += lat;
    samp.index = 0;
  }
}

}  // namespace raft

// ---------------------------------------------------------------------------
// the launch: kc rounds of every lane of a block

namespace raft {

// round k writes its outbox here; round k+1 reads it (the last round's
// buffer is the output fabric, and consecutive rounds alternate)
RAFT_HD void *const *fab_dst(const Args &a, int k) {
  return a.p + (((a.kc - 1 - k) % 2 == 0) ? P_FAB_OUT : P_FAB_SCR);
}

RAFT_HD void *const *fab_src(const Args &a, int k) {
  return k == 0 ? a.p + P_FAB_IN : fab_dst(a, k - 1);
}

RAFT_HD Dims dims_of(const Args &a) { return Dims{a.n, a.w, a.e, a.f, a.r}; }

// load lane i's routed inbox, with the mute cut at the read
template <int V>
RAFT_HD void load_inbox(const Args &a, void *const *src, long long i,
                        const Dims &d, Fab<V> &in, bool &mute_self,
                        bool (&peer_mute)[V]) {
  io_fab<LOAD_ROUTED>(src, in, i, d);
  const long long base = i - i % V;
  const uint8_t *mute = (const uint8_t *)a.p[P_MUTE];
  mute_self = false;
  for (int j = 0; j < V; ++j) peer_mute[j] = false;
  if (!(a.flags & F_MUTE)) return;
  mute_self = mute[i] != 0;
  for (int j = 0; j < V; ++j) {
    peer_mute[j] = mute[base + j] != 0;
    if (peer_mute[j] || mute_self) {
      in.rep_kind[j] = in.hb_kind[j] = in.vote_kind[j] = in.vresp_kind[j] = MSG_NONE;
    }
  }
}

template <int V>
RAFT_HD void lane_round(const Args &a, long long i, int k, Lane<V> &L,
                        const Cfg<V> &c, const Ops<V> &ops, Sampler &samp,
                        int round_ctr, Events &ev) {
  const Dims d = dims_of(a);
  Fab<V> in, out;
  bool mute_self, peer_mute[V];
  load_inbox<V>(a, fab_src(a, k), i, d, in, mute_self, peer_mute);
  Ops<V> zero;
  clear_ops(zero);
  const bool use_ops = (a.flags & F_OPS) && (k == 0 || !(a.flags & F_OPS_ROUND0));
  clear_fab(out, d);
  fused_round_lane<V>(L, c, in, use_ops ? ops : zero, mute_self, peer_mute,
                      a.flags, a.lag, round_ctr + k, samp, out, ev, d);
  io_fab<STORE>(fab_dst(a, k), out, i, d);
  // the carry crosses the slim dtypes between rounds (slim_state/fat_state)
  io_state<ROUNDTRIP>(nullptr, L, i, d);
}

template <int V>
RAFT_HD void lane_load(const Args &a, long long i, Lane<V> &L, Cfg<V> &c,
                       Ops<V> &ops, Sampler &samp) {
  const Dims d = dims_of(a);
  io_state<LOAD>(a.p + P_STATE_IN, L, i, d);
  io_cfg<LOAD>(a.p + P_CFG, c, i, d);
  io_ops<LOAD>(a.p + P_OPS, ops, i, d);
  samp.index = samp.round = 0;
  if (a.flags & F_METRICS) {
    samp.index = ((const int *)a.p[P_SAMP_INDEX_IN])[i];
    samp.round = ((const int *)a.p[P_SAMP_ROUND_IN])[i];
  }
}

template <int V>
RAFT_HD void lane_store(const Args &a, long long i, Lane<V> &L,
                        const Sampler &samp) {
  const Dims d = dims_of(a);
  io_state<STORE>(a.p + P_STATE_OUT, L, i, d);
  if (a.flags & F_METRICS) {
    ((int *)a.p[P_SAMP_INDEX_OUT])[i] = samp.index;
    ((int *)a.p[P_SAMP_ROUND_OUT])[i] = samp.round;
  }
}

RAFT_HD int *partials_row(const Args &a, int k, long long block,
                          long long n_blocks) {
  return (int *)a.p[P_PARTIALS] + ((long long)k * n_blocks + block) * kPartialWidth;
}

}  // namespace raft

#ifdef __CUDACC__

namespace {

using namespace raft;

template <int V>
__global__ void __launch_bounds__(kMaxCta) round_kernel(const Args a) {
  __shared__ int acc[kPartUsed];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool metrics = a.flags & F_METRICS;
  Lane<V> L;
  Cfg<V> c;
  Ops<V> ops;
  Sampler samp;
  lane_load<V>(a, i, L, c, ops, samp);
  const int round_ctr = metrics ? *(const int *)a.p[P_ROUND_CTR] : 0;
  for (int k = 0; k < a.kc; ++k) {
    Events ev;
    lane_round<V>(a, i, k, L, c, ops, samp, round_ctr, ev);
    if (metrics) {
      for (int t = threadIdx.x; t < kPartUsed; t += blockDim.x) acc[t] = 0;
      __syncthreads();
      for (int x = 0; x < kPartUsed; ++x)
        if (ev.v[x]) atomicAdd(&acc[x], ev.v[x]);
      __syncthreads();
      int *row = partials_row(a, k, blockIdx.x, gridDim.x);
      for (int t = threadIdx.x; t < kPartialWidth; t += blockDim.x)
        row[t] = t < kPartUsed ? acc[t] : 0;
    }
    // this round's outbox is complete before the next round reads it, and
    // every read of the buffer the next round overwrites is done
    __syncthreads();
  }
  lane_store<V>(a, i, L, samp);
}

}  // namespace

// ptrs: kNumPtrs device pointers in table order; dims: n, v, w, e, f, r,
// kc, cta (lanes per CUDA block: a multiple of v that divides n, <= 256).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int raft_round(void *const *ptrs, int nptrs, const long long *dims,
                          int flags, int lag, void *stream) {
  if (nptrs != kNumPtrs) return (int)cudaErrorInvalidValue;
  Args a;
  for (int p = 0; p < kNumPtrs; ++p) a.p[p] = ptrs[p];
  a.n = dims[0];
  const int v = (int)dims[1];
  a.w = (int)dims[2];
  a.e = (int)dims[3];
  a.f = (int)dims[4];
  a.r = (int)dims[5];
  a.kc = (int)dims[6];
  const long long cta = dims[7];
  a.flags = flags;
  a.lag = lag;
  if (cta < 1 || cta > kMaxCta || cta % v || a.n % cta || a.w > kMaxW ||
      a.e > kMaxE || a.f > kMaxF || a.r > kMaxR || a.kc < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(a.n / cta);
  // the widened carry lives in the thread's local memory: make sure the
  // per-thread stack covers the kernel's frame
#define LAUNCH(V)                                                       \
  do {                                                                  \
    cudaFuncAttributes attr;                                            \
    size_t limit = 0;                                                   \
    if (cudaFuncGetAttributes(&attr, round_kernel<V>) == cudaSuccess && \
        cudaDeviceGetLimit(&limit, cudaLimitStackSize) == cudaSuccess &&  \
        attr.localSizeBytes > limit)                                    \
      cudaDeviceSetLimit(cudaLimitStackSize, attr.localSizeBytes);      \
    round_kernel<V><<<grid, (unsigned)cta, 0, s>>>(a);                  \
  } while (0)
  RAFT_V_SWITCH(v, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

#else  // a host build of the same lane code, run block by block on the CPU

#include <vector>

namespace {

using namespace raft;

template <int V>
int round_host(const Args &a, long long cta) {
  const long long n_blocks = a.n / cta;
  const bool metrics = a.flags & F_METRICS;
  const int round_ctr = metrics ? *(const int *)a.p[P_ROUND_CTR] : 0;
  std::vector<Lane<V>> L(cta);
  std::vector<Cfg<V>> c(cta);
  std::vector<Ops<V>> ops(cta);
  std::vector<Sampler> samp(cta);
  for (long long b = 0; b < n_blocks; ++b) {
    for (long long t = 0; t < cta; ++t)
      lane_load<V>(a, b * cta + t, L[t], c[t], ops[t], samp[t]);
    for (int k = 0; k < a.kc; ++k) {
      int acc[kPartUsed] = {0};
      for (long long t = 0; t < cta; ++t) {
        Events ev;
        lane_round<V>(a, b * cta + t, k, L[t], c[t], ops[t], samp[t], round_ctr, ev);
        for (int x = 0; x < kPartUsed; ++x) acc[x] += ev.v[x];
      }
      if (metrics) {
        int *row = partials_row(a, k, b, n_blocks);
        for (int x = 0; x < kPartialWidth; ++x) row[x] = x < kPartUsed ? acc[x] : 0;
      }
    }
    for (long long t = 0; t < cta; ++t) lane_store<V>(a, b * cta + t, L[t], samp[t]);
  }
  return 0;
}

}  // namespace

extern "C" int raft_round_host(void *const *ptrs, int nptrs,
                               const long long *dims, int flags, int lag) {
  if (nptrs != kNumPtrs) return 1;
  Args a;
  for (int p = 0; p < kNumPtrs; ++p) a.p[p] = ptrs[p];
  a.n = dims[0];
  const int v = (int)dims[1];
  a.w = (int)dims[2];
  a.e = (int)dims[3];
  a.f = (int)dims[4];
  a.r = (int)dims[5];
  a.kc = (int)dims[6];
  const long long cta = dims[7];
  a.flags = flags;
  a.lag = lag;
  if (cta < 1 || cta % v || a.n % cta || a.w > kMaxW || a.e > kMaxE ||
      a.f > kMaxF || a.r > kMaxR || a.kc < 1)
    return 1;
  switch (v) {
    case 1: return round_host<1>(a, cta);
    case 2: return round_host<2>(a, cta);
    case 3: return round_host<3>(a, cta);
    case 4: return round_host<4>(a, cta);
    case 5: return round_host<5>(a, cta);
    case 6: return round_host<6>(a, cta);
    case 7: return round_host<7>(a, cta);
    case 8: return round_host<8>(a, cta);
    default: return 1;
  }
}

#endif
