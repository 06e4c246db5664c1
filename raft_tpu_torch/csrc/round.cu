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
// What bounds it. Per launch the carry crosses device memory once each way
// (about 1.5 KB per lane at the bench shape), and each round is a few
// thousand integer operations per lane on that carry, many of them reads
// of the log window and the fabric at indexes that depend on the data. So
// the kernel is bound by where the carry lives while the rounds run: in
// registers and shared memory it is the device-memory bytes and the
// latency of the round's dependent chains; in a thread's local memory (a
// stack frame of KBs per thread, far beyond the L2 across the card) every
// access inside the round is device-memory traffic.
//
// Design.
// - Compile-time Shape and block. V, W (log_window), E (max_msg_entries),
//   F (max_inflight), R (max_read_index) and S (the most lanes a block
//   takes, a multiple of 32) are -D macros: build.py compiles one library
//   per (Shape, S) a run uses. Every per-lane array is exactly as long as
//   the Shape asks, every loop over one unrolls, and every shared-memory
//   address folds into an immediate offset.
// - One thread per lane; a CUDA block covers whole raft groups (its lane
//   count is a multiple of V), so routing never leaves the block and no
//   grid-wide sync is needed.
// - Registers: the LANE scalars and the PEER arrays (always indexed by the
//   loop over V), widened to int32 and narrowed between rounds, which
//   replays the slim casts (K rounds in one launch equal K launches of one
//   round bit for bit). Nothing selects an element of them by a
//   data-dependent index (a bit mask does, where the reference does):
//   such an index keeps the whole carry in local memory.
// - The diet-v2 build (-DRAFT_DIET=1, the packed carry of state.py
//   pack_state and ops/fused.py pack_fabric): the same registers and
//   shared-memory columns, the same rounds. Only the device-memory rows
//   differ (RAFT_*_DIET below: uint16/int16/int8 columns, bitset words):
//   widened at load, narrowed at store, and between rounds every value
//   that packs narrower is clamped to its range with ERR_DIET_OVERFLOW on
//   its lane, as store_carry then load_carry do. The rings stay in their
//   slim dtypes in shared memory, so no value a round writes and reads
//   back is clamped before the boundary.
// - Shared memory, element e of lane t at [e * s + t]: the rings indexed
//   by data (log window, inflights, ReadIndex queues; s = S, so a warp
//   hits 32 banks whatever elements its threads pick), in their slim
//   dtypes, which hold every value the reference stores there; and two
//   fabric buffers (s = S + 1, so the routed reads of a group's V senders
//   fall in distinct banks). About 790 B per lane at the bench shape: 96
//   lanes a block, three blocks an SM.
// - Fabric on-chip across the K rounds: lane g*V+j reads its inbound cell
//   i straight from the outbox of lane g*V+i, slot j, with the mute cut
//   applied to its own inbound cells (sender or receiver muted; the self
//   slot passes through); round k reads buffer k % 2 and writes its outbox
//   to the other, one __syncthreads() per round; only the last round's
//   outbox is stored.
// - Device memory: each thread moves its own lane's rows (16-byte
//   accesses where a row allows; a warp's 32 neighbouring rows use every
//   sector it fetches) and writes its own shared-memory columns, so the
//   load and the store need no barrier and no index arithmetic. (A copy by
//   the whole block, each leaf's chunk transposed through shared memory,
//   made a one-round launch 3.7x slower: PERF.md, PR 3.)
// - The paged build (-DRAFT_PAGED=1 with RAFT_WRES, RAFT_PE, RAFT_M: the
//   paged entry log of ops/paged.py, paged in the kernel). A CUDA block
//   is one allocation segment: its lanes' page tables address its own
//   sub-pool of `pool_rows` rows (row 0 its trash row). The log leaves'
//   device rows are the resident [W_res] tails; each thread rebuilds its
//   lane's W ring columns from its tail, its page-table row and the
//   sub-pool (page_in), the rounds run unchanged, and after the last one
//   the block decides with one barrier whether any lane's last or
//   snap_index moved. If none did (and E <= W_res) the tables and the
//   sub-pool are copied through; else the block reallocates from scratch
//   (page_out): each lane's page demand, an exclusive scan over the block
//   (warp shuffles, one shared row of warp totals), its pages written,
//   and every other row of the sub-pool zeroed, with ERR_PAGE_EXHAUSTED on
//   a lane that did not fit. Built with and without RAFT_DIET.
// - The chaos build (-DRAFT_CHAOS=1: the chaos plane of
//   raft_tpu_torch/chaos/device.py, replacing the chaos branch of the
//   Pallas kernel, :616-634, :670-700, :728-730). Per lane and in-kernel
//   round (absolute round = the launch's first round + k): at a crash or
//   restart round the lane's registers and ring columns are wiped
//   (wipe_lane); its inbound cells are cut by the partition masks, a down
//   endpoint and one drop draw per channel and edge, as bits of a mask per
//   channel read through the inbox (InFab), so that no sender's cell is
//   written; a down or skipped lane does not tick; after the round, cells
//   of the lane's previous outbox (the buffer it read this round) fill
//   empty cells of its new one where the duplicate draw fires, before the
//   storage boundary; and the recovery probe reads its group's
//   has-a-leader and committed-past-base flags from a byte a lane, written
//   before the round's barrier and read after it, then a second barrier
//   before the partials row takes the block's recounts. The draws are
//   chaos/device.py's counter-based hash on the global lane (i), so
//   blocks and K do not change them. Knobs are read from device memory
//   each round; the probe columns ride in registers. Not built with
//   RAFT_PAGED.
// - The commit index and vote tallies are per lane over its own [V]
//   progress rows: raft::joint_committed / reduce_half<V> of quorum.cuh,
//   shared with quorum.cu.
// - Metrics: each counter summed across the warp (redux) and added to the
//   block's shared row with one atomic per warp; exact in any order. One
//   partials row per (round, block); the rows are summed outside.
// - The source is laid out as functions that mirror the Python modules
//   (ops/log.py, ops/progress.py, ops/step.py, ops/fused.py), so a leaf
//   that differs points at one function.
//
// Argument packing. The pointer table follows the dataclass field order of
// RaftState, LaneConfig, Fabric and LocalOps; the X-macro tables below are
// that order, with each leaf's storage dtype and shape, and
// tests/test_torch_pallas_round.py holds them against the dataclasses.
// Everything not under __CUDACC__ also compiles as plain C++: the host
// entry raft_round_host runs the same phases on a block-sized buffer with
// the same layout, lane after lane.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RAFT_UNROLL _Pragma("unroll")
#else
#define RAFT_UNROLL
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

// The diet-v2 packed layout (raft_tpu_torch/state.py pack_state and
// ops/fused.py pack_fabric, the kernel's V <= 8 making every bitset one
// byte): the leaves whose storage differs from the tables above, in table
// order, X(name, packed dtype, packed shape). A -DRAFT_DIET=1 build reads
// and writes these in device memory; its rounds run on the same registers
// and shared-memory columns as the slim build.
#define RAFT_STATE_DIET(X)                \
  X(id, I8, LANE)                         \
  X(term, U16, LANE)                      \
  X(vote, I8, LANE)                       \
  X(lead, I8, LANE)                       \
  X(lead_transferee, I8, LANE)            \
  X(pending_conf_index, U16, LANE)        \
  X(log_term, U16, WIN)                   \
  X(log_bytes, I16, WIN)                  \
  X(last, U16, LANE)                      \
  X(stabled, U16, LANE)                   \
  X(committed, U16, LANE)                 \
  X(applying, U16, LANE)                  \
  X(applied, U16, LANE)                   \
  X(snap_index, U16, LANE)                \
  X(snap_term, U16, LANE)                 \
  X(pending_snap_index, U16, LANE)        \
  X(pending_snap_term, U16, LANE)         \
  X(avail_snap_index, U16, LANE)          \
  X(avail_snap_term, U16, LANE)           \
  X(prs_id, I8, PEER)                     \
  X(voters_in, U8, LANE)                  \
  X(voters_out, U8, LANE)                 \
  X(learners, U8, LANE)                   \
  X(learners_next, U8, LANE)              \
  X(pr_match, U16, PEER)                  \
  X(pr_next, U16, PEER)                   \
  X(pr_pending_snapshot, U16, PEER)       \
  X(pr_recent_active, U8, LANE)           \
  X(pr_msg_app_flow_paused, U8, LANE)     \
  X(infl_index, U16, INFL)                \
  X(ro_from, I8, READ)                    \
  X(ro_index, U16, READ)                  \
  X(ro_acks, U8, READ)                    \
  X(pri_from, I8, READ)                   \
  X(rs_index, U16, READ)

#define RAFT_CFG_DIET(X)                       \
  X(election_tick, I16, LANE)                  \
  X(heartbeat_tick, I16, LANE)                 \
  X(max_inflight, I8, LANE)

#define RAFT_FABRIC_DIET(X)     \
  X(rep_term, U16, PEER)        \
  X(rep_index, U16, PEER)       \
  X(rep_log_term, U16, PEER)    \
  X(rep_commit, U16, PEER)      \
  X(rep_reject_hint, U16, PEER) \
  X(rep_ent_term, U16, ENT)     \
  X(rep_ent_bytes, I16, ENT)    \
  X(rep_snap_index, U16, PEER)  \
  X(rep_snap_term, U16, PEER)   \
  X(hb_term, U16, PEER)         \
  X(hb_commit, U16, PEER)       \
  X(vote_term, U16, PEER)       \
  X(vote_index, U16, PEER)      \
  X(vote_log_term, U16, PEER)   \
  X(vresp_term, U16, PEER)      \
  X(self_term, U16, LANE)       \
  X(self_index, U16, LANE)

// The chaos build's columns (raft_tpu_torch/chaos/device.py KNOBS and
// PROBES), int32, in pointer order: the knobs are read, the probes read and
// written.
#define RAFT_CHAOS_KNOBS(X)      \
  X(drop_num, I32, PEER)         \
  X(dup_num, I32, PEER)          \
  X(part_send, I32, LANE)        \
  X(part_recv, I32, LANE)        \
  X(tick_skew_num, I32, LANE)    \
  X(crash_at, I32, LANE)         \
  X(restart_at, I32, LANE)

#define RAFT_CHAOS_PROBES(X)     \
  X(base_committed, I32, LANE)   \
  X(reelect_round, I32, LANE)    \
  X(recommit_round, I32, LANE)

#ifndef RAFT_DIET
#define RAFT_DIET 0
#endif

#ifndef RAFT_PAGED
#define RAFT_PAGED 0
#endif

#ifndef RAFT_CHAOS
#define RAFT_CHAOS 0
#endif
#if RAFT_CHAOS && RAFT_PAGED
#error "the chaos build does not take the paged entry log (ROADMAP Queue 2)"
#endif
#if RAFT_PAGED && (!defined(RAFT_WRES) || !defined(RAFT_PE) || !defined(RAFT_M))
#error "the paged build takes its geometry: -DRAFT_WRES= -DRAFT_PE= -DRAFT_M="
#endif

#if !defined(RAFT_V) || !defined(RAFT_W) || !defined(RAFT_E) || \
    !defined(RAFT_F) || !defined(RAFT_R) || !defined(RAFT_S)
#error "build round.cu for one Shape and block: -DRAFT_V= -DRAFT_W= -DRAFT_E= -DRAFT_F= -DRAFT_R= -DRAFT_S="
#endif

namespace raft {

// the Shape this library is built for (config.Shape)
constexpr int V = RAFT_V;  // max_peers
constexpr int W = RAFT_W;  // log_window
constexpr int E = RAFT_E;  // max_msg_entries
constexpr int F = RAFT_F;  // max_inflight
constexpr int R = RAFT_R;  // max_read_index
static_assert(V >= 1 && V <= 8, "the round kernel takes V = 1..8");
static_assert(W >= 1 && W <= 64 && (W & (W - 1)) == 0, "W: a power of two <= 64");
static_assert(E >= 1 && E <= 8 && F >= 1 && F <= 8 && R >= 1 && R <= 8,
              "the round kernel takes E, F, R = 1..8");
constexpr int kMaxCta = 256;  // lanes (threads) per CUDA block
// The column stride of the block's shared memory: the most lanes a block
// of this library takes (a multiple of 32). A compile-time stride folds
// every shared-memory address of the lane code into an immediate offset
// from a few base registers.
constexpr int S = RAFT_S;
static_assert(S >= 32 && S <= kMaxCta && S % 32 == 0, "S: a multiple of 32 <= kMaxCta");

RAFT_HD constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }

#if RAFT_PAGED
// the paged entry log's geometry (ops/paged.py PagePlan)
constexpr int WRES = RAFT_WRES;  // resident entries per lane
constexpr int PE = RAFT_PE;      // entries per page
constexpr int M = RAFT_M;        // page-table slots per lane
constexpr int LPE = ilog2(PE);
constexpr int KMAX = (W - WRES + PE - 1) / PE + 1;  // the most pages one lane needs
static_assert(WRES >= 2 && WRES < W && (WRES & (WRES - 1)) == 0, "WRES: a power of two < W");
static_assert(PE >= 1 && PE <= W && (PE & (PE - 1)) == 0, "PE: a power of two <= W");
static_assert(M >= KMAX && (M & (M - 1)) == 0, "M: next_pow2(KMAX)");
// allocator elision is sound only when every in-round log write lands in
// the resident window (paged.py page_out_cond)
constexpr bool kCanSkip = E <= WRES;
#endif

#define RAFT_COUNT(name, dt, shape) +1
constexpr int kStateN = 0 RAFT_STATE_FIELDS(RAFT_COUNT);
constexpr int kCfgN = 0 RAFT_CFG_FIELDS(RAFT_COUNT);
constexpr int kFabN = 0 RAFT_FABRIC_FIELDS(RAFT_COUNT);
constexpr int kOpsN = 0 RAFT_OPS_FIELDS(RAFT_COUNT);
#undef RAFT_COUNT

// leaf indexes in table order
#define RAFT_ENUM_STATE(name, dt, shape) SL_##name,
#define RAFT_ENUM_CFG(name, dt, shape) CL_##name,
#define RAFT_ENUM_FAB(name, dt, shape) FL_##name,
enum : int { RAFT_STATE_FIELDS(RAFT_ENUM_STATE) };
enum : int { RAFT_CFG_FIELDS(RAFT_ENUM_CFG) };
enum : int { RAFT_FABRIC_FIELDS(RAFT_ENUM_FAB) };
#undef RAFT_ENUM_STATE
#undef RAFT_ENUM_CFG
#undef RAFT_ENUM_FAB

#define RAFT_ENUM_CHAOS(name, dt, shape) CH_##name,
enum : int { RAFT_CHAOS_KNOBS(RAFT_ENUM_CHAOS) kChaosKnobs };
enum : int { RAFT_CHAOS_PROBES(RAFT_ENUM_CHAOS) kChaosProbes };
#undef RAFT_ENUM_CHAOS

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
  P_SAMP_INDEX_OUT = P_FAB_OUT + kFabN,
  P_SAMP_ROUND_OUT,
  P_PARTIALS,                      // [kc, n / cta, kPartialWidth] i32
  P_PAGED_IN,                      // PagedLog leaves (PG_* order; paged
  P_PAGED_OUT = P_PAGED_IN + 8,    // build, else null), in and out
  P_CH_KNOB = P_PAGED_OUT + 8,     // the chaos build only: its knob columns,
  P_CH_PROBE_IN = P_CH_KNOB + kChaosKnobs,  // the probe columns in,
  P_CH_ROUND = P_CH_PROBE_IN + kChaosProbes, // [] i32 the launch's first round,
  P_CH_HEAL,                                 // [] i32 heal_round,
  P_CH_SEED,                                 // [] u32 the PRNG stream,
  P_CH_PROBE_OUT,                            // the probe columns out
  kNumPtrs = RAFT_CHAOS ? P_CH_PROBE_OUT + kChaosProbes : P_CH_KNOB
};

// the PagedLog leaves (ops/paged.py LEAVES): pt [N, M] u16, the pool
// columns [P, PE] in the log leaves' device types, four [N] i32 counters
enum : int { PG_pt, PG_pool_term, PG_pool_type, PG_pool_bytes, PG_faults, PG_exhausted,
             PG_dirty, PG_skipped };

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
// the chaos build's recounts n_reelected / n_recommitted: shared-memory
// slots after the metrics sums, row slots after them with metrics on, at 0
// without
constexpr int kChaosPart = RAFT_CHAOS ? 2 : 0;
constexpr int kAccN = kPartUsed + kChaosPart;
constexpr int NEVER = 1 << 30;  // chaos/device.py NEVER
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
constexpr int ERR_DIET_OVERFLOW = 64;  // state.py: a value clamped at the diet boundary
constexpr int ERR_PAGE_EXHAUSTED = 128;  // state.py: a lane's pages did not fit its pool
constexpr int BIG = 2147483647;

struct Args {
  void *p[kNumPtrs];
  long long n;
  int kc;     // rounds in this launch
  int flags;
  int lag;    // auto_compact_lag when F_LAG
  long long pool_rows;  // pool rows per CUDA block (paged build), else 0
};

// ---------------------------------------------------------------------------
// the block's shared-memory buffer

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
#define RAFT_ST_U16 uint16_t
#define RAFT_ST_U8 uint8_t

enum : int { K_LANE, K_PEER, K_WIN, K_INFL, K_READ, K_READ_PEER, K_ENT };

// How leaf K of group G is stored in device memory, given its slim
// storage type ST: as ST (T = ST, kind -1: the slim table's shape), or in
// a diet build as its RAFT_*_DIET row (T and kind from there).
enum : int { G_STATE, G_CFG, G_FAB };
template <int G, int K, typename ST>
struct Store {
  using T = ST;
  static constexpr int kind = -1;
};
#if RAFT_DIET
#define RAFT_STORE_ROW(group, leaf, dt, shape) \
  template <typename ST>                       \
  struct Store<group, leaf, ST> {              \
    using T = RAFT_ST_##dt;                    \
    static constexpr int kind = K_##shape;     \
  };
#define RAFT_STORE_STATE(name, dt, shape) RAFT_STORE_ROW(G_STATE, SL_##name, dt, shape)
#define RAFT_STORE_CFG(name, dt, shape) RAFT_STORE_ROW(G_CFG, CL_##name, dt, shape)
#define RAFT_STORE_FAB(name, dt, shape) RAFT_STORE_ROW(G_FAB, FL_##name, dt, shape)
RAFT_STATE_DIET(RAFT_STORE_STATE)
RAFT_CFG_DIET(RAFT_STORE_CFG)
RAFT_FABRIC_DIET(RAFT_STORE_FAB)
#undef RAFT_STORE_ROW
#undef RAFT_STORE_STATE
#undef RAFT_STORE_CFG
#undef RAFT_STORE_FAB
#endif

// The state leaves the round never reads or writes (fused.py leaves them
// to the host): a lane's row goes from the input straight to the output,
// and takes no register and no shared memory (round_cuda.py THROUGH is the
// same list).
RAFT_HD constexpr bool through(int k) {
  return k == SL_is_learner || k == SL_learners_next || k == SL_auto_leave ||
         k == SL_pri_ctx || k == SL_pri_from;
}

// The log leaves of the paged build: their device rows are the resident
// tails, moved by the paging phases, not by load_lane / store_lane.
RAFT_HD constexpr bool paged_log(int k) {
  return RAFT_PAGED && (k == SL_log_term || k == SL_log_type || k == SL_log_bytes);
}

struct Leaf {
  int bytes, kind;
  bool through;
};
#define RAFT_LEAF_STATE(name, dt, shape) \
  Leaf{(int)sizeof(RAFT_ST_##dt), K_##shape, through(SL_##name)},
#define RAFT_LEAF_FAB(name, dt, shape) Leaf{(int)sizeof(RAFT_ST_##dt), K_##shape, false},
constexpr Leaf kStateLeaves[] = {RAFT_STATE_FIELDS(RAFT_LEAF_STATE)};
constexpr Leaf kFabLeaves[] = {RAFT_FABRIC_FIELDS(RAFT_LEAF_FAB)};
#undef RAFT_LEAF_STATE
#undef RAFT_LEAF_FAB

RAFT_HD constexpr int state_kind(int k) { return kStateLeaves[k].kind; }

RAFT_HD constexpr int elems(int kind) {
  return kind == K_LANE ? 1
       : kind == K_PEER ? V
       : kind == K_WIN ? W
       : kind == K_INFL ? V * F
       : kind == K_READ ? R
       : kind == K_READ_PEER ? R * V
                             : V * E;
}

// the leaves held in shared memory, by set: the state's rings (indexed by
// data) and the fabric
enum : int { SET_RING, SET_FAB };

RAFT_HD constexpr bool in_set(int set, const Leaf &l) {
  return set == SET_RING ? (l.kind == K_WIN || l.kind == K_INFL || l.kind == K_READ ||
                            l.kind == K_READ_PEER) && !l.through
                         : true;
}

// Per lane, the elements of the set's leaves before leaf k, in the set's
// 32-bit region (wide) or its 8-bit region.
RAFT_HD constexpr int set_off(const Leaf *t, int k, int set, bool wide) {
  int o = 0;
  for (int j = 0; j < k; ++j)
    if (in_set(set, t[j]) && (t[j].bytes == 4) == wide) o += elems(t[j].kind);
  return o;
}

RAFT_HD constexpr bool set_sizes_ok(const Leaf *t, int n, int set) {
  for (int j = 0; j < n; ++j)
    if (in_set(set, t[j]) && t[j].bytes != 4 && t[j].bytes != 1) return false;
  return true;
}
static_assert(set_sizes_ok(kStateLeaves, kStateN, SET_RING) &&
                  set_sizes_ok(kFabLeaves, kFabN, SET_FAB),
              "the leaves in shared memory are 32-bit or 8-bit");

constexpr int kRing32 = set_off(kStateLeaves, kStateN, SET_RING, true);
constexpr int kRing8 = set_off(kStateLeaves, kStateN, SET_RING, false);
constexpr int kFab32 = set_off(kFabLeaves, kFabN, SET_FAB, true);
constexpr int kFab8 = set_off(kFabLeaves, kFabN, SET_FAB, false);

RAFT_HD constexpr long long pad16(long long x) { return (x + 15) & ~15LL; }

// Byte offsets into the block's buffer, compile-time constants. Element e
// of lane t of a leaf in shared memory sits at column[e * s + t]: s = sr =
// S for the rings, s = sf = S + 1 for the two fabric buffers.
struct Block {
  unsigned char *base;
  static constexpr int sr = S, sf = S + 1;
  static constexpr long long ring32 = 0;
  static constexpr long long ring8 = ring32 + pad16(4LL * kRing32 * sr);
  static constexpr long long fab0 = ring8 + pad16((long long)kRing8 * sr);
  static constexpr long long fab32_bytes = pad16(4LL * kFab32 * sf);
  static constexpr long long fab_bytes = fab32_bytes + pad16((long long)kFab8 * sf);
  static constexpr long long acc0 = fab0 + 2 * fab_bytes;
  static constexpr long long acc_bytes = pad16(4LL * kAccN);
  // the paged build's warp totals of its block scan
  static constexpr long long scan0 = acc0 + 2 * acc_bytes;
  // the chaos build's probe flags, a byte a lane
  static constexpr long long flag0 = scan0 + (RAFT_PAGED ? pad16(4LL * (kMaxCta / 32)) : 0);
  static constexpr long long bytes = flag0 + (RAFT_CHAOS ? pad16(S) : 0);

  // fabric buffer b (0 or 1): its 32-bit and 8-bit regions
  RAFT_HD long long fab32(int b) const { return fab0 + b * fab_bytes; }
  RAFT_HD long long fab8(int b) const { return fab32(b) + fab32_bytes; }
  RAFT_HD int *acc(int b) const { return (int *)(base + acc0 + b * acc_bytes); }
  RAFT_HD int *scan() const { return (int *)(base + scan0); }
  RAFT_HD uint8_t *flag() const { return base + flag0; }
};

template <typename ST>
RAFT_HD ST *col_at(const Block &B, long long region32, long long region8,
                   int off32, int off8, int s) {
  return sizeof(ST) == 4 ? (ST *)(B.base + region32) + (long long)off32 * s
                         : (ST *)(B.base + region8) + (long long)off8 * s;
}

// column of state leaf K in the rings
template <int K, typename ST>
RAFT_HD ST *ring_col(const Block &B) {
  constexpr int o32 = set_off(kStateLeaves, K, SET_RING, true);
  constexpr int o8 = set_off(kStateLeaves, K, SET_RING, false);
  return col_at<ST>(B, B.ring32, B.ring8, o32, o8, B.sr);
}

// column of fabric leaf K in fabric buffer b
template <int K, typename ST>
RAFT_HD ST *fab_col(const Block &B, int b) {
  constexpr int o32 = set_off(kFabLeaves, K, SET_FAB, true);
  constexpr int o8 = set_off(kFabLeaves, K, SET_FAB, false);
  return col_at<ST>(B, B.fab32(b), B.fab8(b), o32, o8, B.sf);
}

// A thread's view of a shared-memory column: element e at p[e * s].
template <typename T>
struct Col {
  T *p;
  int s;
  RAFT_HD T &operator[](int e) const { return p[(long long)e * s]; }
};

// [X][Y] elements: row x is the Col at p + x * so, element stride si.
template <typename T>
struct Col2 {
  T *p;
  int so, si;
  RAFT_HD Col<T> operator[](int x) const { return Col<T>{p + (long long)x * so, si}; }
};

// ---------------------------------------------------------------------------
// a lane's row of an [N, X] leaf in device memory, moved as a whole: in
// accesses of U bytes, the widest of 16, 8 and 4 that divides the row (the
// wrapper checks that every leaf starts 16-byte aligned), else element by
// element. The threads of a warp read 32 neighbouring rows, so every
// sector fetched is used; the elements go to registers or to the lane's
// shared-memory column, where a warp's stores hit 32 banks.

template <int U>
struct alignas(U) Bits {
  uint32_t w[U / 4];
};

template <typename T, int X>
struct RowIO {
  static constexpr int kBytes = X * (int)sizeof(T);
  static constexpr int U = kBytes % 16 == 0 ? 16 : kBytes % 8 == 0 ? 8 : kBytes % 4 == 0 ? 4 : 0;
  static constexpr int PER = U / (int)sizeof(T);  // elements per access
  static constexpr int EW = 4 / (int)sizeof(T);   // elements per 32-bit word
  static constexpr int kBits = 8 * (int)sizeof(T);
  static constexpr uint32_t kMask = sizeof(T) == 4 ? 0xffffffffu : (1u << kBits) - 1u;

  static RAFT_HD void load(const T *row, T (&e)[X]) {
    if constexpr (U == 0) {
      RAFT_UNROLL
      for (int q = 0; q < X; ++q) e[q] = row[q];
    } else {
      RAFT_UNROLL
      for (int a = 0; a < kBytes / U; ++a) {
        const Bits<U> b = ((const Bits<U> *)row)[a];
        RAFT_UNROLL
        for (int q = 0; q < PER; ++q) e[a * PER + q] = (T)(b.w[q / EW] >> (kBits * (q % EW)));
      }
    }
  }

  static RAFT_HD void store(T *row, const T (&e)[X]) {
    if constexpr (U == 0) {
      RAFT_UNROLL
      for (int q = 0; q < X; ++q) row[q] = e[q];
    } else {
      RAFT_UNROLL
      for (int a = 0; a < kBytes / U; ++a) {
        Bits<U> b;
        RAFT_UNROLL
        for (int w = 0; w < U / 4; ++w) b.w[w] = 0;
        RAFT_UNROLL
        for (int q = 0; q < PER; ++q)
          b.w[q / EW] |= ((uint32_t)e[a * PER + q] & kMask) << (kBits * (q % EW));
        ((Bits<U> *)row)[a] = b;
      }
    }
  }
};

// lane i's row of T (device memory) <-> its column of C (element e at
// col[e * s]); a diet build's rows are narrower than their columns, whose
// values the boundary has already clamped to the row's range
template <typename T, int X, typename C>
RAFT_HD void row_to_col(const T *g, long long i, C *col, int s) {
  T e[X];
  RowIO<T, X>::load(g + i * X, e);
  RAFT_UNROLL
  for (int q = 0; q < X; ++q) col[q * s] = (C)e[q];
}

template <typename T, int X, typename C>
RAFT_HD void col_to_row(T *g, long long i, const C *col, int s) {
  T e[X];
  RAFT_UNROLL
  for (int q = 0; q < X; ++q) e[q] = (T)col[q * s];
  RowIO<T, X>::store(g + i * X, e);
}

// lane t's outbox row of fabric leaf K: in from the input fabric into
// buffer 0, or out from buffer b to the output fabric
template <int K, typename ST, int KIND>
RAFT_HD void fab_row(const Args &a, const Block &B, long long i, int t, int b, bool in) {
  using T = typename Store<G_FAB, K, ST>::T;
  ST *col = fab_col<K, ST>(B, in ? 0 : b) + t;
  if (in)
    row_to_col<T, elems(KIND)>((const T *)a.p[P_FAB_IN + K], i, col, B.sf);
  else
    col_to_row<T, elems(KIND)>((T *)a.p[P_FAB_OUT + K], i, col, B.sf);
}

RAFT_HD void fab_rows(const Args &a, const Block &B, long long i, int t, int b, bool in) {
#define RAFT_FAB_ROW(name, dt, shape) \
  fab_row<FL_##name, RAFT_ST_##dt, K_##shape>(a, B, i, t, b, in);
  RAFT_FABRIC_FIELDS(RAFT_FAB_ROW)
#undef RAFT_FAB_ROW
}

// ---------------------------------------------------------------------------
// the per-lane carry: LANE and PEER leaves in registers (widened), the
// rings as views of the block's shared memory (slim)

#define RAFT_MT_LANE(ct, st) ct
#define RAFT_MT_PEER(ct, st) ct
#define RAFT_MT_WIN(ct, st) Col<st>
#define RAFT_MT_INFL(ct, st) Col2<st>
#define RAFT_MT_READ(ct, st) Col<st>
#define RAFT_MT_READ_PEER(ct, st) Col2<st>
#define RAFT_MD_LANE
#define RAFT_MD_PEER [V]
#define RAFT_MD_WIN
#define RAFT_MD_INFL
#define RAFT_MD_READ
#define RAFT_MD_READ_PEER
#define RAFT_MEMBER(name, dt, shape) \
  RAFT_MT_##shape(RAFT_CT_##dt, RAFT_ST_##dt) name RAFT_MD_##shape;

struct Lane {
  RAFT_STATE_FIELDS(RAFT_MEMBER)
};

struct Cfg {
  RAFT_CFG_FIELDS(RAFT_MEMBER)
};

struct Ops {
  RAFT_OPS_FIELDS(RAFT_MEMBER)
};

#undef RAFT_MEMBER

// A lane's view of one fabric buffer, one member per leaf: as an outbox,
// cell j of a PEER leaf is member[j] and entry k of cell j of an ENT leaf
// member[j][k]; as an inbox, the same indexes reach the senders' cells.
// The self channel (LANE) is member[0].
#define RAFT_FT_LANE(st) Col<st>
#define RAFT_FT_PEER(st) Col<st>
#define RAFT_FT_ENT(st) Col2<st>
#define RAFT_FAB_MEMBER(name, dt, shape) RAFT_FT_##shape(RAFT_ST_##dt) name;

struct Fab {
  RAFT_FABRIC_FIELDS(RAFT_FAB_MEMBER)
};

#undef RAFT_FAB_MEMBER

// lane t's own cells (its outbox) in buffer b
template <int K, typename ST>
RAFT_HD void bind_out(Col<ST> &x, const Block &B, int b, int t) {
  x = Col<ST>{fab_col<K, ST>(B, b) + t, B.sf};
}
template <int K, typename ST>
RAFT_HD void bind_out(Col2<ST> &x, const Block &B, int b, int t) {
  x = Col2<ST>{fab_col<K, ST>(B, b) + t, E * B.sf, B.sf};
}

// the cells sent to lane t = base + me by the lanes of its group: sender
// i's slot me, so element i steps over threads
template <int K, typename ST>
RAFT_HD void bind_in(Col<ST> &x, const Block &B, int b, int base, int me, int kind) {
  ST *col = fab_col<K, ST>(B, b);
  x = kind == K_LANE ? Col<ST>{col + base + me, B.sf} : Col<ST>{col + (long long)me * B.sf + base, 1};
}
template <int K, typename ST>
RAFT_HD void bind_in(Col2<ST> &x, const Block &B, int b, int base, int me, int) {
  x = Col2<ST>{fab_col<K, ST>(B, b) + (long long)me * E * B.sf + base, 1, B.sf};
}

RAFT_HD Fab outbox(const Block &B, int b, int t) {
  Fab f;
#define RAFT_BIND_OUT(name, dt, shape) bind_out<FL_##name, RAFT_ST_##dt>(f.name, B, b, t);
  RAFT_FABRIC_FIELDS(RAFT_BIND_OUT)
#undef RAFT_BIND_OUT
  return f;
}

RAFT_HD Fab inbox(const Block &B, int b, int t) {
  Fab f;
  const int me = t % V, base = t - me;
#define RAFT_BIND_IN(name, dt, shape) \
  bind_in<FL_##name, RAFT_ST_##dt>(f.name, B, b, base, me, K_##shape);
  RAFT_FABRIC_FIELDS(RAFT_BIND_IN)
#undef RAFT_BIND_IN
  return f;
}

#if RAFT_CHAOS
// The chaos build's inbox: the kind of inbound cell e reads MSG_NONE where
// bit e of its channel's cut is set (the mute cut and the chaos cuts), so
// a sender's cells stay as it sent them, for its duplicate redelivery.
struct KindCol {
  int8_t *p;
  int s;
  uint32_t cut;
  RAFT_HD int operator[](int e) const {
    return (cut >> e) & 1u ? (int)MSG_NONE : (int)p[(long long)e * s];
  }
};
struct InFab : Fab {
  KindCol rep_kind, hb_kind, vote_kind, vresp_kind, self_kind;  // hide Fab's
};
#else
using InFab = Fab;
#endif

// ---------------------------------------------------------------------------
// per-thread leaf I/O, by member type: LANE scalars and PEER rows between
// device memory and registers, the rings' rows between device memory and
// their columns (the views bound at load). A diet build's row may be
// narrower (T, widened at load and narrowed at store: the boundary below
// has clamped every value to T's range) or a bitset: a PEER bool row
// stored as one word per lane, ro_acks' [R][V] as one word per slot.

// bit j set where x[j]
RAFT_HD uint32_t bits(const bool (&x)[V]) {
  uint32_t m = 0;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) m |= uint32_t(x[j]) << j;
  return m;
}

// state leaf K (slim storage ST) as device memory holds it
template <int K, typename ST>
struct StateLeaf {
  using S = Store<G_STATE, K, ST>;
  using T = typename S::T;
  static constexpr int kind = S::kind < 0 ? state_kind(K) : S::kind;
  static constexpr int X = elems(kind);  // elements of the lane's row
  static constexpr bool bits = kind != state_kind(K);
  static constexpr bool narrow = S::kind >= 0 && !bits && !through(K);
};

// a through leaf's row, input to output
template <int K, typename T, int X>
RAFT_HD void pass_row(const Args &a, long long i) {
  T e[X];
  RowIO<T, X>::load((const T *)a.p[P_STATE_IN + K] + i * X, e);
  RowIO<T, X>::store((T *)a.p[P_STATE_OUT + K] + i * X, e);
}

template <int K, typename ST, typename CT>
RAFT_HD void load_leaf(CT &x, const Args &a, const Block &, long long i, int) {
  using L = StateLeaf<K, ST>;
  if constexpr (through(K))
    pass_row<K, typename L::T, L::X>(a, i);
  else
    x = (CT)((const typename L::T *)a.p[P_STATE_IN + K])[i];
}
template <int K, typename ST, typename CT>
RAFT_HD void load_leaf(CT (&x)[V], const Args &a, const Block &, long long i, int) {
  using L = StateLeaf<K, ST>;
  using T = typename L::T;
  if constexpr (through(K)) {
    pass_row<K, T, L::X>(a, i);
  } else if constexpr (L::bits) {
    const uint32_t w = ((const T *)a.p[P_STATE_IN + K])[i];
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) x[j] = (CT)((w >> j) & 1u);
  } else {
    T e[V];
    RowIO<T, V>::load((const T *)a.p[P_STATE_IN + K] + i * V, e);
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) x[j] = (CT)e[j];
  }
}
template <int K, typename ST>
RAFT_HD void load_leaf(Col<ST> &x, const Args &a, const Block &B, long long i, int t) {
  using L = StateLeaf<K, ST>;
  using T = typename L::T;
  if constexpr (through(K)) {
    pass_row<K, T, L::X>(a, i);
  } else {
    x = Col<ST>{ring_col<K, ST>(B) + t, B.sr};
    if constexpr (!paged_log(K))
      row_to_col<T, L::X>((const T *)a.p[P_STATE_IN + K], i, x.p, B.sr);
  }
}
template <int K, typename ST>
RAFT_HD void load_leaf(Col2<ST> &x, const Args &a, const Block &B, long long i, int t) {
  using L = StateLeaf<K, ST>;
  using T = typename L::T;
  constexpr int inner = state_kind(K) == K_INFL ? F : V;
  x = Col2<ST>{ring_col<K, ST>(B) + t, inner * B.sr, B.sr};
  if constexpr (L::bits) {  // ro_acks: [R] words -> [R][V] bools
    T e[R];
    RowIO<T, R>::load((const T *)a.p[P_STATE_IN + K] + i * R, e);
    RAFT_UNROLL
    for (int r = 0; r < R; ++r) {
      RAFT_UNROLL
      for (int j = 0; j < V; ++j) x[r][j] = (ST)((e[r] >> j) & 1u);
    }
  } else {
    row_to_col<T, L::X>((const T *)a.p[P_STATE_IN + K], i, x.p, B.sr);
  }
}

template <int K, typename ST, typename CT>
RAFT_HD void store_leaf(const CT &x, const Args &a, long long i) {
  using T = typename StateLeaf<K, ST>::T;
  if constexpr (!through(K)) ((T *)a.p[P_STATE_OUT + K])[i] = (T)x;
}
template <int K, typename ST, typename CT>
RAFT_HD void store_leaf(const CT (&x)[V], const Args &a, long long i) {
  using L = StateLeaf<K, ST>;
  using T = typename L::T;
  if constexpr (through(K)) return;
  if constexpr (L::bits) {
    ((T *)a.p[P_STATE_OUT + K])[i] = (T)bits(x);
  } else {
    T e[V];
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) e[j] = (T)x[j];
    RowIO<T, V>::store((T *)a.p[P_STATE_OUT + K] + i * V, e);
  }
}
template <int K, typename ST>
RAFT_HD void store_leaf(const Col<ST> &x, const Args &a, long long i) {
  using L = StateLeaf<K, ST>;
  if constexpr (!through(K) && !paged_log(K))
    col_to_row<typename L::T, L::X>((typename L::T *)a.p[P_STATE_OUT + K], i, x.p, x.s);
}
template <int K, typename ST>
RAFT_HD void store_leaf(const Col2<ST> &x, const Args &a, long long i) {
  using L = StateLeaf<K, ST>;
  using T = typename L::T;
  if constexpr (L::bits) {  // ro_acks: [R][V] bools -> [R] words
    T e[R];
    RAFT_UNROLL
    for (int r = 0; r < R; ++r) {
      uint32_t w = 0;
      RAFT_UNROLL
      for (int j = 0; j < V; ++j) w |= uint32_t(x[r][j] != 0) << j;
      e[r] = (T)w;
    }
    RowIO<T, R>::store((T *)a.p[P_STATE_OUT + K] + i * R, e);
  } else {
    col_to_row<T, L::X>((T *)a.p[P_STATE_OUT + K], i, x.p, x.si);
  }
}

// The carry between rounds. The slim build replays the slim casts
// (slim_state then fat_state). A diet build replays store_carry then
// load_carry (ops/fused.py): the same casts, then every value that packs
// narrower (the lane's registers, its ring columns and its outbox cells)
// clamped to its packed range, with ERR_DIET_OVERFLOW set on the lane
// where one moved. Bitsets hold any bool, and error_bits is never packed.

template <typename T>
struct Range;  // the inclusive value range of a packed dtype (state.py _DIET_RANGE)
template <>
struct Range<uint16_t> {
  static constexpr int lo = 0, hi = 65535;
};
template <>
struct Range<int16_t> {
  static constexpr int lo = -32768, hi = 32767;
};
template <>
struct Range<int8_t> {
  static constexpr int lo = -128, hi = 127;
};

template <typename T, typename C>
RAFT_HD void clamp_to(C &x, bool &ovf) {
  if (x < Range<T>::lo || x > Range<T>::hi) {
    ovf = true;
    x = x < Range<T>::lo ? Range<T>::lo : Range<T>::hi;
  }
}

template <int K, typename ST, typename CT>
RAFT_HD void roundtrip(CT &x, bool &ovf) {
  x = (CT)(ST)x;
  if constexpr (StateLeaf<K, ST>::narrow) clamp_to<typename StateLeaf<K, ST>::T>(x, ovf);
}
template <int K, typename ST, typename CT>
RAFT_HD void roundtrip(CT (&x)[V], bool &ovf) {
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    x[j] = (CT)(ST)x[j];
    if constexpr (StateLeaf<K, ST>::narrow) clamp_to<typename StateLeaf<K, ST>::T>(x[j], ovf);
  }
}
template <int K, typename ST>
RAFT_HD void roundtrip(Col<ST> &x, bool &ovf) {
  if constexpr (StateLeaf<K, ST>::narrow) {
    RAFT_UNROLL
    for (int e = 0; e < elems(state_kind(K)); ++e)
      clamp_to<typename StateLeaf<K, ST>::T>(x[e], ovf);
  }
}
template <int K, typename ST>
RAFT_HD void roundtrip(Col2<ST> &x, bool &ovf) {
  if constexpr (StateLeaf<K, ST>::narrow) {
    constexpr int inner = state_kind(K) == K_INFL ? F : V;
    RAFT_UNROLL
    for (int o = 0; o < elems(state_kind(K)) / inner; ++o) {
      RAFT_UNROLL
      for (int e = 0; e < inner; ++e) clamp_to<typename StateLeaf<K, ST>::T>(x[o][e], ovf);
    }
  }
}

// the lane's outbox cells of fabric leaf K (fabric_diet_overflow, then
// pack_fabric's clamp)
template <int K, typename ST, int KIND>
RAFT_HD void clamp_cells(const Col<ST> &x, bool &ovf) {
  using S = Store<G_FAB, K, ST>;
  if constexpr (S::kind >= 0) {
    RAFT_UNROLL
    for (int j = 0; j < (KIND == K_LANE ? 1 : V); ++j) clamp_to<typename S::T>(x[j], ovf);
  }
}
template <int K, typename ST, int KIND>
RAFT_HD void clamp_cells(const Col2<ST> &x, bool &ovf) {
  using S = Store<G_FAB, K, ST>;
  if constexpr (S::kind >= 0) {
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      RAFT_UNROLL
      for (int k = 0; k < E; ++k) clamp_to<typename S::T>(x[j][k], ovf);
    }
  }
}

RAFT_HD void load_lane(Lane &L, const Args &a, const Block &B, long long i, int t) {
#define RAFT_LOAD(name, dt, shape) load_leaf<SL_##name, RAFT_ST_##dt>(L.name, a, B, i, t);
  RAFT_STATE_FIELDS(RAFT_LOAD)
#undef RAFT_LOAD
}

RAFT_HD void store_lane(const Lane &L, const Args &a, long long i) {
#define RAFT_STORE(name, dt, shape) store_leaf<SL_##name, RAFT_ST_##dt>(L.name, a, i);
  RAFT_STATE_FIELDS(RAFT_STORE)
#undef RAFT_STORE
}

// the lane's carry and its outbox `out` after a round
RAFT_HD void roundtrip_lane(Lane &L, const Fab &out) {
  bool ovf = false;
#define RAFT_RT(name, dt, shape) roundtrip<SL_##name, RAFT_ST_##dt>(L.name, ovf);
  RAFT_STATE_FIELDS(RAFT_RT)
#undef RAFT_RT
#define RAFT_CLAMP(name, dt, shape) clamp_cells<FL_##name, RAFT_ST_##dt, K_##shape>(out.name, ovf);
  RAFT_FABRIC_FIELDS(RAFT_CLAMP)
#undef RAFT_CLAMP
  if (ovf) L.error_bits |= ERR_DIET_OVERFLOW;
}

RAFT_HD void load_cfg(Cfg &obj, const Args &a, long long i) {
#define RAFT_LOAD_CFG(name, dt, shape)                                                   \
  obj.name = (RAFT_CT_##dt)(                                                             \
      (const typename Store<G_CFG, CL_##name, RAFT_ST_##dt>::T *)a.p[P_CFG + CL_##name])[i];
  RAFT_CFG_FIELDS(RAFT_LOAD_CFG)
#undef RAFT_LOAD_CFG
}

RAFT_HD void load_ops(Ops &obj, const Args &a, long long i) {
  int k = P_OPS;
#define RAFT_LOAD_OPS(name, dt, shape) \
  obj.name = (RAFT_CT_##dt)((const RAFT_ST_##dt *)a.p[k++])[i];
  RAFT_OPS_FIELDS(RAFT_LOAD_OPS)
#undef RAFT_LOAD_OPS
}

RAFT_HD constexpr int imin(int a, int b) { return a < b ? a : b; }
RAFT_HD constexpr int imax(int a, int b) { return a < b ? b : a; }
RAFT_HD int clampi(int x, int lo, int hi) { return imin(imax(x, lo), hi); }
// Python's floor modulo (torch.remainder) for a positive modulus
RAFT_HD int fmod_pos(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

RAFT_HD void clear_fab(const Fab &f) {
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    f.rep_kind[j] = MSG_NONE;
    f.rep_term[j] = f.rep_index[j] = f.rep_log_term[j] = f.rep_commit[j] = 0;
    f.rep_reject[j] = 0;
    f.rep_reject_hint[j] = f.rep_n_ents[j] = 0;
    RAFT_UNROLL
    for (int k = 0; k < E; ++k)
      f.rep_ent_term[j][k] = f.rep_ent_type[j][k] = f.rep_ent_bytes[j][k] = 0;
    f.rep_snap_index[j] = f.rep_snap_term[j] = 0;
    f.hb_kind[j] = MSG_NONE;
    f.hb_term[j] = f.hb_commit[j] = f.hb_context[j] = 0;
    f.vote_kind[j] = MSG_NONE;
    f.vote_term[j] = f.vote_index[j] = f.vote_log_term[j] = 0;
    f.vote_reject[j] = 0;
    f.vote_context[j] = 0;
    f.vresp_kind[j] = MSG_NONE;
    f.vresp_term[j] = 0;
    f.vresp_reject[j] = 0;
  }
  f.self_kind[0] = MSG_NONE;
  f.self_term[0] = f.self_index[0] = 0;
}

RAFT_HD void clear_ops(Ops &o) {
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
  int ent_term[E], ent_type[E], ent_bytes[E];
  int snap_index, snap_term;
};

RAFT_HD void clear_msg(Msg &m) {
  m.type = m.frm = m.log_term = m.index = m.commit = 0;
  m.context = m.n_ents = 0;
  RAFT_UNROLL
  for (int k = 0; k < E; ++k) m.ent_term[k] = m.ent_type[k] = m.ent_bytes[k] = 0;
  m.snap_index = m.snap_term = 0;
}

// state.py draw_timeout / rng_next, in native uint32
RAFT_HD int draw_timeout(uint32_t rng, int election_tick) {
  return election_tick + (int)((rng >> 16) % (uint32_t)election_tick);
}
RAFT_HD uint32_t rng_next(uint32_t rng) { return rng * 1664525u + 1013904223u; }

// One lane's round. Member functions mirror the Python functions of the
// same name; every masked tensor update becomes `if (mask)` on this lane.
struct Round {
  Lane &L;
  const Cfg &c;
  const InFab &in;
  const Fab &out;
  int ss;          // self slot (step.self_slot), -1 when untracked
  bool is_self[V];
  bool send_sel[V], send_sie[V];

  RAFT_HD Round(Lane &l, const Cfg &cf, const InFab &inb, const Fab &o)
      : L(l), c(cf), in(inb), out(o) {
    // step.find_slot(state, state.id): the first hot slot
    ss = -1;
    RAFT_UNROLL
    for (int j = V - 1; j >= 0; --j)
      if (L.prs_id[j] == L.id && L.prs_id[j] != 0) ss = j;
    RAFT_UNROLL
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

  RAFT_HD int slot_of(int idx) const { return idx & (W - 1); }

  RAFT_HD int window_index(int s) const {
    const int first = L.snap_index + 1;
    return first + ((s - first) & (W - 1));
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

  RAFT_HD void append(int prev, const int (&et)[E], const int (&ety)[E],
                      const int (&eb)[E], int n) {
    const bool act = n > 0;
    err(act && prev < L.committed, ERR_APPEND_BELOW_COMMIT);
    const bool overflow = act && prev + n - L.snap_index > W;
    err(overflow, ERR_WINDOW_OVERFLOW);
    const bool ok = act && prev >= L.committed && !overflow;
    if (ok) {
      const int slot0 = slot_of(prev + 1);
      RAFT_UNROLL
      for (int k = 0; k < E; ++k) {
        if (k < n) {
          const int s = (slot0 + k) % W;
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

  RAFT_HD int find_conflict(int prev, const int (&et)[E], int n) const {
    int ci = BIG;
    RAFT_UNROLL
    for (int k = 0; k < E; ++k) {
      const int idx = prev + 1 + k;
      if (k < n && term_at(idx) != et[k]) ci = imin(ci, idx);
    }
    return ci == BIG ? 0 : ci;
  }

  // returns lastnewi (0 when not ok)
  RAFT_HD int maybe_append(int index, int log_term, int committed,
                           const int (&et)[E], const int (&ety)[E],
                           const int (&eb)[E], int n, bool &ok) {
    ok = term_at(index) == log_term;
    const int lastnewi = index + n;
    const int ci = find_conflict(index, et, n);
    err(ok && ci != 0 && ci <= L.committed, ERR_CONFLICT_BELOW_COMMIT);
    const int shift = ci > 0 ? ci - index - 1 : 0;
    int st[E], sty[E], sb[E];
    const int s0 = fmod_pos(shift, E);
    RAFT_UNROLL
    for (int k = 0; k < E; ++k) {  // a roll by s0, as masks over the E entries
      const int src = (s0 + k) % E;
      st[k] = sty[k] = sb[k] = 0;
      RAFT_UNROLL
      for (int q = 0; q < E; ++q) {
        const int m = -(int)(q == src);
        st[k] |= et[q] & m;
        sty[k] |= ety[q] & m;
        sb[k] |= eb[q] & m;
      }
    }
    const int n_keep = (ok && ci > 0) ? n - shift : 0;
    append(ci > 0 ? ci - 1 : 0, st, sty, sb, n_keep);
    commit_to(ok ? imin(committed, lastnewi) : 0);
    return ok ? lastnewi : 0;
  }

  // the rollback index of find_conflict_by_term / fused._fcbt_nv
  RAFT_HD int conflict_index(int index, int term) const {
    int best = -1;
    RAFT_UNROLL
    for (int s = 0; s < W; ++s) {
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
    RAFT_UNROLL
    for (int s = 0; s < W; ++s) L.log_term[s] = L.log_type[s] = L.log_bytes[s] = 0;
    L.last = L.stabled = L.committed = L.snap_index = idx;
    L.snap_term = term;
    L.pending_snap_index = idx;
    L.pending_snap_term = term;
    L.applying = imin(L.applying, idx);
    L.applied = imin(L.applied, idx);
  }

  RAFT_HD int bytes_between(int lo, int hi) const {
    int sum = 0;
    RAFT_UNROLL
    for (int s = 0; s < W; ++s) {
      const int idx = window_index(s);
      if (idx <= L.last && idx > lo && idx <= hi) sum += L.log_bytes[s];
    }
    return sum;
  }

  RAFT_HD bool has_unapplied_conf_changes() const {
    bool any = false;
    RAFT_UNROLL
    for (int s = 0; s < W; ++s) {
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
    const int cap = imin(c.max_inflight, F);
    const bool cap_hit = L.infl_count[j] >= cap;
    const int max_bytes = c.max_inflight_bytes;
    const bool bytes_hit = max_bytes != 0 && L.infl_total_bytes[j] >= max_bytes;
    return cap_hit || bytes_hit;
  }

  RAFT_HD void inflights_add(int j, bool sel, int index, int bytes) {
    sel = sel && !inflights_full(j);
    if (!sel) return;
    const int pos = fmod_pos(L.infl_start[j] + L.infl_count[j], F);
    L.infl_index[j][pos] = index;
    L.infl_bytes[j][pos] = bytes;
    L.infl_count[j] += 1;
    L.infl_total_bytes[j] += bytes;
  }

  RAFT_HD void inflights_free_le(int j, bool sel, int to) {
    int n_free = 0, b_free = 0;
    RAFT_UNROLL
    for (int k = 0; k < F; ++k) {
      const bool live = k < L.infl_count[j];
      const int pos = fmod_pos(L.infl_start[j] + k, F);
      if (live && L.infl_index[j][pos] <= to) {
        n_free += 1;
        b_free += L.infl_bytes[j][pos];
      }
    }
    if (!sel) return;
    const int new_count = L.infl_count[j] - n_free;
    L.infl_start[j] = new_count == 0 ? 0 : fmod_pos(L.infl_start[j] + n_free, F);
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
    RAFT_UNROLL
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
    // learners[max(ss, 0)], through a bit mask: a select among the array's
    // elements would be folded back into a data-dependent index, which
    // keeps the whole carry out of registers
    const bool is_lr = (bits(L.learners) >> imax(ss, 0)) & 1u;
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
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) L.votes[j] = PENDING;
    L.pending_conf_index = 0;
    L.uncommitted_size = 0;
    RAFT_UNROLL
    for (int q = 0; q < R; ++q) {
      L.ro_ctx[q] = L.ro_from[q] = L.ro_index[q] = L.ro_seq[q] = 0;
      RAFT_UNROLL
      for (int j = 0; j < V; ++j) L.ro_acks[q][j] = false;
    }
    L.ro_next_seq = 1;
    RAFT_UNROLL
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
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) L.votes[j] = PENDING;
    L.lead = 0;
    L.state = PRE_CANDIDATE;
  }

  RAFT_HD void put_self(bool mask, int type, int term, int index) {
    if (!mask) return;
    out.self_kind[0] = type;
    out.self_term[0] = term;
    out.self_index[0] = index;
  }

  // leader local append + self-ack; entry terms are the lane's term
  RAFT_HD bool append_entry(bool mask, const int (&ety)[E], const int (&eb)[E], int n) {
    int sz = 0;
    RAFT_UNROLL
    for (int k = 0; k < E; ++k) sz += eb[k];
    const bool refuse = L.uncommitted_size > 0 && sz > 0 &&
                        L.uncommitted_size + sz > c.max_uncommitted_size;
    const bool ok = mask && !refuse && L.last + n - L.snap_index <= W;
    if (ok) L.uncommitted_size += sz;
    int stamped[E];
    RAFT_UNROLL
    for (int k = 0; k < E; ++k) stamped[k] = L.term;
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
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      const bool sel_self = mask && is_self[j];
      become_replicate(j, sel_self);
      if (sel_self) L.pr_recent_active[j] = true;
    }
    int zeros[E] = {0};
    append_entry(mask, zeros, zeros, mask ? 1 : 0);
  }

  RAFT_HD void maybe_send_append() {
    const bool has_avail = L.avail_snap_index != 0;
    const int send_si = has_avail ? L.avail_snap_index : L.snap_index;
    const int send_st = has_avail ? L.avail_snap_term : L.snap_term;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      bool sel = send_sel[j] && L.prs_id[j] != 0 && !is_self[j] && !is_paused(j);
      const int prev = L.pr_next[j] - 1;
      const int prev_term = term_at(prev);
      const bool throttled = L.pr_state[j] == REPLICATE && inflights_full(j);
      const int n_avail = imax(L.last - prev, 0);
      int n_send = throttled ? 0 : imin(n_avail, E);
      const int slot0 = L.pr_next[j] & (W - 1);
      int et[E], ety[E], eb[E];
      int cum = 0, n_fit = 0;
      RAFT_UNROLL
      for (int k = 0; k < E; ++k) {
        const int s = (slot0 + k) % W;
        et[k] = L.log_term[s];
        ety[k] = L.log_type[s];
        eb[k] = k < n_send ? L.log_bytes[s] : 0;
        cum += eb[k];
        n_fit += cum <= c.max_size_per_msg;
      }
      n_send = n_send > 0 ? clampi(imin(n_send, n_fit), 1, E) : 0;
      int sent_bytes = 0;
      RAFT_UNROLL
      for (int k = 0; k < E; ++k) {
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
        RAFT_UNROLL
        for (int k = 0; k < E; ++k) {
          out.rep_ent_term[j][k] = et[k];
          out.rep_ent_type[j][k] = ety[k];
          out.rep_ent_bytes[j][k] = eb[k];
        }
      }
      update_on_entries_send(j, app_sel, n_send, sent_bytes);
    }
  }

  RAFT_HD void bcast_heartbeat(bool mask, int ctx) {
    RAFT_UNROLL
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
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) self_voter = self_voter || (voter(j) && is_self[j]);
    put_self(mask && self_voter, resp_t, ask_term, 0);
    const int lt = last_term();
    RAFT_UNROLL
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
  int v[kCounters];  // counter deltas
  int bucket;        // latency bucket of a sample closed this round, else -1
  int lat;           // its latency
};

struct Sampler {  // metrics/device.py samp_index / samp_round of this lane
  int index, round;
};

// One round of lane `L` on its routed inbox `in` (mute cut applied) into
// the cleared outbox `out`. round_ctr is the metrics round counter before
// this round; ev gets this lane's metric deltas. tick: the chaos build's
// tick mask (false: the clocks hold and no tick fires).
RAFT_HD void fused_round_lane(Lane &L, const Cfg &c, const InFab &in, const Ops &ops,
                              uint32_t cut, int flags, int lag,
                              int round_ctr, Sampler &samp, const Fab &out,
                              Events &ev, bool tick = true) {
  Round rd(L, c, in, out);
  const bool *is_self = rd.is_self;
  const bool metrics = flags & F_METRICS;
  RAFT_UNROLL
  for (int x = 0; x < kCounters; ++x) ev.v[x] = 0;
  ev.bucket = -1;
  ev.lat = 0;
  const int lead0 = L.lead, committed0 = L.committed;

  // ---- tick (raft.go:823-862) ----
  bool fire_hup = false, fire_beat = false, fire_cq = false;
  if (flags & F_TICK) {
    const bool is_leader0 = L.state == LEADER;
    int ee = L.election_elapsed + 1;
    int he = is_leader0 ? L.heartbeat_elapsed + 1 : L.heartbeat_elapsed;
#if RAFT_CHAOS
    if (!tick) {
      ee = L.election_elapsed;
      he = L.heartbeat_elapsed;
    }
#endif
    fire_hup = !is_leader0 && rd.promotable() && ee >= L.randomized_election_timeout;
#if RAFT_CHAOS
    fire_hup = fire_hup && tick;
    const bool lead_etick = is_leader0 && ee >= c.election_tick && tick;
#else
    const bool lead_etick = is_leader0 && ee >= c.election_tick;
#endif
    fire_cq = lead_etick && c.check_quorum;
    if (fire_hup || lead_etick) ee = 0;
    fire_beat = is_leader0 && he >= c.heartbeat_tick;
#if RAFT_CHAOS
    fire_beat = fire_beat && tick;
#endif
    if (fire_beat) he = 0;
    L.election_elapsed = ee;
    L.heartbeat_elapsed = he;
    if (lead_etick) L.lead_transferee = 0;
  }

  // ---- presence ----
  bool rep_p[V], hb_p[V], vote_p[V], vresp_p[V];
  RAFT_UNROLL
  for (int i = 0; i < V; ++i) {
    rep_p[i] = in.rep_kind[i] != MSG_NONE;
    hb_p[i] = in.hb_kind[i] != MSG_NONE;
    vote_p[i] = in.vote_kind[i] != MSG_NONE;
    vresp_p[i] = in.vresp_kind[i] != MSG_NONE;
  }
  const bool self_p = in.self_kind[0] != MSG_NONE;

  // ---- term ladder (raft.go:1053-1139) ----
  const bool in_lease =
      c.check_quorum && L.lead != 0 && L.election_elapsed < c.election_tick;
  bool is_vreq[V], lease_ignored[V];
  int t_new = 0;
  RAFT_UNROLL
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
  t_new = imax(t_new, (self_p && in.self_kind[0] == MSG_APP_RESP) ? in.self_term[0] : 0);
  const bool step_down = t_new > L.term;
  int ldr_member = 0;
  RAFT_UNROLL
  for (int i = 0; i < V; ++i) {
    const bool from_rep = rep_p[i] && in.rep_term[i] == t_new &&
                          (in.rep_kind[i] == MSG_APP || in.rep_kind[i] == MSG_SNAP);
    const bool from_hb = hb_p[i] && in.hb_term[i] == t_new && in.hb_kind[i] == MSG_HEARTBEAT;
    ldr_member = imax(ldr_member, (from_rep || from_hb) ? i + 1 : 0);
  }
  rd.become_follower(step_down, t_new, ldr_member);

  // lower-term handling (raft.go:1087-1139)
  bool rep_live[V], hb_live[V], vote_live[V];
  RAFT_UNROLL
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
  RAFT_UNROLL
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
    RAFT_UNROLL
    for (int k = 0; k < E; ++k) {
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
  rd.become_follower(any_app && is_cand, L.term, m_frm);
  if (any_app && L.state == FOLLOWER) {
    L.lead = m_frm;
    L.election_elapsed = 0;
  }
  rd.handle_append_entries(any_app && m.type == MSG_APP && L.state == FOLLOWER, m);
  const bool is_snap = any_app && m.type == MSG_SNAP;
  rd.handle_snapshot(is_snap, m);
  if (is_snap && L.pending_snap_index != 0) {
    L.applied = imax(L.applied, L.pending_snap_index);
    L.applying = imax(L.applying, L.pending_snap_index);
    L.pending_snap_index = 0;
    L.pending_snap_term = 0;
  }

  // ---- winning heartbeat (raft.go:1772-1775) ----
  bool any_hb = false;
  int hwin = 0;
  RAFT_UNROLL
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
  rd.become_follower(any_hb && is_cand, L.term, h_frm);
  if (any_hb && L.state == FOLLOWER) {
    L.lead = h_frm;
    L.election_elapsed = 0;
  }
  rd.handle_heartbeat(any_hb && L.state == FOLLOWER, h);

  // ---- vote casting: grant at most one candidate (raft.go:1164-1212) ----
  {
    const int lt = rd.last_term();
    bool grantable[V], is_pv[V], vreq_cell[V];
    bool any_real = false;
    int gwin = 0;
    RAFT_UNROLL
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
    RAFT_UNROLL
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
  RAFT_UNROLL
  for (int i = 0; i < V; ++i)
    ton = ton || (vote_live[i] && in.vote_kind[i] == MSG_TIMEOUT_NOW &&
                  in.vote_term[i] == L.term);
  ton = ton && L.state == FOLLOWER;

  // ---- leader fan-in ----
  bool is_leader = L.state == LEADER;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    const bool in_snap = is_leader && L.pr_state[j] == SNAPSHOT;
    if ((flags & F_MUTE) && in_snap && ((cut >> j) & 1u))
      L.pr_pending_snapshot[j] = 0;
    rd.become_probe(j, in_snap);
    if (in_snap) L.pr_msg_app_flow_paused[j] = true;
  }

  // MsgAppResp cells, including the self-ack (raft.go:1333-1526)
  const bool self_ar = self_p && in.self_kind[0] == MSG_APP_RESP &&
                       in.self_term[0] == L.term && is_leader;
  bool ar_cell[V], acc_cell[V], advanced[V], old_paused[V];
  int ar_index[V];
  bool advanced_lane = false;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    ar_cell[j] = rep_live[j] && in.rep_kind[j] == MSG_APP_RESP &&
                 in.rep_term[j] == L.term && is_leader;
    const bool self_ar_cell = self_ar && is_self[j];
    const bool ar_all = ar_cell[j] || self_ar_cell;
    ar_index[j] = self_ar_cell ? in.self_index[0] : in.rep_index[j];
    if (ar_all) L.pr_recent_active[j] = true;
    const bool rej_cell = ar_cell[j] && in.rep_reject[j];
    acc_cell[j] = ar_all && !rej_cell;
    const int next_probe = in.rep_log_term[j] > 0
                               ? rd.conflict_index(in.rep_reject_hint[j], in.rep_log_term[j])
                               : in.rep_reject_hint[j];
    const bool decreased = rd.maybe_decr_to(j, rej_cell, ar_index[j], next_probe);
    rd.become_probe(j, decreased && L.pr_state[j] == REPLICATE);
    rd.want_send(j, decreased, true);
    old_paused[j] = rd.is_paused(j);
    const bool updated = rd.maybe_update(j, acc_cell[j], ar_index[j]);
    const bool probe_refresh = acc_cell[j] && L.pr_match[j] == ar_index[j] &&
                               L.pr_state[j] == PROBE;
    advanced[j] = updated || probe_refresh;
    rd.become_replicate(j, advanced[j] && L.pr_state[j] == PROBE);
    const bool from_snap = advanced[j] && L.pr_state[j] == SNAPSHOT &&
                           L.pr_match[j] + 1 >= L.snap_index + 1;
    rd.become_probe(j, from_snap);
    rd.become_replicate(j, from_snap);
    rd.inflights_free_le(j, advanced[j] && L.pr_state[j] == REPLICATE, ar_index[j]);
    advanced_lane = advanced_lane || advanced[j];
  }

  // the commit index: one joint-quorum reduction per lane
  {
    int match[V];
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) match[j] = rd.voter(j) ? L.pr_match[j] : 0;
    const int mci = joint_committed<V>(match, L.voters_in, L.voters_out);
    const bool committed_adv = rd.maybe_commit(advanced_lane ? mci : 0, L.term);
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      rd.want_send(j, committed_adv, true);
      rd.want_send(j, advanced[j] && !committed_adv && !is_self[j], old_paused[j]);
    }
  }

  // leadership transfer completion (raft.go:1519-1524)
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    if (acc_cell[j] && advanced[j] && j + 1 == L.lead_transferee &&
        L.pr_match[j] == L.last) {
      out.vote_kind[j] = MSG_TIMEOUT_NOW;
      out.vote_term[j] = L.term;
    }
  }

  // MsgHeartbeatResp cells (raft.go:1527-1561)
  bool hr_cell[V];
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    hr_cell[j] = hb_live[j] && in.hb_kind[j] == MSG_HEARTBEAT_RESP &&
                 in.hb_term[j] == L.term && is_leader;
    if (hr_cell[j]) {
      L.pr_recent_active[j] = true;
      L.pr_msg_app_flow_paused[j] = false;
    }
    rd.want_send(j, hr_cell[j] && (L.pr_match[j] < L.last || L.pr_state[j] == PROBE), true);
  }

  // ReadIndex acks via heartbeat ctx (raft.go:1548-1561)
  {
    const int r = R;
    bool hit_any[R], release[R], put[R];
    bool acks[R][V];
    int won_seq = -1;
    RAFT_UNROLL
    for (int q = 0; q < r; ++q) {
      hit_any[q] = false;
      int ro_votes[V];
      RAFT_UNROLL
      for (int i = 0; i < V; ++i) {
        const bool hit = hr_cell[i] && L.ro_ctx[q] == in.hb_context[i] && L.ro_ctx[q] != 0;
        hit_any[q] = hit_any[q] || hit;
        acks[q][i] = L.ro_acks[q][i] || hit;
        ro_votes[i] = acks[q][i] ? GRANTED : PENDING;
      }
      const bool won = L.ro_ctx[q] != 0 && rd.joint_vote(ro_votes) == VOTE_WON && hit_any[q];
      won_seq = imax(won_seq, won ? L.ro_seq[q] : -1);
    }
    RAFT_UNROLL
    for (int q = 0; q < r; ++q) release[q] = L.ro_ctx[q] != 0 && L.ro_seq[q] <= won_seq;
    int dst_c[R];
    int n_put = 0;
    RAFT_UNROLL
    for (int q = 0; q < r; ++q) {
      int rank = 0;
      RAFT_UNROLL
      for (int p = 0; p < r; ++p) rank += release[p] && L.ro_seq[p] < L.ro_seq[q];
      const int dst_slot = L.rs_count + rank;
      put[q] = release[q] && dst_slot < r;
      dst_c[q] = clampi(dst_slot, 0, r - 1);
      n_put += put[q];
    }
    // ohm.scatter_set: a target slot takes the sum of the values put there
    int new_ctx[R], new_index[R];
    RAFT_UNROLL
    for (int t = 0; t < r; ++t) {
      bool hit = false;
      int vc = 0, vi = 0;
      RAFT_UNROLL
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
    RAFT_UNROLL
    for (int t = 0; t < r; ++t) {
      L.rs_ctx[t] = new_ctx[t];
      L.rs_index[t] = new_index[t];
    }
    L.rs_count = imin(L.rs_count + n_put, r);
    RAFT_UNROLL
    for (int q = 0; q < r; ++q) {
      if (put[q]) L.ro_ctx[q] = L.ro_from[q] = L.ro_index[q] = L.ro_seq[q] = 0;
      RAFT_UNROLL
      for (int i = 0; i < V; ++i) L.ro_acks[q][i] = put[q] ? false : acks[q][i];
    }
    ev.v[C_READ_INDEX_SERVED] += n_put;
  }

  // Msg(Pre)VoteResp cells -> poll (raft.go:1041-1049, 1647-1666)
  bool pre_won, real_won;
  {
    const int my_resp = L.state == PRE_CANDIDATE ? MSG_PRE_VOTE_RESP : MSG_VOTE_RESP;
    const bool self_vr = self_p && in.self_kind[0] == my_resp && is_cand;
    bool any_vr = false;
    RAFT_UNROLL
    for (int i = 0; i < V; ++i) {
      const bool live = vresp_p[i] && !(in.vresp_term[i] < L.term);
      const bool vr_cell = live && in.vresp_kind[i] == my_resp && is_cand;
      const bool vr_all = vr_cell || (self_vr && is_self[i]);
      const bool vr_rej = vr_cell && in.vresp_reject[i];
      if (vr_all && rd.voter(i)) L.votes[i] = vr_rej ? REJECTED : GRANTED;
      any_vr = any_vr || vr_all;
    }
    int votes[V];
    RAFT_UNROLL
    for (int i = 0; i < V; ++i) votes[i] = L.votes[i];
    const int res = rd.joint_vote(votes);
    const bool tallied = any_vr && is_cand;
    const bool won = tallied && res == VOTE_WON;
    const bool lost = tallied && res == VOTE_LOST;
    pre_won = won && L.state == PRE_CANDIDATE;
    real_won = won && L.state == CANDIDATE;
    rd.become_leader(real_won);
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) rd.want_send(j, real_won, true);
    rd.become_follower(lost, L.term, 0);
  }

  // ---- local inputs ----
  int ctype = c.pre_vote ? PRE_ELECTION : ELECTION;
  if (ton) ctype = TRANSFER;
  if (pre_won) ctype = ELECTION;
  const bool hup_fired = rd.hup(fire_hup || ops.hup || ton || pre_won, ctype);
  ev.v[C_ELECTIONS_STARTED] += hup_fired;
  ev.v[C_ELECTIONS_WON] += real_won;

  // CheckQuorum (raft.go:1231-1243)
  is_leader = L.state == LEADER;
  {
    const bool cq = fire_cq && is_leader;
    int active[V];
    RAFT_UNROLL
    for (int j = 0; j < V; ++j)
      active[j] = (L.pr_recent_active[j] || is_self[j]) ? GRANTED : REJECTED;
    const bool alive = rd.joint_vote(active) == VOTE_WON;
    rd.become_follower(cq && !alive, L.term, 0);
    RAFT_UNROLL
    for (int j = 0; j < V; ++j)
      if (cq && !is_self[j]) L.pr_recent_active[j] = false;
  }

  // heartbeats (MsgBeat) carry the newest pending ReadIndex ctx
  is_leader = L.state == LEADER;
  {
    int best = -1, newest = 0;
    bool any_live = false;
    RAFT_UNROLL
    for (int q = 0; q < R; ++q) {
      const int key = L.ro_ctx[q] != 0 ? L.ro_seq[q] : -1;
      any_live = any_live || L.ro_ctx[q] != 0;
      if (q == 0 || key > best) {
        best = key;
        newest = q;
      }
    }
    const int beat_ctx = any_live ? L.ro_ctx[newest] : 0;
    rd.bcast_heartbeat((fire_beat || ops.beat) && is_leader, beat_ctx);
  }

  // proposals (raft.go:1244-1302)
  {
    const int prop_n = (flags & F_AUTO_PROPOSE) ? imax(ops.prop_n, is_leader ? 1 : 0)
                                                : ops.prop_n;
    const bool prop = prop_n > 0 && is_leader && L.lead_transferee == 0 && rd.ss >= 0;
    const int pn = imin(prop_n, E);
    int zeros[E] = {0}, eb[E];
    RAFT_UNROLL
    for (int k = 0; k < E; ++k) eb[k] = (k < pn && prop) ? ops.prop_bytes : 0;
    const bool appended = rd.append_entry(prop, zeros, eb, pn);
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) rd.want_send(j, appended, true);
    ev.v[C_PROPOSALS] += appended ? pn : 0;
    ev.v[C_PROPOSALS_DROPPED] += prop_n > 0 && !appended;
    if (metrics && appended && samp.index == 0) {  // metrics.arm_sample
      samp.index = L.last;
      samp.round = round_ctr + 1;
    }
  }

  // conf-change proposal (raft.go:1259-1301)
  {
    const bool want_cc = ops.prop_cc > 0 && is_leader && L.lead_transferee == 0 && rd.ss >= 0;
    bool joint = false;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) joint = joint || L.voters_out[j];
    const bool pending_cc = L.pending_conf_index > L.applied;
    const bool refused = pending_cc || (ops.prop_cc == 2 ? !joint : joint);
    const bool cc_ok = want_cc && !refused;
    int zeros[E] = {0}, cc_type[E] = {0};
    cc_type[0] = cc_ok ? ENTRY_CONF_CHANGE_V2 : 0;
    const bool cc_appended = rd.append_entry(want_cc, cc_type, zeros, 1);
    if (cc_appended && cc_ok) L.pending_conf_index = L.last;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) rd.want_send(j, cc_appended, true);
    ev.v[C_PROPOSALS] += cc_appended;
    ev.v[C_PROPOSALS_DROPPED] += want_cc && (refused || !cc_appended);
  }

  // transfer-leadership request (raft.go:1587-1618)
  {
    const int tt = ops.transfer_to;
    const int t_slot = clampi(tt - 1, 0, V - 1);
    uint32_t known = 0;  // prs_id[t_slot] != 0 && !learners[t_slot] (see promotable)
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) known |= uint32_t(L.prs_id[j] != 0 && !L.learners[j]) << j;
    const bool t_known = (known >> t_slot) & 1u;
    const bool t_ok = is_leader && tt != 0 && tt != L.lead_transferee && tt != L.id &&
                      tt >= 1 && tt <= V && t_known;
    if (t_ok) {
      L.election_elapsed = 0;
      L.lead_transferee = tt;
    }
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      const bool t_cell = j == t_slot && t_ok;
      const bool t_ready = t_cell && L.pr_match[j] == L.last;
      if (t_ready) {
        out.vote_kind[j] = MSG_TIMEOUT_NOW;
        out.vote_term[j] = L.term;
      }
      rd.want_send(j, t_cell && !t_ready, true);
    }
  }

  // ReadIndex at the leader (raft.go:1303-1332)
  {
    const int r = R;
    const bool ri = ops.read_ctx != 0 && is_leader;
    const bool ri_ok = ri && rd.term_at(L.committed) == L.term;
    int n_in = 0, n_out = 0;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      n_in += L.voters_in[j];
      n_out += L.voters_out[j];
    }
    const bool single = n_in <= 1 && n_out == 0;
    const bool immediate = ri_ok && (single || c.read_only_lease_based);
    const bool enq = ri_ok && !immediate;
    bool any_free = false;
    int first_free = 0;
    RAFT_UNROLL
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
      RAFT_UNROLL
      for (int j = 0; j < V; ++j) L.ro_acks[q][j] = is_self[j];
      L.ro_seq[q] = L.ro_next_seq;
    }
    L.ro_next_seq += can_enq;
    rd.bcast_heartbeat(can_enq, ops.read_ctx);
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
  rd.maybe_send_append();

  // ---- synchronous persist + apply ----
  L.stabled = L.last;
  const int applied_bytes = rd.bytes_between(L.applied, L.committed);
  rd.applied_to(L.committed);
  L.uncommitted_size = imax(L.uncommitted_size - applied_bytes, 0);
  if (flags & F_LAG) {
    L.avail_snap_index = L.applied;
    L.avail_snap_term = rd.term_at(L.applied);
    const int target = imax(L.snap_index, L.applied - lag);
    rd.compact(target, rd.term_at(target));
  }

  if (!metrics) return;
  // ---- end-of-round measurement ----
  RAFT_UNROLL
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
    RAFT_UNROLL
    for (int x = 0; x < kBuckets - 1; ++x) b += lat > edges[x];
    ev.bucket = b;
    ev.lat = lat;
    samp.index = 0;
  }
}

}  // namespace raft

// ---------------------------------------------------------------------------
// the launch: kc rounds of every lane of a block, in phases separated by
// block barriers (the host build runs each phase over all lanes in turn)

namespace raft {

// what a thread keeps across the rounds
struct Thread {
  Lane L;
  Cfg c;
  Sampler samp;
  uint32_t cut;  // bit j: lane j of the group or this lane muted (the mute cut)
#if RAFT_PAGED
  int pg_faults;         // pages of this lane's table mapped at page-in
  int pg_last, pg_snap;  // last and snap_index at page-in
#endif
#if RAFT_CHAOS
  int ch_base, ch_reelect, ch_recommit;  // the probe columns (chaos/device.py PROBES)
  bool ch_wiped;  // wiped in a round of this launch: its through rows are zeroed
#endif
};

#if RAFT_CHAOS
// ---- chaos/device.py: the chaos plane of a lane ---------------------------

enum : uint32_t { SALT_DROP = 1, SALT_DUP = 5, SALT_TICK_SKEW = 9 };  // + channel

RAFT_HD uint32_t mix32(uint32_t x) {  // lowbias32
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// chaos_bits(seed, round, site, salt) and _decide: true with probability
// num / 2^16
RAFT_HD bool decide(uint32_t seed, int rnd, uint32_t idx, uint32_t salt, int num) {
  const uint32_t x = idx * 0x9E3779B9u + (uint32_t)rnd * 0x85EBCA6Bu + seed + salt * 0xC2B2AE35u;
  return num > 0 && (int)(mix32(x) & 0xFFFFu) < num;
}

RAFT_HD const int *knob(const Args &a, int k) { return (const int *)a.p[P_CH_KNOB + k]; }
// the chaos scalars: the launch's first round, heal_round, the seed
struct ChaosScalars {
  int round, heal;
  uint32_t seed;
};
RAFT_HD ChaosScalars chaos_scalars(const Args &a) {
  return {*(const int *)a.p[P_CH_ROUND], *(const int *)a.p[P_CH_HEAL],
          *(const uint32_t *)a.p[P_CH_SEED]};
}

// state.py wipe_volatile on the lane's registers and ring columns (every
// index a loop constant); the through rows pri_ctx / pri_from are zeroed
// at the store
RAFT_HD void wipe_lane(Lane &L, const Cfg &c) {
  L.state = FOLLOWER;
  L.lead = L.lead_transferee = L.uncommitted_size = 0;
  L.election_elapsed = L.heartbeat_elapsed = 0;
  L.rng = rng_next(L.rng);
  L.randomized_election_timeout = draw_timeout(L.rng, c.election_tick);
  L.stabled = L.last;
  L.applying = L.applied;
  L.pending_snap_index = L.pending_snap_term = 0;
  L.snap_unavailable = false;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    L.pr_match[j] = 0;
    L.pr_next[j] = 1;
    L.pr_state[j] = L.pr_pending_snapshot[j] = L.votes[j] = 0;
    L.pr_recent_active[j] = L.pr_msg_app_flow_paused[j] = false;
    L.infl_start[j] = L.infl_count[j] = L.infl_total_bytes[j] = 0;
    RAFT_UNROLL
    for (int f = 0; f < F; ++f) L.infl_index[j][f] = L.infl_bytes[j][f] = 0;
  }
  RAFT_UNROLL
  for (int r = 0; r < R; ++r) {
    L.ro_ctx[r] = L.ro_from[r] = L.ro_index[r] = L.ro_seq[r] = 0;
    L.rs_ctx[r] = L.rs_index[r] = 0;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) L.ro_acks[r][j] = 0;
  }
  L.ro_next_seq = 1;
  L.rs_count = 0;
}

// begin_round for lane i in round k of the launch: the crash-window wipe,
// the cut of each channel's inbound cells (the mute cut `th.cut`, the
// partition masks, a down endpoint, a drop draw per edge), whether the lane
// is down, its tick mask, and the probe's baseline at the heal round
RAFT_HD void chaos_begin(const Args &a, long long i, int k, Thread &th, uint32_t (&cut)[4],
                         bool &crashed, bool &tick) {
  const ChaosScalars sc = chaos_scalars(a);
  const int rnd = sc.round + k;
  const uint32_t seed = sc.seed;
  const int *crash_at = knob(a, CH_crash_at), *restart_at = knob(a, CH_restart_at);
  if (rnd == crash_at[i] || rnd == restart_at[i]) {
    wipe_lane(th.L, th.c);
    th.ch_wiped = true;
  }
  crashed = rnd >= crash_at[i] && rnd < restart_at[i];
  const long long base = i - i % V;
  const int recv = knob(a, CH_part_recv)[i];
  uint32_t cells = th.cut;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    const bool down = rnd >= crash_at[base + j] && rnd < restart_at[base + j];
    if ((knob(a, CH_part_send)[base + j] & recv) == 0 || crashed || down) cells |= 1u << j;
  }
  RAFT_UNROLL
  for (int ch = 0; ch < 4; ++ch) cut[ch] = cells;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    const int num = knob(a, CH_drop_num)[i * V + j];
    RAFT_UNROLL
    for (int ch = 0; ch < 4; ++ch)
      if (decide(seed, rnd, (uint32_t)(i * V + j), SALT_DROP + ch, num)) cut[ch] |= 1u << j;
  }
  tick = !crashed && !decide(seed, rnd, (uint32_t)i, SALT_TICK_SKEW, knob(a, CH_tick_skew_num)[i]);
  if (rnd == sc.heal) th.ch_base = th.L.committed;
}

// end_round's duplicate redelivery: where the draw fires, cell j of the
// outbox this round delivered (`prev`, untouched by the cuts) goes into
// the empty cell j of the new outbox `out`, every field of the channel
RAFT_HD void chaos_dup(const Args &a, const Fab &prev, const Fab &out, long long i, int k) {
  const ChaosScalars sc = chaos_scalars(a);
  const int rnd = sc.round + k;
  const uint32_t seed = sc.seed;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    const int num = knob(a, CH_dup_num)[i * V + j];
    const uint32_t edge = (uint32_t)(i * V + j);
    if (prev.rep_kind[j] != MSG_NONE && out.rep_kind[j] == MSG_NONE &&
        decide(seed, rnd, edge, SALT_DUP + 0, num)) {
      out.rep_kind[j] = prev.rep_kind[j];
      out.rep_term[j] = prev.rep_term[j];
      out.rep_index[j] = prev.rep_index[j];
      out.rep_log_term[j] = prev.rep_log_term[j];
      out.rep_commit[j] = prev.rep_commit[j];
      out.rep_reject[j] = prev.rep_reject[j];
      out.rep_reject_hint[j] = prev.rep_reject_hint[j];
      out.rep_n_ents[j] = prev.rep_n_ents[j];
      RAFT_UNROLL
      for (int e = 0; e < E; ++e) {
        out.rep_ent_term[j][e] = prev.rep_ent_term[j][e];
        out.rep_ent_type[j][e] = prev.rep_ent_type[j][e];
        out.rep_ent_bytes[j][e] = prev.rep_ent_bytes[j][e];
      }
      out.rep_snap_index[j] = prev.rep_snap_index[j];
      out.rep_snap_term[j] = prev.rep_snap_term[j];
    }
    if (prev.hb_kind[j] != MSG_NONE && out.hb_kind[j] == MSG_NONE &&
        decide(seed, rnd, edge, SALT_DUP + 1, num)) {
      out.hb_kind[j] = prev.hb_kind[j];
      out.hb_term[j] = prev.hb_term[j];
      out.hb_commit[j] = prev.hb_commit[j];
      out.hb_context[j] = prev.hb_context[j];
    }
    if (prev.vote_kind[j] != MSG_NONE && out.vote_kind[j] == MSG_NONE &&
        decide(seed, rnd, edge, SALT_DUP + 2, num)) {
      out.vote_kind[j] = prev.vote_kind[j];
      out.vote_term[j] = prev.vote_term[j];
      out.vote_index[j] = prev.vote_index[j];
      out.vote_log_term[j] = prev.vote_log_term[j];
      out.vote_reject[j] = prev.vote_reject[j];
      out.vote_context[j] = prev.vote_context[j];
    }
    if (prev.vresp_kind[j] != MSG_NONE && out.vresp_kind[j] == MSG_NONE &&
        decide(seed, rnd, edge, SALT_DUP + 3, num)) {
      out.vresp_kind[j] = prev.vresp_kind[j];
      out.vresp_term[j] = prev.vresp_term[j];
      out.vresp_reject[j] = prev.vresp_reject[j];
    }
  }
}

// end_round's recovery probe for lane t after the round's barrier: its
// group's flags (bit 0 a leader, bit 1 committed past the baseline, one
// byte a lane) record the first armed round of each
RAFT_HD void lane_probe(const Args &a, const Block &B, int k, int t, Thread &th) {
  const ChaosScalars sc = chaos_scalars(a);
  const int rnd = sc.round + k;
  const uint8_t *f = B.flag() + (t - t % V);
  uint32_t any = 0;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) any |= f[j];
  if (rnd >= sc.heal) {
    if (th.ch_reelect == NEVER && (any & 1u)) th.ch_reelect = rnd;
    if (th.ch_recommit == NEVER && (any & 2u)) th.ch_recommit = rnd;
  }
}

// a through row of lane i zeroed in the output (a wiped lane's pri_ctx,
// pri_from)
template <int K, typename ST>
RAFT_HD void zero_row(const Args &a, long long i) {
  using L = StateLeaf<K, ST>;
  typename L::T e[L::X];
  RAFT_UNROLL
  for (int q = 0; q < L::X; ++q) e[q] = 0;
  RowIO<typename L::T, L::X>::store((typename L::T *)a.p[P_STATE_OUT + K] + i * L::X, e);
}
#endif

// lane i (thread t of the block): its carry into registers and its rings'
// columns, its outbox row into fabric buffer 0, its config, sampler and
// mute bits
RAFT_HD void lane_load(const Args &a, const Block &B, long long i, int t, Thread &th) {
  load_lane(th.L, a, B, i, t);
  fab_rows(a, B, i, t, 0, true);
  load_cfg(th.c, a, i);
  th.samp.index = th.samp.round = 0;
  if (a.flags & F_METRICS) {
    th.samp.index = ((const int *)a.p[P_SAMP_INDEX_IN])[i];
    th.samp.round = ((const int *)a.p[P_SAMP_ROUND_IN])[i];
  }
  th.cut = 0;
  if (a.flags & F_MUTE) {
    const uint8_t *mute = (const uint8_t *)a.p[P_MUTE];
    const long long base = i - i % V;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) th.cut |= uint32_t(mute[base + j] != 0) << j;
    if (mute[i]) th.cut = (1u << V) - 1;
  }
#if RAFT_CHAOS
  th.ch_base = ((const int *)a.p[P_CH_PROBE_IN + CH_base_committed])[i];
  th.ch_reelect = ((const int *)a.p[P_CH_PROBE_IN + CH_reelect_round])[i];
  th.ch_recommit = ((const int *)a.p[P_CH_PROBE_IN + CH_recommit_round])[i];
  th.ch_wiped = false;
#endif
}

// round k of lane i (thread t): inbox in buffer k % 2, outbox in the other
RAFT_HD void lane_round(const Args &a, const Block &B, int k, long long i, int t, Thread &th,
                        int round_ctr, Events &ev) {
  const int src = k & 1;
  const Fab in = inbox(B, src, t);
  const Fab out = outbox(B, src ^ 1, t);
#if RAFT_CHAOS
  // the cuts as masks read through the inbox: the senders' cells stay
  // as sent, for their duplicate redelivery below
  uint32_t cut[4];
  bool crashed, tick;
  chaos_begin(a, i, k, th, cut, crashed, tick);
  InFab inb;
  static_cast<Fab &>(inb) = in;
  inb.rep_kind = KindCol{in.rep_kind.p, in.rep_kind.s, cut[0]};
  inb.hb_kind = KindCol{in.hb_kind.p, in.hb_kind.s, cut[1]};
  inb.vote_kind = KindCol{in.vote_kind.p, in.vote_kind.s, cut[2]};
  inb.vresp_kind = KindCol{in.vresp_kind.p, in.vresp_kind.s, cut[3]};
  inb.self_kind = KindCol{in.self_kind.p, in.self_kind.s, crashed ? 1u : 0u};
#else
  // the mute cut, at the read: only this lane reads its inbound cells
  RAFT_UNROLL
  for (int j = 0; j < V; ++j)
    if ((th.cut >> j) & 1u)
      in.rep_kind[j] = in.hb_kind[j] = in.vote_kind[j] = in.vresp_kind[j] = MSG_NONE;
#endif
  clear_fab(out);
  // the ops are read when a round applies them (not held across rounds)
  Ops ops;
  if ((a.flags & F_OPS) && (k == 0 || !(a.flags & F_OPS_ROUND0)))
    load_ops(ops, a, i);
  else
    clear_ops(ops);
#if RAFT_CHAOS
  if (crashed) clear_ops(ops);  // a down lane takes no host ops
  fused_round_lane(th.L, th.c, inb, ops, th.cut, a.flags, a.lag, round_ctr + k, th.samp, out,
                   ev, tick);
  chaos_dup(a, outbox(B, src, t), out, i, k);
  // the probe's flags, before the storage boundary clamps committed
  B.flag()[t] = uint8_t((th.L.state == LEADER ? 1u : 0u) |
                        (th.L.committed > th.ch_base ? 2u : 0u));
#else
  fused_round_lane(th.L, th.c, in, ops, th.cut, a.flags, a.lag, round_ctr + k, th.samp, out,
                   ev);
#endif
  // the carry crosses the storage boundary between rounds
  roundtrip_lane(th.L, out);
}

// after the rounds: lane i's carry, its last outbox (fabric buffer b) and
// its sampler to device memory; only this thread wrote any of them
RAFT_HD void lane_store(const Args &a, const Block &B, int b, long long i, int t,
                        const Thread &th) {
  store_lane(th.L, a, i);
  fab_rows(a, B, i, t, b, false);
  if (a.flags & F_METRICS) {
    ((int *)a.p[P_SAMP_INDEX_OUT])[i] = th.samp.index;
    ((int *)a.p[P_SAMP_ROUND_OUT])[i] = th.samp.round;
  }
#if RAFT_CHAOS
  ((int *)a.p[P_CH_PROBE_OUT + CH_base_committed])[i] = th.ch_base;
  ((int *)a.p[P_CH_PROBE_OUT + CH_reelect_round])[i] = th.ch_reelect;
  ((int *)a.p[P_CH_PROBE_OUT + CH_recommit_round])[i] = th.ch_recommit;
  if (th.ch_wiped) {
    zero_row<SL_pri_ctx, RAFT_ST_I32>(a, i);
    zero_row<SL_pri_from, RAFT_ST_I32>(a, i);
  }
#endif
}

RAFT_HD int *acc_row(const Block &B, int k) { return B.acc(k & 1); }

// The launch's arguments from a C entry's (table order; dims: n, v, w, e,
// f, r, kc, cta, pool rows per block (paged build, else 0)): false unless v..r are this library's Shape and the
// block is a multiple of v that divides n and takes at most S lanes.
RAFT_HD bool args_of(void *const *ptrs, int nptrs, const long long *dims, int flags, int lag,
                     Args &a, int &cta) {
  if (nptrs != kNumPtrs || dims[1] != V || dims[2] != W || dims[3] != E ||
      dims[4] != F || dims[5] != R || dims[7] < V || dims[7] > S || dims[7] % V ||
      dims[0] % dims[7] || dims[6] < 1)
    return false;
#if RAFT_PAGED
  if (dims[8] < KMAX + 1 || dims[8] > 65536) return false;
#else
  if (dims[8] != 0) return false;
#endif
  for (int p = 0; p < kNumPtrs; ++p) a.p[p] = ptrs[p];
  a.n = dims[0];
  a.kc = (int)dims[6];
  a.flags = flags;
  a.lag = lag;
  a.pool_rows = dims[8];
  cta = (int)dims[7];
  return true;
}

// round k's partials row from the block's sums, which are zeroed for
// round k + 2 (threads tid of nth); the chaos build's row has its
// recounts too
RAFT_HD void write_partials(const Args &a, const Block &B, int k, long long blk,
                            long long n_blocks, int tid, int nth) {
  int *acc = acc_row(B, k);
  int *row = (int *)a.p[P_PARTIALS] + ((long long)k * n_blocks + blk) * kPartialWidth;
  for (int x = tid; x < kPartialWidth; x += nth) {
#if RAFT_CHAOS
    // the recounts after the metrics slots, or at 0 without metrics: lanes
    // with a recorded round, over V (whole groups a block)
    const bool met = (a.flags & F_METRICS) && x < kPartUsed;
    const int xc = (a.flags & F_METRICS) ? kPartUsed : 0;
    const bool ch = x >= xc && x < xc + kChaosPart;
    const int from = ch ? kPartUsed + x - xc : x;
    row[x] = met ? acc[x] : ch ? acc[from] / V : 0;
    if (met || ch) acc[from] = 0;
#else
    row[x] = x < kPartUsed ? acc[x] : 0;
    if (x < kPartUsed) acc[x] = 0;
#endif
  }
}


#if RAFT_PAGED
// ---- ops/paged.py: the paged entry log of a lane ------------------------
// The index math of page_in / page_out on the lane's stored values (the
// ring columns hold them widened; the boundary has clamped them).

RAFT_HD constexpr int pool_leaf(int k) {
  return k == SL_log_term ? PG_pool_term : k == SL_log_type ? PG_pool_type : PG_pool_bytes;
}

// slot s of a log leaf's column from the pool: entry `ent` of the block's
// sub-pool where `mapped`, else zero (page_in's fallback, paged.py:245-249)
template <int K, typename ST>
RAFT_HD void slot_from_pool(const Args &a, const Col<ST> &x, int s, bool mapped, long long ent) {
  using T = typename StateLeaf<K, ST>::T;
  x[s] = mapped ? (ST)((const T *)a.p[P_PAGED_IN + pool_leaf(K)])[ent] : (ST)0;
}

// the resident tail row over the column: entry ir of (lo_res, last] sits
// in tail slot ir & (WRES - 1) and ring slot ir & (W - 1)
template <int K, typename ST>
RAFT_HD void tail_to_col(const Args &a, long long i, const Col<ST> &x, int last, int lo_res) {
  using T = typename StateLeaf<K, ST>::T;
  T e[WRES];
  RowIO<T, WRES>::load((const T *)a.p[P_STATE_IN + K] + i * WRES, e);
  RAFT_UNROLL
  for (int r = 0; r < WRES; ++r) {
    const int ir = last - ((last - r) & (WRES - 1));
    if (ir > lo_res) x[ir & (W - 1)] = (ST)e[r];
  }
}

// page_in (paged.py:222-258): lane i's W ring slots of the three log
// leaves from its tail, its page-table row and its block's sub-pool
// (rows [blk * pool_rows, (blk + 1) * pool_rows)); slots outside
// (snap, last] are zero. Keeps the lane's mapped pages (the faults bump)
// and its last / snap_index for the move test.
RAFT_HD void lane_page_in(const Args &a, long long i, long long blk, Thread &th) {
  Lane &L = th.L;
  const int last = L.last, snap = L.snap_index;
  const int lo_res = imax(snap, last - WRES);
  const uint16_t *pt = (const uint16_t *)a.p[P_PAGED_IN + PG_pt] + i * M;
  const long long seg = blk * a.pool_rows;
  int mapped = 0;
  RAFT_UNROLL
  for (int m = 0; m < M; ++m) mapped += pt[m] > 0;
  th.pg_faults = mapped;
  th.pg_last = last;
  th.pg_snap = snap;
  RAFT_UNROLL
  for (int s = 0; s < W; ++s) {
    const int idx = last - ((last - s) & (W - 1));
    const bool paged = idx > snap && idx <= lo_res;  // valid, not resident
    const int page = paged ? (int)pt[(idx >> LPE) & (M - 1)] : 0;
    const long long ent = (seg + page) * PE + (idx & (PE - 1));
    slot_from_pool<SL_log_term>(a, L.log_term, s, page > 0, ent);
    slot_from_pool<SL_log_type>(a, L.log_type, s, page > 0, ent);
    slot_from_pool<SL_log_bytes>(a, L.log_bytes, s, page > 0, ent);
  }
  tail_to_col<SL_log_term>(a, i, L.log_term, last, lo_res);
  tail_to_col<SL_log_type>(a, i, L.log_type, last, lo_res);
  tail_to_col<SL_log_bytes>(a, i, L.log_bytes, last, lo_res);
}

// the resident tail of a column (paged.py _resident_tail, :261-284)
template <int K, typename ST>
RAFT_HD void col_to_tail(const Args &a, long long i, const Col<ST> &x, int last, int lo_res) {
  using T = typename StateLeaf<K, ST>::T;
  T e[WRES];
  RAFT_UNROLL
  for (int r = 0; r < WRES; ++r) {
    const int ir = last - ((last - r) & (WRES - 1));
    e[r] = ir > lo_res ? (T)x[ir & (W - 1)] : (T)0;
  }
  RowIO<T, WRES>::store((T *)a.p[P_STATE_OUT + K] + i * WRES, e);
}

// pool row `row` of a log leaf: entries key * PE + c in (snap, lo_res],
// zeros elsewhere (paged.py:320-336)
template <int K, typename ST>
RAFT_HD void col_to_page(const Args &a, const Col<ST> &x, long long row, int key, int snap,
                         int lo_res) {
  using T = typename StateLeaf<K, ST>::T;
  T e[PE];
  RAFT_UNROLL
  for (int c = 0; c < PE; ++c) {
    const int ent = key * PE + c;
    e[c] = ent > snap && ent <= lo_res ? (T)x[ent & (W - 1)] : (T)0;
  }
  RowIO<T, PE>::store((T *)a.p[P_PAGED_OUT + pool_leaf(K)] + row * PE, e);
}

// the pages the lane's paged range (snap, lo_res] needs, and its first key
RAFT_HD int lane_need(const Lane &L, int &k_lo) {
  const int snap = L.snap_index, lo_res = imax(snap, (int)L.last - WRES);
  k_lo = (snap + 1) >> LPE;
  return lo_res > snap ? (lo_res >> LPE) - k_lo + 1 : 0;
}

// page_out / page_out_cond (paged.py:287-384) of lane i, after the rounds:
// its tail, its page-table row, its live pages and its counters. `moved`:
// the block reallocates; page0: the lane's first page id (1 + the
// exclusive scan of the block's needs). The block's rows no live page
// writes are block_pool's.
RAFT_HD void lane_page_out(const Args &a, long long i, long long blk, Thread &th, bool moved,
                           int page0) {
  Lane &L = th.L;
  const int last = L.last, snap = L.snap_index;
  const int lo_res = imax(snap, last - WRES);
  const int *const *in = (const int *const *)(a.p + P_PAGED_IN);
  int *const *out = (int *const *)(a.p + P_PAGED_OUT);
  out[PG_faults][i] = in[PG_faults][i] + th.pg_faults;
  col_to_tail<SL_log_term>(a, i, L.log_term, last, lo_res);
  col_to_tail<SL_log_type>(a, i, L.log_type, last, lo_res);
  col_to_tail<SL_log_bytes>(a, i, L.log_bytes, last, lo_res);
  const uint16_t *pt_in = (const uint16_t *)a.p[P_PAGED_IN + PG_pt] + i * M;
  uint16_t *pt_out = (uint16_t *)a.p[P_PAGED_OUT + PG_pt] + i * M;
  if (!moved) {  // the skip branch: table and pool as they were
    uint16_t e[M];
    RowIO<uint16_t, M>::load(pt_in, e);
    RowIO<uint16_t, M>::store(pt_out, e);
    out[PG_exhausted][i] = in[PG_exhausted][i];
    out[PG_dirty][i] = in[PG_dirty][i];
    out[PG_skipped][i] = in[PG_skipped][i] + 1;
    return;
  }
  int k_lo;
  const int need = lane_need(L, k_lo);
  const int n_alloc = imin(imax((int)a.pool_rows - page0, 0), need);
  const bool exh = n_alloc < need;
  if (exh) L.error_bits |= ERR_PAGE_EXHAUSTED;
  // slot mm holds key k_lo + ((mm - k_lo) & (M - 1)), live below n_alloc
  uint16_t e[M];
  RAFT_UNROLL
  for (int mm = 0; mm < M; ++mm) {
    const int j = (mm - k_lo) & (M - 1);
    e[mm] = (uint16_t)(j < n_alloc ? page0 + j : 0);
  }
  RowIO<uint16_t, M>::store(pt_out, e);
  const long long seg = blk * a.pool_rows;
  RAFT_UNROLL
  for (int j = 0; j < KMAX; ++j) {
    if (j >= n_alloc) break;
    const long long row = seg + page0 + j;
    col_to_page<SL_log_term>(a, L.log_term, row, k_lo + j, snap, lo_res);
    col_to_page<SL_log_type>(a, L.log_type, row, k_lo + j, snap, lo_res);
    col_to_page<SL_log_bytes>(a, L.log_bytes, row, k_lo + j, snap, lo_res);
  }
  out[PG_exhausted][i] = in[PG_exhausted][i] + (exh ? 1 : 0);
  out[PG_dirty][i] = in[PG_dirty][i] + n_alloc;
  out[PG_skipped][i] = in[PG_skipped][i];
}

template <typename T>
RAFT_HD void pool_rows_part(const Args &a, int leaf, long long seg, long long end, bool copy,
                            int tid, int nth) {
  const T *src = (const T *)a.p[P_PAGED_IN + leaf] + seg * PE;
  T *dst = (T *)a.p[P_PAGED_OUT + leaf] + seg * PE;
  for (long long x = tid; x < a.pool_rows * PE; x += nth) {
    const long long row = x / PE;
    if (copy)
      dst[x] = src[x];
    else if (row == 0 || row >= end)
      dst[x] = (T)0;
  }
}

// the block's sub-pool rows no lane wrote (threads tid of nth): copied
// through when the block skipped its allocator, else zeroed (the trash row
// 0, and the rows from 1 + the block's total need on, which the scan left
// unallocated)
RAFT_HD void block_pool(const Args &a, long long blk, bool moved, int total_need, int tid,
                        int nth) {
  using TT = typename StateLeaf<SL_log_term, int32_t>::T;
  using TY = typename StateLeaf<SL_log_type, int8_t>::T;
  using TB = typename StateLeaf<SL_log_bytes, int32_t>::T;
  const long long seg = blk * a.pool_rows;
  const long long end = 1 + (long long)total_need;
  pool_rows_part<TT>(a, PG_pool_term, seg, end, !moved, tid, nth);
  pool_rows_part<TY>(a, PG_pool_type, seg, end, !moved, tid, nth);
  pool_rows_part<TB>(a, PG_pool_bytes, seg, end, !moved, tid, nth);
}
#endif

}  // namespace raft

#ifdef __CUDACC__

namespace {

using namespace raft;

// the block's sums of round k: each counter summed over the warp, then one
// shared-memory atomic per warp (integer adds: exact in any order)
__device__ __forceinline__ void add_events(const Events &ev, int *acc, int t, int cta) {
  const int live = cta - (t & ~31);
  const unsigned mask = live >= 32 ? 0xffffffffu : (1u << live) - 1u;
  const bool leader = (t & 31) == 0;
#pragma unroll
  for (int x = 0; x < kCounters; ++x) {
    const int s = __reduce_add_sync(mask, ev.v[x]);
    if (leader && s) atomicAdd(&acc[x], s);
  }
#pragma unroll
  for (int x = 0; x < kBuckets; ++x) {
    const int s = __reduce_add_sync(mask, ev.bucket == x ? 1 : 0);
    if (leader && s) atomicAdd(&acc[C_HIST0 + x], s);
  }
  const int s = __reduce_add_sync(mask, ev.lat);
  if (leader && s) atomicAdd(&acc[C_LAT_SUM], s);
}

#if RAFT_CHAOS
// the chaos build's recounts: lanes with a recorded reelect / recommit
// round, summed over the warp and added to the block's slots
__device__ __forceinline__ void add_recounts(const Thread &th, int *acc, int t, int cta) {
  const int live = cta - (t & ~31);
  const unsigned mask = live >= 32 ? 0xffffffffu : (1u << live) - 1u;
  const int s0 = __reduce_add_sync(mask, th.ch_reelect != NEVER ? 1 : 0);
  const int s1 = __reduce_add_sync(mask, th.ch_recommit != NEVER ? 1 : 0);
  if ((t & 31) == 0) {
    if (s0) atomicAdd(&acc[kPartUsed], s0);
    if (s1) atomicAdd(&acc[kPartUsed + 1], s1);
  }
}
#endif

#if RAFT_PAGED
// The exclusive prefix sum of x over the block's threads, and its total:
// an inclusive scan within each warp by shuffles, then the warp totals
// through one shared row (a block is one allocation segment, at most
// kMaxCta lanes).
__device__ __forceinline__ int block_exclusive_scan(int x, int *warp_tot, int t, int cta,
                                                    int &total) {
  const int live = cta - (t & ~31);
  const unsigned mask = live >= 32 ? 0xffffffffu : (1u << live) - 1u;
  const int lane = t & 31, warp = t >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(mask, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31 || t == cta - 1) warp_tot[warp] = v;
  __syncthreads();
  int base = 0, sum = 0;
  for (int w = 0; w * 32 < cta; ++w) {
    const int s = warp_tot[w];
    if (w < warp) base += s;
    sum += s;
  }
  total = sum;
  return base + v - x;
}

// page_out_cond for the block (paged.py:357-384): one barrier decides
// whether any lane's last or snap_index moved since page-in; if so the
// allocator runs (the block scan of the lanes' needs gives each its first
// page), else the tables and the sub-pool are copied through
__device__ __forceinline__ void page_out_block(const Args &a, const Block &B, long long blk,
                                               long long i, int t, int cta, Thread &th) {
  const bool moved =
      !kCanSkip || __syncthreads_or(th.L.last != th.pg_last || th.L.snap_index != th.pg_snap);
  int total = 0, page0 = 1;
  if (moved) {
    int k_lo;
    page0 = 1 + block_exclusive_scan(lane_need(th.L, k_lo), B.scan(), t, cta, total);
  }
  lane_page_out(a, i, blk, th, moved, page0);
  block_pool(a, blk, moved, total, t, cta);
}
#endif

// blocks of this library that fit an SM's 228 KB of shared memory (1 KB of
// it reserved per block): the register budget keeps that occupancy
constexpr int kBlocksPerSm = imax(1, imin(8, (int)(233472 / (Block::bytes + 1024))));

__global__ void __launch_bounds__(S, kBlocksPerSm) round_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, cta = blockDim.x;
  const long long blk = blockIdx.x, i = blk * cta + t;
  const bool metrics = a.flags & F_METRICS;
  const Block B{smem};
  for (int x = t; x < 2 * kAccN; x += cta) acc_row(B, x / kAccN)[x % kAccN] = 0;
  Thread th;
  lane_load(a, B, i, t, th);
#if RAFT_PAGED
  lane_page_in(a, i, blk, th);
#endif
  const int round_ctr = metrics ? *(const int *)a.p[P_ROUND_CTR] : 0;
  __syncthreads();  // every lane's outbox is in buffer 0
  for (int k = 0; k < a.kc; ++k) {
    Events ev;
    lane_round(a, B, k, i, t, th, round_ctr, ev);
    if (metrics) add_events(ev, acc_row(B, k), t, cta);
    // this round's outbox and sums are complete, and every read of its
    // inbox (the next round's outbox) is done
    __syncthreads();
#if RAFT_CHAOS
    // the probe reads its group's flags; once every lane has read them and
    // added its recounts, the row is written (and the flags free again)
    lane_probe(a, B, k, t, th);
    add_recounts(th, acc_row(B, k), t, cta);
    __syncthreads();
    write_partials(a, B, k, blk, gridDim.x, t, cta);
#else
    if (metrics) write_partials(a, B, k, blk, gridDim.x, t, cta);
#endif
  }
#if RAFT_PAGED
  page_out_block(a, B, blk, i, t, cta, th);  // sets ERR_PAGE_EXHAUSTED before the store
#endif
  lane_store(a, B, a.kc & 1, i, t, th);  // the last round wrote buffer kc % 2
}

// The kernel's dynamic shared memory above 48 KB, enabled once.
cudaError_t enable_smem() {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Block::bytes);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

}  // namespace

// ptrs: kNumPtrs device pointers in table order; dims: n, v, w, e, f, r,
// kc, cta (lanes per CUDA block: a multiple of v that divides n, at most
// S), pool rows per block (the paged build's allocation segment, else 0). v..r must be the Shape this library was built for. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int raft_round(void *const *ptrs, int nptrs, const long long *dims,
                          int flags, int lag, void *stream) {
  Args a;
  int cta;
  if (!args_of(ptrs, nptrs, dims, flags, lag, a, cta)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = enable_smem();
  if (e != cudaSuccess) return (int)e;
  round_kernel<<<(unsigned)(a.n / cta), (unsigned)cta, (size_t)Block::bytes,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// For a CUDA block of cta lanes: out = {shared-memory bytes, resident
// blocks per SM, registers per thread, local (stack) bytes per thread}.
extern "C" int raft_round_info(long long cta, long long *out) {
  if (cta < 1 || cta > S) return (int)cudaErrorInvalidValue;
  cudaError_t e = enable_smem();
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, round_kernel, (int)cta,
                                                    (size_t)Block::bytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, round_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = Block::bytes;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (long long)attr.localSizeBytes;
  return 0;
}

#else  // a host build of the same phases, block by block, lane by lane

#include <vector>

namespace {

using namespace raft;

int round_host(const Args &a, int cta) {
  const long long n_blocks = a.n / cta;
  const bool metrics = a.flags & F_METRICS;
  const int round_ctr = metrics ? *(const int *)a.p[P_ROUND_CTR] : 0;
  std::vector<Bits<16>> buf((Block::bytes + 15) / 16);
  const Block B{(unsigned char *)buf.data()};
  std::vector<Thread> th(cta);
  for (long long blk = 0; blk < n_blocks; ++blk) {
    for (int x = 0; x < 2 * kAccN; ++x) acc_row(B, x / kAccN)[x % kAccN] = 0;
    for (int t = 0; t < cta; ++t) {
      lane_load(a, B, blk * cta + t, t, th[t]);
#if RAFT_PAGED
      lane_page_in(a, blk * cta + t, blk, th[t]);
#endif
    }
    for (int k = 0; k < a.kc; ++k) {
      int *acc = acc_row(B, k);
      for (int t = 0; t < cta; ++t) {
        Events ev;
        lane_round(a, B, k, blk * cta + t, t, th[t], round_ctr, ev);
        if (!metrics) continue;
        for (int x = 0; x < kCounters; ++x) acc[x] += ev.v[x];
        if (ev.bucket >= 0) acc[C_HIST0 + ev.bucket] += 1;
        acc[C_LAT_SUM] += ev.lat;
      }
#if RAFT_CHAOS
      for (int t = 0; t < cta; ++t) {
        lane_probe(a, B, k, t, th[t]);
        acc[kPartUsed] += th[t].ch_reelect != NEVER;
        acc[kPartUsed + 1] += th[t].ch_recommit != NEVER;
      }
      for (int t = 0; t < cta; ++t) write_partials(a, B, k, blk, n_blocks, t, cta);
#else
      if (metrics)
        for (int t = 0; t < cta; ++t) write_partials(a, B, k, blk, n_blocks, t, cta);
#endif
    }
#if RAFT_PAGED
    // page_out_block, its barrier and scan as loops over the block's lanes
    bool moved = !kCanSkip;
    for (int t = 0; t < cta; ++t)
      moved = moved || th[t].L.last != th[t].pg_last || th[t].L.snap_index != th[t].pg_snap;
    int total = 0;
    std::vector<int> page0(cta, 1);
    for (int t = 0; moved && t < cta; ++t) {
      int k_lo;
      page0[t] = 1 + total;
      total += lane_need(th[t].L, k_lo);
    }
    for (int t = 0; t < cta; ++t) lane_page_out(a, blk * cta + t, blk, th[t], moved, page0[t]);
    block_pool(a, blk, moved, total, 0, 1);
#endif
    for (int t = 0; t < cta; ++t) lane_store(a, B, a.kc & 1, blk * cta + t, t, th[t]);
  }
  return 0;
}

}  // namespace

extern "C" int raft_round_host(void *const *ptrs, int nptrs, const long long *dims,
                               int flags, int lag) {
  Args a;
  int cta;
  if (!args_of(ptrs, nptrs, dims, flags, lag, a, cta)) return 1;
  return round_host(a, cta);
}

#endif

// The Shape and stride this library was built for ({v, w, e, f, r, s})
// and the bytes of shared memory its CUDA block takes.
extern "C" void raft_round_shape(long long *out) {
  const long long s[6] = {raft::V, raft::W, raft::E, raft::F, raft::R, raft::S};
  for (int x = 0; x < 6; ++x) out[x] = s[x];
}

extern "C" long long raft_round_smem() { return raft::Block::bytes; }

// 1 for the diet-v2 build (the packed carry in device memory), else 0.
extern "C" int raft_round_diet() { return RAFT_DIET; }

// 1 for the chaos build (its knob, probe and scalar pointers close the
// table), else 0.
extern "C" int raft_round_chaos() { return RAFT_CHAOS; }

// The paged build's geometry {1, WRES, PE, M}, or {0, 0, 0, 0}.
extern "C" void raft_round_paged(long long *out) {
#if RAFT_PAGED
  const long long g[4] = {1, raft::WRES, raft::PE, raft::M};
#else
  const long long g[4] = {0, 0, 0, 0};
#endif
  for (int x = 0; x < 4; ++x) out[x] = g[x];
}
