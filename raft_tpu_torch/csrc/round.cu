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
//   back is clamped before the boundary. Every value is in range when a
//   round starts, so the boundary clamps the registers, the outbox and
//   only the ring slots the round wrote (Mid).
// - Shared memory, element e of lane t at [e * s + t]: the rings indexed
//   by data (log window, inflights, ReadIndex queues; s = S, so a warp
//   hits 32 banks whatever elements its threads pick), in their slim
//   dtypes, which hold every value the reference stores there; one fabric
//   buffer (s = S + 1, so the routed reads of a group's V senders fall in
//   distinct banks); and a staging column of V + 4 ints a lane (s = S) for
//   the writes a round holds between its halves. About 550 B per lane at
//   the bench shape: 96 lanes a block, four blocks (12 warps) an SM, so
//   that a grid of 528 blocks runs in one wave.
// - Fabric on-chip across the K rounds, in one buffer: lane g*V+j reads
//   its inbound cell i straight from the outbox of lane g*V+i, slot j, with
//   the mute cut applied to its own inbound cells (sender or receiver
//   muted; the self slot passes through). A round runs in two halves
//   (lane_read, lane_write) with a __syncthreads() between them and one
//   after: the read half runs the round up to its last read of the inbox
//   and holds the outbox writes it makes (which cells in registers, Mid;
//   the values that are not the lane's term in its staging column), and
//   the write half clears the lane's own cells, writes the held ones and
//   runs the rest of the round into them. A group of V lanes straddles
//   warps, so the barrier is the block's. Only the last round's outbox is
//   stored.
// - Device memory: each thread moves its own lane's rows (16-byte
//   accesses where a row allows; a warp's 32 neighbouring rows use every
//   sector it fetches) and writes its own shared-memory columns, so the
//   load and the store need no barrier and no index arithmetic. (A copy by
//   the whole block, each leaf's chunk transposed through shared memory,
//   made a one-round launch 3.7x slower: PERF.md, PR 3.)
// - The paged build (-DRAFT_PAGED=1 with RAFT_WRES, RAFT_PE, RAFT_M: the
//   paged entry log of ops/paged.py, paged in the kernel). An allocation
//   segment is the engine's lane tile, as in the JAX package: `bps`
//   consecutive CUDA blocks whose lanes' page tables address the
//   segment's own sub-pool of `pool_rows` rows (row 0 its trash row). The
//   log leaves' device rows are the resident [W_res] tails; each thread
//   rebuilds its lane's W ring columns from its tail, its page-table row
//   and the sub-pool (page_in), the rounds run unchanged, and after the
//   last one each block takes, with one barrier, whether any of its lanes'
//   last or snap_index moved, and the exclusive scan of its lanes' page
//   demands (warp shuffles, one shared row of warp totals). A segment of
//   several blocks then meets at a barrier in device memory: each block
//   publishes one 64-bit word (the launch's epoch, its `moved`, its total
//   demand) and waits with acquire loads until every block of its segment
//   has published; the OR of the words decides page_out_cond for the
//   segment, and their sum below the block is its first page. So that a
//   waiting block never holds a slot a block of its own segment needs, a
//   block takes its place (its logical id, hence its lanes) from a ticket
//   counter when it starts, not from blockIdx: every lower id has
//   started, and a segment whose blocks fit the card at once completes
//   (round_cuda.py checks that they do). If no lane of the segment moved
//   (and E <= W_res) the tables and the sub-pool are copied through; else
//   the segment reallocates from scratch (page_out): its lanes' pages
//   written from 1 + the scan, and every other row of the sub-pool zeroed,
//   each block taking an even share of the rows, with ERR_PAGE_EXHAUSTED
//   on a lane that did not fit. Built with and without RAFT_DIET, and
//   with RAFT_CHAOS.
// - The chaos build (-DRAFT_CHAOS=1: the chaos plane of
//   raft_tpu_torch/chaos/device.py, replacing the chaos branch of the
//   Pallas kernel, :616-634, :670-700, :728-730). Per lane and in-kernel
//   round (absolute round = the launch's first round + k): at a crash or
//   restart round the lane's registers and ring columns are wiped
//   (wipe_lane); its inbound cells are cut by the partition masks, a down
//   endpoint and one drop draw per channel and edge, as bits of a mask per
//   channel read through the inbox (InFab), so that no sender's cell is
//   written; a down or skipped lane does not tick; the write half clears a
//   peer cell at its first write (Round::touch), so that after the round a
//   cell it did not write still holds the lane's previous outbox, which
//   stays where the duplicate draw fires and is cleared elsewhere
//   (chaos_end), before the storage boundary; and the recovery probe
//   reads its group's has-a-leader and committed-past-base flags from a
//   byte a lane, written before the round's last barrier and read after
//   it, then one more barrier before the partials row takes the block's
//   recounts. The draws are
//   chaos/device.py's counter-based hash on the global lane (i), so
//   blocks and K do not change them. No knob changes inside a launch, so
//   a lane reads its crash, restart and partition columns once, at its
//   load, into facts of the launch (chaos_facts; kc <= 64): its down
//   window in the launch's rounds, in a word of shared memory its group
//   reads, and its wipe rounds, the partition's cut and its probe's
//   recorded rounds as bits above the mute cut; a round tests bits and
//   loads its drop, duplicate or skew numerators only where one is
//   nonzero. The probe's baseline, which changes only at the heal round,
//   sits in shared memory beside the launch's scalars. With RAFT_PAGED
//   (round_kernel_chaos_paged, replacing :589-730) the lane pages in,
//   runs the chaos rounds and pages out: a crash wipe keeps the log and
//   its cursors (state.py wipe_volatile), so the probe's barriers inside
//   the rounds and the segment barrier after them never meet.
// - The lease build (-DRAFT_LEASE=1: the leader-lease plane of
//   raft_tpu_torch/ops/lease.py, replacing the Pallas kernel's lease branch:
//   the lease leaves of its carry, :486, and fused_round's lease tail,
//   raft_tpu/ops/fused.py:1470-1497, run from :676). Composes with every
//   other flag. Each round ends in the lease tail on the round's final
//   role, transfer and confchange state: the round's append and heartbeat
//   ack cells, kept as a V-bit mask (Events::ack) from their phases to the
//   round's end, with the self slot, vote a joint quorum; the countdown
//   and the skew ride in registers, and the epoch and the four event
//   counters live in their output rows (copied there at load, updated in
//   place on an event: one owner a lane). The margin is a launch argument
//   (Args::margin), so one build serves every margin. A crash or restart
//   wipe zeroes the countdown and the skew (state.py wipe_volatile); a
//   chaos tick the lane skipped counts as skew (skipped_tick).
// - The commit index and vote tallies are per lane over its own [V]
//   progress rows: raft::joint_committed / reduce_half<V> of quorum.cuh,
//   shared with quorum.cu.
// - Metrics: each counter summed across the warp (redux) and added to the
//   block's shared row with one atomic per warp; exact in any order. One
//   partials row per (round, block); the rows are summed outside.
// - The stamp build (-DRAFT_STAMPS=1 beside any flags: a measuring twin,
//   never launched by the engine). Thread 0 of each block writes its row
//   of one more pointer, int64 [blocks, kStampSlots + kc]: clock64() at
//   every phase boundary (ticket, load, page-in, each round's last
//   barrier, store, block scan, segment barrier, page-out, pool pass),
//   each after a block barrier (one the build adds where the kernel has
//   none, so that a phase ends with the block's slowest thread),
//   %globaltimer where blocks must line up (start, end, around the
//   segment barrier), its SM, and the laps, each thread's cycles in the
//   parts of a round (chaos_begin, the round proper in both halves,
//   chaos_end with the probe flag, the storage boundary, lane_probe)
//   summed and maxed over the block. A stamp marks when thread 0 issued a phase, not when its
//   loads landed: a load's latency shows in the phase that first uses it.
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

// The lease build's columns (ops/lease.py LEASE_STATE_FIELDS: RaftState's
// fields after cfg), in pointer order, in and out, and the diet-v2 rows of
// the three the packed carry narrows (the counters stay int32).
#define RAFT_LEASE_FIELDS(X)         \
  X(lease_left, I32, LANE)           \
  X(lease_epoch, I32, LANE)          \
  X(lease_skew, I32, LANE)           \
  X(lease_grants, I32, LANE)         \
  X(lease_renewals, I32, LANE)       \
  X(lease_revocations, I32, LANE)    \
  X(lease_skew_revocations, I32, LANE)

#define RAFT_LEASE_DIET(X)           \
  X(lease_left, U16, LANE)           \
  X(lease_epoch, U16, LANE)          \
  X(lease_skew, U16, LANE)

#ifndef RAFT_DIET
#define RAFT_DIET 0
#endif

#ifndef RAFT_PAGED
#define RAFT_PAGED 0
#endif

#ifndef RAFT_CHAOS
#define RAFT_CHAOS 0
#endif

#ifndef RAFT_LEASE
#define RAFT_LEASE 0
#endif

#ifndef RAFT_STAMPS
#define RAFT_STAMPS 0
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

#define RAFT_ENUM_LEASE(name, dt, shape) LS_##name,
enum : int { RAFT_LEASE_FIELDS(RAFT_ENUM_LEASE) kLeaseN };
#undef RAFT_ENUM_LEASE

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
  P_SEG = P_PAGED_OUT + 8,         // [1 + n / cta] u64: the segment barrier's
                                   // ticket and words (paged build, bps > 1)
  P_CH_KNOB,                       // the chaos build only: its knob columns,
  P_CH_PROBE_IN = P_CH_KNOB + kChaosKnobs,  // the probe columns in,
  P_CH_ROUND = P_CH_PROBE_IN + kChaosProbes, // [] i32 the launch's first round,
  P_CH_HEAL,                                 // [] i32 heal_round,
  P_CH_SEED,                                 // [] u32 the PRNG stream,
  P_CH_PROBE_OUT,                            // the probe columns out
  // the lease build only: its columns in (LS_* order), then out
  P_LEASE_IN = RAFT_CHAOS ? P_CH_PROBE_OUT + kChaosProbes : P_CH_KNOB,
  P_LEASE_OUT = P_LEASE_IN + kLeaseN,
  P_STAMPS = RAFT_LEASE ? P_LEASE_OUT + kLeaseN : P_LEASE_IN,  // the stamp build only:
                                   // [blocks, kStampSlots + kc] i64, a row a block
  kNumPtrs = P_STAMPS + (RAFT_STAMPS ? 1 : 0)
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
// The chaos build's rounds a launch: its facts of a launch hold round
// numbers relative to the launch's first in 7 bits (pallas_round.py
// MAX_ROUNDS_PER_CALL).
constexpr int kMaxChaosRounds = 64;
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
constexpr int EPOCH_WRAP = 1 << 15;  // ops/lease.py: lease_epoch wraps here
constexpr long long kMaxMargin = 1 << 20;  // the lease margins a launch takes

// The stamp build's row of a block (logical id), thread 0's stamps: clock64()
// at each phase boundary, after a block barrier where the phase has none of
// its own (so a phase ends with the block's slowest thread), %globaltimer
// (ns) where blocks must line up, and
// the in-round laps, each thread's cycles in a part of a round summed
// over the launch, reduced over the block (sum and max); round k's clock
// after its last barrier at kStampSlots + k.
enum : int {
  ST_GT_START = 0, ST_START, ST_SMID, ST_TICKET, ST_LOAD, ST_PAGE_IN, ST_LOADED, ST_STORE,
  ST_SCAN, ST_GT_SEG_IN, ST_GT_SEG_OUT, ST_SEGMENT, ST_PAGE_OUT, ST_POOL, ST_END, ST_GT_END,
  ST_LAPS,
};
// the laps: chaos_begin; the round proper (round_read, and clear_fab, ops,
// round_write, the lease tail); chaos_end and the probe flag; the storage boundary
// (roundtrip_lane); and lane_probe with the recounts, after the round's
// barrier
enum : int { LAP_BEGIN, LAP_ROUND, LAP_DUP, LAP_BOUNDARY, LAP_PROBE, kLaps };
constexpr int kStampSlots = ST_LAPS + 2 * kLaps;

struct Args {
  void *p[kNumPtrs];
  long long n;
  int kc;     // rounds in this launch
  int flags;
  int lag;    // auto_compact_lag when F_LAG
  long long pool_rows;  // pool rows per allocation segment (paged build), else 0
  int bps;              // CUDA blocks per allocation segment (paged build), else 1
  uint32_t epoch;       // this launch's tag of the segment words (bps > 1)
  int margin;           // the lease margin (lease build), else 0
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
enum : int { G_STATE, G_CFG, G_FAB, G_LEASE };
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
#define RAFT_STORE_LEASE(name, dt, shape) RAFT_STORE_ROW(G_LEASE, LS_##name, dt, shape)
RAFT_STATE_DIET(RAFT_STORE_STATE)
RAFT_CFG_DIET(RAFT_STORE_CFG)
RAFT_FABRIC_DIET(RAFT_STORE_FAB)
RAFT_LEASE_DIET(RAFT_STORE_LEASE)
#undef RAFT_STORE_ROW
#undef RAFT_STORE_STATE
#undef RAFT_STORE_CFG
#undef RAFT_STORE_FAB
#undef RAFT_STORE_LEASE
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

// the paged build's shared ints after the warp totals of its block scan
enum : int { SC_LID = kMaxCta / 32, SC_MOVED, SC_PREFIX, SC_TOTAL, kScanSlots };

// A lane's staging column (Held): the values of the outbox writes its
// round's read half holds for its write half, int32 elements in this
// order, the vote responses' terms last (one a cell)
enum : int { HV_REP_INDEX, HV_REP_HINT, HV_REP_LOG_TERM, HV_HB_CONTEXT, HV_VR_TERM };
constexpr int kStage = HV_VR_TERM + V;

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

// Byte offsets into the block's buffer, compile-time constants. Element e
// of lane t of a leaf in shared memory sits at column[e * s + t]: s = sr =
// S for the rings and the staging columns, s = sf = S + 1 for the fabric.
struct Block {
  unsigned char *base;
  static constexpr int sr = S, sf = S + 1;
  static constexpr long long ring32 = 0;
  static constexpr long long ring8 = ring32 + pad16(4LL * kRing32 * sr);
  static constexpr long long fab32 = ring8 + pad16((long long)kRing8 * sr);
  static constexpr long long fab8 = fab32 + pad16(4LL * kFab32 * sf);
  static constexpr long long stage0 = fab8 + pad16((long long)kFab8 * sf);
  static constexpr long long acc0 = stage0 + pad16(4LL * kStage * sr);
  static constexpr long long acc_bytes = pad16(4LL * kAccN);
  // the paged build's warp totals of its block scan, then the block's
  // logical id and its segment's moved, prefix and total (kScanSlots)
  static constexpr long long scan0 = acc0 + 2 * acc_bytes;
  // the chaos build's probe flags, a byte a lane
  static constexpr long long flag0 = scan0 + (RAFT_PAGED ? pad16(4LL * kScanSlots) : 0);
  // the chaos build's facts of the launch: a word a lane (its down window
  // and the knobs it draws on, chaos_facts), the probe's baseline a lane,
  // and the launch's scalars (first round, heal_round, seed)
  static constexpr long long fact0 = flag0 + (RAFT_CHAOS ? pad16(S) : 0);
  static constexpr long long base0 = fact0 + (RAFT_CHAOS ? pad16(4LL * S) : 0);
  static constexpr long long csc0 = base0 + (RAFT_CHAOS ? pad16(4LL * S) : 0);
  // the stamp build's lap sums (sum, max), reduced at the launch's end
  static constexpr long long lap0 = csc0 + (RAFT_CHAOS ? 16 : 0);
  static constexpr long long bytes = lap0 + (RAFT_STAMPS ? pad16(8LL * kLaps) : 0);

  RAFT_HD Col<int> stage(int t) const { return Col<int>{(int *)(base + stage0) + t, sr}; }
  RAFT_HD int *acc(int b) const { return (int *)(base + acc0 + b * acc_bytes); }
  RAFT_HD int *scan() const { return (int *)(base + scan0); }
  RAFT_HD uint8_t *flag() const { return base + flag0; }
  RAFT_HD uint32_t *fact() const { return (uint32_t *)(base + fact0); }
  RAFT_HD int *probe_base() const { return (int *)(base + base0); }
  RAFT_HD int *chaos_sc() const { return (int *)(base + csc0); }
  RAFT_HD unsigned *laps() const { return (unsigned *)(base + lap0); }
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

// column of fabric leaf K in the fabric
template <int K, typename ST>
RAFT_HD ST *fab_col(const Block &B) {
  constexpr int o32 = set_off(kFabLeaves, K, SET_FAB, true);
  constexpr int o8 = set_off(kFabLeaves, K, SET_FAB, false);
  return col_at<ST>(B, B.fab32, B.fab8, o32, o8, B.sf);
}

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

// lane t's outbox row of fabric leaf K: in from the input fabric, or out
// to the output fabric
template <int K, typename ST, int KIND>
RAFT_HD void fab_row(const Args &a, const Block &B, long long i, int t, bool in) {
  using T = typename Store<G_FAB, K, ST>::T;
  ST *col = fab_col<K, ST>(B) + t;
  if (in)
    row_to_col<T, elems(KIND)>((const T *)a.p[P_FAB_IN + K], i, col, B.sf);
  else
    col_to_row<T, elems(KIND)>((T *)a.p[P_FAB_OUT + K], i, col, B.sf);
}

RAFT_HD void fab_rows(const Args &a, const Block &B, long long i, int t, bool in) {
#define RAFT_FAB_ROW(name, dt, shape) \
  fab_row<FL_##name, RAFT_ST_##dt, K_##shape>(a, B, i, t, in);
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

// lane t's own cells (its outbox)
template <int K, typename ST>
RAFT_HD void bind_out(Col<ST> &x, const Block &B, int t) {
  x = Col<ST>{fab_col<K, ST>(B) + t, B.sf};
}
template <int K, typename ST>
RAFT_HD void bind_out(Col2<ST> &x, const Block &B, int t) {
  x = Col2<ST>{fab_col<K, ST>(B) + t, E * B.sf, B.sf};
}

// the cells sent to lane t = base + me by the lanes of its group: sender
// i's slot me, so element i steps over threads
template <int K, typename ST>
RAFT_HD void bind_in(Col<ST> &x, const Block &B, int base, int me, int kind) {
  ST *col = fab_col<K, ST>(B);
  x = kind == K_LANE ? Col<ST>{col + base + me, B.sf} : Col<ST>{col + (long long)me * B.sf + base, 1};
}
template <int K, typename ST>
RAFT_HD void bind_in(Col2<ST> &x, const Block &B, int base, int me, int) {
  x = Col2<ST>{fab_col<K, ST>(B) + (long long)me * E * B.sf + base, 1, B.sf};
}

RAFT_HD Fab outbox(const Block &B, int t) {
  Fab f;
#define RAFT_BIND_OUT(name, dt, shape) bind_out<FL_##name, RAFT_ST_##dt>(f.name, B, t);
  RAFT_FABRIC_FIELDS(RAFT_BIND_OUT)
#undef RAFT_BIND_OUT
  return f;
}

RAFT_HD Fab inbox(const Block &B, int t) {
  Fab f;
  const int me = t % V, base = t - me;
#define RAFT_BIND_IN(name, dt, shape) \
  bind_in<FL_##name, RAFT_ST_##dt>(f.name, B, base, me, K_##shape);
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
// Every value of the carry is in its packed range when a round starts (it
// was loaded or paged in from packed rows, or clamped at the last
// boundary), so a clamp of a value the round did not write is a no-op:
// the rings' slots are clamped only where the round wrote them (Mid), the
// registers and the outbox cells all.

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
// the rings: only the slots the round wrote (clamp_written)
template <int K, typename ST>
RAFT_HD void roundtrip(Col<ST> &, bool &) {}
template <int K, typename ST>
RAFT_HD void roundtrip(Col2<ST> &, bool &) {}

// a slot of ring leaf K that the round wrote
template <int K, typename ST>
RAFT_HD void clamp_slot(ST &x, bool &ovf) {
  if constexpr (StateLeaf<K, ST>::narrow) clamp_to<typename StateLeaf<K, ST>::T>(x, ovf);
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

// The channels of the fabric, in table order; a cell of the outbox is
// (channel, j), the self channel's one cell j = 0.
enum : int { CH_REP, CH_HB, CH_VOTE, CH_VRESP, CH_SELF };

// cell j of channel CH of outbox f cleared: its kind MSG_NONE, every other
// field 0
template <int CH>
RAFT_HD void clear_cell(const Fab &f, int j) {
  if constexpr (CH == CH_REP) {
    f.rep_kind[j] = MSG_NONE;
    f.rep_term[j] = f.rep_index[j] = f.rep_log_term[j] = f.rep_commit[j] = 0;
    f.rep_reject[j] = 0;
    f.rep_reject_hint[j] = f.rep_n_ents[j] = 0;
    RAFT_UNROLL
    for (int k = 0; k < E; ++k)
      f.rep_ent_term[j][k] = f.rep_ent_type[j][k] = f.rep_ent_bytes[j][k] = 0;
    f.rep_snap_index[j] = f.rep_snap_term[j] = 0;
  } else if constexpr (CH == CH_HB) {
    f.hb_kind[j] = MSG_NONE;
    f.hb_term[j] = f.hb_commit[j] = f.hb_context[j] = 0;
  } else if constexpr (CH == CH_VOTE) {
    f.vote_kind[j] = MSG_NONE;
    f.vote_term[j] = f.vote_index[j] = f.vote_log_term[j] = 0;
    f.vote_reject[j] = 0;
    f.vote_context[j] = 0;
  } else if constexpr (CH == CH_VRESP) {
    f.vresp_kind[j] = MSG_NONE;
    f.vresp_term[j] = 0;
    f.vresp_reject[j] = 0;
  } else {
    f.self_kind[0] = MSG_NONE;
    f.self_term[0] = f.self_index[0] = 0;
  }
}

RAFT_HD void clear_fab(const Fab &f) {
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    clear_cell<CH_REP>(f, j);
    clear_cell<CH_HB>(f, j);
    clear_cell<CH_VOTE>(f, j);
    clear_cell<CH_VRESP>(f, j);
  }
  clear_cell<CH_SELF>(f, 0);
}

RAFT_HD void clear_ops(Ops &o) {
  o.hup = o.forget = o.beat = false;
  o.prop_n = o.prop_bytes = o.transfer_to = o.read_ctx = o.prop_cc = 0;
}

// a bit set of N elements
template <bool Narrow>
struct MaskT {
  using T = uint32_t;
};
template <>
struct MaskT<false> {
  using T = uint64_t;
};
template <int N>
using Mask = typename MaskT<(N <= 32)>::T;

RAFT_HD int low_bit(uint64_t m) {  // the lowest set bit of m != 0
#ifdef __CUDA_ARCH__
  return __ffsll((long long)m) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

// What a lane's round keeps from its read half to its write half. The
// block has one fabric buffer: a round reads its inbox (the senders' cells
// of their last outboxes) in its read half, and the block's barrier
// separates that from its write half, which writes its outbox in the same
// cells. The outbox writes the read half makes are held until then (the
// cells in hc and hm, the values in the lane's staging column, Held). The
// host build keeps one a lane between its loops over the block's lanes.
enum : uint32_t {  // Mid::f
  MF_HUP = 1, MF_BEAT = 2, MF_CQ = 4, MF_TON = 8, MF_CAND = 16, MF_VR = 32,
  MF_TICK = 64, MF_DOWN = 128,  // the chaos build's tick mask and down lane
};
enum : int {  // bit offsets of the held cells: Mid::hc, then Mid::hm
  HC_PING = 0, HC_TON = 8, HC_VR = 16, HC_VR_REJ = 24,
  HM_VR_PV = 0, HM_REP_CELL = 8, HM_REP_REJ = 12, HM_HB_CELL = 16,
};
struct Mid {
  uint32_t f;       // MF_* facts of the read half
  uint32_t sel;     // want_send: bit j send_sel[j], bit 8 + j send_sie[j]
  uint32_t hc, hm;  // the held writes: V-bit sets of cells (HC_*), and (HM_*)
                    // the vote responses' pre-vote kinds, the cells + 1 of the
                    // append and heartbeat responses, and the append reject
  int lead0, committed0;  // the metrics' baselines of the round
#if RAFT_CHAOS
  uint32_t wr;  // the peer cells the write half wrote, bit 8 * channel + j (Round::touch)
#endif
#if RAFT_DIET
  Mask<W> wlog;       // the ring slots the round wrote: log window slot s,
  Mask<V * F> winfl;  // inflight j * F + f,
  uint32_t wread;     // ro q (bit q) and rs q (bit 8 + q)
#endif
};

// the ring slots the round wrote, clamped (the boundary's note above)
RAFT_HD void clamp_written(Lane &L, const Mid &mid, bool &ovf) {
#if RAFT_DIET
  for (Mask<W> m = mid.wlog; m; m &= m - 1) {
    const int s = low_bit(m);
    clamp_slot<SL_log_term>(L.log_term[s], ovf);
    clamp_slot<SL_log_type>(L.log_type[s], ovf);
    clamp_slot<SL_log_bytes>(L.log_bytes[s], ovf);
  }
  for (Mask<V * F> m = mid.winfl; m; m &= m - 1) {
    const int x = low_bit(m);
    clamp_slot<SL_infl_index>(L.infl_index[x / F][x % F], ovf);
    clamp_slot<SL_infl_bytes>(L.infl_bytes[x / F][x % F], ovf);
  }
  for (uint32_t m = mid.wread & 0xFFu; m; m &= m - 1) {
    const int q = low_bit(m);
    clamp_slot<SL_ro_ctx>(L.ro_ctx[q], ovf);
    clamp_slot<SL_ro_from>(L.ro_from[q], ovf);
    clamp_slot<SL_ro_index>(L.ro_index[q], ovf);
    clamp_slot<SL_ro_seq>(L.ro_seq[q], ovf);
  }
  for (uint32_t m = mid.wread >> 8; m; m &= m - 1) {
    const int q = low_bit(m);
    clamp_slot<SL_rs_ctx>(L.rs_ctx[q], ovf);
    clamp_slot<SL_rs_index>(L.rs_index[q], ovf);
  }
#else
  (void)L;
  (void)mid;
  (void)ovf;
#endif
}

// the lane's carry and its outbox `out` after a round: the registers, the
// ring slots the round wrote and the outbox cells
RAFT_HD void roundtrip_lane(Lane &L, const Fab &out, const Mid &mid) {
  bool ovf = false;
#define RAFT_RT(name, dt, shape) roundtrip<SL_##name, RAFT_ST_##dt>(L.name, ovf);
  RAFT_STATE_FIELDS(RAFT_RT)
#undef RAFT_RT
  clamp_written(L, mid, ovf);
#define RAFT_CLAMP(name, dt, shape) clamp_cells<FL_##name, RAFT_ST_##dt, K_##shape>(out.name, ovf);
  RAFT_FABRIC_FIELDS(RAFT_CLAMP)
#undef RAFT_CLAMP
  if (ovf) L.error_bits |= ERR_DIET_OVERFLOW;
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

// One lane's round, in its read half (out null: its outbox writes are held
// in mid and the staging column) or its write half (out the lane's
// outbox). Member functions mirror the Python functions of the same name;
// every masked tensor update becomes `if (mask)` on this lane.
struct Round {
  Lane &L;
  const Cfg &c;
  Mid &mid;
  const Fab *out;
  Col<int> stage;  // the lane's staging column (Held values, HV_*)
  int ss;          // self slot (step.self_slot), -1 when untracked
  bool is_self[V];

  RAFT_HD Round(Lane &l, const Cfg &cf, Mid &m, const Fab *o, Col<int> st)
      : L(l), c(cf), mid(m), out(o), stage(st) {
    // step.find_slot(state, state.id): the first hot slot
    ss = -1;
    RAFT_UNROLL
    for (int j = V - 1; j >= 0; --j)
      if (L.prs_id[j] == L.id && L.prs_id[j] != 0) ss = j;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) is_self[j] = j == ss;
  }

  RAFT_HD bool voter(int j) const { return L.voters_in[j] || L.voters_out[j]; }
  RAFT_HD void err(bool cond, int bit) {
    if (cond) L.error_bits |= bit;
  }

  // the diet build's record of the ring slots the round writes (Mid)
  RAFT_HD void wrote_log(int s) {
#if RAFT_DIET
    mid.wlog |= Mask<W>(1) << s;
#else
    (void)s;
#endif
  }
  RAFT_HD void wrote_infl(int j, int f) {
#if RAFT_DIET
    mid.winfl |= Mask<V * F>(1) << (j * F + f);
#else
    (void)j, (void)f;
#endif
  }
  RAFT_HD void wrote_read(int bit) {  // ro q: q; rs q: 8 + q
#if RAFT_DIET
    mid.wread |= 1u << bit;
#else
    (void)bit;
#endif
  }

  // A write of the write half to peer cell j of channel CH. The chaos
  // build clears a cell at its first write, recorded in mid.wr (the other
  // builds clear the outbox before the write half): until then it holds
  // the last outbox's message, which chaos_end may redeliver.
  template <int CH>
  RAFT_HD void touch(int j) {
#if RAFT_CHAOS
    const uint32_t bit = 1u << (8 * CH + j);
    if (!(mid.wr & bit)) clear_cell<CH>(*out, j);
    mid.wr |= bit;
#else
    (void)j;
#endif
  }

  // ---- the read half's outbox writes, held (Mid::hc, hm, the stage) ----

  RAFT_HD void hold_vote_resp(int i, bool pv, bool reject, int term) {
    mid.hc |= (1u << (HC_VR + i)) | (reject ? 1u << (HC_VR_REJ + i) : 0u);
    if (pv) mid.hm |= 1u << (HM_VR_PV + i);
    stage[HV_VR_TERM + i] = term;
  }

  // the held writes into the outbox, in the order the read half made them
  RAFT_HD void flush_held() {
    const uint32_t hc = mid.hc, hm = mid.hm;
    const Fab &o = *out;
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      if ((hc >> (HC_PING + j)) & 1u) {
        touch<CH_REP>(j);
        o.rep_kind[j] = MSG_APP_RESP;
        o.rep_term[j] = L.term;
      }
      if ((hc >> (HC_VR + j)) & 1u) {
        touch<CH_VRESP>(j);
        o.vresp_kind[j] = (hm >> (HM_VR_PV + j)) & 1u ? MSG_PRE_VOTE_RESP : MSG_VOTE_RESP;
        o.vresp_term[j] = stage[HV_VR_TERM + j];
        if ((hc >> (HC_VR_REJ + j)) & 1u) o.vresp_reject[j] = true;
      }
      if ((hc >> (HC_TON + j)) & 1u) {
        touch<CH_VOTE>(j);
        o.vote_kind[j] = MSG_TIMEOUT_NOW;
        o.vote_term[j] = L.term;
      }
    }
    const int rj = (int)((hm >> HM_REP_CELL) & 15u) - 1;
    if (rj >= 0) {
      touch<CH_REP>(rj);
      o.rep_kind[rj] = MSG_APP_RESP;
      o.rep_term[rj] = L.term;
      o.rep_index[rj] = stage[HV_REP_INDEX];
      if ((hm >> HM_REP_REJ) & 1u) {
        o.rep_reject[rj] = true;
        o.rep_reject_hint[rj] = stage[HV_REP_HINT];
        o.rep_log_term[rj] = stage[HV_REP_LOG_TERM];
      }
    }
    const int hj = (int)((hm >> HM_HB_CELL) & 15u) - 1;
    if (hj >= 0) {
      touch<CH_HB>(hj);
      o.hb_kind[hj] = MSG_HEARTBEAT_RESP;
      o.hb_term[hj] = L.term;
      o.hb_context[hj] = stage[HV_HB_CONTEXT];
    }
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
          wrote_log(s);
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
    wrote_infl(j, pos);
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

  static RAFT_HD int joint_vote(const int (&votes)[V], const bool (&in)[V],
                                const bool (&out)[V]) {
    const int r1 = majority_vote(votes, in);
    const int r2 = majority_vote(votes, out);
    const bool any_lost = r1 == VOTE_LOST || r2 == VOTE_LOST;
    return any_lost ? VOTE_LOST : imax(r1, r2);
  }

  RAFT_HD int joint_vote(const int (&votes)[V]) const {
    return joint_vote(votes, L.voters_in, L.voters_out);
  }

  RAFT_HD void want_send(int j, bool cell, bool sie) {
    mid.sel |= (cell ? 1u << j : 0u) | (cell && sie ? 1u << (8 + j) : 0u);
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
    out->self_kind[0] = type;
    out->self_term[0] = term;
    out->self_index[0] = index;
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
      bool sel = ((mid.sel >> j) & 1u) && L.prs_id[j] != 0 && !is_self[j] && !is_paused(j);
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
      sel = sel && (n_send > 0 || ((mid.sel >> (8 + j)) & 1u));
      const bool need_snap = prev < L.snap_index;
      const bool snap_sel =
          sel && need_snap && L.pr_recent_active[j] && !L.snap_unavailable;
      const bool app_sel = sel && !need_snap;
      become_snapshot(j, snap_sel, send_si);
      const Fab &o = *out;
      if (snap_sel) {
        touch<CH_REP>(j);
        o.rep_kind[j] = MSG_SNAP;
        o.rep_term[j] = L.term;
        o.rep_snap_index[j] = send_si;
        o.rep_snap_term[j] = send_st;
      }
      if (app_sel) {
        touch<CH_REP>(j);
        o.rep_kind[j] = MSG_APP;
        o.rep_term[j] = L.term;
        o.rep_index[j] = prev;
        o.rep_log_term[j] = prev_term;
        o.rep_commit[j] = L.committed;
        o.rep_n_ents[j] = n_send;
        RAFT_UNROLL
        for (int k = 0; k < E; ++k) {
          o.rep_ent_term[j][k] = et[k];
          o.rep_ent_type[j][k] = ety[k];
          o.rep_ent_bytes[j][k] = eb[k];
        }
      }
      update_on_entries_send(j, app_sel, n_send, sent_bytes);
    }
  }

  RAFT_HD void bcast_heartbeat(bool mask, int ctx) {
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      if (!(mask && L.prs_id[j] != 0 && !is_self[j])) continue;
      touch<CH_HB>(j);
      out->hb_kind[j] = MSG_HEARTBEAT;
      out->hb_term[j] = L.term;
      out->hb_commit[j] = imin(L.pr_match[j], L.committed);
      out->hb_context[j] = ctx;
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
      touch<CH_VOTE>(j);
      out->vote_kind[j] = vote_t;
      out->vote_term[j] = ask_term;
      out->vote_index[j] = L.last;
      out->vote_log_term[j] = lt;
      out->vote_context[j] = ctype == TRANSFER ? TRANSFER : 0;
    }
  }

  RAFT_HD bool hup(bool mask, int ctype) {
    const bool ok = mask && L.state != LEADER && promotable() &&
                    !has_unapplied_conf_changes();
    campaign(ok, ctype);
    return ok;
  }

  // put_reply of a MsgAppResp at the lane's term to raft id `to` (slot
  // to-1), held
  RAFT_HD void reply_app_resp(bool mask, int to, int index) {
    if (!(mask && to >= 1 && to <= V)) return;
    mid.hm = (mid.hm & ~(15u << HM_REP_CELL)) | (uint32_t)to << HM_REP_CELL;
    stage[HV_REP_INDEX] = index;
  }

  RAFT_HD void handle_append_entries(bool mask, const Msg &m) {
    const bool stale = mask && m.index < L.committed;
    reply_app_resp(stale, m.frm, L.committed);
    const bool live = mask && !stale;
    bool ok;
    const int lastnewi =
        maybe_append(live ? m.index : -1, m.log_term, m.commit, m.ent_term,
                     m.ent_type, m.ent_bytes, live ? m.n_ents : 0, ok);
    reply_app_resp(live && ok, m.frm, lastnewi);
    int hi, ht;
    find_conflict_by_term(imin(m.index, L.last), m.log_term, hi, ht);
    if (live && !ok && m.frm >= 1 && m.frm <= V) {
      reply_app_resp(true, m.frm, m.index);
      mid.hm |= 1u << HM_REP_REJ;
      stage[HV_REP_HINT] = hi;
      stage[HV_REP_LOG_TERM] = ht;
    }
  }

  RAFT_HD void handle_heartbeat(bool mask, const Msg &m) {
    commit_to(mask ? m.commit : 0);
    if (mask && m.frm >= 1 && m.frm <= V) {  // a MsgHeartbeatResp, held
      mid.hm = (mid.hm & ~(15u << HM_HB_CELL)) | (uint32_t)m.frm << HM_HB_CELL;
      stage[HV_HB_CONTEXT] = m.context;
    }
  }

  RAFT_HD void handle_snapshot(bool mask, const Msg &m) {
    const int sidx = m.snap_index, sterm = m.snap_term;
    const bool stale = mask && sidx <= L.committed;
    const bool ff = mask && !stale && term_at(sidx) == sterm;
    commit_to(ff ? sidx : 0);
    reply_app_resp(stale || ff, m.frm, L.committed);
    const bool doit = mask && !stale && !ff && L.state == FOLLOWER;
    restore_snapshot(sidx, sterm, doit);
    reply_app_resp(doit, m.frm, L.last);
  }
};

// ---- ops/fused.py fused_round, for one lane ----------------------------

struct Events {
  int v[kCounters];  // counter deltas
  int bucket;        // latency bucket of a sample closed this round, else -1
  int lat;           // its latency
#if RAFT_LEASE
  uint32_t ack;      // bit j: cell j acked this round (append, heartbeat, self)
#endif
};

struct Sampler {  // metrics/device.py samp_index / samp_round of this lane
  int index, round;
};

// One round of lane `L`, in two halves with a barrier of the block
// between them (Mid). The read half runs the round on its routed inbox
// `in` (mute cut applied) up to its last read of it, holding its outbox
// writes in `mid` and the lane's staging column `stage`; ev gets this
// lane's metric deltas. tick: the chaos build's tick mask (false: the
// clocks hold and no tick fires).
RAFT_HD void round_read(Lane &L, const Cfg &c, const InFab &in, uint32_t cut, int flags,
                        Mid &mid, Col<int> stage, Events &ev, bool tick = true) {
  mid.f = mid.sel = mid.hc = mid.hm = 0;
#if RAFT_CHAOS
  mid.wr = 0;
#endif
#if RAFT_DIET
  mid.wlog = 0;
  mid.winfl = 0;
  mid.wread = 0;
#endif
  Round rd(L, c, mid, nullptr, stage);
  const bool *is_self = rd.is_self;
  RAFT_UNROLL
  for (int x = 0; x < kCounters; ++x) ev.v[x] = 0;
  ev.bucket = -1;
  ev.lat = 0;
#if RAFT_LEASE
  ev.ack = 0;
#endif
  mid.lead0 = L.lead;
  mid.committed0 = L.committed;

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
    if (ping) mid.hc |= 1u << (HC_PING + i);  // a MsgAppResp at the lane's term
    if (low_vote && in.vote_kind[i] == MSG_PRE_VOTE) rd.hold_vote_resp(i, true, true, L.term);
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
      if (grant) rd.hold_vote_resp(i, is_pv[i], false, in.vote_term[i]);
      if (vreq_cell[i] && !grant) rd.hold_vote_resp(i, is_pv[i], true, L.term);
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
#if RAFT_LEASE
    ev.ack |= uint32_t(ar_all) << j;
#endif
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
        L.pr_match[j] == L.last)
      mid.hc |= 1u << (HC_TON + j);  // a MsgTimeoutNow at the lane's term
  }

  // MsgHeartbeatResp cells (raft.go:1527-1561)
  bool hr_cell[V];
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    hr_cell[j] = hb_live[j] && in.hb_kind[j] == MSG_HEARTBEAT_RESP &&
                 in.hb_term[j] == L.term && is_leader;
#if RAFT_LEASE
    ev.ack |= uint32_t(hr_cell[j]) << j;
#endif
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
      if (hit) rd.wrote_read(8 + t);
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

  // Msg(Pre)VoteResp cells -> poll (raft.go:1041-1049, 1647-1666): the
  // inbox's last reads
  bool any_vr = false;
  {
    const int my_resp = L.state == PRE_CANDIDATE ? MSG_PRE_VOTE_RESP : MSG_VOTE_RESP;
    const bool self_vr = self_p && in.self_kind[0] == my_resp && is_cand;
    RAFT_UNROLL
    for (int i = 0; i < V; ++i) {
      const bool live = vresp_p[i] && !(in.vresp_term[i] < L.term);
      const bool vr_cell = live && in.vresp_kind[i] == my_resp && is_cand;
      const bool vr_all = vr_cell || (self_vr && is_self[i]);
      const bool vr_rej = vr_cell && in.vresp_reject[i];
      if (vr_all && rd.voter(i)) L.votes[i] = vr_rej ? REJECTED : GRANTED;
      any_vr = any_vr || vr_all;
    }
  }
  mid.f = (fire_hup ? MF_HUP : 0u) | (fire_beat ? MF_BEAT : 0u) | (fire_cq ? MF_CQ : 0u) |
          (ton ? MF_TON : 0u) | (is_cand ? MF_CAND : 0u) | (any_vr ? MF_VR : 0u);
}

// The write half: the round on from its last read of the inbox, into the
// lane's outbox `out` (cleared, but for the chaos build's kept cells), the
// held writes first. round_ctr is the metrics round counter before this
// round.
RAFT_HD void round_write(Lane &L, const Cfg &c, const Ops &ops, int flags, int lag,
                         int round_ctr, Sampler &samp, const Fab &out, Mid &mid,
                         Col<int> stage, Events &ev) {
  Round rd(L, c, mid, &out, stage);
  const bool *is_self = rd.is_self;
  const bool metrics = flags & F_METRICS;
  const bool is_cand = mid.f & MF_CAND;
  rd.flush_held();

  bool pre_won, real_won;
  {
    int votes[V];
    RAFT_UNROLL
    for (int i = 0; i < V; ++i) votes[i] = L.votes[i];
    const int res = rd.joint_vote(votes);
    const bool tallied = (mid.f & MF_VR) && is_cand;
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
  const bool ton = mid.f & MF_TON;
  int ctype = c.pre_vote ? PRE_ELECTION : ELECTION;
  if (ton) ctype = TRANSFER;
  if (pre_won) ctype = ELECTION;
  const bool hup_fired = rd.hup((mid.f & MF_HUP) || ops.hup || ton || pre_won, ctype);
  ev.v[C_ELECTIONS_STARTED] += hup_fired;
  ev.v[C_ELECTIONS_WON] += real_won;

  // CheckQuorum (raft.go:1231-1243)
  bool is_leader = L.state == LEADER;
  {
    const bool cq = (mid.f & MF_CQ) && is_leader;
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
    rd.bcast_heartbeat(((mid.f & MF_BEAT) || ops.beat) && is_leader, beat_ctx);
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
        rd.touch<CH_VOTE>(j);
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
      rd.wrote_read(q);
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
      rd.wrote_read(8 + q);
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
#if RAFT_LEASE
  ev.ack |= bits(rd.is_self);  // the lease tail (lane_lease) runs after the round
#endif

  if (!metrics) return;
  // ---- end-of-round measurement: the messages the round wrote (in the
  // chaos build a cell it did not write still holds the last outbox's) ----
#if RAFT_CHAOS
  const uint32_t unwritten = ~mid.wr;
#else
  const uint32_t unwritten = 0;
#endif
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    const int rk = (unwritten >> (8 * CH_REP + j)) & 1u ? (int)MSG_NONE : (int)out.rep_kind[j];
    const int hk = (unwritten >> (8 * CH_HB + j)) & 1u ? (int)MSG_NONE : (int)out.hb_kind[j];
    const bool vote =
        !((unwritten >> (8 * CH_VOTE + j)) & 1u) && out.vote_kind[j] != MSG_NONE;
    const bool vresp =
        !((unwritten >> (8 * CH_VRESP + j)) & 1u) && out.vresp_kind[j] != MSG_NONE;
    ev.v[C_MSGS_APP] += rk == MSG_APP || rk == MSG_SNAP;
    ev.v[C_MSGS_APP_RESP] += rk == MSG_APP_RESP;
    ev.v[C_MSGS_HEARTBEAT] += hk == MSG_HEARTBEAT;
    ev.v[C_MSGS_HEARTBEAT_RESP] += hk == MSG_HEARTBEAT_RESP;
    ev.v[C_MSGS_VOTE] += vote;
    ev.v[C_MSGS_VOTE_RESP] += vresp;
  }
  ev.v[C_LEADER_CHANGES] += L.lead != mid.lead0 && L.lead != 0;
  ev.v[C_COMMITS] += L.committed - mid.committed0;
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

// What a thread keeps across the rounds. The planes keep little here: at
// the bench Shape a 96-lane block has 168 registers a thread (four blocks,
// 12 warps, an SM: three warps on each quarter of the register file),
// which the carry and the round fill. The paged build reads what page-in saw again at page-out
// (the lane's input cursors and page-table row), the chaos build keeps
// its facts of the launch in `cut` above the mute bits and in shared
// memory (chaos_facts) and writes a probe column only when it records a
// round, and the lease build keeps its countdown and skew here and its
// epoch and counters in their output rows (lease_col).
#if RAFT_LEASE
struct LeaseRegs {
  int left, skew;  // lease_left, lease_skew (widened)
};
#endif
struct Thread {
  Lane L;
  Cfg c;
  Sampler samp;
  uint32_t cut;  // bit j: lane j of the group or this lane muted (the mute cut);
                 // the chaos build's facts above (CUT_*)
#if RAFT_LEASE
  LeaseRegs lease;
#endif
#if RAFT_STAMPS
  uint32_t lap[kLaps];  // cycles in each lap, over the launch
#endif
};

// The stamp build's laps: RAFT_LAP(th, x, c) adds the cycles since c to
// lap x and restarts c. Without RAFT_STAMPS (and in the host build) both
// are nothing.
#if RAFT_STAMPS && defined(__CUDA_ARCH__)
#define RAFT_LAP_START(c) long long c = clock64()
#define RAFT_LAP(th, x, c)                        \
  do {                                            \
    const long long now_ = clock64();             \
    (th).lap[x] += (uint32_t)(now_ - (c));        \
    (c) = now_;                                   \
  } while (0)
#else
#define RAFT_LAP_START(c)
#define RAFT_LAP(th, x, c)
#endif

#if RAFT_LEASE
// ---- ops/lease.py: the leader-lease plane of a lane -----------------------

// lease column K's storage type (slim int32; a diet build's RAFT_LEASE_DIET
// rows uint16) and its input and output rows
template <int K>
using LeaseT = typename Store<G_LEASE, K, int32_t>::T;
template <int K>
RAFT_HD const LeaseT<K> *lease_in(const Args &a) {
  return (const LeaseT<K> *)a.p[P_LEASE_IN + K];
}
template <int K>
RAFT_HD LeaseT<K> *lease_col(const Args &a) {
  return (LeaseT<K> *)a.p[P_LEASE_OUT + K];
}

// one event on lane i's counter K, in place (int32, wrapping as the plain
// version's int32 add does)
template <int K>
RAFT_HD void lease_count(const Args &a, long long i) {
  lease_col<K>(a)[i] = (int32_t)((uint32_t)lease_col<K>(a)[i] + 1u);
}

// lease_round for lane i after its round (fused.py's lease tail): ack, bit
// j a fresh append or heartbeat ack of cell j or the self slot; skipped,
// the lane skipped this round's tick
RAFT_HD void lane_lease(const Args &a, long long i, Thread &th, uint32_t ack, bool skipped) {
  const Lane &L = th.L;
  const Cfg &c = th.c;
  int votes[V];
  bool cc_active = L.pending_conf_index > L.applied;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    votes[j] = (ack >> j) & 1u ? GRANTED : PENDING;
    cc_active = cc_active || L.voters_out[j];
  }
  const bool ack_quorum = Round::joint_vote(votes, L.voters_in, L.voters_out) == VOTE_WON;
  const bool is_leader = L.state == LEADER;
  int left = th.lease.left, skew = th.lease.skew;
  const bool held = left > 0;
  left = imax(left - 1, 0);
  const bool unsafe = !is_leader || L.lead_transferee != 0 || cc_active;
  if (held && skipped) skew += 1;
  const bool skew_revoke = held && skew > a.margin;
  const bool revoke = held && (unsafe || skew_revoke);
  const bool renew = is_leader && c.check_quorum && ack_quorum && !unsafe && !skew_revoke;
  const bool granted = renew && !held;
  if (revoke)
    left = 0;
  else if (renew)
    left = imax(c.election_tick - 1 - a.margin, 1);
  if (granted || revoke) skew = 0;
  th.lease.left = left;
  th.lease.skew = skew;
  if (granted) {
    LeaseT<LS_lease_epoch> *ep = lease_col<LS_lease_epoch>(a) + i;
    *ep = (LeaseT<LS_lease_epoch>)fmod_pos((int)*ep + 1, EPOCH_WRAP);
    lease_count<LS_lease_grants>(a, i);
  }
  if (renew && held) lease_count<LS_lease_renewals>(a, i);
  if (revoke) lease_count<LS_lease_revocations>(a, i);
  if (held && skew_revoke && !unsafe) lease_count<LS_lease_skew_revocations>(a, i);
}

// the storage boundary of the countdown and the skew: a diet build clamps
// them to uint16 with ERR_DIET_OVERFLOW, as pack_state does (the epoch
// stays below EPOCH_WRAP and the counters are int32)
RAFT_HD void lease_roundtrip(Thread &th) {
#if RAFT_DIET
  bool ovf = false;
  clamp_to<uint16_t>(th.lease.left, ovf);
  clamp_to<uint16_t>(th.lease.skew, ovf);
  if (ovf) th.L.error_bits |= ERR_DIET_OVERFLOW;
#else
  (void)th;
#endif
}
#endif

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
// probe column k (PROBES order) of the launch's output, the lane's working
// copy from its load on
RAFT_HD int *chaos_probe(const Args &a, int k) { return (int *)a.p[P_CH_PROBE_OUT + k]; }

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

// The facts of a launch. None of the knob columns changes inside a launch
// (set_chaos acts between dispatches), so lane i reads them once, at its
// load, into what its rounds test as bits:
// - Thread::cut above the mute bits: the partition's cut (bit CUT_PART + j:
//   member j's sends do not reach the lane), the rounds of its crash and
//   restart wipes in this launch (k, or kNoRound), and whether its probe
//   rounds are recorded (the output columns are written once, when one is);
// - its word of the block's facts (B.fact(), read by its group's lanes):
//   the rounds k of the launch in which it is down, [lo, hi), and whether
//   any of its drop, duplicate or tick-skew numerators is nonzero;
// - the probe's baseline (B.probe_base()), which changes only at the heal
//   round, and the launch's scalars (B.chaos_sc()).
constexpr int CUT_PART = 8, CUT_WIPE_C = 16, CUT_WIPE_R = 23;
constexpr uint32_t CUT_REELECT = 1u << 30, CUT_RECOMMIT = 1u << 31;
constexpr uint32_t kNoRound = 127;
enum : uint32_t { FACT_DROP = 1u << 16, FACT_DUP = 1u << 17, FACT_SKEW = 1u << 18 };
enum : int { SC_ROUND, SC_HEAL, SC_SEED };

// x - r0 clamped to the launch's rounds [0, kc] (a down window's edge), or
// as the round of an edge inside the launch, else kNoRound
RAFT_HD uint32_t rel_clamp(long long x, int kc) {
  return (uint32_t)(x < 0 ? 0 : x > kc ? kc : x);
}
RAFT_HD uint32_t rel_round(long long x, int kc) {
  return x >= 0 && x < kc ? (uint32_t)x : kNoRound;
}

// whether a fact word's lane is down in round k of the launch
RAFT_HD bool fact_down(uint32_t f, uint32_t k) { return (f & 0x7Fu) <= k && k < ((f >> 8) & 0x7Fu); }

// lane i's (thread t's) facts of the launch, at its load (kc <=
// kMaxChaosRounds): its word of B.fact() and its probe's baseline
// written, its probe columns copied to their output rows (the lane's
// working copies), and its bits of Thread::cut returned
RAFT_HD uint32_t chaos_facts(const Args &a, const Block &B, long long i, int t) {
  const int r0 = *(const int *)a.p[P_CH_ROUND];  // the launch's first round
  if (t == 0) {
    B.chaos_sc()[SC_ROUND] = r0;
    B.chaos_sc()[SC_HEAL] = *(const int *)a.p[P_CH_HEAL];
    B.chaos_sc()[SC_SEED] = *(const int *)a.p[P_CH_SEED];
  }
  const long long c = (long long)knob(a, CH_crash_at)[i] - r0;
  const long long r = (long long)knob(a, CH_restart_at)[i] - r0;
  const long long g = i - i % V;
  const int recv = knob(a, CH_part_recv)[i];
  int send[V], drop[V], dup[V];
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    send[j] = knob(a, CH_part_send)[g + j];
    drop[j] = knob(a, CH_drop_num)[i * V + j];
    dup[j] = knob(a, CH_dup_num)[i * V + j];
  }
  uint32_t part = 0, f = rel_clamp(c, a.kc) | rel_clamp(r, a.kc) << 8;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    if ((send[j] & recv) == 0) part |= 1u << j;
    if (drop[j] > 0) f |= FACT_DROP;
    if (dup[j] > 0) f |= FACT_DUP;
  }
  if (knob(a, CH_tick_skew_num)[i] > 0) f |= FACT_SKEW;
  int probe[kChaosProbes];
  RAFT_UNROLL
  for (int k = 0; k < kChaosProbes; ++k) probe[k] = ((const int *)a.p[P_CH_PROBE_IN + k])[i];
  RAFT_UNROLL
  for (int k = 0; k < kChaosProbes; ++k) chaos_probe(a, k)[i] = probe[k];
  B.fact()[t] = f;
  B.probe_base()[t] = probe[CH_base_committed];
  return part << CUT_PART | rel_round(c, a.kc) << CUT_WIPE_C | rel_round(r, a.kc) << CUT_WIPE_R |
         (probe[CH_reelect_round] != NEVER ? CUT_REELECT : 0u) |
         (probe[CH_recommit_round] != NEVER ? CUT_RECOMMIT : 0u);
}

// begin_round for lane i (thread t) in round k of the launch, from its
// facts: the crash-window wipe, the cut of each channel's inbound cells
// (the mute cut, the partition's, a down endpoint, a drop draw per edge),
// whether the lane is down, its tick mask, and the probe's baseline at the
// heal round
RAFT_HD void chaos_begin(const Args &a, const Block &B, long long i, int t, int k, Thread &th,
                         uint32_t (&cut)[4], bool &crashed, bool &tick) {
  const int *sc = B.chaos_sc();
  const int rnd = sc[SC_ROUND] + k;
  const uint32_t seed = (uint32_t)sc[SC_SEED], kk = (uint32_t)k;
  if (kk == ((th.cut >> CUT_WIPE_C) & 0x7Fu) || kk == ((th.cut >> CUT_WIPE_R) & 0x7Fu)) {
    wipe_lane(th.L, th.c);
#if RAFT_LEASE
    th.lease.left = th.lease.skew = 0;  // the lease is gone; the epoch survives
#endif
  }
  const int me = t % V;
  const uint32_t *f = B.fact() + (t - me);
  const uint32_t own = f[me];
  crashed = fact_down(own, kk);
  uint32_t cells = (th.cut | th.cut >> CUT_PART) & ((1u << V) - 1);
  RAFT_UNROLL
  for (int j = 0; j < V; ++j)
    if (crashed || fact_down(f[j], kk)) cells |= 1u << j;
  RAFT_UNROLL
  for (int ch = 0; ch < 4; ++ch) cut[ch] = cells;
  if (own & FACT_DROP) {
    const int *row = knob(a, CH_drop_num) + i * V;
    const uint32_t e0 = (uint32_t)i * V;  // the lane's first edge, as the hash takes it
    int num[V];
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) num[j] = row[j];
    RAFT_UNROLL
    for (int j = 0; j < V; ++j) {
      RAFT_UNROLL
      for (int ch = 0; ch < 4; ++ch)
        if (decide(seed, rnd, e0 + j, SALT_DROP + ch, num[j])) cut[ch] |= 1u << j;
    }
  }
  tick = !crashed && !((own & FACT_SKEW) &&
                       decide(seed, rnd, (uint32_t)i, SALT_TICK_SKEW, knob(a, CH_tick_skew_num)[i]));
  if (rnd == sc[SC_HEAL]) {
    B.probe_base()[t] = th.L.committed;
    chaos_probe(a, CH_base_committed)[i] = th.L.committed;
  }
}

// end_round's duplicate redelivery, on the block's one fabric buffer,
// after the write half: a peer cell the round did not write (Mid::wr)
// still holds the lane's last outbox (the cells this round delivered,
// untouched by the cuts). Where that is a message and the duplicate draw
// fires, it stays, every field of the channel; every other such cell is
// cleared.
template <int CH>
RAFT_HD void end_cell(const Fab &out, int j, bool dup, uint32_t seed, int rnd, uint32_t edge,
                      int num) {
  const int kind = CH == CH_REP ? out.rep_kind[j] : CH == CH_HB ? out.hb_kind[j]
                 : CH == CH_VOTE ? out.vote_kind[j] : out.vresp_kind[j];
  if (!(dup && kind != MSG_NONE && decide(seed, rnd, edge, SALT_DUP + CH, num)))
    clear_cell<CH>(out, j);
}

RAFT_HD void chaos_end(const Args &a, const Block &B, const Fab &out, uint32_t wr, long long i,
                       int t, int k) {
  const bool dup = B.fact()[t] & FACT_DUP;
  const int rnd = B.chaos_sc()[SC_ROUND] + k;
  const uint32_t seed = (uint32_t)B.chaos_sc()[SC_SEED];
  const uint32_t e0 = (uint32_t)i * V;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) {
    const uint32_t todo = ~wr >> j;
    if (!((todo >> (8 * CH_REP) | todo >> (8 * CH_HB) | todo >> (8 * CH_VOTE) |
           todo >> (8 * CH_VRESP)) & 1u))
      continue;
    const int num = dup ? knob(a, CH_dup_num)[i * V + j] : 0;
    if ((todo >> (8 * CH_REP)) & 1u) end_cell<CH_REP>(out, j, dup, seed, rnd, e0 + j, num);
    if ((todo >> (8 * CH_HB)) & 1u) end_cell<CH_HB>(out, j, dup, seed, rnd, e0 + j, num);
    if ((todo >> (8 * CH_VOTE)) & 1u) end_cell<CH_VOTE>(out, j, dup, seed, rnd, e0 + j, num);
    if ((todo >> (8 * CH_VRESP)) & 1u) end_cell<CH_VRESP>(out, j, dup, seed, rnd, e0 + j, num);
  }
}

// the probe's flag of lane t after round k, before the storage boundary
// clamps committed: bit 0 a leader, bit 1 committed past the baseline
// (read only from the heal round on, when the baseline holds)
RAFT_HD void probe_flag(const Block &B, int k, int t, const Lane &L) {
  const int *sc = B.chaos_sc();
  const bool past = sc[SC_ROUND] + k >= sc[SC_HEAL] && L.committed > B.probe_base()[t];
  B.flag()[t] = uint8_t((L.state == LEADER ? 1u : 0u) | (past ? 2u : 0u));
}

// end_round's recovery probe for lane t after the round's barrier: its
// group's flags (one byte a lane) record the first armed round of each,
// in the output column and in the lane's recorded bits
RAFT_HD void lane_probe(const Args &a, const Block &B, int k, long long i, int t, Thread &th) {
  const int *sc = B.chaos_sc();
  const int rnd = sc[SC_ROUND] + k;
  if (rnd < sc[SC_HEAL]) return;
  const uint8_t *f = B.flag() + (t - t % V);
  uint32_t any = 0;
  RAFT_UNROLL
  for (int j = 0; j < V; ++j) any |= f[j];
  if (!(th.cut & CUT_REELECT) && (any & 1u)) {
    chaos_probe(a, CH_reelect_round)[i] = rnd;
    th.cut |= CUT_REELECT;
  }
  if (!(th.cut & CUT_RECOMMIT) && (any & 2u)) {
    chaos_probe(a, CH_recommit_round)[i] = rnd;
    th.cut |= CUT_RECOMMIT;
  }
}

// whether the lane was wiped in a round of this launch (its crash or
// restart round inside it): its through rows are zeroed at the store
RAFT_HD bool chaos_wiped(const Thread &th) {
  return ((th.cut >> CUT_WIPE_C) & 0x7Fu) != kNoRound || ((th.cut >> CUT_WIPE_R) & 0x7Fu) != kNoRound;
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
// columns, its outbox row into the fabric, its config, sampler and mute
// bits
RAFT_HD void lane_load(const Args &a, const Block &B, long long i, int t, Thread &th) {
  load_lane(th.L, a, B, i, t);
  fab_rows(a, B, i, t, true);
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
  th.cut |= chaos_facts(a, B, i, t);
#endif
#if RAFT_LEASE
  th.lease.left = (int)lease_in<LS_lease_left>(a)[i];
  th.lease.skew = (int)lease_in<LS_lease_skew>(a)[i];
  lease_col<LS_lease_epoch>(a)[i] = lease_in<LS_lease_epoch>(a)[i];
  lease_col<LS_lease_grants>(a)[i] = lease_in<LS_lease_grants>(a)[i];
  lease_col<LS_lease_renewals>(a)[i] = lease_in<LS_lease_renewals>(a)[i];
  lease_col<LS_lease_revocations>(a)[i] = lease_in<LS_lease_revocations>(a)[i];
  lease_col<LS_lease_skew_revocations>(a)[i] = lease_in<LS_lease_skew_revocations>(a)[i];
#endif
}

// Round k of lane i (thread t) on the block's one fabric buffer: its read
// half (lane_read) reads its inbox, the senders' cells of their last
// outboxes, and holds its outbox writes (mid); after a barrier of the block
// (every lane has read its inbox) its write half (lane_write) writes its
// outbox into its own cells.
RAFT_HD void lane_read(const Args &a, const Block &B, int k, long long i, int t, Thread &th,
                       Mid &mid, Events &ev) {
  const Fab in = inbox(B, t);
  RAFT_LAP_START(lap_c);
#if RAFT_CHAOS
  // the cuts as masks read through the inbox: the senders' cells stay
  // as sent, for their duplicate redelivery (chaos_end)
  uint32_t cut[4];
  bool crashed, tick;
  chaos_begin(a, B, i, t, k, th, cut, crashed, tick);
  RAFT_LAP(th, LAP_BEGIN, lap_c);
  InFab inb;
  static_cast<Fab &>(inb) = in;
  inb.rep_kind = KindCol{in.rep_kind.p, in.rep_kind.s, cut[0]};
  inb.hb_kind = KindCol{in.hb_kind.p, in.hb_kind.s, cut[1]};
  inb.vote_kind = KindCol{in.vote_kind.p, in.vote_kind.s, cut[2]};
  inb.vresp_kind = KindCol{in.vresp_kind.p, in.vresp_kind.s, cut[3]};
  inb.self_kind = KindCol{in.self_kind.p, in.self_kind.s, crashed ? 1u : 0u};
  round_read(th.L, th.c, inb, th.cut, a.flags, mid, B.stage(t), ev, tick);
  mid.f |= (tick ? MF_TICK : 0u) | (crashed ? MF_DOWN : 0u);
#else
  // the mute cut, at the read: only this lane reads its inbound cells,
  // and every sender rewrites or clears its cells in its write half
  RAFT_UNROLL
  for (int j = 0; j < V; ++j)
    if ((th.cut >> j) & 1u)
      in.rep_kind[j] = in.hb_kind[j] = in.vote_kind[j] = in.vresp_kind[j] = MSG_NONE;
  round_read(th.L, th.c, in, th.cut, a.flags, mid, B.stage(t), ev);
#endif
  RAFT_LAP(th, LAP_ROUND, lap_c);
}

RAFT_HD void lane_write(const Args &a, const Block &B, int k, long long i, int t, Thread &th,
                        Mid &mid, int round_ctr, Events &ev) {
  const Fab out = outbox(B, t);
  RAFT_LAP_START(lap_c);
#if RAFT_CHAOS
  clear_cell<CH_SELF>(out, 0);  // the peer cells at their first write, or after (chaos_end)
#else
  clear_fab(out);
#endif
  // the ops are read when a round applies them (not held across rounds)
  Ops ops;
  if ((a.flags & F_OPS) && (k == 0 || !(a.flags & F_OPS_ROUND0)))
    load_ops(ops, a, i);
  else
    clear_ops(ops);
#if RAFT_CHAOS
  if (mid.f & MF_DOWN) clear_ops(ops);  // a down lane takes no host ops
#endif
  round_write(th.L, th.c, ops, a.flags, a.lag, round_ctr + k, th.samp, out, mid, B.stage(t), ev);
#if RAFT_LEASE
  // the lease tail on the round's final state (the metrics block after it
  // in fused.py reads no lease column): a ticking round the lane skipped
  // is skew (the chaos build's tick mask)
  lane_lease(a, i, th, ev.ack, RAFT_CHAOS && (a.flags & F_TICK) && !(mid.f & MF_TICK));
#endif
  RAFT_LAP(th, LAP_ROUND, lap_c);
#if RAFT_CHAOS
  chaos_end(a, B, out, mid.wr, i, t, k);
  probe_flag(B, k, t, th.L);
  RAFT_LAP(th, LAP_DUP, lap_c);
#endif
  // the carry crosses the storage boundary between rounds
  roundtrip_lane(th.L, out, mid);
#if RAFT_LEASE
  lease_roundtrip(th);
#endif
  RAFT_LAP(th, LAP_BOUNDARY, lap_c);
}

// after the rounds: lane i's carry, its last outbox and its sampler to
// device memory; only this thread wrote any of them
RAFT_HD void lane_store(const Args &a, const Block &B, long long i, int t, const Thread &th) {
  store_lane(th.L, a, i);
  fab_rows(a, B, i, t, false);
  if (a.flags & F_METRICS) {
    ((int *)a.p[P_SAMP_INDEX_OUT])[i] = th.samp.index;
    ((int *)a.p[P_SAMP_ROUND_OUT])[i] = th.samp.round;
  }
#if RAFT_CHAOS
  if (chaos_wiped(th)) {
    zero_row<SL_pri_ctx, RAFT_ST_I32>(a, i);
    zero_row<SL_pri_from, RAFT_ST_I32>(a, i);
  }
#endif
#if RAFT_LEASE
  lease_col<LS_lease_left>(a)[i] = (LeaseT<LS_lease_left>)th.lease.left;
  lease_col<LS_lease_skew>(a)[i] = (LeaseT<LS_lease_skew>)th.lease.skew;
#endif
}

RAFT_HD int *acc_row(const Block &B, int k) { return B.acc(k & 1); }

// The launch's arguments from a C entry's (table order; dims: n, v, w, e,
// f, r, kc, cta, and for the paged build pool rows per allocation segment,
// blocks per segment and the launch's epoch, else 0, 1, 0; then the lease
// margin, 0 without the lease build): false unless v..r are this
// library's Shape, the block is a multiple of v that divides n and takes
// at most S lanes, the segments cover the blocks, and the margin is one
// this build takes.
RAFT_HD bool args_of(void *const *ptrs, int nptrs, const long long *dims, int flags, int lag,
                     Args &a, int &cta) {
  if (nptrs != kNumPtrs || dims[1] != V || dims[2] != W || dims[3] != E ||
      dims[4] != F || dims[5] != R || dims[7] < V || dims[7] > S || dims[7] % V ||
      dims[0] % dims[7] || dims[6] < 1)
    return false;
#if RAFT_PAGED
  if (dims[8] < KMAX + 1 || dims[8] > 65536 || dims[9] < 1 || (dims[0] / dims[7]) % dims[9] ||
      dims[10] < 0 || dims[10] > 0xFFFFFFFFLL || (dims[9] > 1 && (!ptrs[P_SEG] || !dims[10])))
    return false;
#else
  if (dims[8] != 0 || dims[9] != 1 || dims[10] != 0) return false;
#endif
  if (RAFT_LEASE ? dims[11] < 0 || dims[11] > kMaxMargin : dims[11] != 0) return false;
  if (RAFT_CHAOS && dims[6] > kMaxChaosRounds) return false;
  for (int p = 0; p < kNumPtrs; ++p) a.p[p] = ptrs[p];
  a.n = dims[0];
  a.kc = (int)dims[6];
  a.flags = flags;
  a.lag = lag;
  a.pool_rows = dims[8];
  a.bps = (int)dims[9];
  a.epoch = (uint32_t)dims[10];
  a.margin = (int)dims[11];
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

// slot s of a log leaf's column from the pool: entry `ent` of the segment's
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

// lane i's last / snap_index as page-in saw them: its input leaves,
// widened as load_lane widens them
template <int K>
RAFT_HD int cursor_in(const Args &a, long long i) {
  return (int)((const typename StateLeaf<K, int32_t>::T *)a.p[P_STATE_IN + K])[i];
}

// whether lane i's last or snap_index moved since page-in
RAFT_HD bool lane_moved(const Args &a, long long i, const Lane &L) {
  return L.last != cursor_in<SL_last>(a, i) || L.snap_index != cursor_in<SL_snap_index>(a, i);
}

// page_in (paged.py:222-258): lane i's W ring slots of the three log
// leaves from its tail, its page-table row and its segment's sub-pool
// (rows [seg * pool_rows, (seg + 1) * pool_rows)); slots outside
// (snap, last] are zero.
RAFT_HD void lane_page_in(const Args &a, long long i, long long seg, Thread &th) {
  Lane &L = th.L;
  const int last = L.last, snap = L.snap_index;
  const int lo_res = imax(snap, last - WRES);
  const uint16_t *pt = (const uint16_t *)a.p[P_PAGED_IN + PG_pt] + i * M;
  const long long base = seg * a.pool_rows;
  RAFT_UNROLL
  for (int s = 0; s < W; ++s) {
    const int idx = last - ((last - s) & (W - 1));
    const bool paged = idx > snap && idx <= lo_res;  // valid, not resident
    const int page = paged ? (int)pt[(idx >> LPE) & (M - 1)] : 0;
    const long long ent = (base + page) * PE + (idx & (PE - 1));
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

// page_out / page_out_cond (paged.py:287-384) of lane i, after the rounds
// and the store of its carry: its tail, its page-table row, its live pages
// and its counters, and ERR_PAGE_EXHAUSTED added to its stored error bits
// where its pages did not fit (error_bits is never packed). `moved`:
// the segment `seg` reallocates; page0: the lane's first page id (1 + the
// exclusive scan of the segment's needs). The sub-pool's rows no live page
// writes are block_pool's.
RAFT_HD void lane_page_out(const Args &a, long long i, long long seg, Thread &th, bool moved,
                           int page0) {
  Lane &L = th.L;
  const int last = L.last, snap = L.snap_index;
  const int lo_res = imax(snap, last - WRES);
  const int *const *in = (const int *const *)(a.p + P_PAGED_IN);
  int *const *out = (int *const *)(a.p + P_PAGED_OUT);
  col_to_tail<SL_log_term>(a, i, L.log_term, last, lo_res);
  col_to_tail<SL_log_type>(a, i, L.log_type, last, lo_res);
  col_to_tail<SL_log_bytes>(a, i, L.log_bytes, last, lo_res);
  const uint16_t *pt_in = (const uint16_t *)a.p[P_PAGED_IN + PG_pt] + i * M;
  uint16_t *pt_out = (uint16_t *)a.p[P_PAGED_OUT + PG_pt] + i * M;
  uint16_t e_in[M];
  RowIO<uint16_t, M>::load(pt_in, e_in);
  int mapped = 0;  // the pages page-in gathered: the faults bump
  RAFT_UNROLL
  for (int m = 0; m < M; ++m) mapped += e_in[m] > 0;
  out[PG_faults][i] = in[PG_faults][i] + mapped;
  if (!moved) {  // the skip branch: table and pool as they were
    RowIO<uint16_t, M>::store(pt_out, e_in);
    out[PG_exhausted][i] = in[PG_exhausted][i];
    out[PG_dirty][i] = in[PG_dirty][i];
    out[PG_skipped][i] = in[PG_skipped][i] + 1;
    return;
  }
  int k_lo;
  const int need = lane_need(L, k_lo);
  const int n_alloc = imin(imax((int)a.pool_rows - page0, 0), need);
  const bool exh = n_alloc < need;
  if (exh) ((int *)a.p[P_STATE_OUT + SL_error_bits])[i] = L.error_bits | ERR_PAGE_EXHAUSTED;
  // slot mm holds key k_lo + ((mm - k_lo) & (M - 1)), live below n_alloc
  uint16_t e[M];
  RAFT_UNROLL
  for (int mm = 0; mm < M; ++mm) {
    const int j = (mm - k_lo) & (M - 1);
    e[mm] = (uint16_t)(j < n_alloc ? page0 + j : 0);
  }
  RowIO<uint16_t, M>::store(pt_out, e);
  const long long base = seg * a.pool_rows;
  RAFT_UNROLL
  for (int j = 0; j < KMAX; ++j) {
    if (j >= n_alloc) break;
    const long long row = base + page0 + j;
    col_to_page<SL_log_term>(a, L.log_term, row, k_lo + j, snap, lo_res);
    col_to_page<SL_log_type>(a, L.log_type, row, k_lo + j, snap, lo_res);
    col_to_page<SL_log_bytes>(a, L.log_bytes, row, k_lo + j, snap, lo_res);
  }
  out[PG_exhausted][i] = in[PG_exhausted][i] + (exh ? 1 : 0);
  out[PG_dirty][i] = in[PG_dirty][i] + n_alloc;
  out[PG_skipped][i] = in[PG_skipped][i];
}

// rows [lo, hi) of the sub-pool at row `base` (threads tid of nth):
// copied through, or zeroed where no live page goes (the trash row 0, and
// the rows from `end` on)
template <typename T>
RAFT_HD void pool_rows_part(const Args &a, int leaf, long long base, long long lo, long long hi,
                            long long end, bool copy, int tid, int nth) {
  const T *src = (const T *)a.p[P_PAGED_IN + leaf] + base * PE;
  T *dst = (T *)a.p[P_PAGED_OUT + leaf] + base * PE;
  for (long long x = lo * PE + tid; x < hi * PE; x += nth) {
    const long long row = x / PE;
    if (copy)
      dst[x] = src[x];
    else if (row == 0 || row >= end)
      dst[x] = (T)0;
  }
}

// block j's share of the sub-pool rows of segment `seg` that no lane
// writes (threads tid of nth; the bps blocks of a segment take even
// shares): copied through when the segment skipped its allocator, else
// zeroed (the trash row 0, and the rows from 1 + the segment's total need
// on, which the scan left unallocated). A one-block segment takes the
// whole sub-pool with constant bounds: through the share arithmetic its
// launch took about 20 us more on the H100 (PERF.md, the paged build).
RAFT_HD void block_pool(const Args &a, long long seg, int j, bool moved, int total_need, int tid,
                        int nth) {
  using TT = typename StateLeaf<SL_log_term, int32_t>::T;
  using TY = typename StateLeaf<SL_log_type, int8_t>::T;
  using TB = typename StateLeaf<SL_log_bytes, int32_t>::T;
  const long long base = seg * a.pool_rows;
  const long long end = 1 + (long long)total_need;
  if (a.bps == 1) {
    pool_rows_part<TT>(a, PG_pool_term, base, 0, a.pool_rows, end, !moved, tid, nth);
    pool_rows_part<TY>(a, PG_pool_type, base, 0, a.pool_rows, end, !moved, tid, nth);
    pool_rows_part<TB>(a, PG_pool_bytes, base, 0, a.pool_rows, end, !moved, tid, nth);
    return;
  }
  const long long share = (a.pool_rows + a.bps - 1) / a.bps;
  const long long lo = j * share < a.pool_rows ? j * share : a.pool_rows;
  const long long hi = lo + share < a.pool_rows ? lo + share : a.pool_rows;
  pool_rows_part<TT>(a, PG_pool_term, base, lo, hi, end, !moved, tid, nth);
  pool_rows_part<TY>(a, PG_pool_type, base, lo, hi, end, !moved, tid, nth);
  pool_rows_part<TB>(a, PG_pool_bytes, base, lo, hi, end, !moved, tid, nth);
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

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The stamp build's row of block `blk` (nullptr without RAFT_STAMPS), and
// thread 0's stamps into it: clock64() (stamp) or %globaltimer (stamp_gt).
__device__ __forceinline__ long long *stamp_row(const Args &a, long long blk) {
#if RAFT_STAMPS
  return (long long *)a.p[P_STAMPS] + blk * (kStampSlots + a.kc);
#else
  (void)a;
  (void)blk;
  return nullptr;
#endif
}

__device__ __forceinline__ void stamp(long long *row, int slot, int t) {
#if RAFT_STAMPS
  if (t == 0) row[slot] = clock64();
#endif
}

__device__ __forceinline__ void stamp_gt(long long *row, int slot, int t) {
#if RAFT_STAMPS
  if (t == 0) row[slot] = (long long)globaltimer_ns();
#endif
}

// a stamp after a block barrier (the stamp build's only): the phase it
// ends is the block's, up to its slowest thread
__device__ __forceinline__ void stamp_sync(long long *row, int slot, int t) {
#if RAFT_STAMPS
  __syncthreads();
  stamp(row, slot, t);
#endif
}

#if RAFT_STAMPS
// the block's laps into its row: each summed and maxed over the warp, then
// one shared-memory atomic a warp (the lap row zeroed at the start)
__device__ __forceinline__ void stamp_laps(const Block &B, const Thread &th, long long *row,
                                           int t, int cta) {
  const int live = cta - (t & ~31);
  const unsigned mask = live >= 32 ? 0xffffffffu : (1u << live) - 1u;
  unsigned *laps = B.laps();
#pragma unroll
  for (int x = 0; x < kLaps; ++x) {
    const unsigned s = __reduce_add_sync(mask, th.lap[x]);
    const unsigned m = __reduce_max_sync(mask, th.lap[x]);
    if ((t & 31) == 0) {
      atomicAdd(&laps[2 * x], s);
      atomicMax(&laps[2 * x + 1], m);
    }
  }
  __syncthreads();
  if (t < 2 * kLaps) row[ST_LAPS + t] = laps[t];
}
#endif

#if RAFT_CHAOS
// the chaos build's recounts: lanes with a recorded reelect / recommit
// round (their bits in Thread::cut), summed over the warp and added to the
// block's slots
__device__ __forceinline__ void add_recounts(const Thread &th, int *acc, int t, int cta) {
  const int live = cta - (t & ~31);
  const unsigned mask = live >= 32 ? 0xffffffffu : (1u << live) - 1u;
  const int s0 = __reduce_add_sync(mask, th.cut & CUT_REELECT ? 1 : 0);
  const int s1 = __reduce_add_sync(mask, th.cut & CUT_RECOMMIT ? 1 : 0);
  if ((t & 31) == 0) {
    if (s0) atomicAdd(&acc[kPartUsed], s0);
    if (s1) atomicAdd(&acc[kPartUsed + 1], s1);
  }
}
#endif

#if RAFT_PAGED
// The exclusive prefix sum of x over the block's threads, and its total:
// an inclusive scan within each warp by shuffles, then the warp totals
// through one shared row (at most kMaxCta lanes a block).
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

// The segment barrier's scratch (P_SEG, u64): word 0 the ticket counter
// (its low 32 bits), then one word a block by logical id: the launch's
// epoch in the high 32 bits, the block's `moved` in bit 31 and its lanes'
// total page demand below it. The epoch tells this launch's words from
// the last one's, so nothing is reset between launches.
__device__ __forceinline__ unsigned long long *seg_words(const Args &a) {
  return (unsigned long long *)a.p[P_SEG];
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long *p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long *p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The block's logical id, which places its lanes: blockIdx.x when a
// segment is one block, else its ticket. Tickets go 0..gridDim.x - 1 in
// the order the blocks start (atomicInc wraps the counter back to 0 at the
// last one, ready for the next launch), so when a block waits at its
// segment's barrier every block with a lower id has started.
__device__ __forceinline__ long long logical_block(const Args &a, const Block &B, int t) {
  if (a.bps == 1) return blockIdx.x;
  int *slot = B.scan() + SC_LID;
  if (t == 0) *slot = (int)atomicInc((unsigned *)seg_words(a), gridDim.x - 1);
  __syncthreads();
  return *slot;
}

// A wait at the segment barrier longer than this traps: a launch whose
// segment cannot complete fails instead of hanging the card.
constexpr unsigned long long kSegWaitNs = 10ull * 1000 * 1000 * 1000;

// The segment of block `blk` (bps blocks, one allocation segment) from its
// blocks' words: whether any lane of the segment moved (page_out_cond
// decides per segment, as the JAX package does per tile), the demand of
// the segment's blocks below this one and the segment's total. The block
// publishes its word; warp 0 reads the segment's words with acquire loads
// until each carries this launch's epoch, and shares what they say
// through the block's scan row.
//
// The wrapper passes the pool in and out as separate buffers
// (P_PAGED_IN, P_PAGED_OUT). An in-place pool would be safe too: every
// block of a segment has read its pages (page-in, before the rounds)
// before it publishes, and no block writes a page before every word of
// its segment is in.
__device__ __forceinline__ void segment_barrier(const Args &a, const Block &B, long long blk,
                                                int t, int cta, bool moved, int total,
                                                bool &seg_moved, int &below, int &seg_total) {
  if (a.bps == 1) {
    seg_moved = moved;
    below = 0;
    seg_total = total;
    return;
  }
  unsigned long long *words = seg_words(a) + 1;
  int *sc = B.scan();
  const int lanes = cta < 32 ? cta : 32;
  if (t < lanes) {
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    if (t == 0) {
      __threadfence();
      st_release(words + blk,
                 ((unsigned long long)a.epoch << 32) | (moved ? 1ull << 31 : 0ull) |
                     (unsigned long long)(unsigned)total);
    }
    __syncwarp(mask);
    const long long first = blk - blk % a.bps;
    const unsigned long long t0 = globaltimer_ns();
    unsigned any = 0;
    int low = 0, sum = 0;
    for (long long x = first + t; x < first + a.bps; x += lanes) {
      unsigned long long w;
      while ((uint32_t)((w = ld_acquire(words + x)) >> 32) != a.epoch) {
        if (globaltimer_ns() - t0 > kSegWaitNs) __trap();
        __nanosleep(100);
      }
      const int need = (int)(w & 0x7FFFFFFFull);
      any |= (unsigned)(w >> 31) & 1u;
      sum += need;
      if (x < blk) low += need;
    }
    any = __reduce_or_sync(mask, any);
    low = __reduce_add_sync(mask, (unsigned)low);
    sum = __reduce_add_sync(mask, (unsigned)sum);
    if (t == 0) {
      sc[SC_MOVED] = (int)any;
      sc[SC_PREFIX] = low;
      sc[SC_TOTAL] = sum;
    }
  }
  __syncthreads();
  seg_moved = sc[SC_MOVED] != 0;
  below = sc[SC_PREFIX];
  seg_total = sc[SC_TOTAL];
}

// page_out_cond for the block's segment (paged.py:357-384): one barrier
// takes whether any of the block's lanes moved last or snap_index since
// page-in, the block scan their page demands, and the segment barrier
// both for the segment; if any lane of the segment moved the allocator
// runs (each lane's first page is 1 + the demand before it in the
// segment), else the tables and the sub-pool are copied through
__device__ __forceinline__ void page_out_block(const Args &a, const Block &B, long long blk,
                                               long long i, int t, int cta, Thread &th,
                                               long long *srow) {
  const bool mine = !kCanSkip || __syncthreads_or(lane_moved(a, i, th.L));
  int k_lo, total;
  const int off = block_exclusive_scan(lane_need(th.L, k_lo), B.scan(), t, cta, total);
  stamp_sync(srow, ST_SCAN, t);
  bool moved;
  int below, seg_total;
  stamp_gt(srow, ST_GT_SEG_IN, t);
  segment_barrier(a, B, blk, t, cta, mine, total, moved, below, seg_total);
  stamp_gt(srow, ST_GT_SEG_OUT, t);
  stamp(srow, ST_SEGMENT, t);
  const long long seg = blk / a.bps;
  lane_page_out(a, i, seg, th, moved, 1 + below + off);
  stamp_sync(srow, ST_PAGE_OUT, t);
  block_pool(a, seg, (int)(blk % a.bps), moved, seg_total, t, cta);
  stamp_sync(srow, ST_POOL, t);
}
#endif

// blocks of this library that fit an SM's 228 KB of shared memory (1 KB of
// it reserved per block): the register budget keeps that occupancy
constexpr int kBlocksPerSm = imax(1, imin(8, (int)(233472 / (Block::bytes + 1024))));

__global__ void __launch_bounds__(S, kBlocksPerSm) round_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, cta = blockDim.x;
  const bool metrics = a.flags & F_METRICS;
  const Block B{smem};
#if RAFT_STAMPS
  const long long c_start = clock64(), gt_start = (long long)globaltimer_ns();
  if (t < 2 * kLaps) B.laps()[t] = 0;
#endif
  for (int x = t; x < 2 * kAccN; x += cta) acc_row(B, x / kAccN)[x % kAccN] = 0;
#if RAFT_PAGED
  const long long blk = logical_block(a, B, t);
#else
  const long long blk = blockIdx.x;
#endif
  long long *const srow = stamp_row(a, blk);
#if RAFT_STAMPS
  if (t == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    srow[ST_GT_START] = gt_start;
    srow[ST_START] = c_start;
    srow[ST_SMID] = smid;
  }
#endif
  stamp_sync(srow, ST_TICKET, t);
  const long long i = blk * cta + t;
  Thread th;
#if RAFT_STAMPS
#pragma unroll
  for (int x = 0; x < kLaps; ++x) th.lap[x] = 0;
#endif
  lane_load(a, B, i, t, th);
  stamp_sync(srow, ST_LOAD, t);
#if RAFT_PAGED
  lane_page_in(a, i, blk / a.bps, th);
#endif
  stamp_sync(srow, ST_PAGE_IN, t);
  const int round_ctr = metrics ? *(const int *)a.p[P_ROUND_CTR] : 0;
  __syncthreads();  // every lane's outbox is in the fabric
  stamp(srow, ST_LOADED, t);
  for (int k = 0; k < a.kc; ++k) {
    Events ev;
    Mid mid;
    lane_read(a, B, k, i, t, th, mid, ev);
    __syncthreads();  // every inbox is read: each lane's cells are its own to write
    lane_write(a, B, k, i, t, th, mid, round_ctr, ev);
    if (metrics) add_events(ev, acc_row(B, k), t, cta);
    // this round's outbox (the next round's inboxes) and sums are complete
    __syncthreads();
#if RAFT_CHAOS
    // the probe reads its group's flags; once every lane has read them and
    // added its recounts, the row is written (and the flags free again)
    RAFT_LAP_START(lap_c);
    lane_probe(a, B, k, i, t, th);
    add_recounts(th, acc_row(B, k), t, cta);
    RAFT_LAP(th, LAP_PROBE, lap_c);
    __syncthreads();
    write_partials(a, B, k, blk, gridDim.x, t, cta);
#else
    if (metrics) write_partials(a, B, k, blk, gridDim.x, t, cta);
#endif
    stamp(srow, kStampSlots + k, t);
  }
  lane_store(a, B, i, t, th);
  stamp_sync(srow, ST_STORE, t);
#if RAFT_PAGED
  // after the store, so that the carry's registers are free for the
  // segment barrier and the allocator
  page_out_block(a, B, blk, i, t, cta, th, srow);
#endif
#if RAFT_STAMPS
  stamp_sync(srow, ST_END, t);
  stamp_gt(srow, ST_GT_END, t);
  stamp_laps(B, th, srow, t, cta);
#endif
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
// S), then for the paged build the pool rows per allocation segment, the
// CUDA blocks per segment and the launch's epoch (nonzero, another than
// the last launch's on the same scratch, when a segment spans blocks),
// else 0, 1, 0, then the lease margin (0..kMaxMargin for the lease build,
// else 0). v..r must be the Shape this library was built for.
// Launches on `stream` and returns cudaGetLastError().
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
  // the paged build runs a whole allocation segment's blocks through their
  // rounds, then the segment's page-out; the others one block at a time
  const int bps = RAFT_PAGED ? a.bps : 1;
  std::vector<std::vector<Bits<16>>> bufs(bps, std::vector<Bits<16>>((Block::bytes + 15) / 16));
  std::vector<Thread> th((std::size_t)bps * cta);
  std::vector<Mid> mid(cta);  // a round's lanes between its halves
  std::vector<Events> ev(cta);
  for (long long blk0 = 0; blk0 < n_blocks; blk0 += bps) {
    for (int j = 0; j < bps; ++j) {
      const long long blk = blk0 + j;
      const Block B{(unsigned char *)bufs[j].data()};
      Thread *tb = th.data() + (std::size_t)j * cta;
      for (int x = 0; x < 2 * kAccN; ++x) acc_row(B, x / kAccN)[x % kAccN] = 0;
      for (int t = 0; t < cta; ++t) {
        lane_load(a, B, blk * cta + t, t, tb[t]);
#if RAFT_PAGED
        lane_page_in(a, blk * cta + t, blk / bps, tb[t]);
#endif
      }
      for (int k = 0; k < a.kc; ++k) {
        int *acc = acc_row(B, k);
        // every lane's read half, then (the block's barrier) every write half
        for (int t = 0; t < cta; ++t) lane_read(a, B, k, blk * cta + t, t, tb[t], mid[t], ev[t]);
        for (int t = 0; t < cta; ++t) {
          lane_write(a, B, k, blk * cta + t, t, tb[t], mid[t], round_ctr, ev[t]);
          if (!metrics) continue;
          for (int x = 0; x < kCounters; ++x) acc[x] += ev[t].v[x];
          if (ev[t].bucket >= 0) acc[C_HIST0 + ev[t].bucket] += 1;
          acc[C_LAT_SUM] += ev[t].lat;
        }
#if RAFT_CHAOS
        for (int t = 0; t < cta; ++t) {
          lane_probe(a, B, k, blk * cta + t, t, tb[t]);
          acc[kPartUsed] += (tb[t].cut & CUT_REELECT) != 0;
          acc[kPartUsed + 1] += (tb[t].cut & CUT_RECOMMIT) != 0;
        }
        for (int t = 0; t < cta; ++t) write_partials(a, B, k, blk, n_blocks, t, cta);
#else
        if (metrics)
          for (int t = 0; t < cta; ++t) write_partials(a, B, k, blk, n_blocks, t, cta);
#endif
      }
    }
    for (int j = 0; j < bps; ++j) {
      const Block B{(unsigned char *)bufs[j].data()};
      for (int t = 0; t < cta; ++t)
        lane_store(a, B, (blk0 + j) * cta + t, t, th[(std::size_t)j * cta + t]);
    }
#if RAFT_PAGED
    // page_out_block over the segment: its barriers and scans as loops
    // over the segment's lanes in order
    const long long seg = blk0 / bps;
    bool moved = !kCanSkip;
    for (std::size_t x = 0; x < th.size(); ++x)
      moved = moved || lane_moved(a, blk0 * cta + (long long)x, th[x].L);
    int total = 0;
    std::vector<int> page0(th.size());
    for (std::size_t x = 0; x < th.size(); ++x) {
      int k_lo;
      page0[x] = 1 + total;
      total += lane_need(th[x].L, k_lo);
    }
    for (std::size_t x = 0; x < th.size(); ++x)
      lane_page_out(a, blk0 * cta + (long long)x, seg, th[x], moved, page0[x]);
    for (int j = 0; j < bps; ++j) block_pool(a, seg, j, moved, total, 0, 1);
#endif
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

// 1 for the lease build (its column pointers, in then out, close the
// table, and dims[11] is the margin), else 0.
extern "C" int raft_round_lease() { return RAFT_LEASE; }

// The stamp build's fixed slots a row (kStampSlots; its stamp buffer, the
// table's last pointer, holds kStampSlots + kc a block), else 0.
extern "C" int raft_round_stamps() { return RAFT_STAMPS ? raft::kStampSlots : 0; }

// The paged build's geometry {1, WRES, PE, M}, or {0, 0, 0, 0}.
extern "C" void raft_round_paged(long long *out) {
#if RAFT_PAGED
  const long long g[4] = {1, raft::WRES, raft::PE, raft::M};
#else
  const long long g[4] = {0, 0, 0, 0};
#endif
  for (int x = 0; x < 4; ++x) out[x] = g[x];
}
