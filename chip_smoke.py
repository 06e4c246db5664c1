"""Chip smoke for the PyTorch/CUDA port: builds the CUDA kernels, holds each
against its plain PyTorch version, holds the card against the CPU on a
small cluster, and drives the main path at the bench's headline size.

    python3 chip_smoke.py

Needs one CUDA card (an H100; the kernels build for sm_90a with nvcc). Each
phase prints one JSON line; any failure exits non-zero. The line before the
last lists every ported kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Phases:
  device   the card's name and power limit (nvidia-smi)
  build    nvcc of csrc/quorum.cu and of csrc/round.cu for each (Shape,
           CUDA block, carry layout) the script uses (ROUND_BUILDS:
           W16/E2/F2/R2 at V=3 with the engine's 96-lane block and 6, 48 and
           192 lanes, at V=5 with 10, the diet-v2 build at V=3 with 96
           and 6, the paged builds, slim and diet, with 96 and 6, the
           chaos builds, slim and diet, with 96, 6 and 10, the chaos
           builds with paging, slim and diet, with 96, the eight lease
           builds with 96, and the stamp twins, -DRAFT_STAMPS=1, of the
           paged builds and the chaos builds with paging, STAMP_BUILDS),
           all started together: seconds of each, ptxas's
           registers, stack frame and spills of every kernel function
           (each quorum kernel at each V), and the round kernel's shared
           memory and resident blocks per SM, each round build beside the
           layout with two fabric buffers (TWO_BUFFERS)
  kernels  each quorum kernel against its plain version at V = 1..8 and
           N = 196,608 (one block's lanes), 196,609-196,611, 100,003 and 3
           (every n % 4 of the quad kernels), and the lane-major kernels
           on bool masks whose bytes hold 2..255; exact equality; each
           lane-major wrapper refuses, by name, an operand one element off
           its alignment, before any launch;
           timed at the main-path shape (V = 3) on raw launches with the
           arguments packed once: device time per launch from the
           profiler with the L2 cache overwritten before each launch (ms)
           and back to back (warm_ms, inputs resident in L2), and CUDA
           events over back-to-back launches, beside its wrapper and the
           plain version; and the floor under the lane-major kernels on
           their grid, timed the same way: an empty launch, and a 16-byte
           read of each kernel's input bytes that writes its output bytes
  parity   a 64-group FusedCluster for 33 rounds on the card and on the CPU:
           identical sha256 over every state, fabric and metrics leaf
  main     BlockedFusedCluster, 1,048,576 groups x 3 voters as 16 blocks of
           65,536 (bench.py's Shape, auto_propose, compaction lag 8,
           round_chunk 8): warm up until every group has a leader, then 32
           timed rounds; joint_kernel launches must equal rounds x blocks
  profile  one round of every block under torch.profiler: CUDA kernels
           per block-round, device time per round and its share of the
           main phase's round time
  round_kernel   the round megakernel (csrc/round.cu) against its plain
           version round_kernel_ref on the card: V in {3,5} x K in {1,4} x
           two seeds, 9 rounds as pallas_rounds launches them (K=4: two
           full launches and a remainder), a muted lane and injected
           hup/propose/ReadIndex/transfer ops; sha256 over every carry leaf
           and partials row after each launch, naming the first differing
           leaf
  parity_pallas  engine="pallas" on the card against the eager CPU path,
           64 groups x 33 rounds, at K=1 and K=3: identical digests
  main_pallas    the main phase's cluster on engine="pallas" at K=1 and
           K=8: groups-ticks/s, round_ms, commits per group-round (1.0),
           every group elected, check_no_errors, peak memory; round_kernel
           launches must equal rounds x blocks / K and joint_kernel must
           not launch; then one launch at the main path's shape (block 0's
           carry) against its plain version, timed with CUDA events beside
           the plain version and the bound; raw K=1 launches at three CUDA
           block sizes, and raw K=8 launches (ms per launch and per round)
  profile_pallas one K=1 round of every block under torch.profiler: CUDA
           kernels per block-round, device busy share, the megakernel's
           share of the device time
  round_kernel_diet  the diet-v2 build (-DRAFT_DIET=1) against
           round_kernel_ref on the packed carry: K in {1,3,8}, 9 rounds as
           pallas_rounds launches them, on a carry in range and on one
           brought to 65,531 so that appends overflow the packed uint16
           columns (clamps and ERR_DIET_OVERFLOW bits compared too); every
           leaf exact
  parity_diet    diet=True on the card against the eager CPU path with
           diet=True, 64 groups x 33 rounds: eager, pallas K=1 and K=3;
           the CPU's diet host_state against its slim run; and a run that
           fast-forwards by 48 Ki so the automatic rebase fires (pallas K=3
           on the card against the CPU)
  main_pallas_diet  the main_pallas cluster with diet=True at K=8 and K=1:
           the same gates (round_kernel_diet launches = rounds x blocks / K,
           no round_kernel or joint_kernel launch), a host_state digest
           equal to the slim run's at the same K, and round_ms, peak memory
           (reset at the start of each run) and the resident carry's bytes
           per lane beside the slim run's (main_pallas_diet_vs_slim); at K=1
           the diet build timed at the main path's shape
           (round_kernel_diet_timing) and profiled (profile_pallas_diet)
  eager_diet     the eager engine on 2 of the main path's blocks, 40 rounds,
           diet on and off: one host_state digest, one total_committed
  round_kernel_paged  the paged builds (-DRAFT_PAGED=1, in-kernel paging)
           against round_kernel_ref: slim and diet, K in {1,8}, a full pool
           and one that exhausts, launches that reallocate and launches
           that skip the allocator; every carry, partials and PagedLog
           leaf; then allocation segments of 2, 32 and 64 CUDA blocks of
           96 lanes on a grid of 2,048 blocks (65,536 groups: more blocks
           than the card holds at once), with a pool that holds and one
           that exhausts (round_kernel_paged_segments)
  parity_paged   the paged pallas engine on the card against the CPU,
           in-kernel and at the dispatch boundary
  main_pallas_paged  the paged main path at full width (run_main_paged,
           check_main_paged): in-kernel at the default tile (3,072 lanes:
           16 allocation segments of 32 CUDA blocks a block), in-kernel
           at tile_lanes=96 (one block a segment), in-kernel diet, at the
           dispatch boundary and flat; one host_state digest, the pool in
           use, no error bit, each run's segment layout; the paged builds
           timed at its shape over 3,072- and 96-lane segments
           (round_kernel_paged_timing, round_kernel_paged_diet_timing)
  round_kernel_chaos  the chaos builds (-DRAFT_CHAOS=1, slim and diet)
           against round_kernel_ref(chaos=): V in {3,5} x K in {1,4} x two
           seeds (metrics on for one, off for the other), 9 rounds as
           pallas_rounds launches them, under drops and duplicates of 0.2
           on four groups, tick skew 0.3, an asymmetric partition, a crash
           window that opens and closes inside a K=4 launch, an instant
           restart and a heal round armed inside a launch; sha256 over
           every carry leaf, probe column and partials row, naming the
           first differing one
  parity_chaos   a 64-group FusedCluster(chaos=True) through 33 faulted
           rounds: on the card eager and pallas K=1 and K=3, slim and diet,
           against the eager CPU run: one host_state + chaos-leaf digest
  chaos_slo_smoke  benches/chaos_soak.py --smoke (64 groups, seed 1000, the
           default Shape) on the card at K=8 and on the CPU: the recovery
           SLO holds, one probe snapshot and trajectory_digest
  main_pallas_chaos  the main_pallas cluster with chaos=True, driven by
           the port's ChaosRunner through benches/chaos_soak.py's mixed
           scenario (a copy: `scenario`) at 1,048,576 groups, tick budget
           64, at K=8 slim, K=1 slim and K=8 diet: the recovery SLO's
           outcome (reported: at this seed some groups stay leaderless past
           their window, as in the JAX package), groups probed,
           election_safety_batched after every segment and the lanes with
           error bits (reported; at this cell's 16-entry window a few
           followers' windows overflow, as in the JAX package; any bit
           but those of the window's capacity fails the phase), round_kernel_chaos(_diet) launches = what the segments'
           chunks launch, one digest and one probe snapshot across the three
           runs; round_ms, groups-ticks/s, host schedule seconds, peak
           memory beside main_pallas's K=8 round_ms; the chaos builds timed
           at block 0 beside the slim build (round_kernel_chaos_timing,
           round_kernel_chaos_diet_timing)
  round_kernel_chaos_paged  the chaos builds with paging (-DRAFT_CHAOS=1
           -DRAFT_PAGED=1, slim and diet) against round_kernel_ref(paged=,
           chaos=) over segments of two 96-lane blocks: K in {1,4} x seed 5
           (metrics on) with a full pool and seed 17 (metrics off) with one
           that exhausts, round_kernel_chaos's faults, proposals while the
           logs outrun the resident tail, then launches that skip the
           allocator; sha256 over every carry leaf, partials row, PagedLog
           leaf and probe column, naming the first differing one
  parity_chaos_paged  parity_chaos's 64-group, 33-round run with
           paged=True (at compaction lag 12, so that the pool is used): on
           the card eager at the boundary and around every round, pallas at
           the boundary (K=3) and in the kernel (K=1 and K=3; the default
           tile: one segment of two 96-lane blocks), the pallas runs slim
           and diet; one host_state + chaos digest with the unpaged CPU
           run, and the in-kernel K=3 runs' every leaf equal to the CPU's
  main_pallas_chaos_paged  main_pallas_chaos's scenario at 1,048,576
           groups with paged=True, paged_inkernel=True (page_window=8,
           page_entries=4) at K=8, slim and diet, as 128 blocks of 8,192
           groups with 65,536 pages a block (8,192 a 3,072-lane segment),
           beside the unpaged chaos run of the same layout: one digest, one
           probe snapshot, the same error lanes, no page exhausted;
           round_kernel_chaos_paged(_diet) launches = what the segments'
           chunks launch; round_ms, pool in use, each segment's peak
           pages in use (segment_pages_peak against segment_pool_rows,
           sampled after every schedule segment), peak memory; the builds
           timed at block 0 (round_kernel_chaos_paged_timing,
           round_kernel_chaos_paged_diet_timing), each with its stamp
           twin's phase table at K=1 and K=8 (`stamps`: per phase the
           median and max over the blocks in us at the SM clock nvidia-smi
           reads under the twin's load, the twin's ms beside the timed
           build's; stamp_table)
  round_kernel_lease  the eight lease builds (-DRAFT_LEASE=1 with every
           combination of diet, paging and chaos) against
           round_kernel_ref on a 128-group cluster with check_quorum and
           live leases: K in {1,4} x seed 5 (margin 0, metrics on) and 17
           (margin 2, metrics off), leases dropped with epochs at 32,767
           and renewal counters at 2^31 - 2, a transfer and a conf change
           that revoke; the chaos builds under tick skew 0.5, a crash
           window and an instant restart of leased leaders; the paged
           builds over segments of two 96-lane blocks, one pool that
           exhausts; sha256 over every leaf, naming the first that differs
  parity_lease   a 64-group FusedCluster(check_quorum=True, lease=True,
           chaos=True) through 33 rounds of a lease skew storm: on the card
           eager and pallas K=1 and K=3, slim and diet, and pallas paging in
           the kernel, against the eager CPU run: one host_state + chaos
           digest and one lease_stats
  main_pallas_lease  the main cell with check_quorum=True, lease=True,
           lease_margin=1, chaos=True: the election warm-up, then
           benches/lease_ab.py's device schedule (12 rounds, 48 calm, three
           bursts of tick skew 0.7 on every slot of 6 rounds with 12 calm
           after each, 48 settle), at K=8, K=8 diet and K=1, and the
           lease-off twin at K=8; gates: every group elected, one digest
           across the lease runs, their digest without the lease columns
           equal to the twin's, grants, renewals and skew revocations > 0,
           after every segment no lease held by a lane that is not a leader
           or has a transfer pending, a conf change in flight or skew past
           the margin, launches as the chunks launch, no error bit but the
           window's capacity; round_ms, groups-ticks/s and peak memory
           beside the twin's (main_pallas_lease_vs_twin); each lease build
           timed beside the build without lease and its bytes bound, the
           unpaged ones at the K=8 runs' block 0, the paged ones at one
           8,192-group block of the chaos-paged layout
           (round_kernel_lease*_timing)

Every launch of a paged build waits with a deadline (`synchronize`): a
segment barrier that does not complete fails the phase (the kernel also
traps a wait over 10 s) instead of stalling the script.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from raft_tpu_torch import build, interop
from raft_tpu_torch.chaos import ChaosRunner, ChaosSchedule, trajectory_digest
from raft_tpu_torch.chaos import device as tch
from raft_tpu_torch.chaos.schedule import election_safety_batched
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops import quorum as qr
from raft_tpu_torch.ops import quorum_cuda as qc
from raft_tpu_torch.ops import paged as tpg
from raft_tpu_torch.ops import round_cuda as rc
from raft_tpu_torch.ops.fused import FusedCluster, fused_rounds
from raft_tpu_torch.ops.lease import EPOCH_WRAP, LEASE_COUNTER_FIELDS, LEASE_STATE_FIELDS
from raft_tpu_torch.ops.log import ERR_COMMIT_OUT_OF_RANGE, ERR_WINDOW_OVERFLOW
from raft_tpu_torch.scheduler import BlockedFusedCluster
from raft_tpu_torch.state import ERR_DIET_OVERFLOW, ERR_PAGE_EXHAUSTED, is_packed
from raft_tpu_torch.types import StateType

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet); the
# quorum kernels' compares, selects and adds are 32-bit scalar operations
SCALAR_OPS_PER_S = 67e12
# The libraries of csrc/round.cu this script builds, as (Shape, CUDA block
# lanes, diet-v2 build, paged plan, chaos build): bench.py's widths at the
# main path's V, at its engine block and at the small blocks
# check_round_kernel uses, and at the second V; two more engine blocks at
# V=3 for the block-size sweep of round_kernel_timing; and the diet build
# at the engine block and the small block.
BENCH_WIDTHS = dict(w=16, e=2, f=2, r=2)
# The paged builds' plan (W_res, PE, M) at the bench widths: Shape(page_window
# =8, page_entries=4), benches/paged_ab.py's geometry
PAGED_PLAN = (8, 4, 4)
_B3 = dict(v=3, **BENCH_WIDTHS)
# ... and the paged builds (in-kernel paging: the CUDA block is the lane tile)
# at the engine block and the small block, slim and diet
_B5 = dict(v=5, **BENCH_WIDTHS)
# ... and the chaos builds, slim and diet, at the engine block, the small
# block and the second V's block
# ... and the chaos builds with paging, slim and diet, at the engine block
# ... and the eight lease builds (-DRAFT_LEASE=1 with each other flag set)
# at the engine block; each entry ends with its lease flag
LEASE_BUILDS = [(diet, plan, chaos) for chaos in (False, True) for plan in (None, PAGED_PLAN)
                for diet in (False, True)]
ROUND_BUILDS = [(_B3, 96, False, None, False), (_B3, 6, False, None, False),
                (_B5, 10, False, None, False), (_B3, 48, False, None, False),
                (_B3, 192, False, None, False), (_B3, 96, True, None, False),
                (_B3, 6, True, None, False),
                (_B3, 96, False, PAGED_PLAN, False), (_B3, 96, True, PAGED_PLAN, False),
                (_B3, 6, False, PAGED_PLAN, False), (_B3, 6, True, PAGED_PLAN, False)] + [
    (d, cta, diet, None, True) for d, cta in ((_B3, 96), (_B3, 6), (_B5, 10))
    for diet in (False, True)] + [
    (_B3, 96, diet, PAGED_PLAN, True) for diet in (False, True)]
ROUND_BUILDS = [b + (False,) for b in ROUND_BUILDS] + [
    (_B3, 96, diet, plan, chaos, True) for diet, plan, chaos in LEASE_BUILDS]
# ... and the measuring twins (-DRAFT_STAMPS=1) of the paged builds and of
# the chaos builds with paging at the engine block, slim and diet: never
# launched by the engine, read by round_kernel_paged(_diet)_timing and
# round_kernel_chaos_paged(_diet)_timing
STAMP_BUILDS = [(_B3, 96, diet, PAGED_PLAN, chaos, False) for chaos in (False, True)
                for diet in (False, True)]
# Each build's shared memory a block, resident blocks an SM, registers a
# thread and spilled bytes (ptxas's stores + loads) as the layout with two
# fabric buffers compiled them (NVIDIA H100 80GB HBM3, CUDA 12.8): the
# build phase prints them beside this tree's as `two_buffers`
TWO_BUFFERS = {
    "round-v3-w16-e2-f2-r2-s96":
        (75648, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s32":
        (25728, 8, 255, 0),
    "round-v5-w16-e2-f2-r2-s32":
        (38272, 5, 255, 0),
    "round-v3-w16-e2-f2-r2-s64":
        (50688, 4, 255, 0),
    "round-v3-w16-e2-f2-r2-s192":
        (150528, 1, 255, 0),
    "round-v3-w16-e2-f2-r2-s96-diet1":
        (75648, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s32-diet1":
        (25728, 8, 225, 0),
    "round-v3-w16-e2-f2-r2-s96-paged1-wres8-pe4-m4":
        (75696, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s96-diet1-paged1-wres8-pe4-m4":
        (75696, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s32-paged1-wres8-pe4-m4":
        (25776, 8, 228, 0),
    "round-v3-w16-e2-f2-r2-s32-diet1-paged1-wres8-pe4-m4":
        (25776, 8, 214, 0),
    "round-v3-w16-e2-f2-r2-s96-chaos1":
        (76528, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s96-diet1-chaos1":
        (76528, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s32-chaos1":
        (26032, 8, 255, 0),
    "round-v3-w16-e2-f2-r2-s32-diet1-chaos1":
        (26032, 8, 246, 0),
    "round-v5-w16-e2-f2-r2-s32-chaos1":
        (38576, 5, 255, 0),
    "round-v5-w16-e2-f2-r2-s32-diet1-chaos1":
        (38576, 5, 255, 0),
    "round-v3-w16-e2-f2-r2-s96-paged1-wres8-pe4-m4-chaos1":
        (76576, 3, 168, 16),
    "round-v3-w16-e2-f2-r2-s96-diet1-paged1-wres8-pe4-m4-chaos1":
        (76576, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s96-lease1":
        (75648, 3, 168, 32),
    "round-v3-w16-e2-f2-r2-s96-diet1-lease1":
        (75648, 3, 166, 0),
    "round-v3-w16-e2-f2-r2-s96-paged1-wres8-pe4-m4-lease1":
        (75696, 3, 168, 52),
    "round-v3-w16-e2-f2-r2-s96-diet1-paged1-wres8-pe4-m4-lease1":
        (75696, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s96-chaos1-lease1":
        (76528, 3, 168, 16),
    "round-v3-w16-e2-f2-r2-s96-diet1-chaos1-lease1":
        (76528, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s96-paged1-wres8-pe4-m4-chaos1-lease1":
        (76576, 3, 168, 68),
    "round-v3-w16-e2-f2-r2-s96-diet1-paged1-wres8-pe4-m4-chaos1-lease1":
        (76576, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s96-paged1-wres8-pe4-m4-chaos1-stamps1":
        (76624, 3, 168, 0),
    "round-v3-w16-e2-f2-r2-s96-diet1-paged1-wres8-pe4-m4-chaos1-stamps1":
        (76624, 3, 168, 16),
}
MAIN_GROUPS = 1 << 20
MAIN_BLOCK_GROUPS = 1 << 16
VOTERS = 3
BLOCK_LANES = MAIN_BLOCK_GROUPS * VOTERS  # 196,608
# the paged main path: a page id is uint16, so a block's pool holds at most
# 65,536 pages, and benches/paged_ab.py's traffic maps about two pages for
# every three lanes (after its second all-groups sweep every follower of a
# cold group is one entry past its 8-entry tail), plus a trash row for
# each 96-lane tile: 98,304-lane blocks exhaust even 65,536 pages, so 64
# blocks of 16,384 groups, with a page for every lane (96 a tile), then
# the most a block holds
PAGED_BLOCK_GROUPS = 1 << 14
PAGED_BLOCK_LANES = PAGED_BLOCK_GROUPS * VOTERS  # 49,152
PAGED_POOLS = (49_152, 65_536)
PAGED_SWEEP = 16  # rounds per Zipf sweep (benches/paged_ab.py AB_ROUNDS)
# the chaos cell with paging: a block's pool holds at most 65,536 pages
# (uint16 ids, paged.validate_page_plan), and the mixed scenario at lag 8
# holds more than a page a lane (PERF.md, the cells), so 65,536-group
# blocks (1/3 page a lane) exhaust: 128 blocks of 8,192 groups, 65,536
# pages a block (2.67 a lane)
CHAOS_PAGED_BLOCK_GROUPS = 1 << 13
CHAOS_PAGED_POOL = 65_536
# a launch of a paged build still running after this long fails its phase
LAUNCH_DEADLINE_S = 120.0
TIMED_ROUNDS = 32
WARM_LIMIT = 40 * 16  # bench.py:76-84


_T0 = time.perf_counter()


def emit(phase: str, **fields):
    """One JSON line: the phase, its fields, and the seconds since the
    script started (t_s)."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - _T0}), flush=True)


def bench_shape(n_lanes: int) -> Shape:
    """bench.py:46-56 at its defaults (W=16, E=2)."""
    return Shape(
        n_lanes=n_lanes, max_peers=VOTERS, log_window=16, max_msg_entries=2,
        max_inflight=2, max_read_index=2,
    )


def cuda_ms(fn, iters: int = 200) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, name: str, iters: int = 100, cold: bool = False) -> float:
    """Mean device time of the CUDA kernels whose name contains `name`, as
    torch.profiler records them over `iters` calls of fn(); with `cold`,
    the L2 cache is overwritten before each call (a 128 MB fill, which the
    name leaves out), so the inputs come from device memory."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(1 << 25, dtype=torch.int32, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiling session that records no kernel is repeated
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush.fill_(0)
                fn()
            torch.cuda.synchronize()
        times = [_device_us(e) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if times:
            return sum(times) / len(times) / 1e3
    raise AssertionError(f"the profiler recorded no {name} kernel in three sessions")


def synchronize(what: str, deadline_s: float = LAUNCH_DEADLINE_S) -> None:
    """torch.cuda.synchronize with a deadline: an event recorded on the
    current stream is polled, and work still running past the deadline (a
    segment barrier that never completes) raises TimeoutError naming
    `what` instead of stalling the script."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    while not ev.query():
        if time.perf_counter() - t0 > deadline_s:
            raise TimeoutError(f"{what}: the card did not finish within {deadline_s} s")
        time.sleep(0.0005)
    torch.cuda.synchronize()


def raw_launch(kernel, *args, target=None, segments=None):
    """A call of the kernel's C entry on the current stream with arguments
    packed once: no checks, allocation or launch count. A paged build's
    launch takes the next epoch of `segments` (the barrier's scratch) each
    call, so that its segment barrier waits as it does on the main path."""
    fn = kernel.fn(target)
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        if segments is not None:
            args[2][10] = segments.next_epoch()  # dims: the launch's epoch
        rc_ = fn(*args, stream)
        if rc_ != 0:
            raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc_}")

    return go


# -- kernels against their plain versions ------------------------------------


def quorum_inputs(rng, n: int, v: int, dev):
    """Random acked indexes (with ties) and voter masks, including empty
    configs (-> 2^31-1) and joint configs on about a third of the lanes."""
    match = rng.integers(0, 64, size=(n, v), dtype=np.int32)
    mask_in = rng.random((n, v)) < 0.7
    mask_in[rng.random(n) < 0.05] = False
    mask_out = (rng.random((n, v)) < 0.6) & (rng.random(n) < 0.3)[:, None]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return t(match), t(mask_in), t(mask_out)


def kernel_calls(match, mask_in, mask_out):
    """name -> (wrapper call, plain call, raw launch) on the same inputs;
    the raw launch writes a preallocated output."""
    n, v = match.shape
    vm = [qc.pack_voter_major(x) for x in (match, mask_in, mask_out)]
    out = torch.empty(n, dtype=torch.int32, device=match.device)
    p = [x.data_ptr() for x in (match, mask_in, mask_out, out)]
    pv = [x.data_ptr() for x in vm]
    k = qc.KERNELS
    return {
        "committed_kernel": (
            lambda: qc.committed(match, mask_in),
            lambda: qr.majority_committed(match, mask_in),
            raw_launch(k["committed_kernel"], p[0], p[1], p[3], n, v),
        ),
        "joint_kernel": (
            lambda: qc.joint_committed(match, mask_in, mask_out),
            lambda: qr.joint_committed_plain(match, mask_in, mask_out),
            raw_launch(k["joint_kernel"], p[0], p[1], p[2], p[3], n, v),
        ),
        "joint_kernel_vm": (
            lambda: qc.joint_committed_packed(*vm, v=v, n=n),
            lambda: qr.joint_committed_plain(match, mask_in, mask_out),
            raw_launch(k["joint_kernel_vm"], *pv, p[3], n, vm[0].shape[1], v),
        ),
    }


def bytes_moved(name: str, n: int, v: int) -> int:
    """Bytes the function must move: each input element it needs read
    once, the int32 output written once."""
    per_lane = {
        "committed_kernel": 4 * v + v + 4,  # match, one bool mask, out
        "joint_kernel": 4 * v + 2 * v + 4,  # match, two bool masks, out
        "joint_kernel_vm": 3 * 4 * v + 4,  # V rows of three int32 operands
    }[name]
    return per_lane * n


def ops_needed(name: str, n: int, v: int) -> int:
    """Scalar operations of csrc/quorum.cu per call: for each majority half,
    V mask tests, V masking selects, V voter-count adds, a min and a max per
    compare-swap of the odd-even network, V selects to pick the k-th element
    and a few for k and the empty test; the joint form adds two empty
    selects and the min of its halves."""
    swaps = sum(len(range(r & 1, v - 1, 2)) for r in range(v))
    half = 4 * v + 2 * swaps + 4
    per_lane = half + 1 if name == "committed_kernel" else 2 * half + 3
    return per_lane * n


def check_alignment(dev) -> list[str]:
    """Each lane-major wrapper on operands where one argument is a view one
    element off its allocation: it must raise ValueError naming that
    argument, and launch nothing."""
    rng = np.random.default_rng(7)
    refused = []
    for name, args in (("committed", ("match", "mask")),
                       ("joint_committed", ("match", "mask_in", "mask_out"))):
        for bad in args:
            ops = dict(zip(("match", "mask_in", "mask_out"),
                           quorum_inputs(rng, 1024, VOTERS, dev)))
            ops["mask"] = ops["mask_in"]
            x = ops[bad]
            off = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
            off.copy_(x)
            ops[bad] = off
            before = {k: q.launches for k, q in qc.KERNELS.items()}
            try:
                getattr(qc, name)(*(ops[a] for a in args))
            except ValueError as e:
                if bad not in str(e) or "aligned" not in str(e):
                    raise AssertionError(f"{name}: misaligned {bad} refused as {e!r}") from e
            else:
                raise AssertionError(f"{name} took a misaligned {bad}")
            if any(q.launches != before[k] for k, q in qc.KERNELS.items()):
                raise AssertionError(f"{name} launched on a misaligned {bad}")
            refused.append(f"{name}:{bad}")
    return refused


def check_kernels(dev) -> dict:
    rng = np.random.default_rng(20261016)
    err = {name: 0 for name in qc.KERNELS}
    cases = 0
    for v in range(1, qc.MAX_V + 1):
        for n in (BLOCK_LANES, BLOCK_LANES + 1, BLOCK_LANES + 2, BLOCK_LANES + 3, 100_003, 3):
            calls = kernel_calls(*quorum_inputs(rng, n, v, dev))
            for name, (kern, plain, _) in calls.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{name} v={v} n={n}: {got.shape}/{got.dtype}")
                diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
                err[name] = max(err[name], diff)
                cases += 1
    # bool masks whose storage holds bytes 2..255 (a bool view of uint8
    # data): every non-zero byte is a voter, as the plain version sees it
    for v in range(1, qc.MAX_V + 1):
        match, mask_in, mask_out = quorum_inputs(rng, BLOCK_LANES + 3, v, dev)

        def wide(m):
            scale = torch.from_numpy(rng.integers(1, 256, size=tuple(m.shape), dtype=np.uint8))
            return (m.to(torch.uint8) * scale.to(dev)).view(torch.bool)

        for name, got, want in (
            ("committed_kernel", qc.committed(match, wide(mask_in)),
             qr.majority_committed(match, mask_in)),
            ("joint_kernel", qc.joint_committed(match, wide(mask_in), wide(mask_out)),
             qr.joint_committed_plain(match, mask_in, mask_out)),
        ):
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
            err[name] = max(err[name], diff)
            cases += 1
    bad = {k: e for k, e in err.items() if e != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    # time at the main path's shape: one block's lanes, V = 3
    calls = kernel_calls(*quorum_inputs(rng, BLOCK_LANES, VOTERS, dev))
    rows = {}
    for name, (kern, plain, raw) in calls.items():
        b = bytes_moved(name, BLOCK_LANES, VOTERS)
        ops = ops_needed(name, BLOCK_LANES, VOTERS)
        bytes_ms, ops_ms = 1e3 * b / HBM_BYTES_PER_S, 1e3 * ops / SCALAR_OPS_PER_S
        rows[name] = dict(
            max_abs_err=err[name],
            ms=profiled_ms(raw, name, cold=True),
            warm_ms=profiled_ms(raw, name),
            raw_event_ms=cuda_ms(raw),
            wrapper_ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain, iters=50),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=b,
            ops=ops,
        )
    emit("kernels", cases=cases, refused=check_alignment(dev), shape=[BLOCK_LANES, VOTERS],
         timing=rows, floor=floor_timing(dev))
    return rows


def floor_timing(dev) -> dict:
    """The fixed cost under committed_kernel and joint_kernel at the main
    path's shape, on their grid (csrc/quorum.cu raft_quorum_floor_*): an
    empty launch, and for each kernel a read of its input bytes in 16-byte
    words that writes its output bytes; ms with the L2 cache overwritten
    before each launch, warm_ms back to back, as the kernels are timed."""
    lib = build.load("quorum")
    empty, read = lib.raft_quorum_floor_empty, lib.raft_quorum_floor_read
    empty.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p]
    empty.restype = read.restype = ctypes.c_int
    n = BLOCK_LANES
    out_bytes = 4 * n
    in_bytes = {k: bytes_moved(k, n, VOTERS) - out_bytes
                for k in ("committed_kernel", "joint_kernel")}
    src = torch.zeros(max(in_bytes.values()) // 4 + 4, dtype=torch.int32, device=dev)
    sink = torch.empty(out_bytes // 4 + 4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def go(fn, *args):
        def launch():
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
        return launch

    runs = {"empty": (go(empty, n), "floor_empty", 0)}
    for k, b in in_bytes.items():
        runs[f"read_{k}"] = (go(read, src.data_ptr(), b // 16, sink.data_ptr(), n),
                             "floor_read", b + out_bytes)
    rows = {}
    for name, (launch, kernel, b) in runs.items():
        rows[name] = dict(ms=profiled_ms(launch, kernel, cold=True),
                          warm_ms=profiled_ms(launch, kernel), bytes=b)
    return rows


# -- the card against the CPU ------------------------------------------------


def check_parity():
    g = 64
    leaves = {}
    for dev in ("cuda", "cpu"):
        c = FusedCluster(g, VOTERS, seed=11, shape=bench_shape(g * VOTERS), device=dev)
        c.run(33, auto_propose=True, auto_compact_lag=4)
        leaves[dev] = (
            interop.to_numpy_leaves(c.state)
            + interop.to_numpy_leaves(c.fab)
            + interop.to_numpy_leaves(c.metrics)
        )
        leaders = len(c.leader_lanes())
    d_gpu, d_cpu = interop.digest(leaves["cuda"]), interop.digest(leaves["cpu"])
    emit("parity", groups=g, rounds=33, digest_cuda=d_gpu, digest_cpu=d_cpu,
         leaders=leaders)
    if d_gpu != d_cpu:
        diff = [
            i for i, (a, b) in enumerate(zip(leaves["cuda"], leaves["cpu"]))
            if not np.array_equal(a, b)
        ]
        raise AssertionError(f"card and CPU diverge at leaves {diff}")
    if leaders == 0:
        raise AssertionError("parity cluster elected no leader in 33 rounds")


# -- the main path -------------------------------------------------------------


def host_digest(c) -> str:
    """sha256 over every block's host_state leaves (the slim view, whether
    or not the carry is packed), block after block."""
    return interop.digest(*(interop.to_numpy_leaves(b.host_state()) for b in c.blocks))


def carry_bytes_per_lane(c) -> float:
    """Device bytes of the resident carry (state, config and fabric leaves)
    per lane."""
    total = sum(x.numel() * x.element_size() for b in c.blocks
                for x in rc._state_leaves(b.state) + rc._cfg_leaves(b.state)
                + rc._fab_leaves(b.fab))
    return total / (c.g * c.v)


def run_main(dev, phase="main", **engine):
    lag = 8
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c = BlockedFusedCluster(
        MAIN_GROUPS, VOTERS, block_groups=MAIN_BLOCK_GROUPS, seed=42,
        shape=bench_shape(BLOCK_LANES), round_chunk=8, device=dev, **engine,
    )
    qc.reset_launches()
    rc.reset_launches()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rounds = 0
    t0 = time.perf_counter()
    while True:  # bench.py: one block of 32 rounds, then until all elected
        c.run(32, auto_propose=True, auto_compact_lag=lag)
        rounds += 32
        if c.leader_count() == MAIN_GROUPS:
            break
        if rounds > WARM_LIMIT:
            raise RuntimeError(
                f"warm-up stalled: {c.leader_count()}/{MAIN_GROUPS} after {rounds} rounds"
            )
    warm_s = time.perf_counter() - t0
    com0 = c.total_committed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c.run(TIMED_ROUNDS, auto_propose=True, auto_compact_lag=lag)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rounds += TIMED_ROUNDS
    launches = {name: k.launches for name, k in {**qc.KERNELS, **rc.KERNELS}.items()}
    commits = c.total_committed() - com0
    c.check_no_errors()
    snap = c.metrics_snapshot()
    leaders = c.leader_count()
    k = engine.get("rounds_per_call", 1)
    pallas = engine.get("engine") == "pallas"
    expect = rounds * c.k // k
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    extra = {}
    if pallas:
        extra = dict(carry_bytes_per_lane=carry_bytes_per_lane(c), digest=host_digest(c))
    emit(
        phase, **engine,
        groups=MAIN_GROUPS, voters=VOTERS, blocks=c.k, block_groups=MAIN_BLOCK_GROUPS,
        setup_s=setup_s, warm_rounds=rounds - TIMED_ROUNDS, warm_s=warm_s,
        timed_rounds=TIMED_ROUNDS, timed_s=dt,
        groups_ticks_per_s=MAIN_GROUPS * TIMED_ROUNDS / dt,
        round_ms=1e3 * dt / TIMED_ROUNDS,
        commits_per_group_round=commits / (MAIN_GROUPS * VOTERS * TIMED_ROUNDS),
        leaders=leaders, check_no_errors=True,
        metrics={k: v for k, v in snap["counters"].items() if v},
        launches=launches, expected_launches=expect, peak_mem_gb=peak_gb, **extra,
    )
    if leaders != MAIN_GROUPS or commits <= 0:
        raise AssertionError(f"{phase}: {leaders} leaders, {commits} commits")
    if pallas and commits != MAIN_GROUPS * VOTERS * TIMED_ROUNDS:
        raise AssertionError(f"{phase}: commits per group-round is not 1.0")
    diet = engine.get("diet", False)
    want = {"joint_kernel": 0 if pallas else expect}
    if pallas:
        want.update(round_kernel_diet=expect if diet else 0, round_kernel=0 if diet else expect)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{phase}: {name} launched {launches[name]} times, expected {n}")
    return c, launches, 1e3 * dt / TIMED_ROUNDS, dict(round_ms=1e3 * dt / TIMED_ROUNDS,
                                                      peak_mem_gb=peak_gb, **extra)


# -- the round megakernel ------------------------------------------------------


def carry_leaves(st, fb, samp, parts) -> list:
    """(name, numpy leaf) of one launch's outputs, in packing order (the
    lease columns after the other state leaves)."""
    names = rc.dataclass_names()
    out = [("state." + n, x) for n, x in zip(names["STATE"], interop.to_numpy_leaves(st))]
    if st.lease_left is not None:
        out += [("state." + n, getattr(st, n).cpu().numpy()) for n in LEASE_STATE_FIELDS]
    out += [("fabric." + n, x) for n, x in zip(names["FABRIC"], interop.to_numpy_leaves(fb))]
    if samp is not None:
        out += [("samp_index", samp[0].cpu().numpy()), ("samp_round", samp[1].cpu().numpy())]
    if parts is not None:
        out += [("partials", parts.cpu().numpy())]
    return out


def first_difference(a, b) -> str | None:
    for (name, x), (_, y) in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            return name
    return None


def launch_pair(c, ops, k, first, *, cta, mute):
    """One launch of the kernel and of its plain version on the same card
    inputs (c's carry); returns both results."""
    m = c.metrics
    kw = dict(v=c.v, kc=k, cta=cta, apply_ops=first, ops_round0_only=True,
              do_tick=True, auto_propose=True, auto_compact_lag=4)
    args = (c.state, c.fab, ops, mute, (m.samp_index, m.samp_round), m.round_ctr)
    return rc.round_call(*args, **kw), plr.round_kernel_ref(*args, **kw)


def check_round_kernel(dev):
    """The kernel against round_kernel_ref over 9 rounds per case, launched
    as pallas_rounds launches them; raises naming the first differing leaf."""
    cases = 0
    for v in (3, 5):
        for k in (1, 4):
            for seed in (5, 17):
                g = 16
                c = FusedCluster(g, v, seed=seed, device=dev, shape=Shape(
                    n_lanes=g * v, max_peers=v, log_window=16, max_msg_entries=2,
                    max_inflight=2, max_read_index=2))
                c.run(12, auto_propose=True, auto_compact_lag=4)  # eager warm-up
                c.set_mute([v + 1])
                n = g * v
                ops = c.ops(hup={0: True, 2 * v: True}, prop_n={1: 2, v: 1}, prop_bytes=7,
                            read_ctx={i: 100 + i for i in range(n)},
                            transfer_to={i: (i % v) + 1 for i in range(3 * v, 5 * v)})
                plan = [k] * (9 // k) + ([9 % k] if 9 % k else [])
                for i, kc in enumerate(plan):
                    got, want = launch_pair(c, ops, kc, i == 0, cta=2 * v, mute=c.mute)
                    torch.cuda.synchronize()
                    a, b = carry_leaves(*got), carry_leaves(*want)
                    bad = first_difference(a, b)
                    if bad is not None or interop.digest([x for _, x in a]) != interop.digest(
                        [x for _, x in b]
                    ):
                        raise AssertionError(
                            f"round_kernel v={v} K={k} seed={seed} launch {i}: "
                            f"first differing leaf {bad}"
                        )
                    c.state, c.fab = got[0], got[1]
                    c.metrics = plr.fold_partials(c.metrics, got[2], got[3], kc)
                    cases += 1
    emit("round_kernel", launches_compared=cases, cases="V{3,5} x K{1,4} x seeds{5,17}",
         rounds_per_case=9, max_abs_err=0)


def check_parity_pallas():
    g = 64
    out = {}
    for k in (1, 3):
        digests = {}
        for dev, engine in (("cuda", dict(engine="pallas", rounds_per_call=k)), ("cpu", {})):
            c = FusedCluster(g, VOTERS, seed=11, shape=bench_shape(g * VOTERS), device=dev, **engine)
            c.run(33, auto_propose=True, auto_compact_lag=4)
            digests[dev] = interop.digest(
                interop.to_numpy_leaves(c.state) + interop.to_numpy_leaves(c.fab)
                + interop.to_numpy_leaves(c.metrics)
            )
        out[f"K{k}"] = digests
        if digests["cuda"] != digests["cpu"]:
            raise AssertionError(f"parity_pallas K={k}: card {digests['cuda']} != cpu {digests['cpu']}")
    emit("parity_pallas", groups=g, rounds=33, digests=out)


def diet_cluster(dev, g: int, seed: int, near: bool):
    """A diet cluster of g groups x 3 voters at the bench widths, warmed 12
    eager rounds; with `near`, its index space fast-forwarded to just under
    65,535 (a negative rebase), so that the next rounds overflow the packed
    uint16 columns."""
    c = FusedCluster(g, VOTERS, seed=seed, device=dev, shape=bench_shape(g * VOTERS),
                     diet=True)
    c.run(12, auto_propose=True, auto_compact_lag=4)
    if near:
        approach_u16_top(c)
    return c


def approach_u16_top(c, top: int = 65531):
    """Fast-forward c's index space by a window-aligned negative rebase,
    then run eager rounds past FusedCluster.run (whose automatic rebase
    would undo it) until the largest index is `top`: a few appends short
    of the packed uint16 range."""
    w = c.shape.w
    c.rebase_groups(range(c.g), delta=-(((top - int(c.host_state().last.max())) // w) * w))
    while int(c.host_state().last.max()) < top:
        c.state, c.fab, c.metrics = fused_rounds(
            c.state, c.fab, c._no_ops, c.mute, v=c.v, n_rounds=1, auto_propose=True,
            auto_compact_lag=4, metrics=c.metrics)


def check_round_kernel_diet(dev):
    """The diet build against round_kernel_ref on the packed carry over 9
    rounds per case, launched as pallas_rounds launches them at K = 1, 3
    and 8, on a carry in range and on one that overflows the packed uint16
    columns (its clamps and ERR_DIET_OVERFLOW bits must agree too); raises
    naming the first differing leaf."""
    cases, flagged = 0, 0
    for near in (False, True):
        for k in (1, 3, 8):
            c = diet_cluster(dev, 16, seed=5, near=near)
            c.set_mute([4])
            n = c.g * c.v
            ops = c.ops(hup={0: True}, prop_n={i: 2 for i in range(n)}, prop_bytes=7,
                        read_ctx={i: 100 + i for i in range(n)})
            plan = [k] * (9 // k) + ([9 % k] if 9 % k else [])
            for i, kc in enumerate(plan):
                got, want = launch_pair(c, ops, kc, i == 0, cta=2 * c.v, mute=c.mute)
                torch.cuda.synchronize()
                bad = first_difference(carry_leaves(*got), carry_leaves(*want))
                if bad is not None:
                    raise AssertionError(f"round_kernel_diet K={k} near={near} launch {i}: "
                                         f"first differing leaf {bad}")
                c.state, c.fab = got[0], got[1]
                c.metrics = plr.fold_partials(c.metrics, got[2], got[3], kc)
                cases += 1
            hit = int(((c.state.error_bits & ERR_DIET_OVERFLOW) != 0).sum())
            if (hit > 0) != near:
                raise AssertionError(f"round_kernel_diet K={k} near={near}: {hit} lanes flagged")
            flagged += hit
    emit("round_kernel_diet", launches_compared=cases, cases="K{1,3,8} x {in range, overflow}",
         rounds_per_case=9, overflow_lanes_flagged=flagged, max_abs_err=0)


def check_parity_diet():
    """diet=True on the card against the eager CPU path with diet=True, 64
    groups x 33 rounds: the eager engine and engine="pallas" at K=1 and 3;
    the CPU's diet host_state against its slim run; and a run through the
    automatic rebase: fast-forward by 48 Ki, run on (the rebase fires
    before the next dispatch), pallas K=3 on the card against the CPU."""
    g = 64
    shape = bench_shape(g * VOTERS)

    def run(dev, diet=True, **engine):
        c = FusedCluster(g, VOTERS, seed=11, shape=shape, device=dev, diet=diet, **engine)
        c.run(33, auto_propose=True, auto_compact_lag=4)
        return c

    def digest(c):
        return interop.digest(interop.to_numpy_leaves(c.state) + interop.to_numpy_leaves(c.fab)
                              + interop.to_numpy_leaves(c.metrics))

    cpu = run("cpu")
    out = {"cpu": digest(cpu)}
    if interop.digest(interop.to_numpy_leaves(cpu.host_state())) != interop.digest(
            interop.to_numpy_leaves(run("cpu", diet=False).state)):
        raise AssertionError("parity_diet: the CPU's diet host_state differs from its slim run")
    for name, engine in (("eager", {}), ("pallas_k1", dict(engine="pallas", rounds_per_call=1)),
                         ("pallas_k3", dict(engine="pallas", rounds_per_call=3))):
        out[name] = digest(run("cuda", **engine))
        if out[name] != out["cpu"]:
            raise AssertionError(f"parity_diet {name}: card {out[name]} != cpu {out['cpu']}")
    rebased = {}
    for dev, engine in (("cuda", dict(engine="pallas", rounds_per_call=3)), ("cpu", {})):
        c = run(dev, **engine)
        c.rebase_groups(range(g), delta=-(48 * 1024))
        before = int(c.state_columns("last")["last"].max())
        c.run(15, auto_propose=True, auto_compact_lag=4)
        after = int(c.state_columns("last")["last"].max())
        if before < 48 * 1024 or after >= c.DIET_REBASE_AT:
            raise AssertionError(f"parity_diet rebase on {dev}: last {before} -> {after}")
        c.check_no_errors()
        rebased[dev] = dict(max_last_before=before, max_last_after=after, digest=digest(c))
    if rebased["cuda"]["digest"] != rebased["cpu"]["digest"]:
        raise AssertionError("parity_diet: card and CPU differ after the automatic rebase")
    emit("parity_diet", groups=g, rounds=33, digests=out, auto_rebase=rebased)


def check_eager_diet(dev):
    """The eager engine with diet=True on 2 blocks of the main path's
    blocks, 40 rounds: its host_state digest against the slim run's."""
    out = {}
    for diet in (False, True):
        c = BlockedFusedCluster(2 * MAIN_BLOCK_GROUPS, VOTERS, block_groups=MAIN_BLOCK_GROUPS,
                                seed=42, shape=bench_shape(BLOCK_LANES), round_chunk=8,
                                device=dev, diet=diet)
        c.run(40, auto_propose=True, auto_compact_lag=8)
        c.check_no_errors()
        out[diet] = dict(digest=host_digest(c), total_committed=c.total_committed(),
                         leaders=c.leader_count())
        del c
    emit("eager_diet", blocks=2, block_groups=MAIN_BLOCK_GROUPS, rounds=40,
         slim=out[False], diet=out[True])
    if out[True] != out[False]:
        raise AssertionError("eager_diet: the diet run differs from the slim run")


def round_bytes(args, outputs) -> int:
    """Bytes one launch must move: every input leaf read once, every output
    leaf written once (cfg is read; the output state shares it)."""
    st, fb, ops, mute, samp, ctr = args
    ins = (interop.to_numpy_leaves(st) + interop.to_numpy_leaves(fb)
           + interop.to_numpy_leaves(ops) + [mute.cpu().numpy()]
           + [x.cpu().numpy() for x in samp] + [ctr.cpu().numpy()])
    ost, ofb, osamp, parts = outputs
    outs = ([x for _, x in carry_leaves(ost, ofb, osamp, parts)])
    return sum(x.nbytes for x in ins) + sum(x.nbytes for x in outs)


def round_ops(n: int, v: int, w: int, e: int, f: int, r: int) -> int:
    """An estimate of the integer operations of one round per lane, from the
    loops of csrc/round.cu: each leaf element widened and narrowed; the
    window scans (find_conflict_by_term once per peer and once for the
    follower, bytes_between, has_unapplied_conf_changes, about 6 operations
    per slot); about 150 per peer cell over the fan-in and fan-out; the
    ReadIndex ack tally (R x V hits and the R x R rank); and about 300
    scalar ones."""
    elems = (30 + 3 * w + 15 * v + 2 * v * f + 9 * r + r * v) + (26 * v + 3 * v * e + 3)
    per_lane = 2 * elems + (v + 1) * w * 6 + 2 * w * 6 + 150 * v + 6 * r * v + 7 * r * r + 300
    return per_lane * n


def ptxas_report(log: str) -> list[dict]:
    """Per kernel function of nvcc's -Xptxas -v output: registers, stack
    frame and spill bytes."""
    out = []
    for m in re.finditer(
        r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) bytes spill "
        r"stores, (\d+) bytes spill loads.*?Used (\d+) registers", log, re.S,
    ):
        out.append(dict(function=m.group(1), stack_bytes=int(m.group(2)),
                        spill_stores=int(m.group(3)), spill_loads=int(m.group(4)),
                        registers=int(m.group(5))))
    return out


def engine_cta(d: dict) -> int:
    """The CUDA block the pallas engine uses for a 65,536-group block."""
    n = MAIN_BLOCK_GROUPS * d["v"]
    return rc.cta_lanes(plr.default_tile(n, d["v"]), d["v"], d)


def build_all() -> None:
    t0 = time.perf_counter()
    built = build.build("quorum", *(rc.target(*b) for b in ROUND_BUILDS),
                        *(rc.target(*b, stamps=True) for b in STAMP_BUILDS))
    rows = {}
    for key, b in built.items():
        fns = ptxas_report(b.log)
        rows[key] = dict(nvcc_s=b.seconds)
        if key == "quorum":
            rows[key]["max_registers"] = max((f["registers"] for f in fns), default=None)
            rows[key]["spill_bytes"] = sum(f["spill_stores"] + f["spill_loads"] for f in fns)
            # kernel<V>: [registers, stack bytes, spill bytes]
            rows[key]["ptxas"] = {
                "{}<{}>".format(*m.groups()):
                    [f["registers"], f["stack_bytes"], f["spill_stores"] + f["spill_loads"]]
                for f in fns
                if (m := re.search(r"((?:committed|joint)_kernel(?:_vm)?)ILi(\d)E",
                                   f["function"]))
            }
        else:
            rows[key]["ptxas"] = [f for f in fns if "round_kernel" in f["function"]]
            rows[key]["spill_bytes"] = sum(f["spill_stores"] + f["spill_loads"]
                                           for f in rows[key]["ptxas"])
            was = TWO_BUFFERS.get(key)
            rows[key]["two_buffers"] = was and dict(
                zip(("smem_bytes", "blocks_per_sm", "registers", "spill_bytes"), was))
    for b in ROUND_BUILDS:
        rows[rc.target(*b).key].update(cta_lanes=b[1], **rc.occupancy(*b[:5], lease=b[5]))
    for b in STAMP_BUILDS:
        t = rc.target(*b, stamps=True)
        slots = build.load(t).raft_round_stamps()
        if slots != rc.stamp_slots():
            raise AssertionError(f"{t.key}: {slots} stamp slots, the wrapper reads "
                                 f"{rc.stamp_slots()}")
        rows[t.key].update(cta_lanes=b[1], **rc.occupancy(*b[:5], lease=b[5], stamps=True))
    emit("build", seconds=time.perf_counter() - t0, targets=rows)


def time_round_kernel(c, phase="round_kernel_timing"):
    """Launches at the main path's shape (block 0's carry) against the plain
    version, K=1 and K=8; the kernel timed on raw launches (the arguments
    packed once: the wrapper's per-call packing, about a millisecond of host
    time, would otherwise set the pace) beside its wrapper, the plain
    version and the bound; then, for the slim build, raw K=1 launches at
    other CUDA blocks. A packed carry (diet=True) times the diet build."""
    b = c.blocks[0]
    shape = b.shape
    d = rc.dims_of(b.state, b.fab, b.v)
    cta = engine_cta(d)
    m = b.metrics
    args = (b.state, b.fab, b._no_ops, b.mute, (m.samp_index, m.samp_round), m.round_ctr)
    diet = b._diet
    kern = rc.KERNELS["round_kernel_diet" if diet else "round_kernel"]

    def kw(kc, cta=cta):
        return dict(v=b.v, kc=kc, cta=cta, apply_ops=True, ops_round0_only=True,
                    do_tick=True, auto_propose=True, auto_compact_lag=8)

    def raw(kc, cta=cta):
        ptrs, dims, flags, lag, outs = rc.pack(*args, **kw(kc, cta))
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        return raw_launch(kern, arr, nptr, cdims, flags, lag,
                          target=rc.target(d, cta, diet)), outs

    def carry(res):  # state and fabric: the same at every CUDA block
        return [x for x in carry_leaves(*res) if x[0].startswith(("state.", "fabric."))]

    rows = {}
    wants = {}
    for kc in (1, 8):
        go, outs = raw(kc)
        go()
        wants[kc] = plr.round_kernel_ref(*args, **kw(kc))
        torch.cuda.synchronize()
        bad = first_difference(carry_leaves(*outs), carry_leaves(*wants[kc]))
        if bad is not None:
            raise AssertionError(f"{kern.name} K={kc} at the main path's shape: "
                                 f"first differing leaf {bad}")
        nbytes = round_bytes(args, outs)
        ops = kc * round_ops(shape.n_lanes, b.v, shape.log_window, shape.max_msg_entries,
                             shape.max_inflight, shape.max_read_index)
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / SCALAR_OPS_PER_S
        ms = cuda_ms(go, iters=50 if kc == 1 else 10)
        rows[kc] = dict(
            max_abs_err=0, ms=ms, ms_per_round=ms / kc,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, ops=ops, rounds=kc,
        )
        if kc == 1:
            rows[kc].update(
                profiled_ms=profiled_ms(go, "round_kernel", iters=20),
                **rc.occupancy(d, cta, diet),
                wrapper_ms=cuda_ms(lambda: rc.round_call(*args, **kw(1)), iters=20),
                plain_ms=cuda_ms(lambda: plr.round_kernel_ref(*args, **kw(1)), iters=3),
            )
        del go, outs
    sweep = {}
    tile = b._pallas_tile
    for cb in [] if diet else sorted({48, 96, 192, cta}):
        if tile % cb or cb % b.v or rc.smem_bytes(d, cb) > rc.MAX_SMEM:
            continue
        sweep[cb] = rc.occupancy(d, cb)
        for kc in (1, 8):
            go, outs = raw(kc, cb)
            go()
            torch.cuda.synchronize()
            bad = first_difference(carry(outs), carry(wants[kc]))
            if bad is not None:
                raise AssertionError(f"round_kernel K={kc} at cta={cb}: first differing leaf {bad}")
            sweep[cb][f"k{kc}_ms"] = cuda_ms(go, iters=50 if kc == 1 else 10)
            del go, outs
    row = dict(rows[1], cta_lanes=cta, lanes=shape.n_lanes, k8=rows[8], cta_sweep=sweep)
    emit(phase, **row)
    return row



# -- the paged entry log (in-kernel paging) ------------------------------------


def paged_shape(n_lanes: int, pool: int = 0) -> Shape:
    """The bench shape with benches/paged_ab.py's paging geometry (W=16, a
    resident tail of 8, pages of 4 entries); pool 0 provisions fully."""
    return Shape(n_lanes=n_lanes, max_peers=VOTERS, log_window=16, page_window=8,
                 page_entries=4, max_msg_entries=2, max_inflight=2, max_read_index=2,
                 pool_pages=pool)


def paged_leaves(pg) -> list:
    return [("paged." + k, x) for k, x in zip(rc.PAGED_LEAVES, interop.to_numpy_leaves(pg))]


def check_round_kernel_paged(dev):
    """The paged builds against round_kernel_ref on the card: slim and diet,
    K = 1 and 8, a full pool and one of 8 pages a segment (lanes exhaust),
    on a 16-group cluster in 6-lane tiles (8 allocation segments) warmed
    12 rounds: two 9-round dispatches with proposals as pallas_rounds
    launches them, then quiet launches (no tick, no proposals) until the
    allocator is skipped; every carry leaf, partials row and PagedLog leaf
    exact after each launch; raises naming the first differing leaf."""
    cases = skipped = exhausted = 0
    for diet in (False, True):
        for k in (1, 8):
            for pool in (0, 64):
                c = FusedCluster(16, VOTERS, seed=5, device=dev, shape=paged_shape(48, pool),
                                 diet=diet, engine="pallas", tile_lanes=6, paged=True,
                                 paged_inkernel=True)
                c.run(12, auto_propose=True, auto_compact_lag=12)
                n = c.g * c.v
                ops = c.ops(prop_n={i: 2 for i in range(n)}, prop_bytes=7)
                plan = [k] * (9 // k) + ([9 % k] if 9 % k else [])
                launches = [(kc, i == 0, False) for i, kc in enumerate(plan)] * 2
                # quiet launches until the allocator is skipped: 6 rounds at
                # K=1, 16 at K=8
                launches += [(k, False, True)] * (6 if k == 1 else 2)
                skip0 = int(c.paged.skipped.sum())
                for i, (kc, first, quiet) in enumerate(launches):
                    m = c.metrics
                    kw = dict(v=c.v, kc=kc, cta=6, apply_ops=first, ops_round0_only=True,
                              do_tick=not quiet, auto_propose=not quiet, auto_compact_lag=12,
                              paged=c.paged)
                    args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round),
                            m.round_ctr)
                    got = rc.round_call(*args, **kw)
                    synchronize(f"round_kernel_paged diet={diet} K={k} pool={pool} launch {i}")
                    want = plr.round_kernel_ref(*args, **kw)
                    bad = first_difference(carry_leaves(*got[:4]) + paged_leaves(got[4]),
                                           carry_leaves(*want[:4]) + paged_leaves(want[4]))
                    if bad is not None:
                        raise AssertionError(f"round_kernel_paged diet={diet} K={k} pool={pool} "
                                             f"launch {i}: first differing leaf {bad}")
                    c.state, c.fab, c.paged = got[0], got[1], got[4]
                    c.metrics = plr.fold_partials(c.metrics, got[2], got[3], kc)
                    cases += 1
                skips = int(c.paged.skipped.sum()) - skip0
                hit = int(((c.state.error_bits & ERR_PAGE_EXHAUSTED) != 0).sum())
                if skips <= 0 or (hit > 0) != (pool > 0):
                    raise AssertionError(f"round_kernel_paged diet={diet} K={k} pool={pool}: "
                                         f"{skips} skipped lanes, {hit} exhausted lanes")
                skipped += skips
                exhausted += hit
    emit("round_kernel_paged", launches_compared=cases,
         cases="{slim, diet} x K{1,8} x {full pool, 8 pages a segment}",
         lanes=48, tile_lanes=6, skipped_lane_launches=skipped, exhausted_lanes=exhausted,
         max_abs_err=0)


# the multi-block segments: (CUDA blocks a segment, pool pages, whether it
# exhausts) on 65,536 groups (2,048 blocks of 96 lanes); every SEG_HOT-th
# group proposes, so that 65,536 pages hold the demand even of 192-lane
# segments (64 pages) and 16,384 (16 a 192-lane segment) do not
SEG_CASES = ((2, 65_536, False), (32, 65_536, False), (64, 65_536, False), (2, 16_384, True))
SEG_HOT = 8


def check_round_kernel_segments(dev):
    """Allocation segments of several CUDA blocks on a grid of 2,048
    blocks, more than the card holds at once: for each SEG_CASES entry a
    65,536-group cluster paging in the kernel at a tile of that many
    96-lane blocks elects (every group campaigns) and takes proposals on
    every SEG_HOT-th group through the engine, then three launches (K=1
    and K=8 with proposals, one quiet K=1) of the paged build with its
    segment barrier against round_kernel_ref over the same segments; every
    carry, partials and PagedLog leaf exact; the 16,384-page pool must
    exhaust and the others must not."""
    g, cta = MAIN_BLOCK_GROUPS, 96
    n = g * VOTERS
    rows = {}
    for bps, pool, exhausts in SEG_CASES:
        tile = bps * cta
        c = FusedCluster(g, VOTERS, seed=5, device=dev, shape=paged_shape(n, pool),
                         engine="pallas", tile_lanes=tile, paged=True, paged_inkernel=True)
        if c._segments is None or c._paged_segs != n // tile:
            raise AssertionError(f"round_kernel_paged_segments: tile {tile} is not {bps} "
                                 f"blocks a segment")
        lag = dict(auto_compact_lag=12)
        hot = c.ops(prop_n={x * VOTERS: 2 for x in range(0, g, SEG_HOT)}, prop_bytes=5)
        c.run(1, ops=c.ops(hup={x * VOTERS: True for x in range(g)}), **lag)
        c.run(3, **lag)
        for _ in range(8):
            c.run(1, ops=hot, **lag)
        synchronize(f"round_kernel_paged_segments bps={bps} warm-up")
        for i, (kc, ops, quiet) in enumerate(((1, hot, False), (8, hot, False),
                                               (1, None, True), (1, None, True))):
            m = c.metrics
            kw = dict(v=VOTERS, kc=kc, cta=cta, apply_ops=ops is not None, ops_round0_only=True,
                      do_tick=not quiet, auto_propose=False, paged=c.paged, seg_lanes=tile, **lag)
            args = (c.state, c.fab, ops or c._no_ops, c.mute, (m.samp_index, m.samp_round),
                    m.round_ctr)
            got = rc.round_call(*args, segments=c._segments, **kw)
            synchronize(f"round_kernel_paged_segments bps={bps} pool={pool} launch {i}")
            want = plr.round_kernel_ref(*args, **kw)
            bad = first_difference(carry_leaves(*got[:4]) + paged_leaves(got[4]),
                                   carry_leaves(*want[:4]) + paged_leaves(want[4]))
            if bad is not None:
                raise AssertionError(f"round_kernel_paged_segments bps={bps} pool={pool} "
                                     f"launch {i}: first differing leaf {bad}")
            c.state, c.fab, c.paged = got[0], got[1], got[4]
            c.metrics = plr.fold_partials(m, got[2], got[3], kc)
        stats = c.paged_stats()
        exhausted = int(((c.state.error_bits & ERR_PAGE_EXHAUSTED) != 0).sum())
        rows[f"{bps}x{pool}"] = dict(
            blocks_per_segment=bps, tile_lanes=tile, segments=n // tile, pool_pages=pool,
            grid_blocks=n // cta, resident_blocks=rc.resident_blocks(
                rc.dims_of(c.state, c.fab, VOTERS, c.paged), cta, dev, False, PAGED_PLAN),
            exhausted_lanes=exhausted, pool_in_use=stats["paged_pool_in_use"],
            skipped_lane_launches=stats["paged_alloc_skipped"], leaders=len(c.leader_lanes()))
        if (exhausted > 0) != exhausts or stats["paged_pool_in_use"] == 0:
            raise AssertionError(f"round_kernel_paged_segments bps={bps} pool={pool}: "
                                 f"{rows[f'{bps}x{pool}']}")
        del c
        torch.cuda.empty_cache()
    emit("round_kernel_paged_segments", lanes=n, cta_lanes=cta, cases=rows, max_abs_err=0)


def check_parity_paged():
    """Paged pallas engine (K=3) on the card against the CPU, 64 groups x 33
    rounds at compaction lag 12, in-kernel (the default tile: one segment
    of two 96-lane CUDA blocks) and at the dispatch boundary: one sha256
    over every state,
    fabric, metrics and PagedLog leaf; the host_state of each equal to the
    unpaged CPU run's."""
    g = 64
    shape = paged_shape(g * VOTERS)

    def run(dev, **kw):
        c = FusedCluster(g, VOTERS, seed=11, shape=shape, device=dev, engine="pallas",
                         rounds_per_call=3, **kw)
        c.run(33, auto_propose=True, auto_compact_lag=12)
        return c

    flat = interop.digest(interop.to_numpy_leaves(run("cpu").host_state()))
    out = {}
    for mode, kw in (("inkernel", dict(paged=True, paged_inkernel=True)),
                     ("boundary", dict(paged=True))):
        d = {}
        for dev in ("cuda", "cpu"):
            c = run(dev, **kw)
            d[dev] = interop.digest(interop.to_numpy_leaves(c.state) + interop.to_numpy_leaves(c.fab)
                                    + interop.to_numpy_leaves(c.metrics)
                                    + interop.to_numpy_leaves(c.paged))
            d[f"{dev}_host"] = interop.digest(interop.to_numpy_leaves(c.host_state()))
            d[f"{dev}_segs"] = c._paged_segs
            d[f"{dev}_stats"] = c.paged_stats()
        out[mode] = d
        if d["cuda"] != d["cpu"] or d["cuda_host"] != flat:
            raise AssertionError(f"parity_paged {mode}: card {d['cuda']} cpu {d['cpu']}, "
                                 f"host {d['cuda_host']} flat {flat}")
        if d["cuda_stats"]["paged_pool_in_use"] == 0:
            raise AssertionError(f"parity_paged {mode}: the pool was never used")
    emit("parity_paged", groups=g, rounds=33, flat_host_digest=flat, **out)


def zipf_sweeps(c, sweeps: int) -> list:
    """benches/paged_ab.py:120-137 on the whole cluster: groups ranked by a
    seeded shuffle, rank r proposing every 2^min(bit_length(r), 5) sweeps
    at its leader (rank 0 two entries a sweep, the others one): the
    global-lane LocalOps of sweeps 0..sweeps-1."""
    st = c.state_columns("state")["state"]
    lanes = np.nonzero(st == 2)[0]  # StateType.LEADER
    leader_of = np.full(c.g, -1, np.int64)
    leader_of[(lanes // c.v)[::-1]] = lanes[::-1]  # the first leader lane of a group
    rank = np.random.default_rng(7).permutation(c.g)
    bits = np.zeros_like(rank)
    nz = rank > 0
    bits[nz] = np.floor(np.log2(rank[nz])).astype(rank.dtype) + 1
    period = 1 << np.minimum(bits, 5)
    out = []
    for s in range(sweeps):
        prop = np.zeros(c.g * c.v, np.int32)
        on = (s % period == 0) & (leader_of >= 0)
        prop[leader_of[on]] = np.where(rank[on] == 0, 2, 1)
        out.append(c.prepare_ops(c.ops(prop_n=prop)))
    return out


def paged_bytes_per_lane(c) -> float:
    """carry_bytes_per_lane plus the PagedLog sidecar's bytes."""
    side = sum(tpg.paged_bytes_per_lane(b.paged) * b.shape.n_lanes for b in c.blocks
               if b.paged is not None)
    return carry_bytes_per_lane(c) + side / (c.g * c.v)


def run_main_paged(dev, phase: str, pool: int, **paging):
    """The paged main path at full width: 1,048,576 groups x 3 as 64 blocks
    of 16,384 on engine="pallas" at K=8 (round_chunk 8), with
    benches/paged_ab.py's traffic: elect under the shallow compaction lag
    W_res / 2 = 4, then 4 Zipf sweeps of 16 rounds at lag W - 4 = 12 to
    shape the depth profile, and 8 timed ones. Returns (cluster, the
    phase's fields); raises on a stalled election or an error bit."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c = BlockedFusedCluster(MAIN_GROUPS, VOTERS, block_groups=PAGED_BLOCK_GROUPS, seed=42,
                            shape=paged_shape(PAGED_BLOCK_LANES, pool), round_chunk=8,
                            device=dev, engine="pallas", rounds_per_call=8, **paging)
    qc.reset_launches()
    rc.reset_launches()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rounds = 0
    while c.leader_count() < MAIN_GROUPS:
        c.run(PAGED_SWEEP, auto_propose=True, auto_compact_lag=4)
        synchronize(f"{phase}: warm-up")
        rounds += PAGED_SWEEP
        if rounds > WARM_LIMIT:
            raise RuntimeError(f"{phase}: election stalled at {c.leader_count()} leaders")
    sweeps = zipf_sweeps(c, 8)
    for s in range(4):
        c.run(PAGED_SWEEP, ops=sweeps[s], auto_compact_lag=12)
    synchronize(f"{phase}: shaping sweeps")
    t0 = time.perf_counter()
    for s in range(8):
        c.run(PAGED_SWEEP, ops=sweeps[s], auto_compact_lag=12)
    synchronize(f"{phase}: timed sweeps")
    dt = time.perf_counter() - t0
    rounds += 12 * PAGED_SWEEP
    launches = {name: k.launches for name, k in rc.KERNELS.items()}
    launches.update({name: k.launches for name, k in qc.KERNELS.items()})
    stats = c.paged_stats() or {}
    fields = dict(
        **{k: x for k, x in paging.items() if k != "tile_lanes"}, pool_pages=pool,
        groups=MAIN_GROUPS, voters=VOTERS, blocks=c.k,
        block_groups=PAGED_BLOCK_GROUPS, rounds=rounds, setup_s=setup_s,
        timed_rounds=8 * PAGED_SWEEP, timed_s=dt, round_ms=1e3 * dt / (8 * PAGED_SWEEP),
        groups_ticks_per_s=MAIN_GROUPS * 8 * PAGED_SWEEP / dt, leaders=c.leader_count(),
        total_committed=c.total_committed(),
        segs_per_block=c.blocks[0]._paged_segs, tile_lanes=c.blocks[0]._pallas_tile,
        blocks_per_segment=segment_blocks(c.blocks[0]),
        carry_bytes_per_lane=paged_bytes_per_lane(c), peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, expected_launches=rounds * c.k // 8, digest=host_digest(c), **stats,
    )
    return c, fields


def segment_blocks(b) -> int | None:
    """CUDA blocks per allocation segment of a FusedCluster paging in the
    kernel (None otherwise)."""
    if not b._paged_inkernel or b._pallas_tile is None:
        return None
    d = rc.dims_of(b.state, b.fab, b.v, b.paged)
    return b._pallas_tile // rc.cta_lanes(b._pallas_tile, b.v, d, chaos=b.chaos is not None,
                                          paged=True)


def segment_pages(b) -> torch.Tensor:
    """Pages in use in each allocation segment of a FusedCluster paging in
    the kernel: its page table's mapped entries, tile by tile, on its
    device (int64 [segments])."""
    return (b.paged.pt.to(torch.int32) > 0).view(b._paged_segs, -1).sum(1)


def paged_cell(dev, name: str, **paging):
    """run_main_paged as phase main_pallas_paged_<name> on the first pool of
    PAGED_POOLS that does not exhaust (a pool that does is printed); returns
    (cluster, fields)."""
    for pool in PAGED_POOLS if paging else (0,):
        c, f = run_main_paged(dev, f"main_pallas_paged_{name}", pool, **paging)
        if not f.get("paged_exhausted"):
            return c, f
        emit("main_pallas_paged_exhausted", run=name, pool_pages=pool,
             paged_exhausted=f["paged_exhausted"])
        del c
        torch.cuda.empty_cache()
    raise AssertionError(f"main_pallas_paged {name}: the pool exhausts at 65,536 pages")


def check_main_paged(dev):
    """main_pallas_paged: the paged main path in-kernel (the default tile,
    3,072 lanes: 16 segments of 32 CUDA blocks a block), in-kernel at
    tile_lanes=96 (512 one-block segments a block), in-kernel with
    diet=True, at the dispatch boundary, and with paging off: one
    host_state digest, the pool in use, no error bit; round_kernel_paged
    (round_kernel_paged_diet) launched rounds x blocks / K times in the
    in-kernel runs, round_kernel in the others. A pool that exhausts is
    printed and the run repeated on the next pool of PAGED_POOLS. Returns
    ({run: fields}, the in-kernel slim and diet clusters' timing rows, over
    3,072- and 96-lane segments)."""
    runs = {}
    timing = {}
    plans = (("inkernel", dict(paged=True, paged_inkernel=True), "round_kernel_paged"),
             ("inkernel_t96", dict(paged=True, paged_inkernel=True, tile_lanes=96),
              "round_kernel_paged"),
             ("inkernel_diet", dict(paged=True, paged_inkernel=True, diet=True),
              "round_kernel_paged_diet"),
             ("boundary", dict(paged=True), "round_kernel"),
             ("flat", {}, "round_kernel"))
    for name, paging, kernel in plans:
        c, f = paged_cell(dev, name, **paging)
        c.check_no_errors()
        want = {k: (f["expected_launches"] if k == kernel else 0) for k in rc.KERNELS}
        want["joint_kernel"] = 0
        bad = {k: f["launches"][k] for k, n in want.items() if f["launches"][k] != n}
        if bad or f["leaders"] != MAIN_GROUPS:
            raise AssertionError(f"main_pallas_paged {name}: launches {bad}, want {want}, "
                                 f"{f['leaders']} leaders")
        if paging and not f.get("paged_pool_in_use"):
            raise AssertionError(f"main_pallas_paged {name}: the pool was never used")
        emit(f"main_pallas_paged_{name}", **f)
        runs[name] = f
        if name in ("inkernel", "inkernel_diet"):
            timing[kernel] = time_round_kernel_paged(c, f"{kernel}_timing", tiles=(96,))
        del c
        torch.cuda.empty_cache()
    digests = {name: f["digest"] for name, f in runs.items()}
    emit("main_pallas_paged", digests=digests,
         round_ms={name: f["round_ms"] for name, f in runs.items()},
         carry_bytes_per_lane={name: f["carry_bytes_per_lane"] for name, f in runs.items()},
         peak_mem_gb={name: f["peak_mem_gb"] for name, f in runs.items()})
    if len(set(digests.values())) != 1:
        raise AssertionError(f"main_pallas_paged: host_state digests differ: {digests}")
    return runs, timing


def time_round_kernel_paged(c, phase: str, tiles=()) -> dict:
    """The paged build at the main path's shape (block 0's resident carry
    and PagedLog) against round_kernel_ref, K=1 and K=8, over the cluster's
    allocation segments and, for each of `tiles`, the same carry
    resegmented to segments of that many lanes; timed on raw launches
    (arguments packed once, a new epoch a launch) beside the plain version
    and the bytes bound: every input leaf read once and every output leaf
    written once, the page table, the pool and the segment words
    included. At the cluster's segments, the build's stamp twin
    (-DRAFT_STAMPS=1) on the same inputs (`stamps`: stamp_table, with the
    wave facts)."""
    b = c.blocks[0]
    diet = b._diet
    m = b.metrics
    n = b.shape.n_lanes
    d = rc.dims_of(b.state, b.fab, b.v, b.paged)
    plan = rc.paged_plan(b.paged)
    kern = rc.KERNELS[rc.kernel_name(diet, True)]
    by_tile = {}
    for tile in (b._pallas_tile, *tiles):
        st, pg = b.state, b.paged
        if tile != b._pallas_tile:
            st, pg = tpg.resegment(st, pg, b._paged_segs, n // tile)
        cta = rc.cta_lanes(tile, b.v, d, paged=True)
        segments = rc.Segments(n // cta, st.term.device) if tile > cta else None
        args = (st, b.fab, b._no_ops, b.mute, (m.samp_index, m.samp_round), m.round_ctr)

        def kw(kc):
            return dict(v=b.v, kc=kc, cta=cta, apply_ops=True, ops_round0_only=True,
                        do_tick=True, auto_propose=True, auto_compact_lag=12, paged=pg,
                        seg_lanes=tile)

        rows = {}
        for kc in (1, 8):
            ptrs, dims, flags, lag, outs = rc.pack(*args, segments=segments, **kw(kc))
            arr, nptr, cdims = rc.as_c_args(ptrs, dims)
            go = raw_launch(kern, arr, nptr, cdims, flags, lag,
                            target=rc.target(d, cta, diet, plan), segments=segments)
            go()
            synchronize(f"{kern.name} K={kc} tile={tile}")
            want = plr.round_kernel_ref(*args, **kw(kc))
            bad = first_difference(carry_leaves(*outs[:4]) + paged_leaves(outs[4]),
                                   carry_leaves(*want[:4]) + paged_leaves(want[4]))
            if bad is not None:
                raise AssertionError(f"{kern.name} K={kc} tile={tile} at the main path's "
                                     f"shape: first differing leaf {bad}")
            pg_bytes = sum(x.nbytes for _, x in paged_leaves(pg) + paged_leaves(outs[4]))
            seg_bytes = 0 if segments is None else 8 * (1 + n // cta)
            nbytes = round_bytes(args, outs[:4]) + pg_bytes + seg_bytes
            ms = cuda_ms(go, iters=50 if kc == 1 else 10)
            synchronize(f"{kern.name} K={kc} tile={tile} timing")
            rows[kc] = dict(max_abs_err=0, ms=ms, ms_per_round=ms / kc,
                            bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                            bytes=nbytes, paged_bytes=pg_bytes, segment_bytes=seg_bytes,
                            rounds=kc, skipped_lanes=int((outs[4].skipped - pg.skipped).sum()))
            if kc == 1 and tile == b._pallas_tile:
                rows[kc].update(
                    **rc.occupancy(d, cta, diet, plan),
                    wrapper_ms=cuda_ms(lambda: rc.round_call(*args, segments=segments, **kw(1)),
                                       iters=20),
                    plain_ms=cuda_ms(lambda: plr.round_kernel_ref(*args, **kw(1)), iters=3),
                )
            if tile == b._pallas_tile:
                rows[kc]["stamps"] = stamp_launch(
                    kern, args, kw(kc), rc.target(d, cta, diet, plan, stamps=True), segments,
                    kc, want, f"{kern.name} stamps K={kc}")
            del go, outs, want
        by_tile[tile] = dict(rows[1], cta_lanes=cta, blocks_per_segment=tile // cta,
                             k8=rows[8])
    row = dict(by_tile[b._pallas_tile], tile_lanes=b._pallas_tile, lanes=n,
               by_tile={str(t): {k: v for k, v in r.items() if k not in ("k8", "stamps")}
                        | {"k8_ms_per_round": r["k8"]["ms_per_round"],
                           "k8_bound_ms": r["k8"]["bound_ms"]}
                        for t, r in by_tile.items()})
    emit(phase, **row)
    return row


# -- the chaos plane ------------------------------------------------------------

CHAOS_BUDGET = 64  # ticks (benches/chaos_soak.py CHAOS_BUDGET)


def chaos_plan(n: int, v: int, r0: int, groups: int = 4) -> dict:
    """Faults from round r0 (absolute chaos rounds): drops and duplicates
    of 0.2 on the edges of the first `groups` groups, tick skew 0.3 on every
    lane, an asymmetric partition of the next group's member 0, lane 1 down
    over [r0+1, r0+3) (inside a K=4 launch from r0), an instant restart of
    lane 3v at r0+5, and the recovery probe armed at r0+2."""
    edge = np.where((np.arange(n) < groups * v)[:, None], tch.probability(0.2), 0)
    edge = np.repeat(edge, v, axis=1).astype(np.int32)
    send, recv = np.ones(n, np.int32), np.ones(n, np.int32)
    send[groups * v], recv[groups * v] = 3, 2
    crash, restart = np.full(n, tch.NEVER, np.int32), np.full(n, tch.NEVER, np.int32)
    crash[1], restart[1] = r0 + 1, r0 + 3
    crash[3 * v], restart[3 * v] = r0 + 5, r0 + 5
    never = np.full(n, tch.NEVER, np.int32)
    return dict(drop_num=edge, dup_num=edge,
                tick_skew_num=np.full(n, tch.probability(0.3), np.int32),
                part_send=send, part_recv=recv, crash_at=crash, restart_at=restart,
                heal_round=r0 + 2, reelect_round=never, recommit_round=never.copy())


def paged_launch_leaves(res) -> list:
    """A launch with paging's outputs as (name, array) leaves: the carry and
    partials, the PagedLog and, of a chaos launch, the probe columns."""
    return (carry_leaves(*res[:4]) + paged_leaves(res[4])
            + (probe_leaves(res[5]) if len(res) > 5 else []))


def probe_leaves(probes) -> list:
    """(name, numpy leaf) of a chaos launch's probe columns."""
    return [("chaos." + k, x.cpu().numpy()) for k, x in zip(tch.PROBES, probes)]


def check_round_kernel_chaos(dev):
    """The chaos builds against round_kernel_ref(chaos=) over 9 rounds per
    case, launched as pallas_rounds launches them, slim and diet; raises
    naming the first differing leaf, probe column or partials row."""
    cases = 0
    for diet in (False, True):
        for v in (3, 5):
            for k in (1, 4):
                for seed in (5, 17):
                    metrics = seed == 5
                    g = 16
                    n = g * v
                    c = FusedCluster(g, v, seed=seed, device=dev, diet=diet, chaos=True,
                                     shape=Shape(n_lanes=n, max_peers=v, log_window=16,
                                                 max_msg_entries=2, max_inflight=2,
                                                 max_read_index=2))
                    c.run(12, auto_propose=True, auto_compact_lag=4)  # eager warm-up
                    c.set_chaos(**chaos_plan(n, v, int(c.chaos.round)))
                    c.set_mute([v + 1])
                    ops = c.ops(hup={0: True, 2 * v: True}, prop_n={1: 2, v: 1}, prop_bytes=7,
                                read_ctx={i: 100 + i for i in range(n)})
                    plan = [k] * (9 // k) + ([9 % k] if 9 % k else [])
                    for i, kc in enumerate(plan):
                        m = c.metrics
                        samp = (m.samp_index, m.samp_round) if metrics else None
                        args = (c.state, c.fab, ops, c.mute, samp, m.round_ctr if metrics else None)
                        kw = dict(v=v, kc=kc, cta=2 * v, apply_ops=i == 0, ops_round0_only=True,
                                  do_tick=True, auto_propose=True, auto_compact_lag=4,
                                  chaos=c.chaos)
                        got = rc.round_call(*args, **kw)
                        want = plr.round_kernel_ref(*args, **kw)
                        torch.cuda.synchronize()
                        a = carry_leaves(*got[:4]) + probe_leaves(got[4])
                        b = carry_leaves(*want[:4]) + probe_leaves(want[4])
                        bad = first_difference(a, b)
                        if bad is not None or interop.digest([x for _, x in a]) != interop.digest(
                            [x for _, x in b]
                        ):
                            raise AssertionError(
                                f"{rc.kernel_name(diet, False, True)} v={v} K={k} seed={seed} "
                                f"launch {i}: first differing leaf {bad}")
                        c.state, c.fab = got[0], got[1]
                        if metrics:
                            c.metrics = plr.fold_partials(m, got[2], got[3], kc)
                        c.chaos = plr.fold_chaos(c.chaos, got[4], got[3], kc, metrics)
                        cases += 1
    emit("round_kernel_chaos", launches_compared=cases,
         cases="{slim, diet} x V{3,5} x K{1,4} x seeds{5 (metrics on), 17 (off)}",
         rounds_per_case=9, max_abs_err=0)


def check_parity_chaos():
    """FusedCluster(chaos=True), 64 groups x 33 rounds under three fault
    plans: on the card eager and pallas K=1 and K=3, slim and diet,
    against the eager CPU run; one digest over host_state and the chaos
    leaves."""
    g = 64
    n = g * VOTERS

    def run(dev, diet=False, **engine):
        c = FusedCluster(g, VOTERS, seed=11, shape=bench_shape(n), device=dev, diet=diet,
                         chaos=True, **engine)
        for r0 in (0, 11, 22):
            c.set_chaos(**chaos_plan(n, VOTERS, r0 + 3))
            c.run(11, auto_propose=True, auto_compact_lag=4)
        return c, interop.digest(interop.to_numpy_leaves(c.host_state())
                                 + interop.to_numpy_leaves(c.chaos))

    cpu, want = run("cpu")
    out = {"cpu": want}
    for diet in (False, True):
        for name, engine in (("eager", {}), ("pallas_k1", dict(engine="pallas", rounds_per_call=1)),
                             ("pallas_k3", dict(engine="pallas", rounds_per_call=3))):
            key = name + ("_diet" if diet else "")
            out[key] = run("cuda", diet, **engine)[1]
            if out[key] != want:
                raise AssertionError(f"parity_chaos {key}: card {out[key]} != cpu {want}")
    cols = cpu.chaos_columns()
    emit("parity_chaos", groups=g, rounds=33, digests=out,
         n_reelected=int(cols["n_reelected"]), n_recommitted=int(cols["n_recommitted"]),
         error_lanes=int((cpu.state.error_bits != 0).sum()))


def check_slo_smoke():
    """benches/chaos_soak.py --smoke on the port: 64 groups x 3, seed 1000,
    the default Shape, tick budget 64, the mixed scenario; on the card on
    the pallas engine at K=8 and on the CPU on the eager engine: the
    recovery SLO holds, and both give one probe snapshot and one
    trajectory_digest."""
    g = 64
    out = {}
    for dev, engine in (("cuda", dict(engine="pallas", rounds_per_call=8)), ("cpu", {})):
        c = FusedCluster(g, VOTERS, seed=1000, device=dev, chaos=True, **engine)
        snap = ChaosRunner(c, scenario(g, VOTERS), tick_budget=CHAOS_BUDGET).run()
        out[dev] = (snap, trajectory_digest(c))
    snap = out["cuda"][0]
    emit("chaos_slo_smoke", groups=g, seed=1000, counters=snap["counters"], slo=snap["slo"],
         digest=out["cuda"][1])
    if out["cuda"] != out["cpu"]:
        raise AssertionError("chaos_slo_smoke: the card and the CPU differ")
    if not snap["slo"]["ok"] or snap["counters"]["chaos_groups_probed"] <= 0:
        raise AssertionError(f"chaos_slo_smoke: recovery SLO {snap['slo']}, {snap['counters']}")


def scenario(g: int, v: int, schedule=ChaosSchedule):
    """benches/chaos_soak.py:47-67, unchanged, on the port's ChaosSchedule
    (or another class with its methods): quarters of the batch get
    partitions, leader kills and flapping links, with drop, duplicate and
    skew noise over the kill and flap quarters."""
    q = max(1, g // 4)
    part = list(range(0, q))
    kill = list(range(q, 2 * q))
    flap = list(range(2 * q, 3 * q))
    sched = (
        schedule(g, v)
        .rolling_partitions(at=24, waves=2, duration=10, settle=8)
        .partition(groups=part, at=70, duration=12)
        .kill_leaders(groups=kill, at=72, down=8)
        .flap(groups=flap, at=70, cycles=2, down=4, up=4)
        .drop(groups=kill, at=70, duration=16, prob=0.2)
        .duplicate(groups=kill, at=70, duration=16, prob=0.2)
        .skew(groups=flap, at=70, duration=16, prob=0.3)
    )
    return sched


def chaos_digest(c) -> str:
    """sha256 over every block's host_state and chaos leaves."""
    return interop.digest(*(interop.to_numpy_leaves(b.host_state()) + interop.to_numpy_leaves(b.chaos)
                            for b in c.blocks))


def run_main_chaos(dev, phase: str = "main_pallas_chaos", block_groups: int = MAIN_BLOCK_GROUPS,
                   pool: int | None = None, **engine):
    """The main path with chaos=True through the ChaosRunner at full width,
    in blocks of block_groups groups, paged with `pool` pages a block when
    given (page_window=8, page_entries=4); returns (cluster, row, probe
    snapshot)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lanes = block_groups * VOTERS
    shape = bench_shape(lanes) if pool is None else paged_shape(lanes, pool)
    c = BlockedFusedCluster(
        MAIN_GROUPS, VOTERS, block_groups=block_groups, seed=42,
        shape=shape, round_chunk=8, device=dev, chaos=True, **engine,
    )
    sched = scenario(MAIN_GROUPS, VOTERS)
    # after every segment: election safety, and the lanes whose error bits
    # are set, with their bits (the runner's own check_no_errors would stop
    # at the first: at this cell's 16-entry window the scenario overflows a
    # few followers' windows, in the JAX package too, PERF.md PR 7)
    errors = {}
    # paged: each allocation segment's pages in use, the most seen at the
    # end of any schedule segment (the pool's headroom; kept on the card)
    seg_peak = {}
    run_segment = c.run

    def run_checked(rounds, **kw):
        run_segment(rounds, **kw)
        synchronize(f"{phase}: a segment of {rounds} rounds")
        election_safety_batched(c)
        for i, b in enumerate(c.blocks):
            bits = b.state.error_bits.cpu().numpy()
            for lane in np.nonzero(bits)[0]:
                errors.setdefault(i * c.lanes_per_block + int(lane), int(bits[lane]))
            if pool is not None:
                used = segment_pages(b)
                seg_peak[i] = used if i not in seg_peak else torch.maximum(seg_peak[i], used)

    c.run = run_checked
    runner = ChaosRunner(c, sched, tick_budget=CHAOS_BUDGET, check_invariants=False)
    segs = sched.segments(runner.settle)
    qc.reset_launches()
    rc.reset_launches()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = runner.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del c.run  # the wrapper holds the cluster: a cycle that would outlive the phase
    launches = {name: k.launches for name, k in {**qc.KERNELS, **rc.KERNELS}.items()}
    # the host's schedule work, timed again: every segment's columns
    t1 = time.perf_counter()
    for a, _ in segs:
        sched.columns(a)
    schedule_s = time.perf_counter() - t1
    rounds = segs[-1][1]
    k = engine["rounds_per_call"]
    diet = engine.get("diet", False)
    paged = engine.get("paged_inkernel", False)
    name = rc.kernel_name(diet, paged, True)
    expect = c.k * sum(-(-step // k) for a, b in segs for step, _ in c.sweep(b - a))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    b0 = c.blocks[0]
    layout = {}
    if pool is not None:
        peaks = torch.stack([seg_peak[i] for i in range(c.k)]).cpu()
        rows = pool // b0._paged_segs
        layout = dict(pool_pages=pool, segs_per_block=b0._paged_segs,
                      tile_lanes=b0._pallas_tile, blocks_per_segment=segment_blocks(b0),
                      segment_pool_rows=rows, segment_pages_peak=int(peaks.max()),
                      segment_pages_peak_mean=float(peaks.double().mean()),
                      segment_peak_share=int(peaks.max()) / rows,
                      **(c.paged_stats() or {}))
    row = dict(
        **engine, **layout, groups=MAIN_GROUPS, voters=VOTERS, blocks=c.k,
        block_groups=block_groups,
        setup_s=setup_s, rounds=rounds, segments=len(segs), run_s=dt,
        round_ms=1e3 * dt / rounds, groups_ticks_per_s=MAIN_GROUPS * rounds / dt,
        schedule_s=schedule_s, counters=snap["counters"], slo=snap["slo"],
        hist_reelect=snap["hist_reelect"], hist_recommit=snap["hist_recommit"],
        leaders=c.leader_count(), total_committed=c.total_committed(),
        error_lanes={str(lane): bits for lane, bits in sorted(errors.items())},
        launches={n_: x for n_, x in launches.items() if x}, expected_launches=expect,
        peak_mem_gb=peak_gb, digest=chaos_digest(c),
    )
    emit(phase, **row)
    # the SLO's outcome here is the reference's: without PreVote a healed
    # member with a higher term disrupts its group, and at this seed and
    # width some groups stay leaderless past their window (the JAX package
    # and the port agree on the count at 256 and 1,024 groups, PERF.md
    # PR 7); it is reported, and held equal across the three runs
    if snap["counters"]["chaos_groups_probed"] <= 0:
        raise AssertionError(f"{phase}: no group probed: {snap['counters']}")
    # window capacity, not safety: an append past a follower's 16-entry
    # window is refused (ERR_WINDOW_OVERFLOW), and the commit index it
    # then carries is past its last (ERR_COMMIT_OUT_OF_RANGE)
    capacity = ERR_WINDOW_OVERFLOW | ERR_COMMIT_OUT_OF_RANGE
    if any(bits & ~capacity for bits in errors.values()):
        raise AssertionError(f"{phase}: error bits beyond window capacity: {errors}")
    want = {name: expect, "joint_kernel": 0, rc.kernel_name(diet, paged, False): 0,
            rc.kernel_name(diet, not paged, True): 0}
    for kname, count in want.items():
        if launches[kname] != count:
            raise AssertionError(f"{phase}: {kname} launched {launches[kname]} times, "
                                 f"expected {count}")
    return c, row, snap


def time_round_kernel_chaos(c, phase: str) -> dict:
    """The chaos build at block 0 of the chaos cell (its carry and chaos
    state after the scenario) against round_kernel_ref(chaos=), K=1 and
    K=8, timed on raw launches beside the build without chaos on the same
    carry (the slim, or with diet the diet build), the plain version and
    the bytes bound: every input leaf read once and every output leaf
    written once, the knob, probe and scalar leaves included."""
    b = c.blocks[0]
    diet = b._diet
    m = b.metrics
    args = (b.state, b.fab, b._no_ops, b.mute, (m.samp_index, m.samp_round), m.round_ctr)
    d = rc.dims_of(b.state, b.fab, b.v)
    cta = rc.cta_lanes(b._pallas_tile, b.v, d, chaos=True)
    kern = rc.KERNELS[rc.kernel_name(diet, False, True)]
    base = rc.KERNELS[rc.kernel_name(diet, False, False)]
    ch_bytes = sum(getattr(b.chaos, k).numel() * 4 for k in tch.KNOBS + tch.PROBES * 2) + 12

    def kw(kc, chaos=True):
        return dict(v=b.v, kc=kc, cta=cta, apply_ops=True, ops_round0_only=True, do_tick=True,
                    auto_propose=True, auto_compact_lag=8, chaos=b.chaos if chaos else None)

    rows = {}
    for kc in (1, 8):
        ptrs, dims, flags, lag, outs = rc.pack(*args, **kw(kc))
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        go = raw_launch(kern, arr, nptr, cdims, flags, lag, target=rc.target(d, cta, diet, None, True))
        go()
        want = plr.round_kernel_ref(*args, **kw(kc))
        torch.cuda.synchronize()
        bad = first_difference(carry_leaves(*outs[:4]) + probe_leaves(outs[4]),
                               carry_leaves(*want[:4]) + probe_leaves(want[4]))
        if bad is not None:
            raise AssertionError(f"{kern.name} K={kc} at the main path's shape: "
                                 f"first differing leaf {bad}")
        nbytes = round_bytes(args, outs[:4]) + ch_bytes
        ms = cuda_ms(go, iters=50 if kc == 1 else 10)
        ptrs0, dims0, flags0, lag0, outs0 = rc.pack(*args, **kw(kc, chaos=False))
        arr0, nptr0, cdims0 = rc.as_c_args(ptrs0, dims0)
        go0 = raw_launch(base, arr0, nptr0, cdims0, flags0, lag0, target=rc.target(d, cta, diet))
        base_ms = cuda_ms(go0, iters=50 if kc == 1 else 10)
        rows[kc] = dict(max_abs_err=0, ms=ms, ms_per_round=ms / kc,
                        without_chaos_ms=base_ms, without_chaos_ms_per_round=base_ms / kc,
                        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                        bytes=nbytes, chaos_bytes=ch_bytes, rounds=kc)
        if kc == 1:
            rows[kc].update(
                **rc.occupancy(d, cta, diet, None, True),
                wrapper_ms=cuda_ms(lambda: rc.round_call(*args, **kw(1)), iters=20),
                plain_ms=cuda_ms(lambda: plr.round_kernel_ref(*args, **kw(1)), iters=3),
            )
        del go, outs, want, go0, outs0
    row = dict(rows[1], cta_lanes=cta, lanes=b.shape.n_lanes, k8=rows[8])
    emit(phase, **row)
    return row


def check_main_chaos(dev, k8_round_ms: float):
    """main_pallas_chaos at K=8 slim, K=1 slim and K=8 diet: one digest and
    one probe snapshot; the chaos builds timed at the K=8 runs' block 0."""
    runs, snaps, timing = {}, {}, {}
    for name, engine in (("k8", dict(engine="pallas", rounds_per_call=8)),
                         ("k1", dict(engine="pallas", rounds_per_call=1)),
                         ("k8_diet", dict(engine="pallas", rounds_per_call=8, diet=True))):
        c, runs[name], snaps[name] = run_main_chaos(dev, **engine)
        synchronize(f"main_pallas_chaos {name}")
        if name == "k8":
            timing["round_kernel_chaos"] = time_round_kernel_chaos(c, "round_kernel_chaos_timing")
        if name == "k8_diet":
            timing["round_kernel_chaos_diet"] = time_round_kernel_chaos(
                c, "round_kernel_chaos_diet_timing")
        del c
        torch.cuda.empty_cache()
    digests = {name: r["digest"] for name, r in runs.items()}
    if any(r["error_lanes"] != runs["k8"]["error_lanes"] for r in runs.values()):
        raise AssertionError("main_pallas_chaos: the error lanes differ between the runs")
    emit("main_pallas_chaos_vs_main_pallas",
         round_ms={name: r["round_ms"] for name, r in runs.items()},
         main_pallas_k8_round_ms=k8_round_ms, digests=digests,
         peak_mem_gb={name: r["peak_mem_gb"] for name, r in runs.items()})
    if len(set(digests.values())) != 1:
        raise AssertionError(f"main_pallas_chaos: digests differ: {digests}")
    if any(snaps[name] != snaps["k8"] for name in snaps):
        raise AssertionError("main_pallas_chaos: the probe snapshots differ")
    return runs, timing


# -- the chaos plane with the paged entry log -----------------------------------


def check_round_kernel_chaos_paged(dev):
    """The chaos builds with paging against round_kernel_ref(paged=,
    chaos=) on a 128-group cluster paging in the kernel over segments of
    two 96-lane blocks (two segments): slim and diet, K in {1,4}, seed 5
    (metrics on) with a full pool and seed 17 (metrics off) with one of 4
    pages a segment (lanes exhaust); round_kernel_chaos's faults
    (chaos_plan) with a muted lane and proposals, 9 rounds as pallas_rounds
    launches them at compaction lag 12 (the logs outrun the 8-entry tail),
    then 3 quiet launches (no tick, no proposals) to skip the allocator;
    every carry, partials, PagedLog and probe leaf by sha256, naming the
    first that differs."""
    cases = exhausted = skipped = 0
    g, v, cta, tile = 128, VOTERS, 96, 192
    n = g * v
    for diet in (False, True):
        for k in (1, 4):
            for seed, pool in ((5, 0), (17, 8)):
                metrics = seed == 5
                c = FusedCluster(g, v, seed=seed, device=dev, diet=diet, chaos=True,
                                 shape=paged_shape(n, pool), engine="pallas", tile_lanes=tile,
                                 paged=True, paged_inkernel=True)
                c.run(12, auto_propose=True, auto_compact_lag=12)
                c.set_chaos(**chaos_plan(n, v, int(c.chaos.round)))
                c.set_mute([v + 1])
                ops = c.ops(hup={0: True}, prop_n={i: 2 for i in range(0, n, v)},
                            prop_bytes=7, read_ctx={i: 100 + i for i in range(n)})
                plan = [k] * (9 // k) + ([9 % k] if 9 % k else [])
                launches = [(kc, i == 0, False) for i, kc in enumerate(plan)]
                launches += [(1, False, True)] * 3
                skip0 = int(c.paged.skipped.sum())
                for i, (kc, first, quiet) in enumerate(launches):
                    m = c.metrics
                    samp = (m.samp_index, m.samp_round) if metrics else None
                    args = (c.state, c.fab, ops, c.mute, samp, m.round_ctr if metrics else None)
                    kw = dict(v=v, kc=kc, cta=cta, apply_ops=first, ops_round0_only=True,
                              do_tick=not quiet, auto_propose=not quiet, auto_compact_lag=12,
                              paged=c.paged, chaos=c.chaos, seg_lanes=tile)
                    got = rc.round_call(*args, segments=c._segments, **kw)
                    what = (f"{rc.kernel_name(diet, True, True)} K={k} seed={seed} "
                            f"pool={pool} launch {i}")
                    synchronize(what)
                    want = plr.round_kernel_ref(*args, **kw)
                    a, b = paged_launch_leaves(got), paged_launch_leaves(want)
                    bad = first_difference(a, b)
                    if bad is not None or interop.digest([x for _, x in a]) != interop.digest(
                        [x for _, x in b]
                    ):
                        raise AssertionError(f"{what}: first differing leaf {bad}")
                    c.state, c.fab, c.paged = got[0], got[1], got[4]
                    if metrics:
                        c.metrics = plr.fold_partials(m, got[2], got[3], kc)
                    c.chaos = plr.fold_chaos(c.chaos, got[5], got[3], kc, metrics)
                    cases += 1
                hit = int(((c.state.error_bits & ERR_PAGE_EXHAUSTED) != 0).sum())
                if (hit > 0) != (pool > 0):
                    raise AssertionError(f"round_kernel_chaos_paged diet={diet} K={k} "
                                         f"seed={seed} pool={pool}: {hit} exhausted lanes")
                exhausted += hit
                skipped += int(c.paged.skipped.sum()) - skip0
    if skipped <= 0:
        raise AssertionError("round_kernel_chaos_paged: no launch skipped its allocator")
    emit("round_kernel_chaos_paged", launches_compared=cases,
         cases="{slim, diet} x K{1,4} x {seed 5 (metrics on) full pool, seed 17 (metrics "
               "off) 4 pages a segment}",
         lanes=n, tile_lanes=tile, cta_lanes=cta, blocks_per_segment=tile // cta,
         skipped_lane_launches=skipped, exhausted_lanes=exhausted, max_abs_err=0)


def check_parity_chaos_paged():
    """parity_chaos's run (64 groups, 33 rounds under three fault plans)
    with paged=True, at compaction lag 12 so that the pool is used: on the
    card the eager engine at the boundary and around every round, the
    pallas engine at the boundary (K=3) and in the kernel (the default
    tile, 192 lanes: one segment of two 96-lane blocks) at K=1 and K=3, the
    pallas runs slim and diet; one host_state + chaos digest with the
    unpaged eager CPU run, and the in-kernel K=3 runs' every leaf
    (PagedLog included) equal to the CPU's."""
    g = 64
    n = g * VOTERS

    def run(dev, diet=False, **kw):
        paged = kw.pop("paged", True)
        c = FusedCluster(g, VOTERS, seed=11, shape=paged_shape(n), device=dev, diet=diet,
                         chaos=True, paged=paged, **kw)
        for r0 in (0, 11, 22):
            c.set_chaos(**chaos_plan(n, VOTERS, r0 + 3))
            c.run(11, auto_propose=True, auto_compact_lag=12)
            if dev == "cuda":
                synchronize(f"parity_chaos_paged {kw}")
        host = interop.digest(interop.to_numpy_leaves(c.host_state())
                              + interop.to_numpy_leaves(c.chaos))
        raw = None
        if c.paged is not None:
            raw = interop.digest(*(interop.to_numpy_leaves(x)
                                   for x in (c.state, c.fab, c.metrics, c.chaos, c.paged)))
        return c, host, raw

    flat, want, _ = run("cpu", paged=False)
    out = {"cpu_flat": want}
    layout = {}
    for diet in (False, True):
        for name, kw in (("eager_boundary", {}), ("eager_inkernel", dict(paged_inkernel=True)),
                         ("pallas_boundary_k3", dict(engine="pallas", rounds_per_call=3)),
                         ("pallas_inkernel_k1", dict(engine="pallas", rounds_per_call=1,
                                                     paged_inkernel=True)),
                         ("pallas_inkernel_k3", dict(engine="pallas", rounds_per_call=3,
                                                     paged_inkernel=True))):
            if diet and name.startswith("eager"):
                continue  # the eager engine's packed carry: parity_diet
            key = name + ("_diet" if diet else "")
            c, out[key], raw = run("cuda", diet, **kw)
            if out[key] != want:
                raise AssertionError(f"parity_chaos_paged {key}: card {out[key]} != cpu {want}")
            if c.paged_stats()["paged_pool_in_use"] == 0:
                raise AssertionError(f"parity_chaos_paged {key}: the pool was never used")
            if name == "pallas_inkernel_k3":
                layout = dict(tile_lanes=c._pallas_tile, segs=c._paged_segs,
                              blocks_per_segment=segment_blocks(c))
                cpu_raw = run("cpu", diet, **kw)[2]
                if raw != cpu_raw:
                    raise AssertionError(f"parity_chaos_paged {key}: card leaves {raw} != "
                                         f"cpu {cpu_raw}")
                out[key + "_leaves"] = raw
    cols = flat.chaos_columns()
    emit("parity_chaos_paged", groups=g, rounds=33, compaction_lag=12, digests=out, **layout,
         n_reelected=int(cols["n_reelected"]), n_recommitted=int(cols["n_recommitted"]))


def sm_clock_under_load(go) -> float:
    """The SM clock (MHz) as nvidia-smi reads it while `go` launches back
    to back on the card."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    n = 0
    while proc.poll() is None:
        go()
        n += 1
        if n % 64 == 0:
            torch.cuda.synchronize()
    out, _ = proc.communicate()
    torch.cuda.synchronize()
    return float(out.split()[0])


def stamp_table(rows: np.ndarray, kc: int, cta: int, sm_mhz: float) -> dict:
    """A stamp build's rows (csrc/round.cu ST_*, one a block) as phases:
    for each, [median, max] over the blocks in us at `sm_mhz` (clock64
    cycles / MHz). Thread 0's boundaries partition each block's launch
    (start .. end), so the phases sum to its total; `rounds` is
    split per round (round_us) and the laps (each thread's cycles in a
    part of a round, over the launch) are the block's mean a thread
    (median over blocks) and its slowest thread (max over blocks). From
    %globaltimer: each block's wait at the segment barrier
    (segment_wait_us), the spread of a segment's arrivals
    (segment_arrival_spread_us), a block's time start to end
    (block_globaltimer_us) and the launch's span, first start to last end
    (span_us); sm_mhz_globaltimer is the SM clock those imply. The wave
    facts, from %globaltimer and the SM ids: late_blocks, the blocks that
    started after the first block ended (a launch that fits the card at
    once has none), and max_blocks_an_sm, the most blocks one SM held at
    once."""
    st, laps = rc.stamp_fields()
    col = {name: rows[:, j].astype(np.float64) for j, name in enumerate(st)}
    base = rc.stamp_slots()
    rk = rows[:, base:base + kc].astype(np.float64)
    paged = bool(col["SEGMENT"].any())
    edges = [("ticket", "START", "TICKET"), ("load", "TICKET", "LOAD"),
             ("page_in", "LOAD", "PAGE_IN"), ("load_barrier", "PAGE_IN", "LOADED")]
    cyc = {name: col[b] - col[a] for name, a, b in edges}
    cyc["rounds"] = rk[:, -1] - col["LOADED"]
    cyc["store"] = col["STORE"] - rk[:, -1]
    if paged:
        for name, a, b in (("scan", "STORE", "SCAN"), ("segment_barrier", "SCAN", "SEGMENT"),
                           ("page_out", "SEGMENT", "PAGE_OUT"), ("pool", "PAGE_OUT", "POOL"),
                           ("end", "POOL", "END")):
            cyc[name] = col[b] - col[a]
    else:
        cyc["end"] = col["END"] - col["STORE"]
    cyc["total"] = col["END"] - col["START"]

    def mm(x_us):
        return [float(np.median(x_us)), float(np.max(x_us))]

    phases = {name: mm(x / sm_mhz) for name, x in cyc.items()}
    per_round = np.diff(np.concatenate([col["LOADED"][:, None], rk], axis=1), axis=1)
    lap = {}
    for j, name in enumerate(laps):
        s, m = rows[:, base - 2 * len(laps) + 2 * j], rows[:, base - 2 * len(laps) + 2 * j + 1]
        lap[name.lower()] = [float(np.median(s / cta)) / sm_mhz, float(np.max(m)) / sm_mhz]
    gt = {name: col[name] for name in st if name.startswith("GT_")}
    block_ns = gt["GT_END"] - gt["GT_START"]
    out = dict(
        sm_mhz=sm_mhz, blocks=int(rows.shape[0]), sms=int(len(np.unique(col["SMID"]))),
        phases_us=phases,
        sum_of_median_phases_us=sum(v[0] for k, v in phases.items() if k != "total"),
        round_us=mm(per_round.ravel() / sm_mhz), laps_us=lap,
        block_globaltimer_us=mm(block_ns / 1e3),
        span_us=float(gt["GT_END"].max() - gt["GT_START"].min()) / 1e3,
        sm_mhz_globaltimer=float(np.median(cyc["total"] / np.maximum(block_ns, 1) * 1e3)),
    )
    out.update(wave_facts(gt["GT_START"], gt["GT_END"], col["SMID"]))
    if paged:
        out["segment_wait_us"] = mm((gt["GT_SEG_OUT"] - gt["GT_SEG_IN"]) / 1e3)
    return out


def wave_facts(start, end, smid) -> dict:
    """late_blocks and max_blocks_an_sm (stamp_table) of blocks that ran
    [start, end) on SM smid: each SM's starts and ends swept in time order,
    an end before a start at the same instant."""
    most = 0
    for sm in np.unique(smid):
        on = smid == sm
        held = 0
        for _, step in sorted([(x, 1) for x in start[on]] + [(x, -1) for x in end[on]]):
            held += step
            most = max(most, held)
    return dict(late_blocks=int((start > end.min()).sum()), max_blocks_an_sm=most)


def stamp_launch(kern, args, kw, target, segments, kc, want, what) -> dict:
    """The stamp build `target` of `kern` on the same inputs: its outputs
    against `want` (the plain version's), its time a launch (CUDA events),
    and its stamp table at the SM clock nvidia-smi reads under its load."""
    n = args[0].term.shape[0]
    stamps = torch.zeros((n // kw["cta"], rc.stamp_slots() + kc), dtype=torch.int64,
                         device=args[0].term.device)
    ptrs, dims, flags, lag, outs = rc.pack(*args, segments=segments, stamps=stamps, **kw)
    arr, nptr, cdims = rc.as_c_args(ptrs, dims)
    go = raw_launch(kern, arr, nptr, cdims, flags, lag, target=target, segments=segments)
    go()
    synchronize(what)
    bad = first_difference(paged_launch_leaves(outs), paged_launch_leaves(want))
    if bad is not None:
        raise AssertionError(f"{what}: first differing leaf {bad}")
    ms = cuda_ms(go, iters=50 if kc == 1 else 10)
    synchronize(f"{what} timing")
    mhz = sm_clock_under_load(go)
    stamps.zero_()
    go()
    synchronize(what)
    table = stamp_table(stamps.cpu().numpy(), kc, kw["cta"], mhz)
    return dict(stamp_ms=ms, **table)


def time_round_kernel_chaos_paged(c, phase: str) -> dict:
    """The chaos build with paging at block 0 of the paged chaos cell (its
    resident carry, PagedLog and chaos state after the scenario) against
    round_kernel_ref(paged=, chaos=), K=1 and K=8, over the cluster's
    allocation segments, timed on raw launches (a new epoch a launch)
    beside the paged build without chaos on the same carry, the plain
    version and the bytes bound: every input leaf read once and every
    output leaf written once, the page table, the pool, the knob, probe
    and scalar leaves and the segment words included. After the timed
    launches, the build's stamp twin (-DRAFT_STAMPS=1) on the same inputs:
    its outputs, its time beside the timed build's, and where its launch
    goes (`stamps`: stamp_table)."""
    b = c.blocks[0]
    diet = b._diet
    m = b.metrics
    n = b.shape.n_lanes
    args = (b.state, b.fab, b._no_ops, b.mute, (m.samp_index, m.samp_round), m.round_ctr)
    d = rc.dims_of(b.state, b.fab, b.v, b.paged)
    tile = b._pallas_tile
    cta = rc.cta_lanes(tile, b.v, d, chaos=True, paged=True)
    plan = rc.paged_plan(b.paged)
    kern = rc.KERNELS[rc.kernel_name(diet, True, True)]
    base = rc.KERNELS[rc.kernel_name(diet, True, False)]
    ch_bytes = sum(getattr(b.chaos, k).numel() * 4 for k in tch.KNOBS + tch.PROBES * 2) + 12
    seg_bytes = 0 if b._segments is None else 8 * (1 + n // cta)

    def kw(kc, chaos=True):
        return dict(v=b.v, kc=kc, cta=cta, apply_ops=True, ops_round0_only=True, do_tick=True,
                    auto_propose=True, auto_compact_lag=8, paged=b.paged,
                    chaos=b.chaos if chaos else None, seg_lanes=tile)

    rows = {}
    for kc in (1, 8):
        ptrs, dims, flags, lag, outs = rc.pack(*args, segments=b._segments, **kw(kc))
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        go = raw_launch(kern, arr, nptr, cdims, flags, lag,
                        target=rc.target(d, cta, diet, plan, True), segments=b._segments)
        go()
        synchronize(f"{kern.name} K={kc}")
        want = plr.round_kernel_ref(*args, **kw(kc))
        bad = first_difference(paged_launch_leaves(outs), paged_launch_leaves(want))
        if bad is not None:
            raise AssertionError(f"{kern.name} K={kc} at the main path's shape: "
                                 f"first differing leaf {bad}")
        pg_bytes = sum(x.nbytes for _, x in paged_leaves(b.paged) + paged_leaves(outs[4]))
        nbytes = round_bytes(args, outs[:4]) + pg_bytes + ch_bytes + seg_bytes
        ms = cuda_ms(go, iters=50 if kc == 1 else 10)
        synchronize(f"{kern.name} K={kc} timing")
        ptrs0, dims0, flags0, lag0, outs0 = rc.pack(*args, segments=b._segments,
                                                    **kw(kc, chaos=False))
        arr0, nptr0, cdims0 = rc.as_c_args(ptrs0, dims0)
        go0 = raw_launch(base, arr0, nptr0, cdims0, flags0, lag0,
                         target=rc.target(d, cta, diet, plan), segments=b._segments)
        base_ms = cuda_ms(go0, iters=50 if kc == 1 else 10)
        synchronize(f"{base.name} K={kc} timing")
        rows[kc] = dict(max_abs_err=0, ms=ms, ms_per_round=ms / kc,
                        without_chaos_ms=base_ms, without_chaos_ms_per_round=base_ms / kc,
                        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                        bytes=nbytes, paged_bytes=pg_bytes, chaos_bytes=ch_bytes,
                        segment_bytes=seg_bytes, rounds=kc)
        if kc == 1:
            rows[kc].update(
                **rc.occupancy(d, cta, diet, plan, True),
                wrapper_ms=cuda_ms(lambda: rc.round_call(*args, segments=b._segments, **kw(1)),
                                   iters=20),
                plain_ms=cuda_ms(lambda: plr.round_kernel_ref(*args, **kw(1)), iters=3),
            )
        rows[kc]["stamps"] = stamp_launch(
            kern, args, kw(kc), rc.target(d, cta, diet, plan, True, stamps=True), b._segments,
            kc, want, f"{kern.name} stamps K={kc}")
        del go, outs, want, go0, outs0
    row = dict(rows[1], cta_lanes=cta, tile_lanes=tile, blocks_per_segment=tile // cta,
               lanes=n, k8=rows[8])
    emit(phase, **row)
    return row


def check_main_chaos_paged(dev):
    """main_pallas_chaos_paged: the chaos cell's scenario at 1,048,576
    groups as CHAOS_PAGED_BLOCK_GROUPS-group blocks, unpaged (the twin)
    and paging in the kernel at the default tile (3,072 lanes, 32 blocks a
    segment) with CHAOS_PAGED_POOL pages a block, slim and diet, all at
    K=8: one digest, one probe snapshot, the same error lanes, no page
    exhausted; the chaos builds with paging timed at block 0."""
    runs, snaps, timing = {}, {}, {}
    paging = dict(paged=True, paged_inkernel=True)
    for name, pool, engine in (
        ("flat_k8", None, dict(engine="pallas", rounds_per_call=8)),
        ("k8", CHAOS_PAGED_POOL, dict(engine="pallas", rounds_per_call=8, **paging)),
        ("k8_diet", CHAOS_PAGED_POOL, dict(engine="pallas", rounds_per_call=8, diet=True,
                                           **paging)),
    ):
        c, runs[name], snaps[name] = run_main_chaos(
            dev, f"main_pallas_chaos_paged_{name}", CHAOS_PAGED_BLOCK_GROUPS, pool, **engine)
        synchronize(f"main_pallas_chaos_paged {name}")
        if pool is not None and runs[name].get("paged_exhausted"):
            raise AssertionError(f"main_pallas_chaos_paged {name}: "
                                 f"{runs[name]['paged_exhausted']} lanes exhausted the pool")
        if name == "k8":
            timing["round_kernel_chaos_paged"] = time_round_kernel_chaos_paged(
                c, "round_kernel_chaos_paged_timing")
        if name == "k8_diet":
            timing["round_kernel_chaos_paged_diet"] = time_round_kernel_chaos_paged(
                c, "round_kernel_chaos_paged_diet_timing")
        del c
        torch.cuda.empty_cache()
    digests = {name: r["digest"] for name, r in runs.items()}
    emit("main_pallas_chaos_paged", digests=digests,
         round_ms={name: r["round_ms"] for name, r in runs.items()},
         pool_in_use={name: r.get("paged_pool_in_use") for name, r in runs.items()},
         peak_mem_gb={name: r["peak_mem_gb"] for name, r in runs.items()})
    if any(r["error_lanes"] != runs["flat_k8"]["error_lanes"] for r in runs.values()):
        raise AssertionError("main_pallas_chaos_paged: the error lanes differ between the runs")
    if len(set(digests.values())) != 1:
        raise AssertionError(f"main_pallas_chaos_paged: digests differ: {digests}")
    if any(snaps[name] != snaps["flat_k8"] for name in snaps):
        raise AssertionError("main_pallas_chaos_paged: the probe snapshots differ")
    return runs, timing


# -- the leader-lease plane ---------------------------------------------------------

LEASE_MARGIN = 1  # the main cell's lease_margin (RAFT_TPU_LEASE_MARGIN's default)
# benches/lease_ab.py:60-63, :133-150: 12 rounds, 48 calm, 3 bursts of tick
# skew 0.7 on every slot (6 rounds, then 12 calm), 48 settle
LEASE_SCHEDULE = ([(12, 0.0), (48, 0.0)] + [(6, 0.7), (12, 0.0)] * 3 + [(48, 0.0)])


def lease_name(diet: bool, plan, chaos: bool) -> str:
    return rc.kernel_name(diet, plan is not None, chaos, True)


def i32(x):
    return x.to(torch.int32)


def lease_edges(c, lanes) -> None:
    """On `lanes` (leaders): the lease dropped with its epoch at 32,767, so
    that the next grant wraps it, and the renewal counter at 2^31 - 2, so
    that it wraps at the second renewal."""
    st = c.state
    m = torch.zeros(st.term.shape[0], dtype=torch.bool, device=st.term.device)
    m[torch.as_tensor(lanes, device=m.device)] = True

    def put(col, value):
        return torch.where(m, value, i32(col)).to(col.dtype)

    c.state = dataclasses.replace(st, lease_left=put(st.lease_left, 0),
                                  lease_epoch=put(st.lease_epoch, EPOCH_WRAP - 1),
                                  lease_renewals=put(st.lease_renewals, 2**31 - 2))


def lease_held_violations(c, margin: int):
    """(lanes holding a lease, lanes holding one against the plane's safety
    shape: not a leader, a transfer pending, a confchange in flight or
    skew past the margin), over every block of c, read on the card."""
    held = bad = 0
    for b in getattr(c, "blocks", [c]):
        st = b.state
        vo = st.voters_out
        cc = (i32(st.pending_conf_index) > i32(st.applied)) | (
            vo.any(dim=1) if vo.dim() == 2 else i32(vo) != 0)
        ok = ((i32(st.state) == int(StateType.LEADER)) & (i32(st.lead_transferee) == 0) & ~cc
              & (i32(st.lease_skew) <= margin))
        h = i32(st.lease_left) > 0
        held = held + h.sum()
        bad = bad + (h & ~ok).sum()
    return int(held), int(bad)


def check_round_kernel_lease(dev):
    """Every lease build against round_kernel_ref on a 128-group cluster
    with check_quorum and live leases, at K in {1,4} x seeds 5 (margin 0,
    metrics on) and 17 (margin 2, metrics off), 9 rounds as pallas_rounds
    launches them; before them, leaders of groups 0-3 drop their lease
    with the epoch at 32,767 and renewal counters at 2^31 - 2; ops: a
    transfer away from the leaders of groups 8-11 and a conf change at
    those of groups 12-15 (both revoke), a muted follower in groups 16-17
    and every second launch without proposals (no self-ack: the leader's
    own slot completes its ack quorum); chaos builds: tick skew 0.5 on
    every lane, a crash window of group 4's leader inside a K=4 launch and
    an instant restart of group 5's; paged builds: segments of two 96-lane
    blocks, seed 17 with a pool of 8 pages a segment (lanes exhaust).
    sha256 over every carry leaf (the lease columns included), partials
    row, PagedLog leaf and probe column, naming the first that differs."""
    cases = wraps = exhausted = 0
    events = dict.fromkeys(LEASE_COUNTER_FIELDS, 0)
    g, v, cta, tile = 128, VOTERS, 96, 192
    n = g * v
    for diet, plan, chaos in LEASE_BUILDS:
        paged = plan is not None
        name = lease_name(diet, plan, chaos)
        for k in (1, 4):
            for seed, margin in ((5, 0), (17, 2)):
                metrics = seed == 5
                pool = 8 if paged and seed == 17 else 0
                c = FusedCluster(g, v, seed=seed, device=dev, diet=diet, chaos=chaos,
                                 lease=True, lease_margin=margin, check_quorum=True,
                                 election_tick=6,
                                 shape=paged_shape(n, pool) if paged else bench_shape(n),
                                 engine="pallas", tile_lanes=tile, paged=paged,
                                 paged_inkernel=paged)
                c.run(24, auto_propose=True, auto_compact_lag=12)
                synchronize(f"{name} warm-up")
                lead = c.leader_lanes()
                if len(lead) < 16 or int((i32(c.state.lease_left) > 0).sum()) == 0:
                    raise AssertionError(f"{name} seed={seed}: {len(lead)} leaders, no lease")
                of = {int(x) // v: int(x) for x in lead}
                lease_edges(c, [of[gi] for gi in range(4) if gi in of])
                # a muted follower in groups 16-17: in the launches without
                # proposals their leaders' ack quorums need the own slot
                c.set_mute([next(gi * v + j for j in range(v) if gi * v + j != of.get(gi))
                            for gi in (16, 17)])
                ops = c.ops(transfer_to={of[gi]: (of[gi] + 1) % v + 1
                                         for gi in range(8, 12) if gi in of},
                            prop_cc={of[gi]: 1 for gi in range(12, 16) if gi in of},
                            prop_n={i: 1 for i in range(0, n, v)}, prop_bytes=7)
                if chaos:
                    r0 = int(c.chaos.round)
                    crash = np.full(n, tch.NEVER, np.int32)
                    restart = np.full(n, tch.NEVER, np.int32)
                    for gi, (a, b) in ((4, (r0 + 1, r0 + 3)), (5, (r0 + 2, r0 + 2))):
                        if gi in of:
                            crash[of[gi]], restart[of[gi]] = a, b
                    c.set_chaos(tick_skew_num=tch.probability(0.5), crash_at=crash,
                                restart_at=restart)
                steps = [k] * (9 // k) + ([9 % k] if 9 % k else [])
                for i, kc in enumerate(steps):
                    m = c.metrics
                    samp = (m.samp_index, m.samp_round) if metrics else None
                    args = (c.state, c.fab, ops, c.mute, samp, m.round_ctr if metrics else None)
                    kw = dict(v=v, kc=kc, cta=cta, apply_ops=i == 0, ops_round0_only=True,
                              do_tick=True, auto_propose=i % 2 == 0, auto_compact_lag=12,
                              paged=c.paged, chaos=c.chaos, seg_lanes=tile, lease_margin=margin)
                    got = rc.round_call(*args, segments=c._segments, **kw)
                    what = f"{name} K={k} seed={seed} margin={margin} launch {i}"
                    synchronize(what)
                    want = plr.round_kernel_ref(*args, **kw)
                    a, b = carry_leaves(*got[:4]), carry_leaves(*want[:4])
                    if paged:
                        a, b = a + paged_leaves(got[4]), b + paged_leaves(want[4])
                    if chaos:
                        a, b = a + probe_leaves(got[-1]), b + probe_leaves(want[-1])
                    bad = first_difference(a, b)
                    if bad is not None or interop.digest([x for _, x in a]) != interop.digest(
                        [x for _, x in b]
                    ):
                        raise AssertionError(f"{what}: first differing leaf {bad}")
                    st0 = c.state
                    c.state, c.fab = got[0], got[1]
                    for f in LEASE_COUNTER_FIELDS:
                        events[f] += int((getattr(c.state, f) != getattr(st0, f)).sum())
                    wraps += int(((i32(st0.lease_epoch) == EPOCH_WRAP - 1)
                                  & (i32(c.state.lease_epoch) == 0)).sum())
                    if paged:
                        c.paged = got[4]
                    if metrics:
                        c.metrics = plr.fold_partials(m, got[2], got[3], kc)
                    if chaos:
                        c.chaos = plr.fold_chaos(c.chaos, got[-1], got[3], kc, metrics)
                    cases += 1
                hit = int(((c.state.error_bits & ERR_PAGE_EXHAUSTED) != 0).sum())
                if (hit > 0) != (pool > 0):
                    raise AssertionError(f"{name} K={k} seed={seed}: {hit} exhausted lanes")
                exhausted += hit
    if not all(events.values()) or wraps == 0:
        raise AssertionError(f"round_kernel_lease: events {events}, epoch wraps {wraps}")
    emit("round_kernel_lease", launches_compared=cases, builds=len(LEASE_BUILDS),
         cases="8 lease builds x K{1,4} x {seed 5 margin 0 (metrics on), seed 17 margin 2 "
               "(metrics off; paged: 8 pages a segment)}",
         lanes=n, cta_lanes=cta, paged_tile_lanes=tile, lane_events=events,
         epoch_wraps=wraps, exhausted_lanes=exhausted, max_abs_err=0)


def check_parity_lease():
    """FusedCluster(check_quorum=True, lease=True, chaos=True), 64 groups x
    33 rounds through a lease skew storm (two waves of tick skew 0.7 on
    every slot, 6 rounds each), compaction lag 12: on the card eager and
    pallas K=1 and K=3, slim and diet, and pallas paging in the kernel
    (K=3, one segment of two 96-lane blocks) against the eager CPU run:
    one digest over host_state (the lease columns included) and the chaos
    leaves, and one lease_stats."""
    g = 64
    n = g * VOTERS
    cuts = (0, 9, 15, 21, 27, 33)

    def run(dev, diet=False, paged=False, **engine):
        c = FusedCluster(g, VOTERS, seed=11, shape=paged_shape(n) if paged else bench_shape(n),
                         device=dev, diet=diet, chaos=True, lease=True, check_quorum=True,
                         election_tick=6, paged=paged, paged_inkernel=paged, **engine)
        sched = ChaosSchedule(g, VOTERS).lease_skew_storm(groups=range(g), at=9, bursts=2,
                                                          duration=6, gap=6, prob=0.7)
        for a, b in zip(cuts, cuts[1:]):
            c.set_chaos(**sched.columns(a))
            c.run(b - a, auto_propose=True, auto_compact_lag=12)
            if dev == "cuda":
                synchronize(f"parity_lease {engine}")
        return c, interop.digest(interop.to_numpy_leaves(c.host_state())
                                 + interop.to_numpy_leaves(c.chaos)), c.lease_stats()

    _, want, stats = run("cpu")
    if not (stats["lease_grants"] and stats["lease_renewals"] and stats["lease_skew_revocations"]):
        raise AssertionError(f"parity_lease: the CPU run's lease counters {stats}")
    out = {"cpu": want}
    runs = [(name + ("_diet" if diet else ""), dict(diet=diet, **engine))
            for diet in (False, True)
            for name, engine in (("eager", {}),
                                 ("pallas_k1", dict(engine="pallas", rounds_per_call=1)),
                                 ("pallas_k3", dict(engine="pallas", rounds_per_call=3)))]
    runs.append(("pallas_inkernel_paged_k3", dict(engine="pallas", rounds_per_call=3,
                                                  paged=True)))
    for key, kw in runs:
        _, out[key], got = run("cuda", **kw)
        if out[key] != want or got != stats:
            raise AssertionError(f"parity_lease {key}: card {out[key]} {got} != cpu {want} {stats}")
    emit("parity_lease", groups=g, rounds=33, digests=out, lease_stats=stats)


def lease_digests(c) -> tuple[str, str]:
    """(chaos_digest, the same without the seven lease columns): the raft
    trajectory, which the lease plane never feeds back into, in the
    second. The lease columns are the state's last leaves."""
    full, raft = [], []
    for b in c.blocks:
        st = b.host_state()
        leaves = interop.to_numpy_leaves(st)
        cut = len(leaves) - (len(LEASE_STATE_FIELDS) if st.lease_left is not None else 0)
        chaos = interop.to_numpy_leaves(b.chaos)
        full += leaves + chaos
        raft += leaves[:cut] + chaos
    return interop.digest(full), interop.digest(raft)


def run_main_lease(dev, run: str, lease: bool = True, **engine):
    """The main cell with check_quorum=True, chaos=True and the lease plane
    (lease_margin 1), or without it (the twin): the election warm-up, then
    LEASE_SCHEDULE; after every schedule segment the held leases are
    checked against the plane's safety shape on the card. Returns
    (cluster, row)."""
    phase = "main_pallas_lease"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c = BlockedFusedCluster(
        MAIN_GROUPS, VOTERS, block_groups=MAIN_BLOCK_GROUPS, seed=42,
        shape=bench_shape(BLOCK_LANES), round_chunk=8, device=dev, chaos=True,
        check_quorum=True, lease=lease, lease_margin=LEASE_MARGIN, **engine,
    )
    k = engine["rounds_per_call"]
    expect = 0

    def advance(rounds):
        nonlocal expect
        c.run(rounds, auto_propose=True, auto_compact_lag=8)
        expect += c.k * sum(-(-step // k) for step, _ in c.sweep(rounds))

    qc.reset_launches()
    rc.reset_launches()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = 0
    while True:  # bench.py's warm-up: 32 rounds, then until every group has a leader
        advance(32)
        warm += 32
        if c.leader_count() == MAIN_GROUPS:
            break
        if warm > WARM_LIMIT:
            raise RuntimeError(f"{phase} {run}: {c.leader_count()}/{MAIN_GROUPS} after {warm}")
    warm_s = time.perf_counter() - t0
    run_s = 0.0
    held, violations = [], 0
    for rounds, prob in LEASE_SCHEDULE:
        c.set_chaos(tick_skew_num=tch.probability(prob) if prob else 0)
        t1 = time.perf_counter()
        advance(rounds)
        synchronize(f"{phase} {run}: a segment of {rounds} rounds")
        run_s += time.perf_counter() - t1
        if lease:
            h, bad = lease_held_violations(c, LEASE_MARGIN)
            held.append(h)
            violations += bad
    launches = {name: x.launches for name, x in {**qc.KERNELS, **rc.KERNELS}.items()}
    rounds = sum(r for r, _ in LEASE_SCHEDULE)
    diet = engine.get("diet", False)
    name = rc.kernel_name(diet, False, True, lease)
    errors = {}
    for i, b in enumerate(c.blocks):
        bits = b.state.error_bits.cpu().numpy()
        for lane in np.nonzero(bits)[0]:
            errors[i * c.lanes_per_block + int(lane)] = int(bits[lane])
    row = dict(
        run=run, lease=lease, lease_margin=LEASE_MARGIN, **engine, groups=MAIN_GROUPS,
        voters=VOTERS, blocks=c.k, setup_s=setup_s, warm_rounds=warm, warm_s=warm_s,
        rounds=rounds, run_s=run_s, round_ms=1e3 * run_s / rounds,
        groups_ticks_per_s=MAIN_GROUPS * rounds / run_s, leaders=c.leader_count(),
        total_committed=c.total_committed(), lease_stats=c.lease_stats(),
        held_after_segments=held, lease_violations=violations,
        error_lanes={str(lane): bits for lane, bits in sorted(errors.items())},
        launches={n_: x for n_, x in launches.items() if x}, expected_launches=expect,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    row["digest"], row["raft_digest"] = lease_digests(c)
    emit(phase, **row)
    capacity = ERR_WINDOW_OVERFLOW | ERR_COMMIT_OUT_OF_RANGE
    if any(bits & ~capacity for bits in errors.values()):
        raise AssertionError(f"{phase} {run}: error bits beyond window capacity: {errors}")
    if violations:
        raise AssertionError(f"{phase} {run}: {violations} leases held against the safety shape")
    if lease:
        st = row["lease_stats"]
        if not all(st[f] > 0 for f in ("lease_grants", "lease_renewals",
                                       "lease_skew_revocations")):
            raise AssertionError(f"{phase} {run}: lease counters {st}")
    want = {name: expect, "joint_kernel": 0, rc.kernel_name(diet, False, True, not lease): 0,
            rc.kernel_name(diet, False, False, lease): 0}
    for kname, count in want.items():
        if launches[kname] != count:
            raise AssertionError(f"{phase} {run}: {kname} launched {launches[kname]} times, "
                                 f"expected {count}")
    return c, row


def time_round_kernel_lease(b, phase: str, chaos: bool) -> dict:
    """A lease build at a block's carry (b: a FusedCluster with the lease
    columns, paged in the kernel or not) against round_kernel_ref, K=1 and
    K=8, timed on raw launches beside the build without lease on the same
    carry (the lease columns left out), the plain version and the bytes
    bound: every input leaf read once and every output leaf written once,
    the lease columns, and where the build takes them the chaos, page and
    segment leaves, included."""
    diet, paged = b._diet, b.paged is not None
    m = b.metrics
    n = b.shape.n_lanes
    args = (b.state, b.fab, b._no_ops, b.mute, (m.samp_index, m.samp_round), m.round_ctr)
    no_lease = (dataclasses.replace(b.state, **dict.fromkeys(LEASE_STATE_FIELDS)),) + args[1:]
    d = rc.dims_of(b.state, b.fab, b.v, b.paged)
    tile = b._pallas_tile
    cta = rc.cta_lanes(tile, b.v, d, chaos=chaos, paged=paged)
    plan = rc.paged_plan(b.paged) if paged else None
    kern = rc.KERNELS[rc.kernel_name(diet, paged, chaos, True)]
    base = rc.KERNELS[rc.kernel_name(diet, paged, chaos, False)]
    ch_bytes = (sum(getattr(b.chaos, k).numel() * 4 for k in tch.KNOBS + tch.PROBES * 2) + 12
                if chaos else 0)
    seg_bytes = 0 if b._segments is None else 8 * (1 + n // cta)

    def kw(kc):
        return dict(v=b.v, kc=kc, cta=cta, apply_ops=True, ops_round0_only=True, do_tick=True,
                    auto_propose=True, auto_compact_lag=8, paged=b.paged,
                    chaos=b.chaos if chaos else None, seg_lanes=tile, lease_margin=LEASE_MARGIN)

    def leaves(res):
        out = carry_leaves(*res[:4])
        if paged:
            out += paged_leaves(res[4])
        if chaos:
            out += probe_leaves(res[-1])
        return out

    def raw(kernel, a, kc, lease):
        ptrs, dims, flags, lag, outs = rc.pack(*a, segments=b._segments, **kw(kc))
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        return raw_launch(kernel, arr, nptr, cdims, flags, lag, segments=b._segments,
                          target=rc.target(d, cta, diet, plan, chaos, lease)), outs

    rows = {}
    for kc in (1, 8):
        go, outs = raw(kern, args, kc, True)
        go()
        synchronize(f"{kern.name} K={kc}")
        want = plr.round_kernel_ref(*args, **kw(kc))
        bad = first_difference(leaves(outs), leaves(want))
        if bad is not None:
            raise AssertionError(f"{kern.name} K={kc} at {n} lanes: first differing leaf {bad}")
        pg_bytes = (sum(x.nbytes for _, x in paged_leaves(b.paged) + paged_leaves(outs[4]))
                    if paged else 0)
        nbytes = round_bytes(args, outs[:4]) + pg_bytes + ch_bytes + seg_bytes
        ms = cuda_ms(go, iters=50 if kc == 1 else 10)
        synchronize(f"{kern.name} K={kc} timing")
        go0, outs0 = raw(base, no_lease, kc, False)
        base_ms = cuda_ms(go0, iters=50 if kc == 1 else 10)
        synchronize(f"{base.name} K={kc} timing")
        rows[kc] = dict(max_abs_err=0, ms=ms, ms_per_round=ms / kc,
                        without_lease_ms=base_ms, without_lease_ms_per_round=base_ms / kc,
                        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                        bytes=nbytes, rounds=kc)
        if kc == 1:
            rows[kc].update(
                **rc.occupancy(d, cta, diet, plan, chaos, lease=True),
                wrapper_ms=cuda_ms(lambda: rc.round_call(*args, segments=b._segments, **kw(1)),
                                   iters=20),
                plain_ms=cuda_ms(lambda: plr.round_kernel_ref(*args, **kw(1)), iters=3),
            )
        del go, outs, want, go0, outs0
    row = dict(rows[1], cta_lanes=cta, tile_lanes=tile, lanes=n, k8=rows[8])
    emit(phase, **row)
    return row


def lease_paged_cell(dev, diet: bool):
    """One block of the chaos-paged cell's layout (8,192 groups, 65,536
    pool pages, paging in the kernel over 3,072-lane segments) with
    check_quorum=True, lease=True, chaos=True at K=8, warmed up until every
    group has a leader: the carry the paged lease builds are timed on."""
    g = CHAOS_PAGED_BLOCK_GROUPS
    c = FusedCluster(g, VOTERS, seed=42, shape=paged_shape(g * VOTERS, CHAOS_PAGED_POOL),
                     device=dev, diet=diet, chaos=True, lease=True, lease_margin=LEASE_MARGIN,
                     check_quorum=True, engine="pallas", rounds_per_call=8, paged=True,
                     paged_inkernel=True)
    for _ in range(WARM_LIMIT // 32):
        c.run(32, auto_propose=True, auto_compact_lag=8)
        synchronize("lease_paged_cell warm-up")
        if len(c.leader_lanes()) == g:
            return c
    raise RuntimeError(f"lease_paged_cell: {len(c.leader_lanes())}/{g} leaders")


def check_main_lease(dev):
    """main_pallas_lease at K=8 slim, K=8 diet and K=1 slim, and its
    lease-off twin at K=8: one digest with the lease columns across the
    three lease runs, their raft digest equal to the twin's; the lease
    builds timed at block 0 of the K=8 runs (with and without chaos) and
    the paged lease builds at a paged cell's block."""
    runs, timing = {}, {}
    for run, lease, engine in (
        ("k8", True, dict(engine="pallas", rounds_per_call=8)),
        ("k8_diet", True, dict(engine="pallas", rounds_per_call=8, diet=True)),
        ("k1", True, dict(engine="pallas", rounds_per_call=1)),
        ("twin_k8", False, dict(engine="pallas", rounds_per_call=8)),
    ):
        c, runs[run] = run_main_lease(dev, run, lease, **engine)
        if run in ("k8", "k8_diet"):
            b = c.blocks[0]
            for chaos in (True, False):
                name = lease_name(b._diet, None, chaos)
                timing[name] = time_round_kernel_lease(b, name + "_timing", chaos)
        del c
        torch.cuda.empty_cache()
    for diet in (False, True):
        c = lease_paged_cell(dev, diet)
        for chaos in (True, False):
            name = lease_name(diet, PAGED_PLAN, chaos)
            timing[name] = time_round_kernel_lease(c, name + "_timing", chaos)
        del c
        torch.cuda.empty_cache()
    lease_runs = ("k8", "k8_diet", "k1")
    digests = {r: runs[r]["digest"] for r in runs}
    raft = {r: runs[r]["raft_digest"] for r in runs}
    emit("main_pallas_lease_vs_twin",
         round_ms={r: x["round_ms"] for r, x in runs.items()},
         groups_ticks_per_s={r: x["groups_ticks_per_s"] for r, x in runs.items()},
         peak_mem_gb={r: x["peak_mem_gb"] for r, x in runs.items()},
         digests=digests, raft_digests=raft)
    if len({digests[r] for r in lease_runs}) != 1:
        raise AssertionError(f"main_pallas_lease: digests differ: {digests}")
    if len(set(raft.values())) != 1 or raft["twin_k8"] != digests["twin_k8"]:
        raise AssertionError(f"main_pallas_lease: the raft trajectory differs from the "
                             f"lease-off twin's: {raft}")
    if any(runs[r]["error_lanes"] != runs["twin_k8"]["error_lanes"] for r in runs):
        raise AssertionError("main_pallas_lease: the error lanes differ between the runs")
    return runs, timing


def _device_us(e) -> float:
    return e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total


def profile_round(c, round_ms: float, phase: str = "profile"):
    """One round of every block under the profiler: CUDA kernels per
    block-round, device time per round, and its share of the unprofiled
    round time of the main phase (the profiler's own wall time is inflated
    by tracing every launch, so it is reported but not used)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c.run(1, auto_propose=True, auto_compact_lag=8)
        torch.cuda.synchronize()
    profiled_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + _device_us(e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    mega_us = sum(t for name, t in by_name.items() if "round_kernel" in name)
    emit(
        phase, profiled_wall_ms=profiled_ms, round_ms=round_ms,
        device_busy_ms=busy_ms, device_busy_share=busy_ms / round_ms,
        cuda_kernels_per_block_round=len(kernels) / c.k,
        round_kernel_share=mega_us / 1e3 / busy_ms if busy_ms else 0.0,
        top_kernels_us=[[name[:100], t] for name, t in top],
    )
    if not kernels:
        raise AssertionError(f"{phase}: the profiler saw no CUDA kernel")
    return busy_ms / round_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    build_all()

    timing = check_kernels(dev)
    check_parity()
    c, launches, round_ms, _ = run_main(dev)
    profile_round(c, round_ms)
    del c
    torch.cuda.empty_cache()

    check_round_kernel(dev)
    check_parity_pallas()
    slim = {}
    for k in (8, 1):
        c, launches_k, round_ms_k, slim[k] = run_main(
            dev, "main_pallas", engine="pallas", rounds_per_call=k)
        if k == 1:
            timing["round_kernel"] = time_round_kernel(c)
            slim[k]["device_busy_share"] = profile_round(c, round_ms_k, "profile_pallas")
            launches["round_kernel"] = launches_k["round_kernel"]
        del c
        torch.cuda.empty_cache()

    # the diet-v2 packed carry: its kernel, the card against the CPU, and
    # the main path with diet=True against the slim runs above
    check_round_kernel_diet(dev)
    check_parity_diet()
    for k in (8, 1):
        c, launches_k, round_ms_k, diet = run_main(
            dev, "main_pallas_diet", engine="pallas", rounds_per_call=k, diet=True)
        if k == 1:
            timing["round_kernel_diet"] = time_round_kernel(c, "round_kernel_diet_timing")
            diet["device_busy_share"] = profile_round(c, round_ms_k, "profile_pallas_diet")
            launches["round_kernel_diet"] = launches_k["round_kernel_diet"]
        emit("main_pallas_diet_vs_slim", rounds_per_call=k, diet=diet, slim=slim[k])
        if diet["digest"] != slim[k]["digest"]:
            raise AssertionError(f"main_pallas_diet K={k}: host_state digest differs from slim")
        del c
        torch.cuda.empty_cache()
    check_eager_diet(dev)

    # the paged entry log: its kernels, the card against the CPU, and the
    # paged main path against itself at the dispatch boundary and unpaged
    check_round_kernel_paged(dev)
    check_round_kernel_segments(dev)
    check_parity_paged()
    paged_runs, paged_timing = check_main_paged(dev)
    timing.update(paged_timing)
    launches["round_kernel_paged"] = paged_runs["inkernel"]["launches"]["round_kernel_paged"]
    launches["round_kernel_paged_diet"] = (
        paged_runs["inkernel_diet"]["launches"]["round_kernel_paged_diet"])

    # the chaos plane: its kernels, the card against the CPU, and the main
    # path through benches/chaos_soak.py's scenario at K=8, K=1 and diet
    check_round_kernel_chaos(dev)
    check_parity_chaos()
    check_slo_smoke()
    chaos_runs, chaos_timing = check_main_chaos(dev, slim[8]["round_ms"])
    timing.update(chaos_timing)
    launches["round_kernel_chaos"] = chaos_runs["k8"]["launches"]["round_kernel_chaos"]
    launches["round_kernel_chaos_diet"] = (
        chaos_runs["k8_diet"]["launches"]["round_kernel_chaos_diet"])

    # the chaos plane with in-kernel paging: its kernels over multi-block
    # segments, the card against the CPU, and the chaos cell paged
    check_round_kernel_chaos_paged(dev)
    check_parity_chaos_paged()
    cp_runs, cp_timing = check_main_chaos_paged(dev)
    timing.update(cp_timing)
    launches["round_kernel_chaos_paged"] = cp_runs["k8"]["launches"]["round_kernel_chaos_paged"]
    launches["round_kernel_chaos_paged_diet"] = (
        cp_runs["k8_diet"]["launches"]["round_kernel_chaos_paged_diet"])

    # the leader-lease plane: its eight builds, the card against the CPU,
    # and the main cell with check_quorum, chaos and a lease skew storm
    # beside its lease-off twin
    check_round_kernel_lease(dev)
    check_parity_lease()
    lease_runs, lease_timing = check_main_lease(dev)
    timing.update(lease_timing)
    for diet, plan, chaos in LEASE_BUILDS:  # the main cell runs the chaos builds unpaged
        name = lease_name(diet, plan, chaos)
        run = "k8_diet" if diet else "k8"
        launches[name] = lease_runs[run]["launches"].get(name, 0)

    replaces = {
        "committed_kernel": "raft_tpu/ops/quorum_pallas.py:99",
        "joint_kernel": "raft_tpu/ops/quorum_pallas.py:106",
        "joint_kernel_vm": "raft_tpu/ops/quorum_pallas.py:120",
        "round_kernel": "raft_tpu/ops/pallas_round.py:564",
        "round_kernel_diet": "raft_tpu/ops/pallas_round.py:599",
        "round_kernel_paged": "raft_tpu/ops/pallas_round.py:589",
        "round_kernel_paged_diet": "raft_tpu/ops/pallas_round.py:589",
        "round_kernel_chaos": "raft_tpu/ops/pallas_round.py:616",
        "round_kernel_chaos_diet": "raft_tpu/ops/pallas_round.py:616",
        "round_kernel_chaos_paged": "raft_tpu/ops/pallas_round.py:589",
        "round_kernel_chaos_paged_diet": "raft_tpu/ops/pallas_round.py:589",
        # the lease branch: the lease leaves of the carry and fused_round's
        # lease tail, run from the kernel body
        **{lease_name(diet, plan, chaos): "raft_tpu/ops/pallas_round.py:676"
           for diet, plan, chaos in LEASE_BUILDS},
    }
    kernels = []
    for name in replaces:
        row = {
            "name": name,
            "route": "cuda",
            "source": "raft_tpu_torch/csrc/"
            + ("round.cu" if name.startswith("round_kernel") else "quorum.cu"),
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": timing[name]["max_abs_err"],
            "ms": timing[name]["ms"],
            "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"],
            "bound_by": timing[name]["bound_by"],
            # no single PyTorch call computes a (joint) quorum commit index
            # or a raft round
            "library_ms": None,
        }
        if name.startswith("round_kernel"):
            row["ms_per_round_k8"] = timing[name]["k8"]["ms_per_round"]
        kernels.append(row)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except TimeoutError as e:
        # a launch that never finished: leave without waiting on the card
        print(f"chip_smoke: {e}", file=sys.stderr, flush=True)
        os._exit(1)
