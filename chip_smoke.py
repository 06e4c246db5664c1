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
           CUDA block) the script uses (ROUND_BUILDS: W16/E2/F2/R2 at V=3
           with the engine's 96-lane block and 6, 48 and 192 lanes, and at
           V=5 with 10), all started together: seconds of each, ptxas's
           registers, stack frame and spills of every kernel function
           (each quorum kernel at each V), and the round kernel's shared
           memory and resident blocks per SM
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
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from raft_tpu_torch import build, interop
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops import quorum as qr
from raft_tpu_torch.ops import quorum_cuda as qc
from raft_tpu_torch.ops import round_cuda as rc
from raft_tpu_torch.ops.fused import FusedCluster
from raft_tpu_torch.scheduler import BlockedFusedCluster

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet); the
# quorum kernels' compares, selects and adds are 32-bit scalar operations
SCALAR_OPS_PER_S = 67e12
# The libraries of csrc/round.cu this script builds, as (Shape, CUDA block
# lanes): bench.py's widths at the main path's V, at its engine block and at
# the small blocks check_round_kernel uses, and at the second V; plus two
# more engine blocks at V=3 for the block-size sweep of round_kernel_timing.
BENCH_WIDTHS = dict(w=16, e=2, f=2, r=2)
ROUND_BUILDS = [(dict(v=3, **BENCH_WIDTHS), 96), (dict(v=3, **BENCH_WIDTHS), 6),
                (dict(v=5, **BENCH_WIDTHS), 10), (dict(v=3, **BENCH_WIDTHS), 48),
                (dict(v=3, **BENCH_WIDTHS), 192)]
MAIN_GROUPS = 1 << 20
MAIN_BLOCK_GROUPS = 1 << 16
VOTERS = 3
BLOCK_LANES = MAIN_BLOCK_GROUPS * VOTERS  # 196,608
TIMED_ROUNDS = 32
WARM_LIMIT = 40 * 16  # bench.py:76-84


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                flush.fill_(0)
            fn()
        torch.cuda.synchronize()
    times = [_device_us(e) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if not times:
        raise AssertionError(f"the profiler recorded no {name} kernel")
    return sum(times) / len(times) / 1e3


def raw_launch(kernel, *args, target=None):
    """A call of the kernel's C entry on the current stream with arguments
    packed once: no checks, allocation or launch count."""
    fn = kernel.fn(target)
    stream = torch.cuda.current_stream().cuda_stream

    def go():
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


def run_main(dev, phase="main", **engine):
    lag = 8
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
        launches=launches, expected_launches=expect,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    if leaders != MAIN_GROUPS or commits <= 0:
        raise AssertionError(f"{phase}: {leaders} leaders, {commits} commits")
    if pallas and commits != MAIN_GROUPS * VOTERS * TIMED_ROUNDS:
        raise AssertionError(f"{phase}: commits per group-round is not 1.0")
    want = {"round_kernel": expect, "joint_kernel": 0} if pallas else {"joint_kernel": expect}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{phase}: {name} launched {launches[name]} times, expected {n}")
    return c, launches, 1e3 * dt / TIMED_ROUNDS


# -- the round megakernel ------------------------------------------------------


def carry_leaves(st, fb, samp, parts) -> list:
    """(name, numpy leaf) of one launch's outputs, in packing order."""
    names = rc.dataclass_names()
    out = [("state." + n, x) for n, x in zip(names["STATE"], interop.to_numpy_leaves(st))]
    out += [("fabric." + n, x) for n, x in zip(names["FABRIC"], interop.to_numpy_leaves(fb))]
    if samp is not None:
        out += [("samp_index", samp[0].cpu().numpy()), ("samp_round", samp[1].cpu().numpy()),
                ("partials", parts.cpu().numpy())]
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


def round_occupancy(d: dict, cta: int) -> dict:
    """csrc/round.cu raft_round_info for the Shape's library: shared memory
    of a block of cta lanes, resident blocks per SM, registers and local
    (stack) bytes per thread, as the runtime reports them."""
    fn = build.load(rc.target(d, cta)).raft_round_info
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    err = fn(cta, out)
    if err:
        raise RuntimeError(f"raft_round_info({cta}) failed: CUDA error {err}")
    return dict(smem_bytes=out[0], blocks_per_sm=out[1], registers=out[2],
                local_bytes=out[3])


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
    built = build.build("quorum", *(rc.target(d, cta) for d, cta in ROUND_BUILDS))
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
    for d, cta in ROUND_BUILDS:
        rows[rc.target(d, cta).key].update(cta_lanes=cta, **round_occupancy(d, cta))
    emit("build", seconds=time.perf_counter() - t0, targets=rows)


def time_round_kernel(c):
    """Launches at the main path's shape (block 0's carry) against the plain
    version, K=1 and K=8; the kernel timed on raw launches (the arguments
    packed once: the wrapper's per-call packing, about a millisecond of host
    time, would otherwise set the pace) beside its wrapper, the plain
    version and the bound; then raw K=1 launches at other CUDA blocks."""
    b = c.blocks[0]
    shape = b.shape
    d = rc.dims_of(b.state, b.fab, b.v)
    cta = engine_cta(d)
    m = b.metrics
    args = (b.state, b.fab, b._no_ops, b.mute, (m.samp_index, m.samp_round), m.round_ctr)
    kern = rc.KERNELS["round_kernel"]

    def kw(kc, cta=cta):
        return dict(v=b.v, kc=kc, cta=cta, apply_ops=True, ops_round0_only=True,
                    do_tick=True, auto_propose=True, auto_compact_lag=8)

    def raw(kc, cta=cta):
        ptrs, dims, flags, lag, outs = rc.pack(*args, **kw(kc, cta))
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        return raw_launch(kern, arr, nptr, cdims, flags, lag, target=rc.target(d, cta)), outs

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
            raise AssertionError(f"round_kernel K={kc} at the main path's shape: "
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
                wrapper_ms=cuda_ms(lambda: rc.round_call(*args, **kw(1)), iters=20),
                plain_ms=cuda_ms(lambda: plr.round_kernel_ref(*args, **kw(1)), iters=3),
            )
        del go, outs
    sweep = {}
    tile = b._pallas_tile
    for cb in sorted({48, 96, 192, cta}):
        if tile % cb or cb % b.v or rc.smem_bytes(d, cb) > rc.MAX_SMEM:
            continue
        sweep[cb] = round_occupancy(d, cb)
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
    emit("round_kernel_timing", **row)
    return row


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
    c, launches, round_ms = run_main(dev)
    profile_round(c, round_ms)
    del c
    torch.cuda.empty_cache()

    check_round_kernel(dev)
    check_parity_pallas()
    c8, launches8, _ = run_main(dev, "main_pallas", engine="pallas", rounds_per_call=8)
    del c8
    c1, launches1, round_ms1 = run_main(dev, "main_pallas", engine="pallas", rounds_per_call=1)
    timing["round_kernel"] = time_round_kernel(c1)
    profile_round(c1, round_ms1, "profile_pallas")
    launches["round_kernel"] = launches1["round_kernel"]

    replaces = {
        "committed_kernel": "raft_tpu/ops/quorum_pallas.py:99",
        "joint_kernel": "raft_tpu/ops/quorum_pallas.py:106",
        "joint_kernel_vm": "raft_tpu/ops/quorum_pallas.py:120",
        "round_kernel": "raft_tpu/ops/pallas_round.py:564",
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": "raft_tpu_torch/csrc/"
            + ("round.cu" if name == "round_kernel" else "quorum.cu"),
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
        for name in replaces
    ]
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
    sys.exit(main())
