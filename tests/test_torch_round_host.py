"""The CUDA source's lane code on the CPU: csrc/round.cu compiled as plain
C++ (everything outside its `__CUDACC__` sections) for one Shape, whose
raft_round_host entry runs the kernel's phases block by block on a
block-sized buffer with the kernel's shared-memory layout, held against the
kernel's plain version (ops/pallas_round.py round_kernel_ref) through
partitions, re-elections, proposals, reads, transfers and conf changes, at
K = 1 and 3 rounds per launch; its diet-v2 build (-DRAFT_DIET=1) on
the packed carry, through a carry fast-forwarded to just under 65,535 so
that rounds overflow the packed uint16 columns and the boundary's clamps
and ERR_DIET_OVERFLOW bits show; and its paged builds (-DRAFT_PAGED=1,
slim and diet) paging in the kernel over two-segment pools, one that
holds every lane and one that exhausts, through launches that reallocate
and launches that skip the allocator; and its chaos builds
(-DRAFT_CHAOS=1, slim and diet) under drops, duplicates, an asymmetric
partition, tick skew, a crash window and an instant restart inside a
launch, and a heal round armed inside one. Exact equality on every carry
leaf, partials row, PagedLog leaf and chaos probe column. Skips without a
C++ compiler.
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raft_tpu_torch import build, interop
from raft_tpu_torch.chaos.device import NEVER, probability
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import paged as pgmod
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops import round_cuda as rc
from raft_tpu_torch.state import ERR_DIET_OVERFLOW, ERR_PAGE_EXHAUSTED, is_packed

G = 4
RUN = dict(auto_propose=True, auto_compact_lag=4)
# (W, E, F, R): the Shape of the lane tests, and one whose rings all wrap
# within a few rounds (one-slot inflight and ReadIndex rings, one entry per
# message, a 16-slot log under compaction lag 2)
BASE = (8, 2, 2, 2)
WRAP = (16, 1, 1, 1)


def _shape(n_lanes, v, wefr=BASE):
    w, e, f, r = wefr
    return Shape(n_lanes=n_lanes, max_peers=v, log_window=w, max_msg_entries=e,
                 max_inflight=f, max_read_index=r)


# (v, cfg, (w, e, f, r)) of the lane tests: every group size the kernel
# takes (V = 1..8), and two whose rings all wrap
CASES = [
    (3, {}, BASE), (5, dict(pre_vote=True, check_quorum=True), BASE),
    (1, {}, BASE), (2, {}, BASE), (4, dict(pre_vote=True), BASE),
    (6, dict(check_quorum=True), BASE), (7, dict(pre_vote=True), BASE),
    (8, dict(pre_vote=True, check_quorum=True), BASE),
    (3, {}, WRAP), (5, dict(pre_vote=True, check_quorum=True), WRAP),
]
# (v, cfg, (w, e, f, r)) of the diet build's lane tests
DIET_CASES = [(3, {}, BASE), (5, dict(pre_vote=True, check_quorum=True), WRAP)]
# the paged builds' Shape (the bench widths) and plan (W_res, PE, M) at V=3
PAGED_WEFR = (16, 2, 2, 2)
PAGED_PLAN = (8, 4, 4)
# the chaos builds' (v, (w, e, f, r)), slim and diet
CHAOS_CASE = (3, BASE)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """(v, (w, e, f, r), diet) -> csrc/round.cu compiled as plain C++ for
    that Shape, blocks of up to 32 lanes and carry layout. The first
    request starts one compiler per library of CASES and DIET_CASES, all at
    once; each library is loaded when it is first asked for."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler for the host build of csrc/round.cu")
    root = tmp_path_factory.mktemp("round_host")
    procs = {}
    libs = {}

    def start(key):
        v, wefr, diet, plan, chaos = key
        d = dict(zip("vwefr", (v, *wefr)))
        t = rc.target(d, 2 * v, diet, plan, chaos)
        so = root / f"{t.key}.so"
        proc = subprocess.Popen(
            [cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-Wno-unknown-pragmas",
             *t.flags, "-x", "c++", str(build.CSRC / "round.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs[key] = (proc, so)

    def get(v, wefr=BASE, diet=False, plan=None, chaos=False):
        key = (v, wefr, diet, plan, chaos)
        if key not in libs:
            if not procs:
                for k in dict.fromkeys([(cv, cw, False, None, False) for cv, _, cw in CASES]
                                       + [(cv, cw, True, None, False) for cv, _, cw in DIET_CASES]
                                       + [(3, PAGED_WEFR, d, PAGED_PLAN, False) for d in (False, True)]
                                       + [(*CHAOS_CASE, d, None, True) for d in (False, True)]):
                    start(k)
            if key not in procs:
                start(key)
            proc, so = procs[key]
            log, _ = proc.communicate()
            assert proc.returncode == 0, log
            lib = ctypes.CDLL(str(so))
            lib.raft_round_host.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_int]
            lib.raft_round_smem.argtypes = []
            lib.raft_round_smem.restype = ctypes.c_longlong
            lib.raft_round_shape.argtypes = [ctypes.c_void_p]
            lib.raft_round_diet.argtypes = []
            lib.raft_round_diet.restype = ctypes.c_int
            lib.raft_round_paged.argtypes = [ctypes.c_void_p]
            lib.raft_round_chaos.argtypes = []
            lib.raft_round_chaos.restype = ctypes.c_int
            libs[key] = lib
        return libs[key]

    yield get
    for proc, _ in procs.values():
        if proc.returncode is None:
            proc.communicate()


def _outputs(res):
    st, fb, samp, parts = res[:4]
    names = rc.dataclass_names()
    out = [("state." + n, x) for n, x in zip(names["STATE"], interop.to_numpy_leaves(st))]
    out += [("fabric." + n, x) for n, x in zip(names["FABRIC"], interop.to_numpy_leaves(fb))]
    if samp is not None:
        out += [("samp_index", samp[0].numpy()), ("samp_round", samp[1].numpy())]
    if parts is not None:
        out += [("partials", parts.numpy())]
    if len(res) > 4 and isinstance(res[4], tuple):  # the probe columns of a chaos launch
        out += [("chaos." + n, x.numpy()) for n, x in zip(rc.chmod.PROBES, res[4])]
    elif len(res) > 4:  # the PagedLog of a paged launch
        out += [("paged." + n, x) for n, x in zip(rc.PAGED_LEAVES, interop.to_numpy_leaves(res[4]))]
    return out


@pytest.mark.parametrize("v,cfg,wefr", CASES)
def test_cuda_lane_code_equals_plain_version(host_lib, v, cfg, wefr):
    """Partitions, re-elections, proposals, reads, transfers and conf
    changes: at every round the host build of the kernel's lane code and
    round_kernel_ref give the same carry and partials, at K = 1 and 3."""
    fn = host_lib(v, wefr).raft_round_host
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v, wefr), device="cpu", **cfg)
    phases = [
        ([], {}),
        ([i * v for i in range(G)], dict(prop_n={1: 2, v + 1: 2}, prop_bytes=2)),
        ([], dict(transfer_to={i: i % v + 1 for i in range(n)}, beat={1: True},
                  forget={2: True}, read_ctx={i: 7 + i for i in range(n)})),
        ([i * v + min(2, v - 1) for i in range(G)],
         dict(prop_cc={i: 1 for i in range(n)}, hup={4 % n: True})),
    ]
    checks = 0
    for muted, ops_kw in phases:
        c.set_mute(range(n), on=False)
        if muted:
            c.set_mute(muted)
        for r in range(6):
            ops = c.ops(**ops_kw) if ops_kw and r % 4 == 0 else c._no_ops
            m = c.metrics
            args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
            kw = dict(v=v, kc=1 + 2 * (r % 2), cta=2 * v, apply_ops=True,
                      ops_round0_only=r % 3 != 0, do_tick=True, auto_propose=r % 3 != 1,
                      auto_compact_lag=2)
            want = plr.round_kernel_ref(*args, **kw)
            ptrs, dims, flags, lag, got = rc.pack(*args, **kw)
            arr, nptr, cdims = rc.as_c_args(ptrs, dims)
            assert fn(arr, nptr, cdims, flags, lag) == 0
            for (name, a), (_, b) in zip(_outputs(want), _outputs(got)):
                assert a.dtype == b.dtype and np.array_equal(a, b), (muted, r, name)
            checks += 1
            c.run(1, ops=ops, **RUN)
    assert checks == 24
    # at V = 2 a muted voter leaves its group without a quorum
    assert c.metrics_snapshot()["counters"]["elections_won"] >= (G if v != 2 else 1)


@pytest.mark.parametrize("v,wefr", list(dict.fromkeys(
    [(3, BASE), (5, WRAP)] + [(v, wefr) for v, _, wefr in CASES]
)))
def test_library_is_its_shape(host_lib, v, wefr):
    """Each library of the lane tests answers with the Shape and stride it
    was built for, takes no launch of another Shape, and its block layout
    is the wrapper's smem_bytes."""
    lib = host_lib(v, wefr)
    got = (ctypes.c_longlong * 6)()
    lib.raft_round_shape(got)
    assert tuple(got) == (v, *wefr, 32)
    d = dict(zip("vwefr", (v, *wefr)))
    for cta in (v, 2 * v, 32 - 32 % v):
        assert lib.raft_round_smem() == rc.smem_bytes(d, cta), cta
    c = tfused.FusedCluster(2, v, seed=1, shape=_shape(2 * v, v, wefr), device="cpu")
    m = c.metrics
    args = (c.state, c.fab, c._no_ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
    ptrs, dims, flags, lag, _ = rc.pack(*args, v=v, kc=1, cta=v, apply_ops=True, ops_round0_only=True,
                                       do_tick=True, auto_propose=True, auto_compact_lag=None)
    for k in range(1, 6):
        bad = list(dims)
        bad[k] += 1
        arr, nptr, cdims = rc.as_c_args(ptrs, bad)
        assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 1, k


@pytest.mark.parametrize("near", [False, True], ids=["in_range", "overflow"])
@pytest.mark.parametrize("v,cfg,wefr", DIET_CASES)
def test_diet_lane_code_equals_plain_version(host_lib, v, cfg, wefr, near):
    """The diet build on the packed carry against round_kernel_ref on the
    same carry, eight launches at K = 1 and 3 after an eager warm-up, with
    proposals and reads. `overflow`: the index space fast-forwarded to just
    under 65,535 first (a negative rebase), so appends cross the packed
    uint16 range within the launches; the clamped values and the
    ERR_DIET_OVERFLOW bits must equal the plain version's."""
    lib = host_lib(v, wefr, diet=True)
    assert lib.raft_round_diet() == 1 and host_lib(v, wefr).raft_round_diet() == 0
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v, wefr), device="cpu", diet=True,
                            **cfg)
    c.run(12, **RUN)
    if near:
        w = wefr[0]
        top = int(c.host_state().last.max())
        c.rebase_groups(range(G), delta=-(((65535 - 4 - top) // w) * w))
    assert is_packed(c.state) and not (c.state.error_bits & ERR_DIET_OVERFLOW).any()
    for r in range(8):
        ops = c.ops(prop_n={i: 2 for i in range(n)}, prop_bytes=5,
                    read_ctx={i: 9 + i for i in range(n)}) if r % 4 == 0 else c._no_ops
        m = c.metrics
        args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
        kc = 1 + 2 * (r % 2)
        kw = dict(v=v, kc=kc, cta=2 * v, apply_ops=True, ops_round0_only=True, do_tick=True,
                  auto_propose=True, auto_compact_lag=2)
        want = plr.round_kernel_ref(*args, **kw)
        ptrs, dims, flags, lag, got = rc.pack(*args, **kw)
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 0
        for (name, a), (_, b) in zip(_outputs(want), _outputs(got)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (near, r, name)
        c.state, c.fab = want[0], want[1]
        c.metrics = plr.fold_partials(m, want[2], want[3], kc)
    assert is_packed(c.state)
    flagged = (c.state.error_bits & ERR_DIET_OVERFLOW) != 0
    assert bool(flagged.any()) == near
    if near:  # the clamp held the column at the top of its range
        assert int(c.state.last.to(torch.int32).max()) == 65535


@pytest.mark.parametrize("pool", [0, 8], ids=["full_pool", "exhausting_pool"])
@pytest.mark.parametrize("diet", [False, True], ids=["slim", "diet"])
def test_paged_lane_code_equals_plain_version(host_lib, diet, pool):
    """The paged build (in-kernel paging, two 6-lane segments) against
    round_kernel_ref on the same resident carry and PagedLog: launches at
    K = 1 and 3 with proposals while the logs outrun the resident window
    (the allocator runs: pages written, and with the 8-page pool lanes
    clamped with ERR_PAGE_EXHAUSTED), then quiet launches (no tick, no
    proposals) until the allocator is skipped on both sides."""
    v = 3
    lib = host_lib(v, PAGED_WEFR, diet, PAGED_PLAN)
    geo = (ctypes.c_longlong * 4)()
    lib.raft_round_paged(geo)
    assert tuple(geo) == (1, *PAGED_PLAN) and lib.raft_round_diet() == int(diet)
    d = dict(zip("vwefr", (v, *PAGED_WEFR)))
    assert lib.raft_round_smem() == rc.smem_bytes(d, 2 * v, paged=True) > rc.smem_bytes(d, 2 * v)
    n = G * v
    # the 8-page pool: 4 pages a segment, under what the deep lanes need
    shape = dataclasses.replace(_shape(n, v, PAGED_WEFR), pool_pages=pool)
    c = tfused.FusedCluster(G, v, seed=7, shape=shape, device="cpu", diet=diet,
                            engine="pallas", tile_lanes=2 * v, paged=True, paged_inkernel=True)
    assert c._paged_segs == 2 and c.paged.pool_term.shape[0] == (pool or n * 3 + 8)
    c.run(12, auto_propose=True, auto_compact_lag=12)
    skipped0 = int(c.paged.skipped.sum())
    for r in range(14):
        quiet = r >= 8
        ops = c.ops(prop_n={i: 2 for i in range(n)}, prop_bytes=5) if r % 4 == 0 else c._no_ops
        m = c.metrics
        args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
        kc = 1 + 2 * (r % 2)
        kw = dict(v=v, kc=kc, cta=2 * v, apply_ops=not quiet, ops_round0_only=True,
                  do_tick=not quiet, auto_propose=not quiet, auto_compact_lag=12, paged=c.paged)
        want = plr.round_kernel_ref(*args, **kw)
        ptrs, dims, flags, lag, got = rc.pack(*args, **kw)
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 0
        for (name, a), (_, b) in zip(_outputs(want), _outputs(got)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (diet, pool, r, name)
        c.state, c.fab, c.paged = want[0], want[1], want[4]
        c.metrics = plr.fold_partials(m, want[2], want[3], kc)
    stats = pgmod.paged_stats(c.paged)
    assert stats["paged_pages_dirty"] > 0 and stats["paged_alloc_skipped"] > skipped0
    exhausted = (c.state.error_bits & ERR_PAGE_EXHAUSTED) != 0
    assert bool(exhausted.any()) == (pool > 0) and (stats["paged_exhausted"] > 0) == (pool > 0)


@pytest.mark.parametrize("diet", [False, True], ids=["slim", "diet"])
def test_chaos_lane_code_equals_plain_version(host_lib, diet):
    """The chaos build against round_kernel_ref(chaos=) on the same carry
    and ChaosState: drops and duplicates of 0.2 on two groups, tick skew
    0.3, an asymmetric partition, a lane down for three rounds and an
    instant restart, both inside launches, and the heal round armed inside
    one; eight launches at K = 1 and 3, metrics on and off, the probe
    columns and recounts compared too."""
    v, wefr = CHAOS_CASE
    lib = host_lib(v, wefr, diet, None, True)
    assert lib.raft_round_chaos() == 1 and host_lib(v, wefr, diet).raft_round_chaos() == 0
    d = dict(zip("vwefr", (v, *wefr)))
    assert lib.raft_round_smem() == rc.smem_bytes(d, 2 * v, chaos=True) > rc.smem_bytes(d, 2 * v)
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v, wefr), device="cpu", diet=diet,
                            chaos=True)
    c.run(12, **RUN)
    r0 = int(c.chaos.round)
    lanes = np.arange(n)
    edge = np.where((lanes < 2 * v)[:, None], probability(0.2), 0).repeat(v, 1).astype(np.int32)
    send, recv = np.ones(n, np.int32), np.ones(n, np.int32)
    send[2 * v], recv[2 * v] = 3, 2
    crash, restart = np.full(n, NEVER, np.int32), np.full(n, NEVER, np.int32)
    crash[1], restart[1] = r0 + 2, r0 + 5
    crash[3 * v], restart[3 * v] = r0 + 4, r0 + 4
    c.set_chaos(drop_num=edge, dup_num=edge, tick_skew_num=np.full(n, probability(0.3)),
                part_send=send, part_recv=recv, crash_at=crash, restart_at=restart,
                heal_round=r0 + 7, reelect_round=np.full(n, NEVER), recommit_round=np.full(n, NEVER))
    for r in range(8):
        metrics = r % 3 != 2
        ops = c.ops(prop_n={i: 2 for i in range(n)}, prop_bytes=5) if r % 4 == 0 else c._no_ops
        m = c.metrics
        samp = (m.samp_index, m.samp_round) if metrics else None
        args = (c.state, c.fab, ops, c.mute, samp, m.round_ctr if metrics else None)
        kc = 1 + 2 * (r % 2)
        kw = dict(v=v, kc=kc, cta=2 * v, apply_ops=True, ops_round0_only=True, do_tick=True,
                  auto_propose=True, auto_compact_lag=2, chaos=c.chaos)
        want = plr.round_kernel_ref(*args, **kw)
        ptrs, dims, flags, lag, got = rc.pack(*args, **kw)
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 0
        for (name, a), (_, b) in zip(_outputs(want), _outputs(got), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), (diet, r, name)
        c.state, c.fab = want[0], want[1]
        if metrics:
            c.metrics = plr.fold_partials(m, want[2], want[3], kc)
        c.chaos = plr.fold_chaos(c.chaos, want[4], want[3], kc, metrics)
    cols = c.chaos_columns()
    assert cols["round"] == r0 + 16 and 0 < cols["n_reelected"] <= G
    assert (cols["base_committed"] > 0).any() and (cols["recommit_round"] != NEVER).any()
