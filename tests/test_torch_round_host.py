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
slim and diet) paging in the kernel over allocation segments of 1, 2 and
4 CUDA blocks, with pools that hold every lane and pools that exhaust,
through launches that reallocate and launches that skip the allocator
(the host build runs a segment's blocks through their rounds, then the
segment's page-out, as the kernel's segment barrier orders them); its
chaos builds (-DRAFT_CHAOS=1, slim and diet) under drops, duplicates, an
asymmetric partition, tick skew, a crash window and an instant restart
inside a launch, and a heal round armed inside one; and the chaos builds
with paging (-DRAFT_CHAOS=1 -DRAFT_PAGED=1, slim and diet) under the same
faults over two-block segments; and its lease builds (-DRAFT_LEASE=1 alone,
and with every other flag) under live leases, tick skew, a crash edge, an
epoch at 32,767 and counters at the int32 edge, at margins 0 to 2. Exact
equality on every carry leaf (the lease columns included), partials row,
PagedLog leaf and chaos probe column. Skips without a C++ compiler.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch import build, interop
from raft_tpu_torch.chaos import device as chmod
from raft_tpu_torch.chaos.device import NEVER, P_ONE, probability
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops.lease import EPOCH_WRAP, LEASE_STATE_FIELDS
from raft_tpu_torch.ops import paged as pgmod
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops import round_cuda as rc
from raft_tpu_torch.state import ERR_DIET_OVERFLOW, ERR_PAGE_EXHAUSTED, is_packed
from raft_tpu_torch.types import MessageType as MT

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

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
# the lease builds: -DRAFT_LEASE=1 alone, and with every other flag
LEASE_CASES = {"lease": (3, BASE, False, None, False),
               "lease_chaos_paged_diet": (3, PAGED_WEFR, True, PAGED_PLAN, True)}


def _await_build(so, deadline: float = 600.0):
    """Wait for the build of `so` (or its .err log)."""
    err = so.with_suffix(".err")
    end = time.monotonic() + deadline
    while not so.exists():
        assert not err.exists(), err.read_text()
        assert time.monotonic() < end, f"no build of {so.name} after {deadline} s"
        time.sleep(0.05)


# the compiler's shell publishes the library ($0.so), or its log as $0.err,
# the moment the compiler ends: a worker that waits on another's build does
# not wait for that worker to ask for the library
_PUBLISH = 'if "$@" > "$0.log" 2>&1; then mv "$0.tmp" "$0.so"; else mv "$0.log" "$0.err"; fi'


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """(v, (w, e, f, r), diet) -> csrc/round.cu compiled as plain C++ for
    that Shape, blocks of up to 32 lanes and carry layout. The first
    request starts one compiler per library of the module's tests, all at
    once; each library is loaded when it is first asked for. Under xdist
    the session's workers share one build directory, and each library is
    compiled by the first worker that claims it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler for the host build of csrc/round.cu")
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "round_host"
    root.mkdir(exist_ok=True)
    procs = {}
    libs = {}

    def start(key):
        v, wefr, diet, plan, chaos, lease = key
        d = dict(zip("vwefr", (v, *wefr)))
        t = rc.target(d, 2 * v, diet, plan, chaos, lease)
        so = root / f"{t.key}.so"
        procs[key] = (None, so)
        try:
            os.close(os.open(so.with_suffix(".claim"), os.O_CREAT | os.O_EXCL))
        except FileExistsError:  # built, or being built, by another worker
            return
        base = str(so)[: -len(".so")]
        procs[key] = (subprocess.Popen(
            ["sh", "-c", _PUBLISH, base, cxx, "-std=c++17", "-O0", "-shared", "-fPIC",
             "-Wno-unknown-pragmas", *t.flags, "-x", "c++", str(build.CSRC / "round.cu"),
             "-o", base + ".tmp"]), so)

    def get(v, wefr=BASE, diet=False, plan=None, chaos=False, lease=False):
        key = (v, wefr, diet, plan, chaos, lease)
        if key not in libs:
            if not procs:
                for k in dict.fromkeys([(cv, cw, False, None, False, False) for cv, _, cw in CASES]
                                       + [(cv, cw, True, None, False, False)
                                          for cv, _, cw in DIET_CASES]
                                       + [(3, PAGED_WEFR, d, PAGED_PLAN, False, False)
                                          for d in (False, True)]
                                       + [(*CHAOS_CASE, d, None, True, False) for d in (False, True)]
                                       + [(3, PAGED_WEFR, d, PAGED_PLAN, True, False)
                                          for d in (False, True)]
                                       + [(*case, True) for case in LEASE_CASES.values()]):
                    start(k)
            if key not in procs:
                start(key)
            _await_build(procs[key][1])
            lib = ctypes.CDLL(str(procs[key][1]))
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
            lib.raft_round_lease.argtypes = []
            lib.raft_round_lease.restype = ctypes.c_int
            libs[key] = lib
        return libs[key]

    yield get
    for proc, _ in procs.values():
        if proc is not None:
            proc.wait()


def _outputs(res):
    st, fb, samp, parts = res[:4]
    names = rc.dataclass_names()
    out = [("state." + n, x) for n, x in zip(names["STATE"], interop.to_numpy_leaves(st))]
    if st.lease_left is not None:
        out += [("state." + n, getattr(st, n).numpy()) for n in LEASE_STATE_FIELDS]
    out += [("fabric." + n, x) for n, x in zip(names["FABRIC"], interop.to_numpy_leaves(fb))]
    if samp is not None:
        out += [("samp_index", samp[0].numpy()), ("samp_round", samp[1].numpy())]
    if parts is not None:
        out += [("partials", parts.numpy())]
    for extra in res[4:]:
        if isinstance(extra, tuple):  # the probe columns of a chaos launch
            out += [("chaos." + n, x.numpy()) for n, x in zip(rc.chmod.PROBES, extra)]
        else:  # the PagedLog of a paged launch
            out += [("paged." + n, x) for n, x in zip(rc.PAGED_LEAVES, interop.to_numpy_leaves(extra))]
    return out


def _launch_both(lib, c, ops, what, **kw):
    """One launch of the host build `lib` and of round_kernel_ref on the
    carry of cluster c; every output leaf equal; returns the plain
    version's outputs."""
    m = c.metrics
    args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
    want = plr.round_kernel_ref(*args, **kw)
    ptrs, dims, flags, lag, got = rc.pack(*args, **kw)
    arr, nptr, cdims = rc.as_c_args(ptrs, dims)
    assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 0
    for (name, a), (_, b) in zip(_outputs(want), _outputs(got), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, name)
    return want


def _advance(c, want, kc):
    """c's carry, metrics and chaos state after a launch whose outputs are
    `want`."""
    c.state, c.fab = want[0], want[1]
    c.metrics = plr.fold_partials(c.metrics, want[2], want[3], kc)
    if c.chaos is not None:
        c.chaos = plr.fold_chaos(c.chaos, want[4], want[3], kc, True)


@pytest.mark.parametrize("diet", [False, True], ids=["slim", "diet"])
def test_every_lane_reads_and_rewrites_its_cells(host_lib, diet):
    """The block's one fabric buffer holds each lane's inbox and outbox: a
    round whose every lane reads its inbound cells and rewrites its own.
    Every lane of a fresh PreVote cluster campaigns at once, so in the
    next round each grants its peers' pre-votes with responses that copy
    the request's term (in.vote_term) while its peers read its requests;
    then the real votes, each candidate rejecting the others. The four
    groups share one 12-lane block, a group at each position in it; the
    launches at K = 1, 1 and 3 equal round_kernel_ref's on every leaf."""
    v = 3
    lib = host_lib(v, BASE, diet)
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v), device="cpu", diet=diet,
                            pre_vote=True)
    kw = dict(v=v, cta=n, apply_ops=True, ops_round0_only=True, do_tick=False,
              auto_propose=False, auto_compact_lag=2)
    want = _launch_both(lib, c, c.ops(hup={i: True for i in range(n)}), "hup", kc=1, **kw)
    peers = ~np.eye(v, dtype=bool)[np.arange(n) % v]  # cell j of lane i: a peer's
    assert (want[1].vote.kind.numpy()[peers] == MT.MSG_PRE_VOTE).all()
    _advance(c, want, 1)
    want = _launch_both(lib, c, c._no_ops, "grants", kc=1, **kw)
    fab = want[1].vresp
    assert (fab.kind.numpy()[peers] == MT.MSG_PRE_VOTE_RESP).all()
    assert (fab.term.to(torch.int32).numpy()[peers] == 1).all() and not fab.reject.any()
    _advance(c, want, 1)
    want = _launch_both(lib, c, c._no_ops, "votes", kc=3, **kw)
    assert (want[0].term.to(torch.int32) == 1).all()


def test_chaos_duplicate_keeps_only_an_empty_cell(host_lib):
    """The chaos build's duplicates on the one fabric buffer: with the
    duplicate draw certain on every edge of two groups, a cell that its
    sender left empty this round holds the last round's message (the old
    cell stays), and one that it rewrote holds what it wrote (the new
    cell stays). Launches at K = 1 and 3, proposing and not, equal
    round_kernel_ref(chaos=)'s; each K = 1 launch is also held against the
    same launch without duplicates, and both kinds of cell occur."""
    v, wefr = CHAOS_CASE
    lib = host_lib(v, wefr, False, None, True)
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v, wefr), device="cpu", chaos=True)
    c.run(12, **RUN)
    dup = np.where((np.arange(n) < 2 * v)[:, None], P_ONE, 0).repeat(v, 1).astype(np.int32)
    c.set_chaos(dup_num=dup)
    faulty = np.arange(n)[:, None] < 2 * v
    kept = rewritten = 0
    for r in range(6):
        kc = 1 if r % 2 == 0 else 3
        kw = dict(v=v, kc=kc, cta=2 * v, apply_ops=True, ops_round0_only=True, do_tick=True,
                  auto_propose=r % 4 != 2, auto_compact_lag=2)
        want = _launch_both(lib, c, c._no_ops, r, chaos=c.chaos, **kw)
        if kc == 1:
            m = c.metrics
            args = (c.state, c.fab, c._no_ops, c.mute, (m.samp_index, m.samp_round),
                    m.round_ctr)
            quiet = plr.round_kernel_ref(
                *args, chaos=chmod.with_columns(c.chaos, dup_num=np.zeros_like(dup)), **kw)
            for ch in tfused.CHANNELS:
                old, new, own = (getattr(f, ch) for f in (c.fab, want[1], quiet[1]))
                sent = old.kind.numpy() != MT.MSG_NONE
                empty = sent & (own.kind.numpy() == MT.MSG_NONE) & faulty
                wrote = sent & (own.kind.numpy() != MT.MSG_NONE) & faulty
                for fld in dataclasses.fields(old):
                    a, b, q = (getattr(x, fld.name).numpy() for x in (old, new, own))
                    assert np.array_equal(b[empty], a[empty]), (r, ch, fld.name)
                    assert np.array_equal(b[wrote], q[wrote]), (r, ch, fld.name)
                kept += int(empty.sum())
                rewritten += int(wrote.sum())
        _advance(c, want, kc)
    assert kept and rewritten, (kept, rewritten)


def test_diet_boundary_clamps_what_a_round_wrote(host_lib):
    """The diet build's boundary clamps only the ring slots and outbox
    cells a round wrote (the rest of the carry is in its packed range when
    the round starts): the first two groups' leaders propose 40,000-byte
    entries, over log_bytes' int16 range, which the round writes into a
    ring slot and sends in an outbox cell, beside the slots and cells it
    leaves alone. The clamped values and the ERR_DIET_OVERFLOW bits equal
    round_kernel_ref's, at K = 1 and then 3."""
    v = 3
    lib = host_lib(v, BASE, True)
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v), device="cpu", diet=True)
    c.run(24, **RUN)  # every group elected
    lead = c.leader_lanes()
    big = lead[lead < 2 * v]
    assert len(big) == 2
    kw = dict(v=v, cta=2 * v, apply_ops=True, ops_round0_only=True, do_tick=True,
              auto_propose=False, auto_compact_lag=2)
    ops = c.ops(prop_n={int(i): 1 for i in big}, prop_bytes=40_000)
    want = _launch_both(lib, c, ops, "propose", kc=1, **kw)
    over = (want[0].error_bits & ERR_DIET_OVERFLOW).numpy() != 0
    assert over[big].all() and over.sum() == len(big)
    assert ((want[0].log_bytes.numpy() == 32767).sum(1) == np.isin(np.arange(n), big)).all()
    sent = want[1].rep.ent_bytes.numpy() == 32767
    assert sent[big].any(axis=(1, 2)).all() and sent.any(axis=(1, 2)).sum() == len(big)
    _advance(c, want, 1)
    want = _launch_both(lib, c, c._no_ops, "replicate", kc=3, **kw)
    assert ((want[0].log_bytes.numpy() == 32767).sum(1) >= 1).sum() >= 2 * v


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


# (lanes a segment, lanes a CUDA block) of the paged lane tests: segments
# of 1, 2 and 4 blocks
SEGMENTS = {"1-block": (6, 6), "2-block": (6, 3), "4-block": (12, 3)}


# (pool pages, groups muted from the start) of the paged lane tests: a pool
# that holds every lane, one that exhausts (it clips a block's run of
# pages), and the exhausting one with the first two groups silent, so that
# the first block (in the 4-block segments the first two) needs no page:
# an empty run
POOLS = {"full_pool": (0, 0), "exhausting_pool": (8, 0), "empty_block": (8, 2)}


@pytest.mark.parametrize("segment", list(SEGMENTS))
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("diet", [False, True], ids=["slim", "diet"])
def test_paged_lane_code_equals_plain_version(host_lib, diet, pool, segment):
    """The paged build (in-kernel paging, allocation segments of 1, 2 and
    4 CUDA blocks) against round_kernel_ref on the same resident carry and
    PagedLog: launches at K = 1 and 3 with proposals while the logs outrun
    the resident window (the allocator runs: each block's run of pages
    written, and with the 8-page pool runs clipped at the sub-pool's end
    and lanes clamped with ERR_PAGE_EXHAUSTED; `empty_block`: blocks whose
    muted groups never append write an empty run beside full ones), then
    quiet launches (no tick, no proposals) until the allocator is skipped
    on both sides. A segment of several blocks takes the barrier's
    scratch from its caller: pack refuses it without one."""
    v = 3
    tile, cta = SEGMENTS[segment]
    pool, silent = POOLS[pool]
    lib = host_lib(v, PAGED_WEFR, diet, PAGED_PLAN)
    geo = (ctypes.c_longlong * 4)()
    lib.raft_round_paged(geo)
    assert tuple(geo) == (1, *PAGED_PLAN) and lib.raft_round_diet() == int(diet)
    d = dict(zip("vwefr", (v, *PAGED_WEFR)))
    assert lib.raft_round_smem() == rc.smem_bytes(d, 2 * v, paged=True) > rc.smem_bytes(d, 2 * v)
    n = G * v
    # the 8-page pool: 4 or 8 pages a segment, under what the deep lanes need
    shape = dataclasses.replace(_shape(n, v, PAGED_WEFR), pool_pages=pool)
    c = tfused.FusedCluster(G, v, seed=7, shape=shape, device="cpu", diet=diet,
                            engine="pallas", tile_lanes=tile, paged=True, paged_inkernel=True)
    assert c._paged_segs == n // tile and c.paged.pool_term.shape[0] == (pool or n * 3 + 8)
    if silent:
        c.set_mute(range(silent * v))
    c.run(12, auto_propose=True, auto_compact_lag=12)
    skipped0 = int(c.paged.skipped.sum())
    segments = rc.Segments(n // cta, "cpu") if tile > cta else None
    for r in range(14):
        quiet = r >= 8
        ops = c.ops(prop_n={i: 2 for i in range(n)}, prop_bytes=5) if r % 4 == 0 else c._no_ops
        m = c.metrics
        args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
        kc = 1 + 2 * (r % 2)
        kw = dict(v=v, kc=kc, cta=cta, apply_ops=not quiet, ops_round0_only=True,
                  do_tick=not quiet, auto_propose=not quiet, auto_compact_lag=12, paged=c.paged,
                  seg_lanes=tile)
        want = plr.round_kernel_ref(*args, **kw)
        if segments is not None and r == 0:  # the scratch has one owner, the caller
            with pytest.raises(ValueError, match="needs the barrier's scratch"):
                rc.pack(*args, **kw)
        ptrs, dims, flags, lag, got = rc.pack(*args, segments=segments, **kw)
        assert dims[8:10] == [c.paged.pool_term.shape[0] * tile // n, tile // cta]
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 0
        for (name, a), (_, b) in zip(_outputs(want), _outputs(got), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), (diet, pool, segment, r, name)
        c.state, c.fab, c.paged = want[0], want[1], want[4]
        c.metrics = plr.fold_partials(m, want[2], want[3], kc)
    stats = pgmod.paged_stats(c.paged)
    assert stats["paged_pages_dirty"] > 0 and stats["paged_alloc_skipped"] > skipped0
    exhausted = (c.state.error_bits & ERR_PAGE_EXHAUSTED) != 0
    assert bool(exhausted.any()) == (pool > 0) and (stats["paged_exhausted"] > 0) == (pool > 0)
    if silent:  # the silent groups' lanes hold no page: their block's run was empty
        assert not c.paged.pt[: silent * v].to(torch.int32).any()


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


# The crash windows of the chaos-paged lane tests, (lane, crash_at,
# restart_at) in rounds after the first launch's first round r0; the
# launches start at r0 + 0, 1, 4, 5, 8, 9, 12, 13, ... (K = 1, 3, 1, 3, ...).
# `inside`: a window that opens inside a K=3 launch and closes at one's
# first round, and an instant restart at a K=1 launch. `launch_edges`: a
# window open since before the first launch that closes at a K=3 launch's
# last round, one that opens and closes at K=3 launches' first rounds, one
# that opens and closes at their last rounds, and an instant restart at a
# K=3 launch's first round.
CRASHES = {
    "inside": ((1, 2, 5), (3 * 3, 4, 4)),
    "launch_edges": ((1, -3, 3), (3 + 1, 5, 9), (2 * 3 + 2, 7, 11), (3 * 3, 13, 13)),
}


@pytest.mark.parametrize("diet,crashes", [
    (False, "inside"), (True, "inside"), (False, "launch_edges"), (True, "launch_edges"),
], ids=["slim", "diet", "slim-launch_edges", "diet-launch_edges"])
def test_chaos_paged_lane_code_equals_plain_version(host_lib, diet, crashes):
    """The chaos build with paging (round_kernel_chaos_paged) against
    round_kernel_ref(paged=, chaos=) on the same resident carry, PagedLog
    and ChaosState, over two 6-lane segments of two 3-lane blocks: the
    chaos case's faults (drops, duplicates, an asymmetric partition, tick
    skew, crash windows and an instant restart, CRASHES: inside launches,
    or at a launch's first and last rounds and from before the first, the
    edges the kernel's facts of a launch encode, the heal round armed at a
    launch's last round) with proposals while the logs outrun the resident
    window, metrics on and off, then quiet launches until the allocator is
    skipped; every carry leaf, partials row, PagedLog leaf and probe
    column."""
    v = 3
    lib = host_lib(v, PAGED_WEFR, diet, PAGED_PLAN, True)
    geo = (ctypes.c_longlong * 4)()
    lib.raft_round_paged(geo)
    assert tuple(geo) == (1, *PAGED_PLAN) and lib.raft_round_chaos() == 1
    d = dict(zip("vwefr", (v, *PAGED_WEFR)))
    assert lib.raft_round_smem() == rc.smem_bytes(d, 2 * v, paged=True, chaos=True)
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v, PAGED_WEFR), device="cpu",
                            diet=diet, engine="pallas", tile_lanes=2 * v, paged=True,
                            paged_inkernel=True, chaos=True)
    c.run(12, auto_propose=True, auto_compact_lag=12)
    r0 = int(c.chaos.round)
    edge = np.where((np.arange(n) < 2 * v)[:, None], probability(0.2), 0).repeat(v, 1)
    send, recv = np.ones(n, np.int32), np.ones(n, np.int32)
    send[2 * v], recv[2 * v] = 3, 2
    crash, restart = np.full(n, NEVER, np.int32), np.full(n, NEVER, np.int32)
    for lane, down, up in CRASHES[crashes]:
        crash[lane], restart[lane] = r0 + down, r0 + up
    c.set_chaos(drop_num=edge.astype(np.int32), dup_num=edge.astype(np.int32),
                tick_skew_num=np.full(n, probability(0.3)), part_send=send, part_recv=recv,
                crash_at=crash, restart_at=restart, heal_round=r0 + 7,
                reelect_round=np.full(n, NEVER), recommit_round=np.full(n, NEVER))
    skipped0 = int(c.paged.skipped.sum())
    segments = rc.Segments(n // v, "cpu")
    for r in range(12):
        quiet = r >= 8
        metrics = r % 3 != 2
        ops = c.ops(prop_n={i: 2 for i in range(n)}, prop_bytes=5) if r % 4 == 0 else c._no_ops
        m = c.metrics
        samp = (m.samp_index, m.samp_round) if metrics else None
        args = (c.state, c.fab, ops, c.mute, samp, m.round_ctr if metrics else None)
        kc = 1 + 2 * (r % 2)
        kw = dict(v=v, kc=kc, cta=v, apply_ops=not quiet, ops_round0_only=True,
                  do_tick=not quiet, auto_propose=not quiet, auto_compact_lag=12, paged=c.paged,
                  chaos=c.chaos, seg_lanes=2 * v)
        want = plr.round_kernel_ref(*args, **kw)
        ptrs, dims, flags, lag, got = rc.pack(*args, segments=segments, **kw)
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 0
        for (name, a), (_, b) in zip(_outputs(want), _outputs(got), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), (diet, r, name)
        c.state, c.fab, c.paged = want[0], want[1], want[4]
        if metrics:
            c.metrics = plr.fold_partials(m, want[2], want[3], kc)
        c.chaos = plr.fold_chaos(c.chaos, want[5], want[3], kc, metrics)
    stats = pgmod.paged_stats(c.paged)
    assert stats["paged_pages_dirty"] > 0 and stats["paged_alloc_skipped"] > skipped0
    cols = c.chaos_columns()
    assert cols["round"] == r0 + 24 and 0 < cols["n_reelected"] <= G
    assert (cols["recommit_round"] != NEVER).any()


@pytest.mark.parametrize("case", list(LEASE_CASES))
def test_lease_lane_code_equals_plain_version(host_lib, case):
    """The lease builds against round_kernel_ref on the same carry with the
    lease columns: -DRAFT_LEASE=1 alone (a check_quorum cluster), and with
    chaos, paging over two-block segments and the packed carry under tick
    skew 0.5, a crash window and an instant restart of leased lanes. Live
    leases, leaders' leases dropped with their epochs at 32,767 (the
    re-grant wraps them), renewal counters at 2^31 - 2 (they wrap), a
    transfer that revokes, a muted follower in two groups and launches
    without proposals (a leader's ack quorum then needs its own slot: no
    self-ack arrives), and the margin
    0, 1 or 2 from launch to launch; ten launches at K = 1 and 3, every
    carry leaf, partials row, PagedLog leaf and probe column."""
    v, wefr, diet, plan, chaos = LEASE_CASES[case]
    lib = host_lib(v, wefr, diet, plan, chaos, lease=True)
    assert lib.raft_round_lease() == 1 and host_lib(v, wefr, diet, plan, chaos).raft_round_lease() == 0
    n = G * v
    paged = plan is not None
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v, wefr), device="cpu", diet=diet,
                            chaos=chaos, lease=True, check_quorum=True, election_tick=5,
                            engine="pallas", tile_lanes=2 * v, paged=paged,
                            paged_inkernel=paged)
    c.run(15, auto_propose=True, auto_compact_lag=12)
    st = c.state
    lead = st.state.to(torch.int32) == 2
    assert bool((st.lease_left.to(torch.int32) > 0).any()), "no live lease to carry"

    def put(col, mask, value):
        return torch.where(mask, value, col.to(torch.int32)).to(col.dtype)

    first = lead & (torch.arange(n) < 2 * v)
    c.state = dataclasses.replace(
        st, lease_left=put(st.lease_left, first, 0),
        lease_epoch=put(st.lease_epoch, first, EPOCH_WRAP - 1),
        lease_renewals=put(st.lease_renewals, lead, 2**31 - 2))
    if chaos:
        r0 = int(c.chaos.round)
        crash, restart = np.full(n, NEVER, np.int32), np.full(n, NEVER, np.int32)
        leaders = np.nonzero(lead.numpy())[0]
        crash[leaders[0]], restart[leaders[0]] = r0 + 3, r0 + 6
        crash[leaders[-1]], restart[leaders[-1]] = r0 + 5, r0 + 5
        c.set_chaos(tick_skew_num=np.full(n, probability(0.5)), crash_at=crash,
                    restart_at=restart)
    xfer = np.nonzero(lead.numpy() & (np.arange(n) >= 2 * v))[0]
    # one follower of groups 0 and 1 muted: their leaders' ack quorums need
    # the leader's own slot in the launches without proposals
    c.set_mute([next(g * v + j for j in range(v) if not lead[g * v + j]) for g in (0, 1)])
    segments = rc.Segments(n // v, "cpu") if paged else None
    seen = dict.fromkeys(LEASE_STATE_FIELDS[3:], 0)
    for r in range(10):
        metrics = r % 3 != 2
        m = c.metrics
        samp = (m.samp_index, m.samp_round) if metrics else None
        ops = c._no_ops
        if r == 4:  # a transfer away from the last groups' leaders revokes their leases
            ops = c.ops(transfer_to={int(x): int((x + 1) % v + 1) for x in xfer})
        args = (c.state, c.fab, ops, c.mute, samp, m.round_ctr if metrics else None)
        kc = 1 + 2 * (r % 2)
        kw = dict(v=v, kc=kc, cta=v if paged else 2 * v, apply_ops=True, ops_round0_only=True,
                  do_tick=True, auto_propose=r % 4 != 3, auto_compact_lag=12,
                  paged=c.paged, chaos=c.chaos, seg_lanes=2 * v, lease_margin=r % 3)
        want = plr.round_kernel_ref(*args, **kw)
        ptrs, dims, flags, lag, got = rc.pack(*args, segments=segments, **kw)
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        assert lib.raft_round_host(arr, nptr, cdims, flags, lag) == 0
        for (name, a), (_, b) in zip(_outputs(want), _outputs(got), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), (case, r, name)
        before = c.state
        c.state, c.fab = want[0], want[1]
        for k in seen:
            seen[k] += int((getattr(c.state, k) != getattr(before, k)).sum())
        if paged:
            c.paged = want[4]
        if metrics:
            c.metrics = plr.fold_partials(m, want[2], want[3], kc)
        if chaos:
            c.chaos = plr.fold_chaos(c.chaos, want[-1], want[3], kc, metrics)
    assert seen["lease_grants"] and seen["lease_renewals"] and seen["lease_revocations"], seen
    if not chaos:  # the dropped leases were granted again, their epochs wrapped
        assert int(c.state.lease_epoch[first].to(torch.int32).max()) == 0
    assert (c.state.lease_renewals < 0).any()  # wrapped past 2^31 - 1
    if chaos:
        assert seen["lease_skew_revocations"], seen
