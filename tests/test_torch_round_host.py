"""The CUDA source's lane code on the CPU: csrc/round.cu compiled as plain
C++ (everything outside its `__CUDACC__` sections) for one Shape, whose
raft_round_host entry runs the kernel's phases block by block on a
block-sized buffer with the kernel's shared-memory layout, held against the
kernel's plain version (ops/pallas_round.py round_kernel_ref) through
partitions, re-elections, proposals, reads, transfers and conf changes, at
K = 1 and 3 rounds per launch. Exact equality on every carry leaf and
partials row. Skips without a C++ compiler.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from raft_tpu_torch import build, interop
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops import round_cuda as rc

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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """(v, (w, e, f, r)) -> csrc/round.cu compiled as plain C++ for that
    Shape and blocks of up to 32 lanes. The first request starts one
    compiler per Shape of CASES, all at once; each library is loaded when
    it is first asked for."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler for the host build of csrc/round.cu")
    root = tmp_path_factory.mktemp("round_host")
    procs = {}
    libs = {}

    def start(key):
        v, wefr = key
        d = dict(zip("vwefr", (v, *wefr)))
        t = rc.target(d, 2 * v)
        so = root / f"{t.key}.so"
        proc = subprocess.Popen(
            [cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-Wno-unknown-pragmas",
             *t.flags, "-x", "c++", str(build.CSRC / "round.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs[key] = (proc, so)

    def get(v, wefr=BASE):
        key = (v, wefr)
        if key not in libs:
            if not procs:
                for k in dict.fromkeys((cv, cw) for cv, _, cw in CASES):
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
            libs[key] = lib
        return libs[key]

    yield get
    for proc, _ in procs.values():
        if proc.returncode is None:
            proc.communicate()


def _outputs(res):
    st, fb, samp, parts = res
    names = rc.dataclass_names()
    out = [("state." + n, x) for n, x in zip(names["STATE"], interop.to_numpy_leaves(st))]
    out += [("fabric." + n, x) for n, x in zip(names["FABRIC"], interop.to_numpy_leaves(fb))]
    out += [("samp_index", samp[0].numpy()), ("samp_round", samp[1].numpy()),
            ("partials", parts.numpy())]
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
