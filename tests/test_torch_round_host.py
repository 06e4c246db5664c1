"""The CUDA source's lane code on the CPU: csrc/round.cu compiled as plain
C++ (everything outside its `__CUDACC__` sections), whose raft_round_host
entry runs the kernel's lane code block by block, held against the kernel's
plain version (ops/pallas_round.py round_kernel_ref) through partitions,
re-elections, proposals, reads, transfers and conf changes. Exact equality
on every carry leaf and partials row. Skips without a C++ compiler.
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


def _shape(n_lanes, v):
    return Shape(n_lanes=n_lanes, max_peers=v, log_window=8, max_msg_entries=2,
                 max_inflight=2, max_read_index=2)


@pytest.fixture(scope="module")
def host_round(tmp_path_factory):
    """csrc/round.cu compiled as plain C++ (its raft_round_host entry runs
    the kernel's lane code block by block on the CPU)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler for the host build of csrc/round.cu")
    so = tmp_path_factory.mktemp("round_host") / "round_host.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-x", "c++", str(build.CSRC / "round.cu"), "-o", str(so)],
        check=True, capture_output=True,
    )
    fn = ctypes.CDLL(str(so)).raft_round_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return fn


def _outputs(res):
    st, fb, samp, parts = res
    names = rc.dataclass_names()
    out = [("state." + n, x) for n, x in zip(names["STATE"], interop.to_numpy_leaves(st))]
    out += [("fabric." + n, x) for n, x in zip(names["FABRIC"], interop.to_numpy_leaves(fb))]
    out += [("samp_index", samp[0].numpy()), ("samp_round", samp[1].numpy()),
            ("partials", parts.numpy())]
    return out


@pytest.mark.parametrize("v,cfg", [
    (3, {}), (5, dict(pre_vote=True, check_quorum=True)),
    # the other group sizes the kernel instantiates (V = 1..8)
    (1, {}), (2, {}), (4, dict(pre_vote=True)),
    (6, dict(check_quorum=True)), (7, dict(pre_vote=True)),
    (8, dict(pre_vote=True, check_quorum=True)),
])
def test_cuda_lane_code_equals_plain_version(host_round, v, cfg):
    """Partitions, re-elections, proposals, reads, transfers and conf
    changes: at every round the host build of the kernel's lane code and
    round_kernel_ref give the same carry and partials, at K = 1 and 2."""
    n = G * v
    c = tfused.FusedCluster(G, v, seed=7, shape=_shape(n, v), device="cpu", **cfg)
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
            kw = dict(v=v, kc=1 + r % 2, cta=2 * v, apply_ops=True, ops_round0_only=r % 3 != 0,
                      do_tick=True, auto_propose=r % 3 != 1, auto_compact_lag=2)
            want = plr.round_kernel_ref(*args, **kw)
            ptrs, dims, flags, lag, got, scratch = rc.pack(*args, **kw)
            arr, nptr, cdims = rc.as_c_args(ptrs, dims)
            assert host_round(arr, nptr, cdims, flags, lag) == 0
            for (name, a), (_, b) in zip(_outputs(want), _outputs(got)):
                assert a.dtype == b.dtype and np.array_equal(a, b), (muted, r, name)
            checks += 1
            c.run(1, ops=ops, **RUN)
    assert checks == 24
    # at V = 2 a muted voter leaves its group without a quorum
    assert c.metrics_snapshot()["counters"]["elections_won"] >= (G if v != 2 else 1)
