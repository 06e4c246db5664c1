"""The CUDA source's quad code on the CPU: csrc/quorum.cu compiled as plain
C++ (everything outside its `__CUDACC__` sections), whose
raft_committed_host / raft_joint_committed_host entries run the kernels'
per-thread body (16-byte and 32-bit loads, mask bytes unpacked from their
words, the ragged last quad) for every thread index in turn, held against
the plain versions of ops/quorum.py. V = 1..8, every n % 4 and n < 4;
random ties, empty configs and joint configs. Exact equality. Skips
without a C++ compiler.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raft_tpu_torch import build
from raft_tpu_torch.ops import quorum as tq

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

NS = [1, 2, 3, 4, 5, 7, 8, 1023, 4097]
_P, _N = ctypes.c_void_p, ctypes.c_longlong
_LIB = {}  # one build a process, shared by every module that asks


def host_library(tmp_path_factory):
    """csrc/quorum.cu compiled with g++ as plain C++ (once a process)."""
    if "lib" not in _LIB:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            pytest.skip("needs a C++ compiler for the host build of csrc/quorum.cu")
        so = tmp_path_factory.mktemp("quorum_host") / "quorum_host.so"
        proc = subprocess.run(
            [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
             "-x", "c++", str(build.CSRC / "quorum.cu"), "-o", str(so)],
            capture_output=True, text=True,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(so))
        lib.raft_committed_host.argtypes = [_P, _P, _P, _N, ctypes.c_int]
        lib.raft_joint_committed_host.argtypes = [_P, _P, _P, _P, _N, ctypes.c_int]
        _LIB["lib"] = lib
    return _LIB["lib"]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory)


def committed_host(lib, match: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """raft_committed_host on CPU tensors: match i32 [N, V], mask bool [N, V]."""
    n, v = match.shape
    out = torch.full((n,), -7, dtype=torch.int32)
    rc = lib.raft_committed_host(match.data_ptr(), mask.data_ptr(), out.data_ptr(), n, v)
    assert rc == 0
    return out


def joint_host(lib, match, mask_in, mask_out) -> torch.Tensor:
    n, v = match.shape
    out = torch.full((n,), -7, dtype=torch.int32)
    rc = lib.raft_joint_committed_host(
        match.data_ptr(), mask_in.data_ptr(), mask_out.data_ptr(), out.data_ptr(), n, v
    )
    assert rc == 0
    return out


def _inputs(v: int, n: int):
    """Acked indexes in 0..15 (many ties), ~5% empty incoming configs, joint
    configs on ~30% of the lanes."""
    rng = np.random.default_rng(7000 + 100 * v + n)
    match = rng.integers(0, 16, size=(n, v), dtype=np.int32)
    mask_in = rng.random((n, v)) < 0.7
    mask_in[rng.random(n) < 0.05] = False
    mask_out = (rng.random((n, v)) < 0.6) & (rng.random(n) < 0.3)[:, None]
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (match, mask_in, mask_out)]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("v", range(1, 9))
def test_quad_code_equals_plain(host_lib, v, n):
    match, mask_in, mask_out = _inputs(v, n)
    assert torch.equal(committed_host(host_lib, match, mask_in),
                       tq.majority_committed(match, mask_in))
    assert torch.equal(joint_host(host_lib, match, mask_in, mask_out),
                       tq.joint_committed_plain(match, mask_in, mask_out))


@pytest.mark.parametrize("v", range(1, 9))
def test_quad_code_counts_any_nonzero_mask_byte(host_lib, v):
    """A bool tensor viewed over uint8 storage may hold bytes 2..255; the
    quad code counts every non-zero byte as a voter, as the plain version's
    tests see them."""
    n = 1027
    rng = np.random.default_rng(9000 + v)
    match = torch.from_numpy(rng.integers(0, 16, size=(n, v), dtype=np.int32))
    raw = [rng.choice(np.array([0, 1, 2, 128, 255], np.uint8), size=(n, v)) for _ in range(2)]
    mask_in, mask_out = (torch.from_numpy(r).view(torch.bool) for r in raw)
    want_in, want_out = (torch.from_numpy(r != 0) for r in raw)
    assert torch.equal(committed_host(host_lib, match, mask_in),
                       tq.majority_committed(match, want_in))
    assert torch.equal(joint_host(host_lib, match, mask_in, mask_out),
                       tq.joint_committed_plain(match, want_in, want_out))


def test_host_entries_refuse_wide_groups(host_lib):
    match = torch.zeros((8, 9), dtype=torch.int32)
    mask = torch.zeros((8, 9), dtype=torch.bool)
    out = torch.zeros(8, dtype=torch.int32)
    p = [x.data_ptr() for x in (match, mask, out)]
    assert host_lib.raft_committed_host(p[0], p[1], p[2], 8, 9) == 1
    assert host_lib.raft_joint_committed_host(p[0], p[1], p[1], p[2], 8, 0) == 1
