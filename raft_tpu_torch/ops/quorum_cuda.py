"""Wrappers of the CUDA commit-index kernels (csrc/quorum.cu).

Each wrapper takes the plain PyTorch version (ops/quorum.py) for tensors
on the CPU, and only then; for tensors on the card it checks device, dtype,
shape, contiguity and, for the lane-major kernels' 16-byte and 32-bit
loads, alignment, launches its kernel on the current stream, and raises on
anything the kernel does not take or on a refused launch. There is no
fallback from the card to the plain version.

Each kernel counts its launches (`KERNELS[name].launches`), so a run can
show that it went through the kernel.

| kernel            | replaces (raft_tpu/ops/quorum_pallas.py)          |
| committed_kernel  | _committed_kernel :99, committed_pallas :155      |
| joint_kernel      | _joint_kernel :106, joint_committed_pallas :178   |
| joint_kernel_vm   | _joint_kernel_vm :120, joint_committed_packed :205 |
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch import build
from raft_tpu_torch.ops import quorum as plain

I32 = torch.int32
MAX_V = 8  # the kernels instantiate V = 1..8
VPAD = 8  # voter rows of the packed voter-major layout
_TILE = 1024  # lane padding of the packed layout (quorum_pallas._TILE)

_P = ctypes.c_void_p
_N = ctypes.c_longlong


class Kernel:
    """One C entry point of a library built from csrc/ and its launch
    count; `lib` is the default build target (a source name, or a
    build.Target with its -D macros), `launch(..., target=)` another."""

    def __init__(self, name: str, symbol: str, argtypes, lib: build.Target | str = "quorum"):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.lib = lib
        self.launches = 0
        self._fns = {}

    def fn(self, target: build.Target | str | None = None):
        key = target or self.lib
        fn = self._fns.get(key)
        if fn is None:
            fn = getattr(build.load(build.as_target(key)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[key] = fn
        return fn

    def launch(self, device: torch.device, *args, target: build.Target | str | None = None):
        """Call the entry with `args` and the raw handle of `device`'s
        current stream, making `device` current only when it is not;
        raises on a non-zero CUDA error."""
        fn = self.fn(target)
        index = device.index
        current = torch._C._cuda_getDevice()  # CUDA is up: device's tensors exist
        if index is None or index == current:
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(current))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc}")
        self.launches += 1


KERNELS = {
    k.name: k
    for k in (
        Kernel("committed_kernel", "raft_committed", [_P, _P, _P, _N, ctypes.c_int, _P]),
        Kernel(
            "joint_kernel", "raft_joint_committed",
            [_P, _P, _P, _P, _N, ctypes.c_int, _P],
        ),
        Kernel(
            "joint_kernel_vm", "raft_joint_committed_vm",
            [_P, _P, _P, _P, _N, _N, ctypes.c_int, _P],
        ),
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _check(what: str, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if x.shape != shape:
        raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_lane_major(dev, match, *masks):
    """(n, v, data pointers) of lane-major operands on dev: match i32
    [N, V] and (name, bool [N, V]) masks. The kernels read match in 16-byte
    and each mask in 32-bit accesses (csrc/quorum.cu), so each must start
    aligned to that."""
    shape = match.shape
    if len(shape) != 2:
        raise ValueError(f"match must be [N, V], got shape {tuple(shape)}")
    n, v = shape
    if not 1 <= v <= MAX_V:
        raise ValueError(f"the quorum kernels take 1 <= V <= {MAX_V}, got V={v}")
    _check("match", match, I32, shape, dev)
    ptrs = [match.data_ptr()]
    if ptrs[0] % 16:
        raise ValueError("match must start 16-byte aligned")
    for name, m in masks:
        _check(name, m, torch.bool, shape, dev)
        ptrs.append(m.data_ptr())
        if ptrs[-1] % 4:
            raise ValueError(f"{name} must start 4-byte aligned")
    return n, v, ptrs


def committed(match, mask):
    """MajorityConfig.CommittedIndex per lane: match i32 [N, V], mask bool
    [N, V] -> i32 [N] (the kernel of quorum_pallas.committed_pallas)."""
    dev = match.device
    if dev.type == "cpu":
        return plain.majority_committed(match, mask)
    n, v, ptrs = _check_lane_major(dev, match, ("mask", mask))
    out = match.new_empty(n)  # the allocator's blocks are 512-byte aligned
    if n:
        KERNELS["committed_kernel"].launch(dev, *ptrs, out.data_ptr(), n, v)
    return out


def joint_committed(match, mask_in, mask_out):
    """JointConfig.CommittedIndex per lane: match i32 [N, V], voter masks
    bool [N, V] -> i32 [N] (the kernel of joint_committed_pallas)."""
    dev = match.device
    if dev.type == "cpu":
        return plain.joint_committed_plain(match, mask_in, mask_out)
    n, v, ptrs = _check_lane_major(dev, match, ("mask_in", mask_in), ("mask_out", mask_out))
    out = match.new_empty(n)
    if n:
        KERNELS["joint_kernel"].launch(dev, *ptrs, out.data_ptr(), n, v)
    return out


def pack_voter_major(x):
    """[N, V] -> [VPAD, N_pad] int32 voter-major, zero-padded
    (quorum_pallas.pack_voter_major): the one-time layout change for
    callers that keep the quorum operands voter-major."""
    n, v = x.shape
    n_pad = -(-n // _TILE) * _TILE
    out = torch.zeros((VPAD, n_pad), dtype=I32, device=x.device)
    out[:v, :n] = x.to(I32).t()
    return out


def joint_committed_packed(match_vm, in_vm, out_vm, *, v: int, n: int):
    """JointConfig.CommittedIndex over packed voter-major operands
    ([VPAD, N_pad] int32 x3) -> i32 [n] (the kernel of
    joint_committed_packed)."""
    if match_vm.device.type == "cpu":
        rows = slice(0, v), slice(0, n)
        return plain.joint_committed_plain(
            match_vm[rows].t(), in_vm[rows].t() != 0, out_vm[rows].t() != 0
        )
    if not 1 <= v <= MAX_V:
        raise ValueError(f"the quorum kernels take 1 <= V <= {MAX_V}, got V={v}")
    shape = match_vm.shape
    if match_vm.dim() != 2 or shape[0] != VPAD or not 0 <= n <= shape[1]:
        raise ValueError(
            f"packed operands must be [{VPAD}, N_pad >= n={n}], got {tuple(shape)}"
        )
    for name, x in (("match_vm", match_vm), ("in_vm", in_vm), ("out_vm", out_vm)):
        _check(name, x, I32, shape, match_vm.device)
    out = torch.empty(n, dtype=I32, device=match_vm.device)
    if n:
        KERNELS["joint_kernel_vm"].launch(
            match_vm.device, match_vm.data_ptr(), in_vm.data_ptr(),
            out_vm.data_ptr(), out.data_ptr(), n, shape[1], v,
        )
    return out
