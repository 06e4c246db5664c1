"""Wrapper of the round megakernel (csrc/round.cu `round_kernel`).

`round_call` runs `kc` fused rounds over every lane in one launch. For
tensors on the CPU, and only then, it runs the kernel's plain PyTorch
version (ops/pallas_round.py `round_kernel_ref`); for tensors on the card it
checks every leaf's device, dtype, shape and contiguity, launches the kernel
on the current stream, and raises on anything the kernel does not take or on
a refused launch. There is no fallback from the card to the plain version.
The launches are counted in `KERNELS["round_kernel"].launches`.

| kernel        | replaces (raft_tpu/ops/pallas_round.py)                 |
| round_kernel  | make_call(kc).kernel :564, pl.pallas_call :745          |

The argument packing is generated from the dataclass field order of
RaftState, LaneConfig, Fabric and LocalOps. csrc/round.cu carries the same
order, with each leaf's storage dtype and shape, as X-macro tables;
`layout()` parses them, and every launch checks that the two agree.

The kernel is compiled for one Shape (V, W, E, F, R as -D macros) and
one column stride S of its shared memory (`stride(cta)`): the first launch
at a Shape and block size builds its library (`target`), and a Shape the
kernel does not take, or a library that does not build, raises naming the
Shape. `smem_bytes` is csrc/round.cu's Block: the shared memory a CUDA
block takes, which bounds its lane count (`cta_lanes`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import typing

import torch

from raft_tpu_torch import build
from raft_tpu_torch.ops.fused import Fabric, LocalOps
from raft_tpu_torch.ops.quorum_cuda import Kernel, _check
from raft_tpu_torch.state import LaneConfig, RaftState

I32 = torch.int32
MAX_V = 8  # csrc/round.cu takes V = 1..8 ...
CAPS = {"w": 64, "e": 8, "f": 8, "r": 8}  # ... and W, E, F, R up to these
MAX_CTA = 256  # csrc/round.cu kMaxCta
CTA_TARGET = 96  # lanes per CUDA block the engine aims for (PERF.md, PR 3)
MAX_SMEM = 232_448  # shared memory one block can use on the H100 (227 KB)
PARTIAL_WIDTH = 128  # csrc/round.cu kPartialWidth
PART_USED = 25  # csrc/round.cu kPartUsed

_P = ctypes.c_void_p
KERNELS = {
    "round_kernel": Kernel(
        "round_kernel", "raft_round",
        [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P], lib="round",
    )
}
_SIZE = {"I32": 4, "U32": 4, "I16": 2, "I8": 1, "BOOL": 1}
_RINGS = ("WIN", "INFL", "READ", "READ_PEER")
# the state leaves the round never touches: they go from input to output
# in registers and bypass shared memory (csrc/round.cu through())
THROUGH = ("is_learner", "learners_next", "auto_leave", "pri_ctx", "pri_from")

# csrc/round.cu flags
F_MUTE, F_METRICS, F_TICK, F_AUTO_PROPOSE, F_LAG, F_OPS, F_OPS_ROUND0 = (
    1, 2, 4, 8, 16, 32, 64,
)
DTYPES = {
    "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "BOOL": torch.bool, "U32": torch.uint32,
}
GROUPS = ("STATE", "CFG", "FABRIC", "OPS")
_FAB_CHANNELS = tuple(f.name for f in dataclasses.fields(Fabric))


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


@functools.cache
def layout() -> dict[str, tuple[tuple[str, str, str], ...]]:
    """The leaf tables of csrc/round.cu: group -> ((name, dtype, shape), ...)
    in table order."""
    text = (build.CSRC / "round.cu").read_text()
    out = {}
    for group in GROUPS:
        m = re.search(rf"#define RAFT_{group}_FIELDS\(X\)(.*?)\n\n", text, re.S)
        if m is None:
            raise RuntimeError(f"csrc/round.cu has no RAFT_{group}_FIELDS table")
        out[group] = tuple(re.findall(r"X\((\w+),\s*(\w+),\s*(\w+)\)", m.group(1)))
    return out


@functools.cache
def dataclass_names() -> dict[str, tuple[str, ...]]:
    """The same groups from the dataclasses, what the packing follows;
    Fabric leaves as `channel_field` (`self_` -> `self`)."""
    hints = typing.get_type_hints(Fabric)
    return {
        "STATE": tuple(f.name for f in dataclasses.fields(RaftState) if f.name != "cfg"),
        "CFG": tuple(f.name for f in dataclasses.fields(LaneConfig)),
        "FABRIC": tuple(
            f"{chan.name.rstrip('_')}_{f.name}"
            for chan in dataclasses.fields(Fabric)
            for f in dataclasses.fields(hints[chan.name])
        ),
        "OPS": tuple(LocalOps._fields),
    }


def _check_layout() -> None:
    table = {g: tuple(name for name, _, _ in rows) for g, rows in layout().items()}
    want = dataclass_names()
    for g in GROUPS:
        if table[g] != want[g]:
            raise RuntimeError(
                f"csrc/round.cu RAFT_{g}_FIELDS differs from the dataclass "
                f"field order: {table[g]} != {want[g]}"
            )


def _state_leaves(state: RaftState):
    return [getattr(state, n) for n in dataclass_names()["STATE"]]


def _cfg_leaves(state: RaftState):
    return [getattr(state.cfg, n) for n in dataclass_names()["CFG"]]


def _fab_leaves(fab: Fabric):
    out = []
    for chan in _FAB_CHANNELS:
        ch = getattr(fab, chan)
        out += [getattr(ch, f.name) for f in dataclasses.fields(ch)]
    return out


def _fab_from_leaves(like: Fabric, leaves) -> Fabric:
    it = iter(leaves)
    chans = {}
    for chan in _FAB_CHANNELS:
        ch = getattr(like, chan)
        chans[chan] = type(ch)(**{f.name: next(it) for f in dataclasses.fields(ch)})
    return Fabric(**chans)


def _state_from_leaves(like: RaftState, leaves) -> RaftState:
    names = dataclass_names()["STATE"]
    return dataclasses.replace(like, **dict(zip(names, leaves)))


def _shape(kind: str, n: int, v: int, d: dict) -> tuple:
    return {
        "LANE": (n,), "PEER": (n, v), "WIN": (n, d["w"]), "INFL": (n, v, d["f"]),
        "READ": (n, d["r"]), "READ_PEER": (n, d["r"], v), "ENT": (n, v, d["e"]),
    }[kind]


def dims_of(state, fab, v: int) -> dict:
    """The Shape of a slim carry: {v, w, e, f, r}."""
    return {"v": v, "w": state.log_term.shape[1], "e": fab.rep.ent_term.shape[2],
            "f": state.infl_index.shape[2], "r": state.ro_ctx.shape[1]}


def shape_name(d: dict) -> str:
    return "Shape(V={v}, W={w}, E={e}, F={f}, R={r})".format(**d)


def check_shape(d: dict) -> None:
    """Raise, naming the dimension, for a Shape the kernel does not take."""
    if not 1 <= d["v"] <= MAX_V:
        raise ValueError(f"the round kernel takes 1 <= V <= {MAX_V}, got V={d['v']}")
    for k, cap in CAPS.items():
        if not 1 <= d[k] <= cap:
            raise ValueError(f"the round kernel takes 1 <= {k} <= {cap}, got {k}={d[k]}")
    if d["w"] & (d["w"] - 1):
        raise ValueError(f"the round kernel takes a power-of-two w, got w={d['w']}")


def stride(cta: int) -> int:
    """csrc/round.cu's compile-time column stride S for blocks of cta
    lanes: cta rounded up to a multiple of 32 (a warp's banks)."""
    return -(-cta // 32) * 32


def target(d: dict, cta: int) -> build.Target:
    """The library of the kernel for Shape d and blocks of cta lanes."""
    return build.Target(
        "round",
        tuple((f"RAFT_{k.upper()}", d[k]) for k in "vwefr") + (("RAFT_S", stride(cta)),),
    )


def smem_bytes(d: dict, cta: int) -> int:
    """Shared memory of one CUDA block of `cta` lanes at Shape d
    (csrc/round.cu Block): with S = stride(cta), the rings (but THROUGH) at
    stride S, two fabric buffers at stride S + 1, two metrics rows; each
    region padded to 16 bytes."""
    v, w, e, f, r = (d[k] for k in "vwefr")
    elems = {"LANE": 1, "PEER": v, "WIN": w, "INFL": v * f, "READ": r,
             "READ_PEER": r * v, "ENT": v * e}
    tab = layout()

    def count(group, kinds, size):
        return sum(elems[k] for name, dt, k in tab[group]
                   if k in kinds and _SIZE[dt] == size and name not in THROUGH)

    def pad(x):
        return -(-x // 16) * 16

    sr = stride(cta)
    sf = sr + 1
    rings = pad(4 * count("STATE", _RINGS, 4) * sr) + pad(count("STATE", _RINGS, 1) * sr)
    fab = pad(4 * count("FABRIC", elems, 4) * sf) + pad(count("FABRIC", elems, 1) * sf)
    return rings + 2 * fab + 2 * pad(4 * PART_USED)


def cta_lanes(tile_lanes: int, v: int, dims: dict | None = None,
              target: int = CTA_TARGET) -> int:
    """Lanes per CUDA block: the largest multiple of v that divides the tile
    and is at most `target` (else the smallest such multiple), at most
    MAX_CTA and, given the Shape `dims`, within MAX_SMEM where one is."""
    cands = [c for c in range(v, min(tile_lanes, MAX_CTA) + 1, v) if tile_lanes % c == 0]
    if not cands:
        raise ValueError(f"no CUDA block of <= {MAX_CTA} lanes covers whole groups of "
                         f"tile_lanes={tile_lanes}, v={v}")
    if dims is not None:  # where none fits, pack refuses the launch by name
        cands = [c for c in cands if smem_bytes(dims, c) <= MAX_SMEM] or cands
    small = [c for c in cands if c <= target]
    return max(small) if small else min(cands)


def pack(state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta, apply_ops,
         ops_round0_only, do_tick, auto_propose, auto_compact_lag):
    """Check every leaf and allocate the outputs; returns (pointer list,
    dims, flags, lag, outputs), outputs = (state, fab, sampler, partials)."""
    _check_layout()
    n = state.term.shape[0]
    d = dims_of(state, fab, v)
    check_shape(d)
    if not 1 <= cta <= MAX_CTA or n % v or n % cta or cta % v:
        raise ValueError(f"bad lane layout: n={n}, v={v}, cta={cta}")
    if smem_bytes(d, cta) > MAX_SMEM:
        raise ValueError(f"a CUDA block of cta={cta} lanes at {shape_name(d)} needs "
                         f"{smem_bytes(d, cta)} bytes of shared memory, over {MAX_SMEM}")
    if not 1 <= kc:
        raise ValueError(f"kc must be >= 1, got {kc}")
    dev = state.term.device
    tab = layout()
    groups = {
        "STATE": _state_leaves(state), "CFG": _cfg_leaves(state),
        "FABRIC": _fab_leaves(fab), "OPS": list(ops),
    }
    for g, leaves in groups.items():
        for (name, dt, kind), x in zip(tab[g], leaves):
            _check(f"{g.lower()}.{name}", x, DTYPES[dt], _shape(kind, n, v, d), dev)
            if x.data_ptr() % 16:  # the kernel moves a lane's row in 16-byte accesses
                raise ValueError(f"{g.lower()}.{name} must start 16-byte aligned")
    metrics = sampler is not None
    if mute is not None:
        _check("mute", mute, torch.bool, (n,), dev)
    if metrics:
        for name, x in zip(("samp_index", "samp_round"), sampler):
            _check(name, x, I32, (n,), dev)
        _check("round_ctr", round_ctr, I32, (), dev)

    st_out = [torch.empty_like(x) for x in groups["STATE"]]
    fab_out = [torch.empty_like(x) for x in groups["FABRIC"]]
    samp_out = [torch.empty_like(x) for x in sampler] if metrics else [None, None]
    parts = (
        torch.empty((kc, n // cta, PARTIAL_WIDTH), dtype=I32, device=dev)
        if metrics else None
    )

    def ptr(x):
        return None if x is None else x.data_ptr()

    ptrs = [ptr(x) for x in groups["STATE"] + groups["CFG"] + groups["FABRIC"] + groups["OPS"]]
    ptrs += [ptr(mute)]
    ptrs += [ptr(x) for x in (sampler if metrics else (None, None))]
    ptrs += [ptr(round_ctr if metrics else None)]
    ptrs += [ptr(x) for x in st_out + fab_out + samp_out] + [ptr(parts)]
    flags = (
        (F_MUTE if mute is not None else 0) | (F_METRICS if metrics else 0)
        | (F_TICK if do_tick else 0) | (F_AUTO_PROPOSE if auto_propose else 0)
        | (F_LAG if auto_compact_lag is not None else 0) | (F_OPS if apply_ops else 0)
        | (F_OPS_ROUND0 if ops_round0_only else 0)
    )
    dims = [n, v, d["w"], d["e"], d["f"], d["r"], kc, cta]
    outputs = (
        _state_from_leaves(state, st_out),
        _fab_from_leaves(fab, fab_out),
        tuple(samp_out) if metrics else None,
        parts,
    )
    return ptrs, dims, flags, int(auto_compact_lag or 0), outputs


def as_c_args(ptrs, dims):
    return (_P * len(ptrs))(*ptrs), len(ptrs), (ctypes.c_longlong * len(dims))(*dims)


def round_call(state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta,
               apply_ops=True, ops_round0_only=True, do_tick=True,
               auto_propose=False, auto_compact_lag=None):
    """kc rounds in one launch. state/fab: the slim carry; sampler:
    (samp_index, samp_round) with metrics on, else None; round_ctr: the
    metrics round counter ([] int32 tensor). Returns (state, fab, sampler,
    partials [kc, n / cta, PARTIAL_WIDTH] int32 or None)."""
    kw = dict(v=v, kc=kc, cta=cta, apply_ops=apply_ops, ops_round0_only=ops_round0_only,
              do_tick=do_tick, auto_propose=auto_propose,
              auto_compact_lag=auto_compact_lag)
    if state.term.device.type == "cpu":
        from raft_tpu_torch.ops.pallas_round import round_kernel_ref

        return round_kernel_ref(state, fab, ops, mute, sampler, round_ctr, **kw)
    ptrs, dims, flags, lag, outputs = pack(state, fab, ops, mute, sampler, round_ctr, **kw)
    t = library(dims_of(state, fab, v), cta)
    arr, nptr, cdims = as_c_args(ptrs, dims)
    KERNELS["round_kernel"].launch(state.term.device, arr, nptr, cdims, flags, lag, target=t)
    return outputs


def library(d: dict, cta: int) -> build.Target:
    """Build (once) the kernel for Shape d and blocks of cta lanes; raises
    naming the Shape when its library does not build. Returns the build
    target."""
    t = target(d, cta)
    try:
        KERNELS["round_kernel"].fn(t)
    except RuntimeError as e:
        raise RuntimeError(f"round_kernel for {shape_name(d)} did not build: {e}") from e
    return t
