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
MAX_V = 8  # the kernel instantiates V = 1..8
MAX_CTA = 256  # csrc/round.cu kMaxCta
PARTIAL_WIDTH = 128  # csrc/round.cu kPartialWidth
CAPS = {"w": 64, "e": 8, "f": 8, "r": 8}  # csrc/round.cu kMaxW/E/F/R

_P = ctypes.c_void_p
KERNELS = {
    "round_kernel": Kernel(
        "round_kernel", "raft_round",
        [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P], lib="round",
    )
}

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


def cta_lanes(tile_lanes: int, v: int, target: int = 192) -> int:
    """Lanes per CUDA block: the largest multiple of v that divides the tile
    and is at most `target` (else the smallest such multiple, at most
    MAX_CTA)."""
    cands = [c for c in range(v, min(tile_lanes, MAX_CTA) + 1, v) if tile_lanes % c == 0]
    if not cands:
        raise ValueError(f"no CUDA block of <= {MAX_CTA} lanes covers whole groups of "
                         f"tile_lanes={tile_lanes}, v={v}")
    small = [c for c in cands if c <= target]
    return max(small) if small else min(cands)


def pack(state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta, apply_ops,
         ops_round0_only, do_tick, auto_propose, auto_compact_lag):
    """Check every leaf and allocate the outputs; returns (pointer list,
    dims, flags, lag, outputs, scratch), outputs = (state, fab, sampler,
    partials). The caller holds `scratch` (the ping-pong fabric) until the
    launch is enqueued."""
    _check_layout()
    n = state.term.shape[0]
    d = {"w": state.log_term.shape[1], "e": fab.rep.ent_term.shape[2],
         "f": state.infl_index.shape[2], "r": state.ro_ctx.shape[1]}
    if not 1 <= v <= MAX_V:
        raise ValueError(f"the round kernel takes 1 <= V <= {MAX_V}, got V={v}")
    for k, cap in CAPS.items():
        if d[k] > cap:
            raise ValueError(f"the round kernel takes {k} <= {cap}, got {d[k]}")
    if n % v or n % cta or cta % v or not 1 <= cta <= MAX_CTA:
        raise ValueError(f"bad lane layout: n={n}, v={v}, cta={cta}")
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
    metrics = sampler is not None
    if mute is not None:
        _check("mute", mute, torch.bool, (n,), dev)
    if metrics:
        for name, x in zip(("samp_index", "samp_round"), sampler):
            _check(name, x, I32, (n,), dev)
        _check("round_ctr", round_ctr, I32, (), dev)

    st_out = [torch.empty_like(x) for x in groups["STATE"]]
    fab_out = [torch.empty_like(x) for x in groups["FABRIC"]]
    fab_scr = [torch.empty_like(x) for x in groups["FABRIC"]] if kc > 1 else [None] * len(fab_out)
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
    ptrs += [ptr(x) for x in st_out + fab_out + fab_scr + samp_out] + [ptr(parts)]
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
    return ptrs, dims, flags, int(auto_compact_lag or 0), outputs, fab_scr


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
    ptrs, dims, flags, lag, outputs, scratch = pack(
        state, fab, ops, mute, sampler, round_ctr, **kw
    )
    arr, nptr, cdims = as_c_args(ptrs, dims)
    KERNELS["round_kernel"].launch(state.term.device, arr, nptr, cdims, flags, lag)
    del scratch  # stream-ordered: the allocator reuses it only after the launch
    return outputs
