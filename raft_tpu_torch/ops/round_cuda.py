"""Wrapper of the round megakernel (csrc/round.cu `round_kernel`).

`round_call` runs `kc` fused rounds over every lane in one launch. For
tensors on the CPU, and only then, it runs the kernel's plain PyTorch
version (ops/pallas_round.py `round_kernel_ref`); for tensors on the card it
checks every leaf's device, dtype, shape and contiguity, launches the kernel
on the current stream, and raises on anything the kernel does not take or on
a refused launch. There is no fallback from the card to the plain version.
The launches are counted in `KERNELS["round_kernel"].launches`, those of
the diet-v2 build (a packed carry, state.is_packed) in
`KERNELS["round_kernel_diet"].launches`, and those of the paged builds (a
`paged=` sidecar: in-kernel paging) in `round_kernel_paged` and
`round_kernel_paged_diet`, and those of the chaos builds (a `chaos=`
ChaosState) in `round_kernel_chaos` and `round_kernel_chaos_diet`.

| kernel                  | replaces (raft_tpu/ops/pallas_round.py)            |
| round_kernel            | make_call(kc).kernel :564, pl.pallas_call :745     |
| round_kernel_diet       | the same, its packed-carry branch :599-603,        |
|                         | :655-660, :707-710                                 |
| round_kernel_paged      | the same, its in-kernel paging branch :589-597,    |
|                         | :711-725                                           |
| round_kernel_paged_diet | the paging branch on the packed carry              |
| round_kernel_chaos      | the same, its chaos branch :616-634, :670-700,     |
|                         | :728-730 (fold :826-834)                           |
| round_kernel_chaos_diet | the chaos branch on the packed carry               |

The argument packing is generated from the dataclass field order of
RaftState, LaneConfig, Fabric and LocalOps. csrc/round.cu carries the same
order, with each leaf's storage dtype and shape, as X-macro tables, and
beside them the diet-v2 tables of the leaves whose packed storage differs;
`layout(diet)` parses them, and every launch checks that the two agree.

The kernel is compiled for one Shape (V, W, E, F, R as -D macros), one
column stride S of its shared memory (`stride(cta)`) and one carry layout
(slim, or diet-v2 packed with -DRAFT_DIET=1): the first launch at a Shape,
block size and layout builds its library (`target`), and a Shape the
kernel does not take, or a library that does not build, raises naming the
Shape. A packed carry never runs the slim build. `smem_bytes` is
csrc/round.cu's Block: the shared memory a CUDA block takes (the same in
the slim and diet builds; the paged builds add one row of warp totals),
which bounds its lane count (`cta_lanes`).

Paged (ops/paged.py, `paged=` given): the paged build (-DRAFT_PAGED=1 with
the plan's RAFT_WRES, RAFT_PE, RAFT_M) takes the resident [N, W_res] log
rows and the PagedLog leaves, in and out; a CUDA block is one allocation
segment, so the block is the engine's lane tile and the pool's rows per
block are a runtime dimension.

Chaos (chaos/device.py, `chaos=` given): the chaos build (-DRAFT_CHAOS=1)
takes seven knob columns (RAFT_CHAOS_KNOBS), three probe columns in and
out (RAFT_CHAOS_PROBES) and the scalars round, heal_round and seed (the
ChaosState's own 0-d tensors), after the table's other pointers; the partials row is written with
metrics or chaos on. Chaos with paging is refused (NotImplementedError).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import typing

import torch

from raft_tpu_torch import build
from raft_tpu_torch.chaos import device as chmod
from raft_tpu_torch.ops.fused import CHAOS_PAGED, Fabric, LocalOps
from raft_tpu_torch.ops.paged import LEAVES, LOG_COLS
from raft_tpu_torch.ops.quorum_cuda import Kernel, _check
from raft_tpu_torch.state import LaneConfig, RaftState, is_packed

I32 = torch.int32
MAX_V = 8  # csrc/round.cu takes V = 1..8 ...
CAPS = {"w": 64, "e": 8, "f": 8, "r": 8}  # ... and W, E, F, R up to these
MAX_CTA = 256  # csrc/round.cu kMaxCta
CTA_TARGET = 96  # lanes per CUDA block the engine aims for (PERF.md, PR 3)
MAX_SMEM = 232_448  # shared memory one block can use on the H100 (227 KB)
PARTIAL_WIDTH = 128  # csrc/round.cu kPartialWidth
PART_USED = 25  # csrc/round.cu kPartUsed
CHAOS_PART = 2  # csrc/round.cu kChaosPart: the recount slots of the chaos build

_P = ctypes.c_void_p
_ROUND_ARGS = [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P]
KERNELS = {
    name: Kernel(name, "raft_round", _ROUND_ARGS, lib="round")
    for name in ("round_kernel", "round_kernel_diet", "round_kernel_paged",
                 "round_kernel_paged_diet", "round_kernel_chaos", "round_kernel_chaos_diet")
}
_SIZE = {"I32": 4, "U32": 4, "I16": 2, "I8": 1, "BOOL": 1, "U16": 2, "U8": 1}
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
    "BOOL": torch.bool, "U32": torch.uint32, "U16": torch.uint16, "U8": torch.uint8,
}
GROUPS = ("STATE", "CFG", "FABRIC", "OPS")
# under paging the log leaves are [N, W_res] rows, and the PagedLog leaves
# (csrc/round.cu PG_*) close the pointer table
LOG_LEAVES, PAGED_LEAVES = LOG_COLS, LEAVES
_FAB_CHANNELS = tuple(f.name for f in dataclasses.fields(Fabric))


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _table(text: str, name: str) -> tuple[tuple[str, str, str], ...]:
    m = re.search(rf"#define {name}\(X\)(.*?)\n\n", text, re.S)
    if m is None:
        raise RuntimeError(f"csrc/round.cu has no {name} table")
    return tuple(re.findall(r"X\((\w+),\s*(\w+),\s*(\w+)\)", m.group(1)))


@functools.cache
def diet_rows() -> dict[str, tuple[tuple[str, str, str], ...]]:
    """csrc/round.cu's diet-v2 tables: group -> ((name, packed dtype, packed
    shape), ...) of the leaves whose storage the packed carry changes."""
    text = (build.CSRC / "round.cu").read_text()
    return {g: _table(text, f"RAFT_{g}_DIET") if g != "OPS" else () for g in GROUPS}


@functools.cache
def layout(diet: bool = False) -> dict[str, tuple[tuple[str, str, str], ...]]:
    """The leaf tables of csrc/round.cu: group -> ((name, dtype, shape), ...)
    in table order, as the slim carry stores them, or with diet as the
    diet-v2 packed carry does."""
    text = (build.CSRC / "round.cu").read_text()
    out = {g: _table(text, f"RAFT_{g}_FIELDS") for g in GROUPS}
    if diet:
        for g, rows in diet_rows().items():
            packed = {row[0]: row for row in rows}
            out[g] = tuple(packed.get(row[0], row) for row in out[g])
    return out


@functools.cache
def chaos_rows() -> dict[str, tuple[tuple[str, str, str], ...]]:
    """csrc/round.cu's chaos tables: KNOBS and PROBES -> ((name, dtype,
    shape), ...) in pointer order."""
    text = (build.CSRC / "round.cu").read_text()
    return {g: _table(text, f"RAFT_CHAOS_{g}") for g in ("KNOBS", "PROBES")}


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
    """Both tables of csrc/round.cu against the dataclasses: the slim
    tables in field order, and each diet table naming leaves of its group
    in that order."""
    table = {g: tuple(name for name, _, _ in rows) for g, rows in layout().items()}
    want = dataclass_names()
    for g in GROUPS:
        if table[g] != want[g]:
            raise RuntimeError(
                f"csrc/round.cu RAFT_{g}_FIELDS differs from the dataclass "
                f"field order: {table[g]} != {want[g]}"
            )
        packed = tuple(name for name, _, _ in diet_rows()[g])
        if packed != tuple(name for name in want[g] if name in packed):
            raise RuntimeError(
                f"csrc/round.cu RAFT_{g}_DIET names leaves that are not "
                f"{g} leaves in field order: {packed}"
            )
    for g, names in (("KNOBS", chmod.KNOBS), ("PROBES", chmod.PROBES)):
        rows = chaos_rows()[g]
        if tuple(name for name, _, _ in rows) != names or any(dt != "I32" for _, dt, _ in rows):
            raise RuntimeError(
                f"csrc/round.cu RAFT_CHAOS_{g} differs from chaos/device.py {g}: {rows}"
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


def dims_of(state, fab, v: int, paged=None) -> dict:
    """The Shape of a carry: {v, w, e, f, r} (w the full window, also when
    `paged` holds the carry's pages)."""
    w = paged.w if paged is not None else state.log_term.shape[1]
    return {"v": v, "w": w, "e": fab.rep.ent_term.shape[2],
            "f": state.infl_index.shape[2], "r": state.ro_ctx.shape[1]}


def paged_plan(paged) -> tuple[int, int, int]:
    """(W_res, PE, M) of a PagedLog: the paged build's geometry."""
    return paged.w_res, paged.pool_term.shape[1], paged.pt.shape[1]


def kernel_name(diet: bool, paged: bool, chaos: bool = False) -> str:
    return ("round_kernel" + ("_paged" if paged else "") + ("_chaos" if chaos else "")
            + ("_diet" if diet else ""))


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


def target(d: dict, cta: int, diet: bool = False, plan=None, chaos: bool = False
           ) -> build.Target:
    """The library of the kernel for Shape d and blocks of cta lanes, of
    the diet-v2 build (-DRAFT_DIET=1) with diet, of the paged build with
    plan = (W_res, PE, M), and of the chaos build (-DRAFT_CHAOS=1) with
    chaos."""
    paged = ()
    if plan is not None:
        if chaos:
            raise NotImplementedError(CHAOS_PAGED)
        paged = (("RAFT_PAGED", 1),) + tuple(zip(("RAFT_WRES", "RAFT_PE", "RAFT_M"), plan))
    return build.Target(
        "round",
        tuple((f"RAFT_{k.upper()}", d[k]) for k in "vwefr") + (("RAFT_S", stride(cta)),)
        + ((("RAFT_DIET", 1),) if diet else ()) + paged
        + ((("RAFT_CHAOS", 1),) if chaos else ()),
    )


def smem_bytes(d: dict, cta: int, paged: bool = False, chaos: bool = False) -> int:
    """Shared memory of one CUDA block of `cta` lanes at Shape d
    (csrc/round.cu Block): with S = stride(cta), the rings (but THROUGH) at
    stride S, two fabric buffers at stride S + 1, two partials rows (with
    the chaos build's two recount slots), in the paged build one row of
    warp totals, and in the chaos build one probe-flag byte a lane; each
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
    acc = pad(4 * (PART_USED + (CHAOS_PART if chaos else 0)))
    return (rings + 2 * fab + 2 * acc + (pad(4 * (MAX_CTA // 32)) if paged else 0)
            + (pad(sr) if chaos else 0))


def cta_lanes(tile_lanes: int, v: int, dims: dict | None = None,
              target: int = CTA_TARGET, chaos: bool = False) -> int:
    """Lanes per CUDA block: the largest multiple of v that divides the tile
    and is at most `target` (else the smallest such multiple), at most
    MAX_CTA and, given the Shape `dims`, within MAX_SMEM (of the chaos
    build with chaos) where one is."""
    cands = [c for c in range(v, min(tile_lanes, MAX_CTA) + 1, v) if tile_lanes % c == 0]
    if not cands:
        raise ValueError(f"no CUDA block of <= {MAX_CTA} lanes covers whole groups of "
                         f"tile_lanes={tile_lanes}, v={v}")
    if dims is not None:  # where none fits, pack refuses the launch by name
        cands = [c for c in cands if smem_bytes(dims, c, chaos=chaos) <= MAX_SMEM] or cands
    small = [c for c in cands if c <= target]
    return max(small) if small else min(cands)


def pack(state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta, apply_ops,
         ops_round0_only, do_tick, auto_propose, auto_compact_lag, paged=None, chaos=None):
    """Check every leaf and allocate the outputs; returns (pointer list,
    dims, flags, lag, outputs), outputs = (state, fab, sampler, partials)
    and, given `paged`, the PagedLog out, given `chaos`, the probe columns
    out."""
    _check_layout()
    if chaos is not None and paged is not None:
        raise NotImplementedError(CHAOS_PAGED)
    n = state.term.shape[0]
    d = dims_of(state, fab, v, paged)
    check_shape(d)
    if not 1 <= cta <= MAX_CTA or n % v or n % cta or cta % v:
        raise ValueError(f"bad lane layout: n={n}, v={v}, cta={cta}")
    smem = smem_bytes(d, cta, paged is not None, chaos is not None)
    if smem > MAX_SMEM:
        raise ValueError(f"a CUDA block of cta={cta} lanes at {shape_name(d)} needs "
                         f"{smem} bytes of shared memory, over {MAX_SMEM}")
    if not 1 <= kc:
        raise ValueError(f"kc must be >= 1, got {kc}")
    dev = state.term.device
    tab = layout(is_packed(state))
    groups = {
        "STATE": _state_leaves(state), "CFG": _cfg_leaves(state),
        "FABRIC": _fab_leaves(fab), "OPS": list(ops),
    }
    for g, leaves in groups.items():
        for (name, dt, kind), x in zip(tab[g], leaves):
            shape = _shape(kind, n, v, d)
            if paged is not None and g == "STATE" and name in LOG_LEAVES:
                shape = (n, paged.w_res)
            _check(f"{g.lower()}.{name}", x, DTYPES[dt], shape, dev)
            if x.data_ptr() % 16:  # the kernel moves a lane's row in 16-byte accesses
                raise ValueError(f"{g.lower()}.{name} must start 16-byte aligned")
    pool_rows = 0
    pg_in = [None] * len(PAGED_LEAVES)
    if paged is not None:
        w_res, pe, m = paged_plan(paged)
        p = paged.pool_term.shape[0]
        if p % (n // cta):
            raise ValueError(f"pool_pages={p} does not split over {n // cta} CUDA blocks")
        pool_rows = p // (n // cta)
        pg_in = [getattr(paged, k) for k in PAGED_LEAVES]
        want = {"pt": (torch.uint16, (n, m))}
        for col, pool in zip(LOG_LEAVES, PAGED_LEAVES[1:4]):
            want[pool] = (getattr(state, col).dtype, (p, pe))
        for k in PAGED_LEAVES[4:]:
            want[k] = (I32, (n,))
        for k, x in zip(PAGED_LEAVES, pg_in):
            _check(f"paged.{k}", x, *want[k], dev)
            if x.data_ptr() % 16:
                raise ValueError(f"paged.{k} must start 16-byte aligned")
    metrics = sampler is not None
    if mute is not None:
        _check("mute", mute, torch.bool, (n,), dev)
    if metrics:
        for name, x in zip(("samp_index", "samp_round"), sampler):
            _check(name, x, I32, (n,), dev)
        _check("round_ctr", round_ctr, I32, (), dev)
    ch_in = []
    if chaos is not None:
        for g in ("KNOBS", "PROBES"):
            for name, _, kind in chaos_rows()[g]:
                x = getattr(chaos, name)
                _check(f"chaos.{name}", x, I32, _shape(kind, n, v, d), dev)
                ch_in.append(x)
        for name, dt in (("round", I32), ("heal_round", I32), ("seed", torch.uint32)):
            x = getattr(chaos, name)
            _check(f"chaos.{name}", x, dt, (), dev)
            ch_in.append(x)

    st_out = [torch.empty_like(x) for x in groups["STATE"]]
    fab_out = [torch.empty_like(x) for x in groups["FABRIC"]]
    samp_out = [torch.empty_like(x) for x in sampler] if metrics else [None, None]
    parts = (
        torch.empty((kc, n // cta, PARTIAL_WIDTH), dtype=I32, device=dev)
        if metrics or chaos is not None else None
    )

    def ptr(x):
        return None if x is None else x.data_ptr()

    ptrs = [ptr(x) for x in groups["STATE"] + groups["CFG"] + groups["FABRIC"] + groups["OPS"]]
    ptrs += [ptr(mute)]
    ptrs += [ptr(x) for x in (sampler if metrics else (None, None))]
    ptrs += [ptr(round_ctr if metrics else None)]
    ptrs += [ptr(x) for x in st_out + fab_out + samp_out] + [ptr(parts)]
    pg_out = [None if x is None else torch.empty_like(x) for x in pg_in]
    ptrs += [ptr(x) for x in pg_in + pg_out]
    probe_out = []
    if chaos is not None:  # the chaos build's pointers close the table
        probe_out = [torch.empty_like(getattr(chaos, p)) for p in chmod.PROBES]
        ptrs += [ptr(x) for x in ch_in + probe_out]
    flags = (
        (F_MUTE if mute is not None else 0) | (F_METRICS if metrics else 0)
        | (F_TICK if do_tick else 0) | (F_AUTO_PROPOSE if auto_propose else 0)
        | (F_LAG if auto_compact_lag is not None else 0) | (F_OPS if apply_ops else 0)
        | (F_OPS_ROUND0 if ops_round0_only else 0)
    )
    dims = [n, v, d["w"], d["e"], d["f"], d["r"], kc, cta, pool_rows]
    outputs = (
        _state_from_leaves(state, st_out),
        _fab_from_leaves(fab, fab_out),
        tuple(samp_out) if metrics else None,
        parts,
    )
    if paged is not None:
        outputs += (dataclasses.replace(paged, **dict(zip(PAGED_LEAVES, pg_out))),)
    if chaos is not None:
        outputs += (tuple(probe_out),)
    return ptrs, dims, flags, int(auto_compact_lag or 0), outputs


def as_c_args(ptrs, dims):
    return (_P * len(ptrs))(*ptrs), len(ptrs), (ctypes.c_longlong * len(dims))(*dims)


def round_call(state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta,
               apply_ops=True, ops_round0_only=True, do_tick=True,
               auto_propose=False, auto_compact_lag=None, paged=None, chaos=None):
    """kc rounds in one launch. state/fab: the slim carry, or the diet-v2
    packed carry (the diet build of the kernel runs it); sampler:
    (samp_index, samp_round) with metrics on, else None; round_ctr: the
    metrics round counter ([] int32 tensor); paged: the PagedLog of a paged
    carry (the state's log leaves its resident tails): each block of cta
    lanes pages in, runs the rounds and pages out over its own sub-pool;
    chaos: the ChaosState (chaos/device.py) whose faults the rounds apply,
    from its round, heal_round and seed. Returns (state, fab, sampler,
    partials [kc, n / cta, PARTIAL_WIDTH] int32 or None), then the
    PagedLog when paged, or the probe columns (chaos.PROBES) when chaos."""
    kw = dict(v=v, kc=kc, cta=cta, apply_ops=apply_ops, ops_round0_only=ops_round0_only,
              do_tick=do_tick, auto_propose=auto_propose,
              auto_compact_lag=auto_compact_lag, paged=paged, chaos=chaos)
    if state.term.device.type == "cpu":
        from raft_tpu_torch.ops.pallas_round import round_kernel_ref

        return round_kernel_ref(state, fab, ops, mute, sampler, round_ctr, **kw)
    ptrs, dims, flags, lag, outputs = pack(state, fab, ops, mute, sampler, round_ctr, **kw)
    diet = is_packed(state)
    plan = paged_plan(paged) if paged is not None else None
    t = library(dims_of(state, fab, v, paged), cta, diet, plan, chaos is not None)
    arr, nptr, cdims = as_c_args(ptrs, dims)
    kernel = KERNELS[kernel_name(diet, paged is not None, chaos is not None)]
    kernel.launch(state.term.device, arr, nptr, cdims, flags, lag, target=t)
    return outputs


def library(d: dict, cta: int, diet: bool = False, plan=None, chaos: bool = False
            ) -> build.Target:
    """Build (once) the kernel for Shape d and blocks of cta lanes (the
    diet-v2 build with diet, the paged build with plan = (W_res, PE, M),
    the chaos build with chaos); raises naming the Shape when its library
    does not build. Returns the build target."""
    t = target(d, cta, diet, plan, chaos)
    name = kernel_name(diet, plan is not None, chaos)
    try:
        KERNELS[name].fn(t)
    except RuntimeError as e:
        raise RuntimeError(f"{name} for {shape_name(d)} did not build: {e}") from e
    return t
