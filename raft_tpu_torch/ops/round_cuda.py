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
`round_kernel_paged_diet`, those of the chaos builds (a `chaos=`
ChaosState) in `round_kernel_chaos` and `round_kernel_chaos_diet`, and
those of the builds with both in `round_kernel_chaos_paged` and
`round_kernel_chaos_paged_diet`, and those of each build's lease twin (a
state with the lease columns) in `round_kernel_lease*`
(`round_kernel_lease_chaos_paged_diet` with every flag).

| kernel                        | replaces (raft_tpu/ops/pallas_round.py)      |
| round_kernel                  | make_call(kc).kernel :564, pl.pallas_call    |
|                               | :745                                         |
| round_kernel_diet             | the same, its packed-carry branch :599-603,  |
|                               | :655-660, :707-710                           |
| round_kernel_paged            | the same, its in-kernel paging branch        |
|                               | :589-597, :711-725                           |
| round_kernel_paged_diet       | the paging branch on the packed carry        |
| round_kernel_chaos            | the same, its chaos branch :616-634,         |
|                               | :670-700, :728-730 (fold :826-834)           |
| round_kernel_chaos_diet       | the chaos branch on the packed carry         |
| round_kernel_chaos_paged      | the chaos branch composed with in-kernel     |
|                               | paging, :589-730                             |
| round_kernel_chaos_paged_diet | the same on the packed carry                 |
| round_kernel_lease*           | each build above with its lease branch: the  |
|                               | lease leaves of the carry :486 and           |
|                               | fused_round's lease tail (raft_tpu/ops/      |
|                               | fused.py:1470-1497, run from :676)           |

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
rows and the PagedLog leaves, in and out. An allocation segment is the
engine's lane tile (`seg_lanes`), `seg_lanes / cta` CUDA blocks that meet
at a barrier in device memory before they page out; the pool's rows per
segment, the blocks per segment and the launch's epoch are runtime
dimensions, and the barrier's scratch (`Segments`: a ticket counter and a
word a block) is the caller's, kept across launches. The blocks of a
segment must all fit the card at once (`resident_blocks`).

Chaos (chaos/device.py, `chaos=` given): the chaos build (-DRAFT_CHAOS=1)
takes seven knob columns (RAFT_CHAOS_KNOBS), three probe columns in and
out (RAFT_CHAOS_PROBES) and the scalars round, heal_round and seed (the
ChaosState's own 0-d tensors), after the table's other pointers; the
partials row is written with metrics or chaos on. With paging too, the
build takes both (-DRAFT_CHAOS=1 -DRAFT_PAGED=1), the paged pointers
first.

Lease (ops/lease.py, a state whose lease columns are set): the lease build
(-DRAFT_LEASE=1, with any of the flags above) takes the seven lease
columns (RAFT_LEASE_FIELDS, uint16 for the three of RAFT_LEASE_DIET in a
diet build) in and then out, after every other pointer, and the margin as
the twelfth dimension, so one build serves every margin.

Stamps (a measuring build, -DRAFT_STAMPS=1 beside any flags; `target(...,
stamps=True)`, `pack(..., stamps=)`): the same kernel with thread 0 of each
block recording where its launch goes into one int64 row a block
([blocks, stamp_slots() + kc], the table's last pointer), laid out as the
ST_* and LAP_* enums of csrc/round.cu (`stamp_fields`). The engine never
builds or launches it; chip_smoke.py reads it.
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
from raft_tpu_torch.ops.fused import Fabric, LocalOps
from raft_tpu_torch.ops.lease import LEASE_PACK_U16, LEASE_STATE_FIELDS
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
MAX_CHAOS_ROUNDS = 64  # csrc/round.cu kMaxChaosRounds: rounds a chaos launch takes
SCAN_SLOTS = MAX_CTA // 32 + 4  # csrc/round.cu kScanSlots: warp totals, id, segment
# csrc/round.cu kStage - V: a lane's staging ints of its held writes beside
# the vote responses' V terms
STAGE_INTS = 4

_P = ctypes.c_void_p
_ROUND_ARGS = [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P]
_BASE_NAMES = ("round_kernel", "round_kernel_diet", "round_kernel_paged",
               "round_kernel_paged_diet", "round_kernel_chaos", "round_kernel_chaos_diet",
               "round_kernel_chaos_paged", "round_kernel_chaos_paged_diet")
KERNELS = {
    name: Kernel(name, "raft_round", _ROUND_ARGS, lib="round")
    for name in _BASE_NAMES + tuple(n.replace("round_kernel", "round_kernel_lease", 1)
                                    for n in _BASE_NAMES)
}
MAX_MARGIN = 1 << 20  # csrc/round.cu kMaxMargin
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


@functools.cache
def stamp_fields() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """csrc/round.cu's stamp row: the ST_* slot names in order, and the
    LAP_* lap names (each lap a (sum, max) pair of slots after them)."""
    text = (build.CSRC / "round.cu").read_text()
    st = re.search(r"enum : int \{\s*(ST_GT_START = 0,.*?)\};", text, re.S)
    lap = re.search(r"enum : int \{ (LAP_\w+,.*?)kLaps \};", text, re.S)
    if st is None or lap is None:
        raise RuntimeError("csrc/round.cu has no stamp slot or lap enum")
    return (tuple(re.findall(r"ST_(\w+)", st.group(1)))[:-1],
            tuple(re.findall(r"LAP_(\w+)", lap.group(1))))


def stamp_slots() -> int:
    """The fixed slots of a stamp row (csrc/round.cu kStampSlots): the
    ST_* slots and two a lap; round k's stamp follows at stamp_slots() + k."""
    st, laps = stamp_fields()
    return len(st) + 2 * len(laps)


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
def lease_rows(diet: bool = False) -> tuple[tuple[str, str, str], ...]:
    """csrc/round.cu's lease columns ((name, dtype, shape), ...) in pointer
    order, as the slim carry stores them, or with diet as the diet-v2
    packed carry does."""
    text = (build.CSRC / "round.cu").read_text()
    rows = _table(text, "RAFT_LEASE_FIELDS")
    if diet:
        packed = {row[0]: row for row in _table(text, "RAFT_LEASE_DIET")}
        rows = tuple(packed.get(row[0], row) for row in rows)
    return rows


@functools.cache
def dataclass_names() -> dict[str, tuple[str, ...]]:
    """The same groups from the dataclasses, what the packing follows;
    Fabric leaves as `channel_field` (`self_` -> `self`)."""
    hints = typing.get_type_hints(Fabric)
    return {
        "STATE": tuple(f.name for f in dataclasses.fields(RaftState)
                       if f.name != "cfg" and f.name not in LEASE_STATE_FIELDS),
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
    fields = [f.name for f in dataclasses.fields(RaftState)]
    after_cfg = tuple(fields[fields.index("cfg") + 1:])
    for diet, packed in ((False, ()), (True, LEASE_PACK_U16)):
        rows = lease_rows(diet)
        want = tuple((name, "U16" if name in packed else "I32", "LANE") for name in after_cfg)
        if rows != want:
            raise RuntimeError(
                f"csrc/round.cu RAFT_LEASE_FIELDS (diet={diet}) differs from RaftState's "
                f"lease columns: {rows} != {want}"
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


def kernel_name(diet: bool, paged: bool, chaos: bool = False, lease: bool = False) -> str:
    return ("round_kernel" + ("_lease" if lease else "") + ("_chaos" if chaos else "")
            + ("_paged" if paged else "") + ("_diet" if diet else ""))


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


def target(d: dict, cta: int, diet: bool = False, plan=None, chaos: bool = False,
           lease: bool = False, stamps: bool = False) -> build.Target:
    """The library of the kernel for Shape d and blocks of cta lanes, of
    the diet-v2 build (-DRAFT_DIET=1) with diet, of the paged build with
    plan = (W_res, PE, M), of the chaos build (-DRAFT_CHAOS=1) with chaos,
    of the lease build (-DRAFT_LEASE=1) with lease, and its measuring twin
    (-DRAFT_STAMPS=1) with stamps."""
    paged = ()
    if plan is not None:
        paged = (("RAFT_PAGED", 1),) + tuple(zip(("RAFT_WRES", "RAFT_PE", "RAFT_M"), plan))
    return build.Target(
        "round",
        tuple((f"RAFT_{k.upper()}", d[k]) for k in "vwefr") + (("RAFT_S", stride(cta)),)
        + ((("RAFT_DIET", 1),) if diet else ()) + paged
        + ((("RAFT_CHAOS", 1),) if chaos else ())
        + ((("RAFT_LEASE", 1),) if lease else ())
        + ((("RAFT_STAMPS", 1),) if stamps else ()),
    )


def smem_bytes(d: dict, cta: int, paged: bool = False, chaos: bool = False) -> int:
    """Shared memory of one CUDA block of `cta` lanes at Shape d
    (csrc/round.cu Block): with S = stride(cta), the rings (but THROUGH) at
    stride S, the one fabric buffer at stride S + 1, the staging columns of
    a round's held outbox writes (STAGE_INTS + v int32 a lane) at stride S,
    two partials rows (with the chaos build's two recount slots), in the
    paged build one row of warp totals and four ints of the segment
    barrier (SCAN_SLOTS), and in the chaos build one probe-flag byte a
    lane, its facts of the launch (a word a lane, the probe's baseline a
    lane, and four scalar ints); each region padded to 16 bytes."""
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
    stage = pad(4 * (STAGE_INTS + v) * sr)
    acc = pad(4 * (PART_USED + (CHAOS_PART if chaos else 0)))
    return (rings + fab + stage + 2 * acc + (pad(4 * SCAN_SLOTS) if paged else 0)
            + (pad(sr) + 2 * pad(4 * sr) + 16 if chaos else 0))


def cta_lanes(tile_lanes: int, v: int, dims: dict | None = None,
              target: int = CTA_TARGET, chaos: bool = False, paged: bool = False) -> int:
    """Lanes per CUDA block: the largest multiple of v that divides the tile
    and is at most `target` (else the smallest such multiple), at most
    MAX_CTA and, given the Shape `dims`, within MAX_SMEM (of the chaos
    build with chaos, of the paged build with paged) where one is."""
    cands = [c for c in range(v, min(tile_lanes, MAX_CTA) + 1, v) if tile_lanes % c == 0]
    if not cands:
        raise ValueError(f"no CUDA block of <= {MAX_CTA} lanes covers whole groups of "
                         f"tile_lanes={tile_lanes}, v={v}")
    if dims is not None:  # where none fits, pack refuses the launch by name
        cands = [c for c in cands
                 if smem_bytes(dims, c, paged=paged, chaos=chaos) <= MAX_SMEM] or cands
    small = [c for c in cands if c <= target]
    return max(small) if small else min(cands)


class Segments:
    """The segment barrier's scratch of the paged builds (csrc/round.cu
    P_SEG): int64 [1 + blocks], the ticket counter and one word a CUDA
    block, zeroed once; and the epoch that tags each launch's words, so
    that nothing is reset between launches. One per cluster (its launches
    run in order on one stream)."""

    def __init__(self, blocks: int, device):
        self.words = torch.zeros((1 + blocks,), dtype=torch.int64, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        """The next launch's epoch: 1..2^32 - 1, never the last one's."""
        self.epoch = self.epoch % 0xFFFFFFFF + 1
        return self.epoch


def occupancy(d: dict, cta: int, diet: bool = False, plan=None, chaos: bool = False,
              device=None, lease: bool = False, stamps: bool = False) -> dict:
    """csrc/round.cu raft_round_info for the library of Shape d and blocks
    of cta lanes (built if needed; with stamps its -DRAFT_STAMPS=1 twin):
    shared memory of a block, resident blocks per SM, registers and local
    (stack) bytes per thread, as the runtime reports them."""
    t = (target(d, cta, diet, plan, chaos, lease, stamps=True) if stamps
         else library(d, cta, diet, plan, chaos, lease))
    fn = build.load(t).raft_round_info
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = fn(cta, out)
    if err:
        raise RuntimeError(f"raft_round_info({cta}) failed: CUDA error {err}")
    return dict(smem_bytes=out[0], blocks_per_sm=out[1], registers=out[2], local_bytes=out[3])


def resident_blocks(d: dict, cta: int, device, diet: bool = False, plan=None,
                    chaos: bool = False, lease: bool = False) -> int:
    """CUDA blocks of cta lanes of the library for Shape d that the card
    holds at once: resident blocks per SM (occupancy) times the SMs."""
    per_sm = occupancy(d, cta, diet, plan, chaos, device, lease)["blocks_per_sm"]
    return int(per_sm) * torch.cuda.get_device_properties(device).multi_processor_count


def pack(state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta, apply_ops,
         ops_round0_only, do_tick, auto_propose, auto_compact_lag, paged=None, chaos=None,
         seg_lanes=None, segments=None, lease_margin=1, stamps=None):
    """Check every leaf and allocate the outputs; returns (pointer list,
    dims, flags, lag, outputs), outputs = (state, fab, sampler, partials)
    and, given `paged`, the PagedLog out, given `chaos`, the probe columns
    out; a state with the lease columns has them out in its `state`.
    seg_lanes: the paged build's allocation segment (default one
    CUDA block); segments: the barrier's scratch (`Segments`), required
    when a segment spans blocks: its owner (the cluster) keeps it across
    launches, so that a launch allocates and zeroes none. lease_margin:
    the lease build's margin (0..MAX_MARGIN). stamps: the stamp build's
    row buffer, int64 [n / cta, stamp_slots() + kc] (only for a launch of
    a -DRAFT_STAMPS=1 library)."""
    _check_layout()
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
    if chaos is not None and kc > MAX_CHAOS_ROUNDS:
        raise ValueError(f"the chaos build takes kc <= {MAX_CHAOS_ROUNDS}, got {kc}")
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
    pool_rows, bps, epoch, seg_words = 0, 1, 0, None
    pg_in = [None] * len(PAGED_LEAVES)
    if paged is not None:
        w_res, pe, m = paged_plan(paged)
        p = paged.pool_term.shape[0]
        seg_lanes = seg_lanes or cta
        if seg_lanes % cta or n % seg_lanes:
            raise ValueError(f"bad segment layout: n={n}, seg_lanes={seg_lanes}, cta={cta}")
        n_segs, bps = n // seg_lanes, seg_lanes // cta
        if p % n_segs:
            raise ValueError(f"pool_pages={p} does not split over {n_segs} allocation segments")
        pool_rows = p // n_segs
        if bps > 1:
            if segments is None:
                raise ValueError(f"a segment of {bps} CUDA blocks needs the barrier's scratch: "
                                 f"pass segments=Segments({n // cta}, device), kept by its owner")
            seg_words = segments.words
            if seg_words.device != dev or seg_words.dtype != torch.int64 or (
                    seg_words.shape[0] < 1 + n // cta):
                raise ValueError(f"segments: int64 [>= {1 + n // cta}] on {dev}, got "
                                 f"{seg_words.dtype} {tuple(seg_words.shape)} on {seg_words.device}")
            epoch = segments.next_epoch()
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
    ptrs += [ptr(x) for x in pg_in + pg_out] + [ptr(seg_words)]
    probe_out = []
    if chaos is not None:  # the chaos build's pointers come next
        probe_out = [torch.empty_like(getattr(chaos, p)) for p in chmod.PROBES]
        ptrs += [ptr(x) for x in ch_in + probe_out]
    lease = state.lease_left is not None
    margin = 0
    if lease:  # the lease build's columns close the table, in then out
        if not 0 <= lease_margin <= MAX_MARGIN:
            raise ValueError(f"lease_margin must be in 0..{MAX_MARGIN}, got {lease_margin}")
        margin = int(lease_margin)
        ls_in = [getattr(state, name) for name in LEASE_STATE_FIELDS]
        for (name, dt, kind), x in zip(lease_rows(is_packed(state)), ls_in):
            _check(f"state.{name}", x, DTYPES[dt], _shape(kind, n, v, d), dev)
        ls_out = [torch.empty_like(x) for x in ls_in]
        ptrs += [ptr(x) for x in ls_in + ls_out]
    if stamps is not None:  # the stamp build's row buffer closes the table
        _check("stamps", stamps, torch.int64, (n // cta, stamp_slots() + kc), dev)
        ptrs += [ptr(stamps)]
    flags = (
        (F_MUTE if mute is not None else 0) | (F_METRICS if metrics else 0)
        | (F_TICK if do_tick else 0) | (F_AUTO_PROPOSE if auto_propose else 0)
        | (F_LAG if auto_compact_lag is not None else 0) | (F_OPS if apply_ops else 0)
        | (F_OPS_ROUND0 if ops_round0_only else 0)
    )
    dims = [n, v, d["w"], d["e"], d["f"], d["r"], kc, cta, pool_rows, bps, epoch, margin]
    st_new = _state_from_leaves(state, st_out)
    if lease:
        st_new = dataclasses.replace(st_new, **dict(zip(LEASE_STATE_FIELDS, ls_out)))
    outputs = (
        st_new,
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
               auto_propose=False, auto_compact_lag=None, paged=None, chaos=None,
               seg_lanes=None, segments=None, lease_margin=1):
    """kc rounds in one launch. state/fab: the slim carry, or the diet-v2
    packed carry (the diet build of the kernel runs it); sampler:
    (samp_index, samp_round) with metrics on, else None; round_ctr: the
    metrics round counter ([] int32 tensor); paged: the PagedLog of a paged
    carry (the state's log leaves its resident tails): each allocation
    segment of seg_lanes lanes (default cta: one CUDA block; `segments`
    the barrier's scratch, required when it spans blocks) pages
    in, runs the rounds and pages out over its own sub-pool; chaos: the
    ChaosState (chaos/device.py) whose faults the rounds apply, from its
    round, heal_round and seed; a state with the lease columns runs the
    lease build with lease_margin. Returns (state, fab, sampler, partials
    [kc, n / cta, PARTIAL_WIDTH] int32 or None), then the PagedLog when
    paged, then the probe columns (chaos.PROBES) when chaos."""
    kw = dict(v=v, kc=kc, cta=cta, apply_ops=apply_ops, ops_round0_only=ops_round0_only,
              do_tick=do_tick, auto_propose=auto_propose,
              auto_compact_lag=auto_compact_lag, paged=paged, chaos=chaos, seg_lanes=seg_lanes,
              lease_margin=lease_margin)
    if state.term.device.type == "cpu":
        from raft_tpu_torch.ops.pallas_round import round_kernel_ref

        return round_kernel_ref(state, fab, ops, mute, sampler, round_ctr, **kw)
    ptrs, dims, flags, lag, outputs = pack(state, fab, ops, mute, sampler, round_ctr,
                                           segments=segments, **kw)
    diet, lease = is_packed(state), state.lease_left is not None
    plan = paged_plan(paged) if paged is not None else None
    t = library(dims_of(state, fab, v, paged), cta, diet, plan, chaos is not None, lease)
    arr, nptr, cdims = as_c_args(ptrs, dims)
    kernel = KERNELS[kernel_name(diet, paged is not None, chaos is not None, lease)]
    kernel.launch(state.term.device, arr, nptr, cdims, flags, lag, target=t)
    return outputs


def library(d: dict, cta: int, diet: bool = False, plan=None, chaos: bool = False,
            lease: bool = False) -> build.Target:
    """Build (once) the kernel for Shape d and blocks of cta lanes (the
    diet-v2 build with diet, the paged build with plan = (W_res, PE, M),
    the chaos build with chaos, the lease build with lease); raises naming
    the Shape when its library does not build. Returns the build target."""
    t = target(d, cta, diet, plan, chaos, lease)
    name = kernel_name(diet, plan is not None, chaos, lease)
    try:
        KERNELS[name].fn(t)
    except RuntimeError as e:
        raise RuntimeError(f"{name} for {shape_name(d)} did not build: {e}") from e
    return t
