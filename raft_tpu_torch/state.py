"""Device-resident batched raft state.

The PyTorch counterpart of `raft_tpu/state.py`: one *lane* is one raft node,
and the reference `raft` struct (raft.go:338-430) is flattened into tensors
batched over the lane axis N — `[N]` per-node scalars, `[N, V]` per-peer
progress, `[N, V, F]` inflight rings and the `[N, W]` circular log window
of (term, type, size) columns.

The dataclasses keep the JAX package's field order and slim storage dtypes
exactly, so one sha256 over the leaves in field order (interop.py) compares
the two packages. Round compute is int32; the narrow dtypes of
`STATE_SLIM` exist only between rounds.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raft_tpu_torch.config import (
    DEFAULT_ELECTION_TICK,
    DEFAULT_HEARTBEAT_TICK,
    DEFAULT_MAX_COMMITTED_SIZE_PER_READY,
    DEFAULT_MAX_SIZE_PER_MSG,
    DEFAULT_MAX_UNCOMMITTED_SIZE,
    Shape,
)
from raft_tpu_torch.types import StateType

I32 = torch.int32
BOOL = torch.bool
U32 = torch.uint32
_MASK32 = 0xFFFFFFFF
_NP = {I32: np.int32, BOOL: np.bool_}


@dataclasses.dataclass
class LaneConfig:
    """Per-lane dynamic tunables — the batched `Config` (reference:
    raft.go:124-286)."""

    election_tick: Any  # [N] i32
    heartbeat_tick: Any  # [N] i32
    max_size_per_msg: Any  # [N] i32, bytes per MsgApp (raft.go:188)
    max_uncommitted_size: Any  # [N] i32 (raft.go:200-204)
    max_committed_size_per_ready: Any  # [N] i32 (raft.go:193-199)
    max_inflight: Any  # [N] i32 in-flight MsgApp count cap (raft.go:211-215)
    max_inflight_bytes: Any  # [N] i32 (raft.go:216-220)
    check_quorum: Any  # [N] bool (raft.go:221-225)
    pre_vote: Any  # [N] bool (raft.go:226-229)
    read_only_lease_based: Any  # [N] bool (raft.go:230-240)
    disable_proposal_forwarding: Any  # [N] bool (raft.go:257-265)
    step_down_on_removal: Any  # [N] bool (raft.go:272-276)
    disable_conf_change_validation: Any  # [N] bool (raft.go:266-271)


@dataclasses.dataclass
class RaftState:
    """The complete batched state machine. All tensors lead with N. Field
    semantics are documented on raft_tpu/state.py RaftState."""

    # --- identity & role (reference: raft.go:338-430) ---
    id: Any  # [N] i32
    term: Any  # [N] i32
    vote: Any  # [N] i32
    state: Any  # [N] StateType
    lead: Any  # [N] i32
    lead_transferee: Any  # [N] i32
    is_learner: Any  # [N] bool
    pending_conf_index: Any  # [N] i32
    uncommitted_size: Any  # [N] i32

    # --- tick machinery (reference: raft.go:400-421, 823-862, 1984-1990) ---
    election_elapsed: Any  # [N]
    heartbeat_elapsed: Any  # [N]
    randomized_election_timeout: Any  # [N]
    rng: Any  # [N] u32 per-lane LCG state

    # --- log window: index i lives in slot i & (W-1) when snap_index < i <= last
    log_term: Any  # [N, W] i32
    log_type: Any  # [N, W] EntryType
    log_bytes: Any  # [N, W] i32
    last: Any  # [N] i32
    stabled: Any  # [N] i32
    committed: Any  # [N] i32
    applying: Any  # [N] i32
    applied: Any  # [N] i32
    snap_index: Any  # [N] i32
    snap_term: Any  # [N] i32
    pending_snap_index: Any  # [N] i32 (0 = none)
    pending_snap_term: Any  # [N] i32
    avail_snap_index: Any  # [N] i32 (0 = none)
    avail_snap_term: Any  # [N] i32
    snap_unavailable: Any  # [N] bool

    # --- membership (reference: tracker/tracker.go:27-78) ---
    prs_id: Any  # [N, V] i32 (0 = empty slot)
    voters_in: Any  # [N, V] bool
    voters_out: Any  # [N, V] bool
    learners: Any  # [N, V] bool
    learners_next: Any  # [N, V] bool
    auto_leave: Any  # [N] bool

    # --- per-peer progress (reference: tracker/progress.go:30-98) ---
    pr_match: Any  # [N, V] i32
    pr_next: Any  # [N, V] i32
    pr_state: Any  # [N, V] ProgressState
    pr_pending_snapshot: Any  # [N, V] i32
    pr_recent_active: Any  # [N, V] bool
    pr_msg_app_flow_paused: Any  # [N, V] bool
    votes: Any  # [N, V] VoteState

    # --- inflights ring (reference: tracker/inflights.go:28-40) ---
    infl_index: Any  # [N, V, F] i32
    infl_bytes: Any  # [N, V, F] i32
    infl_start: Any  # [N, V]
    infl_count: Any  # [N, V]
    infl_total_bytes: Any  # [N, V] i32

    # --- read-only (linearizable read) tracking ---
    ro_ctx: Any  # [N, R] i32 (0 = free slot)
    ro_from: Any  # [N, R] i32
    ro_index: Any  # [N, R] i32
    ro_acks: Any  # [N, R, V] bool
    ro_seq: Any  # [N, R] i32
    ro_next_seq: Any  # [N] i32
    pri_ctx: Any  # [N, R] i32
    pri_from: Any  # [N, R] i32
    rs_ctx: Any  # [N, R] i32
    rs_index: Any  # [N, R] i32
    rs_count: Any  # [N]

    # invariant-violation bits (ops/log.py ERR_*): must stay zero
    error_bits: Any  # [N] i32

    cfg: LaneConfig

    @property
    def first_index(self):
        """reference: log.go firstIndex == snapshot index + 1."""
        return self.snap_index + 1


# Carry diet: narrow storage dtypes for enum/counter fields between rounds
# (raft_tpu/state.py STATE_SLIM). Values round-trip exactly.
STATE_SLIM = {
    "state": torch.int8,
    "votes": torch.int8,
    "pr_state": torch.int8,
    "log_type": torch.int8,
    "election_elapsed": torch.int16,
    "heartbeat_elapsed": torch.int16,
    "randomized_election_timeout": torch.int16,
    "infl_start": torch.int8,
    "infl_count": torch.int8,
    "rs_count": torch.int8,
}


def _cast_fields(obj, dtype_map, widen: bool):
    upd = {}
    for f, dt in dtype_map.items():
        x = getattr(obj, f)
        target = I32 if widen else dt
        if x.dtype != target:
            upd[f] = x.to(target)
    return dataclasses.replace(obj, **upd) if upd else obj


def slim_state(state: RaftState) -> RaftState:
    """Cast the dieted fields to their narrow storage dtypes (idempotent)."""
    return _cast_fields(state, STATE_SLIM, widen=False)


def fat_state(state: RaftState) -> RaftState:
    """Restore all dieted fields to int32 for round compute (idempotent)."""
    return _cast_fields(state, STATE_SLIM, widen=True)


# --------------------------------------------------------------------------
# Byte diet v2 (raft_tpu/state.py:252-455): packed bitsets and narrow
# rebased indexes, a second storage boundary below slim/fat.
#
# `pack_state` narrows the slim layout further for the resident carry and
# `unpack_state` restores it exactly; both are idempotent, and for every
# in-range value unpack_state(pack_state(x)) equals slim_state(x), so diet
# on and off walk one trajectory. Every [N, V] bool mask (and the [N, R, V]
# ro_acks) becomes one bitset word per lane; index and term columns become
# uint16 absolute values in the rebased index space (FusedCluster's
# automatic rebase keeps them under DIET_REBASE_AT); canonical-id columns
# int8; log_bytes int16 under Shape.max_entry_bytes. A value out of its
# packed range clamps and sets ERR_DIET_OVERFLOW in error_bits, which is
# never packed. The JAX lease columns are not in this port's RaftState.

ERR_DIET_OVERFLOW = 64
# the paged entry log's pool ran out at page_out (ops/paged.py): the lane
# keeps its resident tail, its overflow pages read back as absent entries
ERR_PAGE_EXHAUSTED = 128

# inclusive value range of each packed storage dtype
_DIET_RANGE = {
    torch.uint16: (0, (1 << 16) - 1),
    torch.int16: (-(1 << 15), (1 << 15) - 1),
    torch.int8: (-128, 127),
}

# rebased index columns and term columns -> uint16 (the index fields are
# exactly the set ops/log.py rebase_indexes shifts)
PACK_U16 = (
    "term", "snap_term", "pending_snap_term", "avail_snap_term", "log_term",
    "last", "stabled", "committed", "applying", "applied",
    "snap_index", "pending_snap_index", "avail_snap_index",
    "pending_conf_index",
    "pr_match", "pr_next", "pr_pending_snapshot",
    "infl_index", "ro_index", "rs_index",
)
# canonical raft ids 1..V (V <= 32) -> int8
PACK_I8 = ("id", "vote", "lead", "lead_transferee", "prs_id", "ro_from", "pri_from")
# entry payload sizes bounded by Shape.max_entry_bytes -> int16
PACK_I16 = ("log_bytes",)
# bool mask columns -> one bitset word per lane along the trailing V axis
PACK_BITSET = (
    "voters_in", "voters_out", "learners", "learners_next",
    "pr_recent_active", "pr_msg_app_flow_paused", "ro_acks",
)
# LaneConfig columns whose bounds make_lane_config validates
CFG_PACK = {
    "election_tick": torch.int16,
    "heartbeat_tick": torch.int16,
    "max_inflight": torch.int8,
}


def bitset_dtype(v: int):
    """Smallest unsigned word holding v mask bits (Shape caps v at 32)."""
    if v <= 8:
        return torch.uint8
    if v <= 16:
        return torch.uint16
    if v <= 32:
        return torch.uint32
    raise ValueError(f"bitset packing needs v <= 32, got {v}")


def pack_bits(x, dtype):
    """[..., V] bool -> [...] bitset word (bit j = column j)."""
    v = x.shape[-1]
    w = torch.ones((), dtype=torch.int64, device=x.device) << torch.arange(
        v, dtype=torch.int64, device=x.device
    )
    return (x.to(torch.int64) * w).sum(dim=-1).to(dtype)


def unpack_bits(x, v: int):
    """[...] bitset word -> [..., V] bool (exact inverse of pack_bits)."""
    sh = torch.arange(v, dtype=torch.int64, device=x.device)
    return ((x.to(torch.int64)[..., None] >> sh) & 1).to(BOOL)


def is_packed(state: RaftState) -> bool:
    """The diet-v2 layout: its mask columns are [N] bitset words."""
    return state.voters_in.dim() == 1


def pack_state(state: RaftState) -> RaftState:
    """Slim/fat -> diet-v2 packed storage (idempotent). Values outside a
    field's packed range clamp and set ERR_DIET_OVERFLOW on their lane."""
    if is_packed(state):
        return state
    state = slim_state(state)
    bd = bitset_dtype(state.voters_in.shape[-1])
    ovf = torch.zeros(state.term.shape, dtype=BOOL, device=state.term.device)
    upd = {}

    def narrow(name, dt):
        nonlocal ovf
        x = getattr(state, name)
        lo, hi = _DIET_RANGE[dt]
        bad = (x < lo) | (x > hi)
        if bad.dim() > 1:
            bad = bad.flatten(1).any(dim=1)
        ovf = ovf | bad
        upd[name] = torch.clamp(x, lo, hi).to(dt)

    for f in PACK_U16:
        narrow(f, torch.uint16)
    for f in PACK_I8:
        narrow(f, torch.int8)
    for f in PACK_I16:
        narrow(f, torch.int16)
    for f in PACK_BITSET:
        upd[f] = pack_bits(getattr(state, f), bd)
    upd["error_bits"] = state.error_bits | torch.where(ovf, ERR_DIET_OVERFLOW, 0).to(I32)
    # make_lane_config enforces these bounds: the casts are exact
    upd["cfg"] = dataclasses.replace(
        state.cfg, **{k: getattr(state.cfg, k).to(dt) for k, dt in CFG_PACK.items()}
    )
    return dataclasses.replace(state, **upd)


def unpack_state(state: RaftState) -> RaftState:
    """Diet-v2 packed -> the exact slim layout (idempotent). Host readers
    (FusedCluster.host_state) read through this, so every value surfaces
    absolute and in the dtypes of a carry without the diet."""
    if not is_packed(state):
        return state
    v = state.prs_id.shape[-1]  # [N, V] survives packing (dtype only)
    upd = {f: getattr(state, f).to(I32) for f in PACK_U16 + PACK_I8 + PACK_I16}
    for f in PACK_BITSET:
        upd[f] = unpack_bits(getattr(state, f), v)
    upd["cfg"] = dataclasses.replace(
        state.cfg, **{k: getattr(state.cfg, k).to(I32) for k in CFG_PACK}
    )
    return dataclasses.replace(state, **upd)


def make_lane_config(shape: Shape, device, **overrides) -> LaneConfig:
    n = shape.n
    defaults = dict(
        election_tick=(DEFAULT_ELECTION_TICK, I32),
        heartbeat_tick=(DEFAULT_HEARTBEAT_TICK, I32),
        max_size_per_msg=(DEFAULT_MAX_SIZE_PER_MSG, I32),
        max_uncommitted_size=(DEFAULT_MAX_UNCOMMITTED_SIZE, I32),
        max_committed_size_per_ready=(DEFAULT_MAX_COMMITTED_SIZE_PER_READY, I32),
        max_inflight=(shape.max_inflight, I32),
        max_inflight_bytes=(2**30, I32),
        check_quorum=(False, BOOL),
        pre_vote=(False, BOOL),
        read_only_lease_based=(False, BOOL),
        disable_proposal_forwarding=(False, BOOL),
        step_down_on_removal=(False, BOOL),
        disable_conf_change_validation=(False, BOOL),
    )
    unknown = set(overrides) - set(defaults)
    if unknown:
        raise TypeError(f"unknown LaneConfig field(s): {sorted(unknown)}")
    cols = {}
    for k, (val, dt) in defaults.items():
        val = overrides.get(k, val)
        cols[k] = np.broadcast_to(np.asarray(val, _NP[dt]), (n,))
    # the reference's Config.validate (raft.go:288-336) plus the int16/int8
    # slim-carry bounds (raft_tpu/state.py make_lane_config)
    for k in ("election_tick", "heartbeat_tick"):
        if not bool(np.all(cols[k] >= 1)):
            raise ValueError(f"{k} must be >= 1 for every lane")
        if not bool(np.all(cols[k] <= 1 << 14)):
            raise ValueError(f"{k} must be <= 16384 (int16 carry diet)")
    mi = cols["max_inflight"]
    if not bool(np.all((mi >= 1) & (mi <= 127))):
        raise ValueError(
            "max_inflight must be in 1..127 for every lane (int8 carry diet)"
        )
    return LaneConfig(
        **{k: torch.tensor(np.array(x), device=device) for k, x in cols.items()}
    )


def draw_timeout(rng, election_tick):
    """Randomized election timeout in [ET, 2*ET) from the per-lane PRNG
    (reference: raft.go:1984-1990; raft_tpu/state.py draw_timeout). The LCG
    state is uint32 in storage; the arithmetic runs in int64 on the
    zero-extended value, since uint32 shifts are not available on every
    PyTorch device and a signed int32 shift would break the draw."""
    et = election_tick.to(torch.int64)
    r = rng.to(torch.int64) & _MASK32
    return (et + (r >> 16) % et).to(I32)


def rng_next(rng):
    """One step of the per-lane LCG (Numerical Recipes constants), uint32
    in and out, computed modulo 2^32 in int64."""
    r = rng.to(torch.int64) & _MASK32
    return ((r * 1664525 + 1013904223) & _MASK32).to(U32)


def where_u32(mask, new, old):
    """torch.where for uint32 columns, selected in int64."""
    return torch.where(mask, new.to(torch.int64), old.to(torch.int64)).to(U32)


def wipe_volatile(state: RaftState, mask) -> RaftState:
    """Crash-restart the masked lanes in place (raft_tpu/state.py:494-572):
    what the WAL streams (HardState, log metadata, membership, cursors) and
    the snapshot origin survive; every volatile field resets to the
    fresh-boot follower defaults of init_state. The lane's LCG advances one
    step and its election timeout is redrawn from it; error_bits are kept
    (they are the test oracle, not raft state). mask: [N] bool. The JAX
    state's lease fields are not in this port's RaftState."""
    m = mask
    mv = mask[:, None]
    mvf = mask[:, None, None]

    def z(x, mk=m):
        return torch.where(mk, torch.zeros((), dtype=x.dtype, device=x.device), x)

    def full(x, value, mk=m):
        return torch.where(mk, torch.full((), value, dtype=x.dtype, device=x.device), x)

    rng2 = where_u32(m, rng_next(state.rng), state.rng)
    rand2 = torch.where(
        m,
        draw_timeout(rng2, state.cfg.election_tick).to(state.randomized_election_timeout.dtype),
        state.randomized_election_timeout,
    )
    return dataclasses.replace(
        state,
        state=full(state.state, int(StateType.FOLLOWER)),
        lead=z(state.lead),
        lead_transferee=z(state.lead_transferee),
        uncommitted_size=z(state.uncommitted_size),
        election_elapsed=z(state.election_elapsed),
        heartbeat_elapsed=z(state.heartbeat_elapsed),
        randomized_election_timeout=rand2,
        rng=rng2,
        # durability covered everything streamed; applying rejoins applied
        stabled=torch.where(m, state.last, state.stabled),
        applying=torch.where(m, state.applied, state.applying),
        pending_snap_index=z(state.pending_snap_index),
        pending_snap_term=z(state.pending_snap_term),
        snap_unavailable=z(state.snap_unavailable),
        pr_match=z(state.pr_match, mv),
        pr_next=full(state.pr_next, 1, mv),
        pr_state=z(state.pr_state, mv),
        pr_pending_snapshot=z(state.pr_pending_snapshot, mv),
        pr_recent_active=z(state.pr_recent_active, mv),
        pr_msg_app_flow_paused=z(state.pr_msg_app_flow_paused, mv),
        votes=z(state.votes, mv),
        infl_index=z(state.infl_index, mvf),
        infl_bytes=z(state.infl_bytes, mvf),
        infl_start=z(state.infl_start, mv),
        infl_count=z(state.infl_count, mv),
        infl_total_bytes=z(state.infl_total_bytes, mv),
        ro_ctx=z(state.ro_ctx, mv),
        ro_from=z(state.ro_from, mv),
        ro_index=z(state.ro_index, mv),
        ro_acks=z(state.ro_acks, mvf),
        ro_seq=z(state.ro_seq, mv),
        ro_next_seq=full(state.ro_next_seq, 1),
        pri_ctx=z(state.pri_ctx, mv),
        pri_from=z(state.pri_from, mv),
        rs_ctx=z(state.rs_ctx, mv),
        rs_index=z(state.rs_index, mv),
        rs_count=z(state.rs_count),
    )


def init_state(
    shape: Shape,
    ids: np.ndarray,
    peer_ids: np.ndarray,
    peer_is_learner: np.ndarray | None = None,
    seed: int = 1,
    cfg: LaneConfig | None = None,
    *,
    device,
) -> RaftState:
    """Fresh boot state: every lane a term-0 follower with an empty log
    (reference: raft.go:432-477; raft_tpu/state.py init_state).

    ids: [N] this-node raft ids; peer_ids: [N, V] membership, 0-padded, own
    id included; peer_is_learner: [N, V] bool learner mask."""
    n, v, w = shape.n, shape.v, shape.w
    f = shape.max_inflight
    r = shape.max_read_index
    ids = np.asarray(ids, np.int32)
    peer_ids = np.asarray(peer_ids, np.int32)
    if peer_ids.shape != (n, v):
        raise ValueError(f"peer_ids must be [{n},{v}], got {peer_ids.shape}")
    if peer_is_learner is None:
        peer_is_learner = np.zeros((n, v), bool)
    present = peer_ids != 0
    voters_in = present & ~peer_is_learner
    self_slot = peer_ids == ids[:, None]
    own_learner = (peer_is_learner & self_slot).any(axis=1)

    def t(x):
        return torch.tensor(np.ascontiguousarray(x), device=device)

    def zeros(*dims, dtype=I32):
        return torch.zeros((n,) + dims, dtype=dtype, device=device)

    # distinct odd per-lane LCG streams (raft_tpu/state.py init_state)
    rng = np.asarray(
        (
            (seed * 2654435761 + np.arange(n, dtype=np.uint64) * 0x9E3779B9)
            & 0xFFFFFFFF
        )
        | 1,
        np.uint32,
    )
    cfg = cfg if cfg is not None else make_lane_config(shape, device)
    rng_t = t(rng)
    rand_to = draw_timeout(rng_t, cfg.election_tick)

    return RaftState(
        id=t(ids),
        term=zeros(),
        vote=zeros(),
        state=torch.full((n,), int(StateType.FOLLOWER), dtype=I32, device=device),
        lead=zeros(),
        lead_transferee=zeros(),
        is_learner=t(own_learner),
        pending_conf_index=zeros(),
        uncommitted_size=zeros(),
        election_elapsed=zeros(),
        heartbeat_elapsed=zeros(),
        randomized_election_timeout=rand_to,
        rng=rng_t,
        log_term=zeros(w),
        log_type=zeros(w),
        log_bytes=zeros(w),
        last=zeros(),
        stabled=zeros(),
        committed=zeros(),
        applying=zeros(),
        applied=zeros(),
        snap_index=zeros(),
        snap_term=zeros(),
        pending_snap_index=zeros(),
        pending_snap_term=zeros(),
        avail_snap_index=zeros(),
        avail_snap_term=zeros(),
        snap_unavailable=zeros(dtype=BOOL),
        prs_id=t(peer_ids),
        voters_in=t(voters_in),
        voters_out=zeros(v, dtype=BOOL),
        learners=t(peer_is_learner & present),
        learners_next=zeros(v, dtype=BOOL),
        auto_leave=zeros(dtype=BOOL),
        pr_match=zeros(v),
        pr_next=torch.ones((n, v), dtype=I32, device=device),
        pr_state=zeros(v),
        pr_pending_snapshot=zeros(v),
        pr_recent_active=zeros(v, dtype=BOOL),
        pr_msg_app_flow_paused=zeros(v, dtype=BOOL),
        votes=zeros(v),
        infl_index=zeros(v, f),
        infl_bytes=zeros(v, f),
        infl_start=zeros(v),
        infl_count=zeros(v),
        infl_total_bytes=zeros(v),
        ro_ctx=zeros(r),
        ro_from=zeros(r),
        ro_index=zeros(r),
        ro_acks=zeros(r, v, dtype=BOOL),
        ro_seq=zeros(r),
        ro_next_seq=torch.ones((n,), dtype=I32, device=device),
        pri_ctx=zeros(r),
        pri_from=zeros(r),
        rs_ctx=zeros(r),
        rs_index=zeros(r),
        rs_count=zeros(),
        error_bits=zeros(),
        cfg=cfg,
    )
