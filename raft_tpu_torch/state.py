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
