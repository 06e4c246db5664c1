"""The fused multi-raft round: every lane's whole round as one pass of
tensor ops (raft_tpu/ops/fused.py).

Messages live in per-(source lane, destination member) slots of a channel
fabric — replication, heartbeat, vote request and vote response channels of
[N, V] columns plus a [N] self slot — and routing is a transpose within each
group: inbox[g, j, i] = outbox[g, i, j]. A round is tick, the term ladder,
the winning append/heartbeat per lane through the step handlers, vote
casting, the leader fan-in with one commit-index reduction per lane, the
local inputs, and one coalesced append fan-out (see the JAX module doc for
the design and reference line numbers).

This module runs the round eagerly: one PyTorch call per tensor op, and the
commit-index reduction through the hand-written CUDA kernel on the card
(ops/quorum.py joint_committed -> csrc/quorum.cu joint_kernel). The carry is
updated functionally (new tensors each round); nothing is written in place.

Of the JAX round's optional planes metrics, the diet-v2 packed carry
(`diet=True`: state.pack_state / pack_fabric between dispatches, and
store_carry / load_carry around every round), the paged entry log
(`paged=True`, ops/paged.py: a resident tail plus a page pool between
dispatches, or with `paged_inkernel=True` around every round) and the
chaos plane (`chaos=True`, chaos/device.py: drops, duplicates, partitions,
tick skew and crashes around every round, and the recovery probe) are
ported; lease, trace, tier, straddle and fused_ids are not, nor chaos
together with paging (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from raft_tpu_torch.chaos import device as chmod
from raft_tpu_torch.config import Shape, resolve_device
from raft_tpu_torch.messages import empty_batch
from raft_tpu_torch.metrics import device as metmod
from raft_tpu_torch.metrics.host import CounterAccumulator
from raft_tpu_torch.ops import log as lg
from raft_tpu_torch.ops import onehot as ohm
from raft_tpu_torch.ops import paged as pgmod
from raft_tpu_torch.ops import progress as pg
from raft_tpu_torch.ops import quorum as qr
from raft_tpu_torch.ops import step as stepmod
from raft_tpu_torch.state import (
    _DIET_RANGE,
    ERR_DIET_OVERFLOW,
    RaftState,
    fat_state,
    init_state,
    is_packed,
    make_lane_config,
    pack_state,
    slim_state,
    unpack_state,
)
from raft_tpu_torch.types import (
    CampaignType,
    EntryType,
    MessageType as MT,
    ProgressState,
    StateType,
    VoteResult,
    VoteState,
)

I32 = torch.int32
BOOL = torch.bool
NONE = int(MT.MSG_NONE)

# Planes of the JAX round that this package does not have yet.
PLANES_NOT_PORTED = (
    "lease", "trace", "tier", "straddle", "fused_ids",
)


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


# --------------------------------------------------------------------------
# the channel fabric


@dataclasses.dataclass
class RepChan:
    """Replication channel: MsgApp / MsgSnap / MsgAppResp per (src, dst)."""

    kind: Any  # [N, V] MessageType (MSG_NONE = empty)
    term: Any  # [N, V]
    index: Any  # [N, V] APP: prev index; APPRESP: acked/rejected index
    log_term: Any  # [N, V] APP: prev term; APPRESP(rej): hint term
    commit: Any  # [N, V]
    reject: Any  # [N, V] bool
    reject_hint: Any  # [N, V]
    n_ents: Any  # [N, V]
    ent_term: Any  # [N, V, E]
    ent_type: Any  # [N, V, E]
    ent_bytes: Any  # [N, V, E]
    snap_index: Any  # [N, V]
    snap_term: Any  # [N, V]


@dataclasses.dataclass
class HbChan:
    """Heartbeat channel: MsgHeartbeat / MsgHeartbeatResp."""

    kind: Any
    term: Any
    commit: Any
    context: Any  # ReadIndex ctx ticket


@dataclasses.dataclass
class VoteChan:
    """Vote-request channel: MsgVote / MsgPreVote / MsgTimeoutNow."""

    kind: Any
    term: Any
    index: Any  # candidate lastIndex
    log_term: Any  # candidate lastTerm
    reject: Any  # bool (unused for requests)
    context: Any  # campaign-transfer flag


@dataclasses.dataclass
class VoteRespChan:
    """Vote-response channel: Msg(Pre)VoteResp."""

    kind: Any
    term: Any
    reject: Any  # bool


@dataclasses.dataclass
class SelfMsg:
    """The after-append self slot (MsgAppResp / Msg(Pre)VoteResp to self)."""

    kind: Any  # [N]
    term: Any  # [N]
    index: Any  # [N]


@dataclasses.dataclass
class Fabric:
    rep: RepChan
    hb: HbChan
    vote: VoteChan
    vresp: VoteRespChan
    self_: SelfMsg


CHANNELS = ("rep", "hb", "vote", "vresp")


def empty_fabric(n: int, v: int, e: int, device) -> Fabric:
    def z():
        return torch.zeros((n, v), dtype=I32, device=device)

    def zb():
        return torch.zeros((n, v), dtype=BOOL, device=device)

    def ze():
        return torch.zeros((n, v, e), dtype=I32, device=device)

    def none():
        return torch.full((n, v), NONE, dtype=I32, device=device)

    return Fabric(
        rep=RepChan(none(), z(), z(), z(), z(), zb(), z(), z(), ze(), ze(), ze(), z(), z()),
        hb=HbChan(none(), z(), z(), z()),
        vote=VoteChan(none(), z(), z(), z(), zb(), z()),
        vresp=VoteRespChan(none(), z(), zb()),
        self_=SelfMsg(
            torch.full((n,), NONE, dtype=I32, device=device),
            torch.zeros((n,), dtype=I32, device=device),
            torch.zeros((n,), dtype=I32, device=device),
        ),
    )


# Fabric carry diet (fused.FABRIC_SLIM): type and count columns store as int8
FABRIC_SLIM = {
    ("rep", "kind"): torch.int8,
    ("rep", "n_ents"): torch.int8,
    ("rep", "ent_type"): torch.int8,
    ("hb", "kind"): torch.int8,
    ("vote", "kind"): torch.int8,
    ("vresp", "kind"): torch.int8,
    ("self_", "kind"): torch.int8,
}


def _cast_fabric(fab: Fabric, widen: bool) -> Fabric:
    for (chan_name, field), dt in FABRIC_SLIM.items():
        chan = getattr(fab, chan_name)
        x = getattr(chan, field)
        target = I32 if widen else dt
        if x.dtype != target:
            chan = dataclasses.replace(chan, **{field: x.to(target)})
            fab = dataclasses.replace(fab, **{chan_name: chan})
    return fab


def slim_fabric(fab: Fabric) -> Fabric:
    return _cast_fabric(fab, widen=False)


def fat_fabric(fab: Fabric) -> Fabric:
    return _cast_fabric(fab, widen=True)


# Diet-v2 fabric (fused.FABRIC_PACK, the wire-side twin of state.pack_state):
# every bounded term/index/commit column of an in-flight message narrows to
# uint16 (messages carry values from the sender's rebased state) and entry
# payload sizes to int16. The host-ticket columns (hb.context,
# vote.context) stay int32. Empty slots are zeros, so packing every cell
# whatever its kind is exact.
FABRIC_PACK = {
    ("rep", "term"): torch.uint16,
    ("rep", "index"): torch.uint16,
    ("rep", "log_term"): torch.uint16,
    ("rep", "commit"): torch.uint16,
    ("rep", "reject_hint"): torch.uint16,
    ("rep", "snap_index"): torch.uint16,
    ("rep", "snap_term"): torch.uint16,
    ("rep", "ent_term"): torch.uint16,
    ("rep", "ent_bytes"): torch.int16,
    ("hb", "term"): torch.uint16,
    ("hb", "commit"): torch.uint16,
    ("vote", "term"): torch.uint16,
    ("vote", "index"): torch.uint16,
    ("vote", "log_term"): torch.uint16,
    ("vresp", "term"): torch.uint16,
    ("self_", "term"): torch.uint16,
    ("self_", "index"): torch.uint16,
}


def is_packed_fabric(fab: Fabric) -> bool:
    """The diet-v2 fabric layout (its replication index is uint16)."""
    return fab.rep.index.dtype == torch.uint16


def fabric_diet_overflow(fab: Fabric):
    """[N] bool: a cell of this lane's outbox row outside its diet-v2
    range. store_carry folds it into state.error_bits (the fabric has no
    error column of its own)."""
    n = fab.self_.kind.shape[0]
    ovf = torch.zeros((n,), dtype=BOOL, device=fab.self_.kind.device)
    if is_packed_fabric(fab):
        return ovf
    for (chan_name, field), dt in FABRIC_PACK.items():
        x = getattr(getattr(fab, chan_name), field)
        lo, hi = _DIET_RANGE[dt]
        bad = (x < lo) | (x > hi)
        if bad.dim() > 1:
            bad = bad.flatten(1).any(dim=1)
        ovf = ovf | bad
    return ovf


def _cast_fabric_map(fab: Fabric, table, widen: bool, clamp: bool) -> Fabric:
    for (chan_name, field), dt in table.items():
        chan = getattr(fab, chan_name)
        x = getattr(chan, field)
        target = I32 if widen else dt
        if x.dtype != target:
            if clamp and not widen:
                lo, hi = _DIET_RANGE[dt]
                x = torch.clamp(x, lo, hi)
            chan = dataclasses.replace(chan, **{field: x.to(target)})
            fab = dataclasses.replace(fab, **{chan_name: chan})
    return fab


def pack_fabric(fab: Fabric) -> Fabric:
    """Slim/fat -> diet-v2 packed fabric (idempotent). Out-of-range cells
    clamp; store_carry folds fabric_diet_overflow into error_bits first,
    so a clamp is never silent."""
    if is_packed_fabric(fab):
        return fab
    return _cast_fabric_map(slim_fabric(fab), FABRIC_PACK, widen=False, clamp=True)


def unpack_fabric(fab: Fabric) -> Fabric:
    """Diet-v2 packed -> the exact slim fabric (idempotent)."""
    if not is_packed_fabric(fab):
        return fab
    return _cast_fabric_map(fab, FABRIC_PACK, widen=True, clamp=False)


def store_carry(state: RaftState, fab: Fabric):
    """The diet-v2 store boundary of a (state, fabric) carry: fold the
    fabric's overflow into state.error_bits, then pack both. Every engine
    crosses this one boundary between rounds (csrc/round.cu replays it in
    its diet build). A carry already packed passes as it is: its values
    are in range by their dtypes, so the fold and the packs are the
    identity, and skipping them saves the card four launches a dispatch."""
    if is_packed(state) and is_packed_fabric(fab):
        return state, fab
    ovf = fabric_diet_overflow(fab)
    state = dataclasses.replace(
        state, error_bits=state.error_bits | torch.where(ovf, ERR_DIET_OVERFLOW, 0).to(I32)
    )
    return pack_state(state), pack_fabric(fab)


def load_carry(state: RaftState, fab: Fabric):
    """The diet-v2 load boundary: packed (state, fabric) -> the int32
    compute view."""
    return fat_state(unpack_state(state)), fat_fabric(unpack_fabric(fab))


def _fat_carry(state: RaftState, fab: Fabric):
    return fat_state(state), fat_fabric(fab)


def _slim_carry(state: RaftState, fab: Fabric):
    return slim_state(state), slim_fabric(fab)


def carry_boundary(state: RaftState):
    """(load, store): the storage boundary a carry crosses around every
    round, the diet-v2 pair for a packed carry (state.is_packed), else the
    slim casts. Both engines cross it, and store also brings a carry into
    its storage layout on entry."""
    return (load_carry, store_carry) if is_packed(state) else (_fat_carry, _slim_carry)


def aligned_peer_mute(mute, v: int):
    """[N, V] peer-mute matrix for group-aligned lanes: cell [dst, i] is the
    mute bit of member i of dst's group (lane (dst//v)*v + i)."""
    n = mute.shape[0]
    g = n // v
    return mute.reshape(g, 1, v).expand(g, v, v).reshape(n, v)


def _route_field(x, v):
    """inbox[g, j, i] = outbox[g, i, j]: a [G, V, V] axis swap per field."""
    g = x.shape[0] // v
    y = x.reshape((g, v, v) + tuple(x.shape[2:]))
    return y.transpose(1, 2).reshape(x.shape)


def route_fabric(out: Fabric, v: int, mute=None, peer_mute=None) -> Fabric:
    """Deliver the group-aligned fabric; the self slot passes through. A
    muted lane neither sends nor receives (peer_mute: the precomputed
    aligned_peer_mute(mute, v))."""
    if mute is not None and peer_mute is None:
        peer_mute = aligned_peer_mute(mute, v)

    def deliver(chan):
        chan = type(chan)(**{f: _route_field(getattr(chan, f), v) for f in _fields(chan)})
        if mute is None:
            return chan
        cut = peer_mute | mute[:, None]
        return dataclasses.replace(chan, kind=torch.where(cut, NONE, chan.kind))

    return Fabric(
        **{c: deliver(getattr(out, c)) for c in CHANNELS}, self_=out.self_
    )


# --------------------------------------------------------------------------
# outbox adapter: the step handlers' emissions land in the fabric


_FAMILY = {
    "rep": (MT.MSG_APP, MT.MSG_SNAP, MT.MSG_APP_RESP),
    "hb": (MT.MSG_HEARTBEAT, MT.MSG_HEARTBEAT_RESP),
    "vote": (MT.MSG_VOTE, MT.MSG_PRE_VOTE, MT.MSG_TIMEOUT_NOW),
    "vresp": (MT.MSG_VOTE_RESP, MT.MSG_PRE_VOTE_RESP),
}


def _family(types, mtype):
    m = mtype == int(types[0])
    for t in types[1:]:
        m = m | (mtype == int(t))
    return m


class ChannelOutbox:
    """The outbox protocol (put_peers / put_self / put_reply) of the step
    handlers, writing into the channel fabric. Message type is data, so a
    write is routed to its channel by per-element family masks."""

    def __init__(self, n: int, v: int, e: int, device):
        self.n, self.v, self.e = n, v, e
        self.device = device
        self.fab = empty_fabric(n, v, e, device)

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.tensor(x, device=self.device)

    def _merge_chan(self, chan, sel, fields):
        upd = {}
        for name in _fields(chan):
            src = fields.get("type" if name == "kind" else name)
            if src is None:
                continue
            old = getattr(chan, name)
            m = sel
            while m.dim() < old.dim():
                m = m.unsqueeze(-1)
            upd[name] = torch.where(m, src.to(old.dtype), old)
        return dataclasses.replace(chan, **upd)

    def _put_nv(self, sel_nv, fields_nv):
        """Write [N, V]-shaped messages into their family channels."""
        fields = {k: self._tensor(x) for k, x in fields_nv.items()}
        mtype = fields["type"].to(I32).expand(sel_nv.shape)
        fields["type"] = mtype
        upd = {
            c: self._merge_chan(getattr(self.fab, c), sel_nv & _family(t, mtype), fields)
            for c, t in _FAMILY.items()
        }
        self.fab = dataclasses.replace(self.fab, **upd)

    def put_peers(self, mask_nv, **fields):
        def bc(x):
            x = self._tensor(x)
            return x[:, None] if x.dim() == 1 and x.shape[0] == self.n else x

        self._put_nv(mask_nv, {k: bc(x) for k, x in fields.items()})

    def put_reply(self, mask, to, **fields):
        """Reply to raft id `to` [N] — dst slot to-1 (canonical ids)."""
        dst = torch.clamp(to - 1, 0, self.v - 1)
        sel = (
            mask[:, None]
            & ohm.onehot(dst, self.v)
            & ((to >= 1) & (to <= self.v))[:, None]
        )
        fields_nv = {}
        for k, x in fields.items():
            x = self._tensor(x)
            if x.dim() >= 1 and x.shape[0] == self.n:
                x = x.unsqueeze(1)
            fields_nv[k] = x
        self._put_nv(sel, fields_nv)

    def put_self(self, mask, type, term=0, index=0):
        """Queue the after-append self-ack (kind/term/index only)."""
        s = self.fab.self_

        def col(x):
            return self._tensor(x).to(I32).expand(mask.shape)

        self.fab = dataclasses.replace(
            self.fab,
            self_=SelfMsg(
                kind=torch.where(mask, col(type), s.kind),
                term=torch.where(mask, col(term), s.term),
                index=torch.where(mask, col(index), s.index),
            ),
        )


# --------------------------------------------------------------------------
# helpers


def _w(mask, new, old):
    return torch.where(mask, new, old)


def _select_row(chan, win, any_win) -> dict:
    """Each lane's winning member cell as [N] columns (one-hot select over
    the member axis; lanes without a winner read zeros)."""
    v = chan.kind.shape[1]
    sel = ohm.onehot(torch.clamp(win, min=0), v) & any_win[:, None]
    row = {}
    for name in _fields(chan):
        x = getattr(chan, name)
        xi = x.to(I32) if x.dtype == BOOL else x
        s = sel if x.dim() == 2 else sel[:, :, None]
        got = torch.where(s, xi, 0).sum(dim=1, dtype=I32)
        row[name] = got.to(BOOL) if x.dtype == BOOL else got
    return row


def _msg_view(row: dict, frm, n: int, e: int, device):
    """The [N] MsgBatch view of a selected channel row that the step
    handlers read; fields the channel lacks stay zero."""
    fields = {("type" if k == "kind" else k): x for k, x in row.items()}
    return dataclasses.replace(empty_batch((n,), e, device), frm=frm, **fields)


class LocalOps(NamedTuple):
    """Host-injected per-round local inputs (all optional zeros)."""

    hup: Any  # [N] bool - MsgHup
    prop_n: Any  # [N] i32 entries to propose this round
    prop_bytes: Any  # [N] i32 payload size per entry
    transfer_to: Any  # [N] i32 raft id (0 = none) - MsgTransferLeader
    read_ctx: Any  # [N] i32 ctx ticket (0 = none) - MsgReadIndex at leader
    forget: Any  # [N] bool - MsgForgetLeader
    prop_cc: Any  # [N] i32 conf-change proposal: 0 none, 1 enter/simple, 2 leave
    beat: Any  # [N] bool - host-fired MsgBeat


_BOOL_OPS = ("hup", "forget", "beat")


def no_ops(n: int, device) -> LocalOps:
    return make_local_ops(n, device)


def make_local_ops(n: int, device, **kw) -> LocalOps:
    """LocalOps over `n` lanes with the given columns set; values may be
    dicts {lane: value} or full arrays."""
    base = {
        f: np.zeros((n,), np.bool_ if f in _BOOL_OPS else np.int32)
        for f in LocalOps._fields
    }
    for k, val in kw.items():
        if isinstance(val, dict):
            for lane, x in val.items():
                base[k][lane] = x
        else:
            base[k][:] = val
    return LocalOps(**{k: torch.tensor(x, device=device) for k, x in base.items()})


# --------------------------------------------------------------------------
# the fused round


def fused_round(
    state: RaftState,
    inb: Fabric,
    ops: LocalOps,
    mute=None,
    *,
    peer_mute=None,
    do_tick: bool = True,
    auto_propose: bool = False,
    auto_compact_lag: int | None = None,
    tick_mask=None,
    metrics: metmod.MetricsState | None = None,
):
    """One complete synchronous round for every lane, on the fat (int32)
    state and the routed inbox. Returns (state, outbox fabric), or
    (state, fabric, metrics) when `metrics` is given. Phase by phase a port
    of raft_tpu/ops/fused.py fused_round; comments there cite the
    reference. tick_mask: optional [N] bool from the chaos plane; a lane
    where it is False skips this round's tick (its clocks hold, and no
    election, check-quorum or heartbeat tick fires)."""
    n, v = state.prs_id.shape
    e = inb.rep.ent_term.shape[-1]
    dev = state.term.device
    out = ChannelOutbox(n, v, e, dev)
    bag = None
    if metrics is not None:
        bag = metmod.EventBag()
        lead0 = state.lead
        committed0 = state.committed
    lanes_v = ohm.iota(v, dev)[None, :]
    ss = stepmod.self_slot(state)
    is_self = lanes_v == ss[:, None]
    zeros_n = torch.zeros((n,), dtype=I32, device=dev)
    all_peers = torch.ones((n, v), dtype=BOOL, device=dev)

    send_sel = torch.zeros((n, v), dtype=BOOL, device=dev)
    send_sie = torch.zeros((n, v), dtype=BOOL, device=dev)

    def want_send(cells, sie=None):
        nonlocal send_sel, send_sie
        send_sel = send_sel | cells
        send_sie = send_sie | (cells if sie is None else (cells & sie))

    def put_type(cells, mtype, **fields):
        out._put_nv(cells, dict(fields, type=torch.full((n, v), int(mtype), dtype=I32, device=dev)))

    # ---- tick (raft.go:823-862) ----
    fire_hup = fire_beat = fire_cq = torch.zeros((n,), dtype=BOOL, device=dev)
    if do_tick:
        is_leader0 = state.state == StateType.LEADER
        ee = state.election_elapsed + 1
        he = torch.where(is_leader0, state.heartbeat_elapsed + 1, state.heartbeat_elapsed)
        if tick_mask is not None:
            ee = torch.where(tick_mask, ee, state.election_elapsed)
            he = torch.where(tick_mask, he, state.heartbeat_elapsed)
        fire_hup = (
            ~is_leader0
            & stepmod.promotable(state)
            & (ee >= state.randomized_election_timeout)
        )
        lead_etick = is_leader0 & (ee >= state.cfg.election_tick)
        if tick_mask is not None:
            fire_hup = fire_hup & tick_mask
            lead_etick = lead_etick & tick_mask
        fire_cq = lead_etick & state.cfg.check_quorum
        ee = torch.where(fire_hup | lead_etick, 0, ee)
        fire_beat = is_leader0 & (he >= state.cfg.heartbeat_tick)
        if tick_mask is not None:
            fire_beat = fire_beat & tick_mask
        he = torch.where(fire_beat, 0, he)
        state = dataclasses.replace(
            state,
            election_elapsed=ee,
            heartbeat_elapsed=he,
            lead_transferee=_w(lead_etick, 0, state.lead_transferee),
        )

    # ---- presence ----
    rep_p = inb.rep.kind != NONE
    hb_p = inb.hb.kind != NONE
    vote_p = inb.vote.kind != NONE
    vresp_p = inb.vresp.kind != NONE
    self_p = inb.self_.kind != NONE

    # ---- term ladder (raft.go:1053-1139) ----
    keep_vote = inb.vote.kind == MT.MSG_PRE_VOTE
    keep_vresp = (inb.vresp.kind == MT.MSG_PRE_VOTE_RESP) & ~inb.vresp.reject
    force = inb.vote.context == CampaignType.TRANSFER
    in_lease = (
        state.cfg.check_quorum
        & (state.lead != 0)
        & (state.election_elapsed < state.cfg.election_tick)
    )
    is_vreq = (inb.vote.kind == MT.MSG_VOTE) | (inb.vote.kind == MT.MSG_PRE_VOTE)
    lease_ignored = (
        vote_p
        & is_vreq
        & (inb.vote.term > state.term[:, None])
        & ~force
        & in_lease[:, None]
    )

    def bump(present, term):
        return torch.where(present, term, 0).amax(dim=1)

    rep_bump = bump(rep_p, inb.rep.term)
    hb_bump = bump(hb_p, inb.hb.term)
    vote_bump = bump(vote_p & ~keep_vote & ~lease_ignored, inb.vote.term)
    vresp_bump = bump(vresp_p & ~keep_vresp, inb.vresp.term)
    self_bump = torch.where(
        self_p & (inb.self_.kind == MT.MSG_APP_RESP), inb.self_.term, 0
    )
    t_new = torch.maximum(
        torch.maximum(rep_bump, hb_bump),
        torch.maximum(torch.maximum(vote_bump, vresp_bump), self_bump),
    )
    step_down = t_new > state.term
    # leader attribution: an append-family or heartbeat sender at t_new
    from_ldr_rep = rep_p & (inb.rep.term == t_new[:, None]) & (
        (inb.rep.kind == MT.MSG_APP) | (inb.rep.kind == MT.MSG_SNAP)
    )
    from_ldr_hb = hb_p & (inb.hb.term == t_new[:, None]) & (
        inb.hb.kind == MT.MSG_HEARTBEAT
    )
    ldr_member = torch.where(from_ldr_rep | from_ldr_hb, lanes_v + 1, 0).amax(dim=1)
    state = stepmod.become_follower(state, step_down, t_new, ldr_member)

    # lower-term handling (raft.go:1087-1139)
    low_rep = rep_p & (inb.rep.term < state.term[:, None])
    low_hb = hb_p & (inb.hb.term < state.term[:, None])
    low_vote = vote_p & (inb.vote.term < state.term[:, None])
    ping = (state.cfg.check_quorum | state.cfg.pre_vote)[:, None] & (
        (low_rep & (inb.rep.kind == MT.MSG_APP))
        | (low_hb & (inb.hb.kind == MT.MSG_HEARTBEAT))
    )
    put_type(ping, MT.MSG_APP_RESP, term=state.term[:, None])
    low_prevote = low_vote & (inb.vote.kind == MT.MSG_PRE_VOTE)
    put_type(low_prevote, MT.MSG_PRE_VOTE_RESP, term=state.term[:, None], reject=all_peers)
    rep_live = rep_p & ~low_rep
    hb_live = hb_p & ~low_hb
    vote_live = vote_p & ~low_vote & ~lease_ignored

    # ---- winning append-family message (raft.go:1732-1795) ----
    app_cell = rep_live & (
        (inb.rep.kind == MT.MSG_APP) | (inb.rep.kind == MT.MSG_SNAP)
    ) & (inb.rep.term == state.term[:, None])
    any_app = app_cell.any(dim=1)
    win = ohm.argmax_last(app_cell)  # first hot slot
    mrow = _select_row(inb.rep, win, any_app)
    m_frm = torch.where(any_app, win + 1, 0)

    # candidates step down on current-term append traffic (raft.go:1639-1647)
    is_cand = (state.state == StateType.CANDIDATE) | (
        state.state == StateType.PRE_CANDIDATE
    )
    state = stepmod.become_follower(state, any_app & is_cand, state.term, m_frm)
    # followers adopt the leader + reset timer (raft.go:1681-1692)
    adopt = any_app & (state.state == StateType.FOLLOWER)
    state = dataclasses.replace(
        state,
        lead=_w(adopt, m_frm, state.lead),
        election_elapsed=_w(adopt, 0, state.election_elapsed),
    )
    msg = _msg_view(mrow, m_frm, n, e, dev)
    is_app = any_app & (mrow["kind"] == MT.MSG_APP) & (state.state == StateType.FOLLOWER)
    state = stepmod.handle_append_entries(state, is_app, msg, out)
    is_snap = any_app & (mrow["kind"] == MT.MSG_SNAP)
    state = stepmod.handle_snapshot(state, is_snap, msg, out)
    # in-fabric snapshot transport is instantaneous: the restore IS the
    # persisted application (sync model), so clear the pending marker
    applied_snap = is_snap & (state.pending_snap_index != 0)
    state = dataclasses.replace(
        state,
        applied=_w(applied_snap, torch.maximum(state.applied, state.pending_snap_index), state.applied),
        applying=_w(applied_snap, torch.maximum(state.applying, state.pending_snap_index), state.applying),
        pending_snap_index=_w(applied_snap, 0, state.pending_snap_index),
        pending_snap_term=_w(applied_snap, 0, state.pending_snap_term),
    )

    # ---- winning heartbeat (raft.go:1772-1775) ----
    hb_cell = hb_live & (inb.hb.kind == MT.MSG_HEARTBEAT) & (
        inb.hb.term == state.term[:, None]
    )
    any_hb = hb_cell.any(dim=1)
    hwin = ohm.argmax_last(hb_cell)
    hrow = _select_row(inb.hb, hwin, any_hb)
    h_frm = torch.where(any_hb, hwin + 1, 0)
    state = stepmod.become_follower(state, any_hb & is_cand, state.term, h_frm)
    adopt_h = any_hb & (state.state == StateType.FOLLOWER)
    state = dataclasses.replace(
        state,
        lead=_w(adopt_h, h_frm, state.lead),
        election_elapsed=_w(adopt_h, 0, state.election_elapsed),
    )
    hb_msg = _msg_view(hrow, h_frm, n, e, dev)
    state = stepmod.handle_heartbeat(
        state, any_hb & (state.state == StateType.FOLLOWER), hb_msg, out
    )

    # ---- vote casting: grant at most one candidate (raft.go:1164-1212) ----
    vreq_cell = vote_live & is_vreq
    # VOTE requests bumped us to their term already; PREVOTE asks for term+1
    is_pv_cell = inb.vote.kind == MT.MSG_PRE_VOTE
    pv_ahead = is_pv_cell & (inb.vote.term > state.term[:, None])
    cur = vreq_cell & (
        ((inb.vote.kind == MT.MSG_VOTE) & (inb.vote.term == state.term[:, None]))
        | pv_ahead
    )
    cand_id = lanes_v + 1
    can_vote = (
        (state.vote[:, None] == cand_id)
        | ((state.vote == 0) & (state.lead == 0))[:, None]
        | pv_ahead
    )
    # up-to-date per candidate cell (log.go:428-433)
    lt = lg.last_term(state)[:, None]
    up2d_cell = (inb.vote.log_term > lt) | (
        (inb.vote.log_term == lt) & (inb.vote.index >= state.last[:, None])
    )
    grantable = cur & can_vote & up2d_cell
    # a real MSG_VOTE grant records state.vote, so at most one wins per
    # round; PreVote grants record nothing — grant all
    real_grantable = grantable & ~is_pv_cell
    any_real = real_grantable.any(dim=1)
    gwin = ohm.argmax_last(real_grantable)
    real_grant_cell = real_grantable & (lanes_v == gwin[:, None]) & any_real[:, None]
    grant_cell = (grantable & is_pv_cell) | real_grant_cell
    resp_kind = torch.where(
        is_pv_cell, int(MT.MSG_PRE_VOTE_RESP), int(MT.MSG_VOTE_RESP)
    ).to(I32)
    out._put_nv(grant_cell, {"type": resp_kind, "term": inb.vote.term})
    out._put_nv(
        vreq_cell & ~grant_cell,
        {"type": resp_kind, "term": state.term[:, None], "reject": all_peers},
    )
    real_grant = real_grant_cell.any(dim=1)
    state = dataclasses.replace(
        state,
        vote=_w(real_grant, gwin + 1, state.vote),
        election_elapsed=_w(real_grant, 0, state.election_elapsed),
    )

    # ---- TimeoutNow -> transfer campaign (raft.go:1713-1719) ----
    ton = (
        vote_live
        & (inb.vote.kind == MT.MSG_TIMEOUT_NOW)
        & (inb.vote.term == state.term[:, None])
    ).any(dim=1) & (state.state == StateType.FOLLOWER)

    # ---- leader fan-in -------------------------------------------------
    is_leader = state.state == StateType.LEADER

    # snapshot transport feedback: muted peer => failure (clear the pending
    # snapshot), reachable => success; both resume probing, paused
    in_snap = is_leader[:, None] & (state.pr_state == ProgressState.SNAPSHOT)
    if mute is not None:
        if peer_mute is None:
            peer_mute = aligned_peer_mute(mute, v)
        snap_fail = in_snap & (mute[:, None] | peer_mute)
        state = dataclasses.replace(
            state, pr_pending_snapshot=_w(snap_fail, 0, state.pr_pending_snapshot)
        )
    state = pg.become_probe(state, in_snap)
    state = dataclasses.replace(
        state,
        pr_msg_app_flow_paused=_w(in_snap, True, state.pr_msg_app_flow_paused),
    )

    # MsgAppResp cells, including the self-ack (raft.go:1333-1526)
    ar_cell = (
        rep_live
        & (inb.rep.kind == MT.MSG_APP_RESP)
        & (inb.rep.term == state.term[:, None])
        & is_leader[:, None]
    )
    self_ar = (
        self_p
        & (inb.self_.kind == MT.MSG_APP_RESP)
        & (inb.self_.term == state.term)
        & is_leader
    )
    self_ar_cell = self_ar[:, None] & is_self
    ar_all = ar_cell | self_ar_cell
    ar_index = torch.where(self_ar_cell, inb.self_.index[:, None], inb.rep.index)
    state = dataclasses.replace(
        state, pr_recent_active=_w(ar_all, True, state.pr_recent_active)
    )

    rej_cell = ar_cell & inb.rep.reject
    acc_cell = ar_all & ~rej_cell

    # rejections; the JAX round skips this block with a lax.cond when no
    # cell rejects — with no rejection every update below is a no-op, so
    # it runs unconditionally here and the host never waits on the device
    next_probe = torch.where(
        inb.rep.log_term > 0,
        _fcbt_nv(state, inb.rep.reject_hint, inb.rep.log_term),
        inb.rep.reject_hint,
    )
    state, decreased = pg.maybe_decr_to(state, rej_cell, ar_index, next_probe)
    state = pg.become_probe(state, decreased & (state.pr_state == ProgressState.REPLICATE))
    want_send(decreased)

    old_paused = pg.is_paused(state)
    state, updated = pg.maybe_update(state, acc_cell, ar_index)
    probe_refresh = (
        acc_cell
        & (state.pr_match == ar_index)
        & (state.pr_state == ProgressState.PROBE)
    )
    advanced = updated | probe_refresh
    from_probe = advanced & (state.pr_state == ProgressState.PROBE)
    state = pg.become_replicate(state, from_probe)
    from_snap = (
        advanced
        & (state.pr_state == ProgressState.SNAPSHOT)
        & (state.pr_match + 1 >= state.first_index[:, None])
    )
    state = pg.become_probe(state, from_snap)
    state = pg.become_replicate(state, from_snap)
    in_repl = advanced & (state.pr_state == ProgressState.REPLICATE)
    state = pg.inflights_free_le(state, in_repl, ar_index)

    # the commit index: one joint-quorum reduction per lane, on the card the
    # CUDA joint_kernel (quorum_pallas._joint_kernel's counterpart)
    advanced_lane = advanced.any(dim=1)
    mci = qr.joint_committed(
        torch.where(stepmod.voter_mask(state), state.pr_match, 0),
        state.voters_in,
        state.voters_out,
    )
    state, committed_adv = lg.maybe_commit(
        state, torch.where(advanced_lane, mci, 0), state.term
    )
    want_send(committed_adv[:, None] & all_peers)
    retry = advanced & ~committed_adv[:, None] & ~is_self
    want_send(retry, old_paused)

    # leadership transfer completion (raft.go:1519-1524)
    xfer_cell = (
        acc_cell
        & advanced
        & ((lanes_v + 1) == state.lead_transferee[:, None])
        & (state.pr_match == state.last[:, None])
    )
    put_type(xfer_cell, MT.MSG_TIMEOUT_NOW, term=state.term[:, None])

    # MsgHeartbeatResp cells (raft.go:1527-1561)
    hr_cell = (
        hb_live
        & (inb.hb.kind == MT.MSG_HEARTBEAT_RESP)
        & (inb.hb.term == state.term[:, None])
        & is_leader[:, None]
    )
    state = dataclasses.replace(
        state,
        pr_recent_active=_w(hr_cell, True, state.pr_recent_active),
        pr_msg_app_flow_paused=_w(hr_cell, False, state.pr_msg_app_flow_paused),
    )
    need_app = hr_cell & (
        (state.pr_match < state.last[:, None])
        | (state.pr_state == ProgressState.PROBE)
    )
    want_send(need_app)

    # ReadIndex acks via heartbeat ctx (raft.go:1548-1561,
    # read_only.go:68-112): a quorum ack for a ctx releases the whole FIFO
    # prefix up to and including that request
    r_ax = state.ro_ctx.shape[1]
    hit = (
        hr_cell[:, None, :]
        & (state.ro_ctx[:, :, None] == inb.hb.context[:, None, :])
        & (state.ro_ctx[:, :, None] != 0)
    )  # [N, R, V]
    acks = state.ro_acks | hit
    ro_votes = torch.where(acks, int(VoteState.GRANTED), int(VoteState.PENDING)).to(I32)
    ro_res = qr.joint_vote(
        ro_votes, state.voters_in[:, None, :], state.voters_out[:, None, :]
    )
    live_ro = state.ro_ctx != 0
    won = live_ro & (ro_res == VoteResult.VOTE_WON) & hit.any(dim=2)
    won_seq = torch.where(won, state.ro_seq, -1).amax(dim=1)  # [N]
    release = live_ro & (state.ro_seq <= won_seq[:, None])
    # pack released slots into the rs ring in FIFO (ro_seq) order
    sq = state.ro_seq
    rel_rank = (release[:, None, :] & (sq[:, None, :] < sq[:, :, None])).sum(dim=-1, dtype=I32)
    dst_slot = state.rs_count[:, None] + rel_rank
    put = release & (dst_slot < r_ax)
    dst_c = torch.clamp(dst_slot, 0, r_ax - 1)
    state = dataclasses.replace(
        state,
        rs_ctx=ohm.scatter_set(state.rs_ctx, dst_c, state.ro_ctx, put),
        rs_index=ohm.scatter_set(state.rs_index, dst_c, state.ro_index, put),
        rs_count=torch.clamp(state.rs_count + put.sum(dim=1, dtype=I32), max=r_ax),
        ro_ctx=_w(put, 0, state.ro_ctx),
        ro_from=_w(put, 0, state.ro_from),
        ro_index=_w(put, 0, state.ro_index),
        ro_seq=_w(put, 0, state.ro_seq),
        ro_acks=torch.where(put[:, :, None], False, acks),
    )
    if metrics is not None:
        bag.add("read_index_served", put)

    # Msg(Pre)VoteResp cells -> poll (raft.go:1041-1049, 1647-1666)
    my_resp = torch.where(
        state.state == StateType.PRE_CANDIDATE,
        int(MT.MSG_PRE_VOTE_RESP),
        int(MT.MSG_VOTE_RESP),
    ).to(I32)
    vresp_live = vresp_p & ~(inb.vresp.term < state.term[:, None])
    vr_cell = vresp_live & (inb.vresp.kind == my_resp[:, None]) & is_cand[:, None]
    self_vr = self_p & (inb.self_.kind == my_resp) & is_cand
    vr_all = vr_cell | (self_vr[:, None] & is_self)
    vr_rej = vr_cell & inb.vresp.reject  # the self vote never rejects
    state = dataclasses.replace(
        state,
        votes=torch.where(
            vr_all & stepmod.voter_mask(state),
            torch.where(vr_rej, int(VoteState.REJECTED), int(VoteState.GRANTED)).to(I32),
            state.votes,
        ),
    )
    res = qr.joint_vote(state.votes, state.voters_in, state.voters_out)
    tallied = vr_all.any(dim=1) & is_cand
    won = tallied & (res == VoteResult.VOTE_WON)
    lost = tallied & (res == VoteResult.VOTE_LOST)
    pre_won = won & (state.state == StateType.PRE_CANDIDATE)
    real_won = won & (state.state == StateType.CANDIDATE)
    state = stepmod.become_leader(state, real_won, out)
    want_send(real_won[:, None] & all_peers)
    state = stepmod.become_follower(state, lost, state.term, zeros_n)

    # ---- local inputs ---------------------------------------------------
    # campaign: ticks, injected hups, TimeoutNow transfers, PreVote wins
    ctype = torch.where(
        state.cfg.pre_vote, int(CampaignType.PRE_ELECTION), int(CampaignType.ELECTION)
    )
    ctype = torch.where(ton, int(CampaignType.TRANSFER), ctype)
    ctype = torch.where(pre_won, int(CampaignType.ELECTION), ctype).to(I32)
    state, hup_fired = stepmod.hup(
        state, fire_hup | ops.hup | ton | pre_won, ctype, out
    )
    if metrics is not None:
        bag.add("elections_started", hup_fired)
        bag.add("elections_won", real_won)

    # CheckQuorum (raft.go:1231-1243)
    is_leader = state.state == StateType.LEADER
    cq = fire_cq & is_leader
    alive = qr.joint_active(state.pr_recent_active | is_self, state.voters_in, state.voters_out)
    state = stepmod.become_follower(state, cq & ~alive, state.term, zeros_n)
    state = dataclasses.replace(
        state,
        pr_recent_active=_w(cq[:, None] & ~is_self, False, state.pr_recent_active),
    )

    # heartbeats (MsgBeat, raft.go:1228-1230) carry the newest pending
    # ReadIndex ctx
    is_leader = state.state == StateType.LEADER
    beat_live = state.ro_ctx != 0
    beat_newest = ohm.argmax_last(torch.where(beat_live, state.ro_seq, -1))
    beat_ctx = torch.where(
        beat_live.any(dim=1), ohm.gather(state.ro_ctx, beat_newest), 0
    )
    state = stepmod.bcast_heartbeat(
        state, (fire_beat | ops.beat) & is_leader, out, ctx=beat_ctx
    )

    # proposals (raft.go:1244-1302)
    prop_n = torch.maximum(ops.prop_n, is_leader.to(I32)) if auto_propose else ops.prop_n
    prop = (prop_n > 0) & is_leader & (state.lead_transferee == 0) & (ss >= 0)
    k = ohm.iota(e, dev)[None, :]
    pn = torch.clamp(prop_n, max=e)
    ent_bytes = torch.where(
        (k < pn[:, None]) & prop[:, None], ops.prop_bytes[:, None], 0
    )
    zeros_e = torch.zeros((n, e), dtype=I32, device=dev)
    state, appended = stepmod.append_entry(state, prop, zeros_e, zeros_e, ent_bytes, pn, out)
    want_send(appended[:, None] & all_peers)
    if metrics is not None:
        bag.add("proposals", torch.where(appended, pn, 0))
        bag.add("proposals_dropped", (prop_n > 0) & ~appended)
        metrics = metmod.arm_sample(metrics, appended, state.last)

    # conf-change proposal (raft.go:1259-1301): one ENTRY_CONF_CHANGE_V2
    # entry whose content the host holds; a refused change appends an empty
    # NORMAL entry in its place
    want_cc = (ops.prop_cc > 0) & is_leader & (state.lead_transferee == 0) & (ss >= 0)
    joint = state.voters_out.any(dim=1)
    pending_cc = state.pending_conf_index > state.applied
    refused = pending_cc | torch.where(ops.prop_cc == 2, ~joint, joint)
    cc_ok = want_cc & ~refused
    cc_type = torch.where(
        cc_ok[:, None] & (k == 0), int(EntryType.ENTRY_CONF_CHANGE_V2), 0
    ).to(I32)
    state, cc_appended = stepmod.append_entry(
        state, want_cc, zeros_e, cc_type, zeros_e, torch.ones((n,), dtype=I32, device=dev), out
    )
    state = dataclasses.replace(
        state,
        pending_conf_index=_w(cc_appended & cc_ok, state.last, state.pending_conf_index),
    )
    want_send(cc_appended[:, None] & all_peers)
    if metrics is not None:
        bag.add("proposals", cc_appended)
        bag.add("proposals_dropped", want_cc & (refused | ~cc_appended))

    # transfer-leadership request (raft.go:1587-1618), refused for
    # untracked or learner transferees
    tt = ops.transfer_to
    t_slot = torch.clamp(tt - 1, 0, v - 1)
    t_ok = (
        is_leader
        & (tt != 0)
        & (tt != state.lead_transferee)
        & (tt != state.id)
        & (tt >= 1)
        & (tt <= v)
        & (ohm.gather(state.prs_id, t_slot) != 0)
        & ~ohm.gather(state.learners, t_slot)
    )
    t_cell = ohm.onehot(t_slot, v) & t_ok[:, None]
    state = dataclasses.replace(
        state,
        election_elapsed=_w(t_ok, 0, state.election_elapsed),
        lead_transferee=_w(t_ok, tt, state.lead_transferee),
    )
    t_ready = t_cell & (state.pr_match == state.last[:, None])
    put_type(t_ready, MT.MSG_TIMEOUT_NOW, term=state.term[:, None])
    want_send(t_cell & ~t_ready)

    # ReadIndex at the leader (raft.go:1303-1332): single-voter or
    # lease-based groups answer at once, else enqueue + ctx'd heartbeat
    ri = (ops.read_ctx != 0) & is_leader
    ri_ok = ri & (lg.term_at(state, state.committed) == state.term)
    n_in = state.voters_in.sum(dim=1, dtype=I32)
    n_out = state.voters_out.sum(dim=1, dtype=I32)
    single = (n_in <= 1) & (n_out == 0)
    immediate = ri_ok & (single | state.cfg.read_only_lease_based)
    enq = ri_ok & ~immediate
    free = state.ro_ctx == 0
    first_free = ohm.argmax_last(free)
    can_enq = enq & free.any(dim=1)
    put_r = ohm.onehot(first_free, r_ax) & can_enq[:, None]
    state = dataclasses.replace(
        state,
        ro_ctx=_w(put_r, ops.read_ctx[:, None], state.ro_ctx),
        ro_from=_w(put_r, state.id[:, None], state.ro_from),
        ro_index=_w(put_r, state.committed[:, None], state.ro_index),
        ro_acks=_w(put_r[:, :, None], is_self[:, None, :], state.ro_acks),
        ro_seq=_w(put_r, state.ro_next_seq[:, None], state.ro_seq),
        ro_next_seq=state.ro_next_seq + can_enq.to(I32),
    )
    state = stepmod.bcast_heartbeat(state, can_enq, out, ctx=ops.read_ctx)
    # immediate release -> rs ring
    imm_room = immediate & (state.rs_count < r_ax)
    imm_put = ohm.onehot(torch.clamp(state.rs_count, 0, r_ax - 1), r_ax) & imm_room[:, None]
    if metrics is not None:
        bag.add("read_index_served", imm_room)
    state = dataclasses.replace(
        state,
        rs_ctx=_w(imm_put, ops.read_ctx[:, None], state.rs_ctx),
        rs_index=_w(imm_put, state.committed[:, None], state.rs_index),
        rs_count=_w(imm_room, state.rs_count + 1, state.rs_count),
    )

    # forget leader (raft.go:1700-1708; refused under lease-based reads)
    state = dataclasses.replace(
        state,
        lead=_w(
            ops.forget
            & (state.state == StateType.FOLLOWER)
            & (state.lead != 0)
            & ~state.cfg.read_only_lease_based,
            0,
            state.lead,
        ),
    )

    # ---- the single coalesced append fan-out ----
    state = stepmod.maybe_send_append(state, send_sel, send_sie, out)

    # ---- synchronous persist + apply (doc.go:79-103 in the sync model) ----
    state = dataclasses.replace(state, stabled=state.last)
    applied_bytes = _bytes_between(state, state.applied, state.committed)
    state = lg.applied_to(state, state.committed)
    state = dataclasses.replace(
        state, uncommitted_size=torch.clamp(state.uncommitted_size - applied_bytes, min=0)
    )
    if auto_compact_lag is not None:
        # snapshot at `applied`, then compact keeping `lag` entries
        # (the app's CreateSnapshot/Compact loop, storage.go:227-272)
        state = dataclasses.replace(
            state,
            avail_snap_index=state.applied,
            avail_snap_term=lg.term_at(state, state.applied),
        )
        target = torch.maximum(state.snap_index, state.applied - auto_compact_lag)
        state = lg.compact(state, target, lg.term_at(state, target))

    if metrics is None:
        return state, out.fab
    # ---- end-of-round measurement ----
    fab = out.fab
    rk, hk = fab.rep.kind, fab.hb.kind
    bag.add("msgs_app", (rk == MT.MSG_APP) | (rk == MT.MSG_SNAP))
    bag.add("msgs_app_resp", rk == MT.MSG_APP_RESP)
    bag.add("msgs_heartbeat", hk == MT.MSG_HEARTBEAT)
    bag.add("msgs_heartbeat_resp", hk == MT.MSG_HEARTBEAT_RESP)
    bag.add("msgs_vote", fab.vote.kind != NONE)
    bag.add("msgs_vote_resp", fab.vresp.kind != NONE)
    bag.add("leader_changes", (state.lead != lead0) & (state.lead != 0))
    bag.add("commits", state.committed - committed0)
    metrics = metmod.observe_commit_latency(metrics, state)
    metrics = metmod.commit_round(metrics, bag)
    return state, fab, metrics


def _fcbt_nv(state: RaftState, index_nv, term_nv):
    """find_conflict_by_term over [N, V] (leader-side rejection hints,
    log.go:166-194): a masked max over the window per cell."""
    idx_w, valid_w = lg.window_indexes(state)  # [N, W]
    cand = (
        valid_w[:, None, :]
        & (idx_w[:, None, :] <= index_nv[:, :, None])
        & (state.log_term[:, None, :] <= term_nv[:, :, None])
    )
    best = torch.where(cand, idx_w[:, None, :], -1).amax(dim=-1)
    snap_ok = (state.snap_index[:, None] <= index_nv) & (
        state.snap_term[:, None] <= term_nv
    )
    best = torch.maximum(best, torch.where(snap_ok, state.snap_index[:, None], -1))
    best = torch.where(index_nv > state.last[:, None], index_nv, best)
    below = torch.minimum(index_nv, state.snap_index[:, None] - 1)
    best = torch.where(best < 0, torch.clamp(below, min=0), best)
    return torch.clamp(best, min=0)


def _bytes_between(state: RaftState, lo, hi):
    idx, valid = lg.window_indexes(state)
    m = valid & (idx > lo[:, None]) & (idx <= hi[:, None])
    return torch.where(m, state.log_bytes, 0).sum(dim=1, dtype=I32)


def rebase_fabric(fab: Fabric, delta) -> Fabric:
    """Shift the index columns of in-flight messages down by `delta` [N]
    (per source lane; a group rebases as a whole and delivery never leaves
    the group, so source deltas are destination deltas), floored at 0, on
    live cells only (fused._rebase_fabric). Takes and returns an int32
    fabric."""
    d = delta[:, None]

    def shift(x, live, dd=d):
        return torch.where(live, torch.clamp(x - dd, min=0), x)

    rep = fab.rep
    rep_live = rep.kind != NONE
    rep = dataclasses.replace(
        rep,
        index=shift(rep.index, rep_live),
        commit=shift(rep.commit, rep_live),
        reject_hint=shift(rep.reject_hint, rep_live),
        snap_index=shift(rep.snap_index, rep_live & (rep.snap_index > 0)),
    )
    hb = dataclasses.replace(fab.hb, commit=shift(fab.hb.commit, fab.hb.kind != NONE))
    vote = dataclasses.replace(fab.vote, index=shift(fab.vote.index, fab.vote.kind != NONE))
    self_ = dataclasses.replace(
        fab.self_, index=shift(fab.self_.index, fab.self_.kind != NONE, delta)
    )
    return dataclasses.replace(fab, rep=rep, hb=hb, vote=vote, self_=self_)


# --------------------------------------------------------------------------
# running rounds


def fused_rounds(
    state: RaftState,
    fab: Fabric,
    ops: LocalOps,
    mute,
    *,
    v: int,
    n_rounds: int,
    do_tick: bool = True,
    auto_propose: bool = False,
    auto_compact_lag: int | None = None,
    ops_first_round_only: bool = True,
    paged_inkernel: bool = False,
    metrics: metmod.MetricsState | None = None,
    chaos: chmod.ChaosState | None = None,
    paged: pgmod.PagedLog | None = None,
):
    """n_rounds fused rounds (raft_tpu/ops/fused.py fused_rounds without the
    straddle and trace planes). `ops` applies to the first round
    only unless ops_first_round_only=False. The carry enters and leaves in
    the slim storage dtypes, or packed when it comes packed
    (state.is_packed); each round widens to int32, routes, computes and
    narrows back across the same boundary (store_carry / load_carry when
    packed).

    paged: the paged entry log's sidecar (ops/paged.py); the state then
    holds the resident [N, W_res] tail, the full window is paged in after
    the store boundary, the rounds run on it unchanged, and it is paged out
    at the exit in place of the stale-slot scrub. With paged_inkernel
    (the twin of the pallas engine's in-kernel paging) page_in and
    page_out_cond run around every round instead, on the stored carry.

    chaos: the chaos carry (chaos/device.py); its faults apply around
    every round, begin_round after routing and end_round (given the
    outbox delivered this round) after the round, on the fat carry.
    Returns (state, fab[, metrics][, chaos][, paged])."""
    if chaos is not None and paged is not None:
        raise NotImplementedError(CHAOS_PAGED)
    load, store = carry_boundary(state)
    state, fab = store(state, fab)
    inkernel = paged is not None and paged_inkernel
    # allocator elision is sound only when every in-round log write lands
    # in the resident window (pgmod.page_out_cond)
    can_skip = inkernel and fab.rep.ent_term.shape[-1] <= paged.w_res
    if paged is not None and not inkernel:
        state, paged = pgmod.page_in(state, paged)
    peer_mute = aligned_peer_mute(mute, v) if mute is not None else None
    zero_ops = None
    for i in range(n_rounds):
        o = ops
        if ops_first_round_only and i > 0:
            if zero_ops is None:
                zero_ops = LocalOps(*(torch.zeros_like(x) for x in ops))
            o = zero_ops
        if inkernel:
            state, paged = pgmod.page_in(state, paged)
            last_pre, snap_pre = state.last.to(I32), state.snap_index.to(I32)
        st_fat, fb_fat = load(state, fab)
        inb = route_fabric(fb_fat, v, mute, peer_mute=peer_mute)
        tick_mask = None
        if chaos is not None:
            chaos, st_fat, inb, o, tick_mask = chmod.begin_round(chaos, st_fat, inb, o, v)
        res = fused_round(
            st_fat,
            inb,
            o,
            mute,
            peer_mute=peer_mute,
            do_tick=do_tick,
            auto_propose=auto_propose,
            auto_compact_lag=auto_compact_lag,
            tick_mask=tick_mask,
            metrics=metrics,
        )
        out_st, out_fb = res[0], res[1]
        if chaos is not None:
            chaos, out_fb = chmod.end_round(chaos, out_st, fb_fat, out_fb, v)
        state, fab = store(out_st, out_fb)
        if metrics is not None:
            metrics = res[2]
        if inkernel:
            state, paged = pgmod.page_out_cond(state, paged, last_pre, snap_pre,
                                               can_skip=can_skip)
    if paged is not None and not inkernel:
        state, paged = pgmod.page_out(state, paged)
    elif paged is None:
        # the JAX package leaves the same canonical zeros-outside-window layout
        state = lg.scrub_stale_slots(state)
    out = (state, fab)
    if metrics is not None:
        out += (metrics,)
    if chaos is not None:
        out += (chaos,)
    if paged is not None:
        out += (paged,)
    return out


# chaos with paging: the JAX kernel composes them (raft_tpu/ops/
# pallas_round.py:589-730); the port refuses them together by name
CHAOS_PAGED = ("the chaos plane with the paged entry log is not ported to "
               "raft_tpu_torch yet (ROADMAP Queue 2: chaos branch x in-kernel paging)")


class FusedCluster:
    """G raft groups x V voters on the fused round: canonical ids 1..V per
    group, group g on lanes [g*V, (g+1)*V). Runs on `cuda` unless the caller
    passes another `device` (`device="cpu"` runs the plain PyTorch path).

    metrics: keep the device metrics plane (on by default, as in the JAX
    package). diet: keep the carry in the diet-v2 packed layout between
    dispatches (state.pack_state / pack_fabric; off by default, as
    RAFT_TPU_DIET is in the JAX package), with the automatic rebase that
    keeps its uint16 index columns under DIET_REBASE_AT. paged: keep a
    resident tail of Shape.page_window entries per lane and the rest of
    the window in a page pool (ops/paged.py; off by default, as
    RAFT_TPU_PAGED is); paged_inkernel: page around every round instead of
    every dispatch (on the pallas engine one allocation segment per lane
    tile, the tile pinned here). chaos: keep the chaos plane
    (chaos/device.py; off by default, as RAFT_TPU_CHAOS is), its PRNG
    stream drawn from seed + chaos_seed (RAFT_TPU_CHAOS_SEED); its knobs
    are set with set_chaos, usually by a chaos/schedule.py ChaosRunner;
    chaos with paged raises NotImplementedError. engine: "xla"
    (default: the eager round of this module) or "pallas" (ops/pallas_round.py: K rounds per launch of the CUDA round
    kernel; tile_lanes, default pallas_round.default_tile, and
    rounds_per_call K, default 1, are checked here and raise TileError /
    ValueError). **cfg: LaneConfig overrides (election_tick, pre_vote, ...)."""

    def __init__(
        self,
        n_groups: int,
        n_voters: int,
        seed: int = 1,
        shape: Shape | None = None,
        learner_ids: tuple = (),
        *,
        device=None,
        metrics: bool = True,
        diet: bool = False,
        paged: bool = False,
        paged_inkernel: bool = False,
        chaos: bool = False,
        chaos_seed: int = 0,
        engine: str | None = None,
        tile_lanes: int | None = None,
        rounds_per_call: int | None = None,
        **cfg,
    ):
        from raft_tpu_torch.ops import pallas_round as plr

        for plane in PLANES_NOT_PORTED:
            if cfg.get(plane):
                raise NotImplementedError(
                    f"the {plane} plane is not ported to raft_tpu_torch yet (ROADMAP)"
                )
            cfg.pop(plane, None)
        self.device = resolve_device(device)
        self.g, self.v = n_groups, n_voters
        n = n_groups * n_voters
        self.shape = shape or Shape(n_lanes=n, max_peers=n_voters)
        if self.shape.n_lanes != n or self.shape.v != n_voters:
            raise ValueError("fused layout requires n_lanes=G*V, max_peers=V")
        ids = np.tile(np.arange(1, n_voters + 1, dtype=np.int32), n_groups)
        peers = np.broadcast_to(
            np.arange(1, n_voters + 1, dtype=np.int32), (n, n_voters)
        )
        is_learner = np.zeros((n, n_voters), bool)
        for lid in learner_ids:
            if not 1 <= lid <= n_voters:
                raise ValueError(f"learner id {lid} outside canonical 1..{n_voters}")
            is_learner[:, lid - 1] = True
        lane_cfg = make_lane_config(self.shape, self.device, **cfg)
        self.state = slim_state(
            init_state(
                self.shape, ids, peers, is_learner, seed=seed, cfg=lane_cfg,
                device=self.device,
            )
        )
        self.fab = slim_fabric(
            empty_fabric(n, n_voters, self.shape.max_msg_entries, self.device)
        )
        # diet-v2: the resident carry packs down to bitset masks and uint16
        # rebased indexes, and every round widens it on the device.
        # _diet_budget is the host-side headroom counter of the automatic
        # rebase (_diet_headroom); 0 forces a device read on the next run.
        self._diet = bool(diet)
        self._diet_budget = 0
        if self._diet:
            self.state = pack_state(self.state)
            self.fab = pack_fabric(self.fab)
        self.mute = torch.zeros((n,), dtype=BOOL, device=self.device)
        self._no_ops = no_ops(n, self.device)
        self.metrics = metmod.init_metrics(n, self.device) if metrics else None
        self._metrics_acc = CounterAccumulator() if metrics else None
        if chaos and paged:
            raise NotImplementedError(CHAOS_PAGED)
        self.chaos = (
            chmod.init_chaos(n, n_voters, seed, chaos_seed, device=self.device) if chaos else None
        )
        # round engine, resolved once here; a failing pallas launch raises
        # (no fallback to "xla")
        self.engine = plr.resolve_engine(engine)
        self._pallas_tile = self._pallas_rounds = None
        self._paged_inkernel = bool(paged and paged_inkernel)
        if self.engine == "pallas":
            self._pallas_rounds = self._resolve_pallas_rounds(rounds_per_call)
            self._pallas_tile = self._resolve_pallas_tile(tile_lanes)
        # the paged entry log: the plan is checked here (raise, never fall
        # back) and the full-window carry split into its resident tail and
        # the pool. _paged_segs is the allocation segments the host views
        # read the page ids under: 1, or one per lane tile when the pallas
        # engine pages in the kernel.
        self.paged = None
        self._paged_segs = 1
        if paged:
            plan = pgmod.validate_page_plan(self.shape, n)
            if self._paged_inkernel and self.engine == "pallas":
                self._paged_segs = n // self._pallas_tile
                pgmod.check_pool_segments(plan, self._paged_segs)
            self.state, self.paged = pgmod.split_state(self.state, plan, self._paged_segs)

    def run(
        self,
        rounds: int = 1,
        ops: LocalOps | None = None,
        do_tick: bool = True,
        auto_propose: bool = False,
        auto_compact_lag: int | None = None,
        ops_first_round_only: bool = True,
    ):
        if self._diet:  # may rebase the carry and the metrics' samples
            self._diet_headroom(rounds)
        kw = dict(
            v=self.v,
            n_rounds=rounds,
            do_tick=do_tick,
            auto_propose=auto_propose,
            auto_compact_lag=auto_compact_lag,
            ops_first_round_only=ops_first_round_only,
            paged_inkernel=self._paged_inkernel,
            metrics=self.metrics,
            chaos=self.chaos,
            paged=self.paged,
        )
        ops = self._no_ops if ops is None else ops
        if self.engine == "pallas":
            res = self._run_pallas(ops, **kw)
        else:
            res = fused_rounds(self.state, self.fab, ops, self.mute, **kw)
        self.state, self.fab = res[0], res[1]
        rest = list(res[2:])
        if self.metrics is not None:
            self.metrics = rest.pop(0)
        if self.chaos is not None:
            self.chaos = rest.pop(0)
        if self.paged is not None:
            self.paged = rest.pop(0)

    # -- pallas engine (ops/pallas_round.py) ------------------------------

    def _run_pallas(self, ops, **kw):
        """One dispatch on the round kernel: ceil(rounds / K) launches."""
        from raft_tpu_torch.ops import pallas_round as plr

        return plr.pallas_rounds(
            self.state, self.fab, ops, self.mute, tile_lanes=self._pallas_tile,
            rounds_per_call=self._pallas_rounds, **kw,
        )

    def _resolve_pallas_tile(self, tile_lanes: int | None) -> int:
        """The lane tile: tile_lanes, else default_tile (under in-kernel
        paging the engine's CUDA block, which is the tile there:
        pallas_round.paged_tile); TileError if it breaks the group
        alignment, or, in-kernel paging on the card, if the kernel cannot
        run it as one CUDA block."""
        from raft_tpu_torch.ops import pallas_round as plr

        n = self.shape.n_lanes
        if tile_lanes is not None:
            t = tile_lanes
        elif self._paged_inkernel:
            t = plr.paged_tile(self.shape)
        else:
            t = plr.default_tile(n, self.v)
        plr.check_tile(n, self.v, t)
        if self._paged_inkernel and self.device.type == "cuda":
            plr.check_paged_block(self.shape, t)
        return t

    def _resolve_pallas_rounds(self, rounds_per_call: int | None) -> int:
        """K: rounds_per_call, else 1; ValueError if out of range."""
        from raft_tpu_torch.ops import pallas_round as plr

        k = rounds_per_call if rounds_per_call is not None else 1
        plr.validate_round_plan(k)
        return k

    # -- index-space rebase and the diet-v2 automatic rebase ---------------

    def rebase_groups(self, groups, delta: int | None = None) -> dict:
        """Re-key the index space of whole groups down by a window-aligned
        delta (their smallest snap_index rounded down to W, or `delta`)
        while traffic is live: state and in-flight fabric shift together
        between dispatches. Returns {group: delta}. Negative deltas are
        allowed (tests fast-forward a batch toward an overflow guard)."""
        w = self.shape.w
        n = self.g * self.v
        snap = self.state.snap_index.cpu().numpy().astype(np.int64)
        deltas = np.zeros((n,), np.int32)
        mask = np.zeros((n,), bool)
        out = {}
        for g in groups:
            sl = slice(g * self.v, (g + 1) * self.v)
            d = delta if delta is not None else (int(snap[sl].min()) // w) * w
            if d == 0:
                continue
            if d % w:
                raise ValueError("rebase delta must be window-aligned")
            deltas[sl] = d
            mask[sl] = True
            out[g] = d
        if out:
            self._apply_rebase(mask, deltas)
        return out

    def _apply_rebase(self, mask, deltas):
        """Shift the carry's index space (ops/log.py rebase_indexes and
        rebase_fabric), the metrics plane's latency samples and the chaos
        plane's recovery baseline for the masked lanes. The shift runs on the int32 view: x - d floored at 0
        on a packed uint16 column would wrap first, so a packed carry is
        unpacked around it and packed again."""
        mj = torch.as_tensor(mask, device=self.device)
        dj = torch.as_tensor(deltas, device=self.device)
        carry = self.state
        if self.paged is not None:
            # the deltas are window-aligned, not page-key aligned: rebase the
            # full window, and let page_out's allocator rebuild the pool
            carry, self.paged = pgmod.page_in_host(carry, self.paged, self._paged_segs)
        st = slim_state(lg.rebase_indexes(unpack_state(carry), mj, dj))
        fb = slim_fabric(rebase_fabric(fat_fabric(unpack_fabric(self.fab)), dj))
        if is_packed(self.state):
            st, fb = pack_state(st), pack_fabric(fb)
        if self.paged is not None:
            st, self.paged = pgmod.page_out_host(st, self.paged, self._paged_segs)
        self.state, self.fab = st, fb
        # the index space moved under the headroom counter: re-read it
        self._diet_budget = 0
        if self.metrics is not None:
            self.metrics = metmod.rebase_samples(self.metrics, mj, dj)
        if self.chaos is not None:  # the recovery baseline moves with its lanes
            self.chaos = chmod.rebase(self.chaos, mj, dj)

    # Automatic-rebase threshold of the packed uint16 index columns: when
    # the largest index a dispatch could reach would cross it, every group
    # rebases down first. 48 Ki leaves 16 Ki under 2^16 (a whole
    # MAX_LOG_WINDOW) and lies far above what a test or bench run reaches.
    DIET_REBASE_AT = 48 * 1024

    def _diet_headroom(self, rounds: int):
        """Pre-dispatch overflow guard of the packed index columns. A
        dispatch grows any index by at most rounds * (E + 1) (E appended
        entries and one snapshot catch-up a round), so a host-side budget
        is spent by that bound each run and max(last) is read off the
        device only when the budget runs out."""
        grow = rounds * (self.shape.max_msg_entries + 1)
        if self._diet_budget > grow:
            self._diet_budget -= grow
            return
        mx = int(self.state.last.to(I32).max())
        if mx + grow >= self.DIET_REBASE_AT:
            self._rebase_all_groups()
            mx = int(self.state.last.to(I32).max())
        self._diet_budget = max(self.DIET_REBASE_AT - mx - grow, 0)

    def _rebase_all_groups(self):
        """The whole batch rebased at once: each group by its smallest
        snap_index rounded down to W, in one numpy pass."""
        w = self.shape.w
        snap = self.state.snap_index.cpu().numpy().astype(np.int64)
        d_g = (snap.reshape(self.g, self.v).min(axis=1) // w) * w
        deltas = np.repeat(d_g, self.v).astype(np.int32)
        mask = deltas != 0
        if mask.any():
            self._apply_rebase(mask, deltas)

    # -- host views of the carry ------------------------------------------

    def host_state(self) -> RaftState:
        """The carry as host readers see it: slim dtypes, absolute int32
        index columns, [N, V] bool masks and the full [N, W] log window,
        whether or not it is packed or paged (self.state may be diet-v2
        packed, and under paging holds the resident tail)."""
        carry = self.state
        if self.paged is not None:
            carry = pgmod.page_in_view(carry, self.paged, self._paged_segs)
        return unpack_state(carry)

    def adopt_state(self, st: RaftState):
        """Install a host-built (slim or fat, full-window) state as the
        carry, packed when the current carry is and split again under
        paging: the write-side twin of host_state."""
        st = pack_state(st) if is_packed(self.state) else slim_state(st)
        if self.paged is not None:
            st, self.paged = pgmod.page_out_host(st, self.paged, self._paged_segs)
        self.state = st

    def ops(self, **kw) -> LocalOps:
        """A LocalOps with the given per-lane columns set ({lane: value}
        dicts or full arrays)."""
        return make_local_ops(self.state.id.shape[0], self.device, **kw)

    def campaign(self, lane: int):
        self.run(1, ops=self.ops(hup={lane: True}), do_tick=False)

    def set_mute(self, lanes, on: bool = True):
        m = self.mute.clone()
        m[torch.as_tensor(np.asarray(lanes, dtype=np.int64), device=self.device)] = on
        self.mute = m

    def set_chaos(self, **cols):
        """Overwrite chaos knob columns (chaos/device.py SETTABLE): [N] /
        [N, V] arrays in this cluster's lane order, or scalars to
        broadcast. Needs chaos=True at construction."""
        if self.chaos is None:
            raise RuntimeError("chaos plane is off: construct with chaos=True")
        self.chaos = chmod.with_columns(self.chaos, **cols)

    def chaos_columns(self, *names) -> dict:
        """Chaos columns as numpy (default: chaos/device.py PROBE_FIELDS);
        an empty dict when the plane is off."""
        if self.chaos is None:
            return {}
        names = names or chmod.PROBE_FIELDS
        return {k: getattr(self.chaos, k).cpu().numpy() for k in names}

    # -- inspection -------------------------------------------------------

    def metrics_snapshot(self) -> dict | None:
        """Pull the device counters and fold them into exact int64 totals;
        None when the metrics plane is off."""
        if self.metrics is None:
            return None
        m = self.metrics
        self._metrics_acc.pull(
            m.counters.cpu().numpy(), m.hist.cpu().numpy(),
            int(m.lat_sum), int(m.round_ctr),
        )
        snap = self._metrics_acc.snapshot()
        # the paged pool's pressure rides the same snapshot
        snap["counters"].update(self.paged_stats() or {})
        return snap

    def paged_stats(self) -> dict | None:
        """Pool occupancy and the paged counters' sums (ops/paged.py
        paged_stats; None without paging), mirrored onto the host plane
        (metrics/host.py PAGED_COUNTERS). One device read: call it at host
        sync points, not per dispatch."""
        if self.paged is None:
            return None
        from raft_tpu_torch.metrics.host import record_paged_stats

        stats = pgmod.paged_stats(self.paged)
        record_paged_stats(stats)
        return stats

    def leader_lanes(self) -> np.ndarray:
        return np.nonzero(self.state.state.cpu().numpy() == int(StateType.LEADER))[0]

    def state_columns(self, *names) -> dict:
        """Host numpy copies of the named state columns, read through
        host_state (packed columns widen to absolute int32 / [N, V] bool)."""
        st = self.host_state()
        return {name: getattr(st, name).cpu().numpy() for name in names}

    def check_no_errors(self):
        bits = self.state.error_bits.cpu().numpy()
        if self.paged is not None and (bits & pgmod.ERR_PAGE_EXHAUSTED).any():
            self.paged_stats()  # the exhaustion counter and its warning first
        if (bits != 0).any():
            raise AssertionError(f"error_bits set: lanes {np.nonzero(bits)[0].tolist()}")
