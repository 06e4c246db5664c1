"""The step handlers the fused round reuses (raft_tpu/ops/step.py).

Per-lane control flow is a lane mask: each handler is a no-op on the lanes
it does not select. Handlers emit messages through an outbox object with
the `put_peers` / `put_self` / `put_reply` protocol; the fused round passes
its channel fabric (ops/fused.py ChannelOutbox). The serial engine's own
outbox and `step` are not part of this package.
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch.messages import MsgBatch
from raft_tpu_torch.ops import log as lg
from raft_tpu_torch.ops import onehot as ohm
from raft_tpu_torch.ops import progress as pg
from raft_tpu_torch.state import RaftState, draw_timeout, rng_next, where_u32
from raft_tpu_torch.types import (
    CampaignType,
    MessageType as MT,
    ProgressState,
    StateType,
    VoteState,
)

I32 = torch.int32


def _w(mask, new, old):
    return torch.where(mask, new, old)


def voter_mask(state: RaftState):
    """[N, V] union of incoming+outgoing voter sets."""
    return state.voters_in | state.voters_out


def peer_present(state: RaftState):
    return state.prs_id != 0


def find_slot(state: RaftState, ids):
    """Peer slot [N] of raft id `ids` [N]; -1 when absent (id 0 never
    resolves)."""
    hit = (state.prs_id == ids[:, None]) & (state.prs_id != 0)
    slot = ohm.argmax_last(hit)
    return torch.where(hit.any(dim=1), slot, -1)


def self_slot(state: RaftState):
    return find_slot(state, state.id)


def _is_self(state: RaftState):
    v = state.prs_id.shape[1]
    return ohm.iota(v, state.prs_id.device)[None, :] == self_slot(state)[:, None]


def promotable(state: RaftState):
    """raft.go:1962-1966: self tracked, not a learner, no pending snapshot."""
    ss = self_slot(state)
    is_lr = ohm.gather(state.learners, torch.clamp(ss, min=0))
    return (ss >= 0) & ~is_lr & (state.pending_snap_index == 0)


def has_unapplied_conf_changes(state: RaftState):
    """Conf-change entries in (applied, committed] (raft.go:963-989)."""
    idx, valid = lg.window_indexes(state)
    inrange = valid & (idx > state.applied[:, None]) & (idx <= state.committed[:, None])
    return (inrange & (state.log_type != 0)).any(dim=1)


# --------------------------------------------------------------------------
# state transitions (reference: raft.go:760-939)


def reset(state: RaftState, mask, term) -> RaftState:
    """raft.go:760-790."""
    term_changed = mask & (state.term != term)
    rng = where_u32(mask, rng_next(state.rng), state.rng)
    rand_to = draw_timeout(rng, state.cfg.election_tick)
    m1 = mask[:, None]
    present = peer_present(state)
    is_self = _is_self(state)

    state = dataclasses.replace(
        state,
        term=_w(mask, term, state.term),
        vote=_w(term_changed, 0, state.vote),
        lead=_w(mask, 0, state.lead),
        election_elapsed=_w(mask, 0, state.election_elapsed),
        heartbeat_elapsed=_w(mask, 0, state.heartbeat_elapsed),
        rng=rng,
        randomized_election_timeout=_w(mask, rand_to, state.randomized_election_timeout),
        lead_transferee=_w(mask, 0, state.lead_transferee),
        votes=_w(m1, int(VoteState.PENDING), state.votes),
        pending_conf_index=_w(mask, 0, state.pending_conf_index),
        uncommitted_size=_w(mask, 0, state.uncommitted_size),
        # the readOnly queue is recreated on reset (raft.go:782); the
        # pending-read-index slots (pri_*) are not
        ro_ctx=_w(m1, 0, state.ro_ctx),
        ro_from=_w(m1, 0, state.ro_from),
        ro_index=_w(m1, 0, state.ro_index),
        ro_acks=_w(mask[:, None, None], False, state.ro_acks),
        ro_seq=_w(m1, 0, state.ro_seq),
        ro_next_seq=_w(mask, 1, state.ro_next_seq),
    )
    # progress reset for every tracked peer (self keeps Match=lastIndex)
    sel = m1 & present
    state = pg.reset_state(state, sel, ProgressState.PROBE)
    return dataclasses.replace(
        state,
        pr_match=_w(sel, torch.where(is_self, state.last[:, None], 0), state.pr_match),
        pr_next=_w(sel, state.last[:, None] + 1, state.pr_next),
        pr_recent_active=_w(sel, False, state.pr_recent_active),
    )


def become_follower(state: RaftState, mask, term, lead) -> RaftState:
    """raft.go:864-871."""
    state = reset(state, mask, term)
    return dataclasses.replace(
        state,
        lead=_w(mask, lead, state.lead),
        state=_w(mask, int(StateType.FOLLOWER), state.state),
    )


def become_candidate(state: RaftState, mask) -> RaftState:
    """raft.go:873-884."""
    state = reset(state, mask, state.term + mask.to(I32))
    return dataclasses.replace(
        state,
        vote=_w(mask, state.id, state.vote),
        state=_w(mask, int(StateType.CANDIDATE), state.state),
    )


def become_pre_candidate(state: RaftState, mask) -> RaftState:
    """raft.go:886-899: role/votes/lead only; term and vote are kept."""
    return dataclasses.replace(
        state,
        votes=_w(mask[:, None], int(VoteState.PENDING), state.votes),
        lead=_w(mask, 0, state.lead),
        state=_w(mask, int(StateType.PRE_CANDIDATE), state.state),
    )


def append_entry(state: RaftState, mask, ent_term, ent_type, ent_bytes, n_ents, out):
    """Leader local append + self-ack (raft.go:791-822); entry terms are
    stamped with the lane's term. Returns (state, accepted [N])."""
    # uncommitted-size gate (raft.go:2033-2047)
    sz = ent_bytes.sum(dim=-1, dtype=I32)
    refuse = (
        (state.uncommitted_size > 0)
        & (sz > 0)
        & (state.uncommitted_size + sz > state.cfg.max_uncommitted_size)
    )
    # window capacity is a device-only constraint: dropping a proposal is
    # always safe (ErrProposalDropped semantics)
    w = state.log_term.shape[-1]
    ok = mask & ~refuse & (state.last + n_ents - state.snap_index <= w)
    state = dataclasses.replace(
        state,
        uncommitted_size=_w(ok, state.uncommitted_size + sz, state.uncommitted_size),
    )
    stamped = state.term[:, None].expand(ent_term.shape)
    state = lg.append(
        state, state.last, stamped, ent_type, ent_bytes, torch.where(ok, n_ents, 0)
    )
    out.put_self(ok, type=int(MT.MSG_APP_RESP), term=state.term, index=state.last)
    return state, ok


def become_leader(state: RaftState, mask, out) -> RaftState:
    """raft.go:901-939."""
    state = reset(state, mask, state.term)
    sel_self = mask[:, None] & _is_self(state)
    state = dataclasses.replace(
        state,
        lead=_w(mask, state.id, state.lead),
        state=_w(mask, int(StateType.LEADER), state.state),
        pending_conf_index=_w(mask, state.last, state.pending_conf_index),
    )
    state = pg.become_replicate(state, sel_self)
    state = dataclasses.replace(
        state, pr_recent_active=_w(sel_self, True, state.pr_recent_active)
    )
    # append the empty entry at the new term (payload size 0)
    zeros = torch.zeros((out.n, out.e), dtype=I32, device=mask.device)
    state, _ = append_entry(state, mask, zeros, zeros, zeros, mask.to(I32), out)
    return state


# --------------------------------------------------------------------------
# sending (reference: raft.go:589-715)


def maybe_send_append(state: RaftState, sel, send_if_empty, out) -> RaftState:
    """Append/snapshot fan-out for the selected [N, V] cells
    (raft.go:600-666). Never selects the self slot."""
    sel = sel & peer_present(state) & ~_is_self(state) & ~pg.is_paused(state)

    prev = state.pr_next - 1  # [N, V]
    prev_term = lg.term_at(state, prev)
    # entries availability (a throttled replicate sends empty)
    throttled = (state.pr_state == ProgressState.REPLICATE) & pg.inflights_full(state)
    n_avail = torch.clamp(state.last[:, None] - prev, min=0)
    e = out.e
    n_send = torch.where(throttled, 0, torch.clamp(n_avail, max=e))

    # gather entry columns per peer, contiguous from pr_next: [N, V, E]
    w = state.log_term.shape[-1]
    slot0 = state.pr_next & (w - 1)
    k = ohm.iota(e, sel.device)
    ent_term, ent_type, ent_bytes = ohm.gather_range_multi(
        [state.log_term, state.log_type, state.log_bytes], slot0, e
    )
    validk = k < n_send.unsqueeze(-1)
    ent_bytes = torch.where(validk, ent_bytes, 0)
    # byte budget: trim to max_size_per_msg, always keeping >= 1 entry
    # (util.go:266 limitSize)
    within = ohm.cumsum_last(ent_bytes) <= state.cfg.max_size_per_msg[:, None, None]
    n_fit = within.sum(dim=-1, dtype=I32)
    n_send = torch.where(
        n_send > 0, torch.clamp(torch.minimum(n_send, n_fit), 1, e), 0
    )
    validk = k < n_send.unsqueeze(-1)
    ent_term = torch.where(validk, ent_term, 0)
    ent_type = torch.where(validk, ent_type, 0)
    ent_bytes = torch.where(validk, ent_bytes, 0)

    sie = torch.as_tensor(send_if_empty, dtype=torch.bool, device=sel.device)
    if sie.dim() == 1:
        sie = sie[:, None]
    sel = sel & ((n_send > 0) | sie)

    # snapshot path: predecessor compacted away (raft.go:625-649); the
    # snapshot sent is the application's latest (avail_snap_*), and a
    # deferred Storage.Snapshot() (snap_unavailable) skips the send
    need_snap = prev < state.snap_index[:, None]
    snap_sel = sel & need_snap & state.pr_recent_active & ~state.snap_unavailable[:, None]
    app_sel = sel & ~need_snap

    has_avail = state.avail_snap_index != 0
    send_si = torch.where(has_avail, state.avail_snap_index, state.snap_index)
    send_st = torch.where(has_avail, state.avail_snap_term, state.snap_term)
    state = pg.become_snapshot(state, snap_sel, send_si[:, None].expand(prev.shape))
    out.put_peers(
        snap_sel,
        type=int(MT.MSG_SNAP),
        term=state.term[:, None],
        snap_index=send_si[:, None],
        snap_term=send_st[:, None],
    )
    out.put_peers(
        app_sel,
        type=int(MT.MSG_APP),
        term=state.term[:, None],
        index=prev,
        log_term=prev_term,
        commit=state.committed[:, None],
        n_ents=n_send,
        ent_term=ent_term,
        ent_type=ent_type,
        ent_bytes=ent_bytes,
    )
    sent_bytes = ent_bytes.sum(dim=-1, dtype=I32)
    return pg.update_on_entries_send(state, app_sel, n_send, sent_bytes)


def bcast_heartbeat(state: RaftState, mask, out, ctx=None) -> RaftState:
    """raft.go:668-686, 708-715: commit capped at min(match, committed);
    `ctx` [N] rides ReadIndex broadcasts."""
    sel = mask[:, None] & peer_present(state) & ~_is_self(state)
    commit = torch.minimum(state.pr_match, state.committed[:, None])
    if ctx is None:
        ctx = torch.zeros_like(state.term)
    out.put_peers(
        sel,
        type=int(MT.MSG_HEARTBEAT),
        term=state.term[:, None],
        commit=commit,
        context=ctx[:, None],
    )
    return state


def campaign(state: RaftState, mask, ctype, out) -> RaftState:
    """raft.go:993-1039. ctype: [N] CampaignType."""
    pre = mask & (ctype == CampaignType.PRE_ELECTION)
    real = mask & (ctype != CampaignType.PRE_ELECTION)
    state = become_pre_candidate(state, pre)
    state = become_candidate(state, real)
    # PreVote asks for the next term without bumping ours
    ask_term = torch.where(pre, state.term + 1, state.term)
    vote_t = torch.where(pre, int(MT.MSG_PRE_VOTE), int(MT.MSG_VOTE)).to(I32)
    resp_t = torch.where(pre, int(MT.MSG_PRE_VOTE_RESP), int(MT.MSG_VOTE_RESP)).to(I32)
    is_self = _is_self(state)
    voters = voter_mask(state)
    # self-vote response, queued after the vote is durable
    out.put_self(
        mask & (voters & is_self).any(dim=1), type=resp_t, term=ask_term
    )
    out.put_peers(
        mask[:, None] & voters & ~is_self,
        type=vote_t[:, None],
        term=ask_term[:, None],
        index=state.last[:, None],
        log_term=lg.last_term(state)[:, None],
        context=torch.where(
            ctype == CampaignType.TRANSFER, int(CampaignType.TRANSFER), 0
        ).to(I32)[:, None],
    )
    return state


def hup(state: RaftState, mask, ctype, out):
    """raft.go:941-961. Returns (state, fired [N]): the lanes that really
    campaigned after the promotable / pending-conf-change gates."""
    ok = (
        mask
        & (state.state != StateType.LEADER)
        & promotable(state)
        & ~has_unapplied_conf_changes(state)
    )
    return campaign(state, ok, ctype, out), ok


# --------------------------------------------------------------------------
# follower-side handlers (reference: raft.go:1732-1795)


def handle_append_entries(state: RaftState, mask, msg: MsgBatch, out) -> RaftState:
    stale = mask & (msg.index < state.committed)
    out.put_reply(
        stale, to=msg.frm, type=int(MT.MSG_APP_RESP), term=state.term,
        index=state.committed,
    )
    live = mask & ~stale
    state, lastnewi, ok = lg.maybe_append(
        state,
        torch.where(live, msg.index, -1),
        msg.log_term,
        msg.commit,
        msg.ent_term,
        msg.ent_type,
        msg.ent_bytes,
        torch.where(live, msg.n_ents, 0),
    )
    out.put_reply(
        live & ok, to=msg.frm, type=int(MT.MSG_APP_RESP), term=state.term,
        index=lastnewi,
    )
    hint_i, hint_t = lg.find_conflict_by_term(
        state, torch.minimum(msg.index, state.last), msg.log_term
    )
    out.put_reply(
        live & ~ok,
        to=msg.frm,
        type=int(MT.MSG_APP_RESP),
        term=state.term,
        index=msg.index,
        reject=True,
        reject_hint=hint_i,
        log_term=hint_t,
    )
    return state


def handle_heartbeat(state: RaftState, mask, msg: MsgBatch, out) -> RaftState:
    state = lg.commit_to(state, torch.where(mask, msg.commit, 0))
    out.put_reply(
        mask, to=msg.frm, type=int(MT.MSG_HEARTBEAT_RESP), term=state.term,
        context=msg.context,
    )
    return state


def handle_snapshot(state: RaftState, mask, msg: MsgBatch, out) -> RaftState:
    """raft.go:1777-1795 + restore at 1799-1879; config adoption from the
    snapshot's ConfState is host-side, the device does the log surgery
    and the ack."""
    sidx, sterm = msg.snap_index, msg.snap_term
    stale = mask & (sidx <= state.committed)
    # fast-forward: we already have the entry; just commit to it
    ff = mask & ~stale & lg.match_term(state, sidx, sterm)
    state = lg.commit_to(state, torch.where(ff, sidx, 0))
    out.put_reply(
        stale | ff, to=msg.frm, type=int(MT.MSG_APP_RESP), term=state.term,
        index=state.committed,
    )
    doit = mask & ~stale & ~ff & (state.state == StateType.FOLLOWER)
    state = lg.restore_snapshot(state, sidx, sterm, doit)
    out.put_reply(
        doit, to=msg.frm, type=int(MT.MSG_APP_RESP), term=state.term,
        index=state.last,
    )
    return state
