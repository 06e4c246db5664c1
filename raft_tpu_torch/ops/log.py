"""Batched log-window ops (raft_tpu/ops/log.py).

The reference's raftLog cursors, unstable tail and stable Storage
(log.go:24-63, log_unstable.go:33-50, storage.go:46-90) collapse into one
circular columnar window per lane:

    entry index i lives at slot i & (W-1), valid when snap_index < i <= last

with snap_index <= applied <= applying <= committed <= last. Where the
reference panics, the lane sets a bit in `state.error_bits` and the update
is clamped to a no-op.
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch.ops import onehot as oh
from raft_tpu_torch.state import RaftState

I32 = torch.int32

# error_bits flags (see RaftState.error_bits)
ERR_COMMIT_OUT_OF_RANGE = 1  # reference log.go:319-324 panic
ERR_CONFLICT_BELOW_COMMIT = 2  # reference log.go:118-120 panic
ERR_APPEND_BELOW_COMMIT = 4  # reference log.go:135-137 panic
ERR_WINDOW_OVERFLOW = 8  # no reference analog: device window capacity
ERR_APPLIED_OUT_OF_RANGE = 16  # reference log.go:328-331 panic
ERR_INDEX_NEAR_OVERFLOW = 32  # int32 indexes approaching 2^31
INDEX_OVERFLOW_MARGIN = 1 << 30
_BIG = 2**31 - 1


def scrub_stale_slots(state: RaftState) -> RaftState:
    """Zero every log slot outside the live window (idx <= snap_index), the
    canonical layout both packages leave at the end of a dispatch. Works on
    slim columns (mask math in int32, column dtypes kept)."""
    n, w = state.log_term.shape
    s = oh.iota(w, state.log_term.device)
    last = state.last.to(I32)[:, None]
    idx = last - ((last - s) & (w - 1))
    stale = idx <= state.snap_index.to(I32)[:, None]

    def z(col):
        return torch.where(stale, torch.zeros((), dtype=col.dtype, device=col.device), col)

    return dataclasses.replace(
        state,
        log_term=z(state.log_term),
        log_type=z(state.log_type),
        log_bytes=z(state.log_bytes),
    )


def _err(state: RaftState, cond, bit: int) -> RaftState:
    return dataclasses.replace(
        state, error_bits=state.error_bits | torch.where(cond, bit, 0).to(I32)
    )


def slot_of(state: RaftState, idx):
    w = state.log_term.shape[-1]
    return idx & (w - 1)


def window_indexes(state: RaftState):
    """Per-slot entry index and validity, [N, W] each: slot s holds index
    first + ((s - first) mod W), valid when <= last."""
    n, w = state.log_term.shape
    s = oh.iota(w, state.log_term.device)
    first = state.first_index[:, None]
    idx = first + ((s - first) & (w - 1))
    valid = idx <= state.last[:, None]
    return idx, valid


def _lanes(x, ndim: int):
    """[N] per-lane cursor -> broadcastable against a [N, ...] of ndim."""
    return x.reshape(x.shape + (1,) * (ndim - 1))


def _mask_terms(state: RaftState, idx, raw):
    """Term lookup boundary rules (log.go:380-404): 0 outside the window,
    the compaction point's own term is known, and a pending snapshot
    answers its index."""
    d = idx.dim()
    snap_i = _lanes(state.snap_index, d)
    in_window = (idx > snap_i) & (idx <= _lanes(state.last, d))
    t = torch.where(in_window, raw, 0)
    t = torch.where(idx == snap_i, _lanes(state.snap_term, d), t)
    pend_i = _lanes(state.pending_snap_index, d)
    return torch.where(
        (pend_i > 0) & (idx == pend_i), _lanes(state.pending_snap_term, d), t
    )


def term_at(state: RaftState, idx):
    """Term of entry `idx` per lane; 0 when unknown. idx: [N] or [N, K]."""
    raw = oh.gather(state.log_term, slot_of(state, idx))
    return _mask_terms(state, idx, raw)


def last_term(state: RaftState):
    return term_at(state, state.last)


def terms_range(state: RaftState, start, e: int):
    """term_at for the contiguous indexes start..start+e-1 ([N] -> [N, e])."""
    idx = start[:, None] + oh.iota(e, start.device)
    raw = oh.gather_range(state.log_term, slot_of(state, start), e)
    return _mask_terms(state, idx, raw)


def match_term(state: RaftState, idx, term):
    """log.go:435-441 (a real entry's term is never 0, so 0 == 0 matches
    only the empty-log base case)."""
    return term_at(state, idx) == term


def commit_to(state: RaftState, tocommit) -> RaftState:
    """log.go:317-325: never decrease; past last is corruption."""
    bad = tocommit > state.last
    state = _err(state, (tocommit > state.committed) & bad, ERR_COMMIT_OUT_OF_RANGE)
    new_commit = torch.maximum(state.committed, torch.minimum(tocommit, state.last))
    return dataclasses.replace(state, committed=new_commit)


def maybe_commit(state: RaftState, max_index, term):
    """log.go:447-456: commit only entries of the given (current) term."""
    ok = (
        (max_index > state.committed)
        & (term != 0)
        & (term_at(state, max_index) == term)
    )
    state = commit_to(state, torch.where(ok, max_index, 0))
    return state, ok


def applied_to(state: RaftState, idx) -> RaftState:
    """log.go:327-341."""
    bad = (state.committed < idx) | (idx < state.applied)
    idx = torch.minimum(torch.maximum(idx, state.applied), state.committed)
    state = _err(state, bad, ERR_APPLIED_OUT_OF_RANGE)
    return dataclasses.replace(
        state, applied=idx, applying=torch.maximum(state.applying, idx)
    )


def append(state: RaftState, prev_index, ent_term, ent_type, ent_bytes, n_ents) -> RaftState:
    """Truncate at prev_index and append (log.go:131-141 +
    log_unstable.go:196-218): entries cover (prev_index, prev_index+n_ents].
    ent_*: [N, E]; n_ents: [N] (0 = no-op). Overflowing the window clamps
    the lane to a no-op and sets ERR_WINDOW_OVERFLOW."""
    n, w = state.log_term.shape
    e = ent_term.shape[-1]
    act = n_ents > 0

    state = _err(state, act & (prev_index < state.committed), ERR_APPEND_BELOW_COMMIT)
    overflow = act & (prev_index + n_ents - state.snap_index > w)
    state = _err(state, overflow, ERR_WINDOW_OVERFLOW)
    ok = act & (prev_index >= state.committed) & ~overflow

    write = ok[:, None] & (oh.iota(e, ok.device) < n_ents[:, None])
    slot0 = slot_of(state, prev_index + 1)
    new_term, new_type, new_bytes = oh.scatter_range_set_multi(
        [state.log_term, state.log_type, state.log_bytes],
        slot0,
        [ent_term, ent_type, ent_bytes],
        write,
    )

    new_last = torch.where(ok, prev_index + n_ents, state.last)
    state = _err(state, ok & (new_last >= INDEX_OVERFLOW_MARGIN), ERR_INDEX_NEAR_OVERFLOW)
    return dataclasses.replace(
        state,
        log_term=new_term,
        log_type=new_type,
        log_bytes=new_bytes,
        last=new_last,
        stabled=torch.where(ok, torch.minimum(state.stabled, prev_index), state.stabled),
        applying=torch.minimum(state.applying, new_last),
    )


def find_conflict(state: RaftState, prev_index, ent_term, n_ents):
    """First offered index whose term mismatches ours, 0 when we hold them
    all (log.go:143-165)."""
    e = ent_term.shape[-1]
    k = oh.iota(e, prev_index.device)
    idx = prev_index[:, None] + 1 + k
    valid = k < n_ents[:, None]
    mism = valid & (terms_range(state, prev_index + 1, e) != ent_term)
    ci = torch.where(mism, idx, _BIG).amin(dim=-1)
    return torch.where(ci == _BIG, 0, ci)


def maybe_append(state: RaftState, index, log_term, committed, ent_term, ent_type, ent_bytes, n_ents):
    """The follower append path (log.go:107-129). Returns (state,
    lastnewi [N], ok [N])."""
    ok = match_term(state, index, log_term)
    lastnewi = index + n_ents
    ci = find_conflict(state, index, ent_term, n_ents)
    state = _err(state, ok & (ci != 0) & (ci <= state.committed), ERR_CONFLICT_BELOW_COMMIT)

    # shift the entry columns left by (ci - index - 1) so entry ci lands first
    shift = torch.where(ci > 0, ci - index - 1, 0)
    e = ent_term.shape[-1]
    sh_term, sh_type, sh_bytes = oh.gather_range_multi(
        [ent_term, ent_type, ent_bytes], shift, e
    )
    n_keep = torch.where(ok & (ci > 0), n_ents - shift, 0)
    state = append(state, torch.where(ci > 0, ci - 1, 0), sh_term, sh_type, sh_bytes, n_keep)
    state = commit_to(state, torch.where(ok, torch.minimum(committed, lastnewi), 0))
    return state, torch.where(ok, lastnewi, 0), ok


def find_conflict_by_term(state: RaftState, index, term):
    """Rollback point for rejected appends (log.go:166-194): the max
    i <= index whose term is <= `term` or unknown. Returns (idx, term-or-0)."""
    idx_w, valid_w = window_indexes(state)
    cand = valid_w & (idx_w <= index[:, None]) & (state.log_term <= term[:, None])
    best_w = torch.where(cand, idx_w, -1).amax(dim=-1)
    snap_ok = (state.snap_index <= index) & (state.snap_term <= term)
    best = torch.maximum(best_w, torch.where(snap_ok, state.snap_index, -1))
    above = index > state.last
    best = torch.where(above, index, best)
    below = torch.minimum(index, state.snap_index - 1)
    best = torch.where(best < 0, torch.clamp(below, min=0), best)
    best = torch.clamp(best, min=0)
    t = torch.where(above, 0, term_at(state, best))
    return best, t


def rebase_indexes(state: RaftState, mask, delta) -> RaftState:
    """Host-driven index re-keying, the recovery path for the int32 index
    space: subtract `delta` [N] (a multiple of W, so slot positions hold)
    from every index-valued field of masked lanes. Sentinel-zero fields
    shift only where set; pr_match/pr_next clamp at their floors. Clears
    ERR_INDEX_NEAR_OVERFLOW; a delta that is not a multiple of W is flagged."""
    w = state.log_term.shape[-1]
    d = torch.where(mask, delta, 0)
    dv = d[:, None]

    def sub(x, floor=0):
        return torch.clamp(x - d, min=floor)

    def sub_nv(x, floor=0):
        return torch.clamp(x - dv, min=floor)

    def sub_if(x, live, dd):
        return torch.where(live, torch.clamp(x - dd, min=0), x)

    state = dataclasses.replace(
        state,
        last=sub(state.last),
        stabled=sub(state.stabled),
        committed=sub(state.committed),
        applying=sub(state.applying),
        applied=sub(state.applied),
        snap_index=sub(state.snap_index),
        pending_snap_index=sub_if(state.pending_snap_index, state.pending_snap_index > 0, d),
        avail_snap_index=sub_if(state.avail_snap_index, state.avail_snap_index > 0, d),
        pending_conf_index=sub_if(state.pending_conf_index, state.pending_conf_index > 0, d),
        pr_match=sub_nv(state.pr_match),
        pr_next=sub_nv(state.pr_next, 1),
        pr_pending_snapshot=sub_if(state.pr_pending_snapshot, state.pr_pending_snapshot > 0, dv),
        infl_index=sub_if(state.infl_index, state.infl_index > 0, dv[..., None]),
        ro_index=sub_if(state.ro_index, state.ro_ctx != 0, dv),
        rs_index=sub_if(state.rs_index, state.rs_ctx != 0, dv),
        error_bits=torch.where(
            mask, state.error_bits & ~ERR_INDEX_NEAR_OVERFLOW, state.error_bits
        ),
    )
    return _err(state, mask & ((delta & (w - 1)) != 0), ERR_COMMIT_OUT_OF_RANGE)


def compact(state: RaftState, to_index, to_term) -> RaftState:
    """Move the snapshot point forward (storage.go:251-272); the caller
    passes to_index <= applied and its term."""
    ok = (to_index > state.snap_index) & (to_index <= state.applied)
    return dataclasses.replace(
        state,
        snap_index=torch.where(ok, to_index, state.snap_index),
        snap_term=torch.where(ok, to_term, state.snap_term),
    )


def restore_snapshot(state: RaftState, idx, term, mask) -> RaftState:
    """Follower adopting a leader snapshot (log.go:458-462 +
    log_unstable.go:188-194): wipe the log view, set commit, and stage the
    snapshot as pending."""
    m1 = mask[:, None]
    return dataclasses.replace(
        state,
        log_term=torch.where(m1, 0, state.log_term),
        log_type=torch.where(m1, 0, state.log_type),
        log_bytes=torch.where(m1, 0, state.log_bytes),
        last=torch.where(mask, idx, state.last),
        stabled=torch.where(mask, idx, state.stabled),
        committed=torch.where(mask, idx, state.committed),
        snap_index=torch.where(mask, idx, state.snap_index),
        snap_term=torch.where(mask, term, state.snap_term),
        pending_snap_index=torch.where(mask, idx, state.pending_snap_index),
        pending_snap_term=torch.where(mask, term, state.pending_snap_term),
        applying=torch.where(mask, torch.minimum(state.applying, idx), state.applying),
        applied=torch.where(mask, torch.minimum(state.applied, idx), state.applied),
    )
