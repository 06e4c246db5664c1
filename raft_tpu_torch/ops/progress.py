"""Per-peer progress + inflights as [N, V] / [N, V, F] elementwise updates
(raft_tpu/ops/progress.py; reference tracker/progress.go:30-98,
tracker/state.go:20-34, tracker/inflights.go:28-143).

Every function takes a `sel [N, V]` bool mask naming the (lane, peer-slot)
cells it applies to — the batched form of the reference's per-Progress
method calls.
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch.ops import onehot as oh
from raft_tpu_torch.state import RaftState
from raft_tpu_torch.types import ProgressState

I32 = torch.int32


def reset_state(state: RaftState, sel, to_state) -> RaftState:
    """tracker/progress.go:100-107 ResetState: clears the pause flag, the
    pending snapshot and the inflight window."""
    return dataclasses.replace(
        state,
        pr_state=torch.where(sel, int(to_state), state.pr_state),
        pr_msg_app_flow_paused=torch.where(sel, False, state.pr_msg_app_flow_paused),
        pr_pending_snapshot=torch.where(sel, 0, state.pr_pending_snapshot),
        infl_start=torch.where(sel, 0, state.infl_start),
        infl_count=torch.where(sel, 0, state.infl_count),
        infl_total_bytes=torch.where(sel, 0, state.infl_total_bytes),
    )


def become_probe(state: RaftState, sel) -> RaftState:
    """tracker/progress.go:109-123: from Snapshot resume above the pending
    snapshot, otherwise from Match+1."""
    from_snap = sel & (state.pr_state == ProgressState.SNAPSHOT)
    next_ = torch.where(
        from_snap,
        torch.maximum(state.pr_match + 1, state.pr_pending_snapshot + 1),
        state.pr_match + 1,
    )
    state = reset_state(state, sel, ProgressState.PROBE)
    return dataclasses.replace(state, pr_next=torch.where(sel, next_, state.pr_next))


def become_replicate(state: RaftState, sel) -> RaftState:
    """tracker/progress.go:125-129."""
    state = reset_state(state, sel, ProgressState.REPLICATE)
    return dataclasses.replace(
        state, pr_next=torch.where(sel, state.pr_match + 1, state.pr_next)
    )


def become_snapshot(state: RaftState, sel, snapshot_index) -> RaftState:
    """tracker/progress.go:131-136."""
    state = reset_state(state, sel, ProgressState.SNAPSHOT)
    return dataclasses.replace(
        state,
        pr_pending_snapshot=torch.where(sel, snapshot_index, state.pr_pending_snapshot),
    )


def inflights_full(state: RaftState):
    """[N, V] bool. tracker/inflights.go:129-133."""
    f = state.infl_index.shape[-1]
    cap = torch.clamp(state.cfg.max_inflight[:, None], max=f)
    cap_hit = state.infl_count >= cap
    max_bytes = state.cfg.max_inflight_bytes[:, None]
    bytes_hit = (max_bytes != 0) & (state.infl_total_bytes >= max_bytes)
    return cap_hit | bytes_hit


def inflights_add(state: RaftState, sel, index, bytes_) -> RaftState:
    """Record one in-flight MsgApp (index, bytes) for selected cells
    (tracker/inflights.go:61-80); full cells are clamped to no-ops."""
    f = state.infl_index.shape[-1]
    sel = sel & ~inflights_full(state)
    pos = (state.infl_start + state.infl_count) % f  # [N, V]
    put = sel.unsqueeze(-1) & oh.onehot(pos, f)
    return dataclasses.replace(
        state,
        infl_index=torch.where(put, index.unsqueeze(-1), state.infl_index),
        infl_bytes=torch.where(put, bytes_.unsqueeze(-1), state.infl_bytes),
        infl_count=torch.where(sel, state.infl_count + 1, state.infl_count),
        infl_total_bytes=torch.where(
            sel, state.infl_total_bytes + bytes_, state.infl_total_bytes
        ),
    )


def inflights_free_le(state: RaftState, sel, to) -> RaftState:
    """Free all inflights with index <= to (tracker/inflights.go:97-127).
    The ring holds a monotonic index sequence, so the freed set is a prefix."""
    f = state.infl_index.shape[-1]
    k = oh.iota(f, state.infl_index.device)
    live = k < state.infl_count.unsqueeze(-1)  # ring order positions
    pos = (state.infl_start.unsqueeze(-1) + k) % f  # physical slot of ring pos k
    idx_k = oh.gather(state.infl_index, pos)
    byt_k = oh.gather(state.infl_bytes, pos)
    freed = live & (idx_k <= to.unsqueeze(-1))
    n_free = freed.sum(dim=-1, dtype=I32)
    b_free = torch.where(freed, byt_k, 0).sum(dim=-1, dtype=I32)
    new_count = state.infl_count - n_free
    new_start = torch.where(new_count == 0, 0, (state.infl_start + n_free) % f)
    return dataclasses.replace(
        state,
        infl_count=torch.where(sel, new_count, state.infl_count),
        infl_start=torch.where(sel, new_start, state.infl_start),
        infl_total_bytes=torch.where(
            sel, state.infl_total_bytes - b_free, state.infl_total_bytes
        ),
    )


def update_on_entries_send(state: RaftState, sel, n_entries, bytes_) -> RaftState:
    """Optimistic Next bump + inflight add when a MsgApp is emitted
    (tracker/progress.go:139-164)."""
    repl = sel & (state.pr_state == ProgressState.REPLICATE)
    probe = sel & (state.pr_state == ProgressState.PROBE)
    sending = n_entries > 0
    last = state.pr_next + n_entries - 1
    state = inflights_add(state, repl & sending, last, bytes_)
    return dataclasses.replace(
        state,
        pr_next=torch.where(repl & sending, last + 1, state.pr_next),
        pr_msg_app_flow_paused=torch.where(
            repl,
            inflights_full(state),
            torch.where(probe & sending, True, state.pr_msg_app_flow_paused),
        ),
    )


def maybe_update(state: RaftState, sel, n):
    """Ack from follower: raise Match/Next; returns (state, updated [N, V])
    (tracker/progress.go:167-177)."""
    updated = sel & (state.pr_match < n)
    state = dataclasses.replace(
        state,
        pr_match=torch.where(updated, n, state.pr_match),
        pr_msg_app_flow_paused=torch.where(updated, False, state.pr_msg_app_flow_paused),
        pr_next=torch.where(sel, torch.maximum(state.pr_next, n + 1), state.pr_next),
    )
    return state, updated


def maybe_decr_to(state: RaftState, sel, rejected, match_hint):
    """Rejection from follower: lower Next using the hint unless the
    rejection is stale; returns (state, changed [N, V])
    (tracker/progress.go:186-217)."""
    repl = state.pr_state == ProgressState.REPLICATE
    repl_ok = sel & repl & (rejected > state.pr_match)
    probe_ok = sel & ~repl & (state.pr_next - 1 == rejected)
    new_next = torch.where(
        repl_ok,
        state.pr_match + 1,
        torch.clamp(torch.minimum(rejected, match_hint + 1), min=1),
    )
    changed = repl_ok | probe_ok
    state = dataclasses.replace(
        state,
        pr_next=torch.where(changed, new_next, state.pr_next),
        pr_msg_app_flow_paused=torch.where(probe_ok, False, state.pr_msg_app_flow_paused),
    )
    return state, changed


def is_paused(state: RaftState):
    """[N, V] bool. tracker/progress.go:219-236."""
    return torch.where(
        state.pr_state == ProgressState.SNAPSHOT, True, state.pr_msg_app_flow_paused
    )
