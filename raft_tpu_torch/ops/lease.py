"""Device half of the leader-lease plane (raft_tpu/ops/lease.py).

A leader holds a lease, renewed by the quorum traffic it already
generates; while the lease holds, its commit index is a linearizable read
index. Rounds are ticks, so the lease clock is exact but for the chaos
plane's tick skew, which the margin and the skew revocation defend
against. The carry holds seven optional [N] columns per lane (RaftState
fields, None when the plane is off):

  lease_left   countdown in rounds (0 = no lease): no rebase under the
               diet-v2 carry, where it packs as uint16 (bounded by
               election_tick <= 2^14).
  lease_epoch  grant generation, wraps at EPOCH_WRAP = 2^15, so the uint16
               diet cast is exact by construction.
  lease_skew   ticks the lane skipped (chaos tick mask false on a ticking
               round) while it held a lease; reset by grant and
               revocation only, never by renewal, so a skew storm
               accumulates to the margin.
  lease_grants / lease_renewals / lease_revocations /
  lease_skew_revocations
               monotone per-lane event counters (int32 in every layout),
               summed on the host (FusedCluster.lease_stats).

A lease is granted or renewed only on a leader running check_quorum that
received a fresh joint quorum of this round's append and heartbeat acks
(self included). The window is election_tick - 1 - margin rounds. It is
revoked on leadership loss, a pending transfer, a confchange in flight, or
tick skew past the margin. The plane is observational: nothing here feeds
back into a raft decision, so lease on and off walk one raft trajectory.

The margin is a constructor argument (FusedCluster(lease_margin=1)),
clamped at 0 as the JAX package's lease_margin() clamps its environment
variable; this package reads no environment variable.
"""

from __future__ import annotations

import torch

I32 = torch.int32

# the per-lane event counters, in the order LEASE_STATE_FIELDS lists the
# whole column set (RaftState's field order after cfg)
LEASE_COUNTER_FIELDS = (
    "lease_grants",
    "lease_renewals",
    "lease_revocations",
    "lease_skew_revocations",
)
LEASE_STATE_FIELDS = ("lease_left", "lease_epoch", "lease_skew") + LEASE_COUNTER_FIELDS
# the columns the diet-v2 carry packs as uint16; the counters stay int32
LEASE_PACK_U16 = ("lease_left", "lease_epoch", "lease_skew")

# lease_epoch wraps here, so that its uint16 diet cast never clamps
EPOCH_WRAP = 1 << 15

DEFAULT_MARGIN = 1


def clamp_margin(margin: int) -> int:
    """The margin as the round uses it: an int, at least 0."""
    return max(int(margin), 0)


def counter_sums(states) -> dict:
    """The event counters of `states` (RaftStates with the lease columns)
    summed over their lanes and over the states, exactly (int64), with one
    device read."""
    sums = torch.stack([
        torch.stack([getattr(s, f) for f in LEASE_COUNTER_FIELDS]).sum(dim=1, dtype=torch.int64)
        for s in states
    ]).sum(dim=0)
    return {f: int(x) for f, x in zip(LEASE_COUNTER_FIELDS, sums.cpu().tolist())}


def lease_round(state, *, is_leader, ack_quorum, skipped_tick, margin: int) -> dict:
    """One round of lease maintenance (raft_tpu/ops/lease.py:100-178), run
    by the fused round after its role, transfer and confchange transitions
    are final.

    state: the post-transition RaftState (int32 compute view; its lease
    columns the previous round's); is_leader: [N] bool, leadership after
    this round; ack_quorum: [N] bool, a joint quorum of this round's
    append and heartbeat acks landed; skipped_tick: [N] bool, the lane
    skipped this round's tick (False unless chaos is on and the round
    ticks); margin: an int >= 0. Returns the seven successor columns."""
    left = state.lease_left.to(I32)
    epoch = state.lease_epoch.to(I32)
    skew = state.lease_skew.to(I32)
    held = left > 0

    # the natural expiry: one round elapsed
    left = torch.clamp(left - 1, min=0)

    # conservative revocation on the post-round state: leadership lost,
    # a transfer pending, a confchange in flight
    cc_active = (state.pending_conf_index > state.applied) | state.voters_out.any(dim=-1)
    unsafe = ~is_leader | (state.lead_transferee != 0) | cc_active

    # clock skew accumulated while holding a lease, revoked past the margin
    skew = torch.where(held & skipped_tick, skew + 1, skew)
    skew_revoke = held & (skew > margin)
    revoke = held & (unsafe | skew_revoke)

    # grant or renew on a fresh ack quorum with nothing unsafe in flight
    window = torch.clamp(state.cfg.election_tick.to(I32) - 1 - margin, min=1)
    renew = is_leader & state.cfg.check_quorum & ack_quorum & ~unsafe & ~skew_revoke
    granted = renew & ~held
    renewed = renew & held

    left = torch.where(revoke, 0, torch.where(renew, window, left)).to(I32)
    epoch = torch.where(granted, (epoch + 1) % EPOCH_WRAP, epoch)
    # skew resets on grant and on revocation, never on renewal
    skew = torch.where(granted | revoke, 0, skew).to(I32)

    def count(x, ev):
        return x.to(I32) + ev.to(I32)

    return dict(
        lease_left=left,
        lease_epoch=epoch,
        lease_skew=skew,
        lease_grants=count(state.lease_grants, granted),
        lease_renewals=count(state.lease_renewals, renewed),
        lease_revocations=count(state.lease_revocations, revoke),
        lease_skew_revocations=count(
            state.lease_skew_revocations, held & skew_revoke & ~unsafe
        ),
    )
