"""Quorum math as batched reductions over a trailing voter axis
(raft_tpu/ops/quorum.py; reference quorum/majority.go, quorum/joint.go).

- `majority_committed`: each voter's acked index, sorted; the pick is
  element n-(n/2+1), i.e. the (n/2+1)-th largest (majority.go:126-172). An
  empty config yields COMMITTED_INF, the identity of the joint min.
- `majority_vote`: yes/missing counts against q = n/2+1 (majority.go:178-207).
- joint configs: min of the committed indexes (joint.go:49-56) and the AND
  of the vote results (joint.go:61-75).

The functions here are the plain PyTorch versions. `joint_committed`, the
reduction the fused round runs every round, goes through the hand-written
CUDA kernel for tensors on the card (ops/quorum_cuda.py) and through
`joint_committed_plain` for tensors on the CPU.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops import onehot as oh
from raft_tpu_torch.types import VoteResult, VoteState

I32 = torch.int32
# Identity element standing in for the reference's MaxUint64 (majority.go:129).
COMMITTED_INF = 2**31 - 1


def _count(mask):
    return mask.sum(dim=-1, dtype=I32)


def majority_committed(match, mask):
    """(n/2+1)-th largest acked index among masked voters; INF if the mask
    is empty. match: [..., V] i32; mask: [..., V] bool."""
    n = _count(mask)
    q = n // 2 + 1
    # non-voters sort below every real acked index (acked >= 0); an
    # odd-even transposition network, no sort call
    srt = oh.sort_last(match, valid=mask, pad=-1)
    v = match.shape[-1]
    # V-n pad values of -1 sort to the front, so the reference's srt[n - q]
    # is srt[V - q] here
    picked = oh.select_kth(srt, v - q)
    return torch.where(n == 0, COMMITTED_INF, picked)


def majority_vote(votes, mask):
    """VoteResult over the trailing voter axis. votes: [..., V] VoteState."""
    n = _count(mask)
    q = n // 2 + 1
    granted = _count(mask & (votes == VoteState.GRANTED))
    missing = _count(mask & (votes == VoteState.PENDING))
    res = torch.where(
        granted >= q,
        int(VoteResult.VOTE_WON),
        torch.where(
            granted + missing >= q,
            int(VoteResult.VOTE_PENDING),
            int(VoteResult.VOTE_LOST),
        ),
    )
    return torch.where(n == 0, int(VoteResult.VOTE_WON), res).to(I32)


def joint_committed_plain(match, mask_in, mask_out):
    """min of the two halves' committed indexes (joint.go:49-56)."""
    return torch.minimum(
        majority_committed(match, mask_in), majority_committed(match, mask_out)
    )


def joint_committed(match, mask_in, mask_out):
    """JointConfig.CommittedIndex of each lane. On the card this launches
    the CUDA `joint_kernel` (or raises); on the CPU it is the plain
    version."""
    from raft_tpu_torch.ops import quorum_cuda

    return quorum_cuda.joint_committed(match, mask_in, mask_out)


def joint_vote(votes, mask_in, mask_out):
    """Both halves must win; either Lost loses (joint.go:61-75)."""
    r1 = majority_vote(votes, mask_in)
    r2 = majority_vote(votes, mask_out)
    both = torch.maximum(r1, r2)  # WON=1 < LOST=2 < PENDING=3
    any_lost = (r1 == VoteResult.VOTE_LOST) | (r2 == VoteResult.VOTE_LOST)
    return torch.where(any_lost, int(VoteResult.VOTE_LOST), both)


def joint_active(active, mask_in, mask_out):
    """CheckQuorum liveness: RecentActive as votes, joint win required
    (tracker/tracker.go:217-227)."""
    votes = torch.where(
        active, int(VoteState.GRANTED), int(VoteState.REJECTED)
    ).to(I32)
    return joint_vote(votes, mask_in, mask_out) == VoteResult.VOTE_WON
