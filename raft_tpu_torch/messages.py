"""SoA message batches (raft_tpu/messages.py).

The reference's `raftpb.Message` (raftpb/raft.proto:71-108) as a
struct-of-arrays batch with a fixed per-message entry capacity E. Entry
payloads never ride in device messages: the device reads only the (term,
type, size) columns. The fused round hands the step handlers one [N]
`MsgBatch` view of each lane's winning inbox cell.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from raft_tpu_torch.types import MessageType

I32 = torch.int32


@dataclasses.dataclass
class MsgBatch:
    """A batch of messages with leading shape [...]; `type == MSG_NONE`
    marks an empty slot. Field semantics match raftpb.Message."""

    type: Any  # [...] i32
    to: Any  # [...] i32 raft id (within destination group)
    frm: Any  # [...] i32
    term: Any  # [...] i32
    log_term: Any  # [...] i32
    index: Any  # [...] i32
    commit: Any  # [...] i32
    vote: Any  # [...] i32
    reject: Any  # [...] bool
    reject_hint: Any  # [...] i32
    context: Any  # [...] i32 (read-index ctx ticket / campaign-transfer flag)
    # entries [..., E]: index of entry k is msg.index + 1 + k
    n_ents: Any  # [...] i32
    ent_term: Any  # [..., E] i32
    ent_type: Any  # [..., E] i32
    ent_bytes: Any  # [..., E] i32
    snap_index: Any  # [...] i32
    snap_term: Any  # [...] i32


def empty_batch(batch_shape: tuple[int, ...], max_entries: int, device) -> MsgBatch:
    def z():
        return torch.zeros(batch_shape, dtype=I32, device=device)

    def ze():
        return torch.zeros((*batch_shape, max_entries), dtype=I32, device=device)

    return MsgBatch(
        type=torch.full(batch_shape, int(MessageType.MSG_NONE), dtype=I32, device=device),
        to=z(),
        frm=z(),
        term=z(),
        log_term=z(),
        index=z(),
        commit=z(),
        vote=z(),
        reject=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        reject_hint=z(),
        context=z(),
        n_ents=z(),
        ent_term=ze(),
        ent_type=ze(),
        ent_bytes=ze(),
        snap_index=z(),
        snap_term=z(),
    )
