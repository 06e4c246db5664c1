"""Wire-level enums and constants, numbered as the reference protobuf
definitions (reference: raftpb/raft.proto:15-69, 110-135) and as the JAX
package's `raft_tpu/types.py`, so state dumps of both packages agree."""

from __future__ import annotations

import enum


class EntryType(enum.IntEnum):
    # reference: raftpb/raft.proto:15-19
    ENTRY_NORMAL = 0
    ENTRY_CONF_CHANGE = 1
    ENTRY_CONF_CHANGE_V2 = 2


class MessageType(enum.IntEnum):
    # reference: raftpb/raft.proto:41-69
    MSG_HUP = 0
    MSG_BEAT = 1
    MSG_PROP = 2
    MSG_APP = 3
    MSG_APP_RESP = 4
    MSG_VOTE = 5
    MSG_VOTE_RESP = 6
    MSG_SNAP = 7
    MSG_HEARTBEAT = 8
    MSG_HEARTBEAT_RESP = 9
    MSG_UNREACHABLE = 10
    MSG_SNAP_STATUS = 11
    MSG_CHECK_QUORUM = 12
    MSG_TRANSFER_LEADER = 13
    MSG_TIMEOUT_NOW = 14
    MSG_READ_INDEX = 15
    MSG_READ_INDEX_RESP = 16
    MSG_PRE_VOTE = 17
    MSG_PRE_VOTE_RESP = 18
    MSG_STORAGE_APPEND = 19
    MSG_STORAGE_APPEND_RESP = 20
    MSG_STORAGE_APPLY = 21
    MSG_STORAGE_APPLY_RESP = 22
    MSG_FORGET_LEADER = 23
    # Sentinel for an empty message slot in an SoA batch (not a wire type).
    MSG_NONE = 63


class StateType(enum.IntEnum):
    # reference: raft.go:47-53
    FOLLOWER = 0
    CANDIDATE = 1
    LEADER = 2
    PRE_CANDIDATE = 3


class ProgressState(enum.IntEnum):
    # reference: tracker/state.go:20-34
    PROBE = 0
    REPLICATE = 1
    SNAPSHOT = 2


class VoteState(enum.IntEnum):
    """Per-voter recorded vote; PENDING makes 'not yet voted' representable
    (reference: tracker/tracker.go:260-290 keeps a map[id]bool)."""

    PENDING = 0
    GRANTED = 1
    REJECTED = 2


class VoteResult(enum.IntEnum):
    # reference: quorum/quorum.go:48-58
    VOTE_WON = 1
    VOTE_LOST = 2
    VOTE_PENDING = 3


class CampaignType(enum.IntEnum):
    """Reference uses strings (raft.go:71-81); the device engine needs ints."""

    PRE_ELECTION = 0
    ELECTION = 1
    TRANSFER = 2
