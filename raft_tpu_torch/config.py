"""Engine configuration: the static capacities of the batched engine.

The PyTorch counterpart of `raft_tpu/config.py` `Shape`. The JAX package
keys its compiled programs on these capacities; here they fix the tensor
shapes of the carry. Per-lane dynamic tunables live in `state.LaneConfig`.

The port reads no environment variables: every choice is a constructor
argument, and the device is explicit (`resolve_device`).
"""

from __future__ import annotations

import dataclasses

import torch

# Defaults mirroring reference raft.go:288-336 validate() fallbacks.
DEFAULT_ELECTION_TICK = 10
DEFAULT_HEARTBEAT_TICK = 1
DEFAULT_MAX_SIZE_PER_MSG = 1 << 20
DEFAULT_MAX_UNCOMMITTED_SIZE = 1 << 30
DEFAULT_MAX_COMMITTED_SIZE_PER_READY = 1 << 20


@dataclasses.dataclass(frozen=True)
class Shape:
    """Static capacities (see raft_tpu/config.py Shape for the reference
    semantics of each field).

    n_lanes: raft nodes in the batch ("N"; groups*voters in a cluster).
    max_peers: voters+learners per group ("V").
    log_window: entries resident per lane ("W", circular, a power of two).
    max_msg_entries: entries carried per MsgApp ("E").
    max_inflight: per-peer in-flight MsgApp window ("F").
    max_read_index: outstanding ReadIndex requests per lane ("R").
    """

    n_lanes: int
    max_peers: int = 8
    log_window: int = 64
    max_msg_entries: int = 8
    max_inflight: int = 8
    max_read_index: int = 4

    def __post_init__(self):
        if self.log_window & (self.log_window - 1):
            raise ValueError("log_window must be a power of two")
        # the slim carry (state.STATE_SLIM / fused.FABRIC_SLIM) stores these
        # counters as int8
        for f in ("max_inflight", "max_read_index", "max_msg_entries"):
            if not 1 <= getattr(self, f) <= 127:
                raise ValueError(f"{f} must be in 1..127 (int8 carry diet; "
                                 "inbox sizing assumes at least 1)")
        if not 1 <= self.max_peers <= 32:
            raise ValueError("max_peers must be in 1..32")

    @property
    def n(self) -> int:
        return self.n_lanes

    @property
    def v(self) -> int:
        return self.max_peers

    @property
    def w(self) -> int:
        return self.log_window


def resolve_device(device=None) -> torch.device:
    """The entry points run on the card unless the caller names another
    device: None means `cuda`, and asking for `cuda` without a card raises
    instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "raft_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
