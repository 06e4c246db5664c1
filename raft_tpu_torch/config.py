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

# The diet-v2 packed carry stores rebased index columns as uint16, so the
# window must stay far under 2^16 (raft_tpu/config.py MAX_LOG_WINDOW).
MAX_LOG_WINDOW = 1 << 14


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
    max_entry_bytes: the largest entry payload the diet-v2 packed carry
      stores (its entry-size columns are int16).
    page_window: the paged entry log's resident entries per lane ("W_res",
      a power of two, 2 <= W_res < W); 0 -> min(8, W/2) at cluster
      construction (ops/paged.py validate_page_plan).
    page_entries: entries per pool page ("PE", a power of two <= W); 0 ->
      min(4, page_window).
    pool_pages: pages in the shared entry pool ("P", page 0 a reserved
      trash row, ids uint16); 0 -> full provisioning, which never
      exhausts.
    """

    n_lanes: int
    max_peers: int = 8
    log_window: int = 64
    max_msg_entries: int = 8
    max_inflight: int = 8
    max_read_index: int = 4
    max_entry_bytes: int = 32767
    page_window: int = 0
    page_entries: int = 0
    pool_pages: int = 0

    def __post_init__(self):
        if self.log_window & (self.log_window - 1):
            raise ValueError("log_window must be a power of two")
        # the slim carry (state.STATE_SLIM / fused.FABRIC_SLIM) stores these
        # counters as int8
        for f in ("max_inflight", "max_read_index", "max_msg_entries"):
            if not 1 <= getattr(self, f) <= 127:
                raise ValueError(f"{f} must be in 1..127 (int8 carry diet; "
                                 "inbox sizing assumes at least 1)")
        # the diet-v2 packed carry (state.pack_state) stores the per-peer
        # bool masks as one bitset word per lane, the rebased index columns
        # as uint16 and the entry sizes as int16
        if not 1 <= self.max_peers <= 32:
            raise ValueError(
                "max_peers must be in 1..32 (diet-v2 packs the [N, V] bool "
                "masks into one bitset word per lane)"
            )
        if self.log_window > MAX_LOG_WINDOW:
            raise ValueError(
                f"log_window must be <= MAX_LOG_WINDOW={MAX_LOG_WINDOW} "
                "(diet-v2 stores rebased index columns as uint16; the "
                "post-rebase space is a few windows plus the between-rebase "
                "growth budget)"
            )
        if not 1 <= self.max_entry_bytes <= 32767:
            raise ValueError(
                "max_entry_bytes must be in 1..32767 (diet-v2 stores entry "
                "size columns as int16)"
            )
        # the paged entry log's geometry: each nonzero field on its own here,
        # the plan across fields in ops/paged.py validate_page_plan
        if self.page_window:
            if self.page_window & (self.page_window - 1):
                raise ValueError("page_window must be a power of two")
            if not 2 <= self.page_window < self.log_window:
                raise ValueError(
                    "page_window must be in 2..log_window/2 (the paged "
                    "resident window is a strict subset of log_window)"
                )
        if self.page_entries:
            if self.page_entries & (self.page_entries - 1):
                raise ValueError("page_entries must be a power of two")
            if not 1 <= self.page_entries <= self.log_window:
                raise ValueError(
                    "page_entries must be in 1..log_window (a page never "
                    "holds more than one window)"
                )
        if self.pool_pages:
            if not 2 <= self.pool_pages <= (1 << 16):
                raise ValueError(
                    "pool_pages must be in 2..65536 (page ids are uint16 "
                    "with page 0 reserved as the trash row)"
                )

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
