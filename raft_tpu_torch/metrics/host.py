"""Host half of the metrics plane (raft_tpu/metrics/host.py): fold the
device's wrapping int32 counters into exact int64 totals, and merge the
snapshots of several blocks.

Snapshot schema, as in the JAX package:

    {"counters": {name: int}, "hist": {"edges", "buckets", "sum", "count"},
     "rounds": int}
"""

from __future__ import annotations

import logging
import time

import numpy as np

from raft_tpu_torch.metrics.device import COUNTERS, HIST_EDGES, N_BUCKETS


def empty_snapshot() -> dict:
    return {
        "counters": {name: 0 for name in COUNTERS},
        "hist": {
            "edges": list(HIST_EDGES),
            "buckets": [0] * N_BUCKETS,
            "sum": 0,
            "count": 0,
        },
        "rounds": 0,
    }


class CounterAccumulator:
    """Exact int64 totals from a stream of wrapping-int32 device pulls:
    each pull's delta is `(cur - prev) mod 2^32`, the true event count while
    fewer than 2^31 events happen between pulls."""

    def __init__(self):
        self._prev_counters = np.zeros(len(COUNTERS), np.int64)
        self._prev_hist = np.zeros(N_BUCKETS, np.int64)
        self._prev_lat_sum = 0
        self._prev_rounds = 0
        self.counters = np.zeros(len(COUNTERS), np.int64)
        self.hist = np.zeros(N_BUCKETS, np.int64)
        self.lat_sum = 0
        self.rounds = 0

    @staticmethod
    def _delta(cur, prev):
        return (
            np.asarray(cur, np.int64).astype(np.uint32)
            - np.asarray(prev, np.int64).astype(np.uint32)
        ).astype(np.uint32).astype(np.int64)

    def pull(self, counters, hist, lat_sum, round_ctr) -> None:
        """Fold one pulled set of host values into the totals."""
        cur_c = np.asarray(counters, np.int64)
        cur_h = np.asarray(hist, np.int64)
        cur_s = int(lat_sum)
        cur_r = int(round_ctr)
        self.counters += self._delta(cur_c, self._prev_counters)
        self.hist += self._delta(cur_h, self._prev_hist)
        self.lat_sum += int(self._delta(cur_s, self._prev_lat_sum))
        self.rounds += int(self._delta(cur_r, self._prev_rounds))
        self._prev_counters = cur_c
        self._prev_hist = cur_h
        self._prev_lat_sum = cur_s
        self._prev_rounds = cur_r

    def snapshot(self) -> dict:
        return {
            "counters": {name: int(self.counters[i]) for i, name in enumerate(COUNTERS)},
            "hist": {
                "edges": list(HIST_EDGES),
                "buckets": [int(x) for x in self.hist],
                "sum": int(self.lat_sum),
                "count": int(self.hist.sum()),
            },
            "rounds": int(self.rounds),
        }


def merge_snapshots(snaps) -> dict:
    """Sum the block snapshots of one cluster: counters and histogram
    buckets add, rounds is the max (every block steps the same rounds)."""
    out = empty_snapshot()
    for s in snaps:
        for name, v in s["counters"].items():
            out["counters"][name] += int(v)
        h = out["hist"]
        h["buckets"] = [a + int(b) for a, b in zip(h["buckets"], s["hist"]["buckets"])]
        h["sum"] += int(s["hist"]["sum"])
        h["count"] += int(s["hist"]["count"])
        out["rounds"] = max(out["rounds"], int(s["rounds"]))
    return out


# The paged entry log's counters (host plane): computed from the sidecar by
# FusedCluster.paged_stats at host sync points, never per dispatch.
#   paged_pool_in_use    gauge: pool pages mapped by any lane's table
#   paged_page_faults    pages gathered from the pool at page_in
#   paged_exhausted      page_out clamp events (lane x pass); nonzero means
#                        ERR_PAGE_EXHAUSTED is set on some lane
#   paged_pages_dirty    pages the allocator wrote back
#   paged_alloc_skipped  allocator passes elided by page_out_cond
PAGED_COUNTERS = (
    "paged_pool_in_use",
    "paged_page_faults",
    "paged_exhausted",
    "paged_pages_dirty",
    "paged_alloc_skipped",
)

# the latest paged_stats snapshot, as levels (re-recording one is idempotent)
PAGED_EVENTS = {name: 0 for name in PAGED_COUNTERS}
_LOG = logging.getLogger(__name__)
_WARNED_AT = {}


def record_paged_stats(stats: dict) -> None:
    """Mirror one ops/paged.py paged_stats snapshot onto PAGED_EVENTS, and
    warn (at most once a minute) when the pool has clamped lanes."""
    for name in PAGED_COUNTERS:
        PAGED_EVENTS[name] = int(stats.get(name, 0))
    exhausted = int(stats.get("paged_exhausted", 0))
    now = time.monotonic()
    if exhausted and now - _WARNED_AT.get("paged_exhausted", -60.0) >= 60.0:
        _WARNED_AT["paged_exhausted"] = now
        _LOG.warning(
            "paged entry pool exhausted: %d lane-dispatch clamp events so far "
            "(ERR_PAGE_EXHAUSTED set on the affected lanes; raise "
            "Shape.pool_pages — pool holds %d pages)",
            exhausted, int(stats.get("paged_pool_pages", 0)),
        )


# The leader-lease counters (raft_tpu/metrics/host.py:279-303). The first
# four are host sums of the per-lane device event counters (ops/lease.py,
# pulled by FusedCluster.lease_stats at host sync points); the last two
# belong to the serve plane's lease fast path, which is not ported, and
# stay 0 here:
#   lease_grants           fresh leases granted (lease_left 0 -> window)
#   lease_renewals         leases extended by a fresh ack quorum
#   lease_revocations      conservative revocations (leadership loss,
#                          transfer, confchange, or tick skew)
#   lease_skew_revocations the skew-only subset of revocations
#   lease_reads_served     reads answered from the lease fast path
#   lease_reads_fallback   lease-routed reads sent back to ReadIndex
LEASE_COUNTERS = (
    "lease_grants",
    "lease_renewals",
    "lease_revocations",
    "lease_skew_revocations",
    "lease_reads_served",
    "lease_reads_fallback",
)

# the process-wide mirror of the lease counters: record_lease_stats sets
# the device-derived ones as levels and leaves the others as they are
LEASE_EVENTS = {name: 0 for name in LEASE_COUNTERS}


def record_lease_stats(stats: dict) -> None:
    """Mirror one FusedCluster.lease_stats snapshot onto LEASE_EVENTS
    (only the keys it holds)."""
    for name in LEASE_COUNTERS:
        if name in stats:
            LEASE_EVENTS[name] = int(stats[name])
