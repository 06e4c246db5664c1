"""Host half of the metrics plane (raft_tpu/metrics/host.py): fold the
device's wrapping int32 counters into exact int64 totals, and merge the
snapshots of several blocks.

Snapshot schema, as in the JAX package:

    {"counters": {name: int}, "hist": {"edges", "buckets", "sum", "count"},
     "rounds": int}
"""

from __future__ import annotations

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
