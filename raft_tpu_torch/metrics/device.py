"""Device half of the metrics plane (raft_tpu/metrics/device.py): the
`MetricsState` carried through the fused round.

Per-lane event masks reduce to int32 scalars inside the round, so the carry
holds one [K] counter vector and one [B] histogram per block; only the
commit-latency sampler keeps [N] columns. Counters are int32 and wrap on
add, exactly as in the JAX package; the host folds wraparound-aware deltas
into int64 totals (metrics/host.py). Counter semantics are documented on
the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

I32 = torch.int32

COUNTERS = (
    "elections_started",
    "elections_won",
    "leader_changes",
    "commits",
    "proposals",
    "proposals_dropped",
    "msgs_app",
    "msgs_app_resp",
    "msgs_heartbeat",
    "msgs_heartbeat_resp",
    "msgs_vote",
    "msgs_vote_resp",
    "read_index_served",
)
COUNTER_INDEX = {name: i for i, name in enumerate(COUNTERS)}

# commit-latency bucket upper bounds in rounds (le semantics); the last
# bucket is the +Inf overflow
HIST_EDGES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
N_BUCKETS = len(HIST_EDGES) + 1


@dataclasses.dataclass
class MetricsState:
    """counters/hist/lat_sum/round_ctr are per-block scalars (already
    lane-reduced); samp_* are the per-lane latency sampler."""

    counters: Any  # [K] i32, wraps
    hist: Any  # [B] i32 commit-latency bucket counts
    lat_sum: Any  # [] i32 sum of sampled latencies
    round_ctr: Any  # [] i32 rounds stepped
    samp_index: Any  # [N] i32 in-flight sampled entry index (0 = none)
    samp_round: Any  # [N] i32 round_ctr at sample start


def init_metrics(n: int, device) -> MetricsState:
    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=device)

    return MetricsState(
        counters=z(len(COUNTERS)),
        hist=z(N_BUCKETS),
        lat_sum=z(),
        round_ctr=z(),
        samp_index=z(n),
        samp_round=z(n),
    )


class EventBag:
    """Collects the round's lane-shaped event counts as fused_round walks;
    reduce() collapses them to ONE [K] int32 delta at the end."""

    def __init__(self):
        self._events: dict[str, list] = {}

    def add(self, name: str, mask_or_count):
        if name not in COUNTER_INDEX:
            raise KeyError(f"unknown counter {name!r}")
        self._events.setdefault(name, []).append(mask_or_count)

    def reduce(self, device, rows: int | None = None) -> torch.Tensor:
        """[K] deltas, or [rows, K] when the lanes split into `rows` equal
        runs (one per CUDA block of the round kernel)."""
        parts = []
        for name in COUNTERS:
            total = torch.zeros(() if rows is None else (rows,), dtype=I32, device=device)
            for t in self._events.get(name, ()):
                total = total + lane_sum(t, rows)
            parts.append(total)
        return torch.stack(parts, dim=-1)


def lane_sum(x, rows: int | None = None):
    """int32 sum of a lane-leading tensor: a scalar, or one sum per run of
    lanes when `rows` splits the lanes into equal runs."""
    if rows is None:
        return x.sum(dtype=I32)
    return x.reshape(rows, -1).sum(dim=1, dtype=I32)


def _rows(metrics: "MetricsState") -> int | None:
    """Row count of a per-run metrics carry (counters [rows, K]); None for
    the usual lane-reduced carry (counters [K])."""
    return metrics.counters.shape[0] if metrics.counters.dim() == 2 else None


def bucket_index(lat):
    """Histogram bucket of a latency in rounds: how many edges it exceeds."""
    idx = torch.zeros(lat.shape, dtype=I32, device=lat.device)
    for e in HIST_EDGES:
        idx = idx + (lat > e).to(I32)
    return idx


def observe_commit_latency(metrics: MetricsState, state) -> MetricsState:
    """End-of-round sampler update: complete the samples whose index
    committed. round_ctr is the pre-increment value, so a propose+commit
    within one round measures 1. A per-run carry (counters [rows, K]) keeps
    hist and lat_sum per run too."""
    rows = _rows(metrics)
    now = metrics.round_ctr + 1
    live = metrics.samp_index > 0
    done = live & (state.committed >= metrics.samp_index)
    lat = torch.where(done, now - metrics.samp_round, 0)
    buckets = torch.arange(N_BUCKETS, dtype=I32, device=lat.device)
    oh = (bucket_index(lat)[:, None] == buckets[None, :]) & done[:, None]
    return dataclasses.replace(
        metrics,
        hist=metrics.hist
        + (oh if rows is None else oh.reshape(rows, -1, N_BUCKETS)).sum(dim=-2, dtype=I32),
        lat_sum=metrics.lat_sum + lane_sum(lat, rows),
        samp_index=torch.where(done, 0, metrics.samp_index),
    )


def arm_sample(metrics: MetricsState, appended, last_index) -> MetricsState:
    """Start a latency sample on lanes that appended and have none live."""
    arm = appended & (metrics.samp_index == 0)
    return dataclasses.replace(
        metrics,
        samp_index=torch.where(arm, last_index, metrics.samp_index),
        samp_round=torch.where(arm, metrics.round_ctr + 1, metrics.samp_round),
    )


def commit_round(metrics: MetricsState, bag: EventBag) -> MetricsState:
    """Fold the round's event bag into the carry; advance the round counter."""
    return dataclasses.replace(
        metrics,
        counters=metrics.counters + bag.reduce(metrics.counters.device, _rows(metrics)),
        round_ctr=metrics.round_ctr + 1,
    )


def rebase_samples(metrics: MetricsState, mask, delta) -> MetricsState:
    """Shift live sampled indexes with an index-space rebase of their
    lanes; a sample that would fall to <= 0 is dropped."""
    live = (metrics.samp_index > 0) & mask
    shifted = metrics.samp_index - delta
    return dataclasses.replace(
        metrics,
        samp_index=torch.where(live, torch.clamp(shifted, min=0), metrics.samp_index),
    )
