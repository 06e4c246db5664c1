"""Multi-block fused scheduler (raft_tpu/scheduler.py BlockedFusedCluster).

`n_groups` raft groups held as K = n_groups / block_groups resident
FusedClusters. Groups never interact, so splitting the batch keeps each
round's temporaries at block size while every block's slim carry stays
resident. Dispatch is round-major: each sweep runs `round_chunk` rounds of
every block before advancing. Block i is seeded `seed + 7919*i`, so the
blocks' election timeouts decorrelate as lanes within a block do, and the
trajectory matches the JAX package block for block.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.config import Shape, resolve_device
from raft_tpu_torch.metrics.host import merge_snapshots
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops.fused import FusedCluster, LocalOps, make_local_ops
from raft_tpu_torch.types import StateType


class BlockedFusedCluster:
    """The driving API mirrors FusedCluster; per-lane injections address
    lanes in global order (block i owns lanes [i*B*V, (i+1)*B*V)). Runs on
    `cuda` unless `device` names another device. engine / tile_lanes /
    rounds_per_call pass through to every block (FusedCluster)."""

    def __init__(
        self,
        n_groups: int,
        n_voters: int,
        block_groups: int | None = None,
        seed: int = 1,
        shape: Shape | None = None,
        round_chunk: int = 1,
        *,
        device=None,
        **cfg,
    ):
        block_groups = block_groups or n_groups
        if n_groups % block_groups:
            raise ValueError("n_groups must be a multiple of block_groups")
        if round_chunk < 1:
            raise ValueError("round_chunk must be >= 1")
        # the pallas engine's K must divide round_chunk, or every chunk ends
        # in a remainder launch (raft_tpu/scheduler.py:91-101)
        if plr.resolve_engine(cfg.get("engine")) == "pallas":
            k = cfg.get("rounds_per_call")
            if k is not None:
                plr.validate_round_plan(k, round_chunk=round_chunk)
        self.device = resolve_device(device)
        self.g, self.v = n_groups, n_voters
        self.block_groups = block_groups
        self.k = n_groups // block_groups
        self.lanes_per_block = block_groups * n_voters
        self.round_chunk = round_chunk
        self.blocks = [
            FusedCluster(
                block_groups, n_voters, seed=seed + 7919 * i, shape=shape,
                device=self.device, **cfg,
            )
            for i in range(self.k)
        ]

    def prepare_ops(self, ops: LocalOps) -> list[LocalOps]:
        """Slice a global-lane LocalOps into K per-block bindings."""
        lpb = self.lanes_per_block
        return [
            LocalOps(*(x[i * lpb : (i + 1) * lpb] for x in ops)) for i in range(self.k)
        ]

    def sweep(self, rounds: int):
        """The round-major schedule: (step, first) chunks, step <=
        round_chunk, covering `rounds` rounds."""
        done = 0
        while done < rounds:
            step = min(self.round_chunk, rounds - done)
            yield step, done == 0
            done += step

    def run(self, rounds: int = 1, ops=None, **kw):
        """`rounds` fused rounds on every block, round-major. ops: a
        global-lane LocalOps, or a K-list from prepare_ops."""
        per_ops = None
        if ops is not None:
            per_ops = list(ops) if isinstance(ops, list) else self.prepare_ops(ops)
            if len(per_ops) != self.k:
                raise ValueError(
                    f"per-block ops list must have {self.k} entries, got {len(per_ops)}"
                )
        ops_first = kw.get("ops_first_round_only", True)
        for step, first in self.sweep(rounds):
            for i, b in enumerate(self.blocks):
                o = None
                if per_ops is not None and (first or not ops_first):
                    o = per_ops[i]
                b.run(step, ops=o, **kw)

    def ops(self, **kw) -> LocalOps:
        """Global-lane LocalOps (same contract as FusedCluster.ops)."""
        return make_local_ops(self.g * self.v, self.device, **kw)

    # -- inspection (aggregate) -------------------------------------------

    def metrics_snapshot(self) -> dict | None:
        """One merged snapshot over all K blocks with one device sync: the
        blocks' lane-reduced counters are stacked into a single pull."""
        if self.blocks[0].metrics is None:
            return None
        rows = torch.stack(
            [
                torch.cat(
                    [
                        b.metrics.counters,
                        b.metrics.hist,
                        b.metrics.lat_sum[None],
                        b.metrics.round_ctr[None],
                    ]
                )
                for b in self.blocks
            ]
        ).cpu().numpy()
        nc = rows.shape[1] - 2 - self.blocks[0].metrics.hist.shape[0]
        snaps = []
        for b, row in zip(self.blocks, rows):
            b._metrics_acc.pull(row[:nc], row[nc:-2], row[-2], row[-1])
            snaps.append(b._metrics_acc.snapshot())
        return merge_snapshots(snaps)

    def total_committed(self) -> int:
        return int(
            sum(b.state.committed.sum(dtype=torch.int64) for b in self.blocks)
        )

    def leader_count(self) -> int:
        return int(
            sum((b.state.state == StateType.LEADER).sum(dtype=torch.int64) for b in self.blocks)
        )

    def check_no_errors(self):
        for b in self.blocks:
            b.check_no_errors()
