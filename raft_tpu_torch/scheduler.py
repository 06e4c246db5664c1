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

import numpy as np
import torch

from raft_tpu_torch.config import Shape, resolve_device
from raft_tpu_torch.metrics.host import merge_snapshots
from raft_tpu_torch.ops import paged as pgmod
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops.fused import FusedCluster, LocalOps, make_local_ops
from raft_tpu_torch.types import StateType


class BlockedFusedCluster:
    """The driving API mirrors FusedCluster; per-lane injections address
    lanes in global order (block i owns lanes [i*B*V, (i+1)*B*V)). Runs on
    `cuda` unless `device` names another device. diet / paged /
    paged_inkernel / chaos / chaos_seed / lease / lease_margin / engine /
    tile_lanes / rounds_per_call pass through to every block
    (FusedCluster); a paged
    Shape's plan is checked for one block's lanes before any block
    allocates, and each block pages over its own segments. Chaos columns
    are set and read in global lane order (set_chaos, chaos_columns), with
    paging as without. lease_stats sums the blocks' lease counters, and the
    merged metrics snapshot carries them."""

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
        # a bad page plan fails here, before any block allocates a carry
        # (raft_tpu/scheduler.py:243-250); each block checks it again
        if cfg.get("paged") and shape is not None:
            pgmod.validate_page_plan(shape, self.lanes_per_block)
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
        if self.k == 1:
            # one block: all rounds in one dispatch, as the JAX package runs
            # it (raft_tpu/scheduler.py:343-359), so the diet-v2 headroom
            # projects rounds * (E + 1) once and rebases when JAX does
            self.blocks[0].run(rounds, ops=None if per_ops is None else per_ops[0], **kw)
            return
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

    # -- the chaos plane (raft_tpu/scheduler.py:400-440) ------------------

    @property
    def chaos_enabled(self) -> bool:
        return self.blocks[0].chaos is not None

    def set_chaos(self, **cols):
        """Chaos columns in global lane order: arrays whose first dimension
        is the lane count are sliced per block, anything else (heal_round)
        goes to every block."""
        if not self.chaos_enabled:
            raise RuntimeError("chaos plane is off: construct with chaos=True")
        n, lpb = self.g * self.v, self.lanes_per_block
        for i, b in enumerate(self.blocks):
            b.set_chaos(**{
                name: val[i * lpb : (i + 1) * lpb] if np.ndim(val) >= 1 and len(val) == n else val
                for name, val in cols.items()
            })

    def chaos_columns(self, *names) -> dict:
        """Chaos columns of all blocks: per-lane columns concatenated in
        global lane order, the recounts n_reelected / n_recommitted summed,
        other scalars (round, heal_round: the same in every block) from
        block 0."""
        if not self.chaos_enabled:
            return {}
        per = [b.chaos_columns(*names) for b in self.blocks]
        out = {}
        for name, v0 in per[0].items():
            vals = [p[name] for p in per]
            if np.ndim(v0) >= 1 and np.shape(v0)[0] == self.lanes_per_block:
                out[name] = np.concatenate(vals)
            elif name in ("n_reelected", "n_recommitted"):
                out[name] = sum(int(x) for x in vals)
            else:
                out[name] = v0
        return out

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
        snap = merge_snapshots(snaps)
        snap["counters"].update(self.lease_stats() or {})
        return snap

    def lease_stats(self) -> dict | None:
        """The blocks' lease counters (FusedCluster.lease_stats) summed,
        with one device read; None without the lease plane."""
        if self.blocks[0].state.lease_left is None:
            return None
        from raft_tpu_torch.metrics.host import record_lease_stats
        from raft_tpu_torch.ops.lease import counter_sums

        stats = counter_sums([b.state for b in self.blocks])
        record_lease_stats(stats)
        return stats

    def paged_stats(self) -> dict | None:
        """The blocks' paged_stats summed (pool pages included); None
        without paging."""
        stats = [b.paged_stats() for b in self.blocks]
        if stats[0] is None:
            return None
        return {k: sum(s[k] for s in stats) for k in stats[0]}

    def state_columns(self, *names) -> dict:
        """The named [N_block]-leading state columns of every block,
        concatenated in global lane order, each read through the block's
        host_state (packed columns widen to absolute int32)."""
        cols = [b.state_columns(*names) for b in self.blocks]
        return {name: np.concatenate([c[name] for c in cols]) for name in names}

    def total_committed(self) -> int:
        # widened before the sum: a diet-v2 packed committed column is
        # uint16, which PyTorch does not reduce
        return int(
            sum(b.state.committed.to(torch.int64).sum() for b in self.blocks)
        )

    def leader_lanes(self) -> np.ndarray:
        """Global lanes that are leaders, block after block."""
        return np.concatenate([b.leader_lanes() + i * self.lanes_per_block
                               for i, b in enumerate(self.blocks)])

    def leader_count(self) -> int:
        return int(
            sum((b.state.state == StateType.LEADER).sum(dtype=torch.int64) for b in self.blocks)
        )

    def check_no_errors(self):
        for b in self.blocks:
            b.check_no_errors()
