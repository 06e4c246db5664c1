"""Host half of the chaos plane (raft_tpu/chaos/schedule.py): the scenario
builder, the segment driver and the recovery SLO.

`ChaosSchedule` states a fault scenario once, in absolute chaos rounds,
and compiles it into the knob columns in force at each segment's first
round (`columns`); `segments` cuts the timeline at every event edge and
heal round. `ChaosRunner` drives a FusedCluster or BlockedFusedCluster
through it segment by segment: write the columns, run, check
`check_no_errors` and `election_safety_batched`, arm the recovery probe at
each heal round, and fold each healed group's ticks to re-election and to
first commit into `RecoveryProbe`, whose snapshot has the JAX package's
schema. `trajectory_digest` is the JAX package's bit-identity oracle over
the state and chaos leaves.

The columns, heal sets and probe folds are numpy over whole group arrays
(the JAX package loops in Python over every group of every event, seconds
a segment at 1,048,576 groups); the arrays and snapshots are the same.
The wire-plane builders (fabric) and the lease skew storm are not ported:
they raise NotImplementedError naming their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.chaos.device import NEVER, probability
from raft_tpu_torch.types import StateType

_WIRE = ("the fabric wire plane is not ported to raft_tpu_torch yet "
         "(ROADMAP Queue 1: fabric/ and the bridge)")
_LEASE = "the lease plane is not ported to raft_tpu_torch yet (ROADMAP Queue 1: the lease plane)"


@dataclasses.dataclass
class _Event:
    kind: str  # "partition" | "drop" | "dup" | "skew" | "kill"
    start: int
    end: int  # exclusive; for "kill": the restart round
    groups: np.ndarray  # int64 group ids
    lanes: np.ndarray | None = None  # "kill": explicit lanes (None = leaders)
    members: tuple | None = (0,)
    prob: float = 1.0
    asymmetric: bool = False
    resolved: np.ndarray | None = None  # leader lanes pinned by resolve_kills


class ChaosSchedule:
    """Fault scenario over G groups x V voters; every builder returns self
    and takes absolute rounds. Scenarios that end in a heal register a
    recovery-probe phase for their groups."""

    def __init__(self, n_groups: int, n_voters: int):
        self.g, self.v = n_groups, n_voters
        self.events: list[_Event] = []
        self.heals: dict[int, np.ndarray] = {}  # round -> sorted group ids

    # -- scenario builders -------------------------------------------------

    def _groups(self, groups) -> np.ndarray:
        if groups is None:
            return np.arange(self.g, dtype=np.int64)
        if isinstance(groups, range):
            gs = np.arange(groups.start, groups.stop, groups.step, dtype=np.int64)
        else:
            gs = np.asarray(groups, dtype=np.int64).reshape(-1)
        bad = gs[(gs < 0) | (gs >= self.g)]
        if bad.size:
            raise ValueError(f"group {int(bad[0])} outside 0..{self.g - 1}")
        return gs

    def _heal(self, at: int, groups: np.ndarray):
        at = int(at)
        self.heals[at] = np.union1d(self.heals.get(at, np.zeros(0, np.int64)), groups)

    def partition(self, groups, at, duration, members=(0,), asymmetric=False):
        """Cut member slots `members` of each group off the rest for
        [at, at+duration); asymmetric=True lets the minority's packets out
        while it receives none."""
        gs = self._groups(groups)
        if not 0 < len(members) < self.v:
            raise ValueError("partition must leave both sides non-empty")
        self.events.append(_Event("partition", at, at + duration, groups=gs,
                                  members=tuple(members), asymmetric=asymmetric))
        self._heal(at + duration, gs)
        return self

    def rolling_partitions(self, at, waves, duration, settle, members=(0,)):
        """Partition wave w covers group slice w of `waves` equal slices,
        with `settle` recovery rounds between heals."""
        per = self.g // waves
        if per < 1:
            raise ValueError("more waves than groups")
        for w in range(waves):
            gs = range(w * per, self.g if w == waves - 1 else (w + 1) * per)
            self.partition(gs, at + w * (duration + settle), duration, members)
        return self

    def flap(self, groups, at, cycles, down=3, up=3, members=(0,)):
        """Flapping link: `cycles` x (down rounds cut, up rounds healthy),
        one probe phase at the final heal."""
        gs = self._groups(groups)
        for k in range(cycles):
            s = at + k * (down + up)
            self.events.append(_Event("partition", s, s + down, groups=gs, members=tuple(members)))
        self._heal(at + cycles * (down + up) - up, gs)
        return self

    def drop(self, groups, at, duration, prob, members=None):
        """Message loss on every inbound edge of the groups (members=None),
        or on both directions of the given member slots. No probe phase."""
        self.events.append(_Event(
            "drop", at, at + duration, groups=self._groups(groups),
            members=None if members is None else tuple(members), prob=prob,
        ))
        return self

    def duplicate(self, groups, at, duration, prob):
        """Duplicate-delivery probability on the groups' outbound edges."""
        self.events.append(_Event("dup", at, at + duration, groups=self._groups(groups),
                                  prob=prob))
        return self

    def skew(self, groups, at, duration, prob, members=(0,)):
        """Clock skew: member slots skip ticks with probability `prob`."""
        self.events.append(_Event("skew", at, at + duration, groups=self._groups(groups),
                                  members=tuple(members), prob=prob))
        return self

    def lease_skew_storm(self, *args, **kwargs):
        raise NotImplementedError(_LEASE)

    def kill(self, lanes, at, down):
        """Crash explicit global lanes at `at`, restart at `at+down`
        (down=0: instant restart, the volatile wipe only)."""
        lanes = np.asarray(lanes, dtype=np.int64).reshape(-1)
        gs = np.unique(lanes // self.v)
        self.events.append(_Event("kill", at, at + down, groups=gs, lanes=lanes))
        self._heal(at + down, gs)
        return self

    def kill_leaders(self, groups, at, down):
        """Leader-targeted kill: the lanes are the groups' leaders at round
        `at` (ChaosRunner resolves them); groups with no leader then are
        skipped."""
        gs = self._groups(groups)
        self.events.append(_Event("kill", at, at + down, groups=gs, lanes=None))
        self._heal(at + down, gs)
        return self

    def staggered_restart(self, groups, at, down=2, gap=4, members=None):
        """Rolling restart: member slot m of each group crash-restarts in its
        own window starting at `at + m*gap`."""
        gs = self._groups(groups)
        members = tuple(range(self.v)) if members is None else tuple(members)
        last = at
        for j, m in enumerate(members):
            s = at + j * gap
            self.events.append(_Event("kill", s, s + down, groups=gs, lanes=gs * self.v + m))
            last = s + down
        self._heal(last, gs)
        return self

    def wire_partition(self, *args, **kwargs):
        raise NotImplementedError(_WIRE)

    def wire_delay(self, *args, **kwargs):
        raise NotImplementedError(_WIRE)

    def wire_plan(self, rnd: int) -> dict:
        raise NotImplementedError(_WIRE)

    # -- compilation -------------------------------------------------------

    def horizon(self) -> int:
        return max([e.end for e in self.events] + list(self.heals), default=0)

    def segments(self, settle: int) -> list[tuple[int, int]]:
        """[start, end) pieces cut at every event edge and heal round, plus
        `settle` trailing rounds after the last edge."""
        stop = self.horizon() + settle
        cuts = {0, stop}
        for e in self.events:
            cuts.update((e.start, e.end))
        cuts.update(self.heals)
        cuts = sorted(c for c in cuts if 0 <= c <= stop)
        return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]

    def heal_groups_at(self, rnd: int) -> np.ndarray:
        """The sorted groups whose recovery phase starts at `rnd`."""
        return self.heals.get(int(rnd), np.zeros(0, np.int64))

    def _rows(self, groups, members) -> np.ndarray:
        return (groups[:, None] * self.v + np.asarray(members, np.int64)[None, :]).reshape(-1)

    def columns(self, start: int) -> dict:
        """The full knob column set in force at round `start`. Kill events
        program the earliest crash cycle still ahead of (or spanning)
        `start` per lane; of overlapping partitions of one group the later
        event wins."""
        n, v = self.g * self.v, self.v
        drop = np.zeros((n, v), np.int32)
        dup = np.zeros((n, v), np.int32)
        skew = np.zeros((n,), np.int32)
        send = np.ones((n,), np.int32)
        recv = np.ones((n,), np.int32)
        crash = np.full((n,), NEVER, np.int32)
        restart = np.full((n,), NEVER, np.int32)
        for e in self.events:
            if e.kind == "kill":
                if e.end <= start and e.end != e.start:
                    continue  # cycle fully behind this segment
                if e.start == e.end and e.start < start:
                    continue  # instant restart already fired
                lanes = e.lanes
                if lanes is None:
                    if start < e.start:
                        continue  # leaders not resolvable yet
                    lanes = e.resolved if e.resolved is not None else np.zeros(0, np.int64)
                sel = lanes[e.start < crash[lanes]]  # the earliest upcoming cycle wins
                crash[sel], restart[sel] = e.start, e.end
                continue
            if not e.start <= start < e.end:
                continue
            p = probability(e.prob)
            group_lanes = self._rows(e.groups, range(v))
            if e.kind == "partition":
                rows = self._rows(e.groups, e.members)
                # bit 1 the majority side, bit 2 the minority; asymmetric
                # keeps bit 1 in the minority's send mask
                send[rows] = 3 if e.asymmetric else 2
                recv[rows] = 2
            elif e.kind == "drop":
                if e.members is None:
                    drop[group_lanes, :] = p
                else:
                    drop[self._rows(e.groups, e.members), :] = p  # the members' inbound
                    drop[group_lanes[:, None], np.asarray(e.members)[None, :]] = p  # outbound
            elif e.kind == "dup":
                dup[group_lanes, :] = p
            elif e.kind == "skew":
                skew[self._rows(e.groups, e.members)] = p
        return dict(drop_num=drop, dup_num=dup, tick_skew_num=skew, part_send=send,
                    part_recv=recv, crash_at=crash, restart_at=restart)

    def resolve_kills(self, start: int, leader_lanes) -> None:
        """Pin leader-targeted kills that start at `start` to the leader
        lanes (leader_lanes: a callable giving the global lane array)."""
        for e in self.events:
            if e.kind == "kill" and e.lanes is None and e.start == start:
                lanes = np.asarray(leader_lanes(), np.int64)
                e.resolved = lanes[np.isin(lanes // self.v, e.groups)]


def skew_twin_schedule(*args, **kwargs):
    raise NotImplementedError(_WIRE)


# --------------------------------------------------------------------------
# recovery probe


class RecoveryProbe:
    """Per-heal-phase recovery accounting: ticks to re-election and to first
    commit per healed group, in le-bucket histograms. A group unrecovered
    when its phase is collected violates the SLO."""

    EDGES = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

    def __init__(self, tick_budget: int):
        self.tick_budget = int(tick_budget)
        self.phases: list[dict] = []
        nb = len(self.EDGES) + 1
        self._hist = {w: np.zeros(nb, np.int64) for w in ("reelect", "recommit")}
        self._sum = {"reelect": 0, "recommit": 0}
        self._count = {"reelect": 0, "recommit": 0}
        self.unrecovered = 0
        self.over_budget = 0

    def _fold(self, which: str, ticks: np.ndarray):
        ok = ticks[ticks >= 0]
        self.unrecovered += int(ticks.size - ok.size)
        self.over_budget += int((ok > self.tick_budget).sum())
        b = np.searchsorted(np.asarray(self.EDGES), ok, side="left")
        self._hist[which] += np.bincount(b, minlength=len(self.EDGES) + 1)
        self._sum[which] += int(ok.sum())
        self._count[which] += int(ok.size)

    def observe(self, heal_round: int, groups, reelect, recommit):
        """reelect / recommit: absolute rounds per group (NEVER =
        unrecovered); ticks count from the heal round, 1-based."""
        reelect = np.asarray(reelect, np.int64)
        recommit = np.asarray(recommit, np.int64)
        re_t = np.where(reelect == NEVER, -1, reelect - heal_round + 1)
        co_t = np.where(recommit == NEVER, -1, recommit - heal_round + 1)
        self._fold("reelect", re_t)
        self._fold("recommit", co_t)
        self.phases.append({
            "heal_round": int(heal_round),
            "groups": np.asarray(groups, np.int64).tolist(),
            "reelect_ticks": re_t.tolist(),
            "recommit_ticks": co_t.tolist(),
        })

    def ok(self) -> bool:
        return self.unrecovered == 0 and self.over_budget == 0

    def snapshot(self) -> dict:
        """The JAX package's snapshot: counters, the SLO, the phases and
        the two histograms."""
        out = {
            "counters": {
                "chaos_phases": len(self.phases),
                "chaos_groups_probed": self._count["reelect"] + self.unrecovered,
                "chaos_unrecovered": self.unrecovered,
                "chaos_over_budget": self.over_budget,
            },
            "slo": {"tick_budget": self.tick_budget, "ok": self.ok()},
            "phases": self.phases,
        }
        for which in ("reelect", "recommit"):
            out[f"hist_{which}"] = {
                "edges": list(self.EDGES),
                "buckets": self._hist[which].tolist(),
                "sum": self._sum[which],
                "count": self._count[which],
            }
        return out


# --------------------------------------------------------------------------
# runner


def election_safety_batched(c):
    """At most one leader per (group, term) now (raft_tpu/testing/
    invariants.py:83-109): a stale leader beside a new one in a different
    term is legal after a partition. Takes a FusedCluster or a
    BlockedFusedCluster (its blocks)."""
    blocks = getattr(c, "blocks", None)
    if blocks is not None:
        for b in blocks:
            election_safety_batched(b)
        return
    v = c.v
    lead = (c.state.state.cpu().numpy() == int(StateType.LEADER)).reshape(-1, v)
    tm = c.state.term.to(torch.int32).cpu().numpy().reshape(-1, v)
    both = lead[:, :, None] & lead[:, None, :] & (tm[:, :, None] == tm[:, None, :])
    both &= ~np.eye(v, dtype=bool)[None]
    if both.any():
        bad = np.nonzero(both.any(axis=(1, 2)))[0]
        raise AssertionError(f"two leaders share a term in group(s) {bad.tolist()[:16]}")


class ChaosRunner:
    """Drive a FusedCluster or BlockedFusedCluster built with chaos=True
    through a ChaosSchedule. settle: trailing rounds after the last event
    (default 2 * tick_budget); run_kw go to every cluster.run (default
    auto_propose=True, auto_compact_lag=8, as in the JAX package)."""

    def __init__(self, cluster, schedule: ChaosSchedule, *, tick_budget: int = 64,
                 settle: int | None = None, check_invariants: bool = True, **run_kw):
        if getattr(cluster, "chaos", None) is None and not getattr(cluster, "chaos_enabled", False):
            raise RuntimeError("cluster has no chaos plane (construct with chaos=True)")
        if (cluster.g, cluster.v) != (schedule.g, schedule.v):
            raise ValueError("schedule geometry != cluster geometry")
        self.cluster = cluster
        self.schedule = schedule
        self.probe = RecoveryProbe(tick_budget)
        self.settle = 2 * tick_budget if settle is None else settle
        self.check_invariants = check_invariants
        self.run_kw = dict(run_kw)
        self.run_kw.setdefault("auto_propose", True)
        self.run_kw.setdefault("auto_compact_lag", 8)

    def _collect(self, phases):
        """Fold pending phases into the probe from one read of the recovery
        columns (each lane keeps the absolute round of its recovery)."""
        if not phases:
            return
        cols = self.cluster.chaos_columns("reelect_round", "recommit_round")
        re = cols["reelect_round"].reshape(self.schedule.g, self.schedule.v)
        co = cols["recommit_round"].reshape(self.schedule.g, self.schedule.v)
        for heal_round, gs in phases:
            self.probe.observe(heal_round, gs, re[gs, 0], co[gs, 0])

    def run(self) -> dict:
        """The whole schedule; returns the probe snapshot. A phase stays
        armed to the end of the run, unless one of its groups heals again,
        which ends that group's window only."""
        v = self.schedule.v
        pending: list[tuple[int, np.ndarray]] = []
        for a, b in self.schedule.segments(self.settle):
            self.schedule.resolve_kills(a, self.cluster.leader_lanes)
            cols = self.schedule.columns(a)
            heal = self.schedule.heal_groups_at(a)
            if heal.size:
                clipped, still = [], []
                for hr, gs in pending:
                    again = np.isin(gs, heal)
                    if again.any():
                        clipped.append((hr, gs[again]))
                    if not again.all():
                        still.append((hr, gs[~again]))
                self._collect(clipped)
                pending = still
                # arm the probe for the healing groups only; the device
                # captures base_committed at round == heal_round
                cur = self.cluster.chaos_columns("reelect_round", "recommit_round")
                re = np.array(cur["reelect_round"], np.int32)
                co = np.array(cur["recommit_round"], np.int32)
                lanes = (heal[:, None] * v + np.arange(v)).reshape(-1)
                re[lanes] = NEVER
                co[lanes] = NEVER
                cols.update(heal_round=a, reelect_round=re, recommit_round=co)
                pending.append((a, heal))
            self.cluster.set_chaos(**cols)
            self.cluster.run(b - a, **self.run_kw)
            if self.check_invariants:
                self.cluster.check_no_errors()
                election_safety_batched(self.cluster)
        self._collect(pending)
        return self.probe.snapshot()


def trajectory_digest(cluster) -> str:
    """sha256 over the bytes of every state and chaos leaf of the cluster
    (each block's), in field order: the JAX package's formula, so the two
    packages' runs compare."""
    h = hashlib.sha256()
    for b in getattr(cluster, "blocks", None) or [cluster]:
        for leaf in interop.to_numpy_leaves(b.state) + interop.to_numpy_leaves(b.chaos):
            h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()
