"""Device half of the chaos plane (raft_tpu/chaos/device.py): the
`ChaosState` carried through the fused round beside the metrics plane.

Faults are batched tensor ops around every round, drawn from a
counter-based hash of (seed, absolute round, global site index, salt), so
the fault timeline does not depend on how rounds are chunked into
dispatches or lanes into tiles, and two runs of one seed replay it bit for
bit. Fault model (host-settable columns, SETTABLE):

- drop_num [N, V]: per-inbound-edge loss probability in 2^-16 units
  (P_ONE = certain); each channel (rep/hb/vote/vresp) draws on its own.
- dup_num [N, V]: per-outbound-edge duplicate probability: after a round,
  the previous round's outbox cells are put back into still-empty cells of
  the new outbox, so the message is delivered again one round later.
- part_send / part_recv [N]: partition bitmasks; edge src->dst passes iff
  `part_send[src] & part_recv[dst] != 0` (different masks: asymmetric).
- tick_skew_num [N]: probability a lane skips its tick this round.
- crash_at / restart_at [N]: while crash_at <= round < restart_at the lane
  is down: volatile state wiped at both edges (state.wipe_volatile), no
  inbound, no outbound, no tick, host ops zeroed. NEVER disables.

Recovery probe: from `heal_round` on, per group, the first round with a
leader (reelect_round) and the first with `committed` past its value at
the heal (recommit_round), and their group counts (n_reelected,
n_recommitted), read back by chaos/schedule.py RecoveryProbe.

PyTorch has no uint32 multiply or logical shift on the CPU or the card, so
the hash runs in int64 on values below 2^32, masked to 32 bits after every
step; a multiply by a 32-bit constant is split into 16-bit halves so that
no product reaches 2^63 (`_mul32`). The `seed` leaf stays uint32, as in
the JAX package, so the two digest alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from raft_tpu_torch.state import wipe_volatile
from raft_tpu_torch.types import MessageType as MT, StateType

I32 = torch.int32
I64 = torch.int64
U32 = torch.uint32
M32 = 0xFFFFFFFF

# "never": far beyond any soak horizon and far below the int32 limit
NEVER = 1 << 30

# fault probabilities are fixed point in 2^-16 units
P_ONE = 1 << 16

# per-site salts: every decision family hashes its own stream
_SALT_DROP_REP = 1
_SALT_DROP_HB = 2
_SALT_DROP_VOTE = 3
_SALT_DROP_VRESP = 4
_SALT_DUP_REP = 5
_SALT_DUP_HB = 6
_SALT_DUP_VOTE = 7
_SALT_DUP_VRESP = 8
_SALT_TICK_SKEW = 9

CHANNELS = ("rep", "hb", "vote", "vresp")
DROP_SALTS = (_SALT_DROP_REP, _SALT_DROP_HB, _SALT_DROP_VOTE, _SALT_DROP_VRESP)
DUP_SALTS = (_SALT_DUP_REP, _SALT_DUP_HB, _SALT_DUP_VOTE, _SALT_DUP_VRESP)


@dataclasses.dataclass
class ChaosState:
    """The chaos carry, in the JAX package's field order."""

    seed: Any  # [] u32 PRNG stream id (derived from the cluster seed)
    round: Any  # [] i32 absolute chaos round (never resets)
    drop_num: Any  # [N, V] i32 inbound-edge drop probability (2^-16 units)
    dup_num: Any  # [N, V] i32 outbound-edge duplicate probability
    part_send: Any  # [N] i32 partition send bitmask (default 1)
    part_recv: Any  # [N] i32 partition recv bitmask (default 1)
    tick_skew_num: Any  # [N] i32 tick-skip probability
    crash_at: Any  # [N] i32 absolute crash round (NEVER = alive)
    restart_at: Any  # [N] i32 absolute restart round (NEVER = stays down)
    heal_round: Any  # [] i32 recovery probe armed from this round (NEVER = off)
    base_committed: Any  # [N] i32 committed captured at the heal round
    reelect_round: Any  # [N] i32 first round with a leader post-heal (NEVER)
    recommit_round: Any  # [N] i32 first round committed > base post-heal
    n_reelected: Any  # [] i32 groups with reelect_round recorded
    n_recommitted: Any  # [] i32 groups with recommit_round recorded


# host-settable knob columns (FusedCluster.set_chaos) and the probe columns
# the host reads back after a heal phase
SETTABLE = (
    "drop_num", "dup_num", "part_send", "part_recv", "tick_skew_num", "crash_at",
    "restart_at", "heal_round", "base_committed", "reelect_round", "recommit_round",
)
PROBE_FIELDS = (
    "round", "heal_round", "base_committed", "reelect_round", "recommit_round",
    "n_reelected", "n_recommitted",
)
# the per-lane columns a round kernel reads (KNOBS) and reads and writes
# (PROBES), in the order of raft_tpu/ops/pallas_round.py:134-143
KNOBS = ("drop_num", "dup_num", "part_send", "part_recv", "tick_skew_num", "crash_at",
         "restart_at")
PROBES = ("base_committed", "reelect_round", "recommit_round")


def probability(p: float) -> int:
    """Float probability -> fixed-point 2^-16 knob value."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"probability {p} outside [0, 1]")
    return min(P_ONE, int(round(p * P_ONE)))


def init_chaos(n: int, v: int, seed: int = 1, chaos_seed: int = 0, *, device) -> ChaosState:
    """All-quiet chaos state for N = G*V lanes, every field its own tensor.
    The PRNG stream derives from the cluster seed plus chaos_seed
    (raft_tpu/chaos/device.py:163-171), so sibling blocks of a
    BlockedFusedCluster (seed + 7919*i) decorrelate."""
    if n % v:
        raise ValueError("chaos plane requires group-aligned lanes (N = G*V)")
    dev = torch.device(device)
    sid = (((seed + chaos_seed) * 2654435761) ^ 0x5EEDC0DE) & M32

    def full(shape, value):
        return torch.full(shape, value, dtype=I32, device=dev)

    return ChaosState(
        seed=torch.tensor(sid, dtype=U32, device=dev),
        round=full((), 0),
        drop_num=full((n, v), 0),
        dup_num=full((n, v), 0),
        part_send=full((n,), 1),
        part_recv=full((n,), 1),
        tick_skew_num=full((n,), 0),
        crash_at=full((n,), NEVER),
        restart_at=full((n,), NEVER),
        heal_round=full((), NEVER),
        base_committed=full((n,), 0),
        reelect_round=full((n,), NEVER),
        recommit_round=full((n,), NEVER),
        n_reelected=full((), 0),
        n_recommitted=full((), 0),
    )


def with_columns(chaos: ChaosState, **cols) -> ChaosState:
    """Host setter: overwrite SETTABLE columns ([N] / [N, V] arrays, or
    scalars to broadcast); each written column is a new tensor."""
    upd = {}
    for k, val in cols.items():
        if k not in SETTABLE:
            raise KeyError(f"not a settable chaos column: {k!r} (see SETTABLE)")
        cur = getattr(chaos, k)
        x = val if isinstance(val, torch.Tensor) else torch.from_numpy(np.array(val))
        x = x.to(device=cur.device, dtype=cur.dtype)
        upd[k] = x.expand(cur.shape).clone()
    return dataclasses.replace(chaos, **upd) if upd else chaos


# --------------------------------------------------------------------------
# counter-based PRNG, uint32 arithmetic on int64 values below 2^32


def _mul32(x, c: int):
    """x * c mod 2^32 for 0 <= x < 2^32: the 16-bit halves of x times c
    stay below 2^48, so the int64 products are exact."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _mix(x):
    """32-bit finalizer (lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u32(x):
    """An integer tensor or int as int64 in [0, 2^32) (the uint32 bits)."""
    if not isinstance(x, torch.Tensor):
        return int(x) & M32
    return x.to(I64) & M32


def chaos_bits(seed, rnd, idx, salt: int):
    """uint32 hash (as int64) of (seed, round, site index, salt)."""
    x = (
        _mul32(_u32(idx), 0x9E3779B9)
        + _mul32(_u32(rnd), 0x85EBCA6B)
        + _u32(seed)
        + (salt * 0xC2B2AE35 & M32)
    ) & M32
    return _mix(x)


def _decide(seed, rnd, idx, salt: int, num):
    """True with probability num / 2^16 (num >= P_ONE: always)."""
    return (chaos_bits(seed, rnd, idx, salt) & 0xFFFF) < num


# --------------------------------------------------------------------------
# round hooks (ops/fused.py fused_rounds, and per lane window from the
# round kernel's plain version with lane_offset = the window's first lane)


def _lane_edge(n: int, v: int, lane_offset, device):
    """Global (lane, edge) PRNG site indices of a window of n lanes that
    starts at lane_offset (None = 0): a tiled run reproduces the
    monolithic fault stream."""
    lane = torch.arange(n, dtype=I64, device=device)
    if lane_offset is not None:
        lane = lane + int(lane_offset)
    edge = lane[:, None] * v + torch.arange(v, dtype=I64, device=device)[None, :]
    return lane & M32, edge & M32


def _peer_cols(x, v: int):
    """[N] column -> [N, V], cell [d, i] the value of d's group member i."""
    n = x.shape[0]
    g = n // v
    return x.reshape(g, 1, v).expand(g, v, v).reshape(n, v)


def _group_any(x, v: int):
    """[N] bool -> [N] bool, true on every lane of a group where any is."""
    n = x.shape[0]
    g = n // v
    return x.reshape(g, v).any(dim=1)[:, None].expand(g, v).reshape(n)


def _none_where(c, kind):
    return torch.where(c, torch.full((), int(MT.MSG_NONE), dtype=kind.dtype,
                                     device=kind.device), kind)


def begin_round(chaos: ChaosState, state, inb, ops, v: int, *, lane_offset=None):
    """Faults before the step: crash-window wipes, inbound cuts (drop,
    partition, crash), host ops zeroed on down lanes, the tick mask, and
    the probe's committed baseline at the heal round. `state` and `inb`
    are the fat round inputs, `inb` already routed. Returns (chaos, state,
    inb, ops, tick_mask)."""
    n = state.id.shape[0]
    rnd, seed = chaos.round, chaos.seed
    lane, edge = _lane_edge(n, v, lane_offset, state.id.device)

    wipe = (rnd == chaos.crash_at) | (rnd == chaos.restart_at)
    state = wipe_volatile(state, wipe)
    crashed = (rnd >= chaos.crash_at) & (rnd < chaos.restart_at)

    # inb cell [d, i] carries the message from d's group member i
    allowed = (_peer_cols(chaos.part_send, v) & chaos.part_recv[:, None]) != 0
    base_cut = ~allowed | crashed[:, None] | _peer_cols(crashed, v)

    def cut(chan, salt: int):
        c = base_cut | _decide(seed, rnd, edge, salt, chaos.drop_num)
        return dataclasses.replace(chan, kind=_none_where(c, chan.kind))

    inb = dataclasses.replace(
        inb,
        **{ch: cut(getattr(inb, ch), salt) for ch, salt in zip(CHANNELS, DROP_SALTS)},
        # the self slot is a local ack: cut only when the lane is down
        self_=dataclasses.replace(inb.self_, kind=_none_where(crashed, inb.self_.kind)),
    )
    ops = type(ops)(*(torch.where(crashed, torch.zeros_like(x), x) for x in ops))

    skip = _decide(seed, rnd, lane, _SALT_TICK_SKEW, chaos.tick_skew_num)
    tick_mask = ~crashed & ~skip
    chaos = dataclasses.replace(
        chaos,
        base_committed=torch.where(rnd == chaos.heal_round, state.committed,
                                   chaos.base_committed),
    )
    return chaos, state, inb, ops, tick_mask


def end_round(chaos: ChaosState, state, prev_fab, out_fab, v: int, *, lane_offset=None):
    """Faults after the step: duplicate redelivery into `out_fab` (the FAT
    outbox just produced) from `prev_fab` (the FAT outbox delivered this
    round), the recovery probe on the post-round `state` (per group, the
    first post-heal round with a leader and with committed past the heal
    baseline), the group recounts and the round advance. Returns (chaos,
    out_fab)."""
    rnd = chaos.round
    _, edge = _lane_edge(state.id.shape[0], v, lane_offset, state.id.device)

    def dup(prev, new, salt: int):
        keep = (
            (prev.kind != MT.MSG_NONE)
            & (new.kind == MT.MSG_NONE)
            & _decide(chaos.seed, rnd, edge, salt, chaos.dup_num)
        )
        return type(new)(**{
            f.name: torch.where(keep[..., None] if getattr(new, f.name).ndim == 3 else keep,
                                getattr(prev, f.name), getattr(new, f.name))
            for f in dataclasses.fields(new)
        })

    out_fab = dataclasses.replace(
        out_fab,
        **{ch: dup(getattr(prev_fab, ch), getattr(out_fab, ch), salt)
           for ch, salt in zip(CHANNELS, DUP_SALTS)},
    )
    armed = rnd >= chaos.heal_round
    has_leader = _group_any(state.state == StateType.LEADER, v)
    past = _group_any(state.committed > chaos.base_committed, v)
    reelect = torch.where(armed & (chaos.reelect_round == NEVER) & has_leader, rnd,
                          chaos.reelect_round)
    recommit = torch.where(armed & (chaos.recommit_round == NEVER) & past, rnd,
                           chaos.recommit_round)
    chaos = dataclasses.replace(
        chaos,
        reelect_round=reelect,
        recommit_round=recommit,
        # absolute recounts, not deltas: the same after any round
        n_reelected=(reelect != NEVER).sum(dtype=I32) // v,
        n_recommitted=(recommit != NEVER).sum(dtype=I32) // v,
        round=rnd + 1,
    )
    return chaos, out_fab


def rebase(chaos: ChaosState, mask, delta) -> ChaosState:
    """base_committed holds absolute committed values: an index-space
    rebase (FusedCluster.rebase_groups) shifts it with its lanes."""
    return dataclasses.replace(
        chaos,
        base_committed=torch.where(mask, chaos.base_committed - delta, chaos.base_committed),
    )
