"""The `pallas` engine: K fused rounds per kernel launch
(raft_tpu/ops/pallas_round.py).

The eager round (ops/fused.py) launches about 3,600 small CUDA kernels per
block-round and is bound by the host's launch rate. This engine runs K
rounds of route_fabric + fused_round per launch of one hand-written CUDA
kernel (csrc/round.cu `round_kernel`, through ops/round_cuda.py): each
thread reads its lane's slim carry once, runs the K rounds with the carry
on the chip, and writes it back once. `n_rounds` that K does not divide
runs as the full-K launches plus one remainder launch.

Contract with ops/fused.py fused_rounds, as in the JAX package:

- `pallas_rounds` mirrors fused_rounds' signature and return tuple
  (state, fab[, metrics]) and walks the same trajectory bit for bit at
  every K: between in-kernel rounds the carry crosses the slim dtypes
  exactly as it does between launches.
- Tile invariant: `tile_lanes % v == 0` and `n % tile_lanes == 0`
  (TileError otherwise), so a raft group never straddles a tile. On the
  card a CUDA block covers a whole number of groups inside the tile
  (round_cuda.cta_lanes); tile_lanes stays the API's alignment contract.
- Metrics: each (round, CUDA block) writes one int32 partials row of
  width PARTIAL_WIDTH (counter deltas, latency histogram deltas, lat_sum
  delta); the rows are summed outside the kernel. int32 wrap-add is
  associative, so the sum equals the eager round's, exactly.

Not carried over from the JAX engine: the chaos, trace, paged and diet
planes (they raise NotImplementedError at FusedCluster construction, as
on the eager path), the Mosaic (tile, K) autotune sweep, interpret mode,
and the engine fallback: a build or launch failure raises, and
engine="pallas" never becomes "xla" on its own. The port reads no
environment variables: the engine, tile and K are constructor arguments.
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch.metrics import device as metmod
from raft_tpu_torch.ops import fused as fmod
from raft_tpu_torch.ops import log as lgmod
from raft_tpu_torch.ops import round_cuda
from raft_tpu_torch.state import fat_state, slim_state

I32 = torch.int32

ENGINES = ("xla", "pallas")

# Width of the per-(round, CUDA block) partials row (raft_tpu/ops/
# pallas_round.py:109-120). Layout (int32): [0:C) counter deltas
# (C = len(COUNTERS)), [C:C+B) latency histogram deltas (B = N_BUCKETS),
# [C+B] lat_sum delta, then zeros.
PARTIAL_WIDTH = round_cuda.PARTIAL_WIDTH

# Rounds per launch are bounded as in the JAX package, with the same
# error; on the card a launch of K rounds is one loop, not an unrolled
# program, but the bound keeps one launch's time short.
MAX_ROUNDS_PER_CALL = 64


class TileError(ValueError):
    """A lane tile that violates the group-alignment invariant."""


def resolve_engine(engine: str | None = None) -> str:
    """The `engine=` argument, "xla" when None. Unknown names raise."""
    e = (engine or "xla").lower()
    if e not in ENGINES:
        raise ValueError(f"unknown engine {e!r}: expected one of {ENGINES}")
    return e


def validate_round_plan(rounds_per_call, *, round_chunk: int | None = None) -> None:
    """Up-front check of K (rounds_per_call) and its composition with the
    blocked scheduler's round_chunk."""
    if (
        not isinstance(rounds_per_call, int)
        or isinstance(rounds_per_call, bool)
        or rounds_per_call < 1
    ):
        raise ValueError(
            f"rounds_per_call must be an integer >= 1, got {rounds_per_call!r}"
        )
    if rounds_per_call > MAX_ROUNDS_PER_CALL:
        raise ValueError(
            f"rounds_per_call={rounds_per_call} exceeds "
            f"MAX_ROUNDS_PER_CALL={MAX_ROUNDS_PER_CALL}"
        )
    if round_chunk is not None and rounds_per_call > 1 and round_chunk % rounds_per_call:
        raise ValueError(
            f"round_chunk={round_chunk} is not a multiple of "
            f"rounds_per_call={rounds_per_call}: every blocked chunk would end "
            "in a remainder launch. Pick a K that divides round_chunk"
        )


def check_tile(n: int, v: int, tile_lanes: int) -> None:
    """Enforce the tile invariant with a clear error (TileError)."""
    if tile_lanes < 1:
        raise TileError(f"tile_lanes={tile_lanes} must be >= 1")
    if tile_lanes % v:
        raise TileError(
            f"tile_lanes={tile_lanes} is not a multiple of v={v}: a raft "
            "group's voters must never straddle a lane tile"
        )
    if n % tile_lanes:
        raise TileError(
            f"tile_lanes={tile_lanes} does not divide the lane count "
            f"n={n}: the tiles must cover the batch exactly"
        )


def tile_candidates(n: int, v: int) -> list[int]:
    """Group-aligned power-of-two sub-tiles plus the whole batch, every one
    dividing n."""
    cands = []
    for base in (256, 512, 1024, 2048, 4096):
        t = base * v
        if t < n and n % t == 0:
            cands.append(t)
    cands.append(n)
    return cands


def default_tile(n: int, v: int) -> int:
    """Largest candidate <= 1024*v, else the smallest candidate."""
    cands = tile_candidates(n, v)
    best = None
    for t in cands:
        if t <= 1024 * v:
            best = t
    return best if best is not None else cands[0]


# --------------------------------------------------------------------------
# the kernel's plain version


def round_kernel_ref(
    state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta, apply_ops=True,
    ops_round0_only=True, do_tick=True, auto_propose=False, auto_compact_lag=None,
):
    """What one launch of csrc/round.cu computes, in plain PyTorch: kc
    rounds of route_fabric -> fused_round on the slim carry, the slim casts
    replayed between rounds, ops applied (when apply_ops) in round 0 only
    or in every round, and with metrics on (sampler given) fresh zeroed
    delta slots each round, one row per run of `cta` lanes. Returns
    (state, fab, sampler, partials [kc, n / cta, PARTIAL_WIDTH] or None),
    as round_cuda.round_call does."""
    n = state.term.shape[0]
    dev = state.term.device
    rows = n // cta
    nc, nb = len(metmod.COUNTERS), metmod.N_BUCKETS
    peer_mute = fmod.aligned_peer_mute(mute, v) if mute is not None else None
    zero_ops = fmod.LocalOps(*(torch.zeros_like(x) for x in ops))
    mt = None
    if sampler is not None:
        mt = metmod.MetricsState(
            counters=None, hist=None, lat_sum=None, round_ctr=round_ctr,
            samp_index=sampler[0], samp_round=sampler[1],
        )
    st, fb = slim_state(state), fmod.slim_fabric(fab)
    parts = []
    for k in range(kc):
        if mt is not None:
            mt = dataclasses.replace(
                mt,
                counters=torch.zeros((rows, nc), dtype=I32, device=dev),
                hist=torch.zeros((rows, nb), dtype=I32, device=dev),
                lat_sum=torch.zeros((rows,), dtype=I32, device=dev),
            )
        o = ops if apply_ops and (k == 0 or not ops_round0_only) else zero_ops
        inb = fmod.route_fabric(fmod.fat_fabric(fb), v, mute, peer_mute=peer_mute)
        res = fmod.fused_round(
            fat_state(st), inb, o, mute, peer_mute=peer_mute, do_tick=do_tick,
            auto_propose=auto_propose, auto_compact_lag=auto_compact_lag, metrics=mt,
        )
        st, fb = slim_state(res[0]), fmod.slim_fabric(res[1])
        if mt is not None:
            mt = res[2]
            row = torch.cat([mt.counters, mt.hist, mt.lat_sum[:, None]], dim=1)
            parts.append(torch.nn.functional.pad(row, (0, PARTIAL_WIDTH - row.shape[1])))
    if mt is None:
        return st, fb, None, None
    return st, fb, (mt.samp_index, mt.samp_round), torch.stack(parts)


# --------------------------------------------------------------------------
# the engine


def fold_partials(metrics, sampler, parts, kc: int):
    """The metrics carry after one launch of kc rounds: the partials rows of
    every round and block summed into the counters (int32 wrap-add is
    associative, so this equals kc sequential adds), the sampler columns
    the launch wrote, and the round counter advanced by kc."""
    nc, nb = len(metmod.COUNTERS), metmod.N_BUCKETS
    dsum = parts.sum(dim=(0, 1), dtype=I32)
    return dataclasses.replace(
        metrics,
        counters=metrics.counters + dsum[:nc],
        hist=metrics.hist + dsum[nc : nc + nb],
        lat_sum=metrics.lat_sum + dsum[nc + nb],
        round_ctr=metrics.round_ctr + kc,
        samp_index=sampler[0],
        samp_round=sampler[1],
    )


def pallas_rounds(
    state,
    fab,
    ops,
    mute,
    *,
    v: int,
    tile_lanes: int,
    n_rounds: int,
    rounds_per_call: int = 1,
    do_tick: bool = True,
    auto_propose: bool = False,
    auto_compact_lag: int | None = None,
    ops_first_round_only: bool = True,
    metrics: metmod.MetricsState | None = None,
):
    """n_rounds fused rounds as launches of K = rounds_per_call rounds each,
    plus one remainder launch when K does not divide n_rounds. Same
    contract and trajectory as ops/fused.py fused_rounds (module doc).
    Returns (state, fab) or (state, fab, metrics)."""
    validate_round_plan(rounds_per_call)
    state = slim_state(state)
    fab = fmod.slim_fabric(fab)
    n = state.term.shape[0]
    check_tile(n, v, tile_lanes)
    cta = round_cuda.cta_lanes(tile_lanes, v, round_cuda.dims_of(state, fab, v))

    kc = max(1, min(rounds_per_call, n_rounds)) if n_rounds else 1
    n_full, rem = divmod(n_rounds, kc)
    calls = [kc] * n_full + ([rem] if rem else [])
    for i, k in enumerate(calls):
        sampler = (metrics.samp_index, metrics.samp_round) if metrics is not None else None
        state, fab, sampler, parts = round_cuda.round_call(
            state, fab, ops, mute, sampler,
            metrics.round_ctr if metrics is not None else None,
            v=v, kc=k, cta=cta,
            apply_ops=i == 0 or not ops_first_round_only,
            ops_round0_only=ops_first_round_only,
            do_tick=do_tick, auto_propose=auto_propose,
            auto_compact_lag=auto_compact_lag,
        )
        if metrics is not None:
            metrics = fold_partials(metrics, sampler, parts, k)
    # the canonical zeros-outside-window layout, as fused_rounds leaves it
    state = lgmod.scrub_stale_slots(state)
    if metrics is None:
        return state, fab
    return state, fab, metrics
