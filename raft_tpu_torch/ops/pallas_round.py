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
- Chaos (chaos/device.py): the knob columns go in, the probe columns in
  and out, and the scalars round, heal_round and seed; on the
  card the kernel's chaos build runs (round_cuda.target(chaos=True)). The
  fault draws are functions of the global lane (the CUDA block's first
  lane is the window's offset, as JAX's program_id * tile_lanes) and of
  the absolute round, so blocks and K are invisible to the fault
  timeline. The group recounts n_reelected / n_recommitted go into the
  partials row after the metrics slots (or at 0 without metrics); they
  are absolute, so only the last round's row, summed over blocks, lands
  in the carry (`fold_chaos`).

- Lease (ops/lease.py): a state with the lease columns carries them
  through the launch, and every round ends in the lease tail with the
  engine's margin (`lease_margin`, a launch argument, so one build serves
  every margin); on the card the kernel's lease build runs
  (round_cuda.target(lease=True)), composed with each build above.
- Diet-v2: a packed carry (state.is_packed) enters, crosses every
  boundary between in-kernel rounds and leaves packed, through the
  fused.store_carry / load_carry pair the eager engine crosses; on the
  card it runs the kernel's diet build (round_cuda.target(diet=True)).
- Paged (ops/paged.py): host-boundary mode pages the whole window in
  before the launches and out after them, in plain PyTorch on the device,
  and the kernel runs on the full window as ever. In-kernel mode
  (paged_inkernel) hands the resident tails and the PagedLog to the
  kernel's paged build: each lane tile is one allocation segment with its
  own sub-pool and is paged in at the top of a launch and out (with the
  allocator skipped where no lane of the tile moved) at its end. The
  default tile is JAX's, `default_tile`; on the card a tile is
  tile_lanes / cta CUDA blocks that meet at a segment barrier before they
  page out (csrc/round.cu), so they must all fit the card at once
  (`check_paged_block`, TileError otherwise). Chaos composes with both
  modes (the chaos build with paging, round_cuda.target(chaos=True,
  plan=...)): paging is invisible to a chaos trajectory, since a crash
  wipe keeps the log.

Not carried over from the JAX engine: the trace plane (it raises
NotImplementedError at FusedCluster construction, as on the eager path),
the Mosaic (tile, K) autotune sweep, interpret mode,
and the engine fallback: a build or launch failure raises, and
engine="pallas" never becomes "xla" on its own. The port reads no
environment variables: the engine, tile and K are constructor arguments.
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch.chaos import device as chmod
from raft_tpu_torch.metrics import device as metmod
from raft_tpu_torch.ops import fused as fmod
from raft_tpu_torch.ops import log as lgmod
from raft_tpu_torch.ops import paged as pgmod
from raft_tpu_torch.ops import round_cuda

I32 = torch.int32

ENGINES = ("xla", "pallas")

# Width of the per-(round, CUDA block) partials row (raft_tpu/ops/
# pallas_round.py:109-120). Layout (int32): [0:C) counter deltas
# (C = len(COUNTERS)), [C:C+B) latency histogram deltas (B = N_BUCKETS),
# [C+B] lat_sum delta, then [X], [X+1] the chaos recounts n_reelected and
# n_recommitted of the block (X = C+B+1 with metrics, else 0), then zeros.
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


def shape_dims(shape) -> dict:
    """The Shape's {v, w, e, f, r} (round_cuda's dims)."""
    return {"v": shape.max_peers, "w": shape.log_window, "e": shape.max_msg_entries,
            "f": shape.max_inflight, "r": shape.max_read_index}


def paged_cta(shape, tile_lanes: int, chaos: bool = False) -> int:
    """The CUDA block of the paged build for a lane tile: the engine's
    (round_cuda.cta_lanes), within the paged build's shared memory."""
    return round_cuda.cta_lanes(tile_lanes, shape.max_peers, shape_dims(shape),
                                chaos=chaos, paged=True)


def check_paged_block(shape, tile_lanes: int, cta: int | None = None, *,
                      resident: int | None = None, chaos: bool = False) -> int:
    """In-kernel paging on the card runs each lane tile (one allocation
    segment) as tile_lanes / cta CUDA blocks that meet at a barrier in
    device memory. TileError, naming the numbers, unless the block (default
    paged_cta) divides the tile, fits MAX_SMEM, and, given `resident` (the
    blocks the card holds at once, round_cuda.resident_blocks), the
    segment's blocks all fit the card at once. Returns the block."""
    d = shape_dims(shape)
    cta = cta or paged_cta(shape, tile_lanes, chaos)
    if tile_lanes % cta:
        raise TileError(
            f"tile_lanes={tile_lanes} is not a multiple of the CUDA block of {cta} lanes: "
            "in-kernel paging on the card runs each lane tile as whole CUDA blocks"
        )
    smem = round_cuda.smem_bytes(d, cta, paged=True, chaos=chaos)
    if smem > round_cuda.MAX_SMEM:
        raise TileError(
            f"a CUDA block of {cta} lanes at {round_cuda.shape_name(d)} needs {smem} bytes "
            f"of shared memory, over MAX_SMEM={round_cuda.MAX_SMEM}"
        )
    if resident is not None and tile_lanes // cta > resident:
        raise TileError(
            f"tile_lanes={tile_lanes} is {tile_lanes // cta} CUDA blocks of {cta} lanes, "
            f"over the {resident} this card holds at once: the blocks of an allocation "
            "segment wait for each other at its barrier"
        )
    return cta


# --------------------------------------------------------------------------
# the kernel's plain version


def round_kernel_ref(
    state, fab, ops, mute, sampler, round_ctr, *, v, kc, cta, apply_ops=True,
    ops_round0_only=True, do_tick=True, auto_propose=False, auto_compact_lag=None,
    paged=None, chaos=None, seg_lanes=None, lease_margin=1,
):
    """What one launch of csrc/round.cu computes, in plain PyTorch: kc
    rounds of route_fabric -> fused_round on the carry, its storage
    boundary (fused.carry_boundary: the slim casts, or on a packed carry
    the diet-v2 store_carry / load_carry pair) replayed between rounds,
    ops applied (when apply_ops) in round 0 only or in every round, and
    with metrics on (sampler given) fresh zeroed delta slots each round,
    one row per run of `cta` lanes. With `paged` (the paged build: the
    state's log leaves are resident tails) each run of `seg_lanes` lanes
    (default cta) is an allocation segment: page_in on the stored carry at
    the top, the rounds on the full window, and page_out_cond after the
    last store, as raft_tpu/ops/pallas_round.py:589-597 and :707-725 order
    them. With `chaos` (a ChaosState: its round, heal_round and seed the
    launch's scalars) chaos.begin_round after routing and end_round after
    each round, over global lanes, as :616-700 order them, and each row's
    chaos slots the block's recounts; with both, inside the paging, as
    :589-730. A state with the lease columns runs the lease tail of
    every round with `lease_margin`. Returns (state, fab, sampler,
    partials [kc, n / cta, PARTIAL_WIDTH] or None), then the PagedLog
    when paged, then the probe columns (chaos.PROBES) when chaos, as
    round_cuda.round_call does."""
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
    load, store = fmod.carry_boundary(state)
    st, fb = store(state, fab)
    segs = n // (seg_lanes or cta)
    if paged is not None:
        st, paged = pgmod.page_in(st, paged, segs)
        last_pre, snap_pre = st.last.to(I32), st.snap_index.to(I32)
    parts = []
    ch = chaos
    for k in range(kc):
        if mt is not None:
            mt = dataclasses.replace(
                mt,
                counters=torch.zeros((rows, nc), dtype=I32, device=dev),
                hist=torch.zeros((rows, nb), dtype=I32, device=dev),
                lat_sum=torch.zeros((rows,), dtype=I32, device=dev),
            )
        o = ops if apply_ops and (k == 0 or not ops_round0_only) else zero_ops
        st, fb = load(st, fb)
        inb = fmod.route_fabric(fb, v, mute, peer_mute=peer_mute)
        tick_mask = None
        if ch is not None:
            ch, st, inb, o, tick_mask = chmod.begin_round(ch, st, inb, o, v)
        res = fmod.fused_round(
            st, inb, o, mute, peer_mute=peer_mute, do_tick=do_tick,
            auto_propose=auto_propose, auto_compact_lag=auto_compact_lag,
            tick_mask=tick_mask, metrics=mt, lease_margin=lease_margin,
        )
        st2, fb2 = res[0], res[1]
        row = []
        if mt is not None:
            mt = res[2]
            row += [mt.counters, mt.hist, mt.lat_sum[:, None]]
        if ch is not None:
            ch, fb2 = chmod.end_round(ch, st2, fb, fb2, v)
            # the block's recounts: lanes with a recorded round, over V
            row += [((getattr(ch, p) != chmod.NEVER).reshape(rows, cta).sum(1, dtype=I32)
                     // v)[:, None] for p in ("reelect_round", "recommit_round")]
        st, fb = store(st2, fb2)
        if row:
            row = torch.cat(row, dim=1)
            parts.append(torch.nn.functional.pad(row, (0, PARTIAL_WIDTH - row.shape[1])))
    if paged is not None:
        can_skip = fab.rep.ent_term.shape[-1] <= paged.w_res
        st, paged = pgmod.page_out_cond(st, paged, last_pre, snap_pre, can_skip=can_skip,
                                        segs=segs)
    samp = (mt.samp_index, mt.samp_round) if mt is not None else None
    out = (st, fb, samp, torch.stack(parts) if parts else None)
    if paged is not None:
        out += (paged,)
    if ch is not None:
        out += (tuple(getattr(ch, p) for p in chmod.PROBES),)
    return out


# --------------------------------------------------------------------------
# the engine


def fold_partials(metrics, sampler, parts, kc: int):
    """The metrics carry after one launch of kc rounds: the metrics slots of
    the partials rows of every round and block summed into the counters
    (int32 wrap-add is associative, so this equals kc sequential adds),
    the sampler columns the launch wrote, and the round counter advanced
    by kc."""
    nc, nb = len(metmod.COUNTERS), metmod.N_BUCKETS
    dsum = parts[..., : nc + nb + 1].sum(dim=(0, 1), dtype=I32)
    return dataclasses.replace(
        metrics,
        counters=metrics.counters + dsum[:nc],
        hist=metrics.hist + dsum[nc : nc + nb],
        lat_sum=metrics.lat_sum + dsum[nc + nb],
        round_ctr=metrics.round_ctr + kc,
        samp_index=sampler[0],
        samp_round=sampler[1],
    )


def chaos_slot(metrics: bool) -> int:
    """The partials column of n_reelected (n_recommitted the next one)."""
    return len(metmod.COUNTERS) + metmod.N_BUCKETS + 1 if metrics else 0


def fold_chaos(chaos, probes, parts, kc: int, metrics: bool):
    """The chaos carry after one launch of kc rounds: the probe columns the
    launch wrote, the recounts of its last round's row summed over blocks
    (absolute counts: the last row wins), and the round advanced by kc."""
    x = chaos_slot(metrics)
    last = parts[kc - 1].sum(dim=0, dtype=I32)
    return dataclasses.replace(
        chaos, **dict(zip(chmod.PROBES, probes)),
        n_reelected=last[x], n_recommitted=last[x + 1], round=chaos.round + kc,
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
    paged_inkernel: bool = False,
    metrics: metmod.MetricsState | None = None,
    chaos: chmod.ChaosState | None = None,
    paged: pgmod.PagedLog | None = None,
    segments: round_cuda.Segments | None = None,
    lease_margin: int = 1,
):
    """n_rounds fused rounds as launches of K = rounds_per_call rounds each,
    plus one remainder launch when K does not divide n_rounds. Same
    contract and trajectory as ops/fused.py fused_rounds (module doc).
    segments: the segment barrier's scratch of in-kernel paging on the
    card, required there when a tile spans CUDA blocks (FusedCluster keeps
    one). lease_margin: the lease plane's margin, for a state with the
    lease columns. Returns (state, fab[, metrics][, chaos][,
    paged])."""
    validate_round_plan(rounds_per_call)
    state, fab = fmod.carry_boundary(state)[1](state, fab)
    inkernel = paged is not None and paged_inkernel
    if paged is not None and not inkernel:
        state, paged = pgmod.page_in(state, paged)
    n = state.term.shape[0]
    check_tile(n, v, tile_lanes)
    if inkernel:
        n_tiles = n // tile_lanes
        if paged.pool_term.shape[0] % n_tiles:
            raise TileError(
                f"pool_pages={paged.pool_term.shape[0]} does not divide "
                f"into {n_tiles} tiles of {tile_lanes} lanes: in-kernel "
                "paging slices the pool per grid step (segment-local "
                "allocation); pin RAFT_TPU_POOL_PAGES / "
                "RAFT_TPU_PALLAS_TILE so the pool splits evenly"
            )
        # one tile is one allocation segment: tile_lanes / cta CUDA blocks
        cta = round_cuda.cta_lanes(tile_lanes, v, round_cuda.dims_of(state, fab, v, paged),
                                   chaos=chaos is not None, paged=True)
    else:
        cta = round_cuda.cta_lanes(tile_lanes, v, round_cuda.dims_of(state, fab, v),
                                   chaos=chaos is not None)

    kc = max(1, min(rounds_per_call, n_rounds)) if n_rounds else 1
    n_full, rem = divmod(n_rounds, kc)
    calls = [kc] * n_full + ([rem] if rem else [])
    for i, k in enumerate(calls):
        sampler = (metrics.samp_index, metrics.samp_round) if metrics is not None else None
        out = round_cuda.round_call(
            state, fab, ops, mute, sampler,
            metrics.round_ctr if metrics is not None else None,
            v=v, kc=k, cta=cta,
            apply_ops=i == 0 or not ops_first_round_only,
            ops_round0_only=ops_first_round_only,
            do_tick=do_tick, auto_propose=auto_propose,
            auto_compact_lag=auto_compact_lag, paged=paged if inkernel else None,
            chaos=chaos, seg_lanes=tile_lanes, segments=segments, lease_margin=lease_margin,
        )
        state, fab, sampler, parts = out[:4]
        if inkernel:
            paged = out[4]
        if metrics is not None:
            metrics = fold_partials(metrics, sampler, parts, k)
        if chaos is not None:
            chaos = fold_chaos(chaos, out[-1], parts, k, metrics is not None)
    if paged is not None and not inkernel:
        state, paged = pgmod.page_out(state, paged)
    elif paged is None:
        # the canonical zeros-outside-window layout, as fused_rounds leaves it
        state = lgmod.scrub_stale_slots(state)
    res = (state, fab)
    if metrics is not None:
        res += (metrics,)
    if chaos is not None:
        res += (chaos,)
    if paged is not None:
        res += (paged,)
    return res
