"""The port's paged entry log against the JAX package, leaf for leaf.

The JAX side runs with RAFT_TPU_PAGED=1 (and RAFT_TPU_PAGED_INKERNEL,
RAFT_TPU_PALLAS_TILE, RAFT_TPU_DIET where a case needs them, carry
donation off, metrics on); the port builds its clusters with paged=True.
Integer state: every comparison is exact, dtypes included, on every leaf
of the state, the fabric, the metrics and the PagedLog (page table, pool
and counters). Covered: the geometry checks and their messages; page_out /
page_in round trips at 1, 2 and 4 allocation segments, resegment, and a
pool that exhausts; the eager engine paging at the dispatch boundary and
around every round; the pallas engine's plain version paging at the
boundary and in the kernel (K = 1 and 4, tile 2 * V: two segments), diet
on and off, and with a pool that exhausts; rebase and adopt_state under
paging; and the blocked scheduler.

The JAX pallas engine compiles its in-kernel rounds unrolled (minutes in
interpret mode at K > 1), so the in-kernel reference is JAX's kernel body
composed from JAX's own functions in its order (raft_tpu/ops/
pallas_round.py:589-597 and :707-725): page_in_host per tile segment, the
launch's rounds as single-round fused_rounds dispatches, then
page_out_host, or where no lane of a segment moved, that segment's
resident tail with `skipped` bumped.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from raft_tpu import state as jst
from raft_tpu.config import Shape as JShape
from raft_tpu.ops import fused as jfused
from raft_tpu.ops import log as jlog
from raft_tpu.ops import paged as jpg
from raft_tpu.scheduler import BlockedFusedCluster as JBlocked
from raft_tpu_torch import interop
from raft_tpu_torch import state as tst
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import paged as tpg
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.scheduler import BlockedFusedCluster
from tests.test_torch_state import assert_same_leaves, jax_leaves

V = 3
G = 4
N = G * V
TILE = 2 * V
SEGS = N // TILE
SHAPE = dict(max_peers=V, log_window=16, max_msg_entries=2, max_inflight=2, max_read_index=2)
LAG = 12  # deep enough that logs outrun the 8-entry resident window
RUN = dict(auto_propose=True, auto_compact_lag=LAG)
STEP = 3  # rounds per JAX dispatch
ROUNDS = 33
KNOBS = ("DIET", "ENGINE", "PALLAS_ROUNDS", "PALLAS_TILE", "CHAOS", "TRACELOG", "LEASE",
         "TIER", "PAGED", "PAGED_INKERNEL", "PAGE_WINDOW", "PAGE_ENTRIES", "POOL_PAGES")


def _env(mp, **on):
    """Pin every RAFT_TPU_* knob the JAX constructors read: those in `on`
    set, the others removed; paging, metrics on, donation off."""
    for k in KNOBS:
        mp.delenv(f"RAFT_TPU_{k}", raising=False)
    mp.setenv("RAFT_TPU_PAGED", "1")
    mp.setenv("RAFT_TPU_DONATE", "0")
    mp.setenv("RAFT_TPU_METRICS", "1")
    for k, v in on.items():
        mp.setenv(f"RAFT_TPU_{k.upper()}", str(v))


@pytest.fixture(scope="module", autouse=True)
def _jax_paged_env():
    with pytest.MonkeyPatch.context() as mp:
        _env(mp)
        yield


def _shapes(pool: int = 0, n: int = N, **kw):
    return (JShape(n_lanes=n, pool_pages=pool, **SHAPE, **kw),
            Shape(n_lanes=n, pool_pages=pool, **SHAPE, **kw))


def _carry(c):
    return c.state, c.fab, c.metrics, c.paged


def _assert_carry(want, tc, what: str):
    """want: a JAX (state, fabric, metrics, paged) carry; tc: a port cluster."""
    for part, w, t in zip(("state", "fabric", "metrics", "paged"), want, _carry(tc)):
        assert_same_leaves(w, t, f"{what}: {part}")


# -- the geometry ------------------------------------------------------------------

SHAPE_BASE = dict(n_lanes=12, max_peers=3, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)


@pytest.mark.parametrize("kw", [
    dict(page_window=3), dict(page_window=16), dict(page_window=1),
    dict(page_entries=3), dict(page_entries=32), dict(pool_pages=1), dict(pool_pages=70000),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_shape_rejects_page_geometry_as_jax_does(kw):
    with pytest.raises(ValueError) as want:
        JShape(**{**SHAPE_BASE, **kw})
    with pytest.raises(ValueError) as got:
        Shape(**{**SHAPE_BASE, **kw})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,lanes", [
    (dict(log_window=2), 12),  # no room for a paged window
    (dict(pool_pages=2), 12),  # under kmax + 1
    (dict(pool_pages=3), 12),
    (dict(), 30_000),  # full provisioning over 65,536 pages
    (dict(page_window=4, page_entries=2, pool_pages=8), 12),  # taken
    (dict(), 12),
], ids=["window", "pool2", "pool3", "pool_too_big", "pinned", "default"])
def test_page_plan_matches_jax(kw, lanes):
    """validate_page_plan: the same plan, or the same error, in both."""
    js, ts = (S(**{**SHAPE_BASE, **kw}) for S in (JShape, Shape))
    try:
        want = jpg.validate_page_plan(js, lanes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpg.validate_page_plan(ts, lanes)
        assert str(got.value) == str(e)
        return
    got = tpg.validate_page_plan(ts, lanes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.kmax == want.kmax


@pytest.mark.parametrize("pool,segs", [(9, 2), (8, 4), (8, 2), (44, 2), (9, 1)])
def test_check_pool_segments_matches_jax(pool, segs):
    plans = [m.validate_page_plan(S(**{**SHAPE_BASE, "pool_pages": pool}), 12)
             for m, S in ((jpg, JShape), (tpg, Shape))]
    try:
        jpg.check_pool_segments(plans[0], segs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpg.check_pool_segments(plans[1], segs)
        assert str(got.value) == str(e)
        return
    tpg.check_pool_segments(plans[1], segs)


# -- page_out / page_in ----------------------------------------------------------------

_jax_split = jax.jit(jpg.split_state, static_argnums=(1, 2))


def _logged_state(seed: int, diet: bool = False):
    """The same slim state in both packages with ragged random log depth:
    every (snap, last] span from empty to the full window, garbage in the
    stale slots (tests/test_paged.py:_random_logged_state)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_PAGED", "0")  # the full window
        js = jst.slim_state(jfused.FusedCluster(G, V, seed=seed, shape=_shapes()[0]).state)
    n, w = np.asarray(js.log_term).shape
    rng = np.random.default_rng(seed)
    last = rng.integers(0, 50, size=n).astype(np.int32)
    snap = np.maximum(0, last - rng.integers(0, w + 1, size=n)).astype(np.int32)
    upd = dict(last=last, snap_index=snap,
               log_term=rng.integers(1, 9, (n, w)).astype(np.int32),
               log_type=rng.integers(0, 3, (n, w)).astype(np.int8),
               log_bytes=rng.integers(0, 100, (n, w)).astype(np.int32))
    js = dataclasses.replace(js, **{k: jax.numpy.asarray(v) for k, v in upd.items()})
    if diet:
        js = jst.pack_state(js)
    return js, interop.from_numpy_tree(tst.RaftState, jax_leaves(js), "cpu")


@pytest.mark.parametrize("segs,diet", [(1, False), (2, False), (4, False), (2, True)],
                         ids=["1", "2", "4", "2-diet"])
def test_page_round_trip_matches_jax(segs, diet):
    """split_state (page_out on a fresh sidecar), page_in_host and a second
    page_out at `segs` allocation segments: every leaf as JAX leaves it;
    the full window comes back scrubbed, page ids stay in their sub-pool,
    and a second split rebuilds the same table and pool."""
    js, ts = _logged_state(0, diet)
    plan_j = jpg.validate_page_plan(_shapes()[0], N)
    plan_t = tpg.validate_page_plan(_shapes()[1], N)
    jr, jp = _jax_split(js, plan_j, segs)
    tr, tp = tpg.split_state(ts, plan_t, segs)
    assert_same_leaves(jr, tr, "resident")
    assert_same_leaves(jp, tp, "paged")
    assert tr.log_term.shape == (N, plan_t.w_res)
    assert int(tp.pt.to(torch.int32).max()) < plan_t.pool_pages // segs
    jf, jp2 = jpg.page_in_host(jr, jp, segs)
    tf, tp2 = tpg.page_in_host(tr, tp, segs)
    assert_same_leaves(jf, tf, "page_in")
    assert_same_leaves(jp2, tp2, "page_in paged")
    canon = tst.unpack_state(tf) if diet else tf
    assert_same_leaves(jlog.scrub_stale_slots(jst.unpack_state(js)), canon, "scrubbed window")
    tr2, tp3 = tpg.page_out_host(tf, tp2, segs)
    assert torch.equal(tp3.pt, tp.pt) and torch.equal(tp3.pool_term, tp.pool_term)
    assert_same_leaves(jr, tr2, "re-split")


def test_resegment_matches_jax():
    """resegment 1 -> 4 -> 2: the ids move between sub-pools, the values do
    not, every leaf as in JAX."""
    js, ts = _logged_state(3)
    plan_j = jpg.validate_page_plan(_shapes()[0], N)
    plan_t = tpg.validate_page_plan(_shapes()[1], N)
    j, t = _jax_split(js, plan_j, 1), tpg.split_state(ts, plan_t, 1)
    for old, new in ((1, 4), (4, 2)):
        j = jpg.resegment(*j, old, new)
        t = tpg.resegment(*t, old, new)
        assert_same_leaves(j[0], t[0], f"resegment {old}->{new}: state")
        assert_same_leaves(j[1], t[1], f"resegment {old}->{new}: paged")
    assert_same_leaves(jpg.page_in_view(*j, 2), tpg.page_in_view(*t, 2), "view")


def test_exhaustion_clamps_and_flags_as_jax_does():
    """A pool too small for the batch (8 pages, kmax 7): the overflow pages
    drop, ERR_PAGE_EXHAUSTED and `exhausted` mark exactly the clamped
    lanes, and the rest round-trip; every leaf as in JAX."""
    js, ts = _logged_state(1)
    kw = dict(page_window=4, page_entries=2)
    plan_j = jpg.validate_page_plan(_shapes(8, **kw)[0], N)
    plan_t = tpg.validate_page_plan(_shapes(8, **kw)[1], N)
    assert plan_t.kmax == 7
    jr, jp = _jax_split(js, plan_j, 1)
    tr, tp = tpg.split_state(ts, plan_t, 1)
    assert_same_leaves(jr, tr, "resident")
    assert_same_leaves(jp, tp, "paged")
    exh = tp.exhausted > 0
    assert exh.any() and not exh.all()
    assert torch.equal((tr.error_bits & tst.ERR_PAGE_EXHAUSTED) != 0, exh)
    assert_same_leaves(jpg.page_in_view(jr, jp, 1), tpg.page_in_view(tr, tp, 1), "view")


# -- the engines ---------------------------------------------------------------------------

_jax_round = functools.partial(
    jfused._fused_rounds_nodonate_jit, v=V, n_rounds=1, do_tick=True,
    ops_first_round_only=True, straddle=None, **RUN)
_jax_tail = jax.jit(jpg._resident_tail)


def _per_segment(moved, a, b):
    """a where its allocation segment moved, else b (leaves split over SEGS
    runs of their leading dimension)."""
    a, b = np.asarray(a), np.asarray(b)
    sel = np.repeat(moved, a.shape[0] // SEGS).reshape((-1,) + (1,) * (a.ndim - 1))
    return jax.numpy.asarray(np.where(sel, a, b))


def _jax_inkernel_launch(c, kc: int):
    """One launch of JAX's in-kernel paging megakernel over c's carry, from
    JAX's functions in the kernel's order."""
    st, pg = jpg.page_in_host(c.state, c.paged, SEGS)
    last_pre = np.asarray(st.last).astype(np.int32)
    snap_pre = np.asarray(st.snap_index).astype(np.int32)
    fb, met = c.fab, c.metrics
    for _ in range(kc):
        st, fb, met = _jax_round(st, fb, c._no_ops, c.mute, metrics=met)
    moved = ((np.asarray(st.last).astype(np.int32) != last_pre)
             | (np.asarray(st.snap_index).astype(np.int32) != snap_pre)).reshape(SEGS, -1).any(1)
    if c.fab.rep.ent_term.shape[-1] > pg.w_res:
        moved[:] = True
    full_st, full_pg = jpg.page_out_host(st, pg, SEGS)
    skip_st = _jax_tail(st, pg)
    skip_pg = dataclasses.replace(pg, skipped=pg.skipped + 1)
    c.state = jax.tree.map(functools.partial(_per_segment, moved), full_st, skip_st)
    c.paged = jax.tree.map(functools.partial(_per_segment, moved), full_pg, skip_pg)
    c.fab, c.metrics = fb, met


@functools.cache
def _jax_twin(mode: str, diet: bool, pool: int):
    """The JAX cluster of seed 7 after ROUNDS rounds in `mode`: its carry
    (state, fabric, metrics, paged) and host_state."""
    kw = {}
    on = dict(diet=int(diet))
    if mode == "xla_inkernel":
        on["paged_inkernel"] = 1
    if mode == "pallas_inkernel":
        on.update(paged_inkernel=1, pallas_tile=TILE)
        kw = dict(engine="pallas")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, **on)
        c = jfused.FusedCluster(G, V, seed=7, shape=_shapes(pool)[0], **kw)
        assert c._paged_segs == (SEGS if mode == "pallas_inkernel" else 1)
        if mode == "pallas_inkernel":
            for _ in range(ROUNDS):  # K = 1 launches; the values at any K
                _jax_inkernel_launch(c, 1)
        else:
            for _ in range(ROUNDS // STEP):
                c.run(STEP, **RUN)
    return _carry(c), c.host_state()


def _port(mode: str, diet: bool, pool: int, k: int = 1):
    kw = dict(paged=True, diet=diet)
    if mode.startswith("pallas"):
        kw.update(engine="pallas", rounds_per_call=k, tile_lanes=TILE)
    if mode in ("xla_inkernel", "pallas_inkernel"):
        kw["paged_inkernel"] = True
    return tfused.FusedCluster(G, V, seed=7, shape=_shapes(pool)[1], device="cpu", **kw)


# (port engine, JAX twin, diet, pool pages, K): host-boundary pallas pages
# once a dispatch as the eager engine does, so the two share a twin
ENGINE_CASES = [
    ("xla", "xla", False, 0, 1),
    ("xla", "xla", True, 0, 1),
    ("xla_inkernel", "xla_inkernel", False, 0, 1),
    ("pallas", "xla", False, 0, 1),
    ("pallas", "xla", True, 0, 4),
    ("pallas_inkernel", "pallas_inkernel", False, 0, 1),
    ("pallas_inkernel", "pallas_inkernel", True, 0, 1),
    ("pallas_inkernel", "pallas_inkernel", False, 8, 1),
]


@pytest.mark.parametrize("mode,twin,diet,pool,k", ENGINE_CASES,
                         ids=lambda x: str(x) if not isinstance(x, bool) else ("diet" if x else "slim"))
def test_engine_matches_jax(mode, twin, diet, pool, k):
    """ROUNDS rounds in STEP-round dispatches: the raw carry, PagedLog
    included, as JAX's at the same paging mode and segmentation; the pool
    in use; with the pinned 8-page pool, lanes clamped and flagged."""
    want, host = _jax_twin(twin, diet, pool)
    tc = _port(mode, diet, pool, k)
    assert tc._paged_segs == (SEGS if mode == "pallas_inkernel" else 1)
    for _ in range(ROUNDS // STEP):
        tc.run(STEP, **RUN)
    _assert_carry(want, tc, f"{mode} K={k}")
    assert_same_leaves(host, tc.host_state(), "host_state")
    stats = tc.paged_stats()
    assert stats["paged_pool_in_use"] > 0
    assert (stats["paged_exhausted"] > 0) == (pool > 0)
    assert tst.is_packed(tc.state) == diet
    if "inkernel" in mode:
        assert stats["paged_alloc_skipped"] > 0


@pytest.mark.parametrize("diet", [False, True], ids=["slim", "diet"])
def test_pallas_inkernel_k4_matches_jax(diet):
    """K = 4 in-kernel: three 11-round dispatches (launches of 4, 4 and 3
    rounds) against the JAX kernel body at the same launches; the values
    equal the K = 1 twin's."""
    c = None
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, diet=int(diet), paged_inkernel=1, pallas_tile=TILE)
        c = jfused.FusedCluster(G, V, seed=7, shape=_shapes()[0], engine="pallas")
    tc = _port("pallas_inkernel", diet, 0, k=4)
    for _ in range(ROUNDS // 11):
        for kc in (4, 4, 3):
            _jax_inkernel_launch(c, kc)
        tc.run(11, **RUN)
    _assert_carry(_carry(c), tc, "pallas in-kernel K=4")
    assert_same_leaves(_jax_twin("pallas_inkernel", diet, 0)[1], tc.host_state(), "host_state")


def test_pallas_inkernel_pool_must_split_over_tiles():
    """In-kernel paging refuses a pool that does not split over the tiles,
    at construction and at the engine, with JAX's message there."""
    with pytest.raises(ValueError, match="allocation segments"):
        _port("pallas_inkernel", False, pool=45)
    tc = _port("pallas_inkernel", False, pool=44)
    bad = dataclasses.replace(tc.paged, pool_term=tc.paged.pool_term[:-1])
    with pytest.raises(plr.TileError, match="does not divide into 2 tiles of 6 lanes"):
        plr.pallas_rounds(tc.state, tc.fab, tc._no_ops, tc.mute, v=V, tile_lanes=TILE,
                          n_rounds=1, paged=bad, paged_inkernel=True)


def test_paged_tile_is_one_cuda_block():
    """Under in-kernel paging the default tile is the engine's CUDA block,
    and a tile the kernel cannot run as one block raises, naming the
    limit."""
    shape = Shape(n_lanes=98_304, **SHAPE)
    assert plr.paged_tile(shape) == 96
    plr.check_paged_block(shape, 96)
    with pytest.raises(plr.TileError, match="MAX_CTA=256"):
        plr.check_paged_block(shape, 258)
    wide = Shape(n_lanes=8 * 240, max_peers=8, log_window=64, max_msg_entries=8,
                 max_inflight=8, max_read_index=8)
    with pytest.raises(plr.TileError, match="MAX_SMEM"):
        plr.check_paged_block(wide, 240)


# -- rebase, adopt_state and the blocked scheduler -------------------------------------------


def test_rebase_and_adopt_state_under_paging():
    """rebase_groups pages the window in, shifts it and pages it out again
    (faults bumped), adopt_state splits a host-built window: every leaf as
    in JAX, through two more dispatches."""
    jc = jfused.FusedCluster(G, V, seed=7, shape=_shapes()[0])
    tc = _port("xla", False, 0)
    for c in (jc, tc):
        for _ in range(6):
            c.run(STEP, **RUN)
        c.rebase_groups(range(G), delta=-1024)
    _assert_carry(_carry(jc), tc, "rebased")
    for c in (jc, tc):
        c.run(STEP, **RUN)
        c.adopt_state(c.host_state())
        c.run(STEP, **RUN)
    _assert_carry(_carry(jc), tc, "adopted")
    assert int(tc.host_state().last.max()) > 1024


def test_blocked_paged_run_matches_jax():
    """Two paged blocks in 3-round chunks: each block's raw carry as JAX's;
    the plan is checked before any block exists; the summed stats."""
    kw = dict(block_groups=G, seed=5, round_chunk=STEP)
    jb = JBlocked(2 * G, V, shape=_shapes()[0], **kw)
    tb = BlockedFusedCluster(2 * G, V, shape=_shapes()[1], device="cpu", paged=True, **kw)
    for b in (jb, tb):
        b.run(ROUNDS, **RUN)
        b.check_no_errors()
    for i, (x, y) in enumerate(zip(jb.blocks, tb.blocks)):
        _assert_carry(_carry(x), y, f"block {i}")
    stats = tb.paged_stats()
    assert stats["paged_pool_pages"] == 2 * (N * 3 + 8)
    assert stats["paged_pool_in_use"] == sum(b.paged_stats()["paged_pool_in_use"]
                                             for b in tb.blocks) > 0
    with pytest.raises(ValueError, match="too small"):
        BlockedFusedCluster(2 * G, V, shape=_shapes(pool=2)[1], device="cpu", paged=True, **kw)
