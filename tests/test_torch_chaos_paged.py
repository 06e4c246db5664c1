"""The port's chaos plane composed with the paged entry log, against the
JAX package, leaf for leaf.

The JAX side runs with RAFT_TPU_CHAOS=1 and RAFT_TPU_PAGED=1 (and
RAFT_TPU_PAGED_INKERNEL, RAFT_TPU_PALLAS_TILE, RAFT_TPU_DIET where a case
needs them, carry donation off, metrics on); the port builds its clusters
with chaos=True, paged=True. Integer state: every comparison is exact,
dtypes included, on every leaf of the state, the fabric, the metrics, the
ChaosState and the PagedLog (page table, pool and counters), and on
host_state. Covered: the eager engine paging at the dispatch boundary and
around every round; the pallas engine's plain version paging at the
boundary and in the kernel, at K = 1 and 4, over one and two allocation
segments, diet off and on, and with a pool that exhausts; rebase_groups
under both planes; a two-block BlockedFusedCluster; the ChaosRunner over
a paged cluster; and paging invisible to a chaos trajectory (the chaos
soak's scenario at 256 groups, 64 rounds: in-kernel paged, flat, and
JAX's flat run, one digest).

As in tests/test_torch_paged.py, the JAX references of the pallas modes
are composed from JAX's own functions in its kernel's order (one-round
fused_rounds dispatches with the chaos carry between page_in_host and
page_out_host), since JAX's interpret mode takes minutes at K > 1; so is
paging at the dispatch boundary (page_in_host, one-round dispatches,
page_out_host) and paging around every round (a one-round, one-segment
in-kernel launch a round), each leaf for leaf what JAX's eager cluster
computes in that mode: every mode then runs the one-round program of its
carry layout instead of compiling a dispatch of its own, and so does each
block of JAX's BlockedFusedCluster in the two-block case.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from raft_tpu.chaos import schedule as jsched
from raft_tpu.config import Shape as JShape
from raft_tpu.ops import fused as jfused
from raft_tpu.ops import paged as jpg
from raft_tpu.scheduler import BlockedFusedCluster as JBlocked
from raft_tpu_torch import interop
from raft_tpu_torch import state as tst
from raft_tpu_torch.chaos import device as tch
from raft_tpu_torch.chaos import schedule as tsched
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.scheduler import BlockedFusedCluster
from tests.test_torch_paged import KNOBS, _jax_inkernel_launch, _jax_round
from tests.test_torch_state import assert_same_leaves, jax_leaves, release_memory  # noqa: F401

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

V = 3
G = 4
N = G * V
SHAPE = dict(max_peers=V, log_window=16, max_msg_entries=2, max_inflight=2, max_read_index=2)
RUN = dict(auto_propose=True, auto_compact_lag=12)  # the logs outrun the 8-entry tail
STEP = 11  # rounds a dispatch: launches of 4, 4 and 3 rounds at K = 4
ROUNDS = 33
NEVER = tch.NEVER


def _env(mp, **on):
    """Pin every RAFT_TPU_* knob the JAX constructors read: those in `on`
    set, the others removed; chaos, paging and metrics on, donation off."""
    for k in KNOBS + ("CHAOS_SEED",):
        mp.delenv(f"RAFT_TPU_{k}", raising=False)
    for k, v in {**dict(chaos=1, paged=1, donate=0, metrics=1), **on}.items():
        mp.setenv(f"RAFT_TPU_{k.upper()}", str(v))


@pytest.fixture(scope="module", autouse=True)
def _jax_env():
    with pytest.MonkeyPatch.context() as mp:
        _env(mp)
        yield


def _shapes(pool: int = 0, n: int = N):
    return (JShape(n_lanes=n, pool_pages=pool, **SHAPE),
            Shape(n_lanes=n, pool_pages=pool, **SHAPE))


def _plan(n: int, r0: int) -> dict:
    """tests/test_torch_chaos.py's faults over n lanes from round r0:
    drops and duplicates of 0.2 on groups 0-1, tick skew 0.3, an
    asymmetric partition of group 2's member 0, lane 1 down for 4 rounds,
    an instant restart of group 3's member 0, the probe armed at r0 + 9."""
    edge = np.where((np.arange(n) < 2 * V)[:, None], tch.probability(0.2), 0)
    edge = np.repeat(edge, V, axis=1).astype(np.int32)
    send, recv = np.ones(n, np.int32), np.ones(n, np.int32)
    send[2 * V], recv[2 * V] = 3, 2
    crash, restart = np.full(n, NEVER, np.int32), np.full(n, NEVER, np.int32)
    crash[1], restart[1] = r0 + 2, r0 + 6
    crash[3 * V], restart[3 * V] = r0 + 4, r0 + 4
    return dict(drop_num=edge, dup_num=edge, tick_skew_num=np.full(n, tch.probability(0.3),
                np.int32), part_send=send, part_recv=recv, crash_at=crash, restart_at=restart,
                heal_round=r0 + 9, reelect_round=np.full(n, NEVER, np.int32),
                recommit_round=np.full(n, NEVER, np.int32))


def _launches(k: int) -> list[int]:
    """The launches of one STEP-round dispatch at K = k."""
    return [k] * (STEP // k) + ([STEP % k] if STEP % k else [])


def _drive(c, dispatch=None, until: int = ROUNDS):
    """Rounds up to `until` in STEP-round dispatches (c.run, or
    dispatch(c)), _plan from round 0 and a second one from round STEP."""
    n = c.g * c.v
    for r in range(0, until, STEP):
        if r < 2 * STEP:
            c.set_chaos(**_plan(n, r))
        if dispatch is None:
            c.run(STEP, **RUN)
        else:
            dispatch(c)


def _jax_boundary_dispatch(c):
    """One STEP-round dispatch of JAX's paging at the dispatch boundary,
    composed: page_in_host, one-round chaos dispatches, page_out_host."""
    st, pg = jpg.page_in_host(c.state, c.paged, 1)
    fb, met, ch = c.fab, c.metrics, c.chaos
    for _ in range(STEP):
        st, fb, met, ch = _jax_round(st, fb, c._no_ops, c.mute, metrics=met, chaos=ch)
    c.state, c.paged = jpg.page_out_host(st, pg, 1)
    c.fab, c.metrics, c.chaos = fb, met, ch


def _carry(c):
    return c.state, c.fab, c.metrics, c.chaos, c.paged


def _assert_carry(jc, tc, what: str):
    for part, w, t in zip(("state", "fabric", "metrics", "chaos", "paged"), _carry(jc),
                          _carry(tc), strict=True):
        assert_same_leaves(w, t, f"{what}: {part}")


def _jax_cluster(mode: str, diet: bool = False, segs: int = 1, pool: int = 0, g: int = G):
    """A JAX chaos + paged cluster of seed 7: paging at the dispatch
    boundary ("xla", "boundary"), around every round ("xla_inkernel"), or
    pinned to the pallas engine's in-kernel segmentation
    ("pallas_inkernel", segs tiles)."""
    on, kw = dict(diet=int(diet)), {}
    if mode == "xla_inkernel":
        on["paged_inkernel"] = 1
    if mode == "pallas_inkernel":
        on.update(paged_inkernel=1, pallas_tile=g * V // segs)
        kw = dict(engine="pallas")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, **on)
        c = jfused.FusedCluster(g, V, seed=7, shape=_shapes(pool, g * V)[0], **kw)
    assert c._paged_segs == (segs if mode == "pallas_inkernel" else 1)
    return c


def _jax_dispatch(mode: str, segs: int, k: int):
    """One STEP-round dispatch of the JAX reference of `mode`, composed
    from JAX's functions: each leaf for leaf what JAX's eager cluster.run
    computes in the eager modes ("xla", "boundary": paging at the dispatch
    boundary; "xla_inkernel": around every round, one segment's launch a
    round), so that every mode runs the one-round program of its carry
    layout instead of compiling a dispatch of its own."""
    if mode == "pallas_inkernel":
        return lambda c: [_jax_inkernel_launch(c, kc, segs) for kc in _launches(k)]
    if mode == "xla_inkernel":
        return lambda c: [_jax_inkernel_launch(c, 1, 1) for _ in range(STEP)]
    return _jax_boundary_dispatch


@functools.cache
def _twin(mode: str, diet: bool, segs: int, k: int, pool: int):
    """The JAX cluster through _drive in `mode` (K matters to the
    in-kernel reference only)."""
    c = _jax_cluster(mode, diet, segs, pool)
    _drive(c, _jax_dispatch(mode, segs, k))
    return c, jax_leaves(c.host_state())


def _port(mode: str, diet: bool = False, segs: int = 1, k: int = 1, pool: int = 0):
    kw = dict(paged=True, chaos=True, diet=diet)
    if mode.startswith("pallas"):
        kw.update(engine="pallas", rounds_per_call=k, tile_lanes=N // segs)
    if "inkernel" in mode:
        kw["paged_inkernel"] = True
    return tfused.FusedCluster(G, V, seed=7, shape=_shapes(pool)[1], device="cpu", **kw)


# (port mode, JAX twin, diet, allocation segments, K, pool pages): the
# pallas engine at the boundary pages once a dispatch as the eager engine
# does, so the two share a twin; 8 pages exhaust
CASES = [
    ("xla", "xla", False, 1, 1, 0),
    ("xla_inkernel", "xla_inkernel", False, 1, 1, 0),
    ("pallas", "xla", False, 1, 1, 0),
    ("pallas", "xla", False, 1, 4, 0),
    ("pallas", "boundary", True, 1, 4, 0),
    ("pallas_inkernel", "pallas_inkernel", False, 2, 1, 0),
    ("pallas_inkernel", "pallas_inkernel", False, 1, 4, 0),
    ("pallas_inkernel", "pallas_inkernel", True, 2, 4, 0),
    ("pallas_inkernel", "pallas_inkernel", True, 1, 1, 0),
    ("pallas_inkernel", "pallas_inkernel", False, 2, 1, 8),
]


@pytest.mark.parametrize("mode,twin,diet,segs,k,pool", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_engine_matches_jax(mode, twin, diet, segs, k, pool):
    """ROUNDS faulted rounds in STEP-round dispatches: the raw carry
    (state, fabric, metrics, ChaosState, PagedLog) and host_state as
    JAX's in the same paging mode, segmentation and launches; the faults
    took effect, the pool was used, and the 8-page pool exhausted."""
    jc, host = _twin(twin, diet, segs, k if twin == "pallas_inkernel" else 1, pool)
    tc = _port(mode, diet, segs, k, pool)
    assert tc._paged_segs == (segs if mode == "pallas_inkernel" else 1)
    _drive(tc)
    _assert_carry(jc, tc, f"{mode} diet={diet} segs={segs} K={k} pool={pool}")
    assert_same_leaves(host, tc.host_state(), "host_state")
    cols = tc.chaos_columns()
    assert cols["round"] == ROUNDS and (cols["reelect_round"] != NEVER).any()
    stats = tc.paged_stats()
    assert stats["paged_pool_in_use"] > 0
    assert (stats["paged_exhausted"] > 0) == (pool > 0)
    assert tst.is_packed(tc.state) == diet


def test_rebase_groups_under_both_planes():
    """rebase_groups on a chaos cluster paging in the kernel over two
    segments: the window paged in at the segments, shifted with the
    recovery baseline, and paged out again; every leaf as JAX's, then
    through one more dispatch."""
    jc = _jax_cluster("pallas_inkernel", segs=2)
    tc = _port("pallas_inkernel", segs=2)
    _drive(jc, _jax_dispatch("pallas_inkernel", 2, 1), until=2 * STEP)
    _drive(tc, until=2 * STEP)
    base = tc.chaos_columns()["base_committed"]
    for c in (jc, tc):
        c.rebase_groups(range(G), delta=-1024)
    _assert_carry(jc, tc, "rebased")
    assert np.array_equal(tc.chaos_columns()["base_committed"], base + 1024)
    _jax_dispatch("pallas_inkernel", 2, 1)(jc)
    tc.run(STEP, **RUN)
    _assert_carry(jc, tc, "after the rebase")
    assert int(tc.host_state().last.max()) > 1024


def test_blocked_cluster_matches_jax():
    """Two chaos + paged blocks in STEP-round chunks, the faults set in
    global lane order: each block's carry as JAX's, the recounts summed.
    JAX's BlockedFusedCluster seeds the blocks and slices the faults; each
    block's chunk is the composed boundary dispatch (its run, leaf for
    leaf, through the one-round program the other references compile)."""
    kw = dict(block_groups=G, seed=5, round_chunk=STEP)
    jb = JBlocked(2 * G, V, shape=_shapes()[0], **kw)
    tb = BlockedFusedCluster(2 * G, V, shape=_shapes()[1], device="cpu", chaos=True,
                             paged=True, **kw)
    _drive(jb, lambda b: [_jax_boundary_dispatch(x) for x in b.blocks])
    _drive(tb)
    for i, (x, y) in enumerate(zip(jb.blocks, tb.blocks, strict=True)):
        _assert_carry(x, y, f"block {i}")
    assert tb.chaos_columns()["n_reelected"] == sum(
        int(b.chaos.n_reelected) for b in jb.blocks) > 0
    assert tb.paged_stats()["paged_pool_in_use"] > 0


def _drive_scenario(c, sched, rounds: int, step: int | None = None):
    """The ChaosRunner's loop (chaos/schedule.py ChaosRunner.run) up to
    `rounds`: each segment's columns and probe arming set, then its rounds
    in one dispatch (or in dispatches of `step`)."""
    v = sched.v
    for a, b in sched.segments(2 * chip_smoke.CHAOS_BUDGET):
        if a >= rounds:
            break
        sched.resolve_kills(a, c.leader_lanes)
        cols = sched.columns(a)
        heal = np.asarray(sched.heal_groups_at(a), np.int64)
        if heal.size:
            cur = c.chaos_columns("reelect_round", "recommit_round")
            re = np.array(cur["reelect_round"], np.int32)
            co = np.array(cur["recommit_round"], np.int32)
            lanes = (heal[:, None] * v + np.arange(v)).reshape(-1)
            re[lanes] = co[lanes] = NEVER
            cols.update(heal_round=a, reelect_round=re, recommit_round=co)
        c.set_chaos(**cols)
        n = min(b, rounds) - a
        for _ in range(n // (step or n)):
            c.run(step or n, auto_propose=True, auto_compact_lag=8)


def test_paging_is_invisible_to_a_chaos_trajectory():
    """chip_smoke.scenario (the chaos soak's mixed scenario) at 256 groups
    for 64 rounds under the bench Shape with page_window=8, page_entries=4:
    the port with chaos and in-kernel paging (pallas, K = 8, the default
    tile), the port without paging (eager) and JAX without paging end on
    one host_state + chaos digest."""
    g, rounds = 256, 64
    n = g * V
    shape = dict(n_lanes=n, max_peers=V, log_window=16, max_msg_entries=2, max_inflight=2,
                 max_read_index=2, page_window=8, page_entries=4)
    digests = {}
    for name, kw in (("paged", dict(paged=True, paged_inkernel=True, engine="pallas",
                                    rounds_per_call=8)), ("flat", {})):
        c = tfused.FusedCluster(g, V, seed=42, shape=Shape(**shape), device="cpu", chaos=True,
                                **kw)
        _drive_scenario(c, chip_smoke.scenario(g, V), rounds)
        digests[name] = interop.digest(interop.to_numpy_leaves(c.host_state())
                                       + interop.to_numpy_leaves(c.chaos))
        if name == "paged":
            assert c.paged_stats()["paged_pool_in_use"] > 0 and c._paged_segs == 1
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, paged=0)
        jc = jfused.FusedCluster(g, V, seed=42, shape=JShape(**shape))
        _drive_scenario(jc, chip_smoke.scenario(g, V, jsched.ChaosSchedule), rounds, step=1)
        digests["jax"] = interop.digest(jax_leaves(jc.host_state()) + jax_leaves(jc.chaos))
    assert digests["paged"] == digests["flat"] == digests["jax"], digests


def test_chaos_runner_over_a_paged_cluster():
    """The port's ChaosRunner over a chaos cluster paging in the kernel
    (two segments) and over one without paging, on one schedule: one probe
    snapshot and one host_state + chaos digest."""
    out = []
    for kw in (dict(paged=True, paged_inkernel=True, engine="pallas", tile_lanes=2 * V,
                    rounds_per_call=3), {}):
        c = tfused.FusedCluster(G, V, seed=13, shape=_shapes()[1], device="cpu", chaos=True,
                                **kw)
        sched = (tsched.ChaosSchedule(G, V)
                 .skew(groups=[0, 1], at=3, duration=6, prob=0.3)
                 .duplicate(groups=[1, 2], at=9, duration=6, prob=0.25)
                 .partition(groups=[1, 3], at=15, duration=3)
                 .kill_leaders(groups=[0, 2], at=15, down=3))
        snap = tsched.ChaosRunner(c, sched, tick_budget=18, settle=6, **RUN).run()
        out.append((snap, interop.digest(interop.to_numpy_leaves(c.host_state())
                                         + interop.to_numpy_leaves(c.chaos))))
    assert out[0] == out[1]
    assert out[0][0]["counters"]["chaos_groups_probed"] >= 2
