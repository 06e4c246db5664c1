"""The port's leader-lease plane against the JAX package, leaf for leaf.

The JAX side runs with RAFT_TPU_LEASE=1 and RAFT_TPU_CHAOS=1 (carry
donation off, metrics on, its default margin 1) set for this module; the
port builds its clusters with lease=True, chaos=True. Integer state: every
comparison is exact, dtypes included. Covered: lease_round on seeded
columns at margins 0, 1 and 3, with and without skipped ticks, holders,
transferees, confchanges in flight, epochs at 32,767 and counters at the
int32 edge (eager jnp, no program); the margin's clamp; the lease columns
through pack_state / unpack_state (counters over 65,535 stay int32),
wipe_volatile, init_state and interop; the plane's elision without lease;
a 4 x 3 cluster with check_quorum under a lease skew storm, a leadership
transfer and a leader kill through 42 rounds on the eager engine and the
pallas engine's plain version at K = 1 and 4, slim and diet (every state,
fabric, metrics and ChaosState leaf, lease_stats and the snapshot's lease
counters, with grants, renewals and skew revocations in the window);
in-kernel paging under the same run (its host view and lease totals equal
the unpaged JAX run's); and a two-block BlockedFusedCluster against two
flat clusters of the same seeds.

The JAX clusters dispatch 3 rounds at a time: two fused-round programs
for the file (slim and diet), no interpret-mode kernel.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import state as jst
from raft_tpu.config import Shape as JShape
from raft_tpu.ops import fused as jfused
from raft_tpu.ops import lease as jls
from raft_tpu_torch import interop
from raft_tpu_torch import state as tst
from raft_tpu_torch.chaos import schedule as tsched
from raft_tpu_torch.config import Shape
from raft_tpu_torch.metrics import host as thost
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import lease as tls
from raft_tpu_torch.scheduler import BlockedFusedCluster
from tests.test_torch_state import assert_same_leaves, jax_leaves, release_memory  # noqa: F401

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

V, G = 3, 4
N = G * V
STEP = 3  # rounds per JAX dispatch: one compiled program per configuration
ROUNDS = 42
RUN = dict(auto_propose=True, auto_compact_lag=4)
CFG = dict(check_quorum=True, election_tick=5)
SHAPE = dict(max_peers=V, log_window=8, max_msg_entries=2, max_inflight=2, max_read_index=2)
PAGED = dict(page_window=4, page_entries=2, pool_pages=40)
# the dispatch boundaries: knob columns written, ops given, carries read
CUTS = (0, 12, 15, 21, 24, 27, 30, 33, 36, 39, ROUNDS)
ENV_OFF = ("ENGINE", "PALLAS_ROUNDS", "PALLAS_TILE", "TRACELOG", "PAGED", "TIER", "CHAOS_SEED",
           "LEASE_MARGIN", "DIET")


@pytest.fixture(scope="module", autouse=True)
def _jax_lease_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_LEASE", "1")
        mp.setenv("RAFT_TPU_CHAOS", "1")
        mp.setenv("RAFT_TPU_DONATE", "0")
        mp.setenv("RAFT_TPU_METRICS", "1")
        for k in ENV_OFF:
            mp.delenv(f"RAFT_TPU_{k}", raising=False)
        yield mp


# -- lease_round on columns ------------------------------------------------------------


def _columns(seed: int, n: int = 96, v: int = 3, skipped: bool = True) -> dict:
    """Seeded numpy columns: about half the lanes hold a lease, some with
    skew near the margins; transferees, confchanges (a joint config or an
    unapplied conf entry), epochs at 32,767 and counters at the int32 edge
    on some lanes; election ticks down to 1 (the window's clamp)."""
    rng = np.random.default_rng(seed)

    def some(p):
        return rng.random(n) < p

    i32 = np.int32
    counters = rng.integers(0, 70_000, (4, n)).astype(i32)
    counters[:, :3] = [2**31 - 1, 65_535, 0]
    epoch = rng.integers(0, tls.EPOCH_WRAP, n).astype(i32)
    epoch[::5] = tls.EPOCH_WRAP - 1
    applied = rng.integers(0, 20, n).astype(i32)
    cols = dict(
        lease_left=np.where(some(0.5), rng.integers(1, 9, n), 0).astype(i32),
        lease_epoch=epoch,
        lease_skew=rng.integers(0, 5, n).astype(i32),
        lease_grants=counters[0], lease_renewals=counters[1],
        lease_revocations=counters[2], lease_skew_revocations=counters[3],
        applied=applied,
        pending_conf_index=(applied + np.where(some(0.15), 1, -rng.integers(0, 3, n))).astype(i32),
        voters_out=(rng.random((n, v)) < 0.05),
        lead_transferee=np.where(some(0.15), rng.integers(1, v + 1, n), 0).astype(i32),
        election_tick=rng.integers(1, 12, n).astype(i32),
        check_quorum=some(0.85),
        is_leader=some(0.6),
        ack_quorum=some(0.7),
        skipped_tick=some(0.4) & skipped,
    )
    # lane 5 (epoch 32,767) is granted a lease this round: its epoch wraps
    for k, x in dict(lease_left=0, pending_conf_index=applied[5], lead_transferee=0,
                     election_tick=5, check_quorum=True, is_leader=True, ack_quorum=True).items():
        cols[k][5] = x
    cols["voters_out"][5] = False
    return cols


def _state_ns(cols: dict, arr):
    cfg = types.SimpleNamespace(election_tick=arr(cols["election_tick"]),
                                check_quorum=arr(cols["check_quorum"]))
    skip = ("election_tick", "check_quorum", "is_leader", "ack_quorum", "skipped_tick")
    return types.SimpleNamespace(cfg=cfg, **{k: arr(x) for k, x in cols.items() if k not in skip})


@pytest.mark.parametrize("skipped", [False, True], ids=["ticking", "skipped"])
@pytest.mark.parametrize("margin", [0, 1, 3])
def test_lease_round_matches_jax(margin, skipped):
    """ops/lease.py lease_round against JAX's (eager jnp) on seeded columns:
    the seven successor columns, dtype and value."""
    cols = _columns(100 * margin + skipped, skipped=skipped)
    flags = {k: cols[k] for k in ("is_leader", "ack_quorum", "skipped_tick")}
    want = jls.lease_round(_state_ns(cols, jnp.asarray),
                           **{k: jnp.asarray(x) for k, x in flags.items()}, margin=margin)
    got = tls.lease_round(_state_ns(cols, torch.from_numpy),
                          **{k: torch.from_numpy(x) for k, x in flags.items()}, margin=margin)
    assert tuple(got) == tls.LEASE_STATE_FIELDS == jls.LEASE_STATE_FIELDS
    for k in tls.LEASE_STATE_FIELDS:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (margin, skipped, k)
    # every event fired somewhere, and the wraps showed
    for k in tls.LEASE_COUNTER_FIELDS:
        fired = got[k].numpy() != cols[k]
        assert fired.any() or (k == "lease_skew_revocations" and not skipped), k
    assert cols["lease_epoch"][5] == tls.EPOCH_WRAP - 1 and got["lease_epoch"][5] == 0
    assert got["lease_left"].numpy().max() <= max(cols["election_tick"].max() - 1, 8)


def test_margin_clamps_as_jax(_jax_lease_env):
    """The constructor's lease_margin clamps at 0 as JAX's
    RAFT_TPU_LEASE_MARGIN does, and FusedCluster keeps it."""
    for m in (-3, 0, 1, 7):
        _jax_lease_env.setenv("RAFT_TPU_LEASE_MARGIN", str(m))
        try:
            assert tls.clamp_margin(m) == jls.lease_margin(), m
        finally:
            _jax_lease_env.delenv("RAFT_TPU_LEASE_MARGIN")
    assert tls.DEFAULT_MARGIN == jls.lease_margin() == 1
    c = tfused.FusedCluster(2, 3, device="cpu", lease=True, lease_margin=-2)
    assert c.lease_margin == 0


# -- the columns in the state layer ----------------------------------------------------


def _lease_states(seed: int = 5):
    """A JAX state with the lease columns (RAFT_TPU_LEASE=1) and its port
    twin, the lease columns seeded (counters over 65,535, an epoch at
    32,767) and the volatile columns random."""
    n = 18
    shape = JShape(n_lanes=n, max_peers=V, log_window=8, max_msg_entries=2, max_inflight=2,
                   max_read_index=2)
    ids = np.tile(np.arange(1, V + 1, dtype=np.int32), n // V)
    peers = np.broadcast_to(np.arange(1, V + 1, dtype=np.int32), (n, V))
    js = jst.init_state(shape, ids, peers, seed=9)
    assert js.lease_left is not None
    rng = np.random.default_rng(seed)
    upd = {}
    for f in dataclasses.fields(js):
        x = getattr(js, f.name)
        if f.name in ("cfg", "id", "prs_id") or x is None:
            continue
        a = np.asarray(x)
        upd[f.name] = (rng.integers(0, 2, a.shape).astype(bool) if a.dtype == bool
                       else rng.integers(0, 2**31 if a.dtype == np.uint32 else 50, a.shape
                                         ).astype(a.dtype))
    upd["lease_epoch"][0] = tls.EPOCH_WRAP - 1
    for k in tls.LEASE_COUNTER_FIELDS:
        upd[k] = rng.integers(65_536, 2**31 - 1, n).astype(np.int32)
    js = dataclasses.replace(js, **{k: jnp.asarray(x) for k, x in upd.items()})
    return js, interop.from_numpy_tree(tst.RaftState, jax_leaves(js), "cpu")


def test_init_state_and_interop_carry_the_lease_columns():
    """init_state(lease=True) is JAX's under RAFT_TPU_LEASE=1, seven zero
    int32 columns after cfg, each its own buffer; interop carries them
    both ways and into the digest."""
    n = 12
    ids = np.tile(np.arange(1, V + 1, dtype=np.int32), n // V)
    peers = np.broadcast_to(np.arange(1, V + 1, dtype=np.int32), (n, V))
    js = jst.init_state(JShape(n_lanes=n, max_peers=V), ids, peers, seed=3)
    ts = tst.init_state(Shape(n_lanes=n, max_peers=V), ids, peers, seed=3, device="cpu",
                        lease=True)
    assert_same_leaves(js, ts, "init_state(lease)")
    ptrs = {getattr(ts, f).data_ptr() for f in tls.LEASE_STATE_FIELDS}
    assert len(ptrs) == 7
    js2, ts2 = _lease_states()
    back = interop.from_numpy_tree(tst.RaftState, interop.to_numpy_leaves(ts2), "cpu")
    assert_same_leaves(js2, back, "interop")
    assert interop.digest(interop.to_numpy_leaves(back)) == interop.digest(jax_leaves(js2))


def test_pack_unpack_round_trip_keeps_counters_int32():
    """pack_state narrows lease_left/epoch/skew to uint16 and keeps the
    counters int32 (values over 65,535 intact), as JAX's; unpack_state
    widens them back; a countdown over 65,535 clamps with
    ERR_DIET_OVERFLOW on its lane in both packages."""
    js, ts = _lease_states()
    jp, tp = jst.pack_state(js), tst.pack_state(ts)
    assert_same_leaves(jp, tp, "pack_state")
    for f in tls.LEASE_PACK_U16:
        assert getattr(tp, f).dtype == torch.uint16, f
    for f in tls.LEASE_COUNTER_FIELDS:
        assert getattr(tp, f).dtype == torch.int32 and int(getattr(tp, f).min()) > 65_535, f
    assert_same_leaves(jst.unpack_state(jp), tst.unpack_state(tp), "unpack_state")
    for f in tls.LEASE_STATE_FIELDS:
        assert torch.equal(getattr(tst.unpack_state(tp), f), getattr(ts, f).to(torch.int32)), f
    big = np.asarray(js.lease_left).copy()
    big[4] = 70_000
    js3 = dataclasses.replace(js, lease_left=jnp.asarray(big), error_bits=js.error_bits * 0)
    ts3 = interop.from_numpy_tree(tst.RaftState, jax_leaves(js3), "cpu")
    jp3, tp3 = jst.pack_state(js3), tst.pack_state(ts3)
    assert_same_leaves(jp3, tp3, "pack_state overflow")
    assert int(tp3.lease_left[4]) == 65_535
    assert int(tp3.error_bits[4]) & tst.ERR_DIET_OVERFLOW


def test_wipe_volatile_matches_jax():
    """wipe_volatile with the lease columns on a random mask: lease_left and
    lease_skew zeroed, the epoch and the counters kept, every leaf as
    JAX's."""
    js, ts = _lease_states(7)
    mask = np.random.default_rng(2).integers(0, 2, 18).astype(bool)
    assert 0 < mask.sum() < 18
    want = jst.wipe_volatile(js, jnp.asarray(mask))
    got = tst.wipe_volatile(ts, torch.from_numpy(mask))
    assert_same_leaves(want, got, "wipe_volatile(lease)")
    assert not got.lease_left.numpy()[mask].any() and not got.lease_skew.numpy()[mask].any()
    assert torch.equal(got.lease_epoch, ts.lease_epoch)


def test_lease_plane_elides_without_lease():
    """Off (the default), the state has no lease leaf and the cluster no
    lease_stats; on, exactly seven leaves more, and no other leaf moves."""
    off = tfused.FusedCluster(2, 3, seed=4, device="cpu")
    on = tfused.FusedCluster(2, 3, seed=4, device="cpu", lease=True)
    assert off.state.lease_left is None and off.lease_stats() is None
    lo, ln = interop.to_numpy_leaves(off.state), interop.to_numpy_leaves(on.state)
    assert len(ln) == len(lo) + 7
    assert interop.digest(ln[: len(lo)]) == interop.digest(lo)
    assert "lease_grants" not in off.metrics_snapshot()["counters"]
    assert on.lease_stats() == dict.fromkeys(tls.LEASE_COUNTER_FIELDS, 0)


# -- the cluster under a skew storm ----------------------------------------------------


def _schedule():
    """Two skew waves on every member (15-21, 24-30), a kill of group 2's
    leader at 24 for 3 rounds; ChaosSchedule.lease_skew_storm's geometry."""
    return (tsched.ChaosSchedule(G, V)
            .lease_skew_storm(groups=range(G), at=15, bursts=2, duration=6, gap=3)
            .kill_leaders(groups=[2], at=24, down=3))


def _leaders(c) -> np.ndarray:
    st = np.asarray(c.state.state) if isinstance(c, jfused.FusedCluster) else \
        c.state.state.cpu().numpy()
    return np.nonzero(st == 2)[0]


def _carry(c):
    blocks = c.blocks if isinstance(c, BlockedFusedCluster) else [c]
    out = []
    for b in blocks:
        for part in (b.state, b.fab, b.metrics, b.chaos):
            out.append(jax_leaves(part) if isinstance(b, jfused.FusedCluster)
                       else interop.to_numpy_leaves(part))
    return out


def _drive(c, step=None):
    """ROUNDS rounds in dispatches between CUTS (of `step` rounds each
    where given): the schedule's columns at every cut, a transfer away from
    group 0's leader at 12. Returns {21: carry, 42: carry}."""
    sched = _schedule()
    out = {}
    for a, b in zip(CUTS, CUTS[1:]):
        if a == 21:
            out[21] = _carry(c)
        sched.resolve_kills(a, lambda: _leaders(c))
        c.set_chaos(**sched.columns(a))
        ops = None
        if a == 12:
            lead = [x for x in _leaders(c) if x < V]
            ops = c.ops(transfer_to={int(x): int((x + 1) % V + 1) for x in lead})
        for r in range(a, b, step or b - a):
            c.run(step or b - a, ops=ops if r == a else None, **RUN)
    out[ROUNDS] = _carry(c)
    return out


def _assert_carry(want, got, what):
    assert len(want) == len(got), what
    for j, (a, b) in enumerate(zip(want, got)):
        part = ("state", "fabric", "metrics", "chaos")[j % 4]
        assert len(a) == len(b), (what, part, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, part, i)


def _lease_counters(c) -> dict:
    snap = c.metrics_snapshot()["counters"]
    return {k: snap[k] for k in tls.LEASE_COUNTER_FIELDS}


@pytest.fixture(scope="module", params=["slim", "diet"])
def jax_run(request, _jax_lease_env):
    """The JAX lease + chaos cluster through _drive (RAFT_TPU_DIET=1 for
    diet): its carries at 21 and 42, host view, lease_stats and snapshot."""
    diet = request.param == "diet"
    if diet:
        _jax_lease_env.setenv("RAFT_TPU_DIET", "1")
    try:
        jc = jfused.FusedCluster(G, V, seed=7, shape=JShape(n_lanes=N, **SHAPE), **CFG)
    finally:
        _jax_lease_env.delenv("RAFT_TPU_DIET", raising=False)
    assert jc.state.lease_left is not None and jc.chaos is not None
    snaps = _drive(jc, STEP)
    jc.check_no_errors()
    snaps["host"] = jax_leaves(jc.host_state())
    snaps["stats"] = jc.lease_stats()
    snaps["snap"] = _lease_counters(jc)
    return request.param, snaps


def _port(cfg: str, **kw):
    shape = Shape(n_lanes=N, **SHAPE, **(PAGED if kw.get("paged") else {}))
    return tfused.FusedCluster(G, V, seed=7, shape=shape, device="cpu", diet=cfg == "diet",
                               chaos=True, lease=True, **CFG, **kw)


@pytest.mark.parametrize("engine,k", [("xla", None), ("pallas", 1), ("pallas", 4)],
                         ids=["eager", "pallas-k1", "pallas-k4"])
def test_cluster_matches_jax(jax_run, engine, k):
    """FusedCluster(lease=True, chaos=True, check_quorum=True) through the
    skew storm, the transfer and the leader kill: every leaf (lease and
    ChaosState included) after 21 and 42 rounds as JAX's, lease_stats and
    the snapshot's lease counters too, with grants, renewals and skew
    revocations counted inside the window."""
    cfg, snaps = jax_run
    kw = {} if engine == "xla" else dict(engine="pallas", rounds_per_call=k, tile_lanes=2 * V)
    tc = _port(cfg, **kw)
    got = _drive(tc)
    what = f"{cfg} {engine} K={k}"
    _assert_carry(snaps[21], got[21], what + " @21")
    _assert_carry(snaps[ROUNDS], got[ROUNDS], what + f" @{ROUNDS}")
    stats = tc.lease_stats()
    assert stats == snaps["stats"] == _lease_counters(tc) == snaps["snap"], what
    assert {k: thost.LEASE_EVENTS[k] for k in tls.LEASE_COUNTER_FIELDS} == stats
    at21 = dict(zip(tls.LEASE_STATE_FIELDS, got[21][0][-7:]))
    for k in ("lease_grants", "lease_renewals", "lease_skew_revocations"):
        assert stats[k] > 0, (what, k, stats)
    # the storm's skew revocations land inside the compared window
    assert stats["lease_skew_revocations"] > int(at21["lease_skew_revocations"].sum()) >= 0
    assert stats["lease_grants"] > int(at21["lease_grants"].sum()) > 0


def test_inkernel_paging_is_invisible_to_the_lease_plane(jax_run):
    """The pallas engine's in-kernel paging (two tiles, K = 4) through the
    same run: the host view, the ChaosState and lease_stats equal the
    unpaged JAX run's."""
    cfg, snaps = jax_run
    tc = _port(cfg, engine="pallas", rounds_per_call=4, tile_lanes=2 * V, paged=True,
               paged_inkernel=True)
    got = _drive(tc)
    assert interop.digest(interop.to_numpy_leaves(tc.host_state())) == interop.digest(snaps["host"])
    assert interop.digest(got[ROUNDS][3]) == interop.digest(snaps[ROUNDS][3])
    assert tc.lease_stats() == snaps["stats"]


def test_two_block_scheduler_equals_flat_clusters():
    """A two-block BlockedFusedCluster(lease=True) against two flat
    clusters of the blocks' seeds, the storm's columns set in global lane
    order: every block's leaves equal its flat twin's, lease_stats and the
    merged snapshot's lease counters are the sums."""
    g = 2 * G
    shape = Shape(n_lanes=G * V, **SHAPE)
    kw = dict(device="cpu", chaos=True, lease=True, **CFG)
    bc = BlockedFusedCluster(g, V, block_groups=G, seed=7, shape=shape, round_chunk=3, **kw)
    flat = [tfused.FusedCluster(G, V, seed=7 + 7919 * i, shape=shape, **kw) for i in range(2)]
    sched = tsched.ChaosSchedule(g, V).lease_skew_storm(groups=range(g), at=9, bursts=2,
                                                        duration=4, gap=2)
    for a, b in zip((0, 9, 13, 15, 19, 24), (9, 13, 15, 19, 24, 30)):
        cols = sched.columns(a)
        bc.set_chaos(**cols)
        bc.run(b - a, **RUN)
        for i, f in enumerate(flat):
            f.set_chaos(**{k: x[i * N:(i + 1) * N] for k, x in cols.items()})
            f.run(b - a, **RUN)
    for blk, f in zip(bc.blocks, flat):
        _assert_carry(_carry(f), _carry(blk), "blocked")
    stats = bc.lease_stats()
    want = {k: sum(f.lease_stats()[k] for f in flat) for k in tls.LEASE_COUNTER_FIELDS}
    assert stats == want and stats["lease_grants"] > 0 and stats["lease_skew_revocations"] > 0
    snap = bc.metrics_snapshot()["counters"]
    assert {k: snap[k] for k in tls.LEASE_COUNTER_FIELDS} == want


def test_diet_rebase_leaves_the_lease_columns():
    """A fast-forward by 48 Ki (rebase_groups on the packed carry) and the
    automatic diet-v2 rebase it then triggers shift the index columns and
    leave the lease columns as they were (the countdown needs no rebase):
    the diet cluster walks the lease columns of a slim twin that never
    rebased."""
    diet, slim = _port("diet"), _port("slim")
    for c in (diet, slim):
        c.run(21, **RUN)
    before = {f: getattr(diet.state, f).clone() for f in tls.LEASE_STATE_FIELDS}
    assert int(before["lease_left"].to(torch.int32).max()) > 0
    diet.rebase_groups(range(G), delta=-(48 * 1024))
    for f, x in before.items():
        y = getattr(diet.state, f)
        assert y.dtype == x.dtype and torch.equal(y, x), f
    for c in (diet, slim):
        c.run(9, **RUN)
    got, want = diet.host_state(), slim.host_state()
    assert 0 < int(got.last.max()) < tfused.FusedCluster.DIET_REBASE_AT  # rebased back down
    for f in tls.LEASE_STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert diet.lease_stats() == slim.lease_stats()
