"""The port's chaos plane against the JAX package, leaf for leaf.

The JAX side runs with RAFT_TPU_CHAOS=1 (carry donation off, metrics on)
set for this module; the port builds its clusters with chaos=True. Integer
state: every comparison is exact, dtypes included, on every leaf of the
state, the fabric, the metrics and the ChaosState. Covered: the
counter-based hash and its int64 arithmetic on 10^5 sites with seeds near
2^32; state.wipe_volatile on a random mask; quiet chaos equal to chaos
off; same-seed runs with faults bit-identical, and equal to JAX's by
trajectory_digest; a crash freezing its lane and keeping its HardState;
ChaosSchedule.columns / segments for every event kind against JAX's at
G = 64; the blocked scheduler's global-lane columns; the eager engine,
the pallas engine's plain version (K = 1 and 4) and a one-block
BlockedFusedCluster through 33 faulted rounds at V = 3 (slim) and V = 5
(diet, then through a fast-forward and the automatic rebase); JAX's
pallas_rounds in interpret mode (2 tiles, K = 2) against the port's; a
ChaosRunner schedule through both packages' runners; and chaos with
paging refused by name.

Every JAX cluster run dispatches 3 rounds at a time, so each cluster
configuration compiles one program, shared by every test of the module.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_tpu import state as jst
from raft_tpu.chaos import device as jch
from raft_tpu.chaos import schedule as jsched
from raft_tpu.config import Shape as JShape
from raft_tpu.ops import fused as jfused
from raft_tpu.ops import pallas_round as jplr
from raft_tpu_torch import interop
from raft_tpu_torch import state as tst
from raft_tpu_torch.chaos import device as tch
from raft_tpu_torch.chaos import schedule as tsched
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import pallas_round as tplr
from raft_tpu_torch.scheduler import BlockedFusedCluster
from tests.test_torch_state import assert_same_leaves, jax_leaves

G = 4
STEP = 3  # rounds per JAX dispatch: one compiled program per configuration
RUN = dict(auto_propose=True, auto_compact_lag=4)
NEVER = tch.NEVER
ENV_OFF = ("ENGINE", "PALLAS_ROUNDS", "PALLAS_TILE", "TRACELOG", "PAGED", "LEASE", "TIER",
           "CHAOS_SEED")
# (V, diet) of the engine runs
CFGS = {"v3-slim": (3, False), "v5-diet": (5, True)}


@pytest.fixture(scope="module", autouse=True)
def _jax_chaos_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_CHAOS", "1")
        mp.setenv("RAFT_TPU_DONATE", "0")
        mp.setenv("RAFT_TPU_METRICS", "1")
        mp.delenv("RAFT_TPU_DIET", raising=False)
        for k in ENV_OFF:
            mp.delenv(f"RAFT_TPU_{k}", raising=False)
        yield mp


def _shape(v: int) -> dict:
    return dict(n_lanes=G * v, max_peers=v, log_window=8, max_msg_entries=2, max_inflight=2,
                max_read_index=2)


def _plan(v: int, r0: int) -> dict:
    """Faults from round r0: drops and duplicates of 0.2 on groups 0-1,
    tick skew 0.3 everywhere, an asymmetric partition of group 2's member
    0, lane 1 down for 4 rounds, an instant restart of group 3's member 0,
    and the recovery probe armed at r0 + 9."""
    n = G * v
    edge = np.where((np.arange(n) < 2 * v)[:, None], tch.probability(0.2), 0)
    edge = np.repeat(edge, v, axis=1).astype(np.int32)
    send, recv = np.ones(n, np.int32), np.ones(n, np.int32)
    send[2 * v], recv[2 * v] = 3, 2
    crash, restart = np.full(n, NEVER, np.int32), np.full(n, NEVER, np.int32)
    crash[1], restart[1] = r0 + 2, r0 + 6
    crash[3 * v], restart[3 * v] = r0 + 4, r0 + 4
    return dict(drop_num=edge, dup_num=edge, tick_skew_num=np.full(n, tch.probability(0.3),
                np.int32), part_send=send, part_recv=recv, crash_at=crash, restart_at=restart,
                heal_round=r0 + 9, reelect_round=np.full(n, NEVER, np.int32),
                recommit_round=np.full(n, NEVER, np.int32))


def _drive(c, after=None):
    """33 faulted rounds in dispatches of STEP: the first plan at round 0,
    a second from round 15. Returns {15: carry, 33: carry}; `after`
    (round -> callable) runs before that round's dispatch."""
    out = {}
    c.set_chaos(**_plan(c.v, 0))
    for r in range(0, 33, STEP):
        if r == 15:
            out[15] = _carry(c)
            c.set_chaos(**_plan(c.v, 15))
        if after and r in after:
            after[r](c)
        c.run(STEP, **RUN)
    out[33] = _carry(c)
    return out


def _carry(c):
    if isinstance(c, (jfused.FusedCluster, tfused.FusedCluster)):
        blocks = [c]
    else:
        blocks = c.blocks
    leaves = []
    for b in blocks:
        for part in (b.state, b.fab, b.metrics, b.chaos):
            if isinstance(b, jfused.FusedCluster):
                leaves.append(jax_leaves(part))
            else:
                leaves.append(interop.to_numpy_leaves(part))
    return leaves


def _assert_carry(want, got, what):
    assert len(want) == len(got), what
    for j, (a, b) in enumerate(zip(want, got)):
        part = ("state", "fabric", "metrics", "chaos")[j % 4]
        assert len(a) == len(b), (what, part)
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, part, i)


@pytest.fixture(scope="module", params=list(CFGS))
def jax_run(request):
    """The JAX chaos cluster of a configuration through _drive; the diet
    one then, the faults lifted, fast-forwarded by 48 Ki and run 15 rounds
    on, through the automatic rebase."""
    v, diet = CFGS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        if diet:
            mp.setenv("RAFT_TPU_DIET", "1")
        jc = jfused.FusedCluster(G, v, seed=7, shape=JShape(**_shape(v)))
        snaps = _drive(jc)
        if diet:
            _rebase_run(jc)
            snaps["rebased"] = _carry(jc)
            snaps["host"] = jax_leaves(jc.host_state())
        jc.check_no_errors()
    return request.param, snaps


def _rebase_run(c):
    """The faults lifted, a fast-forward by 48 Ki, then 15 rounds."""
    c.set_chaos(drop_num=0, dup_num=0, tick_skew_num=0, part_send=1, part_recv=1)
    c.rebase_groups(range(G), delta=-(48 * 1024))
    for _ in range(5):
        c.run(STEP, **RUN)


def _port(cfg: str, **kw):
    v, diet = CFGS[cfg]
    return tfused.FusedCluster(G, v, seed=7, shape=Shape(**_shape(v)), device="cpu", diet=diet,
                               chaos=True, **kw)


# -- the counter-based hash ------------------------------------------------------


def test_mul32_is_exact():
    """_mul32 against Python integers on the extremes and random values,
    for every multiplier of the hash."""
    rng = np.random.default_rng(1)
    xs = np.concatenate([[0, 1, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**32 - 1],
                         rng.integers(0, 2**32, 4096)]).astype(np.int64)
    for c in (0x9E3779B9, 0x85EBCA6B, 0x7FEB352D, 0x846CA68B, 0xC2B2AE35, 0xFFFFFFFF):
        got = tch._mul32(torch.from_numpy(xs), c).numpy()
        assert got.tolist() == [(int(x) * c) % 2**32 for x in xs], hex(c)


@pytest.mark.parametrize("seed", [0, 2**32 - 1, 2**32 - 7, 0x5EEDC0DE])
def test_chaos_bits_and_decide_match_jax(seed):
    """chaos_bits and _decide on 10^5 sites (lane and edge indexes up to
    2^32 - 1, rounds across int32) against JAX's uint32 arithmetic."""
    rng = np.random.default_rng(seed % 1000)
    idx = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    idx[:3] = [0, 2**31, 2**32 - 1]
    rnd = rng.integers(-(2**31), 2**31, 100_000, dtype=np.int64).astype(np.int32)
    num = rng.integers(-2, tch.P_ONE + 2, 100_000).astype(np.int32)
    jseed = jax.numpy.asarray(seed, jax.numpy.uint32)
    tseed = torch.tensor(seed, dtype=torch.uint32)
    for salt in (1, 5, 9):
        want = np.asarray(jch.chaos_bits(jseed, jax.numpy.asarray(rnd), jax.numpy.asarray(idx), salt))
        got = tch.chaos_bits(tseed, torch.from_numpy(rnd), torch.from_numpy(idx.astype(np.int64)), salt)
        assert np.array_equal(want.astype(np.int64), got.numpy()), salt
        dw = np.asarray(jch._decide(jseed, jax.numpy.asarray(rnd), jax.numpy.asarray(idx), salt,
                                    jax.numpy.asarray(num)))
        dg = tch._decide(tseed, torch.from_numpy(rnd), torch.from_numpy(idx.astype(np.int64)),
                         salt, torch.from_numpy(num))
        assert np.array_equal(dw, dg.numpy()) and 0 < dw.mean() < 1, salt


def test_init_chaos_and_seed_stream_match_jax(_jax_chaos_env):
    """init_chaos at a cluster seed and a chaos_seed offset: every leaf
    (the seed a uint32 scalar) as JAX's with RAFT_TPU_CHAOS_SEED."""
    _jax_chaos_env.setenv("RAFT_TPU_CHAOS_SEED", "12345")
    try:
        want = jch.init_chaos(12, 3, seed=2**31 + 5)
    finally:
        _jax_chaos_env.delenv("RAFT_TPU_CHAOS_SEED")
    got = tch.init_chaos(12, 3, seed=2**31 + 5, chaos_seed=12345, device="cpu")
    assert_same_leaves(want, got, "init_chaos")
    with pytest.raises(ValueError, match="group-aligned"):
        tch.init_chaos(10, 3, device="cpu")
    with pytest.raises(KeyError, match="settable"):
        tch.with_columns(got, seed=1)


def test_wipe_volatile_matches_jax():
    """wipe_volatile on a random mask of a state with every volatile
    column random: the same leaves as JAX's."""
    v, n = 3, 18
    shape = JShape(n_lanes=n, max_peers=v, log_window=8, max_msg_entries=2, max_inflight=2,
                   max_read_index=2)
    ids = np.tile(np.arange(1, v + 1, dtype=np.int32), n // v)
    peers = np.broadcast_to(np.arange(1, v + 1, dtype=np.int32), (n, v))
    js = jst.init_state(shape, ids, peers, seed=9)
    rng = np.random.default_rng(4)
    upd = {}
    for f in dataclasses.fields(js):
        x = getattr(js, f.name)
        if f.name in ("cfg", "id", "prs_id") or x is None:
            continue
        a = np.asarray(x)
        upd[f.name] = jax.numpy.asarray(
            rng.integers(0, 2, a.shape).astype(bool) if a.dtype == bool
            else rng.integers(0, 2**31 if a.dtype == np.uint32 else 50, a.shape).astype(a.dtype))
    js = dataclasses.replace(js, **upd)
    ts = interop.from_numpy_tree(tst.RaftState, jax_leaves(js), "cpu")
    mask = rng.integers(0, 2, n).astype(bool)
    assert 0 < mask.sum() < n
    want = jst.wipe_volatile(js, jax.numpy.asarray(mask))
    got = tst.wipe_volatile(ts, torch.from_numpy(mask))
    assert_same_leaves(want, got, "wipe_volatile")
    assert np.array_equal(got.stabled.numpy(), np.where(mask, ts.last, ts.stabled))


# -- the engines through faults ------------------------------------------------------


def test_eager_engine_matches_jax(jax_run):
    """FusedCluster.run (fused_rounds) with chaos=True through two fault
    plans: the state, fabric, metrics and ChaosState leaves after 15 and
    33 rounds as JAX's; the diet one also after the fast-forward, the
    automatic rebase and 15 more rounds (host_state included)."""
    cfg, snaps = jax_run
    tc = _port(cfg)
    got = _drive(tc)
    _assert_carry(snaps[15], got[15], f"{cfg} eager @15")
    _assert_carry(snaps[33], got[33], f"{cfg} eager @33")
    if "rebased" in snaps:
        _rebase_run(tc)
        _assert_carry(snaps["rebased"], _carry(tc), f"{cfg} eager after the rebase")
        assert interop.digest(snaps["host"]) == interop.digest(
            interop.to_numpy_leaves(tc.host_state()))
        assert int(tc.host_state().last.max()) < tfused.FusedCluster.DIET_REBASE_AT
    cols = tc.chaos_columns()
    assert cols["n_reelected"] > 0 and (cols["reelect_round"] != NEVER).any()


@pytest.mark.parametrize("k", [1, 4])
def test_pallas_engine_matches_jax(jax_run, k):
    """engine="pallas" (its launches through round_kernel_ref(chaos=), two
    6- or 10-lane blocks) at K rounds a launch: the same leaves as JAX's
    eager scan after 33 rounds; the partials' last-round recounts folded
    into n_reelected / n_recommitted."""
    cfg, snaps = jax_run
    v = CFGS[cfg][0]
    tc = _port(cfg, engine="pallas", rounds_per_call=k, tile_lanes=2 * v)
    got = _drive(tc)
    _assert_carry(snaps[33], got[33], f"{cfg} pallas K={k}")


def test_one_block_blocked_cluster_matches_jax(jax_run):
    """A one-block BlockedFusedCluster (block 0 seeded as the cluster) with
    global-lane set_chaos: the JAX cluster's leaves after 33 rounds."""
    cfg, snaps = jax_run
    v, diet = CFGS[cfg]
    bc = BlockedFusedCluster(G, v, block_groups=G, seed=7, shape=Shape(**_shape(v)),
                             device="cpu", diet=diet, chaos=True)
    got = _drive(bc)
    _assert_carry(snaps[33], got[33], f"{cfg} blocked")


def test_jax_pallas_interpret_matches_port_pallas():
    """JAX pallas_rounds in interpret mode (2 tiles of 6 lanes, K = 2, 4
    rounds: two launches) with chaos, metrics off (the recounts in slots 0
    and 1 of the partials row), against the port's pallas_rounds on the
    same carry: state, fabric and chaos. (Interpret mode compiles this
    one program in about 35 s; the metrics-on layout is held by the
    engine cases above and the host build.)"""
    v, n = 3, G * 3
    jc = jfused.FusedCluster(G, v, seed=7, shape=JShape(**_shape(v)))
    tc = _port("v3-slim")
    for c in (jc, tc):
        for _ in range(5):
            c.run(STEP, **RUN)
        c.set_chaos(**{**_plan(v, 14), "heal_round": 16})
    _assert_carry(_carry(jc), _carry(tc), "before")
    kw = dict(v=v, n_rounds=4, do_tick=True, ops_first_round_only=True, tile_lanes=2 * v,
              rounds_per_call=2, **RUN)
    want = jplr._pallas_rounds_nodonate_jit(jc.state, jc.fab, jc._no_ops, jc.mute,
                                            interpret=True, metrics=None, chaos=jc.chaos, **kw)
    got = tplr.pallas_rounds(tc.state, tc.fab, tc._no_ops, tc.mute, chaos=tc.chaos, **kw)
    for what, w, g in zip(("state", "fabric", "chaos"), want, got, strict=True):
        assert_same_leaves(w, g, f"interpret K=2: {what}")
    assert int(got[2].n_reelected) > 0
    assert n == tc.chaos.drop_num.shape[0]


# -- semantics on the port --------------------------------------------------------


def test_quiet_chaos_equals_chaos_off():
    """tests/test_chaos.py:100 on the port: chaos on with every knob quiet
    walks the chaos-off trajectory (state and fabric), on both engines."""
    for engine in ("xla", "pallas"):
        runs = []
        for chaos in (False, True):
            c = tfused.FusedCluster(G, 3, seed=11, shape=Shape(**_shape(3)), device="cpu",
                                    chaos=chaos, engine=engine, tile_lanes=6)
            c.run(12, **RUN)
            c.run(12, **RUN)
            runs.append(interop.digest(interop.to_numpy_leaves(c.state),
                                       interop.to_numpy_leaves(c.fab)))
        assert runs[0] == runs[1], engine


def _faulted(seed: int, jax_side: bool = False):
    """tests/test_chaos.py:119 _faulted_run at STEP-round dispatches."""
    shape = _shape(3)
    c = (jfused.FusedCluster(G, 3, seed=seed, shape=JShape(**shape)) if jax_side else
         tfused.FusedCluster(G, 3, seed=seed, shape=Shape(**shape), device="cpu", chaos=True))
    n = G * 3
    for r in range(0, 18, STEP):
        if r == 6:
            c.set_chaos(drop_num=np.full((n, 3), tch.probability(0.3), np.int32),
                        dup_num=np.full((n, 3), tch.probability(0.3), np.int32),
                        tick_skew_num=np.full(n, tch.probability(0.5), np.int32))
        if r == 12:
            c.set_chaos(drop_num=np.zeros((n, 3), np.int32), dup_num=np.zeros((n, 3), np.int32),
                        tick_skew_num=np.zeros(n, np.int32))
        c.run(STEP, **RUN)
    c.check_no_errors()
    return c


def test_same_seed_bit_identical_with_faults():
    """tests/test_chaos.py:139 on the port: two same-seed faulted runs have
    one trajectory_digest, JAX's; a quiet run of the seed differs."""
    a, b = _faulted(23), _faulted(23)
    assert tsched.trajectory_digest(a) == tsched.trajectory_digest(b)
    assert tsched.trajectory_digest(a) == jsched.trajectory_digest(_faulted(23, jax_side=True))
    q = tfused.FusedCluster(G, 3, seed=23, shape=Shape(**_shape(3)), device="cpu", chaos=True)
    q.run(18, **RUN)
    assert tsched.trajectory_digest(a) != tsched.trajectory_digest(q)


def test_crash_freezes_lane_and_preserves_hardstate():
    """tests/test_chaos.py:203 on the port: a crashed leader becomes a
    follower, its term, vote, committed and last stay frozen while it is
    down, and after the restart HardState has survived and the lane
    commits past its frozen index."""
    c = tfused.FusedCluster(2, 3, seed=5, shape=Shape(**{**_shape(3), "n_lanes": 6}),
                            device="cpu", chaos=True)
    c.run(32, **RUN)
    c.check_no_errors()
    leaders = c.leader_lanes()
    assert len(leaders) == 2
    victim = int(leaders[0])
    r = int(c.chaos.round)
    crash, restart = np.full(6, NEVER, np.int32), np.full(6, NEVER, np.int32)
    crash[victim], restart[victim] = r + 2, r + 10
    c.set_chaos(crash_at=crash, restart_at=restart)

    def hard(c):
        st = c.host_state()
        return tuple(int(getattr(st, f)[victim]) for f in ("term", "committed", "vote", "last"))

    c.run(4, **RUN)
    assert int(c.state.state[victim]) == int(tst.StateType.FOLLOWER)
    frozen = hard(c)
    c.run(4, **RUN)
    assert hard(c) == frozen and int(c.state.state[victim]) == int(tst.StateType.FOLLOWER)
    c.run(40, **RUN)
    c.check_no_errors()
    now = hard(c)
    assert now[0] >= frozen[0] and now[1] > frozen[1]
    st = c.state.state.reshape(2, 3)
    assert int((st[victim // 3] == int(tst.StateType.LEADER)).sum()) == 1


def test_chaos_with_paging_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="chaos branch x in-kernel paging"):
        tfused.FusedCluster(G, 3, shape=Shape(**_shape(3), page_window=4, page_entries=2),
                            device="cpu", chaos=True, paged=True)
    c = tfused.FusedCluster(G, 3, shape=Shape(**_shape(3)), device="cpu")
    with pytest.raises(RuntimeError, match="chaos plane is off"):
        c.set_chaos(heal_round=0)
    assert c.chaos_columns() == {}
    with pytest.raises(RuntimeError, match="no chaos plane"):
        tsched.ChaosRunner(c, tsched.ChaosSchedule(G, 3))


# -- the host plane ------------------------------------------------------------


def _schedules(g: int, v: int):
    """The same scenario in both packages, one of every event kind."""
    out = []
    for mod in (jsched, tsched):
        out.append(
            mod.ChaosSchedule(g, v)
            .rolling_partitions(at=4, waves=3, duration=5, settle=2)
            .partition(groups=range(10, 20), at=6, duration=4, members=(0, 2), asymmetric=True)
            .flap(groups=[30, 31, 33], at=5, cycles=2, down=2, up=3)
            .drop(groups=range(40, 48), at=3, duration=9, prob=0.25)
            .drop(groups=[50, 51], at=4, duration=5, prob=0.5, members=(1,))
            .duplicate(groups=range(0, 64, 7), at=2, duration=6, prob=0.125)
            .skew(groups=range(20, 30), at=1, duration=12, prob=0.3, members=(0, 1))
            .kill(lanes=[5, 17, 17, 100], at=7, down=3)
            .kill(lanes=[60], at=9, down=0)
            .kill_leaders(groups=range(8, 16), at=8, down=4)
            .staggered_restart(groups=[55, 56], at=10, down=2, gap=3)
        )
    return out


def test_schedule_columns_and_segments_match_jax():
    """tests/test_chaos.py:292 at G = 64: the segments, the heal groups and
    every knob column at every segment start equal JAX's, leader kills
    resolved from the same leader lanes."""
    g, v = 64, 3
    js, ts = _schedules(g, v)
    assert ts.horizon() == js.horizon()
    segs = ts.segments(settle=10)
    assert segs == js.segments(settle=10)
    leaders = np.arange(0, g * v, v) + np.arange(g) % v
    for a, _ in segs:
        for s in (js, ts):
            s.resolve_kills(a, lambda: leaders)
        assert ts.heal_groups_at(a).tolist() == list(js.heal_groups_at(a)), a
        want, got = js.columns(a), ts.columns(a)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), (a, k)
    with pytest.raises(ValueError, match="both sides"):
        tsched.ChaosSchedule(4, 3).partition(groups=[0], at=0, duration=1, members=(0, 1, 2))
    with pytest.raises(ValueError, match="outside"):
        tsched.ChaosSchedule(4, 3).drop(groups=[4], at=0, duration=1, prob=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsched.ChaosSchedule(4, 3).wire_partition([(0, 1)], at=0, duration=1)
    with pytest.raises(NotImplementedError, match="lease"):
        tsched.ChaosSchedule(4, 3).lease_skew_storm(groups=[0], at=0, bursts=1)


def test_blocked_set_chaos_slices_global_columns():
    """tests/test_chaos.py:323 on the port: global columns slice per block,
    scalars broadcast, chaos_columns concatenates and sums the recounts."""
    bc = BlockedFusedCluster(4, 3, block_groups=2, seed=3, device="cpu", chaos=True)
    assert bc.chaos_enabled
    n = 12
    crash = np.full(n, NEVER, np.int32)
    crash[1], crash[7] = 100, 200
    bc.set_chaos(crash_at=crash, heal_round=77)
    assert int(bc.blocks[0].chaos.crash_at[1]) == 100 and int(bc.blocks[1].chaos.crash_at[1]) == 200
    assert int(bc.blocks[0].chaos.heal_round) == int(bc.blocks[1].chaos.heal_round) == 77
    cols = bc.chaos_columns("crash_at", "heal_round", "n_reelected")
    assert cols["crash_at"].shape == (n,) and cols["crash_at"][1] == 100
    assert cols["crash_at"][7] == 200 and cols["heal_round"] == 77 and cols["n_reelected"] == 0
    # the blocks' streams decorrelate: seeds from seed + 7919 * i
    assert int(bc.blocks[0].chaos.seed) != int(bc.blocks[1].chaos.seed)


def test_chaos_runner_matches_jax():
    """Skew, duplicates and drops, then a partition and a leader kill healed
    at round 24, through both packages' ChaosRunner (segments of 3 and 6
    rounds, election safety after each): one trajectory_digest and one
    probe snapshot."""
    out = []
    for mod, fmod, shape in ((jsched, jfused, JShape), (tsched, tfused, Shape)):
        kw = {} if fmod is jfused else dict(device="cpu", chaos=True)
        c = fmod.FusedCluster(G, 3, seed=13, shape=shape(**_shape(3)), **kw)
        sched = (mod.ChaosSchedule(G, 3)
                 .skew(groups=[0, 1], at=3, duration=6, prob=0.3)
                 .duplicate(groups=[1, 2], at=9, duration=6, prob=0.25)
                 .drop(groups=[2, 3], at=15, duration=6, prob=0.2)
                 .partition(groups=[1, 3], at=21, duration=3)
                 .kill_leaders(groups=[0, 2], at=21, down=3))
        runner = mod.ChaosRunner(c, sched, tick_budget=24, settle=6, **RUN)
        out.append((sched.segments(settle=6), runner.run(), mod.trajectory_digest(c)))
    assert out[0][0] == out[1][0] and {b - a for a, b in out[1][0]} == {3, 6}
    assert out[0][1] == out[1][1] and out[0][2] == out[1][2]
    counters = out[1][1]["counters"]
    # probed: the groups that re-elected, plus each unrecovered fold
    assert counters["chaos_phases"] == 1 and counters["chaos_groups_probed"] >= G
