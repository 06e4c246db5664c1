"""The port's diet-v2 packed carry against the JAX package, leaf for leaf.

The JAX side runs with RAFT_TPU_DIET=1 (and carry donation off, metrics
on) set for this module; the port builds its clusters with diet=True.
Integer state: every comparison is exact, dtypes included. Covered: the
Shape bounds the packed layout needs; pack_state / unpack_state and
pack_fabric / unpack_fabric on randomised carries at V = 3, 9 and 17 (all
three bitset widths), in range and out of it (clamp and ERR_DIET_OVERFLOW);
the eager engine over 33 rounds and the pallas engine's plain version at
K = 1 and 4 over 9 rounds on a packed carry; the automatic rebase under
DIET_REBASE_AT; the blocked scheduler with diet on and off; and the
packed layout of csrc/round.cu's diet build. Every JAX cluster run
dispatches one compiled program (3 rounds, auto_propose, compaction lag 4).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tests.test_diet as jdiet
from raft_tpu import state as jst
from raft_tpu.config import Shape as JShape
from raft_tpu.ops import fused as jfused
from raft_tpu.scheduler import BlockedFusedCluster as JBlocked
from raft_tpu_torch import interop
from raft_tpu_torch import state as tst
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import round_cuda as rc
from raft_tpu_torch.scheduler import BlockedFusedCluster
from tests.test_torch_state import assert_same_leaves, jax_leaves, release_memory  # noqa: F401

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

V = 3
G = 4
N = G * V
RUN = dict(auto_propose=True, auto_compact_lag=4)
SHAPE = dict(max_peers=V, log_window=8, max_msg_entries=2, max_inflight=2, max_read_index=2)
STEP = 3  # rounds per JAX dispatch: one compiled program for the file
ENV_OFF = ("ENGINE", "PALLAS_ROUNDS", "CHAOS", "TRACELOG", "PAGED", "LEASE", "TIER")


@pytest.fixture(scope="module", autouse=True)
def _jax_diet_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_DIET", "1")
        mp.setenv("RAFT_TPU_DONATE", "0")
        mp.setenv("RAFT_TPU_METRICS", "1")
        for k in ENV_OFF:
            mp.delenv(f"RAFT_TPU_{k}", raising=False)
        yield


def _clusters(seed: int, n_groups: int = G, **port):
    n = n_groups * V
    jc = jfused.FusedCluster(n_groups, V, seed=seed, shape=JShape(n_lanes=n, **SHAPE))
    tc = tfused.FusedCluster(n_groups, V, seed=seed, shape=Shape(n_lanes=n, **SHAPE),
                             device="cpu", diet=True, **port)
    return jc, tc


def _carry(c):
    return c.state, c.fab, c.metrics


def _assert_carry(want, tc, what: str):
    """want: a JAX (state, fabric, metrics) carry; tc: a port cluster."""
    assert tst.is_packed(tc.state) and tfused.is_packed_fabric(tc.fab)
    for part, w, t in zip(("state", "fabric", "metrics"), want, _carry(tc)):
        assert_same_leaves(w, t, f"{what}: {part}")


# -- the Shape bounds -----------------------------------------------------------

# the JAX rejection matrix, tests/test_diet.py test_shape_rejects_unpackable_bounds
REJECTED = next(
    m.args[1] for m in jdiet.test_shape_rejects_unpackable_bounds.pytestmark
    if m.name == "parametrize"
)
SHAPE_BASE = dict(n_lanes=12, max_peers=3, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)


@pytest.mark.parametrize("kw", REJECTED, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_shape_rejects_what_jax_rejects(kw):
    """Each Shape the JAX package refuses, the port refuses with the same
    message; the base Shape both take."""
    JShape(**SHAPE_BASE)
    Shape(**SHAPE_BASE)
    with pytest.raises(ValueError) as want:
        JShape(**{**SHAPE_BASE, **kw})
    with pytest.raises(ValueError) as got:
        Shape(**{**SHAPE_BASE, **kw})
    assert str(got.value) == str(want.value)


# -- the pack functions -------------------------------------------------------------

# one compiled program per Shape, not one per operation
_jax_pack_state = jax.jit(jst.pack_state)
_jax_unpack_state = jax.jit(jst.unpack_state)
_jax_pack_fabric = jax.jit(jfused.pack_fabric)
_jax_unpack_fabric = jax.jit(jfused.unpack_fabric)
_jax_store_carry = jax.jit(jfused.store_carry)
_jax_load_carry = jax.jit(jfused.load_carry)


def _random_slim(v: int, seed: int, wide: bool):
    """The leaves of a slim state of 3 groups x v voters with every packed
    column random: within its packed range, or (`wide`) across a span four
    times as wide, so that about half the values clamp."""
    n = 3 * v
    shape = JShape(n_lanes=n, max_peers=v, log_window=8, max_msg_entries=2,
                   max_inflight=2, max_read_index=2)
    ids = np.tile(np.arange(1, v + 1, dtype=np.int32), 3)
    peers = np.broadcast_to(np.arange(1, v + 1, dtype=np.int32), (n, v))
    st = jst.slim_state(jst.init_state(shape, ids, peers, seed=seed))
    rng = np.random.default_rng(seed)
    spans = {**{f: (0, 1 << 16) for f in jst.PACK_U16},
             **{f: (-128, 128) for f in jst.PACK_I8},
             **{f: (-(1 << 15), 1 << 15) for f in jst.PACK_I16}}
    upd = {}
    for f, (lo, hi) in spans.items():
        x = np.asarray(getattr(st, f))
        if wide:
            lo, hi = lo - (hi - lo), hi + (hi - lo)
        upd[f] = jax.numpy.asarray(rng.integers(lo, hi, x.shape).astype(x.dtype))
    for f in jst.PACK_BITSET:
        upd[f] = jax.numpy.asarray(rng.integers(0, 2, np.asarray(getattr(st, f)).shape) > 0)
    upd["error_bits"] = jax.numpy.asarray(rng.integers(0, 64, n).astype(np.int32))
    js = dataclasses.replace(st, **upd)
    return js, interop.from_numpy_tree(tst.RaftState, jax_leaves(js), "cpu")


@pytest.mark.parametrize("wide", [False, True], ids=["in_range", "clamped"])
@pytest.mark.parametrize("v", [3, 9, 17])
def test_pack_state_matches_jax(v, wide):
    js, ts = _random_slim(v, seed=v, wide=wide)
    jp, tp = _jax_pack_state(js), tst.pack_state(ts)
    assert_same_leaves(jp, tp, "pack_state")
    assert tst.is_packed(tp) and not tst.is_packed(ts)
    assert tp.voters_in.dtype == tst.bitset_dtype(v) and tp.ro_acks.shape == (3 * v, 2)
    assert_same_leaves(_jax_unpack_state(jp), tst.unpack_state(tp), "unpack_state")
    flagged = (tp.error_bits & tst.ERR_DIET_OVERFLOW) != 0
    assert bool(flagged.all()) == wide and (wide or not flagged.any())
    # idempotent both ways, and an exact round trip for in-range values
    assert_same_leaves(jp, tst.pack_state(tp), "pack o pack")
    u = tst.unpack_state(tp)
    assert interop.digest(interop.to_numpy_leaves(tst.unpack_state(u))) == interop.digest(
        interop.to_numpy_leaves(u))
    if not wide:
        assert_same_leaves(js, u, "unpack o pack")


def _random_fabric(v: int, seed: int, wide: bool):
    """The leaves of a slim fabric of 3 groups x v voters with random kinds
    and every packed column random (`wide`: about half out of range)."""
    n, e = 3 * v, 2
    fab = jfused.slim_fabric(jfused.empty_fabric(n, v, e))
    rng = np.random.default_rng(100 + seed)
    leaves = jax_leaves(fab)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(fab)]
    packed = {f".{c}.{f}": dt for (c, f), dt in jfused.FABRIC_PACK.items()}
    out = []
    for path, x in zip(paths, leaves):
        if path in packed:
            lo, hi = (0, 1 << 16) if packed[path] == jax.numpy.uint16 else (-(1 << 15), 1 << 15)
            if wide:
                lo, hi = lo - (hi - lo), hi + (hi - lo)
            x = rng.integers(lo, hi, x.shape).astype(x.dtype)
        elif x.dtype == np.int8:
            x = rng.integers(0, 64, x.shape).astype(np.int8)
        out.append(x)
    jf = jax.tree.unflatten(jax.tree.structure(fab), [jax.numpy.asarray(x) for x in out])
    return jf, interop.from_numpy_tree(tfused.Fabric, out, "cpu")


@pytest.mark.parametrize("wide", [False, True], ids=["in_range", "clamped"])
@pytest.mark.parametrize("v", [3, 9, 17])
def test_pack_fabric_and_carry_boundary_match_jax(v, wide):
    jf, tf = _random_fabric(v, seed=v, wide=wide)
    jp, tp = _jax_pack_fabric(jf), tfused.pack_fabric(tf)
    assert_same_leaves(jp, tp, "pack_fabric")
    assert tfused.is_packed_fabric(tp) and not tfused.is_packed_fabric(tf)
    assert_same_leaves(_jax_unpack_fabric(jp), tfused.unpack_fabric(tp), "unpack_fabric")
    assert_same_leaves(jp, tfused.pack_fabric(tp), "pack o pack")
    ovf = tfused.fabric_diet_overflow(tf)
    assert np.array_equal(np.asarray(jfused.fabric_diet_overflow(jf)), ovf.numpy())
    assert bool(ovf.any()) == wide and not tfused.fabric_diet_overflow(tp).any()
    if not wide:
        assert_same_leaves(jf, tfused.unpack_fabric(tp), "unpack o pack")
    # the boundary both engines cross: fabric overflow folded into the state
    js, ts = _random_slim(v, seed=v + 1, wide=False)
    jstored = _jax_store_carry(js, jf)
    for jx, tx, what in zip(jstored, tfused.store_carry(ts, tf),
                            ("store_carry state", "store_carry fabric")):
        assert_same_leaves(jx, tx, what)
    jl, tl = _jax_load_carry(*jstored), tfused.load_carry(*tfused.store_carry(ts, tf))
    assert_same_leaves(jl[0], tl[0], "load_carry state")
    assert_same_leaves(jl[1], tl[1], "load_carry fabric")


def test_overflow_clamps_and_flags_only_its_lane():
    """tests/test_diet.py:186 and :204 on the port: an out-of-range value
    clamps and sets ERR_DIET_OVERFLOW on its own lane, never wraps."""
    _, ts = _random_slim(3, seed=5, wide=False)
    last = torch.full_like(ts.last, 100)
    last[0], last[1] = 70000, -7
    ts = dataclasses.replace(ts, last=last, error_bits=torch.zeros_like(ts.error_bits))
    p = tst.pack_state(ts)
    eb = p.error_bits
    assert eb[0] & tst.ERR_DIET_OVERFLOW and eb[1] & tst.ERR_DIET_OVERFLOW
    assert (eb[2:] == 0).all()
    u = tst.unpack_state(p).last
    assert u[0] == 65535 and u[1] == 0 and (u[2:] == 100).all()
    fab = tfused.slim_fabric(tfused.empty_fabric(9, 3, 2, "cpu"))
    assert not tfused.fabric_diet_overflow(fab).any()
    idx = fab.rep.index.clone()
    idx[0] = 70000
    bad = dataclasses.replace(fab, rep=dataclasses.replace(fab.rep, index=idx))
    ovf = tfused.fabric_diet_overflow(bad)
    assert ovf[0] and not ovf[1:].any()
    assert (tfused.unpack_fabric(tfused.pack_fabric(bad)).rep.index[0] == 65535).all()


def test_interop_carries_a_packed_jax_carry():
    """The leaves of a JAX packed carry build the port's packed carry, and
    the digest tells leaves apart by dtype."""
    js, _ = _random_slim(3, seed=2, wide=False)
    jp = _jax_pack_state(js)
    tp = interop.from_numpy_tree(tst.RaftState, jax_leaves(jp), "cpu")
    assert tst.is_packed(tp)
    assert_same_leaves(jp, tp, "from_numpy_tree")
    a = np.arange(4, dtype=np.int32)
    assert interop.digest([a]) != interop.digest([a.view(np.uint32)])


def test_round_cu_diet_table_is_the_packed_layout():
    """csrc/round.cu's diet tables: each packed leaf with pack_state's and
    pack_fabric's dtype and shape (V <= 8: every bitset a byte)."""
    rc._check_layout()
    n, e = N, SHAPE["max_msg_entries"]
    c = tfused.FusedCluster(G, V, shape=Shape(n_lanes=N, **SHAPE), device="cpu", diet=True)
    dims = rc.dims_of(c.state, c.fab, V)
    leaves = {
        "STATE": [getattr(c.state, x) for x in rc.dataclass_names()["STATE"]],
        "CFG": [getattr(c.state.cfg, x) for x in rc.dataclass_names()["CFG"]],
        "FABRIC": rc._fab_leaves(c.fab),
    }
    changed = 0
    for g, xs in leaves.items():
        for (name, dt, kind), slim, x in zip(rc.layout(True)[g], rc.layout()[g], xs):
            assert x.dtype == rc.DTYPES[dt], (g, name)
            assert tuple(x.shape) == rc._shape(kind, n, V, dims), (g, name)
            changed += (dt, kind) != slim[1:]
    assert changed == sum(len(rows) for rows in rc.diet_rows().values()) == 55
    d = dict(v=V, w=8, e=e, f=2, r=2)
    assert rc.target(d, 6, diet=True).key == rc.target(d, 6).key + "-diet1"


# -- the engines on a packed carry --------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """The JAX diet cluster of seed 7 after 9 and after 33 rounds, as
    dispatches of STEP rounds."""
    jc, _ = _clusters(7)
    snaps = {}
    for i in range(1, 12):
        jc.run(STEP, **RUN)
        if i * STEP in (9, 33):
            snaps[i * STEP] = _carry(jc)
    jc.check_no_errors()
    return snaps


def test_eager_rounds_match_jax(jax_run):
    """33 rounds of the eager engine on a packed carry: every packed state,
    fabric and metrics leaf as the JAX scan leaves it."""
    _, tc = _clusters(7)
    assert tst.is_packed(tc.state)
    for _ in range(33 // STEP):
        tc.run(STEP, **RUN)
    _assert_carry(jax_run[33], tc, "33 eager rounds")
    assert int(tc.state_columns("committed")["committed"].max()) > 0


@pytest.mark.parametrize("k", [1, 4])
def test_pallas_plain_version_matches_jax(jax_run, k):
    """The pallas engine's plain version (round_kernel_ref, K rounds a
    launch: at K = 4 two full launches and a remainder) over 9 rounds in
    one dispatch on the packed carry, against the JAX scan."""
    _, tc = _clusters(7, engine="pallas", rounds_per_call=k, tile_lanes=2 * V)
    tc.run(9, **RUN)
    _assert_carry(jax_run[9], tc, f"pallas K={k}")


def test_auto_rebase_matches_jax():
    """tests/test_diet.py:371 on the port: fast-forward the batch by 48 Ki,
    run on, and the packed twin rebases under DIET_REBASE_AT by itself;
    the raw packed carry and host_state equal the JAX twin's."""
    twins = _clusters(7)
    mids = []
    for c in twins:
        for _ in range(10):
            c.run(STEP, **RUN)
        c.rebase_groups(range(G), delta=-(48 * 1024))
        assert int(np.asarray(c.state_columns("last")["last"]).max()) >= 48 * 1024
        for _ in range(5):
            c.run(STEP, **RUN)
        mids.append(int(np.asarray(c.state_columns("last")["last"]).max()))
        c.rebase_groups(range(G))
        c.check_no_errors()
    jc, tc = twins
    assert mids[0] == mids[1] < tfused.FusedCluster.DIET_REBASE_AT == jc.DIET_REBASE_AT
    _assert_carry(_carry(jc), tc, "after the automatic rebase")
    assert_same_leaves(jc.host_state(), tc.host_state(), "host_state")


def test_blocked_diet_equals_slim():
    """Two blocks with diet on and off: one host_state digest per block,
    one total_committed, the same state columns."""
    kw = dict(block_groups=4, seed=5, shape=Shape(n_lanes=N, **SHAPE), round_chunk=8,
              device="cpu")
    on = BlockedFusedCluster(8, V, diet=True, **kw)
    off = BlockedFusedCluster(8, V, **kw)
    for b in (on, off):
        b.run(24, **RUN)
        b.check_no_errors()
    assert all(tst.is_packed(b.state) for b in on.blocks)
    for x, y in zip(on.blocks, off.blocks):
        assert interop.digest(interop.to_numpy_leaves(x.host_state())) == interop.digest(
            interop.to_numpy_leaves(y.host_state()))
    assert on.total_committed() == off.total_committed() > 0
    cols = ("committed", "last", "voters_in")
    a, b = on.state_columns(*cols), off.state_columns(*cols)
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in cols)


@pytest.mark.parametrize("blocks", [1, 2])
def test_blocked_diet_rebases_when_jax_does(blocks):
    """One and two diet blocks against JAX's BlockedFusedCluster: 30
    rounds, block 0 fast-forwarded to 49,072 + its last index, 30 more.
    One block runs all 30 rounds in one dispatch, as JAX does, so the
    automatic rebase projects 30 * (E + 1) at once and fires when JAX's
    does; two blocks sweep in round_chunk pieces on both sides. Every
    block's host_state digest equals JAX's after each step."""
    kw = dict(block_groups=G, seed=7, round_chunk=STEP)
    jb = JBlocked(G * blocks, V, shape=JShape(n_lanes=N, **SHAPE), **kw)
    tb = BlockedFusedCluster(G * blocks, V, shape=Shape(n_lanes=N, **SHAPE), device="cpu",
                             diet=True, **kw)
    tops = []
    for step in ("run", "fast-forward", "run"):
        for c in (jb, tb):
            if step == "run":
                c.run(30, **RUN)
            else:
                c.blocks[0].rebase_groups(range(G), delta=-49072)
        for i, (jx, tx) in enumerate(zip(jb.blocks, tb.blocks)):
            assert interop.digest(jax_leaves(jx.host_state())) == interop.digest(
                interop.to_numpy_leaves(tx.host_state())), (step, i)
        tops.append(int(tb.blocks[0].host_state().last.max()))
    tb.check_no_errors()
    # one block projects 90 past the fast-forward, over DIET_REBASE_AT, and
    # rebases down; two blocks project 9 a chunk and stay up, as in JAX
    assert tops[1] > 49072 and (tops[2] < tops[0] + 60) == (blocks == 1)


def test_adopt_state_repacks_the_host_view():
    """adopt_state, host_state's write-side twin: the host view of a packed
    carry adopted back is the same packed carry; a slim cluster takes a
    fat state in its slim dtypes."""
    on = tfused.FusedCluster(G, V, seed=3, shape=Shape(n_lanes=N, **SHAPE), device="cpu",
                             diet=True)
    off = tfused.FusedCluster(G, V, seed=3, shape=Shape(n_lanes=N, **SHAPE), device="cpu")
    for c in (on, off):
        c.run(15, **RUN)
    packed = interop.to_numpy_leaves(on.state)
    host = on.host_state()
    assert not tst.is_packed(host)
    on.adopt_state(tst.fat_state(host))
    assert tst.is_packed(on.state)
    assert interop.digest(packed) == interop.digest(interop.to_numpy_leaves(on.state))
    slim = interop.to_numpy_leaves(off.state)
    off.adopt_state(tst.fat_state(off.host_state()))
    assert interop.digest(slim) == interop.digest(interop.to_numpy_leaves(off.state))
