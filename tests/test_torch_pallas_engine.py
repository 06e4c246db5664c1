"""The port's pallas engine on the CPU: the cluster and scheduler entry
points against the eager engine, the tile and round-plan errors, the
library and block chosen for each Shape (build target, shape bounds, shared
memory, CUDA block), and the argument packing of csrc/round.cu against the
dataclasses.

Integer state: every comparison is exact. The JAX package is not needed
here; tests/test_torch_pallas_round.py holds the engine against it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops import round_cuda as rc
from raft_tpu_torch.scheduler import BlockedFusedCluster
from raft_tpu_torch.state import init_state, slim_state

V = 3
G = 4
N = G * V
TILE = 2 * V
RUN = dict(auto_propose=True, auto_compact_lag=4)


def _shape(n_lanes=N, v=V):
    return Shape(n_lanes=n_lanes, max_peers=v, log_window=8, max_msg_entries=2,
                 max_inflight=2, max_read_index=2)


def _digest(c) -> str:
    return interop.digest(
        interop.to_numpy_leaves(c.state) + interop.to_numpy_leaves(c.fab)
        + interop.to_numpy_leaves(c.metrics)
    )


# -- (c) the entry points ---------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 5])
def test_cluster_pallas_equals_xla(k):
    """A muted lane and injected ops, 9 rounds in two runs: the pallas
    engine lands on the eager engine's digest at every K."""
    cx = tfused.FusedCluster(G, V, seed=2, shape=_shape(), device="cpu")
    cp = tfused.FusedCluster(G, V, seed=2, shape=_shape(), device="cpu", engine="pallas",
                             tile_lanes=TILE, rounds_per_call=k)
    assert (cx.engine, cp.engine, cp._pallas_rounds, cp._pallas_tile) == ("xla", "pallas", k, TILE)
    for c in (cx, cp):
        c.run(5, **RUN)
        c.set_mute([4])
        c.run(4, ops=c.ops(hup={7: True}, prop_n={0: 2}, prop_bytes=3,
                           read_ctx={i: 50 + i for i in range(N)}), **RUN)
    assert _digest(cx) == _digest(cp)
    assert cp.metrics_snapshot()["counters"] == cx.metrics_snapshot()["counters"]


def test_blocked_passthrough():
    kw = dict(block_groups=2, seed=5, shape=_shape(6), round_chunk=2, device="cpu")
    bx = BlockedFusedCluster(4, V, **kw)
    bp = BlockedFusedCluster(4, V, engine="pallas", rounds_per_call=2, **kw)
    assert all(b.engine == "pallas" and b._pallas_rounds == 2 for b in bp.blocks)
    for b in (bx, bp):
        b.run(24, **RUN)
    assert bp.leader_count() == bx.leader_count() == 4
    for x, p in zip(bx.blocks, bp.blocks):
        assert _digest(x) == _digest(p)
    assert bp.metrics_snapshot() == bx.metrics_snapshot()
    bp.check_no_errors()


def test_metrics_off_and_no_tick():
    cx = tfused.FusedCluster(G, V, seed=3, shape=_shape(), device="cpu", metrics=False)
    cp = tfused.FusedCluster(G, V, seed=3, shape=_shape(), device="cpu", metrics=False,
                             engine="pallas", rounds_per_call=2)
    for c in (cx, cp):
        c.campaign(0)
        c.run(3, do_tick=False, ops_first_round_only=False, ops=c.ops(prop_n={0: 1}))
    assert cp.metrics is None
    assert interop.digest(interop.to_numpy_leaves(cx.state)) == interop.digest(
        interop.to_numpy_leaves(cp.state)
    )


# -- (d) tile and round-plan errors ----------------------------------------


def test_tile_invariants_rejected():
    plr.check_tile(12, 3, 6)
    with pytest.raises(plr.TileError, match="multiple of v"):
        plr.check_tile(12, 3, 4)
    with pytest.raises(plr.TileError, match="does not divide"):
        plr.check_tile(12, 3, 9)
    with pytest.raises(plr.TileError, match=">= 1"):
        plr.check_tile(12, 3, 0)
    # a configuration error: raised by the constructor, never rerouted
    with pytest.raises(plr.TileError, match="multiple of v"):
        tfused.FusedCluster(G, V, seed=1, shape=_shape(), device="cpu", engine="pallas",
                            tile_lanes=4)
    # the xla engine ignores the pallas knobs, as in the JAX package
    assert tfused.FusedCluster(G, V, shape=_shape(), device="cpu", tile_lanes=4).engine == "xla"


def test_tile_helpers():
    n, v = 4096 * 3, 3
    cands = plr.tile_candidates(n, v)
    assert cands == [768, 1536, 3072, 6144, n]
    assert all(n % t == 0 and t % v == 0 for t in cands)
    assert plr.default_tile(n, v) == 3072
    assert plr.default_tile(12, 3) == 12
    assert plr.default_tile(65536 * 3, 3) == 3072  # the bench block
    assert rc.cta_lanes(3072, 3) == rc.CTA_TARGET == 96  # 3 blocks per SM on the H100
    assert rc.cta_lanes(6, 3) == 6
    assert rc.cta_lanes(3 * 1021, 3) == 3  # 1021 is prime
    assert all(rc.cta_lanes(t, 5) % 5 == 0 for t in (5, 10, 640, 5 * 512))


@pytest.mark.parametrize("v", range(1, rc.MAX_V + 1))
def test_tiles_and_blocks_align_to_groups(v):
    """For every V the kernel instantiates: each tile candidate passes
    check_tile, the default tile is one of them, and the CUDA block of each
    tile holds whole groups, divides the tile and fits kMaxCta."""
    for groups in (1, 3, 4, 1024, 4096, 65536):
        n = groups * v
        cands = plr.tile_candidates(n, v)
        assert cands[-1] == n and cands == sorted(set(cands))
        for t in cands:
            plr.check_tile(n, v, t)
            cta = rc.cta_lanes(t, v)
            assert cta % v == 0 and t % cta == 0 and cta <= rc.MAX_CTA, (n, t, cta)
        tile = plr.default_tile(n, v)
        assert tile in cands
        assert tile <= 1024 * v or tile == cands[0]


def test_round_plan_validation():
    plr.validate_round_plan(1)
    plr.validate_round_plan(plr.MAX_ROUNDS_PER_CALL)
    with pytest.raises(ValueError, match="MAX_ROUNDS_PER_CALL"):
        plr.validate_round_plan(plr.MAX_ROUNDS_PER_CALL + 1)
    for bad in (0, -2, 1.5, True):
        with pytest.raises(ValueError, match="integer >= 1"):
            plr.validate_round_plan(bad)
    with pytest.raises(ValueError, match="round_chunk"):
        plr.validate_round_plan(3, round_chunk=4)
    plr.validate_round_plan(2, round_chunk=4)
    with pytest.raises(ValueError, match="round_chunk"):
        BlockedFusedCluster(4, 3, block_groups=2, seed=1, shape=_shape(6), device="cpu",
                            engine="pallas", rounds_per_call=3, round_chunk=4)
    with pytest.raises(ValueError, match="MAX_ROUNDS_PER_CALL"):
        tfused.FusedCluster(G, V, shape=_shape(), device="cpu", engine="pallas",
                            rounds_per_call=65)
    with pytest.raises(ValueError, match="unknown engine"):
        tfused.FusedCluster(G, V, shape=_shape(), device="cpu", engine="mosaic")
    assert plr.resolve_engine(None) == "xla" and plr.resolve_engine("PALLAS") == "pallas"


# -- (e) the argument packing -------------------------------------------------


def test_round_cu_tables_follow_the_dataclasses():
    """csrc/round.cu's leaf tables: the dataclass field order, and each
    leaf's storage dtype and shape as the slim carry holds them."""
    table = rc.layout()
    assert {g: tuple(n for n, _, _ in rows) for g, rows in table.items()} == rc.dataclass_names()
    n, w, e, f, r = N, 8, 2, 2, 2
    ids = np.tile(np.arange(1, V + 1, dtype=np.int32), G)
    peers = np.broadcast_to(np.arange(1, V + 1, dtype=np.int32), (N, V))
    st = slim_state(init_state(_shape(), ids, peers, device="cpu"))
    fab = tfused.slim_fabric(tfused.empty_fabric(n, V, e, "cpu"))
    ops = tfused.no_ops(n, "cpu")
    dims = {"w": w, "e": e, "f": f, "r": r}
    leaves = {
        "STATE": [getattr(st, x) for x in rc.dataclass_names()["STATE"]],
        "CFG": [getattr(st.cfg, x) for x in rc.dataclass_names()["CFG"]],
        "FABRIC": interop.to_numpy_leaves(fab),
        "OPS": list(ops),
    }
    for g, rows in table.items():
        assert len(rows) == len(leaves[g])
        for (name, dt, kind), x in zip(rows, leaves[g]):
            x = torch.as_tensor(x)
            assert x.dtype == rc.DTYPES[dt], (g, name)
            assert tuple(x.shape) == rc._shape(kind, n, V, dims), (g, name)


def test_pack_checks_every_leaf():
    c = tfused.FusedCluster(G, V, shape=_shape(), device="cpu")
    m = c.metrics
    kw = dict(v=V, kc=2, cta=TILE, apply_ops=True, ops_round0_only=True, do_tick=True,
              auto_propose=True, auto_compact_lag=4)
    samp = (m.samp_index, m.samp_round)
    ptrs, dims, flags, lag, outputs = rc.pack(
        c.state, c.fab, c._no_ops, c.mute, samp, m.round_ctr, **kw
    )
    # no scratch fabric: the K rounds keep the fabric in shared memory; the
    # PagedLog's 8 leaves in and out close the table, null when unpaged
    assert len(ptrs) == 58 + 13 + 29 + 8 + 4 + 58 + 29 + 3 + 2 * 8
    assert ptrs[-16:] == [None] * 16
    assert dims == [N, V, 8, 2, 2, 2, 2, TILE, 0] and lag == 4
    assert flags == rc.F_MUTE | rc.F_METRICS | rc.F_TICK | rc.F_AUTO_PROPOSE | rc.F_LAG | rc.F_OPS | rc.F_OPS_ROUND0
    assert outputs[3].shape == (2, N // TILE, plr.PARTIAL_WIDTH)
    fat = tfused.fat_fabric(c.fab)
    with pytest.raises(TypeError, match="fabric.rep_kind"):
        rc.pack(c.state, fat, c._no_ops, c.mute, samp, m.round_ctr, **kw)
    bad = dataclasses.replace(c.state, log_term=c.state.log_term[:, :4])
    with pytest.raises(ValueError, match="state.log_term"):
        rc.pack(bad, c.fab, c._no_ops, c.mute, samp, m.round_ctr, **kw)
    bad = dataclasses.replace(c.state, pr_match=c.state.pr_match.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        rc.pack(bad, c.fab, c._no_ops, c.mute, samp, m.round_ctr, **kw)
    with pytest.raises(ValueError, match="V <= 8"):
        rc.pack(c.state, c.fab, c._no_ops, c.mute, samp, m.round_ctr, **dict(kw, v=9))


@pytest.mark.parametrize("dim,shape_kw,match", [
    ("v", dict(max_peers=9), "V <= 8"),
    ("w", dict(log_window=128), "w <= 64"),
    ("e", dict(max_msg_entries=9), "e <= 8"),
    ("f", dict(max_inflight=9), "f <= 8"),
    ("r", dict(max_read_index=9), "r <= 8"),
])
def test_pack_refuses_shapes_beyond_the_kernel(dim, shape_kw, match):
    """csrc/round.cu is compiled for one Shape at a time, V, W, E, F and R
    within its static bounds: a Shape beyond them is refused by name before
    any build or launch."""
    v = shape_kw.get("max_peers", V)
    kw = {**dict(max_peers=v, log_window=8, max_msg_entries=2, max_inflight=2,
                 max_read_index=2), **shape_kw}
    c = tfused.FusedCluster(2, v, shape=Shape(n_lanes=2 * v, **kw), device="cpu")
    m = c.metrics
    d = rc.dims_of(c.state, c.fab, v)
    assert d[dim] == {"v": v, "w": kw["log_window"], "e": kw["max_msg_entries"],
                      "f": kw["max_inflight"], "r": kw["max_read_index"]}[dim]
    with pytest.raises(ValueError, match=match):
        rc.pack(c.state, c.fab, c._no_ops, c.mute, (m.samp_index, m.samp_round),
                m.round_ctr, v=v, kc=1, cta=v, apply_ops=True, ops_round0_only=True,
                do_tick=True, auto_propose=False, auto_compact_lag=None)


def test_cta_lanes_fit_shared_memory():
    """The CUDA block is chosen within the card's shared memory for the
    Shape; a block that does not fit is refused by pack."""
    big = dict(v=8, w=64, e=8, f=8, r=8)
    assert rc.smem_bytes(big, 192) > rc.MAX_SMEM
    cta = rc.cta_lanes(8 * 1024, 8, big)
    assert cta % 8 == 0 and rc.smem_bytes(big, cta) <= rc.MAX_SMEM
    assert rc.smem_bytes(big, cta + 8) > rc.MAX_SMEM or (8 * 1024) % (cta + 8)
    bench = dict(v=3, w=16, e=2, f=2, r=2)
    assert rc.cta_lanes(3072, 3, bench) == rc.cta_lanes(3072, 3) == rc.CTA_TARGET
    c = tfused.FusedCluster(8, 8, shape=Shape(n_lanes=64, max_peers=8, log_window=64,
                                              max_msg_entries=8, max_inflight=8,
                                              max_read_index=8), device="cpu")
    m = c.metrics
    with pytest.raises(ValueError, match="shared memory"):
        rc.pack(c.state, c.fab, c._no_ops, c.mute, (m.samp_index, m.samp_round),
                m.round_ctr, v=8, kc=1, cta=64, apply_ops=True, ops_round0_only=True,
                do_tick=True, auto_propose=False, auto_compact_lag=None)


@pytest.mark.parametrize("v", range(1, rc.MAX_V + 1))
def test_library_target_is_the_shape_and_stride(v):
    """One library per Shape and block stride: the target's -D macros are
    V, W, E, F, R and the block rounded up to whole warps, and its key
    names exactly those."""
    d = dict(v=v, w=16, e=2, f=2, r=2)
    keys = {}
    for cta in range(v, rc.MAX_CTA + 1, v):
        s = rc.stride(cta)
        assert s % 32 == 0 and cta <= s < cta + 32 and rc.stride(s) == s
        t = rc.target(d, cta)
        assert t.source == "round"
        assert t.defines == (("RAFT_V", v), ("RAFT_W", 16), ("RAFT_E", 2), ("RAFT_F", 2),
                             ("RAFT_R", 2), ("RAFT_S", s))
        assert t.flags == tuple(f"-D{k}={x}" for k, x in t.defines)
        keys.setdefault(t.key, set()).add(s)
    assert all(len(strides) == 1 for strides in keys.values())
    for k in "wefr":
        assert rc.target({**d, k: d[k] * 2}, v).key != rc.target(d, v).key


@pytest.mark.parametrize("v", range(1, rc.MAX_V + 1))
def test_check_shape_names_the_dimension(v):
    """check_shape takes every Shape within the kernel's static bounds
    whose W is a power of two, and refuses any other by the dimension's
    name."""
    base = dict(v=v, w=8, e=2, f=2, r=2)
    for w in (1, 2, 8, 16, rc.CAPS["w"]):
        rc.check_shape(dict(base, w=w))
    rc.check_shape(dict(base, **{k: rc.CAPS[k] for k in "efr"}))
    with pytest.raises(ValueError, match="power-of-two w, got w=12"):
        rc.check_shape(dict(base, w=12))
    for k, cap in rc.CAPS.items():
        for bad in (0, 2 * cap):
            with pytest.raises(ValueError, match=f"1 <= {k} <= {cap}, got {k}={bad}"):
                rc.check_shape(dict(base, **{k: bad}))
    for bad in (0, rc.MAX_V + 1):
        with pytest.raises(ValueError, match=f"V <= {rc.MAX_V}, got V={bad}"):
            rc.check_shape(dict(base, v=bad))


@pytest.mark.parametrize("v", range(1, rc.MAX_V + 1))
def test_smem_bytes_follows_the_stride(v):
    """A block's shared memory is a multiple of 16 bytes, depends on the
    block only through its stride, never shrinks as the block grows, and
    grows with each of W, E, F and R."""
    d = dict(v=v, w=16, e=2, f=2, r=2)
    prev = 0
    for cta in range(v, rc.MAX_CTA + 1, v):
        b = rc.smem_bytes(d, cta)
        assert b % 16 == 0 and b >= prev and b == rc.smem_bytes(d, rc.stride(cta)), cta
        prev = b
    for k in "wefr":
        assert rc.smem_bytes({**d, k: 2 * d[k]}, 32) > rc.smem_bytes(d, 32), k


@pytest.mark.parametrize("v", range(1, rc.MAX_V + 1))
def test_cta_lanes_is_the_largest_block_within_target(v):
    """For tiles of whole groups: the block is the largest multiple of v
    that divides the tile at or below the target (else the smallest), at
    most kMaxCta, and, given the largest Shape, one that fits the card's
    shared memory where any does."""
    big = dict(v=v, w=rc.CAPS["w"], e=rc.CAPS["e"], f=rc.CAPS["f"], r=rc.CAPS["r"])
    for groups in (1, 2, 5, 12, 64, 1021, 1024):
        tile = groups * v
        cands = [c for c in range(v, min(tile, rc.MAX_CTA) + 1, v) if tile % c == 0]
        for aim in (v, 32, rc.CTA_TARGET, rc.MAX_CTA):
            below = [c for c in cands if c <= aim]
            want = max(below) if below else min(cands)
            assert rc.cta_lanes(tile, v, target=aim) == want, (tile, aim)
        fit = [c for c in cands if rc.smem_bytes(big, c) <= rc.MAX_SMEM]
        cta = rc.cta_lanes(tile, v, big)
        assert cta in (fit or cands) and cta <= rc.MAX_CTA, tile


@pytest.fixture(scope="module")
def pack_args():
    c = tfused.FusedCluster(G, V, shape=_shape(), device="cpu")
    m = c.metrics
    kw = dict(v=V, kc=2, cta=TILE, apply_ops=True, ops_round0_only=True, do_tick=True,
              auto_propose=True, auto_compact_lag=4)
    return c.state, c.fab, c._no_ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr, kw


def _with_leaf(args, group, name, x):
    """pack's arguments with one leaf of the csrc/round.cu tables replaced."""
    st, fab, ops = args[:3]
    if group == "STATE":
        st = dataclasses.replace(st, **{name: x})
    elif group == "CFG":
        st = dataclasses.replace(st, cfg=dataclasses.replace(st.cfg, **{name: x}))
    elif group == "FABRIC":
        leaves = rc._fab_leaves(fab)
        leaves[rc.dataclass_names()["FABRIC"].index(name)] = x
        fab = rc._fab_from_leaves(fab, leaves)
    else:
        ops = ops._replace(**{name: x})
    return (st, fab, ops) + tuple(args[3:6])


def _leaf(args, group, name):
    st, fab, ops = args[:3]
    return {
        "STATE": lambda: getattr(st, name), "CFG": lambda: getattr(st.cfg, name),
        "FABRIC": lambda: rc._fab_leaves(fab)[rc.dataclass_names()["FABRIC"].index(name)],
        "OPS": lambda: getattr(ops, name),
    }[group]()


@pytest.mark.parametrize(
    "group,name", [(g, name) for g, rows in rc.layout().items() for name, _, _ in rows]
)
def test_pack_refuses_each_bad_leaf(pack_args, group, name):
    """The kernel reads every leaf through a raw pointer: a leaf of another
    dtype, another shape, a strided layout or a start off 16-byte alignment
    is refused by name before any launch, for each leaf of csrc/round.cu's
    tables."""
    *args, kw = pack_args
    x = _leaf(args, group, name)
    what = f"{group.lower()}.{name}"
    rc.pack(*args, **kw)
    other = torch.int64 if x.dtype == torch.int32 else torch.int32
    with pytest.raises(TypeError, match=f"{what} must be"):
        rc.pack(*_with_leaf(args, group, name, x.to(other)), **kw)
    with pytest.raises(ValueError, match=f"{what} must have shape"):
        rc.pack(*_with_leaf(args, group, name, x.unsqueeze(-1)), **kw)
    if x.dim() > 1:
        strided = x.transpose(0, 1).contiguous().transpose(0, 1)
        with pytest.raises(ValueError, match=f"{what} must be contiguous"):
            rc.pack(*_with_leaf(args, group, name, strided), **kw)
    shifted = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    with pytest.raises(ValueError, match=f"{what} must start 16-byte aligned"):
        rc.pack(*_with_leaf(args, group, name, shifted), **kw)


@pytest.mark.parametrize("cta,kc,match", [
    (4, 1, "bad lane layout"),  # not whole groups
    (9, 1, "bad lane layout"),  # does not divide the lanes
    (0, 1, "bad lane layout"),
    (TILE, 0, "kc must be >= 1"),
])
def test_pack_refuses_bad_launch_geometry(pack_args, cta, kc, match):
    """Blocks must hold whole groups and divide the lanes, and a launch
    runs at least one round: refused before any leaf is read."""
    *args, kw = pack_args
    with pytest.raises(ValueError, match=match):
        rc.pack(*args, **dict(kw, cta=cta, kc=kc))
