"""The port's fused round against the JAX package, leaf for leaf.

Both packages start from one carry (raft_tpu_torch.interop) on the
tests/test_pallas_round.py configuration — G=4 groups x V=3 voters, W=8,
E=2, metrics on, auto_propose, compaction lag 4 — and run 33 rounds; every
state, fabric and metrics leaf must be equal (integer state, tolerance 0),
and a mismatch is reported by column name. The JAX side compiles once for
the whole file: every JAX run goes through FusedCluster.run with the same
static arguments and carry donation off.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_tpu.config import Shape as JShape
from raft_tpu.ops import fused as jfused
from raft_tpu.ops import log as jlog
from raft_tpu.metrics import device as jmet
from raft_tpu.scheduler import BlockedFusedCluster as JBlocked
from raft_tpu.state import fat_state as jfat
from raft_tpu_torch import interop
from raft_tpu_torch.config import Shape
from raft_tpu_torch.metrics import device as tmet
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import log as tlog
from raft_tpu_torch.scheduler import BlockedFusedCluster
from raft_tpu_torch.state import RaftState, fat_state
from tests.test_torch_state import assert_same_leaves, jax_leaves, release_memory  # noqa: F401

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

V = 3
G = 4
N = G * V
ROUNDS = 33
RUN = dict(auto_propose=True, auto_compact_lag=4)
SHAPE = dict(max_peers=V, log_window=8, max_msg_entries=2, max_inflight=2, max_read_index=2)


@pytest.fixture(scope="module", autouse=True)
def _copying_jax_dispatch():
    """JAX clusters dispatch the copying twin, so every JAX run of this file
    shares one compiled program."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_DONATE", "0")
        mp.setenv("RAFT_TPU_METRICS", "1")
        yield


def _clusters(seed: int, n_groups: int = G):
    jc = jfused.FusedCluster(n_groups, V, seed=seed, shape=JShape(n_lanes=n_groups * V, **SHAPE))
    tc = tfused.FusedCluster(
        n_groups, V, seed=seed, shape=Shape(n_lanes=n_groups * V, **SHAPE), device="cpu"
    )
    return jc, tc


def _assert_clusters_equal(jc, tc, what: str):
    assert_same_leaves(jc.state, tc.state, f"{what}: state")
    assert_same_leaves(jc.fab, tc.fab, f"{what}: fabric")
    assert_same_leaves(jc.metrics, tc.metrics, f"{what}: metrics")


@pytest.mark.parametrize("seed", [7, 11])
def test_fused_rounds_leaf_for_leaf(seed):
    jc, tc = _clusters(seed)
    _assert_clusters_equal(jc, tc, "construction")
    # fused_rounds from one carry: the JAX leaves build the port's objects
    st = interop.from_numpy_tree(RaftState, jax_leaves(jc.state), "cpu")
    fb = interop.from_numpy_tree(tfused.Fabric, jax_leaves(jc.fab), "cpu")
    mt = interop.from_numpy_tree(tmet.MetricsState, jax_leaves(jc.metrics), "cpu")
    got = tfused.fused_rounds(
        st, fb, tc._no_ops, tc.mute, v=V, n_rounds=ROUNDS, metrics=mt, **RUN
    )
    jc.run(ROUNDS, **RUN)
    assert_same_leaves(jc.state, got[0], "state")
    assert_same_leaves(jc.fab, got[1], "fabric")
    assert_same_leaves(jc.metrics, got[2], "metrics")
    # the run is not trivial: every group elected and committed
    assert len(jc.leader_lanes()) == G
    assert int(np.asarray(jc.state.committed).min()) > 0


def test_muted_lane_and_local_ops():
    """A muted follower (snapshot catch-up after the mute lifts) and a
    make_local_ops campaign/propose injection, through FusedCluster.run."""
    jc, tc = _clusters(3)
    jc.run(ROUNDS, **RUN)
    tc.run(ROUNDS, **RUN)
    jc.set_mute([4])
    tc.set_mute([4])
    ops = dict(hup={0: True, 7: True}, prop_n={1: 2, 5: 1, 9: 2}, prop_bytes=5,
               read_ctx={i: 100 + i for i in range(N)})
    jc.run(ROUNDS, ops=jc.ops(**ops), **RUN)
    tc.run(ROUNDS, ops=tc.ops(**ops), **RUN)
    _assert_clusters_equal(jc, tc, "muted + ops")
    jc.set_mute([4], on=False)
    tc.set_mute([4], on=False)
    jc.run(ROUNDS, **RUN)
    tc.run(ROUNDS, **RUN)
    _assert_clusters_equal(jc, tc, "after unmute")
    assert jc.metrics_snapshot()["counters"] == tc.metrics_snapshot()["counters"]
    tc.check_no_errors()


@pytest.mark.parametrize(
    "cfg",
    [
        dict(pre_vote=True),
        dict(pre_vote=True, check_quorum=True),
        dict(check_quorum=True, election_tick=[4, 5, 6] * G, max_size_per_msg=3),
    ],
    ids=["prevote", "prevote-checkquorum", "checkquorum-mixed-ticks"],
)
def test_scenarios_match_jax(cfg):
    """PreVote / CheckQuorum elections, a partitioned leader, leadership
    transfer, forget-leader, ReadIndex and conf-change proposals, each phase
    33 rounds, both packages stepped from one construction."""
    jc = jfused.FusedCluster(G, V, seed=21, shape=JShape(n_lanes=N, **SHAPE), **cfg)
    tc = tfused.FusedCluster(
        G, V, seed=21, shape=Shape(n_lanes=N, **SHAPE), device="cpu", **cfg
    )
    phases = [
        ([], {}),
        ([0, 3, 6, 9], dict(prop_n={1: 2, 4: 2}, prop_bytes=2)),  # member 0 cut off
        ([], dict(transfer_to={i: i % V + 1 for i in range(N)}, beat={1: True},
                  forget={2: True, 5: True}, read_ctx={i: 7 + i for i in range(N)})),
        ([], dict(prop_cc={i: 1 for i in range(N)}, hup={4: True})),
    ]
    for k, (muted, ops) in enumerate(phases):
        for c in (jc, tc):
            c.set_mute(range(N), on=False)
            if muted:
                c.set_mute(muted)
            c.run(ROUNDS, ops=c.ops(**ops) if ops else None, **RUN)
        _assert_clusters_equal(jc, tc, f"phase {k}")
    assert len(tc.leader_lanes()) >= 1


def test_blocked_cluster_matches_jax():
    """8 groups as 2 blocks; the port sweeps round-major in chunks of 8,
    the JAX side in one chunk — trajectories are chunking-independent."""
    jb = JBlocked(8, V, block_groups=4, seed=5, shape=JShape(n_lanes=N, **SHAPE),
                  round_chunk=ROUNDS)
    tb = BlockedFusedCluster(8, V, block_groups=4, seed=5, shape=Shape(n_lanes=N, **SHAPE),
                             round_chunk=8, device="cpu")
    jb.run(ROUNDS, **RUN)
    tb.run(ROUNDS, **RUN)
    assert tb.leader_count() == jb.leader_count() == 8
    assert tb.total_committed() == jb.total_committed() > 0
    for i, (j, t) in enumerate(zip(jb.blocks, tb.blocks)):
        _assert_clusters_equal(j, t, f"block {i}")
    assert tb.metrics_snapshot() == {
        k: v for k, v in jb.metrics_snapshot().items() if k in ("counters", "hist", "rounds")
    }
    tb.check_no_errors()


def test_rebase_and_sampler_shift_match_jax():
    jc, _ = _clusters(7)
    jc.run(ROUNDS, **RUN)
    js = jax.jit(jfat)(jc.state)
    ts = fat_state(interop.from_numpy_tree(RaftState, jax_leaves(js), "cpu"))
    mask = np.arange(N) % 2 == 0
    delta = np.where(np.arange(N) < 6, 8, 5).astype(np.int32)  # 5: not a multiple of W
    assert_same_leaves(
        jax.jit(jlog.rebase_indexes)(js, mask, delta),
        tlog.rebase_indexes(ts, torch.from_numpy(mask), torch.from_numpy(delta)),
        "rebase_indexes",
    )
    tm = interop.from_numpy_tree(tmet.MetricsState, jax_leaves(jc.metrics), "cpu")
    assert_same_leaves(
        jax.jit(jmet.rebase_samples)(jc.metrics, mask, delta),
        tmet.rebase_samples(tm, torch.from_numpy(mask), torch.from_numpy(delta)),
        "rebase_samples",
    )


def test_campaign_and_error_surface():
    _, tc = _clusters(1)
    tc.campaign(0)
    cols = tc.state_columns("state", "term", "vote")
    assert cols["state"][0] == 1 and cols["term"][0] == 1 and cols["vote"][0] == 1
    tc.check_no_errors()
    tc.state = dataclasses.replace(
        tc.state, error_bits=torch.tensor([0] * 5 + [8] + [0] * (N - 6), dtype=torch.int32)
    )
    with pytest.raises(AssertionError, match=r"lanes \[5\]"):
        tc.check_no_errors()
