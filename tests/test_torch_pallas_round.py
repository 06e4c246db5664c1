"""The port's pallas engine against the JAX package, leaf for leaf.

`raft_tpu_torch.ops.pallas_round.pallas_rounds` on the CPU (its launches
go through the kernel's plain version, `round_kernel_ref`) at K in {1, 3}
walks the same trajectory as JAX `fused_rounds`, which the JAX package's own
tests hold bit-identical to its `pallas_rounds`: 7 rounds of G=4 groups x
V=3 voters, tiles of 6 lanes, metrics on, a muted lane and injected
hup / propose / ReadIndex / transfer ops, with the default LaneConfig and
with PreVote + CheckQuorum. Integer state: tolerance 0, and a
differing leaf is named by `assert_same_leaves`.

JAX `pallas_rounds` in interpret mode is not run here: 4 rounds of it take
about 50 s on one CPU worker, over this file's budget.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.config import Shape as JShape
from raft_tpu.ops import fused as jfused
from raft_tpu_torch import interop
from raft_tpu_torch.metrics import device as tmet
from raft_tpu_torch.ops import fused as tfused
from raft_tpu_torch.ops import pallas_round as tplr
from raft_tpu_torch.state import RaftState
from tests.test_torch_state import assert_same_leaves, jax_leaves, release_memory  # noqa: F401

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

V = 3
G = 4
N = G * V
ROUNDS = 7
TILE = 2 * V
RUN = dict(do_tick=True, auto_propose=True, auto_compact_lag=4, ops_first_round_only=True)
SHAPE = dict(max_peers=V, log_window=8, max_msg_entries=2, max_inflight=2, max_read_index=2)
OPS = dict(
    hup={0: True, 7: True}, prop_n={1: 2, 5: 1, 9: 2}, prop_bytes=5,
    read_ctx={i: 100 + i for i in range(N)}, transfer_to={3: 2, 10: 3},
)


CFGS = {"default": {}, "prevote-checkquorum": dict(pre_vote=True, check_quorum=True)}


@pytest.fixture(scope="module", params=list(CFGS))
def jax_run(request):
    """One JAX cluster, warmed 14 rounds, then a muted lane; its carry before
    and after ROUNDS rounds of JAX fused_rounds with the ops. Every JAX call
    shares one compiled program (same static arguments, no donation)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_METRICS", "1")
        jc = jfused.FusedCluster(
            G, V, seed=13, shape=JShape(n_lanes=N, **SHAPE), **CFGS[request.param]
        )

        def rounds(ops):
            return jfused._fused_rounds_nodonate_jit(
                jc.state, jc.fab, ops, jc.mute, v=V, n_rounds=ROUNDS, straddle=None,
                metrics=jc.metrics, chaos=None, **RUN,
            )

        for _ in range(2):
            jc.state, jc.fab, jc.metrics = rounds(jc._no_ops)
        jc.set_mute([4])
        jops = jc.ops(**OPS)
        before = [jax_leaves(x) for x in (jc.state, jc.fab, jc.metrics, jc.mute)]
        after = rounds(jops)
    return before, jax_leaves(jops), after, CFGS[request.param]


def _port_carry(before, ops_leaves):
    """The port's objects built from the JAX leaves."""
    return (
        interop.from_numpy_tree(RaftState, before[0], "cpu"),
        interop.from_numpy_tree(tfused.Fabric, before[1], "cpu"),
        interop.from_numpy_tree(tfused.LocalOps, ops_leaves, "cpu"),
        torch.from_numpy(np.array(before[3][0])),
        interop.from_numpy_tree(tmet.MetricsState, before[2], "cpu"),
    )


@pytest.mark.parametrize("k", [1, 3])
def test_pallas_rounds_equal_jax_fused_rounds(jax_run, k):
    before, ops_leaves, after, cfg = jax_run
    st, fb, ops, mute, mt = _port_carry(before, ops_leaves)
    assert bool(st.cfg.pre_vote[0]) == cfg.get("pre_vote", False)
    assert mute.tolist() == [i == 4 for i in range(N)]
    got = tplr.pallas_rounds(
        st, fb, ops, mute, v=V, tile_lanes=TILE, n_rounds=ROUNDS, rounds_per_call=k,
        metrics=mt, **RUN,
    )
    assert_same_leaves(after[0], got[0], f"K={k}: state")
    assert_same_leaves(after[1], got[1], f"K={k}: fabric")
    assert_same_leaves(after[2], got[2], f"K={k}: metrics")
    # not trivial: the rounds elected, committed and proposed
    delta = got[2].counters - mt.counters
    for name in ("elections_started", "commits", "proposals"):
        assert int(delta[tmet.COUNTER_INDEX[name]]) > 0, name
