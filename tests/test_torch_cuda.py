"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions, and the fused round on the card against the CPU.

Every test here is marked `cuda` and skips without a card. The file
imports neither JAX nor `raft_tpu`, so it runs on a machine that has only
PyTorch; there, without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -q tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.config import Shape
from raft_tpu_torch.ops import quorum as tq
from raft_tpu_torch.ops import quorum_cuda as tqc
from raft_tpu_torch.ops.fused import FusedCluster

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(v: int, n: int, dev):
    """Acked indexes with ties, ~5% empty incoming configs, joint configs on
    ~30% of the lanes."""
    rng = np.random.default_rng(1000 + v)
    match = rng.integers(0, 16, size=(n, v), dtype=np.int32)
    mask_in = rng.random((n, v)) < 0.7
    mask_in[rng.random(n) < 0.05] = False
    mask_out = (rng.random((n, v)) < 0.6) & (rng.random(n) < 0.3)[:, None]
    return [torch.from_numpy(x).to(dev) for x in (match, mask_in, mask_out)]


@pytest.mark.parametrize("v", [1, 3, 5, 7, 8])
def test_cuda_kernels_equal_plain(card, v):
    match, mask_in, mask_out = _inputs(v, 196_608 + 7, card)
    n = match.shape[0]
    before = {k: q.launches for k, q in tqc.KERNELS.items()}
    assert torch.equal(tqc.committed(match, mask_in), tq.majority_committed(match, mask_in))
    want = tq.joint_committed_plain(match, mask_in, mask_out)
    assert torch.equal(tqc.joint_committed(match, mask_in, mask_out), want)
    vm = [tqc.pack_voter_major(x) for x in (match, mask_in, mask_out)]
    assert torch.equal(tqc.joint_committed_packed(*vm, v=v, n=n), want)
    torch.cuda.synchronize()
    assert all(q.launches == before[k] + 1 for k, q in tqc.KERNELS.items())


def test_cuda_wrapper_rejects_wide_groups(card):
    match, mask_in, mask_out = _inputs(8, 64, card)
    wide = torch.cat([match, match[:, :1]], dim=1)
    wide_mask = torch.cat([mask_in, mask_in[:, :1]], dim=1)
    with pytest.raises(ValueError, match="V <= 8"):
        tqc.joint_committed(wide, wide_mask, wide_mask)


def test_round_on_card_matches_cpu(card):
    """Default device is the card; 24 rounds of 16 groups land on the same
    sha256 over every state, fabric and metrics leaf as the CPU run, and
    the commit index went through the joint kernel once per round."""
    shape = Shape(n_lanes=48, max_peers=3, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)
    digests = {}
    for dev in (None, "cpu"):
        c = FusedCluster(16, 3, seed=9, shape=shape, device=dev)
        before = tqc.KERNELS["joint_kernel"].launches
        c.run(24, auto_propose=True, auto_compact_lag=4)
        launched = tqc.KERNELS["joint_kernel"].launches - before
        assert launched == (24 if dev is None else 0)
        assert c.state.term.device.type == ("cuda" if dev is None else "cpu")
        digests[dev] = interop.digest(
            interop.to_numpy_leaves(c.state)
            + interop.to_numpy_leaves(c.fab)
            + interop.to_numpy_leaves(c.metrics)
        )
    assert digests[None] == digests["cpu"]


@pytest.mark.parametrize("k", [1, 3])
def test_round_kernel_equals_plain(card, k):
    """The round megakernel (csrc/round.cu) against round_kernel_ref on the
    same card inputs: a warmed 32-group cluster with a muted lane and
    injected ops, one launch of k rounds; names the first differing leaf."""
    from raft_tpu_torch.ops import pallas_round as plr
    from raft_tpu_torch.ops import round_cuda as rc

    v, g = 3, 32
    shape = Shape(n_lanes=g * v, max_peers=v, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)
    c = FusedCluster(g, v, seed=4, shape=shape)
    c.run(20, auto_propose=True, auto_compact_lag=4)
    c.set_mute([5])
    ops = c.ops(hup={0: True}, prop_n={1: 2}, prop_bytes=3,
                read_ctx={i: 9 + i for i in range(g * v)}, transfer_to={3: 2})
    m = c.metrics
    args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
    kw = dict(v=v, kc=k, cta=2 * v, do_tick=True, auto_propose=True, auto_compact_lag=4)
    before = rc.KERNELS["round_kernel"].launches
    got = rc.round_call(*args, **kw)
    want = plr.round_kernel_ref(*args, **kw)
    torch.cuda.synchronize()
    assert rc.KERNELS["round_kernel"].launches == before + 1
    names = rc.dataclass_names()
    labels = ["state." + x for x in names["STATE"]] + ["fabric." + x for x in names["FABRIC"]]
    labels += ["samp_index", "samp_round", "partials"]

    def leaves(res):
        st, fb, samp, parts = res
        return (interop.to_numpy_leaves(st)[: len(names["STATE"])]
                + interop.to_numpy_leaves(fb) + [samp[0].cpu().numpy(),
                                                 samp[1].cpu().numpy(), parts.cpu().numpy()])

    for name, a, b in zip(labels, leaves(got), leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"first differing leaf: {name}"


def test_round_kernel_bench_widths_k8(card):
    """The megakernel against round_kernel_ref at the bench shape's widths
    (V=3, W16/E2/F2/R2) and the engine's CUDA block, 8 rounds in one
    launch over 4 blocks of whole groups: the fabric stays in shared memory
    for 7 of the 8 round trips."""
    from raft_tpu_torch.ops import pallas_round as plr
    from raft_tpu_torch.ops import round_cuda as rc

    v, g = 3, 128
    shape = Shape(n_lanes=g * v, max_peers=v, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)
    c = FusedCluster(g, v, seed=8, shape=shape)
    c.run(16, auto_propose=True, auto_compact_lag=4)
    c.set_mute([7, 200])
    ops = c.ops(hup={0: True}, prop_n={4: 2}, prop_bytes=5,
                read_ctx={i: 3 + i for i in range(g * v)})
    m = c.metrics
    args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
    cta = rc.cta_lanes(g * v, v, rc.dims_of(c.state, c.fab, v))
    assert cta == rc.CTA_TARGET and (g * v) // cta == 4
    kw = dict(v=v, kc=8, cta=cta, do_tick=True, auto_propose=True, auto_compact_lag=4)
    got = rc.round_call(*args, **kw)
    want = plr.round_kernel_ref(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], want[:2]):
        for x, y in zip(interop.to_numpy_leaves(a), interop.to_numpy_leaves(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(got[2] + (got[3],), want[2] + (want[3],)):
        assert torch.equal(x, y)


def _diet_cluster(dev, near: bool):
    """A warmed 32-group diet-v2 cluster (V=3, bench widths); with `near`,
    its largest index brought to 65,531, so that the next rounds' appends
    overflow the packed uint16 columns."""
    v, g = 3, 32
    shape = Shape(n_lanes=g * v, max_peers=v, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)
    c = FusedCluster(g, v, seed=4, shape=shape, device=dev, diet=True)
    c.run(20, auto_propose=True, auto_compact_lag=4)
    if near:
        from chip_smoke import approach_u16_top

        approach_u16_top(c)
    return c


@pytest.mark.parametrize("near", [False, True], ids=["in_range", "overflow"])
@pytest.mark.parametrize("k", [1, 3])
def test_diet_round_kernel_equals_plain(card, k, near):
    """The diet build of the megakernel against round_kernel_ref on the same
    packed card carry, two launches of k rounds with proposals each: every
    packed leaf, partials row and sampler equal; on the overflow carry the
    clamped columns and ERR_DIET_OVERFLOW bits too."""
    from raft_tpu_torch.ops import pallas_round as plr
    from raft_tpu_torch.ops import round_cuda as rc
    from raft_tpu_torch.state import ERR_DIET_OVERFLOW, is_packed

    c = _diet_cluster(card, near)
    n = c.state.term.shape[0]
    ops = c.ops(prop_n={i: 2 for i in range(n)}, prop_bytes=3,
                read_ctx={i: 9 + i for i in range(n)})
    kw = dict(v=c.v, kc=k, cta=2 * c.v, do_tick=True, auto_propose=True, auto_compact_lag=4)
    before = {name: q.launches for name, q in rc.KERNELS.items()}
    for _ in range(2):
        m = c.metrics
        args = (c.state, c.fab, ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
        got = rc.round_call(*args, **kw)
        want = plr.round_kernel_ref(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:2], want[:2]):
            for x, y in zip(interop.to_numpy_leaves(a), interop.to_numpy_leaves(b)):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(got[2] + (got[3],), want[2] + (want[3],)):
            assert torch.equal(x, y)
        c.state, c.fab = got[0], got[1]
        c.metrics = plr.fold_partials(m, got[2], got[3], k)
    assert is_packed(c.state)
    assert rc.KERNELS["round_kernel_diet"].launches == before["round_kernel_diet"] + 2
    assert rc.KERNELS["round_kernel"].launches == before["round_kernel"]
    assert bool(((c.state.error_bits & ERR_DIET_OVERFLOW) != 0).any()) == near


def test_diet_pallas_on_card_matches_cpu(card):
    """engine="pallas" with diet=True on the card against the eager engine
    with diet=True on the CPU: 33 rounds of 16 groups at K=3, one sha256
    over every packed state, fabric and metrics leaf."""
    shape = Shape(n_lanes=48, max_peers=3, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)
    digests = {}
    for dev, engine in ((None, dict(engine="pallas", rounds_per_call=3)), ("cpu", {})):
        c = FusedCluster(16, 3, seed=9, shape=shape, device=dev, diet=True, **engine)
        c.run(33, auto_propose=True, auto_compact_lag=4)
        digests[dev] = interop.digest(
            interop.to_numpy_leaves(c.state)
            + interop.to_numpy_leaves(c.fab)
            + interop.to_numpy_leaves(c.metrics)
        )
    assert digests[None] == digests["cpu"]


def test_paged_round_kernel_equals_plain(card):
    """The paged builds (in-kernel paging, slim and diet) against
    round_kernel_ref on the card: K = 1 and 8, a full pool and one that
    exhausts, launches that reallocate and launches that skip the
    allocator; every carry, partials and PagedLog leaf (chip_smoke's
    round_kernel_paged phase)."""
    from chip_smoke import check_round_kernel_paged
    from raft_tpu_torch.ops import round_cuda as rc

    before = {name: q.launches for name, q in rc.KERNELS.items()}
    check_round_kernel_paged(card)
    for name in ("round_kernel_paged", "round_kernel_paged_diet"):
        assert rc.KERNELS[name].launches > before[name]


def test_paged_pallas_on_card_matches_cpu(card):
    """The paged pallas engine on the card against the CPU, in-kernel and at
    the dispatch boundary: one digest over every leaf, PagedLog included,
    and the host_state of the unpaged run (chip_smoke's parity_paged)."""
    from chip_smoke import check_parity_paged

    check_parity_paged()


def test_paged_tile_over_a_cuda_block_raises(card):
    """In-kernel paging on the card runs each lane tile as one CUDA block: a
    258-lane tile raises TileError naming MAX_CTA at construction."""
    from raft_tpu_torch.ops.pallas_round import TileError

    shape = Shape(n_lanes=516, max_peers=3, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2, pool_pages=516 * 3 + 8 + 2)
    with pytest.raises(TileError, match="MAX_CTA=256"):
        FusedCluster(172, 3, shape=shape, engine="pallas", tile_lanes=258, paged=True,
                     paged_inkernel=True)


@pytest.mark.parametrize("diet", [False, True], ids=["slim", "diet"])
def test_round_kernel_chaos_equals_plain(card, diet):
    """The chaos build (-DRAFT_CHAOS=1) against round_kernel_ref(chaos=)
    on the same card inputs, one launch of 4 rounds at V=3: drops and
    duplicates of 0.3 on half the groups, tick skew 0.3, a lane down over
    rounds 1-2 of the launch, an instant restart at round 3 and the heal
    armed at round 2; every carry leaf, probe column and partials row, and
    one launch counted."""
    from raft_tpu_torch.chaos import device as tch
    from raft_tpu_torch.ops import pallas_round as plr
    from raft_tpu_torch.ops import round_cuda as rc

    v, g = 3, 32
    n = g * v
    shape = Shape(n_lanes=n, max_peers=v, log_window=16, max_msg_entries=2,
                  max_inflight=2, max_read_index=2)
    c = FusedCluster(g, v, seed=4, shape=shape, diet=diet, chaos=True)
    c.run(20, auto_propose=True, auto_compact_lag=4)
    r0 = int(c.chaos.round)
    edge = np.where((np.arange(n) < n // 2)[:, None], tch.probability(0.3), 0)
    edge = np.repeat(edge, v, axis=1).astype(np.int32)
    crash = np.full(n, tch.NEVER, np.int32)
    restart = crash.copy()
    crash[1], restart[1] = r0 + 1, r0 + 3
    crash[4], restart[4] = r0 + 3, r0 + 3
    c.set_chaos(drop_num=edge, dup_num=edge, tick_skew_num=np.full(n, tch.probability(0.3)),
                crash_at=crash, restart_at=restart, heal_round=r0 + 2,
                reelect_round=np.full(n, tch.NEVER), recommit_round=np.full(n, tch.NEVER))
    m = c.metrics
    args = (c.state, c.fab, c._no_ops, c.mute, (m.samp_index, m.samp_round), m.round_ctr)
    kw = dict(v=v, kc=4, cta=2 * v, do_tick=True, auto_propose=True, auto_compact_lag=4,
              chaos=c.chaos)
    name = rc.kernel_name(diet, False, True)
    before = rc.KERNELS[name].launches
    got = rc.round_call(*args, **kw)
    want = plr.round_kernel_ref(*args, **kw)
    torch.cuda.synchronize()
    assert rc.KERNELS[name].launches == before + 1
    names = rc.dataclass_names()
    labels = ["state." + x for x in names["STATE"]] + ["fabric." + x for x in names["FABRIC"]]
    labels += ["samp_index", "samp_round", "partials"] + ["chaos." + p for p in tch.PROBES]

    def leaves(res):
        st, fb, samp, parts, probes = res
        return (interop.to_numpy_leaves(st)[: len(names["STATE"])] + interop.to_numpy_leaves(fb)
                + [x.cpu().numpy() for x in (*samp, parts, *probes)])

    for label, a, b in zip(labels, leaves(got), leaves(want), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"first differing leaf: {label}"
