"""The port's quorum math against the JAX package: the plain PyTorch
versions against raft_tpu.ops.quorum and against the Pallas kernels of
raft_tpu.ops.quorum_pallas in interpret mode, at V = 1..8 with empty and
joint configs. All comparisons are exact. The CUDA kernels are held
against the plain versions on a card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from raft_tpu.ops import onehot as joh
from raft_tpu.ops import quorum as jq
from raft_tpu.ops import quorum_pallas as jqp
from raft_tpu_torch.ops import onehot as toh
from raft_tpu_torch.ops import quorum as tq
from raft_tpu_torch.ops import quorum_cuda as tqc

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

N = 1100  # two 1024-lane Pallas tiles, ragged

# one compiled program per reference function and shape, not one per
# primitive: the JAX side of this file stays a few dozen compiles
J = {
    name: jax.jit(getattr(mod, name))
    for mod, names in (
        (jq, ("majority_committed", "joint_committed", "majority_vote",
              "joint_vote", "joint_active")),
        (joh, ("argmax_last", "cumsum_last", "sort_last", "gather", "scatter_set")),
        (jqp, ("pack_voter_major",)),
    )
    for name in names
}
J["gather_range_multi"] = jax.jit(joh.gather_range_multi, static_argnums=2)
J["scatter_range_set_multi"] = jax.jit(joh.scatter_range_set_multi)


def _inputs(v: int, n: int = N, seed: int = 0):
    """Acked indexes with ties; ~5% empty incoming configs; joint configs
    on ~30% of the lanes."""
    rng = np.random.default_rng(seed * 131 + v)
    match = rng.integers(0, 16, size=(n, v), dtype=np.int32)
    mask_in = rng.random((n, v)) < 0.7
    mask_in[rng.random(n) < 0.05] = False
    mask_out = (rng.random((n, v)) < 0.6) & (rng.random(n) < 0.3)[:, None]
    return match, mask_in, mask_out


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("v", range(1, 9))
def test_plain_equals_jnp_reference(v):
    match, mask_in, mask_out = _inputs(v)
    m, a, b = _t(match, mask_in, mask_out)
    want = np.asarray(J["majority_committed"](match, mask_in))
    assert np.array_equal(tq.majority_committed(m, a).numpy(), want)
    assert (want == jq.COMMITTED_INF).any()  # empty configs exercised
    want = np.asarray(J["joint_committed"](match, mask_in, mask_out))
    assert np.array_equal(tq.joint_committed_plain(m, a, b).numpy(), want)
    # the dispatching entry takes the plain version for CPU tensors
    assert np.array_equal(tq.joint_committed(m, a, b).numpy(), want)
    votes = np.random.default_rng(v).integers(0, 3, size=match.shape, dtype=np.int32)
    (vt,) = _t(votes)
    assert np.array_equal(
        tq.majority_vote(vt, a).numpy(), np.asarray(J["majority_vote"](votes, mask_in))
    )
    assert np.array_equal(
        tq.joint_vote(vt, a, b).numpy(), np.asarray(J["joint_vote"](votes, mask_in, mask_out))
    )
    assert np.array_equal(
        tq.joint_active(a, m > 7, b).numpy(),
        np.asarray(J["joint_active"](mask_in, match > 7, mask_out)),
    )


@pytest.mark.parametrize("v", range(1, 9))
def test_wrappers_equal_pallas_kernels_interpret(v):
    """On CPU tensors each wrapper is its plain version; the JAX Pallas
    kernels run in interpret mode, as the JAX package's own tests run them."""
    match, mask_in, mask_out = _inputs(v, seed=1)
    m, a, b = _t(match, mask_in, mask_out)
    want = np.asarray(jqp.committed_pallas(match, mask_in, interpret=True))
    assert np.array_equal(tqc.committed(m, a).numpy(), want)
    want = np.asarray(
        jqp.joint_committed_pallas(match, mask_in, mask_out, interpret=True)
    )
    assert np.array_equal(tqc.joint_committed(m, a, b).numpy(), want)
    jvm = [J["pack_voter_major"](x) for x in (match, mask_in, mask_out)]
    tvm = [tqc.pack_voter_major(x) for x in (m, a, b)]
    for j, t in zip(jvm, tvm):
        assert np.array_equal(np.asarray(j), t.numpy())
    want = np.asarray(jqp.joint_committed_packed(*jvm, v=v, n=N, interpret=True))
    assert np.array_equal(tqc.joint_committed_packed(*tvm, v=v, n=N).numpy(), want)


def test_onehot_primitives_match_jax():
    rng = np.random.default_rng(9)
    x = rng.integers(-3, 3, size=(64, 5), dtype=np.int32)  # many ties
    (xt,) = _t(x)
    assert np.array_equal(toh.argmax_last(xt).numpy(), np.asarray(J["argmax_last"](x)))
    assert np.array_equal(toh.cumsum_last(xt).numpy(), np.asarray(J["cumsum_last"](x)))
    assert np.array_equal(toh.sort_last(xt).numpy(), np.asarray(J["sort_last"](x)))
    col = rng.integers(0, 100, size=(64, 8), dtype=np.int32)
    idx = rng.integers(-2, 10, size=(64, 3), dtype=np.int32)  # out of range reads 0
    ct, it = _t(col, idx)
    assert np.array_equal(toh.gather(ct, it).numpy(), np.asarray(J["gather"](col, idx)))
    start = rng.integers(-20, 20, size=64, dtype=np.int32)
    (st,) = _t(start)
    for j, t in zip(
        J["gather_range_multi"]([col, col * 2], start, 3),
        toh.gather_range_multi([ct, ct * 2], st, 3),
    ):
        assert np.array_equal(np.asarray(j), t.numpy())
    vals = rng.integers(0, 9, size=(64, 2), dtype=np.int32)
    mask = rng.random((64, 2)) < 0.6
    vt, mt = _t(vals, mask)
    for j, t in zip(
        J["scatter_range_set_multi"]([col], start, [vals], mask),
        toh.scatter_range_set_multi([ct], st, [vt], mt),
    ):
        assert np.array_equal(np.asarray(j), t.numpy())
    sidx = np.stack([np.arange(64) % 8, (np.arange(64) + 3) % 8], axis=1).astype(np.int32)
    (sit,) = _t(sidx)
    assert np.array_equal(
        toh.scatter_set(ct, sit, vt, mt).numpy(),
        np.asarray(J["scatter_set"](col, sidx, vals, mask)),
    )


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The card-side checks run before any launch, so they are testable on
    meta tensors without a card."""
    match = torch.zeros((8, 9), dtype=torch.int32, device="meta")
    mask = torch.zeros((8, 9), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="V <= 8"):
        tqc.joint_committed(match, mask, mask)
    match = torch.zeros((8, 3), dtype=torch.int64, device="meta")
    mask = torch.zeros((8, 3), dtype=torch.bool, device="meta")
    with pytest.raises(TypeError, match="int32"):
        tqc.committed(match, mask)
    match = torch.zeros((3, 8), dtype=torch.int32, device="meta").t()
    with pytest.raises(ValueError, match="contiguous"):
        tqc.joint_committed(match, mask, mask)


@pytest.mark.parametrize(
    "wrapper,bad",
    [("committed", "match"), ("committed", "mask"), ("joint_committed", "match"),
     ("joint_committed", "mask_in"), ("joint_committed", "mask_out")],
)
def test_wrapper_refuses_misaligned_operands(wrapper, bad):
    """The quad kernels read match in 16-byte and each mask in 32-bit
    accesses: a view one element off its allocation is refused by name
    before any launch (meta tensors carry the offset in data_ptr)."""
    n, v = 8, 3
    ops = {}
    for name, dtype in (("match", torch.int32), ("mask", torch.bool),
                        ("mask_in", torch.bool), ("mask_out", torch.bool)):
        base = torch.zeros(n * v + 1, dtype=dtype, device="meta")
        ops[name] = (base[1:] if name == bad else base[:-1]).view(n, v)
    args = ("match", "mask") if wrapper == "committed" else ("match", "mask_in", "mask_out")
    before = {k: q.launches for k, q in tqc.KERNELS.items()}
    with pytest.raises(ValueError, match=f"^{bad} must start .*aligned"):
        getattr(tqc, wrapper)(*(ops[a] for a in args))
    assert {k: q.launches for k, q in tqc.KERNELS.items()} == before
