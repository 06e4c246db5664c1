"""The PyTorch port's state layer against the JAX package: init_state,
the slim/fat carry casts, the per-lane LCG, the interop carry and the
package rules (no JAX import, the card by default).

Every comparison is exact: the state is integer, tolerance 0. The port runs
on the CPU here; tests that need a card are marked `cuda` and skip
without one.
"""

from __future__ import annotations

import ast
import ctypes
import ctypes.util
import dataclasses
import gc
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from raft_tpu import state as jst
from raft_tpu.config import Shape as JShape
from raft_tpu_torch import interop
from raft_tpu_torch import state as tst
from raft_tpu_torch.config import Shape, resolve_device
from raft_tpu_torch.ops.fused import PLANES_NOT_PORTED, FusedCluster

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

ROOT = pathlib.Path(__file__).resolve().parent.parent
_LIBC = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")


# resident bytes of a test process above which release_memory clears
RELEASE_ABOVE = 6 << 30


def resident_bytes() -> int:
    """This process's resident memory (Linux /proc; 0 where there is none)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


@pytest.fixture(scope="module", autouse=True)
def release_memory():
    """After a module's tests, in a process holding more than RELEASE_ABOVE
    resident: drop JAX's compiled programs and trace caches, collect, and
    hand the C heap's free pages back to the system (glibc's malloc_trim).
    A test process otherwise keeps every program it compiled, gigabytes
    after a few of the suite's files, while the xdist workers share the
    machine's memory. Below the mark it does nothing: clearing costs
    seconds, and the process's later JAX calls trace again. Autouse in
    every module that imports it."""
    yield
    if resident_bytes() <= RELEASE_ABOVE:
        return
    jax.clear_caches()
    gc.collect()
    if hasattr(_LIBC, "malloc_trim"):
        _LIBC.malloc_trim(0)


def jax_leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_same_leaves(jax_tree, torch_obj, what: str):
    """Leaf for leaf, dtype and value, naming the first column that
    differs (the tests/test_pallas_round.py:54-59 contract)."""
    paths = [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_leaves_with_path(jax_tree)
    ]
    want = jax_leaves(jax_tree)
    got = interop.to_numpy_leaves(torch_obj)
    assert len(want) == len(got), (what, len(want), len(got))
    for path, a, b in zip(paths, want, got):
        assert a.dtype == b.dtype, (what, path, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, path)


def _layout(n_groups: int, v: int):
    n = n_groups * v
    ids = np.tile(np.arange(1, v + 1, dtype=np.int32), n_groups)
    peers = np.broadcast_to(np.arange(1, v + 1, dtype=np.int32), (n, v)).copy()
    learners = np.zeros((n, v), bool)
    learners[:, v - 1] = v > 3  # exercise the learner masks on wide groups
    return ids, peers, learners


@pytest.mark.parametrize("v", [3, 5, 7])
@pytest.mark.parametrize("seed", [1, 7, 42])
def test_init_state_digest_equal(seed, v):
    g = 5
    ids, peers, learners = _layout(g, v)
    jshape = JShape(n_lanes=g * v, max_peers=v, log_window=8, max_inflight=4)
    tshape = Shape(n_lanes=g * v, max_peers=v, log_window=8, max_inflight=4)
    js = jst.init_state(jshape, ids, peers, learners, seed=seed)
    ts = tst.init_state(tshape, ids, peers, learners, seed=seed, device="cpu")
    assert_same_leaves(js, ts, "init_state")
    assert_same_leaves(jst.slim_state(js), tst.slim_state(ts), "slim_state")
    assert_same_leaves(
        jst.fat_state(jst.slim_state(js)),
        tst.fat_state(tst.slim_state(ts)),
        "fat_state",
    )
    assert interop.digest(jax_leaves(js)) == interop.digest(interop.to_numpy_leaves(ts))


def test_interop_round_trip():
    ids, peers, learners = _layout(3, 3)
    js = jst.slim_state(
        jst.init_state(JShape(n_lanes=9, max_peers=3), ids, peers, learners, seed=5)
    )
    ts = interop.from_numpy_tree(tst.RaftState, jax_leaves(js), "cpu")
    assert_same_leaves(js, ts, "from_numpy_tree")
    back = interop.from_numpy_tree(tst.RaftState, interop.to_numpy_leaves(ts), "cpu")
    assert interop.digest(interop.to_numpy_leaves(back)) == interop.digest(jax_leaves(js))
    with pytest.raises(ValueError, match="left over"):
        interop.from_numpy_tree(tst.LaneConfig, jax_leaves(js), "cpu")


def test_lcg_and_timeout_draw_match_jax():
    """The uint32 LCG and the timeout draw, including states with the high
    bit set, where a signed shift would go wrong."""
    rng = np.random.default_rng(3)
    r = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    r[:4] = [0, 1, 2**31, 2**32 - 1]
    et = rng.integers(1, 1 << 14, size=r.shape, dtype=np.int32)
    jr, tr = jax.numpy.asarray(r), torch.from_numpy(r)
    assert np.array_equal(np.asarray(jst.rng_next(jr)), tst.rng_next(tr).numpy())
    assert np.array_equal(
        np.asarray(jst.draw_timeout(jr, jax.numpy.asarray(et))),
        tst.draw_timeout(tr, torch.from_numpy(et)).numpy(),
    )
    assert tst.rng_next(tr).dtype == torch.uint32


def test_lane_config_overrides_and_bounds():
    shape = Shape(n_lanes=6, max_peers=3, max_inflight=4)
    jshape = JShape(n_lanes=6, max_peers=3, max_inflight=4)
    kw = dict(election_tick=[5, 6, 7, 8, 9, 10], pre_vote=True, check_quorum=True)
    assert_same_leaves(
        jst.make_lane_config(jshape, **kw),
        tst.make_lane_config(shape, "cpu", **kw),
        "make_lane_config",
    )
    with pytest.raises(ValueError, match="election_tick"):
        tst.make_lane_config(shape, "cpu", election_tick=0)
    with pytest.raises(ValueError, match="max_inflight"):
        tst.make_lane_config(shape, "cpu", max_inflight=128)
    with pytest.raises(TypeError, match="unknown"):
        tst.make_lane_config(shape, "cpu", no_such_knob=1)


def test_entry_points_default_to_the_card():
    """device=None means cuda; without a card that raises rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedCluster(2, 3)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("plane", PLANES_NOT_PORTED)
def test_unported_planes_raise(plane):
    with pytest.raises(NotImplementedError, match=plane):
        FusedCluster(2, 3, device="cpu", **{plane: True})


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib") or (
        module == "raft_tpu" or module.startswith("raft_tpu.")
    )


def test_port_imports_no_jax_and_nothing_of_raft_tpu():
    files = sorted((ROOT / "raft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in _imports(f)
        if _forbidden(m)
    ]
    assert bad == []
    # the rule itself: the port's own name passes, the reference's does not
    assert not _forbidden("raft_tpu_torch.ops.fused")
    assert _forbidden("raft_tpu.ops.fused") and _forbidden("jax.numpy")


def test_slim_dtypes_and_field_order_match_jax():
    # every field, the lease plane's optional columns after cfg included,
    # with the same defaults
    assert [(f.name, f.default) for f in dataclasses.fields(tst.RaftState)] == [
        (f.name, f.default) for f in dataclasses.fields(jst.RaftState)
    ]
    assert {k: str(v).split(".")[-1] for k, v in tst.STATE_SLIM.items()} == {
        k: np.dtype(v).name for k, v in jst.STATE_SLIM.items()
    }
