"""The reference's quorum tables on the port: the hand cases and the 50k
dumb-oracle checks of tests/test_quorum.py (committed :46-66 and :164-182,
joint :199-215), and the quorum/testdata scripts majority_commit.txt and
joint_commit.txt that tests/test_quorum_datadriven.py replays. Each runs
through raft_tpu_torch.ops.quorum's plain majority_committed /
joint_committed_plain and through the host build of csrc/quorum.cu's quad
code (tests/test_torch_quorum_host.py), V <= 8. Exact equality. The
scripts' `committed` directives are replayed here, by replay_committed;
random directives hold that replay against tests/test_quorum_datadriven.py's
run_directive over raft_tpu, so it is checked where the testdata is absent.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import quorum as tq
from tests import test_quorum_datadriven as dd
from tests.test_torch_quorum_host import committed_host, host_library, joint_host

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

INF = tq.COMMITTED_INF
BACKENDS = ["plain", "host"]


@pytest.fixture(scope="module")
def impl(tmp_path_factory):
    """backend -> (committed(match, mask), joint(match, mask_in, mask_out))
    over [K, V] numpy rows, returning numpy [K]."""
    lib = {}

    def get(backend):
        if backend == "plain":
            fns = (tq.majority_committed, tq.joint_committed_plain)
        else:
            lib.setdefault("lib", host_library(tmp_path_factory))
            fns = (lambda m, k: committed_host(lib["lib"], m, k),
                   lambda m, a, b: joint_host(lib["lib"], m, a, b))

        def wrap(fn):
            return lambda *xs: fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)).numpy()

        return wrap(fns[0]), wrap(fns[1])

    return get


def dumb_committed(match, mask):
    """Row by row, the largest k among the voters' acked indexes and 0 that
    a quorum of voters has acked (0 if none; INF for an empty config):
    tests/test_quorum.py dumb_committed (reference quorum/quick_test.go:85),
    in numpy."""
    n = mask.sum(axis=1)
    q = n // 2 + 1
    cand = np.concatenate([match, np.zeros((len(match), 1), match.dtype)], axis=1)
    valid = np.concatenate([mask, np.ones((len(mask), 1), bool)], axis=1)
    acks = ((match[:, None, :] >= cand[:, :, None]) & mask[:, None, :]).sum(axis=2)
    ok = valid & (acks >= q[:, None])
    best = np.where(ok, cand, 0).max(axis=1)
    return np.where(n == 0, INF, best)


# tests/test_quorum.py:46-66
HAND = [
    ([5, 0, 0, 0], [1, 0, 0, 0], 5),  # single voter: its own match
    ([2, 4, 9, 0], [1, 1, 1, 0], 4),  # 3 voters: median
    ([0, 4, 9, 0], [1, 1, 1, 0], 4),  # 3 voters, one never acked
    ([1, 2, 3, 4], [1, 1, 1, 1], 2),  # 4 voters, q = 3: 3rd largest
    ([0, 0, 0, 0], [0, 0, 0, 0], INF),  # empty config: the identity
]


@pytest.mark.parametrize("match,mask,want", HAND)
@pytest.mark.parametrize("backend", BACKENDS)
def test_committed_hand_cases(impl, backend, match, mask, want):
    committed, _ = impl(backend)
    got = committed(np.asarray([match], np.int32), np.asarray([mask], bool))
    assert got.tolist() == [want]


def _shuffled_masks(rng, k, v):
    n = rng.integers(0, v + 1, size=k)
    mask = np.arange(v)[None, :] < n[:, None]
    perm = rng.permuted(np.tile(np.arange(v), (k, 1)), axis=1)
    return np.take_along_axis(mask, perm, axis=1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_committed_matches_dumb_oracle_50k(impl, backend):
    """tests/test_quorum.py:164-182: 50k rows, 0..8 voters shuffled over
    V = 8 slots, acked indexes below 2^18."""
    committed, _ = impl(backend)
    rng = np.random.default_rng(42)
    k, v = 50_000, 8
    mask = _shuffled_masks(rng, k, v)
    match = rng.integers(0, 1 << 18, size=(k, v)).astype(np.int32)
    np.testing.assert_array_equal(committed(match, mask), dumb_committed(match, mask))


@pytest.mark.parametrize("backend", BACKENDS)
def test_joint_committed_matches_min_50k(impl, backend):
    """tests/test_quorum.py:199-215: the joint index is the min of the two
    halves' dumb-oracle indexes."""
    _, joint = impl(backend)
    rng = np.random.default_rng(44)
    k, v = 50_000, 8
    mask_in = rng.integers(0, 2, size=(k, v)).astype(bool)
    mask_out = rng.integers(0, 2, size=(k, v)).astype(bool)
    match = rng.integers(0, 1 << 18, size=(k, v)).astype(np.int32)
    want = np.minimum(dumb_committed(match, mask_in), dumb_committed(match, mask_out))
    np.testing.assert_array_equal(joint(match, mask_in, mask_out), want)


def _row(acked: dict, ids: set, idsj: set, v: int):
    """One [1, V] row of acked indexes and the two halves' masks, voters in
    ascending id order (tests/test_quorum_datadriven.py's slot layout)."""
    match = np.zeros((1, v), np.int32)
    m1 = np.zeros((1, v), bool)
    m2 = np.zeros((1, v), bool)
    for slot, nid in enumerate(sorted(ids | idsj)):
        match[0, slot] = acked.get(nid, 0)
        m1[0, slot] = nid in ids
        m2[0, slot] = nid in idsj
    return match, m1, m2


def replay_committed(d, committed, joint, v: int) -> str:
    """The output of a `committed` directive of the reference's quorum
    scripts (quorum/datadriven_test.go), cross-checks included, with the
    commit index from committed(match, mask) / joint(match, m1, m2) over
    [1, V] rows. Bar chart and dumb oracle: tests/test_quorum_datadriven.py
    describe / alternative_committed."""
    if d.cmd != "committed":
        raise ValueError(f"{d.pos}: not a committed directive: {d.cmd}")
    ids, idsj, idxs, is_joint = [], [], [], False
    for a in d.cmd_args:
        for val in a.vals:
            if a.key == "cfg":
                ids.append(int(val))
            elif a.key == "cfgj":
                is_joint = True
                if val != "zero":
                    idsj.append(int(val))
            elif a.key == "idx":
                idxs.append(0 if val == "_" else int(val))
    acked = {}
    for nid in ids + idsj:  # the script's indexes in voter order, 0 = none
        if nid not in acked and len(acked) < len(idxs):
            acked[nid] = idxs[len(acked)]
    acked = {k: x for k, x in acked.items() if x != 0}
    c, cj = set(ids), set(idsj)

    def maj(l, cfg):
        match, m1, _ = _row(l, cfg, set(), v)
        return int(committed(match, m1)[0])

    def jnt(l, a, b):
        return int(joint(*_row(l, a, b, v))[0])

    s = dd.idx_str
    if is_joint:
        idx = jnt(acked, c, cj)
        buf = [dd.describe(acked, c | cj)]
        if (a := jnt(acked, cj, c)) != idx:
            buf.append(f"{s(a)} <-- via symmetry\n")
        return "".join(buf) + f"{s(idx)}\n"
    idx = maj(acked, c)
    buf = [dd.describe(acked, c)]
    if (a := dd.alternative_committed(acked, c)) != idx:
        buf.append(f"{s(a)} <-- via alternative computation\n")
    if (a := jnt(acked, c, set())) != idx:
        buf.append(f"{s(a)} <-- via zero-joint quorum\n")
    if (a := jnt(acked, c, c)) != idx:
        buf.append(f"{s(a)} <-- via self-joint quorum\n")
    for nid in c:
        own = acked.get(nid, 0)
        if idx > own > 0:
            for lowered, label in ((own - 1, own), (0, 0)):
                lo = {k: x for k, x in {**acked, nid: lowered}.items() if x != 0}
                if (a := maj(lo, c)) != idx:
                    buf.append(f"{s(a)} <-- overlaying {nid}->{label}")
    return "".join(buf) + f"{s(idx)}\n"


def _slots(backend: str) -> int:
    """Voter slots a row has: 16 on the plain version (the JAX tests' V),
    8 on the host build (the kernels take V <= 8; the scripts name at most
    6 voters)."""
    return 16 if backend == "plain" else 8


@pytest.mark.parametrize("fname", ["majority_commit.txt", "joint_commit.txt"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_quorum_datadriven(impl, backend, fname):
    """The reference's scripts over the port, byte for byte."""
    if not os.path.isdir(dd.REF_TESTDATA):
        pytest.skip("reference testdata not mounted")
    from raft_tpu.testing.datadriven import parse_file

    fns = impl(backend)
    failures = [
        f"{d.pos}: {d.cmd}\nwant:\n{d.expected}\ngot:\n{got}"
        for d in parse_file(os.path.join(dd.REF_TESTDATA, fname))
        if (got := replay_committed(d, *fns, _slots(backend))) != d.expected
    ]
    assert not failures, f"{len(failures)} diverged:\n\n" + "\n\n".join(failures)


def _random_directives(rng, k: int):
    """k `committed` directives in the scripts' syntax: 0-6 voters from ids
    1..7, a third of them joint (some with cfgj=zero), indexes 0..9 with
    `_` for a voter that never acked, sometimes fewer indexes than voters."""
    from raft_tpu.testing.datadriven import TestData, parse_cmd_line

    out = []
    for i in range(k):
        ids = sorted(rng.choice(np.arange(1, 8), size=rng.integers(0, 7), replace=False))
        line = "committed cfg=(" + ",".join(map(str, ids)) + ")"
        voters = list(ids)
        if rng.random() < 0.35:
            if rng.random() < 0.2:
                line += " cfgj=zero"
            else:
                jd = sorted(rng.choice(np.arange(1, 8), size=rng.integers(1, 6), replace=False))
                line += " cfgj=(" + ",".join(map(str, jd)) + ")"
                voters += [x for x in jd if x not in voters]
        n_idx = max(0, len(voters) - int(rng.integers(0, 2)))
        idx = ["_" if rng.random() < 0.2 else str(rng.integers(1, 10)) for _ in range(n_idx)]
        line += " idx=(" + ",".join(idx) + ")"
        cmd, args = parse_cmd_line(line)
        out.append(TestData(f"random:{i}", cmd, args, "", ""))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_replay_equals_jax_replay(impl, backend):
    """replay_committed over the port writes, for random directives, what
    tests/test_quorum_datadriven.py's run_directive writes over raft_tpu:
    the replay above is held here where the reference testdata is absent."""
    fns = impl(backend)
    for d in _random_directives(np.random.default_rng(4242), 60):
        assert replay_committed(d, *fns, _slots(backend)) == dd.run_directive(d), d.pos
