"""Several trees' paged round builds, timed in one process on one card.

    python3 ab_chaos_paged.py --parent DIR [--tree NAME=DIR ...] [--before DIR]
                              [--cell chaos_paged|paged ...] [--out FILE]

For each `--cell` (default chaos_paged), slim and diet: drives the cell,
chaos_paged chip_smoke.py's main_pallas_chaos_paged (the chaos scenario at
1,048,576 groups, 128 blocks of 8,192, paging in the kernel at K=8) and
paged its main_pallas_paged in-kernel run (1,048,576 groups as 64 blocks
of 16,384 under benches/paged_ab.py's Zipf traffic, K=8, 3,072-lane
segments), and at block 0's carry after it launches the cell's build
(`round_kernel_chaos_paged` or `round_kernel_paged`, slim, then `_diet`)
of the tree whose csrc directory is `--parent` (e.g. a `git archive` of
the parent commit, unpacked), of each `--tree`, and of this tree
("change"), K=1 and K=8: every launch's outputs against the plain
version, then all timed in turns, parent, the trees, this tree, and back
(CUDA events, `cuda_ms`), twice. Then the stamp twin (-DRAFT_STAMPS=1) of
each `--tree`, of this tree and, with `--before`, of that tree's csrc:
each one's outputs, its time a launch and its phase table with the wave
facts (chip_smoke.stamp_table: late_blocks, max_blocks_an_sm). Each other
tree's library is compiled from its own round.cu and quorum.cuh with this
tree's nvcc flags; its pointer table must be this tree's.

Needs one CUDA card. One JSON line a result; the last line is
{"ok": true, ...}. With --out, every line is also written to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from raft_tpu_torch import build
from raft_tpu_torch.ops import pallas_round as plr
from raft_tpu_torch.ops import round_cuda as rc

_OUT: list[Path] = []  # --out, when given


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    for path in _OUT:
        with path.open("a") as f:
            f.write(line + "\n")


def start_nvcc(csrc: Path, t: build.Target, out: Path) -> subprocess.Popen:
    """nvcc of csrc/round.cu for target t into `out` (this tree's flags)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *t.flags, "-o", str(out), str(csrc / "round.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def entry(path: Path):
    fn = ctypes.CDLL(str(path)).raft_round
    fn.argtypes = rc._ROUND_ARGS
    fn.restype = ctypes.c_int
    return fn


class Lib:
    """A round library loaded by path, callable like a Kernel."""

    def __init__(self, name: str, path: Path):
        self.name = name
        self._fn = entry(path)

    def fn(self, target=None):
        return self._fn


def ab_block(c, libs: dict, stamp_libs: dict, tag: str, chaos: bool) -> None:
    """libs: {tree: Lib} of the timed build, "parent" first and "change"
    last; stamp_libs: {tree: Lib} of the stamp twins; chaos: the cell's
    build is a chaos build (its launches take the cell's chaos state and
    its compaction lag, 8; the paged cell's is 12)."""
    b = c.blocks[0]
    m = b.metrics
    args = (b.state, b.fab, b._no_ops, b.mute, (m.samp_index, m.samp_round), m.round_ctr)
    d = rc.dims_of(b.state, b.fab, b.v, b.paged)
    tile = b._pallas_tile
    cta = rc.cta_lanes(tile, b.v, d, chaos=chaos, paged=True)

    def kw(kc):
        return dict(v=b.v, kc=kc, cta=cta, apply_ops=True, ops_round0_only=True, do_tick=True,
                    auto_propose=True, auto_compact_lag=8 if chaos else 12, paged=b.paged,
                    chaos=b.chaos if chaos else None, seg_lanes=tile)

    for kc in (1, 8):
        want = plr.round_kernel_ref(*args, **kw(kc))
        ptrs, dims, flags, lag, outs = rc.pack(*args, segments=b._segments, **kw(kc))
        arr, nptr, cdims = rc.as_c_args(ptrs, dims)
        go = {}
        for tree, lib in libs.items():
            go[tree] = cs.raw_launch(lib, arr, nptr, cdims, flags, lag, segments=b._segments)
            go[tree]()
            cs.synchronize(f"{tag} {tree} K={kc}")
            bad = cs.first_difference(cs.paged_launch_leaves(outs), cs.paged_launch_leaves(want))
            if bad is not None:
                raise AssertionError(f"{tag} {tree} K={kc}: first differing leaf {bad}")
        iters = 50 if kc == 1 else 10
        order = list(libs)
        turns = []
        for tree in (order + order[::-1]) * 2:
            turns.append([tree, cs.cuda_ms(go[tree], iters=iters)])
            cs.synchronize(f"{tag} {tree} K={kc} timing")
        mean = {tree: sum(ms for t, ms in turns if t == tree) / 4 for tree in libs}
        emit(f"ab_{tag}", kc=kc, lanes=b.shape.n_lanes, cta_lanes=cta, tile_lanes=tile,
             turns_ms=turns, mean_ms=mean,
             over_parent={tree: ms / mean["parent"] for tree, ms in mean.items()})
        for tree, lib in stamp_libs.items():
            row = cs.stamp_launch(lib, args, kw(kc), None, b._segments, kc, want,
                                  f"{tag} stamps {tree} K={kc}")
            # the timed build of the same source ("before": the parent's)
            emit(f"stamps_{tag}", tree=tree, kc=kc,
                 timed_ms=mean["parent" if tree == "before" else tree], **row)
        del go, outs, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, help="the parent tree's csrc directory")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="another tree's csrc directory, timed and stamped")
    ap.add_argument("--before", type=Path, help="a tree's csrc whose stamp twin to read too")
    ap.add_argument("--cell", action="append", choices=("chaos_paged", "paged"),
                    help="the cell whose build to time (default chaos_paged; repeatable)")
    ap.add_argument("--out", type=Path, help="also write every JSON line here")
    opt = ap.parse_args()
    if opt.out is not None:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text("")
        _OUT.append(opt.out)
    if not torch.cuda.is_available():
        print("ab_chaos_paged: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out_dir = build.BUILD_DIR / "ab"
    trees = dict(t.split("=", 1) for t in opt.tree)
    timed = ["parent", *trees, "change"]
    stamped = (["before"] if opt.before is not None else []) + [*trees, "change"]
    src = {"parent": opt.parent, "before": opt.before, "change": build.CSRC,
           **{name: Path(d) for name, d in trees.items()}}
    cells = [cell == "chaos_paged" for cell in dict.fromkeys(opt.cell or ["chaos_paged"])]
    jobs, libs = {}, {}
    for chaos in cells:
        for diet in (False, True):
            b = (cs._B3, 96, diet, cs.PAGED_PLAN, chaos, False)
            for tree in timed:
                jobs[(tree, diet, chaos)] = (src[tree], rc.target(*b))
            for tree in stamped:
                jobs[("stamps_" + tree, diet, chaos)] = (src[tree], rc.target(*b, stamps=True))
    procs = {}
    for key, (csrc, t) in jobs.items():
        path = out_dir / f"{key[0]}-{t.key}.so"
        procs[key] = (start_nvcc(csrc, t, path), path)
    # the cells' own libraries meanwhile (the engine builds on first use)
    build.build(*(rc.target(cs._B3, 96, diet, cs.PAGED_PLAN, chaos)
                  for chaos in cells for diet in (False, True)))
    logs = {}
    for key, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key} exited {proc.returncode}:\n{log}")
        logs[f"{key[0]}{'_chaos' if key[2] else ''}{'_diet' if key[1] else ''}"] = [
            f for f in cs.ptxas_report(log) if "round_kernel" in f["function"]]
        libs[key] = path
    emit("build", seconds=time.perf_counter() - t0, ptxas=logs)
    for chaos in cells:
        for diet in (False, True):
            tag = rc.kernel_name(diet, True, chaos)
            if chaos:
                c, run, _ = cs.run_main_chaos(
                    dev, f"cell_{tag}", cs.CHAOS_PAGED_BLOCK_GROUPS, cs.CHAOS_PAGED_POOL,
                    engine="pallas", rounds_per_call=8, paged=True, paged_inkernel=True,
                    diet=diet)
            else:
                c, run = cs.paged_cell(dev, f"cell_{tag}", paged=True, paged_inkernel=True,
                                       diet=diet)
            cs.synchronize(f"cell {tag}")
            emit(f"cell_{tag}", round_ms=run["round_ms"], digest=run["digest"],
                 pool_in_use=run.get("paged_pool_in_use"))
            ab_block(c, {tree: Lib(f"{tree} {tag}", libs[(tree, diet, chaos)]) for tree in timed},
                     {tree: Lib(f"{tree} stamps {tag}", libs[("stamps_" + tree, diet, chaos)])
                      for tree in stamped}, tag, chaos)
            del c
            torch.cuda.empty_cache()
    emit("ok", ok=True, seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except TimeoutError as e:
        print(f"ab_chaos_paged: {e}", file=sys.stderr, flush=True)
        import os

        os._exit(1)
