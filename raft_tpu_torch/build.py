"""Build the port's CUDA sources into shared libraries with a plain C
interface, and load them with ctypes.

A build target is a source `csrc/<source>.cu` and the `-D` macros it is
compiled with (csrc/round.cu takes the Shape that way, so each Shape a run
uses is one library). Each target compiles with `nvcc` for Hopper
(`sm_90a`) on first use into `csrc/build/<key>-<hash>.so`, keyed by a hash
of the source, the shared headers (`csrc/*.cuh`), the flags and the
macros, so an edited source or header rebuilds and an unchanged one is
reused. `build` starts one `nvcc` per target, all at once, and waits for
them together. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Target:
    """csrc/<source>.cu compiled with -D<name>=<value> for each define."""

    source: str
    defines: tuple[tuple[str, int], ...] = ()

    @property
    def key(self) -> str:
        """e.g. "quorum", "round-v3-w16-e2-f2-r2"."""
        return self.source + "".join(
            f"-{name.removeprefix('RAFT_').lower()}{value}" for name, value in self.defines
        )

    @property
    def flags(self) -> tuple[str, ...]:
        return tuple(f"-D{name}={value}" for name, value in self.defines)


def as_target(t: Target | str) -> Target:
    return t if isinstance(t, Target) else Target(t)


@dataclasses.dataclass(frozen=True)
class Built:
    name: str  # the target's key
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register/spill report), "" when reused


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


def library_path(target: Target | str) -> Path:
    t = as_target(target)
    src = (CSRC / f"{t.source}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + t.flags).encode()
    digest = hashlib.sha256(src + headers + flags).hexdigest()
    return BUILD_DIR / f"{t.key}-{digest[:16]}.so"


def build(*targets: Target | str) -> dict[str, Built]:
    """Compile every target that has no current library, all in parallel;
    returns key -> Built. Raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    out = {}
    for t in map(as_target, targets):
        dst = library_path(t)
        if dst.exists():
            out[t.key] = Built(t.key, dst, 0.0, "")
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *t.flags, "-o", str(tmp), str(CSRC / f"{t.source}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[t.key] = (proc, dst, tmp, time.perf_counter())
    failed = []
    for key, (proc, dst, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {key} exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, dst)  # atomic: concurrent builds race safely
        out[key] = Built(key, dst, secs, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(target: Target | str) -> ctypes.CDLL:
    """The loaded library of a target, building it if needed."""
    t = as_target(target)
    lib = _loaded.get(t.key)
    if lib is None:
        lib = ctypes.CDLL(str(build(t)[t.key].path))
        _loaded[t.key] = lib
    return lib
