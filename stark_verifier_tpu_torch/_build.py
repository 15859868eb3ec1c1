"""Builds and loads the CUDA kernels (csrc/) at first use.

Every `.cu` file under csrc/ is compiled by its own `nvcc` process for
sm_90a, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ctypes.  The library lands in
`build/` beside this file, named by a hash of the sources, so a changed
source rebuilds and an unchanged one loads in milliseconds.  Nothing here
runs at import: the first kernel launch triggers the build.  A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_u32p = ctypes.POINTER(ctypes.c_uint32)


class WalkGroup(ctypes.Structure):
    """One branch group of the grouped Merkle walks (csrc/merkle_walk.cu,
    struct stark_walk_group: the same fields in the same order)."""
    _fields_ = [("value", _p), ("sibling", _p), ("witness", _p),
                ("tidx", _p), ("depth", _p), ("out", _p),
                ("vstride", _ll), ("wit_stride", _ll), ("n", _ll),
                ("vw", _i), ("levels", _i), ("first_block", _ll)]


_groups = ctypes.POINTER(WalkGroup)
# C entry points: every pointer and the stream are c_void_p (a bare Python
# int would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "stark_walk_leaf_levels_groups": [_groups, _i, _p],
    "stark_chain_levels": [_p, _p, _ll, _p, _p, _i, _ll, _p],
    "stark_eval4_rows": [_p, _p, _p, _p, _u32p, _u32p, _ll, _p, _ll, _p],
    "stark_spot_checks": [_p, _p, _p, _p, _p, _ll, _i, _p, _ll, _p],
    "stark_mul_mod": [_p, _ll, _p, _ll, _p, _ll, _p],
    "stark_walk_branches_groups": [_groups, _i, _p],
}

_state = {"lib": None, "seconds": None, "log": ""}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels cannot be built on this machine")


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set argtypes/restype of every C entry point."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _compile(nvcc: str, out: Path) -> str:
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{out.stem}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        srcs = sources()
        objs = [tmp / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs, failed = [], []
        for s, p in zip(srcs, procs):       # wait for all: none is left running
            text, _ = p.communicate()
            logs.append(f"== {s.name}\n{text}")
            if p.returncode:
                failed.append(s.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        so_tmp = tmp / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(so_tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, out)             # atomic: a racing process wins whole
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library_path() -> Path:
    """Where the library of this source state (and these flags) is built."""
    return BUILD_DIR / f"libstark_kernels_{source_hash()}.so"


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if this source state has not
    been built here before."""
    if _state["lib"] is not None:
        return _state["lib"]
    t0 = time.perf_counter()
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _state["log"] = _compile(find_nvcc(), out)
    _state["lib"] = declare(ctypes.CDLL(str(out)))
    _state["seconds"] = time.perf_counter() - t0
    return _state["lib"]


def build_seconds():
    """Seconds the first load() took (build included), or None before it."""
    return _state["seconds"]


def build_log() -> str:
    """nvcc's output of this process's build (register and spill counts from
    -Xptxas -v); empty when the library was already built."""
    return _state["log"]


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
