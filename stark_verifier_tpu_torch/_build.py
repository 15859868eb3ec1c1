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

from .profiling import span

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class WalkGroup(ctypes.Structure):
    """One branch group of the grouped Merkle walks (csrc/merkle_walk.cu,
    struct stark_walk_group: the same fields in the same order)."""
    _fields_ = [("value", _p), ("sibling", _p), ("witness", _p),
                ("tidx", _p), ("depth", _p), ("out", _p),
                ("vstride", _ll), ("wit_stride", _ll), ("n", _ll),
                ("vw", _i), ("levels", _i), ("first_block", _ll),
                ("ok", _p)]


class SpotArgs(ctypes.Structure):
    """The operands of kernel D (csrc/spot_checks.cu, struct
    stark_spot_args: the same fields in the same order)."""
    _fields_ = [("main", _p), ("lin", _p), ("pos", _p), ("kh", _p),
                ("ic1", _p), ("ic0", _p), ("g2", _p), ("z", _p), ("z2", _p),
                ("k", _p), ("out", _p),
                ("main_stride", _ll), ("lin_stride", _ll), ("kh_stride", _ll),
                ("ic1_stride", _ll), ("ic0_stride", _ll), ("rows", _ll),
                ("k_rows", _ll), ("group", _ll), ("n", _ll),
                ("log_steps", _i), ("power", _i)]


class FriRowsArgs(ctypes.Structure):
    """The operands of kernel C (csrc/fri_rows.cu, struct
    stark_fri_rows_args: the same fields in the same order)."""
    _fields_ = [("poly", _p), ("col", _p), ("ys", _p), ("lroot", _p),
                ("root2", _p), ("g2", _p), ("ok", _p), ("lhs", _p),
                ("poly_stride", _ll), ("col_stride", _ll),
                ("lroot_stride", _ll), ("root2_stride", _ll), ("rows", _ll),
                ("levels", _ll), ("q", _ll), ("n", _ll),
                ("ginv", ctypes.c_uint32 * 8), ("inv4", ctypes.c_uint32 * 8)]


class NttStageArgs(ctypes.Structure):
    """The operands of one NTT stage (csrc/ntt_stage.cu, struct
    stark_ntt_stage_args: the same fields in the same order)."""
    _fields_ = [("src", _p), ("perm", _p), ("tw", _p), ("scale", _p),
                ("dst", _p), ("lead", _ll), ("n", _ll), ("src_n", _ll),
                ("half", _ll), ("tw_rows", _ll), ("tw_stride", _ll),
                ("tw_off", _ll), ("src_limbs", _i), ("dst_limbs", _i)]


class NttBlockArgs(ctypes.Structure):
    """The operands of one pass of several NTT stages (csrc/ntt_block.cu,
    struct stark_ntt_block_args: the same fields in the same order)."""
    _fields_ = [("src", _p), ("perm", _p), ("tw", _p), ("scale", _p),
                ("dst", _p), ("lead", _ll), ("n", _ll), ("src_n", _ll),
                ("tw_rows", _ll), ("s0", _i), ("k", _i), ("lc", _i),
                ("src_limbs", _i), ("dst_limbs", _i)]


class HashArgs(ctypes.Structure):
    """The operands of one launch of the narrow hashes (csrc/blake2s_hash.cu,
    struct stark_hash_args: the same fields in the same order)."""
    _fields_ = [("src", _p), ("dst", _p), ("n", _ll), ("words", _i),
                ("nbytes", _i), ("chain", _i), ("links", _i)]


_groups = ctypes.POINTER(WalkGroup)
# C entry points: every pointer and the stream are c_void_p (a bare Python
# int would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "stark_walk_leaf_levels_groups": [_groups, _i, _p],
    "stark_walk_quads_groups": [_groups, _i, _p],
    "stark_fri_rows": [ctypes.POINTER(FriRowsArgs), _p],
    "stark_spot_checks": [ctypes.POINTER(SpotArgs), _p],
    "stark_mul_mod": [_p, _ll, _p, _ll, _p, _ll, _p],
    "stark_walk_branches_groups": [_groups, _i, _p],
    "stark_ntt_stage": [ctypes.POINTER(NttStageArgs), _p],
    "stark_ntt_block": [ctypes.POINTER(NttBlockArgs), _p],
    "stark_mimc_scan": [_p, _p, _ll, _ll, _i, _p, _ll, _p],
    "stark_hash_words": [ctypes.POINTER(HashArgs), _p],
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
    with span("build.load") as sp:
        t0 = time.perf_counter()
        out = library_path()
        built = not out.exists()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _state["log"] = _compile(find_nvcc(), out)
        _state["lib"] = declare(ctypes.CDLL(str(out)))
        _state["seconds"] = time.perf_counter() - t0
        sp.set(built=built)
    return _state["lib"]


def build_seconds():
    """Seconds the first load() took (build included), or None before it."""
    return _state["seconds"]


def build_log() -> str:
    """nvcc's output of this process's build (register and spill counts from
    -Xptxas -v); empty when the library was already built."""
    return _state["log"]


def proof_stride(t, nlead: int, what: str) -> int:
    """Word stride between consecutive proofs of the tensor `t` that an
    entry point reads in place: its first `nlead` dims index the proofs
    (they must collapse to one stride) and its other dims are dense.
    `what` names the operand in the error."""
    inner = t.shape[nlead:]
    dense = 1
    for size, stride in zip(reversed(inner), reversed(t.stride()[nlead:])):
        if size > 1 and stride != dense:
            raise ValueError(f"{what} rows must be dense")
        dense *= size
    for d in range(nlead - 1):
        if t.shape[d] > 1 and t.stride(d) != t.stride(d + 1) * t.shape[d + 1]:
            raise ValueError(f"{what}: the proof dims do not collapse to "
                             "one stride")
    return t.stride(nlead - 1) if nlead else 0


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
