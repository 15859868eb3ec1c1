"""ctypes bindings for the native wire parser (wire_parser.c, built with cc).

The host half of ingestion: a two-pass C scanner (svt_scan sizes a proof's
groups, svt_fill copies its values, siblings and witnesses into buffers the
caller allocated), and a one-pass entry point for a layout the caller
keeps (svt_pass_many walks each blob once into its slot and refuses what does
not fit it).  The library is built by the host C compiler (`$CC`, else
`cc`) at first use, into `build/` beside the package under a name that hashes
the source and the flags, so a changed source rebuilds and several processes
can build at once.  A failed build raises with the compiler's output; nothing
falls back to the Python walker (`proofio.wire.parse_proof`), which stays the
plain version the tests hold this one against.

ctypes releases the GIL around every call.  The batched entry points
(svt_scan_many, svt_fill_many, svt_pass_many, svt_pack_many) take a range of
blobs a call, so a chunk parses on a few threads that hold the GIL only
between ranges (proofio/ingest.py, proofio/static_layout.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .. import _build

SOURCE = Path(__file__).resolve().parent / "wire_parser.c"
CFLAGS = ["-O2", "-shared", "-fPIC"]
META_WORDS = 2 + 6 * 66          # svt_scan's int64 meta buffer: 64 levels + tail

_lock = threading.Lock()
_state = {"lib": None, "seconds": None}

_ERRORS = {
    1: "truncated proof",
    2: "invalid proof element type",
    3: "bad size field",
    6: "too many FRI levels",
    7: "meta buffer too small",
    8: "proof does not fit the layout",
    9: "trailing bytes after proof",
}

SLOT_ARGS = 25                   # svt_fill's arguments after `len`

_p, _i64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "svt_scan": [ctypes.c_char_p, ctypes.c_size_t,
                 ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t],
    "svt_fill": ([ctypes.c_char_p, ctypes.c_size_t, _p, _p]
                 + [_p] * 11                     # per-level pointer tables
                 + [ctypes.POINTER(ctypes.c_int64), _p]
                 + [_p] * 10),                   # main + lincomb buffers
    "svt_scan_many": [_p, _p, _i64, _p, _i64, _p],
    "svt_fill_many": [_p, _p, _p, _i64, _p, _p],
    "svt_pass_many": [_p, _p, _i64, _p, ctypes.c_int32, _p],
    "svt_pack_many": [_p, _p, _i64, _p, _i64],
}


def error_message(rc: int) -> str:
    return _ERRORS.get(rc, f"error {rc}")


def library_path() -> Path:
    cc = os.environ.get("CC", "cc")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([cc] + CFLAGS).encode())
    return _build.BUILD_DIR / f"libwire_parser_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cc = os.environ.get("CC", "cc")
    tmp = out.with_name(f"{out.stem}.tmp-{os.getpid()}-{threading.get_ident()}.so")
    try:
        res = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"the wire parser could not be built with {cc}: "
                           f"{e}") from e
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed to build the wire parser:\n"
                           f"{res.stdout}")
    os.replace(tmp, out)          # atomic: a racing process wins whole


def get_lib() -> ctypes.CDLL:
    """The parser library, built first if this source has not been built
    here before.  Raises RuntimeError when it cannot be built."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        t0 = time.perf_counter()
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        _state["seconds"] = time.perf_counter() - t0
        return lib


def build_seconds():
    """Seconds the first get_lib() of this process took (the build included
    when there was one), or None before it."""
    return _state["seconds"]


def scan(lib, blob: bytes):
    """svt_scan one blob: (return code, int64 meta)."""
    meta = np.zeros(META_WORDS, dtype=np.int64)
    rc = lib.svt_scan(blob, len(blob),
                      meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      meta.size)
    return rc, meta


class Blobs:
    """A chunk of blobs as the batched entry points take them: an array of
    byte pointers (which holds a reference to every blob, so the pointers
    stay valid as long as this object) and their uint64 lengths."""

    def __init__(self, blobs: list):
        blobs = [b if isinstance(b, bytes) else bytes(b) for b in blobs]
        self.blobs = blobs
        self.n = len(blobs)
        self.ptrs = (ctypes.c_char_p * max(self.n, 1))(*blobs)
        self.lens = np.fromiter((len(b) for b in blobs), dtype=np.uint64,
                                count=self.n)

    def at(self, j: int):
        """(pointer array, lengths) from blob j on."""
        return (ctypes.addressof(self.ptrs) + j * ctypes.sizeof(ctypes.c_char_p),
                self.lens.ctypes.data + j * 8)

    def take(self, rows) -> "Blobs":
        """The blobs at `rows`, in order, as a chunk of their own."""
        return Blobs([self.blobs[j] for j in rows])


def _in_ranges(fn, n: int, threads: int) -> None:
    """fn(start, stop) over about `threads` contiguous ranges of [0, n), on
    threads when there is more than one; every range's error is raised."""
    k = max(1, min(threads, n))
    cuts = [n * i // k for i in range(k + 1)]
    spans = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
    if len(spans) <= 1:
        for a, b in spans:
            fn(a, b)
        return
    with ThreadPoolExecutor(max_workers=len(spans)) as ex:
        for f in [ex.submit(fn, a, b) for a, b in spans]:
            f.result()


def scan_many(lib, blobs: Blobs, threads: int = 4):
    """svt_scan of every blob: (metas [n, META_WORDS] int64, rcs [n])."""
    metas = np.zeros((blobs.n, META_WORDS), dtype=np.int64)
    rcs = np.zeros(blobs.n, dtype=np.int32)

    def part(a, b):
        ptrs, lens = blobs.at(a)
        lib.svt_scan_many(ptrs, lens, b - a, metas[a:].ctypes.data,
                          META_WORDS, rcs[a:].ctypes.data)

    _in_ranges(part, blobs.n, threads)
    return metas, rcs


def _check_table(table: np.ndarray) -> None:
    if table.dtype != np.uint64 or table.ndim != 2 \
            or table.shape[1] != SLOT_ARGS or not table.flags.c_contiguous:
        raise ValueError("fill table must be dense [slots, 25] uint64")


def fill_many(lib, blobs: Blobs, rows: np.ndarray, table: np.ndarray,
              threads: int = 4) -> np.ndarray:
    """svt_fill of blob j into slot j for every j in rows, with the slots'
    arguments from table ([slots, SLOT_ARGS] uint64 addresses, which must
    point into live buffers).  Returns the return codes, one a row."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    _check_table(table)
    if rows.size and (rows.min() < 0 or rows.max() >= min(blobs.n,
                                                          table.shape[0])):
        raise IndexError("fill rows out of range")
    rcs = np.zeros(rows.size, dtype=np.int32)

    def part(a, b):
        ptrs, lens = blobs.at(0)
        lib.svt_fill_many(ptrs, lens, rows[a:].ctypes.data, b - a,
                          table.ctypes.data, rcs[a:].ctypes.data)

    _in_ranges(part, rows.size, threads)
    return rcs


def pass_many(lib, blobs: Blobs, table: np.ndarray, strict: bool,
              threads: int = 4) -> np.ndarray:
    """svt_pass_many: blob j in one pass into slot j for every j < n, held
    to the layout meta of the slots' table (as fill_many's, [>= n,
    SLOT_ARGS]).  Returns the return codes, one a blob: 0 where the blob is
    filled exactly as scan + fill would fill it, else the first deviation
    (the slot then part written)."""
    _check_table(table)
    if table.shape[0] < blobs.n:
        raise IndexError("fill table has fewer slots than blobs")
    rcs = np.zeros(blobs.n, dtype=np.int32)
    row = SLOT_ARGS * table.itemsize

    def part(a, b):
        ptrs, lens = blobs.at(a)
        lib.svt_pass_many(ptrs, lens, b - a, table.ctypes.data + a * row,
                          int(strict), rcs[a:].ctypes.data)

    _in_ranges(part, blobs.n, threads)
    return rcs


def pack_many(lib, blobs: Blobs, out: np.ndarray, threads: int = 4) -> None:
    """Row j of out ([>= n, words] 4-byte words, C-contiguous) = blob j's
    first 4 * words bytes, zero-padded."""
    if out.ndim != 2 or out.itemsize != 4 or not out.flags.c_contiguous \
            or out.shape[0] < blobs.n:
        raise ValueError("pack buffer must be dense [>= n, words] words")
    words = out.shape[1]

    def part(a, b):
        ptrs, lens = blobs.at(a)
        lib.svt_pack_many(ptrs, lens, b - a, out[a:].ctypes.data, words)

    _in_ranges(part, blobs.n, threads)


def parse_proof_native(proof_bytes: bytes, allow_trailing: bool = True):
    """Parse with the C scanner; returns a wire.ProofArrays equal to
    wire.parse_proof's.

    Raises wire.WireFormatError on malformed input (the Python walker's
    error model, including the reference's trailing-bytes tolerance --
    deserializer.rs:142 returns a consumed count that main.rs:204 ignores);
    raises RuntimeError if the library cannot be built.
    """
    from ..proofio import wire

    lib = get_lib()
    proof_bytes = bytes(proof_bytes)
    rc, meta = scan(lib, proof_bytes)
    if rc:
        raise wire.WireFormatError(error_message(rc))

    n_levels = int(meta[0])
    n_points = int(meta[1])
    lv_meta = meta[2:2 + 6 * n_levels].reshape(n_levels, 6)
    mn, mvs, md, ln, lvs, ld = (int(x) for x in
                                meta[2 + 6 * n_levels: 2 + 6 * n_levels + 6])
    consumed = int(meta[2 + 6 * n_levels + 6])
    if not allow_trailing and consumed != len(proof_bytes):
        raise wire.WireFormatError(
            f"{len(proof_bytes) - consumed} trailing bytes after proof")

    u8, u32 = np.uint8, np.uint32

    def bufs(n, vs, d):
        """values, siblings, witnesses (bytes), vsizes, depths."""
        return (np.zeros(n * vs, u8), np.zeros(n * vs, u8),
                np.zeros(n * d * 32, u8), np.zeros(n, u32), np.zeros(n, u32))

    merkle_root, l_merkle_root = np.zeros(32, u8), np.zeros(32, u8)
    points = np.zeros(n_points * 32, u8)
    main, lin = bufs(mn, mvs, md), bufs(ln, lvs, ld)
    root2 = [np.zeros(32, u8) for _ in range(n_levels)]
    col = [bufs(int(m[0]), int(m[1]), int(m[2])) for m in lv_meta]
    pol = [bufs(int(m[3]), int(m[4]), int(m[5])) for m in lv_meta]

    def ptrs(arrs):
        return (ctypes.c_void_p * max(len(arrs), 1))(
            *[a.ctypes.data for a in arrs])

    def vp(a):
        return ctypes.c_void_p(a.ctypes.data)

    rc = lib.svt_fill(
        proof_bytes, len(proof_bytes), vp(merkle_root), vp(l_merkle_root),
        ptrs(root2),
        *(ptrs([g[k] for g in col]) for k in range(5)),
        *(ptrs([g[k] for g in pol]) for k in range(5)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), vp(points),
        *(vp(a) for a in main), *(vp(a) for a in lin))
    if rc:
        raise wire.WireFormatError(error_message(rc))

    def words(a, shape):
        return a.view("<u4").astype(np.uint32).reshape(shape)

    def group(b, n, vs, d):
        v, s, w, vsizes, depths = b
        return wire.BranchGroup(
            value_words=words(v, (n, vs // 4)),
            sibling_words=words(s, (n, vs // 4)),
            witness_words=words(w, (n, d, 8)),
            vsizes=vsizes, depths=depths)

    levels = [wire.FriLevel(
        root2_words=words(root2[i], (8,)),
        column=group(col[i], int(m[0]), int(m[1]), int(m[2])),
        poly=group(pol[i], int(m[3]), int(m[4]), int(m[5])))
        for i, m in enumerate(lv_meta)]
    return wire.ProofArrays(
        merkle_root_words=words(merkle_root, (8,)),
        l_merkle_root_words=words(l_merkle_root, (8,)),
        fri_levels=levels,
        points_words=words(points, (n_points, 8)),
        main=group(main, mn, mvs, md),
        lincomb=group(lin, ln, lvs, ld),
        consumed=consumed,
    )
