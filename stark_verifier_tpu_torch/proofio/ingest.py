"""Batched proof ingestion: wire bytes -> one batch tree of host tensors.

The per-proof path (wire.parse_proof_fast -> device.proof_tree ->
device.stack_proofs) allocates every proof's arrays, wraps them and copies
them again into the batch.  Here the batch arrays are allocated ONCE per
chunk shape and the native fill pass (native/wire_parser.c svt_fill) writes
each proof's values, siblings and witnesses straight into its slot [i].
Blobs whose scan metadata deviates from the layout's (ragged groups,
another witness padding) go through the per-proof parse into the same slot;
blobs that are malformed or of another family reject (ok[i] = False).

The batch tensors are int32 holding the uint32 bit patterns (the port's word
convention, proofio/device.py); when the batch is bound for the card they are
pinned, so that its host-to-device copy can run asynchronously.  Every host
check reads them through uint32 numpy views of the same memory.

On a layout the caller keeps, each blob is parsed in one pass straight into
its slot (native.pass_many): the pass holds the blob to the layout's shape as
it walks, and fills it exactly as a scan and a fill would.  Only the blobs it
refuses, and every blob of a chunk with no kept layout (a stream slot's or a
batch caller's first), are scanned and filled by the two-pass route
(native.scan_many / fill_many), with the family and layout checks vectorized
over the scan metadata.  Each is a few calls a chunk, each over a range of
blobs on its own thread, with the GIL released for the whole range.  Only the
rare structural outliers take the per-proof parse, on the same threads.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import device as pdevice
from . import wire
from .. import fp
from ..profiling import span


class SlotShapeError(Exception):
    """A validated proof tree does not fit the chunk layout's padded dims
    (witness arrays deeper than the layout allocated).  Deliberately NOT a
    WireFormatError/ValueError: it must never be swallowed as a reject --
    the blob is family-valid, so the caller expands the layout instead."""


def _family_rows(metas: np.ndarray, cfg) -> np.ndarray:
    """Does each row of svt_scan metadata describe a proof of this
    statement family?  bool [rows].

    Mirrors wire.validate_proof's level / branch-count / value-size / POINTS
    checks on the scan metadata alone (group maxima: a ragged group whose
    max matches still native-fills and is then caught per branch by
    validate_filled).  Gates both layout selection and per-blob fill, so one
    adversarial blob at a chunk head can neither crash BatchLayout nor set
    the chunk's widths for its neighbours."""
    L, q, s = cfg.fri_levels, cfg.fri_queries, cfg.spot_checks
    if L < 1:
        return np.zeros(metas.shape[0], dtype=bool)
    lv = metas[:, 2:2 + 6 * L].reshape(-1, L, 6)
    tm = metas[:, 2 + 6 * L:2 + 6 * L + 6]
    return ((metas[:, 0] == L) & (metas[:, 1] == cfg.fri_final_domain)
            & ((lv[..., 0] == q) & (lv[..., 1] == 32) & (lv[..., 3] == 4 * q)
               & (lv[..., 4] == 32)).all(axis=1)
            & (tm[:, 0] == 2 * s) & (tm[:, 1] == 96) & (tm[:, 3] == s)
            & (tm[:, 4] == 32))


def _pad_assign(dst: np.ndarray, src: np.ndarray) -> None:
    """dst[...] = src, zero-padding trailing dims when src is smaller
    (witness depth raggedness is free: the Merkle walk is governed by the
    depth arrays, padding rows are never hashed)."""
    if dst.shape == src.shape:
        dst[...] = src
        return
    if dst.ndim != src.ndim or any(
            d < s for d, s in zip(dst.shape, src.shape)):
        raise SlotShapeError(f"{src.shape} does not fit slot {dst.shape}")
    dst[...] = 0
    dst[tuple(slice(0, s) for s in src.shape)] = src


def _words(t: torch.Tensor) -> np.ndarray:
    """uint32 numpy view of an int32 host tensor (same memory)."""
    return t.numpy().view(np.uint32)


class BatchLayout:
    """Chunk-shape descriptor + the preallocated batch tree.

    Built from the scan metadata of the first family-valid blob; reused
    across chunks of the same stream (allocate once, fill in place).
    `tensors` is the batch as int32 torch tensors (pinned with pin=True);
    `tree` holds uint32 numpy views of the same memory, through which the
    host fills and checks it.
    """

    def __init__(self, meta: np.ndarray, batch: int, pin: bool = False):
        self.batch = batch
        self.pin = pin
        self.n_levels = int(meta[0])
        if self.n_levels < 1:
            # a wire-valid blob may carry zero FRI levels (tag 2 at once);
            # it can never be a layout
            raise wire.WireFormatError("proof has no FRI levels")
        self.n_points = int(meta[1])
        self.lv_meta = [tuple(int(x) for x in row)
                        for row in meta[2:2 + 6 * self.n_levels].reshape(
                            self.n_levels, 6)]
        tm = meta[2 + 6 * self.n_levels: 2 + 6 * self.n_levels + 6]
        self.main_meta = tuple(int(x) for x in tm[:3])
        self.lin_meta = tuple(int(x) for x in tm[3:])
        self.key = (self.n_levels, self.n_points,
                    tuple(self.lv_meta), self.main_meta, self.lin_meta)

        B, L = batch, self.n_levels

        def buf(*shape):
            return torch.zeros(shape, dtype=torch.int32, pin_memory=pin)

        def group(n, vs, d):
            return {"value": buf(B, n, vs // 4), "sibling": buf(B, n, vs // 4),
                    "witness": buf(B, n, d, 8), "depth": buf(B, n)}

        c0 = self.lv_meta[0]
        self.tensors = {
            "merkle_root": buf(B, 8),
            "l_merkle_root": buf(B, 8),
            "fri": {
                "root2": buf(B, L, 8),
                "col_value": buf(B, L, c0[0], c0[1] // 4),
                "col_sibling": buf(B, L, c0[0], c0[1] // 4),
                "col_witness": [buf(B, cm[0], cm[2], 8) for cm in self.lv_meta],
                "col_depth": buf(B, L, c0[0]),
                "poly_value": buf(B, L, c0[3], c0[4] // 4),
                "poly_sibling": buf(B, L, c0[3], c0[4] // 4),
                "poly_witness": [buf(B, cm[3], cm[5], 8)
                                 for cm in self.lv_meta],
                "poly_depth": buf(B, L, c0[3]),
            },
            "points": buf(B, self.n_points, 8),
            "main": group(*self.main_meta),
            "lincomb": group(*self.lin_meta),
        }
        self.tree = pdevice.tree_map(_words, self.tensors)
        # scratch per-branch vsizes, one row per slot (checked then discarded)
        u32 = np.uint32
        self._vs_col = [np.zeros((B, cm[0]), u32) for cm in self.lv_meta]
        self._vs_poly = [np.zeros((B, cm[3]), u32) for cm in self.lv_meta]
        self._vs_main = np.zeros((B, self.main_meta[0]), u32)
        self._vs_lin = np.zeros((B, self.lin_meta[0]), u32)
        # fill strides: svt_fill reads vmax/dmax strides from the meta buffer
        self._fill_meta = meta.copy()
        # scan-metadata prefix a blob must match to native-fill this layout
        self._meta_prefix = meta[:2 + 6 * self.n_levels + 6].copy()
        self._build_fill_table()

    def _build_fill_table(self) -> None:
        """svt_fill's arguments for every slot, as addresses: the table
        [batch, 25] that native.fill_many reads, and the per-level pointer
        arrays [batch, 11, levels] its table entries point to.  Every address
        points into self.tensors, self._vs_*, self._fill_meta or
        self._level_ptrs, which this object owns for its whole life, so the
        table never outlives the memory it points into."""
        B, L = self.batch, self.n_levels
        i = np.arange(B, dtype=np.uint64)
        t, fri = self.tensors, self.tensors["fri"]

        def rows(x, level=None):
            """Address of slot i's row (at `level` of a [B, L, ...] array)."""
            if isinstance(x, torch.Tensor):
                base, st = x.data_ptr(), x.stride()
                size = x.element_size()
            else:
                base, st, size = x.ctypes.data, x.strides, 1
            off = 0 if level is None else level * st[1] * size
            return np.uint64(base + off) + i * np.uint64(st[0] * size)

        per_level = [
            [rows(fri["root2"], l) for l in range(L)],
            [rows(fri["col_value"], l) for l in range(L)],
            [rows(fri["col_sibling"], l) for l in range(L)],
            [rows(fri["col_witness"][l]) for l in range(L)],
            [rows(self._vs_col[l]) for l in range(L)],
            [rows(fri["col_depth"], l) for l in range(L)],
            [rows(fri["poly_value"], l) for l in range(L)],
            [rows(fri["poly_sibling"], l) for l in range(L)],
            [rows(fri["poly_witness"][l]) for l in range(L)],
            [rows(self._vs_poly[l]) for l in range(L)],
            [rows(fri["poly_depth"], l) for l in range(L)],
        ]
        self._level_ptrs = np.ascontiguousarray(
            np.stack([np.stack(k, axis=1) for k in per_level], axis=1))
        tables = (np.uint64(self._level_ptrs.ctypes.data)
                  + (i[:, None] * np.uint64(11) + np.arange(11, dtype=np.uint64))
                  * np.uint64(8 * L))
        meta = np.full(B, self._fill_meta.ctypes.data, dtype=np.uint64)
        m, c = t["main"], t["lincomb"]
        cols = ([rows(t["merkle_root"]), rows(t["l_merkle_root"])]
                + [tables[:, k] for k in range(11)]
                + [meta, rows(t["points"]),
                   rows(m["value"]), rows(m["sibling"]), rows(m["witness"]),
                   rows(self._vs_main), rows(m["depth"]),
                   rows(c["value"]), rows(c["sibling"]), rows(c["witness"]),
                   rows(self._vs_lin), rows(c["depth"])])
        self._fill_table = np.ascontiguousarray(np.stack(cols, axis=1))

    def compatible_rows(self, metas: np.ndarray) -> np.ndarray:
        """bool [rows]: may each row's blob native-fill this layout?"""
        return (metas[:, :self._meta_prefix.size] == self._meta_prefix).all(1)

    def fill(self, lib, blobs, rows: np.ndarray, threads: int) -> np.ndarray:
        """Native fill of blob j into slot j for every j in rows; returns
        svt_fill's return codes, one a row."""
        from .. import native
        return native.fill_many(lib, blobs, rows, self._fill_table, threads)

    def one_pass(self, lib, blobs, strict: bool, threads: int) -> np.ndarray:
        """Blob j in one pass into slot j for every blob; returns the return
        codes, 0 exactly where the blob's scan metadata would pass
        compatible_rows (and, under strict, has no trailing bytes), its slot
        then filled as fill() would fill it."""
        from .. import native
        return native.pass_many(lib, blobs, self._fill_table, strict, threads)

    def copy_slot_from_tree(self, src: dict, i: int) -> None:
        """Slow path: copy a per-proof numpy tree into batch slot i.  Smaller
        witness dims zero-pad into the slot; a tree DEEPER than the layout
        raises SlotShapeError (the caller expands the layout -- it must not
        reject a family-valid proof for its chunk-mates' shapes)."""
        pdevice.tree_map(lambda dst, s: _pad_assign(dst[i], s), self.tree, src)

    def family_ok(self, cfg) -> bool:
        """Layout-level family checks (identical for every slot of this
        layout): FRI level count, branch counts, value sizes, POINTS size."""
        return bool(_family_rows(self._fill_meta[None], cfg)[0])

    def validate_filled(self, cfg, filled: np.ndarray) -> np.ndarray:
        """Vectorized per-slot family checks (value sizes, witness depths)
        over the natively filled slots; a violating slot rejects, it never
        aborts the chunk.  Depths are compared as uint32, as the reference
        reads them."""
        B = filled.size
        if not self.family_ok(cfg):
            return np.zeros(B, dtype=bool)
        okv = filled.copy()
        fri = self.tree["fri"]
        for l in range(self.n_levels):
            okv &= (self._vs_col[l][:B] == 32).all(axis=1)
            okv &= (self._vs_poly[l][:B] == 32).all(axis=1)
            okv &= (fri["col_depth"][:B, l] >= 1).all(axis=1)
            okv &= (fri["poly_depth"][:B, l] >= 1).all(axis=1)
        okv &= (self._vs_main[:B] == 96).all(axis=1)
        okv &= (self._vs_lin[:B] == 32).all(axis=1)
        okv &= (self.tree["main"]["depth"][:B] >= 1).all(axis=1)
        okv &= (self.tree["lincomb"]["depth"][:B] >= 1).all(axis=1)
        return okv


def ingest_chunk(blobs: list, cfg, layout: BatchLayout | None = None,
                 threads: int = 4, pad_to: int | None = None,
                 pin: bool = False):
    """Parse a chunk of wire blobs into ONE batch tree.

    Returns (batch_tree, ok, layout): batch_tree is the layout's [pad_to or
    len(blobs), ...] tree of int32 host tensors (the slot of a failed blob --
    and every pad slot past len(blobs) -- holds the first valid proof;
    callers mask by `ok`, length len(blobs)), ok a bool array, and the
    reusable BatchLayout (None tree when no blob is valid).  pin=True
    allocates a new layout in pinned memory.  Thread-parallel native
    parse: one pass a blob on a kept layout, scan + fill for the rest;
    per-blob failures reject without aborting.

    Per-proof verdict independence: the layout is only ever built from a
    meta passing _family_rows, a passed-in layout that is too small or
    family-incompatible is discarded rather than reused, and a family-valid
    blob that doesn't fit the layout's witness padding EXPANDS the layout
    instead of rejecting -- no blob's verdict depends on which other blobs
    share its chunk.
    """
    with span("parse", proofs=len(blobs)) as sp:
        tree, ok, layout, seen = _ingest(blobs, cfg, layout, threads, pad_to,
                                         pin)
        if sp:
            rcs, fam, filled, passed, slow, how = seen
            sp.set(scan_rejected=int((rcs != 0).sum()),
                   family_rejected=int(((rcs == 0) & ~fam).sum()),
                   native_filled=int(filled.sum()), one_pass=passed,
                   slow=slow, ok=int(ok.sum()), layout=how)
    return tree, ok, layout


def _ingest(blobs: list, cfg, layout, threads: int, pad_to, pin: bool):
    """ingest_chunk's work: (tree, ok, layout, what the parse span counts:
    (scan return codes, family rows, natively filled rows, how many of them
    the one pass filled, slow-path blobs, what became of the layout: kept,
    built, rebuilt, expanded or none))."""
    from .. import native
    lib = native.get_lib()

    B = len(blobs)
    alloc = max(pad_to or B, B)
    ok = np.zeros(B, dtype=bool)
    filled = np.zeros(B, dtype=bool)
    chunk = native.Blobs(blobs)

    given = layout is not None
    if layout is not None and (layout.batch < alloc
                               or not layout.family_ok(cfg)):
        layout = None
    if layout is not None:
        # a kept layout: one pass a blob, straight into its slot.  A blob it
        # fills is of the family and compatible with the layout, as a scan
        # would have found; only the blobs it refuses are scanned below
        with span("parse.pass"):
            filled = layout.one_pass(lib, chunk, cfg.strict, threads) == 0
    passed = int(filled.sum())
    rest = np.flatnonzero(~filled)         # scanned: metas' rows are these
    rcs = np.zeros(B, dtype=np.int32)
    fam = filled.copy()
    if rest.size:
        with span("parse.scan"):
            metas, rcs[rest] = native.scan_many(
                lib, chunk if rest.size == B else chunk.take(rest), threads)
            fam[rest] = (rcs[rest] == 0) & _family_rows(metas, cfg)

    if layout is not None and not passed and fam.any() and not (
            layout.compatible_rows(metas) & fam).any():
        # stale layout (expanded for a one-off adversarial blob, or the
        # prover's witness padding changed): no blob here native-fills it,
        # so rebuild rather than slow-path whole chunks forever.  (With
        # none passed, every blob was scanned.)
        layout = None
    how = "kept" if layout is not None else "rebuilt" if given else "built"
    if layout is None:
        if not fam.any():
            # nothing in this chunk matches the family: every blob rejects
            return None, ok, layout, (rcs, fam, filled, 0, 0, "none")
        with span("parse.layout"):
            layout = BatchLayout(metas[int(np.flatnonzero(fam)[0])], alloc,
                                 pin=pin)

    if rest.size:
        native_rows = fam[rest] & layout.compatible_rows(metas)
        if cfg.strict:
            # trailing bytes: the host parse below arbitrates (and rejects)
            native_rows &= (metas[:, 2 + 6 * cfg.fri_levels + 6]
                            == chunk.lens[rest].astype(np.int64))
        rows = rest[native_rows]
        if rows.size:
            with span("parse.fill"):
                filled[rows[layout.fill(lib, chunk, rows, threads) == 0]] = \
                    True
    # a scan/fill divergence never aborts the chunk: such a blob takes the
    # per-proof host parse with the structural outliers (ragged groups,
    # other witness padding), which decides its verdict
    oversized = []        # (j, tree): family-valid but deeper than the layout

    def slow_one(j):
        try:
            p = wire.parse_proof_fast(blobs[j], allow_trailing=not cfg.strict)
            wire.validate_proof(p, cfg)
            t = pdevice.proof_tree(p)
        except (wire.WireFormatError, ValueError):
            return
        try:
            layout.copy_slot_from_tree(t, j)
            ok[j] = True
        except SlotShapeError:
            oversized.append((j, t))   # list.append is GIL-atomic

    slow = np.flatnonzero(fam & ~filled)
    if slow.size:
        with span("parse.slow"), \
                ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
            list(ex.map(slow_one, slow.tolist()))
    with span("parse.validate"):
        ok |= layout.validate_filled(cfg, filled)

    if oversized:
        # a valid proof must not reject because the chunk head's witness
        # padding was shallower: rebuild the layout with max dims and
        # migrate everything already ingested (adversarial input only)
        how = "expanded"
        with span("parse.layout"):
            layout = _expand_layout(layout, [t for _, t in oversized],
                                    np.flatnonzero(ok))
        for j, t in oversized:
            layout.copy_slot_from_tree(t, j)
            ok[j] = True

    seen = (rcs, fam, filled, passed, int(slow.size), how)
    if not ok.any():
        return None, ok, layout, seen
    # failed and pad slots get the first valid proof, so that the whole
    # batch verifies in one call; their verdicts are masked by `ok`
    with span("parse.pad"):
        first = int(np.flatnonzero(ok)[0])
        rest = np.concatenate([np.flatnonzero(~ok),
                               np.arange(B, layout.batch)]).astype(np.int64)
        if rest.size:
            pdevice.tree_map(lambda a: a.__setitem__(rest, a[first]),
                             layout.tree)
    return layout.tensors, ok, layout, seen


def _expand_layout(old: BatchLayout, extra_trees: list,
                   keep: np.ndarray) -> BatchLayout:
    """New layout whose witness dims cover `old` plus every tree in
    extra_trees; slots listed in `keep` are migrated (zero-padded)."""
    meta = old._fill_meta.copy()
    L = old.n_levels

    def bump(ix, v):
        meta[ix] = max(int(meta[ix]), int(v))

    for t in extra_trees:
        for l in range(L):
            bump(2 + 6 * l + 2, t["fri"]["col_witness"][l].shape[-2])
            bump(2 + 6 * l + 5, t["fri"]["poly_witness"][l].shape[-2])
        bump(2 + 6 * L + 2, t["main"]["witness"].shape[-2])
        bump(2 + 6 * L + 5, t["lincomb"]["witness"].shape[-2])
    new = BatchLayout(meta, old.batch, pin=old.pin)

    keep = np.asarray(keep, dtype=np.int64)
    if keep.size:
        def mig(dst, src):
            dst[(keep,) + tuple(slice(0, s) for s in src.shape[1:])] = \
                src[keep]
        pdevice.tree_map(mig, new.tree, old.tree)
    return new


class StatementRows:
    """A chunk's run-time statements as limbs, row for row beside its
    batch tree: `tensors` is {"inp": [rows, 16], "out": [rows, 16]} int32
    (pinned with pin=True), allocated once and refilled a chunk at a time.
    `limbs` holds each distinct (input, claimed output) converted once,
    mod p as verify_mimc takes them; a stream shares it between its
    slots."""

    MAX_KEPT = 1 << 16     # distinct statements converted before a reset

    def __init__(self, rows: int, limbs: dict, pin: bool = False):
        self.tensors = {k: torch.zeros((rows, fp.NLIMBS), dtype=torch.int32,
                                       pin_memory=pin)
                        for k in ("inp", "out")}
        self.limbs = limbs

    def fill(self, statements: list) -> int:
        """Write rows [:len(statements)]; returns how many distinct
        statements they hold."""
        keys = [(int(a), int(b)) for a, b in statements]
        distinct = set(keys)
        if len(self.limbs) > self.MAX_KEPT:
            self.limbs.clear()
        for k in distinct - self.limbs.keys():
            self.limbs[k] = fp.ints_to_limbs([x % fp.MODULUS for x in k])
        both = np.stack([self.limbs[k] for k in keys])        # [n, 2, 16]
        _words(self.tensors["inp"])[:len(keys)] = both[:, 0]
        _words(self.tensors["out"])[:len(keys)] = both[:, 1]
        return len(distinct)


def ingest_chunk_plain(blobs: list, cfg, pad_to: int | None = None):
    """The plain version of ingest_chunk: per-proof Python walk + validate,
    then a padded stack.  Returns (batch_tree of int32 host tensors or None,
    ok).  Nothing calls it on the way to a verdict; the tests hold
    ingest_chunk against it."""
    trees, ok = [], np.zeros(len(blobs), dtype=bool)
    golden = None
    for j, b in enumerate(blobs):
        try:
            p = wire.parse_proof(bytes(b), allow_trailing=not cfg.strict)
            wire.validate_proof(p, cfg)
            t = pdevice.proof_tree(p)
        except wire.WireFormatError:
            trees.append(None)
            continue
        trees.append(t)
        ok[j] = True
        golden = golden or t
    if golden is None:
        return None, ok
    trees = [t if t is not None else golden for t in trees]
    while pad_to and len(trees) < pad_to:
        trees.append(golden)
    return (pdevice.tree_map(lambda a: torch.from_numpy(a.view(np.int32)),
                             _pad_stack(trees)), ok)


def _pad_stack(trees: list):
    """stack_proofs tolerating per-proof witness-depth maxima (valid proofs
    of one family may pad witnesses differently; zero-padding to the common
    max is free -- the walk is governed by the depth arrays)."""
    def stack(*xs):
        if all(x.shape == xs[0].shape for x in xs):
            return np.stack(xs)
        shp = tuple(max(x.shape[d] for x in xs) for d in range(xs[0].ndim))
        out = np.zeros((len(xs),) + shp, xs[0].dtype)
        for i, x in enumerate(xs):
            out[(i,) + tuple(slice(0, s) for s in x.shape)] = x
        return out

    return pdevice.tree_map(stack, trees[0], *trees[1:])
