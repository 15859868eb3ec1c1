"""Host-side wire-format parser: proof bytes -> fixed-shape word arrays.

Implements the reference verifier's serialization (src/deserializer.rs:16-144):

  StarkProof := merkle_root[32] || l_merkle_root[32]
                ( tag=1 || root2[32] || column:MultiProof || poly:MultiProof )*
                ( tag=2 || size:u32le || points[size] )        -- terminates
                merkle_branches:MultiProof || linear_comb_branches:MultiProof
  MultiProof  := n:u32le || Branch{n}
  Branch      := vsize:u32le || value[vsize] || sibling[vsize]
                 || wsize:u32le || witness[32][wsize/32]

All length/tag prefixes are little-endian u32; field values are 32-byte
big-endian ints.  The parser emits uint32 little-endian *word* arrays (the
Blake2s view); the field-limb view is derived on the device (see
ops.field.words_be_to_limbs) so the host->device copy stays minimal.

Malformed input raises WireFormatError -- the batched verifier maps parse
failures to reject verdicts instead of panicking like the reference.

Trailing-bytes semantics match the reference: from_bytes returns the consumed
byte count (deserializer.rs:142) and main() ignores it (main.rs:204), so a
proof followed by trailing garbage still verifies.  parse_proof therefore
accepts trailing bytes by default and records `consumed`.

Structure validation against a statement family (validate_proof) is a
separate step from byte parsing: the wire format itself admits any level
count / group widths, but the verifier works on one family's fixed shapes --
a parsed-but-wrong-shape proof must REJECT with a structured error (the
reference's equivalent is the hardcoded shape asserts panicking,
main.rs:50,120-123).

This is the port's own copy of the JAX package's parser.  parse_proof is
the Python walker; parse_proof_fast runs the native C scanner (native/),
which gives the same arrays and the same errors, and is what
parse_and_validate uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class WireFormatError(ValueError):
    pass


@dataclass(frozen=True)
class BranchGroup:
    """One MultiProof as struct-of-arrays.

    value_words/sibling_words: [n, vw_max] uint32 (LE words; vw = vsize/4,
    zero-padded past each branch's own size for ragged groups)
    witness_words: [n, depth_max, 8] uint32 (zero-padded past each depth)
    vsizes/depths: [n] per-branch value bytes / witness counts -- the
    reference reads both per branch (deserializer.rs:104-119).
    """
    value_words: np.ndarray
    sibling_words: np.ndarray
    witness_words: np.ndarray
    vsizes: np.ndarray
    depths: np.ndarray

    @property
    def n(self) -> int:
        return self.value_words.shape[0]

    @property
    def rectangular(self) -> bool:
        return (len(set(self.vsizes.tolist())) == 1
                and len(set(self.depths.tolist())) == 1)

    @property
    def depth(self) -> int:
        return self.witness_words.shape[1]

    @property
    def value_bytes(self) -> int:
        return self.value_words.shape[1] * 4

    @property
    def vsize_classes(self) -> tuple:
        """Distinct per-branch value sizes (bytes), ascending."""
        return tuple(sorted(set(int(v) for v in self.vsizes)))


@dataclass(frozen=True)
class FriLevel:
    root2_words: np.ndarray      # [8] uint32
    column: BranchGroup          # embedded-root tree (root2)
    poly: BranchGroup            # verified against the previous level's root


@dataclass(frozen=True)
class ProofArrays:
    merkle_root_words: np.ndarray    # [8] uint32
    l_merkle_root_words: np.ndarray  # [8] uint32
    fri_levels: list
    points_words: np.ndarray         # [n_points, 8] uint32 (parsed, unused in
                                     # parity mode -- the reference discards
                                     # them, deserializer.rs:47-59)
    main: BranchGroup
    lincomb: BranchGroup
    consumed: int = -1               # bytes consumed by the parse; input may
                                     # carry trailing garbage beyond it


def _bytes_to_words(b: bytes) -> np.ndarray:
    if len(b) % 4:
        raise WireFormatError("byte length not word aligned")
    return np.frombuffer(b, dtype="<u4").astype(np.uint32)


class _Reader:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise WireFormatError(
                f"truncated proof: need {n} bytes at offset {self.off}")
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")


def _parse_multiproof(r: _Reader) -> BranchGroup:
    n = r.u32()
    if n == 0 or n > 1 << 20:
        raise WireFormatError(f"implausible branch count {n}")
    values, siblings, witnesses = [], [], []
    vsizes = np.zeros(n, dtype=np.uint32)
    depths = np.zeros(n, dtype=np.uint32)
    for i in range(n):
        vsize = r.u32()
        if vsize == 0 or vsize % 32:
            raise WireFormatError(f"bad value size {vsize}")
        if vsize > 1 << 16:
            raise WireFormatError(f"implausible value size {vsize}")
        vsizes[i] = vsize
        values.append(_bytes_to_words(r.take(vsize)))
        siblings.append(_bytes_to_words(r.take(vsize)))
        wsize = r.u32()
        if wsize % 32:
            raise WireFormatError("witness bytes not a multiple of 32")
        depth = wsize // 32
        if depth > 64:
            raise WireFormatError(f"implausible witness depth {depth}")
        depths[i] = depth
        witnesses.append(_bytes_to_words(r.take(wsize)).reshape(depth, 8))
    # ragged groups (per-branch vsize/depth, deserializer.rs:104-119) are
    # zero-padded to the group maxima; per-branch sizes ride along
    vw_max = max(v.shape[0] for v in values)
    d_max = max(w.shape[0] for w in witnesses)
    value_arr = np.zeros((n, vw_max), dtype=np.uint32)
    sibling_arr = np.zeros((n, vw_max), dtype=np.uint32)
    witness_arr = np.zeros((n, d_max, 8), dtype=np.uint32)
    for i in range(n):
        value_arr[i, :values[i].shape[0]] = values[i]
        sibling_arr[i, :siblings[i].shape[0]] = siblings[i]
        witness_arr[i, :witnesses[i].shape[0]] = witnesses[i]
    return BranchGroup(
        value_words=value_arr,
        sibling_words=sibling_arr,
        witness_words=witness_arr,
        vsizes=vsizes,
        depths=depths,
    )


def parse_proof(proof_bytes: bytes, allow_trailing: bool = True) -> ProofArrays:
    """Parse one serialized proof. Raises WireFormatError on malformed input.

    allow_trailing=True matches the reference (trailing garbage after a
    well-formed proof verifies); pass False to reject trailing bytes instead.
    Either way the consumed count rides along on the result.
    """
    r = _Reader(proof_bytes)
    merkle_root = _bytes_to_words(r.take(32))
    l_merkle_root = _bytes_to_words(r.take(32))

    fri_levels = []
    points = None
    while True:
        tag = r.u32()
        if tag == 1:  # MERKLE level
            root2 = _bytes_to_words(r.take(32))
            column = _parse_multiproof(r)
            poly = _parse_multiproof(r)
            fri_levels.append(FriLevel(root2, column, poly))
            if len(fri_levels) > 64:
                raise WireFormatError("too many FRI levels")
        elif tag == 2:  # POINTS -- terminates the FRI element loop
            psize = r.u32()
            if psize == 0 or psize % 32:
                raise WireFormatError(f"bad points size {psize}")
            points = _bytes_to_words(r.take(psize)).reshape(psize // 32, 8)
            break
        else:
            raise WireFormatError(f"invalid proof element type {tag}")

    main = _parse_multiproof(r)
    lincomb = _parse_multiproof(r)
    if r.off != len(proof_bytes) and not allow_trailing:
        raise WireFormatError(
            f"{len(proof_bytes) - r.off} trailing bytes after proof")
    return ProofArrays(merkle_root, l_merkle_root, fri_levels, points,
                       main, lincomb, consumed=r.off)


def parse_proof_fast(proof_bytes: bytes,
                     allow_trailing: bool = True) -> ProofArrays:
    """Parse with the native C scanner (native/wire_parser.c): the same
    output and error model as parse_proof.  Raises RuntimeError if the
    scanner cannot be built; it never falls back to the walker."""
    from .. import native
    return native.parse_proof_native(proof_bytes, allow_trailing)


def validate_proof(p: ProofArrays, cfg) -> None:
    """Check a parsed proof's structure against a statement family's shapes.

    Raises WireFormatError on any mismatch (level count, group widths, value
    sizes -- main.rs:50,120-123 pin these with panicking asserts in the
    reference); witness depths stay free except depth 0, which no committed
    tree can produce (the permute-4 shuffle needs >= 4 leaves,
    merkle_tree.rs:112).
    """
    nlv = len(p.fri_levels)
    if nlv != cfg.fri_levels:
        raise WireFormatError(
            f"proof has {nlv} FRI levels; family expects {cfg.fri_levels}")
    q = cfg.fri_queries

    def check_group(g: BranchGroup, name: str, n: int, vsize: int):
        if g.n != n:
            raise WireFormatError(
                f"{name}: {g.n} branches; family expects {n}")
        if g.vsize_classes != (vsize,):
            raise WireFormatError(
                f"{name}: value sizes {g.vsize_classes}; family expects "
                f"{vsize}-byte values")
        if int(g.depths.min()) < 1:
            raise WireFormatError(f"{name}: zero-depth witness")

    for l, lv in enumerate(p.fri_levels):
        check_group(lv.column, f"FRI level {l} column", q, 32)
        check_group(lv.poly, f"FRI level {l} poly", 4 * q, 32)
    check_group(p.main, "main branches", 2 * cfg.spot_checks, 96)
    check_group(p.lincomb, "lincomb branches", cfg.spot_checks, 32)
    npoints = p.points_words.shape[0]
    if npoints != cfg.fri_final_domain:
        raise WireFormatError(
            f"POINTS element has {npoints} values; family expects "
            f"{cfg.fri_final_domain}")


def parse_and_validate(proof_bytes: bytes, cfg) -> ProofArrays:
    """Parse (native scanner) + family-shape validation in one step.  Strict
    mode also rejects trailing bytes."""
    p = parse_proof_fast(proof_bytes, allow_trailing=not cfg.strict)
    validate_proof(p, cfg)
    return p
