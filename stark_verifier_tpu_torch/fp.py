"""Host-side helpers and constants for the 256-bit prime field.

Field: F_p with p = 2^256 - 351*2^32 + 1 (the MiMC-STARK prime; reference
verifier: src/main.rs:29).

Public representation: a field element is 16 little-endian 16-bit limbs
(shape [..., 16]) -- the layout the JAX package uses at its public functions,
kept here so the two packages compare array for array.  Host arrays are numpy
uint32; tensors carry the same values as int32 (see ops/field.py).  The CUDA
kernels repack to 8 x 32-bit limbs internally (csrc/field256.cuh).

Reduction exploits the sparse prime: 2^256 === 351*2^32 - 1 (mod p), so a
wide product is reduced by folding its high part H as H * C with
C = 351*2^32 - 1 (a 41-bit constant), then one conditional subtract of p.

This module is host-only (pure Python/numpy): conversions and constants.
"""

from __future__ import annotations

import numpy as np

# p = 2^256 - 351*2^32 + 1  (reference: src/main.rs:29)
MODULUS = 2**256 - 351 * 2**32 + 1
# 2^256 mod p = 351*2^32 - 1 (41 bits -> 3 limbs)
FOLD_C = 351 * 2**32 - 1

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

EXTENSION_FACTOR = 8


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    """Convert a non-negative int < 2^(16n) to n little-endian u16 limbs (uint32)."""
    if not 0 <= x < (1 << (LIMB_BITS * n)):
        raise ValueError(f"value out of range for {n} limbs")
    out = np.zeros(n, dtype=np.uint32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of int_to_limbs (accepts any 1-D array of limbs)."""
    x = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(arr[i])
    return x


def ints_to_limbs(xs, n: int = NLIMBS) -> np.ndarray:
    """Vector version: list of ints -> [len(xs), n] uint32 limb array."""
    out = np.zeros((len(xs), n), dtype=np.uint32)
    for j, x in enumerate(xs):
        out[j] = int_to_limbs(x, n)
    return out


def ints_to_limbs_fast(xs, n: int = NLIMBS) -> np.ndarray:
    """Bulk int -> limbs via to_bytes + frombuffer (needed for the
    2^12..2^16-entry gather tables)."""
    nbytes = 2 * n
    buf = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").astype(np.uint32).reshape(len(xs), n)


def be_bytes_to_limbs(b: np.ndarray) -> np.ndarray:
    """[..., 32] uint8 big-endian byte view -> [..., 16] uint32 limbs.

    Proof field values are serialized as 32-byte big-endian ints
    (reference: src/main.rs:171-174, BigInt::from_bytes_be).
    """
    b = np.asarray(b, dtype=np.uint32)
    if b.shape[-1] != 32:
        raise ValueError(f"expected 32 trailing bytes, got {b.shape[-1]}")
    # byte pairs, most significant first: limb k (LE) = bytes [30-2k, 31-2k]
    rev = b[..., ::-1]  # little-endian byte order
    lo = rev[..., 0::2]
    hi = rev[..., 1::2]
    return (hi << 8) | lo


def bytes_to_le_words(b: np.ndarray) -> np.ndarray:
    """[..., 4k] uint8 -> [..., k] uint32 little-endian words (Blake2s view)."""
    b = np.asarray(b, dtype=np.uint32)
    if b.shape[-1] % 4:
        raise ValueError(f"byte count {b.shape[-1]} not a multiple of 4")
    b4 = b.reshape(*b.shape[:-1], b.shape[-1] // 4, 4)
    return b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16) | (b4[..., 3] << 24)


def limbs_to_le_words(limbs: np.ndarray) -> np.ndarray:
    """[..., 16] limbs -> [..., 8] uint32 little-endian 32-bit limbs (the
    packed rows the spot-check kernel gathers from)."""
    l = np.asarray(limbs, dtype=np.uint32)
    return np.ascontiguousarray(l[..., 0::2] | (l[..., 1::2] << 16))


def pow2_table(base: int, nbits: int, modulus: int = MODULUS) -> np.ndarray:
    """[nbits, NLIMBS] table of base^(2^i) mod p, for data-dependent exponents."""
    vals = []
    cur = base % modulus
    for _ in range(nbits):
        vals.append(cur)
        cur = cur * cur % modulus
    return ints_to_limbs(vals)


# Limb-array constants (host numpy)
P_LIMBS = int_to_limbs(MODULUS)
FOLD_C_LIMBS = int_to_limbs(FOLD_C, 3)
ONE_LIMBS = int_to_limbs(1)
ZERO_LIMBS = int_to_limbs(0)
