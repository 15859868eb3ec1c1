"""Batched Blake2s in plain integer torch: one compression per block.

Replaces the reference verifier's `blake2` crate usage
(src/merkle_tree.rs:127-163, src/main.rs:131-146, src/utils.rs:54-78).  Every
hash in the protocol is unkeyed, 32-byte-digest Blake2s over one of four fixed
input sizes:

  * 32 bytes  -- Fiat-Shamir chain links (utils.rs:70)
  * 33 bytes  -- k1..k4 coefficient derivation (main.rs:133-144)
  * 64 bytes  -- Merkle node hashes (merkle_tree.rs:131-160)
  * 192 bytes -- main-trace leaf hashes (96-byte P||D||B values, main.rs:171)

Words are int32 tensors holding uint32 bit patterns.  Addition and xor are
the same bits in either reading (int32 addition wraps); only the rotate's
right shift differs, so it masks off the sign extension.  The working state is
a [..., 4, 4] matrix as four [..., 4] rows; the column and diagonal half-rounds
are G-functions applied to whole rows (the classic 4-lane formulation), which
keeps a compression at a few hundred tensor ops.

hash_words dispatches by device and nothing else: a CUDA tensor takes one
launch of the narrow-hash kernel (ops/blake2s_cuda.py, csrc/blake2s_hash.cu),
a CPU tensor the plain version here (hash_words_plain), which the plain walks
of ops/merkle_cuda.py call directly.  On the card that kernel hashes the
narrow parts of the verifier (k-hashes, dense Merkle tails; the index chains
through ops/prg.chain_entries); the wide Merkle levels run in the kernels of
ops/merkle_cuda.py, which carry the same compression (csrc/blake2s.cuh).
"""

from __future__ import annotations

import numpy as np
import torch

from . import blake2s_cuda

IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)

# Parameter block word 0 for digest_length=32, key=0, fanout=1, depth=1
_PARAM0 = np.uint32(0x01010020)
H0 = IV.copy()
H0[0] ^= _PARAM0

SIGMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
], dtype=np.int32)

# Message-schedule gather for the 4-lane formulation: per round the column
# step's x/y words, then the diagonal step's x/y words -> one [160] index
# vector, gathered once per compression.
_SCHED = np.concatenate(
    [np.concatenate([SIGMA[r, 0:8:2], SIGMA[r, 1:8:2],
                     SIGMA[r, 8:16:2], SIGMA[r, 9:16:2]]) for r in range(10)])


def _i32(words) -> np.ndarray:
    return np.asarray(words, dtype=np.uint32).view(np.int32)


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    # logical right shift of the uint32 bit pattern held in an int32
    return ((x >> r) & ((1 << (32 - r)) - 1)) | (x << (32 - r))


def _g(a, b, c, d, x, y):
    a = a + b + x
    d = _rotr(d ^ a, 16)
    c = c + d
    b = _rotr(b ^ c, 12)
    a = a + b + y
    d = _rotr(d ^ a, 8)
    c = c + d
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _roll(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.roll(x, k, dims=-1)


def compress(h: torch.Tensor, m: torch.Tensor, t: int, last: bool) -> torch.Tensor:
    """One Blake2s compression: h [..., 8], m [..., 16] -> new h [..., 8].

    t: static byte counter after this block; last: static final-block flag.
    """
    lead = m.shape[:-1]
    dev = m.device
    h = h.expand(lead + (8,))
    a = h[..., 0:4]
    b = h[..., 4:8]
    c = torch.from_numpy(_i32(IV[0:4])).to(dev).expand(lead + (4,))
    dvec = IV[4:8].copy()
    dvec[0] ^= np.uint32(t & 0xFFFFFFFF)
    dvec[1] ^= np.uint32(t >> 32)
    if last:
        dvec[2] ^= np.uint32(0xFFFFFFFF)
    d = torch.from_numpy(_i32(dvec)).to(dev).expand(lead + (4,))

    sched = m[..., torch.from_numpy(_SCHED).to(dev)]          # [..., 160]
    for r in range(10):
        s = sched[..., 16 * r:16 * r + 16]
        a, b, c, d = _g(a, b, c, d, s[..., 0:4], s[..., 4:8])
        # diagonalize: rotate rows so diagonals align as columns
        b, c, d = _roll(b, -1), _roll(c, -2), _roll(d, -3)
        a, b, c, d = _g(a, b, c, d, s[..., 8:12], s[..., 12:16])
        b, c, d = _roll(b, 1), _roll(c, 2), _roll(d, 3)

    return h ^ torch.cat([a, b], dim=-1) ^ torch.cat([c, d], dim=-1)


def hash_words(words: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Blake2s-256 digest of a message given as [..., W] int32 LE words.

    nbytes is the true (static) message length; words beyond it must be
    zero-padded by the caller (W >= ceil(nbytes/4)).  Returns [..., 8]:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if words.device.type == "cpu":
        return hash_words_plain(words, nbytes)
    return blake2s_cuda.hash_words(words, nbytes)


def hash_words_plain(words: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain version of hash_words: one compression of tensor ops a block,
    on whatever device the tensor lies."""
    W = words.shape[-1]
    if W * 4 < nbytes:
        raise ValueError(f"hash_words: {W} words cannot hold {nbytes} bytes")
    nblocks = max(1, -(-nbytes // 64))
    lead = words.shape[:-1]
    h = torch.from_numpy(_i32(H0)).to(words.device).expand(lead + (8,))
    for blk in range(nblocks):
        lo = blk * 16
        hi = min(lo + 16, W)
        m = words[..., lo:hi]
        if hi - lo < 16:
            m = torch.nn.functional.pad(m, (0, 16 - (hi - lo)))
        is_last = blk == nblocks - 1
        t = nbytes if is_last else (blk + 1) * 64
        h = compress(h, m, t, is_last)
    return h


def hash_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H(a || b) for two [..., 8]-word (32-byte) inputs -> [..., 8].
    The Merkle node hash (reference: src/merkle_tree.rs:131-141)."""
    return hash_words(torch.cat([a, b], dim=-1), 64)


def hash_leaf_pair(value: torch.Tensor, sibling: torch.Tensor) -> torch.Tensor:
    """H(value || sibling) for equal-width word inputs of any static size."""
    vw = value.shape[-1]
    return hash_words(torch.cat([value, sibling], dim=-1), 8 * vw)


def hash_chain(h32: torch.Tensor) -> torch.Tensor:
    """H(x) of a 32-byte input -- the Fiat-Shamir PRG link
    (reference: src/utils.rs:70)."""
    return hash_words(h32, 32)


def hash_root_byte(root: torch.Tensor, byte_val: int) -> torch.Tensor:
    """H(root || [b]) of 33 bytes -- k-coefficient derivation
    (reference: src/main.rs:131-146).  root [..., 8] words; byte_val the
    one byte after it (0..255).  Returns [..., 8]."""
    tail = torch.full(root.shape[:-1] + (1,), byte_val, dtype=torch.int32,
                      device=root.device)
    return hash_words(torch.cat([root, tail], dim=-1), 33)
