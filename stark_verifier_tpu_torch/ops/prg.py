"""Fiat-Shamir pseudorandom index derivation, batched.

Replicates the reference PRG bit-for-bit (src/utils.rs:53-94):

  * the seed (a Merkle root) is used raw as the first 32 bytes of the stream
    -- it is NOT hashed first (utils.rs:67)
  * the stream extends by chaining Blake2s over the previous 32-byte entry
  * each index consumes 4 stream bytes read BIG-endian (utils.rs:79-85)
  * with exclude_multiples_of = e: reduce mod real_modulus = m*(e-1)/e, then
    remap x -> 1 + x + x/(e-1) to skip multiples of e (utils.rs:89-91)

The chain is sequential per seed (<= 10 links for this protocol) but runs
batched across proofs and seeds.  Indices are returned as int64 (every value
is < 2^32): the stream words are full 32-bit patterns, and `%` / `//` on a
negative int32 would be wrong, so they widen before the reduction.
"""

from __future__ import annotations

import torch

from . import blake2s, blake2s_cuda
from .field import bswap32


def chain_entries(seed_words: torch.Tensor, n_entries: int) -> torch.Tensor:
    """seed_words [..., 8] -> [..., n_entries, 8]: the raw seed followed by
    n_entries-1 Blake2s chain links (the seed itself is the first stream
    entry, NOT hashed first -- utils.rs:67-70).  Chains with different seeds
    batch along the leading dims, so stacking every chain the protocol needs
    steps them together: on the card, one launch of the chain kernel
    (ops/blake2s_cuda.py); on the CPU, the plain version."""
    if seed_words.device.type == "cpu":
        return chain_entries_plain(seed_words, n_entries)
    return blake2s_cuda.chain_entries(seed_words, n_entries - 1)


def chain_entries_plain(seed_words: torch.Tensor,
                        n_entries: int) -> torch.Tensor:
    """Plain version of chain_entries: one plain hash a link, on whatever
    device the tensor lies."""
    entries = [seed_words]
    cur = seed_words
    for _ in range(n_entries - 1):
        cur = blake2s.hash_words_plain(cur, 32)
        entries.append(cur)
    return torch.stack(entries, dim=-2)


def indices_from_entries(entries: torch.Tensor, count: int, modulus,
                         exclude_multiples_of: int | None = None) -> torch.Tensor:
    """entries [..., n_entries, 8] (from chain_entries) -> [..., count] int64
    indices: 4 stream bytes per index read big-endian, reduced mod
    real_modulus = m*(e-1)/e, remapped to skip multiples of e
    (utils.rs:79-91).  modulus: python int or an integer tensor broadcastable
    against [..., count]."""
    # a host int stays one: a tensor made of it would be a copy to the card,
    # which a CUDA graph cannot capture
    m = modulus.to(torch.int64) if isinstance(modulus, torch.Tensor) \
        else int(modulus)
    if exclude_multiples_of is not None:
        e = exclude_multiples_of
        real_modulus = (m // e) * (e - 1)
    else:
        real_modulus = m
    stream = entries.reshape(*entries.shape[:-2], -1)[..., :count]
    x = (bswap32(stream).to(torch.int64) & 0xFFFFFFFF) % real_modulus
    if exclude_multiples_of is not None:
        x = 1 + x + x // (exclude_multiples_of - 1)
    return x


def pseudorandom_indices(seed_words: torch.Tensor, count: int, modulus,
                         exclude_multiples_of: int | None = None) -> torch.Tensor:
    """seed_words: [..., 8] -> [..., count] int64 indices.

    `modulus` may be a python int or a tensor (must be divisible by
    exclude_multiples_of when excluding, true for every protocol domain)."""
    entries = chain_entries(seed_words, -(-count // 8))
    return indices_from_entries(entries, count, modulus, exclude_multiples_of)
