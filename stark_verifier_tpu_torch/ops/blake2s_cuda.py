"""The glue's narrow Blake2s hashes on the card: hash_words and
chain_entries, each one launch of csrc/blake2s_hash.cu.

ops/blake2s.hash_words and ops/prg.chain_entries dispatch here for a CUDA
tensor and run their plain versions (blake2s.hash_words_plain,
prg.chain_entries_plain) for a CPU tensor, with no switch in between.  The
kernel takes a message of any width W and length nbytes <= 4 W and any
leading shape: one thread a message, the words read as they are given, so
that kernel and plain version agree word for word on any input.  In chain
mode a thread hashes its 32-byte seed `links` times and writes every entry.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# launches per mode since the last reset (chip_smoke.py and the verify span
# read these)
launches = {"hash_words": 0, "hash_chain": 0}


def _launch(words: torch.Tensor, nbytes: int, links, lib) -> torch.Tensor:
    """One launch over every message of `words` [..., W]; `links` None for
    one digest a message, else the chain mode.  `lib`: a host build of the
    kernels' library for CPU tensors (the tests), by default the card's."""
    name = "hash_words" if links is None else "hash_chain"
    if words.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {words.dtype}")
    if words.dim() < 1 or words.shape[-1] < 1:
        raise ValueError(f"{name}: expected [..., W] words, got "
                         f"{tuple(words.shape)}")
    W = words.shape[-1]
    if not 0 <= nbytes <= 4 * W:
        raise ValueError(f"{name}: {W} words cannot hold {nbytes} bytes")
    if links is not None and (W != 8 or links < 0):
        raise ValueError(f"{name}: a chain takes [..., 8] seeds and links "
                         f">= 0, got {tuple(words.shape)} and {links}")
    dev = words.device
    if (dev.type == "cuda") == (lib is not None):
        raise ValueError(f"{name}: a tensor on {dev}: the kernel takes a "
                         "CUDA tensor (a CPU one only with a host build)")
    lead = tuple(words.shape[:-1])
    shape = lead + ((8,) if links is None else (links + 1, 8))
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    src = words.contiguous()
    args = _build.HashArgs(src=src.data_ptr(), dst=out.data_ptr(),
                           n=src.numel() // W, words=W, nbytes=nbytes,
                           chain=int(links is not None),
                           links=links or 0)
    if lib is None:
        lib = _build.load()
        with torch.cuda.device(dev):
            rc = lib.stark_hash_words(
                ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    else:
        rc = lib.stark_hash_words(ctypes.byref(args), None)
    _build.check(rc, "stark_hash_words")
    launches[name] += 1
    return out


def hash_words(words: torch.Tensor, nbytes: int, lib=None) -> torch.Tensor:
    """Blake2s-256 digests of the messages [..., W] int32 LE words of
    `nbytes` bytes each -> [..., 8], one launch.  Words past nbytes are
    hashed as given (the caller zero-pads them)."""
    return _launch(words, nbytes, None, lib)


def chain_entries(seed_words: torch.Tensor, links: int,
                  lib=None) -> torch.Tensor:
    """seed_words [..., 8] -> [..., links + 1, 8]: each seed followed by its
    `links` Blake2s chain links, one launch."""
    return _launch(seed_words, 32, links, lib)
