"""Merkle branch walks on the card: walk_leaf_levels (kernel A) and
chain_levels (kernel B), each with its plain PyTorch version.

Counterpart of the JAX package's ops/merkle_pallas.py.  The kernels live in
csrc/merkle_walk.cu: one thread per branch, reading the branch's rows straight
from the proof tree's layout.  A wrapper launches its kernel for a CUDA
tensor (or raises) and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import torch

from .. import _build
from . import blake2s

# launches per kernel since the last reset (chip_smoke.py reads these)
launches = {"walk_leaf_levels": 0, "chain_levels": 0}


def _check_words(t: torch.Tensor, name: str, dev: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")


def _dense(t: torch.Tensor, name: str) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    return t


def _witness_stride(wit: torch.Tensor, nlead: int, levels: int) -> int:
    """Word stride between consecutive branches of a witness view
    [*lead, >=levels, 8] whose rows are dense (8 contiguous words, levels 8
    words apart) and whose leading dims collapse to one stride."""
    if wit.dim() != nlead + 2 or wit.shape[-1] != 8 or wit.shape[-2] < levels:
        raise ValueError(f"witness: bad shape {tuple(wit.shape)}")
    if wit.stride(-1) != 1 or (wit.shape[-2] > 1 and wit.stride(-2) != 8):
        raise ValueError("witness: level rows must be dense")
    stride = wit.stride(nlead - 1) if nlead else 0
    for d in range(nlead - 1):
        if wit.shape[d] > 1 and wit.stride(d) != wit.stride(d + 1) * wit.shape[d + 1]:
            raise ValueError("witness: leading dims do not collapse to one stride")
    if wit.data_ptr() % 16 or stride % 4:
        raise ValueError("witness: rows must be 16-byte aligned")
    return stride


def _chain_plain(res, witness_words, ti, levels):
    for k in range(levels):
        w = witness_words[..., k, :]
        odd = ((ti & 1) != 0)[..., None]
        res = blake2s.hash_pair(torch.where(odd, w, res),
                                torch.where(odd, res, w))
        ti = ti >> 1
    return res


def walk_leaf_levels_plain(value_words, sibling_words, witness_words,
                           tree_index, levels: int):
    """Plain version of walk_leaf_levels: the leaf pair-hash, then a loop of
    blake2s.hash_pair ordered by index parity."""
    odd = ((tree_index & 1) != 0)[..., None]
    res = blake2s.hash_leaf_pair(torch.where(odd, sibling_words, value_words),
                                 torch.where(odd, value_words, sibling_words))
    # tree indices are < 2^31, so the int32 shift is the unsigned one
    return _chain_plain(res, witness_words, tree_index >> 1, levels)


def chain_levels_plain(h, witness_words, tree_index, levels: int):
    """Plain version of chain_levels."""
    return _chain_plain(h, witness_words, tree_index, levels)


def walk_leaf_levels(value_words, sibling_words, witness_words, tree_index,
                     levels: int):
    """Leaf hash + the first `levels` witness levels of a RECTANGULAR group.

    value/sibling [..., vw] (vw = 8 or 24); witness_words [..., >=levels, 8];
    tree_index [...] the 2^(w+2)+permuted start index (int32, < 2^31).
    Returns the [..., 8] digests after `levels` halvings past the leaf (the
    caller continues with ti >> (levels+1))."""
    if value_words.device.type == "cpu":
        return walk_leaf_levels_plain(value_words, sibling_words,
                                      witness_words, tree_index, levels)
    dev = value_words.device
    lead = value_words.shape[:-1]
    vw = value_words.shape[-1]
    for t, name in ((value_words, "value"), (sibling_words, "sibling"),
                    (witness_words, "witness"), (tree_index, "tree_index")):
        _check_words(t, name, dev)
    if vw not in (8, 24):
        raise ValueError(f"value width {vw} words: the kernel takes 8 or 24")
    if sibling_words.shape != value_words.shape or tree_index.shape != lead:
        raise ValueError("value / sibling / tree_index shapes disagree")
    if witness_words.shape[:-2] != lead:
        raise ValueError("witness leading dims disagree with value")
    stride = _witness_stride(witness_words, len(lead), levels)
    out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_walk_leaf_levels(
            _dense(value_words, "value").data_ptr(),
            _dense(sibling_words, "sibling").data_ptr(),
            witness_words.data_ptr(), stride,
            _dense(tree_index, "tree_index").data_ptr(), out.data_ptr(),
            vw, levels, out.numel() // 8,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_walk_leaf_levels")
    launches["walk_leaf_levels"] += 1
    return out


def chain_levels(h, witness_words, tree_index, levels: int):
    """`levels` witness levels from running digests h [..., 8]; tree_index is
    the CURRENT (already-halved) index.  witness_words [..., >=levels, 8] may
    be a strided view (a level slice of one branch in four).  Returns the
    [..., 8] digests."""
    if h.device.type == "cpu":
        return chain_levels_plain(h, witness_words, tree_index, levels)
    dev = h.device
    lead = h.shape[:-1]
    for t, name in ((h, "h"), (witness_words, "witness"),
                    (tree_index, "tree_index")):
        _check_words(t, name, dev)
    if h.shape[-1] != 8 or tree_index.shape != lead:
        raise ValueError("h / tree_index shapes disagree")
    if witness_words.shape[:-2] != lead:
        raise ValueError("witness leading dims disagree with h")
    stride = _witness_stride(witness_words, len(lead), levels)
    out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_chain_levels(
            _dense(h, "h").data_ptr(), witness_words.data_ptr(), stride,
            _dense(tree_index, "tree_index").data_ptr(), out.data_ptr(),
            levels, out.numel() // 8,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_chain_levels")
    launches["chain_levels"] += 1
    return out
