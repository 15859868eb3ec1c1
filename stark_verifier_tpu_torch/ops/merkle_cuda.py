"""Merkle branch walks on the card: walk_leaf_levels (kernel A),
chain_levels (kernel B) and walk_branches (kernel F), each with its plain
PyTorch version.

Counterpart of the JAX package's ops/merkle_pallas.py.  A and B are the
full-width lower levels of the shared-path walk (ops/merkle._shared_bottom);
F is the whole independent walk of a branch with its own depth, which
ops/merkle.verify_branches runs for unshared and ragged groups.  The kernels
live in csrc/merkle_walk.cu: one thread per branch, reading the branch's rows
straight from the proof tree's layout.  A wrapper launches its kernel for a
CUDA tensor (or raises) and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import torch

from .. import _build
from . import blake2s

# launches per kernel since the last reset (chip_smoke.py reads these)
launches = {"walk_leaf_levels": 0, "chain_levels": 0, "walk_branches": 0}


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


def _lead_stride(t: torch.Tensor, nlead: int, name: str,
                 aligned: bool = True) -> int:
    """Word stride between consecutive branches of a view whose first `nlead`
    dims index the branches and collapse to one stride, with 16-byte aligned
    rows (unless `aligned` is False: rows read word by word)."""
    stride = t.stride(nlead - 1) if nlead else 0
    for d in range(nlead - 1):
        if t.shape[d] > 1 and t.stride(d) != t.stride(d + 1) * t.shape[d + 1]:
            raise ValueError(
                f"{name}: leading dims do not collapse to one stride")
    if aligned and (t.data_ptr() % 16 or stride % 4):
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    return stride


def _witness_stride(wit: torch.Tensor, nlead: int, levels: int) -> int:
    """Word stride between consecutive branches of a witness view
    [*lead, >=levels, 8] whose rows are dense (8 contiguous words, levels 8
    words apart) and whose leading dims collapse to one stride."""
    if wit.dim() != nlead + 2 or wit.shape[-1] != 8 or wit.shape[-2] < levels:
        raise ValueError(f"witness: bad shape {tuple(wit.shape)}")
    if wit.stride(-1) != 1 or (wit.shape[-2] > 1 and wit.stride(-2) != 8):
        raise ValueError("witness: level rows must be dense")
    return _lead_stride(wit, nlead, "witness")


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


def walk_branches_plain(value_words, sibling_words, witness_words, tree_index,
                        depth):
    """Plain version of walk_branches: the leaf pair-hash, then max_depth
    masked steps -- a step at or past a branch's depth leaves its digest and
    index as they are."""
    max_depth = witness_words.shape[-2]
    # uint32 bit patterns -> their values, so that >> and < are unsigned
    ti = tree_index.to(torch.int64) & 0xFFFFFFFF
    d = depth.to(torch.int64) & 0xFFFFFFFF
    odd = ((ti & 1) != 0)[..., None]
    res = blake2s.hash_leaf_pair(torch.where(odd, sibling_words, value_words),
                                 torch.where(odd, value_words, sibling_words))
    ti = ti >> 1
    for k in range(max_depth):
        w = witness_words[..., k, :]
        odd = ((ti & 1) != 0)[..., None]
        nres = blake2s.hash_pair(torch.where(odd, w, res),
                                 torch.where(odd, res, w))
        active = k < d
        res = torch.where(active[..., None], nres, res)
        ti = torch.where(active, ti >> 1, ti)
    return res


def _branch_rows(value_words, sibling_words, nlead: int):
    """(value, sibling, word stride between branches) as the independent walk
    reads them: in place where it can, and as dense copies in the one case it
    cannot -- a width read by 16-byte loads (8 or 24 words) in rows that are
    not 16-byte aligned (a column slice of wider rows).  Any other layout the
    kernel cannot read raises."""
    aligned = value_words.shape[-1] in (8, 24)
    if aligned and any(
            t.data_ptr() % 16 or (nlead and t.stride(nlead - 1) % 4)
            for t in (value_words, sibling_words)):
        value_words = value_words.contiguous()
        sibling_words = sibling_words.contiguous()
    if value_words.stride(-1) != 1 or any(
            n > 1 and sv != ss for n, sv, ss in zip(
                value_words.shape, value_words.stride(),
                sibling_words.stride())):
        raise ValueError("value / sibling: rows must be dense and the two "
                         "laid out alike")
    vstride = _lead_stride(value_words, nlead, "value", aligned)
    _lead_stride(sibling_words, nlead, "sibling", aligned)
    return value_words, sibling_words, vstride


def walk_branches(value_words, sibling_words, witness_words, tree_index,
                  depth):
    """Leaf hash + each branch's OWN number of witness levels: the
    independent walk of ragged and unshared groups.

    value/sibling [..., vw] (any vw >= 1; may be a column slice of wider
    rows); witness_words [..., max_depth, 8], rows past a branch's depth are
    never read; tree_index [...] the 2^(depth+2)+permuted start index and
    depth [...] the branch's witness count, both int32 holding uint32 bit
    patterns.  A depth above max_depth walks max_depth levels.  Returns the
    final [..., 8] digests (the caller compares them with the root)."""
    if value_words.device.type == "cpu":
        return walk_branches_plain(value_words, sibling_words, witness_words,
                                   tree_index, depth)
    dev = value_words.device
    lead = value_words.shape[:-1]
    vw = value_words.shape[-1]
    for t, name in ((value_words, "value"), (sibling_words, "sibling"),
                    (witness_words, "witness"), (tree_index, "tree_index"),
                    (depth, "depth")):
        _check_words(t, name, dev)
    if vw < 1:
        raise ValueError("value width must be at least one word")
    if (sibling_words.shape != value_words.shape or tree_index.shape != lead
            or depth.shape != lead):
        raise ValueError("value / sibling / tree_index / depth shapes disagree")
    if witness_words.shape[:-2] != lead:
        raise ValueError("witness leading dims disagree with value")
    max_depth = witness_words.shape[-2]
    stride = _witness_stride(witness_words, len(lead), max_depth)
    value_words, sibling_words, vstride = _branch_rows(
        value_words, sibling_words, len(lead))
    out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_walk_branches(
            value_words.data_ptr(), sibling_words.data_ptr(),
            vstride if lead else vw, vw,
            witness_words.data_ptr(), stride,
            _dense(tree_index, "tree_index").data_ptr(),
            _dense(depth, "depth").data_ptr(), max_depth, out.data_ptr(),
            out.numel() // 8, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_walk_branches")
    launches["walk_branches"] += 1
    return out
