"""Merkle branch walks on the card: walk_leaf_levels (kernel A),
walk_quads (kernel B) and walk_branches (kernel F), each with its plain
PyTorch version.

Counterpart of the JAX package's ops/merkle_pallas.py.  A and B are the
full-width lower levels of the shared-path walk (ops/merkle._shared_bottom):
A for plain groups, B for the FRI poly groups, whose branches come in
sibling quads and which B walks from the quads' leaves (the JAX package's
chain_levels starts from digests that plain JAX hashed first).  F is the
whole independent walk of a branch with its own depth, which
ops/merkle.verify_branches runs for unshared and ragged groups.  The kernels
live in csrc/merkle_walk.cu: one thread per branch (per quad for B), reading
the rows straight from the proof tree's layout.  Each walks a list of groups
in one launch (walk_leaf_levels_groups, walk_quads_groups,
walk_branches_groups); the one-group wrappers are such lists of one.  A
wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version only for a CPU tensor.
"""

from __future__ import annotations

import torch

from .. import _build
from . import blake2s

# launches per kernel since the last reset (chip_smoke.py reads these)
launches = {"walk_leaf_levels": 0, "walk_quads": 0, "walk_branches": 0}

# groups a launch of A, B or F (csrc/merkle_walk.cu: STARK_WALK_MAX_GROUPS)
MAX_GROUPS = 32


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


def _pair_plain(left, right):
    """H(left || right) of two equal-width word inputs by the plain hash,
    on whatever device they lie (the plain walks never launch a kernel)."""
    return blake2s.hash_words_plain(torch.cat([left, right], dim=-1),
                                    8 * left.shape[-1])


def _chain_plain(res, witness_words, ti, levels):
    for k in range(levels):
        w = witness_words[..., k, :]
        odd = ((ti & 1) != 0)[..., None]
        res = _pair_plain(torch.where(odd, w, res),
                          torch.where(odd, res, w))
        ti = ti >> 1
    return res


def walk_leaf_levels_plain(value_words, sibling_words, witness_words,
                           tree_index, levels: int):
    """Plain version of walk_leaf_levels: the leaf pair-hash, then a loop of
    pair hashes ordered by index parity."""
    odd = ((tree_index & 1) != 0)[..., None]
    res = _pair_plain(torch.where(odd, sibling_words, value_words),
                      torch.where(odd, value_words, sibling_words))
    # tree indices are < 2^31, so the int32 shift is the unsigned one
    return _chain_plain(res, witness_words, tree_index >> 1, levels)


def chain_levels_plain(h, witness_words, tree_index, levels: int):
    """`levels` witness levels from running digests h [..., 8]; tree_index
    is the CURRENT (already halved) index: the JAX package's chain_levels,
    whose work kernel B does after the quads' leaves."""
    return _chain_plain(h, witness_words, tree_index, levels)


def walk_quads_plain(value_words, sibling_words, witness_words, tree_index,
                     levels: int):
    """Plain version of walk_quads: the quads' two leaf pair-hashes, the
    first-level check, their combine, then chain_levels_plain."""
    lead4 = value_words.shape[:-2] + (value_words.shape[-2] // 4, 4)
    val4 = value_words.reshape(lead4 + value_words.shape[-1:])
    sib4 = sibling_words.reshape(lead4 + sibling_words.shape[-1:])
    wit4 = witness_words.reshape(lead4 + witness_words.shape[-2:])
    # branches 0 and 2 of every quad in one call: their tree indices are even
    n0123 = _pair_plain(val4[..., 0::2, :], sib4[..., 0::2, :])
    n01, n23 = n0123[..., 0, :], n0123[..., 1, :]
    w0 = wit4[..., 0, :]                        # [..., q, 4, 8]
    ok = ((w0[..., 0:2, :] == n23[..., None, :]).all(dim=-1).all(dim=-1)
          & (w0[..., 2:4, :] == n01[..., None, :]).all(dim=-1).all(dim=-1))
    res = _pair_plain(n01, n23)
    ti = tree_index.reshape(lead4)[..., 0] >> 2
    return (_chain_plain(res, wit4[..., 0, 1:, :], ti, levels),
            ok.to(torch.int32))


def _launch(entry: str, name: str, descs: list, dev) -> None:
    """The grouped walk `entry` over the descriptors, MAX_GROUPS a launch."""
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k in range(0, len(descs), MAX_GROUPS):
            part = descs[k:k + MAX_GROUPS]
            rc = getattr(lib, entry)((_build.WalkGroup * len(part))(*part),
                                     len(part), stream)
            _build.check(rc, entry)
            launches[name] += 1


def _group(value, sibling, witness, tree_index, depth, out, vstride: int,
           wit_stride: int, levels: int) -> "_build.WalkGroup":
    return _build.WalkGroup(
        value.data_ptr(), sibling.data_ptr(), witness.data_ptr(),
        tree_index.data_ptr(), None if depth is None else depth.data_ptr(),
        out.data_ptr(), vstride, wit_stride, out.numel() // 8,
        value.shape[-1], levels, 0)


def walk_leaf_levels_groups(groups: list) -> list:
    """walk_leaf_levels over several groups in one launch of kernel A.

    groups: (value, sibling, witness, tree_index, levels) tuples, each as
    walk_leaf_levels takes them.  Returns one [..., 8] digest tensor a group.
    On the CPU, the plain version group by group."""
    if not groups:
        return []
    dev = groups[0][0].device
    if dev.type == "cpu":
        return [walk_leaf_levels_plain(*g) for g in groups]
    descs, outs = [], []
    for value_words, sibling_words, witness_words, tree_index, levels in groups:
        lead = value_words.shape[:-1]
        vw = value_words.shape[-1]
        for t, name in ((value_words, "value"), (sibling_words, "sibling"),
                        (witness_words, "witness"),
                        (tree_index, "tree_index")):
            _check_words(t, name, dev)
        if vw not in (8, 24):
            raise ValueError(f"value width {vw} words: the kernel takes 8 or 24")
        if sibling_words.shape != value_words.shape or tree_index.shape != lead:
            raise ValueError("value / sibling / tree_index shapes disagree")
        if witness_words.shape[:-2] != lead:
            raise ValueError("witness leading dims disagree with value")
        stride = _witness_stride(witness_words, len(lead), levels)
        out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
        outs.append(out)
        if out.numel():
            descs.append(_group(
                _dense(value_words, "value"), _dense(sibling_words, "sibling"),
                witness_words, _dense(tree_index, "tree_index"), None, out,
                vw, stride, levels))
    if descs:
        _launch("stark_walk_leaf_levels_groups", "walk_leaf_levels", descs,
                dev)
    return outs


def walk_leaf_levels(value_words, sibling_words, witness_words, tree_index,
                     levels: int):
    """Leaf hash + the first `levels` witness levels of a RECTANGULAR group.

    value/sibling [..., vw] (vw = 8 or 24); witness_words [..., >=levels, 8];
    tree_index [...] the 2^(w+2)+permuted start index (int32, < 2^31).
    Returns the [..., 8] digests after `levels` halvings past the leaf (the
    caller continues with ti >> (levels+1)).  A one-group launch of
    walk_leaf_levels_groups."""
    return walk_leaf_levels_groups(
        [(value_words, sibling_words, witness_words, tree_index, levels)])[0]


def walk_quads_groups(groups: list) -> list:
    """walk_quads over several groups in one launch of kernel B.

    groups: (value, sibling, witness, tree_index, levels) tuples, each as
    walk_quads takes them.  Returns one (digests [..., q, 8], ok [..., q])
    pair a group.  On the CPU, the plain version group by group."""
    if not groups:
        return []
    dev = groups[0][0].device
    if dev.type == "cpu":
        return [walk_quads_plain(*g) for g in groups]
    descs, outs = [], []
    for value_words, sibling_words, witness_words, tree_index, levels in groups:
        lead = value_words.shape[:-1]
        vw = value_words.shape[-1]
        for t, name in ((value_words, "value"), (sibling_words, "sibling"),
                        (witness_words, "witness"),
                        (tree_index, "tree_index")):
            _check_words(t, name, dev)
        if vw != 8:
            raise ValueError(f"value width {vw} words: the kernel takes 8")
        if not lead or lead[-1] % 4:
            raise ValueError("walk_quads: the branch count must be a "
                             "multiple of 4")
        if sibling_words.shape != value_words.shape or tree_index.shape != lead:
            raise ValueError("value / sibling / tree_index shapes disagree")
        if witness_words.shape[:-2] != lead:
            raise ValueError("witness leading dims disagree with value")
        # every quad's first witness row, then `levels` rows of its branch 0
        stride = _witness_stride(witness_words, len(lead), levels + 1)
        quads = lead[:-1] + (lead[-1] // 4,)
        out = torch.empty(quads + (8,), dtype=torch.int32, device=dev)
        ok = torch.empty(quads, dtype=torch.int32, device=dev)
        outs.append((out, ok))
        if out.numel():
            desc = _group(
                _dense(value_words, "value"), _dense(sibling_words, "sibling"),
                witness_words, _dense(tree_index, "tree_index"), None, out,
                vw, stride, levels)
            desc.ok = ok.data_ptr()
            descs.append(desc)
    if descs:
        _launch("stark_walk_quads_groups", "walk_quads", descs, dev)
    return outs


def walk_quads(value_words, sibling_words, witness_words, tree_index,
               levels: int):
    """The sibling quads of a RECTANGULAR group from their leaves: branches
    4q .. 4q+3 of the last leading dim are the four leaves of one level-2
    node, branch 4q's tree index is even (4-aligned), and b's sibling is b+1's
    value (the caller checks both).

    value/sibling [..., 4q, 8] (the plain version takes any width);
    witness_words [..., 4q, >=levels+1, 8]; tree_index [..., 4q] the
    2^(w+2)+permuted start index (int32, < 2^31).  Returns (digests
    [..., q, 8] after the combine and
    `levels` more levels of branch 4q's witness, ok [..., q] int32: 1 where
    branches 4q, 4q+1 carry H(v2 || s2) and 4q+2, 4q+3 carry H(v0 || s0) as
    their first witness, else 0).  A one-group launch of
    walk_quads_groups."""
    return walk_quads_groups(
        [(value_words, sibling_words, witness_words, tree_index, levels)])[0]


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
    res = _pair_plain(torch.where(odd, sibling_words, value_words),
                      torch.where(odd, value_words, sibling_words))
    ti = ti >> 1
    for k in range(max_depth):
        w = witness_words[..., k, :]
        odd = ((ti & 1) != 0)[..., None]
        nres = _pair_plain(torch.where(odd, w, res),
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


def _branch_table(groups: list, dev) -> tuple:
    """(descriptors, digest tensors, rows) of kernel F's launch over
    `groups`.  `rows` holds the dense copies _branch_rows made: the
    descriptors point into them, so they must outlive the launch."""
    descs, outs, rows = [], [], []
    for value_words, sibling_words, witness_words, tree_index, depth in groups:
        lead = value_words.shape[:-1]
        vw = value_words.shape[-1]
        for t, name in ((value_words, "value"), (sibling_words, "sibling"),
                        (witness_words, "witness"), (tree_index, "tree_index"),
                        (depth, "depth")):
            _check_words(t, name, dev)
        if vw < 1:
            raise ValueError("value width must be at least one word")
        if (sibling_words.shape != value_words.shape
                or tree_index.shape != lead or depth.shape != lead):
            raise ValueError(
                "value / sibling / tree_index / depth shapes disagree")
        if witness_words.shape[:-2] != lead:
            raise ValueError("witness leading dims disagree with value")
        max_depth = witness_words.shape[-2]
        stride = _witness_stride(witness_words, len(lead), max_depth)
        value_words, sibling_words, vstride = _branch_rows(
            value_words, sibling_words, len(lead))
        rows.append((value_words, sibling_words))
        out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
        outs.append(out)
        if out.numel():
            descs.append(_group(
                value_words, sibling_words, witness_words,
                _dense(tree_index, "tree_index"), _dense(depth, "depth"), out,
                vstride if lead else vw, stride, max_depth))
    return descs, outs, rows


def walk_branches_groups(groups: list) -> list:
    """walk_branches over several groups in one launch of kernel F.

    groups: (value, sibling, witness, tree_index, depth) tuples, each as
    walk_branches takes them (the value-size classes of a ragged group may
    be groups of their own).  Returns one [..., 8] digest tensor a group.
    On the CPU, the plain version group by group."""
    if not groups:
        return []
    dev = groups[0][0].device
    if dev.type == "cpu":
        return [walk_branches_plain(*g) for g in groups]
    descs, outs, rows = _branch_table(groups, dev)
    if descs:
        _launch("stark_walk_branches_groups", "walk_branches", descs, dev)
    del rows        # the launch is queued: the copies may go back to the pool
    return outs


def walk_branches(value_words, sibling_words, witness_words, tree_index,
                  depth):
    """Leaf hash + each branch's OWN number of witness levels: the
    independent walk of ragged and unshared groups.

    value/sibling [..., vw] (any vw >= 1; may be a column slice of wider
    rows); witness_words [..., max_depth, 8], rows past a branch's depth are
    never read; tree_index [...] the 2^(depth+2)+permuted start index and
    depth [...] the branch's witness count, both int32 holding uint32 bit
    patterns.  A depth above max_depth walks max_depth levels.  Returns the
    final [..., 8] digests (the caller compares them with the root).  A
    one-group launch of walk_branches_groups."""
    return walk_branches_groups(
        [(value_words, sibling_words, witness_words, tree_index, depth)])[0]
