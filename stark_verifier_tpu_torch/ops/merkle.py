"""Batched Merkle multiproof verification: the independent per-branch walk
(verify_branches) and the shared-path walk (verify_groups_shared).

Counterpart of the reference verifier's sequential branch walker
(src/merkle_tree.rs:25-44,101-172): all branches of a group verify in
lockstep instead of one hash at a time.

Bit-exactness quirks replicated:
  * leaf shuffle: with w witnesses, ld4 = 2^(w+1)/4 and the permuted index is
    (x / ld4) + 4*(x mod ld4)                        (merkle_tree.rs:112-116)
  * the start tree index is 2^(w+2) + permuted (NOT the textbook 2^(w+1)), so
    the value/sibling pairing order uses the *index* parity
                                                     (merkle_tree.rs:120-141)
  * each witness level pairs by the halved tree index's parity
                                                     (merkle_tree.rs:145-163)

Instead of asserting on mismatch (merkle_tree.rs:165), a group returns a
boolean verdict so batched verification can reject without aborting.

The reference verifies every branch independently all the way to the root,
so with n branches the top levels of the tree are re-hashed up to n times: at
the level with 2^j nodes there are at most min(n, 2^j) DISTINCT nodes.
verify_groups_shared() walks each group bottom-up at full width (the walk
kernels of ops/merkle_cuda.py) only while the level can still hold n distinct
nodes, then switches to a DENSE node representation: the start indices
2^(w+2)+i occupy one aligned power-of-two interval, so after t halvings the
live keys span exactly [2^(w+2-t), 2^(w+2-t) + 2^(w+1-t)) -- a node's slot is
(key - base), pure arithmetic, and the children of dense slot o are slots 2o
and 2o+1 of the level below.  No sorting, compaction, scatter or gather:
every data-dependent placement is a masked broadcast-compare-reduce.
Accept/reject equivalence with the independent walks is kept by explicit
equality checks wherever a branch's own data stops being used:

  * two branches that reached the same node by the switchover must agree on
    the running hash (state-equality check at tail entry);
  * a branch that shares a node with an earlier branch must supply the same
    witness at every remaining level (per-level witness-equality checks);
  * when two slots merge as siblings, each side's claimed witness must equal
    the other side's computed state (cross-checks) -- then the single
    H(left || right) equals both branches' next hashes.

If every check passes, each branch's independent walk would compute exactly
the slot states, so "final slot == root" decides all of them at once; any
failed check rejects, exactly where the independent walk could only have
reached the root through a Blake2s collision.  The walk requires a
RECTANGULAR group (every branch at the group's full static depth); the depth
guard makes a misrouted ragged group reject, never misverify.  Slot tails of
all groups are stacked per tree level into one compression call.

verify_branches() is that independent walk itself: every branch to the root
with its own witness depth (ragged groups, and the cross-check of the
dedup).  It does the index arithmetic and the root compare; the walk in
between is ops/merkle_cuda.walk_branches.

Words are int32 bit patterns; tree indices and slots are int64 (all < 2^31).
"""

from __future__ import annotations

import torch

from . import blake2s, merkle_cuda

# Dedup the top (TAIL_CAP + 1) tree levels.  2 is inherited: it is the value
# the JAX package takes when its walk kernels are on, from sweeps on other
# hardware.  It has NOT been measured on an H100; a re-sweep there is open.
TAIL_CAP = 2


def _flog2(n: int) -> int:
    return n.bit_length() - 1


def _eq8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


# verify_branches() walks depths 1 .. MAX_BRANCH_DEPTH; outside that range
# the start index 2^(depth+2) + permuted leaves 32 bits (or, at depth 0, the
# shuffle divides by zero), and the branch rejects
MAX_BRANCH_DEPTH = 29


def _u32(t: torch.Tensor) -> torch.Tensor:
    """Values of uint32 bit patterns (int32 storage) as int64; wider integer
    tensors pass through."""
    if t.dtype == torch.int32:
        return t.to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def verify_branches(root_words, indices, value_words, sibling_words,
                    witness_words, depth, vsizes=None, vsize_classes=None):
    """Verify a group of Merkle branches against a root, each branch
    independently and with its own witness depth.

    root_words:    [..., 8] words (broadcast over the branch axis) -- the
                   expected root, or [..., n, 8] for per-branch roots.
    indices:       [..., n] leaf indices (pre-permutation).
    value_words:   [..., n, vw] (vw = 8 for 32-byte leaves, 24 for the
                   96-byte main-trace leaves; ragged groups zero-padded).
    sibling_words: [..., n, vw].
    witness_words: [..., n, max_depth, 8] (zero-padded past `depth`).
    depth:         actual witness count -- python int, or a tensor
                   broadcastable against the branch axis; a batched
                   group-level depth [...] broadcasts over the branches (the
                   reference walks per-branch depth, merkle_tree.rs:119-163).
                   A depth above max_depth walks max_depth levels.  A depth
                   of 0 or above MAX_BRANCH_DEPTH rejects its branch.
    vsizes:        optional [..., n] per-branch value BYTES for ragged value
                   sizes (deserializer.rs:104-119); requires vsize_classes,
                   the static tuple of distinct sizes.  Each class is walked
                   as a group of the launch and selected per branch; a size
                   in no class takes the first class's.

    Returns (ok [..., n] bool, value_words passthrough) -- mirroring
    MultiProof::verify returning the leaf values (merkle_tree.rs:25-44).
    """
    ok = verify_branches_groups([dict(
        root=root_words, indices=indices, value=value_words,
        sibling=sibling_words, witness=witness_words, depth=depth,
        vsizes=vsizes, vsize_classes=vsize_classes)])[0]
    return ok, value_words.contiguous()


def verify_branches_groups(groups: list) -> list:
    """verify_branches over several groups, all walked in one launch of
    kernel F (ops/merkle_cuda.walk_branches_groups).

    groups: dicts with the arguments of verify_branches by name (root,
    indices, value, sibling, witness, depth; optional vsizes and
    vsize_classes).  Returns one ok [..., n] bool tensor a group."""
    walks, plans = [], []
    for g in groups:
        indices = g["indices"]
        dev = indices.device
        d = _u32(torch.as_tensor(g["depth"], device=dev))
        if d.dim() and d.dim() < indices.dim():
            d = d[..., None]
        d = d.expand(indices.shape)
        valid = (d >= 1) & (d <= MAX_BRANCH_DEPTH)
        ds = d.clamp(1, MAX_BRANCH_DEPTH)

        # uint32 arithmetic, as the reference's: int64 masked to 32 bits
        ind = _u32(indices)
        ld4 = 1 << (ds - 1)                      # 2^(w+1) / 4
        idx = ((ind // ld4) + 4 * (ind % ld4)) & 0xFFFFFFFF
        tree_index = (((1 << (ds + 2)) + idx) & 0xFFFFFFFF).to(torch.int32)
        depth32 = ds.to(torch.int32).contiguous()

        value = g["value"].contiguous()
        sibling = g["sibling"].contiguous()
        classes = g.get("vsize_classes") if g.get("vsizes") is not None \
            else None
        widths = [value.shape[-1]] if classes is None else \
            [cls // 4 for cls in classes]        # static byte sizes
        plans.append((g, valid, classes, len(walks)))
        walks += [(value[..., :vw], sibling[..., :vw], g["witness"],
                   tree_index, depth32) for vw in widths]

    hs = merkle_cuda.walk_branches_groups(walks)
    oks = []
    for g, valid, classes, at in plans:
        res = hs[at]
        if classes is not None:
            vs = _u32(g["vsizes"])
            for k, cls in enumerate(classes[1:], start=1):
                res = torch.where((vs == cls)[..., None], hs[at + k], res)
        root = g["root"]
        if root.dim() < res.dim():
            root = root[..., None, :]
        oks.append(_eq8(res, root) & valid)
    return oks


def _dense_agree_minmax(vals: torch.Tensor, o: torch.Tensor, width: int):
    """Masked min/max agreement (broadcast-compare-reduce form).

    vals [..., n, 8], o [..., n] slot of each branch (in [0, width)).
    Returns (dense [..., width, 8] = masked min over the branches at each
    slot, occupied [..., width], agree [...] = every occupied slot's
    branches are word-identical, i.e. masked min == masked max).

    The words are int32 bit patterns, so min and max order them as SIGNED
    values, unlike the JAX package's uint32.  Agreement (min == max) does not
    depend on the order, and an occupied slot whose branches agree yields
    their common value either way; only the filler of unoccupied slots
    differs, and no verdict reads it."""
    slots = torch.arange(width, dtype=o.dtype, device=o.device)
    m = (o[..., None] == slots)[..., None]          # [..., n, width, 1]
    v = vals[..., None, :]                          # [..., n, 1, 8]
    info = torch.iinfo(vals.dtype)
    lo = torch.where(m, v, info.max).amin(dim=-3)
    hi = torch.where(m, v, info.min).amax(dim=-3)
    occupied = m[..., 0].any(dim=-2)                # [..., width]
    agree = (~occupied | _eq8(lo, hi)).all(dim=-1)
    return lo, occupied, agree


def _shared_bottom(group: dict) -> dict:
    """Index arithmetic, guards and the launch operands of one group's leaf
    hash and full-width lower levels, up to the switchover: st["walk"] for a
    non-quad group (one group of a walk_leaf_levels_groups launch),
    st["quad"] for a quad group (one group of a walk_quads_groups launch).
    The caller launches them and puts the digests in st["res"]."""
    indices = group["indices"].to(torch.int64)
    witness = group["witness"]                  # [..., n, w, 8]
    w = witness.shape[-2]
    n = indices.shape[-1]
    # uniform-depth guard: a ragged group routed here rejects (never accepts)
    ok = (group["depth"] == w).all(dim=-1)

    ld4 = 1 << (w - 1)
    idx = (indices // ld4) + 4 * (indices % ld4)
    ti0 = (1 << (w + 2)) + idx

    val, sib = group["value"], group["sibling"]
    st = {"w": w, "ok": ok, "root": group["root"]}
    if not group.get("quad"):
        # leaf + full-width levels in one kernel (digests stay in registers
        # between levels); the dense-tail dedup takes over at level t0
        t0 = max(1, w - min(_flog2(max(1, n - 1)), TAIL_CAP))
        st["walk"] = (val.contiguous(), sib.contiguous(), witness,
                      ti0.to(torch.int32), t0 - 1)
        st.update(n=n, t0=t0, ti=ti0 >> t0, wit=witness, ti0=ti0)
    else:
        # Sibling-quad form (FRI poly groups): branch 4k+i queries position
        # y_k + (rou_deg/4)*i, whose PERMUTED index is 4*y_k + i
        # (main.rs:62-66 + merkle_tree.rs:112-116) -- the four branches of a
        # query are the four leaves of one level-2 subtree node and share
        # every witness above it.  Kernel B walks the subtree once per query:
        # two leaf pair-hashes, the check that each branch's first witness is
        # the OTHER pair's digest (what its independent walk hashes against),
        # one combine, then the levels up to the switchover.  The equality
        # checks below cover what else a dropped branch's own data would
        # have fed its independent walk.
        q4 = n // 4
        lead4 = idx.shape[:-1] + (q4, 4)
        idx4 = idx.reshape(lead4)
        # structure guard (the caller constructs indices this way; a
        # misrouted group must reject, never misverify).  Requires the quad
        # to be 4-ALIGNED, not just consecutive: indices 4y+2..4y+5 would
        # pass a consecutiveness-only check yet straddle two subtree nodes.
        i4 = torch.arange(4, dtype=torch.int64, device=idx.device)
        ok = ok & ((idx4 == idx4[..., 0:1] + i4)
                   & ((idx4[..., 0:1] & 3) == 0)).all(dim=-1).all(dim=-1)
        val4 = val.reshape(lead4 + val.shape[-1:])
        sib4 = sib.reshape(lead4 + sib.shape[-1:])
        # within each sibling pair, each branch's claimed sibling must be
        # the other's value; then H(v0 || s0) serves both walks (b0's tree
        # index 4y is even, b1's odd -> both hash the same ordered pair)
        pair_ok = ((val4[..., 0::2, :] == sib4[..., 1::2, :])
                   & (sib4[..., 0::2, :] == val4[..., 1::2, :]))
        ok = ok & pair_ok.flatten(-3).all(dim=-1)
        # all four branches must present identical witnesses at every
        # remaining level (each independent walk consumes its own copy)
        wit4 = witness.reshape(lead4 + witness.shape[-2:])
        if w > 1:
            ok = ok & (wit4[..., 1:, 1:, :]
                       == wit4[..., 0:1, 1:, :]).flatten(-4).all(dim=-1)
        n_eff, consumed = q4, 2
        t0 = max(consumed, w - min(_flog2(max(1, n_eff - 1)), TAIL_CAP))
        # the pair hashes, their combine and levels consumed .. t0-1 in
        # kernel B (digests stay in registers), from b0's start index
        st["quad"] = (val.contiguous(), sib.contiguous(), witness,
                      ti0.to(torch.int32), t0 - consumed)
        ti0 = ti0.reshape(lead4)[..., 0]        # b0's start index, [..., q4]
        st.update(ok=ok, n=n_eff, t0=t0, ti=ti0 >> t0,
                  wit=wit4[..., 0, :, :], ti0=ti0)   # [..., q4, w, 8] view
    return st


def _switchover(st: dict) -> None:
    """Dense switchover: live keys ti = ti0 >> t0 span one aligned interval,
    so (key - base) is the node's slot.  Branches sharing a node must agree
    on the running hash; the agreed value becomes the slot state."""
    w, t0 = st["w"], st["t0"]
    we = 1 << (w + 1 - t0)
    o = st.pop("ti") - (1 << (w + 2 - t0))      # [..., n_eff]
    state, valid, agree = _dense_agree_minmax(st.pop("res"), o, we)
    st.update(tail_len=w - t0 + 1, ok=st["ok"] & agree, state=state,
              valid=valid)


def _tail_inputs(st: dict, j: int):
    """Build this level's (left, right) hash inputs for one group.

    j = levels remaining after this one; output width = 2^j; input slots
    2o / 2o+1 are the children of output slot o."""
    w = st["w"]
    t = w - j                                    # witness level consumed
    wt = st["wit"][..., t - 1, :]                # [..., n, 8] (branch order)
    valid = st["valid"]
    w_in = valid.shape[-1]

    # all branches at a node must supply the same witness; the agreed value
    # is the node's dense witness
    o_in = (st["ti0"] >> t) - (1 << (w + 2 - t))
    wd, _, agree = _dense_agree_minmax(wt, o_in, w_in)
    st["ok"] = st["ok"] & agree

    # dense pair step: children of output slot o are input slots 2o, 2o+1
    d = st["state"]
    dl, dr = d[..., 0::2, :], d[..., 1::2, :]
    wl, wr = wd[..., 0::2, :], wd[..., 1::2, :]
    vl, vr = valid[..., 0::2], valid[..., 1::2]
    # even-key child hashes H(state || wit), odd H(wit || state); when both
    # children are present one H(left || right) serves both walks provided
    # each side's claimed witness equals the other's computed state
    a = torch.where(vl[..., None], dl, wr)
    b = torch.where(vr[..., None], dr, wl)
    both = vl & vr
    cross = _eq8(wl, dr) & _eq8(wr, dl)
    st["ok"] = st["ok"] & (~both | cross).all(dim=-1)

    st["valid"] = vl | vr
    return a, b


def verify_groups_shared(groups: list) -> list:
    """Verify rectangular branch groups with shared-path walks.

    groups: dicts with root [..., 8], indices [..., n], value/sibling
    [..., n, vw], witness [..., n, w, 8] (w = the group's uniform depth),
    depth [..., n], and "quad": True for sibling-quad groups.  Returns one
    [...] bool verdict per group (the AND over its branches).  All groups'
    dense tails stack into one Blake2s call per tree level.
    """
    sts = [_shared_bottom(g) for g in groups]
    # the leaf walks of every non-quad group in one launch of kernel A, of
    # every quad group in one launch of kernel B
    walking = [st for st in sts if "walk" in st]
    for st, res in zip(walking, merkle_cuda.walk_leaf_levels_groups(
            [st.pop("walk") for st in walking])):
        st["res"] = res
    quads = [st for st in sts if "quad" in st]
    for st, (res, first_ok) in zip(quads, merkle_cuda.walk_quads_groups(
            [st.pop("quad") for st in quads])):
        st["res"] = res
        st["ok"] = st["ok"] & (first_ok != 0).all(dim=-1)
    for st in sts:
        _switchover(st)
    for j in range(max(st["tail_len"] for st in sts) - 1, -1, -1):
        parts = [st for st in sts if st["tail_len"] > j]
        ins = [_tail_inputs(st, j) for st in parts]
        h = blake2s.hash_pair(torch.cat([a for a, _ in ins], dim=-2),
                              torch.cat([b for _, b in ins], dim=-2))
        off = 0
        for st, (a, _) in zip(parts, ins):
            w_out = a.shape[-2]
            st["state"] = h[..., off:off + w_out, :]
            off += w_out
    return [st["ok"] & st["valid"][..., 0]
            & _eq8(st["state"][..., 0, :], st["root"])
            for st in sts]


def merkle_root_permuted(leaves: torch.Tensor) -> torch.Tensor:
    """Root of the full tree the prover builds over a committed value list.

    leaves: [..., n, 8] word leaves (n a power of two, at least 4).  The
    prover lays leaves out in the permute-4 shuffled order that
    ProofBranch::verify walks back (src/merkle_tree.rs:112-116): query index
    x lives at tree position (x / (n/4)) + 4*(x mod (n/4)).  Parents are
    Blake2s(left || right) all the way up.

    Used by strict mode to bind the FRI POINTS element to the last committed
    root -- the check the reference parses for but never performs
    (deserializer.rs:47-59, main.rs:94).
    """
    n = leaves.shape[-2]
    ld4 = n // 4
    x = torch.arange(n, device=leaves.device)
    pos = (x // ld4) + 4 * (x % ld4)
    nodes = leaves[..., torch.argsort(pos), :]   # tree position -> query index
    while nodes.shape[-2] > 1:
        nodes = blake2s.hash_pair(nodes[..., 0::2, :], nodes[..., 1::2, :])
    return nodes[..., 0, :]
