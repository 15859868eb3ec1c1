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
                   in its own launch and selected per branch; a size in no
                   class takes the first class's.

    Returns (ok [..., n] bool, value_words passthrough) -- mirroring
    MultiProof::verify returning the leaf values (merkle_tree.rs:25-44).
    """
    dev = indices.device
    d = _u32(torch.as_tensor(depth, device=dev))
    if d.dim() and d.dim() < indices.dim():
        d = d[..., None]
    d = d.expand(indices.shape)
    valid = (d >= 1) & (d <= MAX_BRANCH_DEPTH)
    ds = d.clamp(1, MAX_BRANCH_DEPTH)

    # uint32 arithmetic, as the reference's: int64 masked to 32 bits
    ind = _u32(indices)
    ld4 = 1 << (ds - 1)                          # 2^(w+1) / 4
    idx = ((ind // ld4) + 4 * (ind % ld4)) & 0xFFFFFFFF
    tree_index = (((1 << (ds + 2)) + idx) & 0xFFFFFFFF).to(torch.int32)
    depth32 = ds.to(torch.int32).contiguous()

    value_words = value_words.contiguous()
    sibling_words = sibling_words.contiguous()
    if vsizes is None:
        res = merkle_cuda.walk_branches(value_words, sibling_words,
                                        witness_words, tree_index, depth32)
    else:
        res = None
        for cls in vsize_classes:                # static byte sizes
            h = merkle_cuda.walk_branches(
                value_words[..., :cls // 4], sibling_words[..., :cls // 4],
                witness_words, tree_index, depth32)
            sel = (_u32(vsizes) == cls)[..., None]
            res = h if res is None else torch.where(sel, h, res)

    if root_words.dim() < res.dim():
        root_words = root_words[..., None, :]
    return _eq8(res, root_words) & valid, value_words


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
    """Leaf hash + full-width lower levels + switchover to dense node form."""
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
    if not group.get("quad"):
        # leaf + full-width levels in one kernel (digests stay in registers
        # between levels); the dense-tail dedup below takes over at level t0
        t0 = max(1, w - min(_flog2(max(1, n - 1)), TAIL_CAP))
        res = merkle_cuda.walk_leaf_levels(
            val.contiguous(), sib.contiguous(), witness,
            ti0.to(torch.int32), levels=t0 - 1)
        ti = ti0 >> t0
        n_eff = n
    else:
        # Sibling-quad form (FRI poly groups): branch 4k+i queries position
        # y_k + (rou_deg/4)*i, whose PERMUTED index is 4*y_k + i
        # (main.rs:62-66 + merkle_tree.rs:112-116) -- the four branches of a
        # query are the four leaves of one level-2 subtree node and share
        # every witness above it.  Walk the subtree once per query: two leaf
        # pair-hashes + one combine instead of four full walks, with
        # equality checks wherever a dropped branch's own data would have
        # been used by its independent walk.
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
        # both pair hashes in one call: branches 0 and 2 of every quad
        n0123 = blake2s.hash_leaf_pair(val4[..., 0::2, :], sib4[..., 0::2, :])
        n01, n23 = n0123[..., 0, :], n0123[..., 1, :]
        wit4 = witness.reshape(lead4 + witness.shape[-2:])
        # level-1: each branch's own first witness must equal the computed
        # state of the OTHER pair (what its independent walk hashes against)
        w0 = wit4[..., 0, :]                    # [..., q4, 4, 8]
        first_ok = ((w0[..., 0:2, :] == n23[..., None, :])
                    & (w0[..., 2:4, :] == n01[..., None, :]))
        ok = ok & first_ok.flatten(-3).all(dim=-1)
        res = blake2s.hash_pair(n01, n23)       # [..., q4, 8]
        # all four branches must present identical witnesses at every
        # remaining level (each independent walk consumes its own copy)
        if w > 1:
            ok = ok & (wit4[..., 1:, 1:, :]
                       == wit4[..., 0:1, 1:, :]).flatten(-4).all(dim=-1)
        ti0 = ti0.reshape(lead4)[..., 0]        # b0's start index, [..., q4]
        ti = ti0 >> 2
        witness = wit4[..., 0, :, :]            # [..., q4, w, 8] strided view
        n_eff, consumed = q4, 2
        t0 = max(consumed, w - min(_flog2(max(1, n_eff - 1)), TAIL_CAP))
        if t0 > consumed:
            # pair + combine above in plain torch, the remaining full-width
            # levels in the chain kernel
            res = merkle_cuda.chain_levels(
                res.contiguous(), witness[..., consumed - 1:t0 - 1, :],
                ti.to(torch.int32), levels=t0 - consumed)
            ti = ti >> (t0 - consumed)

    # dense switchover: live keys ti = ti0 >> t0 span one aligned interval,
    # so (key - base) is the node's slot.  Branches sharing a node must agree
    # on the running hash; the agreed value becomes the slot state.
    we = 1 << (w + 1 - t0)
    o = ti - (1 << (w + 2 - t0))                # [..., n_eff]
    state, valid, agree = _dense_agree_minmax(res, o, we)
    return {
        "n": n_eff, "w": w, "t0": t0, "tail_len": w - t0 + 1,
        "ok": ok & agree,
        "root": group["root"], "wit": witness, "ti0": ti0,
        "state": state, "valid": valid,
    }


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
