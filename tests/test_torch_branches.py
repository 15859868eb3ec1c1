"""The independent Merkle walk: the port's ops/merkle_cuda.walk_branches
(kernel F; on the CPU its plain version) against the Pallas kernel it
replaces in interpret mode, and ops/merkle.verify_branches against the JAX
package's namesake and the oracle's per-branch walk on ragged groups.
Tolerance 0."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from stark_verifier_tpu.ops import merkle as JM, merkle_pallas
from test_torch_merkle import LOOP_LAX
from stark_verifier_tpu_torch.ops import merkle as M, merkle_cuda
from stark_verifier_tpu_torch.proofio import wire

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _jax_level_loops():
    """The JAX walks' level scans as loops, compiled once per shape
    (test_torch_merkle.LOOP_LAX)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "lax", LOOP_LAX)
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _words(rng, shape):
    w = rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[0::5] = 0xFFFFFFFF
    w.reshape(-1)[2::9] = 0x80000000
    return w


def _bwords(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype="<u4").astype(np.uint32)


@pytest.fixture(scope="module")
def pallas_walk():
    """Operands of a group with mixed depths 1..max_depth per lane and
    32-byte leaves, and the Pallas kernel's digests in interpret mode (96-byte
    leaves there take many minutes; they are held against the JAX
    verify_branches and the oracle below)."""
    rng = np.random.RandomState(0)
    n, max_depth = 8, 3
    val, sib = _words(rng, (n, 8)), _words(rng, (n, 8))
    wit = _words(rng, (n, max_depth, 8))
    idx = np.arange(n, dtype=np.uint32)
    dp = ((np.arange(n) % max_depth) + 1).astype(np.uint32)
    ld4 = np.uint32(1) << (dp - 1)
    ti = ((np.uint32(1) << (dp + 2)) + idx // ld4 + 4 * (idx % ld4)
          ).astype(np.uint32)
    with pytest.MonkeyPatch.context() as mp:
        # 1x128 tiles exercise the same kernel logic as the full tiles
        mp.setattr(merkle_pallas, "SUB_TILE", 1)
        want = np.asarray(merkle_pallas.walk_branches(
            jnp.asarray(val), jnp.asarray(sib), jnp.asarray(wit),
            jnp.asarray(ti), jnp.asarray(dp), interpret=True))
    return (val, sib, wit, ti, dp), want


def test_walk_branches_vs_pallas_interpret(pallas_walk):
    args, want = pallas_walk
    got = merkle_cuda.walk_branches(*map(_t, args))
    np.testing.assert_array_equal(_n(got), want)
    assert merkle_cuda.launches["walk_branches"] == 0


def test_walk_branches_groups_equal_the_walk_of_each_group(pallas_walk):
    """The Pallas-checked group beside groups of 24 and 5 words a value (the
    last a ragged size) with depths per branch up to and past their witness
    rows, and a group of one branch, in one call: each group's digests equal
    its own walk_branches, the first also the Pallas kernel's."""
    rng = np.random.RandomState(7)
    groups = [pallas_walk[0]]
    for n, vw, max_depth in ((4, 24, 3), (6, 5, 5), (1, 8, 2)):
        depth = ((np.arange(n) % (max_depth + 1)) + 1).astype(np.uint32)
        groups.append((_words(rng, (n, vw)), _words(rng, (n, vw)),
                       _words(rng, (n, max_depth, 8)), _words(rng, (n,)),
                       depth))
    got = merkle_cuda.walk_branches_groups(
        [tuple(map(_t, g)) for g in groups])
    assert len(got) == len(groups)
    for g, out in zip(groups, got):
        np.testing.assert_array_equal(
            out.numpy(), merkle_cuda.walk_branches(*map(_t, g)).numpy())
    np.testing.assert_array_equal(_n(got[0]), pallas_walk[1])
    assert merkle_cuda.walk_branches_groups([]) == []


def test_walk_branches_equals_the_static_walk_at_uniform_depth():
    rng = np.random.RandomState(1)
    n, depth = 6, 4
    val, sib = _t(_words(rng, (2, n, 24))), _t(_words(rng, (2, n, 24)))
    wit = _t(_words(rng, (2, n, depth, 8)))
    ti = _t(rng.randint(1 << (depth + 2), 1 << (depth + 3), (2, n))
            .astype(np.uint32))
    d = torch.full((2, n), depth, dtype=torch.int32)
    np.testing.assert_array_equal(
        merkle_cuda.walk_branches(val, sib, wit, ti, d).numpy(),
        merkle_cuda.walk_leaf_levels(val, sib, wit, ti, depth).numpy())
    # a depth past the witness rows walks all of them and no more
    np.testing.assert_array_equal(
        merkle_cuda.walk_branches(val, sib, wit, ti, d + 3).numpy(),
        merkle_cuda.walk_branches(val, sib, wit, ti, d).numpy())


def test_no_fallback_for_a_tensor_that_is_not_on_the_cpu():
    z = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    i = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(Exception):
        merkle_cuda.walk_branches(
            z, z, torch.zeros((4, 2, 8), dtype=torch.int32, device="meta"),
            i, i)
    assert merkle_cuda.launches["walk_branches"] == 0


# ---------------------------------------------------------------------------
# verify_branches on a ragged group: value sizes 32/64/32/96, depths 3/2/5/4
# ---------------------------------------------------------------------------

def _serialize_multiproof(branches):
    out = len(branches).to_bytes(4, "little")
    for br in branches:
        out += len(br.value).to_bytes(4, "little")
        out += br.value + br.sibling_value
        out += (32 * len(br.witnesses)).to_bytes(4, "little")
        out += b"".join(br.witnesses)
    return out


@pytest.fixture(scope="module")
def ragged():
    rng = random.Random(0xA11)

    def rand(n):
        return bytes(rng.randrange(256) for _ in range(n))

    branches, indices = [], []
    for vsize, depth in [(32, 3), (64, 2), (32, 5), (96, 4)]:
        branches.append(oracle.Branch(
            value=rand(vsize), sibling_value=rand(vsize),
            witnesses=[rand(32) for _ in range(depth)]))
        indices.append(rng.randrange(2 ** (depth + 1)))
    g = wire._parse_multiproof(wire._Reader(_serialize_multiproof(branches)))
    assert g.vsizes.tolist() == [32, 64, 32, 96]
    assert g.depths.tolist() == [3, 2, 5, 4] and not g.rectangular
    roots = [oracle.branch_root(i, br) for br, i in zip(branches, indices)]
    for br, i, r in zip(branches, indices, roots):
        assert oracle.verify_branch(r, i, br) == br.value
    return {"g": g, "branches": branches,
            "indices": np.array(indices, dtype=np.uint32),
            "roots": np.stack([_bwords(r) for r in roots])}


def _both(r, value=None, depths=None, witness=None):
    """(port, JAX) per-branch verdicts of the ragged group, with one operand
    replaced."""
    g = r["g"]
    value = g.value_words if value is None else value
    depths = g.depths if depths is None else depths
    witness = g.witness_words if witness is None else witness
    got, passthrough = M.verify_branches(
        _t(r["roots"]), _t(r["indices"]), _t(value), _t(g.sibling_words),
        _t(witness), _t(depths), vsizes=_t(g.vsizes),
        vsize_classes=g.vsize_classes)
    np.testing.assert_array_equal(_n(passthrough), value)
    want, _ = JM.verify_branches(
        jnp.asarray(r["roots"]), jnp.asarray(r["indices"]), jnp.asarray(value),
        jnp.asarray(g.sibling_words), jnp.asarray(witness),
        jnp.asarray(depths), vsizes=jnp.asarray(g.vsizes),
        vsize_classes=g.vsize_classes)
    return got.numpy(), np.asarray(want)


def test_ragged_group_verifies_like_jax_and_the_oracle(ragged):
    got, want = _both(ragged)
    assert got.dtype == np.bool_ and got.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", range(4))
def test_ragged_group_tampered_value_rejects_its_branch_only(ragged, k):
    bad = ragged["g"].value_words.copy()
    bad[k, 0] ^= 1
    got, want = _both(ragged, value=bad)
    np.testing.assert_array_equal(got, want)
    expect = np.ones(4, dtype=bool)
    expect[k] = False
    np.testing.assert_array_equal(got, expect)
    tampered = oracle.Branch(value=bad[k, :len(ragged["branches"][k].value)
                                       // 4].tobytes(),
                             sibling_value=ragged["branches"][k].sibling_value,
                             witnesses=ragged["branches"][k].witnesses)
    with pytest.raises(AssertionError):
        oracle.verify_branch(ragged["roots"][k].tobytes(),
                             int(ragged["indices"][k]), tampered)


def test_verify_branches_groups_equal_one_call_a_group(ragged):
    """The ragged group (its value-size classes walked as groups of the
    same launch), the same group with one value flipped and a rectangular
    group, in one call: the verdicts of one verify_branches call a group
    (held against the JAX package's by the tests around this one)."""
    g = ragged["g"]
    bad = g.value_words.copy()
    bad[2, 0] ^= 1
    rng = np.random.RandomState(8)
    rect = {"root": _words(rng, (8,)), "indices": np.arange(5, dtype=np.uint32),
            "value": _words(rng, (5, 8)), "sibling": _words(rng, (5, 8)),
            "witness": _words(rng, (5, 3, 8)), "depth": 3}
    rect["root"] = _n(merkle_cuda.walk_branches(
        _t(rect["value"][1]), _t(rect["sibling"][1]), _t(rect["witness"][1]),
        torch.tensor(32 + 1 // 4 + 4 * (1 % 4), dtype=torch.int32),
        torch.tensor(3, dtype=torch.int32)))
    groups = [dict(root=ragged["roots"], indices=ragged["indices"], value=v,
                   sibling=g.sibling_words, witness=g.witness_words,
                   depth=g.depths, vsizes=g.vsizes,
                   vsize_classes=g.vsize_classes)
              for v in (g.value_words, bad)] + [rect]
    def port(grp):
        return {k: _t(v) if isinstance(v, np.ndarray) else v
                for k, v in grp.items()}

    got = M.verify_branches_groups([port(grp) for grp in groups])
    names = ("root", "indices", "value", "sibling", "witness", "depth")
    for grp, ok in zip(groups, got):
        one, _ = M.verify_branches(*map(port(grp).get, names),
                                   vsizes=port(grp).get("vsizes"),
                                   vsize_classes=grp.get("vsize_classes"))
        np.testing.assert_array_equal(ok.numpy(), one.numpy())
    assert got[0].all() and got[1].tolist() == [True, True, False, True]
    assert got[2].tolist() == [False, True, False, False, False]


def test_ragged_group_short_depth_rejects_its_branch_only(ragged):
    short = ragged["g"].depths.copy()
    short[2] -= 1
    got, want = _both(ragged, depths=short)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [True, True, False, True])


def test_ragged_group_padded_witness_still_verifies(ragged):
    """One more zero level than any depth: padded is not tampered."""
    w = ragged["g"].witness_words
    padded = np.concatenate([w, np.zeros_like(w[:, :1])], axis=1)
    got, want = _both(ragged, witness=padded)
    np.testing.assert_array_equal(got, want)
    assert got.all()


@pytest.mark.parametrize("depth", [0, 30, 31, 64, 0xFFFFFFFF])
def test_depth_outside_the_walkable_range_rejects(ragged, depth):
    """Depth 0 (the shuffle would divide by zero) and depths whose start
    index leaves 32 bits reject their branch, whatever the root; the other
    branches keep their verdicts."""
    d = ragged["g"].depths.copy()
    d[1] = depth
    got, _ = M.verify_branches(
        _t(ragged["roots"]), _t(ragged["indices"]), _t(ragged["g"].value_words),
        _t(ragged["g"].sibling_words), _t(ragged["g"].witness_words), _t(d),
        vsizes=_t(ragged["g"].vsizes),
        vsize_classes=ragged["g"].vsize_classes)
    np.testing.assert_array_equal(got.numpy(), [True, False, True, True])


def test_depth_zero_rejects_even_a_root_that_is_the_leaf_hash():
    """A tree built by hand whose root IS the leaf pair-hash: the JAX
    function's depth-0 arithmetic would compare exactly that; the port
    rejects."""
    rng = np.random.RandomState(3)
    val, sib = _t(_words(rng, (1, 8))), _t(_words(rng, (1, 8)))
    wit = torch.zeros((1, 2, 8), dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    for first, second in ((val, sib), (sib, val)):
        root = merkle_cuda.walk_branches(first, second, wit, zero, zero)[0]
        ok, _ = M.verify_branches(root, zero, val, sib, wit, 0)
        assert not bool(ok.any())


def test_static_and_group_level_depths_and_broadcast_root():
    """depth as a python int, as a [batch] tensor broadcast over the
    branches, and a root shared by the group: against the JAX function."""
    rng = np.random.RandomState(4)
    b, n, w = 2, 5, 3
    val, sib = _words(rng, (b, n, 24)), _words(rng, (b, n, 24))
    wit = _words(rng, (b, n, w, 8))
    idx = rng.randint(0, 1 << (w + 1), (b, n)).astype(np.uint32)
    idx[0, 0] = 0xFFFFFFF0                      # far outside the tree
    # branch (0, 1)'s own root as the group's root: one accept per call
    ld4 = 1 << (w - 1)
    ti = (1 << (w + 2)) + idx[0, 1] // ld4 + 4 * (idx[0, 1] % ld4)
    root = merkle_cuda.walk_leaf_levels(
        _t(val[0, 1]), _t(sib[0, 1]), _t(wit[0, 1]),
        torch.tensor(int(ti), dtype=torch.int32), w)
    roots = np.stack([_n(root), _n(root)])
    for depth_t, depth_j in (
            (w, w),
            (torch.tensor([w, w - 1], dtype=torch.int32),
             jnp.asarray(np.array([w, w - 1], dtype=np.uint32)))):
        got, _ = M.verify_branches(_t(roots), _t(idx), _t(val), _t(sib),
                                   _t(wit), depth_t)
        want, _ = JM.verify_branches(
            jnp.asarray(roots), jnp.asarray(idx), jnp.asarray(val),
            jnp.asarray(sib), jnp.asarray(wit), depth_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (b, n) and bool(got[0, 1]) and got.sum() == 1


def test_merkle_root_permuted_vs_jax():
    rng = np.random.RandomState(5)
    leaves = _words(rng, (2, 16, 8))
    got = _n(M.merkle_root_permuted(_t(leaves)))
    np.testing.assert_array_equal(
        got, np.asarray(JM.merkle_root_permuted(jnp.asarray(leaves))))
    # a branch of that tree verifies against it: index 5, depth 3
    assert got.shape == (2, 8)
