"""Port's Merkle modules against the JAX package: the plain versions of the
two walk kernels (ops/merkle_cuda.py) against the Pallas kernels in interpret
mode, and the shared-path walk (ops/merkle.py) against its JAX namesake on
the branch groups of a freshly proved statement.  Tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prover
from stark_verifier_tpu.ops import (
    blake2s as JB, merkle as JM, merkle_pallas, prg as JP)
from stark_verifier_tpu.proofio import wire as jwire
from stark_verifier_tpu_torch.ops import merkle as M, merkle_cuda
from stark_verifier_tpu_torch.proofio import wire

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]


@pytest.fixture(autouse=True)
def _tiny_tiles(monkeypatch):
    # 1x128 tiles exercise the same kernel logic as the full tiles and keep
    # the interpret-mode emulator fast
    monkeypatch.setattr(merkle_pallas, "SUB_TILE", 1)


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


def _start(n, depth):
    idx = np.arange(n, dtype=np.uint32)
    ld4 = np.uint32(1 << (depth - 1))
    return (np.uint32(1 << (depth + 2)) + idx // ld4
            + 4 * (idx % ld4)).astype(np.uint32)


def _jax_plain_walk(val, sib, wit, ti, levels):
    odd = (ti & 1).astype(bool)[..., None]
    r = JB.hash_leaf_pair(jnp.where(odd, sib, val), jnp.where(odd, val, sib))
    t2 = ti >> 1
    for k in range(levels):
        w = wit[:, k, :]
        odd = (t2 & 1).astype(bool)[..., None]
        r = JB.hash_pair(jnp.where(odd, w, r), jnp.where(odd, r, w))
        t2 = t2 >> 1
    return r


@pytest.mark.parametrize("levels", [3, 0])
def test_walk_leaf_levels_vs_pallas_interpret(levels):
    rng = np.random.RandomState(1)
    n, depth = 8, 4
    val, sib = _words(rng, (n, 8)), _words(rng, (n, 8))
    wit = _words(rng, (n, depth, 8))
    ti = _start(n, depth)
    want = np.asarray(merkle_pallas.walk_leaf_levels(
        jnp.asarray(val), jnp.asarray(sib), jnp.asarray(wit), jnp.asarray(ti),
        levels=levels, interpret=True))
    got = merkle_cuda.walk_leaf_levels(_t(val), _t(sib), _t(wit), _t(ti),
                                       levels)
    np.testing.assert_array_equal(_n(got), want)


@pytest.fixture(scope="module")
def vw24_walk():
    """Operands of a group of 96-byte leaves (three compressions) and the
    JAX plain reference's digests (interpret mode takes many minutes to trace
    them)."""
    rng = np.random.RandomState(2)
    n, depth, levels = 8, 5, 4
    args = (_words(rng, (n, 24)), _words(rng, (n, 24)),
            _words(rng, (n, depth, 8)), _start(n, depth))
    return args + (levels,), np.asarray(_jax_plain_walk(
        *map(jnp.asarray, args), levels))


def test_walk_leaf_levels_vw24_vs_jax_plain(vw24_walk):
    (val, sib, wit, ti, levels), want = vw24_walk
    got = merkle_cuda.walk_leaf_levels(_t(val), _t(sib), _t(wit), _t(ti),
                                       levels)
    np.testing.assert_array_equal(_n(got), want)


def test_walk_leaf_levels_groups_equal_the_walk_of_each_group(vw24_walk):
    """The JAX-checked 96-byte group beside groups of 32-byte leaves with
    other level counts, one of a single branch, in one call: each group's
    digests equal its own walk_leaf_levels, the first also the JAX
    reference's."""
    rng = np.random.RandomState(6)
    groups = [vw24_walk[0]]
    for n, depth, levels in ((8, 4, 3), (1, 6, 6)):
        groups.append((_words(rng, (n, 8)), _words(rng, (n, 8)),
                       _words(rng, (n, depth, 8)), _start(n, depth), levels))
    got = merkle_cuda.walk_leaf_levels_groups(
        [tuple(map(_t, g[:4])) + (g[4],) for g in groups])
    assert len(got) == len(groups)
    for (val, sib, wit, ti, levels), out in zip(groups, got):
        np.testing.assert_array_equal(
            out.numpy(), merkle_cuda.walk_leaf_levels(
                _t(val), _t(sib), _t(wit), _t(ti), levels).numpy())
    np.testing.assert_array_equal(_n(got[0]), vw24_walk[1])
    assert merkle_cuda.walk_leaf_levels_groups([]) == []


def test_chain_levels_vs_pallas_interpret():
    rng = np.random.RandomState(3)
    n, levels = 8, 3
    h = _words(rng, (n, 8))
    wit = _words(rng, (n, levels, 8))
    ti = rng.randint(8, 64, (n,)).astype(np.uint32)
    want = np.asarray(merkle_pallas.chain_levels(
        jnp.asarray(h), jnp.asarray(wit), jnp.asarray(ti), levels=levels,
        interpret=True))
    got = merkle_cuda.chain_levels(_t(h), _t(wit), _t(ti), levels)
    np.testing.assert_array_equal(_n(got), want)


def test_chain_levels_strided_view_equals_copy():
    rng = np.random.RandomState(4)
    wit4 = _t(_words(rng, (2, 5, 4, 6, 8)))
    view = wit4[:, :, 0, 1:4, :]
    h = _t(_words(rng, (2, 5, 8)))
    ti = _t(rng.randint(8, 1 << 12, (2, 5)).astype(np.uint32))
    np.testing.assert_array_equal(
        merkle_cuda.chain_levels(h, view, ti, 3).numpy(),
        merkle_cuda.chain_levels(h, view.contiguous(), ti, 3).numpy())
    assert merkle_cuda._witness_stride(view, 2, 3) == 4 * 6 * 8
    with pytest.raises(ValueError):
        merkle_cuda._witness_stride(wit4[:, :, 0, :, ::2], 2, 3)


def test_branch_rows_copy_only_for_unaligned_wide_loads():
    """The independent walk reads value rows in place; it copies only a
    width read by 16-byte loads out of rows that break the alignment, and
    any other layout it cannot read raises instead of being copied."""
    rng = np.random.RandomState(5)
    wide = _t(_words(rng, (3, 6, 10)))
    sib = _t(_words(rng, (3, 6, 10)))
    v, s, stride = merkle_cuda._branch_rows(wide, sib, 2)
    assert v is wide and s is sib and stride == 10   # word-by-word width
    v, s, stride = merkle_cuda._branch_rows(wide[..., :3], sib[..., :3], 2)
    assert v.data_ptr() == wide.data_ptr() and stride == 10
    v, s, stride = merkle_cuda._branch_rows(wide[..., :8], sib[..., :8], 2)
    assert v.is_contiguous() and s.is_contiguous() and stride == 8
    np.testing.assert_array_equal(v.numpy(), wide[..., :8].numpy())
    rows12 = _t(_words(rng, (3, 6, 12)))
    v, _, stride = merkle_cuda._branch_rows(rows12[..., :8], rows12[..., :8], 2)
    assert v.data_ptr() == rows12.data_ptr() and stride == 12   # in place
    levels = _t(_words(rng, (3, 2, 6, 8)))
    with pytest.raises(ValueError, match="collapse"):
        merkle_cuda._branch_rows(levels[:, 1], levels[:, 1], 2)
    with pytest.raises(ValueError, match="laid out alike"):
        merkle_cuda._branch_rows(rows12[..., :8], levels[:, 0].contiguous(), 2)
    with pytest.raises(ValueError, match="dense"):
        merkle_cuda._branch_rows(rows12[..., ::2], rows12[..., ::2], 2)


def test_wrappers_do_not_fall_back_for_non_cpu_tensors():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper goes for the kernel, which cannot be built or launched here."""
    z = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(Exception):
        merkle_cuda.walk_leaf_levels(
            z, z, torch.zeros((4, 2, 8), dtype=torch.int32, device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"), 1)
    assert merkle_cuda.launches["walk_leaf_levels"] == 0


# ---------------------------------------------------------------------------
# shared-path walk on the groups of a fresh proof (2^9 steps)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fresh():
    pb, _ = prover.prove_to_bytes(3, 512, CONSTS)
    p = wire.parse_proof(pb)
    jp = jwire.parse_proof(pb)
    for a, b in ((p.main, jp.main), (p.fri_levels[1].poly,
                                     jp.fri_levels[1].poly)):
        np.testing.assert_array_equal(a.witness_words, b.witness_words)
    return p


def _group_arrays(p):
    """The 8 branch groups of the proof as numpy dicts (root, indices, value,
    sibling, witness, depth, quad), indices from the oracle-checked PRG."""
    precision = 512 * 8
    pos = np.asarray(JP.pseudorandom_indices(
        jnp.asarray(p.l_merkle_root_words), 80, precision, 8))
    aug = np.stack([pos, (pos + 8) % precision], -1).reshape(160)
    groups = [
        dict(root=p.merkle_root_words, indices=aug, g=p.main, quad=False),
        dict(root=p.l_merkle_root_words, indices=pos, g=p.lincomb, quad=False),
    ]
    prev = p.l_merkle_root_words
    mod = precision // 4
    for lv in p.fri_levels:
        ys = np.asarray(JP.pseudorandom_indices(
            jnp.asarray(lv.root2_words), 40, mod, 8))
        poly_pos = (ys[:, None] + mod * np.arange(4, dtype=np.uint32)).reshape(160)
        groups.append(dict(root=lv.root2_words, indices=ys, g=lv.column,
                           quad=False))
        groups.append(dict(root=prev, indices=poly_pos, g=lv.poly, quad=True))
        prev = lv.root2_words
        mod //= 4
    out = []
    for g in groups:
        bg = g["g"]
        out.append({"root": np.asarray(g["root"]),
                    "indices": np.asarray(g["indices"], dtype=np.uint32),
                    "value": bg.value_words, "sibling": bg.sibling_words,
                    "witness": bg.witness_words, "depth": bg.depths,
                    "quad": g["quad"]})
    return out


def _batched(groups, variants):
    """Stack each group over len(variants) copies; variant i applies its
    edit function to copy i of every group."""
    out = []
    for gi, g in enumerate(groups):
        stacked = {}
        for k, v in g.items():
            if k == "quad":
                continue
            stacked[k] = np.stack([np.array(v) for _ in variants])
        for i, edit in enumerate(variants):
            if edit is not None:
                edit(gi, {k: v[i] for k, v in stacked.items()})
        if g["quad"]:
            stacked["quad"] = True
        out.append(stacked)
    return out


def _run_both(groups):
    jg = [{k: (v if k == "quad" else jnp.asarray(v)) for k, v in g.items()}
          for g in groups]
    tg = [{k: (v if k == "quad" else _t(v)) for k, v in g.items()}
          for g in groups]
    for g in tg:
        g["indices"] = g["indices"].to(torch.int64) & 0xFFFFFFFF
    want = np.stack([np.asarray(v) for v in JM.verify_groups_shared(jg)])
    got = np.stack([v.numpy() for v in M.verify_groups_shared(tg)])
    return got, want


def _flip(field, group_index):
    def edit(gi, g):
        if gi == group_index:
            flat = g[field].reshape(-1)
            flat[len(flat) // 3] ^= 0x80000000
    return edit


def _misalign(quad_i):
    def edit(gi, g):
        if gi == quad_i:
            g["indices"][:4] += 2
    return edit


def _straddle(quad_i):
    """The first query's four positions moved so that their permuted indices
    are consecutive (4y+2 .. 4y+5) but straddle two subtree nodes."""
    def edit(gi, g):
        if gi == quad_i:
            w = g["witness"].shape[-2]
            ld4 = 1 << (w - 1)
            y = int(g["indices"][0]) % ld4
            g["indices"][:4] = [(y + (k + 2) // 4) % ld4 + ((k + 2) % 4) * ld4
                                for k in range(4)]
    return edit


def _ragged(group_index):
    def edit(gi, g):
        if gi == group_index:
            g["depth"][5] -= 1
    return edit


N_GROUPS = 8                       # main, lincomb, 3 x (column, poly)
QUAD = 3                           # the first FRI level's poly group
FIELDS = ["value", "sibling", "witness"]


@pytest.fixture(scope="module")
def shared_results(fresh):
    """Both packages' per-group verdicts on ONE batch (the JAX side runs op
    by op and costs most of a minute, so it runs once): the good proof; one
    copy per group with one word flipped in that group (value, sibling or
    witness in turn); a quad that is not 4-aligned; a quad that is
    consecutive but straddles two subtree nodes; a ragged depth.  The JAX
    package takes its tail depth from the environment; 2 is the port's."""
    groups = _group_arrays(fresh)
    assert len(groups) == N_GROUPS and groups[QUAD]["quad"]
    variants = ([None] + [_flip(FIELDS[i % 3], i) for i in range(N_GROUPS)]
                + [_misalign(QUAD), _straddle(QUAD), _ragged(1)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_SHARED_TAIL", "2")
        mp.setattr(merkle_pallas, "SUB_TILE", 1)
        return _run_both(_batched(groups, variants))


def test_shared_walk_all_verdicts_match_jax(shared_results):
    got, want = shared_results
    np.testing.assert_array_equal(got, want)


def test_shared_walk_accepts_good_proof(shared_results):
    got, _ = shared_results
    assert got[:, 0].all()


@pytest.mark.parametrize("group", range(N_GROUPS))
def test_shared_walk_flipped_word_rejects_its_group_only(shared_results, group):
    got, want = shared_results
    col = got[:, 1 + group]
    np.testing.assert_array_equal(col, want[:, 1 + group])
    expect = np.ones(N_GROUPS, dtype=bool)
    expect[group] = False
    np.testing.assert_array_equal(col, expect)


@pytest.mark.parametrize("variant,group", [(0, QUAD), (1, QUAD), (2, 1)],
                         ids=["quad_not_aligned", "quad_straddles_nodes",
                              "ragged_depth"])
def test_shared_walk_guards_reject(shared_results, variant, group):
    got, want = shared_results
    col = got[:, 1 + N_GROUPS + variant]
    np.testing.assert_array_equal(col, want[:, 1 + N_GROUPS + variant])
    expect = np.ones(N_GROUPS, dtype=bool)
    expect[group] = False
    np.testing.assert_array_equal(col, expect)


def test_dense_agree_signed_words():
    """Agreement and the agreed value do not depend on min/max ordering the
    int32 patterns as signed values."""
    vals = _t(np.array([[0xFFFFFFFF] * 8, [0xFFFFFFFF] * 8, [0x80000000] * 8,
                        [0x7FFFFFFF] * 8], dtype=np.uint32))
    o = torch.tensor([1, 1, 3, 0])
    dense, occupied, agree = M._dense_agree_minmax(vals, o, 4)
    assert bool(agree) and occupied.tolist() == [True, True, False, True]
    np.testing.assert_array_equal(_n(dense[1]), [0xFFFFFFFF] * 8)
    np.testing.assert_array_equal(_n(dense[3]), [0x80000000] * 8)
    jd, jo, ja = JM._dense_agree_minmax(jnp.asarray(_n(vals)),
                                        jnp.asarray(o.numpy()), 4)
    assert bool(ja) and np.asarray(jo).tolist() == occupied.tolist()
    occ = occupied.numpy()
    np.testing.assert_array_equal(_n(dense)[occ], np.asarray(jd)[occ])
    _, _, agree2 = M._dense_agree_minmax(vals, torch.tensor([1, 1, 1, 0]), 4)
    assert not bool(agree2)
