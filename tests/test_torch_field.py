"""Port's ops/field.py against the JAX package's namesakes and Python ints.

Same numpy inputs on both sides; integer arithmetic, so the tolerance is 0.
"""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stark_verifier_tpu import fp as jfp
from stark_verifier_tpu.ops import field as JF
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.ops import field as F

torch.set_num_threads(1)
P = fp.MODULUS
EDGE = [0, 1, P - 1, P, P + 1, 2**256 - 1]


def _vals(seed, n=24):
    rng = random.Random(seed)
    return EDGE + [rng.randrange(1 << 256) for _ in range(n - len(EDGE))]


def _np(vals):
    return fp.ints_to_limbs(vals)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _ints(a):
    return [fp.limbs_to_int(r) for r in a.reshape(-1, a.shape[-1])]


def test_fp_module_matches():
    assert fp.MODULUS == jfp.MODULUS and fp.FOLD_C == jfp.FOLD_C
    vals = _vals(0)
    np.testing.assert_array_equal(fp.ints_to_limbs(vals), jfp.ints_to_limbs(vals))
    np.testing.assert_array_equal(fp.ints_to_limbs_fast(vals),
                                  jfp.ints_to_limbs_fast(vals))
    b = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                      dtype=np.uint8).reshape(-1, 32)
    np.testing.assert_array_equal(fp.be_bytes_to_limbs(b),
                                  jfp.be_bytes_to_limbs(b))
    np.testing.assert_array_equal(fp.bytes_to_le_words(b),
                                  jfp.bytes_to_le_words(b))


def test_const():
    for v in EDGE[:5]:
        np.testing.assert_array_equal(_n(F.const(v, "cpu")), np.asarray(JF.const(v)))


@pytest.mark.parametrize("word", [0, 1, 0x80000000, 0xFFFFFFFF, 0x12345678,
                                  0x80FF00FF])
def test_bswap32(word):
    w = np.array([word, word ^ 0xFFFFFFFF], dtype=np.uint32)
    np.testing.assert_array_equal(_n(F.bswap32(_t(w))),
                                  np.asarray(JF.bswap32(jnp.asarray(w))))
    assert int(_n(F.bswap32(_t(w)))[0]) == int.from_bytes(
        word.to_bytes(4, "little"), "big")


def test_word_limb_views():
    vals = _vals(1)
    words = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                          dtype="<u4").reshape(-1, 8).astype(np.uint32)
    limbs = F.words_be_to_limbs(_t(words))
    np.testing.assert_array_equal(
        _n(limbs), np.asarray(JF.words_be_to_limbs(jnp.asarray(words))))
    assert _ints(_n(limbs)) == vals
    back = F.limbs_to_words_be(limbs)
    np.testing.assert_array_equal(_n(back), words)
    np.testing.assert_array_equal(
        _n(back), np.asarray(JF.limbs_to_words_be(jnp.asarray(_n(limbs)))))


def test_canon():
    vals = _vals(2) + [2**256 - 2**41, P + 2**40]
    a = _np(vals)
    got = _n(F.canon(_t(a)))
    np.testing.assert_array_equal(got, np.asarray(JF.canon(jnp.asarray(a))))
    assert _ints(got) == [v % P for v in vals]


@pytest.mark.parametrize("op", ["add_mod", "sub_mod"])
def test_add_sub(op):
    xs = _vals(3)
    ys = list(reversed(_vals(4)))
    # raw operands (the functions are specified on canonical inputs; on the
    # others both packages must still agree word for word)
    a, b = _np(xs), _np(ys)
    got = _n(getattr(F, op)(_t(a), _t(b)))
    want = np.asarray(getattr(JF, op)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    # canonical operands against Python ints
    ca, cb = [x % P for x in xs], [y % P for y in ys]
    got = _ints(_n(getattr(F, op)(_t(_np(ca)), _t(_np(cb)))))
    sign = 1 if op == "add_mod" else -1
    assert got == [(x + sign * y) % P for x, y in zip(ca, cb)]


def test_add_broadcasts():
    a = _np(_vals(5, 8))
    one = _np([P - 1])[0]
    got = _n(F.add_mod(_t(_np([v % P for v in _vals(5, 8)])), _t(one)))
    assert _ints(got) == [(v % P + P - 1) % P for v in _vals(5, 8)]
    assert a.shape == got.shape


@pytest.mark.parametrize("fn", ["mul_mod", "mul_mod_lazy"])
def test_mul(fn):
    xs = _vals(6)
    ys = list(reversed(_vals(7)))
    a, b = _np(xs), _np(ys)
    got = _n(getattr(F, fn)(_t(a), _t(b)))
    np.testing.assert_array_equal(
        got, np.asarray(getattr(JF, fn)(jnp.asarray(a), jnp.asarray(b))))
    assert _ints(got) == [x * y % P for x, y in zip(xs, ys)]


def test_sqr():
    xs = _vals(8) + [(1 << 256) - 1]
    a = _np(xs)
    got = _n(F.sqr_mod(_t(a)))
    np.testing.assert_array_equal(got, np.asarray(JF.sqr_mod(jnp.asarray(a))))
    assert _ints(got) == [x * x % P for x in xs]


def test_mul_sum_mod_at_the_bound():
    """16 pairs + 8 extras, including all-0xFFFF limbs everywhere."""
    rng = random.Random(9)
    n = 6
    pairs_i = [([rng.randrange(1 << 256) for _ in range(n)],
                [rng.randrange(1 << 256) for _ in range(n)])
               for _ in range(16)]
    extra_i = [[rng.randrange(1 << 256) for _ in range(n)] for _ in range(8)]
    for xs, ys in pairs_i:
        xs[0] = ys[0] = (1 << 256) - 1
        xs[1], ys[1] = P, P - 1
    for e in extra_i:
        e[0] = (1 << 256) - 1
    got = _n(F.mul_sum_mod([(_t(_np(x)), _t(_np(y))) for x, y in pairs_i],
                           extra=[_t(_np(e)) for e in extra_i]))
    want = np.asarray(JF.mul_sum_mod(
        [(jnp.asarray(_np(x)), jnp.asarray(_np(y))) for x, y in pairs_i],
        extra=[jnp.asarray(_np(e)) for e in extra_i]))
    np.testing.assert_array_equal(got, want)
    ints = [(sum(x[j] * y[j] for x, y in pairs_i)
             + sum(e[j] for e in extra_i)) % P for j in range(n)]
    assert _ints(got) == ints


@pytest.mark.parametrize("npairs,nextra", [(0, 0), (17, 0), (1, 9)])
def test_mul_sum_mod_bound_raises(npairs, nextra):
    a = _t(_np([1]))
    with pytest.raises(ValueError):
        F.mul_sum_mod([(a, a)] * npairs, extra=[a] * nextra)


def test_mul_sum_mod_broadcast_pairs():
    xs = _vals(10, 8)
    k = 2**256 - 5
    got = _n(F.mul_sum_mod([(_t(_np([k])[0]), _t(_np(xs)))],
                           extra=[_t(_np(xs))]))
    assert _ints(got) == [(k * x + x) % P for x in xs]


# ---------------------------------------------------------------------------
# exponentiation and inversion (products through mul_mod), comparison,
# conditional subtract, wide products and reductions and the modular sum,
# against the JAX package's namesakes.  The JAX inversion chain costs seconds
# to compile, and eager JAX compiles every op of a new shape, so everything
# is compiled once, in one jitted call: batch_inv (whose every nonzero output
# is JAX's inv_mod of its input), pow_table, neg_mod, pow_const, ge,
# cond_sub, mul_wide, reduce_wide (both modes) and _sum_mod.
# ---------------------------------------------------------------------------

POW_EXPONENTS = (0, 1, 13)
GE_WIDTHS = (16, 3)
SUM_COUNTS = (1, 2, 3, 5, 8)


def _wide(vals, width=32):
    """Python ints -> [n, width] normalized limbs."""
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(width)]
                     for v in vals], dtype=np.uint32)


def _int_of(row):
    return sum(int(x) << (16 * i) for i, x in enumerate(row))


def _ge_operands(width):
    """Pairs of [n, width]-limb integers: random, equal, off by the low limb,
    off by the top bit, zero, the top of the range."""
    rng = random.Random(11 + width)
    top = 1 << (16 * width)
    xs = [rng.randrange(top) for _ in range(12)] + [0, top - 1, 5, 5]
    ys = [rng.randrange(top) for _ in range(12)] + [0, 0, 5, 4]
    xs[1] = ys[1] ^ 1
    xs[2] = ys[2] ^ (1 << (16 * width - 1))
    return xs, ys


def _wide_operands():
    """Reduction inputs: p^2 (whose lazy residue lies in [p, 2^256), not the
    canonical value), products of edge values, the top of the range, and
    unnormalized columns up to 2^21 - 1."""
    rng = random.Random(14)
    vals = [P * P, 0, 1, P * (P - 1), (P - 1) ** 2, P * P - 1, 2**512 - 1,
            (2**256 - 1) ** 2] + [rng.randrange(1 << 512) for _ in range(24)]
    cols = np.random.RandomState(15).randint(0, 1 << 21, (16, 32))
    cols[0] = (1 << 21) - 1
    cols[1, :16] = 0
    return np.concatenate([_wide(vals), cols.astype(np.uint32)])


def _sum_operands(n):
    vals = [v % P for v in _vals(20 + n, 3 * n + 6)[6:]]
    return vals, _np(vals).reshape(3, n, 16)


@pytest.fixture(scope="module")
def jax_ref():
    import jax

    rows = _np([v % P for v in _vals(31)]).reshape(3, 8, 16).copy()
    rows[1, 2] = 0                                       # zeros map to 0
    rows[2, 5:] = 0
    base = 0x1234567 * 2**200 + 99
    table = fp.pow2_table(base, 32)
    e = np.array([0, 1, 5, 0xFFFFFFFF, 0x80000000, 123456789],
                 dtype=np.uint32)
    ge_in = {w: tuple(_wide(v, w) for v in _ge_operands(w))
             for w in GE_WIDTHS}
    mw = (_np(_vals(12)), _np(list(reversed(_vals(13)))))
    sums = {n: _sum_operands(n)[1] for n in SUM_COUNTS}

    def jax_side(r, t, x, ge_in, mw, w, sums):
        ge = {k: JF.ge(a, b) for k, (a, b) in ge_in.items()}
        return {
            "batch_inv": JF.batch_inv(r), "pow_table": JF.pow_table(t, x, 32),
            "neg_mod": JF.neg_mod(r[0]),
            "pow_const": [JF.pow_const(r[0], k) for k in POW_EXPONENTS],
            "ge": ge,
            "cond_sub": {k: JF.cond_sub(a, b, ge[k])
                         for k, (a, b) in ge_in.items()},
            "mul_wide": JF.mul_wide(*mw),
            "reduce_wide": {c: JF.reduce_wide(w, canonical=c)
                            for c in (True, False)},
            "_sum_mod": {n: JF._sum_mod(v) for n, v in sums.items()},
        }

    out = jax.tree_util.tree_map(np.asarray, jax.jit(jax_side)(
        rows, table, e, ge_in, mw, _wide_operands(), sums))
    out.update({"rows": rows, "table": table, "e": e, "base": base})
    return out


def test_neg_and_pow_const_vs_jax(jax_ref):
    v = jax_ref["rows"][0]
    np.testing.assert_array_equal(_n(F.neg_mod(_t(v))),
                                  jax_ref["neg_mod"])
    assert _ints(_n(F.neg_mod(_t(v)))) == [-x % P for x in _ints(v)]
    for k, want in zip(POW_EXPONENTS, jax_ref["pow_const"]):
        got = _n(F.pow_const(_t(v), k))
        np.testing.assert_array_equal(got, want)
        assert _ints(got) == [pow(x, k, P) for x in _ints(v)]


def test_inv_mod_vs_jax(jax_ref):
    rows, want = jax_ref["rows"], jax_ref["batch_inv"]
    got = _n(F.inv_mod(_t(rows)))
    np.testing.assert_array_equal(got, want)          # 0 -> 0 on both sides
    assert _ints(got) == [pow(x, P - 2, P) for x in _ints(rows)]
    # a raw input is canonicalized first
    assert _ints(_n(F.inv_mod(_t(_np([P + 2]))))) == [pow(2, P - 2, P)]
    assert _ints(_n(F.pow2k(_t(_np([3])), 5))) == [pow(3, 32, P)]


def test_batch_inv_vs_jax(jax_ref):
    rows, want = jax_ref["rows"], jax_ref["batch_inv"]
    np.testing.assert_array_equal(_n(F.batch_inv(_t(rows))), want)
    moved = np.ascontiguousarray(np.moveaxis(rows, 1, 0))
    np.testing.assert_array_equal(_n(F.batch_inv(_t(moved), axis=0)),
                                  np.moveaxis(want, 1, 0))


def test_pow_table_vs_jax(jax_ref):
    d = jax_ref
    got = _n(F.pow_table(_t(d["table"]), _t(d["e"]), 32))
    np.testing.assert_array_equal(got, d["pow_table"])
    assert _ints(got) == [pow(d["base"], int(x), P) for x in d["e"]]


@pytest.mark.parametrize("width", GE_WIDTHS)
def test_ge_and_cond_sub(jax_ref, width):
    xs, ys = _ge_operands(width)
    a, b = _wide(xs, width), _wide(ys, width)
    got = F.ge(_t(a), _t(b))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), jax_ref["ge"][width])
    assert got.tolist() == [x >= y for x, y in zip(xs, ys)]
    d = _n(F.cond_sub(_t(a), _t(b), got))
    np.testing.assert_array_equal(d, jax_ref["cond_sub"][width])
    assert [_int_of(r) for r in d] == [x - y if x >= y else x
                                       for x, y in zip(xs, ys)]


def test_mul_wide(jax_ref):
    xs, ys = _vals(12), list(reversed(_vals(13)))
    got = _n(F.mul_wide(_t(_np(xs)), _t(_np(ys))))
    assert got.shape == (len(xs), 32)
    np.testing.assert_array_equal(got, jax_ref["mul_wide"])
    assert [_int_of(r) for r in got] == [x * y for x, y in zip(xs, ys)]


@pytest.mark.parametrize("canonical", [True, False])
def test_reduce_wide(jax_ref, canonical):
    """Both modes bit for bit against JAX (_wide_operands)."""
    w = _wide_operands()
    got = _n(F.reduce_wide(_t(w), canonical=canonical))
    np.testing.assert_array_equal(got, jax_ref["reduce_wide"][canonical])
    for row, r in zip(w, got):
        assert _int_of(r) % P == _int_of(row) % P
        assert _int_of(r) < (P if canonical else 2**256)
    assert (_int_of(got[0]) >= P) is not canonical       # p^2


@pytest.mark.parametrize("n", SUM_COUNTS)
def test_sum_mod(jax_ref, n):
    vals, x = _sum_operands(n)
    want = jax_ref["_sum_mod"][n]
    np.testing.assert_array_equal(_n(F._sum_mod(_t(x))), want)
    moved = np.ascontiguousarray(np.moveaxis(x, 1, 0))
    np.testing.assert_array_equal(_n(F._sum_mod(_t(moved), axis=0)), want)
    assert _ints(want) == [sum(vals[i * n:(i + 1) * n]) % P for i in range(3)]
