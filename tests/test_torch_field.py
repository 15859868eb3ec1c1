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
# exponentiation and inversion (products through mul_mod), against the JAX
# package's namesakes.  The JAX inversion chain costs seconds to compile, so
# everything is compiled once, in one jitted call: batch_inv (whose every
# nonzero output is JAX's inv_mod of its input), pow_table, neg_mod and
# pow_const.
# ---------------------------------------------------------------------------

POW_EXPONENTS = (0, 1, 13)


@pytest.fixture(scope="module")
def inversions():
    import jax

    rows = _np([v % P for v in _vals(31)]).reshape(3, 8, 16).copy()
    rows[1, 2] = 0                                       # zeros map to 0
    rows[2, 5:] = 0
    base = 0x1234567 * 2**200 + 99
    table = fp.pow2_table(base, 32)
    e = np.array([0, 1, 5, 0xFFFFFFFF, 0x80000000, 123456789],
                 dtype=np.uint32)
    def jax_side(r, t, x):
        return (JF.batch_inv(r), JF.pow_table(t, x, 32), JF.neg_mod(r[0]),
                [JF.pow_const(r[0], k) for k in POW_EXPONENTS])

    jinv, jpow, jneg, jpows = jax.jit(jax_side)(
        jnp.asarray(rows), jnp.asarray(table), jnp.asarray(e))
    return {"rows": rows, "table": table, "e": e, "base": base,
            "batch_inv": np.asarray(jinv), "pow_table": np.asarray(jpow),
            "neg_mod": np.asarray(jneg),
            "pow_const": [np.asarray(x) for x in jpows]}


def test_neg_and_pow_const_vs_jax(inversions):
    v = inversions["rows"][0]
    np.testing.assert_array_equal(_n(F.neg_mod(_t(v))),
                                  inversions["neg_mod"])
    assert _ints(_n(F.neg_mod(_t(v)))) == [-x % P for x in _ints(v)]
    for k, want in zip(POW_EXPONENTS, inversions["pow_const"]):
        got = _n(F.pow_const(_t(v), k))
        np.testing.assert_array_equal(got, want)
        assert _ints(got) == [pow(x, k, P) for x in _ints(v)]


def test_inv_mod_vs_jax(inversions):
    rows, want = inversions["rows"], inversions["batch_inv"]
    got = _n(F.inv_mod(_t(rows)))
    np.testing.assert_array_equal(got, want)          # 0 -> 0 on both sides
    assert _ints(got) == [pow(x, P - 2, P) for x in _ints(rows)]
    # a raw input is canonicalized first
    assert _ints(_n(F.inv_mod(_t(_np([P + 2]))))) == [pow(2, P - 2, P)]
    assert _ints(_n(F.pow2k(_t(_np([3])), 5))) == [pow(3, 32, P)]


def test_batch_inv_vs_jax(inversions):
    rows, want = inversions["rows"], inversions["batch_inv"]
    np.testing.assert_array_equal(_n(F.batch_inv(_t(rows))), want)
    moved = np.ascontiguousarray(np.moveaxis(rows, 1, 0))
    np.testing.assert_array_equal(_n(F.batch_inv(_t(moved), axis=0)),
                                  np.moveaxis(want, 1, 0))


def test_pow_table_vs_jax(inversions):
    d = inversions
    got = _n(F.pow_table(_t(d["table"]), _t(d["e"]), 32))
    np.testing.assert_array_equal(got, d["pow_table"])
    assert _ints(got) == [pow(d["base"], int(x), P) for x in d["e"]]
