"""The element-wise multiply (kernel E): the port's ops/field_cuda.mul_mod,
which on the CPU is the kernel's plain version, against the Pallas kernel it
replaces (interpret mode), the JAX package's field.mul_mod and Python ints.
Same numpy inputs on every side; integer arithmetic, tolerance 0."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stark_verifier_tpu.ops import field as JF, field_pallas
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.ops import (
    field as F, field_cuda, fri_cuda, quartic, spot_cuda)

torch.set_num_threads(1)
P = fp.MODULUS
EDGE = [0, 1, 2, P - 1, P - 2, P, P + 1, (1 << 256) - 1, fp.FOLD_C,
        1 << 255, (1 << 128) - 1]


def _vals(seed, n=64):
    rng = random.Random(seed)
    return EDGE + [rng.randrange(1 << 256) for _ in range(n - len(EDGE))]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _ints(a):
    return [fp.limbs_to_int(r) for r in a.reshape(-1, 16)]


@pytest.fixture(scope="module")
def operands():
    xs = _vals(1)
    ys = list(reversed(_vals(2)))
    return xs, ys, fp.ints_to_limbs(xs), fp.ints_to_limbs(ys)


def test_mul_mod_vs_pallas_interpret(operands):
    xs, ys, a, b = operands
    got = _n(field_cuda.mul_mod(_t(a), _t(b)))
    want = np.asarray(field_pallas.mul_mod(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    np.testing.assert_array_equal(got, want)


def test_mul_mod_vs_jax_field_and_ints(operands):
    xs, ys, a, b = operands
    got = _n(field_cuda.mul_mod(_t(a), _t(b)))
    np.testing.assert_array_equal(
        got, np.asarray(JF.mul_mod(jnp.asarray(a), jnp.asarray(b))))
    assert _ints(got) == [x * y % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("edge", [0, P - 1, P, P + 1, (1 << 256) - 1])
def test_mul_mod_edge_values_on_both_sides(edge):
    """Every edge value against every edge value and a few random ones, as
    left and as right operand."""
    others = EDGE + _vals(3, 16)[len(EDGE):]
    e = _t(fp.int_to_limbs(edge))
    o = _t(fp.ints_to_limbs(others))
    want = [edge * y % P for y in others]
    assert _ints(_n(field_cuda.mul_mod(e, o))) == want
    assert _ints(_n(field_cuda.mul_mod(o, e))) == want


@pytest.mark.parametrize("shape_a,shape_b", [
    ((512, 16), (16,)), ((32, 16), (32, 16)), ((64, 16), (16,)),
    ((4, 8, 16), (8, 16)), ((3, 1, 16), (1, 5, 16))])
def test_mul_mod_broadcast_shapes(shape_a, shape_b):
    rng = np.random.RandomState(4)

    def limbs(shape):
        return rng.randint(0, 1 << 16, shape).astype(np.uint32)

    a, b = limbs(shape_a), limbs(shape_b)
    got = _n(field_cuda.mul_mod(_t(a), _t(b)))
    want = np.asarray(JF.mul_mod(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == np.broadcast_shapes(shape_a, shape_b)


def test_period_of_a_trailing_block_and_of_any_other_broadcast():
    lead = (4, 8)
    z = torch.zeros
    assert field_cuda._period(z((16,), dtype=torch.int32), lead)[1] == 1
    assert field_cuda._period(z((8, 16), dtype=torch.int32), lead)[1] == 8
    assert field_cuda._period(z((1, 8, 16), dtype=torch.int32), lead)[1] == 8
    assert field_cuda._period(z((4, 8, 16), dtype=torch.int32), lead)[1] == 32
    t, period = field_cuda._period(z((4, 1, 16), dtype=torch.int32), lead)
    assert period == 32 and t.shape == (4, 8, 16) and t.is_contiguous()


def test_wide_limbs_are_rejected_not_wrapped():
    a = _t(fp.ints_to_limbs([3, 5, 7]))
    b = _t(fp.ints_to_limbs([2, 2, 2]))
    a[1, 0] = 1 << 16
    b[2, 9] = -5
    got = field_cuda.mul_mod(a, b)
    assert _ints(_n(got[:1])) == [6]
    assert (got[1:] == -1).all()
    assert (field_cuda.mul_mod(got, b)[1:] == -1).all()   # and stays so


def test_field_mul_mod_is_the_dispatch(operands, monkeypatch):
    """field.mul_mod, sqr_mod and mul_mod_lazy go through field_cuda.mul_mod;
    a CPU tensor takes the plain version."""
    xs, ys, a, b = operands
    calls = []
    real = field_cuda.mul_mod
    monkeypatch.setattr(field_cuda, "mul_mod",
                        lambda x, y: calls.append(1) or real(x, y))
    want = field_cuda.mul_mod_plain(_t(a), _t(b))
    assert torch.equal(F.mul_mod(_t(a), _t(b)), want)
    assert torch.equal(F.mul_mod_lazy(_t(a), _t(b)), want)
    assert _ints(_n(F.sqr_mod(_t(a)))) == [x * x % P for x in xs]
    assert len(calls) == 3 and field_cuda.launches["mul_mod"] == 0


def test_no_fallback_for_a_tensor_that_is_not_on_the_cpu():
    z = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(Exception):
        F.mul_mod(z, z)
    assert field_cuda.launches["mul_mod"] == 0
    with pytest.raises(TypeError):
        field_cuda.mul_mod(z.to(torch.int64), z)
    with pytest.raises(ValueError):
        field_cuda.mul_mod(z[:, :8], z[:, :8])


def test_plain_versions_of_the_other_kernels_do_not_reach_the_dispatch(
        monkeypatch):
    """The plain versions of the FRI row and spot-check kernels multiply
    through mul_mod_plain: with the dispatch broken they still run."""
    def broken(a, b):
        raise AssertionError("a plain version called the multiply's dispatch")

    monkeypatch.setattr(field_cuda, "mul_mod", broken)
    rng = np.random.RandomState(5)

    def limbs(*shape):
        return _t(rng.randint(0, 1 << 16, shape + (16,)).astype(np.uint32))

    ginv, inv4 = limbs(), limbs()
    out = quartic.eval4_even_odd(F.canon(limbs(2, 3)), F.canon(limbs(2, 3)),
                                 limbs(2, 3, 4), limbs(2), ginv, inv4)
    assert out.shape == (2, 3, 16)
    words = F.limbs_to_words_be(limbs(2, 3, 4))
    assert fri_cuda.eval4_rows(
        F.canon(limbs(2, 3)), F.canon(limbs(2, 3)), words, limbs(2),
        ginv, inv4).shape == (2, 3, 8)
    ok, lhs = fri_cuda.fri_rows(
        F.limbs_to_words_be(limbs(2, 5, 12)), F.limbs_to_words_be(
            limbs(2, 5, 3)), torch.arange(30).reshape(2, 5, 3),
        F.limbs_to_words_be(limbs(2)), F.limbs_to_words_be(limbs(2, 5)),
        F.limbs_to_words_le(F.canon(limbs(64))), ginv, inv4, lhs=True)
    assert ok.shape == (2, 5, 3) and lhs.shape == (2, 5, 3, 8)
    for power in (2, 3):
        ok = spot_cuda.spot_limbs_plain(
            limbs(2, 3, 5), F.canon(limbs(2, 3, 5)), limbs(2, 1, 4),
            F.canon(limbs(2, 1)), F.canon(limbs(2, 1)), power)
        assert ok.shape == (2, 3, 3)

    def words(*shape):
        return _t(rng.randint(0, 2**32, shape, dtype=np.uint64)
                  .astype(np.uint32))

    tabs = spot_cuda.SpotTables(
        *(F.limbs_to_words_le(F.canon(limbs(r))) for r in (16, 16, 16, 4)),
        log_steps=2)
    ok = spot_cuda.spot_checks_plain(
        words(2, 6, 24), words(2, 3, 8), torch.arange(6).reshape(2, 3),
        words(2, 4, 8), F.canon(limbs(2)), F.canon(limbs(2)), tabs, power=3)
    assert ok.shape == (2, 3, 3)
    with pytest.raises(AssertionError):
        F.mul_mod(limbs(2), limbs(2))


def test_eval_poly_vs_jax_and_ints():
    rng = random.Random(6)
    coeffs = [rng.randrange(1 << 256) for _ in range(7)] + [P + 3]
    xs = [x % P for x in _vals(7, 20)]
    c, x = fp.ints_to_limbs(coeffs), fp.ints_to_limbs(xs).reshape(4, 5, 16)
    got = _n(F.eval_poly(_t(c), _t(x)))
    np.testing.assert_array_equal(
        got, np.asarray(JF.eval_poly(jnp.asarray(c), jnp.asarray(x))))
    assert _ints(got) == [sum(co * pow(v, i, P) for i, co in enumerate(coeffs))
                          % P for v in xs]
