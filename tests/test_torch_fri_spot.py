"""Plain versions of the FRI row kernel and the spot-check kernel against the
JAX package's Pallas kernels in interpret mode and against the oracle.
Tolerance 0."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from stark_verifier_tpu.config import StarkConfig as JCfg, cached_tables as jtables
from stark_verifier_tpu.ops import field as JF, fri_pallas, spot_pallas
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.ops import field as F, fri_cuda, quartic, spot_cuda

torch.set_num_threads(1)
P = fp.MODULUS


@pytest.fixture(autouse=True)
def _tiny_tiles(monkeypatch):
    monkeypatch.setattr(fri_pallas, "LANE_TILE", 128)
    monkeypatch.setattr(spot_pallas, "LANE_TILE", 128)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _rows_case(G, sx_int, seed):
    """G random row groups on the default statement's power table (the
    construction of the JAX package's own row-kernel test)."""
    rng = random.Random(seed)
    tables = jtables(JCfg())
    g2t = np.asarray(tables.g2_powers)
    e1 = [rng.randrange(65536) for _ in range(G)]
    x1_inv = g2t[[(-e) & 65535 for e in e1]]
    x1sq_inv = g2t[[(-2 * e) & 65535 for e in e1]]
    rows = [[rng.randrange(1 << 256) for _ in range(4)] for _ in range(G)]
    rows[0] = [(1 << 256) - 1, P, P + 1, 0]
    ys = np.stack([fp.ints_to_limbs(r) for r in rows])
    sx = fp.int_to_limbs(sx_int % (1 << 256))
    return tables, e1, rows, x1_inv, x1sq_inv, ys, sx


def _oracle_rows(tables, e1_list, rows, sx_int):
    G2 = tables.G2
    qr = [1, pow(G2, 16384, P), pow(G2, 32768, P), pow(G2, 49152, P)]
    xs, ys = [], []
    for e1, row in zip(e1_list, rows):
        x1 = pow(G2, e1, P)
        xs += [q * x1 % P for q in qr]
        ys += row
    polys = oracle.multi_interp_4(xs, ys)
    return [oracle.eval_quartic(polys[4 * g: 4 * g + 4], sx_int)
            for g in range(len(e1_list))]


@pytest.mark.parametrize("sx_int", [
    0xC0FFEE << 230 | 12345,            # raw, below p
    (1 << 256) - 1,                     # raw, unreduced (>= p)
    P + 7])
def test_eval4_rows_plain(sx_int):
    tables, e1, rows, x1_inv, x1sq_inv, ys, sx = _rows_case(12, sx_int, 0x4A11)
    ginv, inv4 = np.asarray(tables.quartic_ginv), np.asarray(tables.inv4)
    ys_w = np.asarray(JF.limbs_to_words_be(jnp.asarray(ys)))
    want_w = np.asarray(fri_pallas.eval4_rows(
        jnp.asarray(x1_inv), jnp.asarray(x1sq_inv), jnp.asarray(ys_w),
        jnp.asarray(sx), ginv, inv4, interpret=True))
    got_w = fri_cuda.eval4_rows(_t(x1_inv), _t(x1sq_inv), _t(ys_w), _t(sx),
                                ginv, inv4)
    np.testing.assert_array_equal(_n(got_w), want_w)
    got = _n(F.words_be_to_limbs(got_w))
    assert [fp.limbs_to_int(r) for r in got] == _oracle_rows(
        tables, e1, rows, sx_int)
    # the even/odd form by itself (module ops/quartic.py), limbs in and out
    lhs = quartic.eval4_even_odd(_t(x1_inv), _t(x1sq_inv), _t(ys), _t(sx),
                                 _t(ginv), _t(inv4))
    np.testing.assert_array_equal(_n(lhs), got)


def test_eval4_rows_batched_levels():
    """The verifier's call shape: [B, L, q] row groups, one sx per (B, L)."""
    tables, _, _, x1_inv, x1sq_inv, ys, _ = _rows_case(12, 5, 99)
    ginv, inv4 = np.asarray(tables.quartic_ginv), np.asarray(tables.inv4)
    rng = random.Random(3)
    sx = fp.ints_to_limbs([rng.randrange(1 << 256) for _ in range(4)]
                          ).reshape(2, 2, 16)
    ys_w = np.asarray(JF.limbs_to_words_be(jnp.asarray(ys))).reshape(2, 2, 3, 4, 8)
    xi = x1_inv.reshape(2, 2, 3, 16)
    xsq = x1sq_inv.reshape(2, 2, 3, 16)
    want = np.asarray(fri_pallas.eval4_rows(
        jnp.asarray(xi), jnp.asarray(xsq), jnp.asarray(ys_w), jnp.asarray(sx),
        ginv, inv4, interpret=True))
    got = fri_cuda.eval4_rows(_t(xi), _t(xsq), _t(ys_w), _t(sx), ginv, inv4)
    np.testing.assert_array_equal(_n(got), want)


def _rand_limbs(rng, shape, canonical=False):
    v = rng.randint(0, 1 << 16, shape + (16,)).astype(np.uint32)
    v.reshape(-1, 16)[0] = 0xFFFF                    # 2^256 - 1
    if canonical:
        v = np.asarray(JF.canon(jnp.asarray(v)))
    return v


@pytest.mark.parametrize("power", [3, 2])
def test_spot_checks_plain(power):
    rng = np.random.RandomState(11 + power)
    n = 10
    raw5 = _rand_limbs(rng, (n, 5))
    tab5 = _rand_limbs(rng, (n, 5), canonical=True)
    ks4 = _rand_limbs(rng, (4,))
    ic1 = _rand_limbs(rng, (), canonical=True)
    ic0 = _rand_limbs(rng, (), canonical=True)

    # make individual families PASS on chosen positions (a canonical rhs is
    # a valid raw encoding of itself)
    p, d, b = (F.canon(_t(raw5[:, i])) for i in (0, 2, 3))
    x, xs, z, z2, k = (_t(tab5[:, i]) for i in range(5))
    p_pow = [(F.sqr_mod(p), p)] if power == 3 else [(p, p)]
    raw5[0, 1] = _n(F.mul_sum_mod(p_pow + [(z, d)], extra=[k]))[0]
    raw5[2, 4] = _n(F.mul_sum_mod(
        [(_t(ks4[0]), p), (_t(ks4[1]), F.mul_mod(p, xs)),
         (_t(ks4[2]), b), (_t(ks4[3]), F.mul_mod(b, xs))], extra=[d]))[2]
    raw5[1, 0] = _n(F.mul_sum_mod([(b, z2), (_t(ic1), x)],
                                  extra=[_t(ic0).expand(n, 16)]))[1]

    want = np.asarray(spot_pallas.spot_checks(
        jnp.asarray(raw5), jnp.asarray(tab5), jnp.asarray(ks4),
        jnp.asarray(ic1), jnp.asarray(ic0), interpret=True, power=power))
    got = spot_cuda.spot_checks(_t(raw5), _t(tab5), _t(ks4), _t(ic1), _t(ic0),
                                power=power)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] and want[1, 1] and want[2, 2]
    assert not want[3:].any()


def test_spot_checks_verifier_call_shape():
    """[B, 80-like] positions with per-proof k's and interpolant
    coefficients broadcast over positions."""
    rng = np.random.RandomState(5)
    raw5 = _rand_limbs(rng, (2, 6, 5))
    tab5 = _rand_limbs(rng, (2, 6, 5), canonical=True)
    ks4 = _rand_limbs(rng, (2, 1, 4))
    ic1 = _rand_limbs(rng, (2, 1), canonical=True)
    ic0 = _rand_limbs(rng, (2, 1), canonical=True)
    raw5[1, 3, 1] = raw5[1, 3, 0]        # arbitrary edit; verdicts just compare
    want = np.asarray(spot_pallas.spot_checks(
        jnp.asarray(raw5), jnp.asarray(tab5), jnp.asarray(ks4),
        jnp.asarray(ic1), jnp.asarray(ic0), interpret=True))
    got = spot_cuda.spot_checks(_t(raw5), _t(tab5), _t(ks4), _t(ic1), _t(ic0))
    assert got.shape == (2, 6, 3) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_spot_checks_bad_power_raises():
    z = torch.zeros((1, 5, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        spot_cuda.spot_checks(z, z, z[:, :4], z[0, 0], z[0, 0], power=5)
