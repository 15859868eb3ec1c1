"""Plain versions of the FRI row kernel and the spot-check kernel against the
JAX package's Pallas kernels in interpret mode and against the oracle (both
on the proof's words and packed tables, the JAX functions on the limbs and
gathers of the same values).  Tolerance 0."""

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


def _be_words(x):
    """An integer < 2^256 -> its 8 big-endian wire words (numpy uint32)."""
    return _be(fp.int_to_limbs(x))


def _fri_case(rng, tables, b, nl, q):
    """Kernel C's operands for b proofs of nl levels and q queries, as the
    proof holds them: raw poly rows and column values (0xFFFFFFFF words,
    values >= p), column indices over the whole 32-bit range with 0 and the
    top of the range on the last level, roots >= p."""
    poly = _rand_words(rng, (b, nl, 4 * q, 8))
    col = _rand_words(rng, (b, nl, q, 8))
    ys = rng.randint(0, 2**32, (b, nl, q), dtype=np.uint64).astype(np.int64)
    ys[0, -1, :3] = [0, 2**32 - 1, tables.level_moduli[-1] - 1]
    lroot = _rand_words(rng, (b, 8))
    root2 = _rand_words(rng, (b, nl, 8))
    lroot[0] = 0xFFFFFFFF                        # 2^256 - 1
    root2[-1, 0] = _be_words(P)
    root2[0, 1] = _be_words(P + 3)
    # query 0 of proof b-1, level 2: rows 5, 5 + p, 5, 5 (the constant 5);
    # query 3 the same constant, every row encoded as 5 + p
    poly[-1, 2, 0:4] = [_be_words(v) for v in (5, P + 5, 5, 5)]
    poly[-1, 2, 12:16] = _be_words(P + 5)
    return poly, col, ys, lroot, root2


def _jax_fri_lhs(tables, poly, ys, lroot, root2):
    """The JAX verifier's own pieces (stark_verifier_tpu/protocol/verify.py,
    _fri_checks) up to the compare: special_x's limbs, the uint32 index
    arithmetic, jnp.take of the limb power table, the Pallas row kernel."""
    nl, q = ys.shape[-2:]
    g2t = jnp.asarray(tables.g2_powers)
    mask = jnp.uint32(tables.g2_powers.shape[0] - 1)
    lvl_mult = jnp.asarray(np.array([4 ** l for l in range(nl)],
                                    dtype=np.uint32))[:, None]
    e1 = (jnp.asarray(ys.astype(np.uint32)) * lvl_mult) & mask
    x1_inv = jnp.take(g2t, (jnp.uint32(0) - e1) & mask, axis=0)
    x1sq_inv = jnp.take(g2t, (jnp.uint32(0) - jnp.uint32(2) * e1) & mask,
                        axis=0)
    prev = np.concatenate([lroot[:, None], root2[:, :-1]], axis=1)
    special_x = JF.words_be_to_limbs(jnp.asarray(prev))
    rows_w = jnp.asarray(poly).reshape(*poly.shape[:-2], q, 4, 8)
    return np.asarray(fri_pallas.eval4_rows(
        x1_inv, x1sq_inv, rows_w, special_x, np.asarray(tables.quartic_ginv),
        np.asarray(tables.inv4), interpret=True))


@pytest.mark.parametrize("log_steps", [13, 9])
def test_fri_rows_plain(log_steps):
    """C's plain version on the proof's words, the indices, the roots and
    the packed power table against the JAX verifier's gathers, Pallas row
    kernel and compare, at the default statement's table (2^16 rows) and a
    small one (2^12).  The committed values hold at every even query; a
    tampered word and a non-canonical encoding of the right value reject."""
    tables = jtables(JCfg(log_steps=log_steps))
    b, nl, q = 2, 5, 4
    rng = np.random.RandomState(40 + log_steps)
    poly, col, ys, lroot, root2 = _fri_case(rng, tables, b, nl, q)
    want_lhs = _jax_fri_lhs(tables, poly, ys, lroot, root2)
    col[:, :, 0::2] = want_lhs[:, :, 0::2]
    col[0, 1, 2, 7] ^= 1                         # a tampered word
    col[-1, 2, 3] = _be_words(P + 5)             # 5, not canonical
    want_ok = np.asarray(jnp.all(jnp.asarray(want_lhs) == jnp.asarray(col),
                                 axis=-1))
    expect = np.zeros((b, nl, q), dtype=bool)
    expect[:, :, 0::2] = True
    expect[0, 1, 2] = False
    assert np.array_equal(want_ok, expect)
    assert fp.limbs_to_int(_n(F.words_be_to_limbs(_t(want_lhs[-1, 2, 3])))) == 5
    g2w = _t(fp.limbs_to_le_words(np.asarray(tables.g2_powers)))
    ok, got_lhs = fri_cuda.fri_rows(
        _t(poly), _t(col), torch.from_numpy(ys), _t(lroot), _t(root2), g2w,
        tables.quartic_ginv, tables.inv4, lhs=True)
    assert ok.dtype == torch.bool and ok.shape == (b, nl, q)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(_n(got_lhs), want_lhs)
    assert torch.equal(fri_cuda.fri_rows(
        _t(poly), _t(col), torch.from_numpy(ys), _t(lroot), _t(root2), g2w,
        tables.quartic_ginv, tables.inv4), ok)


def _rand_limbs(rng, shape, canonical=False):
    v = rng.randint(0, 1 << 16, shape + (16,)).astype(np.uint32)
    v.reshape(-1, 16)[0] = 0xFFFF                    # 2^256 - 1
    if canonical:
        v = _n(F.canon(_t(v))).copy()
    return v


def _rand_words(rng, shape):
    """Raw proof words: any 32-byte value, 0xFFFFFFFF words mixed in (so
    some values are >= p)."""
    w = rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[5::23] = 0xFFFFFFFF
    return w


def _be(limbs):
    """Limbs -> the proof's 8 BE words (numpy, uint32)."""
    return _n(F.limbs_to_words_be(limbs if isinstance(limbs, torch.Tensor)
                                  else _t(limbs)))


ROWS, LOG_STEPS, K_ROWS = 64, 3, 16     # small statement tables


def _spot_case(rng, lead, n, k_rows=K_ROWS):
    """Kernel D's operands as the verifier hands them over, made small:
    main value rows [*lead, 2n, 24] and lincomb rows [*lead, n, 8] of raw
    BE words (some 0xFFFFFFFF words, some values >= p), positions, raw
    k-hash words, canonical interpolant limbs, packed tables (a K table of
    k_rows rows); and, beside them, the limbs and gathers the JAX function
    takes for the same values."""
    main = _rand_words(rng, lead + (2 * n, 24))
    lin = _rand_words(rng, lead + (n, 8))
    lin.reshape(-1)[::8][1::3] = 0xFFFFFFFF          # values >= p
    pos = rng.randint(0, 1 << 20, lead + (n,)).astype(np.int64)
    kh = _rand_words(rng, lead + (4, 8))
    ic1 = _rand_limbs(rng, lead, canonical=True)
    ic0 = _rand_limbs(rng, lead, canonical=True)
    tabs = {name: _rand_limbs(rng, (rows,), canonical=True)
            for name, rows in (("g2", ROWS), ("z", ROWS), ("z2", ROWS),
                               ("k", k_rows))}
    mask = ROWS - 1
    tab5 = np.stack([tabs["g2"][pos & mask],
                     tabs["g2"][(pos << LOG_STEPS) & mask],
                     tabs["z"][pos & mask], tabs["z2"][pos & mask],
                     tabs["k"][pos & (k_rows - 1)]], axis=-2)
    words = dict(main=main, lin=lin, pos=pos, kh=kh, ic1=ic1, ic0=ic0,
                 tabs=tabs)
    return words, tab5


def _limbs_of(words):
    """raw5 [..., n, 5, 16] and ks4 [..., 1, 4, 16] from the word operands,
    with the JAX package's conversion."""
    lead_n = words["lin"].shape[:-1]
    mv = words["main"].reshape(lead_n + (2, 3, 8))
    raw = np.stack([mv[..., 0, 0, :], mv[..., 1, 0, :], mv[..., 0, 1, :],
                    mv[..., 0, 2, :], words["lin"]], axis=-2)
    raw5 = np.asarray(JF.words_be_to_limbs(jnp.asarray(raw)))
    ks4 = np.asarray(JF.words_be_to_limbs(jnp.asarray(words["kh"])))
    return raw5, ks4[..., None, :, :]


def _port_spot(words, power):
    tabs = spot_cuda.SpotTables(
        *(_t(fp.limbs_to_le_words(words["tabs"][k]))
          for k in ("g2", "z", "z2", "k")), log_steps=LOG_STEPS)
    return spot_cuda.spot_checks(
        _t(words["main"]), _t(words["lin"]), torch.from_numpy(words["pos"]),
        _t(words["kh"]), _t(words["ic1"]), _t(words["ic0"]), tabs,
        power=power)


def _make_hold(words, tab5, power, at):
    """Rewrite the committed values so that each family holds at one
    position of `at` (a canonical right-hand side is a valid raw encoding
    of itself): transition at at[0], lincomb at at[1], boundary at at[2]."""
    raw5, ks4 = _limbs_of(words)
    p, d, b = (F.canon(_t(raw5[..., i, :])) for i in (0, 2, 3))
    x, xs, z, z2, k = (_t(tab5[..., i, :]) for i in range(5))
    k1, k2, k3, k4 = (_t(ks4[..., i, :]) for i in range(4))
    p_pow = [(F.sqr_mod(p), p)] if power == 3 else [(p, p)]
    rhs_t = _be(F.mul_sum_mod(p_pow + [(z, d)], extra=[k]))
    rhs_l = _be(F.mul_sum_mod([(k1, p), (k2, F.mul_mod(p, xs)), (k3, b),
                               (k4, F.mul_mod(b, xs))], extra=[d]))
    ic1, ic0 = _t(words["ic1"])[..., None, :], _t(words["ic0"])[..., None, :]
    rhs_b = _be(F.mul_sum_mod([(b, z2), (ic1, x)], extra=[ic0.expand(x.shape)]))
    lead_n = words["lin"].shape[:-1]
    mv = words["main"].reshape(lead_n + (2, 3, 8))
    mv[at[0] + (1, 0)] = rhs_t[at[0]]                # P(g1 x)
    words["lin"][at[1]] = rhs_l[at[1]]               # L(x)
    mv[at[2] + (0, 0)] = rhs_b[at[2]]                # P(x): bit 1 only there


def _jax_spot(words, tab5, power):
    raw5, ks4 = _limbs_of(words)
    return np.asarray(spot_pallas.spot_checks(
        jnp.asarray(raw5), jnp.asarray(tab5), jnp.asarray(ks4),
        jnp.asarray(words["ic1"][..., None, :]),
        jnp.asarray(words["ic0"][..., None, :]), interpret=True, power=power))


@pytest.mark.parametrize("power", [3, 2])
def test_spot_checks_plain(power):
    """D's plain version on the proof's words and the packed tables against
    the JAX function on the limbs and gathers of the same values, with each
    family holding at one position and failing elsewhere."""
    rng = np.random.RandomState(11 + power)
    words, tab5 = _spot_case(rng, (), 10)
    _make_hold(words, tab5, power, [(0,), (2,), (1,)])
    want = _jax_spot(words, tab5, power)
    got = _port_spot(words, power)
    assert got.shape == (10, 3) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] and want[1, 1] and want[2, 2]
    assert not want[3:].any()


@pytest.mark.parametrize("k_rows", [K_ROWS, 512])
@pytest.mark.parametrize("power", [3, 2])
def test_spot_checks_verifier_call_shape(power, k_rows):
    """[B, n] positions with per-proof k's and interpolant coefficients,
    and K tables of the statement's size and of a larger one (the
    runtime-statement path's own table at one constant a round)."""
    rng = np.random.RandomState(5 + power)
    words, tab5 = _spot_case(rng, (2,), 6, k_rows=k_rows)
    _make_hold(words, tab5, power, [(1, 3), (0, 5), (1, 0)])
    want = _jax_spot(words, tab5, power)
    got = _port_spot(words, power)
    assert got.shape == (2, 6, 3) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1, 3, 0] and want[0, 5, 2] and want[1, 0, 1]


def test_spot_checks_bad_power_raises():
    rng = np.random.RandomState(1)
    words, _ = _spot_case(rng, (), 4)
    with pytest.raises(ValueError):
        _port_spot(words, 5)
