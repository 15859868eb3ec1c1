"""The modules the runtime-statement and strict paths add around the kernels:
ops/ntt (whose products are the multiply kernel; on the CPU its plain
version) against the JAX package's ntt and the oracle's FFT, the runtime K(x)
path against the statement's K table, and the strict-mode POINTS checks
against the JAX functions called eagerly.  Tolerance 0."""

import random

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
import prover
from stark_verifier_tpu.config import (
    StarkConfig as JCfg, cached_tables as jcached_tables)
from stark_verifier_tpu.ops import merkle as JM, ntt as JN
from stark_verifier_tpu.protocol import verify as JV
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.config import StarkConfig, cached_tables
from stark_verifier_tpu_torch.ops import field as F, field_cuda, merkle as M, ntt
from stark_verifier_tpu_torch.proofio import wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
P = fp.MODULUS
CONSTS = [(i ** 7) ^ 42 for i in range(64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _ints(a):
    return [fp.limbs_to_int(r) for r in np.asarray(a).reshape(-1, 16)]


def _root(n):
    return pow(7, (P - 1) // n, P)


@pytest.mark.parametrize("n", [1, 2, 16, 64])
def test_intt_vs_oracle_and_jax(n):
    """Every size against the oracle's fft_inv; n = 16 also against the JAX
    package's intt, jitted (one compilation; eagerly it compiles every stage,
    five times as long)."""
    rng = random.Random(n)
    vals = [0, P - 1][:n] + [rng.randrange(P) for _ in range(max(0, n - 2))]
    a = fp.ints_to_limbs(vals)
    got = _n(ntt.intt(_t(a), _root(n)))
    assert _ints(got) == oracle.fft_inv(vals, _root(n))
    if n == 16:
        np.testing.assert_array_equal(got, np.asarray(
            jax.jit(JN.intt, static_argnums=1)(jnp.asarray(a), _root(n))))


def test_ntt_forward_batched_and_round_trip():
    """Leading batch dims share the twiddles; forward against the oracle's
    FFT; inverse of forward is the identity."""
    rng = random.Random(7)
    n = 32
    vals = [[rng.randrange(P) for _ in range(n)] for _ in range(3)]
    a = np.stack([fp.ints_to_limbs(v) for v in vals])        # [3, n, 16]
    fwd = ntt.ntt(_t(a), _root(n))
    for row, v in zip(_n(fwd), vals):
        assert _ints(row) == oracle.fft_fwd(v, _root(n))
    np.testing.assert_array_equal(_n(ntt.intt(fwd, _root(n))), a)


def test_ntt_rejects_a_size_that_is_no_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt(torch.zeros((12, 16), dtype=torch.int32), 3)


def test_ntt_products_go_through_the_multiply_dispatch(monkeypatch):
    """What the runtime-statement path's 64-point iNTT launches on the card:
    one launch of the several-stage kernel for its six stages (not six
    launches of the one-stage kernel), reading the caller's limbs through
    the bit-reverse permutation and writing limbs scaled by n^-1; no launch
    of the one-stage kernel or the multiply kernel (the products are the
    NTT kernel's own).  Driven through the card path with a library that
    records each launch's operands."""
    calls = []
    real = field_cuda.mul_mod
    monkeypatch.setattr(field_cuda, "mul_mod",
                        lambda x, y: calls.append(x.shape) or real(x, y))
    seen = []

    class Recorder:
        @staticmethod
        def stark_ntt_block(args, stream):
            a = args._obj
            seen.append((a.s0, a.k, a.lc, a.perm is not None,
                         a.scale is not None, a.src_limbs, a.dst_limbs,
                         a.src == a.dst))
            return 0

        @staticmethod
        def stark_ntt_stage(args, stream):
            seen.append("stage")
            return 0

    before = dict(ntt.launches)
    x = _t(fp.ints_to_limbs(CONSTS))
    out = ntt.ntt_kernel(x, _root(64), inverse=True, lib=Recorder)
    assert out.shape == (64, 16) and calls == []
    assert ntt.launches["ntt_block"] - before["ntt_block"] == len(seen) == 1
    assert ntt.launches["ntt_stage"] == before["ntt_stage"]
    # stages 0..5 in one pass, gather in, n^-1 and limbs out
    assert seen == [(0, 6, 0, True, True, 1, 1, False)]


@pytest.mark.parametrize("family", ["default", "random"])
def test_runtime_k_path_vs_table_and_oracle(family):
    """iNTT of the round constants + Horner at x^skips2: the statement's K
    table for the default constants, the oracle's fft_inv + eval_poly_at for
    any."""
    cfg = StarkConfig(log_steps=9)
    tables = cached_tables(cfg)
    rng = random.Random(0xCD)
    consts = (CONSTS if family == "default"
              else [rng.randrange(1 << 256) % P for _ in range(64)])
    positions = [rng.randrange(cfg.precision) for _ in range(9)]
    g2t = _t(tables.g2_powers)
    pos = torch.tensor(positions, dtype=torch.int64)
    x_sk2 = g2t[(pos * cfg.skips2) & (cfg.precision - 1)]
    minipoly = ntt.intt(_t(fp.ints_to_limbs(consts)), tables.minipoly_root)
    got = _ints(_n(F.eval_poly(minipoly, x_sk2)))
    mini = oracle.fft_inv(consts, tables.minipoly_root)
    assert _ints(_n(minipoly)) == mini
    assert got == [oracle.eval_poly_at(mini, pow(tables.G2, p * cfg.skips2, P))
                   for p in positions]
    if family == "default":
        assert got == [fp.limbs_to_int(tables.k_table[p % tables.k_period])
                       for p in positions]


# ---------------------------------------------------------------------------
# strict mode: the POINTS element bound to the last root and checked directly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def points():
    """POINTS of a fresh log_steps=9 proof, with its tamperings stacked into
    one batch: good; a held-out position; an interpolation position; a
    position divisible by the extension factor (unconstrained by the direct
    check, caught by the binding)."""
    cfg = StarkConfig(log_steps=9, strict=True)
    tables = cached_tables(cfg)
    pb, _ = prover.prove_to_bytes(3, 512, CONSTS)
    p = wire.parse_and_validate(pb, cfg)
    pts, deg = tables.points_pts, cfg.fri_final_maxdeg_plus_1
    batch = np.stack([p.points_words] * 4)
    batch[1, int(pts[deg + 3]), 0] ^= 2
    batch[2, int(pts[0]), 3] ^= 1
    batch[3, 8, 0] ^= 1
    return cfg, tables, batch, p.fri_levels[-1].root2_words


def test_points_checks_vs_jax(points):
    cfg, tables, batch, last_root = points
    jcfg = JCfg(log_steps=9, strict=True)
    jtables = jcached_tables(jcfg)
    direct = V.points_direct_check(_t(batch), tables, cfg)
    np.testing.assert_array_equal(direct.numpy(), np.asarray(jax.jit(
        lambda b: JV.points_direct_check(b, jtables, jcfg))(jnp.asarray(batch))))
    assert direct.tolist() == [True, False, False, True]
    binding = V.points_root_binding(_t(batch), _t(last_root))
    np.testing.assert_array_equal(
        binding.numpy(),
        np.asarray(JV.points_root_binding(jnp.asarray(batch),
                                          jnp.asarray(last_root))))
    assert binding.tolist() == [True, False, False, False]


def test_direct_check_catches_a_tamper_the_binding_cannot(points):
    """An attacker who recomputes the commitment over a tampered layer
    satisfies the binding; the direct low-degree check still rejects."""
    cfg, tables, batch, _ = points
    tampered = _t(batch[1])
    new_root = M.merkle_root_permuted(tampered)
    # the JAX roots of the whole batch, whose shapes the binding's call in
    # test_points_checks_vs_jax has compiled already: row 1 is this one's
    np.testing.assert_array_equal(
        _n(new_root), np.asarray(JM.merkle_root_permuted(jnp.asarray(batch)))[1])
    assert bool(V.points_root_binding(tampered, new_root))
    assert not bool(V.points_direct_check(tampered, tables, cfg))


def test_direct_check_rejects_an_unconstructible_degree():
    class FakeCfg:
        fri_final_maxdeg_plus_1 = 32

    with pytest.raises(ValueError, match="unconstructible"):
        V.points_direct_check(torch.zeros((64, 8), dtype=torch.int32), None,
                              FakeCfg())


def test_direct_check_takes_a_verifier_modules_buffers(points):
    """The verifier hands itself in as `tables`: registered buffers are used
    as they are."""
    cfg, tables, batch, _ = points
    fn, _ = V.make_verifier(cfg, 3, device="cpu")
    assert {"points_eval_matrix", "points_pts"} <= {
        n for n, _ in fn.named_buffers()}
    assert V.points_direct_check(_t(batch), fn, cfg).tolist() == [
        True, False, False, True]
