"""ops/ntt beyond the verifier's 64 points: the plain version (the CPU path)
against the oracle's FFT at 2^13 and the JAX package's ntt at 2^10 (jitted
once, with raw edge values, n = 1 and 2 and a leading batch dim in the same
compilation), and the host tables the stage kernel reads.  The kernel path
itself (forward then inverse at 2^16, the folds, the cross stage) runs
through the host build of the kernel in tests/test_torch_csrc_host.py.
Tolerance 0."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from stark_verifier_tpu.ops import ntt as JN
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.ops import ntt

torch.set_num_threads(1)
P = fp.MODULUS
EDGES = [0, 1, P - 1, P, P + 1, 2**256 - 1, 2**256 - 2**32, 2**224 - 1,
         int("FFFFFFFF00000000" * 4, 16), 2**255]


def _root(n):
    return pow(7, (P - 1) // n, P)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _raw(n, seed, lead=()):
    """[*lead, n, 16] raw values below 2^256, the edge values first."""
    rng = random.Random(seed)
    count = n * int(np.prod(lead, dtype=np.int64))
    vals = [rng.randrange(1 << 256) for _ in range(count)]
    vals[:min(count, len(EDGES))] = EDGES[:min(count, len(EDGES))]
    return fp.ints_to_limbs_fast(vals).reshape(tuple(lead) + (n, 16))


def test_ntt_2_13_vs_oracle():
    n = 1 << 13
    rng = random.Random(13)
    vals = [rng.randrange(P) for _ in range(n)]
    got = _n(ntt.ntt(_t(fp.ints_to_limbs_fast(vals)), _root(n)))
    assert [fp.limbs_to_int(r) for r in got] == oracle.fft_fwd(vals, _root(n))


def test_ntt_vs_jax_one_compilation():
    """2^10 forward on raw edge values; n = 1 and 2 with a leading batch of
    3, forward and inverse: one jitted JAX function for all of them."""
    big = _raw(1 << 10, 10)
    one = fp.ints_to_limbs([P + 1, 2**256 - 1, 5]).reshape(3, 1, 16)
    two = _raw(2, 2, (3,))

    def jax_side(b, o, t):
        return (JN.ntt(b, _root(1 << 10)), JN.ntt(o, 1), JN.intt(o, 1),
                JN.ntt(t, _root(2)), JN.intt(t, _root(2)))

    want = [np.asarray(w) for w in jax.jit(jax_side)(
        jnp.asarray(big), jnp.asarray(one), jnp.asarray(two))]
    got = [ntt.ntt(_t(big), _root(1 << 10)), ntt.ntt(_t(one), 1),
           ntt.intt(_t(one), 1), ntt.ntt(_t(two), _root(2)),
           ntt.intt(_t(two), _root(2))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), w)
    # n = 1: the forward transform returns its input raw, the inverse
    # canonicalizes it (a product by 1)
    np.testing.assert_array_equal(_n(got[1]), one)
    assert [fp.limbs_to_int(r) for r in _n(got[2]).reshape(3, 16)] == [
        1, 2**256 - 1 - P, 5]


def test_host_tables_cache_what_the_kernel_reads():
    n = 1 << 12
    perm, tw = ntt._card_tables(_root(n), n, P, "cpu")
    assert perm.dtype == torch.int32 and tuple(perm.shape) == (n,)
    assert tuple(tw.shape) == (n // 2, 8)
    assert fp.limbs_to_int(ntt.F.words_le_to_limbs(tw[3]).numpy().astype(
        np.uint32)) == pow(_root(n), 3, P)
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt(torch.zeros((6, 16), dtype=torch.int32), 3)
