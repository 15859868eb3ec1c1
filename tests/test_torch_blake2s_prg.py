"""Port's ops/blake2s.py and ops/prg.py against hashlib, the JAX package and
the oracle.  Words are uint32 on the JAX side and int32 bit patterns on the
port's; compared as bits, tolerance 0."""

import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from stark_verifier_tpu.ops import blake2s as JB, prg as JP
from stark_verifier_tpu_torch.ops import blake2s as B, prg as PRG

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _messages(nbytes, seed):
    rng = np.random.RandomState(seed)
    nwords = -(-nbytes // 4)
    by = rng.randint(0, 256, (6, nwords * 4)).astype(np.uint8)
    by[0, :] = 0xFF                         # 0xFFFFFFFF words
    by[1, :] = 0
    by[1, 3::4] = 0x80                      # 0x80000000 words
    by[:, nbytes:] = 0                      # zero padding past the message
    return by


def test_constants_match():
    np.testing.assert_array_equal(B.IV, JB.IV)
    np.testing.assert_array_equal(B.H0, JB.H0)
    np.testing.assert_array_equal(B.SIGMA, JB.SIGMA)


@pytest.mark.parametrize("nbytes", [32, 33, 64, 192])
def test_hash_words(nbytes):
    by = _messages(nbytes, nbytes)
    words = by.view("<u4").astype(np.uint32)
    got = _n(B.hash_words(_t(words), nbytes))
    for i in range(by.shape[0]):
        assert got[i].tobytes() == hashlib.blake2s(
            by[i, :nbytes].tobytes()).digest()
    np.testing.assert_array_equal(
        got, np.asarray(JB.hash_words(jnp.asarray(words), nbytes)))


def test_hash_words_too_short_raises():
    with pytest.raises(ValueError):
        B.hash_words(torch.zeros((2, 8), dtype=torch.int32), 33)


@pytest.mark.parametrize("vw", [8, 24])
def test_pair_hashes(vw):
    rng = np.random.RandomState(vw)
    a = rng.randint(0, 2**32, (5, vw), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, (5, vw), dtype=np.uint64).astype(np.uint32)
    a[0], b[0] = 0xFFFFFFFF, 0x80000000
    got = _n(B.hash_leaf_pair(_t(a), _t(b)))
    np.testing.assert_array_equal(
        got, np.asarray(JB.hash_leaf_pair(jnp.asarray(a), jnp.asarray(b))))
    for i in range(5):
        assert got[i].tobytes() == hashlib.blake2s(
            a[i].tobytes() + b[i].tobytes()).digest()
    if vw == 8:
        np.testing.assert_array_equal(_n(B.hash_pair(_t(a), _t(b))), got)
        np.testing.assert_array_equal(
            _n(B.hash_chain(_t(a))),
            np.asarray(JB.hash_chain(jnp.asarray(a))))


@pytest.mark.parametrize("byte_val", [0, 1, 4, 0x80, 0xFF])
def test_hash_root_byte(byte_val):
    """H(root || [b]), 33 bytes: the k-coefficient hash (6 roots, the shape
    test_hash_words[33] gives JAX's eager hash)."""
    by = _messages(32, 33)
    roots = by.view("<u4").astype(np.uint32)                 # [6, 8]
    got = _n(B.hash_root_byte(_t(roots), byte_val))
    np.testing.assert_array_equal(
        got, np.asarray(JB.hash_root_byte(jnp.asarray(roots), byte_val)))
    for i in range(roots.shape[0]):
        assert got[i].tobytes() == hashlib.blake2s(
            roots[i].tobytes() + bytes([byte_val])).digest()


def _seeds():
    rng = np.random.RandomState(77)
    s = rng.randint(0, 256, (4, 32)).astype(np.uint8)
    s[0] = 0xFF                              # every stream word 0xFFFFFFFF
    s[1] = 0
    s[1, 0::4] = 0x80                        # BE reads of 0x80000000
    return s


def test_chain_entries():
    words = _seeds().view("<u4").astype(np.uint32)
    got = _n(PRG.chain_entries(_t(words), 10))
    np.testing.assert_array_equal(
        got, np.asarray(JP.chain_entries(jnp.asarray(words), 10)))
    np.testing.assert_array_equal(got[:, 0], words)      # raw seed first


@pytest.mark.parametrize("count,modulus,exclude", [
    (40, 16384, 8), (80, 65536, 8), (40, 64, 8), (13, 1000, None)])
def test_indices(count, modulus, exclude):
    seeds = _seeds()
    words = seeds.view("<u4").astype(np.uint32)
    got = PRG.pseudorandom_indices(_t(words), count, modulus, exclude)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JP.pseudorandom_indices(jnp.asarray(words), count,
                                           modulus, exclude)))
    for i in range(seeds.shape[0]):
        assert got[i].tolist() == oracle.get_pseudorandom_indices(
            seeds[i].tobytes(), count, modulus, exclude)


def test_indices_per_level_moduli():
    """The verifier's stacked call: one modulus per FRI level, broadcast."""
    rng = np.random.RandomState(5)
    words = rng.randint(0, 2**32, (3, 5, 8), dtype=np.uint64).astype(np.uint32)
    moduli = np.array([16384, 4096, 1024, 256, 64], dtype=np.uint32)
    ent = PRG.chain_entries(_t(words), 5)
    got = PRG.indices_from_entries(
        ent, 40, torch.from_numpy(moduli.astype(np.int64))[:, None], 8)
    want = JP.indices_from_entries(
        JP.chain_entries(jnp.asarray(words), 5), 40,
        jnp.asarray(moduli)[:, None], 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 1 and not bool((got % 8 == 0).any())
