"""debug.py (STARK_DEBUG=1): the four cases of the JAX package's
tests/test_debug_mode.py against the port, each check raising where the
JAX package's does on the same inputs, and the verifiers under the switch:
they accept the golden log_steps=9 proof, reject a tampered one, and bound
the FRI column indices before kernel C takes them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prover
from stark_verifier_tpu import debug as jdebug
from stark_verifier_tpu.ops import field as JF
from stark_verifier_tpu_torch import debug, fp
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.ops import field as F, prg
from stark_verifier_tpu_torch.proofio import device, wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
CFG = StarkConfig(log_steps=9)


def _limbs(x):
    return torch.from_numpy(fp.int_to_limbs(x).astype(np.int32))


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("STARK_DEBUG", raising=False)
    assert not debug.enabled()
    f = lambda x: x                                        # noqa: E731
    assert debug.checked(f) is f
    fn, _ = V.make_verifier(CFG, 3, device="cpu")
    assert isinstance(fn, V.MimcVerifier)                  # the module itself


def test_limb_invariant_check_fires(monkeypatch):
    """A limb >= 2^16 fed to add_mod raises under the switch, here as in the
    JAX package (its checkify error)."""
    monkeypatch.setenv("STARK_DEBUG", "1")
    good = _limbs(12345)
    bad = good.clone()
    bad[3] = 0x2000F
    fn = debug.checked(F.add_mod)
    assert fp.limbs_to_int(fn(good, good).numpy().astype(np.uint32)) == 24690
    with pytest.raises(ValueError, match="limb invariant"):
        fn(good, bad)
    jfn = jdebug.checked(jax.jit(JF.add_mod))
    with pytest.raises(Exception, match="limb invariant"):
        jfn(jnp.asarray(good.numpy().astype(np.uint32)),
            jnp.asarray(bad.numpy().astype(np.uint32)))
    neg = good.clone()
    neg[0] = -1                             # the word 0xFFFFFFFF
    for name in ("sub_mod", "add_mod"):
        with pytest.raises(ValueError, match=name):
            getattr(F, name)(good, neg)
    with pytest.raises(ValueError, match="mul_sum_mod"):
        F.mul_sum_mod([(good, neg)])


def test_index_bounds_check_fires(monkeypatch):
    monkeypatch.setenv("STARK_DEBUG", "1")

    def gather(idx):
        debug.check_bounds(idx, 16, "test gather")
        return idx

    fn = debug.checked(gather)
    fn(torch.arange(4, dtype=torch.int32))
    with pytest.raises(IndexError, match="out of bounds"):
        fn(torch.tensor([3, 99], dtype=torch.int32))
    # a negative int32 index is a large unsigned one: out of bounds, as the
    # JAX package's uint32 compare has it
    with pytest.raises(IndexError, match="out of bounds"):
        fn(torch.tensor([-1], dtype=torch.int32))

    def jgather(idx):
        jdebug.check_bounds(idx, 16, "test gather")
        return idx

    with pytest.raises(Exception, match="out of bounds"):
        jdebug.checked(jax.jit(jgather))(
            jnp.asarray([0xFFFFFFFF], dtype=jnp.uint32))


def test_checks_absent_when_disabled(monkeypatch):
    """Off, the same denormalized input wraps silently (the caller keeps
    the invariant)."""
    monkeypatch.delenv("STARK_DEBUG", raising=False)
    good = _limbs(1)
    bad = good.clone()
    bad[3] = 0x2000F
    F.add_mod(good, bad)
    debug.check_bounds(torch.tensor([99]), 16, "off")


@pytest.fixture(scope="module")
def golden():
    blob, _ = prover.prove_to_bytes(3, CFG.num_steps, CONSTS)
    tree = device.proof_tree(wire.parse_and_validate(blob, CFG))
    bad = device.tree_map(np.array, tree)
    bad["main"]["value"][7, 3] ^= 1
    return device.to_device(device.stack_proofs([tree, bad]), "cpu")


def test_verifiers_under_the_switch(monkeypatch, golden):
    monkeypatch.setenv("STARK_DEBUG", "1")
    fn, _ = V.make_verifier(CFG, 3, device="cpu")
    assert isinstance(fn, debug._Checked) and fn.cfg == CFG
    assert fn(golden).tolist() == [True, False]
    cfn, _ = V.make_chunked_verifier(CFG, 3, chunk=1, device="cpu")
    assert cfn(golden).tolist() == [True, False]
    gfn, _ = V.make_general_verifier(CFG, device="cpu")
    out = prover.prove_to_bytes(3, CFG.num_steps, CONSTS)[1]
    consts = torch.from_numpy(fp.ints_to_limbs(CONSTS).astype(np.int32))
    assert gfn(golden, _limbs(3), consts, _limbs(out)).tolist() == [True,
                                                                     False]


def test_fri_indices_bounded_under_the_switch(monkeypatch, golden):
    """Column indices past the level's table raise before kernel C's plain
    version takes them."""
    monkeypatch.setenv("STARK_DEBUG", "1")
    real = prg.indices_from_entries
    monkeypatch.setattr(prg, "indices_from_entries",
                        lambda *a, **k: real(*a, **k) + CFG.precision)
    fn, _ = V.make_verifier(CFG, 3, device="cpu")
    with pytest.raises(IndexError, match="fri column indices"):
        fn(golden)
