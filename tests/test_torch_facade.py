"""The port's entry points beyond the static verifier, proof by proof against
the pure-Python oracle on fresh proofs from tests/prover.py: verify_mimc (the
reference's library boundary), ragged blobs through verify_proof_bytes, the
square statement family and strict mode.  Everything runs with device="cpu",
where the kernels' plain versions compute; verdicts are exact."""

import numpy as np
import pytest
import torch

import oracle
import prover
import stark_verifier_tpu_torch as svt
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.models import FAMILIES
from stark_verifier_tpu_torch.models.mimc import MimcStatement
from stark_verifier_tpu_torch.models.square import SquareStatement
from stark_verifier_tpu_torch.ops import spot_cuda
from stark_verifier_tpu_torch.proofio import device, wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
P = fp.MODULUS
STEPS = 512
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
# a statement no table was precomputed for: other input, other constants
INP2, CONSTS2 = 5, [(i ** 3) ^ 7 for i in range(16)]
# the square family's
INP_SQ, CONSTS_SQ = 7, [(i ** 5) ^ 9 for i in range(16)]
CFG_SQ = StarkConfig(log_steps=9, num_constants=16, power=2)


def _oracle(blob, inp, consts, out, power=3):
    """The oracle's verdict; an assert of the reference is a reject."""
    try:
        proof, _ = oracle.parse_proof(blob)
        return bool(oracle.verify_mimc_proof(inp, STEPS, consts, out, proof,
                                             parity_guards=False, power=power))
    except (AssertionError, ValueError, IndexError):
        return False


def _flip(blob, at):
    b = bytearray(blob)
    b[at] ^= 1
    return bytes(b)


def _drop_last_witness(blob, depth=11):
    """The blob with the last witness of its last (lincomb) branch cut off:
    that branch carries one witness fewer than its neighbours."""
    at = len(blob) - 32 * depth - 4
    assert int.from_bytes(blob[at:at + 4], "little") == 32 * depth
    return (blob[:at] + (32 * (depth - 1)).to_bytes(4, "little")
            + blob[at + 4:-32])


def _limbs(x):
    a = fp.ints_to_limbs(x) if isinstance(x, list) else fp.int_to_limbs(x)
    return torch.from_numpy(a.astype(np.int32))


@pytest.fixture(scope="module")
def default_proof():
    return prover.prove_to_bytes(3, STEPS, CONSTS)


@pytest.fixture(scope="module")
def other_proof():
    return prover.prove_to_bytes(INP2, STEPS, CONSTS2)


@pytest.fixture(scope="module")
def square_proof():
    return prover.prove_to_bytes(INP_SQ, STEPS, CONSTS_SQ, power=2)


# ---------------------------------------------------------------------------
# verify_mimc
# ---------------------------------------------------------------------------

def test_verify_mimc_list_against_the_oracle(default_proof):
    """Good, flipped (two sites), truncated (a parse reject), ragged, good:
    one verdict per blob, each the oracle's."""
    blob, out = default_proof
    blobs = [blob, _flip(blob, 110), _flip(blob, len(blob) // 2), blob[:500],
             _drop_last_witness(blob), blob]
    got = svt.verify_mimc(3, STEPS, CONSTS, out, blobs, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.bool_
    assert got.tolist() == [_oracle(b, 3, CONSTS, out) for b in blobs]
    assert got.tolist() == [True, False, False, False, False, True]


def test_verify_mimc_one_blob_gives_a_bool(default_proof):
    blob, out = default_proof
    assert svt.verify_mimc(3, STEPS, CONSTS, out, blob, device="cpu") is True
    assert svt.verify_mimc(3, STEPS, CONSTS, out, bytearray(blob[:-1]),
                           device="cpu") is False


@pytest.mark.parametrize("what", ["statement", "wrong_output", "wrong_input",
                                  "changed_constant", "default_constants"])
def test_verify_mimc_runtime_statement_against_the_oracle(other_proof, what):
    """Input 5 and 16 constants of another sequence: nothing here is in a
    precomputed table, the constants go through the iNTT."""
    blob, out = other_proof
    inp, consts, claimed = INP2, list(CONSTS2), out
    if what == "wrong_output":
        claimed = (out + 1) % P
    elif what == "wrong_input":
        inp = INP2 + 1
    elif what == "changed_constant":
        consts[3] ^= 1
    elif what == "default_constants":
        consts = [(i ** 7) ^ 42 for i in range(16)]
    got = svt.verify_mimc(inp, STEPS, consts, claimed, [blob], device="cpu")
    assert got.tolist() == [_oracle(blob, inp, consts, claimed)]
    assert got.tolist() == [what == "statement"]


def test_verify_mimc_all_malformed_and_bad_step_count(default_proof):
    blob, out = default_proof
    got = svt.verify_mimc(3, STEPS, CONSTS, out, [b"", blob[:100]],
                          device="cpu")
    assert got.tolist() == [False, False]
    with pytest.raises(ValueError, match="power of two"):
        svt.verify_mimc(3, 500, CONSTS, out, [blob], device="cpu")


# ---------------------------------------------------------------------------
# ragged proofs through the bytes facade
# ---------------------------------------------------------------------------

def test_ragged_blob_gets_a_verdict_not_an_exception(default_proof):
    blob, out = default_proof
    ragged = _drop_last_witness(blob)
    tree = device.proof_tree(wire.parse_and_validate(ragged,
                                                     StarkConfig(log_steps=9)))
    assert not device.is_rectangular(tree)
    assert tree["lincomb"]["depth"].tolist() == [11] * 79 + [10]
    assert _oracle(ragged, 3, CONSTS, out) is False
    assert svt.verify_proof_bytes(ragged, log_steps=9, device="cpu") is False


def test_misrouted_ragged_proof_rejects_on_the_shared_walk(default_proof):
    """Routing is by is_rectangular; a ragged proof sent to the shared walk
    all the same rejects through the uniform-depth guard."""
    blob, _ = default_proof
    cfg = StarkConfig(log_steps=9)
    tree = device.proof_tree(wire.parse_and_validate(
        _drop_last_witness(blob), cfg))
    fn, _ = V.make_verifier(cfg, 3, shared_merkle=True, device="cpu")
    assert not bool(fn(device.to_device(tree, "cpu")))


def test_ragged_and_rectangular_proofs_stack_into_one_batch(default_proof):
    blob, _ = default_proof
    cfg = StarkConfig(log_steps=9)
    trees = [device.proof_tree(wire.parse_and_validate(b, cfg))
             for b in (blob, _drop_last_witness(blob))]
    # the ragged proof's own arrays are as deep as its deepest branch
    batch = device.stack_proofs(trees)
    assert batch["lincomb"]["witness"].shape == (2, 80, 11, 8)
    assert not device.is_rectangular(batch)
    fn, _ = V.make_verifier(cfg, 3, shared_merkle=False, device="cpu")
    assert fn(device.to_device(batch, "cpu")).tolist() == [True, False]


# ---------------------------------------------------------------------------
# the square family (x <- x^2 + k): the spot checks' power-2 form
# ---------------------------------------------------------------------------

def test_families_registry_and_outputs():
    assert set(FAMILIES) == {"mimc", "square"}
    assert FAMILIES["square"](CFG_SQ).config().power == 2
    assert MimcStatement().config() == StarkConfig()
    with pytest.raises(ValueError, match="power == 2"):
        SquareStatement(StarkConfig(log_steps=9))
    # compute_output uses the family's default (i^7)^42 constants
    got = SquareStatement(CFG_SQ).compute_output(INP_SQ, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (16,)
    assert fp.limbs_to_int(got.numpy().astype(np.uint32)) == oracle.mimc(
        INP_SQ, STEPS, [(i ** 7) ^ 42 for i in range(16)], power=2)
    np.testing.assert_array_equal(
        SquareStatement(CFG_SQ).round_constants(),
        fp.ints_to_limbs([(i ** 7) ^ 42 for i in range(16)]))


@pytest.mark.parametrize("what", ["proof", "wrong_output", "flipped"])
def test_square_family_against_the_oracle(square_proof, what, monkeypatch):
    blob, out = square_proof
    assert out == oracle.mimc(INP_SQ, STEPS, CONSTS_SQ, power=2)
    if what == "flipped":
        blob = _flip(blob, 200)
    claimed = (out + 1) % P if what == "wrong_output" else out
    powers = []
    real = spot_cuda.spot_checks
    monkeypatch.setattr(
        spot_cuda, "spot_checks",
        lambda *a, power=3: powers.append(power) or real(*a, power=power))
    fn, _ = SquareStatement(CFG_SQ).make_general_verifier(device="cpu")
    tree = device.to_device(device.proof_tree(
        wire.parse_and_validate(blob, CFG_SQ)), "cpu")
    got = bool(fn(tree, _limbs(INP_SQ), _limbs(CONSTS_SQ), _limbs(claimed)))
    assert got is _oracle(blob, INP_SQ, CONSTS_SQ, claimed, power=2)
    assert got is (what == "proof") and powers == [2]


def test_square_family_static_verifier():
    """SquareStatement.make_verifier: the family's default constants, the
    output precomputed on the host; single proof and a batch of two."""
    cfg = StarkConfig(log_steps=9, power=2)
    blob, out = prover.prove_to_bytes(3, STEPS, CONSTS, power=2)
    assert _oracle(blob, 3, CONSTS, out, power=2)
    fn, _ = SquareStatement(cfg).make_verifier(inp=3, device="cpu")
    trees = [device.proof_tree(wire.parse_and_validate(b, cfg))
             for b in (blob, _flip(blob, 200))]
    assert bool(fn(device.to_device(trees[0], "cpu")))
    batch = device.to_device(device.stack_proofs(trees), "cpu")
    assert fn(batch).tolist() == [True, False]
    unshared, _ = SquareStatement(cfg).make_verifier(
        inp=3, shared_merkle=False, device="cpu")
    assert unshared(batch).tolist() == [True, False]


def test_families_are_not_interchangeable(square_proof):
    """A square-family proof does not verify under the cubic constraint with
    the same parameters."""
    blob, out = square_proof
    cfg3 = StarkConfig(log_steps=9, num_constants=16, power=3)
    fn, _ = MimcStatement(cfg3).make_general_verifier(device="cpu")
    tree = device.to_device(device.proof_tree(
        wire.parse_and_validate(blob, cfg3)), "cpu")
    assert not bool(fn(tree, _limbs(INP_SQ), _limbs(CONSTS_SQ), _limbs(out)))
    assert _oracle(blob, INP_SQ, CONSTS_SQ, out, power=3) is False


# ---------------------------------------------------------------------------
# strict mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,parity,strict", [
    ("blob", True, True), ("trailing", True, False),
    ("flipped", False, False), ("truncated", False, False)])
def test_strict_bytes_facade(default_proof, case, parity, strict):
    blob, _ = default_proof
    data = {"blob": blob, "trailing": blob + b"\x00",
            "flipped": _flip(blob, 110), "truncated": blob[:-1]}[case]
    assert svt.verify_proof_bytes(data, log_steps=9, device="cpu") is parity
    assert svt.verify_proof_bytes(data, log_steps=9, strict=True,
                                  device="cpu") is strict


@pytest.mark.parametrize("shared", [True, False])
def test_strict_binds_the_points_element(default_proof, shared):
    """A changed POINTS word is invisible in parity mode (the reference
    parses POINTS and drops it) and rejects under strict, on the shared and
    the unshared walk; the good proof accepts under both."""
    blob, _ = default_proof
    tree = device.proof_tree(wire.parse_proof(blob))
    changed = device.tree_map(np.array, tree)
    changed["points"][5, 0] ^= 1
    batch = device.to_device(device.stack_proofs([tree, changed]), "cpu")
    parity_fn, _ = V.make_verifier(StarkConfig(log_steps=9), 3,
                                   shared_merkle=shared, device="cpu")
    strict_fn, _ = V.make_verifier(StarkConfig(log_steps=9, strict=True), 3,
                                   shared_merkle=shared, device="cpu")
    assert parity_fn(batch).tolist() == [True, True]
    assert strict_fn(batch).tolist() == [True, False]


def test_strict_verify_mimc(default_proof):
    blob, out = default_proof
    blobs = [blob, blob + b"x"]
    assert svt.verify_mimc(3, STEPS, CONSTS, out, blobs,
                           device="cpu").tolist() == [True, True]
    assert svt.verify_mimc(3, STEPS, CONSTS, out, blobs, strict=True,
                           device="cpu").tolist() == [True, False]
