"""The K table of run-time round constants, on the CPU: the statement's host
table by NTT against the O(k * k_period) loop it replaced, the call's table
(protocol.verify.runtime_k_words: the constants' iNTT, zero-padded, through
the forward NTT) against the statement's, and the runtime-statement verifier
at one constant a round (log_steps=9, 512 constants) against the oracle on
tests/prover.py proofs.  No JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import oracle
import prover
import stark_verifier_tpu_torch as svt
from stark_verifier_tpu_torch import fp, profiling
from stark_verifier_tpu_torch.config import StarkConfig, StatementTables
from stark_verifier_tpu_torch.config import cached_tables
from stark_verifier_tpu_torch.proofio import device, wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
P = fp.MODULUS
STEPS = 512
CFG1 = StarkConfig(log_steps=9, num_constants=STEPS)   # one constant a round
CONSTS1 = [(i ** 7) ^ 42 for i in range(STEPS)]


def _loop_k_table(tables: StatementTables) -> np.ndarray:
    """The K table as the host built it before: minipoly(k_root^t) by a
    power accumulation over the coefficients, for every t < k_period."""
    cfg, m = tables.cfg, tables.cfg.modulus
    coeffs = tables._intt_host(
        [(i ** 7) ^ 42 for i in range(cfg.num_constants)],
        tables.minipoly_root)
    base = pow(tables.G2, cfg.skips2, m)
    out = np.zeros((tables.k_period, fp.NLIMBS), dtype=np.uint32)
    x = 1
    for t in range(tables.k_period):
        acc, pw = 0, 1
        for c in coeffs:
            acc = (acc + c * pw) % m
            pw = pw * x % m
        out[t] = fp.int_to_limbs(acc)
        x = x * base % m
    return out


@pytest.mark.parametrize("constants", [16, 64, 512])
def test_host_k_table_equals_the_loop(constants):
    tables = StatementTables(StarkConfig(log_steps=9, num_constants=constants))
    assert tables.k_period == 8 * constants
    assert tables.k_root == pow(tables.G2, tables.cfg.skips2, P)
    want = _loop_k_table(tables)
    assert tables.k_table.dtype == want.dtype
    np.testing.assert_array_equal(tables.k_table, want)


@pytest.mark.parametrize("cfg", [StarkConfig(), StarkConfig(log_steps=9),
                                 CFG1], ids=["default", "log9", "log9_k512"])
def test_call_k_table_equals_the_statements(cfg):
    """The formula constants give the statement's own table, word for word,
    through the verifier module and through bare StatementTables."""
    tables = cached_tables(cfg)
    consts = torch.from_numpy(fp.ints_to_limbs(
        [(i ** 7) ^ 42 for i in range(cfg.num_constants)]).astype(np.int32))
    want = fp.limbs_to_le_words(tables.k_table)
    got = V.runtime_k_words(consts, tables)
    assert got.shape == (tables.k_period, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    fn, _ = V.make_general_verifier(cfg, device="cpu")
    np.testing.assert_array_equal(V.runtime_k_words(consts, fn).numpy(),
                                  got.numpy())


# ---------------------------------------------------------------------------
# the runtime-statement verifier at one constant a round
# ---------------------------------------------------------------------------

def _flip(blob: bytes, at: int) -> bytes:
    b = bytearray(blob)
    b[at] ^= 1
    return bytes(b)


def _spot_site_flips(blob: bytes) -> dict:
    """One bit flipped in each site the spot checks read: the two roots
    that seed the k-hashes and the positions, a main leaf and witness, a
    lincomb leaf and sibling (found by their bytes after the main
    multiproof starts)."""
    proof, _ = oracle.parse_proof(blob)
    main = proof.merkle_branches.branches[7]
    lin = proof.linear_comb_branches.branches[4]
    start = blob.index(proof.merkle_branches.branches[0].value)
    at = {"merkle_root": 5, "l_merkle_root": 40,
          "main_value": blob.index(main.value, start) + 40,
          "main_witness": blob.index(main.witnesses[3], start) + 9,
          "lincomb_value": blob.index(lin.value, start) + 4,
          "lincomb_sibling": blob.index(lin.sibling_value, start) + 4}
    return {f"flip@{k}": _flip(blob, a) for k, a in at.items()}


def _oracle(blob: bytes, consts, out) -> bool:
    try:
        proof, _ = oracle.parse_proof(blob)
        return bool(oracle.verify_mimc_proof(3, STEPS, consts, out, proof,
                                             parity_guards=False))
    except (AssertionError, ValueError, IndexError):
        return False


@pytest.fixture(scope="module")
def one_a_round():
    """{kind: (blob, claimed output)}: the honest proof, a flip at each
    spot-check site, the honest proof against a moved output."""
    blob, out = prover.prove_to_bytes(3, STEPS, CONSTS1)
    kinds = {"honest": (blob, out), "moved_output": (blob, (out + 1) % P)}
    kinds.update({k: (b, out) for k, b in _spot_site_flips(blob).items()})
    return kinds


@pytest.fixture(scope="module")
def general_verdicts(one_a_round):
    """{kind: verdict} of one batched call of the general verifier."""
    fn, _ = V.make_general_verifier(CFG1, device="cpu")
    names = list(one_a_round)
    trees = [device.proof_tree(wire.parse_and_validate(one_a_round[k][0],
                                                       CFG1))
             for k in names]
    batch = device.to_device(device.stack_proofs(trees), "cpu")
    outs = torch.from_numpy(fp.ints_to_limbs(
        [one_a_round[k][1] for k in names]).astype(np.int32))
    limbs = lambda x: torch.from_numpy(                       # noqa: E731
        np.asarray(x).astype(np.int32))
    got = fn(batch, limbs(fp.int_to_limbs(3)), limbs(fp.ints_to_limbs(CONSTS1)),
             outs)
    return dict(zip(names, got.tolist()))


KINDS = ["honest", "moved_output", "flip@merkle_root", "flip@l_merkle_root",
         "flip@main_value", "flip@main_witness", "flip@lincomb_value",
         "flip@lincomb_sibling"]


@pytest.mark.parametrize("kind", KINDS)
def test_one_constant_a_round_against_the_oracle(one_a_round,
                                                 general_verdicts, kind):
    blob, out = one_a_round[kind]
    assert set(general_verdicts) == set(KINDS)
    assert general_verdicts[kind] == _oracle(blob, CONSTS1, out)
    assert general_verdicts[kind] == (kind == "honest")


def test_verify_mimc_at_one_constant_a_round(one_a_round):
    blob, out = one_a_round["honest"]
    blobs = [blob, one_a_round["flip@main_value"][0], blob[:700], blob]
    got = svt.verify_mimc(3, STEPS, CONSTS1, out, blobs, device="cpu")
    assert got.tolist() == [_oracle(b, CONSTS1, out) for b in blobs]
    assert got.tolist() == [True, False, False, True]


@pytest.mark.parametrize("cfg", [StarkConfig(log_steps=9), CFG1],
                         ids=["k64", "k512"])
def test_the_kx_span_counts_constants_and_rows(one_a_round, cfg):
    """verify.kx, inside verify, carries k and the table's rows."""
    blob = (one_a_round["honest"][0] if cfg is CFG1
            else prover.prove_to_bytes(3, STEPS, CONSTS1[:64])[0])
    consts = [(i ** 7) ^ 42 for i in range(cfg.num_constants)]
    with profile(activities=[ProfilerActivity.CPU]):
        assert svt.verify_mimc(3, STEPS, consts, oracle.mimc(3, STEPS, consts),
                               blob, device="cpu") is True
    verify = [s for s in profiling.spans() if s.name == "verify"][-1]
    kx, = [s for s in profiling.spans()
           if s.name == "verify.kx" and s.parent == verify.id]
    assert kx.attrs == {"constants": cfg.num_constants,
                        "k_rows": 8 * cfg.num_constants}
