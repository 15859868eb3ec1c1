"""The proof stream with run-time statements (parallel/mesh.verify_stream
with statements= and constants=) on the CPU: one constant a round (2^9
steps, 512 constants), four statements, chunks of 8; its verdicts against
tests/oracle.py for honest, flipped, moved-output, other-statement, ragged
and truncated blobs across chunk boundaries; the arguments it refuses; its
spans under the profiler; and the fixed-statement stream's verdicts,
walks and hash launches as they were before statements came.  No JAX."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import oracle
import prover
from stark_verifier_tpu_torch import profiling
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.ops import blake2s, blake2s_cuda, prg
from stark_verifier_tpu_torch.parallel import mesh as M
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
P = oracle.MODULUS
STEPS = 512
CONSTS = [(i ** 7) ^ 42 for i in range(STEPS)]       # one a round
CFG = StarkConfig(log_steps=9, num_constants=STEPS)
INPUTS = (3, 4, 5, 6)


def _flip(blob: bytes, at: int) -> bytes:
    b = bytearray(blob)
    b[at] ^= 1
    return bytes(b)


def _ragged(blob: bytes, depth: int = 11) -> bytes:
    """The last (lincomb) branch with one witness fewer than its group."""
    at = len(blob) - 32 * depth - 4
    assert int.from_bytes(blob[at:at + 4], "little") == 32 * depth
    return (blob[:at] + (32 * (depth - 1)).to_bytes(4, "little")
            + blob[at + 4:-32])


def _oracle(blob: bytes, inp: int, out: int, consts=CONSTS) -> bool:
    try:
        proof, _ = oracle.parse_proof(blob)
        return bool(oracle.verify_mimc_proof(inp, STEPS, consts, out, proof,
                                             parity_guards=False))
    except (AssertionError, ValueError, IndexError):
        return False


@pytest.fixture(scope="module")
def proofs():
    """{input: (blob, output)} at one constant a round."""
    return {i: prover.prove_to_bytes(i, STEPS, CONSTS) for i in INPUTS}


@pytest.fixture(scope="module")
def requests(proofs):
    """[(kind, blob, (input, claimed output))]: at chunks of 8, every kind
    in the first two and the ragged blob in the third, of 5."""
    def own(i):
        return proofs[i][0], (i, proofs[i][1])

    blob3 = proofs[3][0]
    value = oracle.parse_proof(blob3)[0].merkle_branches.branches[0].value
    at_value = blob3.index(value) + 3
    flips = [_flip(blob3, at) for at in (5, 40, at_value)]
    reqs = [("honest",) + own(i) for i in INPUTS]
    reqs += [("flip", b, (3, proofs[3][1])) for b in flips]
    reqs += [("wrong_output", proofs[4][0], (4, (proofs[4][1] + 1) % P)),
             ("other_statement", proofs[5][0], (6, proofs[6][1])),
             ("truncated", blob3[:1000], (3, proofs[3][1]))]
    reqs += [("honest",) + own(i) for i in reversed(INPUTS)]
    reqs += [("other_statement", proofs[6][0], (5, proofs[5][1]))]
    reqs += [("honest",) + own(i) for i in INPUTS]
    reqs += [("ragged", _ragged(proofs[4][0]), (4, proofs[4][1])),
             ("honest",) + own(5)]
    assert len(reqs) == 21
    return reqs


def _stream(reqs, chunk=8, **kw):
    return dict(M.verify_stream(
        (b for _, b, _ in reqs), chunk=chunk, cfg=CFG,
        statements=(s for _, _, s in reqs), constants=CONSTS, threads=2,
        device="cpu", **kw))


@pytest.fixture(scope="module")
def traced(requests):
    """The stream under the profiler: (verdicts, the spans it recorded)."""
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _stream(requests)
    until = time.time_ns()
    spans = [s for s in profiling.spans()
             if since <= s.start_ns and s.end_ns <= until]
    return got, spans


def test_verdicts_equal_the_oracles(requests, traced):
    got, _ = traced
    want = [_oracle(b, *s) for _, b, s in requests]
    assert [got[i] for i in range(len(requests))] == want
    assert want == [k == "honest" for k, _, _ in requests]


def test_a_ragged_chunk_takes_the_independent_walk(traced):
    _, spans = traced
    walks = [s.attrs["walk"] for s in sorted(spans, key=lambda s: s.start_ns)
             if s.name == "stream.dispatch"]
    assert walks == ["shared", "shared", "independent"]


def test_the_worker_packs_the_statements_and_verify_runs_general(requests,
                                                                 traced):
    _, spans = traced
    main = threading.get_native_id()
    by_id = {s.id: s for s in spans}
    packs = sorted((s for s in spans if s.name == "stream.statements"),
                   key=lambda s: s.start_ns)
    chunks = [requests[i:i + 8] for i in range(0, len(requests), 8)]
    assert [s.attrs for s in packs] == [
        {"proofs": len(c), "statements": len({st for _, _, st in c})}
        for c in chunks]
    assert [s.attrs["statements"] for s in packs] == [5, 4, 3]
    for s in packs:
        assert s.thread != main
        assert by_id[s.parent].name == "stream.prepare"
        assert by_id[s.parent].thread == s.thread
    verifies = [s for s in spans if s.name == "verify"]
    assert len(verifies) == 3
    assert all(s.thread == main and s.attrs["runtime"] is True
               and s.attrs["graph"] == "eager" for s in verifies)
    kx = [s for s in spans if s.name == "verify.kx"]
    assert [s.attrs for s in kx] == [{"constants": STEPS,
                                      "k_rows": 8 * STEPS}] * 3


def test_verdicts_do_not_depend_on_the_chunk(requests, traced):
    assert _stream(requests, chunk=5) == traced[0]


@pytest.mark.parametrize("kw,match", [
    ({"device_parse": True}, "device_parse"),
    ({"mesh": object()}, "mesh"),
    ({"constants": None}, "both"),
    ({"constants": CONSTS[:64]}, "64 round constants"),
])
def test_the_stream_refuses(proofs, kw, match):
    args = dict(chunk=8, cfg=CFG, statements=[(3, proofs[3][1])],
                constants=CONSTS, device="cpu")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        next(M.verify_stream([proofs[3][0]], **args))


def test_statements_are_taken_mod_p(proofs):
    """As verify_mimc and the oracle take them."""
    blob, out = proofs[3]
    sts = [(3 + P, out), (3, out + P), (3 + P, out + 1)]
    got = dict(M.verify_stream([blob] * 3, chunk=8, cfg=CFG, statements=sts,
                               constants=[c + P for c in CONSTS],
                               device="cpu"))
    assert [got[i] for i in range(3)] == [_oracle(blob, *s) for s in sts]
    assert [got[i] for i in range(3)] == [True, True, False]


def test_the_statements_run_in_step_with_the_blobs(proofs):
    with pytest.raises(ValueError):
        list(M.verify_stream([proofs[3][0]] * 3, chunk=2, cfg=CFG,
                             statements=[(3, proofs[3][1])] * 2,
                             constants=CONSTS, device="cpu"))


def test_the_fixed_statement_stream_is_as_before(monkeypatch):
    """Verdicts, walks and graph counts, and 8 narrow-hash launches a
    shared-walk call, with each hash call counted as a launch."""
    consts = CONSTS[:64]
    blob = prover.prove_to_bytes(3, STEPS, consts)[0]
    blobs = [blob, _flip(blob, 40), blob[:1000], blob, blob, _ragged(blob)]

    def counting(fn, mode):
        def call(*args):
            blake2s_cuda.launches[mode] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(blake2s, "hash_words",
                        counting(blake2s.hash_words, "hash_words"))
    monkeypatch.setattr(prg, "chain_entries",
                        counting(prg.chain_entries, "hash_chain"))
    before = V.graph_counts.copy()
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        got = dict(M.verify_stream(blobs, chunk=2,
                                   cfg=StarkConfig(log_steps=9), threads=2,
                                   device="cpu"))
    spans = sorted((s for s in profiling.spans() if s.start_ns >= since),
                   key=lambda s: s.start_ns)
    assert got == {0: True, 1: False, 2: False, 3: True, 4: True, 5: False}
    assert [s.attrs.get("walk") for s in spans
            if s.name == "stream.dispatch"] == ["shared", "shared",
                                                "independent"]
    verifies = [s for s in spans if s.name == "verify"]
    assert [s.attrs["hash_launches"] for s in verifies[:2]] == [8, 8]
    assert all(s.attrs["runtime"] is False for s in verifies)
    assert not [s for s in spans if s.name == "stream.statements"]
    assert V.graph_counts - before == {("shared", "eager"): 2,
                                       ("unshared", "eager"): 1}
